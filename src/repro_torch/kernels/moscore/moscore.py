"""Wrappers of the two CUDA moscore kernels (``csrc/moscore.cu``).

Each wrapper takes the transposed (G, P) tables of one routing window,
checks them, and launches one CTA that scans the W requests with queue
feedback. The extension is built with ``torch.utils.cpp_extension.load``
at first use, into ``build/torch_ext/`` at the root of the checkout.

On CPU tensors a wrapper runs its kernel's plain PyTorch version
(``mo_scan_hoisted`` or ``ref_moscore_route``); on CUDA tensors it
launches the kernel or raises. Each CUDA launch adds one to the wrapper's
``launches`` count, so a run can show that it went through the kernel."""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from repro_torch.core.policies import mo_scan_hoisted
from repro_torch.kernels.moscore.ref import ref_moscore_route

_CSRC = Path(__file__).resolve().parent / "csrc"
#: where the extension is built: ``build/torch_ext`` in the checkout
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "torch_ext"
#: the kernels keep q (P floats) in dynamic shared memory; with their
#: static scratch (at most 768 B) it stays within the 48 KB a launch gets
#: by default if P <= 12032
MAX_PAIRS = 12032
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false"]


@functools.cache
def extension():
    """Build (first call) and load the moscore CUDA extension."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="repro_torch_moscore",
                sources=[str(_CSRC / "moscore.cu"),
                         str(_CSRC / "binding.cpp")],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3"], extra_cuda_cflags=CUDA_FLAGS)


def _check(name: str, t: torch.Tensor, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_window(Tt, tables, gs, q0):
    """Validate one window's CUDA inputs; returns (P, W)."""
    if Tt.device.type != "cuda":
        raise ValueError(f"moscore kernels run on CUDA tensors, got "
                         f"{Tt.device}")
    if Tt.ndim != 2 or not 1 <= Tt.shape[1] <= MAX_PAIRS:
        raise ValueError(f"Tt must be (G, P) with 1 <= P <= {MAX_PAIRS}, "
                         f"got {tuple(Tt.shape)}")
    for name, t, dtypes in tables:
        _check(name, t, dtypes, tuple(Tt.shape), Tt.device)
    if gs.ndim != 1:
        raise ValueError(f"gs must be (W,), got {tuple(gs.shape)}")
    _check("gs", gs, (torch.int32,), tuple(gs.shape), Tt.device)
    _check("q0", q0, (torch.float32,), (Tt.shape[1],), Tt.device)
    return Tt.shape[1], gs.shape[0]


def moscore_hoisted_cuda(Tt, Ent, Ft, gs, q0, *, gamma: float):
    """The hoisted window scan: ``Tt``/``Ent`` (G, P) float32 transposed
    profile and normalised energy (``mo_precompute``), ``Ft`` (G, P) bool
    or uint8 feasibility, ``gs`` (W,) int32 groups in [0, G), ``q0`` (P,)
    float32. Returns ``(choices (W,) int32, q_final (P,) float32)``."""
    if Tt.device.type == "cpu":
        return mo_scan_hoisted(Tt, Ent, Ft, gs, q0, gamma=gamma)
    P, W = _check_window(Tt, [("Tt", Tt, (torch.float32,)),
                              ("Ent", Ent, (torch.float32,)),
                              ("Ft", Ft, (torch.bool, torch.uint8))],
                         gs, q0)
    choices = torch.empty((W,), dtype=torch.int32, device=Tt.device)
    q_final = torch.empty((P,), dtype=torch.float32, device=Tt.device)
    extension().moscore_hoisted(Tt, Ent, Ft, gs, q0, choices, q_final,
                                float(gamma), 1.0 - float(gamma))
    moscore_hoisted_cuda.launches += 1
    return choices, q_final


moscore_hoisted_cuda.launches = 0


def moscore_cuda(Tt, Et, Mt, gs, q0, *, delta: float, gamma: float):
    """The unhoisted window scan: ``Tt``/``Et``/``Mt`` (G, P) float32
    transposed raw profile, ``gs`` (W,) int32 groups in [0, G), ``q0``
    (P,) float32. Returns ``(choices (W,) int32, q_final (P,) float32)``.
    """
    if Tt.device.type == "cpu":
        return ref_moscore_route(Tt.t(), Et.t(), Mt.t(), gs, q0,
                                 delta=delta, gamma=gamma)
    P, W = _check_window(Tt, [("Tt", Tt, (torch.float32,)),
                              ("Et", Et, (torch.float32,)),
                              ("Mt", Mt, (torch.float32,))], gs, q0)
    choices = torch.empty((W,), dtype=torch.int32, device=Tt.device)
    q_final = torch.empty((P,), dtype=torch.float32, device=Tt.device)
    extension().moscore(Tt, Et, Mt, gs, q0, choices, q_final, float(delta),
                        float(gamma), 1.0 - float(gamma))
    moscore_cuda.launches += 1
    return choices, q_final


moscore_cuda.launches = 0
