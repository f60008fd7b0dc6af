"""Backend dispatch for one routing window (port of
``repro.kernels.moscore.ops``).

Four concrete backends share one contract, ``(T, E, mAP, gs, q0) ->
(choices, q_final)``, and give bit-identical float32 routing:

  * ``"ref"`` -- the plain PyTorch scan, every Algorithm 1 term
    recomputed per request (``ref_moscore_route``);
  * ``"hoisted"`` -- the plain PyTorch scan with the queue-independent
    terms precomputed once per window (``mo_select_batch_hoisted``);
  * ``"cuda"`` -- the unhoisted CUDA kernel (``moscore_cuda``);
  * ``"cuda_hoisted"`` -- the hoisted CUDA kernel
    (``moscore_hoisted_cuda``), fed by ``mo_precompute`` on the device.

``"auto"`` resolves per device: ``cuda_hoisted`` for CUDA tensors,
``hoisted`` for CPU tensors. The ``REPRO_TORCH_MOSCORE_BACKEND``
environment variable overrides the ``auto`` choice; an explicit
``backend=`` always wins. A ``cuda*`` backend on CPU tensors raises: there
is no silent fallback in either direction."""

from __future__ import annotations

import os

import torch

from repro_torch.core.policies import mo_precompute, mo_select_batch_hoisted
from repro_torch.core.profiles import ProfileTable
from repro_torch.kernels.moscore.moscore import (moscore_cuda,
                                                 moscore_hoisted_cuda)
from repro_torch.kernels.moscore.ref import ref_moscore_route

BACKENDS = ("cuda", "ref", "hoisted", "cuda_hoisted", "auto")

#: environment override for ``backend="auto"`` (see :func:`resolve_backend`)
BACKEND_ENV = "REPRO_TORCH_MOSCORE_BACKEND"


def default_backend(device) -> str:
    """The fastest correct backend for tensors on ``device``: the hoisted
    CUDA kernel on a CUDA device, the hoisted PyTorch scan elsewhere."""
    return "cuda_hoisted" if torch.device(device).type == "cuda" \
        else "hoisted"


def resolve_backend(backend: str, device) -> str:
    """Normalise a backend spec to a concrete one for tensors on
    ``device``. ``"auto"`` reads ``REPRO_TORCH_MOSCORE_BACKEND`` first (a
    concrete backend name; ``auto`` itself is rejected), then falls back
    to :func:`default_backend`. Explicit backends pass through."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown moscore backend {backend!r}; one of "
                         f"{BACKENDS}")
    if backend != "auto":
        return backend
    env = os.environ.get(BACKEND_ENV, "").strip()
    if env:
        if env not in BACKENDS or env == "auto":
            raise ValueError(
                f"{BACKEND_ENV}={env!r} is not a concrete moscore backend; "
                f"one of {tuple(b for b in BACKENDS if b != 'auto')}")
        return env
    return default_backend(device)


def moscore_route(T, E, mAP, gs, q0, *, delta: float = 20.0,
                  gamma: float = 0.5, backend: str = "cuda", health=None):
    """Route a window of requests with queue feedback.

    ``T``/``E``/``mAP``: (P, G) float32 profile tables; ``gs``: (W,) int32
    estimated groups in [0, G); ``q0``: (P,) queue depths, all on one
    device. Returns ``(choices (W,) int32, q_final (P,) float32)`` there.

    ``health`` (optional, (P,) bool) masks down pairs for the whole window
    at the feasibility stage, with the degraded fallback of
    ``core.policies.mo_scores``. The unhoisted kernel recomputes
    feasibility from raw mAP, so a masked window on ``"cuda"`` routes
    through the hoisted kernel, the mask entering via the precompute."""
    backend = resolve_backend(backend, T.device)
    if backend.startswith("cuda") and T.device.type != "cuda":
        raise ValueError(f"moscore backend {backend!r} needs CUDA tensors, "
                         f"got {T.device}; use 'hoisted' or 'ref' on the CPU")
    if backend == "ref":
        return ref_moscore_route(T, E, mAP, gs, q0, delta=delta,
                                 gamma=gamma, health=health)
    if backend == "hoisted":
        return mo_select_batch_hoisted(ProfileTable(T, E, mAP), gs, q0,
                                       delta=delta, gamma=gamma,
                                       health=health)
    gs = gs.to(torch.int32).contiguous()
    q0 = q0.to(torch.float32).contiguous()
    if backend == "cuda_hoisted" or health is not None:
        feasible, E_n = mo_precompute(T, E, mAP, delta=delta, health=health)
        return moscore_hoisted_cuda(
            T.t().contiguous(), E_n.t().contiguous(),
            feasible.t().contiguous(), gs, q0, gamma=gamma)
    return moscore_cuda(T.t().contiguous(), E.t().contiguous(),
                        mAP.t().contiguous(), gs, q0, delta=delta,
                        gamma=gamma)
