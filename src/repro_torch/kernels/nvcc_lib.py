"""Build and load the attention kernels' shared library.

The CUDA sources of ``flash_attention/csrc`` (the bf16 tensor-core kernel
and the split-tf32 one for a float32 q) and ``decode_attention/csrc``
expose a plain C interface. At first use they are compiled for sm_90a by
``nvcc``, one process per source, all started together, linked into one
shared library under ``build/torch_ext/`` at the root of the checkout, and
loaded with ``ctypes``. The library's name carries a hash of the sources
and flags, so an edit rebuilds it and an unchanged tree reuses it. Nothing
here runs when the module is imported."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
SOURCES = (_KERNELS / "flash_attention" / "csrc" / "flash_attention_mma.cu",
           _KERNELS / "flash_attention" / "csrc" / "flash_attention_3xtf32.cu",
           _KERNELS / "decode_attention" / "csrc" / "decode_attention.cu")
#: headers the sources include: they too key the library's name
HEADERS = (_KERNELS / "flash_attention" / "csrc" / "flash_common.cuh",)
#: where the library is built: ``build/torch_ext`` in the checkout
BUILD_DIR = _KERNELS.parents[2] / "build" / "torch_ext"
#: no fast math: expf and IEEE division keep fp32 within 1e-5 of the
#: plain versions; -Xptxas -v writes registers and spills to the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
#: (name, restype, argtypes) of every C entry point
_SIGNATURES = (
    ("fa_forward_mma", _I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _STRIDES, _I, _I, ctypes.c_float, _P)),
    ("fa_forward_3xtf32", _I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _STRIDES, _I, _I, ctypes.c_float, _P)),
    ("dec_forward", _I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _STRIDES, ctypes.c_float, _P)),
    ("dec_forward_fused", _I, (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _STRIDES, ctypes.c_float, _P)),
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the attention "
                           "kernels are built with its nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libattention-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source at once, link, and return the library's path.
    The compiler's output, ptxas's register report included, goes to a
    ``.log`` beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{tag}.so"
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, "-shared", "-gencode",
                               "arch=compute_90a,code=sm_90a",
                               *map(str, objs), "-o", str(tmp)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(logs))
    if link is None or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("building the attention kernels failed:\n"
                           + "\n".join(logs)[-8000:])
    os.replace(tmp, lib)
    return lib


@functools.cache
def attention_library() -> ctypes.CDLL:
    """Build (first call) and load the library, with every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, restype, argtypes in _SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


def strides_arg(*strides: int):
    """A C array of element strides for the launchers."""
    return (ctypes.c_longlong * len(strides))(*strides)


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
