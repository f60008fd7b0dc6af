#!/usr/bin/env python3
"""Where the float32 flash kernel's error comes from, on one NVIDIA GPU.

    python3 scripts/flash_fp32_accuracy.py

Builds ``flash_attention_3xtf32.cu`` (in
``src/repro_torch/kernels/flash_attention/csrc/``) in three variants
that differ only in how the split-tf32 products are summed, each made
from the source by naming ``mma_3x`` (every ``mma``
into the running accumulator, the tensor core's own accumulate) or
``mma_3x_add`` (each step's products in zeroed registers, then one
round-to-nearest add) at the two products' call sites:

- ``direct``: both products as ``mma_3x``;
- ``pv_fresh``: P·V as ``mma_3x_add``, Q·K^T as ``mma_3x``;
- ``both_fresh``: both as ``mma_3x_add``.

On each case it holds every variant, and the float32 plain version
(``ref_attention``), against the same attention computed in float64:
the largest error, the drift (the sum of the errors' components toward
zero, over the sum of |output|: a sum that loses magnitude step by step
shows as a negative drift), and the least atol that the 1e-5 check
against the float32 plain version needs at rtol 1e-5. It also times each
variant at the LM prefill shape by CUDA-graph replay and prints ptxas's
registers and spills. One JSON line per case, then the card's name and
power limit. Without a CUDA device it exits 1."""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build" / "flash_fp32_accuracy"
# (Q.K^T, P.V) helper of each variant
VARIANTS = {"direct": ("mma_3x", "mma_3x"),
            "pv_fresh": ("mma_3x", "mma_3x_add"),
            "both_fresh": ("mma_3x_add", "mma_3x_add")}
# (B, Sq, Sk, H, KV, D, causal, q_offset, K/V dtype)
CASES = [(4, 2048, 2560, 32, 32, 80, True, 0, torch.bfloat16),
         (4, 2048, 2560, 32, 32, 80, True, 0, torch.float32),
         (4, 1024, 2560, 32, 32, 80, True, 1024, torch.bfloat16),
         (2, 512, 512, 32, 8, 128, True, 0, torch.float32),
         (1, 300, 333, 4, 4, 80, False, 0, torch.bfloat16)]
RTOL = ATOL = 1e-5


def variant_source(qk: str, pv: str) -> str:
    """The kernel's source with the two products' helpers named."""
    src = (CSRC / "flash_attention_3xtf32.cu").read_text()
    src, n_qk = re.subn(r"mma_3x(?:_add)?(<KV16>\(s\[j\])", qk + r"\1", src)
    src, n_pv = re.subn(r"mma_3x(?:_add)?(<KV16>\(acc\[)", pv + r"\1", src)
    if (n_qk, n_pv) != (2, 2):
        raise RuntimeError(f"expected 2 call sites per product, found "
                           f"{n_qk} and {n_pv}")
    return src


def build(name: str) -> tuple[Path, str]:
    from repro_torch.kernels.nvcc_lib import NVCC_FLAGS, _nvcc

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "flash_common.cuh", d)
    cu = d / "flash_attention_3xtf32.cu"
    cu.write_text(variant_source(*VARIANTS[name]))
    lib = d / "lib.so"
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", str(cu), "-o",
                          str(lib)], capture_output=True, text=True,
                         timeout=900)
    if out.returncode:
        raise RuntimeError(f"{name} does not build:\n{out.stderr[-4000:]}")
    return lib, out.stdout + out.stderr


def load(lib: Path) -> ctypes.CDLL:
    from repro_torch.kernels.nvcc_lib import _SIGNATURES

    cdll = ctypes.CDLL(str(lib))
    for name, restype, argtypes in _SIGNATURES:
        if name == "fa_forward_3xtf32":
            cdll.fa_forward_3xtf32.restype = restype
            cdll.fa_forward_3xtf32.argtypes = list(argtypes)
    return cdll


def attention_f64(q, k, v, *, causal, scale, q_offset):
    """The same attention in float64, one (batch, KV head) at a time."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    keep = torch.arange(sq, device=q.device)[:, None] + q_offset \
        >= torch.arange(sk, device=q.device)[None, :]
    for i in range(b):
        for j in range(kv):
            qq = q[i, :, j * g:(j + 1) * g].double()
            s = torch.einsum("qgd,sd->gqs", qq, k[i, :, j].double()) * scale
            if causal:
                s = s.masked_fill(~keep, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[i, :, j * g:(j + 1) * g] = torch.einsum(
                "gqs,sd->qgd", p, v[i, :, j].double())
    return out


def errors(got, want64, plain):
    """Largest error and drift against float64; least atol at rtol 1e-5
    against the float32 plain version."""
    from chip_smoke import _close

    e = got.double() - want64
    drift = float((e * want64.sign()).sum() / want64.abs().sum())
    _, _, need = _close(got, plain, RTOL, ATOL)
    return {"max_abs_err_f64": float(e.abs().max()), "drift": drift,
            "atol_needed_vs_plain": need}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fp32_accuracy: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.kernels.flash_attention.flash_attention  # noqa: F401
    from chip_smoke import graph_ms, nvidia_smi, ptxas_report
    from repro_torch.kernels.flash_attention import ref_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    wrapper_mod = sys.modules[
        "repro_torch.kernels.flash_attention.flash_attention"]
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    libs = {n: load(lib) for n, (lib, _) in built.items()}
    print(json.dumps({"ptxas": {
        n: [r for r in ptxas_report(log) if "<80" in r["kernel"]]
        for n, (_, log) in built.items()}}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, sq, sk, h, kv, d, causal, off, kvdt in CASES:
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda")
        k = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(kvdt)
        v = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(kvdt)
        sc = d ** -0.5
        want64 = attention_f64(q, k, v, causal=causal, scale=sc, q_offset=off)
        plain = ref_attention(q, k, v, causal=causal, scale=sc, q_offset=off)
        row = {"case": {"B": b, "Sq": sq, "Sk": sk, "H": h, "KV": kv, "D": d,
                        "causal": causal, "q_offset": off,
                        "kv_dtype": str(kvdt)[6:]},
               "plain_f32": errors(plain, want64, plain)}
        for n, cdll in libs.items():
            wrapper_mod.attention_library = lambda cdll=cdll: cdll
            call = lambda: wrapper_mod.flash_attention_cuda(  # noqa: E731
                q, k, v, causal=causal, scale=sc, q_offset=off)
            r = errors(call(), want64, plain)
            if (b, sq, sk) == (4, 2048, 2560):
                r["ms"] = graph_ms(call, 20)
            row[n] = r
        print(json.dumps(row), flush=True)
        del q, k, v, want64, plain
    print(nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
