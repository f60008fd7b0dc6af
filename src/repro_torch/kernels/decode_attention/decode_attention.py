"""Wrappers of the split-K decode attention CUDA kernel
(``csrc/decode_attention.cu``, port of ``_dec_kernel``).

``decode_attention_cuda`` takes the serving layout: q (B, H, D) and the
cache k/v (B, S, KV, D), read in place through strides (JAX transposes
the whole cache to (B * KV, S, D) on every call; here that would be a
copy per layer per decoded token). ``decode_attention_splits`` keeps the
JAX wrapper's (B * KV, G, D) / (B * KV, S, D) layout. Both return the
fp32 partials and per-split LSE; the combine stays in ``ops.py``. On CPU
tensors they run the plain PyTorch version (``ref_decode_splits``); on
CUDA tensors they launch the kernel or raise. Each launch adds one to
``decode_attention_cuda.launches``."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import ref_decode_splits
from repro_torch.kernels.nvcc_lib import (attention_library, check_launch,
                                          strides_arg)

#: each lane holds 4 head-dim elements: D <= 128, a multiple of 8
MAX_HEAD_DIM = 128
#: query rows per KV head (H // KV) the kernel keeps in registers
MAX_GROUP = 8
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, kv_len, n_splits) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the decode kernel runs on CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, D) and k, v (B, S, KV, D) of "
                         f"one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, H % KV)")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per KV head: the kernel "
                         f"takes at most {MAX_GROUP}")
    if n_splits < 1 or s % n_splits:
        raise ValueError(f"n_splits {n_splits} must divide S = {s}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"each float32 or bfloat16, k and v alike")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise ValueError("a bfloat16 q against float32 k/v is not built: "
                         "the kernel takes q and k/v alike, or a float32 q "
                         "against a bfloat16 cache")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) \
            or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be a contiguous (B,) int32 tensor, "
                         f"got {kv_len.dtype} {tuple(kv_len.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        # one 4-element load per lane: 4-element aligned rows
        if t.stride(3) != 1 or any(x % 4 for x in t.stride()[:3]) \
                or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must be contiguous along the head dim "
                             f"with strides and offset in multiples of 4")


def decode_attention_cuda(q, k, v, kv_len, *, n_splits: int):
    """Split-K partials of q (B, H, D) against the cache k/v (B, S, KV, D),
    masked by kv_len (B,) int32: o (B * KV, n_splits, G, D) and lse
    (B * KV, n_splits, G, 1), both fp32."""
    if q.device.type == "cpu":
        return ref_decode_splits(q, k, v, kv_len, n_splits=n_splits)
    _check(q, k, v, kv_len, n_splits)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    o = torch.empty((b * kv, n_splits, g, d), dtype=torch.float32,
                    device=q.device)
    lse = torch.empty((b * kv, n_splits, g, 1), dtype=torch.float32,
                      device=q.device)
    err = attention_library().dec_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), lse.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), b, kv, g, s, d, n_splits,
        strides_arg(*k.stride()[:3], *v.stride()[:3]), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention_cuda", err)
    decode_attention_cuda.launches += 1
    return o, lse


decode_attention_cuda.launches = 0


def decode_attention_splits(q, k, v, kv_len, *, n_splits: int):
    """q: (BKV, G, D); k/v: (BKV, S, D); kv_len: (BKV, 1) int32, the layout
    of ``repro``'s ``decode_attention_splits``. Returns partials
    o: (BKV, n_splits, G, D), lse: (BKV, n_splits, G, 1)."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected (BKV, G, D) and (BKV, S, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return decode_attention_cuda(q, k[:, :, None], v[:, :, None],
                                 kv_len.reshape(-1), n_splits=n_splits)
