"""Wrappers of the decode attention CUDA kernel
(``csrc/decode_attention.cu``, port of ``_dec_kernel``).

``decode_attention_cuda`` takes the serving layout: q (B, H, D) and the
cache k/v (B, S, KV, D), read in place through strides (JAX transposes
the whole cache to (B * KV, S, D) on every call; here that would be a
copy per layer per decoded token), and returns the fp32 split-K partials
and per-split LSE, as ``_dec_kernel`` writes them; the combine then runs
in ``ops.py``. ``decode_attention_splits`` keeps the JAX wrapper's
(B * KV, G, D) / (B * KV, S, D) layout. ``decode_attention_fused`` runs
the same streaming loop over even pieces of the valid prefix and merges
the pieces inside the launch (a thread-block cluster per batch x KV
head): the (B, H, D) output in q's dtype from one launch. On CPU tensors
they run the plain PyTorch versions (``ref_decode_splits``,
``ref_decode_fused``); on CUDA tensors they launch the kernel or raise.
Each launch adds one to the wrapper's ``launches``."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import (ref_decode_fused,
                                                      ref_decode_splits)
from repro_torch.kernels.nvcc_lib import (attention_library, check_launch,
                                          strides_arg)

#: each lane holds 16 bytes of a row: D <= 128, a multiple of 8
MAX_HEAD_DIM = 128
#: query rows per KV head (H // KV) the kernel keeps in registers
MAX_GROUP = 8
#: the fused kernel merges its splits in one cluster of at most 8 CTAs
MAX_FUSED_SPLITS = 8
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, kv_len, n_splits, *, fused: bool = False) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the decode kernel runs on CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)) + (
            () if isinstance(kv_len, int) else (("kv_len", kv_len),)):
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
    if fused and not 1 <= n_splits <= MAX_FUSED_SPLITS:
        raise ValueError(f"n_splits {n_splits}: the fused kernel merges 1 "
                         f"to {MAX_FUSED_SPLITS} splits in one cluster")
    if not fused and (n_splits < 1 or s % n_splits):
        raise ValueError(f"n_splits {n_splits} must divide S = {s}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"each float32 or bfloat16, k and v alike")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise ValueError("a bfloat16 q against float32 k/v is not built: "
                         "the kernel takes q and k/v alike, or a float32 q "
                         "against a bfloat16 cache")
    is_int = isinstance(kv_len, int)
    if not (is_int and fused) and not (
            isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32
            and tuple(kv_len.shape) == (b,) and kv_len.is_contiguous()):
        got = type(kv_len).__name__ if is_int else \
            f"{kv_len.dtype} {tuple(kv_len.shape)}"
        raise ValueError(f"kv_len must be a contiguous (B,) int32 tensor"
                         f"{' or an int' if fused else ''}, got {got}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        # one 16-byte copy per lane: rows on 16-byte boundaries
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or any(x % vec for x in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous along the head dim "
                             f"with strides in multiples of {vec} elements "
                             f"and a 16-byte aligned start")


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


def decode_attention_fused(q, k, v, kv_len, *, n_splits: int):
    """Decode attention of q (B, H, D) against the cache k/v (B, S, KV, D)
    masked by kv_len, a (B,) int32 tensor or one int for every row:
    (B, H, D) in q.dtype, zeros for a row with kv_len = 0. The valid
    prefix is cut into ``n_splits`` (1..8) even pieces, one CTA each,
    merged inside the launch with ``ops.py``'s LSE combine."""
    if q.device.type == "cpu":
        return ref_decode_fused(q, k, v, kv_len)
    _check(q, k, v, kv_len, n_splits, fused=True)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    fixed = isinstance(kv_len, int)
    err = attention_library().dec_forward_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if fixed else kv_len.data_ptr(), kv_len if fixed else 0,
        out.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), b, kv, h // kv, s, d, n_splits,
        strides_arg(*k.stride()[:3], *v.stride()[:3]), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention_fused", err)
    decode_attention_fused.launches += 1
    return out


decode_attention_fused.launches = 0


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
