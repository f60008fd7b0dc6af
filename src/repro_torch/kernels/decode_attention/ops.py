"""Public decode attention (port of
``repro.kernels.decode_attention.ops``): the split-count heuristic, the
split-K kernel and the fp32 LSE combine over splits, which stays plain
PyTorch after the kernel as JAX kept it outside the Pallas kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_cuda)


def _pick_splits(s: int, d: int, target_block_bytes: int = 4 << 20) -> int:
    block = max(128, target_block_bytes // (2 * d * 2))   # bf16 k+v
    n = max(1, s // block)
    while s % n != 0:
        n -= 1
    return n


def decode_attention(q, k, v, kv_len=None, *, n_splits: int = 0):
    """q: (B, H, D); k/v: (B, S, KV, D); kv_len: (B,) valid length or None.
    Split-K partials from the kernel (its plain version on CPU tensors),
    fp32 LSE combine here. Returns (B, H, D) in q.dtype."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    ns = n_splits or _pick_splits(s, d)
    o_p, lse_p = decode_attention_cuda(q, k, v, kv_len.to(torch.int32),
                                       n_splits=ns)
    # combine partials: softmax over splits in fp32
    lse = lse_p[..., 0]                                   # (BKV, NS, G)
    m = lse.amax(dim=1, keepdim=True)
    w = torch.exp(lse - m)                                # (BKV, NS, G)
    num = (o_p * w[..., None]).sum(dim=1)                 # (BKV, G, D)
    den = w.sum(dim=1)                                    # (BKV, G)
    out = num / den[..., None]
    return out.reshape(b, kv, g, d).reshape(b, h, d).to(q.dtype)
