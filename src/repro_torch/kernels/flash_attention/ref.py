"""Plain PyTorch attention (port of
``repro.kernels.flash_attention.ref``): the oracle of the flash kernel and
its plain version on CPU tensors."""

from __future__ import annotations

import torch


def ref_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D). fp32 softmax, output in
    q.dtype. Query row i sits at key position i + ``q_offset``: with
    ``causal`` it sees keys 0..i + q_offset (top-left aligned at 0, as
    ``repro.models.layers._causal_mask``)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, sq, kv, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] + q_offset \
            >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
