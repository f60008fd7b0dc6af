"""Plain PyTorch decode attention (port of
``repro.kernels.decode_attention.ref``), and the plain version of the
split-K kernel."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_decode_attention(q, k, v, kv_len=None):
    """q: (B, H, D); k/v: (B, S, KV, D); kv_len: (B,) valid prefix length
    (None -> full). Returns (B, H, D)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    scores = scores / (d ** 0.5)
    if kv_len is not None:
        valid = torch.arange(s, device=q.device)[None] < kv_len[:, None]
        scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)


def ref_decode_splits(q, k, v, kv_len, *, n_splits: int):
    """What the split-K kernel computes, as ``_dec_kernel`` defines it.

    q: (B, H, D); k/v: (B, S, KV, D); kv_len: (B,) int. For each
    (b * KV + kv head, split): the G = H // KV query rows against positions
    [split * S/n, (split + 1) * S/n) masked by ``kv_len``. Returns the
    normalised partials (B * KV, n, G, D) and the LSE (B * KV, n, G, 1),
    fp32; a split wholly past ``kv_len`` gives zeros and LSE = -1e30."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    block = s // n_splits
    scale = 1.0 / (d ** 0.5)
    qf = q.reshape(b * kv, g, d).float() * scale
    kf = k.permute(0, 2, 1, 3).reshape(b * kv, n_splits, block, d).float()
    vf = v.permute(0, 2, 1, 3).reshape(b * kv, n_splits, block, d).float()
    sc = torch.einsum("xgd,xnkd->xngk", qf, kf)
    pos = torch.arange(s, device=q.device).reshape(n_splits, block)
    lens = kv_len.to(q.device).repeat_interleave(kv)
    valid = (pos[None] < lens[:, None, None])[:, :, None, :]
    sc = torch.where(valid, sc, NEG_INF)
    m = sc.amax(dim=-1)
    # all-invalid splits produce m = NEG_INF; guard the exp
    m_safe = torch.clamp_min(m, NEG_INF / 2)
    p = torch.exp(sc - m_safe[..., None])
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("xngk,xnkd->xngd", p, vf) \
        / torch.clamp_min(l, 1e-30)[..., None]
    lse = torch.where(l > 0, torch.log(l) + m_safe, NEG_INF)
    return o, lse[..., None]


def ref_decode_fused(q, k, v, kv_len):
    """What the fused kernel computes: decode attention of q (B, H, D)
    against k/v (B, S, KV, D) masked by kv_len ((B,) int, or one int for
    every row), in q.dtype, with zeros for a row that has no valid
    position. Its splits merge to the one-split result, so this is
    ``ref_decode_splits`` with one split."""
    b, h, d = q.shape
    if isinstance(kv_len, int):
        kv_len = torch.full((b,), kv_len, dtype=torch.int32, device=q.device)
    o, _ = ref_decode_splits(q, k, v, kv_len, n_splits=1)
    return o.reshape(b, h, d).to(q.dtype)
