"""Public decode attention (port of
``repro.kernels.decode_attention.ops``).

On CUDA tensors one launch gives the output: the fused kernel splits the
valid prefix ``card_splits`` ways (or ``n_splits``) and merges the splits
inside the launch. On CPU tensors it is the plain path of the JAX
package: ``_pick_splits`` (the TPU's heuristic, copied), the split-K
partials and the fp32 LSE combine over splits in plain PyTorch."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    MAX_FUSED_SPLITS, decode_attention_cuda, decode_attention_fused)


def _pick_splits(s: int, d: int, target_block_bytes: int = 4 << 20) -> int:
    block = max(128, target_block_bytes // (2 * d * 2))   # bf16 k+v
    n = max(1, s // block)
    while s % n != 0:
        n -= 1
    return n


# the fewest cache positions a split of the fused kernel is given
MIN_SPLIT_POSITIONS = 256


def card_splits(bkv: int, s: int, n_sm: int) -> int:
    """Splits of the fused kernel on a card of ``n_sm`` SMs: as many as
    keep the ``bkv`` (batch x KV head) rows within one 8-warp CTA per SM,
    at least one, at most one cluster (8), and no fewer than
    ``MIN_SPLIT_POSITIONS`` cache positions per split. 1 at the
    stablelm-3b decode shape (bkv = 128, 132 SMs): there more splits
    measured slower (PERF.md)."""
    return max(1, min(MAX_FUSED_SPLITS, n_sm // max(bkv, 1),
                      s // MIN_SPLIT_POSITIONS))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, kv_len=None, *, n_splits: int = 0):
    """q: (B, H, D); k/v: (B, S, KV, D); kv_len: (B,) int32 valid length,
    one int for every row, or None (the whole cache). Returns (B, H, D) in
    q.dtype; a row with kv_len = 0 gives zeros. ``n_splits = 0`` picks the
    split count: ``card_splits`` on CUDA, ``_pick_splits`` on the CPU."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    if kv_len is None:
        kv_len = s
    if q.device.type == "cuda":
        ns = n_splits or card_splits(b * kv, s, _sm_count(q.device.index))
        if not isinstance(kv_len, int):
            kv_len = kv_len.to(torch.int32)
        return decode_attention_fused(q, k, v, kv_len, n_splits=ns)
    if isinstance(kv_len, int):
        kv_len = torch.full((b,), kv_len, dtype=torch.int32, device=q.device)
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
