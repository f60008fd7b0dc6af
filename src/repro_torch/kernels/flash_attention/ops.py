"""Public flash attention (port of ``repro.kernels.flash_attention.ops``):
the GQA layout at the function, the kernel underneath.

JAX repeats the KV heads and folds heads into the batch before its
kernel; here the kernel reads K/V in place by index, so the same call
makes no copy of them."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) -> (B, Sq, H, D), scaled by
    1/sqrt(D); query row i sits at key position i + ``q_offset`` (a chunk
    of a prompt prefilled into a cache at that position). CPU tensors
    take the plain version, CUDA tensors the kernel."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                q_offset=q_offset)
