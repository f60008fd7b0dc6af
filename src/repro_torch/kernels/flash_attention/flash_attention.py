"""Wrappers of the flash attention CUDA kernels (port of ``_fa_kernel``):
``csrc/flash_attention_mma.cu`` for a bf16 q against bf16 K/V (bf16
tensor cores), ``csrc/flash_attention_3xtf32.cu`` for a float32 q against
float32 or bf16 K/V (tf32 tensor cores with each fp32 operand split in
two, where the 1e-5 of the fp32 path holds).

``flash_attention_cuda`` takes the GQA layout, q (B, Sq, H, D) and k/v
(B, Sk, KV, D), with any strides that keep D contiguous: query head h
reads KV head h // (H // KV) by index, so no repeated or transposed copy
of K/V is made. Query row i sits at key position i + ``q_offset``, so a
chunk of a prompt attends to the cache written before it.
``flash_attention_bhsd`` keeps the JAX wrapper's (BH, S, D) layout. On
CPU tensors both run the plain PyTorch version (``ref_attention``); on
CUDA tensors they launch the kernel that the dtypes select
(``kernel_for``) or raise, never the other one. Each launch adds one to
``flash_attention_cuda.launches`` and to the launched kernel's entry of
``flash_attention_cuda.kernel_launches``."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import ref_attention
from repro_torch.kernels.nvcc_lib import (attention_library, check_launch,
                                          strides_arg)

#: the kernels keep up to 128 head-dim columns per row; D % 8 == 0
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
#: the bf16 tensor-core kernel (bf16 q and K/V) and the split-tf32 one
#: (float32 q)
KERNELS = ("flash_fwd_mma", "flash_fwd_3xtf32")


def kernel_for(q_dtype: torch.dtype) -> str:
    """The CUDA kernel that a query of this dtype launches."""
    return "flash_fwd_mma" if q_dtype == torch.bfloat16 \
        else "flash_fwd_3xtf32"


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, KV, D) "
                         f"of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 \
            or h % k.shape[2] or k.shape[1] == 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, H % KV, Sk > 0)")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"each float32 or bfloat16, k and v alike")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise ValueError("a bfloat16 q against float32 k/v is not built: "
                         "the kernel takes q and k/v alike, or a float32 q "
                         "against a bfloat16 cache")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dim")
        # both kernels copy rows in 16-byte pieces
        if any(x * t.element_size() % 16 for x in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels take strides in "
                             f"multiples of 16 bytes and a 16-byte aligned "
                             f"start")


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float,
                         q_offset: int = 0):
    """Attention of q (B, Sq, H, D) over k/v (B, Sk, KV, D) -> (B, Sq, H, D)
    in q.dtype, fp32 softmax. With ``causal`` query row i sees keys
    0..i + ``q_offset`` (top-left aligned at offset 0, as ``_fa_kernel``
    and ``mha(q_offset=)``)."""
    q_offset = int(q_offset)
    if not 0 <= q_offset < 2 ** 30:
        raise ValueError(f"q_offset {q_offset}: the kernels take a "
                         f"non-negative int32 offset")
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset)
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    st = strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    rest = (b, h, kv, sq, sk, d, st, int(causal), q_offset, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    kernel = kernel_for(q.dtype)
    lib = attention_library()
    if kernel == "flash_fwd_mma":
        err = lib.fa_forward_mma(*ptrs, *rest)
    else:
        err = lib.fa_forward_3xtf32(*ptrs, int(k.dtype == torch.bfloat16),
                                    *rest)
    check_launch(f"flash_attention_cuda ({kernel})", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.kernel_launches[kernel] += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.kernel_launches = dict.fromkeys(KERNELS, 0)


def flash_attention_bhsd(q, k, v, *, causal: bool, scale: float):
    """q: (BH, Sq, D); k/v: (BH, Sk, D) (kv heads already broadcast), the
    layout of ``repro``'s ``flash_attention_bhsd``."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected (BH, S, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    o = flash_attention_cuda(q[:, :, None], k[:, :, None], v[:, :, None],
                             causal=causal, scale=scale)
    return o[:, :, 0]
