from repro_torch.kernels.flash_attention.flash_attention import (
    KERNELS, flash_attention_bhsd, flash_attention_cuda, kernel_for)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import ref_attention

__all__ = ["KERNELS", "flash_attention", "flash_attention_bhsd",
           "flash_attention_cuda", "kernel_for", "ref_attention"]
