from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import ref_attention

__all__ = ["flash_attention", "flash_attention_bhsd", "flash_attention_cuda",
           "ref_attention"]
