from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_cuda, decode_attention_fused, decode_attention_splits)
from repro_torch.kernels.decode_attention.ops import (_pick_splits,
                                                      card_splits,
                                                      decode_attention)
from repro_torch.kernels.decode_attention.ref import (ref_decode_attention,
                                                      ref_decode_fused,
                                                      ref_decode_splits)

__all__ = ["card_splits", "decode_attention", "decode_attention_cuda",
           "decode_attention_fused", "decode_attention_splits",
           "ref_decode_attention", "ref_decode_fused", "ref_decode_splits",
           "_pick_splits"]
