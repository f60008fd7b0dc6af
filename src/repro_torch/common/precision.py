"""Dtype names of the precision policy (port of
``repro.common.precision.parse_dtype``): params and matmuls in the
config's dtype, softmax and norms in float32."""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def parse_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]
