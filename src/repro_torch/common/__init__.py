"""Common substrate of the port: configuration dataclasses and the dtype
names of the precision policy (``repro.common`` counterparts)."""

from repro_torch.common.configs import LMConfig, ShapeSpec, TrainingConfig
from repro_torch.common.precision import parse_dtype

__all__ = ["LMConfig", "ShapeSpec", "TrainingConfig", "parse_dtype"]
