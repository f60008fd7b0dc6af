"""Arch descriptor and the LM shape cells (port of
``repro.configs.base``; the diffusion and vision cells wait for their
model families)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.common.configs import ShapeSpec, TrainingConfig

LM_SHAPES = (
    ShapeSpec("train_4k", "train", global_batch=256, seq_len=4096),
    ShapeSpec("prefill_32k", "prefill", global_batch=32, seq_len=32_768),
    ShapeSpec("decode_32k", "decode", global_batch=128, seq_len=32_768),
    ShapeSpec("long_500k", "decode", global_batch=1, seq_len=524_288),
)

FAMILY_SHAPES = {"lm": LM_SHAPES}


@dataclass(frozen=True)
class Arch:
    id: str
    family: str                       # lm (the only ported family)
    config: Any                       # LMConfig
    train: TrainingConfig
    reduced: Any                      # smoke-test-sized config, same family
    source: str = ""                  # citation tag
    notes: str = ""

    @property
    def shapes(self) -> tuple[ShapeSpec, ...]:
        return FAMILY_SHAPES[self.family]

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.id}: unknown shape {name!r}")
