"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b; hf]: 40L d_model=5120 32H
(GQA kv=8) d_ff=13824 vocab=100352, dense, LayerNorm."""

from repro_torch.common.configs import LMConfig, TrainingConfig
from repro_torch.configs.base import Arch

CONFIG = LMConfig(
    name="stablelm-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13_824, vocab_size=100_352, norm="layernorm",
)

REDUCED = LMConfig(
    name="stablelm-12b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=512, norm="layernorm", dtype="float32",
)

ARCH = Arch(
    id="stablelm-12b", family="lm", config=CONFIG,
    train=TrainingConfig(optimizer="adamw", lr=3e-4, remat="dots"),
    reduced=REDUCED, source="hf:stabilityai/stablelm-2-1_6b; hf",
)
