"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified]: 32L d_model=2560
32H (GQA kv=32 = MHA) d_ff=6912 vocab=50304, dense, LayerNorm."""

from repro_torch.common.configs import LMConfig, TrainingConfig
from repro_torch.configs.base import Arch

CONFIG = LMConfig(
    name="stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50_304, norm="layernorm",
)

REDUCED = LMConfig(
    name="stablelm-3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512, norm="layernorm", dtype="float32",
)

ARCH = Arch(
    id="stablelm-3b", family="lm", config=CONFIG,
    train=TrainingConfig(optimizer="adamw", lr=3e-4, remat="dots"),
    reduced=REDUCED, source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
