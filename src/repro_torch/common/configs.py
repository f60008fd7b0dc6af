"""Configuration dataclasses (port of ``repro.common.configs``).

Only the decoder LM is ported: ``ShapeSpec`` cells, ``LMConfig`` with its
parameter counts, and the ``TrainingConfig`` that an ``Arch`` carries.
The dataclasses are frozen, as in the JAX package, so a config can key a
cache."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: ``kind`` is ``train``, ``prefill``,
    ``decode`` or ``serve``."""

    name: str
    kind: str
    global_batch: int
    seq_len: int = 0          # LM cells
    img_res: int = 0          # vision / diffusion cells
    steps: int = 0            # diffusion sampler steps

    def __post_init__(self) -> None:
        if self.kind not in ("train", "prefill", "decode", "serve"):
            raise ValueError(f"unknown shape kind {self.kind!r}")


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (optionally MoE)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0         # DeepSeek: always-on shared experts
    d_expert: int = 0                 # per-expert FFN width (0 -> d_ff)
    moe_dense_residual: bool = False  # Arctic: dense FFN residual in parallel
    capacity_factor: float = 1.25
    router_impl: str = "topk"         # topk | balanced
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_exp(self) -> int:
        return self.d_expert or self.d_ff

    def n_params(self) -> int:
        """Total parameter count."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        dense_ff = 0
        moe_ff = 0
        router = 0
        if self.moe:
            if self.n_shared_experts:
                dense_ff += 3 * d * (self.n_shared_experts * self.d_exp)
            if self.moe_dense_residual:
                dense_ff += 3 * d * self.d_ff
            moe_ff = self.n_experts * 3 * d * self.d_exp
            router = d * self.n_experts
        else:
            dense_ff = 3 * d * self.d_ff
        per_layer = attn + dense_ff + moe_ff + router + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed top-k count)."""
        if not self.moe:
            return self.n_params()
        inactive = self.n_layers * (self.n_experts - self.top_k) \
            * 3 * self.d_model * self.d_exp
        return self.n_params() - inactive


@dataclass(frozen=True)
class TrainingConfig:
    """Optimizer / schedule / parallelism knobs for train cells."""

    optimizer: str = "adamw"           # adamw | adafactor | sgdm
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0                # 0 -> no gradient accumulation
    remat: str = "full"                # none | dots | full
    grad_compression: str = "none"     # none | int8
    label_smoothing: float = 0.0
