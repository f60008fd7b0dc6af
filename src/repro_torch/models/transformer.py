"""Decoder-only dense LM for serving (port of
``repro.models.transformer``).

Weights keep the JAX package's layout, stacked along a leading layer dim
in a nested dict, so ``params_from_numpy`` carries a JAX tree across
unchanged; ``forward`` loops over the layers in Python where JAX scans.

Exposes:
  * param_specs(cfg)                   -> nested dict of (shape, dtype)
  * init_params(cfg, generator, device=...)   -> params from a generator
  * params_from_numpy(cfg, tree, device=...)  -> params from a JAX tree
  * forward(cfg, params, tokens, ...)  -> logits or hidden states
  * cache_specs / init_cache, prefill, decode_step: serving with stacked
    (L, B, max_seq, KV, hd) k/v caches, written IN PLACE (JAX returns new
    arrays); prefill and decode_step still return the cache dict.

MoE, the int8 KV cache, ``chunked_xent`` and the training loss wait for
later slices (ROADMAP.md) and raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.configs import LMConfig
from repro_torch.common.precision import parse_dtype
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

f32 = torch.float32


# ------------------------------------------------------------ parameters ---

def param_specs(cfg: LMConfig) -> dict[str, Any]:
    """Nested dict of ``(shape, dtype)`` leaves, the JAX package's tree."""
    if cfg.moe:
        raise NotImplementedError(
            "MoE LMs are not ported yet (ROADMAP.md item 17: models/moe.py)")
    dt = parse_dtype(cfg.dtype)
    Ln, D, H, KV, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    attn = {
        "norm": ((Ln, D), f32),
        "wq": ((Ln, D, H * hd), dt),
        "wk": ((Ln, D, KV * hd), dt),
        "wv": ((Ln, D, KV * hd), dt),
        "wo": ((Ln, H * hd, D), dt),
    }
    mlp = {
        "norm": ((Ln, D), f32),
        "w_gate": ((Ln, D, cfg.d_ff), dt),
        "w_up": ((Ln, D, cfg.d_ff), dt),
        "w_down": ((Ln, cfg.d_ff, D), dt),
    }
    if cfg.norm == "layernorm":
        attn["norm_bias"] = ((Ln, D), f32)
        mlp["norm_bias"] = ((Ln, D), f32)
    shapes: dict[str, Any] = {
        "embed": ((cfg.vocab_size, D), dt),
        "final_norm": ((D,), f32),
        "layers": {"attn": attn, "mlp": mlp},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((cfg.vocab_size, D), dt)
    return shapes


def init_params(cfg: LMConfig, generator: torch.Generator | None = None, *,
                device=None):
    """Random params on ``device`` (the CUDA device by default) from
    ``generator`` (seed 0 when None). On the ``meta`` device only the
    shapes are made."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return L.init_tree(generator, param_specs(cfg), device=dev)


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, bit for bit
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: LMConfig, tree, *, device=None):
    """The JAX package's parameter tree (stacked on the layer axis, leaves
    as numpy arrays) as the port's params on ``device``."""
    dev = resolve_device(device)

    def carry(spec, node, path):
        if isinstance(spec, dict):
            missing = set(spec) ^ set(node)
            if missing:
                raise ValueError(f"{path or 'params'}: keys differ from "
                                 f"param_specs: {sorted(missing)}")
            return {k: carry(spec[k], node[k], f"{path}/{k}") for k in spec}
        shape, dtype = spec
        if tuple(np.shape(node)) != shape:
            raise ValueError(f"{path}: shape {np.shape(node)}, expected "
                             f"{shape}")
        return _tensor(node, dtype, dev)

    return carry(param_specs(cfg), tree, "")


def n_params(params) -> int:
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    return params.numel()


def _layer(params, i: int):
    """Layer ``i``'s weights: views into the stacked params."""
    return {part: {k: w[i] for k, w in ws.items()}
            for part, ws in params["layers"].items()}


# --------------------------------------------------------------- forward ---

def _layer_body(cfg: LMConfig, attn_impl: str, x, w, positions, cache,
                cache_pos):
    """One transformer layer. cache: dict or None."""
    attn_out, new_cache = L.attention_block(
        x, w["attn"], cfg, positions=positions, causal=True,
        cache=cache, cache_pos=cache_pos, attn_impl=attn_impl)
    x = x + attn_out
    wm = w["mlp"]
    xn = L.norm_apply(cfg.norm, x, wm["norm"], wm.get("norm_bias"))
    x = x + L.swiglu(xn, wm)
    return x, new_cache


def _final_norm(cfg: LMConfig, x, params):
    return L.rmsnorm(x, params["final_norm"]) if cfg.norm == "rmsnorm" \
        else L.layernorm(x, params["final_norm"])


def _head(params, x):
    head = params.get("lm_head", params["embed"])
    return x @ head.T.to(x.dtype)


def forward(cfg: LMConfig, params, tokens, *, attn_impl: str = "auto",
            caches=None, cache_pos=None, return_hidden: bool = False):
    """tokens: (B,S) -> logits (B,S,V) [or hidden (B,S,D)].

    ``caches``: stacked (L, B, Smax, KV, hd) k/v tensors for serving,
    written in place; returns (out, caches) when provided, else
    (out, aux_loss = 0)."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    start = 0 if cache_pos is None else int(cache_pos)
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    serving = caches is not None
    if serving and "k_scale" in caches:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, items 16-17: "
            "int8 KV cache)")
    for i in range(cfg.n_layers):
        cache = {"k": caches["k"][i], "v": caches["v"][i]} if serving \
            else None
        x, _ = _layer_body(cfg, attn_impl, x, _layer(params, i), positions,
                           cache, cache_pos)
    x = _final_norm(cfg, x, params)
    out = x if return_hidden else _head(params, x)
    if serving:
        return out, caches
    return out, torch.zeros((), dtype=f32, device=x.device)


# --------------------------------------------------------------- serving ---

def cache_specs(cfg: LMConfig, batch: int, max_seq: int, dtype=None):
    """``{"k": (shape, dtype), "v": ...}`` of the stacked cache; bf16 unless
    ``dtype`` says otherwise, whatever the params' dtype (as in JAX)."""
    if cfg.kv_cache_dtype == "int8" or dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, items 16-17: "
            "int8 KV cache)")
    dtype = torch.bfloat16 if dtype is None else dtype
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None, *,
               device=None):
    """Zeroed k/v caches on ``device`` (the CUDA device by default)."""
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_specs(cfg, batch, max_seq,
                                              dtype).items()}


def prefill(cfg: LMConfig, params, tokens, caches, *,
            attn_impl: str = "auto"):
    """Run the prompt through the model, filling ``caches`` from position 0
    (in place). Returns (last-token logits, caches). Only the final
    position goes through the LM head."""
    hidden, caches = forward(cfg, params, tokens, caches=caches, cache_pos=0,
                             attn_impl=attn_impl, return_hidden=True)
    return _head(params, hidden[:, -1]), caches


def decode_step(cfg: LMConfig, params, token, caches, pos: int, *,
                attn_impl: str = "auto"):
    """One decode step: token (B,1) against caches filled up to ``pos``;
    writes position ``pos`` in place. Returns (logits (B,V), caches)."""
    out, caches = forward(cfg, params, token, caches=caches, cache_pos=pos,
                          attn_impl=attn_impl)
    return out[:, -1], caches
