"""Shared neural-net layers (port of ``repro.models.layers``): pure
functions over dicts of tensors.

Compute follows the JAX package's precision policy: matmuls in the
params' dtype, softmax and norms in float32. Where JAX promotes a mixed
pair of dtypes (a float32 query against a bfloat16 cache), ``_promote``
does the same, because torch's matmuls take one dtype. The sharding
``constraint(...)`` calls are the identity on one device and are gone.

Attention in ``attention_block`` goes to the hand-written CUDA kernels on
CUDA tensors (flash attention for the prefill and for the no-cache
forward, split-K decode attention for one query token); on CPU tensors,
or with ``attn_impl="ref"``, it takes the plain path, which mirrors JAX's
``mha``/``chunked_mha`` dtype casts included."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

f32 = torch.float32

#: ``attn_impl`` values: ``auto`` takes the kernels on CUDA tensors and the
#: plain path on CPU tensors; ``ref`` takes the plain path on any device
ATTN_IMPLS = ("auto", "ref")


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion."""
    a, b = _promote(a, b)
    return a @ b


# ---------------------------------------------------------------- norms ----

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * (1.0 + scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def norm_apply(kind: str, x, scale, bias=None):
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


# ----------------------------------------------------------------- rope ----

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, n_heads, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    ang = positions[..., None].to(f32) * freqs               # (...,S,hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ---

def _causal_mask(sq: int, sk: int, q_offset, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    return qpos >= kpos


def mha(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """Grouped-query attention, fp32 softmax (the plain path).

    q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd). ``kv_len`` masks a partially-filled
    cache. Returns (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", *_promote(qg, k)).to(f32) * scale
    if causal:
        m = _causal_mask(sq, sk, q_offset, q.device)
        s = torch.where(m[None, None, None], s, -1e30)
    if kv_len is not None:
        valid = torch.arange(sk, device=q.device)[None, :] \
            < torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
        s = torch.where(valid[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", *_promote(p, v))
    return o.reshape(b, sq, h, hd)


def chunked_mha(q, k, v, *, causal: bool, chunk: int = 512, q_offset=0):
    """Streaming-softmax attention over query chunks, never materialising
    the full (Sq,Sk) score matrix (the plain path for long prefills).
    ``q_offset`` supports prefill-into-cache (queries live at positions
    q_offset..q_offset+Sq within the K/V sequence)."""
    b, sq, h, hd = q.shape
    if sq <= chunk:
        return mha(q, k, v, causal=causal, q_offset=q_offset)
    if sq % chunk:
        raise ValueError(f"Sq = {sq} is not a multiple of chunk = {chunk}")
    return torch.cat([mha(q[:, i:i + chunk], k, v, causal=causal,
                          q_offset=i + q_offset)
                      for i in range(0, sq, chunk)], dim=1)


def _write(buf, new, pos: int):
    """Write ``new`` into ``buf`` at sequence position ``pos``, in place
    (JAX's ``dynamic_update_slice``, which returns a new array)."""
    s = new.shape[1]
    if not 0 <= pos <= buf.shape[1] - s:
        raise ValueError(f"cache write of {s} positions at {pos} overruns "
                         f"max_seq = {buf.shape[1]}")
    buf[:, pos:pos + s] = new.to(buf.dtype)
    return buf


def attention_block(x, w, cfg, *, positions, causal=True, cache=None,
                    cache_pos=None, attn_impl: str = "auto"):
    """Full attention block: norm -> qkv -> rope -> attn -> out-proj.

    ``cache``: optional dict(k=(B,S,KV,hd), v=...); the new k/v are written
    into it IN PLACE at ``cache_pos``, and the same dict is returned as the
    new cache. Returns (out, new_cache).

    With a cache, on CUDA tensors and ``attn_impl="auto"``: a prompt or a
    chunk of one (s > 1) goes to the flash kernel with ``q_offset =
    cache_pos``, causal over the whole cache, whose unfilled tail the
    causal mask hides; one token (s == 1) goes to the fused decode kernel
    with ``kv_len = cache_pos + 1``, one int for every row. Without a cache
    it goes to the flash kernel with ``causal``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = norm_apply(cfg.norm, x, w["norm"], w.get("norm_bias"))
    q = _mm(xn, w["wq"]).reshape(b, s, h, hd)
    kx = _mm(xn, w["wk"]).reshape(b, s, kv, hd)
    vx = _mm(xn, w["wv"]).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    kx = apply_rope(kx, positions, cfg.rope_theta)

    plain = attn_impl != "auto" or x.device.type == "cpu"
    new_cache = None
    if cache is not None:
        if "k_scale" in cache:
            raise NotImplementedError(
                "the int8 KV cache is not ported yet (ROADMAP.md, items "
                "16-17: int8 KV cache)")
        pos = int(cache_pos)
        ck = _write(cache["k"], kx, pos)
        cv = _write(cache["v"], vx, pos)
        new_cache = {"k": ck, "v": cv}
        # Causal mask with the query offset also masks the unfilled cache
        # tail (slots > cache_pos + s are in the future of every query).
        if plain:
            if s >= 4096:   # long prefill: stream query chunks
                o = chunked_mha(q, ck, cv, causal=True, q_offset=pos)
            else:
                o = mha(q, ck, cv, causal=True, q_offset=pos)
        elif s == 1:
            o = decode_attention(q[:, 0], ck, cv, pos + 1)[:, None]
        else:
            o = flash_attention(q, ck, cv, causal=True, q_offset=pos)
    elif plain:
        if s >= 8192:   # long sequence: stream query chunks
            o = chunked_mha(q, kx, vx, causal=causal)
        else:
            o = mha(q, kx, vx, causal=causal)
    else:
        o = flash_attention(q, kx, vx, causal=causal)
    out = _mm(o.reshape(b, s, h * hd), w["wo"])
    return out, new_cache


# ------------------------------------------------------------------ mlp ----

def swiglu(x, w):
    hidden = F.silu(_mm(x, w["w_gate"])) * _mm(x, w["w_up"])
    return _mm(hidden, w["w_down"])


# ------------------------------------------------------------ init utils ---

def trunc_init(gen: torch.Generator | None, shape, dtype, *,
               device) -> torch.Tensor:
    """Truncated normal in [-2, 2] times 1/sqrt(fan_in), drawn in float32
    from ``gen`` and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=f32, device=device)
    if t.device.type == "meta":
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def init_tree(gen: torch.Generator | None, shapes, *, device):
    """Params for a nested dict of ``(shape, dtype)`` leaves: 1-D leaves are
    zeros, the rest ``trunc_init`` (as the JAX package's ``init_tree``;
    the draws differ, since the generators do)."""
    if isinstance(shapes, dict):
        return {k: init_tree(gen, v, device=device) for k, v in shapes.items()}
    shape, dtype = shapes
    if len(shape) == 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    return trunc_init(gen, shape, dtype, device=device)
