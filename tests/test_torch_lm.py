"""The port's dense LM serving path against the JAX package, on the CPU:
the layers, ``attention_block`` with and without a cache, and ``prefill``
followed by greedy ``decode_step``s on parameters carried across with
``params_from_numpy``. On CPU tensors attention takes the plain path,
which mirrors JAX's ``mha``/``chunked_mha`` (no kernel is launched).

Tolerances, with their reasons:

* float32 models: 5e-5 relative to the largest logit; the layers: 1e-5
  (1e-4 for the decode step of ``attention_block``, which reads a
  bfloat16 cache). XLA and torch sum the matmuls and reductions in
  different orders, and the errors grow through the layers: the largest
  seen here is 7.5e-6, so 5e-5 leaves a margin and is tighter than the
  1e-4 the comparison started from. The caches are bfloat16 in both
  packages (as ``init_cache`` makes them), so a rounding difference
  before the cast can flip one bfloat16 ulp: they are compared at 4e-3
  relative to the largest entry (2^-8, one ulp of it).
* bfloat16 models: 2e-2, ``tests/test_kernels.py::_tol``'s bfloat16
  tolerance: each side rounds its matmul outputs to bfloat16 itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.configs import LMConfig as JaxLMConfig
from repro.configs import get as jax_get
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.common.configs import LMConfig
from repro_torch.configs import NOT_PORTED, get, stablelm_3b
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

GQA = LMConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               d_ff=128, vocab_size=128, dtype="float32")
MODELS = {
    "stablelm-3b-reduced": stablelm_3b.REDUCED,
    "gqa": GQA,
    "stablelm-3b-reduced-bf16": dataclasses.replace(stablelm_3b.REDUCED,
                                                    dtype="bfloat16"),
}


def _jax_cfg(cfg: LMConfig) -> JaxLMConfig:
    return JaxLMConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(rng, shape, dtype=np.float32):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _carry(cfg, seed):
    """JAX params from a key, and the same values as the port's params."""
    jp = JT.init_params(_jax_cfg(cfg), jax.random.PRNGKey(seed))
    tp = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ["stablelm-3b", "stablelm-12b"])
def test_configs_equal_jax(arch):
    a, ja = get(arch), jax_get(arch)
    for cfg, jcfg in ((a.config, ja.config), (a.reduced, ja.reduced)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.hd, cfg.d_exp, cfg.n_params(), cfg.n_active_params()) \
            == (jcfg.hd, jcfg.d_exp, jcfg.n_params(), jcfg.n_active_params())
    assert dataclasses.asdict(a.train) == dataclasses.asdict(ja.train)
    assert [dataclasses.asdict(s) for s in a.shapes] \
        == [dataclasses.asdict(s) for s in ja.shapes]


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_archs_raise(arch):
    jax_get(arch)                       # known to the JAX registry
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get(arch)


@pytest.mark.parametrize("arch", ["stablelm-3b", "stablelm-12b"])
def test_full_width_param_count_on_meta(arch):
    """The full-width tree, built on the meta device, has JAX's shapes.
    ``LMConfig.n_params()`` leaves out the LayerNorm biases that both
    trees hold (2 x n_layers x d_model), in the JAX package too."""
    cfg = get(arch).config
    params = T.init_params(cfg, device="meta")
    jshapes = JT.abstract_params(_jax_cfg(cfg))
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.device.type == "meta"
    n = T.n_params(params)
    assert n == sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    assert n == cfg.n_params() + 2 * cfg.n_layers * cfg.d_model


# ----------------------------------------------------------------- layers --

def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 64))
    sj, st = _pair(rng, (64,))
    bj, bt = _pair(rng, (64,))
    np.testing.assert_allclose(_np(L.rmsnorm(xt, st)),
                               _np(JL.rmsnorm(xj, sj)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(L.layernorm(xt, st, bt)),
                               _np(JL.layernorm(xj, sj, bj)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(L.norm_apply("layernorm", xt, st)),
                               _np(JL.norm_apply("layernorm", xj, sj)),
                               rtol=1e-5, atol=1e-5)
    hj, ht = _pair(rng, (2, 5, 4, 16))
    pos = np.arange(3, 8, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        _np(L.apply_rope(ht, torch.from_numpy(pos), 10_000.0)),
        _np(JL.apply_rope(hj, jnp.asarray(pos), 10_000.0)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(L.rope_freqs(80, 1e4),
                                  JL.rope_freqs(80, 1e4))


@pytest.mark.parametrize("case", ["causal", "offset", "kv_len", "full"])
def test_mha_matches_jax(case):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, 8, 4, 16))
    kj, kt = _pair(rng, (2, 24, 2, 16))
    vj, vt = _pair(rng, (2, 24, 2, 16))
    kw = {"causal": dict(causal=True), "offset": dict(causal=True,
                                                      q_offset=9),
          "kv_len": dict(causal=True, q_offset=3,
                         kv_len=np.array([11, 20], np.int32)),
          "full": dict(causal=False)}[case]
    jkw = dict(kw)
    if "kv_len" in kw:
        jkw["kv_len"] = jnp.asarray(kw["kv_len"])
        kw["kv_len"] = torch.from_numpy(kw["kv_len"])
    np.testing.assert_allclose(_np(L.mha(qt, kt, vt, **kw)),
                               _np(JL.mha(qj, kj, vj, **jkw)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("q_offset", [0, 16])
def test_chunked_mha_matches_jax(q_offset):
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (1, 64, 2, 16))
    kj, kt = _pair(rng, (1, 96, 2, 16))
    vj, vt = _pair(rng, (1, 96, 2, 16))
    got = L.chunked_mha(qt, kt, vt, causal=True, chunk=16, q_offset=q_offset)
    want = JL.chunked_mha(qj, kj, vj, causal=True, chunk=16,
                          q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (2, 5, 64))
    w = {k: _pair(rng, s) for k, s in (("w_gate", (64, 96)),
                                        ("w_up", (64, 96)),
                                        ("w_down", (96, 64)))}
    got = L.swiglu(xt, {k: v[1] for k, v in w.items()})
    want = JL.swiglu(xj, {k: v[0] for k, v in w.items()})
    assert _rel(got, want) < 1e-5


def _block_inputs(cfg, seed=4, s=8):
    jp, tp = _carry(cfg, seed)
    wj = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    wt = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng, (2, s, cfg.d_model))
    return wj, wt, xj, xt


@pytest.mark.parametrize("model", ["stablelm-3b-reduced", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_block_without_cache_matches_jax(model, causal):
    cfg = MODELS[model]
    wj, wt, xj, xt = _block_inputs(cfg)
    pos = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    oj, cj = JL.attention_block(xj, wj, _jax_cfg(cfg),
                                positions=jnp.asarray(pos), causal=causal)
    n0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    ot, ct = L.attention_block(xt, wt, cfg, positions=torch.from_numpy(pos),
                               causal=causal)
    assert cj is None and ct is None
    assert _rel(ot, oj) < 1e-5
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == n0     # CPU: plain path


@pytest.mark.parametrize("model", ["stablelm-3b-reduced", "gqa"])
def test_attention_block_with_cache_matches_jax(model):
    """A prefill into an empty cache, then one token at the next position:
    the outputs, and the caches written in place."""
    cfg = MODELS[model]
    wj, wt, xj, xt = _block_inputs(cfg)
    jcfg = _jax_cfg(cfg)
    shape = (2, 16, cfg.n_kv_heads, cfg.hd)
    cj = {"k": jnp.zeros(shape, jnp.bfloat16),
          "v": jnp.zeros(shape, jnp.bfloat16)}
    ct = {"k": torch.zeros(shape, dtype=torch.bfloat16),
          "v": torch.zeros(shape, dtype=torch.bfloat16)}
    n0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    pos = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    oj, cj = JL.attention_block(xj, wj, jcfg, positions=jnp.asarray(pos),
                                cache=cj, cache_pos=0)
    ot, ct2 = L.attention_block(xt, wt, cfg, positions=torch.from_numpy(pos),
                                cache=ct, cache_pos=0)
    assert ct2["k"] is ct["k"] and ct2["v"] is ct["v"]      # in place
    assert _rel(ot, oj) < 1e-5
    for f in ("k", "v"):
        assert _rel(ct[f], cj[f]) < 4e-3
    x1j, x1t = xj[:, :1], xt[:, :1]
    p1 = np.full((2, 1), 8, np.int32)
    oj, cj = JL.attention_block(x1j, wj, jcfg, positions=jnp.asarray(p1),
                                cache=cj, cache_pos=8)
    ot, ct = L.attention_block(x1t, wt, cfg, positions=torch.from_numpy(p1),
                               cache=ct, cache_pos=8)
    assert _rel(ot, oj) < 1e-4
    for f in ("k", "v"):
        assert _rel(ct[f], cj[f]) < 4e-3
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == n0     # CPU: plain path


@pytest.mark.parametrize("model", ["stablelm-3b-reduced", "gqa"])
def test_attention_block_chunk_at_cache_pos_matches_jax(model):
    """A multi-token chunk written at ``cache_pos > 0`` (after an 8-token
    prompt), as a chunked prefill makes it: the output (the causal mask at
    query offset ``cache_pos``) and the caches written in place, against
    JAX's ``attention_block`` at the same position."""
    cfg = MODELS[model]
    wj, wt, xj, xt = _block_inputs(cfg)
    jcfg = _jax_cfg(cfg)
    shape = (2, 24, cfg.n_kv_heads, cfg.hd)
    cj = {"k": jnp.zeros(shape, jnp.bfloat16),
          "v": jnp.zeros(shape, jnp.bfloat16)}
    ct = {"k": torch.zeros(shape, dtype=torch.bfloat16),
          "v": torch.zeros(shape, dtype=torch.bfloat16)}
    n0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    pos = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    _, cj = JL.attention_block(xj, wj, jcfg, positions=jnp.asarray(pos),
                               cache=cj, cache_pos=0)
    L.attention_block(xt, wt, cfg, positions=torch.from_numpy(pos),
                      cache=ct, cache_pos=0)
    x2j, x2t = _pair(np.random.default_rng(9), (2, 5, cfg.d_model))
    p2 = np.arange(8, 13, dtype=np.int32)[None].repeat(2, 0)
    oj, cj = JL.attention_block(x2j, wj, jcfg, positions=jnp.asarray(p2),
                                cache=cj, cache_pos=8)
    ot, ct = L.attention_block(x2t, wt, cfg, positions=torch.from_numpy(p2),
                               cache=ct, cache_pos=8)
    assert ot.shape == (2, 5, cfg.d_model)
    assert _rel(ot, oj) < 1e-4          # reads the bfloat16 cache
    for f in ("k", "v"):
        assert _rel(ct[f], cj[f]) < 4e-3
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == n0     # CPU: plain path


def test_attention_block_rejects_what_it_does_not_take():
    cfg = MODELS["gqa"]
    _, wt, _, xt = _block_inputs(cfg)
    pos = torch.arange(8)[None].expand(2, 8)
    shape = (2, 16, cfg.n_kv_heads, cfg.hd)
    with pytest.raises(ValueError, match="attn_impl"):
        L.attention_block(xt, wt, cfg, positions=pos, attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="int8"):
        L.attention_block(xt, wt, cfg, positions=pos, cache_pos=0, cache={
            "k": torch.zeros(shape, dtype=torch.int8),
            "v": torch.zeros(shape, dtype=torch.int8),
            "k_scale": torch.zeros(shape[:-1] + (1,)),
            "v_scale": torch.zeros(shape[:-1] + (1,))})
    with pytest.raises(ValueError, match="overruns"):
        L.attention_block(xt, wt, cfg, positions=pos, cache_pos=12, cache={
            "k": torch.zeros(shape, dtype=torch.bfloat16),
            "v": torch.zeros(shape, dtype=torch.bfloat16)})
    with pytest.raises(NotImplementedError, match="int8"):
        T.init_cache(dataclasses.replace(cfg, kv_cache_dtype="int8"), 2, 16,
                     device="cpu")


# ------------------------------------------------------- prefill / decode --

@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_then_greedy_decode_matches_jax(model):
    """``prefill`` of a 16-token prompt into a 32-slot cache, then three
    greedy ``decode_step``s fed JAX's argmax (so that both sides see the
    same tokens): the logits at every step and the returned caches."""
    cfg = MODELS[model]
    tol = 2e-2 if cfg.dtype == "bfloat16" else 5e-5
    jcfg = _jax_cfg(cfg)
    jp, tp = _carry(cfg, 1)
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    cj = JT.init_cache(jcfg, 2, 32)
    ct = T.init_cache(cfg, 2, 32, device="cpu")
    assert ct["k"].dtype == torch.bfloat16 and ct["k"].shape == cj["k"].shape
    n0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    lj, cj = JT.prefill(jcfg, jp, jnp.asarray(tok, jnp.int32), cj)
    lt, ct = T.prefill(cfg, tp, torch.from_numpy(tok), ct)
    assert lt.shape == (2, cfg.vocab_size) and lt.dtype == T.parse_dtype(
        cfg.dtype)
    assert _rel(lt, lj) < tol, "prefill logits"
    for f in ("k", "v"):
        assert _rel(ct[f], cj[f]) < max(tol, 4e-3), f"prefill cache {f}"
    for step in range(3):
        nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
        pos = 16 + step
        lj, cj = JT.decode_step(jcfg, jp, jnp.asarray(nxt), cj, pos)
        lt, ct = T.decode_step(cfg, tp, torch.from_numpy(nxt).long(), ct,
                               pos)
        assert _rel(lt, lj) < tol, f"decode step {step}"
        for f in ("k", "v"):
            assert _rel(ct[f], cj[f]) < max(tol, 4e-3), \
                f"decode step {step} cache {f}"
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == n0     # CPU: plain path


@pytest.mark.parametrize("model", list(MODELS))
def test_two_chunk_prefill_matches_one_shot_and_jax(model):
    """A 16-token prompt prefilled in two chunks of 10 and 6 tokens through
    ``forward(..., cache_pos=)``: the last chunk's logits equal the one-shot
    ``prefill``'s last-token logits and JAX's two-chunk ``forward`` on the
    same numpy weights, and so do the caches."""
    cfg = MODELS[model]
    tol = 2e-2 if cfg.dtype == "bfloat16" else 5e-5
    jcfg = _jax_cfg(cfg)
    jp, tp = _carry(cfg, 1)
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    one, c1 = T.prefill(cfg, tp, torch.from_numpy(tok),
                        T.init_cache(cfg, 2, 32, device="cpu"))
    ct = T.init_cache(cfg, 2, 32, device="cpu")
    cj = JT.init_cache(jcfg, 2, 32)
    for lo, hi in ((0, 10), (10, 16)):
        lt, ct = T.forward(cfg, tp, torch.from_numpy(tok[:, lo:hi]),
                           caches=ct, cache_pos=lo)
        lj, cj = JT.forward(jcfg, jp, jnp.asarray(tok[:, lo:hi], jnp.int32),
                            caches=cj, cache_pos=lo)
        assert lt.shape == (2, hi - lo, cfg.vocab_size)
        assert _rel(lt, lj) < tol, f"chunk at {lo}"
    assert _rel(lt[:, -1], one) < tol
    for f in ("k", "v"):
        assert _rel(ct[f], cj[f]) < max(tol, 4e-3), f
        assert _rel(ct[f], c1[f]) < max(tol, 4e-3), f


def test_forward_without_cache_matches_jax():
    cfg = MODELS["stablelm-3b-reduced"]
    jp, tp = _carry(cfg, 3)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    lj, aj = JT.forward(_jax_cfg(cfg), jp, jnp.asarray(tok, jnp.int32))
    lt, at = T.forward(cfg, tp, torch.from_numpy(tok))
    assert lt.shape == (2, 12, cfg.vocab_size)
    assert _rel(lt, lj) < 5e-5
    assert float(at) == float(aj) == 0.0


def test_entry_points_need_a_device(monkeypatch):
    """Without a CUDA device the entry points raise unless given
    ``device="cpu"``; with it they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MODELS["gqa"]
    tree = jax.tree.map(np.asarray,
                        JT.init_params(_jax_cfg(cfg), jax.random.PRNGKey(0)))
    for call in (lambda **kw: T.init_params(cfg, **kw),
                 lambda **kw: T.init_cache(cfg, 2, 16, **kw),
                 lambda **kw: T.params_from_numpy(cfg, tree, **kw)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
        out = call(device="cpu")
        leaves = jax.tree.leaves(out)
        assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_init_params_follow_the_jax_init():
    """Shapes and dtypes of JAX's tree; 1-D leaves zero, the rest a
    truncated normal at 1/sqrt(fan_in); one seed, one draw."""
    cfg = MODELS["stablelm-3b-reduced-bf16"]
    gen = lambda: torch.Generator().manual_seed(5)
    p = T.init_params(cfg, gen(), device="cpu")
    jp = JT.init_params(_jax_cfg(cfg), jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        if t.ndim == 1:
            assert not t.any(), path
        else:
            std = 1.0 / np.sqrt(t.shape[-2])
            assert float(t.float().abs().max()) <= 2 * std * 1.01, path
    q = T.init_params(cfg, gen(), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p),
                                                 jax.tree.leaves(q)))
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, jp)
        bad["embed"] = bad["embed"][:-1]
        T.params_from_numpy(cfg, bad, device="cpu")
