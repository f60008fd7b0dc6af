"""The port's attention kernels' plain versions against the JAX package, on
the CPU: flash attention against ``ref_attention`` and ``mha`` (the Pallas
flash kernel does not run on the installed jax), split-K decode attention
against the Pallas wrapper itself in interpret mode, both its partials and
its combined output.

Inputs are drawn with numpy from a seed in float32; bfloat16 inputs are
those arrays cast on each side (both round to nearest even, so both sides
hold the same values). Tolerances are ``tests/test_kernels.py::_tol``:
1e-5 in float32 (the two sides sum in different orders) and 2e-2 in
bfloat16 (JAX's ``mha`` rounds the probabilities to bfloat16 before P.V;
the oracles do not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention.decode_attention import (
    decode_attention_splits as jax_splits)
from repro.kernels.decode_attention.ops import _pick_splits as jax_pick
from repro.kernels.flash_attention import ref_attention as jax_ref_attention
from repro.models.layers import mha as jax_mha
from repro_torch.kernels.decode_attention import (_pick_splits,
                                                  card_splits,
                                                  decode_attention,
                                                  decode_attention_cuda,
                                                  decode_attention_fused,
                                                  decode_attention_splits,
                                                  ref_decode_attention,
                                                  ref_decode_fused,
                                                  ref_decode_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd,
                                                 flash_attention_cuda,
                                                 ref_attention)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _pair(rng, shape, name):
    """One float32 normal array on both sides, in dtype ``name``."""
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (b, sq, sk, h, kv, d, causal): the four shapes of tests/test_kernels.py
# (causal where sq == sk, as there), a causal case with Sk > Sq (a prompt
# against a longer cache), and head dim 80 (stablelm), ragged included
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 2, 64, True),
    (1, 512, 512, 2, 1, 128, True),
    (2, 128, 512, 2, 2, 64, False),
    (1, 128, 256, 4, 2, 64, True),
    (2, 64, 64, 4, 4, 80, True),
    (1, 100, 130, 2, 1, 80, True),
    (1, 100, 130, 4, 2, 80, False),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES)
def test_flash_plain_versions_match_jax(b, sq, sk, h, kv, d, causal, dtype):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (b, sq, h, d), dtype)
    kj, kt = _pair(rng, (b, sk, kv, d), dtype)
    vj, vt = _pair(rng, (b, sk, kv, d), dtype)
    want = _np(jax_ref_attention(qj, kj, vj, causal=causal))
    scale = 1.0 / d ** 0.5
    n0 = flash_attention_cuda.launches
    got = {
        "ref_attention": ref_attention(qt, kt, vt, causal=causal),
        "flash_attention": flash_attention(qt, kt, vt, causal=causal),
        "flash_attention_cuda": flash_attention_cuda(
            qt, kt, vt, causal=causal, scale=scale),
    }
    if kv == h:         # the (BH, S, D) layout of flash_attention_bhsd
        fold = lambda x: x.transpose(1, 2).reshape(b * h, -1, d)
        o = flash_attention_bhsd(fold(qt), fold(kt), fold(vt), causal=causal,
                                 scale=scale)
        got["flash_attention_bhsd"] = o.reshape(b, h, sq, d).transpose(1, 2)
    for name, o in got.items():
        assert o.dtype == qt.dtype and o.shape == qt.shape, name
        np.testing.assert_allclose(_np(o), want, err_msg=name, **_tol(dtype))
    if sq == sk or not causal:
        # JAX's serving attention agrees (top-left mask at q_offset = 0)
        np.testing.assert_allclose(
            _np(flash_attention(qt, kt, vt, causal=causal)),
            _np(jax_mha(qj, kj, vj, causal=causal)), **_tol(dtype))
    assert flash_attention_cuda.launches == n0     # CPU: no launch


# (b, sq, sk, h, kv, d): causal prompt chunks against a longer cache, as a
# chunked prefill makes them (Sq + q_offset <= Sk), GQA among them
OFFSET_CASES = [(1, 16, 64, 2, 2, 64), (2, 24, 48, 4, 2, 80),
                (1, 40, 56, 4, 1, 16)]


@pytest.mark.parametrize("q_offset", [0, 5, 16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d", OFFSET_CASES)
def test_flash_with_query_offset_matches_jax_mha(b, sq, sk, h, kv, d,
                                                  q_offset):
    """Query row i at key position i + q_offset: ``ref_attention``,
    ``flash_attention`` and ``flash_attention_cuda`` on CPU tensors against
    JAX ``mha(..., q_offset=)``, causal, in float32 at 1e-5."""
    rng = np.random.default_rng(q_offset + d)
    qj, qt = _pair(rng, (b, sq, h, d), "float32")
    kj, kt = _pair(rng, (b, sk, kv, d), "float32")
    vj, vt = _pair(rng, (b, sk, kv, d), "float32")
    want = _np(jax_mha(qj, kj, vj, causal=True, q_offset=q_offset))
    n0 = flash_attention_cuda.launches
    scale = 1.0 / d ** 0.5
    got = {
        "ref_attention": ref_attention(qt, kt, vt, causal=True,
                                       q_offset=q_offset),
        "flash_attention": flash_attention(qt, kt, vt, causal=True,
                                           q_offset=q_offset),
        "flash_attention_cuda": flash_attention_cuda(
            qt, kt, vt, causal=True, scale=scale, q_offset=q_offset),
    }
    for name, o in got.items():
        assert o.dtype == qt.dtype and o.shape == qt.shape, name
        np.testing.assert_allclose(_np(o), want, err_msg=name,
                                   **_tol("float32"))
    assert flash_attention_cuda.launches == n0     # CPU: no launch
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_cuda(qt, kt, vt, causal=True, scale=scale,
                             q_offset=-1)


# (b, s, h, kv, d, kv_len, n_splits): the four cases of
# tests/test_kernels.py (kv_len = 17 of 2048 in 4 splits leaves three
# splits wholly masked), one split at head dim 80, the split count picked
# by _pick_splits at d = 80, and a different kv_len per row
DECODE_CASES = [
    (1, 512, 4, 4, 64, None, 4),
    (2, 1024, 8, 2, 128, None, 4),
    (2, 512, 4, 2, 64, 300, 4),
    (1, 2048, 2, 1, 128, 17, 4),
    (2, 256, 4, 4, 80, 200, 1),
    (1, 640, 2, 2, 80, 513, 0),
    (3, 256, 4, 1, 64, (5, 256, 100), 4),
]


def _decode_inputs(b, s, h, kv, d, kv_len, dtype):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (b, h, d), dtype)
    kj, kt = _pair(rng, (b, s, kv, d), dtype)
    vj, vt = _pair(rng, (b, s, kv, d), dtype)
    if kv_len is None:
        return (qj, kj, vj, None), (qt, kt, vt, None)
    lens = np.broadcast_to(np.asarray(kv_len, np.int32), (b,)).copy()
    return (qj, kj, vj, jnp.asarray(lens)), (qt, kt, vt,
                                             torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kv,d,kv_len,n_splits", DECODE_CASES)
def test_decode_matches_jax_pallas_wrapper(b, s, h, kv, d, kv_len, n_splits,
                                           dtype):
    (qj, kj, vj, lj), (qt, kt, vt, lt) = _decode_inputs(b, s, h, kv, d,
                                                        kv_len, dtype)
    want = _np(jax_decode(qj, kj, vj, lj, n_splits=n_splits, interpret=True))
    got = decode_attention(qt, kt, vt, lt, n_splits=n_splits)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))
    np.testing.assert_allclose(_np(ref_decode_attention(qt, kt, vt, lt)),
                               want, **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kv,d,kv_len,n_splits", DECODE_CASES)
def test_decode_partials_match_jax_kernel(b, s, h, kv, d, kv_len, n_splits,
                                          dtype):
    """The split-K partials and per-split LSE, as ``_dec_kernel`` writes
    them, masked splits (LSE = -1e30, zero partial) included."""
    (qj, kj, vj, _), (qt, kt, vt, lt) = _decode_inputs(b, s, h, kv, d,
                                                       kv_len, dtype)
    ns = n_splits or jax_pick(s, d)
    g = h // kv
    lens = np.full((b,), s, np.int32) if lt is None else lt.numpy()
    lens_bkv = np.repeat(lens, kv)[:, None]
    qf = qj.reshape(b * kv, g, d)
    kf = kj.transpose(0, 2, 1, 3).reshape(b * kv, s, d)
    vf = vj.transpose(0, 2, 1, 3).reshape(b * kv, s, d)
    o_w, lse_w = jax_splits(qf, kf, vf, jnp.asarray(lens_bkv), n_splits=ns,
                            interpret=True)
    n0 = decode_attention_cuda.launches
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(b * kv, s, d)
    outs = {
        "decode_attention_splits": decode_attention_splits(
            qt.reshape(b * kv, g, d), fold(kt), fold(vt),
            torch.from_numpy(lens_bkv), n_splits=ns),
        "decode_attention_cuda": decode_attention_cuda(
            qt, kt, vt, torch.from_numpy(lens), n_splits=ns),
        "ref_decode_splits": ref_decode_splits(
            qt, kt, vt, torch.from_numpy(lens), n_splits=ns),
    }
    for name, (o, lse) in outs.items():
        assert o.dtype == lse.dtype == torch.float32, name
        assert o.shape == (b * kv, ns, g, d) and lse.shape == (b * kv, ns,
                                                               g, 1), name
        np.testing.assert_allclose(o.numpy(), np.asarray(o_w),
                                   err_msg=name, **_tol(dtype))
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w),
                                   err_msg=name, **_tol(dtype))
    if kv_len == 17:                     # three splits lie past kv_len
        assert (outs["decode_attention_cuda"][1][:, 1:] == -1e30).all()
        assert (outs["decode_attention_cuda"][0][:, 1:] == 0).all()
    assert decode_attention_cuda.launches == n0     # CPU: no launch


def test_pick_splits_matches_jax():
    for s in (1, 17, 128, 512, 2048, 2560, 4096, 13107, 32_768, 524_288):
        for d in (16, 64, 80, 128, 256):
            assert _pick_splits(s, d) == jax_pick(s, d), (s, d)
    assert _pick_splits(2560, 80) == 1      # the stablelm-3b serving cache


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kv,d,kv_len,n_splits", DECODE_CASES)
def test_decode_fused_plain_version_matches_jax(b, s, h, kv, d, kv_len,
                                                n_splits, dtype):
    """What the fused kernel computes (its plain version on CPU tensors,
    ``ref_decode_fused``) is the Pallas wrapper's combined output, for a
    (B,) kv_len and for one int kv_len; ``decode_attention`` takes an int
    kv_len on the CPU too."""
    (qj, kj, vj, lj), (qt, kt, vt, lt) = _decode_inputs(b, s, h, kv, d,
                                                        kv_len, dtype)
    want = _np(jax_decode(qj, kj, vj, lj, n_splits=n_splits, interpret=True))
    n0 = decode_attention_fused.launches
    lens = torch.full((b,), s, dtype=torch.int32) if lt is None else lt
    got = decode_attention_fused(qt, kt, vt, lens, n_splits=n_splits or 1)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))
    np.testing.assert_allclose(_np(ref_decode_fused(qt, kt, vt, lens)),
                               want, **_tol(dtype))
    if kv_len is None or isinstance(kv_len, int):
        one = s if kv_len is None else kv_len
        np.testing.assert_allclose(_np(ref_decode_fused(qt, kt, vt, one)),
                                   want, **_tol(dtype))
        np.testing.assert_allclose(
            _np(decode_attention(qt, kt, vt, one, n_splits=n_splits)),
            want, **_tol(dtype))
    assert decode_attention_fused.launches == n0     # CPU: no launch


def test_card_splits():
    """The fused kernel's split count: as many as keep the (batch x KV
    head) rows within one 8-warp CTA per SM, at most one cluster of 8, at
    least 256 positions a split."""
    assert card_splits(128, 2560, 132) == 1      # stablelm-3b decode, H100
    assert card_splits(32, 2560, 132) == 4
    assert card_splits(4, 32_768, 132) == 8      # capped at one cluster
    assert card_splits(4, 600, 132) == 2         # >= 256 positions a split
    assert card_splits(4, 100, 132) == 1
    assert card_splits(132, 4096, 132) == 1
    assert card_splits(1000, 4096, 132) == 1
    assert card_splits(0, 4096, 132) == 8
    for bkv in range(1, 300):
        ns = card_splits(bkv, 1 << 20, 132)
        assert 1 <= ns <= 8
        assert bkv * ns <= 132 or ns == 1       # one CTA per SM at most
        assert ns == 8 or bkv * (ns + 1) > 132   # and no fewer than that
