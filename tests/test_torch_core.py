"""Parity of the port's core (profiles, estimator, Algorithm 1) with the
JAX package on identical inputs. Every comparison is exact: float32
results must match bit for bit."""

import jax
import numpy as np
import pytest
import torch
from _torch_helpers import carry, np_

from repro.core import estimator as JEST
from repro.core import policies as JPOL
from repro.core.profiles import ProfileTable as JaxProfileTable
from repro.core.profiles import paper_fleet as jax_paper_fleet
from repro.core.profiles import synthetic_fleet as jax_synthetic_fleet
from repro_torch import resolve_device
from repro_torch.core import estimator as EST
from repro_torch.core import policies as POL
from repro_torch.core.profiles import (GROUP_NAMES, ProfileTable,
                                       paper_fleet, synthetic_fleet)

STICKINESS = (0.5, 0.7, 0.85, 0.95)


def _fleet(n_pairs):
    jp = jax_paper_fleet() if n_pairs == 5 \
        else jax_synthetic_fleet(jax.random.PRNGKey(2), n_pairs)
    return jp, carry(jp)


def test_paper_fleet_equal():
    jp, tp = jax_paper_fleet(), paper_fleet()
    assert tp.names == jp.names and len(GROUP_NAMES) == tp.n_groups
    assert (tp.n_pairs, tp.n_groups, tp.is_stacked) == (5, 5, False)
    for name in ("T", "E", "mAP", "floor_mw"):
        t = getattr(tp, name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(np_(t), np_(getattr(jp, name)))


def test_profile_npz_loads_across_packages(tmp_path):
    """The .npz format is shared: a fleet saved by either package loads
    unchanged in the other."""
    jp = jax_synthetic_fleet(jax.random.PRNGKey(4), 17)
    jp.save(str(tmp_path / "jax.npz"))
    tp = ProfileTable.load(str(tmp_path / "jax.npz"))
    tp.save(str(tmp_path / "torch.npz"))
    back = JaxProfileTable.load(str(tmp_path / "torch.npz"))
    assert tp.names == jp.names == back.names
    for name in ("T", "E", "mAP", "floor_mw"):
        np.testing.assert_array_equal(np_(getattr(tp, name)),
                                      np_(getattr(jp, name)))
        np.testing.assert_array_equal(np_(getattr(back, name)),
                                      np_(getattr(jp, name)))


def test_synthetic_fleet_draws_from_generator():
    """Same distributions as the JAX fleet; the draws are the
    generator's, so one seed gives one fleet."""
    def draw(seed):
        return synthetic_fleet(torch.Generator().manual_seed(seed), 64)

    a, b, c = draw(3), draw(3), draw(4)
    assert (a.n_pairs, a.n_groups) == (64, 5)
    for name in ("T", "E", "mAP", "floor_mw"):
        assert getattr(a, name).dtype == torch.float32
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.T, c.T)
    assert float(a.mAP.min()) >= 1.0 and float(a.mAP.max()) <= 99.0
    strong = a.floor_mw == 500.0
    assert torch.all(a.T[strong, 0] >= 120.0 * 0.7 - 1e-3)
    assert torch.all(a.T[~strong, 0] <= 40.0 * 1.4 + 1e-3)


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        paper_fleet().to()
    assert resolve_device("cpu") == torch.device("cpu")
    assert paper_fleet().to("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("stickiness", STICKINESS)
def test_markov_transition_bitwise(stickiness):
    want = np_(JEST.markov_transition(5, stickiness))
    got = EST.markov_transition(5, stickiness, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np_(got), want)


@pytest.mark.parametrize("stickiness", STICKINESS)
def test_stationary_bitwise(stickiness):
    P = np_(JEST.markov_transition(5, stickiness))
    want = np_(JEST.stationary(P))
    got = EST.stationary(torch.tensor(P))
    np.testing.assert_array_equal(np_(got), want)


@pytest.mark.parametrize("a,b,c,exact,two_roundings", [
    # the float32 product rounds the answer away
    (1 + 2 ** -12, 1 + 2 ** -12, -1 - 2 ** -11, 2 ** -24, 0.0),
    # a*b + c = 2^28 + 16 + 2^-32: a float64 sum rounds to the float32
    # midpoint 2^28 + 16, which then ties to even
    (1 + 2 ** -12, 16 * (1 - 2 ** -12 + 2 ** -24), 2 ** 28, 2 ** 28 + 32,
     2 ** 28)])
def test_fma_emulation_rounds_once(a, b, c, exact, two_roundings):
    """The stationary matvec's fused multiply-add rounds a*b + c once."""
    a, b, c = (torch.tensor([x], dtype=torch.float32) for x in (a, b, c))
    assert float(EST._fma_f32(a, b, c)) == exact
    if c < 2 ** 20:
        assert float(a * b + c) == two_roundings
    else:
        assert float((a.double() * b.double() + c.double()).float()) \
            == two_roundings


@pytest.mark.parametrize("n_groups", [3, 5])
def test_group_of_count(n_groups):
    counts = np.arange(-3, 12, dtype=np.int32)
    want = np_(JEST.group_of_count(counts, n_groups))
    got = EST.group_of_count(torch.from_numpy(counts), n_groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), want)


def _health(n_pairs, kind, mAP, delta):
    """None, a random mask, or one that downs every pair clearing the
    last group's accuracy bar (its degraded fallback)."""
    if kind is None:
        return None
    h = np.random.default_rng(n_pairs).random(n_pairs) < 0.7
    if kind == "degraded":
        h[mAP[:, -1] >= mAP[:, -1].max() - delta] = False
    return h


@pytest.mark.parametrize("health", [None, "random", "degraded"])
@pytest.mark.parametrize("n_pairs,delta", [(5, 20.0), (37, 10.0),
                                           (200, 5.0)])
def test_mo_precompute_bitwise(n_pairs, delta, health):
    jp, tp = _fleet(n_pairs)
    h = _health(n_pairs, health, np_(jp.mAP), delta)
    jf, jE = JPOL.mo_precompute(jp.T, jp.E, jp.mAP, delta=delta, health=h)
    tf, tE = POL.mo_precompute(tp.T, tp.E, tp.mAP, delta=delta,
                               health=None if h is None
                               else torch.from_numpy(h))
    np.testing.assert_array_equal(np_(tf), np_(jf))
    np.testing.assert_array_equal(np_(tE), np_(jE))


@pytest.mark.parametrize("health", [None, "random", "degraded"])
# 0.33 and 0.67: float32(1 - gamma) != 1 - float32(gamma)
@pytest.mark.parametrize("n_pairs,delta,gamma", [(5, 20.0, 0.5),
                                                 (37, 10.0, 0.33),
                                                 (200, 5.0, 0.67)])
def test_mo_scores_bitwise(n_pairs, delta, gamma, health):
    """Per-request scores, unhoisted and hoisted, at random queues for
    every group; both agree with JAX and with each other."""
    jp, tp = _fleet(n_pairs)
    h = _health(n_pairs, health, np_(jp.mAP), delta)
    th = None if h is None else torch.from_numpy(h)
    q = np.random.default_rng(1).integers(0, 6, n_pairs).astype(np.float32)
    tf, tE = POL.mo_precompute(tp.T, tp.E, tp.mAP, delta=delta, health=th)
    for g in range(tp.n_groups):
        jJ, jfe = JPOL.mo_scores(jp.T[:, g], jp.E[:, g], jp.mAP[:, g], q,
                                 delta=delta, gamma=gamma, health=h)
        tJ, tfe = POL.mo_scores(tp.T[:, g], tp.E[:, g], tp.mAP[:, g],
                                torch.from_numpy(q), delta=delta,
                                gamma=gamma, health=th)
        np.testing.assert_array_equal(np_(tJ), np_(jJ))
        np.testing.assert_array_equal(np_(tfe), np_(jfe))
        tJh = POL.mo_scores_hoisted(tp.T[:, g], tE[:, g], tf[:, g],
                                    torch.from_numpy(q), gamma=gamma)
        np.testing.assert_array_equal(np_(tJh), np_(jJ))
        p, _, _ = POL.mo_select(tp, g, torch.from_numpy(q), delta=delta,
                                gamma=gamma, health=th)
        assert int(p) == int(np.argmin(np_(jJ)))
