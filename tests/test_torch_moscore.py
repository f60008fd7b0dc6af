"""The port's routing-window backends against the JAX package's fp32
backends: choices and final queues must be EQUAL (no tolerance). Fleets
are the JAX package's, carried across; groups and queues come from
numpy. The CUDA kernels are held against their plain versions on the
card in ``test_torch_cuda.py``."""

import jax
import numpy as np
import pytest
import torch
from _torch_helpers import carry, np_

from repro.core.profiles import paper_fleet as jax_paper_fleet
from repro.core.profiles import synthetic_fleet as jax_synthetic_fleet
from repro.kernels.moscore import moscore_route as jax_moscore_route
from repro.kernels.moscore import resolve_backend as jax_resolve_backend
from repro_torch.core.policies import mo_precompute
from repro_torch.kernels.moscore import (BACKEND_ENV, BACKENDS,
                                         default_backend, moscore_cuda,
                                         moscore_hoisted_cuda,
                                         moscore_route, ref_moscore_route,
                                         resolve_backend)

# the grid of tests/test_kernels.py::test_moscore, plus 1024 pairs and a
# gamma whose 1 - gamma rounds differently in float32 than in double
GRID = [(5, 64, 20.0, 0.5), (5, 256, 20.0, 0.0), (37, 128, 10.0, 1.0),
        (200, 64, 30.0, 0.25), (1024, 256, 20.0, 0.5),
        (200, 256, 20.0, 0.33)]


def _case(n_pairs, window, seed=2):
    jp = jax_paper_fleet() if n_pairs == 5 \
        else jax_synthetic_fleet(jax.random.PRNGKey(seed), n_pairs)
    rng = np.random.default_rng(seed)
    gs = rng.integers(0, jp.n_groups, window).astype(np.int32)
    q0 = rng.integers(0, 4, n_pairs).astype(np.float32)
    return jp, carry(jp), gs, q0


def _route(tp, gs, q0, **kw):
    p, q = moscore_route(tp.T, tp.E, tp.mAP, torch.from_numpy(gs),
                         torch.from_numpy(q0), **kw)
    assert p.dtype == torch.int32 and q.dtype == torch.float32
    return np_(p), np_(q)


@pytest.mark.parametrize("backend", ["ref", "hoisted"])
@pytest.mark.parametrize("n_pairs,window,delta,gamma", GRID)
def test_route_bitwise_vs_jax(n_pairs, window, delta, gamma, backend):
    jp, tp, gs, q0 = _case(n_pairs, window)
    got_p, got_q = _route(tp, gs, q0, delta=delta, gamma=gamma,
                          backend=backend)
    for jb in ("xla", "hoisted"):
        want_p, want_q = jax_moscore_route(jp.T, jp.E, jp.mAP, gs, q0,
                                           delta=delta, gamma=gamma,
                                           backend=jb)
        np.testing.assert_array_equal(got_p, np_(want_p), err_msg=jb)
        np.testing.assert_array_equal(got_q, np_(want_q), err_msg=jb)


@pytest.mark.parametrize("backend", ["ref", "hoisted"])
@pytest.mark.parametrize("n_pairs,degraded", [(5, False), (37, True),
                                              (200, False)])
def test_route_health_mask_bitwise_vs_jax(n_pairs, degraded, backend):
    """A window under one health mask, including the degraded fallback
    (no healthy pair clears some group's accuracy bar)."""
    jp, tp, gs, q0 = _case(n_pairs, 128, seed=5)
    h = np.random.default_rng(n_pairs).random(n_pairs) < 0.6
    if degraded:
        m = np_(jp.mAP)[:, -1]
        h[m >= m.max() - 20.0] = False
    got_p, got_q = _route(tp, gs, q0, delta=20.0, gamma=0.5,
                          backend=backend, health=torch.from_numpy(h))
    for jb in ("xla", "hoisted"):
        want_p, want_q = jax_moscore_route(jp.T, jp.E, jp.mAP, gs, q0,
                                           delta=20.0, gamma=0.5,
                                           backend=jb, health=h)
        np.testing.assert_array_equal(got_p, np_(want_p), err_msg=jb)
        np.testing.assert_array_equal(got_q, np_(want_q), err_msg=jb)
    assert h[got_p].all()


def test_resolve_backend_rules(monkeypatch):
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    assert BACKENDS == ("cuda", "ref", "hoisted", "cuda_hoisted", "auto")
    assert default_backend("cuda") == "cuda_hoisted"
    assert default_backend("cpu") == "hoisted"
    assert resolve_backend("auto", "cpu") == "hoisted"
    assert resolve_backend("auto", torch.device("cuda")) == "cuda_hoisted"
    for b in BACKENDS[:-1]:
        assert resolve_backend(b, "cpu") == b
    with pytest.raises(ValueError, match="unknown moscore backend"):
        resolve_backend("pallas", "cpu")
    monkeypatch.setenv(BACKEND_ENV, "ref")
    assert resolve_backend("auto", "cpu") == "ref"
    assert resolve_backend("hoisted", "cpu") == "hoisted"   # explicit wins
    for bad in ("auto", "int8"):
        monkeypatch.setenv(BACKEND_ENV, bad)
        with pytest.raises(ValueError, match=BACKEND_ENV):
            resolve_backend("auto", "cpu")


def test_backend_env_vars_do_not_cross(monkeypatch):
    """Each package reads its own override: a port backend name never
    reaches the JAX package, and the JAX one never reaches the port."""
    monkeypatch.setenv(BACKEND_ENV, "cuda_hoisted")
    monkeypatch.delenv("REPRO_MOSCORE_BACKEND", raising=False)
    assert jax_resolve_backend("auto") in ("hoisted", "pallas_hoisted")
    monkeypatch.delenv(BACKEND_ENV)
    monkeypatch.setenv("REPRO_MOSCORE_BACKEND", "xla")
    assert resolve_backend("auto", "cpu") == "hoisted"


@pytest.mark.parametrize("backend", ["cuda", "cuda_hoisted"])
def test_cuda_backends_raise_on_cpu_tensors(backend):
    _, tp, gs, q0 = _case(5, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _route(tp, gs, q0, backend=backend)


def test_kernel_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; the hoisted wrapper accepts the mask as bool or uint8."""
    _, tp, gs, q0 = _case(37, 64)
    gs_t, q0_t = torch.from_numpy(gs), torch.from_numpy(q0)
    n0 = (moscore_cuda.launches, moscore_hoisted_cuda.launches)
    want = ref_moscore_route(tp.T, tp.E, tp.mAP, gs_t, q0_t, delta=10.0,
                             gamma=0.3)
    got = moscore_cuda(tp.T.t().contiguous(), tp.E.t().contiguous(),
                       tp.mAP.t().contiguous(), gs_t, q0_t, delta=10.0,
                       gamma=0.3)
    feas, En = mo_precompute(tp.T, tp.E, tp.mAP, delta=10.0)
    for Ft in (feas.t().contiguous(), feas.t().contiguous().to(torch.uint8)):
        got_h = moscore_hoisted_cuda(tp.T.t().contiguous(),
                                     En.t().contiguous(), Ft, gs_t, q0_t,
                                     gamma=0.3)
        for a, b in zip(got_h, want):
            assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (moscore_cuda.launches, moscore_hoisted_cuda.launches) == n0


def test_hoisted_layout():
    """The hoisted kernel's layout: one warp up to 32 pairs, then 1 and 2
    pairs per thread up to twelve warps each, 4 up to sixteen, then 16 per
    thread up to 24 warps; every layout covers P, no warp is idle, and
    none has more warps than the kernel is built for at its K."""
    from repro_torch.kernels.moscore.moscore import (
        HOISTED_MAX_WARPS, HOISTED_PAIRS_PER_THREAD, MAX_PAIRS,
        hoisted_layout)

    assert hoisted_layout(5) == (1, 1)          # the paper fleet: one warp
    assert hoisted_layout(32) == (1, 1)
    assert hoisted_layout(33) == (1, 2)
    assert hoisted_layout(256) == (1, 8)
    assert hoisted_layout(257) == (1, 9)
    assert hoisted_layout(384) == (1, 12)
    assert hoisted_layout(385) == (2, 7)
    assert hoisted_layout(768) == (2, 12)
    assert hoisted_layout(769) == (4, 7)
    assert hoisted_layout(1024) == (4, 8)
    assert hoisted_layout(2048) == (4, 16)
    assert hoisted_layout(2049) == (16, 5)
    assert hoisted_layout(MAX_PAIRS) == (16, 24)
    for P in (1, 7, 31, 32, 33, 100, 255, 256, 257, 384, 385, 768, 769,
              1000, 1024, 2048, 2049, 4096, 5000, MAX_PAIRS):
        for k in (None, *HOISTED_PAIRS_PER_THREAD):
            try:
                kk, warps = hoisted_layout(P, k)
            except ValueError:
                assert k is not None
                assert -(-P // (32 * k)) > HOISTED_MAX_WARPS[k]
                continue
            assert kk in HOISTED_PAIRS_PER_THREAD and (k is None or kk == k)
            assert 32 * warps * kk >= P > 32 * (warps - 1) * kk
            assert warps <= HOISTED_MAX_WARPS[kk]
    for bad in ((0, None), (100, 3), (100, 8), (12289, 16)):
        with pytest.raises(ValueError):
            hoisted_layout(*bad)
