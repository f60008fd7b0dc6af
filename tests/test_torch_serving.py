"""The port's serving plane against the JAX package's: the same scenario
gives EQUAL record arrays (routing, estimator, latency, energy, mAP), the
gateway routes any window partition of one stream identically, and the
entry points run on the card unless asked for the CPU."""

import jax
import numpy as np
import pytest
import torch
from _torch_helpers import carry, np_

from repro.core.profiles import paper_fleet as jax_paper_fleet
from repro.core.profiles import synthetic_fleet as jax_synthetic_fleet
from repro.core.scenario import Scenario as JaxScenario
from repro.serving import AsyncExecutorPool as JaxPool
from repro.serving import ServingPlane as JaxServingPlane
from repro.serving import WindowedGateway as JaxGateway
from repro_torch.core import Scenario, paper_fleet
from repro_torch.serving import (AsyncExecutorPool, ServingPlane,
                                 WindowedGateway)

RECORDS = ("pair", "g_est", "g_true", "latency", "energy", "map")


def _fleets(n_pairs):
    jp = jax_paper_fleet() if n_pairs == 5 \
        else jax_synthetic_fleet(jax.random.PRNGKey(0), n_pairs)
    return jp, carry(jp)


@pytest.mark.parametrize("n_pairs,n_users,window", [(5, 15, 64),
                                                    (200, 1024, 256)])
def test_serving_plane_records_equal_jax(n_pairs, n_users, window):
    jp, tp = _fleets(n_pairs)
    profile = "paper" if n_pairs == 5 else tp
    jax_profile = "paper" if n_pairs == 5 else jp
    want = JaxServingPlane.build(
        JaxScenario(profile=jax_profile, n_users=n_users), window=window,
        backend="hoisted").run(2048)
    plane = ServingPlane.build(Scenario(profile=profile, n_users=n_users),
                               window=window, device="cpu")
    got = plane.run(2048)
    for k in RECORDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["router_window_s"].shape == (2048 // window,)
    assert ServingPlane.summarize(got) == JaxServingPlane.summarize(want)


def test_serving_plane_continues_across_runs():
    """A second run continues the first (clock, scenes, queues and
    estimator state persist), as the JAX plane does."""
    want = JaxServingPlane.build(JaxScenario(n_users=15), window=32,
                                 backend="hoisted")
    plane = ServingPlane.build(Scenario(n_users=15), window=32,
                               device="cpu")
    for n in (256, 320):
        w, g = want.run(n), plane.run(n)
        for k in RECORDS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _route_stream(gw, streams, window, q):
    out = []
    for i in range(0, len(streams), window):
        pairs, gs, q = gw.route_window(streams[i:i + window], q)
        out.append(np.stack([np_(pairs), np_(gs)]))
    return np.concatenate(out, axis=1), np_(q)


@pytest.mark.parametrize("n_pairs", [5, 200])
def test_window_partition_invariance(n_pairs):
    """Windows of 1 and of 64 over one request stream, threading q_after,
    route identically, and match the JAX gateway's routing."""
    jp, tp = _fleets(n_pairs)
    rng = np.random.default_rng(n_pairs)
    streams = rng.integers(0, 300, 512)
    seen = rng.integers(0, 300, 200)
    counts = rng.integers(0, 7, 200)
    q0 = rng.integers(0, 5, n_pairs).astype(np.float32)
    got = {}
    for window in (1, 64):
        gw = WindowedGateway(tp, device="cpu")
        gw.observe_detections_window(seen, counts)
        got[window] = _route_stream(gw, streams, window, q0)
    jgw = JaxGateway(jp, backend="hoisted")
    jgw.observe_detections_window(seen, counts)
    want = _route_stream(jgw, streams, 64, q0)
    for window in (1, 64):
        np.testing.assert_array_equal(got[window][0], want[0])
        np.testing.assert_array_equal(got[window][1], want[1])


def test_observe_detections_last_write_wins():
    gw = WindowedGateway(paper_fleet(), device="cpu")
    jgw = JaxGateway(jax_paper_fleet())
    for ids, cnts in (([3, 7, 3, 3, 7], [1, 2, 4, 2, 9]),
                      ([7, 1000], [0, 6])):
        gw.observe_detections_window(ids, cnts)
        jgw.observe_detections_window(ids, cnts)
    gw.observe_detections_window([], [])           # an empty poll: no-op
    counts = np_(gw._counts)
    assert counts.dtype == np.int32 and counts[3] == 2 and counts[7] == 0
    np.testing.assert_array_equal(counts, np_(jgw._counts))
    with pytest.raises(ValueError, match="stream id out of range"):
        gw.observe_detections_window([gw.n_streams], [1])
    with pytest.raises(ValueError, match="stream id out of range"):
        gw.route_window([-1], np.zeros(5, np.float32))


def test_executor_pool_matches_jax():
    """Submissions and polls give the JAX pool's records, and the
    accounting invariant holds throughout."""
    tp, jp = paper_fleet(), jax_paper_fleet()
    pool, jpool = AsyncExecutorPool(tp), JaxPool(jp)
    rng = np.random.default_rng(0)
    now = 0.0
    for step in range(30):
        pairs = rng.integers(0, 5, 16)
        groups = rng.integers(0, 5, 16)
        for p in (pool, jpool):
            if step == 10:
                p.apply_drift(1.5, 0.5)
            p.submit_window(pairs, groups, now, stream_ids=pairs)
        now += 0.05
        got, want = pool.poll(now), jpool.poll(now)
        for f in ("rids", "pairs", "groups", "finish_s", "energy_mwh",
                  "map_proxy"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(pool.depths(), jpool.depths())
        assert pool.depths().min() >= 0
        assert pool.submitted == pool.polled + pool.in_flight


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent CPU path: without a card the entry points raise and say
    how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingPlane.build(Scenario())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        WindowedGateway(paper_fleet())
    gw = WindowedGateway(Scenario(n_users=5000), device="cpu")
    assert gw.backend == "hoisted" and gw.n_streams == 5000


@pytest.mark.parametrize("knob", [dict(policy="LT"), dict(online=True),
                                  dict(cloud=object()),
                                  dict(faults=object()),
                                  dict(pods=[0, 0, 1, 1, 1])])
def test_unported_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="not ported"):
        WindowedGateway(paper_fleet(), device="cpu", **knob)


def test_cuda_backend_on_cpu_gateway_raises():
    gw = WindowedGateway(paper_fleet(), device="cpu", backend="cuda_hoisted")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gw.route_window([0, 1], np.zeros(5, np.float32))
