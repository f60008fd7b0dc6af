"""The windowed serving plane (port of ``repro.serving.engine
.ServingPlane``): workload -> gateway -> executor pool -> metrics.

Requests are admitted a window at a time; one ``route_window`` call routes
the whole window against the live executor queue depths, the
:class:`~repro_torch.serving.executor.AsyncExecutorPool` enqueues it
without blocking, and completions polled between windows feed the
gateway's windowed observation hooks. The workload's randomness is
numpy's ``default_rng(seed)``, as in the JAX package, so the same
scenario gives the same records in both packages. The fault plane's
retry loop comes with its slice."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import estimator as EST
from repro_torch.serving.executor import AsyncExecutorPool
from repro_torch.serving.gateway import WindowedGateway

# detection probability of one object given pair mAP
_P_DET = lambda m: np.minimum(1.0, 0.80 + 0.20 * m / 100.0)


@dataclass
class ServingPlane:
    """Windowed closed-ish loop over a modelled fleet.

    Per iteration: poll the pool for completions (feeding the gateway's
    observation hooks), admit the next window of streams, route it in one
    call against live queue depths, enqueue it on the pool, and advance
    simulated time by the window's offered-load interval. Scene
    complexity per stream follows the simulator's Markov chain."""

    gateway: WindowedGateway
    pool: AsyncExecutorPool
    window: int = 64
    n_streams: int = 15
    stickiness: float = 0.85
    offered_rps: float | None = None   # None: ~90% of fleet capacity
    seed: int = 0
    _recs: dict = field(default=None, repr=False)

    @classmethod
    def build(cls, scenario, *, window: int = 64, backend: str = "auto",
              offered_rps: float | None = None,
              device=None) -> "ServingPlane":
        """One Scenario -> the whole plane: the gateway adopts the
        scenario's profile, policy, γ, Δ and dispatch, the pool its fleet,
        the workload its user count, stickiness and seed. ``device`` is
        where the gateway routes (``None``: the CUDA device; raises
        without one)."""
        gw = WindowedGateway(scenario, backend=backend,
                             n_streams=max(1024, scenario.n_users),
                             device=device)
        return cls(gw, AsyncExecutorPool(gw.prof), window=window,
                   n_streams=scenario.n_users,
                   stickiness=scenario.stickiness,
                   offered_rps=offered_rps, seed=scenario.seed)

    def capacity_rps(self) -> float:
        """Aggregate fleet service capacity (completions/sec) at the
        pool's CURRENT true mean service times (after drift), not the
        offline profile. The default offered load is 90% of this."""
        return float(np.sum(1.0 / self.pool._T_s.mean(axis=1)))

    def _observe(self, resp, rng) -> None:
        """Feed one polled completion window back: measured latency and
        energy into the dispatch state (keyed by the ESTIMATED group the
        decision used), modelled detection counts into the estimator."""
        if resp.size == 0:
            return
        self.gateway.observe_window(resp.pairs, resp.est_groups,
                                    resp.latency_ms, resp.energy_mwh)
        true_count = np.where(resp.groups < self.gateway.prof.n_groups - 1,
                              resp.groups, 5)
        det = rng.binomial(true_count, _P_DET(resp.map_proxy))
        det += rng.random(resp.size) < 0.05 * (1 - resp.map_proxy / 100.0)
        self.gateway.observe_detections_window(resp.stream_ids, det)
        r = self._recs
        r["latency"].append(resp.latency_ms / 1000.0)
        r["energy"].append(resp.energy_mwh)
        r["map"].append(resp.map_proxy)
        r["pair"].append(resp.pairs)
        r["g_true"].append(resp.groups)
        r["g_est"].append(resp.est_groups)

    def run(self, n_requests: int = 2048):
        """Drive ``n_requests`` through the plane; returns per-request
        record arrays (completion order) plus router timing:
        ``router_s`` (total wall-clock inside ``route_window``, including
        the copy of the window's pairs to the host) and
        ``router_window_s`` (per-window samples). Repeated calls CONTINUE
        the plane: clock, streams, queues and estimator state persist."""
        G = self.gateway.prof.n_groups
        if getattr(self, "_rng", None) is None:     # first run: cold plane
            self._rng = np.random.default_rng(self.seed)
            P_mat = EST.markov_transition(G, self.stickiness,
                                          device=self.gateway.device)
            pi0 = EST.stationary(P_mat).cpu().numpy()
            P_mat = P_mat.cpu().numpy()
            self._cumP = P_mat.cumsum(axis=1)
            self._scene = self._rng.choice(G, self.n_streams, p=pi0)
            self._now = 0.0
            self._served = 0
        rng, cumP, scene = self._rng, self._cumP, self._scene
        rps = self.offered_rps or 0.9 * self.capacity_rps()
        self._recs = {k: [] for k in ("latency", "energy", "map", "pair",
                                      "g_true", "g_est")}
        router_win = []
        now, done = self._now, 0
        while done < n_requests:
            self._observe(self.pool.poll(now), rng)
            w_new = min(self.window, n_requests - done)
            rid0 = self._served + done
            streams = np.arange(rid0, rid0 + w_new) % self.n_streams
            scene[streams] = (rng.random((w_new, 1))
                              > cumP[scene[streams]]).sum(axis=1)
            t0 = time.perf_counter()
            pairs, gs, _q = self.gateway.route_window(streams,
                                                      self.pool.depths())
            pairs = pairs.cpu().numpy()
            router_win.append(time.perf_counter() - t0)
            self.pool.submit_window(pairs, scene[streams], now,
                                    est_groups=gs.cpu().numpy(),
                                    stream_ids=streams,
                                    rids=np.arange(rid0, rid0 + w_new))
            now += w_new / rps
            done += w_new
        self._observe(self.pool.poll(np.inf), rng)   # drain the tail
        self._now = max(now, float(self.pool._avail.max(initial=0.0)))
        self._served += done
        recs = {k: np.concatenate(v) for k, v in self._recs.items()}
        recs["router_s"] = float(np.sum(router_win))
        recs["router_window_s"] = np.asarray(router_win)
        return recs

    @staticmethod
    def summarize(recs) -> dict:
        """Mean and p90 latency (ms), mean energy (mWh), mean mAP and the
        estimator's accuracy over one run's records."""
        lat = recs["latency"]
        return {
            "latency_ms": float(lat.mean() * 1000),
            "latency_p90_ms": float(np.percentile(lat, 90) * 1000),
            "energy_mwh": float(recs["energy"].mean()),
            "map": float(recs["map"].mean()),
            "estimator_acc": float((recs["g_true"] == recs["g_est"]).mean()),
        }
