"""The modelled executor pool (port of ``AsyncExecutorPool`` from
``repro.serving.executor``).

The whole fleet's FIFO queues as one non-blocking object, on the host in
numpy as in the JAX package: ``submit_window`` enqueues a routed window
with modelled service times from the profile table and returns at once;
completions surface through :meth:`AsyncExecutorPool.poll`, in completion
order. The fault hooks (``fail_pairs``, ``set_fault_throttle``) and the
``real``-mode executor come with their slices."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.profiles import ProfileTable
from repro_torch.serving.request import ResponseWindow

_FIELDS = ("rids", "stream_ids", "pairs", "groups", "est_groups",
           "arrival_s", "finish_s", "energy_mwh", "map_proxy")


@dataclass
class AsyncExecutorPool:
    """The fleet's executor queues, fed a routed window at a time.

    :meth:`depths` is the live per-pair in-flight count the next routing
    window scores against (q_p of Algorithm 1). Accounting invariant:
    every completion polled was submitted before, so depths never go
    negative and ``submitted == polled + in_flight`` at every instant."""

    prof: ProfileTable

    def __post_init__(self):
        if self.prof.is_stacked:
            raise ValueError("executor pool serves one fleet, not a "
                             "stacked ensemble")
        P = self.prof.n_pairs
        # TRUE service times: the profile times a cumulative drift
        self._T_base = self.prof.T.cpu().numpy().astype(np.float64) / 1000.0
        self._E_base = self.prof.E.cpu().numpy().astype(np.float64)
        self._drift_t = np.float64(1.0)
        self._drift_e = np.float64(1.0)
        self._recompute()
        self._M = self.prof.mAP.cpu().numpy().astype(np.float64)
        self._avail = np.zeros(P, np.float64)   # per-pair FIFO frontier
        self._depth = np.zeros(P, np.int64)
        self.submitted = 0
        self.polled = 0
        # pending completions, appended per window, drained by poll()
        self._pending: list[ResponseWindow] = []

    @property
    def in_flight(self) -> int:
        return int(self._depth.sum())

    def _recompute(self) -> None:
        self._T_s = self._T_base * self._drift_t
        self._E = self._E_base * self._drift_e

    def apply_drift(self, t_scale, e_scale=None) -> None:
        """Scale the TRUE service times (and optionally energies) from now
        on: thermal throttling, a model swap. Balancers are never told.
        Drift is cumulative: repeated calls multiply."""
        self._drift_t = self._drift_t * np.asarray(t_scale, np.float64)
        if e_scale is not None:
            self._drift_e = self._drift_e * np.asarray(e_scale, np.float64)
        self._recompute()

    def depths(self) -> np.ndarray:
        """(P,) live queue depths: q_p for the next admission window."""
        return self._depth.astype(np.float32).copy()

    def submit_window(self, pairs, groups, now: float, *, est_groups=None,
                      stream_ids=None, rids=None) -> ResponseWindow:
        """Enqueue one routed window at time ``now`` (non-blocking).

        ``pairs``: (W,) routing decisions; ``groups``: (W,) TRUE
        complexity groups (they drive modelled service time and energy).
        Returns the scheduled :class:`ResponseWindow` at once: the records
        :meth:`poll` will surface once ``now`` passes their finish times."""
        pairs = np.asarray(pairs, np.int64)
        groups = np.asarray(groups, np.int64)
        W = pairs.shape[0]
        svc = self._T_s[pairs, groups]
        finish = np.empty(W, np.float64)
        for p in np.unique(pairs):              # FIFO within each pair
            m = pairs == p
            finish[m] = max(now, self._avail[p]) + np.cumsum(svc[m])
            self._avail[p] = finish[m][-1]
        np.add.at(self._depth, pairs, 1)
        self.submitted += W

        def arr(x, dtype=np.int64):
            return np.zeros(W, dtype) if x is None else np.asarray(x, dtype)

        resp = ResponseWindow(
            rids=arr(rids), stream_ids=arr(stream_ids), pairs=pairs,
            groups=groups, est_groups=arr(est_groups),
            arrival_s=np.full(W, float(now)), finish_s=finish,
            energy_mwh=self._E[pairs, groups],
            map_proxy=self._M[pairs, groups])
        self._pending.append(resp)
        return resp

    def poll(self, now: float) -> ResponseWindow:
        """Drain every completion with ``finish_s <= now``, merged across
        pairs into ONE window in completion order (possibly empty;
        ``poll(np.inf)`` drains everything)."""
        if not self._pending:
            return ResponseWindow()
        cat = {f: np.concatenate([getattr(w, f) for w in self._pending])
               for f in _FIELDS}
        done = cat["finish_s"] <= now
        keep = {f: v[~done] for f, v in cat.items()}
        self._pending = [] if keep["pairs"].size == 0 \
            else [ResponseWindow(**keep)]
        order = np.argsort(cat["finish_s"][done], kind="stable")
        out = ResponseWindow(**{f: v[done][order] for f, v in cat.items()})
        np.subtract.at(self._depth, out.pairs, 1)
        self.polled += out.size
        return out
