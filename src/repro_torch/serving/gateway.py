"""The request plane's router (port of the MO fused path of
``repro.serving.gateway.WindowedGateway``).

:class:`WindowedGateway` admits requests in windows. For each window it
gathers the estimator state (the last detected count per stream, a
``(n_streams,)`` tensor on the gateway's device), estimates the groups and
routes the whole window through ``moscore_route`` with intra-window queue
feedback: on a CUDA device one launch of the hoisted CUDA kernel
(``backend="auto"``). Detected counts flow back through
:meth:`WindowedGateway.observe_detections_window`, where a stream that
completes twice in one window keeps its latest entry.

This slice serves the MO policy under :class:`StaticDispatch`. The other
policies, adaptive dispatch, the cloud tier, the fault plane and
hierarchical pods raise ``NotImplementedError`` until their slices land."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.dispatch import DispatchEngine, StaticDispatch
from repro_torch.core.estimator import group_of_count
from repro_torch.core.profiles import ProfileTable
from repro_torch.core.scenario import Scenario
from repro_torch.device import resolve_device
from repro_torch.kernels.moscore import moscore_route, resolve_backend

i32 = torch.int32
f32 = torch.float32


@dataclass
class WindowedGateway:
    """Windowed (micro-batched) router over a heterogeneous fleet.

    ``prof`` is a :class:`ProfileTable` or a :class:`Scenario`, whose
    policy, γ, Δ and dispatch engine apply to knobs left at their
    defaults; its user count sets the minimum ``n_streams``.
    ``n_streams`` is the estimator-state capacity (stream ids stay below
    it); ``backend`` is one of ``repro_torch.kernels.moscore.BACKENDS``,
    resolved once at construction (``"auto"``: the hoisted CUDA kernel on
    a CUDA device, the hoisted PyTorch scan on the CPU);
    ``device`` is where the tables, the estimator state and the routing
    run (``None``: the CUDA device; raises without one)."""

    prof: ProfileTable
    policy: str = "MO"
    gamma: float = 0.5
    delta: float = 20.0
    online: bool = False
    dispatch: DispatchEngine | None = None
    n_streams: int = 1024
    backend: str = "auto"
    cloud: Any = None
    faults: Any = None
    pods: Any = None
    device: Any = None

    def __post_init__(self):
        if isinstance(self.prof, Scenario):
            sc = self.prof
            self.prof = sc.resolve_profile()
            for name, default, value in (("policy", "MO", sc.policy),
                                         ("gamma", 0.5, sc.gamma),
                                         ("delta", 20.0, sc.delta)):
                if getattr(self, name) == default:
                    setattr(self, name, value)
            if self.dispatch is None:
                self.dispatch = sc.resolve_dispatch()
            if self.n_streams == 1024:
                self.n_streams = max(self.n_streams, sc.n_users)
        if self.dispatch is None:
            self.dispatch = StaticDispatch()
        for wanted, what in (
                (self.policy != "MO", f"policy {self.policy!r} (the "
                 "baselines and the select_window scan, ROADMAP A3 and A6)"),
                (self.online or self.dispatch.adaptive,
                 "adaptive dispatch (OnlineDispatch, ROADMAP A6)"),
                (self.cloud is not None, "the cloud tier (ROADMAP A10)"),
                (self.faults is not None, "the fault plane (ROADMAP A11)"),
                (self.pods is not None,
                 "hierarchical pods routing (ROADMAP A12)")):
            if wanted:
                raise NotImplementedError(
                    f"{what} is not ported to repro_torch yet")
        if self.prof.is_stacked:
            raise ValueError("gateway serves one fleet; scenario/profile "
                             "is a stacked ensemble")
        self.device = resolve_device(self.device)
        self.backend = resolve_backend(self.backend, self.device)
        self.prof = self.prof.to(self.device)
        self._counts = torch.zeros((self.n_streams,), dtype=i32,
                                   device=self.device)
        self._dstate = self.dispatch.init(self.prof)

    # -- estimator state ----------------------------------------------------

    def _check_streams(self, ids: np.ndarray):
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_streams):
            raise ValueError(
                f"stream id out of range [0, {self.n_streams}) — raise "
                f"n_streams= (gateway estimator-state capacity)")

    def observe_detections_window(self, stream_ids, detected_counts):
        """Scatter a batch of detected object counts into the estimator
        state; a stream that completes twice in one window keeps its
        latest entry (a scatter-max of the window index per stream, which
        equals a sequential per-request replay)."""
        ids = np.asarray(stream_ids, np.int64)
        self._check_streams(ids)
        if ids.size == 0:
            return
        ids_d = torch.as_tensor(ids, device=self.device)
        cnts = torch.as_tensor(np.asarray(detected_counts),
                               device=self.device).to(i32)
        pos = torch.full((self.n_streams,), -1, dtype=torch.int64,
                         device=self.device)
        pos.scatter_reduce_(0, ids_d, torch.arange(ids.shape[0],
                                                   device=self.device),
                            reduce="amax")
        latest = cnts[torch.clamp(pos, min=0)]
        self._counts = torch.where(pos >= 0, latest, self._counts)

    # -- dispatch-state observation -----------------------------------------

    def observe_window(self, pairs, groups, latency_ms,
                       energy_mwh=None) -> None:
        """Fold a completed window's measurements into the dispatch state.
        A no-op: the only engine this slice serves is the non-adaptive
        :class:`StaticDispatch`, which discards observations."""

    # -- decisions ----------------------------------------------------------

    def route_window(self, stream_ids, queue_depths):
        """Route one admission window.

        ``stream_ids``: (W,) ints below ``n_streams``; ``queue_depths``:
        (P,) live queue depths at admission. Returns ``(pairs (W,) int32,
        est_groups (W,) int32, q_after (P,) float32)`` as tensors on the
        gateway's device. Decision w+1 sees decision w's queue bump, and
        ``q_after`` is the depths to thread into the next window when no
        executor feedback arrives in between, so any window partition of
        one request stream routes identically."""
        ids = np.asarray(stream_ids, np.int64)
        self._check_streams(ids)
        return self._route_fused(
            torch.as_tensor(ids, device=self.device),
            torch.as_tensor(queue_depths, device=self.device).to(f32))

    def _route_fused(self, ids, q0):
        # MO path: estimator gather + one moscore_route call against the
        # engine's belief tables; rr advances by W exactly as W select()
        # calls would have advanced it
        gs = group_of_count(self._counts[ids], self.prof.n_groups)
        tbl = self.dispatch.tables(self._dstate, self.prof)
        pairs, q = moscore_route(tbl.T, tbl.E, tbl.mAP, gs, q0,
                                 delta=float(self.delta),
                                 gamma=float(self.gamma),
                                 backend=self.backend)
        self._dstate = {**self._dstate,
                        "rr": self._dstate["rr"] + ids.shape[0]}
        return pairs, gs, q
