"""Request/response records for the heterogeneous serving fleet.

:class:`Request`/:class:`Response` are the per-request records of the
original engine; :class:`RequestWindow`/:class:`ResponseWindow` are their
batched struct-of-arrays forms — one record per admission window, fields
as (W,) arrays — used by the windowed request plane
(``repro_torch.serving.engine.ServingPlane``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class Request:
    rid: int
    stream_id: int            # video stream / user id (estimator state key)
    arrival_s: float
    payload: Any = None       # image array (or token array for LM cells)
    est_group: int = 0        # estimated complexity class (set by gateway)


@dataclass
class Response:
    rid: int
    stream_id: int
    pair: int                 # device-model pair the request ran on
    start_s: float
    finish_s: float
    detections: Any = None
    detected_count: int = 0
    energy_mwh: float = 0.0
    map_proxy: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.finish_s  # caller subtracts arrival


def _empty(dtype):
    return field(default_factory=lambda: np.empty((0,), dtype))


@dataclass
class RequestWindow:
    """One admission window, struct-of-arrays: W requests admitted at the
    same instant and routed by ONE ``route_window`` call."""

    stream_ids: np.ndarray                      # (W,) estimator state keys
    arrival_s: float = 0.0                      # window admission time
    rids: np.ndarray = _empty(np.int64)         # (W,) request ids
    payloads: Any = None                        # optional (W, ...) frames

    @property
    def size(self) -> int:
        return int(np.asarray(self.stream_ids).shape[0])


@dataclass
class ResponseWindow:
    """Completed requests surfaced by one executor-pool poll, in
    completion order (fields are parallel (W,) arrays). ``groups`` is the
    TRUE complexity group (drives modelled service/detections);
    ``est_groups`` the gateway's estimate at routing time (what
    observations are keyed by)."""

    rids: np.ndarray = _empty(np.int64)
    stream_ids: np.ndarray = _empty(np.int64)
    pairs: np.ndarray = _empty(np.int64)
    groups: np.ndarray = _empty(np.int64)
    est_groups: np.ndarray = _empty(np.int64)
    arrival_s: np.ndarray = _empty(np.float64)
    finish_s: np.ndarray = _empty(np.float64)
    energy_mwh: np.ndarray = _empty(np.float64)
    map_proxy: np.ndarray = _empty(np.float64)

    @property
    def size(self) -> int:
        return int(self.pairs.shape[0])

    @property
    def latency_ms(self) -> np.ndarray:
        return (self.finish_s - self.arrival_s) * 1000.0
