"""Dispatch engines: where per-decision routing state lives (port of the
interface and ``StaticDispatch`` of ``repro.core.dispatch``).

An engine is a stateless object (hyper-parameters only). Its mutable
state is a :data:`DispatchState` dict of tensors, built by :meth:`init`
and held by the caller; every engine's state carries the round-robin
counter ``"rr"``. The online-adaptive engine waits for a later slice."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.profiles import ProfileTable

DispatchState = dict


class DispatchEngine:
    """Interface between the routing loop and its per-decision state."""

    #: False when :meth:`observe` is a no-op, so serving paths can skip the
    #: observation plumbing entirely
    adaptive: bool = True

    def init(self, prof: ProfileTable) -> DispatchState:
        """Fresh state for a fleet of ``prof``'s shape, on its device."""
        raise NotImplementedError

    def tables(self, state: DispatchState, prof: ProfileTable):
        """The belief :class:`ProfileTable` decisions are scored against."""
        raise NotImplementedError

    def observe(self, state, p, g, obs_t_ms, obs_e_mwh=None):
        """Fold one completed request's latency (ms) and optionally energy
        (mWh) at cell ``(p, g)`` into the state."""
        raise NotImplementedError

    def observe_window(self, state, pairs, groups, obs_t_ms,
                       obs_e_mwh=None):
        """Fold a window of observations ((W,) tensors, completion order).
        The default loops :meth:`observe`."""
        for w in range(len(pairs)):
            state = self.observe(state, pairs[w], groups[w], obs_t_ms[w],
                                 None if obs_e_mwh is None
                                 else obs_e_mwh[w])
        return state


@dataclass(frozen=True)
class StaticDispatch(DispatchEngine):
    """The default: decisions use the offline profile unchanged and
    observations are discarded; the state is the round-robin counter."""

    adaptive = False

    def init(self, prof):
        return {"rr": torch.zeros((), dtype=torch.int32, device=prof.device)}

    def tables(self, state, prof):
        return prof

    def observe(self, state, p, g, obs_t_ms, obs_e_mwh=None):
        return state

    def observe_window(self, state, pairs, groups, obs_t_ms,
                       obs_e_mwh=None):
        return state
