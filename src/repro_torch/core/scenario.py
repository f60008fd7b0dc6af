"""Declarative scenarios (port of the serving-path fields of
``repro.core.scenario.Scenario``).

A :class:`Scenario` carries what the windowed serving plane reads: the
fleet profile, policy, user count, γ, Δ, the scene chain's stickiness,
the seed and the dispatch engine, with the JAX package's defaults. The
simulator fields (workload, drift, cloud, faults, mesh, ...) come with
their slices."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.core.dispatch import DispatchEngine, StaticDispatch
from repro_torch.core.policies import POLICY_CODES
from repro_torch.core.profiles import ProfileTable, paper_fleet

#: named profiles a Scenario can reference symbolically
PROFILE_REGISTRY: dict[str, Callable[[], ProfileTable]] = {
    "paper": paper_fleet,
}


@dataclass(frozen=True, eq=False)
class Scenario:
    """One serving scenario. ``profile`` is a registry name
    (:data:`PROFILE_REGISTRY`, default ``"paper"``, the Table I/II
    testbed) or a :class:`ProfileTable`; ``dispatch`` defaults to
    :class:`StaticDispatch` when ``None``."""

    profile: ProfileTable | str = "paper"
    policy: str = "MO"
    n_users: int = 15
    gamma: float = 0.5
    delta: float = 20.0
    stickiness: float = 0.85
    seed: int = 0
    dispatch: DispatchEngine | None = None

    def __post_init__(self):
        if isinstance(self.profile, str):
            if self.profile not in PROFILE_REGISTRY:
                raise ValueError(
                    f"unknown profile {self.profile!r}; registered: "
                    f"{sorted(PROFILE_REGISTRY)}")
        elif not isinstance(self.profile, ProfileTable):
            raise TypeError("profile must be a registry name or a "
                            f"ProfileTable, got {type(self.profile)}")
        if self.policy not in POLICY_CODES:
            raise ValueError(f"unknown policy {self.policy!r}; one of "
                             f"{sorted(POLICY_CODES)}")

    def resolve_profile(self) -> ProfileTable:
        if isinstance(self.profile, str):
            return PROFILE_REGISTRY[self.profile]()
        return self.profile

    def resolve_dispatch(self) -> DispatchEngine:
        return StaticDispatch() if self.dispatch is None else self.dispatch
