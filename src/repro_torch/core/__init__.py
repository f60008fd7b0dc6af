"""Core of the port: profiles, the estimator, Algorithm 1, dispatch
engines and scenarios, as plain PyTorch on tensors."""

from repro_torch.core.dispatch import DispatchEngine, StaticDispatch
from repro_torch.core.estimator import (group_of_count, markov_transition,
                                        stationary)
from repro_torch.core.policies import (BIG, POLICY_CODES, mo_precompute,
                                       mo_scan_hoisted, mo_scores,
                                       mo_scores_hoisted, mo_select,
                                       mo_select_batch,
                                       mo_select_batch_hoisted)
from repro_torch.core.profiles import (GROUP_NAMES, ProfileTable,
                                       paper_fleet, profile_from_numpy,
                                       synthetic_fleet)
from repro_torch.core.scenario import PROFILE_REGISTRY, Scenario

__all__ = [
    "DispatchEngine", "StaticDispatch",
    "group_of_count", "markov_transition", "stationary",
    "BIG", "POLICY_CODES", "mo_precompute", "mo_scan_hoisted", "mo_scores",
    "mo_scores_hoisted", "mo_select", "mo_select_batch",
    "mo_select_batch_hoisted",
    "GROUP_NAMES", "ProfileTable", "paper_fleet", "profile_from_numpy",
    "synthetic_fleet",
    "PROFILE_REGISTRY", "Scenario",
]
