"""The plain PyTorch reference of Algorithm 1 with queue feedback: every
term recomputed per request. The unhoisted CUDA kernel must match it
exactly."""

from __future__ import annotations

from repro_torch.core.policies import mo_select_batch
from repro_torch.core.profiles import ProfileTable


def ref_moscore_route(T, E, mAP, gs, q0, *, delta: float, gamma: float,
                      health=None):
    """``(choices (W,) int32, q_final (P,) float32)`` for (P, G) tables,
    on the tensors' device."""
    return mo_select_batch(ProfileTable(T, E, mAP), gs, q0, delta=delta,
                           gamma=gamma, health=health)
