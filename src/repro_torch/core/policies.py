"""Algorithm 1, the two-stage multi-objective policy (port of the MO half
of ``repro.core.policies``), as plain PyTorch functions on tensors.

Every function here is float32 and reproduces the JAX package's
decisions bit for bit: the same expression order, ``BIG`` sentinels for
masked reductions, and first-index ``argmin``. A Python float enters the
arithmetic rounded to float32 (:func:`_scalar`), as JAX's weakly typed
scalars do; ``1 - gamma`` is taken in Python double first, as the JAX
kernels and scans take it.

:func:`mo_select_batch` and :func:`mo_scan_hoisted` are the plain
versions of the two CUDA kernels in ``repro_torch.kernels.moscore``: a
Python loop of small tensor ops per request, used on the CPU and, on the
card, only to check the kernels."""

from __future__ import annotations

import torch

from repro_torch.core.profiles import ProfileTable

f32 = torch.float32
BIG = 1e30
EPS = 1e-9

POLICY_CODES = {"MO": 0, "RR": 1, "RND": 2, "LC": 3, "LE": 4, "LT": 5,
                "HA": 6}


def _scalar(x: float) -> torch.Tensor:
    # a 0-dim CPU tensor broadcasts into CUDA ops without a copy
    return torch.tensor(x, dtype=f32)


def mo_scores(T_g, E_g, mAP_g, q, *, delta: float, gamma: float,
              health=None):
    """Algorithm 1 scores over the P pairs for one request.

    ``T_g``/``E_g``/``mAP_g``: (P,) profiled columns of the request's
    group; ``q``: (P,) live queue depths. Returns ``(J, feasible)``;
    infeasible pairs score ``BIG``. ``health`` (optional, (P,) bool)
    removes down pairs at the feasibility stage; when no healthy pair
    clears the (unmasked) accuracy bar, the candidate set relaxes to all
    healthy pairs and the energy term is zeroed."""
    map_max = torch.max(mAP_g)
    feasible = mAP_g >= map_max - _scalar(delta)
    if health is not None:
        cand = feasible & health
        degraded = ~torch.any(cand)
        feasible = torch.where(degraded, health, cand)
    L_exp = T_g * (1.0 + q)
    l_min = torch.min(torch.where(feasible, L_exp, BIG))
    l_max = torch.max(torch.where(feasible, L_exp, -BIG))
    e_min = torch.min(torch.where(feasible, E_g, BIG))
    e_max = torch.max(torch.where(feasible, E_g, -BIG))
    L_n = (L_exp - l_min) / torch.clamp_min(l_max - l_min, EPS)
    E_n = (E_g - e_min) / torch.clamp_min(e_max - e_min, EPS)
    if health is not None:
        E_n = torch.where(degraded, 0.0, E_n)
    J = _scalar(gamma) * L_n + _scalar(1.0 - gamma) * E_n
    return torch.where(feasible, J, BIG), feasible


def mo_select(prof: ProfileTable, g: int, q, *, delta: float = 5.0,
              gamma: float = 0.5, health=None):
    """p* = argmin J over the accuracy-feasible set (one request)."""
    J, feasible = mo_scores(prof.T[:, g], prof.E[:, g], prof.mAP[:, g], q,
                            delta=delta, gamma=gamma, health=health)
    return torch.argmin(J), J, feasible


def mo_precompute(T, E, mAP, *, delta: float, health=None):
    """The queue-independent half of Algorithm 1 for a whole (P, G) table.

    Returns ``(feasible, E_n)``, both (P, G): the accuracy-feasibility
    mask and the feasible-set-normalised energy term. Column g of each
    equals what :func:`mo_scores` computes for a request of group g, bit
    for bit (min and max are exact). ``health`` folds in with
    :func:`mo_scores`'s degraded-mode expressions."""
    map_max = torch.amax(mAP, dim=-2, keepdim=True)
    feasible = mAP >= map_max - _scalar(delta)
    if health is not None:
        h = health[..., None]
        cand = feasible & h
        degraded = ~torch.any(cand, dim=-2, keepdim=True)
        feasible = torch.where(degraded, h, cand)
    e_min = torch.amin(torch.where(feasible, E, BIG), dim=-2, keepdim=True)
    e_max = torch.amax(torch.where(feasible, E, -BIG), dim=-2, keepdim=True)
    E_n = (E - e_min) / torch.clamp_min(e_max - e_min, EPS)
    if health is not None:
        E_n = torch.where(degraded, 0.0, E_n)
    return feasible, E_n


def mo_scores_hoisted(T_g, En_g, feas_g, q, *, gamma: float):
    """Per-request Algorithm 1 scores from precomputed group constants
    (columns of :func:`mo_precompute`'s outputs); bit-identical to
    :func:`mo_scores` on the same inputs."""
    L_exp = T_g * (1.0 + q)
    l_min = torch.min(torch.where(feas_g, L_exp, BIG))
    l_max = torch.max(torch.where(feas_g, L_exp, -BIG))
    L_n = (L_exp - l_min) / torch.clamp_min(l_max - l_min, EPS)
    J = _scalar(gamma) * L_n + _scalar(1.0 - gamma) * En_g
    return torch.where(feas_g, J, BIG)


def _bump(q: torch.Tensor, p: torch.Tensor, one: torch.Tensor) -> None:
    # q[p] += 1 with p left on the device (indexing with a 0-dim tensor
    # would read it back to the host)
    q.index_add_(0, p.view(1), one)


def mo_scan_hoisted(Tt, Ent, Ft, gs, q0, *, gamma: float):
    """The window scan of the hoisted kernel, in plain PyTorch.

    ``Tt``/``Ent``: (G, P) float32 transposed profile and normalised
    energy; ``Ft``: (G, P) bool feasibility; ``gs``: (W,) groups; ``q0``:
    (P,) queue depths. Returns ``(choices (W,) int32, q_final (P,)
    float32)``; each choice bumps ``q`` before the next request is scored.
    """
    q = q0.to(f32).clone()
    gs = gs.long()
    Tg, Eg, Fg = Tt[gs], Ent[gs], Ft[gs].bool()      # (W, P) rows
    one = torch.ones((1,), dtype=f32, device=q.device)
    choices = torch.empty((gs.shape[0],), dtype=torch.int32,
                          device=q.device)
    for w in range(gs.shape[0]):
        p = torch.argmin(mo_scores_hoisted(Tg[w], Eg[w], Fg[w], q,
                                           gamma=gamma))
        choices[w] = p
        _bump(q, p, one)
    return choices, q


def mo_select_batch_hoisted(prof: ProfileTable, gs, q0, *,
                            delta: float = 5.0, gamma: float = 0.5,
                            health=None):
    """:func:`mo_select_batch` with the queue-independent work hoisted out
    of the scan: one :func:`mo_precompute`, then :func:`mo_scan_hoisted`.
    Same contract, bit-identical choices and final queue. ``health`` is
    one (P,) mask for the whole window."""
    feasible, E_n = mo_precompute(prof.T, prof.E, prof.mAP, delta=delta,
                                  health=health)
    return mo_scan_hoisted(prof.T.t(), E_n.t(), feasible.t(), gs, q0,
                           gamma=gamma)


def mo_select_batch(prof: ProfileTable, gs, q0, *, delta: float = 5.0,
                    gamma: float = 0.5, health=None):
    """Sequential assignment of a routing window with queue feedback: each
    selection bumps q[p*] before the next request is scored, with every
    Algorithm 1 term recomputed per request. ``gs``: (W,) groups. Returns
    ``(choices (W,) int32, q_final (P,) float32)``."""
    q = q0.to(f32).clone()
    gs = gs.long()
    Tg, Eg, Mg = prof.T.t()[gs], prof.E.t()[gs], prof.mAP.t()[gs]
    one = torch.ones((1,), dtype=f32, device=q.device)
    choices = torch.empty((gs.shape[0],), dtype=torch.int32,
                          device=q.device)
    for w in range(gs.shape[0]):
        J, _ = mo_scores(Tg[w], Eg[w], Mg[w], q, delta=delta, gamma=gamma,
                         health=health)
        p = torch.argmin(J)
        choices[w] = p
        _bump(q, p, one)
    return choices, q
