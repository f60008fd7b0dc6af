"""Object-count estimator and scene-complexity chain (port of
``repro.core.estimator``).

The group of an incoming frame is estimated from the detection output of
the previous frame of the same stream (paper §III-B.1). The chain's
transition matrix and its stationary distribution reproduce the JAX
package's float32 results bit for bit: the row sum is taken left to
right, and the power iteration's matvec is the left-to-right chain of
fused multiply-adds that XLA's CPU backend emits for a small ``p @ P``."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

f32 = torch.float32


def group_of_count(count, n_groups: int = 5) -> torch.Tensor:
    """Paper grouping: {0, 1, 2, 3, 4+} objects."""
    return torch.clamp(count, 0, n_groups - 1).to(torch.int32)


def _scalar(x: float) -> torch.Tensor:
    # a Python float enters float32 arithmetic rounded to float32 first,
    # as JAX's weakly typed scalars do
    return torch.tensor(x, dtype=f32)


def markov_transition(n_states: int = 5, stickiness: float = 0.85,
                      drift_up: float = 0.62, *,
                      device=None) -> torch.Tensor:
    """Scene-complexity Markov chain: consecutive frames usually keep their
    object count (temporal continuity), occasionally drift +-1, rarely jump.
    ``drift_up`` > 0.5 skews the stationary distribution toward crowded
    scenes. Returns the (S, S) row-stochastic float32 matrix on
    ``device`` (``None``: the CUDA device)."""
    dev = resolve_device(device)
    eye = torch.eye(n_states, dtype=f32, device=dev)
    up = torch.roll(eye, 1, dims=1)
    up[-1] = 0.0                                       # no wraparound
    down = torch.roll(eye, -1, dims=1)
    down[0] = 0.0
    drift = _scalar(drift_up) * up + _scalar(1 - drift_up) * down
    # boundary states put all drift mass on their single neighbour
    drift[0, 1] = 1.0
    drift[-1, -2] = 1.0
    jump = torch.ones((n_states, n_states), dtype=f32, device=dev) \
        / _scalar(n_states)
    P = _scalar(stickiness) * eye + _scalar(1 - stickiness) * (
        _scalar(0.8) * drift + _scalar(0.2) * jump)
    row = P[:, 0]
    for j in range(1, n_states):                       # left to right
        row = row + P[:, j]
    return P / row[:, None]


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add does.

    The float32 product is exact in float64. The float64 sum is turned
    into its round-to-odd value (TwoSum gives the rounding error; an
    inexact even result steps one ulp toward it), which then rounds to
    float32 exactly as the infinitely precise sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def stationary(P: torch.Tensor) -> torch.Tensor:
    """Stationary distribution of a row-stochastic matrix: 200 steps of
    power iteration from the uniform vector, each ``pi @ P`` computed as a
    left-to-right fused multiply-add chain over the rows."""
    n = P.shape[0]
    pi = torch.ones((n,), dtype=f32, device=P.device) / _scalar(n)
    for _ in range(200):
        acc = torch.zeros_like(pi)
        for i in range(n):
            acc = _fma_f32(pi[i], P[i], acc)
        pi = acc
    return pi
