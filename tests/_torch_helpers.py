"""Shared pieces of the port's tests (``test_torch_*.py``).

Both packages see the same inputs: fleets are drawn by the JAX package
and carried across with ``profile_from_numpy``; everything else is made
with numpy from a seed and handed to each side. This module imports no
JAX, so the card's tests (``test_torch_cuda.py``) can use it where JAX is
not installed."""

import numpy as np
import torch

from repro_torch.core.profiles import ProfileTable, profile_from_numpy


def carry(prof) -> ProfileTable:
    """The JAX package's fleet (a ``repro.core.profiles.ProfileTable``) as
    a port table on the CPU."""
    floor = None if prof.floor_mw is None else np.asarray(prof.floor_mw)
    return profile_from_numpy(np.asarray(prof.T), np.asarray(prof.E),
                              np.asarray(prof.mAP), prof.names, floor)


def np_(x) -> np.ndarray:
    """A JAX array or a port tensor (any device) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)
