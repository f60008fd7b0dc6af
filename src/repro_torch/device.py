"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; anything else is taken as given.

    There is no silent CPU path: with no CUDA device, ``None`` raises and
    the caller has to ask for the CPU (``device="cpu"``) explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
