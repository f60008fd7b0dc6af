"""PyTorch/CUDA port of the multi-objective load balancer (``repro``).

The layout mirrors ``repro``: ``core/`` (profiles, estimator, Algorithm
1, dispatch, scenarios), ``kernels/`` (the routing-window scan, flash
attention and split-K decode attention as hand-written CUDA for sm_90a,
each beside its plain PyTorch version), ``serving/`` (the windowed
request plane), and for LM serving ``common/`` and ``configs/`` (the
dense LM configurations) and ``models/`` (prefill and greedy decode).
The package imports torch and numpy only. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`)."""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
