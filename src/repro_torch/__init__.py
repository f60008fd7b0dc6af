"""PyTorch/CUDA port of the multi-objective load balancer (``repro``).

The layout mirrors ``repro``: ``core/`` (profiles, estimator, Algorithm 1,
dispatch, scenarios), ``kernels/moscore/`` (the routing-window scan as
hand-written CUDA for sm_90a beside its plain PyTorch version) and
``serving/`` (the windowed request plane). The package imports torch and
numpy only. Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (:func:`repro_torch.device.resolve_device`)."""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
