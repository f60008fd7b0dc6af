"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

  moscore/  the routing-window scan of Algorithm 1 with queue feedback
            (``moscore_cuda``, ``moscore_hoisted_cuda``), behind
            ``moscore_route``'s backend dispatch

Each kernel directory holds ``csrc/`` (CUDA sources and the binding),
the wrappers that build it at first use and launch it, and ``ops.py``.
"""
