from repro_torch.kernels.moscore.moscore import (moscore_cuda,
                                                 moscore_hoisted_cuda)
from repro_torch.kernels.moscore.ops import (BACKEND_ENV, BACKENDS,
                                             default_backend, moscore_route,
                                             resolve_backend)
from repro_torch.kernels.moscore.ref import ref_moscore_route

__all__ = ["moscore_route", "ref_moscore_route", "moscore_cuda",
           "moscore_hoisted_cuda", "default_backend", "resolve_backend",
           "BACKENDS", "BACKEND_ENV"]
