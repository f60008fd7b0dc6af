"""The windowed request plane of the port: gateway, executor pool and
serving plane."""

from repro_torch.serving.engine import ServingPlane
from repro_torch.serving.executor import AsyncExecutorPool
from repro_torch.serving.gateway import WindowedGateway
from repro_torch.serving.request import (Request, RequestWindow, Response,
                                         ResponseWindow)

__all__ = ["Request", "Response", "RequestWindow", "ResponseWindow",
           "WindowedGateway", "AsyncExecutorPool", "ServingPlane"]
