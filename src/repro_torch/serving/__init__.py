"""Serving in torch: the continuous-batching token engine and the
batched, async deCSVM fit server.  Counterpart of ``repro.serving``."""
from repro_torch.serving.engine import FifoEngine, Request, ServeEngine
from repro_torch.serving.fit import (DecsvmFitServer, FitHandle, FitRequest,
                                     FitResult)

__all__ = ["FifoEngine", "Request", "ServeEngine", "DecsvmFitServer",
           "FitHandle", "FitRequest", "FitResult"]
