"""Serving in torch: the continuous-batching token engine.  Counterpart
of ``repro.serving``; the fit server (``serving/fit.py``) waits for ROADMAP
Queue 1 item 11."""
from repro_torch.serving.engine import FifoEngine, Request, ServeEngine

__all__ = ["FifoEngine", "Request", "ServeEngine"]
