"""Serving front door of the port."""
from repro_torch.serving.engine import Request, Result, ServingEngine

__all__ = ["Request", "Result", "ServingEngine"]
