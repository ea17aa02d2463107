"""Serving front door of the port, and SpecPipe-DB (dynamic batching)
with its local executor, arenas and scheduler."""
from repro_torch.serving.dynbatch import (DBStats, SpecPipeDBEngine,
                                          generate_with_executor)
from repro_torch.serving.engine import Request, Result, ServingEngine
from repro_torch.serving.executor import LocalFusedExecutor, PipelineExecutor
from repro_torch.serving.scheduler import (DynamicBatchScheduler, KVArena,
                                           PageAllocator, PagedKVArena,
                                           PagePool, SlotPool)

__all__ = ["DBStats", "DynamicBatchScheduler", "KVArena",
           "LocalFusedExecutor", "PageAllocator", "PagePool",
           "PagedKVArena", "PipelineExecutor", "Request", "Result",
           "ServingEngine", "SlotPool", "SpecPipeDBEngine",
           "generate_with_executor"]
