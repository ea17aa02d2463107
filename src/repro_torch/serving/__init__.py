"""Serving front door of the port, and SpecPipe-DB (dynamic batching)
with its executors (local, the stage ring's flush and overlapped
schedules, and the async free-running stage actors), arenas and
scheduler."""
from repro_torch.serving.dynbatch import (DBStats, SpecPipeDBEngine,
                                          generate_with_executor)
from repro_torch.serving.engine import Request, Result, ServingEngine
from repro_torch.serving.executor import (AsyncExecutorError,
                                          AsyncPipelineExecutor, Deferred,
                                          LocalFusedExecutor,
                                          OverlappedShardedExecutor,
                                          PipelineExecutor,
                                          ShardedPipelineExecutor)
from repro_torch.serving.scheduler import (DynamicBatchScheduler, KVArena,
                                           PageAllocator, PagedKVArena,
                                           PagePool, SlotPool)

__all__ = ["AsyncExecutorError", "AsyncPipelineExecutor", "DBStats",
           "Deferred", "DynamicBatchScheduler", "KVArena",
           "LocalFusedExecutor",
           "OverlappedShardedExecutor", "PageAllocator", "PagePool",
           "PagedKVArena", "PipelineExecutor", "Request", "Result",
           "ServingEngine", "ShardedPipelineExecutor", "SlotPool",
           "SpecPipeDBEngine", "generate_with_executor"]
