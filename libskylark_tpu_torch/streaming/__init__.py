"""Out-of-core streaming engine of the port (port of the single-process
part of ``libskylark_tpu/streaming``).

- ``pipeline``: the prefetch thread, pinned host→device copies on a copy
  stream, a bounded queue, and the counters that show the overlap;
- ``overlap``: where the fold waits for the card (chunk boundaries);
- ``engine``: the checkpointable accumulation fold over the
  ``resilient`` runner (resume is bitwise);
- ``drivers``: one-pass ``sketch`` (S·A / A·Ωᵀ), streaming
  sketch-and-solve least squares and the streaming KRR Gram.

The elastic multi-host layer (``ElasticParams``, ``RowPartition``,
``distributed_sketch``, repartition on resume ...) waits for ROADMAP
Queue A item 9; its names raise ``UnsupportedError`` naming it.
"""

from ..utils.exceptions import deferred
from .drivers import kernel_ridge, sketch, sketch_batches, sketch_least_squares
from .engine import StreamParams, as_block_factory, run_stream, skip_batches
from .pipeline import Prefetcher, PrefetchStats, device_placer, pinned_placer

_ITEM9 = "ROADMAP Queue A item 9: multi-device (elastic streaming)"
ElasticParams = deferred("ElasticParams", _ITEM9)
HostLedger = deferred("HostLedger", _ITEM9)
RowPartition = deferred("RowPartition", _ITEM9)
distributed_sketch = deferred("distributed_sketch", _ITEM9)
distributed_sketch_least_squares = deferred("distributed_sketch_least_squares", _ITEM9)
elastic_run_stream = deferred("elastic_run_stream", _ITEM9)
host_dir = deferred("host_dir", _ITEM9)
read_progress = deferred("read_progress", _ITEM9)
world_info = deferred("world_info", _ITEM9)
ResumePlan = deferred("ResumePlan", _ITEM9)
replan_resume = deferred("replan_resume", _ITEM9)
resolve_resume = deferred("resolve_resume", _ITEM9)
execute_rank_plan = deferred("execute_rank_plan", _ITEM9)
read_epoch = deferred("read_epoch", _ITEM9)

__all__ = [
    "sketch",
    "sketch_batches",
    "sketch_least_squares",
    "kernel_ridge",
    "StreamParams",
    "run_stream",
    "as_block_factory",
    "skip_batches",
    "Prefetcher",
    "PrefetchStats",
    "device_placer",
    "pinned_placer",
    "ElasticParams",
    "RowPartition",
    "HostLedger",
    "read_progress",
    "world_info",
    "host_dir",
    "elastic_run_stream",
    "distributed_sketch",
    "distributed_sketch_least_squares",
    "ResumePlan",
    "replan_resume",
    "resolve_resume",
    "execute_rank_plan",
    "read_epoch",
]
