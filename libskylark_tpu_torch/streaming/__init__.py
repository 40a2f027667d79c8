"""Out-of-core streaming engine of the port (port of the single-process
part of ``libskylark_tpu/streaming``).

- ``pipeline``: the prefetch thread, pinned host→device copies on a copy
  stream, a bounded queue, and the counters that show the overlap;
- ``overlap``: where the fold waits for the card (chunk boundaries);
- ``engine``: the checkpointable accumulation fold over the
  ``resilient`` runner (resume is bitwise);
- ``drivers``: one-pass ``sketch`` (S·A / A·Ωᵀ), streaming
  sketch-and-solve least squares and the streaming KRR Gram;
- ``elastic``: the multi-process layer over a ``torch.distributed``
  world: ``RowPartition``, ``ElasticParams``, per-rank host state
  (manifest, progress ledger), the handshake, ``distributed_sketch``
  and ``distributed_sketch_least_squares``;
- ``repartition``: resume under another world size by adopting the
  durable partials of the old one (epochs, plans, fencing).
"""

from .drivers import kernel_ridge, sketch, sketch_batches, sketch_least_squares
from .elastic import (ElasticParams, HostLedger, RowPartition, distributed_sketch,
                      distributed_sketch_least_squares, elastic_run_stream, host_dir,
                      read_progress, world_info)
from .engine import StreamParams, as_block_factory, run_stream, skip_batches
from .pipeline import Prefetcher, PrefetchStats, device_placer, pinned_placer
from .repartition import (ResumePlan, execute_rank_plan, read_epoch, replan_resume,
                          resolve_resume)

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
