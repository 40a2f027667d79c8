"""Meshes, sharded values and collectives of the port (port of
``libskylark_tpu/parallel``).

The JAX package's single communication backend is a ``jax.sharding.Mesh``
with GSPMD shardings and explicit ``shard_map`` schedules.  The port has
two layers in its place:

- in one process, a :class:`~.mesh.Mesh` of slots, each bound to a
  ``torch.device`` (several slots may share one), the :class:`~.mesh.Sharded`
  container and three in-process collectives (``mesh.py``), under the
  explicit sharded schedules of ``collectives.py``: rowwise and
  columnwise, dense and sparse, the 2-D grids, the all-to-all
  ``sparse_out`` schedules and ``ShardedBCOO``;
- across processes, a ``torch.distributed`` process group with one rank
  per card: :func:`cross_host_psum` and :class:`CollectiveWatchdog`, the
  merge of the elastic path.

What JAX leaves to GSPMD (any jitted code given a sharded array: the
CLI's ``--shard``, the sharded-input sketches, solvers, SVD, KRR, ADMM
and predict, the serve layer's sharded programs) runs on a third:
``routes.py``, one row-sharded schedule the entry points share (the
input resharded once to rows, the tall work per slot, the small
replicated matrices psum'd in slot order; a mesh of one is the
unsharded call).
"""

from .collectives import (
    HEARTBEAT_DIR,
    CollectiveWatchdog,
    ShardedBCOO,
    batch_sharded_program,
    columnwise_batch_sharded,
    columnwise_sharded,
    columnwise_sharded_sparse,
    columnwise_sharded_sparse_2d,
    columnwise_sharded_sparse_out,
    columnwise_sharded_sparse_out_2d,
    cross_host_psum,
    rowwise_sharded,
    rowwise_sharded_sparse,
    rowwise_sharded_sparse_out,
    suggest_sparse_out_capacity,
)
from .mesh import (
    COLS,
    ROWS,
    constrain_rows,
    default_mesh,
    fully_replicated,
    make_mesh,
    replicate,
    row_sharding,
    shard,
    shard_cols,
    shard_rows,
    shard_rows_padded,
    sharding,
)

__all__ = [
    "ROWS",
    "COLS",
    "default_mesh",
    "fully_replicated",
    "make_mesh",
    "replicate",
    "shard",
    "shard_cols",
    "shard_rows",
    "shard_rows_padded",
    "sharding",
    "row_sharding",
    "constrain_rows",
    "cross_host_psum",
    "CollectiveWatchdog",
    "HEARTBEAT_DIR",
    "rowwise_sharded",
    "batch_sharded_program",
    "columnwise_batch_sharded",
    "columnwise_sharded",
    "rowwise_sharded_sparse",
    "columnwise_sharded_sparse",
    "columnwise_sharded_sparse_2d",
    "columnwise_sharded_sparse_out",
    "columnwise_sharded_sparse_out_2d",
    "rowwise_sharded_sparse_out",
    "suggest_sparse_out_capacity",
    "ShardedBCOO",
]
