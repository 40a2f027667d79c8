"""Cross-process collectives of the port (port of
``libskylark_tpu/parallel``).

The JAX package's single communication backend is a ``jax.sharding.Mesh``
with GSPMD shardings and explicit ``shard_map`` schedules; the port's is
a ``torch.distributed`` process group with one rank per card.  This
slice brings what the elastic path needs, :func:`cross_host_psum` and
:class:`CollectiveWatchdog` (``collectives.py``).  The mesh helpers and
the explicit sharded schedules (rowwise/columnwise, dense and sparse,
the 2-D grids, the all-to-all ``sparse_out`` schedules and
``ShardedBCOO``) are ROADMAP Queue A item 9b: their names raise
``UnsupportedError`` naming it.
"""

from ..utils.exceptions import deferred
from .collectives import HEARTBEAT_DIR, CollectiveWatchdog, cross_host_psum

_ITEM9B = "ROADMAP Queue A item 9b: explicit in-process sharded schedules"

ROWS = "rows"
COLS = "cols"
default_mesh = deferred("default_mesh", _ITEM9B)
fully_replicated = deferred("fully_replicated", _ITEM9B)
make_mesh = deferred("make_mesh", _ITEM9B)
replicate = deferred("replicate", _ITEM9B)
shard = deferred("shard", _ITEM9B)
shard_cols = deferred("shard_cols", _ITEM9B)
shard_rows = deferred("shard_rows", _ITEM9B)
shard_rows_padded = deferred("shard_rows_padded", _ITEM9B)
sharding = deferred("sharding", _ITEM9B)
row_sharding = deferred("row_sharding", _ITEM9B)
constrain_rows = deferred("constrain_rows", _ITEM9B)
rowwise_sharded = deferred("rowwise_sharded", _ITEM9B)
batch_sharded_program = deferred("batch_sharded_program", _ITEM9B)
columnwise_batch_sharded = deferred("columnwise_batch_sharded", _ITEM9B)
columnwise_sharded = deferred("columnwise_sharded", _ITEM9B)
rowwise_sharded_sparse = deferred("rowwise_sharded_sparse", _ITEM9B)
columnwise_sharded_sparse = deferred("columnwise_sharded_sparse", _ITEM9B)
columnwise_sharded_sparse_2d = deferred("columnwise_sharded_sparse_2d", _ITEM9B)
columnwise_sharded_sparse_out = deferred("columnwise_sharded_sparse_out", _ITEM9B)
columnwise_sharded_sparse_out_2d = deferred("columnwise_sharded_sparse_out_2d", _ITEM9B)
rowwise_sharded_sparse_out = deferred("rowwise_sharded_sparse_out", _ITEM9B)
suggest_sparse_out_capacity = deferred("suggest_sparse_out_capacity", _ITEM9B)
ShardedBCOO = deferred("ShardedBCOO", _ITEM9B)

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
