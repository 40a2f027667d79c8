"""Graph layer of the port: the graph container and its arc-list reader,
the approximate adjacency spectral embedding, seed-set local community
detection (host code), the in-core adjacency sketch, its edge-block fold and the
streamed fold on the streaming engine, and the Nyström eigensolve from
the sketch (in core or from one streamed pass)."""

from .ase import ASEParams, approximate_ase
from .community import find_local_cluster, time_dependent_ppr
from .graph import SimpleGraph, read_arc_list
from .stream import (
    adjacency_sketch_fold,
    ase_from_sketch,
    chained_adjacency_sketch,
    graph_block_source,
    incore_adjacency_sketch,
    streamed_adjacency_sketch,
    streaming_ase,
)

__all__ = [
    "SimpleGraph",
    "read_arc_list",
    "ASEParams",
    "approximate_ase",
    "time_dependent_ppr",
    "find_local_cluster",
    "graph_block_source",
    "adjacency_sketch_fold",
    "incore_adjacency_sketch",
    "streamed_adjacency_sketch",
    "chained_adjacency_sketch",
    "ase_from_sketch",
    "streaming_ase",
]
