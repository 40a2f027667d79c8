"""Graph layer of the port: the graph container, the in-core adjacency
sketch and its edge-block fold, and the Nyström eigensolve from the
sketch."""

from .graph import SimpleGraph
from .stream import (
    adjacency_sketch_fold,
    ase_from_sketch,
    graph_block_source,
    incore_adjacency_sketch,
)

__all__ = [
    "SimpleGraph",
    "graph_block_source",
    "adjacency_sketch_fold",
    "incore_adjacency_sketch",
    "ase_from_sketch",
]
