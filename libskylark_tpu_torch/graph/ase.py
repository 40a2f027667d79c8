"""Approximate adjacency spectral embedding (ASE), port of
``libskylark_tpu/graph/ase.py``.

≙ ``ApproximateASE`` (``ml/graph/spectral_embedding.hpp:19-94``, Lyzinski
et al): randomized symmetric SVD of the adjacency matrix, embeddings
``X = V·diag(√|λ|)``.  The adjacency is dense (``G.adjacency()``, f64),
a sparse COO (``sparse=True``: ``SimpleGraph.adjacency_coo``, torch's
default dtype) whose products run through ``torch.sparse``, or never
built (``streamed=True``: one pass over edge blocks,
:func:`~.stream.streaming_ase`, folded in torch's default dtype).  It is computed on ``device`` (the card
by default), or where a tensor ``G`` lies.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import as_tensor, resolve_device
from ..core.context import SketchContext
from ..linalg.svd import SVDParams, approximate_symmetric_svd
from .graph import SimpleGraph

__all__ = ["ASEParams", "approximate_ase"]


@dataclass
class ASEParams(SVDParams):
    """≙ ``approximate_ase_params_t`` (the SVD's oversampling and
    iteration knobs).  ``streamed=True`` folds edge blocks of
    ``batch_edges`` undirected edges into ``Ω·A`` in one pass, so it
    requires ``num_iterations == 0``."""

    sparse: bool = False  # use the COO adjacency
    streamed: bool = False  # fold edge blocks; never build A
    batch_edges: int = 65536  # undirected edges per streamed block


def approximate_ase(G, k: int, context: SketchContext, params: ASEParams | None = None, *,
                    device=None):
    """Returns ``(X, lam)``: X (n, k) embeddings, lam the eigenvalues.

    ``G`` is a ``SimpleGraph`` or an (n, n) adjacency (dense or sparse COO
    tensor, or an array).  On the streamed route ``device`` places the
    fold's accumulators; a fold that checkpoints calls
    :func:`~.stream.streaming_ase` with its own ``StreamParams``."""
    params = params or ASEParams()
    if isinstance(G, SimpleGraph) and params.streamed:
        from ..streaming.engine import StreamParams
        from ..streaming.pipeline import pinned_placer
        from .stream import graph_block_source, streaming_ase

        # The fold accumulates in torch's default float, as the JAX
        # package's f64 request follows its x64 mode (f32 without it).
        return streaming_ase(graph_block_source(G, batch_edges=params.batch_edges), G.n, k,
                             context, params, dtype=torch.get_default_dtype(),
                             stream_params=StreamParams(placer=pinned_placer(resolve_device(device))))
    if isinstance(G, SimpleGraph):
        A = G.adjacency_coo(device=device) if params.sparse else as_tensor(G.adjacency(), device)
    else:
        A = as_tensor(G, device)
    V, lam = approximate_symmetric_svd(A, k, context, params)
    return V * torch.sqrt(lam.abs())[None, :], lam
