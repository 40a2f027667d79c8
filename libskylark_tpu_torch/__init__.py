"""libskylark_tpu_torch — the PyTorch/CUDA port of libskylark_tpu.

A second package beside the JAX one: the same counter stream, the same
~100-byte sketch JSON and the same public names, with every Pallas
kernel on the ported path replaced by a CUDA C++ kernel for Hopper
(``csrc/``, built by ``_build`` at first use).  Entry points run on the
card unless the caller asks for the CPU (``device="cpu"``, CPU tensors,
or :func:`set_default_device`); CPU tensors take the kernels' plain
PyTorch versions.  Ported so far: sketch-and-solve least squares with
FJLT and the hash sketches on dense input, guarded by the numerical-
health layer (``guard``); the randomized NLA layer (``linalg``,
``solvers``: Blendenpik and LSRN over the Krylov solvers, the
randomized SVD, condition estimation, the regression dispatch); the
hash sketches on
sparse COO input, dense or sparse output, and the in-core graph
adjacency sketch with its Nyström eigensolve (``graph``); and the
predict path of the random-feature kernel machine (``ml``: the six
kernels, the RFT/Fastfood/RLT/PPT feature maps and the dense sketches,
``FeatureMapModel``/``KernelModel`` in the JAX package's file format,
and the flagship forward step, ``flagship.entry``); and its in-core
training path (``ml``: KRR's five strategies and RLSC, the BlockADMM
trainer over the loss/regularizer prox library ``solvers.prox``, and
the RLS, SketchRLS, NystromRLS and SketchPCR estimators).  Sparse
matrices are ``torch.sparse_coo_tensor``s
(``utils.coo_from_bcoo_arrays`` builds one from a BCOO's arrays).
Out of core (``streaming``): the sketches' slice protocol folded over
batch sources by a checkpointable engine on the resilient runner
(``resilient``, ``utils.checkpoint``), with pinned, prefetched
host→device copies; streaming least squares, KRR (the
feature-and-example-streamed north star), the randomized SVD and the
graph sketch ride it.
"""

from ._device import set_default_device
from . import (core, flagship, graph, guard, linalg, ml, resilient, sketch, solvers, streaming,
               utils)
from .core.context import SketchContext

__version__ = "0.1.0"

__all__ = ["SketchContext", "sketch", "linalg", "solvers", "guard", "resilient", "graph",
           "ml", "flagship", "core", "utils", "streaming", "set_default_device"]
