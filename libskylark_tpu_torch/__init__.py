"""libskylark_tpu_torch — the PyTorch/CUDA port of libskylark_tpu.

A second package beside the JAX one: the same counter stream, the same
~100-byte sketch JSON and the same public names, with every Pallas
kernel on the ported path replaced by a CUDA C++ kernel for Hopper
(``csrc/``, built by ``_build`` at first use).  Entry points run on the
card unless the caller asks for the CPU (``device="cpu"``, CPU tensors,
or :func:`set_default_device`); CPU tensors take the kernels' plain
PyTorch versions.  Ported so far: sketch-and-solve least squares with
FJLT and the hash sketches on dense input; the hash sketches on
sparse COO input, dense or sparse output, and the in-core graph
adjacency sketch with its Nyström eigensolve (``graph``).  Sparse
matrices are ``torch.sparse_coo_tensor``s
(``utils.coo_from_bcoo_arrays`` builds one from a BCOO's arrays).
"""

from ._device import set_default_device
from . import core, graph, linalg, sketch, utils
from .core.context import SketchContext

__version__ = "0.1.0"

__all__ = ["SketchContext", "sketch", "linalg", "graph", "core", "utils",
           "set_default_device"]
