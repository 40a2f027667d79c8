"""Sketching layer of the port: the sketches on the sketch-and-solve
least-squares, sparse-sketch and random-feature paths and the kernels
they run."""

from . import kernels_fut, kernels_scatter, kernels_window
from .base import (
    Dimension,
    SketchTransform,
    create_sketch,
    deserialize_sketch,
    from_dict,
    from_json,
    register_sketch,
    sketch_registry,
)
from .dense import CT, JLT, DenseSketch
from .fjlt import FJLT
from .frft import FastGaussianRFT, FastMaternRFT, FastRFT
from .fut import RFUT, dct, next_pow2, wht
from .hash import CWT, MMT, SJLT, WZT, HashSketch
from .ppt import PPT
from .quasi import QJLT
from .rft import RFT, GaussianQRFT, GaussianRFT, LaplacianQRFT, LaplacianRFT, MaternRFT
from .rlt import ExpSemigroupQRLT, ExpSemigroupRLT
from .sampling import NURST, UST

COLUMNWISE = Dimension.COLUMNWISE
ROWWISE = Dimension.ROWWISE

# ≙ python-skylark's SUPPORTED_SKETCH_TRANSFORMS, as the JAX package
# defines it: one (type, "Matrix", "Matrix") entry per registered sketch.
SUPPORTED_SKETCH_TRANSFORMS = [
    (T, "Matrix", "Matrix") for T in sorted(sketch_registry())
]

__all__ = [
    "Dimension",
    "COLUMNWISE",
    "ROWWISE",
    "SketchTransform",
    "create_sketch",
    "deserialize_sketch",
    "SUPPORTED_SKETCH_TRANSFORMS",
    "from_dict",
    "from_json",
    "register_sketch",
    "sketch_registry",
    "DenseSketch",
    "JLT",
    "QJLT",
    "CT",
    "FJLT",
    "RFUT",
    "UST",
    "NURST",
    "HashSketch",
    "CWT",
    "MMT",
    "SJLT",
    "WZT",
    "RFT",
    "GaussianRFT",
    "LaplacianRFT",
    "MaternRFT",
    "GaussianQRFT",
    "LaplacianQRFT",
    "FastRFT",
    "FastGaussianRFT",
    "FastMaternRFT",
    "ExpSemigroupRLT",
    "ExpSemigroupQRLT",
    "PPT",
    "wht",
    "dct",
    "next_pow2",
    "kernels_fut",
    "kernels_scatter",
    "kernels_window",
]
