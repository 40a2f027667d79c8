"""Sketching layer of the port: the sketches on the sketch-and-solve
least-squares and sparse-sketch paths and the kernels they run."""

from . import kernels_fut, kernels_scatter, kernels_window
from .base import (
    Dimension,
    SketchTransform,
    create_sketch,
    from_dict,
    from_json,
    register_sketch,
    sketch_registry,
)
from .fjlt import FJLT
from .fut import RFUT, next_pow2, wht
from .hash import CWT, MMT, SJLT, WZT, HashSketch
from .sampling import UST

COLUMNWISE = Dimension.COLUMNWISE
ROWWISE = Dimension.ROWWISE

__all__ = [
    "Dimension",
    "COLUMNWISE",
    "ROWWISE",
    "SketchTransform",
    "create_sketch",
    "from_dict",
    "from_json",
    "register_sketch",
    "sketch_registry",
    "FJLT",
    "RFUT",
    "UST",
    "HashSketch",
    "CWT",
    "MMT",
    "SJLT",
    "WZT",
    "wht",
    "next_pow2",
    "kernels_fut",
    "kernels_scatter",
    "kernels_window",
]
