"""The sketch layer's share of its roofline: the least time of S·A at
the cell's sketch type, size and A (A read once, S·A written once, or
the transform's operations at the f32 peak if longer) over the device
time of the sketch's public apply, by CUDA events."""

from benchmark import counts


def read(run):
    drv = run.driver
    A = getattr(drv, "A", None)
    if A is None or run.device.type != "cuda":
        return None
    from libskylark_tpu_torch.core.context import SketchContext
    from libskylark_tpu_torch.sketch.base import Dimension, create_sketch

    S = create_sketch(drv.stype, drv.m, drv.s, SketchContext(seed=run.seed + 1))
    ms = run.device_ms(lambda: S.apply(A, Dimension.COLUMNWISE), reps=5)
    least = counts.sketch_columnwise(drv.stype, drv.m, drv.n, drv.s, A.element_size()).least_s()
    return 100.0 * least / (ms * 1e-3)
