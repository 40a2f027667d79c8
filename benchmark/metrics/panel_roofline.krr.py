"""The feature map's share of its roofline on one panel: the least time
of a panel's features (the (rows, d)·(d, S) product at the bf16 peak, or
its bytes if longer) over the device time of the map's public apply to
one panel of X with its hoisted operands, by CUDA events."""

import torch

from benchmark import counts


def read(run):
    drv = run.driver
    X = getattr(drv, "X", None)
    if X is None or run.device.type != "cuda":
        return None
    from libskylark_tpu_torch.core.context import SketchContext
    from libskylark_tpu_torch.ml import GaussianKernel
    from libskylark_tpu_torch.sketch.base import Dimension

    fmap = GaussianKernel(drv.d, float(drv.cfg["sigma"])).create_rft(
        drv.s, "regular", SketchContext(seed=run.seed + 1))
    ops = fmap.hoistable_operands(torch.bfloat16, X.device)
    ms = run.device_ms(lambda: fmap.apply_with_operands(ops, X[0], Dimension.ROWWISE), reps=10)
    return 100.0 * counts.rft_panel(drv.rows, drv.d, drv.s).least_s() / (ms * 1e-3)
