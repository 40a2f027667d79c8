"""Machine-learning layer of the port (≙ reference ``ml/``): kernels,
the KRR/RLSC solver families, the BlockADMM kernel-machine trainer,
the nonlinear estimators, label coding and model persistence.

The streaming KRR solvers (``streaming_kernel_ridge``,
``streaming_approximate_kernel_ridge``) ride the ``streaming`` layer.
Not ported yet: ``ml/distributed.py`` (ROADMAP Queue A item 9).
"""

from .admm import ADMMParams, BlockADMMSolver
from .coding import decode_labels, dummy_coding
from .distances import (
    euclidean_distance_matrix,
    expsemigroup_distance_matrix,
    l1_distance_matrix,
)
from .kernels import (
    ExpSemigroupKernel,
    GaussianKernel,
    Kernel,
    LaplacianKernel,
    LinearKernel,
    MaternKernel,
    PolynomialKernel,
    kernel_by_name,
)
from .krr import (
    KrrParams,
    approximate_kernel_ridge,
    faster_kernel_ridge,
    kernel_ridge,
    large_scale_kernel_ridge,
    sketched_approximate_kernel_ridge,
    streaming_approximate_kernel_ridge,
    streaming_kernel_ridge,
)
from .metrics import classification_accuracy, mean_squared_error
from .model import FeatureMapModel, KernelModel, load_model
from .nonlinear import RLS, NystromRLS, SketchPCR, SketchRLS
from .rlsc import (
    approximate_kernel_rlsc,
    faster_kernel_rlsc,
    kernel_rlsc,
    sketched_approximate_kernel_rlsc,
)

__all__ = [
    "Kernel",
    "LinearKernel",
    "GaussianKernel",
    "PolynomialKernel",
    "LaplacianKernel",
    "ExpSemigroupKernel",
    "MaternKernel",
    "kernel_by_name",
    "KrrParams",
    "kernel_ridge",
    "approximate_kernel_ridge",
    "sketched_approximate_kernel_ridge",
    "faster_kernel_ridge",
    "large_scale_kernel_ridge",
    "streaming_kernel_ridge",
    "streaming_approximate_kernel_ridge",
    "kernel_rlsc",
    "approximate_kernel_rlsc",
    "sketched_approximate_kernel_rlsc",
    "faster_kernel_rlsc",
    "dummy_coding",
    "decode_labels",
    "euclidean_distance_matrix",
    "l1_distance_matrix",
    "expsemigroup_distance_matrix",
    "classification_accuracy",
    "mean_squared_error",
    "RLS",
    "SketchRLS",
    "NystromRLS",
    "SketchPCR",
    "ADMMParams",
    "BlockADMMSolver",
    "FeatureMapModel",
    "KernelModel",
    "load_model",
]
