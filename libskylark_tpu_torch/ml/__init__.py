"""Machine-learning layer of the port: kernels, distances, label coding,
metrics and the predict path of the random-feature and kernel models
(training waits for a later slice, ROADMAP Queue A)."""

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
from .metrics import classification_accuracy, mean_squared_error
from .model import FeatureMapModel, KernelModel, load_model

__all__ = [
    "Kernel",
    "LinearKernel",
    "GaussianKernel",
    "PolynomialKernel",
    "LaplacianKernel",
    "ExpSemigroupKernel",
    "MaternKernel",
    "kernel_by_name",
    "dummy_coding",
    "decode_labels",
    "euclidean_distance_matrix",
    "l1_distance_matrix",
    "expsemigroup_distance_matrix",
    "classification_accuracy",
    "mean_squared_error",
    "FeatureMapModel",
    "KernelModel",
    "load_model",
]
