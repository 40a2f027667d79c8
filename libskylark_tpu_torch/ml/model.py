"""Model persistence and prediction (port of
``libskylark_tpu/ml/model.py``), in the JAX package's file format.

- ``FeatureMapModel``: a chain of feature maps (rebuilt from their sketch
  JSON through the registry) and a coefficient matrix W; ``predict`` is
  ``concat(maps(X)) @ W``.  Saved as model JSON plus ``<path>.coef.npy``.
- ``KernelModel``: the training X and coefficients A; ``predict`` is
  ``k(X, X_train) @ A``.  Saved as model JSON plus ``<path>.data.npz``.
- ``load_model``: reads the JSON's ``model_type`` and loads through the
  right class.

A model saved by either package loads in the other:
``FeatureMapModel.from_dict(d, W)`` and ``KernelModel.from_arrays`` take
the JAX package's model JSON and numpy arrays.  ``np.save`` writes
bfloat16 (which numpy lacks) as 2-byte void records; the saved dtype
name rides the JSON, and the records are re-viewed as ``int16`` and then
as ``torch.bfloat16``, bit for bit, with no ``ml_dtypes``.  Arrays load
onto ``device`` (the default device when None); a prediction runs where
its input lies, with the coefficients moved there.
"""

from __future__ import annotations

import json
import math
import os
from typing import Sequence

import numpy as np
import torch

from .._device import as_tensor
from ..core.random import _const
from ..parallel import routes
from ..parallel import mesh as pmesh
from ..sketch.base import Dimension
from ..sketch.base import from_dict as sketch_from_dict
from .kernels import from_dict as kernel_from_dict

__all__ = ["FeatureMapModel", "KernelModel", "load_model"]

_SERIAL_VERSION = 2  # tracks sketch.base.SERIAL_VERSION (stream revision)


def _json_info(info):
    """JSON image of a model's ``info`` dict; leaves that are not JSON
    become ``str``."""
    if info is None:
        return None
    return json.loads(json.dumps(info, default=str))


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX/numpy name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy for ``np.save``; bfloat16 as 2-byte void records, as
    ``np.save`` writes it from the JAX package."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, name: str | None, device=None) -> torch.Tensor:
    """A tensor of its own holding ``arr``, with ``np.save``'s erasure of
    bfloat16 undone (``name`` from the JSON): 2-byte void records are
    re-viewed bit for bit, anything else is cast."""
    arr = np.array(arr, copy=True)
    if name == "bfloat16":
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            return as_tensor(arr.view(np.int16), device).view(torch.bfloat16)
        return as_tensor(arr, device).to(torch.bfloat16)
    if name and str(arr.dtype) != name:
        arr = arr.astype(np.dtype(name))
    return as_tensor(arr, device)


def _argmax_labels(O: torch.Tensor, classes):
    idx = torch.argmax(O, dim=-1)
    if classes is None:
        return idx
    return torch.as_tensor(np.asarray(classes), device=O.device)[idx]


class FeatureMapModel:
    """Coefficients W over the concatenated outputs of feature maps.

    ``maps`` may be empty (a linear model on the raw features).
    ``scale_maps`` scales each map's block by √(S_j/d), the reference's
    block scaling."""

    def __init__(self, maps: Sequence, W, scale_maps: bool = False,
                 input_dim=None, classes=None, *, device=None):
        self.maps = list(maps)
        self.W = as_tensor(W, device)
        self.scale_maps = bool(scale_maps)
        self.input_dim = input_dim or (self.maps[0].n if self.maps else None)
        self.classes = None if classes is None else list(np.asarray(classes).tolist())
        self.info = None

    def features(self, X, *, device=None) -> torch.Tensor:
        """Concatenated (n, D) features of X (n, d); a sparse COO X goes
        to the maps as it is.  A sharded X gives row-sharded features,
        each slot's from its own rows."""
        X, _ = routes.operands(X, device=device)
        return routes.rows_map(self._features, X)

    def _features(self, X: torch.Tensor) -> torch.Tensor:
        if not self.maps:
            return X.to_dense() if X.layout == torch.sparse_coo else X
        blocks = []
        for S in self.maps:
            Z = S.apply(X, Dimension.ROWWISE)
            if self.scale_maps:
                Z = Z * _const(math.sqrt(Z.shape[-1] / X.shape[-1]), Z.dtype, Z.device)
            blocks.append(Z)
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)

    def predict(self, X, *, device=None) -> torch.Tensor:
        """(n, k) outputs (decision values or regression predictions);
        row-sharded for a sharded X."""
        Z = self.features(X, device=device)
        return routes.rows_map(lambda z: z @ self.W.to(device=z.device, dtype=z.dtype), Z)

    def predict_labels(self, X, classes=None, *, device=None) -> torch.Tensor:
        return _argmax_labels(pmesh.fully_replicated(self.predict(X, device=device)),
                              classes if classes is not None else self.classes)

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "skylark_object_type": "model",
            "skylark_version": _SERIAL_VERSION,
            "model_type": "feature_map",
            "scale_maps": self.scale_maps,
            "input_dim": self.input_dim,
            "classes": None if self.classes is None else np.asarray(self.classes).tolist(),
            "maps": [S.to_dict() for S in self.maps],
            "coef_shape": list(self.W.shape),
            "coef_dtype": _dtype_name(self.W.dtype),
            "info": _json_info(self.info),
        }

    @classmethod
    def from_dict(cls, d: dict, W, *, device=None) -> "FeatureMapModel":
        """The model of a model JSON dict (either package's) and its
        coefficients (numpy, as ``np.load`` returns them, or a tensor)."""
        if d.get("model_type") != "feature_map":
            raise ValueError(f"not a feature_map model: {d.get('model_type')}")
        if not isinstance(W, torch.Tensor):
            W = _from_numpy(W, d.get("coef_dtype"), device)
        model = cls([sketch_from_dict(md) for md in d["maps"]], W,
                    scale_maps=d.get("scale_maps", False), input_dim=d.get("input_dim"),
                    classes=d.get("classes"), device=device)
        model.info = d.get("info")
        return model

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        np.save(self._coef_path(path), _to_numpy(self.W))

    @classmethod
    def load(cls, path: str, *, device=None) -> "FeatureMapModel":
        with open(path) as f:
            d = json.load(f)
        if d.get("model_type") != "feature_map":
            raise ValueError(f"not a feature_map model: {d.get('model_type')}")
        return cls.from_dict(d, np.load(cls._coef_path(path)), device=device)

    @staticmethod
    def _coef_path(path) -> str:
        return os.fspath(path) + ".coef.npy"


class KernelModel:
    """Kernel-space model: predict = k(X, X_train) @ A."""

    def __init__(self, kernel, X_train, A, classes=None, *, device=None):
        self.kernel = kernel
        self.X_train = as_tensor(X_train, device)
        self.A = as_tensor(A, self.X_train.device)
        self.input_dim = int(self.X_train.shape[1])
        self.info = None
        self.classes = None if classes is None else list(np.asarray(classes).tolist())

    def predict(self, X, *, device=None) -> torch.Tensor:
        """(m, k) outputs; row-sharded for a sharded X (each slot's Gram
        block against the training set)."""
        X, _ = routes.operands(X, device=device)
        return routes.rows_map(self._predict, X)

    def _predict(self, X: torch.Tensor) -> torch.Tensor:
        K = self.kernel.gram(X, self.X_train.to(X.device))  # (m, n)
        dt = torch.promote_types(K.dtype, self.A.dtype)
        return K.to(dt) @ self.A.to(device=K.device, dtype=dt)

    def predict_labels(self, X, classes=None, *, device=None) -> torch.Tensor:
        return _argmax_labels(pmesh.fully_replicated(self.predict(X, device=device)),
                              classes if classes is not None else self.classes)

    def to_dict(self) -> dict:
        return {
            "skylark_object_type": "model",
            "skylark_version": _SERIAL_VERSION,
            "model_type": "kernel",
            "classes": None if self.classes is None else np.asarray(self.classes).tolist(),
            "kernel": self.kernel.to_dict(),
            "data_dtypes": {
                "X_train": _dtype_name(self.X_train.dtype),
                "A": _dtype_name(self.A.dtype),
            },
            "info": _json_info(self.info),
        }

    @classmethod
    def from_arrays(cls, d: dict, X_train, A, *, device=None) -> "KernelModel":
        """The model of a kernel-model JSON dict (either package's) and its
        arrays (numpy, as ``np.load`` returns them, or tensors)."""
        if d.get("model_type") != "kernel":
            raise ValueError(f"not a kernel model: {d.get('model_type')}")
        dtypes = d.get("data_dtypes") or {}
        if not isinstance(X_train, torch.Tensor):
            X_train = _from_numpy(X_train, dtypes.get("X_train"), device)
        if not isinstance(A, torch.Tensor):
            A = _from_numpy(A, dtypes.get("A"), device)
        model = cls(kernel_from_dict(d["kernel"]), X_train, A,
                    classes=d.get("classes"), device=device)
        model.info = d.get("info")
        return model

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        np.savez(os.fspath(path) + ".data.npz", X_train=_to_numpy(self.X_train),
                 A=_to_numpy(self.A))

    @classmethod
    def load(cls, path: str, *, device=None) -> "KernelModel":
        with open(path) as f:
            d = json.load(f)
        if d.get("model_type") != "kernel":
            raise ValueError(f"not a kernel model: {d.get('model_type')}")
        with np.load(os.fspath(path) + ".data.npz") as data:
            return cls.from_arrays(d, data["X_train"], data["A"], device=device)


_MODEL_TYPES = {
    "feature_map": FeatureMapModel,
    "kernel": KernelModel,
}


def load_model(path: str, *, device=None):
    """Load a saved model of either kind (by its JSON's ``model_type``);
    a classification model carries its labels in ``.classes``."""
    with open(path) as f:
        d = json.load(f)
    mtype = d.get("model_type")
    if mtype not in _MODEL_TYPES:
        raise ValueError(
            f"unknown model_type {mtype!r} (expected one of {sorted(_MODEL_TYPES)})")
    return _MODEL_TYPES[mtype].load(path, device=device)
