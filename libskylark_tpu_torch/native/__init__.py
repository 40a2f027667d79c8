"""Native C core loader of the port (≙ the reference's ``capi/`` shared
library; port of ``libskylark_tpu/native``).

The port keeps its own copy of the C++ source (``src/skylark_native.cpp``,
the same C code as the JAX package's) and builds it with ``g++ -O3
-shared -fPIC -fopenmp -std=c++17`` at first use into ``build/native/``
beside the package (listed in ``.gitignore``), under a name that carries
a hash of the source and the flags, so an edit rebuilds and a stale
library is never loaded.  The compiler writes to a temporary name in that
directory and the result is moved into place with ``os.replace``, so a
second process building at the same time never loads a half-written
file.  Everything degrades gracefully: ``available()`` is False when no
compiler exists, and the IO layer falls back to its pure-Python parser.

The core computes on host f64 arrays (the C consumers the reference
serves are CPU-side); its counter draws are the port's ``core.random``
stream (integer draws bitwise, transcendental ones to ~1 ulp in f64).
``parse_libsvm_bytes.calls`` counts the LIBSVM texts the native parser
has parsed (``.bytes`` their size, ``.seconds`` the time it took), so a
caller can tell that a read went through it and not through the Python
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np

from ..utils.exceptions import SkylarkError

__all__ = [
    "available",
    "lib",
    "parse_libsvm_bytes",
    "supported_sketch_transforms",
    "kernel_gram",
    "approximate_svd",
    "approximate_least_squares",
    "model_predict",
    "NativeModel",
    "NativeSketch",
    "NativeContext",
]

SRC = Path(__file__).resolve().parent / "src" / "skylark_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libskylark_native-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile the source to ``path`` (through a temporary file in the same
    directory and ``os.replace``); False when there is no working g++."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        # A corrupt or incompatible library under this name: rebuild once,
        # then degrade gracefully.
        if not _build(path):
            return None
        try:
            return ctypes.CDLL(str(path))
        except OSError:
            return None


def lib():
    """The loaded CDLL, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        L = _load()
        if L is None:
            return None
        L.sl_create_context.restype = ctypes.c_void_p
        L.sl_create_context.argtypes = [ctypes.c_uint64]
        L.sl_free_context.argtypes = [ctypes.c_void_p]
        L.sl_context_counter.restype = ctypes.c_uint64
        L.sl_context_counter.argtypes = [ctypes.c_void_p]
        L.sl_create_sketch_transform.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.POINTER(ctypes.c_void_p),
        ]
        L.sl_create_sketch_transform2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_void_p),
        ]
        L.sl_create_sketch_transform_ex.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_void_p),
        ]
        L.sl_free_sketch_transform.argtypes = [ctypes.c_void_p]
        L.sl_apply_sketch_transform.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        L.sl_serialize_sketch_transform.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
        ]
        L.sl_deserialize_sketch_transform.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)
        ]
        L.sl_free_str.argtypes = [ctypes.c_char_p]
        L.sl_supported_sketch_transforms.argtypes = [
            ctypes.POINTER(ctypes.c_char_p)
        ]
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        L.sl_kernel_gram.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            f64, ctypes.c_long, f64, ctypes.c_long, ctypes.c_long, f64,
        ]
        L.sl_approximate_svd.argtypes = [
            ctypes.c_void_p, f64, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_int, f64, f64, f64,
        ]
        L.sl_approximate_least_squares.argtypes = [
            ctypes.c_void_p, f64, f64, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, f64,
        ]
        L.sl_model_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        L.sl_model_predict.argtypes = [
            ctypes.c_char_p, f64, ctypes.c_long, ctypes.c_long, f64,
        ]
        L.sl_model_load.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)
        ]
        L.sl_model_free.argtypes = [ctypes.c_void_p]
        L.sl_model_predict_handle.argtypes = [
            ctypes.c_void_p, f64, ctypes.c_long, ctypes.c_long, f64,
        ]
        L.sl_model_stream_version.restype = ctypes.c_int
        L.sl_model_stream_version.argtypes = [ctypes.c_void_p]
        L.sl_stream_revision.restype = ctypes.c_int
        L.sl_stream_revision.argtypes = []
        L.sl_error_string.restype = ctypes.c_char_p
        L.sl_error_string.argtypes = [ctypes.c_int]
        L.sl_sample.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_long, ctypes.c_int,
            ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        L.sl_libsvm_count.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        L.sl_libsvm_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _lib = L
        return _lib


def available() -> bool:
    return lib() is not None


def supported_sketch_transforms():
    """(type, input, output, direction) tuples the native C API supports
    (≙ ``sl_supported_sketch_transforms``, capi/csketch.cpp:74+)."""
    out = ctypes.c_char_p()
    _check(lib().sl_supported_sketch_transforms(ctypes.byref(out)))
    s = out.value.decode()
    lib().sl_free_str(out)
    return [tuple(line.split()) for line in s.splitlines()]


_KERNEL_CODES = {
    "linear": 0, "gaussian": 1, "polynomial": 2,
    "laplacian": 3, "expsemigroup": 4, "matern": 5,
}


def kernel_gram(kernel: str, X, Y=None, p1=0.0, p2=0.0, p3=0.0):
    """Native kernel Gram K[i, j] = k(X[i], Y[j]) (≙ ``capi/ckernel.cpp``).

    Params by kernel: gaussian/laplacian p1=sigma; polynomial p1=q, p2=c,
    p3=gamma; expsemigroup p1=beta; matern p1=nu (half-integer), p2=l.
    """
    X = np.ascontiguousarray(X, np.float64)
    Y = X if Y is None else np.ascontiguousarray(Y, np.float64)
    if X.ndim != 2 or Y.ndim != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"bad gram shapes {X.shape} vs {Y.shape}")
    # Required scale parameters: a forgotten one would silently produce
    # NaN/zero grams (exp(-d/0)) deep inside downstream solves.
    if kernel not in _KERNEL_CODES:
        raise ValueError(
            f"unknown kernel {kernel!r}; choose from {sorted(_KERNEL_CODES)}"
        )
    if kernel == "polynomial" and not p3 > 0:
        raise ValueError(f"polynomial kernel needs gamma = p3 > 0, got {p3}")
    if kernel in ("gaussian", "laplacian") and not p1 > 0:
        raise ValueError(f"{kernel} kernel needs sigma = p1 > 0, got {p1}")
    if kernel == "expsemigroup" and not p1 > 0:
        raise ValueError(f"expsemigroup kernel needs beta = p1 > 0, got {p1}")
    if kernel == "matern" and (not p1 > 0 or not p2 > 0):
        raise ValueError(
            f"matern kernel needs nu = p1 > 0 and l = p2 > 0, got {p1}, {p2}"
        )
    K = np.empty((X.shape[0], Y.shape[0]), np.float64)
    _check(lib().sl_kernel_gram(
        _KERNEL_CODES[kernel], p1, p2, p3,
        X, X.shape[0], Y, Y.shape[0], X.shape[1], K,
    ))
    return K


def approximate_svd(ctx, A, rank: int, num_iterations: int = 1):
    """Native randomized truncated SVD (≙ ``capi/cnla.cpp``): returns
    (U, S, V) with A ≈ U @ diag(S) @ V.T.  ``ctx`` is a NativeContext."""
    A = np.ascontiguousarray(A, np.float64)
    m, n = A.shape
    k = int(rank)
    U = np.empty((m, k), np.float64)
    S = np.empty((k,), np.float64)
    V = np.empty((n, k), np.float64)
    _check(lib().sl_approximate_svd(
        ctx._h, A, m, n, k, num_iterations, U, S, V
    ))
    return U, S, V


def approximate_least_squares(ctx, A, b, sketch_size: int = 0):
    """Native sketch-and-solve least squares (≙ ``capi/cnla.cpp``):
    argmin_x ||Ax - b|| via a CWT sketch (default size 4n)."""
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if b.ndim != 2 or A.ndim != 2 or b.shape[0] != A.shape[0]:
        raise ValueError(
            f"shape mismatch: A {A.shape} needs b with {A.shape[0]} rows, "
            f"got {b.shape}"
        )
    m, n = A.shape
    t = b.shape[1]
    x = np.empty((n, t), np.float64)
    _check(lib().sl_approximate_least_squares(
        ctx._h, A, b, m, n, t, sketch_size, x
    ))
    return x[:, 0] if squeeze else x


class NativeModel:
    """Load-once handle on a saved ``FeatureMapModel`` for repeated native
    prediction (≙ ``capi/cml.cpp`` + the streaming-predict consumer: the
    reference CLI loads the model once, then predicts per batch)."""

    def __init__(self, path):
        path = os.fspath(path)
        h = ctypes.c_void_p()
        _check(lib().sl_model_load(path.encode(), ctypes.byref(h)))
        self._h = h
        self._free = lib().sl_model_free
        with open(path) as f:
            meta = json.load(f)
        # The native handle parses the version itself (sl_model_stream_
        # version), so pure-C consumers see the same diagnostic signal.
        ver = lib().sl_model_stream_version(self._h)
        if ver < lib().sl_stream_revision():
            warnings.warn(
                f"model serialized under stream revision {ver} "
                f"(current {lib().sl_stream_revision()}): "
                "f32-uniform-derived map values reproduce differently "
                "(docs/counter_contract.md, Stream revisions)",
                stacklevel=2,
            )
        # (D,) coefficients predict to (n,), matching Python's
        # FeatureMapModel.predict broadcasting.  The metadata already
        # carries the dims — no extra native info round-trip needed.
        shape = meta.get("coef_shape", [0, 0])
        self._squeeze = len(shape) == 1
        self.input_dim = meta.get("input_dim")
        self.num_outputs = 1 if self._squeeze else int(shape[1])

    def predict(self, X):
        X = np.ascontiguousarray(X, np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got {X.shape}")
        out = np.empty((X.shape[0], self.num_outputs), np.float64)
        _check(lib().sl_model_predict_handle(
            self._h, X, X.shape[0], X.shape[1], out
        ))
        return out[:, 0] if self._squeeze else out

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)


def model_predict(path, X):
    """One-shot native prediction from a saved ``FeatureMapModel``; for
    repeated batches use :class:`NativeModel` (loads once)."""
    return NativeModel(path).predict(X)


def _check(code: int):
    if code:
        msg = lib().sl_error_string(code).decode()
        raise SkylarkError(f"native error {code}: {msg}")


def parse_libsvm_bytes(data: bytes):
    """(labels, rows, cols, vals, n_features) from LIBSVM text bytes.
    A successful parse adds to ``parse_libsvm_bytes.calls``, ``.bytes``
    and ``.seconds``."""
    t0 = time.perf_counter()
    L = lib()
    n_rows = ctypes.c_long()
    n_nnz = ctypes.c_long()
    max_col = ctypes.c_long()
    _check(L.sl_libsvm_count(data, len(data), ctypes.byref(n_rows),
                             ctypes.byref(n_nnz), ctypes.byref(max_col)))
    labels = np.empty(n_rows.value, np.float64)
    rows = np.empty(n_nnz.value, np.int64)
    cols = np.empty(n_nnz.value, np.int64)
    vals = np.empty(n_nnz.value, np.float64)
    _check(L.sl_libsvm_parse(data, len(data), labels, rows, cols, vals))
    parse_libsvm_bytes.calls += 1
    parse_libsvm_bytes.bytes += len(data)
    parse_libsvm_bytes.seconds += time.perf_counter() - t0
    return labels, rows, cols, vals, int(max_col.value)


parse_libsvm_bytes.calls = 0
parse_libsvm_bytes.bytes = 0
parse_libsvm_bytes.seconds = 0.0


class NativeContext:
    """≙ ``sl_create_context`` handle."""

    def __init__(self, seed: int):
        L = lib()
        self._h = L.sl_create_context(seed)
        # Cache the free function: module globals may already be cleared
        # when __del__ runs at interpreter shutdown.
        self._free = L.sl_free_context

    @property
    def counter(self) -> int:
        return int(lib().sl_context_counter(self._h))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)


class NativeSketch:
    """≙ ``sl_create_sketch_transform`` + apply/serialize handles."""

    def __init__(self, handle, n, s):
        self._h = handle
        self.n, self.s = n, s
        self._free = lib().sl_free_sketch_transform

    @classmethod
    def create(cls, ctx: NativeContext, sketch_type: str, n: int, s: int,
               param: float = 0.0, param2: float = 0.0, param3: float = 0.0):
        out = ctypes.c_void_p()
        _check(lib().sl_create_sketch_transform_ex(
            ctx._h, sketch_type.encode(), n, s, param, param2, param3,
            ctypes.byref(out)))
        return cls(out, n, s)

    @classmethod
    def from_json(cls, js: str):
        out = ctypes.c_void_p()
        _check(lib().sl_deserialize_sketch_transform(js.encode(), ctypes.byref(out)))
        d = json.loads(js)
        return cls(out, int(d["N"]), int(d["S"]))

    def apply(self, A: np.ndarray, dim: str = "columnwise") -> np.ndarray:
        A = np.ascontiguousarray(A, np.float64)
        cw = dim == "columnwise"
        if cw:
            out = np.empty((self.s, A.shape[1]), np.float64)
        else:
            out = np.empty((A.shape[0], self.s), np.float64)
        _check(lib().sl_apply_sketch_transform(
            self._h, A, A.shape[0], A.shape[1], 0 if cw else 1, out))
        return out

    def to_json(self) -> str:
        out = ctypes.c_char_p()
        _check(lib().sl_serialize_sketch_transform(self._h, ctypes.byref(out)))
        s = out.value.decode()
        lib().sl_free_str(out)
        return s

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)
