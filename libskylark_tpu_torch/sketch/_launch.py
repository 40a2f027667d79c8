"""Shared plumbing of the kernel wrappers: argument checks, the ctypes
call on PyTorch's current stream, and the error check after it."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """Load kernel library ``name`` and declare its functions' argument
    types: every pointer and the stream as ``c_void_p`` (a bare Python
    int would be passed as a 32-bit int and cut), every int as
    ``c_int``, ``restype`` the ``cudaError_t`` as an int."""
    lib = _build.load(name)
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


def check(t: torch.Tensor, what: str, *, device, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with
    one of ``dtypes`` and ``ndim`` dimensions."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{what} must lie on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} must have dtype in {dtypes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def run(fn, device: torch.device, *args) -> None:
    """Call C entry ``fn(*args, stream)`` on ``device``'s current stream;
    raise if it reports a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} failed to launch: cudaError_t {err}"
        )


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
