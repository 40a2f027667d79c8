"""Records the calls of the program's kernel wrappers with their shapes,
while a traced stretch runs.

Each wrapper in ``sketch.kernels_*`` is replaced by a stand-in that
notes the shapes ``counts.KERNELS`` prices and calls through; its launch
counters (``launches``, ``launches_by_nb``) stay the wrapper's own.  A
call made while a CUDA graph is captured is recorded too; the program's
launch counters say how many launches ran.
"""

from __future__ import annotations

import importlib

WRAPPERS = (("kernels_window", "gather_scaled_rows"), ("kernels_window", "scatter_rows"),
            ("kernels_fut", "rfut_rowwise"), ("kernels_fut", "rfut_rowwise_sampled"),
            ("kernels_scatter", "segment_sum_flat"))


def _shape(t):
    return tuple(int(d) for d in t.shape)


def describe(name: str, args: tuple, kwargs: dict) -> dict:
    """The shapes of one wrapper call that ``counts.KERNELS`` reads."""
    if name == "gather_scaled_rows":
        T, idx = args[0], args[1]
        return {"T": _shape(T), "idx": _shape(idx), "itemsize": T.element_size()}
    if name == "scatter_rows":
        A, b = args[0], args[1]
        return {"A": _shape(A), "nnz": 1 if b.ndim == 1 else int(b.shape[0]),
                "num_segments": int(args[3]), "itemsize": A.element_size()}
    if name in ("rfut_rowwise", "rfut_rowwise_sampled"):
        x = args[0]
        call = {"x": _shape(x), "nb": int(args[2]), "itemsize": x.element_size()}
        if name == "rfut_rowwise_sampled":
            call["idx"] = _shape(args[3])
        return call
    if name == "segment_sum_flat":
        vals = args[0]
        return {"vals": _shape(vals), "num_segments": int(args[2]),
                "itemsize": vals.element_size()}
    raise KeyError(name)


class _StandIn:
    def __init__(self, fn, name, calls):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *args, **kwargs):
        call = describe(self._name, args, kwargs)
        call["kernel"] = self._name
        self._calls.append(call)
        return self._fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._fn, attr)

    def __setattr__(self, attr, value):
        setattr(self._fn, attr, value)


class Recorder:
    """Context manager: ``calls`` lists the wrapper calls made inside."""

    def __init__(self):
        self.calls: list[dict] = []
        self._saved = []

    def __enter__(self):
        for mod_name, name in WRAPPERS:
            mod = importlib.import_module(f"libskylark_tpu_torch.sketch.{mod_name}")
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, _StandIn(fn, name, self.calls))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()
        return False
