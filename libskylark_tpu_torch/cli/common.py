"""Shared helpers for the port's CLI drivers (port of
``libskylark_tpu/cli/common.py``).

Beside the JAX package's helpers: ``--device`` and :func:`run_scope`,
which set the port's default device (and, under ``--x64``, torch's
default dtype, and under ``--telemetry``/``--telemetry-dir`` the
telemetry knob and ledger directory) for one run and put them back after
it, and
:func:`to_device`, the host→card copy of what the IO layer read (f32, or
f64 under ``--x64``, as ``jnp.asarray`` gives).  :func:`distributed_scope`
joins the ``torch.distributed`` world of a ``--distributed`` run, and
:func:`shard_input` lays A out for ``--shard``.
"""

from __future__ import annotations

import os
import warnings
from contextlib import contextmanager

import numpy as np
import torch

from .. import _device
from ..utils.sparse import is_sparse

__all__ = [
    "FILE_FORMATS",
    "add_device_args",
    "add_perf_args",
    "add_policy_args",
    "add_telemetry_args",
    "add_distributed_args",
    "distributed_scope",
    "float_dtype",
    "in_run_dtype",
    "load_classes",
    "load_dataset",
    "print_perf_report",
    "print_policy_report",
    "print_telemetry_report",
    "print_test_metrics",
    "add_shard_args",
    "shard_input",
    "run_scope",
    "scan_dims",
    "setup_perf",
    "setup_policy",
    "setup_telemetry",
    "stream_dataset",
    "sync",
    "to_device",
    "to_numpy",
]

def add_device_args(p) -> None:
    """The port's device flag (every driver)."""
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the driver computes: the card (default; a run without "
             "one raises) or the CPU, which takes each kernel's plain "
             "PyTorch version",
    )


@contextmanager
def run_scope(args):
    """Resolve ``--device`` (raising without a card unless it is ``cpu``)
    and make it the port's default device for the run; ``--x64`` makes
    f64 torch's default dtype, as ``jax_enable_x64`` does in the JAX
    package.  Both are put back when the run ends, and so are
    ``SKYLARK_TELEMETRY`` and the ledger directory, which
    :func:`setup_telemetry` sets inside the scope (closing the run's
    ledger), so drivers called in one process do not leak into each
    other or into their caller."""
    from ..telemetry import ledger

    dev = _device.resolve_device(args.device)
    prev_device, prev_dtype = _device._DEFAULT_DEVICE, torch.get_default_dtype()
    prev_knob, prev_dir = os.environ.get("SKYLARK_TELEMETRY"), ledger._STATE["dir"]
    _device.set_default_device(dev)
    if getattr(args, "x64", False):
        torch.set_default_dtype(torch.float64)
    try:
        yield dev
    finally:
        _device._DEFAULT_DEVICE = prev_device
        torch.set_default_dtype(prev_dtype)
        if _telemetry_requested(args):
            if prev_knob is None:
                os.environ.pop("SKYLARK_TELEMETRY", None)
            else:
                os.environ["SKYLARK_TELEMETRY"] = prev_knob
            ledger.configure(prev_dir)


def float_dtype(args) -> torch.dtype:
    return torch.float64 if getattr(args, "x64", False) else torch.float32


def in_run_dtype(batches, args):
    """Host batches ``(X, y)`` (numpy or a COO X, numpy y) as CPU tensors
    in the run's dtype (f32, or f64 under ``--x64``), as the JAX
    package's placer casts them; the stream's placer copies them."""
    dtype = float_dtype(args)
    for X, y in batches:
        X = X if isinstance(X, torch.Tensor) else torch.from_numpy(X)
        yield X.to(dtype), torch.from_numpy(y).to(dtype)


def to_device(X, args, device=None):
    """The host→card copy of a dataset array: numpy or a dense tensor
    becomes a dense tensor, a sparse COO stays one (uncoalesced, its
    entries in order), in f32 (f64 under ``--x64``) on ``device`` (the
    run's default)."""
    dev = _device.resolve_device(device)
    dtype = float_dtype(args)
    if is_sparse(X):
        return X.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(X) if not isinstance(X, torch.Tensor) else X,
                           dtype=dtype, device=dev)


def sync() -> None:
    """Wait for the card (if one is in use) before reading a host clock."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def to_numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor (dense or COO), a sharded value
    (gathered) or an array."""
    from ..parallel import fully_replicated

    x = fully_replicated(x)
    if isinstance(x, torch.Tensor):
        x = x.to_dense() if is_sparse(x) else x
        return x.detach().cpu().numpy()
    return np.asarray(x)


def add_shard_args(p) -> None:
    """``--shard`` (``skylark_linear``, ``skylark_svd``)."""
    p.add_argument("--shard", action="store_true",
                   help="shard the input rows over all visible devices (a mesh of one "
                        "slot per card; rows zero-padded to a multiple of the slots)")


def shard_input(args, A, dev):
    """``(A, n_orig)``: with ``--shard`` a dense A row-sharded over
    ``default_mesh()`` (``shard_rows_padded``: zero rows up to a multiple
    of the slots; ``n_orig`` its true row count), else A and None.  A
    sparse A keeps one device, with the JAX driver's warning."""
    if not args.shard:
        return A, None
    if is_sparse(A):
        print("warning: --shard ignores sparse inputs (BCOO stays on one device)")
        return A, None
    from ..parallel import default_mesh, shard_rows_padded

    return shard_rows_padded(A, default_mesh(device=None if dev.type == "cuda" else dev))


def add_distributed_args(p, *, what: str) -> None:
    """``--distributed`` and its knobs (``skylark_linear``, ``skylark_ml``)."""
    p.add_argument(
        "--distributed", action="store_true",
        help=f"{what} over a torch.distributed world: every rank runs this same command "
             "(launch with torchrun, or set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT); "
             "each folds its own row range and one sum merges; --checkpoint-dir becomes "
             "the shared root of per-rank state")
    p.add_argument(
        "--resume-policy", default="strict", choices=["strict", "repartition"],
        help="with --distributed --resume: 'strict' demands the same world size as the "
             "interrupted run (exit on mismatch, code 109); 'repartition' replans the "
             "root's durable progress onto the new world")
    p.add_argument(
        "--collective-timeout", type=float, default=None, metavar="SECONDS",
        help="with --distributed: deadline for cross-rank collectives (handshake, merge); "
             "a hung or straggling peer raises CollectiveTimeoutError (code 110) naming the "
             "stragglers instead of hanging (default: no deadline, or "
             "SKYLARK_COLLECTIVE_TIMEOUT_S)")


@contextmanager
def distributed_scope(args):
    """Join the ``torch.distributed`` world of a ``--distributed`` run
    from the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    environment (what ``torchrun`` sets), NCCL on the card ``LOCAL_RANK``
    names (else the current one) and gloo on the CPU, and leave it at the
    end.  A group the caller already initialized is used as it is.
    With ``--collective-timeout`` the group's own timeout is four times
    it (at least 60 s), so a rank blocked in a collective past its
    deadline still exits."""
    import datetime

    import torch.distributed as dist

    if not getattr(args, "distributed", False) or dist.is_initialized():
        yield
        return
    backend = "nccl" if args.device == "cuda" else "gloo"
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
    kw = {}
    if args.collective_timeout:
        kw["timeout"] = datetime.timedelta(seconds=max(60.0, 4 * args.collective_timeout))
    dist.init_process_group(backend, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def add_perf_args(p) -> None:
    """The shared compilation/plan observability flags (every driver)."""
    p.add_argument(
        "--xla-cache-dir", default=None,
        help="persistent XLA compilation cache directory (a JAX package "
             "flag: the port has no XLA cache and warns that it is not "
             "applied)",
    )
    p.add_argument(
        "--plan-stats", action="store_true",
        help="print the sketch-plan cache counters "
             "(hits/misses/traces/compile time) on exit",
    )


def setup_perf(args) -> None:
    """--xla-cache-dir takes the JAX package's own "not applied" path: the
    port compiles no XLA executables, so there is no cache to point."""
    if not getattr(args, "xla_cache_dir", None):
        return
    warnings.warn(
        "--xla-cache-dir not applied (the PyTorch port has no XLA "
        "compilation cache); continuing without the persistent "
        "compilation cache",
        RuntimeWarning,
        stacklevel=2,
    )


def print_perf_report(args) -> None:
    """Emit the plan-cache counter block when --plan-stats was given."""
    if not getattr(args, "plan_stats", False):
        return
    from .. import plans

    st = plans.stats()
    print(
        "plan cache: "
        f"{st['hits']} hits / {st['misses']} misses, "
        f"{st['traces']} traces, {st['compiles']} compiles "
        f"({st['compile_seconds']:.3f}s), "
        f"{st['bypasses']} bypasses, "
        f"{st['size']}/{st['max_size']} plans resident"
        + (f", {st['evictions']} evicted" if st["evictions"] else "")
    )


def add_policy_args(p) -> None:
    """The shared adaptive-policy flags (every driver)."""
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "--policy", dest="policy", action="store_true", default=None,
        help="enable the adaptive execution policy (the default; "
             "profile-driven routing/autotuning once --policy-dir or "
             "SKYLARK_POLICY_DIR points at a profile store)",
    )
    g.add_argument(
        "--no-policy", dest="policy", action="store_false",
        help="disable the policy layer (sets SKYLARK_POLICY=0): "
             "default routes, no profile reads or writes, no warm start",
    )
    p.add_argument(
        "--policy-dir", default=None,
        help="profile-store directory (profile-<pid>.json per process); "
             "enables persistent autotuning profiles and warm-start "
             "plan replay across runs",
    )


def setup_policy(args) -> None:
    """Apply the policy flags and warm-start the process (on the run's
    device: call it inside :func:`run_scope`)."""
    from .. import policy

    if getattr(args, "policy", None) is False:
        os.environ["SKYLARK_POLICY"] = "0"
        return
    if getattr(args, "policy", None) is True:
        os.environ["SKYLARK_POLICY"] = "1"
    if getattr(args, "policy_dir", None):
        policy.configure(args.policy_dir)
    ws = policy.warm_start()
    if ws["enabled"] and (ws["plans_replayed"] or ws["xla_cache_dir"]):
        print(
            f"policy warm start: {ws['plans_replayed']} plans replayed "
            f"({ws['plans_skipped']} skipped), "
            f"xla cache {ws['xla_cache_dir'] or 'unset'}, "
            f"{ws['seconds']:.3f}s"
        )


def print_policy_report(args) -> None:
    """Close out a policy run: the decision counters, when any fired
    (they count in the telemetry registry, so with telemetry on)."""
    if getattr(args, "policy", None) is False:
        return
    from .. import telemetry

    counters = telemetry.snapshot()["policy"]
    if counters:
        print(f"policy: {counters}")


def add_telemetry_args(p) -> None:
    """The shared telemetry flags (every driver)."""
    p.add_argument(
        "--telemetry", action="store_true",
        help="enable the telemetry layer (sets SKYLARK_TELEMETRY=1 for the "
             "run): spans + counters in-process, and the JSONL run ledger "
             "when --telemetry-dir is also given",
    )
    p.add_argument(
        "--telemetry-dir", default=None,
        help="directory for the JSONL run ledger "
             "(ledger-<pid>.jsonl; implies --telemetry)",
    )


def _telemetry_requested(args) -> bool:
    return bool(
        getattr(args, "telemetry", False)
        or getattr(args, "telemetry_dir", None)
    )


def setup_telemetry(args) -> None:
    """Apply --telemetry/--telemetry-dir before the solve starts (inside
    :func:`run_scope`, which puts both back when the run ends)."""
    if not _telemetry_requested(args):
        return
    from .. import telemetry

    os.environ["SKYLARK_TELEMETRY"] = "1"
    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir)


def print_telemetry_report(args) -> None:
    """Close out a --telemetry run: one summary line + the ledger path."""
    if not _telemetry_requested(args):
        return
    from .. import telemetry

    snap = telemetry.snapshot()
    hit = snap["plan_cache_hit_rate"]
    overlap = snap["prefetch_overlap"]
    print(
        "telemetry: "
        f"plan-cache hit rate {hit if hit is not None else 'n/a'}, "
        f"prefetch overlap {overlap if overlap is not None else 'n/a'}, "
        f"guard {snap['guard'] or {}}, checkpoint {snap['checkpoint'] or {}}"
    )
    telemetry.flush()
    if telemetry.ledger_path():
        print(f"telemetry ledger -> {telemetry.ledger_path()}")


# ≙ the reference's --fileformat choices (ml/options.hpp:46-47,173-174):
# libsvm covers LIBSVM_DENSE/LIBSVM_SPARSE (the --sparse flag picks the
# container), hdf5_dense/hdf5_sparse name the layout in the file itself
# (ml/io.hpp:869-889).
FILE_FORMATS = ("libsvm", "hdf5_dense", "hdf5_sparse")


def _widen(X, y, n_features):
    """Pad X's feature axis up to ``n_features`` (a test file converted
    from a sparse split can have a smaller max feature index than the
    train file — the libsvm reader pads the same way)."""
    if n_features is None or X.shape[1] >= n_features:
        return X, y
    if is_sparse(X):  # the same triplets, a wider logical shape
        X = torch.sparse_coo_tensor(X._indices(), X._values(),
                                    (X.shape[0], int(n_features)), check_invariants=False)
    else:
        X = np.pad(
            np.asarray(X), ((0, 0), (0, int(n_features) - X.shape[1]))
        )
    return X, y


def load_dataset(path, fileformat: str, sparse: bool, n_features=None):
    """(X, y) under any supported --fileformat.  For hdf5_dense,
    ``sparse`` converts to a COO after the read (matching the libsvm
    --sparse semantics); hdf5_sparse is sparse by construction."""
    from ..io import read_hdf5, read_libsvm

    if fileformat == "libsvm":
        return read_libsvm(path, n_features=n_features, sparse=sparse)
    if fileformat == "hdf5_dense":
        return _widen(*read_hdf5(path, sparse=sparse), n_features)
    if fileformat == "hdf5_sparse":
        return _widen(*read_hdf5(path, sparse=True), n_features)
    raise ValueError(f"unknown fileformat {fileformat!r}; use {FILE_FORMATS}")


def stream_dataset(path, fileformat: str, d: int, batch: int, sparse: bool):
    """Bounded-memory (X_batch, y_batch) iterator under any
    --fileformat (the streaming-predict IO seam)."""
    from ..io import stream_hdf5, stream_libsvm

    if fileformat == "libsvm":
        return stream_libsvm(path, d, batch, sparse=sparse)
    if fileformat == "hdf5_dense":
        return stream_hdf5(path, batch, sparse=sparse)
    if fileformat == "hdf5_sparse":
        return stream_hdf5(path, batch, sparse=True)
    raise ValueError(f"unknown fileformat {fileformat!r}; use {FILE_FORMATS}")


def scan_dims(path, fileformat: str) -> tuple[int, int]:
    """Global ``(n_examples, n_features)`` of a dataset WITHOUT loading
    it — streaming drivers need the shape up front (rows address the
    sketch counter stream).  LIBSVM takes one tokenize-only pass
    (``io.scan_libsvm_dims``); HDF5 reads the stored shape."""
    if fileformat == "libsvm":
        from ..io import scan_libsvm_dims

        return scan_libsvm_dims(path)
    if fileformat in ("hdf5_dense", "hdf5_sparse"):
        from ..utils.deps import require

        h5py = require("h5py")
        with h5py.File(path, "r") as f:
            if "X" in f:
                return int(f["X"].shape[0]), int(f["X"].shape[1])
            d, n, _ = (int(v) for v in f["dimensions"][:])
            return n, d
    raise ValueError(f"unknown fileformat {fileformat!r}; use {FILE_FORMATS}")


def load_classes(modelfile):
    """Read the legacy label-decoding sidecar (pre-round-2 models; the
    coding now rides the model JSON itself — ``ml/model.py``)."""
    try:
        return np.load(str(modelfile) + ".classes.npy")
    except FileNotFoundError:
        return None


def print_test_metrics(model, Xt, yt, regression: bool) -> None:
    """Uniform test-set scoring block for all drivers."""
    if regression or getattr(model, "classes", None) is None:
        pred = to_numpy(model.predict(Xt))
        pred = pred[:, 0] if pred.ndim > 1 else pred
        err = np.linalg.norm(pred - yt) / max(np.linalg.norm(yt), 1e-30)
        print(f"Test relative error: {err:.4f}")
    else:
        pred = to_numpy(model.predict_labels(Xt, model.classes))
        acc = float((pred == yt).mean()) * 100
        print(f"Test accuracy: {acc:.2f}%")
