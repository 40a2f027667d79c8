"""Checkpoint/resume of solver state (port of
``libskylark_tpu/utils/checkpoint.py``).

Format (version 2), the JAX package's: ONE ``<path>.npz`` holding the
flattened state leaves plus an embedded JSON metadata record — a single
``os.replace`` commits the checkpoint atomically.  The metadata records
the format version, per-leaf CRC32 checksums and per-leaf dtype strings
(npz stores bfloat16 as raw two-byte void records; the recorded dtype
restores it).  Each package reads the other's files leaf for leaf.

State is a nest of dicts, lists and tuples with tensors (or numpy
arrays, or Python numbers) at the leaves, flattened in the JAX
package's pytree order: dict entries by sorted key, sequences in order,
``None`` an empty node.  Leaves load as CPU tensors; given a prototype
(``like=``) each lands on its prototype leaf's device, and a Python
number prototype gets a Python number back.

:class:`CheckpointStore` layers keep-last-N rotation on top, with
fallback to the newest *valid* slot when the newest file is corrupt.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np
import torch

from .exceptions import CheckpointError, StaleEpochError

__all__ = [
    "save_solver_state",
    "load_solver_state",
    "CheckpointStore",
    "FORMAT_VERSION",
    "tree_flatten",
    "tree_unflatten",
    "place_like",
]

FORMAT_VERSION = 2

_LEAF = "*"


def tree_flatten(tree):
    """``(leaves, treedef)`` in the JAX package's pytree order."""
    leaves = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if type(node) in (list, tuple):
            return (type(node).__name__, None, tuple(walk(v) for v in node))
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == _LEAF:
            return next(it)
        kind, keys, children = node
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, vals))
        return list(vals) if kind == "list" else tuple(vals)

    return build(treedef)


def _treedef_str(treedef) -> str:
    """A readable description in the spirit of JAX's ``str(treedef)``
    (recorded, never parsed)."""
    def fmt(node):
        if node is None:
            return "None"
        if node == _LEAF:
            return "*"
        kind, keys, children = node
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(c)}" for k, c in zip(keys, children)) + "}"
        inner = ", ".join(fmt(c) for c in children)
        return f"[{inner}]" if kind == "list" else f"({inner}{',' if len(children) == 1 else ''})"

    return f"PyTreeDef({fmt(treedef)})"


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the file stores: bfloat16 as two-byte void
    records (what numpy writes for the JAX package's bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _leaf_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def _fsync_dir(directory: str) -> None:
    """Flush a directory's entry table (rename durability on POSIX);
    best-effort, as some filesystems refuse a directory fd."""
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_solver_state(path, state, metadata: dict | None = None) -> None:
    """Save ``state`` atomically to ``<path>.npz`` (tmp + fsync + rename +
    directory fsync), so a crash leaves the old slot or the new one whole."""
    leaves, treedef = tree_flatten(state)
    arrays = [_to_numpy(v) for v in leaves]
    meta = {
        "skylark_object_type": "solver_checkpoint",
        "format_version": FORMAT_VERSION,
        "num_leaves": len(arrays),
        "treedef": _treedef_str(treedef),
        "leaf_dtypes": [_dtype_name(v, a) for v, a in zip(leaves, arrays)],
        "leaf_crc32": [zlib.crc32(_leaf_bytes(a)) for a in arrays],
        "metadata": metadata or {},
    }
    tmp = str(path) + ".tmp.npz"
    np.savez(
        tmp,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"leaf_{i}": a for i, a in enumerate(arrays)},
    )
    with open(tmp, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, str(path) + ".npz")
    _fsync_dir(os.path.dirname(str(path)))


def _restore(arr: np.ndarray, name: str | None) -> torch.Tensor:
    """The stored array as a CPU tensor of its recorded dtype."""
    if name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise CheckpointError(f"bfloat16 leaf stored with itemsize {arr.dtype.itemsize}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if name is not None and str(arr.dtype) != name:
        want = np.dtype(name)
        arr = arr.view(want) if arr.dtype.itemsize == want.itemsize else arr.astype(want)
    return torch.from_numpy(np.array(arr))


def place_like(loaded: torch.Tensor, proto):
    """A loaded leaf placed as its prototype leaf lies: on a prototype
    tensor's device, as a Python number for a number, as numpy for
    numpy."""
    if isinstance(proto, torch.Tensor):
        return loaded.to(proto.device)
    if isinstance(proto, (bool, int, float)) and loaded.ndim == 0:
        return type(proto)(loaded.item())
    if isinstance(proto, np.ndarray):
        return loaded.numpy()
    return loaded


def load_solver_state(path, like=None):
    """Returns ``(state, metadata)``.  With ``like`` (a state prototype)
    the leaves are unflattened into its structure, each on its prototype
    leaf's device; otherwise the flat list of CPU tensors is returned.

    Raises :class:`CheckpointError` when the file is not a solver
    checkpoint, leaves are missing, or a CRC32 check fails.
    """
    fname = str(path) + ".npz"
    try:
        with np.load(fname) as data:
            if "__meta__" not in data.files:
                raise CheckpointError(f"{fname}: missing __meta__ record")
            try:
                meta = json.loads(bytes(data["__meta__"]).decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise CheckpointError(f"{fname}: unreadable metadata: {e}")
            if meta.get("skylark_object_type") != "solver_checkpoint":
                raise CheckpointError(
                    f"{fname}: skylark_object_type is "
                    f"{meta.get('skylark_object_type')!r}, expected 'solver_checkpoint'")
            num = meta["num_leaves"]
            present = {k for k in data.files if k.startswith("leaf_")}
            expected = {f"leaf_{i}" for i in range(num)}
            if present != expected:
                raise CheckpointError(f"{fname}: num_leaves={num} but file holds "
                                      f"{sorted(present)}")
            # Read inside the with-block: the npz holds its file open.
            arrays = [data[f"leaf_{i}"] for i in range(num)]
    except (OSError, zlib.error, ValueError, EOFError, KeyError, zipfile.BadZipFile) as e:
        if isinstance(e, CheckpointError):
            raise
        raise CheckpointError(f"{fname}: unreadable container: {e}")

    dtypes = meta.get("leaf_dtypes") or [None] * num
    crcs = meta.get("leaf_crc32")
    leaves = []
    for i, arr in enumerate(arrays):
        if crcs is not None and zlib.crc32(_leaf_bytes(arr)) != crcs[i]:
            raise CheckpointError(f"{fname}: CRC32 mismatch on leaf_{i}")
        leaves.append(_restore(arr, dtypes[i]))

    if like is not None:
        proto, treedef = tree_flatten(like)
        if len(proto) != num:
            raise CheckpointError(f"{fname}: prototype has {len(proto)} leaves, "
                                  f"checkpoint has {num}")
        return tree_unflatten(treedef, [place_like(v, p) for v, p in zip(leaves, proto)]), \
            meta["metadata"]
    return leaves, meta["metadata"]


class CheckpointStore:
    """Keep-last-N rotation of step-indexed checkpoints in one directory.

    Slots are ``<prefix>-<step:012d>.npz``; :meth:`save` commits a new slot
    atomically, then prunes the oldest beyond ``keep_last``.
    :meth:`load_latest` walks slots newest to oldest and returns the first
    that validates, so one corrupt-at-rest file costs at most one round of
    recomputation, not the run.
    """

    def __init__(self, directory, keep_last: int = 3, prefix: str = "ckpt"):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)

    def _slot(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}-{step:012d}")

    def steps(self) -> list[int]:
        """Ascending step indices of the slots on disk."""
        out = []
        pre, suf = self.prefix + "-", ".npz"
        for name in os.listdir(self.directory):
            if name.startswith(pre) and name.endswith(suf):
                try:
                    out.append(int(name[len(pre):-len(suf)]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, state, step: int, metadata: dict | None = None) -> str:
        meta = dict(metadata or {})
        meta["step"] = int(step)
        slot = self._slot(step)
        # The new slot is durable before any old one is unlinked.
        save_solver_state(slot, state, meta)
        for old in self.steps()[: -self.keep_last]:
            try:
                os.remove(self._slot(old) + ".npz")
            except OSError:
                pass  # pruning is best-effort; a leftover slot is harmless
        return slot + ".npz"

    @staticmethod
    def slot_epoch(metadata: dict) -> int:
        """The elastic epoch a slot was written under (0 for slots that
        carry none)."""
        elastic = metadata.get("elastic")
        if isinstance(elastic, dict) and "epoch" in elastic:
            return int(elastic["epoch"])
        return int(metadata.get("epoch", 0))

    def load_latest(self, like=None, expect_epoch: int | None = None):
        """``(state, metadata, step)`` from the newest valid slot, or None
        when there is no slot.  Raises :class:`CheckpointError` only when
        every slot fails validation, and :class:`StaleEpochError` at once
        when ``expect_epoch`` is given and the newest readable slot was
        written under another epoch."""
        steps = self.steps()
        if not steps:
            return None
        errors = []
        for step in reversed(steps):
            try:
                state, meta = load_solver_state(self._slot(step), like=like)
            except CheckpointError as e:
                errors.append(str(e))
                continue
            if expect_epoch is not None:
                have = self.slot_epoch(meta)
                if have != int(expect_epoch):
                    raise StaleEpochError(
                        f"checkpoint slot step {step} in {self.directory} was written at "
                        f"elastic epoch {have}, this resume runs at epoch "
                        f"{int(expect_epoch)}; the slot belongs to a superseded partition",
                        expected=int(expect_epoch), got=have)
            return state, meta, step
        raise CheckpointError(
            f"no valid checkpoint among {len(steps)} slot(s): " + "; ".join(errors))
