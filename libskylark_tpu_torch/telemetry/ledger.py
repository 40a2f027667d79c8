"""The JSONL run ledger: one machine-readable event stream per process
(port of ``libskylark_tpu/telemetry/ledger.py``, the same schema and
file name, so the two packages' ledgers read alike).

Schema (one object per line, monotonically sequenced within the
process):

    {"ts": <unix seconds>, "seq": <int>, "pid": <int>,
     "kind": <event class>, "name": <event name>, "attrs": {...}}

``seq`` is allocated under the registry's single lock, so the ledger
order is total per process even with concurrent emitters; ``ts`` is
wall clock (informational — ``seq`` is the ordering key).  The file is
``ledger-<pid>.jsonl`` under the configured directory, so multi-process
jobs never interleave writers.

Lifecycle discipline: the sink opens lazily on the FIRST event that has
both telemetry enabled and a directory configured, and only THEN
registers its atexit flush — an import (or a fully disabled run) leaves
the process's atexit table untouched (pinned by
``tests/test_torch_telemetry.py``).  With no directory configured,
events still sequence and count in the registry; nothing is written.
"""

from __future__ import annotations

import atexit
import json
import os
import time

from . import config
from .registry import LOCK

__all__ = ["configure", "event", "emit", "ledger_path", "flush", "close"]

_STATE = {
    "dir": None,       # configure() override; else SKYLARK_TELEMETRY_DIR
    "path": None,
    "fh": None,
    "seq": 0,
    "atexit": False,
}


def configure(directory) -> None:
    """Point the ledger at ``directory`` (overrides
    ``SKYLARK_TELEMETRY_DIR``; ``None`` reverts to the env knob).  An
    already-open sink is closed so the next event reopens in the new
    location."""
    with LOCK:
        _close_locked()
        _STATE["dir"] = str(directory) if directory else None


def ledger_path() -> str | None:
    """Path of the open ledger file (``None`` before the first write)."""
    return _STATE["path"]


def _coerce(obj):
    # numpy scalars and arrays, torch tensors (on any device) → plain
    # JSON values: ``.item()`` for a 0-d value, ``.tolist()`` otherwise.
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "ndim", 1) == 0:
        return item()
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    return str(obj)


def _ensure_open_locked():
    if _STATE["fh"] is not None:
        return _STATE["fh"]
    directory = _STATE["dir"] or config.ledger_dir()
    if not directory:
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ledger-{os.getpid()}.jsonl")
    _STATE["fh"] = open(path, "a", encoding="utf-8")
    _STATE["path"] = path
    if not _STATE["atexit"]:
        # Registered only once a file actually opened: disabled imports
        # must leave the atexit table untouched.
        atexit.register(close)
        _STATE["atexit"] = True
    return _STATE["fh"]


def event(kind: str, name: str, attrs: dict | None = None):
    """Emit one ledger event; returns its ``seq`` (None when disabled).

    Call sites on hot paths should gate on ``telemetry.enabled()``
    themselves so the disabled path never builds the ``attrs`` dict.
    """
    if not config.enabled():
        return None
    rec_attrs = attrs or {}
    with LOCK:
        _STATE["seq"] += 1
        seq = _STATE["seq"]
        fh = _ensure_open_locked()
        if fh is not None:
            fh.write(
                json.dumps(
                    {
                        "ts": round(time.time(), 6),
                        "seq": seq,
                        "pid": os.getpid(),
                        "kind": kind,
                        "name": name,
                        "attrs": rec_attrs,
                    },
                    default=_coerce,
                )
                + "\n"
            )
    return seq


def emit(kind: str, name: str, **attrs):
    """Keyword-flavored :func:`event` for cold call sites."""
    if not config.enabled():
        return None
    return event(kind, name, attrs)


def flush() -> None:
    with LOCK:
        if _STATE["fh"] is not None:
            _STATE["fh"].flush()


def _close_locked() -> None:
    if _STATE["fh"] is not None:
        try:
            _STATE["fh"].flush()
            _STATE["fh"].close()
        except OSError:
            pass  # best-effort: a dead filesystem must not mask the run
        _STATE["fh"] = None
        _STATE["path"] = None


def close() -> None:
    """Flush and close the sink (idempotent; re-opens on the next event)."""
    with LOCK:
        _close_locked()
