"""Telemetry env knobs (port of ``libskylark_tpu/telemetry/config.py``),
read PER CALL (like ``SKYLARK_GUARD`` /
``SKYLARK_NO_PLANS``) so tests and operators can flip them at runtime.

``SKYLARK_TELEMETRY`` gates the whole layer and defaults to OFF: every
entry point short-circuits through :func:`enabled` before touching the
registry or the ledger, so a disabled process pays one dict lookup per
call site and allocates nothing (the ``.lower()`` string copy the other
knobs make is deliberately avoided here — this check sits on per-batch
hot paths).
"""

from __future__ import annotations

import os

__all__ = ["enabled", "ledger_dir"]

_OFF = (None, "", "0", "false", "False", "FALSE", "off", "no")


def enabled() -> bool:
    """True when ``SKYLARK_TELEMETRY`` is set truthy (default: off)."""
    return os.environ.get("SKYLARK_TELEMETRY") not in _OFF


def ledger_dir() -> str | None:
    """Directory for the JSONL run ledger (``SKYLARK_TELEMETRY_DIR`` or
    :func:`~libskylark_tpu.telemetry.configure`); ``None`` means events
    count in the registry but no ledger file is written."""
    return os.environ.get("SKYLARK_TELEMETRY_DIR") or None
