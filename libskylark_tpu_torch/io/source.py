"""Byte-stream sources: the remote-filesystem seam of the IO layer (port
of ``libskylark_tpu/io/source.py``).

≙ the reference's HDFS variants of the LIBSVM readers
(``utility/io/libsvm_io.hpp:1495-1638``: the same parse loop over an
``hdfsFS`` handle instead of an ``ifstream``).  Every reader that
consumes bytes (``read_libsvm`` / ``stream_libsvm`` / the arc-list
readers) accepts a *source* — anything with ``open() -> binary
file-like`` — and a URL-scheme registry picks the backend, so remote
stores plug in without touching the parsers.

Built-in backends:

- ``LocalSource`` — plain paths and ``file://`` URLs.
- ``MemorySource`` — in-memory bytes (tests, generated data).
- ``FsspecSource`` — any scheme fsspec knows (``memory://``, ``hdfs://``,
  ``s3://``, ``gs://`` …) when the optional ``fsspec`` package is
  importable (schemes whose extra backend deps are missing raise their
  own clear errors at ``open()``).

``register_scheme`` lets applications add their own backends.
"""

from __future__ import annotations

import io
import os
import random
import time
from typing import Callable

__all__ = [
    "ByteSource",
    "LocalSource",
    "MemorySource",
    "FsspecSource",
    "open_source",
    "register_scheme",
]


class ByteSource:
    """Interface: a named, re-openable stream of bytes."""

    name: str = "<bytes>"

    def open(self):  # -> binary file-like (context manager)
        raise NotImplementedError

    def size(self) -> int | None:
        """Total bytes if cheaply known, else None (streaming-only)."""
        return None


class LocalSource(ByteSource):
    def __init__(self, path):
        self.path = os.fspath(path)
        self.name = self.path

    def open(self):
        return open(self.path, "rb")

    def size(self):
        return os.path.getsize(self.path)


class MemorySource(ByteSource):
    def __init__(self, data: bytes, name: str = "<memory>"):
        self._data = bytes(data)
        self.name = name

    def open(self):
        return io.BytesIO(self._data)

    def size(self):
        return len(self._data)


class FsspecSource(ByteSource):
    """Remote store via fsspec (covers the reference's HDFS role).

    Instantiating raises ImportError with a pointer when fsspec is not
    installed; schemes fsspec knows but whose backend deps are absent
    (e.g. hdfs without a JVM) raise their own error at ``open()``.

    ``open()`` retries transient ``OSError``/``IOError`` with jittered
    exponential backoff (``retries`` extra attempts after the first) —
    a flaky remote store must not kill a multi-hour stream over one
    dropped connection.  Non-OSError failures (missing backend deps,
    auth errors) propagate immediately.  Retries are counted in the
    telemetry registry (``io.open_retries``) with one ledger event per
    retried attempt.
    """

    def __init__(self, url: str, *, retries: int = 3, backoff: float = 0.2):
        from ..utils.deps import require

        self._fsspec = require("fsspec")
        self.url = url
        self.name = url
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._sleep = time.sleep  # injectable: tests skip the real wait
        self._jitter = random.random  # likewise

    def open(self):
        from .. import telemetry

        attempt = 0
        while True:
            try:
                return self._fsspec.open(self.url, "rb").open()
            except OSError as e:
                if attempt >= self.retries:
                    raise
                # Full jitter on the exponential step: concurrent hosts
                # re-opening the same store must not thunder in lockstep.
                delay = self.backoff * (2**attempt) * (0.5 + self._jitter())
                if telemetry.enabled():
                    telemetry.inc("io.open_retries")
                    telemetry.event("io", "open_retry", {
                        "url": self.url, "attempt": attempt, "delay": round(delay, 4),
                        "error": f"{type(e).__name__}: {e}"[:200]})
                self._sleep(delay)
                attempt += 1


_SCHEMES: dict[str, Callable[[str], ByteSource]] = {}


def register_scheme(scheme: str, factory: Callable[[str], ByteSource]):
    """Route ``scheme://...`` URLs to ``factory(url)``."""
    _SCHEMES[scheme.lower()] = factory


def open_source(src) -> ByteSource:
    """Coerce a path / URL / bytes / ByteSource to a ByteSource.

    - ByteSource: returned as-is
    - bytes: MemorySource
    - ``file://`` URL or plain path: LocalSource
    - ``scheme://`` URL: registered factory, else FsspecSource
    """
    if isinstance(src, ByteSource):
        return src
    if isinstance(src, (bytes, bytearray)):
        return MemorySource(bytes(src))
    path = os.fspath(src)
    if "://" in path:
        scheme, rest = path.split("://", 1)
        scheme = scheme.lower()
        if scheme == "file":
            return LocalSource(rest)
        if scheme in _SCHEMES:
            return _SCHEMES[scheme](path)
        return FsspecSource(path)
    return LocalSource(path)


def _lines_of(f, chunk_bytes: int):
    """Byte blocks of complete lines from the binary file ``f``, read
    ``chunk_bytes`` at a time: a line split across two reads is re-joined
    (the torn tail is carried), and a final line without a newline is
    still delivered.  The last block may be empty."""
    carry = b""
    eof = False
    while not eof:
        data = f.read(chunk_bytes)
        eof = not data
        block = carry + data
        carry = b""
        if not eof:
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            carry, block = block[cut + 1:], block[: cut + 1]
        yield block
