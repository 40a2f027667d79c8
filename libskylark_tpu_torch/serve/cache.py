"""Versioned, bounded result cache for the serve front door (port of
``libskylark_tpu/serve/cache.py``; host-only: results are host arrays).

Sketching is deterministic — the serialized-sketch interchange the
reference ships (PAPER.md §1) exists precisely because the same seed +
the same rows give the same bits — so a repeated idempotent request
(``cond_est`` dashboard poll, hot PPR seed set, OOS embed of the same
vertices) can be re-served *bitwise* from a dict instead of burning a
device dispatch.  The cache is keyed on

    ``(placement_key, canonical payload digest, registry epoch)``

The epoch component is what makes staleness structurally impossible: a
live-registry mint (edge fold, row append/downdate, model swap) bumps
the entity's epoch, so the very next request computes a DIFFERENT key
and misses — even if the old entry were still resident.  Explicit
:meth:`ResultCache.invalidate` (called from ``Registry._mint``) is
therefore a memory optimisation, not a correctness mechanism: it frees
the retired entity's entries immediately instead of waiting for LRU
pressure.  In-flight batches that admitted pinned to the old epoch are
unaffected either way — they never consult the cache after admission.

Bounding is LRU over entry count AND a byte budget (estimated via
ndarray ``nbytes`` + repr cost for scalars), because a single cached
``ase_embed`` row block can outweigh a thousand cond reports.

Knobs: ``SKYLARK_CACHE`` (``0`` disables), ``SKYLARK_CACHE_MAX_ENTRIES``
(default 1024), ``SKYLARK_CACHE_MAX_BYTES`` (default 64 MiB).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

import numpy as np

from .. import telemetry

__all__ = ["ResultCache", "payload_digest", "payload_crc"]


def _canonical_bytes(obj):
    """Stable byte serialisation of a request payload component.

    ndarrays hash as dtype + shape + raw bytes (bitwise identity, the
    only identity the serve layer promises); tuples/lists recurse with
    framing so ``(1, (2, 3))`` and ``(1, 2, 3)`` differ; everything
    else falls back to ``repr`` (ints, floats, strs, None — all of
    which repr stably).
    """
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        head = "A|%s|%s|" % (arr.dtype.str, arr.shape)
        return head.encode("ascii") + arr.tobytes()
    if isinstance(obj, (tuple, list)):
        parts = [b"T|" if isinstance(obj, tuple) else b"L|"]
        for item in obj:
            b = _canonical_bytes(item)
            parts.append(b"%d:" % len(b))
            parts.append(b)
        return b"".join(parts)
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: repr(kv[0]))
        return _canonical_bytes(("D",) + tuple(x for kv in items for x in kv))
    return ("R|" + repr(obj)).encode("utf-8", "backslashreplace")


def payload_digest(payload):
    """128-bit BLAKE2b digest of the canonical request payload bytes.

    A real cryptographic hash, not a CRC: crc32 is linear over GF(2),
    so ANY equal-length crc32 collision of the canonical bytes also
    collides under every domain-prefixed crc32 of those bytes — doubling
    the CRC widens the word, not the collision resistance, and a
    high-QPS hot set would eventually serve another request's bits.
    BLAKE2b at 16 bytes keeps birthday collisions at ~2^-64 across any
    realistic resident set; the ``person`` tag domain-separates these
    digests from any other BLAKE2b use in the process.
    """
    data = _canonical_bytes(payload)
    h = hashlib.blake2b(data, digest_size=16, person=b"skylark-cache")
    return int.from_bytes(h.digest(), "big")


#: Legacy name (pre-review the digest was a doubled crc32).
payload_crc = payload_digest


def _value_nbytes(value):
    """Best-effort byte estimate of a cached result."""
    if isinstance(value, np.ndarray):
        return int(value.nbytes) + 64
    if isinstance(value, dict):
        return sum(_value_nbytes(v) for v in value.values()) + 64
    if isinstance(value, (tuple, list)):
        return sum(_value_nbytes(v) for v in value) + 64
    return len(repr(value)) + 48


def _copy_in(value):
    """Deep, frozen snapshot of a value entering the cache.

    Containers are rebuilt recursively and ndarrays copied with
    ``writeable=False``, so the producer keeping (and later mutating)
    its own reference — the batcher hands the same decoded result to
    the response envelope — can never alter the stored bits.  The copy
    runs once per *miss*, where a device dispatch just happened; it is
    noise next to the work it memoizes.
    """
    if isinstance(value, np.ndarray):
        arr = value.copy()
        arr.flags.writeable = False
        return arr
    if isinstance(value, dict):
        return {k: _copy_in(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_copy_in(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_copy_in(v) for v in value)
    return value


def _copy_out(value):
    """Caller-safe projection of a cached value.

    Containers (dicts, lists, tuples — including nested PPR cluster /
    member lists) are rebuilt fresh so mutating the returned structure
    cannot poison the cache; ndarrays come back as read-only *views* of
    the frozen stored copy — zero data movement on the hit path, and a
    caller writing into one raises instead of corrupting every future
    hit.
    """
    if isinstance(value, np.ndarray):
        view = value.view()
        view.flags.writeable = False
        return view
    if isinstance(value, dict):
        return {k: _copy_out(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_copy_out(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_copy_out(v) for v in value)
    return value


class ResultCache:
    """Bounded (LRU + byte budget) versioned result cache.

    Thread-safe; shared by the front-door response path, the
    ``cond_report``/``ppr_report`` memoizers, and (via ``stats()`` on
    the load-report plane) the router's placement tie-break.
    """

    def __init__(self, max_entries=None, max_bytes=None, enabled=None):
        if enabled is None:
            enabled = os.environ.get("SKYLARK_CACHE", "1") != "0"
        if max_entries is None:
            max_entries = int(os.environ.get(
                "SKYLARK_CACHE_MAX_ENTRIES", "1024"))
        if max_bytes is None:
            max_bytes = int(os.environ.get(
                "SKYLARK_CACHE_MAX_BYTES", str(64 * 1024 * 1024)))
        self.enabled = bool(enabled)
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        self._d = OrderedDict()          # key -> (value, nbytes, entity)
        self._by_entity = {}             # entity -> set of keys
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    # -- core ---------------------------------------------------------------

    def get(self, key):
        """Return the cached value for ``key`` (LRU-refreshed) or None."""
        if not self.enabled or key is None:
            return None
        with self._lock:
            rec = self._d.get(key)
            if rec is None:
                self.misses += 1
                if telemetry.enabled():
                    telemetry.inc("serve.cache.miss")
                return None
            self._d.move_to_end(key)
            self.hits += 1
        if telemetry.enabled():
            telemetry.inc("serve.cache.hit")
        return _copy_out(rec[0])

    def put(self, key, value, entity=None):
        """Insert ``value`` under ``key``, attributing it to ``entity``
        for targeted invalidation.  Oversized values (> byte budget) are
        refused rather than evicting the whole cache for one entry."""
        if not self.enabled or key is None:
            return
        nb = _value_nbytes(value)
        if nb > self.max_bytes:
            return
        value = _copy_in(value)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                keys = self._by_entity.get(old[2])
                if keys is not None:
                    keys.discard(key)
            self._d[key] = (value, nb, entity)
            self._bytes += nb
            if entity is not None:
                self._by_entity.setdefault(entity, set()).add(key)
            while (len(self._d) > self.max_entries
                   or self._bytes > self.max_bytes):
                self._evict_lru_locked()

    def _evict_lru_locked(self):
        k, (_, nb, entity) = self._d.popitem(last=False)
        self._bytes -= nb
        self.evictions += 1
        keys = self._by_entity.get(entity)
        if keys is not None:
            keys.discard(k)
            if not keys:
                self._by_entity.pop(entity, None)
        if telemetry.enabled():
            telemetry.inc("serve.cache.evictions")

    def invalidate(self, entity):
        """Drop every key attributed to ``entity`` (a registry mint just
        retired its epoch).  Returns the number of entries dropped."""
        if entity is None:
            return 0
        with self._lock:
            keys = self._by_entity.pop(entity, None)
            if not keys:
                return 0
            n = 0
            for k in keys:
                rec = self._d.pop(k, None)
                if rec is not None:
                    self._bytes -= rec[1]
                    n += 1
            self.invalidations += n
        if telemetry.enabled() and n:
            telemetry.inc("serve.cache.invalidations", n)
        return n

    def clear(self):
        with self._lock:
            self._d.clear()
            self._by_entity.clear()
            self._bytes = 0

    # -- introspection ------------------------------------------------------

    def __len__(self):
        with self._lock:
            return len(self._d)

    def key_census(self):
        """placement_key -> cached entry count, for the router's
        fleet-wide hit sharing: a replica that already holds a hot key's
        result wins placement ties so the fleet pays ONE dispatch."""
        census = {}
        with self._lock:
            for (pkey, _crc, _epoch) in self._d:
                census[pkey] = census.get(pkey, 0) + 1
        return census

    def stats(self):
        with self._lock:
            return {
                "enabled": self.enabled,
                "entries": len(self._d),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "keys": self.key_census_locked(),
            }

    def key_census_locked(self):
        census = {}
        for (pkey, _crc, _epoch) in self._d:
            census[pkey] = census.get(pkey, 0) + 1
        return census
