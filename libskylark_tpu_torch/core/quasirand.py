"""Quasi-random (QMC) sequences with O(1) random access (port of
``libskylark_tpu/core/quasirand.py``).

A leaped Halton sequence: ``coordinate(idx, dim)`` is the radical
inverse of ``idx * leap`` in the ``dim``-th prime base, a pure function
of its arguments, so any window of the sequence is computed on its own.

Indices are int64 and the float pipeline is f64 on every device: what
the JAX package computes under x64 and what the reference computes in
double.  The digit loop keeps the JAX order of operations (``m = m / b;
r = r + m·digit; res = res // b``) as separate rounded operations, with
no fused multiply-add, the same on the card and the CPU.  XLA's CPU
compile contracts ``r + m·digit`` into one, so the JAX package's values
sit within 1 ulp of f64 of these.  Past a base's last nonzero digit an iteration adds exactly 0.0, so a
shorter loop is bitwise the 41-digit one; :func:`halton_block` groups
the columns into digit tiers and runs each tier's loop only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..utils.exceptions import InvalidParameters

__all__ = ["primes", "radical_inverse", "LeapedHaltonSequence"]

_MAX_DIGITS = 41  # 41 digits of base >= 2 exhaust any 41-bit index
_TIERS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 41)


@lru_cache(maxsize=64)
def primes(n: int) -> np.ndarray:
    """First n primes (a numpy sieve)."""
    if n <= 0:
        return np.array([], dtype=np.int64)
    limit = max(15, int(n * (np.log(n + 2) + np.log(np.log(n + 3))) * 1.2) + 10)
    while True:
        sieve = np.ones(limit, dtype=bool)
        sieve[:2] = False
        for p in range(2, int(limit**0.5) + 1):
            if sieve[p]:
                sieve[p * p :: p] = False
        found = np.flatnonzero(sieve)
        if len(found) >= n:
            return found[:n].astype(np.int64)
        limit *= 2


def _digit_loop(base: torch.Tensor, res: torch.Tensor, ndigits: int) -> torch.Tensor:
    """The radical inverse of the int64 ``res`` (already ``idx + 1``) in
    ``base``, broadcast, over ``ndigits`` digits, in f64.  ``m`` depends on
    the base only, so it keeps the base's shape."""
    shape = torch.broadcast_shapes(base.shape, res.shape)
    fbase = base.to(torch.float64)
    r = torch.zeros(shape, dtype=torch.float64, device=res.device)
    m = torch.ones(base.shape, dtype=torch.float64, device=res.device)
    for _ in range(ndigits):
        m = m / fbase
        q = torch.div(res, base, rounding_mode="floor")
        digit = res - q * base          # res % base: res and base are positive
        r = r + m * digit.to(torch.float64)
        res = q
    return r


def radical_inverse(base, idx, ndigits: int = _MAX_DIGITS, *, device=None) -> torch.Tensor:
    """Van der Corput radical inverse of ``idx + 1`` in ``base`` (1-based,
    as the reference's ``RadialInverseFunction``), f64.  ``base`` and
    ``idx`` broadcast; tensors are computed where ``idx`` lies, other
    arguments move to ``device``.  ``ndigits`` bounds the digit loop; any
    bound past the index's last digit gives bitwise the same values."""
    idx = as_tensor(idx, device).to(torch.int64)
    base = as_tensor(base, idx.device).to(torch.int64)
    return _digit_loop(base, idx + 1, ndigits)


def _iroot(value: int, k: int) -> int:
    """floor(value ** (1/k)) for positive Python ints, exact."""
    r = int(round(value ** (1.0 / k)))
    while r > 0 and r**k > value:
        r -= 1
    while (r + 1) ** k <= value:
        r += 1
    return r


def digit_tiers(p: np.ndarray, max_res: int) -> np.ndarray:
    """Per base in ``p``, the smallest tier t of ``_TIERS`` with p^t >
    ``max_res`` (so every residue up to ``max_res`` has at most t digits),
    else 41.  ``p^t > M`` holds exactly when ``p > floor(M^(1/t))``."""
    tier = np.full(p.shape, _MAX_DIGITS, np.int64)
    for t in reversed(_TIERS[:-1]):
        tier[p > _iroot(int(max_res), t)] = t
    return tier


def halton_block(p: np.ndarray, idx: torch.Tensor, max_res: int) -> torch.Tensor:
    """(h, w) f64 block of radical inverses: column j in base ``p[j]``, row
    i of ``idx[i] + 1`` (int64, on the block's device); ``max_res`` bounds
    ``idx + 1``.  Columns run in digit tiers (bitwise the 41-digit loop);
    for increasing ``p`` the tiers are contiguous runs of columns."""
    h, w = idx.shape[0], p.size
    out = torch.empty((h, w), dtype=torch.float64, device=idx.device)
    if not w or not h:
        return out
    tier = digit_tiers(p, max_res)
    res = idx[:, None] + 1
    cuts = np.flatnonzero(np.diff(tier)) + 1
    for lo, hi in zip(np.concatenate([[0], cuts]), np.concatenate([cuts, [w]])):
        base = torch.from_numpy(p[lo:hi]).to(idx.device)[None, :]
        out[:, lo:hi] = _digit_loop(base, res, int(tier[lo]))
    return out


@dataclass(frozen=True)
class LeapedHaltonSequence:
    """Leaped Halton QMC sequence (≙ ``leaped_halton_sequence_t``):
    ``coordinate(idx, i) = radical_inverse(prime(i), idx * leap)``, the
    default leap being the (d+1)-th prime."""

    d: int
    leap: int = -1

    def __post_init__(self):
        if self.d < 0:
            raise InvalidParameters(f"Halton dimension must be >= 0, got {self.d}")
        if self.leap == -1:
            object.__setattr__(self, "leap", int(primes(self.d + 1)[-1]))
            return
        if self.leap < 1:
            raise InvalidParameters(
                f"Halton leap must be a positive integer (or -1 for the "
                f"default), got {self.leap}"
            )
        # A leap sharing a factor with a base prime visits only a strict
        # subsequence of that base's digit lattice: no base may divide it.
        bad = [int(p) for p in primes(self.d) if self.leap % int(p) == 0]
        if bad:
            raise InvalidParameters(
                f"Halton leap {self.leap} is not coprime with base(s) {bad}; "
                f"choose a leap not divisible by any of the first {self.d} "
                f"primes"
            )

    def coordinate(self, idx, i, *, device=None) -> torch.Tensor:
        """Value(s) at sequence index ``idx``, dimension ``i`` (f64)."""
        idx = as_tensor(idx, device).to(torch.int64)
        p = torch.from_numpy(primes(self.d)).to(idx.device)[as_tensor(i, idx.device).long()]
        return radical_inverse(p, idx * self.leap)

    def window(self, idx0: int, num: int, dtype=torch.float32, *, device=None) -> torch.Tensor:
        """(num, d) block of the sequence from index ``idx0``, in ``dtype``
        (computed in f64, cast once), by digit tiers."""
        dev = resolve_device(device)
        idx0, num = int(idx0), int(num)
        idx = (idx0 + torch.arange(num, dtype=torch.int64, device=dev)) * self.leap
        max_res = (idx0 + num) * self.leap + 1
        return halton_block(primes(self.d), idx, max_res).to(dtype)

    # -- serialization ------------------------------------------------------

    def to_dict(self):
        return {
            "skylark_object_type": "qmc_sequence",
            "sequence_type": "leaped halton",
            "d": self.d,
            "leap": self.leap,
        }

    @classmethod
    def from_dict(cls, dd):
        return cls(d=int(dd["d"]), leap=int(dd["leap"]))

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s):
        return cls.from_dict(json.loads(s))
