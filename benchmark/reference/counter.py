"""The counter stream of ``counter_contract.md`` (a frozen copy beside
this file), written out in plain torch for the benchmark's reference.

Sample ``i`` of a stream is Threefry-2x32 (20 rounds) of the 64-bit
counter ``i`` split into its (hi, lo) words, keyed by ``(seed_lo32,
seed_hi32 ^ lane * 0x9E3779B9)``.  Each 32-bit word is held in an int64
tensor and masked after every add.  Only the draws the reference needs
are here: Rademacher signs, bounded integers, uniforms and normals.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(seed: int, counters_hi: torch.Tensor, counters_lo: torch.Tensor, lane: int = 0):
    """The two output words of Threefry-2x32 for each counter."""
    seed = int(seed) % (1 << 64)
    k0 = seed & MASK
    k1 = ((seed >> 32) ^ (lane * GOLDEN)) & MASK
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (counters_hi + ks[0]) & MASK
    x1 = (counters_lo + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def bits(seed: int, base: int, num: int, device, lane: int = 0):
    """(hi, lo) words of counters ``base .. base + num - 1``."""
    idx = torch.arange(num, dtype=torch.int64, device=device) + (int(base) & MASK)
    hi = ((int(base) >> 32) + (idx >> 32)) & MASK
    return threefry(seed, hi, idx & MASK, lane)


def rademacher(seed: int, base: int, num: int, device, dtype=torch.float64):
    """±1 from the low bit of the low word."""
    _, lo = bits(seed, base, num, device)
    return ((lo & 1) * 2 - 1).to(dtype)


def uniform_int(seed: int, base: int, num: int, high: int, device):
    """Integers in [0, high] by the multiply-shift ``floor(x * span /
    2^64)`` of the 64-bit word x.  Exact in int64 for span < 2^31."""
    span = int(high) + 1
    if not 0 < span < (1 << 31):
        raise ValueError(f"span {span} out of range")
    hi, lo = bits(seed, base, num, device)
    return (hi * span + ((lo * span) >> 32)) >> 32


def uniform01_f32(seed: int, base: int, num: int, device):
    """f32 uniforms in (0, 1): ``(hi >> 8) + 0.5`` times 2^-24."""
    hi, _ = bits(seed, base, num, device)
    return ((hi >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def normal_f32(seed: int, base: int, num: int, device):
    """f32 Box-Muller normals, u1 from the high word, u2 from the low."""
    hi, lo = bits(seed, base, num, device)
    u1 = ((hi >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    u2 = ((lo >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
