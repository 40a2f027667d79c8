"""Operations and bytes of each kernel and layer the benchmark prices,
from shapes alone, and the published peaks of the card they are priced
against (``peaks.json``).

Every count takes inputs read once and outputs written once, whatever an
implementation reads again, and the operations the algorithm needs.  A
least time is the larger of operations over the dtype's peak and bytes
over the memory bandwidth.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    peak: str = "f32_flops_per_s"  # the peaks.json rate the operations run at

    def least_s(self) -> float:
        return max(self.flops / PEAKS[self.peak], self.bytes / PEAKS["hbm_bytes_per_s"])

    def bound(self) -> str:
        """Which of the two limits sets :meth:`least_s`."""
        return ("flops" if self.flops / PEAKS[self.peak]
                >= self.bytes / PEAKS["hbm_bytes_per_s"] else "bytes")

    def __add__(self, other: "Work") -> "Work":
        if self.peak != other.peak:
            raise ValueError("cannot add work priced at different peaks")
        return Work(self.flops + other.flops, self.bytes + other.bytes, self.peak)

    def times(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k, self.peak)


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def sketch_columnwise(kind: str, m: int, n: int, s: int, itemsize: int = 4) -> Work:
    """``S·A`` for A (m, n), written as (s, n) in A's dtype.  The FJLT's
    transform needs NB·log2(NB) additions per column; a hash sketch one
    multiply-add per entry of A; a dense sketch 2·m·s per column."""
    moved = m * n * itemsize + s * n * itemsize
    if kind == "FJLT":
        nb = next_pow2(m)
        flops = nb * math.log2(nb) * n
    elif kind in ("CWT", "MMT", "WZT"):
        flops = 2.0 * m * n
    elif kind == "JLT":
        flops = 2.0 * m * s * n
    else:
        raise ValueError(f"no count for sketch {kind!r}")
    return Work(flops, moved)


def gather_scaled_rows(nrows: int, cols: int, s: int, itemsize: int = 4) -> Work:
    """``scale · T[idx]``: s rows of T read, s rows written, s indices."""
    return Work(float(s * cols), 2.0 * s * cols * itemsize + 4.0 * s)


def scatter_rows(k: int, cols: int, s: int, nnz: int = 1, itemsize: int = 4) -> Work:
    """``out[b] += v·A`` for A (k, cols): A read, nnz buckets and values
    per row, the (s, cols) f32 output written."""
    return Work(2.0 * nnz * k * cols, k * cols * itemsize + 8.0 * nnz * k + 4.0 * s * cols)


def rfut_rowwise(m: int, n: int, nb: int, itemsize: int = 4) -> Work:
    """D then the WHT of each of m rows padded to nb, (m, nb) written."""
    return Work(m * nb * math.log2(nb), (m * n + n + m * nb) * itemsize)


def rfut_rowwise_sampled(m: int, n: int, nb: int, s: int, itemsize: int = 4) -> Work:
    """The same transform with only s sampled lanes of each row written."""
    return Work(m * nb * math.log2(nb), (m * n + n + m * s) * itemsize + 4.0 * s)


def segment_sum_flat(nnz: int, segments: int, itemsize: int = 4) -> Work:
    """``out[key] += val`` over nnz entries into segments f32 sums."""
    return Work(float(nnz), nnz * (itemsize + 4.0) + 4.0 * segments)


def lsqr_step(m: int, n: int, k: int = 1, itemsize: int = 4) -> Work:
    """One LSQR step on A (m, n) with k right-hand sides: A·v then Aᵀ·u,
    each a read of A (the second needs the first's result), and the
    (m, k) u read and written."""
    return Work(4.0 * m * n * k, 2.0 * m * n * itemsize + 2.0 * m * k * itemsize)


def rft_panel(rows: int, d: int, s: int, itemsize: int = 2) -> Work:
    """Random Fourier features of a (rows, d) panel: the (rows, d) by
    (d, s) product, W and the panel read, the (rows, s) features written;
    at the bf16 tensor-core peak."""
    return Work(2.0 * rows * d * s, (rows * d + d * s + rows * s) * itemsize, "bf16_flops_per_s")


def krr_fit(n: int, d: int, s: int, sweeps: int, itemsize: int = 2) -> Work:
    """The least work of a streamed random-feature ridge fit whose
    features do not fit beside X: every sweep makes each row's features
    at least once, and the first also forms the (s, s) Gram."""
    panel = rft_panel(n, d, s, itemsize)
    gram = Work(2.0 * n * s * s, 0.0, "bf16_flops_per_s")
    return panel.times(sweeps) + gram


KERNELS = {
    "gather_scaled_rows": lambda call: gather_scaled_rows(
        call["T"][0], call["T"][1], call["idx"][0], call["itemsize"]),
    "scatter_rows": lambda call: scatter_rows(
        call["A"][0], call["A"][1], call["num_segments"], call["nnz"], call["itemsize"]),
    "rfut_rowwise": lambda call: rfut_rowwise(
        call["x"][0], call["x"][1], call["nb"], call["itemsize"]),
    "rfut_rowwise_sampled": lambda call: rfut_rowwise_sampled(
        call["x"][0], call["x"][1], call["nb"], call["idx"][0], call["itemsize"]),
    "segment_sum_flat": lambda call: segment_sum_flat(
        call["vals"][0], call["num_segments"], call["itemsize"]),
}
