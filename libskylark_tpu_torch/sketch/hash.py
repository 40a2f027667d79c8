"""Hash (CountSketch-family) sketches CWT, MMT, WZT and SJLT, dense and
sparse apply (port of ``libskylark_tpu/sketch/hash.py``).

Each input coordinate i in [0, N) is hashed to ``nnz`` output slots
``bucket[h, i] ~ U{0..S-1}`` with values ``value[h, i]`` (±1 for CWT,
±1/√nnz for SJLT, Cauchy for MMT, signed reciprocal-exponential for
WZT); columnwise, ``SA[r, :] = Σ_{h,i: bucket[h,i]=r} value[h,i]·A[i, :]``.
Both arrays are counter-derived, in the reference's layout (nnz·N
buckets, then nnz·N values).

Dense apply takes one of the reference's two branches:

- one-hot matmul when N·S ≤ 2^27 and the batch is ≥ 16: the (N, S)
  hash matrix has small-integer (or 0/1) entries, exact in bf16, and f32
  inputs ride the three-part bf16 split; the exact bf16 parts are
  contracted in a full-f32 matmul (TF32 off), so every product is exact
  and the sums are f32, as in the reference's f32-accumulating bf16 dot;
- otherwise the row scatter ``kernels_window.scatter_rows`` (a CUDA
  kernel on the card, its plain version on the CPU) for f32/bf16/f16
  input, and a plain ``index_add_`` in the input dtype for f64 (the
  reference's XLA branch).  A dense apply's window is the whole domain
  [0, N), so no value lies past it and none needs zeroing.

Sparse input is a ``torch.sparse_coo_tensor`` (2-D, or a 1-D vector),
coalesced or not; duplicate coordinates add up, as in a BCOO.  With
``dense_output=True`` each hash is one flat segment sum keyed by the
hashed destination (``kernels_scatter.segment_sum_flat``: a CUDA kernel
on the card, its plain version on the CPU; f64 takes a plain
``index_add_`` in f64, the reference's XLA branch).  Without it, the
hashed coordinates are relabelled and ``coalesce()`` sums the
duplicates, the counterpart of the reference's ``sum_duplicates``.
Other sparse layouts (CSR, ...) raise ``UnsupportedError``.

Streaming slices regenerate only the k-coordinate hash windows of a row
block (flat counter index ``h·N + start + i``).  A dense f32/bf16/f16
block takes ONE ``scatter_rows`` launch for all nnz hashes, with buckets
and f32 values stacked (nnz, k); ``apply_slice_kernel`` zeroes the
values past N, and ``apply_slice_kernel_acc`` with an f32 accumulator
hands it to the kernel (``scatter_rows(..., acc=acc)``), whose result
is bitwise ``acc + scatter_rows(...)``: one launch per stream chunk.
f64 blocks take ``index_add_`` in f64; sparse COO blocks one segment
sum per hash keyed ``b[rows]·m + cols``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..core.context import SketchContext
from ..core.precision import bf16_split3, f32_accumulable, mm_f32
from ..core.random import _const, sample
from ..utils.exceptions import UnsupportedError
from . import kernels_scatter, kernels_window
from .base import Dimension, SketchTransform, register_sketch

__all__ = ["HashSketch", "CWT", "MMT", "WZT", "SJLT"]

_ONEHOT_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _segment_sum(addends, key, num_segments: int):
    """Flat scatter-add ``out[key[i]] += addends[i]``.  f32-accumulable
    dtypes (f32, bf16, f16) go through ``kernels_scatter.segment_sum_flat``
    and come back in their dtype; f64 takes a plain ``index_add_`` in
    f64 (the reference's default XLA branch, which keeps f64 sums)."""
    if f32_accumulable(addends.dtype):
        return kernels_scatter.segment_sum_flat(addends.contiguous(),
                                                key.contiguous(), num_segments)
    out = torch.zeros(num_segments, dtype=addends.dtype, device=addends.device)
    return out.index_add_(0, key.long(), addends)


def _segment_sum_rows(A, b, v, num_segments: int):
    """Row scatter-add ``out[b[h,i], :] += v[h,i]·A[i, :]`` (A (k, m),
    b/v (nnz, k)).  f32-accumulable inputs go through the scatter kernel
    with f32 values and come back f32; others (f64) take a plain
    ``index_add_`` in A's dtype."""
    if f32_accumulable(A.dtype):
        Ak = A if A.dtype in _KERNEL_DTYPES else A.to(torch.float32)
        return kernels_window.scatter_rows(Ak.contiguous(), b, v, num_segments)
    m = A.shape[1]
    rows = (v[:, :, None] * A[None, :, :]).reshape(-1, m)
    out = torch.zeros((num_segments, m), dtype=A.dtype, device=A.device)
    return out.index_add_(0, b.reshape(-1).long(), rows)


class HashSketch(SketchTransform):
    """Base engine: bucket ~ uniform_int(0, S-1), value ~ ``value_dist``,
    ``nnz`` hash functions per coordinate (CountSketch at nnz = 1)."""

    value_dist: str = "rademacher"

    # The dense apply switches from the scatter to the one-hot matmul at
    # batch 16: a bucketed plan must not pad a thinner batch across it.
    batch_size_gates = (16,)

    # Above this many (S·N) entries the materialized one-hot hashing
    # matrix no longer pays for itself; the scatter branch takes over.
    _ONEHOT_LIMIT = 1 << 27

    def __init__(self, n: int, s: int, context: SketchContext, nnz: int = 1):
        if nnz < 1:
            raise ValueError(f"hash sketch needs nnz >= 1, got {nnz}")
        self.nnz = int(nnz)
        super().__init__(n, s, context)
        self._seed = context.seed
        self._idx_base = context.reserve(self.nnz * n)
        self._val_base = context.reserve(self.nnz * n)

    def _window(self, start, num: int | None, total: int):
        """``(start, num)`` of a flat window: ``start`` a host int, or a
        0-d int64 device tensor (then ``num`` is required)."""
        if isinstance(start, torch.Tensor):
            if num is None:
                raise ValueError("a tensor window start needs an explicit length")
            return start, int(num)
        start = int(start)
        return start, (total - start if num is None else int(num))

    def buckets(self, start=0, num: int | None = None, device=None):
        """bucket[i] for i in [start, start+num) of the flat (nnz·N)
        layout, int32."""
        start, num = self._window(start, num, self.nnz * self.n)
        return sample("uniform_int", self._seed, self._idx_base, num, offset=start,
                      dtype=torch.int32, device=device, low=0, high=self.s - 1)

    def values(self, dtype=torch.float32, start=0, num: int | None = None, device=None):
        """Signed values, same flat layout as :meth:`buckets`."""
        start, num = self._window(start, num, self.nnz * self.n)
        return sample(self.value_dist, self._seed, self._val_base, num, offset=start,
                      dtype=dtype, device=device)

    # Up to this many nnz·N entries, a stream's hash windows are windows
    # of the whole (nnz, N) arrays, realized once per dtype and device and
    # dropped by finalize_slices: a window costs ~300 small launches of
    # the counter stream, which set the time of a stream chunk otherwise.
    # The limit is a memory budget: int32 buckets and f32 values take
    # 8 B an entry, so 2^25 entries hold 256 MiB on the device during a
    # pass.  Above it each window is drawn for its chunk.
    _SLICE_MEMO_LIMIT = 1 << 25

    def _slice_hashes(self, start, k: int, vdtype, device):
        """Stacked (nnz, k) buckets and values of coordinates [start,
        start + k), hash h at flat index ``h·N + start``: views of the
        memoized whole arrays where the window lies in [0, N) and they
        are small enough, else drawn for the window (the same counters,
        so the same bits)."""
        if (not isinstance(start, torch.Tensor) and 0 <= start and start + k <= self.n
                and self.nnz * self.n <= self._SLICE_MEMO_LIMIT):
            key = (vdtype, resolve_device(device))
            memo = self.__dict__.setdefault("_slice_memo", {})
            if key not in memo:
                memo[key] = self._slice_hashes_drawn(0, self.n, vdtype, key[1])
            b, v = memo[key]
            return b[:, start:start + k], v[:, start:start + k]
        return self._slice_hashes_drawn(start, k, vdtype, device)

    def slice_steps_launch_bound(self) -> bool:
        """A stream step is launch-bound where its windows are drawn per
        step (above the memo's limit: ~300 small launches of the counter
        stream a window); cut from the memoized arrays it is a view and
        the row scatter, which a plan's copy-in of the block would only
        slow (phase 3k (b) of ``chip_smoke.py`` times both)."""
        return self.nnz * self.n > self._SLICE_MEMO_LIMIT

    def _slice_hashes_drawn(self, start, k: int, vdtype, device):
        b = torch.stack([self.buckets(h * self.n + start, k, device=device)
                         for h in range(self.nnz)])
        v = torch.stack([self.values(vdtype, h * self.n + start, k, device=device)
                         for h in range(self.nnz)])
        return b, v

    # -- apply --------------------------------------------------------------

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              dense_output: bool = False, device=None):
        """Apply the sketch.  For a sparse COO ``A``, ``dense_output=True``
        accumulates straight into a dense result (≙ the reference's mixed
        sparse→dense apply, ``hash_transform_Mixed.hpp``) and otherwise
        the result is a coalesced sparse COO tensor.  Dense inputs ignore
        the flag."""
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if A.layout == torch.sparse_coo:
            return self._apply_coo(A, dim, dense_output)
        if A.layout != torch.strided:
            raise UnsupportedError(
                f"hash sketches take dense or sparse COO input, not {A.layout} "
                "(convert with .to_sparse_coo())"
            )
        if A.ndim == 1:
            if dim is Dimension.COLUMNWISE:
                return self._apply_dense(A[:, None], dim)[:, 0]
            return self._apply_dense(A[None, :], dim)[0, :]
        return self._apply_dense(A, dim)

    # Dense outputs above this many elements would not fit comfortably
    # next to the input triplets; callers beyond it keep the sparse path.
    # It also keeps every flat key below 2^31.
    _DENSE_OUT_LIMIT = 1 << 28

    def _apply_coo(self, A, dim: Dimension, dense_output: bool):
        """Sparse COO input.  ``_indices()``/``_values()`` read an
        uncoalesced tensor as it is: its duplicates add up in the sums,
        and no sort of the input is paid for."""
        idx, data = A._indices(), A._values()
        if A.ndim == 1:
            # Vectors are columns columnwise / rows rowwise, as for dense.
            zero = torch.zeros_like(idx[0])
            col = dim is Dimension.COLUMNWISE
            idx = torch.stack([idx[0], zero] if col else [zero, idx[0]])
            shape = (A.shape[0], 1) if col else (1, A.shape[0])
            if dense_output:
                out = self._apply_sparse_dense_out(idx, data, shape, dim)
            else:
                out = self._apply_sparse(idx, data, shape, dim).to_dense()
            return out[:, 0] if col else out[0, :]
        if A.ndim != 2:
            raise ValueError(f"sparse apply needs a 1-D or 2-D tensor, got {A.ndim}-D")
        if dense_output:
            return self._apply_sparse_dense_out(idx, data, tuple(A.shape), dim)
        return self._apply_sparse(idx, data, tuple(A.shape), dim)

    def _check_hashed_axis(self, shape, dim: Dimension) -> int:
        axis = 0 if dim is Dimension.COLUMNWISE else 1
        if shape[axis] != self.n:
            raise ValueError(
                f"{dim.value} apply needs A with {self.n} on axis {axis}, "
                f"got {tuple(shape)}"
            )
        return axis

    def _apply_sparse_dense_out(self, idx, data, shape, dim: Dimension):
        """Sparse → dense: one flat segment sum per hash function keyed
        by the hashed destination, ``b[h][row]·batch + col`` columnwise
        and ``row·S + b[h][col]`` rowwise, in the data's dtype."""
        axis = self._check_hashed_axis(shape, dim)
        batch = shape[1 - axis]
        if self.s * batch > self._DENSE_OUT_LIMIT:
            raise ValueError(
                f"dense_output needs S*batch <= {self._DENSE_OUT_LIMIT} "
                f"elements, got {self.s}*{batch}; use the sparse path"
            )
        dtype = data.dtype if data.is_floating_point() else torch.float32
        dev = data.device
        data = data.to(dtype)
        rows, cols = idx[0], idx[1]
        hashed = rows if axis == 0 else cols
        b = self.buckets(device=dev).reshape(self.nnz, self.n)
        v = self.values(dtype, device=dev).reshape(self.nnz, self.n)
        out = torch.zeros(self.s * batch, dtype=dtype, device=dev)
        for h in range(self.nnz):
            bh = b[h].long()[hashed]
            # int64 keys; below S·batch <= 2^28, so the int32 cast is exact.
            key = bh * batch + cols if axis == 0 else rows * self.s + bh
            out = out + _segment_sum(data * v[h][hashed], key.int(),
                                     self.s * batch).to(dtype)
        return out.reshape((self.s, batch) if axis == 0 else (batch, self.s))

    def _apply_sparse(self, idx, data, shape, dim: Dimension):
        """Sparse → sparse: relabel the hashed index per hash function,
        scale the data, and sum the duplicates with ``coalesce()`` (≙ the
        queue-then-finalize CSC build of
        ``hash_transform_local_sparse.hpp:88-152``)."""
        axis = self._check_hashed_axis(shape, dim)
        dev = data.device
        b = self.buckets(device=dev).reshape(self.nnz, self.n)
        v = self.values(data.dtype, device=dev).reshape(self.nnz, self.n)
        hashed = idx[axis]
        idx_parts, data_parts = [], []
        for h in range(self.nnz):
            part = idx.clone()
            part[axis] = b[h].long()[hashed]
            idx_parts.append(part)
            data_parts.append(data * v[h][hashed])
        out_shape = (self.s, shape[1]) if axis == 0 else (shape[0], self.s)
        return torch.sparse_coo_tensor(torch.cat(idx_parts, 1), torch.cat(data_parts),
                                       out_shape, check_invariants=False).coalesce()

    def _apply_dense(self, A, dim: Dimension):
        dtype = A.dtype if A.is_floating_point() else torch.float32
        dev = A.device
        if dim is Dimension.COLUMNWISE:
            if A.shape[0] != self.n:
                raise ValueError(
                    f"columnwise apply needs A with {self.n} rows, got "
                    f"{tuple(A.shape)}"
                )
        elif A.shape[-1] != self.n:
            raise ValueError(
                f"rowwise apply needs A with {self.n} columns, got "
                f"{tuple(A.shape)}"
            )
        A = A.to(dtype)
        batch = A.shape[1] if dim is Dimension.COLUMNWISE else A.shape[0]
        if self.n * self.s <= self._ONEHOT_LIMIT and batch >= 16:
            if dtype in _ONEHOT_DTYPES:
                c = self._sign_scale()
                if c is not None:
                    out = self._onehot_contract(
                        A, self._sign_matrix_bf16(c, dev), dim, dtype)
                    return (out * c).to(dtype)
                return self._apply_onehot_scaled(A, dim, dtype)
            M = self._hash_matrix(dtype, dev)
            return M.T @ A if dim is Dimension.COLUMNWISE else A @ M
        b = self.buckets(device=dev).reshape(self.nnz, self.n)
        vdtype = torch.float32 if f32_accumulable(dtype) else dtype
        v = self.values(vdtype, device=dev).reshape(self.nnz, self.n)
        if dim is Dimension.COLUMNWISE:
            return _segment_sum_rows(A, b, v, self.s).to(dtype)
        # ROWWISE: (A·Sᵀ) = (S·Aᵀ)ᵀ — one transpose puts the scattered
        # axis on the rows the kernel accumulates.
        return _segment_sum_rows(A.T, b, v, self.s).T.to(dtype)

    # -- streaming slices ---------------------------------------------------

    supports_slice_kernel = True

    def _apply_slice_columnwise(self, A_block, start: int):
        """Partial scatter-add over the hash windows of coordinates
        [start, start + k): sparse COO blocks one segment sum per hash
        keyed by their local rows, dense blocks one stacked row scatter."""
        k, m = A_block.shape
        dev = A_block.device
        if A_block.layout == torch.sparse_coo:
            idx, data = A_block._indices(), A_block._values()
            dtype = data.dtype if data.is_floating_point() else torch.float32
            data = data.to(dtype)
            rows, cols = idx[0], idx[1]
            out = torch.zeros((self.s, m), dtype=dtype, device=dev)
            for h in range(self.nnz):
                b = self.buckets(h * self.n + start, k, device=dev).long()
                v = self.values(dtype, h * self.n + start, k, device=dev)
                key = (b[rows] * m + cols).int()
                out = out + _segment_sum(data * v[rows], key,
                                         self.s * m).to(dtype).reshape(self.s, m)
            return out
        return self._slice_kernel_impl(A_block, start, None)

    def _slice_kernel_impl(self, A_block, start, acc):
        """Shared body of the dense slices: the stacked (nnz, k) windows
        in one row scatter, values past N zeroed unless a host start
        puts the window inside the domain (an out-of-domain counter
        stream can hold non-finite draws, WZT's 1/Exp, and inf·0 from a
        padded row would poison the sum).  With an f32 ``acc`` and an
        f32 block the accumulator add is the kernel's emit: one launch
        per chunk, bitwise ``acc + part``."""
        dtype = A_block.dtype if A_block.is_floating_point() else torch.float32
        A_block = A_block.to(dtype)
        k = A_block.shape[0]
        dev = A_block.device
        vdtype = torch.float32 if f32_accumulable(dtype) else dtype
        b, v = self._slice_hashes(start, k, vdtype, dev)
        if isinstance(start, torch.Tensor) or start + k > self.n:
            valid = torch.arange(k, device=dev) + start < self.n
            v = torch.where(valid[None, :], v, torch.zeros((), dtype=vdtype, device=dev))
        if acc is not None and dtype == torch.float32 and acc.dtype == torch.float32:
            return kernels_window.scatter_rows(A_block.contiguous(), b, v.contiguous(),
                                               self.s, acc=acc)
        out = _segment_sum_rows(A_block, b, v, self.s).to(dtype)
        return out if acc is None else acc + out.to(acc.dtype)

    def apply_slice_kernel(self, A_block, start):
        return self._slice_kernel_impl(A_block, start, None)

    def apply_slice_kernel_acc(self, acc, A_block, start):
        return self._slice_kernel_impl(A_block, start, acc)

    def finalize_slices(self, acc, dim: Dimension | str = Dimension.COLUMNWISE):
        """Ends a pass of slices: drops the memoized hash arrays."""
        self.__dict__.pop("_slice_memo", None)
        return acc

    # -- loop-invariant operands ---------------------------------------------

    def hoistable_operands(self, dtype=torch.float32, device=None):
        """The bf16-exact one-hot operands of the dense apply (the sign
        matrix for CWT/SJLT, per-hash (P01, v) pairs for MMT/WZT), the
        O(N·S) build a streaming consumer should not repeat per block;
        None where the apply takes no one-hot route.  Memoized per dtype
        and device."""
        if dtype not in _ONEHOT_DTYPES or self.n * self.s > self._ONEHOT_LIMIT:
            return None
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_hoist_cache", {})
        hit = cache.get((dtype, dev))
        if hit is None:
            c = self._sign_scale()
            hit = (("sign", c, self._sign_matrix_bf16(c, dev)) if c is not None
                   else ("scaled", self._scaled_pairs(dev)))
            cache[(dtype, dev)] = hit
        return hit

    def apply_with_operands(self, ops, A, dim: Dimension | str = Dimension.COLUMNWISE,
                            *, device=None):
        """:meth:`apply` with the hoisted one-hot operands, bitwise the
        same: any input the apply would not send down the one-hot route
        (sparse, 1-D, f16/f64, thin batches) takes :meth:`apply`."""
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if ops is None or A.layout != torch.strided or A.ndim != 2:
            return self.apply(A, dim)
        dtype = A.dtype if A.is_floating_point() else torch.float32
        if dtype not in _ONEHOT_DTYPES:
            return self.apply(A, dim)
        axis = 0 if dim is Dimension.COLUMNWISE else 1
        if A.shape[axis] != self.n:
            raise ValueError(f"{dim.value} apply needs A with {self.n} on axis {axis}, "
                             f"got {tuple(A.shape)}")
        if A.shape[1 - axis] < 16:
            return self.apply(A, dim)
        if ops[0] == "sign":
            _, c, Mi = ops
            return (self._onehot_contract(A, Mi, dim, dtype) * c).to(dtype)
        return self._scaled_contract(ops[1], A, dim, dtype)

    def _hash_matrix(self, dtype, device):
        """Dense (N, S) hashing matrix M with M[i, b[h,i]] += v[h,i]
        (one add per hash, as the reference's broadcast-compare sum)."""
        b = self.buckets(device=device).reshape(self.nnz, self.n).long()
        v = self.values(dtype, device=device).reshape(self.nnz, self.n)
        rows = torch.arange(self.n, device=device)
        M = torch.zeros((self.n, self.s), dtype=dtype, device=device)
        for h in range(self.nnz):
            M[rows, b[h]] += v[h]
        return M

    def _sign_scale(self):
        """Scalar c with the hash matrix ``c · M_int`` (small-integer
        entries, exact in bf16), or None when values aren't signs."""
        if self.value_dist != "rademacher":
            return None
        return 1.0

    def _onehot_contract(self, X, M, dim: Dimension, dtype):
        """Contract X's N axis with a bf16 (N, S) matrix M of exact values;
        f32 X rides the three-part bit-mask split.  Each product is a bf16
        one with an f32 result (``mm_f32``).  Returns f32, (S, batch)
        columnwise / (batch, S) rowwise."""

        def mm(x):
            return mm_f32(M.T, x) if dim is Dimension.COLUMNWISE else mm_f32(x, M)

        if dtype == torch.bfloat16:
            return mm(X.to(torch.bfloat16))
        hi, lo, lo2 = bf16_split3(X.to(torch.float32))
        return mm(hi) + mm(lo) + mm(lo2)

    def _sign_matrix_bf16(self, c, device):
        """The (N, S) integer sign matrix ·(1/c) in bf16 (signed
        collision counts — exact)."""
        b = self.buckets(device=device).reshape(self.nnz, self.n).long()
        v = self.values(torch.float32, device=device).reshape(self.nnz, self.n)
        rows = torch.arange(self.n, device=device)
        Mi = torch.zeros((self.n, self.s), dtype=torch.bfloat16, device=device)
        inv_c = float(np.float32(1.0 / c))
        for h in range(self.nnz):
            Mi[rows, b[h]] += torch.round(v[h] * inv_c).to(torch.bfloat16)
        return Mi

    def _apply_onehot_scaled(self, A, dim: Dimension, dtype):
        """General-valued hash sketches (MMT/WZT): the value array is
        folded into A, so each hash's matrix is pure 0/1 (exact in bf16):
        ``SA = Σ_h P01_hᵀ·(v_h ⊙ A)`` columnwise."""
        return self._scaled_contract(self._scaled_pairs(A.device), A, dim, dtype)

    def _scaled_pairs(self, device):
        """Per-hash (0/1 bucket matrix in bf16, value row) pairs."""
        b = self.buckets(device=device).reshape(self.nnz, self.n).long()
        v = self.values(torch.float32, device=device).reshape(self.nnz, self.n)
        rows = torch.arange(self.n, device=device)
        pairs = []
        for h in range(self.nnz):
            P01 = torch.zeros((self.n, self.s), dtype=torch.bfloat16, device=device)
            P01[rows, b[h]] = _const(1.0, torch.bfloat16, device)  # no host copy
            pairs.append((P01, v[h]))
        return tuple(pairs)

    def _scaled_contract(self, pairs, A, dim: Dimension, dtype):
        """``Σ_h contract(v_h ⊙ A, P01_h)``: the one loop behind the
        per-call and the hoisted scaled one-hot paths."""
        A32 = A.to(torch.float32)
        out = None
        for P01, vh in pairs:
            scaled = A32 * (vh[:, None] if dim is Dimension.COLUMNWISE else vh[None, :])
            part = self._onehot_contract(scaled, P01, dim, dtype)
            out = part if out is None else out + part
        return out.to(dtype)


@register_sketch
class CWT(HashSketch):
    """Clarkson-Woodruff (CountSketch): bucket + Rademacher sign."""

    sketch_type = "CWT"
    value_dist = "rademacher"


@register_sketch
class SJLT(HashSketch):
    """Sparse JLT / OSNAP with ``nnz`` nonzeros per column: coordinate i
    contributes ±1/√nnz at nnz hashed output slots."""

    sketch_type = "SJLT"
    value_dist = "rademacher"

    def __init__(self, n: int, s: int, context: SketchContext, nnz: int = 4):
        super().__init__(n, s, context, nnz=nnz)

    def values(self, dtype=torch.float32, start=0, num: int | None = None, device=None):
        v = super().values(dtype, start, num, device=device)
        return v / torch.sqrt(_const(float(self.nnz), dtype, v.device))

    def _sign_scale(self):
        return 1.0 / float(np.sqrt(self.nnz))

    def _param_dict(self):
        return {"nnz": self.nnz}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, nnz=d.get("nnz", 4))


@register_sketch
class MMT(HashSketch):
    """Meng-Mahoney: bucket + Cauchy values (l1 embedding)."""

    sketch_type = "MMT"
    value_dist = "cauchy"


@register_sketch
class WZT(HashSketch):
    """Woodruff-Zhang: bucket + signed reciprocal-exponential values
    ±(1/Exp)^(1/p), an extra Rademacher block of N after the base two."""

    sketch_type = "WZT"
    value_dist = "exponential"

    def __init__(self, n: int, s: int, context: SketchContext, p: float = 2.0):
        if not 1.0 <= p <= 2.0:
            raise ValueError(f"WZT parameter p must be in [1, 2], got {p}")
        self.p = float(p)
        super().__init__(n, s, context)
        self._pm_base = context.reserve(n)

    def values(self, dtype=torch.float32, start=0, num: int | None = None, device=None):
        start, num = self._window(start, num, self.n)
        e = sample("exponential", self._seed, self._val_base, num, offset=start,
                   dtype=dtype, device=device)
        pm = sample("rademacher", self._seed, self._pm_base, num, offset=start,
                    dtype=dtype, device=device)
        return pm * (1.0 / e) ** _const(1.0 / self.p, dtype, e.device)

    def _param_dict(self):
        return {"P": self.p}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, p=d.get("P", 2.0))
