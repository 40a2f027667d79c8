"""The port's row scatter (``kernels_window.scatter_rows``) on the CPU.

On the CPU the wrapper takes its plain version, ``index_add_`` of the
f32 rows ``v·A`` in the JAX kernel's entry order e = i·nnz + h (row i
ascending, hash h innermost); ``chip_smoke.py`` holds the CUDA kernel
bitwise against it on the card.  Here:

- the plain version is bitwise a numpy loop that adds the rows in that
  order, one rounding for the product and one for the sum;
- it stays within 1e-5 (relative to the largest output) of the JAX
  kernel in interpret mode, which contracts the same adds into FMAs;
- pass 1's plain version (``scatter_partition_plain``) is bitwise
  numpy's stable argsort on the bucket;
- a numpy replica of the CUDA kernels' index math (the LSD pass plan,
  count-table layout and prefix sums, tile geometry, ``seg_start``, the
  cut of buckets longer than ``_L`` into pieces and each piece's lookup)
  reproduces that order exactly, for S from 1 to 2^24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.sketch import pallas_window
from libskylark_tpu_torch.sketch import kernels_window as kw

pytestmark = pytest.mark.kernels


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _inputs(rng, k, s, m, nnz):
    A = rng.standard_normal((k, m)).astype(np.float32)
    b = rng.integers(0, s, (nnz, k)).astype(np.int32)
    v = rng.standard_normal((nnz, k)).astype(np.float32)
    return A, b, v


def _in_order(A, b, v, s):
    """out[b[h, i]] += v[h, i] * A[i] for i ascending, h innermost, in f32;
    buckets outside [0, s) are dropped."""
    out = np.zeros((s, A.shape[1]), np.float32)
    for i in range(A.shape[0]):
        for h in range(b.shape[0]):
            t = b[h, i]
            if 0 <= t < s:
                out[t] = out[t] + v[h, i] * A[i]
    return out


@pytest.mark.parametrize("nnz", [1, 3])
@pytest.mark.parametrize("m", [1, 40])
def test_plain_is_the_in_order_sum_bitwise(rng, nnz, m):
    k, s = 3000, 37
    A, b, v = _inputs(rng, k, s, m, nnz)
    out = kw.scatter_rows_plain(torch.from_numpy(A), torch.from_numpy(b),
                                torch.from_numpy(v), s)
    np.testing.assert_array_equal(out.numpy(), _in_order(A, b, v, s))
    acc = rng.standard_normal((s, m)).astype(np.float32)
    fused = kw.scatter_rows_plain(torch.from_numpy(A), torch.from_numpy(b),
                                  torch.from_numpy(v), s, acc=torch.from_numpy(acc))
    np.testing.assert_array_equal(fused.numpy(), acc + _in_order(A, b, v, s))


@pytest.mark.parametrize("acc", [False, True])
def test_plain_drops_buckets_out_of_range(rng, acc):
    """As the kernel does: buckets [0, 1, 5, -1] into 2 give bitwise the
    result of the first two entries alone; with 1 % of the buckets out of
    range on both sides (nnz = 3), bitwise the in-order sum of the kept
    entries.  The acc fold stays acc + out."""
    A = rng.standard_normal((4, 6)).astype(np.float32)
    v = rng.standard_normal((1, 4)).astype(np.float32)
    b = np.array([[0, 1, 5, -1]], np.int32)
    acc2 = torch.from_numpy(rng.standard_normal((2, 6)).astype(np.float32)) if acc else None
    out = kw.scatter_rows_plain(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(v),
                                2, acc=acc2)
    kept = kw.scatter_rows_plain(torch.from_numpy(A[:2]), torch.from_numpy(b[:, :2]),
                                 torch.from_numpy(v[:, :2]), 2, acc=acc2)
    assert torch.equal(out, kept)
    k, s, m = 3000, 37, 40
    A, b, v = _inputs(rng, k, s, m, 3)
    bad = rng.choice(b.size, b.size // 100, replace=False)
    b.flat[bad] = np.array([-1, s, -(1 << 31), (1 << 31) - 1])[np.arange(bad.size) % 4]
    accs = rng.standard_normal((s, m)).astype(np.float32) if acc else None
    out = kw.scatter_rows(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(v), s,
                          acc=None if accs is None else torch.from_numpy(accs))
    ref = _in_order(A, b, v, s)
    np.testing.assert_array_equal(out.numpy(), ref if accs is None else accs + ref)


@pytest.mark.parametrize("nnz", [1, 3])
def test_plain_bf16_rows_match_pallas(rng, nnz):
    k, s, m = 1000, 96, 200
    A, b, v = _inputs(rng, k, s, m, nnz)
    A16 = torch.from_numpy(A).to(torch.bfloat16)
    ref = pallas_window.scatter_rows(jnp.asarray(A16.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(b), jnp.asarray(v), s, interpret=True)
    out = kw.scatter_rows(A16, torch.from_numpy(b), torch.from_numpy(v), s)
    assert _rel(out, ref) <= 1e-5
    # bf16 rows are exact in f32: the same sum as the f32 copy's.
    assert torch.equal(out, kw.scatter_rows(A16.float(), torch.from_numpy(b),
                                            torch.from_numpy(v), s))


def _buckets(rng, kind, nnz, k, s):
    if kind == "random":
        return rng.integers(0, s, (nnz, k)).astype(np.int32)
    if kind == "one":
        return np.full((nnz, k), s - 1, np.int32)
    # 1 % out of range on both sides (and at the int32 ends), half of the
    # rest in one hot bucket.
    b = rng.integers(0, s, (nnz, k)).astype(np.int64)
    b.flat[rng.choice(b.size, b.size // 2, replace=False)] = s // 2
    bad = rng.choice(b.size, max(1, b.size // 100), replace=False)
    b.flat[bad] = np.array([-1, s, -(1 << 31), (1 << 31) - 1])[np.arange(bad.size) % 4]
    return b.astype(np.int32)


def _stable_order(b, s):
    """Entries e = i * nnz + h with buckets in range, stably by bucket."""
    flat = b.T.reshape(-1)
    keep = np.flatnonzero((flat >= 0) & (flat < s))
    return keep[np.argsort(flat[keep], kind="stable")]


@pytest.mark.parametrize("kind", ["random", "one", "adversarial"])
@pytest.mark.parametrize("nnz,k,s", [(1, 20000, 2048), (3, 5000, 300), (4, 3000, 1)])
def test_partition_plain_is_the_stable_order(rng, kind, nnz, k, s):
    b = _buckets(rng, kind, nnz, k, s)
    order = _stable_order(b, s)
    bt = torch.from_numpy(b)
    sk, se, ss = kw.scatter_partition_plain(bt, s)
    assert sk.dtype == se.dtype == ss.dtype == torch.int32
    assert tuple(sk.shape) == tuple(se.shape) == (nnz * k,) and tuple(ss.shape) == (s + 1,)
    n = order.size
    flat = b.T.reshape(-1)
    np.testing.assert_array_equal(se[:n].numpy(), order)
    np.testing.assert_array_equal(sk[:n].numpy(), flat[order])
    np.testing.assert_array_equal(ss.numpy(), np.searchsorted(flat[order], np.arange(s + 1)))
    # On CPU tensors the public pass 1 is its plain version; (k,) is nnz = 1.
    for x, y in zip(kw.scatter_partition(bt, s), (sk, se, ss)):
        assert torch.equal(x, y)
    if nnz == 1:
        for x, y in zip(kw.scatter_partition(bt[0], s), (sk, se, ss)):
            assert torch.equal(x, y)


def _excl(cum, i):
    return np.where(i > 0, cum[np.maximum(i - 1, 0)], 0)


def _emulate_partition(b, s):
    """The kernels' pass 1 in numpy, index for index as in csrc/window.cu:
    LSD passes over 2048-entry tiles, each count table digit-major
    (digit d of tile t at d * tiles + t), prefixed, each tile placed
    stably from its offsets; then seg_start and the piece counts."""
    nnz, k = b.shape
    E = nnz * k
    plan = kw._plan(E, s)
    tile = kw._TILE
    flat = b.T.reshape(-1).astype(np.int64)
    keys = np.where((flat >= 0) & (flat < s), flat, -1)
    ents = np.arange(E)
    n = E
    for shift, nd in plan.digits:
        dig = np.where(keys[:n] >= 0, (keys[:n] >> shift) & (nd - 1), -1)
        counts = np.zeros(nd * plan.tiles, np.int64)
        for t in range(plan.tiles):
            d = dig[t * tile:(t + 1) * tile]
            counts[np.arange(nd) * plan.tiles + t] = np.bincount(d[d >= 0], minlength=nd)
        cum = np.cumsum(counts)
        out_keys, out_ents = np.full(E, -1), np.full(E, -1)
        for t in range(plan.tiles):
            lo, hi = t * tile, min(n, (t + 1) * tile)
            d, kk, ee = dig[lo:hi], keys[lo:hi], ents[lo:hi]
            keep = d >= 0
            d, kk, ee = d[keep], kk[keep], ee[keep]
            order = np.argsort(d, kind="stable")
            ds = d[order]
            start = np.concatenate([[0], np.cumsum(np.bincount(ds, minlength=nd))])
            at = _excl(cum, np.arange(nd) * plan.tiles + t)
            dst = at[ds] - start[ds] + np.arange(ds.size)
            out_keys[dst], out_ents[dst] = kk[order], ee[order]
        n = int(cum[-1])
        keys, ents = out_keys, out_ents
    seg_start = np.searchsorted(keys[:n], np.arange(s + 1), side="left")
    lens = np.diff(seg_start)
    pieces = np.maximum(1, lens // kw._L + (lens % kw._L != 0))
    return ents[:n], seg_start, pieces


def _emulate_pieces(seg_start, pieces, blocks):
    """find_piece for each block index: (bucket, lo, hi, whole, slot)."""
    L = kw._L
    piece_cum = np.cumsum(pieces)
    blocks = blocks[blocks < piece_cum[-1]]
    t = np.searchsorted(piece_cum, blocks, side="right")  # first t with cum > b
    first = _excl(piece_cum, t)
    p = blocks - first
    lo = seg_start[t] + p * L
    hi = np.minimum(seg_start[t + 1], lo + L)
    return t, lo, hi, pieces[t] == 1, np.where(p > 0, first - t + p - 1, -1)


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("s", [1, 2, 37, 256, 257, 2048, 65537, 1 << 24])
@pytest.mark.parametrize("nnz,k", [(1, 20000), (3, 7001)])
def test_index_math_gives_the_stable_order_and_pieces(rng, kind, s, nnz, k):
    b = _buckets(rng, kind, nnz, k, s)
    ents, seg_start, pieces = _emulate_partition(b, s)
    sk, se, ss = kw.scatter_partition_plain(torch.from_numpy(b), s)
    np.testing.assert_array_equal(ents, se[:ents.size].numpy())
    np.testing.assert_array_equal(seg_start, ss.numpy())
    plan = kw._plan(b.size, s)
    assert pieces.sum() <= plan.pieces
    # Pass 2's lookup over the pieces of the non-empty buckets and the
    # first and last blocks (all blocks for S up to 2^20): every bucket's
    # list is covered once, in order, by pieces of at most L entries; the
    # pieces after the first of a cut bucket have distinct workspace slots
    # below plan.parts.
    piece_cum = np.cumsum(pieces)
    busy = np.flatnonzero(np.diff(seg_start) > 0)
    if s <= 1 << 20:
        blocks = np.arange(plan.pieces)
    else:
        blocks = np.concatenate([np.arange(a, z) for a, z in
                                 zip(_excl(piece_cum, busy), piece_cum[busy])]
                                + [np.arange(8), plan.pieces - 1 - np.arange(8)])
    t, lo, hi, whole, slot = _emulate_pieces(seg_start, pieces, blocks)
    assert np.all(hi - lo <= kw._L) and np.all(lo <= hi)
    for bucket in busy:
        sel = t == bucket
        assert lo[sel][0] == seg_start[bucket] and hi[sel][-1] == seg_start[bucket + 1]
        np.testing.assert_array_equal(lo[sel][1:], hi[sel][:-1])
    cut = ~whole & (slot >= 0)
    assert np.unique(slot[cut]).size == cut.sum() and np.all(slot[cut] < plan.parts)
    if kind == "adversarial" and nnz * k > 2 * kw._L:
        assert cut.any()  # the hot bucket is cut


def _check_plan(E, S):
    plan = kw._plan(E, S)
    bits = (S - 1).bit_length()
    # LSD passes, low bits first, each at most 8 bits and a power-of-two
    # digit count, together exactly the bucket's bits.
    assert 1 <= len(plan.digits) <= 4
    shift_end = 0
    for shift, nd in plan.digits:
        assert shift == shift_end and 1 <= nd <= 256 and nd & (nd - 1) == 0
        shift_end += nd.bit_length() - 1
    assert shift_end == bits and S <= 1 << shift_end
    # The count table stays bounded whatever S: digits x tiles <= E / 8 + 256.
    assert plan.tiles * kw._TILE >= E > (plan.tiles - 1) * kw._TILE
    for _, nd in plan.digits:
        assert nd * plan.tiles <= E // 8 + 256
    assert plan.pieces == S + E // kw._L and plan.parts == max(1, E // kw._L)
    return plan


@pytest.mark.parametrize("E,S", [
    (1 << 20, 2048),          # the LS path: A (2^20, 512) and b (2^20, 1) into 2048
    (4 << 18, 2048),          # SJLT nnz = 4 over 2^18 rows
    (1 << 20, 1), (1000, 2), (2049, 257), (1 << 26, 1 << 24),
    ((1 << 31) - 2049, (1 << 31) - 2),
])
def test_plan_invariants(E, S):
    plan = _check_plan(E, S)
    if S == 2048:
        assert plan.digits == ((0, 64), (6, 32)) and plan.tiles == -(-E // kw._TILE)


def test_plan_invariants_over_every_bucket_width():
    """S from 1 to 2^24: every bit width, with its edges."""
    sizes = set(range(1, 300)) | {(1 << p) + d for p in range(9, 25) for d in (-1, 0, 1)}
    for S in sorted(sizes):
        for E in (1, 50_000, 1 << 20):
            _check_plan(E, S)


def test_shared_header_is_part_of_the_build_hash(tmp_path, monkeypatch):
    """window.cu and scatter.cu include csrc/stage.cuh: a change to it
    must rebuild both libraries."""
    from libskylark_tpu_torch import _build

    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert '#include "stage.cuh"' in (tmp_path / "window.cu").read_text()
    assert '#include "stage.cuh"' in (tmp_path / "scatter.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    with open(tmp_path / "stage.cuh", "a") as f:
        f.write("\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(before[name] != after[name] for name in _build.SOURCES)
