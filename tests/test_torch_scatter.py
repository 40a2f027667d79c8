"""The port's flat segment sum against the JAX package's Pallas kernel.

On the CPU ``kernels_scatter.segment_sum_flat`` takes its plain version
(an f32 ``index_add_``); the CUDA kernel is held against the same plain
version on the card by ``chip_smoke.py``.  The JAX side runs the real
two-pass kernel bodies with ``interpret=True``, as
``tests/test_pallas_scatter.py`` does, at sizes past its gate (nnz ≥
8192, T ≥ 1024).  Tolerance: 1e-5 relative, the kernel's ``self_check``
bar (sums in another order); exactly 0 for dyadic values, whose sums are
exact in any order.

Pass 1 (``partition``) is held exactly: its plain version against
numpy's stable argsort on ``key // V``, and a numpy replica of the CUDA
kernels' two-level index math (count-table layouts, prefix sums, tile
geometry from ``_plan``) against that plain version.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.sketch import pallas_scatter
from libskylark_tpu_torch import _build
from libskylark_tpu_torch.sketch import kernels_scatter

pytestmark = pytest.mark.kernels

DTYPES = {
    "f32": (torch.float32, jnp.float32),
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "f16": (torch.float16, jnp.float16),
}


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _keys(rng, kind, nnz, T):
    if kind == "random":
        return rng.integers(0, T, nnz).astype(np.int32)
    # Partition edges of the JAX plan and of the port's V-slot partitions,
    # and one hot slot taking half the entries.
    _, _, V = pallas_scatter._plan(nnz, T)
    Vt = kernels_scatter._V
    edges = np.unique(np.array([0, V - 1, V, 2 * V - 1, Vt - 1, Vt, T - 1]) % T)
    keys = np.concatenate([
        np.repeat(edges, 50).astype(np.int32),
        np.full(nnz // 2, min(V + 7, T - 1), np.int32),
    ])
    return np.concatenate([keys, rng.integers(0, T, nnz - keys.size)]).astype(np.int32)


def _run(rng, kind, nnz, T, dtype, dyadic):
    keys = _keys(rng, kind, nnz, T)
    if dyadic:
        vals = rng.choice([-1.0, -0.5, 0.5, 1.0], nnz).astype(np.float32)
    else:
        vals = rng.standard_normal(nnz).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    ref = pallas_scatter.segment_sum_flat(jnp.asarray(vals, jdt), jnp.asarray(keys), T,
                                          interpret=True)
    out = kernels_scatter.segment_sum_flat(torch.from_numpy(vals).to(tdt),
                                           torch.from_numpy(keys), T)
    assert out.dtype == tdt and tuple(out.shape) == (T,)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind,nnz,T", [
    ("random", 8193, 1024),       # one entry past the JAX chunk boundary
    ("random", 20000, 200000),    # sparse slots, several partitions
    ("adversarial", 16384, 40000),
])
def test_plain_matches_pallas_interpret(rng, kind, nnz, T, dtype):
    out, ref = _run(rng, kind, nnz, T, dtype, dyadic=False)
    # bf16/f16 inputs are exact in f32; both sides round the f32 sum once.
    tol = 1e-5 if dtype == "f32" else float(torch.finfo(DTYPES[dtype][0]).eps)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dyadic_values_bitwise(rng, dtype):
    out, ref = _run(rng, "adversarial", 16384, 40000, dtype, dyadic=True)
    np.testing.assert_array_equal(out, ref)


def test_small_case_and_dropped_nothing(rng):
    keys = rng.integers(0, 37, 100).astype(np.int32)
    vals = rng.standard_normal(100).astype(np.float32)
    out = kernels_scatter.segment_sum_flat(torch.from_numpy(vals), torch.from_numpy(keys), 37)
    ref = np.zeros(37, np.float64)
    np.add.at(ref, keys, vals.astype(np.float64))
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_drops_keys_out_of_range(rng, dtype):
    """As the kernel does: keys [0, 1, 5, -1] into 2 give bitwise the sum
    of the first two entries alone; with 1 % of the keys out of range on
    both sides (and at the int32 ends), bitwise the sum of the kept
    entries, in input order."""
    tdt = DTYPES[dtype][0]
    vals = torch.from_numpy(rng.standard_normal(4).astype(np.float32)).to(tdt)
    keys = torch.tensor([0, 1, 5, -1], dtype=torch.int32)
    out = kernels_scatter.segment_sum_flat_plain(vals, keys, 2)
    assert out.dtype == tdt
    assert torch.equal(out, kernels_scatter.segment_sum_flat_plain(vals[:2], keys[:2], 2))
    nnz, T = 20000, 3000
    keys = rng.integers(0, T, nnz).astype(np.int64)
    bad = rng.choice(nnz, nnz // 100, replace=False)
    keys[bad] = np.array([-1, T, -(1 << 31), (1 << 31) - 1])[np.arange(bad.size) % 4]
    vals = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32)).to(tdt)
    keys = torch.from_numpy(keys.astype(np.int32))
    keep = (keys >= 0) & (keys < T)
    out = kernels_scatter.segment_sum_flat(vals, keys, T)  # a CPU tensor: the plain version
    assert torch.equal(out, kernels_scatter.segment_sum_flat_plain(vals[keep], keys[keep], T))


@pytest.mark.parametrize("nnz,T", [
    (100, 37), (10_000_000, 102_400_000), (69_000_000, 127_934_784), (1000, (1 << 31) - 1),
    (1, 1),
    (69_362_378, 127_934_784),    # the graph path: com-LiveJournal scale, SJLT(n, 32)
], ids=["small", "sparse-sketch", "graph-approx", "int32-T", "one", "graph"])
def test_plan_invariants(nnz, T):
    plan = kernels_scatter._plan(nnz, T)
    V, tile = kernels_scatter._V, kernels_scatter._TILE
    assert plan.parts * V >= T > (plan.parts - 1) * V
    # Level-1 tiles cover the entries; at most 256 coarse buckets of 2^shift
    # slots, a multiple of V, cover the slots; F fine digits per bucket.
    assert plan.tiles1 * tile >= nnz > (plan.tiles1 - 1) * tile
    assert plan.buckets <= kernels_scatter._MAX_BUCKETS
    assert (plan.buckets << plan.shift) >= T > ((plan.buckets - 1) << plan.shift)
    assert (1 << plan.shift) % V == 0 and plan.fine == (1 << plan.shift) // V <= 512
    assert plan.buckets * plan.fine >= plan.parts
    # Level-2 tiles never cross a bucket: whatever the bucket sizes, the
    # max(1, ceil(n_b / tile)) tiles of each bucket fit in tiles2.
    nb = plan.buckets
    for sizes in ([nnz] + [0] * (nb - 1), [nnz // nb] * (nb - 1) + [nnz - nnz // nb * (nb - 1)],
                  [tile + 1] * min(nb, nnz // (tile + 1)) + [0] * nb):
        assert sum(max(1, -(-n // tile)) for n in sizes[:nb]) <= plan.tiles2
    # Count tables: at most 1/32 of an int per entry, plus a bucket term.
    assert plan.buckets * plan.tiles1 <= nnz // 32 + kernels_scatter._MAX_BUCKETS
    assert plan.fine * plan.tiles2 <= nnz // 16 + 512 * (kernels_scatter._MAX_BUCKETS + 1)


def _partition_keys(rng, kind, nnz, T):
    if kind == "random":
        return rng.integers(0, T, nnz).astype(np.int32)
    # Partition and coarse-bucket edges, one hot slot with half the entries,
    # and keys out of range on both sides.
    plan = kernels_scatter._plan(nnz, T)
    V, B = kernels_scatter._V, 1 << plan.shift
    edges = np.unique(np.array([0, V - 1, V, 2 * V - 1, B - 1, B, B + V, T - 1]) % T)
    out = np.array([-1, -V, T, T + 5, -(1 << 31), (1 << 31) - 1], np.int64)
    keys = np.concatenate([np.repeat(edges, 1 + nnz // 1000), np.repeat(out, 1 + nnz // 1600),
                           np.full(nnz // 2, min(V + 7, T - 1))])
    keys = np.concatenate([keys, rng.integers(0, T, nnz - keys.size)]).astype(np.int32)
    rng.shuffle(keys)
    return keys


def _stable_order(keys, T):
    """Indices of the entries in range, stably by key // V (numpy)."""
    keep = np.flatnonzero((keys >= 0) & (keys < T))
    return keep[np.argsort(keys[keep] // kernels_scatter._V, kind="stable")]


def _emulate_partition(keys, T):
    """The kernels' two-level pass 1 in numpy, index for index as in
    csrc/scatter.cu (count tables, their prefix sums, tile geometry):
    returns the entry each output position holds and part_start."""
    plan = kernels_scatter._plan(keys.size, T)
    tile, V, nb, F = kernels_scatter._TILE, kernels_scatter._V, plan.buckets, plan.fine

    def excl(cum, i):
        return np.where(i > 0, cum[np.maximum(i - 1, 0)], 0)

    def place(ids, digits, nd, col, stride, cum, out):
        """One tile: stage stably by digit, write each run from its offset."""
        staged = ids[np.argsort(digits, kind="stable")]
        d = np.sort(digits, kind="stable")
        start = np.concatenate([[0], np.cumsum(np.bincount(d, minlength=nd))])
        at = excl(cum, col + np.arange(nd) * stride)
        out[at[d] - start[d] + np.arange(d.size)] = staged
        return at

    # Level 1: tile k's count of bucket b sits at b * tiles1 + k.
    dig = np.where((keys >= 0) & (keys < T), keys.astype(np.int64) >> plan.shift, -1)
    counts1 = np.zeros(nb * plan.tiles1, np.int64)
    for k in range(plan.tiles1):
        d = dig[k * tile:(k + 1) * tile]
        counts1[np.arange(nb) * plan.tiles1 + k] = np.bincount(d[d >= 0], minlength=nb)
    cum1 = np.cumsum(counts1)
    order1 = np.full(keys.size, -1)
    for k in range(plan.tiles1):
        ids = np.arange(k * tile, min(keys.size, (k + 1) * tile))
        ids = ids[dig[ids] >= 0]
        place(ids, dig[ids], nb, k, plan.tiles1, cum1, order1)
    # Level 2: bucket b is cut into its own tiles, numbered from tile_off[b];
    # tile t's count of digit f sits at tile_off[b] * F + f * ntiles[b] + t.
    bstart = excl(cum1, np.arange(nb + 1) * plan.tiles1)
    ntiles = np.maximum(1, -(-np.diff(bstart) // tile))
    tile_off = np.concatenate([[0], np.cumsum(ntiles)])
    assert tile_off[-1] <= plan.tiles2
    fd = (keys[order1[:bstart[-1]]].astype(np.int64) >> 14) & (F - 1)
    geometry = []
    counts2 = np.zeros(F * plan.tiles2, np.int64)
    for blk in range(tile_off[-1]):
        b = int(np.searchsorted(tile_off, blk, side="right")) - 1
        t = blk - tile_off[b]
        lo, hi = bstart[b] + t * tile, min(bstart[b] + (t + 1) * tile, bstart[b + 1])
        assert bstart[b] <= lo <= hi <= bstart[b + 1]        # inside its bucket
        geometry.append((b, t, lo, hi))
        col = tile_off[b] * F + t
        counts2[col + np.arange(F) * ntiles[b]] = np.bincount(fd[lo:hi], minlength=F)
    cum2 = np.cumsum(counts2)
    order2 = np.full(keys.size, -1)
    part_start = np.full(plan.parts + 1, -1)
    for b, t, lo, hi in geometry:
        at = place(order1[lo:hi], fd[lo:hi], F, tile_off[b] * F + t, ntiles[b], cum2, order2)
        if t == 0:
            p = b * F + np.arange(F)
            part_start[p[p < plan.parts]] = at[p < plan.parts]
    part_start[plan.parts] = bstart[-1]
    return order2[:bstart[-1]], part_start


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("nnz,T", [
    (50_000, 40_000_000),    # 7 level-1 tiles, 153 buckets of 16 partitions
    (20_000, 3_000_000),     # one partition per bucket (F = 1)
    (300, 37),               # one bucket, one partition
])
def test_partition_plain_is_the_stable_order(rng, kind, nnz, T):
    keys = _partition_keys(rng, kind, nnz, T)
    vals = rng.standard_normal(nnz).astype(np.float32)
    order = _stable_order(keys, T)
    sk, sv, ps = kernels_scatter.partition_plain(torch.from_numpy(vals).to(torch.bfloat16),
                                                 torch.from_numpy(keys), T)
    P = -(-T // kernels_scatter._V)
    assert sk.dtype == torch.int32 and sv.dtype == torch.float32 and ps.dtype == torch.int32
    assert tuple(sk.shape) == tuple(sv.shape) == (nnz,) and tuple(ps.shape) == (P + 1,)
    n = order.size
    np.testing.assert_array_equal(sk[:n].numpy(), keys[order])
    np.testing.assert_array_equal(
        sv[:n].numpy(), torch.from_numpy(vals[order]).to(torch.bfloat16).float().numpy())
    ref = np.searchsorted(keys[order] // kernels_scatter._V, np.arange(P + 1))
    np.testing.assert_array_equal(ps.numpy(), ref)


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("nnz,T", [(50_000, 40_000_000), (20_000, 3_000_000), (300, 37)])
def test_two_level_index_math_gives_the_stable_order(rng, kind, nnz, T):
    keys = _partition_keys(rng, kind, nnz, T)
    order, part_start = _emulate_partition(keys, T)
    sk, _, ps = kernels_scatter.partition_plain(torch.zeros(nnz), torch.from_numpy(keys), T)
    np.testing.assert_array_equal(order, _stable_order(keys, T))
    np.testing.assert_array_equal(part_start, ps.numpy())


def test_partition_takes_its_plain_version_on_cpu(rng):
    keys = torch.from_numpy(_partition_keys(rng, "adversarial", 20_000, 3_000_000))
    vals = torch.from_numpy(rng.standard_normal(20_000).astype(np.float32))
    for a, b in zip(kernels_scatter.partition(vals, keys, 3_000_000),
                    kernels_scatter.partition_plain(vals, keys, 3_000_000)):
        assert torch.equal(a, b)


def test_cpu_tensors_do_not_count_launches():
    before = kernels_scatter.segment_sum_flat.launches
    kernels_scatter.segment_sum_flat(torch.ones(10), torch.zeros(10, dtype=torch.int32), 3)
    assert kernels_scatter.segment_sum_flat.launches == before


def test_scatter_source_is_built_and_every_entry_declared():
    assert "scatter" in _build.SOURCES
    assert _build.library_path("scatter").name.startswith("libscatter-")
    text = (Path(_build.__file__).parent / "csrc" / "scatter.cu").read_text()
    exported = {line.split("(")[0].split()[-1] for line in text.splitlines()
                if line.startswith("int skylark_")}
    assert exported == set(kernels_scatter._SIGNATURES)
