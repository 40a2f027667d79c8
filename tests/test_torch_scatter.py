"""The port's flat segment sum against the JAX package's Pallas kernel.

On the CPU ``kernels_scatter.segment_sum_flat`` takes its plain version
(an f32 ``index_add_``); the CUDA kernel is held against the same plain
version on the card by ``chip_smoke.py``.  The JAX side runs the real
two-pass kernel bodies with ``interpret=True``, as
``tests/test_pallas_scatter.py`` does, at sizes past its gate (nnz ≥
8192, T ≥ 1024).  Tolerance: 1e-5 relative, the kernel's ``self_check``
bar (sums in another order); exactly 0 for dyadic values, whose sums are
exact in any order.
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


def test_plan_keeps_count_table_small():
    for nnz, T in ((100, 37), (10_000_000, 102_400_000), (69_000_000, 127_934_784),
                   (1000, (1 << 31) - 1)):
        P, C, K = kernels_scatter._plan(nnz, T)
        assert P * kernels_scatter._V >= T > (P - 1) * kernels_scatter._V
        assert C % 32 == 0 and K * C >= nnz > (K - 1) * C
        assert P * K <= max(nnz // 2, P) + P


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
