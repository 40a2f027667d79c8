"""Port vs JAX package: the mesh and its sharded values
(``parallel/mesh.py``).

- ``default_mesh`` factors n slots near-square exactly as the JAX
  package's does (n = 1 … 8, JAX on its 8 host devices, the port's
  slots on the CPU); without a card it raises unless a device is named.
- ``make_mesh`` takes the JAX axis names and shapes; several slots may
  share one device; ``explicit`` is recorded.
- ``shard`` and its helpers split an array into the blocks the JAX
  package's shardings give each device (compared shard by shard with
  ``addressable_shards``), ``fully_replicated`` gathers them back
  bitwise, ``shard_rows_padded`` pads to the mesh and returns ``n_orig``.
- ``psum`` adds in slot order (the left fold), ``psum_scatter`` is its
  blocks, ``all_to_all`` moves ``[src][dst]`` to ``dst``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu.parallel as J
from libskylark_tpu_torch import parallel as P
from libskylark_tpu_torch.parallel import mesh as M


def cpu_mesh(shape, names=(P.ROWS, P.COLS)):
    return P.make_mesh(shape, names, devices="cpu")


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_factors_as_jax(n):
    got = P.default_mesh(n, device="cpu")
    assert got.shape == dict(J.default_mesh(n).shape)
    assert got.axis_names == (P.ROWS, P.COLS) and got.size == n
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_default_mesh_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: default_mesh() is over the cards")
    with pytest.raises(RuntimeError, match="is_available"):
        P.default_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        P.make_mesh((1,), (P.ROWS,))
    assert P.default_mesh(device="cpu").shape == {P.ROWS: 1, P.COLS: 1}


def test_make_mesh_shapes_devices_and_flags():
    mesh = P.make_mesh((2, 3), ("r", "c"), devices=["cpu"] * 6, explicit=True)
    assert mesh.shape == {"r": 2, "c": 3} and mesh.size == 6 and mesh.explicit
    assert mesh.coords(4) == (1, 1)
    assert mesh.groups("r") == [[0, 3], [1, 4], [2, 5]]
    assert mesh.groups("c") == [[0, 1, 2], [3, 4, 5]]
    assert not cpu_mesh((2, 3)).explicit
    assert cpu_mesh((2, 3)) == P.make_mesh((2, 3), devices=torch.device("cpu"))
    with pytest.raises(ValueError, match="differ in length"):
        P.make_mesh((4,), devices="cpu")  # the default names are two
    with pytest.raises(ValueError, match="needs 4 devices"):
        P.make_mesh((4,), (P.ROWS,), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="distinct"):
        P.make_mesh((2, 2), ("r", "r"), devices="cpu")


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(3).standard_normal((16, 24))


def _jax_blocks(arr):
    """Each JAX device's block, in the mesh's flat device order."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in arr.sharding.mesh.devices.flat]


@pytest.mark.parametrize("which", ["rows", "cols", "replicate", "rows_cols", "cols_axis"])
def test_shard_blocks_are_jax_blocks(x, which):
    jmesh, tmesh = J.make_mesh((2, 4)), cpu_mesh((2, 4))
    xt = torch.from_numpy(x)
    jx = jnp.asarray(x)
    got, want = {
        "rows": (P.shard_rows(xt, tmesh), J.shard_rows(jx, jmesh)),
        "cols": (P.shard_cols(xt, tmesh), J.shard_cols(jx, jmesh)),
        "replicate": (P.replicate(xt, tmesh), J.replicate(jx, jmesh)),
        "rows_cols": (P.shard(xt, tmesh, P.ROWS, P.COLS), J.shard(jx, jmesh, J.ROWS, J.COLS)),
        "cols_axis": (P.shard(xt, tmesh, None, P.COLS), J.shard(jx, jmesh, None, J.COLS)),
    }[which]
    assert got.shape == tuple(want.shape) and got.spec == tuple(want.sharding.spec)
    for mine, theirs in zip(got.shards, _jax_blocks(want)):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    assert torch.equal(P.fully_replicated(got), xt)
    assert P.fully_replicated(xt) is xt  # a plain tensor passes through


def test_sharding_specs_and_constrain_rows(x):
    mesh = cpu_mesh((2, 4))
    assert P.row_sharding(mesh).spec == ((P.ROWS, P.COLS), None)
    assert P.row_sharding(cpu_mesh((8,), (P.ROWS,)), 3).spec == (P.ROWS, None, None)
    assert P.sharding(mesh, P.ROWS) == P.sharding(mesh, P.ROWS, None)
    with pytest.raises(ValueError, match="not in"):
        P.sharding(mesh, "nope")
    xt = torch.from_numpy(x)
    rows = P.constrain_rows(xt, mesh)
    assert rows.sharding == P.row_sharding(mesh) and P.constrain_rows(rows, mesh) is rows
    cols = P.shard_cols(xt, mesh)
    again = P.constrain_rows(cols, mesh)  # a reshard: gathered, then split by rows
    assert [torch.equal(a, b) for a, b in zip(again.shards, rows.shards)] == [True] * 8
    with pytest.raises(ValueError, match="not divisible"):
        P.shard_rows(xt[:13], mesh)
    one = P.shard_rows(xt, cpu_mesh((1,), (P.ROWS,)))
    assert one.shards[0].data_ptr() == xt.data_ptr()  # a mesh of one holds x itself


@pytest.mark.parametrize("n", [16, 13, 9, 1])
def test_shard_rows_padded_pads_and_returns_n_orig(x, n):
    mesh = cpu_mesh((2, 4))
    xs = torch.from_numpy(x[:n])
    got, n_orig = P.shard_rows_padded(xs, mesh, pad_value=-1.0)
    want, jn = J.shard_rows_padded(jnp.asarray(x[:n]), J.make_mesh((2, 4)), pad_value=-1.0)
    assert n_orig == jn == n and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(P.fully_replicated(got).numpy(), np.asarray(want))
    assert torch.equal(P.fully_replicated(got)[:n], xs)


def test_psum_adds_in_slot_order():
    # 1 + 2^-53 + 2^-53 is 1 added left to right, 1 + 2^-52 right to left:
    # the order is visible in the bits.
    tiny = 2.0 ** -53
    parts = [torch.tensor([1.0], dtype=torch.float64), torch.tensor([tiny], dtype=torch.float64),
             torch.tensor([tiny], dtype=torch.float64)]
    assert M.psum(parts, "cpu").item() == (1.0 + tiny) + tiny == 1.0
    assert M.psum(parts[::-1], "cpu").item() == 1.0 + 2 * tiny
    one = torch.arange(3.0)
    assert M.psum([one], "cpu") is one  # a mesh of one: the value itself
    rows = [torch.arange(8.0).reshape(4, 2) * (k + 1) for k in range(2)]
    total = M.psum(rows, "cpu")
    blocks = M.psum_scatter(rows, ["cpu", "cpu"])
    assert torch.equal(torch.cat(blocks), total)
    with pytest.raises(ValueError, match="divisible"):
        M.psum_scatter([torch.zeros(3)] * 2, ["cpu", "cpu"])


def test_all_to_all_moves_src_dst_to_dst():
    p = 3
    bufs = [torch.tensor([[10 * s + d] for d in range(p)]) for s in range(p)]
    got = M.all_to_all(bufs, ["cpu"] * p)
    for d in range(p):
        assert got[d][:, 0].tolist() == [10 * s + d for s in range(p)]
    pairs = M.all_to_all([(b, -b) for b in bufs], ["cpu"] * p)
    assert all(torch.equal(a, -b) for a, b in pairs)

