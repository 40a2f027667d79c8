"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper takes its kernel's plain PyTorch version (the
CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``).  The JAX side runs the real Pallas
kernel bodies in ``interpret=True`` mode, as ``tests/test_pallas_fut.py``
and ``tests/test_pallas_window.py`` do.  Tolerances are the JAX
package's own: 1e-5 relative for the transforms and scatters (sums in
another order), exactly 0 for the scaled gather (pure selection plus
one identical multiply).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.sketch import fut as jax_fut
from libskylark_tpu.sketch import pallas_fut, pallas_window
from libskylark_tpu_torch import _build, _device
from libskylark_tpu_torch.sketch import kernels_fut, kernels_window

pytestmark = pytest.mark.kernels


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _signs(rng, n):
    return np.sign(rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("m,n,nb", [(16, 512, 512), (8, 300, 512), (8, 1000, 1024)])
def test_rfut_rowwise_plain_matches_pallas(rng, m, n, nb):
    x = rng.standard_normal((m, n)).astype(np.float32)
    d = _signs(rng, n)
    ref = pallas_fut.rfut_rowwise(jnp.asarray(x), jnp.asarray(d), nb,
                                  interpret=True)
    out = kernels_fut.rfut_rowwise(torch.from_numpy(x), torch.from_numpy(d), nb)
    assert out.shape == (m, nb) and out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-5


def test_rfut_rowwise_bf16_plain_matches_pallas(rng):
    x = rng.standard_normal((8, 512)).astype(np.float32)
    d = _signs(rng, 512)
    ref = pallas_fut.rfut_rowwise(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(d, jnp.bfloat16), 512,
                                  interpret=True)
    out = kernels_fut.rfut_rowwise(torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(d).bfloat16(), 512)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float(), np.asarray(ref, np.float32)) <= 1e-2


@pytest.mark.parametrize("n,s", [(512, 128), (300, 256)])
def test_rfut_rowwise_sampled_plain_matches_pallas(rng, n, s):
    m, nb = 16, 512
    x = rng.standard_normal((m, n)).astype(np.float32)
    d = _signs(rng, n)
    idx = rng.integers(0, nb, s).astype(np.int32)  # with duplicates
    ref = pallas_fut.rfut_rowwise_sampled(jnp.asarray(x), jnp.asarray(d), nb,
                                          idx, interpret=True)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    out = kernels_fut.rfut_rowwise_sampled(xt, dt, nb, torch.from_numpy(idx))
    assert out.shape == (m, s)
    assert _rel(out, ref) <= 1e-5
    # The JAX package's acceptance of the fused kernel (fjlt.py probe).
    base = kernels_fut.rfut_rowwise(xt, dt, nb)[:, idx] * np.sqrt(nb / s)
    assert _rel(out, base) <= 1e-5


@pytest.mark.parametrize("nb", [128, 256])
@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rfut_rowwise_plain_narrow_matches_jax_wht(rng, nb, pad, dtype):
    """NB = 128, 256 (the warp-per-row kernel's widths): the JAX Pallas
    kernel gates NB < 512 out, so its XLA ``wht`` of pad(x ⊙ d) is the
    reference, the product taken in x's dtype.  f32: 1e-5 relative;
    bf16: the plain version rounds the f32 transform once, so each
    element lies within one bf16 rounding (2^-8 relative) of the f32
    reference, plus the f32 transforms' 1e-5."""
    m, n = 9, nb - pad
    x = rng.standard_normal((m, n)).astype(np.float32)
    d = _signs(rng, n)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xd = (jnp.asarray(x, jdt) * jnp.asarray(d, jdt)).astype(jnp.float32)
    ref = np.asarray(jax_fut.wht(jnp.pad(xd, ((0, 0), (0, nb - n))), axis=1), np.float64)
    out = kernels_fut.rfut_rowwise(torch.from_numpy(x).to(tdt), torch.from_numpy(d).to(tdt), nb)
    assert out.shape == (m, nb) and out.dtype == tdt
    out = out.double().numpy()
    if dtype == "f32":
        assert _rel(out, ref) <= 1e-5
    else:
        assert np.all(np.abs(out - ref) <= 2.0 ** -8 * np.abs(ref) + 1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype,n,offset,bulk", [
    (torch.float32, 128, 0, True),      # aligned, 512-byte rows
    (torch.float32, 128, 1, False),     # a view one element past an aligned address
    (torch.float32, 125, 0, False),     # 500-byte rows: not whole 16-byte units
    (torch.float32, 252, 0, True),      # n < NB, rows of 1008 bytes
    (torch.bfloat16, 256, 0, True),
    (torch.bfloat16, 256, 1, False),
    (torch.bfloat16, 252, 0, False),    # 504-byte rows
    (torch.bfloat16, 120, 0, True),     # 240-byte rows
])
def test_rfut_bulk_copy_decision(dtype, n, offset, bulk):
    buf = torch.zeros(4 * n + 8, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    x = buf[offset:offset + 4 * n].view(4, n)
    assert kernels_fut.bulk_copies(x) is bulk


def test_rfut_gates():
    assert kernels_fut.supported(7, 4096, 4096)        # any row count
    assert kernels_fut.supported(1, 20000, 1 << 15)
    assert not kernels_fut.supported(8, 64, 64)        # below 128
    assert kernels_fut.supported(8, 100, 128)          # the smallest instance
    assert not kernels_fut.supported(8, 1 << 16, 1 << 16)
    assert not kernels_fut.supported(8, 600, 600)      # not a power of 2
    assert not kernels_fut.supported(8, 600, 512)      # n > nb
    assert kernels_fut.supported_sampled(3, 4096, 4096, 1024)
    assert not kernels_fut.supported_sampled(3, 4096, 4096, 1000)
    assert not kernels_fut.supported_sampled(3, 4096, 4096, 64)


@pytest.mark.parametrize("k,s,m,nnz", [
    (7, 12, 5, 1),        # tiny ragged block
    (130, 10, 1, 1),      # single column (the LS solve's b vector)
    (2048, 1000, 320, 1), # padding seams: S off every tile, m off 128
    (1000, 96, 200, 4),   # stacked hashes (SJLT nnz = 4)
])
def test_scatter_rows_plain_matches_pallas(rng, k, s, m, nnz):
    A = rng.standard_normal((k, m)).astype(np.float32)
    b = rng.integers(0, s, (nnz, k)).astype(np.int32)
    v = rng.standard_normal((nnz, k)).astype(np.float32)
    ref = pallas_window.scatter_rows(jnp.asarray(A), jnp.asarray(b),
                                     jnp.asarray(v), s, interpret=True)
    out = kernels_window.scatter_rows(torch.from_numpy(A), torch.from_numpy(b),
                                      torch.from_numpy(v), s)
    assert out.shape == (s, m) and out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-5


def test_scatter_rows_1d_is_nnz1(rng):
    A = torch.from_numpy(rng.standard_normal((300, 40)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 50, 300).astype(np.int32))
    v = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    assert torch.equal(kernels_window.scatter_rows(A, b, v, 50),
                       kernels_window.scatter_rows(A, b[None], v[None], 50))


def test_scatter_rows_acc_fold_bitwise(rng):
    k, s, m = 2048, 1000, 320
    A = rng.standard_normal((k, m)).astype(np.float32)
    b = rng.integers(0, s, (4, k)).astype(np.int32)
    v = rng.standard_normal((4, k)).astype(np.float32)
    acc = rng.standard_normal((s, m)).astype(np.float32)
    At, bt, vt, acct = map(torch.from_numpy, (A, b, v, acc))
    fused = kernels_window.scatter_rows(At, bt, vt, s, acc=acct)
    assert torch.equal(fused, acct + kernels_window.scatter_rows(At, bt, vt, s))
    ref = pallas_window.scatter_rows(jnp.asarray(A), jnp.asarray(b),
                                     jnp.asarray(v), s, acc=jnp.asarray(acc),
                                     interpret=True)
    assert _rel(fused, ref) <= 1e-5
    with pytest.raises(TypeError):
        kernels_window.scatter_rows(At, bt, vt, s, acc=acct.double())


@pytest.mark.parametrize("nrows,s,m,dtype", [
    pytest.param(300, 1000, 320, "float32", id="300-1000-320"),
    pytest.param(3000, 128, 5, "float32", id="3000-128-5"),
    pytest.param(3000, 2048, 1, "float32", id="3000-2048-1"),       # the LS solve's b
    pytest.param(300, 1000, 320, "bfloat16", id="300-1000-320-bf16"),
    pytest.param(3000, 2048, 1, "bfloat16", id="3000-2048-1-bf16"),
])
def test_gather_scaled_rows_plain_bitwise_pallas(rng, nrows, s, m, dtype):
    T = rng.standard_normal((nrows, m)).astype(np.float32)
    idx = rng.integers(0, nrows, s).astype(np.int32)
    # 0.3 is not a bf16 value: the scale is rounded to T's dtype on both sides.
    scale = 0.3125 if dtype == "float32" else 0.3
    ref = pallas_window.gather_scaled_rows(jnp.asarray(T, getattr(jnp, dtype)),
                                           jnp.asarray(idx), scale, interpret=True)
    out = kernels_window.gather_scaled_rows(
        torch.from_numpy(T).to(getattr(torch, dtype)), torch.from_numpy(idx), scale)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref).astype(np.float32))


def test_cpu_tensors_take_plain_versions_without_counting(rng):
    before = (kernels_fut.rfut_rowwise.launches,
              dict(kernels_fut.rfut_rowwise.launches_by_nb),
              kernels_fut.rfut_rowwise_sampled.launches,
              kernels_window.scatter_rows.launches,
              kernels_window.gather_scaled_rows.launches)
    x = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32))
    d = torch.ones(512)
    idx = torch.zeros(128, dtype=torch.int32)
    kernels_fut.rfut_rowwise(x, d, 512)
    kernels_fut.rfut_rowwise_sampled(x, d, 512, idx)
    kernels_window.scatter_rows(x.T.contiguous(), idx[:512 // 4].repeat(4), torch.ones(512), 3)
    kernels_window.gather_scaled_rows(x, idx[:4], 2.0)
    after = (kernels_fut.rfut_rowwise.launches,
             kernels_fut.rfut_rowwise.launches_by_nb,
             kernels_fut.rfut_rowwise_sampled.launches,
             kernels_window.scatter_rows.launches,
             kernels_window.gather_scaled_rows.launches)
    assert after == before


def test_build_command_targets_hopper(tmp_path):
    cmd = _build.nvcc_command("rfut", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/rfut.cu")
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert (Path(_build.__file__).parent / "csrc" / f"{name}.cu").exists()


def test_every_c_entry_is_declared():
    """Each wrapper module declares ctypes argtypes for exactly the C
    entries its source exports (an undeclared pointer would be cut to
    32 bits)."""
    csrc = Path(_build.__file__).parent / "csrc"
    for module, source in ((kernels_fut, "rfut.cu"), (kernels_window, "window.cu")):
        text = (csrc / source).read_text()
        exported = {
            line.split("(")[0].split()[-1]
            for line in text.splitlines()
            if line.startswith("int skylark_")
        }
        assert exported == set(module._SIGNATURES), source


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")
    with pytest.raises(RuntimeError, match="cuda"):
        _device.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        _device.as_tensor(np.zeros(3))  # the default device is cuda
    assert _device.as_tensor(np.zeros(3), "cpu").device.type == "cpu"
