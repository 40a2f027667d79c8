"""The plain reference against the port on the CPU: the counter stream
bit for bit, the FJLT on both of the port's routes, the feature map's
draws, and the blocked QR against a direct solve."""

import math

import pytest
import torch

from benchmark.reference import counter, kernel_ridge, least_squares

SEEDS = [0, 72, 2 ** 31 + 9, 2 ** 33 + 12345]
BASES = [0, 5, (1 << 32) - 3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("base", BASES)
def test_counter_stream_matches_the_port(seed, base):
    from libskylark_tpu_torch.core import random as R

    def port(dist, **k):
        return R.sample(dist, seed, base, 777, device="cpu", **k)

    assert torch.equal(counter.rademacher(seed, base, 777, "cpu", torch.float32),
                       port("rademacher", dtype=torch.float32))
    assert torch.equal(counter.uniform_int(seed, base, 777, (1 << 21) - 1, "cpu"),
                       port("uniform_int", dtype=torch.int64, low=0, high=(1 << 21) - 1))
    assert torch.equal(counter.normal_f32(seed, base, 777, "cpu"), port("normal"))
    assert torch.equal(counter.uniform01_f32(seed, base, 777, "cpu"), port("uniform"))


@pytest.mark.parametrize("gemm", ["0", "1"])
@pytest.mark.parametrize("m", [4096, 3000])
def test_fjlt_matches_the_port(m, gemm, monkeypatch):
    from libskylark_tpu_torch.core.context import SketchContext
    from libskylark_tpu_torch.sketch.base import create_sketch

    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", gemm)
    A = torch.randn(m, 24, generator=torch.Generator().manual_seed(1))
    ctx = SketchContext(seed=2 ** 32 + 77, counter=123)
    S = create_sketch("FJLT", m, 256, ctx)
    assert ctx.counter - 123 == m + 256          # the contract's budget
    got = S.apply(A, "columnwise").double()
    ref = least_squares.fjlt_columnwise(A, 2 ** 32 + 77, 123, 256, block_cols=7)
    assert float((got - ref).abs().max() / ref.abs().max()) < 2e-6


def test_rft_draws_match_the_port():
    from libskylark_tpu_torch.core.context import SketchContext
    from libskylark_tpu_torch.ml import GaussianKernel

    d, s = 96, 64
    ctx = SketchContext(seed=5, counter=40)
    fmap = GaussianKernel(d, 8.0).create_rft(s, "regular", ctx)
    assert ctx.counter - 40 == d * s + s
    W, shifts = kernel_ridge.rft_draws(5, 40, d, s, 8.0, "cpu")
    assert torch.equal(W, fmap.hoistable_operands(torch.bfloat16, "cpu"))
    assert torch.equal(shifts, fmap.shifts(torch.bfloat16, "cpu"))
    assert W.dtype == shifts.dtype == torch.bfloat16


def test_features_follow_the_bf16_recipe():
    g = torch.Generator().manual_seed(3)
    X = torch.randn(64, 32, generator=g).to(torch.bfloat16)
    W, shifts = kernel_ridge.rft_draws(9, 0, 32, 16, 8.0, "cpu")
    Z = kernel_ridge.features(X, W, shifts, 16)
    exact = math.sqrt(2 / 16) * torch.cos(X.double() @ W.double().T + shifts.double())
    assert Z.dtype == torch.bfloat16
    assert float((Z.double() - exact).abs().max()) < 0.1 * math.sqrt(2 / 16)


def test_blocked_qr_solves_least_squares():
    g = torch.Generator().manual_seed(4)
    A = torch.randn(1000, 12, generator=g)
    B = torch.randn(1000, 3, generator=g)
    R = least_squares.qr_augmented(A, B, block_rows=128)
    X, Ra = least_squares.solve_from_r(R, 12)
    direct = torch.linalg.lstsq(A.double(), B.double()).solution
    assert torch.allclose(X, direct, atol=1e-10)
    assert torch.allclose(Ra.T @ Ra, A.double().T @ A.double(), atol=1e-8)


def test_wht_is_the_sylvester_hadamard():
    X = torch.eye(256, dtype=torch.float64)
    H = least_squares.wht_rows(X)
    i = torch.arange(256)
    bits = (i[:, None] & i[None, :])
    parity = torch.zeros_like(bits)
    for k in range(8):
        parity ^= (bits >> k) & 1
    assert torch.equal(H, (1 - 2 * parity).double())
