"""The count functions against hand counts at the three cells' shapes."""

import math

import pytest

from benchmark import counts

M, N, S = 50_000, 500, 2000


def test_peaks_are_the_published_ones():
    assert counts.PEAKS["bf16_flops_per_s"] == 989e12
    assert counts.PEAKS["f32_flops_per_s"] == 67e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_fjlt_sketch_of_the_ls_cell():
    w = counts.sketch_columnwise("FJLT", M, N, S)
    assert w.bytes == M * N * 4 + S * N * 4 == 104_000_000
    assert w.flops == 65536 * 16 * N  # NB = 2^16
    assert w.bound() == "bytes"
    assert w.least_s() == pytest.approx(104_000_000 / 3.35e12)  # 0.0310 ms


def test_cwt_sketch_of_the_ls_cell():
    w = counts.sketch_columnwise("CWT", M, N, S)
    assert w.bytes == 104_000_000 and w.flops == 2 * M * N
    assert w.least_s() == pytest.approx(3.1045e-5, rel=1e-4)


def test_gather_of_the_fjlt_cell():
    a = counts.gather_scaled_rows(M, N, S)          # A's sampled rows
    assert a.bytes == 2 * S * N * 4 + 4 * S == 8_008_000
    b = counts.gather_scaled_rows(M, 1, S)          # b's
    assert b.bytes == 2 * S * 4 + 4 * S == 24_000
    # PERF.md's kernel table at 2^20 x 512: 0.0025 ms.
    assert counts.gather_scaled_rows(2 ** 20, 512, 2048).least_s() * 1e3 == pytest.approx(
        0.0025, abs=1e-4)


def test_scatter_of_the_cwt_cell():
    a = counts.scatter_rows(M, N, S)
    assert a.bytes == M * N * 4 + 8 * M + 4 * S * N == 104_400_000
    assert a.flops == 2 * M * N
    # PERF.md's kernel table at 2^20 x 512 -> 2048: 0.645 ms.
    assert counts.scatter_rows(2 ** 20, 512, 2048).least_s() * 1e3 == pytest.approx(
        0.645, abs=1e-3)


def test_rfut_kernels():
    w = counts.rfut_rowwise(131072, 4096, 4096)
    assert w.bytes == (131072 * 4096 * 2 + 4096) * 4
    assert w.least_s() * 1e3 == pytest.approx(1.282, abs=1e-3)  # PERF.md's bound
    ws = counts.rfut_rowwise_sampled(131072, 4096, 4096, 1024)
    assert ws.least_s() * 1e3 == pytest.approx(0.801, abs=1e-3)
    assert counts.segment_sum_flat(10 ** 7, 1024 * 10 ** 5).bytes == 8e7 + 4 * 1.024e8


def test_lsqr_step_reads_a_twice():
    w = counts.lsqr_step(M, N)
    assert w.bytes == 2 * M * N * 4 + 2 * M * 4 == 200_400_000
    assert w.least_s() * 1e3 == pytest.approx(0.059821, abs=1e-5)


def test_panel_features_of_the_krr_cell():
    w = counts.rft_panel(125_000, 4096, 2048)
    assert w.flops == 2 * 125_000 * 4096 * 2048
    assert w.least_s() * 1e3 == pytest.approx(2.1205, abs=1e-3)  # flops-bound
    assert w.bound() == "flops"
    assert w.bytes * 1e3 / 3.35e12 == pytest.approx(0.46, abs=0.01)


def test_krr_fit_least_work():
    w = counts.krr_fit(7_500_000, 4096, 2048, 3)
    panel = 2.0 * 7_500_000 * 4096 * 2048
    assert w.flops == 3 * panel + 2.0 * 7_500_000 * 2048 ** 2
    assert w.least_s() == pytest.approx(w.flops / 989e12)
    assert 0.44 < w.least_s() < 0.46


def test_work_refuses_mixed_peaks():
    with pytest.raises(ValueError):
        counts.rft_panel(1, 1, 1) + counts.lsqr_step(1, 1)


def test_kernel_pricing_reads_recorded_shapes():
    call = {"kernel": "gather_scaled_rows", "T": (M, N), "idx": (S,), "itemsize": 4}
    assert counts.KERNELS["gather_scaled_rows"](call) == counts.gather_scaled_rows(M, N, S)
    call = {"kernel": "scatter_rows", "A": (M, N), "nnz": 1, "num_segments": S, "itemsize": 4}
    assert counts.KERNELS["scatter_rows"](call) == counts.scatter_rows(M, N, S)
    assert math.isclose(counts.next_pow2(3000), 4096)
