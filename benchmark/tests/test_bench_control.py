"""The comparison that decides ``correct`` separates the program from
its control at a tiny size: the program reads under the limit and the
reference computed one precision lower (TF32 inputs for the float32
least squares, e4m3 cosines for the bf16 features) reads over it."""

import pytest
import torch

from benchmark.control import read_seed

from .tiny import CPU, SIZES, cell_inputs


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_program_passes_and_control_fails(cell):
    bench, cfg, mix = cell_inputs(cell)
    (limit,) = mix["limits"].values()
    for seed in (2 ** 31 + 101, 3):
        got = read_seed(bench, cell, seed, 0.3, True, CPU, cfg, mix)
        assert got["failed"] == 0 and got["requests"] > 0
        assert got["program"] <= limit, got
        assert got["control_min"] > limit, got
        assert got["control_min"] >= 3 * got["program"], got


def test_rounding_controls_round():
    from benchmark.reference.kernel_ridge import round_e4m3
    from benchmark.reference.least_squares import round_tf32

    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.0 - 2 ** -9])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, -3.0 - 2 ** -9]
    c = torch.tensor([0.3, -0.7], dtype=torch.bfloat16)
    assert round_e4m3(c).dtype == torch.bfloat16
    assert (round_e4m3(c).float() - c.float()).abs().max() > 0
