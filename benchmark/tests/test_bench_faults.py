"""A run with its timed path broken underneath comes out not correct:
for each fault a cell can have (a state left unchanged, half of the rows
left out, an answer altered where it is made; no cell spans chips, so
no exchange can be left out), and correct without one."""

import pytest
import torch

from .tiny import run_tiny


def _half_rows_ls(monkeypatch):
    from libskylark_tpu_torch.linalg import least_squares as lsq

    real = lsq.approximate_least_squares

    def half(A, B, ctx, params=None, *a, **k):
        return real(A[:A.shape[0] // 2], B[:A.shape[0] // 2], ctx, params, *a, **k)

    monkeypatch.setattr(lsq, "approximate_least_squares", half)


def _altered_small_solve(monkeypatch):
    from libskylark_tpu_torch.linalg import least_squares as lsq

    real = lsq.exact_least_squares

    def altered(*a, **k):
        X = real(*a, **k).clone()
        X[0] += 1e-3 * X.abs().max()
        return X

    monkeypatch.setattr(lsq, "exact_least_squares", altered)


def _lsqr(monkeypatch, change):
    from libskylark_tpu_torch.solvers import accelerated

    real = accelerated.lsqr

    def broken(*a, **k):
        X, info = real(*a, **k)
        return change(X), info

    monkeypatch.setattr(accelerated, "lsqr", broken)


def _altered_lsqr(monkeypatch):
    def alter(X):
        X = X.clone()
        X[0] += 1e-3 * X.abs().max()
        return X

    _lsqr(monkeypatch, alter)


def _unchanged_lsqr(monkeypatch):
    _lsqr(monkeypatch, torch.zeros_like)   # x stays at LSQR's start


def _half_rows_krr(monkeypatch):
    from libskylark_tpu_torch import ml

    real = ml.streaming_kernel_ridge

    def half(kernel, block_fn, shape, Y, *a, **k):
        n = shape[0] // 2
        return real(kernel, block_fn, (n, shape[1]), Y[:n], *a, **k)

    monkeypatch.setattr(ml, "streaming_kernel_ridge", half)


def _altered_krr(monkeypatch):
    from libskylark_tpu_torch import ml

    real = ml.streaming_kernel_ridge

    def altered(*a, **k):
        model = real(*a, **k)
        model.W = model.W.clone()
        model.W[0] += 0.05 * model.W.abs().max()
        return model

    monkeypatch.setattr(ml, "streaming_kernel_ridge", altered)


def _unchanged_krr(monkeypatch):
    from libskylark_tpu_torch.ml import krr

    monkeypatch.setattr(krr, "_cho_solve", lambda L, B: torch.zeros_like(B))


FAULTS = [
    ("ls_sketch_fjlt", "half of the rows", _half_rows_ls),
    ("ls_sketch_fjlt", "answer altered", _altered_small_solve),
    ("ls_blendenpik_cwt", "half of the rows", _half_rows_ls),
    ("ls_blendenpik_cwt", "answer altered", _altered_lsqr),
    ("ls_blendenpik_cwt", "state unchanged", _unchanged_lsqr),
    ("krr_rff_sweeps", "half of the rows", _half_rows_krr),
    ("krr_rff_sweeps", "answer altered", _altered_krr),
    ("krr_rff_sweeps", "state unchanged", _unchanged_krr),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_caught(cell, fault, plant, monkeypatch):
    plant(monkeypatch)
    line, _, _ = run_tiny(cell, seconds=0.3)
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("cell", sorted({c for c, _, _ in FAULTS}))
def test_unbroken_run_is_correct(cell):
    line, _, _ = run_tiny(cell, seconds=0.3)
    assert line["correct"] is True, line["checks"]
