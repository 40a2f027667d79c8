"""Port vs JAX package: the loss/regularizer prox library
(``solvers/prox.py``).

Same seeded numpy inputs in f64 (x64 is on) to both packages.
Tolerance: every ``evaluate`` and ``prox`` within 1e-12 of the JAX value
relative to its largest magnitude.  The logistic prox is the damped
Newton loop with per-example masks: examples that converged keep their
value, so the port's result is the JAX one to rounding.  The port's
batched call over a leading partition axis (BlockADMM's) equals its
per-partition calls, to the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu_torch as T
from libskylark_tpu.solvers import prox as jprox
from libskylark_tpu_torch.solvers import prox as tprox

RTOL = 1e-12
LOSSES = ["squared", "lad", "hinge", "logistic"]
REGS = ["none", "l2", "l1"]


def _close(port, ref, rtol=RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(port - ref).max() <= rtol * scale


def _case(rng, loss, kind, n=64, k=4):
    """(V, Y) for a loss: 'binary' ±1 labels with V (1, n), 'multiclass'
    class indices with V (k, n), 'regression' targets of V's shape."""
    if kind == "binary":
        V = rng.standard_normal((1, n)) * 2
        Y = np.where(rng.standard_normal(n) > 0, 1.0, -1.0)
    elif kind == "multiclass":
        V = rng.standard_normal((k, n)) * 2
        Y = rng.integers(0, k, n).astype(np.float64)
    else:
        V = rng.standard_normal((k, n)) * 2
        Y = rng.standard_normal((k, n))
    return V, Y


def _kinds(loss):
    return ["regression"] if loss in ("squared", "lad") else ["binary", "multiclass"]


CASES = [(loss, kind) for loss in LOSSES for kind in _kinds(loss)]


@pytest.mark.parametrize("loss,kind", CASES)
@pytest.mark.parametrize("lam", [0.05, 1.0, 7.5])
def test_loss_prox_and_evaluate_match_jax(rng, loss, kind, lam):
    V, Y = _case(rng, loss, kind)
    jl, tl = jprox.get_loss(loss), tprox.get_loss(loss)
    _close(tl.prox(torch.from_numpy(V), lam, torch.from_numpy(Y)),
           jl.prox(jnp.asarray(V), lam, jnp.asarray(Y)))
    _close(tl.evaluate(torch.from_numpy(V), torch.from_numpy(Y)),
           jl.evaluate(jnp.asarray(V), jnp.asarray(Y)))


@pytest.mark.parametrize("loss,kind", CASES)
def test_loss_batched_over_partitions(rng, loss, kind):
    """A leading axis P is P independent problems (the ADMM layout), to
    rounding: torch may reduce over the k axis of a 3-D tensor in
    another order than of a 2-D one."""
    parts = [_case(rng, loss, kind, n=32) for _ in range(3)]
    V = torch.from_numpy(np.stack([v for v, _ in parts]))
    Y = torch.from_numpy(np.stack([y for _, y in parts]))
    lam = torch.tensor(0.7, dtype=torch.float64)
    tl = tprox.get_loss(loss)
    out = tl.prox(V, lam, Y)
    for p in range(3):
        _close(out[p], tl.prox(V[p], lam, Y[p]))
    total = sum(tl.evaluate(V[p], Y[p]) for p in range(3))
    assert abs(float(tl.evaluate(V, Y)) - float(total)) <= RTOL * abs(float(total))


def test_logistic_prox_converged_examples_keep_values(rng):
    """Masked Newton: an example already at its optimum is never moved;
    with a Newton budget of 1 the result is the JAX one too."""
    V, Y = _case(rng, "logistic", "multiclass", n=40)
    jl, tl = jprox.LogisticLoss(), tprox.LogisticLoss()
    X = tl.prox(torch.from_numpy(V), 0.3, torch.from_numpy(Y))
    again = tl.prox(X, 0.0, torch.from_numpy(Y))  # lam = 0: prox is the identity
    assert torch.equal(again, X)
    j1, t1 = jprox.LogisticLoss(max_newton_steps=1), tprox.LogisticLoss(max_newton_steps=1)
    _close(t1.prox(torch.from_numpy(V), 2.0, torch.from_numpy(Y)),
           j1.prox(jnp.asarray(V), 2.0, jnp.asarray(Y)))
    assert not tl.graphable and tprox.HingeLoss.graphable


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_logistic_prox_chunks_bitwise(rng, kind, monkeypatch):
    """A masked Newton step after every example has converged changes
    nothing, so any number of steps between reads of the convergence
    flag gives bitwise the same prox, batched over partitions too."""
    parts = [_case(rng, "logistic", kind, n=48) for _ in range(2)]
    V = torch.from_numpy(np.stack([v for v, _ in parts]))
    Y = torch.from_numpy(np.stack([y for _, y in parts]))
    outs = []
    for chunk in (1, 3, 7, 100):
        monkeypatch.setattr(tprox, "NEWTON_CHUNK", chunk)
        outs.append(tprox.LogisticLoss().prox(V, 1.5, Y))
    assert all(torch.equal(out, outs[0]) for out in outs[1:])


@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("lam", [0.01, 0.8])
def test_regularizer_matches_jax(rng, reg, lam):
    W = rng.standard_normal((20, 3))
    jr, tr = jprox.get_regularizer(reg), tprox.get_regularizer(reg)
    _close(tr.prox(torch.from_numpy(W), lam), jr.prox(jnp.asarray(W), lam))
    _close(tr.evaluate(torch.from_numpy(W)), jr.evaluate(jnp.asarray(W)))


def test_registry_and_exports():
    assert sorted(tprox.LOSSES) == sorted(jprox.LOSSES)
    assert sorted(tprox.REGULARIZERS) == sorted(jprox.REGULARIZERS)
    for name in LOSSES:
        assert T.solvers.get_loss(name).name == name
    for name in REGS:
        assert T.solvers.get_regularizer(name).name == name
    assert set(jprox.__all__) == set(tprox.__all__)


def test_hinge_out_of_range_class_codes_minus_one(rng):
    """A class index outside [0, k) codes −1 in every row, as
    ``jax.nn.one_hot`` gives a zero row."""
    V = rng.standard_normal((3, 5))
    Y = np.array([0.0, 2.0, 5.0, -1.0, 1.0])
    _close(tprox.HingeLoss().prox(torch.from_numpy(V), 0.5, torch.from_numpy(Y)),
           jprox.HingeLoss().prox(jnp.asarray(V), 0.5, jnp.asarray(Y)))
