"""Port vs JAX package: kernel ridge regression's in-core strategies
(``ml/krr.py``) and the RLSC wrappers (``ml/rlsc.py``).

Same seeded numpy inputs in f64 (x64 is on) and the same
``SketchContext`` seeds to both packages, so both realize the same
feature maps and sketches.  The JAX side runs with ``SKYLARK_POLICY=0
SKYLARK_NO_PLANS=1`` (the port has no policy store or plans; plans are
bitwise eager by contract) and ``SKYLARK_NO_SRHT_GEMM=1`` (both take
FJLT's WHT route).  Tolerances, relative to the largest magnitude:
direct solves (exact, approximate, sketched, large-scale BCD, RLSC)
1e-10; ``faster_kernel_ridge``'s preconditioned CG 1e-6 with the same
iteration count.  A model the port trains loads in the JAX package
(``libskylark_tpu.ml.load_model``) and predicts the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.ml import krr as jkrr
from libskylark_tpu_torch.ml import krr as tkrr

DIRECT = 1e-10
CG_TOL = 1e-6
N, D = 160, 6


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    for knob in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(knob, raising=False)


def _rel(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


def _data(rng, n=N, d=D, targets=0):
    X = rng.standard_normal((n, d))
    if targets:
        Y = np.tanh(X @ rng.standard_normal((d, targets)))
    else:
        Y = np.sin(X.sum(1))
    return X, Y


def _kernels(d=D, sigma=2.0):
    return (J.ml.GaussianKernel(d, sigma), T.ml.GaussianKernel(d, sigma))


@pytest.mark.parametrize("targets", [0, 3])
def test_kernel_ridge_matches_jax(rng, targets):
    X, Y = _data(rng, targets=targets)
    jm = jkrr.kernel_ridge(_kernels()[0], jnp.asarray(X), jnp.asarray(Y), 0.1)
    tm = tkrr.kernel_ridge(_kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), 0.1)
    assert _rel(tm.A, jm.A) <= DIRECT
    Xt = rng.standard_normal((20, D))
    assert _rel(tm.predict(torch.from_numpy(Xt)), jm.predict(jnp.asarray(Xt))) <= DIRECT


@pytest.mark.parametrize("use_fast", [False, True])
@pytest.mark.parametrize("targets", [0, 2])
def test_approximate_kernel_ridge_matches_jax(rng, use_fast, targets):
    X, Y = _data(rng, targets=targets)
    jm = jkrr.approximate_kernel_ridge(
        _kernels()[0], jnp.asarray(X), jnp.asarray(Y), 0.05, 96, J.SketchContext(seed=7),
        jkrr.KrrParams(use_fast=use_fast))
    tm = tkrr.approximate_kernel_ridge(
        _kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), 0.05, 96,
        T.SketchContext(seed=7), tkrr.KrrParams(use_fast=use_fast))
    assert _rel(tm.W, jm.W) <= DIRECT
    assert tm.info["recovery"] == jm.info["recovery"]
    assert tm.maps[0].to_dict() == jm.maps[0].to_dict()
    assert tm.info["policy"] == jm.info["policy"]


@pytest.mark.parametrize("fast_sketch", [False, True])
def test_sketched_approximate_kernel_ridge_matches_jax(rng, fast_sketch):
    X, Y = _data(rng, n=256, targets=2)
    p = dict(fast_sketch=fast_sketch, sketch_size=128)
    jm = jkrr.sketched_approximate_kernel_ridge(
        _kernels()[0], jnp.asarray(X), jnp.asarray(Y), 0.05, 48, J.SketchContext(seed=3),
        jkrr.KrrParams(**p))
    tm = tkrr.sketched_approximate_kernel_ridge(
        _kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), 0.05, 48,
        T.SketchContext(seed=3), tkrr.KrrParams(**p))
    assert _rel(tm.W, jm.W) <= DIRECT


def test_sketched_default_size_is_4s(rng):
    """t defaults to min(4s, n): the CWT of 4s = 64 rows."""
    X, Y = _data(rng, n=200)
    jm = jkrr.sketched_approximate_kernel_ridge(
        _kernels()[0], jnp.asarray(X), jnp.asarray(Y), 0.1, 16, J.SketchContext(seed=4),
        jkrr.KrrParams(fast_sketch=True))
    tm = tkrr.sketched_approximate_kernel_ridge(
        _kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), 0.1, 16,
        T.SketchContext(seed=4), tkrr.KrrParams(fast_sketch=True))
    assert _rel(tm.W, jm.W) <= DIRECT


@pytest.mark.parametrize("use_fast", [False, True])
def test_faster_kernel_ridge_matches_jax_cg(rng, use_fast):
    """A problem the preconditioner suits (19-20 CG steps at 1e-8): CG
    without reorthogonalization spreads rounding differences once its
    Ritz values converge (ROADMAP Queue C), so a slow CG would move the
    stopping step of either package."""
    X, Y = _data(rng, targets=2)
    jk, tk = _kernels(sigma=3.0)
    p = dict(use_fast=use_fast, tolerance=1e-8, iter_lim=200)
    jm = jkrr.faster_kernel_ridge(
        jk, jnp.asarray(X), jnp.asarray(Y), 0.3, 128, J.SketchContext(seed=5),
        jkrr.KrrParams(**p))
    tm = tkrr.faster_kernel_ridge(
        tk, torch.from_numpy(X), torch.from_numpy(Y), 0.3, 128,
        T.SketchContext(seed=5), tkrr.KrrParams(**p))
    assert _rel(tm.A, jm.A) <= CG_TOL
    assert int(tm.info["iterations"]) == int(jm.info["iterations"])
    assert int(tm.info["flag"]) == int(jm.info["flag"]) == 0
    assert int(tm.info["iterations"]) < p["iter_lim"]
    # The preconditioned CG is close to the exact solve it stands for.
    exact = tkrr.kernel_ridge(tk, torch.from_numpy(X), torch.from_numpy(Y), 0.3)
    assert _rel(tm.A, exact.A) <= 1e-6


def test_chunk_sizes_match_jax():
    for d, s, split in [(6, 100, 0), (6, 100, 32), (10, 7, 4), (128, 8192, 2048), (4, 5, 3)]:
        jp, tp = jkrr.KrrParams(max_split=split), tkrr.KrrParams(max_split=split)
        assert tkrr._chunk_sizes(d, s, tp) == jkrr._chunk_sizes(d, s, jp)


@pytest.mark.parametrize("use_fast", [False, True])
def test_large_scale_kernel_ridge_matches_jax(rng, use_fast):
    X, Y = _data(rng, n=200, targets=2)
    p = dict(max_split=32, iter_lim=60, tolerance=1e-4, use_fast=use_fast)
    jm = jkrr.large_scale_kernel_ridge(
        _kernels()[0], jnp.asarray(X), jnp.asarray(Y), 0.1, 80, J.SketchContext(seed=6),
        jkrr.KrrParams(**p))
    tm = tkrr.large_scale_kernel_ridge(
        _kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), 0.1, 80,
        T.SketchContext(seed=6), tkrr.KrrParams(**p))
    assert len(tm.maps) == len(jm.maps) > 1
    assert [S.to_dict() for S in tm.maps] == [S.to_dict() for S in jm.maps]
    assert _rel(tm.W, jm.W) <= DIRECT


def test_guard_fallback_on_indefinite_gram(rng):
    """λ < 0 with more features than examples makes ZᵀZ + λI indefinite:
    both packages' Cholesky fails, both fall back to the eigh
    pseudoinverse solve and record it."""
    X, Y = _data(rng, n=40)
    jm = jkrr.approximate_kernel_ridge(
        _kernels()[0], jnp.asarray(X), jnp.asarray(Y), -1e-3, 64, J.SketchContext(seed=8))
    tm = tkrr.approximate_kernel_ridge(
        _kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), -1e-3, 64,
        T.SketchContext(seed=8))
    rec = tm.info["recovery"]
    assert rec == jm.info["recovery"]
    assert rec["recovered"] and rec["attempts"][0]["action"] == "fallback"
    assert np.isfinite(tm.W.numpy()).all()
    assert _rel(tm.W, jm.W) <= 1e-8  # a pseudoinverse: eigh of the same G to rounding


def test_guard_fallback_on_singular_gram(rng):
    """X ≡ 0 under the linear kernel and λ = 0: ZᵀZ + λI is exactly 0."""
    X = np.zeros((30, D))
    Y = rng.standard_normal(30)
    jm = jkrr.approximate_kernel_ridge(
        J.ml.LinearKernel(D), jnp.asarray(X), jnp.asarray(Y), 0.0, 12, J.SketchContext(seed=1))
    tm = tkrr.approximate_kernel_ridge(
        T.ml.LinearKernel(D), torch.from_numpy(X), torch.from_numpy(Y), 0.0, 12,
        T.SketchContext(seed=1))
    assert tm.info["recovery"] == jm.info["recovery"]
    assert tm.info["recovery"]["attempts"][0]["action"] == "fallback"
    assert torch.equal(tm.W, torch.zeros_like(tm.W)) and np.all(np.asarray(jm.W) == 0)


def test_guard_off_leaves_nan_and_records_nothing(rng, monkeypatch):
    """Under SKYLARK_GUARD=0 a failed factor gives NaN coefficients in
    both packages, and the report is the disabled one."""
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    X, Y = _data(rng, n=40)
    jm = jkrr.approximate_kernel_ridge(
        _kernels()[0], jnp.asarray(X), jnp.asarray(Y), -1e-3, 64, J.SketchContext(seed=8))
    tm = tkrr.approximate_kernel_ridge(
        _kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), -1e-3, 64,
        T.SketchContext(seed=8))
    assert tm.info["recovery"] == jm.info["recovery"]
    assert not tm.info["recovery"]["guarded"]
    assert np.isnan(np.asarray(jm.W)).all() and torch.isnan(tm.W).all()


def test_bf16_features_keep_dtype_contract(rng):
    """bf16 features: the model stays bf16, the factor runs in f32, and
    the predictions track an f32 run to bf16 accuracy (the JAX package's
    tests/test_ml.py::TestKRR::test_bf16_features_keep_dtype_contract)."""
    n, d, s = 256, 8, 64
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.tanh(X @ rng.standard_normal(d)).astype(np.float32)
    k = T.ml.GaussianKernel(d, 2.0)
    m16 = tkrr.approximate_kernel_ridge(k, torch.from_numpy(X).bfloat16(),
                                        torch.from_numpy(y), 0.1, s, T.SketchContext(seed=9))
    assert m16.W.dtype == torch.bfloat16
    m32 = tkrr.approximate_kernel_ridge(k, torch.from_numpy(X), torch.from_numpy(y), 0.1, s,
                                        T.SketchContext(seed=9))
    p16 = m16.predict(torch.from_numpy(X)).double()
    p32 = m32.predict(torch.from_numpy(X)).double()
    assert float((p16 - p32).abs().max() / p32.abs().max()) < 0.05


def _two_blobs(rng, n_per, d, classes=(3, 7)):
    X = np.concatenate([rng.standard_normal((n_per, d)) + 2.5 * i
                        for i in range(len(classes))])
    y = np.repeat(np.array(classes), n_per)
    return X, y


@pytest.mark.parametrize("name,args", [
    ("kernel_rlsc", ()),
    ("approximate_kernel_rlsc", (64, 11)),
    ("sketched_approximate_kernel_rlsc", (64, 12)),
    ("faster_kernel_rlsc", (64, 13)),
])
def test_rlsc_matches_jax(rng, name, args):
    X, y = _two_blobs(rng, 40, 4)
    jk, tk = J.ml.GaussianKernel(4, 2.0), T.ml.GaussianKernel(4, 2.0)
    jargs = (args[0], J.SketchContext(seed=args[1])) if args else ()
    targs = (args[0], T.SketchContext(seed=args[1])) if args else ()
    kw = {}
    if name == "faster_kernel_rlsc":
        kw = dict(params=None)
    jm = getattr(J.ml, name)(jk, jnp.asarray(X), y, 0.05, *jargs, **kw)
    tm = getattr(T.ml, name)(tk, torch.from_numpy(X), y, 0.05, *targs, **kw)
    assert list(tm.classes) == list(np.asarray(jm.classes).tolist()) == [3, 7]
    tol = CG_TOL if name == "faster_kernel_rlsc" else DIRECT
    assert _rel(tm.predict(torch.from_numpy(X)), jm.predict(jnp.asarray(X))) <= tol
    labels = tm.predict_labels(torch.from_numpy(X)).numpy()
    assert np.array_equal(labels, np.asarray(jm.predict_labels(jnp.asarray(X), jm.classes)))
    assert (labels == y).mean() > 0.95


def test_port_trained_models_load_in_jax(rng, tmp_path):
    """Trained by the port, saved, loaded by ``libskylark_tpu.ml.load_model``:
    the same coefficients and predictions (feature-map and kernel models)."""
    X, y = _two_blobs(rng, 30, 4)
    Xt = rng.standard_normal((25, 4))
    k = T.ml.GaussianKernel(4, 1.5)
    models = {
        "fm": T.ml.approximate_kernel_rlsc(k, torch.from_numpy(X), y, 0.05, 48,
                                           T.SketchContext(seed=21)),
        "km": T.ml.kernel_rlsc(k, torch.from_numpy(X), y, 0.05),
    }
    for key, tm in models.items():
        path = str(tmp_path / f"{key}.json")
        tm.save(path)
        jm = J.ml.load_model(path)
        coef = tm.W if key == "fm" else tm.A
        assert np.array_equal(np.asarray(jm.W if key == "fm" else jm.A), coef.numpy())
        assert list(np.asarray(jm.classes).tolist()) == [3, 7]
        assert _rel(tm.predict(torch.from_numpy(Xt)), jm.predict(jnp.asarray(Xt))) <= DIRECT


def _same_info(a, b):
    """CG's info dicts bitwise equal (values are tensors or numbers)."""
    return a.keys() == b.keys() and all(
        torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)


def test_deferred_parts_raise_naming_their_item(rng, tmp_path):
    # Nothing of ml/krr.py is deferred any more: the streaming solvers are
    # ported (tests/test_torch_streaming.py) and so is checkpointed CG,
    # whose run writes rotated checkpoints and is bitwise the unchecked one
    # (chunked CG steps are the one-shot steps).
    assert T.ml.streaming_kernel_ridge is tkrr.streaming_kernel_ridge
    X, Y = _data(rng, n=40)
    args = (_kernels()[1], torch.from_numpy(X), torch.from_numpy(Y), 0.1, 8)
    plain = tkrr.faster_kernel_ridge(*args, T.SketchContext(seed=1))
    ck = tkrr.faster_kernel_ridge(*args, T.SketchContext(seed=1), tkrr.KrrParams(
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=3))
    assert torch.equal(ck.A, plain.A)
    assert _same_info(ck.info, plain.info)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir())


def test_checkpointed_faster_kernel_ridge_resumes_bitwise(rng, tmp_path, monkeypatch):
    """A checkpointed faster-KRR solve preempted after chunk 1 and resumed
    is bitwise the uninterrupted checkpointed solve (and both the unchecked
    one); the result is held against the JAX package's checkpointed run
    at the CG tolerance, with the same iteration count."""
    X, Y = _data(rng, targets=2)
    jk, tk = _kernels(sigma=3.0)
    p = dict(tolerance=1e-8, iter_lim=200, checkpoint_every=4)

    def port(directory, **kw):
        return tkrr.faster_kernel_ridge(
            tk, torch.from_numpy(X), torch.from_numpy(Y), 0.3, 128, T.SketchContext(seed=5),
            tkrr.KrrParams(checkpoint_dir=str(tmp_path / directory), **p, **kw))

    whole = port("whole")
    plain = tkrr.faster_kernel_ridge(
        tk, torch.from_numpy(X), torch.from_numpy(Y), 0.3, 128, T.SketchContext(seed=5),
        tkrr.KrrParams(tolerance=1e-8, iter_lim=200))
    assert torch.equal(whole.A, plain.A)
    assert int(whole.info["iterations"]) > 2 * p["checkpoint_every"]  # chunk 1 is not the last

    runner = T.resilient.ResilientRunner

    class Preempted(runner):
        def __init__(self, solver, params=None, **kw):
            super().__init__(solver, params, fault_plan=T.resilient.FaultPlan(
                preempt_after_chunk=1))

    monkeypatch.setattr(T.resilient, "ResilientRunner", Preempted)
    with pytest.raises(T.resilient.SimulatedPreemption):
        port("killed")
    monkeypatch.setattr(T.resilient, "ResilientRunner", runner)
    resumed = port("killed", resume=True)
    assert torch.equal(resumed.A, whole.A)
    assert _same_info(resumed.info, whole.info)
    jm = jkrr.faster_kernel_ridge(
        jk, jnp.asarray(X), jnp.asarray(Y), 0.3, 128, J.SketchContext(seed=5),
        jkrr.KrrParams(checkpoint_dir=str(tmp_path / "jax"), **p))
    assert _rel(whole.A, jm.A) <= CG_TOL
    assert int(whole.info["iterations"]) == int(jm.info["iterations"])


def test_exports_match_jax():
    assert set(J.ml.krr.__all__) == set(tkrr.__all__)
    for name in ("KrrParams", "kernel_ridge", "approximate_kernel_ridge",
                 "sketched_approximate_kernel_ridge", "faster_kernel_ridge",
                 "large_scale_kernel_ridge", "kernel_rlsc", "approximate_kernel_rlsc",
                 "sketched_approximate_kernel_rlsc", "faster_kernel_rlsc"):
        assert hasattr(T.ml, name)
