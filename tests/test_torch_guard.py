"""Port vs JAX package: the numerical-health guard layer (``guard/``).

Verdicts, details and attempt records must be equal; a certificate's
cond within 1e-8 relative (the probe's ``cond_est`` on a small,
well-conditioned sketch output, both packages drawing the same probe
vectors from the private seed 0x5EED).  The ladder is driven by the same
hand-made ``attempt_fn`` in both packages, so its contexts (derived
seeds), sketch sizes and records must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import guard as jg
from libskylark_tpu_torch import guard as tg
from libskylark_tpu_torch.utils.exceptions import NumericalHealthError


@pytest.fixture(autouse=True)
def _guard_env(monkeypatch):
    for var in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")


def _cert_fields(c):
    return (c.verdict, c.stage, c.flag, c.detail.split(" ")[0])


def _assert_cert(ct, cj):
    assert _cert_fields(ct) == _cert_fields(cj)
    for name in ("cond", "sigma_max", "sigma_min"):
        a, b = getattr(ct, name), getattr(cj, name)
        assert (a is None) == (b is None)
        if b is not None and np.isfinite(b):
            assert abs(a - b) <= 1e-8 * abs(b), name


@pytest.mark.parametrize("value,expect", [(None, True), ("1", True), ("0", False),
                                          ("false", False), ("FALSE", False), ("yes", True)])
def test_enabled_reads_env_per_call(monkeypatch, value, expect):
    if value is not None:
        monkeypatch.setenv("SKYLARK_GUARD", value)
    assert tg.enabled() is jg.enabled() is expect


def test_knobs_match_jax(monkeypatch):
    assert tg.max_retries() == jg.max_retries() == 2
    assert tg.GROWTH_FACTOR == jg.GROWTH_FACTOR
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert tg.cond_max(tdt) == pytest.approx(jg.cond_max(jdt), rel=1e-12)
    assert tg.cond_max() == pytest.approx(jg.cond_max(), rel=1e-12)
    monkeypatch.setenv("SKYLARK_GUARD_MAX_RETRIES", "-3")
    monkeypatch.setenv("SKYLARK_GUARD_COND_MAX", "123.5")
    assert tg.max_retries() == jg.max_retries() == 0
    assert tg.cond_max(torch.float32) == jg.cond_max(jnp.float32) == 123.5


def test_sentinels():
    good = {"a": torch.ones(3), "b": [torch.zeros(2, 2), (torch.arange(4), 7)]}
    assert tg.tree_all_finite(good) and bool(tg.finite_probe(good))
    assert tg.check_finite(good, "s") is good
    assert tg.tree_all_finite([torch.arange(3)])  # no float leaves
    bad = {"a": torch.ones(3), "b": [torch.tensor([1.0, float("inf")])]}
    assert not tg.tree_all_finite(bad)
    report = tg.RecoveryReport(stage="x")
    with pytest.raises(NumericalHealthError) as e:
        tg.check_finite(bad, "my_stage", report=report)
    assert e.value.code == 108 and e.value.stage == "my_stage" and e.value.report is report
    assert not tg.tree_all_finite(torch.tensor([float("nan")], dtype=torch.bfloat16))


def _sketch_output(rng, s=80, n=20):
    return rng.standard_normal((s, n)) * np.logspace(0, -1, n)


@pytest.mark.parametrize("case", ["ok", "wide", "ceiling", "nan", "singular", "f32"])
def test_certify_sketch_matches_jax(rng, case):
    SA = _sketch_output(rng)
    kw = {}
    if case == "wide":
        SA = SA.T.copy()
    elif case == "ceiling":
        kw = dict(cond_max=2.0)
    elif case == "nan":
        SA[3, 4] = np.nan
    elif case == "singular":
        SA[:, 7] = 0.0
    elif case == "f32":
        SA = SA.astype(np.float32)
    cj = jg.certify_sketch(jnp.asarray(SA), stage="st", **kw)
    ct = tg.certify_sketch(torch.from_numpy(SA), stage="st", **kw)
    if case == "f32":
        # f32 probe sweeps round differently: verdict and flag equal, cond
        # within 1e-4.
        assert _cert_fields(ct) == _cert_fields(cj)
        assert ct.cond == pytest.approx(cj.cond, rel=1e-4)
    elif case == "singular":
        # The estimate of an exactly singular matrix is rounding noise
        # (~1e14 in both): the verdict and flag are what must agree.
        assert _cert_fields(ct) == _cert_fields(cj)
        assert ct.cond > 1e12 and cj.cond > 1e12
    else:
        _assert_cert(ct, cj)
    expect = {"ok": "OK", "wide": "OK", "ceiling": "RESKETCH", "nan": "RESKETCH",
              "singular": "RESKETCH", "f32": "OK"}[case]
    assert ct.verdict == expect and ct.ok == (expect == "OK")


def test_certify_sketch_bf16_upcasts(rng):
    SA = torch.from_numpy(_sketch_output(rng).astype(np.float32)).bfloat16()
    ct = tg.certify_sketch(SA)
    assert ct.ok and ct.cond == pytest.approx(
        tg.certify_sketch(SA.float()).cond, rel=0)


@pytest.mark.parametrize("case", ["ok", "nan", "zero", "collapsed", "residual"])
def test_certify_svd_matches_jax(rng, case):
    A = rng.standard_normal((60, 12))
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    U, s, V = U[:, :3], s[:3], Vt[:3].T
    if case == "nan":
        U = U.copy()
        U[0, 0] = np.nan
    elif case == "zero":
        A, s = np.zeros_like(A), np.zeros_like(s)
    elif case == "collapsed":
        s = np.zeros_like(s)
    elif case == "residual":
        U = -U
    cj = jg.certify_svd(jnp.asarray(A), jnp.asarray(U), jnp.asarray(s), jnp.asarray(V))
    ct = tg.certify_svd(*map(torch.from_numpy, (A, U, s, V)))
    _assert_cert(ct, cj)
    assert ct.ok == (case in ("ok", "zero"))


def test_certify_svd_sparse_and_rtol(rng):
    D = rng.standard_normal((50, 10)) * (rng.random((50, 10)) < 0.4)
    U, s, Vt = np.linalg.svd(D, full_matrices=False)
    args = [torch.from_numpy(x) for x in (U, s, Vt.T)]
    assert tg.certify_svd(torch.from_numpy(D).to_sparse(), *args).ok
    assert not tg.certify_svd(torch.from_numpy(D), args[0], args[1] * 2, args[2], rtol=0.5).ok
    assert tg.certify_svd(torch.from_numpy(D), args[0], args[1] * 1.2, args[2], rtol=0.5).ok
    zero = torch.zeros(50, 10).to_sparse()
    assert tg.certify_svd(zero, torch.zeros(50, 2), torch.zeros(2), torch.zeros(10, 2)).ok


def test_pinv_psd_solve_matches_jax(rng):
    G0 = rng.standard_normal((30, 6))
    G = G0.T @ G0
    G[:, 5] = G[5, :] = 0.0  # singular PSD
    C = rng.standard_normal((6, 2))
    xj = np.asarray(jg.pinv_psd_solve(jnp.asarray(G), jnp.asarray(C)))
    xt = tg.pinv_psd_solve(torch.from_numpy(G), torch.from_numpy(C)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    assert np.all(xt[5] == 0.0)


@pytest.mark.parametrize("seed", [0, 1, 9, 12345, 2**31 - 2, 2**40 + 7])
def test_derived_context_matches_jax(seed):
    for attempt in range(5):
        cj = jg.derived_context(J.SketchContext(seed=seed, counter=3), attempt)
        ct = tg.derived_context(T.SketchContext(seed=seed, counter=3), attempt)
        assert (ct.seed, ct.counter) == (cj.seed, cj.counter)
        if attempt:
            assert ct.seed != seed % (2**31 - 1) or seed == 0


def test_report_dicts_match_jax():
    for pkg in (jg, tg):
        r = pkg.RecoveryReport(stage="s")
        r.record("initial", verdict="RESKETCH", detail="x", cond=3.5, sketch_size=10)
        r.record("fallback", verdict="FALLBACK")
        r.recovered = True
        if pkg is jg:
            dj = r.to_dict()
        else:
            dt = r.to_dict()
    assert dt == dj
    assert tg.RecoveryReport.disabled("q").to_dict() == jg.RecoveryReport.disabled("q").to_dict()
    assert tg.RecoveryAttempt("replay", chunk=3).to_dict() == {"action": "replay", "chunk": 3}


def _ladder(pkg, verdicts, *, fallback=True, **kw):
    """Run ``pkg.run_ladder`` with an attempt_fn that returns the given
    verdicts in turn and records what it was called with."""
    seen = []

    def attempt(ctx, s, i):
        seen.append((ctx.seed, s, i))
        v = verdicts[i]
        return f"result{i}", pkg.Certificate(v, "stage", cond=10.0 ** i, detail=f"d{i}")

    ctx = (J if pkg is jg else T).SketchContext(seed=77)
    fb = (lambda: "dense") if fallback else None
    out, report = pkg.run_ladder("stage", ctx, 40, 100, attempt, fb, **kw)
    return out, report.to_dict(), seen


@pytest.mark.parametrize("verdicts,kw,expect", [
    (["OK"], {}, "result0"),
    (["RESKETCH", "OK"], {}, "result1"),
    (["RESKETCH", "RESKETCH", "OK"], {}, "result2"),
    (["RESKETCH"] * 3, {}, "dense"),  # resketch -> grow -> fallback
    (["RESKETCH"] * 5, dict(max_retries=4), "dense"),  # growth clamped to 100
    (["RESKETCH", "FALLBACK"], {}, "dense"),  # FALLBACK skips the rest
    (["RESKETCH"] * 3, dict(growth=1.5), "dense"),
])
def test_run_ladder_matches_jax(verdicts, kw, expect):
    out_t, rep_t, seen_t = _ladder(tg, verdicts, **kw)
    out_j, rep_j, seen_j = _ladder(jg, verdicts, **kw)
    assert out_t == out_j == expect
    assert rep_t == rep_j and seen_t == seen_j
    actions = [a["action"] for a in rep_t["attempts"]]
    if expect == "dense":
        assert actions[-1] == "fallback" and rep_t["recovered"] is True
    if len(verdicts) >= 3 and expect == "dense" and "FALLBACK" not in verdicts:
        assert actions[:3] == ["initial", "resketch", "grow"]


def test_run_ladder_reads_max_retries_env(monkeypatch):
    monkeypatch.setenv("SKYLARK_GUARD_MAX_RETRIES", "0")
    out_t, rep_t, _ = _ladder(tg, ["RESKETCH"])
    out_j, rep_j, _ = _ladder(jg, ["RESKETCH"])
    assert out_t == out_j == "dense" and rep_t == rep_j
    assert [a["action"] for a in rep_t["attempts"]] == ["initial", "fallback"]


def test_run_ladder_exhausted_raises():
    with pytest.raises(NumericalHealthError) as e:
        _ladder(tg, ["RESKETCH"] * 3, fallback=False)
    with pytest.raises(jg.NumericalHealthError) as ej:
        _ladder(jg, ["RESKETCH"] * 3, fallback=False)
    assert e.value.stage == ej.value.stage == "stage"
    assert e.value.report.to_dict() == ej.value.report.to_dict()
    assert [a.action for a in e.value.report.attempts] == ["initial", "resketch", "grow"]


def test_exact_ne_reroutes_when_guarded(rng, monkeypatch):
    A = rng.standard_normal((40, 5))
    A[:, 4] = 0.0  # an exactly zero pivot: no Cholesky factor in either package
    b = rng.standard_normal(40)
    from libskylark_tpu.linalg import least_squares as jls

    xt = T.linalg.exact_least_squares(torch.from_numpy(A), torch.from_numpy(b), alg="ne")
    xj = np.asarray(jls.exact_least_squares(jnp.asarray(A), jnp.asarray(b), alg="ne"))
    assert bool(torch.isfinite(xt).all())
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    with pytest.raises(NumericalHealthError):
        T.linalg.exact_least_squares(torch.from_numpy(A), torch.from_numpy(b), alg="ne")
