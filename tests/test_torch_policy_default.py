"""Port vs JAX package: the routing decision (``policy/``) with no
profile store.  The port's decision is the JAX package's default one
with the caller's pinned fields, so ``info["policy"]`` must be EQUAL to
the JAX package's dict, on every least-squares route, the default (no
route), ``streaming_least_squares`` and ``approximate_kernel_ridge``.

The JAX side runs with ``SKYLARK_POLICY=0`` (its decision ignores any
store), ``SKYLARK_NO_PLANS=1`` and ``SKYLARK_NO_SRHT_GEMM=1``; x64 is on
(``tests/conftest.py``).  No tolerance: dicts compare with ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import policy as jpol
from libskylark_tpu_torch import policy as tpol
from libskylark_tpu_torch.streaming import StreamParams, pinned_placer


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jcore

        monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean,
                            raising=False)


@pytest.mark.parametrize("m,n", [(1, 1), (2, 3), (1000, 50), (1 << 20, 512), (32768, 768)])
def test_profile_keys_match_jax(m, n):
    assert tpol.shape_class(m, n) == jpol.shape_class(m, n)
    for dtype in ("float32", "bfloat16", "float64"):
        assert tpol.profile_key("ls", "gpu", dtype, m, n) == jpol.profile_key(
            "ls", "gpu", dtype, m, n)


@pytest.mark.parametrize("kind", ["ls", "ls_stream", "krr", "train"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("pins", [{}, {"route": "refine"}, {"sketch_type": "CWT"},
                                  {"sketch_size": 77, "route": "exact"}])
def test_choose_route_matches_jax(kind, sparse, pins):
    sig = dict(kind=kind, m=5000, n=40, targets=2, dtype="float32", sparse=sparse,
               backend="gpu")
    got = tpol.choose_route(tpol.ProblemSignature(**sig), **pins)
    want = jpol.choose_route(jpol.ProblemSignature(**sig), store_view={}, **pins)
    assert got.to_dict() == want.to_dict()
    assert got.key == "|".join([kind, "gpu", "float32", "r13c6"])


def test_unknown_kind_and_routes():
    assert tpol.LS_ROUTES == jpol.decide.LS_ROUTES
    with pytest.raises(ValueError, match="unknown problem kind"):
        tpol.choose_route(tpol.ProblemSignature(kind="bogus", m=4, n=2))
    with pytest.raises(ValueError, match="unknown least-squares route"):
        T.linalg.approximate_least_squares(torch.zeros(8, 2), torch.zeros(8), T.SketchContext(),
                                           route="bogus")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_consult_names_dtypes_and_backends_as_jax(dtype):
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.float64: "float64"}[dtype]
    for device, backend in (("cpu", "cpu"), (torch.device("cuda", 0), "gpu")):
        d = tpol.consult("ls", m=300, n=20, dtype=dtype, device=device)
        assert d.key == f"ls|{backend}|{name}|r9c5"
        assert d.to_dict() == jpol.choose_route(jpol.ProblemSignature(
            kind="ls", m=300, n=20, dtype=name, backend=backend), store_view={}).to_dict()


@pytest.mark.parametrize("route", [None, "sketch", "refine", "blendenpik", "lsrn", "exact"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ls_info_policy_equals_jax(route, dtype):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((600, 12)).astype(dtype)
    b = (A @ rng.standard_normal(12) + 0.1 * rng.standard_normal(600)).astype(dtype)
    _, it = T.linalg.approximate_least_squares(torch.from_numpy(A), torch.from_numpy(b),
                                               T.SketchContext(seed=2), route=route,
                                               return_info=True)
    _, ij = J.linalg.approximate_least_squares(jnp.asarray(A), jnp.asarray(b),
                                               J.SketchContext(seed=2), route=route,
                                               return_info=True)
    assert it["policy"] == ij["policy"]
    assert set(it) == set(ij)


def test_pinned_sketch_fields_land_in_the_decision():
    rng = np.random.default_rng(3)
    A, b = rng.standard_normal((400, 8)), rng.standard_normal(400)
    args = dict(route="refine", return_info=True)
    _, it = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=2),
        T.linalg.LeastSquaresParams(sketch_type="CWT", sketch_size=40), **args)
    _, ij = J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=2),
        J.linalg.LeastSquaresParams(sketch_type="CWT", sketch_size=40), **args)
    assert it["policy"] == ij["policy"]
    assert it["policy"]["sketch_type"] == "CWT" and it["refine"]["sketch_size"] == 40


def test_streaming_info_policy_equals_jax():
    rng = np.random.default_rng(4)
    n, d = 64, 4
    A, b = rng.standard_normal((n, d)), rng.standard_normal(n)
    blocks_j = [(jnp.asarray(A[i:i + 16]), jnp.asarray(b[i:i + 16])) for i in range(0, n, 16)]
    blocks_t = [(torch.from_numpy(A[i:i + 16]), torch.from_numpy(b[i:i + 16]))
                for i in range(0, n, 16)]
    _, ij = J.linalg.streaming_least_squares(blocks_j, n, d, J.SketchContext(seed=11))
    _, it = T.linalg.streaming_least_squares(
        blocks_t, n, d, T.SketchContext(seed=11),
        stream_params=StreamParams(placer=pinned_placer("cpu")))
    assert it["policy"] == ij["policy"]
    assert it["policy"]["key"] == "ls_stream|cpu|float32|r6c2"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_krr_info_policy_equals_jax(dtype):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((120, 5)).astype(dtype)
    Y = np.sin(X.sum(1)).astype(dtype)
    jm = J.ml.approximate_kernel_ridge(J.ml.GaussianKernel(5, 2.0), jnp.asarray(X),
                                       jnp.asarray(Y), 0.1, 32, J.SketchContext(seed=7))
    tm = T.ml.approximate_kernel_ridge(T.ml.GaussianKernel(5, 2.0), torch.from_numpy(X),
                                       torch.from_numpy(Y), 0.1, 32, T.SketchContext(seed=7))
    assert tm.info["policy"] == jm.info["policy"]
    assert tm.info["policy"]["route"] == "cholesky"
