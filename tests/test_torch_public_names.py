"""Port vs JAX package: the public names the python-skylark surface
keeps, ``sketch.deserialize_sketch``, ``sketch.SUPPORTED_SKETCH_TRANSFORMS``
and the error codes of ``utils`` (``AllocationError`` 101 and
``SketchError`` 103 among them).

A dict serialized by the JAX package goes through the port's
``deserialize_sketch`` and must give the transform ``from_dict`` gives:
the same JSON, the same output bitwise, hash buckets bitwise the JAX
package's, and values within the JAX package's 1e-5 relative of its own
apply (sums in another order; ``SKYLARK_NO_SRHT_GEMM=1`` puts the JAX
FJLT on the port's route, as ``test_torch_sketch.py`` does).  The
quasi-Monte-Carlo maps and the DCT FJLT are among the cases; the cosine
features of GaussianQRFT evaluate ndtri in f32, whose torch and XLA
versions differ in the last ulps, so it is held at 1e-4 (as
``test_torch_quasi.py`` holds it).  Every sketch type the JAX package
registers is registered in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.utils.exceptions as JE
import libskylark_tpu_torch as T

TOL = 1e-5


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("stype,params,shape,dim", [
    ("CWT", {}, (300, 5), "columnwise"),
    ("SJLT", {"nnz": 2}, (4, 300), "rowwise"),
    ("MMT", {}, (300, 3), "columnwise"),
    ("FJLT", {}, (300, 4), "columnwise"),
    ("JLT", {}, (6, 300), "rowwise"),
    ("QJLT", {}, (300, 4), "columnwise"),
    ("GaussianQRFT", {"sigma": 3.0}, (5, 300), "rowwise"),
    ("FJLT", {"fut": "dct"}, (300, 4), "columnwise"),
])
def test_deserialize_sketch_applies_as_from_dict(rng, monkeypatch, stype, params, shape, dim):
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    Sj = J.sketch.create_sketch(stype, 300, 40, J.SketchContext(seed=77), **params)
    d = Sj.serialize()
    St = T.sketch.deserialize_sketch(d)
    Sf = T.sketch.from_dict(d)
    assert type(St) is type(Sf) and St.to_json() == Sf.to_json() == Sj.to_json()
    A = rng.standard_normal(shape).astype(np.float32)
    out = St.apply(torch.from_numpy(A), dim)
    assert torch.equal(out, Sf.apply(torch.from_numpy(A), dim))
    assert _rel(out, Sj.apply(jnp.asarray(A), dim)) <= (1e-4 if stype == "GaussianQRFT" else TOL)
    if stype in ("CWT", "SJLT", "MMT"):
        np.testing.assert_array_equal(St.buckets(device="cpu").numpy(),
                                      np.asarray(Sj.buckets()))


def test_supported_sketch_transforms_is_the_jax_list_less_the_unported():
    ported = T.sketch.SUPPORTED_SKETCH_TRANSFORMS
    reference = J.sketch.SUPPORTED_SKETCH_TRANSFORMS
    assert ported == reference  # nothing is left unported
    assert set(T.sketch.sketch_registry()) == set(J.sketch.sketch_registry())
    assert all(t == (t[0], "Matrix", "Matrix") for t in ported)
    assert "SUPPORTED_SKETCH_TRANSFORMS" in T.sketch.__all__
    assert "deserialize_sketch" in T.sketch.__all__


@pytest.mark.parametrize("name", [
    "SkylarkError", "AllocationError", "InvalidParameters", "SketchError",
    "UnsupportedError", "IOError_", "ConvergenceError", "CheckpointError",
    "NumericalHealthError", "StaleEpochError", "RefinementError",
])
def test_error_codes_match_jax(name):
    ported, reference = getattr(T.utils, name), getattr(JE, name)
    assert name in T.utils.__all__
    assert ported.code == reference.code
    assert issubclass(ported, T.utils.SkylarkError)
    assert [c.__name__ for c in ported.__mro__] == [c.__name__ for c in reference.__mro__]
