"""Port vs JAX package: the nine command-line drivers (``linear``, ``svd``,
``krr``, ``ml``, ``graph_se``, ``community``, ``convert2hdf5``, ``serve``,
``top``), each run as the JAX package's ``main(argv)`` and as the port's
``main(argv + ["--device", "cpu"])`` on the same files made from a seed
(``top`` has no ``--device``: it reads HTTP surfaces and ledgers).

The JAX side runs with x64 on (the test configuration's default), so the
port runs with ``--x64``; the fixtures are the existing parity tests'
(``SKYLARK_NO_SRHT_GEMM=1``, ``SKYLARK_POLICY=0``, the JAX plans off,
``SKYLARK_GUARD=0`` for the least-squares drivers, ``trace_state_clean``
put back in ``jax.core`` for the JAX streaming drivers), and the tolerances
theirs for the same solver: least squares and Blendenpik 1e-9 relative
(``test_torch_accelerated.py``), the randomized SVD 1e-9 on invariants
(``test_torch_svd.py``), KRR 1e-10 direct and 1e-6 through CG
(``test_torch_krr.py``), BlockADMM 1e-9 (``test_torch_admm.py``), ASE
1e-10 (``test_torch_graph_analytics.py``); community detection is host
numpy in both and equal; ``serve`` over stdio answers the same frames
(least squares at 1e-9, the same error envelopes), and ``top --once``
renders the same frame, timestamp aside.  Also: a model saved by one package predicts
the same in the other, ``--stream`` equals the whole-file solve with the
stream's own sketch, ``--shard`` on one CPU slot is bitwise the run
without it (``tests/test_torch_cli_shard.py`` holds it to the JAX
driver's ``--shard`` on 8 slots) and the elastic flags run one rank of a world of 1, the
telemetry flags print and ledger what the
JAX drivers do and hold for the run only, and a run without ``--device
cpu`` raises here,
where there is no card.  ``tests/test_cli_ml.py`` is mirrored case for
case on the port (its ``TestGraftEntry`` tests ``__graft_entry__``, not a
driver: the port's ``flagship.py`` has its counterpart).
"""

import importlib
import os
import re

import jax
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.plans.plan as jplan
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
from libskylark_tpu.io import write_libsvm
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

LS_TOL = 1e-9
SVD_TOL = 1e-9
DIRECT = 1e-10
CG_TOL = 1e-6
ADMM_TOL = 1e-9
ASE_TOL = 1e-10
CPU = ["--device", "cpu"]
DRIVERS = ("linear", "svd", "krr", "ml", "graph_se", "community", "convert2hdf5", "serve")


def jmain(name):
    return importlib.import_module(f"libskylark_tpu.cli.{name}").main


def tmain(name):
    return importlib.import_module(f"libskylark_tpu_torch.cli.{name}").main


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    # The JAX package's plans off (its plan path needs an API the installed
    # jax removed); the port keeps its default, planned path.
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    for knob in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(knob, raising=False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def _both(name, argv, capsys):
    """Run the JAX driver and the port's (on the CPU) on ``argv`` with
    ``{pkg}`` replaced by ``j``/``t`` in output names, both with ``--x64``
    where the driver has it; returns both outputs."""
    outs = []
    for tag, fn, extra in (("j", jmain(name), []), ("t", tmain(name), CPU)):
        args = [a.replace("{pkg}", tag) for a in argv]
        if name not in ("graph_se", "community", "convert2hdf5"):
            args += ["--x64"]
        capsys.readouterr()
        assert fn(args + extra) == 0
        outs.append(capsys.readouterr().out)
    return outs


def _acc(out):
    return float(out.split("Test accuracy:")[1].split("%")[0])


@pytest.fixture
def ls_file(tmp_path, rng):
    A = rng.standard_normal((600, 7))
    A[:, 3] *= 5.0
    b = A @ rng.standard_normal(7) + 0.1 * rng.standard_normal(600)
    write_libsvm(tmp_path / "ls.svm", A, b)
    return tmp_path, A, b


@pytest.fixture
def blob_files(tmp_path, rng):
    d = 4
    X0 = rng.standard_normal((40, d)) - 1.5
    X1 = rng.standard_normal((40, d)) + 1.5
    X = np.vstack([X0, X1])
    y = np.array([1] * 40 + [2] * 40)
    perm = rng.permutation(80)
    X, y = X[perm], y[perm]
    write_libsvm(tmp_path / "train", X[:64], y[:64])
    write_libsvm(tmp_path / "test", X[64:], y[64:])
    return tmp_path


# -- linear -------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["exact", "sketched", "accelerated", "lsrn"])
def test_linear_solution_matches_jax(ls_file, capsys, monkeypatch, solver):
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    root, A, b = ls_file
    outs = _both("linear", [str(root / "ls.svm"), "--solver", solver,
                            "--solution", str(root / "x_{pkg}.npy")], capsys)
    xj, xt = np.load(root / "x_j.npy"), np.load(root / "x_t.npy")
    assert xt.dtype == np.float64 and xt.shape == (7,)
    assert _rel(xt, xj) <= LS_TOL
    for out in outs:
        assert re.search(rf"Solved 600x7 \({solver}\) in [0-9.]+s; residual", out)


def test_linear_f32_without_x64(ls_file, capsys):
    root, A, b = ls_file
    assert tmain("linear")([str(root / "ls.svm"), "--solution", str(root / "x.npy")] + CPU) == 0
    x = np.load(root / "x.npy")
    assert x.dtype == np.float32
    ref = np.linalg.lstsq(A, b, rcond=None)[0]
    assert np.linalg.norm(A @ x - b) <= (1 + 1e-4) * np.linalg.norm(A @ ref - b)


def test_linear_stream_equals_whole_file_with_its_sketch(ls_file, capsys):
    """--stream folds the file in batches into S·A and S·b with the
    stream's default sketch (JLT at 4n, as in the JAX package); its x is
    the whole-file sketch-and-solve with that sketch, at the streaming
    tests' 1e-12, and the JAX package's --stream x at LS_TOL."""
    root, A, b = ls_file
    outs = _both("linear", [str(root / "ls.svm"), "--stream", "--batch-rows", "128",
                            "--solution", str(root / "s_{pkg}.npy")], capsys)
    xs, xj = np.load(root / "s_t.npy"), np.load(root / "s_j.npy")
    assert _rel(xs, xj) <= LS_TOL
    assert "Streaming 600x7 in batches of 128 rows" in outs[1]
    assert "(streamed sketch-and-solve, 5 batches)" in outs[1]
    S = T.sketch.JLT(600, 28, T.SketchContext(seed=38734))
    SA = S.apply(torch.from_numpy(A))
    Sb = S.apply(torch.from_numpy(b)[:, None])
    want = T.linalg.exact_least_squares(SA, Sb)[:, 0].numpy()
    assert _rel(xs, want) <= 1e-12
    # A control: another seed's sketch gives another x.
    S2 = T.sketch.JLT(600, 28, T.SketchContext(seed=1))
    other = T.linalg.exact_least_squares(S2.apply(torch.from_numpy(A)),
                                         S2.apply(torch.from_numpy(b)[:, None]))[:, 0].numpy()
    assert _rel(other, want) > 1e-6


def test_linear_stream_checkpoint_resume(ls_file, capsys):
    root, _, _ = ls_file
    base = [str(root / "ls.svm"), "--stream", "--batch-rows", "64", "--x64"] + CPU
    assert tmain("linear")(base + ["--solution", str(root / "a.npy")]) == 0
    ck = str(root / "ck")
    assert tmain("linear")(base + ["--solution", str(root / "b.npy"), "--checkpoint-dir", ck,
                                   "--checkpoint-every", "2"]) == 0
    assert tmain("linear")(base + ["--solution", str(root / "c.npy"), "--checkpoint-dir", ck,
                                   "--resume"]) == 0
    a = np.load(root / "a.npy")
    assert np.array_equal(a, np.load(root / "b.npy")) and np.array_equal(a, np.load(root / "c.npy"))


def test_linear_cond_est_reports_the_cwt_sketch(ls_file, capsys):
    """--cond-est sketches A with CWT (dense or sparse A), and reports
    the condition number of S·A: held against numpy's on the same S·A."""
    root, A, _ = ls_file
    for extra in ([], ["--sparse", "--solver", "exact"]):
        capsys.readouterr()
        try:
            tmain("linear")([str(root / "ls.svm"), "--cond-est", "--x64",
                             "--solution", str(root / "x.npy")] + extra + CPU)
        except NotImplementedError:
            assert extra  # a sparse A's exact solve fails after the report, as in JAX
        out = capsys.readouterr().out
        cond = float(re.search(r"Cond-est: cond ([0-9.e+-]+),", out).group(1))
        S = T.sketch.CWT(600, 28, T.SketchContext(seed=38734))
        SA = S.apply(torch.from_numpy(A)).numpy()
        assert abs(cond / np.linalg.cond(SA) - 1) <= 1e-3
        assert "effective rank 7/7 (sketch size 28)" in out


# -- svd ----------------------------------------------------------------------


def _svd_files(root, prefix):
    return [np.load(root / f"{prefix}.{k}.npy") for k in ("U", "S", "V")]


def test_svd_libsvm_matches_jax(tmp_path, rng, capsys):
    U = np.linalg.qr(rng.standard_normal((80, 12)))[0]
    V = np.linalg.qr(rng.standard_normal((12, 12)))[0]
    A = U @ np.diag(10 * 0.6 ** np.arange(12)) @ V.T
    write_libsvm(tmp_path / "a.svm", A, np.zeros(80))
    for extra in ([], ["--sparse"], ["-i", "2"]):
        _both("svd", [str(tmp_path / "a.svm"), "-k", "4", "--prefix",
                      str(tmp_path / "{pkg}")] + extra, capsys)
        (Ut, st, Vt), (Uj, sj, Vj) = _svd_files(tmp_path, "t"), _svd_files(tmp_path, "j")
        assert np.abs(st - sj).max() <= SVD_TOL * sj[0]
        assert np.abs((Ut * st) @ Vt.T - (Uj * sj) @ Vj.T).max() <= SVD_TOL * sj[0]


def test_svd_symmetric_and_streamed_profile_match_jax(tmp_path, rng, capsys):
    B = rng.standard_normal((20, 20))
    np.save(tmp_path / "a.npy", B + B.T)
    _both("svd", [str(tmp_path / "a.npy"), "--symmetric", "-k", "3", "-i", "3",
                  "--prefix", str(tmp_path / "{pkg}")], capsys)
    lt, lj = np.load(tmp_path / "t.S.npy"), np.load(tmp_path / "j.S.npy")
    assert np.abs(lt - lj).max() <= SVD_TOL * np.abs(lj).max()
    _both("svd", ["--profile", "64", "16", "-k", "3", "--stream", "16",
                  "--prefix", str(tmp_path / "p{pkg}")], capsys)
    st, sj = np.load(tmp_path / "pt.S.npy"), np.load(tmp_path / "pj.S.npy")
    assert np.abs(st - sj).max() <= SVD_TOL * sj[0]


def test_svd_arclist_and_ascii(tmp_path, capsys):
    (tmp_path / "g.txt").write_text("a b\nb c\nc a\nc d\nd e\ne f\nf d\n")
    _both("svd", [str(tmp_path / "g.txt"), "--filetype", "arclist", "--sparse", "-k", "2",
                  "--ascii", "--prefix", str(tmp_path / "{pkg}")], capsys)
    st, sj = np.loadtxt(tmp_path / "t.S"), np.loadtxt(tmp_path / "j.S")
    assert np.abs(st - sj).max() <= SVD_TOL * sj[0]


# -- krr ----------------------------------------------------------------------


@pytest.mark.parametrize("alg,tol", [("0", DIRECT), ("1", CG_TOL), ("2", DIRECT), ("3", DIRECT),
                                     ("4", CG_TOL)])
def test_krr_models_match_jax(blob_files, capsys, alg, tol):
    root = blob_files
    outs = _both("krr", ["--trainfile", str(root / "train"), "--testfile", str(root / "test"),
                         "--modelfile", str(root / "m_{pkg}.json"), "-a", alg,
                         "--sigma", "2.0", "-f", "64", "--tolerance", "1e-8"], capsys)
    assert _acc(outs[0]) == _acc(outs[1]) > 85.0
    Xt, _ = T.io.read_libsvm(root / "test", n_features=4)
    tm = T.ml.load_model(str(root / "m_t.json"), device="cpu")
    jm = J.ml.load_model(root / "m_j.json")
    assert _rel(tm.predict(torch.from_numpy(Xt)).numpy(), jm.predict(Xt)) <= tol
    assert list(tm.classes) == list(np.asarray(jm.classes).tolist()) == [1.0, 2.0]


def test_krr_model_files_cross_packages(blob_files, capsys):
    """A model saved by one package predicts the same in the other."""
    root = blob_files
    _both("krr", ["--trainfile", str(root / "train"), "--modelfile", str(root / "m_{pkg}.json"),
                  "-a", "2", "--sigma", "2.0", "-f", "64"], capsys)
    Xt, _ = T.io.read_libsvm(root / "test", n_features=4)
    for path in (root / "m_t.json", root / "m_j.json"):
        tm = T.ml.load_model(str(path), device="cpu")
        jm = J.ml.load_model(path)
        assert _rel(tm.predict(torch.from_numpy(Xt)).numpy(), jm.predict(Xt)) <= DIRECT
        np.testing.assert_array_equal(tm.predict_labels(torch.from_numpy(Xt)).numpy(),
                                      np.asarray(jm.predict_labels(Xt)))


def test_krr_stream_matches_jax_and_whole_file(tmp_path, rng, capsys):
    X = rng.standard_normal((100, 3))
    y = X.sum(1)
    write_libsvm(tmp_path / "train", X, y)
    args = ["--trainfile", str(tmp_path / "train"), "-a", "2", "--regression", "--sigma", "3.0",
            "-f", "64", "--lambda", "0.001"]
    _both("krr", args + ["--stream", "--batch-rows", "30", "--modelfile",
                         str(tmp_path / "s_{pkg}.json")], capsys)
    assert tmain("krr")(args + ["--x64", "--modelfile", str(tmp_path / "w.json")] + CPU) == 0
    st = T.ml.load_model(str(tmp_path / "s_t.json"), device="cpu")
    sj = J.ml.load_model(tmp_path / "s_j.json")
    w = T.ml.load_model(str(tmp_path / "w.json"), device="cpu")
    Xt = torch.from_numpy(X[:20])
    assert _rel(st.predict(Xt).numpy(), sj.predict(X[:20])) <= DIRECT
    assert _rel(st.predict(Xt).numpy(), w.predict(Xt).numpy()) <= 1e-9


# -- ml -----------------------------------------------------------------------


@pytest.mark.parametrize("fast", [False, True])
def test_ml_train_matches_jax(blob_files, capsys, fast):
    root = blob_files
    outs = _both("ml", ["--trainfile", str(root / "train"), "--testfile", str(root / "test"),
                        "--modelfile", str(root / "a_{pkg}.json"), "-l", "hinge", "-g", "2.0",
                        "-f", "256", "-n", "2", "-i", "12", "--lambda", "0.005"]
                 + (["--usefast"] if fast else []), capsys)
    assert _acc(outs[0]) == _acc(outs[1]) > 85.0
    tm = T.ml.load_model(str(root / "a_t.json"), device="cpu")
    jm = J.ml.load_model(root / "a_j.json")
    assert _rel(tm.W.numpy(), jm.W) <= ADMM_TOL
    objective = [float(re.search(r"final objective ([0-9.e+-]+)", o).group(1)) for o in outs]
    assert abs(objective[1] / objective[0] - 1) <= 1e-6  # printed to 7 digits


def test_ml_models_predict_across_packages(blob_files, capsys):
    """Train in one package, predict in the other through the driver."""
    root = blob_files
    _both("ml", ["--trainfile", str(root / "train"), "--modelfile", str(root / "a_{pkg}.json"),
                 "-l", "squared", "-g", "2.0", "-f", "64", "-n", "2", "-i", "8"], capsys)
    accs = []
    for model in ("a_j.json", "a_t.json"):
        for fn, extra in ((jmain("ml"), []), (tmain("ml"), CPU)):
            capsys.readouterr()
            assert fn(["--testfile", str(root / "test"), "--modelfile", str(root / model)]
                      + extra) == 0
            accs.append(_acc(capsys.readouterr().out))
    assert len(set(accs)) == 1 and accs[0] > 85.0


def test_ml_checkpointed_training_resumes(blob_files, capsys):
    root = blob_files
    base = ["--trainfile", str(root / "train"), "-f", "32", "-n", "2", "-i", "6", "--x64"] + CPU
    assert tmain("ml")(base + ["--modelfile", str(root / "w.json")]) == 0
    assert tmain("ml")(base + ["--modelfile", str(root / "c.json"), "--checkpoint-dir",
                               str(root / "ck"), "--checkpoint-every", "2"]) == 0
    w = T.ml.load_model(str(root / "w.json"), device="cpu")
    c = T.ml.load_model(str(root / "c.json"), device="cpu")
    assert torch.equal(w.W, c.W)


# -- graph_se and community ---------------------------------------------------


def _community_file(tmp_path, rng, n_per=30):
    n = 2 * n_per
    lines = [f"v{i} v{j}" for i in range(n) for j in range(i + 1, n)
             if rng.random() < (0.5 if (i < n_per) == (j < n_per) else 0.02)]
    (tmp_path / "g.txt").write_text("\n".join(lines) + "\n")
    return tmp_path / "g.txt"


@pytest.mark.parametrize("extra", [["--sparse", "-i", "2"], ["-i", "1"],
                                   ["--streamed", "--batch-edges", "40"]])
def test_graph_se_matches_jax(tmp_path, rng, capsys, f64_default, extra):
    path = _community_file(tmp_path, rng)
    outs = _both("graph_se", [str(path), "-k", "3", "--prefix", str(tmp_path / "{pkg}")] + extra,
                 capsys)
    assert outs[0].splitlines()[0] == outs[1].splitlines()[0]  # "Read graph: ..."
    Xt, Xj = np.load(tmp_path / "t.X.npy"), np.load(tmp_path / "j.X.npy")
    signs = np.sign((Xt * Xj).sum(axis=0))
    assert np.abs(Xt * signs - Xj).max() <= ASE_TOL * np.abs(Xj).max()
    assert (tmp_path / "t.index.txt").read_text() == (tmp_path / "j.index.txt").read_text()


def test_graph_se_streamed_folds_in_the_default_dtype(tmp_path, rng, capsys):
    """Without f64 as torch's default the streamed fold runs in f32 (as
    the JAX driver's f64 request does without x64), the dtype whose
    segment sum takes the kernel on the card; the embedding is the f64
    fold's to f32 rounding."""
    path = _community_file(tmp_path, rng)
    argv = [str(path), "-k", "3", "--streamed", "--batch-edges", "40"] + CPU
    assert tmain("graph_se")(argv + ["--prefix", str(tmp_path / "f32")]) == 0
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert tmain("graph_se")(argv + ["--prefix", str(tmp_path / "f64")]) == 0
    finally:
        torch.set_default_dtype(old)
    X32, X64 = np.load(tmp_path / "f32.X.npy"), np.load(tmp_path / "f64.X.npy")
    assert X32.dtype == np.float32 and X64.dtype == np.float64
    signs = np.sign((X32 * X64).sum(axis=0))
    assert np.abs(X32 * signs - X64).max() <= 1e-4 * np.abs(X64).max()


@pytest.mark.parametrize("extra", [[], ["--recursive"], ["--seed", "v3"]])
def test_community_matches_jax(tmp_path, rng, capsys, extra):
    path = _community_file(tmp_path, rng)
    outs = _both("community", [str(path), "--seed", "v0", "--epsilon", "1e-4"] + extra, capsys)
    assert outs[0] == outs[1]
    assert "Conductance: " in outs[1] and "Cluster: " in outs[1]


def test_community_unknown_vertex_and_interactive(tmp_path, rng, capsys, monkeypatch):
    import io

    path = _community_file(tmp_path, rng)
    assert tmain("community")([str(path), "--seed", "nope"] + CPU) == 1
    assert "unknown vertex 'nope'" in capsys.readouterr().out
    outs = []
    for fn, extra in ((jmain("community"), []), (tmain("community"), CPU)):
        monkeypatch.setattr("sys.stdin", io.StringIO("v0 v1\nv40\n\n"))
        assert fn([str(path), "-i"] + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1].count("Conductance:") == 2


# -- convert2hdf5 -------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_convert2hdf5_matches_jax(blob_files, capsys, sparse):
    h5py = pytest.importorskip("h5py")
    root = blob_files
    outs = _both("convert2hdf5", [str(root / "train"), str(root / "{pkg}.h5")]
                 + (["--sparse"] if sparse else []), capsys)
    assert outs[0].replace("j.h5", "t.h5") == outs[1]
    with h5py.File(root / "t.h5") as ft, h5py.File(root / "j.h5") as fj:
        assert sorted(ft) == sorted(fj)
        for key in ft:
            np.testing.assert_array_equal(ft[key][()], fj[key][()])


# -- deferred flags and the device rule ----------------------------------------


@pytest.mark.parametrize("name,argv,item", [
    ("linear", ["--shard"], "item 9"),
    ("linear", ["--stream", "--distributed"], "item 9"),
    ("linear", ["--resume-policy", "repartition"], "item 9"),
    ("linear", ["--collective-timeout", "5"], "item 9"),
    ("svd", ["--shard"], "item 9"),
    ("ml", ["--distributed"], "item 9"),
    ("ml", ["--resume-policy", "strict"], "item 9"),
    ("ml", ["--collective-timeout", "1"], "item 9"),
])
def test_deferred_flags_raise_naming_their_item(blob_files, name, argv, item, monkeypatch):
    root = blob_files
    files = {"linear": [str(root / "train")], "svd": [str(root / "train")],
             "krr": ["--trainfile", str(root / "train")],
             "ml": ["--trainfile", str(root / "train")]}[name]
    if "--shard" in argv:  # sharded-input routes (item 9c): ported, one CPU slot
        out = ["--solution", str(root / "x.npy")] if name == "linear" else \
            ["--prefix", str(root / "svd"), "-k", "2"]
        plain = ["--solution", str(root / "x0.npy")] if name == "linear" else \
            ["--prefix", str(root / "svd0"), "-k", "2"]
        # One thread for the bitwise pin: on a loaded host MKL may run a GEMM
        # on fewer threads than torch asks for, and its bits follow the count.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert tmain(name)(files + argv + out + CPU) == 0
            assert tmain(name)(files + plain + CPU) == 0
        finally:
            torch.set_num_threads(threads)
        for suffix in ((".npy",) if name == "linear" else (".U.npy", ".S.npy", ".V.npy")):
            first = "x" if name == "linear" else "svd"
            np.testing.assert_array_equal(np.load(root / f"{first}{suffix}"),
                                          np.load(root / f"{first}0{suffix}"))
        return
    # The elastic flags are ported: --distributed joins the world of the
    # RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT environment (one
    # process here), the knobs without it are accepted and unused, as in
    # the JAX drivers.
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    out = ["--solution", str(root / "x.npy")] if name == "linear" else \
        ["--modelfile", str(root / "m.json"), "-f", "16", "-n", "2", "-i", "2"]
    assert tmain(name)(files + argv + out + CPU) == 0
    import torch.distributed as dist

    assert not dist.is_initialized()  # the driver left the world it joined


def _ledger_events(directory):
    """The (kind, name) of a ledger's events, the plans layer's and the
    port's own spans left out: the JAX side runs with its plans off (plan
    events exist only on the port's side), and the JAX package opens only
    the streaming and training spans."""
    import glob
    import json

    from libskylark_tpu_torch.telemetry import SPANS

    port_spans = set(SPANS) - {"stream.chunk", "train.stream", "train.factor", "train.iterate"}
    events = []
    for path in sorted(glob.glob(str(directory / "ledger-*.jsonl"))):
        with open(path, encoding="utf-8") as fh:
            events += [json.loads(line) for line in fh]
    return [(e["kind"], e["name"]) for e in events
            if e["kind"] != "plan" and e["name"] not in port_spans]


@pytest.mark.parametrize("name,argv", [
    ("linear", ["--telemetry"]),
    ("linear", ["--telemetry-dir", "tdir"]),
    ("svd", ["-k", "2", "--telemetry"]),
    ("krr", ["--telemetry"]),
    ("krr", ["-a", "2", "--telemetry-dir", "tdir"]),
    ("ml", ["--telemetry-dir", "tdir"]),
])
def test_telemetry_flags_work_as_in_jax(blob_files, capsys, monkeypatch, name, argv):
    """The telemetry flags run: ``--telemetry`` prints the JAX driver's
    summary line (the plan-cache hit rate aside: the JAX plans are off
    here), ``--telemetry-dir`` writes a ledger holding the JAX driver's
    events on the same input, a ``run_summary`` last where there is one;
    after the port's driver ``SKYLARK_TELEMETRY`` and the ledger
    directory are back to their values before it, and its ledger is
    closed."""
    from libskylark_tpu_torch.telemetry import ledger as tledger

    root = blob_files
    files = {"linear": [str(root / "train"), "--solution", str(root / "x.npy")],
             "svd": [str(root / "train"), "--prefix", str(root / "svd")],
             "krr": ["--trainfile", str(root / "train"), "--modelfile", str(root / "m")],
             "ml": ["--trainfile", str(root / "train"), "--modelfile", str(root / "m")]}[name]
    outs, ledgers = [], []
    for tag, fn, pkg, extra in (("j", jmain(name), J, []), ("t", tmain(name), T, CPU)):
        monkeypatch.setenv("SKYLARK_TELEMETRY", "0")  # the JAX driver sets it for good
        args = [str(root / f"tdir_{tag}") if a == "tdir" else a for a in argv]
        pkg.telemetry.reset()
        capsys.readouterr()
        try:
            assert fn(files + args + ["--x64"] + extra) == 0
        finally:
            pkg.telemetry.close()
        outs.append(capsys.readouterr().out)
        if tag == "t":
            assert os.environ["SKYLARK_TELEMETRY"] == "0"
            assert tledger._STATE["dir"] is None and T.telemetry.ledger_path() is None
        pkg.telemetry.configure(None)
        pkg.telemetry.reset()
        ledgers.append(_ledger_events(root / f"tdir_{tag}"))
    if "--telemetry-dir" in argv:
        assert ledgers[1] == ledgers[0]
        # The ledger opens at its first event: a run without one writes none
        # (the port's own spans are events too).
        import glob

        wrote = [bool(glob.glob(str(root / f"tdir_{tag}" / "ledger-*.jsonl")))
                 for tag in ("j", "t")]
        assert [("telemetry ledger -> " in out) for out in outs] == wrote
        assert wrote[0] == bool(ledgers[0]) and (wrote[1] or not ledgers[1])
        summaries = [i for i, ev in enumerate(ledgers[1]) if ev[0] == "run_summary"]
        assert summaries == ([len(ledgers[1]) - 1] if summaries else [])
        if name in ("linear", "krr"):
            assert summaries  # Blendenpik and approximate KRR close their runs
    else:
        lines = [re.sub(r"plan-cache hit rate [^,]*,", "", out.split("telemetry: ")[1])
                 for out in outs]
        assert lines[1] == lines[0]


def test_xla_cache_dir_warns_not_applied(blob_files, tmp_path):
    with pytest.warns(RuntimeWarning, match="--xla-cache-dir not applied"):
        assert tmain("linear")([str(blob_files / "train"), "--solver", "exact", "--solution",
                                str(tmp_path / "x.npy"), "--xla-cache-dir", str(tmp_path)]
                               + CPU) == 0


def test_plan_stats_report(ls_file, capsys):
    root, _, _ = ls_file
    assert tmain("linear")([str(root / "ls.svm"), "--solver", "sketched", "--plan-stats",
                            "--solution", str(root / "x.npy")] + CPU) == 0
    assert re.search(r"plan cache: \d+ hits / \d+ misses, \d+ traces", capsys.readouterr().out)


@pytest.mark.parametrize("name", DRIVERS)
def test_without_a_card_each_driver_raises(blob_files, tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
    root = blob_files
    (tmp_path / "g.txt").write_text("a b\nb c\n")
    argv = {"linear": [str(root / "train")], "svd": [str(root / "train")],
            "krr": ["--trainfile", str(root / "train")],
            "ml": ["--trainfile", str(root / "train")],
            "graph_se": [str(tmp_path / "g.txt")],
            "community": [str(tmp_path / "g.txt"), "--seed", "a"],
            "convert2hdf5": [str(root / "train"), str(tmp_path / "o.h5")],
            "serve": ["--no-prime"]}[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tmain(name)(argv)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tmain(name)(argv + ["--device", "cuda"])


def test_run_scope_puts_the_defaults_back(ls_file):
    from libskylark_tpu_torch import _device

    root, _, _ = ls_file
    before = (_device._DEFAULT_DEVICE, torch.get_default_dtype())
    assert tmain("linear")([str(root / "ls.svm"), "--x64", "--solution",
                            str(root / "x.npy")] + CPU) == 0
    assert (_device._DEFAULT_DEVICE, torch.get_default_dtype()) == before


# -- tests/test_cli_ml.py, case for case, on the port ---------------------------


class TestKrrCLI:
    @pytest.mark.parametrize("alg", [0, 1, 2])
    def test_classification(self, blob_files, alg, capsys):
        rc = tmain("krr")([
            "--trainfile", str(blob_files / "train"), "--testfile", str(blob_files / "test"),
            "--modelfile", str(blob_files / "m.json"), "-a", str(alg), "--sigma", "2.0",
            "-f", "256"] + CPU)
        assert rc == 0
        assert _acc(capsys.readouterr().out) > 85.0

    def test_regression(self, tmp_path, rng, capsys):
        X = rng.standard_normal((100, 3))
        y = X.sum(1)
        write_libsvm(tmp_path / "train", X, y)
        write_libsvm(tmp_path / "test", X[:20], y[:20])
        rc = tmain("krr")([
            "--trainfile", str(tmp_path / "train"), "--testfile", str(tmp_path / "test"),
            "--modelfile", str(tmp_path / "m.json"), "-a", "2", "--regression",
            "--sigma", "3.0", "-f", "512", "--lambda", "0.001"] + CPU)
        assert rc == 0
        assert float(capsys.readouterr().out.split("relative error:")[1]) < 0.2


class TestMlCLI:
    def test_train_and_predict(self, blob_files, capsys):
        rc = tmain("ml")([
            "--trainfile", str(blob_files / "train"), "--testfile", str(blob_files / "test"),
            "--modelfile", str(blob_files / "admm.json"), "-l", "hinge", "-g", "2.0",
            "-f", "256", "-n", "2", "-i", "25", "--lambda", "0.005"] + CPU)
        assert rc == 0
        assert _acc(capsys.readouterr().out) > 85.0

    def test_predict_from_saved_model(self, blob_files, capsys):
        tmain("ml")(["--trainfile", str(blob_files / "train"), "--modelfile",
                     str(blob_files / "admm2.json"), "-l", "squared", "-g", "2.0", "-f", "128",
                     "-n", "2", "-i", "15"] + CPU)
        capsys.readouterr()
        rc = tmain("ml")(["--testfile", str(blob_files / "test"), "--modelfile",
                          str(blob_files / "admm2.json")] + CPU)
        assert rc == 0
        assert _acc(capsys.readouterr().out) > 85.0


class TestStreamingPredict:
    def test_streaming_matches_batch(self, blob_files, capsys):
        tmain("ml")(["--trainfile", str(blob_files / "train"), "--modelfile",
                     str(blob_files / "sp.json"), "-l", "squared", "-g", "2.0", "-f", "128",
                     "-n", "2", "-i", "15"] + CPU)
        capsys.readouterr()
        rc = tmain("ml")(["--testfile", str(blob_files / "test"), "--modelfile",
                          str(blob_files / "sp.json"), "--outputfile",
                          str(blob_files / "preds.txt"), "--batch", "5"] + CPU)
        assert rc == 0
        acc_stream = _acc(capsys.readouterr().out)
        assert len((blob_files / "preds.txt").read_text().splitlines()) == 16
        rc = tmain("ml")(["--testfile", str(blob_files / "test"), "--modelfile",
                          str(blob_files / "sp.json")] + CPU)
        assert acc_stream == _acc(capsys.readouterr().out)


class TestStreamLibsvm:
    def test_batches_cover_file(self, tmp_path, rng):
        X = rng.standard_normal((23, 6))
        y = rng.standard_normal(23)
        write_libsvm(tmp_path / "s", X, y)
        chunks = list(T.io.stream_libsvm(tmp_path / "s", 6, batch=7))
        assert [len(c[1]) for c in chunks] == [7, 7, 7, 2]
        Xr, yr = T.io.read_libsvm(tmp_path / "s", n_features=6)
        np.testing.assert_allclose(np.vstack([c[0] for c in chunks]), Xr, rtol=1e-15)
        np.testing.assert_allclose(np.concatenate([c[1] for c in chunks]), yr, rtol=1e-15)


class TestStreamLibsvmSparse:
    def test_sparse_batches_match_dense(self, tmp_path, rng):
        X = rng.standard_normal((17, 8))
        X[rng.random((17, 8)) < 0.6] = 0
        y = rng.standard_normal(17)
        write_libsvm(tmp_path / "sp", X, y)
        dense = list(T.io.stream_libsvm(tmp_path / "sp", 8, batch=6))
        sparse = list(T.io.stream_libsvm(tmp_path / "sp", 8, batch=6, sparse=True))
        assert len(dense) == len(sparse) == 3
        for (Xd, yd), (Xs, ys) in zip(dense, sparse):
            np.testing.assert_allclose(Xs.to_dense().numpy(), Xd, rtol=1e-15)
            np.testing.assert_allclose(ys, yd)


class TestHdf5FileFormat:
    def test_convert_then_krr_hdf5_dense(self, blob_files, capsys):
        pytest.importorskip("h5py")
        for split in ("train", "test"):
            assert tmain("convert2hdf5")([str(blob_files / split),
                                          str(blob_files / f"{split}.h5")] + CPU) == 0
        capsys.readouterr()
        rc = tmain("krr")(["--trainfile", str(blob_files / "train.h5"), "--testfile",
                           str(blob_files / "test.h5"), "--modelfile", str(blob_files / "mh.json"),
                           "--fileformat", "hdf5_dense", "-a", "2", "--sigma", "2.0",
                           "-f", "256"] + CPU)
        assert rc == 0
        assert _acc(capsys.readouterr().out) > 85.0

    def test_convert_then_ml_hdf5_sparse(self, blob_files, capsys):
        pytest.importorskip("h5py")
        for split in ("train", "test"):
            assert tmain("convert2hdf5")([str(blob_files / split),
                                          str(blob_files / f"{split}s.h5"), "--sparse"]
                                         + CPU) == 0
        capsys.readouterr()
        rc = tmain("ml")(["--trainfile", str(blob_files / "trains.h5"), "--testfile",
                          str(blob_files / "tests.h5"), "--modelfile",
                          str(blob_files / "admmh.json"), "--fileformat", "hdf5_sparse",
                          "-l", "hinge", "-g", "2.0", "-f", "256", "-n", "2", "-i", "25",
                          "--lambda", "0.005"] + CPU)
        assert rc == 0
        assert _acc(capsys.readouterr().out) > 85.0

    def test_hdf5_streaming_predict_matches_batch(self, blob_files, capsys):
        pytest.importorskip("h5py")
        tmain("ml")(["--trainfile", str(blob_files / "train"), "--modelfile",
                     str(blob_files / "sph.json"), "-l", "squared", "-g", "2.0", "-f", "128",
                     "-n", "2", "-i", "15"] + CPU)
        tmain("convert2hdf5")([str(blob_files / "test"), str(blob_files / "testh.h5")] + CPU)
        capsys.readouterr()
        rc = tmain("ml")(["--testfile", str(blob_files / "testh.h5"), "--modelfile",
                          str(blob_files / "sph.json"), "--fileformat", "hdf5_dense",
                          "--outputfile", str(blob_files / "predh.txt"), "--batch", "5"] + CPU)
        assert rc == 0
        acc_stream = _acc(capsys.readouterr().out)
        assert len((blob_files / "predh.txt").read_text().splitlines()) == 16
        rc = tmain("ml")(["--testfile", str(blob_files / "test"), "--modelfile",
                          str(blob_files / "sph.json")] + CPU)
        assert acc_stream == _acc(capsys.readouterr().out)

    def test_stream_hdf5_sparse_batches(self, tmp_path, rng):
        pytest.importorskip("h5py")
        X = rng.standard_normal((17, 8))
        X[rng.random((17, 8)) < 0.6] = 0
        y = rng.standard_normal(17)
        T.io.write_hdf5(tmp_path / "s.h5", X, y, sparse=True)
        chunks = list(T.io.stream_hdf5(tmp_path / "s.h5", batch=6))
        assert [len(c[1]) for c in chunks] == [6, 6, 5]
        Xall = np.vstack([c[0].to_dense().numpy() for c in chunks])
        Xr, yr = T.io.read_hdf5(tmp_path / "s.h5", sparse=False)
        np.testing.assert_allclose(Xall, Xr, rtol=1e-15)
        np.testing.assert_allclose(np.concatenate([c[1] for c in chunks]), yr, rtol=1e-15)


class TestModelRoundTripAcrossCLIs:
    def test_krr_kernel_model_reloads_with_classes(self, blob_files):
        rc = tmain("krr")(["--trainfile", str(blob_files / "train"), "--modelfile",
                           str(blob_files / "km.json"), "-a", "0", "--sigma", "2.0"] + CPU)
        assert rc == 0
        m = T.ml.load_model(str(blob_files / "km.json"), device="cpu")
        assert isinstance(m, T.ml.KernelModel)
        assert m.classes is not None and len(m.classes) >= 2
        Xt, yt = T.io.read_libsvm(blob_files / "test")
        pred = m.predict_labels(torch.from_numpy(Xt)).numpy()
        assert (pred == yt).mean() > 0.85


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``main`` runs only as a script)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", ["linear", "linear sketched", "krr", "ml"])
def test_driver_ledgers_are_the_ones_chip_smoke_expects(tmp_path, rng, capsys, monkeypatch,
                                                        label):
    """Phase 3m of ``chip_smoke.py`` holds the port's driver ledgers on the
    card to ``CLI_LEDGERS``, run with phase 3l's flags: here the JAX
    package's drivers, and the port's, write exactly those on small files
    of the same kinds (a dense least-squares file, planted classes)."""
    expected = _chip_smoke().CLI_LEDGERS[label]
    A = rng.standard_normal((2000, 12))
    write_libsvm(tmp_path / "ls", A, A @ rng.standard_normal(12) + rng.standard_normal(2000))
    centers = 3.0 * rng.standard_normal((3, 20))
    y = rng.integers(0, 3, 600)
    X = centers[y] + rng.standard_normal((600, 20))
    write_libsvm(tmp_path / "train", X[:500], y[:500] + 1)
    write_libsvm(tmp_path / "test", X[500:], y[500:] + 1)
    ls, train, test = str(tmp_path / "ls"), str(tmp_path / "train"), str(tmp_path / "test")
    name, argv = {
        "linear": ("linear", [ls, "--cond-est", "--solution", str(tmp_path / "x.npy")]),
        "linear sketched": ("linear", [ls, "--solver", "sketched", "--solution",
                                       str(tmp_path / "x.npy")]),
        "krr": ("krr", ["--trainfile", train, "--testfile", test, "--modelfile",
                        str(tmp_path / "k.json"), "-a", "2", "--use-fast", "-f", "64", "--sigma",
                        "3", "--lambda", "0.01"]),
        "ml": ("ml", ["--trainfile", train, "--testfile", test, "--modelfile",
                      str(tmp_path / "m.json"), "--usefast", "-g", "3", "-f", "64", "-n", "4", "-i",
                      "5", "-l", "hinge", "--lambda", "0.01"]),
    }[label]
    for tag, fn, pkg, extra in (("j", jmain(name), J, []), ("t", tmain(name), T, CPU)):
        monkeypatch.setenv("SKYLARK_TELEMETRY", "0")
        pkg.telemetry.reset()
        try:
            assert fn(argv + ["--x64", "--telemetry-dir", str(tmp_path / tag)] + extra) == 0
        finally:
            pkg.telemetry.close()
            pkg.telemetry.configure(None)
            pkg.telemetry.reset()
        capsys.readouterr()
        assert _ledger_events(tmp_path / tag) == expected, tag


# -- serve and top ----------------------------------------------------------------


def test_serve_stdio_matches_jax(tmp_path, rng, capsys, monkeypatch):
    """The same frames on stdin to both daemons: least squares (FJLT and
    CWT systems), a kernel model's predict with labels, ping, and an
    unknown system's error envelope."""
    import io
    import json

    from libskylark_tpu.ml.kernels import GaussianKernel
    from libskylark_tpu.ml.model import KernelModel

    A = rng.standard_normal((200, 6))
    np.save(tmp_path / "A.npy", A)
    KernelModel(GaussianKernel(4, sigma=1.5), rng.standard_normal((30, 4)),
                rng.standard_normal((30, 3)), classes=[5, 6, 7]).save(str(tmp_path / "k.json"))
    frames = [{"id": i, "op": "ls_solve", "system": name, "b": rng.standard_normal(200).tolist()}
              for i, name in enumerate(("fjlt", "cwt", "fjlt"))]
    frames += [{"id": "p", "op": "predict", "model": "krr", "labels": True,
                "x": rng.standard_normal((2, 4)).tolist()},
               {"id": "ping", "op": "ping"},
               {"id": "bad", "op": "ls_solve", "system": "nope", "b": [0.0]}]
    lines = "".join(json.dumps(f) + "\n" for f in frames)
    outs = []
    for fn, extra in ((jmain("serve"), []), (tmain("serve"), CPU)):
        for sketch in ("FJLT", "CWT"):  # one daemon per sketch type, as the flag is global
            monkeypatch.setattr("sys.stdin", io.StringIO(lines))
            capsys.readouterr()
            assert fn(["--system", f"{sketch.lower()}={tmp_path / 'A.npy'}", "--model",
                       f"krr={tmp_path / 'k.json'}", "--sketch-type", sketch, "--x64"]
                      + extra) == 0
            outs.append([json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("{")])
    for j, t in ((outs[0], outs[2]), (outs[1], outs[3])):
        assert [r["id"] for r in t] == [r["id"] for r in j] == [f["id"] for f in frames]
        for rj, rt in zip(j, t):
            assert rt["ok"] == rj["ok"]
            if not rj["ok"]:
                assert rt["error"] == rj["error"]
            elif rj["id"] in (0, 1, 2):
                assert _rel(rt["result"], rj["result"]) <= LS_TOL
            else:
                assert rt["result"] == rj["result"]


@pytest.mark.parametrize("source", ["url", "telemetry-dir"])
def test_top_once_renders_as_jax(tmp_path, rng, capsys, monkeypatch, source):
    """``top --once`` of both packages against one port server (its
    /healthz, /stats, /traces, /slo and /timeline) or one port driver's
    ledger directory: the same frame but for the clock line."""
    import threading

    from libskylark_tpu_torch import serve

    srv = httpd = None
    if source == "url":
        monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
        T.telemetry.reset()
        srv = serve.Server(serve.ServeParams(warm_start=False), seed=1, device="cpu")
        srv.register_system("sys", rng.standard_normal((64, 4)))
        srv.start()
        for _ in range(3):
            assert srv.call(op="ls_solve", system="sys", b=rng.standard_normal(64).tolist())["ok"]
        httpd = serve.serve_http(srv)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        argv = ["--url", f"http://127.0.0.1:{httpd.server_address[1]}", "--once"]
    else:
        A = rng.standard_normal((300, 5))
        write_libsvm(tmp_path / "ls", A, A @ rng.standard_normal(5))
        monkeypatch.setenv("SKYLARK_TELEMETRY", "0")
        try:
            assert tmain("linear")([str(tmp_path / "ls"), "--solution", str(tmp_path / "x.npy"),
                                    "--telemetry-dir", str(tmp_path / "ledger")] + CPU) == 0
        finally:
            T.telemetry.close()
            T.telemetry.configure(None)
            T.telemetry.reset()
        argv = ["--telemetry-dir", str(tmp_path / "ledger"), "--once"]
    frames = []
    try:
        for fn in (jmain("top"), tmain("top")):
            capsys.readouterr()
            assert fn(argv) == 0
            frames.append(capsys.readouterr().out.splitlines())
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            srv.stop()
            T.telemetry.reset()
            serve.server._LATENCIES.clear()
    assert frames[0][0].startswith("skylark-top") and frames[1][0].startswith("skylark-top")
    assert frames[1][1:] == frames[0][1:] and len(frames[0]) > 2
    if source == "url":
        assert "requests 3  ok 3" in "\n".join(frames[1])
