"""``skylark_linear --shard`` and ``skylark_svd --shard`` of the port
against the JAX drivers' ``--shard``.

The JAX drivers shard A's rows over the 8 host devices of
``tests/conftest.py`` (``default_mesh()``, rows zero-padded to a
multiple of 8 by ``shard_rows_padded``, so the sketch is drawn for the
padded row count); the port runs ``--shard`` on the CPU with its
``default_mesh()`` set to 8 CPU slots, the same 2 × 4 mesh and the same
padding.  Held: the solution
within 1e-8 of the JAX one relative to its largest entry (the unsharded
drivers' parity is 1e-9, ``tests/test_torch_cli.py``; the slots' sums
move it by f64 rounding), the singular values within 1e-10, U·diag(S)·Vᵀ
within 1e-8, U trimmed back to the file's rows, and the same report
lines.  A 602-row file pads to 608.
"""

import re

import numpy as np
import pytest

from libskylark_tpu.io import write_libsvm
from test_torch_cli import CPU, jax_plain, jmain, tmain  # noqa: F401  (jax_plain: autouse)

SOLVERS = ["exact", "sketched", "accelerated", "lsrn"]


@pytest.fixture
def ls_file(tmp_path):
    rng = np.random.default_rng(31)
    A = rng.standard_normal((602, 7))
    A[:, 3] *= 5.0
    b = A @ rng.standard_normal(7) + 0.1 * rng.standard_normal(602)
    write_libsvm(tmp_path / "ls.svm", A, b)
    return tmp_path, A, b


@pytest.fixture(autouse=True)
def eight_slots(monkeypatch):
    """The port's ``default_mesh()`` as JAX's on its 8 host devices: 2 × 4
    slots, here all on the CPU."""
    import libskylark_tpu_torch.parallel as tpar

    mesh = tpar.default_mesh
    monkeypatch.setattr(tpar, "default_mesh", lambda n_devices=None, device=None:
                        mesh(8, device="cpu"))


def _rel(port, ref):
    return np.abs(port - ref).max() / np.abs(ref).max()


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", line)]


def _run_both(name, argv, capsys):
    outs = []
    for tag, fn, extra in (("j", jmain(name), []),
                           ("t", tmain(name), CPU)):
        capsys.readouterr()
        assert fn([a.replace("{pkg}", tag) for a in argv] + ["--x64", "--shard"] + extra) == 0
        outs.append(capsys.readouterr().out)
    return outs


@pytest.mark.parametrize("solver", SOLVERS)
def test_linear_shard_matches_jax(ls_file, capsys, monkeypatch, solver):
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    root, A, b = ls_file
    outs = _run_both("linear", [str(root / "ls.svm"), "--solver", solver,
                                "--solution", str(root / "x_{pkg}.npy")], capsys)
    xj, xt = np.load(root / "x_j.npy"), np.load(root / "x_t.npy")
    assert xt.shape == (7,) and _rel(xt, xj) <= 1e-8
    lines = [next(ln for ln in out.splitlines() if ln.startswith("Solved")) for out in outs]
    assert lines[0].split(" in ")[0] == lines[1].split(" in ")[0] == f"Solved 602x7 ({solver})"
    rj, rt = _numbers(lines[0].split("residual")[1]), _numbers(lines[1].split("residual")[1])
    assert rt == pytest.approx(rj, rel=1e-8)


def test_svd_shard_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(32)
    A = rng.standard_normal((602, 3)) @ rng.standard_normal((3, 12))
    A += 0.01 * rng.standard_normal((602, 12))
    write_libsvm(tmp_path / "a.svm", A, np.zeros(602))
    outs = _run_both("svd", [str(tmp_path / "a.svm"), "-k", "3", "-i", "1",
                             "--prefix", str(tmp_path / "{pkg}")], capsys)
    U, S, V = ({tag: np.load(tmp_path / f"{tag}.{f}.npy") for tag in "jt"} for f in "USV")
    assert U["t"].shape == (602, 3)
    assert _rel(S["t"], S["j"]) <= 1e-10
    rec = {tag: (U[tag] * S[tag]) @ V[tag].T for tag in "jt"}
    assert _rel(rec["t"], rec["j"]) <= 1e-8
    heads = [out.splitlines()[0].split(" in ")[0] for out in outs]
    assert heads[0] == heads[1] == "Rank-3 SVD of 602x12"


def test_shard_ignores_a_sparse_input_as_jax(tmp_path, capsys):
    rng = np.random.default_rng(33)
    A = rng.standard_normal((602, 12)) * (rng.random((602, 12)) < 0.3)
    write_libsvm(tmp_path / "a.svm", A, np.zeros(602))
    outs = _run_both("svd", [str(tmp_path / "a.svm"), "--sparse", "-k", "3",
                             "--prefix", str(tmp_path / "{pkg}")], capsys)
    for out in outs:
        assert "warning: --shard ignores sparse inputs" in out
    assert _rel(np.load(tmp_path / "t.S.npy"), np.load(tmp_path / "j.S.npy")) <= 1e-10
