"""Port vs JAX package: the IO layer (``io.source``, ``io.libsvm``,
``io.hdf5``, ``io.arclist``) and ``graph.read_arc_list``, on the same
files made from a seed.

``tests/test_io.py`` mirrored case for case, each case run through both
packages (the retry count also in the port's ledger, beside the JAX
package's event).  Tolerances: none — dense reads, labels,
batches, scans and arc-list blocks are held bitwise equal to the JAX
package's, and a sparse read's ``(indices, values)`` bitwise equal to
the BCOO's, in the same (file) order, uncoalesced.
"""

import numpy as np
import pytest
import torch

import libskylark_tpu.io as JIO
import libskylark_tpu_torch.io as TIO
from libskylark_tpu.graph import read_arc_list as jax_read_arc_list
from libskylark_tpu_torch import native
from libskylark_tpu_torch.graph import read_arc_list


def _same_sparse(Xt, Xj):
    """The port's COO holds the BCOO's entries, bitwise, in the same order."""
    assert Xt.layout == torch.sparse_coo and not Xt.is_coalesced()
    assert Xt._indices().dtype == torch.int64
    assert tuple(Xt.shape) == tuple(Xj.shape)
    np.testing.assert_array_equal(Xt._indices().T.numpy(), np.asarray(Xj.indices))
    vals = Xt._values().numpy()
    assert vals.dtype == np.asarray(Xj.data).dtype
    np.testing.assert_array_equal(vals, np.asarray(Xj.data))


def _both(fn_name, *args, **kw):
    return getattr(TIO, fn_name)(*args, **kw), getattr(JIO, fn_name)(*args, **kw)


def test_roundtrip_dense(tmp_path, rng):
    X = rng.standard_normal((20, 7))
    X[rng.random((20, 7)) < 0.5] = 0.0
    y = rng.integers(0, 3, 20).astype(float)
    TIO.write_libsvm(tmp_path / "f", X, y)
    JIO.write_libsvm(tmp_path / "g", X, y)
    assert (tmp_path / "f").read_bytes() == (tmp_path / "g").read_bytes()
    (X2, y2), (Xj, yj) = _both("read_libsvm", tmp_path / "f", n_features=7)
    assert isinstance(X2, np.ndarray)
    np.testing.assert_allclose(X2, X, rtol=1e-15)
    np.testing.assert_array_equal(X2, Xj)
    np.testing.assert_array_equal(y2, yj)


def test_roundtrip_sparse(tmp_path, rng):
    X = rng.standard_normal((15, 9))
    X[rng.random((15, 9)) < 0.7] = 0.0
    y = rng.standard_normal(15)
    TIO.write_libsvm(tmp_path / "f", X, y)
    (Xs, y2), (Xj, yj) = _both("read_libsvm", tmp_path / "f", n_features=9, sparse=True)
    _same_sparse(Xs, Xj)
    np.testing.assert_allclose(Xs.to_dense().numpy(), X, rtol=1e-15)
    np.testing.assert_array_equal(y2, yj)
    # A COO written back is the same file.
    TIO.write_libsvm(tmp_path / "g", Xs, y2)
    assert (tmp_path / "g").read_bytes() == (tmp_path / "f").read_bytes()


def test_sparse_read_keeps_file_order_and_duplicates(tmp_path):
    """Entries stay in the file's order (columns out of order in a line,
    a repeated column): nothing sorts or sums them."""
    (tmp_path / "f").write_text("1 3:1.5 1:2.0 3:0.25\n-1 2:4.0 1:1.0\n")
    (Xs, _), (Xj, _) = _both("read_libsvm", tmp_path / "f", sparse=True)
    _same_sparse(Xs, Xj)
    assert Xs._indices().T.tolist() == [[0, 2], [0, 0], [0, 2], [1, 1], [1, 0]]


def test_1_based_indices(tmp_path):
    (tmp_path / "f").write_text("1 1:2.5 3:1.0\n-1 2:0.5\n")
    (X, y), (Xj, yj) = _both("read_libsvm", tmp_path / "f")
    assert X.shape == (2, 3)
    np.testing.assert_allclose(X, [[2.5, 0, 1.0], [0, 0.5, 0]])
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_comments_and_blank_lines(tmp_path):
    (tmp_path / "f").write_text("# header\n\n1 1:2.5 3:1 # trailing\n\n-1 2:0.5\n")
    for sparse in (False, True):
        (X, y), (Xj, yj) = _both("read_libsvm", tmp_path / "f", sparse=sparse)
        if sparse:
            _same_sparse(X, Xj)
        else:
            np.testing.assert_array_equal(X, Xj)
        np.testing.assert_array_equal(y, [1, -1])
        np.testing.assert_array_equal(y, yj)


def test_pad_features(tmp_path):
    (tmp_path / "f").write_text("0 1:1\n")
    (X, _), (Xj, _) = _both("read_libsvm", tmp_path / "f", n_features=5)
    assert X.shape == (1, 5)
    np.testing.assert_array_equal(X, Xj)


def test_clip_features(tmp_path):
    (tmp_path / "f").write_text("0 1:1 4:2\n1 2:3 5:4\n")
    (Xs, _), (Xj, _) = _both("read_libsvm", tmp_path / "f", n_features=3, sparse=True)
    _same_sparse(Xs, Xj)
    assert tuple(Xs.shape) == (2, 3)


def test_max_rows(tmp_path):
    (tmp_path / "f").write_text("1 1:1\n2 2:2\n3 3:3\n")
    (X, y), (Xj, yj) = _both("read_libsvm", tmp_path / "f", n_features=3, max_rows=2)
    assert X.shape == (2, 3)
    np.testing.assert_allclose(y, [1, 2])
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    (Xs, ys), (Xsj, _) = _both("read_libsvm", tmp_path / "f", n_features=3, max_rows=2,
                               sparse=True)
    assert tuple(Xs.shape) == (2, 3)
    _same_sparse(Xs, Xsj)
    np.testing.assert_array_equal(Xs.to_dense().numpy(), X)
    # max_rows beyond the file is a no-op
    X3, _ = TIO.read_libsvm(tmp_path / "f", max_rows=99)
    assert X3.shape[0] == 3
    # inferred width comes from the KEPT rows only
    (X4, _), (X4j, _) = _both("read_libsvm", tmp_path / "f", max_rows=2)
    assert X4.shape == (2, 2)
    np.testing.assert_array_equal(X4, X4j)


@pytest.mark.parametrize("sparse", [False, True])
def test_python_fallback_equals_native_parser(tmp_path, rng, monkeypatch, sparse):
    """The strict per-line parser (no compiler, or malformed input) reads
    the same arrays as the native one, bitwise, and the native call
    counter moves only on the native path."""
    assert native.available()
    X = rng.standard_normal((30, 6))
    X[rng.random((30, 6)) < 0.5] = 0.0
    y = rng.integers(0, 4, 30).astype(float)
    TIO.write_libsvm(tmp_path / "f", X, y)
    calls = native.parse_libsvm_bytes.calls
    Xn, yn = TIO.read_libsvm(tmp_path / "f", sparse=sparse)
    assert native.parse_libsvm_bytes.calls == calls + 1
    monkeypatch.setattr(native, "available", lambda: False)
    Xp, yp = TIO.read_libsvm(tmp_path / "f", sparse=sparse)
    assert native.parse_libsvm_bytes.calls == calls + 1
    if sparse:
        assert torch.equal(Xn._indices(), Xp._indices())
        assert torch.equal(Xn._values(), Xp._values())
    else:
        np.testing.assert_array_equal(Xn, Xp)
    np.testing.assert_array_equal(yn, yp)


@pytest.mark.parametrize("text", [b"1 0:2.0\n", b"1 x:2.0\n", b"1 2\n"])
def test_malformed_input_raises_value_error(text):
    """Malformed text fails the native parser and raises the strict
    parser's ValueError, in both packages, read whole or streamed."""
    with pytest.raises(ValueError):
        TIO.read_libsvm(text)
    with pytest.raises(ValueError):
        JIO.read_libsvm(text)
    with pytest.raises(ValueError):
        list(TIO.stream_libsvm(text, n_features=2))
    with pytest.raises(ValueError):
        list(JIO.stream_libsvm(text, n_features=2))


# -- byte-source seam (≙ the HDFS reader role, libsvm_io.hpp:1495-1638) ----


def test_memory_source_read(rng):
    data = b"1 1:2.0 2:3.0\n-1 2:1.5\n"
    X, y = TIO.read_libsvm(TIO.MemorySource(data), n_features=2)
    Xj, yj = JIO.read_libsvm(JIO.MemorySource(data), n_features=2)
    np.testing.assert_allclose(X, [[2.0, 3.0], [0.0, 1.5]])
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    # raw bytes coerce too
    X2, _ = TIO.read_libsvm(data, n_features=2)
    np.testing.assert_array_equal(X2, X)


def _stream_both(src_t, src_j, *args, **kw):
    return list(TIO.stream_libsvm(src_t, *args, **kw)), list(JIO.stream_libsvm(src_j, *args, **kw))


def _same_batches(bt, bj):
    assert [len(b[1]) for b in bt] == [len(b[1]) for b in bj]
    for (Xt, yt), (Xj, yj) in zip(bt, bj):
        if isinstance(Xt, torch.Tensor):
            _same_sparse(Xt, Xj)
        else:
            np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)


def test_stream_from_source(rng):
    lines = [f"{i % 2} 1:{i}.0" for i in range(10)]
    data = ("\n".join(lines) + "\n").encode()
    bt, bj = _stream_both(TIO.MemorySource(data), JIO.MemorySource(data), n_features=1, batch=4)
    assert [len(b[1]) for b in bt] == [4, 4, 2]
    got = np.concatenate([b[0][:, 0] for b in bt])
    np.testing.assert_allclose(got, np.arange(10.0))
    _same_batches(bt, bj)


def test_stream_no_trailing_newline():
    data = b"1 1:1.0\n2 1:2.0\n3 1:3.0"  # note: no final \n
    bt, bj = _stream_both(data, data, n_features=1, batch=2)
    assert [len(b[1]) for b in bt] == [2, 1]
    np.testing.assert_allclose(np.concatenate([b[1] for b in bt]), [1, 2, 3])
    _same_batches(bt, bj)


@pytest.mark.parametrize("sparse", [False, True])
def test_stream_example_spans_chunk_boundary(sparse):
    lines = [f"{i} 1:{i}.5 2:{i * 10}.25 3:{i * 100}.125" for i in range(7)]
    data = ("\n".join(lines) + "\n").encode()
    assert max(len(l) for l in lines) > 8
    bt, bj = _stream_both(data, data, n_features=3, batch=3, chunk_bytes=8, sparse=sparse)
    assert [len(b[1]) for b in bt] == [3, 3, 1]
    X = np.concatenate([b[0].to_dense().numpy() if sparse else b[0] for b in bt])
    np.testing.assert_allclose(np.concatenate([b[1] for b in bt]), np.arange(7.0))
    np.testing.assert_allclose(X[:, 0], np.arange(7) + 0.5)
    np.testing.assert_allclose(X[:, 2], np.arange(7) * 100 + 0.125)
    _same_batches(bt, bj)


def test_stream_empty_source():
    assert list(TIO.stream_libsvm(b"", n_features=4)) == []
    assert list(TIO.stream_libsvm(TIO.MemorySource(b""), n_features=4)) == []
    assert list(TIO.stream_libsvm(b"\n# nothing\n\n", n_features=4)) == []


def test_stream_raw_bytes_and_memory_source_agree(tmp_path, rng):
    X = rng.standard_normal((9, 4))
    X[rng.random((9, 4)) < 0.5] = 0.0
    y = rng.standard_normal(9)
    path = str(tmp_path / "f.libsvm")
    TIO.write_libsvm(path, X, y)
    data = open(path, "rb").read()

    def collect(src):
        bs = list(TIO.stream_libsvm(src, n_features=4, batch=4))
        return np.concatenate([b[0] for b in bs]), np.concatenate([b[1] for b in bs])

    Xf, yf = collect(path)
    Xb, yb = collect(data)
    Xm, ym = collect(TIO.MemorySource(data))
    np.testing.assert_array_equal(Xb, Xf)
    np.testing.assert_array_equal(Xm, Xf)
    np.testing.assert_array_equal(yb, yf)
    np.testing.assert_array_equal(ym, yf)
    np.testing.assert_allclose(Xf, X, rtol=1e-15)
    _same_batches(*_stream_both(path, path, n_features=4, batch=4))


def test_stream_batches_cover_file(tmp_path, rng):
    """Batches concatenate to the whole-file read (dense and sparse, the
    sparse one bitwise the JAX package's per-batch BCOOs)."""
    X = rng.standard_normal((23, 6))
    X[rng.random((23, 6)) < 0.6] = 0
    y = rng.standard_normal(23)
    TIO.write_libsvm(tmp_path / "s", X, y)
    for sparse in (False, True):
        bt, bj = _stream_both(tmp_path / "s", tmp_path / "s", 6, batch=7, sparse=sparse,
                              chunk_bytes=64)
        assert [len(c[1]) for c in bt] == [7, 7, 7, 2]
        _same_batches(bt, bj)
    Xr, yr = TIO.read_libsvm(tmp_path / "s", n_features=6)
    dense = list(TIO.stream_libsvm(tmp_path / "s", 6, batch=7))
    np.testing.assert_array_equal(np.vstack([c[0] for c in dense]), Xr)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in dense]), yr)


def test_scan_libsvm_dims(tmp_path):
    (tmp_path / "f").write_text(
        "# header comment\n1 1:1.0 7:2.0\n\n-1 3:4.0  # trailing\n2 2:1.0"
    )
    assert TIO.scan_libsvm_dims(tmp_path / "f") == (3, 7) == JIO.scan_libsvm_dims(tmp_path / "f")
    assert TIO.scan_libsvm_dims(b"") == (0, 0)
    # tiny chunks: counting must survive lines split across reads
    assert TIO.scan_libsvm_dims(b"1 1:1.0\n2 12:3.0\n", chunk_bytes=4) == (2, 12)


def test_file_url_and_scheme_registry(tmp_path):
    (tmp_path / "f").write_text("1 1:4.0\n")
    X, _ = TIO.read_libsvm(f"file://{tmp_path}/f")
    np.testing.assert_allclose(X, [[4.0]])

    TIO.register_scheme("torchmem", lambda url: TIO.MemorySource(b"1 1:7.0\n"))
    X2, _ = TIO.read_libsvm("torchmem://whatever")
    np.testing.assert_allclose(X2, [[7.0]])
    assert TIO.open_source("torchmem://x").size() == len(b"1 1:7.0\n")
    # The two packages keep their own registries.
    assert "torchmem" not in JIO.source._SCHEMES


def test_fsspec_backend_roundtrip():
    pytest.importorskip("fsspec")
    import fsspec

    with fsspec.open("memory://skyt/t.libsvm", "wb") as f:
        f.write(b"1 1:2.0\n0 1:3.0\n")
    X, y = TIO.read_libsvm("memory://skyt/t.libsvm")
    Xj, yj = JIO.read_libsvm("memory://skyt/t.libsvm")
    np.testing.assert_allclose(X, [[2.0], [3.0]])
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    batches = list(TIO.stream_libsvm("memory://skyt/t.libsvm", n_features=1))
    assert len(batches) == 1 and len(batches[0][1]) == 2


def test_unknown_remote_scheme_raises():
    with pytest.raises(Exception, match="no-such-proto-xyz|fsspec"):
        TIO.open_source("no-such-proto-xyz://bucket/key").open()


class _FlakyFsspec:
    """Stands in for the fsspec module: ``open()`` raises transient
    OSErrors for the first ``fail`` calls, then returns an OpenFile-alike
    whose ``.open()`` yields the payload."""

    def __init__(self, fail: int, payload: bytes = b"payload"):
        self.fail = fail
        self.calls = 0
        self.payload = payload

    def open(self, url, mode):
        self.calls += 1
        if self.calls <= self.fail:
            raise OSError(f"transient failure #{self.calls}")
        payload = self.payload

        class _OpenFile:
            def open(self):
                import io as _io

                return _io.BytesIO(payload)

        return _OpenFile()


@pytest.mark.parametrize("pkg", [TIO, JIO], ids=["port", "jax"])
def test_fsspec_open_retries_transient_oserror(pkg):
    """FsspecSource.open() retries transient OSError with jittered
    exponential backoff; the injected sleeps are the same in both."""
    pytest.importorskip("fsspec")
    src = pkg.FsspecSource("memory://flaky/x", retries=3, backoff=0.1)
    flaky = _FlakyFsspec(fail=2)
    src._fsspec = flaky
    sleeps = []
    src._sleep = sleeps.append
    src._jitter = lambda: 0.5  # deterministic: delay = backoff * 2**k
    with src.open() as f:
        assert f.read() == b"payload"
    assert flaky.calls == 3  # 2 failures + 1 success
    np.testing.assert_allclose(sleeps, [0.1, 0.2])


def test_fsspec_open_retry_budget_exhausted():
    pytest.importorskip("fsspec")
    src = TIO.FsspecSource("memory://flaky/y", retries=2, backoff=0.01)
    flaky = _FlakyFsspec(fail=10)
    src._fsspec = flaky
    src._sleep = lambda s: None
    with pytest.raises(OSError, match="transient failure #3"):
        src.open()
    assert flaky.calls == 3  # first try + 2 retries, then the raise


@pytest.mark.parametrize("pkg", [TIO, JIO], ids=["port", "jax"])
def test_fsspec_open_retries_counted_in_telemetry(tmp_path, monkeypatch, pkg):
    """Each retried open counts ``io.open_retries`` and writes one ``io``
    / ``open_retry`` ledger event with the same attrs in both packages."""
    pytest.importorskip("fsspec")
    import importlib
    import json

    telemetry = importlib.import_module(pkg.__name__.rsplit(".", 1)[0] + ".telemetry")
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.configure(tmp_path)
    telemetry.reset()
    try:
        src = pkg.FsspecSource("memory://flaky/z", retries=3, backoff=0.01)
        src._fsspec = _FlakyFsspec(fail=1)
        src._sleep = lambda s: None
        src._jitter = lambda: 0.5
        with src.open() as f:
            f.read()
        assert telemetry.REGISTRY.snapshot()["counters"]["io.open_retries"] == 1
        telemetry.flush()
        with open(telemetry.ledger_path(), encoding="utf-8") as fh:
            (ev,) = [json.loads(line) for line in fh]
        assert (ev["kind"], ev["name"]) == ("io", "open_retry")
        assert ev["attrs"] == {"url": "memory://flaky/z", "attempt": 0, "delay": 0.01,
                               "error": "OSError: transient failure #1"}
    finally:
        telemetry.close()
        telemetry.configure(None)
        telemetry.reset()


class TestRemoteSchemeIntegration:
    """A real non-local fsspec driver (http:// against a local server),
    the code path an hdfs:// or s3:// URL takes."""

    @pytest.fixture()
    def http_root(self, tmp_path):
        pytest.importorskip("fsspec")
        pytest.importorskip("aiohttp")  # fsspec's http driver backend
        import functools
        import threading
        from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

        handler = functools.partial(SimpleHTTPRequestHandler, directory=str(tmp_path))
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            yield tmp_path, f"http://127.0.0.1:{httpd.server_address[1]}"
        finally:
            httpd.shutdown()
            thread.join(timeout=5)

    def test_stream_libsvm_over_http(self, http_root, rng):
        root, base = http_root
        X = rng.standard_normal((37, 5))
        y = (rng.standard_normal(37) > 0).astype(float)
        TIO.write_libsvm(root / "data.svm", X, y)
        Xl, yl = TIO.read_libsvm(root / "data.svm")
        Xr, yr = TIO.read_libsvm(f"{base}/data.svm")
        np.testing.assert_array_equal(Xr, Xl)
        np.testing.assert_array_equal(yr, yl)
        bt, bj = _stream_both(f"{base}/data.svm", f"{base}/data.svm", 5, batch=10,
                              chunk_bytes=256)
        assert [len(b[1]) for b in bt] == [10, 10, 10, 7]
        np.testing.assert_array_equal(np.vstack([b[0] for b in bt]), Xl)
        _same_batches(bt, bj)

    def test_streaming_predict_over_http(self, http_root, rng, capsys):
        """Train locally, then stream predictions straight off the remote
        URL through the port's skylark-ml driver."""
        from libskylark_tpu_torch.cli.ml import main

        root, base = http_root
        X = rng.standard_normal((48, 4))
        w = rng.standard_normal(4)
        y = np.sign(X @ w)
        TIO.write_libsvm(root / "train.svm", X, y)
        TIO.write_libsvm(root / "test.svm", X[:20], y[:20])
        assert main([
            "--trainfile", str(root / "train.svm"), "--modelfile", str(root / "m.json"),
            "-l", "squared", "-g", "1.0", "-f", "32", "-n", "2", "-i", "10", "--device", "cpu",
        ]) == 0
        capsys.readouterr()
        assert main([
            "--testfile", f"{base}/test.svm", "--modelfile", str(root / "m.json"),
            "--outputfile", str(root / "preds.txt"), "--batch", "7", "--device", "cpu",
        ]) == 0
        assert len((root / "preds.txt").read_text().splitlines()) == 20


# -- HDF5, written by one package and read by the other ---------------------


def _hdf5_case(rng):
    X = rng.standard_normal((17, 8))
    X[rng.random((17, 8)) < 0.6] = 0
    return X, rng.standard_normal(17)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_across_packages(tmp_path, rng, sparse, writer):
    pytest.importorskip("h5py")
    X, y = _hdf5_case(rng)
    (TIO if writer == "port" else JIO).write_hdf5(tmp_path / "f.h5", X, y, sparse=sparse)
    for want_sparse in (None, False, True):
        (Xt, yt), (Xj, yj) = _both("read_hdf5", tmp_path / "f.h5", sparse=want_sparse)
        np.testing.assert_array_equal(yt, yj)
        if isinstance(Xt, torch.Tensor):
            _same_sparse(Xt, Xj)
            np.testing.assert_array_equal(Xt.to_dense().numpy(), X)
        else:
            np.testing.assert_array_equal(Xt, Xj)
            np.testing.assert_array_equal(Xt, X)


def test_hdf5_coo_written_by_port_reads_in_jax(tmp_path, rng):
    """A COO (the port's sparse read) goes to the CSR layout; the JAX
    package reads the same triplets back."""
    pytest.importorskip("h5py")
    X, y = _hdf5_case(rng)
    TIO.write_libsvm(tmp_path / "f", X, y)
    Xs, ys = TIO.read_libsvm(tmp_path / "f", n_features=8, sparse=True)
    TIO.write_hdf5(tmp_path / "s.h5", Xs, ys)
    Xj, yj = JIO.read_hdf5(tmp_path / "s.h5")
    np.testing.assert_array_equal(np.asarray(Xj.todense()), X)
    np.testing.assert_array_equal(yj, y)


@pytest.mark.parametrize("sparse", [False, True])
def test_stream_hdf5_batches(tmp_path, rng, sparse):
    pytest.importorskip("h5py")
    X, y = _hdf5_case(rng)
    TIO.write_hdf5(tmp_path / "s.h5", X, y, sparse=sparse)
    bt = list(TIO.stream_hdf5(tmp_path / "s.h5", batch=6))
    bj = list(JIO.stream_hdf5(tmp_path / "s.h5", batch=6))
    assert [len(c[1]) for c in bt] == [6, 6, 5]
    _same_batches(bt, bj)
    dense = np.vstack([c[0].to_dense().numpy() if sparse else c[0] for c in bt])
    np.testing.assert_array_equal(dense, X)


# -- arc lists and graph.read_arc_list ---------------------------------------


ARCS = (b"# a comment\n% another\n1 2\n2 3 7.5\n3 1\n3 3\n2 1\n4 5\n\n5 6\n6 4\n"
        b"1 4\nshort\n7 7\n")


def _arc_file(tmp_path, rng, n=60, m=400):
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    lines = [f"v{a} v{b}" for a, b in zip(u, v)] + ["# done"]
    path = tmp_path / "arcs.txt"
    path.write_text("\n".join(lines))  # no trailing newline
    return path


def test_parse_edge_block_and_chunk_lines(tmp_path):
    from libskylark_tpu.io import arclist as jarc
    from libskylark_tpu_torch.io import arclist as tarc

    assert tarc._parse_edge_block(ARCS) == jarc._parse_edge_block(ARCS)
    src_t, src_j = TIO.MemorySource(ARCS), JIO.MemorySource(ARCS)
    for chunk in (3, 7, 1 << 20):
        assert list(tarc._chunk_lines(src_t, chunk)) == list(jarc._chunk_lines(src_j, chunk))
    lo, hi = np.array([1, 5, 0]), np.array([2, 9, 7])
    np.testing.assert_array_equal(tarc._pack(lo, hi), jarc._pack(lo, hi))


@pytest.mark.parametrize("chunk", [5, 64, 8 << 20])
def test_scan_and_stream_arc_list(tmp_path, rng, chunk):
    path = _arc_file(tmp_path, rng)
    (it, nt), (ij, nj) = _both("scan_arc_list", path, chunk_bytes=chunk)
    assert it == ij and nt == nj
    bt = list(TIO.stream_arc_list(path, index=it, batch_edges=37, chunk_bytes=chunk))
    bj = list(JIO.stream_arc_list(path, index=ij, batch_edges=37, chunk_bytes=chunk))
    assert len(bt) == len(bj) and sum(b["rows"].size for b in bt) == 2 * nt
    for a, b in zip(bt, bj):
        for key in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(a[key], b[key])
    # The checkpointable factory resumes at a batch.
    ft = TIO.arc_list_source(path, index=it, batch_edges=37)
    fj = JIO.arc_list_source(path, index=ij, batch_edges=37)
    for a, b in zip(ft(2), fj(2)):
        np.testing.assert_array_equal(a["rows"], b["rows"])
    assert len(list(ft(2))) == len(bt) - 2


def test_read_arc_list_matches_jax(tmp_path, rng):
    for src in (_arc_file(tmp_path, rng), ARCS):
        Gt, Gj = read_arc_list(src), jax_read_arc_list(src)
        assert Gt.n == Gj.n and Gt.vertices == Gj.vertices and Gt.index == Gj.index
        np.testing.assert_array_equal(Gt.indptr, Gj.indptr)
        np.testing.assert_array_equal(Gt.indices, Gj.indices)
    G = read_arc_list(ARCS)
    assert G.vertices == ["1", "2", "3", "4", "5", "6"]  # 7 only in a self-loop
    assert G.volume // 2 == 7
    # A file:// URL and a MemorySource read the same graph.
    path = _arc_file(tmp_path, rng)
    G1, G2 = read_arc_list(f"file://{path}"), read_arc_list(TIO.MemorySource(path.read_bytes()))
    np.testing.assert_array_equal(G1.indices, G2.indices)
