"""The kept step graphs of ``resilient.chunked`` (``GraphCache``,
``GRAPHS``) and one-shot LSQR over them.

On the CPU a stand-in for ``StepGraph`` replaces the CUDA graph: it keeps
the step it was "captured" with and runs it on its static state in
place, as a replay runs the captured kernels on the graph's buffers.
So the key, the eviction, the weak hold on A, the copy of each call's
operands and the clone of what a solve hands out are checked here, and
a cached solve must be bitwise the eager one.  The tests marked
``cuda`` run the real graphs and skip without a card; on the card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_cache.py``.
"""

import gc
import json
import threading
import weakref

import numpy as np
import pytest
import torch

from libskylark_tpu_torch import telemetry
from libskylark_tpu_torch.core.context import SketchContext
from libskylark_tpu_torch.resilient import chunked
from libskylark_tpu_torch.solvers import accelerated
from libskylark_tpu_torch.solvers import krylov as tk
from libskylark_tpu_torch.solvers import precond as tp


class FakeGraph:
    """``StepGraph`` on the CPU: replays by running the captured step."""

    def __init__(self, step, state):
        self.run = step
        self.state = {k: v.clone() for k, v in state.items()}

    def advance(self, state, k):
        if state is not self.state:
            for key, v in self.state.items():
                v.copy_(state[key])
        for _ in range(k):
            new = self.run(self.state)
            for key, v in self.state.items():
                v.copy_(new[key])
        return self.state


class StubGraph:
    """A graph that keeps nothing of its step (as a CUDA graph keeps no
    Python reference), for the tests of the key and of lifetimes."""

    def __init__(self, step, state):
        self.state = dict(state)

    def advance(self, state, k):
        return state


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in ("SKYLARK_TELEMETRY", "SKYLARK_TELEMETRY_DIR", "SKYLARK_GUARD"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    telemetry.close()
    telemetry.configure(None)
    telemetry.reset()
    yield
    telemetry.close()
    telemetry.configure(None)
    telemetry.reset()


@pytest.fixture
def graphs(monkeypatch):
    """A fresh cache of 8, its graphs ``FakeGraph``s, and every dense
    operand graphable (on the CPU too); returns the list of captures."""
    made = []

    class Counted(FakeGraph):
        def __init__(self, step, state):
            super().__init__(step, state)
            made.append(self)

    monkeypatch.setattr(chunked, "GRAPHS", chunked.GraphCache(chunked.GRAPH_CACHE_SIZE))
    monkeypatch.setattr(chunked, "StepGraph", Counted)
    monkeypatch.setattr(tk, "graphable", lambda *ops: all(
        isinstance(t, torch.Tensor) and t.layout == torch.strided for t in ops))
    return made


@pytest.fixture
def stub(monkeypatch):
    """A fresh cache of 3 whose graphs are ``StubGraph``s; returns it and
    the list of captures."""
    made = []

    class Counted(StubGraph):
        def __init__(self, step, state):
            super().__init__(step, state)
            made.append(self)

    cache = chunked.GraphCache(3)
    monkeypatch.setattr(chunked, "GRAPHS", cache)
    monkeypatch.setattr(chunked, "StepGraph", Counted)
    return cache, made


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU form")
    return torch.device("cuda")


def _problem(seed, m=200, n=12, dtype=torch.float64, device="cpu"):
    g = np.random.default_rng(seed)
    A = torch.tensor(g.standard_normal((m, n)), dtype=dtype, device=device)
    return A, [torch.tensor(g.standard_normal(m), dtype=dtype, device=device) for _ in range(2)]


def _precond(kind, A, seed):
    """A preconditioner of ``kind`` from a fresh draw of rows of A (so
    each call has its own operand, as each Blendenpik solve has)."""
    if kind == "none":
        return None
    g = torch.Generator(device=A.device).manual_seed(seed)
    rows = torch.randint(0, A.shape[0], (4 * A.shape[1],), generator=g, device=A.device)
    R = torch.linalg.qr(A[rows], mode="r")[1]
    if kind == "tri":
        return tp.TriInversePrecond(R)
    if kind == "tri_lower":
        return tp.TriInversePrecond(R.T.contiguous(), lower=True)
    return tp.MatPrecond(torch.linalg.inv(R))


def _eager(A, b, N, params=None):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "graphable", lambda *ops: False)
        return tk.lsqr(A, b, precond=N, params=params)


def _same(out, ref):
    (x, info), (xr, ir) = out, ref
    assert torch.equal(x, xr)
    assert all(torch.equal(info[k], ir[k]) for k in ("iterations", "flag", "resid"))


# -- one-shot LSQR over the cache ------------------------------------------------------


@pytest.mark.parametrize("kind", ["none", "tri", "tri_lower", "mat"])
def test_second_solve_hits_and_is_bitwise_eager(graphs, kind):
    """Two solves on one A with their own b and preconditioner: one
    capture, and each is bitwise the eager masked steps."""
    A, (b1, b2) = _problem(1)
    N1, N2 = _precond(kind, A, 11), _precond(kind, A, 12)
    out1 = tk.lsqr(A, b1, precond=N1)
    out2 = tk.lsqr(A, b2, precond=N2)
    assert len(graphs) == 1 and len(chunked.GRAPHS) == 1
    _same(out1, _eager(A, b1, N1))
    _same(out2, _eager(A, b2, N2))
    assert int(out1[1]["iterations"]) > 1


@pytest.mark.parametrize("kind", ["none", "tri"])
def test_results_do_not_alias_a_later_solve(graphs, kind):
    """What a solve hands out is its own: the next solve on the same
    graph leaves it as it was (the identity's X would be the static Y)."""
    A, (b1, b2) = _problem(2)
    x1, info1 = tk.lsqr(A, b1, precond=_precond(kind, A, 21))
    kept = (x1.clone(), {k: v.clone() for k, v in info1.items()})
    tk.lsqr(A, b2, precond=_precond(kind, A, 22))
    assert len(graphs) == 1
    assert torch.equal(x1, kept[0])
    assert all(torch.equal(info1[k], kept[1][k]) for k in info1)
    static = graphs[0].state
    assert all(v.data_ptr() != static[k].data_ptr()
               for k, v in (("it", info1["iterations"]), ("phibar", info1["resid"])))


def test_a_key_per_shape_constant_and_class(graphs):
    """What the step bakes in is in the key: another iteration limit,
    tolerance, preconditioner class, triangle or RHS width captures
    anew; the first key still hits."""
    A, (b1, b2) = _problem(3)
    R = _precond("tri", A, 31)
    tk.lsqr(A, b1, precond=R)
    tk.lsqr(A, b1, precond=R, params=tk.KrylovParams(iter_lim=50))
    tk.lsqr(A, b1, precond=R, params=tk.KrylovParams(tolerance=1e-9))
    tk.lsqr(A, b1, precond=_precond("mat", A, 31))
    tk.lsqr(A, b1, precond=_precond("tri_lower", A, 31))
    tk.lsqr(A, torch.stack([b1, b2], 1), precond=R)
    assert len(graphs) == 6
    _same(tk.lsqr(A, b2, precond=_precond("tri", A, 32)), _eager(A, b2, _precond("tri", A, 32)))
    assert len(graphs) == 6


def test_callers_without_a_key_capture_each_call(graphs):
    """CG, a preconditioner of another class and chunks a caller drives
    keep today's one capture per solve; nothing enters the cache."""
    A, (b1, _) = _problem(4)
    G = A.T @ A + torch.eye(A.shape[1], dtype=A.dtype)
    rhs = A.T @ b1
    for _ in range(2):
        tk.cg(G, rhs)
    assert len(graphs) == 2

    class Scaled(tp.MatPrecond):
        pass

    N = Scaled(torch.eye(A.shape[1], dtype=A.dtype))
    ref = _eager(A, b1, N)
    for _ in range(2):
        _same(tk.lsqr(A, b1, precond=N), ref)
    assert len(graphs) == 4
    sol = tk.lsqr_chunked(A, b1)
    s = sol.init_state()
    for _ in range(3):
        s = sol.step_chunk(s, 2)
    assert len(graphs) == 5 and len(chunked.GRAPHS) == 0


def test_cache_does_not_keep_a_alive(graphs):
    """The cache holds A weakly: once its graph's step is gone (a CUDA
    graph keeps no Python reference to it), a dropped A is freed."""
    A, (b1, _) = _problem(5)
    tk.lsqr(A, b1, precond=_precond("tri", A, 51))
    assert len(graphs) == 1 and len(chunked.GRAPHS) == 1
    graphs[0].run = None
    ref = weakref.ref(A)
    del A
    gc.collect()
    assert ref() is None


def test_hits_and_misses_in_the_run_summary(graphs, monkeypatch, tmp_path):
    """Blendenpik's run summary carries the cache's counters, and
    ``lsqr.capture`` opens on a miss only."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.configure(tmp_path)
    A, (b1, b2) = _problem(6, m=400, n=10)
    ctx = SketchContext(seed=6)
    for b in (b1, b2, b1):
        accelerated.faster_least_squares(A, b, ctx)
    telemetry.flush()
    events = [json.loads(line) for line in open(telemetry.ledger_path())]
    last = [e for e in events if e["kind"] == "run_summary"][-1]
    counters = last["attrs"]["snapshot"]["counters"]
    assert counters["step_graphs.lsqr.misses"] == 1
    assert counters["step_graphs.lsqr.hits"] == 2
    assert counters["span.lsqr.capture.calls"] == 1
    assert counters["span.lsqr.run.calls"] == 3
    assert len(graphs) == 1


def test_counters_are_off_with_telemetry(graphs):
    A, (b1, _) = _problem(7)
    tk.lsqr(A, b1)
    tk.lsqr(A, b1)
    assert len(graphs) == 1
    assert not any(k.startswith("step_graphs.") for k in telemetry.snapshot()["counters"])


def test_threads_get_entries_of_their_own(graphs):
    """Two threads solving on one A never share an entry: each captures
    once, and every result is bitwise the serial one."""
    A, bs = _problem(8)
    Ns = [_precond("tri", A, 80 + i) for i in range(4)]
    serial = [_eager(A, bs[i % 2], Ns[i]) for i in range(4)]
    out, errors = {}, []

    def work(t):
        try:
            for i in (t, t + 2):
                out[i] = tk.lsqr(A, bs[i % 2], precond=Ns[i])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(graphs) == 2 and len(chunked.GRAPHS) == 2
    for i in range(4):
        _same(out[i], serial[i])


# -- the cache's key, bound and lifetimes -------------------------------------------------


def _state(n=4, dtype=torch.float64):
    return {"x": torch.zeros(n, dtype=dtype), "it": torch.zeros((), dtype=torch.int64)}


def _spec(A, R, key=("lsqr", 100, 1e-14)):
    return chunked.GraphKey(key, (A,), {"R": R}, lambda ops: (lambda s: s))


def _other(field, A, R, state):
    """The arguments of a lookup that differs from ``(A, R, state)`` in
    ``field`` alone."""
    spec = _spec(A, R)
    if field == "constants":
        spec = _spec(A, R, key=("lsqr", 100, 1e-12))
    elif field == "kind":
        spec = _spec(A, R, key=("cg", 100, 1e-14))
    elif field == "A_identity":
        spec = _spec(A.clone(), R)
    elif field == "A_strides":
        spec = _spec(A.T.contiguous().T, R)
    elif field == "A_shape":
        spec = _spec(A[:-1], R)
    elif field == "A_dtype":
        spec = _spec(A.float(), R)
    elif field == "operand_strides":
        spec = _spec(A, R.T.contiguous().T)
    elif field == "operand_dtype":
        spec = _spec(A, R.float())
    elif field == "state_shape":
        state = _state(5)
    elif field == "state_dtype":
        state = _state(dtype=torch.float32)
    return spec, state


FIELDS = ["constants", "kind", "A_identity", "A_strides", "A_shape", "A_dtype",
          "operand_strides", "operand_dtype", "state_shape", "state_dtype"]


@pytest.mark.parametrize("field", FIELDS)
def test_key_differs_in_each_field(stub, field):
    cache, made = stub
    A = torch.randn(6, 4, dtype=torch.float64)
    R = torch.randn(4, 4, dtype=torch.float64)
    state = _state()
    first = cache.entry("lsqr", _spec(A, R), state)
    spec, state2 = _other(field, A, R, state)
    second = cache.entry("lsqr", spec, state2)
    assert second is not first and len(made) == 2
    # The first key is still kept, and found again.
    assert cache.entry("lsqr", _spec(A, R), state) is first and len(made) == 2


def test_key_equal_copies_the_operands_in(stub):
    """The same A, layouts and constants with a new R and a new state:
    a hit, whose operand copy now holds the new R's values."""
    cache, made = stub
    A = torch.randn(6, 4, dtype=torch.float64)
    R1, R2 = torch.randn(4, 4, dtype=torch.float64), torch.randn(4, 4, dtype=torch.float64)
    first = cache.entry("lsqr", _spec(A, R1), _state())
    assert torch.equal(first.operands["R"], R1) and first.operands["R"] is not R1
    assert cache.entry("lsqr", _spec(A, R2), _state()) is first
    assert len(made) == 1 and torch.equal(first.operands["R"], R2)
    assert torch.equal(R1, R1.clone())  # the caller's tensors are not written


def test_key_differs_in_math_mode(stub):
    cache, made = stub
    A, R = torch.randn(6, 4), torch.randn(4, 4)
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    try:
        cache.entry("lsqr", _spec(A, R), _state())
        mm.allow_tf32 = not old
        cache.entry("lsqr", _spec(A, R), _state())
    finally:
        mm.allow_tf32 = old
    assert len(made) == 2


def test_key_differs_by_thread(stub):
    cache, made = stub
    A, R = torch.randn(6, 4), torch.randn(4, 4)
    got = []
    cache.entry("lsqr", _spec(A, R), _state())
    th = threading.Thread(target=lambda: got.append(cache.entry("lsqr", _spec(A, R), _state())))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and len(got) == 1
    assert len(made) == 2 and len(cache) == 2


def test_eviction_at_the_bound(stub):
    """Past its size the least recently used entry goes."""
    cache, made = stub
    R = torch.randn(4, 4)
    As = [torch.randn(6, 4) for _ in range(4)]
    entries = [cache.entry("lsqr", _spec(A, R), _state()) for A in As[:3]]
    assert cache.entry("lsqr", _spec(As[0], R), _state()) is entries[0]  # now the newest
    cache.entry("lsqr", _spec(As[3], R), _state())
    assert len(cache) == 3 and len(made) == 4
    assert cache.entry("lsqr", _spec(As[0], R), _state()) is entries[0]
    assert cache.entry("lsqr", _spec(As[2], R), _state()) is entries[2]
    assert len(made) == 4
    # As[1] was the least recently used: evicted, so captured anew.
    assert cache.entry("lsqr", _spec(As[1], R), _state()) is not entries[1]
    assert len(made) == 5 and len(cache) == 3


def test_a_dead_read_is_a_miss(stub):
    """An entry whose in-place tensor died is a miss even where a live
    tensor has the same address, shape, strides and dtype."""
    cache, made = stub
    base, R = torch.randn(6, 4), torch.randn(4, 4)
    A = base[:]  # a tensor of its own over base's memory
    first = cache.entry("lsqr", _spec(A, R), _state())
    assert cache.entry("lsqr", _spec(base, R), _state()) is first
    del A
    gc.collect()
    again = cache.entry("lsqr", _spec(base, R), _state())
    assert again is not first and len(made) == 2 and len(cache) == 1


def test_the_entry_keeps_no_strong_reference_to_its_reads(stub):
    cache, made = stub
    A, R = torch.randn(6, 4), torch.randn(4, 4)
    cache.entry("lsqr", _spec(A, R), _state())
    ref = weakref.ref(A)
    del A
    gc.collect()
    assert ref() is None


# -- on the card --------------------------------------------------------------------------


def _blendenpik_problem(device, m=50000, n=500, seed=28):
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(m, n, generator=g, device=device)
    return A, torch.randn(4, m, generator=g, device=device)


@pytest.mark.cuda
def test_card_cached_lsqr_is_bitwise_eager(card, monkeypatch):
    """Two solves on one A with their own b and R: the second opens no
    ``lsqr.capture``, each is bitwise the eager steps, and the first's
    results are unchanged by the second."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    monkeypatch.setattr(chunked, "GRAPHS", chunked.GraphCache(chunked.GRAPH_CACHE_SIZE))
    A, B = _blendenpik_problem(card, m=20000, n=200)
    N1, N2 = _precond("tri", A, 1), _precond("tri", A, 2)
    out1 = tk.lsqr(A, B[0], precond=N1)
    kept = (out1[0].clone(), {k: v.clone() for k, v in out1[1].items()})
    captures = telemetry.snapshot()["counters"]["span.lsqr.capture.calls"]
    out2 = tk.lsqr(A, B[1], precond=N2)
    counters = telemetry.snapshot()["counters"]
    assert captures == 1 and counters["span.lsqr.capture.calls"] == 1
    assert counters["step_graphs.lsqr.hits"] == 1
    assert torch.equal(out1[0], kept[0])
    assert all(torch.equal(out1[1][k], kept[1][k]) for k in kept[1])
    monkeypatch.setattr(chunked, "CUDA_GRAPHS", False)
    _same(out1, tk.lsqr(A, B[0], precond=N1))
    _same(out2, tk.lsqr(A, B[1], precond=N2))
    assert int(out2[1]["iterations"]) > 1


@pytest.mark.cuda
def test_card_reserved_memory_is_flat_over_blendenpik_solves(card, monkeypatch):
    monkeypatch.setattr(chunked, "GRAPHS", chunked.GraphCache(chunked.GRAPH_CACHE_SIZE))
    A, B = _blendenpik_problem(card)
    ctx = SketchContext(seed=28)
    accelerated.faster_least_squares(A, B[0], ctx)
    torch.cuda.synchronize()
    reserved = []
    for i in range(20):
        accelerated.faster_least_squares(A, B[i % 4], ctx)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(card))
    assert len(chunked.GRAPHS) == 1
    assert reserved[-1] == reserved[0], reserved


@pytest.mark.cuda
def test_card_lsrn_and_threads_are_bitwise_serial(card, monkeypatch):
    """LSRN's N is copied in as R is; Blendenpik from two threads is
    bitwise the serial solves."""
    monkeypatch.setattr(chunked, "GRAPHS", chunked.GraphCache(chunked.GRAPH_CACHE_SIZE))
    A, B = _blendenpik_problem(card, m=20000, n=200)

    def solve(fn, i):
        return fn(A, B[i], SketchContext(seed=100 + i))

    for fn in (accelerated.lsrn_least_squares, accelerated.faster_least_squares):
        cached = [solve(fn, i) for i in range(4)]
        with monkeypatch.context() as mp:
            mp.setattr(chunked, "CUDA_GRAPHS", False)
            eager = [solve(fn, i) for i in range(4)]
        for c, e in zip(cached, eager):
            assert torch.equal(c[0], e[0])
            assert int(c[1]["iterations"]) == int(e[1]["iterations"])
    out, errors = {}, []
    # One capture at a time (two threads cannot capture on the one side
    # stream at once); the solves after them run side by side.
    capture, both = threading.Lock(), threading.Barrier(2, timeout=120)

    def work(t):
        try:
            stream = torch.cuda.Stream(card)
            with torch.cuda.stream(stream):
                with capture:
                    out[t] = solve(accelerated.faster_least_squares, t)
                    stream.synchronize()
                both.wait()
                out[t + 2] = solve(accelerated.faster_least_squares, t + 2)
                stream.synchronize()
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors and not any(th.is_alive() for th in threads), errors
    for i in range(4):
        assert torch.equal(out[i][0], cached[i][0])
