"""One rank of an elastic drill: the multi-process path run over a
seeded problem with injected faults.

    python -m libskylark_tpu_torch.tools.elastic_drill --rank R --world W \\
        --init "file://$PWD/build/store" --spec '{"scenario": "lsq", ...}'

Every rank of a world runs this with the same ``--spec`` (or ``--runs``,
several specs in order); the ranks join a gloo ``torch.distributed``
group (``--init`` is its ``init_method``; gloo also on a card, since
NCCL refuses two ranks on one card) and run each scenario through the
port's public entry points:

- ``lsq``: ``distributed_sketch_least_squares`` of a (nrows, ncols)
  problem in batches of ``batch_rows`` (JLT or CWT to ``s`` rows);
- ``train``: ``DistributedBlockADMMTrainer`` on Gaussian-kernel feature
  maps (``tag`` "fast" is Fastfood) over ``partitions`` data partitions;
- ``graph``: ``streamed_adjacency_sketch`` of an edge list (``edges``, an
  ``.npz`` with ``lo``/``hi``) in blocks of ``batch_rows`` edges.

The data are made on the rank's device from the seed, batch by batch
(:func:`lsq_problem`, :func:`train_problem`), so every rank, every
restart and the single-process reference see the same stream.  Faults:
``kill_after_chunk`` (SIGKILL once that checkpoint chunk of the stream
commits), ``train_kill_after_chunk`` (the same in the ADMM loop) and
``slow_at_batch``/``slow_seconds`` (a straggler), each a
``HostFaultPlan`` on ``fault_rank`` (every rank when None).  Rank 0
saves a run's result to ``<out>/x-0.pt``, every rank its
``<out>/info-<rank>.json`` (the trainer's with its objective trace,
``history``); each rank prints ``DRILL-OK`` and a JSON line (per run:
launch counts, seconds, the result's SHA-256; the group's backend); a
collective past its deadline prints ``DRILL-TIMEOUT`` with the
stragglers and exits 110, a stale epoch exits 111.  Every rank marks
its phases on stderr (``DRILL-PHASE``, :func:`_phase`).
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["DEFAULTS", "lsq_problem", "train_problem", "graph_problem", "run", "main"]

DEFAULTS = {
    "scenario": "lsq",
    "seed": 5,
    "sketch_seed": None,  # the sketch's SketchContext seed (None: seed + 8)
    "dtype": "float64",
    "nrows": 96,
    "ncols": 5,
    "batch_rows": 4,
    "s": 24,
    "sketch": "JLT",
    "exact": False,
    "planted": False,  # b = A·w + noise, w evenly spaced in [-1, 1]
    "checkpoint_every": 1,
    "resume": False,
    "resume_policy": "strict",
    "collective_timeout": None,
    # train
    "d": 5,
    "maps": 2,
    "map_size": 16,
    "tag": "regular",
    "partitions": 4,
    "loss": "squared",
    "maxiter": 6,
    # graph
    "edges": None,
    "vertices": None,
    "graph_s": 32,
    # faults
    "kill_after_chunk": None,
    "train_kill_after_chunk": None,
    "slow_at_batch": None,
    "slow_seconds": 0.0,
    "fault_rank": None,
}


def _spec(spec: dict) -> dict:
    unknown = set(spec) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown drill spec keys {sorted(unknown)}")
    return {**DEFAULTS, **spec}


def _sketch_seed(spec) -> int:
    return int(spec["seed"]) + 8 if spec["sketch_seed"] is None else int(spec["sketch_seed"])


def _batches(spec, device, make):
    """A block factory over ``ceil(nrows / batch_rows)`` batches, batch b
    made by ``make(generator, rows)`` from a generator seeded by
    ``(seed, b)`` on ``device``."""
    n, br = int(spec["nrows"]), int(spec["batch_rows"])
    nb = -(-n // br)

    def factory(start: int = 0):
        for b in range(start, nb):
            g = torch.Generator(device=device).manual_seed(int(spec["seed"]) * 1_000_003 + b)
            yield make(g, min(br, n - b * br))

    return factory


def lsq_problem(spec: dict, device):
    """``(factory, S)``: batches ``(A_b, b_b)`` of the least-squares
    problem (standard normal, or integers in [-9, 9] with ``exact``; with
    ``planted``, b = A·w + standard normal noise) and its sketch."""
    from ..core.context import SketchContext
    from ..sketch.base import create_sketch

    spec = _spec(spec)
    dt = getattr(torch, spec["dtype"])
    m = int(spec["ncols"])

    def make(g, rows):
        if spec["exact"]:
            return (torch.randint(-9, 10, (rows, m), generator=g, device=device).to(dt),
                    torch.randint(-9, 10, (rows,), generator=g, device=device).to(dt))
        A_b = torch.randn((rows, m), generator=g, device=device, dtype=dt)
        b_b = torch.randn((rows,), generator=g, device=device, dtype=dt)
        return A_b, (A_b @ w + b_b if spec["planted"] else b_b)

    w = torch.linspace(-1.0, 1.0, m, dtype=dt, device=device)

    S = create_sketch(spec["sketch"], int(spec["nrows"]), int(spec["s"]),
                      SketchContext(seed=_sketch_seed(spec)))
    return _batches(spec, device, make), S


def train_problem(spec: dict, device):
    """``(factory, maps, params, classes)``: batches ``(X_b, y_b)``
    (standard normal X; labels ±1 by the sign of a fixed linear score for
    the label losses, else a regression target), the feature maps and the
    ADMM parameters."""
    from ..core.context import SketchContext
    from ..ml import ADMMParams, GaussianKernel

    spec = _spec(spec)
    dt = getattr(torch, spec["dtype"])
    d = int(spec["d"])
    w = torch.linspace(-1.0, 1.0, d, dtype=dt, device=device)
    label = spec["loss"] in ("hinge", "logistic")

    def make(g, rows):
        X = torch.randn((rows, d), generator=g, device=device, dtype=dt)
        score = X @ w
        y = torch.where(score > 0, 1.0, -1.0).to(dt) if label else score
        return X, y

    kernel = GaussianKernel(d, 2.0)
    ctx = SketchContext(seed=_sketch_seed(spec))
    maps = [kernel.create_rft(int(spec["map_size"]), spec["tag"], ctx)
            for _ in range(int(spec["maps"]))]
    params = ADMMParams(rho=1.0, lam=0.01, maxiter=int(spec["maxiter"]),
                        data_partitions=int(spec["partitions"]))
    return _batches(spec, device, make), maps, params, ([-1.0, 1.0] if label else None)


def graph_problem(spec: dict, device):
    """``(factory, S, n, nedges)``: edge blocks ``{"rows", "cols", "vals"}``
    (both directions, f32 ones) of the ``.npz`` edge list, the SJLT to
    ``graph_s`` rows, the vertex and undirected edge counts."""
    from ..core.context import SketchContext
    from ..sketch.hash import SJLT

    spec = _spec(spec)
    with np.load(spec["edges"]) as f:
        lo, hi = f["lo"], f["hi"]
    n, br = int(spec["vertices"]), int(spec["batch_rows"])

    def factory(start: int = 0):
        for e0 in range(start * br, lo.size, br):
            l = torch.from_numpy(lo[e0:e0 + br]).to(device)
            h = torch.from_numpy(hi[e0:e0 + br]).to(device)
            yield {"rows": torch.cat([l, h]), "cols": torch.cat([h, l]),
                   "vals": torch.ones(2 * l.numel(), dtype=torch.float32, device=device)}

    S = SJLT(n, int(spec["graph_s"]), SketchContext(seed=_sketch_seed(spec)))
    return factory, S, n, int(lo.size)


def _plans(spec, rank):
    """``(stream, train)`` fault plans of this rank (None where none)."""
    from ..resilient import HostFaultPlan

    stream = train = None
    if spec["fault_rank"] is not None and int(spec["fault_rank"]) != rank:
        return stream, train
    knobs = {"die_after_commit": spec["kill_after_chunk"], "slow_at_batch": spec["slow_at_batch"]}
    if any(v is not None for v in knobs.values()):
        stream = HostFaultPlan(slow_seconds=float(spec["slow_seconds"]), **knobs)
    if spec["train_kill_after_chunk"] is not None:
        train = HostFaultPlan(die_after_commit=spec["train_kill_after_chunk"])
    return stream, train


def _counts() -> dict:
    from ..sketch import kernels_fut as kf
    from ..sketch import kernels_scatter as ks
    from ..sketch import kernels_window as kw

    return {"rfut_rowwise": kf.rfut_rowwise.launches,
            "rfut_rowwise_sampled": kf.rfut_rowwise_sampled.launches,
            "gather_scaled_rows": kw.gather_scaled_rows.launches,
            "scatter_rows": kw.scatter_rows.launches,
            "segment_sum_flat": ks.segment_sum_flat.launches}


def run(spec: dict, *, rank: int, device, root=None, out=None) -> dict:
    """Run ``spec``'s scenario as this rank of the initialized group;
    returns ``{"x", "info", "seconds", "launches"}`` (``x`` on the host)."""
    from ..graph.stream import streamed_adjacency_sketch
    from ..ml.distributed import DistributedBlockADMMTrainer
    from ..parallel.collectives import cross_host_psum
    from ..streaming import ElasticParams, RowPartition, pinned_placer, world_info
    from ..streaming.elastic import distributed_sketch_least_squares

    spec = _spec(spec)
    _, world = world_info()
    device = torch.device(device)
    dt = getattr(torch, spec["dtype"])
    params = ElasticParams(
        placer=pinned_placer(device), prefetch=0, checkpoint_dir=root,
        checkpoint_every=int(spec["checkpoint_every"]), resume=bool(spec["resume"]),
        resume_policy=spec["resume_policy"],
        collective_timeout_s=spec["collective_timeout"])
    stream_plan, train_plan = _plans(spec, rank)
    before = _counts()
    t0 = time.perf_counter()
    if spec["scenario"] == "lsq":
        factory, S = lsq_problem(spec, device)
        part = RowPartition(nrows=int(spec["nrows"]), batch_rows=int(spec["batch_rows"]),
                            world_size=world)
        x, info = distributed_sketch_least_squares(
            factory, S, ncols=int(spec["ncols"]), partition=part, dtype=dt, params=params,
            fault_plan=stream_plan)
    elif spec["scenario"] == "train":
        factory, maps, admm, classes = train_problem(spec, device)
        part = RowPartition(nrows=int(spec["nrows"]), batch_rows=int(spec["batch_rows"]),
                            world_size=world)
        trainer = DistributedBlockADMMTrainer(spec["loss"], "l2", maps, admm, params)
        model, info = trainer.train(factory, part, classes=classes,
                                    regression=classes is None, dtype=dt,
                                    fault_plan=stream_plan, train_fault_plan=train_plan)
        x = model.W
        info = {**{k: v for k, v in info.items() if k != "policy"},
                "history": list(model.history)}
    elif spec["scenario"] == "graph":
        factory, S, n, nedges = graph_problem(spec, device)
        part = RowPartition(nrows=nedges, batch_rows=int(spec["batch_rows"]), world_size=world)
        x = streamed_adjacency_sketch(factory, S, ncols=n, dtype=torch.float32,
                                      partition=part, params=params, fault_plan=stream_plan)
        info = {"rows": nedges, "world_size": world, "rank": rank}
    else:
        raise ValueError(f"unknown drill scenario {spec['scenario']!r}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    after = _counts()
    x = x.detach().cpu()
    result = {"x": x, "info": info, "seconds": seconds,
              "x_sha256": hashlib.sha256(x.contiguous().view(torch.uint8).numpy()).hexdigest(),
              "launches": {k: after[k] - before[k] for k in after},
              "host_copies": cross_host_psum.host_copies}
    if out is not None:
        # Every rank holds the same x (its hash is in the report): rank 0
        # saves it.
        os.makedirs(out, exist_ok=True)
        if rank == 0:
            torch.save(x, os.path.join(out, "x-0.pt"))
        with open(os.path.join(out, f"info-{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(info, fh, default=str)
    return result


def _phase(name: str) -> None:
    """``DRILL-PHASE <name> <unix seconds>`` on stderr: how far a rank got
    (start: imports done; group: joined; run NAME; checks; leave), for a
    caller that has only its output."""
    print(f"DRILL-PHASE {name} {time.time():.3f}", file=sys.stderr, flush=True)


def main(argv=None, *, setup=None) -> int:
    """The rank process: join the group, run the runs, report, leave.

    ``--spec``/``--root``/``--out`` give one run; ``--runs``, a JSON list
    of ``{"name", "spec", "root", "out"}``, several, in order, in one
    group.  ``setup(rank)``, where given, runs once the group is up and
    before the first run; it returns None or a callable, called after
    the last run with the group still up, whose dict joins the report."""
    import torch.distributed as dist

    from ..parallel.collectives import cross_host_psum
    from ..utils.exceptions import CollectiveTimeoutError, StaleEpochError

    p = argparse.ArgumentParser(prog="elastic_drill")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True, help="init_method of the process group")
    p.add_argument("--device", default="cpu")
    p.add_argument("--group-timeout", type=float, default=60.0)
    p.add_argument("--root", default=None, help="shared checkpoint root")
    p.add_argument("--out", default=None, help="directory for x-0.pt, info-<rank>.json")
    p.add_argument("--spec", default="{}", help="the scenario, a JSON object (DEFAULTS)")
    p.add_argument("--runs", default=None, help="a JSON list of {name, spec, root, out}")
    args = p.parse_args(argv)
    runs = (json.loads(args.runs) if args.runs is not None else
            [{"name": "run", "spec": json.loads(args.spec), "root": args.root, "out": args.out}])
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    _phase("start")
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.world,
                            timeout=datetime.timedelta(seconds=args.group_timeout))
    _phase("group")
    finish = setup(args.rank) if setup is not None else None
    done = []
    for r in runs:
        _phase(f"run {r['name']}")
        try:
            res = run(r["spec"], rank=args.rank, device=device, root=r.get("root"),
                      out=r.get("out"))
        except CollectiveTimeoutError as e:
            print(f"DRILL-TIMEOUT phase={e.phase} stragglers={e.stragglers}", flush=True)
            # The blocked collective still holds the group: leave without
            # tearing it down (its own timeout would have to expire first).
            os._exit(110)
        except StaleEpochError:
            print("DRILL-STALE-EPOCH", flush=True)
            os._exit(111)
        done.append({"name": r["name"], "seconds": res["seconds"], "sha": res["x_sha256"],
                     "launches": res["launches"], "replay": res["info"].get("replay")})
    _phase("checks")
    report = {"rank": args.rank, "world": args.world, "backend": dist.get_backend(),
              "host_copies": cross_host_psum.host_copies, "runs": done,
              **(finish() if finish is not None else {})}
    _phase("leave")
    dist.destroy_process_group()
    print("DRILL-OK", flush=True)
    print(json.dumps(report, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
