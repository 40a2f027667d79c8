"""skylark-torch-serve: the long-lived multi-tenant sketch-serving daemon
(port of ``libskylark_tpu/cli/serve.py``: every flag, plus ``--device``).

Front ends (both speak the exact ``serve/protocol.py`` JSON frames):

- default: JSON-lines stdio — one request per stdin line, one response
  per stdout line, in order (inetd/systemd-socket style);
- ``--http PORT``: loopback HTTP — ``POST /`` with one request object
  or a list (a list is submitted concurrently and rides the
  cross-request coalescer), ``GET /stats``, ``GET /healthz``.

Warm state is loaded ONCE at startup: ``--model NAME=PATH`` JSON models
(``ml/model.py`` save format) and ``--system NAME=PATH`` least-squares
operators (``.npy``, f32 unless ``--x64``) become resident on
``--device`` (the card by default; without one the run raises unless
``--device cpu`` is given) before the first request.

Fleet mode:

- ``--workers K`` pins K batcher threads to the local cards
  (one admission queue, one coalescer — K fused dispatches in flight);
- ``--replicas K`` (HTTP only) runs K full replica servers behind an
  in-process :class:`~..serve.router.Router` front door — ``POST /``
  is placed by key affinity + load, ``GET /fleet`` shows membership;
- ``--join URL`` announces THIS server to a router front door at URL
  once it is primed and serving (zero-downtime rollout: the router
  fences the registry signature and only then places traffic here);
- ``--autoscale`` runs the membership control loop over the router
  front door: replicas spawn against ``--queue-high``/``--p99-high-ms``
  targets (primed before placeable, join-fenced) and drain to zero
  in-flight before leaving, bounded by ``--min-replicas`` /
  ``--max-replicas``; every decision is ledgered and visible on
  ``/healthz`` (the ``skylark-top`` autoscale panel).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np

from .common import (
    add_device_args,
    add_perf_args,
    add_policy_args,
    add_telemetry_args,
    print_perf_report,
    print_policy_report,
    print_telemetry_report,
    run_scope,
    setup_perf,
    setup_policy,
    setup_telemetry,
    to_device,
)


def _name_path(spec: str, flag: str) -> tuple[str, str]:
    name, sep, path = spec.partition("=")
    if not sep or not name or not path:
        raise SystemExit(f"{flag} expects NAME=PATH, got {spec!r}")
    return name, path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skylark-torch-serve")
    p.add_argument(
        "--model", action="append", default=[], metavar="NAME=PATH",
        help="register a saved model (ml/model.py JSON) under NAME; "
             "repeatable",
    )
    p.add_argument(
        "--system", action="append", default=[], metavar="NAME=PATH",
        help="register a least-squares operator A (.npy, tall 2-D) "
             "under NAME; its sketch + QR are precomputed at startup; "
             "repeatable",
    )
    p.add_argument("--sketch-type", default="FJLT",
                   help="sketch registry name for --system operators")
    p.add_argument("--sketch-size", type=int, default=None,
                   help="sketch rows for --system operators "
                        "(default: min(m, max(4n, n+16)))")
    p.add_argument("--seed", type=int, default=38734,
                   help="server SketchContext seed (fresh-sketch requests "
                        "reserve counters from it deterministically)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve HTTP on 127.0.0.1:PORT (0 picks a free "
                        "port) instead of JSON-lines stdio")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission bound: requests beyond this depth are "
                        "shed with code 112")
    p.add_argument("--max-coalesce", type=int, default=16,
                   help="max requests fused into one dispatch")
    p.add_argument("--coalesce-window-ms", type=float, default=0.0,
                   help="linger this long after the first request of a "
                        "batch to let coalesce-mates arrive")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline; requests whose "
                        "queue wait exceeds it are shed with code 113")
    p.add_argument("--no-prime", dest="prime", action="store_false",
                   help="skip the startup priming dispatches that capture "
                        "every lane rung's plans before traffic")
    p.add_argument("--workers", type=int, default=1,
                   help="batcher worker threads; K>1 pins each to a "
                        "distinct local device so independent batches "
                        "use every card")
    p.add_argument("--replicas", type=int, default=1,
                   help="run K replica servers behind a router front "
                        "door (requires --http); requests are placed by "
                        "key affinity, live queue depth and profiled "
                        "throughput")
    p.add_argument("--join", default=None, metavar="URL",
                   help="announce this server to a router front door at "
                        "URL after priming (requires --http); registry "
                        "signatures are fenced at join")
    p.add_argument("--autoscale", action="store_true",
                   help="run the membership control loop over the router "
                        "front door (requires --http): replicas are "
                        "spawned against queue-depth/p99 targets and "
                        "drained to zero in-flight when idle")
    p.add_argument("--min-replicas", type=int, default=1,
                   help="autoscale floor: never drain below this many "
                        "placeable replicas")
    p.add_argument("--max-replicas", type=int, default=4,
                   help="autoscale ceiling: never spawn past this many "
                        "placeable replicas")
    p.add_argument("--queue-high", type=float, default=8.0,
                   help="mean placeable queue depth above which the "
                        "autoscaler spawns a replica")
    p.add_argument("--p99-high-ms", type=float, default=None,
                   help="optional p99 latency target; above it the "
                        "autoscaler spawns even with shallow queues")
    p.add_argument("--autoscale-interval", type=float, default=2.0,
                   help="autoscale decision period in seconds")
    p.add_argument("--state-dir", default=None, metavar="DIR",
                   help="durable serve state: every registry mutation is "
                        "journaled (write-ahead, fsync'd) to DIR before "
                        "it publishes, with periodic snapshot compaction; "
                        "with --replicas K each replica journals into "
                        "DIR/replica-i")
    p.add_argument("--recover", action="store_true",
                   help="restore the registry from --state-dir (snapshot "
                        "+ journal tail) before serving — the restarted "
                        "replica rejoins at the exact epoch it died at; "
                        "--model/--system names already recovered are "
                        "skipped")
    p.add_argument("--journal-compact-every", type=int, default=None,
                   metavar="N",
                   help="journal records between snapshot compactions "
                        "(default SKYLARK_JOURNAL_COMPACT_EVERY or 256; "
                        "0 disables compaction)")
    p.add_argument("--x64", action="store_true")
    add_device_args(p)
    add_perf_args(p)
    add_policy_args(p)
    add_telemetry_args(p)
    args = p.parse_args(argv)

    setup_perf(args)
    with run_scope(args) as dev:
        setup_telemetry(args)
        setup_policy(args)  # warm-starts the process (plan replay)
        return _run(args, dev)


def _run(args, dev) -> int:
    from .. import serve
    from ..core import SketchContext

    if args.replicas > 1 and args.http is None:
        raise SystemExit("--replicas needs --http (the front door is HTTP)")
    if args.join and args.http is None:
        raise SystemExit("--join needs --http (the router heartbeats this "
                         "server's /healthz)")
    if args.autoscale and args.http is None:
        raise SystemExit("--autoscale needs --http (the control loop runs "
                         "over a router front door)")

    params = serve.ServeParams(
        max_queue=args.max_queue,
        max_coalesce=args.max_coalesce,
        coalesce_window_ms=args.coalesce_window_ms,
        default_deadline_ms=args.deadline_ms,
        warm_start=False,  # setup_policy above already replayed
        prime=args.prime,
        workers=args.workers,
        state_dir=args.state_dir,
        recover=args.recover,
        journal_compact_every=args.journal_compact_every,
    )

    fleet_mode = args.replicas > 1 or args.autoscale
    made = [0]  # per-replica state subdirectories in fleet mode

    def make_server() -> "serve.Server":
        import os as _os
        from dataclasses import replace as _replace

        p_i = params
        if args.state_dir is not None and fleet_mode:
            # One journal per replica: the WAL is single-writer (one
            # append handle, one epoch counter), so fleet members must
            # not share a journal file.
            p_i = _replace(
                params,
                state_dir=_os.path.join(
                    args.state_dir, f"replica-{made[0]}"
                ),
            )
        made[0] += 1
        server = serve.Server(p_i, seed=args.seed, device=dev)
        recovered = server.registry.describe() if args.recover else None
        for spec in args.model:
            name, path = _name_path(spec, "--model")
            if recovered is not None and name in recovered["models"]:
                print(f"model {name!r} recovered from journal",
                      file=sys.stderr)
                continue
            server.registry.load_model(name, path)
            print(f"model {name!r} <- {path}", file=sys.stderr)
        for spec in args.system:
            name, path = _name_path(spec, "--system")
            if recovered is not None and name in recovered["systems"]:
                print(f"system {name!r} recovered from journal",
                      file=sys.stderr)
                continue
            A = to_device(np.load(path), args, dev)
            server.registry.register_system(
                name, A,
                context=SketchContext(seed=args.seed + 1),
                sketch_type=args.sketch_type,
                sketch_size=args.sketch_size,
            )
            print(f"system {name!r} <- {path} {tuple(A.shape)}", file=sys.stderr)
        return server

    servers = [make_server() for _ in range(max(1, args.replicas))]
    router = None
    autoscaler = None
    if args.replicas > 1 or args.autoscale:
        router = serve.Router(
            serve.RouterParams(heartbeat_interval_s=1.0)
        ).start()
        for i, s in enumerate(servers):
            s.start()  # primed BEFORE the router can place traffic here
            rec = router.join(f"replica-{i}", server=s)
            print(f"replica-{i} joined (epoch {rec['epoch']})",
                  file=sys.stderr)
        front = router
        if args.autoscale:
            autoscaler = serve.Autoscaler(
                router, lambda name: make_server(),
                serve.AutoscaleParams(
                    min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas,
                    queue_high=args.queue_high,
                    p99_high_ms=args.p99_high_ms,
                    interval_s=args.autoscale_interval,
                ),
            )
            for i, s in enumerate(servers):
                autoscaler.adopt(f"replica-{i}", s)
            router.autoscaler = autoscaler  # /healthz autoscale panel
            autoscaler.start()
            print(f"autoscale [{args.min_replicas}, {args.max_replicas}] "
                  f"queue_high {args.queue_high} every "
                  f"{args.autoscale_interval}s", file=sys.stderr)
    else:
        servers[0].start()
        front = servers[0]
    try:
        if args.http is not None:
            httpd = serve.serve_http(front, port=args.http)
            host, port = httpd.server_address[:2]
            print(f"serving http://{host}:{port}", file=sys.stderr)
            try:
                if args.join:
                    # Serve in the background so the router's join-time
                    # /healthz probe (which checks we are primed and
                    # alive) can reach us before we block.
                    t = threading.Thread(
                        target=httpd.serve_forever, daemon=True
                    )
                    t.start()
                    _announce_join(args.join, host, port)
                    t.join()
                else:
                    httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.shutdown()
        else:
            served = serve.serve_stdio(front, sys.stdin, sys.stdout)
            print(f"served {served} requests", file=sys.stderr)
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
        print_perf_report(args)
        print_policy_report(args)
        print_telemetry_report(args)
    return 0


def _announce_join(router_url: str, host: str, port: int) -> None:
    """POST /join to the front door; a code-109 signature fence comes
    back as a structured envelope and exits with its message."""
    url = f"http://{host}:{port}"
    req = urllib.request.Request(
        router_url.rstrip("/") + "/join",
        data=json.dumps({"name": f"{host}:{port}", "url": url}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            rec = json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        raise SystemExit(f"join rejected by {router_url}: {body}") from e
    print(f"joined fleet at {router_url}: epoch {rec.get('epoch')} "
          f"placeable {rec.get('placeable')}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
