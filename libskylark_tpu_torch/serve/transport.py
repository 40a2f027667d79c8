"""Process-boundary transports: JSON-lines stdio and HTTP loopback (port
of ``libskylark_tpu/serve/transport.py``).

Both speak the exact :mod:`.protocol` frames — the serialized-sketch /
JSON parity contract the ``native/`` C-API surface uses — so any
language that can write a JSON line can drive a server.

- :func:`serve_stdio` — one request per input line, one response per
  output line, in order.  The systemd/inetd-style deployment: a parent
  process owns the pipe pair.
- :func:`serve_http` — a loopback ``ThreadingHTTPServer``: ``POST /``
  with a request object (or a list of them — submitted concurrently,
  answered as a list, which is how a remote caller reaches the
  coalescer), plus the read-only observability surface: ``GET /stats``,
  ``GET /healthz`` (resolved backend, registry census, primed rungs),
  ``GET /metrics`` (Prometheus text format 0.0.4),
  ``GET /traces`` (flight-recorder ids; ``?drain=1`` removes what it
  returns) and ``GET /traces/<id>`` (one trace, JSON).

Every GET is served from snapshots/copies taken under the telemetry
locks — scrapes never block the worker thread and can never observe a
torn registry.  Neither transport catches a failed launch to answer
from elsewhere: a request whose dispatch raised gets its structured
error envelope.
"""

from __future__ import annotations

import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import telemetry
from . import protocol

__all__ = ["serve_stdio", "serve_http"]


def serve_stdio(server, in_stream, out_stream) -> int:
    """Drain ``in_stream`` line-by-line until EOF; returns the number of
    requests served.  Malformed lines get a structured error response
    (the stream stays usable)."""
    served = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            request = protocol.decode(line)
        except Exception as e:  # noqa: BLE001 — bad frame, keep serving
            out_stream.write(
                protocol.encode(
                    protocol.error_response(None, e, {"events": []})
                ) + "\n"
            )
            out_stream.flush()
            continue
        response = server.call(request)
        out_stream.write(protocol.encode(response) + "\n")
        out_stream.flush()
        served += 1
    return served


def _healthz(srv) -> dict:
    """Liveness + identity: which backend actually resolved, how much is
    registered, whether the plan ladder is primed — the three facts a
    probe needs to tell 'up' from 'up but will stall mid-traffic'.  For
    fleet members the full load report rides along as ``"load"`` (queue
    pressure, per-key throughput, census signature) — one GET is both
    the probe and the router's heartbeat."""
    registry = getattr(srv, "registry", None)
    if registry is not None:
        dev = registry.device
    else:  # a Router front door: its replicas' device kind
        import torch

        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    backend = "gpu" if dev.type == "cuda" else dev.type
    out = {"ok": True, "backend": backend, "telemetry": telemetry.enabled()}
    if registry is not None:  # a Server (a Router front door has none)
        out["device"] = str(dev)
        out["registry"] = {
            "models": len(registry.models),
            "systems": len(registry.systems),
        }
        out["primed"] = list(srv.primed)
        out["worker_alive"] = (
            srv._thread is not None and srv._thread.is_alive()
        )
    if hasattr(srv, "load_report"):
        out["load"] = srv.load_report()
    if hasattr(srv, "fleet_report"):
        out["fleet"] = srv.fleet_report()
    scaler = getattr(srv, "autoscaler", None)
    if scaler is not None:  # a Router front door with a control loop
        out["autoscale"] = scaler.report()
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "skylark-serve"
    # Keep-alive: HTTP/1.0 (the BaseHTTPRequestHandler default) closes
    # the socket per response, making every ~100-byte frame pay a TCP
    # handshake; every _send path always sets Content-Length, which is
    # what HTTP/1.1 persistence requires.
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet: telemetry owns observability
        pass

    def _send(self, code: int, obj) -> None:
        body = protocol.encode(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server.skylark_server
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._send(200, _healthz(srv))
        elif path == "/stats":
            self._send(200, srv.stats())
        elif path == "/fleet":
            # A Router front door answers with the membership table; a
            # plain Server answers with its own load report, so one
            # probe URL works against either end of the fleet.
            if hasattr(srv, "fleet_report"):
                self._send(200, srv.fleet_report())
            elif hasattr(srv, "load_report"):
                self._send(200, srv.load_report())
            else:
                self._send(
                    404, {"ok": False, "error": {"message": "not found"}}
                )
        elif path == "/metrics":
            from ..telemetry.exposition import CONTENT_TYPE

            queue = getattr(srv, "queue", None)
            self._send_text(
                200,
                telemetry.prometheus_text(
                    extra_gauges={"serve_queue_depth": len(queue)}
                    if queue is not None else None
                ),
                CONTENT_TYPE,
            )
        elif path == "/slo":
            # Error-budget state for every declared objective (empty
            # objectives dict when SKYLARK_SLO is unset — the endpoint
            # answers either way so probes can distinguish "no SLOs"
            # from "old replica without the endpoint").
            self._send(200, {
                "objectives": telemetry.slo_report(),
                "slo_spec": os.environ.get("SKYLARK_SLO") or "",
            })
        elif path == "/timeline":
            # Serving the ring also rolls it forward: an idle replica
            # still closes windows when scraped.
            queue = getattr(srv, "queue", None)
            telemetry.timeline_tick(
                extra={"queue_depth": len(queue)}
                if queue is not None else None
            )
            self._send(200, telemetry.timeline_state())
        elif path == "/traces":
            if "drain=1" in query.split("&"):
                self._send(200, telemetry.drain_traces())
            else:
                self._send(200, telemetry.trace_ids())
        elif path.startswith("/traces/"):
            trace = telemetry.get_trace(path[len("/traces/"):])
            if trace is None:
                self._send(
                    404, {"ok": False, "error": {"message": "unknown trace"}}
                )
            else:
                self._send(200, trace)
        else:
            self._send(404, {"ok": False, "error": {"message": "not found"}})

    def do_POST(self):
        srv = self.server.skylark_server
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
        except Exception as e:  # noqa: BLE001 — bad frame
            self._send(
                400, protocol.error_response(None, e, {"events": []})
            )
            return
        if self.path.partition("?")[0] == "/join":
            # Fleet membership: a replica announces itself to a Router
            # front door.  Signature mismatches come back as structured
            # code-109 envelopes (HTTP 409), not stack traces.
            if not hasattr(srv, "handle_join"):
                self._send(
                    404, {"ok": False, "error": {"message": "not a router"}}
                )
            else:
                try:
                    self._send(200, {"ok": True, **srv.handle_join(payload)})
                except Exception as e:  # noqa: BLE001 — structured join errors
                    self._send(
                        409, protocol.error_response(None, e, {"events": []})
                    )
            return
        # QoS lane key from the wire: an X-Skylark-Tenant header stamps
        # every request in the body that doesn't already carry its own
        # "tenant" field (payload wins — the header is the transport-
        # level default, e.g. one gateway per tenant).
        tenant = self.headers.get("X-Skylark-Tenant")
        if tenant:
            if isinstance(payload, dict):
                payload.setdefault("tenant", tenant)
            elif isinstance(payload, list):
                for r in payload:
                    if isinstance(r, dict):
                        r.setdefault("tenant", tenant)
        if isinstance(payload, list):
            # concurrent submission IS the point: a remote batch rides
            # the same cross-request coalescer in-process callers hit
            futures = [srv.submit(r) for r in payload]
            self._send(200, [f.result() for f in futures])
        else:
            self._send(200, srv.call(payload))


def serve_http(server, host: str = "127.0.0.1", port: int = 0):
    """Bind a loopback HTTP front end; returns the ``ThreadingHTTPServer``
    (``.server_address`` has the bound port; call ``serve_forever`` /
    ``shutdown`` to run and stop it)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.skylark_server = server
    return httpd
