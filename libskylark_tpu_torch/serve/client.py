"""The Python client: in-process (zero-copy futures) or HTTP loopback
(port of ``libskylark_tpu/serve/client.py``; host-only).

``Client(server)`` talks straight to a :class:`~.server.Server` in the
same process — results come back as numpy arrays, and concurrent
callers coalesce.  ``Client(url="http://127.0.0.1:PORT")`` speaks the
:mod:`.transport` HTTP front end — results come back as the protocol's
nested lists.

HTTP clients hold one **keep-alive** connection per calling thread
(the transport speaks HTTP/1.1): under a serving workload of many
small requests, the TCP handshake would otherwise dominate the wire
cost of a ~100-byte frame.  A connection that went stale between calls
is retried once on a fresh socket; the reused-vs-fresh split is
counted (``serve.client_conn_reused`` / ``serve.client_conn_fresh``)
so a fleet bench can verify reuse is actually happening.

Every convenience method returns the protocol response dict by default;
``check=True`` unwraps ``result`` and re-raises structured errors as
their :mod:`utils.exceptions` classes (code-mapped)."""

from __future__ import annotations

import http.client
import json
import os
import threading
import uuid
from urllib.parse import urlsplit

from .. import telemetry
from . import protocol

__all__ = ["Client", "default_timeout_s"]


def default_timeout_s() -> float:
    """The bounded socket read timeout HTTP clients use when none is
    passed: ``SKYLARK_HTTP_TIMEOUT_S`` (seconds, default 60).  Bounded
    by default on purpose — a hung replica must surface as a timeout
    the router can eject on (the 114 path), never block a caller
    thread forever on ``recv``."""
    return float(os.environ.get("SKYLARK_HTTP_TIMEOUT_S", "60"))


class Client:
    def __init__(self, server=None, *, url: str | None = None,
                 timeout: float | None = None):
        if (server is None) == (url is None):
            raise ValueError("pass exactly one of server= or url=")
        self._server = server
        self._url = url.rstrip("/") if url else None
        self._timeout = default_timeout_s() if timeout is None else timeout
        self._local = threading.local()
        if self._url:
            parts = urlsplit(self._url)
            self._host = parts.hostname or "127.0.0.1"
            self._port = parts.port or 80
            self._base = parts.path.rstrip("/")

    # -- transport ----------------------------------------------------------

    def _request(self, method: str, path: str,
                 body: bytes | None = None) -> str:
        """One HTTP exchange over this thread's keep-alive connection.

        A reused connection the server has since closed fails on the
        first read — retried ONCE on a fresh socket; errors on a fresh
        connection propagate (the server is actually down)."""
        for _ in range(2):
            conn = getattr(self._local, "conn", None)
            fresh = conn is None
            if fresh:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=self._timeout
                )
                self._local.conn = conn
            try:
                conn.request(
                    method, self._base + path, body=body,
                    headers={"Content-Type": "application/json"}
                    if body is not None else {},
                )
                resp = conn.getresponse()
                text = resp.read().decode()
                if resp.will_close:
                    conn.close()
                    self._local.conn = None
                telemetry.inc(
                    "serve.client_conn_fresh" if fresh
                    else "serve.client_conn_reused"
                )
                return text
            except (http.client.HTTPException, OSError):
                conn.close()
                self._local.conn = None
                if fresh:
                    raise
        raise OSError("unreachable")  # pragma: no cover

    def close(self) -> None:
        """Drop this thread's keep-alive connection (idempotent)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def call(self, request: dict | None = None, /, **fields) -> dict:
        req = dict(request or {}, **fields)
        if self._server is not None:
            return self._server.call(req)
        return protocol.decode(
            self._request("POST", "/", protocol.encode(req).encode())
        )

    def call_many(self, requests: list[dict]) -> list[dict]:
        """Submit concurrently (the coalescing path for remote callers)."""
        if self._server is not None:
            futures = [self._server.submit(r) for r in requests]
            return [f.result() for f in futures]
        data = json.dumps(requests, default=lambda o: o.tolist()).encode()
        return json.loads(self._request("POST", "/", data))

    def healthz(self) -> dict:
        """The server's ``/healthz`` (includes the ``load`` report the
        fleet router places by); in-process, the report directly."""
        if self._server is not None:
            return {
                "ok": True,
                "load": self._server.load_report(),
                "primed": list(self._server.primed),
            }
        return json.loads(self._request("GET", "/healthz"))

    # -- conveniences -------------------------------------------------------

    @staticmethod
    def _unwrap(response: dict, check: bool):
        if not check:
            return response
        return protocol.raise_for_error(response)["result"]

    def ls_solve(self, system: str, b, *, check: bool = False, **fields):
        return self._unwrap(
            self.call(op="ls_solve", system=system, b=b, **fields), check
        )

    def cond_est(self, system: str, *, check: bool = False, **fields):
        return self._unwrap(
            self.call(op="cond_est", system=system, **fields), check
        )

    def predict(self, model: str, x, *, labels: bool = False,
                check: bool = False, **fields):
        return self._unwrap(
            self.call(op="predict", model=model, x=x, labels=labels, **fields),
            check,
        )

    def ppr(self, graph: str, seeds, *, check: bool = False, **fields):
        return self._unwrap(
            self.call(op="ppr", graph=graph, seeds=seeds, **fields), check
        )

    def ase_embed(self, graph: str, *, check: bool = False, **fields):
        """Embedding queries: pass ``ids=`` for row lookups or
        ``neighbors=`` for an out-of-sample projection (exactly one)."""
        return self._unwrap(
            self.call(op="ase_embed", graph=graph, **fields), check
        )

    def update(self, *, check: bool = False, idem_key: str | None = None,
               **fields):
        """Live-registry mutation with exactly-once semantics: mints a
        fresh idempotency key when the caller supplies none, so a retry
        of THIS call (client timeout whose first send actually landed,
        router failover re-placement) can never double-apply — the
        server's dedup window returns the original epoch receipt."""
        if idem_key is None:
            idem_key = uuid.uuid4().hex
        return self._unwrap(
            self.call(op="update", idem_key=idem_key, **fields), check
        )

    def ping(self) -> bool:
        return bool(self.call(op="ping").get("ok"))

    def stats(self) -> dict:
        return protocol.raise_for_error(self.call(op="stats"))["result"]
