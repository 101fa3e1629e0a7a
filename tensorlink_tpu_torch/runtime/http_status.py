"""HTTP status endpoint for nodes (a copy of
``tensorlink_tpu/runtime/http_status.py``: the port keeps its own so that
it never imports the JAX package; ``/profile`` runs the port's
``runtime/profiling.timed_capture``, a ``torch.profiler`` capture).

The reference exposes a Flask+CORS sidecar with one real route
(`GET /node` -> get_self_info(), src/p2p/node_api.py:5-12, launched only
by the User role on a hardcoded port, src/roles/user.py:44-48). Here every
node can serve status: a dependency-free asyncio HTTP/1.1 responder with

    GET /node     -> node.status()               (reference parity)
    GET /metrics  -> node.metrics snapshot       (loss, throughput, ...)
                     ?format=prom -> Prometheus text exposition
    GET /jobs     -> validator job table         (when the node has one)
    GET /ledger   -> receipt auditor snapshot    (per-tenant/per-worker
                     metering rollups + anomaly counts, validator only)
    GET /spans    -> tracer span buffer as Chrome-trace JSON
                     (open in Perfetto / chrome://tracing)
    GET /events   -> flight-recorder ring buffer (runtime/flight.py)
                     ?kind= &min_severity= &since=<seq> &limit=
    GET /healthz  -> node.health.report(): 200 {"ok": true, ...} when
                     healthy, 503 + {"ok": false, "reasons": {...}}
                     when a watchdog tripped / a readiness condition is
                     set / the event loop lags (truthful liveness +
                     readiness, not a hardcoded constant)
    GET /profile  -> bounded torch.profiler capture of whatever the node
                     is doing right now (?ms=N, clamped to
                     profiling.MAX_PROFILE_MS), parsed into the
                     op_breakdown bundle; a concurrent capture is
                     refused with 409 — one profiler at a time a process

Read only, bound to the node's host; HEAD is answered with headers only.
Every response carries ``Cache-Control: no-store`` — a proxy caching
``/metrics`` would serve stale telemetry silently.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Callable
from urllib.parse import parse_qsl


class Response:
    """Handler return type for a non-200 status (the /healthz 503)."""

    __slots__ = ("status", "body")

    def __init__(self, status: str, body: Any):
        self.status = status
        self.body = body


class StatusServer:
    def __init__(
        self, node: Any, host: str, port: int, timeout_s: float = 5.0
    ):
        self.node = node
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._server: asyncio.AbstractServer | None = None

    @property
    def bound_port(self) -> int | None:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    def _routes(self) -> dict[str, Callable[[dict], Any]]:
        """path -> handler(query_params) -> body. A handler returns a
        JSON-serializable object, ``(content_type, text)`` for non-JSON
        payloads (the Prometheus exposition), or an awaitable of either
        (the /profile capture runs off-loop)."""
        node = self.node

        def profile(q: dict):
            async def run():
                from tensorlink_tpu_torch.runtime import profiling

                ms = int(q.get("ms", 200))
                log_dir = getattr(
                    getattr(node, "cfg", None), "profile_dir", None
                )
                try:
                    # to_thread: the capture sleeps for its duration and
                    # the profiler's start/stop can block — never on the
                    # node's event loop
                    return await asyncio.to_thread(
                        profiling.timed_capture, ms, log_dir
                    )
                except profiling.ProfileBusyError as e:
                    return Response("409 Conflict", {"error": str(e)})

            return run()

        def healthz(q: dict):
            health = getattr(node, "health", None)
            if health is None:
                return {"ok": True}  # health-less nodes stay r1-shaped
            rep = health.report()
            if rep["ok"]:
                return rep  # 200, "ok": true preserved (additive keys)
            return Response("503 Service Unavailable", rep)

        routes: dict[str, Callable[[dict], Any]] = {
            "/healthz": healthz,
            "/node": lambda q: node.status(),
            "/profile": profile,
        }
        flight = getattr(node, "flight", None)
        if flight is not None:

            def events_route(q: dict):
                return {
                    "service": flight.service,
                    "events": flight.events(
                        kind=q.get("kind"),
                        min_severity=q.get("min_severity"),
                        since=int(q["since"]) if "since" in q else None,
                        limit=int(q["limit"]) if "limit" in q else None,
                    ),
                }

            routes["/events"] = events_route
        metrics = getattr(node, "metrics", None)
        if metrics is not None:

            def metrics_route(q: dict):
                if q.get("format") == "prom" and hasattr(metrics, "to_prometheus"):
                    return ("text/plain; version=0.0.4", metrics.to_prometheus())
                return metrics.snapshot()

            routes["/metrics"] = metrics_route
        tracer = getattr(node, "tracer", None)
        if tracer is not None:
            routes["/spans"] = lambda q: tracer.to_chrome_trace()
        ts = getattr(node, "timeseries", None)
        if ts is not None:

            def history_route(q: dict):
                # GET /history?series=NAME&since=T&step=S — one named
                # ring; without ?series= list what's recorded so a
                # dashboard can discover before it queries
                name = q.get("series")
                if not name:
                    return {"tiers": list(ts.tiers), "series": ts.names()}
                if ts.kind(name) is None:
                    return Response(
                        "404 Not Found", {"error": f"no series {name}"}
                    )
                return ts.query(
                    name,
                    since=float(q["since"]) if "since" in q else None,
                    step=float(q["step"]) if "step" in q else None,
                )

            routes["/history"] = history_route
        serving = getattr(node, "serving", None)
        if serving is not None and hasattr(serving, "kv_stats"):

            def kv_route(q: dict):
                # locked residency snapshot: pool occupancy/fragmentation
                # plus the resident prefix chains (digest, blocks, refs,
                # priority class, last-hit age) — ROADMAP-1(a) groundwork
                # (a coroutine off the loop: it takes the engine's lock,
                # which a step holds for its whole run)
                limit = int(q.get("limit", 64))
                return asyncio.to_thread(serving.kv_stats, limit=limit)

            routes["/kv"] = kv_route
        fleet_series = getattr(node, "fleet_series", None)
        if fleet_series is not None:

            def fleet_route(q: dict):
                # ?series=NAME rolls one metric fleet-wide (sum for
                # counters, mean for gauges) beside the per-node points;
                # the bare call is the dashboard summary: per-node last
                # values + KV summaries + active alerts (own and fleet)
                name = q.get("series")
                if name:
                    return fleet_series.query(
                        name,
                        since=float(q["since"]) if "since" in q else None,
                        step=float(q["step"]) if "step" in q else None,
                    )
                out = fleet_series.summary()
                alerts = getattr(node, "fleet_alerts", None)
                own = getattr(node, "alerts", None)
                out["alerts"] = {
                    "own": own.active() if own is not None else [],
                    "fleet": (
                        alerts.active() if alerts is not None else []
                    ),
                }
                return out

            routes["/fleet"] = fleet_route
        auditor = getattr(node, "receipt_auditor", None)
        if auditor is not None:
            routes["/ledger"] = lambda q: auditor.snapshot()
        if hasattr(node, "jobs"):
            routes["/jobs"] = lambda q: {
                jid: {
                    "author": j.author,
                    "stages": j.n_stages,
                    "workers": [
                        (w or {}).get("node_id") for w in (j.workers or [])
                    ],
                    "state": node.job_state.get(jid, {}),
                }
                for jid, j in node.jobs.items()
            }
        return routes

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader) -> list[str]:
        request = await reader.readline()
        parts = request.decode("latin1").split()
        # drain headers
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        return parts

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            # one overall deadline for the whole request (a per-line
            # timeout would let a client trickle header lines and pin a
            # task forever — review finding). wait_for, not the 3.11-only
            # asyncio.timeout: the runtime floor is 3.10 (pyproject).
            parts = await asyncio.wait_for(
                self._read_request(reader), self.timeout_s
            )
            target = parts[1] if len(parts) >= 2 else "/"
            method = parts[0] if parts else ""
            path, _, rawq = target.partition("?")
            query = dict(parse_qsl(rawq))
            handler = self._routes().get(path)
            if method not in ("GET", "HEAD"):
                status, body = "405 Method Not Allowed", {"error": "GET only"}
            elif handler is None:
                status, body = "404 Not Found", {"error": f"no route {path}"}
            else:
                try:
                    status, body = "200 OK", handler(query)
                    if asyncio.iscoroutine(body):
                        body = await body
                except Exception as e:  # noqa: BLE001 — must answer 500
                    status, body = "500 Internal Server Error", {
                        "error": type(e).__name__
                    }
            if isinstance(body, Response):  # handler-chosen status
                status, body = body.status, body.body
            if isinstance(body, tuple):  # (content_type, text) non-JSON
                ctype, payload = body[0], body[1].encode()
            else:
                ctype = "application/json"
                payload = json.dumps(body, default=str).encode()
            # no CORS header: a wildcard ACAO would let any web page the
            # operator's browser visits read this unauthenticated endpoint
            # cross-origin, defeating the loopback-bind default
            head = (
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Cache-Control: no-store\r\n"
                f"Connection: close\r\n\r\n"
            ).encode()
            # HEAD gets the same status line + headers (including the
            # Content-Length a GET would produce) and no body
            writer.write(head if method == "HEAD" else head + payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError):
            # ValueError: StreamReader.readline raises it for a request
            # line beyond the 64 KiB reader limit — drop the connection
            # rather than kill the handler task with a traceback
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )

    async def stop(self) -> None:
        # claim the server BEFORE awaiting: concurrent stop() calls must
        # not both close (the second would await a dead handle) — the
        # check-and-clear is atomic, only the winner tears down
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()
