"""Distributed span tracing — dependency-free (a copy of
``tensorlink_tpu/runtime/tracing.py``: the port keeps its own so that it
never imports the JAX package; ``StepTelemetry.shape_key`` walks the
batch with ``utils/trees.tree_leaves`` in place of ``jax.tree.leaves``).

The reference's only observability is per-peer message counters and a
PING latency probe (src/p2p/smart_node.py:855-892); a user→validator→
worker RPC leaves no correlated record anywhere. Here every node carries
a :class:`Tracer` with a bounded in-memory span buffer; spans opened on
one node propagate over the p2p envelope (p2p/node.py injects a
``_trace`` field into outbound messages while a span is active, and the
receiving dispatch opens a child span), so one job's RPC chain stitches
into a single trace across roles.

Export is the Chrome-trace ``traceEvents`` format — the same format a
``torch.profiler`` capture exports and ``profiling.parse_op_breakdown``
already consumes — served by ``GET /spans`` on the node's StatusServer and
openable directly in Perfetto (ui.perfetto.dev) or chrome://tracing.

Clocks: spans are stamped with wall-clock ``time.time_ns()`` on both
ends so spans from different nodes land on one shared timeline (skew is
whatever NTP leaves, microseconds on a LAN — fine for ms-scale RPCs);
durations subtract the same clock, so a span is internally consistent
even if the host steps its clock between traces.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
import threading
import time
import uuid
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

# The active span for the current task/thread. contextvars (not a
# thread-local): asyncio handlers running concurrently in one thread each
# see their own span, and to_thread copies the context so StageRunner
# work keeps its parent.
_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "tensorlink_tpu_torch_current_span", default=None
)


def _new_id() -> str:
    """128-bit random id, hex, truncated to 16 chars (64 bits — the same
    width OpenTelemetry uses for span ids; collision-safe for a buffer of
    thousands)."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed operation. ``trace_id`` groups a causal chain (shared
    across nodes), ``parent_id`` is the span that caused this one —
    possibly on a different node (wire context)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    attrs: dict[str, Any] = field(default_factory=dict)
    start_ns: int = 0
    end_ns: int | None = None
    status: str = "ok"

    @property
    def duration_ns(self) -> int:
        return 0 if self.end_ns is None else max(self.end_ns - self.start_ns, 0)

    def context(self) -> dict[str, str]:
        """Wire form for cross-node propagation (the ``_trace`` field)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "attrs": self.attrs,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "status": self.status,
        }


def current_span() -> Span | None:
    """The task's active span, or None (used by JsonFormatter to stamp
    trace_id/span_id onto log records)."""
    return _current_span.get()


def current_trace_context() -> dict[str, str] | None:
    """Wire context of the active span, or None when no span is active —
    the one-ContextVar-read fast path p2p ``send`` uses, so untraced
    nodes pay no envelope overhead."""
    s = _current_span.get()
    return None if s is None else s.context()


class Tracer:
    """Per-node span recorder with a bounded buffer (oldest evicted).

    Usage::

        with tracer.span("train_step", {"step": 3}):
            ...                        # child spans nest automatically

        @tracer.trace("recruit")
        async def recruit(...): ...    # decorator (sync or async)

    A span opened while another is active becomes its child (same
    trace_id); ``remote=`` instead parents onto a wire context received
    from a peer, which is how cross-node chains stitch.
    """

    def __init__(self, service: str = "node", max_spans: int = 2048):
        self.service = service
        self.max_spans = max_spans
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()  # handlers record from worker threads

    # -------------------------------------------------------------- record
    def start_span(
        self,
        name: str,
        attrs: dict | None = None,
        remote: dict | None = None,
    ) -> Span:
        parent = _current_span.get()
        if remote is not None and remote.get("trace_id"):
            # remote contexts arrive from the WIRE: cap id lengths so a
            # hostile peer cannot pin megabytes per span in the buffer
            # (and in every /spans response) via a giant _trace field
            trace_id = str(remote["trace_id"])[:64]
            parent_id = (
                str(remote["span_id"])[:64] if remote.get("span_id") else None
            )
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_id(), None
        return Span(
            name=name,
            trace_id=trace_id,
            span_id=_new_id(),
            parent_id=parent_id,
            attrs=dict(attrs or {}),
            start_ns=time.time_ns(),
        )

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        attrs: dict | None = None,
        remote: dict | None = None,
    ) -> Iterator[Span]:
        s = self.start_span(name, attrs, remote)
        token = _current_span.set(s)
        try:
            yield s
        except BaseException as e:
            s.status = "error"
            s.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            _current_span.reset(token)
            s.end_ns = time.time_ns()
            with self._lock:
                self._spans.append(s)

    def trace(
        self, name: str | None = None, attrs: dict | None = None
    ) -> Callable:
        """Decorator form of :meth:`span`; works on sync and async
        callables, span named after the function unless given."""

        def deco(fn):
            label = name or fn.__qualname__
            if inspect.iscoroutinefunction(fn):

                @functools.wraps(fn)
                async def awrap(*a, **kw):
                    with self.span(label, attrs):
                        return await fn(*a, **kw)

                return awrap

            @functools.wraps(fn)
            def wrap(*a, **kw):
                with self.span(label, attrs):
                    return fn(*a, **kw)

            return wrap

        return deco

    def finish_span(self, s: Span, status: str = "ok") -> Span:
        """Close and record a span obtained from :meth:`start_span`
        without ever making it the ambient context — for spans held
        open across awaits in different tasks (the disaggregated-
        serving front end keeps one root span per request from submit
        to result and parents each leg's RPC span onto it via
        ``remote=s.context()``)."""
        s.end_ns = time.time_ns()
        s.status = status
        with self._lock:
            self._spans.append(s)
        return s

    def record_span(
        self,
        name: str,
        start_ns: int,
        end_ns: int,
        attrs: dict | None = None,
        *,
        trace_id: str | None = None,
        parent: Span | None = None,
        status: str = "ok",
    ) -> Span:
        """Append an already-finished span from explicit timestamps —
        for reconstructed timelines (the serving engines stitch each
        request's queue/prefill/decode phases at finish time, from
        stamps taken on the hot path where opening a live span per
        phase would mean span context churn per token chunk). Same
        buffer/eviction as live spans; ``parent`` nests it under
        another recorded span, ``trace_id`` groups siblings."""
        s = Span(
            name=name,
            trace_id=(
                trace_id if trace_id is not None
                else (parent.trace_id if parent is not None else _new_id())
            ),
            span_id=_new_id(),
            parent_id=parent.span_id if parent is not None else None,
            attrs=dict(attrs or {}),
            start_ns=int(start_ns),
            end_ns=int(end_ns),
            status=status,
        )
        with self._lock:
            self._spans.append(s)
        return s

    # -------------------------------------------------------------- read
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def to_chrome_trace(self) -> dict:
        """Finished spans as a Chrome-trace object ``{"traceEvents":
        [...]}`` — complete ("X") events in microseconds, one pid per
        tracer (named after the service), one tid per trace so each
        causal chain gets its own timeline row in Perfetto. Span ids and
        attrs ride in ``args``."""
        pid = zlib.crc32(self.service.encode()) & 0x7FFFFFFF
        events: list[dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": self.service},
            }
        ]
        tids_named: set[int] = set()
        for s in self.spans():
            if s.end_ns is None:
                continue
            tid = zlib.crc32(s.trace_id.encode()) & 0x7FFFFFFF
            if tid not in tids_named:
                tids_named.add(tid)
                events.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": f"trace {s.trace_id[:8]}"},
                    }
                )
            events.append(
                {
                    "ph": "X",
                    "name": s.name,
                    "cat": "span" if s.status == "ok" else "span,error",
                    "pid": pid,
                    "tid": tid,
                    "ts": s.start_ns / 1e3,
                    "dur": s.duration_ns / 1e3,
                    "args": {
                        "trace_id": s.trace_id,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                        **s.attrs,
                    },
                }
            )
        return {"traceEvents": events}


# ----------------------------------------------------------- step telemetry
class StepTelemetry:
    """Shared train-step instrumentation for Trainer/ShardedTrainer: a
    (shape, dtype, rng-variant) cache key decides whether THIS call
    compiles — the span is labeled ``{prefix}.compile_step`` vs
    ``{prefix}.step`` accordingly, and compile time never pollutes the
    ``step_seconds`` latency histogram. Host-side dispatch time; a first
    call's duration is dominated by the XLA compile."""

    def __init__(
        self,
        tracer: "Tracer | None",
        metrics: Any,
        prefix: str,
        attrs: dict | None = None,
    ):
        self.tracer = tracer
        self.metrics = metrics
        self.prefix = prefix
        self.attrs = dict(attrs or {})
        self._seen: set = set()

    @staticmethod
    def shape_key(batch: Any, rng: Any) -> tuple:
        """jit cache-key proxy: a new signature means the call retraces."""
        from tensorlink_tpu_torch.utils.trees import tree_leaves

        return (
            rng is None,
            tuple(
                (tuple(getattr(x, "shape", ())), str(getattr(x, "dtype", "")))
                for x in tree_leaves(batch)
            ),
        )

    def seen(self, batch: Any, rng: Any) -> bool:
        """Whether this call signature already compiled — i.e. the next
        :meth:`step` will be a real step, not a compile (the device
        timer skips compile calls)."""
        return self.shape_key(batch, rng) in self._seen

    @contextlib.contextmanager
    def step(self, batch: Any, rng: Any) -> Iterator[None]:
        key = self.shape_key(batch, rng)
        first = key not in self._seen
        self._seen.add(key)
        cm = (
            self.tracer.span(
                f"{self.prefix}.compile_step" if first else f"{self.prefix}.step",
                self.attrs,
            )
            if self.tracer is not None
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with cm:
            yield
        if self.metrics is not None:
            dt = time.perf_counter() - t0
            self.metrics.observe("compile_s" if first else "step_s", dt)
            if not first:
                self.metrics.observe_hist("step_seconds", dt)
            self.metrics.incr("train_steps")

    @contextlib.contextmanager
    def data(self) -> Iterator[None]:
        """Wrap the batch fetch: ``{prefix}.data`` span + ``data_s``
        series, so input-pipeline stalls show on the step timeline."""
        t0 = time.perf_counter()
        cm = (
            self.tracer.span(f"{self.prefix}.data")
            if self.tracer is not None
            else contextlib.nullcontext()
        )
        with cm:
            yield
        if self.metrics is not None:
            self.metrics.observe("data_s", time.perf_counter() - t0)


# ---------------------------------------------------------------- straggler
def straggler_report(
    metrics: Any, peers: dict[str, Any] | None = None
) -> dict:
    """Per-stage step-time skew + peer heartbeat age — the "which stage
    is slow, and is its worker even alive" view surfaced at ``/node``.

    Reads the rolling ``stage{i}_fwd_s`` / ``stage{i}_bwd_s`` series the
    master records per micro-batch RPC (roles/user.py) — or a worker's
    own local-compute series — and reports each stage's mean time, the
    slowest stage, and skew = slowest / median (1.0 = perfectly even;
    MPMD pipeline work treats this ratio as the straggler signal:
    pipeline throughput is gated by the max, not the mean). ``peers``
    (node_id -> object with ``last_seen``) adds per-peer heartbeat age:
    a straggler whose heartbeat is also stale is dead, not slow.
    """
    import re

    stage_means: dict[str, dict[str, float]] = {}
    series = getattr(metrics, "series", {}) or {}
    for name, q in series.items():
        m = re.fullmatch(r"stage(\d+)_(fwd|bwd)_s", name)
        if not m or not q:
            continue
        vals = list(q)
        rec = stage_means.setdefault(m.group(1), {})
        rec[f"{m.group(2)}_mean_s"] = sum(vals) / len(vals)
        rec[f"{m.group(2)}_n"] = len(vals)
    out: dict[str, Any] = {"stages": stage_means}
    totals = {
        k: v.get("fwd_mean_s", 0.0) + v.get("bwd_mean_s", 0.0)
        for k, v in stage_means.items()
    }
    if totals:
        ordered = sorted(totals.values())
        n = len(ordered)
        # true median (middle pair averaged for even n): with 2 stages
        # the upper-middle shortcut made skew identically 1.0
        median = (ordered[(n - 1) // 2] + ordered[n // 2]) / 2
        slowest = max(totals, key=totals.get)
        out["slowest_stage"] = int(slowest)
        out["slowest_mean_s"] = totals[slowest]
        out["skew"] = (totals[slowest] / median) if median > 0 else float("inf")
    if peers:
        now = time.time()
        out["heartbeat_age_s"] = {
            nid[:16]: round(now - getattr(p, "last_seen", now), 3)
            for nid, p in peers.items()
        }
    return out
