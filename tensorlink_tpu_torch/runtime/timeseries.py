"""Bounded on-node time-series — history for every metric (a copy of
``tensorlink_tpu/runtime/timeseries.py``, which uses no framework: the
port keeps its own so that it never imports the JAX package).

Everything in ``runtime/metrics.py`` is a point-in-time snapshot: a
counter's current value, a rolling window's last/mean, a histogram's
p99-so-far. None of it can answer "what did TPOT do in the 60 s before
the stall?". This module adds the time axis with HARD memory bounds:

- :class:`TimeSeriesStore` samples an attached :class:`Metrics`
  registry at a fixed cadence into per-series ring buffers with
  N-level downsampling (default 1 s x 10 min and 15 s x 2 h). Memory
  is ``O(max_series x sum(tier slots))`` regardless of run length.
- **Counters are stored cumulative** (the sampled counter value, not a
  rate). Downsampling a cumulative series is just "last sample in the
  bucket", so a delta split across a downsample boundary is conserved
  exactly — consumers compute rates as differences between bucket
  values, at any tier.
- **Gauges downsample by mean** (sum + count per bucket) — the
  coarse tier answers "roughly where was it", not "what was the last
  instant".
- **Gaps stay visible.** A bucket nothing wrote to is absent from
  query results — never interpolated. A stalled node's rings show the
  stall as a hole, which is the whole point.
- Served at ``GET /history?series=&since=&step=`` by the node's
  status server and folded into postmortem bundles so a crash captures
  the minutes *before* it.
- :meth:`TimeSeriesStore.delta` exports a size-bounded cursor-based
  slice for the heartbeat PONG piggyback; :class:`FleetStore` on the
  validator ingests those deltas (hostile-peer sanitized, same policy
  as the capability record) into per-node rings and rolls them up
  fleet-wide at query time (counters sum, gauges average across
  nodes) for ``GET /fleet``.

Dependency-free and importable without torch, like runtime/flight.py —
``tldiag`` and tests use it against plain dicts.
"""

from __future__ import annotations

import fnmatch
import math
import threading
import time
from typing import Any, Iterable

__all__ = [
    "DEFAULT_TIERS",
    "DELTA_DEFAULT_PATTERNS",
    "FleetStore",
    "TimeSeriesStore",
]

# (step_s, slots) per retention tier, finest first:
# 1 s x 600 = 10 min of fine history, 15 s x 480 = 2 h of coarse.
DEFAULT_TIERS: tuple[tuple[float, int], ...] = ((1.0, 600), (15.0, 480))

# Series worth shipping over the heartbeat by default: the SLO inputs
# (per-class TTFT/TPOT percentiles), KV pressure, and the shed/error
# budget counters. fnmatch-style; ``delta()`` callers can widen.
DELTA_DEFAULT_PATTERNS: tuple[str, ...] = (
    "serving_ttft_s*.p99",
    "serving_ttft_s*.count",
    "serving_tpot_s*.p99",
    "kv_pool_utilization",
    "kv_blocks_in_use",
    "serving_shed_total",
    "serving_requests_total",
    "serving_deadline_miss_total",
    "host_gap_frac",
)

# Hostile-peer bounds applied when ingesting a heartbeat delta — the
# same posture as p2p/node.py's capability sanitizer: a byzantine
# peer must not be able to blow up the validator's memory.
MAX_DELTA_SERIES = 48
MAX_DELTA_POINTS = 160
MAX_NAME_LEN = 120

# Wire version of the heartbeat-delta payload, pinned in
# proto.manifest.json (tlproto TLP405). Bump it when the delta's field
# layout changes; ingest rejects unknown versions with a typed counter
# + flight event instead of attempting a parse. A delta WITHOUT the
# "v" field is pre-versioning legacy and still accepted — additive-
# optional is the one silent evolution the compatibility contract
# allows, and that grace window is what lets this very field roll out.
TS_DELTA_SCHEMA = 1


class _Ring:
    """One retention tier of one series: ``slots`` fixed buckets of
    ``step`` seconds, addressed ``bucket_id % slots``. A slot holds
    (bucket_id, aggregate) and is lazily reset when a newer bucket
    wraps onto it — no background expiry task."""

    __slots__ = ("step", "slots", "ids", "acc", "cnt")

    def __init__(self, step: float, slots: int):
        self.step = float(step)
        self.slots = int(slots)
        self.ids = [-1] * self.slots  # bucket id per slot (-1 = empty)
        self.acc = [0.0] * self.slots  # counter: last value; gauge: sum
        self.cnt = [0] * self.slots  # gauge: samples in bucket

    def write(self, t: float, value: float, kind: str) -> None:
        b = int(t // self.step)
        i = b % self.slots
        if self.ids[i] != b:
            self.ids[i] = b
            self.acc[i] = 0.0
            self.cnt[i] = 0
        if kind == "counter":
            # cumulative: last sample in the bucket wins, so coarser
            # tiers conserve deltas across their boundaries exactly
            self.acc[i] = value
        else:
            self.acc[i] += value
        self.cnt[i] += 1

    def points(
        self, since: float | None = None, now: float | None = None,
        kind: str = "gauge",
    ) -> list[list[float]]:
        """Time-ordered ``[t, v]`` pairs (t = bucket start). Buckets
        nothing wrote to are simply absent — gaps, not zeros."""
        if now is None:
            now = time.time()
        cur = int(now // self.step)
        lo = cur - self.slots + 1  # oldest bucket still valid
        if since is not None:
            # first bucket STARTING at/after since — so a cursor of
            # "newest + epsilon" really excludes the bucket already
            # shipped (re-ingesting a gauge bucket would double-count
            # its samples on the fleet side)
            lo = max(lo, int(math.ceil(since / self.step)))
        out: list[tuple[int, float]] = []
        for i in range(self.slots):
            b = self.ids[i]
            if b < lo or b > cur + 1:
                continue  # empty, expired, or impossibly-future slot
            if kind == "gauge" and self.cnt[i] > 0:
                v = self.acc[i] / self.cnt[i]
            else:
                v = self.acc[i]
            out.append((b, v))
        out.sort()
        return [[round(b * self.step, 3), v] for b, v in out]


class _Series:
    __slots__ = ("name", "kind", "rings")

    def __init__(self, name: str, kind: str, tiers):
        self.name = name
        self.kind = kind
        self.rings = [_Ring(step, slots) for step, slots in tiers]


class TimeSeriesStore:
    """Fixed-memory multi-tier ring store for one node's metrics.

    Thread-safe: the asyncio sampler task, serving pump threads (via
    :meth:`record`) and HTTP handlers all touch it.
    """

    def __init__(
        self,
        tiers: Iterable[tuple[float, int]] = DEFAULT_TIERS,
        max_series: int = 512,
    ):
        self.tiers = tuple(
            (float(s), int(n)) for s, n in tiers
        )
        if not self.tiers:
            raise ValueError("need at least one retention tier")
        self.max_series = int(max_series)
        self._series: dict[str, _Series] = {}
        self._lock = threading.Lock()
        self.dropped_series = 0  # cardinality-cap casualties
        self.samples_total = 0

    # ------------------------------------------------------------ write
    def record(
        self, name: str, value: float, kind: str = "gauge",
        now: float | None = None,
    ) -> None:
        """Write one sample into every tier. ``kind`` is fixed at
        series creation; later calls with a different kind keep the
        original (cumulative counters cannot become gauges)."""
        v = float(value)
        if math.isnan(v):
            return
        t = time.time() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                s = self._series[name] = _Series(name, kind, self.tiers)
            for ring in s.rings:
                ring.write(t, v, s.kind)
            self.samples_total += 1

    def sample_metrics(self, metrics: Any, now: float | None = None) -> None:
        """One sampler tick over a :class:`~.metrics.Metrics` registry:
        counters as cumulative counters, rolling series as last-value
        gauges, histogram p50/p99 as gauges plus ``.count`` as a
        cumulative counter (the burn-rate denominators)."""
        t = time.time() if now is None else now
        for name, v in list(metrics.counters.items()):
            self.record(name, v, "counter", now=t)
        for name, q in list(metrics.series.items()):
            if q:
                self.record(name, q[-1], "gauge", now=t)
        for name, h in list(metrics.histograms.items()):
            if h.n == 0:
                continue
            self.record(f"{name}.p50", h.quantile(0.50), "gauge", now=t)
            self.record(f"{name}.p99", h.quantile(0.99), "gauge", now=t)
            self.record(f"{name}.count", h.n, "counter", now=t)

    # ------------------------------------------------------------- read
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, name: str) -> str | None:
        with self._lock:
            s = self._series.get(name)
            return s.kind if s else None

    def _pick_tier(self, s: _Series, since, step, now) -> _Ring:
        """Finest tier that (a) satisfies a requested ``step`` and
        (b) still retains ``since`` — the 2 h tier answers for
        questions the 10 min tier has already forgotten."""
        for ring in s.rings:
            if step is not None and ring.step < float(step) - 1e-9:
                continue
            if since is not None:
                oldest = now - ring.step * ring.slots
                if since < oldest - ring.step:
                    continue
            return ring
        return s.rings[-1]

    def query(
        self, name: str, since: float | None = None,
        step: float | None = None, now: float | None = None,
    ) -> dict[str, Any]:
        t = time.time() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return {"series": name, "points": [], "step": None}
            ring = self._pick_tier(s, since, step, t)
            return {
                "series": name,
                "kind": s.kind,
                "step": ring.step,
                "points": ring.points(since=since, now=t, kind=s.kind),
            }

    def window(
        self, name: str, seconds: float, now: float | None = None,
    ) -> list[list[float]]:
        """Last ``seconds`` of the finest tier — the alert evaluator's
        read path."""
        t = time.time() if now is None else now
        return self.query(name, since=t - seconds, now=t)["points"]

    def snapshot(self, last_s: float | None = None) -> dict[str, Any]:
        """Postmortem form: every series, every tier. ``last_s``
        trims to the final window (crash bundles want the minutes
        before death, not 2 h of flatline)."""
        t = time.time()
        since = None if last_s is None else t - float(last_s)
        out: dict[str, Any] = {
            "tiers": [list(x) for x in self.tiers],
            "series": {},
        }
        with self._lock:
            for name, s in self._series.items():
                out["series"][name] = {
                    "kind": s.kind,
                    "tiers": [
                        {
                            "step": r.step,
                            "points": r.points(
                                since=since, now=t, kind=s.kind
                            ),
                        }
                        for r in s.rings
                    ],
                }
        return out

    # --------------------------------------------- heartbeat delta wire
    def delta(
        self,
        since: float | None,
        patterns: Iterable[str] = DELTA_DEFAULT_PATTERNS,
        now: float | None = None,
        max_series: int = MAX_DELTA_SERIES,
        max_points: int = MAX_DELTA_POINTS,
    ) -> dict[str, Any]:
        """Compact finest-tier slice since the requester's cursor —
        what rides the heartbeat PONG. Stateless on this side: the
        PINGer carries its own ``since`` cursor, so a responder never
        tracks per-peer read positions. Bounded by construction:
        ``max_series`` series, ``max_points`` points total."""
        t = time.time() if now is None else now
        pats = tuple(patterns)
        if since is None:
            # first contact: only the finest tier's last ~30 s, the
            # cursor takes over from there
            since = t - 30.0
        out: dict[str, Any] = {
            "v": TS_DELTA_SCHEMA, "t": round(t, 3), "series": {},
        }
        budget = max_points
        with self._lock:
            for name in sorted(self._series):
                if budget <= 0 or len(out["series"]) >= max_series:
                    break
                if not any(fnmatch.fnmatch(name, p) for p in pats):
                    continue
                s = self._series[name]
                pts = s.rings[0].points(since=since, now=t, kind=s.kind)
                if not pts:
                    continue
                pts = pts[-budget:]
                budget -= len(pts)
                out["series"][name] = {"kind": s.kind, "points": pts}
        return out


def sanitize_delta(delta: Any) -> dict[str, Any] | None:
    """Bound an untrusted peer's heartbeat delta before ingestion —
    the time-series analogue of ``Node._cap_value``: series count,
    point count, name length and value types are all clamped; anything
    non-numeric is dropped, never raised on."""
    if not isinstance(delta, dict):
        return None
    v = delta.get("v", TS_DELTA_SCHEMA)  # absent = pre-versioning peer
    if isinstance(v, bool) or not isinstance(v, int) or \
            v != TS_DELTA_SCHEMA:
        return None  # unknown wire version: reject, don't guess-parse
    raw = delta.get("series")
    if not isinstance(raw, dict):
        return None
    out: dict[str, Any] = {"series": {}}
    t = delta.get("t")
    if isinstance(t, (int, float)) and math.isfinite(t):
        out["t"] = float(t)
    for name, body in list(raw.items())[:MAX_DELTA_SERIES]:
        if not isinstance(name, str) or len(name) > MAX_NAME_LEN:
            continue
        if not isinstance(body, dict):
            continue
        kind = body.get("kind")
        kind = kind if kind in ("counter", "gauge") else "gauge"
        pts = body.get("points")
        if not isinstance(pts, list):
            continue
        clean: list[list[float]] = []
        for p in pts[:MAX_DELTA_POINTS]:
            if (
                isinstance(p, (list, tuple)) and len(p) == 2
                and isinstance(p[0], (int, float))
                and isinstance(p[1], (int, float))
                and math.isfinite(p[0]) and math.isfinite(p[1])
            ):
                clean.append([float(p[0]), float(p[1])])
        if clean:
            out["series"][name] = {"kind": kind, "points": clean}
    return out


class FleetStore:
    """Validator-side rollup: per-node ring stores fed by sanitized
    heartbeat deltas, plus query-time fleet aggregation (counters sum
    across nodes, gauges average) on aligned finest-tier buckets.

    A node that misses beats leaves a hole in its rings — the rollup
    averages over the nodes that DID report, and the per-node view
    shows the gap. Nothing is interpolated.
    """

    def __init__(
        self,
        tiers: Iterable[tuple[float, int]] = DEFAULT_TIERS,
        max_nodes: int = 256,
    ):
        self.tiers = tuple((float(s), int(n)) for s, n in tiers)
        self.max_nodes = int(max_nodes)
        self._nodes: dict[str, TimeSeriesStore] = {}
        self._last_seen: dict[str, float] = {}
        self._cursor: dict[str, float] = {}  # next PING's since=
        self._kv: dict[str, dict] = {}  # last kv summary per node
        self._lock = threading.Lock()

    # ------------------------------------------------------------ write
    def ingest(
        self, node_id: str, delta: Any, now: float | None = None,
        kv: Any = None,
    ) -> int:
        """Sanitize + ingest one peer's delta; returns points kept.
        Advances the per-node cursor to the newest point so the next
        PING asks only for what's new (a missed beat widens the ask —
        the gap closes from the responder's rings, not by guessing)."""
        t = time.time() if now is None else now
        clean = sanitize_delta(delta)
        with self._lock:
            if node_id not in self._nodes:
                if len(self._nodes) >= self.max_nodes:
                    return 0
                self._nodes[node_id] = TimeSeriesStore(self.tiers)
            store = self._nodes[node_id]
            self._last_seen[node_id] = t
            if isinstance(kv, dict):
                self._kv[node_id] = _sanitize_kv_summary(kv)
        kept = 0
        newest = None
        if clean:
            for name, body in clean["series"].items():
                for pt, pv in body["points"]:
                    store.record(name, pv, body["kind"], now=pt)
                    kept += 1
                    if newest is None or pt > newest:
                        newest = pt
        with self._lock:
            if newest is not None:
                # +half step: never re-request the bucket just stored
                cur = self._cursor.get(node_id, 0.0)
                self._cursor[node_id] = max(cur, newest + 1e-3)
        return kept

    def cursor(self, node_id: str) -> float | None:
        with self._lock:
            return self._cursor.get(node_id)

    def forget(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            self._last_seen.pop(node_id, None)
            self._cursor.pop(node_id, None)
            self._kv.pop(node_id, None)

    # ------------------------------------------------------------- read
    def nodes(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def last_seen_age(self, node_id: str, now: float | None = None):
        t = time.time() if now is None else now
        with self._lock:
            seen = self._last_seen.get(node_id)
        return None if seen is None else max(0.0, t - seen)

    def node_store(self, node_id: str) -> TimeSeriesStore | None:
        with self._lock:
            return self._nodes.get(node_id)

    def query(
        self, name: str, since: float | None = None,
        step: float | None = None, now: float | None = None,
    ) -> dict[str, Any]:
        """Per-node + fleet-rolled points for one series."""
        t = time.time() if now is None else now
        with self._lock:
            stores = dict(self._nodes)
        per_node: dict[str, Any] = {}
        kinds: set[str] = set()
        for nid, store in stores.items():
            q = store.query(name, since=since, step=step, now=t)
            if q["points"]:
                per_node[nid] = q
                if q.get("kind"):
                    kinds.add(q["kind"])
        kind = "counter" if kinds == {"counter"} else "gauge"
        # fleet rollup on aligned buckets: counters sum, gauges mean
        agg: dict[float, list[float]] = {}
        for q in per_node.values():
            for pt, pv in q["points"]:
                agg.setdefault(pt, []).append(pv)
        if kind == "counter":
            fleet = [[pt, sum(vs)] for pt, vs in sorted(agg.items())]
        else:
            fleet = [
                [pt, sum(vs) / len(vs)] for pt, vs in sorted(agg.items())
            ]
        return {
            "series": name,
            "kind": kind,
            "nodes": per_node,
            "fleet": fleet,
        }

    def summary(self, now: float | None = None) -> dict[str, Any]:
        """The ``GET /fleet`` body: node roster with staleness + kv
        summaries, the series catalog, and the retention tiers."""
        t = time.time() if now is None else now
        with self._lock:
            stores = dict(self._nodes)
            seen = dict(self._last_seen)
            kv = {k: dict(v) for k, v in self._kv.items()}
        names: set[str] = set()
        for s in stores.values():
            names.update(s.names())
        return {
            "tiers": [list(x) for x in self.tiers],
            "nodes": {
                nid: {
                    "last_seen_age_s": round(max(0.0, t - seen[nid]), 3)
                    if nid in seen else None,
                    "series": stores[nid].names(),
                    **({"kv": kv[nid]} if nid in kv else {}),
                }
                for nid in sorted(stores)
            },
            "series": sorted(names),
        }


def _sanitize_kv_summary(kv: dict) -> dict:
    """Bound an untrusted peer's kv residency summary (scalars only,
    fixed keys) before it lands in the fleet table."""
    out: dict[str, Any] = {}
    for k in (
        "num_blocks", "used", "free", "reusable", "cached",
        "occupancy", "fragmentation", "chains", "prefix_blocks",
    ):
        v = kv.get(k)
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)) and math.isfinite(v):
            out[k] = round(float(v), 6) if isinstance(v, float) else int(v)
    return out
