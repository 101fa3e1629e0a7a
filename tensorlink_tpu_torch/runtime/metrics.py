"""Step metrics + timing (a copy of ``tensorlink_tpu/runtime/metrics.py``,
which uses no framework: the port keeps its own so that it never imports
the JAX package).

Structured per-step metrics — loss, samples/sec/chip, pipeline-bubble %,
step latency — plus a lightweight rolling aggregator a node can publish
over its HTTP status endpoint, with Prometheus text exposition.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import re
import time
from dataclasses import dataclass, field
from typing import Any, Deque


class StepTimer:
    """Wall-clock step timer with warmup discard."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0: float | None = None
        self._steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup:
            self.times.append(dt)

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else math.nan

    @property
    def p50_s(self) -> float:
        if not self.times:
            return math.nan
        s = sorted(self.times)
        return s[len(s) // 2]


def pipeline_bubble_fraction(num_stages: int, num_micro: int) -> float:
    """Ideal GPipe bubble fraction (S-1)/(M+S-1).

    The reference never scheduled its pipeline (ordering emerged from thread
    timing + a 0.5 s stagger, src/ml/distributed.py:107); here the schedule
    is explicit so the bubble is a closed-form, reportable quantity.
    """
    s, m = num_stages, num_micro
    return (s - 1) / (m + s - 1) if s > 1 else 0.0


# Latency-shaped default buckets (seconds): 1 ms .. 10 s, roughly
# log-spaced — the Prometheus client-library convention.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Device-dispatch-shaped buckets (seconds): a decode chunk on a real
# chip lands in the 10 µs..10 ms range, where DEFAULT_BUCKETS would bin
# every observation into the first bucket and flatten the quantiles.
# Used by the DispatchTimer per-program busy histograms.
DEVICE_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)


class Histogram:
    """Fixed-bucket histogram with cumulative counts — O(len(buckets))
    memory regardless of observation count (the rolling deques cap at
    ``window``; a histogram never drops, so p99 over a long run is
    honest). Quantiles interpolate linearly within the bucket, the same
    estimate Prometheus' ``histogram_quantile`` computes server-side."""

    __slots__ = ("buckets", "counts", "sum", "n")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.n += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1); nan when empty. Values above the
        last finite bucket clamp to that bound — the same saturation
        Prometheus applies to +Inf observations."""
        if self.n == 0:
            return math.nan
        rank = q * self.n
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):  # overflow bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return self.buckets[-1]

    def snapshot(self) -> dict[str, Any]:
        return {
            "n": self.n,
            "sum": self.sum,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset
    ([a-zA-Z_:][a-zA-Z0-9_:]*) — counter names like ``msg:PING`` carry
    colons legally, but leading digits and other punctuation do not."""
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return s if s and not s[0].isdigit() else f"_{s}"


@dataclass
class Metrics:
    """Rolling metrics registry. json-serializable snapshots, plus
    Prometheus text exposition (``GET /metrics?format=prom``)."""

    window: int = 100
    series: dict[str, Deque[float]] = field(default_factory=dict)
    counters: collections.Counter = field(default_factory=collections.Counter)
    histograms: dict[str, Histogram] = field(default_factory=dict)

    def observe(self, name: str, value: float) -> None:
        q = self.series.setdefault(name, collections.deque(maxlen=self.window))
        q.append(float(value))

    def observe_hist(
        self, name: str, value: float,
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        """Record into a fixed-bucket histogram (created on first use;
        ``buckets`` only applies then — a live histogram's bounds are
        immutable, cumulative counts cannot be re-binned)."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets or DEFAULT_BUCKETS)
        h.observe(value)

    def incr(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {"counters": dict(self.counters)}
        for name, q in self.series.items():
            if q:
                vals = list(q)
                out[name] = {
                    "last": vals[-1],
                    "mean": sum(vals) / len(vals),
                    # additive keys only: consumers of the r0 shape
                    # (last/mean/n) keep working
                    "min": min(vals),
                    "max": max(vals),
                    "n": len(vals),
                }
        if self.histograms:
            out["histograms"] = {
                name: h.snapshot() for name, h in self.histograms.items()
            }
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def to_prometheus(self, prefix: str = "tensorlink") -> str:
        """Prometheus text exposition format (0.0.4): counters as
        ``_total`` counters, rolling series as gauges (last value; the
        window mean/min/max stay JSON-side), histograms as cumulative
        ``_bucket{le=...}`` + ``_sum`` + ``_count`` series. Exactly one
        ``# HELP`` + ``# TYPE`` pair per metric family (exposition
        format 0.0.4 conformance — promtool and client_golang's parser
        both want HELP before TYPE); name collisions after sanitization
        keep the first metric and drop later ones (never two TYPEs)."""
        lines: list[str] = []
        seen: set[str] = set()

        def emit(name: str, kind: str, raw: str) -> bool:
            if name in seen:
                return False
            seen.add(name)
            # HELP text is the source metric name (pre-sanitization) +
            # kind — escaped per the format spec (\\ and \n only)
            help_text = (
                f"tensorlink {kind} {raw}"
                .replace("\\", r"\\").replace("\n", r"\n")
            )
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            return True

        for name in sorted(self.counters):
            p = f"{prefix}_{_prom_name(name)}_total"
            if emit(p, "counter", name):
                lines.append(f"{p} {self.counters[name]}")
        for name in sorted(self.series):
            q = self.series[name]
            if not q:
                continue
            p = f"{prefix}_{_prom_name(name)}"
            if emit(p, "gauge", name):
                lines.append(f"{p} {q[-1]}")
        for name in sorted(self.histograms):
            h = self.histograms[name]
            p = f"{prefix}_{_prom_name(name)}"
            if not emit(p, "histogram", name):
                continue
            cum = 0
            for bound, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{p}_bucket{{le="{bound}"}} {cum}')
            lines.append(f'{p}_bucket{{le="+Inf"}} {h.n}')
            lines.append(f"{p}_sum {h.sum}")
            lines.append(f"{p}_count {h.n}")
        return "\n".join(lines) + "\n"


def throughput(samples: int, seconds: float, chips: int = 1) -> float:
    """samples/sec/chip — headline metric per BASELINE.json."""
    return samples / seconds / max(chips, 1) if seconds > 0 else math.nan
