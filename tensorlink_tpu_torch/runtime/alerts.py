"""Declarative SLO alerting over the time-series rings (a copy of
``tensorlink_tpu/runtime/alerts.py``, which uses no framework: the port
keeps its own so that it never imports the JAX package).

The health layer (runtime/flight.py) answers "is this process alive
and able to serve"; this module answers "is it serving WELL ENOUGH" —
machine-checkable SLO rules evaluated against the history that
runtime/timeseries.py keeps, instead of eyeballed snapshots:

- :class:`AlertRule` — one declarative rule, loadable from an
  ``slo.json`` file. Four kinds:

  * ``latency`` — a latency percentile series (e.g.
    ``serving_ttft_s:interactive.p99``) vs its SLO target, judged
    over TWO windows (classic multi-window burn rate: the short
    window proves it's happening NOW, the long one proves it's not a
    blip). Fires only when every window's mean exceeds the target.
  * ``budget_burn`` — an error/shed budget: the rate
    ``delta(numerator) / delta(denominator)`` over each window vs
    ``budget_frac x burn_factor`` (burn_factor 10 = "burning a
    30-day budget in 3 days" pace).
  * ``threshold`` — a plain gauge ceiling over one window
    (HOST-BOUND on ``host_gap_frac``, KV-PRESSURE on pool
    occupancy).
  * ``staleness`` — a peer stopped reporting: last-seen age vs
    ``stale_after_s``. Evaluated fleet-side (the validator's
    FleetStore knows the ages); a node cannot observe its own death.

- :class:`AlertEngine` — edge-triggered evaluation: the fire edge
  records one ``alert_fired`` flight event (wall + monotonic
  timestamps, so it overlays the /history rings exactly) and sets a
  ``HealthState`` condition ``alert:<name>``; the clear edge records
  ``alert_cleared`` and clears it. ``active()`` is what ``/node`` and
  ``/fleet`` publish and what ``tldiag watch`` renders.

Both the node (its own metrics) and the validator (every peer's
heartbeat-delta rings, rule names suffixed ``@<node>``) run the same
engine. Dependency-free and importable without torch — ``tldiag check``
evaluates the identical rules client-side from scraped /history.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable

__all__ = [
    "AlertEngine",
    "AlertRule",
    "default_rules",
    "load_rules",
]

_KINDS = ("latency", "budget_burn", "threshold", "staleness")


@dataclass(frozen=True)
class AlertRule:
    """One SLO rule. ``windows_s`` are judged ALL-of (multi-window
    burn); a window with no data abstains — absence of evidence never
    fires a latency alert (staleness covers absence)."""

    name: str
    kind: str
    series: str = ""
    target: float = 0.0  # latency target / gauge ceiling, in the
    # series' own unit
    windows_s: tuple[float, ...] = (30.0, 120.0)
    numerator: str = ""  # budget_burn: counter series burning budget
    denominator: str = ""  # budget_burn: total-traffic counter
    budget_frac: float = 0.01
    burn_factor: float = 1.0
    stale_after_s: float = 10.0
    severity: str = "warn"  # flight-event severity on the fire edge

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"rule kind {self.kind!r} not in {_KINDS}")
        if not self.windows_s:
            raise ValueError(f"rule {self.name!r} needs >= 1 window")

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "kind": self.kind, "series": self.series,
            "target": self.target, "windows_s": list(self.windows_s),
            "numerator": self.numerator,
            "denominator": self.denominator,
            "budget_frac": self.budget_frac,
            "burn_factor": self.burn_factor,
            "stale_after_s": self.stale_after_s,
            "severity": self.severity,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        return cls(
            name=str(d["name"]),
            kind=str(d.get("kind", "threshold")),
            series=str(d.get("series", "")),
            target=float(d.get("target", 0.0)),
            windows_s=tuple(
                float(w) for w in d.get("windows_s", (30.0, 120.0))
            ),
            numerator=str(d.get("numerator", "")),
            denominator=str(d.get("denominator", "")),
            budget_frac=float(d.get("budget_frac", 0.01)),
            burn_factor=float(d.get("burn_factor", 1.0)),
            stale_after_s=float(d.get("stale_after_s", 10.0)),
            severity=str(d.get("severity", "warn")),
        )


def _mean(points: list) -> float | None:
    vals = [p[1] for p in points]
    return sum(vals) / len(vals) if vals else None


def _delta(points: list) -> float | None:
    """Cumulative-counter delta across a window; None below 2 points
    (one sample says nothing about a rate)."""
    if len(points) < 2:
        return None
    return points[-1][1] - points[0][1]


@dataclass
class _ruleval:
    firing: bool
    value: float | None
    detail: str


def evaluate_rule(
    rule: AlertRule, store: Any, now: float | None = None,
    stale_age_s: float | None = None,
) -> _ruleval:
    """One rule against one store (anything with
    ``window(name, seconds, now)``). ``stale_age_s`` feeds staleness
    rules — the caller knows the peer's last-seen age."""
    t = time.time() if now is None else now
    if rule.kind == "staleness":
        if stale_age_s is None:
            return _ruleval(False, None, "no age")
        firing = stale_age_s > rule.stale_after_s
        return _ruleval(
            firing, round(stale_age_s, 3),
            f"last seen {stale_age_s:.1f}s ago "
            f"(stale after {rule.stale_after_s:g}s)",
        )
    worst: float | None = None
    for w in rule.windows_s:
        if rule.kind == "budget_burn":
            num = _delta(store.window(rule.numerator, w, now=t))
            den = _delta(store.window(rule.denominator, w, now=t))
            if num is None or den is None or den <= 0:
                return _ruleval(False, worst, f"no data in {w:g}s window")
            v = num / den
            limit = rule.budget_frac * rule.burn_factor
        else:  # latency / threshold: windowed mean vs ceiling
            v = _mean(store.window(rule.series, w, now=t))
            if v is None or math.isnan(v):
                return _ruleval(False, worst, f"no data in {w:g}s window")
            limit = rule.target
        if worst is None or v > worst:
            worst = v
        if v <= limit:
            return _ruleval(
                False, worst, f"{v:.4g} <= {limit:.4g} over {w:g}s"
            )
    limit = (
        rule.budget_frac * rule.burn_factor
        if rule.kind == "budget_burn" else rule.target
    )
    return _ruleval(
        True, worst,
        f"{worst:.4g} > {limit:.4g} over all of "
        f"{'/'.join(f'{w:g}s' for w in rule.windows_s)}",
    )


class AlertEngine:
    """Edge-triggered rule evaluation with a live active-alert table.

    ``health`` (optional): firing alerts set ``alert:<name>``
    conditions — the node's /healthz goes 503 while an SLO burns,
    which is exactly what an external LB should see. The validator's
    fleet engine passes ``health=None``: a peer's burn must not mark
    the validator itself unready.
    """

    def __init__(
        self,
        rules: Iterable[AlertRule] = (),
        recorder: Any = None,
        health: Any = None,
        metrics: Any = None,
    ):
        self.rules = list(rules)
        self.recorder = recorder
        self.health = health
        self.metrics = metrics
        self._active: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- state
    def active(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self._active.values()]

    def _transition(
        self, name: str, rule: AlertRule, res: _ruleval, now: float,
    ) -> None:
        with self._lock:
            was = name in self._active
            if res.firing:
                rec = self._active.get(name)
                if rec is None:
                    rec = self._active[name] = {
                        "name": name,
                        "rule": rule.name,
                        "kind": rule.kind,
                        "severity": rule.severity,
                        "since": round(now, 3),
                    }
                rec["value"] = res.value
                rec["detail"] = res.detail
            else:
                self._active.pop(name, None)
        if res.firing and not was:
            if self.metrics is not None:
                self.metrics.incr("alerts_fired_total")
            if self.recorder is not None:
                # the event carries wall + monotonic stamps (flight.py
                # Event), so the fire edge lands exactly on the
                # /history buckets that triggered it
                self.recorder.record(
                    "alert_fired", rule.severity, alert=name,
                    rule_kind=rule.kind, value=res.value,
                    detail=res.detail,
                )
            if self.health is not None:
                self.health.set_condition(f"alert:{name}", res.detail)
        elif was and not res.firing:
            if self.recorder is not None:
                self.recorder.record(
                    "alert_cleared", "info", alert=name,
                    rule_kind=rule.kind,
                )
            if self.health is not None:
                self.health.clear_condition(f"alert:{name}")

    # ------------------------------------------------------- evaluation
    def evaluate(
        self, store: Any, now: float | None = None, suffix: str = "",
    ) -> list[dict[str, Any]]:
        """All non-staleness rules against one store. ``suffix`` scopes
        alert names (the validator appends ``@<node>``)."""
        t = time.time() if now is None else now
        for rule in self.rules:
            if rule.kind == "staleness":
                continue
            res = evaluate_rule(rule, store, now=t)
            self._transition(rule.name + suffix, rule, res, t)
        return self.active()

    def evaluate_fleet(
        self, fleet: Any, now: float | None = None,
    ) -> list[dict[str, Any]]:
        """Every rule against every node in a FleetStore: staleness
        from last-seen ages, series rules against each node's ingested
        rings, names suffixed ``@<node>``."""
        t = time.time() if now is None else now
        for node_id in fleet.nodes():
            age = fleet.last_seen_age(node_id, now=t)
            store = fleet.node_store(node_id)
            for rule in self.rules:
                if rule.kind == "staleness":
                    res = evaluate_rule(rule, None, now=t, stale_age_s=age)
                elif store is not None:
                    res = evaluate_rule(rule, store, now=t)
                else:
                    continue
                self._transition(f"{rule.name}@{node_id}", rule, res, t)
        return self.active()


# ------------------------------------------------------------ rule files
def default_rules(slo: dict | None = None) -> list[AlertRule]:
    """The standard rule set from a compact SLO dict::

        {"ttft_p99_s": {"interactive": 0.5},   # per-class targets,
         "tpot_p99_s": {"interactive": 0.1},   # or a bare float for
         "windows_s": [30, 120],               # the overall histogram
         "shed_budget_frac": 0.01,
         "receipt_anomaly_frac": 0.01,
         "host_gap_frac": 0.3,
         "kv_used_frac": 0.9,
         "heartbeat_stale_s": 10}

    Latency series names follow the sampler's convention:
    ``serving_ttft_s:<class>.p99`` (``serving_ttft_s.p99`` for the
    all-traffic histogram)."""
    slo = slo or {}
    windows = tuple(float(w) for w in slo.get("windows_s", (30.0, 120.0)))
    rules: list[AlertRule] = []

    def latency(metric: str, label: str, spec: Any) -> None:
        targets = spec if isinstance(spec, dict) else {"": spec}
        for cls, target in targets.items():
            series = f"{metric}:{cls}.p99" if cls else f"{metric}.p99"
            name = f"{label}-burn:{cls}" if cls else f"{label}-burn"
            rules.append(AlertRule(
                name=name, kind="latency", series=series,
                target=float(target), windows_s=windows,
                severity="error",
            ))

    if "ttft_p99_s" in slo:
        latency("serving_ttft_s", "ttft", slo["ttft_p99_s"])
    if "tpot_p99_s" in slo:
        latency("serving_tpot_s", "tpot", slo["tpot_p99_s"])
    if "shed_budget_frac" in slo:
        rules.append(AlertRule(
            name="shed-burn", kind="budget_burn",
            numerator="serving_shed_total",
            denominator="serving_requests_total",
            budget_frac=float(slo["shed_budget_frac"]),
            burn_factor=float(slo.get("burn_factor", 10.0)),
            windows_s=windows, severity="error",
        ))
    rules.append(AlertRule(
        name="receipt-anomaly-burn", kind="budget_burn",
        numerator="receipt_anomaly_total",
        denominator="receipt_accepted_total",
        budget_frac=float(slo.get("receipt_anomaly_frac", 0.01)),
        burn_factor=float(slo.get("burn_factor", 10.0)),
        windows_s=windows, severity="error",
    ))
    rules.append(AlertRule(
        name="host-bound", kind="threshold", series="host_gap_frac",
        target=float(slo.get("host_gap_frac", 0.3)),
        windows_s=windows[:1],
    ))
    rules.append(AlertRule(
        name="kv-pressure", kind="threshold",
        series="kv_pool_utilization",
        target=float(slo.get("kv_used_frac", 0.9)),
        windows_s=windows[:1],
    ))
    rules.append(AlertRule(
        name="heartbeat-stale", kind="staleness",
        stale_after_s=float(slo.get("heartbeat_stale_s", 10.0)),
        severity="error",
    ))
    return rules


def load_rules(src: str | dict) -> list[AlertRule]:
    """Rules from an ``slo.json`` path or an already-parsed dict.
    Accepts the explicit form (``{"rules": [{...}, ...]}``) and the
    compact SLO form :func:`default_rules` expands; a file may carry
    both (explicit rules append to the expanded defaults)."""
    if isinstance(src, str):
        with open(src) as f:
            src = json.load(f)
    if not isinstance(src, dict):
        raise ValueError("slo spec must be a JSON object")
    compact = {k: v for k, v in src.items() if k != "rules"}
    rules = default_rules(compact) if compact else []
    for d in src.get("rules", []):
        rules.append(AlertRule.from_dict(d))
    return rules
