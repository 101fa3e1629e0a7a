"""Deterministic fault injection (a copy of
``tensorlink_tpu/runtime/chaos.py``, which imports no framework; copied,
not imported, so the port stands alone).

A :class:`ChaosPlan` is a seeded script of faults keyed by SITE — a named
hook point in real code — and the Nth invocation of that site. The port's
hook points are in the serving scheduler (``parallel/serving.py``):
``serving.dispatch`` before each decode or spec chunk is launched (before
the graph replay, never inside a captured body) and ``serving.drain`` at
the top of each drain (slow the dispatch or drain path: the in-process
stand-in for a worker stalling mid-decode). Anything can host one by
calling :func:`fire`.

- **Zero overhead disarmed.** Every hook is guarded by
  ``chaos.ACTIVE is not None``: one module-global read, no branch taken,
  no RNG consulted, no lock acquired when no plan is armed.
- **Deterministic.** Faults trigger on invocation COUNTS (``at`` /
  ``every``), never on wall clocks, and all jitter comes from the
  plan-seeded RNG: the same plan and seed against the same call sequence
  give the same :attr:`ChaosHarness.log`, byte for byte (and the same
  log as the reference's harness).
- **Actions are dumb.** ``delay``/``slow`` sleep, ``drop`` tells the hook
  to lose the work, ``kill`` invokes a handler the scenario registered.
  ``recorder=`` / ``metrics=`` are optional duck-typed sinks (anything
  with ``record(kind, severity, **data)`` / ``incr(name)``).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = [
    "ACTIVE",
    "ChaosHarness",
    "ChaosPlan",
    "Fault",
    "arm",
    "disarm",
    "fire",
]

_ACTIONS = ("drop", "delay", "slow", "kill")


@dataclass(frozen=True)
class Fault:
    """One scripted fault.

    ``site``: hook-point name (``p2p.send``, ``serving.dispatch``, or
    any site a scenario fires). ``action``: what happens there.
    ``at``: fire on exactly the Nth invocation of the site (1-based);
    ``every``: fire on every Nth instead. ``count`` bounds total
    firings (None = unbounded for ``every``, 1 for ``at``).
    ``delay_s`` (+ seeded ``jitter_s``) applies to delay/slow.
    ``match`` filters on the hook's context kwargs (e.g.
    ``{"type": "DHT_QUERY"}`` drops only those frames); a match key
    the hook did not pass never matches. ``handler`` names the
    scenario-registered callable a ``kill`` invokes."""

    site: str
    action: str
    at: int | None = None
    every: int | None = None
    count: int | None = None
    delay_s: float = 0.0
    jitter_s: float = 0.0
    match: tuple[tuple[str, Any], ...] = ()
    handler: str = "kill"

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(
                f"action {self.action!r} not in {_ACTIONS}"
            )
        if (self.at is None) == (self.every is None):
            raise ValueError(
                f"fault at site {self.site!r} needs exactly one of "
                "at=/every="
            )

    def due(self, n: int) -> bool:
        if self.at is not None:
            return n == self.at
        return self.every > 0 and n % self.every == 0

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match)


@dataclass
class ChaosPlan:
    """A seeded list of faults — the unit a test commits / replays."""

    seed: int = 0
    faults: list[Fault] = field(default_factory=list)

    def fault(self, site: str, action: str, **kw) -> "ChaosPlan":
        """Add one fault; returns the plan, so calls chain:
        ``plan.fault("p2p.send", "drop", at=3)``."""
        match = tuple(sorted((kw.pop("match", None) or {}).items()))
        self.faults.append(Fault(site, action, match=match, **kw))
        return self

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "faults": [
                {
                    "site": f.site, "action": f.action, "at": f.at,
                    "every": f.every, "count": f.count,
                    "delay_s": f.delay_s, "jitter_s": f.jitter_s,
                    "match": dict(f.match), "handler": f.handler,
                }
                for f in self.faults
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosPlan":
        plan = cls(seed=int(d.get("seed", 0)))
        for f in d.get("faults", []):
            plan.fault(
                str(f["site"]), str(f["action"]), at=f.get("at"),
                every=f.get("every"), count=f.get("count"),
                delay_s=float(f.get("delay_s", 0.0)),
                jitter_s=float(f.get("jitter_s", 0.0)),
                match=f.get("match"), handler=str(f.get("handler", "kill")),
            )
        return plan


class ChaosHarness:
    """An armed plan: per-site invocation counters, the seeded RNG, the
    deterministic firing log, and the scenario's kill handlers. Thread-
    safe — serving pumps fire from worker threads while p2p hooks fire
    on event loops."""

    def __init__(self, plan: ChaosPlan, recorder=None, metrics=None):
        self.plan = plan
        self.recorder = recorder
        self.metrics = metrics
        self._rng = random.Random(plan.seed)
        self._counts: dict[str, int] = {}
        self._fired: dict[int, int] = {}  # fault index -> firings
        self._handlers: dict[str, Callable[..., Any]] = {}
        self._lock = threading.Lock()
        # (site, invocation_n, action) tuples in firing order — the
        # sequence the determinism test compares across runs
        self.log: list[tuple[str, int, str]] = []

    def on_kill(self, name: str, handler: Callable[..., Any]) -> None:
        """Register the callable a ``kill`` fault's ``handler`` names
        (the scenario owns WHAT dies; the plan owns WHEN)."""
        self._handlers[name] = handler

    def actions(self, site: str, **ctx) -> list[dict]:
        """Advance ``site``'s counter by one invocation and return the
        actions due NOW (empty almost always). Jitter is drawn from
        the plan RNG inside the lock, so the draw sequence — hence the
        log — is a pure function of (plan, call sequence)."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            due: list[dict] = []
            for i, f in enumerate(self.plan.faults):
                if f.site != site or not f.due(n) or not f.matches(ctx):
                    continue
                cap = f.count if f.count is not None else (
                    1 if f.at is not None else None
                )
                if cap is not None and self._fired.get(i, 0) >= cap:
                    continue
                self._fired[i] = self._fired.get(i, 0) + 1
                delay = f.delay_s
                if f.jitter_s:
                    delay += self._rng.random() * f.jitter_s
                due.append(
                    {"action": f.action, "delay_s": delay,
                     "handler": f.handler}
                )
                self.log.append((site, n, f.action))
        for a in due:
            self._record(site, n, a, ctx)
            if a["action"] == "kill":
                h = self._handlers.get(a["handler"])
                if h is not None:
                    h(site=site, n=n, **ctx)
        return due

    def apply_sync(self, site: str, **ctx) -> bool:
        """Fire + apply from synchronous code (serving pump threads):
        sleeps out delay/slow actions, runs kill handlers, returns True
        when a ``drop`` is due (the caller loses the work)."""
        drop = False
        for a in self.actions(site, **ctx):
            if a["action"] in ("delay", "slow") and a["delay_s"] > 0:
                time.sleep(a["delay_s"])
            drop = drop or a["action"] == "drop"
        return drop

    def _record(self, site: str, n: int, act: dict, ctx: dict) -> None:
        if self.metrics is not None:
            self.metrics.incr("chaos_faults_total")
        if self.recorder is not None:
            try:
                self.recorder.record(
                    f"chaos.{act['action']}", "warn", site=site, n=n,
                    delay_s=round(act["delay_s"], 4),
                    **{k: v for k, v in ctx.items()
                       if isinstance(v, (str, int, float, bool))},
                )
            except Exception:  # noqa: BLE001 — chaos must not add real faults
                pass

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


# The one module-global every hook checks. Not a function on purpose:
# ``chaos.ACTIVE is not None`` from the hot path is a dict lookup + an
# identity test, with no call frame.
ACTIVE: ChaosHarness | None = None


def arm(
    plan: ChaosPlan, recorder=None, metrics=None
) -> ChaosHarness:
    """Install ``plan`` as the process-wide active harness."""
    global ACTIVE
    ACTIVE = ChaosHarness(plan, recorder=recorder, metrics=metrics)
    return ACTIVE


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def fire(site: str, **ctx) -> list[dict]:
    """Convenience hook for sites without the inline guard. Returns the
    due actions ([] when disarmed)."""
    h = ACTIVE
    return h.actions(site, **ctx) if h is not None else []
