"""Flight recorder + health sentinels — the black-box layer (a copy of
``tensorlink_tpu/runtime/flight.py``: the port keeps its own so that it
never imports the JAX package; the HBM watermarks read
``runtime/mesh.local_device_info`` once CUDA is initialized, and
``versions()`` reports torch and CUDA).

PR-1's tracing/metrics observe *healthy* runs: spans need an open
context, rolling series evict, and nothing survives the process. This
module answers "what was the node doing when things went wrong":

- :class:`FlightRecorder` — a bounded ring of structured events (peer
  join/drop, job state transitions, watchdog trips, checkpoint writes,
  anomalies). Every node carries one (served at ``GET /events``); code
  with no node at hand (the Trainer, crash handlers) uses the
  process-wide :func:`default_recorder`.
- :class:`Watchdog` / :class:`HealthState` — liveness deadlines (no
  train step, no peer traffic) and explicit readiness conditions (a
  placed stage's worker died), plus event-loop lag; the StatusServer's
  ``/healthz`` turns this into a truthful 200/503.
- :func:`write_postmortem` / :func:`install_crash_handler` — on an
  unhandled crash or signal, dump one JSON bundle: events + last spans
  + metrics snapshot + config + py/torch versions. ``tldiag``
  (the reference's diag.py) collects the live-node equivalents over HTTP.

Dependency-free and importable without torch (memory watermarks consult
torch only when it is already loaded and CUDA initialized), same as
runtime/tracing.py.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable


@dataclass
class Event:
    """One recorded occurrence. ``seq`` is a process-wide monotonic id so
    consumers (``/events?since=``, tldiag merges) can order and dedupe
    events across scrapes without trusting wall clocks. ``ts`` is the
    wall clock; ``mono`` is ``time.monotonic()`` at record time, so a
    consumer holding one (wall, mono) pair from ANY event can place
    every other event, span, and monotonic-stamped timeline (device
    time, alert windows) on a single shared axis — wall clocks alone
    can step backwards under NTP and misorder a timeline."""

    kind: str
    severity: str = "info"  # info | warn | error
    ts: float = 0.0
    mono: float = 0.0
    seq: int = 0
    attrs: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "ts": self.ts,
            "mono": self.mono,
            "seq": self.seq,
            "attrs": self.attrs,
        }


_seq = itertools.count(1)  # shared across recorders: one process timeline

SEVERITIES = ("info", "warn", "error")


class FlightRecorder:
    """Bounded ring buffer of :class:`Event` (oldest evicted), safe to
    record from worker threads and asyncio handlers alike."""

    def __init__(self, service: str = "proc", max_events: int = 2048):
        self.service = service
        self.max_events = max_events
        self._events: deque[Event] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self.counts: dict[str, int] = {}  # kind -> total recorded (no evict)

    def record(self, kind: str, severity: str = "info", **attrs: Any) -> Event:
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r} not in {SEVERITIES}")
        ev = Event(
            kind=kind,
            severity=severity,
            ts=time.time(),
            mono=time.monotonic(),
            seq=next(_seq),
            # default=str at read time would lose structure; stringify
            # non-JSON values NOW so a poisoned attr can never make the
            # /events route (or a post-mortem dump) raise
            attrs={k: _jsonable(v) for k, v in attrs.items()},
        )
        with self._lock:
            self._events.append(ev)
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return ev

    def events(
        self,
        kind: str | None = None,
        min_severity: str | None = None,
        since: int | None = None,
        limit: int | None = None,
    ) -> list[dict[str, Any]]:
        """Events as dicts, oldest first. ``since`` filters by seq
        (exclusive), ``limit`` keeps the NEWEST n after filtering."""
        with self._lock:
            evs: Iterable[Event] = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if min_severity is not None:
            floor = SEVERITIES.index(min_severity)
            evs = [e for e in evs if SEVERITIES.index(e.severity) >= floor]
        if since is not None:
            evs = [e for e in evs if e.seq > since]
        out = [e.to_dict() for e in evs]
        return out[-limit:] if limit else out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x) for x in v]
    return str(v)


_default: FlightRecorder | None = None
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder:
    """The process-wide recorder, created lazily. Node-less code (the
    Trainer, checkpoint writers, crash handlers) records here; nodes
    carry their own so each ``/events`` serves its own timeline."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder(service=f"proc:{os.getpid()}")
        return _default


# ------------------------------------------------------------- watchdogs
class Watchdog:
    """Deadline on recurring activity: :meth:`kick` on every occurrence;
    if no kick lands within ``deadline_s`` the dog trips — one
    ``watchdog_trip`` event (not one per check) and an unhealthy reason
    until the next kick re-arms it. ``armed=False`` dogs are ignored, so
    a job-step watchdog can exist before the first step without tripping
    an idle node."""

    def __init__(
        self,
        name: str,
        deadline_s: float,
        recorder: FlightRecorder | None = None,
        armed: bool = True,
    ):
        self.name = name
        self.deadline_s = float(deadline_s)
        self.recorder = recorder
        self.armed = armed
        self.tripped = False
        self._last = time.monotonic()

    @property
    def age_s(self) -> float:
        return time.monotonic() - self._last

    def arm(self) -> None:
        """(Re)start the deadline from now."""
        self._last = time.monotonic()
        self.armed = True
        self.tripped = False

    def disarm(self) -> None:
        self.armed = False
        self.tripped = False

    def kick(self) -> None:
        self._last = time.monotonic()
        if self.tripped:
            self.tripped = False
            if self.recorder is not None:
                self.recorder.record(
                    "watchdog_recovered", "info", watchdog=self.name
                )

    def check(self) -> bool:
        """True while healthy. Records the trip event on the healthy ->
        tripped edge only."""
        if not self.armed:
            return True
        if self.age_s <= self.deadline_s:
            return False if self.tripped else True
        if not self.tripped:
            self.tripped = True
            if self.recorder is not None:
                self.recorder.record(
                    "watchdog_trip",
                    "error",
                    watchdog=self.name,
                    deadline_s=self.deadline_s,
                    age_s=round(self.age_s, 3),
                )
        return False


class HealthState:
    """A node's liveness + readiness, computed — not asserted.

    Three inputs: watchdogs (recurring activity missed its deadline),
    conditions (explicit degradations set/cleared by role code, e.g.
    "stage 1's worker is dead"), and event-loop lag (a starved loop
    can't serve heartbeats even though the process is alive).
    :meth:`report` is what ``/healthz`` serves; ``ok=False`` -> 503.
    """

    LOOP_LAG_UNHEALTHY_S = 1.0

    def __init__(self, recorder: FlightRecorder | None = None):
        self.recorder = recorder
        self.watchdogs: dict[str, Watchdog] = {}
        self.conditions: dict[str, str] = {}  # name -> human reason
        self.loop_lag_s = 0.0
        self._lock = threading.Lock()

    def watchdog(
        self, name: str, deadline_s: float, armed: bool = True
    ) -> Watchdog:
        """Get-or-create; an existing dog keeps its state but adopts the
        new deadline (callers shorten deadlines in tests)."""
        with self._lock:
            dog = self.watchdogs.get(name)
            if dog is None:
                dog = self.watchdogs[name] = Watchdog(
                    name, deadline_s, self.recorder, armed=armed
                )
            else:
                dog.deadline_s = float(deadline_s)
            return dog

    def remove_watchdog(self, name: str) -> None:
        """Retire a dog for good (e.g. its job shut down) — disarming
        alone would leave one dead entry per historical job in every
        /healthz payload and every health-loop tick, forever."""
        with self._lock:
            self.watchdogs.pop(name, None)

    def set_condition(self, name: str, reason: str) -> None:
        with self._lock:
            fresh = name not in self.conditions
            self.conditions[name] = reason
        if fresh and self.recorder is not None:
            self.recorder.record(
                "health_degraded", "error", condition=name, reason=reason
            )

    def clear_condition(self, name: str) -> None:
        with self._lock:
            had = self.conditions.pop(name, None)
        if had is not None and self.recorder is not None:
            self.recorder.record("health_restored", "info", condition=name)

    def clear_conditions(self, prefix: str) -> None:
        with self._lock:
            names = [n for n in self.conditions if n.startswith(prefix)]
        for n in names:
            self.clear_condition(n)

    def note_loop_lag(self, lag_s: float) -> None:
        self.loop_lag_s = float(lag_s)

    def check_watchdogs(self) -> None:
        """Drive trip-edge detection (called by the node's health loop;
        report() also checks, so a scrape between loop ticks is exact)."""
        with self._lock:
            dogs = list(self.watchdogs.values())
        for dog in dogs:
            dog.check()

    def report(self) -> dict[str, Any]:
        with self._lock:
            dogs = list(self.watchdogs.values())
            conditions = dict(self.conditions)
        reasons: dict[str, str] = {}
        dog_view: dict[str, Any] = {}
        for dog in dogs:
            healthy = dog.check()
            dog_view[dog.name] = {
                "armed": dog.armed,
                "age_s": round(dog.age_s, 3),
                "deadline_s": dog.deadline_s,
                "ok": healthy,
            }
            if not healthy:
                reasons[f"watchdog:{dog.name}"] = (
                    f"no activity for {dog.age_s:.1f}s "
                    f"(deadline {dog.deadline_s:.1f}s)"
                )
        for name, why in conditions.items():
            reasons[f"condition:{name}"] = why
        if self.loop_lag_s > self.LOOP_LAG_UNHEALTHY_S:
            reasons["event_loop_lag"] = (
                f"event loop lagging {self.loop_lag_s:.2f}s"
            )
        ok = not reasons
        return {
            "ok": ok,
            "live": True,  # we computed this -> the process answers
            "ready": ok,
            "reasons": reasons,
            "watchdogs": dog_view,
            "conditions": conditions,
            "event_loop_lag_s": round(self.loop_lag_s, 4),
        }


# ----------------------------------------------------- memory watermarks
def host_memory_info() -> dict[str, int] | None:
    """(total, available) host bytes via psutil or /proc/meminfo; None
    when neither source exists (exotic platforms)."""
    try:
        import psutil

        vm = psutil.virtual_memory()
        return {"total": int(vm.total), "available": int(vm.available)}
    except ImportError:
        pass
    try:
        info: dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                if k in ("MemTotal", "MemAvailable"):
                    info[k] = int(rest.split()[0]) * 1024
        if "MemTotal" in info and "MemAvailable" in info:
            return {
                "total": info["MemTotal"],
                "available": info["MemAvailable"],
            }
    except OSError:
        pass
    return None


def sample_memory_watermarks(metrics: Any) -> dict[str, float]:
    """Host RAM + accelerator HBM watermark gauges, observed into
    ``metrics`` (rolling series -> min/max in snapshots are the
    watermarks; Prometheus gauges via ?format=prom). The card is
    consulted only when torch is ALREADY imported and CUDA initialized —
    a control-plane node must not pay a CUDA context for a memory
    gauge."""
    out: dict[str, float] = {}
    host = host_memory_info()
    if host is not None:
        out["host_mem_available_bytes"] = float(host["available"])
        out["host_mem_used_frac"] = 1.0 - host["available"] / max(
            host["total"], 1
        )
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        try:
            from tensorlink_tpu_torch.runtime.mesh import local_device_info

            limit = in_use = 0
            for d in local_device_info():
                limit += d.get("bytes_limit") or 0
                in_use += d.get("bytes_in_use") or 0
            if limit:
                out["hbm_in_use_bytes"] = float(in_use)
                out["hbm_used_frac"] = in_use / limit
        except Exception:  # noqa: BLE001 — gauges must never break a node
            pass
    if metrics is not None:
        for name, val in out.items():
            metrics.observe(name, val)
    return out


# --------------------------------------------------------- post-mortem
def versions() -> dict[str, str]:
    out = {"python": sys.version.split()[0]}
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch"] = getattr(torch, "__version__", "?")
        out["cuda"] = str(torch.version.cuda)
        try:
            out["cuda_device"] = (torch.cuda.get_device_name(0)
                                  if torch.cuda.is_available() else "none")
        except Exception:  # noqa: BLE001 — the card may be unreachable,
            # which is exactly when a post-mortem gets written
            out["cuda_device"] = "unavailable"
    return out


def write_postmortem(
    path: str,
    reason: str,
    recorder: FlightRecorder | None = None,
    tracer: Any = None,
    metrics: Any = None,
    config: Any = None,
    exc: BaseException | None = None,
    max_spans: int = 256,
    timeseries: Any = None,
    timeseries_last_s: float | None = 600.0,
) -> str:
    """Dump the black box to ``path`` (atomic write): events + last
    spans + metrics snapshot + the last minutes of the time-series
    rings + config + versions. Every section is best-effort — a
    half-written bundle from a dying process beats an exception in the
    crash handler. Returns the path written."""
    recorder = recorder or default_recorder()
    bundle: dict[str, Any] = {
        "reason": reason,
        "at": time.time(),
        # the (wall, mono) anchor pair: maps every Event.mono in this
        # bundle onto the wall-clock axis the time-series rings use
        "at_mono": time.monotonic(),
        "pid": os.getpid(),
        "service": recorder.service,
        "versions": versions(),
    }
    if exc is not None:
        bundle["exception"] = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
    try:
        bundle["events"] = recorder.events()
        bundle["event_counts"] = dict(recorder.counts)
    except Exception as e:  # noqa: BLE001
        bundle["events_error"] = str(e)
    if tracer is not None:
        try:
            bundle["spans"] = [s.to_dict() for s in tracer.spans()[-max_spans:]]
        except Exception as e:  # noqa: BLE001
            bundle["spans_error"] = str(e)
    if metrics is not None:
        try:
            bundle["metrics"] = metrics.snapshot()
        except Exception as e:  # noqa: BLE001
            bundle["metrics_error"] = str(e)
    if timeseries is not None:
        try:
            # the minutes BEFORE the crash — what a snapshot can't show
            bundle["timeseries"] = timeseries.snapshot(
                last_s=timeseries_last_s
            )
        except Exception as e:  # noqa: BLE001
            bundle["timeseries_error"] = str(e)
    if config is not None:
        try:
            cfg = config.to_dict() if hasattr(config, "to_dict") else config
            if not isinstance(cfg, dict):
                import dataclasses

                cfg = (
                    dataclasses.asdict(config)
                    if dataclasses.is_dataclass(config)
                    else {"repr": repr(config)}
                )
            bundle["config"] = cfg
        except Exception as e:  # noqa: BLE001
            bundle["config_error"] = str(e)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, default=str)
    os.replace(tmp, path)
    return path


def install_crash_handler(
    directory: str,
    recorder: FlightRecorder | None = None,
    tracer: Any = None,
    metrics: Any = None,
    config: Any = None,
    signals: tuple[int, ...] | None = None,
    timeseries: Any = None,
):
    """Arm the post-mortem dump: an unhandled exception (sys.excepthook)
    or a termination signal (SIGTERM by default; pass ``signals=()`` to
    skip signal handling, e.g. under a test runner) writes
    ``postmortem-<pid>-<ts>.json`` into ``directory`` before the
    previous hook/handler runs. Returns an ``uninstall()`` callable.
    """
    import signal as _signal

    os.makedirs(directory, exist_ok=True)
    if signals is None:
        signals = (_signal.SIGTERM,)

    def dump(reason: str, exc: BaseException | None = None) -> None:
        path = os.path.join(
            directory, f"postmortem-{os.getpid()}-{int(time.time())}.json"
        )
        try:
            write_postmortem(
                path, reason, recorder=recorder, tracer=tracer,
                metrics=metrics, config=config, exc=exc,
                timeseries=timeseries,
            )
            print(f"post-mortem bundle written: {path}", file=sys.stderr)  # noqa: T201
        except Exception:  # noqa: BLE001 — the crash path must not crash
            pass

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        dump(f"unhandled {exc_type.__name__}", exc=exc)
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook

    prev_sig: dict[int, Any] = {}
    for sig in signals:
        try:
            prev_sig[sig] = _signal.getsignal(sig)

            def handler(signum, frame, _prev=prev_sig[sig]):
                dump(f"signal {signum}")
                # restore + re-raise so the default disposition (or the
                # app's own handler) still terminates the process
                _signal.signal(signum, _prev or _signal.SIG_DFL)
                _signal.raise_signal(signum)

            _signal.signal(sig, handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            prev_sig.pop(sig, None)

    def uninstall() -> None:
        if sys.excepthook is hook:
            sys.excepthook = prev_hook
        for sig, prev in prev_sig.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    return uninstall
