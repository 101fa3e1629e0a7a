"""Profiling on ``torch.profiler`` (the capture half of
``tensorlink_tpu/runtime/profiling.py``), device timing (its
``DispatchTimer`` and ``measure_capability`` parts) and a per-dispatch
cost model.

- offline: :func:`trace` captures the enclosed region (CPU ops and, on
  CUDA, the kernels CUPTI sees) into a Chrome trace under ``log_dir``,
  :func:`step_trace` names a sub-span (``record_function``), and
  :func:`op_breakdown` runs a function under a capture and returns
  :func:`parse_op_breakdown`: device time by kernel-name family
  (``KERNEL_FAMILIES``: the four hand kernels B1-B4 by their CUDA
  function names, cuBLAS GEMMs, the foreach optimizer, reductions,
  elementwise, copies; first match wins, the rest "other"). A CPU
  capture holds no device events, so its breakdown is empty, as the
  reference's is off the TPU;
- on-demand: :func:`timed_capture` records ``ms`` milliseconds of
  whatever the process is doing (CUPTI sees every thread's kernels) and
  serves ``GET /profile?ms=N`` (``runtime/http_status.py``); one capture
  at a time, a second is refused with :class:`ProfileBusyError`;
- :func:`roofline` is the two-wall arithmetic on the peaks the caller
  gives (the port states no card's peaks here); :class:`Stopwatch` stops
  after a host read of a result.
- :class:`DispatchTimer` attributes each dispatched program's time into
  device-busy and host-gap with no added synchronization, with the
  reference's API and arithmetic (FIFO finalization, ``busy``/``gap``,
  EWMA, ``MAX_PROGRAMS``, ``snapshot``). On CUDA the probe is a pair of
  timing events recorded just before and just after the dispatch (never
  inside a captured graph): busy is ``start.elapsed_time(end)``, the gap
  ``prev_end.elapsed_time(start)`` clamped at 0, and a dispatch is ready
  when its end event's ``query()`` says so. Without events (CPU tensors)
  it keeps the reference's host clock.
- :func:`measure_capability`: a chained bf16 matmul and an HBM read,
  timed on the card with CUDA events: the peaks per-program MFU and MBU
  are computed against.
- :func:`program_cost`: flops and HBM bytes of one prefill chunk, decode
  chunk or speculative chunk, counted from the model config and the
  dispatch's host-known shape. The port has no XLA ``cost_analysis()``,
  so the engines compute this at each dispatch and it rides the
  dispatch handle.

With ``metrics=`` the timer emits the reference's per-program series
(``dev_<program>_busy_s`` histogram, ``dev_<program>_gap_s`` gauge), and
with ``recorder=`` ``measure_capability`` records the reference's
``capability.measured`` event.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Iterator, Sequence

import torch

from tensorlink_tpu_torch.nn.moe import expert_capacity
from tensorlink_tpu_torch.utils.trees import tree_leaves


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> str:
    """Write ``prof``'s Chrome trace to a new timestamped directory under
    ``log_dir`` (as each reference capture writes one) -> its path."""
    d = tempfile.mkdtemp(prefix=time.strftime("%Y_%m_%d_%H_%M_%S_"), dir=log_dir)
    path = os.path.join(d, "trace.json.gz")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[str]:
    """Capture the enclosed region with ``torch.profiler`` into a Chrome
    trace under ``log_dir`` (default: ``tensorlink_tpu_torch_trace`` in
    the temporary directory); open it in Perfetto or chrome://tracing."""
    from torch.profiler import profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "tensorlink_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield log_dir
    _export(prof, log_dir)


@contextlib.contextmanager
def step_trace(name: str) -> Iterator[None]:
    """Named sub-span inside an active trace (shows up on the timeline)."""
    with torch.profiler.record_function(name):
        yield


def roofline(
    *,
    flops_per_step: float,
    hbm_bytes_per_step: float,
    peak_tflops: float,
    hbm_gbps: float,
    measured_step_s: float | None = None,
) -> dict:
    """Two-line roofline: which wall does this program lean on?

    ``hbm_bytes_per_step`` is the program's main-memory traffic (an
    analytic params + activations + optimizer estimate, or
    ``program_cost``'s bytes); the peaks are the caller's (the card's
    datasheet, or ``measure_capability``). Returns the compute-bound and
    bandwidth-bound time floors, the arithmetic intensity against the
    machine's ridge point, and, when a measured step time is given, the
    fraction of the BINDING floor achieved."""
    t_compute = flops_per_step / (peak_tflops * 1e12)
    t_memory = hbm_bytes_per_step / (hbm_gbps * 1e9)
    intensity = flops_per_step / max(hbm_bytes_per_step, 1.0)
    ridge = peak_tflops * 1e12 / (hbm_gbps * 1e9)  # FLOP/byte at the knee
    floor = max(t_compute, t_memory)
    out = {
        "t_compute_floor_s": t_compute,
        "t_memory_floor_s": t_memory,
        "arithmetic_intensity_flop_per_byte": intensity,
        "ridge_flop_per_byte": ridge,
        "bound": "compute" if t_compute >= t_memory else "memory",
        # the MFU ceiling the floors imply — independent of any
        # measurement, useful for pre-run planning
        "attainable_mfu_at_floor": flops_per_step / floor / (peak_tflops * 1e12),
    }
    if measured_step_s is not None:
        out["measured_step_s"] = measured_step_s
        out["fraction_of_binding_floor"] = floor / measured_step_s
    return out


def _host_read(tree) -> None:
    """Read one element of the first tensor of ``tree`` on the host: the
    device queue up to it has drained."""
    t = next((x for x in tree_leaves(tree) if torch.is_tensor(x)), None)
    if t is not None:
        t.reshape(-1)[0].item()


class Stopwatch:
    """Synchronized device timing: a host read of ``sync_array`` (any
    tree; its first tensor) before the clock stops."""

    def __init__(self):
        self.t0 = None
        self.elapsed_s = 0.0

    def start(self) -> "Stopwatch":
        self.t0 = time.perf_counter()
        return self

    def stop(self, sync_array=None) -> float:
        if sync_array is not None:
            _host_read(sync_array)
        self.elapsed_s = time.perf_counter() - self.t0
        return self.elapsed_s


# kernel-name families of a device breakdown (first match wins): the
# hand kernels by their CUDA function names (csrc/), then the library
KERNEL_FAMILIES = (
    ("flash_fwd (B1)", ("flash_fwd_kernel",)),
    ("flash_bwd (B2)", ("flash_bwd_",)),
    ("paged_decode (B3)", ("paged_mma_kernel", "paged_general_kernel",
                           "paged_merge_kernel")),
    ("fused_residual_norm (B4)", ("fused_norm_kernel",)),
    ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("embedding backward", ("indexing_backward", "embedding_backward")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# Kineto's device categories: kernels, copies and memsets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_family(name: str, category: str = "kernel") -> str:
    """The ``KERNEL_FAMILIES`` group of a device event's name; copies and
    memsets by their category."""
    if category != "kernel":
        return category
    return next((fam for fam, keys in KERNEL_FAMILIES
                 if any(k in name for k in keys)), "other")


def parse_op_breakdown(trace_events: list) -> dict:
    """Aggregate a Chrome-trace event list (the ``traceEvents`` of a
    ``torch.profiler`` export) into device time by kernel-name family
    (``kernel_family``), from Kineto's device events (complete events of
    a ``DEVICE_CATEGORIES`` category). A capture without device events
    (the CPU) gives an empty breakdown (``total_s == 0``).
    ``control_flow_wrapper_s`` is kept for the reference's shape: a
    kernel breakdown has no enclosing events."""
    cat = collections.Counter()
    nops = collections.Counter()
    for e in trace_events:
        c = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e or c not in DEVICE_CATEGORIES:
            continue
        fam = kernel_family(e.get("name", ""), c)
        cat[fam] += e["dur"]
        nops[fam] += 1
    total_us = sum(cat.values())
    return {
        "total_s": total_us / 1e6,
        "control_flow_wrapper_s": {},
        "categories": {
            c: {
                "s": d / 1e6,
                "fraction": (d / total_us) if total_us else 0.0,
                "ops": nops[c],
            }
            for c, d in cat.most_common()
        },
    }


def _newest_trace_events(d: str) -> list | None:
    """Event list of the NEWEST capture under ``d`` (by mtime: each
    capture writes a new timestamped subdirectory, and a reused
    ``log_dir`` holds older runs), or None when no trace file was
    produced."""
    traces = []
    for root, _, files in os.walk(d):
        for name in files:
            if name.endswith(("trace.json.gz", "trace.json")):
                p = os.path.join(root, name)
                traces.append((os.path.getmtime(p), p))
    if not traces:
        return None
    tj = max(traces)[1]
    opener = gzip.open if tj.endswith(".gz") else open
    with opener(tj, "rt") as f:
        return json.load(f)["traceEvents"]


def _no_trace(error: str) -> dict:
    return {"total_s": 0.0, "control_flow_wrapper_s": {}, "categories": {},
            "error": error}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def op_breakdown(fn, *args, log_dir: str | None = None) -> dict:
    """Run ``fn(*args)`` once under a fresh capture and return its
    ``parse_op_breakdown``. ``fn`` should be warm (a first call would
    profile the kernels' build). The device is synchronized inside the
    capture, so it spans the real device work."""
    from torch.profiler import profile

    own_dir = log_dir is None
    d = log_dir or tempfile.mkdtemp(prefix="tlt_profile_")
    try:
        os.makedirs(d, exist_ok=True)
        with profile(activities=_activities()) as prof:
            fn(*args)
            _sync()
        _export(prof, d)
        events = _newest_trace_events(d)
        if events is None:
            return _no_trace("no trace file produced")
        result = parse_op_breakdown(events)
        if not own_dir:
            result["trace_dir"] = d  # caller keeps the capture
        return result
    finally:
        if own_dir:
            shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------- on-demand capture
# One profiler at a time a process: captures serialize on this lock and a
# second requester is REFUSED (the StatusServer turns it into a 409),
# never queued — an operator asking "what is the card doing right now"
# must not silently measure a minute later.
_capture_lock = threading.Lock()
# set while a timed capture records (from its start to the end of its
# window, before it synchronizes and stops): what another thread polls
# to run work inside the window
CAPTURE_LIVE = threading.Event()

# hard bound on one capture: /profile is an unauthenticated loopback
# endpoint, and an unbounded capture both pins the profiler and grows
# an arbitrarily large trace file
MAX_PROFILE_MS = 10_000
MIN_PROFILE_MS = 10


class ProfileBusyError(RuntimeError):
    """A profiler capture is already running in this process."""


def _clamp_ms(ms) -> int:
    return max(MIN_PROFILE_MS, min(int(ms), MAX_PROFILE_MS))


def timed_capture(ms: int = 200, log_dir: str | None = None) -> dict:
    """Capture ``ms`` milliseconds of whatever this process is doing
    under ``torch.profiler`` and return the parsed ``op_breakdown``
    bundle (the ``GET /profile?ms=N`` payload). Blocking for the
    duration — callers on an event loop must ``asyncio.to_thread`` it.
    With ``log_dir`` the raw capture is retained there (``trace_dir`` in
    the result); otherwise it is parsed and deleted. Raises
    :class:`ProfileBusyError` when a capture is already live."""
    from torch.profiler import profile

    ms = _clamp_ms(ms)
    if not _capture_lock.acquire(blocking=False):
        raise ProfileBusyError(
            "a profiler capture is already running in this process"
        )
    try:
        own_dir = log_dir is None
        d = log_dir or tempfile.mkdtemp(prefix="tlt_profile_")
        try:
            os.makedirs(d, exist_ok=True)
            prof = profile(activities=_activities())
            prof.start()
            try:
                CAPTURE_LIVE.set()
                time.sleep(ms / 1000.0)
                CAPTURE_LIVE.clear()
                _sync()
            finally:
                CAPTURE_LIVE.clear()
                prof.stop()
            _export(prof, d)
            events = _newest_trace_events(d)
            out = {
                "duration_ms": ms,
                "op_breakdown": (
                    parse_op_breakdown(events) if events is not None
                    else _no_trace("no trace produced")
                ),
            }
            if not own_dir:
                out["trace_dir"] = d
            return out
        finally:
            if own_dir:
                shutil.rmtree(d, ignore_errors=True)
    finally:
        _capture_lock.release()


class _Dispatch:
    """One in-flight program dispatch: host enqueue time, a readiness
    probe (a CUDA ``(start, end)`` event pair, or anything with
    ``is_ready()``), and the dispatch's cost (flops and bytes) when the
    caller counted it."""

    __slots__ = ("program", "t_dispatch", "probe", "done", "busy_s", "cost")

    def __init__(self, program: str, t_dispatch: float, probe: Any,
                 cost: dict | None = None):
        self.program = program
        self.t_dispatch = t_dispatch
        self.probe = probe
        self.done = False
        # stamped at finalization: this dispatch's device-busy seconds,
        # which the serving engines apportion to the requests it served
        self.busy_s = 0.0
        self.cost = cost


def _is_event_pair(probe) -> bool:
    return isinstance(probe, tuple) and len(probe) == 2


def _probe_ready(probe: Any) -> bool:
    if _is_event_pair(probe):
        return probe[1].query()
    fn = getattr(probe, "is_ready", None)
    if fn is None:
        return False  # finalized at the next explicit sync
    try:
        return bool(fn())
    except Exception:  # noqa: BLE001 — a released buffer counts as ready
        return True


class DispatchTimer:
    """Per-program device-busy vs host-gap attribution with no added
    synchronization.

    The serving engines run their programs on one stream, so device
    execution is serialized in dispatch order. Per finalized dispatch:

    - with CUDA events: ``busy`` is the device time between the events
      recorded around the dispatch, ``gap`` the device time from the
      previous dispatch's end event to this one's start (the device sat
      idle waiting for the host), clamped at 0;
    - with the host clock (the reference's arithmetic): ``busy = ready -
      max(dispatch, frontier)`` and ``gap = max(dispatch - frontier,
      0)``, where ``ready`` is stamped by :meth:`poll` (the probe reports
      ready) or exactly by :meth:`drained` right after a host sync the
      caller was doing anyway.

    ``host_gap_frac = gap / (gap + busy)``. Finalization is strictly
    FIFO: a sync of dispatch N finalizes every earlier outstanding
    dispatch first (they provably completed). At most ``MAX_PROGRAMS``
    distinct names register before the rest lump under ``"other"``.
    Thread-safe; the lock takes nothing else.
    """

    MAX_PROGRAMS = 8

    def __init__(self, metrics=None, ewma: float = 0.1, clock=None):
        self.metrics = metrics
        self.alpha = float(ewma)
        self._clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._fifo: collections.deque[_Dispatch] = collections.deque()
        self._frontier: float | None = None
        self._frontier_event = None
        self.programs: dict[str, dict] = {}

    # ------------------------------------------------------------ record
    def dispatch(self, program: str, probe: Any = None,
                 cost: dict | None = None) -> _Dispatch:
        """Note one enqueued program, right after the call returned (host
        dispatch overhead then counts as host gap). ``probe``: the CUDA
        ``(start, end)`` event pair recorded around the dispatch, or an
        object with ``is_ready()``, or None (finalized at a sync).
        ``cost``: ``{"flops", "bytes"}`` of this dispatch."""
        e = _Dispatch(str(program), self._clock(), probe, cost)
        with self._lock:
            self._fifo.append(e)
        return e

    def poll(self) -> None:
        """Finalize FIFO-head dispatches whose probe reports ready (one
        cheap query per pending head: fit for every scheduler step)."""
        now = self._clock()
        with self._lock:
            while self._fifo and _probe_ready(self._fifo[0].probe):
                self._finalize_locked(self._fifo.popleft(), now)

    def drained(self, e: _Dispatch) -> None:
        """Exact finalization right after the caller host-synced this
        dispatch's output. Earlier outstanding dispatches finalize
        first."""
        now = self._clock()
        with self._lock:
            # the done check lives inside the lock: a concurrent poll()
            # may finalize e first, and the loop below would then drain
            # dispatches still executing
            if e.done:
                return
            while self._fifo:
                head = self._fifo.popleft()
                self._finalize_locked(head, now)
                if head is e:
                    break

    def count_tokens(self, program: str, n: int) -> None:
        """Attribute ``n`` emitted tokens to ``program`` (device
        tokens/s in the snapshot)."""
        if n <= 0:
            return
        with self._lock:
            _, rec = self._program_locked(str(program))
            rec["tokens"] += int(n)

    # ---------------------------------------------------------- internals
    def _program_locked(self, name: str) -> tuple[str, dict]:
        rec = self.programs.get(name)
        if rec is None:
            if len(self.programs) >= self.MAX_PROGRAMS:
                name = "other"
                rec = self.programs.get(name)
            if rec is None:
                rec = self.programs[name] = {
                    "count": 0, "busy_s": 0.0, "gap_s": 0.0,
                    "busy_ewma_s": None, "tokens": 0,
                }
        return name, rec

    def _finalize_locked(self, e: _Dispatch, t_ready: float) -> None:
        e.done = True
        if _is_event_pair(e.probe):
            start, end = e.probe
            busy = max(start.elapsed_time(end) / 1e3, 0.0)
            prev = self._frontier_event
            gap = 0.0 if prev is None else max(prev.elapsed_time(start) / 1e3, 0.0)
            self._frontier_event = end
        else:
            start_t = (e.t_dispatch if self._frontier is None
                       else max(e.t_dispatch, self._frontier))
            busy = max(t_ready - start_t, 0.0)
            gap = (max(e.t_dispatch - self._frontier, 0.0)
                   if self._frontier is not None else 0.0)
            self._frontier = max(self._frontier or t_ready, t_ready)
        e.probe = None  # release the events promptly
        e.busy_s = busy
        name, rec = self._program_locked(e.program)
        rec["count"] += 1
        rec["busy_s"] += busy
        rec["gap_s"] += gap
        a = self.alpha
        rec["busy_ewma_s"] = (
            busy if rec["busy_ewma_s"] is None
            else (1.0 - a) * rec["busy_ewma_s"] + a * busy
        )
        if e.cost:
            rec["flops"] = rec.get("flops", 0.0) + e.cost.get("flops", 0.0)
            rec["bytes"] = rec.get("bytes", 0.0) + e.cost.get("bytes", 0.0)
        if self.metrics is not None:
            from tensorlink_tpu_torch.runtime.metrics import DEVICE_BUCKETS

            # one histogram and one gauge per canonical program name
            # (bounded by MAX_PROGRAMS), never a per-request label
            self.metrics.observe_hist(f"dev_{name}_busy_s", busy,
                                      buckets=DEVICE_BUCKETS)
            self.metrics.observe(f"dev_{name}_gap_s", gap)

    # -------------------------------------------------------------- read
    def snapshot(self) -> dict:
        """Per-program totals and EWMAs plus the engine-wide device-busy
        vs host-gap split (and, for dispatches that carried a cost, the
        flops and bytes they moved)."""
        with self._lock:
            progs = {name: dict(rec) for name, rec in self.programs.items()}
            pending = len(self._fifo)
        busy = sum(r["busy_s"] for r in progs.values())
        gap = sum(r["gap_s"] for r in progs.values())
        for r in progs.values():
            if r["tokens"] and r["busy_s"] > 0:
                r["device_tokens_per_sec"] = round(r["tokens"] / r["busy_s"], 1)
        return {
            "programs": progs,
            "pending": pending,
            "device_busy_s": round(busy, 6),
            "host_gap_s": round(gap, 6),
            "host_gap_frac": (
                round(gap / (gap + busy), 4) if (gap + busy) > 0 else 0.0
            ),
        }


# ------------------------------------------------ capability microbench
CAPABILITY_SCHEMA = 1


def measure_capability(
    *,
    matmul_dim: int = 512,
    hbm_mb: int = 64,
    reps: int = 4,
    store=None,
    key: str | None = None,
    device=None,
    recorder=None,
) -> dict:
    """Microbench of this card: peak bf16 matmul TFLOP/s (``reps``
    chained ``matmul_dim``-square products) and HBM read GB/s (a sum
    over ``hbm_mb`` MiB of f32), each timed with CUDA events after a
    warm-up. The denominators per-program MFU/MBU are computed against,
    and the physics a receipt auditor checks claims against; size them
    so the card is filled (the defaults, the reference's, read an H100
    far below its peak).

    With ``store``/``key`` (a ``runtime/autotune.py`` ``AutotuneStore``
    and its chip-global key, ``store_key(GLOBAL_MODEL, ())``), a record
    an earlier process measured on the same card at the same sizes is
    returned without running anything (``cached: True``); otherwise the
    fresh measurement is merged into the store's record, so a restart
    skips it. ``recorder``: a flight recorder that gets a
    ``capability.measured`` event for a fresh measurement."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("measure_capability times the CUDA card; got "
                           f"device {dev}")
    if store is not None and key:
        cap = (store.load(key) or {}).get("capability")
        if (isinstance(cap, dict) and cap.get("schema") == CAPABILITY_SCHEMA
                and cap.get("chip") == torch.cuda.get_device_name(dev)
                and cap.get("matmul_dim") == int(matmul_dim)
                and cap.get("hbm_mb") == int(hbm_mb)):
            return {**cap, "cached": True}
    t_all = time.perf_counter()
    n = int(matmul_dim)
    # entries 1/n keep the chained product at ones (exact in bf16)
    x = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)
    y = x @ x
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        y = y @ x  # chained: the calls serialize on the data dependence
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3
    peak_tflops = (2.0 * n**3 * reps) / dt / 1e12 if dt > 0 else 0.0

    m = max(int(hbm_mb) * (1 << 20) // 4, 1024)
    buf = torch.ones((m,), dtype=torch.float32, device=dev)
    s = buf.sum()  # warm-up
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        s = buf.sum()
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3
    hbm_gbps = (4.0 * m * reps) / dt / 1e9 if dt > 0 else 0.0
    del x, y, buf, s
    cap = {
        "schema": CAPABILITY_SCHEMA,
        "chip": torch.cuda.get_device_name(dev),
        "peak_tflops": round(peak_tflops, 4),
        "hbm_gbps": round(hbm_gbps, 3),
        "matmul_dim": n,
        "hbm_mb": int(hbm_mb),
        "measure_s": round(time.perf_counter() - t_all, 4),
        "measured_at": time.time(),
    }
    if recorder is not None:
        try:
            recorder.record(
                "capability.measured", chip=cap["chip"],
                peak_tflops=cap["peak_tflops"], hbm_gbps=cap["hbm_gbps"],
                measure_s=cap["measure_s"],
            )
        except Exception:  # noqa: BLE001 — telemetry must not fail a measurement
            pass
    if store is not None and key:
        store.update(key, {"capability": cap})
    return cap


# ------------------------------------------------------------ cost model
def _dims(cfg) -> dict:
    """Per-layer widths of a Llama- or GPT-2-style config (``experts`` 0
    for a dense MLP)."""
    H = cfg.num_heads
    D = cfg.dim // H
    gated = hasattr(cfg, "hidden_dim")  # Llama: SwiGLU; GPT-2: GELU MLP
    return {
        "dim": cfg.dim, "layers": cfg.num_layers, "H": H, "D": D,
        "Hkv": getattr(cfg, "num_kv_heads", H), "vocab": cfg.vocab_size,
        "mlp_mats": 3 if gated else 2,
        "hidden": cfg.hidden_dim if gated else 4 * cfg.dim,
        "experts": getattr(cfg, "moe_experts", 0),
    }


def layer_matmul_params(cfg) -> int:
    """Weights one token multiplies through per layer: q, k, v, o and the
    dense MLP's matrices (a MoE FFN's work depends on the call's T:
    ``moe_row_flops``)."""
    d = _dims(cfg)
    attn = d["dim"] * (d["H"] + 2 * d["Hkv"]) * d["D"] + d["H"] * d["D"] * d["dim"]
    return attn + (0 if d["experts"] else d["mlp_mats"] * d["dim"] * d["hidden"])


def moe_row_flops(cfg, T: int, shards: int = 1) -> float:
    """Flops of one layer's MoE FFN over one row of T tokens, as the
    dense one-hot dispatch computes them: the router (2 D E a token),
    the dispatch and combine einsums (2 T E C D each) and every expert's
    products over its C slots (2 D H E C a matrix), whether a slot holds
    a token or not. ``shards``: the model axis the experts are cut over;
    one rank routes every token with the whole router and runs the
    einsums for its E / ``shards`` experts. 0 for a dense config."""
    d = _dims(cfg)
    E = d["experts"]
    if not E:
        return 0.0
    C = expert_capacity(T, E, cfg.moe_top_k, cfg.moe_capacity_factor)
    D, Hd = d["dim"], d["hidden"]
    experts = 2 * 2 * T * E * C * D + 2 * d["mlp_mats"] * D * Hd * E * C
    return float(2 * T * D * E + experts / shards)


def program_cost(
    cfg,
    program: str,
    *,
    rows: int,
    steps: int,
    frontier: Sequence[int],
    k: int = 0,
    weight_bytes: float,
    kv_token_bytes: int,
    shards: int = 1,
) -> dict:
    """Flops and HBM bytes of one dispatch, from the config and the
    dispatch's host-known shape.

    ``program``: ``"prefill_chunk"`` (one row; ``steps`` query tokens,
    the chunk's width; ``frontier`` = [the chunk's end position]: its
    queries attend causally from ``frontier - steps``), ``"decode"``
    (``rows`` batch rows, ``steps`` T == 1 steps; ``frontier`` = each
    decoding row's write frontier after the chunk) or ``"spec_chunk"``
    (``steps`` verify rounds of K + 1 = ``k + 1`` queries a row; the
    draft model's passes are not counted). ``kv_token_bytes``: k/v bytes
    one token holds in one layer (scales included). ``weight_bytes``: the
    bytes one weight pass reads as the engine stores them
    (``InferenceEngine.weight_bytes``: int8 weights at one byte plus
    their f32 scales). ``shards``: the model axis the dispatch runs on;
    each rank does 1 / ``shards`` of the flops (a MoE layer's router
    whole: ``moe_row_flops``), and ``weight_bytes`` and
    ``kv_token_bytes`` are already its own (its blocks, its KV heads,
    its E / ``shards`` experts beside the whole router), so the cost,
    MFU and MBU are one rank's.

    Counted: every weight is read once a weight pass (one a prefill
    chunk, one a decode step or verify round), the LM head over the rows
    whose logits are taken (the last real token of a prefill chunk, every
    row of a decode step), and each query's keys up to its position:
    2 x 2 x H x D flops a (query, key) pair and a layer, and each row's
    KV bytes up to its frontier read once a weight pass. A MoE config
    adds ``moe_row_flops`` a layer for each row at the pass's T (the
    chunk's width, 1 a decode step, K + 1 a verify round), and its
    ``weight_bytes`` holds every expert the rank holds."""
    d = _dims(cfg)
    L, H, D = d["layers"], d["H"], d["D"]
    per_tok = 2.0 * layer_matmul_params(cfg) * L
    head_flops = 2.0 * d["dim"] * d["vocab"]
    w_bytes = float(weight_bytes)
    attn_pair = 4.0 * H * D * L
    kv_tok = float(kv_token_bytes) * L
    if program == "prefill_chunk":
        T = int(steps)
        end = int(frontier[0])
        pos = end - T
        pairs = T * pos + T * (T + 1) / 2
        flops = ((per_tok * T + head_flops + attn_pair * pairs) / shards
                 + L * moe_row_flops(cfg, T, shards))
        nbytes = w_bytes + kv_tok * end
    elif program in ("decode", "spec_chunk"):
        K = int(steps)
        q = 1 if program == "decode" else int(k) + 1
        passes = K
        pairs = 0.0
        kv_read = 0.0
        for f in frontier:
            # the row's first query of the chunk sits at f - K*q
            first = max(int(f) - K * q, 0)
            for step in range(K):
                base = first + step * q
                pairs += q * base + q * (q + 1) / 2
                kv_read += base + q
        flops = (((per_tok + head_flops) * rows * q * passes + attn_pair * pairs)
                 / shards + L * moe_row_flops(cfg, q, shards) * rows * passes)
        nbytes = w_bytes * passes + kv_tok * kv_read
    else:
        raise ValueError(f"unknown program {program!r}")
    return {"flops": float(flops), "bytes": float(nbytes)}
