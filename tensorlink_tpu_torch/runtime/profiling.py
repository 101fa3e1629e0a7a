"""Device timing (the ``DispatchTimer`` and ``measure_capability`` parts of
``tensorlink_tpu/runtime/profiling.py``) and a per-dispatch cost model.

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

The reference's metrics hooks (histograms per program) wait for the
port's observability module.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Sequence

import torch


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

    def __init__(self, ewma: float = 0.1, clock=None):
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
        _, rec = self._program_locked(e.program)
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
    skips it."""
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
    if store is not None and key:
        store.update(key, {"capability": cap})
    return cap


# ------------------------------------------------------------ cost model
def _dims(cfg) -> dict:
    """Per-layer widths of a Llama- or GPT-2-style config."""
    H = cfg.num_heads
    D = cfg.dim // H
    gated = hasattr(cfg, "hidden_dim")  # Llama: SwiGLU; GPT-2: GELU MLP
    return {
        "dim": cfg.dim, "layers": cfg.num_layers, "H": H, "D": D,
        "Hkv": getattr(cfg, "num_kv_heads", H), "vocab": cfg.vocab_size,
        "mlp_mats": 3 if gated else 2,
        "hidden": cfg.hidden_dim if gated else 4 * cfg.dim,
    }


def layer_matmul_params(cfg) -> int:
    """Weights one token multiplies through per layer: q, k, v, o and the
    MLP's matrices."""
    d = _dims(cfg)
    attn = d["dim"] * (d["H"] + 2 * d["Hkv"]) * d["D"] + d["H"] * d["D"] * d["dim"]
    return attn + d["mlp_mats"] * d["dim"] * d["hidden"]


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
    their f32 scales).

    Counted: every weight is read once a weight pass (one a prefill
    chunk, one a decode step or verify round), the LM head over the rows
    whose logits are taken (the last real token of a prefill chunk, every
    row of a decode step), and each query's keys up to its position:
    2 x 2 x H x D flops a (query, key) pair and a layer, and each row's
    KV bytes up to its frontier read once a weight pass."""
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
        flops = per_tok * T + head_flops + attn_pair * pairs
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
        flops = (per_tok + head_flops) * rows * q * passes + attn_pair * pairs
        nbytes = w_bytes * passes + kv_tok * kv_read
    else:
        raise ValueError(f"unknown program {program!r}")
    return {"flops": float(flops), "bytes": float(nbytes)}
