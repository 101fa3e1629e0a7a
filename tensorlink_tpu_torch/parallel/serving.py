"""Continuous-batching serving engines (port of the scheduler core of
``ContinuousBatchingEngine`` and ``PagedContinuousBatchingEngine`` in
``tensorlink_tpu/parallel/serving.py``).

A fixed set of decode slots serves a stream of requests: a slot row is
one request with its own write index, validity mask, logical position
and sampling stream. ``submit`` queues a prompt, ``step`` runs one
scheduler iteration, ``result`` drives the loop until a request ends.

``ContinuousBatchingEngine`` gives every slot a contiguous region of
``L`` cache slots a layer (``nn/attention.py`` per-row index form):

- **admission** prefills the prompt right away when a slot is free: the
  prompt is left-padded to a multiple of ``prefill_block`` (bounding the
  distinct prefill shapes), attends its own fresh keys, and its k/v are
  written straight into the slot's region in place;
- **decode** runs ``decode_chunk`` T == 1 steps over every slot per
  scheduler step, the counterpart of the JAX package's jitted
  ``lax.scan``: on CUDA one replay of a captured graph
  (``runtime/graphs.py``), on the CPU the same chunk body eagerly; a row
  whose request ended parks, and its slot is free for the next
  admission once the chunk that ended it has drained.

``PagedContinuousBatchingEngine`` (its subclass) keeps every layer's k/v
in shared pools of fixed-size blocks addressed through per-slot block
tables (``nn/attention.py`` paged form); the host-side
``BlockPool``/``PrefixIndex`` (``parallel/kvpool.py``) decide which
block ids each slot maps:

- **admission** matches the prompt against the prefix index; resident
  full blocks map straight into the block table and are never
  re-prefilled. A matched partial tail block is revived when idle or
  copied (copy-on-write) when it has live sharers.
- **chunked prefill**: the prompt runs in ``prefill_chunk``-token
  chunks, right-padded, at most one chunk per scheduler step,
  interleaved with decode.
- **decode** grows each slot's block table lazily, just ahead of its
  write frontier. When the pool runs short, the least protected request
  (lowest priority class, newest within it) is preempted: its blocks
  free, it re-queues, and it resumes token-identical because sampling
  depends on (request seed, logical position) only.
- a finished request's slot is retired on the device (block table to
  the sentinel, so later writes through it drop) before its blocks
  return to the pool.

**Admission control** (both engines): ``submit`` takes a ``priority``
(:class:`Priority`), which orders admission from the queue, which
queued request a full queue sheds first (displacement) and, on the paged
engine, which running request is preempted; and a ``deadline_s``:
``submit`` refuses a deadline that the measured time per output token
proves unmeetable, and a queued or running request whose deadline passes
is cancelled (slot and blocks freed). Shed requests get a typed
``OverloadedError`` with a ``retry_after_s`` derived from measured TPOT
and the backlog. ``cancel`` and ``result(deadline_s=)`` abort a request;
the scheduler lock makes ``submit`` and ``cancel`` safe against a thread
that pumps ``step``.

**Speculative decoding** (both engines; ``speculative=SpecConfig``,
``draft=InferenceEngine``, ``parallel/speculative.py``): each dispatched
chunk runs ``rounds`` rounds of draft-K then verify-K+1 in one target
weight pass, and rolls each row's write frontier back to its first
rejection in place (contiguous: the write index; paged: the logical
index, whose rejected writes land in blocks the row owns or the scratch
block). A per-row effective K (the adaptive controller's) is a
preallocated device tensor, so one spec-chunk graph serves any mix of K.

Device state: the JAX engines donate their state tree to each program.
Here the caches, write index, per-slot vectors (fed token, valid count,
budget, liveness, sampling seed, effective K), the speculation state and
the chunk's token output are preallocated device buffers that the chunk
body updates in place, so a captured graph keeps reading the live
buffers. The chunk body reads no host value but its graph key (the
blocks of a blockwise read on the contiguous cache above 2048 slots) and
makes no host read.

Chunks in flight: as in the reference, ``pipeline_depth`` (default 2)
decode chunks stay in flight. Each dispatch copies the chunk's tokens
into one of ``pipeline_depth + 1`` pinned host buffers and records an
event; ``step`` drains the oldest chunk once more than
``pipeline_depth`` are in flight (all of them when idle), which is the
one host sync. A prefill's first token stays a device scalar (copied
out the same way) until the first chunk after it drains; TTFT is stamped
when its event is seen complete. Requests finish, and their slots and
blocks free, at drain.

**Device timing** (``device_timing=True``, ``runtime/profiling.py``):
every prefill, decode and spec dispatch goes through a
``DispatchTimer``. On CUDA two timing events are recorded around the
dispatch (around ``GraphCache.run``, never inside a captured body); the
timer reads them when they have completed (``poll`` each step, exactly at
the drain's sync), so it adds no sync. ``device_time()`` and
``stats()["device_time"]`` give each program's count, busy and gap
seconds, host-gap share and device tokens/s, and, with a ``capability``
record (``measure_capability``), its MFU and MBU from the flops and
bytes ``program_cost`` counts at each dispatch.

**Metering** (``metering=True``): each request accumulates the busy
seconds of the dispatches that served it (a prefill dispatch bills its
request; a decode or spec chunk is split equally over the rows it was
dispatched for), their flops and bytes, KV block-seconds (paged: at
alloc, grow, preempt and finish) and the wire bytes of an imported
prefill. A finished request leaves a meter (``meter(rid)``,
``drain_meters()``) that ``runtime/ledger.py build_receipt`` signs. A
meter is written once the last chunk in flight that served its request
has drained, so every chunk's device time bills some request.

**Disaggregated prefill/decode** (paged engine, ``parallel/kvwire.py``):
``prefill_export`` runs a request's chunked prefill on a held slot (the
row is off on the device and out of every decode chunk) and returns its
filled blocks, gathered from the pools in one sync, with the first
token and the scalars a decode leg needs. ``import_prefill`` on another
engine grafts the blocks into its preallocated pools in place (under
graph replay the captured graphs keep reading the same tensors), points
the slot's block-table row at them and decodes token-identically to
colocated serving. Draft-model speculation raises
``NotImplementedError`` there, as in the reference.

**Warm start** (both engines): ``compile_cache_dir=`` (or
``$TL_COMPILE_CACHE_DIR``, ``runtime/compile_cache.py``) keeps the
kernel libraries a restart would otherwise rebuild; ``stats()["compile"]``
says which came from it (``compile_cache_hit``). ``autotune_dir=`` (or
``$TL_AUTOTUNE_DIR``, ``runtime/autotune.py``) loads, before anything is
captured, the record keyed by (torch, CUDA, chip, model fingerprint,
bucket set): flash-block overrides installed, the adaptive controller's K
prior staged. ``save_autotune(**extra)`` writes this engine's knobs (and
JSON-safe extras such as ``autopair_draft``'s ``persistable`` verdict).
``warm_buckets=True`` runs the bucket set the key names once at
construction.

**Chaos hooks** (``runtime/chaos.py``): ``serving.dispatch`` before each
decode or spec chunk is launched and ``serving.drain`` at the top of each
drain, on the host, outside every captured body; disarmed, each costs one
module-global read.

**Self-healing** (``SpecConfig.self_heal_accept``): an EWMA of recent
acceptance; below the floor after ``HEAL_MIN_PROPOSED`` verified
proposals the engine downgrades itself (draft -> n-gram -> off) at a
device-idle point (no live slot, no chunk in flight, no pending prefill),
drops the old mode's graphs and pool and rebuilds the speculation state;
the next chunk captures the new mode. ``stats()["spec_self_healed"]``.

**asyncio**: ``asubmit`` / ``aresult`` run ``submit`` / ``result`` in the
loop's executor. Every device call stays under the scheduler lock, so a
pump thread's graph capture never overlaps another thread's prefill (a
capture fails if another thread launches work meanwhile).

Not ported yet (see ROADMAP): metrics and events (the counts live in
``stats()``).
"""

from __future__ import annotations

import asyncio
import collections
import enum
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tensorlink_tpu_torch.nn.attention import paged_write_slots
from tensorlink_tpu_torch.ops.quant import quantize_kv_int8
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    sample_logits_at,
    spec_verify,
)
from tensorlink_tpu_torch.parallel.kvpool import (
    BlockPool,
    PoolExhaustedError,
    PrefixIndex,
)
from tensorlink_tpu_torch.parallel.speculative import (
    AdaptiveKController,
    SpecConfig,
    SpeculativeDecoder,
    ngram_propose,
)
from tensorlink_tpu_torch.runtime import chaos
from tensorlink_tpu_torch.runtime.autotune import (
    AutotuneStore,
    apply_flash_overrides,
    model_fingerprint,
    store_key,
)
from tensorlink_tpu_torch.runtime.compile_cache import compile_report, enable_compile_cache
from tensorlink_tpu_torch.runtime.graphs import GraphCache
from tensorlink_tpu_torch.runtime.profiling import DispatchTimer, program_cost

__all__ = [
    "ContinuousBatchingEngine",
    "DeadlineExceededError",
    "OverloadedError",
    "PagedContinuousBatchingEngine",
    "PoolExhaustedError",
    "PoolOverloadedError",
    "Priority",
    "PromptTooLongError",
    "QueueFullError",
    "ServingError",
    "SpecConfig",
    "serve_error_from_wire",
    "serve_error_to_wire",
]

# retry-after TPOT stand-in before the first request finishes (a cold
# engine has measured nothing); every later estimate is the EWMA of this
# engine's own completions
_RETRY_TPOT_FALLBACK_S = 0.02

# rows of a speculative chunk's output per round, after its K+1 tokens:
# n_emit, n_acc, fallback, n_prop, draft steps no row needed
_SPEC_EXTRA = 5

# verified proposals the self-healing gate waits for before it trusts
# the acceptance EWMA (the reference's)
HEAL_MIN_PROPOSED = 32

# the most prefill buckets the contiguous engine keys its autotune record
# on and warms (the reference's prefill-program cache bound)
_AUTOTUNE_BUCKETS_MAX = 32


class Priority(enum.IntEnum):
    """SLO class on ``submit()``. Lower value = more protected: the
    scheduler admits, queues and, under pool pressure, preserves requests
    in this order (a BATCH stream is preempted or shed before any
    STANDARD one, STANDARD before INTERACTIVE; within a class, newest
    first). Token-identical preempt/resume makes demotion safe."""

    INTERACTIVE = 0
    STANDARD = 1
    BATCH = 2


_PRIO_NAMES = {int(p): p.name.lower() for p in Priority}


def _coerce_priority(p) -> int:
    if isinstance(p, str):
        try:
            return int(Priority[p.upper()])
        except KeyError:
            raise ValueError(
                f"unknown priority {p!r} (use "
                f"{'/'.join(n.name for n in Priority)})"
            ) from None
    return int(Priority(int(p)))


class ServingError(RuntimeError):
    """Base class for scheduler rejections."""


class PromptTooLongError(ServingError):
    """Prompt (plus its token budget) cannot fit a slot's view."""


class OverloadedError(ServingError):
    """Typed 429: the scheduler shed this request. ``retry_after_s`` is
    derived from measured TPOT x the token backlog ahead of a new arrival
    / decode width x pool pressure. ``reason`` names the resource
    (``queue_full``, ``pool_exhausted``, ``displaced``)."""

    def __init__(self, msg: str, *, retry_after_s: float | None = None,
                 reason: str = "overloaded"):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.reason = reason


class QueueFullError(OverloadedError):
    """Admission queue at max_queue with every slot busy."""

    def __init__(self, msg: str, **kw):
        kw.setdefault("reason", "queue_full")
        super().__init__(msg, **kw)


class PoolOverloadedError(OverloadedError, PoolExhaustedError):
    """Queue at max_queue while slots are free: starved on KV blocks.
    Catchable as either ``PoolExhaustedError`` or ``OverloadedError``."""

    def __init__(self, msg: str, **kw):
        kw.setdefault("reason", "pool_exhausted")
        super().__init__(msg, **kw)


class DeadlineExceededError(ServingError):
    """The request's deadline is (or became) unmeetable: refused at
    admission when measured TPOT proves the decode alone cannot finish in
    time, or cancelled later (slot and blocks freed) when the deadline
    passes while it is queued, running or awaited."""

    def __init__(self, msg: str, *, rid: int | None = None):
        super().__init__(msg)
        self.rid = rid


# typed scheduler errors crossing a wire: a remote rejection re-raises
# as the same type, retry-after included
_WIRE_ERRORS = {
    cls.__name__: cls
    for cls in (
        ServingError, PromptTooLongError, OverloadedError, QueueFullError,
        PoolOverloadedError, DeadlineExceededError, PoolExhaustedError,
        # result(timeout_s=): the request still runs and can be collected
        TimeoutError,
    )
}


def serve_error_to_wire(e: BaseException) -> dict:
    """Scheduler exception -> SERVE_FAILED reply dict."""
    out = {
        "type": "SERVE_FAILED",
        "error_type": type(e).__name__,
        "error": str(e)[:300],
    }
    ra = getattr(e, "retry_after_s", None)
    if ra is not None:
        out["retry_after_s"] = ra
    return out


def serve_error_from_wire(resp: dict) -> BaseException:
    """SERVE_FAILED reply -> the typed exception to raise locally; an
    unknown type degrades to ``ServingError``."""
    cls = _WIRE_ERRORS.get(str(resp.get("error_type")), ServingError)
    msg = str(resp.get("error", "remote serving leg failed"))
    if issubclass(cls, OverloadedError):
        return cls(msg, retry_after_s=resp.get("retry_after_s"))
    return cls(msg)


def _as_tensor(x) -> torch.Tensor:
    """A payload field as a CPU tensor (a numpy array is wrapped)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


@dataclass
class _Request:
    rid: int
    ids: np.ndarray | None  # [T0] prompt tokens (dropped once finished)
    max_new: int
    seed: int
    submitted_at: float
    priority: int = int(Priority.STANDARD)
    deadline_s: float | None = None
    deadline_at: float | None = None  # perf_counter absolute
    # terminal failure (shed, deadline miss, cancel): result() raises it
    failed: BaseException | None = None
    tenant: str | None = None
    slot: int | None = None
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None
    prefill_chunks: int = 0
    # the prefill's first token on its way to the host: (host tensor,
    # event or None), taken at the first drain after it
    first_token: tuple | None = None
    # speculation (0 when it is off)
    spec_rounds: int = 0  # verify passes this request was live for
    spec_proposed: int = 0  # drafted tokens verified for it
    spec_accepted: int = 0  # drafted tokens accepted into its stream
    # wall-clock anchor of the meter's t_start (the other stamps are
    # perf_counter)
    submitted_ns: int = 0
    n_prompt: int = 0  # prompt tokens (the prompt itself is dropped at finish)
    # prefill-leg hold (disaggregated serving): the scheduler prefills the
    # request but never decodes it; prefill_export ships its blocks
    hold: bool = False
    # metering: busy seconds, flops and bytes of the dispatches that
    # served it, KV block-seconds, the imported blob's bytes
    busy_s: float = 0.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    kv_block_s: float = 0.0
    kv_blocks_now: int = 0
    kv_anchor: float | None = None
    wire_bytes: int = 0
    # the last prefill dispatch's timer handle, and every prefill handle
    # not yet folded into the meter
    disp: object | None = None
    disp_hist: list = field(default_factory=list)
    # finished while a chunk that served it was still in flight: its
    # meter is written when the last such chunk drains
    meter_deferred: bool = False


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over per-slot contiguous cache
    regions on one device.

    ``slots``: decode batch width (a slot row is one request).
    ``decode_chunk``: T == 1 steps per scheduler step (one captured graph
    on CUDA). ``pipeline_depth``: decode chunks kept in flight before the
    host syncs the oldest (0: every step reads its own chunk back).
    ``prefill_block``: prompt lengths round up to a multiple of this.
    ``max_queue``: pending admissions beyond which ``submit`` sheds (a
    strictly lower-priority queued request, else the arrival) with an
    ``OverloadedError``. ``keep_results``: finished requests kept
    readable through ``result``. ``cuda_graphs`` (CUDA only): decode
    chunks run as graph replays (True) or eagerly (False), the same chunk
    body either way. ``speculative`` (a ``SpecConfig``, or True for the
    default one) turns on speculative decoding, n-gram unless ``draft``
    (an ``InferenceEngine`` on the same device and vocabulary) is given.
    ``device_timing``: time every dispatch (``stats()["device_time"]``);
    ``capability``: a ``measure_capability`` record, the peaks MFU and MBU
    are computed against. ``metering``: keep a meter a finished request
    (``meter``, ``drain_meters``); ``meter_kind`` names what they bill
    (``"serve"``, or a disaggregated leg's ``"prefill_leg"`` /
    ``"decode_leg"``). ``compile_cache_dir``, ``autotune_dir`` and
    ``warm_buckets``: the warm start (module docstring).
    """

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        slots: int = 8,
        gen: GenerationConfig | None = None,
        decode_chunk: int = 8,
        pipeline_depth: int = 2,
        prefill_block: int = 32,
        max_queue: int | None = None,
        keep_results: int = 1024,
        cuda_graphs: bool = True,
        draft: InferenceEngine | None = None,
        speculative: SpecConfig | bool | None = None,
        device_timing: bool = True,
        capability: dict | None = None,
        metering: bool = True,
        compile_cache_dir: str | None = None,
        autotune_dir: str | None = None,
        warm_buckets: bool = False,
    ):
        if engine.rolling:
            raise NotImplementedError(
                "continuous batching over a rolling (ring) cache would "
                "need per-row wrap bookkeeping; use the monotone cache"
            )
        self.engine = engine
        self.device = engine.device
        self.gen = gen or GenerationConfig()
        if not 0.0 < self.gen.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1] (1.0 = off), got {self.gen.top_p}"
            )
        self.slots = S = int(slots)
        self.decode_chunk = int(decode_chunk)
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.prefill_block = int(prefill_block)
        self.max_queue = max_queue
        self.keep_results = max(int(keep_results), 1)
        self.L = L = engine.cache_len
        self._lock = threading.Lock()

        # per-dispatch device timing (runtime/profiling.py): events
        # recorded around each dispatch, read once complete; no sync added
        self._timer = DispatchTimer() if device_timing else None
        self.capability = capability
        # metering (runtime/ledger.py): finished-request meters, addressable
        # by rid and drainable once, both bounded
        self.metering = bool(metering)
        self.meter_kind = "serve"
        self._meter_log: collections.OrderedDict[int, dict] = collections.OrderedDict()
        self._meter_fresh: collections.deque = collections.deque(maxlen=512)
        self._metered_total = 0

        # speculative decoding: a draft engine implies draft-model mode;
        # ``speculative`` alone (True or a SpecConfig) n-gram mode
        self.spec: SpeculativeDecoder | None = None
        if draft is not None or speculative:
            cfg = speculative if isinstance(speculative, SpecConfig) else SpecConfig()
            self.spec = SpeculativeDecoder(engine, draft, cfg)
        # self-healing: recent-acceptance EWMA, and the downgrade if one
        # happened
        self._heal_acc: float | None = None
        self._heal_proposed = 0
        self.spec_self_healed: dict | None = None
        self.spec_self_heal_total = 0

        # warm start: the kernel-build cache, then the autotune record,
        # loaded before anything is built or captured
        self._cc_dir = enable_compile_cache(compile_cache_dir)
        self.autotune_warm_start_s: float | None = None
        self._autotune_key: str | None = None
        self._autotune_record: dict | None = None
        self._autotune_dropped = 0  # extras save_autotune could not serialize
        self._autotune = AutotuneStore.resolve(autotune_dir)
        if self._autotune is not None:
            self._autotune_load()

        self._kctl: AdaptiveKController | None = None
        if self.spec is not None and self.spec.cfg.adaptive:
            # n-gram proposals are free: only the position cost pulls K
            # down then
            self._kctl = AdaptiveKController(
                self.spec.cfg,
                draft_cost=0.0 if self.spec.mode == "ngram" else None,
                prior=(self._autotune_record or {}).get("k_prior"),
            )
        # the masked-K array staged for the next dispatch (the paged
        # engine stages it before growing blocks, so the two agree)
        self._k_dispatch: list[int] | None = None
        self.spec_rounds_total = 0  # (live row, verify pass) pairs
        self.spec_emitted_total = 0
        self.spec_accepted_total = 0
        self.spec_proposed_total = 0
        self.spec_fallback_total = 0
        self.spec_idle_draft_steps = 0  # draft steps no row needed

        dev = self.device
        self._valid = torch.zeros((S, L), dtype=torch.bool, device=dev)
        self._n_valid = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._tok = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._remaining = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._live = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._seed = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._rows = torch.arange(S, device=dev)
        self._graphs = GraphCache(dev, enabled=cuda_graphs)
        # dispatched, not yet drained: (host output, event or None, the
        # dispatch-time slot -> request snapshot, slot -> the most
        # positions the chunk may advance that slot, timer handle or None)
        self._inflight: collections.deque = collections.deque()
        self._init_out()
        self._dispatched = 0

        # host-side scheduler state
        self._queue: list[_Request] = []
        self._requests: dict[int, _Request] = {}
        self._done_order: collections.deque[int] = collections.deque()
        self._slot_req: list[_Request | None] = [None] * S
        self._free: list[int] = list(range(S))[::-1]
        self._next_rid = 0
        # upper bound of each slot's device write index once every
        # dispatched chunk has run, and (paged) the advance a slot's bound
        # already includes for the chunk about to be dispatched
        self._slot_ub = [0] * S
        self._staged_adv: dict[int, int] = {}

        # admission control: measured TPOT/TTFT EWMAs feed retry-after
        # and deadline feasibility; shed, miss and cancel counts stats()
        self._tpot_ewma: float | None = None
        self._ttft_ewma: float | None = None
        self._sheds = 0
        self._shed_by_prio: dict[int, int] = {}
        self._last_shed_at: float | None = None
        self._deadline_misses = 0
        self._deadlined = 0  # live requests carrying a deadline
        self._cancelled = 0

        # counters
        self.prefill_chunks = 0  # prefill programs run
        self.decode_steps = 0  # T == 1 model steps dispatched
        self.verify_passes = 0  # speculative verify passes dispatched
        self.draft_steps = 0  # draft-model T == 1 steps dispatched
        self._drained_tokens = 0
        # steps that ran decode and no prefill: wall time (each drain ends
        # in a device sync, so the sum is device-inclusive) and the tokens
        # drained in them
        self.decode_only_s = 0.0
        self.decode_only_tokens = 0
        self._init_state()
        self._init_spec_state()
        if warm_buckets:
            self._warm()

    def _init_out(self) -> None:
        """The chunk's device output and the pinned host buffers the
        chunks in flight copy it to; their shape follows the mode."""
        S = self.slots
        if self.spec is None:
            out_shape = (self.decode_chunk, S)
        else:
            cfg = self.spec.cfg
            out_shape = (cfg.rounds, cfg.k + 1 + _SPEC_EXTRA, S)
        self._out = torch.zeros(out_shape, dtype=torch.int64, device=self.device)
        pin = self.device.type == "cuda"
        self._host_out = [
            torch.zeros(out_shape, dtype=torch.int64, pin_memory=pin)
            for _ in range(self.pipeline_depth + 1)
        ]

    # ------------------------------------------------------- warm start
    def _autotune_buckets(self) -> tuple[int, ...]:
        """The prefill shapes this engine's tuning was measured against
        (part of the store key) and that ``warm_buckets`` runs: every
        ``prefill_block`` multiple up to the cache view, at most
        ``_AUTOTUNE_BUCKETS_MAX`` of them."""
        top = min(self.L, self.engine.max_len)
        buckets = range(self.prefill_block, top + 1, self.prefill_block)
        return tuple(buckets)[:_AUTOTUNE_BUCKETS_MAX]

    def _autotune_load(self) -> None:
        """Load and apply the record for this (torch, CUDA, chip, model,
        buckets) key: flash-block overrides installed, the K prior staged
        for the controller. A miss (absent, corrupt, stale) is a silent
        cold start."""
        t0 = time.perf_counter()
        self._autotune_key = store_key(
            model_fingerprint(self.engine.model), self._autotune_buckets()
        )
        rec = self._autotune.load(self._autotune_key)
        if rec is None:
            return
        # (a record's paged-kernel rows have no counterpart here:
        # autotune.apply_paged_overrides says why)
        apply_flash_overrides(rec)
        self._autotune_record = rec
        self.autotune_warm_start_s = round(time.perf_counter() - t0, 4)

    def save_autotune(self, **extra) -> str | None:
        """Persist this engine's measured knobs — the installed flash-block
        overrides, its bucket set, the adaptive controller's K prior —
        plus caller extras (e.g. ``draft_pair=`` an ``autopair_draft``
        verdict's ``persistable``). An extra that is not JSON-serializable
        is dropped and counted (``stats()["autotune"]``), never allowed to
        fail the save. Returns the written path, None without a store."""
        if self._autotune is None:
            return None
        from tensorlink_tpu_torch.ops.flash import flash_block_overrides

        with self._lock:  # a self-heal may be swapping the controller
            rec = {
                "flash_blocks": [list(t) for t in flash_block_overrides()],
                "prefill_buckets": list(self._autotune_buckets()),
            }
            if self._kctl is not None:
                rec["k_prior"] = self._kctl.prior()
        for k, v in extra.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError):
                self._autotune_dropped += 1
                continue
            rec[k] = v
        key = self._autotune_key or store_key(
            model_fingerprint(self.engine.model), self._autotune_buckets()
        )
        return str(self._autotune.save(key, rec))

    @torch.no_grad()
    def _warm(self) -> None:
        """Run each prefill bucket of the autotune key once on slot 0's
        region at construction (kernel libraries build, the allocator
        warms), then reset the slot: first-request TTFT then measures
        serving. Buckets run smallest first."""
        dev = self.device
        for Tp in self._autotune_buckets():
            ids = torch.zeros((1, Tp), dtype=torch.int64, device=dev)
            pos = torch.arange(Tp, device=dev)[None, :]
            self.engine.model(ids, caches=self._slot_caches(self._kv, 0),
                              positions=pos, mask=None, logits=False)
        self._valid[0] = False
        self._cache_index[0] = 0

    def release(self) -> None:
        """Drop this engine's captured graphs and their pool (the memory
        returns to the allocator). The engine stays usable: the next
        chunk captures anew."""
        with self._lock:
            while self._inflight:
                self._drain_one()
            self._graphs.clear()

    def _init_state(self) -> None:
        """Every layer's [S, L] cache regions and the per-slot write
        index they share."""
        eng, S = self.engine, self.slots
        caches = eng.model.init_caches(S, self.L, dtype=eng.cache_dtype)
        self._kv = [(c["attn"]["k"], c["attn"]["v"]) for c in caches]
        k0 = self._kv[0][0]
        # k/v bytes one token holds in one layer (program_cost)
        self._kv_token_bytes = 2 * int(np.prod(k0.shape[2:])) * k0.element_size()
        self._cache_index = torch.zeros((S,), dtype=torch.int32, device=self.device)
        # host mirror: each slot's device write index is _slot_base plus
        # the request's tokens banked so far, less one (the last sampled
        # token is not yet fed)
        self._slot_base = [0] * S
        self.kv_bytes = sum(t.numel() * t.element_size() for kv in self._kv for t in kv)

    def _init_spec_state(self) -> None:
        """Speculation's device state, allocated once: the per-slot draft
        cache (draft mode; the target view's layout, so one write index
        serves both) and, at temperature > 0, the draft logits [S, K, V]
        the verifier reads; or the slot-aligned token ids n-gram lookup
        drafts from, with K + 1 scratch columns past L that take the
        writes past the end (no host-side filter). ``_k_eff`` [S] is the
        per-row effective K, filled before each dispatch."""
        if self.spec is None:
            return
        S, L, K = self.slots, self.L, self.spec.cfg.k
        dev = self.device
        self._k_eff = torch.full((S,), K, dtype=torch.int32, device=dev)
        self._dlg = None
        if self.spec.mode == "draft":
            self._draft_kv = self.spec.init_draft_caches(S, L)
            self._draft_fn = self.spec.build_draft_fn(self.gen)
            if self.gen.temperature > 0.0:
                V = self.engine.model.cfg.vocab_size
                self._dlg = torch.zeros((S, K, V), dtype=torch.float32, device=dev)
            self.draft_kv_bytes = sum(t.numel() * t.element_size()
                                      for kv in self._draft_kv for t in kv)
        else:
            self._ids = torch.zeros((S, L + K + 1), dtype=torch.int64, device=dev)

    def _to_device(self, a) -> torch.Tensor:
        """A host array or CPU tensor on the device without a stream sync
        (a blocking copy would wait for every chunk in flight)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # ------------------------------------------------------ device timing
    def _timer_start(self):
        """A timed dispatch's (start, end) CUDA events, the start recorded
        now, before its first launch; None without a timer or on the
        CPU. ``_timer_end`` records the end once its work is enqueued."""
        if self._timer is None or self.device.type != "cuda":
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, torch.cuda.Event(enable_timing=True)

    @staticmethod
    def _timer_end(probe) -> None:
        if probe is not None:
            probe[1].record()

    def _timer_dispatch(self, program: str, probe, cost: dict | None):
        """Note a dispatch that just returned, with its events (CUDA) and
        its cost, on a timer handle. None without a timer."""
        if self._timer is None:
            return None
        return self._timer.dispatch(program, probe, cost=cost)

    def _cost(self, program: str, *, rows: int, steps: int, frontier, k: int = 0):
        return program_cost(
            self.engine.model.cfg, program, rows=rows, steps=steps,
            frontier=frontier, k=k,
            weight_bytes=self.engine.weight_bytes,
            kv_token_bytes=self._kv_token_bytes,
        )

    # ------------------------------------------------------------ submit
    def submit(self, ids, *, max_new: int | None = None, seed: int = 0,
               priority: Priority | int | str = Priority.STANDARD,
               deadline_s: float | None = None,
               tenant: str | None = None, _hold: bool = False) -> int:
        """Enqueue one prompt (1-D token array); returns a request id.

        ``priority`` (:class:`Priority`, its value or name) orders
        admission and protects the stream under pressure. ``deadline_s``
        (seconds from now): ``DeadlineExceededError`` here when measured
        TPOT proves the decode alone cannot finish in time; later, a
        request whose deadline passes is cancelled and its ``result``
        raises the same type. ``tenant``: a billing identity kept on the
        request. Raises ``PromptTooLongError`` when prompt + budget
        cannot fit a slot, and an ``OverloadedError`` (``QueueFullError``
        / ``PoolOverloadedError``) with ``retry_after_s`` past
        ``max_queue`` pending requests, unless a strictly lower-priority
        queued request can be shed instead."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new if max_new is not None else self.gen.max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        prio = _coerce_priority(priority)
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        with self._lock:
            # a due downgrade applies before this prompt admits: it must
            # not prefill into a mode already measured as a loss
            self._maybe_self_heal()
            self._check_fit(int(ids.size), max_new)
            self._check_deadline_feasible(max_new, deadline_s)
            # expired work frees its slot and blocks before this arrival
            # competes for them
            self._expire_deadlines_locked()
            # fill free slots first, so max_queue bounds work that waits
            self._admit_waiting()
            self._check_backpressure(prio)
            rid = self._next_rid
            self._next_rid += 1
            now = time.perf_counter()
            req = _Request(
                rid=rid, ids=ids.astype(np.int64), max_new=max_new,
                seed=int(seed), submitted_at=now, priority=prio,
                deadline_s=deadline_s,
                deadline_at=None if deadline_s is None else now + deadline_s,
                tenant=str(tenant)[:128] if tenant else None,
                submitted_ns=time.time_ns(), hold=_hold, n_prompt=int(ids.size),
            )
            if deadline_s is not None:
                self._deadlined += 1
            self._requests[rid] = req
            self._admit_or_queue(req)
        return rid

    def _bucket(self, t0: int) -> int:
        return min(-(-t0 // self.prefill_block) * self.prefill_block, self.L)

    def _check_fit(self, t0: int, max_new: int) -> None:
        if t0 + max_new > self.engine.max_len:
            raise PromptTooLongError(
                f"prompt {t0} + new {max_new} exceeds engine max_len "
                f"{self.engine.max_len}"
            )
        Tp = self._bucket(t0)
        if Tp < t0 or Tp + max_new > self.L:
            raise PromptTooLongError(
                f"prompt {t0} (padded {Tp}) + new {max_new} exceeds the "
                f"slot cache region ({self.L} slots)"
            )

    # ------------------------------------------------- admission control
    def _check_deadline_feasible(self, max_new: int, deadline_s) -> None:
        """Refuse work whose deadline is provably unmeetable: ``max_new``
        tokens cost at least ``(max_new - 1) x`` measured TPOT of decode.
        With nothing measured yet, nothing is provable."""
        if deadline_s is None or self._tpot_ewma is None:
            return
        floor = (max_new - 1) * self._tpot_ewma
        if floor <= deadline_s:
            return
        self._deadline_misses += 1
        raise DeadlineExceededError(
            f"deadline {deadline_s}s is provably unmeetable: {max_new} "
            f"tokens x measured TPOT {self._tpot_ewma:.5f}s/token = "
            f"{floor:.3f}s of decode alone"
        )

    def _pool_pressure_locked(self) -> float:
        return 1.0  # contiguous slots: the queue estimate is complete

    def _retry_after_locked(self) -> float:
        """TPOT x the token backlog ahead of a new arrival / decode width
        x pool pressure, from the EWMA of this engine's finished requests
        (a fixed guess until one has finished)."""
        tpot = self._tpot_ewma if self._tpot_ewma is not None else _RETRY_TPOT_FALLBACK_S
        ahead = 0
        for r in self._slot_req:
            if r is not None and not r.done:
                ahead += max(r.max_new - len(r.tokens), 1)
        for r in self._queue:
            ahead += max(r.max_new - len(r.tokens), 1)
        eta = tpot * ahead / max(self.slots, 1)
        return round(max(eta * self._pool_pressure_locked(), tpot), 4)

    def _note_shed(self, prio: int) -> None:
        self._sheds += 1
        self._shed_by_prio[prio] = self._shed_by_prio.get(prio, 0) + 1
        self._last_shed_at = time.perf_counter()

    def _displace_for_locked(self, prio: int) -> bool:
        """Make queue room for an arrival by shedding the newest queued
        request of a strictly lower class (its ``result`` raises the
        ``OverloadedError`` it would have got at submit). False when
        nothing queued is lower: the arrival itself must shed."""
        if not self._queue:
            return False
        victim = max(self._queue, key=lambda r: (r.priority, r.rid))
        if victim.priority <= prio:
            return False
        ra = self._retry_after_locked()
        self._abort_locked(victim, OverloadedError(
            f"request {victim.rid} shed: displaced by a {_PRIO_NAMES[prio]} "
            f"admission under backpressure; retry in {ra}s",
            retry_after_s=ra, reason="displaced",
        ))
        return True

    def _abort_locked(self, req: _Request, error: BaseException) -> None:
        """Terminal failure of a queued or running request: ``failed`` set
        (``result`` raises it), queue entry removed, slot (and, paged,
        device row and blocks) freed through ``_finish``."""
        req.failed = error
        if isinstance(error, DeadlineExceededError):
            self._deadline_misses += 1
        elif isinstance(error, OverloadedError):
            self._note_shed(req.priority)
        else:
            self._cancelled += 1
        if req in self._queue:
            self._queue.remove(req)
        if req.slot is not None and not req.done:
            self._drain_for_abort(req)
        if not req.done:
            self._finish(req)

    def _drain_for_abort(self, req: _Request) -> None:
        """Before ``_finish`` of a running request: its device row stops
        (a slot's contiguous region is private and the next admission's
        prefill resets the row, so nothing needs draining). The paged
        engine retires the row and drains the chunks in flight first."""
        self._live[req.slot] = False

    def cancel(self, rid: int, *, error: BaseException | None = None) -> bool:
        """Cancel a queued or running request: its slot (and paged blocks)
        free and ``result(rid)`` raises ``error`` (a ``ServingError`` by
        default). False when the request is unknown or already done."""
        with self._lock:
            req = self._requests.get(rid)
            if req is None or req.done:
                return False
            self._abort_locked(req, error or ServingError(f"request {rid} cancelled"))
            return True

    def _expire_deadlines_locked(self) -> None:
        """Cancel queued and running requests whose deadline has passed;
        nothing to do when no live request carries one."""
        if not self._deadlined:
            return
        now = time.perf_counter()
        expired = [r for r in self._queue
                   if r.deadline_at is not None and r.deadline_at < now]
        expired += [r for r in self._slot_req
                    if r is not None and not r.done
                    and r.deadline_at is not None and r.deadline_at < now]
        for req in expired:
            self._abort_locked(req, DeadlineExceededError(
                f"request {req.rid} missed its {req.deadline_s}s deadline; "
                "cancelled", rid=req.rid,
            ))

    def _check_backpressure(self, prio: int = int(Priority.STANDARD)) -> None:
        if self.max_queue is None or self._free or len(self._queue) < self.max_queue:
            return
        if self._displace_for_locked(prio):
            return  # a lower-priority queued request was shed instead
        ra = self._retry_after_locked()
        self._note_shed(prio)
        raise QueueFullError(
            f"{len(self._queue)} requests pending (max_queue="
            f"{self.max_queue}); retry in {ra}s",
            retry_after_s=ra,
        )

    def _admit_or_queue(self, req: _Request) -> None:
        if self._free:
            self._admit(req)  # the prefill runs now
        else:
            self._queue.append(req)

    def _next_queued_locked(self) -> _Request:
        """Admission order: priority class first, FIFO (rid) within; a
        preempted request keeps its rid, so it resumes ahead of later
        arrivals of its class."""
        return min(self._queue, key=lambda r: (r.priority, r.rid))

    # --------------------------------------------------------- admission
    def _admit_waiting(self) -> None:
        while self._free and self._queue:
            req = self._next_queued_locked()
            self._queue.remove(req)
            self._admit(req)

    @torch.no_grad()
    def _admit(self, req: _Request) -> None:
        """Prefill the prompt into a free slot's region: left-padded to
        its bucket Tp, attending its fresh keys, written in place at
        slots [0, Tp) (the draft's cache too, in draft mode; the ids
        buffer in n-gram mode); the first token is sampled on the device
        and read at the next drain."""
        slot = self._free.pop()
        req.slot = slot
        self._slot_req[slot] = req
        t0 = int(req.ids.size)
        Tp = self._bucket(t0)
        dev = self.device
        buf = np.zeros((1, Tp), np.int64)
        buf[0, Tp - t0:] = req.ids
        ids = self._to_device(buf)
        real = torch.arange(Tp, device=dev) >= Tp - t0
        pos = (real.long().cumsum(dim=0) - 1).clamp_min(0)[None, :]
        qslot = torch.arange(Tp, device=dev)[:, None]
        mask = ((qslot >= qslot.T) & real[None, :])[None, None]  # key at or before query
        model = self.engine.model
        probe = self._timer_start()
        hidden, _ = model(ids, caches=self._slot_caches(self._kv, slot),
                          positions=pos, mask=mask, logits=False)
        if self.spec is not None and self.spec.mode == "draft":
            self.spec.draft.model(ids, caches=self._slot_caches(self._draft_kv, slot),
                                  positions=pos, mask=mask, logits=False)
        elif self.spec is not None:
            self._ids[slot, :Tp] = ids[0]
        self._valid[slot] = False
        self._valid[slot, :Tp] = real
        self._cache_index[slot] = Tp
        self._slot_base[slot] = Tp
        self._slot_ub[slot] = Tp
        self._start_row(slot, model.head(hidden[0, -1]), req.seed, t0,
                        req.max_new, True)
        self._note_prefill(req, "prefill", probe, self._cost(
            "prefill_chunk", rows=1, steps=Tp, frontier=[Tp]))
        self.prefill_chunks += 1
        req.prefill_chunks += 1
        req.first_token = self._stash_first(self._tok[slot])

    def _note_prefill(self, req: _Request, program: str, probe, cost) -> None:
        """Time a prefill dispatch that just returned; its handle bills
        the request."""
        self._timer_end(probe)
        req.disp = self._timer_dispatch(program, probe, cost)
        if req.disp is not None and self.metering:
            req.disp_hist.append(req.disp)

    def _slot_caches(self, kv, slot: int) -> list[dict]:
        """One slot's [1, L] views of cache (k, v) pairs, at index 0."""
        index = torch.zeros((), dtype=torch.int32, device=self.device)
        return [
            {"attn": {"k": k[slot:slot + 1], "v": v[slot:slot + 1], "index": index}}
            for k, v in kv
        ]

    def _start_row(self, slot: int, logits_row, seed: int, n_valid: int,
                   max_new: int, final: bool) -> None:
        """Sample a prefill's first token on the device and set the slot's
        per-row state: fed token, valid count, seed, budget, liveness."""
        dev = self.device
        seed_t = torch.full((1,), seed, dtype=torch.int64, device=dev)
        pos_t = torch.full((1,), n_valid, dtype=torch.int64, device=dev)
        gen = self.gen
        tok0 = sample_logits_at(logits_row[None], seed_t, pos_t,
                                gen.temperature, gen.top_k, gen.top_p)[0]
        self._tok[slot] = tok0
        self._n_valid[slot] = n_valid
        self._seed[slot] = seed
        self._remaining[slot] = max_new - 1 if final else 0
        if not final or max_new <= 1:
            self._live[slot] = False
        elif gen.eos_token_id is None:
            self._live[slot] = True
        else:
            self._live[slot] = tok0 != gen.eos_token_id

    def _stash_first(self, tok0) -> tuple:
        """Start a first token's copy to the host: (host tensor, event)."""
        if tok0.device.type != "cuda":
            return tok0.clone(), None
        host = torch.empty((), dtype=torch.int64, pin_memory=True)
        host.copy_(tok0, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _maybe_record_ttft(self, req: _Request) -> None:
        """Stamp TTFT once the first token has reached the host (the
        reference's ``is_ready`` poll, here the copy's event); an aborted
        request's TTFT is no latency and is not stamped."""
        if req.first_token_at is not None or req.first_token is None:
            return
        if req.failed is not None:
            return
        event = req.first_token[1]
        if event is None or event.query():
            req.first_token_at = time.perf_counter()
            ttft = req.first_token_at - req.submitted_at
            self._ttft_ewma = (ttft if self._ttft_ewma is None
                               else 0.8 * self._ttft_ewma + 0.2 * ttft)

    def _take_first(self, req: _Request) -> None:
        """Fold the prefill's first token into the request's stream."""
        if req.first_token is None:
            return
        host, event = req.first_token
        if event is not None:
            event.synchronize()
        self._prefill_synced(req)
        self._maybe_record_ttft(req)
        req.first_token = None
        self._append_token(req, int(host))

    def _prefill_synced(self, req: _Request) -> None:
        """The first token's copy has been waited on: its prefill dispatch
        (and every one before it) finalizes, and the request's finalized
        prefill dispatches fold into its meter (before the token is
        appended: a one-token request finishes there)."""
        if req.disp is not None and self._timer is not None:
            self._timer.drained(req.disp)
        req.disp = None
        if self.metering:
            self._meter_fold_prefill(req)

    # ------------------------------------------------------------ decode
    def _step_caches(self, index, frontier, T: int = 1) -> list[dict]:
        """Per-layer cache dicts for a T-token decode or verify pass over
        every slot, with the host bounds of the decoding rows' write
        frontiers (dead rows decode garbage that nobody reads)."""
        return [
            {"attn": {"k": kk, "v": vv, "index": index, "frontier": frontier}}
            for kk, vv in self._kv
        ]

    def _chunk_advance(self, slot: int | None = None) -> int:
        """The most positions the next chunk can advance a slot by:
        ``decode_chunk``, or ``rounds * (k + 1)`` under speculation with
        the slot's staged effective K (k_max when none is staged)."""
        if self.spec is None:
            return self.decode_chunk
        k = self.spec.cfg.k
        if slot is not None and self._k_dispatch is not None:
            k = self._k_dispatch[slot]
        return self.spec.cfg.rounds * (k + 1)

    def _frontier(self, decoding: list[int]):
        """Host ``(lo, hi)`` bounding every decoding row's write index over
        the next chunk's T == 1 steps: ``hi`` from the index's upper bound
        once the chunks in flight have run, plus the chunk's advance less
        one; ``lo`` from the tokens drained so far (it may lag, which only
        widens a windowed read)."""
        lo = min(
            self._slot_base[s] + max(len(self._slot_req[s].tokens) - 1, 0)
            for s in decoding
        )
        return lo, max(self._slot_ub[s] for s in decoding) + self._chunk_advance() - 1

    def _chunk_key(self, frontier):
        """What a chunk bakes in: the blocks each layer's blockwise read
        spans (None on the full-width read, which reads no host value)."""
        return tuple(
            blk.attn.decode_blocks(self.L, frontier)
            for blk in self.engine.model.blocks.blocks()
        )

    def _spec_key(self, frontier):
        """A spec chunk's graph key: the target's blocks for its T == 1
        frontier and for the verify pass's K + 1 queries, and the draft's
        blocks. The effective K is a device operand, not part of it."""
        K = self.spec.cfg.k
        vfront = None if frontier is None else (frontier[0], frontier[1] + K)
        key = (self._chunk_key(frontier), self._chunk_key(vfront))
        if self.spec.mode == "draft":
            key += (tuple(blk.attn.decode_blocks(self.L, frontier)
                          for blk in self.spec.draft.model.blocks.blocks()),)
        return key

    def _chunk_body(self, frontier) -> None:
        """``decode_chunk`` T == 1 steps over every slot, in place on the
        device state; step k's tokens (fill where a row is not live) go to
        ``self._out[k]``. No host read, no rebinding: a captured graph of
        this body keeps serving every later chunk."""
        model, L = self.engine.model, self.L
        gen = self.gen
        fill = gen.eos_token_id if gen.eos_token_id is not None else 0
        index, live = self._cache_index, self._live
        for k in range(self.decode_chunk):
            # the fed token's slot becomes attendable for live rows; an
            # index at capacity updates nothing (OR with False)
            at = index.long().clamp(max=L - 1)
            self._valid[self._rows, at] |= live & (index < L)
            logits, _ = model(
                self._tok[:, None],
                caches=self._step_caches(index, frontier),
                positions=self._n_valid[:, None],
                mask=self._valid[:, None, None, :],
            )
            step = live.int()
            # every row's k/v was written at its index; only live rows
            # consumed the slot
            index.add_(step)
            self._n_valid.add_(step)
            nxt = sample_logits_at(logits[:, -1], self._seed, self._n_valid,
                                   gen.temperature, gen.top_k, gen.top_p)
            self._out[k].copy_(torch.where(live, nxt, fill))
            self._remaining.sub_(step)
            ended = self._remaining <= 0
            if gen.eos_token_id is not None:
                ended = ended | (nxt == gen.eos_token_id)
            self._tok.copy_(torch.where(live, nxt, self._tok))
            live.logical_and_(~ended)

    def _spec_open_mask(self, f0):
        """History validity for the verify and draft passes, open at and
        after each row's frontier: the T == K+1 per-row attention bounds
        query t at slot ``index + t`` itself, so opening the fresh region
        admits only the pass's own causal prefix. (The paged engine
        returns None: its rows are unpadded and attend in logical
        coordinates.)"""
        ar = torch.arange(self.L, device=self.device)[None, :]
        return (self._valid | (ar >= f0[:, None]))[:, None, None, :]

    def _spec_chunk_body(self, frontier) -> None:
        """``rounds`` rounds of draft-K then verify-K+1 in one target
        weight pass, in place on the device state. Per round and live row
        it emits 1..k_eff+1 tokens (the accepted prefix, then the
        correction or bonus) and rolls the write frontier back to the
        first rejection: the write index is reset in place, the rejected
        writes sit at or past it, never become valid, and the next round
        overwrites them before reading them.

        Round r writes ``self._out[r]``: rows 0..K the emitted tokens,
        then n_emit (0 where the row was not live), n_acc (accepted
        proposals before the EOS and budget clips), fallback (n-gram
        rows with no match), n_prop (proposals the row stood behind) and
        the draft steps no row needed. No host read."""
        spec, model, gen = self.spec, self.engine.model, self.gen
        K, R, L = spec.cfg.k, spec.cfg.rounds, self.L
        eos = gen.eos_token_id
        dev = self.device
        index, live = self._cache_index, self._live
        k_eff = self._k_eff.clamp(1, K)
        idxk = torch.arange(K + 1, device=dev)
        ar = torch.arange(L, device=dev)[None, :]
        zero = torch.zeros((), dtype=torch.long, device=dev)
        for r in range(R):
            f0 = index.clone()
            live0 = live.clone()
            tok, n_valid, seed = self._tok, self._n_valid, self._seed
            mask = self._spec_open_mask(f0)
            if spec.mode == "draft":
                props, k_live, idle = self._draft_fn(
                    self._draft_kv, tok, n_valid, seed, f0, mask, k_eff,
                    live0, frontier, self._dlg)
                fb = torch.zeros_like(live0)
            else:
                props, found = ngram_propose(self._ids[:, :L], self._valid, f0,
                                             tok, K, spec.cfg.ngram)
                fb = live0 & ~found
                k_live, idle = k_eff.long(), zero
            # ONE target weight pass verifies all K proposals (+ the bonus
            # position): feed [tok, d_1..d_K]
            toks_in = torch.cat([tok[:, None], props], dim=1)
            logits, _ = model(
                toks_in, caches=self._step_caches(f0, frontier, K + 1),
                positions=n_valid.long()[:, None] + idxk[None, :], mask=mask,
            )
            n_raw, emitted = spec_verify(
                logits, props, spec.verify_key(seed, n_valid), gen.temperature,
                gen.top_k, gen.top_p, draft_logits=self._dlg, k_live=k_live)
            # draft quality before the EOS and budget clips: a clipped
            # emission is the request ending, not a rejection
            n_acc = torch.where(live0, n_raw - 1, 0)
            n_prop = torch.where(live0, k_live, 0)
            if eos is not None:
                hit = (emitted == eos) & (idxk[None, :] < n_raw[:, None])
                eos_pos = torch.where(hit, idxk[None, :], K + 1).amin(dim=1)
                n_raw = torch.minimum(n_raw, eos_pos + 1)
            n_raw = torch.minimum(n_raw, self._remaining.long().clamp_min(1))
            n_emit = torch.where(live0, n_raw, 0)
            self._remaining.sub_(n_emit.int())
            ended = self._remaining <= 0
            if eos is not None:
                ended = ended | (eos_pos < n_emit)
            tok_new = emitted.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0]
            self._valid.logical_or_((ar >= f0[:, None].long())
                                    & (ar < (f0.long() + n_emit)[:, None]))
            index.copy_(f0 + n_emit.int())
            n_valid.add_(n_emit.int())
            tok.copy_(torch.where(live0, tok_new, tok))
            live.logical_and_(~ended)
            if spec.mode == "ngram":
                # bank the fed tokens for later lookups; slots past the
                # frontier hold rejected tokens until overwritten, and
                # writes past L land in the scratch columns
                self._ids.scatter_(1, f0.long()[:, None] + idxk[None, :], toks_in)
            out = self._out[r]
            out[:K + 1].copy_(emitted.T)
            out[K + 1].copy_(n_emit)
            out[K + 2].copy_(n_acc)
            out[K + 3].copy_(fb.long())
            out[K + 4].copy_(n_prop)
            out[K + 5].copy_(idle.expand(self.slots))

    def _spec_k_array(self) -> list[int]:
        """Per-slot effective K for the next spec chunk: the controller's
        choice for occupied slots, k_max for free or parked rows (the
        device masks them by liveness)."""
        K = self.spec.cfg.k
        if self._kctl is None:
            return [K] * self.slots
        return [K if r is None else min(self._kctl.k_for(r.rid), K)
                for r in self._slot_req]

    @torch.no_grad()
    def _dispatch_decode(self, decoding: list[int]) -> None:
        """Run one chunk (a graph replay on CUDA) and start its output's
        copy to the host; the chunk joins the in-flight queue."""
        frontier = self._frontier(decoding)
        h = chaos.ACTIVE  # fault injection: disarmed, one identity test
        if h is not None:
            h.apply_sync("serving.dispatch",
                         program="decode" if self.spec is None else "spec_chunk")
        if self.spec is None:
            program = "decode"
            probe = self._timer_start()
            self._graphs.run(self._chunk_key(frontier),
                             lambda: self._chunk_body(frontier),
                             after=lambda: self._timer_end(probe))
            disp = self._timer_dispatch(program, probe, None)
            self.decode_steps += self.decode_chunk
        else:
            program = "spec_chunk"
            ks = self._k_dispatch if self._k_dispatch is not None else self._spec_k_array()
            self._k_dispatch = ks
            if self._kctl is not None:
                self._kctl.note_dispatch(ks[s] for s in decoding)
            self._k_eff.copy_(self._to_device(np.asarray(ks, np.int32)))
            probe = self._timer_start()
            self._graphs.run(self._spec_key(frontier),
                             lambda: self._spec_chunk_body(frontier),
                             after=lambda: self._timer_end(probe))
            disp = self._timer_dispatch(program, probe, None)
            cfg = self.spec.cfg
            self.verify_passes += cfg.rounds
            if self.spec.mode == "draft":
                self.draft_steps += cfg.rounds * (cfg.k + 1)
        adv = {s: self._chunk_advance(s) for s in decoding}
        self._k_dispatch = None
        self._staged_adv.clear()
        host = self._host_out[self._dispatched % len(self._host_out)]
        self._dispatched += 1
        event = None
        if self.device.type == "cuda":
            host.copy_(self._out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host.copy_(self._out)
        live = set(decoding)
        snap = tuple(
            r if s in live else None for s, r in enumerate(self._slot_req)
        )
        self._inflight.append((host, event, snap, adv, disp))
        self._advance_ub(adv)
        if disp is not None:
            # each decoding row's write frontier once this chunk has run
            disp.cost = self._cost(
                program, rows=self.slots,
                steps=self.decode_chunk if self.spec is None else self.spec.cfg.rounds,
                frontier=[self._slot_ub[s] for s in decoding],
                k=0 if self.spec is None else self.spec.cfg.k,
            )

    def _advance_ub(self, adv: dict) -> None:
        for s, n in adv.items():
            req = self._slot_req[s]
            self._slot_ub[s] = min(self._slot_ub[s] + n,
                                   self._slot_base[s] + req.max_new - 1)

    def _drain_one(self) -> None:
        """Sync the oldest chunk in flight (the one host sync), hand its
        tokens to the requests of its dispatch-time snapshot, and tighten
        each still-running slot's upper bound to its now known write index
        plus the chunks still in flight."""
        h = chaos.ACTIVE  # scripted drain stall (a worker stalling mid-decode)
        if h is not None:
            h.apply_sync("serving.drain")
        host, event, snap, _, disp = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        for req in snap:
            if req is not None:
                self._take_first(req)
        if disp is not None:
            self._timer.drained(disp)  # right after the sync: exact
            if self.metering:
                # before the tokens: a request they finish bills this chunk
                self._meter_apportion(disp, [r for r in snap if r is not None])
        toks = host.numpy()
        if self.spec is None:
            emitted = 0
            for k in range(toks.shape[0]):
                for s, req in enumerate(snap):
                    if req is not None and not req.done:
                        self._append_token(req, int(toks[k, s]))
                        emitted += 1
            self._drained_tokens += emitted
            if self._timer is not None:
                self._timer.count_tokens("decode", emitted)
        else:
            self._drain_spec(toks, snap)
        for req in snap:
            if req is not None and req.meter_deferred and not self._in_flight(req):
                req.meter_deferred = False
                self._meter_finish(req)
        for s, req in enumerate(snap):
            if req is None or req.done or self._slot_req[s] is not req:
                continue
            # a drain inside block growth (a preemption) comes after the
            # slot's bound took the next chunk's advance: keep it
            ahead = self._staged_adv.get(s, 0) + sum(
                e[3].get(s, 0) for e in self._inflight if e[2][s] is req)
            exact = self._slot_base[s] + len(req.tokens) - 1
            self._slot_ub[s] = min(self._slot_ub[s], exact + ahead)

    def _drain_spec(self, out: np.ndarray, snap) -> None:
        """One speculative chunk's output ``[R, K+1+5, S]``: per live (row,
        round) pair the emitted tokens (exactly ``n_emit`` a weight pass)
        and acceptance ``n_acc / n_prop``, which also feeds the adaptive
        controller."""
        K = self.spec.cfg.k
        rounds = emitted = accepted = proposed = 0
        for r in range(out.shape[0]):
            for s, req in enumerate(snap):
                cnt = int(out[r, K + 1, s])
                if req is None or cnt <= 0:
                    continue
                rounds += 1
                emitted += cnt
                acc, prop = int(out[r, K + 2, s]), int(out[r, K + 4, s])
                accepted += acc
                proposed += prop
                if self._kctl is not None:
                    self._kctl.observe(req.rid, prop, acc)
                if not req.done:
                    req.spec_rounds += 1
                    req.spec_proposed += prop
                    req.spec_accepted += acc
                for k in range(cnt):
                    if req.done:
                        break
                    self._append_token(req, int(out[r, k, s]))
                    self._drained_tokens += 1
        if self._timer is not None:
            self._timer.count_tokens("spec_chunk", emitted)
        self.spec_rounds_total += rounds
        self.spec_emitted_total += emitted
        self.spec_accepted_total += accepted
        self.spec_proposed_total += proposed
        self.spec_fallback_total += int(out[:, K + 3].sum())
        self.spec_idle_draft_steps += int(out[:, K + 5, 0].sum())
        if proposed and self.spec.cfg.self_heal_accept is not None:
            # recent acceptance for the self-healing gate: the lifetime
            # totals would take long to show a draft that went bad
            lam = self.spec.cfg.ewma
            a = accepted / proposed
            self._heal_acc = (a if self._heal_acc is None
                              else (1.0 - lam) * self._heal_acc + lam * a)
            self._heal_proposed += proposed

    def _maybe_self_heal(self) -> None:
        """Downgrade the speculation mode (draft -> n-gram -> off) when the
        acceptance EWMA sits below ``SpecConfig.self_heal_accept`` after
        at least ``HEAL_MIN_PROPOSED`` verified proposals. Only when the
        device is idle (no live slot, no chunk in flight, no pending
        prefill): the old mode's graphs and their pool are dropped and the
        speculation state rebuilt, which must never happen under a
        dispatched chunk. Queued requests admit under the new mode. The
        KV caches stay (the target's k/v do not depend on the mode). Mode
        counters restart; ``stats()["spec_self_healed"]`` keeps what
        happened. Caller holds the scheduler lock."""
        spec = self.spec
        if spec is None or spec.cfg.self_heal_accept is None:
            return
        if self._heal_acc is None or self._heal_proposed < HEAL_MIN_PROPOSED:
            return
        if self._heal_acc >= spec.cfg.self_heal_accept:
            return
        if any(r is not None for r in self._slot_req) or self._inflight:
            return
        if self._pending_prefills():
            return
        to = "ngram" if spec.mode == "draft" else "nonspec"
        self.spec_self_healed = {
            "from": spec.mode, "to": to,
            "acceptance": round(self._heal_acc, 4),
            "proposed": self._heal_proposed,
        }
        self.spec_self_heal_total += 1
        if to == "ngram":
            self.spec = SpeculativeDecoder(self.engine, None, spec.cfg)
            if self._kctl is not None:
                # proposals are free now, and the bad draft's acceptance
                # says nothing about n-gram
                self._kctl = AdaptiveKController(spec.cfg, draft_cost=0.0)
        else:
            self.spec = None
            self._kctl = None
        self.spec_rounds_total = 0
        self.spec_emitted_total = 0
        self.spec_accepted_total = 0
        self.spec_proposed_total = 0
        self.spec_fallback_total = 0
        self.spec_idle_draft_steps = 0
        self._heal_acc = None
        self._heal_proposed = 0
        self._k_dispatch = None
        # the old mode's graphs (and the draft cache they read) go before
        # the new mode allocates and captures
        self._graphs.clear()
        for name in ("_draft_kv", "_draft_fn", "_dlg", "_ids", "_k_eff"):
            self.__dict__.pop(name, None)
        self._init_out()
        self._init_spec_state()

    def _pending_prefills(self) -> int:
        return 0  # the paged engine: its chunked-prefill queue

    # ---------------------------------------------------------- metering
    def _in_flight(self, req: _Request) -> bool:
        """A chunk still in flight was dispatched for ``req``."""
        return any(r is req for e in self._inflight for r in e[2])

    def _meter_apportion(self, disp, served) -> None:
        """Split one drained chunk's busy seconds, flops and bytes equally
        over the rows it was dispatched for: a row bills the lane it held
        (the chunk's cost did not depend on how many rows emitted). Every
        row of the dispatch-time snapshot bills, also one whose request
        ended in an earlier chunk, so every chunk bills some request."""
        if not served:
            return
        share = 1.0 / len(served)
        cost = disp.cost or {}
        busy = disp.busy_s * share
        fl = cost.get("flops", 0.0) * share
        by = cost.get("bytes", 0.0) * share
        for req in served:
            req.busy_s += busy
            req.flops += fl
            req.hbm_bytes += by

    def _meter_fold_prefill(self, req: _Request) -> None:
        """Fold the request's finalized prefill dispatches into its meter:
        a prefill dispatch serves one request and bills it whole. A
        handle not yet finalized stays parked."""
        rest = []
        for d in req.disp_hist:
            if not d.done:
                rest.append(d)
                continue
            req.busy_s += d.busy_s
            if d.cost:
                req.flops += d.cost.get("flops", 0.0)
                req.hbm_bytes += d.cost.get("bytes", 0.0)
        req.disp_hist = rest

    def _meter_kv(self, req: _Request, blocks: int | None = None) -> None:
        """Integrate KV block-seconds: fold the (blocks x elapsed)
        rectangle since the last change in holding, then anchor at the new
        count (paged: alloc, grow, preempt, finish)."""
        now = time.perf_counter()
        if req.kv_anchor is not None:
            req.kv_block_s += req.kv_blocks_now * (now - req.kv_anchor)
        req.kv_anchor = now
        if blocks is not None:
            req.kv_blocks_now = int(blocks)

    def _meter_finish(self, req: _Request, kind: str | None = None) -> None:
        """Freeze a finished request's accumulators into the meter a
        receipt is built from (``runtime/ledger.py build_receipt``); the
        wall-clock window runs from its submission to now."""
        self._meter_fold_prefill(req)
        t0 = (req.submitted_ns or time.time_ns()) / 1e9
        meter = {
            "rid": req.rid,
            "tenant": req.tenant or "anonymous",
            "kind": kind or self.meter_kind,
            "t_start": t0,
            "t_end": t0 + max(time.perf_counter() - req.submitted_at, 0.0),
            "prompt_tokens": req.n_prompt,
            "emitted_tokens": len(req.tokens),
            "busy_s": req.busy_s,
            "flops": req.flops,
            "hbm_bytes": req.hbm_bytes,
            "kv_block_s": req.kv_block_s,
            "wire_bytes": req.wire_bytes,
        }
        self._meter_log[req.rid] = meter
        while len(self._meter_log) > 4 * self.keep_results:
            self._meter_log.popitem(last=False)
        self._meter_fresh.append(meter)
        self._metered_total += 1

    def meter(self, rid: int) -> dict | None:
        """The finished request's meter: None until it is written (once
        the last chunk that served the request has drained) or after
        bounded eviction."""
        with self._lock:
            return self._meter_log.get(rid)

    def drain_meters(self, limit: int = 64) -> list[dict]:
        """Up to ``limit`` written meters not drained before; each is
        handed out once."""
        out: list[dict] = []
        with self._lock:
            while self._meter_fresh and len(out) < limit:
                out.append(self._meter_fresh.popleft())
        return out

    # ---------------------------------------------------------- lifetime
    def _finish(self, req: _Request) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        if self.metering:
            self._meter_fold_prefill(req)
            self._meter_kv(req, 0)
            if self._in_flight(req):
                req.meter_deferred = True
            else:
                self._meter_finish(req)
        req.ids = None
        slot = req.slot
        if slot is not None and self._slot_req[slot] is req:
            self._slot_req[slot] = None
            self._free.append(slot)
        if req.deadline_at is not None:
            self._deadlined = max(self._deadlined - 1, 0)
        # measured TPOT (deadline floor, retry-after): aborted requests
        # are left out, their finish time is the abort's
        if req.failed is None and req.first_token_at is not None and len(req.tokens) > 1:
            tpot = (req.finished_at - req.first_token_at) / (len(req.tokens) - 1)
            self._tpot_ewma = (tpot if self._tpot_ewma is None
                               else 0.8 * self._tpot_ewma + 0.2 * tpot)
        if self._kctl is not None:
            self._kctl.forget(req.rid)
        # bounded result retention: a steady stream must not grow host
        # memory forever
        self._done_order.append(req.rid)
        while len(self._done_order) > self.keep_results:
            self._requests.pop(self._done_order.popleft(), None)

    def _append_token(self, req: _Request, tok: int) -> None:
        if req.done:
            return
        req.tokens.append(int(tok))
        eos = self.gen.eos_token_id
        if len(req.tokens) >= req.max_new or (eos is not None and tok == eos):
            self._finish(req)

    # -------------------------------------------------------------- loop
    def _prefill_step(self) -> None:
        """Prefill work a scheduler step runs besides admission (the
        paged engine's one chunk)."""

    def _decoding_slots(self) -> list[int]:
        return [s for s, r in enumerate(self._slot_req) if r is not None]

    def _busy(self) -> bool:
        """Work besides decoding that keeps the scheduler going."""
        return bool(self._queue)

    def step(self) -> bool:
        """One scheduler iteration: expire deadlines, admit waiting
        prompts, run the step's prefill work, dispatch one decode chunk,
        then drain the oldest chunks until ``pipeline_depth`` stay in
        flight (all of them when nothing was dispatched). Returns False
        when fully idle."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        t_start = time.perf_counter()
        chunks0, drained0 = self.prefill_chunks, self._drained_tokens
        self._maybe_self_heal()
        self._expire_deadlines_locked()
        self._admit_waiting()
        self._prefill_step()
        decoding = self._decoding_slots()
        if decoding:
            self._dispatch_decode(decoding)
        # a staged masked-K array or advance must not leak into a later step
        self._k_dispatch = None
        self._staged_adv.clear()
        for r in self._slot_req:
            if r is not None:
                self._maybe_record_ttft(r)
        if self._timer is not None:
            self._timer.poll()  # finalize what has completed, no sync
        prefilled = self.prefill_chunks != chunks0
        busy = bool(decoding) or prefilled
        while len(self._inflight) > (self.pipeline_depth if busy else 0):
            self._drain_one()
        if not busy:
            self._maybe_self_heal()  # just drained fully idle
        if decoding and not prefilled:
            self.decode_only_s += time.perf_counter() - t_start
            self.decode_only_tokens += self._drained_tokens - drained0
        return busy or bool(self._inflight) or self._busy()

    def result(self, rid: int, *, timeout_s: float | None = None,
               deadline_s: float | None = None) -> np.ndarray:
        """Drive the loop until request ``rid`` finishes; its tokens.

        ``deadline_s`` bounds the wait with cancellation: past it the
        request is aborted (slot and blocks freed) and
        ``DeadlineExceededError`` raised. ``timeout_s`` raises
        ``TimeoutError`` and leaves the request running. A request that
        was shed, cancelled or missed its deadline raises that failure."""
        with self._lock:
            req = self._requests.get(rid)
        if req is None:
            raise KeyError(
                f"unknown request id {rid} (never submitted, or its result "
                f"was evicted after {self.keep_results} newer completions)"
            )
        now = time.perf_counter()
        cancel_at = None if deadline_s is None else now + deadline_s
        timeout_at = None if timeout_s is None else now + timeout_s
        while not req.done:
            if not self.step() and not req.done:
                raise ServingError(
                    f"request {rid} cannot complete: scheduler idle"
                )
            now = time.perf_counter()
            if cancel_at is not None and now > cancel_at and not req.done:
                err = DeadlineExceededError(
                    f"request {rid} not done within deadline_s={deadline_s}; "
                    "cancelled and freed", rid=rid,
                )
                if self.cancel(rid, error=err):
                    raise err
                continue  # finished meanwhile: fall through to its outcome
            if timeout_at is not None and now > timeout_at and not req.done:
                raise TimeoutError(f"request {rid} not done in {timeout_s}s")
        if req.failed is not None:
            raise req.failed
        return np.asarray(req.tokens, np.int64)

    async def asubmit(self, ids, *, max_new: int | None = None, seed: int = 0,
                      priority: Priority | int | str = Priority.STANDARD,
                      deadline_s: float | None = None,
                      tenant: str | None = None) -> int:
        """``submit`` in the running loop's executor: admission runs a
        prefill and may wait on a pump thread holding the scheduler lock,
        neither of which belongs on an event loop."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: self.submit(
            ids, max_new=max_new, seed=seed, priority=priority,
            deadline_s=deadline_s, tenant=tenant))

    async def aresult(self, rid: int, *, timeout_s: float | None = None,
                      deadline_s: float | None = None) -> np.ndarray:
        """``result`` in the running loop's executor: the scheduler is
        pumped from a worker thread, so an event loop keeps serving while
        a request generates. Concurrent calls serialize on the scheduler
        lock."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: self.result(
            rid, timeout_s=timeout_s, deadline_s=deadline_s))

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def timings(self, rid: int) -> dict:
        """Host-clock seconds from submit to the first token and to the
        last, for a finished (or running) request."""
        req = self._requests[rid]
        t0 = req.submitted_at
        return {
            "ttft_s": None if req.first_token_at is None else req.first_token_at - t0,
            "total_s": None if req.finished_at is None else req.finished_at - t0,
            "tokens": len(req.tokens),
            "prefill_chunks": req.prefill_chunks,
        }

    def _spec_stats(self) -> dict:
        """Speculation counters under the reference's keys. A weight pass
        is one (live row, verify round) pair, so accepted tokens per
        weight pass > 1 is the gain over plain decode. Port keys besides:
        ``verify_passes`` and ``draft_steps`` dispatched, and
        ``idle_draft_steps`` (draft steps no row needed, which the
        reference skips and a captured chunk runs masked)."""
        prop = self.spec_proposed_total
        wp = self.spec_rounds_total
        out = {
            "mode": self.spec.mode,
            "k": self.spec.cfg.k,
            "rounds": self.spec.cfg.rounds,
            "weight_passes": wp,
            "emitted_tokens": self.spec_emitted_total,
            "accepted_total": self.spec_accepted_total,
            "proposed_total": prop,
            "acceptance_rate": (round(self.spec_accepted_total / prop, 4)
                                if prop else 0.0),
            "accepted_tokens_per_weight_pass": (
                round(self.spec_emitted_total / wp, 4) if wp else 0.0),
            "fallback_total": self.spec_fallback_total,
            "live_requests": {
                r.rid: round(r.spec_accepted / r.spec_proposed, 4)
                for r in self._slot_req if r is not None and r.spec_proposed
            },
            "adaptive": self._kctl is not None,
            "verify_passes": self.verify_passes,
            "draft_steps": self.draft_steps,
            "idle_draft_steps": self.spec_idle_draft_steps,
        }
        if self._kctl is not None:
            out["k_mean"] = round(self._kctl.k_mean(), 3)
            out["k_prior"] = self._kctl.prior()
        return out

    def stats(self) -> dict:
        """Host-side scheduler snapshot: occupancy, the decode graphs'
        counters (graphs held, captured, capture s, replays, pool bytes),
        admission control and, when on, speculation."""
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        adm: dict = {
            "retry_after_s": self._retry_after_locked(),
            "shed_total": self._sheds,
            "deadline_miss_total": self._deadline_misses,
            "cancelled_total": self._cancelled,
        }
        if self._tpot_ewma is not None:
            adm["tpot_ewma_s"] = round(self._tpot_ewma, 6)
        if self._ttft_ewma is not None:
            adm["ttft_ewma_s"] = round(self._ttft_ewma, 6)
        if self._sheds:
            adm["shed_by_priority"] = {
                _PRIO_NAMES[p]: n for p, n in sorted(self._shed_by_prio.items())
            }
            adm["last_shed_age_s"] = round(time.perf_counter() - self._last_shed_at, 3)
        out = {
            "slots": self.slots,
            "busy_slots": sum(r is not None for r in self._slot_req),
            "queued": len(self._queue),
            "requests": len(self._requests),
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "inflight_chunks": len(self._inflight),
            "graphs": self._graphs.stats(),
            "admission": adm,
        }
        if self.spec is not None:
            out["spec"] = self._spec_stats()
        if self.spec_self_healed is not None:
            out["spec_self_healed"] = self.spec_self_healed
            out["spec_self_heal_total"] = self.spec_self_heal_total
        out["compile"] = compile_report()
        if self._autotune is not None:
            out["autotune"] = {"key": self._autotune_key,
                               "extras_dropped": self._autotune_dropped,
                               **self._autotune.counts}
        if self.autotune_warm_start_s is not None:
            out["autotune_warm_start_s"] = self.autotune_warm_start_s
        out["metering"] = {
            "enabled": self.metering,
            "metered_total": self._metered_total,
            "undrained": len(self._meter_fresh),
        }
        dt = self._device_time_locked()
        if dt is not None:
            out["device_time"] = dt
        return out

    def _device_time_locked(self) -> dict | None:
        """The timer's snapshot, each program with its MFU and MBU where a
        ``capability`` record gives the card's peaks (the flops and bytes
        its finalized dispatches moved over their busy seconds)."""
        if self._timer is None:
            return None
        snap = self._timer.snapshot()
        cap = self.capability or {}
        for rec in snap["programs"].values():
            if rec["busy_s"] <= 0:
                continue
            if rec.get("flops") and cap.get("peak_tflops"):
                rec["mfu"] = round(rec["flops"] / rec["busy_s"]
                                   / (cap["peak_tflops"] * 1e12), 4)
            if rec.get("bytes") and cap.get("hbm_gbps"):
                rec["mbu"] = round(rec["bytes"] / rec["busy_s"]
                                   / (cap["hbm_gbps"] * 1e9), 4)
        return snap

    def device_time(self) -> dict | None:
        """Per-program device-busy and host-gap attribution (locked)."""
        with self._lock:
            return self._device_time_locked()


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged KV cache on one device.

    ``slots``: decode batch width. ``decode_chunk``: T == 1 steps per
    scheduler step. ``block_size``: tokens per KV block; it must divide
    the engine's cache length. ``num_blocks`` defaults to
    ``slots * cache_len / block_size`` (never tighter than one full view
    per slot). ``prefill_chunk``: tokens per prefill program.
    ``prefix_cache``: share resident prompt prefixes. ``kv_quant``:
    None or "int8" pools. ``max_queue``: pending admissions beyond which
    ``submit`` sheds with an ``OverloadedError``. The other arguments
    are the contiguous engine's (``speculative``, ``draft``: the draft's
    cache is contiguous per slot even here, at the view's width).
    """

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefill_chunk: int = 32,
        prefix_cache: bool = True,
        kv_quant: str | None = None,
        **kw,
    ):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} (None or 'int8')")
        self.block_size = int(block_size)
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_cache = bool(prefix_cache)
        self.kv_quant = kv_quant
        self._num_blocks_arg = num_blocks
        super().__init__(engine, **kw)

    def _init_state(self) -> None:
        eng, S, L, bs = self.engine, self.slots, self.L, self.block_size
        if L % bs:
            raise ValueError(
                f"block_size {bs} must divide the cache view width {L}"
            )
        self.max_blocks = MB = L // bs
        nb = self._num_blocks_arg
        self.pool = BlockPool(S * MB if nb is None else int(nb), bs)
        self.index = PrefixIndex(bs) if self.prefix_cache else None
        if self.index is not None:
            self.pool.evict_hook = self.index.forget_block
        caches = [
            blk.attn.init_paged_cache(
                self.pool.num_blocks, bs, S, MB, dtype=eng.cache_dtype,
                quant=self.kv_quant, device=self.device,
            )
            for blk in eng.model.blocks.blocks()
        ]
        # one write index and one block table serve every layer (the JAX
        # package keeps a copy per layer; they are always equal)
        self._cache_index = caches[0]["index"]
        self._block_table = caches[0]["block_table"]
        self._pools = [
            {name: c[name] for name in c if name not in ("index", "block_table")}
            for c in caches
        ]
        self.kv_block_bytes = sum(
            int(np.prod(t.shape[1:])) * t.element_size()
            for p in self._pools for t in p.values()
        )
        self._kv_token_bytes = sum(
            int(np.prod(t.shape[2:])) * t.element_size() for t in self._pools[0].values()
        )
        # engine geometry import_prefill validates payloads against
        self._n_layers = len(self._pools)
        self._block_shape = tuple(self._pools[0]["k"].shape[1:])  # (bs, Hkv, D)
        # disaggregated-serving counts (prefill_export / import_prefill /
        # note_disagg_transfer): stats()["disagg"]
        self.disagg: dict[str, int] = {
            "exports": 0, "export_blocks": 0, "export_tokens": 0,
            "imports": 0, "import_blocks": 0, "import_tokens": 0,
            "fallbacks": 0,
        }
        self._disagg_ewma: dict[str, float] = {}
        self._slot_blocks: list[list[int]] = [[] for _ in range(S)]
        self._slot_ub = [0] * S  # device write-frontier upper bound
        # the device write index is _slot_base + tokens banked - 1 (the
        # base: the prefill's length less the tokens banked before it)
        self._slot_base = [0] * S
        self._slot_limit = [0] * S  # prompt + budget cap, in tokens
        self._pending: dict[int, dict] = {}  # slot -> prefill job
        self.prefix_matched_tokens = 0
        self.prompt_tokens_total = 0
        self.prefilled_tokens = 0
        self.peak_blocks_in_use = 0
        self.cow_copies = 0
        self.preemptions = 0

    def _autotune_buckets(self) -> tuple[int, ...]:
        # one chunk width serves every prompt: it is the bucket set
        return (self.prefill_chunk,)

    @torch.no_grad()
    def _warm(self) -> None:
        """One prefill chunk at construction, through slot 0's row while
        it points at the scratch block (its writes land there): the
        libraries build and the allocator warms."""
        C, dev = self.prefill_chunk, self.device
        index = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.engine.model(torch.zeros((1, C), dtype=torch.int64, device=dev),
                          caches=self._caches(index, self._block_table[:1], C),
                          positions=torch.arange(C, device=dev)[None, :],
                          mask=None, logits=False)

    def _pending_prefills(self) -> int:
        return len(self._pending)

    def _check_fit(self, t0: int, max_new: int) -> None:
        if t0 + max_new > self.engine.max_len:
            raise PromptTooLongError(
                f"prompt {t0} + new {max_new} exceeds engine max_len "
                f"{self.engine.max_len}"
            )
        if t0 + max_new > self.L:
            raise PromptTooLongError(
                f"prompt {t0} + new {max_new} exceeds the block-table "
                f"view ({self.L} positions)"
            )
        need = -(-(t0 + max_new) // self.block_size)
        if need > self.pool.num_blocks:
            raise PoolExhaustedError(
                f"request worst case is {need} blocks of {self.block_size} "
                f"tokens; the pool holds {self.pool.num_blocks} total"
            )

    def _pool_pressure_locked(self) -> float:
        # a near-full pool inflates the retry-after: freed capacity is
        # contended by every queued request
        util = self.pool.in_use / self.pool.num_blocks
        return min(4.0, 1.0 / max(1.0 - util, 0.25))

    def _check_backpressure(self, prio: int = int(Priority.STANDARD)) -> None:
        if self.max_queue is None or len(self._queue) < self.max_queue:
            return
        if self._free:
            # slots are free yet admissions back up: the queue is starved
            # on KV blocks, not on decode width
            if self._displace_for_locked(prio):
                return
            ra = self._retry_after_locked()
            self._note_shed(prio)
            raise PoolOverloadedError(
                f"{len(self._queue)} requests pending on KV blocks "
                f"({self.pool.in_use}/{self.pool.num_blocks} in use, "
                f"max_queue={self.max_queue}); retry in {ra}s",
                retry_after_s=ra,
            )
        super()._check_backpressure(prio)

    def _admit_or_queue(self, req: _Request) -> None:
        # queue first, then drain in (priority, rid) order: a non-empty
        # queue means its best head is starved on blocks, and only a
        # strictly higher-priority arrival may pass it
        self._queue.append(req)
        self._admit_waiting()

    def _admit_waiting(self) -> None:
        # (priority, FIFO within a class): when the best head cannot get
        # blocks, preempt strictly lower-priority running work for it;
        # with no such victim, everyone behind it waits too
        while self._free and self._queue:
            head = self._next_queued_locked()
            if self._try_admit(head):
                self._queue.remove(head)
                continue
            victims = [s for s, r in enumerate(self._slot_req)
                       if r is not None and r.priority > head.priority]
            if not victims:
                break
            # priority, then newest: the order pool pressure uses
            self._preempt(max(victims, key=lambda s: (
                self._slot_req[s].priority, self._slot_req[s].rid)))

    @torch.no_grad()
    def _try_admit(self, req: _Request) -> bool:
        """Map a request into a free slot: prefix-match, retain/COW shared
        blocks, allocate the rest, point the device block table, and
        queue the chunked prefill. False when the pool cannot cover the
        prompt right now."""
        if req.tokens:
            # preemption resume: re-prefill prompt + banked tokens
            ids_full = np.concatenate([req.ids, np.asarray(req.tokens)])
        else:
            ids_full = req.ids
        ids_full = ids_full.astype(np.int64)
        t0 = len(ids_full)
        max_new_eff = req.max_new - len(req.tokens)
        bs = self.block_size
        hits: list[int] = []
        nmatch = 0
        tail = None
        if self.index is not None:
            # never match the whole prompt: the final token must prefill
            # so its logits can seed the first sample
            hits, nmatch, tail = self.index.match(ids_full, max_tokens=t0 - 1)
        n_new = -(-t0 // bs) - len(hits) - (1 if tail is not None else 0)
        taken: list[int] = []
        cow_src = None
        tail_bid = None
        try:
            for b in hits:
                # a hit raises the block's eviction class to its most
                # protected consumer
                self.pool.retain(b, priority=req.priority)
                taken.append(b)
            if tail is not None:
                bid, _fill = tail
                if self.pool.refcount(bid) == 0:
                    # sole owner: revive and extend in place
                    self.pool.retain(bid, priority=req.priority)
                    taken.append(bid)
                    tail_bid = bid
                else:
                    # live sharers: copy-on-write before writing into it
                    (tail_bid,) = self.pool.alloc(1)
                    taken.append(tail_bid)
                    cow_src = bid
            new_blocks = self.pool.alloc(n_new) if n_new > 0 else []
            taken.extend(new_blocks)
        except PoolExhaustedError:
            for b in reversed(taken):
                self.pool.release(b)
            return False
        slot = self._free.pop()
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_blocks[slot] = (
            hits + ([tail_bid] if tail is not None else []) + new_blocks
        )
        if self.metering:
            self._meter_kv(req, len(self._slot_blocks[slot]))
        self._slot_limit[slot] = min(t0 + max_new_eff, self.L)
        self._slot_ub[slot] = t0
        self._slot_base[slot] = t0 - len(req.tokens)
        if cow_src is not None:
            for pool in self._pools:
                for arr in pool.values():
                    arr[tail_bid] = arr[cow_src]
            self.cow_copies += 1
        self._set_row(slot, start=nmatch)
        self._pending[slot] = {
            "ids": ids_full, "pos": nmatch, "seed": req.seed,
            "max_new": max_new_eff,
        }
        self.prompt_tokens_total += t0
        self.prefix_matched_tokens += nmatch
        self.prefilled_tokens += t0 - nmatch
        return True

    def _set_row(self, slot: int, start: int | None = None) -> None:
        """Point the slot's device block-table row at its blocks; at
        admission also reset its write index to the first position the
        request will write (a parked index could alias a shared block)."""
        row = np.full((self.max_blocks,), self.pool.num_blocks, np.int32)
        blocks = self._slot_blocks[slot]
        row[: len(blocks)] = blocks
        self._block_table[slot] = self._to_device(row)
        if start is not None:
            self._cache_index[slot] = start

    def _step_caches(self, index, frontier, T: int = 1) -> list[dict]:
        return self._caches(index, self._block_table, T)

    def _frontier(self, decoding: list[int]):
        return None  # the paged read takes its bounds from the device

    def _chunk_key(self, frontier):
        return ()  # the chunk reads no host value: one graph

    def _advance_ub(self, adv: dict) -> None:
        pass  # ``_grow_blocks`` advanced it before the dispatch

    def _spec_open_mask(self, f0):
        return None  # unpadded rows, causality in logical coordinates

    def _caches(self, index, block_table, T):
        """Per-layer cache dicts over the shared pools, with the write
        slots computed once for every layer."""
        slots = paged_write_slots(
            index, block_table, T, self.pool.num_blocks, self.block_size
        )
        return [
            {"attn": {**pool, "index": index, "block_table": block_table,
                      "write_slots": slots}}
            for pool in self._pools
        ]

    @torch.no_grad()
    def _dispatch_prefill_chunk(self) -> bool:
        """At most ONE chunk per scheduler step, so decode interleaves."""
        if not self._pending:
            return False
        # SLO order for the one chunk a step too: an INTERACTIVE prompt's
        # TTFT does not wait behind a BATCH prompt's remaining chunks
        slot = min(self._pending, key=lambda s: (self._slot_req[s].priority,
                                                 self._slot_req[s].rid))
        job = self._pending[slot]
        ids, pos = job["ids"], job["pos"]
        C = self.prefill_chunk
        nreal = min(C, len(ids) - pos)
        buf = np.zeros((1, C), np.int64)
        buf[0, :nreal] = ids[pos:pos + nreal]
        is_final = pos + nreal >= len(ids)
        dev = self.device
        index = torch.full((1,), pos, dtype=torch.int32, device=dev)
        bt = self._block_table[slot:slot + 1]
        positions = (pos + torch.arange(C, device=dev))[None, :]
        # mask=None: the paged path builds causality (and the window
        # band) in logical coordinates; pad tokens past nreal write
        # blocks the decode steps overwrite before reading
        ids_dev = self._to_device(buf)
        req = self._slot_req[slot]
        probe = self._timer_start()
        hidden, _ = self.engine.model(
            ids_dev, caches=self._caches(index, bt, C),
            positions=positions, mask=None, logits=False,
        )
        if self.spec is not None and self.spec.mode == "draft":
            # the draft prefills the same chunk into its contiguous slot
            # row (per-row index form: writes past the row drop); paged
            # rows are unpadded, so slot order is logical order
            dcaches = [
                {"attn": {"k": k[slot:slot + 1], "v": v[slot:slot + 1],
                          "index": index}}
                for k, v in self._draft_kv
            ]
            self.spec.draft.model(ids_dev, caches=dcaches, positions=positions,
                                  mask=None, logits=False)
        elif self.spec is not None:
            # n-gram ids at their logical positions (the pad tail past
            # nreal is overwritten later and never valid)
            n = min(C, self.L - pos)
            self._ids[slot, pos:pos + n] = ids_dev[0, :n]
        n_end = pos + nreal
        self._cache_index[slot] = n_end
        self._valid[slot] = torch.arange(self.L, device=dev) < n_end
        # a held row's final chunk samples the first token but leaves the
        # row off on the device (nothing decodes it)
        self._start_row(slot, self.engine.model.head(hidden[0, nreal - 1]),
                        job["seed"], n_end, job["max_new"], is_final and not req.hold)
        self._note_prefill(req, "prefill_chunk", probe, self._cost(
            "prefill_chunk", rows=1, steps=C, frontier=[pos + C]))
        self.prefill_chunks += 1
        job["pos"] = n_end
        req.prefill_chunks += 1
        if is_final:
            if req.hold:
                # the held row's table goes to the sentinel: the decode
                # chunks still write every row's k/v at its index, and
                # this row's would land in its prompt's last block; they
                # go to the scratch block instead (export reads the
                # blocks by id, not through the table)
                self._block_table[slot] = self.pool.num_blocks
            del self._pending[slot]
            self._slot_ub[slot] = len(ids)
            if self.index is not None:
                # register the PROMPT prefix as soon as its blocks are
                # written: a concurrent request sharing it hits at once;
                # under pressure the pool evicts BATCH-cached prefixes
                # before STANDARD before INTERACTIVE
                for b in self.index.register(req.ids, self._slot_blocks[slot]):
                    self.pool.mark_cached(b, priority=req.priority)
            req.first_token = self._stash_first(self._tok[slot])
        return True

    def _retire_row(self, slot: int) -> None:
        """Kill a slot on the device: live off, valid row cleared, block
        table to the sentinel so later writes through it drop."""
        self._block_table[slot] = self.pool.num_blocks
        self._live[slot] = False
        self._valid[slot] = False

    def _release_slot_blocks(self, slot: int) -> None:
        for b in self._slot_blocks[slot]:
            self.pool.release(b)
        self._slot_blocks[slot] = []
        self._slot_ub[slot] = 0
        self._staged_adv.pop(slot, None)
        self._slot_limit[slot] = 0
        self._pending.pop(slot, None)

    def _finish(self, req: _Request) -> None:
        slot = req.slot
        owned = slot is not None and self._slot_req[slot] is req
        super()._finish(req)
        if owned:
            # retire BEFORE the blocks go back to the pool
            self._retire_row(slot)
            self._release_slot_blocks(slot)

    def _preempt(self, slot: int) -> None:
        """Evict a live request to free its blocks and re-queue it; it
        re-prefills prompt + banked tokens and continues token-identical.
        The row retires on the device first (later chunks drop its
        writes), then every chunk in flight drains (their tokens are
        genuine, and may finish the request), then the blocks go back."""
        req = self._slot_req[slot]
        self.preemptions += 1
        self._retire_row(slot)
        while self._inflight:
            self._drain_one()
        if req.done:
            return  # finished in flight; _finish freed everything
        self._release_slot_blocks(slot)
        if self.metering:
            self._meter_kv(req, 0)  # holds nothing while re-queued
        self._slot_req[slot] = None
        req.slot = None
        self._free.append(slot)
        # (priority, rid) ordering: it resumes ahead of later arrivals of
        # its class because it keeps its rid
        self._queue.append(req)

    def _drain_for_abort(self, req: _Request) -> None:
        """As ``_preempt``: retire the device row first (later chunks drop
        its writes), then drain every chunk in flight; only then may
        ``_finish`` return the slot's blocks to the pool, since a chunk
        dispatched before the retire could still write through the old
        table."""
        self._retire_row(req.slot)
        while self._inflight:
            self._drain_one()

    def _alloc_with_preemption(self, n: int, protect: int):
        """Allocate ``n`` blocks, preempting under pressure in
        priority-then-newest order: the newest request of the least
        protected class among the others (BATCH before STANDARD before
        INTERACTIVE). None when ``protect`` itself had to go."""
        while True:
            try:
                return self.pool.alloc(n)
            except PoolExhaustedError:
                victims = [
                    s for s, r in enumerate(self._slot_req)
                    if r is not None and s != protect
                ]
                if not victims:
                    self._preempt(protect)
                    return None
                self._preempt(max(victims, key=lambda s: (
                    self._slot_req[s].priority, self._slot_req[s].rid)))

    def _grow_blocks(self, decoding: list[int]) -> list[int]:
        """Extend block tables ahead of the decode write frontier: the
        next chunk advances each live row by up to ``_chunk_advance``
        positions (``decode_chunk``, or ``rounds * (k_eff + 1)`` under
        speculation, with the staged effective K the dispatch will carry),
        so the blocks must exist before it is dispatched. ``_slot_ub``
        moves by that bound at every dispatch, so it covers the chunks
        still in flight, whose tokens the host has not seen; a drain
        tightens it to the known index plus the chunks still in flight
        (rejected rounds advance less than the bound). Rejected writes
        past the frontier land in blocks the row owns or, past its table,
        in the scratch block. Returns the decoding set minus any
        preempted slots."""
        bs = self.block_size
        for slot in decoding:
            req = self._slot_req[slot]
            if req is None or slot in self._pending:
                continue  # preempted (or re-queued) by an earlier growth
            target = min(
                self._slot_ub[slot] + self._chunk_advance(slot),
                self._slot_limit[slot],
            )
            need = -(-target // bs)
            have = len(self._slot_blocks[slot])
            if need > have:
                got = self._alloc_with_preemption(need - have, slot)
                if got is None:
                    continue  # the slot itself was evicted
                self._slot_blocks[slot].extend(got)
                self._set_row(slot)
                if self.metering:
                    self._meter_kv(req, len(self._slot_blocks[slot]))
            self._slot_ub[slot] = target
            self._staged_adv[slot] = self._chunk_advance(slot)
        return [
            s for s in decoding
            if self._slot_req[s] is not None and s not in self._pending
        ]

    # ------------------------------------------- disaggregated serving
    # The paged KV block is the wire unit: prefill_export runs chunked
    # prefill into the local pools and reads back only the request's
    # filled blocks ([n_blocks, block_size, Hkv, D] a layer, never a
    # contiguous cache); import_prefill on the decode leg allocates local
    # block ids, writes the payload into its pools in place, points the
    # slot's block-table row at them and decodes as if it had prefilled
    # locally. Sampling is keyed by (request seed, logical position), so
    # the decode leg is token-identical to colocated serving.

    # staged blocks round up to a multiple of this; the pad rows go to
    # the scratch block (the reference's mode="drop")
    _GRAFT_WIDTH = 8

    def _disagg_guard(self) -> None:
        if self.spec is not None and self.spec.mode == "draft":
            raise NotImplementedError(
                "disaggregated serving with a draft model would need "
                "the draft's prefill cache shipped beside the target's "
                "blocks; use n-gram speculation or a non-spec decode "
                "leg"
            )

    def prefill_export(
        self, ids, *, max_new: int | None = None, seed: int = 0,
        priority: Priority | int | str = Priority.STANDARD,
        deadline_s: float | None = None, timeout_s: float | None = None,
        tenant: str | None = None,
    ) -> dict:
        """Run this request's prefill leg only and export the result.

        The prompt admits through the normal queue (priority order,
        prefix-matched against the local index, chunked prefill
        interleaved with co-resident traffic) on a held slot: its row is
        off on the device and out of every decode chunk. Once the final
        chunk has run, the filled blocks are gathered (one sync) and the
        slot torn down; the prompt prefix stays registered in the local
        index, so a repeat export of a shared prefix re-prefills only the
        tail.

        Returns the payload ``parallel/kvwire.py`` packs: per-layer
        ``[n_blocks, block_size, Hkv, D]`` stacks (CPU tensors; int8 pools
        add their scales), the prompt ids, the first sampled token and the
        seed, budget and block-size scalars a decode leg needs."""
        self._disagg_guard()
        rid = self.submit(
            ids, max_new=max_new, seed=seed, priority=priority,
            deadline_s=deadline_s, tenant=tenant, _hold=True,
        )
        with self._lock:
            req = self._requests[rid]
        deadline = None if timeout_s is None else time.perf_counter() + timeout_s
        idle_recheck = False
        while True:
            export_err: BaseException | None = None
            with self._lock:
                if req.failed is not None:
                    raise req.failed
                slot = req.slot
                if (slot is not None and self._slot_req[slot] is req
                        and slot not in self._pending
                        and req.first_token is not None):
                    try:
                        return self._export_slot_locked(req, slot)
                    except BaseException as e:
                        # cancelled below, outside the lock, so a failed
                        # export does not pin the held slot and its blocks
                        export_err = e
            if export_err is not None:
                self.cancel(rid)
                raise export_err
            if idle_recheck:
                self.cancel(rid)
                raise ServingError(
                    f"prefill-export request {rid} cannot complete: "
                    "scheduler idle (internal accounting bug)"
                )
            progressed = self.step()
            if deadline is not None and time.perf_counter() > deadline:
                self.cancel(rid)
                raise TimeoutError(
                    f"prefill of request {rid} not done in {timeout_s}s"
                )
            idle_recheck = not progressed and req.failed is None and not req.done

    def _pool_layout(self, rows: int):
        """Every pool tensor's ``rows`` rows packed into one byte buffer:
        ``([(layer, name, pool tensor, offset)], size)``, each offset 16-byte
        aligned (any dtype view of the buffer is then legal)."""
        plan, total = [], 0
        for i, pool in enumerate(self._pools):
            for name, t in pool.items():
                plan.append((i, name, t, total))
                total += -(-rows * t[0].numel() * t.element_size() // 16) * 16
        return plan, total

    @staticmethod
    def _rows_view(flat, t, off: int, rows: int) -> torch.Tensor:
        """[rows, *t.shape[1:]] of t's dtype at byte ``off`` of ``flat``."""
        nbytes = rows * t[0].numel() * t.element_size()
        return flat[off:off + nbytes].view(t.dtype).view((rows, *t.shape[1:]))

    def _gather_blocks(self, bids: list[int]) -> list[dict]:
        """Every pool tensor's rows ``bids`` to host memory: one
        ``index_select`` a tensor into one device buffer, one copy to
        pinned host memory and one sync. -> per-layer ``{name: CPU
        tensor}`` (views of that host buffer)."""
        n = len(bids)
        idx = self._to_device(np.asarray(bids, np.int64))
        plan, total = self._pool_layout(n)
        dev_flat = torch.empty((total,), dtype=torch.uint8, device=self.device)
        for _, _, t, off in plan:
            torch.index_select(t, 0, idx, out=self._rows_view(dev_flat, t, off, n))
        if self.device.type == "cuda":
            host_flat = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
            host_flat.copy_(dev_flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()  # the export's one sync
        else:
            host_flat = dev_flat
        layers = [{} for _ in self._pools]
        for i, name, t, off in plan:
            layers[i][name] = self._rows_view(host_flat, t, off, n)
        return layers

    def _export_slot_locked(self, req: _Request, slot: int) -> dict:
        bs = self.block_size
        prompt_ids = np.asarray(req.ids, np.int64).reshape(-1)
        t0 = int(prompt_ids.size)
        bids = list(self._slot_blocks[slot])
        need = -(-t0 // bs)
        if len(bids) != need:  # held slots never grow past the prompt
            raise ServingError(
                f"export expected {need} prompt blocks, slot maps "
                f"{len(bids)} (internal accounting bug)"
            )
        host, event = req.first_token
        if event is not None:
            event.synchronize()
        self._prefill_synced(req)
        self._maybe_record_ttft(req)
        tok0 = int(host)
        payload = {
            "prompt_ids": torch.from_numpy(prompt_ids.astype(np.int32)),
            "layers": self._gather_blocks(bids),
            "n_valid": t0,
            "tok0": tok0,
            "seed": int(req.seed),
            "remaining": int(req.max_new) - 1,
            "block_size": bs,
        }
        if self.kv_quant is not None:
            # int8 blocks and scales ship natively
            payload["kv_quant"] = self.kv_quant
        if self.index is not None:
            payload["prefix_digest"] = self.index.chain_digest(prompt_ids)
        self.disagg["exports"] += 1
        self.disagg["export_blocks"] += len(bids)
        self.disagg["export_tokens"] += t0
        req.first_token = None
        # teardown: _finish retires the row before the blocks return to
        # the pool; the registered prefix keeps them reusable
        self._finish(req)
        return payload

    def _coerce_kv_form(self, layers: list, src_quant: str | None) -> list:
        """Imported layers from the payload's pool form into this
        engine's: matching forms pass through (int8 blocks and scales
        graft natively); int8 -> float dequantizes to f32; float -> int8
        quantizes with ``ops/quant.py quantize_kv_int8``, the write-time
        math, so a re-export equals a locally written pool."""
        if src_quant == self.kv_quant:
            return layers
        out = []
        for bl in layers:
            ent = {}
            for kv in ("k", "v"):
                x = _as_tensor(bl[kv])
                if src_quant == "int8":
                    ent[kv] = x.float() * _as_tensor(bl[kv + "_scale"]).float()[..., None]
                else:
                    ent[kv], ent[kv + "_scale"] = quantize_kv_int8(x)
            out.append(ent)
        return out

    def _stage_graft(self, layers: list, nblk: int):
        """The payload's blocks on the device in the pools' dtypes, as
        [n_pad, ...] views of one buffer (n_pad: nblk rounded up to
        ``_GRAFT_WIDTH``), staged through pinned memory with one
        non-blocking copy."""
        W = self._GRAFT_WIDTH
        n_pad = -(-nblk // W) * W
        plan, total = self._pool_layout(n_pad)
        host = torch.empty((total,), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        for i, name, t, off in plan:
            self._rows_view(host, t, off, n_pad)[:nblk].copy_(_as_tensor(layers[i][name]))
        dev = self._to_device(host)
        return [(i, name, self._rows_view(dev, t, off, n_pad)) for i, name, t, off in plan]

    def import_prefill(
        self, payload: dict, *,
        priority: Priority | int | str = Priority.STANDARD,
        deadline_s: float | None = None,
        tenant: str | None = None,
        wire_bytes: int = 0,
    ) -> int:
        """Graft a prefill leg's exported blocks into this engine's pools
        and start decoding them: the decode side of disaggregated serving.
        Validates geometry and the chained prefix digest (the ids the
        payload claims must reproduce the digest the prefill leg
        computed), allocates local block ids, writes the blocks into the
        pools in place (``index_copy_``; pad rows of the staging go to the
        scratch block), points the slot's block-table row at them, sets
        the row as a final prefill chunk would have left it, and registers
        the prompt prefix in the local index.

        Raises ``OverloadedError`` / ``PoolOverloadedError`` (with a
        measured ``retry_after_s``) when no slot or blocks are free (an
        import is never queued) and ``ValueError`` on a payload this
        engine cannot trust. ``wire_bytes``: the received blob's length,
        billed on the request's meter. Returns the rid; drive
        ``result(rid)`` / ``step()`` as for a local submission."""
        self._disagg_guard()
        prompt_ids = np.asarray(_as_tensor(payload["prompt_ids"])).reshape(-1).astype(np.int64)
        t0 = int(prompt_ids.size)
        n_valid = int(payload["n_valid"])
        tok0 = int(payload["tok0"])
        seed = int(payload["seed"])
        remaining = int(payload["remaining"])
        bs = int(payload["block_size"])
        layers = payload["layers"]
        prio = _coerce_priority(priority)
        if bs != self.block_size:
            raise ValueError(
                f"payload block_size {bs} != engine block_size {self.block_size}"
            )
        if n_valid != t0 or t0 == 0:
            raise ValueError(f"payload n_valid {n_valid} != prompt length {t0}")
        if remaining < 0:
            raise ValueError(f"negative remaining budget {remaining}")
        nblk = -(-t0 // bs)
        max_new = remaining + 1  # tok0 is already the first generation
        if len(layers) != self._n_layers:
            raise ValueError(
                f"payload has {len(layers)} layers, engine has {self._n_layers}"
            )
        src_quant = payload.get("kv_quant")
        if src_quant is None and "k_scale" in layers[0]:
            src_quant = "int8"  # a producer shipping scales inline
        if src_quant not in (None, "int8"):
            raise ValueError(f"unknown payload kv_quant {src_quant!r}")
        src_keys = ("k", "v", "k_scale", "v_scale") if src_quant == "int8" else ("k", "v")
        for i, bl in enumerate(layers):
            for name in src_keys:
                if name not in bl:
                    raise ValueError(
                        f"layer {i} missing {name} blocks for kv_quant={src_quant!r}"
                    )
                want = ((nblk, *self._block_shape) if name in ("k", "v")
                        else (nblk, *self._block_shape[:-1]))
                shape = tuple(_as_tensor(bl[name]).shape)
                if shape != want:
                    raise ValueError(
                        f"layer {i} {name} blocks have shape {shape}, expected {want}"
                    )
        # staging runs outside the lock: the host copy and the
        # non-blocking upload must not stall a thread pumping step()
        staged = self._stage_graft(self._coerce_kv_form(layers, src_quant), nblk)
        ids_row = np.zeros((self.L,), np.int64)
        ids_row[:t0] = prompt_ids[:self.L]
        eos = self.gen.eos_token_id
        done0 = remaining <= 0 or (eos is not None and tok0 == eos)
        with self._lock:
            digest = payload.get("prefix_digest")
            if digest is not None and self.index is not None:
                if self.index.chain_digest(prompt_ids) != digest:
                    raise ValueError(
                        "prefix digest mismatch: the payload's prompt ids do "
                        "not correspond to its blocks"
                    )
            self._check_fit(t0, max_new)
            self._expire_deadlines_locked()
            if not self._free:
                ra = self._retry_after_locked()
                self._note_shed(prio)
                raise OverloadedError(
                    f"no free decode slot for imported prefill; retry in {ra}s",
                    retry_after_s=ra, reason="no_decode_slot",
                )
            try:
                bids = self.pool.alloc(nblk)
            except PoolExhaustedError as e:
                ra = self._retry_after_locked()
                self._note_shed(prio)
                raise PoolOverloadedError(f"{e}; retry in {ra}s",
                                          retry_after_s=ra) from e
            rid = self._next_rid
            self._next_rid += 1
            now = time.perf_counter()
            req = _Request(
                rid=rid, ids=prompt_ids, max_new=max_new, seed=seed,
                submitted_at=now, priority=prio, deadline_s=deadline_s,
                deadline_at=None if deadline_s is None else now + deadline_s,
                tenant=str(tenant)[:128] if tenant else None,
                submitted_ns=time.time_ns(), n_prompt=t0,
                wire_bytes=max(int(wire_bytes), 0),
            )
            if deadline_s is not None:
                self._deadlined += 1
            self._requests[rid] = req
            slot = self._free.pop()
            req.slot = slot
            self._slot_req[slot] = req
            self._slot_blocks[slot] = list(bids)
            if self.metering:
                self._meter_kv(req, nblk)
            # what a final prefill chunk leaves: the write index and its
            # bounds at the prompt's end, nothing banked yet
            self._slot_limit[slot] = min(t0 + max_new, self.L)
            self._slot_ub[slot] = t0
            self._slot_base[slot] = t0
            try:
                bid_pad = np.full((len(staged[0][2]),), self.pool.num_blocks, np.int64)
                bid_pad[:nblk] = bids
                bid_dev = self._to_device(bid_pad)
                for i, name, blocks in staged:
                    # in place: captured graphs keep reading these pools
                    self._pools[i][name].index_copy_(0, bid_dev, blocks)
                self._set_row(slot, start=t0)
                dev = self.device
                self._valid[slot] = torch.arange(self.L, device=dev) < t0
                self._n_valid[slot] = t0
                self._tok[slot] = tok0
                self._seed[slot] = seed
                self._remaining[slot] = remaining
                self._live[slot] = not done0
                if self.spec is not None:
                    # n-gram drafting looks up the same banked ids a local
                    # prefill would have written
                    self._ids[slot, :self.L] = self._to_device(ids_row)
                if self.index is not None:
                    for b in self.index.register(prompt_ids, list(bids)):
                        self.pool.mark_cached(b, priority=prio)
            except BaseException:
                # a failed device write must not leak the slot, the blocks
                # or a request that can never finish
                self._retire_row(slot)
                self._slot_req[slot] = None
                self._release_slot_blocks(slot)
                self._free.append(slot)
                if deadline_s is not None:
                    self._deadlined = max(self._deadlined - 1, 0)
                self._requests.pop(rid, None)
                raise
            self.disagg["imports"] += 1
            self.disagg["import_blocks"] += nblk
            self.disagg["import_tokens"] += t0
            if done0:
                # nothing to decode: complete at import
                req.first_token_at = time.perf_counter()
                self._append_token(req, tok0)
            else:
                req.first_token = (torch.tensor(tok0), None)
        return rid

    def disagg_wire_ewma_s(self) -> float:
        """Measured wire-transfer EWMA (0.0 until a transfer was noted):
        what a prefill leg charges against an end-to-end deadline before
        shipping."""
        with self._lock:
            return float(self._disagg_ewma.get("wire_s_ewma") or 0.0)

    def note_disagg_transfer(
        self, *, prefill_s: float | None = None,
        wire_s: float | None = None, wire_bytes: int | None = None,
        fallback: bool = False,
    ) -> None:
        """Fold one completed prefill-leg transfer into the EWMAs and
        counts of ``stats()["disagg"]`` (a wire time above the prefill
        time means the hop, not the card, bounds the leg)."""
        with self._lock:
            for name, v in (("prefill_s_ewma", prefill_s), ("wire_s_ewma", wire_s)):
                if v is None:
                    continue
                old = self._disagg_ewma.get(name)
                self._disagg_ewma[name] = round(
                    v if old is None else 0.8 * old + 0.2 * v, 6
                )
            if wire_bytes:
                self.disagg["wire_bytes"] = self.disagg.get("wire_bytes", 0) + int(wire_bytes)
            if fallback:
                self.disagg["fallbacks"] += 1

    def _prefill_step(self) -> None:
        self._dispatch_prefill_chunk()

    def _decoding_slots(self) -> list[int]:
        # a held (prefill-leg) row is never decoded: it waits for export
        decoding = [
            s for s, r in enumerate(self._slot_req)
            if r is not None and s not in self._pending and not r.hold
        ]
        if decoding and self.spec is not None:
            # stage the masked-K array now: block growth and the
            # dispatch's effective K must read the same values (a drain
            # during growth may move the controller)
            self._k_dispatch = self._spec_k_array()
        return self._grow_blocks(decoding) if decoding else decoding

    def _busy(self) -> bool:
        return bool(self._queue or self._pending)

    def _step_locked(self) -> bool:
        """One scheduler iteration: expire deadlines, admit, run at most
        one prefill chunk, grow block tables, dispatch one decode chunk,
        drain. Returns False when fully idle."""
        busy = super()._step_locked()
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.pool.in_use)
        return busy

    def prefix_hit_rate(self) -> float:
        if not self.prompt_tokens_total:
            return 0.0
        return self.prefix_matched_tokens / self.prompt_tokens_total

    def _stats_locked(self) -> dict:
        return {
            **super()._stats_locked(),
            "pool": self.pool.stats(),
            "prefilling": len(self._pending),
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "prompt_tokens_total": self.prompt_tokens_total,
            "prefix_matched_tokens": self.prefix_matched_tokens,
            "prefilled_tokens": self.prefilled_tokens,
            "prefix_cache_hit_rate": round(self.prefix_hit_rate(), 4),
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            **({"disagg": {**self.disagg, **self._disagg_ewma}}
               if any(self.disagg.values()) or self._disagg_ewma else {}),
        }
