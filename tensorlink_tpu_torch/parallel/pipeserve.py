"""Pipeline-sharded serving (port of ``tensorlink_tpu/parallel/pipeserve.py``):
serve a model no single worker holds.

The layer stack is cut into contiguous stages (``nn.staging.stage_spans``,
in proportion to each worker's published memory); every stage worker runs
a **stage-local paged engine**, whose own ``BlockPool`` holds only that
stage's KV blocks, and the activations ([S, 1, D] a decode tick,
[1, C, D] a prefill chunk) go worker to worker over the CRC-framed codec
in ``ACT_FWD`` / ``ACT_RESULT`` frames (``p2p/node.py``).

Each stage program is the layer-range restriction of the paged engine's
programs (``parallel/serving.py``): the same valid-mask update, write
index discipline and logical-coordinate causality, through the same
kernels (B3 paged attention for the prefill chunk and the decode tick,
B4 fused residual + norm in each pre-norm layer's decode step). Sampling
is ``sample_logits_at`` keyed by (request seed, position), so an N-stage
chain emits the token stream of one engine holding the whole model.
Stage programs run eagerly (no CUDA-graph capture yet).

The head (:class:`PipelineCoordinator`, on the stage-0 worker) keeps
batching continuous across the pipeline: decode ticks of resident slots
overlap prefill chunks of new ones. Typed ``serve_error_to_wire`` errors
cross every hop, deadlines are decremented per leg, and a dead stage is
survived by validator re-recruitment of a spare replica plus prefix
re-prefill: the head keeps prompt + accepted tokens on the host,
re-prefills them through the repaired chain, and position-keyed sampling
continues the stream without re-drawing an accepted token.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from collections import OrderedDict, deque
from math import ceil

import numpy as np
import torch

from tensorlink_tpu_torch.nn.attention import paged_write_slots
from tensorlink_tpu_torch.nn.staging import StageSlice, layer_param_bytes, stage_spans
from tensorlink_tpu_torch.p2p.serialization import pack_arrays, unpack_arrays
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    declared_compute_dtype,
    sample_logits_at,
)
from tensorlink_tpu_torch.parallel.kvpool import BlockPool, PoolExhaustedError
from tensorlink_tpu_torch.parallel.serving import (
    DeadlineExceededError,
    PoolOverloadedError,
    Priority,
    PromptTooLongError,
    QueueFullError,
    ServingError,
    serve_error_from_wire,
)

__all__ = [
    "ACT_WIRE_SCHEMA",
    "MAX_ACT_BYTES",
    "PipelineCoordinator",
    "PipelineStageEngine",
    "layer_param_bytes",  # re-exported: deployers size stages with these
    "pack_act_payload",
    "plan_pipeline",
    "stage_spans",
    "unpack_act_payload",
]


# --------------------------------------------------------- activation wire
# ONE tensor plus a schema pin, framed by the codec KV blocks ride; the
# routing and shape metadata travel in the ACT_FWD frame's ``meta`` dict,
# where the receiving role clamps them field by field.

ACT_WIRE_SCHEMA = 1

# hostile-ingest bound: a decode tick is S*D values and a prefill chunk
# C*D; anything bigger is a hostile or corrupt frame
MAX_ACT_BYTES = 256 << 20


def pack_act_payload(x, codec: str = "zstd") -> bytes:
    """Activation tensor (or sampled-token vector) -> wire blob; the same
    bytes as the reference's for the same array and codec."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    elif x.device.type != "cpu":
        x = x.cpu()
    return pack_arrays(
        {"schema": np.asarray(ACT_WIRE_SCHEMA, np.int32), "x": x}, codec=codec,
    )


def unpack_act_payload(blob) -> torch.Tensor:
    """Wire blob -> activation tensor (CPU), CRC-checked by the codec and
    schema/size-clamped here (the stage engine still checks the exact
    shape before any compute)."""
    if not isinstance(blob, (bytes, bytearray)):
        raise ValueError("activation blob must be bytes")
    if len(blob) > MAX_ACT_BYTES:
        raise ValueError(
            f"activation blob {len(blob)}B exceeds cap {MAX_ACT_BYTES}B"
        )
    arrs = unpack_arrays(bytes(blob))
    schema = arrs.get("schema")
    schema = int(schema.reshape(-1)[0]) if schema is not None else -1
    if schema != ACT_WIRE_SCHEMA:
        raise ValueError(
            f"activation wire schema {schema} != {ACT_WIRE_SCHEMA} "
            "(incompatible peer build)"
        )
    x = arrs["x"]
    if x.dim() > 3:
        raise ValueError(f"activation rank {x.dim()} > 3")
    return x


# -------------------------------------------------------------- placement
def plan_pipeline(
    fleet: dict[str, dict],
    *,
    n_stages: int | None = None,
    need_bytes: int = 0,
    exclude=(),
) -> dict | None:
    """Pick pipeline stage workers from published capability records.

    Eligible records claim ``hbm_bytes``. Workers rank by it, decode
    bandwidth (``hbm_gbps``) breaking ties; without ``n_stages`` the plan
    takes the FEWEST workers whose summed memory covers ``need_bytes``
    (every extra stage is an extra wire hop a token). None when the
    fleet cannot hold the model."""
    exclude = set(exclude or ())
    elig = []
    for nid, cap in (fleet or {}).items():
        if nid in exclude or not isinstance(cap, dict):
            continue
        try:
            hbm = float(cap.get("hbm_bytes") or 0.0)
        except (TypeError, ValueError):
            continue
        if hbm <= 0:
            continue
        try:
            gbps = float(cap.get("hbm_gbps") or 0.0)
        except (TypeError, ValueError):
            gbps = 0.0
        elig.append((nid, hbm, gbps))
    elig.sort(key=lambda t: (-t[1], -t[2], t[0]))
    if n_stages is not None:
        k = int(n_stages)
        if k < 1 or len(elig) < k:
            return None
        pick = elig[:k]
        if need_bytes and sum(h for _, h, _ in pick) < need_bytes:
            return None
    else:
        if need_bytes <= 0:
            raise ValueError("plan_pipeline needs n_stages or need_bytes")
        pick, acc = [], 0.0
        for row in elig:
            pick.append(row)
            acc += row[1]
            if acc >= need_bytes:
                break
        if acc < need_bytes:
            return None
    return {
        "stages": [nid for nid, _, _ in pick],
        "capacities": [h for _, h, _ in pick],
    }


# ----------------------------------------------------------- stage engine
class PipelineStageEngine:
    """One pipeline stage: the paged serving programs restricted to the
    layers ``[lo, hi)``, over a stage-local block pool.

    - ``decode_step``: one tick for all S slots. Stage 0 embeds the fed
      tokens; every stage runs its layers through its paged KV; the last
      stage applies the head and samples each slot at (seed, position).
    - ``prefill_chunk``: one C-token chunk of one slot, written through
      the slot's block-table row.

    Host bookkeeping (block allocation, table rows, retirement) follows
    the paged engine; prefix caching is not wired (a prefix hit would
    have to hit on every stage at once). The stage's weights are the
    engine's model's own tensors (``StageSlice``); only the KV pools and
    row state are the stage's."""

    def __init__(
        self,
        engine,
        *,
        lo: int,
        hi: int,
        sid: str = "pipe",
        stage: int = 0,
        n_stages: int = 1,
        slots: int = 4,
        gen: GenerationConfig | None = None,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefill_chunk: int = 16,
        max_len: int | None = None,
        metrics=None,
        recorder=None,
        **_ignored,
    ):
        self.slice = StageSlice(engine.model, lo, hi)
        self.device = engine.device
        self.sid = str(sid)
        self.stage = int(stage)
        self.n_stages = int(n_stages)
        self.slots = S = int(slots)
        self.gen = gen or GenerationConfig()
        self.L = L = int(max_len or engine.cache_len)
        self.block_size = int(block_size)
        if self.L % self.block_size:
            raise ValueError(
                f"block_size {block_size} must divide the cache view "
                f"width {self.L}"
            )
        self.chunk_len = int(prefill_chunk)
        self.cache_dtype = engine.cache_dtype
        self.metrics = metrics
        self.recorder = recorder
        self.params = self.slice.stage_params()
        self.max_blocks = MB = self.L // self.block_size
        nb = num_blocks if num_blocks is not None else S * MB
        self.pool = BlockPool(int(nb), self.block_size, metrics=metrics,
                              recorder=recorder)
        self._slot_blocks: list[list[int]] = [[] for _ in range(S)]
        dev = self.device
        caches = self.slice.init_paged_caches(
            self.pool.num_blocks, self.block_size, S, MB,
            dtype=self.cache_dtype, device=dev,
        )
        # one write index and one block table serve every layer (as in
        # the paged engine)
        self._index = caches[0]["index"]
        self._block_table = caches[0]["block_table"]
        self._pools = [
            {k: c[k] for k in c if k not in ("index", "block_table")}
            for c in caches
        ]
        self._valid = torch.zeros((S, L), dtype=torch.bool, device=dev)
        self._rows = torch.arange(S, device=dev)
        self._lock = threading.Lock()
        # slots whose device rows still await retirement: a release from
        # the event-loop thread frees the blocks at once and leaves the
        # device writes to the next locked run, on a compute thread
        self._retire: set[int] = set()
        # busy-vs-wall attribution for the per-stage bubble column: busy
        # is host wall under this engine's programs (each ends in a host
        # read), the window first-to-last activity
        self._busy = {"decode": 0.0, "prefill": 0.0}
        self._steps = {"decode": 0, "prefill": 0}
        self._t_first: float | None = None
        self._t_last: float | None = None

    # ---------------------------------------------------------- programs
    def _caches(self, index, block_table, T: int) -> list[dict]:
        slots = paged_write_slots(index, block_table, T, self.pool.num_blocks,
                                  self.block_size)
        return [
            {**pool, "index": index, "block_table": block_table,
             "write_slots": slots}
            for pool in self._pools
        ]

    @torch.no_grad()
    def _decode(self, xin, n_valid, live, seeds):
        sl, L, gen = self.slice, self.L, self.gen
        index = self._index
        # as the one-engine chunk: the fed token's slot becomes attendable
        # for live rows; an index at capacity updates nothing
        at = index.long().clamp(max=L - 1)
        self._valid[self._rows, at] |= live & (index < L)
        x = sl.embed(xin[:, None], n_valid[:, None]) if sl.first else xin
        x, _ = sl.body(x, self._caches(index, self._block_table, 1),
                       mask=self._valid[:, None, None, :],
                       positions=n_valid[:, None])
        step = live.int()
        index.add_(step)
        if sl.last:
            logits = sl.head(x)
            new_n = n_valid + step
            return sample_logits_at(logits[:, -1], seeds, new_n,
                                    gen.temperature, gen.top_k, gen.top_p)
        return x

    @torch.no_grad()
    def _prefill(self, xin, slot: int, start: int, nreal: int, seed: int):
        sl, C, dev, gen = self.slice, self.chunk_len, self.device, self.gen
        index = torch.full((1,), start, dtype=torch.int32, device=dev)
        bt = self._block_table[slot:slot + 1]
        positions = (start + torch.arange(C, device=dev))[None, :]
        x = sl.embed(xin, positions) if sl.first else xin
        # mask=None: the paged path builds causality in logical coordinates
        x, _ = sl.body(x, self._caches(index, bt, C), mask=None,
                       positions=positions)
        n_end = start + nreal
        self._index[slot] = n_end
        self._valid[slot] = torch.arange(self.L, device=dev) < n_end
        if sl.last:
            logits = sl.head(x[0, nreal - 1])
            seed_t = torch.full((1,), seed, dtype=torch.int64, device=dev)
            pos_t = torch.full((1,), n_end, dtype=torch.int64, device=dev)
            return sample_logits_at(logits[None], seed_t, pos_t,
                                    gen.temperature, gen.top_k, gen.top_p)[0]
        return x

    # -------------------------------------------------------------- host
    def _note(self, tag: str, dt: float) -> None:
        now = time.perf_counter()
        self._busy[tag] += dt
        self._steps[tag] += 1
        if self._t_first is None:
            self._t_first = now - dt
        self._t_last = now

    def _apply_retire(self) -> None:
        """Retire queued slots on the device (block-table row to the
        sentinel, validity cleared); caller holds the lock."""
        for slot in sorted(self._retire):
            self._set_row(slot, None)
            self._valid[slot] = False
        self._retire.clear()

    def _set_row(self, slot: int, blocks: list[int] | None) -> None:
        row = np.full((self.max_blocks,), self.pool.num_blocks, np.int32)
        if blocks:
            row[: len(blocks)] = blocks
        self._block_table[slot] = torch.from_numpy(row).to(self.device)

    def begin_request(self, slot: int, n_ctx: int, budget: int) -> None:
        """Admit (or re-admit) a request into ``slot``: release the last
        tenant's blocks, allocate enough for prompt + budget up front and
        point the slot's block-table row at them (the decode tick then
        never grows a slot)."""
        slot = int(slot)
        n_ctx, budget = int(n_ctx), int(budget)
        if not (0 <= slot < self.slots):
            raise ValueError(f"slot {slot} out of range")
        if n_ctx < 1 or n_ctx + budget > self.L:
            raise PromptTooLongError(
                f"prompt {n_ctx} + budget {budget} exceeds cache view "
                f"width {self.L}"
            )
        nblocks = ceil(min(n_ctx + budget, self.L) / self.block_size)
        with self._lock:
            self._apply_retire()
            for bid in self._slot_blocks[slot]:
                self.pool.release(bid)
            self._slot_blocks[slot] = []
            try:
                blocks = self.pool.alloc(nblocks)
            except PoolExhaustedError as e:
                raise PoolOverloadedError(
                    f"stage {self.stage} pool exhausted: {e}"
                ) from e
            self._slot_blocks[slot] = blocks
            self._set_row(slot, blocks)
            self._index[slot] = 0

    def slot_blocks(self, slot: int) -> int:
        """Pool blocks ``slot`` pins (constant over a residency)."""
        with self._lock:
            return len(self._slot_blocks[int(slot)])

    def release_slot(self, slot: int, *, defer: bool = False) -> None:
        """Free ``slot``'s blocks and retire its device row; ``defer``
        (the head's release, on the event-loop thread) queues the device
        part for the next locked run instead of issuing it here."""
        slot = int(slot)
        with self._lock:
            for bid in self._slot_blocks[slot]:
                self.pool.release(bid)
            self._slot_blocks[slot] = []
            self._retire.add(slot)
            if not defer:
                self._apply_retire()

    def reset_all(self) -> None:
        for s in range(self.slots):
            self.release_slot(s)

    def _act_dtype(self) -> torch.dtype:
        return getattr(torch, declared_compute_dtype(self.params))

    def _expect_x(self, x, shape: tuple, dtype) -> torch.Tensor:
        x = torch.as_tensor(x)
        if tuple(x.shape) != shape:
            raise ValueError(
                f"activation shape {tuple(x.shape)} != expected {shape}"
            )
        return x.to(device=self.device, dtype=dtype)

    def prefill_chunk(self, slot, xin, start, nreal, seed,
                      n_ctx=None, budget=None):
        """Run one prefill chunk for ``slot``; the first chunk
        (``start == 0``) (re)admits the slot with ``n_ctx``/``budget``.
        Returns a CPU tensor: hidden states on relaying stages, the
        sampled first token on the last (meaningful on the final chunk
        only: every chunk samples, the host keeps the last draw)."""
        slot, start, nreal = int(slot), int(start), int(nreal)
        C = self.chunk_len
        if not (1 <= nreal <= C) or start < 0 or start + nreal > self.L:
            raise ValueError("prefill chunk out of bounds")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range")
        if start == 0:
            if n_ctx is None or budget is None:
                raise ValueError("first chunk needs n_ctx and budget")
            self.begin_request(slot, n_ctx, budget)
        if self.slice.first:
            x = self._expect_x(xin, (1, C), torch.int64)
        else:
            x = self._expect_x(xin, (1, C, self.slice.hidden_dim),
                               self._act_dtype())
        with self._lock:
            self._apply_retire()
            t0 = time.perf_counter()
            out = self._prefill(x, slot, start, nreal, int(seed)).cpu()
            self._note("prefill", time.perf_counter() - t0)
        return out

    def decode_step(self, xin, n_valid, live, seeds):
        """One decode tick across all S slots. ``xin`` is the fed token
        vector [S] on stage 0 and the upstream hidden states [S, 1, D]
        elsewhere; ``n_valid``/``live``/``seeds`` ride the wire from the
        head so every stage computes with the same row state. Returns a
        CPU tensor: hidden states, or the sampled tokens [S] (last)."""
        S, dev = self.slots, self.device
        n_valid = np.asarray(n_valid, np.int64)
        live = np.asarray(live, bool)
        seeds = np.asarray(seeds, np.int64) & 0xFFFFFFFF
        if n_valid.shape != (S,) or live.shape != (S,) or seeds.shape != (S,):
            raise ValueError("decode row-state arrays must be [slots]")
        if self.slice.first:
            x = self._expect_x(xin, (S,), torch.int64)
        else:
            x = self._expect_x(xin, (S, 1, self.slice.hidden_dim),
                               self._act_dtype())
        with self._lock:
            self._apply_retire()
            t0 = time.perf_counter()
            out = self._decode(
                x, torch.from_numpy(n_valid).to(dev),
                torch.from_numpy(live).to(dev), torch.from_numpy(seeds).to(dev),
            ).cpu()
            self._note("decode", time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            busy_d, busy_p = self._busy["decode"], self._busy["prefill"]
            steps_d, steps_p = self._steps["decode"], self._steps["prefill"]
            t_first, t_last = self._t_first, self._t_last
        busy = busy_d + busy_p
        window = 0.0
        if t_first is not None and t_last is not None:
            window = max(t_last - t_first, 0.0)
        bubble = max(0.0, 1.0 - busy / window) if window > 1e-9 else 0.0
        out = {
            "pipeline_stage": self.stage,
            "pipeline_n_stages": self.n_stages,
            "layers": [self.slice.lo, self.slice.hi],
            "dtype": declared_compute_dtype(self.params),
            "decode_steps": steps_d,
            "prefill_chunks": steps_p,
            "decode_s": round(busy_d, 6),
            "prefill_s": round(busy_p, 6),
            "busy_s": round(busy, 6),
            "window_s": round(window, 6),
            "bubble_frac": round(bubble, 4),
            "pool": self.pool.stats(),
        }
        return out


# ------------------------------------------------------------ coordinator
class PipelineCoordinator:
    """Head-of-pipeline scheduler (runs on the stage-0 worker).

    Duck-types the serving-engine surface the worker's SERVE_SUBMIT /
    SERVE_RESULT handlers and :class:`RemoteServingClient` already speak
    — ``asubmit`` / ``aresult`` / ``stats`` / ``pool`` — so the entire
    client path works against a pipeline unchanged.

    Per decode tick: run the local stage-0 program over ALL slots, ship
    the [S, 1, D] hidden states down the chain as one ``ACT_FWD`` whose
    reply (the last stage's sampled tokens) relays back up, then apply
    EOS/budget bookkeeping host-side. Prefill streams chunk-by-chunk the
    same way. Admissions overlap in-flight ticks (asyncio.gather), so a
    newly admitted request's prefill chunks occupy early stages while
    resident slots' decode traffic occupies later ones."""

    ACT_TIMEOUT_S = 60.0

    def __init__(
        self,
        node,
        engine: PipelineStageEngine,
        *,
        route: list[dict],
        sid: str,
        validator=None,
        max_queue: int = 64,
        gen: GenerationConfig | None = None,
    ):
        self.node = node
        self.engine = engine
        self.route = [dict(w) for w in (route or [])]
        self.sid = str(sid)
        self.n_stages = len(self.route) + 1
        self.validator = validator
        self.gen = gen or engine.gen
        self.max_queue = int(max_queue)
        self.slots = engine.slots
        self.L = engine.L
        self._requests: dict[int, dict] = {}
        self._slot_rid: list[int | None] = [None] * self.slots
        self._queue: list[int] = []
        self._next_rid = 1
        self._wake = asyncio.Event()
        self._pump_task: asyncio.Task | None = None
        self._opened = False
        self._ticks = 0
        self._act_bytes = 0
        self._failovers = 0
        self._refills = 0
        # per-request resource metering (runtime/ledger.py): the head
        # owns the whole request lifecycle, so it is the one place a
        # pipeline request's stage-0 busy seconds, activation wire
        # bytes, and KV block-seconds can be folded into ONE meter the
        # stage-0 worker signs (kind="pipeline"). Downstream stages'
        # device time is deliberately NOT claimed — a receipt only ever
        # bills work the signing node itself performed.
        self.metering = True
        self.meter_kind = "pipeline"
        self._meter_log: OrderedDict[int, dict] = OrderedDict()
        self._meter_fresh: deque = deque(maxlen=512)
        self._metered_total = 0

    # ------------------------------------------------------------ spans
    def _span(self, name: str, req: dict | None = None, **attrs):
        """Child span of a request's ``serving.pipeline_request`` root
        (or of the current task's span, for hop spans opened inside a
        prefill/tick span). No tracer on the node -> no-op."""
        tracer = getattr(self.node, "tracer", None)
        if tracer is None:
            return contextlib.nullcontext()
        root = (req or {}).get("span")
        remote = root.context() if root is not None else None
        return tracer.span(name, attrs=attrs, remote=remote)

    # expose the stage-0 pool so capability records advertise real
    # KV headroom for this node's share of the pipeline
    @property
    def pool(self):
        return self.engine.pool

    # ------------------------------------------------------------ submit
    async def asubmit(
        self, ids, *, max_new: int | None = None, seed: int = 0,
        priority=Priority.STANDARD, deadline_s: float | None = None,
        tenant: str | None = None,
    ) -> int:
        ids = [int(t) for t in np.asarray(ids).reshape(-1)]
        max_new = int(max_new if max_new is not None else
                      self.gen.max_new_tokens)
        if not ids:
            raise ServingError("empty prompt")
        if len(ids) + max_new > self.L:
            raise PromptTooLongError(
                f"prompt {len(ids)} + max_new {max_new} exceeds pipeline "
                f"cache view width {self.L}"
            )
        if len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"pipeline admission queue full ({self.max_queue})",
                retry_after_s=1.0,
            )
        rid = self._next_rid
        self._next_rid += 1
        req = {
            "rid": rid, "ids": ids, "max_new": max_new,
            "seed": int(seed) & 0xFFFFFFFF,
            "deadline_at": (
                time.perf_counter() + float(deadline_s)
                if deadline_s is not None else None
            ),
            "tokens": [], "state": "queued", "slot": None,
            "last_tok": 0, "n_valid": 0,
            "done": asyncio.Event(), "error": None,
            # metering accumulators + wall anchors (runtime/ledger.py)
            "tenant": str(tenant)[:128] if tenant else None,
            "t_wall0": time.time(), "t0": time.perf_counter(),
            "busy_s": 0.0, "wire_bytes": 0.0,
            "kv_blocks": 0, "kv_anchor": None, "kv_block_s": 0.0,
            "span": None,
        }
        tracer = getattr(self.node, "tracer", None)
        if tracer is not None:
            # root of this request's timeline: prefill chunks, decode
            # ticks, and chain hops open as its children, and the
            # downstream stages' handler spans continue the same trace
            # over the wire — /spans on any stage shows the stitched
            # per-stage view
            req["span"] = tracer.start_span(
                "serving.pipeline_request",
                {"sid": self.sid, "rid": rid, "prompt_len": len(ids),
                 "max_new": max_new, "n_stages": self.n_stages},
            )
        self._requests[rid] = req
        self._queue.append(rid)
        self._ensure_pump()
        return rid

    async def aresult(
        self, rid: int, *, timeout_s: float | None = None,
        deadline_s: float | None = None,
    ) -> list[int]:
        req = self._requests.get(int(rid))
        if req is None:
            raise ServingError(f"unknown rid {rid}")
        wait = timeout_s if timeout_s is not None else deadline_s
        try:
            if wait is None:
                await req["done"].wait()
            else:
                await asyncio.wait_for(req["done"].wait(), float(wait))
        except asyncio.TimeoutError:
            if deadline_s is not None and timeout_s is None:
                self._fail(req, DeadlineExceededError(
                    f"rid {rid} missed its result deadline", rid=rid
                ))
            else:
                # soft timeout: the stream is still running and
                # collectable by a later poll — typed so the client
                # can tell this from a dead leg
                raise TimeoutError(
                    f"rid {rid} still decoding after {wait}s"
                ) from None
        if req["error"] is not None:
            self._requests.pop(int(rid), None)
            raise req["error"]
        self._requests.pop(int(rid), None)
        return list(req["tokens"])

    # -------------------------------------------------------------- pump
    def _ensure_pump(self) -> None:
        self._wake.set()
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump()
            )

    def _active(self) -> list[dict]:
        return [
            self._requests[r] for r in self._slot_rid
            if r is not None and r in self._requests
        ]

    async def open(self) -> None:
        """Geometry handshake: PIPE_LOAD every downstream stage and
        verify sid/slot-count/cache-width/layer-contiguity before any
        activation crosses the wire."""
        if self._opened:
            return
        want_lo = self.engine.slice.hi
        for i in range(1, self.n_stages):
            peer = await self._stage_peer(i)
            resp = await self.node.request(peer, {
                "type": "PIPE_LOAD", "sid": self.sid, "stage": i,
                "n_stages": self.n_stages, "slots": self.slots,
                "max_len": self.L, "reset": False,
            })
            self._check_act(resp, "PIPE_LOAD")
            if int(resp.get("lo", -1)) != want_lo:
                raise ServingError(
                    f"stage {i} layers [{resp.get('lo')}, "
                    f"{resp.get('hi')}) do not continue [.., {want_lo})"
                )
            want_lo = int(resp.get("hi", -1))
        if want_lo != self.engine.slice.num_layers:
            raise ServingError(
                f"pipeline covers layers up to {want_lo} of "
                f"{self.engine.slice.num_layers}"
            )
        self._opened = True

    async def _pump(self) -> None:
        while True:
            try:
                if not self._opened:
                    await self.open()
            except Exception as e:  # noqa: BLE001 — typed + transport
                self._fail_all(e)
                return
            self._expire_deadlines()
            admits = []
            while self._queue and None in self._slot_rid:
                rid = self._queue.pop(0)
                req = self._requests.get(rid)
                if req is None:
                    continue
                slot = self._slot_rid.index(None)
                self._slot_rid[slot] = rid
                req["slot"] = slot
                req["state"] = "prefill"
                admits.append(req)
            decoding = [
                r for r in self._active() if r["state"] == "decoding"
            ]
            tasks = []
            if decoding:
                tasks.append(self._tick(decoding))
            tasks.extend(self._prefill(r) for r in admits)
            if not tasks:
                if not self._queue and not self._active():
                    return  # idle: next asubmit restarts the pump
                self._wake.clear()
                await self._wake.wait()
                continue
            results = await asyncio.gather(*tasks, return_exceptions=True)
            for err in results:
                if isinstance(err, Exception):
                    await self._handle_chain_error(err)

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        for req in list(self._requests.values()):
            da = req["deadline_at"]
            if da is not None and now > da and not req["done"].is_set():
                self._fail(req, DeadlineExceededError(
                    f"rid {req['rid']} deadline passed mid-pipeline",
                    rid=req["rid"],
                ))

    # ------------------------------------------------------------- legs
    async def _stage_peer(self, i: int):
        winfo = self.route[i - 1]
        p = self.node.peers.get(winfo["node_id"])
        if p is not None:
            return p
        return await self.node.connect_candidates(
            winfo["host"], int(winfo["port"]),
            tuple(winfo.get("alt_hosts", ()) or ()),
            expect_id=winfo["node_id"],
        )

    @staticmethod
    def _check_act(resp: dict, want: str) -> dict:
        if isinstance(resp, dict) and resp.get("type") == "SERVE_FAILED":
            e = serve_error_from_wire(resp)
            e.dead_stage = resp.get("dead_stage")
            e.dead_node = resp.get("dead_node")
            raise e
        if not isinstance(resp, dict) or resp.get("type") != want:
            raise ServingError(
                f"pipeline hop replied "
                f"{resp.get('type') if isinstance(resp, dict) else resp!r}, "
                f"wanted {want}"
            )
        return resp

    async def _chain(self, out, meta: dict, bill=()) -> dict:
        """Ship a stage-0 output down the chain; the last stage's
        ACT_RESULT relays back as this request's reply. Transport
        failures on the FIRST hop are tagged dead_stage=1 here; deeper
        hops tag themselves in their typed relay error. ``bill`` lists
        the request dicts whose meters split this hop's wire bytes."""
        blob = await asyncio.to_thread(pack_act_payload, out)
        self._act_bytes += len(blob)
        if self.metering and bill:
            share = len(blob) / len(bill)
            for r in bill:
                r["wire_bytes"] += share
        route_rest = [
            {k: w[k] for k in ("node_id", "host", "port") if k in w}
            | {"alt_hosts": list(w.get("alt_hosts", ()) or [])}
            for w in self.route[1:]
        ]
        meta = {
            **meta, "sid": self.sid, "stage": 1, "route": route_rest,
        }
        try:
            # the hop span parents under the enclosing prefill/tick
            # span (same coroutine), so each chain crossing shows up
            # on the request timeline with its payload size
            with self._span(
                "serving.pipeline.hop", None,
                stage=1, kind=str(meta.get("kind")), bytes=len(blob),
            ):
                peer = await self._stage_peer(1)
                resp = await self.node.send_activations(
                    peer, blob, meta, timeout=self.ACT_TIMEOUT_S
                )
        except (ConnectionError, OSError, asyncio.TimeoutError,
                TimeoutError) as e:
            err = ServingError(f"pipeline stage 1 unreachable: {e}")
            err.dead_stage = 1
            err.dead_node = self.route[0].get("node_id")
            raise err from e
        return self._check_act(resp, "ACT_RESULT")

    def _leg_deadline(self, reqs) -> float | None:
        das = [r["deadline_at"] for r in reqs if r["deadline_at"]]
        if not das:
            return None
        return max(0.001, min(das) - time.perf_counter())

    async def _prefill(self, req: dict) -> None:
        """Stream one request's prompt (plus, after a failover, its
        already-accepted tokens) through the pipeline chunk-by-chunk.
        The final chunk's relayed ``tok0`` is the next token of the
        stream — sampled at logical position ``len(ids_eff)``, exactly
        where the single-chip program would draw it."""
        try:
            eng = self.engine
            ids_eff = req["ids"] + req["tokens"]
            budget = req["max_new"] - len(req["tokens"])
            if budget <= 0:
                self._finish(req)
                return
            n, C, slot = len(ids_eff), eng.chunk_len, req["slot"]
            tok0 = None
            with self._span(
                "serving.pipeline.prefill", req,
                stage=0, slot=slot, n_ctx=n,
            ):
                for start in range(0, n, C):
                    da = req["deadline_at"]
                    if da is not None and time.perf_counter() > da:
                        raise DeadlineExceededError(
                            f"rid {req['rid']} deadline passed during "
                            "prefill", rid=req["rid"],
                        )
                    nreal = min(C, n - start)
                    ids_chunk = np.zeros((1, C), np.int32)
                    ids_chunk[0, :nreal] = ids_eff[start:start + nreal]
                    tb = time.perf_counter()
                    out = await asyncio.to_thread(
                        eng.prefill_chunk, slot, ids_chunk, start, nreal,
                        req["seed"], n, budget,
                    )
                    if self.metering:
                        req["busy_s"] += time.perf_counter() - tb
                        if start == 0:
                            # upfront allocation: the block count is
                            # fixed for the slot's whole residency, so
                            # the KV rectangle is one anchor + one close
                            req["kv_blocks"] = eng.slot_blocks(slot)
                            req["kv_anchor"] = time.perf_counter()
                    if self.n_stages == 1:
                        tok0 = int(out)
                        continue
                    resp = await self._chain(out, {
                        "kind": "prefill", "slot": slot, "start": start,
                        "nreal": nreal, "seed": req["seed"], "n_ctx": n,
                        "budget": budget,
                        "deadline_s": self._leg_deadline([req]),
                    }, bill=(req,))
                    tok0 = int(resp["tok0"])
            req["n_valid"] = n
            req["tokens"].append(tok0)
            req["last_tok"] = tok0
            req["n_valid"] += 1
            eos = self.gen.eos_token_id
            if budget <= 1 or (eos is not None and tok0 == eos):
                self._finish(req)
            else:
                req["state"] = "decoding"
        except (ServingError, TimeoutError) as e:
            if getattr(e, "dead_stage", None) is not None:
                raise  # chain death: let the pump run failover
            self._fail(req, e)

    async def _tick(self, decoding: list[dict]) -> None:
        """One pipeline decode tick for every decoding slot at once —
        the in-flight microbatch."""
        from tensorlink_tpu_torch.runtime import chaos

        if chaos.ACTIVE is not None and chaos.ACTIVE.apply_sync(
            "pipeserve.tick", tick=self._ticks, sid=self.sid
        ):
            return  # chaos drop: skip this tick, state untouched
        eng = self.engine
        S = self.slots
        toks = np.zeros((S,), np.int32)
        n_valid = np.zeros((S,), np.int32)
        live = np.zeros((S,), bool)
        seeds = np.zeros((S,), np.uint32)
        for req in decoding:
            s = req["slot"]
            toks[s] = req["last_tok"]
            # the fed token occupies position n_valid - 1; the decode
            # program is fed the SEQUENCE length before this tick's
            # token, i.e. the single-chip state's n_valid
            n_valid[s] = req["n_valid"] - 1
            live[s] = True
            seeds[s] = req["seed"]
        with self._span(
            "serving.pipeline.decode_tick", decoding[0],
            stage=0, tick=self._ticks, rows=len(decoding),
        ):
            tb = time.perf_counter()
            out = await asyncio.to_thread(
                eng.decode_step, toks, n_valid, live, seeds
            )
            if self.metering:
                # one program run serves every live row: each slot
                # bills for the batch lane it held this tick
                share = (time.perf_counter() - tb) / len(decoding)
                for req in decoding:
                    req["busy_s"] += share
            if self.n_stages > 1:
                resp = await self._chain(out, {
                    "kind": "decode", "tick": self._ticks,
                    "n_valid": n_valid.tolist(),
                    "live": live.tolist(),
                    "seeds": seeds.tolist(),
                    "deadline_s": self._leg_deadline(decoding),
                }, bill=decoding)
                tokens = np.asarray(resp["tokens"], np.int64)
                if tokens.shape != (S,):
                    raise ServingError(
                        f"pipeline tick returned {tokens.shape} tokens, "
                        f"wanted ({S},)"
                    )
            else:
                tokens = np.asarray(out, np.int64)
        self._ticks += 1
        eos = self.gen.eos_token_id
        for req in decoding:
            tok = int(tokens[req["slot"]])
            req["tokens"].append(tok)
            req["last_tok"] = tok
            req["n_valid"] += 1
            remaining = req["max_new"] - len(req["tokens"])
            if remaining <= 0 or (eos is not None and tok == eos):
                self._finish(req)

    # ---------------------------------------------------------- failover
    async def _handle_chain_error(self, err: Exception) -> None:
        dead = getattr(err, "dead_stage", None)
        if dead is None:
            # a typed per-request error already handled in _prefill, or
            # a local fault: fail everything in flight loudly
            self._fail_all(err)
            return
        ok = await self._failover(int(dead), getattr(err, "dead_node", None))
        if not ok:
            self._fail_all(ServingError(
                f"pipeline stage {dead} died and no replacement is "
                f"available ({err})"
            ))

    async def _failover(self, dead_stage: int, dead_node) -> bool:
        """Survive a dead stage: validator re-recruits a replica worker
        already holding the same stage slice, every downstream stage
        resets, and the head re-prefills prompt + accepted tokens for
        each in-flight request through the repaired chain. Accepted
        tokens are never re-sampled — position-keyed sampling continues
        the stream exactly."""
        self._failovers += 1
        node = self.node
        if getattr(node, "flight", None) is not None:
            node.flight.record(
                "serving.pipeline_failover", "warn", sid=self.sid,
                stage=dead_stage, dead=str(dead_node)[:64],
            )
        if self.validator is None:
            return False
        # re-resolve the validator handle: the stored Peer may be stale
        # (a later inbound dial from the validator displaces the
        # outbound stream in _register_peer) — the registry holds the
        # LIVE connection under the same node_id
        validator = node.peers.get(
            getattr(self.validator, "node_id", None)
        ) or self.validator
        try:
            resp = await node.request(validator, {
                "type": "SERVE_PIPELINE_PLAN", "sid": self.sid,
                "stage": int(dead_stage),
                "exclude": [dead_node] if dead_node else [],
            })
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            if getattr(node, "flight", None) is not None:
                node.flight.record(
                    "serving.pipeline_failover_failed", "error",
                    sid=self.sid, stage=dead_stage, error=str(e)[:120],
                )
            return False
        if not isinstance(resp, dict) or resp.get("error") or \
                not resp.get("node"):
            return False
        winfo = resp["node"]
        old = self.route[dead_stage - 1]
        self.route[dead_stage - 1] = dict(winfo)
        # a stale peer handle to the dead node must not be reused
        self.node.peers.pop(old.get("node_id"), None)
        self._opened = False
        try:
            # re-handshake (PIPE_LOAD) then hard-reset every stage's
            # slots — re-prefill rebuilds all KV from scratch
            await self.open()
            for i in range(1, self.n_stages):
                peer = await self._stage_peer(i)
                resp = await self.node.request(peer, {
                    "type": "PIPE_LOAD", "sid": self.sid, "stage": i,
                    "n_stages": self.n_stages, "slots": self.slots,
                    "max_len": self.L, "reset": True,
                })
                self._check_act(resp, "PIPE_LOAD")
            await asyncio.to_thread(self.engine.reset_all)
            for req in self._active():
                if req["done"].is_set():
                    continue
                self._refills += 1
                req["state"] = "prefill"
                await self._prefill(req)
        except (ServingError, TimeoutError, ConnectionError, OSError,
                asyncio.TimeoutError) as e:
            if getattr(node, "flight", None) is not None:
                node.flight.record(
                    "serving.pipeline_failover_failed", "error",
                    sid=self.sid, stage=dead_stage, error=str(e)[:120],
                )
            return False
        if getattr(node, "flight", None) is not None:
            node.flight.record(
                "serving.pipeline_failover_done", "info", sid=self.sid,
                stage=dead_stage, replacement=str(
                    winfo.get("node_id"))[:16],
            )
        return True

    # ------------------------------------------------------- bookkeeping
    def _finish(self, req: dict) -> None:
        self._release(req)
        req["state"] = "done"
        self._meter_finish(req)
        self._finish_span(req, "ok")
        req["done"].set()

    def _fail(self, req: dict, err: Exception) -> None:
        self._release(req)
        req["state"] = "failed"
        req["error"] = err
        self._finish_span(req, "error")
        req["done"].set()

    def _finish_span(self, req: dict, status: str) -> None:
        sp = req.pop("span", None)
        if sp is not None:
            tracer = getattr(self.node, "tracer", None)
            if tracer is not None:
                tracer.finish_span(sp, status=status)

    def _meter_finish(self, req: dict) -> None:
        """Freeze this request's meter for receipt signing (successful
        completions only — a failed stream delivered nothing billable).
        The worker's ``work_receipt``/``pending_receipts`` read these
        through the same ``meter``/``drain_meters`` surface the flat
        engines expose."""
        if not self.metering:
            return
        t0 = req.get("t_wall0") or time.time()
        meter = {
            "rid": int(req["rid"]),
            "tenant": req.get("tenant"),
            "kind": self.meter_kind,
            "t_start": float(t0),
            "t_end": float(
                t0 + max(time.perf_counter() - req.get("t0", 0.0), 0.0)
            ) if req.get("t0") else float(t0),
            "prompt_tokens": len(req["ids"]),
            "emitted_tokens": len(req["tokens"]),
            "busy_s": float(req.get("busy_s", 0.0)),
            "flops": 0.0,
            "hbm_bytes": 0.0,
            "kv_block_s": float(req.get("kv_block_s", 0.0)),
            "wire_bytes": int(req.get("wire_bytes", 0.0)),
        }
        self._meter_log[meter["rid"]] = meter
        while len(self._meter_log) > 4096:
            self._meter_log.popitem(last=False)
        self._meter_fresh.append(meter)
        self._metered_total += 1

    def meter(self, rid: int) -> dict | None:
        return self._meter_log.get(int(rid))

    def drain_meters(self, limit: int = 64) -> list[dict]:
        out: list[dict] = []
        while self._meter_fresh and len(out) < limit:
            out.append(self._meter_fresh.popleft())
        return out

    def _release(self, req: dict) -> None:
        # close the KV block-seconds rectangle while the blocks are
        # still attributable to this request
        if req.get("kv_anchor") is not None:
            req["kv_block_s"] += req.get("kv_blocks", 0) * max(
                time.perf_counter() - req["kv_anchor"], 0.0
            )
            req["kv_anchor"] = None
        slot = req.get("slot")
        if slot is not None and self._slot_rid[slot] == req["rid"]:
            self._slot_rid[slot] = None
            # stage-0 blocks free now; downstream stages recycle a
            # slot's blocks at its next admission (their pools are
            # sized for all slots fully resident, so lazy reclamation
            # cannot strand capacity)
            try:
                # the device part waits for the stage's next run, on a
                # compute thread (no CUDA work on the event loop)
                self.engine.release_slot(slot, defer=True)
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        req["slot"] = None
        self._wake.set()

    def _fail_all(self, err: Exception) -> None:
        for rid in list(self._queue):
            req = self._requests.get(rid)
            if req is not None and not req["done"].is_set():
                self._fail(req, err)
        self._queue.clear()
        for req in self._active():
            if not req["done"].is_set():
                self._fail(req, err)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "pipeline": {
                "sid": self.sid,
                "stage": 0,
                "n_stages": self.n_stages,
                "ticks": self._ticks,
                "act_wire_bytes": self._act_bytes,
                "failovers": self._failovers,
                "reprefills": self._refills,
                "queued": len(self._queue),
                "active": len(self._active()),
            },
            "metering": {
                "enabled": self.metering,
                "metered_total": self._metered_total,
                "undrained": len(self._meter_fresh),
            },
            "stage0": self.engine.stats(),
            "pool": self.engine.pool.stats(),
        }
