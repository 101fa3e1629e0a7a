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
  write frontier. When the pool runs short, the newest request is
  preempted: its blocks free, it re-queues, and it resumes
  token-identical because sampling depends on (request seed, logical
  position) only.
- a finished request's slot is retired on the device (block table to
  the sentinel, so later writes through it drop) before its blocks
  return to the pool.

Device state: the JAX engines donate their state tree to each program.
Here the caches, write index, per-slot vectors (fed token, valid count,
budget, liveness, sampling seed) and the chunk's [K, S] token output are
preallocated device buffers that the chunk body updates in place, so a
captured graph keeps reading the live buffers. The chunk body reads no
host value but its graph key (the blocks of a blockwise read on the
contiguous cache above 2048 slots) and makes no host read.

Chunks in flight: as in the reference, ``pipeline_depth`` (default 2)
decode chunks stay in flight. Each dispatch copies the chunk's tokens
into one of ``pipeline_depth + 1`` pinned host buffers and records an
event; ``step`` drains the oldest chunk once more than
``pipeline_depth`` are in flight (all of them when idle), which is the
one host sync. A prefill's first token stays a device scalar (copied
out the same way) until the first chunk after it drains; TTFT is stamped
when its event is seen complete. Requests finish, and their slots and
blocks free, at drain.

Not ported yet (see ROADMAP): speculation, priorities, deadlines and
retry-after, metering and receipts, disaggregated prefill export and
import, autotune and the compile cache, device timing, chaos hooks,
self-healing, ``aresult``.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tensorlink_tpu_torch.nn.attention import paged_write_slots
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    sample_logits_at,
)
from tensorlink_tpu_torch.parallel.kvpool import (
    BlockPool,
    PoolExhaustedError,
    PrefixIndex,
)
from tensorlink_tpu_torch.runtime.graphs import GraphCache

__all__ = [
    "ContinuousBatchingEngine",
    "OverloadedError",
    "PagedContinuousBatchingEngine",
    "PoolExhaustedError",
    "PoolOverloadedError",
    "PromptTooLongError",
    "QueueFullError",
    "ServingError",
]


class ServingError(RuntimeError):
    """Base class for scheduler rejections."""


class PromptTooLongError(ServingError):
    """Prompt (plus its token budget) cannot fit a slot's view."""


class OverloadedError(ServingError):
    """The scheduler shed this request; ``reason`` names the resource."""

    def __init__(self, msg: str, *, reason: str = "overloaded"):
        super().__init__(msg)
        self.reason = reason


class QueueFullError(OverloadedError):
    """Admission queue at max_queue with every slot busy."""

    def __init__(self, msg: str):
        super().__init__(msg, reason="queue_full")


class PoolOverloadedError(OverloadedError, PoolExhaustedError):
    """Queue at max_queue while slots are free: starved on KV blocks."""

    def __init__(self, msg: str):
        super().__init__(msg, reason="pool_exhausted")


@dataclass
class _Request:
    rid: int
    ids: np.ndarray | None  # [T0] prompt tokens (dropped once finished)
    max_new: int
    seed: int
    submitted_at: float
    slot: int | None = None
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None
    prefill_chunks: int = 0
    # the prefill's first token on its way to the host: (host tensor,
    # event or None), taken at the first drain after it
    first_token: tuple | None = None


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over per-slot contiguous cache
    regions on one device.

    ``slots``: decode batch width (a slot row is one request).
    ``decode_chunk``: T == 1 steps per scheduler step (one captured graph
    on CUDA). ``pipeline_depth``: decode chunks kept in flight before the
    host syncs the oldest (0: every step reads its own chunk back).
    ``prefill_block``: prompt lengths round up to a multiple of this.
    ``max_queue``: pending admissions beyond which ``submit`` raises an
    ``OverloadedError`` when no slot is free. ``keep_results``: finished
    requests kept readable through ``result``. ``cuda_graphs`` (CUDA
    only): decode chunks run as graph replays (True) or eagerly (False),
    the same chunk body either way.
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
        self.decode_chunk = K = int(decode_chunk)
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.prefill_block = int(prefill_block)
        self.max_queue = max_queue
        self.keep_results = max(int(keep_results), 1)
        self.L = L = engine.cache_len

        dev = self.device
        self._valid = torch.zeros((S, L), dtype=torch.bool, device=dev)
        self._n_valid = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._tok = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._remaining = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._live = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._seed = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._rows = torch.arange(S, device=dev)
        self._out = torch.zeros((K, S), dtype=torch.int64, device=dev)
        self._graphs = GraphCache(dev, enabled=cuda_graphs)
        # dispatched, not yet drained: (host tokens [K, S], event or None,
        # the dispatch-time slot -> request snapshot)
        self._inflight: collections.deque = collections.deque()
        pin = dev.type == "cuda"
        self._host_out = [
            torch.zeros((K, S), dtype=torch.int64, pin_memory=pin)
            for _ in range(self.pipeline_depth + 1)
        ]
        self._dispatched = 0

        # host-side scheduler state
        self._queue: list[_Request] = []
        self._requests: dict[int, _Request] = {}
        self._done_order: collections.deque[int] = collections.deque()
        self._slot_req: list[_Request | None] = [None] * S
        self._free: list[int] = list(range(S))[::-1]
        self._next_rid = 0
        # upper bound of each slot's device write index once every
        # dispatched chunk has run
        self._slot_ub = [0] * S

        # counters
        self.prefill_chunks = 0  # prefill programs run
        self.decode_steps = 0  # T == 1 model steps dispatched
        self._drained_tokens = 0
        # steps that ran decode and no prefill: wall time (each drain ends
        # in a device sync, so the sum is device-inclusive) and the tokens
        # drained in them
        self.decode_only_s = 0.0
        self.decode_only_tokens = 0
        self._init_state()

    def _init_state(self) -> None:
        """Every layer's [S, L] cache regions and the per-slot write
        index they share."""
        eng, S = self.engine, self.slots
        caches = eng.model.init_caches(S, self.L, dtype=eng.cache_dtype)
        self._kv = [(c["attn"]["k"], c["attn"]["v"]) for c in caches]
        self._cache_index = torch.zeros((S,), dtype=torch.int32, device=self.device)
        # host mirror: the write index each slot's prefill left behind
        # (the prompt's padded length); a running request has since
        # advanced it by one a decoded token
        self._slot_base = [0] * S
        self.kv_bytes = sum(t.numel() * t.element_size() for kv in self._kv for t in kv)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without a stream sync (a blocking
        copy would wait for every chunk in flight)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------ submit
    def submit(self, ids, *, max_new: int | None = None, seed: int = 0) -> int:
        """Enqueue one prompt (1-D token array); returns a request id.
        Raises ``PromptTooLongError`` when prompt + budget cannot fit a
        slot, and an ``OverloadedError`` past ``max_queue`` pending
        requests."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new if max_new is not None else self.gen.max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self._check_fit(int(ids.size), max_new)
        # fill free slots first, so max_queue bounds work that waits
        self._admit_waiting()
        self._check_backpressure()
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid=rid, ids=ids.astype(np.int64), max_new=max_new,
            seed=int(seed), submitted_at=time.perf_counter(),
        )
        self._requests[rid] = req
        self._queue.append(req)
        self._admit_waiting()
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

    def _check_backpressure(self) -> None:
        if self.max_queue is None or self._free or len(self._queue) < self.max_queue:
            return
        raise QueueFullError(
            f"{len(self._queue)} requests pending (max_queue={self.max_queue})"
        )

    # --------------------------------------------------------- admission
    def _admit_waiting(self) -> None:
        while self._free and self._queue:
            req = min(self._queue, key=lambda r: r.rid)
            self._queue.remove(req)
            self._admit(req)

    @torch.no_grad()
    def _admit(self, req: _Request) -> None:
        """Prefill the prompt into a free slot's region: left-padded to
        its bucket Tp, attending its fresh keys, written in place at
        slots [0, Tp); the first token is sampled on the device and read
        at the next drain."""
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
        mask = (qslot >= qslot.T) & real[None, :]  # key at or before query
        index = torch.zeros((), dtype=torch.int32, device=dev)
        caches = [
            {"attn": {"k": k[slot:slot + 1], "v": v[slot:slot + 1], "index": index}}
            for k, v in self._kv
        ]
        model = self.engine.model
        hidden, _ = model(ids, caches=caches, positions=pos,
                          mask=mask[None, None], logits=False)
        self._valid[slot] = False
        self._valid[slot, :Tp] = real
        self._cache_index[slot] = Tp
        self._slot_base[slot] = Tp
        self._slot_ub[slot] = Tp
        self._start_row(slot, model.head(hidden[0, -1]), req.seed, t0,
                        req.max_new, True)
        self.prefill_chunks += 1
        req.prefill_chunks += 1
        req.first_token = self._stash_first(self._tok[slot])

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
        reference's ``is_ready`` poll, here the copy's event)."""
        if req.first_token_at is not None or req.first_token is None:
            return
        event = req.first_token[1]
        if event is None or event.query():
            req.first_token_at = time.perf_counter()

    def _take_first(self, req: _Request) -> None:
        """Fold the prefill's first token into the request's stream."""
        if req.first_token is None:
            return
        host, event = req.first_token
        if event is not None:
            event.synchronize()
        self._maybe_record_ttft(req)
        req.first_token = None
        self._append_token(req, int(host))

    # ------------------------------------------------------------ decode
    def _step_caches(self, index, frontier) -> list[dict]:
        """Per-layer cache dicts for a decode step, with the host bounds of
        the decoding rows' write frontiers (dead rows decode garbage that
        nobody reads)."""
        return [
            {"attn": {"k": kk, "v": vv, "index": index, "frontier": frontier}}
            for kk, vv in self._kv
        ]

    def _frontier(self, decoding: list[int]):
        """Host ``(lo, hi)`` bounding every decoding row's write index over
        the next chunk's K steps: ``hi`` from the index's upper bound once
        the chunks in flight have run, plus K - 1; ``lo`` from the tokens
        drained so far (it may lag, which only widens a windowed read)."""
        K = self.decode_chunk
        lo = min(
            self._slot_base[s] + max(len(self._slot_req[s].tokens) - 1, 0)
            for s in decoding
        )
        return lo, max(self._slot_ub[s] for s in decoding) + K - 1

    def _chunk_key(self, frontier):
        """What a chunk bakes in: the blocks each layer's blockwise read
        spans (None on the full-width read, which reads no host value)."""
        return tuple(
            blk.attn.decode_blocks(self.L, frontier)
            for blk in self.engine.model.blocks.blocks()
        )

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

    @torch.no_grad()
    def _dispatch_decode(self, decoding: list[int]) -> None:
        """Run one chunk (a graph replay on CUDA) and start its tokens'
        copy to the host; the chunk joins the in-flight queue."""
        frontier = self._frontier(decoding)
        self._graphs.run(self._chunk_key(frontier),
                         lambda: self._chunk_body(frontier))
        self.decode_steps += self.decode_chunk
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
        self._inflight.append((host, event, snap))
        self._advance_ub(decoding)

    def _advance_ub(self, decoding: list[int]) -> None:
        for s in decoding:
            req = self._slot_req[s]
            self._slot_ub[s] = min(self._slot_ub[s] + self.decode_chunk,
                                   self._slot_base[s] + req.max_new - 1)

    def _drain_one(self) -> None:
        """Sync the oldest chunk in flight (the one host sync) and hand its
        tokens to the requests of its dispatch-time snapshot."""
        host, event, snap = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        for req in snap:
            if req is not None:
                self._take_first(req)
        toks = host.numpy()
        for k in range(toks.shape[0]):
            for s, req in enumerate(snap):
                if req is not None and not req.done:
                    self._append_token(req, int(toks[k, s]))
                    self._drained_tokens += 1

    # ---------------------------------------------------------- lifetime
    def _finish(self, req: _Request) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        req.ids = None
        slot = req.slot
        if slot is not None and self._slot_req[slot] is req:
            self._slot_req[slot] = None
            self._free.append(slot)
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
        """One scheduler iteration: admit waiting prompts, run the step's
        prefill work, dispatch one decode chunk, then drain the oldest
        chunks until ``pipeline_depth`` stay in flight (all of them when
        nothing was dispatched). Returns False when fully idle."""
        t_start = time.perf_counter()
        chunks0, drained0 = self.prefill_chunks, self._drained_tokens
        self._admit_waiting()
        self._prefill_step()
        decoding = self._decoding_slots()
        if decoding:
            self._dispatch_decode(decoding)
        for r in self._slot_req:
            if r is not None:
                self._maybe_record_ttft(r)
        prefilled = self.prefill_chunks != chunks0
        busy = bool(decoding) or prefilled
        while len(self._inflight) > (self.pipeline_depth if busy else 0):
            self._drain_one()
        if decoding and not prefilled:
            self.decode_only_s += time.perf_counter() - t_start
            self.decode_only_tokens += self._drained_tokens - drained0
        return busy or bool(self._inflight) or self._busy()

    def result(self, rid: int) -> np.ndarray:
        """Drive the loop until request ``rid`` finishes; its tokens."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(
                f"unknown request id {rid} (never submitted, or its result "
                f"was evicted after {self.keep_results} newer completions)"
            )
        while not req.done:
            if not self.step() and not req.done:
                raise ServingError(
                    f"request {rid} cannot complete: scheduler idle"
                )
        return np.asarray(req.tokens, np.int64)

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

    def stats(self) -> dict:
        """Host-side scheduler snapshot, with the decode graphs' counters
        (graphs held, captured, capture s, replays, pool bytes)."""
        return {
            "slots": self.slots,
            "busy_slots": sum(r is not None for r in self._slot_req),
            "queued": len(self._queue),
            "requests": len(self._requests),
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "inflight_chunks": len(self._inflight),
            "graphs": self._graphs.stats(),
        }


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged KV cache on one device.

    ``slots``: decode batch width. ``decode_chunk``: T == 1 steps per
    scheduler step. ``block_size``: tokens per KV block; it must divide
    the engine's cache length. ``num_blocks`` defaults to
    ``slots * cache_len / block_size`` (never tighter than one full view
    per slot). ``prefill_chunk``: tokens per prefill program.
    ``prefix_cache``: share resident prompt prefixes. ``kv_quant``:
    None or "int8" pools. ``max_queue``: pending admissions beyond which
    ``submit`` raises an ``OverloadedError``.
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
        self._slot_blocks: list[list[int]] = [[] for _ in range(S)]
        self._slot_ub = [0] * S  # device write-frontier upper bound
        self._slot_limit = [0] * S  # prompt + budget cap, in tokens
        self._pending: dict[int, dict] = {}  # slot -> prefill job
        self.prefix_matched_tokens = 0
        self.prompt_tokens_total = 0
        self.prefilled_tokens = 0
        self.peak_blocks_in_use = 0
        self.cow_copies = 0
        self.preemptions = 0

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

    def _check_backpressure(self) -> None:
        if self.max_queue is None or len(self._queue) < self.max_queue:
            return
        if self._free:
            raise PoolOverloadedError(
                f"{len(self._queue)} requests pending on KV blocks "
                f"({self.pool.in_use}/{self.pool.num_blocks} in use, "
                f"max_queue={self.max_queue})"
            )
        raise QueueFullError(
            f"{len(self._queue)} requests pending (max_queue={self.max_queue})"
        )

    def _admit_waiting(self) -> None:
        # FIFO by rid: a preempted request keeps its rid and resumes
        # ahead of later arrivals; a head that cannot get blocks makes
        # everyone behind it wait too
        while self._free and self._queue:
            head = min(self._queue, key=lambda r: r.rid)
            if not self._try_admit(head):
                break
            self._queue.remove(head)

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
                self.pool.retain(b)
                taken.append(b)
            if tail is not None:
                bid, _fill = tail
                if self.pool.refcount(bid) == 0:
                    # sole owner: revive and extend in place
                    self.pool.retain(bid)
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
        self._slot_limit[slot] = min(t0 + max_new_eff, self.L)
        self._slot_ub[slot] = t0
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

    def _step_caches(self, index, frontier) -> list[dict]:
        return self._caches(index, self._block_table, 1)

    def _frontier(self, decoding: list[int]):
        return None  # the paged read takes its bounds from the device

    def _chunk_key(self, frontier):
        return ()  # the chunk reads no host value: one graph

    def _advance_ub(self, decoding: list[int]) -> None:
        pass  # ``_grow_blocks`` advanced it before the dispatch

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
        slot = min(self._pending, key=lambda s: self._slot_req[s].rid)
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
        hidden, _ = self.engine.model(
            self._to_device(buf), caches=self._caches(index, bt, C),
            positions=positions, mask=None, logits=False,
        )
        n_end = pos + nreal
        self._cache_index[slot] = n_end
        self._valid[slot] = torch.arange(self.L, device=dev) < n_end
        self._start_row(slot, self.engine.model.head(hidden[0, nreal - 1]),
                        job["seed"], n_end, job["max_new"], is_final)
        self.prefill_chunks += 1
        job["pos"] = n_end
        req = self._slot_req[slot]
        req.prefill_chunks += 1
        if is_final:
            del self._pending[slot]
            self._slot_ub[slot] = len(ids)
            if self.index is not None:
                # register the PROMPT prefix as soon as its blocks are
                # written: a concurrent request sharing it hits at once
                for b in self.index.register(req.ids, self._slot_blocks[slot]):
                    self.pool.mark_cached(b)
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
        self._slot_req[slot] = None
        req.slot = None
        self._free.append(slot)
        self._queue.append(req)

    def _alloc_with_preemption(self, n: int, protect: int):
        """Allocate ``n`` blocks, preempting the newest other request
        under pressure. None when ``protect`` itself had to go."""
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
                self._preempt(max(victims, key=lambda s: self._slot_req[s].rid))

    def _grow_blocks(self, decoding: list[int]) -> list[int]:
        """Extend block tables ahead of the decode write frontier: the
        next chunk advances each live row by up to ``decode_chunk``
        positions, so the blocks must exist before it is dispatched.
        ``_slot_ub`` moves by ``decode_chunk`` at every dispatch, so it
        already covers the chunks still in flight, which the host has not
        seen the tokens of. Returns the decoding set minus any preempted
        slots."""
        bs = self.block_size
        for slot in decoding:
            req = self._slot_req[slot]
            if req is None or slot in self._pending:
                continue  # preempted (or re-queued) by an earlier growth
            target = min(
                self._slot_ub[slot] + self.decode_chunk, self._slot_limit[slot]
            )
            need = -(-target // bs)
            have = len(self._slot_blocks[slot])
            if need > have:
                got = self._alloc_with_preemption(need - have, slot)
                if got is None:
                    continue  # the slot itself was evicted
                self._slot_blocks[slot].extend(got)
                self._set_row(slot)
            self._slot_ub[slot] = target
        return [
            s for s in decoding
            if self._slot_req[s] is not None and s not in self._pending
        ]

    def _prefill_step(self) -> None:
        self._dispatch_prefill_chunk()

    def _decoding_slots(self) -> list[int]:
        decoding = [
            s for s, r in enumerate(self._slot_req)
            if r is not None and s not in self._pending
        ]
        return self._grow_blocks(decoding) if decoding else decoding

    def _busy(self) -> bool:
        return bool(self._queue or self._pending)

    def step(self) -> bool:
        """One scheduler iteration: admit, run at most one prefill chunk,
        grow block tables, dispatch one decode chunk, drain. Returns False
        when fully idle."""
        busy = super().step()
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.pool.in_use)
        return busy

    def prefix_hit_rate(self) -> float:
        if not self.prompt_tokens_total:
            return 0.0
        return self.prefix_matched_tokens / self.prompt_tokens_total

    def stats(self) -> dict:
        return {
            **super().stats(),
            "pool": self.pool.stats(),
            "prefilling": len(self._pending),
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "prompt_tokens_total": self.prompt_tokens_total,
            "prefix_matched_tokens": self.prefix_matched_tokens,
            "prefilled_tokens": self.prefilled_tokens,
            "prefix_cache_hit_rate": round(self.prefix_hit_rate(), 4),
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
        }
