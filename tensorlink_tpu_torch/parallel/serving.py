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
  scheduler step (a Python loop standing in for the JAX package's
  ``lax.scan``); a row whose request ended parks, and its slot is free
  for the next admission.

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

Device state: the JAX engines donate their state tree to each program
and keep ``pipeline_depth`` chunks in flight. Here the caches, write
index and per-slot vectors are preallocated device buffers updated in
place, and each scheduler step reads its decode chunk's tokens back
before it returns (no chunk stays in flight).

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
    position_generator,
    sample_logits,
)
from tensorlink_tpu_torch.parallel.kvpool import (
    BlockPool,
    PoolExhaustedError,
    PrefixIndex,
)

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


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over per-slot contiguous cache
    regions on one device.

    ``slots``: decode batch width (a slot row is one request).
    ``decode_chunk``: T == 1 steps per scheduler step. ``prefill_block``:
    prompt lengths round up to a multiple of this. ``max_queue``: pending
    admissions beyond which ``submit`` raises an ``OverloadedError`` when
    no slot is free. ``keep_results``: finished requests kept readable
    through ``result``.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        slots: int = 8,
        gen: GenerationConfig | None = None,
        decode_chunk: int = 8,
        prefill_block: int = 32,
        max_queue: int | None = None,
        keep_results: int = 1024,
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
        self._slot_seed = [0] * S

        # host-side scheduler state
        self._queue: list[_Request] = []
        self._requests: dict[int, _Request] = {}
        self._done_order: collections.deque[int] = collections.deque()
        self._slot_req: list[_Request | None] = [None] * S
        self._free: list[int] = list(range(S))[::-1]
        self._next_rid = 0

        # counters
        self.prefill_chunks = 0  # prefill programs run
        self.decode_steps = 0  # T == 1 model steps run
        # steps that ran decode and no prefill: wall time (each step ends
        # in a device read, so the sum is device-inclusive) and the
        # tokens they emitted
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
        slots [0, Tp); the first token is sampled and read back."""
        slot = self._free.pop()
        req.slot = slot
        self._slot_req[slot] = req
        t0 = int(req.ids.size)
        Tp = self._bucket(t0)
        dev = self.device
        ids = torch.zeros((1, Tp), dtype=torch.long, device=dev)
        ids[0, Tp - t0:] = torch.from_numpy(req.ids).to(dev)
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
        tok0 = self._sample_one(model.head(hidden[0, -1]), req.seed, t0)
        done0 = torch.tensor(req.max_new <= 1, device=dev)
        if self.gen.eos_token_id is not None:
            done0 = done0 | (tok0 == self.gen.eos_token_id)
        self._cache_index[slot] = Tp
        self._slot_base[slot] = Tp
        self._valid[slot] = False
        self._valid[slot, :Tp] = real
        self._n_valid[slot] = t0
        self._tok[slot] = tok0
        self._slot_seed[slot] = req.seed
        self._remaining[slot] = req.max_new - 1
        self._live[slot] = ~done0
        self.prefill_chunks += 1
        req.prefill_chunks += 1
        first = int(tok0)
        req.first_token_at = time.perf_counter()
        self._append_token(req, first)

    def _sample_one(self, logits_row, seed: int, position: int):
        gen = self.gen
        g = None
        if gen.temperature != 0.0:
            g = position_generator(seed, position, logits_row.device)
        return sample_logits(
            logits_row, gen.temperature, gen.top_k, gen.top_p, generator=g
        )

    # ------------------------------------------------------------ decode
    def _step_caches(self, index, k: int) -> list[dict]:
        """Per-layer cache dicts for decode step ``k`` of a chunk, with the
        host bounds of the running rows' write frontiers (dead rows decode
        garbage that nobody reads)."""
        fronts = [
            self._slot_base[s] + len(r.tokens) - 1
            for s, r in enumerate(self._slot_req) if r is not None
        ]
        frontier = (min(fronts), max(fronts) + k)
        return [
            {"attn": {"k": kk, "v": vv, "index": index, "frontier": frontier}}
            for kk, vv in self._kv
        ]

    @torch.no_grad()
    def _decode_chunk(self) -> np.ndarray:
        """``decode_chunk`` T == 1 steps over every slot -> tokens
        [K, S] on the host (fill token where a row is not live)."""
        model, S, L = self.engine.model, self.slots, self.L
        dev = self.device
        gen = self.gen
        fill = gen.eos_token_id if gen.eos_token_id is not None else 0
        rows = torch.arange(S, device=dev)
        out = torch.empty((self.decode_chunk, S), dtype=torch.int64, device=dev)
        for k in range(self.decode_chunk):
            index, live = self._cache_index, self._live
            # the fed token's slot becomes attendable for live rows; an
            # index at capacity updates nothing (OR with False)
            at = index.long().clamp(max=L - 1)
            self._valid[rows, at] |= live & (index < L)
            logits, _ = model(
                self._tok[:, None],
                caches=self._step_caches(index, k),
                positions=self._n_valid[:, None],
                mask=self._valid[:, None, None, :],
            )
            step = live.int()
            # every row's k/v was written at its index; only live rows
            # consumed the slot
            self._cache_index = index + step
            self._n_valid = self._n_valid + step
            nxt = self._sample_rows(logits[:, -1])
            out[k] = torch.where(live, nxt, fill)
            self._remaining = self._remaining - step
            ended = self._remaining <= 0
            if gen.eos_token_id is not None:
                ended = ended | (nxt == gen.eos_token_id)
            self._tok = torch.where(live, nxt, self._tok)
            self._live = live & ~ended
            self.decode_steps += 1
        return out.cpu().numpy()

    def _sample_rows(self, logits):
        if self.gen.temperature == 0.0:
            return sample_logits(logits, 0.0)
        # (seed, position) per row; rows that are not live draw too and
        # are discarded
        n_valid = self._n_valid.tolist()
        return torch.stack([
            self._sample_one(logits[s], self._slot_seed[s], n_valid[s])
            for s in range(self.slots)
        ])

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

    def step(self) -> bool:
        """One scheduler iteration: admit waiting prompts, run the step's
        prefill work, run one decode chunk and hand its tokens to their
        requests. Returns False when fully idle."""
        t_start = time.perf_counter()
        chunks0 = self.prefill_chunks
        self._admit_waiting()
        self._prefill_step()
        decoding = self._decoding_slots()
        emitted = 0
        if decoding:
            live = set(decoding)
            snap = [
                r if s in live else None for s, r in enumerate(self._slot_req)
            ]
            toks = self._decode_chunk()
            for k in range(toks.shape[0]):
                for s, req in enumerate(snap):
                    if req is not None and not req.done:
                        self._append_token(req, int(toks[k, s]))
                        emitted += 1
        prefilled = self.prefill_chunks != chunks0
        if decoding and not prefilled:
            self.decode_only_s += time.perf_counter() - t_start
            self.decode_only_tokens += emitted
        return bool(prefilled or decoding or self._queue)

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
        """Host-side scheduler snapshot."""
        return {
            "slots": self.slots,
            "busy_slots": sum(r is not None for r in self._slot_req),
            "queued": len(self._queue),
            "requests": len(self._requests),
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
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
        self._block_table[slot] = torch.from_numpy(row).to(self.device)
        if start is not None:
            self._cache_index[slot] = start

    def _step_caches(self, index, k: int) -> list[dict]:
        return self._caches(index, self._block_table, 1)

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
            torch.from_numpy(buf).to(dev), caches=self._caches(index, bt, C),
            positions=positions, mask=None, logits=False,
        )
        n_end = pos + nreal
        last = self.engine.model.head(hidden[0, nreal - 1])
        tok0 = self._sample_one(last, job["seed"], n_end)
        max_new = job["max_new"]
        done0 = torch.tensor(max_new <= 1, device=dev)
        if self.gen.eos_token_id is not None:
            done0 = done0 | (tok0 == self.gen.eos_token_id)
        self._cache_index[slot] = n_end
        self._valid[slot] = torch.arange(self.L, device=dev) < n_end
        self._n_valid[slot] = n_end
        self._tok[slot] = tok0
        self._slot_seed[slot] = job["seed"]
        self._remaining[slot] = max_new - 1 if is_final else 0
        self._live[slot] = torch.tensor(is_final, device=dev) & ~done0
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
            first = int(tok0)
            if req.first_token_at is None:
                req.first_token_at = time.perf_counter()
            self._append_token(req, first)
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
        re-prefills prompt + banked tokens and continues token-identical."""
        req = self._slot_req[slot]
        self.preemptions += 1
        self._retire_row(slot)
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
        positions, so the blocks must exist before it runs. Returns the
        decoding set minus any preempted slots."""
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

    def step(self) -> bool:
        """One scheduler iteration: admit, run at most one prefill chunk,
        grow block tables, run one decode chunk and hand its tokens to
        their requests. Returns False when fully idle."""
        busy = super().step()
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.pool.in_use)
        return busy or bool(self._pending)

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
