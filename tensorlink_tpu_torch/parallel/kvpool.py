"""Paged KV-cache pool: fixed-size blocks, refcounts, prefix sharing.

The port's own copy of ``tensorlink_tpu/parallel/kvpool.py`` (numpy
only): importing any ``tensorlink_tpu`` submodule would import JAX, so
the port keeps this file beside its engine instead. Keep the two in
step.

The continuous-batching engine (parallel/serving.py) historically
reserved one contiguous ``max_len`` cache region per slot, so HBM
scaled with ``slots x worst-case length`` and two requests sharing a
system prompt each paid a full prefill. This module is the host-side
half of the paged alternative (ROADMAP item 1):

- ``BlockPool``: a free-list allocator over ``num_blocks`` fixed-size
  blocks with per-block refcounts. Blocks whose refcount drops to zero
  but that still back a registered prompt prefix park in an LRU
  "reusable" list — they satisfy future prefix hits for free and are
  evicted (oldest first) only when allocation would otherwise fail.
  Exhaustion raises the typed ``PoolExhaustedError`` (backpressure,
  never a shape error) and lands a flight-recorder event.

- ``PrefixIndex``: a refcount-friendly radix-style index over prompt
  prefixes at block granularity. Keys are CHAINED digests — block i's
  key is ``H(key_{i-1} || tokens[i*bs:(i+1)*bs])`` — so a lookup walks
  the prompt block by block exactly like a radix trie walks edges,
  with O(1) state per step and no collision-prone flat hashing of
  arbitrary-length prefixes. Partial tail blocks (a prompt whose length
  is not a block multiple) index under ``(parent key, fill)`` so an
  exact-prefix request can share them too; writing into a shared block
  is what triggers copy-on-write in the engine.

The DEVICE half — ``block_table[pos // bs] * bs + pos % bs`` cache
addressing — lives in nn/attention.py (the paged cache form) and
parallel/serving.py (the paged engine state); this module is pure
host-side bookkeeping and deliberately jax-free.
"""

from __future__ import annotations

import collections
import hashlib
import time

import numpy as np


class PoolExhaustedError(RuntimeError):
    """No free or evictable block can satisfy the allocation — typed
    backpressure for admission control (the pool-level analogue of
    serving.QueueFullError), never a shape error downstream."""


class BlockPool:
    """Fixed-size KV block allocator with refcounts and LRU reuse.

    A block id is an index into the device-side per-layer pools
    ``[num_blocks, block_size, Hkv, D]`` (nn/attention.py paged form).
    The pool itself never touches device memory — it only decides which
    block ids are live, shared, reusable (cached prefix, refcount 0),
    or free.

    States: FREE (never written / fully forgotten) -> LIVE (refcount
    >= 1) -> REUSABLE (refcount 0 but prefix-registered; an LRU hit
    revives it, allocation pressure evicts it via ``evict_hook``) ->
    FREE.
    """

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        *,
        metrics=None,
        recorder=None,
    ):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}, {block_size}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.metrics = metrics
        self.recorder = recorder
        self._free: collections.deque[int] = collections.deque(
            range(self.num_blocks)
        )
        self._refs = [0] * self.num_blocks
        # refcount-0 blocks still backing a registered prefix, oldest
        # first — the prefix cache's eviction order
        self._reusable: collections.OrderedDict[int, None] = (
            collections.OrderedDict()
        )
        self._cached: set[int] = set()  # prefix-registered block ids
        # SLO class of the request whose prefix a cached block backs
        # (serving.Priority value; jax-free here on purpose — it is
        # just an eviction rank). Under allocation pressure the least
        # protected class evicts first, oldest-first within a class,
        # so BATCH system prompts never push an INTERACTIVE tenant's
        # resident prefix out of the pool.
        self._cached_prio: dict[int, int] = {}
        # owner wires this to PrefixIndex.forget_block so evicting a
        # reusable block also drops its index entries
        self.evict_hook = None
        self.in_use = 0  # blocks with refcount >= 1

    # ------------------------------------------------------------- events
    def _event(self, kind: str, severity: str = "info", **data) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record(kind, severity, **data)
            except Exception:  # noqa: BLE001 — telemetry must not fail allocs
                pass

    # ---------------------------------------------------------------- API
    @property
    def available(self) -> int:
        """Blocks an alloc() could hand out right now (free + evictable)."""
        return len(self._free) + len(self._reusable)

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate ``n`` blocks (refcount 1 each). Prefers never-used
        free blocks; under pressure evicts the oldest reusable blocks
        (forgetting their prefix entries). Raises ``PoolExhaustedError``
        when fewer than ``n`` blocks exist in either state."""
        if n < 0:
            raise ValueError(f"alloc of {n} blocks")
        if self.available < n:
            self._event(
                "kvpool.exhausted", "warn",
                requested=n, free=len(self._free),
                reusable=len(self._reusable), in_use=self.in_use,
            )
            if self.metrics is not None:
                self.metrics.incr("kv_pool_exhausted_total")
            raise PoolExhaustedError(
                f"need {n} KV blocks; {len(self._free)} free + "
                f"{len(self._reusable)} evictable of {self.num_blocks} "
                f"({self.in_use} in use)"
            )
        out: list[int] = []
        evicted = 0
        for _ in range(n):
            if self._free:
                bid = self._free.popleft()
            else:
                bid = self._evict_candidate()
                del self._reusable[bid]
                self._forget(bid)
                evicted += 1
            self._refs[bid] = 1
            self.in_use += 1
            out.append(bid)
        self._event(
            "kvpool.alloc", blocks=n, evicted=evicted, in_use=self.in_use
        )
        return out

    def retain(self, bid: int, priority: int | None = None) -> None:
        """Refcount++ (prefix hit / sharer). Revives a reusable block.
        ``priority`` upgrades (never downgrades) the block's cached
        eviction class: a prefix WARMED by BATCH but HIT by INTERACTIVE
        is protecting interactive traffic and must be ranked by its
        most protected consumer, not its first writer."""
        if self._refs[bid] == 0:
            if bid not in self._reusable:
                raise ValueError(
                    f"retain of free block {bid} (never allocated or "
                    "already forgotten) — allocate it instead"
                )
            del self._reusable[bid]
            self.in_use += 1
        self._refs[bid] += 1
        if priority is not None and bid in self._cached:
            self._cached_prio[bid] = min(
                self._cached_prio.get(bid, 2), int(priority)
            )

    def release(self, bid: int) -> None:
        """Refcount--. At zero the block parks reusable if it still
        backs a registered prefix, else returns to the free list.
        A negative refcount is an accounting bug and raises."""
        if self._refs[bid] <= 0:
            raise ValueError(
                f"release of block {bid} with refcount {self._refs[bid]} "
                "(double free)"
            )
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self.in_use -= 1
            if bid in self._cached:
                self._reusable[bid] = None  # newest at the end (LRU)
            else:
                self._free.append(bid)
            self._event("kvpool.free", block=bid, in_use=self.in_use)

    def _evict_candidate(self) -> int:
        """Priority-then-LRU eviction: the OLDEST reusable block of the
        LEAST protected priority class. Iteration is oldest-first, so
        the first block seen of the worst class present wins; a pool
        with no priority annotations degenerates to plain LRU."""
        worst = None
        worst_p = -1
        for bid in self._reusable:  # oldest -> newest
            p = self._cached_prio.get(bid, 2)
            if p > worst_p:
                worst, worst_p = bid, p
                if p >= 2:  # least protected class, oldest — done
                    break
        return worst

    def mark_cached(self, bid: int, priority: int = 2) -> None:
        """Flag a block as prefix-registered: at refcount 0 it parks
        reusable (serving future prefix hits) instead of freeing.
        ``priority`` (serving.Priority value; defaults to the least
        protected class) ranks it for pressure eviction — min-merged
        with any existing annotation, so re-registration can upgrade
        but never strip protection."""
        self._cached.add(bid)
        old = self._cached_prio.get(bid)
        self._cached_prio[bid] = (
            int(priority) if old is None else min(old, int(priority))
        )

    def touch(self, bid: int) -> None:
        """LRU bump for a reusable block that served a read-only hit."""
        if bid in self._reusable:
            self._reusable.move_to_end(bid)

    def _forget(self, bid: int) -> None:
        self._cached.discard(bid)
        self._cached_prio.pop(bid, None)
        if self.evict_hook is not None:
            self.evict_hook(bid)
        self._event("kvpool.evict", block=bid)

    def stats(self) -> dict:
        # "fragmentation" for a paged pool: the fraction of the
        # allocatable headroom that is REUSABLE rather than clean-free
        # — an alloc under pressure must evict (and forget prefix
        # entries) for that fraction of its blocks, so high
        # fragmentation means allocation is about to start costing
        # cache hits
        avail = len(self._free) + len(self._reusable)
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.in_use,
            "blocks_free": len(self._free),
            "blocks_reusable": len(self._reusable),
            "blocks_cached": len(self._cached),
            "utilization": round(self.in_use / self.num_blocks, 4),
            "fragmentation": round(
                len(self._reusable) / avail, 4
            ) if avail else 0.0,
        }


class PrefixIndex:
    """Radix-style prompt-prefix index at block granularity.

    Chained digests make each full block a trie edge: matching a prompt
    walks ``key_i = H(key_{i-1} || block_tokens)`` until a key misses.
    Partial tails (the last ``fill < block_size`` tokens of a prompt)
    register under their parent key so exact-prefix requests can share
    them; the caller copy-on-writes those before extending them.

    The index stores BLOCK IDS, not contents — the pool's
    ``evict_hook`` must point at :meth:`forget_block` so an evicted
    block's entries vanish with it.
    """

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._full: dict[bytes, int] = {}  # chain digest -> block id
        # parent digest -> {fill: (digest over fill tokens, block id)}
        self._partial: dict[bytes, dict[int, tuple[bytes, int]]] = {}
        self._by_block: dict[int, list[tuple]] = {}  # bid -> entry keys
        # residency metadata (the /kv introspection surface): parent
        # chain link per full entry (child digest -> parent digest, so
        # a leaf walks back to the root), and last-hit wall time per
        # entry key (full: digest; partial: ("p", parent, fill)) —
        # stamped at register and refreshed by every match() walk
        self._parent: dict[bytes, bytes] = {}
        self._last_hit: dict[object, float] = {}

    @staticmethod
    def _digest(parent: bytes, tokens: np.ndarray) -> bytes:
        return hashlib.sha1(
            parent + np.ascontiguousarray(tokens, np.int32).tobytes()
        ).digest()

    def match(
        self, ids: np.ndarray, *, max_tokens: int | None = None
    ) -> tuple[list[int], int, tuple[int, int] | None]:
        """Longest resident prefix of ``ids``.

        Returns ``(full_blocks, matched_tokens, tail)`` where
        ``full_blocks`` are the block ids covering the first
        ``len(full_blocks) * block_size`` tokens and ``tail`` is an
        optional ``(block_id, fill)`` partial-block hit extending the
        match by ``fill`` more tokens. ``matched_tokens`` counts both.
        Never matches past ``max_tokens`` (callers pass ``len(ids) - 1``
        so at least one token remains to prefill — the sampler needs
        its logits). The caller owns refcounts: nothing is retained
        here."""
        ids = np.asarray(ids).reshape(-1)
        bs = self.block_size
        cap = len(ids) if max_tokens is None else min(max_tokens, len(ids))
        blocks: list[int] = []
        key = b""
        n = 0
        hit_t = time.time()
        while n + bs <= cap:
            nxt = self._digest(key, ids[n:n + bs])
            bid = self._full.get(nxt)
            if bid is None:
                break
            blocks.append(bid)
            key = nxt
            self._last_hit[key] = hit_t
            n += bs
        tail = None
        fills = self._partial.get(key)
        if fills:
            for fill in sorted(fills, reverse=True):
                if n + fill > cap:
                    continue
                digest, bid = fills[fill]
                if self._digest(key, ids[n:n + fill]) == digest:
                    tail = (bid, fill)
                    self._last_hit[("p", key, fill)] = hit_t
                    n += fill
                    break
        return blocks, n, tail

    def register(self, ids: np.ndarray, blocks: list[int]) -> list[int]:
        """Index a prefilled prompt: every full block under its chain
        digest, the partial tail (if any) under its parent. Existing
        entries win (first writer keeps the cache slot — duplicates
        would just shadow it). Returns the block ids newly indexed, so
        the caller can ``pool.mark_cached`` them."""
        ids = np.asarray(ids).reshape(-1)
        bs = self.block_size
        newly: list[int] = []
        key = b""
        n = 0
        reg_t = time.time()
        for bid in blocks:
            if n + bs <= len(ids):
                nxt = self._digest(key, ids[n:n + bs])
                if nxt not in self._full:
                    self._full[nxt] = bid
                    self._parent[nxt] = key
                    self._last_hit[nxt] = reg_t
                    self._by_block.setdefault(bid, []).append(("f", nxt))
                    newly.append(bid)
                key = nxt
                n += bs
            else:
                fill = len(ids) - n
                if fill <= 0:
                    break
                fills = self._partial.setdefault(key, {})
                if fill not in fills:
                    fills[fill] = (self._digest(key, ids[n:n + fill]), bid)
                    self._last_hit[("p", key, fill)] = reg_t
                    self._by_block.setdefault(bid, []).append(
                        ("p", key, fill)
                    )
                    newly.append(bid)
                break
        return newly

    def chain_digest(self, ids: np.ndarray) -> bytes:
        """The chained digest over the FULL blocks of ``ids`` — the key
        the last full block indexes under. Exported with a KV-block
        wire payload (parallel/kvwire.py) so the decode leg can verify
        the token ids it was handed actually correspond to the blocks
        before registering them: the digest it recomputes from the ids
        must match, or the payload is internally inconsistent. Both
        sides computing the SAME chain is also what makes remote blocks
        index into the receiver's ``PrefixIndex`` at the same keys a
        local prefill would have produced."""
        ids = np.asarray(ids).reshape(-1)
        bs = self.block_size
        key = b""
        n = 0
        while n + bs <= len(ids):
            key = self._digest(key, ids[n:n + bs])
            n += bs
        return key

    def forget_block(self, bid: int) -> None:
        """Drop every entry pointing at ``bid`` (pool eviction hook)."""
        for entry in self._by_block.pop(bid, []):
            if entry[0] == "f":
                self._full.pop(entry[1], None)
                self._parent.pop(entry[1], None)
                self._last_hit.pop(entry[1], None)
            else:
                fills = self._partial.get(entry[1])
                if fills is not None:
                    fills.pop(entry[2], None)
                    if not fills:
                        del self._partial[entry[1]]
                self._last_hit.pop(("p", entry[1], entry[2]), None)

    def __len__(self) -> int:
        return len(self._full) + sum(
            len(f) for f in self._partial.values()
        )

    # -------------------------------------------------- residency surface
    def chains(self) -> list[dict]:
        """Every MAXIMAL resident prefix chain: a leaf full-block
        digest (no full child) walked back to the root via the parent
        links, plus every partial-tail entry as its own chain record.
        Block ids are listed root-first — exactly the prefix a future
        prompt would map. Caller holds whatever lock guards the index
        (the engine's scheduler lock)."""
        has_child = set(self._parent.values())
        out: list[dict] = []

        def walk(leaf: bytes) -> list[int]:
            bids: list[int] = []
            key = leaf
            while key:
                bid = self._full.get(key)
                if bid is None:
                    # an INTERIOR ancestor was evicted out from under
                    # this chain (forget_block drops one digest, not
                    # its descendants' parent links): report only the
                    # resident suffix — those blocks are unreachable
                    # garbage awaiting LRU eviction, not a mappable
                    # prefix, but they DO occupy pool blocks
                    break
                bids.append(bid)
                key = self._parent.get(key, b"")
            bids.reverse()
            return bids

        for leaf in self._full:
            if leaf in has_child or leaf in self._partial:
                continue  # interior node: a longer chain covers it
            bids = walk(leaf)
            out.append({
                "digest": leaf.hex()[:16],
                "blocks": len(bids),
                "tokens": len(bids) * self.block_size,
                "block_ids": bids,
                "last_hit": self._last_hit.get(leaf),
            })
        for parent, fills in self._partial.items():
            base = walk(parent) if parent else []
            for fill, (_, bid) in fills.items():
                out.append({
                    "digest": (parent.hex()[:16] or "root")
                    + f"+{fill}",
                    "blocks": len(base) + 1,
                    "tokens": len(base) * self.block_size + fill,
                    "tail_fill": fill,
                    "block_ids": base + [bid],
                    "last_hit": self._last_hit.get(("p", parent, fill)),
                })
        return out


def kv_residency(
    pool: BlockPool | None,
    index: PrefixIndex | None,
    now: float | None = None,
    limit: int = 64,
) -> dict:
    """The ``GET /kv`` body: pool occupancy/fragmentation plus the
    resident prefix chains annotated with the pool's view of each
    chain's blocks — refcounts, eviction priority class (min over the
    chain: its most protected consumer), last-hit age. MUST be called
    under the lock that serializes pool/index mutation (the serving
    engine's scheduler lock) — the point is an exact snapshot, not a
    torn one."""
    t = time.time() if now is None else now
    out: dict = {
        "pool": pool.stats() if pool is not None else None,
        "chains": [],
        "total_chains": 0,
        "prefix_entries": len(index) if index is not None else 0,
    }
    if index is None:
        return out
    chains = index.chains()
    out["total_chains"] = len(chains)
    # the hottest prefixes first; bound the body (a node with thousands
    # of resident chains still answers in one small page)
    chains.sort(key=lambda c: c.get("last_hit") or 0.0, reverse=True)
    for c in chains[:limit]:
        rec = dict(c)
        hit = rec.pop("last_hit", None)
        rec["last_hit_age_s"] = (
            round(max(0.0, t - hit), 3) if hit else None
        )
        if pool is not None:
            bids = rec["block_ids"]
            rec["refs"] = sum(pool.refcount(b) for b in bids)
            rec["priority"] = min(
                (pool._cached_prio.get(b, 2) for b in bids), default=2
            )
        out["chains"].append(rec)
    if len(chains) > limit:
        out["truncated"] = len(chains) - limit
    return out


def kv_summary(
    pool: BlockPool | None, index: PrefixIndex | None
) -> dict:
    """Compact scalar form of :func:`kv_residency` — what rides the
    heartbeat delta to the validator's fleet table (the published-
    residency groundwork for prefix-affinity routing). Same locking
    contract as :func:`kv_residency`."""
    out: dict = {}
    if pool is not None:
        st = pool.stats()
        out.update({
            "num_blocks": st["num_blocks"],
            "used": st["blocks_in_use"],
            "free": st["blocks_free"],
            "reusable": st["blocks_reusable"],
            "cached": st["blocks_cached"],
            "occupancy": st["utilization"],
            "fragmentation": st["fragmentation"],
        })
    if index is not None:
        out["prefix_blocks"] = len(index._by_block)
        out["chains"] = sum(
            1 for _ in index.chains()
        )
    return out
