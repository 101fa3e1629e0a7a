"""Worker: a compute provider binding its device (port of
``tensorlink_tpu/roles/worker.py``).

- A stage arrives as a spec + weights blob (the reference's names and
  layout); the worker rebuilds the module with ``module_from_config``
  and runs it with the shipped tensors through ``functional_call``.
- FORWARD / BACKWARD are async handlers that run the stage off the event
  loop (``asyncio.to_thread``) and relay to the next hop.
- The optimizer steps after the gradients apply.

:class:`StageRunner` keeps only a stage's inputs between forward and
backward: ``backward`` recomputes the stage under autograd from the
stashed input (the reference's rematerializing vjp). Train-mode dropout
draws from a ``torch.Generator`` seeded from (train seed, stage, step,
micro), so the recompute, and a validator's replay, reproduce the mask
(the reference folds the same four into a threefry key). Memory stats
keep the reference's keys; their numbers come from the CUDA caching
allocator around each new shape's first run (on the CPU: argument and
output bytes only) in place of XLA's compile-time memory analysis. A
stage runs on one device: a local tensor-parallel stage over several
devices is refused.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.nn.module import Module, module_from_config, param_tree
from tensorlink_tpu_torch.p2p.node import Node, Peer, wire_guard
from tensorlink_tpu_torch.p2p.serialization import (
    pack_arrays,
    packed_nbytes,
    tree_flatten_arrays,
    tree_unflatten_arrays,
    unpack_arrays,
)
from tensorlink_tpu_torch.runtime.mesh import local_device_info
from tensorlink_tpu_torch.train.optim import apply_updates, make_optimizer
from tensorlink_tpu_torch.utils.trees import flatten, tree_bytes


def _prog_total(m: dict) -> int:
    """Live device bytes of one stage program (args + temps + outs)."""
    return m["temp_bytes"] + m["argument_bytes"] + m["output_bytes"]


class StaleFenceError(RuntimeError):
    """A data-plane op from an aborted step attempt reached the runner
    after its fence advanced; the result must be discarded, not
    accumulated."""


def host_free_memory_bytes() -> int:
    try:
        import psutil

        return psutil.virtual_memory().available
    except ImportError:  # pragma: no cover
        return 1 << 30


def wire_params(tree_or_flat) -> dict[str, torch.Tensor]:
    """A received param tree (the reference's nested layout, ``{}`` for a
    parameterless child) -> flat state dict (empty subtrees dropped)."""
    if any(isinstance(v, dict) for v in tree_or_flat.values()):
        return flatten(tree_or_flat)
    return {k: v for k, v in tree_or_flat.items() if not k.endswith("//empty")}


def _add(a: dict | None, b: dict) -> dict:
    if a is None:
        return dict(b)
    return {k: a[k] + b[k] for k in a}


def _micro_seed(train_seed: int, stage: int, step: int, micro: int) -> int:
    """The dropout generator's seed for one (stage, step, micro)."""
    h = hashlib.sha256(
        f"{int(train_seed)}:{int(stage)}:{int(step)}:{int(micro)}".encode()
    ).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@dataclass
class StageRunner:
    """One loaded pipeline stage: forward, a recomputing backward, and the
    local optimizer state. ``params`` is a flat state dict on ``device``
    (the module itself holds no weights: it runs through
    ``functional_call``). Gradient accumulation is guarded by a lock;
    BACKWARD handlers run in worker threads."""

    job_id: str
    stage_index: int
    module: Module
    params: dict
    opt: Any
    opt_state: Any
    owner: str = ""  # node_id that shipped the spec; authorizes data-plane ops
    step: int = 0
    fence: int = 0  # abort epoch; data-plane msgs from older epochs rejected
    inputs: dict = field(default_factory=dict)  # (step, micro) -> (x, train)
    grad_accum: Any = None
    micro_seen: int = 0
    last_applied_step: int = -1  # master step already applied (idempotency)
    # data-parallel replica set
    replica: int = 0
    replica_peers: list = field(default_factory=list)  # [{node_id,host,port}]
    # this replica's full stage chain (placement dicts), for worker-to-
    # worker relay routing + sender authorization; refreshed on recovery
    chain: list = field(default_factory=list)
    _snapped_step: int = -1  # guards double-snapshot on STEP_END retry
    devices: Any = None  # more than one device: refused (no local TP)
    # None keeps dropout off; an int turns on the train-mode programs,
    # with the mask's generator seeded per (seed, stage, step, micro)
    train_seed: int | None = None
    # "lora": only adapter leaves update
    train_only: str | None = None
    device: Any = None

    def __post_init__(self):
        if self.devices is not None and len(self.devices) > 1:
            raise ValueError(
                "a stage over several local devices (local tensor "
                "parallelism) waits for a multi-card host; this port runs "
                "each stage on one device"
            )
        # CUDA unless the caller names a device
        self.device = resolve_device(self.device)
        self._lock = threading.Lock()
        self._mem_lock = threading.Lock()  # guards _memory only (short)
        # functional_call swaps the module's parameters for the call's:
        # two threads in one module at once would see each other's, so
        # every run of the stage takes this lock
        self._run_lock = threading.Lock()
        self._memory: dict[str, dict] = {}
        self._seen_shapes: set = set()
        from tensorlink_tpu_torch.parallel.inference import declared_compute_dtype

        self.compute_dtype = getattr(torch, declared_compute_dtype(self.params))

    def _trainable(self, name: str) -> bool:
        if self.train_only != "lora":
            return True
        from tensorlink_tpu_torch.nn.lora import is_lora_name

        return is_lora_name(name)

    def _mask_if_lora(self, tree: dict) -> dict:
        if self.train_only != "lora":
            return tree
        return {k: (v if self._trainable(k) else torch.zeros_like(v))
                for k, v in tree.items()}

    def _generator(self, step: int, micro: int) -> torch.Generator:
        """Deterministic dropout stream for one (stage, step, micro):
        re-derived by backward's recompute and by any auditor holding the
        job's train seed."""
        g = torch.Generator(device=self.device)
        g.manual_seed(_micro_seed(self.train_seed, self.stage_index, step, micro))
        return g

    def _run(self, params: dict, x: torch.Tensor, gen: torch.Generator | None):
        if gen is None:
            return functional_call(self.module, params, (x,))
        return functional_call(self.module, params, (x,),
                               {"rng": gen, "train": True})

    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(device=self.device, dtype=self.compute_dtype)

    def _measure(self, tag: str, x: torch.Tensor, fn):
        """Run ``fn``; the first run of each (tag, shape) records the
        program's footprint: arguments (params + input), output and, on
        CUDA, the allocator's peak above the bytes live before it (the
        temporaries)."""
        key = (tag, tuple(x.shape))
        if key in self._seen_shapes:
            return fn()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        out = fn()
        first = out[0] if isinstance(out, tuple) else out
        out_b = first.numel() * first.element_size()
        temp = 0
        if cuda:
            torch.cuda.synchronize(self.device)
            temp = max(torch.cuda.max_memory_allocated(self.device) - base - out_b, 0)
        rec = {
            "temp_bytes": int(temp),
            "argument_bytes": int(tree_bytes(self.params)
                                  + x.numel() * x.element_size()),
            "output_bytes": int(out_b),
            "code_bytes": 0,
        }
        with self._mem_lock:
            self._seen_shapes.add(key)
            old = self._memory.get(tag)
            # keep the largest footprint per program across shapes
            if old is None or _prog_total(rec) > _prog_total(old):
                self._memory[tag] = rec
        return out

    def memory_stats(self) -> dict:
        """Measured footprint of the stage programs (filled in after the
        first run per shape; param bytes always known)."""
        with self._mem_lock:
            programs = {k: dict(v) for k, v in self._memory.items()}
        peak = max((_prog_total(m) for m in programs.values()), default=0)
        return {
            "param_bytes": tree_bytes(self.params),
            "programs": programs,
            "peak_program_bytes": peak,
        }

    def forward(
        self, step: int, micro: int, x, fence: int = 0,
        train: bool = False, stash: bool = True,
    ) -> torch.Tensor:
        xd = self._to_device(x)
        # train mode needs a seed for reproducible masks; a job that
        # shipped none stays on the eval programs
        use_train = bool(train) and self.train_seed is not None
        with self._lock:
            if fence < self.fence:
                raise StaleFenceError(f"fence {fence} < {self.fence}")
            # the mode rides the stash so backward recomputes the same
            # program (and mask); stash=False is the inference contract
            if stash:
                self.inputs[(step, micro)] = (xd, use_train)
        gen = self._generator(step, micro) if use_train else None
        tag = "fwd_train" if use_train else "fwd"
        with torch.no_grad(), self._run_lock:
            out = self._measure(tag, xd, lambda: self._run(self.params, xd, gen))
        return out.cpu()

    def backward(self, step: int, micro: int, g, fence: int = 0) -> torch.Tensor:
        with self._lock:
            if fence < self.fence:
                raise StaleFenceError(f"fence {fence} < {self.fence}")
            xd, was_train = self.inputs.pop((step, micro))
        gd = self._to_device(g)
        names = [k for k in self.params if self._trainable(k)]

        def run():
            # recompute the stage from its input under autograd, then the
            # vjp of the incoming cotangent
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(k in names)
                          for k, v in self.params.items()}
                xx = xd.detach().requires_grad_(True)
                gen = self._generator(step, micro) if was_train else None
                out = self._run(leaves, xx, gen)
                grads = torch.autograd.grad(
                    out, [xx] + [leaves[k] for k in names], gd.to(out.dtype),
                    allow_unused=True,
                )
            gx = grads[0]
            gp = {k: (gk if gk is not None else torch.zeros_like(self.params[k]))
                  for k, gk in zip(names, grads[1:])}
            for k in self.params:
                if k not in gp:
                    gp[k] = torch.zeros_like(self.params[k])
            return gx, gp

        with self._run_lock:
            gx, gp = self._measure("bwd_train" if was_train else "bwd", xd, run)
        with self._lock:
            # re-check under the lock: ABORT_STEP may have advanced the
            # fence and cleared grad_accum while the vjp ran in this
            # thread; accumulating now would double-count this micro in
            # the retried step
            if fence < self.fence:
                raise StaleFenceError(f"fence {fence} < {self.fence}")
            self.grad_accum = _add(self.grad_accum, gp)
            self.micro_seen += 1
        return gx.cpu()

    def pol(self, params: dict, x: torch.Tensor):
        """The proof-of-learning run (``roles.pol.pol_run``): the same
        program as the validator's ``replay_stage``."""
        from tensorlink_tpu_torch.roles.pol import pol_run

        with self._run_lock:
            return pol_run(self.module, params, x.to(self.device))

    def reset_step(self) -> None:
        """Discard partial micro-batch state (grad accum + stashed
        activations) so an aborted pipeline step can be retried after an
        elastic stage re-assignment."""
        with self._lock:
            self.grad_accum = None
            self.micro_seen = 0
            self.inputs.clear()
            self._snapped_step = -1  # the retried step may snapshot again

    def _update(self, grads: dict) -> None:
        with torch.no_grad():
            grads = self._mask_if_lora(grads)
            updates, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params, self.step
            )
            self.params = apply_updates(self.params, self._mask_if_lora(updates))
        self.step += 1

    def apply_step(self, master_step: int | None = None, fence: int = 0) -> bool:
        """Apply the accumulated gradient. Idempotent per logical
        ``master_step`` (a retried STEP_END must not apply twice) and
        fenced like FORWARD/BACKWARD (a straggling STEP_END from an
        aborted attempt applies nothing). Returns True if applied."""
        with self._lock:
            if fence < self.fence:
                return False  # stale attempt; leave accum for the retry
            if master_step is not None and master_step <= self.last_applied_step:
                # already applied for this logical step: discard the
                # retry's re-accumulated grads or they leak into the next
                self.grad_accum = None
                self.micro_seen = 0
                return False
            if self.grad_accum is None:
                return False
            grads, n = self.grad_accum, max(self.micro_seen, 1)
            self.grad_accum = None
            self.micro_seen = 0
            if master_step is not None:
                self.last_applied_step = master_step
        self._update({k: v / n for k, v in grads.items()})
        return True

    def take_accum(self, master_step: int | None, fence: int):
        """Snapshot-and-clear the gradient accumulator for DP sync.
        Returns (grads_or_None, micro_count), or None if this logical step
        was already snapshotted/applied or the fence is stale."""
        with self._lock:
            if fence < self.fence:
                return None
            if master_step is not None and (
                master_step <= self.last_applied_step
                or master_step <= self._snapped_step
            ):
                return None
            if master_step is not None:
                self._snapped_step = master_step
            g, n = self.grad_accum, self.micro_seen
            self.grad_accum = None
            self.micro_seen = 0
        # mask before the replica exchange: base-weight grads would be
        # zeroed by apply_synced anyway
        if g is not None:
            g = self._mask_if_lora(g)
        return g, n

    def restore_accum(self, g, n: int, master_step: int | None, fence: int) -> None:
        """Put a take_accum snapshot back after a FAILED replica sync, so
        a retried STEP_END re-syncs the same gradient. No-op if the step
        was aborted (fence moved) or applied in the meantime."""
        with self._lock:
            if fence < self.fence:
                return
            if master_step is not None and master_step <= self.last_applied_step:
                return
            if g is not None:
                self.grad_accum = _add(self.grad_accum, g)
            self.micro_seen += n
            if master_step is not None:
                # un-latch the snapshot guard for the retried STEP_END
                self._snapped_step = min(self._snapped_step, master_step - 1)

    def apply_synced(self, master_step: int | None, contributions) -> bool:
        """Apply the replica-averaged gradient. ``contributions`` is the
        deterministically ordered [(grads_or_None, n), ...] across all
        replicas (own included), the same order on every replica, so the
        sum (and so the params) stays bitwise identical across the set."""
        total_n = sum(n for _, n in contributions)
        if total_n == 0:
            return False
        acc = None
        for g, _n in contributions:
            if g is None:
                continue
            acc = _add(acc, {k: v.to(self.device) for k, v in g.items()})
        with self._lock:
            if master_step is not None and master_step <= self.last_applied_step:
                return False
            if master_step is not None:
                self.last_applied_step = master_step
        if acc is None:
            self.step += 1
            return True
        self._update({k: v / total_n for k, v in acc.items()})
        return True


class WorkerNode(Node):
    """Handles: STATS_REQUEST, JOB_OFFER, MODULE_SPEC, FORWARD, BACKWARD,
    STEP_END, PARAMS_REQUEST, POL_CHALLENGE (see pol.py)."""

    RESERVATION_TTL_S = 120.0
    # peer-fed growth bounds (tlproto TLP202): a hostile peer may not
    # park unbounded reservations or ship megatoken prompts
    MAX_RESERVATIONS = 64
    MAX_SERVE_IDS = 65536

    def __init__(self, cfg: NodeConfig | None = None, registry=None, *,
                 device=None, **kw):
        cfg = cfg or NodeConfig(role="worker")
        super().__init__(cfg, **kw)
        # the device this worker's stages and engines run on (CUDA unless
        # the caller asks for the CPU)
        self.device = resolve_device(device)
        # kernel-build cache before any stage runs: a restarted worker
        # loads its built kernels from disk
        from tensorlink_tpu_torch.runtime.compile_cache import enable_compile_cache

        enable_compile_cache(cfg.compile_cache_dir, recorder=self.flight)
        # ... and the autotune store beside it: the worker has no model
        # yet, so it loads the card-global record (persisted flash-block
        # overrides install before any stage runs)
        self.autotune_warm_start_s: float | None = None
        self._load_autotune(cfg)
        # capability microbench (runtime/profiling.py): runs in the
        # background at start(), cached in the autotune store under the
        # same chip-global key so restarts skip it; the record rides
        # every heartbeat PONG into validators' fleet tables
        self.capability_ready = asyncio.Event()
        self.registry = registry  # optional: verifies validator identity
        self.stages: dict[tuple[str, int], StageRunner] = {}
        # DP replica grad exchange: (job, stage, step, sender) -> (g, n)
        self._grad_inbox: dict[tuple, tuple[Any, int]] = {}
        # arrival signal per (job, stage, step): STEP_END awaits this
        # instead of busy-polling the inbox at 20 ms
        self._grad_events: dict[tuple, asyncio.Event] = {}
        # (job_id, stage) -> (bytes, expires_at, author); converted to a
        # live stage by MODULE_SPEC (author-only), or expired — never
        # leaked.
        self._reservations: dict[tuple[str, int], tuple[int, float, str]] = {}
        # signed work receipts by engine rid (runtime/ledger.py):
        # built once per finished request — the SAME signed object
        # rides the SERVE_TOKENS reply and the heartbeat PONG, so a
        # validator seeing both dedups by content, not by luck
        self._receipts: "collections.OrderedDict[int, dict]" = (
            collections.OrderedDict()
        )
        self.training = False
        # disaggregated serving: a worker may host a
        # continuous-batching scheduler and advertise a serving leg —
        # "prefill" (compute-bound chunked prefill, blocks exported),
        # "decode" (bandwidth-bound continuation of imported blocks),
        # or "colocated" (both legs). Advertised on every heartbeat
        # PONG via capability_record; the validator places legs from
        # the resulting fleet roofline table.
        self.serving = None
        self.serving_mode: str | None = None
        # pipeline-sharded serving: this worker may host
        # ONE stage of a layer-partitioned pipeline. Stage 0 additionally
        # runs the PipelineCoordinator (attached as self.serving, so the
        # SERVE_SUBMIT/SERVE_RESULT surface is unchanged); stages >= 1
        # compute ACT_FWD hops only. Advertised via pipe_* fields in the
        # heartbeat capability record.
        self._pipe_stage = None
        self._pipe_coord = None

    # ------------------------------------------------------------ autotune
    def _autotune_key(self):
        from tensorlink_tpu_torch.runtime.autotune import GLOBAL_MODEL, store_key

        return store_key(GLOBAL_MODEL, ())

    def _load_autotune(self, cfg: NodeConfig) -> None:
        from tensorlink_tpu_torch.runtime.autotune import (
            AutotuneStore,
            apply_flash_overrides,
        )

        store = AutotuneStore.resolve(
            cfg.autotune_dir, recorder=self.flight
        )
        if store is None:
            return
        t0 = time.perf_counter()
        rec = store.load(self._autotune_key())
        if rec is None:
            return
        applied = apply_flash_overrides(rec)
        self.autotune_warm_start_s = round(time.perf_counter() - t0, 4)
        self.flight.record(
            "autotune.warm_start", flash_overrides=applied,
            warm_start_s=self.autotune_warm_start_s,
        )

    def save_autotune(self) -> str | None:
        """Persist this worker's installed flash-block overrides under
        the chip-global key (a tuning sweep's result must outlive the
        process that ran it). A MERGE, not a blind save: the capability
        microbench shares this key, and overwriting would force the
        next restart to re-measure the chip. Returns the written path
        or None when no store is configured."""
        from tensorlink_tpu_torch.ops.flash import flash_block_overrides
        from tensorlink_tpu_torch.runtime.autotune import AutotuneStore

        store = AutotuneStore.resolve(
            self.cfg.autotune_dir, recorder=self.flight
        )
        if store is None:
            return None
        return str(store.update(
            self._autotune_key(),
            {"flash_blocks": [list(t) for t in flash_block_overrides()]},
        ))

    # ---------------------------------------------------------- capability
    def _capability_enabled(self) -> bool:
        import os

        if self.cfg.capability_bench is not None:
            return bool(self.cfg.capability_bench)
        return os.environ.get("TL_CAPABILITY_BENCH", "1") != "0"

    async def start(self) -> None:
        await super().start()
        if self._capability_enabled():
            # off the start path: peers can handshake while the bench
            # (two tiny jits + timed loops, autotune-cached) runs
            self._spawn(self._measure_capability_task())

    async def _measure_capability_task(self) -> None:
        from tensorlink_tpu_torch.runtime.autotune import AutotuneStore
        from tensorlink_tpu_torch.runtime.profiling import measure_capability

        store = AutotuneStore.resolve(
            self.cfg.autotune_dir, recorder=self.flight
        )
        try:
            cap = await asyncio.to_thread(
                measure_capability,
                device=self.device,
                store=store,
                key=self._autotune_key() if store is not None else None,
                recorder=self.flight,
            )
        except Exception as e:  # noqa: BLE001 — telemetry must not kill start
            self.flight.record(
                "capability.failed", "warn", error=repr(e)
            )
            self.capability_ready.set()
            return
        self.capability = cap
        self.metrics.observe("capability_peak_tflops", cap["peak_tflops"])
        self.metrics.observe("capability_hbm_gbps", cap["hbm_gbps"])
        self.capability_ready.set()

    def capability_record(self) -> dict | None:
        """Base record (chip peaks + any attached serving scheduler's
        per-program attribution) extended with per-STAGE program times
        (the measured ``stage{i}_fwd_s`` / ``_bwd_s`` means; the port's
        stage programs carry no flop count, so no per-stage MFU) and the
        pipeline stage's fields."""
        rec = super().capability_record()
        if self._pipe_stage is not None:
            # a pipeline stage advertises itself even when the node has
            # no measured roofline and no SERVE_SUBMIT surface (stages
            # >= 1 serve only ACT_FWD hops): the validator's replacement
            # planner and tldiag's ROLE column both read these fields
            if rec is None:
                rec = dict(self.capability or {})
            st = self._pipe_stage.stats()
            rec["pipe_sid"] = self._pipe_stage.sid
            rec["pipe_stage"] = self._pipe_stage.stage
            rec["pipe_n_stages"] = self._pipe_stage.n_stages
            rec["pipe_lo"], rec["pipe_hi"] = st["layers"]
            rec["pipe_bubble_frac"] = st["bubble_frac"]
            pool = self._pipe_stage.pool
            rec.setdefault("kv_blocks_free", pool.available)
            rec.setdefault("kv_blocks_total", pool.num_blocks)
            rec.setdefault("kv_block_size", pool.block_size)
        if rec is None:
            return None
        progs = dict(rec.get("programs") or {})
        for (jid, idx), runner in self.stages.items():
            for tag in ("fwd", "bwd"):
                q = self.metrics.series.get(f"stage{idx}_{tag}_s")
                if not q:
                    continue
                vals = list(q)
                progs[f"stage{idx}_{tag}"] = {
                    "mean_s": round(sum(vals) / len(vals), 6), "n": len(vals),
                }
        if progs:
            rec["programs"] = progs
        return rec

    def on_peer_lost(self, peer: Peer) -> None:
        """A lost job OWNER strands this worker's loaded stages: until
        the master reattaches (same identity) or the reservation-style
        teardown frees them, capacity is pinned — worth a black-box
        event when diagnosing 'why did the worker refuse offers'."""
        orphaned = [
            {"job_id": jid[:16], "stage": idx}
            for (jid, idx), r in self.stages.items()
            if r.owner == peer.node_id
        ]
        if orphaned:
            self.flight.record(
                "stage_owner_lost", "warn", owner=peer.node_id[:16],
                stages=orphaned,
            )

    @property
    def reserved_bytes(self) -> int:
        now = time.time()
        self._reservations = {
            k: v for k, v in self._reservations.items() if v[1] > now
        }
        return sum(b for b, _, _ in self._reservations.values())

    @reserved_bytes.setter
    def reserved_bytes(self, value: int) -> None:
        # test/diagnostic hook: a blanket reservation that never expires
        self._reservations[("__manual__", -1)] = (value, float("inf"), "")

    # ---------------------------------------------------------- handlers
    def register_handlers(self) -> None:
        super().register_handlers()
        self.on("STATS_REQUEST", self._h_stats)
        self.on("JOB_OFFER", self._h_job_offer)
        self.on("MODULE_SPEC", self._h_module_spec)
        self.on("FORWARD", self._h_forward)
        self.on("BACKWARD", self._h_backward)
        self.on("RELAY_FORWARD", self._h_relay_forward)
        self.on("RELAY_BACKWARD", self._h_relay_backward)
        self.on("STEP_END", self._h_step_end)
        self.on("GRAD_SHARE", self._h_grad_share)
        self.on("ABORT_STEP", self._h_abort_step)
        self.on("PARAMS_REQUEST", self._h_params_request)
        self.on("POL_CHALLENGE", self._h_pol_challenge)
        self.on("UNLOAD", self._h_unload)
        self.on("SERVE_SUBMIT", self._h_serve_submit)
        self.on("SERVE_RESULT", self._h_serve_result)
        self.on("SERVE_PREFILL", self._h_serve_prefill)
        self.on("PIPE_LOAD", self._h_pipe_load)
        self.register_stream_kind("module_spec", self._stream_module_spec)

    # ------------------------------------------------ serving (disagg)
    def serving_engine(
        self, engine, *, paged: bool = False, mode: str = "colocated",
        **kw,
    ):
        """Attach a continuous-batching scheduler to this WORKER and
        advertise it as a serving leg. ``mode`` is what the heartbeat
        capability record tells validators this worker WANTS to serve:

        - ``"colocated"``: full requests (``SERVE_SUBMIT``/
          ``SERVE_RESULT``) — also the fallback target when a
          disaggregated leg dies;
        - ``"prefill"``: the compute-bound leg — ``SERVE_PREFILL`` runs
          chunked prefill locally and ships the filled KV blocks to the
          decode worker named in the request;
        - ``"decode"``: the bandwidth-bound leg — received ``KV_BLOCKS``
          graft into the local pool and decode in the continuous-
          batching engine as if prefilled here.

        Disaggregated modes require ``paged=True``: the paged KV block
        is the wire unit. Observability wiring is the shared
        ``Node._build_serving`` (metrics/flight/tracer/compile cache/
        autotune/capability), same as the user role's."""
        if mode not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"serving mode must be colocated/prefill/decode, "
                f"got {mode!r}"
            )
        if mode != "colocated" and not paged:
            raise ValueError(
                "disaggregated serving modes require paged=True — the "
                "paged KV block is the wire unit"
            )
        self._build_serving(engine, paged=paged, **kw)
        self.serving_mode = mode
        # what this engine's finished requests bill as on their work
        # receipts (runtime/ledger.py)
        self.serving.meter_kind = {
            "colocated": "serve", "prefill": "prefill_leg",
            "decode": "decode_leg",
        }[mode]
        self.flight.record("serving.attached", mode=mode, paged=paged)
        return self.serving

    # ------------------------------------------------- work receipts
    def work_receipt(self, rid: int) -> dict | None:
        """The signed WorkReceipt for a finished request — None until
        it finishes, when metering is off, or after bounded eviction.
        Built once and cached: the reply path and the heartbeat drain
        hand out the SAME signed object, so a validator seeing both
        dedups by canonical content."""
        r = self._receipts.get(rid)
        if r is not None:
            return r
        serving = self.serving
        if serving is None or not getattr(serving, "metering", False):
            return None
        meter = serving.meter(rid)
        if meter is None:
            return None
        return self._receipt_for_meter(meter)

    def _receipt_for_meter(self, meter: dict) -> dict:
        from tensorlink_tpu_torch.runtime.ledger import build_receipt

        rid = int(meter["rid"])
        r = self._receipts.get(rid)
        if r is None:
            r = build_receipt(meter, self.identity)
            self._receipts[rid] = r
            while len(self._receipts) > 4096:
                self._receipts.popitem(last=False)
            self.metrics.incr("receipts_issued_total")
        return r

    def pending_receipts(self, limit: int = 64) -> list[dict]:
        """Receipts for finished requests not yet shipped to a
        validator — the PONG piggyback source (p2p/node.py _h_ping).
        Drains the engine's fresh-meter queue exactly once."""
        serving = self.serving
        if serving is None or not hasattr(serving, "drain_meters"):
            return []
        return [
            self._receipt_for_meter(m)
            for m in serving.drain_meters(limit)
        ]

    def _serving_or_error(self, need_paged: bool = False):
        serving = self.serving
        if serving is None or (
            need_paged and not hasattr(serving, "import_prefill")
        ):
            from tensorlink_tpu_torch.parallel.serving import (
                ServingError,
                serve_error_to_wire,
            )

            return None, serve_error_to_wire(ServingError(
                "no paged serving engine attached to this worker"
                if need_paged else
                "no serving engine attached to this worker"
            ))
        return serving, None

    @staticmethod
    def _serve_kwargs(msg: dict, peer=None) -> dict:
        out = {
            "seed": int(msg.get("seed", 0)),
            "priority": str(msg.get("priority", "standard"))[:32],
        }
        if msg.get("max_new") is not None:
            out["max_new"] = int(msg["max_new"])
        if msg.get("deadline_s") is not None:
            out["deadline_s"] = float(msg["deadline_s"])
        # billing identity for the work receipt: the submitter's
        # declared tenant, defaulting to the submitting peer's node id
        # — an absent field never bills to another tenant's name
        if msg.get("tenant") is not None:
            out["tenant"] = str(msg["tenant"])[:128]
        elif peer is not None:
            out["tenant"] = str(peer.node_id)[:128]
        return out

    def _serve_ids(self, msg: dict) -> np.ndarray:
        """Validate a peer-supplied token-id list (tlproto registered
        sanitizer). Raises TypeError/ValueError on malformed input, which
        ``wire_guard`` turns into a typed malformed-frame reject."""
        raw = msg["ids"]
        if not isinstance(raw, (list, tuple)):
            raise TypeError(f"ids must be a list, got {type(raw).__name__}")
        if len(raw) > self.MAX_SERVE_IDS:
            raise ValueError(
                f"ids length {len(raw)} exceeds {self.MAX_SERVE_IDS}"
            )
        return np.asarray([int(t) for t in raw], np.int32).reshape(-1)

    @wire_guard
    async def _h_serve_submit(self, node, peer, msg) -> dict:
        """Colocated admission: the full-request path (and the dead-leg
        fallback target). Typed scheduler rejections — overload with
        measured retry-after, unmeetable deadlines — cross the wire as
        SERVE_FAILED and re-raise as the same type on the caller."""
        from tensorlink_tpu_torch.parallel.serving import serve_error_to_wire

        serving, err = self._serving_or_error()
        if err is not None:
            return err
        ids = self._serve_ids(msg)
        try:
            rid = await serving.asubmit(ids, **self._serve_kwargs(msg, peer))
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return serve_error_to_wire(e)
        return {"type": "SERVE_ACCEPTED", "rid": rid}

    @wire_guard
    async def _h_serve_result(self, node, peer, msg) -> dict:
        from tensorlink_tpu_torch.parallel.serving import serve_error_to_wire

        serving, err = self._serving_or_error()
        if err is not None:
            return err
        kw = {}
        if msg.get("timeout_s") is not None:
            kw["timeout_s"] = float(msg["timeout_s"])
        if msg.get("deadline_s") is not None:
            kw["deadline_s"] = float(msg["deadline_s"])
        try:
            tokens = await serving.aresult(int(msg["rid"]), **kw)
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return serve_error_to_wire(e)
        out = {
            "type": "SERVE_TOKENS",
            "rid": int(msg["rid"]),
            "tokens": [int(t) for t in np.asarray(tokens).reshape(-1)],
        }
        # the signed work receipt rides the reply the user already
        # waits for: the client can verify the claim against the
        # tokens in the SAME frame (runtime/ledger.py)
        receipt = self.work_receipt(int(msg["rid"]))
        if receipt is not None:
            out["receipt"] = receipt
        return out

    @wire_guard
    async def _h_serve_prefill(self, node, peer, msg) -> dict:
        """The PREFILL leg: chunked-prefill the prompt into the local
        pool, ship the filled blocks to the decode worker named in
        ``msg["decode"]``, and answer with the decode-side rid the
        caller fetches the stream from.

        Failure semantics: when the decode leg is unreachable or
        refuses the import, this worker FALLS BACK to colocated serving
        — the prompt prefix it just prefilled is registered in its own
        index, so the re-submit prefix-hits and pays only the tail —
        and the reply says so (``fallback: "colocated"`` + local rid).
        A ``serving.disagg_fallback`` flight event records the
        downgrade either way."""
        from tensorlink_tpu_torch.parallel.kvwire import pack_kv_payload
        from tensorlink_tpu_torch.parallel.serving import serve_error_to_wire

        serving, err = self._serving_or_error(need_paged=True)
        if err is not None:
            return err
        ids = self._serve_ids(msg)
        kw = self._serve_kwargs(msg, peer)
        t0 = time.perf_counter()
        try:
            with self.tracer.span(
                "serving.prefill_leg", {"prompt_len": int(ids.size)}
            ):
                payload = await asyncio.to_thread(
                    serving.prefill_export, ids, **kw
                )
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return serve_error_to_wire(e)
        prefill_s = time.perf_counter() - t0
        blob = await asyncio.to_thread(pack_kv_payload, payload)
        dec = msg.get("decode") or {}
        # the deadline is END-TO-END: the decode leg (and any local
        # fallback) gets only what prefill + packing have not already
        # spent — a re-anchored full budget would let a disagg request
        # run to ~2x the SLO the caller asked for
        if kw.get("deadline_s") is not None:
            from tensorlink_tpu_torch.parallel.serving import (
                DeadlineExceededError,
            )

            rem = kw["deadline_s"] - (time.perf_counter() - t0)
            if rem <= 0:
                return serve_error_to_wire(DeadlineExceededError(
                    f"deadline {kw['deadline_s']}s fully consumed by "
                    "the prefill leg"
                ))
            kw["deadline_s"] = rem
        meta = {
            "priority": kw.get("priority", "standard"),
            "deadline_s": kw.get("deadline_s"),
            "origin": peer.node_id,
            # the decode leg bills the SAME tenant as the prefill leg
            "tenant": kw.get("tenant"),
        }
        reason = None
        t1 = time.perf_counter()
        if kw.get("deadline_s") is not None:
            # the decode leg re-anchors its budget at import ARRIVAL, so
            # wire time would silently extend the end-to-end SLO: charge
            # the measured transfer EWMA upfront (per-transfer wall time
            # is unknowable across node clocks). An estimate that alone
            # exhausts the budget skips the hop — colocated serving on
            # the just-warmed prefix beats a transfer we cannot afford.
            est = serving.disagg_wire_ewma_s()
            if kw["deadline_s"] - est <= 0:
                reason = (
                    f"transfer EWMA {est:.3f}s exceeds remaining "
                    f"deadline {kw['deadline_s']:.3f}s"
                )
            else:
                meta["deadline_s"] = kw["deadline_s"] - est
        if reason is None:
            try:
                with self.tracer.span(
                    "serving.kv_transfer",
                    {"bytes": len(blob),
                     "to": str(dec.get("node_id", ""))[:8]},
                ):
                    dpeer = self.peers.get(dec.get("node_id"))
                    if dpeer is None:
                        dpeer = await self.connect_candidates(
                            dec["host"], int(dec["port"]),
                            tuple(dec.get("alt_hosts", ()) or ()),
                            expect_id=dec.get("node_id"),
                        )
                    resp = await self.send_kv_blocks(dpeer, blob, meta)
                if resp.get("type") == "KV_IMPORTED":
                    wire_s = time.perf_counter() - t1
                    serving.note_disagg_transfer(
                        prefill_s=prefill_s, wire_s=wire_s,
                        wire_bytes=len(blob),
                    )
                    return {
                        "type": "SERVE_PREFILLED",
                        "decode_rid": int(resp["rid"]),
                        "decode_node": dec.get("node_id"),
                        "wire_bytes": len(blob),
                        "prefill_s": round(prefill_s, 6),
                        "wire_s": round(wire_s, 6),
                    }
                reason = (
                    f"{resp.get('error_type', resp.get('type'))}: "
                    f"{resp.get('error', 'import refused')}"
                )
            except (ConnectionError, OSError, KeyError,
                    asyncio.TimeoutError) as e:
                reason = f"{type(e).__name__}: {e}"
        # decode leg dead or refusing: serve the whole request HERE.
        # The export left the prompt prefix registered locally, so this
        # re-submit re-prefills only the tail (prefix hit), and the
        # (seed, position) sampling keys keep it token-identical.
        self.flight.record(
            "serving.disagg_fallback", "warn",
            decode=str(dec.get("node_id", ""))[:16], reason=reason[:200],
        )
        self.metrics.incr("serving_disagg_fallback_total")
        serving.note_disagg_transfer(prefill_s=prefill_s, fallback=True)
        if kw.get("deadline_s") is not None:
            from tensorlink_tpu_torch.parallel.serving import (
                DeadlineExceededError,
            )

            # the remainder computed above predates the transfer
            # attempt: a decode peer that accepts TCP but hangs burns
            # up to KV_TRANSFER_TIMEOUT_S here, and the end-to-end
            # deadline must charge that wait to this request too
            rem = kw["deadline_s"] - (time.perf_counter() - t1)
            if rem <= 0:
                return serve_error_to_wire(DeadlineExceededError(
                    f"deadline fully consumed by the failed KV "
                    f"transfer to {str(dec.get('node_id', ''))[:8]}"
                ))
            kw["deadline_s"] = rem
        try:
            rid = await serving.asubmit(ids, **kw)
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return serve_error_to_wire(e)
        return {
            "type": "SERVE_PREFILLED",
            "fallback": "colocated",
            "rid": rid,
            "reason": reason[:200],
            "wire_bytes": 0,
            "prefill_s": round(prefill_s, 6),
        }

    async def handle_kv_blocks(self, peer: Peer, msg: dict) -> dict:
        """The DECODE leg's import side: unpack the CRC-framed blob
        (corruption raises before anything touches the pool), graft the
        blocks into the local engine, and hand back the rid the user
        front end will fetch. Overload is a typed SERVE_FAILED with a
        measured retry-after — never a silent drop."""
        from tensorlink_tpu_torch.parallel.kvwire import unpack_kv_payload
        from tensorlink_tpu_torch.parallel.serving import serve_error_to_wire

        serving, err = self._serving_or_error(need_paged=True)
        if err is not None:
            return err
        meta = msg.get("meta") or {}
        kw = {"priority": meta.get("priority", "standard")}
        if meta.get("deadline_s") is not None:
            kw["deadline_s"] = float(meta["deadline_s"])
        tenant = meta.get("tenant") or meta.get("origin") or peer.node_id
        if tenant:
            kw["tenant"] = str(tenant)[:128]
        try:
            with self.tracer.span(
                "serving.kv_import", {"bytes": len(msg["blob"])}
            ):
                payload = await asyncio.to_thread(
                    unpack_kv_payload, bytes(msg["blob"])
                )
                rid = await asyncio.to_thread(
                    lambda: serving.import_prefill(
                        payload, wire_bytes=len(msg["blob"]), **kw
                    )
                )
        except ValueError as e:
            # malformed or incompatible wire payload: CRC mismatch, or a
            # KV_WIRE_SCHEMA this importer does not speak. Typed reject
            # plus a flight event so rolling upgrades are observable.
            self.metrics.incr("kv_wire_rejected_total")
            self.flight.record(
                "kv_wire_rejected", "warn",
                peer=peer.node_id[:16], error=str(e)[:200],
            )
            return serve_error_to_wire(e)
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return serve_error_to_wire(e)
        return {"type": "KV_IMPORTED", "rid": rid}

    # ---------------------------------------------- serving (pipeline)
    # hostile-ingest clamps for peer-fed activation metadata (tlproto
    # TLP201): slot counts, chunk bounds, and relay route length are
    # bounded before any of them select compute or a dial target
    MAX_ACT_SLOTS = 4096
    MAX_ACT_ROUTE = 16

    def pipeline_stage(
        self, engine, *, sid: str, stage: int, n_stages: int,
        lo: int, hi: int, route: list[dict] | None = None,
        validator=None, **kw,
    ):
        """Attach ONE stage of a pipeline-sharded serving deployment
        (parallel/pipeserve.py) to this worker.

        ``engine`` is a full :class:`InferenceEngine`; the stage keeps
        only the ``[lo, hi)`` layer slice of its params (plus embedding
        on stage 0 / head on the last) — the whole point is that the
        full model never has to fit this worker. Stage 0 additionally
        hosts the :class:`PipelineCoordinator` (attached as
        ``self.serving``, so SERVE_SUBMIT/SERVE_RESULT and the
        client surface work unchanged) and needs the downstream
        ``route`` (winfo dicts for stages 1..N-1) plus optionally the
        ``validator`` peer for dead-stage re-recruitment. Stages >= 1
        serve ACT_FWD hops only. A worker may also pre-load a stage as
        a SPARE replica (same sid/stage, not in any route): its
        capability record advertises ``pipe_sid``/``pipe_stage`` and the
        validator's replacement planner recruits it on stage death."""
        from tensorlink_tpu_torch.parallel.pipeserve import (
            PipelineCoordinator,
            PipelineStageEngine,
        )

        kw.setdefault("metrics", self.metrics)
        kw.setdefault("recorder", self.flight)
        stage_eng = PipelineStageEngine(
            engine, lo=lo, hi=hi, sid=sid, stage=stage,
            n_stages=n_stages, **kw,
        )
        self._pipe_stage = stage_eng
        if int(stage) == 0:
            if int(n_stages) > 1 and not route:
                raise ValueError(
                    "stage 0 needs the downstream route (winfo dicts "
                    "for stages 1..N-1)"
                )
            coord = PipelineCoordinator(
                self, stage_eng, route=route or [], sid=sid,
                validator=validator, gen=stage_eng.gen,
            )
            self._pipe_coord = coord
            self.serving = coord
            self.serving_mode = "pipeline"
            self.flight.record(
                "serving.attached", mode=f"pipeline/stage0/{n_stages}",
                paged=True,
            )
            return coord
        self.flight.record(
            "serving.attached", mode=f"pipeline/stage{stage}/{n_stages}",
            paged=True,
        )
        return stage_eng

    def _act_meta(self, msg: dict) -> dict:
        """Validate peer-fed activation metadata (tlproto registered
        sanitizer). Raises TypeError/ValueError on malformed input;
        every field that selects compute (slot, chunk bounds, row-state
        vectors) or a dial target (relay route) is type- and
        range-clamped before use."""
        raw = msg.get("meta")
        if not isinstance(raw, dict):
            raise TypeError("ACT_FWD carries no meta dict")
        kind = str(raw.get("kind", ""))[:16]
        if kind not in ("prefill", "decode"):
            raise ValueError(f"unknown activation kind {kind!r}")
        out: dict = {"sid": str(raw.get("sid", ""))[:64], "kind": kind}
        route = raw.get("route")
        if route is None:
            route = []
        if not isinstance(route, (list, tuple)) or \
                len(route) > self.MAX_ACT_ROUTE:
            raise ValueError("activation route malformed or too long")
        out["route"] = [
            {
                "node_id": str(w["node_id"])[:64],
                "host": str(w["host"])[:255],
                "port": int(w["port"]),
                "alt_hosts": [
                    str(h)[:255] for h in (w.get("alt_hosts") or [])
                ][:8],
            }
            for w in route
        ]
        out["deadline_s"] = (
            float(raw["deadline_s"])
            if raw.get("deadline_s") is not None else None
        )
        if kind == "prefill":
            out["slot"] = int(raw["slot"])
            out["start"] = int(raw["start"])
            out["nreal"] = int(raw["nreal"])
            out["seed"] = int(raw["seed"]) & 0xFFFFFFFF
            out["n_ctx"] = int(raw["n_ctx"])
            out["budget"] = int(raw["budget"])
            if not (0 <= out["slot"] <= self.MAX_ACT_SLOTS
                    and 0 <= out["start"] <= self.MAX_SERVE_IDS
                    and 1 <= out["nreal"] <= self.MAX_SERVE_IDS
                    and 1 <= out["n_ctx"] <= self.MAX_SERVE_IDS
                    and 0 <= out["budget"] <= self.MAX_SERVE_IDS):
                raise ValueError("prefill chunk bounds out of range")
        else:
            for name in ("n_valid", "live", "seeds"):
                v = raw[name]
                if not isinstance(v, (list, tuple)) or \
                        len(v) > self.MAX_ACT_SLOTS:
                    raise ValueError(
                        f"decode {name} malformed or too long"
                    )
            out["n_valid"] = [int(x) for x in raw["n_valid"]]
            out["live"] = [bool(x) for x in raw["live"]]
            out["seeds"] = [int(x) & 0xFFFFFFFF for x in raw["seeds"]]
            out["tick"] = int(raw.get("tick", 0))
        return out

    async def handle_act_fwd(self, peer: Peer, msg: dict) -> dict:
        """One pipeline hop: run this worker's stage over the received
        activation chunk, then either reply with the stage output
        relayed down the remaining route (the last stage's ACT_RESULT
        — sampled tokens / first token — travels back up as each hop's
        reply) or, on the last stage, answer directly. Typed serving
        errors cross every hop; a dead downstream peer is reported with
        ``dead_stage`` so the head can re-recruit exactly the stage
        that died. The end-to-end deadline is decremented by this
        stage's compute + packing before the next leg sees it."""
        from tensorlink_tpu_torch.parallel.pipeserve import (
            pack_act_payload,
            unpack_act_payload,
        )
        from tensorlink_tpu_torch.parallel.serving import (
            DeadlineExceededError,
            ServingError,
            serve_error_to_wire,
        )

        eng = self._pipe_stage
        if eng is None or eng.stage == 0:
            # the head ORIGINATES activation traffic; an ACT_FWD aimed
            # at it (or at a stage-less worker) is a routing error
            return serve_error_to_wire(ServingError(
                "no relay pipeline stage attached to this worker"
            ))
        try:
            meta = self._act_meta(msg)
        except (KeyError, TypeError, ValueError) as e:
            self.metrics.incr("act_wire_rejected_total")
            self.flight.record(
                "act_wire_rejected", "warn",
                peer=peer.node_id[:16], error=str(e)[:200],
            )
            return serve_error_to_wire(ServingError(
                f"malformed activation frame: {e}"
            ))
        if meta["sid"] != eng.sid:
            return serve_error_to_wire(ServingError(
                f"activation for pipeline {meta['sid']!r}; this stage "
                f"serves {eng.sid!r}"
            ))
        t0 = time.perf_counter()
        dl = meta["deadline_s"]
        if dl is not None and dl <= 0:
            return serve_error_to_wire(DeadlineExceededError(
                f"deadline exhausted before stage {eng.stage} compute"
            ))
        try:
            x = await asyncio.to_thread(
                unpack_act_payload, bytes(msg["blob"])
            )
        except ValueError as e:
            # CRC mismatch, schema skew, or a hostile oversized tensor
            self.metrics.incr("act_wire_rejected_total")
            self.flight.record(
                "act_wire_rejected", "warn",
                peer=peer.node_id[:16], error=str(e)[:200],
            )
            return serve_error_to_wire(e)
        try:
            with self.tracer.span(
                "serving.pipeline_stage",
                {"stage": eng.stage, "kind": meta["kind"]},
            ):
                if meta["kind"] == "prefill":
                    out = await asyncio.to_thread(
                        eng.prefill_chunk, meta["slot"], x,
                        meta["start"], meta["nreal"], meta["seed"],
                        meta["n_ctx"], meta["budget"],
                    )
                else:
                    out = await asyncio.to_thread(
                        eng.decode_step, x, meta["n_valid"],
                        meta["live"], meta["seeds"],
                    )
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return serve_error_to_wire(e)
        if eng.slice.last:
            if meta["kind"] == "decode":
                return {
                    "type": "ACT_RESULT", "sid": eng.sid,
                    "tick": meta.get("tick", 0),
                    "tokens": [
                        int(t) for t in np.asarray(out).reshape(-1)
                    ],
                }
            return {
                "type": "ACT_RESULT", "sid": eng.sid,
                "tok0": int(np.asarray(out).reshape(())),
            }
        route = meta["route"]
        if not route:
            return serve_error_to_wire(ServingError(
                f"stage {eng.stage} is not last but the relay route is "
                "empty"
            ))
        nxt = route[0]
        blob2 = await asyncio.to_thread(pack_act_payload, out)
        fwd = {k: v for k, v in meta.items() if k != "route"}
        fwd["route"] = route[1:]
        fwd["stage"] = eng.stage + 1
        if dl is not None:
            rem = dl - (time.perf_counter() - t0)
            if rem <= 0:
                return serve_error_to_wire(DeadlineExceededError(
                    f"deadline consumed by stage {eng.stage} compute"
                ))
            fwd["deadline_s"] = rem
        try:
            npeer = self.peers.get(nxt["node_id"])
            if npeer is None:
                npeer = await self.connect_candidates(
                    nxt["host"], int(nxt["port"]),
                    tuple(nxt.get("alt_hosts", ()) or ()),
                    expect_id=nxt["node_id"],
                )
            # coerce the relayed verdict: a hostile downstream stage
            # must not be able to push an untyped frame back up the
            # chain through this hop's reply
            return self._typed_reply(
                await self.send_activations(npeer, blob2, fwd),
                fallback="SERVE_FAILED",
            )
        except (ConnectionError, OSError, KeyError,
                asyncio.TimeoutError) as e:
            self.flight.record(
                "serving.pipeline_hop_dead", "warn",
                stage=eng.stage + 1, node=str(nxt.get("node_id"))[:16],
                error=str(e)[:120],
            )
            err = serve_error_to_wire(ServingError(
                f"pipeline stage {eng.stage + 1} unreachable from "
                f"stage {eng.stage}: {e}"
            ))
            # exact attribution rides the relayed error so the head
            # re-recruits the stage that died, not the one that told it
            err["dead_stage"] = eng.stage + 1
            err["dead_node"] = nxt.get("node_id")
            return err

    @wire_guard
    async def _h_pipe_load(self, node, peer, msg) -> dict:
        """Geometry handshake / reset for a pipeline stage: the head
        verifies sid + slot count + cache width + layer continuity
        before any activation crosses, and hard-resets the stage's
        slots during dead-stage failover (re-prefill rebuilds all KV
        from scratch on the repaired chain)."""
        from tensorlink_tpu_torch.parallel.serving import (
            ServingError,
            serve_error_to_wire,
        )

        eng = self._pipe_stage
        if eng is None:
            return serve_error_to_wire(ServingError(
                "no pipeline stage attached to this worker"
            ))
        sid = str(msg.get("sid", ""))[:64]
        if sid != eng.sid:
            return serve_error_to_wire(ServingError(
                f"this worker serves pipeline {eng.sid!r}, not {sid!r}"
            ))
        for field, want in (
            ("stage", eng.stage), ("slots", eng.slots),
            ("max_len", eng.L), ("n_stages", eng.n_stages),
        ):
            if msg.get(field) is not None and int(msg[field]) != want:
                return serve_error_to_wire(ServingError(
                    f"pipeline geometry mismatch: {field} "
                    f"{msg[field]} != {want}"
                ))
        if bool(msg.get("reset")):
            await asyncio.to_thread(eng.reset_all)
            self.flight.record(
                "serving.pipeline_reset", sid=sid, stage=eng.stage
            )
        return {
            "type": "PIPE_LOAD", "ok": True, "sid": eng.sid,
            "stage": eng.stage, "lo": eng.slice.lo, "hi": eng.slice.hi,
            "slots": eng.slots, "max_len": eng.L,
            "block_size": eng.block_size,
        }

    def _observe_stage(self, stage: int, kind: str, dt: float) -> None:
        """Per-stage local compute time: the stage{i}_fwd_s/_bwd_s series
        tracing.straggler_report reads (this worker's own /node view),
        plus a latency histogram for /metrics?format=prom."""
        self.metrics.observe(f"stage{stage}_{kind}_s", dt)
        self.metrics.observe_hist(f"stage_{kind}_seconds", dt)

    def capacity_bytes(self) -> int:
        dev_free = 0
        for d in local_device_info():
            if d["bytes_limit"]:
                dev_free += d["bytes_limit"] - (d["bytes_in_use"] or 0)
        cap = dev_free or host_free_memory_bytes() // 2
        return max(cap - self.reserved_bytes, 0)

    @wire_guard
    async def _h_stats(self, node, peer, msg) -> dict:
        """Self-report (reference: worker.py:363-381)."""
        return {
            "type": "STATS",
            "node_id": self.node_id,
            "role": self.role,
            "memory": self.capacity_bytes(),
            "devices": local_device_info(),
            "training": self.training,
            "stages_loaded": len(self.stages),
            # measured per-stage footprint: param bytes immediately,
            # program peaks once each shape has run. Reporting only:
            # offer admission pre-filters on param bytes since offers
            # precede any run.
            "stage_memory": {
                f"{jid[:16]}:{idx}": r.memory_stats()
                for (jid, idx), r in self.stages.items()
            },
        }

    @wire_guard
    async def _h_job_offer(self, node, peer, msg) -> dict:
        """Accept/decline by free memory (reference: worker.py:164-188).
        Memory bound = params + grads + 2x Adam state + activation slack."""
        need = int(msg["param_bytes"]) * 4 + (64 << 20)
        if len(self._reservations) >= self.MAX_RESERVATIONS:
            # bound peer-fed reservation growth (tlproto TLP202): expired
            # entries are swept lazily, so a flood of offers from a
            # hostile author must hit a hard ceiling, not the TTL
            self.metrics.incr("job_offer_rejected_total")
            self.flight.record(
                "job_offer_rejected", "warn",
                peer=peer.node_id[:16], reason="reservation table full",
            )
            return {
                "type": "DECLINE_JOB",
                "job_id": str(msg["job_id"]),
                "stage": int(msg["stage"]),
            }
        if need <= self.capacity_bytes():
            self._reservations[(str(msg["job_id"]), int(msg["stage"]))] = (
                need,
                time.time() + self.RESERVATION_TTL_S,
                str(msg.get("author", "")),
            )
            return {
                "type": "ACCEPT_JOB",
                "job_id": msg["job_id"],
                "stage": msg["stage"],
                "info": self.info.to_wire(),
            }
        return {"type": "DECLINE_JOB", "job_id": msg["job_id"], "stage": msg["stage"]}

    def _authorize_spec(self, key, peer, need: int) -> dict | None:
        """Shared by the one-shot and streamed spec paths. Authorization: a live stage may only be replaced by its owner;
        a reservation made on behalf of a job author may only be claimed
        by that author; unreserved shipping is capacity-checked so a peer
        cannot blow past the memory bound reservations protect. Returns an
        error dict, or None (authorized; reservation consumed)."""
        existing = self.stages.get(key)
        if existing is not None and existing.owner != peer.node_id:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "unauthorized"}
        res = self._reservations.get(key)
        if res is not None and res[2] and res[2] != peer.node_id:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "unauthorized"}
        if res is None and existing is None:
            if need > self.capacity_bytes():
                return {"type": "ERROR", "error": "insufficient memory"}
        # reservation becomes a live stage (its memory is now real)
        self._reservations.pop(key, None)
        return None

    def _install_stage(self, meta: dict, module, params, peer) -> dict:
        """Build + register the StageRunner; returns the LOADED ack."""
        runner = self._build_stage(meta, module, params, peer)
        if isinstance(runner, dict):  # refused: the ERROR reply
            return runner
        return self._publish_stage(runner, params)

    def _build_stage(self, meta: dict, module, params, peer):
        """The StageRunner of a shipped stage (its optimizer state made on
        the worker's device), or the ERROR reply that refuses it. Touches
        no state the event loop reads, so it may run off the loop."""
        train = meta.get("train", {})
        opt = make_optimizer(
            train.get("optimizer", "adam"),
            float(train.get("learning_rate", 1e-3)),
            float(train.get("weight_decay", 0.0)),
            moment_dtype=train.get("moment_dtype", "float32"),
        )
        tp = self.cfg.stage_tp_devices
        devices = None
        if tp == -1 or tp > 1:
            local = [d["id"] for d in local_device_info()]
            devices = local if tp == -1 else local[: min(tp, len(local))]
        seed = train.get("seed")
        t_only = train.get("train_only")  # validated pre-transfer by
        # _validate_train_meta on both spec entry paths
        if t_only == "lora":
            from tensorlink_tpu_torch.nn.lora import is_lora_name

            if not any(is_lora_name(k) for k in params):
                # adapter-only training with zero adapter leaves would
                # run to completion applying all-zero updates — loss
                # flat, no diagnostic. The user forgot
                # lora_init (or its targets matched nothing here).
                return {
                    "type": "ERROR",
                    "error": "train_only='lora' but the shipped stage "
                             "carries no LoRA adapter leaves (run "
                             "nn.lora.lora_init on the params first)",
                }
        try:
            runner = StageRunner(
                job_id=str(meta["job_id"]),
                stage_index=int(meta["stage"]),
                module=module,
                params=params,
                opt=opt,
                opt_state=opt.init(params),
                devices=devices,
                train_seed=int(seed) if seed is not None else None,
                train_only=t_only,
                owner=peer.node_id,
                replica=int(meta.get("replica", 0)),
                replica_peers=[
                    dict(p)
                    for p in meta.get("replicas", [])
                    if p.get("node_id") != self.node_id
                ],
                chain=[dict(p) for p in meta.get("chain", [])],
                device=self.device,
            )
        except ValueError as e:  # several local devices: refused
            return {"type": "ERROR", "error": str(e)}
        return runner

    def _publish_stage(self, runner: StageRunner, params) -> dict:
        """Register a built runner (``self.stages``, ``self.training``,
        the pre-dials, the flight record) -> the LOADED ack."""
        self.stages[(runner.job_id, runner.stage_index)] = runner
        self.training = True
        if runner.replica_peers:
            # pre-dial the replica set (initiator = lower node_id) so the
            # first STEP_END's GRAD_SHARE finds live connections
            self._spawn(self._connect_replicas(runner))
        neighbors = [
            p for p in runner.chain
            if abs(int(p.get("stage", -9)) - runner.stage_index) == 1
            and p.get("node_id") != self.node_id
        ]
        if neighbors:
            # pre-dial chain neighbors so the first relay hop finds a live
            # connection (same initiator election as replicas)
            self._spawn(self._preconnect(neighbors))
        self.flight.record(
            "stage_loaded", job_id=runner.job_id[:16],
            stage=runner.stage_index, replica=runner.replica,
            owner=runner.owner[:16], param_bytes=tree_bytes(params),
        )
        return {
            "type": "LOADED",
            "job_id": runner.job_id,
            "stage": runner.stage_index,
            "param_bytes": tree_bytes(params),
        }

    @staticmethod
    def _validate_train_meta(meta: dict) -> dict | None:
        """Cheap schema checks that must run BEFORE authorization and
        transfer: rejecting a typo'd train_only after streaming a
        multi-GB stage (and consuming the reservation) wastes the whole
        shipment."""
        train = dict(meta.get("train") or {})
        t_only = train.get("train_only")
        if t_only not in (None, "lora"):
            return {
                "type": "ERROR",
                "error": f"unknown train_only {t_only!r}; supported: 'lora'",
            }
        from tensorlink_tpu_torch.train.optim import (
            SUPPORTED_MOMENT_DTYPES,
            SUPPORTED_OPTIMIZERS,
        )

        opt_name = train.get("optimizer", "adam")
        if opt_name not in SUPPORTED_OPTIMIZERS:
            # same wasted-shipment rationale: make_optimizer would raise
            # this only in _install_stage, after the full stage streamed
            return {
                "type": "ERROR",
                "error": f"unknown optimizer {opt_name!r}; supported: "
                         f"{SUPPORTED_OPTIMIZERS}",
            }
        mdt = train.get("moment_dtype", "float32")
        if mdt not in SUPPORTED_MOMENT_DTYPES:
            return {
                "type": "ERROR",
                "error": f"unsupported moment_dtype {mdt!r}; supported: "
                         f"{SUPPORTED_MOMENT_DTYPES}",
            }
        if mdt != "float32" and opt_name == "sgd":
            # make_optimizer would raise this AFTER the stage shipped
            return {
                "type": "ERROR",
                "error": "moment_dtype is an adam/adamw option (sgd "
                         "stores no moments)",
            }
        return None

    @wire_guard
    async def _h_module_spec(self, node, peer, msg) -> dict:
        """One-shot path: spec + weights in a single message (small
        stages; large ones arrive via the module_spec stream kind)."""
        err = self._validate_train_meta(msg)
        if err is not None:
            return err
        key = (str(msg["job_id"]), int(msg["stage"]))
        # params + grads + 2x Adam moments + activation slack, measured
        # on the UNCOMPRESSED manifest bytes — len(blob) is zstd-sized
        # and can undercount low-entropy weights 100x
        err = self._authorize_spec(
            key, peer, packed_nbytes(msg["weights"]) * 4 + (64 << 20)
        )
        if err is not None:
            return err

        def build():
            # heavy: decompress + device transfer + opt init, off the
            # event loop so PINGs keep answering (no CUDA call on the
            # node's event-loop thread); it touches no state the loop reads
            flat = unpack_arrays(msg["weights"])
            params = self._to_stage(tree_unflatten_arrays(flat))
            module = self._stage_module(msg["module_config"])
            return self._build_stage(msg, module, params, peer), params

        # the runner is published on the loop, after the await: the loop's
        # readers of self.stages (STATS, capability records) never see it
        # change under them
        runner, params = await asyncio.to_thread(build)
        if isinstance(runner, dict):  # refused: the ERROR reply
            return runner
        return self._publish_stage(runner, params)

    async def _stream_module_spec(self, peer, meta, manifest):
        """Stream-kind factory: a stage too large for one frame arrives
        tensor-by-tensor; each tensor moves to device the moment it
        completes, so host memory is bounded by the largest tensor."""
        err = self._validate_train_meta(meta)
        if err is not None:
            return err
        key = (str(meta["job_id"]), int(meta["stage"]))
        err = self._authorize_spec(
            key, peer, int(manifest["total"]) * 4 + (64 << 20)
        )
        if err is not None:
            return err
        leaves: dict[str, Any] = {}

        def sink(name, arr):
            leaves[name] = arr.to(self.device)  # host staging buffer freed

        async def finish():
            # opt.init and the device transfer of a multi-GB stage
            # must not starve the event loop (same reasoning as the
            # one-shot path's to_thread)
            def build_install():
                module = self._stage_module(meta["module_config"])
                params = self._to_stage(tree_unflatten_arrays(leaves))
                return self._install_stage(meta, module, params, peer)

            return await asyncio.to_thread(build_install)

        return sink, finish

    def _stage_module(self, module_config: dict) -> Module:
        """The stage's module, its parameters on the meta device: the
        shipped tensors replace them at every call (``functional_call``)."""
        return module_from_config(module_config, device=torch.device("meta"))

    def _to_stage(self, tree) -> dict[str, torch.Tensor]:
        """Received params (the reference's nested layout or a flat dict)
        -> flat state dict on this worker's device, dtypes as shipped."""
        return {k: v.to(self.device) for k, v in wire_params(tree).items()}

    @staticmethod
    def _wire_tree(runner: StageRunner, flat: dict) -> dict:
        """Flat names of a stage's params or grads, by the reference's
        layout (``//empty`` markers for parameterless children), on the
        host."""
        tree = param_tree(runner.module, {k: v.detach().cpu()
                                          for k, v in flat.items()})
        return tree_flatten_arrays(tree)

    async def _replica_peer(self, info: dict, wait_s: float = 15.0) -> Peer:
        """Connection to a replica sibling with deterministic initiator
        election: the LOWER node_id dials, the higher waits for the
        inbound connection. Without this, both replicas dial each other on
        the first STEP_END and _register_peer's duplicate-replacement
        closes a stream with the GRAD_SHARE request still in flight
        (simultaneous cross-connect race)."""
        nid = info["node_id"]
        p = self.peers.get(nid)
        if p is not None:
            return p
        if self.node_id < nid:
            return await self.connect_candidates(
                info["host"], int(info["port"]), info.get("alt_hosts", ()),
                expect_id=nid)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait_s
        while loop.time() < deadline:
            p = self.peers.get(nid)
            if p is not None:
                return p
            await asyncio.sleep(0.05)
        # sibling never dialed (it may be older code): dial as fallback
        return await self.connect_candidates(
            info["host"], int(info["port"]), info.get("alt_hosts", ()),
            expect_id=nid)

    async def _connect_replicas(self, runner: StageRunner) -> None:
        await self._preconnect(runner.replica_peers)

    async def _preconnect(self, infos: list) -> None:
        """Pre-dial a peer set with initiator election (lower node_id
        dials) so the first data-plane message finds a live connection."""
        for info in infos:
            if self.node_id < info["node_id"] and info["node_id"] not in self.peers:
                try:
                    await self.connect_candidates(
                        info["host"], int(info["port"]),
                        info.get("alt_hosts", ()),
                        expect_id=info["node_id"])
                except (ConnectionError, OSError) as e:
                    self.log.warning(
                        "peer pre-connect to %s failed: %s",
                        info["node_id"][:8], e,
                    )

    def _authorized_runner(
        self, peer: Peer, msg, allow_validator: bool = False
    ) -> "StageRunner | dict":
        """Only the job owner (the node that shipped the spec) may drive a
        stage; PoL challenges may additionally come from registry-verified
        validators. Without this, any handshaked peer
        could steal weights (PARAMS_REQUEST) or tear the job down."""
        key = (str(msg["job_id"]), int(msg["stage"]))
        runner = self.stages.get(key)
        if runner is None:
            return {"type": "ERROR", "error": f"no stage {key}"}
        if peer.node_id == runner.owner:
            return runner
        if allow_validator:
            if self.registry is not None and self.registry.is_validator(peer.node_id):
                return runner
            if self.registry is None and peer.role == "validator":
                return runner  # off-chain dev mode
        peer.ghosts += 1
        self._penalize(peer)
        return {"type": "ERROR", "error": "unauthorized"}

    @wire_guard
    async def _h_forward(self, node, peer, msg) -> dict | None:
        """Run the stage and return the activation to the requester
        (hub-and-spoke: the master drives the chain, reference §3.2).
        Tensor payloads ride the typed-array codec."""
        runner = self._authorized_runner(peer, msg)
        if isinstance(runner, dict):
            return self._typed_reply(runner)
        if int(msg.get("fence", 0)) < runner.fence:
            return {"type": "ERROR", "error": "stale fence (aborted step)"}
        x = unpack_arrays(msg["data"])["x"]
        t0 = time.perf_counter()
        try:
            # child of the rpc.FORWARD dispatch span when the master is
            # tracing: isolates this stage's compute from wire+queue time
            with self.tracer.span(
                f"stage{runner.stage_index}.fwd",
                {"step": int(msg["step"]), "micro": int(msg["micro"])},
            ):
                out = await asyncio.to_thread(
                    runner.forward, int(msg["step"]), int(msg["micro"]), x,
                    int(msg.get("fence", 0)), bool(msg.get("train", False)),
                    not bool(msg.get("infer", False)),
                )
        except StaleFenceError:
            return {"type": "ERROR", "error": "stale fence (aborted step)"}
        self._observe_stage(runner.stage_index, "fwd", time.perf_counter() - t0)
        reply = {
            "type": "ACTIVATION",
            "job_id": msg["job_id"],
            "stage": msg["stage"],
            "step": msg["step"],
            "micro": msg["micro"],
            "data": pack_arrays({"x": out}),
        }
        return reply

    @wire_guard
    async def _h_backward(self, node, peer, msg) -> dict | None:
        runner = self._authorized_runner(peer, msg)
        if isinstance(runner, dict):
            return self._typed_reply(runner)
        if int(msg.get("fence", 0)) < runner.fence:
            return {"type": "ERROR", "error": "stale fence (aborted step)"}
        g = unpack_arrays(msg["data"])["g"]
        t0 = time.perf_counter()
        try:
            with self.tracer.span(
                f"stage{runner.stage_index}.bwd",
                {"step": int(msg["step"]), "micro": int(msg["micro"])},
            ):
                gx = await asyncio.to_thread(
                    runner.backward, int(msg["step"]), int(msg["micro"]), g,
                    int(msg.get("fence", 0)),
                )
        except StaleFenceError:
            return {"type": "ERROR", "error": "stale fence (aborted step)"}
        self._observe_stage(runner.stage_index, "bwd", time.perf_counter() - t0)
        return {
            "type": "INPUT_GRAD",
            "job_id": msg["job_id"],
            "stage": msg["stage"],
            "step": msg["step"],
            "micro": msg["micro"],
            "data": pack_arrays({"g": gx}),
        }

    # ------------------------------------------------- worker->worker relay
    # Stage-to-stage activation transfer. The master sends the micro-batch to the FIRST
    # stage with the remaining route; each worker computes and forwards
    # DIRECTLY to the next stage's worker; the last hop returns the result
    # to the origin (master) as a RELAY_RESULT. Backward mirrors in
    # reverse. Fencing/idempotency are identical to the hub path — every
    # hop carries (job, stage, step, micro, fence).

    def _relay_sender_ok(self, runner: StageRunner, peer: Peer, *, backward: bool) -> bool:
        """A relay hop may come from the job owner (first hop) or from the
        ADJACENT stage worker of this replica's chain (shipped in the
        MODULE_SPEC, refreshed on every recovery re-ship). Anything else
        is ghosted — a handshaken stranger must not drive the stage."""
        if peer.node_id == runner.owner:
            return True
        want = runner.stage_index + (1 if backward else -1)
        return any(
            int(p.get("stage", -1)) == want
            and int(p.get("replica", 0)) == runner.replica
            and p.get("node_id") == peer.node_id
            for p in runner.chain
        )

    async def _relay_to_origin(self, msg: dict, payload: dict) -> None:
        origin = self.peers.get(str(msg.get("origin", "")))
        if origin is None:
            # master connection gone: nothing to reply to — the master's
            # waiter times out and its elastic recovery takes over
            self.log.warning(
                "relay result for step %s micro %s has no origin connection",
                msg.get("step"), msg.get("micro"),
            )
            return
        try:
            await self.send(origin, {
                **payload,
                "job_id": msg["job_id"],
                "step": msg["step"],
                "micro": msg["micro"],
                "fence": msg.get("fence", 0),
            })
        except (ConnectionError, OSError):
            # connection died between lookup and send: same outcome as
            # origin-missing above — the master's elastic retry resolves
            self.log.warning(
                "relay result for step %s micro %s lost origin connection",
                msg.get("step"), msg.get("micro"),
            )

    async def _relay_error(self, msg: dict, error: str) -> None:
        await self._relay_to_origin(
            msg, {"type": "RELAY_ERROR", "kind": msg.get("kind", "act"),
                  "error": error},
        )

    async def _relay_run(self, runner: StageRunner, msg: dict, *, backward: bool) -> None:
        """Compute this hop off-loop, then forward along the route or
        return the final result to the origin."""
        arr_key = "g" if backward else "x"
        kind = "grad" if backward else "act"
        t0 = time.perf_counter()
        try:
            # unpack inside the try: a malformed hop payload must flow to
            # the master as RELAY_ERROR, not stall its waiter to timeout
            data = unpack_arrays(msg["data"])[arr_key]
            extra = () if backward else (
                bool(msg.get("train", False)),
                not bool(msg.get("infer", False)),
            )
            fn = runner.backward if backward else runner.forward
            with self.tracer.span(
                f"stage{runner.stage_index}.{'bwd' if backward else 'fwd'}",
                {"step": int(msg["step"]), "micro": int(msg["micro"]),
                 "relay": True},
            ):
                out = await asyncio.to_thread(
                    fn, int(msg["step"]), int(msg["micro"]), data,
                    int(msg.get("fence", 0)), *extra,
                )
        except StaleFenceError:
            return  # aborted step attempt: drop silently
        except Exception as e:  # noqa: BLE001 — surfaced to the master
            await self._relay_error(dict(msg, kind=kind), f"stage {runner.stage_index}: {e}")
            return
        self._observe_stage(
            runner.stage_index, "bwd" if backward else "fwd",
            time.perf_counter() - t0,
        )
        route = list(msg.get("route") or [])
        blob = pack_arrays({arr_key: out})
        if route:
            nxt = route[0]
            try:
                p = await self._replica_peer(nxt)
                await self.send(p, {
                    "type": "RELAY_BACKWARD" if backward else "RELAY_FORWARD",
                    "job_id": msg["job_id"],
                    "stage": int(nxt["stage"]),
                    "step": msg["step"],
                    "micro": msg["micro"],
                    "fence": msg.get("fence", 0),
                    "origin": msg.get("origin"),
                    "route": route[1:],
                    # train/infer modes ride every hop: each stage derives
                    # its own (seed, stage, step, micro) dropout stream,
                    # and inference hops skip the backward stash
                    "train": bool(msg.get("train", False)),
                    "infer": bool(msg.get("infer", False)),
                    "data": blob,
                })
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                await self._relay_error(
                    dict(msg, kind=kind),
                    f"hop stage {runner.stage_index}->{nxt.get('stage')}: {e}",
                )
        else:
            await self._relay_to_origin(
                msg, {"type": "RELAY_RESULT", "kind": kind, "data": blob},
            )

    async def _h_relay(self, peer: Peer, msg: dict, *, backward: bool) -> dict | None:
        key = (str(msg["job_id"]), int(msg["stage"]))
        runner = self.stages.get(key)
        first_hop = peer.node_id == str(msg.get("origin", ""))
        kind = "grad" if backward else "act"

        async def fail(error: str) -> dict | None:
            if first_hop:
                return {"type": "ERROR", "error": error}
            await self._relay_error(dict(msg, kind=kind), error)
            return None

        if runner is None:
            return await fail(f"no stage {key}")
        if not self._relay_sender_ok(runner, peer, backward=backward):
            peer.ghosts += 1
            self._penalize(peer)
            return await fail("unauthorized relay sender")
        if int(msg.get("fence", 0)) < runner.fence:
            if first_hop:
                return {"type": "ERROR", "error": "stale fence (aborted step)"}
            return None  # stale straggler hop: drop
        # ack immediately (first hop is a master request); compute+forward
        # proceed in the background, errors flow to the origin
        self._spawn(self._relay_run(runner, msg, backward=backward))
        if first_hop:
            return {"type": "RELAY_ACCEPTED", "stage": runner.stage_index}
        return None

    @wire_guard
    async def _h_relay_forward(self, node, peer, msg) -> dict | None:
        return await self._h_relay(peer, msg, backward=False)

    @wire_guard
    async def _h_relay_backward(self, node, peer, msg) -> dict | None:
        return await self._h_relay(peer, msg, backward=True)

    @wire_guard
    async def _h_step_end(self, node, peer, msg) -> dict:
        """All micro-grads in: optimizer step (correctly: step, no
        pre-zeroing — contrast worker.py:320-321). When the stage has
        data-parallel replicas, grads are exchanged worker-to-worker and
        averaged deterministically before the update (the reference only
        *planned* this, Whitepaper:21)."""
        runner = self._authorized_runner(peer, msg)
        if isinstance(runner, dict):
            return self._typed_reply(runner)
        master_step = int(msg["step"]) if "step" in msg else None
        fence = int(msg.get("fence", 0))
        if not runner.replica_peers:
            applied = await asyncio.to_thread(runner.apply_step, master_step, fence)
            return {"type": "STEPPED", "step": runner.step, "applied": applied}

        snap = await asyncio.to_thread(runner.take_accum, master_step, fence)
        if snap is None:  # duplicate/stale STEP_END
            return {"type": "STEPPED", "step": runner.step, "applied": False}
        own_g, own_n = snap

        # push our contribution to every replica peer, then wait for
        # theirs; the combined sum is ordered by node_id so every replica
        # applies a bitwise-identical update
        def pack_contrib():
            if own_g is None:
                return pack_arrays({}), own_n
            return pack_arrays(self._wire_tree(runner, own_g)), own_n

        blob, n = await asyncio.to_thread(pack_contrib)

        async def push(info: dict):
            p = await self._replica_peer(info)
            # idempotent: the receiver's inbox slot is keyed (job,
            # stage, step, sender) — a duplicate delivery overwrites
            # with identical bytes — so a transient replica blip costs
            # one jittered backoff, not the whole training step
            await self.request_idempotent(
                p,
                {
                    "type": "GRAD_SHARE",
                    "job_id": runner.job_id,
                    "stage": runner.stage_index,
                    "step": master_step,
                    "n": n,
                    "data": blob,
                },
                timeout=30.0,
            )

        ev_key = (runner.job_id, runner.stage_index, master_step)
        event = self._grad_events.setdefault(ev_key, asyncio.Event())
        try:
            await asyncio.gather(*(push(i) for i in runner.replica_peers))
            expected = {i["node_id"] for i in runner.replica_peers}
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 30.0
            while True:
                have = {
                    s
                    for (j, st, sp, s) in self._grad_inbox
                    if j == runner.job_id
                    and st == runner.stage_index
                    and sp == master_step
                }
                if expected <= have:
                    break
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise asyncio.TimeoutError("grad sync timeout")
                event.clear()
                try:
                    await asyncio.wait_for(event.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    raise asyncio.TimeoutError("grad sync timeout") from None
        except (ConnectionError, asyncio.TimeoutError) as e:
            # put the local gradient back so a retried STEP_END can
            # re-sync it — dropping it here silently diverged the
            # replica set
            runner.restore_accum(own_g, own_n, master_step, fence)
            self._grad_events.pop(ev_key, None)
            return {"type": "ERROR", "error": f"grad sync failed: {e}"}

        contribs = {self.node_id: (own_g, own_n)}
        for nid in expected:
            key = (runner.job_id, runner.stage_index, master_step, nid)
            contribs[nid] = self._grad_inbox.pop(key)
        ordered = [contribs[nid] for nid in sorted(contribs)]
        applied = await asyncio.to_thread(
            runner.apply_synced, master_step, ordered
        )
        self._grad_events.pop(ev_key, None)
        self._gc_grad_state(runner)
        return {"type": "STEPPED", "step": runner.step, "applied": applied}

    def _gc_grad_state(self, runner: StageRunner) -> None:
        """Evict inbox entries + events for steps this stage has already
        applied — a replica that timed out of a sync used to leave its
        (late-arriving) share in the inbox forever."""
        applied = runner.last_applied_step
        if applied < 0:
            return
        stale = [
            k
            for k in self._grad_inbox
            if k[0] == runner.job_id
            and k[1] == runner.stage_index
            and isinstance(k[2], int)
            and k[2] <= applied
        ]
        for k in stale:
            del self._grad_inbox[k]
        stale_ev = [
            k
            for k in self._grad_events
            if k[0] == runner.job_id
            and k[1] == runner.stage_index
            and isinstance(k[2], int)
            and k[2] <= applied
        ]
        for k in stale_ev:
            del self._grad_events[k]

    @wire_guard
    async def _h_grad_share(self, node, peer, msg) -> dict:
        """A replica peer's gradient contribution. Only accepted from the
        stage's registered replica set."""
        key = (str(msg["job_id"]), int(msg["stage"]))
        runner = self.stages.get(key)
        if runner is None:
            return {"type": "ERROR", "error": f"no stage {key}"}
        if peer.node_id not in {i["node_id"] for i in runner.replica_peers}:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "not a replica peer"}

        def unpack():
            flat = unpack_arrays(msg["data"])
            if not flat or set(flat) == {"//empty"}:
                return None
            return {
                k: v.to(runner.device)
                for k, v in wire_params(tree_unflatten_arrays(flat)).items()
            }

        g = await asyncio.to_thread(unpack)
        step = int(msg["step"])
        if step <= runner.last_applied_step:
            # late share for a step this replica already applied (its own
            # sync may have timed out and been retried) — do not stash it
            # forever (unbounded inbox growth)
            return {"type": "GRAD_ACK", "step": step, "stale": True}
        self._grad_inbox[
            (runner.job_id, runner.stage_index, step, peer.node_id)
        ] = (g, int(msg["n"]))
        ev = self._grad_events.get((runner.job_id, runner.stage_index, step))
        if ev is not None:
            ev.set()
        return {"type": "GRAD_ACK", "step": step}

    @wire_guard
    async def _h_abort_step(self, node, peer, msg) -> dict:
        """Discard partial grads/activations after a mid-step stage
        failure so the master can retry the step against a recovered
        pipeline."""
        runner = self._authorized_runner(peer, msg)
        if isinstance(runner, dict):
            return self._typed_reply(runner)
        runner.fence = max(runner.fence, int(msg.get("fence", runner.fence + 1)))
        runner.reset_step()
        self.flight.record(
            "step_aborted", "warn", job_id=runner.job_id[:16],
            stage=runner.stage_index, fence=runner.fence, step=runner.step,
        )
        return {"type": "STEP_ABORTED", "step": runner.step, "fence": runner.fence}

    @wire_guard
    async def _h_params_request(self, node, peer, msg) -> dict:
        """Return current stage params (reference: send_parameters,
        torch_node.py:148-157). With ``stream: true`` the weights come
        back as a chunked "parameters" stream (large stages) and this
        response only carries the metadata."""
        runner = self._authorized_runner(peer, msg, allow_validator=True)
        if isinstance(runner, dict):
            return self._typed_reply(runner)
        head = {
            "type": "PARAMETERS",
            "job_id": msg["job_id"],
            "stage": msg["stage"],
            "step": runner.step,
            # last APPLIED master step: a reattaching master must resume
            # strictly above this or its STEP_ENDs are skipped as dupes
            "applied_step": runner.last_applied_step,
            "fence": runner.fence,
        }
        flat = await asyncio.to_thread(
            lambda: self._wire_tree(runner, runner.params)
        )
        if msg.get("stream"):
            head["streaming"] = True

            async def stream_back():
                meta = {"job_id": str(msg["job_id"]),
                        "stage": int(msg["stage"]), "req": msg.get("id")}
                try:
                    resp = await self.send_stream(peer, "parameters", meta, flat)
                    if resp.get("type") not in ("OK", "DONE"):
                        raise RuntimeError(f"stream rejected: {resp}")
                except Exception as e:  # noqa: BLE001
                    # fire-and-forget must not fail silently: the user
                    # would block for the full stream timeout; log here
                    # and tell the peer best-effort
                    self.log.warning("PARAMETERS stream failed: %s", e)
                    try:
                        await self.send(
                            peer,
                            {"type": "PARAMS_STREAM_FAILED",
                             "job_id": meta["job_id"],
                             "stage": meta["stage"], "error": str(e)},
                        )
                    except Exception:  # noqa: BLE001
                        pass

            self._spawn(stream_back())
            return head
        head["weights"] = pack_arrays(flat)
        return head

    @wire_guard
    async def _h_unload(self, node, peer, msg) -> dict:
        """Free a finished job's stages + any reservation (job teardown;
        the reference had no teardown at all). Owner-only."""
        jid = str(msg["job_id"])
        removed = [
            k
            for k, r in self.stages.items()
            if k[0] == jid and r.owner == peer.node_id
        ]
        # reservations are author-owned too: a peer may only clear its own
        # (otherwise any peer could free a pending job's
        # reservation between ACCEPT_JOB and MODULE_SPEC)
        res_removed = [
            k
            for k, v in self._reservations.items()
            if k[0] == jid and (not v[2] or v[2] == peer.node_id)
        ]
        touched_foreign = (
            any(k[0] == jid for k in self.stages)
            or any(k[0] == jid for k in self._reservations)
        ) and not (removed or res_removed)
        if touched_foreign:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "unauthorized"}
        for k in removed:
            del self.stages[k]
        for k in res_removed:
            del self._reservations[k]
        self.training = bool(self.stages)
        if removed or res_removed:
            self.flight.record(
                "stage_unloaded", job_id=jid[:16], stages=len(removed),
                reservations=len(res_removed),
            )
        return {"type": "UNLOADED", "job_id": jid, "stages": len(removed)}

    @wire_guard
    async def _h_pol_challenge(self, node, peer, msg) -> dict:
        """Deterministic re-execution (``roles/pol.py``).

        Two challenge forms:
        - {"seed": s, "shape": [...]}: derive the input from the
          device-invariant counter-hash stream (cheap wire);
        - {"data": blob}: explicit input array.
        The proof commits to the forward output AND the input-cotangent of
        sum(out) (gradient validation, Whitepaper:41-47) plus the current
        params digest so successive audits evidence training progress.
        """
        from tensorlink_tpu_torch.roles import pol

        runner = self._authorized_runner(peer, msg, allow_validator=True)
        if isinstance(runner, dict):
            return self._typed_reply(runner)
        if "data" in msg:
            blob = bytes(msg["data"])

            def challenge():
                return unpack_arrays(blob)["x"].to(runner.compute_dtype)
        else:
            # the challenge is derived in the stage's declared compute
            # dtype (a validator's replay does the same): the reference
            # draws f32 and promotes, which a bf16 torch stage refuses
            shape = tuple(int(s) for s in msg["shape"])
            seed = int(msg["seed"])
            dtype = msg.get("dtype") or str(runner.compute_dtype).removeprefix("torch.")

            def challenge():
                return pol.challenge_input(seed, shape, dtype)

        # snapshot ONCE: proof, digest, and (optionally) the returned
        # weights all come from the same param dict (an optimizer step
        # replaces it, never mutates it), so a live step can never make an
        # honest proof inconclusive
        p = runner.params
        step = runner.step

        def compute():
            # the proof, the digest and the host copies all off the loop
            out, gx = runner.pol(p, challenge())
            wire = self._wire_tree(runner, p)
            out_c = pol.commitment(out)
            return {
                "type": "POL_PROOF",
                "job_id": msg["job_id"],
                "stage": msg["stage"],
                "step": step,
                "output": out_c,
                "input_grad": pol.commitment(gx),
                "params_digest": pol.params_digest(wire),
                # back-compat fields
                "digest": out_c["digest"],
                "output_sum": float(out.float().sum()),
            }, wire

        reply, wire = await asyncio.to_thread(compute)
        if msg.get("include_params"):
            reply["weights"] = await asyncio.to_thread(pack_arrays, wire)
        return reply
