"""User: job requester and training master (port of
``tensorlink_tpu/roles/user.py``).

``request_job`` partitions a model into stages by a memory budget,
negotiates placement through a validator, ships stage specs and weights
to the recruited workers (the reference's names and layout), then drives
pipelined micro-batch training over typed FORWARD/BACKWARD messages.

Params are the reference's nested tree (``{"0": {"w": ...}, "1": {}}``)
of torch tensors; a flat state dict is nested on entry. Activations and
gradients are torch tensors on the host, on the wire as ``pack_arrays``
blobs (bf16 as its bits), and ``loss_grad`` callbacks take and return
torch tensors. ``partition_tree`` takes its shapes from a run on the
meta device. An obfuscation key is an integer seed.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.nn.module import Module, Sequential
from tensorlink_tpu_torch.p2p.node import Node, Peer, wire_guard
from tensorlink_tpu_torch.p2p.serialization import (
    pack_arrays,
    tree_flatten_arrays,
    unpack_arrays,
)
from tensorlink_tpu_torch.roles.jobs import JobRecord, StageSpec
from tensorlink_tpu_torch.nn.staging import param_bytes as tree_bytes
from tensorlink_tpu_torch.utils.trees import nest


def nested_params(params) -> dict:
    """A param tree in the reference's nested layout: a flat state dict
    (dotted names) is nested; a nested tree passes through."""
    if any(isinstance(v, dict) for v in params.values()):
        return params
    return nest(dict(params))


def _wire(a):
    """A tensor for ``pack_arrays``: on the host (bf16 stays bf16)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return np.asarray(a)


def _split(batch, m: int) -> list:
    if isinstance(batch, torch.Tensor):
        return list(torch.tensor_split(batch, m))
    return [torch.as_tensor(x) for x in np.array_split(np.asarray(batch), m)]


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _wire(tree)


def partition_sequential(
    seq: Sequential, params: dict, max_stage_bytes: float
) -> list[tuple[Sequential, dict]]:
    """Greedy size-capped partition of a Sequential into stages
    (reference: parse_model's recursive size cap, user.py:316-425).
    Returns [(sub_module, sub_params), ...]."""
    params = nested_params(params)
    return _chunk_units(
        ((layer, params.get(str(i), {})) for i, layer in enumerate(seq.layers)),
        max_stage_bytes,
    )


def _chunk_units(units, max_stage_bytes: float):
    """Greedy size-capped chunking of (module, params) units into
    [(Sequential, params)] stages — shared tail of both partitioners."""
    stages: list[tuple[Sequential, dict]] = []
    cur: list[Module] = []
    cur_params: dict = {}
    cur_bytes = 0
    for mod, p in units:
        b = tree_bytes(p)
        if cur and cur_bytes + b > max_stage_bytes:
            stages.append((Sequential(cur), cur_params))
            cur, cur_params, cur_bytes = [], {}, 0
        cur_params[str(len(cur))] = p
        cur.append(mod)
        cur_bytes += b
    if cur:
        stages.append((Sequential(cur), cur_params))
    return stages


def partition_tree(
    module: Module,
    params: dict,
    max_stage_bytes: float,
    example: "torch.Tensor | None" = None,
) -> list[tuple[Sequential, dict]]:
    """Memory-capped partition of an ARBITRARY module tree — including
    branching ``Parallel`` containers — into a placeable CHAIN of
    stages (the TPU-native answer to the reference's recursive
    parse_model walk, src/roles/user.py:316-425, which descends any
    nn.Module tree by memory).

    A ``Parallel`` that exceeds the budget is linearized with carry
    packing: the input x rides the activation's feature tail through
    each branch's stages (TailMap), finished branch outputs accumulate
    in the prefix, and a CombineTail stage merges them — so branch
    stages place on DIFFERENT workers while the wire still carries one
    array per hop. ``example`` (a ShapeDtypeStruct or array of the
    model input) is required when a Parallel must split: packing
    offsets come from a meta-device run through the tree (``example`` is
    any tensor of the input's shape and dtype). Sequential trees reduce to
    partition_sequential's greedy chunks exactly."""
    from tensorlink_tpu_torch.utils.trees import flatten

    params = nested_params(params)

    def out_aval(mod, p, aval):
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in flatten(p).items()}
        return functional_call(mod, meta, (aval,))

    def linearize(mod, p, aval):
        """-> (units [(module, params)], out_aval)."""
        if isinstance(mod, Sequential):
            units = []
            for i, layer in enumerate(mod.layers):
                u, aval = linearize(layer, p.get(str(i), {}), aval)
                units.extend(u)
            return units, aval
        from tensorlink_tpu_torch.nn.module import (
            AppendTail,
            CombineTail,
            Parallel,
            TailMap,
        )

        if isinstance(mod, Parallel) and tree_bytes(p) > max_stage_bytes:
            if aval is None:
                raise ValueError(
                    "partition_tree needs `example` to split a Parallel "
                    "container (packing offsets come from eval_shape)"
                )
            x_width = aval.shape[-1]
            units: list = []
            prefix = x_width
            widths = []
            branch_out = None
            for i, branch in enumerate(mod.branches):
                units.append((AppendTail(x_width), {}))
                bunits, b_aval = linearize(branch, p.get(str(i), {}), aval)
                for bu, bp in bunits:
                    units.append((TailMap(bu, prefix), {"inner": bp}))
                widths.append(b_aval.shape[-1])
                prefix += b_aval.shape[-1]
                branch_out = b_aval
            units.append(
                (CombineTail(mod.combine, x_width, widths), {})
            )
            if mod.combine == "concat":
                out = torch.empty((*branch_out.shape[:-1], sum(widths)),
                                  dtype=branch_out.dtype, device="meta")
            else:
                out = branch_out
            return units, out
        # atomic unit (fits, or indivisible — the greedy chunker gives
        # an oversized atom its own stage, same as partition_sequential)
        return [(mod, p)], None if aval is None else out_aval(mod, p, aval)

    aval = None
    if example is not None:
        dtype = (example.dtype if isinstance(example, torch.Tensor)
                 else torch.from_numpy(np.zeros((), np.asarray(example).dtype)).dtype)
        aval = torch.empty(tuple(example.shape), dtype=dtype, device="meta")
    units, _ = linearize(module, params, aval)
    return _chunk_units(units, max_stage_bytes)


class StepEndFailure(RuntimeError):
    """A failure during the STEP_END fan-out: some stages may have already
    applied the optimizer update while others have not."""


@dataclass
class RemoteStage:
    index: int
    peer: Peer
    info: dict
    replica: int = 0


def placement_wire(st: RemoteStage) -> dict:
    """The one wire shape for a stage placement (recruitment info + slot
    coordinates) — used for replica sets, relay chains, and relay routes."""
    return dict(st.info, stage=st.index, replica=st.replica)


class DistributedJob:
    """Master-side handle to a placed job — the TPU-era DistributedModel.

    forward/backward run all micro-batches concurrently through the worker
    chain (pipelining across stages emerges from per-micro ordering, but
    explicitly scheduled by asyncio rather than thread timing)."""

    def __init__(
        self,
        user: "UserNode",
        job: JobRecord,
        stages: list[RemoteStage],
        validator: Peer | None = None,
        plan=None,  # ObfuscationPlan: master-side secret rotations
        stage_modules: "list[Sequential] | None" = None,
        relay: bool | None = None,
    ):
        self.user = user
        self.job = job
        self.stages = stages  # ALL stage slots (every replica)
        self.validator = validator  # for elastic re-recruitment
        # replica validators named in ACCEPT_JOB (the seed pushed the job
        # record to them): recovery fails over to these when the seed
        # validator dies mid-job
        self.backup_validators: list[dict] = []
        self.plan = plan
        # worker-to-worker activation relay: default ON for every clear (non-obfuscated) job,
        # chain-backed or not; the obfuscated path must stay
        # hub-and-spoke — the plan's secret rotations between stages are
        # applied by the MASTER only.
        self.relay = (plan is None) if relay is None else relay
        if self.relay and plan is not None:
            raise ValueError("relay transfer is incompatible with obfuscation")
        self.stage_modules = stage_modules
        self.obfuscate_key = None  # set by request_job/reattach_job
        # on-chain job record (request_job(chain_registry=...)): the
        # ledger id this job was requested under, completed by
        # complete_onchain() when the user is done
        self.chain_registry = None
        self.chain_job_id: int | None = None
        self.step = 0
        # last-known params per stage, used to re-ship on stage recovery
        # (seeded with the initial shipment; refreshed by checkpoint_stages)
        self._stage_params: dict[int, Any] = {}
        self.max_step_retries = 2
        # bound what a snapshot rollback can cost: the
        # recovery cache auto-refreshes every N successful steps
        self.checkpoint_every_steps = 25
        # fencing epoch: bumped on every abort; stages reject data-plane
        # messages from older epochs, so a straggler from an aborted
        # attempt can never double-count into a retried step
        self._fence = 0
        # durable checkpointing (attach_durable_checkpointing): the
        # in-memory recovery cache survives a master+validator loss only
        # if it also lands on disk
        self._ckpt = None
        # inference passes get their own step namespace, advancing per
        # call: reusing self.step would (a) make repeated train-mode
        # forwards draw bitwise-identical dropout masks (MC dropout
        # variance 0) and (b) let a straggler RELAY_RESULT from an
        # aborted forward() fulfill a LATER call's identical waiter key
        # with the previous batch's activations. Offset
        # far above any realistic training step count, inside int32 for
        # the rng fold.
        self._infer_seq = 1 << 30
        # train/eval mode fan-out (reference: DistributedModel.train()/
        # eval() over UT-REQ, src/ml/distributed.py:204-234). Here the
        # mode rides every FORWARD/RELAY_FORWARD message; stages run
        # their dropout-on train programs only when the job also shipped
        # a train seed (MODULE_SPEC train.seed), so eval-only jobs and
        # old records keep today's deterministic behavior.
        self.train_mode = True
        # health sentinels (runtime/flight.py): the master's /healthz
        # reflects THIS job — a dead stage peer sets a readiness
        # condition (cleared on recovery), and a step watchdog trips
        # when train_step stops completing (armed on the first step,
        # disarmed by shutdown)
        self._step_dog = None
        if user.cfg.step_watchdog_s:
            self._step_dog = user.health.watchdog(
                f"job_step:{job.job_id[:16]}",
                user.cfg.step_watchdog_s,
                armed=False,
            )
        user._register_job(self)
        user.flight.record(
            "job_placed", job_id=job.job_id[:16], stages=job.n_stages,
            dp=job.dp_factor, relay=self.relay,
            workers=[st.peer.node_id[:16] for st in stages],
        )

    def train(self, mode: bool = True) -> None:
        """Fan train/eval mode out to subsequent forward passes."""
        self.train_mode = bool(mode)

    def eval(self) -> None:
        self.train(False)

    @property
    def _train_flag(self) -> bool:
        return bool(self.train_mode and self.job.train.get("seed") is not None)

    def attach_durable_checkpointing(self, directory: str) -> None:
        """Persist the recovery cache (stage params + job record) to disk
        via orbax on every periodic checkpoint_stages() refresh. Resume
        with UserNode.resume_job_from_checkpoint(directory, ...)."""
        from tensorlink_tpu_torch.runtime.checkpoint import CheckpointManager

        self._ckpt = CheckpointManager(directory, async_save=False)

    def _persist_checkpoint(self, stages: dict, step: int) -> None:
        """Blocking orbax write of an event-loop-consistent SNAPSHOT.

        Runs in a worker thread (asyncio.to_thread) while the event
        loop keeps driving train_step — so it must not touch
        ``self._stage_params``/``self.step`` directly: a concurrent
        step would tear the bundle (stage params from step N stamped
        master_step N+k). The caller captures both on the loop and
        passes them in (tlint TL602)."""
        state = {"stages": {str(i): p for i, p in stages.items()}}
        if self.obfuscate_key is not None:
            state["obfuscate_key"] = np.asarray(int(self.obfuscate_key), np.int64)
        self._ckpt.save(
            step,
            _host_tree(state),
            metadata={
                "job": self.job.to_wire(),
                "master_step": step,
                "obfuscated": self.plan is not None,
            },
            force=True,
        )

    @property
    def chains(self) -> list[list[RemoteStage]]:
        """Data-parallel pipelines DERIVED from the live stage slots:
        chains[r] = replica r's stage chain; micro-batch m routes through
        chains[m % dp] (reference planned this as dp_factor,
        src/roles/user.py:161 — never built). Computed on access so a
        recovered stage slot is visible immediately (a cached list would
        send every retried FORWARD to the dead worker's RemoteStage)."""
        by_replica: dict[int, list[RemoteStage]] = {}
        for st in self.stages:
            by_replica.setdefault(st.replica, []).append(st)
        return [
            sorted(by_replica[r], key=lambda s: s.index)
            for r in sorted(by_replica)
        ]

    async def _relay_micro(
        self, step: int, micro: int, arr: np.ndarray, *, backward: bool,
        infer: bool = False,
    ) -> np.ndarray:
        """One micro-batch through the chain via worker-to-worker relay:
        one request to the entry stage carrying the remaining route; the
        exit stage sends the result straight back to us. vs the hub path:
        half the master traffic, hops ride worker links."""
        chain = self.chains[micro % len(self.chains)]
        order = list(reversed(chain)) if backward else chain
        entry, exit_st = order[0], order[-1]
        kind = "grad" if backward else "act"
        arr_key = "g" if backward else "x"
        key = (self.job.job_id, step, micro, kind, self._fence)
        fut = self.user.relay_waiter(
            key, expected=exit_st.peer.node_id,
            members={st.peer.node_id for st in chain},
        )
        t0 = time.perf_counter()
        try:
            # one span for the whole chain traversal (the per-stage split
            # lives in each worker's stageN spans, stitched by _trace)
            with self.user.tracer.span(
                f"relay.{'bwd' if backward else 'fwd'}",
                {"step": step, "micro": micro, "stages": len(chain)},
            ):
                ack = await self.user.request(
                    entry.peer,
                    {
                        "type": "RELAY_BACKWARD" if backward else "RELAY_FORWARD",
                        "job_id": self.job.job_id,
                        "stage": entry.index,
                        "step": step,
                        "micro": micro,
                        "fence": self._fence,
                        "origin": self.user.node_id,
                        "route": [placement_wire(st) for st in order[1:]],
                        "train": self._train_flag,
                        "infer": infer,
                        "data": pack_arrays({arr_key: _wire(arr)}),
                    },
                    timeout=60.0,
                )
                if ack.get("type") != "RELAY_ACCEPTED":
                    raise RuntimeError(
                        f"stage {entry.index} relay rejected: {ack}"
                    )
                blob = await asyncio.wait_for(fut, timeout=60.0 * len(chain))
            self.user.metrics.observe(
                f"relay_{kind}_s", time.perf_counter() - t0
            )
            return unpack_arrays(blob)[arr_key]
        finally:
            self.user.drop_relay_waiter(key)

    async def _micro_forward(
        self, step: int, micro: int, x: np.ndarray, infer: bool = False
    ) -> np.ndarray:
        chain = self.chains[micro % len(self.chains)]
        if self.relay and len(chain) > 1:
            return await self._relay_micro(
                step, micro, x, backward=False, infer=infer
            )
        for st in chain:
            if self.plan is not None:
                x = self.plan.forward_in(st.index, x)
            # per-(stage, micro) span + rolling series: the master-side
            # observation (compute + wire + queue) that feeds
            # tracing.straggler_report — surfaced at this node's /node
            t0 = time.perf_counter()
            with self.user.tracer.span(
                f"stage{st.index}.fwd.rpc", {"step": step, "micro": micro}
            ):
                resp = await self.user.request(
                    st.peer,
                    {
                        "type": "FORWARD",
                        "job_id": self.job.job_id,
                        "stage": st.index,
                        "step": step,
                        "micro": micro,
                        "fence": self._fence,
                        "train": self._train_flag,
                        "infer": infer,
                        "data": pack_arrays({"x": _wire(x)}),
                    },
                    timeout=60.0,
                )
            if resp.get("type") != "ACTIVATION":
                raise RuntimeError(f"stage {st.index} forward failed: {resp}")
            self.user.metrics.observe(
                f"stage{st.index}_fwd_s", time.perf_counter() - t0
            )
            x = unpack_arrays(resp["data"])["x"]
            if self.plan is not None:
                x = self.plan.forward_out(st.index, x)
        return x

    async def _micro_backward(self, step: int, micro: int, g: np.ndarray) -> np.ndarray:
        chain = self.chains[micro % len(self.chains)]
        if self.relay and len(chain) > 1:
            return await self._relay_micro(step, micro, g, backward=True)
        for st in reversed(chain):
            if self.plan is not None:
                g = self.plan.backward_in(st.index, g)
            t0 = time.perf_counter()
            with self.user.tracer.span(
                f"stage{st.index}.bwd.rpc", {"step": step, "micro": micro}
            ):
                resp = await self.user.request(
                    st.peer,
                    {
                        "type": "BACKWARD",
                        "job_id": self.job.job_id,
                        "stage": st.index,
                        "step": step,
                        "micro": micro,
                        "fence": self._fence,
                        "data": pack_arrays({"g": _wire(g)}),
                    },
                    timeout=60.0,
                )
            if resp.get("type") != "INPUT_GRAD":
                raise RuntimeError(f"stage {st.index} backward failed: {resp}")
            self.user.metrics.observe(
                f"stage{st.index}_bwd_s", time.perf_counter() - t0
            )
            g = unpack_arrays(resp["data"])["g"]
            if self.plan is not None:
                g = self.plan.backward_out(st.index, g)
        return g

    async def complete_onchain(self) -> None:
        """Mark this job's on-chain record completed (releases the
        payment escrow in a real deployment; see chain/registry.py).
        No-op when the job was not requested with a chain_registry."""
        if self.chain_registry is None or self.chain_job_id is None:
            return
        import asyncio as _asyncio

        await _asyncio.to_thread(
            self.chain_registry.complete_job_onchain, self.chain_job_id
        )

    async def shutdown(self, timeout: float = 10.0) -> int:
        """Tear the job down: UNLOAD every stage peer (frees loaded
        stages + any reservation worker-side; owner-authorized) and close
        the on-chain record. The reference had no job teardown at all —
        finished jobs pinned worker memory until the process died, which
        is exactly the capacity leak the worker's reservation TTL guards
        against for NEVER-shipped jobs. Best-effort per peer: a dead
        worker's state is reclaimed by its own restart, not by us.
        Returns the number of stage slots workers confirmed freed."""
        async def unload(peer: Peer) -> int:
            try:
                resp = await self.user.request(
                    peer,
                    {"type": "UNLOAD", "job_id": self.job.job_id},
                    timeout=timeout,
                )
            except (ConnectionError, asyncio.TimeoutError, OSError):
                return 0
            return (
                int(resp.get("stages", 0))
                if resp.get("type") == "UNLOADED"
                else 0
            )

        # concurrent: teardown latency is one timeout, not one per dead
        # peer (a 4-worker job with 3 unreachable peers must not stall
        # its caller 30 s)
        freed = sum(await asyncio.gather(*(
            unload(p)
            for p in {st.peer.node_id: st.peer for st in self.stages}.values()
        )))
        await self.complete_onchain()
        if self.validator is not None:
            # tell the validator the job is over (best-effort) so it can
            # clear any placement-degraded readiness condition — a job
            # whose dead worker was never replaced because the user
            # finished instead must not pin the validator at 503
            try:
                await self.user.request(
                    self.validator,
                    {"type": "JOB_UPDATE", "job_id": self.job.job_id,
                     "done": True},
                    timeout=timeout,
                )
            except (ConnectionError, asyncio.TimeoutError, OSError):
                pass
        if self._step_dog is not None:
            # remove, not disarm: a long-lived master places many jobs
            # and must not accumulate one dead dog per job
            self.user.health.remove_watchdog(self._step_dog.name)
            self._step_dog = None
        self.user.health.clear_conditions(f"job:{self.job.job_id[:16]}")
        self.user._unregister_job(self)
        self.user.flight.record(
            "job_shutdown", job_id=self.job.job_id[:16], stages_freed=freed,
        )
        return freed

    async def train_step(
        self,
        batch_x: np.ndarray,
        loss_grad_fn: Callable[[np.ndarray, int], tuple[float, np.ndarray]],
    ) -> float:
        """One pipelined step: split into micro-batches, forward all,
        loss+grad at the master, backward all, then optimizer step on
        every stage.

        Elastic: a stage failure mid-step aborts the partial step on the
        surviving stages, recovers the dead stage (validator re-recruits,
        last-known params re-shipped), and retries.
        """
        if self._step_dog is not None and not self._step_dog.armed:
            self._step_dog.arm()  # first step starts the deadline clock
        for attempt in range(self.max_step_retries + 1):
            try:
                loss = await self._try_train_step(batch_x, loss_grad_fn)
            except (ConnectionError, asyncio.TimeoutError, RuntimeError) as e:
                if attempt == self.max_step_retries or self.validator is None:
                    raise
                self.user.flight.record(
                    "step_retry", "warn", job_id=self.job.job_id[:16],
                    step=self.step, attempt=attempt, error=str(e)[:200],
                )
                acked = await self._abort_step()
                await self.recover_dead_stages(
                    aborted=acked,
                    # STEP_END may have landed on a subset of stages; the
                    # only consistent restart point is the shared snapshot
                    rollback_all=isinstance(e, StepEndFailure),
                )
                continue
            if self._step_dog is not None:
                self._step_dog.kick()
            return loss
        raise AssertionError("unreachable")

    async def forward(self, batch_x: np.ndarray) -> np.ndarray:
        """Inference-only pipelined pass: micro-batches stream through
        the stage chain(s) and the concatenated final activations return
        — no gradient state is stashed on any worker (the reference gets
        this for free from nn.Module.forward; the socket path needs the
        explicit no-stash contract). Respects train()/eval() mode, so
        eval-mode inference is deterministic and MC-dropout inference is
        a train() away.

        Elastic, with failure handling scoped to what inference actually
        disturbs: a TRANSIENT failure just retries under a fresh
        inference identity (no worker state to clean — nothing was
        stashed, and stragglers can't collide with the new identity);
        only a genuinely DEAD stage triggers the full train-style
        recovery (fence bump + re-recruit + snapshot re-ship), which —
        as with a failed train_step — rolls every stage back to the last
        recovery snapshot. That rollback is loudly logged: call
        ``checkpoint_stages()`` first if you must not lose progress
        since the last refresh."""
        for attempt in range(self.max_step_retries + 1):
            # fresh identity per call AND per retry (see _infer_seq note)
            seq = self._infer_seq
            self._infer_seq += 1
            m = self.job.micro_batches
            micros = _split(batch_x, m)
            tasks = [
                asyncio.ensure_future(
                    self._micro_forward(seq, i, x, infer=True)
                )
                for i, x in enumerate(micros)
            ]
            try:
                outs = await asyncio.gather(*tasks)
                return torch.cat([torch.as_tensor(o) for o in outs], dim=0)
            except BaseException as e:
                # cancel + drain siblings on ANY exit — including the
                # caller's own cancellation (wait_for timeout): an
                # aborted attempt's micros must not keep driving the
                # chain (mirrors _try_train_step)
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                if not isinstance(
                    e, (ConnectionError, asyncio.TimeoutError, RuntimeError)
                ):
                    raise
                if attempt == self.max_step_retries or self.validator is None:
                    raise
                alive = await asyncio.gather(
                    *(self._live_stage(s) for s in self.stages)
                )
                if all(alive):
                    # transient (slow hop, dropped frame): plain retry.
                    # No ABORT_STEP — at the current fence it would wipe
                    # a concurrent train step's gradient state without
                    # invalidating its in-flight messages, and
                    # inference left nothing to clean.
                    continue
                self.user.log.warning(
                    "forward(): dead stage detected — recovering; ALL "
                    "stages roll back to the last recovery snapshot "
                    "(training progress since then is discarded)"
                )
                acked = await self._abort_step()  # bump fence first
                await self.recover_dead_stages(aborted=acked)
        raise AssertionError("unreachable")

    async def _try_train_step(self, batch_x, loss_grad_fn) -> float:
        # root span of the step's trace: every micro's stage RPC — and,
        # through the _trace envelope, every worker-side span it causes —
        # stitches under this one trace_id
        with self.user.tracer.span(
            "user.train_step",
            {"step": self.step, "micros": self.job.micro_batches},
        ):
            return await self._try_train_step_traced(batch_x, loss_grad_fn)

    async def _try_train_step_traced(self, batch_x, loss_grad_fn) -> float:
        t_start = time.perf_counter()
        m = self.job.micro_batches
        micros = _split(batch_x, m)
        step = self.step

        async def one(mi: int, x):
            out = await self._micro_forward(step, mi, x)
            loss, g = loss_grad_fn(out, mi)
            await self._micro_backward(step, mi, g)
            return loss

        tasks = [asyncio.ensure_future(one(i, x)) for i, x in enumerate(micros)]
        try:
            losses = await asyncio.gather(*tasks)
        except BaseException:
            # cancel + drain siblings so no straggler FORWARD/BACKWARD from
            # this aborted attempt lands after the stages reset for a retry
            # (a late landing would double-count a micro's
            # gradient in the retried step)
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        async def end(st: RemoteStage):
            # carries the logical step so a retried STEP_END (slow worker,
            # master timeout) is idempotent on the worker side, and the
            # reply type is checked so an ERROR is not treated as success
            #
            resp = await self.user.request(
                st.peer,
                {
                    "type": "STEP_END",
                    "job_id": self.job.job_id,
                    "stage": st.index,
                    "step": step,
                    "fence": self._fence,
                },
                timeout=30.0,
            )
            if resp.get("type") != "STEPPED":
                raise RuntimeError(f"stage {st.index} step_end failed: {resp}")

        try:
            await asyncio.gather(*(end(st) for st in self.stages))
        except (ConnectionError, asyncio.TimeoutError, RuntimeError):
            # STEP_END is idempotent per (step, fence), so a transient
            # timeout/blip is resolved by simply re-sending — stages that
            # already applied skip, the rest apply their intact accum
            # (escalating straight to a snapshot rollback
            # here silently discarded all progress since the last
            # checkpoint). Only a SECOND failure escalates.
            await asyncio.sleep(0.5)
            try:
                await asyncio.gather(*(end(st) for st in self.stages))
            except (ConnectionError, asyncio.TimeoutError, RuntimeError) as e:
                raise StepEndFailure(str(e)) from e
        self.step += 1
        loss = float(np.mean(losses))
        self.user.metrics.observe("loss", loss)
        self.user.metrics.observe("step_s", time.perf_counter() - t_start)
        self.user.metrics.incr("train_steps")
        if (
            self.checkpoint_every_steps
            and self.step % self.checkpoint_every_steps == 0
        ):
            # keep the recovery snapshot fresh so a rollback costs at most
            # checkpoint_every_steps of progress
            await self.checkpoint_stages()
        return loss

    # ------------------------------------------------------- fault recovery
    async def _abort_step(self, timeout: float = 5.0) -> set[tuple[int, int]]:
        """Clear partial grads/activations on every still-reachable stage.
        Returns the (stage, replica) slots that ACKED the abort — a slot
        that did not ack still holds the old fence and possibly partial
        grads, and must be reset or recovered before a retry."""

        self._fence += 1
        acked: set[tuple[int, int]] = set()

        async def abort(st: RemoteStage):
            try:
                resp = await self.user.request(
                    st.peer,
                    {
                        "type": "ABORT_STEP",
                        "job_id": self.job.job_id,
                        "stage": st.index,
                        "fence": self._fence,
                    },
                    timeout=timeout,
                )
                if resp.get("type") == "STEP_ABORTED":
                    acked.add((st.index, st.replica))
            except (ConnectionError, asyncio.TimeoutError):
                pass  # dead or hung stage: resolved by recover_dead_stages

        await asyncio.gather(*(abort(st) for st in self.stages))
        return acked

    async def _live_stage(self, st: RemoteStage) -> bool:
        if st.peer.node_id not in self.user.peers:
            return False
        try:
            await asyncio.wait_for(self.user.ping(st.peer), timeout=2.0)
            return True
        except (ConnectionError, asyncio.TimeoutError, OSError):
            return False

    async def recover_dead_stages(
        self, aborted: set[int] | None = None, rollback_all: bool = False
    ) -> list[int]:
        """Probe all stages; re-place every dead one via the validator and
        re-ship its module spec + last-known params. Surviving stages are
        rolled back to the SAME cached snapshot — otherwise the pipeline
        would compose params from different training steps (a dead stage
        restarts from the last checkpoint while survivors are N steps
        ahead, silently training a mixed-version model). A stage that is
        alive but did NOT ack the abort (slow/hung) still holds a stale
        fence and partial grads: retry the abort once, and failing that
        treat it as dead. Returns recovered (stage, replica) slots."""
        alive = await asyncio.gather(*(self._live_stage(s) for s in self.stages))
        dead = {
            (st.index, st.replica)
            for st, ok in zip(self.stages, alive)
            if not ok
        }
        if aborted is not None:

            async def retry_abort(st: RemoteStage):
                try:
                    resp = await self.user.request(
                        st.peer,
                        {
                            "type": "ABORT_STEP",
                            "job_id": self.job.job_id,
                            "stage": st.index,
                            "fence": self._fence,
                        },
                        timeout=10.0,
                    )
                    if resp.get("type") != "STEP_ABORTED":
                        dead.add((st.index, st.replica))
                except (ConnectionError, asyncio.TimeoutError):
                    dead.add((st.index, st.replica))

            await asyncio.gather(
                *(
                    retry_abort(st)
                    for st, ok in zip(list(self.stages), alive)
                    if ok
                    and (st.index, st.replica) not in aborted
                    and (st.index, st.replica) not in dead
                )
            )
        recovered: list[tuple[int, int]] = []
        for st in list(self.stages):
            if (st.index, st.replica) in dead:
                # replace the slot but DON'T ship yet: with several dead
                # siblings, shipping now would bake a still-dead node into
                # the first recovery's replica peer list
                await self.recover_stage(
                    st.index, replica=st.replica, dead_id=st.peer.node_id,
                    ship=False,
                )
                recovered.append((st.index, st.replica))
        if recovered or rollback_all:
            # all slots now point at live nodes: ship the recovered slots
            # their modules + cached params, and roll survivors back to
            # the same snapshot — the re-ship also refreshes everyone's
            # replica peer lists (a recovered slot means a new node_id in
            # every sibling's GRAD_SHARE set)
            await asyncio.gather(*(self._ship_stage(st) for st in self.stages))
        return recovered

    async def _failover_validator(self) -> None:
        """The seed validator is unreachable: reattach to a replica
        validator named at placement time (they hold the pushed job
        record, so REPLACE_WORKER/JOB_INFO keep working — the liveness
        the reference's stubbed distribute_job was meant to provide)."""
        last: Exception | None = None
        for info in list(self.backup_validators):
            try:
                peer = await self.user.connect_candidates(
                    info["host"], int(info["port"]),
                    tuple(info.get("alt_hosts", ()) or ()),
                    expect_id=info["node_id"],
                )
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                last = e
                continue
            self.user.log.warning(
                "validator failover: %s -> %s",
                self.validator.node_id[:8] if self.validator else "?",
                peer.node_id[:8],
            )
            self.user.flight.record(
                "validator_failover", "warn",
                job_id=self.job.job_id[:16],
                dead=(self.validator.node_id[:16] if self.validator else "?"),
                new=peer.node_id[:16],
            )
            self.validator = peer
            return
        raise RuntimeError(f"no replica validator reachable ({last})")

    async def recover_stage(
        self, index: int, replica: int = 0, dead_id: str = "", ship: bool = True
    ) -> RemoteStage:
        if self.validator is None:
            raise RuntimeError("no validator attached; cannot re-recruit")
        req = {
            "type": "REPLACE_WORKER",
            "job_id": self.job.job_id,
            "stage": index,
            "replica": replica,
            "exclude": [dead_id] if dead_id else [],
        }
        try:
            resp = await self.user.request(self.validator, req, timeout=30.0)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            # seed validator gone mid-job: fail over to a replica
            # validator and retry the SAME re-recruitment there
            await self._failover_validator()
            resp = await self.user.request(self.validator, req, timeout=30.0)
        if resp.get("type") != "WORKER_REPLACED":
            raise RuntimeError(f"stage {index} recovery failed: {resp.get('error')}")
        if resp.get("validators"):
            # the responding validator (possibly a failover replica) names
            # ITS replica set — fresher than whatever we held before
            self.backup_validators = [
                v for v in resp["validators"]
                if v.get("node_id") != self.validator.node_id
            ]
        placement = resp["worker"]
        peer = self.user.peers.get(placement["node_id"])
        if peer is None:
            peer = await self.user.connect_candidates(
                placement["host"], int(placement["port"]),
                placement.get("alt_hosts", ()),
                expect_id=placement["node_id"],
            )
        st = RemoteStage(
            index=index, peer=peer, info=placement,
            replica=int(placement.get("replica", replica)),
        )
        # replace ONLY the matching (stage, replica) slot, not every
        # replica slot sharing the index
        self.stages = [
            st if (s.index, s.replica) == (index, replica) else s
            for s in self.stages
        ]
        self.stages.sort(key=lambda s: (s.replica, s.index))
        self.user.flight.record(
            "stage_recovered", job_id=self.job.job_id[:16], stage=index,
            replica=replica, dead=dead_id[:16], new=placement["node_id"][:16],
        )
        # the slot points at a live worker again: readiness restored
        self.user.health.clear_condition(
            f"job:{self.job.job_id[:16]}:stage{index}.{replica}"
        )
        if ship:
            await self._ship_stage(st)
        return st

    def _chain_placements(self, replica: int) -> list[dict]:
        """Wire info of replica ``replica``'s full stage chain, in stage
        order — shipped to every member for relay routing/authorization."""
        return [
            placement_wire(s)
            for s in sorted(
                (s for s in self.stages if s.replica == replica),
                key=lambda s: s.index,
            )
        ]

    def _replica_placements(self, index: int) -> list[dict]:
        """Wire info of every live slot of stage ``index`` (the worker
        filters itself out and uses the rest as its GRAD_SHARE set)."""
        return [
            placement_wire(s) for s in self.stages if s.index == index
        ]

    async def _ship_stage(self, st: RemoteStage) -> None:
        """Ship spec + cached params for one stage slot (fresh placement
        or same-snapshot rollback of a survivor)."""
        index = st.index
        params = self._stage_params.get(index)
        if params is None:
            raise RuntimeError(f"no cached params for stage {index}")
        ack = await self.user.ship_spec(
            st.peer,
            {
                "job_id": self.job.job_id,
                "stage": index,
                "replica": st.replica,
                "replicas": self._replica_placements(index),
                "chain": self._chain_placements(st.replica),
                "module_config": self.job.stages[index].module_config,
                "train": self.job.train,
            },
            params,
        )
        if ack.get("type") != "LOADED":
            raise RuntimeError(f"stage {index} reload failed: {ack}")

    async def checkpoint_stages(self) -> dict[int, Any]:
        """Refresh the last-known params cache from every stage (the state
        a recovery re-ships; pair with runtime.checkpoint for durability).
        The cache stays in WIRE basis (folded, if obfuscated): it is what
        gets re-shipped verbatim on recovery."""
        chain0 = self.chains[0]
        parts = await self.fetch_params(deobfuscate=False)
        for st, p in zip(chain0, parts):
            self._stage_params[st.index] = p
        if self._ckpt is not None:
            # snapshot ON the loop: the param trees are replaced
            # wholesale on refresh (never mutated in place), so a
            # shallow dict copy pins a consistent (stages, step) pair
            # for the worker-thread save
            await asyncio.to_thread(
                self._persist_checkpoint, dict(self._stage_params), self.step
            )
        return self._stage_params

    async def fetch_params(self, deobfuscate: bool = True) -> list[dict]:
        """Gather current params, one tree per stage (reference:
        parameters(distributed=True), distributed.py:236-276). Replica 0's
        chain is authoritative — the DP grad sync keeps replicas bitwise
        identical, so one fetch per stage suffices. When the job runs
        obfuscated, worker params live in the rotated basis;
        ``deobfuscate`` maps them back to the true basis (exact — the
        rotation is orthogonal)."""
        out = []
        for st in self.chains[0]:
            from tensorlink_tpu_torch.p2p.serialization import tree_unflatten_arrays

            want_stream = (
                self.job.stages[st.index].param_bytes > STREAM_THRESHOLD_BYTES
            )
            fut = None
            if want_stream:
                fut = asyncio.get_running_loop().create_future()
                self.user._param_streams[(self.job.job_id, st.index)] = (
                    st.peer.node_id,
                    fut,
                )
            try:
                resp = await self.user.request(
                    st.peer,
                    {
                        "type": "PARAMS_REQUEST",
                        "job_id": self.job.job_id,
                        "stage": st.index,
                        "stream": want_stream,
                    },
                    timeout=60.0,
                )
                if resp.get("streaming"):
                    flat = await asyncio.wait_for(
                        fut, self.user.STREAM_TIMEOUT_S
                    )
                else:
                    flat = unpack_arrays(resp["weights"])
            finally:
                self.user._param_streams.pop(
                    (self.job.job_id, st.index), None
                )
            p = tree_unflatten_arrays(flat)
            if deobfuscate and self.plan is not None:
                p = self.plan.unfold_stage(
                    st.index, self.stage_modules[st.index], p
                )
            out.append(p)
        return out

    async def report(self, validator: Peer, loss: float) -> None:
        await self.user.request(
            validator,
            {
                "type": "JOB_UPDATE",
                "job_id": self.job.job_id,
                "loss": loss,
                "step": self.step,
            },
        )


# payloads above this ride the chunked stream path (bounded memory per
# hop) instead of one message; tests shrink it to force streaming
STREAM_THRESHOLD_BYTES = 32 << 20


class UserNode(Node):
    def __init__(self, cfg: NodeConfig | None = None, **kw):
        cfg = cfg or NodeConfig(role="user")
        super().__init__(cfg, **kw)
        # (job_id, stage) -> (expected worker node_id, future) for the
        # "parameters" stream reply. The expected-peer check matters:
        # job_id and stage are known to every placement participant, so
        # without it any connected peer could inject forged weights into
        # a pending fetch (the old request/response path
        # was guarded by its unguessable correlation uuid).
        self._param_streams: dict[tuple, tuple[str, asyncio.Future]] = {}
        self.register_stream_kind("parameters", self._stream_parameters)
        self.on("PARAMS_STREAM_FAILED", self._h_params_stream_failed)
        # (job_id, step, micro, kind, fence) -> (exit sender, chain member
        # ids, future): results of worker-to-worker relay chains land here.
        # The peer checks keep a handshaken stranger from injecting
        # activations/gradients (exit-only) or spurious errors (chain
        # members only) into a pending step.
        self._relay_waiters: dict[tuple, tuple[str, set, asyncio.Future]] = {}
        self.on("RELAY_RESULT", self._h_relay_result)
        self.on("RELAY_ERROR", self._h_relay_result)
        # live DistributedJob handles by job_id: on_peer_lost consults
        # them so a dead stage worker degrades /healthz immediately
        # (readiness condition + flight event), not only when the next
        # train_step happens to fail
        self._jobs: dict[str, DistributedJob] = {}
        # user-side receipt observations (what this client ACTUALLY
        # received per remote request) queued for the validator's next
        # heartbeat PONG — the auditor cross-checks them against the
        # worker's signed claim, so a worker inflating emitted_tokens
        # gets a token_mismatch even with a valid signature
        self._receipt_obs: deque[dict] = deque(maxlen=1024)

    def record_receipt_obs(
        self, worker: str, rid: int, tenant: str, tokens: int
    ) -> None:
        self._receipt_obs.append({
            "worker": str(worker), "rid": int(rid),
            "tenant": str(tenant)[:128], "tokens": int(tokens),
        })

    def pending_receipt_obs(self, limit: int = 256) -> list[dict]:
        """Drain queued observations for a validator PONG (read by
        ``Node._h_ping`` via duck-typed hook, same contract as the
        worker's ``pending_receipts``)."""
        out: list[dict] = []
        while self._receipt_obs and len(out) < limit:
            out.append(self._receipt_obs.popleft())
        return out

    def _register_job(self, job: "DistributedJob") -> None:
        self._jobs[job.job.job_id] = job

    def _unregister_job(self, job: "DistributedJob") -> None:
        self._jobs.pop(job.job.job_id, None)

    def serving_engine(self, engine, *, paged: bool = False, **kw):
        """The user role's LOCAL inference path: a continuous-batching
        scheduler (parallel/serving.py) wired into this node's
        observability — per-request TTFT/TPOT land in ``self.metrics``
        (served at ``GET /metrics``, Prometheus included) and
        submit/admit/finish events in the flight recorder (``GET
        /events``). ``paged=True`` serves through the paged KV cache
        (block pool + prefix sharing, parallel/kvpool.py); either way
        the scheduler is attached as ``self.serving`` so ``GET /node``
        exposes its stats (tldiag reads pool pressure from there).
        Drive it from async handlers via ``await asubmit()`` + ``await
        aresult(rid)`` — both hop to a worker thread, so neither
        prefill compiles nor chunk syncs land on the node's event loop;
        the distributed pipelined path stays ``DistributedJob.forward``."""
        return self._build_serving(engine, paged=paged, **kw)

    def remote_serving(
        self, validator: Peer | None = None, *,
        pipeline: bool = False, sid: str | None = None,
    ) -> "RemoteServingClient":
        """The DISTRIBUTED serving front end: the same
        submit()/result() surface as a local engine, but each request's
        prefill and decode legs are placed across the mesh by a
        validator's fleet-roofline table and the KV blocks cross the
        wire between them. Falls back to colocated serving when the
        fleet cannot split (or a leg dies mid-request). ``validator``
        defaults to the first connected validator peer.

        With ``pipeline=True`` the client targets a PIPELINE-sharded
        deployment instead: the validator is asked (``SERVE_PIPELINE_PLAN``
        with ``stage=0``) which worker runs the head stage of the
        pipeline ``sid`` (or any pipeline when ``sid`` is None), and
        requests are submitted there — the head's coordinator streams
        activations across the stages and owns mid-stream failover, so
        from here the surface is exactly the colocated one."""
        if validator is None:
            validator = next(
                (p for p in self.peers.values() if p.role == "validator"),
                None,
            )
            if validator is None:
                raise ValueError(
                    "remote_serving needs a connected validator peer"
                )
        return RemoteServingClient(
            self, validator, pipeline=pipeline, pipeline_sid=sid
        )

    def on_peer_lost(self, peer: Peer) -> None:
        for dj in list(self._jobs.values()):
            jid = dj.job.job_id[:16]
            for st in dj.stages:
                if st.peer.node_id != peer.node_id:
                    continue
                self.flight.record(
                    "stage_peer_lost", "error", job_id=jid,
                    stage=st.index, replica=st.replica,
                    worker=peer.node_id[:16],
                )
                self.health.set_condition(
                    f"job:{jid}:stage{st.index}.{st.replica}",
                    f"stage {st.index} replica {st.replica} worker "
                    f"{peer.node_id[:8]} lost",
                )

    # ------------------------------------------------- relay result intake
    def relay_waiter(self, key: tuple, expected: str, members: set) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._relay_waiters[key] = (expected, set(members), fut)
        return fut

    def drop_relay_waiter(self, key: tuple) -> None:
        self._relay_waiters.pop(key, None)

    @wire_guard
    async def _h_relay_result(self, node, peer, msg) -> None:
        key = (
            str(msg.get("job_id")), int(msg.get("step", -1)),
            int(msg.get("micro", -1)), str(msg.get("kind", "act")),
            int(msg.get("fence", 0)),
        )
        entry = self._relay_waiters.get(key)
        if entry is None:
            return  # stale straggler from an aborted/timed-out attempt
        expected, members, fut = entry
        is_error = msg.get("type") == "RELAY_ERROR"
        allowed = members if is_error else {expected}
        if peer.node_id not in allowed:
            peer.ghosts += 1
            self._penalize(peer)
            return
        if fut.done():
            return
        if is_error:
            fut.set_exception(RuntimeError(
                f"relay failed: {msg.get('error', 'unknown')}"
            ))
        elif "data" not in msg:
            # fail the waiter rather than KeyError into wire_guard: the
            # caller would otherwise ride out the full relay timeout
            fut.set_exception(RuntimeError("relay result missing data"))
        else:
            fut.set_result(msg["data"])

    @wire_guard
    async def _h_params_stream_failed(self, node, peer, msg) -> None:
        """Worker-side stream failure: fail the waiting fetch immediately
        instead of riding out the stream timeout."""
        key = (str(msg.get("job_id")), int(msg.get("stage", -1)))
        entry = self._param_streams.get(key)
        if entry is None or entry[0] != peer.node_id:
            peer.ghosts += 1
            self._penalize(peer)
            return None
        self._param_streams.pop(key, None)
        fut = entry[1]
        if not fut.done():
            fut.set_exception(
                RuntimeError(f"params stream failed: {msg.get('error')}")
            )
        return None

    async def _stream_parameters(self, peer, meta, manifest):
        """Receives a worker's streamed PARAMETERS reply (flat leaves)."""
        key = (str(meta["job_id"]), int(meta["stage"]))
        entry = self._param_streams.get(key)
        if entry is None or entry[0] != peer.node_id:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "unsolicited parameters stream"}
        leaves: dict[str, Any] = {}

        def sink(name, arr):
            leaves[name] = arr

        async def finish():
            e = self._param_streams.pop(key, None)
            if e is not None and not e[1].done():
                e[1].set_result(leaves)
            return {"type": "OK"}

        return sink, finish

    async def ship_spec(self, peer: Peer, meta: dict, params) -> dict:
        """MODULE_SPEC to one worker: single message below
        STREAM_THRESHOLD_BYTES, chunked stream above (a Llama-8B stage is
        ~16 GB of weights)."""
        flat = await asyncio.to_thread(
            lambda: tree_flatten_arrays(_host_tree(nested_params(params)))
        )
        total = sum(int(a.nbytes) for a in flat.values())
        if total > STREAM_THRESHOLD_BYTES:
            return await self.send_stream(
                peer, "module_spec", meta, flat, timeout=self.STREAM_TIMEOUT_S
            )
        blob = await asyncio.to_thread(pack_arrays, flat)
        return await self.request(
            peer, {**meta, "type": "MODULE_SPEC", "weights": blob}, timeout=60.0
        )

    async def _place_and_ship(
        self, job: JobRecord, resp: dict, params_for_stage
    ) -> list[RemoteStage]:
        """Shared by request_job and resume_job_from_checkpoint: connect
        every placement in the ACCEPT_JOB response, ship
        each stage's spec + weights (``params_for_stage(index)``) to all
        of its replica slots concurrently, await LOADED acks."""
        remote: list[RemoteStage] = []
        for placement in resp["workers"]:
            nid = placement["node_id"]
            peer = self.peers.get(nid)
            if peer is None:
                peer = await self.connect_candidates(
                    placement["host"], int(placement["port"]),
                    placement.get("alt_hosts", ()),
                    expect_id=nid,
                )
            remote.append(
                RemoteStage(
                    index=int(placement["stage"]), peer=peer, info=placement,
                    replica=int(placement.get("replica", 0)),
                )
            )
        remote.sort(key=lambda s: (s.replica, s.index))
        by_stage: dict[int, list[dict]] = {}
        by_replica: dict[int, list[dict]] = {}
        for st in remote:
            by_stage.setdefault(st.index, []).append(placement_wire(st))
            by_replica.setdefault(st.replica, []).append(placement_wire(st))
        for chain in by_replica.values():
            chain.sort(key=lambda p: p["stage"])

        async def ship(st: RemoteStage) -> None:
            ack = await self.ship_spec(
                st.peer,
                {
                    "job_id": job.job_id,
                    "stage": st.index,
                    "replica": st.replica,
                    "replicas": by_stage[st.index],
                    "chain": by_replica[st.replica],
                    "module_config": job.stages[st.index].module_config,
                    "train": job.train,
                },
                params_for_stage(st.index),
            )
            if ack.get("type") != "LOADED":
                raise RuntimeError(f"stage {st.index} failed to load: {ack}")

        await asyncio.gather(*(ship(st) for st in remote))
        return remote

    async def request_job(
        self,
        model: Sequential,
        params: dict,
        validator: Peer,
        *,
        max_stage_bytes: float = 4e9,  # reference default max_module_size
        micro_batches: int = 1,
        dp_factor: int = 1,
        train: dict | None = None,
        obfuscate: bool = False,
        obfuscate_key: int | None = None,
        relay: bool | None = None,
        example=None,  # model-input ShapeDtypeStruct/array: enables
        # partition_tree's branch splitting (Parallel containers)
        chain_registry=None,  # Registry with a job ledger: record the
        # request on-chain before placement (reference intent,
        # src/roles/user.py:50-64,171-199; chain/registry.py docstring)
        chain_payment_milli: int = 0,
    ) -> DistributedJob:
        """Partition -> JOB_REQ -> connect workers -> ship specs+weights ->
        LOADED acks -> DistributedJob (reference call stack §3.1).

        With ``chain_registry=``, the job request is recorded on-chain
        BEFORE placement and the ledger id lands in
        ``DistributedJob.chain_job_id``. The id comes from the
        JobRequested event in the transaction receipt; against a legacy
        contract without that event the registry falls back to re-reading
        ``jobCount()``, which is only correct while a single user submits
        at a time — run concurrent submitters only against contracts that
        emit JobRequested.

        ``obfuscate=True`` folds secret orthogonal rotations into each
        stage's BOUNDARY Dense layers (roles/privacy.py): the activations
        crossing the wire and the first/last weight matrices of every
        stage are basis-hidden from the worker. Interior layers of a
        multi-layer stage ship as-is, rotation is not cryptographic
        secrecy (norms/spectra are preserved), and the final stage's
        output is clear unless the plan obfuscates it — see privacy.py's
        stated limits. Exact training equivalence holds for sgd (rotation
        commutes with the update); adaptive elementwise optimizers (adam,
        adamw) train in the rotated basis with slightly different
        dynamics — a warning is logged."""
        params = nested_params(params)
        if relay and obfuscate:
            # validate BEFORE recruitment: failing in DistributedJob after
            # the specs shipped would leave loaded stages + reservations
            # orphaned on every worker
            raise ValueError("relay transfer is incompatible with obfuscation")
        if obfuscate and (train or {}).get("train_only") == "lora":
            # the rotation plan folds only w/b (privacy.py): adapters
            # would train in the rotated basis while lora_merge later
            # adds them in the clear one — silently wrong weights
            raise ValueError("obfuscation is incompatible with train_only='lora'")
        from tensorlink_tpu_torch.nn.module import Parallel

        def has_parallel(m) -> bool:
            return isinstance(m, Parallel) or any(
                has_parallel(c) for c in m.children()
            )

        if example is not None or has_parallel(model):
            # branching trees linearize via carry packing (partition_tree)
            stage_parts = partition_tree(
                model, params, max_stage_bytes, example=example
            )
        else:
            stage_parts = partition_sequential(model, params, max_stage_bytes)
        chain_job_id = None
        if chain_registry is not None:
            # record BEFORE placement (the reference's requestJob intent
            # preceded recruitment); blocking RPC off the event loop
            chain_job_id = await asyncio.to_thread(
                chain_registry.request_job_onchain,
                self.node_id, int(tree_bytes(params)),
                int(chain_payment_milli),
            )
        plan = None
        key = None
        if obfuscate:
            from tensorlink_tpu_torch.roles.privacy import ObfuscationPlan

            opt_name = (train or {}).get("optimizer", "adam")
            if opt_name not in ("sgd",):
                self.log.warning(
                    "obfuscate=True with optimizer %r: elementwise adaptive "
                    "statistics are not rotation-invariant, so training "
                    "dynamics differ slightly from the unobfuscated run "
                    "(sgd is exactly equivalent)",
                    opt_name,
                )

            key = (
                obfuscate_key
                if obfuscate_key is not None
                else int(np.random.SeedSequence().entropy % (2**63))
            )

            def build_and_fold():
                # off the event loop: a starved loop makes co-hosted
                # peers miss handshake/heartbeat deadlines
                plan = ObfuscationPlan.build(key, stage_parts)
                return plan, [
                    (seq, plan.fold_stage(i, seq, p))
                    for i, (seq, p) in enumerate(stage_parts)
                ]

            plan, stage_parts = await asyncio.to_thread(build_and_fold)
        specs = [
            StageSpec(
                index=i,
                module_config=mod.config(),
                param_bytes=tree_bytes(p),
            )
            for i, (mod, p) in enumerate(stage_parts)
        ]
        job = JobRecord(
            author=self.node_id,
            stages=specs,
            dp_factor=dp_factor,
            micro_batches=micro_batches,
            train=train or {},
            capacity_bytes=sum(s.param_bytes for s in specs),
            seed_validators=[validator.node_id],
        )
        job_msg = {"type": "JOB_REQ", "job": job.to_wire()}
        try:
            resp = await self.request(validator, job_msg, timeout=30.0)
        except ConnectionError:
            # the validator connection can die between connect and JOB_REQ
            # (e.g. our own process blocked the loop through the accept-side
            # handshake window, or a transient network drop). The reference
            # re-sends JOB-REQ after a timeout (user.py:309-314); here we
            # redial the same validator once and retry.
            self.log.warning("validator connection lost; redialing for JOB_REQ")
            validator = await self.connect_candidates(
                validator.info.host, validator.info.port,
                validator.info.alt_hosts, expect_id=validator.node_id,
            )
            resp = await self.request(validator, job_msg, timeout=30.0)
        if resp.get("type") != "ACCEPT_JOB":
            raise RuntimeError(f"job declined: {resp.get('reason')}")

        # ship specs + weights to EVERY slot concurrently — stage i's
        # params go to each of its dp_factor replicas; await LOADED (the
        # ack is the typed response, and setup latency is the max
        # transfer, not the sum)
        remote = await self._place_and_ship(
            job, resp, lambda i: stage_parts[i][1]
        )
        dj = DistributedJob(
            self, job, remote, validator=validator, plan=plan,
            stage_modules=[seq for seq, _ in stage_parts], relay=relay,
        )
        dj.chain_registry = chain_registry
        dj.chain_job_id = chain_job_id
        dj.backup_validators = list(resp.get("validators", []))
        # mirror the replica validators' IDS into our record (addresses
        # live in backup_validators; after a checkpoint resume the fresh
        # ACCEPT_JOB supplies current addresses again)
        job.seed_validators = [validator.node_id] + [
            v["node_id"] for v in dj.backup_validators
        ]
        dj._stage_params = {i: p for i, (_, p) in enumerate(stage_parts)}
        # the rotation key is the ONLY way back to the true basis: expose
        # it so the caller can persist it for reattach_job after a master
        # restart (a generated key used to vanish with
        # the process, stranding the weights in the rotated basis)
        dj.obfuscate_key = key
        if obfuscate and obfuscate_key is None:
            self.log.warning(
                "obfuscate=True generated a random rotation key; persist "
                "job.obfuscate_key — without it the trained weights cannot "
                "be mapped back to the true basis after a master restart"
            )
        return dj

    async def resume_job_from_checkpoint(
        self,
        directory: str,
        validator: Peer,
    ) -> DistributedJob:
        """Resume a job from a durable checkpoint after losing BOTH the
        master and the validator (reattach_job needs the validator's live
        record; this path needs only the disk state written by
        DistributedJob.attach_durable_checkpointing).

        A NEW job record is minted (fresh author/id — surviving workers
        hold the dead master's stages under the old owner and would
        reject a stranger), recruitment runs again, and the checkpointed
        stage params ship to the new placement; training resumes at the
        checkpointed master step."""
        from tensorlink_tpu_torch.runtime.checkpoint import CheckpointManager

        mgr = CheckpointManager(directory, async_save=False)
        meta = mgr.metadata()
        if meta is None:
            raise FileNotFoundError(f"no checkpoint metadata under {directory}")
        state = mgr.restore()
        old = JobRecord.from_wire(meta["job"])
        stage_params = {
            int(i): p for i, p in state["stages"].items()
        }
        key = None
        if state.get("obfuscate_key") is not None:
            key = int(torch.as_tensor(state["obfuscate_key"]).reshape(-1)[0])

        job = JobRecord(
            author=self.node_id,
            stages=old.stages,
            dp_factor=old.dp_factor,
            micro_batches=old.micro_batches,
            train=old.train,
            capacity_bytes=old.capacity_bytes,
            seed_validators=[validator.node_id],
        )
        resp = await self.request(
            validator, {"type": "JOB_REQ", "job": job.to_wire()}, timeout=30.0
        )
        if resp.get("type") != "ACCEPT_JOB":
            raise RuntimeError(f"resume placement declined: {resp.get('reason')}")
        remote = await self._place_and_ship(
            job, resp, lambda i: stage_params[i]
        )
        from tensorlink_tpu_torch.nn.module import module_from_config

        stage_modules = [
            module_from_config(s.module_config, device=torch.device("meta"))
            for s in job.stages
        ]
        plan = None
        if meta.get("obfuscated"):
            if key is None:
                raise RuntimeError(
                    "checkpoint says the job was obfuscated but carries no "
                    "rotation key"
                )
            from tensorlink_tpu_torch.roles.privacy import ObfuscationPlan

            # the plan is a deterministic function of key + module shapes
            # (same rebuild as reattach_job); params stay in wire basis
            plan = ObfuscationPlan.build(
                key, [(seq, {}) for seq in stage_modules]
            )
        dj = DistributedJob(
            self, job, remote, validator=validator, plan=plan,
            stage_modules=stage_modules,
        )
        # the resumed placement's ACCEPT_JOB names the replica validators
        # holding the new record — without this, failover would be dead
        # in exactly the post-recovery scenario it exists for
        dj.backup_validators = list(resp.get("validators", []))
        job.seed_validators = [validator.node_id] + [
            v["node_id"] for v in dj.backup_validators
        ]
        dj._stage_params = dict(stage_params)
        dj.obfuscate_key = key
        dj.step = int(meta.get("master_step", 0))
        dj.attach_durable_checkpointing(directory)
        return dj

    async def reattach_job(
        self,
        job_id: str,
        validator: Peer,
        *,
        obfuscate_key: int | None = None,
    ) -> DistributedJob:
        """Re-attach to a live job after a master restart (the reference
        leaves this as a TODO, src/roles/user.py:169-171).

        Requires the SAME identity (cfg.key_dir) that created the job:
        workers authorize data-plane ops by the owner node_id. The job
        record comes from the validator/DHT, stage modules are rebuilt
        from their specs, and current params are pulled from the workers
        to seed the recovery snapshot. For an obfuscated job, pass the
        original ``obfuscate_key`` — the rotation plan is a deterministic
        function of (key, stage shapes) and is rebuilt exactly.
        """
        from tensorlink_tpu_torch.nn.module import module_from_config

        resp = await self.request(
            validator, {"type": "JOB_INFO", "job_id": job_id}, timeout=30.0
        )
        if resp.get("type") != "JOB":
            raise RuntimeError(f"job lookup failed: {resp.get('error')}")
        job = JobRecord.from_wire(resp["job"])
        if job.author != self.node_id:
            raise RuntimeError(
                "reattach requires the job author's identity "
                f"(job author {job.author[:8]}, we are {self.node_id[:8]})"
            )
        if not job.workers:
            raise RuntimeError("job record carries no placements")

        remote: list[RemoteStage] = []
        for placement in job.workers:
            peer = self.peers.get(placement["node_id"])
            if peer is None:
                peer = await self.connect_candidates(
                    placement["host"], int(placement["port"]),
                    placement.get("alt_hosts", ()),
                    expect_id=placement["node_id"],
                )
            remote.append(
                RemoteStage(index=int(placement["stage"]), peer=peer,
                            info=placement,
                            replica=int(placement.get("replica", 0)))
            )
        remote.sort(key=lambda s: (s.replica, s.index))

        stage_modules = [
            module_from_config(s.module_config, device=torch.device("meta"))
            for s in job.stages
        ]
        plan = None
        if obfuscate_key is not None:
            from tensorlink_tpu_torch.roles.privacy import ObfuscationPlan

            plan = ObfuscationPlan.build(
                obfuscate_key, [(seq, {}) for seq in stage_modules]
            )
        dj = DistributedJob(
            self, job, remote, validator=validator, plan=plan,
            stage_modules=stage_modules,
        )
        # JOB_INFO names the responding validator's replica set: the
        # reattached job keeps a live failover list too
        dj.backup_validators = [
            v for v in resp.get("validators", [])
            if v.get("node_id") != validator.node_id
        ]
        dj.obfuscate_key = obfuscate_key
        # 1) abort any partial step the dead master left behind (stale
        # grad accum / stashed activations would corrupt the first
        # resumed update) and learn each runner's current fence epoch —
        # resuming at fence 0 against a runner whose fence advanced
        # would have every data-plane message rejected as stale
        #
        async def abort(st: RemoteStage) -> int:
            r = await self.request(
                st.peer,
                {"type": "ABORT_STEP", "job_id": job.job_id,
                 "stage": st.index, "fence": 0},
                timeout=10.0,
            )
            if r.get("type") != "STEP_ABORTED":
                raise RuntimeError(f"stage {st.index} abort failed: {r}")
            return int(r.get("fence", 0))

        fences = await asyncio.gather(*(abort(st) for st in remote))
        dj._fence = max(fences)

        # 2) seed the recovery snapshot from the live workers (wire
        # basis) and resynchronize the logical step counter: runners
        # guard STEP_END idempotency by last APPLIED master step, so the
        # resumed counter must sit strictly above every stage's
        # (runner.step alone can lag it)
        from tensorlink_tpu_torch.p2p.serialization import tree_unflatten_arrays

        async def fetch(st: RemoteStage) -> tuple[int, int, int]:
            presp = await self.request(
                st.peer,
                {"type": "PARAMS_REQUEST", "job_id": job.job_id,
                 "stage": st.index},
                timeout=60.0,
            )
            if presp.get("type") != "PARAMETERS":
                raise RuntimeError(
                    f"stage {st.index} params fetch failed: {presp}"
                )
            dj._stage_params[st.index] = tree_unflatten_arrays(
                unpack_arrays(presp["weights"])
            )
            return (
                int(presp.get("step", 0)),
                int(presp.get("applied_step", -1)),
                st.index,
            )

        fetched = await asyncio.gather(*(fetch(st) for st in remote))
        state = resp.get("state") or {}
        dj.step = max(
            [int(state.get("step", 0) or 0)]
            + [s for s, _, _ in fetched]
            + [a + 1 for _, a, _ in fetched]
        )
        return dj


class RemoteServingClient:
    """Disaggregated serving stitched behind the engine API.

    ``submit()`` asks the validator for a two-leg placement
    (``SERVE_PLAN`` over the fleet roofline table), runs the prefill
    leg (``SERVE_PREFILL`` — the prefill worker ships the filled KV
    blocks straight to the decode worker over ``KV_BLOCKS``), and
    remembers where the stream now lives; ``result()`` fetches the
    tokens from that worker. Priorities and deadlines flow through
    unchanged, and remote typed rejections (overload with measured
    retry-after, unmeetable deadlines) re-raise as the same exception
    types a local engine raises.

    Failure semantics: a prefill worker that cannot reach the decode
    leg already falls back to colocated serving on itself (its reply
    says so); a decode leg that dies AFTER import — mid-decode — makes
    ``result()`` fall back to a full colocated re-submit on the
    surviving prefill worker (token-identical by the (seed, position)
    sampling-key construction), recorded as a ``serving.disagg_fallback``
    flight event. Only when no leg survives does the typed error
    propagate.

    One root span per request (``serving.disagg_request``) parents the
    plan/prefill/decode leg spans; the workers' handler spans continue
    the same trace over the wire, so /spans on any involved node shows
    the stitched prefill -> transfer -> decode timeline.
    """

    RESULT_TIMEOUT_S = 120.0

    def __init__(
        self, user: "UserNode", validator: Peer, *,
        pipeline: bool = False, pipeline_sid: str | None = None,
    ):
        self.user = user
        self.validator = validator
        self.pipeline = bool(pipeline)
        self.pipeline_sid = pipeline_sid
        self._handles: dict[int, dict] = {}
        self._next_rid = 0
        # client rid -> verified work receipt (the worker's signed
        # resource claim that rode the SERVE_TOKENS reply), bounded so
        # a long-lived client doesn't grow without end
        self.receipts: deque[tuple[int, dict]] = deque(maxlen=256)

    def receipt(self, rid: int) -> dict | None:
        for r, rec in self.receipts:
            if r == rid:
                return rec
        return None

    def _note_receipt(self, rid: int, h: dict, resp: dict) -> str:
        """Verify + store the receipt (if any) that rode the tokens
        reply, and queue the user-side observation the validator
        cross-checks against the worker's claim. Returns the tenant to
        bill the observation under. Never raises: accounting must not
        break token delivery."""
        node = self.user
        tenant = str(node.node_id)[:128]
        rec = resp.get("receipt")
        if isinstance(rec, dict):
            from tensorlink_tpu_torch.runtime.ledger import verify_receipt

            ok, why = verify_receipt(rec)
            if ok:
                node.metrics.incr("receipts_verified_total")
                self.receipts.append((rid, rec))
                # trust the billed tenant label only after the
                # signature checks out
                tenant = str(rec.get("tenant") or tenant)[:128]
            else:
                node.metrics.incr("receipts_bad_total")
                node.flight.record(
                    "receipt.client_reject", "warn",
                    worker=h["result_peer"].node_id[:16],
                    rid=int(h["remote_rid"]), reason=why,
                )
        return tenant

    async def _pipeline_head(self) -> Peer:
        """Locate the stage-0 (head) worker of the target pipeline via
        the validator's placement table. The head fronts the whole
        pipeline — submit/result against it is the colocated surface."""
        from tensorlink_tpu_torch.parallel.serving import OverloadedError

        node = self.user
        msg: dict = {"type": "SERVE_PIPELINE_PLAN", "stage": 0}
        if self.pipeline_sid:
            msg["sid"] = self.pipeline_sid
        plan = self._check(
            await node.request(self.validator, msg), "SERVE_PIPELINE_PLAN"
        )
        if plan.get("error") or not plan.get("node"):
            raise OverloadedError(
                "validator knows no live pipeline head"
                + (f" for sid {self.pipeline_sid!r}" if self.pipeline_sid
                   else "")
                + (f": {plan['error']}" if plan.get("error") else ""),
                reason="unplaceable",
            )
        return await self._peer(plan["node"])

    def _wire_request(
        self, ids, max_new, seed, priority, deadline_s
    ) -> dict:
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        req: dict = {
            "ids": [int(t) for t in ids],
            "seed": int(seed),
            "priority": str(priority),
        }
        if max_new is not None:
            req["max_new"] = int(max_new)
        if deadline_s is not None:
            req["deadline_s"] = float(deadline_s)
        return req

    async def _peer(self, winfo: dict) -> Peer:
        node = self.user
        p = node.peers.get(winfo["node_id"])
        if p is not None:
            return p
        return await node.connect_candidates(
            winfo["host"], int(winfo["port"]),
            tuple(winfo.get("alt_hosts", ()) or ()),
            expect_id=winfo["node_id"],
        )

    def _terminal(self, rid: int, h: dict) -> None:
        """A request just failed for good: finish its root span as an
        error and drop the handle — keeping it would leak the prompt +
        plan per failed request on a long-lived client, and a re-poll
        reaching finish_span twice would duplicate the root span row
        in /spans. (A soft TimeoutError is NOT terminal: that path
        leaves handle and span live for the next poll.)"""
        self.user.tracer.finish_span(h["root"], status="error")
        self._handles.pop(rid, None)

    @staticmethod
    def _check(resp: dict, *want: str) -> dict:
        from tensorlink_tpu_torch.parallel.serving import (
            ServingError,
            serve_error_from_wire,
        )

        if resp.get("type") == "SERVE_FAILED":
            raise serve_error_from_wire(resp)
        if resp.get("type") not in want:
            raise ServingError(f"unexpected serving reply: {resp}")
        return resp

    async def submit(
        self, ids, *, max_new: int | None = None, seed: int = 0,
        priority="standard", deadline_s: float | None = None,
    ) -> int:
        """Place and launch one request; returns a client-side rid for
        :meth:`result`. Raises the same typed errors a local engine's
        ``submit`` raises (re-raised from the placed leg)."""
        node = self.user
        req = self._wire_request(ids, max_new, seed, priority, deadline_s)
        root = node.tracer.start_span(
            "serving.disagg_request", {"prompt_len": len(req["ids"])}
        )
        ctx = root.context()
        if self.pipeline:
            # pipeline mode: one plan hop to find the head stage, then
            # the head's coordinator owns placement/streaming/failover —
            # the handle is colocated-shaped (no client-side fallback
            # leg; failover happens inside the pipeline)
            try:
                with node.tracer.span("serving.leg.plan", remote=ctx):
                    hpeer = await self._pipeline_head()
                with node.tracer.span(
                    "serving.leg.pipeline_submit", remote=ctx,
                    attrs={"head": hpeer.node_id[:8]},
                ):
                    resp = self._check(
                        await node.request(
                            hpeer, {"type": "SERVE_SUBMIT", **req}
                        ),
                        "SERVE_ACCEPTED",
                    )
            except BaseException:
                node.tracer.finish_span(root, status="error")
                raise
            rid = self._next_rid
            self._next_rid += 1
            self._handles[rid] = {
                "root": root, "req": req, "plan": {"pipeline": True},
                "t0": time.perf_counter(), "result_peer": hpeer,
                "remote_rid": int(resp["rid"]),
                "fallback_info": None, "colocated": True,
            }
            return rid
        with node.tracer.span("serving.leg.plan", remote=ctx):
            plan = self._check(
                await node.request(
                    self.validator,
                    # tokens this request will pin in a KV pool (prompt
                    # + decode budget when known) — the validator's
                    # headroom gate converts per candidate through each
                    # worker's advertised block size
                    {"type": "SERVE_PLAN",
                     "need_tokens": len(req["ids"]) + req.get("max_new", 0)},
                ),
                "SERVE_PLAN",
            )
        if plan.get("error"):
            from tensorlink_tpu_torch.parallel.serving import OverloadedError

            node.tracer.finish_span(root, status="error")
            raise OverloadedError(
                f"validator could not place the request: {plan['error']}",
                reason="unplaceable",
            )
        handle: dict = {
            "root": root, "req": req, "plan": plan,
            "t0": time.perf_counter(),
        }
        try:
            if plan.get("colocated"):
                peer = await self._peer(plan["node"])
                with node.tracer.span(
                    "serving.leg.colocated_submit", remote=ctx
                ):
                    resp = self._check(
                        await node.request(
                            peer, {"type": "SERVE_SUBMIT", **req}
                        ),
                        "SERVE_ACCEPTED",
                    )
                handle.update(
                    result_peer=peer, remote_rid=int(resp["rid"]),
                    fallback_info=None, colocated=True,
                )
            else:
                ppeer = await self._peer(plan["prefill"])
                with node.tracer.span(
                    "serving.leg.prefill", remote=ctx,
                    attrs={"worker": plan["prefill"]["node_id"][:8]},
                ):
                    resp = self._check(
                        await node.request(
                            ppeer,
                            {"type": "SERVE_PREFILL", **req,
                             "decode": plan["decode"]},
                            timeout=self.RESULT_TIMEOUT_S,
                        ),
                        "SERVE_PREFILLED",
                    )
                # on the root span, not the handle: /spans then shows
                # how many bytes this request's KV payload put on the
                # wire (nothing ever read it off the handle)
                root.attrs["wire_bytes"] = int(resp.get("wire_bytes", 0))
                if resp.get("fallback"):
                    # the prefill worker could not reach the decode leg
                    # and now serves the request colocated on itself
                    node.flight.record(
                        "serving.disagg_fallback", "warn", stage="prefill",
                        reason=str(resp.get("reason", ""))[:200],
                    )
                    handle.update(
                        result_peer=ppeer, remote_rid=int(resp["rid"]),
                        fallback_info=None, colocated=True,
                    )
                else:
                    dpeer = await self._peer(plan["decode"])
                    handle.update(
                        result_peer=dpeer,
                        remote_rid=int(resp["decode_rid"]),
                        # the surviving-leg fallback target if decode
                        # dies mid-request
                        fallback_info=plan["prefill"],
                        colocated=False,
                    )
        except BaseException:
            node.tracer.finish_span(root, status="error")
            raise
        rid = self._next_rid
        self._next_rid += 1
        self._handles[rid] = handle
        return rid

    async def result(
        self, rid: int, *, timeout_s: float | None = None
    ) -> np.ndarray:
        """Fetch the finished stream for a :meth:`submit` rid (drives
        the remote engine exactly like a local ``result()``)."""
        from tensorlink_tpu_torch.parallel.serving import ServingError

        node = self.user
        h = self._handles.get(rid)
        if h is None:
            raise KeyError(f"unknown remote serving request {rid}")
        ctx = h["root"].context()
        wait = timeout_s if timeout_s is not None else self.RESULT_TIMEOUT_S
        msg = {
            "type": "SERVE_RESULT", "rid": h["remote_rid"],
            "timeout_s": wait,
        }
        try:
            with node.tracer.span(
                "serving.leg.decode" if not h.get("colocated")
                else "serving.leg.colocated_result",
                remote=ctx,
            ):
                # generous envelope past the engine-side wait: the
                # reply must carry the typed timeout, not race it
                raw = await node.request(
                    h["result_peer"], msg, timeout=wait + 30.0
                )
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            fb = h.get("fallback_info")
            if fb is None:
                self._terminal(rid, h)
                raise ServingError(
                    f"serving leg on {h['result_peer'].node_id[:8]} "
                    f"died mid-request ({e}) and no fallback leg "
                    "survives"
                ) from e
            # decode leg died mid-request: colocated re-run on the
            # surviving prefill worker, token-identical by construction
            node.flight.record(
                "serving.disagg_fallback", "warn", stage="decode",
                dead=h["result_peer"].node_id[:16],
                reason=str(e)[:200],
            )
            node.metrics.incr("serving_disagg_fallback_total")
            try:
                fb_req = dict(h["req"])
                if fb_req.get("deadline_s") is not None:
                    # the deadline is end-to-end: the fallback leg gets
                    # only what the dead legs have not already spent
                    rem = fb_req["deadline_s"] - (
                        time.perf_counter() - h["t0"]
                    )
                    if rem <= 0:
                        from tensorlink_tpu_torch.parallel.serving import (
                            DeadlineExceededError,
                        )

                        raise DeadlineExceededError(
                            f"deadline {fb_req['deadline_s']}s expired "
                            "before the fallback leg could start"
                        )
                    fb_req["deadline_s"] = rem
                fpeer = await self._peer(fb)
                with node.tracer.span("serving.leg.fallback", remote=ctx):
                    sub = self._check(
                        await node.request(
                            fpeer, {"type": "SERVE_SUBMIT", **fb_req}
                        ),
                        "SERVE_ACCEPTED",
                    )
            except BaseException:
                self._terminal(rid, h)
                raise
            # the handle now points at the LIVE fallback stream: a
            # later poll (soft timeout, transient blip) must drive it,
            # not dial the dead decode peer again and pile up another
            # duplicate colocated submit per attempt
            h.update(
                result_peer=fpeer, remote_rid=int(sub["rid"]),
                fallback_info=None, colocated=True,
            )
            # re-enter: the colocated-result path applies the same
            # typed-timeout / leg-death classification to the fallback
            # stream (fallback_info is now None, so recursion is
            # bounded at one level)
            return await self.result(rid, timeout_s=timeout_s)
        except BaseException:
            self._terminal(rid, h)
            raise
        else:
            # raised OUTSIDE the try above: a remote soft result()
            # timeout means the stream is STILL RUNNING and collectable
            # later. builtins TimeoutError subclasses OSError, so
            # letting _check raise it inside the try would misread a
            # healthy still-decoding leg as a dead one (duplicate
            # colocated re-submit while the original stream keeps
            # running). Handle and root span stay live for a later poll.
            if (
                raw.get("type") == "SERVE_FAILED"
                and str(raw.get("error_type")) == "TimeoutError"
            ):
                from tensorlink_tpu_torch.parallel.serving import (
                    serve_error_from_wire,
                )

                raise serve_error_from_wire(raw)
            try:
                resp = self._check(raw, "SERVE_TOKENS")
            except BaseException:
                self._terminal(rid, h)
                raise
        tokens = np.asarray(resp["tokens"], np.int32)
        tenant = self._note_receipt(rid, h, resp)
        node.record_receipt_obs(
            h["result_peer"].node_id, int(h["remote_rid"]),
            tenant, int(tokens.size),
        )
        node.tracer.finish_span(h["root"])
        del self._handles[rid]
        return tokens
