"""ShardedTrainer: the train step over the whole mesh (port of
``tensorlink_tpu/parallel/engine.py``).

A model is split into (embed, N homogeneous blocks, head)
(``PipelineParts``). Blocks are stacked on a [S, L/S, ...] leading axis
and split over ``pipe``; embed and head params are whole on every stage
(or split by their own specs). The reference compiles the whole step
into one XLA program and lets the partitioner insert the collectives;
here every rank runs its part of the step eagerly and issues them itself:

- the micros stream through the GPipe ticks (``parallel/pp.py``) or the
  1F1B table (``parallel/pp1f1b.py``) over the ``pipe`` group;
- ``data`` splits the batch's rows (DP): gradients are averaged over the
  ``data`` group (one all-reduce of every replicated leaf, and under
  ``cfg.fsdp`` a reduce-scatter of each split leaf);
- ``model`` splits the block weights by their ``param_spec`` (Megatron
  TP): the layers insert the ``model`` collectives (``parallel/tp.py``);
  MoE blocks hold ``E/m`` experts a rank and run their all_to_all form
  (``parallel/ep.py``, ``nn/moe.py``): the expert blocks' gradients stay
  local, and the router's, summed over ``model`` inside the layer,
  reaches every rank whole like any replicated leaf's;
- embed and head gradients are summed over ``pipe`` (GPT-2's tied
  ``wte`` takes its embed-side gradient on stage 0 and its head-side one
  on the last stage), so every replica takes the same update;
- ``seq`` splits the token dim inside the pipeline (``Pipeline`` /
  ``Pipeline1F1B`` ``seq_axis``; the blocks run the ring or Ulysses
  attention of ``parallel/sp.py``): every rank embeds the whole micro and
  cuts its token shard; GPipe's head runs on the outputs re-assembled
  over ``seq`` (its seed 1 / S on each rank, the shards' output
  gradients S times the slice), 1F1B's on each shard; every gradient is
  summed over the ``seq`` group, beside the ``data`` reduction, and the
  global mask reaches every shard whole through the extras channel;
- the loss, the global gradient norm (each split leaf's squares summed
  over its groups, each replicated leaf counted once) and the non-finite
  flag travel in one all-reduce over the world, so every rank clips by
  the same norm and skips the same steps.

Per-rank state: ``TrainState`` with flat dicts, names ``embed.<path>``,
``stages.<l>.<path>`` (l the layer within this stage) and
``head.<path>``, of this rank's blocks: f32 masters and moments, each
leaf cut by its spec. ``gather_state`` rebuilds the reference's global
tree (``{"embed", "stages": [S, L/S, ...], "head"}`` and the moments),
``adopt_state`` places one (from another mesh shape, a checkpoint, or
the JAX package through ``convert.sharded_state_from_jax``).

Dropout: each step draws from integer seeds, ``fold_in(seed, step,
data coordinate)`` split into embed, pipe and head streams as the
reference splits its key; a block's mask comes from (micro, global
layer), so it is the same at any pipe depth and under either schedule.

``tracer``/``metrics`` turn on the reference's step telemetry: an
``engine.step`` span (``engine.compile_step`` for the first call of a
batch signature) with ``{"stages", "micros"}``, the ``step_s`` /
``compile_s`` series, and the non-finite accounting
(``train_nonfinite_total``, a ``train_nonfinite`` event to ``flight``, by
default the process's recorder), which reads one flag from the device a
step; ``audit_programs`` (an HLO audit) has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.config import TrainConfig
from tensorlink_tpu_torch.nn.lora import is_lora_name, lora_spec_tree
from tensorlink_tpu_torch.nn.module import NamedSharding, P, flat_specs, is_spec
from tensorlink_tpu_torch.nn.moe import check_expert_split
from tensorlink_tpu_torch.parallel import ep, tp
from tensorlink_tpu_torch.parallel.dp import (
    all_reduce_flat,
    fsdp_dim,
    fsdp_gather,
    fsdp_reduce_scatter,
    fsdp_spec_tree,
)
from tensorlink_tpu_torch.parallel.pp import Pipeline, fold_in, generator
from tensorlink_tpu_torch.parallel.pp1f1b import Pipeline1F1B
from tensorlink_tpu_torch.runtime.mesh import mesh_device, mesh_sizes
from tensorlink_tpu_torch.runtime.flight import default_recorder
from tensorlink_tpu_torch.runtime.metrics import pipeline_bubble_fraction
from tensorlink_tpu_torch.runtime.tracing import StepTelemetry
from tensorlink_tpu_torch.train.optim import (
    apply_updates,
    make_optimizer,
    make_schedule,
)
from tensorlink_tpu_torch.train.trainer import TrainState, _where, note_nonfinite
from tensorlink_tpu_torch.utils.trees import flatten, nest

log = logging.getLogger("tensorlink_tpu_torch.engine")


def apply_with(module, params: dict, *args, method: str = "forward", **kwargs):
    """``module.<method>(*args, **kwargs)`` with its parameters replaced
    by ``params`` (names relative to ``module``): ``functional_call`` for
    any method (``Embedding.attend``, ``forward_with_aux``)."""
    if method == "forward":
        return functional_call(module, params, args, kwargs)
    from torch.nn.utils.stateless import _reparametrize_module

    with _reparametrize_module(module, params):
        return getattr(module, method)(*args, **kwargs)


def sub_params(params: dict, prefix: str) -> dict:
    """The entries of a flat dict under ``prefix.``, prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


@dataclasses.dataclass
class PipelineParts:
    """Model split for the engine. Param containers are flat dicts of
    tensors with dotted names (a state dict's), relative to the part.
    ``head_fn(all_params, x, batch, rng)`` sees ``{"embed": ...,
    "head": ...}`` so that weight tying works; ``rng`` arguments are
    ``torch.Generator``s or None (no dropout)."""

    embed_fn: Callable  # (params, batch, rng=None) -> [B, ...]
    block: Any  # homogeneous block (for specs)
    block_params: dict  # {"0": {...}, ..., "L-1": {...}}
    block_fn: Callable  # (layer params, x[, rng[, extras]]) -> x
    head_fn: Callable  # (all params, x, batch, rng=None) -> output
    embed_params: dict
    head_params: dict
    # blocks with an auxiliary loss (MoE router load balancing):
    # block_fn_aux(lp, x[, rng[, extras]]) -> (x, aux). Used when
    # TrainConfig.moe_aux_weight > 0; both schedules carry it.
    block_fn_aux: Callable | None = None
    # per-batch auxiliary inputs for the blocks (the padding mask):
    # extras_fn(batch) -> dict of [B, ...] tensors, or None; resliced per
    # micro and handed to every stage whole
    extras_fn: Callable | None = None
    # whether head_fn + loss reduce uniformly over token positions
    # (causal-LM mean CE): the seq-sharded 1F1B needs it
    head_per_token: bool | None = None


def _stacked_spec(block, num_stages: int, model_axis: str = "model",
                  example_layer_params=None, fsdp_data_size: int = 1):
    """Per-block spec tree -> stacked [pipe, layer, ...] specs. The
    adapters of ``example_layer_params`` (one layer's flat params) patch
    the tree (``lora_spec_tree``); ``fsdp_data_size`` > 1
    adds ``data`` to one real weight dim of each large leaf BEFORE the
    [pipe, layer] prefix."""
    spec = block.param_spec(model_axis)
    if example_layer_params is not None:
        nested = nest(example_layer_params)
        spec = lora_spec_tree(spec, nested)
        if fsdp_data_size > 1:
            spec = fsdp_spec_tree(spec, nested, fsdp_data_size)
    return _map_specs(spec, lambda s: P("pipe", None, *s))


def _map_specs(tree, fn):
    if is_spec(tree):
        return fn(tree)
    return {k: _map_specs(v, fn) for k, v in tree.items() if v is not None}


def reshape_stages(tree, new_stages: int):
    """Re-factor stacked stage leaves [S, Lps, ...] for another pipeline
    depth: layers are laid out stage-major and contiguous, so changing S
    is a reshape through the flat [L, ...] layout. Works on param and
    moment trees alike (nested dicts of tensors or arrays)."""
    if isinstance(tree, dict):
        return {k: reshape_stages(v, new_stages) for k, v in tree.items()}
    L = tree.shape[0] * tree.shape[1]
    if L % new_stages:
        raise ValueError(f"{L} layers not divisible by {new_stages} stages")
    return tree.reshape(new_stages, L // new_stages, *tree.shape[2:])


class ShardedTrainer:
    """The sharded train and eval steps for one mesh + model."""

    def __init__(
        self,
        mesh,
        cfg: TrainConfig,
        parts: PipelineParts,
        loss_fn: Callable,
        embed_module=None,
        head_module=None,
        loss_reduction: str = "uniform_mean",
        tracer=None,
        metrics=None,
        flight=None,
        *,
        device=None,
    ):
        """``loss_reduction`` declares how ``loss_fn(out, batch)`` reduces
        over the batch: "uniform_mean" (every schedule) or
        "batch_normalized" (normalized by a per-batch quantity: GPipe
        only, which runs loss_fn once over the full batch). ``device``:
        CUDA unless ``device="cpu"``; it must be the mesh's."""
        self.device = resolve_device(device)
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a trainer on "
                             f"{self.device.type}")
        self.device = mesh_device(mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.parts = parts
        self.loss_fn = loss_fn
        self.tracer, self.metrics = tracer, metrics
        self._telemetry = None
        if tracer is not None or metrics is not None:
            self._telemetry = StepTelemetry(
                tracer, metrics, "engine",
                {"stages": mesh_sizes(mesh)["pipe"], "micros": cfg.micro_batches},
            )
            if flight is None:
                flight = default_recorder()
        self.flight = flight
        if loss_reduction not in ("uniform_mean", "batch_normalized"):
            raise ValueError(
                f"unknown loss_reduction {loss_reduction!r}; declare "
                "'uniform_mean' or 'batch_normalized'"
            )
        if loss_reduction == "batch_normalized" and cfg.pp_schedule == "1f1b":
            raise ValueError(
                "pp_schedule='1f1b' computes the batch loss as the "
                "unweighted mean of per-micro losses, which differs from "
                "a per-batch-normalized loss (e.g. mean over the batch's "
                "non-pad tokens). Use pp_schedule='gpipe' (loss_fn runs "
                "once over the full batch there) or renormalize per "
                "example and declare loss_reduction='uniform_mean'."
            )
        self.loss_reduction = loss_reduction
        self.sizes = mesh_sizes(mesh)
        self.num_stages = self.sizes["pipe"]
        L = len(parts.block_params)
        if L % self.num_stages:
            raise ValueError(f"{L} blocks not divisible by pipe={self.num_stages}")
        self.layers_per_stage = L // self.num_stages
        if cfg.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pp_schedule {cfg.pp_schedule!r}")
        self.aux_weight = float(getattr(cfg, "moe_aux_weight", 0.0) or 0.0)
        if self.aux_weight:
            if parts.block_fn_aux is None:
                raise ValueError(
                    "moe_aux_weight > 0 requires PipelineParts.block_fn_aux"
                )
        elif parts.block_fn_aux is not None:
            log.warning("model carries an MoE aux loss but moe_aux_weight=0: "
                        "the router trains unregularized")
        self.seq = self.sizes.get("seq", 1)
        seq_impl = getattr(parts.block, "attn_impl", None)
        ring = seq_impl in ("ring", "ulysses")  # both need the seq group bound
        if self.seq > 1:
            if not ring:
                raise ValueError(
                    "mesh seq>1 shards the token dim inside the pipeline; "
                    "build the model with attn_impl='ring' or 'ulysses' "
                    "so attention spans the full sequence over the seq axis"
                )
            if cfg.pp_schedule == "1f1b" and parts.head_per_token is not True:
                # under seq sharding 1F1B runs head_loss per token shard:
                # a position-selective head (CLS pooling) would pool the
                # wrong token on shards > 0
                raise NotImplementedError(
                    "pp_schedule='1f1b' with mesh seq>1 requires "
                    "PipelineParts.head_per_token=True (a head+loss that "
                    "reduces uniformly over token positions, e.g. "
                    "causal-LM mean CE); this model's parts declare "
                    f"head_per_token={parts.head_per_token!r}. Use "
                    "pp_schedule='gpipe', whose head runs on the "
                    "re-assembled full sequence."
                )
        # ring models bind the seq group even at seq=1, as the reference
        # binds the axis
        self._seq_axis = "seq" if ring else None
        if self.sizes["data"] > 1 and loss_reduction == "batch_normalized":
            raise NotImplementedError(
                "loss_reduction='batch_normalized' over a data axis > 1: each "
                "rank holds only its rows of the batch")
        self.data_size = self.sizes["data"]
        self.model_size = self.sizes["model"]
        experts = getattr(getattr(parts.block, "mlp", None), "num_experts", None)
        if experts:
            check_expert_split(experts, self.model_size)
        self.groups = {a: mesh.get_group(a) for a in ("data", "pipe", "model", "seq")}
        self.pipeline = Pipeline(
            mesh, parts.block_fn, self.num_stages, self.layers_per_stage,
            block_fn_aux=parts.block_fn_aux, seq_axis=self._seq_axis,
            remat=cfg.remat and cfg.pp_schedule == "gpipe")
        self.comm = self.pipeline.comm
        self.seq_shard = self.pipeline.seq
        self.stage = self.comm.stage
        sched = make_schedule(
            cfg.schedule, cfg.learning_rate, cfg.warmup_steps, cfg.total_steps
        )
        self.optimizer = make_optimizer(
            cfg.optimizer, sched, cfg.weight_decay,
            moment_dtype=cfg.opt_moment_dtype,
        )
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.lora_only = cfg.train_only == "lora"

        # specs -----------------------------------------------------------
        fsdp_n = self.data_size if cfg.fsdp else 1
        if cfg.fsdp and fsdp_n <= 1:
            log.warning(
                "fsdp=True on a mesh with data axis size %d: nothing to "
                "shard over; params/moments stay as replicated DP leaves "
                "them", fsdp_n)
        stacked_specs = _stacked_spec(
            parts.block, self.num_stages,
            example_layer_params=parts.block_params["0"],
            fsdp_data_size=fsdp_n,
        )

        def part_specs(module, params):
            flat = (flat_specs(module.param_spec()) if module is not None
                    else {k: P() for k in params})
            spec = {k: flat.get(k, P()) for k in params}
            spec = flat_specs(lora_spec_tree(nest(spec), params))
            if fsdp_n > 1:
                spec = {k: fsdp_spec_tree(s, params[k], fsdp_n)
                        for k, s in spec.items()}
            return spec

        embed_specs = part_specs(embed_module, parts.embed_params)
        head_specs = part_specs(head_module, parts.head_params)
        self.param_specs = {
            "embed": nest(embed_specs),
            "stages": stacked_specs,
            "head": nest(head_specs),
        }
        # per-rank leaf specs (stage leaves without the [pipe, layer] prefix)
        block_flat = {k: P(*s[2:]) for k, s in flat_specs(stacked_specs).items()}
        self._specs: dict[str, P] = {}
        self._specs.update({f"embed.{k}": s for k, s in embed_specs.items()})
        for l in range(self.layers_per_stage):
            self._specs.update({f"stages.{l}.{k}": s for k, s in block_flat.items()})
        self._specs.update({f"head.{k}": s for k, s in head_specs.items()})
        self._block_names = list(block_flat)
        self._host_steps: dict[int, tuple] = {}  # id(step) -> (step, int)
        self._act_meta: dict = {}

    def _parallel(self):
        """The model group bound for the blocks: ``tp.model_parallel``
        and, for MoE blocks, ``ep.ep_parallel`` (their all_to_all form,
        as the reference's step runs under ``jax.set_mesh``)."""
        stack = contextlib.ExitStack()
        stack.enter_context(tp.model_parallel(self.groups["model"]))
        stack.enter_context(ep.ep_parallel(self.groups["model"]))
        return stack

    # -- placement -------------------------------------------------------
    def _axes(self, name: str, dim: int) -> tuple[str, ...]:
        return tuple(a for a in self._specs[name].axes(dim) if self.sizes[a] > 1)

    def _fsdp_dim(self, name: str) -> int | None:
        d = fsdp_dim(self._specs[name])
        return d if d is not None and self.data_size > 1 else None

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a leaf whose global shape has no
        [pipe, layer] prefix."""
        return NamedSharding(self.mesh, self._specs[name]).local(t).contiguous()

    def _replication(self, name: str) -> int:
        """How many ranks hold the same block of ``name``."""
        r = 1
        used = {a for d in range(len(self._specs[name])) for a in self._axes(name, d)}
        for a in ("data", "model", "seq"):
            if a not in used:
                r *= self.sizes.get(a, 1)
        if not name.startswith("stages."):
            r *= self.num_stages
        return r

    def _place(self, flat_global: dict) -> dict:
        """{per-rank name: f32 block on this rank's device} from global
        flat trees (embed, per-layer, head)."""
        out = {}
        for name, t in flat_global.items():
            t = torch.as_tensor(t)
            if not t.is_floating_point():
                raise ValueError(f"non-floating params cannot be trained: {name}")
            out[name] = self._local(name, t).to(self.device, torch.float32)
        return out

    def _global_flat(self, params: dict) -> dict:
        """PipelineParts-style params -> {per-rank name: global tensor}
        for this rank's stage."""
        out = {f"embed.{k}": v for k, v in params["embed"].items()}
        L0 = self.stage * self.layers_per_stage
        for l in range(self.layers_per_stage):
            out.update({f"stages.{l}.{k}": v
                        for k, v in params["blocks"][str(L0 + l)].items()})
        out.update({f"head.{k}": v for k, v in params["head"].items()})
        return out

    # -- state -----------------------------------------------------------
    def init_state(self) -> TrainState:
        """This rank's blocks of the parts' params (f32 masters on its
        device) and fresh moments."""
        params = self._place(self._global_flat({
            "embed": self.parts.embed_params,
            "blocks": self.parts.block_params,
            "head": self.parts.head_params,
        }))
        state = TrainState.create(params, self.optimizer)
        self._host_steps = {id(state.step): (state.step, 0)}
        return state

    def adopt_state(self, state: TrainState) -> TrainState:
        """Place a GLOBAL state (the reference's tree: ``{"embed",
        "stages": [S', L/S', ...], "head"}`` params and moments, e.g.
        ``gather_state`` of another mesh shape or
        ``convert.sharded_state_from_jax``): stage leaves are re-factored
        to this pipeline depth (``reshape_stages``) and every leaf is cut
        to this rank's block."""
        S = self.num_stages

        def place(tree):
            stages = flatten(reshape_stages(tree["stages"], S))
            per_layer = {str(self.stage * self.layers_per_stage + l): {
                k: v[self.stage, l] for k, v in stages.items()}
                for l in range(self.layers_per_stage)}
            return self._place(self._global_flat({
                "embed": flatten(tree["embed"]), "blocks": per_layer,
                "head": flatten(tree["head"])}))

        params = place(state.params)
        opt_state = {k: place(v) for k, v in state.opt_state.items()}
        step = torch.as_tensor(state.step).to(self.device, torch.int32).reshape(())
        return TrainState(params=params, opt_state=opt_state, step=step)

    def gather_state(self, state: TrainState) -> TrainState | None:
        """The GLOBAL state on rank 0 (CPU tensors in the reference's
        tree: params and moments ``{"embed", "stages": [S, L/S, ...],
        "head"}``, step a 0-d tensor); None on the other ranks. A
        collective: every rank calls it."""

        def whole(name, t):
            d = self._fsdp_dim(name)
            if d is not None:
                t = fsdp_gather(t, d, self.groups["data"])
            for dim in range(t.dim()):
                if "model" in self._axes(name, dim):
                    g = self.groups["model"]
                    parts = [torch.empty_like(t) for _ in range(self.model_size)]
                    dist.all_gather(parts, t.contiguous(), group=g)
                    t = torch.cat(parts, dim=dim)
            return t

        def tree(flat):
            full = {k: whole(k, v) for k, v in flat.items()}
            stages = {}
            for name in self._block_names:
                local = torch.stack([full[f"stages.{l}.{name}"]
                                     for l in range(self.layers_per_stage)])
                parts = [torch.empty_like(local) for _ in range(self.num_stages)]
                if self.num_stages > 1:
                    dist.all_gather(parts, local.contiguous(),
                                    group=self.groups["pipe"])
                else:
                    parts = [local]
                stages[name] = torch.stack(parts).cpu()
            return {
                "embed": nest({k: v.cpu() for k, v in sub_params(full, "embed").items()}),
                "stages": nest(stages),
                "head": nest({k: v.cpu() for k, v in sub_params(full, "head").items()}),
            }

        params = tree(state.params)
        opt_state = {k: tree(v) for k, v in state.opt_state.items()}
        if dist.get_rank() != 0:
            return None
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step.detach().cpu())

    # -- the step --------------------------------------------------------
    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.compute_dtype) if t.is_floating_point() else t

    def trainable(self, name: str) -> bool:
        return not self.lora_only or is_lora_name(name)

    def _seed(self, state: TrainState, rng) -> int:
        """The step's base seed: ``rng`` (an int, or a draw from a
        Generator) or ``fold_in(cfg.seed, step)`` (the step known on the
        host when this trainer made the state, read back otherwise),
        folded with this rank's data coordinate."""
        if rng is None:
            known = self._host_steps.get(id(state.step))
            step = known[1] if known and known[0] is state.step else int(state.step)
            base = fold_in(self.cfg.seed, step)
        elif isinstance(rng, torch.Generator):
            # one draw from the caller's generator (a device read on CUDA)
            base = int(torch.randint(2**62, (1,), generator=rng,
                                     device=rng.device).item())
        else:
            base = int(rng)
        return fold_in(base, self.mesh.get_local_rank("data"))

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (its ``data`` coordinate's
        block), on its device."""
        n = self.data_size
        i = self.mesh.get_local_rank("data")
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if n > 1:
                if v.shape[0] % n:
                    raise ValueError(f"batch {v.shape[0]} not divisible by "
                                     f"data={n}")
                v = v.chunk(n)[i]
            out[k] = v.to(self.device)
        return out

    def _batch(self, batch, local: bool) -> dict:
        if local:
            return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self.shard_batch(batch)

    def _micro_extras(self, batch, m: int):
        if self.parts.extras_fn is None:
            return None
        ex = self.parts.extras_fn(batch)
        if ex is None:
            return None
        return [{k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                 for k, v in ex.items()} for i in range(m)]

    def _full_leaves(self, params: dict, grad: bool) -> dict:
        """Whole (FSDP-gathered) f32 leaves of this rank's params; with
        ``grad``, leaves that require grad where trainable."""
        out = {}
        for k, v in params.items():
            d = self._fsdp_dim(k)
            full = fsdp_gather(v, d, self.groups["data"]) if d is not None else v
            full = full.detach()
            if grad and self.trainable(k):
                full.requires_grad_(True)
            out[k] = full
        return out

    def _split(self, cast: dict):
        embed = sub_params(cast, "embed")
        head = sub_params(cast, "head")
        stages = [sub_params(cast, f"stages.{l}") for l in range(self.layers_per_stage)]
        return embed, stages, head

    def _act_like(self, embed, batch, m: int) -> torch.Tensor:
        """A meta tensor with the [M, mb, ...] shape and dtype of the
        embedded micros (the stages after the first never embed)."""
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()) + (m,)
        if key not in self._act_meta:
            with torch.no_grad():
                meta = self.parts.embed_fn(
                    {k: v.to("meta") for k, v in embed.items()},
                    {k: v.to("meta") for k, v in batch.items()}, rng=None)
            B = meta.shape[0]
            if B % m:
                raise ValueError(f"batch {B} not divisible by micro_batches {m}")
            self._act_meta[key] = torch.empty(
                (m, B // m) + tuple(meta.shape[1:]), dtype=meta.dtype, device="meta")
        return self._act_meta[key]

    def _embed(self, embed, batch, seed, m: int):
        """-> (each micro's embedding, with its graph; their detached
        stack [M, mb, ...]). One embed call a micro, as the single-host
        ``Trainer`` accumulates: its backward then runs once a micro into
        the f32 masters, and micro i's dropout draws from
        ``fold_in(seed, i)`` under either schedule."""
        n = next(iter(batch.values())).shape[0]
        if n % m:
            raise ValueError(f"batch {n} not divisible by micro_batches {m}")
        xs = []
        for i in range(m):
            mb = {k: v.reshape(m, n // m, *v.shape[1:])[i] for k, v in batch.items()}
            r = None if seed is None else fold_in(seed, i)
            xs.append(self.parts.embed_fn(embed, mb, rng=generator(r, self.device)))
        return xs, torch.stack([x.detach() for x in xs])

    @staticmethod
    def _embed_backward(xs: list, dxs) -> None:
        live = [(x, g) for x, g in zip(xs, dxs) if x.requires_grad]
        if live:  # frozen embeddings: nothing to do
            torch.autograd.backward([x for x, _ in live], [g for _, g in live])

    def _cut(self, x_list: list) -> list:
        """Each embedded micro's token shard (views that keep the embed's
        graph), or the micros themselves without a seq group."""
        sq = self.seq_shard
        return x_list if sq is None else [sq.cut(x) for x in x_list]

    def _loss(self, cast, batch, seed, grad: bool):
        """GPipe forward (and backward with ``grad``) of this stage ->
        the loss terms this rank contributes (the last stage's loss_fn,
        every stage's aux share)."""
        comm, m, sq = self.comm, self.cfg.micro_batches, self.seq_shard
        S = 1 if sq is None else sq.size
        embed, stages, head = self._split(cast)
        r_embed, r_pipe, r_head = (None, None, None) if seed is None else (
            fold_in(seed, 0), fold_in(seed, 1), fold_in(seed, 2))
        if comm.first:
            x_list, xs = self._embed(embed, batch, r_embed, m)
        else:
            xs = self._act_like(embed, batch, m)
        extras = self._micro_extras(batch, m)
        with_aux = bool(self.aux_weight)
        run = self.pipeline.forward(stages, xs, r_pipe, extras, with_aux=with_aux,
                                    grad=grad, device=self.device)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        if with_aux:
            for a in run.aux:
                if a is not None:
                    total = total + self.aux_weight * torch.as_tensor(a).detach().float() / m
        dys = None
        if comm.last:
            y = torch.stack(run.outputs).detach()
            if sq is not None:  # the head sees the whole sequence
                y = sq.gather(y, dim=2)
            y = y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])
            if grad:
                y.requires_grad_(True)
            with torch.set_grad_enabled(grad):
                out = self.parts.head_fn({"embed": embed, "head": head}, y, batch,
                                         rng=generator(r_head, self.device))
                loss = self.loss_fn(out, batch).float()
            if grad:
                # every seq rank runs the same head: each takes 1/S of its
                # gradients (summed over seq later), while each shard's
                # output gradient is the whole loss's
                (loss / S).backward()
                dy = y.grad.reshape(m, -1, *y.shape[1:])
                dys = list(dy if sq is None else sq.cut(dy, 2) * S)
            total = total + loss.detach()
        if grad:
            dxs = self.pipeline.backward(run, dys, aux_cot=self.aux_weight / (m * S))
            if comm.first:
                self._embed_backward(self._cut(x_list), dxs)
        return total

    def _loss_and_grads_1f1b(self, cast, batch, seed):
        """1F1B gradients of this stage -> the loss (the same on every
        pipe rank)."""
        comm, m = self.comm, self.cfg.micro_batches
        embed, stages, head = self._split(cast)
        r_embed, r_pipe = (None, None) if seed is None else (
            fold_in(seed, 0), fold_in(seed, 1))
        if comm.first:
            x_list, xs = self._embed(embed, batch, r_embed, m)
        else:
            xs = self._act_like(embed, batch, m)
        micro = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:]) for k, v in batch.items()}

        def head_loss(aux_p, y, mb, rng_h):
            return self.loss_fn(self.parts.head_fn(aux_p, y, mb, rng=rng_h), mb)

        pipe = Pipeline1F1B(
            self.mesh, self.parts.block_fn, self.num_stages, self.layers_per_stage,
            head_loss, block_fn_aux=self.parts.block_fn_aux,
            aux_weight=self.aux_weight, seq_axis=self._seq_axis,
            remat=self.cfg.remat)
        loss, dxs = pipe.train_grads(stages, {"embed": embed, "head": head}, xs,
                                     micro, r_pipe, self._micro_extras(batch, m),
                                     device=self.device)
        if comm.first:
            self._embed_backward(self._cut(x_list), dxs)
        # every pipe rank holds the whole loss: contribute 1/S of it
        return loss.detach() / self.num_stages

    def _reduce_grads(self, leaves: dict, params: dict) -> dict:
        """Per-rank gradients of the global loss: embed/head summed over
        ``pipe``, everything summed over ``seq`` (each token shard's
        contribution) and averaged over ``data`` (reduce-scattered to the
        blocks of FSDP leaves)."""
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        shared = [k for k in grads if not k.startswith("stages.")]
        grads.update(zip(shared, all_reduce_flat(
            [grads[k] for k in shared], self.groups["pipe"], mean=False)))
        if self.seq > 1:
            names = list(grads)
            grads.update(zip(names, all_reduce_flat(
                [grads[k] for k in names], self.groups["seq"], mean=False)))
        rep = [k for k in grads if self._fsdp_dim(k) is None]
        grads.update(zip(rep, all_reduce_flat([grads[k] for k in rep],
                                              self.groups["data"])))
        for k in grads:
            d = self._fsdp_dim(k)
            if d is not None:
                grads[k] = fsdp_reduce_scatter(grads[k], d, self.groups["data"])
        return {k: grads[k] for k in params}

    def _grads(self, state: TrainState, batch, seed):
        """-> (loss, global grad norm, non-finite flag, this rank's
        gradients of the global loss before clipping)."""
        leaves = self._full_leaves(state.params, grad=True)
        if not any(v.requires_grad for v in leaves.values()) and self.lora_only:
            raise ValueError("train_only='lora' but the params hold no "
                             "adapter (nn.lora.lora_init first)")
        cast = {k: self._cast(v) for k, v in leaves.items()}
        with self._parallel():
            if self.cfg.pp_schedule == "1f1b":
                loss_part = self._loss_and_grads_1f1b(cast, batch, seed)
            else:
                loss_part = self._loss(cast, batch, seed, grad=True)
        del cast
        grads = self._reduce_grads(leaves, state.params)
        del leaves
        gl = list(grads.values())
        reps = torch.tensor([1.0 / self._replication(k) for k in grads],
                            device=self.device)
        sq = (torch.stack(torch._foreach_norm(gl)).float().square() * reps).sum()
        bad = ~torch.isfinite(torch.stack(torch._foreach_norm(torch._foreach_mul(gl, 0.0))).sum())
        # loss terms are counted once per data replica, model and seq rank
        stats = torch.stack([
            loss_part / (self.data_size * self.model_size * self.seq), sq,
            (bad | ~torch.isfinite(loss_part)).float()])
        dist.all_reduce(stats)
        return stats[0], stats[1].sqrt(), stats[2] > 0, grads

    def loss_and_grads(self, state: TrainState, batch, rng=None, *,
                       local: bool = False):
        """(loss, {per-rank name: gradient}) of one step at ``state``,
        before clipping and the update (the gradients ``train_step``
        clips): names and blocks as in ``state.params``."""
        batch = self._batch(batch, local)
        loss, _, _, grads = self._grads(state, batch, self._seed(state, rng))
        return loss, grads

    def _step(self, state: TrainState, batch, seed):
        loss, gnorm, nonfinite, grads = self._grads(state, batch, seed)
        names = list(grads)
        gl = [grads[k] for k in names]
        if self.cfg.grad_clip_norm:
            scale = torch.clamp(self.cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
            gl = torch._foreach_mul(gl, scale)
            grads = dict(zip(names, gl))
        else:
            gnorm = torch.zeros((), device=self.device)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params, state.step)
        live = [k for k in updates if self.trainable(k)]
        params = {**state.params, **apply_updates(
            {k: state.params[k] for k in live}, {k: updates[k] for k in live})}
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        if self.cfg.skip_nonfinite_updates:
            new_state = TrainState(
                params=_where(nonfinite, state.params, new_state.params),
                opt_state=_where(nonfinite, state.opt_state, new_state.opt_state),
                step=torch.where(nonfinite, state.step, new_state.step),
            )
        return new_state, {"loss": loss, "grad_norm": gnorm, "nonfinite": nonfinite}

    def train_step(self, state: TrainState, batch, rng=None, *, local: bool = False):
        """One optimizer step of every rank -> (new state, {"loss",
        "grad_norm", "nonfinite"} as device tensors, the same on every
        rank). ``batch``: the GLOBAL batch (each rank takes its ``data``
        rows), or with ``local=True`` this rank's rows already (what
        ``ShardedLoader(mesh=...)`` yields). ``rng``: None (streams from
        ``cfg.seed`` and the step), an int seed or a Generator."""
        batch = self._batch(batch, local)
        seed = self._seed(state, rng)
        cm = (self._telemetry.step(batch, rng) if self._telemetry is not None
              else contextlib.nullcontext())
        with cm:
            new_state, stats = self._step(state, batch, seed)
        # the telemetry path's one host read (the reference's)
        if self._telemetry is not None and bool(stats["nonfinite"]):
            note_nonfinite(self, new_state, stats)
        if not self.cfg.skip_nonfinite_updates:
            known = self._host_steps.get(id(state.step))
            if known and known[0] is state.step:
                # the step tensor is held, so its id stays unique
                self._host_steps = {id(new_state.step): (new_state.step, known[1] + 1)}
        return new_state, stats

    def eval_fn(self, state: TrainState, batch, *, local: bool = False):
        """The loss of the GPipe forward without dropout (eval mode), the
        same on every rank."""
        batch = self._batch(batch, local)
        with torch.no_grad():
            cast = {k: self._cast(v) for k, v in
                    self._full_leaves(state.params, grad=False).items()}
            with self._parallel():
                part = self._loss(cast, batch, None, grad=False)
            loss = (part / (self.data_size * self.model_size * self.seq)).reshape(1)
            dist.all_reduce(loss)
        return loss[0]

    # -- reporting ------------------------------------------------------
    @property
    def bubble_fraction(self) -> float:
        return pipeline_bubble_fraction(self.num_stages, self.cfg.micro_batches)

    def measure_bubble(self, state, batch, repeats: int = 3,
                       factors: tuple = (1, 2, 3, 4), *, local: bool = False) -> dict:
        """MEASURED pipeline bubble: time the GPipe forward at k * M
        micros for each k in ``factors`` (same per-micro shape; the
        minimum of ``repeats`` calls, each ended by a device sync and a
        barrier over the pipe group), least-squares fit t = tick_s *
        (micros + extra); bubble = extra / (M + extra). The intercept also
        absorbs fixed per-call costs, so the fraction is an upper bound;
        r2 of the fit is reported, and a fit under r2 0.95 is marked
        invalid, as in the reference."""
        batch = self._batch(batch, local)
        m, comm = self.cfg.micro_batches, self.comm
        with torch.no_grad():
            cast = {k: self._cast(v) for k, v in
                    self._full_leaves(state.params, grad=False).items()}
            embed, stages, _ = self._split(cast)
            if comm.first:
                xs1 = self._embed(embed, batch, None, m)[1]
            else:
                xs1 = self._act_like(embed, batch, m)

            def sync():
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                if comm.size > 1:
                    dist.barrier(group=comm.group)

            def timed(xs):
                with self._parallel():
                    self.pipeline.forward(stages, xs, device=self.device)
                    sync()
                    best = float("inf")
                    for _ in range(repeats):
                        t0 = time.perf_counter()
                        self.pipeline.forward(stages, xs, device=self.device)
                        sync()
                        best = min(best, time.perf_counter() - t0)
                return best

            def rep(k):
                if xs1.device.type == "meta":
                    return torch.empty((k * m,) + tuple(xs1.shape[1:]),
                                       dtype=xs1.dtype, device="meta")
                return torch.cat([xs1] * k)

            micros = np.asarray([k * m for k in factors], np.float64)
            times = np.asarray([timed(rep(k)) for k in factors])
        A = np.stack([micros, np.ones_like(micros)], axis=1)
        (tick_s, c), res, *_ = np.linalg.lstsq(A, times, rcond=None)
        ss_tot = float(((times - times.mean()) ** 2).sum())
        r2 = 1.0 - float(res[0]) / ss_tot if len(res) and ss_tot > 0 else 0.0
        valid = tick_s > 0 and len(micros) >= 3 and len(res) == 1 and r2 > 0.95
        invalid_reason = None
        if not valid:
            invalid_reason = (
                f"fit rejected: tick_s={tick_s:.3e}, points={len(micros)}, "
                f"residuals={len(res)}, r2={r2:.3f} (need >0.95)")
        extra_ticks = c / tick_s if valid else float("nan")
        measured = (extra_ticks / (m + extra_ticks)
                    if valid and extra_ticks > 0 else (0.0 if valid else float("nan")))
        return {
            "valid": bool(valid),
            "invalid_reason": invalid_reason,
            "schedule_timed": "gpipe",
            "micros_timed": [int(v) for v in micros],
            "times_s": [float(t) for t in times],
            "fit_r2": r2,
            "tick_s": float(tick_s),
            "measured_extra_ticks": float(extra_ticks),
            "measured_bubble_fraction": float(measured),
            "closed_form_bubble_fraction": self.bubble_fraction,
            "num_stages": self.num_stages,
            "micro_batches": m,
        }

    def describe(self) -> dict:
        return {
            "mesh": dict(self.sizes),
            "num_stages": self.num_stages,
            "layers_per_stage": self.layers_per_stage,
            "micro_batches": self.cfg.micro_batches,
            "pp_schedule": self.cfg.pp_schedule,
            "bubble_fraction": self.bubble_fraction,
            "dtype": str(self.compute_dtype).removeprefix("torch."),
        }
