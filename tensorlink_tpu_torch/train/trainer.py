"""Single-device training engine (port of ``tensorlink_tpu/train/trainer.py``):
``TrainState``, ``Trainer``, and the losses.

The step is eager PyTorch. Master params and optimizer moments stay f32;
the loss runs on a copy of every floating param cast to ``cfg.dtype``
(``torch.func.functional_call`` in the caller's ``loss_fn``), so the
gradients land in f32 on the masters. Gradient accumulation runs over
``cfg.micro_batches`` slices of the batch. The non-finite sentinel is
computed on the device before clipping, and no step reads the device
from the host: ``train_step`` returns its stats as device tensors. A
trainer built with ``tracer``/``metrics`` reads the non-finite flag once
a step for its telemetry, as the reference's does.

``train_only="lora"`` trains the adapter leaves alone (``nn/lora.py``):
autograd is asked for their gradients only, so the frozen weights' dW
products are never computed, and the other leaves take exact zeros,
which is what the reference's ``mask_to_lora`` leaves before its
non-finite sentinel and clipping. The optimizer still keeps moments for
every leaf (a checkpoint has the reference's keys); a frozen leaf's
update is zero, as the reference masks it, so it keeps its tensor and
AdamW's decoupled decay never moves it.

``GradSync`` is where a step's gradients meet those of other ranks:
``_step`` runs with the identity on one device, and ``parallel.dp``'s
data-parallel and FSDP wrappers hand it their own, so the micro-batch
loop, the LoRA masking, the sentinel, the clip and the skip are this
one step's under every wrapper.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.config import TrainConfig
from tensorlink_tpu_torch.nn.lora import is_lora_name
from tensorlink_tpu_torch.runtime.flight import default_recorder
from tensorlink_tpu_torch.runtime.profiling import DispatchTimer
from tensorlink_tpu_torch.runtime.tracing import StepTelemetry
from tensorlink_tpu_torch.train.optim import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
    make_optimizer,
    make_schedule,
)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE; labels are int ids. Computed in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean()


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: Any
    step: torch.Tensor  # 0-d int32 on the params' device

    @classmethod
    def create(cls, params, optimizer: Optimizer) -> "TrainState":
        device = next(iter(params.values())).device
        return cls(
            params=params,
            opt_state=optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )


class GradSync:
    """How one step's gradients meet those of the other ranks of its
    group. The identity (one device); ``parallel.dp`` supplies the
    data-parallel and FSDP forms."""

    def gather(self, params: dict) -> dict:
        """The whole params the forward runs with, from this rank's."""
        return params

    def reduce(self, loss, grads: dict):
        """The group's (loss, grads), from this rank's; the grads take
        the layout of this rank's params."""
        return loss, grads

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """``flag`` true on any rank of the group."""
        return flag

    def global_norm(self, grads: dict) -> torch.Tensor | None:
        """The norm of the group's whole gradient (None: the norm of
        ``grads``)."""
        return None


def _where(cond: torch.Tensor, old, new):
    """``new`` with every tensor replaced by ``old``'s where ``cond``."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, old, new)
    if isinstance(new, dict):
        return {k: _where(cond, old[k], v) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(_where(cond, o, n) for o, n in zip(old, new))
    return new


def note_nonfinite(trainer, state: TrainState, stats: dict) -> None:
    """The reference's non-finite accounting of an instrumented trainer
    (``Trainer`` or ``ShardedTrainer``) after a poisoned step: the
    ``train_nonfinite_total`` counter and a ``train_nonfinite`` event."""
    if trainer.metrics is not None:
        trainer.metrics.incr("train_nonfinite_total")
    if trainer.flight is not None:
        trainer.flight.record(
            "train_nonfinite", "error", step=int(state.step),
            loss=float(stats["loss"]),
            skipped=trainer.cfg.skip_nonfinite_updates,
        )


class Trainer:
    """Train steps for a (module, loss_fn) pair on one device.

    ``loss_fn(module, params, batch, rng) -> scalar loss``: ``params`` is a
    dict of the module's parameters, already cast to the compute dtype,
    to run the module with (``torch.func.functional_call(module, params,
    args, kwargs)``); ``rng`` is the caller's ``torch.Generator`` for
    dropout, or None. The Trainer owns the optimizer state, clipping, the
    dtype policy and gradient accumulation.

    ``device``: where the state lives (CUDA unless ``device="cpu"``; no
    silent CPU fallback). ``donate`` is accepted for the reference's
    signature (the step never updates its input state in place).
    ``tracer``/``metrics`` turn on the reference's step telemetry: a
    ``trainer.step`` span (``trainer.compile_step`` for the first call of
    a batch signature) with the ``step_s`` / ``compile_s`` series, a
    ``DispatchTimer`` on CUDA events (``device_time()``), ``data_span()``,
    and the non-finite accounting (``train_nonfinite_total``, a
    ``train_nonfinite`` event to ``flight``, by default the process's
    recorder). That path reads one flag from the device a step; an
    uninstrumented trainer reads nothing. ``train_only="lora"`` trains
    only the adapters of a module that went through ``nn.lora.lora_init``
    (module docstring).
    ``fsdp=True`` raises the reference's ``ValueError``: a single-device
    trainer cannot shard params and moments.
    """

    def __init__(
        self,
        module: torch.nn.Module,
        loss_fn: Callable,
        cfg: TrainConfig = TrainConfig(),
        optimizer: Optimizer | None = None,
        donate: bool = True,
        tracer=None,
        metrics=None,
        flight=None,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        if cfg.fsdp:
            # a mode this class cannot honor fails loudly, not silently
            # replicated (the reference's message, word for word)
            raise ValueError(
                "TrainConfig(fsdp=True) has no effect on the single-host "
                "Trainer: wrap its ._step with "
                "parallel.dp.fsdp_train_step(step, mesh, state) (which "
                "shards params+moments over the data axis), or use "
                "ShardedTrainer on a mesh with a data axis"
            )
        self.lora_only = cfg.train_only == "lora"
        self.module = module
        self.loss_fn = loss_fn
        self.cfg = cfg
        sched = make_schedule(
            cfg.schedule, cfg.learning_rate, cfg.warmup_steps, cfg.total_steps
        )
        self.optimizer = optimizer or make_optimizer(
            cfg.optimizer, sched, cfg.weight_decay,
            moment_dtype=cfg.opt_moment_dtype,
        )
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.tracer = tracer
        self.metrics = metrics
        # telemetry-enabled trainers default to the process recorder: the
        # host read the anomaly check needs is paid only then
        if flight is None and (tracer is not None or metrics is not None):
            flight = default_recorder()
        self.flight = flight
        self._telemetry = None
        self._timer = None
        if tracer is not None or metrics is not None:
            self._telemetry = StepTelemetry(tracer, metrics, "trainer")
            # the device timer rides the one read the telemetry path makes
            # a step; an uninstrumented trainer stays asynchronous
            self._timer = DispatchTimer(metrics=metrics)

    # -- state ----------------------------------------------------------
    def init_state(self, params: dict[str, torch.Tensor] | None = None) -> TrainState:
        """f32 master copies of ``params`` (default: the module's own) on
        the trainer's device, and fresh optimizer state."""
        if params is None:
            params = dict(self.module.named_parameters())
        fixed = [k for k, p in params.items() if not p.is_floating_point()]
        if fixed:
            raise ValueError(f"non-floating params cannot be trained: {fixed}")
        params = {
            k: p.detach().to(self.device, torch.float32)
            for k, p in params.items()
        }
        return TrainState.create(params, self.optimizer)

    def _cast(self, params):
        return {k: p.to(self.compute_dtype) for k, p in params.items()}

    def _batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def trainable(self, name: str) -> bool:
        """Whether the leaf ``name`` trains (every leaf, or under
        ``train_only="lora"`` the adapters alone)."""
        return not self.lora_only or is_lora_name(name)

    def loss_and_grads(self, params, batch, rng=None):
        """(loss, {name: f32 grad}) of ``loss_fn`` at ``params`` (the f32
        masters), through the compute-dtype copy. A frozen leaf's grad is
        an exact zero, never computed."""
        leaves = {k: p.detach().requires_grad_(self.trainable(k))
                  for k, p in params.items()}
        wrt = [k for k in leaves if self.trainable(k)]
        if not wrt:
            raise ValueError("train_only='lora' but the params hold no "
                             "adapter (nn.lora.lora_init first)")
        loss = self.loss_fn(self.module, self._cast(leaves), batch, rng)
        grads = dict(zip(wrt, torch.autograd.grad(
            loss, [leaves[k] for k in wrt], allow_unused=True)))
        out = {
            k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
            for k, p in leaves.items()
        }
        return loss.detach(), out

    # -- the step -------------------------------------------------------
    def _step(self, state: TrainState, batch, rng, sync: GradSync | None = None):
        """One optimizer step on ``batch`` (already on the device); ``sync``
        joins the gradients to the other ranks' (default: one device)."""
        sync = sync or GradSync()
        micro = self.cfg.micro_batches
        whole = sync.gather(state.params)
        if micro <= 1:
            loss, grads = self.loss_and_grads(whole, batch, rng)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % micro:
                raise ValueError(
                    f"batch of {n} not divisible by micro_batches={micro}"
                )
            grads, losses = None, []
            for i in range(micro):
                mb = {k: v.reshape(micro, n // micro, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, g = self.loss_and_grads(whole, mb, rng)
                g = {k: x.float() / micro for k, x in g.items()}
                grads = g if grads is None else {
                    k: grads[k] + g[k] for k in grads
                }
                losses.append(loss_i)
            loss = torch.stack(losses).mean()
        loss, grads = sync.reduce(loss, grads)

        # non-finite sentinel, on the device and BEFORE clipping (clipping
        # a tree with an inf leaf turns the norm nan and poisons every
        # grad): g * 0 is 0 where g is finite and nan elsewhere
        gl = list(grads.values())
        grads_finite = torch.isfinite(
            torch.stack(torch._foreach_norm(torch._foreach_mul(gl, 0.0))).sum()
        )
        nonfinite = sync.any(~(torch.isfinite(loss) & grads_finite))
        if self.cfg.grad_clip_norm:
            grads, gnorm = clip_by_global_norm(grads, self.cfg.grad_clip_norm,
                                               norm=sync.global_norm(grads))
        else:
            gnorm = torch.zeros((), device=self.device)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params, state.step
        )
        # a frozen leaf's update is zero: it keeps its tensor
        live = [k for k in updates if self.trainable(k)]
        params = {**state.params, **apply_updates(
            {k: state.params[k] for k in live}, {k: updates[k] for k in live})}
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        if self.cfg.skip_nonfinite_updates:
            # the OLD state wholesale (params, moments, step): a poisoned
            # batch leaves no trace, not even a moment update or a
            # schedule tick
            new_state = TrainState(
                params=_where(nonfinite, state.params, new_state.params),
                opt_state=_where(nonfinite, state.opt_state, new_state.opt_state),
                step=torch.where(nonfinite, state.step, new_state.step),
            )
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "nonfinite": nonfinite}

    # -- observability ---------------------------------------------------
    def data_span(self):
        """Wrap the batch fetch: a ``trainer.data`` span and the ``data_s``
        series, so input-pipeline stalls show on the step timeline."""
        if self._telemetry is None:
            return contextlib.nullcontext()
        return self._telemetry.data()

    def device_time(self) -> dict | None:
        """Per-step device-busy vs host-gap attribution (None on an
        uninstrumented trainer): ``host_gap_frac`` is the device's idle
        share between one step's end and the next one's start."""
        return None if self._timer is None else self._timer.snapshot()

    # -- public ----------------------------------------------------------
    def train_step(self, state: TrainState, batch, rng: torch.Generator | None = None):
        """One optimizer step -> (new state, {"loss", "grad_norm",
        "nonfinite"} as device tensors). ``state`` is not modified."""
        batch = self._batch(batch)
        if self._telemetry is None:
            return self._step(state, batch, rng)
        # the first call of a signature is kept out of the device timing,
        # as the reference keeps its compile out
        disp = None
        if self._telemetry.seen(batch, rng):
            probe = None
            if self.device.type == "cuda":
                probe = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                probe[0].record()
            disp = self._timer.dispatch("train_step", probe)
        with self._telemetry.step(batch, rng):
            state, stats = self._step(state, batch, rng)
        if disp is not None and disp.probe is not None:
            disp.probe[1].record()
        # the telemetry path's one host read (the reference's)
        nonfinite = bool(stats["nonfinite"])
        if disp is not None:
            self._timer.drained(disp)  # right after the sync above
        if nonfinite:
            note_nonfinite(self, state, stats)
        return state, stats

    def eval_loss(self, state: TrainState, batch, rng=None):
        with torch.no_grad():
            return self.loss_fn(self.module, self._cast(state.params),
                                self._batch(batch), rng)
