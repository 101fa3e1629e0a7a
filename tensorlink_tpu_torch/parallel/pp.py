"""Pipeline parallelism: the GPipe schedule over the mesh's ``pipe`` group
(port of ``tensorlink_tpu/parallel/pp.py``).

Each rank of the ``pipe`` axis holds one stage: ``layers_per_stage``
consecutive blocks. The reference compiles the schedule into one SPMD
program (a ``lax.scan`` over M + S - 1 ticks with one ``ppermute`` hop a
tick, and autodiff transposes it into the reverse schedule); here every
rank runs the same M + S - 1 ticks eagerly:

- forward: at tick t stage s runs micro t - s (when 0 <= t - s < M) and
  then every rank exchanges in ONE ``batch_isend_irecv``: its output to
  s + 1, the next micro's input from s - 1;
- backward (``Pipeline.backward``): the reverse ticks, each running one
  micro's stage backward (``torch.autograd.backward`` from the received
  activation gradient) and sending its input gradient to s - 1.

A stage's input is a leaf tensor, so the gradient that crosses the stage
boundary is its ``.grad``; stage 0's inputs are detached from the
caller's embedding, whose backward the caller runs once over all micros
with the returned gradients. The bubble is the closed form
(S - 1) / (M + S - 1) (``runtime.metrics.pipeline_bubble_fraction``).

Dropout: ``rng`` is a per-micro integer seed; each layer draws its mask
from a ``torch.Generator`` seeded with ``fold_in(seed, global layer)``,
so a (micro, layer) pair gets the same mask at any pipe depth and under
either schedule (``stage_apply`` is shared with ``pp1f1b``), and a
recompute under ``remat`` redraws it exactly.

``seq_axis``: the token dim of the activations is sharded over the
mesh's seq group (``SeqShard``). Each rank cuts the micros to its token
shard (xs dim 2 of [M, mb, T, ...]), runs its stage inside
``parallel.sp.seq_parallel`` (the ring or Ulysses attention spans the
whole sequence over the group) and ``__call__`` re-assembles the outputs
over the group. The dropout stream folds in the seq rank, so the shards
draw different masks, and MoE aux is averaged over the group.

A MoE block's aux at model > 1 arrives averaged over the model group
already (``nn/moe.py``'s all_to_all form: one all-reduce of the ranks'
row shares; the fallback routes every row), so a stage sums its layers'
aux as at world 1 and the model ranks hold the same value.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tensorlink_tpu_torch.nn.module import NamedSharding, P
from tensorlink_tpu_torch.runtime.metrics import pipeline_bubble_fraction

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed from ``seed`` and ``data`` (splitmix64 rounds): the
    counterpart of ``jax.random.fold_in`` for generator seeds."""
    h = seed & _MASK64
    for d in data:
        h = (h ^ (int(d) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h >> 1


def generator(seed: int | None, device) -> torch.Generator | None:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (None:
    None, which turns dropout off)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _layer(stage_params, l: int) -> dict:
    if isinstance(stage_params, (list, tuple)):
        return stage_params[l]
    return {k: v[l] for k, v in stage_params.items()}


def stage_apply(block_fn, layers_per_stage: int, stage_params, x, rng=None,
                layer0: int = 0, extras=None, remat: bool = False):
    """Apply one stage's ``layers_per_stage`` blocks. ``stage_params``:
    a list of per-layer param dicts, or a dict of stacked [Lps, ...]
    leaves. ``rng`` is the micro's integer seed (None: no dropout); each
    layer draws from ``fold_in(rng, layer0 + l)``. ``extras`` (this
    micro's auxiliary inputs, e.g. the padding mask) are handed as a
    fourth argument. ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``; the generator is rebuilt from its seed,
    so the recompute draws the same mask). Implemented on the aux loop,
    so the two variants cannot drift."""
    wrapped = lambda lp, xx, *r: (block_fn(lp, xx, *r), 0.0)  # noqa: E731
    return stage_apply_aux(wrapped, layers_per_stage, stage_params, x, rng,
                           layer0, extras, remat)[0]


def stage_apply_aux(block_fn_aux, layers_per_stage: int, stage_params, x,
                    rng=None, layer0: int = 0, extras=None, remat: bool = False):
    """``stage_apply`` for blocks with an auxiliary loss (the MoE router's
    load balancing): ``block_fn_aux(lp, x[, rng[, extras]]) -> (x, aux)``.
    Returns (x, the stage's summed aux)."""
    aux = 0.0
    for l in range(layers_per_stage):
        lp = _layer(stage_params, l)
        seed = None if rng is None else fold_in(rng, layer0 + l)

        def run(xx, lp=lp, seed=seed):
            r = generator(seed, xx.device)
            if extras is not None:
                return block_fn_aux(lp, xx, r, extras)
            if seed is None:
                return block_fn_aux(lp, xx)
            return block_fn_aux(lp, xx, r)

        if remat and torch.is_grad_enabled():
            x, a = checkpoint(run, x, use_reentrant=False)
        else:
            x, a = run(x)
        aux = aux + a
    return x, aux


def stack_stage_params(layer_params: dict, num_stages: int):
    """{"0": p0, ..., "L-1": pL-1} (nested dicts of tensors) -> the same
    tree with [S, L/S, ...] leaves: axis 0 the stage, axis 1 the layer
    within it."""
    L = len(layer_params)
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible by {num_stages} stages")
    per = L // num_stages
    layers = [layer_params[str(i)] for i in range(L)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack([torch.stack(list(nodes[s * per:(s + 1) * per]))
                            for s in range(num_stages)])

    return stack(layers)


def unstack_stage_params(stacked, num_stages: int, layers_per_stage: int) -> dict:
    """Inverse of ``stack_stage_params``."""

    def pick(node, s, l):
        if isinstance(node, dict):
            return {k: pick(v, s, l) for k, v in node.items()}
        return node[s, l]

    return {str(s * layers_per_stage + l): pick(stacked, s, l)
            for s in range(num_stages) for l in range(layers_per_stage)}


def pipeline_sharding(mesh, axis: str = "pipe") -> NamedSharding:
    """Placement of stacked stage params (leading stage axis)."""
    return NamedSharding(mesh, P(axis))


class SeqShard:
    """This rank's token shard on the mesh's seq group: cuts [mb, T, ...]
    activations to [mb, T/S, ...] and re-assembles them."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def local_shape(self, shape) -> tuple:
        """A per-micro [mb, T, ...] shape at this rank's token count."""
        T = shape[1]
        if T % self.size:
            raise ValueError(f"sequence {T} not divisible by seq={self.size}")
        return (shape[0], T // self.size, *shape[2:])

    def cut(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's token shard of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole token dim from every rank's shard (no autograd)."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
            t = t / self.size
        return t

    def context(self):
        from tensorlink_tpu_torch.parallel.sp import seq_parallel

        return seq_parallel(self.group)


def seq_shard(mesh, seq_axis: str | None) -> SeqShard | None:
    return None if seq_axis is None else SeqShard(mesh, seq_axis)


class PipeComm:
    """This rank's place on the mesh's ``pipe`` axis and its exchanges
    with the neighbouring stages (global ranks from the pipe group)."""

    def __init__(self, mesh, axis: str = "pipe"):
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.stage = dist.get_rank(self.group)
        self.prev = (dist.get_global_rank(self.group, self.stage - 1)
                     if self.stage > 0 else None)
        self.next = (dist.get_global_rank(self.group, self.stage + 1)
                     if self.stage < self.size - 1 else None)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    def exchange(self, sends: list, recvs: list) -> None:
        """One ``batch_isend_irecv`` of (tensor, global peer) sends and
        receives, waited on; nothing to do for empty lists."""
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass
class _Run:
    """One forward pass's per-micro stage inputs, outputs and aux."""

    inputs: list
    outputs: list
    aux: list
    with_aux: bool


@dataclasses.dataclass(eq=False)
class Pipeline:
    """GPipe over the mesh's ``pipe`` axis. ``block_fn(layer_params, x)``
    applies ONE layer; each stage applies ``layers_per_stage`` of them
    from its own params."""

    mesh: Any
    block_fn: Callable
    num_stages: int
    layers_per_stage: int
    axis: str = "pipe"
    # blocks with an auxiliary loss (MoE): block_fn_aux(lp, x[, rng]) ->
    # (x, aux). Enables apply_with_aux; plain __call__ ignores it.
    block_fn_aux: Callable | None = None
    # the token-sharded seq axis (module docstring): the blocks must run
    # the ring or Ulysses attention (attn_impl "ring" / "ulysses")
    seq_axis: str | None = None
    remat: bool = False

    def __post_init__(self):
        self.seq = seq_shard(self.mesh, self.seq_axis)
        self.comm = PipeComm(self.mesh, self.axis)
        if self.comm.size != self.num_stages:
            raise ValueError(f"pipe group of {self.comm.size} ranks for "
                             f"{self.num_stages} stages")

    @property
    def bubble_fraction(self) -> Callable[[int], float]:
        return lambda m: pipeline_bubble_fraction(self.num_stages, m)

    def _stage(self, stage_params, x, seed, extras, with_aux: bool):
        layer0 = self.comm.stage * self.layers_per_stage
        if with_aux:
            return stage_apply_aux(self.block_fn_aux, self.layers_per_stage,
                                   stage_params, x, seed, layer0, extras, self.remat)
        y = stage_apply(self.block_fn, self.layers_per_stage, stage_params, x,
                        seed, layer0, extras, self.remat)
        return y, 0.0

    def forward(self, stage_params, xs, rng=None, extras=None, *,
                with_aux: bool = False, grad: bool = False, device=None) -> _Run:
        """The forward ticks. ``xs`` [M, mb, ...]: the micro inputs on
        stage 0; any tensor of their shape and dtype elsewhere (a meta
        tensor will do). ``rng``: an integer seed (micro m draws from
        ``fold_in(rng, m)``). ``extras``: a list of M per-micro inputs,
        or None. With ``grad`` every stage input is a leaf that requires
        grad and each micro's graph is kept for ``backward``."""
        S, s, comm, sq = self.num_stages, self.comm.stage, self.comm, self.seq
        M = xs.shape[0]
        dev = device if device is not None else xs.device
        run = _Run([None] * M, [None] * M, [None] * M, with_aux)
        shape = tuple(xs.shape[1:]) if sq is None else sq.local_shape(xs.shape[1:])
        if rng is not None and sq is not None:
            # each shard holds other token positions: fold its rank in, or
            # every shard would draw the same dropout masks
            rng = fold_in(rng, sq.rank)
        recv = None
        for t in range(M + S - 1):
            m = t - s
            y = None
            if 0 <= m < M:
                if comm.first:
                    x = (xs[m] if sq is None else sq.cut(xs[m])).detach()
                else:
                    x = recv
                x.requires_grad_(grad)
                seed = None if rng is None else fold_in(rng, m)
                ex = None if extras is None else extras[m]
                with torch.set_grad_enabled(grad), self._context():
                    y, a = self._stage(stage_params, x, seed, ex, with_aux)
                run.inputs[m], run.outputs[m], run.aux[m] = x, y, a
            sends, recvs, recv = [], [], None
            if y is not None and not comm.last:
                sends.append((y.detach(), comm.next))
            if not comm.first and 0 <= t + 1 - s < M:
                recv = torch.empty(shape, dtype=xs.dtype, device=dev)
                recvs.append((recv, comm.prev))
            comm.exchange(sends, recvs)
        return run

    def backward(self, run: _Run, dys=None, aux_cot: float = 0.0) -> list | None:
        """The reverse ticks: micro m's stage backward from ``dys[m]``
        (the last stage's output gradients) or the gradient received from
        s + 1, plus ``aux_cot`` on its aux loss. Parameter gradients
        accumulate in the leaves' ``.grad``. Returns stage 0's input
        gradients (a list of M), None elsewhere."""
        S, s, comm = self.num_stages, self.comm.stage, self.comm
        M = len(run.inputs)
        dxs = [None] * M
        recv = None
        for t in range(M + S - 2, -1, -1):
            m = t - s
            dx = None
            if 0 <= m < M:
                dy = dys[m] if comm.last else recv
                outs, cots = [run.outputs[m]], [dy]
                a = run.aux[m]
                if run.with_aux and aux_cot and torch.is_tensor(a) and a.requires_grad:
                    outs.append(a)
                    cots.append(torch.full_like(a, aux_cot))
                with self._context():  # a remat recompute runs the blocks
                    torch.autograd.backward(outs, cots)
                dx = run.inputs[m].grad
                run.inputs[m] = run.outputs[m] = run.aux[m] = None
                if comm.first:
                    dxs[m] = dx
            sends, recvs, recv = [], [], None
            if dx is not None and not comm.first:
                sends.append((dx, comm.prev))
            if not comm.last and 0 <= t - 1 - s < M:
                recv = self._grad_buffer(run, t - 1 - s)
                recvs.append((recv, comm.next))
            comm.exchange(sends, recvs)
        return dxs if comm.first else None

    def _context(self):
        """The seq group bound around the blocks (nothing without one)."""
        return contextlib.nullcontext() if self.seq is None else self.seq.context()

    @staticmethod
    def _grad_buffer(run: _Run, m: int) -> torch.Tensor:
        y = run.outputs[m]
        return torch.empty(y.shape, dtype=y.dtype, device=y.device)

    def _broadcast_outputs(self, run: _Run, xs) -> torch.Tensor:
        """[M, mb, ...] outputs of the last stage, on every pipe rank
        (the whole token dim, re-assembled over a seq group)."""
        comm = self.comm
        if comm.last:
            out = torch.stack(run.outputs)
        else:
            like = run.outputs[0] if run.outputs[0] is not None else None
            shape = (xs.shape[0],) + (
                tuple(like.shape) if like is not None
                else self.seq.local_shape(xs.shape[1:]) if self.seq is not None
                else tuple(xs.shape[1:]))
            out = torch.empty(shape, dtype=xs.dtype,
                              device=like.device if like is not None else xs.device)
        if comm.size > 1:
            src = dist.get_global_rank(comm.group, comm.size - 1)
            dist.broadcast(out, src, group=comm.group)
        return out if self.seq is None else self.seq.gather(out, dim=2)

    def __call__(self, stage_params, xs, rng=None, extras=None) -> torch.Tensor:
        """xs [M, mb, ...] -> outputs [M, mb, ...] (no autograd), on every
        pipe rank, as the reference returns them replicated. ``rng``
        enables dropout inside the blocks; ``extras`` (a list of M)
        reaches every block as a fourth argument."""
        with torch.no_grad():
            run = self.forward(stage_params, xs, rng, extras)
            return self._broadcast_outputs(run, xs)

    def apply_with_aux(self, stage_params, xs, rng=None, extras=None):
        """Like ``__call__`` but also returns the auxiliary loss summed
        over every (stage, micro) and divided by M (requires
        ``block_fn_aux``)."""
        if self.block_fn_aux is None:
            raise ValueError("apply_with_aux requires block_fn_aux")
        with torch.no_grad():
            run = self.forward(stage_params, xs, rng, extras, with_aux=True)
            out = self._broadcast_outputs(run, xs)
            aux = sum(torch.as_tensor(a, dtype=torch.float32, device=out.device)
                      for a in run.aux if a is not None)
            aux = self.comm.sum(torch.as_tensor(aux, dtype=torch.float32,
                                                device=out.device).clone())
            if self.seq is not None:  # each shard routed its own tokens
                aux = self.seq.mean(aux)
            return out, aux / xs.shape[0]
