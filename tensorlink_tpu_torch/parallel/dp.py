"""Data parallelism and FSDP (port of ``tensorlink_tpu/parallel/dp.py``).

Replicated DP: every rank of the ``data`` axis holds the whole params,
takes its block of the batch's rows, and the gradients are averaged over
the ``data`` group before the non-finite sentinel and the clip
(``dp_train_step``; the reference's SPMD partitioner inserts the same
all-reduce from the shardings).

FSDP (ZeRO-3): params AND optimizer moments are split over ``data`` on
one dim each (``fsdp_spec``: the largest free dim that ``data`` divides,
ties to the last), all-gathered before use and their gradients
reduce-scattered (mean) back to the blocks (``fsdp_train_step``;
``ShardedTrainer(cfg.fsdp)`` does the same inside the pipeline). Leaves
under ``FSDP_MIN_ELEMS`` stay replicated. The spec functions are pure
and pick the reference's dim for every shape.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from tensorlink_tpu_torch.nn.module import NamedSharding, P, is_spec
from tensorlink_tpu_torch.train.trainer import GradSync

# the collectives' current names where this torch has them (the older
# names warn of deprecation on newer releases)
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# leaves smaller than this stay replicated: a gather per use of a tiny
# bias/layernorm costs more in collective latency than the bytes it saves
FSDP_MIN_ELEMS = 2**16


def dp_shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows (its ``data`` coordinate's block of dim 0)."""
    sh = NamedSharding(mesh, P("data"))
    return {k: sh.local(torch.as_tensor(v)) for k, v in batch.items()}


def all_reduce_flat(tensors: list[torch.Tensor], group, *,
                    mean: bool = True) -> list[torch.Tensor]:
    """The sum (``mean``: the mean) over ``group`` of each tensor, in ONE
    f32 all-reduce of their flat concatenation (an identity on a group of
    one)."""
    n = dist.get_world_size(group)
    if n == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= n
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


class DataParallelSync(GradSync):
    """``Trainer._step``'s gradients averaged over a data group: each rank
    holds the whole params; the loss and every gradient leaf are
    mean-reduced in one all-reduce, after the micro-batch loop and before
    the sentinel and the clip, so every rank takes the same update."""

    def __init__(self, group):
        self.group = group

    def reduce(self, loss, grads):
        names = list(grads)
        red = all_reduce_flat([loss.float()] + [grads[k] for k in names], self.group)
        return red[0], dict(zip(names, red[1:]))


def dp_train_step(train_step: Callable, mesh) -> Callable:
    """Wrap a ``Trainer``'s step so that each rank steps on its rows of
    the batch with replicated state: ``dp_train_step(trainer._step,
    mesh)(state, batch, rng)``, the batch global. The trainer's own step
    runs (micro-batches, LoRA masking, sentinel, clip, skip) with its
    gradients averaged over the ``data`` group (``DataParallelSync``);
    the reported loss is the mean over the group."""
    trainer = getattr(train_step, "__self__", train_step)
    sync = DataParallelSync(mesh.get_group("data"))

    def wrapped(state, batch, rng=None):
        return trainer._step(state, trainer._batch(dp_shard_batch(batch, mesh)), rng,
                             sync=sync)

    return wrapped


def fsdp_spec(spec, shape: tuple, data_size: int, *, axis: str = "data",
              min_elems: int = FSDP_MIN_ELEMS):
    """Add ``axis`` to one un-split dim of ``spec``: the LARGEST eligible
    dim (ties to the LAST, so square weights split the output-feature
    dim). ``spec`` comes back unchanged when the leaf is too small, every
    dim is taken, or nothing divides ``data_size``."""
    if data_size <= 1:
        return spec
    n = 1
    for d in shape:
        n *= d
    if n < min_elems:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cand = [i for i, (e, d) in enumerate(zip(entries, shape))
            if e is None and d % data_size == 0]
    if not cand:
        return spec
    best = max(cand, key=lambda i: (shape[i], i))
    entries[best] = axis
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def fsdp_spec_tree(spec_tree, params, data_size: int, *, axis: str = "data",
                   min_elems: int = FSDP_MIN_ELEMS):
    """``fsdp_spec`` over a (spec tree, param tree) pair of nested dicts
    (param leaves: anything with ``.shape``; a parameterless subtree such
    as a ``Dropout``'s ``{}`` may be absent from the params)."""
    if is_spec(spec_tree):
        return fsdp_spec(spec_tree, tuple(params.shape), data_size, axis=axis,
                         min_elems=min_elems)
    return {k: fsdp_spec_tree(v, params[k] if is_spec(v) or v else {}, data_size, axis=axis,
                              min_elems=min_elems)
            for k, v in spec_tree.items()}


def fsdp_dim(spec, axis: str = "data") -> int | None:
    """The dim ``spec`` splits over ``axis`` (None: not split over it)."""
    for d in range(len(spec)):
        if axis in spec.axes(d):
            return d
    return None


def fsdp_gather(block: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from this rank's ``block`` along ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return block
    src = block.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_into(out, src, group=group)
    return out.movedim(0, dim)


def fsdp_reduce_scatter(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of the mean over ``group`` of ``full`` along
    ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return full
    src = full.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _reduce_scatter(out, src, group=group)
    out /= n
    return out.movedim(0, dim).contiguous()


class FSDPSync(GradSync):
    """``Trainer._step`` over params split on ``data``: ``dims`` names the
    dim each leaf is split on (None: replicated). The forward runs on the
    gathered params; the gradients come back reduce-scattered (mean) to
    this rank's blocks, replicated leaves all-reduced (mean); the norm
    sums the blocks' squares over the group, each replicated leaf counted
    once; a non-finite block on any rank flags the step on all."""

    def __init__(self, group, dims: dict):
        self.group, self.dims = group, dims
        self.n = dist.get_world_size(group)

    def gather(self, params):
        return {k: (v if self.dims[k] is None else fsdp_gather(v, self.dims[k], self.group))
                for k, v in params.items()}

    def reduce(self, loss, grads):
        rep = [k for k in grads if self.dims[k] is None]
        red = all_reduce_flat([loss.float()] + [grads[k] for k in rep], self.group)
        out = dict(zip(rep, red[1:]))
        out.update({k: fsdp_reduce_scatter(g, self.dims[k], self.group)
                    for k, g in grads.items() if self.dims[k] is not None})
        return red[0], {k: out[k] for k in grads}

    def any(self, flag):
        f = flag.to(torch.float32)
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=self.group)
        return f > 0

    def global_norm(self, grads):
        sq = sum(g.float().square().sum() / (1 if self.dims[k] is not None else self.n)
                 for k, g in grads.items())
        dist.all_reduce(sq, group=self.group)
        return sq.sqrt()


def fsdp_train_step(train_step: Callable, mesh, state,
                    min_elems: int = FSDP_MIN_ELEMS):
    """``dp_train_step``'s FSDP sibling for the single-device ``Trainer``
    path: params and moments split over ``data`` by ``fsdp_spec``
    (moments share their param's shape, so the same spec lands on both).
    The trainer's own step runs on the blocks through ``FSDPSync``: it
    gathers the params for the forward, reduce-scatters the gradients
    to the blocks, and updates the blocks (micro-batches, LoRA masking,
    sentinel, clip by the group norm, skip: all the trainer's). Returns
    (wrapped_step, sharded_state); feed the returned state to the first
    call. ``gather`` on the wrapped step rebuilds the whole state."""
    from tensorlink_tpu_torch.train.trainer import TrainState

    trainer = getattr(train_step, "__self__", train_step)
    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    dims = {k: fsdp_dim(fsdp_spec(P(), tuple(p.shape), n, min_elems=min_elems))
            for k, p in state.params.items()}
    sync = FSDPSync(group, dims)

    def cut(tree):
        return {k: (v if dims[k] is None else
                    v.chunk(n, dims[k])[dist.get_rank(group)].contiguous())
                for k, v in tree.items()}

    sharded = TrainState(
        params=cut(state.params),
        opt_state={k: cut(v) for k, v in state.opt_state.items()},
        step=state.step.clone())

    def step(st, batch, rng=None):
        return trainer._step(st, trainer._batch(dp_shard_batch(batch, mesh)), rng,
                             sync=sync)

    step.gather = lambda st: TrainState(
        params=sync.gather(st.params),
        opt_state={k: sync.gather(v) for k, v in st.opt_state.items()}, step=st.step)
    return step, sharded
