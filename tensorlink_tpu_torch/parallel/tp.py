"""Tensor parallelism, Megatron style (port of ``tensorlink_tpu/parallel/tp.py``).

Each module declares its weights' ``PartitionSpec``s (``Module.param_spec``);
``shard_params`` cuts a parameter dict to this rank's blocks by them. The
reference lets XLA's partitioner insert the collectives; here the layers
insert them where it does, through two ``torch.autograd.Function``s over
the active ``model`` group (``model_parallel``):

- ``copy_to_model``: identity forward, all-reduce (sum) backward — in
  front of a column-parallel product, whose input is replicated and whose
  input gradient is a partial sum on each rank;
- ``reduce_from_model``: all-reduce (sum) forward, identity backward —
  after a row-parallel product, whose output is a partial sum;
- ``gather_from_model``: all-gather on the last dim forward, this rank's
  slice backward — vocab-sharded logits before the loss.

Expert parallelism's all_to_all form (``nn/moe.py`` under
``parallel.ep.ep_parallel``) adds three, each its reverse collective as
its backward:

- ``scatter_rows_to_model``: this rank's block of the batch rows
  forward, an all-gather of the row gradients backward;
- ``all_to_all_model``: the tiled ``all_to_all_single`` swap of the
  dispatched tokens (the reverse swap backward);
- ``gather_rows_to_model``: an all-gather of the rows forward, this
  rank's rows of the gradient backward.

A layer takes the tensor-parallel form when the weight it is handed is a
block of its declared shape (``Dense.w`` narrower than ``out_dim`` under
"col", shorter than ``in_dim`` under "row"; an ``Embedding`` table shorter
than ``vocab_size``); a whole weight runs the plain product, so a
replicated head beside sharded blocks needs no flag. Attention reads its
local head count from the projected width. A group of size 1 makes every
collective an identity, and so does a meta tensor (the sharded trainer's
shape probe).

Each helper counts the collectives it issues in a plain integer, as the
kernel wrappers count their launches: ``copy_to_model.collectives``
(backward all-reduces), ``reduce_from_model.collectives`` and
``gather_from_model.collectives`` and the three above (each swap,
forward or backward, counts one in ``all_to_all_model.collectives``);
``collective_counts()`` reads them and ``reset_collectives()`` zeroes
them. An identity (size 1, meta) counts nothing; the expert-parallel
three never see a meta tensor (only an embedding runs in the trainer's
shape probe). A serving model call on a model axis of size > 1 issues
two all-reduces a block (attention ``o``, the MLP's ``down``, or a MoE
layer's summed partial combines) and one gather of a vocab-sharded
head.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

_GROUP: list = [None]  # the active model-axis process group


@contextlib.contextmanager
def model_parallel(group):
    """Run the enclosed forward (and its backward, which autograd runs
    with the group captured) with ``group`` as the ``model`` axis."""
    prev = _GROUP[0]
    _GROUP[0] = group
    try:
        yield
    finally:
        _GROUP[0] = prev


def model_group():
    """The active model group; raises when a sharded weight is used
    outside ``model_parallel`` (its partial sums would be returned)."""
    g = _GROUP[0]
    if g is None:
        raise RuntimeError(
            "a tensor-parallel weight block was used outside "
            "parallel.tp.model_parallel(group)")
    return g


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, helper) -> torch.Tensor:
    if _size(group) == 1 or x.is_meta:  # a meta tensor carries a shape only
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    helper.collectives += 1
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, copy_to_model), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, reduce_from_model)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = _size(group)
        ctx.group, ctx.n = group, n
        if n == 1:
            return x.view_as(x)
        if x.is_meta:
            return x.new_empty(x.shape[:-1] + (n * x.shape[-1],))
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        gather_from_model.collectives += 1
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        if ctx.n == 1:
            return g, None
        r = dist.get_rank(ctx.group)
        return g.chunk(ctx.n, dim=-1)[r].contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, model_group())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, model_group())


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    return _GatherFromModel.apply(x, model_group())


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int):
    """Tiled all-to-all (``lax.all_to_all(tiled=True)``): ``x`` is cut into
    n chunks along ``split_dim``, chunk j goes to rank j, and the n chunks
    received are concatenated along ``concat_dim`` in rank order. gloo
    carries CUDA tensors here (``parallel/sp.py``)."""
    n = _size(group)
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _swap(x, group, split_dim: int, concat_dim: int):
    if _size(group) == 1:
        return x
    all_to_all_model.collectives += 1
    return _all_to_all(x, group, split_dim, concat_dim)


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _swap(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, *ctx.args), None, None, None


def _rows(x, group):
    n, r = _size(group), dist.get_rank(group)
    return x.chunk(n, dim=0)[r].contiguous()


def _gather_rows(x, group, helper):
    n = _size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    helper.collectives += 1
    return torch.cat(parts, dim=0)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.group, scatter_rows_to_model), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_rows(x, group, gather_rows_to_model)

    @staticmethod
    def backward(ctx, g):
        return _rows(g, ctx.group), None


def all_to_all_model(x: torch.Tensor, split_dim: int, concat_dim: int
                     ) -> torch.Tensor:
    """The tiled swap over the model group, differentiable (the reverse
    swap backward); every swap counts one."""
    return _AllToAllModel.apply(x, model_group(), split_dim, concat_dim)


def scatter_rows_to_model(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of dim 0 of a tensor whole on every rank; the
    backward all-gathers the blocks' gradients, so the whole input's
    gradient is whole on every rank."""
    return _ScatterRows.apply(x, model_group())


def gather_rows_to_model(x: torch.Tensor) -> torch.Tensor:
    """The model group's row blocks -> the whole dim 0 on every rank;
    the backward keeps this rank's rows (every rank holds the same whole
    gradient)."""
    return _GatherRows.apply(x, model_group())


copy_to_model.collectives = 0
reduce_from_model.collectives = 0
gather_from_model.collectives = 0
all_to_all_model.collectives = 0
scatter_rows_to_model.collectives = 0
gather_rows_to_model.collectives = 0
_COUNTED = (copy_to_model, reduce_from_model, gather_from_model,
            all_to_all_model, scatter_rows_to_model, gather_rows_to_model)


def collective_counts() -> dict[str, int]:
    """{helper name: collectives issued} since the last reset."""
    return {f.__name__: f.collectives for f in _COUNTED}


def reset_collectives() -> None:
    for f in _COUNTED:
        f.collectives = 0


def model_rank() -> int:
    return dist.get_rank(model_group())


def shard_params(params: dict, module, mesh, model_axis: str = "model") -> dict:
    """This rank's blocks of a flat parameter dict (``module``'s dotted
    names), cut by ``module.param_spec(model_axis)`` (adapters by
    ``lora_spec_tree``, int8 weights ``….w.q`` / ``….w.s`` by
    ``ops.quant.quantized_spec_tree``) on ``mesh``."""
    from tensorlink_tpu_torch.nn.lora import lora_spec_tree
    from tensorlink_tpu_torch.nn.module import NamedSharding, flat_specs
    from tensorlink_tpu_torch.ops.quant import quantized_spec_tree

    specs = lora_spec_tree(module.param_spec(model_axis), params)
    specs = flat_specs(quantized_spec_tree(specs, params))
    return {k: NamedSharding(mesh, specs[k]).local(v).contiguous()
            for k, v in params.items()}


def tp_jit(fn: Callable, module, mesh, model_axis: str = "model",
           batch_spec=None, out_spec=None) -> Callable:
    """A callable running ``fn(params, x)`` with ``params`` cut to this
    rank's blocks by the module's specs and the model group of ``mesh``
    active. Nothing is compiled (the name is the reference's, whose
    version jits): each call runs eagerly, and the layers insert the
    collectives. ``batch_spec``/``out_spec`` are accepted for the
    reference's signature: the input and output are whole on every rank
    of the model group."""
    group = mesh.get_group(model_axis)

    def run(params, x, *args, **kwargs):
        local = shard_params(params, module, mesh, model_axis)
        with model_parallel(group):
            return fn(local, x, *args, **kwargs)

    return run
