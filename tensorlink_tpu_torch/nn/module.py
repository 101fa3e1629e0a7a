"""The spec-shipping module system (port of ``tensorlink_tpu/nn/module.py``).

A worker never receives code: it receives a module's ``config()`` (plain
data) and its weights, and rebuilds the module with
``module_from_config``. Every module of the port derives from
:class:`Module`, an ``nn.Module`` whose ``config()`` follows the
reference's rule: the public int, float, str, bool, tuple and None
attributes (PyTorch's own ``training`` flag excepted), ``__type__`` and,
for a module with children, ``__children__``. Constructor arguments keep
the reference's names and ``device`` / ``dtype`` are keyword-only, so a
config the JAX package wrote rebuilds the port's counterpart.

Containers: ``Sequential`` (children "0".."N-1", sliced by index or
slice), ``Lambda`` (an activation registered by name), ``Parallel``
(branches combined by add, mul or concat) and the carry-packing
wrappers ``AppendTail``, ``TailMap`` and ``CombineTail``. Every forward
takes the keywords its container passes on (``rng``, ``train``, ...);
the dropout ``rng`` is one ``torch.Generator`` handed to each child in
turn (the reference folds a per-layer key; the draws differ either way).
Sharding specs: ``Module.param_spec(model_axis)`` returns a nested dict
mirroring the module's parameter tree (the reference's key layout, with
``{}`` for parameterless children such as ``Dropout``) whose leaves are
:class:`PartitionSpec` tuples, the port's own copy of
``jax.sharding.PartitionSpec``: entry i names the mesh axis (or tuple of
axes) that dim i is split over, None for a whole dim.
``spec_tree_to_shardings`` turns such a tree into :class:`NamedSharding`
placements on a ``torch.distributed`` ``DeviceMesh``: which dims this
rank slices, over which axes, and the slice itself.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device

_CONFIG_TYPES = (int, float, str, bool, tuple, type(None))


class PartitionSpec(tuple):
    """``PartitionSpec("pipe", None, "model")``: per dim, the mesh axis
    (or tuple of axes) it is split over, or None. Trailing dims not
    named are whole, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dim ``dim`` is split over (empty: whole)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return tuple(e) if isinstance(e, tuple) else (e,)


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class Module(nn.Module):
    """``nn.Module`` plus the reference's ``config()`` and
    ``param_spec()``."""

    def param_spec(self, model_axis: str = "model") -> dict[str, Any]:
        """PartitionSpec tree mirroring the parameter tree. Default:
        children recurse; leaf modules override."""
        return {name: m.param_spec(model_axis) for name, m in self._modules.items()
                if isinstance(m, Module)}

    def config(self) -> dict[str, Any]:
        """Serializable hyperparameter description (for spec shipping)."""
        out = {
            k: v for k, v in self.__dict__.items()
            if not k.startswith("_") and k != "training"
            and isinstance(v, _CONFIG_TYPES)
        }
        out["__type__"] = type(self).__name__
        children = {n: m.config() for n, m in self._modules.items()
                    if isinstance(m, Module)}
        if children:
            out["__children__"] = children
        return out


def _combine(outs: list[torch.Tensor], combine: str) -> torch.Tensor:
    if combine == "concat":
        return torch.cat(outs, dim=-1)
    acc = outs[0]
    for o in outs[1:]:
        acc = acc + o if combine == "add" else acc * o
    return acc


class Sequential(Module):
    """Chain of modules; params keyed "0", "1", ... (the unit the
    pipeline partitioner slices)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)

    @property
    def layers(self) -> list[nn.Module]:
        return list(self._modules.values())

    def forward(self, x, **kwargs):
        for layer in self._modules.values():
            x = layer(x, **kwargs)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(self.layers[idx])
        return self.layers[idx]

    def __len__(self) -> int:
        return len(self._modules)


class Lambda(Module):
    """A stateless function as a module (activations, reshapes)."""

    def __init__(self, fn: Callable, name: str = "lambda"):
        super().__init__()
        self.name = name
        self._fn = fn

    def forward(self, x, **_):
        return self._fn(x)


class Parallel(Module):
    """N branches over the same input, combined elementwise or by
    feature concat. Children "0".."N-1"."""

    COMBINES = ("add", "mul", "concat")

    def __init__(self, branches: Sequence[nn.Module], combine: str = "add"):
        super().__init__()
        if combine not in self.COMBINES:
            raise ValueError(f"combine must be one of {self.COMBINES}")
        self.combine = combine
        for i, b in enumerate(branches):
            self.add_module(str(i), b)

    @property
    def branches(self) -> list[nn.Module]:
        return list(self._modules.values())

    def forward(self, x, **kwargs):
        return _combine([b(x, **kwargs) for b in self._modules.values()],
                        self.combine)


class AppendTail(Module):
    """z -> concat([z, z[..., :width]], -1): re-append the carried input
    at the tail so the next branch's chain can consume it."""

    def __init__(self, width: int):
        super().__init__()
        self.width = width

    def forward(self, z, **_):
        return torch.cat([z, z[..., :self.width]], dim=-1)


class TailMap(Module):
    """z = [prefix | h] -> [prefix | inner(h)]: one chain unit on the
    tail segment, the prefix carried through. Child "inner"."""

    def __init__(self, inner: nn.Module, head_width: int):
        super().__init__()
        self.head_width = head_width
        self.inner = inner

    def forward(self, z, **kwargs):
        h = self.inner(z[..., self.head_width:], **kwargs)
        return torch.cat([z[..., :self.head_width], h], dim=-1)


class CombineTail(Module):
    """z = [x | a_1 .. a_n] -> combine(a_i): drop the carried input and
    merge the branch outputs (``Parallel.combine`` semantics)."""

    def __init__(self, combine: str, x_width: int, widths: Sequence[int]):
        super().__init__()
        if combine not in Parallel.COMBINES:
            raise ValueError(f"combine must be one of {Parallel.COMBINES}")
        self.combine = combine
        self.x_width = x_width
        self.widths = tuple(widths)

    def forward(self, z, **_):
        outs, off = [], self.x_width
        for w in self.widths:
            outs.append(z[..., off:off + w])
            off += w
        return _combine(outs, self.combine)


# ----------------------------------------------------------------- specs

MODULE_TYPES: dict[str, type] = {}

_ACTIVATION_FNS: dict[str, Callable] = {}


def register_module_type(cls: type) -> type:
    MODULE_TYPES[cls.__name__] = cls
    return cls


def register_activation(name: str, fn: Callable) -> None:
    _ACTIVATION_FNS[name] = fn


for _cls in (AppendTail, CombineTail):
    register_module_type(_cls)
del _cls


def module_from_config(cfg: Mapping[str, Any], *, device=None,
                       dtype: torch.dtype = torch.float32) -> Module:
    """Rebuild a module from a ``config()`` dict (the port's or the JAX
    package's). Composite modules that build their own children are
    rebuilt from their constructor arguments; ``Sequential``,
    ``Parallel`` and ``TailMap`` rebuild their children recursively;
    ``Lambda`` maps back to a registered activation by name. Parameters
    land on ``device`` (CUDA unless told otherwise) in ``dtype``,
    allocated but not filled: load the shipped weights, or
    ``init_module``."""
    dev = resolve_device(device)
    kw = {"device": dev, "dtype": dtype}
    t = cfg.get("__type__")
    if t in ("Sequential", "Parallel"):
        children = cfg.get("__children__", {})
        mods = [module_from_config(children[i], **kw)
                for i in sorted(children, key=int)]
        if t == "Sequential":
            return Sequential(mods)
        return Parallel(mods, combine=cfg.get("combine", "add"))
    if t == "TailMap":
        return TailMap(module_from_config(cfg["__children__"]["inner"], **kw),
                       head_width=cfg["head_width"])
    if t == "Lambda":
        name = cfg.get("name", "")
        if name not in _ACTIVATION_FNS:
            raise ValueError(f"unknown activation {name!r}")
        return Lambda(_ACTIVATION_FNS[name], name=name)
    cls = MODULE_TYPES.get(t)
    if cls is None:
        raise ValueError(f"unknown module type {t!r}")
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: cfg[k] for k in params if k != "self" and k in cfg}
    kwargs.update({k: v for k, v in kw.items() if k in params})
    return cls(**kwargs)


class NamedSharding:
    """A ``PartitionSpec`` placed on a mesh (anything with the
    ``DeviceMesh`` methods ``size(dim)`` and ``get_local_rank(name)`` and
    ``mesh_dim_names``): dim i of a global tensor is cut into as many
    equal blocks as the product of its axes' sizes, and this rank holds
    the block at its coordinate (axes row-major, the first slowest)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def _size(self, axis: str) -> int:
        return self.mesh.size(list(self.mesh.mesh_dim_names).index(axis))

    def dims(self) -> dict[int, tuple[str, ...]]:
        """{dim: axes} for every dim split over an axis of size > 1."""
        out = {}
        for d in range(len(self.spec)):
            axes = tuple(a for a in self.spec.axes(d) if self._size(a) > 1)
            if axes:
                out[d] = axes
        return out

    def block(self, dim: int) -> tuple[int, int]:
        """(this rank's block index, block count) along ``dim``."""
        idx, n = 0, 1
        for a in self.spec.axes(dim):
            k = self._size(a)
            idx = idx * k + self.mesh.get_local_rank(a)
            n *= k
        return idx, n

    def shard_shape(self, shape) -> tuple[int, ...]:
        out = list(shape)
        for d in self.dims():
            _, n = self.block(d)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {n} blocks ({self.spec})")
            out[d] //= n
        return tuple(out)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``t`` (a view)."""
        self.shard_shape(t.shape)
        for d in self.dims():
            i, n = self.block(d)
            t = t.chunk(n, dim=d)[i]
        return t

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def flat_specs(spec_tree, prefix: str = "") -> dict[str, PartitionSpec]:
    """Nested spec tree -> {dotted leaf name: spec} (the state-dict
    names of the parameters it mirrors)."""
    if is_spec(spec_tree):
        return {prefix: spec_tree}
    out = {}
    for k, v in spec_tree.items():
        out.update(flat_specs(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def spec_tree_to_shardings(spec_tree, mesh):
    """PartitionSpec tree -> ``NamedSharding`` tree on ``mesh``."""
    if is_spec(spec_tree):
        return NamedSharding(mesh, spec_tree)
    return {k: spec_tree_to_shardings(v, mesh) for k, v in spec_tree.items()}


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator | int | None = None,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """Fill every parameter (each submodule's ``reset_parameters``, from
    ``generator`` or a seed on the parameters' device), then cast the
    floating parameters to ``dtype``, in place. Returns ``module``."""
    if isinstance(generator, int):
        first = next(module.parameters(), None)
        dev = first.device if first is not None else torch.device("cpu")
        generator = torch.Generator(device=dev).manual_seed(generator)
    for mod in module.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


def param_tree(module: nn.Module, state: Mapping[str, Any] | None = None) -> dict:
    """``module``'s parameters as the JAX package's nested param tree: one
    dict per child module, ``{}`` for a child that holds no parameter (a
    ``Lambda``, a ``Dropout``), leaves from ``state`` (a flat state dict;
    default the module's own parameters). The layout a reference node
    unflattens: ``tree_flatten_arrays`` of it gives the reference's names,
    ``//empty`` markers included."""
    state = dict(module.named_parameters()) if state is None else state

    def walk(mod: nn.Module, prefix: str) -> dict:
        out: dict = {}
        for name, _ in mod.named_parameters(recurse=False):
            out[name] = state[prefix + name]
        for name, child in mod.named_children():
            out[name] = walk(child, f"{prefix}{name}.")
        return out

    return walk(module, "")
