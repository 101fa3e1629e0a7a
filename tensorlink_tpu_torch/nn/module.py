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
The per-parameter ``PartitionSpec`` half of the reference
(``param_spec``, ``spec_tree_to_shardings``) belongs with the sharded
trainer and is not here.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device

_CONFIG_TYPES = (int, float, str, bool, tuple, type(None))


class Module(nn.Module):
    """``nn.Module`` plus the reference's ``config()``."""

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
