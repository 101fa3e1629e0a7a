"""LoRA: low-rank adapters for parameter-efficient fine-tuning (port of
``tensorlink_tpu/nn/lora.py``).

The adapters live inside each targeted ``Dense`` as parameters
``lora_a`` [in, r], ``lora_b`` [r, out] and the 0-d f32 ``lora_s``
(alpha / r), so their state-dict names are the JAX tree's key for key
(``bert.encoder.0.attn.q.lora_a``) and ``convert.params_from_jax`` loads
a JAX LoRA tree unchanged. ``Dense.forward`` adds ``((x @ a) @ b) * s``
when they are present. Every function acts in place on the module and
returns it.

Freezing: ``Trainer(cfg with train_only="lora")`` trains only the leaves
whose name holds an adapter key (``LORA_KEYS``). The reference zeroes the
frozen leaves' gradients with ``mask_to_lora`` before clipping and their
updates after the optimizer; the port's eager step asks autograd for the
adapters' gradients alone (so the frozen weights' dW products are never
computed) and uses exact zeros for the rest, which gives the same state.
``lora_merge`` folds the adapters into ``w`` for serving at base-model
cost (and composes with int8 quantization). ``lora_spec_tree`` patches
a ``param_spec`` tree for adapted params, as the reference's does.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from tensorlink_tpu_torch.nn.layers import Dense
from tensorlink_tpu_torch.utils.trees import nest

LORA_KEYS = ("lora_a", "lora_b")  # trainable adapter leaves
LORA_ALL = LORA_KEYS + ("lora_s",)
DEFAULT_TARGETS = ("q", "k", "v", "o", "up", "gate", "down")


def is_lora_name(name: str) -> bool:
    """True if a dotted leaf name holds an adapter key (a trainable leaf
    under ``train_only="lora"``)."""
    return any(part in LORA_KEYS for part in name.split("."))


@torch.no_grad()
def lora_init(
    module: nn.Module,
    generator: torch.Generator | None = None,
    *,
    rank: int = 8,
    alpha: float = 16.0,
    targets: tuple | None = DEFAULT_TARGETS,
) -> nn.Module:
    """Add ``lora_a`` (N(0, 0.01)), ``lora_b`` (zeros), both in the base
    weight's dtype, and ``lora_s`` = alpha / rank (f32) to every ``Dense``
    whose attribute name is in ``targets`` (None: every ``Dense``, e.g. a
    ``Sequential``'s children named by index). ``b`` = 0, so the adapted
    model starts exactly at the base model. ``generator`` draws ``a`` (on
    the weights' device). Returns ``module``."""
    for name, mod in module.named_modules():
        if not isinstance(mod, Dense):
            continue
        if targets is not None and name.rsplit(".", 1)[-1] not in targets:
            continue
        if mod.quantized:
            raise ValueError(
                f"{name or 'Dense'}: adapters go on the float weight; "
                "quantize after lora_init (or after lora_merge)")
        w = mod.w
        a = torch.empty((mod.in_dim, rank), device=w.device, dtype=torch.float32)
        a.normal_(0.0, 0.01, generator=generator)
        mod.lora_a = nn.Parameter(a.to(w.dtype), requires_grad=False)
        mod.lora_b = nn.Parameter(
            torch.zeros((rank, mod.out_dim), device=w.device, dtype=w.dtype),
            requires_grad=False)
        mod.lora_s = nn.Parameter(
            torch.tensor(lora_scale(rank, alpha), device=w.device,
                         dtype=torch.float32),
            requires_grad=False)
    return module


def lora_scale(rank: int, alpha: float) -> float:
    return alpha / rank


@torch.no_grad()
def lora_merge(module: nn.Module) -> nn.Module:
    """Fold the adapters into the base weights, w += (a @ b) * s in f32
    and cast back, and drop the adapter parameters: serving then costs
    exactly the base model (and the merged module quantizes like any
    other). Returns ``module``."""
    for name, mod in module.named_modules():
        if not (isinstance(mod, Dense) and mod.has_lora):
            continue
        if mod.quantized:
            raise ValueError(f"{name or 'Dense'}: cannot merge into an int8 weight")
        delta = (mod.lora_a.float() @ mod.lora_b.float()) * mod.lora_s.float()
        mod.w.data = (mod.w.float() + delta).to(mod.w.dtype)
        for key in LORA_ALL:
            delattr(mod, key)
    return module


def _walk(tree, path: tuple, fn):
    if isinstance(tree, Mapping):
        return {k: _walk(v, path + tuple(str(k).split(".")), fn)
                for k, v in tree.items()}
    return fn(path, tree)


def lora_spec_tree(spec_tree, params):
    """Patch a ``param_spec`` tree for adapted params (nested, or a flat
    state dict): where a subtree carries ``lora_a`` beside ``w``, ``a``
    splits its in-dim like w's rows, ``b`` its out-dim like w's columns,
    and the scale is replicated. Any nesting."""
    from tensorlink_tpu_torch.nn.module import P

    def walk(spec, leaf):
        if isinstance(leaf, Mapping) and "lora_a" in leaf and "w" in leaf:
            wspec = spec["w"]
            row = wspec[0] if len(wspec) > 0 else None
            col = wspec[1] if len(wspec) > 1 else None
            return {**spec, "lora_a": P(row, None), "lora_b": P(None, col),
                    "lora_s": P()}
        if isinstance(leaf, Mapping) and isinstance(spec, Mapping):
            return {k: (walk(spec[k], leaf[k]) if k in spec else spec.get(k))
                    for k in leaf}
        return spec

    if not any(isinstance(v, Mapping) for v in params.values()):
        params = nest(params)
    return walk(spec_tree, params)


def mask_to_lora(tree):
    """Zero every leaf whose name holds no adapter key: a flat state dict
    (dotted names) or a nested dict of tensors."""
    return _walk(tree, (), lambda path, t: t if any(
        p in LORA_KEYS for p in path) else torch.zeros_like(t))


def trainable_leaf_count(params: Any) -> tuple[int, int]:
    """(adapter, total) parameter counts of a module (its state dict) or
    a flat or nested dict of tensors."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    counts = [0, 0]

    def count(path, t):
        n = t.numel()
        counts[1] += n
        if any(p in LORA_KEYS for p in path):
            counts[0] += n

    _walk(params, (), count)
    return counts[0], counts[1]
