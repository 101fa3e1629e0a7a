"""Carry params between the JAX package's trees and the port's modules.

The port's parameter names are the JAX param tree's keys joined with
".", so ``params_from_jax`` is a flatten plus the ``InferenceEngine``
dtype policy: >=2-D floating leaves (the matrices) go to
``param_dtype``, lower-rank floating leaves (norm scales, biases) stay
f32. ``param_dtype=torch.float32`` gives the trainer's f32 masters. A
weight-only int8 leaf (``ops/quant.py``: ``{"q": int8, "s": f32}``)
flattens to ``….w.q`` / ``….w.s`` and keeps its dtypes, which is the
state-dict layout of a quantized ``Dense``. The tree's leaves are
numpy arrays (``jax.device_get`` of a param tree, or
``np.asarray`` per leaf); ``state_dict_to_jax`` goes the other way, so
params trained in the port can be compared with the JAX package's. This
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def policy_dtype(t: torch.Tensor, param_dtype: torch.dtype) -> torch.dtype:
    """The dtype a parameter takes under the serving dtype policy."""
    if not t.is_floating_point():
        return t.dtype
    return param_dtype if t.dim() >= 2 else torch.float32


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree, param_dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """Nested dict of numpy leaves -> flat state dict for
    ``module.load_state_dict``, dtype policy applied. Empty subtrees
    (the JAX Dropout's ``{}``) have no port counterpart and vanish."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), sub)
            return
        t = _to_tensor(node)
        out[prefix] = t.to(policy_dtype(t, param_dtype))

    walk("", tree)
    return out


def state_dict_to_jax(state) -> dict:
    """Flat ``{"a.b.c": tensor}`` -> nested ``{"a": {"b": {"c": ndarray}}}``
    in the JAX param tree's shape (without the empty Dropout subtrees).
    bf16 leaves come back as f32 arrays."""
    out: dict = {}
    for name, t in state.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[leaf] = t.numpy()
    return out


@torch.no_grad()
def apply_dtype_policy(model: nn.Module, param_dtype: torch.dtype,
                       device: torch.device) -> None:
    """Move ``model``'s parameters to ``device`` under the dtype policy,
    in place. Buffers (a quantized weight's int8 ``q`` and f32 ``s``)
    move to ``device`` and keep their dtypes."""
    for p in model.parameters():
        p.data = p.data.to(device=device, dtype=policy_dtype(p.data, param_dtype))
    for mod in model.modules():
        for name, b in mod._buffers.items():
            if b is not None:
                mod._buffers[name] = b.to(device=device)
