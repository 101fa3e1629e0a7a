"""MLP classifier (port of ``tensorlink_tpu/models/mlp.py``): the
smallest end-to-end model, a ``Sequential`` of ``Dense`` layers and
activations (params ``seq.0.w``, ``seq.2.w``, ... as in the JAX tree).
``"gelu"`` is the tanh approximation, as the reference's ``jax.nn.gelu``
default is."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.layers import Dense, init_parameters
from tensorlink_tpu_torch.nn.module import Lambda, Module, Sequential
from tensorlink_tpu_torch.nn.transformer import ACTIVATIONS


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden_dim: int = 256
    out_dim: int = 10
    num_layers: int = 2
    activation: str = "relu"


class MLP(Module):
    """``MLP(cfg, device=None, dtype=torch.float32, seed=0)``: parameters
    on ``device`` (CUDA unless told otherwise), filled from ``seed``."""

    def __init__(self, cfg: MLPConfig = MLPConfig(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg_obj = cfg
        if cfg.activation not in ("relu", "gelu"):
            raise ValueError(f"unknown activation {cfg.activation!r}")
        act = ACTIVATIONS[cfg.activation]
        dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [cfg.out_dim]
        layers = []
        for i in range(cfg.num_layers):
            layers.append(Dense(dims[i], dims[i + 1], device=dev, dtype=dtype))
            if i < cfg.num_layers - 1:
                layers.append(Lambda(act, name=cfg.activation))
        self.seq = Sequential(layers)
        init_parameters(self, dev, seed)

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return self.seq(x)
