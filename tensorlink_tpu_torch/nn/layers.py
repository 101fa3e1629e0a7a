"""Core layers (port of ``tensorlink_tpu/nn/layers.py``).

Parameter names and layouts match the JAX package key for key, so its
params convert one-to-one (``convert.params_from_jax``): ``Dense.w`` is
``[in, out]`` with ``y = x @ w + b``, ``Embedding.table`` is
``[vocab, dim]``, norms carry ``scale`` (and ``bias``). Norms compute in
f32 and cast back to the input dtype; weights are cast to the
activation dtype at use, as in the JAX modules. Every forward is plain
differentiable PyTorch: the trainer takes gradients with respect to
parameters it substitutes (``torch.func.functional_call``), so the
modules' own parameters are created without ``requires_grad``.
``Dropout`` holds no parameters.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tensorlink_tpu_torch.ops.quant import QuantizedWeight, dequantize_weight


def init_parameters(module: nn.Module, device, seed: int | None) -> None:
    """Fill every parameter of ``module`` from a generator on ``device``
    seeded with ``seed`` (None leaves them as allocated): LeCun-normal
    Dense weights, N(0, 0.02) embeddings, unit norm gains and zero biases,
    as the JAX package initializes (the draws themselves differ: tests
    convert the JAX package's params instead of comparing inits)."""
    if seed is None:
        return
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for mod in module.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, device=device, dtype=dtype), requires_grad=False
    )


class Dense(nn.Module):
    """y = x @ w + b. Weight-only int8 (``set_quantized``, reached through
    ``ops.quant.quantize_params_int8``) replaces the parameter ``w`` by a
    child ``w`` holding buffers ``q`` (int8 [in, out]) and ``s`` (f32
    [out]), the JAX tree's ``{"q", "s"}`` leaf, and the forward becomes
    ``x @ dequantize_weight(w, x.dtype)``."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.use_bias = use_bias
        self.w = _param((in_dim, out_dim), device, dtype)
        self.b = _param((out_dim,), device, dtype) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """LeCun normal weight (std sqrt(1 / fan_in)), zero bias."""
        if self.quantized:
            raise RuntimeError("a quantized Dense has no float weight to reset")
        self.w.normal_(0.0, math.sqrt(1.0 / self.in_dim), generator=generator)
        if self.b is not None:
            self.b.zero_()

    @property
    def quantized(self) -> bool:
        return isinstance(self.w, QuantizedWeight)

    def set_quantized(self, q: torch.Tensor, s: torch.Tensor) -> None:
        """Hold the weight as int8 ``q`` [in, out] and f32 scales ``s``
        [out] (the float parameter, if any, is dropped)."""
        if tuple(q.shape) != (self.in_dim, self.out_dim) or q.dtype != torch.int8:
            raise ValueError(f"quantized weight {tuple(q.shape)} {q.dtype} does "
                             f"not fit Dense({self.in_dim}, {self.out_dim})")
        self._parameters.pop("w", None)
        self._modules.pop("w", None)
        self.w = QuantizedWeight(q, s.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = dequantize_weight(self.w, x.dtype) if self.quantized else self.w.to(x.dtype)
        y = x @ w
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class Embedding(nn.Module):
    """Token embedding; ``attend`` reuses the table as the LM head."""

    def __init__(self, vocab_size: int, dim: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.table = _param((vocab_size, dim), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.table.normal_(0.0, 0.02, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.table.to(x.dtype).T


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.use_bias = use_bias
        self.scale = _param((dim,), device, dtype)
        self.bias = _param((dim,), device, dtype) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Explicit-generator dropout: a no-op unless ``train=True`` and a
    ``torch.Generator`` is given (on the input's device). Keeps each
    element with probability ``1 - rate`` and scales survivors by
    ``1 / (1 - rate)``; the mask comes from the generator, so a run is
    reproducible from its seed (the draws differ from the JAX package's
    threefry stream)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, rng: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        if not train or self.rate == 0.0 or rng is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = _param((dim,), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * self.scale.float()
        return y.to(x.dtype)
