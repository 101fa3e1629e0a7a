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
``Dropout`` holds no parameters. Every class derives from
``nn.module.Module`` (``config()`` for spec shipping), and every forward
accepts the keywords a container passes on (``rng``, ``train``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tensorlink_tpu_torch.nn.module import Module, P
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


class Dense(Module):
    """y = x @ w + b. Weight-only int8 (``set_quantized``, reached through
    ``ops.quant.quantize_params_int8``) replaces the parameter ``w`` by a
    child ``w`` holding buffers ``q`` (int8 [in, out]) and ``s`` (f32
    [out]), the JAX tree's ``{"q", "s"}`` leaf, and the forward becomes
    ``x @ dequantize_weight(w, x.dtype)``.

    LoRA (``nn.lora.lora_init``) adds parameters ``lora_a`` [in, r],
    ``lora_b`` [r, out] and the 0-d ``lora_s`` (alpha / r); the forward
    then adds ``((x @ a) @ b) * s`` in the activation dtype, after the
    (dequantized) product and before the bias, as the reference does.
    ``shard`` ("col", "row" or None) is the tensor-parallel role
    (``param_spec``): handed a block of ``w`` (``functional_call`` with a
    ``parallel.tp`` shard), a "col" Dense multiplies ``copy_to_model(x)``
    into its output slice, a "row" Dense sums its partial product over the
    model group before the bias (``parallel/tp.py``). Adapters follow the
    base weight's split (``nn.lora.lora_spec_tree``): under "col" the
    replicated ``(x @ a) * s`` enters ``copy_to_model`` before its ``b``
    slice, under "row" ``x @ a`` is summed before the replicated ``b``, so
    every replicated leaf (``a``, ``s``) gets its whole gradient on every
    rank. An int8 block (``ops.quant.quantized_spec_tree``: a "col"
    block's scales are its columns', a "row" block's are whole) is
    dequantized first and takes the same form.
    ``init_scheme`` is "lecun" or "normal" (N(0, 0.02))."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 shard: str | None = None, init_scheme: str = "lecun", *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.use_bias = use_bias
        self.shard = shard
        self.init_scheme = init_scheme
        self.w = _param((in_dim, out_dim), device, dtype)
        self.register_parameter(
            "b", _param((out_dim,), device, dtype) if use_bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """LeCun normal weight (std sqrt(1 / fan_in)), or N(0, 0.02) under
        ``init_scheme="normal"``; zero bias. Adapters are left alone."""
        if self.quantized:
            raise RuntimeError("a quantized Dense has no float weight to reset")
        std = 0.02 if self.init_scheme == "normal" else math.sqrt(1.0 / self.in_dim)
        self.w.normal_(0.0, std, generator=generator)
        if self.b is not None:
            self.b.zero_()

    @property
    def quantized(self) -> bool:
        return isinstance(self.w, QuantizedWeight)

    def width(self) -> int:
        """Output columns of the weight this Dense holds: ``out_dim``, or
        a "col" block's share of it."""
        return (self.w.q if self.quantized else self.w).shape[1]

    def set_quantized(self, q: torch.Tensor, s: torch.Tensor) -> None:
        """Hold the weight as int8 ``q`` [in, out] and f32 scales ``s``
        [out] (the float parameter, if any, is dropped); or a
        tensor-parallel block of them (fewer columns under "col", fewer
        rows under "row")."""
        rows, cols = (tuple(q.shape) + (0, 0))[:2]
        fits = (q.dim() == 2 and (rows, cols) == (self.in_dim, self.out_dim)
                or self.shard == "col" and rows == self.in_dim
                and cols and self.out_dim % cols == 0
                or self.shard == "row" and cols == self.out_dim
                and rows and self.in_dim % rows == 0)
        if not fits or q.dtype != torch.int8:
            raise ValueError(f"quantized weight {tuple(q.shape)} {q.dtype} does "
                             f"not fit Dense({self.in_dim}, {self.out_dim})")
        self._parameters.pop("w", None)
        self._modules.pop("w", None)
        self.w = QuantizedWeight(q, s.float())

    @property
    def has_lora(self) -> bool:
        return "lora_a" in self._parameters

    def param_spec(self, model_axis: str = "model"):
        w = {"col": P(None, model_axis), "row": P(model_axis, None)}.get(
            self.shard, P())
        spec = {"w": w}
        if self.use_bias:
            spec["b"] = P(model_axis) if self.shard == "col" else P()
        return spec

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        w = dequantize_weight(self.w, x.dtype) if self.quantized else self.w.to(x.dtype)
        if self.shard in ("col", "row") and tuple(w.shape) != (self.in_dim, self.out_dim):
            return self._forward_tp(x, w)
        y = x @ w
        if self.has_lora:
            y = y + ((x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)) \
                * self.lora_s.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y

    def _forward_tp(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The Megatron form on a block of ``w`` (class docstring)."""
        from tensorlink_tpu_torch.parallel import tp

        lora = self.has_lora
        if lora:
            a, b = self.lora_a.to(x.dtype), self.lora_b.to(x.dtype)
            s = self.lora_s.to(x.dtype)
        if self.shard == "col":
            y = tp.copy_to_model(x) @ w
            if lora:  # s on the replicated side: its gradient is whole
                y = y + tp.copy_to_model((x @ a) * s) @ b
        else:
            y = tp.reduce_from_model(x @ w)
            if lora:
                y = y + (tp.reduce_from_model(x @ a) @ b) * s
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class Embedding(Module):
    """Token embedding; ``attend`` reuses the table as the LM head.
    ``shard`` splits the vocab over the model axis (``param_spec``):
    handed a block of the table, the lookup takes the ids that fall in
    it (the rest give zero rows) and sums over the model group, and
    ``attend`` returns the logits of the whole vocab, gathered over the
    group (``parallel/tp.py``)."""

    def __init__(self, vocab_size: int, dim: int, shard: str | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.shard = shard
        self.table = _param((vocab_size, dim), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.table.normal_(0.0, 0.02, generator=generator)

    def param_spec(self, model_axis: str = "model"):
        return {"table": P(model_axis, None) if self.shard else P()}

    def _vocab_block(self) -> bool:
        return self.table.shape[0] != self.vocab_size

    def forward(self, ids: torch.Tensor, **_) -> torch.Tensor:
        if not self._vocab_block():
            return self.table[ids]
        from tensorlink_tpu_torch.parallel import tp

        n = self.table.shape[0]
        local = ids - tp.model_rank() * n
        hit = (local >= 0) & (local < n)
        rows = self.table[local.clamp(0, n - 1)] * hit[..., None].to(self.table.dtype)
        return tp.reduce_from_model(rows)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        if not self._vocab_block():
            return x @ self.table.to(x.dtype).T
        from tensorlink_tpu_torch.parallel import tp

        return tp.gather_from_model(tp.copy_to_model(x) @ self.table.to(x.dtype).T)


class LayerNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.use_bias = use_bias
        self.scale = _param((dim,), device, dtype)
        self.register_parameter(
            "bias", _param((dim,), device, dtype) if use_bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def param_spec(self, model_axis: str = "model"):
        return {"scale": P(), "bias": P()} if self.use_bias else {"scale": P()}

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class Dropout(Module):
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
                train: bool = False, **_) -> torch.Tensor:
        if not train or self.rate == 0.0 or rng is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class RMSNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = _param((dim,), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.scale.fill_(1.0)

    def param_spec(self, model_axis: str = "model"):
        return {"scale": P()}

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * self.scale.float()
        return y.to(x.dtype)
