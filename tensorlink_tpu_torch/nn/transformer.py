"""Transformer blocks (port of ``tensorlink_tpu/nn/transformer.py``),
eval forward: ``FeedForward`` (plain or gated SwiGLU), the pre-LN
``TransformerBlock`` with its T == 1 decode fast path, and
``TransformerStack``. Post-LN blocks, MoE and training-mode dropout wait
for later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.nn.layers import Dense, LayerNorm, RMSNorm
from tensorlink_tpu_torch.ops.decode_glue import fused_residual_norm

ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # GPT-2's gelu_new
    "gelu_exact": F.gelu,  # BERT
    "relu": F.relu,
    "silu": F.silu,
}


class FeedForward(nn.Module):
    """MLP block; ``gated=True`` gives the SwiGLU variant (Llama)."""

    def __init__(self, dim: int, hidden_dim: int, activation: str = "gelu",
                 use_bias: bool = True, gated: bool = False, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.gated = gated
        kw = {"device": device, "dtype": dtype}
        self.up = Dense(dim, hidden_dim, use_bias, **kw)
        self.gate = Dense(dim, hidden_dim, use_bias, **kw) if gated else None
        self.down = Dense(hidden_dim, dim, use_bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = self.up(x)
        h = act(self.gate(x)) * h if self.gated else act(h)
        return self.down(h)


class TransformerBlock(nn.Module):
    """One pre-LN attention + MLP block; ``norm`` is "layer" or "rms"."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        hidden_dim: int | None = None,
        num_kv_heads: int | None = None,
        norm_style: str = "pre",
        norm: str = "layer",
        norm_eps: float = 1e-6,
        activation: str = "gelu",
        use_bias: bool = True,
        gated_mlp: bool = False,
        causal: bool = False,
        rope: bool = False,
        rope_theta: float = 10000.0,
        attn_window: int | None = None,
        *,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        if norm_style != "pre":
            raise NotImplementedError(
                "post-LN blocks wait for the training slice"
            )
        if norm not in ("layer", "rms"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm = norm
        self.norm_eps = norm_eps
        kw = {"device": device, "dtype": dtype}
        norm_cls = RMSNorm if norm == "rms" else LayerNorm
        self.norm1 = norm_cls(dim, eps=norm_eps, **kw)
        self.norm2 = norm_cls(dim, eps=norm_eps, **kw)
        self.attn = MultiHeadAttention(
            dim, num_heads, num_kv_heads=num_kv_heads, use_bias=use_bias,
            rope=rope, rope_theta=rope_theta, causal=causal,
            window=attn_window, **kw,
        )
        self.mlp = FeedForward(
            dim, hidden_dim or 4 * dim, activation=activation,
            use_bias=use_bias, gated=gated_mlp, **kw,
        )

    def forward(self, x, *, mask=None, cache=None, positions=None):
        h = self.norm1(x)
        a = self.attn(h, mask=mask, cache=cache, positions=positions)
        new_cache = None
        if cache is not None:
            a, new_cache = a
        if cache is not None and x.shape[1] == 1:
            # decode step: residual add + norm2 in one kernel launch on
            # CUDA (ops/decode_glue.py); the wrapper raises outside the
            # kernel's limits instead of falling back
            x, h = fused_residual_norm(
                a, x, self.norm2.scale, getattr(self.norm2, "bias", None),
                eps=self.norm_eps, kind=self.norm,
            )
        else:
            x = x + a
            h = self.norm2(x)
        x = x + self.mlp(h)
        if cache is not None:
            return x, new_cache
        return x


class TransformerStack(nn.Module):
    """N homogeneous blocks, named "0".."N-1" as in the JAX params."""

    def __init__(self, num_layers: int, make_block, **block_kw):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(str(i), make_block(**block_kw))

    def blocks(self) -> list[TransformerBlock]:
        return [self._modules[str(i)] for i in range(self.num_layers)]

    def forward(self, x, *, mask=None, caches=None, positions=None):
        new_caches = [] if caches is not None else None
        for i, blk in enumerate(self.blocks()):
            if caches is not None:
                x, c = blk(x, mask=mask, cache=caches[i], positions=positions)
                new_caches.append(c)
            else:
                x = blk(x, mask=mask, positions=positions)
        if caches is not None:
            return x, new_caches
        return x
