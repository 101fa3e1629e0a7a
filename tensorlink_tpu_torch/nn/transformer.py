"""Transformer blocks (port of ``tensorlink_tpu/nn/transformer.py``):
``FeedForward`` (plain or gated SwiGLU), ``TransformerBlock`` — pre-LN
(GPT-2/Llama, with its T == 1 eval decode fast path) or post-LN (BERT) — and
``TransformerStack``. Training mode (``train=True`` with a
``torch.Generator`` as ``rng``) applies dropout where the reference does:
the attention output, inside ``FeedForward`` after the activation, and
the MLP output. The stack hands the one generator to every block in turn
(the reference folds a per-block key; the draws differ either way). MoE
waits for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.nn.layers import Dense, Dropout, LayerNorm, RMSNorm
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
                 use_bias: bool = True, gated: bool = False,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.gated = gated
        kw = {"device": device, "dtype": dtype}
        self.up = Dense(dim, hidden_dim, use_bias, **kw)
        self.gate = Dense(dim, hidden_dim, use_bias, **kw) if gated else None
        self.down = Dense(hidden_dim, dim, use_bias, **kw)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, *, rng=None, train: bool = False
                ) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = self.up(x)
        h = act(self.gate(x)) * h if self.gated else act(h)
        h = self.drop(h, rng=rng, train=train)
        return self.down(h)


class TransformerBlock(nn.Module):
    """One attention + MLP block. ``norm_style``: "pre" (GPT-2/Llama) or
    "post" (BERT); ``norm``: "layer" or "rms"."""

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
        dropout: float = 0.0,
        attn_impl="auto",
        *,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        if norm_style not in ("pre", "post"):
            raise ValueError(f"unknown norm_style {norm_style!r}")
        if norm not in ("layer", "rms"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm_style = norm_style
        self.norm = norm
        self.norm_eps = norm_eps
        kw = {"device": device, "dtype": dtype}
        norm_cls = RMSNorm if norm == "rms" else LayerNorm
        self.norm1 = norm_cls(dim, eps=norm_eps, **kw)
        self.norm2 = norm_cls(dim, eps=norm_eps, **kw)
        self.attn = MultiHeadAttention(
            dim, num_heads, num_kv_heads=num_kv_heads, use_bias=use_bias,
            rope=rope, rope_theta=rope_theta, causal=causal,
            window=attn_window, attn_impl=attn_impl, **kw,
        )
        self.mlp = FeedForward(
            dim, hidden_dim or 4 * dim, activation=activation,
            use_bias=use_bias, gated=gated_mlp, dropout=dropout, **kw,
        )
        self.drop = Dropout(dropout)

    def forward(self, x, *, mask=None, cache=None, positions=None, rng=None,
                train: bool = False):
        if self.norm_style == "post":
            return self._post_ln(x, mask, cache, positions, rng, train)
        h = self.norm1(x)
        a = self.attn(h, mask=mask, cache=cache, positions=positions)
        new_cache = None
        if cache is not None:
            a, new_cache = a
        if cache is not None and not train and x.shape[1] == 1:
            # eval decode step: residual add + norm2 in one kernel launch
            # on CUDA (ops/decode_glue.py); the wrapper raises outside the
            # kernel's limits instead of falling back
            x, h = fused_residual_norm(
                a, x, self.norm2.scale, getattr(self.norm2, "bias", None),
                eps=self.norm_eps, kind=self.norm,
            )
        else:
            x = x + self.drop(a, rng=rng, train=train)
            h = self.norm2(x)
        x = x + self.drop(self.mlp(h, rng=rng, train=train), rng=rng,
                          train=train)
        if cache is not None:
            return x, new_cache
        return x

    def _post_ln(self, x, mask, cache, positions, rng, train):
        """BERT's wiring: norm after each residual add."""
        a = self.attn(x, mask=mask, cache=cache, positions=positions)
        new_cache = None
        if cache is not None:
            a, new_cache = a
        x = self.norm1(x + self.drop(a, rng=rng, train=train))
        m = self.mlp(x, rng=rng, train=train)
        x = self.norm2(x + self.drop(m, rng=rng, train=train))
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

    def forward(self, x, *, mask=None, caches=None, positions=None, rng=None,
                train: bool = False):
        new_caches = [] if caches is not None else None
        for i, blk in enumerate(self.blocks()):
            if caches is not None:
                x, c = blk(x, mask=mask, cache=caches[i], positions=positions,
                           rng=rng, train=train)
                new_caches.append(c)
            else:
                x = blk(x, mask=mask, positions=positions, rng=rng,
                        train=train)
        if caches is not None:
            return x, new_caches
        return x
