"""Transformer blocks (port of ``tensorlink_tpu/nn/transformer.py``):
``FeedForward`` (plain or gated SwiGLU), ``TransformerBlock`` — pre-LN
(GPT-2/Llama, with its T == 1 eval decode fast path) or post-LN (BERT) — and
``TransformerStack``. Training mode (``train=True`` with a
``torch.Generator`` as ``rng``) applies dropout where the reference does:
the attention output, inside ``FeedForward`` after the activation, and
the MLP output. The stack hands the one generator to every block in turn
(the reference folds a per-block key; the draws differ either way).
``moe_experts`` > 0 puts ``nn.moe.MoEFeedForward`` in the MLP's place
(no biases, no dropout, as in the reference); ``forward_with_aux`` then
returns the router's load-balancing loss beside the output, summed over
the stack, and ``router_input`` / ``routing_stats`` probe what a block's
router sees. The T == 1 decode fast path stands in front of either MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.nn.layers import Dense, Dropout, LayerNorm, RMSNorm
from tensorlink_tpu_torch.nn.module import Module
from tensorlink_tpu_torch.nn.moe import MoEFeedForward
from tensorlink_tpu_torch.ops.decode_glue import fused_residual_norm

ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # GPT-2's gelu_new
    "gelu_exact": F.gelu,  # BERT
    "relu": F.relu,
    "silu": F.silu,
}


class FeedForward(Module):
    """MLP block; ``gated=True`` gives the SwiGLU variant (Llama)."""

    def __init__(self, dim: int, hidden_dim: int, activation: str = "gelu",
                 use_bias: bool = True, gated: bool = False,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.hidden_dim = hidden_dim
        self.activation = activation
        self.gated = gated
        self.use_bias = use_bias
        self.dropout = dropout
        kw = {"device": device, "dtype": dtype}
        self.up = Dense(dim, hidden_dim, use_bias, "col", **kw)
        self.register_module(
            "gate", Dense(dim, hidden_dim, use_bias, "col", **kw) if gated else None)
        self.down = Dense(hidden_dim, dim, use_bias, "row", **kw)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, *, rng=None, train: bool = False, **_
                ) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = self.up(x)
        h = act(self.gate(x)) * h if self.gated else act(h)
        h = self.drop(h, rng=rng, train=train)
        return self.down(h)


class TransformerBlock(Module):
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
        qkv_fused: bool = False,
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        *,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        if norm_style not in ("pre", "post"):
            raise ValueError(f"unknown norm_style {norm_style!r}")
        if norm not in ("layer", "rms"):
            raise ValueError(f"unknown norm {norm!r}")
        hidden_dim = hidden_dim or 4 * dim
        # constructor arguments, kept for config() / spec shipping
        self.dim = dim
        self.norm_style = norm_style
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.num_kv_heads = num_kv_heads
        self.norm = norm
        self.norm_eps = norm_eps
        self.activation = activation
        self.use_bias = use_bias
        self.gated_mlp = gated_mlp
        self.causal = causal
        self.rope = rope
        self.rope_theta = rope_theta
        self.dropout = dropout
        if isinstance(attn_impl, str):
            self.attn_impl = attn_impl
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.attn_window = attn_window
        self.qkv_fused = qkv_fused
        kw = {"device": device, "dtype": dtype}
        norm_cls = RMSNorm if norm == "rms" else LayerNorm
        self.norm1 = norm_cls(dim, eps=norm_eps, **kw)
        self.norm2 = norm_cls(dim, eps=norm_eps, **kw)
        self.attn = MultiHeadAttention(
            dim, num_heads, num_kv_heads=num_kv_heads, use_bias=use_bias,
            rope=rope, rope_theta=rope_theta, causal=causal,
            window=attn_window, attn_impl=attn_impl, qkv_fused=qkv_fused,
            **kw,
        )
        if moe_experts:
            # the MoE FFN has neither biases nor internal dropout: refuse
            # rather than diverge from the dense FFN it replaces
            if use_bias:
                raise ValueError("moe_experts requires use_bias=False")
            if dropout:
                raise ValueError("moe_experts requires dropout=0")
            self.mlp = MoEFeedForward(
                dim, hidden_dim, num_experts=moe_experts, top_k=moe_top_k,
                capacity_factor=moe_capacity_factor, gated=gated_mlp,
                activation=activation, **kw,
            )
        else:
            self.mlp = FeedForward(
                dim, hidden_dim, activation=activation, use_bias=use_bias,
                gated=gated_mlp, dropout=dropout, **kw,
            )
        self.drop = Dropout(dropout)

    def _mlp(self, h, rng, train):
        """-> (out, aux). The dense FFN has no auxiliary loss."""
        if isinstance(self.mlp, MoEFeedForward):
            return self.mlp.forward_with_aux(h, rng=rng, train=train)
        return self.mlp(h, rng=rng, train=train), 0.0

    def forward(self, x, *, mask=None, cache=None, positions=None, rng=None,
                train: bool = False, **_):
        x, new_cache, _ = self._run(x, mask, cache, positions, rng, train)
        if cache is not None:
            return x, new_cache
        return x

    def forward_with_aux(self, x, *, mask=None, positions=None, rng=None,
                         train: bool = False):
        """-> (out, aux_loss): the MoE router's load-balancing loss (0.0
        for a dense block). Trainers add ``aux_weight * aux``."""
        x, _, aux = self._run(x, mask, None, positions, rng, train)
        return x, aux

    def _run(self, x, mask, cache, positions, rng, train):
        """-> (out, new cache or None, aux)."""
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
        m, aux = self._mlp(h, rng, train)
        return x + self.drop(m, rng=rng, train=train), new_cache, aux

    def _post_ln(self, x, mask, cache, positions, rng, train):
        """BERT's wiring: norm after each residual add."""
        a = self.attn(x, mask=mask, cache=cache, positions=positions)
        new_cache = None
        if cache is not None:
            a, new_cache = a
        x = self.norm1(x + self.drop(a, rng=rng, train=train))
        m, aux = self._mlp(x, rng, train)
        return self.norm2(x + self.drop(m, rng=rng, train=train)), new_cache, aux

    def router_input(self, x, *, mask=None, positions=None):
        """The tensor this block's MLP (its router) sees, by the block's
        own norm wiring, through the no-cache attention."""
        if self.norm_style == "pre":
            a = self.attn(self.norm1(x), mask=mask, positions=positions)
            return self.norm2(x + a)
        return self.norm1(x + self.attn(x, mask=mask, positions=positions))

    def routing_stats(self, x, *, mask=None, positions=None) -> dict:
        """MoE router telemetry on the input this block's router sees
        (``MoEFeedForward.routing_stats``). Raises for a dense block."""
        if not isinstance(self.mlp, MoEFeedForward):
            raise ValueError("routing_stats: this block's MLP is dense")
        return self.mlp.routing_stats(
            self.router_input(x, mask=mask, positions=positions))


class TransformerStack(Module):
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

    def forward_with_aux(self, x, *, mask=None, positions=None, rng=None,
                         train: bool = False):
        """-> (out, the summed aux losses of the MoE blocks)."""
        aux = 0.0
        for blk in self.blocks():
            x, a = blk.forward_with_aux(x, mask=mask, positions=positions,
                                        rng=rng, train=train)
            aux = aux + a
        return x, aux
