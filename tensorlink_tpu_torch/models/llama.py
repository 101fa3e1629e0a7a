"""Llama 2/3 family (port of ``tensorlink_tpu/models/llama.py``).

RMSNorm + RoPE + grouped-query attention + SwiGLU, no biases, untied LM
head. ``LlamaConfig`` and its presets are the JAX package's, field for
field; ``qkv_fused`` builds the fused q/k/v projection
(``nn/attention.py``); the MoE fields are carried for parity but a
config that sets ``moe_experts`` is refused until MoE is ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.layers import Dense, Embedding, RMSNorm, init_parameters
from tensorlink_tpu_torch.nn.transformer import TransformerBlock, TransformerStack


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    hidden_dim: int = 14336
    max_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    attn_impl: str = "auto"
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    attn_window: int | None = None
    qkv_fused: bool = False

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, dim=4096, num_layers=32,
                   num_heads=32, num_kv_heads=8, hidden_dim=14336,
                   max_len=32768, rope_theta=10000.0,
                   attn_window=4096)

    @classmethod
    def mixtral_8x7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, dim=4096, num_layers=32, num_heads=32,
                   num_kv_heads=8, hidden_dim=14336, max_len=32768,
                   rope_theta=1e6, moe_experts=8, moe_top_k=2)

    @classmethod
    def mistral_tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=128, dim=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, hidden_dim=64, max_len=64,
                   rope_theta=10000.0, attn_window=8)

    @classmethod
    def moe_tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=128, dim=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, hidden_dim=64, max_len=64,
                   rope_theta=10000.0, moe_experts=4, moe_top_k=2)

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(dim=8192, num_layers=80, num_heads=64, num_kv_heads=8,
                   hidden_dim=28672)

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, dim=4096, num_layers=32, num_heads=32,
                   num_kv_heads=32, hidden_dim=11008, max_len=4096,
                   rope_theta=10000.0, rms_eps=1e-5)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=128, dim=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, hidden_dim=64, max_len=64,
                   rope_theta=10000.0)


class Llama(nn.Module):
    """``Llama(cfg, device=None, dtype=torch.float32, seed=0)``: builds
    the parameters on ``device`` (CUDA unless told otherwise) and fills
    them from ``seed`` (``nn.layers.init_parameters``)."""

    def __init__(self, cfg: LlamaConfig = LlamaConfig(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError("MoE blocks wait for a later slice")
        dev = resolve_device(device)
        self.cfg = cfg
        kw = {"device": dev, "dtype": dtype}
        self.tok_emb = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.blocks = TransformerStack(
            cfg.num_layers,
            TransformerBlock,
            dim=cfg.dim,
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            hidden_dim=cfg.hidden_dim,
            norm_style="pre",
            norm="rms",
            norm_eps=cfg.rms_eps,
            activation="silu",
            use_bias=False,
            gated_mlp=True,
            causal=True,
            rope=True,
            rope_theta=cfg.rope_theta,
            attn_window=cfg.attn_window,
            attn_impl=cfg.attn_impl,
            qkv_fused=cfg.qkv_fused,
            **kw,
        )
        self.norm_f = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, use_bias=False, **kw)
        init_parameters(self, dev, seed)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.table.device

    def forward(self, input_ids, *, caches=None, positions=None, mask=None,
                logits: bool = True):
        """-> logits [B, T, vocab] (or the final hidden states when
        ``logits=False``); with ``caches`` (one ``{"attn": cache}`` per
        block) -> (out, new_caches)."""
        x = self.tok_emb(input_ids)
        if caches is not None:
            x, new_attn = self.blocks(
                x, mask=mask, caches=[c["attn"] for c in caches],
                positions=positions,
            )
            new_caches = [{"attn": c} for c in new_attn]
        else:
            new_caches = None
            x = self.blocks(x, mask=mask, positions=positions)
        x = self.norm_f(x)
        out = self.lm_head(x) if logits else x
        if caches is not None:
            return out, new_caches
        return out

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states (``forward(..., logits=False)``)."""
        return self.lm_head(h)

    def tied_head_table(self) -> None:
        """The embedding table an LM head tied to it multiplies by: none,
        the head is its own ``Dense``."""
        return None

    def init_caches(self, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16,
                    rolling: bool = False) -> list[dict]:
        """One contiguous ``{"attn": cache}`` a block, on the model's
        device (``MultiHeadAttention.init_cache``)."""
        return [
            {"attn": blk.attn.init_cache(batch, max_len, dtype, rolling,
                                         device=self.device)}
            for blk in self.blocks.blocks()
        ]
