"""GPT-2 (port of ``tensorlink_tpu/models/gpt2.py``).

Pre-LN decoder blocks (LayerNorm with bias, tanh GELU, biased
projections), learned positions, and an LM head tied to the token
embedding (``wte.attend``). ``GPT2Config`` and its presets are the JAX
package's, field for field; ``qkv_fused`` builds the fused q/k/v
projection (``nn/attention.py``). ``as_pipeline_parts`` waits for the
pipeline slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, init_parameters
from tensorlink_tpu_torch.nn.transformer import TransformerBlock, TransformerStack


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 1024
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    attn_impl: str = "auto"
    qkv_fused: bool = False

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def medium(cls) -> "GPT2Config":
        return cls(dim=1024, num_layers=24, num_heads=16)

    @classmethod
    def tiny(cls) -> "GPT2Config":
        return cls(vocab_size=128, dim=32, num_layers=2, num_heads=2, max_len=64)


class GPT2(nn.Module):
    """``GPT2(cfg, device=None, dtype=torch.float32, seed=0)``: builds the
    parameters on ``device`` (CUDA unless told otherwise) and fills them
    from ``seed`` (``nn.layers.init_parameters``)."""

    def __init__(self, cfg: GPT2Config = GPT2Config(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = {"device": dev, "dtype": dtype}
        self.wte = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.wpe = Embedding(cfg.max_len, cfg.dim, **kw)
        self.drop = Dropout(cfg.dropout)
        self.blocks = TransformerStack(
            cfg.num_layers,
            TransformerBlock,
            dim=cfg.dim,
            num_heads=cfg.num_heads,
            hidden_dim=4 * cfg.dim,
            norm_style="pre",
            norm="layer",
            norm_eps=cfg.layer_norm_eps,
            activation="gelu",
            use_bias=True,
            causal=True,
            dropout=cfg.dropout,
            attn_impl=cfg.attn_impl,
            qkv_fused=cfg.qkv_fused,
            **kw,
        )
        self.ln_f = LayerNorm(cfg.dim, eps=cfg.layer_norm_eps, **kw)
        init_parameters(self, dev, seed)

    @property
    def device(self) -> torch.device:
        return self.wte.table.device

    def forward(self, input_ids, *, caches=None, positions=None, mask=None,
                rng=None, train: bool = False, logits: bool = True):
        """-> logits [B, T, vocab] (or the final hidden states when
        ``logits=False``); with ``caches`` (one ``{"attn": cache}`` per
        block) -> (out, new_caches). Positions default to the cache's
        write index (each row's own, on a per-row cache) plus 0..T-1."""
        T = input_ids.shape[1]
        if positions is None:
            positions = torch.arange(T, device=input_ids.device)[None, :]
            if caches is not None:
                idx = caches[0]["attn"]["index"]
                positions = positions + (idx[:, None] if idx.dim() == 1 else idx)
        x = self.wte(input_ids) + self.wpe(positions)
        x = self.drop(x, rng=rng, train=train)
        if caches is not None:
            x, new_attn = self.blocks(
                x, mask=mask, caches=[c["attn"] for c in caches], rng=rng,
                train=train,
            )
            new_caches = [{"attn": c} for c in new_attn]
        else:
            new_caches = None
            x = self.blocks(x, mask=mask, rng=rng, train=train)
        x = self.ln_f(x)
        out = self.wte.attend(x) if logits else x
        if caches is not None:
            return out, new_caches
        return out

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states (``forward(..., logits=False)``)."""
        return self.wte.attend(h)

    def tied_head_table(self) -> torch.Tensor:
        """The embedding table the tied LM head multiplies by."""
        return self.wte.table

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
