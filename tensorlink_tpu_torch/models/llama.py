"""Llama 2/3 family (port of ``tensorlink_tpu/models/llama.py``).

RMSNorm + RoPE + grouped-query attention + SwiGLU, no biases, untied LM
head. ``LlamaConfig`` and its presets are the JAX package's, field for
field; ``qkv_fused`` builds the fused q/k/v projection
(``nn/attention.py``); ``moe_experts`` > 0 gives every block the
Mixture-of-Experts FFN (``nn/moe.py``, Mixtral-style), and
``forward_with_aux`` returns the logits with the blocks' summed router
load-balancing loss. ``as_pipeline_parts`` splits the model for
``parallel.engine.ShardedTrainer`` (with ``block_fn_aux`` for MoE).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.layers import Dense, Embedding, RMSNorm, init_parameters
from tensorlink_tpu_torch.nn.module import Module
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


class Llama(Module):
    """``Llama(cfg, device=None, dtype=torch.float32, seed=0)``: builds
    the parameters on ``device`` (CUDA unless told otherwise) and fills
    them from ``seed`` (``nn.layers.init_parameters``)."""

    def __init__(self, cfg: LlamaConfig = LlamaConfig(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
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
            moe_experts=cfg.moe_experts,
            moe_top_k=cfg.moe_top_k,
            moe_capacity_factor=cfg.moe_capacity_factor,
            **kw,
        )
        self.norm_f = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, use_bias=False, shard="col", **kw)
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
        out = self.head(x) if logits else x
        if caches is not None:
            return out, new_caches
        return out

    def forward_with_aux(self, input_ids, *, positions=None, mask=None,
                         rng=None, train: bool = False):
        """-> (logits, aux): the MoE router load-balancing loss summed
        over the blocks (0.0 for a dense config). Mixtral-style training
        adds ``aux_weight * aux`` to the task loss."""
        x = self.tok_emb(input_ids)
        x, aux = self.blocks.forward_with_aux(x, mask=mask, positions=positions,
                                              rng=rng, train=train)
        return self.head(self.norm_f(x)), aux

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states (``forward(..., logits=False)``).
        A column block of ``lm_head`` (tensor parallel) gives this rank's
        vocab slice, gathered over the model group into the whole
        vocab."""
        y = self.lm_head(h)
        if self.lm_head.width() != self.cfg.vocab_size:
            from tensorlink_tpu_torch.parallel import tp

            y = tp.gather_from_model(y)
        return y

    def as_pipeline_parts(self, params: dict | None = None):
        """Split into (embed, blocks, head) for the ``ShardedTrainer``;
        ``params``: a flat state dict (default: the model's own). MoE
        configs carry ``block_fn_aux``, so ``moe_aux_weight`` trains the
        router's load balancing in both schedules; at model > 1 a
        block's experts are this rank's E/m and its aux the model
        group's average (``nn/moe.py``)."""
        from tensorlink_tpu_torch.parallel.engine import (
            PipelineParts,
            apply_with,
            sub_params,
        )

        params = dict(self.named_parameters()) if params is None else params
        block = self.blocks.blocks()[0]
        tok_emb, norm_f, lm_head = self.tok_emb, self.norm_f, self.lm_head

        def embed_fn(p, batch, rng=None):
            return apply_with(tok_emb, sub_params(p, "tok_emb"), batch["input_ids"])

        def head_fn(all_params, x, batch, rng=None):
            hp = all_params["head"]
            h = apply_with(norm_f, sub_params(hp, "norm_f"), x)
            return apply_with(lm_head, sub_params(hp, "lm_head"), h)

        def block_fn_aux(lp, x, rng=None):
            return apply_with(block, lp, x, method="forward_with_aux", rng=rng,
                              train=rng is not None)

        return PipelineParts(
            embed_fn=embed_fn,
            block=block,
            block_params={str(i): sub_params(params, f"blocks.{i}")
                          for i in range(self.cfg.num_layers)},
            block_fn=lambda lp, x, rng=None: apply_with(
                block, lp, x, rng=rng, train=rng is not None),
            head_fn=head_fn,
            embed_params={k: v for k, v in params.items() if k.startswith("tok_emb.")},
            head_params={k: v for k, v in params.items()
                         if k.startswith(("norm_f.", "lm_head."))},
            block_fn_aux=block_fn_aux if self.cfg.moe_experts else None,
            head_per_token=True,
        )

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
