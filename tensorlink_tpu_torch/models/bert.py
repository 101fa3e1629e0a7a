"""BERT (port of ``tensorlink_tpu/models/bert.py``).

``Bert`` is the encoder (token + position + type embeddings, LayerNorm,
post-LN ``TransformerBlock``s with exact GELU, tanh pooler over [CLS]);
``BertClassifier`` adds dropout and a dense head. Child names match the
JAX param tree, so ``convert.params_from_jax`` of a JAX ``BertClassifier``
tree loads directly (``bert.tok_emb.table``, ``bert.encoder.0.attn.q.w``,
``head.w``, ...). Attention goes through ``cfg.attn_impl``: under "auto"
a padded batch at seq 512 runs the flash kernels B1/B2 in both
directions. ``bert_pipeline_parts`` splits the encoder (and a classifier
head) for ``parallel.engine.ShardedTrainer``, the padding mask riding to
every stage as ``extras``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    Embedding,
    LayerNorm,
    init_parameters,
)
from tensorlink_tpu_torch.nn.module import Module
from tensorlink_tpu_torch.nn.transformer import TransformerBlock, TransformerStack


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    attn_impl: str = "auto"  # auto | flash | reference

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, dim=32, num_layers=2, num_heads=2,
                   hidden_dim=64, max_len=64)


class Bert(Module):
    """``Bert(cfg, device=None, dtype=torch.float32, seed=0)``: parameters
    on ``device`` (CUDA unless told otherwise), filled from ``seed``
    (``nn.layers.init_parameters``)."""

    def __init__(self, cfg: BertConfig = BertConfig(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = {"device": dev, "dtype": dtype}
        self.tok_emb = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.pos_emb = Embedding(cfg.max_len, cfg.dim, **kw)
        self.type_emb = Embedding(cfg.type_vocab_size, cfg.dim, **kw)
        self.emb_norm = LayerNorm(cfg.dim, eps=cfg.layer_norm_eps, **kw)
        self.emb_drop = Dropout(cfg.dropout)
        self.encoder = TransformerStack(
            cfg.num_layers,
            TransformerBlock,
            dim=cfg.dim,
            num_heads=cfg.num_heads,
            hidden_dim=cfg.hidden_dim,
            norm_style="post",
            norm="layer",
            norm_eps=cfg.layer_norm_eps,
            activation="gelu_exact",
            use_bias=True,
            dropout=cfg.dropout,
            attn_impl=cfg.attn_impl,
            **kw,
        )
        self.pooler = Dense(cfg.dim, cfg.dim, **kw)
        init_parameters(self, dev, seed)

    def forward(self, input_ids, *, token_type_ids=None, attention_mask=None,
                rng: torch.Generator | None = None, train: bool = False):
        """-> {"last_hidden_state": [B, T, dim], "pooled": [B, dim]}.
        ``attention_mask`` [B, T]: 1 = real token."""
        B, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.tok_emb(input_ids) + self.pos_emb(pos) + self.type_emb(token_type_ids)
        x = self.emb_norm(x)
        x = self.emb_drop(x, rng=rng, train=train)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        h = self.encoder(x, mask=mask, rng=rng, train=train)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return {"last_hidden_state": h, "pooled": pooled}


class BertClassifier(Module):
    """BertForSequenceClassification equivalent: [CLS] pooled output,
    dropout, dense head -> logits [B, num_classes]."""

    def __init__(self, cfg: BertConfig, num_classes: int, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.bert = Bert(cfg, device=dev, dtype=dtype, seed=None)
        self.drop = Dropout(cfg.dropout)
        self.head = Dense(cfg.dim, num_classes, device=dev, dtype=dtype)
        init_parameters(self, dev, seed)

    def forward(self, input_ids, *, attention_mask=None,
                rng: torch.Generator | None = None, train: bool = False, **kw):
        out = self.bert(input_ids, attention_mask=attention_mask, rng=rng,
                        train=train, **kw)
        pooled = self.drop(out["pooled"], rng=rng, train=train)
        return self.head(pooled)


def bert_pipeline_parts(model: Bert, params: dict | None = None,
                        num_classes_head: int | None = None):
    """Split a ``Bert`` into pipeline parts. ``params``: a flat state dict
    of the ``Bert`` (default: its own), or with ``num_classes_head`` of a
    ``BertClassifier`` (``bert.*`` and ``head.*``), whose head then gives
    the classification logits from [CLS] (pooler, dropout, dense)."""
    from tensorlink_tpu_torch.parallel.engine import (
        PipelineParts,
        apply_with,
        sub_params,
    )

    bert = model
    params = dict(bert.named_parameters()) if params is None else params
    bp = params if num_classes_head is None else sub_params(params, "bert")
    block = bert.encoder.blocks()[0]

    def embed_fn(p, batch, rng=None):
        ids = batch["input_ids"]
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        tt = batch.get("token_type_ids")
        tt = torch.zeros_like(ids) if tt is None else tt
        x = (apply_with(bert.tok_emb, sub_params(p, "tok_emb"), ids)
             + apply_with(bert.pos_emb, sub_params(p, "pos_emb"), pos)
             + apply_with(bert.type_emb, sub_params(p, "type_emb"), tt))
        x = apply_with(bert.emb_norm, sub_params(p, "emb_norm"), x)
        return bert.emb_drop(x, rng=rng, train=rng is not None)

    if num_classes_head is not None:
        cls_drop = Dropout(bert.cfg.dropout)

        def head_fn(all_params, x, batch, rng=None):
            hp = all_params["head"]
            pooled = torch.tanh(apply_with(bert.pooler, sub_params(hp, "pooler"),
                                           x[:, 0]))
            pooled = cls_drop(pooled, rng=rng, train=rng is not None)
            return pooled @ hp["cls.w"].to(pooled.dtype) + hp["cls.b"].to(pooled.dtype)

        head_params = {**{f"pooler.{k}": v for k, v in sub_params(bp, "pooler").items()},
                       **{f"cls.{k}": v for k, v in sub_params(params, "head").items()}}
    else:
        def head_fn(all_params, x, batch, rng=None):
            return x  # last_hidden_state

        # no pooler in the optimized tree: head_fn never reads it, and
        # decoupled weight decay would shrink an unused param
        head_params = {}

    def extras_fn(batch):
        am = batch.get("attention_mask")
        if am is None:
            return None
        return {"mask": am[:, None, None, :].bool()}

    def block_fn(lp, x, rng=None, extras=None):
        return apply_with(block, lp, x, mask=None if extras is None else extras["mask"],
                          rng=rng, train=rng is not None)

    return PipelineParts(
        embed_fn=embed_fn,
        block=block,
        block_params={str(i): sub_params(bp, f"encoder.{i}")
                      for i in range(bert.cfg.num_layers)},
        block_fn=block_fn,
        extras_fn=extras_fn,
        # CLS pooling selects token 0: not a uniform per-token reduction
        head_per_token=False if num_classes_head is not None else None,
        head_fn=head_fn,
        embed_params={k: v for k, v in bp.items()
                      if k.startswith(("tok_emb.", "pos_emb.", "type_emb.", "emb_norm."))},
        head_params=head_params,
    )
