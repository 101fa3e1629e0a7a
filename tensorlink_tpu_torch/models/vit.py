"""ViT-B/16 (port of ``tensorlink_tpu/models/vit.py``).

``ViT`` is a pre-LN encoder over patch tokens with a [CLS] token and
learned position embeddings; ``ViTClassifier`` puts a dense head on the
[CLS] token (``ViTForImageClassification``). Patch embedding is an
unfold plus a matmul (``PatchEmbed``), as in the reference, so the whole
model is Dense/matmul-shaped. Child and parameter names match the JAX
param tree (``vit.patch.w``, ``vit.cls_token``, ``vit.pos_emb``,
``vit.encoder.0.attn.q.w``, ``head.w``, ...), so
``convert.params_from_jax`` of a JAX ``ViTClassifier`` tree loads
directly. Attention goes through the blocks' ``attn_impl="auto"``: at
ViT-B/16's 197 tokens that is the plain path (197 is off the reference's
kernel rule, ``ops.flash._tile_ok``), as in the reference.
``vit_pipeline_parts`` splits the model for
``parallel.engine.ShardedTrainer``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    LayerNorm,
    _param,
    init_parameters,
)
from tensorlink_tpu_torch.nn.module import Module, P, register_module_type
from tensorlink_tpu_torch.nn.transformer import TransformerBlock, TransformerStack


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 3072
    dropout: float = 0.0
    layer_norm_eps: float = 1e-12

    @classmethod
    def base_16(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(
            image_size=32,
            patch_size=8,
            dim=32,
            num_layers=2,
            num_heads=2,
            hidden_dim=64,
        )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@register_module_type
class PatchEmbed(Module):
    """[B, H, W, C] images -> [B, N, dim] patch tokens via unfold+matmul.
    ``w`` is [patch * patch * channels, dim], rows in (row, column,
    channel) order within a patch, as the reference's."""

    def __init__(self, image_size: int, patch_size: int, channels: int,
                 dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.channels = channels
        self.dim = dim
        pdim = patch_size * patch_size * channels
        self.w = _param((pdim, dim), device, dtype)
        self.b = _param((dim,), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.w.normal_(0.0, 0.02, generator=generator)
        self.b.zero_()

    def param_spec(self, model_axis: str = "model"):
        return {"w": P(None, None), "b": P(None)}

    def forward(self, images: torch.Tensor, **_) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch_size
        x = images.reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p), p * p * C)
        return x @ self.w.to(x.dtype) + self.b.to(x.dtype)


def _embed(patch: PatchEmbed, images, cls_token, pos_emb):
    x = patch(images)
    cls = cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    return torch.cat([cls, x], dim=1) + pos_emb.to(x.dtype)


class ViT(Module):
    """Pre-LN encoder with [CLS] token and learned position embeddings.
    ``ViT(cfg, device=None, dtype=torch.float32, seed=0)``: parameters on
    ``device`` (CUDA unless told otherwise), filled from ``seed``."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg_obj = cfg
        kw = {"device": dev, "dtype": dtype}
        self.patch = PatchEmbed(cfg.image_size, cfg.patch_size, cfg.channels,
                                cfg.dim, **kw)
        self.emb_drop = Dropout(cfg.dropout)
        self.encoder = TransformerStack(
            cfg.num_layers,
            TransformerBlock,
            dim=cfg.dim,
            num_heads=cfg.num_heads,
            hidden_dim=cfg.hidden_dim,
            norm_style="pre",
            norm="layer",
            norm_eps=cfg.layer_norm_eps,
            activation="gelu_exact",
            use_bias=True,
            dropout=cfg.dropout,
            **kw,
        )
        self.final_norm = LayerNorm(cfg.dim, eps=cfg.layer_norm_eps, **kw)
        self.cls_token = _param((1, 1, cfg.dim), dev, dtype)
        self.pos_emb = _param((1, cfg.num_patches + 1, cfg.dim), dev, dtype)
        init_parameters(self, dev, seed)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """N(0, 0.02) [CLS] token and position embeddings (the children
        fill their own)."""
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def param_spec(self, model_axis: str = "model"):
        spec = super().param_spec(model_axis)
        spec["cls_token"] = P(None, None, None)
        spec["pos_emb"] = P(None, None, None)
        return spec

    def forward(self, images, *, rng: torch.Generator | None = None,
                train: bool = False, **_):
        """-> {"last_hidden_state": [B, N + 1, dim], "pooled": [B, dim]}."""
        x = _embed(self.patch, images, self.cls_token, self.pos_emb)
        x = self.emb_drop(x, rng=rng, train=train)
        h = self.encoder(x, rng=rng, train=train)
        h = self.final_norm(h)
        return {"last_hidden_state": h, "pooled": h[:, 0]}


class ViTClassifier(Module):
    """ViTForImageClassification equivalent (head on the [CLS] token)."""

    def __init__(self, cfg: ViTConfig, num_classes: int, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.vit = ViT(cfg, device=dev, dtype=dtype, seed=None)
        self.head = Dense(cfg.dim, num_classes, device=dev, dtype=dtype)
        init_parameters(self, dev, seed)

    def forward(self, images, *, rng: torch.Generator | None = None,
                train: bool = False, **kw):
        out = self.vit(images, rng=rng, train=train, **kw)
        return self.head(out["pooled"])


def vit_pipeline_parts(model: ViT, params: dict | None = None,
                       num_classes_head: int | None = None):
    """Split a ``ViT`` into pipeline parts, the same contract as
    ``bert_pipeline_parts``: embed -> stacked blocks -> head. ``params``:
    a flat state dict of the ``ViT`` (default: its own), or with
    ``num_classes_head`` of a ``ViTClassifier`` (``vit.*`` and ``head.*``),
    whose head then gives the logits from the [CLS] token."""
    from tensorlink_tpu_torch.parallel.engine import (
        PipelineParts,
        apply_with,
        sub_params,
    )

    vit = model
    params = dict(vit.named_parameters()) if params is None else params
    vp = params if num_classes_head is None else sub_params(params, "vit")
    block = vit.encoder.blocks()[0]
    emb_drop = vit.emb_drop

    def embed_fn(p, batch, rng=None):
        images = batch["images"]
        x = apply_with(vit.patch, sub_params(p, "patch"), images)
        cls = p["cls_token"].to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + p["pos_emb"].to(x.dtype)
        return emb_drop(x, rng=rng, train=rng is not None)

    def final_norm(hp, x):
        return apply_with(vit.final_norm, sub_params(hp, "final_norm"), x)

    norm_params = {f"final_norm.{k}": v
                   for k, v in sub_params(vp, "final_norm").items()}
    if num_classes_head is not None:
        def head_fn(all_params, x, batch, rng=None):
            hp = all_params["head"]
            h = final_norm(hp, x)
            return h[:, 0] @ hp["cls.w"].to(h.dtype) + hp["cls.b"].to(h.dtype)

        head_params = {**norm_params,
                       **{f"cls.{k}": v for k, v in sub_params(params, "head").items()}}
    else:
        def head_fn(all_params, x, batch, rng=None):
            return final_norm(all_params["head"], x)

        head_params = norm_params

    def block_fn(lp, x, rng=None):
        return apply_with(block, lp, x, rng=rng, train=rng is not None)

    return PipelineParts(
        embed_fn=embed_fn,
        block=block,
        block_params={str(i): sub_params(vp, f"encoder.{i}")
                      for i in range(vit.cfg_obj.num_layers)},
        block_fn=block_fn,
        head_fn=head_fn,
        # the classifier head pools the CLS patch: position-selective, not
        # a uniform token reduction (as BERT's CLS pooling)
        head_per_token=False if num_classes_head is not None else None,
        embed_params={k: v for k, v in vp.items()
                      if k.startswith("patch.") or k in ("cls_token", "pos_emb")},
        head_params=head_params,
    )
