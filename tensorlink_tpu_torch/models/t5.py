"""T5 encoder-decoder (port of ``tensorlink_tpu/models/t5.py``).

Bidirectional encoder, causal decoder with cross-attention, bucketed
relative position biases shared across the layers of a stack, RMS layer
norm, and the no-softmax-scale attention convention (``scale=1.0``,
folded into T5's init). v1.0 (ReLU FF, tied head with the d^-0.5 logit
rescale) and v1.1 (gated-GeLU, ``gated_ff``; untied head) are both
expressible. Child and parameter names are the JAX param tree's
(``shared.table``, ``enc_rel.w``, ``enc0.attn.q.w``, ``dec0.xattn.k.w``,
``dec0.ff.up.w``, ``lm_head.w``, ...), so ``convert.params_from_jax``
carries a JAX ``T5``'s params across.

Attention is ``attn_impl="reference"`` with an additive bias, as in the
reference: no flash kernel runs. The bucket table is computed on the CPU
in f32 with the published op order (``relative_position_bucket``), so
its integer buckets equal the reference's bit for bit, and only the
gathered bias moves to the parameters' device.

TP: the same Megatron col/row specs as every other family (q/k/v/o and
the FF splits) compose per block through ``param_spec``; the bias table
is replicated, and a block handed a head-split attention slices its
heads' rows of the bias (``parallel/tp.py``'s model rank).
``greedy_decode`` runs the encoder once, projects each decoder layer's
cross k/v once (``project_kv``) and reads a contiguous self-attention
cache per layer, one single-token decoder pass per emitted token. The
reference's ``lax.scan`` is a Python loop here, run eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    Embedding,
    RMSNorm,
    _param,
    init_parameters,
)
from tensorlink_tpu_torch.nn.module import Module, P
from tensorlink_tpu_torch.nn.transformer import FeedForward


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 512
    num_layers: int = 6  # per side (encoder AND decoder)
    num_heads: int = 8
    head_dim: int = 64
    hidden_dim: int = 2048
    rel_buckets: int = 32
    rel_max_distance: int = 128
    dropout: float = 0.1
    rms_eps: float = 1e-6
    gated_ff: bool = False  # False = v1.0 ReLU; True = v1.1 gated-GeLU
    tie_word_embeddings: bool = True  # v1.0 ties (and rescales logits)

    @classmethod
    def small(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=128, dim=32, num_layers=2, num_heads=2,
                   head_dim=16, hidden_dim=64, rel_buckets=8,
                   rel_max_distance=16, dropout=0.0)


def relative_position_bucket(rel: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions (key_pos - query_pos), int32.

    The published bucketing: half the buckets for exact small offsets,
    the rest log-spaced up to max_distance; bidirectional (encoder)
    splits buckets between signs, causal (decoder) uses only
    non-positive offsets. At n = 2^k max_exact the real value is an
    integer, so the f32 op order and dtypes (and the f64 divisor) are
    the reference's, and ``n`` is clamped to 1 for the log with no
    epsilon: one ulp would flip a bucket."""
    rel = rel.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    safe_n = n.clamp_min(1).float()
    log_big = max_exact + (
        torch.log(safe_n / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    log_big = log_big.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, log_big)


class RelativePositionBias(Module):
    """[buckets, H] table -> additive attention bias [1, H, Tq, Tk]. ONE
    instance per stack, shared by every layer (T5 convention)."""

    def __init__(self, num_heads: int, num_buckets: int, max_distance: int,
                 bidirectional: bool, *, device=None, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.bidirectional = bidirectional
        self.w = _param((num_buckets, num_heads), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.w.normal_(0.0, 0.02, generator=generator)

    def param_spec(self, model_axis: str = "model"):
        # heads are TP-split in attention; the table is tiny: replicated,
        # and each block slices its heads' rows of the bias
        return {"w": P()}

    def forward(self, q_len: int, k_len: int, **_) -> torch.Tensor:
        """Queries at positions 0..q_len-1 against keys at 0..k_len-1 (the
        reference's ``apply(params, arange(Tq), arange(Tk))``, its only
        use) -> [1, H, Tq, Tk]. The buckets are computed on the CPU."""
        rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
        bucket = relative_position_bucket(
            rel, bidirectional=self.bidirectional,
            num_buckets=self.num_buckets, max_distance=self.max_distance,
        )
        bias = self.w[bucket.to(self.w.device)]  # [Tq, Tk, H]
        return bias.permute(2, 0, 1)[None]


class T5Block(Module):
    """Pre-RMSNorm residual block: self-attn [+ cross-attn] + FF. The
    relative-position bias arrives from the stack (shared table)."""

    def __init__(self, cfg: T5Config, *, causal: bool, cross: bool,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.causal = causal
        self.cross = cross
        kw = {"device": device, "dtype": dtype}

        def mk_attn():
            # causality rides the explicit mask (the rel bias needs the
            # same [Tq, Tk] geometry anyway)
            return MultiHeadAttention(
                cfg.dim, cfg.num_heads, head_dim=cfg.head_dim, use_bias=False,
                causal=False, attn_impl="reference", scale=1.0, **kw,
            )

        self.norm1 = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        self.attn = mk_attn()
        if cross:
            self.norm_x = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
            self.xattn = mk_attn()
        self.norm2 = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        # v1.0 is the ungated ReLU MLP, v1.1 act(gate(x)) * up(x) with
        # gelu_new: HF's act(wi_0(x)) * wi_1(x)
        self.ff = FeedForward(
            cfg.dim, cfg.hidden_dim,
            activation="gelu" if cfg.gated_ff else "relu",
            use_bias=False, gated=cfg.gated_ff, dropout=cfg.dropout, **kw,
        )
        self.drop = Dropout(cfg.dropout)

    def _local_bias(self, bias):
        """The bias rows of the heads this block's attention holds: all of
        them, or under tensor parallelism this rank's contiguous share."""
        if bias is None:
            return None
        hl = self.attn.q.width() // self.attn.head_dim
        if bias.shape[1] == hl:
            return bias
        from tensorlink_tpu_torch.parallel import tp

        r = tp.model_rank()
        return bias[:, r * hl:(r + 1) * hl]

    def forward(self, x, *, mask=None, bias=None, memory=None,
                memory_mask=None, cross_kv=None, cache=None, rng=None,
                train: bool = False, **_):
        bias = self._local_bias(bias)
        h = self.norm1(x)
        if cache is None:
            a = self.attn(h, mask=mask, bias=bias)
            new_cache = None
        else:
            a, new_cache = self.attn(h, mask=mask, bias=bias, cache=cache)
        x = x + self.drop(a, rng=rng, train=train)
        if self.cross:
            h = self.norm_x(x)
            a = self.xattn(h, kv=memory, precomputed_kv=cross_kv,
                           mask=memory_mask)
            x = x + self.drop(a, rng=rng, train=train)
        h = self.norm2(x)
        f = self.ff(h, rng=rng, train=train)
        x = x + self.drop(f, rng=rng, train=train)
        if cache is not None:
            return x, new_cache
        return x


class T5(Module):
    """Encoder-decoder; ``forward`` returns decoder LM logits.
    ``T5(cfg, device=None, dtype=torch.float32, seed=0)``: parameters on
    ``device`` (CUDA unless told otherwise), filled from ``seed``."""

    def __init__(self, cfg: T5Config = T5Config(), *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg_obj = cfg
        kw = {"device": dev, "dtype": dtype}
        self.shared = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.enc_rel = RelativePositionBias(
            cfg.num_heads, cfg.rel_buckets, cfg.rel_max_distance,
            bidirectional=True, **kw)
        self.dec_rel = RelativePositionBias(
            cfg.num_heads, cfg.rel_buckets, cfg.rel_max_distance,
            bidirectional=False, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"enc{i}", T5Block(cfg, causal=False, cross=False, **kw))
        self.enc_norm = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"dec{i}", T5Block(cfg, causal=True, cross=True, **kw))
        self.dec_norm = RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.dim, cfg.vocab_size, use_bias=False,
                                 shard="col", **kw)
        self.drop = Dropout(cfg.dropout)
        init_parameters(self, dev, seed)

    def _block(self, name: str) -> T5Block:
        return self._modules[name]

    # ------------------------------------------------------------- encoder
    def encode(self, input_ids, *, attention_mask=None,
               rng: torch.Generator | None = None, train: bool = False):
        cfg = self.cfg_obj
        T = input_ids.shape[1]
        x = self.drop(self.shared(input_ids), rng=rng, train=train)
        bias = self.enc_rel(T, T)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i in range(cfg.num_layers):
            x = self._block(f"enc{i}")(x, mask=mask, bias=bias, rng=rng,
                                       train=train)
        return self.enc_norm(x)

    # ------------------------------------------------------------- decoder
    @staticmethod
    def _dec_mask(B: int, T: int, device) -> torch.Tensor:
        tri = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
        return tri[None, None].expand(B, 1, T, T)

    def decode(self, decoder_ids, memory, *, memory_mask=None,
               decoder_attention_mask=None, rng: torch.Generator | None = None,
               train: bool = False):
        cfg = self.cfg_obj
        B, T = decoder_ids.shape
        x = self.drop(self.shared(decoder_ids), rng=rng, train=train)
        bias = self.dec_rel(T, T)
        mask = self._dec_mask(B, T, decoder_ids.device)
        if decoder_attention_mask is not None:
            # padded decoder batches: real positions must not attend to
            # pad keys that precede them under the causal mask
            mask = mask & decoder_attention_mask[:, None, None, :].bool()
        mm = None
        if memory_mask is not None:
            mm = memory_mask[:, None, None, :].bool()
        for i in range(cfg.num_layers):
            x = self._block(f"dec{i}")(x, mask=mask, bias=bias, memory=memory,
                                       memory_mask=mm, rng=rng, train=train)
        return self._lm_logits(self.dec_norm(x))

    def _lm_logits(self, x):
        cfg = self.cfg_obj
        if cfg.tie_word_embeddings:
            # T5 rescales tied logits by d^-0.5 (the missing attention
            # scale's twin convention)
            x = x * (cfg.dim ** -0.5)
            return self.shared.attend(x)
        y = self.lm_head(x)
        if self.lm_head.width() != cfg.vocab_size:
            # a column block of the head gives this rank's vocab slice
            from tensorlink_tpu_torch.parallel import tp

            y = tp.gather_from_model(y)
        return y

    def forward(self, input_ids, decoder_input_ids, *, attention_mask=None,
                decoder_attention_mask=None, rng: torch.Generator | None = None,
                train: bool = False, **_):
        memory = self.encode(input_ids, attention_mask=attention_mask, rng=rng,
                             train=train)
        return self.decode(
            decoder_input_ids, memory, memory_mask=attention_mask,
            decoder_attention_mask=decoder_attention_mask, rng=rng,
            train=train,
        )

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def greedy_decode(self, input_ids, *, attention_mask=None,
                      max_new_tokens: int = 32, start_id: int = 0) -> torch.Tensor:
        """Greedy seq2seq generation, KV-cached: the encoder runs once,
        each decoder layer's cross-attention k/v are projected ONCE
        (``project_kv``), and self-attention reads its per-layer cache,
        one single-token decoder pass per emitted token. Exact against
        re-running ``decode()`` on the emitted prefix: the rel-pos bias row
        for query position t is sliced from the same table, and the
        cache's validity mask plays the causal mask's role for the lone
        query. -> int32 [B, max_new_tokens] on the CPU."""
        cfg = self.cfg_obj
        B = input_ids.shape[0]
        L = int(max_new_tokens) + 1
        memory = self.encode(input_ids, attention_mask=attention_mask)
        mm = None
        if attention_mask is not None:
            mm = attention_mask[:, None, None, :].bool()
        blocks = [self._block(f"dec{i}") for i in range(cfg.num_layers)]
        cross_kv = [blk.xattn.project_kv(memory) for blk in blocks]
        caches = [blk.attn.init_cache(B, L, dtype=memory.dtype,
                                      device=memory.device) for blk in blocks]
        bias_full = self.dec_rel(L, L)  # row t is step t's bias
        tok = torch.full((B,), start_id, dtype=torch.int64,
                         device=input_ids.device)
        out = []
        for t in range(int(max_new_tokens)):
            h = self.shared(tok[:, None])
            bias = bias_full[:, :, t:t + 1]  # [1, H, 1, L]
            for i, blk in enumerate(blocks):
                h, caches[i] = blk(h, bias=bias, cross_kv=cross_kv[i],
                                   memory_mask=mm, cache=caches[i])
            logits = self._lm_logits(self.dec_norm(h))[:, 0]
            tok = logits.float().argmax(dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32).cpu()
