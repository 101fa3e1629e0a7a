"""Attention (port of ``tensorlink_tpu/nn/attention.py``): the plain
reference implementation, RoPE, ``resolve_attn_impl``, and
``MultiHeadAttention`` with its no-cache path (through the module's
``attn_impl``: the plain reference, or ``ops.flash``'s routing to the
flash kernels B1/B2) and its paged-cache path.

Paged cache form (``init_paged_cache``; the serving engine owns it):
  ``k``/``v``     [num_blocks, block_size, Hkv, D] pools shared by all
                  rows (int8 with ``k_scale``/``v_scale`` [num_blocks,
                  block_size, Hkv] f32 siblings when quantized);
  ``index``       [B] int32 — each row's logical write position;
  ``block_table`` [B, max_blocks] int32 — row r's logical block j lives
                  in pool block ``block_table[r, j]``; the sentinel
                  ``num_blocks`` marks unmapped entries, and writes
                  through it are dropped.

The paged write updates the pools IN PLACE (the JAX package returns new
pools; here the engine's preallocated device buffers are the state) and
returns a new cache dict whose ``index`` has advanced by T. The read goes
through ``ops.paged_decode.paged_decode_attention``: the hand-written
kernel for CUDA tensors, its plain version for CPU tensors.

The contiguous (per-slot region) cache path and the fused q/k/v layout
wait for a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from tensorlink_tpu_torch.nn.layers import Dense
from tensorlink_tpu_torch.ops.paged_decode import paged_decode_attention
from tensorlink_tpu_torch.ops.quant import quantize_kv_int8

NEG_INF = -1e30


def band_keep(q_pos, k_pos, causal: bool, window: int | None):
    """THE positional attend predicate: attend iff k <= q (causal) and
    k in (q - window, q]; symmetric band |q - k| < window when not
    causal. None = no positional constraint."""
    if not causal and window is None:
        return None
    keep = None
    if causal:
        keep = q_pos >= k_pos
    if window is not None:
        lo = k_pos > q_pos - window
        keep = lo if keep is None else keep & lo
        if not causal:
            keep = keep & (k_pos < q_pos + window)
    return keep


def dot_product_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, D]
    *,
    causal: bool = False,
    mask: torch.Tensor | None = None,  # [B, 1|H, Tq, Tk] bool, True=attend
    bias: torch.Tensor | None = None,  # additive [1|B, H, Tq, Tk]
    q_offset: int = 0,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Reference attention with an f32 softmax; scores and the
    probability-weighted sum run in the inputs' dtype as in the JAX
    package (probabilities are cast to v's dtype first)."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    if Hkv != H:  # grouped-query: repeat kv heads (jnp.repeat order)
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = D ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal or window is not None:
        Tk = k.shape[1]
        qpos = torch.arange(Tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Tk, device=q.device)[None, :]
        keep = band_keep(qpos, kpos, causal, window)
        logits = torch.where(keep[None, None], logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last dim, half-split layout.
    x: [B, T, H, D]; positions [T] or [B, T]. Math in f32."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (
        theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., None].float() * freqs  # [B?, T, half]
    while angles.dim() < x.dim():
        angles = (
            angles[..., None, :] if angles.dim() == x.dim() - 1
            else angles[None]
        )
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def resolve_attn_impl(impl) -> Callable:
    """Map an ``attn_impl`` name to its function:

    - "reference": ``dot_product_attention`` above;
    - "auto": ``ops.flash.flash_attention_impl`` — the flash kernels on
      the shapes the reference routes to its kernel (``T >= 512``), the
      plain reference otherwise;
    - "flash": the same with ``min_kernel_seq=0`` (the kernel at every
      eligible shape);
    - a callable: itself.

    The sequence-parallel impls ("ring", "ulysses") wait for the SP
    slice."""
    if callable(impl):
        return impl
    if impl == "reference":
        return dot_product_attention
    if impl in ("flash", "auto"):
        # lazy: ops.flash imports this module
        from tensorlink_tpu_torch.ops.flash import flash_attention_impl

        if impl == "flash":
            import functools

            return functools.partial(flash_attention_impl, min_kernel_seq=0)
        return flash_attention_impl
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl {impl!r} (sequence parallel) waits for the SP slice"
        )
    raise ValueError(f"unknown attn_impl {impl!r}")


def paged_write_slots(index: torch.Tensor, block_table: torch.Tensor,
                      T: int, num_blocks: int, block_size: int):
    """Where the T fresh tokens of every row land in the pools:
    ``(rows, tokens, blocks, offsets)`` of the writes that are KEPT.
    Token t of row r goes to logical position ``index[r] + t``, i.e.
    block ``block_table[r, pos // bs]`` at offset ``pos % bs``. Writes
    through the sentinel (unmapped entries, and rows past their table)
    are dropped by filtering — never clamped into a real block. The
    filter reads the device (one host sync); callers that run many
    layers at the same index compute it once and pass it in the cache
    as ``write_slots``."""
    B, MB = block_table.shape
    tpos = index.long()[:, None] + torch.arange(T, device=index.device)[None, :]
    bslot = tpos // block_size
    blk = torch.gather(block_table.long(), 1, bslot.clamp(max=MB - 1))
    blk = torch.where(bslot >= MB, num_blocks, blk)
    keep = (blk >= 0) & (blk < num_blocks)
    rows, toks = keep.nonzero(as_tuple=True)
    return rows, toks, blk[rows, toks], (tpos % block_size)[rows, toks]


class MultiHeadAttention(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        num_kv_heads: int | None = None,
        head_dim: int | None = None,
        use_bias: bool = True,
        rope: bool = False,
        rope_theta: float = 10000.0,
        causal: bool = False,
        scale: float | None = None,
        window: int | None = None,
        attn_impl: str | Callable = "auto",
        *,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim or dim // num_heads
        self.use_bias = use_bias
        self.rope = rope
        self.rope_theta = rope_theta
        self.causal = causal
        self._attn = resolve_attn_impl(attn_impl)
        if window is not None:
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            # an impl that ignores the window would silently widen
            # attention to full context: only the reference, the flash
            # routing, or a callable that declares support may take one
            from tensorlink_tpu_torch.ops.flash import flash_attention_impl

            base = self._attn
            while hasattr(base, "func"):  # unwrap partials
                base = base.func
            declares = getattr(self._attn, "supports_window", False) or getattr(
                base, "supports_window", False
            )
            if base not in (dot_product_attention, flash_attention_impl) \
                    and not declares:
                raise ValueError(
                    "sliding-window attention requires attn_impl "
                    "'reference', 'flash', or 'auto', or a callable marked "
                    "`supports_window = True` that honors the window kwarg"
                )
        self.window = window
        if scale is not None and self._attn is not dot_product_attention:
            # only the reference honors a custom scale; the flash kernels
            # use 1/sqrt(D)
            raise ValueError(
                "custom attention scale requires the reference attention "
                "implementation"
            )
        self.scale = scale
        qdim = self.num_heads * self.head_dim
        kvdim = self.num_kv_heads * self.head_dim
        kw = {"device": device, "dtype": dtype}
        self.q = Dense(dim, qdim, use_bias, **kw)
        self.k = Dense(dim, kvdim, use_bias, **kw)
        self.v = Dense(dim, kvdim, use_bias, **kw)
        self.o = Dense(qdim, dim, use_bias, **kw)

    def forward(self, x, *, mask=None, cache=None, positions=None,
                bias=None):
        B, T, _ = x.shape
        if bias is not None and self._attn is not dot_product_attention:
            # the flash routing swallows unknown kwargs: an additive bias
            # must not be silently dropped
            raise NotImplementedError(
                "additive attention bias requires attn_impl='reference'"
            )
        q = self.q(x).reshape(B, T, self.num_heads, self.head_dim)
        k = self.k(x).reshape(B, T, self.num_kv_heads, self.head_dim)
        v = self.v(x).reshape(B, T, self.num_kv_heads, self.head_dim)
        if cache is not None and "block_table" not in cache:
            raise NotImplementedError(
                "only the paged KV cache is ported; the contiguous cache "
                "waits for a later slice"
            )
        if positions is None:
            if cache is not None and self.rope:
                raise ValueError(
                    "paged rows sit at different logical positions: pass "
                    "positions explicitly"
                )
            positions = torch.arange(T, device=x.device)[None, :]
        if self.rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        if cache is not None:
            if bias is not None:
                raise NotImplementedError(
                    "additive attention bias with a paged cache is not "
                    "supported"
                )
            out, new_cache = self._apply_paged(q, k, v, cache, mask)
            return self.o(out.reshape(B, T, -1)), new_cache
        out = self._attn(
            q, k, v, causal=self.causal, mask=mask, q_offset=0, bias=bias,
            scale=self.scale, window=self.window,
        )
        return self.o(out.reshape(B, T, -1))

    def _apply_paged(self, q, k, v, cache, mask):
        """Scatter the T fresh tokens through each row's block table into
        the shared pools (in place), then attend the row's logical view
        — causality and the window band in logical coordinates, the
        caller's view-width mask further restricting. int8 pools quantize
        at write and dequantize at read (inside the kernel on CUDA)."""
        if self.scale is not None:
            raise NotImplementedError(
                "a custom attention scale has no paged path"
            )
        B, T = q.shape[0], q.shape[1]
        bt, idx = cache["block_table"], cache["index"]
        if idx.dim() != 1:
            raise ValueError(
                f"paged cache needs a per-row [B] index, got ndim {idx.dim()}"
            )
        ck, cv = cache["k"], cache["v"]
        NB, bs = ck.shape[0], ck.shape[1]
        Lv = bt.shape[1] * bs
        slots = cache.get("write_slots")
        if slots is None:
            slots = paged_write_slots(idx, bt, T, NB, bs)
        rows, toks, blk, off = slots
        quant = "k_scale" in cache
        if quant:
            qk, sk = quantize_kv_int8(k)
            qv, sv = quantize_kv_int8(v)
            ck[blk, off] = qk[rows, toks]
            cv[blk, off] = qv[rows, toks]
            cache["k_scale"][blk, off] = sk[rows, toks]
            cache["v_scale"][blk, off] = sv[rows, toks]
        else:
            ck[blk, off] = k[rows, toks].to(ck.dtype)
            cv[blk, off] = v[rows, toks].to(cv.dtype)
        new_cache = {
            name: val for name, val in cache.items() if name != "write_slots"
        }
        new_cache["index"] = idx + T
        if mask is not None:
            if mask.shape[-1] != Lv:
                raise ValueError(
                    "paged cache attention needs a view-width mask (last "
                    f"dim {Lv}), got {tuple(mask.shape)}"
                )
            mask = mask.expand(B, 1, mask.shape[2], Lv).contiguous()
        out = paged_decode_attention(
            q.contiguous(), ck, cv, bt, new_cache["index"].int(),
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            mask=mask, window=self.window,
        )
        return out, new_cache

    def init_paged_cache(
        self, num_blocks: int, block_size: int, batch: int, max_blocks: int,
        dtype=torch.bfloat16, quant: str | None = None, *, device=None,
    ) -> dict:
        """Paged cache form (see the module docstring): pools of
        ``num_blocks`` blocks, per-row write index 0, block table at the
        sentinel. ``quant="int8"``: int8 pools with f32 scales initialized
        to 1.0 (unwritten blocks dequantize to exact zeros); ``dtype`` is
        then ignored for k/v."""
        if quant not in (None, "int8"):
            raise ValueError(f"unknown paged cache quant {quant!r}")
        shape = (num_blocks, block_size, self.num_kv_heads, self.head_dim)
        cache = {
            "index": torch.zeros((batch,), dtype=torch.int32, device=device),
            "block_table": torch.full(
                (batch, max_blocks), num_blocks, dtype=torch.int32,
                device=device,
            ),
        }
        if quant == "int8":
            cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache["k_scale"] = torch.ones(shape[:-1], device=device)
            cache["v_scale"] = torch.ones(shape[:-1], device=device)
        else:
            cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
            cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
        return cache
