"""``flash_attention``: the public entry to kernels B1 and B2 (port of
``tensorlink_tpu/ops/flash.py``).

Layout matches ``nn.attention``: ``[B, T, H, D]``. ``flash_attention`` is
a ``torch.autograd.Function`` whose forward is B1
(``ops.flash_attention.flash_attention_fwd_lse``) and whose backward is
B2 (``flash_attention_bwd``): no [Tq, Tk] matrix is kept between them,
only o and the per-row LSE. The kernels read the [B, T, H, D] tensors as
transposed views, so no layout copy is made. Padding masks ride along as
a key-validity vector ``[B, Tk]`` (BERT's attention_mask), which gets no
gradient.

``flash_attention_impl`` is the ``attn_impl`` that ``MultiHeadAttention``
calls, with the reference's routing rule: the kernel pair for a no-cache
call with no mask or a key-padding mask, ``q_offset == 0``, ``Tq == Tk``,
``T >= min_kernel_seq`` and ``_tile_ok`` lengths; the plain
``dot_product_attention`` otherwise. So the port takes the kernel at
exactly the shapes where the JAX package does on its chip.
"""

from __future__ import annotations

import torch

from tensorlink_tpu_torch.nn.attention import band_keep, dot_product_attention
from tensorlink_tpu_torch.ops.flash_attention import (  # noqa: F401 (sp.py)
    KERNEL_BLOCK,
    LSE_MASKED,
    flash_attention_bwd,
    flash_attention_fwd_lse,
)


def _tile_ok(T: int) -> bool:
    """The reference's kernel-path shape rule (its TPU tiling); the CUDA
    kernel itself takes any length."""
    return T % 128 == 0 or T in (8, 16, 32, 64)


# per-(seq, batch) block sizes: {(seq, batch | None): block}. An exact
# (seq, batch) entry wins over (seq, None); anything else gets the
# kernel's own tile.
_BLOCK_OVERRIDES: dict[tuple[int, int | None], int] = {}
KERNEL_BLOCKS = (KERNEL_BLOCK,)  # the tiles csrc/flash_attention.cu takes


def set_flash_block_override(
    seq: int, block: int, *, batch: int | None = None
) -> None:
    """Pin the flash kernel block size for sequence length ``seq``
    (optionally only at ``batch``). ``block`` must divide ``seq`` and be a
    tile the CUDA kernel takes (``KERNEL_BLOCKS``) — validated here,
    instead of failing at the next launch."""
    if block < 1 or seq % block:
        raise ValueError(
            f"flash block override {block} does not divide seq {seq}"
        )
    if block not in KERNEL_BLOCKS:
        raise ValueError(
            f"flash block override {block}: the CUDA kernel takes blocks "
            f"{KERNEL_BLOCKS}"
        )
    _BLOCK_OVERRIDES[(int(seq), None if batch is None else int(batch))] = int(block)


def clear_flash_block_overrides() -> None:
    _BLOCK_OVERRIDES.clear()


def flash_block_overrides() -> list[tuple[int, int | None, int]]:
    """Snapshot of the installed overrides as ``(seq, batch|None, block)``
    rows."""
    return sorted(
        ((seq, batch, block)
         for (seq, batch), block in _BLOCK_OVERRIDES.items()),
        key=lambda t: (t[0], -1 if t[1] is None else t[1], t[2]),
    )


def flash_block_for(seq: int, batch: int | None = None) -> int:
    """Resolved block size for a (seq, batch) shape: exact-batch
    override, then any-batch override, then the kernel's tile."""
    if batch is not None:
        b = _BLOCK_OVERRIDES.get((seq, int(batch)))
        if b is not None:
            return b
    b = _BLOCK_OVERRIDES.get((seq, None))
    if b is not None:
        return b
    return KERNEL_BLOCK


class _FlashAttention(torch.autograd.Function):
    """forward = B1, backward = B2, on [B, T, H, D] tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, window):
        B = q.shape[0]
        blocks = {
            "block_q": flash_block_for(q.shape[1], B),
            "block_k": flash_block_for(k.shape[1], B),
        }
        o, lse = flash_attention_fwd_lse(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_mask,
            causal=causal, window=window, **blocks,
        )
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.window, ctx.blocks = causal, window, blocks
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), o, lse,
            g.contiguous().transpose(1, 2), kv_mask, causal=ctx.causal,
            window=ctx.window, **ctx.blocks,
        )
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None)


def _kernel_path(q, k) -> bool:
    return _tile_ok(q.shape[1]) and _tile_ok(k.shape[1])


def flash_attention(q, k, v, kv_mask=None, causal: bool = False,
                    window: int | None = None):
    """q: [B, T, H, D]; k, v: [B, T, Hkv, D] (Hkv divides H — GQA is read
    in-kernel, no repeat); kv_mask: [B, Tk] bool/float (nonzero=attend);
    window: sliding-window band. -> [B, T, H, D]. Lengths outside the
    reference's kernel rule (``_tile_ok``) take ``_fallback_attn``, as
    they do in the JAX package."""
    if _kernel_path(q, k):
        return _FlashAttention.apply(q, k, v, kv_mask, causal, window)
    return _fallback_attn(q, k, v, kv_mask, causal, window)


def _fallback_attn(q, k, v, kv_mask, causal, window=None):
    """Plain path matched to the kernel's convention: a row whose keys are
    ALL masked outputs exact zeros (softmax over an all-(-1e30) row would
    otherwise return mean(v))."""
    mask = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    out = dot_product_attention(q, k, v, causal=causal, mask=mask, window=window)
    if kv_mask is not None:
        kvf = kv_mask != 0
        Tq, Tk = q.shape[1], k.shape[1]
        if window is not None and Tq == Tk:
            # row i's visible keys are the band: valid iff any padding
            # survivor falls inside it
            band = band_keep(
                torch.arange(Tq, device=q.device)[:, None],
                torch.arange(Tk, device=q.device)[None, :], causal, window,
            )
            row_valid = (band[None] & kvf[:, None, :]).any(dim=-1)  # [B, Tq]
        elif causal and Tq == Tk:
            # row i sees keys [0, i]: valid iff any of those survives
            row_valid = kvf.cumsum(dim=-1) > 0  # [B, Tq]
        else:
            row_valid = kvf.any(dim=-1, keepdim=True)  # [B, 1]
        out = out * row_valid[..., None, None].to(out.dtype)
    return out


def _as_kv_mask(mask, B: int, Tk: int):
    """Extract a [B, Tk] key-validity vector from a broadcastable
    [B|1, 1, 1, Tk] padding mask; None if the mask is more general.
    Batch-1 masks are broadcast up to B."""
    if mask is None:
        return None, True
    if (
        mask.dim() == 4
        and mask.shape[0] in (1, B)
        and mask.shape[1] == 1
        and mask.shape[2] == 1
        and mask.shape[3] == Tk
    ):
        kv = mask[:, 0, 0, :]
        if kv.shape[0] != B:
            kv = kv.expand(B, Tk)
        return kv, True
    return None, False


# The reference's routing threshold: below this sequence length the
# reference takes the einsum path. It was tuned for the TPU; the H100's
# crossover is measured by chip_smoke.py and recorded in PERF.md, and the
# rule stays the reference's until a benchmark says otherwise.
MIN_KERNEL_SEQ_AUTO = 512


def flash_attention_impl(
    q, k, v, *, causal=False, mask=None, q_offset=0,
    min_kernel_seq: int = MIN_KERNEL_SEQ_AUTO, window=None, **_,
):
    """Drop-in ``attn_impl`` for MultiHeadAttention: the flash kernels on
    the no-cache path (plain or key-padding mask; GQA read in-kernel), the
    plain reference otherwise (offset queries, general masks, unequal or
    off-rule lengths, or sequences below ``min_kernel_seq`` —
    attn_impl='flash' forces the kernel via min_kernel_seq=0)."""
    offset_is_zero = isinstance(q_offset, int) and q_offset == 0
    kv_mask, mask_ok = _as_kv_mask(mask, q.shape[0], k.shape[1])
    if (
        mask_ok and offset_is_zero and k.shape[1] == q.shape[1]
        and max(q.shape[1], k.shape[1]) >= min_kernel_seq
        and _kernel_path(q, k)
    ):
        return flash_attention(q, k, v, kv_mask, causal, window)
    return dot_product_attention(
        q, k, v, causal=causal, mask=mask, q_offset=q_offset, window=window
    )
