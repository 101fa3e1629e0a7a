"""Attention (port of ``tensorlink_tpu/nn/attention.py``): the plain
reference implementation, RoPE, ``resolve_attn_impl``, the
length-bounded ``decode_attention_blockwise``, and
``MultiHeadAttention`` with its no-cache path (through the module's
``attn_impl``: the plain reference, or ``ops.flash``'s routing to the
flash kernels B1/B2), its contiguous-cache path and its paged-cache path.

Contiguous cache form (``init_cache``; one region of ``max_len`` slots a
row):
  ``k``/``v``  [B, max_len, Hkv, D];
  ``index``    a 0-d int32 tensor — every row writes at the same slot
               (the static ``generate`` loop) — or [B] int32, each row's
               own write position (the serving engine's slot form);
  ``rolling``  present (value None) on a ring cache, whose writes wrap
               modulo its capacity;
  ``frontier`` optional host ``(lo, hi)`` ints with ``lo <= index <= hi``
               for every row that is still decoding: the block bounds of
               the blockwise decode, so that no layer reads the index back
               from the device. Without it the blockwise decode covers
               every block, which gives the same outputs. The bounds
               matter only through ``decode_blocks`` (the blocks read),
               which is what a captured decode step bakes in.

Paged cache form (``init_paged_cache``; the serving engine owns it):
  ``k``/``v``     [num_blocks + 1, block_size, Hkv, D] pools shared by
                  all rows (int8 with ``k_scale``/``v_scale``
                  [num_blocks + 1, block_size, Hkv] f32 siblings when
                  quantized); row ``num_blocks`` is a scratch block that
                  takes every dropped write and is never read;
  ``index``       [B] int32 — each row's logical write position;
  ``block_table`` [B, max_blocks] int32 — row r's logical block j lives
                  in pool block ``block_table[r, j]``; the sentinel
                  ``num_blocks`` marks unmapped entries, and writes
                  through it (or past the table) land in the scratch
                  block: no write needs a host-side filter, so a decode
                  step can be captured in a CUDA graph.

Both caches are written IN PLACE (the JAX package returns new arrays;
here the preallocated device buffers are the state), and the module
returns a new cache dict whose ``index`` has advanced by T. The paged
read goes through ``ops.paged_decode.paged_decode_attention``: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors.
The contiguous read is plain PyTorch, as it is XLA code in the JAX
package.

``qkv_fused=True`` projects q, k and v with ONE ``Dense`` (``qkv``) in
the reference's per-kv-group interleave ``[D, G, (H/G q | k | v), Dh]``
(``fuse_qkv_params`` converts a q/k/v param tree to it). Every path —
no cache, contiguous, blockwise, paged, the speculative verify pass and
the draft — projects through ``_project_qkv``, the one place that knows
either layout. The port's attention has no cross-attention source (the
reference refuses ``qkv_fused`` there), so there is no such path to
refuse.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


DECODE_BLOCK = 256
# windowless decode takes the blockwise path only above this cache size
# (slots); the reference's threshold, kept so both packages route alike
DECODE_BLOCKWISE_MIN_WINDOWLESS = 8 * DECODE_BLOCK


def decode_attention_blockwise(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, L, Hkv, D] — the whole cache
    v: torch.Tensor,
    live_len: int,  # host int: slots [0, live_len) may be real
    *,
    mask: torch.Tensor | None = None,  # [B, 1|H, 1|Tq, L] bool over slots
    block: int = DECODE_BLOCK,
    start: int = 0,  # host int: no slot below it is attendable
) -> torch.Tensor:
    """Length-bounded decode attention: the online softmax over the cache
    blocks ``[start // block, ceil(live_len / block))``, clamped to the
    capacity, so a step's cost tracks the live prefix (and, with a
    window, the window) rather than the capacity. Both bounds are host
    ints the caller already knows; reading them from the device would
    cost a host sync per layer per step. Validity and causality come
    from ``mask`` alone: slots at or past ``live_len`` must be masked by
    the caller. Requires ``L % block == 0``.

    Each block's softmax state (max, sum, p @ v) is formed in one batched
    pass and the states are merged by their maxima: the reference's merge,
    which its ``fori_loop`` applies one block at a time (a static-shape
    program needs the loop for a dynamic length), done for all blocks at
    once, so a layer costs the same few eager ops at any live length. A
    row with no attendable slot gives zeros."""
    B, Tq, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    if L % block:
        raise ValueError(
            f"blockwise decode needs cache {L} % block {block} == 0"
        )
    rep = H // Hkv
    b0, nb = decode_block_range(L, live_len, start, block)
    if b0 >= nb:
        return torch.zeros_like(q)
    n, sl = nb - b0, slice(b0 * block, nb * block)
    # GQA without repeating the cache: query heads grouped by kv head
    qg = q.reshape(B, Tq, Hkv, rep, D)
    kb, vb = k[:, sl], v[:, sl]
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb).float() * D ** -0.5
    s = s.reshape(B, H, Tq, n, block)
    if mask is not None:
        mb = mask[..., sl]
        mb = mb.reshape(*mb.shape[:-1], n, block)
        s = torch.where(mb, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # [B, H, Tq, n, 1]
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mb, p, 0.0)
    den = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum(
        "bgrqjk,bjkgd->bgrqjd", p.to(vb.dtype).reshape(B, Hkv, rep, Tq, n, block),
        vb.reshape(B, n, block, Hkv, D),
    ).float().reshape(B, H, Tq, n, D)
    alpha = torch.exp(m - m.amax(dim=3, keepdim=True))
    den = (alpha * den).sum(dim=3)  # [B, H, Tq, 1]
    acc = (alpha * pv).sum(dim=3)  # [B, H, Tq, D]
    out = acc / torch.where(den == 0.0, 1.0, den)
    return out.transpose(1, 2).to(q.dtype)


def decode_block_range(cap: int, live_len: int, start: int = 0,
                       block: int = DECODE_BLOCK) -> tuple[int, int]:
    """-> the blocks ``[b0, nb)`` ``decode_attention_blockwise`` reads for
    host bounds ``live_len`` and ``start`` over a cache of ``cap`` slots;
    clamped, so a frontier within T slots of the end never runs a block
    past the capacity."""
    nb = min(-(-int(live_len) // block), cap // block)
    return max(int(start), 0) // block, nb


def fuse_qkv_params(attn_params: dict, num_heads: int, num_kv_heads: int,
                    head_dim: int) -> dict:
    """One attention's params ``{"q", "k", "v", "o"}`` (each ``{"w"[,
    "b"]}``, numpy arrays or tensors) -> the fused layout ``{"qkv",
    "o"}`` that ``MultiHeadAttention(qkv_fused=True)`` expects: the
    reference's per-kv-group interleave ``[D, G, (hq q | k | v), Dh]``
    flattened on the output dim. Tensors in give tensors out (on their
    device, in their dtype); extra keys are refused, as in the
    reference."""
    extra = set(attn_params) - {"q", "k", "v", "o"}
    if extra:
        raise ValueError(f"cannot fuse attention params with extras {extra}")
    G, hq = num_kv_heads, num_heads // num_kv_heads

    def cat(name):
        parts = [attn_params[n][name] for n in ("q", "k", "v")]
        as_np = not isinstance(parts[0], torch.Tensor)
        if as_np:
            parts = [torch.from_numpy(np.array(p, copy=True)) for p in parts]
        lead = parts[0].shape[:-1]  # (D,) for w, () for b
        qw = parts[0].reshape(*lead, G, hq, head_dim)
        kw_ = parts[1].reshape(*lead, G, 1, head_dim)
        vw = parts[2].reshape(*lead, G, 1, head_dim)
        f = torch.cat([qw, kw_, vw], dim=-2).reshape(*lead, G * (hq + 2) * head_dim)
        return f.numpy() if as_np else f

    qkv = {"w": cat("w")}
    if "b" in attn_params["q"]:
        qkv["b"] = cat("b")
    return {"qkv": qkv, "o": attn_params["o"]}


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
    ``(blocks, offsets)``, both [B, T]. Token t of row r goes to logical
    position ``index[r] + t``, i.e. block ``block_table[r, pos // bs]`` at
    offset ``pos % bs``. A write through the sentinel (an unmapped entry,
    or a position past the row's table) goes to the scratch block
    ``num_blocks``, never clamped into a real block: every write is kept,
    so there is no filter and no host sync. Callers that run many layers
    at the same index compute this once and pass it in the cache as
    ``write_slots``."""
    MB = block_table.shape[1]
    tpos = index.long()[:, None] + torch.arange(T, device=index.device)[None, :]
    bslot = tpos // block_size
    blk = torch.gather(block_table.long(), 1, bslot.clamp(max=MB - 1))
    blk = torch.where(bslot >= MB, num_blocks, blk)
    return blk, tpos % block_size


def paged_write(cache: dict, k: torch.Tensor, v: torch.Tensor, slots) -> None:
    """In place: every row's T fresh k/v [B, T, Hkv, D] into the pools at
    ``slots = paged_write_slots(...)`` (dropped writes into the scratch
    block), quantized first on int8 pools."""
    blk, off = slots
    if "k_scale" in cache:
        qk, sk = quantize_kv_int8(k)
        qv, sv = quantize_kv_int8(v)
        cache["k"][blk, off] = qk
        cache["v"][blk, off] = qv
        cache["k_scale"][blk, off] = sk
        cache["v_scale"][blk, off] = sv
    else:
        cache["k"][blk, off] = k.to(cache["k"].dtype)
        cache["v"][blk, off] = v.to(cache["v"].dtype)


def write_rows(caches, news, index: torch.Tensor) -> None:
    """In place, for each (cache [B, cap, ...], new [B, T, ...]) pair:
    token t of row r goes to slot ``index[r] + t``, and a write at or
    past the capacity is dropped (a clamp would corrupt the row's last
    real slot). Without a host sync: a dropped write lands on slot
    cap - 1 carrying the value that slot holds once the kept writes are
    done (the row's token there, or the slot's old value), so writes that
    share a slot agree and the scatter's order does not matter."""
    B, cap = caches[0].shape[:2]
    T = news[0].shape[1]
    idx = index.long()
    slots = idx[:, None] + torch.arange(T, device=idx.device)[None, :]
    rows = torch.arange(B, device=idx.device)
    kept = slots < cap
    kept_last = idx < cap
    t_last = (cap - 1 - idx).clamp(0, T - 1)
    dst = (rows[:, None], slots.clamp(max=cap - 1))
    for cache, new in zip(caches, news):
        new = new.to(cache.dtype)
        bcast = (1,) * (new.dim() - 2)
        last = torch.where(kept_last.view(B, *bcast), new[rows, t_last],
                           cache[:, cap - 1])
        cache[dst] = torch.where(kept.view(B, T, *bcast), new, last[:, None])


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
        qkv_fused: bool = False,
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
        self.qkv_fused = bool(qkv_fused)
        if self.qkv_fused:
            # one product instead of three, per-kv-group interleave so a
            # column split stays head-aligned (the reference's layout)
            if self.num_heads % self.num_kv_heads:
                raise ValueError("qkv_fused requires num_kv_heads | num_heads")
            G = self.num_kv_heads
            hq = self.num_heads // G
            self.qkv = Dense(dim, G * (hq + 2) * self.head_dim, use_bias, **kw)
        else:
            self.q = Dense(dim, qdim, use_bias, **kw)
            self.k = Dense(dim, kvdim, use_bias, **kw)
            self.v = Dense(dim, kvdim, use_bias, **kw)
        self.o = Dense(qdim, dim, use_bias, **kw)

    def _project_qkv(self, x):
        """-> q [B, T, H, Dh], k and v [B, T, Hkv, Dh], from either
        layout."""
        B, T, _ = x.shape
        H, G, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        if not self.qkv_fused:
            return (self.q(x).reshape(B, T, H, Dh),
                    self.k(x).reshape(B, T, G, Dh),
                    self.v(x).reshape(B, T, G, Dh))
        hq = H // G
        f = self.qkv(x).reshape(B, T, G, hq + 2, Dh)
        return f[:, :, :, :hq].reshape(B, T, H, Dh), f[:, :, :, hq], f[:, :, :, hq + 1]

    def forward(self, x, *, mask=None, cache=None, positions=None,
                bias=None, fresh_keys=None):
        B, T, _ = x.shape
        if bias is not None and self._attn is not dot_product_attention:
            # the flash routing swallows unknown kwargs: an additive bias
            # must not be silently dropped
            raise NotImplementedError(
                "additive attention bias requires attn_impl='reference'"
            )
        q, k, v = self._project_qkv(x)
        if self.rope:
            if positions is None:
                if cache is not None and cache["index"].dim() == 1:
                    raise ValueError(
                        "per-row cache indices with rope require explicit "
                        "positions (rows sit at different logical positions)"
                    )
                base = 0 if cache is None else cache["index"]
                positions = base + torch.arange(T, device=x.device)[None, :]
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        if cache is None:
            out = self._attn(
                q, k, v, causal=self.causal, mask=mask, q_offset=0, bias=bias,
                scale=self.scale, window=self.window,
            )
            return self.o(out.reshape(B, T, -1))
        if "block_table" in cache:
            if bias is not None:
                raise NotImplementedError(
                    "additive attention bias with a paged cache is not "
                    "supported"
                )
            out, new_cache = self._apply_paged(q, k, v, cache, mask)
        elif cache["index"].dim() == 1:
            out, new_cache = self._apply_rows(q, k, v, cache, mask, bias)
        else:
            out, new_cache = self._apply_contiguous(
                q, k, v, cache, mask, bias, fresh_keys
            )
        return self.o(out.reshape(B, T, -1)), new_cache

    def _blocks_min(self) -> int:
        """Cache size above which a decode step takes the blockwise path:
        a window skips straight to its band, so any cache of more than
        one block pays off; windowless, only a large one."""
        if self.window is not None:
            return DECODE_BLOCK
        return DECODE_BLOCKWISE_MIN_WINDOWLESS

    def _blockwise_bounds(self, cap: int, T: int, frontier):
        """Host ``(live_len, start)`` of a cached step's blockwise read, or
        None when a cache of ``cap`` slots takes the full-width read. The
        queries' earliest window start is ``lo + 1 - window``."""
        if (cap <= self._blocks_min() or cap % DECODE_BLOCK
                or self.scale is not None):
            return None
        lo, hi = frontier if frontier is not None else (0, cap)
        win = self.window
        return hi + T, 0 if win is None else max(lo + 1 - win, 0)

    def decode_blocks(self, cap: int, frontier, *, rolling: bool = False):
        """The cache blocks ``(b0, nb)`` a T == 1 decode step over ``cap``
        slots reads for this host ``frontier``, or None when it reads the
        whole cache (full width, the ring). The step depends on the
        frontier only through them, so a captured step is keyed by
        them."""
        bounds = None if rolling else self._blockwise_bounds(cap, 1, frontier)
        return None if bounds is None else decode_block_range(cap, *bounds)

    def _apply_rows(self, q, k, v, cache, mask, bias):
        """Per-row ``[B]`` index (the serving slot form): each row writes
        its T tokens at its own index, dropped at capacity, and attends
        its region under the caller's mask (validity over history),
        causality folded as a per-query slot bound, and the window band
        in slot space (slot s holds logical position s - pads, the pads
        constant a row)."""
        if "rolling" in cache:
            raise NotImplementedError(
                "per-row cache indices with a rolling cache would need "
                "per-row wrap bookkeeping; serve windowed models from the "
                "monotone cache"
            )
        B, T = q.shape[0], q.shape[1]
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        cap = ck.shape[1]
        if mask is not None and mask.shape[-1] != cap:
            raise ValueError(
                "per-row cache indices need a cache-width mask (last dim "
                f"{cap}), got {tuple(mask.shape)}"
            )
        write_rows((ck, cv), (k, v), idx)
        new_cache = {"k": ck, "v": cv, "index": idx + T}
        ar = torch.arange(T, device=q.device)
        live_t = idx.long()[:, None] + ar[None, :] + 1  # [B, T]
        kslot = torch.arange(cap, device=q.device)[None, None, None, :]
        valid = kslot < live_t[:, None, :, None]  # [B, 1, T, cap]
        mask = valid if mask is None else mask & valid
        win = self.window
        if win is not None:
            win_start = (live_t - win).clamp_min(0)
            mask = mask & (kslot >= win_start[:, None, :, None])
        bounds = None if bias is not None else self._blockwise_bounds(
            cap, T, cache.get("frontier"))
        if bounds is not None:
            out = decode_attention_blockwise(
                q, ck.to(q.dtype), cv.to(q.dtype), bounds[0], mask=mask,
                start=bounds[1],
            )
        else:
            out = self._attn(
                q, ck.to(q.dtype), cv.to(q.dtype), causal=False, mask=mask,
                q_offset=0, bias=bias, scale=self.scale, window=None,
            )
        return out, new_cache

    def _apply_contiguous(self, q, k, v, cache, mask, bias, fresh_keys):
        """Scalar index: every row writes its T tokens at ``index`` (wrapped
        modulo the capacity on a ring), then attends either the T fresh
        keys (the prefill contract below) or the cache."""
        B, T = q.shape[0], q.shape[1]
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        cap = ck.shape[1]
        rolling = "rolling" in cache
        ar = torch.arange(T, device=q.device)
        if rolling:
            if T > cap:
                # wrapped duplicates would overwrite each other in an
                # undefined order
                raise ValueError(
                    f"rolling write of {T} tokens exceeds ring capacity "
                    f"{cap}: later tokens would overwrite earlier ones in "
                    "undefined order; chunk the write"
                )
            # a write that crosses the ring edge lands each token in its
            # own slot
            slots = (idx.long() + ar) % cap
        else:
            if T > cap:
                raise ValueError(f"write of {T} tokens into a cache of {cap}")
            # the reference's update-slice start clamps to keep the write
            # inside the cache
            slots = idx.long().clamp(0, cap - T) + ar
        ck.index_copy_(1, slots, k.to(ck.dtype))
        cv.index_copy_(1, slots, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "index": idx + T}
        if rolling:
            new_cache["rolling"] = None
        # fresh-keys prefill contract: a write whose mask covers exactly
        # the T fresh keys attends the just-projected k/v, not the mostly
        # empty cache; an explicit fresh_keys wins. A T == 1 write with a
        # width-1 mask into a wider cache is a one-token prompt's prefill.
        # A caller at index > 0 attends the cache and needs a cache-width
        # mask; a fresh write there is poisoned below.
        fresh = (
            fresh_keys if fresh_keys is not None
            else mask is not None and mask.shape[-1] == T
            and (T > 1 or cap > T)
        )
        if fresh and (mask is None or mask.shape[-1] != T):
            raise ValueError(
                "fresh_keys=True needs a T-wide mask over the just-projected "
                f"keys (got mask {None if mask is None else tuple(mask.shape)}"
                f", T={T})"
            )
        if not fresh and mask is not None and mask.shape[-1] != cap:
            raise ValueError(
                f"cache attention needs a cache-width mask (last dim {cap}), "
                f"got {tuple(mask.shape)}; a prompt-width mask is the "
                "fresh-keys prefill form (fresh_keys=True / the T-wide "
                "inference)"
            )
        if not fresh:
            k, v = ck, cv
            # slots beyond what has been written
            valid = torch.arange(cap, device=q.device)[None, None, None, :] \
                < idx + T
            mask = valid if mask is None else mask & valid
        win = self.window
        # the ring never takes the blockwise path: past its first wrap the
        # live count exceeds the capacity, and its capacity is already
        # window-sized
        bounds = None
        if not fresh and T == 1 and bias is None and not rolling:
            bounds = self._blockwise_bounds(cap, T, cache.get("frontier"))
        if bounds is not None:
            if win is not None:
                # the lone query at live - 1 attends [live - window, live)
                win_start = (idx + T - win).clamp_min(0)
                kpos = torch.arange(cap, device=q.device)[None, None, None, :]
                mask = mask & (kpos >= win_start)
            out = decode_attention_blockwise(
                q, k.to(q.dtype), v.to(q.dtype), bounds[0], mask=mask,
                start=bounds[1],
            )
        elif rolling:
            # past the first wrap slot order is not position order: the
            # caller's mask (slot -> position bookkeeping) is the only
            # authority
            out = self._attn(
                q, k.to(q.dtype), v.to(q.dtype), causal=False, mask=mask,
                q_offset=0, bias=bias, scale=self.scale, window=None,
            )
        else:
            out = self._attn(
                q, k.to(q.dtype), v.to(q.dtype), causal=self.causal,
                mask=mask, q_offset=idx, bias=bias, scale=self.scale,
                window=win,
            )
        if fresh:
            # the contract holds only for an empty cache: at index > 0 the
            # cached context would be silently dropped, so the output is
            # poisoned on the device instead
            out = torch.where(idx == 0, out, float("nan"))
        return out, new_cache

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
        NB, bs = ck.shape[0] - 1, ck.shape[1]  # row NB: the scratch block
        Lv = bt.shape[1] * bs
        slots = cache.get("write_slots")
        if slots is None:
            slots = paged_write_slots(idx, bt, T, NB, bs)
        paged_write(cache, k, v, slots)
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
        # the real blocks only (leading-dim views, still contiguous): the
        # kernel's sentinel test is against their count
        ks, vs = cache.get("k_scale"), cache.get("v_scale")
        out = paged_decode_attention(
            q.contiguous(), ck[:NB], cv[:NB], bt, new_cache["index"].int(),
            k_scale=None if ks is None else ks[:NB],
            v_scale=None if vs is None else vs[:NB],
            mask=mask, window=self.window,
        )
        return out, new_cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   rolling: bool = False, *, device=None) -> dict:
        """Contiguous cache form (see the module docstring) at index 0.
        ``rolling=True`` marks a ring: ``max_len`` is then its capacity
        (typically prompt + window), writes wrap modulo it, and the caller
        owns slot-position masking (``parallel/inference.py``)."""
        shape = (batch, max_len, self.num_kv_heads, self.head_dim)
        cache = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device),
        }
        if rolling:
            cache["rolling"] = None
        return cache

    def init_paged_cache(
        self, num_blocks: int, block_size: int, batch: int, max_blocks: int,
        dtype=torch.bfloat16, quant: str | None = None, *, device=None,
    ) -> dict:
        """Paged cache form (see the module docstring): pools of
        ``num_blocks`` blocks plus the scratch block, per-row write index
        0, block table at the sentinel. ``quant="int8"``: int8 pools with
        f32 scales initialized to 1.0 (unwritten blocks dequantize to
        exact zeros); ``dtype`` is then ignored for k/v."""
        if quant not in (None, "int8"):
            raise ValueError(f"unknown paged cache quant {quant!r}")
        shape = (num_blocks + 1, block_size, self.num_kv_heads, self.head_dim)
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
