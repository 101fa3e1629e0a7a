"""Sequence parallelism: ring and Ulysses attention over the mesh's ``seq``
group (port of ``tensorlink_tpu/parallel/sp.py``).

For long-context training the token dim is sharded over ``seq``: each rank
holds a [B, T/S, H, D] slice of q, k and v. The reference compiles each
exchange into the SPMD program (``lax.ppermute``, ``lax.all_to_all``); here
every rank issues them eagerly on the active seq group (``seq_parallel``,
as ``parallel/tp.py`` keeps the model group):

- the ring: K/V blocks rotate S - 1 hops (one ``batch_isend_irecv`` a hop:
  send to ``(r - 1) mod S``, receive from ``(r + 1) mod S``) while each
  rank accumulates its queries' attention over every block. Causal blocks
  are typed by their global offsets: a block ahead of the local queries is
  skipped, the diagonal gets the triangular mask, blocks behind none.
  ``ring_flash_attention`` runs each block on the flash kernels: B1
  (``flash_attention_fwd_lse``) gives a normalized block output and its
  per-row LSE, merged in f32 by logsumexp weights; the backward takes
  delta = rowsum(do * o) ONCE from the f32 merged output and hands it to
  B2 (``flash_attention_bwd(delta=)``) for every block, since a B2 call
  that sees one block of keys would otherwise sum a partial delta; the
  dk/dv accumulators travel with their blocks for S hops and arrive home.
  GQA stays narrow on the ring. ``ring_attention_local`` is the plain
  einsum ring, for square masks and tiles the kernels' rule refuses;
- Ulysses: two tiled ``all_to_all_single`` swaps (tokens in, heads out and
  back), and whole-sequence attention at H/S heads between them
  (``ops.flash.flash_attention_impl``: B1/B2 where its routing takes the
  kernels). K/V swap at their own head count when it divides S.

Transport: gloo cannot hand a CUDA tensor to ``batch_isend_irecv`` (the
process aborts writing a device pointer to its socket), while it carries
``all_to_all_single`` of CUDA tensors (``tools/gloo_cuda_check.py``
probes both; NVIDIA H100 host, torch 2.11). So on a gloo group a ring
hop moves CUDA tensors through pinned host buffers. The attention math
stays on the device, and an NCCL group never stages.

``ring_attention`` and ``ulysses_attention`` are the global entries: each
rank gives the whole [B, T, H, D] tensors, computes its token slice and
returns the whole output; gradients of the whole inputs are whole on
every rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from tensorlink_tpu_torch.ops.flash import (
    LSE_MASKED,
    _tile_ok,
    flash_attention_bwd,
    flash_attention_fwd_lse,
    flash_attention_impl,
    flash_block_for,
)
from tensorlink_tpu_torch.parallel.tp import _all_to_all

NEG_INF = -1e30

_GROUP: list = [None]  # the active seq-axis process group


@contextlib.contextmanager
def seq_parallel(group):
    """Run the enclosed forward (and its backward, which captures the
    group) with ``group`` as the ``seq`` axis."""
    prev = _GROUP[0]
    _GROUP[0] = group
    try:
        yield
    finally:
        _GROUP[0] = prev


def seq_group():
    """The active seq group; raises outside ``seq_parallel``, as the
    reference's impls fail outside a shard_map that binds the axis."""
    g = _GROUP[0]
    if g is None:
        raise RuntimeError(
            "ring/ulysses attention used outside parallel.sp.seq_parallel"
            "(group): the seq axis is not bound")
    return g


def seq_rank() -> int:
    """This rank's coordinate on the active seq group."""
    return dist.get_rank(seq_group())


def _staged(x: torch.Tensor, group) -> bool:
    """A ring hop of CUDA tensors on a gloo group goes through host
    buffers (module docstring)."""
    return x.is_cuda and str(dist.get_backend(group)) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def ring_shift(tensors: list, group, direction: int = -1) -> list:
    """One hop of the ring: each tensor goes to ``(r + direction) mod S``
    and this rank receives its neighbour's from ``(r - direction) mod S``,
    all in one ``batch_isend_irecv``. -> the received tensors."""
    S = dist.get_world_size(group)
    if S == 1:
        return list(tensors)
    r = dist.get_rank(group)
    to = dist.get_global_rank(group, (r + direction) % S)
    frm = dist.get_global_rank(group, (r - direction) % S)
    staged = _staged(tensors[0], group)
    sends = [_host(t) if staged else t.contiguous() for t in tensors]
    recvs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged
                         else t.device, pin_memory=staged) for t in sends]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        dev = tensors[0].device
        recvs = [t.to(dev, non_blocking=True) for t in recvs]
    return recvs


class _RingShift(torch.autograd.Function):
    """``ring_shift`` of one tensor; the backward rotates the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift([x], group, -1)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_shift([g], ctx.group, +1)[0], None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int):
    """Tiled all-to-all (``lax.all_to_all(tiled=True)``): ``x`` is cut into
    S chunks along ``split_dim``, chunk j goes to rank j, and the S chunks
    received are concatenated along ``concat_dim`` in rank order.
    Differentiable: the backward is the reverse swap."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _ScatterSeq(torch.autograd.Function):
    """Whole [B, T, ...] -> this rank's token slice; the backward gathers
    the slices' gradients, so the whole input's gradient is whole on
    every rank."""

    @staticmethod
    def forward(ctx, x, group):
        S, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[1] % S:
            raise ValueError(f"sequence {x.shape[1]} not divisible by the seq "
                             f"axis size {S}")
        ctx.group = group
        return x.chunk(S, dim=1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """This rank's token slice -> the whole [B, T, ...] on every rank;
    the backward keeps this rank's slice (every rank holds the same
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        S, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(S, dim=1)[r].contiguous(), None


def _gather_seq(x, group):
    S = dist.get_world_size(group)
    if S == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(S)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


# ------------------------------------------------------------- einsum ring


def _block_attn(q, k, q_off, k_off, causal, scale, mask=None):
    """One block's masked f32 logits [B, H, Tq, Tk]; ``mask`` the GLOBAL
    [B, 1, 1|T, T] bool mask, sliced at the block offsets."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    Tq, Tk = q.shape[1], k.shape[1]
    if causal:
        qpos = q_off + torch.arange(Tq, device=q.device)[:, None]
        kpos = k_off + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None, None], s, NEG_INF)
    if mask is not None:
        mblk = mask[..., k_off:k_off + Tk]
        if mask.shape[2] != 1:  # square mask: also slice the q dim
            mblk = mblk[:, :, q_off:q_off + Tq]
        s = torch.where(mblk, s, NEG_INF)
    return s


def ring_attention_local(q, k, v, *, group=None, causal: bool = False,
                         mask=None):
    """Full-sequence attention of this rank's q shard [B, Tq, H, D], K/V
    [B, Tk, H, D] rotating around ``group`` (default: the active seq
    group). ``mask``: the full-sequence [B, 1, 1|T, T] bool mask,
    replicated; each rotation slices its k-block's columns. Differentiable
    (the backward rotates the other way)."""
    group = seq_group() if group is None else group
    S, idx = dist.get_world_size(group), dist.get_rank(group)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if mask is not None:
        if mask.shape[1] != 1:
            raise NotImplementedError(
                "ring attention supports masks with head dim 1 only")
        if mask.shape[3] != S * Tk:
            raise ValueError(
                f"ring mask must be GLOBAL: last dim {mask.shape[3]} != "
                f"axis_size*Tk_local = {S * Tk} (a token-sharded mask "
                "cannot follow the rotating k-blocks)")
        mask = mask.bool()
    scale = D ** -0.5
    q_off = idx * Tq
    m = torch.full((B, H, Tq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Tq, 1), device=q.device)
    acc = torch.zeros((B, Tq, H, D), device=q.device)
    k_blk, v_blk = k, v
    for r in range(S):
        if r > 0:
            k_blk = _RingShift.apply(k_blk, group)
            v_blk = _RingShift.apply(v_blk, group)
        k_off = ((idx + r) % S) * Tk
        s = _block_attn(q, k_blk, q_off, k_off, causal, scale, mask)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal or mask is not None:
            p = torch.where(s <= NEG_INF / 2, 0.0, p)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk).float()
        acc = acc * alpha.transpose(1, 2) + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe.transpose(1, 2)).to(q.dtype)


# ------------------------------------------------------ ring + flash kernels


def _blocks(qt, k_blk) -> dict:
    B = qt.shape[0]
    return {"block_q": flash_block_for(qt.shape[2], B),
            "block_k": flash_block_for(k_blk.shape[1], B)}


def _rf_block_fwd(qt, k_blk, v_blk, kvm, k_idx, idx, causal):
    """One block's B1 call -> (o [B, H, Tq, D] f32, lse [B, H, Tq] f32 with
    fully masked rows at -inf), or None for a causal block ahead of the
    queries (nothing to attend, no launch)."""
    if causal and k_idx > idx:
        return None
    o, lse = flash_attention_fwd_lse(
        qt, k_blk.transpose(1, 2), v_blk.transpose(1, 2), kvm,
        causal=causal and k_idx == idx, **_blocks(qt, k_blk))
    lse = torch.where(lse >= LSE_MASKED / 2, float("-inf"), lse)
    return o.float(), lse


def _rf_block_bwd(qt, k_blk, v_blk, o_t, lse, do_t, delta, kvm, k_idx, idx,
                  causal):
    """One block's B2 call against the FINAL (o, lse) and the whole row's
    ``delta`` -> (dq_t [B, H, Tq, D], dk/dv [B, Tk, Hkv, D]) partial
    contributions, or None for a causal block ahead."""
    if causal and k_idx > idx:
        return None
    dq, dk, dv = flash_attention_bwd(
        qt, k_blk.transpose(1, 2), v_blk.transpose(1, 2), o_t, lse, do_t, kvm,
        causal=causal and k_idx == idx, delta=delta, **_blocks(qt, k_blk))
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


def _merge(out_acc, lse_acc, o_blk, lse_blk):
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    # both -inf (a row fully masked so far): weights 0, not nan
    fin = torch.isfinite(lse_new)
    w_old = torch.where(fin, torch.exp(lse_acc - lse_new), 0.0)
    w_blk = torch.where(fin, torch.exp(lse_blk - lse_new), 0.0)
    return out_acc * w_old[..., None] + o_blk * w_blk[..., None], lse_new


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, group):
        S, idx = dist.get_world_size(group), dist.get_rank(group)
        B, Tq, H, D = q.shape
        Tk = k.shape[1]

        def kvm_at(j):
            return None if kv_mask is None else kv_mask[:, j * Tk:(j + 1) * Tk]

        qt = q.transpose(1, 2)
        out = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, Tq), float("-inf"), device=q.device)
        k_blk, v_blk = k, v
        for r in range(S):
            if r > 0:
                k_blk, v_blk = ring_shift([k_blk, v_blk], group)
            k_idx = (idx + r) % S
            blk = _rf_block_fwd(qt, k_blk, v_blk, kvm_at(k_idx), k_idx, idx,
                                causal)
            if blk is not None:
                out, lse = _merge(out, lse, *blk)
        # the backward kernels take the single-kernel masked-row convention
        lse_saved = torch.where(torch.isfinite(lse), lse, LSE_MASKED)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse_saved)
        ctx.causal, ctx.group = causal, group
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        causal, group = ctx.causal, ctx.group
        S, idx = dist.get_world_size(group), dist.get_rank(group)
        Tk = k.shape[1]
        qt = q.transpose(1, 2)
        do_t = g.to(q.dtype).contiguous().transpose(1, 2)
        # delta once, from the f32 merged output: every block's B2 call
        # needs the whole row's rowsum(do * o)
        delta = (do_t.float() * out).sum(dim=-1)
        o_t = out.to(q.dtype)
        dq = torch.zeros(out.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for r in range(S):
            k_idx = (idx + r) % S
            kvm = None if kv_mask is None else kv_mask[:, k_idx * Tk:(k_idx + 1) * Tk]
            blk = _rf_block_bwd(qt, k_blk, v_blk, o_t, lse, do_t, delta, kvm,
                                k_idx, idx, causal)
            if blk is not None:
                dq += blk[0].float()
                dk += blk[1].float()
                dv += blk[2].float()
            # the accumulators travel with their block: after S hops each
            # has every rank's contribution and is home; the blocks
            # themselves are not needed after the last
            if r < S - 1:
                k_blk, v_blk, dk, dv = ring_shift([k_blk, v_blk, dk, dv], group)
            else:
                dk, dv = ring_shift([dk, dv], group)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, kv_mask=None, causal: bool = False,
                         group=None):
    """Ring attention whose block math is the flash kernels (B1 forward,
    B2 with the ring's delta backward). q [B, Tq, H, D]; k, v [B, Tk, Hkv,
    D], GQA narrow; ``kv_mask``: the GLOBAL [B, S * Tk] key-validity
    vector (nonzero = attend) or None. ``group``: default the active seq
    group."""
    group = seq_group() if group is None else group
    return _RingFlash.apply(q, k, v, kv_mask, causal, group)


def _ring_flash_usable(q, k, mask) -> tuple:
    """(kv_mask | None, usable): the kernel path's preconditions — local
    lengths the kernels' rule takes, and no mask or a global key-padding
    vector [B, 1, 1, S * Tk]."""
    if not (_tile_ok(q.shape[1]) and _tile_ok(k.shape[1])):
        return None, False
    if mask is None:
        return None, True
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return mask[:, 0, 0, :].expand(q.shape[0], mask.shape[3]), True
    return None, False  # square masks stay on the einsum ring


def _reject_unsupported(name: str, **kwargs) -> None:
    """ring/ulysses implement none of these attention kwargs; swallowing
    one would silently change the result (full context under a window,
    the default scale under a custom one, a dropped bias)."""
    for kw, val in kwargs.items():
        if val is not None:
            raise NotImplementedError(
                f"{name} attention does not support {kw}="
                f"{val!r} (use the reference or flash impl)")


def ring_attention_impl(q, k, v, *, causal=False, mask=None, q_offset=0,
                        window=None, bias=None, scale=None, **_):
    """``attn_impl`` "ring" of ``MultiHeadAttention``, inside
    ``seq_parallel`` (the sharded trainer's pipeline at seq > 1): q, k, v
    are the LOCAL [B, T/S, H, D] shards. The flash ring where its
    preconditions hold, the einsum ring otherwise. ``mask``: the GLOBAL
    full-sequence mask, replicated (the trainer's extras channel)."""
    if not (isinstance(q_offset, int) and q_offset == 0):
        raise NotImplementedError(
            "ring attention does not support caches — sequence-"
            "sharded SERVING goes through InferenceEngine("
            "kv_seq_shard=True), which shards the KV cache's slot "
            "dim over the seq axis and lets the SPMD partitioner "
            "derive the online-softmax merge collectives")
    _reject_unsupported("ring", window=window, bias=bias, scale=scale)
    S = dist.get_world_size(seq_group())
    if mask is not None and mask.shape[3] != S * k.shape[1]:
        raise ValueError(
            f"ring mask must be GLOBAL: last dim {mask.shape[3]} != "
            f"axis_size*Tk_local = {S * k.shape[1]} (a token-sharded mask "
            "cannot follow the rotating k-blocks)")
    kv_vec, usable = _ring_flash_usable(q, k, mask)
    if usable:
        return ring_flash_attention(q, k, v, kv_vec, causal)
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:  # GQA: the einsum ring rotates whole K/V shards
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    return ring_attention_local(q, k, v, causal=causal, mask=mask)


def _global(local_fn, q, k, v, mesh, axis, mask):
    group = mesh.get_group(axis)
    qs, ks, vs = (_ScatterSeq.apply(x, group) for x in (q, k, v))
    with seq_parallel(group):
        out = local_fn(qs, ks, vs, mask)
    return _GatherSeq.apply(out, group)


def ring_attention(q, k, v, mesh, *, axis: str = "seq", causal: bool = False,
                   mask=None, use_flash: bool = False):
    """Global entry: each rank gives the whole q, k, v [B, T, H, D], takes
    its token slice over ``mesh``'s ``axis`` and runs the ring; returns
    the whole output. ``mask`` ([B, 1, 1|T, T], replicated) is sliced at
    each k-block's offset. ``use_flash`` runs the blocks on B1/B2
    (``ring_flash_attention``; the mask must then be a key-padding vector
    form or None)."""

    def local(q_, k_, v_, m):
        if use_flash:
            kv_vec, usable = _ring_flash_usable(q_, k_, m)
            if not usable:
                raise NotImplementedError(
                    "use_flash=True needs tile-able local lengths and a "
                    "key-padding-vector mask ([B,1,1,T]) or none — square "
                    "masks run on the einsum ring")
            return ring_flash_attention(q_, k_, v_, kv_vec, causal)
        return ring_attention_local(q_, k_, v_, causal=causal, mask=m)

    return _global(local, q, k, v, mesh, axis, mask)


# ------------------------------------------------------------------ Ulysses


def ulysses_attention_local(q, k, v, *, group=None, causal: bool = False,
                            mask=None):
    """All-to-all head/sequence swap, whole-sequence attention at H/S
    heads, swap back. q [B, T/S, H, D]; k, v [B, T/S, Hkv, D], swapped at
    their own head count when it divides S (the post-swap head blocks
    align with the GQA groups), repeated to H otherwise. ``mask``: the
    replicated global [B, 1, 1, T] key-padding mask."""
    group = seq_group() if group is None else group
    S = dist.get_world_size(group)
    H, Hkv = q.shape[2], k.shape[2]
    if H % S:
        raise ValueError(f"num_heads {H} not divisible by seq axis size {S}")
    if Hkv != H and Hkv % S:
        # uneven kv-head split: ship repeated K/V
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)

    def swap_in(x):  # [B, T/S, h, D] -> [B, T, h/S, D]
        return all_to_all(x, group, split_dim=2, concat_dim=1)

    out = flash_attention_impl(swap_in(q), swap_in(k), swap_in(v),
                               causal=causal, mask=mask)
    return all_to_all(out, group, split_dim=1, concat_dim=2)


def ulysses_attention_impl(q, k, v, *, causal=False, mask=None, q_offset=0,
                           window=None, bias=None, scale=None, **_):
    """``attn_impl`` "ulysses" of ``MultiHeadAttention`` inside
    ``seq_parallel``. ``mask``: the GLOBAL full-sequence mask, replicated
    (head dim 1); a token-sharded one cannot apply to the post-swap
    logits."""
    if not (isinstance(q_offset, int) and q_offset == 0):
        raise NotImplementedError(
            "ulysses attention does not support caches — see "
            "InferenceEngine(kv_seq_shard=True) for sequence-"
            "sharded serving")
    _reject_unsupported("ulysses", window=window, bias=bias, scale=scale)
    if mask is not None:
        S = dist.get_world_size(seq_group())
        if mask.shape[1] != 1:
            raise NotImplementedError(
                "ulysses attention supports masks with head dim 1 only "
                "(heads are split across the axis after the swap)")
        if mask.shape[3] != S * q.shape[1]:
            raise ValueError(
                f"ulysses mask must be GLOBAL: last dim {mask.shape[3]} "
                f"!= axis_size*T_local = {S * q.shape[1]}")
    return ulysses_attention_local(q, k, v, causal=causal, mask=mask)


def ulysses_attention(q, k, v, mesh, *, axis: str = "seq",
                      causal: bool = False, mask=None):
    """Global entry: each rank gives the whole q, k, v, takes its token
    slice over ``mesh``'s ``axis`` and runs the swap; returns the whole
    output. The key-padding mask is replicated."""
    return _global(
        lambda q_, k_, v_, m: ulysses_attention_local(
            q_, k_, v_, causal=causal, mask=m),
        q, k, v, mesh, axis, mask)


# ----------------------------------------------- seq-sharded cache decode


def merge_partials(m, l, acc, group):
    """Merge per-rank online-softmax partials over ``group``: the row
    max ``m`` [..., 1] (one all-reduce max), then the rescaled normalizer
    ``l`` [..., 1] and numerator ``acc`` [..., D] (one all-reduce sum of
    both). -> acc / l, 0 where no rank had a key."""
    if dist.get_world_size(group) > 1:
        mg = m.clone()
        dist.all_reduce(mg, op=dist.ReduceOp.MAX, group=group)
        w = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - mg))
        both = torch.cat([l * w, acc * w], dim=-1)
        dist.all_reduce(both, group=group)
        l, acc = both[..., :1], both[..., 1:]
    return acc / torch.where(l == 0.0, 1.0, l)
