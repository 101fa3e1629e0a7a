"""Paged-decode attention over the block-table form (port of
``tensorlink_tpu/ops/pallas/paged_decode.py``).

``paged_decode_attention`` is the wrapper the paged attention path
calls for every layer of every prefill chunk (T = chunk) and decode
step (T = 1). A CUDA tensor launches the hand-written kernel in
``csrc/paged_decode.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``); a CPU tensor takes ``paged_decode_reference``, the plain
PyTorch version of the same math. Anything else raises: there is no
switch that routes CUDA tensors to the plain version.

The kernel has three variants, chosen from dtypes and shapes alone by
``kernel_variant`` (the engine's bf16 and f16 decode steps take
"decode", its prefill chunks "prefill"; f32 tensors, mixed 16-bit
types, other head dims and masks whose width is not a multiple of 16
take "general").
``partition_plan`` says how many blocks share each row's keys (fixed
partitions of the view at decode, even shares of each tile's live range
at prefill), from shapes alone, so the host never reads ``lengths``.
Each variant counts its own
launches in ``paged_decode_attention.launches_by_variant``; the total
stays in ``paged_decode_attention.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from tensorlink_tpu_torch.ops.quant import dequantize_kv

NEG_INF = -1e30  # finite: exp underflows to 0.0, NaN-free

# limits of csrc/paged_decode.cu
MAX_HEAD_DIM = 256  # general variant (kMaxD)
MAX_GROUP = 32  # general variant (kMaxRows)
MMA_HEAD_DIMS = (64, 128)  # decode and prefill variants
# q dtype -> the pool dtypes the decode and prefill variants take with it
MMA_POOLS = {torch.bfloat16: (torch.bfloat16, torch.int8),
             torch.float16: (torch.float16, torch.int8)}
STAGE_KEYS = 64  # keys per pipeline stage (kStageKeys)
DECODE_ROWS = 16  # T * group query rows of a decode block (kDecodeRows)
PREFILL_ROWS = 64  # query rows of a prefill tile (kPrefillRows)
DECODE_PARTITION = 256  # keys per decode partition
SMS = 132  # H100 SXM streaming multiprocessors
# prefill: split the key range while the grid fits in one wave of two
# resident blocks per SM
PREFILL_TARGET_BLOCKS = 2 * SMS
# general variant's split target (kTargetBlocks) and chunk (kKC)
GENERAL_TARGET_BLOCKS = 4 * SMS
GENERAL_CHUNK = 32

VARIANTS = ("general", "decode", "prefill")
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float16: 3}


def kernel_variant(q_dtype, kv_dtype, T: int, H: int, Hkv: int, D: int,
                   Lv: int, masked: bool) -> str:
    """Which kernel variant takes a call: "decode" for a 16-bit q over
    pools of its own type or int8 (``MMA_POOLS``: bf16 over bf16 or
    int8, f16 over f16 or int8) with D in ``MMA_HEAD_DIMS`` and at most
    ``DECODE_ROWS`` query rows (T x GQA group) per kv head; "prefill"
    for the same types with more rows; "general" for everything else,
    including a mask whose width ``Lv`` is not a multiple of 16 (the
    fast variants copy mask rows 16 bytes at a time): f32 q or pools and
    mixed 16-bit pairs (f16 q over bf16 pools, bf16 q over f16 pools),
    which it computes in f32 whatever the storage types."""
    group = H // Hkv
    fast = (
        kv_dtype in MMA_POOLS.get(q_dtype, ())
        and D in MMA_HEAD_DIMS
        and not (masked and Lv % 16)
    )
    if not fast:
        return "general"
    return "decode" if T * group <= DECODE_ROWS else "prefill"


def partition_plan(variant: str, B: int, T: int, H: int, Hkv: int,
                   Lv: int) -> tuple[int, int]:
    """-> (keys per partition, partitions per row). Decode cuts every
    row's view of ``Lv`` keys into fixed partitions of
    ``DECODE_PARTITION`` keys. Prefill splits each query tile's live key
    range evenly, in whole ``STAGE_KEYS`` stages, into as many parts as
    the grid (query tiles x kv heads x rows) can take and stay within
    ``PREFILL_TARGET_BLOCKS``, the blocks the card holds at once (a
    second wave would double the time); its keys-per-partition is the
    most one part can hold. The general variant splits each row's live
    range evenly into the returned count (its keys-per-partition is 0)."""
    group = H // Hkv
    if variant == "general":
        tq = min(MAX_GROUP // group, T)
        base = -(-T // tq) * Hkv * B
        n = min(-(-GENERAL_TARGET_BLOCKS // base), -(-Lv // GENERAL_CHUNK) // 2)
        return 0, max(n, 1)
    if variant == "decode":
        kp = DECODE_PARTITION
    else:
        base = -(-T // (PREFILL_ROWS // group)) * Hkv * B
        n = max(1, min(PREFILL_TARGET_BLOCKS // base, -(-Lv // STAGE_KEYS)))
        kp = STAGE_KEYS * -(-Lv // (n * STAGE_KEYS))
    return kp, -(-Lv // kp)


def workspace_elems(B: int, T: int, H: int, D: int, nsplit: int) -> int:
    """float32 elements of the partial-state workspace: (m, l, acc[D]) per
    (row, query, head, partition); none without a split."""
    return 0 if nsplit == 1 else B * T * H * nsplit * (D + 2)


def paged_decode_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [NB, bs, Hkv, D] pool (int8 when k_scale given)
    v: torch.Tensor,
    block_table: torch.Tensor,  # [B, MB] int32; NB = unmapped sentinel
    lengths: torch.Tensor,  # [B] int32 live count (POST-write: index + T)
    *,
    k_scale: torch.Tensor | None = None,  # [NB, bs, Hkv] f32
    v_scale: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,  # [B, 1, T|1, Lv] bool, True=attend
    window: int | None = None,
) -> torch.Tensor:
    """The plain home of the kernel's math: gather the logical view,
    dequantize, mask in logical coordinates, f32 softmax with the
    zero-normalizer guard (a row with no attendable key gives 0)."""
    B, T, H, D = q.shape
    NB, bs, Hkv = k.shape[0], k.shape[1], k.shape[2]
    MB = block_table.shape[1]
    Lv = MB * bs
    # sentinel -> clamped garbage block; the positional keep below never
    # reaches it for a mapped row
    bt = torch.clamp(block_table.long(), max=NB - 1)
    kk = k[bt].reshape(B, Lv, Hkv, D)
    vv = v[bt].reshape(B, Lv, Hkv, D)
    if k_scale is not None:
        kk = dequantize_kv(kk, k_scale[bt].reshape(B, Lv, Hkv))
        vv = dequantize_kv(vv, v_scale[bt].reshape(B, Lv, Hkv))
    kk, vv = kk.float(), vv.float()
    if Hkv != H:
        # query head h reads kv head h // (H // Hkv) (jnp.repeat order)
        kk = kk.repeat_interleave(H // Hkv, dim=2)
        vv = vv.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * (D ** -0.5)
    kpos = torch.arange(Lv, device=q.device)[None, None, None, :]
    qpos = (
        lengths.long()[:, None] - T + torch.arange(T, device=q.device)[None, :]
    )[:, None, :, None]  # [B, 1, T, 1]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    if mask is not None:
        keep = keep & mask
    keep = keep.expand(s.shape)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    l_q = torch.where(lsum == 0.0, torch.ones_like(lsum), lsum).transpose(1, 2)
    return (o / l_q).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Paged attention -> [B, T, H, D] in q's dtype; same arguments as
    ``paged_decode_reference``. ``T >= 1``: query t sits at logical
    position ``lengths - T + t``. Scale is the fixed ``1/sqrt(D)``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    Lv = block_table.shape[1] * k.shape[1]
    if mask is not None and mask.shape[-1] != Lv:
        raise ValueError(
            f"paged attention needs a view-width mask (last dim {Lv}), "
            f"got {tuple(mask.shape)}"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return paged_decode_reference(
            q, k, v, block_table, lengths, k_scale=k_scale,
            v_scale=v_scale, mask=mask, window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no paged-decode path for device {q.device}")
    return _launch(q, k, v, block_table, lengths, k_scale, v_scale, mask,
                   window)


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged-decode kernel: {msg}")


def _launch(q, k, v, block_table, lengths, k_scale, v_scale, mask, window):
    B, T, H, D = q.shape
    NB, bs, Hkv = k.shape[0], k.shape[1], k.shape[2]
    MB = block_table.shape[1]
    args = [q, k, v, block_table, lengths, k_scale, v_scale, mask]
    _check(
        all(t is None or t.device == q.device for t in args),
        "every tensor must be on q's device",
    )
    _check(
        all(t is None or t.is_contiguous() for t in args),
        "tensors must be contiguous",
    )
    _check(q.dtype in _Q_CODES, f"q dtype {q.dtype} (float32, bfloat16 or float16)")
    _check(k.dtype == v.dtype and k.dtype in _KV_CODES,
           f"pool dtypes {k.dtype}/{v.dtype}")
    _check(tuple(k.shape) == (NB, bs, Hkv, D) and v.shape == k.shape,
           f"pool shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    _check(Hkv > 0 and H % Hkv == 0 and H // Hkv <= MAX_GROUP,
           f"heads {H}/{Hkv}")
    _check(1 <= D <= MAX_HEAD_DIM, f"head dim {D}")
    _check((k.dtype == torch.int8) == (k_scale is not None),
           "int8 pools need k_scale/v_scale (and only they do)")
    if k_scale is not None:
        _check(
            k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
            and tuple(k_scale.shape) == (NB, bs, Hkv)
            and k_scale.shape == v_scale.shape,
            "scales must be float32 [NB, bs, Hkv]",
        )
    _check(block_table.dtype == torch.int32 and tuple(block_table.shape) == (B, MB),
           "block_table must be int32 [B, MB]")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,),
           "lengths must be int32 [B]")
    mask_T = 1
    if mask is not None:
        _check(
            mask.dtype == torch.bool and mask.dim() == 4
            and mask.shape[0] == B and mask.shape[1] == 1
            and mask.shape[2] in (1, T),
            f"mask must be bool [B, 1, T|1, Lv], got {tuple(mask.shape)}",
        )
        mask_T = mask.shape[2]
    variant = kernel_variant(q.dtype, k.dtype, T, H, Hkv, D, MB * bs,
                             mask is not None)
    if variant != "general":
        _check(all(t is None or t.data_ptr() % 16 == 0
                   for t in (q, k, v, mask)),
               "q, pools and mask must start on 16-byte boundaries")
    kp, nsplit = partition_plan(variant, B, T, H, Hkv, MB * bs)
    out = torch.empty_like(q)
    n_part = workspace_elems(B, T, H, D, nsplit)
    part = None
    if n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tl_paged_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            VARIANTS.index(variant), kp, nsplit,
            B, T, H, Hkv, D, NB, bs, MB, mask_T,
            0 if window is None else int(window), D ** -0.5,
            _Q_CODES[q.dtype], _KV_CODES[k.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"paged-decode kernel ({variant}) launch failed: CUDA error "
            f"{rc} ({lib.tl_cuda_error_string(rc).decode()})"
        )
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_variant[variant] += 1
    return out


def _lib() -> ctypes.CDLL:
    from tensorlink_tpu_torch.ops._build import load

    lib = load("paged_decode.cu")
    if not getattr(lib, "_tl_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.tl_paged_decode.argtypes = [
            P, P, P, P, P, P, P, P, P,  # q k v k_scale v_scale bt len mask out
            P, I, I, I,  # part variant kp nsplit
            I, I, I, I, I, I, I, I, I, I,  # B T H Hkv D NB bs MB mask_T window
            ctypes.c_float, I, I, P,  # scale q_dtype kv_dtype stream
        ]
        lib.tl_paged_decode.restype = I
        lib.tl_cuda_error_string.argtypes = [I]
        lib.tl_cuda_error_string.restype = ctypes.c_char_p
        lib._tl_typed = True
    return lib
