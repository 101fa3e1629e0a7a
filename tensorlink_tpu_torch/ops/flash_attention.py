"""Flash attention forward (B1) and backward (B2) (port of
``tensorlink_tpu/ops/pallas/flash_attention.py``).

Operands use the reference's layout: q ``[B, H, Tq, D]``, k and v
``[B, Hkv, Tk, D]`` (``Hkv`` divides ``H``; query head h reads kv head
``h // (H // Hkv)``), an optional key mask ``kv_mask [B, Tk]`` (nonzero =
attend), ``causal`` and a sliding ``window`` under the positional rule of
``nn.attention.band_keep``. A query row with no attended key gives o = 0
and lse = ``LSE_MASKED``.

``flash_attention_fwd_lse`` and ``flash_attention_bwd`` are the wrappers
``ops.flash`` calls. A CUDA tensor launches the hand-written kernels
(built with ``nvcc`` at first use, bound with ``ctypes``): bf16 and f16
operands those of ``csrc/flash_attention.cu`` (one source, two
instantiations on the 16-bit tensor cores: the forward on wgmma fed by
TMA, the backward on mma.sync, every sum f32; in f16 each row of the
backward's dS operands is scaled by a power of two against underflow);
f32 operands those of ``csrc/flash_attention_f32.cu``, on the tensor
cores in TF32 with a three-product split that keeps f32 precision (the
reference's kernels compute in f32 whatever their inputs, so an f32 or
f16 model keeps its precision). ``launches_by_variant`` counts each
wrapper's launches by form ("bf16", "f32", "f16").
They read any [B, heads, T, D] view whose D is contiguous and whose base
and strides are 16-byte aligned, so the caller's [B, T, H, D] tensors
pass as transposed views, and the outputs come back as views over
[B, T, heads, D] storage. The kernels are built for D 64, 128 and 256;
any other D up to ``MAX_HEAD_DIM`` is zero-padded to the next of them
(``_padded``: the zero columns add nothing to QK^T or dO V^T, and the
padded columns of o, dq, dk and dv are zero), run at the true D's scale,
and sliced back (``_sliced``), so such outputs are views of padded
storage. A CPU tensor takes the plain PyTorch version of the same math
(``flash_attention_fwd_lse_reference``, ``flash_attention_bwd_reference``).
A CUDA input outside the kernels' limits (bf16, f32 or f16, D up to
``MAX_HEAD_DIM``, 16-byte aligned base and strides) raises: nothing
routes a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from tensorlink_tpu_torch.nn.attention import band_keep

NEG_INF = -1e30
# LSE of a fully masked row: exp(s - LSE_MASKED) == 0 for any finite score,
# so the backward's p and ds vanish exactly where the forward gave 0
LSE_MASKED = 1e30

# the head dims csrc/flash_attention.cu and csrc/flash_attention_f32.cu
# are built for; any other D up to MAX_HEAD_DIM is zero-padded to the next
# (the paged kernel, ops/paged_decode.py, stops at 256 too)
HEAD_DIMS = (64, 128, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
# operand dtype -> (launch-count form, library source, entry suffix)
KERNEL_FORMS = {
    torch.bfloat16: ("bf16", "flash_attention.cu", ""),
    torch.float32: ("f32", "flash_attention_f32.cu", "_f32"),
    torch.float16: ("f16", "flash_attention.cu", "_f16"),
}
KERNEL_BLOCK = 64  # the kernels' query and key tile


def _check_shapes(q, k, v, kv_mask):
    B, H, Tq, D = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != D:
        raise ValueError(
            f"bad kv shapes q={tuple(q.shape)} k={tuple(k.shape)} "
            f"v={tuple(v.shape)}"
        )
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} != {(B, Tk)}")
    return B, H, Hkv, Tq, Tk, D


def _check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _keep(kv_mask, Tq, Tk, causal, window, device):
    """[B|1, 1, Tq, Tk] bool keep mask, or None when every pair attends."""
    pos = band_keep(
        torch.arange(Tq, device=device)[:, None],
        torch.arange(Tk, device=device)[None, :], causal, window,
    )
    keep = None if pos is None else pos[None, None]
    if kv_mask is not None:
        kv = (kv_mask != 0)[:, None, None, :]
        keep = kv if keep is None else keep & kv
    return keep


def _repeat_kv(x, H):
    return x if x.shape[1] == H else x.repeat_interleave(H // x.shape[1], dim=1)


def flash_attention_fwd_lse_reference(q, k, v, kv_mask=None, *,
                                      causal: bool = False,
                                      window: int | None = None,
                                      scale: float | None = None):
    """The plain home of B1's math: full f32 scores, masked softmax with
    the zero-normalizer guard. ``scale`` multiplies the scores (None:
    D ** -0.5). -> (o [B, H, Tq, D] in q's dtype, lse [B, H, Tq] f32)."""
    B, H, Hkv, Tq, Tk, D = _check_shapes(q, k, v, kv_mask)
    s = torch.einsum(
        "bhqd,bhkd->bhqk", q.float(), _repeat_kv(k, H).float()
    ) * (D ** -0.5 if scale is None else scale)
    keep = _keep(kv_mask, Tq, Tk, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _repeat_kv(v, H).float()) / l_safe
    lse = torch.where(l > 0.0, m + torch.log(l_safe), LSE_MASKED)[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, kv_mask=None, *,
                                  causal: bool = False,
                                  window: int | None = None, delta=None,
                                  scale: float | None = None):
    """The plain home of B2's math: p = exp(s - lse) with the forward's
    masks, dp = do v^T, delta = rowsum(p * dp), ds = p (dp - delta) scale;
    dk and dv summed over each GQA group. -> (dq, dk, dv) in the inputs'
    dtypes.

    delta is the reference's rowsum(do * o) in exact arithmetic, taken
    from p and dp themselves: from a bf16-rounded o it is off by ~2^-9
    |do||o|, which swamps ds wherever attention is near uniform. The
    kernel reads ``o`` only to centre its one-pass dq sums (the result
    is exact for any o); this version keeps it for the signature and
    shape checks.

    ``delta`` (f32 [B, H, Tq]) replaces that row sum: a caller whose k
    and v are one block of the row's keys (the ring, ``parallel/sp.py``)
    passes rowsum(do * o) of the whole row's output, since the sum over
    this block's p and dp would be a partial one. ``scale`` is the
    forward's (None: D ** -0.5)."""
    B, H, Hkv, Tq, Tk, D = _check_shapes(q, k, v, kv_mask)
    scale = D ** -0.5 if scale is None else scale
    qf, dof = q.float(), do.float()
    kf, vf = _repeat_kv(k, H).float(), _repeat_kv(v, H).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    keep = _keep(kv_mask, Tq, Tk, causal, window, q.device)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = ((p * dp).sum(dim=-1, keepdim=True) if delta is None
             else delta.float()[..., None])
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if H != Hkv:  # sum each GQA group back to its kv head
        dk = dk.reshape(B, Hkv, H // Hkv, Tk, D).sum(dim=2)
        dv = dv.reshape(B, Hkv, H // Hkv, Tk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd_lse(q, k, v, kv_mask=None, *, causal: bool = False,
                            window: int | None = None,
                            block_q: int = KERNEL_BLOCK,
                            block_k: int = KERNEL_BLOCK):
    """-> (o [B, H, Tq, D], lse [B, H, Tq] f32). ``block_q``/``block_k``
    name the tile the caller resolved (``ops.flash.flash_block_for``); the
    kernels take one, ``KERNEL_BLOCK``, and raise on any other."""
    _check_shapes(q, k, v, kv_mask)
    _check_window(window)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(
            q, k, v, kv_mask, causal=causal, window=window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_blocks(block_q, block_k)
    return _launch_fwd(q, k, v, kv_mask, causal, window)


flash_attention_fwd_lse.launches = 0
flash_attention_fwd_lse.launches_by_variant = {"bf16": 0, "f32": 0, "f16": 0}


def flash_attention_bwd(q, k, v, o, lse, do, kv_mask=None, *,
                        causal: bool = False, window: int | None = None,
                        block_q: int = KERNEL_BLOCK,
                        block_k: int = KERNEL_BLOCK, delta=None):
    """Blockwise dq [B, H, Tq, D], dk/dv [B, Hkv, Tk, D] from the forward's
    lse and the cotangent ``do`` of its output o (whose delta term is
    recomputed from p and dp, see ``flash_attention_bwd_reference``, or
    is ``delta``, f32 [B, H, Tq], when the caller gives it). f32
    accumulation, outputs in the inputs' dtypes; GQA groups summed.
    ``launches_by_form`` counts the kernel's launches by where delta
    came from ("own", "delta")."""
    _check_shapes(q, k, v, kv_mask)
    _check_window(window)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"o {tuple(o.shape)} / do {tuple(do.shape)} / lse "
            f"{tuple(lse.shape)} do not match q {tuple(q.shape)}"
        )
    if delta is not None and (tuple(delta.shape) != tuple(q.shape[:3])
                              or delta.dtype != torch.float32
                              or delta.device != q.device):
        raise ValueError(
            f"delta must be float32 {tuple(q.shape[:3])} on {q.device}, got "
            f"{delta.dtype} {tuple(delta.shape)} on {delta.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, kv_mask, causal=causal, window=window,
            delta=delta,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_blocks(block_q, block_k)
    return _launch_bwd(q, k, v, o, lse, do, kv_mask, causal, window, delta)


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_form = {"own": 0, "delta": 0}
flash_attention_bwd.launches_by_variant = {"bf16": 0, "f32": 0, "f16": 0}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash-attention kernel: {msg}")


def _check_blocks(block_q, block_k):
    _check(block_q == KERNEL_BLOCK and block_k == KERNEL_BLOCK,
           f"blocks ({block_q}, {block_k}): the kernel's tile is "
           f"{KERNEL_BLOCK}")


def _strides(x):
    return (x.stride(0), x.stride(1), x.stride(2))


def _check_views(q, views):
    """What the kernels can read: [B, heads, T, D] views of one dtype, bf16,
    f32 or f16 (``KERNEL_FORMS``), D one of ``HEAD_DIMS`` and contiguous,
    all on q's card, whose base pointers and (b, h, t) strides are
    multiples of 16 bytes: the 16-bit forward reads q, k and v through TMA
    tensor maps, which address nothing else, and the backward's 16-byte
    copies need the same (the f32 kernels keep the rule). -> the form's
    ``KERNEL_FORMS`` entry."""
    D = q.shape[-1]
    _check(q.dtype in KERNEL_FORMS,
           f"q dtype {q.dtype} (bfloat16, float32 or float16)")
    _check(D in HEAD_DIMS, f"head dim {D} (kernel takes {HEAD_DIMS})")
    for name, x in views.items():
        _check(x.device == q.device, f"{name} is not on {q.device}")
        _check(x.dtype == q.dtype, f"{name} dtype {x.dtype} (q's {q.dtype})")
        _check(x.stride(3) == 1 or x.shape[3] == 1,
               f"{name} needs a contiguous head dim, strides {x.stride()}")
        _check(x.data_ptr() % 16 == 0,
               f"{name} base pointer {x.data_ptr():#x} is not 16-byte "
               f"aligned (TMA needs it)")
        _check(all(s * x.element_size() % 16 == 0 for s in _strides(x)),
               f"{name} strides {x.stride()} are not multiples of 16 "
               f"bytes (TMA needs them)")
    return KERNEL_FORMS[q.dtype]


def _mask_u8(kv_mask, q):
    if kv_mask is None:
        return None
    _check(kv_mask.device == q.device, f"kv_mask is not on {q.device}")
    if kv_mask.dtype == torch.bool and kv_mask.is_contiguous():
        return kv_mask.view(torch.uint8)  # same bytes: no conversion kernel
    return (kv_mask != 0).to(torch.uint8).contiguous()


def _kernel_dim(D: int) -> int:
    """The head dim the kernels run a D at: the least of ``HEAD_DIMS`` that
    holds it; D above ``MAX_HEAD_DIM`` is refused."""
    _check(0 < D <= MAX_HEAD_DIM,
           f"head dim {D} (kernels take D <= {MAX_HEAD_DIM}: {HEAD_DIMS}, "
           f"other D zero-padded to the next)")
    return next(d for d in HEAD_DIMS if D <= d)


def _padded(x, Dk: int):
    """x [B, heads, T, D] as the kernels read it at head dim Dk: x itself
    at D == Dk, else a copy with Dk - D zero columns appended (contiguous,
    so its base and strides meet ``_check_views``' rules)."""
    D = x.shape[-1]
    return x if D == Dk else torch.nn.functional.pad(x, (0, Dk - D))


def _sliced(B: int, T: int, heads: int, D: int, Dk: int, dtype, device):
    """An output [B, heads, T, D] view of fresh [B, T, heads, Dk] storage
    -> (the view the kernel writes, the first D columns of it that the
    caller gets). Both meet ``_check_views``' rules, so an output can be
    fed back to a kernel (the ring passes o and do to B2)."""
    full = torch.empty((B, T, heads, Dk), dtype=dtype,
                       device=device).transpose(1, 2)
    return full, full[..., :D]


def _call(fn, q, ptrs, strides, dims, scale: float):
    _, source, suffix = KERNEL_FORMS[q.dtype]
    lib = _lib(source)
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    st_arr = (ctypes.c_longlong * len(strides))(*strides)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn + suffix)(ptr_arr, st_arr, dim_arr, scale,
                                       stream)
    if rc != 0:
        err = getattr(lib, f"tl_flash{suffix}_error_string")(rc).decode()
        raise RuntimeError(
            f"flash-attention kernel launch failed: CUDA error {rc} ({err})"
        )


def _dims(q, k, causal, window, delta_in: bool = False):
    B, H, Tq, D = q.shape
    return (B, H, k.shape[1], Tq, k.shape[2], D, int(bool(causal)),
            0 if window is None else int(window), int(delta_in))


def _launch_fwd(q, k, v, kv_mask, causal, window):
    B, H, Tq, D = q.shape
    Dk = _kernel_dim(D)
    q, k, v = (_padded(x, Dk) for x in (q, k, v))
    form = _check_views(q, {"q": q, "k": k, "v": v})[0]
    mask = _mask_u8(kv_mask, q)
    o, o_out = _sliced(B, Tq, H, D, Dk, q.dtype, q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(),
            lse.data_ptr()]
    strides = (*_strides(q), *_strides(k), *_strides(v), *_strides(o))
    _call("tl_flash_fwd", q, ptrs, strides, _dims(q, k, causal, window),
          D ** -0.5)
    flash_attention_fwd_lse.launches += 1
    flash_attention_fwd_lse.launches_by_variant[form] += 1
    return o_out, lse


def _launch_bwd(q, k, v, o, lse, do, kv_mask, causal, window, given=None):
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    Dk = _kernel_dim(D)
    q, k, v, o, do = (_padded(x, Dk) for x in (q, k, v, o, do))
    form = _check_views(q, {"q": q, "k": k, "v": v, "do": do, "o": o})[0]
    _check(lse.device == q.device and lse.dtype == torch.float32
           and lse.is_contiguous(), "lse must be contiguous float32 [B, H, Tq]")
    mask = _mask_u8(kv_mask, q)
    delta = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
             if given is None else given.contiguous())
    (dq, dq_out), (dk, dk_out), (dv, dv_out) = (
        _sliced(B, T, heads, D, Dk, q.dtype, q.device)
        for T, heads in ((Tq, H), (Tk, Hkv), (Tk, Hkv)))
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), None if mask is None else mask.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            o.data_ptr()]
    strides = tuple(
        s for x in (q, k, v, do, dq, dk, dv, o) for s in _strides(x)
    )
    _call("tl_flash_bwd", q, ptrs, strides,
          _dims(q, k, causal, window, given is not None), D ** -0.5)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_form["own" if given is None else "delta"] += 1
    flash_attention_bwd.launches_by_variant[form] += 1
    return dq_out, dk_out, dv_out


def _lib(source: str = "flash_attention.cu") -> ctypes.CDLL:
    from tensorlink_tpu_torch.ops._build import load

    lib = load(source)
    if not getattr(lib, "_tl_typed", False):
        P = ctypes.c_void_p
        for suffix in {x for _, s, x in KERNEL_FORMS.values() if s == source}:
            for name in ("tl_flash_fwd", "tl_flash_bwd"):
                fn = getattr(lib, name + suffix)
                # ptrs, strides, dims, scale, stream
                fn.argtypes = [P, P, P, ctypes.c_float, P]
                fn.restype = ctypes.c_int
            err = getattr(lib, f"tl_flash{suffix}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
        lib._tl_typed = True
    return lib
