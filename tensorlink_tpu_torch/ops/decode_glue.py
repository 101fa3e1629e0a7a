"""Fused residual add + norm for the decode hot path (port of
``tensorlink_tpu/ops/pallas/decode_glue.py``).

``fused_residual_norm(x, res, scale, bias)`` returns
``(x + res, norm(x + res) * scale [+ bias])`` with f32 math and both
outputs in x's dtype — the glue between the attention output and the
MLP's input that ``TransformerBlock`` runs on every T == 1 eval decode
step of every layer. A CUDA tensor launches the hand-written kernel in
``csrc/decode_glue.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``): one block a row, or a thread-block cluster for a row wider
than a block holds; a CPU tensor takes ``fused_residual_norm_reference``.

The kernel is one elementwise add plus a one-row mean/variance reduction
and a scale: it reads x, res, scale (and bias) once and writes two rows,
so it is bound by those bytes. ``launch_geometry`` picks its launch on
the host: the cluster size C, the threads of a block, the vector width
and the vectors a thread holds. Its limit is ``1 <= D <= MAX_D`` in
f32, bf16 or f16; anything else raises instead of falling back.
``fused_residual_norm.launches`` counts the kernel's launches and
``fused_residual_norm.launches_by_form`` splits them by norm form.
``fused_residual_norm_split_reference`` repeats the kernel's order of
reduction (each thread's moments merged with Chan's formula over lanes,
warps and the cluster's blocks) in PyTorch.
"""

import ctypes
import functools

import torch

MAX_D = 65536  # 8 blocks of a cluster x 1024 threads x 8 elements
# launch limits of csrc/decode_glue.cu
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_THREADS = 1024
THREAD_ELEMS = 8  # elements a thread holds in registers (nv x vec)
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _norm_f32(r, scale, bias, eps: float, kind: str):
    """The f32 norm expression, one home shared with the kernel's
    reference."""
    if kind == "layer":
        mu = r.mean(dim=-1, keepdim=True)
        var = (r - mu).square().mean(dim=-1, keepdim=True)
        y = (r - mu) * torch.rsqrt(var + eps)
    elif kind == "rms":
        ms = r.square().mean(dim=-1, keepdim=True)
        y = r * torch.rsqrt(ms + eps)
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    y = y * scale
    if bias is not None:
        y = y + bias
    return y


def fused_residual_norm_reference(x, res, scale, bias=None, *,
                                  eps: float = 1e-6, kind: str = "layer"):
    """Plain PyTorch version: same f32 math, both outputs in x.dtype."""
    r = x.float() + res.float()
    y = _norm_f32(
        r, scale.float(), None if bias is None else bias.float(), eps, kind
    )
    return r.to(x.dtype), y.to(x.dtype)


def fused_residual_norm(
    x: torch.Tensor,  # [..., D] branch output (attention / MLP)
    res: torch.Tensor,  # [..., D] carried residual
    scale: torch.Tensor,  # [D] norm gain
    bias: torch.Tensor | None = None,  # [D] LayerNorm bias
    *,
    eps: float = 1e-6,
    kind: str = "layer",  # "layer" | "rms"
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (x + res, norm(x + res) * scale [+ bias]), both in x.dtype."""
    if x.shape != res.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(res.shape)}")
    if kind not in ("layer", "rms"):
        raise ValueError(f"unknown norm kind {kind!r}")
    if x.device.type == "cpu":
        return fused_residual_norm_reference(
            x, res, scale, bias, eps=eps, kind=kind
        )
    if x.device.type != "cuda":
        raise ValueError(f"no fused-norm path for device {x.device}")
    return _launch(x, res, scale, bias, eps, kind)


fused_residual_norm.launches = 0
# launches by norm form ("rms" or "layer", "+bias" when a bias was given)
FORMS = ("rms", "rms+bias", "layer", "layer+bias")
fused_residual_norm.launches_by_form = dict.fromkeys(FORMS, 0)




def _tree_merge(n, mean, m2, rms: bool):
    """Merge moments along the last dim (a power of two long) as the
    kernel's shuffle tree does: position i takes i + o for o = 1, 2, 4,
    ..., i a multiple of 2 o; Chan's formula, exact for empty sides (n 0),
    or plain sums for RMSNorm. -> the merged (n, mean, m2), last dim
    dropped."""
    n, mean, m2 = n.clone(), mean.clone(), m2.clone()
    o = 1
    while o < n.shape[-1]:
        a, b = slice(0, None, 2 * o), slice(o, None, 2 * o)
        na, nb = n[..., a], n[..., b]
        tot = na + nb
        if rms:
            mean_ab, m2_ab = mean[..., a], m2[..., a] + m2[..., b]
        else:
            d = mean[..., b] - mean[..., a]
            f = torch.where(tot > 0, nb / tot.clamp_min(1), 0.0)
            mean_ab = torch.where(
                na == 0, mean[..., b],
                torch.where(nb == 0, mean[..., a], mean[..., a] + d * f))
            m2_ab = torch.where(
                na == 0, m2[..., b],
                torch.where(nb == 0, m2[..., a],
                            m2[..., a] + m2[..., b] + d * d * na * f))
        n[..., a], mean[..., a], m2[..., a] = tot, mean_ab, m2_ab
        o *= 2
    return n[..., 0], mean[..., 0], m2[..., 0]


def _pad_pow2(x, fill=0.0):
    """Pad the last dim with ``fill`` up to a power of two."""
    size = 1 << (x.shape[-1] - 1).bit_length()
    pad = x.new_full((*x.shape[:-1], size - x.shape[-1]), fill)
    return torch.cat([x, pad], dim=-1)


def _split_moments(r, C: int, threads: int, vec: int, nv: int, rms: bool):
    """(mean, M2) — for RMSNorm (0, sum of squares) — of each row of f32
    ``r`` [rows, D] as the kernel forms them: two-pass (n, mean, M2) of
    each thread's elements (its nv vectors of vec), merged as shuffle trees
    over the 32 lanes of each warp, then over the block's warps, then over
    the cluster's C ranks."""
    rows, D = r.shape
    nvec = D // vec
    per_block = -(-nvec // C)
    c = torch.arange(C)[:, None, None]
    i = torch.arange(nv)[None, None, :] * threads + torch.arange(threads)[None, :, None]
    live = i < (nvec - c * per_block).clamp(max=per_block)  # [C, threads, nv]
    first = ((c * per_block + i) * vec).clamp(max=D - vec)
    idx = first[..., None] + torch.arange(vec)  # [C, threads, nv, vec]
    vals = r[:, idx.reshape(-1)].reshape(rows, C, threads, nv * vec)
    keep = live[..., None].expand(C, threads, nv, vec).reshape(C, threads, nv * vec)
    n = keep.sum(dim=-1).float().expand(rows, C, threads)
    if rms:
        mean = torch.zeros_like(n)
        m2 = torch.where(keep, vals * vals, 0.0).sum(dim=-1)
    else:
        mean = torch.where(keep, vals, 0.0).sum(dim=-1) / n.clamp_min(1)
        m2 = torch.where(keep, (vals - mean[..., None]).square(), 0.0).sum(dim=-1)
    # lanes, then warps (padded to 32 empty ones), then ranks
    warps = -(-threads // 32)
    lanes = [x.reshape(rows, C, warps, 32) for x in (n, mean, m2)]
    n, mean, m2 = _tree_merge(*lanes, rms)
    n, mean, m2 = _tree_merge(*(_pad_pow2(x) for x in (n, mean, m2)), rms)
    n, mean, m2 = _tree_merge(n, mean, m2, rms)
    return mean[:, None], m2[:, None]


def fused_residual_norm_split_reference(x, res, scale, bias=None, *,
                                        eps: float = 1e-6,
                                        kind: str = "layer"):
    """The kernel's order of reduction in plain PyTorch (``_split_moments``
    at the ``launch_geometry`` of this row, pointers 16-byte aligned):
    each thread's two-pass moments merged with Chan's formula as the
    kernel's shuffle trees do. Same outputs as
    ``fused_residual_norm_reference`` up to f32 rounding."""
    geometry = launch_geometry(x.shape[-1], x.element_size())
    return _split_norm(x, res, scale, bias, eps, kind, geometry)


def _split_norm(x, res, scale, bias, eps: float, kind: str, geometry):
    """``fused_residual_norm_split_reference`` at a given launch geometry
    (C, threads, vec, nv)."""
    if kind not in ("layer", "rms"):
        raise ValueError(f"unknown norm kind {kind!r}")
    D = x.shape[-1]
    C, threads, vec, nv = geometry
    r = x.float().reshape(-1, D) + res.float().reshape(-1, D)
    mean, m2 = _split_moments(r, C, threads, vec, nv, kind == "rms")
    y = (r - mean) * torch.rsqrt(m2 / D + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return (r.to(x.dtype).reshape(x.shape), y.to(x.dtype).reshape(x.shape))


@functools.lru_cache(maxsize=256)
def launch_geometry(D: int, itemsize: int, scale_itemsize: int = 4,
                    align: int = 16,
                    scale_align: int = 16) -> tuple[int, int, int, int]:
    """-> (C, threads, vec, nv): the launch of one row of D elements of
    ``itemsize`` bytes. The row is split over a cluster of C blocks, the
    fewest that hold it at MAX_THREADS x THREAD_ELEMS elements a block, so
    one block up to D 8192 (a cluster barrier costs more than a split
    saves at the decode step's 8 x 4096, PERF.md); ``_block_geometry``
    gives the rest."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"fused-norm kernel: feature dim {D} outside 1..{MAX_D}")
    C = 1
    while C < CLUSTER_SIZES[-1] and C * MAX_THREADS * THREAD_ELEMS < D:
        C *= 2
    return _block_geometry(D, itemsize, C, scale_itemsize, align, scale_align)


def _block_geometry(D: int, itemsize: int, C: int, scale_itemsize: int = 4,
                    align: int = 16,
                    scale_align: int = 16) -> tuple[int, int, int, int]:
    """-> (C, threads, vec, nv) of a row of D split over C blocks. vec is
    the widest vector (at most 16 bytes) that divides D and the data
    pointers' alignment ``align`` (and, at most 16 bytes of it, the
    scale/bias pointers' ``scale_align``), so every row starts aligned;
    odd D is scalar. Block c takes vectors [c p, (c + 1) p) with
    p = ceil(D / vec / C), its thread t the vectors c p + j threads + t
    for j < nv."""
    vec = 16 // itemsize
    while vec > 1 and (D % vec or align % (vec * itemsize)
                       or scale_align % min(16, vec * scale_itemsize)):
        vec //= 2
    nvec = D // vec
    per_block = -(-nvec // C)
    nv = 1
    while -(-per_block // nv) > MAX_THREADS:
        nv *= 2
    if nv * vec > THREAD_ELEMS:
        raise ValueError(
            f"fused-norm kernel: D {D} in {C} blocks needs {nv} vectors of "
            f"{vec} a thread (at most {THREAD_ELEMS} elements)"
        )
    need = -(-per_block // nv)  # threads that cover the block's vectors
    return C, min(MAX_THREADS, -(-need // 32) * 32), vec, nv


def _align(*ptrs) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    for p in ptrs:
        while p % a:
            a //= 2
    return a


def _launch(x, res, scale, bias, eps, kind):
    D = x.shape[-1]
    if not 1 <= D <= MAX_D:
        raise ValueError(f"fused-norm kernel: feature dim {D} outside 1..{MAX_D}")
    if x.dtype not in _TYPE_CODES:
        raise ValueError(f"fused-norm kernel: dtype {x.dtype}")
    for name, t in (("res", res), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"fused-norm kernel: {name} on {t.device}")
    if scale.shape != (D,) or (bias is not None and bias.shape != (D,)):
        raise ValueError("fused-norm kernel: scale/bias must be [D]")
    # scale and bias in f32 or in x's type, the two pairs the kernel has
    sdt = scale.dtype if scale.dtype in (torch.float32, x.dtype) else torch.float32
    scale = scale.to(sdt).contiguous()
    if bias is not None:
        bias = bias.to(sdt).contiguous()
    x2 = x.reshape(-1, D).contiguous()
    r2 = res.to(x.dtype).reshape(-1, D).contiguous()
    rows = x2.shape[0]
    r_out = torch.empty_like(x2)
    y_out = torch.empty_like(x2)
    if rows:
        ptrs = (x2.data_ptr(), r2.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(),
                r_out.data_ptr(), y_out.data_ptr())
        C, threads, vec, nv = launch_geometry(
            D, x.element_size(), scale.element_size(),
            _align(ptrs[0], ptrs[1], ptrs[4], ptrs[5]),
            _align(ptrs[2], ptrs[2] if ptrs[3] is None else ptrs[3]),
        )
        dims = (rows, D, _TYPE_CODES[x.dtype], 0 if sdt == torch.float32 else 1,
                C, threads, vec, nv, int(kind == "rms"))
        lib = _lib()
        ptr_arr = (ctypes.c_void_p * 6)(*ptrs)
        dim_arr = (ctypes.c_int * 9)(*dims)
        dev = x.device

        def call():
            return lib.tl_fused_norm(ptr_arr, dim_arr, eps,
                                     torch.cuda.current_stream(dev).cuda_stream)

        # the device switch only where needed: the host sets the decode
        # step's pace, and this runs 32 times a step
        if dev.index == torch.cuda.current_device():
            rc = call()
        else:
            with torch.cuda.device(dev):
                rc = call()
        if rc != 0:
            raise RuntimeError(
                f"fused-norm kernel launch failed: CUDA error {rc} "
                f"({lib.tl_fused_norm_error_string(rc).decode()})"
            )
        fused_residual_norm.launches += 1
        fused_residual_norm.launches_by_form[
            kind + ("" if bias is None else "+bias")] += 1
    return r_out.reshape(x.shape), y_out.reshape(x.shape)


def _lib() -> ctypes.CDLL:
    from tensorlink_tpu_torch.ops._build import load

    lib = load("decode_glue.cu")
    if not getattr(lib, "_tl_typed", False):
        P = ctypes.c_void_p
        # ptrs, dims, eps, stream
        lib.tl_fused_norm.argtypes = [P, P, ctypes.c_float, P]
        lib.tl_fused_norm.restype = ctypes.c_int
        lib.tl_fused_norm_error_string.argtypes = [ctypes.c_int]
        lib.tl_fused_norm_error_string.restype = ctypes.c_char_p
        lib._tl_typed = True
    return lib
