"""Fused residual add + norm for the decode hot path (port of
``tensorlink_tpu/ops/pallas/decode_glue.py``).

``fused_residual_norm(x, res, scale, bias)`` returns
``(x + res, norm(x + res) * scale [+ bias])`` with f32 math and both
outputs in x's dtype — the glue between the attention output and the
MLP's input that ``TransformerBlock`` runs on every T == 1 eval decode
step of every layer. A CUDA tensor launches the Triton kernel below (one
program per row); a CPU tensor takes ``fused_residual_norm_reference``.

The kernel is one elementwise add plus a one-row mean/variance reduction
and a scale: it reads x, res, scale (and bias) once and writes two rows,
so it is bound by those bytes. Its limit is one row in one program:
``D <= MAX_D``; wider rows raise instead of falling back.
"""

import torch

MAX_D = 65536  # one program holds a row: BLOCK_D = next power of two >= D

_KERNEL = None


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


def _launch(x, res, scale, bias, eps, kind):
    D = x.shape[-1]
    if not 1 <= D <= MAX_D:
        raise ValueError(f"fused-norm kernel: feature dim {D} > {MAX_D}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"fused-norm kernel: dtype {x.dtype}")
    for name, t in (("res", res), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"fused-norm kernel: {name} on {t.device}")
    if scale.shape != (D,) or (bias is not None and bias.shape != (D,)):
        raise ValueError("fused-norm kernel: scale/bias must be [D]")
    x2 = x.reshape(-1, D).contiguous()
    r2 = res.to(x.dtype).reshape(-1, D).contiguous()
    rows = x2.shape[0]
    r_out = torch.empty_like(x2)
    y_out = torch.empty_like(x2)
    if rows:
        block = 1 << (D - 1).bit_length()
        kernel = _kernel()
        with torch.cuda.device(x.device):
            kernel[(rows,)](
                x2, r2, scale.contiguous(),
                scale if bias is None else bias.contiguous(),
                r_out, y_out, D, float(eps),
                HAS_BIAS=bias is not None, IS_RMS=kind == "rms",
                BLOCK_D=block, num_warps=min(max(block // 256, 1), 16),
            )
        fused_residual_norm.launches += 1
    return r_out.reshape(x.shape), y_out.reshape(x.shape)


def _kernel():
    """Build (at first use) the Triton kernel. ``triton`` is imported
    here, never at module import: the module must import where Triton is
    absent (CPU hosts run the reference)."""
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl  # bound as a module global: the kernel reads it

    @triton.jit
    def fused_residual_norm_kernel(
        x_ptr, res_ptr, scale_ptr, bias_ptr, r_ptr, y_ptr, D, eps,
        HAS_BIAS: tl.constexpr, IS_RMS: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK_D)
        live = offs < D
        base = row * D
        x = tl.load(x_ptr + base + offs, mask=live, other=0.0).to(tl.float32)
        rs = tl.load(res_ptr + base + offs, mask=live, other=0.0).to(tl.float32)
        r = x + rs
        tl.store(r_ptr + base + offs, r.to(r_ptr.dtype.element_ty), mask=live)
        if IS_RMS:
            ms = tl.sum(r * r, axis=0) / D
            y = r * tl.rsqrt(ms + eps)
        else:
            mu = tl.sum(r, axis=0) / D
            c = tl.where(live, r - mu, 0.0)
            var = tl.sum(c * c, axis=0) / D
            y = c * tl.rsqrt(var + eps)
        s = tl.load(scale_ptr + offs, mask=live, other=0.0).to(tl.float32)
        y = y * s
        if HAS_BIAS:
            y = y + tl.load(bias_ptr + offs, mask=live, other=0.0).to(tl.float32)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=live)

    _KERNEL = fused_residual_norm_kernel
    return _KERNEL
