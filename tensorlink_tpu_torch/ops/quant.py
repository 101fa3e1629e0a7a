"""int8 KV quantization for the paged cache (port of the KV half of
``tensorlink_tpu/ops/quant.py``).

One symmetric absmax scale per (token slot, kv head), computed from the
fresh k/v alone at cache-write time; a zero vector takes scale 1.0 so it
round-trips to exact zeros. Weight-only int8 (``quantize_weight_int8``)
waits for a later slice.
"""

from __future__ import annotations

import torch


def quantize_kv_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float -> (int8 [..., D], f32 scale [...])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(
    q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Inverse of ``quantize_kv_int8``: f32 multiply, then one cast."""
    return (q.float() * s[..., None].float()).to(dtype)
