"""int8 quantization for serving (port of ``tensorlink_tpu/ops/quant.py``).

**Weight-only int8.** A ``Dense`` weight [in, out] is stored as int8 with
one symmetric absmax scale per output channel (``{"q": int8 [in, out],
"s": f32 [out]}``; a zero column takes scale 1.0). In the module tree a
quantized ``Dense`` holds its weight as a child ``w``
(:class:`QuantizedWeight`) with buffers ``q`` and ``s``, so state-dict
names are the JAX tree's ``…w.q`` / ``…w.s``. The forward is the
reference's math, ``x @ dequantize_weight(w, x.dtype)``. XLA fuses that
dequantize into the matmul; here it is materialised (one int8 read and
one write of the activation-dtype copy, which the matmul reads again: 5
bytes a weight against bf16's 2), a plain product outside any kernel of
the port, as it is outside any Pallas kernel in the reference. Embeddings, norms, biases, a tied LM head,
and a MoE block's router and expert stacks (raw tensors, not ``Dense``)
stay in their dtypes. Quantize at serving time (``InferenceEngine(
quantize="int8")``), never in a training loop.

**KV int8** for the paged cache: one symmetric absmax scale per (token
slot, kv head), computed from the fresh k/v alone at cache-write time; a
zero vector takes scale 1.0 so it round-trips to exact zeros.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# output columns quantized at a time: the f32 temporaries of one weight
# stay bounded (a Llama-3 head is 4096 x 128256)
_QUANT_COLS = 4096


def quantize_weight_int8(w: torch.Tensor, group=None) -> dict:
    """[in, out] float -> {"q": int8 [in, out], "s": f32 [out]}, a
    symmetric per-output-channel absmax scale (the reference's math,
    column block by column block). ``group``: ``w`` is a row block of a
    weight split over that process group (tensor parallel "row"): the
    absmax is taken over every rank's rows, so the block quantizes as
    its rows of the whole weight do."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[1],), dtype=torch.float32, device=w.device)
    for c0 in range(0, w.shape[1], _QUANT_COLS):
        wf = w[:, c0:c0 + _QUANT_COLS].float()
        absmax = wf.abs().amax(dim=0)
        if group is not None:
            torch.distributed.all_reduce(absmax, op=torch.distributed.ReduceOp.MAX,
                                         group=group)
        sc = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        q[:, c0:c0 + _QUANT_COLS] = torch.clamp(torch.round(wf / sc), -127, 127).to(torch.int8)
        s[c0:c0 + _QUANT_COLS] = sc
    return {"q": q, "s": s}


def dequantize_weight(qw, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * s`` in ``dtype``: the reference casts both to ``dtype`` and
    multiplies. Here the int8 ``q`` meets ``s`` already cast, so type
    promotion does the cast inside the one multiply kernel (int8 values
    are exact in bf16 and f32, so the result is the same bits) and no
    ``dtype`` copy of ``q`` is written first. ``qw``: a ``{"q", "s"}``
    dict or a :class:`QuantizedWeight`."""
    q, s = (qw["q"], qw["s"]) if isinstance(qw, dict) else (qw.q, qw.s)
    return q * s.to(dtype)


class QuantizedWeight(nn.Module):
    """A quantized ``Dense`` weight: buffers ``q`` (int8 [in, out]) and
    ``s`` (f32 [out])."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


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


def _dense_cls():
    from tensorlink_tpu_torch.nn.layers import Dense

    return Dense


@torch.no_grad()
def quantize_params_int8(module: nn.Module, source: nn.Module | None = None,
                         group=None) -> nn.Module:
    """Quantize the weight of every ``Dense`` of ``module``, in place,
    walking the module tree: only ``Dense`` understands the quantized
    form, so a look-alike 2-D ``w`` elsewhere is never touched. Returns
    ``module``.

    With ``source`` (a module of the same structure), ``module`` — built
    on the meta device, so it holds no memory — takes ``source``'s
    weights instead: each ``Dense`` weight quantized from ``source``'s
    one at a time, every other parameter and buffer shared with
    ``source`` (the same tensors, no copy). That is how the int8 sibling
    of a served model is built without a second float copy.

    ``group``: the process group of the model axis that a module of
    tensor-parallel blocks is split over. Each block quantizes as its
    part of the whole weight: a "row" block's scales are taken over
    ``group``, and a row block without a group raises."""
    Dense = _dense_cls()
    src_mods = dict(source.named_modules()) if source is not None else None
    for name, mod in list(module.named_modules()):
        src = src_mods[name] if src_mods is not None else mod
        if src is not mod:
            for pname, p in src._parameters.items():
                if not (isinstance(mod, Dense) and pname == "w"):
                    mod._parameters[pname] = p
            for bname, b in src._buffers.items():
                mod._buffers[bname] = b
        if not isinstance(mod, Dense):
            continue
        w = src.w
        if isinstance(w, QuantizedWeight):
            if src is not mod:
                mod.set_quantized(w.q, w.s)
        elif w.dim() == 2 and w.is_floating_point():
            row_block = mod.shard == "row" and w.shape[0] != mod.in_dim
            if row_block and group is None:
                raise ValueError(
                    f"{name}: a row block of {w.shape[0]} of {mod.in_dim} "
                    "input rows quantizes over its model group: pass group="
                )
            qw = quantize_weight_int8(w, group if row_block else None)
            mod.set_quantized(qw["q"], qw["s"])
    return module


def quantized_spec_tree(spec_tree, params):
    """The ``param_spec`` tree of a quantized model (the reference's
    ``quantized_spec_tree``): where ``params`` (nested, or a flat state
    dict) holds a weight as ``{"q", "s"}``, ``q`` keeps the float
    weight's spec and the per-output-channel scale ``s`` takes the spec
    of the weight's last axis, so a "col" weight shards its scales with
    its columns and a "row" or replicated weight keeps them whole."""
    from tensorlink_tpu_torch.nn.module import P, is_spec
    from tensorlink_tpu_torch.utils.trees import nest

    def walk(spec, leaf):
        if isinstance(leaf, dict) and set(leaf) == {"q", "s"}:
            last = spec[-1] if is_spec(spec) and len(spec) else None
            return {"q": spec, "s": P(last)}
        if isinstance(leaf, dict) and not is_spec(spec):
            return {k: walk(spec[k], leaf[k]) if k in spec else spec.get(k)
                    for k in leaf}
        return spec

    if not any(isinstance(v, dict) for v in params.values()):
        params = nest(params)
    return walk(spec_tree, params)


def is_quantized(module_or_state) -> bool:
    """True if a module holds any quantized weight (or a state dict any
    ``….q`` / ``….s`` pair)."""
    if isinstance(module_or_state, nn.Module):
        return any(isinstance(m, QuantizedWeight) for m in module_or_state.modules())
    names = set(module_or_state)
    return any(n.endswith(".q") and n[:-2] + ".s" in names for n in names)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def quantization_report(float_module: nn.Module, quant_module: nn.Module) -> dict:
    """Bytes before and after, and the worst per-layer relative error of
    the already quantized weights (no re-quantization pass)."""
    Dense = _dense_cls()
    worst = 0.0
    qmods = dict(quant_module.named_modules())
    for name, mod in float_module.named_modules():
        qm = qmods.get(name)
        if isinstance(mod, Dense) and isinstance(getattr(qm, "w", None), QuantizedWeight):
            orig = mod.w.float()
            d = dequantize_weight(qm.w) - orig
            worst = max(worst, float(torch.linalg.norm(d) / (torch.linalg.norm(orig) + 1e-12)))
    before = _nbytes(float_module.state_dict().values())
    after = _nbytes(quant_module.state_dict().values())
    return {
        "bytes_before": int(before),
        "bytes_after": int(after),
        "compression": round(before / max(after, 1), 2),
        "worst_layer_rel_error": worst,
    }


@torch.no_grad()
def quantized_random_init(module: nn.Module, seed: int, device,
                          dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Random-init ``module`` (built on the meta device) directly in int8
    serving form on ``device``, never materializing float matmul weights:
    each ``Dense`` weight becomes uniform int8 in [-127, 127] with a
    per-channel scale that gives it the LeCun std 1/sqrt(fan_in)
    (uniform[-127, 127] has std ~73.3), ``Dense`` biases zeros, norm
    gains (``scale``) ones, every other tensor (embeddings, other biases)
    N(0, 0.02) in ``dtype``. Only ``Dense`` weights quantize, as in the
    reference: a MoE block's router and expert stacks are not ``Dense``
    and are drawn N(0, 0.02) in ``dtype`` too, so a Mixtral-8x7B under
    int8 still holds ~90 GB of bf16 experts (8 x 3 x 4096 x 14336 x 32
    layers) and does not fit one 80 GB card. For capacity and serving
    runs at real shapes; real checkpoints go through
    ``quantize_params_int8``. Returns ``module``."""
    Dense = _dense_cls()
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for mod in list(module.modules()):
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            if isinstance(mod, Dense) and pname == "w" and p.dim() == 2:
                fan_in, fan_out = p.shape
                q = torch.randint(-127, 128, (fan_in, fan_out), generator=gen,
                                  device=dev, dtype=torch.int8)
                s = torch.full((fan_out,), 1.0 / (73.3 * math.sqrt(fan_in)),
                               dtype=torch.float32, device=dev)
                mod.set_quantized(q, s)
                continue
            if isinstance(mod, Dense):
                t = torch.zeros(p.shape, dtype=dtype, device=dev)
            elif pname == "scale":
                t = torch.ones(p.shape, dtype=dtype, device=dev)
            else:
                t = torch.empty(p.shape, dtype=dtype, device=dev).normal_(
                    0.0, 0.02, generator=gen)
            mod._parameters[pname] = nn.Parameter(t, requires_grad=False)
    return module
