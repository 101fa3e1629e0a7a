"""Optimizers and LR schedules (port of ``tensorlink_tpu/train/optim.py``).

The same gradient-transformation shape as the reference:

    opt = adamw(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``params``, ``grads`` and the moments are flat collections of tensors: a
dict (a state dict) or a list. ``step`` is an int or a 0-d tensor on the
params' device; schedules and bias corrections are computed from it on
the device, so an update never waits on the host. Nothing is updated in
place: ``update`` and ``apply_updates`` return new tensors, as the
reference's pure functions do. The update math is the reference's — f32
throughout, bias-corrected Adam, decoupled weight decay for AdamW — in
``torch._foreach_*`` ops (a few launches per op over all tensors).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tensorlink_tpu_torch.utils.trees import global_norm

Schedule = Callable[[Any], torch.Tensor]

SUPPORTED_OPTIMIZERS = ("sgd", "adam", "adamw")
SUPPORTED_MOMENT_DTYPES = ("float32", "bfloat16")


def _moment_dtype_name(md) -> str:
    if isinstance(md, torch.dtype):
        return str(md).removeprefix("torch.")
    return str(md)


def _flat(tree):
    """(list of tensors, rebuild(list) -> same structure)."""
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(tree, (list, tuple)):
        return list(tree), list
    raise TypeError(f"expected a dict or list of tensors, got {type(tree).__name__}")


def _step_f32(step, like: torch.Tensor | None = None) -> torch.Tensor:
    device = like.device if like is not None else None
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), device=device)


def make_schedule(
    kind: str = "constant",
    base_lr: float = 1e-3,
    warmup_steps: int = 0,
    total_steps: int = 1000,
    final_lr_frac: float = 0.0,
) -> Schedule:
    """step -> learning rate (a 0-d f32 tensor on the step's device):
    linear warmup over ``warmup_steps``, then constant, linear or cosine
    decay to ``final_lr_frac * base_lr`` at ``total_steps``."""
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown schedule {kind!r}")

    def sched(step):
        step = _step_f32(step)
        warm = (
            torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
            if warmup_steps else 1.0
        )
        if kind == "constant":
            decay = 1.0
        else:
            frac = torch.clamp(
                (step - warmup_steps) / max(total_steps - warmup_steps, 1),
                0.0, 1.0,
            )
            if kind == "linear":
                decay = 1.0 - (1.0 - final_lr_frac) * frac
            else:
                decay = final_lr_frac + (1.0 - final_lr_frac) * 0.5 * (
                    1 + torch.cos(math.pi * frac)
                )
        return torch.full_like(step, base_lr) * warm * decay

    return sched


def _const(lr) -> Schedule:
    return lr if callable(lr) else (lambda step: torch.full_like(_step_f32(step), lr))


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params, step)


_M32 = 0xFFFFFFFF


def _mulmod32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), in 16-bit halves of c so
    no product leaves int64's range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mulmod32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mulmod32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _random_bits16(shape, step, salt: int, device) -> torch.Tensor:
    """16 uniform bits per element from a counter-based hash of (step,
    salt, element index), computed on the device: the same step and salt
    give the same bits on every device, and no host sync is needed."""
    step = torch.as_tensor(step, device=device).to(torch.int64)
    seed = _fmix32((step * 0x9E3779B9 + salt * 0x7FEB352D + 0x165667B1) & _M32)
    n = math.prod(shape)
    idx = torch.arange(n, device=device, dtype=torch.int64)
    h = _fmix32((idx * 0x9E3779B1 + seed) & _M32)
    return (h & 0xFFFF).to(torch.int32).reshape(shape)


def _stochastic_round_bf16(x: torch.Tensor, step, salt: int) -> torch.Tensor:
    """Unbiased f32 -> bf16: bf16 is the top 16 bits of f32, so adding a
    uniform 16-bit integer to the f32 bit pattern and truncating the low
    half rounds up with probability equal to the dropped fraction (exact
    for both signs). Non-finite values round to nearest — the bit trick
    would walk an inf's exponent into NaN space."""
    f = x.to(torch.float32)
    bits = f.view(torch.int32)
    r = _random_bits16(f.shape, step, salt, f.device)
    sr = ((bits + r) & -65536).view(torch.float32).to(torch.bfloat16)
    return torch.where(torch.isfinite(f), sr, f.to(torch.bfloat16))


def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor | None = None):
    """-> (grads scaled by min(1, max_norm / (norm + 1e-9)), norm).
    ``norm``: the caller's, where the gradient is larger than ``grads``
    (split over ranks); default the norm of ``grads``."""
    g, rebuild = _flat(grads)
    if norm is None:
        norm = global_norm(g)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return rebuild(torch._foreach_mul(g, scale)), norm


def sgd(
    lr: float | Schedule = 1e-2, momentum: float = 0.0, weight_decay: float = 0.0
) -> Optimizer:
    sched = _const(lr)

    def init(params):
        if momentum:
            p, rebuild = _flat(params)
            return {"mu": rebuild([torch.zeros_like(x) for x in p])}
        return {}

    def update(grads, state, params, step):
        g, rebuild = _flat(grads)
        p, _ = _flat(params)
        lr_t = sched(step if isinstance(step, torch.Tensor)
                     else _step_f32(step, g[0]))
        if weight_decay:
            g = torch._foreach_add(g, p, alpha=weight_decay)
        if momentum:
            mu, _ = _flat(state["mu"])
            mu = torch._foreach_add(torch._foreach_mul(mu, momentum), g)
            return rebuild(torch._foreach_mul(mu, -lr_t)), {"mu": rebuild(mu)}
        return rebuild(torch._foreach_mul(g, -lr_t)), state

    return Optimizer(init, update)


def adam(
    lr: float | Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    decoupled: bool = False,
    moment_dtype: str | torch.dtype = "float32",
) -> Optimizer:
    """``moment_dtype="bfloat16"`` STORES m and v in bf16 (the math stays
    f32), halving optimizer-state bytes. The store rounds stochastically
    (``_stochastic_round_bf16``): with b2 = 0.999 the per-step change of v
    is about 0.1% of v, below bf16's half-ulp, so round-to-nearest would
    freeze the second-moment average. The random bits derive from the
    step and a per-leaf salt, so runs stay reproducible."""
    sched = _const(lr)
    name = _moment_dtype_name(moment_dtype)
    if name not in SUPPORTED_MOMENT_DTYPES:
        raise ValueError(
            f"moment_dtype {moment_dtype!r} unsupported: "
            f"{SUPPORTED_MOMENT_DTYPES} (fp16's narrow exponent can "
            "over/underflow v)"
        )
    mdt = getattr(torch, name)

    def init(params):
        p, rebuild = _flat(params)
        return {
            "m": rebuild([torch.zeros_like(x, dtype=mdt) for x in p]),
            "v": rebuild([torch.zeros_like(x, dtype=mdt) for x in p]),
        }

    def update(grads, state, params, step):
        g, rebuild = _flat(grads)
        p, _ = _flat(params)
        step_t = step if isinstance(step, torch.Tensor) else _step_f32(step, g[0])
        step_f = step_t.to(torch.float32) + 1.0
        lr_t = sched(step_t)
        g = [x.float() for x in g]
        pf = [x.float() for x in p]
        if weight_decay and not decoupled:
            g = torch._foreach_add(g, pf, alpha=weight_decay)
        m_old = [x.float() for x in _flat(state["m"])[0]]
        v_old = [x.float() for x in _flat(state["v"])[0]]
        m = torch._foreach_add(torch._foreach_mul(m_old, b1),
                               torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_add(torch._foreach_mul(v_old, b2),
                               torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        mhat_scale = 1.0 / (1 - torch.pow(b1, step_f))
        vhat_scale = 1.0 / (1 - torch.pow(b2, step_f))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_mul(v, vhat_scale)), eps
        )
        u = torch._foreach_div(torch._foreach_mul(m, mhat_scale), den)
        u = torch._foreach_mul(u, -lr_t)
        if weight_decay and decoupled:
            u = torch._foreach_sub(u, torch._foreach_mul(pf, lr_t * weight_decay))
        updates = rebuild([ui.to(pi.dtype) for ui, pi in zip(u, p)])
        if mdt == torch.bfloat16:
            # deterministic-by-step rounding streams: same step, same bits
            def store(ts, salt):
                return rebuild([
                    _stochastic_round_bf16(t, step_t, salt + i)
                    for i, t in enumerate(ts)
                ])

            return updates, {"m": store(m, 0), "v": store(v, 1 << 20)}
        return updates, {"m": rebuild(m), "v": rebuild(v)}

    return Optimizer(init, update)


def adamw(
    lr: float | Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    moment_dtype: str | torch.dtype = "float32",
) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay=weight_decay, decoupled=True,
                moment_dtype=moment_dtype)


def apply_updates(params, updates):
    p, rebuild = _flat(params)
    u, _ = _flat(updates)
    return rebuild(torch._foreach_add(p, [ui.to(pi.dtype) for ui, pi in zip(u, p)]))


def make_optimizer(
    name: str,
    lr: float | Schedule,
    weight_decay: float = 0.0,
    moment_dtype: str | torch.dtype = "float32",
) -> Optimizer:
    if name == "sgd":
        if _moment_dtype_name(moment_dtype) != "float32":
            # sgd stores no moments: a silently ignored dtype request
            # would misreport the memory budget
            raise ValueError("moment_dtype is an adam/adamw option")
        return sgd(lr, weight_decay=weight_decay)
    if name == "adam":
        return adam(lr, weight_decay=weight_decay, moment_dtype=moment_dtype)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay, moment_dtype=moment_dtype)
    raise ValueError(f"unknown optimizer {name!r}")
