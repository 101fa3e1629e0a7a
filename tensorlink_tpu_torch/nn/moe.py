"""Mixture-of-Experts feed-forward (port of ``tensorlink_tpu/nn/moe.py``).

``MoEFeedForward`` is a drop-in for ``FeedForward``: [B, T, D] -> [B, T, D].
Its parameters are the reference's tree, name for name: ``router.w``
[D, E] and the expert stacks ``up``/``gate`` [E, D, H] and ``down``
[E, H, D] (raw stacked tensors, not ``Dense``: weight-only int8 leaves
them float, as the reference does).

Token-choice top-k routing with a per-expert capacity (Switch/GShard):
each batch row is one routing group of its T tokens, with capacity
``C = max(int(capacity_factor * top_k * T / E), 1)``, so WHICH tokens
drop depends on the T of the call (a prefill chunk, a T == 1 decode
step, a K + 1 verify pass) exactly as in the reference. A token's
position in its expert comes from a cumulative sum over the row's
tokens (pads count where they sit), carried across the k choices by a
running per-expert fill; overflow routes are dropped (the residual path
carries the token). The combine weights are normalised over the
selected experts; the GShard auxiliary loss is returned beside the
output.

The rounding follows the reference step for step: router logits in f32
from f32 copies of the activations and the router weight, the softmax
in f32, ``dispatch``/``combine`` cast to the activation dtype before the
dense one-hot einsums, and the expert products in the activation dtype.
The expert products are plain ``torch.einsum`` batched GEMMs, as they
are XLA einsums outside any Pallas kernel in the reference. Routing
reads nothing back to the host (one-hot by comparison with
``torch.arange``, no ``.item()``, no boolean indexing), so the MoE FFN
runs inside a captured decode chunk; ``routing_stats`` is the one
telemetry call that reads a value back, once, at its end.

Deliberate differences: ``router_noise`` (training only, default 0)
draws from an explicit ``torch.Generator``, so its bits differ from
JAX's normal draw; ``ep_axis`` is kept for config parity and does
nothing on one card (the reference's output with no ambient mesh is
bit-identical to the single-device path).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorlink_tpu_torch.nn.module import Module, P, register_module_type


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, device=device, dtype=dtype), requires_grad=False
    )


def expert_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots each expert has for one routing group (a batch row) of
    ``tokens_per_group`` tokens: ``max(int(cf * k * T / E), 1)``."""
    return max(int(capacity_factor * top_k * tokens_per_group / num_experts), 1)


class Router(nn.Module):
    """The router's weight ``w`` [D, E], read raw (never quantized)."""

    def __init__(self, dim: int, num_experts: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = _param((dim, num_experts), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.w.normal_(0.0, 0.02, generator=generator)


@register_module_type
class MoEFeedForward(Module):
    """``forward`` returns the output; ``forward_with_aux`` returns
    ``(output, aux_loss)`` for load-balanced training."""

    def __init__(self, dim: int, hidden_dim: int, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 gated: bool = True, router_noise: float = 0.0,
                 activation: str = "gelu", ep_axis: str | None = "model", *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.hidden_dim = hidden_dim
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.gated = gated
        self.router_noise = router_noise
        self.activation = activation
        self.ep_axis = ep_axis
        E, D, H = num_experts, dim, hidden_dim
        self.router = Router(D, E, device=device, dtype=dtype)
        self.up = _param((E, D, H), device, dtype)
        self.register_parameter(
            "gate", _param((E, D, H), device, dtype) if gated else None)
        self.down = _param((E, H, D), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Stacked LeCun normal: fan-in D for ``up``/``gate``, H for
        ``down`` (the router resets itself, N(0, 0.02))."""
        std_in = math.sqrt(1.0 / self.dim)
        self.up.normal_(0.0, std_in, generator=generator)
        if self.gate is not None:
            self.gate.normal_(0.0, std_in, generator=generator)
        self.down.normal_(0.0, math.sqrt(1.0 / self.hidden_dim),
                          generator=generator)

    def weights(self) -> list[torch.Tensor]:
        """Every tensor one weight pass reads: the router and all E
        experts (the dense dispatch multiplies through each of them)."""
        return [t for t in (self.router.w, self.up, self.gate, self.down)
                if t is not None]

    def param_spec(self, model_axis: str = "model"):
        """The reference's expert-parallel layout: the expert axis of
        ``up``/``gate``/``down`` over ``model``, the router replicated."""
        spec = {"router": {"w": P()}, "up": P(model_axis, None, None),
                "down": P(model_axis, None, None)}
        if self.gated:
            spec["gate"] = P(model_axis, None, None)
        return spec

    def capacity(self, tokens_per_group: int) -> int:
        return expert_capacity(tokens_per_group, self.num_experts, self.top_k,
                               self.capacity_factor)

    def _route(self, logits: torch.Tensor, rng=None, train: bool = False):
        """logits [B, T, E] -> (dispatch [B, T, E, C], combine [B, T, E, C],
        aux_loss), all f32. Top-k with per-expert capacity."""
        B, T, E = logits.shape
        C = self.capacity(T)
        dev = logits.device
        if train and self.router_noise > 0 and rng is not None:
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=rng, device=dev, dtype=logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1)
        experts = torch.arange(E, device=dev)
        slots = torch.arange(C, device=dev)
        dispatch = torch.zeros((B, T, E, C), dtype=torch.float32, device=dev)
        combine = torch.zeros_like(dispatch)
        # running per-expert fill: the k = 2 choices respect the capacity
        # the k = 1 choices consumed
        fill = torch.zeros((B, E), dtype=torch.int32, device=dev)
        importance = torch.zeros((B, E), dtype=torch.float32, device=dev)
        masked = probs
        for _ in range(self.top_k):
            idx = masked.argmax(dim=-1)  # [B, T], the first maximum
            onehot = (idx[..., None] == experts).float()  # [B, T, E]
            importance = importance + onehot.mean(dim=1)
            # each token's position within its chosen expert
            pos = onehot.cumsum(dim=1) - onehot + fill[:, None, :]
            pos = (pos * onehot).sum(dim=-1).int()  # [B, T]
            keep = pos < C
            w = (probs * onehot).sum(dim=-1) * keep  # [B, T]
            poh = (pos[..., None] == slots).float()  # [B, T, C]; 0 past C
            sel = onehot[..., None] * poh[:, :, None, :]  # [B, T, E, C]
            dispatch = dispatch + sel * keep[..., None, None]
            combine = combine + sel * w[..., None, None]
            fill = fill + (onehot * keep[..., None]).sum(dim=1).int()
            # exclude the chosen expert (a multiply, as the reference:
            # -inf masking would change which of tied experts comes next)
            masked = masked * (1.0 - onehot)
        denom = combine.sum(dim=(2, 3), keepdim=True)
        combine = combine / denom.clamp_min(1e-9)
        # GShard aux loss: E * mean(fraction routed) . mean(router prob)
        frac = importance / self.top_k
        aux = E * (frac * probs.mean(dim=1)).sum(dim=-1).mean()
        return dispatch, combine, aux

    def _router_logits(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.router.w.float()

    def forward_with_aux(self, x: torch.Tensor, *, rng=None,
                         train: bool = False):
        if self.up.shape[0] != self.num_experts:
            raise NotImplementedError(
                "expert-parallel MoE (experts split over the model axis) "
                "waits for the expert-parallel dispatch")
        dispatch, combine, aux = self._route(self._router_logits(x), rng, train)
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
        expert_in = torch.einsum("btec,btd->ebcd", dispatch, x)
        up = torch.einsum("ebcd,edh->ebch", expert_in, self.up.to(x.dtype))
        if self.gated:
            g = torch.einsum("ebcd,edh->ebch", expert_in, self.gate.to(x.dtype))
            h = F.silu(g) * up
        else:
            from tensorlink_tpu_torch.nn.transformer import ACTIVATIONS

            h = ACTIVATIONS[self.activation](up)
        expert_out = torch.einsum("ebch,ehd->ebcd", h, self.down.to(x.dtype))
        return torch.einsum("btec,ebcd->btd", combine, expert_out), aux

    def forward(self, x: torch.Tensor, *, rng=None, train: bool = False, **_
                ) -> torch.Tensor:
        return self.forward_with_aux(x, rng=rng, train=train)[0]

    def routing_stats(self, x: torch.Tensor) -> dict:
        """Router telemetry on ``x`` [B, T, D]: the fraction of (token,
        choice) routes the capacity drops (the residual path carries
        them), the aux loss and the capacity per expert. ``dispatch``
        sums to the kept routes; everything is computed on the device
        and read back once, here."""
        B, T, _ = x.shape
        dispatch, _, aux = self._route(self._router_logits(x))
        kept, aux = torch.stack([dispatch.sum(), aux]).tolist()
        return {
            "drop_fraction": 1.0 - kept / (B * T * self.top_k),
            "aux_loss": aux,
            "capacity_per_expert": self.capacity(T),
        }
