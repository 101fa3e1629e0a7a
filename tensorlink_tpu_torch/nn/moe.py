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

Expert parallelism: on a model group of m ranks a rank holds ``E/m``
experts, the contiguous slice ``[r E/m, (r+1) E/m)`` of ``up``/``gate``/
``down`` that ``param_spec`` cuts; the router stays whole. A layer
handed such blocks runs one of the reference's two lowerings, chosen as
the reference chooses them (``parallel/ep.py``):

- the fallback, under ``tp.model_parallel`` alone: every rank routes
  every token, slices ``dispatch``/``combine`` to its experts, runs them
  and combines a partial [B, T, D]; ``tp.reduce_from_model`` sums the
  partials (one all-reduce a layer) and ``tp.copy_to_model`` sits on
  the input;
- the all_to_all form, under ``ep.ep_parallel`` too: the rank takes its
  ``B/m`` batch rows (``tp.scatter_rows_to_model``), routes them
  (capacity is per row, so the drops are the world-1 drops), swaps
  ``expert_in`` [E, B/m, C, D] to [E/m, B, C, D] with one
  ``all_to_all_single`` (``tp.all_to_all_model``), runs its experts,
  swaps back, combines its rows and all-gathers them
  (``tp.gather_rows_to_model``). A batch that ``m`` does not divide
  takes the fallback.

Both forms return the world-1 output and aux and leave the world-1
router gradient on every rank: the router weight goes through
``tp.copy_to_model``, whose backward sums the ranks' partial gradients
(their rows, or their experts' combine weights), and the aux term is
counted once (the all_to_all form averages the ranks' aux with one
all-reduce, whose backward hands each rank 1/m of the cotangent; the
fallback's aux, computed whole on every rank, passes 1/m of its
gradient). The expert blocks' gradients stay local. Router noise is
drawn over the whole batch and sliced, so a token draws the same bits at
any m. ``E % m != 0`` raises ``ValueError`` (``check_expert_split``).

Deliberate differences: ``router_noise`` (training only, default 0)
draws from an explicit ``torch.Generator``, so its bits differ from
JAX's normal draw; ``ep_axis`` (falsy: never the all_to_all form) names
no mesh axis here, since the experts are cut over the model group.
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


def check_expert_split(num_experts: int, model: int) -> None:
    """Refuse a model axis that does not divide the experts (the
    reference's ``P(model, ...)`` cannot shard them either)."""
    if num_experts % model:
        raise ValueError(
            f"{num_experts} experts do not split over a model axis of "
            f"{model}: expert parallelism needs num_experts % model == 0")


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


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

    def _noise(self, shape, device, rng, train: bool):
        """Router noise of f32 logits of ``shape`` ([B, T, E]), or None
        (eval, no noise or no generator)."""
        if not (train and self.router_noise > 0 and rng is not None):
            return None
        return self.router_noise * torch.randn(
            shape, generator=rng, device=device, dtype=torch.float32)

    def _route(self, logits: torch.Tensor, rng=None, train: bool = False):
        """logits [B, T, E] -> (dispatch [B, T, E, C], combine [B, T, E, C],
        aux_loss), all f32. Top-k with per-expert capacity."""
        B, T, E = logits.shape
        C = self.capacity(T)
        dev = logits.device
        noise = self._noise(logits.shape, dev, rng, train)
        if noise is not None:
            logits = logits + noise
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

    def _router_logits(self, x: torch.Tensor, w=None) -> torch.Tensor:
        return x.float() @ (self.router.w if w is None else w).float()

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """[e, b, C, D] -> [e, b, C, D] through the experts held here."""
        dt = expert_in.dtype
        up = torch.einsum("ebcd,edh->ebch", expert_in, self.up.to(dt))
        if self.gated:
            g = torch.einsum("ebcd,edh->ebch", expert_in, self.gate.to(dt))
            h = F.silu(g) * up
        else:
            from tensorlink_tpu_torch.nn.transformer import ACTIVATIONS

            h = ACTIVATIONS[self.activation](up)
        return torch.einsum("ebch,ehd->ebcd", h, self.down.to(dt))

    def forward_with_aux(self, x: torch.Tensor, *, rng=None,
                         train: bool = False):
        held = self.up.shape[0]
        if held != self.num_experts:
            return self._forward_parallel(x, rng, train, held)
        dispatch, combine, aux = self._route(self._router_logits(x), rng, train)
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
        expert_out = self._experts(torch.einsum("btec,btd->ebcd", dispatch, x))
        return torch.einsum("btec,ebcd->btd", combine, expert_out), aux

    def _forward_parallel(self, x, rng, train: bool, held: int):
        """An expert block over the active model group: the all_to_all
        form under ``ep.ep_parallel``, else the fallback (module
        docstring)."""
        import torch.distributed as dist

        from tensorlink_tpu_torch.parallel import ep, tp

        group = tp.model_group()
        m, r = dist.get_world_size(group), dist.get_rank(group)
        check_expert_split(self.num_experts, m)
        if held * m != self.num_experts:
            raise ValueError(
                f"this rank holds {held} of {self.num_experts} experts on a "
                f"model group of {m}")
        w = tp.copy_to_model(self.router.w)
        B, T, _ = x.shape
        # drawn over the whole batch, so a token's bits do not depend on m
        noise = self._noise((B, T, self.num_experts), x.device, rng, train)
        if self.ep_axis and ep.ep_group() is not None and B % m == 0:
            xr = tp.scatter_rows_to_model(x)
            rows = slice(r * (B // m), (r + 1) * (B // m))
            logits = self._router_logits(xr, w)
            if noise is not None:
                logits = logits + noise[rows]
            dispatch, combine, aux = self._route(logits)
            aux = tp.reduce_from_model(aux) / m
            expert_in = torch.einsum("btec,btd->ebcd", dispatch.to(x.dtype), xr)
            expert_in = tp.all_to_all_model(expert_in, 0, 1)  # [E/m, B, C, D]
            expert_out = tp.all_to_all_model(self._experts(expert_in), 1, 0)
            out = torch.einsum("btec,ebcd->btd", combine.to(x.dtype), expert_out)
            return tp.gather_rows_to_model(out), aux
        xc = tp.copy_to_model(x)
        logits = self._router_logits(xc, w)
        if noise is not None:
            logits = logits + noise
        dispatch, combine, aux = self._route(logits)
        mine = slice(r * held, (r + 1) * held)
        dispatch = dispatch[:, :, mine].to(x.dtype)
        combine = combine[:, :, mine].to(x.dtype)
        expert_out = self._experts(torch.einsum("btec,btd->ebcd", dispatch, xc))
        out = torch.einsum("btec,ebcd->btd", combine, expert_out)
        return tp.reduce_from_model(out), _ScaleGrad.apply(aux, 1.0 / m)

    def forward(self, x: torch.Tensor, *, rng=None, train: bool = False, **_
                ) -> torch.Tensor:
        return self.forward_with_aux(x, rng=rng, train=train)[0]

    def routing_stats(self, x: torch.Tensor) -> dict:
        """Router telemetry on ``x`` [B, T, D]: the fraction of (token,
        choice) routes the capacity drops (the residual path carries
        them), the aux loss and the capacity per expert, over the whole
        batch (an expert block routes with its whole router, so a rank
        reports the batch's drops at any model size). ``dispatch`` sums
        to the kept routes; everything is computed on the device and
        read back once, here."""
        B, T, _ = x.shape
        dispatch, _, aux = self._route(self._router_logits(x))
        kept, aux = torch.stack([dispatch.sum(), aux]).tolist()
        return {
            "drop_fraction": 1.0 - kept / (B * T * self.top_k),
            "aux_loss": aux,
            "capacity_per_expert": self.capacity(T),
        }
