"""Single-device inference engine (port of
``tensorlink_tpu/parallel/inference.py``): ``GenerationConfig``, the
sampling math, and ``InferenceEngine``, which holds a model on one
device under the serving dtype policy and sizes its KV cache.

Greedy sampling is ``argmax`` over f32 logits (ties go to the first
index). Sampling with a temperature cannot reproduce JAX's threefry
draws; it keeps their property instead: a token depends only on (request
seed, logical position), drawn from a ``torch.Generator`` seeded from
both (``position_generator``), never on the slot or the co-tenants.

Mesh/tensor parallelism, weight-only int8, the rolling cache, the
sequence-sharded cache and the static-batch ``generate`` wait for later
slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.convert import apply_dtype_policy

DECODE_BLOCK = 256  # cache capacity rounds up to a multiple of this


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => full softmax
    top_p: float = 1.0  # nucleus sampling; 1.0 => off
    eos_token_id: int | None = None


def _filter_logits(logits, temperature, top_k, top_p=1.0):
    """The temperature/top-k/top-p transform ``sample_logits`` draws
    from, as (unnormalized, possibly -inf-masked) f32 logits.
    ``temperature`` must be > 0 here."""
    logits = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        # keep the smallest prefix of descending-prob tokens whose
        # EXCLUSIVE cumulative mass is < top_p (the first always survives)
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thr = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= thr, logits, neg_inf)
    return logits


_M64 = (1 << 64) - 1


def position_generator(seed: int, position: int,
                       device: torch.device) -> torch.Generator:
    """The generator for the token at logical ``position`` of a request
    with ``seed``: a function of the two alone. The pair is mixed with
    splitmix64 so every bit of the generator's seed depends on both
    (the CPU generator reads only the low 32 bits of its seed)."""
    z = ((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    g = torch.Generator(device=device)
    g.manual_seed((z ^ (z >> 31)) >> 1)
    return g


def sample_logits(logits, temperature, top_k=0, top_p=1.0, generator=None):
    """[..., V] logits -> token ids. Greedy at temperature 0; otherwise a
    Gumbel-max draw from the filtered distribution, with the uniforms
    taken from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    f = _filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(f.shape, generator=generator, device=f.device)
    return torch.argmax(f - torch.log(-torch.log(u)), dim=-1)


class InferenceEngine:
    """A decoder model and its params on one device, ready to serve.

    ``model`` follows the decoder contract of ``models/llama.py``:
    ``model(ids, caches=..., positions=..., mask=...)`` returns
    ``(logits, new_caches)`` when caches are given, and its
    ``blocks.blocks()`` expose ``attn.init_paged_cache``. ``params``
    (a state dict, e.g. from ``convert.params_from_jax``) replaces the
    model's own weights when given. >=2-D floating params are cast to
    ``param_dtype``; 1-D params (norm scales, biases) stay f32.
    """

    def __init__(
        self,
        model: nn.Module,
        params: dict[str, torch.Tensor] | None = None,
        *,
        max_len: int = 2048,
        cache_dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        if params is not None:
            model.load_state_dict(params, strict=True, assign=True)
        apply_dtype_policy(model, param_dtype, self.device)
        model.eval()
        # the user-facing bound stays exactly max_len; only the cache
        # allocation rounds up to a DECODE_BLOCK multiple
        self.max_len = int(max_len)
        self.cache_len = -(-self.max_len // DECODE_BLOCK) * DECODE_BLOCK
        self.cache_dtype = cache_dtype
        self.param_dtype = param_dtype
