"""Single-device inference engine (port of
``tensorlink_tpu/parallel/inference.py``): ``GenerationConfig``, the
sampling math, and ``InferenceEngine``, which holds a model on one
device under the serving dtype policy, sizes its KV cache, and runs the
static-batch ``generate``: one prefill of the left-padded prompts into a
contiguous cache (or a ring, ``rolling_cache=True``), then T == 1 decode
steps in an eager loop standing in for the JAX package's ``lax.scan``.

Greedy sampling is ``argmax`` over f32 logits (ties go to the first
index). Sampling with a temperature cannot reproduce JAX's threefry
draws. The serving engines keep their property instead: a token depends
only on (request seed, logical position), drawn from a
``torch.Generator`` seeded from both (``position_generator``), never on
the slot or the co-tenants. ``generate`` draws every step of a call from
one generator seeded with its ``seed`` argument.

Mesh/tensor parallelism, weight-only int8 and the sequence-sharded cache
wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.convert import apply_dtype_policy
from tensorlink_tpu_torch.nn.attention import DECODE_BLOCK


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

    ``model`` follows the decoder contract of ``models/llama.py`` and
    ``models/gpt2.py``: ``model(ids, caches=..., positions=..., mask=...,
    logits=...)`` returns ``(out, new_caches)`` when caches are given,
    ``model.head`` turns final hidden states into logits,
    ``model.init_caches(batch, max_len, dtype, rolling)`` makes the
    contiguous caches, and its ``blocks.blocks()`` expose
    ``attn.init_paged_cache``. ``params`` (a state dict, e.g. from
    ``convert.params_from_jax``) replaces the model's own weights when
    given. >=2-D floating params are cast to ``param_dtype``; 1-D params
    (norm scales, biases) stay f32. ``rolling_cache=True`` serves a
    sliding-window model from a ring of prompt + window slots, however
    long the generation runs.
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
        rolling_cache: bool = False,
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
        # a windowless model needs every past token: a ring would silently
        # drop context, so the model must declare a window
        self.rolling = bool(rolling_cache)
        self.window = None
        if self.rolling:
            try:
                self.window = model.blocks.blocks()[0].attn.window
            except (AttributeError, IndexError):
                self.window = None
            if not self.window:
                raise ValueError(
                    "rolling_cache=True requires a sliding-window model "
                    "(e.g. LlamaConfig(attn_window=...)); this model "
                    "declares no attention window"
                )

    def cache_plan(self, T0: int, max_new: int) -> tuple[int, bool]:
        """-> (cache slots, ring?) of a ``generate`` call with prompts of
        T0 and ``max_new`` new tokens. The call can never hold more than
        T0 + max_new live slots, so the cache takes that bound (rounded up
        to a DECODE_BLOCK multiple) when it is below the engine's
        capacity. A ring of prompt + window slots that would be larger
        than that falls back to the monotone cache: it would never wrap,
        the outputs are the same and the memory smaller."""
        L = min(self.cache_len, -(-(T0 + max_new) // DECODE_BLOCK) * DECODE_BLOCK)
        rolling = self.rolling and T0 + self.window < L
        return (T0 + self.window if rolling else L), rolling

    def generate_async(self, ids, gen: GenerationConfig | None = None, *,
                       pad_mask=None, seed: int = 0) -> torch.Tensor:
        """Like ``generate`` but returns the device tensor [B, max_new]:
        no host read, unless ``eos_token_id`` is set, when each step reads
        whether every row has ended so the loop can stop early."""
        gen = gen or GenerationConfig()
        if not 0.0 < gen.top_p <= 1.0:
            # top_p 0 would mask every token; "off" is 1.0
            raise ValueError(
                f"top_p must be in (0, 1] (1.0 = off), got {gen.top_p}"
            )
        ids = torch.as_tensor(np.asarray(ids), device=self.device).long()
        B, T0 = ids.shape
        if T0 + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {T0} + new {gen.max_new_tokens} exceeds max_len "
                f"{self.max_len}"
            )
        if pad_mask is None:
            pad = torch.ones_like(ids)
        else:
            pad = torch.as_tensor(np.asarray(pad_mask), device=self.device).long()
        with torch.no_grad():
            return self._run(ids, pad, gen, seed)

    def generate(self, ids, gen: GenerationConfig | None = None, *,
                 pad_mask=None, seed: int = 0) -> np.ndarray:
        """ids: [B, T0] left-padded prompts (``pad_mask`` 1 on real
        tokens); returns [B, max_new_tokens] int64, filled with
        ``eos_token_id`` after a row ends. Sampling at a temperature
        draws from a generator seeded with ``seed``."""
        return self.generate_async(ids, gen, pad_mask=pad_mask, seed=seed).cpu().numpy()

    def _run(self, ids, pad, gen: GenerationConfig, seed: int) -> torch.Tensor:
        model, dev = self.model, self.device
        B, T0 = ids.shape
        max_new, eos, W = gen.max_new_tokens, gen.eos_token_id, self.window
        L, rolling = self.cache_plan(T0, max_new)
        g = None
        if gen.temperature != 0.0:
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))

        def sample(logits):
            return sample_logits(logits, gen.temperature, gen.top_k,
                                 gen.top_p, generator=g)

        # logical positions: pads get 0, the first real token 0
        pos = (pad.cumsum(dim=-1) - 1).clamp_min(0)
        n_valid = pad.sum(dim=-1)
        caches = model.init_caches(B, L, dtype=self.cache_dtype, rolling=rolling)
        # prefill over the T0 fresh keys: a key must be a real prompt token
        # at or before the query (left padding: slot order is logical
        # order); a ring's module ignores positions, so the band rides here
        qslot = torch.arange(T0, device=dev)[None, None, :, None]
        kslot = torch.arange(T0, device=dev)[None, None, None, :]
        mask = (kslot <= qslot) & pad.bool()[:, None, None, :]
        if rolling:
            mask = mask & (pos[:, None, None, :] > pos[:, None, :, None] - W)
        hidden, caches = model(ids, caches=caches, positions=pos, mask=mask,
                               logits=False)
        tok = sample(model.head(hidden[:, -1]))
        out = torch.empty((B, max_new), dtype=torch.long, device=dev)
        out[:, 0] = tok
        done = tok == eos if eos is not None else None
        # slot bookkeeping: valid slots of the monotone cache, or each ring
        # slot's logical position (-1: never written or pad), the only
        # masking authority once writes wrap
        valid = torch.zeros((B, L), dtype=torch.bool, device=dev)
        valid[:, :T0] = pad.bool()
        if rolling:
            valid = torch.where(
                valid, torch.nn.functional.pad(pos, (0, L - T0)), -1
            )
        for i in range(1, max_new):
            # the carried token was sampled at step i - 1: it goes to slot
            # T0 + i - 1 (mod L on a ring) at logical position n_valid + i - 1
            positions = (n_valid + i - 1)[:, None]
            wslot = T0 + i - 1
            if rolling:
                valid[:, wslot % L] = positions[:, 0]
                mask = ((valid >= 0) & (valid > positions - W))[:, None, None, :]
            else:
                valid[:, wslot] = True
                mask = valid[:, None, None, :]
            for c in caches:
                c["attn"]["frontier"] = (wslot, wslot)
            logits, caches = model(tok[:, None], caches=caches,
                                   positions=positions, mask=mask)
            tok = sample(logits[:, -1])
            if eos is not None:
                tok = torch.where(done, eos, tok)
                done = done | (tok == eos)
            out[:, i] = tok
            if eos is not None and i + 1 < max_new and bool(done.all()):
                out[:, i + 1:] = eos
                break
        return out

