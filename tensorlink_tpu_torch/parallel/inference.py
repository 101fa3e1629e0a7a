"""Single-device inference engine (port of
``tensorlink_tpu/parallel/inference.py``): ``GenerationConfig``, the
sampling math, and ``InferenceEngine``, which holds a model on one
device under the serving dtype policy, sizes its KV cache, and runs the
static-batch ``generate``: one prefill of the left-padded prompts into a
contiguous cache (or a ring, ``rolling_cache=True``), then T == 1 decode
steps. Each decode step reads its index from a device counter and
writes the cache, the validity (or ring slot -> position) map and the
output in place, so on CUDA it runs as a replayed CUDA graph
(``runtime/graphs.py``), the counterpart of the reference's jitted
``lax.scan``; on the CPU, or with ``cuda_graphs=False``, the same step
runs eagerly.

Greedy sampling is ``argmax`` over f32 logits (ties go to the first
index). Sampling with a temperature cannot reproduce JAX's threefry
draws; it keeps the reference's property instead: a draw is a function
of (seed, position) alone (``sample_logits_at``: Gumbel noise from a
counter hash of seed, position and vocabulary index, in tensor ops, the
same bits on the CPU and on CUDA). The serving engines key it by
(request seed, logical position), never the slot or the co-tenants;
``generate`` by (its ``seed`` and the row, step). Speculative decoding's
draws (``spec_verify`` here, the draft's proposals in
``parallel/speculative.py``) add a salt to the key, so they never share
bits with that stream.

``quantize="int8"`` serves weight-only int8 (``ops/quant.py``): the
engine quantizes every ``Dense`` weight of the model it is given, in
place, or takes a model (or a state dict) that is already quantized.

Mesh/tensor parallelism and the sequence-sharded cache wait for later
slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.convert import apply_dtype_policy
from tensorlink_tpu_torch.nn.attention import DECODE_BLOCK
from tensorlink_tpu_torch.nn.layers import Dense
from tensorlink_tpu_torch.ops.quant import is_quantized, quantize_params_int8
from tensorlink_tpu_torch.runtime.graphs import GraphCache

# generate checks whether every row has ended (a host read) once every
# this many decode steps
EOS_CHECK_STEPS = 8


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
    neg_inf = float("-inf")  # a scalar: no host-to-device copy
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


_M32 = 0xFFFFFFFF


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    # >> is arithmetic on int64; the mask makes it logical
    return (x >> n) & (_M32 >> n)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for x in [0, 2**32) held in int64: c in two 16-bit
    halves, so no product reaches 2**63 (no signed overflow anywhere)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer finalizer (lowbias32's constants) on
    int64 lanes holding values in [0, 2**32)."""
    x = x ^ _shr(x, 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ _shr(x, 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ _shr(x, 16)


def _salt_word(salt: int) -> int:
    """A stream salt spread over 32 bits (golden-ratio multiply)."""
    return (int(salt) * 0x9E3779B9 + 0x7F4A7C15) & _M32


def counter_bits(seed: torch.Tensor, position: torch.Tensor, vocab: int,
                 salt: int = 0) -> torch.Tensor:
    """[S] seeds, [S] positions (int64) -> [S, vocab] int64 hash bits in
    [0, 2**32): a function of (the seed's low 32 bits, the position's,
    ``salt``, the vocabulary index) alone, the same on every device.
    Salt 0 is the sampling stream; a nonzero salt is another stream."""
    row = _mix32(_mix32(seed.long() & _M32) ^ (position.long() & _M32))
    if salt:
        row = _mix32(row ^ _salt_word(salt))
    col = _mix32(torch.arange(vocab, device=row.device, dtype=torch.int64)
                 ^ 0x9E3779B9)
    return _mix32(row[:, None] ^ col[None, :])


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """Hash bits -> f32 uniforms in (0, 1): the top 23 bits, centred
    (k + 0.5 is exact in f32 for k < 2**23, so u is never 0 or 1)."""
    return (_shr(bits, 9).float() + 0.5) * (1.0 / (1 << 23))


def _gumbel_argmax(logp: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """A draw from softmax(``logp``) by Gumbel-max over hash bits."""
    return torch.argmax(logp - torch.log(-torch.log(_uniform(bits))), dim=-1)


def sample_logits_at(logits, seed, position, temperature, top_k=0, top_p=1.0,
                     salt: int = 0):
    """[S, V] logits -> [S] token ids. Greedy (``argmax``) at temperature
    0; otherwise a Gumbel-max draw from the filtered distribution whose
    uniforms come from ``counter_bits(seed, position, salt=salt)``: row
    s's draw depends on (seed[s], position[s], salt) and its logits only.
    No host read, no generator: capturable."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    f = _filter_logits(logits, temperature, top_k, top_p)
    return _gumbel_argmax(f, counter_bits(seed, position, f.shape[-1], salt))


def spec_verify(tgt_logits, proposals, key, temperature, top_k=0, top_p=1.0,
                draft_logits=None, k_live=None):
    """Speculative accept/reject for every row at once: K drafted tokens
    against the K+1 target positions of one verify-K weight pass.

    ``tgt_logits`` [S, K+1, V]: the target's logits at the fed tokens
    ``[tok, d_1, .., d_K]`` (position i scores the token after fed token
    i). ``proposals`` [S, K]: ``d_1..d_K``. ``key``: ``(seed [S],
    position [S], salt)``, the row's counter-hash key
    (``SpeculativeDecoder.verify_key``). ``draft_logits`` [S, K, V] or
    None: the draft distribution each proposal was drawn from; None is a
    deterministic (delta) proposer, the n-gram draft. ``k_live`` [S] or
    None (= K): how many leading proposals each row really drew;
    acceptance stops there and the token at position ``k_live`` is drawn
    from the target itself, not from the rejection residual.

    Returns ``(n_emit [S], emitted [S, K+1])``: the first ``n_emit``
    entries extend each row (``n_emit`` >= 1). Greedy: exact argmax match,
    so the emitted tokens are the target's own greedy stream at any
    ``k_live``. Temperature > 0: standard rejection sampling (accept d_i
    with probability min(1, p/q), else draw from max(p - q, 0)
    renormalized), whose output distribution is the filtered target's.
    The acceptance uniforms and the correction's Gumbel noise are
    disjoint columns of one ``counter_bits`` row keyed by (seed, position,
    salt), so a row's draws depend on its request alone. Tensor ops over
    all rows, no host read."""
    S, K = proposals.shape
    dev = proposals.device
    props = proposals.long()
    kcap = (torch.full((S,), K, dtype=torch.long, device=dev) if k_live is None
            else k_live.long())
    if temperature == 0.0:
        t = torch.argmax(tgt_logits.float(), dim=-1)  # [S, K+1]
        match = (props == t[:, :K]).long()
        n_acc = torch.minimum(torch.cumprod(match, dim=1).sum(dim=1), kcap)
        return n_acc + 1, t
    lt = torch.log_softmax(
        _filter_logits(tgt_logits, temperature, top_k, top_p), dim=-1)
    V = lt.shape[-1]
    lt_at = lt[:, :K].gather(2, props[..., None])[..., 0]  # [S, K]
    if draft_logits is None:
        ld_at = torch.zeros_like(lt_at)  # delta: log q(d_i) = 0
        # one-hot by scatter: F.one_hot reads the ids back to check them
        q = torch.zeros_like(lt_at[..., None].expand(S, K, V)).scatter(
            2, props[..., None], 1.0)
    else:
        ld = torch.log_softmax(
            _filter_logits(draft_logits, temperature, top_k, top_p), dim=-1)
        ld_at = ld.gather(2, props[..., None])[..., 0]
        q = torch.exp(ld)
    seed, position, salt = key
    bits = counter_bits(seed, position, V + K, salt)  # [S, V + K]
    u = _uniform(bits[:, V:])
    # a proposal the filtered target excludes has lt_at = -inf: accept
    # probability 0
    accept = u < torch.exp(torch.clamp(lt_at - ld_at, max=0.0))
    n_acc = torch.minimum(torch.cumprod(accept.long(), dim=1).sum(dim=1), kcap)
    p_t = torch.exp(lt)  # [S, K+1, V]
    resid = torch.clamp(p_t[:, :K] - q, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    # degenerate residual (the draft covers the target here): the target
    resid = torch.where(rs > 0, resid / torch.where(rs > 0, rs, 1.0), p_t[:, :K])
    cand = torch.cat([resid, p_t[:, K:]], dim=1)
    cand = torch.where(
        (torch.arange(K + 1, device=dev)[None, :] < kcap[:, None])[..., None],
        cand, p_t)
    row = cand.gather(1, n_acc[:, None, None].expand(S, 1, V))[:, 0]
    corr = _gumbel_argmax(torch.log(row + 1e-38), bits[:, :V])
    emitted = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    emitted = emitted.scatter(1, n_acc[:, None], corr[:, None])
    return n_acc + 1, emitted


def _quantized_layout(model: nn.Module, state: dict) -> None:
    """Give every ``Dense`` whose weight ``state`` holds quantized
    (``….w.q`` / ``….w.s``) the quantized form, so the state dict loads
    strictly."""
    for name, mod in list(model.named_modules()):
        qn = f"{name}.w.q" if name else "w.q"
        if isinstance(mod, Dense) and qn in state:
            mod.set_quantized(state[qn], state[qn[:-1] + "s"])


def weight_pass_bytes(model: nn.Module) -> int:
    """Bytes one weight pass of a decoder reads: every ``Dense`` weight
    as stored (int8 ``q`` plus f32 scales ``s``, or the float matrix) and
    the embedding table of an LM head tied to it
    (``model.tied_head_table()``). Biases, norms and the embedding rows a
    step gathers are not counted (``program_cost``'s convention)."""
    total = 0
    for mod in model.modules():
        if isinstance(mod, Dense):
            w = mod.w
            total += (w.q.numel() * w.q.element_size() + w.s.numel() * w.s.element_size()
                      if mod.quantized else w.numel() * w.element_size())
    table = model.tied_head_table()
    if table is not None:
        total += table.numel() * table.element_size()
    return total


def generate_row_seeds(seed: int, batch: int, device) -> torch.Tensor:
    """``generate``'s per-row sampling key: (its seed, the row) mixed
    into one 32-bit seed a row; the step is the position."""
    rows = torch.arange(batch, device=device, dtype=torch.int64)
    return _mix32(_mix32(torch.full_like(rows, int(seed) & _M32)) ^ rows)


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

    ``cuda_graphs`` (CUDA only): ``generate``'s decode steps run as
    replays of captured graphs (True) or eagerly (False); the same step
    either way. The engine keeps the device state of the newest
    ``generate`` shape — (batch, prompt length, generation config) — with
    its graphs, one a set of blocks the step reads, and frees it when a
    call of another shape arrives: a graph pins the cache it was captured
    on, so only the newest shape's cache stays allocated between calls.
    ``step_hook``, when set, is called with the step index before each
    decode step (for measurement; a replay runs no module hooks).

    ``quantize="int8"``: weight-only int8. The model handed in is
    quantized in place (its float ``Dense`` weights are replaced), unless
    it, or ``params``, is quantized already. ``weight_bytes`` is what
    one weight pass reads (int8 weights at one byte plus their f32
    scales), the figure ``runtime/profiling.py`` ``program_cost`` bills.
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
        cuda_graphs: bool = True,
        quantize: str | None = None,
    ):
        if quantize is not None and quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = resolve_device(device)
        self.cuda_graphs = bool(cuda_graphs)
        self.step_hook = None
        self._gen_state: dict | None = None
        self.model = model
        if params is not None:
            if is_quantized(params):
                _quantized_layout(model, params)
            model.load_state_dict(params, strict=True, assign=True)
        self.quantize = quantize
        if quantize == "int8" and not is_quantized(model):
            quantize_params_int8(model)
        apply_dtype_policy(model, param_dtype, self.device)
        model.eval()
        self.weight_bytes = weight_pass_bytes(model)
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
        no host read, unless ``eos_token_id`` is set, when every
        ``EOS_CHECK_STEPS`` steps it reads whether every row has ended so
        the loop can stop early."""
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
        draws from the counter sampler keyed by (``seed``, row, step)."""
        return self.generate_async(ids, gen, pad_mask=pad_mask, seed=seed).cpu().numpy()

    def graph_stats(self) -> dict:
        """The newest ``generate`` shape's graph counters (zeros before the
        first call): graphs held, captured, capture s, replays, pool
        bytes."""
        st = self._gen_state
        return (st["graphs"] if st else GraphCache(self.device)).stats()

    def _state(self, key: tuple, B: int, L: int, rolling: bool) -> dict:
        """The device state of a ``generate`` shape: caches sharing one
        write index, the step counter, fed token, per-row valid count and
        sampling seed, the ended flags, the validity (or ring slot ->
        position) map and the output; kept for the newest shape only."""
        st = self._gen_state
        if st is not None and st["key"] == key:
            return st
        self._gen_state = None  # drop the old shape's cache and graphs
        dev = self.device
        index = torch.zeros((), dtype=torch.int32, device=dev)
        caches = self.model.init_caches(B, L, dtype=self.cache_dtype,
                                        rolling=rolling)
        for c in caches:
            c["attn"]["index"] = index
        max_new = key[-1].max_new_tokens
        st = self._gen_state = {
            "key": key, "caches": caches, "index": index,
            "step": torch.zeros((), dtype=torch.int64, device=dev),
            "tok": torch.zeros((B,), dtype=torch.int64, device=dev),
            "n_valid": torch.zeros((B,), dtype=torch.int64, device=dev),
            "seed": torch.zeros((B,), dtype=torch.int64, device=dev),
            "done": torch.zeros((B,), dtype=torch.bool, device=dev),
            "valid": torch.zeros((B, L), device=dev,
                                 dtype=torch.int64 if rolling else torch.bool),
            "out": torch.zeros((B, max_new), dtype=torch.int64, device=dev),
            "graphs": GraphCache(dev, enabled=self.cuda_graphs),
        }
        return st

    def _run(self, ids, pad, gen: GenerationConfig, seed: int) -> torch.Tensor:
        model, dev = self.model, self.device
        B, T0 = ids.shape
        max_new, eos, W = gen.max_new_tokens, gen.eos_token_id, self.window
        L, rolling = self.cache_plan(T0, max_new)
        st = self._state((B, T0, L, rolling, gen), B, L, rolling)
        caches = st["caches"]
        # logical positions: pads get 0, the first real token 0
        pos = (pad.cumsum(dim=-1) - 1).clamp_min(0)
        # prefill over the T0 fresh keys: a key must be a real prompt token
        # at or before the query (left padding: slot order is logical
        # order); a ring's module ignores positions, so the band rides here
        qslot = torch.arange(T0, device=dev)[None, None, :, None]
        kslot = torch.arange(T0, device=dev)[None, None, None, :]
        mask = (kslot <= qslot) & pad.bool()[:, None, None, :]
        if rolling:
            mask = mask & (pos[:, None, None, :] > pos[:, None, :, None] - W)
        st["index"].zero_()
        for c in caches:
            c["attn"].pop("frontier", None)
        hidden, _ = model(ids, caches=caches, positions=pos, mask=mask,
                          logits=False)
        st["index"].fill_(T0)
        st["seed"].copy_(generate_row_seeds(seed, B, dev))
        tok = sample_logits_at(model.head(hidden[:, -1]), st["seed"],
                               torch.zeros_like(st["seed"]), gen.temperature,
                               gen.top_k, gen.top_p)
        st["tok"].copy_(tok)
        st["out"][:, 0] = tok
        if eos is not None:
            st["done"].copy_(tok == eos)
        st["n_valid"].copy_(pad.sum(dim=-1))
        st["step"].fill_(1)
        # slot bookkeeping: valid slots of the monotone cache, or each ring
        # slot's logical position (-1: never written or pad), the only
        # masking authority once writes wrap
        valid = st["valid"]
        if rolling:
            valid.fill_(-1)
            valid[:, :T0] = torch.where(pad.bool(), pos, -1)
        else:
            valid.zero_()
            valid[:, :T0] = pad.bool()
        attns = [blk.attn for blk in model.blocks.blocks()]
        for i in range(1, max_new):
            if self.step_hook is not None:
                self.step_hook(i)
            # the carried token was sampled at step i - 1: it goes to slot
            # T0 + i - 1 (mod L on a ring); the step's host bounds matter
            # only through the blocks they select, the graph's key
            frontier = (T0 + i - 1, T0 + i - 1)
            key = tuple(a.decode_blocks(L, frontier, rolling=rolling)
                        for a in attns)
            st["graphs"].run(key, lambda: self._decode_step(st, gen, frontier))
            if (eos is not None and i % EOS_CHECK_STEPS == 0
                    and i + 1 < max_new and bool(st["done"].all())):
                # every row has ended: the rest is eos (the reference
                # never stops early; its tokens there are eos too)
                st["out"][:, i + 1:] = eos
                break
        return st["out"].clone()

    def _decode_step(self, st: dict, gen: GenerationConfig, frontier) -> None:
        """One T == 1 decode step of ``generate``, in place on ``st``: the
        step index ``i`` is a device counter, so the same work serves every
        step whose frontier selects the same blocks."""
        B, L = st["valid"].shape
        T0 = st["key"][1]
        eos = gen.eos_token_id
        i = st["step"]
        # the token fed now sits at logical position n_valid + i - 1
        positions = (st["n_valid"] + i - 1)[:, None]
        wslot = (i + (T0 - 1)).view(1)
        valid = st["valid"]
        if "rolling" in st["caches"][0]["attn"]:
            valid.scatter_(1, (wslot % L).expand(B)[:, None], positions)
            mask = (valid >= 0) & (valid > positions - self.window)
        else:
            valid.index_fill_(1, wslot, True)
            mask = valid
        for c in st["caches"]:
            c["attn"]["frontier"] = frontier
        logits, _ = self.model(st["tok"][:, None], caches=st["caches"],
                               positions=positions, mask=mask[:, None, None, :])
        st["index"].add_(1)
        tok = sample_logits_at(logits[:, -1], st["seed"], i.expand(B),
                               gen.temperature, gen.top_k, gen.top_p)
        if eos is not None:
            tok = torch.where(st["done"], eos, tok)
            st["done"].logical_or_(tok == eos)
        st["out"].index_copy_(1, i.view(1), tok[:, None])
        st["tok"].copy_(tok)
        i.add_(1)
