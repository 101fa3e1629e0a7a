"""Speculative decoding for the serving engines (port of
``tensorlink_tpu/parallel/speculative.py``).

Every emitted token of a plain decode step pays a full read of the
weights. A draft proposes K tokens ahead and the target verifies all K
(+1 bonus) positions in ONE weight pass (the T == K+1 form of the per-row
and paged cache paths in ``nn/attention.py``: per-query causality, so a
rejected suffix never influenced its accepted prefix and rollback is an
index reset).

Two drafting strategies share the same verify pass:

- **draft model** (``SpeculativeDecoder(draft=...)``): a second
  ``InferenceEngine`` runs K+1 single-token steps over its own per-slot
  contiguous cache, at the target view's width, with its frontier in
  lockstep with the target's (the extra step writes the k/v of the last
  proposal, so a fully accepted round leaves no hole);
- **n-gram / prompt lookup** (``draft=None``): proposals come from the
  request's own context, the most recent recurrence of the trailing
  n-gram, continued. A row with no match proposes its pending token
  (counted as a fallback).

The draft's K+1 steps always run, masked: the reference skips a step no
row needs under ``lax.cond``, which a captured CUDA graph cannot do
without reading the device. A row that does not need a step keeps
feeding its old token, and ``k_live`` masks its proposals out of
acceptance; the engines count the steps no row needed.

Greedy output is token-identical with speculation on or off; at
temperature > 0 the rejection test (``parallel/inference.py``
``spec_verify``) keeps the output distribution the target's. The draws
come from the counter hash keyed by (request seed, logical position,
salt) with the reference's salts, so they never share bits with the
sampling stream.

**Measured draft pairing** (``autopair_draft``): a short calibration
burst decides how an engine should speculate, from tokens per second on
this card: non-speculative, each candidate draft (by default the
target's weight-only int8 sibling, ``default_draft_candidates``), then
n-gram. The engines' self-healing (``SpecConfig.self_heal_accept``,
``parallel/serving.py``) downgrades a mode that measures as a loss.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

from tensorlink_tpu_torch.ops.quant import quantize_params_int8
from tensorlink_tpu_torch.parallel.inference import InferenceEngine, sample_logits_at

__all__ = [
    "AdaptiveKController",
    "POSITION_COST",
    "SALT_DRAFT",
    "SALT_VERIFY",
    "SpecConfig",
    "SpeculativeDecoder",
    "autopair_draft",
    "default_draft_candidates",
    "ngram_propose",
]

# the clock autopair_draft measures with (tests pin it)
_clock = time.perf_counter

# counter-hash stream salts: the draft's proposals and the verifier's
# accept/reject draws must not share bits with the engine's per-position
# sampling stream (the reference's fold_in salts)
SALT_DRAFT = 0x5D
SALT_VERIFY = 0x5E

# fixed per-drafted-position cost the controller charges beside the draft
# steps: each drafted position still pays verify compute and block
# reservations, so a free proposer (n-gram) does not pin K at k_max at
# zero acceptance
POSITION_COST = 0.02


@dataclass(frozen=True)
class SpecConfig:
    """``k``: drafted tokens per verify pass (each pass emits 1..k+1
    tokens); under the adaptive controller the proposal width,
    ``k_max``. ``rounds``: (draft + verify) rounds a dispatched chunk
    runs; one dispatch advances a live row by up to ``rounds * (k + 1)``
    tokens. ``ngram``: match length of prompt-lookup drafting.

    ``adaptive``: per-request masked K, chosen by
    :class:`AdaptiveKController` from that request's measured acceptance
    and fed to the one spec chunk as a device operand. ``k_min``: the
    controller's floor. ``entropy_exit``: draft-model early exit, a row
    stops proposing at the first step whose draft entropy (nats) exceeds
    it (None = off). ``ewma``: smoothing of the acceptance estimate.
    ``draft_cost``: one draft step's cost relative to a target weight
    pass. ``self_heal_accept``: acceptance floor below which the ENGINE
    downgrades its speculation mode (draft -> n-gram -> off) at its next
    idle point (None = never)."""

    k: int = 4
    rounds: int = 2
    ngram: int = 2
    adaptive: bool = False
    k_min: int = 1
    entropy_exit: float | None = None
    self_heal_accept: float | None = None
    ewma: float = 0.25
    draft_cost: float = 0.5

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.rounds < 1:
            raise ValueError(f"spec rounds must be >= 1, got {self.rounds}")
        if self.ngram < 2:
            raise ValueError(
                f"ngram must be >= 2 (1 would match every token), "
                f"got {self.ngram}"
            )
        if not 1 <= self.k_min <= self.k:
            raise ValueError(f"k_min must be in [1, k={self.k}], got {self.k_min}")
        if self.entropy_exit is not None and self.entropy_exit <= 0:
            raise ValueError(
                f"entropy_exit must be > 0 nats, got {self.entropy_exit}"
            )
        if self.self_heal_accept is not None and not (
            0.0 < self.self_heal_accept < 1.0
        ):
            raise ValueError(
                f"self_heal_accept must be in (0, 1), "
                f"got {self.self_heal_accept}"
            )
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {self.ewma}")
        if self.draft_cost < 0.0:
            raise ValueError(f"draft_cost must be >= 0, got {self.draft_cost}")

    @classmethod
    def auto(cls, k: int = 4, **kw) -> "SpecConfig":
        """The self-tuning preset: adaptive K, draft early exit at 2.5
        nats and self-healing below 0.3 acceptance, as in the reference."""
        kw.setdefault("adaptive", True)
        kw.setdefault("entropy_exit", 2.5)
        kw.setdefault("self_heal_accept", 0.3)
        return cls(k=k, **kw)


class AdaptiveKController:
    """Per-request masked-K controller: turns measured acceptance back
    into the next dispatch's per-row effective K.

    Per-token acceptance ``a`` makes a K-proposal round emit ``e(a, k) =
    (1 - a^(k+1)) / (1 - a)`` expected tokens for one target pass plus
    ``k + 1`` draft steps at ``draft_cost`` each (plus POSITION_COST per
    drafted position). The controller picks the ``k`` in ``[k_min,
    k_max]`` that maximizes tokens per cost, per request, from an EWMA of
    that request's acceptance (new requests start from the cross-request
    prior, which ``prior=`` — a record's ``k_prior``, from the autotune
    store — warm-starts across restarts)."""

    def __init__(self, cfg: SpecConfig, *, draft_cost: float | None = None,
                 prior: dict | None = None):
        self.cfg = cfg
        self.draft_cost = float(draft_cost) if draft_cost is not None else cfg.draft_cost
        self._acc: dict[int, float] = {}  # rid -> acceptance EWMA
        self.prior_acceptance = 0.6
        if prior:
            a = prior.get("acceptance")
            if isinstance(a, (int, float)) and 0.0 <= a <= 1.0:
                self.prior_acceptance = float(a)
            c = prior.get("draft_cost")
            if draft_cost is None and isinstance(c, (int, float)) and c >= 0:
                self.draft_cost = float(c)
        self._k_cache: dict[int, int] = {}  # milli-acceptance -> k
        self.k_dispatched = 0  # sum of k over dispatched (row, chunk)s
        self.rounds_dispatched = 0

    def k_for_acceptance(self, a: float) -> int:
        key = int(round(min(max(a, 0.0), 0.999) * 1000))
        k = self._k_cache.get(key)
        if k is None:
            k = self._argmax_k(key / 1000.0)
            self._k_cache[key] = k
        return k

    def _argmax_k(self, a: float) -> int:
        best_k, best = self.cfg.k_min, -1.0
        for k in range(self.cfg.k_min, self.cfg.k + 1):
            e = float(k + 1) if a >= 0.999 else (1.0 - a ** (k + 1)) / (1.0 - a)
            cost = 1.0 + self.draft_cost * (k + 1) + POSITION_COST * k
            v = e / cost
            if v > best + 1e-9:  # ties go to the smaller k
                best_k, best = k, v
        return best_k

    def k_for(self, rid: int) -> int:
        return self.k_for_acceptance(self._acc.get(rid, self.prior_acceptance))

    def observe(self, rid: int, proposed: int, accepted: int) -> None:
        """One drained verify round's outcome for one request;
        ``proposed`` 0 (a fully exited round) carries no signal."""
        if proposed <= 0:
            return
        lam = self.cfg.ewma
        cur = self._acc.get(rid, self.prior_acceptance)
        self._acc[rid] = (1.0 - lam) * cur + lam * (accepted / proposed)

    def forget(self, rid: int) -> None:
        """Fold a finished request's estimate into the prior and drop its
        state."""
        a = self._acc.pop(rid, None)
        if a is not None:
            lam = self.cfg.ewma
            self.prior_acceptance = (1.0 - lam) * self.prior_acceptance + lam * a

    def note_dispatch(self, ks) -> None:
        for k in ks:
            self.k_dispatched += int(k)
            self.rounds_dispatched += 1

    def k_mean(self) -> float:
        if not self.rounds_dispatched:
            return float(self.k_for_acceptance(self.prior_acceptance))
        return self.k_dispatched / self.rounds_dispatched

    def prior(self) -> dict:
        """What a restarted engine would start its controller from."""
        return {
            "k": self.k_for_acceptance(self.prior_acceptance),
            "acceptance": round(self.prior_acceptance, 4),
            "draft_cost": round(self.draft_cost, 4),
        }


def ngram_propose(ids, valid, index, tok, k: int, n: int):
    """Prompt-lookup drafting on the device: for each row, the most recent
    slot where the trailing n-gram (the last ``n - 1`` committed tokens,
    then the pending token ``tok``) already occurred, and the ``k``
    tokens that followed it.

    ``ids`` [S, L] slot-aligned token ids (pads hold garbage, excluded by
    ``valid``); ``valid`` [S, L] real-token slots; ``index`` [S] write
    frontier (the pending token's slot); ``tok`` [S].

    Returns ``(proposals [S, k] int64, found [S] bool)``. A row with no
    match proposes its pending token repeated (a fallback: verification
    makes any proposal safe). No host read."""
    S, L = ids.shape
    dev = ids.device
    pos = torch.arange(L, device=dev)
    index = index.long()
    ids = ids.long()
    tok = tok.long()
    # the match window [p, p + n - 1] must sit in committed history (a
    # row's valid region is one contiguous [pad_end, index) span)
    ok = valid & ((pos + n - 1)[None, :] < index[:, None])
    ok = ok & (index[:, None] >= n)
    # the trailing gram itself must be committed tokens, not pads
    hist_ok = torch.ones((S,), dtype=torch.bool, device=dev)
    for j in range(n - 1):
        slot_j = (index[:, None] - (n - 1) + j).clamp(0, L - 1)
        gram_j = ids.gather(1, slot_j)
        hist_ok = hist_ok & valid.gather(1, slot_j)[:, 0]
        ok = ok & (ids[:, (pos + j).clamp(max=L - 1)] == gram_j)
    ok = ok & hist_ok[:, None]
    ok = ok & (ids[:, (pos + n - 1).clamp(max=L - 1)] == tok[:, None])
    best = torch.where(ok, pos[None, :], -1).amax(dim=1)
    found = best >= 0
    p_idx = best[:, None] + n + torch.arange(k, device=dev)[None, :]
    props = ids.gather(1, p_idx.clamp(0, L - 1))
    real = found[:, None] & (p_idx < index[:, None])
    return torch.where(real, props, tok[:, None]), found


def _vocab_of(engine) -> int | None:
    return getattr(getattr(engine.model, "cfg", None), "vocab_size", None)


class SpeculativeDecoder:
    """Drafting side of speculative serving, shared by both engines: the
    draft engine (if any), its per-slot cache and the draft round the
    engines run inside their spec chunk. The verify side is the target
    model plus ``inference.spec_verify``."""

    def __init__(self, engine, draft, cfg: SpecConfig):
        self.engine = engine
        self.draft = draft
        self.cfg = cfg
        self.mode = "draft" if draft is not None else "ngram"
        if draft is not None:
            if draft.rolling or getattr(draft, "kv_seq_shard", False):
                raise NotImplementedError(
                    "draft engines must use the plain monotone cache "
                    "(no rolling_cache / kv_seq_shard)"
                )
            if draft.model_size not in (1, engine.model_size):
                raise ValueError(
                    f"draft engine on model axis {draft.model_size} beside "
                    f"a target on {engine.model_size}: build the draft on "
                    "the target's mesh and axes (or whole, on model 1)"
                )
            tv, dv = _vocab_of(engine), _vocab_of(draft)
            if tv is not None and dv is not None and tv != dv:
                raise ValueError(
                    f"draft vocab {dv} != target vocab {tv}: drafted token "
                    "ids would be meaningless to the target"
                )

    def init_draft_caches(self, slots: int, length: int) -> list[tuple]:
        """The per-slot draft cache, one (k, v) [slots, length, Hkv, D]
        pair a draft layer: the target view's slot layout and width, so
        the two frontiers stay in lockstep and one write index serves
        both."""
        caches = self.draft.model.init_caches(slots, length,
                                              dtype=self.draft.cache_dtype)
        return [(c["attn"]["k"], c["attn"]["v"]) for c in caches]

    def verify_key(self, seed, n_valid):
        """A row's rejection-sampling key: (request seed, logical
        position, SALT_VERIFY), independent of the slot and co-tenants."""
        return seed, n_valid, SALT_VERIFY

    def build_draft_fn(self, gen):
        """The draft round: K+1 single-token steps of the draft model that
        feed ``tok`` and then its own proposals through the per-slot
        cache, in place. The last step writes the k/v of proposal d_K and
        drops its own proposal, so a fully accepted round leaves no hole.

        ``run(kv, tok, n_valid, seed, f0, mask, k_eff, live, frontier,
        dlg)`` -> ``(proposals [S, K], k_live [S], idle_steps)``. Step t
        writes at ``f0 + t``. Row s needs step t while ``t <= k_eff[s]``,
        it is live and its draft entropy has stayed under
        ``cfg.entropy_exit``; every step runs for every row (a captured
        graph cannot skip one), and a row that does not need it keeps
        feeding its old token. ``k_live <= k_eff`` is the number of
        proposals a row stands behind. ``idle_steps`` (a device scalar)
        counts the steps no row needed, which the reference skips.
        ``dlg`` [S, K, V] (f32, or None when nothing reads it) takes the
        draft logits of each proposal."""
        model = self.draft.model
        K = self.cfg.k
        thresh = self.cfg.entropy_exit
        temperature = float(gen.temperature)
        top_k, top_p = int(gen.top_k), float(gen.top_p)

        def run(kv, tok, n_valid, seed, f0, mask, k_eff, live, frontier, dlg):
            alive = torch.ones_like(live)
            alive_t = []
            props = []
            idle = torch.zeros((), dtype=torch.long, device=tok.device)
            for t in range(K + 1):
                need = live & alive & (k_eff >= t)
                idx = f0 + t
                caches = [
                    {"attn": {"k": k, "v": v, "index": idx, "frontier": frontier}}
                    for k, v in kv
                ]
                lg, _ = model(tok[:, None], caches=caches,
                              positions=(n_valid + t)[:, None], mask=mask)
                lg = lg[:, -1].float()
                nxt = sample_logits_at(lg, seed, n_valid + t + 1, temperature,
                                       top_k, top_p, salt=SALT_DRAFT)
                nxt = torch.where(need, nxt, tok)
                if thresh is not None:
                    p = torch.softmax(lg, dim=-1)
                    ent = -(p * torch.log(p.clamp_min(1e-20))).sum(dim=-1)
                    alive = alive & need & (ent <= thresh)
                else:
                    alive = alive & need
                idle = idle + (~need.any()).long()
                if t < K:
                    props.append(nxt)
                    alive_t.append(alive)
                    if dlg is not None:
                        dlg[:, t].copy_(lg)
                tok = nxt
            # proposal d_{t+1} stands iff the row was still alive after
            # step t: every entropy check up to the one that drew it passed
            k_live = torch.minimum(torch.stack(alive_t).long().sum(dim=0),
                                   k_eff.long())
            return torch.stack(props, dim=1), k_live, idle

        return run


# --------------------------------------------------------- draft pairing
def default_draft_candidates(engine) -> list[tuple[str, object]]:
    """The free draft for any target: its own weight-only int8 sibling
    (half the weight bytes a draft step on a memory-bound decode, and
    int8 nearly always keeps the argmax). A thunk, not an engine: a
    candidate that is never measured never allocates.

    The sibling is a model of the target's class built on the meta
    device (no memory), into which ``quantize_params_int8`` quantizes
    the target's ``Dense`` weights one at a time and shares every other
    tensor with it (the embedding table, norms, biases). So no float
    copy of the model ever exists beside the target, and the target's
    own module is left as it was. On a mesh the sibling is built on the
    target's mesh and axes from the target's blocks (the reference's
    ``InferenceEngine(engine.mesh, ...)``)."""

    def int8_sibling():
        model = engine.model
        sib = type(model)(model.cfg, device="meta", seed=None)
        quantize_params_int8(sib, source=model, group=engine.model_group)
        return InferenceEngine(
            sib, max_len=engine.max_len, cache_dtype=engine.cache_dtype,
            param_dtype=engine.param_dtype, device=engine.device,
            cuda_graphs=engine.cuda_graphs, quantize="int8",
            mesh=engine.mesh, data_axis=engine.data_axis,
            model_axis=engine.model_axis,
        )

    return [("int8-sibling", int8_sibling)]


def _release(device) -> None:
    """Return what the dropped burst engines and candidates held."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def autopair_draft(
    engine,
    gen,
    *,
    candidates: list[tuple[str, object]] | None = None,
    cfg: SpecConfig | None = None,
    prompts=None,
    max_new: int = 16,
    slots: int = 2,
    recorder=None,
) -> dict:
    """Measured draft pairing: a short calibration burst decides how this
    engine should speculate, from wall-clock tokens per second.

    The burst prompts run through (a) a non-speculative scheduler (the
    baseline), (b) each vocabulary-compatible candidate draft in the
    order given (largest first: the first whose tokens/s beats the
    baseline wins) and (c) n-gram speculation. Verdict order: paying
    draft > paying n-gram > non-spec. Each burst first serves one request
    (which builds and captures its graphs), then times the prompts.

    Candidates are built lazily, one at a time, and each loser — its
    burst scheduler with the graphs and graph pool it captured, and its
    weights — is released (``gc`` and ``torch.cuda.empty_cache``) before
    the next is built, so at most one candidate is ever alive beside the
    target.

    Returns ``{"mode": "draft"|"ngram"|"nonspec", "name", "draft":
    engine or None, "spec": SpecConfig or None, "measured": {name:
    tokens/s}, "baseline_tokens_per_sec", "calibration_s",
    "persistable"}``; ``persistable`` is the JSON-safe summary to hand
    ``save_autotune(draft_pair=...)``. ``skipped`` lists (name, reason)
    of candidates that were refused; with ``recorder`` (a flight
    recorder) each refusal is also a ``spec.autopair_skip`` event, the
    verdict a ``spec.autopair`` event, and the burst schedulers record
    into it, as in the reference."""
    from tensorlink_tpu_torch.parallel.serving import ContinuousBatchingEngine

    t_start = _clock()
    cfg = cfg or SpecConfig()
    if prompts is None:
        vocab = _vocab_of(engine) or 256
        r = np.random.default_rng(0)
        prompts = [r.integers(0, vocab, (n,)) for n in (8, 13, 6, 10)]
    if candidates is None:
        candidates = default_draft_candidates(engine)

    def burst(draft_eng, spec_cfg) -> float:
        sch = ContinuousBatchingEngine(
            engine, slots=slots, gen=gen, decode_chunk=max(cfg.k, 4),
            prefill_block=16, draft=draft_eng, speculative=spec_cfg,
            cuda_graphs=engine.cuda_graphs, recorder=recorder,
        )
        try:
            sch.result(sch.submit(prompts[0], max_new=max_new))  # build + capture
            t0 = _clock()
            rids = [sch.submit(p, max_new=max_new) for p in prompts]
            sch.run_until_idle()
            dt = _clock() - t0
            ntok = sum(len(sch.result(rid)) for rid in rids)
        finally:
            sch.release()
            del sch
            _release(engine.device)
        return ntok / dt if dt > 0 else 0.0

    def _record(kind: str, **data) -> None:
        if recorder is not None:
            try:
                recorder.record(kind, **data)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def skip(name: str, reason: str) -> None:
        skipped.append((name, reason))
        _record("spec.autopair_skip", name=name, reason=reason)

    measured: dict[str, float] = {}
    skipped: list[tuple[str, str]] = []
    base_tps = burst(None, None)
    measured["nonspec"] = round(base_tps, 1)
    tvocab = _vocab_of(engine)
    choice = {"mode": "nonspec", "name": "nonspec", "draft": None, "spec": None}
    for name, cand in candidates:
        d = cand() if callable(cand) else cand
        dvocab = _vocab_of(d)
        if tvocab is not None and dvocab is not None and dvocab != tvocab:
            skip(name, f"vocab {dvocab} != target {tvocab}")
            del d
            _release(engine.device)
            continue
        try:
            tps = burst(d, cfg)
        except (ValueError, NotImplementedError) as e:
            skip(name, str(e)[:200])
            del d
            _release(engine.device)
            continue
        measured[name] = round(tps, 1)
        if tps > base_tps:
            choice = {"mode": "draft", "name": name, "draft": d, "spec": cfg}
            break
        del d
        _release(engine.device)
    if choice["mode"] == "nonspec":
        ng_tps = burst(None, cfg)
        measured["ngram"] = round(ng_tps, 1)
        if ng_tps > base_tps:
            choice = {"mode": "ngram", "name": "ngram", "draft": None, "spec": cfg}
    choice["measured"] = measured
    choice["skipped"] = skipped
    choice["baseline_tokens_per_sec"] = round(base_tps, 1)
    choice["calibration_s"] = round(_clock() - t_start, 3)
    choice["persistable"] = {
        "mode": choice["mode"], "name": choice["name"],
        "measured": measured,
        "baseline_tokens_per_sec": choice["baseline_tokens_per_sec"],
        "calibration_s": choice["calibration_s"],
    }
    _record("spec.autopair", mode=choice["mode"], name=choice["name"],
            measured=measured)
    return choice
