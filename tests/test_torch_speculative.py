"""PyTorch port, parallel/speculative.py and speculative decoding in both
serving engines, held against the JAX package on the same params (f32):

- ``spec_verify``: greedy ``n_emit``/``emitted`` equal JAX's on the same
  logits and proposals, with and without ``k_live``; at temperature > 0
  the first emitted token fits the target's filtered softmax
  (chi-square, p > 1e-3) with a draft, with a delta proposer and with
  ``k_live`` 0 (the counter-hash bits differ from JAX's keys by design);
- ``ngram_propose``, ``AdaptiveKController`` and ``SpecConfig``'s
  validation equal JAX's exactly (left-padded rows, rows with no match,
  the vocab check); the port raises for what waits for later items;
- both engines in n-gram, draft and adaptive modes emit the JAX
  non-spec engine's greedy tokens at ``pipeline_depth`` 0 and 2, with
  the JAX spec engine's weight passes, accepted, proposed and fallback
  counts; a windowed model (blockwise verify) too; constant rollback
  under churn never touches a co-tenant's blocks; the target as its own
  draft emits > 2 tokens a weight pass; sampled tokens depend on (seed,
  position) only; and adaptive K keeps one graph key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel import speculative as jspec
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.inference import spec_verify as jspec_verify
from tensorlink_tpu.parallel.serving import (
    ContinuousBatchingEngine as JContiguous,
    PagedContinuousBatchingEngine as JPaged,
)
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel import speculative as tspec
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    spec_verify,
)
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    SpecConfig,
)

from jax_reference import reference

# ------------------------------------------------------------ spec_verify


def _greedy_case(seed, S=6, K=4, V=11):
    """Logits with distinct argmaxes and proposals that match the target
    for a random prefix of each row."""
    r = np.random.default_rng(seed)
    tgt = r.normal(0, 1, (S, K + 1, V)).astype(np.float32)
    t = tgt.argmax(-1)
    props = r.integers(0, V, (S, K))
    n_match = r.integers(0, K + 1, (S,))
    for s in range(S):
        props[s, :n_match[s]] = t[s, :n_match[s]]
        if n_match[s] < K and props[s, n_match[s]] == t[s, n_match[s]]:
            props[s, n_match[s]] = (t[s, n_match[s]] + 1) % V
    k_live = r.integers(0, K + 1, (S,))
    return tgt, props, k_live


@pytest.mark.parametrize("with_k_live", [False, True])
def test_spec_verify_greedy_equals_jax(with_k_live):
    tgt, props, k_live = _greedy_case(3)
    kl = k_live if with_k_live else None
    n, em = spec_verify(torch.from_numpy(tgt), torch.from_numpy(props),
                        None, 0.0, 0,
                        k_live=None if kl is None else torch.from_numpy(kl))
    key = jax.random.key(0)
    for s in range(tgt.shape[0]):
        jn, jem = jspec_verify(
            jnp.asarray(tgt[s]), jnp.asarray(props[s]), key, 0.0, 0,
            k_live=None if kl is None else jnp.int32(kl[s]))
        assert int(n[s]) == int(jn)
        np.testing.assert_array_equal(em[s].numpy(), np.asarray(jem))
    if with_k_live:
        assert (n.numpy() <= k_live + 1).all() and (n.numpy() < 5).any()


def _first_tokens(tgt, drf, props, temp, k_live, N):
    """The first emitted token of N rows of the same logits, each row its
    own seed."""
    S = N
    K = props.shape[1]
    t = torch.from_numpy(np.broadcast_to(tgt, (S,) + tgt.shape).copy())
    d = None if drf is None else torch.from_numpy(
        np.broadcast_to(drf, (S,) + drf.shape).copy())
    kl = None if k_live is None else torch.full((S,), k_live, dtype=torch.long)
    seed = torch.arange(S, dtype=torch.int64) * 7919 + 11
    pos = torch.full((S,), 5, dtype=torch.int64)
    n, em = spec_verify(t, torch.from_numpy(props), (seed, pos, tspec.SALT_VERIFY),
                        temp, 0, 1.0, draft_logits=d, k_live=kl)
    assert ((n >= 1) & (n <= K + 1)).all()
    return em[:, 0].numpy()


@pytest.mark.parametrize("proposer", ["draft", "delta", "k_live_0"])
def test_spec_verify_sampled_fits_the_target(proposer):
    """Rejection sampling keeps the first emitted token's marginal the
    target's filtered softmax, whatever the draft proposes."""
    V, K, N, temp = 5, 2, 4000, 0.8
    r = np.random.default_rng(0)
    tgt = r.normal(0, 1.5, (K + 1, V)).astype(np.float32)
    drf = r.normal(0, 1.5, (K, V)).astype(np.float32)
    if proposer == "delta":
        props = np.full((N, K), int(np.argmin(tgt[0])))  # an unlikely token
        drf_in = None
    else:
        q = np.exp(drf / temp)
        q /= q.sum(-1, keepdims=True)
        props = np.stack([r.choice(V, size=N, p=q[i]) for i in range(K)], axis=1)
        drf_in = drf
    first = _first_tokens(tgt, drf_in, props, temp,
                          0 if proposer == "k_live_0" else None, N)
    p = np.exp(tgt[0].astype(np.float64) / temp)
    p /= p.sum()
    counts = np.bincount(first, minlength=V)
    assert stats.chisquare(counts, p * counts.sum()).pvalue > 1e-3


def test_spec_verify_salts_keep_the_streams_apart():
    """The same row at the same position draws differently per salt, and
    identically for the same key."""
    V, K = 64, 3
    r = np.random.default_rng(1)
    tgt = torch.from_numpy(r.normal(0, 1, (8, K + 1, V)).astype(np.float32))
    props = torch.zeros((8, K), dtype=torch.long)
    seed = torch.arange(8, dtype=torch.int64)
    pos = torch.full((8,), 3, dtype=torch.int64)
    outs = [spec_verify(tgt, props, (seed, pos, s), 1.0)[1][:, 0] for s in
            (tspec.SALT_VERIFY, tspec.SALT_VERIFY, tspec.SALT_DRAFT)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# ------------------------------------------------------ deterministic helpers


def _ngram_case(seed, S=6, L=32):
    """Rows of small-vocabulary ids (so grams recur), left-padded with
    garbage of their own, including a row too short for a gram and a row
    whose gram never occurred."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, 3, (S, L))
    valid = np.zeros((S, L), bool)
    index = r.integers(2, L - 2, (S,))
    pads = r.integers(0, 4, (S,))
    for s in range(S):
        valid[s, pads[s]:index[s]] = True
    index[0], valid[0] = 1, np.arange(L) == 0  # one committed token
    tok = r.integers(0, 3, (S,))
    ids[1] = 7  # no gram of row 1 ever occurs before its frontier
    tok[1] = 5
    return ids, valid, index, tok


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 3])
def test_ngram_propose_equals_jax(seed, n):
    ids, valid, index, tok = _ngram_case(seed)
    k = 4
    props, found = tspec.ngram_propose(
        torch.from_numpy(ids), torch.from_numpy(valid),
        torch.from_numpy(index).int(), torch.from_numpy(tok), k, n)
    jp, jf = jspec.ngram_propose(jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                                 jnp.asarray(index, jnp.int32),
                                 jnp.asarray(tok, jnp.int32), k, n)
    np.testing.assert_array_equal(props.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    assert not found[0] and not found[1] and found.any()


def test_adaptive_controller_equals_jax():
    r = np.random.default_rng(5)
    for draft_cost in (None, 0.0):
        cfg_t = SpecConfig(k=6, k_min=2, adaptive=True, ewma=0.4)
        cfg_j = jspec.SpecConfig(k=6, k_min=2, adaptive=True, ewma=0.4)
        ct = tspec.AdaptiveKController(cfg_t, draft_cost=draft_cost)
        cj = jspec.AdaptiveKController(cfg_j, draft_cost=draft_cost)
        for _ in range(200):
            rid = int(r.integers(0, 5))
            prop = int(r.integers(0, 7))
            acc = int(r.integers(0, prop + 1))
            ct.observe(rid, prop, acc)
            cj.observe(rid, prop, acc)
            ks = [int(r.integers(1, 7)) for _ in range(3)]
            ct.note_dispatch(ks)
            cj.note_dispatch(ks)
            if r.random() < 0.1:
                ct.forget(rid)
                cj.forget(rid)
            assert [ct.k_for(i) for i in range(6)] == [cj.k_for(i) for i in range(6)]
        assert ct.k_mean() == cj.k_mean() and ct.prior() == cj.prior()
        assert [ct.k_for_acceptance(a / 20) for a in range(21)] == \
            [cj.k_for_acceptance(a / 20) for a in range(21)]
    assert tspec.POSITION_COST == jspec.POSITION_COST
    assert (tspec.SALT_DRAFT, tspec.SALT_VERIFY) == (jspec.SALT_DRAFT, jspec.SALT_VERIFY)


@pytest.mark.parametrize("kw", [
    {"k": 0}, {"rounds": 0}, {"ngram": 1}, {"k": 2, "k_min": 3}, {"k_min": 0},
    {"entropy_exit": 0.0}, {"self_heal_accept": 1.5}, {"ewma": 0.0},
    {"ewma": 1.5}, {"draft_cost": -1.0},
])
def test_spec_config_validation_equals_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jspec.SpecConfig(**kw)
    with pytest.raises(ValueError) as terr:
        SpecConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_spec_config_defaults_and_what_waits():
    assert SpecConfig() .__dict__ == jspec.SpecConfig().__dict__
    auto = SpecConfig.auto(k=6)
    assert auto.__dict__ == jspec.SpecConfig.auto(k=6).__dict__
    assert auto.adaptive and auto.self_heal_accept == 0.3
    # self-healing is accepted, with the reference's range check
    heal = SpecConfig(self_heal_accept=0.3)
    assert heal.__dict__ == jspec.SpecConfig(self_heal_accept=0.3).__dict__


def _tiny_engine(params=None, cfg=None, max_len=32, rolling=False):
    model = Llama(cfg or LlamaConfig.tiny(), device="cpu",
                  seed=None if params is not None else 0)
    return InferenceEngine(model, params, max_len=max_len, device="cpu",
                           rolling_cache=rolling, cache_dtype=torch.float32,
                           param_dtype=torch.float32)


def test_draft_vocab_and_cache_checks():
    eng = _tiny_engine()
    wide = _tiny_engine(cfg=LlamaConfig(
        vocab_size=256, dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
        hidden_dim=64, max_len=64))
    with pytest.raises(ValueError, match="vocab"):
        tspec.SpeculativeDecoder(eng, wide, SpecConfig())
    ring = _tiny_engine(cfg=LlamaConfig.mistral_tiny(), rolling=True)
    # the reference refuses such a draft for good, not as pending work
    with pytest.raises(NotImplementedError) as err:
        tspec.SpeculativeDecoder(eng, ring, SpecConfig())
    assert str(err.value) == ("draft engines must use the plain monotone "
                              "cache (no rolling_cache / kv_seq_shard)")


# ----------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Tiny Llama target and a same-architecture draft of other weights
    (near-zero acceptance, so rollback runs constantly), in both
    packages, with the JAX static engine's greedy tokens."""
    jm = JLlama(JLlamaConfig.tiny())
    p, pd = jm.init(jax.random.key(0)), jm.init(jax.random.key(1))
    mesh = make_mesh(MeshConfig())
    jeng = JEngine(mesh, jm, p, max_len=32, cache_dtype=jnp.float32,
                   param_dtype=jnp.float32)
    jdraft = JEngine(mesh, jm, pd, max_len=32, cache_dtype=jnp.float32,
                     param_dtype=jnp.float32)
    teng = _tiny_engine(params_from_jax(jax.device_get(p)))
    tdraft = _tiny_engine(params_from_jax(jax.device_get(pd)))
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 3, 7)]
    gen = JGen(max_new_tokens=8)
    # the JAX static engine's tokens, computed once a session
    refs = reference(tmp_path_factory, "speculative-engines-refs", lambda: [
        np.asarray(jeng.generate(pr[None], gen))[0] for pr in prompts])
    return jeng, jdraft, teng, tdraft, prompts, refs


MODES = {
    "ngram": (None, {"k": 3, "rounds": 2}),
    "draft": ("draft", {"k": 3, "rounds": 2}),
    "adaptive": ("draft", {"k": 3, "rounds": 2, "adaptive": True,
                           "entropy_exit": 6.0}),
}
ENGINE_KW = {
    "contiguous": {"slots": 2, "decode_chunk": 3, "prefill_block": 4},
    "paged": {"slots": 2, "block_size": 8, "num_blocks": 16, "prefill_chunk": 8},
}
SPEC_KEYS = ("weight_passes", "accepted_total", "proposed_total",
             "fallback_total", "emitted_tokens")


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", list(MODES))
def test_spec_greedy_tokens_and_counts_equal_jax(engines, mode, kind, depth):
    jeng, jdraft, teng, tdraft, prompts, refs = engines
    draft, cfg = MODES[mode]
    kw = dict(ENGINE_KW[kind], pipeline_depth=depth)
    port_cls = ContinuousBatchingEngine if kind == "contiguous" else PagedContinuousBatchingEngine
    sch = port_cls(teng, gen=GenerationConfig(max_new_tokens=8),
                   draft=tdraft if draft else None,
                   speculative=SpecConfig(**cfg), **kw)
    out = [sch.result(rid) for rid in [sch.submit(pr) for pr in prompts]]
    for o, rf in zip(out, refs):
        np.testing.assert_array_equal(o, rf)
    plain = port_cls(teng, gen=GenerationConfig(max_new_tokens=8), **kw)
    for o, rid in zip(out, [plain.submit(pr) for pr in prompts]):
        np.testing.assert_array_equal(o, plain.result(rid))
    sch.run_until_idle()
    st = sch.stats()["spec"]
    assert st["weight_passes"] > 0 and st["adaptive"] == ("adaptive" in mode)
    assert sch.stats()["inflight_chunks"] == 0 and sch.stats()["busy_slots"] == 0
    if depth == 2:  # the JAX spec engine's counts, on the same script
        jcls = JContiguous if kind == "contiguous" else JPaged
        jsch = jcls(jeng, gen=JGen(max_new_tokens=8),
                    draft=jdraft if draft else None,
                    speculative=jspec.SpecConfig(**cfg), **kw)
        for rid in [jsch.submit(pr) for pr in prompts]:
            jsch.result(rid)
        jst = jsch.stats()["spec"]
        assert [st[k] for k in SPEC_KEYS] == [jst[k] for k in SPEC_KEYS]
    if kind == "paged":
        assert sch.pool.in_use == 0


def test_windowed_spec_equals_jax():
    """Mistral-tiny (window 8) at max_len 288: 512 cache slots, so the
    verify pass takes the blockwise read on the contiguous engine and the
    logical window band on the paged one."""
    jm = JLlama(JLlamaConfig.mistral_tiny())
    p = jm.init(jax.random.key(3))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=288,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    teng = _tiny_engine(params_from_jax(jax.device_get(p)),
                        cfg=LlamaConfig.mistral_tiny(), max_len=288)
    r = np.random.default_rng(7)
    prompts = [r.integers(0, 128, (n,)) for n in (12, 4)]
    refs = [np.asarray(jeng.generate(pr[None], JGen(max_new_tokens=16)))[0]
            for pr in prompts]
    gen = GenerationConfig(max_new_tokens=16)
    for sch in (
        ContinuousBatchingEngine(teng, slots=2, gen=gen, decode_chunk=4,
                                 prefill_block=4, speculative=SpecConfig(k=3)),
        PagedContinuousBatchingEngine(teng, slots=2, gen=gen, block_size=8,
                                      num_blocks=24, prefill_chunk=8,
                                      speculative=SpecConfig(k=3)),
    ):
        for rid, ref in zip([sch.submit(pr) for pr in prompts], refs):
            np.testing.assert_array_equal(sch.result(rid), ref)


def test_paged_rollback_never_touches_a_co_tenant(engines):
    """Constant rollback (the mismatched draft rejects nearly everything)
    while slots churn: every stream equals its solo greedy run (the JAX
    engine's for the first three, the port's ``generate`` for the rest),
    and the
    finished slots leave sentinel tables and an empty pool."""
    _, _, teng, tdraft, prompts, refs = engines
    r = np.random.default_rng(11)
    extra = [r.integers(0, 128, (n,)) for n in (6, 4, 8)]
    xrefs = [teng.generate(pr[None], GenerationConfig(max_new_tokens=8))[0]
             for pr in extra]
    sch = PagedContinuousBatchingEngine(
        teng, slots=2, gen=GenerationConfig(max_new_tokens=8), block_size=4,
        num_blocks=16, prefill_chunk=4, draft=tdraft,
        speculative=SpecConfig(k=3, rounds=2))
    rids = [sch.submit(pr) for pr in list(prompts) + extra]
    sch.run_until_idle()
    for rid, ref in zip(rids, list(refs) + xrefs):
        np.testing.assert_array_equal(sch.result(rid), ref)
    assert sch.stats()["spec"]["acceptance_rate"] < 0.5
    assert sch.pool.in_use == 0
    assert (sch._block_table == sch.pool.num_blocks).all()


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_self_draft_emits_more_than_two_tokens_a_pass(engines, kind):
    jeng, _, teng, _, prompts, refs = engines
    kw = ENGINE_KW[kind]
    cls = ContinuousBatchingEngine if kind == "contiguous" else PagedContinuousBatchingEngine
    sch = cls(teng, gen=GenerationConfig(max_new_tokens=8), draft=teng,
              speculative=SpecConfig(k=3, rounds=2), **kw)
    for rid, ref in zip([sch.submit(pr) for pr in prompts], refs):
        np.testing.assert_array_equal(sch.result(rid), ref)
    st = sch.stats()["spec"]
    assert st["accepted_tokens_per_weight_pass"] > 2.0 and st["acceptance_rate"] > 0.7
    assert st["draft_steps"] == st["verify_passes"] * 4


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_sampled_spec_depends_on_seed_and_position_only(engines, mode):
    _, _, teng, tdraft, _, _ = engines
    gen = GenerationConfig(max_new_tokens=8, temperature=0.9, top_k=8)
    kw = {"draft": tdraft} if mode == "draft" else {}
    pr = np.random.default_rng(5).integers(0, 128, (5,))

    def make():
        return ContinuousBatchingEngine(teng, slots=4, gen=gen, decode_chunk=2,
                                        prefill_block=4,
                                        speculative=SpecConfig(k=2), **kw)
    alone = make()
    a = alone.result(alone.submit(pr, seed=42))
    busy = make()
    r6 = np.random.default_rng(6)
    for i, n in enumerate((3, 6, 4)):
        busy.submit(r6.integers(0, 128, (n,)), seed=100 + i)
    np.testing.assert_array_equal(a, busy.result(busy.submit(pr, seed=42)))
    assert list(alone.result(alone.submit(pr, seed=43))) != list(a)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_adaptive_k_keeps_one_graph_key(engines, kind):
    """The effective K is a device operand: however the controller moves
    it, every spec chunk has the same graph key, and the engine counts
    the draft steps no row needed."""
    _, _, teng, tdraft, prompts, refs = engines
    cls = ContinuousBatchingEngine if kind == "contiguous" else PagedContinuousBatchingEngine
    sch = cls(teng, gen=GenerationConfig(max_new_tokens=8), draft=tdraft,
              speculative=SpecConfig(k=3, adaptive=True, entropy_exit=6.0),
              **ENGINE_KW[kind])
    keys, ks = [], []
    key, spec_k = sch._spec_key, sch._spec_k_array
    sch._spec_key = lambda f: keys.append(key(f)) or keys[-1]
    sch._spec_k_array = lambda: ks.append(spec_k()) or ks[-1]
    for rid, ref in zip([sch.submit(pr) for pr in prompts], refs):
        np.testing.assert_array_equal(sch.result(rid), ref)
    assert len(keys) > 3 and len(set(keys)) == 1
    assert len({k for row in ks for k in row}) > 1  # K really moved
    assert sch.stats()["spec"]["idle_draft_steps"] > 0


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_paged_spec_under_pool_pressure_at_depth_2(engines, mode):
    """Speculation reserves ``rounds * (k + 1)`` positions a dispatch with
    two chunks in flight: a pool too small for both slots' reservations
    preempts, and every stream still equals its solo greedy run (a bound
    the drain tightened too far would drop k/v into the scratch block)."""
    _, _, teng, tdraft, _, _ = engines
    r = np.random.default_rng(12)
    prompts = [r.integers(0, 128, (n,)) for n in (9, 6, 11, 5)]
    gen = GenerationConfig(max_new_tokens=12)
    refs = [teng.generate(pr[None], gen)[0] for pr in prompts]
    sch = PagedContinuousBatchingEngine(
        teng, slots=2, gen=gen, block_size=4, num_blocks=9, prefill_chunk=4,
        prefix_cache=False, pipeline_depth=2,
        draft=tdraft if mode == "draft" else None,
        speculative=SpecConfig(k=3, rounds=2))
    rids = [sch.submit(pr) for pr in prompts]
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(sch.result(rid), ref)
    sch.run_until_idle()
    assert sch.preemptions >= 1 and sch.pool.in_use == 0


# ---------------------------------------------------------- self-healing


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_low_accept_self_heals_like_jax(engines, kind):
    """The reference's script (``tests/test_speculative.py``): under a
    draft of other weights the engine downgrades itself at an idle point
    — the same verdict as the JAX engine on the same script — every
    stream keeps the non-spec greedy tokens, and post-heal traffic (the
    rebuilt speculation state and prefill path) does too."""
    jeng, jdraft, teng, tdraft, prompts, refs = engines
    kw = ENGINE_KW[kind]
    tcls, jcls = ((ContinuousBatchingEngine, JContiguous) if kind == "contiguous"
                  else (PagedContinuousBatchingEngine, JPaged))
    sch = tcls(teng, gen=GenerationConfig(max_new_tokens=8), draft=tdraft,
               speculative=SpecConfig(k=3, rounds=2, self_heal_accept=0.3), **kw)
    jsch = jcls(jeng, gen=JGen(max_new_tokens=8), draft=jdraft,
                speculative=jspec.SpecConfig(k=3, rounds=2, self_heal_accept=0.3), **kw)
    r = np.random.default_rng(23)
    work = list(prompts) + [r.integers(0, 128, (n,)) for n in (6, 5, 7, 4)]
    rids = [sch.submit(pr) for pr in work]
    jrids = [jsch.submit(pr) for pr in work]
    sch.run_until_idle()
    jsch.run_until_idle()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(sch.result(rid), np.asarray(jsch.result(jrid)))
    for rid, ref in zip(rids[: len(refs)], refs):
        np.testing.assert_array_equal(sch.result(rid), ref)
    st = sch.stats()
    healed = st["spec_self_healed"]
    assert healed["from"] == "draft" and healed["to"] in ("ngram", "nonspec")
    assert healed["acceptance"] < 0.3 and st["spec_self_heal_total"] == 1
    assert healed == jsch.stats()["spec_self_healed"]
    assert sch.spec is None or sch.spec.mode == "ngram"
    assert not hasattr(sch, "_draft_kv")  # the draft's cache went with it
    pr2 = r.integers(0, 128, (5,))
    ref2 = np.asarray(jeng.generate(jnp.asarray(pr2[None]), JGen(max_new_tokens=8)))[0]
    np.testing.assert_array_equal(sch.result(sch.submit(pr2)), ref2)
    if kind == "paged":
        assert sch.pool.in_use == 0
