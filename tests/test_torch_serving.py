"""PyTorch port, parallel/serving.py. The port's contiguous
``ContinuousBatchingEngine`` is token-identical to the JAX package's
(greedy, f32, same params) on staggered traffic and to the port's own
``generate``; an EOS frees its slot for a queued request; a windowed
model serves from the monotone cache; a rolling engine is refused; and
finished results are bounded. The port's
``PagedContinuousBatchingEngine`` is token-identical to the JAX package's
(greedy, f32, same params) under traffic that exercises the scheduler:
more requests than slots, a shared prefix (hits and a copy-on-write of a
live partial tail), prompts crossing chunk and block edges, a pool small
enough to force preemption, and int8 KV. Sampled mode keeps the property
the JAX engine guarantees: a request's tokens depend on its seed and
positions only, not on its slot or its co-tenants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.serving import (
    ContinuousBatchingEngine as JContiguous,
    PagedContinuousBatchingEngine as JPaged,
)
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    PoolExhaustedError,
    PoolOverloadedError,
    PromptTooLongError,
    QueueFullError,
)

MAX_NEW = 6
KW = {"slots": 2, "decode_chunk": 3, "block_size": 4, "prefill_chunk": 4}


@pytest.fixture(scope="module")
def engines():
    jm = JLlama(JLlamaConfig.tiny())
    p = jm.init(jax.random.key(0))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=32,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    tm = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=32,
                           cache_dtype=torch.float32,
                           param_dtype=torch.float32, device="cpu")
    return jeng, teng


def _traffic(seed=0):
    """(A, B, rest): B extends A's 10-token prompt (2 full blocks + a
    2-token tail) and arrives while A still decodes; the rest share a
    9-token system prompt or stand alone, 1..13 tokens long."""
    r = np.random.default_rng(seed)
    a = r.integers(0, 128, (10,))
    b = np.concatenate([a, r.integers(0, 128, (2,))])
    sys_prompt = r.integers(0, 128, (9,))
    rest = [np.concatenate([sys_prompt, r.integers(0, 128, (n,))])
            for n in (3, 4, 1)]
    rest += [r.integers(0, 128, (n,)) for n in (1, 5, 8, 13)]
    return a, b, rest


def _drive(sch, a, b, rest):
    """Submit A, run until its prefill is done (its prefix registered),
    submit B (live partial-tail hit -> COW) and the rest; collect."""
    ra = sch.submit(a)
    while sch._pending:
        sch.step()
    rids = [ra, sch.submit(b)] + [sch.submit(p) for p in rest]
    return [np.asarray(sch.result(rid)) for rid in rids]


def test_greedy_token_identical_to_jax(engines):
    jeng, teng = engines
    traffic = _traffic()
    ref = _drive(JPaged(jeng, gen=JGen(max_new_tokens=MAX_NEW), **KW), *traffic)
    sch = PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=MAX_NEW), **KW
    )
    out = _drive(sch, *traffic)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    st = sch.stats()
    assert st["cow_copies"] >= 1
    assert st["prefix_matched_tokens"] >= 10 + 8  # B's 10, a sharer's 2 blocks
    assert st["prefill_chunks"] > len(out)  # prompts span several chunks
    assert st["pool"]["blocks_in_use"] == 0  # every block came back


def test_preemption_token_identical_to_jax(engines):
    """A pool of 8 blocks cannot hold two growing requests: the newest
    is preempted, re-queued, re-prefilled, and still emits exactly the
    JAX engine's tokens."""
    jeng, teng = engines
    r = np.random.default_rng(5)
    prompts = [r.integers(0, 128, (n,)) for n in (11, 9, 7)]
    kw = {**KW, "num_blocks": 8, "prefix_cache": False}
    gen = {"max_new_tokens": 12}
    jsch = JPaged(jeng, gen=JGen(**gen), **kw)
    ref = [np.asarray(jsch.result(rid)) for rid in
           [jsch.submit(p) for p in prompts]]
    sch = PagedContinuousBatchingEngine(teng, gen=GenerationConfig(**gen), **kw)
    out = [np.asarray(sch.result(rid)) for rid in
           [sch.submit(p) for p in prompts]]
    assert sch.preemptions >= 1
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o, rf)


def test_int8_kv_token_identical_to_jax(engines):
    jeng, teng = engines
    traffic = _traffic(seed=1)
    ref = _drive(JPaged(jeng, gen=JGen(max_new_tokens=MAX_NEW),
                        kv_quant="int8", **KW), *traffic)
    out = _drive(PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=MAX_NEW), kv_quant="int8",
        **KW), *traffic)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def test_sampled_tokens_independent_of_slot_and_cotenants(engines):
    _, teng = engines
    gen = GenerationConfig(max_new_tokens=MAX_NEW, temperature=1.0, top_k=20)
    r = np.random.default_rng(7)
    x = r.integers(0, 128, (6,))
    alone = PagedContinuousBatchingEngine(teng, gen=gen, **{**KW, "slots": 1})
    solo = alone.result(alone.submit(x, seed=11))
    busy = PagedContinuousBatchingEngine(teng, gen=gen, **{**KW, "slots": 3})
    others = [busy.submit(r.integers(0, 128, (n,)), seed=s)
              for n, s in ((5, 1), (9, 2))]
    rid = busy.submit(x, seed=11)
    assert busy._requests[rid].slot not in (None, 0)  # another slot
    np.testing.assert_array_equal(busy.result(rid), solo)
    for o in others:
        busy.result(o)
    other_seed = alone.result(alone.submit(x, seed=12))
    assert not np.array_equal(other_seed, solo)  # the seed does matter


def test_submit_rejections(engines):
    _, teng = engines
    gen = GenerationConfig(max_new_tokens=4)
    sch = PagedContinuousBatchingEngine(teng, gen=gen, **KW)
    with pytest.raises(PromptTooLongError):
        sch.submit(np.zeros(30, np.int64))  # 30 + 4 > max_len 32
    with pytest.raises(PoolExhaustedError):
        PagedContinuousBatchingEngine(
            teng, gen=gen, num_blocks=2, **KW
        ).submit(np.zeros(10, np.int64))  # needs 4 blocks of 4
    full = PagedContinuousBatchingEngine(teng, gen=gen, max_queue=1, **KW)
    for _ in range(3):  # two slots + one queued
        full.submit(np.arange(5))
    with pytest.raises(QueueFullError):
        full.submit(np.arange(5))
    starved = PagedContinuousBatchingEngine(
        teng, gen=gen, num_blocks=4, max_queue=1, **KW
    )
    starved.submit(np.arange(12))  # takes 4 of the 4 blocks: one slot
    starved.submit(np.arange(12))  # queued on blocks, a slot still free
    with pytest.raises(PoolOverloadedError):
        starved.submit(np.arange(12))


def test_finished_results_are_bounded(engines):
    """Only the newest ``keep_results`` finished requests stay readable."""
    _, teng = engines
    sch = PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=2), keep_results=2, **KW
    )
    rids = [sch.submit(np.arange(3) + i) for i in range(4)]
    sch.run_until_idle()
    with pytest.raises(KeyError):
        sch.result(rids[0])
    assert len(sch.result(rids[-1])) == 2


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, 1.0), (5, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    """The temperature/top-k/top-p transform the sampler draws from is
    the JAX package's, position for position (f32, atol 1e-6; the same
    entries are masked to -inf)."""
    from tensorlink_tpu.parallel.inference import _filter_logits as j_filter
    from tensorlink_tpu_torch.parallel.inference import _filter_logits

    x = np.random.default_rng(4).normal(size=(3, 40)).astype(np.float32) * 3
    ref = np.asarray(j_filter(jnp.asarray(x), 0.7, top_k, top_p))
    out = _filter_logits(torch.from_numpy(x), 0.7, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[~np.isinf(out)], ref[~np.isinf(ref)],
                               atol=1e-6, rtol=0)


# ------------------------------------------------- contiguous engine
CKW = {"slots": 2, "decode_chunk": 3, "prefill_block": 4}


def _staggered(sch, prompts, first=3):
    """Submit ``first`` prompts, run one scheduler step, submit the rest
    (they queue behind busy slots); collect every result."""
    rids = [sch.submit(p) for p in prompts[:first]]
    sch.step()
    rids += [sch.submit(p) for p in prompts[first:]]
    return [np.asarray(sch.result(rid)) for rid in rids]


def test_contiguous_token_identical_to_jax_and_generate(engines):
    """Staggered prompts of 1..12 tokens (across prefill buckets of 4)
    through 2 slots: tokens equal the JAX contiguous engine's and the
    port's ``generate`` of each prompt alone."""
    jeng, teng = engines
    r = np.random.default_rng(11)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 3, 12, 4, 1, 6, 2, 9)]
    ref = _staggered(JContiguous(jeng, gen=JGen(max_new_tokens=MAX_NEW), **CKW),
                     prompts)
    sch = ContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=MAX_NEW), **CKW
    )
    out = _staggered(sch, prompts)
    for o, rf, p in zip(out, ref, prompts):
        np.testing.assert_array_equal(o, rf)
        solo = teng.generate(p[None], GenerationConfig(max_new_tokens=MAX_NEW))
        np.testing.assert_array_equal(o, solo[0])
    st = sch.stats()
    assert st["prefill_chunks"] == len(prompts) and st["busy_slots"] == 0
    assert st["decode_steps"] % CKW["decode_chunk"] == 0


def test_contiguous_eos_frees_slot_for_readmission(engines):
    """One slot: A ends at EOS mid-stream, B (queued) takes the same
    slot and decodes its own tokens up to its EOS point."""
    _, teng = engines
    r = np.random.default_rng(12)
    a, b = r.integers(0, 128, (5,)), r.integers(0, 128, (6,))
    free = teng.generate(a[None], GenerationConfig(max_new_tokens=8))[0]
    eos = int(free[2])
    gen = GenerationConfig(max_new_tokens=8, eos_token_id=eos)
    ref_a = teng.generate(a[None], gen)[0]
    ref_b = teng.generate(b[None], gen)[0]
    sch = ContinuousBatchingEngine(teng, gen=gen, slots=1, decode_chunk=2,
                                   prefill_block=4)
    ra, rb = sch.submit(a), sch.submit(b)
    assert sch.stats()["queued"] == 1
    out_a, out_b = sch.result(ra), sch.result(rb)
    end = int(np.argmax(free == eos))
    assert len(out_a) == end + 1 and out_a[-1] == eos
    np.testing.assert_array_equal(out_a, ref_a[:end + 1])
    assert len(out_b) == 8 or out_b[-1] == eos
    np.testing.assert_array_equal(out_b, ref_b[:len(out_b)])
    assert sch._requests[rb].slot == sch._requests[ra].slot == 0
    assert sch.stats()["busy_slots"] == 0


def test_contiguous_windowed_model_parity():
    """``mistral_tiny`` (window 8) through the scheduler: the per-row
    window band in slot space gives the JAX engine's tokens, for prompts
    longer and shorter than the window."""
    jm = JLlama(JLlamaConfig.mistral_tiny())
    p = jm.init(jax.random.key(3))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=64,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    tm = Llama(LlamaConfig.mistral_tiny(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=64,
                           cache_dtype=torch.float32,
                           param_dtype=torch.float32, device="cpu")
    r = np.random.default_rng(7)
    prompts = [r.integers(0, 128, (n,)) for n in (12, 4, 9)]
    kw = {"slots": 2, "decode_chunk": 4, "prefill_block": 4}
    gen = {"max_new_tokens": 16}
    ref = _staggered(JContiguous(jeng, gen=JGen(**gen), **kw), prompts, first=2)
    out = _staggered(ContinuousBatchingEngine(
        teng, gen=GenerationConfig(**gen), **kw), prompts, first=2)
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o, rf)


def test_rolling_engine_is_refused():
    tm = Llama(LlamaConfig.mistral_tiny(), device="cpu")
    ring = InferenceEngine(tm, max_len=32, rolling_cache=True, device="cpu",
                           cache_dtype=torch.float32)
    for cls in (ContinuousBatchingEngine, PagedContinuousBatchingEngine):
        with pytest.raises(NotImplementedError, match="rolling"):
            cls(ring, slots=2)


def test_contiguous_rejections_and_bounded_results(engines):
    _, teng = engines
    sch = ContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=3), keep_results=2, **CKW
    )
    with pytest.raises(PromptTooLongError):
        sch.submit(np.zeros(30, np.int64))  # 30 + 3 > max_len 32
    with pytest.raises(ValueError):
        sch.submit(np.zeros(0, np.int64))
    rids = [sch.submit(np.arange(4) + i) for i in range(4)]
    sch.run_until_idle()
    for rid in rids[-2:]:
        np.testing.assert_array_equal(sch.result(rid), sch.result(rid))
    for rid in rids[:2]:
        with pytest.raises(KeyError, match="evicted"):
            sch.result(rid)
    assert sch.stats()["requests"] <= 2
    full = ContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=4), max_queue=1,
        **{**CKW, "slots": 1},
    )
    full.submit(np.arange(4))
    full.submit(np.arange(4))  # queued behind the busy slot
    with pytest.raises(QueueFullError):
        full.submit(np.arange(4))


def test_stats_and_readers_lock_safe_under_concurrent_stepping(engines):
    """The reference's TL601 regression, on the port's paged engine:
    ``stats()``, ``prefix_hit_rate()`` and ``timings()`` take the
    scheduler lock, so a scraper thread racing the step loop sees
    consistent snapshots (matched prompt tokens never above submitted,
    counters never going backwards) and never crashes; the final
    counters account for every prompt."""
    import threading

    _, teng = engines
    sch = PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=4),
        **{**KW, "decode_chunk": 2},
    )
    a, b, rest = _traffic(3)
    prompts = [a, b, *rest]
    errors, seen, rids = [], [], []
    stop = threading.Event()

    def scrape():
        try:
            while not stop.is_set():
                s = sch.stats()
                assert s["prefix_matched_tokens"] <= s["prompt_tokens_total"]
                seen.append(s["prompt_tokens_total"])
                assert 0.0 <= sch.prefix_hit_rate() <= 1.0
                for rid in list(rids):
                    assert sch.timings(rid)["tokens"] <= 4
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    t = threading.Thread(target=scrape)
    t.start()
    try:
        for pr in prompts:
            rids.append(sch.submit(pr))
        for rid in rids:
            assert len(sch.result(rid)) > 0
    finally:
        stop.set()
        t.join(timeout=30)
    assert not errors, errors
    assert all(x <= y for x, y in zip(seen, seen[1:]))
    assert sch.stats()["prompt_tokens_total"] == sum(len(p) for p in prompts)


@pytest.mark.parametrize("reader", ["prefix_hit_rate", "timings", "disagg_guard"])
def test_readers_wait_for_the_step_lock(engines, reader):
    """C12: ``prefix_hit_rate`` (the two counters admission writes),
    ``timings`` (``_requests``, which submit and eviction write) and the
    disaggregation guard (``spec``, which a self-heal swaps) read under
    the engine's lock, as the reference's do: held by a step, the lock
    keeps a reader waiting until the step lets go, and the reader then
    answers."""
    import threading

    _, teng = engines
    sch = PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=2), **KW)
    rid = sch.submit(np.arange(5))
    sch.run_until_idle()
    call = {"prefix_hit_rate": sch.prefix_hit_rate,
            "timings": lambda: sch.timings(rid),
            "disagg_guard": sch._disagg_guard}[reader]
    out = []
    t = threading.Thread(target=lambda: out.append(call()))
    with sch._lock:  # a step in flight
        t.start()
        t.join(timeout=0.3)
        assert t.is_alive() and not out, f"{reader} read without the lock"
    t.join(timeout=30)
    assert not t.is_alive() and len(out) == 1
    if reader == "timings":
        assert out[0]["tokens"] == 2
