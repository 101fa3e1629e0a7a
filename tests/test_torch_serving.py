"""PyTorch port, parallel/serving.py: the port's
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
    PagedContinuousBatchingEngine as JPaged,
)
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
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
