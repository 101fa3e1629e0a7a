"""PyTorch port, parallel/serving.py with chunks in flight: at
``pipeline_depth`` 0, 1 and 2 the port's contiguous and paged engines
emit exactly the JAX package's engines' greedy tokens at the same depth
(f32, same params): staggered traffic, an EOS that frees a slot for a
queued request, a shared prefix with a copy-on-write tail, and a pool
small enough to force preemption while chunks are in flight. Requests
finish (and free their slots and blocks) at drain; every request gets a
TTFT stamp; ``decode_steps`` counts dispatched chunks; and once idle no
chunk stays in flight."""

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
)

DEPTHS = [0, 1, 2]


@pytest.fixture(scope="module")
def engines():
    jm = JLlama(JLlamaConfig.tiny())
    p = jm.init(jax.random.key(1))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=32,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    tm = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=32,
                           cache_dtype=torch.float32,
                           param_dtype=torch.float32, device="cpu")
    return jeng, teng


def _staggered(sch, prompts, first=3):
    rids = [sch.submit(p) for p in prompts[:first]]
    sch.step()
    rids += [sch.submit(p) for p in prompts[first:]]
    return [np.asarray(sch.result(rid)) for rid in rids]


def _idle_checks(sch, n_requests):
    sch.run_until_idle()
    st = sch.stats()
    assert st["inflight_chunks"] == 0 and st["busy_slots"] == 0
    assert st["decode_steps"] % sch.decode_chunk == 0
    assert all(sch.timings(rid)["ttft_s"] is not None for rid in range(n_requests))


@pytest.mark.parametrize("depth", DEPTHS)
def test_contiguous_tokens_equal_jax_at_depth(engines, depth):
    jeng, teng = engines
    r = np.random.default_rng(21)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 3, 12, 4, 1, 6, 2, 9)]
    kw = {"slots": 2, "decode_chunk": 3, "prefill_block": 4,
          "pipeline_depth": depth}
    ref = _staggered(JContiguous(jeng, gen=JGen(max_new_tokens=7), **kw), prompts)
    sch = ContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=7), **kw)
    out = _staggered(sch, prompts)
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o, rf)
    _idle_checks(sch, len(prompts))


@pytest.mark.parametrize("depth", DEPTHS)
def test_contiguous_eos_readmission_at_depth(engines, depth):
    """One slot: each request ends at EOS mid-chunk; the next is admitted
    into the slot only once the chunk that ended it drains."""
    jeng, teng = engines
    r = np.random.default_rng(22)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 6, 3)]
    free = teng.generate(prompts[0][None], GenerationConfig(max_new_tokens=9))[0]
    eos = int(free[3])
    kw = {"slots": 1, "decode_chunk": 2, "prefill_block": 4,
          "pipeline_depth": depth}
    jsch = JContiguous(jeng, gen=JGen(max_new_tokens=9, eos_token_id=eos), **kw)
    ref = [np.asarray(jsch.result(rid)) for rid in [jsch.submit(p) for p in prompts]]
    sch = ContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=9, eos_token_id=eos), **kw)
    rids = [sch.submit(p) for p in prompts]
    assert sch.stats()["queued"] == 2
    out = [np.asarray(sch.result(rid)) for rid in rids]
    assert len(out[0]) == int(np.argmax(free == eos)) + 1 and out[0][-1] == eos
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o, rf)
    assert {sch._requests[rid].slot for rid in rids} == {0}
    _idle_checks(sch, len(prompts))


def _shared_prefix_traffic(seed):
    r = np.random.default_rng(seed)
    a = r.integers(0, 128, (10,))
    b = np.concatenate([a, r.integers(0, 128, (2,))])
    rest = [r.integers(0, 128, (n,)) for n in (1, 5, 8, 13, 3)]
    return a, b, rest


def _drive(sch, a, b, rest):
    ra = sch.submit(a)
    while sch._pending:
        sch.step()
    rids = [ra, sch.submit(b)] + [sch.submit(p) for p in rest]
    return [np.asarray(sch.result(rid)) for rid in rids]


@pytest.mark.parametrize("depth", DEPTHS)
def test_paged_tokens_equal_jax_at_depth(engines, depth):
    jeng, teng = engines
    kw = {"slots": 2, "decode_chunk": 3, "block_size": 4, "prefill_chunk": 4,
          "pipeline_depth": depth}
    traffic = _shared_prefix_traffic(23)
    ref = _drive(JPaged(jeng, gen=JGen(max_new_tokens=6), **kw), *traffic)
    sch = PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=6), **kw)
    out = _drive(sch, *traffic)
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o, rf)
    assert sch.stats()["cow_copies"] >= 1
    _idle_checks(sch, len(out))
    assert sch.pool.in_use == 0  # every block came back, at drain


@pytest.mark.parametrize("depth", DEPTHS)
def test_paged_preemption_in_flight_equals_jax(engines, depth):
    """8 blocks cannot hold three growing requests: the newest is
    preempted (its row retired, the chunks in flight drained first),
    re-queued, re-prefilled, and still emits the JAX engine's tokens;
    with EOS set, a request may end while chunks are in flight."""
    jeng, teng = engines
    r = np.random.default_rng(24)
    prompts = [r.integers(0, 128, (n,)) for n in (11, 9, 7)]
    kw = {"slots": 2, "decode_chunk": 3, "block_size": 4, "prefill_chunk": 4,
          "num_blocks": 8, "prefix_cache": False, "pipeline_depth": depth}
    free = teng.generate(prompts[2][None], GenerationConfig(max_new_tokens=12))[0]
    for eos in (None, int(free[5])):
        jsch = JPaged(jeng, gen=JGen(max_new_tokens=12, eos_token_id=eos), **kw)
        ref = [np.asarray(jsch.result(rid)) for rid in
               [jsch.submit(p) for p in prompts]]
        sch = PagedContinuousBatchingEngine(
            teng, gen=GenerationConfig(max_new_tokens=12, eos_token_id=eos), **kw)
        out = [np.asarray(sch.result(rid)) for rid in
               [sch.submit(p) for p in prompts]]
        assert sch.preemptions >= 1
        for o, rf in zip(out, ref):
            np.testing.assert_array_equal(o, rf)
        _idle_checks(sch, len(prompts))
        assert sch.pool.in_use == 0


def test_first_token_waits_for_the_drain(engines):
    """At depth 2 a request's tokens, first token included, reach it only
    when a chunk drains: after one step nothing is banked yet."""
    _, teng = engines
    sch = PagedContinuousBatchingEngine(
        teng, gen=GenerationConfig(max_new_tokens=8), slots=1, decode_chunk=2,
        block_size=4, prefill_chunk=8, pipeline_depth=2)
    rid = sch.submit(np.arange(5))
    sch.step()  # the whole prompt prefills, one chunk dispatches
    assert sch._requests[rid].tokens == [] and sch.stats()["inflight_chunks"] == 1
    sch.step()
    sch.step()  # a third chunk in flight: the first drains
    assert len(sch._requests[rid].tokens) == 1 + 2
    assert len(sch.result(rid)) == 8
