"""PyTorch port, a Mixture-of-Experts Llama (``moe_tiny``: 4 experts,
top-2) served through every engine, held token for token against the
JAX package's engines on the same params and the same script (f32,
greedy). Each model call routes at the reference's T, with capacity per
batch row: the paged engine's prefill chunks (``[1, prefill_chunk]``,
the last one padded at its tail) and T == 1 decode steps at
``pipeline_depth`` 0, 1 and 2, with a shared prefix; the contiguous
engine's left-padded prefill buckets; ``generate``'s left-padded T0;
and the n-gram verify pass at T = K + 1 = 5 (whose capacity drops make
speculative greedy differ from non-speculative greedy in the reference
too, so it is held to the JAX spec engine and its counts)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel import speculative as jspec
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
    SpecConfig,
)

NEW = 7


@pytest.fixture(scope="module")
def engines():
    jm = JLlama(JLlamaConfig.moe_tiny())
    p = jm.init(jax.random.key(1))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=64,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    tm = Llama(LlamaConfig.moe_tiny(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=64,
                           cache_dtype=torch.float32, param_dtype=torch.float32,
                           device="cpu")
    return jeng, teng


def _prompts(seed):
    """Prompts across the 8-token prefill chunk: one chunk, one exact
    chunk, two and three chunks with a padded last one; two share a
    12-token prefix."""
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 128, (12,))
    out = [r.integers(0, 128, (n,)) for n in (5, 8, 12, 20, 1, 9)]
    out.append(np.concatenate([prefix, r.integers(0, 128, (6,))]))
    out.append(np.concatenate([prefix, r.integers(0, 128, (3,))]))
    return out


def _staggered(sch, prompts, first=3):
    rids = [sch.submit(p) for p in prompts[:first]]
    sch.step()
    rids += [sch.submit(p) for p in prompts[first:]]
    return [np.asarray(sch.result(rid)) for rid in rids]


def _equal(out, ref):
    assert len(out) == len(ref)
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o, rf)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_paged_greedy_tokens_equal_jax(engines, depth):
    jeng, teng = engines
    kw = {"slots": 2, "decode_chunk": 3, "block_size": 4, "prefill_chunk": 8,
          "pipeline_depth": depth}
    prompts = _prompts(31)
    ref = _staggered(JPaged(jeng, gen=JGen(max_new_tokens=NEW), **kw), prompts)
    sch = PagedContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=NEW),
                                        **kw)
    _equal(_staggered(sch, prompts), ref)
    sch.run_until_idle()
    st = sch.stats()
    assert st["prefill_chunks"] >= len(prompts) + 3  # multi-chunk prompts
    assert st["inflight_chunks"] == 0 and sch.pool.in_use == 0


def test_contiguous_greedy_tokens_equal_jax(engines):
    jeng, teng = engines
    kw = {"slots": 2, "decode_chunk": 3, "prefill_block": 4, "pipeline_depth": 2}
    prompts = _prompts(32)
    ref = _staggered(JContiguous(jeng, gen=JGen(max_new_tokens=NEW), **kw), prompts)
    sch = ContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=NEW), **kw)
    _equal(_staggered(sch, prompts), ref)


def test_left_padded_generate_equals_jax(engines):
    jeng, teng = engines
    r = np.random.default_rng(33)
    lens = (3, 9, 6)
    ids = np.zeros((3, 9), np.int64)
    pad = np.zeros((3, 9), np.int32)
    for b, n in enumerate(lens):
        ids[b, 9 - n:] = r.integers(1, 128, (n,))
        pad[b, 9 - n:] = 1
    ref = np.asarray(jeng.generate(ids, JGen(max_new_tokens=NEW), pad_mask=pad))
    out = teng.generate(ids, GenerationConfig(max_new_tokens=NEW), pad_mask=pad)
    np.testing.assert_array_equal(out, ref)


def test_paged_ngram_speculation_equals_the_jax_spec_engine(engines):
    jeng, teng = engines
    kw = {"slots": 2, "block_size": 4, "prefill_chunk": 8, "pipeline_depth": 2}
    r = np.random.default_rng(34)
    phrase = r.integers(0, 128, (4,))
    prompts = [np.concatenate([phrase, r.integers(0, 128, (2,)), phrase, phrase]),
               r.integers(0, 128, (11,)), np.tile(phrase, 3), r.integers(0, 128, (3,))]
    jsch = JPaged(jeng, gen=JGen(max_new_tokens=10),
                  speculative=jspec.SpecConfig(k=4), **kw)
    ref = [np.asarray(jsch.result(rid)) for rid in [jsch.submit(p) for p in prompts]]
    sch = PagedContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=10),
                                        speculative=SpecConfig(k=4), **kw)
    _equal([np.asarray(sch.result(rid)) for rid in [sch.submit(p) for p in prompts]], ref)
    keys = ("weight_passes", "accepted_total", "proposed_total", "fallback_total",
            "emitted_tokens")
    st, jst = sch.stats()["spec"], jsch.stats()["spec"]
    assert [st[k] for k in keys] == [jst[k] for k in keys]
    assert st["proposed_total"] > 0
