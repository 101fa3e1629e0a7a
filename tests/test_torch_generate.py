"""PyTorch port, parallel/inference.py ``generate``: the static-batch
loop against the JAX package's ``generate`` on the same params (f32,
greedy, identical tokens) on Llama tiny and GPT-2 tiny: left padding,
EOS fill, the rolling ring of ``mistral_tiny`` against the JAX ring and
against the full cache, the ring's fall-back and its window requirement,
the tight cache allocation (and the blockwise decode), ``top_p``
validation, and sampled tokens that repeat from their seed and stay in
the nucleus. Sampling streams differ from JAX's by design (threefry bits
cannot be matched), so sampled runs are compared with themselves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorlink_tpu_torch.nn.attention as tattn
from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine

F32 = {"cache_dtype": jnp.float32, "param_dtype": jnp.float32}
T32 = {"cache_dtype": torch.float32, "param_dtype": torch.float32,
       "device": "cpu"}
MODELS = {
    "llama": (JLlama, JLlamaConfig.tiny, Llama, LlamaConfig.tiny),
    "gpt2": (JGPT2, JGPT2Config.tiny, GPT2, GPT2Config.tiny),
    "mistral": (JLlama, JLlamaConfig.mistral_tiny, Llama, LlamaConfig.mistral_tiny),
}


def _engines(name, max_len=32, rolling=False, key=3, cfg=None):
    jcls, jcfg, tcls, tcfg = MODELS[name]
    jm = jcls(cfg or jcfg())
    p = jm.init(jax.random.key(key))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=max_len,
                   rolling_cache=rolling, **F32)
    tm = tcls(cfg or tcfg(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)),
                           max_len=max_len, rolling_cache=rolling, **T32)
    return jeng, teng


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def engines(request):
    return _engines(request.param)


def _padded(seed=0):
    """Two prompts of 3 and 5 tokens, left-padded to 5."""
    r = np.random.default_rng(seed)
    ids = r.integers(1, 128, (2, 5))
    pad = np.ones((2, 5), np.int32)
    ids[0, :2] = 0
    pad[0, :2] = 0
    return ids, pad


def test_greedy_left_padded_matches_jax(engines):
    jeng, teng = engines
    ids, pad = _padded()
    gen = {"max_new_tokens": 8}
    ref = np.asarray(jeng.generate(ids, JGen(**gen), pad_mask=pad))
    out = teng.generate(ids, GenerationConfig(**gen), pad_mask=pad)
    np.testing.assert_array_equal(out, ref)
    # padding does not change a row: the short prompt alone
    solo = teng.generate(ids[:1, 2:], GenerationConfig(**gen))
    np.testing.assert_array_equal(out[:1], solo)


def test_eos_fills_after_termination(engines):
    jeng, teng = engines
    ids, pad = _padded(1)
    free = teng.generate(ids, GenerationConfig(max_new_tokens=8), pad_mask=pad)
    eos = int(free[0, 2])  # the row's third token becomes "eos"
    gen = {"max_new_tokens": 8, "eos_token_id": eos}
    ref = np.asarray(jeng.generate(ids, JGen(**gen), pad_mask=pad))
    out = teng.generate(ids, GenerationConfig(**gen), pad_mask=pad)
    np.testing.assert_array_equal(out, ref)
    end = int(np.argmax(free[0] == eos))  # the row's first eos
    np.testing.assert_array_equal(out[0, :end + 1], free[0, :end + 1])
    assert (out[0, end + 1:] == eos).all()


@pytest.mark.parametrize("T0,pad0", [(4, 0), (20, 3)], ids=["short", "long"])
def test_rolling_ring_matches_jax_and_the_full_cache(T0, pad0):
    """``mistral_tiny`` (window 8): the ring of prompt + window slots
    wraps during decode; the prompt of 20 is longer than the window, so
    the prefill band genuinely masks. Tokens equal the JAX ring's and the
    port's own full cache's."""
    jeng, teng = _engines("mistral", max_len=64, rolling=True)
    _, full = _engines("mistral", max_len=64)
    r = np.random.default_rng(6)
    ids = r.integers(1, 128, (2, T0))
    pad = np.ones((2, T0), np.int32)
    ids[1, :pad0] = 0
    pad[1, :pad0] = 0
    gen = {"max_new_tokens": 24}
    assert teng.cache_plan(T0, 24) == (T0 + 8, True)
    ref = np.asarray(jeng.generate(ids, JGen(**gen), pad_mask=pad))
    out = teng.generate(ids, GenerationConfig(**gen), pad_mask=pad)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        full.generate(ids, GenerationConfig(**gen), pad_mask=pad), out)


def test_ring_falls_back_and_requires_a_window():
    """A window of 300 makes the ring larger than the full cache: the
    engine serves from the monotone cache, tokens unchanged; a windowless
    model cannot have a ring."""
    cfg = dict(vocab_size=128, dim=32, num_layers=2, num_heads=4,
               num_kv_heads=2, hidden_dim=64, max_len=64,
               rope_theta=10000.0, attn_window=300)
    jeng, teng = _engines("mistral", max_len=64, rolling=True,
                          cfg=JLlamaConfig(**cfg))
    assert teng.cache_plan(4, 8) == (256, False)
    ids = np.random.default_rng(2).integers(0, 128, (2, 4))
    gen = {"max_new_tokens": 8}
    np.testing.assert_array_equal(
        teng.generate(ids, GenerationConfig(**gen)),
        np.asarray(jeng.generate(ids, JGen(**gen))))
    _, plain = _engines("llama")
    with pytest.raises(ValueError, match="window"):
        InferenceEngine(plain.model, rolling_cache=True, **T32)


def test_tight_allocation_and_blockwise_decode(monkeypatch):
    """A 512-capacity engine serving 5 + 6 tokens allocates 256 slots;
    with the windowless threshold below that, decode takes the blockwise
    path; both give the JAX engine's tokens."""
    jeng, teng = _engines("llama", max_len=512)
    assert teng.cache_len == 512 and teng.cache_plan(5, 6) == (256, False)
    assert teng.cache_plan(300, 200) == (512, False)
    ids = np.random.default_rng(3).integers(0, 128, (2, 5))
    gen = {"max_new_tokens": 6}
    ref = np.asarray(jeng.generate(ids, JGen(**gen)))
    np.testing.assert_array_equal(teng.generate(ids, GenerationConfig(**gen)), ref)
    calls = []
    real = tattn.decode_attention_blockwise
    monkeypatch.setattr(tattn, "decode_attention_blockwise",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    monkeypatch.setattr(tattn, "DECODE_BLOCKWISE_MIN_WINDOWLESS", 128)
    np.testing.assert_array_equal(teng.generate(ids, GenerationConfig(**gen)), ref)
    # 2 layers x 5 decode steps, each bounded by its own live length
    assert calls == [n for n in range(6, 11) for _ in range(2)]


def test_top_p_and_max_len_are_validated(engines):
    _, teng = engines
    ids = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="top_p"):
        teng.generate(ids, GenerationConfig(temperature=1.0, top_p=0.0))
    with pytest.raises(ValueError, match="max_len"):
        teng.generate(ids, GenerationConfig(max_new_tokens=29))


def test_sampling_repeats_from_its_seed_and_stays_in_the_nucleus(engines):
    jeng, teng = engines
    ids, pad = _padded(4)
    gen = GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=8)
    a = teng.generate(ids, gen, pad_mask=pad, seed=7)
    np.testing.assert_array_equal(a, teng.generate(ids, gen, pad_mask=pad, seed=7))
    assert (a != teng.generate(ids, gen, pad_mask=pad, seed=8)).any()
    greedy = teng.generate(ids, GenerationConfig(max_new_tokens=5), pad_mask=pad)
    # a tiny nucleus holds only the argmax token
    nuc = teng.generate(ids, GenerationConfig(max_new_tokens=5, temperature=0.7,
                                              top_p=1e-6), pad_mask=pad, seed=3)
    np.testing.assert_array_equal(nuc, greedy)
    wide = GenerationConfig(max_new_tokens=5, temperature=1.5, top_p=0.95)
    assert (teng.generate(ids, wide, pad_mask=pad, seed=1)
            != teng.generate(ids, wide, pad_mask=pad, seed=2)).any()


def test_generate_async_returns_the_device_tensor(engines):
    _, teng = engines
    ids = np.random.default_rng(5).integers(0, 128, (2, 4))
    out = teng.generate_async(ids, GenerationConfig(max_new_tokens=3))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 3)
    assert out.device == teng.device
