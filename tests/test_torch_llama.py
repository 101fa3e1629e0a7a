"""PyTorch port, models/llama.py and convert.py: Llama logits against the
JAX package's on params carried across by ``convert.params_from_jax``
(f32, atol 1e-4 after two blocks of f32 matmuls), the config presets
field for field, and the serving dtype policy of the conversion."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig

PRESETS = ["llama3_8b", "mistral_7b", "mixtral_8x7b", "mistral_tiny",
           "moe_tiny", "llama3_70b", "llama2_7b", "tiny"]


@pytest.mark.parametrize("preset", PRESETS)
def test_config_presets_match_jax(preset):
    assert dataclasses.asdict(getattr(LlamaConfig, preset)()) == \
        dataclasses.asdict(getattr(JLlamaConfig, preset)())


@pytest.mark.parametrize("preset", ["tiny", "mistral_tiny"])
def test_logits_match_jax(preset):
    jcfg = getattr(JLlamaConfig, preset)()
    jm = JLlama(jcfg)
    p = jm.init(jax.random.key(0))
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12))
    ref = np.asarray(jm.apply(p, jnp.asarray(ids)))
    tm = Llama(getattr(LlamaConfig, preset)(), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(jax.device_get(p)), assign=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_params_from_jax_applies_dtype_policy():
    jm = JLlama(JLlamaConfig.tiny())
    p = jax.device_get(jm.init(jax.random.key(0)))
    # a bf16 leaf from the JAX side converts bit for bit
    p["tok_emb"]["table"] = np.asarray(
        jnp.asarray(p["tok_emb"]["table"], jnp.bfloat16)
    )
    state = params_from_jax(p, param_dtype=torch.bfloat16)
    assert state["tok_emb.table"].dtype == torch.bfloat16
    assert state["blocks.0.attn.q.w"].dtype == torch.bfloat16
    assert state["blocks.1.norm2.scale"].dtype == torch.float32
    assert state["norm_f.scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        state["tok_emb.table"].float().numpy(),
        np.asarray(p["tok_emb"]["table"]).astype(np.float32),
    )
    tm = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    assert set(state) == set(tm.state_dict())


def test_unported_config_features_are_refused():
    """No config feature is refused any more: MoE builds with the
    reference's parameter names and shapes, and the fused q/k/v layout
    builds, with the reference's per-kv-group width and no separate
    q/k/v."""
    moe = Llama(LlamaConfig.moe_tiny(), device="cpu")
    jm = JLlama(JLlamaConfig.moe_tiny())
    ref = params_from_jax(jax.device_get(jm.init(jax.random.key(0))))
    got = moe.state_dict()
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(t.shape) for n, t in ref.items()}
    assert tuple(got["blocks.0.mlp.up"].shape) == (4, 32, 64)
    assert tuple(got["blocks.0.mlp.router.w"].shape) == (32, 4)
    cfg = dataclasses.replace(LlamaConfig.tiny(), qkv_fused=True)
    m = Llama(cfg, device="cpu")
    attn = m.blocks.blocks()[0].attn
    D = cfg.dim // cfg.num_heads
    assert attn.qkv.w.shape == (cfg.dim, (cfg.num_heads + 2 * cfg.num_kv_heads) * D)
    assert not any(".attn.q." in n or ".attn.k." in n for n in m.state_dict())
