"""PyTorch port, models/gpt2.py: GPT-2 tiny logits against the JAX
package's on params carried across by ``convert.params_from_jax`` (f32,
atol 1e-5): without caches, through a scalar contiguous cache (a
left-padded fresh-keys prefill then decode steps whose positions come from
the cache index), and through a per-row cache; the config presets field
for field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jm = JGPT2(JGPT2Config.tiny())
    p = jm.init(jax.random.key(0))
    # nonzero biases and norm offsets, so a dropped bias would show
    r = np.random.default_rng(1)
    p = jax.tree.map(
        lambda a: a + 0.1 * r.normal(size=a.shape).astype(np.float32)
        if a.ndim == 1 else a, jax.device_get(p),
    )
    tm = GPT2(GPT2Config.tiny(), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(p), strict=True, assign=True)
    return jm, p, tm


@pytest.mark.parametrize("preset", ["small", "medium", "tiny"])
def test_config_presets_match_jax(preset):
    assert dataclasses.asdict(getattr(GPT2Config, preset)()) == \
        dataclasses.asdict(getattr(JGPT2Config, preset)())


def test_logits_match_jax(pair):
    jm, p, tm = pair
    ids = np.random.default_rng(2).integers(0, 128, (2, 12))
    ref = np.asarray(jm.apply(p, jnp.asarray(ids)))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_cached_logits_match_jax(pair):
    """Prefill of a left-padded batch over its fresh keys (explicit
    positions), then three decode steps with positions defaulted from the
    scalar cache index, as the JAX model derives them."""
    jm, p, tm = pair
    B, T, L = 2, 5, 16
    r = np.random.default_rng(3)
    ids = r.integers(0, 128, (B, T))
    pad = np.ones((B, T), bool)
    pad[1, :2] = False
    pos = np.maximum(np.cumsum(pad, axis=-1) - 1, 0)
    mask = (np.tril(np.ones((T, T), bool))[None] & pad[:, None, :])[:, None]
    jc = jm.init_caches(B, L, jnp.float32)
    tc = tm.init_caches(B, L, torch.float32)
    ref, jc = jm.apply(p, jnp.asarray(ids), caches=jc,
                       positions=jnp.asarray(pos), mask=jnp.asarray(mask))
    with torch.no_grad():
        out, tc = tm(torch.from_numpy(ids), caches=tc,
                     positions=torch.from_numpy(pos),
                     mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy()[0], np.asarray(ref)[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy()[1, 2:], np.asarray(ref)[1, 2:],
                               atol=ATOL, rtol=0)
    valid = np.zeros((B, L), bool)
    valid[:, :T] = pad
    for i in range(3):
        valid[:, T + i] = True
        tok = r.integers(0, 128, (B, 1))
        m = valid[:, None, None, :]
        ref, jc = jm.apply(p, jnp.asarray(tok), caches=jc, mask=jnp.asarray(m))
        with torch.no_grad():
            out, tc = tm(torch.from_numpy(tok), caches=tc,
                         mask=torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_per_row_cache_logits_match_jax(pair):
    """A per-row [B] index (the serving form): positions default to each
    row's own index."""
    jm, p, tm = pair
    B, L = 2, 16
    r = np.random.default_rng(4)
    jc = jm.init_caches(B, L, jnp.float32)
    tc = tm.init_caches(B, L, torch.float32)
    index = np.array([3, 9], np.int32)
    for c in jc:
        c["attn"]["index"] = jnp.asarray(index)
    for c in tc:
        c["attn"]["index"] = torch.from_numpy(index)
    valid = np.arange(L)[None, :] <= index[:, None]
    tok = r.integers(0, 128, (B, 1))
    ref, _ = jm.apply(p, jnp.asarray(tok), caches=jc,
                      mask=jnp.asarray(valid[:, None, None, :]))
    with torch.no_grad():
        out, _ = tm(torch.from_numpy(tok), caches=tc,
                    mask=torch.from_numpy(valid[:, None, None, :]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_unported_config_features_are_refused():
    with pytest.raises(NotImplementedError):
        GPT2(dataclasses.replace(GPT2Config.tiny(), qkv_fused=True),
             device="cpu")
