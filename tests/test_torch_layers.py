"""PyTorch port, nn/layers.py: Dense, Embedding, RMSNorm and LayerNorm
against the JAX package's modules on the same params and inputs (f32,
atol 1e-6: the same arithmetic in the same order up to rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.nn import layers as jl
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.nn import layers as tl

ATOL = 1e-6


def _load(mod, jparams):
    mod.load_state_dict(params_from_jax(jax.device_get(jparams)), assign=True)
    return mod


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_matches_jax(use_bias):
    jm = jl.Dense(16, 24, use_bias=use_bias)
    p = jm.init(jax.random.key(1))
    if use_bias:  # a nonzero bias, so the add is exercised
        p["b"] = jnp.asarray(_x((24,), 7))
    x = _x((2, 5, 16))
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    tm = _load(tl.Dense(16, 24, use_bias=use_bias), p)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_embedding_and_attend_match_jax():
    jm = jl.Embedding(50, 12)
    p = jm.init(jax.random.key(2))
    ids = np.random.default_rng(3).integers(0, 50, (3, 7))
    tm = _load(tl.Embedding(50, 12), p)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tm(torch.from_numpy(ids)).numpy(),
            np.asarray(jm.apply(p, jnp.asarray(ids))),
        )
        x = _x((3, 12), 4)
        np.testing.assert_allclose(
            tm.attend(torch.from_numpy(x)).numpy(),
            np.asarray(jm.attend(p, jnp.asarray(x))), atol=ATOL, rtol=0,
        )


@pytest.mark.parametrize("kind", ["rms", "layer", "layer_nobias"])
def test_norms_match_jax(kind):
    D = 32
    if kind == "rms":
        jm, tm = jl.RMSNorm(D, eps=1e-5), tl.RMSNorm(D, eps=1e-5)
    else:
        use_bias = kind == "layer"
        jm = jl.LayerNorm(D, eps=1e-5, use_bias=use_bias)
        tm = tl.LayerNorm(D, eps=1e-5, use_bias=use_bias)
    p = {k: jnp.asarray(_x(v.shape, 5 + i)) + (1.0 if k == "scale" else 0.0)
         for i, (k, v) in enumerate(jm.init(jax.random.key(0)).items())}
    x = _x((4, 3, D), 6) * 3 + 1
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    tm = _load(tm, p)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_norm_bf16_input_casts_back_with_f32_math():
    """bf16 activations with f32 scales (the serving dtype policy): the
    norm computes in f32 and returns bf16, as the JAX module does."""
    D = 32
    jm = jl.RMSNorm(D, eps=1e-5)
    p = {"scale": jnp.asarray(_x((D,), 1)) + 1.0}
    x = _x((2, D), 2)
    ref = np.asarray(
        jm.apply(p, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
    )
    tm = _load(tl.RMSNorm(D, eps=1e-5), p)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=0)
