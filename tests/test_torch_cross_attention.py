"""PyTorch port, nn/attention.py cross-attention: ``kv=`` (keys and values
projected from another source) and ``precomputed_kv=`` (``project_kv``'s
(k, v), projected once) against the JAX package's ``MultiHeadAttention``
on the same params and inputs (f32, atol 1e-5), at Tk != Tq and Tk = Tq,
with and without a key-padding mask over the source; the reference's
three refusals with its exception types; and the routing of a source of
the query's length with a key-padding mask to the flash wrapper (B1 on
CUDA tensors), as self-attention is routed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.nn.attention import MultiHeadAttention as JMHA
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.ops import flash as tflash

ATOL = 1e-5
DIM, H, HKV = 32, 4, 2


def _pair(*, rope=False, qkv_fused=False, attn_impl="reference"):
    jm = JMHA(DIM, H, num_kv_heads=HKV, rope=rope, causal=False,
              attn_impl="reference", qkv_fused=qkv_fused)
    p = jm.init(jax.random.key(5))
    tm = MultiHeadAttention(DIM, H, num_kv_heads=HKV, rope=rope, causal=False,
                            attn_impl=attn_impl, qkv_fused=qkv_fused)
    tm.load_state_dict(params_from_jax(jax.device_get(p)), assign=True)
    return jm, p, tm


def _inputs(tq, tk, masked):
    r = np.random.default_rng(tq * 31 + tk)
    x = r.normal(size=(2, tq, DIM)).astype(np.float32)
    src = r.normal(size=(2, tk, DIM)).astype(np.float32)
    mask = None
    if masked:
        keep = np.ones((2, tk), bool)
        keep[0, tk - 2:] = False  # row 0: its last two source tokens are pads
        keep[1, :1] = False
        mask = keep[:, None, None, :]
    return x, src, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padmask"])
@pytest.mark.parametrize("tq,tk", [(5, 9), (6, 6)], ids=["tk9", "tk_eq_tq"])
def test_kv_source_matches_jax(tq, tk, masked):
    jm, p, tm = _pair()
    x, src, mask = _inputs(tq, tk, masked)
    ref = np.asarray(jm.apply(p, jnp.asarray(x), kv=jnp.asarray(src),
                              mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), kv=torch.from_numpy(src),
                 mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the source really is attended: self-attention differs
    with torch.no_grad():
        own = tm(torch.from_numpy(x)).numpy()
    assert np.abs(own - out.numpy()).max() > 1e-3


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padmask"])
def test_precomputed_kv_matches_jax(masked):
    jm, p, tm = _pair()
    x, src, mask = _inputs(4, 7, masked)
    jk, jv = jm.project_kv(p, jnp.asarray(src))
    ref = np.asarray(jm.apply(p, jnp.asarray(x), precomputed_kv=(jk, jv),
                              mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        k, v = tm.project_kv(torch.from_numpy(src))
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
        out = tm(torch.from_numpy(x), precomputed_kv=(k, v),
                 mask=None if mask is None else torch.from_numpy(mask))
        direct = tm(torch.from_numpy(x), kv=torch.from_numpy(src),
                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out.numpy(), direct.numpy())


def test_refusals_match_reference():
    x = torch.zeros((1, 3, DIM))
    src = torch.zeros((1, 5, DIM))
    jx, jsrc = jnp.zeros((1, 3, DIM)), jnp.zeros((1, 5, DIM))

    # qkv_fused with a cross-attention source, and its project_kv
    jm, p, tm = _pair(qkv_fused=True)
    for kw, jkw in (({"kv": src}, {"kv": jsrc}),
                    ({"precomputed_kv": (src, src)},
                     {"precomputed_kv": (jsrc, jsrc)})):
        with pytest.raises(NotImplementedError):
            jm.apply(p, jx, **jkw)
        with pytest.raises(NotImplementedError, match="qkv_fused"):
            tm(x, **kw)
    with pytest.raises(NotImplementedError):
        jm.project_kv(p, jsrc)
    with pytest.raises(NotImplementedError, match="qkv_fused"):
        tm.project_kv(src)

    # rope with precomputed k/v
    jm, p, tm = _pair(rope=True)
    jk, jv = jm.project_kv(p, jsrc)
    with pytest.raises(NotImplementedError):
        jm.apply(p, jx, precomputed_kv=(jk, jv))
    with pytest.raises(NotImplementedError, match="rope"):
        tm(x, precomputed_kv=tm.project_kv(src))

    # a cache with cross-attention
    jm, p, tm = _pair()
    jcache = jm.init_cache(1, 8, dtype=jnp.float32)
    tcache = tm.init_cache(1, 8, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        jm.apply(p, jx, kv=jsrc, cache=jcache)
    with pytest.raises(NotImplementedError, match="caching"):
        tm(x, kv=src, cache=tcache)
    with pytest.raises(NotImplementedError, match="caching"):
        tm(x, precomputed_kv=tm.project_kv(src), cache=tcache)


def test_source_of_query_length_routes_to_flash(monkeypatch):
    """Tk = Tq, a key-padding mask, no offset: the routing rule sends the
    call to the flash wrapper (B1 on CUDA tensors; its plain version on
    these CPU tensors), exactly as self-attention; Tk != Tq takes the
    plain path."""
    _, _, tm = _pair(attn_impl="flash")
    calls = []
    real = tflash.flash_attention

    def spy(q, k, v, kv_mask, causal, window):
        calls.append((q.shape[1], k.shape[1], kv_mask is not None, causal))
        return real(q, k, v, kv_mask, causal, window)

    monkeypatch.setattr(tflash, "flash_attention", spy)
    x, src, mask = _inputs(64, 64, True)
    with torch.no_grad():
        tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
        tm(torch.from_numpy(x), kv=torch.from_numpy(src), mask=torch.from_numpy(mask))
    assert calls == [(64, 64, True, False), (64, 64, True, False)]
    x9, src9, mask9 = _inputs(64, 128, True)
    with torch.no_grad():
        tm(torch.from_numpy(x9), kv=torch.from_numpy(src9), mask=torch.from_numpy(mask9))
    assert len(calls) == 2
