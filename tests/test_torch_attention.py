"""PyTorch port, nn/attention.py: ``MultiHeadAttention`` against the JAX
package's module on the same params and inputs (f32, atol 1e-5; rtol 1e-6 on the paged outputs).

- the no-cache path with RoPE, causal, GQA (and a sliding window);
- the paged path: a chunked prefill (T > 1) then a decode step (T = 1)
  through block tables with sentinel tails — including a row whose
  writes run past its table (dropped, never clamped) — against JAX's
  ``_apply_paged`` on its XLA gather path (the path JAX takes on the
  CPU), in f32 and int8 pools; outputs and the pools' real blocks after
  the writes (the port's scratch block, which takes dropped writes, is
  not part of JAX's pools);
- the paged path with a custom ``scale`` (the gather route that skips
  B3, as the reference's does) against JAX's XLA paged path at T 1 and
  T 3, bf16 and int8 pools, a window and a view-width mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.nn.attention import MultiHeadAttention as JMHA
from tensorlink_tpu.nn.attention import apply_rope as j_apply_rope
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.nn.attention import MultiHeadAttention, apply_rope

ATOL = 1e-5
# paged outputs can reach ~1e2 (int8 garbage at scale 1.0 read through a
# dropped write's clamped sentinel): f32 rounding there is relative
RTOL = 1e-6
DIM, H, HKV = 32, 4, 2
NB, BS, MB = 10, 4, 4


def _pair(window=None, use_bias=True, scale=None):
    jm = JMHA(DIM, H, num_kv_heads=HKV, use_bias=use_bias, rope=True,
              causal=True, window=window, attn_impl="reference", scale=scale)
    p = jm.init(jax.random.key(3))
    if use_bias:
        r = np.random.default_rng(9)
        p = {k: {**v, "b": jnp.asarray(r.normal(size=v["b"].shape) * 0.1,
                                       jnp.float32)}
             for k, v in p.items()}
    tm = MultiHeadAttention(DIM, H, num_kv_heads=HKV, use_bias=use_bias,
                            rope=True, causal=True, window=window, scale=scale,
                            attn_impl="reference" if scale is not None else "auto")
    tm.load_state_dict(params_from_jax(jax.device_get(p)), assign=True)
    return jm, p, tm


def test_rope_matches_jax():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, H, 8)).astype(np.float32)
    pos = r.integers(0, 3000, (2, 5))
    ref = np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 3], ids=["full", "win3"])
def test_no_cache_path_matches_jax(window):
    jm, p, tm = _pair(window)
    x = np.random.default_rng(1).normal(size=(2, 7, DIM)).astype(np.float32)
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _tables():
    # row 0: blocks 3, 7 then sentinels; row 1: ONE block, so the tail
    # of a 5-token prefill runs past its table and must drop
    bt = np.full((2, MB), NB, np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :1] = [1]
    return bt


POOLS = ("k", "v", "k_scale", "v_scale")


def _real(name, t):
    """The port's pools carry a scratch block at row NB for dropped
    writes; JAX's drop them. Compare (and hand JAX) the real blocks."""
    return t[:NB] if name in POOLS else t


def _to_jax_cache(c):
    def arr(t):
        if t.dtype == torch.bfloat16:  # exact through f32
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return {k: arr(_real(k, v)) for k, v in c.items()}


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_paged_prefill_then_decode_matches_jax(quant):
    jm, p, tm = _pair()
    r = np.random.default_rng(2)
    tc = tm.init_paged_cache(NB, BS, 2, MB, dtype=torch.float32, quant=quant)
    # garbage in the pools, so a stray write or read would show
    for name in ("k", "v"):
        if quant:
            tc[name].copy_(torch.from_numpy(
                r.integers(-127, 128, tc[name].shape).astype(np.int8)))
        else:
            tc[name].copy_(torch.from_numpy(
                r.normal(size=tc[name].shape).astype(np.float32)))
    tc["block_table"].copy_(torch.from_numpy(_tables()))
    jc = _to_jax_cache(tc)

    # prefill: 5 tokens per row at index 0
    T = 5
    x = r.normal(size=(2, T, DIM)).astype(np.float32)
    pos = np.tile(np.arange(T), (2, 1))
    jout, jc = jm.apply(p, jnp.asarray(x), cache=jc, positions=jnp.asarray(pos))
    with torch.no_grad():
        tout, tc = tm(torch.from_numpy(x), cache=tc,
                      positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=RTOL)
    for name in tc:
        np.testing.assert_allclose(
            _real(name, tc[name]).numpy().astype(np.float32),
            np.asarray(jc[name]).astype(np.float32), atol=ATOL, rtol=0,
            err_msg=name,
        )

    # decode: one token per row with a view-width validity mask
    x1 = r.normal(size=(2, 1, DIM)).astype(np.float32)
    valid = np.arange(MB * BS)[None, :] <= np.array([[T], [T]])
    mask = valid[:, None, None, :]
    jout, jc = jm.apply(p, jnp.asarray(x1), cache=jc,
                        positions=jnp.asarray([[T], [T]]),
                        mask=jnp.asarray(mask))
    with torch.no_grad():
        tout, tc = tm(torch.from_numpy(x1), cache=tc,
                      positions=torch.tensor([[T], [T]]),
                      mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=RTOL)
    for name in tc:
        np.testing.assert_allclose(
            _real(name, tc[name]).numpy().astype(np.float32),
            np.asarray(jc[name]).astype(np.float32), atol=ATOL, rtol=0,
            err_msg=name,
        )
    np.testing.assert_array_equal(tc["index"].numpy(), [T + 1, T + 1])


def test_paged_write_drops_through_sentinel():
    """Writes past a row's table land nowhere: every block but the
    row's mapped ones keeps its bytes."""
    _, _, tm = _pair()
    tc = tm.init_paged_cache(NB, BS, 2, MB, dtype=torch.float32)
    tc["k"].fill_(7.0)
    tc["block_table"].copy_(torch.from_numpy(_tables()))
    x = torch.randn(2, 6, DIM, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm(x, cache=tc, positions=torch.arange(6)[None].repeat(2, 1))
    touched = {3, 7, 1}
    for b in range(NB):
        untouched = bool((tc["k"][b] == 7.0).all())
        assert untouched == (b not in touched), b


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_paged_custom_scale_matches_jax_xla_path(pool, T, monkeypatch):
    """A custom scale takes the reference's gather route: the paged write,
    then the logical view (int8 dequantized) through the plain attention
    with ``scale=``, a window band and a view-width mask; B3's wrapper is
    never called on it, and still serves ``scale=None``."""
    from tensorlink_tpu_torch.nn import attention as tattn

    calls = []
    real = tattn.paged_decode_attention
    launches = real.launches

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "paged_decode_attention", counting)
    r = np.random.default_rng(5)
    outs = {}
    for scale in (0.3, None):
        jm, p, tm = _pair(window=3, scale=scale)
        quant = "int8" if pool == "int8" else None
        tc = tm.init_paged_cache(NB, BS, 2, MB, dtype=torch.bfloat16, quant=quant)
        for name in ("k", "v"):
            if quant:
                tc[name].copy_(torch.from_numpy(
                    r.integers(-127, 128, tc[name].shape).astype(np.int8)))
                # scales of the size a write gives (absmax / 127): keys
                # read through a sentinel stay O(1), so the logits stay in
                # the range where f32 summation order is below 1e-5
                tc[name + "_scale"].copy_(torch.from_numpy(
                    r.uniform(0.005, 0.02, tc[name + "_scale"].shape).astype(np.float32)))
            else:
                tc[name].copy_(torch.from_numpy(
                    r.normal(size=tc[name].shape).astype(np.float32)))
        tc["block_table"].copy_(torch.from_numpy(_tables()))
        jc = _to_jax_cache(tc)
        calls.clear()
        # a 5-token prefill, then T tokens under a view-width mask that
        # also hides position 1 of row 0
        for t0, t in ((0, 5), (5, T)):
            x = r.normal(size=(2, t, DIM)).astype(np.float32)
            pos = np.tile(np.arange(t0, t0 + t), (2, 1))
            mask = None
            if t0:
                m = np.arange(MB * BS)[None, :] < np.array([[t0 + t], [t0 + t]])
                m[0, 1] = False
                mask = m[:, None, None, :]
            jout, jc = jm.apply(p, jnp.asarray(x), cache=jc, positions=jnp.asarray(pos),
                                mask=None if mask is None else jnp.asarray(mask))
            with torch.no_grad():
                tout, tc = tm(torch.from_numpy(x), cache=tc,
                              positions=torch.from_numpy(pos),
                              mask=None if mask is None else torch.from_numpy(mask))
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                                       rtol=RTOL)
            for name in tc:
                np.testing.assert_allclose(
                    _real(name, tc[name]).float().numpy(),
                    np.asarray(jc[name]).astype(np.float32), atol=ATOL, rtol=0,
                    err_msg=name)
        outs[scale] = (len(calls), tout)
    assert outs[0.3][0] == 0  # the scaled route never reaches B3
    assert outs[None][0] == 2  # B3 still serves scale=None
    assert not torch.allclose(outs[0.3][1], outs[None][1], atol=1e-3)
    assert real.launches == launches  # plain versions on the CPU: no launch
