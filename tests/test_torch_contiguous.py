"""PyTorch port, nn/attention.py contiguous cache: ``MultiHeadAttention``
with a contiguous cache and ``decode_attention_blockwise`` against the JAX
package on the same params and inputs (f32, atol 1e-5):

- a scalar-index prefill (fresh keys, or the cache) then decode steps;
- the blockwise decode against the full-width path at a cache of
  2304 slots (narrow heads), with and without a window;
- per-row writes, dropped at capacity: a row filled to capacity and a
  T > 1 frontier write that crosses it;
- a ring that wraps, a write that crosses its edge, and a write larger
  than the ring, which raises;
- the fresh-keys contract's errors and its NaN poison;
- the decode step's fused residual + norm (B4) runs only in eval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorlink_tpu_torch.nn.attention as tattn
import tensorlink_tpu_torch.nn.transformer as ttrans
from tensorlink_tpu.nn.attention import MultiHeadAttention as JMHA
from tensorlink_tpu.nn.attention import decode_attention_blockwise as j_blockwise
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.nn.attention import (
    MultiHeadAttention,
    decode_attention_blockwise,
    dot_product_attention,
)
from tensorlink_tpu_torch.nn.transformer import TransformerBlock

ATOL = 1e-5
DIM, H, HKV = 32, 4, 2


def _pair(window=None, rope=True):
    jm = JMHA(DIM, H, num_kv_heads=HKV, use_bias=True, rope=rope,
              causal=True, window=window, attn_impl="reference")
    p = jm.init(jax.random.key(3))
    r = np.random.default_rng(9)
    p = {k: {**v, "b": jnp.asarray(r.normal(size=v["b"].shape) * 0.1,
                                   jnp.float32)}
         for k, v in p.items()}
    tm = MultiHeadAttention(DIM, H, num_kv_heads=HKV, use_bias=True,
                            rope=rope, causal=True, window=window)
    tm.load_state_dict(params_from_jax(jax.device_get(p)), assign=True)
    return jm, p, tm


def _caches(jm, tm, B, L, rolling=False, index=None, seed=0):
    """The same cache for both packages, k/v filled with noise so a stray
    read or write shows; ``index`` an int (scalar) or a list (per row)."""
    r = np.random.default_rng(seed)
    tc = tm.init_cache(B, L, torch.float32, rolling=rolling)
    for name in ("k", "v"):
        tc[name].copy_(torch.from_numpy(
            r.normal(size=tc[name].shape).astype(np.float32)))
    if index is not None:
        tc["index"] = torch.tensor(index, dtype=torch.int32)
    jc = jm.init_cache(B, L, jnp.float32, rolling=rolling)
    jc.update({name: jnp.asarray(tc[name].numpy()) for name in ("k", "v")})
    jc["index"] = jnp.asarray(tc["index"].numpy())
    return jc, tc


def _apply(jm, p, tm, jc, tc, x, **kw):
    jout, jc = jm.apply(p, jnp.asarray(x), cache=jc,
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tout, tc = tm(torch.from_numpy(x), cache=tc,
                      **{k: torch.from_numpy(np.asarray(v))
                         for k, v in kw.items()})
    return np.asarray(jout), tout.numpy(), jc, tc


def _same_cache(jc, tc):
    for name in ("k", "v", "index"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("window", [None, 3], ids=["full", "win3"])
@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cache"])
def test_scalar_prefill_then_decode_matches_jax(window, fresh):
    """Left-padded prefill at index 0 (attending its fresh keys under a
    T-wide mask, or the cache under a cache-width one), then three decode
    steps under the valid-slot mask."""
    jm, p, tm = _pair(window)
    B, T, L = 2, 6, 16
    jc, tc = _caches(jm, tm, B, L)
    r = np.random.default_rng(1)
    pad = np.ones((B, T), bool)
    pad[0, :2] = False
    pos = np.maximum(np.cumsum(pad, axis=-1) - 1, 0)
    width = T if fresh else L
    keep = np.arange(width)[None, :] <= np.arange(T)[:, None]
    kreal = np.zeros((B, width), bool)
    kreal[:, :T] = pad
    mask = (keep[None] & kreal[:, None, :])[:, None]
    x = r.normal(size=(B, T, DIM)).astype(np.float32)
    jout, tout, jc, tc = _apply(jm, p, tm, jc, tc, x, positions=pos, mask=mask)
    np.testing.assert_allclose(tout[0, 2:], jout[0, 2:], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tout[1], jout[1], atol=ATOL, rtol=0)
    _same_cache(jc, tc)
    valid = np.zeros((B, L), bool)
    valid[:, :T] = pad
    n = pad.sum(-1)
    for i in range(3):
        valid[:, T + i] = True
        x1 = r.normal(size=(B, 1, DIM)).astype(np.float32)
        jout, tout, jc, tc = _apply(
            jm, p, tm, jc, tc, x1, positions=(n + i)[:, None],
            mask=valid[:, None, None, :],
        )
        np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)
        _same_cache(jc, tc)


@pytest.mark.parametrize("window", [None, 300], ids=["full", "win300"])
def test_blockwise_matches_full_at_2304_slots(window):
    """The blockwise decode over 256-slot blocks, with host bounds, agrees
    with the full-width attention and with the JAX loop; a row with left
    padding, a live prefix of 2000 and garbage past it."""
    r = np.random.default_rng(0)
    B, Hq, Hk, D, L, live = 2, 4, 2, 8, 2304, 2000
    q = r.normal(size=(B, 1, Hq, D)).astype(np.float32)
    k = r.normal(size=(B, L, Hk, D)).astype(np.float32)
    v = r.normal(size=(B, L, Hk, D)).astype(np.float32)
    k[:, live:] = 1e4  # garbage beyond the live prefix
    mask = np.zeros((B, 1, 1, L), bool)
    mask[..., :live] = True
    mask[0, ..., :7] = False
    start = 0
    if window is not None:
        start = live - window
        mask[..., :start] = False
    tq, tk, tv, tmask = (torch.from_numpy(a) for a in (q, k, v, mask))
    full = dot_product_attention(tq, tk, tv, mask=tmask).numpy()
    out = decode_attention_blockwise(tq, tk, tv, live, mask=tmask,
                                     start=start).numpy()
    ref = np.asarray(j_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(live),
        mask=jnp.asarray(mask), start=start,
    ))
    np.testing.assert_allclose(out, full, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # without bounds every block is visited: the same outputs
    every = decode_attention_blockwise(tq, tk, tv, L, mask=tmask).numpy()
    np.testing.assert_allclose(every, out, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="block"):
        decode_attention_blockwise(tq, tk[:, :300], tv[:, :300], live)


@pytest.mark.parametrize("window", [None, 300], ids=["full", "win300"])
@pytest.mark.parametrize("hint", [True, False], ids=["frontier", "no_hint"])
def test_module_decode_over_2304_slots_takes_the_blockwise_path(window, hint,
                                                                 monkeypatch):
    """A T == 1 step over a 2304-slot scalar cache routes to the blockwise
    path in both packages and matches the JAX module, with the host
    frontier or without it; the full-width path agrees too."""
    jm, p, tm = _pair(window)
    B, L, idx = 2, 2304, 2000
    jc, tc = _caches(jm, tm, B, L, index=idx, seed=4)
    valid = np.zeros((B, L), bool)
    valid[:, :idx + 1] = True
    valid[1, :5] = False
    x = np.random.default_rng(5).normal(size=(B, 1, DIM)).astype(np.float32)
    kw = {"positions": np.full((B, 1), idx), "mask": valid[:, None, None, :]}
    calls = []
    real = tattn.decode_attention_blockwise
    monkeypatch.setattr(tattn, "decode_attention_blockwise",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    if hint:
        tc["frontier"] = (idx, idx)
    jout, tout, jc, tc = _apply(jm, p, tm, jc, tc, x, **kw)
    assert calls == [idx + 1 if hint else L + 1]
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)
    _same_cache(jc, tc)
    monkeypatch.setattr(tattn, "DECODE_BLOCK", 4096)  # full width
    tc["index"] = torch.tensor(idx, dtype=torch.int32)
    with torch.no_grad():
        full, _ = tm(torch.from_numpy(x), cache=tc,
                     positions=torch.from_numpy(kw["positions"]),
                     mask=torch.from_numpy(kw["mask"]))
    assert len(calls) == 1
    np.testing.assert_allclose(full.numpy(), jout, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 3])
def test_per_row_writes_drop_at_capacity(T):
    """Per-row [B] indices: row 0 mid-region, row 1 one slot short of
    capacity (a T > 1 write crosses it), row 2 already full. Kept writes
    land, dropped ones leave every slot alone; outputs and caches match
    the JAX module's mode="drop" scatter."""
    jm, p, tm = _pair()
    B, L = 3, 8
    index = [2, L - 1, L]
    jc, tc = _caches(jm, tm, B, L, index=index, seed=2)
    before = tc["k"].clone()
    valid = np.arange(L)[None, :] < np.minimum(np.array(index) + T, L)[:, None]
    valid[0, 0] = False
    x = np.random.default_rng(3).normal(size=(B, T, DIM)).astype(np.float32)
    pos = np.array(index)[:, None] + np.arange(T)[None, :]
    jout, tout, jc, tc = _apply(jm, p, tm, jc, tc, x, positions=pos,
                                mask=valid[:, None, None, :])
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)
    _same_cache(jc, tc)
    np.testing.assert_array_equal(tc["index"].numpy(), np.array(index) + T)
    np.testing.assert_array_equal(tc["k"][2].numpy(), before[2].numpy())
    np.testing.assert_array_equal(tc["k"][1, :L - 1].numpy(),
                                  before[1, :L - 1].numpy())
    assert not np.array_equal(tc["k"][1, L - 1].numpy(), before[1, L - 1].numpy())


def test_ring_wraps_and_a_write_crosses_its_edge():
    """A ring of 8: a 4-token write at index 6 lands in slots 6, 7, 0, 1;
    then decode steps keep wrapping; the caller's slot-position mask is
    the only authority, as in the JAX module."""
    jm, p, tm = _pair(window=5)
    B, L = 2, 8
    jc, tc = _caches(jm, tm, B, L, rolling=True, index=6, seed=6)
    r = np.random.default_rng(7)
    slot_pos = np.full((B, L), -1)
    slot_pos[:, :6] = np.arange(6)
    for T, at in ((4, 6), (1, 10), (1, 11)):
        pos = np.tile(np.arange(at, at + T), (B, 1))
        for t in range(T):
            slot_pos[:, (at + t) % L] = at + t
        keep = (slot_pos[:, None, :] >= 0) & (slot_pos[:, None, :] <= pos[:, :, None]) \
            & (slot_pos[:, None, :] > pos[:, :, None] - 5)
        x = r.normal(size=(B, T, DIM)).astype(np.float32)
        jout, tout, jc, tc = _apply(jm, p, tm, jc, tc, x, positions=pos,
                                    mask=keep[:, None])
        np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)
        _same_cache(jc, tc)
        assert "rolling" in tc
    assert int(tc["index"]) == 12


def test_ring_write_larger_than_capacity_raises():
    _, _, tm = _pair(window=5)
    tc = tm.init_cache(1, 4, torch.float32, rolling=True)
    x = torch.zeros(1, 5, DIM)
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        tm(x, cache=tc, positions=torch.arange(5)[None],
           mask=torch.ones(1, 1, 5, 4, dtype=torch.bool))


def test_fresh_keys_errors_and_nan_poison():
    jm, p, tm = _pair()
    B, T, L = 1, 3, 8
    x = np.random.default_rng(8).normal(size=(B, T, DIM)).astype(np.float32)
    pos = np.arange(T)[None]
    tc = tm.init_cache(B, L, torch.float32)
    with pytest.raises(ValueError, match="fresh_keys=True needs a T-wide mask"):
        tm(torch.from_numpy(x), cache=tc, positions=torch.from_numpy(pos),
           fresh_keys=True)
    with pytest.raises(ValueError, match="cache-width mask"):
        tm(torch.from_numpy(x), cache=tc, positions=torch.from_numpy(pos),
           mask=torch.ones(1, 1, T, T, dtype=torch.bool), fresh_keys=False)
    # a fresh write at index > 0 would drop the cached context: poisoned
    causal = np.tril(np.ones((T, T), bool))[None, None]
    jc, tc = _caches(jm, tm, B, L, index=2)
    jout, tout, _, _ = _apply(jm, p, tm, jc, tc, x, positions=pos + 2,
                              mask=causal)
    assert np.isnan(jout).all() and np.isnan(tout).all()
    jc, tc = _caches(jm, tm, B, L, index=0)
    jout, tout, _, _ = _apply(jm, p, tm, jc, tc, x, positions=pos,
                              mask=causal)
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)


def test_fused_norm_only_on_eval_decode_steps(monkeypatch):
    """A cached T == 1 step launches B4 in eval and takes the unfused
    residual + norm in training, as the reference's ``not train`` gate."""
    calls = []
    real = ttrans.fused_residual_norm
    monkeypatch.setattr(ttrans, "fused_residual_norm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    blk = TransformerBlock(DIM, H, num_kv_heads=HKV, causal=True, rope=True,
                           norm="layer", dropout=0.1)
    x = torch.randn(2, 1, DIM, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for train in (True, False):
            cache = blk.attn.init_cache(2, 8, torch.float32)
            blk(x, cache=cache, positions=torch.zeros(2, 1, dtype=torch.long),
                rng=gen, train=train)
            assert len(calls) == (0 if train else 1)
