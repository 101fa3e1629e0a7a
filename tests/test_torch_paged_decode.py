"""PyTorch port, ops/paged_decode.py: the plain ``paged_decode_reference``
against the JAX package's ``paged_decode_reference`` on the same inputs
(f32, atol 1e-5: the same gather/mask/softmax, einsum sums in another
order), and the wrapper's CPU dispatch.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.ops.pallas.paged_decode import (
    paged_decode_reference as jax_reference,
)
from tensorlink_tpu_torch.ops.paged_decode import (
    paged_decode_attention,
    paged_decode_reference,
)

ATOL = 1e-5
NB, BS, MB, D, B = 12, 4, 4, 8, 3


def _inputs(T, H, Hkv, masked, int8, seed=0):
    r = np.random.default_rng(seed)
    # row 0 short, row 1 mid, row 2 fills the view; unmapped tails keep
    # the sentinel NB
    lengths = np.array([T, 6 + T, MB * BS], np.int32).clip(max=MB * BS)
    perm = r.permutation(NB)
    bt = np.full((B, MB), NB, np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // BS)
        bt[b, :n] = perm[used:used + n] % NB
        used += n
    q = r.normal(size=(B, T, H, D)).astype(np.float32)
    if int8:
        k = r.integers(-127, 128, (NB, BS, Hkv, D)).astype(np.int8)
        v = r.integers(-127, 128, (NB, BS, Hkv, D)).astype(np.int8)
        ks = (r.random((NB, BS, Hkv)) / 50).astype(np.float32)
        vs = (r.random((NB, BS, Hkv)) / 50).astype(np.float32)
    else:
        k = r.normal(size=(NB, BS, Hkv, D)).astype(np.float32)
        v = r.normal(size=(NB, BS, Hkv, D)).astype(np.float32)
        ks = vs = None
    mask = None
    if masked:
        mask = r.random((B, 1, T, MB * BS)) > 0.3
        mask[1] = False  # a fully masked row: exact zeros
    return q, k, v, bt, lengths, ks, vs, mask


def _torch(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("window", [None, 3], ids=["nowin", "win3"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("T", [1, 5])
def test_reference_matches_jax(T, heads, window, masked, int8):
    H, Hkv = heads
    q, k, v, bt, lengths, ks, vs, mask = _inputs(T, H, Hkv, masked, int8)
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lengths),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        mask=None if mask is None else jnp.asarray(mask), window=window,
    ))
    out = paged_decode_reference(
        _torch(q), _torch(k), _torch(v), _torch(bt), _torch(lengths),
        k_scale=_torch(ks), v_scale=_torch(vs), mask=_torch(mask),
        window=window,
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if masked:
        assert not out[1].any()  # the fully masked row


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    q, k, v, bt, lengths, ks, vs, mask = _inputs(5, 4, 2, True, True)
    args = (_torch(q), _torch(k), _torch(v), _torch(bt), _torch(lengths))
    kw = {"k_scale": _torch(ks), "v_scale": _torch(vs), "mask": _torch(mask),
          "window": 3}
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, **kw)
    torch.testing.assert_close(out, paged_decode_reference(*args, **kw),
                               rtol=0, atol=0)
    assert paged_decode_attention.launches == before == 0


def test_wrapper_rejects_what_it_cannot_run():
    q, k, v, bt, lengths, ks, vs, _ = _inputs(1, 4, 2, False, True)
    args = (_torch(q), _torch(k), _torch(v), _torch(bt), _torch(lengths))
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention(*args, k_scale=_torch(ks))
    with pytest.raises(ValueError, match="view-width"):
        paged_decode_attention(
            *args, k_scale=_torch(ks), v_scale=_torch(vs),
            mask=torch.ones((B, 1, 1, 3), dtype=torch.bool),
        )
    # no silent fallback for a device that is neither CPU nor CUDA
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="device"):
        paged_decode_attention(*meta)
