"""PyTorch port, ops/paged_decode.py: the plain ``paged_decode_reference``
against the JAX package's ``paged_decode_reference`` on the same inputs
(f32, atol 1e-5: the same gather/mask/softmax, einsum sums in another
order) at the decode and prefill forms, the wrapper's CPU dispatch, and
its host-side logic: which kernel variant takes a call and how each
row's view is cut into key partitions.

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
    DECODE_PARTITION,
    PREFILL_ROWS,
    PREFILL_TARGET_BLOCKS,
    STAGE_KEYS,
    VARIANTS,
    kernel_variant,
    paged_decode_attention,
    paged_decode_reference,
    partition_plan,
    workspace_elems,
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


@pytest.mark.parametrize("pool", ["f16", "int8"])
@pytest.mark.parametrize("T,masked,window", [(1, True, None), (5, False, 3)])
def test_reference_matches_jax_f16(T, masked, window, pool):
    """The f16 form (the card's decode and prefill variants): f16 q over
    an f16 or int8 pool, the same tensors into both, within 1e-3 of max
    |JAX| (both compute in f32 and round the output to f16 once, 2^-11 ~
    4.9e-4)."""
    q, k, v, bt, lengths, ks, vs, mask = _inputs(T, 4, 2, masked, pool == "int8")
    q = q.astype(np.float16)
    if pool == "f16":
        k, v = k.astype(np.float16), v.astype(np.float16)
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
    )
    assert out.dtype == torch.float16 and ref.dtype == np.float16
    out, ref = out.float().numpy(), ref.astype(np.float32)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()
    if masked:
        assert not out[1].any()  # the fully masked row


@pytest.mark.parametrize("T", [1, 5])
def test_f16_over_int8_small_v_matches_jax(T):
    """f16 q over int8 pools whose V has absmax near 1e-4 (v_scale =
    absmax / 127 near 8e-7, where p v_scale sinks below f16's normal
    range: the card's kernel scales P's rows against it): the plain
    version against the JAX reference on the same numpy inputs, within
    1e-3 of max |JAX| (f32 math both sides, one f16 rounding of an output
    near 1e-4), and not flushed to zero."""
    q, k, v, bt, lengths, ks, vs, mask = _inputs(T, 4, 2, True, True, seed=3)
    q = q.astype(np.float16)
    vs = ((1e-4 / 127) * (0.5 + vs * 25)).astype(np.float32)
    assert 5e-5 < 127 * vs.max() <= 1e-4
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        mask=jnp.asarray(mask),
    ))
    out = paged_decode_attention(
        _torch(q), _torch(k), _torch(v), _torch(bt), _torch(lengths),
        k_scale=_torch(ks), v_scale=_torch(vs), mask=_torch(mask),
    )
    assert out.dtype == torch.float16 and ref.dtype == np.float16
    out, ref = out.float().numpy(), ref.astype(np.float32)
    assert 1e-6 < np.abs(ref).max() <= 1e-4
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()
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


# the prefill form: one row (the engine's chunk), T a multiple of the
# kernel's 64-row tile at GQA group 4 (16 query positions per tile), block
# size 16, a live length over several pages with a sentinel tail
P_H, P_HKV, P_D, P_BS, P_MB, P_NB = 8, 2, 64, 16, 14, 20


def _prefill_inputs(T, length, int8, seed=1):
    r = np.random.default_rng(seed)
    bt = np.full((1, P_MB), P_NB, np.int32)
    n = -(-length // P_BS)
    bt[0, :n] = r.permutation(P_NB)[:n]
    q = r.normal(size=(1, T, P_H, P_D)).astype(np.float32)
    shape = (P_NB, P_BS, P_HKV, P_D)
    if int8:
        k = r.integers(-127, 128, shape).astype(np.int8)
        v = r.integers(-127, 128, shape).astype(np.int8)
        ks = (r.random(shape[:3]) / 50).astype(np.float32)
        vs = (r.random(shape[:3]) / 50).astype(np.float32)
    else:
        k = r.normal(size=shape).astype(np.float32)
        v = r.normal(size=shape).astype(np.float32)
        ks = vs = None
    return q, k, v, bt, np.array([length], np.int32), ks, vs


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [None, 40], ids=["nowin", "win40"])
@pytest.mark.parametrize("T,length", [(32, 32), (32, 150), (64, 200)])
def test_prefill_form_matches_jax(T, length, window, int8):
    """The plain version at the prefill form (what chip_smoke.py holds the
    prefill variant against) vs the JAX reference, f32, atol 1e-5."""
    q, k, v, bt, lengths, ks, vs = _prefill_inputs(T, length, int8)
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lengths),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), window=window,
    ))
    out = paged_decode_attention(
        _torch(q), _torch(k), _torch(v), _torch(bt), _torch(lengths),
        k_scale=_torch(ks), v_scale=_torch(vs), window=window,
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the same call in the kernel's types takes the prefill variant
    kv = torch.int8 if int8 else torch.bfloat16
    assert kernel_variant(torch.bfloat16, kv, T, P_H, P_HKV, P_D,
                          P_MB * P_BS, False) == "prefill"


@pytest.mark.parametrize(
    "q_dtype,kv_dtype,T,H,Hkv,D,Lv,masked,want",
    [
        # the engine's decode step and prefill chunk (Llama-3-8B heads)
        (torch.bfloat16, torch.bfloat16, 1, 32, 8, 128, 2048, True, "decode"),
        (torch.bfloat16, torch.bfloat16, 128, 32, 8, 128, 2048, False, "prefill"),
        (torch.bfloat16, torch.int8, 1, 32, 8, 128, 2048, True, "decode"),
        (torch.bfloat16, torch.int8, 128, 32, 8, 128, 2048, False, "prefill"),
        # speculative verify rows: T * group up to 16 stays decode
        (torch.bfloat16, torch.bfloat16, 4, 32, 8, 128, 2048, True, "decode"),
        (torch.bfloat16, torch.bfloat16, 5, 32, 8, 128, 2048, True, "prefill"),
        (torch.bfloat16, torch.bfloat16, 1, 16, 1, 64, 512, False, "decode"),
        (torch.bfloat16, torch.bfloat16, 1, 32, 1, 64, 512, False, "prefill"),
        # outside the tensor-core variants
        (torch.float32, torch.bfloat16, 1, 32, 8, 128, 2048, True, "general"),
        (torch.bfloat16, torch.float32, 1, 32, 8, 128, 2048, True, "general"),
        (torch.bfloat16, torch.bfloat16, 1, 32, 8, 96, 2048, True, "general"),
        (torch.bfloat16, torch.bfloat16, 1, 4, 2, 8, 16, False, "general"),
        (torch.bfloat16, torch.bfloat16, 1, 32, 8, 128, 2040, True, "general"),
        (torch.bfloat16, torch.bfloat16, 1, 32, 8, 128, 2040, False, "decode"),
        # f16 q over f16 or int8 pools takes the tensor-core variants as
        # bf16 does; mixed 16-bit pairs and other head dims stay general
        (torch.float16, torch.float16, 1, 32, 8, 128, 2048, True, "decode"),
        (torch.float16, torch.float16, 128, 32, 8, 128, 2048, False, "prefill"),
        (torch.float16, torch.int8, 1, 32, 8, 128, 2048, False, "decode"),
        (torch.float16, torch.int8, 128, 32, 8, 128, 2048, True, "prefill"),
        (torch.float16, torch.float16, 5, 32, 8, 128, 2048, True, "prefill"),
        (torch.float16, torch.float16, 1, 32, 8, 96, 2048, True, "general"),
        (torch.float16, torch.float16, 1, 32, 8, 128, 2040, True, "general"),
        (torch.float16, torch.bfloat16, 4, 32, 8, 64, 2048, True, "general"),
        (torch.bfloat16, torch.float16, 1, 32, 8, 128, 2048, True, "general"),
        (torch.float16, torch.float32, 1, 32, 8, 128, 2048, True, "general"),
    ],
)
def test_kernel_variant(q_dtype, kv_dtype, T, H, Hkv, D, Lv, masked, want):
    assert kernel_variant(q_dtype, kv_dtype, T, H, Hkv, D, Lv, masked) == want


@pytest.mark.parametrize("variant", ["decode", "prefill"])
@pytest.mark.parametrize(
    "B,T,H,Hkv,Lv",
    [(8, 1, 32, 8, 2048), (1, 128, 32, 8, 2048), (8, 128, 32, 8, 2048),
     (1, 1, 32, 8, 2048), (3, 1, 8, 2, 100), (1, 64, 8, 8, 64), (2, 7, 4, 4, 1000)],
)
def test_partition_plan_respects_kernel_limits(variant, B, T, H, Hkv, Lv):
    """Partitions are whole 64-key stages, cover the view exactly once,
    and (prefill) split only until the grid reaches the target."""
    kp, nsplit = partition_plan(variant, B, T, H, Hkv, Lv)
    assert kp >= STAGE_KEYS and kp % STAGE_KEYS == 0
    assert (nsplit - 1) * kp < Lv <= nsplit * kp
    if variant == "decode":
        assert kp == DECODE_PARTITION
    else:
        base = -(-T // (PREFILL_ROWS // (H // Hkv))) * Hkv * B
        if nsplit > 1:  # split only while the grid fits the target
            assert base * nsplit <= PREFILL_TARGET_BLOCKS
    n = workspace_elems(B, T, H, 128, nsplit)
    assert n == (0 if nsplit == 1 else B * T * H * nsplit * 130)


def test_partition_plan_of_the_engine_shapes():
    # decode: 8 fixed partitions of 256 keys over a 2048-key view
    assert partition_plan("decode", 8, 1, 32, 8, 2048) == (256, 8)
    # one prefill chunk: 8 tiles x 8 kv heads = 64 blocks, split 4 ways
    assert partition_plan("prefill", 1, 128, 32, 8, 2048) == (512, 4)
    # eight rows of chunks fill the card unsplit
    assert partition_plan("prefill", 8, 128, 32, 8, 2048) == (2048, 1)
    # the general variant keeps the first design's even split of live keys
    assert partition_plan("general", 8, 1, 32, 8, 2048) == (0, 9)
    assert partition_plan("general", 128, 1, 32, 8, 2048) == (0, 1)


def test_cpu_calls_count_no_variant_launch():
    q, k, v, bt, lengths, ks, vs = _prefill_inputs(32, 150, False)
    before = dict(paged_decode_attention.launches_by_variant)
    paged_decode_attention(_torch(q), _torch(k), _torch(v), _torch(bt),
                           _torch(lengths))
    assert paged_decode_attention.launches_by_variant == before
    assert set(before) == set(VARIANTS)
