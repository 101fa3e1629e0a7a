"""PyTorch port, ops/flash_attention.py (B1, B2) and ops/flash.py, against
the JAX package on the same seeded inputs (f32, CPU).

- the port's plain B1 and B2 (what its wrappers run for CPU tensors, and
  what ``chip_smoke.py`` holds the CUDA kernels against) against the
  Pallas kernels in interpret mode, blocks of 64 so every case spans
  several blocks: o and lse within atol/rtol 2e-5, dq/dk/dv within 1e-4
  (f32 sums of up to 256 terms, taken in another order); and, fed the same
  f16 tensors (``:f16`` cases), o within 1e-3 and dq/dk/dv within 5e-3 of
  max |Pallas| (both compute in f32 and round each output to f16 once,
  2^-11 ~ 4.9e-4 of it, at points the two sums reach in another order);
- ``flash_attention``'s autograd gradients against ``jax.grad`` of the JAX
  ``flash_attention(..., interpret=True)`` (1e-4);
- the fully-masked-row rule of ``_fallback_attn`` (exact zeros);
- ``flash_attention_impl``'s routing decision against the reference's,
  on the same shapes and mask forms;
- the block-override registry's validation;
- the forward launcher's refusal of views its TMA tensor maps cannot
  address (raised before any build, so it runs here on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.ops import flash as jflash
from tensorlink_tpu.ops.pallas.flash_attention import (
    flash_attention_bwd as j_bwd,
    flash_attention_fwd_lse as j_fwd,
)
from tensorlink_tpu_torch.ops import flash as tflash
from tensorlink_tpu_torch.ops import flash_attention as tfa
from tensorlink_tpu_torch.ops.flash_attention import (
    KERNEL_BLOCK,
    flash_attention_bwd,
    flash_attention_fwd_lse,
)

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
F16_O_REL, F16_GRAD_REL = 1e-3, 5e-3  # of max |Pallas|, f16 outputs

# name: (B, H, Hkv, T, D, causal, window, mask)
CASES = {
    "plain": (1, 2, 2, 128, 64, False, None, None),
    "kv_mask_masked_row": (2, 2, 2, 128, 64, False, None, "rows"),
    "causal": (1, 2, 2, 256, 64, True, None, None),
    "causal_window": (1, 2, 2, 256, 64, True, 70, "rows"),
    "gqa": (1, 4, 2, 128, 64, True, None, "rows"),
    "d128": (1, 2, 2, 128, 128, False, None, "rows"),
    "gqa_d128_window": (1, 4, 2, 192, 128, True, 50, None),
}
# the f16 cases: every key of a B 1 "rows" case is masked (o and the
# gradients are exact zeros in any dtype), so these hold live rows
F16_CASES = ("plain", "kv_mask_masked_row", "causal", "gqa_d128_window")


def _inputs(B, H, Hkv, T, D, mask, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, T, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, T, D)).astype(np.float32)
    do = r.standard_normal((B, H, T, D)).astype(np.float32)
    kv = None
    if mask == "rows":
        kv = (r.random((B, T)) > 0.3).astype(np.float32)
        kv[-1] = 0.0  # a batch row whose every key is masked
        if B > 1:
            kv[0, T // 2:] = 0.0  # and one padded to half its length
    return q, k, v, do, kv


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize(
    "name", list(CASES) + [f"{n}:f16" for n in F16_CASES])
def test_plain_kernels_match_pallas_interpret(name):
    name, _, form = name.partition(":")
    B, H, Hkv, T, D, causal, window, mask = CASES[name]
    q, k, v, do, kv = _inputs(B, H, Hkv, T, D, mask)
    if form == "f16":  # the same f16 tensors into both
        q, k, v, do = (x.astype(np.float16) for x in (q, k, v, do))
    kw = {"causal": causal, "window": window}
    jo, jlse = j_fwd(_j(q), _j(k), _j(v), _j(kv), block_q=64, block_k=64,
                     interpret=True, **kw)
    to, tlse = flash_attention_fwd_lse(_t(q), _t(k), _t(v), _t(kv), **kw)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)
    if form == "f16":
        assert to.dtype == torch.float16 and jo.dtype == jnp.float16
        assert _rel_to_max(to.numpy(), jo) <= F16_O_REL
    else:
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)

    jg = j_bwd(_j(q), _j(k), _j(v), jo, jlse, _j(do), _j(kv), block_q=64,
               block_k=64, interpret=True, **kw)
    tg = flash_attention_bwd(_t(q), _t(k), _t(v), to, tlse, _t(do), _t(kv), **kw)
    for name_, a, b in zip(("dq", "dk", "dv"), tg, jg):
        if form == "f16":
            assert a.dtype == torch.float16, name_
            assert _rel_to_max(a.numpy(), b) <= F16_GRAD_REL, name_
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name_)


def test_flash_attention_grads_match_jax_grad():
    """[B, T, H, D] autograd through the port's Function (B1 forward, B2
    backward) against jax.grad through the JAX custom_vjp."""
    B, H, Hkv, T, D = 2, 4, 2, 128, 64
    q, k, v, w, kv = _inputs(B, H, Hkv, T, D, "rows", seed=1)
    q, k, v, w = (x.swapaxes(1, 2).copy() for x in (q, k, v, w))

    def jloss(q_, k_, v_):
        o = jflash.flash_attention(q_, k_, v_, jnp.asarray(kv), True, True, None)
        return jnp.sum(o * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, torch.from_numpy(kv), True, None)
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 9)])
def test_fallback_zeros_fully_masked_rows(causal, window):
    """Off the kernel rule (T 100) both packages take _fallback_attn:
    a row whose visible keys are all masked outputs exact zeros."""
    B, H, T, D = 2, 2, 100, 16
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    kv = (r.random((B, T)) > 0.5).astype(np.float32)
    kv[0] = 0.0
    kv[1, :20] = 0.0  # causal rows 0..19 of row 1 see no valid key
    ref = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv),
        causal, False, window))
    out = tflash.flash_attention(_t(q), _t(k), _t(v), _t(kv), causal, window)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert not out[0].any()


# (Tq, Tk, mask form, q_offset, min_kernel_seq)
ROUTES = [
    (512, 512, None, 0, None),
    (256, 256, None, 0, None),
    (256, 256, None, 0, 0),
    (100, 100, None, 0, 0),
    (64, 64, "kv", 0, 0),
    (512, 512, "kv", 0, None),
    (512, 512, "kv1", 0, None),
    (512, 512, "full", 0, None),
    (512, 512, "heads", 0, None),
    (512, 512, None, 3, None),
    (128, 256, None, 0, 0),
]


def _mask(form, B, H, Tq, Tk, r):
    if form is None:
        return None
    shape = {"kv": (B, 1, 1, Tk), "kv1": (1, 1, 1, Tk),
             "full": (B, 1, Tq, Tk), "heads": (B, H, 1, Tk)}[form]
    m = r.random(shape) > 0.2
    m[..., 0] = True
    return m


@pytest.mark.parametrize("route", ROUTES, ids=[str(r) for r in ROUTES])
def test_routing_matches_reference(route, monkeypatch):
    Tq, Tk, form, q_offset, min_seq = route
    B, H, D = 2, 2, 8
    r = np.random.default_rng(3)
    q = r.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Tk, H, D)).astype(np.float32)
    mask = _mask(form, B, H, Tq, Tk, r)
    seen = {}

    def spy(tag):
        def f(q_, k_, v_, kv_mask=None, causal=False, *rest):
            seen[tag] = None if kv_mask is None else np.asarray(kv_mask)
            return q_
        return f

    monkeypatch.setattr(jflash, "flash_attention", spy("jax"))
    monkeypatch.setattr(tflash, "flash_attention", spy("port"))
    kw = {} if min_seq is None else {"min_kernel_seq": min_seq}
    jflash.flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), causal=True,
        mask=None if mask is None else jnp.asarray(mask), q_offset=q_offset,
        interpret=True, **kw)
    tflash.flash_attention_impl(
        _t(q), _t(k), _t(k), causal=True, mask=_t(mask), q_offset=q_offset, **kw)
    assert ("jax" in seen) == ("port" in seen), seen.keys()
    if "jax" in seen and seen["jax"] is not None:
        np.testing.assert_array_equal(seen["port"], seen["jax"])


def test_block_override_registry():
    tflash.clear_flash_block_overrides()
    try:
        assert tflash.flash_block_for(512) == KERNEL_BLOCK
        tflash.set_flash_block_override(512, 64)
        tflash.set_flash_block_override(1024, 64, batch=8)
        assert tflash.flash_block_for(512, 8) == 64
        assert tflash.flash_block_for(1024, 8) == 64
        assert tflash.flash_block_for(1024, 2) == KERNEL_BLOCK
        assert tflash.flash_block_overrides() == [(512, None, 64), (1024, 8, 64)]
        with pytest.raises(ValueError, match="divide"):
            tflash.set_flash_block_override(512, 96)
        with pytest.raises(ValueError, match="divide"):
            tflash.set_flash_block_override(512, 0)
        # divides, but the CUDA kernel has one tile: refused when set
        with pytest.raises(ValueError, match="CUDA kernel"):
            tflash.set_flash_block_override(512, 128)
    finally:
        tflash.clear_flash_block_overrides()
    assert tflash.flash_block_overrides() == []
    assert tflash.flash_block_for(512) == KERNEL_BLOCK


@pytest.mark.parametrize("fault", ["base_pointer", "t_stride"])
def test_forward_launcher_raises_on_views_tma_cannot_address(fault):
    """B1's forward reads q, k and v through TMA tensor maps, which need a
    16-byte aligned base and strides that are multiples of 16 bytes. Its
    launcher raises on any other view (before it builds or launches
    anything) instead of routing it elsewhere."""
    B, H, T, D = 1, 2, 128, 64
    good = torch.zeros((B, T, H, D), dtype=torch.bfloat16).transpose(1, 2)
    buf = torch.zeros(B * T * (H * D + 4) + 8, dtype=torch.bfloat16)
    if fault == "base_pointer":  # one element (2 bytes) off an aligned base
        bad = torch.as_strided(buf, (B, H, T, D), (T * H * D, D, H * D, 1), 1)
    else:  # rows of H * D + 4 elements: a T stride of 264 bytes
        bad = torch.as_strided(buf, (B, H, T, D),
                               (T * (H * D + 4), D, H * D + 4, 1))
    assert buf.data_ptr() % 16 == 0
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="TMA"):
            tfa._launch_fwd(*args, None, False, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_kernel_dtype_rule(dtype):
    """The kernels' dtype rule: bf16 and f16 views go to
    csrc/flash_attention.cu (its "bf16" and "f16" instantiations, both on
    the 16-bit tensor cores with f32 sums), f32 views to
    csrc/flash_attention_f32.cu's "f32" form (an f32 or f16 model keeps
    the precision the reference's kernels give it: they compute in f32
    whatever their inputs), and any other dtype is refused with its
    message. Checked on CPU views: nothing is built or launched, and no
    launch is counted."""
    B, H, T, D = 2, 4, 512, 64
    q, k, v, do, o = (torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)
                      for _ in range(5))
    views = {"q": q, "k": k, "v": v, "do": do, "o": o}
    counts = (dict(flash_attention_fwd_lse.launches_by_variant),
              dict(flash_attention_bwd.launches_by_variant))
    form, source, suffix = tfa._check_views(q, views)
    assert (form, source, suffix) == {
        torch.bfloat16: ("bf16", "flash_attention.cu", ""),
        torch.float32: ("f32", "flash_attention_f32.cu", "_f32"),
        torch.float16: ("f16", "flash_attention.cu", "_f16"),
    }[dtype]
    # every view must share q's dtype
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="k dtype"):
        tfa._check_views(q, dict(views, k=k.to(other)))
    f64 = {n: x.double() for n, x in views.items()}
    with pytest.raises(ValueError,
                       match=r"q dtype torch.float64 \(bfloat16, float32 or float16\)"):
        tfa._check_views(f64["q"], f64)
    assert counts == (flash_attention_fwd_lse.launches_by_variant,
                      flash_attention_bwd.launches_by_variant)
    assert set(counts[0]) == set(counts[1]) == {"bf16", "f32", "f16"}


def test_f32_no_cache_attention_routes_to_the_kernel_pair(monkeypatch):
    """The route is the reference's and the dtype plays no part in it: an
    f32 no-cache attention at T 512 under ``attn_impl="auto"`` reaches
    ``_FlashAttention`` (B1/B2), as a bf16 one does."""
    calls = []
    real = tflash._FlashAttention.apply
    monkeypatch.setattr(tflash._FlashAttention, "apply",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 512, 2, 64), generator=torch.Generator().manual_seed(0)).to(dtype)
        out = tflash.flash_attention_impl(q, q, q, mask=torch.ones((1, 1, 1, 512), dtype=torch.bool))
        assert out.dtype == dtype
    assert calls == [torch.float32, torch.bfloat16]
