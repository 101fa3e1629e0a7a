"""PyTorch port, B1/B2 at head dims other than 64 and 128
(``ops/flash_attention.py``), against the JAX package on the same seeded
inputs (f32, CPU).

The CUDA kernels are built for D 64, 128 and 256; their launchers
zero-pad any other D up to 256 to the next of them, run the kernel at the
true D's scale and slice the outputs back. These tests hold the pieces of
that on the CPU, where nothing is built or launched:

- the port's plain B1 and B2 (own delta, and a given delta =
  rowsum(do o), the ring's form) at D 32, 80, 96, 160 and 256 against
  the Pallas kernels in interpret mode, blocks of 64 (o and lse within
  2e-5, gradients within 1e-4, as ``test_torch_flash.py``);
- "zero-pad, plain at the true scale, slice" equal to the plain version
  at D for o, lse, dq, dk and dv (the padded columns of every output
  exactly zero): the exactness the launchers rely on;
- the launchers' pad and slice helpers give views ``_check_views``
  accepts, also when a sliced output is fed back (the ring passes o and
  do to B2);
- D above 256 is refused with its message before anything is built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.ops.pallas.flash_attention import (
    flash_attention_bwd as j_bwd,
    flash_attention_fwd_lse as j_fwd,
)
from tensorlink_tpu_torch.ops import flash_attention as tfa
from tensorlink_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd_lse,
    flash_attention_fwd_lse_reference,
)

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
PAD_TOL = 1e-6  # f32 sums with zero terms added, taken in another order

# name: (B, H, Hkv, T, D, causal, window, mask)
CASES = {
    "d32": (2, 2, 2, 128, 32, False, None, "rows"),
    "d80_gqa_window": (1, 4, 2, 192, 80, True, 50, None),
    "d96": (2, 4, 4, 128, 96, True, None, "rows"),
    "d160_gqa": (1, 4, 2, 128, 160, False, None, "rows"),
    "d256": (1, 2, 2, 128, 256, True, None, None),
}
# the cases whose D the kernels are not built for: zero-padded
PADDED = [n for n, c in CASES.items() if c[4] not in tfa.HEAD_DIMS]


def _inputs(B, H, Hkv, T, D, mask, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, T, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, T, D)).astype(np.float32)
    do = r.standard_normal((B, H, T, D)).astype(np.float32)
    kv = None
    if mask == "rows":
        kv = (r.random((B, T)) > 0.3).astype(np.float32)
        kv[0, T // 2:] = 0.0  # a row padded to half its length
    return q, k, v, do, kv


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_kernels_match_pallas_interpret_at_head_dim(name):
    B, H, Hkv, T, D, causal, window, mask = CASES[name]
    q, k, v, do, kv = _inputs(B, H, Hkv, T, D, mask)
    kw = {"causal": causal, "window": window}
    jo, jlse = j_fwd(_j(q), _j(k), _j(v), _j(kv), block_q=64, block_k=64,
                     interpret=True, **kw)
    to, tlse = flash_attention_fwd_lse(_t(q), _t(k), _t(v), _t(kv), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=FWD_TOL)
    jg = j_bwd(_j(q), _j(k), _j(v), jo, jlse, _j(do), _j(kv), block_q=64,
               block_k=64, interpret=True, **kw)
    # the reference's delta, rowsum(do o), given as the ring gives it
    delta = (_t(do) * torch.from_numpy(np.array(jo))).sum(dim=-1)
    for given in (None, delta):
        tg = flash_attention_bwd(_t(q), _t(k), _t(v), to, tlse, _t(do), _t(kv),
                                 delta=given, **kw)
        for n, a, b in zip(("dq", "dk", "dv"), tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("name", PADDED)
def test_zero_padded_plain_at_true_scale_equals_plain(name):
    B, H, Hkv, T, D, causal, window, mask = CASES[name]
    q, k, v, do, kv = (_t(x) for x in _inputs(B, H, Hkv, T, D, mask, seed=1))
    kw = {"causal": causal, "window": window}
    Dk = tfa._kernel_dim(D)
    assert Dk in tfa.HEAD_DIMS and Dk > D
    pq, pk, pv, pdo = (tfa._padded(x, Dk) for x in (q, k, v, do))
    assert pq.shape[-1] == Dk and torch.equal(pq[..., :D], q)
    assert not pq[..., D:].any()
    o, lse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
    po, plse = flash_attention_fwd_lse_reference(pq, pk, pv, kv, scale=D ** -0.5, **kw)
    torch.testing.assert_close(po[..., :D], o, atol=PAD_TOL, rtol=PAD_TOL)
    torch.testing.assert_close(plse, lse, atol=PAD_TOL, rtol=PAD_TOL)
    assert not po[..., D:].any()
    delta = (do * o).sum(dim=-1)
    for given in (None, delta):
        g = flash_attention_bwd_reference(q, k, v, o, lse, do, kv, delta=given, **kw)
        pg = flash_attention_bwd_reference(pq, pk, pv, tfa._padded(o, Dk), plse, pdo,
                                           kv, delta=given, scale=D ** -0.5, **kw)
        for n, a, b in zip(("dq", "dk", "dv"), pg, g):
            torch.testing.assert_close(a[..., :D], b, atol=PAD_TOL, rtol=PAD_TOL,
                                       msg=n)
            assert not a[..., D:].any(), n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("D", [32, 80, 96, 64, 128, 160, 256])
def test_pad_and_slice_keep_the_kernel_view_rules(D, dtype):
    """The launchers' inputs (``_padded``) and outputs (``_sliced``) are
    views the kernels read and write (``_check_views``), and a sliced
    output fed back through ``_padded`` is one again; a D the kernels are
    built for passes through uncopied. Checked on CPU views: nothing is
    built or launched."""
    B, H, T = 2, 4, 96
    x = torch.randn((B, T, H, D)).to(dtype).transpose(1, 2)  # the layout callers pass
    Dk = tfa._kernel_dim(D)
    px = tfa._padded(x, Dk)
    assert (px is x) == (D == Dk)
    assert tfa._check_views(px, {"q": px})[0] == tfa.KERNEL_FORMS[dtype][0]
    full, out = tfa._sliced(B, T, H, D, Dk, dtype, x.device)
    assert full.shape == (B, H, T, Dk) and out.shape == (B, H, T, D)
    assert out.data_ptr() == full.data_ptr()
    tfa._check_views(full, {"o": full})
    out.copy_(x)
    again = tfa._padded(out, Dk)
    tfa._check_views(again, {"o": again, "q": px})
    assert torch.equal(again[..., :D], x)


def test_kernel_dims_above_128():
    """D in (128, 256] runs on the D 256 kernels: 256 as built, any other
    zero-padded to it; D up to 128 keeps the kernels it had."""
    assert tfa.MAX_HEAD_DIM == 256 and tfa.HEAD_DIMS == (64, 128, 256)
    assert tfa._kernel_dim(160) == 256 and tfa._kernel_dim(256) == 256
    assert tfa._kernel_dim(129) == 256 and tfa._kernel_dim(128) == 128
    assert tfa._kernel_dim(96) == 128 and tfa._kernel_dim(64) == 64


@pytest.mark.parametrize("D", [257, 320])
def test_head_dims_above_256_refused(D):
    """D above 256 has no kernel (the paged kernel stops there too): the
    launchers refuse it with its message before they build or launch
    anything."""
    with pytest.raises(ValueError, match=f"head dim {D} \\(kernels take D <= 256"):
        tfa._kernel_dim(D)
    B, H, T = 1, 2, 64
    q = torch.zeros((B, H, T, D), dtype=torch.bfloat16)
    lse = torch.zeros((B, H, T))
    with pytest.raises(ValueError, match=f"head dim {D}"):
        tfa._launch_fwd(q, q, q, None, False, None)
    with pytest.raises(ValueError, match=f"head dim {D}"):
        tfa._launch_bwd(q, q, q, q, lse, q, None, False, None)
