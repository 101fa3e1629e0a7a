"""PyTorch port, ops/decode_glue.py: the plain fused residual+norm against
the JAX package's ``fused_residual_norm``, both its jnp fallback and its
Pallas kernel in interpret mode. Tolerances: f32 atol 1e-6 (same f32
math); bf16 atol 1e-2 (both round the same f32 values to bf16, so they
differ by at most one bf16 ulp at the outputs' magnitude).

The CUDA kernel (``csrc/decode_glue.cu``) runs only on the card:
``chip_smoke.py`` holds it against this plain version there. What its
launch is made of is tested here: ``launch_geometry`` (cluster size,
threads, vector width and vectors a thread holds) covers every element of
a row exactly once within the card's limits, and
``fused_residual_norm_split_reference`` (the kernel's per-slice moments,
merged with Chan's formula in its order) matches the JAX package where
the row's mean is large against its spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.ops.pallas.decode_glue import (
    fused_residual_norm as jax_fused,
)
from tensorlink_tpu_torch.ops import decode_glue
from tensorlink_tpu_torch.ops.decode_glue import (
    fused_residual_norm,
    fused_residual_norm_reference,
    fused_residual_norm_split_reference,
    launch_geometry,
)

D = 128  # lane-aligned, so the JAX kernel engages in interpret mode


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(2, 3, D)).astype(np.float32)
    res = (r.normal(size=(2, 3, D)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * r.normal(size=(D,))).astype(np.float32)
    bias = (0.1 * r.normal(size=(D,))).astype(np.float32)
    return x, res, scale, bias


@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_plain_version_matches_jax(kind, with_bias, dtype, interpret):
    x, res, scale, bias = _inputs()
    b = bias if with_bias else None
    jdt = jnp.dtype(dtype)
    jr, jy = jax_fused(
        jnp.asarray(x, jdt), jnp.asarray(res, jdt), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), eps=1e-5, kind=kind,
        interpret=interpret,
    )
    tdt = getattr(torch, dtype)
    tr, ty = fused_residual_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(res).to(tdt),
        torch.from_numpy(scale), None if b is None else torch.from_numpy(b),
        eps=1e-5, kind=kind,
    )
    assert tr.dtype == ty.dtype == tdt
    atol = 1e-6 if dtype == "float32" else 1e-2
    for t_out, j_out in ((tr, jr), (ty, jy)):
        np.testing.assert_allclose(
            t_out.float().numpy(), np.asarray(j_out.astype(jnp.float32)),
            atol=atol, rtol=0,
        )


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    x, res, scale, bias = _inputs(1)
    args = [torch.from_numpy(a) for a in (x, res, scale, bias)]
    before = fused_residual_norm.launches
    out = fused_residual_norm(*args, kind="layer")
    ref = fused_residual_norm_reference(*args, kind="layer")
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_residual_norm.launches == before == 0


def test_wrapper_rejects_bad_arguments():
    x, res, scale, _ = (torch.from_numpy(a) for a in _inputs(2))
    with pytest.raises(ValueError, match="shape"):
        fused_residual_norm(x, res[:, :2], scale)
    with pytest.raises(ValueError, match="kind"):
        fused_residual_norm(x, res, scale, kind="batch")
    with pytest.raises(ValueError, match="device"):
        fused_residual_norm(x.to("meta"), res.to("meta"), scale.to("meta"))


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "16bit"])
@pytest.mark.parametrize("D", [1, 7, 64, 768, 4096, 4100, 5120, 8192, 65536])
def test_launch_geometry_covers_each_element_once(D, itemsize):
    C, threads, vec, nv = launch_geometry(D, itemsize)
    # the card's limits and the kernel's own
    assert C in decode_glue.CLUSTER_SIZES
    assert 32 <= threads <= 1024 and threads % 32 == 0
    assert vec * itemsize <= 16 and D % vec == 0
    assert nv * vec <= decode_glue.THREAD_ELEMS
    # the kernel's index map: block c, thread t, vector j of the thread
    nvec = D // vec
    per_block = -(-nvec // C)
    c, t, j = np.meshgrid(np.arange(C), np.arange(threads), np.arange(nv),
                          indexing="ij")
    i = j * threads + t
    live = i < np.minimum(per_block, nvec - c * per_block)
    first = (c * per_block + i)[live] * vec
    covered = np.bincount((first[:, None] + np.arange(vec)).ravel(),
                          minlength=D)
    assert covered.shape == (D,) and (covered == 1).all()
    # the 16-byte vector wherever D and the pointers allow it
    if D % (16 // itemsize) == 0:
        assert vec == 16 // itemsize


def test_launch_geometry_limits():
    for D in (0, decode_glue.MAX_D + 1):
        with pytest.raises(ValueError, match="feature dim"):
            launch_geometry(D, 2)
    # a pointer aligned to 8 bytes only narrows the vector
    assert launch_geometry(4096, 2, align=8)[2] == 4
    # one block for a row too wide for it is refused, not truncated
    with pytest.raises(ValueError, match="a thread"):
        decode_glue._block_geometry(65536, 2, 1)


# f32 rows with a mean of 2e3 (x and res each offset by 1e3) against a
# spread of ~1.4. The ulp of r there is 1.2e-4, and the two sides' means
# differ by summation order, so y (magnitude ~1-4) differs by a few such
# ulps: on these inputs the JAX result is itself 2.3e-4 from the f64 one,
# the split reference 7e-5. Tolerance: atol 1e-3 (rtol 0). A one-pass
# sum / sum of squares misses var by ~14% here (y off by ~0.3).
SPLIT_ATOL, SPLIT_RTOL = 1e-3, 0.0


def _split_reference(x, res, scale, bias, kind, cluster):
    """The split reference at the geometry the kernel launches
    (``cluster`` None) or with the row split over ``cluster`` blocks."""
    if cluster is None:
        return fused_residual_norm_split_reference(
            x, res, scale, bias, eps=1e-5, kind=kind)
    geometry = decode_glue._block_geometry(x.shape[-1], x.element_size(),
                                           cluster)
    return decode_glue._split_norm(x, res, scale, bias, 1e-5, kind, geometry)


def _offset_inputs(D=4096, rows=4, offset=1e3, seed=3):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(rows, D)) + offset).astype(np.float32)
    res = (r.normal(size=(rows, D)) + offset).astype(np.float32)
    scale = (1 + 0.1 * r.normal(size=(D,))).astype(np.float32)
    bias = (0.1 * r.normal(size=(D,))).astype(np.float32)
    return x, res, scale, bias


@pytest.mark.parametrize("cluster", [None, 8], ids=["one_block", "cluster8"])
@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "interpret"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_split_moments_match_jax_at_a_large_mean(kind, interpret, cluster):
    """The kernel's order of reduction (each thread's moments, merged over
    lanes, warps and the cluster's ranks), on one block as the decode step
    launches D 4096 and split over a cluster of 8."""
    x, res, scale, bias = _offset_inputs()
    b = bias if kind == "layer" else None
    jr, jy = jax_fused(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), eps=1e-5, kind=kind,
        interpret=interpret,
    )
    tr, ty = _split_reference(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(scale),
        None if b is None else torch.from_numpy(b), kind, cluster,
    )
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               atol=SPLIT_ATOL, rtol=SPLIT_RTOL)


def test_one_pass_moments_would_fail_the_large_mean_case():
    """Why the kernel merges (n, mean, M2): the one-pass variance of the
    same f32 rows, E[r^2] - E[r]^2, lands outside the tolerance above."""
    x, res, scale, bias = _offset_inputs()
    r = torch.from_numpy(x) + torch.from_numpy(res)
    mean = r.mean(dim=-1, keepdim=True)
    var = (r * r).mean(dim=-1, keepdim=True) - mean * mean
    y = (r - mean) * torch.rsqrt(var.clamp_min(0) + 1e-5) * torch.from_numpy(scale)
    y = y + torch.from_numpy(bias)
    _, ref = fused_residual_norm_reference(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(scale),
        torch.from_numpy(bias), eps=1e-5, kind="layer")
    err = (y - ref).abs()
    assert bool((err > SPLIT_ATOL + SPLIT_RTOL * ref.abs()).any())


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_split_reference_matches_plain_version_for_every_cluster(kind, cluster):
    x, res, scale, bias = (torch.from_numpy(a) for a in _inputs(4))
    b = bias if kind == "layer" else None
    out = _split_reference(x, res, scale, b, kind, cluster)
    ref = fused_residual_norm_reference(x, res, scale, b, eps=1e-5, kind=kind)
    for a, e in zip(out, ref):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5)
