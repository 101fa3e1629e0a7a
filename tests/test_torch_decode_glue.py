"""PyTorch port, ops/decode_glue.py: the plain fused residual+norm against
the JAX package's ``fused_residual_norm``, both its jnp fallback and its
Pallas kernel in interpret mode. Tolerances: f32 atol 1e-6 (same f32
math); bf16 atol 1e-2 (both round the same f32 values to bf16, so they
differ by at most one bf16 ulp at the outputs' magnitude).

The Triton kernel runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.ops.pallas.decode_glue import (
    fused_residual_norm as jax_fused,
)
from tensorlink_tpu_torch.ops.decode_glue import (
    fused_residual_norm,
    fused_residual_norm_reference,
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
