"""PyTorch port, models/t5.py, against the JAX package on the same params
(the port's seeded init, carried into the JAX tree and back) and seeded
ids, f32 on the CPU.

- ``relative_position_bucket`` bitwise equal to the JAX one for every
  offset in [-300, 300], both directions, at (32, 128) and (8, 16)
  buckets (at n = 2^k max_exact one ulp would flip a bucket);
- ``T5Config.tiny()`` logits within 1e-5, v1.0 (ReLU, tied head with the
  d^-0.5 rescale) and v1.1 (gated-GeLU, untied head), with an encoder
  padding mask and a decoder padding mask; ``encode`` alone too;
- ``greedy_decode`` tokens identical to the JAX ``greedy_decode``, with
  and without an encoder padding mask, and to a step-by-step ``decode``
  of the emitted prefix (the reference's exactness claim);
- the reference's padding invariance and decoder-mask cases
  (``tests/test_t5.py:107``, ``:165``);
- tensor-parallel ``forward`` at model 2 (two spawned gloo ranks, the
  weights cut by ``param_spec``) against world 1, as the reference's
  ``tests/test_t5.py:138`` holds its sharded apply.

This module's top level imports only torch, numpy and the port: the
spawned ranks import it to find their body.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tensorlink_tpu_torch.config import MeshConfig
from tensorlink_tpu_torch.models.t5 import T5, T5Config, relative_position_bucket
from torch_ranks import spawn_cpu_ranks

TOL = 1e-5
V11 = dict(gated_ff=True, tie_word_embeddings=False)


def _cfg(variant: str) -> T5Config:
    base = T5Config.tiny()
    if variant == "v1.1":
        from dataclasses import replace

        return replace(base, **V11)
    return base


@functools.cache
def _jax_model(variant: str):
    """The JAX T5 and its params: the port's seeded init carried into the
    JAX tree (``nn.module.param_tree``), so no JAX init is compiled."""
    import jax
    import jax.numpy as jnp

    from tensorlink_tpu.models.t5 import T5 as JT5
    from tensorlink_tpu.models.t5 import T5Config as JT5Config
    from tensorlink_tpu_torch.nn.module import param_tree

    cfg = _cfg(variant)
    tm = T5(cfg, device="cpu", seed=0)
    tree = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), param_tree(tm))
    return JT5(JT5Config(**cfg.__dict__)), tree


def _port_model(params, variant: str) -> T5:
    from tensorlink_tpu_torch.convert import params_from_jax

    m = T5(_cfg(variant), device="cpu", seed=None)
    m.load_state_dict(params_from_jax(params), strict=True)
    return m


@pytest.mark.parametrize("buckets", [(32, 128), (8, 16)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_bitwise_equal(buckets, bidirectional):
    import jax.numpy as jnp

    from tensorlink_tpu.models.t5 import relative_position_bucket as j_bucket

    nb, md = buckets
    rel = np.arange(-300, 301, dtype=np.int32)
    ref = np.asarray(j_bucket(jnp.asarray(rel), bidirectional=bidirectional,
                              num_buckets=nb, max_distance=md))
    out = relative_position_bucket(torch.from_numpy(rel), bidirectional=bidirectional,
                                   num_buckets=nb, max_distance=md)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def _ids(seed, B, T, vocab=128):
    return np.random.default_rng(seed).integers(2, vocab, (B, T))


@pytest.mark.parametrize("variant", ["v1.0", "v1.1"])
def test_logits_match_jax(variant):
    import jax
    import jax.numpy as jnp

    jm, jp = _jax_model(variant)
    tm = _port_model(jp, variant)
    ids, dec = _ids(0, 2, 10), _ids(1, 2, 7)
    dec[:, 0] = 0
    am = np.ones((2, 10), np.int64)
    am[0, 7:] = 0
    ids[0, 7:] = 0
    dam = np.ones((2, 7), np.int64)
    dam[1, 2:4] = 0
    ref = np.asarray(jax.jit(lambda p, *a: jm.apply(
        p, *a[:2], attention_mask=a[2], decoder_attention_mask=a[3]))(
        jp, jnp.asarray(ids), jnp.asarray(dec), jnp.asarray(am), jnp.asarray(dam)))
    ref_mem = np.asarray(jax.jit(lambda p, i, m: jm.encode(p, i, attention_mask=m))(
        jp, jnp.asarray(ids), jnp.asarray(am)))
    t = torch.from_numpy
    with torch.no_grad():
        out = tm(t(ids), t(dec), attention_mask=t(am), decoder_attention_mask=t(dam))
        mem = tm.encode(t(ids), attention_mask=t(am))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(mem.numpy(), ref_mem, atol=TOL, rtol=0)


@pytest.mark.parametrize("variant, masked",
                         [("v1.0", False), ("v1.0", True), ("v1.1", True)])
def test_greedy_decode_tokens_equal_jax(variant, masked):
    import jax.numpy as jnp

    jm, jp = _jax_model(variant)
    tm = _port_model(jp, variant)
    ids = _ids(2, 3, 9)
    am = None
    if masked:
        am = np.ones((3, 9), np.int64)
        am[0, 5:] = 0
        am[2, 7:] = 0
        ids = ids * am
    ref = jm.greedy_decode(jp, jnp.asarray(ids), max_new_tokens=6, start_id=0,
                           attention_mask=None if am is None else jnp.asarray(am))
    toks = tm.greedy_decode(torch.from_numpy(ids), max_new_tokens=6, start_id=0,
                            attention_mask=None if am is None else torch.from_numpy(am))
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (3, 6)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))
    # and against the naive step-by-step decode() of the emitted prefix
    t = torch.from_numpy
    with torch.no_grad():
        memory = tm.encode(t(ids), attention_mask=None if am is None else t(am))
        dec = torch.zeros((3, 1), dtype=torch.int64)
        for _ in range(6):
            logits = tm.decode(dec, memory, memory_mask=None if am is None else t(am))
            dec = torch.cat([dec, logits[:, -1].argmax(-1)[:, None]], dim=1)
    np.testing.assert_array_equal(toks.numpy(), dec[:, 1:].numpy())


def test_padding_invariance():
    """Encoder padding must not leak through cross-attention (the
    reference's tests/test_t5.py:107 case)."""
    _, jp = _jax_model("v1.0")
    tm = _port_model(jp, "v1.0")
    r = np.random.default_rng(2)
    short = r.integers(2, 128, (1, 4))
    padded = np.zeros((1, 8), np.int64)
    padded[0, :4] = short[0]
    am = np.zeros((1, 8), np.int64)
    am[0, :4] = 1
    dec = torch.from_numpy(r.integers(2, 128, (1, 3)))
    with torch.no_grad():
        a = tm(torch.from_numpy(short), dec)
        b = tm(torch.from_numpy(padded), dec, attention_mask=torch.from_numpy(am))
    torch.testing.assert_close(a, b, atol=TOL, rtol=0)


def test_decoder_padding_mask_honored():
    """decoder_attention_mask gates attention (the reference's
    tests/test_t5.py:165 case): positions after interior pads change,
    positions before them do not."""
    _, jp = _jax_model("v1.0")
    tm = _port_model(jp, "v1.0")
    r = np.random.default_rng(3)
    ids = torch.from_numpy(r.integers(2, 128, (1, 5)))
    dec = torch.from_numpy(r.integers(2, 128, (1, 6)))
    dam = torch.ones((1, 6), dtype=torch.int64)
    dam[0, 2:4] = 0
    with torch.no_grad():
        a = tm(ids, dec)
        b = tm(ids, dec, decoder_attention_mask=dam)
    assert not torch.allclose(a[0, 5], b[0, 5])
    torch.testing.assert_close(a[0, :2], b[0, :2], atol=TOL, rtol=0)


# ------------------------------------------------------ tensor parallelism


def _tp_inputs():
    return torch.ones((2, 6), dtype=torch.int64), torch.ones((2, 4), dtype=torch.int64)


def _tp_rank(rank, world, out_dir, states):
    from torch.func import functional_call

    from tensorlink_tpu_torch.parallel import tp
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    mesh = make_mesh(MeshConfig(model=world), device="cpu")
    got = {}
    for variant, state in states.items():
        model = T5(_cfg(variant), device="cpu", seed=None)
        local = tp.shard_params(state, model, mesh)
        with torch.no_grad(), tp.model_parallel(mesh.get_group("model")):
            out = functional_call(model, local, _tp_inputs())
        got[variant] = {"out": out, "q_shape": tuple(local["enc0.attn.q.w"].shape),
                        "head_shape": tuple(local.get("lm_head.w", torch.zeros(0)).shape)}
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


def test_tensor_parallel_forward_matches_world1(tmp_path):
    """Both variants at model 2: every rank's logits within 2e-5 (the
    reference's bound) of world 1's, with q/k/v/o, the FF and v1.1's
    untied head really split."""
    from tensorlink_tpu_torch.convert import params_from_jax

    states, single = {}, {}
    for variant in ("v1.0", "v1.1"):
        _, jp = _jax_model(variant)
        states[variant] = params_from_jax(jp)
        with torch.no_grad():
            single[variant] = _port_model(jp, variant)(*_tp_inputs())
    spawn_cpu_ranks(_tp_rank, 2, str(tmp_path), states, store_dir=str(tmp_path))
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for variant, g in got.items():
            # the attention projections really are split over the model axis
            assert g["q_shape"] == (32, 16), variant
            torch.testing.assert_close(g["out"], single[variant], atol=2e-5, rtol=0)
        assert got["v1.1"]["head_shape"] == (32, 64)
