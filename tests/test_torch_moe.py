"""PyTorch port, nn/moe.py and the MoE wiring of nn/transformer.py,
models/llama.py, convert.py, ops/quant.py, parallel/inference.py and
runtime/profiling.py, held against the JAX package (f32, params carried
across by ``convert.params_from_jax``, inputs from a numpy seed):

- ``MoEFeedForward._route`` at T 1, 5 and 16: dispatch equal exactly;
  combine equal exactly given the same softmax (XLA's and ATen's ``exp``
  differ in the last bit on some inputs, so the full route's combine is
  held within 1e-7); the module's output and aux loss within 1e-5;
- the reference's own cases: one expert is the dense gated FFN, a
  capacity of 1 drops the overflow, top-2 combines two experts with
  weights summing to 1, and ``routing_stats``' drop fraction (0 with
  ample capacity, between 0 and 1 when tight, equal to JAX's);
- the block refuses biases and dropout with experts; the stacked init's
  fan-ins; router noise draws from the generator in training only;
- ``moe_tiny`` Llama logits within 1e-5 and ``forward_with_aux``
  against ``apply_with_aux``; the state dict round-trips both ways
  under the serving dtype policy;
- int8 leaves the router and the expert stacks float (quantize and the
  random int8 init, on the reference's ``moe_experts=2, top_k=1``
  config), and a quantized MoE engine serves;
- ``weight_pass_bytes`` and ``program_cost`` count all E experts, against
  counts reckoned by hand."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.nn.moe import MoEFeedForward as JMoE
from tensorlink_tpu.nn.transformer import TransformerBlock as JBlock
from tensorlink_tpu_torch.convert import params_from_jax, state_dict_to_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.nn.moe import MoEFeedForward, expert_capacity
from tensorlink_tpu_torch.nn.transformer import TransformerBlock
from tensorlink_tpu_torch.ops.quant import (
    QuantizedWeight,
    is_quantized,
    quantization_report,
    quantize_params_int8,
    quantized_random_init,
)
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    weight_pass_bytes,
)
from tensorlink_tpu_torch.runtime import profiling

F32 = {"cache_dtype": torch.float32, "param_dtype": torch.float32}


def _pair(seed=0, **kw):
    """A JAX MoE FFN, its params, and the port's module holding them."""
    kw = {"dim": 16, "hidden_dim": 32, "num_experts": 4, "top_k": 2, **kw}
    jm = JMoE(**kw)
    p = jm.init(jax.random.key(seed))
    tm = MoEFeedForward(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(p)), strict=True)
    return jm, p, tm


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ the module


@pytest.mark.parametrize("T", [1, 5, 16])
def test_route_dispatch_and_combine_equal_jax(T, monkeypatch):
    jm, p, tm = _pair(T)
    logits = _x(T, (3, T, 4)) * 2.0
    jd, jc, jaux = jm._route(jnp.asarray(logits))
    jd, jc = np.asarray(jd), np.asarray(jc)
    td, tc, taux = tm._route(torch.from_numpy(logits))
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-7)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
    # the same softmax in: combine equal to the bit
    jprobs = torch.from_numpy(np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)))
    monkeypatch.setattr(torch, "softmax", lambda t, dim: jprobs)
    td, tc, _ = tm._route(torch.from_numpy(logits))
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("T", [1, 5, 16])
def test_forward_and_aux_equal_jax(T):
    jm, p, tm = _pair(10 + T)
    x = _x(T, (2, T, 16))
    jout, jaux = jm.apply_with_aux(p, jnp.asarray(x))
    with torch.no_grad():
        out, aux = tm.forward_with_aux(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(), out.numpy())
    assert tm.capacity(T) == jm.capacity(T)


def test_single_expert_equals_dense_ffn():
    """E 1, k 1, ample capacity: the gated FFN of expert 0."""
    _, _, tm = _pair(0, num_experts=1, top_k=1, capacity_factor=4.0)
    x = torch.from_numpy(_x(1, (2, 8, 16)))
    with torch.no_grad():
        out = tm(x)
        ref = (torch.nn.functional.silu(x @ tm.gate[0]) * (x @ tm.up[0])) @ tm.down[0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_capacity_overflow_drops_tokens():
    """A capacity of 1: only the first token reaches expert 0; the rest
    come out as zeros (the residual path carries them)."""
    _, _, tm = _pair(0, dim=8, hidden_dim=16, num_experts=1, top_k=1,
                     capacity_factor=1e-9)
    assert tm.capacity(16) == 1
    with torch.no_grad():
        out = tm(torch.from_numpy(_x(2, (1, 16, 8))))
    assert not torch.allclose(out[0, 0], torch.zeros(8))
    np.testing.assert_allclose(out[0, 1:].numpy(), 0.0, atol=1e-7)


def test_top2_combines_two_experts():
    _, _, tm = _pair(0, dim=8, hidden_dim=16, capacity_factor=4.0)
    x = torch.from_numpy(_x(4, (1, 8, 8)))
    dispatch, combine, _ = tm._route(x @ tm.router.w)
    np.testing.assert_allclose(dispatch.sum(dim=(2, 3)).numpy(), 2.0)
    np.testing.assert_allclose(combine.sum(dim=(2, 3)).numpy(), 1.0, atol=1e-6)


def test_routing_stats_drop_fraction_equals_jax():
    x = _x(0, (2, 32, 16))
    roomy_j, p, roomy = _pair(0, capacity_factor=8.0)
    st = roomy.routing_stats(torch.from_numpy(x))
    assert st["drop_fraction"] == pytest.approx(0.0)
    tight_j, _, tight = _pair(0, capacity_factor=0.25)
    st2 = tight.routing_stats(torch.from_numpy(x))
    assert 0.0 < st2["drop_fraction"] < 1.0
    assert st2["capacity_per_expert"] < st["capacity_per_expert"]
    for jm, tm, got in ((roomy_j, roomy, st), (tight_j, tight, st2)):
        ref = jm.routing_stats(p, jnp.asarray(x))
        assert got["drop_fraction"] == ref["drop_fraction"]
        assert got["capacity_per_expert"] == ref["capacity_per_expert"]
        assert got["aux_loss"] == pytest.approx(ref["aux_loss"], abs=1e-5)
        dispatch = tm._route(torch.from_numpy(x) @ tm.router.w)[0]
        assert float(dispatch.sum()) == (1 - got["drop_fraction"]) * 2 * 32 * 2


def test_stacked_init_fan_ins():
    tm = MoEFeedForward(64, 256, num_experts=8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for mod in tm.modules():
        mod.reset_parameters(gen)
    assert tm.up.std().item() == pytest.approx(1 / math.sqrt(64), rel=0.05)
    assert tm.gate.std().item() == pytest.approx(1 / math.sqrt(64), rel=0.05)
    assert tm.down.std().item() == pytest.approx(1 / math.sqrt(256), rel=0.05)
    assert tm.router.w.std().item() == pytest.approx(0.02, rel=0.1)
    ungated = MoEFeedForward(8, 16, gated=False, device="cpu")
    assert ungated.gate is None and "gate" not in ungated.state_dict()


def test_router_noise_draws_from_the_generator_in_training_only():
    _, _, tm = _pair(0, router_noise=5.0)
    x = torch.from_numpy(_x(5, (2, 16, 16)))
    logits = x @ tm.router.w
    clean = tm._route(logits)[0]
    # eval, or no generator: no noise
    assert torch.equal(tm._route(logits, torch.Generator().manual_seed(1))[0], clean)
    assert torch.equal(tm._route(logits, None, True)[0], clean)
    a = tm._route(logits, torch.Generator().manual_seed(1), True)[0]
    b = tm._route(logits, torch.Generator().manual_seed(1), True)[0]
    assert torch.equal(a, b) and not torch.equal(a, clean)


# ---------------------------------------------------------- the block


@pytest.mark.parametrize("bad", [{"use_bias": True}, {"dropout": 0.1}])
def test_block_refuses_bias_and_dropout_with_experts(bad):
    kw = {"dim": 16, "num_heads": 4, "moe_experts": 4, "use_bias": False, **bad}
    with pytest.raises(ValueError, match="moe_experts requires") as j:
        JBlock(**kw)
    with pytest.raises(ValueError, match="moe_experts requires") as t:
        TransformerBlock(**kw, device="cpu")
    assert str(t.value) == str(j.value)


def test_block_routing_stats_equal_jax():
    kw = {"dim": 16, "num_heads": 4, "hidden_dim": 32, "norm": "rms",
          "use_bias": False, "gated_mlp": True, "causal": True,
          "activation": "silu", "moe_experts": 4, "moe_capacity_factor": 0.5}
    jb = JBlock(**kw)
    p = jb.init(jax.random.key(2))
    tb = TransformerBlock(**kw, device="cpu")
    tb.load_state_dict(params_from_jax(jax.device_get(p)), strict=True)
    x = _x(6, (2, 12, 16))
    ref = jb.routing_stats(p, jnp.asarray(x))
    got = tb.routing_stats(torch.from_numpy(x))
    assert got["drop_fraction"] == ref["drop_fraction"] > 0
    assert got["aux_loss"] == pytest.approx(ref["aux_loss"], abs=1e-5)
    jout, jaux = jb.apply_with_aux(p, jnp.asarray(x))
    with torch.no_grad():
        out, aux = tb.forward_with_aux(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    dense = TransformerBlock(16, 4, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        dense.routing_stats(torch.from_numpy(x))
    assert dense.forward_with_aux(torch.from_numpy(x))[1] == 0.0


# ---------------------------------------------------------- the model


@pytest.fixture(scope="module")
def moe_tiny():
    jm = JLlama(JLlamaConfig.moe_tiny())
    p = jm.init(jax.random.key(0))
    tm = Llama(LlamaConfig.moe_tiny(), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(jax.device_get(p)), strict=True, assign=True)
    return jm, p, tm


def test_moe_tiny_logits_and_aux_equal_jax(moe_tiny):
    jm, p, tm = moe_tiny
    ids = np.random.default_rng(1).integers(0, 128, (2, 12))
    ref = np.asarray(jm.apply(p, jnp.asarray(ids)))
    jlog, jaux = jm.apply_with_aux(p, jnp.asarray(ids))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
        log, aux = tm.forward_with_aux(torch.from_numpy(ids))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    # a dense config's aux is 0
    dense = Llama(LlamaConfig.tiny(), device="cpu")
    assert dense.forward_with_aux(torch.from_numpy(ids))[1] == 0.0


def test_state_dict_round_trips_both_ways(moe_tiny):
    _, p, tm = moe_tiny
    tree = jax.device_get(p)
    back = state_dict_to_jax(tm.state_dict())
    mlp, jmlp = back["blocks"]["1"]["mlp"], tree["blocks"]["1"]["mlp"]
    assert set(mlp) == set(jmlp) == {"router", "up", "gate", "down"}
    for name in ("up", "gate", "down"):
        np.testing.assert_array_equal(mlp[name], np.asarray(jmlp[name]))
    np.testing.assert_array_equal(mlp["router"]["w"], np.asarray(jmlp["router"]["w"]))
    # the serving policy: >= 2-D leaves (router, expert stacks) to bf16
    bf = params_from_jax(tree, param_dtype=torch.bfloat16)
    assert bf["blocks.0.mlp.up"].dtype == torch.bfloat16
    assert bf["blocks.0.mlp.router.w"].dtype == torch.bfloat16
    assert bf["blocks.0.norm2.scale"].dtype == torch.float32
    assert tuple(bf["blocks.0.mlp.down"].shape) == (4, 64, 32)


# ---------------------------------------------------------------- int8


def test_int8_leaves_router_and_experts_float(moe_tiny):
    jm, p, _ = moe_tiny
    tm = Llama(LlamaConfig.moe_tiny(), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(jax.device_get(p)), strict=True, assign=True)
    float_model = Llama(LlamaConfig.moe_tiny(), device="cpu", seed=None)
    float_model.load_state_dict(tm.state_dict(), assign=True)
    quantize_params_int8(tm)
    mlp = tm.blocks.blocks()[0].mlp
    assert isinstance(tm.blocks.blocks()[0].attn.q.w, QuantizedWeight)
    for t in mlp.weights():
        assert isinstance(t, torch.nn.Parameter) and t.dtype == torch.float32
    assert is_quantized(tm)
    rep = quantization_report(float_model, tm)
    assert rep["compression"] > 1.0 and rep["worst_layer_rel_error"] < 0.02
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (1, 8)))
    with torch.no_grad():
        assert torch.isfinite(tm(ids)).all()


def test_quantized_random_init_on_the_reference_moe_config():
    """The reference's ``moe_experts=2, top_k=1`` config: attention int8
    with the LeCun std, router and experts N(0, 0.02) floats, and an
    engine that takes the tree as it is and decodes."""
    cfg = LlamaConfig(vocab_size=64, dim=32, num_layers=2, num_heads=4,
                      num_kv_heads=2, hidden_dim=64, max_len=32,
                      moe_experts=2, moe_top_k=1)
    m = Llama(cfg, device="meta", seed=None)
    quantized_random_init(m, seed=0, device="cpu", dtype=torch.float32)
    attn = m.blocks.blocks()[0].attn
    assert attn.q.w.q.dtype == torch.int8 and tuple(attn.q.w.s.shape) == (32,)
    eff = attn.q.w.q.float() * attn.q.w.s
    assert 0.8 / math.sqrt(32) < eff.std().item() < 1.2 / math.sqrt(32)
    mlp = m.blocks.blocks()[0].mlp
    assert mlp.router.w.dtype == torch.float32 and tuple(mlp.up.shape) == (2, 32, 64)
    assert mlp.up.std().item() == pytest.approx(0.02, rel=0.1)
    eng = InferenceEngine(m, max_len=32, device="cpu", quantize="int8", **F32)
    ids = np.random.default_rng(0).integers(0, 64, (2, 5))
    out = eng.generate(ids, GenerationConfig(max_new_tokens=6))
    assert out.shape == (2, 6) and (out >= 0).all() and (out < 64).all()


# ---------------------------------------------------------- bytes, cost


def _mixtral_tiny_bytes(cfg, attn_bytes, expert_item):
    d, H, G, hid, E = cfg.dim, cfg.num_heads, cfg.num_kv_heads, cfg.hidden_dim, \
        cfg.moe_experts
    Dh = d // H
    mats = [(d, H * Dh), (d, G * Dh), (d, G * Dh), (H * Dh, d)]
    experts = (3 * E * d * hid + d * E) * expert_item  # up, gate, down, router
    return cfg.num_layers * (sum(attn_bytes(i, o) for i, o in mats) + experts), mats


def test_weight_pass_bytes_count_every_expert():
    cfg = LlamaConfig.moe_tiny()
    V, d = cfg.vocab_size, cfg.dim
    bf = InferenceEngine(Llama(cfg, device="cpu"), max_len=32, device="cpu")
    layers, _ = _mixtral_tiny_bytes(cfg, lambda i, o: 2 * i * o, 2)
    assert bf.weight_bytes == layers + 2 * d * V
    q8 = InferenceEngine(Llama(cfg, device="cpu"), max_len=32, device="cpu",
                         quantize="int8")
    layers8, _ = _mixtral_tiny_bytes(cfg, lambda i, o: i * o + 4 * o, 2)
    assert q8.weight_bytes == layers8 + d * V + 4 * V
    assert weight_pass_bytes(q8.model) == q8.weight_bytes


def test_program_cost_counts_the_moe_ffn_by_hand():
    cfg = LlamaConfig.moe_tiny()
    d, L, H, Hkv, V, F, E = cfg.dim, cfg.num_layers, cfg.num_heads, \
        cfg.num_kv_heads, cfg.vocab_size, cfg.hidden_dim, cfg.moe_experts
    D = d // H
    A = d * H * D + 2 * d * Hkv * D + H * D * d  # attention matmuls, a layer

    def ffn(T):  # one row of T tokens, one layer
        C = max(int(1.25 * 2 * T / E), 1)
        return 2 * T * d * E + 4 * T * E * C * d + 2 * 3 * d * F * E * C

    assert [expert_capacity(T, E, 2, 1.25) for T in (1, 5, 8)] == [1, 3, 5]
    kvb = 2 * Hkv * D * 4
    wb = 12345  # bytes are the engine's figure, passed through
    got = profiling.program_cost(cfg, "decode", rows=4, steps=3, frontier=[10, 6],
                                 weight_bytes=wb, kv_token_bytes=kvb)
    ctx = [8, 9, 10] + [4, 5, 6]
    flops = (3 * 4 * (2 * A * L + 2 * d * V) + 3 * 4 * L * ffn(1)
             + sum(4 * H * D * L * c for c in ctx))
    assert got == {"flops": float(flops),
                   "bytes": float(3 * wb + sum(kvb * L * c for c in ctx))}
    got = profiling.program_cost(cfg, "prefill_chunk", rows=1, steps=8, frontier=[16],
                                 weight_bytes=wb, kv_token_bytes=kvb)
    pairs = sum(range(9, 17))
    flops = 8 * 2 * A * L + L * ffn(8) + 2 * d * V + 4 * H * D * L * pairs
    assert got["flops"] == float(flops)
    # a verify round routes K + 1 tokens a row: C from T = 5
    got = profiling.program_cost(cfg, "spec_chunk", rows=2, steps=1, frontier=[10, 10],
                                 k=4, weight_bytes=wb, kv_token_bytes=kvb)
    dense = dataclasses.replace(cfg, moe_experts=0)
    ref = profiling.program_cost(dense, "spec_chunk", rows=2, steps=1, frontier=[10, 10],
                                 k=4, weight_bytes=wb, kv_token_bytes=kvb)
    assert got["bytes"] == ref["bytes"]
    assert got["flops"] - ref["flops"] == 2 * L * (ffn(5) - 2 * 3 * d * F * 5)
    assert profiling.layer_matmul_params(cfg) == A
    assert profiling.layer_matmul_params(dense) == A + 3 * d * F
