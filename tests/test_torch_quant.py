"""PyTorch port, weight-only int8 (ops/quant.py, the quantized ``Dense``,
``InferenceEngine(quantize="int8")``, ``convert``) and the fused q/k/v
layout (``fuse_qkv_params``, ``qkv_fused`` Llama and GPT-2), held against
the JAX package on the same params (f32, tiny widths):

- ``quantize_weight_int8``: q equal to JAX's, s to f32 rounding (rtol
  1e-6); the module surgery quantizes ``Dense`` weights only, under the
  JAX tree's names; a quantized JAX tree loads through ``convert``;
- greedy tokens of the int8 static, contiguous and paged engines equal
  the JAX quantized engine's; int8 against float logits stay under the
  reference's 0.02-nat mean KL on teacher-forced rows;
- ``fuse_qkv_params`` equals JAX's; fused Llama and GPT-2 logits match
  JAX's fused models (atol 1e-4), and a fused tree quantized by the
  engine serves the JAX fused int8 engine's tokens; the speculative
  verify pass and draft steps through the fused projection keep the
  plain engine's greedy tokens;
- ``program_cost`` bills an int8 engine's weights at one byte plus the
  f32 scales, computed here by hand."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.nn.attention import fuse_qkv_params as jfuse
from tensorlink_tpu.ops import quant as jquant
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.serving import (
    ContinuousBatchingEngine as JContiguous,
    PagedContinuousBatchingEngine as JPaged,
)
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.nn.attention import fuse_qkv_params
from tensorlink_tpu_torch.nn.layers import Dense
from tensorlink_tpu_torch.ops import quant
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from tensorlink_tpu_torch.runtime import profiling

KL_BOUND = 0.02  # nats, the reference bench's int8 quality bound
ATOL = 1e-4  # f32 logits after two blocks


def _jax_llama(seed=0, cfg=None):
    jm = JLlama(cfg or JLlamaConfig.tiny())
    return jm, jm.init(jax.random.key(seed))


def _port_engine(p, cfg=None, quantize=None, max_len=32):
    model = Llama(cfg or LlamaConfig.tiny(), device="cpu", seed=None)
    state = params_from_jax(jax.device_get(p)) if p is not None else None
    return InferenceEngine(model, state, max_len=max_len, device="cpu",
                           cache_dtype=torch.float32, param_dtype=torch.float32,
                           quantize=quantize)


# ------------------------------------------------------------------ ops
def test_quantize_weight_matches_jax():
    r = np.random.default_rng(0)
    w = r.normal(0, 0.3, (48, 40)).astype(np.float32)
    w[:, 7] = 0.0  # a zero column takes scale 1.0
    jq = jquant.quantize_weight_int8(jnp.asarray(w))
    tq = quant.quantize_weight_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_allclose(tq["s"].numpy(), np.asarray(jq["s"]), rtol=1e-6, atol=0)
    assert tq["s"][7] == 1.0 and not tq["q"][:, 7].any()
    np.testing.assert_allclose(quant.dequantize_weight(tq).numpy(),
                               np.asarray(jquant.dequantize_weight(jq)),
                               rtol=1e-6, atol=0)
    # column blocks change nothing: the scale is per output channel
    wide = torch.from_numpy(r.normal(0, 1, (8, 9000)).astype(np.float32))
    blocked = quant.quantize_weight_int8(wide)
    jw = jquant.quantize_weight_int8(jnp.asarray(wide.numpy()))
    np.testing.assert_array_equal(blocked["q"].numpy(), np.asarray(jw["q"]))


def test_quantize_touches_dense_only_under_the_jax_names():
    jm, p = _jax_llama()
    jq = jax.device_get(jquant.quantize_params_int8(jm, p))
    eng = _port_engine(p, quantize="int8")
    state = eng.model.state_dict()
    assert set(state) == set(params_from_jax(jq))
    for name, t in state.items():
        if name.endswith(".q"):
            assert t.dtype == torch.int8
        elif name.endswith(".s"):
            assert t.dtype == torch.float32 and t.dim() == 1
    # the embedding and the norms are untouched, every Dense quantized
    np.testing.assert_array_equal(state["tok_emb.table"].numpy(),
                                  np.asarray(p["tok_emb"]["table"]))
    dense = [m for m in eng.model.modules() if isinstance(m, Dense)]
    assert dense and all(m.quantized for m in dense)
    assert quant.is_quantized(eng.model) and quant.is_quantized(state)
    np.testing.assert_array_equal(
        state["blocks.0.attn.q.w.q"].numpy(),
        np.asarray(jq["blocks"]["0"]["attn"]["q"]["w"]["q"]))


def test_quantized_jax_tree_loads_through_convert():
    jm, p = _jax_llama()
    jq = jquant.quantize_params_int8(jm, p)
    state = params_from_jax(jax.device_get(jq))
    assert state["blocks.1.mlp.up.w.q"].dtype == torch.int8
    assert state["blocks.1.mlp.up.w.s"].dtype == torch.float32
    model = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    eng = InferenceEngine(model, state, max_len=32, device="cpu",
                          cache_dtype=torch.float32, param_dtype=torch.float32)
    ids = np.random.default_rng(2).integers(0, 128, (2, 10))
    ref = np.asarray(jm.apply(jq, jnp.asarray(ids)))
    with torch.no_grad():
        out = eng.model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_quantized_random_init_never_builds_float_weights():
    model = Llama(LlamaConfig.tiny(), device="meta", seed=None)
    quant.quantized_random_init(model, seed=3, device="cpu", dtype=torch.float32)
    state = model.state_dict()
    assert all(t.device.type == "cpu" for t in state.values())
    dense = [m for m in model.modules() if isinstance(m, Dense)]
    assert all(m.quantized for m in dense)
    w = quant.dequantize_weight(model.blocks.blocks()[0].mlp.up.w)
    assert abs(float(w.std()) * np.sqrt(32) - 1.0) < 0.05  # LeCun std
    assert torch.equal(state["norm_f.scale"], torch.ones(32))
    eng = InferenceEngine(model, max_len=32, device="cpu",
                          cache_dtype=torch.float32, param_dtype=torch.float32,
                          quantize="int8")
    out = eng.generate(np.array([[1, 2, 3]]), GenerationConfig(max_new_tokens=4))
    assert out.shape == (1, 4)


def test_quantization_report_counts_bytes_and_error():
    jm, p = _jax_llama()
    fl = _port_engine(p).model
    q8 = _port_engine(p, quantize="int8").model
    rep = quant.quantization_report(fl, q8)
    jrep = jquant.quantization_report(p, jquant.quantize_params_int8(jm, p))
    assert rep["bytes_before"] == jrep["bytes_before"]
    assert rep["bytes_after"] == jrep["bytes_after"]
    assert rep["worst_layer_rel_error"] == pytest.approx(jrep["worst_layer_rel_error"], rel=1e-4)


# ------------------------------------------------------------- engines
def _prompts(n=4, vocab=128, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, (k,)) for k in (5, 3, 7, 6)[:n]]


def test_int8_static_generate_equals_jax():
    jm, p = _jax_llama()
    mesh = make_mesh(MeshConfig())
    jeng = JEngine(mesh, jm, p, max_len=32, cache_dtype=jnp.float32,
                   param_dtype=jnp.float32, quantize="int8")
    teng = _port_engine(p, quantize="int8")
    ids = np.random.default_rng(4).integers(0, 128, (2, 6))
    ref = np.asarray(jeng.generate(jnp.asarray(ids), JGen(max_new_tokens=8)))
    np.testing.assert_array_equal(
        teng.generate(ids, GenerationConfig(max_new_tokens=8)), ref)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_int8_serving_greedy_tokens_equal_jax(kind):
    jm, p = _jax_llama()
    mesh = make_mesh(MeshConfig())
    jeng = JEngine(mesh, jm, p, max_len=32, cache_dtype=jnp.float32,
                   param_dtype=jnp.float32, quantize="int8")
    teng = _port_engine(p, quantize="int8")
    kw = ({"slots": 2, "decode_chunk": 3, "prefill_block": 4} if kind == "contiguous"
          else {"slots": 2, "block_size": 8, "num_blocks": 16, "prefill_chunk": 8})
    jcls, tcls = ((JContiguous, ContinuousBatchingEngine) if kind == "contiguous"
                  else (JPaged, PagedContinuousBatchingEngine))
    jsch = jcls(jeng, gen=JGen(max_new_tokens=8), **kw)
    tsch = tcls(teng, gen=GenerationConfig(max_new_tokens=8), **kw)
    prompts = _prompts()
    jrids = [jsch.submit(pr) for pr in prompts]
    trids = [tsch.submit(pr) for pr in prompts]
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(tsch.result(tr), np.asarray(jsch.result(jr)))


def test_int8_logits_stay_under_the_kl_bound():
    """Teacher-forced rows (random ids through the whole model): the mean
    KL of the int8 distribution from the float one is under 0.02 nats."""
    jm, p = _jax_llama()
    fl, q8 = _port_engine(p).model, _port_engine(p, quantize="int8").model
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 128, (4, 24)))
    with torch.no_grad():
        lp = torch.log_softmax(fl(ids).float(), dim=-1)
        lq = torch.log_softmax(q8(ids).float(), dim=-1)
    kl = float((lp.exp() * (lp - lq)).sum(-1).mean())
    assert 0.0 <= kl < KL_BOUND


def test_int8_engine_refuses_unknown_modes():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        _port_engine(None, quantize="int4")


# ----------------------------------------------------------- fused qkv
@pytest.mark.parametrize("bias", [False, True])
def test_fuse_qkv_params_equals_jax(bias):
    r = np.random.default_rng(6)
    D, H, G, Dh = 32, 4, 2, 8

    def dense(n_out):
        d = {"w": r.normal(0, 1, (D, n_out)).astype(np.float32)}
        if bias:
            d["b"] = r.normal(0, 1, (n_out,)).astype(np.float32)
        return d

    attn = {"q": dense(H * Dh), "k": dense(G * Dh), "v": dense(G * Dh), "o": dense(D)}
    ref = jax.device_get(jfuse(attn, H, G, Dh))
    got = fuse_qkv_params(attn, H, G, Dh)
    np.testing.assert_array_equal(got["qkv"]["w"], np.asarray(ref["qkv"]["w"]))
    if bias:
        np.testing.assert_array_equal(got["qkv"]["b"], np.asarray(ref["qkv"]["b"]))
    # tensors in, tensors out, the same values
    t = fuse_qkv_params({k: {n: torch.from_numpy(a) for n, a in v.items()}
                         for k, v in attn.items()}, H, G, Dh)
    np.testing.assert_array_equal(t["qkv"]["w"].numpy(), np.asarray(ref["qkv"]["w"]))
    with pytest.raises(ValueError, match="extras"):
        fuse_qkv_params({**attn, "lora": {}}, H, G, Dh)


def _fuse_tree(p, H, G, Dh):
    p = jax.device_get(p)
    for blk in p["blocks"].values():
        blk["attn"] = jax.device_get(jfuse(blk["attn"], H, G, Dh))
    return p


def test_fused_llama_logits_match_jax():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), qkv_fused=True)
    base, p = _jax_llama()
    fp = _fuse_tree(p, jcfg.num_heads, jcfg.num_kv_heads, jcfg.dim // jcfg.num_heads)
    jm = JLlama(jcfg)
    ids = np.random.default_rng(7).integers(0, 128, (2, 12))
    ref = np.asarray(jm.apply(fp, jnp.asarray(ids)))
    # the unfused model on the unfused tree gives the same function
    np.testing.assert_allclose(ref, np.asarray(base.apply(p, jnp.asarray(ids))), atol=ATOL)
    tm = Llama(dataclasses.replace(LlamaConfig.tiny(), qkv_fused=True), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(fp), assign=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_fused_gpt2_logits_match_jax():
    jcfg = dataclasses.replace(JGPT2Config.tiny(), qkv_fused=True)
    jbase = JGPT2(JGPT2Config.tiny())
    p = jbase.init(jax.random.key(0))
    Dh = jcfg.dim // jcfg.num_heads
    fp = _fuse_tree(p, jcfg.num_heads, jcfg.num_heads, Dh)
    jm = JGPT2(jcfg)
    ids = np.random.default_rng(8).integers(0, 128, (2, 12))
    ref = np.asarray(jm.apply(fp, jnp.asarray(ids)))
    tm = GPT2(dataclasses.replace(GPT2Config.tiny(), qkv_fused=True), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(fp), assign=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_fused_then_quantized_serving_equals_jax(kind):
    """A fused tree that the engine then quantizes (the reference engine's
    ``quantize="int8"`` on a fused model) serves the JAX fused int8
    engine's greedy tokens; every cache path projects through the fused
    ``Dense``."""
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), qkv_fused=True)
    _, p = _jax_llama()
    fp = _fuse_tree(p, jcfg.num_heads, jcfg.num_kv_heads, jcfg.dim // jcfg.num_heads)
    mesh = make_mesh(MeshConfig())
    jeng = JEngine(mesh, JLlama(jcfg), fp, max_len=32, cache_dtype=jnp.float32,
                   param_dtype=jnp.float32, quantize="int8")
    teng = _port_engine(fp, cfg=dataclasses.replace(LlamaConfig.tiny(), qkv_fused=True),
                        quantize="int8")
    assert teng.model.blocks.blocks()[0].attn.qkv.quantized
    kw = ({"slots": 2, "decode_chunk": 3, "prefill_block": 4} if kind == "contiguous"
          else {"slots": 2, "block_size": 8, "num_blocks": 16, "prefill_chunk": 8})
    jcls, tcls = ((JContiguous, ContinuousBatchingEngine) if kind == "contiguous"
                  else (JPaged, PagedContinuousBatchingEngine))
    jsch = jcls(jeng, gen=JGen(max_new_tokens=8), **kw)
    tsch = tcls(teng, gen=GenerationConfig(max_new_tokens=8), **kw)
    prompts = _prompts()
    jrids = [jsch.submit(pr) for pr in prompts]
    trids = [tsch.submit(pr) for pr in prompts]
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(tsch.result(tr), np.asarray(jsch.result(jr)))


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_fused_speculative_paths_keep_the_greedy_tokens(mode):
    """The verify pass (paged, T = K+1) and the draft's steps project
    through the fused ``Dense`` too: greedy tokens equal the unfused
    plain engine's on the same weights."""
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), qkv_fused=True)
    _, p = _jax_llama()
    fp = _fuse_tree(p, jcfg.num_heads, jcfg.num_kv_heads, jcfg.dim // jcfg.num_heads)
    fcfg = dataclasses.replace(LlamaConfig.tiny(), qkv_fused=True)
    fused, plain = _port_engine(fp, cfg=fcfg), _port_engine(p)
    draft = _port_engine(fp, cfg=fcfg) if mode == "draft" else None
    from tensorlink_tpu_torch.parallel.speculative import SpecConfig

    kw = {"slots": 2, "block_size": 8, "num_blocks": 16, "prefill_chunk": 8,
          "gen": GenerationConfig(max_new_tokens=8)}
    sch = PagedContinuousBatchingEngine(fused, draft=draft, speculative=SpecConfig(k=3), **kw)
    ref = PagedContinuousBatchingEngine(plain, **kw)
    for pr in _prompts():
        np.testing.assert_array_equal(sch.result(sch.submit(pr)), ref.result(ref.submit(pr)))
    assert sch.stats()["spec"]["verify_passes"] > 0


# ---------------------------------------------------------- program_cost
def test_program_cost_bills_int8_weights_at_their_bytes():
    """Weight bytes of one pass, by hand: each Dense [in, out] holds in x
    out int8 bytes plus out f32 scales; Llama's untied head is a Dense
    too, GPT-2's tied head reads its bf16 embedding table. The engine's figure feeds program_cost (and so MBU and every
    receipt) unchanged, and the bf16 engine keeps 2 bytes a weight."""
    cfg = LlamaConfig.tiny()
    d, H, G, hid, V, Lyr = cfg.dim, cfg.num_heads, cfg.num_kv_heads, cfg.hidden_dim, \
        cfg.vocab_size, cfg.num_layers
    Dh = d // H
    mats = [(d, H * Dh), (d, G * Dh), (d, G * Dh), (H * Dh, d),
            (d, hid), (d, hid), (hid, d)]
    by_hand = Lyr * sum(i * o + 4 * o for i, o in mats) + d * V + 4 * V
    eng8 = _port_engine(None, quantize="int8")
    assert eng8.weight_bytes == by_hand
    model = Llama(cfg, device="cpu")
    bf = InferenceEngine(model, max_len=32, device="cpu")  # bf16 params
    assert bf.weight_bytes == 2 * (Lyr * sum(i * o for i, o in mats) + d * V)
    # GPT-2's head is tied: its embedding table [V, d] is read once a
    # pass, stored bf16 beside the int8 Dense weights
    gcfg = GPT2Config.tiny()
    gd, gV, gL = gcfg.dim, gcfg.vocab_size, gcfg.num_layers
    gmats = [(gd, gd)] * 4 + [(gd, 4 * gd), (4 * gd, gd)]
    g8 = InferenceEngine(GPT2(gcfg, device="cpu"), max_len=32, device="cpu",
                         quantize="int8")
    assert g8.weight_bytes == gL * sum(i * o + 4 * o for i, o in gmats) + 2 * gV * gd
    kvb = 2 * G * Dh * 4
    got = profiling.program_cost(cfg, "decode", rows=2, steps=3, frontier=[10, 12],
                                 weight_bytes=eng8.weight_bytes, kv_token_bytes=kvb)
    ref = profiling.program_cost(cfg, "decode", rows=2, steps=3, frontier=[10, 12],
                                 weight_bytes=bf.weight_bytes, kv_token_bytes=kvb)
    kv_part = ref["bytes"] - 3 * bf.weight_bytes
    assert got["bytes"] == 3 * by_hand + kv_part
    assert got["flops"] == ref["flops"]
    sch = PagedContinuousBatchingEngine(eng8, slots=2, block_size=8, prefill_chunk=8)
    c = sch._cost("decode", rows=2, steps=3, frontier=[10, 12])
    assert c["bytes"] == 3 * by_hand + sch._kv_token_bytes * Lyr * (
        sum(range(10 - 3 + 1, 10 + 1)) + sum(range(12 - 3 + 1, 12 + 1)))
