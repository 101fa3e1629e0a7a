"""PyTorch port, serving on a mesh: ``InferenceEngine(mesh=)``, its
``generate`` over data and model, the contiguous and paged engines and
speculation at local KV heads.

One spawned job of gloo ranks a mesh shape (``torch_tp_serving_ranks``),
each running every case of that shape while this process runs the JAX
engines on the same mesh of the virtual 8-device CPU, on the same
params (``convert.params_from_jax`` of a JAX init), f32 throughout:

- data 2 x model 2 (4 ranks): ``generate``, the contiguous engine with 4
  slots split over data, and n-gram and self-draft speculation on it,
  token-equal to the JAX engines (the port of ``test_inference.py``'s
  tensor-parallel decode test), with the JAX speculation's counts and
  logits within 1e-4; the ranks' receipts bill the world-1 engine's
  flops;
- model 4 (4 ranks) at one KV head a rank: ``generate`` and the paged
  engine, token-equal to the JAX engines on a model-4 mesh (the paged
  one through its XLA path);
- model 2 (2 ranks): int8, the fused q/k/v layout (``generate``, both
  engines), the ring, n-gram, self-draft and int8-sibling speculation in
  both engines, and GPT-2 through the contiguous engine, each
  token-equal to the JAX engines on a model-2 mesh and to the port at
  world 1, the speculation with both's counts; disaggregated serving
  2 -> 2, 1 -> 2 and 2 -> 1 (payloads at the global KV heads, the same
  on both ranks and equal to a world-1 export), token-equal to the JAX
  paged engine on the model-2 mesh.

Every job checks the collectives a model call issues (two a block and
one for Llama's vocab-sharded head), each rank's weight bytes and that
the q/k/v leaves are blocks, and records the refusals that need a mesh.
The refusals that need none, the capture rule and the quantized spec
tree run in this process.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_serving_ranks as R
from tensorlink_tpu.config import MeshConfig as JMeshConfig
from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.serving import ContinuousBatchingEngine as JContiguous
from tensorlink_tpu.parallel.serving import PagedContinuousBatchingEngine as JPaged
from tensorlink_tpu.parallel.speculative import SpecConfig as JSpecConfig
from tensorlink_tpu.runtime.mesh import make_mesh as jmake_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel.inference import weight_pass_bytes
from torch_ranks import spawn_cpu_ranks

MAX_NEW = 6
LOGIT_ATOL = 1e-4
TINY = dataclasses.asdict(LlamaConfig.tiny())
# one KV head a rank on a model axis of 4
GQA4 = {**TINY, "dim": 64, "num_heads": 8, "num_kv_heads": 4, "hidden_dim": 128}
SPEC = {"k": 3, "rounds": 2}
CONT = {"slots": 2, **R.CONT_KW}


def _inputs():
    """Left-padded ``generate`` rows and the engines' prompts (more than
    the slots, lengths across prefill blocks and chunks)."""
    r = np.random.default_rng(0)
    ids = r.integers(0, 128, (2, 6))
    pad = np.ones((2, 6), np.int64)
    pad[0, :2] = 0
    ids[0, :2] = 0
    prompts = [r.integers(0, 128, (n,)) for n in (3, 7, 1, 11, 5)]
    return ids, pad, prompts


def _jax_llama(cfg: dict, seed: int):
    jm = JLlama(JLlamaConfig(**cfg))
    return jm, jax.device_get(jm.init(jax.random.key(seed)))


def _jax_gpt2(cfg: dict, seed: int):
    jm = JGPT2(JGPT2Config(**cfg))
    return jm, jax.device_get(jm.init(jax.random.key(seed)))


def _jax_engine(jm, p, mesh_kw: dict, **kw):
    return JEngine(jmake_mesh(JMeshConfig(**mesh_kw)), jm, p,
                   **{"max_len": 32, "cache_dtype": jnp.float32,
                      "param_dtype": jnp.float32, **kw})


def _jax_serve(jeng, prompts, cls, **kw):
    """Every prompt through a JAX serving engine: -> (tokens a request,
    the speculation's counts or None)."""
    sch = cls(jeng, gen=JGen(max_new_tokens=MAX_NEW), **kw)
    outs = [np.asarray(sch.result(r)) for r in [sch.submit(p) for p in prompts]]
    spec = sch.stats().get("spec")
    return outs, spec and [spec[k] for k in R.SPEC_KEYS]


class _Job:
    """A spawned job run on a thread, so this process computes the JAX
    side meanwhile; ``results`` joins it and loads every rank's file."""

    def __init__(self, fn, world: int, out_dir, *args):
        self.world, self.dir, self.error = world, str(out_dir), None

        def run():
            try:
                spawn_cpu_ranks(fn, world, self.dir, *args, store_dir=self.dir)
            except BaseException as e:  # re-raised in results()
                self.error = e

        self.thread = threading.Thread(target=run)
        self.thread.start()

    def results(self) -> list[dict]:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def _equal(outs, refs) -> None:
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(np.asarray(o), np.asarray(r))


def _check_rank(res: dict, world1_bytes: int, model: int, cfg: dict) -> None:
    """Blocks, per-rank bytes and the collectives of one model call."""
    layers = cfg["num_layers"]
    # the q projection and the head are column blocks, o a row block
    assert res["blocks"]["blocks.0.attn.q.w"] == (cfg["dim"], cfg["dim"] // model)
    assert res["blocks"]["blocks.0.attn.o.w"] == (cfg["dim"] // model, cfg["dim"])
    assert res["blocks"]["lm_head.w"] == (cfg["dim"], cfg["vocab_size"] // model)
    # every Dense of a Llama is a block: a rank reads 1/model of the bytes
    assert res["weight_bytes"] * model == world1_bytes
    assert res["call_collectives"] == 2 * layers + 1
    assert res["generate_collectives"] == (2 * layers + 1) * MAX_NEW


def test_data_model_generate_and_contiguous_match_jax(tmp_path, devices):
    jm, p = _jax_llama(TINY, 0)
    state = params_from_jax(p)
    ids, pad, prompts = _inputs()
    job = _Job(R.job_data_model, 4, tmp_path, TINY, state, ids, pad, prompts, MAX_NEW)
    jeng = _jax_engine(jm, p, {"data": 2, "model": 2})
    assert "model" in jeng.params["blocks"]["0"]["attn"]["q"]["w"].sharding.spec
    jgen = np.asarray(jeng.generate(ids, JGen(max_new_tokens=MAX_NEW), pad_mask=pad))
    cont = {"slots": 4, **R.CONT_KW}
    jouts = _jax_serve(jeng, prompts, JContiguous, **cont)[0]
    jspec = {mode: _jax_serve(jeng, prompts, JContiguous, speculative=JSpecConfig(**SPEC),
                              draft=jeng if mode == "self" else None, **cont)
             for mode in ("ngram", "self")}
    jlogits = np.asarray(jm.apply(p, jnp.asarray(ids)))
    world1 = R.engine("llama", TINY, state)
    bytes1 = weight_pass_bytes(world1.model)
    flops1 = R.served_flops(R.serve(world1, prompts, MAX_NEW, False, slots=4)[1])
    results = job.results()
    for res in results:
        np.testing.assert_array_equal(res["generate"], jgen)
        _equal(res["contiguous"], jouts)
        for mode, (outs, counts) in jspec.items():
            _equal(res["spec"][mode]["outs"], outs)
            assert res["spec"][mode]["counts"] == counts, mode
        np.testing.assert_allclose(res["logits"].numpy(), jlogits, atol=LOGIT_ATOL)
        _check_rank(res, bytes1, 2, TINY)
        # the slots split over data: 2 rows of state, 1 of 2 KV heads
        assert res["local_slots"] == 2
        assert res["cache_shape"][0] == 2 and res["cache_shape"][2] == 1
        kind, msg = res["refusals"]["paged_data"]
        assert kind == "NotImplementedError" and "data axis" in msg
    # each rank bills its own rows at its share of the flops: the four
    # ranks' receipts sum to the one-device engine's
    assert flops1 > 0
    np.testing.assert_allclose(sum(r["served_flops"] for r in results), flops1,
                               rtol=1e-9)


def test_model4_one_kv_head_a_rank_matches_jax(tmp_path, devices):
    jm, p = _jax_llama(GQA4, 3)
    state = params_from_jax(p)
    ids, pad, prompts = _inputs()
    job = _Job(R.job_model4, 4, tmp_path, GQA4, state, ids, pad, prompts, MAX_NEW)
    jeng = _jax_engine(jm, p, {"model": 4})
    assert "model" in jeng.params["blocks"]["0"]["attn"]["k"]["w"].sharding.spec
    jgen = np.asarray(jeng.generate(ids, JGen(max_new_tokens=MAX_NEW), pad_mask=pad))
    jouts = _jax_serve(jeng, prompts, JPaged, **R.PAGED_KW)[0]
    jlogits = np.asarray(jm.apply(p, jnp.asarray(ids)))
    bytes1 = weight_pass_bytes(R.engine("llama", GQA4, state).model)
    for res in job.results():
        np.testing.assert_array_equal(res["generate"], jgen)
        _equal(res["paged"], jouts)
        np.testing.assert_allclose(res["logits"].numpy(), jlogits, atol=LOGIT_ATOL)
        assert res["blocks"]["blocks.0.attn.k.w"] == (64, 8)  # one head of 8 dims
        _check_rank(res, bytes1, 4, GQA4)
        assert res["pool_shape"][2] == 1  # the pools hold one KV head
        kind, msg = res["refusals"]["kv_heads"]
        assert kind == "ValueError" and "num_kv_heads" in msg


def _port_state(kind: str, cfg: dict, seed: int) -> dict:
    m = (GPT2(GPT2Config(**cfg), device="cpu", seed=seed) if kind == "gpt2"
         else Llama(LlamaConfig(**cfg), device="cpu", seed=seed))
    return {k: v.clone() for k, v in m.state_dict().items()}


def _jax_model2(models: dict, cases: dict, ids, pad, prompts) -> dict:
    """The JAX engines on a model-2 mesh, on the model-2 cases' params:
    name -> the tokens (and speculation counts) the port must give."""
    mesh = {"model": 2}
    gen = JGen(max_new_tokens=MAX_NEW)
    jm, p = models["int8"]
    target = _jax_engine(jm, p, mesh)
    # the int8 case's engine; also the twin of the target's int8 sibling
    int8 = _jax_engine(jm, p, mesh, quantize="int8")
    out = {"int8": {"generate": np.asarray(int8.generate(ids, gen, pad_mask=pad))}}
    jm, p = models["fused"]
    eng = _jax_engine(jm, p, mesh)
    assert "model" in eng.params["blocks"]["0"]["attn"]["qkv"]["w"].sharding.spec
    out["fused"] = {"generate": np.asarray(eng.generate(ids, gen, pad_mask=pad)),
                    "contiguous": _jax_serve(eng, prompts, JContiguous, **CONT)[0],
                    "paged": _jax_serve(eng, prompts, JPaged, **R.PAGED_KW)[0],
                    "logits": np.asarray(jm.apply(p, jnp.asarray(ids)))}
    jm, p = models["ring"]
    eng = _jax_engine(jm, p, mesh, rolling_cache=True, max_len=48)
    out["ring"] = {"generate": np.asarray(eng.generate(
        ids, JGen(max_new_tokens=cases["ring"]["max_new"]), pad_mask=pad))}
    spec = {}
    for kind, cls, kw in (("contiguous", JContiguous, CONT), ("paged", JPaged, R.PAGED_KW)):
        for mode, draft in (("ngram", None), ("self", target), ("int8-sibling", int8)):
            outs, counts = _jax_serve(target, prompts, cls, draft=draft,
                                      speculative=JSpecConfig(**SPEC), **kw)
            spec[(kind, mode)] = {"outs": outs, "counts": counts}
    out["spec"] = spec
    jm, p = models["gpt2"]
    out["gpt2"] = {"contiguous": _jax_serve(_jax_engine(jm, p, mesh), prompts,
                                            JContiguous, **CONT)[0],
                   "logits": np.asarray(jm.apply(p, jnp.asarray(ids)))}
    # the disaggregation cases' colocated tokens (the int8 case's params)
    out["paged"] = _jax_serve(target, prompts, JPaged, **R.PAGED_KW)[0]
    return out


def test_model2_cases_match_world1(tmp_path, devices):
    ring = dataclasses.asdict(LlamaConfig.mistral_tiny())
    gpt2 = dataclasses.asdict(GPT2Config.tiny())
    fused = {**TINY, "qkv_fused": True}
    models = {"int8": _jax_llama(TINY, 1), "fused": _jax_llama(fused, 2),
              "ring": _jax_llama(ring, 3), "gpt2": _jax_gpt2(gpt2, 5)}
    state = {name: params_from_jax(p) for name, (_, p) in models.items()}
    cases = {
        "int8": {"cfg": TINY, "state": state["int8"]},
        "fused": {"cfg": fused, "state": state["fused"]},
        "ring": {"cfg": ring, "state": state["ring"], "max_new": 20},
        # the int8 case's params, so the JAX int8 engine drafts as the
        # port's int8 sibling does
        "spec": {"cfg": TINY, "state": state["int8"]},
        "gpt2": {"cfg": gpt2, "state": state["gpt2"]},
        # three experts cannot split over model 2
        "moe": {"cfg": {**dataclasses.asdict(LlamaConfig.moe_tiny()), "moe_experts": 3}},
    }
    ids, pad, prompts = _inputs()
    # a world-1 prefill leg's payloads, for the model-2 decode leg (1 -> 2)
    one = R.engine("llama", TINY, state["int8"])
    cases["disagg"] = {"payloads": R.disagg(one, prompts, [], MAX_NEW)["payloads"]}
    job = _Job(R.job_model2, 2, tmp_path, cases, ids, pad, prompts, MAX_NEW)
    jref = _jax_model2(models, cases, ids, pad, prompts)
    ref = R.model2_cases(None, cases, ids, pad, prompts, MAX_NEW)
    results = job.results()
    for res in results:
        for want in (jref, ref):
            for name in ("int8", "fused", "ring"):
                np.testing.assert_array_equal(res[name]["generate"], want[name]["generate"])
            for name in ("fused", "gpt2"):
                _equal(res[name]["contiguous"], want[name]["contiguous"])
            _equal(res["fused"]["paged"], want["fused"]["paged"])
            for key, got in res["spec"].items():
                _equal(got["outs"], want["spec"][key]["outs"])
                assert got["counts"] == want["spec"][key]["counts"], key
        for name, per_call in (("int8", 5), ("fused", 5), ("gpt2", 4)):
            logits, n = res[name]["call"]
            np.testing.assert_allclose(logits.numpy(), ref[name]["call"][0].numpy(),
                                       atol=LOGIT_ATOL)
            if name != "int8":
                np.testing.assert_allclose(logits.numpy(), jref[name]["logits"],
                                           atol=LOGIT_ATOL)
            assert n == per_call and ref[name]["call"][1] == 0
        assert res["ring"]["collectives"] == 5 * cases["ring"]["max_new"]
        # int8: "col" scales split with their columns, "row" scales whole
        b = res["int8"]["blocks"]
        assert b["blocks.0.attn.q.w.q"] == (32, 16) and b["blocks.0.attn.q.w.s"] == (16,)
        assert b["blocks.0.attn.o.w.q"] == (16, 32) and b["blocks.0.attn.o.w.s"] == (32,)
        assert res["fused"]["blocks"]["blocks.0.attn.qkv.w"] == (32, 32)
        for name in ("fused", "ring"):
            assert 2 * res[name]["weight_bytes"] == ref[name]["weight_bytes"]
        # the tied wte stays whole on every rank
        wte = 128 * gpt2["dim"] * 4
        assert 2 * (res["gpt2"]["weight_bytes"] - wte) == ref["gpt2"]["weight_bytes"] - wte
        ref_msgs = res["refusals"]
        assert ref_msgs["moe"][0] == "ValueError"
        assert "3 experts" in ref_msgs["moe"][1] and "model axis of 2" in ref_msgs["moe"][1]
        assert ref_msgs["seq_ring"][0] == "NotImplementedError"
        assert "rolling_cache" in ref_msgs["seq_ring"][1]
        for name in ("seq_contiguous", "seq_paged"):
            kind, msg = ref_msgs[name]
            assert kind == "NotImplementedError" and "kv_seq_shard" in msg
    # disaggregation: the payloads hold every KV head, the same on both
    # ranks and equal to the world-1 leg's; 2 -> 2, 1 -> 2 and 2 -> 1
    # decode the JAX colocated tokens
    d = [res["disagg"] for res in results]
    world1 = cases["disagg"]["payloads"]
    for pl0, pl1, pw in zip(d[0]["payloads"], d[1]["payloads"], world1):
        for a, b, w in zip(pl0["layers"], pl1["layers"], pw["layers"]):
            for name in w:
                assert a[name].shape == w[name].shape
                assert torch.equal(a[name], b[name])
                np.testing.assert_allclose(a[name].numpy(), w[name].numpy(), atol=1e-5)
    two_to_one = R.disagg(one, [], d[0]["payloads"], MAX_NEW)["imported"]
    for got in (d[0]["here"], d[1]["here"], d[0]["imported"], d[1]["imported"],
                two_to_one):
        _equal(got, jref["paged"])


def test_world1_mesh_engine_is_the_one_device_engine():
    """``make_mesh(MeshConfig())`` forms a one-rank group: the engine cuts
    nothing, issues no collective, and ``generate`` and the contiguous
    engine give the no-mesh engine's tokens."""
    from tensorlink_tpu_torch.config import MeshConfig
    from tensorlink_tpu_torch.parallel import tp
    from tensorlink_tpu_torch.runtime.mesh import make_mesh, shutdown_distributed

    state = _port_state("llama", TINY, 6)
    ids, pad, prompts = _inputs()
    plain = R.engine("llama", TINY, state)
    want = R.generate(plain, ids, pad, MAX_NEW)[0]
    want_c = R.serve(plain, prompts, MAX_NEW, False)[0]
    mesh = make_mesh(MeshConfig(), device="cpu")
    try:
        eng = R.engine("llama", TINY, state, mesh)
        got, n = R.generate(eng, ids, pad, MAX_NEW)
        np.testing.assert_array_equal(got, want)
        assert n == 0
        tp.reset_collectives()
        _equal(R.serve(eng, prompts, MAX_NEW, False)[0], want_c)
        assert sum(tp.collective_counts().values()) == 0
        assert eng.weight_bytes == plain.weight_bytes
    finally:
        shutdown_distributed()


def test_kv_seq_shard_needs_a_seq_axis():
    with pytest.raises(ValueError, match="seq"):
        R.engine("llama", TINY, None, kv_seq_shard=True)


def test_row_block_quantizes_only_with_its_group():
    """A row block's int8 scales span the whole weight's rows, which
    other ranks hold: without the model group it is refused, not given
    its own rows' scales; a whole row weight needs no group."""
    from tensorlink_tpu_torch.nn.layers import Dense
    from tensorlink_tpu_torch.ops.quant import quantize_params_int8

    block = Dense(8, 4, shard="row", device="cpu")
    block.w = torch.nn.Parameter(torch.ones(4, 4), requires_grad=False)  # 4 of 8 rows
    with pytest.raises(ValueError, match="group="):
        quantize_params_int8(block)
    whole = Dense(8, 4, shard="row", device="cpu")
    whole.w = torch.nn.Parameter(torch.ones(8, 4), requires_grad=False)
    assert quantize_params_int8(whole).quantized


@pytest.mark.parametrize("device, backend, size, graphs, refused", [
    ("cuda", "gloo", 2, True, True),
    ("cuda", "gloo", 2, False, False),
    ("cuda", "gloo", 1, True, False),
    ("cuda", "nccl", 2, True, False),
    ("cpu", "gloo", 4, True, False),
])
def test_capture_needs_nccl_groups(device, backend, size, graphs, refused):
    from tensorlink_tpu_torch.runtime.graphs import check_capture_backend

    if refused:
        with pytest.raises(ValueError, match="cuda_graphs=False"):
            check_capture_backend(device, backend, size, graphs)
    else:
        check_capture_backend(device, backend, size, graphs)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_quantized_spec_tree_matches_reference(name):
    from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
    from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from tensorlink_tpu.ops.quant import quantize_params_int8 as jquant
    from tensorlink_tpu.ops.quant import quantized_spec_tree as jspec_tree
    from tensorlink_tpu_torch.nn.module import flat_specs
    from tensorlink_tpu_torch.ops.quant import quantize_params_int8, quantized_spec_tree

    if name == "llama":
        jm, tm = JLlama(JLlamaConfig(**TINY)), Llama(LlamaConfig.tiny(), device="cpu")
    else:
        jm = JGPT2(JGPT2Config.tiny())
        tm = GPT2(GPT2Config.tiny(), device="cpu")
    jp = jquant(jm, jm.init(jax.random.key(0)))
    j = jspec_tree(jm.param_spec(), jp)
    quantize_params_int8(tm)
    t = flat_specs(quantized_spec_tree(tm.param_spec(), dict(tm.state_dict())))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else k
            out.update(flat(v, key) if isinstance(v, dict) else {key: tuple(v)})
        return out

    assert {k: tuple(v) for k, v in t.items()} == flat(j)
    assert set(t) == set(tm.state_dict())
