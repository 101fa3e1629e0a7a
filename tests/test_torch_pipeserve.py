"""PyTorch port, pipeline-sharded serving: nn/staging.py and
parallel/pipeserve.py, held against the JAX package's modules on the
same params (carried by ``convert.py``, f32 on the CPU).

- ``stage_spans``, ``plan_pipeline``, ``StageSlice``'s param keys and
  ``layer_param_bytes``, and the ``pack_act_payload`` bytes equal the
  reference's; the hostile blobs are refused.
- A 3-stage ``PipelineStageEngine`` chain is greedy token-identical to
  the JAX chain and to the port's single paged engine; the sampled chain
  (temperature 0.9, top-k 40) equals the port's single engine.
- A three-node pipeline of port workers serves through a
  ``RemoteServingClient`` token-identically, and survives a stage
  killed mid-stream (the validator recruits the pre-loaded spare, the
  head re-prefills) without losing an accepted token; malformed
  ``ACT_FWD`` frames are refused typed.
"""

import asyncio

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
from tensorlink_tpu.nn import staging as jstaging
from tensorlink_tpu.parallel import pipeserve as jpipeserve
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.nn.staging import (
    StageSlice,
    layer_param_bytes,
    param_bytes,
    stage_spans,
)
from tensorlink_tpu_torch.p2p.serialization import pack_arrays
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.pipeserve import (
    ACT_WIRE_SCHEMA,
    PipelineStageEngine,
    pack_act_payload,
    plan_pipeline,
    unpack_act_payload,
)
from tensorlink_tpu_torch.parallel.serving import (
    PagedContinuousBatchingEngine,
    PoolOverloadedError,
    PromptTooLongError,
)
from tensorlink_tpu_torch.runtime import chaos

TINY3 = dict(vocab_size=128, dim=32, num_layers=3, num_heads=4, num_kv_heads=2,
             hidden_dim=64, max_len=64, rope_theta=10000.0)
SPANS3 = [(0, 1), (1, 2), (2, 3)]


@pytest.fixture(scope="module")
def tiny3():
    jm = JLlama(JLlamaConfig(**TINY3))
    jp = jm.init(jax.random.key(0))
    return jm, jp, params_from_jax(jax.device_get(jp))


def _engine(tiny3):
    model = Llama(LlamaConfig(**TINY3), device="cpu", seed=None)
    return InferenceEngine(model, tiny3[2], max_len=32, cache_dtype=torch.float32,
                           param_dtype=torch.float32, device="cpu")


def _jengine(tiny3):
    return JEngine(make_mesh(MeshConfig()), tiny3[0], tiny3[1], max_len=32,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)


def _stage_kw(gen):
    return dict(slots=2, gen=gen, block_size=4, prefill_chunk=4, max_len=32)


def _prompts(lengths, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(0, 128, (n,)) for n in lengths]


def _single(tiny3, prompts, gen, seed=7):
    eng = PagedContinuousBatchingEngine(_engine(tiny3), slots=2, gen=gen,
                                        decode_chunk=3, block_size=4)
    return [list(np.asarray(eng.result(eng.submit(p, seed=seed)))) for p in prompts]


def _run_chain(stages, ids, seed, budget):
    """Drive a stage chain in process: the coordinator's data path
    without the network (works for either package's stages)."""
    ids = [int(t) for t in ids]
    n_ctx, C = len(ids), stages[0].chunk_len
    tok0 = None
    for start in range(0, n_ctx, C):
        chunk = ids[start:start + C]
        x = np.asarray(chunk + [0] * (C - len(chunk)), np.int32)[None, :]
        for s in stages:
            x = s.prefill_chunk(0, x, start, len(chunk), seed, n_ctx=n_ctx,
                                budget=budget)
        tok0 = int(np.asarray(x))
    toks, n_valid = [tok0], n_ctx + 1
    for _ in range(budget - 1):
        x = np.asarray([toks[-1], 0], np.int32)
        nv = np.asarray([n_valid - 1, 0], np.int32)
        live = np.asarray([True, False])
        seeds = np.asarray([seed, 0], np.uint32)
        for s in stages:
            x = s.decode_step(x, nv, live, seeds)
        toks.append(int(np.asarray(x)[0]))
        n_valid += 1
    return toks


# --------------------------------------------------- planning and the wire


def test_stage_spans_and_plan_equal_reference():
    for loads, caps in (([1] * 6, [1, 1, 1]), ([1] * 8, [3, 1]),
                        ([5, 1, 1, 1, 1], [1, 1]), ([7, 1], [1, 9]),
                        ([3, 9, 2, 2, 7], [2, 5, 1])):
        assert stage_spans(loads, caps) == jstaging.stage_spans(loads, caps)
    for loads, caps in (([1, 1], [1, 1, 1]), ([1, 1], [1, 0])):
        with pytest.raises(ValueError):
            stage_spans(loads, caps)
    fleet = {"big": {"hbm_bytes": 100.0, "hbm_gbps": 10.0},
             "mid": {"hbm_bytes": 60.0, "hbm_gbps": 99.0},
             "sml": {"hbm_bytes": 10.0}, "novram": {"peak_tflops": 5.0},
             "bad": {"hbm_bytes": "x"}}
    for kw in ({"need_bytes": 90}, {"need_bytes": 150}, {"n_stages": 3},
               {"need_bytes": 65, "exclude": ("big",)}, {"need_bytes": 1000},
               {"n_stages": 5}, {"n_stages": 2, "need_bytes": 500}):
        assert plan_pipeline(fleet, **kw) == jpipeserve.plan_pipeline(fleet, **kw)
    with pytest.raises(ValueError):
        plan_pipeline(fleet)


@pytest.mark.parametrize("codec", ["zstd", "zlib", "none"])
def test_act_payload_bytes_equal_reference(codec):
    r = np.random.default_rng(0)
    for x in (r.normal(size=(2, 1, 32)).astype(np.float32),
              np.asarray([3, 5], np.int32), r.integers(0, 9, (1, 4)).astype(np.int32)):
        assert pack_act_payload(x, codec) == jpipeserve.pack_act_payload(x, codec)
        assert pack_act_payload(torch.from_numpy(x), codec) == \
            jpipeserve.pack_act_payload(x, codec)
        back = unpack_act_payload(jpipeserve.pack_act_payload(x, codec))
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            jpipeserve.unpack_act_payload(pack_act_payload(x, codec)), x)


def test_act_payload_hostile_rejects():
    x = np.zeros((2, 1, 8), np.float32)
    with pytest.raises(ValueError):
        unpack_act_payload({"x": x})
    blob = bytearray(pack_act_payload(x, codec="none"))
    blob[-3] ^= 0xFF
    with pytest.raises(ValueError):
        unpack_act_payload(bytes(blob))
    with pytest.raises(ValueError, match="schema"):
        unpack_act_payload(pack_arrays(
            {"schema": np.asarray(ACT_WIRE_SCHEMA + 9, np.int32), "x": x}))
    with pytest.raises(ValueError, match="rank"):
        unpack_act_payload(pack_arrays(
            {"schema": np.asarray(ACT_WIRE_SCHEMA, np.int32),
             "x": np.zeros((1, 1, 1, 1), np.float32)}))


def test_stage_slice_keys_and_bytes_equal_reference(tiny3):
    jm, jp, tp = tiny3
    tm = Llama(LlamaConfig(**TINY3), device="cpu", seed=None)
    tm.load_state_dict(tp)
    for lo, hi in [(0, 1), (1, 2), (2, 3), (0, 3), (1, 3)]:
        ts, js = StageSlice(tm, lo, hi), jstaging.StageSlice(jm, lo, hi)
        assert ts.param_keys() == js.param_keys()
        assert param_bytes(ts.stage_params()) == jstaging.param_bytes(js.slice_params(jp))
        assert set(ts.slice_params(jp)) == set(js.slice_params(jp))
        for name, t in ts.stage_params().items():
            assert t is dict(tm.named_parameters())[name]  # shared, not copied
    assert layer_param_bytes(tm) == jstaging.layer_param_bytes(jp)
    jg = JGPT2(JGPT2Config.tiny())
    tg = GPT2(GPT2Config.tiny(), device="cpu")
    n = GPT2Config.tiny().num_layers
    for lo, hi in [(0, 1), (1, n), (0, n)]:
        assert StageSlice(tg, lo, hi).param_keys() == \
            jstaging.StageSlice(jg, lo, hi).param_keys()
    with pytest.raises(ValueError):
        StageSlice(tm, 2, 1)


# ------------------------------------------------------------ chain parity


def test_chain_greedy_equals_jax_chain_and_single_engine(tiny3):
    gen, jgen = GenerationConfig(max_new_tokens=6), JGen(max_new_tokens=6)
    prompt = _prompts((9,))[0]
    (ref,) = _single(tiny3, [prompt], gen)
    jeng, teng = _jengine(tiny3), _engine(tiny3)
    jstages = [jpipeserve.PipelineStageEngine(
        jeng, lo=lo, hi=hi, sid="t", stage=i, n_stages=3, **_stage_kw(jgen))
        for i, (lo, hi) in enumerate(SPANS3)]
    jtoks = _run_chain(jstages, prompt, 7, 6)
    for spans in ([(0, 2), (2, 3)], SPANS3):
        stages = [PipelineStageEngine(teng, lo=lo, hi=hi, sid="t", stage=i,
                                      n_stages=len(spans), **_stage_kw(gen))
                  for i, (lo, hi) in enumerate(spans)]
        toks = _run_chain(stages, prompt, 7, 6)
        assert toks == jtoks == ref
        assert [s.stats()["layers"] for s in stages] == [list(sp) for sp in spans]


def test_chain_sampled_equals_single_engine(tiny3):
    gen = GenerationConfig(max_new_tokens=6, temperature=0.9, top_k=40)
    prompts = _prompts((9, 4))
    refs = _single(tiny3, prompts, gen)
    teng = _engine(tiny3)
    stages = [PipelineStageEngine(teng, lo=lo, hi=hi, sid="t", stage=i,
                                  n_stages=3, **_stage_kw(gen))
              for i, (lo, hi) in enumerate(SPANS3)]
    for prompt, ref in zip(prompts, refs):
        assert _run_chain(stages, prompt, 7, 6) == ref


def test_stage_engine_stats_and_admission(tiny3):
    gen = GenerationConfig(max_new_tokens=4)
    teng = _engine(tiny3)
    s = PipelineStageEngine(teng, lo=1, hi=2, sid="t", stage=1, n_stages=3,
                            **_stage_kw(gen))
    st = s.stats()
    assert st["pipeline_stage"] == 1 and st["layers"] == [1, 2]
    assert st["decode_steps"] == 0 and 0.0 <= st["bubble_frac"] <= 1.0
    with pytest.raises(PromptTooLongError):
        s.begin_request(0, 30, 10)
    with pytest.raises(ValueError, match="shape"):
        s.decode_step(np.zeros((2, 1, 8), np.float32), [0, 0], [True, False], [0, 0])
    tight = PipelineStageEngine(teng, lo=1, hi=2, sid="t", stage=1, n_stages=3,
                                num_blocks=8, **_stage_kw(gen))
    tight.begin_request(0, 16, 16)
    with pytest.raises(PoolOverloadedError):
        tight.begin_request(1, 16, 16)
    tight.release_slot(0)
    assert tight.pool.available == 8


# --------------------------------------------------------- three port nodes


def _cfg(role):
    return NodeConfig(role=role, host="127.0.0.1", port=0)


def _winfo(w):
    return {"node_id": w.node_id, "host": "127.0.0.1", "port": w.port}


async def _pipeline_fleet(tiny3, gen, spans, *, spare_stage=None):
    from tensorlink_tpu_torch.roles.user import UserNode
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    n = len(spans)
    val = ValidatorNode(_cfg("validator"), device="cpu")
    ws = [WorkerNode(_cfg("worker"), device="cpu") for _ in spans]
    spare = WorkerNode(_cfg("worker"), device="cpu") if spare_stage is not None else None
    user = UserNode(_cfg("user"))
    nodes = [val, *ws, user] + ([spare] if spare else [])
    for node in nodes:
        await node.start()
    kw = _stage_kw(gen)
    eng = _engine(tiny3)
    hbm = int(param_bytes(tiny3[2]) * 0.7)  # no one worker holds the model
    for i in range(1, n):
        ws[i].pipeline_stage(eng, sid="s", stage=i, n_stages=n, lo=spans[i][0],
                             hi=spans[i][1], **kw)
    if spare is not None:
        spare.pipeline_stage(eng, sid="s", stage=spare_stage, n_stages=n,
                             lo=spans[spare_stage][0], hi=spans[spare_stage][1], **kw)
    vpeer0 = await ws[0].connect("127.0.0.1", val.port)
    ws[0].pipeline_stage(eng, sid="s", stage=0, n_stages=n, lo=spans[0][0],
                         hi=spans[0][1], route=[_winfo(w) for w in ws[1:]],
                         validator=vpeer0, **kw)
    for w in ws + ([spare] if spare else []):
        w.capability = dict(w.capability or {}, hbm_bytes=hbm)
        await val.ping(await val.connect("127.0.0.1", w.port))
    vpeer = await user.connect("127.0.0.1", val.port)
    return val, ws, spare, user, vpeer, nodes


@pytest.mark.asyncio
async def test_three_node_pipeline_end_to_end(tiny3):
    gen = GenerationConfig(max_new_tokens=6)
    prompts = _prompts((9, 5))
    refs = _single(tiny3, prompts, gen)
    val, ws, _, user, vpeer, nodes = await _pipeline_fleet(tiny3, gen, SPANS3)
    try:
        fleet = val.peer_capabilities
        hbms = [c["hbm_bytes"] for c in fleet.values() if "hbm_bytes" in c]
        assert len(hbms) == 3 and max(hbms) < param_bytes(tiny3[2]) <= sum(hbms)
        by_stage = {c.get("pipe_stage"): nid for nid, c in fleet.items()
                    if c.get("pipe_sid") == "s"}
        assert sorted(by_stage) == [0, 1, 2]
        client = user.remote_serving(vpeer, pipeline=True, sid="s")
        rids = [await client.submit(p, seed=7) for p in prompts]
        outs = [list(await client.result(rid)) for rid in rids]
        assert outs == refs
        st = ws[0].serving.stats()["pipeline"]
        assert st["act_wire_bytes"] > 0 and st["failovers"] == 0
        steps = [w._pipe_stage.stats()["decode_steps"] for w in ws]
        assert steps[0] == steps[1] == steps[2] > 0
        for nid in by_stage.values():
            assert "pipe_bubble_frac" in fleet[nid] and fleet[nid]["pipe_n_stages"] == 3
    finally:
        for node in nodes:
            await node.stop()


@pytest.mark.asyncio
async def test_stage_death_recovers_without_losing_tokens(tiny3):
    gen = GenerationConfig(max_new_tokens=8)
    prompt = _prompts((9,))[0]
    (ref,) = _single(tiny3, [prompt], gen)
    val, ws, spare, user, vpeer, nodes = await _pipeline_fleet(
        tiny3, gen, [(0, 1), (1, 3)], spare_stage=1)
    try:
        harness = chaos.arm(chaos.ChaosPlan(seed=0).fault(
            "pipeserve.tick", "kill", at=3, handler="kill-stage1"))
        loop = asyncio.get_running_loop()
        harness.on_kill("kill-stage1", lambda **ctx: loop.create_task(ws[1].stop()))
        client = user.remote_serving(vpeer, pipeline=True, sid="s")
        out = await client.result(await client.submit(prompt, seed=7))
        assert list(out) == ref
        st = ws[0].serving.stats()["pipeline"]
        assert st["failovers"] == 1 and st["reprefills"] >= 1
        assert spare._pipe_stage.stats()["decode_steps"] > 0
        kinds = [e.get("kind") for e in ws[0].flight.events()]
        assert "serving.pipeline_failover_done" in kinds
        nodes.remove(ws[1])
    finally:
        chaos.disarm()
        for node in nodes:
            await node.stop()


@pytest.mark.asyncio
async def test_act_fwd_hostile_ingest_rejected(tiny3):
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    gen = GenerationConfig(max_new_tokens=4)
    w = WorkerNode(_cfg("worker"), device="cpu")
    probe = WorkerNode(_cfg("worker"), device="cpu")
    await w.start()
    await probe.start()
    try:
        peer = await probe.connect("127.0.0.1", w.port)
        blob = pack_act_payload(np.zeros((1, 4), np.int32))
        resp = await probe.request(peer, {"type": "ACT_FWD", "meta": {"kind": "decode"},
                                          "blob": blob})
        assert resp["type"] == "SERVE_FAILED"
        w.pipeline_stage(_engine(tiny3), sid="s", stage=1, n_stages=2, lo=1, hi=3,
                         **_stage_kw(gen))
        resp = await probe.request(peer, {"type": "ACT_FWD", "meta": {"kind": "??"},
                                          "blob": blob})
        assert resp["type"] == "SERVE_FAILED"
        assert "malformed activation frame" in resp["error"]
        meta = {"kind": "prefill", "sid": "other", "slot": 0, "start": 0, "nreal": 4,
                "seed": 0, "n_ctx": 4, "budget": 2, "route": []}
        resp = await probe.request(peer, {"type": "ACT_FWD", "meta": meta, "blob": blob})
        assert resp["type"] == "SERVE_FAILED" and "pipeline 'other'" in resp["error"]
        meta["sid"] = "s"
        resp = await probe.request(peer, {"type": "ACT_FWD", "meta": meta, "blob": blob})
        assert resp["type"] == "SERVE_FAILED" and "shape" in resp["error"]
    finally:
        await w.stop()
        await probe.stop()
