"""PyTorch port, expert parallelism: ``MoEFeedForward`` with E/m experts
a rank in both of the reference's lowerings (``nn/moe.py``,
``parallel/ep.py``), ``ShardedTrainer`` over MoE blocks at model > 1 and
``InferenceEngine(mesh=)`` serving a MoE model.

Three spawned gloo jobs (rank bodies in ``torch_ep_ranks``), while this
process runs the JAX package on the same meshes of the virtual 8-device
CPU, on the same params (``convert.params_from_jax`` of a JAX init), f32:

- the module (4 ranks) at model 4, data 2 x model 2 and model 2, in the
  fallback form (``tp.model_parallel``) and the all_to_all form
  (``ep.ep_parallel`` too): output, aux, the router's and the expert
  blocks' gradients and the input's against the JAX module on the same
  mesh (without and with ``jax.set_mesh``) and against the port at world
  1, within atol 1e-5 / rtol 1e-5 (f32 sums in another order); the
  collectives each form issues; a batch that model 4 does not divide
  (the all_to_all form falls back); router noise drawn over the whole
  batch (the world-1 bits); the whole batch's routing stats;
- ``ShardedTrainer`` with ``LlamaConfig.moe_tiny`` (4 ranks) at pipe 2 x
  model 2, GPipe and 1F1B, ``moe_aux_weight=0.5``, SGD: one step's loss
  and pre-clip gradient norm within rtol 1e-5 and every gathered leaf
  within atol 1e-5 / rtol 1e-4 of the JAX trainer on the same mesh; the
  all_to_all swaps a step; the gathered state through
  ``convert.sharded_state_to_jax`` / ``sharded_state_from_jax`` and
  ``adopt_state`` back to every rank's blocks;
- ``InferenceEngine(mesh=model 2)`` with ``moe_tiny`` (2 ranks): the
  contiguous and paged engines' greedy tokens and n-gram speculation's
  tokens and counts, and the int8 sibling's (paged), equal to the JAX
  engines on a model-2 mesh; the sibling keeps the router and experts
  float blocks; two collectives a
  block and one for the head a model call; a rank's weight bytes.

The ``E % m`` refusal runs in this process.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_engine as TE
import test_torch_tp_serving as TS
import torch_ep_ranks as R
import torch_tp_serving_ranks as SR
from tensorlink_tpu.config import MeshConfig as JMeshConfig
from tensorlink_tpu.nn.moe import MoEFeedForward as JMoE
from tensorlink_tpu.runtime.mesh import make_mesh as jmake_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import LlamaConfig
from tensorlink_tpu_torch.nn.moe import MoEFeedForward, check_expert_split

ATOL = RTOL = 1e-5
KW = {"dim": 16, "hidden_dim": 32, "num_experts": 4, "top_k": 2,
      "capacity_factor": 1.0}
MAX_NEW = 6


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def _jax_module(jm, p, x, g, mesh_kw: dict, ambient: bool) -> dict:
    """out, aux and the gradients of ``sum(out * g) + AUX_W * aux`` of the
    JAX module with its params cut by ``param_spec`` on a mesh (``x``
    over ``data``), with or without the ambient mesh."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = jmake_mesh(JMeshConfig(**mesh_kw))
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), jm.param_spec("model"),
                      is_leaf=lambda s: isinstance(s, P))
    sp = jax.tree.map(jax.device_put, p, sh)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data") if mesh_kw.get("data", 1) > 1 else P()))

    def loss(pp, xx):
        out, aux = jm.apply_with_aux(pp, xx)
        return jnp.sum(out * g) + R.AUX_W * aux, (out, aux)

    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    with jax.set_mesh(mesh) if ambient else contextlib.nullcontext():
        (_, (out, aux)), (gp, gx) = f(sp, xs)
    return {"out": np.asarray(out), "aux": float(aux), "dx": np.asarray(gx),
            "grads": {k: v.numpy() for k, v in params_from_jax(jax.device_get(gp)).items()}}


def _world1(state, x, g, **kw) -> dict:
    m = MoEFeedForward(**KW, device="cpu")
    m.load_state_dict(state)
    if kw.get("train"):
        m.router_noise = 1.0
    return R.moe_step(m, state, torch.from_numpy(x), torch.from_numpy(g),
                      aux_w=R.AUX_W, **kw)


def _check_rank(r, want: dict, n_data: int, m: int, what: str) -> None:
    """One rank's rows, summed gradients and blocks against the whole
    computation ``want`` (the JAX module's or the port's world-1)."""
    d, k = r["data"], r["model"]
    rows = slice(d * (len(want["out"]) // n_data), (d + 1) * (len(want["out"]) // n_data))
    _close(r["out"], np.asarray(want["out"])[rows], f"{what} out")
    _close(r["dx"], np.asarray(want["dx"])[rows], f"{what} dx")
    _close(r["grads"]["router.w"], want["grads"]["router.w"], f"{what} router")
    E = KW["num_experts"] // m
    for name in ("up", "gate", "down"):
        _close(r["grads"][name], np.asarray(want["grads"][name])[k * E:(k + 1) * E],
               f"{what} {name}")


def test_moe_module_both_forms_match_jax_and_world1(tmp_path, devices):
    jm = JMoE(**KW)
    p = jax.device_get(jm.init(jax.random.key(0)))
    state = params_from_jax(p)
    x, g = _x(1, (4, 8, 16)), _x(2, (4, 8, 16))
    xo, go = _x(3, (6, 8, 16)), _x(4, (6, 8, 16))
    job = TS._Job(R.job_module, 4, tmp_path, KW, state, torch.from_numpy(x),
                  torch.from_numpy(g), torch.from_numpy(xo), torch.from_numpy(go))
    world1 = _world1(state, x, g)
    jref = {(name, form): _jax_module(jm, p, x, g, axes, form == "a2a")
            for name, axes in R.MESHES.items() for form in ("fallback", "a2a")}
    for want in jref.values():
        _close(want["out"], world1["out"], "jax out")
        assert want["aux"] == pytest.approx(world1["aux"], rel=RTOL)
    odd = _world1(state, xo, go)
    noisy = _world1(state, x, g, train=True,
                    rng=torch.Generator().manual_seed(R.NOISE_SEED))
    assert not torch.allclose(noisy["out"], world1["out"])
    m1 = MoEFeedForward(**KW, device="cpu")
    m1.load_state_dict(state)
    stats = m1.routing_stats(torch.from_numpy(x))
    assert 0 < stats["drop_fraction"] < 1  # capacity 1.0 drops routes
    for res in job.results():
        for name, axes in R.MESHES.items():
            n, m = axes.get("data", 1), axes["model"]
            auxes = []
            for form in ("fallback", "a2a"):
                r = res[(name, form)]
                assert r["shapes"]["up"] == (4 // m, 16, 32)
                assert r["shapes"]["router.w"] == (16, 4)
                for want in (world1, jref[(name, form)]):
                    _check_rank(r, want, n, m, f"{name} {form}")
                auxes.append(r["aux"])
                c = r["collectives"]
                if form == "a2a":  # two swaps forward, two backward
                    assert c["all_to_all_model"] == 4 and c["reduce_from_model"] == 1
                    assert c["scatter_rows_to_model"] == c["gather_rows_to_model"] == 1
                    assert c["copy_to_model"] == 1  # the router weight's sum
                else:  # one all-reduce forward; the input's and router's back
                    assert c["all_to_all_model"] == 0 and c["reduce_from_model"] == 1
                    assert c["copy_to_model"] == 2
            # a data coordinate's aux covers its rows: their mean is the batch's
            for a in auxes:
                assert a == pytest.approx(world1["aux"], rel=1e-5) or n > 1
        for form in ("fallback", "a2a"):
            r = res[("odd", form)]
            assert r["collectives"]["all_to_all_model"] == 0  # 6 % 4 falls back
            _check_rank(dict(r, data=0, model=res[("model4", form)]["model"]), odd,
                        1, 4, f"odd {form}")
            _check_rank(dict(res[("noise", form)], data=0,
                             model=res[("model4", form)]["model"]), noisy, 1, 4,
                        f"noise {form}")
        assert res["stats"] == pytest.approx(stats)
    # data 2 x model 2: the mean of the two data coordinates' aux
    per = [r[("data2_model2", "a2a")] for r in job.results()]
    assert np.mean([r["aux"] for r in per]) == pytest.approx(world1["aux"], rel=1e-5)


def test_expert_split_refused():
    with pytest.raises(ValueError, match="3 experts do not split over a model axis of 2"):
        check_expert_split(3, 2)
    check_expert_split(8, 4)
    from tensorlink_tpu_torch.config import TrainConfig
    from tensorlink_tpu_torch.models.llama import Llama
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer

    cfg = dataclasses.replace(LlamaConfig.moe_tiny(), moe_experts=3)
    parts = Llama(cfg, device="cpu").as_pipeline_parts()
    with pytest.raises(ValueError, match="3 experts .* model axis of 2"):
        ShardedTrainer(TE._StubMesh(model=2), TrainConfig(batch_size=4, micro_batches=2),
                       parts, lambda o, b: 0.0, device="cpu")


TRAIN_CFG = dict(optimizer="sgd", learning_rate=0.1, moe_aux_weight=0.5)


def test_sharded_trainer_moe_pipe2_model2_matches_jax(tmp_path, devices):
    batch = TE._batch("llama")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jrefs = {}
    init = None
    for sched in ("gpipe", "1f1b"):
        init, (losses, norms), params, _, (*_, p0) = TE._jax_run(
            "llama", "moe_tiny", dict(pipe=2, model=2),
            dict(TRAIN_CFG, pp_schedule=sched), False, batch, steps=1)
        TE._check_moved(p0, params, False)
        jrefs[sched] = (losses[0], norms[0], params)
        if sched == "gpipe":
            job = TS._Job(R.job_trainer, 4, tmp_path, params_from_jax(init), tb,
                          TE._train_cfg(TRAIN_CFG))
    results = job.results()
    for sched, (loss, norm, params) in jrefs.items():
        out = results[0][sched]
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norm, rtol=1e-5)
        TE._assert_state(out["params"], params, f"{sched} params")
        for res in results:
            r = res[sched]
            # one layer a stage, 2 micros: 2 swaps a micro forward, 2 back
            assert r["collectives"]["all_to_all_model"] == 8, (sched, r["collectives"])
            assert r["shapes"]["stages.0.mlp.up"] == (2, 32, 64)
            assert r["shapes"]["stages.0.mlp.router.w"] == (32, 4)
            assert r["adopted"], sched


def test_inference_engine_moe_model2_matches_jax(tmp_path, devices):
    cfg = dataclasses.asdict(LlamaConfig.moe_tiny())
    jm, p = TS._jax_llama(cfg, 0)
    state = params_from_jax(p)
    ids, _, prompts = TS._inputs()
    job = TS._Job(R.job_serving, 2, tmp_path, cfg, state, ids, prompts, MAX_NEW)
    jeng = TS._jax_engine(jm, p, {"model": 2})
    assert "model" in jeng.params["blocks"]["0"]["mlp"]["up"].sharding.spec
    want = {"contiguous": TS._jax_serve(jeng, prompts, TS.JContiguous, **TS.CONT)[0],
            "paged": TS._jax_serve(jeng, prompts, TS.JPaged, **SR.PAGED_KW)[0]}
    for paged, cls, kw in ((False, TS.JContiguous, TS.CONT),
                           (True, TS.JPaged, SR.PAGED_KW)):
        outs, counts = TS._jax_serve(jeng, prompts, cls,
                                     speculative=TS.JSpecConfig(**TS.SPEC), **kw)
        want[("ngram", paged)] = {"outs": outs, "counts": counts}
    # a MoE verify pass routes its K + 1 tokens together, so the tokens
    # depend on the draft: the JAX int8 engine drafts as the sibling does
    int8 = TS._jax_engine(jm, p, {"model": 2}, quantize="int8")
    want["sibling"] = TS._jax_serve(jeng, prompts, TS.JPaged, draft=int8,
                                    speculative=TS.JSpecConfig(**TS.SPEC),
                                    **SR.PAGED_KW)
    one = SR.engine("llama", cfg, state)
    w1_stats = one.model.blocks.blocks()[0].routing_stats(
        one.model.tok_emb(torch.as_tensor(ids)))
    router = sum(blk.mlp.router.w.numel() * 4 for blk in one.model.blocks.blocks())
    for res in job.results():
        TS._equal(res["contiguous"], want["contiguous"])
        TS._equal(res["paged"], want["paged"])
        TS._equal(res["sibling_outs"]["outs"], want["sibling"][0])
        assert res["sibling_outs"]["counts"] == want["sibling"][1]
        for paged in (False, True):
            TS._equal(res[("ngram", paged)]["outs"], want[("ngram", paged)]["outs"])
            assert res[("ngram", paged)]["counts"] == want[("ngram", paged)]["counts"]
        assert res["call"][1] == 2 * cfg["num_layers"] + 1
        assert res["blocks"]["blocks.0.mlp.up"] == (2, 32, 64)
        assert res["blocks"]["blocks.0.mlp.router.w"] == (32, 4)
        # every block and expert stack halved, the routers whole
        assert 2 * res["weight_bytes"] == one.weight_bytes + router
        assert res["sibling"]["blocks.0.mlp.up"] == ((2, 32, 64), torch.float32)
        assert res["sibling"]["blocks.0.mlp.router.w"] == ((32, 4), torch.float32)
        assert res["stats"] == pytest.approx(w1_stats)
