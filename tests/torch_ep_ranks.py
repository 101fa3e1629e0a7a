"""Rank bodies of ``tests/test_torch_ep.py``: expert parallelism on
spawned gloo ranks (``torch_ranks.spawn_cpu_ranks``).

Each job builds its meshes and saves what every rank saw to
``rank<r>.pt`` in the job's directory; the test compares.

Top level: torch, numpy and the port only (the spawned ranks import this
module, which must not import JAX).
"""

import contextlib
import os

import torch
import torch.distributed as dist

from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from tensorlink_tpu_torch.nn.moe import MoEFeedForward
from tensorlink_tpu_torch.parallel import ep, tp
from tensorlink_tpu_torch.parallel.engine import apply_with
from tensorlink_tpu_torch.runtime.mesh import make_mesh

# the module cases: name -> mesh axes (pipe only makes the groups)
MESHES = {"model4": dict(model=4), "data2_model2": dict(data=2, model=2),
          "model2": dict(pipe=2, model=2)}
AUX_W = 0.5
NOISE_SEED = 7


def _save(out_dir: str, rank: int, res: dict) -> None:
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def moe_step(module, params: dict, x, g, *, aux_w: float, rng=None,
             train: bool = False) -> dict:
    """``sum(out * g) + aux_w * aux`` through ``module`` holding
    ``params`` and its backward: -> out, aux and the gradients of every
    param and of ``x``."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    x = x.detach().clone().requires_grad_(True)
    out, aux = apply_with(module, leaves, x, method="forward_with_aux", rng=rng,
                          train=train)
    ((out * g).sum() + aux_w * aux).backward()
    return {"out": out.detach(), "aux": float(aux.detach()),
            "grads": {k: v.grad for k, v in leaves.items()}, "dx": x.grad}


def _form(form: str, group):
    stack = contextlib.ExitStack()
    stack.enter_context(tp.model_parallel(group))
    if form == "a2a":
        stack.enter_context(ep.ep_parallel(group))
    return stack


def job_module(rank, world, out_dir, kw, state, x, g, x_odd, g_odd):
    """``MoEFeedForward`` on every mesh of ``MESHES`` in both forms: this
    data coordinate's rows of ``x``, the gradients of the expert blocks
    and the router summed over ``data``, and the collectives issued; at
    model 4 also a batch of 6 rows (the all_to_all form falls back) and
    router noise in training."""
    res = {}
    for name, axes in MESHES.items():
        mesh = make_mesh(MeshConfig(**axes), device="cpu")
        group, dgroup = mesh.get_group("model"), mesh.get_group("data")
        n, d = mesh.size(0), mesh.get_local_rank("data")
        module = MoEFeedForward(**kw, device="cpu")
        local = tp.shard_params(state, module, mesh)
        xd, gd = x.chunk(n)[d], g.chunk(n)[d]
        for form in ("fallback", "a2a"):
            tp.reset_collectives()
            with _form(form, group):
                r = moe_step(module, local, xd, gd, aux_w=AUX_W / n)
            r["collectives"] = tp.collective_counts()
            for t in r["grads"].values():
                dist.all_reduce(t, group=dgroup)
            r["data"], r["model"] = d, mesh.get_local_rank("model")
            r["shapes"] = {k: tuple(v.shape) for k, v in local.items()}
            res[(name, form)] = r
        if name == "model4":
            for form in ("fallback", "a2a"):
                tp.reset_collectives()
                with _form(form, group):
                    r = moe_step(module, local, x_odd, g_odd, aux_w=AUX_W)
                r["collectives"] = tp.collective_counts()
                res[("odd", form)] = r
                module.router_noise = 1.0
                with _form(form, group):
                    res[("noise", form)] = moe_step(
                        module, local, x, g, aux_w=AUX_W, train=True,
                        rng=torch.Generator().manual_seed(NOISE_SEED))
                module.router_noise = 0.0
            with _form("a2a", group):
                res["stats"] = apply_with(module, local, x, method="routing_stats")
    _save(out_dir, rank, res)


def job_trainer(rank, world, out_dir, state, batch, cfg_kw):
    """``ShardedTrainer`` with ``LlamaConfig.moe_tiny`` at pipe 2 x model
    2 under both schedules: one step, the loss, the pre-clip gradient
    norm, the gathered params, the all_to_all swaps a step and the
    gathered state adopted back through the JAX layout."""
    from tensorlink_tpu_torch.convert import sharded_state_from_jax, sharded_state_to_jax
    from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    mesh = make_mesh(MeshConfig(pipe=2, model=2), device="cpu")
    res = {}
    for sched in ("gpipe", "1f1b"):
        model = Llama(LlamaConfig.moe_tiny(), device="cpu", seed=None)
        model.load_state_dict(state)
        tr = ShardedTrainer(mesh, TrainConfig(**cfg_kw, pp_schedule=sched),
                            model.as_pipeline_parts(),
                            lambda out, b: softmax_cross_entropy(out, b["labels"]),
                            device="cpu")
        st = tr.init_state()
        tp.reset_collectives()
        st, stats = tr.train_step(st, batch)
        counts = tp.collective_counts()
        whole = tr.gather_state(st)  # a collective: every rank calls it
        # the global state through the JAX layout and back, adopted by
        # every rank: the same blocks (expert stacks cut on dim 0)
        box = [whole and sharded_state_to_jax(whole)]
        dist.broadcast_object_list(box, src=0)
        again = tr.adopt_state(sharded_state_from_jax(*box[0]))
        res[sched] = {"loss": float(stats["loss"]),
                      "grad_norm": float(stats["grad_norm"]),
                      "collectives": counts,
                      "shapes": {k: tuple(v.shape) for k, v in st.params.items()},
                      "params": whole and whole.params,
                      "adopted": all(torch.equal(again.params[k], v)
                                     for k, v in st.params.items())}
    _save(out_dir, rank, res)


def job_serving(rank, world, out_dir, cfg_kw, state, ids, prompts, max_new):
    """``InferenceEngine(mesh=model 2)`` with a MoE model: the paged and
    contiguous engines, n-gram speculation in both and the int8
    sibling's in the paged one; the collectives of one model call, the
    weight bytes, the blocks and the whole batch's routing stats."""
    import torch_tp_serving_ranks as R
    from tensorlink_tpu_torch.parallel.speculative import (
        SpecConfig,
        default_draft_candidates,
    )

    mesh = make_mesh(MeshConfig(model=2), device="cpu")
    eng = R.engine("llama", cfg_kw, state, mesh)
    res = {"contiguous": R.serve(eng, prompts, max_new, False)[0],
           "paged": R.serve(eng, prompts, max_new, True)[0],
           "call": R.call_collectives(eng, ids), "weight_bytes": eng.weight_bytes,
           "blocks": R.blocks(eng)}
    spec = SpecConfig(k=3, rounds=2)
    for paged in (False, True):
        outs, sch = R.serve(eng, prompts, max_new, paged, speculative=spec)
        res[("ngram", paged)] = {"outs": outs, "counts": R.spec_counts(sch)}
    sibling = default_draft_candidates(eng)[0][1]()
    res["sibling"] = {k: (tuple(v.shape), v.dtype) for k, v in
                      sibling.model.state_dict().items() if ".mlp." in k}
    outs, sch = R.serve(eng, prompts, max_new, True, speculative=spec, draft=sibling)
    res["sibling_outs"] = {"outs": outs, "counts": R.spec_counts(sch)}
    with torch.no_grad(), eng.parallel():
        x = eng.model.tok_emb(torch.as_tensor(ids))
        res["stats"] = eng.model.blocks.blocks()[0].routing_stats(x)
    _save(out_dir, rank, res)
