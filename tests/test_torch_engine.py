"""PyTorch port, parallel/engine.py (``ShardedTrainer``) and the models'
pipeline parts: spawned gloo ranks against the JAX ``ShardedTrainer`` on
the virtual CPU mesh of the same shape, f32, dropout 0, 3 steps.

Both run from the same params (the JAX init, converted) and batches.
Tolerances: the per-step loss and pre-clip gradient norm within rtol
1e-5, the gathered params and first moments within atol 1e-5 and rtol
1e-4, the second moments within rtol 1e-4 (atol 1e-12: they are ~1e-3
g^2). AdamW runs at lr 3e-4 (the GPT-2 example's), so three steps move
every trained leaf well past the tolerance (checked), and the gradient
norm shows a gradient-scale fault that Adam's update would hide. The
key-bias leaves (GPT-2's and BERT's ``attn.k.b``) are held apart: their
exact gradient is zero (softmax is invariant to a shift common to all
keys), so each package holds its own rounding noise there, which Adam
divides by its own root to lr-sized moves; the test shows their first
moment at most 1e-5 of the query bias's in both packages instead.
Port-only checks: embed and head replicas
bitwise equal across ``pipe``, GPipe and 1F1B losses equal at dropout
0.1, dropout masks that differ between steps, and the rejection paths;
on the GPT-2 GPipe case also the tied ``wte`` split over the vocab at
model 2 x pipe 2 (held to the same JAX run) and the JAX trainer's state
adopted on another pipe depth (``convert.sharded_state_from_jax``,
``adopt_state``, one more step).

This module's top level imports only torch and the port: spawned ranks
import it to find their bodies. The JAX package is imported inside the
functions that run it, in the pytest process.
"""

import os

import numpy as np
import pytest
import torch

from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from torch_ranks import spawn_cpu_ranks

STEPS = 3
LR = 3e-4
LOSS_RTOL = 1e-5
STATE_ATOL, STATE_RTOL = 1e-5, 1e-4
V_ATOL = 1e-12  # the second moment is ~1e-3 g^2: held relative
KEY_BIAS = "attn.k.b"

GPT2_TINY = dict(vocab_size=128, dim=32, num_layers=4, num_heads=2, max_len=64,
                 dropout=0.0)
GPT2_FSDP = dict(vocab_size=512, dim=256, num_layers=2, num_heads=4, max_len=64,
                 dropout=0.0)
BERT_TINY = dict(vocab_size=128, dim=32, num_layers=2, num_heads=2, hidden_dim=64,
                 max_len=64, dropout=0.0)

# case: (model kind, model config, mesh, TrainConfig overrides, lora)
CASES = {
    "gpt2_pipe2_gpipe": ("gpt2", GPT2_TINY, dict(pipe=2), dict(pp_schedule="gpipe"), False),
    "gpt2_pipe2_1f1b": ("gpt2", GPT2_TINY, dict(pipe=2), dict(pp_schedule="1f1b"), False),
    "bert_data2_pipe2": ("bert", BERT_TINY, dict(data=2, pipe=2), {}, False),
    "llama_model2_pipe2": ("llama", "tiny", dict(model=2, pipe=2), {}, False),
    "moe_pipe2_aux": ("llama", "moe_tiny", dict(pipe=2),
                      dict(moe_aux_weight=0.01, pp_schedule="1f1b"), False),
    "lora_pipe2": ("gpt2", GPT2_TINY, dict(pipe=2),
                   dict(train_only="lora"), True),
    "fsdp_data2_pipe2": ("gpt2", GPT2_FSDP, dict(data=2, pipe=2), dict(fsdp=True), False),
}


def _batch(kind: str, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    if kind == "bert":
        mask = np.ones((8, 12), np.int64)
        mask[1, 9:] = 0
        mask[5, 4:] = 0
        return {"input_ids": r.integers(0, 128, (8, 12)), "attention_mask": mask,
                "labels": r.integers(0, 3, (8,))}
    vocab = 512 if kind == "gpt2_fsdp" else 128
    ids = r.integers(0, vocab, (8, 17))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _train_cfg(overrides: dict) -> dict:
    kw = dict(batch_size=8, micro_batches=2, learning_rate=LR, optimizer="adamw",
              dtype="float32", weight_decay=0.01)
    kw.update(overrides)
    return kw


# ------------------------------------------------------------ port side


def _port_model(kind: str, mcfg, state: dict | None, lora: bool):
    """The port's model (and its pipeline parts) loaded with ``state``."""
    from tensorlink_tpu_torch.models.bert import (
        BertClassifier,
        BertConfig,
        bert_pipeline_parts,
    )
    from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
    from tensorlink_tpu_torch.nn.lora import lora_init

    if kind == "bert":
        model = BertClassifier(BertConfig(**mcfg), 3, device="cpu", seed=0)
    elif kind == "gpt2":
        model = GPT2(GPT2Config(**mcfg), device="cpu", seed=0)
    else:
        model = Llama(getattr(LlamaConfig, mcfg)(), device="cpu", seed=0)
    if lora:
        lora_init(model, torch.Generator().manual_seed(1), rank=4, alpha=8.0)
    if state is not None:
        model.load_state_dict(state)
    if kind == "bert":
        return model, bert_pipeline_parts(model.bert, dict(model.named_parameters()),
                                          num_classes_head=3)
    return model, model.as_pipeline_parts()


def _loss_fn(kind: str):
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    return lambda out, b: softmax_cross_entropy(out, b["labels"])


def _engine_rank(rank, world, out_dir, kind, mcfg, mesh_kw, cfg_kw, lora, state,
                 batch, steps):
    """One rank: ``steps`` train steps, then rank 0 saves the losses and
    the gathered state; every rank saves its embed/head leaves."""
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
    _, parts = _port_model(kind, mcfg, state, lora)
    tr = ShardedTrainer(mesh, TrainConfig(**_train_cfg(cfg_kw)), parts,
                        _loss_fn(kind), device="cpu")
    st = tr.init_state()
    losses, norms = [], []
    for _ in range(steps):
        st, stats = tr.train_step(st, batch)
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
    g = tr.gather_state(st)
    shared = {k: v.clone() for k, v in st.params.items()
              if not k.startswith("stages.")}
    torch.save({"shared": shared, "pipe": mesh.get_local_rank("pipe"),
                "data": mesh.get_local_rank("data"),
                "model": mesh.get_local_rank("model"),
                "local_shapes": {k: tuple(v.shape) for k, v in st.params.items()},
                "moment_shapes": {k: tuple(v.shape)
                                  for k, v in st.opt_state["m"].items()}},
               os.path.join(out_dir, f"rank{rank}.pt"))
    if rank == 0:
        torch.save({"losses": losses, "grad_norms": norms, "params": g.params,
                    "opt_state": g.opt_state, "step": int(g.step)},
                   os.path.join(out_dir, "out.pt"))


def _run_port(tmp_path, kind, mcfg, mesh_kw, cfg_kw, lora, state, batch,
              steps=STEPS):
    world = int(np.prod(list(mesh_kw.values())))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    spawn_cpu_ranks(_engine_rank, world, str(tmp_path), kind, mcfg, mesh_kw, cfg_kw,
                    lora, state, tb, steps, store_dir=str(tmp_path))
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    out["ranks"] = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                    for r in range(world)]
    return out


# ------------------------------------------------------------- JAX side


def _jax_run(kind, mcfg, mesh_kw, cfg_kw, lora, batch, steps=STEPS):
    """-> (the init params as numpy, (losses, pre-clip grad norms), final
    params, final opt_state, (trainer, state, batch, initial state params))."""
    import jax
    import jax.numpy as jnp

    from tensorlink_tpu.config import MeshConfig as JMeshConfig
    from tensorlink_tpu.config import TrainConfig as JTrainConfig
    from tensorlink_tpu.models.bert import BertClassifier, BertConfig, bert_pipeline_parts
    from tensorlink_tpu.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu.models.llama import Llama, LlamaConfig
    from tensorlink_tpu.nn.lora import lora_init
    from tensorlink_tpu.parallel.engine import ShardedTrainer
    from tensorlink_tpu.runtime.mesh import make_mesh
    from tensorlink_tpu.train.trainer import softmax_cross_entropy

    key = jax.random.key(0)
    if kind == "bert":
        model = BertClassifier(BertConfig(**mcfg), num_classes=3)
    elif kind == "gpt2":
        model = GPT2(GPT2Config(**mcfg))
    else:
        model = Llama(getattr(LlamaConfig, mcfg)())
    params = model.init(key)
    if lora:
        params = lora_init(model, params, jax.random.key(1), rank=4, alpha=8.0)
    init = jax.device_get(params)
    if kind == "bert":
        parts = bert_pipeline_parts(model.children["bert"], params, num_classes_head=3)
    else:
        parts = model.as_pipeline_parts(params)
    tr = ShardedTrainer(make_mesh(JMeshConfig(**mesh_kw)),
                        JTrainConfig(**_train_cfg(cfg_kw)), parts,
                        lambda out, b: softmax_cross_entropy(out, b["labels"]))
    st = tr.init_state()
    p0 = jax.device_get(st.params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(steps):
        st, m = tr.train_step(st, jb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, (losses, norms), jax.device_get(st.params), jax.device_get(st.opt_state), (tr, st, jb, p0)


def _leaves(tree, prefix=""):
    """Flat {dotted name: np.ndarray}, empty subtrees dropped."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_leaves(v, name))
        else:
            out[name] = np.asarray(v.detach() if torch.is_tensor(v) else v,
                                   np.float32)
    return out


def _assert_state(port_tree, jax_tree, what, atol=STATE_ATOL, rtol=STATE_RTOL,
                  key_bias=True):
    """Every leaf within (atol, rtol); without ``key_bias`` the key-bias
    leaves are left out (``_check_key_bias`` holds them)."""
    p, j = _leaves(port_tree), _leaves(jax_tree)
    assert sorted(p) == sorted(j), (what, sorted(set(p) ^ set(j)))
    for k in j:
        if key_bias or not k.endswith(KEY_BIAS):
            np.testing.assert_allclose(p[k], j[k], atol=atol, rtol=rtol,
                                       err_msg=f"{what} {k}")


def _check_key_bias(port_m, jax_m):
    """The key bias's exact gradient is zero (a softmax row is invariant
    to a shift common to all its keys), so both packages hold rounding
    noise there, which Adam's 1/sqrt(v) scales up to lr-sized moves:
    shown by its first moment, at most 1e-5 of the query bias's in
    either package."""
    for m in (_leaves(port_m), _leaves(jax_m)):
        kb = [k for k in m if k.endswith(KEY_BIAS)]
        for k in kb:
            q = m[k.replace(KEY_BIAS, "attn.q.b")]
            assert np.abs(m[k]).max() <= 1e-5 * np.abs(q).max(), k


def _check_moved(init_tree, final_tree, lora: bool):
    """The comparison can see a leaf that never updated: every trained
    leaf (all but the key bias; the adapters under LoRA) moved beyond
    the state tolerance somewhere."""
    a, b = _leaves(init_tree), _leaves(final_tree)
    for k, v in b.items():
        if k.endswith(KEY_BIAS) or (lora and "lora_" not in k) or k.endswith("lora_s"):
            continue
        assert (np.abs(v - a[k]) > STATE_ATOL + STATE_RTOL * np.abs(v)).any(), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_trainer_matches_jax(case, tmp_path, devices):
    from tensorlink_tpu_torch.convert import params_from_jax

    kind, mcfg, mesh_kw, cfg_kw, lora = CASES[case]
    batch = _batch("gpt2_fsdp" if mcfg is GPT2_FSDP else kind)
    init, (j_losses, j_norms), j_params, j_opt, (jtr, jst, jb, j_p0) = _jax_run(
        kind, mcfg, mesh_kw, cfg_kw, lora, batch)
    out = _run_port(tmp_path, kind, mcfg, mesh_kw, cfg_kw, lora,
                    params_from_jax(init), batch)
    np.testing.assert_allclose(out["losses"], j_losses, rtol=LOSS_RTOL)
    # the pre-clip norm carries the gradients' scale, which Adam's
    # update hides (a sum over data in place of a mean shows here)
    np.testing.assert_allclose(out["grad_norms"], j_norms, rtol=LOSS_RTOL)
    assert out["step"] == STEPS
    _check_moved(j_p0, j_params, lora)
    _assert_state(out["params"], j_params, "params", key_bias=False)
    _assert_state(out["opt_state"]["m"], j_opt["m"], "moment m", key_bias=False)
    _assert_state(out["opt_state"]["v"], j_opt["v"], "moment v", atol=V_ATOL,
                  key_bias=False)
    _check_key_bias(out["opt_state"]["m"], j_opt["m"])
    ranks = out["ranks"]
    # embed and head replicas stay bitwise equal across pipe (and across
    # data where FSDP leaves them whole)
    for r in ranks[1:]:
        if cfg_kw.get("fsdp") and r["data"] != ranks[0]["data"]:
            continue
        for k, v in ranks[0]["shared"].items():
            assert torch.equal(v, r["shared"][k]), (case, k)
    if lora:
        # adapters moved; every base leaf kept its bits (in both packages,
        # so the port's equal the JAX trainer's exactly)
        p, j = _leaves(out["params"]), _leaves(j_params)
        assert all(np.array_equal(p[k], j[k]) for k in p if "lora_" not in k)
        assert all(np.abs(p[k]).max() > 0 for k in p if k.endswith("lora_b"))
    if cfg_kw.get("fsdp"):
        # params AND moments sharded over data where the spec says so
        spec = jtr.param_specs["stages"]["mlp"]["up"]["w"]
        assert "data" in tuple(spec)
        shapes = ranks[0]["local_shapes"]
        full = _leaves(out["params"])
        up = full["stages.mlp.up.w"]
        assert shapes["stages.0.mlp.up.w"] == (up.shape[2], up.shape[3] // 2) or \
            shapes["stages.0.mlp.up.w"] == (up.shape[2] // 2, up.shape[3])
        assert ranks[0]["moment_shapes"] == shapes
    if case == "gpt2_pipe2_gpipe":
        _check_vocab_split(tmp_path, init, j_losses, j_params, batch)
        _check_adopt(kind, mcfg, cfg_kw, lora, init, j_params, j_opt, jtr, jst, jb,
                     batch)


def _check_adopt(kind, mcfg, cfg_kw, lora, init, j_params, j_opt, jtr, jst, jb, batch):
    """convert.sharded_state_from_jax + adopt_state: the JAX trainer's
    state after 3 steps at pipe 2, adopted by a world-1 port trainer
    (pipe 1: stage leaves re-factored to [1, 4, ...]), gathers back to the
    same values, round-trips through sharded_state_to_jax, and its next
    step's loss equals the JAX trainer's 4th."""
    import jax

    from tensorlink_tpu_torch.convert import (
        params_from_jax,
        sharded_state_from_jax,
        sharded_state_to_jax,
    )
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer, reshape_stages
    from tensorlink_tpu_torch.runtime.mesh import make_mesh, shutdown_distributed

    state = sharded_state_from_jax(j_params, j_opt, jax.device_get(jst.step))
    _, m4 = jtr.train_step(jst, jb)
    try:
        mesh = make_mesh(MeshConfig(), device="cpu")
        _, parts = _port_model(kind, mcfg, params_from_jax(init), lora)
        tr = ShardedTrainer(mesh, TrainConfig(**_train_cfg(cfg_kw)), parts,
                            _loss_fn(kind), device="cpu")
        st = tr.adopt_state(state)
        g = tr.gather_state(st)
        assert int(g.step) == STEPS
        want = dict(j_params, stages=reshape_stages(j_params["stages"], 1))
        _assert_state(g.params, want, "adopted params")
        _assert_state(g.opt_state["v"],
                      dict(j_opt["v"], stages=reshape_stages(j_opt["v"]["stages"], 1)),
                      "adopted v")
        back_p, back_o, back_step = sharded_state_to_jax(g)
        assert int(back_step) == STEPS and set(back_o) == {"m", "v"}
        _assert_state(back_p, want, "round trip")
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, stats = tr.train_step(st, tb)
        np.testing.assert_allclose(float(stats["loss"]), float(m4["loss"]),
                                   rtol=LOSS_RTOL)
    finally:
        shutdown_distributed()


# ------------------------------------------------------ port-only checks


def _dropout_rank(rank, world, out_dir, state, batch):
    """GPipe and 1F1B at dropout 0.1 from the same params, and two lr-0
    steps under one schedule."""
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    mesh = make_mesh(MeshConfig(pipe=2), device="cpu")
    res = {}
    for sched in ("gpipe", "1f1b"):
        cfg = dict(GPT2_TINY, dropout=0.1)
        _, parts = _port_model("gpt2", cfg, state, False)
        tr = ShardedTrainer(mesh, TrainConfig(**_train_cfg(dict(
            pp_schedule=sched, learning_rate=0.0, micro_batches=4))),
            parts, _loss_fn("gpt2"), device="cpu")
        st = tr.init_state()
        st, s0 = tr.train_step(st, batch)
        st, s1 = tr.train_step(st, batch)
        res[sched] = (float(s0["loss"]), float(s1["loss"]))
        res[sched + "_eval"] = float(tr.eval_fn(st, batch))
        # remat recomputes each block with its generator rebuilt from the
        # seed: the same masks, so the same losses
        _, parts = _port_model("gpt2", dict(GPT2_TINY, dropout=0.1), state, False)
        trr = ShardedTrainer(mesh, TrainConfig(**_train_cfg(dict(
            pp_schedule=sched, learning_rate=0.0, micro_batches=4, remat=True))),
            parts, _loss_fn("gpt2"), device="cpu")
        st = trr.init_state()
        st, r0 = trr.train_step(st, batch)
        st, r1 = trr.train_step(st, batch)
        res[sched + "_remat"] = (float(r0["loss"]), float(r1["loss"]))
        # train_only="lora" under this schedule: adapters move, the rest
        # keep their bits
        _, parts = _port_model("gpt2", GPT2_TINY, None, True)
        trl = ShardedTrainer(mesh, TrainConfig(**_train_cfg(dict(
            pp_schedule=sched, train_only="lora", learning_rate=1e-2))),
            parts, _loss_fn("gpt2"), device="cpu")
        st0 = trl.init_state()
        st = st0
        for _ in range(2):
            st, _ = trl.train_step(st, batch)
        res[sched + "_lora"] = (
            [k for k in st.params if "lora_" not in k
             and not torch.equal(st.params[k], st0.params[k])],
            [k for k in st.params if k.endswith("lora_b")
             and torch.equal(st.params[k], st0.params[k])])
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "dropout.pt"))


def test_dropout_streams_remat_and_lora_under_both_schedules(tmp_path):
    model, _ = _port_model("gpt2", GPT2_TINY, None, False)
    state = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in _batch("gpt2").items()}
    spawn_cpu_ranks(_dropout_rank, 2, str(tmp_path), state, batch,
                    store_dir=str(tmp_path))
    res = torch.load(tmp_path / "dropout.pt")
    # GPT-2's head has no dropout: embed and block masks come from
    # (step, micro, global layer), so the schedules see the same masks
    np.testing.assert_allclose(res["1f1b"], res["gpipe"], rtol=1e-6)
    # lr 0: the params do not move, the masks do
    assert res["gpipe"][0] != res["gpipe"][1]
    # eval runs without dropout: the same loss from either trainer
    np.testing.assert_allclose(res["1f1b_eval"], res["gpipe_eval"], rtol=1e-6)
    for sched in ("gpipe", "1f1b"):
        np.testing.assert_allclose(res[sched + "_remat"], res[sched], rtol=1e-6)
        changed, unmoved = res[sched + "_lora"]
        assert not changed and not unmoved, (sched, changed, unmoved)


def _vocab_rank(rank, world, out_dir, state, batch):
    """GPT-2 with its tied ``wte`` split over the vocab (an
    ``embed_module`` whose spec says so) at model 2 x pipe 2, and the
    same model replicated at pipe 2 on the same ranks' first half."""
    from tensorlink_tpu_torch.nn.module import Module, P
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    class VocabSplit(Module):
        def param_spec(self, model_axis="model"):
            return {"wte": {"table": P(model_axis, None)}, "wpe": {"table": P()}}

    mesh = make_mesh(MeshConfig(model=2, pipe=2), device="cpu")
    _, parts = _port_model("gpt2", GPT2_TINY, state, False)
    tr = ShardedTrainer(mesh, TrainConfig(**_train_cfg({})), parts, _loss_fn("gpt2"),
                        embed_module=VocabSplit(), device="cpu")
    st = tr.init_state()
    losses = []
    for _ in range(STEPS):
        st, stats = tr.train_step(st, batch)
        losses.append(float(stats["loss"]))
    g = tr.gather_state(st)
    if rank == 0:
        torch.save({"losses": losses, "params": g.params,
                    "spec": tuple(tr.param_specs["embed"]["wte"]["table"]),
                    "block": tuple(st.params["embed.wte.table"].shape)},
                   os.path.join(out_dir, "vocab.pt"))


def _check_vocab_split(tmp_path, init, j_losses, j_params, batch):
    """The vocab-sharded lookup (masked, summed over model) and the tied
    head's gathered logits inside the engine, at model 2 x pipe 2,
    against the JAX trainer with the table replicated: losses and
    gathered params at the parity tolerances."""
    from tensorlink_tpu_torch.convert import params_from_jax

    d = tmp_path / "vocab"
    d.mkdir()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spawn_cpu_ranks(_vocab_rank, 4, str(d), params_from_jax(init), tb,
                    store_dir=str(d))
    out = torch.load(d / "vocab.pt", weights_only=False)
    assert out["spec"] == ("model", None) and out["block"] == (64, 32)
    np.testing.assert_allclose(out["losses"], j_losses, rtol=LOSS_RTOL)
    _assert_state(out["params"], j_params, "vocab-split params", key_bias=False)


# ------------------------------------------------------------ rejections


class _StubMesh:
    """The DeviceMesh surface the constructor's checks read (they raise
    before any process group is touched)."""

    device_type = "cpu"
    mesh_dim_names = ("data", "pipe", "model", "seq")

    def __init__(self, **sizes):
        self.sizes = [sizes.get(n, 1) for n in self.mesh_dim_names]

    def size(self, i):
        return self.sizes[i]


def _gpt2_parts(**kw):
    from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config

    return GPT2(GPT2Config(**dict(GPT2_TINY, **kw)), device="cpu").as_pipeline_parts()


@pytest.mark.parametrize("what", ["indivisible", "schedule", "batch_normalized",
                                  "loss_reduction", "aux_without_fn", "seq_needs_ring"])
def test_rejections_match_reference(what, devices):
    """The reference's error types and messages, raised by both."""
    from tensorlink_tpu.config import MeshConfig as JMeshConfig
    from tensorlink_tpu.config import TrainConfig as JTrainConfig
    from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
    from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from tensorlink_tpu.parallel.engine import ShardedTrainer as JShardedTrainer
    from tensorlink_tpu.runtime.mesh import make_mesh as jmake_mesh
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer

    import jax

    mesh_kw = {"pipe": 3} if what == "indivisible" else (
        {"pipe": 2, "seq": 2} if what == "seq_needs_ring" else {"pipe": 2})
    cfg_kw = dict(batch_size=4, micro_batches=2, dtype="float32")
    kw = {}
    if what == "schedule":
        cfg_kw["pp_schedule"] = "zigzag"
    if what == "batch_normalized":
        cfg_kw["pp_schedule"] = "1f1b"
        kw["loss_reduction"] = "batch_normalized"
    if what == "loss_reduction":
        kw["loss_reduction"] = "nonsense"
    if what == "aux_without_fn":
        cfg_kw["moe_aux_weight"] = 0.01
    jm = JGPT2(JGPT2Config(**GPT2_TINY))
    jparts = jm.as_pipeline_parts(jm.init(jax.random.key(0)))
    with pytest.raises((ValueError, NotImplementedError)) as jerr:
        JShardedTrainer(jmake_mesh(JMeshConfig(**mesh_kw)), JTrainConfig(**cfg_kw),
                        jparts, lambda o, b: 0.0, **kw)
    with pytest.raises(jerr.type) as terr:
        ShardedTrainer(_StubMesh(**mesh_kw), TrainConfig(**cfg_kw), _gpt2_parts(),
                       lambda o, b: 0.0, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def _pp4_rank(rank, world, out_dir, state, batch):
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    mesh = make_mesh(MeshConfig(pipe=4), device="cpu")
    _, parts = _port_model("gpt2", GPT2_TINY, state, False)
    tr = ShardedTrainer(mesh, TrainConfig(**PP4_CFG), parts, _loss_fn("gpt2"),
                        device="cpu")
    st = tr.init_state()
    losses = []
    for _ in range(2):
        st, stats = tr.train_step(st, batch)
        losses.append(float(stats["loss"]))
    if rank == 0:
        torch.save(losses, os.path.join(out_dir, "pp4.pt"))


PP4_CFG = dict(batch_size=8, micro_batches=4, learning_rate=0.01, optimizer="sgd",
               grad_clip_norm=None, dtype="float32")


def test_engine_gpt2_pp4_matches_single_device(tmp_path):
    """pipe 4 (one block a stage), SGD: the first loss equals the plain
    model's, the second the plain model's after one SGD step of the
    single-device ``Trainer`` (4 micros)."""
    from torch.func import functional_call

    from tensorlink_tpu_torch.train.trainer import Trainer

    model, _ = _port_model("gpt2", GPT2_TINY, None, False)
    state = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in _batch("gpt2").items()}
    spawn_cpu_ranks(_pp4_rank, 4, str(tmp_path), state, batch, store_dir=str(tmp_path))
    got = torch.load(tmp_path / "pp4.pt")

    def loss(module, params, b, rng):
        return _loss_fn("gpt2")(functional_call(module, params, (b["input_ids"],)), b)

    tr = Trainer(model, loss, TrainConfig(**PP4_CFG), device="cpu")
    st = tr.init_state()
    want = []
    for _ in range(2):
        st, stats = tr.train_step(st, batch)
        want.append(float(stats["loss"]))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[1] < got[0]


def test_world1_trainer_describe_bubble_and_eval():
    """One process, world 1 (make_mesh forms its own gloo group): the
    reference's describe keys, the closed-form bubble, a measured bubble
    report of the reference's shape, and eval equal to the model's loss."""
    from torch.func import functional_call

    from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh, shutdown_distributed

    model = GPT2(GPT2Config(**GPT2_TINY), device="cpu")
    try:
        mesh = make_mesh(MeshConfig(), device="cpu")
        tr = ShardedTrainer(mesh, TrainConfig(**_train_cfg(dict(micro_batches=4))),
                            model.as_pipeline_parts(), _loss_fn("gpt2"), device="cpu")
        d = tr.describe()
        assert d["mesh"] == {"data": 1, "pipe": 1, "model": 1, "seq": 1}
        assert d["num_stages"] == 1 and d["layers_per_stage"] == 4
        assert d["bubble_fraction"] == 0.0 and d["dtype"] == "float32"
        st = tr.init_state()
        batch = {k: torch.from_numpy(v) for k, v in _batch("gpt2").items()}
        with torch.no_grad():
            logits = functional_call(model, dict(model.named_parameters()),
                                     (batch["input_ids"],))
            ref = float(_loss_fn("gpt2")(logits, batch))
        assert float(tr.eval_fn(st, batch)) == pytest.approx(ref, rel=1e-6)
        rep = tr.measure_bubble(st, batch, repeats=1)
        assert len(rep["times_s"]) == len(rep["micros_timed"]) == 4
        assert all(t > 0 for t in rep["times_s"])
        assert rep["closed_form_bubble_fraction"] == 0.0
        assert set(rep) >= {"valid", "fit_r2", "measured_bubble_fraction", "tick_s"}
        # BERT's padding mask reaches every block as extras: the engine's
        # eval equals the classifier's masked loss
        clf, parts = _port_model("bert", BERT_TINY, None, False)
        bb = {k: torch.from_numpy(v) for k, v in _batch("bert").items()}
        with torch.no_grad():
            logits = clf(bb["input_ids"], attention_mask=bb["attention_mask"])
            ref = float(_loss_fn("bert")(logits, bb))
        trb = ShardedTrainer(mesh, TrainConfig(**_train_cfg({})), parts,
                             _loss_fn("bert"), device="cpu")
        assert float(trb.eval_fn(trb.init_state(), bb)) == pytest.approx(ref, rel=1e-5)
    finally:
        shutdown_distributed()
