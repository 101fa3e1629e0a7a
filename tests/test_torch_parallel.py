"""PyTorch port, parallel/tp.py, parallel/pp.py, parallel/dp.py and the
spec trees of nn/module.py and nn/lora.py.

Pure functions against the JAX package, exactly: every ``param_spec``
tree (Dense in each role, attention plain and fused, the block, BERT,
GPT-2, Llama, MoE) and ``lora_spec_tree``, compared as tuples (the JAX
tree's empty ``Dropout`` subtrees dropped); ``stack_stage_params``,
``unstack_stage_params`` and ``reshape_stages`` on the same arrays.

Collectives on spawned gloo ranks, each against the unsharded
computation in the same process, f32: TP (model 4) for a Dense col/row
pair, a block, a GQA block, a vocab-sharded ``Embedding`` (lookup and
tied logits) and LoRA'd Dense in both roles, outputs and every
gradient within 1e-5; GPipe (pipe 4, and 2 layers a stage on data 2 x
pipe 2) forward within 1e-5 and gradients within 1e-4 of the plain
stack, as the reference's pipeline tests; replicated DP (data 2)
against the single-device ``Trainer``, 3 SGD steps, 1e-5.

Top level: torch and the port only (spawned ranks import this module).
"""

import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from torch_ranks import spawn_cpu_ranks


def _spec_tuples(tree):
    """Nested spec tree -> {dotted: tuple}, empty subtrees dropped."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            out[prefix] = tuple(node)

    walk(tree, "")
    return out


def _modules(name):
    """(JAX module, port module) built from the same arguments."""
    import tensorlink_tpu.nn as jnn
    from tensorlink_tpu.models import bert as jbert
    from tensorlink_tpu.models import gpt2 as jgpt2
    from tensorlink_tpu.models import llama as jllama
    from tensorlink_tpu.nn.moe import MoEFeedForward as JMoE
    from tensorlink_tpu_torch import nn as tnn
    from tensorlink_tpu_torch.models import bert as tbert
    from tensorlink_tpu_torch.models import gpt2 as tgpt2
    from tensorlink_tpu_torch.models import llama as tllama
    from tensorlink_tpu_torch.nn.moe import MoEFeedForward as TMoE

    cpu = {"device": "cpu"}
    if name == "dense_nobias_col":
        return (jnn.Dense(8, 16, use_bias=False, shard="col"),
                tnn.Dense(8, 16, use_bias=False, shard="col", **cpu))
    if name.startswith("dense_"):
        shard = {"col": "col", "row": "row", "none": None}[name[6:]]
        return (jnn.Dense(8, 16, shard=shard), tnn.Dense(8, 16, shard=shard, **cpu))
    if name == "embedding_vocab":
        return jnn.Embedding(64, 8, shard="vocab"), tnn.Embedding(64, 8, shard="vocab", **cpu)
    if name == "attention_gqa":
        return (jnn.MultiHeadAttention(32, 4, num_kv_heads=2),
                tnn.MultiHeadAttention(32, 4, num_kv_heads=2, **cpu))
    if name == "attention_fused":
        return (jnn.MultiHeadAttention(32, 4, num_kv_heads=2, qkv_fused=True),
                tnn.MultiHeadAttention(32, 4, num_kv_heads=2, qkv_fused=True, **cpu))
    if name == "block":
        kw = dict(dim=32, num_heads=4, hidden_dim=64, norm_style="post")
        return jnn.TransformerBlock(**kw), tnn.TransformerBlock(**kw, **cpu)
    if name == "moe":
        return JMoE(32, 64, num_experts=4), TMoE(32, 64, num_experts=4, **cpu)
    if name == "bert":
        kw = dict(vocab_size=128, dim=32, num_layers=2, num_heads=2, hidden_dim=64,
                  max_len=64)
        return (jbert.BertClassifier(jbert.BertConfig(**kw), 3),
                tbert.BertClassifier(tbert.BertConfig(**kw), 3, **cpu))
    if name == "gpt2":
        return (jgpt2.GPT2(jgpt2.GPT2Config.tiny()),
                tgpt2.GPT2(tgpt2.GPT2Config.tiny(), **cpu))
    if name == "llama":
        return (jllama.Llama(jllama.LlamaConfig.tiny()),
                tllama.Llama(tllama.LlamaConfig.tiny(), **cpu))
    if name == "llama_moe":
        return (jllama.Llama(jllama.LlamaConfig.moe_tiny()),
                tllama.Llama(tllama.LlamaConfig.moe_tiny(), **cpu))
    raise KeyError(name)


SPEC_MODULES = ("dense_col", "dense_row", "dense_none", "dense_nobias_col",
                "embedding_vocab", "attention_gqa", "attention_fused", "block",
                "moe", "bert", "gpt2", "llama", "llama_moe")


@pytest.mark.parametrize("name", SPEC_MODULES)
@pytest.mark.parametrize("axis", ["model", "tp"])
def test_param_spec_tree_matches_reference(name, axis):
    jm, tm = _modules(name)
    j = _spec_tuples(jm.param_spec(axis))
    t = _spec_tuples(tm.param_spec(axis))
    assert t == j
    # and the tree names the port's parameters, one for one
    assert set(t) == {k for k, _ in tm.named_parameters()}


@pytest.mark.parametrize("name", ["gpt2", "llama", "bert", "block", "dense_row"])
def test_lora_spec_tree_matches_reference(name):
    import jax

    from tensorlink_tpu.nn.lora import lora_init as jlora_init
    from tensorlink_tpu.nn.lora import lora_spec_tree as jlora_spec_tree
    from tensorlink_tpu_torch.nn.lora import lora_init, lora_spec_tree

    jm, tm = _modules(name)
    targets = None if name == "dense_row" else ("q", "k", "v", "o", "up", "gate", "down")
    jp = jlora_init(jm, jm.init(jax.random.key(0)), jax.random.key(1), rank=4,
                    targets=targets)
    lora_init(tm, torch.Generator().manual_seed(1), rank=4, targets=targets)
    j = _spec_tuples(jlora_spec_tree(jm.param_spec(), jp))
    t = _spec_tuples(lora_spec_tree(tm.param_spec(), dict(tm.named_parameters())))
    assert t == j
    assert any("lora_b" in k for k in t)


def test_stack_unstack_reshape_match_reference():
    import jax.numpy as jnp

    from tensorlink_tpu.parallel.engine import reshape_stages as j_reshape
    from tensorlink_tpu.parallel.pp import stack_stage_params as j_stack
    from tensorlink_tpu.parallel.pp import unstack_stage_params as j_unstack
    from tensorlink_tpu_torch.parallel.engine import reshape_stages
    from tensorlink_tpu_torch.parallel.pp import stack_stage_params, unstack_stage_params

    r = np.random.default_rng(0)
    layers = {str(i): {"attn": {"w": r.standard_normal((3, 5)).astype(np.float32)},
                       "b": r.standard_normal((5,)).astype(np.float32)}
              for i in range(8)}
    t_layers = {i: {"attn": {"w": torch.from_numpy(v["attn"]["w"])},
                    "b": torch.from_numpy(v["b"])} for i, v in layers.items()}
    j_layers = {i: {"attn": {"w": jnp.asarray(v["attn"]["w"])}, "b": jnp.asarray(v["b"])}
                for i, v in layers.items()}
    for S in (1, 2, 4, 8):
        t = stack_stage_params(t_layers, S)
        j = j_stack(j_layers, S)
        np.testing.assert_array_equal(t["attn"]["w"].numpy(), np.asarray(j["attn"]["w"]))
        np.testing.assert_array_equal(t["b"].numpy(), np.asarray(j["b"]))
        back = unstack_stage_params(t, S, 8 // S)
        jback = j_unstack(j, S, 8 // S)
        for i in range(8):
            np.testing.assert_array_equal(back[str(i)]["b"].numpy(),
                                          np.asarray(jback[str(i)]["b"]))
            np.testing.assert_array_equal(back[str(i)]["b"], t_layers[str(i)]["b"])
        for S2 in (1, 2, 4, 8):
            np.testing.assert_array_equal(
                reshape_stages(t, S2)["attn"]["w"].numpy(),
                np.asarray(j_reshape(j, S2)["attn"]["w"]))
    with pytest.raises(ValueError, match="divisible"):
        stack_stage_params(t_layers, 3)
    with pytest.raises(ValueError, match="divisible"):
        reshape_stages(stack_stage_params(t_layers, 2), 3)


# ---------------------------------------------------------------- TP


def _tp_cases(tag):
    """(module, input) pairs the TP rank checks, built identically on
    every rank from one seed."""
    from tensorlink_tpu_torch import nn as tnn
    from tensorlink_tpu_torch.models.llama import LlamaConfig
    from tensorlink_tpu_torch.nn.lora import lora_init

    torch.manual_seed(0)
    cpu = {"device": "cpu"}
    x = torch.randn(2, 6, 32)
    if tag == "dense_col_row":
        mod = tnn.Sequential([tnn.Dense(32, 64, shard="col", **cpu),
                              tnn.Dense(64, 32, shard="row", **cpu)])
    elif tag == "block":
        mod = tnn.TransformerBlock(32, 8, causal=True, **cpu)
    elif tag == "block_gqa":
        c = LlamaConfig.tiny()
        mod = tnn.TransformerBlock(32, 8, num_kv_heads=4, hidden_dim=64, norm="rms",
                                   activation="silu", use_bias=False, gated_mlp=True,
                                   causal=True, rope=True, rope_theta=c.rope_theta, **cpu)
    elif tag == "lora_col_row":
        mod = tnn.Sequential([tnn.Dense(32, 64, shard="col", **cpu),
                              tnn.Dense(64, 32, shard="row", **cpu)])
        lora_init(mod, torch.Generator().manual_seed(2), rank=4, targets=None)
        with torch.no_grad():  # b = 0 at init: give it a value
            for m in mod.modules():
                if getattr(m, "has_lora", False):
                    m.lora_b.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(3))
    elif tag == "embedding":
        mod = tnn.Embedding(64, 32, shard="vocab", **cpu)
        x = torch.randint(0, 64, (2, 6))
    else:
        raise KeyError(tag)
    for p in mod.parameters():
        with torch.no_grad():
            p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(p.numel()))
    return mod, x


TP_CASES = ("dense_col_row", "block", "block_gqa", "lora_col_row", "embedding")


def _tp_loss(tag, mod, params, x):
    if tag == "embedding":
        from tensorlink_tpu_torch.parallel.engine import apply_with

        e = apply_with(mod, params, x)
        logits = apply_with(mod, params, e, method="attend")
        return (logits.square().mean() + e.sum() * 0.01), logits
    y = functional_call(mod, params, (x,))
    return y.square().mean(), y


def _tp_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.parallel import tp
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    mesh = make_mesh(MeshConfig(model=world), device="cpu")
    res = {}
    for tag in TP_CASES:
        mod, x = _tp_cases(tag)
        full = {k: v.detach().clone() for k, v in mod.named_parameters()}
        local = {k: v.clone().requires_grad_() for k, v in
                 tp.shard_params(full, mod, mesh).items()}
        with tp.model_parallel(mesh.get_group("model")):
            loss, y = _tp_loss(tag, mod, local, x)
            loss.backward()
        # tp_jit: the same forward from the whole params
        y2 = tp.tp_jit(lambda p, xx: _tp_loss(tag, mod, p, xx)[1], mod, mesh)(full, x)
        res[tag] = {"y": y.detach(), "y_tp_jit": y2.detach(),
                    "grads": {k: v.grad for k, v in local.items()},
                    "shapes": {k: tuple(v.shape) for k, v in local.items()}}
    torch.save(res, os.path.join(out_dir, f"tp_rank{rank}.pt"))


@pytest.fixture(scope="module")
def tp_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    spawn_cpu_ranks(_tp_rank, 4, str(d), store_dir=str(d))
    return [torch.load(d / f"tp_rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("tag", TP_CASES)
def test_tp_matches_unsharded(tag, tp_results):
    from tensorlink_tpu_torch.nn.module import NamedSharding, flat_specs

    mod, x = _tp_cases(tag)
    full = {k: v.detach().clone().requires_grad_() for k, v in mod.named_parameters()}
    loss, y = _tp_loss(tag, mod, full, x)
    loss.backward()
    from tensorlink_tpu_torch.nn.lora import lora_spec_tree

    specs = flat_specs(lora_spec_tree(mod.param_spec(), dict(mod.named_parameters())))

    class _Mesh:  # rank r's coordinate on a model-only mesh
        mesh_dim_names = ("data", "pipe", "model", "seq")

        def __init__(self, r):
            self.r = r

        def size(self, i):
            return 4 if i == 2 else 1

        def get_local_rank(self, name):
            return self.r if name == "model" else 0

    split = 0
    for r, res in enumerate(tp_results):
        out = res[tag]
        np.testing.assert_allclose(out["y"], y.detach(), atol=1e-5)
        np.testing.assert_allclose(out["y_tp_jit"], y.detach(), atol=1e-5)
        for k, g in out["grads"].items():
            want = NamedSharding(_Mesh(r), specs[k]).local(full[k].grad)
            np.testing.assert_allclose(g, want, atol=1e-5, err_msg=f"{tag} {k}")
            split += out["shapes"][k] != tuple(full[k].shape)
    assert split > 0, "nothing was sharded"


# ---------------------------------------------------------------- PP


def _stack_and_inputs(L=4, dim=16, M=4, mb=8):
    from tensorlink_tpu_torch import nn as tnn

    torch.manual_seed(0)
    stack = tnn.TransformerStack(L, tnn.TransformerBlock, dim=dim, num_heads=2,
                                 causal=True, device="cpu")
    for p in stack.parameters():
        with torch.no_grad():
            p.normal_(0.0, 0.2)
    xs = torch.randn(M, mb, 6, dim)
    params = {k: v.detach().clone() for k, v in stack.named_parameters()}
    return stack, params, xs


def _layer_params(params, i):
    n = len(f"{i}.")
    return {k[n:]: v for k, v in params.items() if k.startswith(f"{i}.")}


def _pp_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.parallel.dp import dp_shard_batch
    from tensorlink_tpu_torch.parallel.pp import Pipeline
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    res = {}
    for tag, mesh_kw, S in (("pipe4", dict(pipe=4), 4), ("data2_pipe2", dict(data=2, pipe=2), 2)):
        mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
        stack, params, xs = _stack_and_inputs()
        blk = stack.blocks()[0]
        Lps = 4 // S
        s = mesh.get_local_rank("pipe")
        sp = [{k: v.clone().requires_grad_() for k, v in
               _layer_params(params, s * Lps + l).items()} for l in range(Lps)]
        pipe = Pipeline(mesh, lambda lp, x: functional_call(blk, lp, (x,)), S, Lps)
        if tag == "data2_pipe2":  # this replica's rows of every micro
            xs = dp_shard_batch({"x": xs.transpose(0, 1)}, mesh)["x"].transpose(0, 1)
        out = pipe(sp, xs)
        run = pipe.forward(sp, xs, grad=True)
        dys = None
        if pipe.comm.last:
            ys = torch.stack(run.outputs)
            dys = list(torch.autograd.grad(ys.square().mean(), ys)[0])
        dxs = pipe.backward(run, dys)
        res[tag] = {"out": out, "stage": s, "data": mesh.get_local_rank("data"),
                    "grads": [{k: v.grad for k, v in lp.items()} for lp in sp],
                    "dxs": None if dxs is None else torch.stack(dxs)}
    torch.save(res, os.path.join(out_dir, f"pp_rank{rank}.pt"))


@pytest.fixture(scope="module")
def pp_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    spawn_cpu_ranks(_pp_rank, 4, str(d), store_dir=str(d))
    return [torch.load(d / f"pp_rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("tag", ["pipe4", "data2_pipe2"])
def test_pipeline_forward_and_grads_match_stack(tag, pp_results):
    stack, params, xs = _stack_and_inputs()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    for r, res in enumerate(pp_results):
        out = res[tag]
        x = xs
        if tag == "data2_pipe2":
            x = xs.chunk(2, dim=1)[out["data"]]
        xg = x.clone().requires_grad_()
        ref = torch.stack([functional_call(stack, leaves, (xg[m],)) for m in range(4)])
        # every pipe rank returns the last stage's outputs
        np.testing.assert_allclose(out["out"], ref.detach(), atol=1e-5)
        for p in leaves.values():
            p.grad = None
        ref.square().mean().backward()
        S = 4 if tag == "pipe4" else 2
        Lps = 4 // S
        for l, g in enumerate(out["grads"]):
            i = out["stage"] * Lps + l
            for k, v in g.items():
                np.testing.assert_allclose(v, leaves[f"{i}.{k}"].grad, atol=1e-4,
                                           err_msg=f"{tag} layer {i} {k}")
        if out["stage"] == 0:
            np.testing.assert_allclose(out["dxs"], xg.grad, atol=1e-4)


# ---------------------------------------------------------------- DP


def _mlp_loss(module, params, batch, rng):
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    return softmax_cross_entropy(functional_call(module, params, (batch["x"],)),
                                 batch["y"])


def _toy():
    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig

    model = MLP(MLPConfig(in_dim=16, hidden_dim=32, out_dim=4), device="cpu", seed=0)
    r = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(r.standard_normal((64, 16)).astype(np.float32)),
             "y": torch.from_numpy(r.integers(0, 4, (64,)))}
    return model, batch


DP_CFG = dict(batch_size=64, micro_batches=1, learning_rate=0.05, optimizer="sgd",
              grad_clip_norm=None, dtype="float32")


def _dp_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.parallel.dp import dp_train_step
    from tensorlink_tpu_torch.runtime.mesh import make_mesh
    from tensorlink_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(MeshConfig(data=world), device="cpu")
    model, batch = _toy()
    tr = Trainer(model, _mlp_loss, TrainConfig(**DP_CFG), device="cpu")
    step = dp_train_step(tr._step, mesh)
    st = tr.init_state()
    losses = []
    for _ in range(3):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    torch.save({"losses": losses, "params": st.params},
               os.path.join(out_dir, f"dp_rank{rank}.pt"))


def test_dp_matches_single_device(tmp_path):
    from tensorlink_tpu_torch.train.trainer import Trainer

    spawn_cpu_ranks(_dp_rank, 2, str(tmp_path), store_dir=str(tmp_path))
    model, batch = _toy()
    tr = Trainer(model, _mlp_loss, TrainConfig(**DP_CFG), device="cpu")
    st = tr.init_state()
    losses = []
    for _ in range(3):
        st, m = tr.train_step(st, batch)
        losses.append(float(m["loss"]))
    for r in range(2):
        out = torch.load(tmp_path / f"dp_rank{r}.pt")
        np.testing.assert_allclose(out["losses"], losses, atol=1e-5)
        for k, v in st.params.items():
            np.testing.assert_allclose(out["params"][k], v, atol=1e-5)
