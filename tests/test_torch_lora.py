"""PyTorch port, nn/lora.py + Dense's side product + Trainer(train_only=
"lora"): against the JAX package on the same seeded inputs and on params
converted from its LoRA trees, f32 on the CPU, tiny BERT (2 layers, dim
64) and single Dense layers.

Tolerances: forwards 1e-5 absolute (the same f32 math in another order);
the merge 1e-6 absolute (one rank-r f32 product and an add); int8 codes
exact after a merge. Five LoRA training steps are held as
``test_torch_train.py`` holds the full trainer's: losses within 1e-4
relative, params within 1e-3 absolute with 99% within 1e-5. Frozen
leaves are compared bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu import config as jconfig
from tensorlink_tpu.models.bert import BertClassifier as JBertClassifier
from tensorlink_tpu.models.bert import BertConfig as JBertConfig
from tensorlink_tpu.nn import lora as jlora
from tensorlink_tpu.nn.layers import Dense as JDense
from tensorlink_tpu.ops.quant import quantize_params_int8 as j_quantize
from tensorlink_tpu.train.trainer import Trainer as JTrainer
from tensorlink_tpu.train.trainer import TrainState as JTrainState
from tensorlink_tpu.train.trainer import softmax_cross_entropy as j_ce
from tensorlink_tpu_torch import config as tconfig
from tensorlink_tpu_torch.convert import params_from_jax, state_dict_to_jax
from tensorlink_tpu_torch.models.bert import BertClassifier, BertConfig
from tensorlink_tpu_torch.nn.layers import Dense
from tensorlink_tpu_torch.nn.lora import (
    LORA_ALL,
    lora_init,
    lora_merge,
    mask_to_lora,
    trainable_leaf_count,
)
from tensorlink_tpu_torch.ops.quant import quantize_params_int8
from tensorlink_tpu_torch.train.optim import apply_updates, clip_by_global_norm
from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy

CLASSES = 3
RANK, ALPHA = 4, 8.0
TCFG = dict(batch_size=4, micro_batches=1, optimizer="adamw", learning_rate=1e-3,
            weight_decay=0.01, dtype="float32", grad_clip_norm=1.0)


def _jcfg():
    return dataclasses.replace(JBertConfig.tiny(), dim=64, hidden_dim=128, dropout=0.0)


def _tcfg():
    return dataclasses.replace(BertConfig.tiny(), dim=64, hidden_dim=128, dropout=0.0)


def _perturb_b(tree, seed=7, scale=0.05):
    """Random lora_b (zeros at init would hide the side product)."""
    r = np.random.default_rng(seed)

    def f(path, x):
        if any(getattr(k, "key", None) == "lora_b" for k in path):
            return jnp.asarray(r.normal(size=x.shape) * scale, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def jbert():
    jm = JBertClassifier(_jcfg(), CLASSES)
    jp = jm.init(jax.random.key(0))
    jl = jlora.lora_init(jm, jp, jax.random.key(1), rank=RANK, alpha=ALPHA)
    return jm, jax.device_get(jp), jax.device_get(jl)


def _port_bert(tree=None):
    model = BertClassifier(_tcfg(), CLASSES, device="cpu", seed=0)
    lora_init(model, torch.Generator().manual_seed(1), rank=RANK, alpha=ALPHA)
    if tree is not None:
        model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def _ids(B=2, T=16, seed=0):
    r = np.random.default_rng(seed)
    am = np.ones((B, T), np.int32)
    am[0, T // 2:] = 0
    return r.integers(0, 128, (B, T)), am


def _leaf_meta(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path):
            (tuple(np.shape(x)), np.asarray(x).dtype.name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_init_names_shapes_dtypes_match_jax(dtype):
    jm = JBertClassifier(_jcfg(), CLASSES)
    jp = jm.init(jax.random.key(0))
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, jp)
    jl = jlora.lora_init(jm, jp, jax.random.key(1), rank=RANK, alpha=ALPHA)
    model = BertClassifier(_tcfg(), CLASSES, device="cpu",
                           dtype=getattr(torch, dtype), seed=0)
    for p in model.parameters():  # the serving dtype policy: 1-D stays f32
        if p.dim() < 2:
            p.data = p.data.float()
    lora_init(model, torch.Generator().manual_seed(1), rank=RANK, alpha=ALPHA)
    ours = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in model.state_dict().items()}
    assert ours == _leaf_meta(jl)
    s = model.bert.encoder._modules["0"].attn.q.lora_s
    assert s.dim() == 0 and s.dtype == torch.float32 and float(s) == ALPHA / RANK
    # default targets: q, k, v, o, up, down in every block; no pooler/head
    adapted = {k.rsplit(".", 2)[-2] for k in ours if k.endswith("lora_a")}
    assert adapted == {"q", "k", "v", "o", "up", "down"}


def test_adapted_bert_starts_at_base_and_matches_jax(jbert):
    jm, jp, jl = jbert
    ids, am = _ids()
    base = BertClassifier(_tcfg(), CLASSES, device="cpu", seed=None)
    base.load_state_dict(params_from_jax(jp))
    model = _port_bert(jl)
    with torch.no_grad():
        t_base = base(torch.from_numpy(ids), attention_mask=torch.from_numpy(am))
        t_lora = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(am))
    assert torch.equal(t_lora, t_base)  # b = 0: exactly the base model
    jl2 = _perturb_b(jl)
    model = _port_bert(jax.device_get(jl2))
    ref = jm.apply(jl2, jnp.asarray(ids), attention_mask=jnp.asarray(am))
    with torch.no_grad():
        out = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(am))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert not np.allclose(out.numpy(), t_base.numpy(), atol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_dense_side_product_matches_jax(quant):
    jd = JDense(16, 24)
    jp = jlora.lora_init(jd, jd.init(jax.random.key(2)), jax.random.key(3),
                         rank=RANK, alpha=ALPHA, targets=None)
    jp = _perturb_b(jp)
    if quant:
        jp = j_quantize(jd, jp)
    x = np.random.default_rng(4).normal(size=(3, 5, 16)).astype(np.float32)
    ref = np.asarray(jd.apply(jp, jnp.asarray(x)))
    td = Dense(16, 24, device="cpu")
    lora_init(td, targets=None, rank=RANK, alpha=ALPHA)
    if quant:
        quantize_params_int8(td)
    td.load_state_dict(params_from_jax(jax.device_get(jp)), strict=True)
    assert td.has_lora and td.quantized == quant
    with torch.no_grad():
        out = td(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_merge_and_merge_then_int8_match_jax(jbert):
    jm, _, jl = jbert
    jl2 = _perturb_b(jl)
    jmerged = jax.device_get(jlora.lora_merge(jm, jl2))
    model = _port_bert(jax.device_get(jl2))
    lora_merge(model)
    ours = model.state_dict()
    ref = params_from_jax(jmerged)
    assert set(ours) == set(ref)
    assert not any(k.rsplit(".", 1)[-1] in LORA_ALL for k in ours)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    jq = params_from_jax(jax.device_get(j_quantize(jm, jmerged)))
    quantize_params_int8(model)
    ours = model.state_dict()
    assert set(ours) == set(jq)
    for k in jq:
        if k.endswith(".w.q"):
            assert ours[k].dtype == torch.int8
            np.testing.assert_array_equal(ours[k].numpy(), jq[k].numpy(), err_msg=k)
        else:
            np.testing.assert_allclose(ours[k].numpy(), jq[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_trainable_count_and_mask_match_jax(jbert):
    _, _, jl = jbert
    model = _port_bert(jl)
    assert trainable_leaf_count(model) == jlora.trainable_leaf_count(jl)
    n_lora, total = trainable_leaf_count(dict(model.named_parameters()))
    assert 0 < n_lora < 0.2 * total
    ones = {k: torch.ones_like(v) for k, v in model.state_dict().items()}
    ref = params_from_jax(jax.device_get(jlora.mask_to_lora(jax.tree.map(jnp.ones_like, jl))))
    ours = mask_to_lora(ones)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    nested = mask_to_lora({"a": {"lora_b": torch.ones(2), "w": torch.ones(2)}})
    assert nested["a"]["lora_b"].sum() == 2 and nested["a"]["w"].sum() == 0


def _batches(n=5, B=4, T=32, seed=1):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        am = np.ones((B, T), np.int32)
        am[0, T // 2:] = 0
        out.append({"input_ids": r.integers(0, 128, (B, T)), "attention_mask": am,
                    "labels": r.integers(0, CLASSES, (B,))})
    return out


def _tloss(module, params, batch, rng):
    logits = functional_call(module, params, (batch["input_ids"],),
                             {"attention_mask": batch["attention_mask"],
                              "rng": rng, "train": rng is not None})
    return softmax_cross_entropy(logits, batch["labels"])


def _lora_trainer(tree, **over):
    cfg = tconfig.TrainConfig(**{**TCFG, "train_only": "lora", **over})
    return Trainer(_port_bert(tree), _tloss, cfg, device="cpu")


def test_five_lora_steps_match_jax(jbert):
    jm, _, jl = jbert

    def jloss(module, params, batch, rng):
        return j_ce(module.apply(params, batch["input_ids"],
                                 attention_mask=batch["attention_mask"]),
                    batch["labels"])

    jt = JTrainer(jm, jloss, jconfig.TrainConfig(**TCFG, train_only="lora"))
    js = JTrainState.create(jax.tree.map(jnp.asarray, jl), jt.optimizer)
    jlosses = []
    for b in _batches():
        js, st = jt.train_step(js, {k: jnp.asarray(v) for k, v in b.items()}, None)
        jlosses.append(float(st["loss"]))

    tt = _lora_trainer(jl)
    state = tt.init_state(params_from_jax(jl))
    losses = []
    for b in _batches():
        state, st = tt.train_step(state, b)
        losses.append(float(st["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state.step) == 5
    for ours_tree, ref_tree in ((state.params, js.params),
                                (state.opt_state["m"], js.opt_state["m"]),
                                (state.opt_state["v"], js.opt_state["v"])):
        ours = jax.tree_util.tree_leaves_with_path(state_dict_to_jax(ours_tree))
        ref = jax.tree_util.tree_leaves_with_path(jax.device_get(ref_tree))
        assert [p for p, _ in ours] == [p for p, _ in ref]
        diffs = np.concatenate([np.abs(a - np.asarray(b)).ravel()
                                for (_, a), (_, b) in zip(ours, ref)])
        assert diffs.max() < 1e-3
        assert np.quantile(diffs, 0.99) < 1e-5


@pytest.mark.parametrize("over", [
    dict(),
    dict(grad_clip_norm=0.0, weight_decay=0.0, optimizer="adam"),
    dict(grad_clip_norm=0.5, weight_decay=0.05, optimizer="adam"),
], ids=["adamw-clip", "adam-plain", "adam-l2-clip"])
def test_frozen_leaves_stay_bit_identical(jbert, over):
    tt = _lora_trainer(jbert[2], **over)
    s0 = tt.init_state()
    state = s0
    for b in _batches(3):
        state, st = tt.train_step(state, b)
        assert not bool(st["nonfinite"])
    for k, p in s0.params.items():
        frozen = not any(key in k.split(".") for key in ("lora_a", "lora_b"))
        assert torch.equal(state.params[k], p) == frozen, k
    # moments for every leaf, as the reference keeps them
    assert set(state.opt_state["m"]) == set(s0.params)


def test_adapter_grads_alone_equal_mask_after_full_grad(jbert):
    """Grads requested for the adapters alone (zeros elsewhere) give the
    state the reference's mask-after-full-grad step gives."""
    jl = jbert[2]
    tt = _lora_trainer(jl)
    full = Trainer(_port_bert(jl), _tloss, tconfig.TrainConfig(**TCFG), device="cpu")
    a = b = tt.init_state()
    for batch in _batches(3):
        a, _ = tt.train_step(a, batch)
        _, g = full.loss_and_grads(b.params, full._batch(batch))
        g, _ = clip_by_global_norm(mask_to_lora(g), TCFG["grad_clip_norm"])
        u, opt = full.optimizer.update(g, b.opt_state, b.params, b.step)
        b = dataclasses.replace(b, params=apply_updates(b.params, mask_to_lora(u)),
                                opt_state=opt, step=b.step + 1)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state["m"][k], b.opt_state["m"][k]), k
        assert torch.equal(a.opt_state["v"][k], b.opt_state["v"][k]), k
    assert int(a.step) == int(b.step) == 3


def test_lora_only_without_adapters_refuses():
    model = BertClassifier(_tcfg(), CLASSES, device="cpu")
    tt = Trainer(model, _tloss, tconfig.TrainConfig(**TCFG, train_only="lora"),
                 device="cpu")
    with pytest.raises(ValueError, match="adapter"):
        tt.train_step(tt.init_state(), _batches(1)[0])
