"""PyTorch port, train/optim.py + train/trainer.py + data/loader.py +
config.py: against the JAX package on the same gradients, params
(converted from its init) and batches, f32 on the CPU.

Tolerances: schedules and single optimizer updates 1e-6 (the same f32
arithmetic, in another order); the Trainer's loss per step within 1e-4
relative of the JAX Trainer's. Its params after 5 AdamW steps agree
within 1e-3 absolute, with 99% of them within 1e-5: Adam divides each
moment by the root of the second, so where a gradient is near zero the
last-ulp differences of two f32 backward passes become step-sized, and
one AdamW step moves a param by at most about lr (1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu import config as jconfig
from tensorlink_tpu.data.loader import ShardedLoader as JLoader
from tensorlink_tpu.models.bert import BertClassifier as JBertClassifier
from tensorlink_tpu.models.bert import BertConfig as JBertConfig
from tensorlink_tpu.train import optim as joptim
from tensorlink_tpu.train.trainer import Trainer as JTrainer
from tensorlink_tpu.train.trainer import TrainState as JTrainState
from tensorlink_tpu.train.trainer import softmax_cross_entropy as j_ce
from tensorlink_tpu_torch import config as tconfig
from tensorlink_tpu_torch.convert import params_from_jax, state_dict_to_jax
from tensorlink_tpu_torch.data.loader import ShardedLoader, prefetch_to_device
from tensorlink_tpu_torch.models.bert import BertClassifier, BertConfig
from tensorlink_tpu_torch.train import optim as toptim
from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy


def _tree(seed, shapes=((3, 5), (5,), (2, 2, 4))):
    r = np.random.default_rng(seed)
    return {f"p{i}": r.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _to_t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_config_copies_match_reference():
    for name in ("MeshConfig", "TrainConfig", "NodeConfig",
                 "DistributedConfig", "FrameworkConfig"):
        j, t = getattr(jconfig, name), getattr(tconfig, name)
        jf = {f.name: f.default for f in dataclasses.fields(j)}
        tf = {f.name: f.default for f in dataclasses.fields(t)}
        assert jf == tf, name
    with pytest.raises(ValueError, match="train_only"):
        tconfig.TrainConfig(train_only="all")
    with pytest.raises(ValueError, match="opt_moment_dtype"):
        tconfig.TrainConfig(opt_moment_dtype="float16")
    fc = tconfig.FrameworkConfig()
    assert tconfig.FrameworkConfig.from_json(fc.to_json()) == fc
    assert fc.to_dict() == jconfig.FrameworkConfig().to_dict()


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedules_match_jax(kind):
    kw = dict(base_lr=3e-4, warmup_steps=5, total_steps=20, final_lr_frac=0.1)
    js = joptim.make_schedule(kind, **kw)
    ts = toptim.make_schedule(kind, **kw)
    for step in range(25):
        np.testing.assert_allclose(
            float(ts(torch.tensor(step, dtype=torch.int32))),
            float(js(jnp.asarray(step, jnp.int32))), rtol=1e-6, err_msg=step)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_updates_match_jax(name):
    sched = dict(kind="linear", base_lr=1e-2, warmup_steps=1, total_steps=10)
    jo = joptim.make_optimizer(name, joptim.make_schedule(**sched), weight_decay=0.05)
    to = toptim.make_optimizer(name, toptim.make_schedule(**sched), weight_decay=0.05)
    jp = _tree(0)
    tp = _to_t(jp)
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _tree(10 + step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(step, jnp.int32))
        tu, ts = to.update(_to_t(g), ts, tp, torch.tensor(step, dtype=torch.int32))
        jp = joptim.apply_updates(jp, ju)
        tp = toptim.apply_updates(tp, tu)
        for k in tp:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_matches_jax():
    g = _tree(3)
    for max_norm in (0.5, 1e3):
        jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tc, tn = toptim.clip_by_global_norm(_to_t(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6, atol=1e-8)


def test_bf16_moments_round_unbiased_and_pass_inf():
    """The mean of many stochastically rounded copies of one value is the
    value (within 5 standard errors), where round-to-nearest would be off
    by the whole gap; inf and nan round to nearest."""
    lo = torch.tensor(1.0 + 2 ** -7, dtype=torch.bfloat16).float()  # bf16 grid point
    ulp = 2.0 ** -7
    for frac in (0.1, 0.5, 0.9):
        x = torch.full((100_000,), float(lo) + frac * ulp)
        for step in (0, 7):
            y = toptim._stochastic_round_bf16(x, torch.tensor(step), salt=3).float()
            assert set(torch.unique(y).tolist()) <= {float(lo), float(lo) + ulp}
            se = ulp * (frac * (1 - frac) / x.numel()) ** 0.5
            assert abs(float(y.mean()) - float(x[0])) < 5 * se, (frac, step)
    y = toptim._stochastic_round_bf16(
        torch.tensor([float("inf"), -float("inf"), float("nan"), 1.0]), 0, 1
    ).float()
    assert y[0] == float("inf") and y[1] == -float("inf") and torch.isnan(y[2])
    # deterministic by (step, salt)
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    a = toptim._stochastic_round_bf16(x, torch.tensor(4), 9)
    assert torch.equal(a, toptim._stochastic_round_bf16(x, torch.tensor(4), 9))
    assert not torch.equal(a, toptim._stochastic_round_bf16(x, torch.tensor(5), 9))
    # adam with bf16 moments stores bf16 and updates like the f32 one
    opt = toptim.adam(1e-3, moment_dtype="bfloat16")
    p = {"w": torch.randn(64, 64)}
    st = opt.init(p)
    u, st = opt.update({"w": torch.randn(64, 64)}, st, p, torch.tensor(0))
    assert st["m"]["w"].dtype == torch.bfloat16 and st["v"]["w"].dtype == torch.bfloat16


# ------------------------------------------------------------- trainer
CLASSES = 3
TCFG = dict(batch_size=4, micro_batches=1, optimizer="adamw", learning_rate=1e-3,
            weight_decay=0.01, dtype="float32", grad_clip_norm=1.0)


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


def _port_trainer(**over):
    cfg = dataclasses.replace(BertConfig.tiny(), dropout=0.0)
    model = BertClassifier(cfg, CLASSES, device="cpu")
    return Trainer(model, _tloss, tconfig.TrainConfig(**{**TCFG, **over}), device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    cfg = dataclasses.replace(JBertConfig.tiny(), dropout=0.0)
    jm = JBertClassifier(cfg, CLASSES)
    jp = jax.device_get(jm.init(jax.random.key(0)))

    def jloss(module, params, batch, rng):
        return j_ce(module.apply(params, batch["input_ids"],
                                 attention_mask=batch["attention_mask"]),
                    batch["labels"])

    jt = JTrainer(jm, jloss, jconfig.TrainConfig(**TCFG))
    state = JTrainState.create(jp, jt.optimizer)
    losses = []
    for b in _batches():
        state, st = jt.train_step(state, {k: jnp.asarray(v) for k, v in b.items()}, None)
        losses.append(float(st["loss"]))
    return jp, losses, jax.device_get(state.params)


def test_trainer_five_steps_match_jax(jax_run):
    jp, jlosses, jparams = jax_run
    tt = _port_trainer()
    state = tt.init_state(params_from_jax(jp, torch.float32))
    losses = []
    for b in _batches():
        state, st = tt.train_step(state, b)
        losses.append(float(st["loss"]))
        assert not bool(st["nonfinite"])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state.step) == 5
    # the port's params back in the JAX tree's shape, leaf by leaf
    ours = jax.tree_util.tree_leaves_with_path(state_dict_to_jax(state.params))
    ref = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in ours] == [p for p, _ in ref]
    diffs = np.concatenate([np.abs(a - np.asarray(b)).ravel()
                            for (_, a), (_, b) in zip(ours, ref)])
    assert diffs.max() < 1e-3
    assert np.quantile(diffs, 0.99) < 1e-5


def test_fsdp_refusal_matches_jax():
    """The single-device Trainer refuses FSDP as the reference does: the
    same exception type, the same message."""
    jm = JBertClassifier(dataclasses.replace(JBertConfig.tiny(), dropout=0.0), CLASSES)
    with pytest.raises(ValueError) as ref:
        JTrainer(jm, lambda *a: None, jconfig.TrainConfig(**TCFG, fsdp=True))
    with pytest.raises(ValueError) as ours:
        _port_trainer(fsdp=True)
    assert str(ours.value) == str(ref.value)
    assert "fsdp_train_step" in str(ours.value)


def test_micro_batches_accumulate_like_one_batch(jax_run):
    jp = jax_run[0]
    b = _batches(1)[0]
    states = []
    for micro in (1, 2):
        tt = _port_trainer(micro_batches=micro)
        s0 = tt.init_state(params_from_jax(jp, torch.float32))
        s1, st = tt.train_step(s0, b)
        states.append((s1, float(st["loss"]), float(st["grad_norm"])))
    (a, la, ga), (c, lc, gc) = states
    np.testing.assert_allclose(lc, la, rtol=1e-6)
    np.testing.assert_allclose(gc, ga, rtol=1e-5)
    for k in a.params:
        np.testing.assert_allclose(c.params[k].numpy(), a.params[k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_skip_nonfinite_leaves_state_unchanged(jax_run):
    jp = jax_run[0]

    def loss(module, params, batch, rng):
        return _tloss(module, params, batch, rng) * batch["w"].mean()

    cfg = dataclasses.replace(BertConfig.tiny(), dropout=0.0)
    tt = Trainer(BertClassifier(cfg, CLASSES, device="cpu"), loss,
                 tconfig.TrainConfig(**TCFG, skip_nonfinite_updates=True),
                 device="cpu")
    b = _batches(1)[0]
    s0 = tt.init_state(params_from_jax(jp, torch.float32))
    s1, st = tt.train_step(s0, {**b, "w": np.ones(4, np.float32)})
    assert not bool(st["nonfinite"]) and int(s1.step) == 1
    s2, st = tt.train_step(s1, {**b, "w": np.array([1, np.inf, 1, 1], np.float32)})
    assert bool(st["nonfinite"])
    assert int(s2.step) == 1
    for k in s1.params:
        assert torch.equal(s2.params[k], s1.params[k]), k
        assert torch.equal(s2.opt_state["m"][k], s1.opt_state["m"][k]), k
        assert torch.equal(s2.opt_state["v"][k], s1.opt_state["v"][k]), k


def test_dropout_training_step_runs_and_reproduces(jax_run):
    """train=True with a generator: finite, and the same seed gives the
    same step."""
    jp = jax_run[0]
    cfg = BertConfig.tiny()  # dropout 0.1
    tt = Trainer(BertClassifier(cfg, CLASSES, device="cpu"), _tloss,
                 tconfig.TrainConfig(**TCFG), device="cpu")
    b = _batches(1)[0]
    out = []
    for _ in range(2):
        s0 = tt.init_state(params_from_jax(jp, torch.float32))
        s1, st = tt.train_step(s0, b, torch.Generator().manual_seed(5))
        out.append((float(st["loss"]), s1))
    assert np.isfinite(out[0][0]) and out[0][0] == out[1][0]
    for k in out[0][1].params:
        assert torch.equal(out[0][1].params[k], out[1][1].params[k])


def test_loader_order_matches_jax():
    data = {"x": np.arange(50).reshape(25, 2), "y": np.arange(25)}
    for kw in ({"seed": 4}, {"seed": 9, "shuffle": False},
               {"seed": 1, "process_index": 1, "process_count": 2}):
        jl = JLoader(data, 6, **kw)
        tl = ShardedLoader(data, 6, **kw)
        jb, tb = list(jl.epochs(2)), list(tl.epochs(2))
        assert len(jb) == len(tb) == 2 * len(tl)
        for a, b in zip(jb, tb):
            for k in data:
                np.testing.assert_array_equal(a[k], b[k])
    got = list(prefetch_to_device(iter(ShardedLoader(data, 6, seed=4)), "cpu"))
    ref = list(ShardedLoader(data, 6, seed=4))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert isinstance(a["x"], torch.Tensor)
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])
