"""PyTorch port, FSDP (parallel/dp.py and ``ShardedTrainer(cfg.fsdp)``).

``fsdp_spec`` and ``fsdp_spec_tree`` are pure and held equal to the JAX
package's on a grid of shapes, data sizes, taken dims and thresholds,
and on GPT-2's spec tree. On spawned gloo ranks (f32): the
``fsdp_train_step`` wrapper against the single-device ``Trainer`` (3
AdamW steps, 1e-5), both wrappers under the trainer's micro-batches,
LoRA masking with weight decay, a binding clip and a skipped poisoned
batch, and the engine with ``fsdp=True`` against the same
engine replicated over ``data`` under both schedules (losses within
1e-5: the reduce-scatter reorders the gradient sum), with params and
moments split over ``data`` where the spec says, and composed with TP
(data 2 x model 2: both axes on the big weights, a falling loss).

Top level: torch and the port only (spawned ranks import this module).
"""

import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from tensorlink_tpu_torch.nn.module import P
from tensorlink_tpu_torch.parallel.dp import fsdp_spec, fsdp_spec_tree
from torch_ranks import spawn_cpu_ranks

SHAPES = ((128, 512), (512, 128), (256, 256), (3, 5), (8, 8), (1024,), (4, 8),
          (50, 64, 6), (2, 2, 2, 2), (7,), (96, 32))
SPECS = ((), ("model",), (None, "model"), ("pipe", "model"), ("model", None, None))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("data", [1, 2, 4])
def test_fsdp_spec_matches_reference(shape, data):
    from jax.sharding import PartitionSpec as JP

    from tensorlink_tpu.parallel.dp import fsdp_spec as j_fsdp_spec

    for spec in SPECS:
        if len(spec) > len(shape):
            continue
        for min_elems in (1, 64, 2**16):
            got = fsdp_spec(P(*spec), shape, data, min_elems=min_elems)
            want = j_fsdp_spec(JP(*spec), shape, data, min_elems=min_elems)
            assert tuple(got) == tuple(want), (spec, min_elems)


def test_fsdp_spec_picks_largest_free_dim():
    assert fsdp_spec(P(), (128, 512), 2, min_elems=1) == P(None, "data")
    assert fsdp_spec(P(), (512, 128), 2, min_elems=1) == P("data")
    assert fsdp_spec(P(), (256, 256), 2, min_elems=1) == P(None, "data")


def test_fsdp_spec_respects_existing_axes():
    assert fsdp_spec(P(None, "model"), (256, 256), 2, min_elems=1) == P("data", "model")
    assert fsdp_spec(P("pipe", "model"), (4, 8), 2, min_elems=1) == P("pipe", "model")


def test_fsdp_spec_divisibility_and_threshold():
    assert fsdp_spec(P(), (3, 5), 2, min_elems=1) == P()
    assert fsdp_spec(P(), (8, 8), 2, min_elems=1024) == P()
    assert fsdp_spec(P(), (256, 256), 1, min_elems=1) == P()


def test_fsdp_spec_tree_matches_reference_on_gpt2():
    import jax

    from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
    from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from tensorlink_tpu.parallel.dp import fsdp_spec_tree as j_tree
    from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu_torch.utils.trees import flatten as _flatten, nest as _nest

    kw = dict(vocab_size=512, dim=256, num_layers=2, num_heads=4, max_len=64)
    jm = JGPT2(JGPT2Config(**kw))
    tm = GPT2(GPT2Config(**kw), device="cpu")
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    for n in (2, 4):
        j = j_tree(jm.param_spec(), jp, n)
        t = fsdp_spec_tree(tm.param_spec(), _nest(dict(tm.named_parameters())), n)
        jf = {k: tuple(v) for k, v in _flatten(jax.tree.map(
            lambda s: ("spec", tuple(s)), j,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))).items()}
        tf = {k: ("spec", tuple(v)) for k, v in _flatten(t).items()}
        assert tf == {k: v for k, v in jf.items()}
        assert any("data" in v[1] for v in tf.values())


def test_single_host_trainer_rejects_fsdp():
    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
    from tensorlink_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="fsdp"):
        Trainer(MLP(MLPConfig(in_dim=16, hidden_dim=64, out_dim=4), device="cpu"),
                lambda *a: None, TrainConfig(fsdp=True), device="cpu")


# ----------------------------------------------------- trainer path


def _mlp_loss(module, params, batch, rng):
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    return softmax_cross_entropy(functional_call(module, params, (batch["x"],)),
                                 batch["y"])


def _toy():
    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig

    model = MLP(MLPConfig(in_dim=16, hidden_dim=64, out_dim=4), device="cpu", seed=0)
    r = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(r.standard_normal((64, 16)).astype(np.float32)),
             "y": torch.from_numpy(r.integers(0, 4, (64,)))}
    return model, batch


TOY_CFG = dict(batch_size=64, micro_batches=1, learning_rate=0.05,
               optimizer="adamw", grad_clip_norm=None, dtype="float32")


def _fsdp_step_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.parallel.dp import fsdp_train_step
    from tensorlink_tpu_torch.runtime.mesh import make_mesh
    from tensorlink_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(MeshConfig(data=world), device="cpu")
    model, batch = _toy()
    tr = Trainer(model, _mlp_loss, TrainConfig(**TOY_CFG), device="cpu")
    step, st = fsdp_train_step(tr._step, mesh, tr.init_state(), min_elems=1)
    shapes = {k: tuple(v.shape) for k, v in st.params.items()}
    moments = {k: tuple(v.shape) for k, v in st.opt_state["m"].items()}
    losses = []
    for _ in range(3):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    whole = step.gather(st)
    torch.save({"losses": losses, "params": whole.params, "shapes": shapes,
                "moments": moments}, os.path.join(out_dir, f"fsdp_rank{rank}.pt"))


def test_fsdp_train_step_matches_replicated(tmp_path):
    from tensorlink_tpu_torch.train.trainer import Trainer

    spawn_cpu_ranks(_fsdp_step_rank, 2, str(tmp_path), store_dir=str(tmp_path))
    model, batch = _toy()
    tr = Trainer(model, _mlp_loss, TrainConfig(**TOY_CFG), device="cpu")
    st = tr.init_state()
    losses = []
    for _ in range(3):
        st, m = tr.train_step(st, batch)
        losses.append(float(m["loss"]))
    for r in range(2):
        out = torch.load(tmp_path / f"fsdp_rank{r}.pt")
        np.testing.assert_allclose(out["losses"], losses, atol=1e-5)
        for k, v in st.params.items():
            np.testing.assert_allclose(out["params"][k], v, atol=1e-5)
        w1 = out["shapes"]["seq.0.w"]
        assert w1 == (16, 32)  # split, not vacuous
        assert out["moments"] == out["shapes"]


# Trainer._step's own semantics under both wrappers: 4 micro-batches,
# adapters only with AdamW's decay on (a frozen base weight must keep its
# bits), a clip that binds (by the norm over every rank's blocks), and a
# poisoned batch (a NaN in a row of rank 1's half) that every rank skips
LORA_CFG = dict(batch_size=64, micro_batches=4, learning_rate=0.05, optimizer="adamw",
                weight_decay=0.1, grad_clip_norm=0.02, train_only="lora",
                skip_nonfinite_updates=True, dtype="float32")
POISON_STEP = 3


def _lora_toy():
    from tensorlink_tpu_torch.nn.lora import lora_init

    model, batch = _toy()
    lora_init(model, torch.Generator().manual_seed(1), rank=4, alpha=8.0, targets=None)
    return model, batch


def _lora_steps(step, st, batch):
    stats = []
    for i in range(5):
        b = batch
        if i == POISON_STEP:
            b = dict(batch, x=batch["x"].clone())
            b["x"][40, 3] = float("nan")
        st, m = step(st, b)
        stats.append([float(m["loss"]), float(m["grad_norm"]), float(m["nonfinite"])])
    return st, stats


def _lora_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.parallel.dp import dp_train_step, fsdp_train_step
    from tensorlink_tpu_torch.runtime.mesh import make_mesh
    from tensorlink_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(MeshConfig(data=world), device="cpu")
    model, batch = _lora_toy()
    tr = Trainer(model, _mlp_loss, TrainConfig(**LORA_CFG), device="cpu")
    out = {}
    step, st = fsdp_train_step(tr._step, mesh, tr.init_state(), min_elems=1)
    out["fsdp_shapes"] = {k: tuple(v.shape) for k, v in st.params.items()}
    st, out["fsdp"] = _lora_steps(step, st, batch)
    out["fsdp_state"] = step.gather(st)
    st, out["dp"] = _lora_steps(dp_train_step(tr._step, mesh), tr.init_state(), batch)
    out["dp_state"] = st
    torch.save(out, os.path.join(out_dir, f"lora_rank{rank}.pt"))


def test_wrapped_steps_keep_the_trainer_step(tmp_path):
    """DP and FSDP over 2 ranks against the single-device ``Trainer`` under
    LORA_CFG: per-step loss, pre-clip norm and non-finite flag, and the
    final params and moments (atol 1e-5), the step counter past the skip,
    and every base leaf bit-identical to its init."""
    from tensorlink_tpu_torch.train.trainer import Trainer

    spawn_cpu_ranks(_lora_rank, 2, str(tmp_path), store_dir=str(tmp_path))
    model, batch = _lora_toy()
    tr = Trainer(model, _mlp_loss, TrainConfig(**LORA_CFG), device="cpu")
    st0 = tr.init_state()
    st, want = _lora_steps(tr.train_step, st0, batch)
    assert [s[2] for s in want] == [0, 0, 0, 1, 0]
    assert want[0][1] > 2 * LORA_CFG["grad_clip_norm"]  # the clip binds
    assert int(st.step) == 4
    for r in range(2):
        out = torch.load(tmp_path / f"lora_rank{r}.pt", weights_only=False)
        assert out["fsdp_shapes"]["seq.0.lora_a"] == (8, 4)  # split, not vacuous
        for mode in ("fsdp", "dp"):
            np.testing.assert_allclose(out[mode], want, rtol=1e-5, atol=1e-6,
                                       err_msg=mode)
            got = out[mode + "_state"]
            assert int(got.step) == 4, mode
            for k, v in st.params.items():
                np.testing.assert_allclose(got.params[k], v, atol=1e-5, err_msg=k)
                if "lora_" not in k or k.endswith("lora_s"):
                    assert torch.equal(got.params[k], st0.params[k]), (mode, k)
            for m in ("m", "v"):
                for k, v in st.opt_state[m].items():
                    np.testing.assert_allclose(got.opt_state[m][k], v, rtol=1e-4,
                                               atol=1e-9, err_msg=f"{mode} {m} {k}")


# ------------------------------------------------------ engine path


def _lm_batch():
    r = np.random.default_rng(0)
    ids = r.integers(0, 512, (8, 17))
    return {"input_ids": torch.from_numpy(ids[:, :-1]),
            "labels": torch.from_numpy(ids[:, 1:])}


def _engine(mesh, **cfg_kw):
    from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    model = GPT2(GPT2Config(vocab_size=512, dim=256, num_layers=2, num_heads=4,
                            max_len=64, dropout=0.0), device="cpu", seed=0)
    cfg = TrainConfig(batch_size=8, micro_batches=2, learning_rate=0.01,
                      optimizer="adamw", dtype="float32", **cfg_kw)
    return ShardedTrainer(mesh, cfg, model.as_pipeline_parts(),
                          lambda lg, b: softmax_cross_entropy(lg, b["labels"]),
                          device="cpu")


def _engine_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    res = {}
    mesh = make_mesh(MeshConfig(data=2, pipe=2), device="cpu")
    for sched in ("gpipe", "1f1b"):
        for fsdp in (False, True):
            tr = _engine(mesh, pp_schedule=sched, fsdp=fsdp)
            st = tr.init_state()
            losses = []
            for _ in range(3):
                st, m = tr.train_step(st, _lm_batch())
                losses.append(float(m["loss"]))
            res[(sched, fsdp)] = losses
            if fsdp:
                res["spec"] = tuple(tr.param_specs["stages"]["mlp"]["up"]["w"])
                res["b_spec"] = tuple(tr.param_specs["stages"]["mlp"]["up"]["b"])
                res["w"] = tuple(st.params["stages.0.mlp.up.w"].shape)
                res["m"] = tuple(st.opt_state["m"]["stages.0.mlp.up.w"].shape)
    torch.save(res, os.path.join(out_dir, f"engine_rank{rank}.pt"))


def _tp_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    tr = _engine(mesh, fsdp=True)
    st = tr.init_state()
    losses = []
    for _ in range(4):
        st, m = tr.train_step(st, _lm_batch())
        losses.append(float(m["loss"]))
    torch.save({"losses": losses, "spec": tuple(tr.param_specs["stages"]["mlp"]["up"]["w"]),
                "w": tuple(st.params["stages.0.mlp.up.w"].shape)},
               os.path.join(out_dir, f"tp_rank{rank}.pt"))


@pytest.fixture(scope="module")
def engine_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_engine")
    spawn_cpu_ranks(_engine_rank, 4, str(d), store_dir=str(d))
    return [torch.load(d / f"engine_rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_engine_fsdp_parity_with_replicated_dp(schedule, engine_results):
    for res in engine_results:
        np.testing.assert_allclose(res[(schedule, True)], res[(schedule, False)],
                                   atol=1e-5)
        # the big MLP weight carries pipe (stacking) and data (FSDP); its
        # block is a quarter of the stacked global leaf, its moments alike
        assert res["spec"][0] == "pipe" and "data" in res["spec"]
        assert "data" not in res["b_spec"]
        assert res["w"] in ((256, 512), (128, 1024)) and res["m"] == res["w"]


def test_engine_fsdp_respects_tp(tmp_path):
    spawn_cpu_ranks(_tp_rank, 4, str(tmp_path), store_dir=str(tmp_path))
    for r in range(4):
        res = torch.load(tmp_path / f"tp_rank{r}.pt")
        spec = res["spec"]
        assert spec[0] == "pipe" and "model" in spec and "data" in spec
        assert res["w"] == (128, 512)  # [256, 1024] split over data and model
        assert res["losses"][-1] < res["losses"][0]
