"""PyTorch port, runtime/checkpoint.py: the CheckpointManager's surface
(round trip, latest step, the metadata sidecar, retention, the save
interval, async saves), bit-exact resume of a training run on the CPU,
LoRA / int8 / bf16 trees kept bit for bit, and the npz files of
``save_arrays_local`` exchanged with the JAX package both ways.

Tolerance: the port's resumed run equals its uninterrupted run bit for
bit; both are held to the JAX Trainer's five MLP steps as
``test_torch_train.py`` holds the BERT trainer (losses within 1e-4
relative, params within 1e-3 absolute with 99% within 1e-5).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from conftest import mlp_loss, toy_batch
from tensorlink_tpu.config import TrainConfig as JTrainConfig
from tensorlink_tpu.models.mlp import MLP as JMLP
from tensorlink_tpu.models.mlp import MLPConfig as JMLPConfig
from tensorlink_tpu.runtime import checkpoint as jckpt
from tensorlink_tpu.train.trainer import Trainer as JTrainer
from tensorlink_tpu_torch.config import TrainConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.bert import BertClassifier, BertConfig
from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
from tensorlink_tpu_torch.nn.lora import lora_init, lora_merge
from tensorlink_tpu_torch.ops.quant import quantize_params_int8
from tensorlink_tpu_torch.p2p.serialization import tree_flatten_arrays
from tensorlink_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    load_arrays_local,
    save_arrays_local,
)
from tensorlink_tpu_torch.train.trainer import Trainer, TrainState, softmax_cross_entropy

MLP_DIMS = dict(in_dim=16, hidden_dim=32, out_dim=4)
TCFG = dict(batch_size=64, learning_rate=1e-2, optimizer="adamw", dtype="float32")


def _mlp_loss(module, params, batch, rng):
    return softmax_cross_entropy(functional_call(module, params, (batch["x"],)),
                                 batch["y"])


def _batch():
    return {k: np.asarray(v) for k, v in toy_batch().items()}


def _mlp_trainer(params=None):
    model = MLP(MLPConfig(**MLP_DIMS), device="cpu", seed=0)
    if params is not None:
        model.load_state_dict(params)
    return Trainer(model, _mlp_loss, TrainConfig(**TCFG), device="cpu")


def _assert_states_equal(a: TrainState, b: TrainState):
    assert int(a.step) == int(b.step)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        for mom in ("m", "v"):
            assert torch.equal(a.opt_state[mom][k], b.opt_state[mom][k]), (mom, k)


def test_roundtrip_latest_step_and_metadata(tmp_path):
    tr = _mlp_trainer()
    state = tr.init_state()
    with CheckpointManager(tmp_path / "ckpt", async_save=False) as mgr:
        assert mgr.latest_step() is None and mgr.metadata() is None
        assert mgr.save(0, state, metadata={"job_id": "j1"})
        assert mgr.latest_step() == 0 and mgr.all_steps() == [0]
        restored = mgr.restore(target=state)
        assert isinstance(restored, TrainState)
        _assert_states_equal(restored, state)
        assert restored.step.dtype == torch.int32 and restored.step.dim() == 0
        meta = mgr.metadata()
        assert meta["job_id"] == "j1" and meta["step"] == 0
        # no target: host tensors nested by their dotted names
        raw = mgr.restore()
        assert torch.equal(raw["params"]["seq"]["0"]["w"], state.params["seq.0.w"])
        assert raw["step"].shape == ()
        # a sidecar naming a step that never committed reads as the latest
        mgr.save(5, state, metadata={"job_id": "j1"})
        with open(os.path.join(mgr.directory, "tlt_meta.json")) as f:
            text = f.read()
        with open(os.path.join(mgr.directory, "tlt_meta.json"), "w") as f:
            f.write(text.replace('"step": 5', '"step": 9'))
        assert mgr.metadata()["step"] == 5
        # a temporary directory is never a step
        os.makedirs(os.path.join(mgr.directory, ".tmp-7-x"))
        assert mgr.all_steps() == [0, 5]
        with pytest.raises(ValueError, match="does not match"):
            mgr.restore(target={"w": torch.zeros(2)})


def test_restore_lands_on_target_dtype():
    import tempfile

    with tempfile.TemporaryDirectory() as d, CheckpointManager(d, async_save=False) as mgr:
        mgr.save(1, {"a": torch.arange(4, dtype=torch.float32), "b": {"c": np.int8(3)}})
        out = mgr.restore(target={"a": torch.zeros(4, dtype=torch.float64),
                                  "b": {"c": np.int8(0)}})
    assert out["a"].dtype == torch.float64 and out["a"].tolist() == [0, 1, 2, 3]
    assert int(out["b"]["c"]) == 3


@pytest.fixture(scope="module")
def jax_mlp_run():
    jm = JMLP(JMLPConfig(**MLP_DIMS))
    jt = JTrainer(jm, mlp_loss, JTrainConfig(**TCFG))
    state = jt.init_state(jax.random.key(0))
    p0 = jax.device_get(state.params)
    losses = []
    for _ in range(5):
        state, st = jt.train_step(state, toy_batch(), jax.random.key(1))
        losses.append(float(st["loss"]))
    return p0, losses, jax.device_get(state.params)


def test_resume_parity_bit_exact_and_equal_to_jax(tmp_path, jax_mlp_run):
    """5 steps against 2 + save + restore + 3: bit-identical; both equal
    the JAX Trainer's 5 steps from the same params."""
    p0, jlosses, jparams = jax_mlp_run
    params = params_from_jax(p0)
    batch = _batch()
    tr = _mlp_trainer(params)
    full, losses = tr.init_state(), []
    for _ in range(5):
        full, st = tr.train_step(full, batch)
        losses.append(float(st["loss"]))

    part = tr.init_state()
    for _ in range(2):
        part, _ = tr.train_step(part, batch)
    with CheckpointManager(tmp_path / "c2", async_save=True) as mgr:
        mgr.save(2, part)
        mgr.wait_until_finished()
        fresh = _mlp_trainer()  # other weights: restore must overwrite them
        resumed = mgr.restore(target=fresh.init_state())
    _assert_states_equal(resumed, part)
    for _ in range(3):
        resumed, st = tr.train_step(resumed, batch)
    _assert_states_equal(resumed, full)
    assert float(st["loss"]) == losses[-1]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    ref = params_from_jax(jparams)
    diffs = np.concatenate([(full.params[k] - ref[k]).abs().numpy().ravel() for k in ref])
    assert diffs.max() < 1e-3 and np.quantile(diffs, 0.99) < 1e-5


def test_resume_with_dropout_draws_per_step(tmp_path):
    """Each step's dropout generator comes from (seed, step), so a resumed
    run draws the masks the uninterrupted one drew."""
    cfg = dataclasses.replace(BertConfig.tiny(), dropout=0.1)
    model = BertClassifier(cfg, 3, device="cpu", seed=0)
    lora_init(model, torch.Generator().manual_seed(1), rank=4)

    def loss(module, params, batch, rng):
        logits = functional_call(module, params, (batch["input_ids"],),
                                 {"rng": rng, "train": True})
        return softmax_cross_entropy(logits, batch["labels"])

    tr = Trainer(model, loss, TrainConfig(**{**TCFG, "learning_rate": 1e-3}),
                 device="cpu")
    r = np.random.default_rng(0)
    batch = {"input_ids": r.integers(0, 128, (4, 16)), "labels": r.integers(0, 3, (4,))}
    gen = lambda step: torch.Generator().manual_seed(1000 + step)  # noqa: E731

    def run(state, steps):
        for s in steps:
            state, _ = tr.train_step(state, batch, gen(s))
        return state

    full = run(tr.init_state(), range(4))
    with CheckpointManager(tmp_path / "d", async_save=True) as mgr:
        mgr.save(2, run(tr.init_state(), range(2)))
        mgr.wait_until_finished()
        resumed = mgr.restore(target=tr.init_state())
    _assert_states_equal(run(resumed, range(2, 4)), full)


def test_retention_interval_and_force(tmp_path):
    with CheckpointManager(tmp_path / "c4", max_to_keep=2, async_save=False) as mgr:
        for s in range(4):
            mgr.save(s, {"x": torch.full((2,), s)})
        assert mgr.all_steps() == [2, 3]
        assert not mgr.save(3, {"x": torch.zeros(2)})  # not past the latest
    with CheckpointManager(tmp_path / "c5", save_interval_steps=3,
                           max_to_keep=None, async_save=False) as mgr:
        saved = [s for s in range(7) if mgr.save(s, {"x": torch.full((2,), s)})]
        assert saved == [0, 3, 6] and mgr.all_steps() == [0, 3, 6]
        assert mgr.save(4, {"x": torch.full((2,), 40)}, force=True)
        assert mgr.save(3, {"x": torch.full((2,), 30)}, force=True)  # overwrite
        assert mgr.all_steps() == [0, 3, 4, 6]
        assert mgr.restore(step=3)["x"].tolist() == [30, 30]
        assert mgr.restore()["x"].tolist() == [6, 6]


def test_async_save_snapshots_at_save_time(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    with CheckpointManager(tmp_path / "a", async_save=True) as mgr:
        assert mgr.save(0, {"x": x, "empty": {}})
        x.add_(1.0)  # after save() returns: must not reach the checkpoint
        assert not mgr.save(0, {"x": x})  # in flight counts as saved
        mgr.wait_until_finished()
        out = mgr.restore(step=0)
    assert torch.equal(out["x"], torch.arange(1000, dtype=torch.float32))
    assert out["empty"] == {}


def test_lora_int8_and_bf16_trees_bit_exact(tmp_path):
    model = BertClassifier(BertConfig.tiny(), 3, device="cpu", dtype=torch.bfloat16)
    lora_init(model, torch.Generator().manual_seed(1), rank=4)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    lora_sd = {k: v.clone() for k, v in model.state_dict().items()}
    quantize_params_int8(lora_merge(model))
    quant_sd = model.state_dict()
    assert any(v.dtype == torch.int8 for v in quant_sd.values())
    assert any(v.dtype == torch.bfloat16 for v in lora_sd.values())
    with CheckpointManager(tmp_path / "ck", async_save=False) as mgr:
        mgr.save(0, {"lora": lora_sd, "quant": quant_sd}, force=True)
        flat = tree_flatten_arrays(mgr.restore(step=0))
    ref = tree_flatten_arrays({"lora": lora_sd, "quant": quant_sd})
    assert set(flat) == set(ref)
    for k, v in ref.items():
        got = flat[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        if v.dtype == torch.bfloat16:
            assert torch.equal(got.view(torch.int16), v.view(torch.int16)), k
        else:
            assert torch.equal(got, v), k


def _npz_tree():
    r = np.random.default_rng(0)
    return {"a": {"w": r.normal(size=(2, 3)).astype(np.float32),
                  "q": r.integers(-127, 128, (4,)).astype(np.int8)},
            "b": np.float32(2.5), "e": {}}


def test_npz_files_exchange_with_jax_package(tmp_path):
    tree = _npz_tree()
    # JAX package writes, the port reads
    jckpt.save_arrays_local(tmp_path / "j.npz", tree)
    out = load_arrays_local(tmp_path / "j.npz")
    assert out["a"]["w"].dtype == torch.float32 and out["a"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(out["a"]["w"].numpy(), tree["a"]["w"])
    np.testing.assert_array_equal(out["a"]["q"].numpy(), tree["a"]["q"])
    assert float(out["b"]) == 2.5 and out["e"] == {}
    # the port writes (tensors), the JAX package reads
    ours = {"a": {"w": torch.from_numpy(tree["a"]["w"]),
                  "q": torch.from_numpy(tree["a"]["q"])},
            "b": torch.tensor(2.5), "e": {}}
    save_arrays_local(tmp_path / "t.npz", ours)
    back = jckpt.load_arrays_local(tmp_path / "t.npz")
    assert back["a"]["q"].dtype == np.int8
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(back["a"]["q"], tree["a"]["q"])
    assert float(back["b"]) == 2.5 and back["e"] == {}
    with pytest.raises(TypeError, match="bfloat16"):
        save_arrays_local(tmp_path / "x.npz", {"w": torch.ones(2, dtype=torch.bfloat16)})


def test_save_arrays_local_writes_the_given_name(tmp_path):
    """The file lands under exactly the name given (no ".npz" appended,
    no temporary left behind), whatever the suffix."""
    for name in ("state.npz", "state.bin", "state"):
        save_arrays_local(tmp_path / name, {"w": torch.arange(3.0)})
        assert os.path.isfile(tmp_path / name)
        np.testing.assert_array_equal(load_arrays_local(tmp_path / name)["w"].numpy(),
                                      np.arange(3.0, dtype=np.float32))
    assert sorted(os.listdir(tmp_path)) == ["state", "state.bin", "state.npz"]


@dataclasses.dataclass
class _OtherState:
    weights: dict
    count: torch.Tensor


def test_checkpoint_takes_any_dataclass_state_and_needs_no_trainer(tmp_path):
    """The runtime layer does not import the trainer: a dataclass state
    saves as the dict of its fields and restores into its own type."""
    import subprocess
    import sys

    code = ("import sys, tensorlink_tpu_torch.runtime.checkpoint; "
            "assert 'tensorlink_tpu_torch.train.trainer' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    state = _OtherState(weights={"a": torch.randn(2, 3), "b": torch.ones(4, dtype=torch.int8)},
                        count=torch.tensor(7, dtype=torch.int32))
    with CheckpointManager(tmp_path, async_save=False) as mgr:
        assert mgr.save(1, state)
        assert sorted(mgr.restore()) == ["count", "weights"]
        target = _OtherState(weights={"a": torch.zeros(2, 3, dtype=torch.float64),
                                      "b": torch.zeros(4, dtype=torch.int8)},
                             count=torch.zeros((), dtype=torch.int32))
        back = mgr.restore(target=target)
    assert isinstance(back, _OtherState)
    assert back.weights["a"].dtype == torch.float64
    torch.testing.assert_close(back.weights["a"], state.weights["a"].double(), rtol=0, atol=0)
    assert torch.equal(back.weights["b"], state.weights["b"]) and int(back.count) == 7
