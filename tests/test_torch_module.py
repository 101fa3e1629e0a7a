"""PyTorch port, nn/module.py + nn/__init__.py's registry + models/mlp.py:
against the JAX package's modules on the same seeded inputs and on
params converted from its init, f32 on the CPU.

- every container and carry-packing module, and every registered type,
  rebuilt by ``module_from_config`` from the JAX module's ``config()``
  (through JSON, as it crosses the wire): the same type, the same config,
  and outputs within 1e-5 of the JAX module's on its params;
- the registries: every type and activation the JAX package registers
  (``PatchEmbed`` among them), the activations
  within 1e-6 (``"gelu"`` is the tanh approximation in both);
- ``MLP``'s forward (1e-5) and five Adam steps, held as
  ``test_torch_train.py`` holds the BERT trainer (losses 1e-4 relative,
  params 1e-3 absolute with 99% within 1e-5);
- ``init_module`` casts every floating parameter to the dtype.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import tensorlink_tpu.nn as jnn
import tensorlink_tpu.nn.moe  # noqa: F401  (registers MoEFeedForward)
import tensorlink_tpu_torch.nn as tnn
from conftest import mlp_loss, toy_batch
from tensorlink_tpu.config import TrainConfig as JTrainConfig
from tensorlink_tpu.models.mlp import MLP as JMLP
from tensorlink_tpu.models.mlp import MLPConfig as JMLPConfig
from tensorlink_tpu.models.vit import PatchEmbed as JPatchEmbed
from tensorlink_tpu.nn import module as jmodule
from tensorlink_tpu.nn.attention import MultiHeadAttention as JMHA
from tensorlink_tpu.nn.moe import MoEFeedForward as JMoE
from tensorlink_tpu.nn.transformer import FeedForward as JFF
from tensorlink_tpu.nn.transformer import TransformerBlock as JBlock
from tensorlink_tpu.train.trainer import Trainer as JTrainer
from tensorlink_tpu_torch.config import TrainConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
from tensorlink_tpu_torch.models.vit import PatchEmbed  # noqa: F401  (registers it)
from tensorlink_tpu_torch.nn import module as tmodule
from tensorlink_tpu_torch.nn.module import (
    Lambda,
    Sequential,
    init_module,
    module_from_config,
)
from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy

ATOL = 1e-5


def _cases():
    relu = jax.nn.relu
    return {
        "Dense": (jnn.Dense(8, 12, shard="col", init_scheme="normal"), (2, 5, 8)),
        "Embedding": (jnn.Embedding(32, 8), "ids"),
        "LayerNorm": (jnn.LayerNorm(8, eps=1e-5, use_bias=False), (2, 5, 8)),
        "RMSNorm": (jnn.RMSNorm(8, eps=1e-5), (2, 5, 8)),
        "Dropout": (jnn.Dropout(0.1), (2, 5, 8)),
        "MultiHeadAttention": (JMHA(16, 4, num_kv_heads=2, rope=True, causal=True,
                                    window=3, attn_impl="reference"), (2, 5, 16)),
        "FeedForward": (JFF(16, 32, activation="silu", gated=True), (2, 5, 16)),
        "TransformerBlock": (JBlock(16, 4, hidden_dim=32, num_kv_heads=2, norm="rms",
                                    activation="silu", use_bias=False, gated_mlp=True,
                                    causal=True, rope=True, attn_impl="reference"),
                             (2, 5, 16)),
        "TransformerBlock-moe": (JBlock(16, 4, hidden_dim=32, use_bias=False,
                                        gated_mlp=True, moe_experts=4,
                                        attn_impl="reference"), (2, 5, 16)),
        "MoEFeedForward": (JMoE(16, 32, num_experts=4, top_k=2), (2, 5, 16)),
        "AppendTail": (jmodule.AppendTail(3), (2, 5, 7)),
        "CombineTail": (jmodule.CombineTail("concat", 4, (3, 5)), (2, 5, 12)),
        "CombineTail-mul": (jmodule.CombineTail("mul", 2, (3, 3)), (2, 5, 8)),
        "Sequential": (jmodule.Sequential([jnn.Dense(8, 16), jmodule.Lambda(relu, "relu"),
                                           jnn.Dense(16, 4)]), (2, 5, 8)),
        "Parallel-add": (jmodule.Parallel([jnn.Dense(8, 4), jnn.Dense(8, 4)]), (2, 5, 8)),
        "Parallel-concat": (jmodule.Parallel([jnn.Dense(8, 4), jnn.Dense(8, 2)],
                                             combine="concat"), (2, 5, 8)),
        "TailMap": (jmodule.TailMap(jnn.Dense(5, 6), head_width=3), (2, 5, 8)),
        "Lambda": (jmodule.Lambda(jax.nn.gelu, "gelu"), (2, 5, 8)),
        "PatchEmbed": (JPatchEmbed(8, 4, 3, 16), (2, 8, 8, 3)),
    }


def _norm(cfg):
    """JSON's view of a config (tuples are lists)."""
    return json.loads(json.dumps(cfg))


def _config_matches(ours, ref):
    """Every key of the reference's config carries the same value; the
    port may add keys only with None values (e.g. MHA's ``scale``)."""
    ours, ref = _norm(ours), _norm(ref)
    for k, v in ref.items():
        if k == "__children__":
            assert set(ours[k]) == set(v), (ours.get(k), v)
            for n in v:
                _config_matches(ours[k][n], v[n])
        else:
            assert ours.get(k) == v, (k, ours.get(k), v)
    for k in set(ours) - set(ref):
        assert ours[k] is None, (k, ours[k])


def _input(shape, seed=0):
    r = np.random.default_rng(seed)
    if shape == "ids":
        return r.integers(0, 32, (2, 5))
    return r.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", list(_cases()))
def test_module_from_jax_config_rebuilds_an_equal_module(name):
    jm, shape = _cases()[name]
    cfg = _norm(jm.config())  # as it crosses the wire
    tm = module_from_config(cfg, device="cpu")
    assert type(tm).__name__ == cfg["__type__"]
    _config_matches(tm.config(), jm.config())
    # the port's own config rebuilds the same module
    assert module_from_config(tm.config(), device="cpu").config() == tm.config()
    jp = jax.device_get(jm.init(jax.random.key(5)))
    tm.load_state_dict(params_from_jax(jp), strict=True)
    x = _input(shape)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_registries_cover_the_jax_package():
    assert "PatchEmbed" in jmodule.MODULE_TYPES
    assert set(jmodule.MODULE_TYPES) <= set(tmodule.MODULE_TYPES)
    assert set(jmodule._ACTIVATION_FNS) == set(tmodule._ACTIVATION_FNS)
    x = _input((2, 3, 4), seed=1) * 3
    for name, jfn in jmodule._ACTIVATION_FNS.items():
        ref = np.asarray(jfn(jnp.asarray(x)))
        out = tmodule._ACTIVATION_FNS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0, err_msg=name)
    with pytest.raises(ValueError, match="unknown activation"):
        module_from_config({"__type__": "Lambda", "name": "nope"}, device="cpu")
    with pytest.raises(ValueError, match="unknown module type"):
        module_from_config({"__type__": "Nope"}, device="cpu")
    assert tnn.Dense is tmodule.MODULE_TYPES["Dense"]


def test_sequential_slicing_and_dropout_generator():
    seq = Sequential([tnn.Dense(8, 16, device="cpu"), Lambda(torch.relu, "relu"),
                      tnn.Dropout(0.5), tnn.Dense(16, 4, device="cpu")])
    init_module(seq, 0)
    assert len(seq) == 4 and isinstance(seq[1], Lambda)
    head = seq[:2]
    assert isinstance(head, Sequential) and len(head) == 2
    assert set(dict(seq.named_parameters())) == {"0.w", "0.b", "3.w", "3.b"}
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(head(x), torch.relu(seq[0](x)))
    a = seq(x, rng=torch.Generator().manual_seed(4), train=True)
    b = seq(x, rng=torch.Generator().manual_seed(4), train=True)
    assert torch.equal(a, b) and not torch.equal(a, seq(x))


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_mlp_forward_and_five_adam_steps_match_jax(activation):
    dims = dict(in_dim=16, hidden_dim=32, out_dim=4, num_layers=3, activation=activation)
    jm = JMLP(JMLPConfig(**dims))
    tcfg = dict(batch_size=64, learning_rate=1e-2, optimizer="adam", dtype="float32")
    jt = JTrainer(jm, mlp_loss, JTrainConfig(**tcfg))
    js = jt.init_state(jax.random.key(0))
    p0 = jax.device_get(js.params)
    model = MLP(MLPConfig(**dims), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(p0), strict=True)
    batch = toy_batch()
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(batch["x"])))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(p0, batch["x"])),
                               atol=ATOL, rtol=0)

    def loss(module, params, b, rng):
        return softmax_cross_entropy(functional_call(module, params, (b["x"],)), b["y"])

    tt = Trainer(model, loss, TrainConfig(**tcfg), device="cpu")
    ts = tt.init_state()
    jl, tl = [], []
    tb = {k: np.asarray(v) for k, v in batch.items()}
    for _ in range(5):
        js, st = jt.train_step(js, batch, jax.random.key(1))
        jl.append(float(st["loss"]))
        ts, st = tt.train_step(ts, tb)
        tl.append(float(st["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    ref = params_from_jax(jax.device_get(js.params))
    assert set(ref) == set(ts.params)
    diffs = np.concatenate([(ts.params[k] - ref[k]).abs().numpy().ravel() for k in ref])
    assert diffs.max() < 1e-3 and np.quantile(diffs, 0.99) < 1e-5


def test_init_module_casts_to_dtype():
    jm = _cases()["Sequential"][0]
    jp = jnn.init_module(jm, jax.random.key(0), dtype=jnp.bfloat16)
    tm = module_from_config(jm.config(), device="cpu")
    assert init_module(tm, torch.Generator().manual_seed(0), torch.bfloat16) is tm
    ours = {k: str(v.dtype).removeprefix("torch.") for k, v in tm.state_dict().items()}
    ref = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(x).dtype.name
           for path, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert ours == ref and set(ours.values()) == {"bfloat16"}
    assert all(torch.isfinite(p.float()).all() for p in tm.parameters())
    # "normal" init draws N(0, 0.02), "lecun" N(0, 1 / fan_in)
    d = init_module(tnn.Dense(256, 256, init_scheme="normal", device="cpu"), 0)
    assert abs(float(d.w.std()) - 0.02) < 0.002 and float(d.b.abs().sum()) == 0
    d = init_module(tnn.Dense(256, 256, device="cpu"), 0)
    assert abs(float(d.w.std()) - 256 ** -0.5) < 0.005
