"""PyTorch port, roles/privacy.py: the secret orthogonal rotations folded
into each stage's boundary Dense layers. The folded stages compose to
the JAX package's unfolded MLP on the same params (f32, atol 1e-4, the
reference suite's bound for a rotated product), fold/unfold round-trips
(atol 1e-5), a norm-fronted transformer stage is refused, and obfuscated
distributed SGD on a port fleet gives the losses of plain SGD on a
reference fleet (rtol 1e-3, the reference suite's bound: the rotation
commutes with SGD exactly, up to f32 rounding in the rotated products).
The rotations come from a ``torch.Generator`` seeded by the key, so
they differ from the reference's threefry rotations for the same key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import NodeConfig as JNodeConfig
from tensorlink_tpu.models.mlp import MLP as JMLP
from tensorlink_tpu.models.mlp import MLPConfig as JMLPConfig
from tensorlink_tpu.roles.registry import InMemoryRegistry as JRegistry
from tensorlink_tpu.roles.user import UserNode as JUserNode
from tensorlink_tpu.roles.validator import ValidatorNode as JValidatorNode
from tensorlink_tpu.roles.worker import WorkerNode as JWorkerNode
from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
from tensorlink_tpu_torch.nn.module import Sequential
from tensorlink_tpu_torch.nn.transformer import TransformerBlock
from tensorlink_tpu_torch.roles.privacy import ObfuscationPlan, random_orthogonal
from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
from tensorlink_tpu_torch.roles.user import UserNode, partition_sequential
from tensorlink_tpu_torch.roles.validator import ValidatorNode
from tensorlink_tpu_torch.roles.worker import WorkerNode
from tensorlink_tpu_torch.utils.trees import flatten

CFG = dict(in_dim=16, hidden_dim=32, out_dim=4, num_layers=2)
TWO_STAGES = 16 * 32 * 4 + 200


@pytest.fixture(scope="module")
def mlp():
    jm = JMLP(JMLPConfig(**CFG))
    jp = jm.init(jax.random.key(0))
    tm = MLP(MLPConfig(**CFG), device="cpu", seed=None)
    tp = params_from_jax(jax.device_get(jp["seq"]))
    return jm, jp, tm, tp


def _apply(seq, tree, x):
    return torch.func.functional_call(seq, flatten(tree), (x,))


def test_random_orthogonal_is_orthogonal():
    r = random_orthogonal(0, 32)
    np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-5)
    np.testing.assert_array_equal(r, random_orthogonal(0, 32))
    assert not np.allclose(r, random_orthogonal(1, 32))


def test_folded_stages_compose_to_reference(mlp):
    jm, jp, tm, tp = mlp
    parts = partition_sequential(tm.seq, tp, TWO_STAGES)
    assert len(parts) == 2
    plan = ObfuscationPlan.build(42, parts)
    x = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    h = torch.from_numpy(x)
    for i, (seq, sp) in enumerate(parts):
        folded = plan.fold_stage(i, seq, sp)
        wire = plan.forward_in(i, h)
        if plan.stages[i].r_in is not None:
            assert not torch.allclose(wire, h, atol=1e-3)
        with torch.no_grad():
            h = plan.forward_out(i, _apply(seq, folded, wire))
    np.testing.assert_allclose(h.numpy(), np.asarray(jm.apply(jp, jnp.asarray(x))),
                               atol=1e-4)
    folded0 = plan.fold_stage(0, *parts[0])
    assert not torch.allclose(folded0["0"]["w"], parts[0][1]["0"]["w"], atol=1e-3)
    for i, (seq, sp) in enumerate(parts):
        back = plan.unfold_stage(i, seq, plan.fold_stage(i, seq, sp))
        for k, v in flatten(sp).items():
            torch.testing.assert_close(flatten(back)[k], v, rtol=0, atol=1e-5)


def test_transformer_stage_rejected():
    blk = TransformerBlock(dim=16, num_heads=2, hidden_dim=32, device="cpu")
    seq = Sequential([blk])
    with pytest.raises(ValueError):
        ObfuscationPlan.build(0, [(seq, {"0": dict(blk.named_parameters())})])


async def _losses(kind, mlp, obfuscate):
    jm, jp, tm, tp = mlp
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    y = rng.integers(0, 4, 16)
    if kind == "ref":
        cfg = lambda r: JNodeConfig(role=r, host="127.0.0.1", port=0)  # noqa: E731
        val = JValidatorNode(cfg("validator"), registry=JRegistry())
        ws = [JWorkerNode(cfg("worker")) for _ in range(2)]
        user = JUserNode(cfg("user"))
        model, params, xin = jm.seq, jp["seq"], x

        def lg(logits, micro):
            yj = jnp.asarray(np.array_split(y, 2)[micro])

            def f(lo):
                return jnp.mean(jax.nn.logsumexp(lo, -1)
                                - jnp.take_along_axis(lo, yj[:, None], -1)[..., 0])

            val_, g = jax.value_and_grad(f)(jnp.asarray(logits))
            return float(val_), np.asarray(g)
    else:
        cfg = lambda r: NodeConfig(role=r, host="127.0.0.1", port=0)  # noqa: E731
        val = ValidatorNode(cfg("validator"), registry=InMemoryRegistry(), device="cpu")
        ws = [WorkerNode(cfg("worker"), device="cpu") for _ in range(2)]
        user = UserNode(cfg("user"))
        model, params, xin = tm.seq, tp, torch.from_numpy(x)
        yt = torch.from_numpy(y)

        def lg(logits, micro):
            lt = torch.as_tensor(logits).float().requires_grad_(True)
            loss = torch.nn.functional.cross_entropy(lt, torch.tensor_split(yt, 2)[micro])
            (g,) = torch.autograd.grad(loss, lt)
            return float(loss.detach()), g

    await val.start()
    for w in ws:
        await w.start()
        await w.connect("127.0.0.1", val.port)
    await user.start()
    vpeer = await user.connect("127.0.0.1", val.port)
    try:
        kw = {"obfuscate": True, "obfuscate_key": 42} if obfuscate else {}
        job = await user.request_job(
            model, params, vpeer, max_stage_bytes=TWO_STAGES, micro_batches=2,
            train={"optimizer": "sgd", "learning_rate": 0.05}, **kw)
        assert job.relay is (not obfuscate)
        losses = [await job.train_step(xin, lg) for _ in range(8)]
        return losses, await job.fetch_params()
    finally:
        for n in (user, val, *ws):
            await n.stop()


@pytest.mark.asyncio
async def test_obfuscated_training_matches_reference_plain(mlp):
    ref_losses, ref_params = await _losses("ref", mlp, False)
    obf_losses, obf_params = await _losses("port", mlp, True)
    np.testing.assert_allclose(obf_losses, ref_losses, rtol=1e-3)
    for tree, jtree in zip(obf_params, ref_params):
        for k, v in flatten(tree).items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(flatten(jtree)[k]), rtol=1e-3, atol=1e-4)
