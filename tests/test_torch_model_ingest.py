"""PyTorch port, models/torch_ingest.py (``from_torch``), against the torch
module's own forward and the JAX package's ``from_torch`` on the same
module and seeded inputs, f32 on the CPU. (``tests/test_torch_ingest.py``
is the JAX package's own file.)

- an MLP, nested ``Sequential``s with both GELU forms, a
  ``MultiheadAttention`` and an ``nn.TransformerEncoder`` (post- and
  pre-LN, a final norm, a ``Linear`` head): outputs within 1e-5 of the
  torch module's and of the JAX ``from_torch``'s, with the same layer
  count and the same parameter names (the reference's tree, flattened);
- the same ``UnsupportedTorchModule`` messages and module paths;
- an ingested model survives ``config()`` -> ``module_from_config`` (the
  wire), and its tensors are copies, not the torch module's storage;
- an ingested MLP trains through the port's ``UserNode.request_job`` on a
  port fleet (two stages, two micro-batches, SGD): the loss falls, as in
  the reference's ``tests/test_torch_ingest.py`` flow.
"""

import asyncio

import numpy as np
import pytest
import torch

from tensorlink_tpu_torch.models.torch_ingest import UnsupportedTorchModule, from_torch
from tensorlink_tpu_torch.nn.module import module_from_config

tn = torch.nn
TOL = 1e-5


def _mlp():
    torch.manual_seed(0)
    return tn.Sequential(tn.Linear(16, 64), tn.ReLU(), tn.LayerNorm(64),
                         tn.Dropout(0.0), tn.Linear(64, 4), tn.Tanh())


def _nested():
    torch.manual_seed(1)
    return tn.Sequential(
        tn.Sequential(tn.Linear(8, 32), tn.GELU()),
        tn.Sequential(tn.Linear(32, 32), tn.GELU(approximate="tanh"), tn.Identity()),
        tn.Linear(32, 2), tn.SiLU(), tn.Sigmoid(),
    )


def _encoder(norm_first):
    torch.manual_seed(5)
    layer = tn.TransformerEncoderLayer(d_model=32, nhead=4, dim_feedforward=64,
                                       dropout=0.1, batch_first=True,
                                       norm_first=norm_first)
    return tn.Sequential(
        tn.TransformerEncoder(layer, num_layers=2, norm=tn.LayerNorm(32),
                              enable_nested_tensor=False),
        tn.Linear(32, 5),
    )


def _mha():
    torch.manual_seed(4)
    return tn.MultiheadAttention(32, 4, batch_first=True)


CASES = {
    "mlp": (_mlp, (8, 16), 6),
    "nested": (_nested, (4, 8), 7),  # the Identity is skipped
    "mha": (_mha, (2, 10, 32), 1),
    "encoder_post_ln": (lambda: _encoder(False), (3, 12, 32), 4),
    "encoder_pre_ln": (lambda: _encoder(True), (3, 12, 32), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_torch_and_the_jax_ingest(case):
    import jax
    import jax.numpy as jnp

    from tensorlink_tpu.models.torch_ingest import from_torch as j_from_torch
    from tensorlink_tpu_torch.convert import params_from_jax

    make, shape, n_layers = CASES[case]
    tm = make().eval()
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        ref = (tm(xt, xt, xt)[0] if case == "mha" else tm(xt)).numpy()
    native, params = from_torch(tm, device="cpu")
    assert len(native) == n_layers
    with torch.no_grad():
        out = native(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    jn, jp = j_from_torch(tm)
    j_out = np.asarray(jn.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)))
    np.testing.assert_allclose(out, j_out, atol=TOL, rtol=0)
    # the reference's param tree, flattened: the same names and values
    ref_params = params_from_jax(jax.device_get(jp))
    assert sorted(params) == sorted(ref_params)
    for k, v in ref_params.items():
        assert torch.equal(params[k], v), k
    # copies: training the ingested model leaves the torch module alone
    for p in params.values():
        assert all(p.data_ptr() != q.data_ptr() for q in tm.parameters())


def test_unsupported_modules_raise_with_path():
    with pytest.raises(UnsupportedTorchModule, match="root.1"):
        from_torch(tn.Sequential(tn.Linear(4, 4), tn.Conv2d(1, 1, 3)), device="cpu")
    with pytest.raises(UnsupportedTorchModule, match="root.0.1: Conv1d"):
        from_torch(tn.Sequential(tn.Sequential(tn.Linear(4, 4), tn.Conv1d(1, 1, 3))),
                   device="cpu")
    with pytest.raises(UnsupportedTorchModule, match="batch_first"):
        from_torch(tn.MultiheadAttention(16, 2), device="cpu")
    with pytest.raises(UnsupportedTorchModule, match="dropout"):
        from_torch(tn.MultiheadAttention(16, 2, dropout=0.2, batch_first=True),
                   device="cpu")
    with pytest.raises(UnsupportedTorchModule, match="Flatten"):
        from_torch(tn.Sequential(tn.Flatten(0)), device="cpu")
    with pytest.raises(UnsupportedTorchModule, match="root.0.layers.0|activation"):
        layer = tn.TransformerEncoderLayer(8, 2, 16, activation=torch.tanh,
                                           batch_first=True)
        from_torch(tn.Sequential(tn.TransformerEncoder(layer, 1,
                                                       enable_nested_tensor=False)),
                   device="cpu")


def test_ingested_model_survives_the_wire():
    torch.manual_seed(2)
    tm = tn.Sequential(tn.Linear(8, 16), tn.ReLU(), tn.Linear(16, 2))
    native, params = from_torch(tm, device="cpu")
    rebuilt = module_from_config(native.config(), device="cpu")
    rebuilt.load_state_dict(params, strict=True)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(rebuilt(x), native(x), atol=1e-6, rtol=0)


async def _train_on_fleet():
    from tensorlink_tpu_torch.config import NodeConfig
    from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
    from tensorlink_tpu_torch.roles.user import UserNode
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    def cfg(role):
        return NodeConfig(role=role, host="127.0.0.1", port=0)

    torch.manual_seed(3)
    tm = tn.Sequential(tn.Linear(16, 32), tn.ReLU(), tn.Linear(32, 4))
    native, params = from_torch(tm, device="cpu")
    validator = ValidatorNode(cfg("validator"), registry=InMemoryRegistry(), device="cpu")
    await validator.start()
    workers = []
    for _ in range(2):
        w = WorkerNode(cfg("worker"), device="cpu")
        await w.start()
        await w.connect("127.0.0.1", validator.port)
        workers.append(w)
    user = UserNode(cfg("user"))
    await user.start()
    v_peer = await user.connect("127.0.0.1", validator.port)
    try:
        job = await user.request_job(
            native, params, v_peer, max_stage_bytes=16 * 32 * 4 + 200,
            micro_batches=2, train={"optimizer": "sgd", "learning_rate": 0.05})
        assert len(job.stages) == 2
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 4, 16))

        def loss_grad(logits, micro):
            lt = torch.as_tensor(logits).float().requires_grad_(True)
            loss = torch.nn.functional.cross_entropy(lt, torch.tensor_split(y, 2)[micro])
            (g,) = torch.autograd.grad(loss, lt)
            return float(loss.detach()), g

        return [await job.train_step(x, loss_grad) for _ in range(8)]
    finally:
        for n in (user, validator, *workers):
            await n.stop()


def test_ingested_model_trains_on_a_port_fleet():
    losses = asyncio.run(_train_on_fleet())
    assert losses[-1] < losses[0]
