"""PyTorch port, models/vit.py, against the JAX package on the same
params and seeded images, f32 on the CPU.

Both packages start from the port's seeded init, carried into the JAX
tree (``nn.module.param_tree``) and back (``convert.params_from_jax``).

- ``ViTClassifier`` at ``ViTConfig.tiny()``: logits within 1e-5 and the
  cross-entropy gradient of every leaf within 1e-4 of ``jax.grad``;
  the encoder's ``last_hidden_state`` and ``pooled`` too;
- ``PatchEmbed`` in the port's module registry, rebuilt from the JAX
  module's ``config()``;
- ``vit_pipeline_parts`` through the port's ``ShardedTrainer`` at pipe 2
  (two spawned gloo ranks): the reference's own case
  (``tests/test_engine.py::test_engine_vit_classifier``: Adam at lr
  1e-3, batch 8 in 2 micro-batches, 10 steps), the losses within 1e-4
  relative of the JAX ``ShardedTrainer``'s on the virtual mesh;
- the plain attention path at ViT-B/16's 197 tokens (off the kernel
  rule, as in the reference), checked by routing alone.

This module's top level imports only torch, numpy and the port: the
spawned ranks import it to find their body.
"""

import functools
import os

import numpy as np
import pytest
import torch

from jax_reference import reference
from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from torch_ranks import spawn_cpu_ranks

LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-4
CLASSES = 4
STEPS = 10
TRAIN = dict(batch_size=8, micro_batches=2, learning_rate=1e-3,
             optimizer="adam", dtype="float32")


def _images(cfg, B, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=(B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


@functools.cache
def _jax_classifier():
    """The JAX classifier and its params: the port's seeded init carried
    into the JAX tree (``convert.state_dict_to_jax``; both packages then
    run the same numbers, and no JAX init is compiled)."""
    from tensorlink_tpu.models.vit import ViTClassifier, ViTConfig
    from tensorlink_tpu_torch.models.vit import ViTClassifier as TViTClassifier

    cfg = ViTConfig.tiny()
    tm = TViTClassifier(cfg, CLASSES, device="cpu", seed=0)
    return cfg, ViTClassifier(cfg, num_classes=CLASSES), _jax_tree(tm)


def _jax_tree(module):
    """A port module's params as the JAX package's nested tree of numpy
    leaves, ``{}`` for parameterless children (``nn.module.param_tree``)."""
    from tensorlink_tpu_torch.nn.module import param_tree

    def leaves(t):
        return ({k: leaves(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().numpy().copy())

    return leaves(param_tree(module))


def _port_classifier(params):
    from tensorlink_tpu_torch.convert import params_from_jax
    from tensorlink_tpu_torch.models.vit import ViTClassifier, ViTConfig

    m = ViTClassifier(ViTConfig.tiny(), CLASSES, device="cpu", seed=None)
    m.load_state_dict(params_from_jax(params), strict=True)
    return m


def test_classifier_logits_and_grads_match_jax():
    import jax
    import jax.numpy as jnp
    from torch.func import functional_call

    from tensorlink_tpu.train.trainer import softmax_cross_entropy as j_ce
    from tensorlink_tpu_torch.convert import state_dict_to_jax
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    cfg, jclf, jp = _jax_classifier()
    x = _images(cfg, 3, 1)
    y = np.array([0, 3, 1])
    ref = np.asarray(jax.jit(jclf.apply)(jp, jnp.asarray(x)))
    jvit = jax.jit(jclf.children["vit"].apply)(jp["vit"], jnp.asarray(x))

    def jloss(p):
        return j_ce(jclf.apply(p, jnp.asarray(x)), jnp.asarray(y))

    jg = jax.device_get(jax.jit(jax.grad(jloss))(jp))

    tm = _port_classifier(jp)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
        vit = tm.vit(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_TOL, rtol=0)
    for key in ("last_hidden_state", "pooled"):
        np.testing.assert_allclose(vit[key].numpy(), np.asarray(jvit[key]),
                                   atol=LOGIT_TOL, rtol=0)

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tm.named_parameters()}
    loss = softmax_cross_entropy(
        functional_call(tm, params, (torch.from_numpy(x),)), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(params.values()))
    ours = state_dict_to_jax(dict(zip(params, grads)))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                yield from leaves(v, name)
            else:
                yield name, np.asarray(v)

    ref_g, our_g = dict(leaves(jg)), dict(leaves(ours))
    assert sorted(ref_g) == sorted(our_g)
    assert {"vit.cls_token", "vit.pos_emb", "vit.patch.w", "head.w"} <= set(our_g)
    for name, g in ref_g.items():
        np.testing.assert_allclose(our_g[name], g, atol=GRAD_TOL, rtol=0,
                                   err_msg=name)


def test_patch_embed_rebuilds_from_the_jax_config():
    import json

    import jax
    import jax.numpy as jnp

    from tensorlink_tpu.models.vit import PatchEmbed as JPatchEmbed
    from tensorlink_tpu_torch.convert import params_from_jax
    from tensorlink_tpu_torch.models.vit import PatchEmbed
    from tensorlink_tpu_torch.nn.module import module_from_config

    jm = JPatchEmbed(16, 4, 3, 24)
    tm = module_from_config(json.loads(json.dumps(jm.config())), device="cpu")
    assert isinstance(tm, PatchEmbed) and tm.config() == jm.config()
    jp = jax.device_get(jm.init(jax.random.key(2)))
    tm.load_state_dict(params_from_jax(jp))
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply(jp, jnp.asarray(x))),
                               atol=LOGIT_TOL, rtol=0)


def test_vit_b16_attention_takes_the_plain_path(monkeypatch):
    """197 tokens are off ``_tile_ok``: "auto" attention never reaches the
    flash pair, as in the reference (its ``_kernel_path`` rule)."""
    from tensorlink_tpu_torch.models.vit import ViTConfig
    from tensorlink_tpu_torch.ops import flash

    cfg = ViTConfig.base_16()
    T = cfg.num_patches + 1
    assert T == 197 and not flash._tile_ok(T)
    monkeypatch.setattr(flash._FlashAttention, "apply",
                        lambda *a: pytest.fail("B1 reached at 197 tokens"))
    q = torch.zeros((1, T, 2, 64))
    flash.flash_attention_impl(q, q, q)


# ------------------------------------------------------------ the pipeline


def _batch():
    from tensorlink_tpu_torch.models.vit import ViTConfig

    cfg = ViTConfig.tiny()
    r = np.random.default_rng(0)
    return {"images": r.normal(size=(8, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
            "labels": r.integers(0, CLASSES, (8,))}


def _pipe_rank(rank, world, out_dir, state, batch):
    from tensorlink_tpu_torch.models.vit import ViTClassifier, ViTConfig, vit_pipeline_parts
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    mesh = make_mesh(MeshConfig(pipe=2), device="cpu")
    clf = ViTClassifier(ViTConfig.tiny(), CLASSES, device="cpu", seed=None)
    clf.load_state_dict(state)
    parts = vit_pipeline_parts(clf.vit, dict(clf.named_parameters()),
                               num_classes_head=CLASSES)
    tr = ShardedTrainer(mesh, TrainConfig(**TRAIN), parts,
                        lambda out, b: softmax_cross_entropy(out, b["labels"]),
                        device="cpu")
    st = tr.init_state()
    losses = []
    for _ in range(STEPS):
        st, stats = tr.train_step(st, batch)
        losses.append(float(stats["loss"]))
    if rank == 0:
        torch.save(losses, os.path.join(out_dir, "losses.pt"))


def _jax_pipeline_losses():
    """The reference's tests/test_engine.py::test_engine_vit_classifier,
    its losses kept."""
    import jax.numpy as jnp

    from tensorlink_tpu.config import MeshConfig as JMeshConfig
    from tensorlink_tpu.config import TrainConfig as JTrainConfig
    from tensorlink_tpu.models.vit import vit_pipeline_parts
    from tensorlink_tpu.parallel.engine import ShardedTrainer
    from tensorlink_tpu.runtime.mesh import make_mesh
    from tensorlink_tpu.train.trainer import softmax_cross_entropy

    _, clf, params = _jax_classifier()
    parts = vit_pipeline_parts(clf.children["vit"], params, num_classes_head=CLASSES)
    tr = ShardedTrainer(make_mesh(JMeshConfig(pipe=2)), JTrainConfig(**TRAIN), parts,
                        lambda logits, b: softmax_cross_entropy(logits, b["labels"]))
    st = tr.init_state()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    losses = []
    for _ in range(STEPS):
        st, m = tr.train_step(st, batch)
        losses.append(float(m["loss"]))
    return losses


def test_pipeline_parts_train_like_the_reference(tmp_path, tmp_path_factory, devices):
    from tensorlink_tpu_torch.convert import params_from_jax

    ref = reference(tmp_path_factory, "vit-pipe2-losses", _jax_pipeline_losses)
    assert ref[-1] < ref[0]
    _, _, jp = _jax_classifier()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()}
    spawn_cpu_ranks(_pipe_rank, 2, str(tmp_path), params_from_jax(jp), batch,
                    store_dir=str(tmp_path))
    losses = torch.load(tmp_path / "losses.pt")
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)
