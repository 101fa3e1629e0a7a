"""PyTorch port, models/bert.py + the training half of nn/: against the
JAX package on the same params (converted from its init) and inputs, f32
on the CPU.

- BERT-tiny logits and pooled output, dropout off, under
  attn_impl="reference" and "flash" (the port's flash Function, whose
  CPU path is the plain B1/B2): atol 1e-5;
- the post-LN ``TransformerBlock`` alone (atol 1e-5), and its gradients
  through "flash" against "reference" within the port (1e-5);
- ``Dropout``: keep rate within a binomial bound, survivors scaled by
  1/keep, identity when not training or without a generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu.models.bert import BertClassifier as JBertClassifier
from tensorlink_tpu.models.bert import BertConfig as JBertConfig
from tensorlink_tpu.nn.transformer import TransformerBlock as JBlock
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.bert import BertClassifier, BertConfig
from tensorlink_tpu_torch.nn.layers import Dropout
from tensorlink_tpu_torch.nn.transformer import TransformerBlock

ATOL = 1e-5


def _batch(B=4, T=64, seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 128, (B, T))
    am = np.ones((B, T), np.int32)
    am[1, 40:] = 0
    am[2, 5:] = 0
    return ids, am


@pytest.fixture(scope="module")
def jax_bert():
    cfg = dataclasses.replace(JBertConfig.tiny(), dropout=0.0)
    model = JBertClassifier(cfg, num_classes=3)
    return model, jax.device_get(model.init(jax.random.key(0)))


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_bert_logits_and_pooled_match_jax(jax_bert, impl):
    jm, jp = jax_bert
    cfg = dataclasses.replace(BertConfig.tiny(), dropout=0.0, attn_impl=impl)
    tm = BertClassifier(cfg, 3, device="cpu")
    tm.load_state_dict(params_from_jax(jp, torch.float32), strict=True)
    ids, am = _batch()
    ref_logits = np.asarray(jm.apply(jp, jnp.asarray(ids),
                                     attention_mask=jnp.asarray(am)))
    ref = jm.children["bert"].apply(jp["bert"], jnp.asarray(ids),
                                    attention_mask=jnp.asarray(am))
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(am))
        out = tm.bert(torch.from_numpy(ids), attention_mask=torch.from_numpy(am))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["pooled"].numpy(), np.asarray(ref["pooled"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               np.asarray(ref["last_hidden_state"]),
                               atol=ATOL, rtol=0)


def _post_block(impl):
    kw = dict(dim=32, num_heads=2, hidden_dim=64, norm_style="post",
              norm="layer", norm_eps=1e-12, activation="gelu_exact",
              use_bias=True)
    jb = JBlock(**kw, dropout=0.0, attn_impl="reference")
    jp = jax.device_get(jb.init(jax.random.key(5)))
    r = np.random.default_rng(6)
    # nonzero biases and norm affine, so every parameter shows
    jp = jax.tree.map(lambda a: a + 0.1 * r.standard_normal(a.shape).astype(a.dtype), jp)
    tb = TransformerBlock(**kw, dropout=0.0, attn_impl=impl, device="cpu")
    tb.load_state_dict(params_from_jax(jp, torch.float32), strict=True)
    return jb, jp, tb


def test_post_ln_block_matches_jax():
    jb, jp, tb = _post_block("reference")
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 1, 1, 16), bool)
    mask[1, ..., 10:] = False
    ref = np.asarray(jb.apply(jp, jnp.asarray(x), mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = tb(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_post_ln_block_grads_flash_vs_reference():
    """Gradients of every block parameter and of the input through the
    flash Function (plain B1/B2 on the CPU) equal autograd through the
    reference attention."""
    _, jp, ref_blk = _post_block("reference")
    _, _, flash_blk = _post_block("flash")
    r = np.random.default_rng(8)
    x0 = torch.from_numpy(r.standard_normal((2, 64, 32)).astype(np.float32))
    mask = torch.ones((2, 1, 1, 64), dtype=torch.bool)
    mask[1, ..., 33:] = False
    w = torch.from_numpy(r.standard_normal((2, 64, 32)).astype(np.float32))
    grads = []
    for blk in (ref_blk, flash_blk):
        params = {k: p.detach().clone().requires_grad_(True)
                  for k, p in blk.named_parameters()}
        x = x0.clone().requires_grad_(True)
        out = functional_call(blk, params, (x,), {"mask": mask})
        (out * w).sum().backward()
        grads.append({"x": x.grad, **{k: p.grad for k, p in params.items()}})
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(),
                                   atol=ATOL, rtol=ATOL, err_msg=k)


def test_dropout_statistics():
    rate, n = 0.1, 200_000
    drop = Dropout(rate)
    x = torch.full((n,), 3.0)
    g = torch.Generator().manual_seed(0)
    y = drop(x, rng=g, train=True)
    keep = 1.0 - rate
    kept = y != 0
    # binomial: 5 standard deviations around n * keep
    sd = (n * keep * rate) ** 0.5
    assert abs(int(kept.sum()) - n * keep) < 5 * sd
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / keep))
    # identity when not training, or without a generator
    assert drop(x, rng=g, train=False) is x
    assert drop(x, train=True) is x
    assert Dropout(0.0)(x, rng=g, train=True) is x
    # a seeded generator reproduces its mask
    y2 = drop(x, rng=torch.Generator().manual_seed(0), train=True)
    assert torch.equal(y, y2)
