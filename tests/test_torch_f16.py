"""PyTorch port, f16 models: the paths that reach B1/B2's and B3's f16
forms, against the JAX package on the same params, f16 on the CPU (where
the wrappers run their plain versions, which compute in f32 as the
kernels do).

- a BERT-tiny widened to T 512 trained with ``TrainConfig(dtype=
  "float16")``: its attention at T 512 goes through ``_FlashAttention``
  (B1 forward, B2 backward), the JAX model's through the Pallas kernels in
  interpret mode; the loss within 3e-4 relative and every gradient but
  the key bias's (zero in exact arithmetic) within 1e-2 of its max |JAX|
  (f16 activations rounded at other points of two frameworks' f16
  layers); the same route in f32 lands within f16's own rounding of it;
- a tiny Llama in f16 served by the paged engine (B3's plain version for
  every chunk and decode step) against the JAX paged engine on the same
  params: the same greedy tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu import config as jconfig
from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.bert import BertClassifier as JBertClassifier
from tensorlink_tpu.models.bert import BertConfig as JBertConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.ops.flash import flash_attention_impl as j_flash_impl
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.serving import PagedContinuousBatchingEngine as JPaged
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu.train.trainer import Trainer as JTrainer
from tensorlink_tpu.train.trainer import softmax_cross_entropy as j_ce
from tensorlink_tpu_torch import config as tconfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.bert import BertClassifier, BertConfig
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.nn import attention as tattention
from tensorlink_tpu_torch.ops import flash as tflash
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import PagedContinuousBatchingEngine
from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy

T = 512  # the no-cache attention takes B1/B2 from here on
CLASSES = 3
LOSS_REL = 3e-4  # f16 against f16: 8e-5 (the f32 port against it: 5e-4)
GRAD_REL = 1e-2  # of max |JAX| a leaf: 4e-3 at worst
TCFG = dict(batch_size=2, micro_batches=1, optimizer="sgd", learning_rate=1e-2,
            grad_clip_norm=1.0)


def _batch():
    r = np.random.default_rng(3)
    am = np.ones((2, T), np.int32)
    am[1, 300:] = 0  # a padded row: the kernels' key mask
    return {"input_ids": r.integers(0, 128, (2, T)), "attention_mask": am,
            "labels": r.integers(0, CLASSES, (2,))}


def _tloss(module, params, batch, rng):
    logits = functional_call(module, params, (batch["input_ids"],),
                             {"attention_mask": batch["attention_mask"]})
    return softmax_cross_entropy(logits, batch["labels"])


def _jloss(module, params, batch, rng):
    return j_ce(module.apply(params, batch["input_ids"],
                             attention_mask=batch["attention_mask"]),
                batch["labels"])


@pytest.fixture(scope="module")
def jax_bert_f16():
    """The JAX model's params, and its loss and f32-master gradients
    through an f16 compute copy, attention on the Pallas kernels."""
    cfg = dataclasses.replace(
        JBertConfig.tiny(), dropout=0.0, max_len=T,
        attn_impl=functools.partial(j_flash_impl, interpret=True))
    jm = JBertClassifier(cfg, CLASSES)
    jp = jax.device_get(jm.init(jax.random.key(0)))
    jt = JTrainer(jm, _jloss, jconfig.TrainConfig(**TCFG, dtype="float16"))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    loss, grads = jax.value_and_grad(jt._loss_for_grad)(jp, batch, None)
    return jp, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_bert_f16_training_through_flash_matches_jax(jax_bert_f16, dtype, monkeypatch):
    jp, jloss, jgrads = jax_bert_f16
    calls = []
    real = tflash._FlashAttention.apply
    monkeypatch.setattr(tflash._FlashAttention, "apply",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    cfg = dataclasses.replace(BertConfig.tiny(), dropout=0.0, max_len=T)
    model = BertClassifier(cfg, CLASSES, device="cpu")
    trainer = Trainer(model, _tloss, tconfig.TrainConfig(**TCFG, dtype=dtype),
                      device="cpu")
    params = params_from_jax(jp, torch.float32)
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    loss, grads = trainer.loss_and_grads(params, batch)
    # every layer's attention took the kernel pair, in the compute dtype
    assert calls == [getattr(torch, dtype)] * cfg.num_layers
    assert np.isfinite(float(loss))
    if dtype == "float32":  # within the f16 JAX run's own rounding
        assert abs(float(loss) - jloss) <= 2e-3 * abs(jloss)
        return
    assert abs(float(loss) - jloss) <= LOSS_REL * abs(jloss)
    ref = params_from_jax(jgrads, torch.float32)
    assert sorted(grads) == sorted(ref)
    for n, g in grads.items():
        assert g.dtype == torch.float32, n
        if n.endswith("attn.k.b"):  # zero in exact arithmetic: a key bias
            continue  # adds one constant to a row's scores; both are noise
        scale = float(ref[n].abs().max())
        if scale == 0.0:
            assert float(g.abs().max()) == 0.0, n
            continue
        assert float((g - ref[n]).abs().max()) <= GRAD_REL * scale, n


def test_llama_f16_paged_engine_greedy_matches_jax(monkeypatch):
    seen = set()
    real = tattention.paged_decode_attention
    monkeypatch.setattr(tattention, "paged_decode_attention",
                        lambda q, k, *a, **kw: seen.add((q.dtype, k.dtype)) or real(q, k, *a, **kw))
    jm = JLlama(JLlamaConfig.tiny())
    p = jm.init(jax.random.key(0))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=32,
                   cache_dtype=jnp.float16, param_dtype=jnp.float16)
    tm = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=32,
                           cache_dtype=torch.float16,
                           param_dtype=torch.float16, device="cpu")
    r = np.random.default_rng(1)
    prompts = [r.integers(0, 128, (n,)) for n in (3, 9, 13, 6)]
    kw = {"slots": 2, "decode_chunk": 3, "block_size": 4, "prefill_chunk": 4}

    def drive(sch):
        rids = [sch.submit(x) for x in prompts]
        return [np.asarray(sch.result(rid)) for rid in rids]

    ref = drive(JPaged(jeng, gen=JGen(max_new_tokens=8), **kw))
    sch = PagedContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=8), **kw)
    out = drive(sch)
    # every paged read (prefill chunks and decode steps) was f16 over f16
    assert seen == {(torch.float16, torch.float16)}
    for o, x in zip(out, ref):
        np.testing.assert_array_equal(o, x)
