"""PyTorch port, sequence parallelism (``parallel/sp.py``, the seq axis
of ``Pipeline`` / ``Pipeline1F1B`` / ``ShardedTrainer`` and
``InferenceEngine(kv_seq_shard=True)``) against the JAX package on the
same numpy inputs, f32.

Two spawned gloo jobs (bodies in ``torch_sp_ranks``), one test each,
each run on a thread while this process runs the JAX side on the
virtual CPU mesh of the same shape (one test a job, so that pytest-xdist
workers never run a job twice):

- seq 4: the ring, einsum and flash (B1/B2's plain versions), and
  Ulysses, forward and the gradients of the whole inputs, against JAX
  ``ring_attention(use_flash=True, interpret=True)`` and
  ``ulysses_attention`` (causal, GQA narrow and repeated, padding masks;
  forward within 2e-5, gradients within 1e-4, the reference's own
  tolerances); ``generate`` with ``kv_seq_shard=True`` token-identical to
  the JAX engine on the same mesh and to the port at world 1, with a
  quarter of world 1's cache bytes a rank; the refusals that need a
  bound seq group;
- pipe 2 x seq 2: one ``ShardedTrainer`` step of GPT-2 on the ring
  (GPipe and 1F1B) and BERT on Ulysses with a padded mask, the loss,
  pre-clip gradient norm and gathered params against the JAX trainer
  (``test_torch_engine``'s tolerances and key-bias rule).

In this process: B2's plain version given the whole row's delta sums
over key blocks to the whole row's gradients, while each block's own
delta does not; the wrapper's delta checks; and every refusal's type and
message against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import test_torch_engine as E
import torch_sp_ranks as R
from tensorlink_tpu.config import MeshConfig as JMeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.nn.attention import MultiHeadAttention as JMHA
from tensorlink_tpu.parallel import sp as jsp
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.runtime.mesh import make_mesh as jmake_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import LlamaConfig
from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd_lse_reference,
)
from tensorlink_tpu_torch.parallel import sp
from test_torch_tp_serving import _Job

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4

# name -> (the port's global entries to run, inputs); B 2, T 32, D 16
ATT = {
    "ring_causal": (("einsum", "flash"), R.np_case(0, 2, 32, 2, 2, 16, True, False)),
    "ring_gqa": (("einsum", "flash"), R.np_case(1, 2, 32, 4, 2, 16, True, False)),
    "ring_mask": (("einsum", "flash"), R.np_case(2, 2, 32, 2, 2, 16, True, True)),
    "ulysses_causal": (("ulysses",), R.np_case(3, 2, 32, 8, 8, 16, True, False)),
    "ulysses_mask": (("ulysses",), R.np_case(4, 2, 32, 4, 4, 16, False, True)),
    "ulysses_gqa4": (("ulysses",), R.np_case(5, 2, 32, 8, 4, 16, True, False)),
    "ulysses_gqa2": (("ulysses",), R.np_case(6, 2, 32, 8, 2, 16, True, False)),
}
RUNS = [(name, kind) for name, (kinds, _) in ATT.items() for kind in kinds]

# a prompt longer than one rank's 64 slots (a 256-slot cache over seq 4),
# so prefill and decode both write across ranks
GEN_CFG = {**dataclasses.asdict(LlamaConfig.tiny()), "max_len": 128}
GEN_T0, GEN_NEW, GEN_MAX_LEN = 70, 8, 96

TRAIN = {
    "gpt2_ring_gpipe": ("gpt2", {**E.GPT2_TINY, "attn_impl": "ring"}, {}),
    "gpt2_ring_1f1b": ("gpt2", {**E.GPT2_TINY, "attn_impl": "ring"},
                       {"pp_schedule": "1f1b"}),
    "bert_ulysses_mask": ("bert", {**E.BERT_TINY, "attn_impl": "ulysses"}, {}),
}


def _jax_attention(name: str):
    """The JAX package's output and gradients on the case's inputs."""
    _, case = ATT[name]
    mesh = jmake_mesh(JMeshConfig(seq=4))
    mask = None if case["mask"] is None else jnp.asarray(case["mask"])
    if name.startswith("ring"):
        def f(q, k, v):
            return jsp.ring_attention(q, k, v, mesh, causal=case["causal"], mask=mask,
                                      use_flash=True, interpret=True)
    else:
        def f(q, k, v):
            return jsp.ulysses_attention(q, k, v, mesh, causal=case["causal"], mask=mask)
    qkv = [jnp.asarray(case[n]) for n in "qkv"]
    w = jnp.asarray(case["q_valid"])

    def loss(*a):
        out = f(*a)
        return jnp.mean((out * w) ** 2), out

    # one program for the output and the gradients
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(*qkv)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gen_inputs():
    r = np.random.default_rng(7)
    ids = r.integers(0, 128, (2, GEN_T0))
    pad = np.ones((2, GEN_T0), np.int64)
    pad[0, :9] = 0
    ids[0, :9] = 0
    return ids, pad


def _jax_msg(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def _jax_shard_refusal(impl, q, mask):
    mesh = jmake_mesh(JMeshConfig(seq=4))
    z = jnp.zeros((1, 32, 2, 16))
    fn = jax.shard_map(lambda q_, k_, v_: impl(q_, k_, v_, mask=mask), mesh=mesh,
                       in_specs=(JP(None, "seq"),) * 3, out_specs=JP(None, "seq"),
                       axis_names=frozenset({"seq"}), check_vma=False)
    return _jax_msg(lambda: jax.jit(fn)(jnp.asarray(q), z, z))


def test_seq4_ring_ulysses_generate_and_refusals_match_jax(tmp_path, devices):
    """The seq-4 job against the JAX side computed while it runs: every
    attention run's whole output and gradients on every rank, the
    ``kv_seq_shard`` tokens and cache bytes, the group-bound refusals."""
    from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
    from torch_tp_serving_ranks import build

    jm = JLlama(JLlamaConfig(**GEN_CFG))
    jp = jax.device_get(jm.init(jax.random.key(3)))
    state = params_from_jax(jp)
    ids, pad = _gen_inputs()
    gen = {"cfg": GEN_CFG, "state": state, "ids": ids, "pad": pad,
           "max_new": GEN_NEW, "max_len": GEN_MAX_LEN}
    job = _Job(R.job_seq4, 4, tmp_path,
               {k: (kinds, case) for k, (kinds, case) in ATT.items()}, gen)
    jatt = {name: _jax_attention(name) for name in ATT}
    jeng = JEngine(jmake_mesh(JMeshConfig(seq=4)), jm, jp, max_len=GEN_MAX_LEN,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32, kv_seq_shard=True)
    jtok = np.asarray(jeng.generate(ids, JGen(max_new_tokens=GEN_NEW), pad_mask=pad))
    one = InferenceEngine(build("llama", GEN_CFG), state, max_len=GEN_MAX_LEN,
                          cache_dtype=torch.float32, param_dtype=torch.float32,
                          device="cpu")
    tok1 = one.generate(ids, GenerationConfig(max_new_tokens=GEN_NEW), pad_mask=pad)
    bytes1 = sum(c["attn"][n].numel() * c["attn"][n].element_size()
                 for c in one._gen_state["caches"] for n in ("k", "v"))
    two_heads = jnp.ones((1, 2, 1, 32), bool)
    bad = jnp.ones((1, 1, 1, 8), bool)
    z32 = np.zeros((1, 32, 2, 16), np.float32)
    jmsgs = {
        "ring_mask_heads": _jax_shard_refusal(jsp.ring_attention_impl, z32, two_heads),
        "ulysses_mask_heads": _jax_shard_refusal(
            jsp.ulysses_attention_impl, np.zeros((1, 32, 4, 16), np.float32), two_heads),
        "ulysses_heads": _jax_shard_refusal(jsp.ulysses_attention_impl, z32, None),
        "ring_global_mask": _jax_shard_refusal(jsp.ring_attention_impl, z32, bad),
        "ulysses_global_mask": _jax_shard_refusal(
            jsp.ulysses_attention_impl, np.zeros((1, 32, 4, 16), np.float32), bad),
    }
    ranks = job.results()
    for res in ranks:  # every rank holds the whole output and gradients
        for name, kind in RUNS:
            jout, jgrads = jatt[name]
            w = ATT[name][1]["q_valid"]
            got = res["attention"][(name, kind)]
            np.testing.assert_allclose(got["out"].numpy() * w, jout * w, atol=FWD_ATOL,
                                       err_msg=f"{name} {kind}")
            for g, jg in zip(got["grads"], jgrads):
                assert g.shape == jg.shape  # GQA's dk/dv come home narrow
                np.testing.assert_allclose(g.numpy(), jg, atol=GRAD_ATOL,
                                           err_msg=f"{name} {kind}")
        np.testing.assert_array_equal(res["generate"], jtok)
        assert 4 * res["cache_bytes"] == bytes1
        for what, msg in jmsgs.items():
            assert msg is not None and res["refusals"][what] == msg, what
    np.testing.assert_array_equal(tok1, jtok)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_refusals_without_a_group_match_jax(impl):
    port = {"ring": sp.ring_attention_impl, "ulysses": sp.ulysses_attention_impl}[impl]
    ref = {"ring": jsp.ring_attention_impl, "ulysses": jsp.ulysses_attention_impl}[impl]
    z, jz = torch.zeros(1, 8, 2, 16), jnp.zeros((1, 8, 2, 16))
    for kw in ({"q_offset": 3}, {"window": 4}, {"bias": 1.0}, {"scale": 0.5}):
        assert R.refused(lambda: port(z, z, z, **kw)) == _jax_msg(
            lambda: ref(jz, jz, jz, **kw))
    assert R.refused(lambda: MultiHeadAttention(32, 2, window=4, attn_impl=impl)) == \
        _jax_msg(lambda: JMHA(32, 2, window=4, attn_impl=impl))


def test_seq_sharded_trainer_matches_jax(tmp_path, devices):
    """The pipe 2 x seq 2 job (one step a case) against the JAX trainer
    on the same mesh: each case's loss, pre-clip gradient norm (every
    rank) and gathered params (rank 0), and the trainer's refusals."""
    from tensorlink_tpu.models.bert import BertClassifier, BertConfig
    from tensorlink_tpu.models.gpt2 import GPT2, GPT2Config

    cases = {}
    for name, (kind, mcfg, cfg_kw) in TRAIN.items():
        # _jax_run's init, so the job starts before the JAX steps run
        model = (BertClassifier(BertConfig(**mcfg), num_classes=3) if kind == "bert"
                 else GPT2(GPT2Config(**mcfg)))
        init = jax.device_get(model.init(jax.random.key(0)))
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in E._batch(kind).items()}
        cases[name] = (kind, mcfg, params_from_jax(init), batch, cfg_kw)
    job = _Job(R.job_trainers, 4, tmp_path, cases, 1)
    jruns = {}
    for name, (kind, mcfg, cfg_kw) in TRAIN.items():
        _, (losses, norms), params, *_ = E._jax_run(
            kind, mcfg, dict(pipe=2, seq=2), cfg_kw, False, E._batch(kind), steps=1)
        jruns[name] = (losses, norms, params)
    jmsgs = _jax_trainer_refusals()
    ranks = job.results()
    for case, (j_losses, j_norms, j_params) in jruns.items():
        for res in ranks:  # every rank reports the same loss and norm
            np.testing.assert_allclose(res[case]["losses"], j_losses, rtol=E.LOSS_RTOL)
            np.testing.assert_allclose(res[case]["grad_norms"], j_norms,
                                       rtol=E.LOSS_RTOL)
        E._assert_state(ranks[0][case]["params"], j_params, case, key_bias=False)
    for what, msg in jmsgs.items():
        assert msg is not None
        for res in ranks:
            assert res["refusals"][what] == msg, what


def _jax_trainer_refusals() -> dict:
    from tensorlink_tpu.config import TrainConfig as JTrainConfig
    from tensorlink_tpu.models.bert import BertClassifier, BertConfig, bert_pipeline_parts
    from tensorlink_tpu.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu.parallel.engine import ShardedTrainer

    mesh = jmake_mesh(JMeshConfig(pipe=2, seq=2))
    g = GPT2(GPT2Config(**E.GPT2_TINY))
    gparts = g.as_pipeline_parts(g.init(jax.random.key(0)))
    b = BertClassifier(BertConfig(**{**E.BERT_TINY, "attn_impl": "ulysses"}),
                       num_classes=3)
    bparts = bert_pipeline_parts(b.children["bert"], b.init(jax.random.key(0)),
                                 num_classes_head=3)
    loss = lambda out, bt: out.mean()  # noqa: E731 - never called
    return {
        "needs_ring": _jax_msg(lambda: ShardedTrainer(
            mesh, JTrainConfig(**E._train_cfg({})), gparts, loss)),
        "head_per_token": _jax_msg(lambda: ShardedTrainer(
            mesh, JTrainConfig(**E._train_cfg({"pp_schedule": "1f1b"})), bparts, loss)),
    }


def _b2_inputs(seed: int = 0):
    r = np.random.default_rng(seed)
    B, H, Hkv, T, D = 2, 4, 2, 16, 16
    q, do = (torch.from_numpy(r.standard_normal((B, H, T, D), np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(r.standard_normal((B, Hkv, 2 * T, D), np.float32))
            for _ in range(2))
    kv = torch.ones(B, 2 * T, dtype=torch.bool)
    kv[1, -5:] = False
    return q, k, v, do, kv


@pytest.mark.parametrize("given", [True, False])
def test_b2_given_delta_sums_to_the_whole_row(given):
    """A row's keys in two blocks, each block's B2 call against the whole
    row's (o, lse): with ``delta`` = rowsum(do * o) the blocks' dq sum to
    the whole call's and each block's dk, dv are the whole call's slice;
    each block's own delta (a partial row sum) misses dq by far more."""
    q, k, v, do, kv = _b2_inputs()
    T = q.shape[2]
    o, lse = flash_attention_fwd_lse_reference(q, k, v, kv)
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do, kv)
    delta = (do * o).sum(-1) if given else None
    parts = [flash_attention_bwd(q, k[:, :, j * T:(j + 1) * T], v[:, :, j * T:(j + 1) * T],
                                 o, lse, do, kv[:, j * T:(j + 1) * T], delta=delta)
             for j in range(2)]
    err = (parts[0][0] + parts[1][0] - dq).abs().max().item()
    if not given:
        assert err > 1e-2
        return
    assert err < 1e-5
    for j, (_, dkj, dvj) in enumerate(parts):
        np.testing.assert_allclose(dkj, dk[:, :, j * T:(j + 1) * T], atol=1e-5)
        np.testing.assert_allclose(dvj, dv[:, :, j * T:(j + 1) * T], atol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_b2_refuses_a_malformed_delta(bad):
    q, k, v, do, kv = _b2_inputs()
    o, lse = flash_attention_fwd_lse_reference(q, k, v, kv)
    delta = (do * o).sum(-1)
    delta = delta[:, :, :-1] if bad == "shape" else delta.double()
    with pytest.raises(ValueError, match="delta"):
        flash_attention_bwd(q, k, v, o, lse, do, kv, delta=delta)
