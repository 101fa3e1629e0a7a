"""PyTorch port, disaggregated prefill/decode on the paged engine
(``prefill_export`` / ``import_prefill`` over ``parallel/kvwire.py``),
held against the JAX package's engines on the same prompts and params
(tiny Llama, f32, params through ``convert.py``): the engine-level cases
of the reference's ``tests/test_disagg.py``.

- an export -> wire -> import round trip decodes the JAX colocated
  tokens, within the port and across the packages both ways;
- an export taken while other rows decode (``pipeline_depth`` 0, 1, 2)
  equals, byte for byte, the same export taken alone: the held row stays
  off on the device;
- no contiguous cache is built on either leg; the prefix registers on
  the decode leg; n-gram speculation on the decode leg; draft
  speculation raises ``NotImplementedError``;
- typed back-pressure, refused geometry and digest, a corrupt blob;
- int8 pools natively and across forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel import serving as jserving
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.kvwire import pack_kv_payload as jpack
from tensorlink_tpu.parallel.kvwire import unpack_kv_payload as junpack
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.kvwire import (
    KV_WIRE_INT8_SCHEMA,
    flatten_kv_payload,
    pack_kv_payload,
    unpack_kv_payload,
)
from tensorlink_tpu_torch.parallel.serving import (
    OverloadedError,
    PagedContinuousBatchingEngine,
    PoolOverloadedError,
    SpecConfig,
)


@pytest.fixture(scope="module")
def engines():
    jm = JLlama(JLlamaConfig.tiny())
    p = jm.init(jax.random.key(0))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=32,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    tm = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=32,
                           cache_dtype=torch.float32, param_dtype=torch.float32,
                           device="cpu")
    return jeng, teng


def _kw(kw):
    kw.setdefault("slots", 2)
    kw.setdefault("decode_chunk", 3)
    kw.setdefault("block_size", 4)
    return kw


def _paged(engines, **kw):
    return PagedContinuousBatchingEngine(
        engines[1], gen=GenerationConfig(max_new_tokens=6), **_kw(kw))


def _jpaged(engines, **kw):
    return jserving.PagedContinuousBatchingEngine(
        engines[0], gen=JGen(max_new_tokens=6), **_kw(kw))


def _prompts(lengths, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 128, (n,)) for n in lengths]


def _jcolo(engines, prompts, **kw):
    colo = _jpaged(engines, **kw)
    return [np.asarray(colo.result(colo.submit(p))) for p in prompts]


def _blocks(payload):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in payload["layers"]]


# ------------------------------------------------- engine-level loopback


@pytest.mark.parametrize("depth", [0, 2])
def test_export_wire_import_decodes_the_jax_colocated_tokens(engines, depth):
    prompts = _prompts((5, 9, 3, 12))
    refs = _jcolo(engines, prompts)
    A, B = _paged(engines, pipeline_depth=depth), _paged(engines, pipeline_depth=depth)
    for p, ref in zip(prompts, refs):
        blob = pack_kv_payload(A.prefill_export(p))
        assert len(blob) > 0
        rid = B.import_prefill(unpack_kv_payload(blob), wire_bytes=len(blob))
        np.testing.assert_array_equal(B.result(rid), ref)
    st_a, st_b = A.stats()["disagg"], B.stats()["disagg"]
    assert st_a["exports"] == st_b["imports"] == len(prompts)
    assert st_a["export_tokens"] == st_b["import_tokens"] == sum(map(len, prompts))
    assert st_a["export_blocks"] == st_b["import_blocks"] == sum(-(-len(p) // 4) for p in prompts)
    assert A.pool.in_use == 0 and A.pool.stats()["blocks_cached"] > 0


def test_payload_and_blob_equal_the_jax_export(engines):
    """The same prompt exported by both engines: the same scalars, the
    same prefix digest, blocks equal to f32 rounding, and the same blob
    layout (the manifests agree)."""
    p = _prompts((10,), seed=5)[0]
    jp = _jpaged(engines).prefill_export(p)
    tp = _paged(engines).prefill_export(p)
    for key in ("n_valid", "tok0", "seed", "remaining", "block_size", "prefix_digest"):
        assert tp[key] == jp[key], key
    np.testing.assert_array_equal(np.asarray(tp["prompt_ids"]), jp["prompt_ids"])
    for tl, jl in zip(_blocks(tp), jp["layers"]):
        for kv in ("k", "v"):
            # only the prompt's slots; the tail slot's pad writes differ
            got = tl[kv].reshape(-1, *tl[kv].shape[2:])[:10]
            want = np.asarray(jl[kv]).reshape(-1, *tl[kv].shape[2:])[:10]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert len(pack_kv_payload(tp, codec="none")) == len(jpack(jp, codec="none"))


def test_cross_package_round_trips(engines):
    """JAX prefill -> JAX blob -> port decode, and port prefill -> port
    blob -> JAX decode: both emit the JAX colocated tokens."""
    prompts = _prompts((7, 11), seed=1)
    refs = _jcolo(engines, prompts)
    JA, JB = _jpaged(engines), _jpaged(engines)
    A, B = _paged(engines), _paged(engines)
    for p, ref in zip(prompts, refs):
        blob = jpack(JA.prefill_export(p))
        rid = B.import_prefill(unpack_kv_payload(blob))
        np.testing.assert_array_equal(B.result(rid), ref)
        blob = pack_kv_payload(A.prefill_export(p))
        jrid = JB.import_prefill(junpack(blob))
        np.testing.assert_array_equal(np.asarray(JB.result(jrid)), ref)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_export_under_concurrent_decode_equals_export_alone(engines, depth):
    """Rows decode (chunks in flight at ``pipeline_depth``) while a held
    request prefills and exports: its blocks, token and scalars equal an
    export of the same prompt on an idle engine, byte for byte. The
    prompt's length (10) leaves its last block partly empty, where a
    decode write of the held row would land."""
    target, *others = _prompts((10, 6, 5), seed=9)
    alone = _paged(engines, slots=3, pipeline_depth=depth).prefill_export(target)
    busy = _paged(engines, slots=3, pipeline_depth=depth)
    rids = [busy.submit(p, max_new=20) for p in others]
    for _ in range(3):
        busy.step()
    assert busy._inflight or depth == 0
    payload = busy.prefill_export(target)
    for key in ("n_valid", "tok0", "seed", "remaining", "block_size", "prefix_digest"):
        assert payload[key] == alone[key]
    for got, want in zip(_blocks(payload), _blocks(alone)):
        for name in want:
            assert got[name].tobytes() == want[name].tobytes(), name
    busy.run_until_idle()
    solo = _paged(engines, slots=3, pipeline_depth=depth)
    for p, rid in zip(others, rids):
        np.testing.assert_array_equal(busy.result(rid),
                                      solo.result(solo.submit(p, max_new=20)))


def test_transfer_never_materializes_contiguous_cache(engines):
    """Every layer ships [n_blocks, block_size, Hkv, D] and neither leg
    builds a contiguous cache: ``init_caches`` is poisoned for the whole
    round trip."""
    prompt = _prompts((9,))[0]
    ref = _jcolo(engines, [prompt])[0]
    A, B = _paged(engines), _paged(engines)

    def boom(*a, **kw):
        raise AssertionError("contiguous cache materialized on a leg")

    orig = Llama.init_caches
    Llama.init_caches = boom
    try:
        payload = A.prefill_export(prompt)
        for layer in payload["layers"]:
            for kv in ("k", "v"):
                assert tuple(layer[kv].shape[:2]) == (-(-len(prompt) // 4), 4)
        out = B.result(B.import_prefill(unpack_kv_payload(pack_kv_payload(payload))))
    finally:
        Llama.init_caches = orig
    np.testing.assert_array_equal(out, ref)


def test_import_registers_prefix_on_decode_leg(engines):
    prompt = _prompts((9,))[0]
    A, B = _paged(engines), _paged(engines)
    B.result(B.import_prefill(unpack_kv_payload(pack_kv_payload(A.prefill_export(prompt)))))
    base = B.prefilled_tokens
    B.result(B.submit(prompt))
    assert B.prefilled_tokens - base < len(prompt)
    assert B.prefix_hit_rate() > 0
    before = A.prefix_matched_tokens
    A.prefill_export(prompt)
    assert A.prefix_matched_tokens > before


def test_export_import_with_ngram_speculation(engines):
    prompt = np.concatenate([_prompts((6,))[0]] * 3)
    ref = _jcolo(engines, [prompt])[0]
    spec = dict(speculative=SpecConfig(k=2, rounds=1, adaptive=False))
    A, B = _paged(engines, **spec), _paged(engines, **spec)
    rid = B.import_prefill(unpack_kv_payload(pack_kv_payload(A.prefill_export(prompt))))
    np.testing.assert_array_equal(B.result(rid), ref)
    assert B.stats()["spec"]["weight_passes"] > 0


def test_draft_speculation_refuses_disaggregation(engines):
    A = _paged(engines)
    payload = A.prefill_export(_prompts((5,))[0])
    D = _paged(engines, draft=engines[1], speculative=SpecConfig(k=2, rounds=1))
    with pytest.raises(NotImplementedError, match="draft"):
        D.prefill_export(_prompts((5,))[0])
    with pytest.raises(NotImplementedError, match="draft"):
        D.import_prefill(payload)


def test_import_typed_backpressure_and_validation(engines):
    prompts = _prompts((9, 9, 9))
    A = _paged(engines)
    payload = A.prefill_export(prompts[0])
    B = _paged(engines)
    with pytest.raises(ValueError, match="block_size"):
        B.import_prefill(dict(payload, block_size=8))
    tampered = dict(payload, prompt_ids=payload["prompt_ids"].clone())
    tampered["prompt_ids"][0] ^= 1
    with pytest.raises(ValueError, match="digest"):
        B.import_prefill(tampered)
    short = dict(payload, layers=payload["layers"][:1])
    with pytest.raises(ValueError, match="layers"):
        B.import_prefill(short)
    small = _paged(engines, slots=1)
    p1, p2 = A.prefill_export(prompts[1]), A.prefill_export(prompts[2])
    small.import_prefill(p1)
    with pytest.raises(OverloadedError) as ei:
        small.import_prefill(p2)
    assert ei.value.retry_after_s is not None and ei.value.reason == "no_decode_slot"
    tight = _paged(engines, slots=2, num_blocks=5)
    tight.import_prefill(p1)  # 3 of 5 blocks live
    with pytest.raises(PoolOverloadedError) as ei2:
        tight.import_prefill(p2)
    assert ei2.value.retry_after_s is not None
    assert tight.stats()["admission"]["shed_total"] == 1


def test_corrupt_wire_blob_rejected(engines):
    A = _paged(engines)
    blob = bytearray(pack_kv_payload(A.prefill_export(_prompts((7,))[0]), codec="none"))
    blob[-3] ^= 0xFF
    with pytest.raises(ValueError, match="CRC-32C"):
        unpack_kv_payload(bytes(blob))


# --------------------------------------------------------------- int8


def test_int8_export_wire_import_decodes_the_jax_int8_tokens(engines):
    prompts = _prompts((5, 9, 3, 12))
    refs = _jcolo(engines, prompts, kv_quant="int8")
    A, B = _paged(engines, kv_quant="int8"), _paged(engines, kv_quant="int8")
    F = _paged(engines)
    for p, ref in zip(prompts, refs):
        payload = A.prefill_export(p)
        assert payload["kv_quant"] == "int8"
        assert payload["layers"][0]["k"].dtype == torch.int8
        assert payload["layers"][0]["k_scale"].dtype == torch.float32
        assert int(flatten_kv_payload(payload)["schema"]) == KV_WIRE_INT8_SCHEMA
        blob = pack_kv_payload(payload)
        assert len(blob) < 0.75 * len(pack_kv_payload(F.prefill_export(p)))
        np.testing.assert_array_equal(B.result(B.import_prefill(unpack_kv_payload(blob))), ref)


def test_cross_form_import_float_to_int8_and_back(engines):
    prompt = _prompts((9,), seed=3)[0]
    q_ref = _jcolo(engines, [prompt], kv_quant="int8")[0]
    F, Q = _paged(engines), _paged(engines, kv_quant="int8")
    rid = Q.import_prefill(unpack_kv_payload(pack_kv_payload(F.prefill_export(prompt))))
    np.testing.assert_array_equal(Q.result(rid), q_ref)
    # int8 -> float: the right reference is the JAX float engine
    # importing the same quantized prefix
    blob = pack_kv_payload(_paged(engines, kv_quant="int8").prefill_export(prompt))
    F1 = _paged(engines)
    JF = _jpaged(engines)
    out = F1.result(F1.import_prefill(unpack_kv_payload(blob)))
    jout = np.asarray(JF.result(JF.import_prefill(junpack(blob))))
    np.testing.assert_array_equal(out, jout)
