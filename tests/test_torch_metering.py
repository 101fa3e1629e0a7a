"""PyTorch port, metering and receipts (``runtime/ledger.py``,
``p2p/crypto.py``, ``runtime/profiling.py`` and the engines' meters):

- the reference's receipt cases (``tests/test_ledger.py``, the
  non-async ones) against the port's ledger and crypto copies, with a
  real RSA identity and with the dev fallback a host without
  ``cryptography`` runs;
- the port's ``DispatchTimer`` under a fake clock and fake probes gives
  the JAX ``DispatchTimer``'s ``snapshot()`` for the same sequence;
- on the same script the port's and the JAX engines' meters agree on
  rid, tenant, kind, prompt and emitted tokens and wire bytes, every
  dispatch bills some request, and preemption moves KV block-seconds at
  the reference's points;
- ``program_cost`` equals hand arithmetic for a decode chunk and a
  prefill chunk."""

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
from tensorlink_tpu.runtime.profiling import DispatchTimer as JTimer
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.p2p import crypto
from tensorlink_tpu_torch.p2p.crypto import Identity
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.kvwire import pack_kv_payload, unpack_kv_payload
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from tensorlink_tpu_torch.runtime import profiling
from tensorlink_tpu_torch.runtime.ledger import (
    ANOMALY_REASONS,
    RECEIPT_SCHEMA,
    ReceiptAuditor,
    build_receipt,
    canonical_receipt_bytes,
    sanitize_receipt,
    sanitize_receipt_obs,
    verify_receipt,
)


def _meter(**kw):
    base = dict(
        rid=1, tenant="acme", kind="serve", t_start=100.0, t_end=102.0,
        prompt_tokens=7, emitted_tokens=6, busy_s=0.5, flops=1e9,
        hbm_bytes=1e8, kv_block_s=3.0, wire_bytes=128,
    )
    base.update(kw)
    return base


@pytest.fixture(params=["rsa", "dev"])
def ident(request, monkeypatch):
    """A real RSA identity, or the dev fallback (``cryptography`` absent:
    the whole test then runs without it)."""
    if request.param == "dev":
        monkeypatch.setattr(crypto, "HAVE_CRYPTOGRAPHY", False)
    else:
        assert crypto.HAVE_CRYPTOGRAPHY
    return Identity.generate()


# -------------------------------------------------------- signing layer


def test_canonical_bytes_stable_and_sig_excluded(ident):
    r = build_receipt(_meter(), ident)
    b1 = canonical_receipt_bytes(r)
    assert canonical_receipt_bytes(dict(sorted(r.items(), reverse=True))) == b1
    assert canonical_receipt_bytes({**r, "sig": "00"}) == b1
    ok, why = verify_receipt(r)
    assert ok, why


@pytest.mark.parametrize("field,forged", [
    ("emitted_tokens", 10**6), ("busy_s", 0.0001), ("tenant", "mallory"),
    ("rid", 999),
])
def test_tampering_any_field_breaks_verification(ident, field, forged):
    r = build_receipt(_meter(), ident)
    ok, why = verify_receipt(dict(r, **{field: forged}))
    assert not ok and why == "bad_signature"


def test_receipt_cannot_be_reassigned_to_another_worker(ident):
    other = Identity.generate()
    r = build_receipt(_meter(), ident)
    stolen = dict(r, pub=other.public_der.hex())
    stolen["sig"] = other.sign(canonical_receipt_bytes(stolen)).hex()
    ok, why = verify_receipt(stolen)
    assert not ok and why == "bad_signature"


def test_dev_identity_refused_by_a_real_verifier(monkeypatch):
    monkeypatch.setattr(crypto, "HAVE_CRYPTOGRAPHY", False)
    r = build_receipt(_meter(), Identity.generate())
    assert verify_receipt(r) == (True, "")
    monkeypatch.setattr(crypto, "HAVE_CRYPTOGRAPHY", True)
    assert verify_receipt(r) == (False, "bad_signature")


def test_sanitize_receipt_rejects_off_contract(ident):
    good = build_receipt(_meter(), ident)
    assert sanitize_receipt(good)["rid"] == 1
    for mutant in (
        42, None, [],
        {k: v for k, v in good.items() if k != "rid"},
        dict(good, emitted_tokens=True),
        dict(good, busy_s=float("nan")),
        dict(good, prompt_tokens=-1),
        dict(good, worker="x"),
        dict(good, schema=99),
    ):
        with pytest.raises(ValueError):
            sanitize_receipt(mutant)
    with pytest.raises(ValueError):
        sanitize_receipt_obs({"worker": "w" * 16, "rid": -1, "tokens": 3})


# -------------------------------------------------------- auditor rules


def _auditor(**kw):
    kw.setdefault("capability_for", {}.get)
    return ReceiptAuditor(**kw)


def test_auditor_rejects_forged_signature(ident):
    aud = _auditor()
    out = aud.ingest(dict(build_receipt(_meter(), ident), emitted_tokens=999))
    assert out == {"accepted": False, "anomalies": ["bad_signature"]}
    assert aud.rejected_total == 1 and not aud.tenants


def test_auditor_flags_overclaim_beyond_wall_and_roofline(ident):
    aud = _auditor()
    r = build_receipt(_meter(t_start=100.0, t_end=100.5, busy_s=5.0), ident)
    out = aud.ingest(r)
    assert out["accepted"] and out["anomalies"] == ["overclaim"]
    cap = {ident.node_id: {"peak_tflops": 1.0, "hbm_gbps": 1000.0}}
    aud2 = _auditor(capability_for=cap.get)
    r2 = build_receipt(_meter(rid=2, busy_s=1.0, t_end=102.0, flops=5e12), ident)
    assert aud2.ingest(r2)["anomalies"] == ["overclaim"]
    r3 = build_receipt(_meter(rid=3, busy_s=1.0, t_end=102.0, flops=1e12), ident)
    assert aud2.ingest(r3)["anomalies"] == []


def test_replay_is_idempotent_but_double_bill_is_fraud(ident):
    aud = _auditor()
    r = build_receipt(_meter(), ident)
    assert aud.ingest(r)["accepted"]
    assert aud.ingest(r) == {"accepted": False, "anomalies": [], "duplicate": True}
    assert aud.tenants["acme"]["emitted_tokens"] == 6
    r2 = build_receipt(_meter(emitted_tokens=9, t_end=103.0), ident)
    assert aud.ingest(r2) == {"accepted": False, "anomalies": ["double_bill"]}
    assert aud.tenants["acme"]["emitted_tokens"] == 6
    assert aud.anomaly_counts["double_bill"] == 1


def test_token_mismatch_against_user_observation(ident):
    obs = {"worker": ident.node_id, "rid": 1, "tenant": "acme", "tokens": 2}
    aud = _auditor()
    aud.ingest(build_receipt(_meter(), ident))
    aud.observe(obs)
    assert aud.anomaly_counts["token_mismatch"] == 1
    aud2 = _auditor()
    aud2.observe(obs)
    assert "token_mismatch" in aud2.ingest(build_receipt(_meter(), ident))["anomalies"]
    aud3 = _auditor()
    aud3.ingest(build_receipt(_meter(), ident))
    aud3.observe(dict(obs, tokens=6))
    assert aud3.anomaly_counts["token_mismatch"] == 0
    assert aud3.tenants["acme"]["observed_tokens"] == 6


def test_anomaly_hook_and_vocabulary(ident):
    hits = []
    aud = _auditor(on_anomaly=lambda w, why: hits.append((w, why)))
    aud.ingest(dict(build_receipt(_meter(), ident), busy_s=1e6))
    aud.ingest("garbage")
    assert [h[1] for h in hits] == ["bad_signature", "bad_schema"]
    assert all(why in ANOMALY_REASONS for _, why in hits)


def test_snapshot_shape_and_bounds(ident):
    aud = ReceiptAuditor(capability_for={}.get, max_rids=2, max_keys=2)
    for rid in range(4):
        aud.ingest(build_receipt(_meter(rid=rid, tenant=f"t{rid}"), ident))
    snap = aud.snapshot()
    assert snap["schema"] == RECEIPT_SCHEMA
    assert snap["accepted_total"] == 4
    assert len(snap["tenants"]) <= 3 and "overflow" in snap["tenants"]


# ------------------------------------------------------- dispatch timer


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Probe:
    def __init__(self):
        self.ready = False

    def is_ready(self):
        return self.ready


def test_dispatch_timer_snapshot_equals_the_reference():
    """The same script of dispatches, polls, drains and token counts
    through both timers under one fake clock: equal snapshots, and equal
    per-dispatch busy seconds. It crosses ``MAX_PROGRAMS`` names."""
    clock = _Clock()
    port, ref = profiling.DispatchTimer(clock=clock), JTimer(clock=clock)
    handles = []
    script = [("prefill_chunk", 0.1, 0.3), ("decode", 0.35, 0.9),
              ("decode", 0.95, 1.2), ("prefill_chunk", 1.5, 1.55)]
    script += [(f"p{i}", 2.0 + i, 2.5 + i) for i in range(9)]
    for name, t_disp, t_ready in script:
        clock.t = t_disp
        probe = _Probe()
        handles.append((port.dispatch(name, probe), ref.dispatch(name, probe), probe))
        clock.t = t_ready
        if name.startswith("decode"):
            probe.ready = True
            port.poll()
            ref.poll()
            port.count_tokens(name, 8)
            ref.count_tokens(name, 8)
        else:
            port.drained(handles[-1][0])
            ref.drained(handles[-1][1])
    # one left in flight, then drained with an earlier one already done
    clock.t = 20.0
    probe = _Probe()
    hp, hr = port.dispatch("decode", probe), ref.dispatch("decode", probe)
    clock.t = 21.0
    port.drained(hp)
    ref.drained(hr)
    assert port.snapshot() == ref.snapshot()
    assert [h[0].busy_s for h in handles] == [h[1].busy_s for h in handles]
    assert "other" in port.snapshot()["programs"]


# ------------------------------------------------------ engine meters


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


_KEYS = ("rid", "tenant", "kind", "prompt_tokens", "emitted_tokens", "wire_bytes")


def _prompts(lengths, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 128, (n,)) for n in lengths]


def _pair(engines, paged=True, **kw):
    jeng, teng = engines
    gen = kw.pop("max_new", 6)
    jcls = jserving.PagedContinuousBatchingEngine if paged else jserving.ContinuousBatchingEngine
    tcls = PagedContinuousBatchingEngine if paged else ContinuousBatchingEngine
    return (jcls(jeng, gen=JGen(max_new_tokens=gen), **kw),
            tcls(teng, gen=GenerationConfig(max_new_tokens=gen), **kw))


def _fields(m):
    return {k: m[k] for k in _KEYS}


def _timer_total(sch) -> float:
    return sum(r["busy_s"] for r in sch.stats()["device_time"]["programs"].values())


@pytest.mark.parametrize("kind,depth", [("paged", 0), ("paged", 2), ("contiguous", 2)])
def test_meters_agree_with_the_reference_and_bill_every_dispatch(engines, kind, depth):
    paged = kind == "paged"
    kw = dict(slots=2, decode_chunk=3, pipeline_depth=depth)
    kw.update(dict(block_size=4, prefill_chunk=4) if paged else dict(prefill_block=4))
    jsch, sch = _pair(engines, paged, **kw)
    prompts = _prompts((5, 9, 3, 12))
    tenants = ["acme", None, "beta", "acme"]
    metas = []
    for s in (jsch, sch):
        rids = [s.submit(p, tenant=t) for p, t in zip(prompts, tenants)]
        s.run_until_idle()
        metas.append([s.meter(r) for r in rids])
    assert [_fields(m) for m in metas[0]] == [_fields(m) for m in metas[1]]
    assert sch.stats()["metering"]["metered_total"] == 4
    # every dispatch billed some request: meters sum to the timer's busy
    assert sum(m["busy_s"] for m in metas[1]) == pytest.approx(_timer_total(sch), rel=1e-9)
    assert all(m["flops"] > 0 and m["hbm_bytes"] > 0 for m in metas[1])
    # KV block-seconds integrate pool blocks: none on the contiguous cache
    assert all((m["kv_block_s"] > 0) == paged for m in metas[1])
    assert all(m["t_end"] >= m["t_start"] for m in metas[1])
    drained = sch.drain_meters()
    # handed out once each, in the order they were written
    assert sorted(m["rid"] for m in drained) == [m["rid"] for m in metas[1]]
    assert sch.drain_meters() == []


def test_timing_and_metering_off(engines):
    """``device_timing=False`` and ``metering=False``: the same tokens, no
    device-time block, no meter."""
    _, teng = engines
    kw = dict(slots=2, decode_chunk=3, block_size=4, prefill_chunk=4,
              gen=GenerationConfig(max_new_tokens=6))
    on = PagedContinuousBatchingEngine(teng, **kw)
    off = PagedContinuousBatchingEngine(teng, device_timing=False, metering=False, **kw)
    p = _prompts((7,), seed=2)[0]
    rid_on, rid_off = on.submit(p), off.submit(p)
    np.testing.assert_array_equal(on.result(rid_on), off.result(rid_off))
    off.run_until_idle()
    st = off.stats()
    assert "device_time" not in st and off.device_time() is None
    assert st["metering"] == {"enabled": False, "metered_total": 0, "undrained": 0}
    assert off.meter(rid_off) is None and off.drain_meters() == []


def test_disagg_leg_meters_agree_with_the_reference(engines):
    """Prefill leg: prompt tokens and 0 emitted, billed its prefill busy
    time; decode leg: the imported first token counts as emitted and the
    blob's length rides the meter."""
    kw = dict(slots=2, decode_chunk=3, block_size=4, prefill_chunk=4)
    jP, P = _pair(engines, **kw)
    jD, D = _pair(engines, **kw)
    for s, kind in ((jP, "prefill_leg"), (P, "prefill_leg"), (jD, "decode_leg"),
                    (D, "decode_leg")):
        s.meter_kind = kind
    prompts = _prompts((7, 13), seed=4)
    got = []
    for src, dst, pack, unpack in ((jP, jD, jpack, junpack), (P, D, pack_kv_payload,
                                                               unpack_kv_payload)):
        rids = []
        for p in prompts:
            blob = pack(src.prefill_export(p, tenant="t1"), codec="none")
            rids.append(dst.import_prefill(unpack(blob), tenant="t1",
                                           wire_bytes=len(blob)))
        dst.run_until_idle()
        got.append(([_fields(src.meter(r)) for r in range(len(prompts))],
                    [_fields(dst.meter(r)) for r in rids]))
    assert got[0] == got[1]
    pm = [P.meter(r) for r in range(len(prompts))]
    assert all(m["emitted_tokens"] == 0 and m["busy_s"] > 0 for m in pm)
    assert sum(m["busy_s"] for m in pm) == pytest.approx(_timer_total(P), rel=1e-9)
    dm = [D.meter(r) for r in range(len(prompts))]
    assert all(m["emitted_tokens"] == 6 and m["wire_bytes"] > 0 for m in dm)
    assert sum(m["busy_s"] for m in dm) == pytest.approx(_timer_total(D), rel=1e-9)


def test_preemption_moves_kv_block_seconds_like_the_reference(engines):
    """The reference's ``_meter_kv`` points (alloc, grow, preempt to 0,
    finish to 0) give the same (rid, blocks) sequence in both engines
    under pool pressure."""
    kw = dict(slots=3, decode_chunk=2, block_size=4, num_blocks=9,
              prefill_chunk=8, prefix_cache=False, pipeline_depth=2, max_new=12)
    jsch, sch = _pair(engines, **kw)
    prompts = _prompts((4, 4, 4), seed=7)
    prios = ["batch", "standard", "interactive"]
    logs = []
    for s in (jsch, sch):
        log = []
        inner = s._meter_kv

        def wrapped(req, blocks=None, inner=inner, log=log):
            log.append((req.rid, blocks))
            return inner(req, blocks)

        s._meter_kv = wrapped
        rids = [s.submit(p, priority=q) for p, q in zip(prompts, prios)]
        s.run_until_idle()
        logs.append(log)
        assert all(s.meter(r)["kv_block_s"] > 0 for r in rids)
    assert sch.preemptions > 0
    assert logs[0] == logs[1]
    assert (0, 0) in logs[1][:-3]  # the BATCH request held nothing while re-queued


# ------------------------------------------------------------ cost model


def test_program_cost_equals_hand_arithmetic():
    cfg = LlamaConfig.tiny()
    d, L, H, Hkv, V, F = cfg.dim, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.vocab_size, cfg.hidden_dim
    D = d // H
    P = d * H * D + 2 * d * Hkv * D + H * D * d + 3 * d * F  # one layer's matmuls
    kvb = 2 * Hkv * D * 2  # bf16 k and v, one token, one layer
    # a decode chunk: 4 rows, 3 steps, two rows decoding to frontiers 10, 6
    got = profiling.program_cost(cfg, "decode", rows=4, steps=3, frontier=[10, 6],
                                 kv_token_bytes=kvb)
    ctx = [8, 9, 10] + [4, 5, 6]  # keys each step's query attends to
    flops = 3 * 4 * (2 * P * L + 2 * d * V) + sum(4 * H * D * L * c for c in ctx)
    nbytes = 3 * (P * L + d * V) * 2 + sum(kvb * L * c for c in ctx)
    assert got == {"flops": float(flops), "bytes": float(nbytes)}
    # a prefill chunk: 4 tokens at positions 8..11
    got = profiling.program_cost(cfg, "prefill_chunk", rows=1, steps=4, frontier=[12],
                                 kv_token_bytes=kvb)
    pairs = 9 + 10 + 11 + 12
    flops = 4 * 2 * P * L + 2 * d * V + 4 * H * D * L * pairs
    nbytes = (P * L + d * V) * 2 + kvb * L * 12
    assert got == {"flops": float(flops), "bytes": float(nbytes)}
    with pytest.raises(ValueError, match="unknown program"):
        profiling.program_cost(cfg, "train", rows=1, steps=1, frontier=[1],
                               kv_token_bytes=kvb)


def test_measure_capability_needs_the_card_and_refuses_the_store():
    with pytest.raises(NotImplementedError, match="item 11"):
        profiling.measure_capability(store=object(), key="k")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.measure_capability(device="cpu")
