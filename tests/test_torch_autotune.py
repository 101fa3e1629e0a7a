"""PyTorch port, runtime/autotune.py and the warm start it feeds, against
the reference store's cases (``tests/test_autotune.py``) on the CPU:

- the store: round trip, ``$TL_AUTOTUNE_DIR``, corrupt / stale / wrong
  key read as a clean miss (counted), every key part matters, the model
  fingerprint is structural (an int8 sibling keys apart), flash overrides
  persist and re-apply (entries the port's registry refuses and
  malformed rows skip), ``update`` merges;
- both serving engines: a process that measures and saves, then a second
  process on the same directory that warm-starts from the bytes the first
  wrote, with the same K prior; an unserializable extra is dropped and
  counted; a corrupt file cold-starts;
- after one scripted adaptive run the K prior equals the JAX engine's;
- ``measure_capability(store=, key=)`` returns a stored record without
  measuring;
- ``autopair_draft`` with its clock pinned: candidates built lazily, at
  most one alive, a vocabulary mismatch skipped, a JSON-safe
  ``persistable``; the default int8 sibling shares the target's
  non-``Dense`` tensors and leaves the target's weights as they were."""

import gc
import hashlib
import json
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel import speculative as jspec
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.serving import ContinuousBatchingEngine as JContiguous
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.ops.flash import (
    clear_flash_block_overrides,
    flash_block_overrides,
    set_flash_block_override,
)
from tensorlink_tpu_torch.ops.quant import quantize_weight_int8
from tensorlink_tpu_torch.parallel import speculative as tspec
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import ContinuousBatchingEngine, SpecConfig
from tensorlink_tpu_torch.runtime import profiling
from tensorlink_tpu_torch.runtime.autotune import (
    GLOBAL_MODEL,
    AutotuneStore,
    apply_flash_overrides,
    apply_paged_overrides,
    model_fingerprint,
    store_key,
)


@pytest.fixture(autouse=True)
def _clean_overrides():
    clear_flash_block_overrides()
    yield
    clear_flash_block_overrides()


def _engine(seed=0, max_len=32, params=None):
    model = Llama(LlamaConfig.tiny(), device="cpu", seed=None if params else seed)
    return InferenceEngine(model, params, max_len=max_len, device="cpu",
                           cache_dtype=torch.float32, param_dtype=torch.float32)


# ------------------------------------------------------------- store unit
def test_store_round_trip(tmp_path):
    store = AutotuneStore.resolve(str(tmp_path / "at"))
    key = store_key("modelfp", (32, 64))
    assert store.load(key) is None  # empty = miss, not error
    p = store.save(key, {"flash_blocks": [[512, None, 64]],
                         "k_prior": {"k": 3, "acceptance": 0.7}})
    rec = store.load(key)
    assert rec["flash_blocks"] == [[512, None, 64]]
    assert rec["k_prior"] == {"k": 3, "acceptance": 0.7}
    assert rec["key"] == key and rec["torch"] == torch.__version__
    assert rec["cuda"] == torch.version.cuda and "chip" in rec
    assert p.exists() and store.counts["saved"] == 1
    assert [f.name for f in p.parent.iterdir()] == [p.name]  # no temp file left


def test_store_resolve_off_and_env(tmp_path, monkeypatch):
    monkeypatch.delenv("TL_AUTOTUNE_DIR", raising=False)
    assert AutotuneStore.resolve(None) is None
    monkeypatch.setenv("TL_AUTOTUNE_DIR", str(tmp_path / "env"))
    store = AutotuneStore.resolve(None)
    assert store is not None and store.root == tmp_path / "env"
    blocker = tmp_path / "file"
    blocker.write_text("x")
    before = AutotuneStore.resolve_failures
    assert AutotuneStore.resolve(str(blocker / "sub")) is None
    assert AutotuneStore.resolve_failures == before + 1


def test_store_corrupt_and_stale_cold_start(tmp_path):
    store = AutotuneStore.resolve(str(tmp_path))
    key = store_key("m", ())
    store.path(key).write_text("{truncated")
    assert store.load(key) is None
    store.path(key).write_bytes(b"\x00garbage\xff")
    assert store.load(key) is None
    store.path(key).write_text(json.dumps({"schema": 99, "key": key}))
    assert store.load(key) is None
    store.path(key).write_text(json.dumps({"schema": 1, "key": "somethingelse"}))
    assert store.load(key) is None
    store.path(key).write_text(json.dumps([1, 2]))
    assert store.load(key) is None
    assert store.counts == {"saved": 0, "corrupt": 2, "stale": 3}


def test_store_key_depends_on_all_parts(monkeypatch):
    keys = {store_key("a", (32,)), store_key("b", (32,)),
            store_key("a", (64,)), store_key("a", (32, 64))}
    assert len(keys) == 4
    assert store_key("a", (64, 32)) == store_key("a", (32, 64))  # a set
    from tensorlink_tpu_torch.runtime import autotune

    for part, val in (("torch", "0.0"), ("cuda", "0.0"), ("chip", "other card")):
        rt = {"torch": torch.__version__, "cuda": torch.version.cuda, "chip": "cpu"}
        monkeypatch.setattr(autotune, "runtime_fingerprint",
                            lambda rt=rt, part=part, val=val: {**rt, part: val})
        keys.add(store_key("a", (32,)))
    assert len(keys) == 7


def test_model_fingerprint_is_structural():
    p1 = {"w": torch.zeros(4, 8), "b": torch.zeros(8)}
    p2 = {"w": torch.ones(4, 8), "b": torch.ones(8)}
    p3 = {"w": torch.zeros(4, 9), "b": torch.zeros(9)}
    assert model_fingerprint(p1) == model_fingerprint(p2)  # values free
    assert model_fingerprint(p1) != model_fingerprint(p3)  # shapes pin
    assert model_fingerprint({"w": torch.zeros(4, 8, dtype=torch.bfloat16),
                              "b": torch.zeros(8)}) != model_fingerprint(p1)
    a, b = _engine(0), _engine(1)
    assert model_fingerprint(a.model) == model_fingerprint(b.model)
    sibling = tspec.default_draft_candidates(a)[0][1]()
    assert model_fingerprint(sibling.model) != model_fingerprint(a.model)


def test_flash_override_persist_and_apply():
    set_flash_block_override(512, 64)
    set_flash_block_override(1024, 64, batch=8)
    snap = flash_block_overrides()
    assert snap == [(512, None, 64), (1024, 8, 64)]
    clear_flash_block_overrides()
    # the port's kernel takes only the 64 tile: a reference record's 256
    # and a block that no longer divides seq are skipped, never fatal
    applied = apply_flash_overrides(
        {"flash_blocks": [list(t) for t in snap] + [[100, None, 33], [512, None, 256]]})
    assert applied == 2 and flash_block_overrides() == snap


def test_apply_overrides_skip_malformed_rows():
    applied = apply_flash_overrides({"flash_blocks": [
        [2048, None, 64],  # good
        ["x", None, 64],  # junk types
        [1, 2],  # wrong arity
        None,
    ]})
    assert applied == 1 and flash_block_overrides() == [(2048, None, 64)]
    assert apply_flash_overrides({}) == 0
    # the port's B3 has no pages-per-step knob: nothing applies
    assert apply_paged_overrides({"paged_kernel": [[8, None, 2], [1, 2]]}) == 0


def test_update_merges_writers(tmp_path):
    store = AutotuneStore.resolve(str(tmp_path))
    key = store_key(GLOBAL_MODEL, ())
    store.update(key, {"flash_blocks": [[512, None, 64]]})
    store.update(key, {"capability": {"peak_tflops": 1.0}})
    rec = store.load(key)
    assert rec["flash_blocks"] == [[512, None, 64]]
    assert rec["capability"] == {"peak_tflops": 1.0}


def test_measure_capability_loads_the_stored_record(tmp_path, monkeypatch):
    """A record measured earlier on the same card at the same sizes comes
    back without measuring (``cached``); another card's does not."""
    store = AutotuneStore.resolve(str(tmp_path))
    key = store_key(GLOBAL_MODEL, ())
    cap = {"schema": profiling.CAPABILITY_SCHEMA, "chip": "card A",
           "peak_tflops": 700.0, "hbm_gbps": 3000.0, "matmul_dim": 512,
           "hbm_mb": 64}
    store.update(key, {"capability": cap})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "card A")

    class Measured(Exception):
        pass

    def measuring(*a, **k):  # the microbench's first allocation
        raise Measured

    monkeypatch.setattr(torch, "full", measuring)
    got = profiling.measure_capability(store=store, key=key, device="cuda")
    assert got == {**cap, "cached": True}
    # other sizes, or another card: a miss, which measures
    with pytest.raises(Measured):
        profiling.measure_capability(matmul_dim=1024, store=store, key=key, device="cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "card B")
    with pytest.raises(Measured):
        profiling.measure_capability(store=store, key=key, device="cuda")


# ------------------------------------------------- engines, two processes
_PROC = """
import hashlib, json, sys
import numpy as np, torch
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.ops.flash import flash_block_overrides, set_flash_block_override
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine, PagedContinuousBatchingEngine, SpecConfig)

kind, mode, tune_dir = sys.argv[1:4]
m = Llama(LlamaConfig.tiny(), device="cpu")
eng = InferenceEngine(m, max_len=32, device="cpu", cache_dtype=torch.float32,
                      param_dtype=torch.float32)
if mode == "measure":
    set_flash_block_override(512, 64)  # the sweep this process pays for once
if kind == "contiguous":
    cls, kw = ContinuousBatchingEngine, {"decode_chunk": 2, "prefill_block": 4}
else:
    cls, kw = PagedContinuousBatchingEngine, {"block_size": 4, "prefill_chunk": 8}
sch = cls(eng, slots=2, gen=GenerationConfig(max_new_tokens=6),
          speculative=SpecConfig(k=3, adaptive=True), autotune_dir=tune_dir, **kw)
prior0 = sch._kctl.prior()
r = np.random.default_rng(0)
for i in range(3):
    sch.result(sch.submit(r.integers(0, 128, (4 + i,))))
if mode == "measure":
    path = sch.save_autotune(draft_pair={"name": "none", "mode": "ngram"},
                             live=object())
else:
    path = str(sch._autotune.path(sch._autotune_key))
blob = open(path, "rb").read()
print(json.dumps({
    "sha": hashlib.sha256(blob).hexdigest(),
    "warm_start_s": sch.autotune_warm_start_s,
    "stats_warm": sch.stats().get("autotune_warm_start_s"),
    "dropped": sch.stats()["autotune"]["extras_dropped"],
    "overrides": [list(t) for t in flash_block_overrides()],
    "record": json.loads(blob),
    "prior0": prior0,
}))
"""


def _run(kind, mode, d):
    out = subprocess.run([sys.executable, "-c", _PROC, kind, mode, d],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_two_process_restart_round_trips_tuning(tmp_path, kind):
    """Process A measures (a flash override, the K posterior) and saves;
    process B loads them at construction, before anything runs: the
    override is installed without a call, the controller starts from A's
    prior, the file is byte for byte what A wrote."""
    d = str(tmp_path / "tune")
    a = _run(kind, "measure", d)
    assert a["warm_start_s"] is None  # cold: nothing to load
    assert a["record"]["flash_blocks"] == [[512, None, 64]]
    assert a["record"]["k_prior"]["k"] >= 1
    assert a["record"]["draft_pair"] == {"name": "none", "mode": "ngram"}
    assert "live" not in a["record"] and a["dropped"] == 1
    b = _run(kind, "load", d)
    assert b["warm_start_s"] is not None and b["stats_warm"] == b["warm_start_s"]
    assert [512, None, 64] in b["overrides"]
    assert b["sha"] == a["sha"]
    assert b["prior0"] == a["record"]["k_prior"]
    assert b["record"]["prefill_buckets"] == a["record"]["prefill_buckets"]


def test_engine_cold_starts_on_corrupt_store(tmp_path):
    eng = _engine()
    d = tmp_path / "tune"
    probe = ContinuousBatchingEngine(eng, slots=1, gen=GenerationConfig(max_new_tokens=2),
                                     decode_chunk=2, prefill_block=4, autotune_dir=str(d))
    probe._autotune.path(probe._autotune_key).write_bytes(b"\x00garbage\xff")
    sch = ContinuousBatchingEngine(eng, slots=1, gen=GenerationConfig(max_new_tokens=2),
                                   decode_chunk=2, prefill_block=4, autotune_dir=str(d))
    assert sch.autotune_warm_start_s is None
    toks = sch.result(sch.submit(np.random.default_rng(1).integers(0, 128, (5,))))
    assert len(toks) == 2
    assert sch.stats()["autotune"]["corrupt"] == 1


def test_warm_buckets_warms_the_key_set(tmp_path):
    eng = _engine(max_len=16)
    sch = ContinuousBatchingEngine(eng, slots=2, gen=GenerationConfig(max_new_tokens=3),
                                   decode_chunk=2, prefill_block=4, warm_buckets=True)
    assert sch._autotune_buckets() == (4, 8, 12, 16)
    # the warm-up leaves slot 0 as it found it: tokens are the plain ones
    plain = ContinuousBatchingEngine(eng, slots=2, gen=GenerationConfig(max_new_tokens=3),
                                     decode_chunk=2, prefill_block=4)
    pr = np.arange(1, 6)
    np.testing.assert_array_equal(sch.result(sch.submit(pr)), plain.result(plain.submit(pr)))


def test_paged_warm_buckets_writes_only_the_scratch_block():
    """The paged warm-up runs one prefill chunk through slot 0's row while
    it points at the scratch block: the pools' real blocks stay zero and
    tokens are the plain engine's."""
    from tensorlink_tpu_torch.parallel.serving import PagedContinuousBatchingEngine

    eng = _engine()
    kw = {"slots": 2, "block_size": 8, "prefill_chunk": 8,
          "gen": GenerationConfig(max_new_tokens=4)}
    sch = PagedContinuousBatchingEngine(eng, warm_buckets=True, **kw)
    assert sch._autotune_buckets() == (8,)
    nb = sch.pool.num_blocks
    assert all(not t[:nb].any() for pool in sch._pools for t in pool.values())
    plain = PagedContinuousBatchingEngine(eng, **kw)
    pr = np.arange(2, 13)
    np.testing.assert_array_equal(sch.result(sch.submit(pr)), plain.result(plain.submit(pr)))


def test_k_prior_equals_the_jax_engines():
    """One scripted adaptive run on the same params: the posterior the
    store would persist equals the JAX engine's."""
    jm = JLlama(JLlamaConfig.tiny())
    p, pd = jm.init(jax.random.key(0)), jm.init(jax.random.key(1))
    mesh = make_mesh(MeshConfig())
    jeng = JEngine(mesh, jm, p, max_len=32, cache_dtype=jnp.float32, param_dtype=jnp.float32)
    jdraft = JEngine(mesh, jm, pd, max_len=32, cache_dtype=jnp.float32,
                     param_dtype=jnp.float32)
    teng = _engine(params=params_from_jax(jax.device_get(p)))
    tdraft = _engine(params=params_from_jax(jax.device_get(pd)))
    kw = {"slots": 2, "decode_chunk": 3, "prefill_block": 4}
    cfg = {"k": 3, "rounds": 2, "adaptive": True}
    jsch = JContiguous(jeng, gen=JGen(max_new_tokens=8), draft=jdraft,
                       speculative=jspec.SpecConfig(**cfg), **kw)
    tsch = ContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=8),
                                    draft=tdraft, speculative=SpecConfig(**cfg), **kw)
    r = np.random.default_rng(0)
    for n in (5, 3, 7):
        pr = r.integers(0, 128, (n,))
        np.testing.assert_array_equal(tsch.result(tsch.submit(pr)),
                                      np.asarray(jsch.result(jsch.submit(pr))))
    assert tsch._kctl.prior() == jsch._kctl.prior()


# ---------------------------------------------------------------- autopair
def test_default_sibling_shares_and_leaves_the_target():
    eng = _engine()
    before = {n: t.clone() for n, t in eng.model.state_dict().items()}
    (name, thunk), = tspec.default_draft_candidates(eng)
    assert name == "int8-sibling"
    sib = thunk()
    after = eng.model.state_dict()
    assert set(after) == set(before)  # the target is not quantized
    assert all(torch.equal(before[n], after[n]) for n in before)
    s_state = sib.model.state_dict()
    # non-Dense tensors are the target's own, not copies
    assert s_state["tok_emb.table"].data_ptr() == after["tok_emb.table"].data_ptr()
    assert s_state["norm_f.scale"].data_ptr() == after["norm_f.scale"].data_ptr()
    qw = quantize_weight_int8(after["blocks.1.mlp.down.w"])
    assert torch.equal(s_state["blocks.1.mlp.down.w.q"], qw["q"])
    assert sib.quantize == "int8" and sib.max_len == eng.max_len


def test_autopair_builds_lazily_one_alive_and_skips_a_vocab_mismatch(monkeypatch):
    eng = _engine(max_len=64)
    ticks = iter(range(10**6))
    monkeypatch.setattr(tspec, "_clock", lambda: float(next(ticks)))
    built, alive = [], []

    def make(tag, vocab=128):
        def thunk():
            # at most one candidate alive: every earlier one was released
            assert not [r for r in alive if r() is not None], tag
            built.append(tag)
            cfg = LlamaConfig(vocab_size=vocab, dim=32, num_layers=1, num_heads=4,
                              num_kv_heads=2, hidden_dim=64, max_len=64)
            e = InferenceEngine(Llama(cfg, device="cpu", seed=len(built)), max_len=64,
                                device="cpu", cache_dtype=torch.float32,
                                param_dtype=torch.float32)
            alive.append(weakref.ref(e))
            return e
        return thunk

    cands = [("big", make("big")), ("wide", make("wide", vocab=256)),
             ("small", make("small"))]
    v = tspec.autopair_draft(eng, GenerationConfig(), candidates=cands,
                             cfg=SpecConfig(k=2), max_new=6)
    assert built == ["big", "wide", "small"]  # lazily, in order
    assert [n for n, _ in v["skipped"]] == ["wide"]
    # the pinned clock makes every burst take one tick: no mode beats the
    # baseline, so the verdict is non-spec
    assert v["mode"] == "nonspec" and v["draft"] is None
    assert set(v["measured"]) == {"nonspec", "big", "small", "ngram"}
    assert json.loads(json.dumps(v["persistable"])) == v["persistable"]
    gc.collect()
    assert all(r() is None for r in alive)  # losers released


def test_autopair_default_candidate_can_win(monkeypatch):
    """Burst clocks that favour the int8 sibling pick it, with the
    config to splat into a serving engine."""
    eng = _engine(max_len=64)
    # _clock calls: the start, then (t0, end) of the baseline burst (2
    # ticks) and of the sibling's (1 tick), then the verdict's stamp
    ticks = iter([0.0, 0.0, 2.0, 10.0, 11.0, 12.0])
    monkeypatch.setattr(tspec, "_clock", lambda: next(ticks))
    v = tspec.autopair_draft(eng, GenerationConfig(), cfg=SpecConfig(k=2), max_new=6)
    assert v["mode"] == "draft" and v["name"] == "int8-sibling"
    assert v["draft"].quantize == "int8" and v["spec"] == SpecConfig(k=2)
    assert v["measured"]["int8-sibling"] > v["measured"]["nonspec"]
    assert "ngram" not in v["measured"]
    sch = ContinuousBatchingEngine(eng, slots=2, gen=GenerationConfig(max_new_tokens=4),
                                   prefill_block=16, draft=v["draft"], speculative=v["spec"])
    plain = ContinuousBatchingEngine(eng, slots=2, gen=GenerationConfig(max_new_tokens=4),
                                     prefill_block=16)
    pr = np.arange(3, 12)
    np.testing.assert_array_equal(sch.result(sch.submit(pr)), plain.result(plain.submit(pr)))


def test_save_autotune_without_a_store_is_a_no_op():
    sch = ContinuousBatchingEngine(_engine(), slots=1, prefill_block=4)
    assert sch.save_autotune(draft_pair={"mode": "nonspec"}) is None
    assert "autotune" not in sch.stats()


def test_record_hash_is_stable(tmp_path):
    store = AutotuneStore.resolve(str(tmp_path))
    key = store_key("m", (8,))
    p = store.save(key, {"a": 1})
    h1 = hashlib.sha256(p.read_bytes()).hexdigest()
    assert store.load(key)["a"] == 1
    assert hashlib.sha256(p.read_bytes()).hexdigest() == h1  # load writes nothing
