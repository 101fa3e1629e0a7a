"""PyTorch port, the telemetry wired into the serving engines and the
trainers, held against the JAX package on the same submissions and
steps (tiny Llama: 2 layers, a 64-token vocabulary, f32, same params):

- the serving engines (paged, contiguous, n-gram speculation, a shed
  and a displacement under ``max_queue``): the same tokens, the same
  metric names with equal counter values and histogram counts, the same
  flight event kinds with equal counts, the same span names with equal
  counts (timings and timestamps are not compared);
- ``kv_stats`` / ``kv_stats_summary`` of the paged engine equal the JAX
  engine's mid-run and at rest (pool counters, chain count, each chain's
  blocks, refs and priority; ages excluded), and the locked snapshot
  holds block conservation while a writer thread admits and evicts (the
  reference's racing-reader case);
- ``Trainer`` and ``ShardedTrainer`` (world 1): the same span names,
  series and counters, the non-finite counter and ``train_nonfinite``
  event on a NaN batch; ``device_time()`` and ``data_span()``;
- ``DispatchTimer(metrics=)``, ``AutotuneStore(recorder=)`` and
  ``autopair_draft(recorder=)`` emit the reference's names.
"""

import collections
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensorlink_tpu.config import MeshConfig as JMeshConfig
from tensorlink_tpu.config import TrainConfig as JTrainConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel import serving as jserving
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.runtime import autotune as jautotune
from tensorlink_tpu.runtime import profiling as jprofiling
from tensorlink_tpu.runtime.flight import FlightRecorder as JFlight
from tensorlink_tpu.runtime.mesh import make_mesh as jmake_mesh
from tensorlink_tpu.runtime.metrics import Metrics as JMetrics
from tensorlink_tpu.runtime.tracing import Tracer as JTracer
from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel import serving
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.speculative import SpecConfig
from tensorlink_tpu_torch.runtime import autotune, profiling
from tensorlink_tpu_torch.runtime.flight import FlightRecorder
from tensorlink_tpu_torch.runtime.metrics import Metrics
from tensorlink_tpu_torch.runtime.tracing import Tracer

VOCAB = 64


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), vocab_size=VOCAB)
    jm = JLlama(jcfg)
    p = jm.init(jax.random.key(0))
    jeng = JEngine(jmake_mesh(JMeshConfig()), jm, p, max_len=32,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    tm = Llama(dataclasses.replace(LlamaConfig.tiny(), vocab_size=VOCAB),
               device="cpu", seed=None)
    teng = InferenceEngine(tm, params_from_jax(jax.device_get(p)), max_len=32,
                           cache_dtype=torch.float32, param_dtype=torch.float32,
                           device="cpu")
    return jeng, teng


def _prompts():
    r = np.random.default_rng(0)
    system = r.integers(0, VOCAB, (6,))
    return [np.concatenate([system, r.integers(0, VOCAB, (n,))]) for n in (3, 5, 7, 2)]


PRIOS = ["interactive", "standard", "batch", "standard"]
# one slot and one queue place: the batch request queues, the interactive
# one displaces it, the last batch request is refused
OVERLOAD_PRIOS = ["standard", "batch", "interactive", "batch"]


def _scheduler(side, eng, kind, **over):
    mod = serving if side == "port" else jserving
    gen = (GenerationConfig if side == "port" else JGen)(max_new_tokens=5)
    tel = ((Metrics(), FlightRecorder(), Tracer()) if side == "port"
           else (JMetrics(), JFlight(), JTracer()))
    kw = dict(slots=2, gen=gen, metrics=tel[0], recorder=tel[1], tracer=tel[2])
    kw.update(over)
    if kind.startswith("paged"):
        return mod.PagedContinuousBatchingEngine(eng, block_size=4, num_blocks=12, **kw)
    return mod.ContinuousBatchingEngine(eng, prefill_block=8, **kw)


def _telemetry(sch) -> dict:
    """Everything the telemetry holds but its timings."""
    snap = sch.metrics.snapshot()
    return {
        "counters": dict(snap["counters"]),
        "series": sorted(k for k in snap if k not in ("counters", "histograms")),
        "histograms": {k: v["n"] for k, v in snap.get("histograms", {}).items()},
        "events": collections.Counter(e["kind"] for e in sch.recorder.events()),
        "spans": collections.Counter(s.name for s in sch.tracer.spans()),
    }


def _serve(sch, kind):
    """The script: four prompts sharing a system prefix at mixed
    priorities (with ``max_queue`` a shed and a displacement too); the
    tokens (or the typed refusal) of each."""
    out = []
    rids = []
    prios = OVERLOAD_PRIOS if kind.endswith("overload") else PRIOS
    for q, pr in zip(_prompts(), prios):
        try:
            rids.append(sch.submit(q, priority=pr))
        except (serving.OverloadedError, jserving.OverloadedError) as e:
            out.append(("refused", type(e).__name__))
    for rid in rids:
        try:
            out.append(list(np.asarray(sch.result(rid))))
        except (serving.OverloadedError, jserving.OverloadedError) as e:
            out.append(("shed", e.reason))
    sch.run_until_idle()
    return out


KINDS = {
    "paged": {},
    "contiguous": {},
    "paged-ngram": {"speculative": "spec"},
    "contiguous-overload": {"slots": 1, "max_queue": 1},
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_serving_telemetry_matches_jax(engines, kind):
    jeng, teng = engines
    over = dict(KINDS[kind])
    sides = {}
    for side, eng in (("jax", jeng), ("port", teng)):
        o = dict(over)
        if o.get("speculative") == "spec":
            o["speculative"] = (SpecConfig if side == "port"
                                else jserving.SpecConfig)(k=2, rounds=2)
        sch = _scheduler(side, eng, kind, **o)
        sides[side] = (_serve(sch, kind), _telemetry(sch))
    (jtok, jtel), (ttok, ttel) = sides["jax"], sides["port"]
    assert ttok == jtok
    for part in jtel:
        assert ttel[part] == jtel[part], part
    ev, sp = ttel["events"], ttel["spans"]
    served = sum(isinstance(t, list) for t in ttok)
    shed = ttok.count(("shed", "displaced"))
    assert ev["serving.submit"] == served + shed
    assert ev["serving.admit"] == served
    # a displaced request finishes too, but was never admitted
    assert sp["serving.request"] == served + shed
    assert sp["serving.queue_wait"] == sp["serving.prefill"] == sp["serving.decode"] == served
    assert ttel["counters"]["serving_requests_total"] == served + shed
    assert ttel["counters"]["serving_tokens_total"] == sum(
        len(t) for t in ttok if isinstance(t, list))
    if kind == "contiguous-overload":
        assert ttok.count(("refused", "QueueFullError")) == shed == 1
        assert ttel["counters"]["serving_shed_total"] == 2
    if kind == "paged-ngram":
        assert ttel["histograms"]["serving_spec_acceptance"] == served


def _residency(snap):
    """A kv_stats body without ages and in a fixed chain order."""
    chains = sorted(({k: v for k, v in c.items() if k != "last_hit_age_s"}
                     for c in snap["chains"]), key=lambda c: c["block_ids"])
    return {**{k: v for k, v in snap.items() if k != "chains"}, "chains": chains}


def test_kv_stats_match_jax(engines):
    jeng, teng = engines
    scheds = {side: _scheduler(side, eng, "paged")
              for side, eng in (("jax", jeng), ("port", teng))}
    views = {side: [] for side in scheds}
    for side, sch in scheds.items():
        for q, pr in zip(_prompts(), PRIOS):
            sch.submit(q, priority=pr)
        for _ in range(4):  # mid-run: live refs on shared prefix blocks
            sch.step()
        views[side].append((_residency(sch.kv_stats(limit=256)), sch.kv_stats_summary()))
        sch.run_until_idle()
        views[side].append((_residency(sch.kv_stats(limit=256)), sch.kv_stats_summary()))
    assert views["port"] == views["jax"]
    live, rest = views["port"]
    assert any(c["refs"] > 0 for c in live[0]["chains"])
    assert rest[0]["pool"]["blocks_in_use"] == 0 and rest[0]["total_chains"] > 0


def test_kv_snapshot_exact_under_concurrent_admission_eviction(engines):
    """The reference's racing-reader case on the port's engine: GET /kv is
    one instant, pool accounting adds up and every resident chain's
    blocks are live, while a writer thread admits and evicts."""
    _, teng = engines
    sch = serving.PagedContinuousBatchingEngine(
        teng, slots=2, gen=GenerationConfig(max_new_tokens=4),
        block_size=4, num_blocks=12, prefix_cache=True,
    )
    r = np.random.default_rng(0)
    system = r.integers(0, VOCAB, (6,))
    prompts = [np.concatenate([system, r.integers(0, VOCAB, (n,))])
               for n in (3, 5, 7, 2, 6, 4, 8, 3)]
    failures: list = []
    done = threading.Event()

    def writer():
        try:
            for _ in range(3):
                for rid in [sch.submit(p) for p in prompts]:
                    sch.result(rid)
        finally:
            done.set()

    wt = threading.Thread(target=writer)
    wt.start()
    snaps = 0
    while not done.is_set() or snaps == 0:
        snap = sch.kv_stats(limit=256)
        snaps += 1
        pool = snap["pool"]
        total = pool["blocks_in_use"] + pool["blocks_free"] + pool["blocks_reusable"]
        if total != pool["num_blocks"]:
            failures.append(f"block conservation broke: {pool}")
            break
        for c in snap["chains"]:
            if len(c["block_ids"]) != c["blocks"]:
                failures.append(f"chain shape torn: {c}")
            if any(not 0 <= b < pool["num_blocks"] for b in c["block_ids"]):
                failures.append(f"chain points at bogus block: {c}")
            if c["refs"] < 0 or c["priority"] not in (0, 1, 2):
                failures.append(f"bad refs/priority: {c}")
    wt.join()
    assert not failures, failures[:3]
    assert snaps > 20  # the reader really raced the writer
    snap = sch.kv_stats(limit=256)
    summ = sch.kv_stats_summary()
    assert summ["num_blocks"] == snap["pool"]["num_blocks"]
    assert summ["used"] == snap["pool"]["blocks_in_use"]
    assert summ["chains"] == snap["total_chains"]


# ------------------------------------------------------------- trainers

def _mlp_pair():
    from tensorlink_tpu.models.mlp import MLP as JMLP
    from tensorlink_tpu.models.mlp import MLPConfig as JMLPConfig
    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig

    kw = dict(in_dim=8, hidden_dim=16, out_dim=3, num_layers=2)
    jm = JMLP(JMLPConfig(**kw))
    p = jax.device_get(jm.init(jax.random.key(0)))
    tm = MLP(MLPConfig(**kw), device="cpu", seed=None)
    return jm, p, tm


def _mlp_batches():
    r = np.random.default_rng(2)
    out = [{"x": r.normal(size=(4, 8)).astype(np.float32),
            "y": r.integers(0, 3, (4,))} for _ in range(3)]
    out[2]["x"][1, 3] = np.nan  # a poisoned batch
    return out


def test_trainer_telemetry_matches_jax():
    from tensorlink_tpu.train.trainer import Trainer as JTrainer
    from tensorlink_tpu.train.trainer import TrainState as JTrainState
    from tensorlink_tpu.train.trainer import softmax_cross_entropy as jce
    from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy

    jm, p, tm = _mlp_pair()
    cfg = dict(optimizer="adamw", learning_rate=1e-3, skip_nonfinite_updates=True)
    tels = {}
    jt = JTrainer(jm, lambda m, prm, b, rng: jce(m.apply(prm, b["x"]), b["y"]),
                  JTrainConfig(**cfg), tracer=JTracer(), metrics=JMetrics(),
                  flight=JFlight())
    st = JTrainState.create(p, jt.optimizer)
    for b in _mlp_batches():
        with jt.data_span():
            jb = {k: jnp.asarray(v) for k, v in b.items()}
        st, _ = jt.train_step(st, jb, jax.random.key(1))
    tels["jax"] = jt
    tt = Trainer(tm, lambda m, prm, b, rng: softmax_cross_entropy(
        functional_call(m, prm, (b["x"],)), b["y"]), TrainConfig(**cfg),
        tracer=Tracer(), metrics=Metrics(), flight=FlightRecorder(), device="cpu")
    ts = tt.init_state(params_from_jax(p))
    for b in _mlp_batches():
        with tt.data_span():
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
        ts, stats = tt.train_step(ts, tb)
    tels["port"] = tt
    assert bool(stats["nonfinite"]) and int(ts.step) == 2

    def view(tr):
        snap = tr.metrics.snapshot()
        return (dict(snap["counters"]),
                {k: v["n"] for k, v in snap.items() if k not in ("counters", "histograms")},
                {k: v["n"] for k, v in snap.get("histograms", {}).items()},
                collections.Counter(e["kind"] for e in tr.flight.events()),
                collections.Counter(s.name for s in tr.tracer.spans()))

    assert view(tels["port"]) == view(tels["jax"])
    counters, series, _, events, spans = view(tels["port"])
    assert counters == {"train_steps": 3, "train_nonfinite_total": 1}
    assert series["step_s"] == 2 and series["compile_s"] == 1 and series["data_s"] == 3
    assert events == {"train_nonfinite": 1}
    assert spans == {"trainer.compile_step": 1, "trainer.step": 2, "trainer.data": 3}
    ev = tt.flight.events()[0]["attrs"]
    assert ev["step"] == 2 and ev["skipped"] is True
    dt = tt.device_time()
    assert dt["programs"]["train_step"]["count"] == 2  # the first call is not timed
    assert set(dt) == set(tels["jax"].device_time())
    # an uninstrumented trainer has no timer and no telemetry
    bare = Trainer(tm, lambda *a: None, TrainConfig(), device="cpu")
    assert bare.device_time() is None and bare._telemetry is None


def test_sharded_trainer_telemetry_matches_jax():
    from tensorlink_tpu.models.gpt2 import GPT2 as JGPT2
    from tensorlink_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from tensorlink_tpu.parallel.engine import ShardedTrainer as JShardedTrainer
    from tensorlink_tpu.train.trainer import softmax_cross_entropy as jce
    from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh, shutdown_distributed
    from tensorlink_tpu_torch.train.trainer import softmax_cross_entropy

    mcfg = dict(vocab_size=64, dim=16, num_layers=1, num_heads=2, max_len=16,
                dropout=0.0)
    cfg = dict(optimizer="sgd", learning_rate=1e-3, micro_batches=2)
    r = np.random.default_rng(4)
    batches = []
    for i in range(3):
        ids = r.integers(0, 64, (4, 9))
        w = np.ones((4,), np.float32)
        if i == 2:
            w[0] = np.nan  # the poisoned batch
        batches.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:], "w": w})

    jm = JGPT2(JGPT2Config(**mcfg))
    jp = jax.device_get(jm.init(jax.random.key(0)))  # the step donates its state
    jtr = JShardedTrainer(
        jmake_mesh(JMeshConfig()), JTrainConfig(**cfg), jm.as_pipeline_parts(jp),
        lambda out, b: jce(out, b["labels"]) * b["w"].mean(),
        tracer=JTracer(), metrics=JMetrics(), flight=JFlight())
    jst = jtr.init_state()
    for b in batches:
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})

    model = GPT2(GPT2Config(**mcfg), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(jp))
    try:
        tr = ShardedTrainer(
            make_mesh(MeshConfig(), device="cpu"), TrainConfig(**cfg),
            model.as_pipeline_parts(),
            lambda out, b: softmax_cross_entropy(out, b["labels"]) * b["w"].mean(),
            tracer=Tracer(), metrics=Metrics(), flight=FlightRecorder(), device="cpu")
        st = tr.init_state()
        for b in batches:
            st, stats = tr.train_step(st, {k: torch.from_numpy(v) for k, v in b.items()})
    finally:
        shutdown_distributed()
    assert bool(stats["nonfinite"])

    def view(t):
        snap = t.metrics.snapshot()
        return (dict(snap["counters"]),
                {k: v["n"] for k, v in snap.items() if k not in ("counters", "histograms")},
                collections.Counter(e["kind"] for e in t.flight.events()),
                collections.Counter(s.name for s in t.tracer.spans()),
                [s.attrs for s in t.tracer.spans()])

    assert view(tr) == view(jtr)
    counters, series, events, spans, attrs = view(tr)
    assert counters == {"train_steps": 3, "train_nonfinite_total": 1}
    assert events == {"train_nonfinite": 1}
    assert spans == {"engine.compile_step": 1, "engine.step": 2}
    assert attrs[0] == {"stages": 1, "micros": 2}


# --------------------------------------------------- the dropped arguments

def test_dispatch_timer_metrics_match_jax():
    clock = iter(np.arange(0.0, 10.0, 0.25)).__next__
    jclock = iter(np.arange(0.0, 10.0, 0.25)).__next__
    tm, jm = Metrics(), JMetrics()
    port = profiling.DispatchTimer(metrics=tm, clock=clock)
    ref = jprofiling.DispatchTimer(metrics=jm, clock=jclock)
    for t in (port, ref):
        for name in ("prefill", "decode", "decode"):
            t.drained(t.dispatch(name))
    ps, js = tm.snapshot(), jm.snapshot()
    assert sorted(ps) == sorted(js)
    assert {k: v["n"] for k, v in ps["histograms"].items()} == \
        {k: v["n"] for k, v in js["histograms"].items()}
    for k in ps:
        if k not in ("counters", "histograms"):
            assert ps[k] == js[k], k


def test_autotune_store_events_match_jax(tmp_path):
    kinds = {}
    for side, mod, rec in (("port", autotune, FlightRecorder()),
                           ("jax", jautotune, JFlight())):
        root = tmp_path / side
        store = mod.AutotuneStore.resolve(str(root), recorder=rec)
        store.save("k1", {"a": 1})
        assert store.load("k1")["a"] == 1
        (root / "tune-k2.json").write_bytes(b"\xff\x00 not json")
        assert store.load("k2") is None
        (root / "tune-k3.json").write_text('{"schema": 999}')
        assert store.load("k3") is None
        store.save("k4", {"b": 2})
        (root / "tune-k4.json").rename(root / "tune-k5.json")
        assert store.load("k5") is None  # stale: key mismatch
        blocked = tmp_path / f"{side}-file"
        blocked.write_text("x")
        assert mod.AutotuneStore.resolve(str(blocked / "sub"), recorder=rec) is None
        kinds[side] = [(e["kind"], e["severity"]) for e in rec.events()]
    assert kinds["port"] == kinds["jax"]
    assert [k for k, _ in kinds["port"]] == [
        "autotune.saved", "autotune.corrupt", "autotune.stale", "autotune.saved",
        "autotune.stale", "autotune.init_failed"]


def test_autopair_records_its_verdict(engines):
    _, teng = engines
    from tensorlink_tpu_torch.parallel.speculative import autopair_draft

    rec = FlightRecorder()
    big = dataclasses.replace(LlamaConfig.tiny(), vocab_size=VOCAB + 1)
    v = autopair_draft(
        teng, GenerationConfig(max_new_tokens=4),
        candidates=[("other-vocab", lambda: InferenceEngine(
            Llama(big, device="cpu", seed=1), max_len=32, device="cpu",
            cache_dtype=torch.float32, param_dtype=torch.float32))],
        cfg=SpecConfig(k=2, rounds=1), max_new=4, recorder=rec)
    kinds = [e["kind"] for e in rec.events()]
    assert kinds.count("spec.autopair_skip") == 1
    assert kinds[-1] == "spec.autopair"
    assert rec.events()[-1]["attrs"]["mode"] == v["mode"]
    assert "serving.submit" in kinds  # the burst schedulers record into it
