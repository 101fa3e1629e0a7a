"""PyTorch port, admission control in parallel/serving.py, held against the
JAX package's engines on the same script (tiny Llama, f32, same params):

- ``Priority``, the typed errors and their wire dicts equal the
  reference's, key for key;
- a full queue sheds with a typed ``QueueFullError`` whose
  ``retry_after_s`` grows with the backlog; an INTERACTIVE arrival
  displaces the newest queued BATCH request, whose ``result`` raises
  ``OverloadedError`` (reason ``displaced``);
- admission follows (priority, rid) in both engines; under pool pressure
  the paged engine preempts BATCH before STANDARD before INTERACTIVE
  (also when a queued INTERACTIVE head cannot get blocks), and every
  preempted stream resumes token-identical;
- ``submit`` refuses a deadline measured TPOT proves unmeetable, a
  queued deadline expires, and ``result(deadline_s=)`` and ``cancel``
  abort a running request with chunks in flight (``pipeline_depth`` 2):
  slot and blocks free at once and the co-tenant's tokens do not move."""

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
from tensorlink_tpu.runtime.flight import FlightRecorder
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel import serving
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    DeadlineExceededError,
    OverloadedError,
    PagedContinuousBatchingEngine,
    Priority,
    QueueFullError,
    ServingError,
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


def _prompts(lengths, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 128, (n,)) for n in lengths]


def _log_calls(sch, name, log, rid_of):
    """Record, in call order, the rid each call of ``sch.<name>`` acts on
    (when the call returns other than False)."""
    inner = getattr(sch, name)

    def wrapped(*a):
        rid = rid_of(*a)
        out = inner(*a)
        if out is not False:
            log.append(rid)
        return out

    setattr(sch, name, wrapped)


def _outcome(sch, rid):
    try:
        return list(np.asarray(sch.result(rid)))
    except OverloadedError as e:
        return ("overloaded", e.reason)
    except serving.DeadlineExceededError:
        return "deadline"
    except jserving.OverloadedError as e:
        return ("overloaded", e.reason)
    except jserving.DeadlineExceededError:
        return "deadline"


# ------------------------------------------------------------ types, wire


def test_priority_and_wire_forms_equal_the_reference():
    assert [(p.name, int(p)) for p in Priority] == \
        [(p.name, int(p)) for p in jserving.Priority]
    for v in ("batch", "INTERACTIVE", 1, Priority.BATCH):
        assert serving._coerce_priority(v) == jserving._coerce_priority(v)
    with pytest.raises(ValueError, match="unknown priority"):
        serving._coerce_priority("urgent")
    cases = [
        ("ServingError", (), {}),
        ("PromptTooLongError", (), {}),
        ("OverloadedError", (), {"retry_after_s": 0.25, "reason": "displaced"}),
        ("QueueFullError", (), {"retry_after_s": 1.5}),
        ("PoolOverloadedError", (), {"retry_after_s": 2.0}),
        ("DeadlineExceededError", (), {"rid": 3}),
        ("PoolExhaustedError", (), {}),
    ]
    for name, args, kw in cases:
        te = getattr(serving, name)("msg " + name, *args, **kw)
        je = getattr(jserving, name)("msg " + name, *args, **kw)
        wire = serving.serve_error_to_wire(te)
        assert wire == jserving.serve_error_to_wire(je)
        back, jback = serving.serve_error_from_wire(wire), jserving.serve_error_from_wire(wire)
        assert type(back).__name__ == type(jback).__name__ == name
        assert getattr(back, "retry_after_s", None) == getattr(jback, "retry_after_s", None)
        assert getattr(te, "reason", None) == getattr(je, "reason", None)
    timeout = serving.serve_error_to_wire(TimeoutError("t"))
    assert timeout == jserving.serve_error_to_wire(TimeoutError("t"))
    assert isinstance(serving.serve_error_from_wire(timeout), TimeoutError)
    unknown = {"error_type": "Nope", "error": "x"}
    assert type(serving.serve_error_from_wire(unknown)) is ServingError
    assert issubclass(serving.PoolOverloadedError, serving.PoolExhaustedError)


# ----------------------------------------------------------- backpressure


def test_shed_is_typed_and_retry_after_grows_with_the_backlog(engines):
    _, teng = engines
    sch = ContinuousBatchingEngine(teng, slots=1, prefill_block=4, max_queue=3,
                                   gen=GenerationConfig(max_new_tokens=6))
    pr = _prompts((4,))[0]
    sch.result(sch.submit(pr))  # a finished request: TPOT is measured
    assert sch.stats()["admission"]["tpot_ewma_s"] > 0
    sch.submit(pr)  # the slot
    ra_shallow = sch.stats()["admission"]["retry_after_s"]
    for _ in range(3):
        sch.submit(pr)  # the queue
    ra_deep = sch.stats()["admission"]["retry_after_s"]
    assert ra_deep > ra_shallow > 0
    with pytest.raises(OverloadedError) as ei:
        sch.submit(pr)
    assert isinstance(ei.value, QueueFullError) and ei.value.reason == "queue_full"
    assert ei.value.retry_after_s == pytest.approx(ra_deep, rel=0.5)
    adm = sch.stats()["admission"]
    assert adm["shed_total"] == 1 and adm["shed_by_priority"] == {"standard": 1}
    sch.run_until_idle()


def test_interactive_displaces_queued_batch_like_jax(engines):
    jeng, teng = engines
    pr = _prompts((4,))[0]
    results = []
    for sch in (
        jserving.ContinuousBatchingEngine(jeng, slots=1, prefill_block=4,
                                          max_queue=1, gen=JGen(max_new_tokens=4)),
        ContinuousBatchingEngine(teng, slots=1, prefill_block=4, max_queue=1,
                                 gen=GenerationConfig(max_new_tokens=4)),
    ):
        ra = sch.submit(pr, priority="standard")  # the slot
        rb = sch.submit(pr, priority=Priority.BATCH)  # the queue, full now
        rc = sch.submit(pr, priority=Priority.INTERACTIVE)  # displaces rb
        with pytest.raises((OverloadedError, jserving.OverloadedError)):
            sch.submit(pr, priority=Priority.BATCH)  # cannot displace rc
        sch.run_until_idle()
        results.append([_outcome(sch, r) for r in (ra, rb, rc)])
        with pytest.raises((OverloadedError, jserving.OverloadedError)) as ei:
            sch.result(rb)
        assert ei.value.retry_after_s > 0
    assert results[0] == results[1]
    assert results[1][1] == ("overloaded", "displaced")
    assert sch.stats()["admission"]["shed_by_priority"] == {"batch": 2}


# -------------------------------------------------------- priority order


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_admission_follows_priority_then_rid_like_jax(engines, kind):
    jeng, teng = engines
    prompts = _prompts((4, 5, 3, 6, 4), seed=1)
    prios = ["standard", "batch", "interactive", "batch", "interactive"]
    kw = {"slots": 1, "decode_chunk": 2}
    kw.update({"prefill_block": 4} if kind == "contiguous"
              else {"block_size": 4, "prefill_chunk": 8})
    rec = FlightRecorder()
    jcls = (jserving.ContinuousBatchingEngine if kind == "contiguous"
            else jserving.PagedContinuousBatchingEngine)
    jsch = jcls(jeng, gen=JGen(max_new_tokens=4), recorder=rec, **kw)
    cls = ContinuousBatchingEngine if kind == "contiguous" else PagedContinuousBatchingEngine
    sch = cls(teng, gen=GenerationConfig(max_new_tokens=4), **kw)
    order = []
    name = "_admit" if kind == "contiguous" else "_try_admit"
    _log_calls(sch, name, order, lambda req: req.rid)
    outs = []
    for s in (jsch, sch):
        rids = [s.submit(p, priority=q) for p, q in zip(prompts, prios)]
        s.run_until_idle()
        outs.append([list(np.asarray(s.result(r))) for r in rids])
    jorder = [e["attrs"]["rid"] for e in rec.events(kind="serving.admit")]
    assert order == jorder == [0, 2, 4, 1, 3]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("depth", [0, 2])
def test_preemption_order_and_token_identical_resume_like_jax(engines, depth):
    """9 blocks of 4 cannot hold three requests of 4 + 12 tokens: the
    paged engine preempts BATCH first although it is the oldest, never
    INTERACTIVE while a lower class runs, and every stream, the resumed
    ones included, equals the JAX engine's."""
    jeng, teng = engines
    prompts = _prompts((4, 4, 4), seed=7)
    prios = [Priority.BATCH, Priority.STANDARD, Priority.INTERACTIVE]
    kw = {"slots": 3, "decode_chunk": 2, "block_size": 4, "num_blocks": 9,
          "prefill_chunk": 8, "prefix_cache": False, "pipeline_depth": depth}
    rec = FlightRecorder()
    jsch = jserving.PagedContinuousBatchingEngine(
        jeng, gen=JGen(max_new_tokens=12), recorder=rec, **kw)
    sch = PagedContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=12), **kw)
    pre = []
    _log_calls(sch, "_preempt", pre, lambda slot: sch._slot_req[slot].rid)
    outs = []
    for s in (jsch, sch):
        rids = [s.submit(p, priority=q) for p, q in zip(prompts, prios)]
        s.run_until_idle()
        outs.append([list(np.asarray(s.result(r))) for r in rids])
    jpre = [e["attrs"]["rid"] for e in rec.events(kind="serving.preempt")]
    assert pre and pre[0] == 0 and 2 not in pre
    assert pre == jpre
    assert outs[0] == outs[1]
    solo = [list(teng.generate(p[None], GenerationConfig(max_new_tokens=12))[0])
            for p in prompts]
    assert outs[1] == solo
    assert sch.pool.in_use == 0 and sch.preemptions == len(pre)


def test_queued_interactive_head_preempts_running_batch_like_jax(engines):
    """A queued INTERACTIVE head that cannot get blocks preempts strictly
    lower-priority running work (newest BATCH first) for them; the
    preempted stream resumes token-identical."""
    jeng, teng = engines
    long_p, short_p = _prompts((12, 10), seed=3)
    kw = {"slots": 2, "decode_chunk": 2, "block_size": 4, "num_blocks": 6,
          "prefill_chunk": 4, "prefix_cache": False, "pipeline_depth": 2}
    rec = FlightRecorder()
    jsch = jserving.PagedContinuousBatchingEngine(
        jeng, gen=JGen(max_new_tokens=8), recorder=rec, **kw)
    sch = PagedContinuousBatchingEngine(teng, gen=GenerationConfig(max_new_tokens=8), **kw)
    pre = []
    _log_calls(sch, "_preempt", pre, lambda slot: sch._slot_req[slot].rid)
    outs = []
    for s in (jsch, sch):
        rb = s.submit(long_p, priority="batch")
        for _ in range(4):
            s.step()
        ri = s.submit(short_p, priority="interactive")
        s.run_until_idle()
        outs.append([list(np.asarray(s.result(r))) for r in (rb, ri)])
    jpre = [e["attrs"]["rid"] for e in rec.events(kind="serving.preempt")]
    assert pre == jpre and pre[0] == 0
    assert outs[0] == outs[1]
    assert sch.pool.in_use == 0


# -------------------------------------------------------------- deadlines


def test_result_deadline_cancels_in_flight_and_frees(engines):
    """At ``pipeline_depth`` 2: ``result(deadline_s=)`` raises a typed
    ``DeadlineExceededError``, and the request's slot and blocks free at
    once (the pool's free count back to what it was before it)."""
    _, teng = engines
    sch = PagedContinuousBatchingEngine(
        teng, slots=1, gen=GenerationConfig(max_new_tokens=24), decode_chunk=2,
        block_size=4, prefix_cache=False, pipeline_depth=2)
    pr = _prompts((4,))[0]
    free0 = sch.pool.available
    rid = sch.submit(pr)
    for _ in range(3):
        sch.step()
    assert sch.stats()["inflight_chunks"] == 2
    with pytest.raises(DeadlineExceededError) as ei:
        sch.result(rid, deadline_s=1e-4)
    assert ei.value.rid == rid
    st = sch.stats()
    assert st["busy_slots"] == 0 and st["pool"]["blocks_in_use"] == 0
    assert sch.pool.available == free0 and st["inflight_chunks"] == 0
    assert (sch._block_table == sch.pool.num_blocks).all()
    with pytest.raises(DeadlineExceededError):
        sch.result(rid)  # sticky on the failure
    assert len(sch.result(sch.submit(pr))) == 24
    assert sch.stats()["admission"]["deadline_miss_total"] == 1


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_cancel_with_chunks_in_flight_leaves_the_co_tenant_alone(engines, kind):
    _, teng = engines
    a, b = _prompts((6, 5), seed=4)
    gen = GenerationConfig(max_new_tokens=20)
    kw = {"slots": 2, "decode_chunk": 2, "pipeline_depth": 2}
    if kind == "paged":
        sch = PagedContinuousBatchingEngine(teng, gen=gen, block_size=4,
                                            prefill_chunk=4, prefix_cache=False, **kw)
    else:
        sch = ContinuousBatchingEngine(teng, gen=gen, prefill_block=4, **kw)
    ra, rb = sch.submit(a), sch.submit(b)
    for _ in range(5):
        sch.step()
    assert sch.stats()["inflight_chunks"] == 2
    assert sch.cancel(rb) and not sch.cancel(rb)
    if kind == "paged":
        slot_a = sch._requests[ra].slot
        assert sch.pool.in_use == len(sch._slot_blocks[slot_a])
    with pytest.raises(ServingError, match="cancelled"):
        sch.result(rb)
    solo = teng.generate(a[None], gen)[0]
    np.testing.assert_array_equal(sch.result(ra), solo)
    assert sch.stats()["admission"]["cancelled_total"] == 1
    # the freed slot serves a new request token-identically
    np.testing.assert_array_equal(sch.result(sch.submit(b)), teng.generate(b[None], gen)[0])


def test_unmeetable_deadline_refused_at_submit(engines):
    _, teng = engines
    sch = ContinuousBatchingEngine(teng, slots=1, prefill_block=4,
                                   gen=GenerationConfig(max_new_tokens=6))
    pr = _prompts((4,))[0]
    sch.result(sch.submit(pr))  # prime the TPOT EWMA
    with pytest.raises(DeadlineExceededError, match="provably unmeetable"):
        sch.submit(pr, max_new=20, deadline_s=1e-5)
    assert sch.stats()["admission"]["deadline_miss_total"] == 1
    # a cold engine cannot prove it: admitted, then expired by the loop
    cold = ContinuousBatchingEngine(teng, slots=1, prefill_block=4,
                                    gen=GenerationConfig(max_new_tokens=6))
    rid = cold.submit(pr, max_new=20, deadline_s=1e-5)
    with pytest.raises(DeadlineExceededError):
        cold.result(rid)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_queued_deadline_expires_like_jax(engines, kind):
    jeng, teng = engines
    pr = _prompts((4,))[0]
    kw = {"slots": 1}
    kw.update({"prefill_block": 4} if kind == "contiguous"
              else {"block_size": 4, "prefill_chunk": 4})
    jcls = (jserving.ContinuousBatchingEngine if kind == "contiguous"
            else jserving.PagedContinuousBatchingEngine)
    cls = ContinuousBatchingEngine if kind == "contiguous" else PagedContinuousBatchingEngine
    outs = []
    for s in (jcls(jeng, gen=JGen(max_new_tokens=10), **kw),
              cls(teng, gen=GenerationConfig(max_new_tokens=10), **kw)):
        ra = s.submit(pr)
        rb = s.submit(pr, deadline_s=1e-4)  # queued behind ra's stream
        s.run_until_idle()
        outs.append([_outcome(s, ra), _outcome(s, rb)])
    assert outs[0] == outs[1] and outs[1][1] == "deadline"
    st = s.stats()["admission"]
    assert st["deadline_miss_total"] == 1 and st["shed_total"] == 0
