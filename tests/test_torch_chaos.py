"""PyTorch port, runtime/chaos.py (a copy of the reference's harness) and
the serving hooks, plus ``asubmit`` / ``aresult``, on the CPU:

- the same plan, seed and call sequence give the JAX harness's log and
  jitter draws exactly; ``to_dict``/``from_dict`` round-trip; a disarmed
  hook runs nothing;
- both serving engines under a plan with ``serving.dispatch`` slows and a
  ``serving.drain`` stall emit the JAX engines' tokens under the same
  plan, with the same firing log, and their own unfaulted tokens;
- eight requests through ``asubmit``/``aresult`` from one event loop,
  two ``aresult`` calls at a time, give ``submit``/``result``'s tokens."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import MeshConfig
from tensorlink_tpu.models.llama import Llama as JLlama
from tensorlink_tpu.models.llama import LlamaConfig as JLlamaConfig
from tensorlink_tpu.parallel.inference import GenerationConfig as JGen
from tensorlink_tpu.parallel.inference import InferenceEngine as JEngine
from tensorlink_tpu.parallel.serving import (
    ContinuousBatchingEngine as JContiguous,
    PagedContinuousBatchingEngine as JPaged,
)
from tensorlink_tpu.runtime import chaos as jchaos
from tensorlink_tpu.runtime.mesh import make_mesh
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    Priority,
)
from tensorlink_tpu_torch.runtime import chaos


def _plan(mod, seed=7):
    return (mod.ChaosPlan(seed=seed)
            .fault("serving.dispatch", "slow", every=3, delay_s=0.001, jitter_s=0.002)
            .fault("serving.drain", "slow", at=2, delay_s=0.005)
            .fault("p2p.send", "drop", every=2, match={"type": "DHT_QUERY"}, count=2)
            .fault("node.kill", "kill", at=1, handler="stop0"))


def _script(mod):
    """One call sequence against a fresh harness; -> (log, actions, kills)."""
    h = mod.ChaosHarness(_plan(mod))
    kills = []
    h.on_kill("stop0", lambda **kw: kills.append(kw))
    acts = []
    for i in range(12):
        acts.append(h.actions("serving.dispatch", program="decode"))
        acts.append(h.actions("p2p.send", type="DHT_QUERY" if i % 3 else "PING"))
        if i % 4 == 0:
            acts.append(h.actions("serving.drain"))
    acts.append(h.actions("node.kill", node=0))
    return h.log, acts, kills, h.counts()


def test_log_equals_the_reference_harness():
    assert _script(chaos) == _script(jchaos)
    # and replays byte for byte
    assert _script(chaos) == _script(chaos)


def test_plan_round_trips_and_validates():
    plan = _plan(chaos)
    d = plan.to_dict()
    assert d == _plan(jchaos).to_dict()
    assert chaos.ChaosPlan.from_dict(d).to_dict() == d
    assert chaos.ChaosPlan.from_dict(d).faults == plan.faults
    with pytest.raises(ValueError, match="action"):
        chaos.Fault("s", "explode", at=1)
    with pytest.raises(ValueError, match="exactly one"):
        chaos.Fault("s", "delay")


def test_disarmed_is_inert_and_arm_installs():
    chaos.disarm()
    assert chaos.ACTIVE is None and chaos.fire("serving.dispatch") == []

    class Sink:
        def __init__(self):
            self.events, self.n = [], 0

        def record(self, kind, severity, **data):
            self.events.append((kind, severity, data))

        def incr(self, name):
            self.n += 1

    sink = Sink()
    h = chaos.arm(chaos.ChaosPlan().fault("x", "delay", at=1), recorder=sink, metrics=sink)
    try:
        assert chaos.ACTIVE is h
        assert chaos.fire("x", tag="a")[0]["action"] == "delay"
        assert chaos.fire("x") == []
        assert sink.n == 1 and sink.events[0][0] == "chaos.delay"
        assert h.apply_sync("y") is False
    finally:
        chaos.disarm()
    assert chaos.ACTIVE is None


# ---------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def pair():
    jm = JLlama(JLlamaConfig.tiny())
    p = jm.init(jax.random.key(0))
    jeng = JEngine(make_mesh(MeshConfig()), jm, p, max_len=32,
                   cache_dtype=jnp.float32, param_dtype=jnp.float32)
    model = Llama(LlamaConfig.tiny(), device="cpu", seed=None)
    teng = InferenceEngine(model, params_from_jax(jax.device_get(p)), max_len=32,
                           device="cpu", cache_dtype=torch.float32,
                           param_dtype=torch.float32)
    r = np.random.default_rng(3)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 3, 7, 6, 4)]
    return jeng, teng, prompts


KW = {
    "contiguous": {"slots": 2, "decode_chunk": 3, "prefill_block": 4},
    "paged": {"slots": 2, "block_size": 8, "num_blocks": 16, "prefill_chunk": 8},
}
STALL = (lambda mod: mod.ChaosPlan(seed=1)
         .fault("serving.dispatch", "slow", every=2, delay_s=0.0, jitter_s=0.002)
         .fault("serving.drain", "slow", at=3, delay_s=0.01))


def _serve(cls, eng, gen, prompts, kw):
    sch = cls(eng, gen=gen, **kw)
    # the first request INTERACTIVE (both packages take the class's value)
    rids = [sch.submit(pr, priority=int(Priority.INTERACTIVE if i == 0 else Priority.STANDARD))
            for i, pr in enumerate(prompts)]
    return [np.asarray(sch.result(rid)) for rid in rids]


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_streams_under_a_drain_stall_equal_jax(pair, kind):
    jeng, teng, prompts = pair
    tcls, jcls = ((ContinuousBatchingEngine, JContiguous) if kind == "contiguous"
                  else (PagedContinuousBatchingEngine, JPaged))
    unfaulted = _serve(tcls, teng, GenerationConfig(max_new_tokens=8), prompts, KW[kind])
    h = chaos.arm(STALL(chaos))
    try:
        port = _serve(tcls, teng, GenerationConfig(max_new_tokens=8), prompts, KW[kind])
    finally:
        chaos.disarm()
    jh = jchaos.arm(STALL(jchaos))
    try:
        ref = _serve(jcls, jeng, JGen(max_new_tokens=8), prompts, KW[kind])
    finally:
        jchaos.disarm()
    for a, b, c in zip(port, ref, unfaulted):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert h.counts()["serving.dispatch"] > 2 and h.counts()["serving.drain"] >= 3
    assert ("serving.drain", 3, "slow") in h.log
    assert h.log == jh.log  # the same hook sequence as the reference


# ------------------------------------------------------------------ async
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_async_api_equals_submit_result(pair, kind):
    _, teng, _ = pair
    tcls = ContinuousBatchingEngine if kind == "contiguous" else PagedContinuousBatchingEngine
    r = np.random.default_rng(9)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 3, 7, 6, 4, 8, 2, 5)]
    gen = GenerationConfig(max_new_tokens=6)
    ref = _serve(tcls, teng, gen, prompts, KW[kind])
    sch = tcls(teng, gen=gen, **KW[kind])

    async def main():
        rids = [await sch.asubmit(pr) for pr in prompts]
        outs = []
        for i in range(0, len(rids), 2):  # two aresults in flight at a time
            outs += await asyncio.gather(sch.aresult(rids[i]), sch.aresult(rids[i + 1]))
        return outs

    outs = asyncio.run(asyncio.wait_for(main(), timeout=120))
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    assert sch.stats()["busy_slots"] == 0
