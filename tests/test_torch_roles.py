"""PyTorch port, the roles that touch tensors: roles/worker.py
(``StageRunner``, ``WorkerNode``), roles/user.py (the partitioners,
``DistributedJob``, ``UserNode``), roles/validator.py (``ValidatorNode``,
``audit_stage``) and roles/pol.py, held against the JAX package's roles
on the same seeded inputs, with params carried across by ``convert.py``
(f32, rtol 1e-5 unless a case says otherwise).

- ``StageRunner``: forward, backward and ``apply_step`` equal the JAX
  runner's; the train-mode recompute reproduces its dropout mask; the
  fence and the STEP_END idempotency hold.
- The partitioners give the reference's splits (module types and byte
  sizes per stage).
- A port fleet (validator, two workers, user) trains the reference
  suite's MLP for 5 SGD steps with losses equal to an all-reference
  fleet's; so does a mixed fleet (port user, reference validator, one
  reference worker, one port worker).
- PoL audits pass an honest worker and fail a cheating one and one whose
  params were perturbed; elastic recovery, ``dp_factor`` 2, inference
  ``forward``, memory stats, teardown and the ownership refusals.
"""

import asyncio
import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.config import NodeConfig as JNodeConfig
from tensorlink_tpu.models.mlp import MLP as JMLP
from tensorlink_tpu.models.mlp import MLPConfig as JMLPConfig
from tensorlink_tpu.roles.registry import InMemoryRegistry as JRegistry
from tensorlink_tpu.roles.user import UserNode as JUserNode
from tensorlink_tpu.roles.user import partition_sequential as jpartition_sequential
from tensorlink_tpu.roles.user import partition_tree as jpartition_tree
from tensorlink_tpu.roles.validator import ValidatorNode as JValidatorNode
from tensorlink_tpu.roles.worker import StageRunner as JStageRunner
from tensorlink_tpu.roles.worker import WorkerNode as JWorkerNode
from tensorlink_tpu.train.optim import make_optimizer as jmake_optimizer
from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
from tensorlink_tpu_torch.nn.layers import Dense, Dropout
from tensorlink_tpu_torch.nn.module import Parallel, Sequential, module_from_config
from tensorlink_tpu_torch.roles import pol
from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
from tensorlink_tpu_torch.roles.user import (
    UserNode,
    partition_sequential,
    partition_tree,
)
from tensorlink_tpu_torch.roles.validator import ValidatorNode
from tensorlink_tpu_torch.roles.worker import StageRunner, StaleFenceError, WorkerNode
from tensorlink_tpu_torch.train.optim import make_optimizer

from jax_reference import reference

KEY = jax.random.key(0)
CFG = dict(in_dim=16, hidden_dim=32, out_dim=4, num_layers=2)
TWO_STAGES = 16 * 32 * 4 + 200  # splits the MLP between its Dense layers
SGD = {"optimizer": "sgd", "learning_rate": 0.05}


@pytest.fixture(scope="module")
def mlp():
    jm = JMLP(JMLPConfig(**CFG))
    jp = jm.init(KEY)
    tm = MLP(MLPConfig(**CFG), device="cpu", seed=None)
    tp = params_from_jax(jax.device_get(jp["seq"]))
    tm.seq.load_state_dict(tp)
    return jm, jp, tm, tp


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(16, 4)), -1)
    return x, y


def _jax_loss_grad(y):
    def loss_grad(logits, micro):
        yj = jnp.asarray(np.array_split(y, 2)[micro])

        def f(lg):
            logz = jax.nn.logsumexp(lg, axis=-1)
            ll = jnp.take_along_axis(lg, yj[:, None], axis=-1)[..., 0]
            return jnp.mean(logz - ll)

        val, g = jax.value_and_grad(f)(jnp.asarray(logits))
        return float(val), np.asarray(g)

    return loss_grad


def _torch_loss_grad(y):
    yt = torch.from_numpy(y)

    def loss_grad(logits, micro):
        lt = torch.as_tensor(logits).float().requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(lt, torch.tensor_split(yt, 2)[micro])
        (g,) = torch.autograd.grad(loss, lt)
        return float(loss.detach()), g

    return loss_grad


def _cfg(role, **kw):
    return NodeConfig(role=role, host="127.0.0.1", port=0, **kw)


def _jcfg(role):
    return JNodeConfig(role=role, host="127.0.0.1", port=0)


async def _fleet(n_workers=2, *, user="port", validator="port",
                 workers=("port", "port")):
    """A validator, ``n_workers`` workers and a user, each from the port
    or the reference as asked, over 127.0.0.1."""
    workers = list(workers) + ["port"] * (n_workers - len(workers))
    if validator == "port":
        val = ValidatorNode(_cfg("validator"), registry=InMemoryRegistry(),
                            device="cpu")
    else:
        val = JValidatorNode(_jcfg("validator"), registry=JRegistry())
    await val.start()
    ws = []
    for kind in workers[:n_workers]:
        w = (WorkerNode(_cfg("worker"), device="cpu") if kind == "port"
             else JWorkerNode(_jcfg("worker")))
        await w.start()
        await w.connect("127.0.0.1", val.port)
        ws.append(w)
    u = UserNode(_cfg("user")) if user == "port" else JUserNode(_jcfg("user"))
    await u.start()
    vpeer = await u.connect("127.0.0.1", val.port)
    return val, ws, u, vpeer


async def _stop(*nodes):
    for n in nodes:
        await n.stop()


def _runner(cls, mod, params, opt, **kw):
    if cls is StageRunner:
        kw.setdefault("device", "cpu")
    return cls(job_id="j", stage_index=0, module=mod, params=params, opt=opt,
               opt_state=opt.init(params), **kw)


# ------------------------------------------------------------ the runner


def test_stage_runner_forward_backward_step_equal_jax(mlp):
    """Forward, the recomputing backward (input and param cotangents) and
    two SGD steps over two micros each equal the JAX runner's."""
    jm, jp, tm, tp = mlp
    jr = _runner(JStageRunner, jm.seq, jp["seq"], jmake_optimizer("sgd", 0.1, 0.0))
    tr = _runner(StageRunner, module_from_config(tm.seq.config(), device="cpu"),
                 dict(tp), make_optimizer("sgd", 0.1, 0.0))
    r = np.random.default_rng(3)
    for step in range(2):
        for micro in range(2):
            x = r.normal(size=(4, 16)).astype(np.float32)
            g = r.normal(size=(4, 4)).astype(np.float32)
            jout = jr.forward(step, micro, x)
            tout = tr.forward(step, micro, torch.from_numpy(x))
            np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-5, atol=1e-6)
            jgx = jr.backward(step, micro, g)
            tgx = tr.backward(step, micro, torch.from_numpy(g))
            np.testing.assert_allclose(tgx.numpy(), jgx, rtol=1e-5, atol=1e-6)
        for name, jg in params_from_jax(jax.device_get(jr.grad_accum)).items():
            np.testing.assert_allclose(tr.grad_accum[name].numpy(), jg.numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert jr.apply_step(step) and tr.apply_step(step)
    for name, jv in params_from_jax(jax.device_get(jr.params)).items():
        np.testing.assert_allclose(tr.params[name].numpy(), jv.numpy(),
                                   rtol=1e-5, atol=1e-6)
    stats = tr.memory_stats()
    assert set(stats) == {"param_bytes", "programs", "peak_program_bytes"}
    assert set(stats["programs"]) == {"fwd", "bwd"}
    assert stats["programs"]["fwd"]["argument_bytes"] > stats["param_bytes"] > 0


def test_stage_runner_train_mode_dropout_recompute():
    """Train-mode dropout: the mask comes from (seed, stage, step, micro),
    backward's recompute reproduces it (its input gradient equals a local
    autograd run under the same generator), eval is dropout-off, and a
    job that shipped no seed ignores the train flag."""
    mod = Sequential([Dense(16, 32, device="cpu"), Dropout(0.4),
                      Dense(32, 4, device="cpu")])
    torch.manual_seed(0)
    for p_ in mod.parameters():
        p_.data.normal_()
    params = {k: v.detach().clone() for k, v in mod.named_parameters()}
    opt = make_optimizer("sgd", 0.1)

    def mk(seed):
        return StageRunner(job_id="j", stage_index=1, module=mod, params=params,
                           opt=opt, opt_state=opt.init(params), train_seed=seed,
                           device="cpu")

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32))
    runner = mk(7)
    ev = runner.forward(0, 0, x)
    with torch.no_grad():
        torch.testing.assert_close(ev, mod(x), rtol=0, atol=0)
    tr = runner.forward(0, 1, x, 0, True)
    assert not torch.equal(tr, ev)
    torch.testing.assert_close(tr, mk(7).forward(0, 1, x, 0, True), rtol=0, atol=0)
    assert not torch.equal(tr, mk(7).forward(1, 1, x, 0, True))
    g = torch.ones((4, 4))
    gx = runner.backward(0, 1, g)
    xx = x.clone().requires_grad_(True)
    out = mod(xx, rng=runner._generator(0, 1), train=True)
    torch.testing.assert_close(out.detach(), tr, rtol=0, atol=0)
    (gx_ref,) = torch.autograd.grad(out, xx, g)
    torch.testing.assert_close(gx, gx_ref, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(mk(None).forward(0, 0, x, 0, True), ev, rtol=0, atol=0)


def test_step_end_idempotent_and_stale_fence(mlp):
    _jm, _jp, tm, tp = mlp
    opt = make_optimizer("sgd", 0.1, 0.0)
    r = _runner(StageRunner, module_from_config(tm.seq.config(), device="cpu"),
                dict(tp), opt)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32))
    out = r.forward(0, 0, x)
    r.backward(0, 0, torch.ones_like(out))
    assert r.apply_step(0) is True
    after = {k: v.clone() for k, v in r.params.items()}
    out = r.forward(0, 0, x, fence=r.fence)
    r.backward(0, 0, torch.ones_like(out), fence=r.fence)
    assert r.apply_step(0) is False  # the retried logical step is skipped
    for k in after:
        torch.testing.assert_close(r.params[k], after[k], rtol=0, atol=0)
    assert r.grad_accum is None and r.micro_seen == 0
    # a backward landing after an abort advanced the fence
    out = r.forward(1, 0, x, fence=0)
    r.fence = 1
    r.reset_step()
    with pytest.raises(StaleFenceError):
        r.backward(1, 0, torch.ones_like(out), fence=0)
    assert r.grad_accum is None and r.micro_seen == 0
    with pytest.raises(ValueError, match="local tensor"):
        _runner(StageRunner, r.module, dict(tp), opt, devices=[0, 1])


# -------------------------------------------------------- partitioners


def _stage_sig(parts):
    from tensorlink_tpu.utils.trees import tree_bytes as jtree_bytes
    from tensorlink_tpu_torch.nn.staging import param_bytes

    out = []
    for seq, p in parts:
        types = [type(m).__name__ for m in seq.layers]
        out.append((types, param_bytes(p) if isinstance(seq, Sequential)
                    and any(isinstance(v, torch.Tensor) for v in _leaves(p))
                    else jtree_bytes(p)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("cap", [TWO_STAGES, 1e9, 1.0])
def test_partition_sequential_equals_reference(mlp, cap):
    jm, jp, tm, tp = mlp
    jparts = jpartition_sequential(jm.seq, jp["seq"], cap)
    tparts = partition_sequential(tm.seq, tp, cap)
    assert _stage_sig(tparts) == _stage_sig(jparts)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32))
    h = x
    for seq, p in tparts:
        from tensorlink_tpu_torch.utils.trees import flatten

        h = torch.func.functional_call(seq, flatten(p), (h,))
    with torch.no_grad():
        torch.testing.assert_close(h, tm.seq(x), rtol=1e-6, atol=1e-6)


def test_partition_tree_equals_reference():
    """A two-branch ``Parallel`` over budget linearizes into the
    reference's chain (AppendTail, TailMap per branch unit, CombineTail),
    with packing offsets from a meta-device run."""
    from tensorlink_tpu.nn.layers import Dense as JDense
    from tensorlink_tpu.nn.module import Parallel as JParallel
    from tensorlink_tpu.nn.module import Sequential as JSequential

    jmodel = JSequential([JDense(8, 16), JParallel(
        [JSequential([JDense(16, 16), JDense(16, 8)]), JDense(16, 8)],
        combine="concat")])
    jp = jmodel.init(KEY)
    tmodel = module_from_config(jmodel.config(), device="cpu")
    tp = params_from_jax(jax.device_get(jp))
    cap = 16 * 16 * 4 + 100
    jparts = jpartition_tree(jmodel, jp, cap,
                             example=jax.ShapeDtypeStruct((2, 8), jnp.float32))
    tparts = partition_tree(tmodel, tp, cap, example=torch.zeros(2, 8))
    assert _stage_sig(tparts) == _stage_sig(jparts)
    assert [s.config() for s, _ in tparts] == [s.config() for s, _ in jparts]
    x = np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32)
    jh, th = jnp.asarray(x), torch.from_numpy(x)
    from tensorlink_tpu_torch.utils.trees import flatten

    for (js, jsp), (ts, tsp) in zip(jparts, tparts):
        jh = js.apply(jsp, jh)
        th = torch.func.functional_call(ts, flatten(tsp), (th,))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="example"):
        partition_tree(tmodel, tp, cap)
    assert isinstance(tmodel.layers[1], Parallel)


# ------------------------------------------------------------- fleets

async def _train_losses(kind: str, mlp) -> list[float]:
    jm, jp, tm, tp = mlp
    x, y = _data()
    if kind == "reference":
        val, ws, u, vpeer = await _fleet(user="ref", validator="ref",
                                         workers=("ref", "ref"))
        model, params, lg, xin = jm.seq, jp["seq"], _jax_loss_grad(y), x
    else:
        workers = ("port", "port") if kind == "port" else ("ref", "port")
        val, ws, u, vpeer = await _fleet(
            validator="port" if kind == "port" else "ref", workers=workers)
        model, params, lg, xin = tm.seq, tp, _torch_loss_grad(y), torch.from_numpy(x)
    try:
        job = await u.request_job(model, params, vpeer, max_stage_bytes=TWO_STAGES,
                                  micro_batches=2, train=SGD)
        holders = {st.peer.node_id for st in job.stages}
        assert holders == {w.node_id for w in ws}
        return [await job.train_step(xin, lg) for _ in range(5)]
    finally:
        await _stop(u, val, *ws)


@pytest.mark.asyncio
@pytest.mark.parametrize("kind", ["port", "mixed"])
async def test_fleet_trains_like_reference_fleet(mlp, kind, tmp_path_factory):
    """5 SGD steps of the MLP over two stages, two micro-batches: the port
    fleet's (and the mixed fleet's) losses equal the all-reference
    fleet's (rtol 1e-5), and the loss falls."""
    def ref_fleet():
        # the reference fleet on an event loop of its own (computed once a
        # session, whichever worker asks first)
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            return ex.submit(asyncio.run, _train_losses("reference", mlp)).result()

    ref = reference(tmp_path_factory, "roles-reference-fleet-losses", ref_fleet)
    losses = await _train_losses(kind, mlp)
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    assert losses[-1] < losses[0]


@pytest.mark.asyncio
async def test_placement_report_shutdown_and_refusals(mlp):
    """Placement on distinct workers, the DHT record, JOB_UPDATE,
    fetch_params, the chain ledger, teardown, and the ownership checks:
    a stranger's MODULE_SPEC and UNLOAD are refused."""
    _jm, _jp, tm, tp = mlp
    val, ws, u, vpeer = await _fleet()
    attacker = UserNode(_cfg("user"))
    await attacker.start()
    try:
        ledger = InMemoryRegistry()
        job = await u.request_job(tm.seq, tp, vpeer, max_stage_bytes=TWO_STAGES,
                                  micro_batches=2, train=SGD,
                                  chain_registry=ledger, chain_payment_milli=3)
        assert len({st.peer.node_id for st in job.stages}) == 2
        wire = await u.dht_query(f"job:{job.job.job_id}")
        assert wire is not None and wire["author"] == u.node_id
        x, y = _data()
        loss = await job.train_step(torch.from_numpy(x), _torch_loss_grad(y))
        await job.report(vpeer, loss)
        assert val.job_state[job.job.job_id]["loss"] == pytest.approx(loss)
        fetched = await job.fetch_params()
        assert set(fetched[0]) == {"0", "1"} and fetched[0]["1"] == {}
        assert not torch.equal(fetched[0]["0"]["w"], tp["0.w"])

        w = next(w for w in ws if w.node_id == job.stages[0].peer.node_id)
        before = {k: v.clone() for k, v in w.stages[(job.job.job_id, 0)].params.items()}
        a_peer = await attacker.connect("127.0.0.1", w.port)
        from tensorlink_tpu_torch.p2p.serialization import pack_arrays

        r = await attacker.request(a_peer, {
            "type": "MODULE_SPEC", "job_id": job.job.job_id, "stage": 0,
            "module_config": job.job.stages[0].module_config,
            "weights": pack_arrays({k: torch.zeros_like(v) for k, v in before.items()}),
        })
        assert r["type"] == "ERROR" and "unauthorized" in r["error"]
        for k, v in w.stages[(job.job.job_id, 0)].params.items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
        r = await attacker.request(a_peer, {"type": "UNLOAD", "job_id": job.job.job_id})
        assert r["type"] == "ERROR"
        w._reservations[("pending", 0)] = (1 << 20, time.time() + 60, u.node_id)
        r = await attacker.request(a_peer, {"type": "UNLOAD", "job_id": "pending"})
        assert r["type"] == "ERROR" and ("pending", 0) in w._reservations

        assert ledger.job_onchain(1)["completed"] is False
        assert await job.shutdown() == 2
        assert all(not w.stages for w in ws)
        assert ledger.job_onchain(1)["completed"] is True
    finally:
        await _stop(u, attacker, val, *ws)


@pytest.mark.asyncio
async def test_pol_audits_honest_cheating_and_perturbed(mlp):
    """The validator replays the stage from the approved spec: an honest
    worker passes by exact digest (both ends on the CPU: platform
    ``torch-cpu``); a worker that corrupts its output commitment, and one
    whose params were perturbed after the fact, fail and are slashed."""
    _jm, _jp, tm, tp = mlp
    val, ws, u, vpeer = await _fleet(n_workers=1, workers=("port",))
    try:
        job = await u.request_job(tm.seq, tp, vpeer, micro_batches=1,
                                  train={"optimizer": "sgd", "learning_rate": 0.0})
        jid = job.job.job_id
        rec = await val.audit_stage(jid, 0, in_shape=(4, 16), seed=7)
        assert rec["passed"] is True and rec["forward_ok"] and rec["grad_ok"]
        w = ws[0]
        # same challenge twice: identical digests
        proofs = [await u.request(job.stages[0].peer, {
            "type": "POL_CHALLENGE", "job_id": jid, "stage": 0, "seed": 3,
            "shape": [4, 16]}) for _ in range(2)]
        assert proofs[0]["digest"] == proofs[1]["digest"]
        assert proofs[0]["output"]["platform"] == "torch-cpu"
        honest = w._handlers["POL_CHALLENGE"]

        async def cheat(node, peer, msg):
            proof = await honest(node, peer, msg)
            proof["output"] = dict(proof["output"], digest="0" * 64)
            return proof

        w._handlers["POL_CHALLENGE"] = cheat
        rec = await val.audit_stage(jid, 0, in_shape=(4, 16), seed=8)
        assert rec["passed"] is False
        assert val.dht.get_local(f"rep:{w.node_id}") == 0.0
        w._handlers["POL_CHALLENGE"] = honest
        runner = w.stages[(jid, 0)]
        params = dict(runner.params)
        runner.params = {k: v + 1e-3 for k, v in params.items()}

        async def stale_weights(node, peer, msg):
            # a worker that computes with perturbed params but ships the
            # digest and weights it was given
            proof = await honest(node, peer, msg)
            runner.params = params
            from tensorlink_tpu_torch.p2p.serialization import pack_arrays

            proof["weights"] = pack_arrays(w._wire_tree(runner, params))
            proof["params_digest"] = pol.params_digest(w._wire_tree(runner, params))
            runner.params = {k: v + 1e-3 for k, v in params.items()}
            return proof

        w._handlers["POL_CHALLENGE"] = stale_weights
        rec = await val.audit_stage(jid, 0, in_shape=(4, 16), seed=9)
        assert rec["passed"] is False and rec["forward_ok"] is False
        assert [a["passed"] for a in val.job_state[jid]["audits"]] == [True, False, False]
    finally:
        await _stop(u, val, *ws)


def test_pol_commitment_and_challenge_stream():
    x = torch.linspace(-1, 1, 64).reshape(8, 8)
    proof = pol.commitment(x)
    assert proof["platform"] == "torch-cpu"
    assert pol.verify_commitment(x, proof)
    foreign = dict(proof, platform="cpu")  # a reference node's tag
    assert pol.verify_commitment(x + 1e-7, foreign)
    assert not pol.verify_commitment(x + 1.0, foreign)
    a = pol.challenge_input(3, (2, 5))
    torch.testing.assert_close(a, pol.challenge_input(3, (2, 5)), rtol=0, atol=0)
    assert not torch.equal(a, pol.challenge_input(4, (2, 5)))
    big = pol.challenge_input(0, (64, 64))
    assert abs(float(big.mean())) < 0.1 and abs(float(big.std()) - 1.0) < 0.1
    assert pol.challenge_input(3, (2, 5), "bfloat16").dtype == torch.bfloat16


@pytest.mark.asyncio
async def test_elastic_recovery_and_inference_forward(mlp):
    """Kill the stage-1 worker mid-run with a spare connected: the next
    step aborts, re-recruits, re-ships the cached params and retries; the
    loss keeps falling. ``forward`` then returns the chain's output and
    leaves no stashed activation on any worker."""
    _jm, _jp, tm, tp = mlp
    val, ws, u, vpeer = await _fleet(n_workers=3)
    victim_id = None
    try:
        job = await u.request_job(tm.seq, tp, vpeer, max_stage_bytes=TWO_STAGES,
                                  micro_batches=2, train=SGD)
        x, y = _data()
        xt, lg = torch.from_numpy(x), _torch_loss_grad(y)
        losses = [await job.train_step(xt, lg) for _ in range(3)]
        await job.checkpoint_stages()
        victim_id = job.stages[1].peer.node_id
        await next(w for w in ws if w.node_id == victim_id).stop()
        losses += [await job.train_step(xt, lg) for _ in range(3)]
        assert job.stages[1].peer.node_id != victim_id
        assert losses[-1] < losses[2], losses
        assert val.job_state[job.job.job_id]["replacements"][0]["stage"] == 1
        out = await job.forward(xt[:8])
        fetched = await job.fetch_params()
        h = xt[:8]
        from tensorlink_tpu_torch.utils.trees import flatten

        for (seq, _), p in zip(
                partition_sequential(tm.seq, tp, TWO_STAGES), fetched):
            h = torch.func.functional_call(seq, flatten(p), (h,))
        torch.testing.assert_close(out, h, rtol=1e-5, atol=1e-6)
        for w in ws:
            if w.node_id != victim_id:
                assert all(not r.inputs and r.grad_accum is None
                           for r in w.stages.values())
        stats = await val.request(val.peers[job.stages[0].peer.node_id],
                                  {"type": "STATS_REQUEST"})
        entry = next(iter(stats["stage_memory"].values()))
        assert set(entry["programs"]) >= {"fwd", "bwd"}
    finally:
        await _stop(u, val, *[w for w in ws if w.node_id != victim_id])


@pytest.mark.asyncio
async def test_dp_factor_2_replicas_stay_identical(mlp):
    """dp_factor 2 over 2 stages: four slots, micro-batches round-robin
    over the two chains, GRAD_SHARE on STEP_END keeps the replicas
    bitwise identical, and the per-replica audit finds each slot."""
    _jm, _jp, tm, tp = mlp
    val, ws, u, vpeer = await _fleet(n_workers=4)
    try:
        job = await u.request_job(tm.seq, tp, vpeer, max_stage_bytes=TWO_STAGES,
                                  micro_batches=2, dp_factor=2, train=SGD)
        assert [len(c) for c in job.chains] == [2, 2]
        x, y = _data()
        losses = [await job.train_step(torch.from_numpy(x), _torch_loss_grad(y))
                  for _ in range(4)]
        assert losses[-1] < losses[0]
        jid = job.job.job_id
        for idx in (0, 1):
            runners = [next(w for w in ws if w.node_id == st.peer.node_id).stages[(jid, idx)]
                       for st in job.stages if st.index == idx]
            for k in runners[0].params:
                torch.testing.assert_close(runners[0].params[k], runners[1].params[k],
                                           rtol=0, atol=0)
        assert all(not w._grad_inbox for w in ws)
        recs = [await val.audit_stage(jid, 1, in_shape=(4, 32), replica=r) for r in (0, 1)]
        assert all(r["passed"] for r in recs) and recs[0]["worker"] != recs[1]["worker"]
    finally:
        await _stop(u, val, *ws)


def test_validate_train_meta_and_lora_refusal():
    assert WorkerNode._validate_train_meta(
        {"train": {"optimizer": "adam", "moment_dtype": "bfloat16"}}) is None
    err = WorkerNode._validate_train_meta({"train": {"moment_dtype": "bf16"}})
    assert err is not None and "moment_dtype" in err["error"]
    err = WorkerNode._validate_train_meta(
        {"train": {"optimizer": "sgd", "moment_dtype": "bfloat16"}})
    assert err is not None and "sgd" in err["error"]
    err = WorkerNode._validate_train_meta({"train": {"train_only": "all"}})
    assert err is not None and "train_only" in err["error"]


class _WriteLog(dict):
    """A dict that records the thread of every write into it."""

    def __init__(self):
        super().__init__()
        self.writers = set()

    def __setitem__(self, key, value):
        import threading

        self.writers.add(threading.get_ident())
        super().__setitem__(key, value)


@pytest.mark.asyncio
async def test_stage_installs_publish_on_the_loop_under_stats(mlp):
    """C13: a one-shot MODULE_SPEC builds its runner (device transfer,
    optimizer state) off the event loop, but registers it on the loop:
    ``self.stages`` and ``self.training``, which STATS iterates and reads
    there, are written by the loop's thread only. A scraper hammers
    STATS_REQUEST while eight stages install at once; every reply is a
    STATS and every install a LOADED."""
    import threading

    from tensorlink_tpu_torch.p2p.serialization import pack_arrays

    _jm, _jp, tm, tp = mlp
    w = WorkerNode(_cfg("worker"), device="cpu")
    u, scraper = UserNode(_cfg("user")), UserNode(_cfg("user"))
    for n in (w, u, scraper):
        await n.start()
    w.stages = _WriteLog()
    loop_thread = threading.get_ident()
    try:
        peer = await u.connect("127.0.0.1", w.port)
        speer = await scraper.connect("127.0.0.1", w.port)
        (seq0, _), _ = partition_sequential(tm.seq, tp, TWO_STAGES)
        weights = pack_arrays({k: v for k, v in tp.items() if k.startswith("0.")})
        stop, replies = asyncio.Event(), []

        async def scrape():
            while not stop.is_set():
                replies.append(await scraper.request(speer, {"type": "STATS_REQUEST"}))

        task = asyncio.ensure_future(scrape())
        acks = await asyncio.gather(*(
            u.request(peer, {"type": "MODULE_SPEC", "job_id": f"job-{i}", "stage": 0,
                             "module_config": seq0.config(), "weights": weights,
                             "train": SGD})
            for i in range(8)))
        stop.set()
        await task
        assert [a["type"] for a in acks] == ["LOADED"] * 8, acks
        assert len(w.stages) == 8 and w.training
        assert w.stages.writers == {loop_thread}
        assert replies and all(r["type"] == "STATS" for r in replies), replies[-1]
        assert (await scraper.request(speer, {"type": "STATS_REQUEST"}))["stages_loaded"] == 8
    finally:
        await _stop(u, scraper, w)
