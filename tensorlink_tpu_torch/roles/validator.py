"""Validator: network backbone — job validation, worker recruitment, PoL
(port of ``tensorlink_tpu/roles/validator.py``; a PoL replay runs on the
validator's ``device``, off the event loop).

As the reference's validator: JOB_REQ is schema-checked
(assert_job_req, validator.py:12-25) and reputation-gated
(validator.py:115-120), the job record is stored in the DHT
(validator.py:186), workers are polled for stats and best-fit recruited
one per stage (validator.py:181-296) — but async with request/response
instead of sleep-polling shared state, and recruitment runs per-stage
concurrently.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.p2p.node import Node, Peer, wire_guard
from tensorlink_tpu_torch.roles.jobs import JobRecord, validate_job_request
from tensorlink_tpu_torch.roles.registry import Registry
from tensorlink_tpu_torch.runtime.ledger import ReceiptAuditor


def roofline_score(cap: dict, leg: str) -> tuple[float, float]:
    """Two-key roofline rank of one fleet capability record for one
    serving leg. Prefill is compute-bound (one weight pass amortized
    over the whole prompt), so its primary key is measured peak bf16
    TFLOPs with HBM GB/s breaking ties; decode is bandwidth-bound
    (every token re-reads the weights + cache), so the keys swap.
    Missing measurements rank 0 — a worker that never published a
    roofline loses to any measured one but stays placeable."""
    t = float(cap.get("peak_tflops") or 0.0)
    b = float(cap.get("hbm_gbps") or 0.0)
    return (t, b) if leg == "prefill" else (b, t)


def plan_serving(
    fleet: dict[str, dict], *, need_blocks: int = 0, need_tokens: int = 0,
    pipeline: int | None = None, need_bytes: int = 0,
) -> dict | None:
    """Place one request's prefill and decode legs from a fleet
    capability table (``{node_id: capability record}`` — the live view
    heartbeat PONGs build on a validator).

    Eligibility: the record must advertise a ``serving_mode`` and —
    when it publishes KV headroom — have at least ``need_blocks`` free
    blocks (the /metrics-backed gauge piggybacked on heartbeats).
    ``need_tokens`` states the requirement in tokens (prompt + budget)
    and converts per candidate through the ``kv_block_size`` its own
    record advertises — block geometry is a worker property, so the
    same request needs a different block count on each worker.
    Prefill goes to the highest :func:`roofline_score` among
    prefill/colocated workers, decode to the highest among
    decode/colocated. When both legs would land on the SAME worker, or
    only one worker is live, the plan degrades to colocated serving —
    preferring colocated-mode workers but accepting a lone single-leg
    worker too (the advertised mode is a placement PREFERENCE; every
    attached engine can run both legs, and a one-worker fleet must
    keep serving).

    Returns ``{"colocated": True, "node": id}`` or ``{"colocated":
    False, "prefill": id, "decode": id}``; None when nothing fits.

    PIPELINE MODE: with ``pipeline`` (a stage count)
    or ``need_bytes`` (model weight bytes no single worker can hold),
    placement delegates to :func:`pipeserve.plan_pipeline` — stage
    workers picked by published ``hbm_bytes``, fewest stages that cover
    the model — and returns ``{"pipeline": True, "stages": [ids],
    "capacities": [bytes]}`` instead (None when the fleet's summed HBM
    cannot hold the model)."""
    if pipeline is not None or need_bytes:
        from tensorlink_tpu_torch.parallel.pipeserve import plan_pipeline

        plan = plan_pipeline(
            fleet, n_stages=pipeline, need_bytes=need_bytes
        )
        if plan is None:
            return None
        return {"pipeline": True, **plan}

    def headroom_ok(c: dict) -> bool:
        free = c.get("kv_blocks_free")
        if free is None:
            return True
        need = need_blocks
        bs = c.get("kv_block_size")
        if need_tokens and bs:
            need = max(need, -(-int(need_tokens) // int(bs)))
        return int(free) >= need

    serving = {
        nid: c for nid, c in fleet.items()
        if c.get("serving_mode") and headroom_ok(c)
    }
    pre = [
        nid for nid, c in serving.items()
        if c["serving_mode"] in ("prefill", "colocated")
    ]
    dec = [
        nid for nid, c in serving.items()
        if c["serving_mode"] in ("decode", "colocated")
    ]
    # node_id is the deterministic final tie-break (unmeasured fleets)
    best_pre = max(
        pre, key=lambda n: (*roofline_score(serving[n], "prefill"), n),
        default=None,
    )
    best_dec = max(
        dec, key=lambda n: (*roofline_score(serving[n], "decode"), n),
        default=None,
    )
    if best_pre is not None and best_dec is not None and best_pre != best_dec:
        return {"colocated": False, "prefill": best_pre, "decode": best_dec}
    colo = [
        nid for nid, c in serving.items()
        if c["serving_mode"] == "colocated"
    ] or list(serving)
    if not colo:
        return None
    return {
        "colocated": True,
        # a lone colocated node serves both legs; rank by the decode
        # roofline — steady-state serving time is decode-dominated
        "node": max(colo, key=lambda n: (*roofline_score(serving[n], "decode"), n)),
    }


class ValidatorNode(Node):
    def __init__(
        self,
        cfg: NodeConfig | None = None,
        registry: Registry | None = None,
        *,
        device=None,
        **kw,
    ):
        cfg = cfg or NodeConfig(role="validator")
        super().__init__(cfg, **kw)
        from tensorlink_tpu_torch import resolve_device

        # where PoL replays run (CUDA unless the caller asks for the CPU)
        self.device = resolve_device(device)
        if registry is None and not cfg.off_chain:
            # chain-backed deployment configured entirely through NodeConfig
            # (reference: .env CONTRACT/CHAIN_URL, smart_node.py:20-30)
            if not (cfg.chain_url and cfg.chain_contract):
                raise ValueError(
                    "off_chain=False requires chain_url and chain_contract"
                )
            from tensorlink_tpu_torch.chain import Web3Registry

            registry = Web3Registry(
                cfg.chain_url, cfg.chain_contract, sender=cfg.chain_sender
            )
        self.registry = registry
        self.jobs: dict[str, JobRecord] = {}
        self.job_state: dict[str, dict] = {}  # job_id -> {loss, accuracy,...}
        # Work-receipt auditor: ingests signed meters harvested from
        # worker PONGs / heartbeats, cross-checks them against the
        # worker's own published capability record and the user-side
        # token observations, and keeps the per-tenant / per-worker
        # ledgers served at GET /ledger. The presence of this attribute
        # is what turns on the receipt piggyback in Node.ping().
        self.receipt_auditor = ReceiptAuditor(
            metrics=self.metrics,
            recorder=self.flight,
            capability_for=self.peer_capabilities.get,
            on_anomaly=self._receipt_demerit,
        )

    def _receipt_demerit(self, wid: str, reason: str) -> None:
        """Reputation demerit for a worker whose receipt was rejected or
        flagged. A metering lie is cheaper to tell than a failed
        re-execution audit is to engineer, so this halves reputation
        instead of zeroing it the way ``_finish_audit`` does — honest
        one-off clock skew survives, repeat offenders converge to 0.
        ``token_mismatch`` is exempt: there the *user's* observation
        disagrees with the claim and either side could be lying."""
        if reason == "token_mismatch":
            return
        peer = self.peers.get(wid)
        rep = peer.reputation if peer is not None else 1.0
        new = max(float(rep), 0.0) * 0.5
        if peer is not None:
            peer.reputation = new
        self.dht.put_local(f"rep:{wid}", new)
        if self.registry is not None:
            async def _demote(reg=self.registry, wid=wid, new=new):
                try:
                    await asyncio.to_thread(reg.set_reputation, wid, new)
                except Exception as e:
                    self.log.warning("registry demerit failed: %s", e)

            self._spawn(_demote())
        self.flight.record(
            "receipt.demerit", "warn",
            worker=wid[:16], reason=reason, reputation=new,
        )

    def on_peer_lost(self, peer: Peer) -> None:
        """A dead worker that holds live placements degrades every job
        it serves: flight event + readiness condition per job, cleared
        when REPLACE_WORKER lands a substitute. /healthz on this
        validator then answers 'can the jobs I placed actually run'."""
        hit = []
        for jid, job in self.jobs.items():
            slots = [
                {"stage": int(w.get("stage", -1)),
                 "replica": int(w.get("replica", 0))}
                for w in (job.workers or [])
                if w and w.get("node_id") == peer.node_id
            ]
            if slots:
                hit.append((jid, slots))
        for jid, slots in hit:
            self.flight.record(
                "placed_worker_lost", "error", job_id=jid[:16],
                worker=peer.node_id[:16], slots=slots,
            )
            self.health.set_condition(
                f"job:{jid[:16]}",
                f"placed worker {peer.node_id[:8]} lost "
                f"(slots {[(s['stage'], s['replica']) for s in slots]})",
            )

    async def start(self) -> None:
        await super().start()
        if self.registry is not None:
            # registry I/O may be chain RPC — never on the event loop
            await asyncio.to_thread(self.registry.register_validator, self.info)
            await asyncio.to_thread(self.registry.refresh)
            self._spawn(self._registry_refresh_loop())

    async def _registry_refresh_loop(self) -> None:
        """Keeps the cached validator view fresh so the DHT store gate
        (is_validator_local) can answer without blocking the loop."""
        while not self._stopping:
            await asyncio.sleep(self.cfg.registry_refresh_s)
            try:
                await asyncio.to_thread(self.registry.refresh)
            except Exception as e:  # noqa: BLE001
                self.log.warning("registry refresh failed: %s", e)

    # ---------------------------------------------------------- handlers
    def register_handlers(self) -> None:
        super().register_handlers()
        self.on("JOB_REQ", self._h_job_req)
        self.on("JOB_UPDATE", self._h_job_update)
        self.on("JOB_INFO", self._h_job_info)
        self.on("REPLACE_WORKER", self._h_replace_worker)
        self.on("JOB_REPLICATE", self._h_job_replicate)
        self.on("SERVE_PLAN", self._h_serve_plan)
        self.on("SERVE_PIPELINE_PLAN", self._h_serve_pipeline_plan)

    def authorize_peer(self, node_id: str, role: str) -> bool:
        """Reputation gate (reference: smart_node.py:329-337)."""
        known = self.dht.get_local(f"rep:{node_id}")
        return known is None or float(known) > 0.0

    def dht_store_allowed(self, peer, key: str) -> bool:
        """Job records are written by validators (replication) only; a
        user's job enters the DHT through the validated JOB_REQ path.
        Validator status is checked against the Registry (the chain-anchored
        identity, reference: smart_node.py:357-379) — peer.role alone is a
        self-declared HELLO field and is NOT trusted."""
        if not super().dht_store_allowed(peer, key):
            return False
        if key.startswith("job:"):
            if self.registry is not None:
                # this gate runs inline in the message handler: cache-only
                # check, refreshed by _registry_refresh_loop
                return self.registry.is_validator_local(peer.node_id)
            return peer.role == "validator"  # off-chain dev mode only
        return True

    def _workers(self) -> list[Peer]:
        return [p for p in self.peers.values() if p.role == "worker"]

    async def _poll_worker_stats(self) -> dict[str, dict]:
        """STATS_REQUEST fanout (reference: request_worker_stats,
        validator.py:315-321)."""
        stats: dict[str, dict] = {}

        async def one(p: Peer):
            try:
                # read-only, so safe to retry: a worker mid-GC or
                # riding out a transient blip still makes the
                # recruitment round instead of vanishing from it
                s = await self.request_idempotent(
                    p, {"type": "STATS_REQUEST"}
                )
                stats[p.node_id] = s
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass

        await asyncio.gather(*(one(p) for p in self._workers()))
        return stats

    async def _recruit_stage(
        self,
        job: JobRecord,
        stage_index: int,
        stats: dict[str, dict],
        taken: set[str],
        replica: int = 0,
    ) -> dict | None:
        """Best-fit recruitment with decline fallback (reference:
        recruit_worker, validator.py:244-296). ``replica`` tags the
        data-parallel replica slot (reference: planned dp_factor,
        src/roles/user.py:161 — implemented here)."""
        spec = job.stages[stage_index]

        def rank(kv):
            nid, s = kv
            # best-fit on memory first (smallest adequate slot), then —
            # among equal-memory candidates — the FULL two-key roofline
            # score from the heartbeat capability record: faster chip
            # first, higher HBM bandwidth breaking residual ties (a
            # training stage is compute-bound like a prefill leg, so
            # the "prefill" ordering applies)
            cap = self.peer_capabilities.get(nid) or {}
            t, b = roofline_score(cap, "prefill")
            return (s.get("memory", 0), -t, -b)

        candidates = sorted(
            (
                (nid, s)
                for nid, s in stats.items()
                if nid not in taken and s.get("memory", 0) >= spec.param_bytes * 4
            ),
            key=rank,
        )
        for nid, s in candidates:
            peer = self.peers.get(nid)
            if peer is None:
                continue
            try:
                resp = await self.request(
                    peer,
                    {
                        "type": "JOB_OFFER",
                        "job_id": job.job_id,
                        "stage": stage_index,
                        "param_bytes": spec.param_bytes,
                        "author": job.author,
                    },
                    timeout=3.0,
                )
            except (asyncio.TimeoutError, ConnectionError):
                continue
            if resp.get("type") == "ACCEPT_JOB":
                taken.add(nid)
                placement = dict(resp["info"], stage=stage_index, replica=replica)
                # append the address this validator actually reaches the
                # worker at (observed peername) as a dial candidate — for
                # a NAT'd worker the advertised external IP may not
                # hairpin for same-LAN peers
                dial_candidates = [
                    placement["host"], *placement.get("alt_hosts", [])
                ]
                if peer.info.host not in dial_candidates:
                    placement.setdefault("alt_hosts", []).append(peer.info.host)
                return placement
        return None

    # ------------------------------------------------- job replication
    # The reference stubs validator-to-validator job distribution
    # (distribute_job/update_job, src/roles/validator.py:323-331). Here
    # the live record is pushed to sibling validators on every placement
    # change, so a seed-validator loss no longer strands REPLACE_WORKER /
    # JOB_INFO for the job's lifetime — the user
    # falls back to a replica validator (roles/user.py recover_stage).

    def _is_validator_peer(self, peer: Peer) -> bool:
        if self.registry is not None:
            # cache-only: this runs inline in a message handler
            return self.registry.is_validator_local(peer.node_id)
        return peer.role == "validator"  # off-chain dev mode only

    async def _sibling_validators(self, k: int = 3) -> list[dict]:
        """Up to k other validators from the registry (the chain-anchored
        membership; peers' self-declared roles are not trusted), as wire
        dicts {node_id, host, port, alt_hosts}."""
        if self.registry is None:
            return []
        try:
            entries = await asyncio.to_thread(self.registry.sample_validators, k + 1)
        except Exception as e:  # noqa: BLE001 — chain RPC may be down
            self.log.warning("sibling sampling failed: %s", e)
            return []
        return [
            {
                "node_id": e.info.node_id,
                "host": e.info.host,
                "port": e.info.port,
                "alt_hosts": list(getattr(e.info, "alt_hosts", []) or []),
            }
            for e in entries
            if e.info.node_id != self.node_id
        ][:k]

    async def _job_replica_set(self, job_id: str) -> list[dict]:
        """This job's pinned replica-validator set, chosen once and kept
        in job_state — every ACCEPT_JOB/WORKER_REPLACED/JOB_INFO reply
        and every replication push uses the SAME set. (sampling independently per call could advertise validators to
        the user that never received the record.)"""
        st = self.job_state.setdefault(job_id, {})
        if not st.get("replica_validators"):
            st["replica_validators"] = await self._sibling_validators()
            # a validator pinning a fresh set for a job it already holds
            # (e.g. a replica serving JOB_INFO after a failover) must
            # actually SEED that set — the advertised list must be
            # validators that hold the record. (No recursion: the
            # spawned _replicate_job re-enters with the set pinned.)
            if st["replica_validators"] and job_id in self.jobs:
                self._spawn(self._replicate_job(self.jobs[job_id]))
        return st["replica_validators"]

    async def _replicate_job(self, job: JobRecord) -> int:
        """Push the record (+ state) to the job's pinned replica set;
        returns the number of acks. Best-effort: replication failing must
        not fail the placement that triggered it."""
        n = 0
        for info in await self._job_replica_set(job.job_id):
            try:
                peer = self.peers.get(info["node_id"])
                if peer is None:
                    peer = await self.connect_candidates(
                        info["host"], int(info["port"]),
                        tuple(info.get("alt_hosts", ()) or ()),
                        expect_id=info["node_id"],
                    )
                resp = await self.request(
                    peer,
                    {
                        "type": "JOB_REPLICATE",
                        "job": job.to_wire(),
                        "state": {
                            k: v
                            for k, v in self.job_state.get(
                                job.job_id, {}
                            ).items()
                            # the receiver pins its OWN replica set
                            if k != "replica_validators"
                        },
                    },
                    timeout=5.0,
                )
                if resp.get("type") == "JOB_REPLICATED":
                    n += 1
            except (ConnectionError, OSError, asyncio.TimeoutError) as err:
                self.log.info(
                    "job %s replication to %s failed: %s",
                    job.job_id[:8], info["node_id"][:8], err,
                )
        return n

    @wire_guard
    async def _h_job_replicate(self, node, peer, msg) -> dict:
        if not self._is_validator_peer(peer):
            return {"type": "ERROR", "error": "validators only"}
        try:
            # full schema + job-id integrity check, same as JOB_REQ: the
            # id digests the canonical fields (author/stages/train/...),
            # so a compromised sibling cannot overwrite a live record
            # with a tampered SPEC under the victim's job_id. (workers/
            # seed_validators are legitimately mutable placement state.)
            job = validate_job_request(msg["job"])
        except (KeyError, TypeError, ValueError) as e:
            return {"type": "ERROR", "error": f"bad record: {e}"}
        self.jobs[job.job_id] = job
        st = self.job_state.setdefault(job.job_id, {})
        st.update(dict(msg.get("state") or {}))
        st["replicated_from"] = peer.node_id
        st["replicated_at"] = time.time()
        # a replication push means the seed just (re)placed this job —
        # any degradation we flagged for its old placement is answered
        # by the fresh record (a still-dead slot would have blocked the
        # replacement, and the seed would not have pushed). Without this
        # a REPLICA validator stayed 503 forever: the REPLACE_WORKER
        # that clears the seed's condition never reaches it.
        self.health.clear_condition(f"job:{job.job_id[:16]}")
        return {"type": "JOB_REPLICATED", "job_id": job.job_id}

    @wire_guard
    async def _h_job_req(self, node, peer, msg) -> dict:
        """Validate -> store in DHT -> recruit one worker per stage ->
        reply ACCEPT_JOB with placements (reference: create_job,
        validator.py:181-296)."""
        try:
            job = validate_job_request(msg["job"])
        except ValueError as e:
            return {"type": "DECLINE_JOB", "reason": str(e)}
        if job.author != peer.node_id:
            return {"type": "DECLINE_JOB", "reason": "author mismatch"}
        if peer.reputation <= 0.0:
            return {"type": "DECLINE_JOB", "reason": "reputation"}

        # spans nest under the rpc.JOB_REQ dispatch span when the user is
        # tracing, so placement latency splits into poll vs recruit on
        # the same cross-node timeline
        with self.tracer.span(
            "validator.poll_stats", {"job_id": job.job_id[:16]}
        ):
            stats = await self._poll_worker_stats()
        taken: set[str] = set()
        placements: list[dict | None] = []
        with self.tracer.span(
            "validator.recruit",
            {"job_id": job.job_id[:16], "stages": job.n_stages,
             "dp": job.dp_factor},
        ):
            for r in range(job.dp_factor):
                for i in range(job.n_stages):  # sequential: taken-set must grow
                    placements.append(
                        await self._recruit_stage(job, i, stats, taken, replica=r)
                    )
        if any(p is None for p in placements):
            unplaced = [i for i, p in enumerate(placements) if p is None]
            self.flight.record(
                "job_declined", "warn", job_id=job.job_id[:16],
                author=job.author[:16], reason="unplaceable",
                slots=unplaced,
            )
            return {
                "type": "DECLINE_JOB",
                "reason": f"could not place stage slots {unplaced}",
            }
        job.workers = placements
        self.job_state[job.job_id] = {"created": time.time(), "updates": 0}
        # pin the replica-validator set for this job's lifetime and name
        # it in the record + reply so the user can fall back when this
        # (seed) validator dies mid-job — the advertised set IS the
        # replicated-to set by construction
        siblings = await self._job_replica_set(job.job_id)
        job.seed_validators = [self.node_id] + [
            s["node_id"] for s in siblings
        ]
        self.jobs[job.job_id] = job
        await self.dht_store(f"job:{job.job_id}", job.to_wire())
        self._spawn(self._replicate_job(job))
        self.flight.record(
            "job_accepted", job_id=job.job_id[:16], author=job.author[:16],
            stages=job.n_stages, dp=job.dp_factor,
            workers=[(p or {}).get("node_id", "")[:16] for p in placements],
        )
        return {
            "type": "ACCEPT_JOB",
            "job_id": job.job_id,
            "workers": placements,
            "validators": siblings,
        }

    @wire_guard
    async def _h_job_update(self, node, peer, msg) -> dict:
        """Loss/accuracy aggregation (reference stubs this:
        validator.py:329-331). ``done: true`` marks the job finished
        (sent by DistributedJob.shutdown): a torn-down job's placement
        can no longer be degraded, so its readiness condition clears —
        without this a worker that died and was never replaced (because
        the user finished instead) kept this validator 503 forever."""
        jid = str(msg["job_id"])
        st = self.job_state.setdefault(jid, {"updates": 0})
        for k in ("loss", "accuracy", "step"):
            if k in msg:
                st[k] = msg[k]
        st["updates"] += 1
        st["last_update"] = time.time()
        if msg.get("done") and self.jobs.get(jid, None) is not None:
            if peer.node_id == self.jobs[jid].author:  # author-only
                st["done"] = True
                self.health.clear_condition(f"job:{jid[:16]}")
                self.flight.record("job_done", job_id=jid[:16])
        return {"type": "JOB_UPDATED"}

    @wire_guard
    async def _h_job_info(self, node, peer, msg) -> dict:
        jid = str(msg["job_id"])
        job = self.jobs.get(jid)
        if job is None:
            wire = await self.dht_query(f"job:{jid}")
            if wire is None:
                return {"type": "ERROR", "error": "unknown job"}
            return {"type": "JOB", "job": wire, "state": self.job_state.get(jid, {})}
        return {
            "type": "JOB",
            "job": job.to_wire(),
            "state": self.job_state.get(jid, {}),
            # reattach/resume flows rebuild their failover list from this
            "validators": await self._job_replica_set(jid),
        }

    @wire_guard
    async def _h_serve_plan(self, node, peer, msg) -> dict:
        """Disaggregated-serving placement: place a
        request's prefill and decode legs from the live fleet roofline
        table this validator's heartbeats harvested — prefill on the
        highest measured peak TFLOPs, decode on the highest HBM GB/s,
        both gated on the KV-pool headroom each worker's capability
        record publishes (the /metrics gauges, piggybacked on PONGs).
        Degrades to a colocated placement when only one serving worker
        is live. The reply carries full dial info (advertised address +
        the address this validator actually reaches each worker at) so
        the user and the prefill worker can reach both legs."""
        need = int(msg.get("need_blocks", 0) or 0)
        need_tokens = int(msg.get("need_tokens", 0) or 0)
        fleet = {
            nid: cap
            for nid, cap in self.peer_capabilities.items()
            if nid in self.peers and cap.get("role") == "worker"
        }
        plan = plan_serving(fleet, need_blocks=need, need_tokens=need_tokens)
        if plan is None:
            self.flight.record(
                "serving.unplaceable", "warn", need_blocks=need,
                need_tokens=need_tokens, fleet=len(fleet),
            )
            return {
                "type": "SERVE_PLAN",
                "error": "no serving-capable worker "
                         f"(fleet of {len(fleet)}, need {need} blocks)",
            }

        def winfo(nid: str) -> dict:
            # the validator's Peer.info host IS the address it reaches
            # the worker at (dialed target for outbound, observed
            # peername for inbound) — unlike recruitment there is no
            # second self-advertised record to merge, so the wire info
            # ships as-is; multi-candidate NAT dial info would need
            # workers to publish their own PeerInfo on heartbeats
            info = self.peers[nid].info.to_wire()
            info["serving_mode"] = fleet[nid].get("serving_mode")
            return info

        out: dict = {"type": "SERVE_PLAN", "colocated": plan["colocated"]}
        if plan["colocated"]:
            out["node"] = winfo(plan["node"])
        else:
            out["prefill"] = winfo(plan["prefill"])
            out["decode"] = winfo(plan["decode"])
        self.flight.record(
            "serving.placement",
            colocated=plan["colocated"],
            prefill=str(plan.get("prefill", plan.get("node", "")))[:16],
            decode=str(plan.get("decode", plan.get("node", "")))[:16],
        )
        return out

    MAX_PLAN_EXCLUDE = 64

    @wire_guard
    async def _h_serve_pipeline_plan(self, node, peer, msg) -> dict:
        """Pipeline-serving placement, two modes:

        - FRESH (``n_stages`` and/or ``need_bytes``): partition a model
          across the fewest workers whose published ``hbm_bytes`` cover
          its weights; reply carries per-stage dial info + capacities
          (the head slices layers proportional to capacity).
        - REPLACEMENT (``stage`` + ``sid``): a stage died mid-stream —
          recruit a live worker already advertising the SAME
          ``pipe_sid``/``pipe_stage`` (a pre-loaded spare replica, so no
          param shipping on the failover path), best decode roofline
          first, the dead node excluded."""
        fleet = {
            nid: cap
            for nid, cap in self.peer_capabilities.items()
            if nid in self.peers and cap.get("role") == "worker"
        }

        def winfo(nid: str) -> dict:
            info = self.peers[nid].info.to_wire()
            info["pipe_stage"] = fleet[nid].get("pipe_stage")
            return info

        exclude = {
            str(x)[:64]
            for x in list(msg.get("exclude") or [])[:self.MAX_PLAN_EXCLUDE]
        }
        if msg.get("stage") is not None:
            stage = int(msg["stage"])
            sid = str(msg.get("sid", ""))[:64]
            spares = [
                nid for nid, cap in fleet.items()
                if nid not in exclude
                and cap.get("pipe_stage") == stage
                and (not sid or cap.get("pipe_sid") == sid)
            ]
            best = max(
                spares,
                key=lambda n: (*roofline_score(fleet[n], "decode"), n),
                default=None,
            )
            if best is None:
                self.flight.record(
                    "serving.pipeline_unplaceable", "warn", sid=sid[:16],
                    stage=stage, fleet=len(fleet),
                )
                return {
                    "type": "SERVE_PIPELINE_PLAN",
                    "error": f"no spare worker advertises pipeline "
                             f"{sid!r} stage {stage}",
                }
            self.flight.record(
                "serving.pipeline_placement", sid=sid[:16], stage=stage,
                node=best[:16], replacement=True,
            )
            return {
                "type": "SERVE_PIPELINE_PLAN", "stage": stage,
                "node": winfo(best),
            }
        n_stages = (
            int(msg["n_stages"]) if msg.get("n_stages") is not None
            else None
        )
        need_bytes = int(msg.get("need_bytes", 0) or 0)
        from tensorlink_tpu_torch.parallel.pipeserve import plan_pipeline

        try:
            plan = plan_pipeline(
                {n: c for n, c in fleet.items() if n not in exclude},
                n_stages=n_stages, need_bytes=need_bytes,
            )
        except ValueError as e:
            return {"type": "SERVE_PIPELINE_PLAN", "error": str(e)[:200]}
        if plan is None:
            self.flight.record(
                "serving.pipeline_unplaceable", "warn",
                n_stages=n_stages, need_bytes=need_bytes,
                fleet=len(fleet),
            )
            return {
                "type": "SERVE_PIPELINE_PLAN",
                "error": f"fleet of {len(fleet)} cannot hold "
                         f"{need_bytes} bytes across "
                         f"{n_stages or 'any'} stages",
            }
        self.flight.record(
            "serving.pipeline_placement",
            stages=[s[:16] for s in plan["stages"]],
            need_bytes=need_bytes,
        )
        return {
            "type": "SERVE_PIPELINE_PLAN",
            "stages": [winfo(nid) for nid in plan["stages"]],
            "capacities": plan["capacities"],
        }

    @wire_guard
    async def _h_replace_worker(self, node, peer, msg) -> dict:
        """Elastic re-recruitment after a stage failure. Author-only; the dead worker is excluded and reputation-dinged."""
        jid = str(msg["job_id"])
        job = self.jobs.get(jid)
        if job is None:
            return {"type": "ERROR", "error": "unknown job"}
        if job.author != peer.node_id:
            return {"type": "ERROR", "error": "unauthorized"}
        stage_index = int(msg["stage"])
        replica = int(msg.get("replica", 0))
        if not 0 <= stage_index < job.n_stages:
            return {"type": "ERROR", "error": "bad stage"}
        workers = job.workers or []
        slot = next(
            (
                k
                for k, w in enumerate(workers)
                if w
                and int(w.get("stage", -1)) == stage_index
                and int(w.get("replica", 0)) == replica
            ),
            None,
        )
        if slot is None:
            return {"type": "ERROR", "error": "unknown stage slot"}
        exclude = {str(x) for x in msg.get("exclude", [])}
        # only the worker actually recorded on this slot gets a liveness
        # ding — the exclude list is caller-supplied and must not be a
        # reputation weapon against arbitrary nodes
        current = workers[slot]
        if current and current["node_id"] in exclude:
            nid = current["node_id"]
            rep = self.dht.get_local(f"rep:{nid}")
            self.dht.put_local(
                f"rep:{nid}", max(0.0, (1.0 if rep is None else float(rep)) - 0.25)
            )
        stats = await self._poll_worker_stats()
        taken = exclude | {
            w["node_id"] for k, w in enumerate(workers) if w and k != slot
        }
        placement = await self._recruit_stage(
            job, stage_index, stats, taken, replica=replica
        )
        if placement is None:
            self.flight.record(
                "worker_replace_failed", "error", job_id=jid[:16],
                stage=stage_index, replica=replica,
            )
            return {"type": "ERROR", "error": "no replacement available"}
        job.workers[slot] = placement
        await self.dht_store(f"job:{jid}", job.to_wire())
        st = self.job_state.setdefault(jid, {})
        st.setdefault("replacements", []).append(
            {"stage": stage_index, "replica": replica,
             "new": placement["node_id"], "at": time.time()}
        )
        self.flight.record(
            "worker_replaced", job_id=jid[:16], stage=stage_index,
            replica=replica, new=placement["node_id"][:16],
        )
        if all(
            w and w.get("node_id") in self.peers for w in job.workers
        ):
            # every slot points at a connected worker again: the
            # degradation on_peer_lost flagged is over — /healthz goes
            # back to ready for this job (another still-dead slot keeps
            # the condition until ITS replacement lands)
            self.health.clear_condition(f"job:{jid[:16]}")
        # placement changed: refresh the sibling replicas so a later
        # seed-validator loss hands the user a CURRENT record. The reply
        # names this validator's replica set so a user that failed over
        # here also refreshes its backup list (replacing the dead seed's)
        self._spawn(self._replicate_job(job))
        return {
            "type": "WORKER_REPLACED",
            "job_id": jid,
            "worker": placement,
            "validators": await self._job_replica_set(jid),
        }

    # ---------------------------------------------------------- PoL audit
    async def audit_stage(
        self,
        job_id: str,
        stage_index: int,
        in_shape: tuple[int, ...],
        seed: int = 0,
        rtol: float = 1e-4,
        replica: int = 0,
    ) -> dict:
        """Proof-of-learning audit of one placed stage.

        The reference describes this in its whitepaper (forward-pass +
        gradient validation, Whitepaper:41-47) and ships a commented-out
        `validate()` (src/roles/validator.py:153-179). Here it is live:
        fetch the worker's params, issue a seeded challenge, replay the
        stage from the *approved job record's* spec through our own build,
        and compare commitments (bitwise on matching platforms). A failed
        audit slashes reputation in the registry and the local DHT.
        """
        from tensorlink_tpu_torch.p2p.serialization import (
            tree_unflatten_arrays,
            unpack_arrays,
        )
        from tensorlink_tpu_torch.roles import pol

        job = self.jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id}")
        spec = job.stages[stage_index]
        # look the slot up by (stage, replica) — indexing workers[] by
        # stage_index is only right for replica 0 when dp_factor == 1
        #
        placement = next(
            (
                w
                for w in (job.workers or [])
                if w
                and int(w.get("stage", -1)) == stage_index
                and int(w.get("replica", 0)) == replica
            ),
            None,
        )
        if placement is None:
            raise KeyError(
                f"job {job_id} has no placement for stage {stage_index} "
                f"replica {replica}"
            )
        wid = placement["node_id"]
        peer = self.peers.get(wid)
        if peer is None:
            peer = await self.connect_candidates(
                placement["host"], int(placement["port"]),
                placement.get("alt_hosts", ()),
                expect_id=wid,
            )

        base = {"job_id": job_id, "stage": stage_index}
        # include_params: the worker snapshots one immutable param tree and
        # computes proof + digest + returned weights from it, so the audit
        # can never race a live optimizer step (the old
        # two-request flow was inconclusive for every busy honest worker,
        # and three in a row slashed them to zero)
        with self.tracer.span(
            "validator.audit_stage",
            {"job_id": job_id[:16], "stage": stage_index, "worker": wid[:8]},
        ):
            proof = await self.request(
                peer,
                {**base, "type": "POL_CHALLENGE", "seed": seed,
                 "shape": list(in_shape), "include_params": True},
                timeout=60.0,
            )
        record: dict[str, Any] = {
            "job_id": job_id, "stage": stage_index, "worker": wid,
            "seed": seed, "at": time.time(),
        }
        atomic = "weights" in proof
        if proof.get("type") != "POL_PROOF":
            record.update(passed=False, reason="no proof")
        else:
            if atomic:
                params = tree_unflatten_arrays(unpack_arrays(proof["weights"]))
            else:
                # older worker: fetch params separately (may race a live
                # optimizer step — treated as inconclusive, never slashed)
                presp = await self.request(
                    peer, {**base, "type": "PARAMS_REQUEST"}, timeout=30.0
                )
                if presp.get("type") != "PARAMETERS":
                    record.update(passed=False, reason="no params")
                    return self._finish_audit(job_id, wid, peer, record)
                params = tree_unflatten_arrays(unpack_arrays(presp["weights"]))
            def replay():
                from tensorlink_tpu_torch.parallel.inference import (
                    declared_compute_dtype,
                )
                from tensorlink_tpu_torch.roles.worker import wire_params

                digest_ok = pol.params_digest(params) == proof.get("params_digest")
                flat = {k: v.to(self.device) for k, v in wire_params(params).items()}
                # the challenge in the stage's declared compute dtype, as
                # the worker derives it
                x = pol.challenge_input(
                    seed, tuple(in_shape), declared_compute_dtype(flat)
                ).to(self.device)
                out, gx = pol.replay_stage(spec.module_config, flat, x)
                return (digest_ok,
                        pol.verify_commitment(out, proof["output"], rtol=rtol),
                        pol.verify_commitment(gx, proof["input_grad"], rtol=rtol))

            digest_ok, ok_out, ok_gx = await asyncio.to_thread(replay)
            if ok_out and ok_gx and (digest_ok or not atomic):
                record.update(passed=True, forward_ok=True, grad_ok=True,
                              step=proof.get("step"))
            elif not atomic and not digest_ok:
                # legacy two-request flow raced a live optimizer step —
                # inconclusive once, but a worker that KEEPS withholding
                # weights and never matches its digest is evading audits
                # (it controls the reply, so it chooses the legacy path):
                # three consecutive inconclusives slash
                prior = [
                    a
                    for a in self.job_state.get(job_id, {}).get("audits", [])
                    if a.get("stage") == stage_index and a.get("worker") == wid
                ]
                streak = []
                for a in reversed(prior):
                    if a.get("passed") is None:
                        streak.append(a)
                    else:
                        break
                # an honest legacy worker that is actively TRAINING is
                # inconclusive on every audit (the separate params fetch
                # races the optimizer) — its reported step advances, so
                # don't escalate immediately. A worker whose step is
                # stagnant across 3 inconclusive digest mismatches is not
                # training and the mismatch cannot be a race: evasion.
                # And regardless of step churn, the
                # validator asked for the atomic include_params reply
                # EXPLICITLY every time — a worker that keeps choosing the
                # legacy reply controls that choice, so a 'step' it merely
                # claims to bump must not whitelist it forever: cap total
                # consecutive legacy inconclusives (fabricated step
                # bumps would otherwise evade audits indefinitely)
                cur_step = proof.get("step")
                advancing = any(a.get("step") != cur_step for a in streak)
                if len(streak) >= 2 and not advancing:
                    record.update(
                        passed=False, reason="persistent inconclusive audits"
                    )
                elif len(streak) >= 4:
                    record.update(
                        passed=False,
                        reason="refused atomic proof across "
                        f"{len(streak) + 1} audits",
                    )
                else:
                    record.update(
                        passed=None, reason="params changed mid-audit",
                        step=cur_step,
                    )
            else:
                # weights and proof arrive in one atomic reply: any
                # mismatch is the worker's fault, never an audit race
                record.update(
                    passed=False,
                    forward_ok=bool(ok_out),
                    grad_ok=bool(ok_gx),
                    digest_ok=bool(digest_ok),
                    step=proof.get("step"),
                )
        return self._finish_audit(job_id, wid, peer, record)

    def _finish_audit(
        self, job_id: str, wid: str, peer: Peer | None, record: dict
    ) -> dict:
        st = self.job_state.setdefault(job_id, {})
        st.setdefault("audits", []).append(record)
        self.flight.record(
            "audit",
            "error" if record.get("passed") is False else "info",
            job_id=job_id[:16], worker=wid[:16],
            stage=record.get("stage"), passed=record.get("passed"),
            reason=record.get("reason"),
        )
        if record.get("passed") is False:
            self.dht.put_local(f"rep:{wid}", 0.0)
            if self.registry is not None:
                # reputation write may be a chain transaction — off-loop,
                # and a failure must be visible, not a GC-time warning
                async def _slash(reg=self.registry, wid=wid):
                    try:
                        await asyncio.to_thread(reg.set_reputation, wid, 0.0)
                    except Exception as e:  # noqa: BLE001
                        self.log.warning(
                            "on-chain reputation slash for %s failed: %s",
                            wid[:8], e,
                        )

                self._spawn(_slash())
            if peer is not None:
                peer.reputation = 0.0
        return record
