"""Signed work receipts: per-request resource metering folded into
signed records, and the auditor that checks them (a copy of
``tensorlink_tpu/runtime/ledger.py``).

A receipt does not prove a worker ran the model. It makes every claim
attributable (signed over canonical bytes with the worker's
``p2p.crypto.Identity``, so it is tamper-evident and cannot be denied)
and plausible (checked against physics the worker published itself: its
measured capability record, the receipt's own wall-clock window, and
what the client reported receiving).

- producer: :func:`build_receipt` folds the meter dict a serving engine
  accumulated for one finished request (device-busy seconds from the
  ``DispatchTimer``, token counts, KV block-seconds, wire bytes) into a
  flat :data:`RECEIPT_SCHEMA` dict and signs
  :func:`canonical_receipt_bytes`.
- auditor: :class:`ReceiptAuditor` verifies signatures, applies the
  plausibility checks, keeps bounded per-tenant and per-worker rollups,
  and names anomalies with typed reasons (``bad_schema`` /
  ``bad_signature`` / ``overclaim`` / ``double_bill`` /
  ``token_mismatch``), counted in ``metrics`` and ``recorder`` when the
  caller passes them.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
import time
from typing import Any, Callable

from tensorlink_tpu_torch.p2p.crypto import Identity

__all__ = [
    "RECEIPT_SCHEMA",
    "ANOMALY_REASONS",
    "canonical_receipt_bytes",
    "build_receipt",
    "verify_receipt",
    "sanitize_receipt",
    "sanitize_receipt_obs",
    "ReceiptAuditor",
]

RECEIPT_SCHEMA = 1

# the typed anomaly vocabulary — every flagged receipt carries exactly
# one of these, and the per-reason counters use the same strings
ANOMALY_REASONS = (
    "bad_schema",
    "bad_signature",
    "overclaim",
    "double_bill",
    "token_mismatch",
)

# (field, type, lo, hi) — the wire contract for one receipt. Flat
# scalars only: canonical bytes must be order- and encoding-stable.
_FIELDS: tuple[tuple[str, type, float, float], ...] = (
    ("schema", int, 1, 64),
    ("worker", str, 8, 128),  # lo/hi are LENGTH bounds for str
    ("tenant", str, 1, 128),
    ("rid", int, 0, 2**62),
    ("kind", str, 1, 32),
    ("t_start", float, 0.0, 4e12),
    ("t_end", float, 0.0, 4e12),
    ("prompt_tokens", int, 0, 10**9),
    ("emitted_tokens", int, 0, 10**9),
    ("busy_s", float, 0.0, 1e7),
    ("flops", float, 0.0, 1e24),
    ("hbm_bytes", float, 0.0, 1e21),
    ("kv_block_s", float, 0.0, 1e9),
    ("wire_bytes", int, 0, 2**62),
)

_KINDS = ("serve", "prefill_leg", "decode_leg", "pipeline")

# physics slack: measured busy seconds finalized by an opportunistic
# poll can overshoot by a scheduler iteration, and the capability
# microbench itself has run-to-run variance — a plausibility audit must
# not flag honest jitter. 2x headroom still catches any worthwhile lie.
_PEAK_SLACK = 2.0
_WALL_SLACK_S = 0.05


def canonical_receipt_bytes(receipt: dict) -> bytes:
    """THE signing contract: UTF-8 JSON with sorted keys, compact
    separators, no NaN/Inf, over every field EXCEPT ``sig`` — byte-for-
    byte reproducible on any host from the same values. msgpack
    round-trips int/float/str losslessly and Python's float repr is
    shortest-roundtrip, so signer and verifier derive identical bytes
    without a second serialization format on the wire."""
    body = {k: v for k, v in receipt.items() if k != "sig"}
    return json.dumps(
        body, sort_keys=True, separators=(",", ":"), allow_nan=False,
        ensure_ascii=True,
    ).encode()


def build_receipt(meter: dict, identity: Identity) -> dict:
    """Fold one finished request's meter dict into a signed receipt.

    ``meter`` is what a serving engine accumulated (see
    ``ContinuousBatchingEngine`` metering): rid/tenant/kind/token
    counts/busy_s/flops/hbm_bytes/kv_block_s/wire_bytes plus wall-clock
    t_start/t_end. Missing numeric fields default to 0; the worker id
    and public key come from ``identity`` — a receipt can only ever
    claim work for the key that signs it."""
    r: dict[str, Any] = {"schema": RECEIPT_SCHEMA}
    for name, typ, _lo, _hi in _FIELDS:
        if name in ("schema", "worker"):
            continue
        v = meter.get(name)
        if typ is str:
            r[name] = str(v if v is not None else "")
        elif typ is int:
            r[name] = int(v or 0)
        else:
            r[name] = float(v or 0.0)
    if not r["tenant"]:
        r["tenant"] = "anonymous"
    if r["kind"] not in _KINDS:
        r["kind"] = "serve"
    r["worker"] = identity.node_id
    r["pub"] = identity.public_der.hex()
    r["sig"] = identity.sign(canonical_receipt_bytes(r)).hex()
    return r


def verify_receipt(receipt: dict) -> tuple[bool, str]:
    """(ok, reason). Checks the public key binds to the claimed worker
    id (pub is inside the signed bytes, so a valid signature under a
    swapped key is impossible) and the RSA-PSS signature over the
    canonical bytes. Dev-fallback identities are refused by real-crypto
    verifiers — crypto.Identity.verify enforces that boundary."""
    try:
        pub = bytes.fromhex(receipt["pub"])
        sig = bytes.fromhex(receipt["sig"])
    except (KeyError, ValueError, TypeError):
        return False, "bad_signature"
    if Identity.node_id_for(pub) != receipt.get("worker"):
        return False, "bad_signature"
    if not Identity.verify(pub, sig, canonical_receipt_bytes(receipt)):
        return False, "bad_signature"
    return True, ""


def sanitize_receipt(obj: Any) -> dict:
    """Validate one peer-fed receipt payload into a clean flat dict.

    Raises ``ValueError`` on anything off-contract — wrong container
    type, missing/mistyped/out-of-bounds fields, oversized strings,
    unknown schema version. Every wire receipt goes through here before
    any other read of it."""
    if not isinstance(obj, dict):
        raise ValueError(f"receipt must be a dict, got {type(obj).__name__}")
    out: dict[str, Any] = {}
    for name, typ, lo, hi in _FIELDS:
        v = obj.get(name)
        if typ is str:
            if not isinstance(v, str) or not (lo <= len(v) <= hi):
                raise ValueError(f"receipt field {name!r} invalid")
            out[name] = v
        elif typ is int:
            if isinstance(v, bool) or not isinstance(v, int) or not (
                lo <= v <= hi
            ):
                raise ValueError(f"receipt field {name!r} invalid")
            out[name] = v
        else:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"receipt field {name!r} invalid")
            v = float(v)
            if not (lo <= v <= hi):  # NaN fails both comparisons
                raise ValueError(f"receipt field {name!r} invalid")
            out[name] = v
    if out["schema"] != RECEIPT_SCHEMA:
        raise ValueError(f"unknown receipt schema {out['schema']}")
    if out["kind"] not in _KINDS:
        raise ValueError(f"unknown receipt kind {out['kind']!r}")
    for name in ("pub", "sig"):
        v = obj.get(name)
        if not isinstance(v, str) or not (16 <= len(v) <= 4096):
            raise ValueError(f"receipt field {name!r} invalid")
        out[name] = v
    return out


def sanitize_receipt_obs(obj: Any) -> dict:
    """Validate one user-side observation (what the client actually
    received for a request): worker/rid/tenant/tokens. Same taint
    contract as :func:`sanitize_receipt`."""
    if not isinstance(obj, dict):
        raise ValueError("receipt obs must be a dict")
    worker = obj.get("worker")
    rid = obj.get("rid")
    tenant = obj.get("tenant", "anonymous")
    tokens = obj.get("tokens")
    if not isinstance(worker, str) or not (8 <= len(worker) <= 128):
        raise ValueError("receipt obs field 'worker' invalid")
    if isinstance(rid, bool) or not isinstance(rid, int) or rid < 0:
        raise ValueError("receipt obs field 'rid' invalid")
    if not isinstance(tenant, str) or not (1 <= len(tenant) <= 128):
        raise ValueError("receipt obs field 'tenant' invalid")
    if isinstance(tokens, bool) or not isinstance(tokens, int) or not (
        0 <= tokens <= 10**9
    ):
        raise ValueError("receipt obs field 'tokens' invalid")
    return {"worker": worker, "rid": rid, "tenant": tenant,
            "tokens": tokens}


def _rollup() -> dict:
    return {
        "receipts": 0, "prompt_tokens": 0, "emitted_tokens": 0,
        "busy_s": 0.0, "kv_block_s": 0.0, "wire_bytes": 0,
        "anomalies": 0,
    }


class ReceiptAuditor:
    """Validator-side receipt verification + rollup ledgers.

    Invariants the audit enforces (each a typed anomaly):

    - ``bad_signature`` — REJECTED outright (never enters a ledger):
      signature fails over the canonical bytes, or the embedded public
      key does not hash to the claimed worker id.
    - ``double_bill`` — REJECTED: a second receipt for the same
      (worker, rid) — re-billing an already-accounted request.
    - ``overclaim`` — FLAGGED (ledgered, anomaly recorded): claimed
      busy seconds exceed the receipt's own wall-clock window, or the
      implied TFLOPs / HBM GB/s exceed the worker's OWN published
      capability record by more than the measurement slack. The worker
      is contradicted by physics it advertised itself.
    - ``token_mismatch`` — FLAGGED: the emitted-token claim disagrees
      with what the user-side client reported actually receiving for
      that (worker, rid).

    What this is NOT: proof of learning/inference. A worker that ran
    the model can still round busy_s up within its roofline envelope;
    detecting that needs re-execution spot checks (the audit_stage path
    does exactly that for training). The receipts make such spot checks
    attributable — a signed claim is evidence, not hearsay.

    All state is bounded (``max_rids`` rid windows per worker,
    ``max_keys`` tenants/workers); every mutation is lock-guarded so
    PONG harvesting and HTTP snapshots can race freely.
    """

    def __init__(
        self,
        *,
        metrics=None,
        recorder=None,
        capability_for: Callable[[str], dict | None] | None = None,
        on_anomaly: Callable[[str, str], None] | None = None,
        max_rids: int = 4096,
        max_keys: int = 1024,
        clock=time.time,
    ):
        self.metrics = metrics
        self.recorder = recorder
        self.capability_for = capability_for
        self.on_anomaly = on_anomaly
        self.max_rids = int(max_rids)
        self.max_keys = int(max_keys)
        self._clock = clock
        self._lock = threading.Lock()
        # (worker, rid) -> canonical-body digest of the accepted
        # receipt, insertion-ordered for bounded eviction. The digest
        # splits replay from fraud: a retransmitted identical receipt
        # (lost-PONG resend) is an idempotent no-op; a DIFFERENT body
        # for an already-billed rid is the double_bill anomaly.
        self._seen: collections.OrderedDict[tuple[str, int], str] = (
            collections.OrderedDict()
        )
        # (worker, rid) -> client-observed token count (either side may
        # arrive first; cross-check fires when both are present)
        self._obs: collections.OrderedDict[tuple[str, int], dict] = (
            collections.OrderedDict()
        )
        # (worker, rid) -> claimed emitted tokens, for obs-after-receipt
        self._claimed: collections.OrderedDict[tuple[str, int], dict] = (
            collections.OrderedDict()
        )
        self.tenants: dict[str, dict] = {}
        self.workers: dict[str, dict] = {}
        self.anomaly_counts: collections.Counter = collections.Counter()
        self.accepted_total = 0
        self.rejected_total = 0
        self.observed_tokens_total = 0

    # ------------------------------------------------------------ events
    def _reject(self) -> None:
        self.rejected_total += 1
        if self.metrics is not None:
            self.metrics.incr("receipt_rejected_total")

    def _anomaly(self, reason: str, worker: str, **attrs) -> None:
        self.anomaly_counts[reason] += 1
        if self.metrics is not None:
            self.metrics.incr("receipt_anomaly_total")
            self.metrics.incr(f"receipt_anomaly_total:{reason}")
        if self.recorder is not None:
            self.recorder.record(
                "receipt.anomaly", severity="warn", reason=reason,
                worker=worker[:16], **attrs,
            )
        w = self.workers.get(worker[:128])
        if w is not None:
            w["anomalies"] += 1
            w["last_anomaly"] = reason
        if self.on_anomaly is not None:
            try:
                self.on_anomaly(worker, reason)
            except Exception:  # noqa: BLE001 — demerit hook must not
                pass  # poison the audit path

    @staticmethod
    def _bump(table: dict, key: str, r: dict, max_keys: int) -> dict:
        row = table.get(key)
        if row is None:
            if len(table) >= max_keys:
                key = "overflow"
                row = table.get(key)
            if row is None:
                row = table[key] = _rollup()
        row["receipts"] += 1
        row["prompt_tokens"] += r["prompt_tokens"]
        row["emitted_tokens"] += r["emitted_tokens"]
        row["busy_s"] += r["busy_s"]
        row["kv_block_s"] += r["kv_block_s"]
        row["wire_bytes"] += r["wire_bytes"]
        return row

    @staticmethod
    def _evict(od: collections.OrderedDict, cap: int) -> None:
        while len(od) > cap:
            od.popitem(last=False)

    # ------------------------------------------------------------ ingest
    def ingest(self, receipt: Any) -> dict:
        """Audit one wire receipt. Returns ``{"accepted": bool,
        "anomalies": [reason, ...]}``. Malformed payloads count as
        ``bad_schema`` and are rejected — callers that already ran
        :func:`sanitize_receipt` never hit that branch."""
        try:
            r = sanitize_receipt(receipt)
        except ValueError:
            with self._lock:
                self._reject()
                self._anomaly("bad_schema", str(
                    receipt.get("worker", "?") if isinstance(receipt, dict)
                    else "?"
                ))
            return {"accepted": False, "anomalies": ["bad_schema"]}
        ok, reason = verify_receipt(r)
        anomalies: list[str] = []
        with self._lock:
            worker = r["worker"]
            if not ok:
                self._reject()
                self._anomaly(reason, worker, rid=r["rid"])
                return {"accepted": False, "anomalies": [reason]}
            key = (worker, r["rid"])
            digest = hashlib.sha256(canonical_receipt_bytes(r)).hexdigest()
            prev = self._seen.get(key)
            if prev is not None:
                if prev == digest:  # replay of the accounted receipt
                    return {"accepted": False, "anomalies": [],
                            "duplicate": True}
                self._reject()
                self._anomaly(
                    "double_bill", worker, rid=r["rid"],
                    tenant=r["tenant"],
                )
                return {"accepted": False, "anomalies": ["double_bill"]}
            self._seen[key] = digest
            self._evict(self._seen, self.max_rids)

            anomalies += self._physics_check(r)
            # cross-check against a client observation, whichever side
            # arrived first
            obs = self._obs.pop(key, None)
            if obs is not None and obs["tokens"] != r["emitted_tokens"]:
                anomalies.append("token_mismatch")
            elif obs is None:
                self._claimed[key] = {
                    "tokens": r["emitted_tokens"], "tenant": r["tenant"],
                }
                self._evict(self._claimed, self.max_rids)

            self.accepted_total += 1
            if self.metrics is not None:
                self.metrics.incr("receipt_accepted_total")
            wrow = self._bump(self.workers, worker[:128], r, self.max_keys)
            wrow.setdefault("last_anomaly", None)
            trow = self._bump(self.tenants, r["tenant"], r, self.max_keys)
            for reason in anomalies:
                trow["anomalies"] += 1
                self._anomaly(
                    reason, worker, rid=r["rid"], tenant=r["tenant"],
                )
        return {"accepted": True, "anomalies": anomalies}

    def _physics_check(self, r: dict) -> list[str]:
        """Plausibility against the receipt's own window and the
        worker's published roofline. Never flags a worker with no
        capability record on the peak checks — absence of evidence is
        handled by placement (unadvertised workers get no traffic),
        not by fabricating a roofline here."""
        out = []
        wall = max(r["t_end"] - r["t_start"], 0.0)
        if r["busy_s"] > wall + _WALL_SLACK_S:
            out.append("overclaim")
            return out  # one reason per receipt; wall is the strongest
        cap = self.capability_for(r["worker"]) if self.capability_for else None
        if cap and r["busy_s"] > 0:
            peak_tf = float(cap.get("peak_tflops") or 0.0)
            if peak_tf > 0 and (
                r["flops"] / r["busy_s"] / 1e12 > peak_tf * _PEAK_SLACK
            ):
                out.append("overclaim")
                return out
            peak_bw = float(cap.get("hbm_gbps") or 0.0)
            if peak_bw > 0 and (
                r["hbm_bytes"] / r["busy_s"] / 1e9 > peak_bw * _PEAK_SLACK
            ):
                out.append("overclaim")
        return out

    # ------------------------------------------------------ observations
    def observe(self, obs: Any) -> None:
        """Ingest one user-side observation ({worker, rid, tenant,
        tokens}): the tokens the client actually received. Cross-checks
        immediately when the worker's receipt already landed, else
        parks (bounded) until it does. Malformed observations are
        dropped under the bad_schema counter."""
        try:
            o = sanitize_receipt_obs(obs)
        except ValueError:
            with self._lock:
                self._anomaly("bad_schema", str(
                    obs.get("worker", "?") if isinstance(obs, dict) else "?"
                ))
            return
        with self._lock:
            self.observed_tokens_total += o["tokens"]
            t = self.tenants.get(o["tenant"])
            if t is None and len(self.tenants) < self.max_keys:
                t = self.tenants[o["tenant"]] = _rollup()
            if t is not None:
                t["observed_tokens"] = (
                    t.get("observed_tokens", 0) + o["tokens"]
                )
            key = (o["worker"], o["rid"])
            claimed = self._claimed.pop(key, None)
            if claimed is not None:
                if claimed["tokens"] != o["tokens"]:
                    self._anomaly(
                        "token_mismatch", o["worker"], rid=o["rid"],
                        tenant=claimed["tenant"],
                        claimed=claimed["tokens"], observed=o["tokens"],
                    )
            else:
                self._obs[key] = o
                self._evict(self._obs, self.max_rids)

    # ------------------------------------------------------------- views
    def snapshot(self) -> dict:
        """The ``GET /ledger`` payload: per-tenant and per-worker
        rollups, anomaly tallies by reason, and the accept/reject
        totals. Plain JSON-able scalars throughout."""
        with self._lock:
            return {
                "schema": RECEIPT_SCHEMA,
                "accepted_total": self.accepted_total,
                "rejected_total": self.rejected_total,
                "observed_tokens_total": self.observed_tokens_total,
                "anomalies": dict(self.anomaly_counts),
                "tenants": {
                    k: dict(v) for k, v in self.tenants.items()
                },
                "workers": {
                    k: dict(v) for k, v in self.workers.items()
                },
            }
