"""Chain-backed validator registry.

Implements the `roles.registry.Registry` seam against an EVM contract, the
TPU-native analogue of the reference's web3 binding (src/p2p/smart_node.py:
165-179 contract init; 522-537 getValidatorCount/getValidatorInfo; 357-379
handshake role verification). Node code is oblivious to the backing store:
hermetic tests use InMemoryRegistry, deployments pass a Web3Registry.

Contract interface (minimal, defined by this framework — the reference's
1.5 MB generated ABI is mostly unused surface):

    function validatorCount() view returns (uint256)
    function validatorAt(uint256 i) view returns
        (string nodeId, string host, uint256 port,
         uint256 reputationMilli, uint256 registeredAt)
    function isValidator(string nodeId) view returns (bool)
    function registerValidator(string nodeId, string host, uint256 port)
    function deregisterValidator(string nodeId)
    function setReputation(string nodeId, uint256 reputationMilli)
    function jobCount() view returns (uint256)
    function requestJob(string userId, uint256 capacityBytes,
                        uint256 paymentMilli) returns (uint256 jobId)
    function completeJob(uint256 jobId)
    function jobAt(uint256 jobId) view returns
        (string userId, uint256 capacityBytes, uint256 paymentMilli,
         bool completed)

Reputation and payment ride as milli-units (uint) since the EVM has no
floats. The job functions are the ON-CHAIN job/payment records the
reference only carried as commented-out intent (src/roles/user.py:
50-64, 171-199; the whitepaper anchors payments on-chain) — here the
write path is live: UserNode.request_job(chain_registry=...) records
the request before placement and DistributedJob.complete_onchain()
closes it.

The port's copy of ``tensorlink_tpu/chain/registry.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

import time

from tensorlink_tpu_torch.chain import abi
from tensorlink_tpu_torch.chain.keccak import keccak256, selector
from tensorlink_tpu_torch.chain.rpc import ChainError, ChainRpc
from tensorlink_tpu_torch.p2p.dht import PeerInfo
from tensorlink_tpu_torch.roles.registry import Registry, ValidatorEntry

_VALIDATOR_AT_RETURNS = ["string", "string", "uint256", "uint256", "uint256"]

_SEL = {
    "validatorCount": selector("validatorCount()"),
    "validatorAt": selector("validatorAt(uint256)"),
    "isValidator": selector("isValidator(string)"),
    "registerValidator": selector("registerValidator(string,string,uint256)"),
    "deregisterValidator": selector("deregisterValidator(string)"),
    "setReputation": selector("setReputation(string,uint256)"),
    "jobCount": selector("jobCount()"),
    "requestJob": selector("requestJob(string,uint256,uint256)"),
    "completeJob": selector("completeJob(uint256)"),
    "jobAt": selector("jobAt(uint256)"),
}


class Web3Registry(Registry):
    """Registry reads via `eth_call`, writes via node-managed transactions.

    `cache_ttl` bounds RPC traffic from the hot handshake path: the
    reference issues one `eth_call` per inbound validator handshake
    (smart_node.py:357-373); here verification hits a TTL-cached local
    view and only misses go to the chain.
    """

    def __init__(
        self,
        rpc_url: str,
        contract_address: str,
        sender: str | None = None,
        cache_ttl: float = 5.0,
        rpc: ChainRpc | None = None,
    ):
        self.rpc = rpc or ChainRpc(rpc_url)
        self.contract = contract_address
        self.sender = sender
        self.cache_ttl = cache_ttl
        self._cache: list[ValidatorEntry] | None = None
        self._cache_at = 0.0

    # ------------------------------------------------------------ raw calls
    def _call(self, name: str, types: list[str], values: list) -> bytes:
        out = self.rpc.eth_call(
            self.contract, _SEL[name] + abi.encode(types, values)
        )
        if not out:
            # every read in this interface declares return values; empty
            # returndata means calling an address with no contract code —
            # surface the misconfiguration instead of decoding zeros
            raise ChainError(
                f"{name}: empty returndata from {self.contract} — wrong "
                "contract address or contract not deployed on this chain?"
            )
        return out

    def _read(self, name: str, ret_types: list[str], types: list[str],
              values: list) -> list:
        """eth_call + decode; decode failures (truncated/garbage
        returndata from a wrong contract) surface as ChainError so both
        symptoms of a misconfigured address share one exception type."""
        out = self._call(name, types, values)
        try:
            return abi.decode(ret_types, out)
        except ValueError as e:
            raise ChainError(
                f"{name}: undecodable returndata from {self.contract}: {e}"
            ) from e

    def _transact(self, name: str, types: list[str], values: list) -> str:
        # mark the cached view stale (next read refetches) but KEEP it for
        # is_validator_local — nulling it would fail-close the event-loop
        # gate for the whole window until the next refresh
        self._cache_at = 0.0
        return self.rpc.send_transaction(
            self.contract, _SEL[name] + abi.encode(types, values), sender=self.sender
        )

    # ------------------------------------------------------------- Registry
    def register_validator(self, info: PeerInfo) -> None:
        self._transact(
            "registerValidator",
            ["string", "string", "uint256"],
            [info.node_id, info.host, info.port],
        )

    def deregister_validator(self, node_id: str) -> None:
        self._transact("deregisterValidator", ["string"], [node_id])

    def validator_count(self) -> int:
        [count] = self._read("validatorCount", ["uint256"], [], [])
        return count

    def list_validators(self) -> list[ValidatorEntry]:
        now = time.monotonic()
        if self._cache is not None and now - self._cache_at < self.cache_ttl:
            return list(self._cache)
        entries = []
        for i in range(self.validator_count()):
            node_id, host, port, rep_milli, registered_at = self._read(
                "validatorAt", _VALIDATOR_AT_RETURNS, ["uint256"], [i]
            )
            entries.append(
                ValidatorEntry(
                    info=PeerInfo(node_id=node_id, role="validator",
                                  host=host, port=port),
                    reputation=rep_milli / 1000.0,
                    registered_at=float(registered_at),
                )
            )
        self._cache, self._cache_at = entries, now
        return list(entries)

    def is_validator(self, node_id: str) -> bool:
        cached = self._cache
        if cached is not None and time.monotonic() - self._cache_at < self.cache_ttl:
            if any(e.info.node_id == node_id for e in cached):
                return True
        [ok] = self._read("isValidator", ["bool"], ["string"], [node_id])
        return ok

    def is_validator_local(self, node_id: str) -> bool:
        """Cache-only check for event-loop call sites: never an RPC, stale
        allowed (the validator refreshes the view periodically). A miss on
        an empty cache denies — fail-closed until the first refresh."""
        cached = self._cache or []
        return any(e.info.node_id == node_id for e in cached)

    def refresh(self) -> None:
        # stale-while-revalidate: the old view keeps serving
        # is_validator_local during the N+1 RPC roundtrips; list_validators
        # swaps the fresh list in atomically at the end
        self._cache_at = 0.0
        self.list_validators()

    def set_reputation(self, node_id: str, rep: float) -> None:
        self._transact(
            "setReputation", ["string", "uint256"],
            [node_id, max(0, round(rep * 1000))],
        )

    # -- on-chain job/payment records (module docstring) ----------------

    # keccak256("JobRequested(uint256,string)") — topic[0] of the event the
    # contract emits per requestJob; topic[1] is the indexed job id
    JOB_REQUESTED_TOPIC = "0x" + keccak256(
        b"JobRequested(uint256,string)"
    ).hex()

    def request_job_onchain(
        self, user_id: str, capacity_bytes: int, payment_milli: int
    ) -> int:
        """Record a job request; -> its on-chain job id. A transaction
        cannot return a value over JSON-RPC, so the id comes from the
        JobRequested event in the transaction's receipt logs — race-free
        under concurrent submitters (each receipt names ITS job). Only
        when the node returns no receipt/logs (old contract without the
        event) does this fall back to re-reading jobCount(), which is
        correct only while a single user submits at a time — the
        constraint UserNode.request_job documents."""
        tx_hash = self._transact(
            "requestJob", ["string", "uint256", "uint256"],
            [user_id, int(capacity_bytes), int(payment_milli)],
        )
        try:
            receipt = self.rpc.get_transaction_receipt(tx_hash)
        except ChainError:
            receipt = None
        status = (receipt or {}).get("status")
        if status is not None and int(status, 16) == 0:
            # reverted: falling through to the jobCount() fallback here
            # would return some OTHER job's id as if this request
            # succeeded — and its escrow would later be completed
            raise ChainError(
                f"requestJob transaction {tx_hash} reverted (status 0x0)"
            )
        for log in (receipt or {}).get("logs", []):
            topics = log.get("topics") or []
            if len(topics) >= 2 and topics[0] == self.JOB_REQUESTED_TOPIC:
                return int(topics[1], 16)
        # legacy fallback: jobCount() after the receipt (single-submitter
        # window only — see docstring)
        [count] = self._read("jobCount", ["uint256"], [], [])
        return int(count)

    def complete_job_onchain(self, job_id: int) -> None:
        self._transact("completeJob", ["uint256"], [int(job_id)])

    def job_onchain(self, job_id: int) -> dict:
        user_id, cap, pay, done = self._read(
            "jobAt", ["string", "uint256", "uint256", "bool"],
            ["uint256"], [int(job_id)],
        )
        return {
            "user_id": user_id, "capacity_bytes": int(cap),
            "payment_milli": int(pay), "completed": bool(done),
        }
