"""Validator registry: the chain-integration seam.

The reference binds to an EVM contract for validator enumeration and
role verification, bypassed entirely by off_chain_test=True
(src/p2p/smart_node.py:165-179,522-537). Here the same seam is an abstract
Registry: InMemoryRegistry for hermetic tests/off-chain deployments; a
web3-backed implementation can slot in behind the same interface without
touching any node code.

The port's copy of ``tensorlink_tpu/roles/registry.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

import abc
import random
import time
from dataclasses import dataclass, field

from tensorlink_tpu_torch.p2p.dht import PeerInfo


@dataclass
class ValidatorEntry:
    info: PeerInfo
    reputation: float = 1.0
    registered_at: float = field(default_factory=time.time)


class Registry(abc.ABC):
    @abc.abstractmethod
    def register_validator(self, info: PeerInfo) -> None: ...

    @abc.abstractmethod
    def validator_count(self) -> int: ...

    @abc.abstractmethod
    def list_validators(self) -> list[ValidatorEntry]: ...

    @abc.abstractmethod
    def is_validator(self, node_id: str) -> bool: ...

    def is_validator_local(self, node_id: str) -> bool:
        """Non-blocking variant for event-loop call sites (the DHT store
        gate runs inline in the message handler). Chain-backed registries
        override this to consult only their cached view — possibly stale,
        never an RPC. Default: same as is_validator, which is already
        memory-only for in-process registries."""
        return self.is_validator(node_id)

    def refresh(self) -> None:
        """Re-fetch any cached view. Blocking I/O allowed — callers on the
        event loop wrap this in asyncio.to_thread. Default: no-op."""

    # -- on-chain job/payment records (chain/registry.py docstring): the
    # reference carried requestJob only as commented-out intent; backends
    # without a job ledger return None and callers skip the recording
    def request_job_onchain(
        self, user_id: str, capacity_bytes: int, payment_milli: int
    ) -> int | None:
        return None

    def complete_job_onchain(self, job_id: int) -> None:
        pass

    def job_onchain(self, job_id: int) -> dict | None:
        return None

    def sample_validators(self, k: int = 6) -> list[ValidatorEntry]:
        """Bootstrap sampling (reference: <=6 random contract validators,
        smart_node.py:539-585)."""
        entries = self.list_validators()
        return random.sample(entries, min(k, len(entries)))


class InMemoryRegistry(Registry):
    def __init__(self):
        self._validators: dict[str, ValidatorEntry] = {}

    def register_validator(self, info: PeerInfo) -> None:
        self._validators[info.node_id] = ValidatorEntry(info=info)

    def deregister_validator(self, node_id: str) -> None:
        self._validators.pop(node_id, None)

    def validator_count(self) -> int:
        return len(self._validators)

    def list_validators(self) -> list[ValidatorEntry]:
        return list(self._validators.values())

    def is_validator(self, node_id: str) -> bool:
        return node_id in self._validators

    def set_reputation(self, node_id: str, rep: float) -> None:
        if node_id in self._validators:
            self._validators[node_id].reputation = rep

    # job ledger (same semantics as the chain contract, memory-backed so
    # role tests can assert the request->complete lifecycle hermetically)
    def request_job_onchain(
        self, user_id: str, capacity_bytes: int, payment_milli: int
    ) -> int:
        jobs = getattr(self, "_jobs", None)
        if jobs is None:
            jobs = self._jobs = []
        jobs.append({
            "user_id": user_id, "capacity_bytes": int(capacity_bytes),
            "payment_milli": int(payment_milli), "completed": False,
        })
        return len(jobs)

    def complete_job_onchain(self, job_id: int) -> None:
        # same error contract as the mock chain contract (chain/mock.py
        # completeJob): unknown ids raise ValueError, not AttributeError/
        # IndexError — the two ledger backends must not diverge on error
        # behavior (ADVICE r5)
        jobs = getattr(self, "_jobs", [])
        if not 1 <= job_id <= len(jobs):
            raise ValueError(f"unknown job {job_id}")
        jobs[job_id - 1]["completed"] = True

    def job_onchain(self, job_id: int) -> dict | None:
        jobs = getattr(self, "_jobs", [])
        if not 1 <= job_id <= len(jobs):
            return None
        return dict(jobs[job_id - 1])
