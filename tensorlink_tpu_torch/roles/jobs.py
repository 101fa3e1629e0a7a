"""Job records + stage specs.

Job schema follows the reference's record (author, capacity, dp_factor,
distribution, n_workers, seed_validators, workers, id —
src/roles/user.py:244-257) minus pickles: the id is a sha256 over the
msgpack-canonical record, and the "distribution" maps stage index to a
*spec digest + byte size*, never code.

The port's copy of ``tensorlink_tpu/roles/jobs.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step. Digests use the port's msgpack codec
(``p2p/serialization.packb``), whose bytes equal ``msgpack.packb``'s, so
a digest is the reference's.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

from tensorlink_tpu_torch.p2p.serialization import packb


@dataclass
class StageSpec:
    """One pipeline stage: a module config (plain data) + its weights'
    byte size. Weights travel separately as a packed array blob."""

    index: int
    module_config: dict
    param_bytes: int
    digest: str = ""

    def __post_init__(self):
        if not self.digest:
            body = packb(
                {"cfg": self.module_config, "bytes": self.param_bytes}
            )
            self.digest = hashlib.sha256(body).hexdigest()

    def to_wire(self) -> dict:
        return {
            "index": self.index,
            "module_config": self.module_config,
            "param_bytes": self.param_bytes,
            "digest": self.digest,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "StageSpec":
        # Never trust the wire digest: recompute from content so the
        # job-id integrity check actually binds module_config/param_bytes.
        return cls(
            index=int(d["index"]),
            module_config=d["module_config"],
            param_bytes=int(d["param_bytes"]),
            digest="",
        )


@dataclass
class JobRecord:
    author: str  # user node_id
    stages: list[StageSpec]
    dp_factor: int = 1
    micro_batches: int = 1
    train: dict = field(default_factory=dict)  # optimizer/lr/... plain data
    capacity_bytes: int = 0
    seed_validators: list[str] = field(default_factory=list)
    workers: list[dict] = field(default_factory=list)  # filled by validator
    created_at: float = field(default_factory=time.time)
    job_id: str = ""

    def __post_init__(self):
        if not self.job_id:
            body = packb(
                {
                    "author": self.author,
                    "stages": [s.digest for s in self.stages],
                    "dp": self.dp_factor,
                    "micro": self.micro_batches,
                    "train": sorted(self.train.items()),
                    "t": self.created_at,
                }
            )
            self.job_id = hashlib.sha256(body).hexdigest()

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def to_wire(self) -> dict:
        return {
            "job_id": self.job_id,
            "author": self.author,
            "stages": [s.to_wire() for s in self.stages],
            "dp_factor": self.dp_factor,
            "micro_batches": self.micro_batches,
            "train": self.train,
            "capacity_bytes": self.capacity_bytes,
            "seed_validators": self.seed_validators,
            "workers": self.workers,
            "created_at": self.created_at,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "JobRecord":
        return cls(
            author=str(d["author"]),
            stages=[StageSpec.from_wire(s) for s in d["stages"]],
            dp_factor=int(d.get("dp_factor", 1)),
            micro_batches=int(d.get("micro_batches", 1)),
            train=dict(d.get("train", {})),
            capacity_bytes=int(d.get("capacity_bytes", 0)),
            seed_validators=list(d.get("seed_validators", [])),
            workers=list(d.get("workers", [])),
            created_at=float(d.get("created_at", 0.0)),
            job_id=str(d.get("job_id", "")),
        )


def validate_job_request(d: dict) -> JobRecord:
    """Schema check (reference: assert_job_req, validator.py:12-25).
    Raises ValueError on malformed requests."""
    try:
        job = JobRecord.from_wire(d)
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed job request: {e}") from e
    if not job.stages:
        raise ValueError("job has no stages")
    if any(s.param_bytes < 0 for s in job.stages):
        raise ValueError("negative stage size")
    if job.dp_factor < 1 or job.micro_batches < 1:
        raise ValueError("dp_factor and micro_batches must be >= 1")
    if len(job.author) != 64:
        raise ValueError("author must be a node id")
    # recompute id from canonical fields: reject tampered ids
    expect = JobRecord(
        author=job.author,
        stages=job.stages,
        dp_factor=job.dp_factor,
        micro_batches=job.micro_batches,
        train=job.train,
        created_at=job.created_at,
        job_id="",
    ).job_id
    if job.job_id != expect:
        raise ValueError("job id mismatch")
    return job
