"""Roles: the registry seam and job records here; the worker, user and
validator nodes, proof-of-learning and obfuscation in their modules
(``roles.worker``, ``roles.user``, ``roles.validator``, ``roles.pol``,
``roles.privacy``)."""

from tensorlink_tpu_torch.roles.registry import InMemoryRegistry, Registry  # noqa: F401
from tensorlink_tpu_torch.roles.jobs import JobRecord, StageSpec, validate_job_request  # noqa: F401
