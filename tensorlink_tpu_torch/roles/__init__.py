"""Role plumbing ported so far: the registry seam and job records. The
worker, validator and user nodes come with the roles that touch tensors."""

from tensorlink_tpu_torch.roles.registry import InMemoryRegistry, Registry  # noqa: F401
from tensorlink_tpu_torch.roles.jobs import JobRecord, StageSpec, validate_job_request  # noqa: F401
