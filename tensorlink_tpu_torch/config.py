"""Typed configuration (a copy of ``tensorlink_tpu/config.py``).

The same frozen dataclasses, fields, defaults and ``__post_init__``
checks as the JAX package's, copied rather than imported: importing any
module of ``tensorlink_tpu`` loads JAX. Fields that name a JAX-side
mechanism (``remat``, ``pp_schedule``, ``fsdp``, the node's compile
cache) are carried so a config round-trips between the two packages;
the port honours them as its slices land, and refuses what it cannot
honour yet where it is used (``train.trainer.Trainer``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: axes (data, pipe, model, seq). The product of
    the axis sizes must equal the number of participating devices."""

    data: int = 1
    pipe: int = 1
    model: int = 1
    seq: int = 1

    AXIS_NAMES = ("data", "pipe", "model", "seq")

    @property
    def num_devices(self) -> int:
        return self.data * self.pipe * self.model * self.seq

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return (self.data, self.pipe, self.model, self.seq)

    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.AXIS_NAMES, self.shape))


@dataclass(frozen=True)
class DistributedConfig:
    """Multi-process mesh formation. ``coordinator`` is "host:port" of
    process 0; ``num_processes`` and ``process_id`` are set explicitly."""

    coordinator: str | None = None  # None = single-process (no init)
    num_processes: int | None = None
    process_id: int | None = None
    local_device_ids: tuple | None = None

    @property
    def enabled(self) -> bool:
        return self.coordinator is not None


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters + micro-batching (gradient accumulation
    over ``micro_batches`` slices of each batch)."""

    batch_size: int = 32
    micro_batches: int = 4
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    optimizer: str = "adamw"  # adam | adamw | sgd
    warmup_steps: int = 0
    total_steps: int = 1000
    schedule: str = "constant"  # constant | linear | cosine
    grad_clip_norm: float | None = 1.0
    seed: int = 0
    dtype: str = "bfloat16"  # compute dtype; params stay f32
    remat: bool = False  # recompute each stage/block in the backward
    pp_schedule: str = "gpipe"  # gpipe | 1f1b
    # weight of the MoE router load-balancing loss added to the task loss
    moe_aux_weight: float = 0.0
    # "lora" = train ONLY LoRA adapter leaves
    train_only: str | None = None
    # FSDP/ZeRO-3: shard params + optimizer moments over the ``data`` axis
    fsdp: bool = False
    # storage dtype of adam/adamw m+v (update math stays f32)
    opt_moment_dtype: str = "float32"
    # a step whose loss/grads are non-finite leaves params, optimizer
    # moments and the step counter unchanged
    skip_nonfinite_updates: bool = False

    def __post_init__(self):
        if self.train_only not in (None, "lora"):
            raise ValueError(
                f"unknown train_only {self.train_only!r}; supported: 'lora'"
            )
        from tensorlink_tpu_torch.train.optim import SUPPORTED_MOMENT_DTYPES

        if self.opt_moment_dtype not in SUPPORTED_MOMENT_DTYPES:
            raise ValueError(
                f"unsupported opt_moment_dtype {self.opt_moment_dtype!r}; "
                f"supported: {SUPPORTED_MOMENT_DTYPES}"
            )

    @property
    def micro_batch_size(self) -> int:
        if self.batch_size % self.micro_batches:
            raise ValueError(
                f"batch_size={self.batch_size} not divisible by "
                f"micro_batches={self.micro_batches}"
            )
        return self.batch_size // self.micro_batches


@dataclass(frozen=True)
class NodeConfig:
    """Control-plane node identity + transport settings."""

    role: str = "worker"  # user | worker | validator
    host: str = "127.0.0.1"
    port: int = 0  # 0 = OS-assigned
    base_port: int = 38751
    max_connections: int = 64
    handshake_timeout_s: float = 10.0
    connect_timeout_s: float = 5.0
    request_timeout_s: float = 5.0
    dht_replication: int = 3
    dht_buckets: int = 256
    heartbeat_interval_s: float = 2.0
    heartbeat_miss_limit: int = 3
    compression: str = "zstd"  # none | zlib | zstd
    compression_min_bytes: int = 4096
    off_chain: bool = True
    chain_url: str | None = None
    chain_contract: str | None = None
    chain_sender: str | None = None
    key_dir: str | None = None
    http_status_port: int | None = None
    stage_tp_devices: int = 1
    dht_snapshot_path: str | None = None
    dht_snapshot_interval_s: float = 600.0
    upnp: bool = False
    upnp_lease_s: int = 0
    upnp_timeout_s: float = 3.0
    upnp_ssdp_addr: tuple = ("239.255.255.250", 1900)
    registry_refresh_s: float = 30.0
    health_interval_s: float = 1.0
    step_watchdog_s: float | None = 300.0
    compile_cache_dir: str | None = None
    autotune_dir: str | None = None
    capability_bench: bool | None = None
    profile_dir: str | None = None
    timeseries_enabled: bool = True
    timeseries_interval_s: float = 1.0
    slo_path: str | None = None

    def __post_init__(self):
        # wire serialization round-trips tuples as lists; normalize so
        # config equality survives to_dict/from_dict
        object.__setattr__(self, "upnp_ssdp_addr", tuple(self.upnp_ssdp_addr))


@dataclass(frozen=True)
class FrameworkConfig:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    node: NodeConfig = field(default_factory=NodeConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FrameworkConfig":
        dist = dict(d.get("distributed", {}))
        if dist.get("local_device_ids") is not None:
            dist["local_device_ids"] = tuple(dist["local_device_ids"])
        return cls(
            mesh=MeshConfig(**d.get("mesh", {})),
            train=TrainConfig(**d.get("train", {})),
            node=NodeConfig(**d.get("node", {})),
            distributed=DistributedConfig(**dist),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FrameworkConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "FrameworkConfig":
        return dataclasses.replace(self, **kw)


def config_from_env(env: Mapping[str, str] | None = None) -> FrameworkConfig:
    """Optional env-var overrides (explicit, never at import time)."""
    env = dict(os.environ if env is None else env)
    mesh = MeshConfig(
        data=int(env.get("TLTPU_MESH_DATA", 1)),
        pipe=int(env.get("TLTPU_MESH_PIPE", 1)),
        model=int(env.get("TLTPU_MESH_MODEL", 1)),
        seq=int(env.get("TLTPU_MESH_SEQ", 1)),
    )
    return FrameworkConfig(mesh=mesh)
