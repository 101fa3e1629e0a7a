"""Process groups and the device mesh (port of ``tensorlink_tpu/runtime/mesh.py``).

One process drives one device. ``initialize_distributed`` joins the
processes of a job into one ``torch.distributed`` process group (NCCL on
CUDA, gloo on the CPU); ``make_mesh`` arranges the group's ranks into a
``DeviceMesh`` with the reference's axes ``("data", "pipe", "model",
"seq")``, ``model`` and ``seq`` innermost, so the ranks of one model group
are adjacent (one host's NVLink domain) and ``data`` is outermost.

``make_mesh`` also works where no ``initialize_distributed`` ran, as the
JAX ``make_mesh`` does over the local devices: a one-rank mesh then forms
its own group over a ``FileStore`` in a fresh temporary directory (no
port, no network), which ``shutdown_distributed`` destroys. A mesh that
needs more ranks than the group has raises.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.config import DistributedConfig, MeshConfig
from tensorlink_tpu_torch.nn.module import NamedSharding, P

_STATE = {"initialized": False, "store_dir": None}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(cfg: DistributedConfig, *, device=None) -> dict:
    """Join this process into the job's process group: ``cfg.coordinator``
    is ``"host:port"`` of rank 0 (or any ``init_method`` URL: ``tcp://``,
    ``file://``), ``num_processes`` the world size and ``process_id`` this
    rank. NCCL on CUDA (the default device), gloo with ``device="cpu"``;
    on CUDA the process takes device ``local_device_ids[0]`` (default:
    rank modulo the visible devices). No-op (with a report) for a
    single-process config or an already joined process.

    Returns {enabled, process_id, num_processes, global_devices,
    local_devices}, the reference's summary."""
    if not cfg.enabled:
        return {"enabled": False}
    dev = resolve_device(device)
    if not dist.is_initialized():
        url = cfg.coordinator
        if "://" not in url:
            url = f"tcp://{url}"
        rank, world = cfg.process_id, cfg.num_processes
        if rank is None or world is None:
            raise ValueError("initialize_distributed needs num_processes "
                             "and process_id")
        if dev.type == "cuda":
            ids = cfg.local_device_ids
            torch.cuda.set_device(ids[0] if ids else rank % torch.cuda.device_count())
        dist.init_process_group(_backend(dev), init_method=url, rank=rank,
                                world_size=world)
        _STATE["initialized"] = True
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {
        "enabled": True,
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "global_devices": dist.get_world_size(),
        "local_devices": local,
    }


def shutdown_distributed() -> None:
    """Destroy the process group this module formed (tests and the chip
    script form several in a row)."""
    if _STATE["initialized"] and dist.is_initialized():
        dist.destroy_process_group()
    _STATE["initialized"] = False
    d = _STATE["store_dir"]
    _STATE["store_dir"] = None
    if d is not None:
        shutil.rmtree(d, ignore_errors=True)


def _single_rank_group(dev: torch.device) -> None:
    d = tempfile.mkdtemp(prefix="tl-mesh-")
    store = dist.FileStore(os.path.join(d, "store"), 1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(_backend(dev), store=store, rank=0, world_size=1)
    _STATE.update(initialized=True, store_dir=d)


def make_mesh(cfg: MeshConfig, devices=None, *, device=None):
    """The job's ``DeviceMesh`` with axes (data, pipe, model, seq) of
    ``cfg``'s sizes over every rank of the process group (CUDA unless
    ``device="cpu"``). ``devices`` is accepted for the reference's
    signature; each rank contributes its own device."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if cfg.num_devices != 1:
            raise ValueError(
                f"mesh {cfg.shape} needs {cfg.num_devices} devices, have 1 "
                "(initialize_distributed first)")
        _single_rank_group(dev)
    world = dist.get_world_size()
    if cfg.num_devices != world:
        raise ValueError(
            f"mesh {cfg.shape} needs {cfg.num_devices} devices, have {world}")
    return init_device_mesh(dev.type, cfg.shape,
                            mesh_dim_names=MeshConfig.AXIS_NAMES)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (the reference's ``mesh.shape``)."""
    names = mesh.mesh_dim_names
    return {n: mesh.size(i) for i, n in enumerate(names)}


def axis_group(mesh, axis: str):
    """The process group of ``axis`` of a ``DeviceMesh``: the ranks that
    share this rank's coordinates on every other axis."""
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_backend(mesh, axis: str) -> str:
    """The backend ("nccl", "gloo") of ``axis``'s process group."""
    return str(dist.get_backend(axis_group(mesh, axis)))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass
class MeshRuntime:
    """Owns the mesh and the common placements for one job."""

    cfg: MeshConfig
    mesh: object  # torch.distributed.device_mesh.DeviceMesh

    @classmethod
    def create(cls, cfg: MeshConfig | None = None, devices=None, *,
               device=None) -> "MeshRuntime":
        if cfg is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            cfg = MeshConfig(data=world)
        return cls(cfg=cfg, mesh=make_mesh(cfg, devices, device=device))

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    # Common placements -------------------------------------------------
    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    @property
    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    @property
    def batch_sharded(self) -> NamedSharding:
        """Batch dim over (data,); used for inputs."""
        return NamedSharding(self.mesh, P(("data",)))

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (its ``data`` coordinate's
        block of dim 0), on its device."""
        sh = self.batch_sharded
        return {k: sh.local(torch.as_tensor(v)).to(self.device)
                for k, v in batch.items()}

    def replicate(self, tree: dict) -> dict:
        """The whole of every tensor, on this rank's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in tree.items()}

    # Introspection -----------------------------------------------------
    def describe(self) -> dict:
        dev = self.device
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        return {
            "axes": self.cfg.axis_sizes(),
            "num_devices": self.cfg.num_devices,
            "device_kinds": [kind],
        }


def local_device_info() -> list[dict]:
    """Per-device capacity of this host's CUDA devices (the reference's
    per-device ``memory_stats`` report); one CPU entry without CUDA."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu",
                 "bytes_limit": None, "bytes_in_use": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({
            "id": i,
            "platform": "gpu",
            "device_kind": props.name,
            "bytes_limit": props.total_memory,
            "bytes_in_use": torch.cuda.memory_allocated(i),
        })
    return out
