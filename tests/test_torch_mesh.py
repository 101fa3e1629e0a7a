"""PyTorch port, runtime/mesh.py, the placements of nn/module.py and the
multi-process ``ShardedLoader``.

In one process: ``make_mesh`` at world 1 forms its own gloo group over
a file store (and refuses a bigger mesh), ``MeshRuntime``'s placements,
``local_device_info``, ``PartitionSpec``/``NamedSharding`` blocks on a
stub mesh, and the loader's process shards against the JAX loader's
global batch, row for row. On two spawned gloo ranks that join through
``initialize_distributed`` (a ``file://`` coordinator): the reference's
summary dict, the mesh's axes, each rank's rows of a global batch, and
a loader on a data 1 x pipe 2 mesh giving both pipe ranks the same rows.

Top level: torch and the port only (spawned ranks import this module).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tensorlink_tpu_torch.config import DistributedConfig, MeshConfig
from tensorlink_tpu_torch.data.loader import ShardedLoader
from tensorlink_tpu_torch.nn.module import (
    NamedSharding,
    P,
    PartitionSpec,
    spec_tree_to_shardings,
)
from tensorlink_tpu_torch.runtime import mesh as tmesh


class _StubMesh:
    mesh_dim_names = ("data", "pipe", "model", "seq")

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]


def test_partition_spec_is_a_tuple_like_jax():
    from jax.sharding import PartitionSpec as JP

    for entries in [(), ("pipe", None, "model"), (("data", "model"),), (None, "data")]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    s = PartitionSpec("pipe", None, ("data", "model"))
    assert s.axes(0) == ("pipe",) and s.axes(1) == () and s.axes(2) == ("data", "model")
    assert s.axes(5) == ()
    assert repr(P("model")) == "PartitionSpec('model',)"


@pytest.mark.parametrize("coords", [(0, 0, 0, 0), (1, 0, 1, 0), (1, 1, 1, 0)])
def test_named_sharding_blocks(coords):
    m = _StubMesh((2, 2, 2, 1), coords)
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    sh = NamedSharding(m, P(("data", "model"), None, "pipe"))
    assert sh.dims() == {0: ("data", "model"), 2: ("pipe",)}
    idx, n = sh.block(0)
    assert n == 4 and idx == coords[0] * 2 + coords[2]
    local = sh.local(t)
    assert tuple(local.shape) == sh.shard_shape(t.shape) == (2, 6, 2)
    torch.testing.assert_close(local, t[idx * 2:(idx + 1) * 2, :,
                                         coords[1] * 2:(coords[1] + 1) * 2])
    # a size-1 axis splits nothing
    assert NamedSharding(m, P("seq")).local(t) is t or torch.equal(
        NamedSharding(m, P("seq")).local(t), t)
    with pytest.raises(ValueError, match="split"):
        NamedSharding(m, P("data")).local(torch.zeros(3))
    tree = spec_tree_to_shardings({"a": P("model"), "b": {"c": P()}}, m)
    assert isinstance(tree["b"]["c"], NamedSharding) and tree["a"].spec == P("model")


def test_make_mesh_world1_and_placements():
    try:
        mesh = tmesh.make_mesh(MeshConfig(), device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tmesh.mesh_sizes(mesh) == {"data": 1, "pipe": 1, "model": 1, "seq": 1}
        assert mesh.mesh_dim_names == MeshConfig.AXIS_NAMES
        rt = tmesh.MeshRuntime(MeshConfig(), mesh)
        assert rt.describe() == {"axes": {"data": 1, "pipe": 1, "model": 1, "seq": 1},
                                 "num_devices": 1, "device_kinds": ["cpu"]}
        b = {"x": np.arange(12).reshape(6, 2)}
        np.testing.assert_array_equal(rt.shard_batch(b)["x"].numpy(), b["x"])
        np.testing.assert_array_equal(rt.replicate(b)["x"].numpy(), b["x"])
        assert rt.sharding("data").spec == P("data")
        assert rt.replicated.spec == P() and rt.batch_sharded.spec == P(("data",))
        with pytest.raises(ValueError, match="needs 2 devices"):
            tmesh.make_mesh(MeshConfig(data=2), device="cpu")
    finally:
        tmesh.shutdown_distributed()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_mesh(MeshConfig(pipe=4), device="cpu")
    assert tmesh.initialize_distributed(DistributedConfig()) == {"enabled": False}


def test_local_device_info():
    info = tmesh.local_device_info()
    assert info and set(info[0]) == {"id", "platform", "device_kind", "bytes_limit",
                                     "bytes_in_use"}
    if not torch.cuda.is_available():
        assert info[0]["platform"] == "cpu"


def _ds(n=48):
    return {"x": np.arange(n * 3).reshape(n, 3), "y": np.arange(n)}


def test_process_shards_partition_the_global_batch():
    from tensorlink_tpu.data.loader import ShardedLoader as JLoader

    ds = _ds(n=48)
    parts = [list(ShardedLoader(ds, global_batch=12, seed=3, process_index=i,
                                process_count=4)) for i in range(4)]
    full = list(JLoader(ds, global_batch=12, seed=3, shuffle=True,
                        process_index=0, process_count=1))
    for s in range(len(full)):
        glob = np.concatenate([parts[i][s]["x"] for i in range(4)])
        np.testing.assert_array_equal(glob, full[s]["x"])
    m = _StubMesh((2, 2, 1, 1), (1, 0, 0, 0))
    on_mesh = list(ShardedLoader(ds, global_batch=12, seed=3, mesh=m))
    both = [list(ShardedLoader(ds, global_batch=12, seed=3, process_index=i,
                               process_count=2)) for i in range(2)]
    for s in range(len(full)):
        np.testing.assert_array_equal(on_mesh[s]["x"], both[1][s]["x"])
    with pytest.raises(ValueError, match="mesh or"):
        ShardedLoader(ds, global_batch=12, mesh=m, process_index=0)


def _init_rank(rank, store, out_dir):
    torch.set_num_threads(1)
    info = tmesh.initialize_distributed(DistributedConfig(
        coordinator=f"file://{store}", num_processes=2, process_id=rank), device="cpu")
    try:
        again = tmesh.initialize_distributed(DistributedConfig(
            coordinator=f"file://{store}", num_processes=2, process_id=rank),
            device="cpu")
        mesh = tmesh.make_mesh(MeshConfig(data=2), device="cpu")
        rt = tmesh.MeshRuntime(MeshConfig(data=2), mesh)
        rows = rt.shard_batch({"x": np.arange(8)})["x"]
        pipe = tmesh.make_mesh(MeshConfig(pipe=2), device="cpu")
        loader = list(ShardedLoader(_ds(), global_batch=12, seed=5, mesh=pipe))
        on_data = list(ShardedLoader(_ds(), global_batch=12, seed=5, mesh=mesh))
        torch.save({"info": info, "again": again, "rows": rows,
                    "pipe_rows": [b["y"] for b in loader],
                    "data_rows": [b["y"] for b in on_data],
                    "pipe_rank": pipe.get_local_rank("pipe")},
                   os.path.join(out_dir, f"init{rank}.pt"))
    finally:
        tmesh.shutdown_distributed()


def test_two_ranks_initialize_mesh_and_loader(tmp_path):
    import torch.multiprocessing as mp

    mp.start_processes(_init_rank, args=(str(tmp_path / "store"), str(tmp_path)),
                       nprocs=2, start_method="spawn")
    outs = [torch.load(tmp_path / f"init{r}.pt", weights_only=False) for r in range(2)]
    for r, out in enumerate(outs):
        assert out["info"] == {"enabled": True, "process_id": r, "num_processes": 2,
                               "global_devices": 2, "local_devices": 1}
        assert out["again"] == out["info"]
        np.testing.assert_array_equal(out["rows"].numpy(), np.arange(8)[r * 4:(r + 1) * 4])
        assert out["pipe_rank"] == r
    # the pipe ranks of one data replica read the same (all) rows; the
    # data ranks read disjoint halves of each global batch
    for a, b in zip(outs[0]["pipe_rows"], outs[1]["pipe_rows"]):
        np.testing.assert_array_equal(a, b)
        assert len(a) == 12
    for a, b in zip(outs[0]["data_rows"], outs[1]["data_rows"]):
        assert len(a) == 6 and not set(a) & set(b)
