"""The PyTorch port stands alone: no file of ``tensorlink_tpu_torch/``
(nor ``chip_smoke.py``, the ``tools/`` scripts for the card or the test
modules spawned ranks import) imports JAX or the JAX package, importing
the port leaves JAX unloaded, and the entry points never fall back to
the CPU on their own."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.config import TrainConfig
from tensorlink_tpu_torch.data.loader import prefetch_to_device
from tensorlink_tpu_torch.models.bert import Bert, BertClassifier, BertConfig
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
from tensorlink_tpu_torch.nn.module import module_from_config
from tensorlink_tpu_torch.parallel.inference import InferenceEngine
from tensorlink_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tensorlink_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "tensorlink_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tools", "kernel_ab.py"),
           os.path.join(REPO, "tools", "gloo_cuda_check.py"),
           os.path.join(REPO, "tools", "flash_check.py"),
           os.path.join(REPO, "tools", "zoo_legs.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    # every subpackage is scanned, runtime/ (the CUDA-graph cache) too
    assert os.path.join(PORT, "runtime", "graphs.py") in files
    assert os.path.join(PORT, "parallel", "speculative.py") in files
    for mod in ("compile_cache.py", "autotune.py", "chaos.py"):
        assert os.path.join(PORT, "runtime", mod) in files
    assert os.path.join(PORT, "nn", "moe.py") in files
    for mod in (("nn", "lora.py"), ("nn", "module.py"), ("models", "mlp.py"),
                ("runtime", "checkpoint.py"), ("runtime", "metrics.py"),
                ("runtime", "mesh.py"), ("parallel", "dp.py"), ("parallel", "tp.py"),
                ("parallel", "pp.py"), ("parallel", "pp1f1b.py"),
                ("parallel", "engine.py"), ("parallel", "sp.py"),
                ("parallel", "ep.py"), ("utils", "logging.py"),
                ("runtime", "tracing.py"), ("runtime", "timeseries.py"),
                ("runtime", "alerts.py"), ("runtime", "flight.py"),
                ("runtime", "http_status.py"), ("p2p", "node.py"),
                ("p2p", "connection.py"), ("chain", "registry.py"),
                ("roles", "jobs.py"), ("nn", "staging.py"),
                ("parallel", "pipeserve.py"), ("roles", "pol.py"),
                ("roles", "privacy.py"), ("roles", "worker.py"),
                ("roles", "user.py"), ("roles", "validator.py"),
                ("__main__.py",), ("diag.py",), ("models", "vit.py"),
                ("models", "t5.py"), ("models", "hf_import.py"),
                ("models", "torch_ingest.py")):
        assert os.path.join(PORT, *mod) in files
    bad = [
        (os.path.relpath(p, REPO), root)
        for p in files for root in _imported_roots(p) if root in FORBIDDEN
    ]
    assert not bad, bad


def _reference_names(path):
    """String constants outside docstrings that name the JAX package's
    modules or loggers (``"tensorlink_tpu.runtime.tracing"``,
    ``f"tensorlink_tpu.{name}"``): a ``sys.modules`` lookup or a logger
    under such a name would read the reference, not the copy."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    pat = re.compile(r"tensorlink_tpu(\.|$)")
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs and pat.match(n.value)]


def test_no_port_file_names_the_jax_packages_modules():
    bad = [(os.path.relpath(p, REPO), s) for p in _port_files()
           for s in _reference_names(p)]
    assert not bad, bad


# packages the card's host may lack: never imported by the port
# (msgpack, ml_dtypes), or only inside a try that keeps the reference's
# fallback (zstandard: zlib blobs; cryptography: the dev identity)
NOT_IMPORTED = ("msgpack", "ml_dtypes")
GUARDED = ("zstandard", "cryptography")


def _guarded_imports(path):
    """-> (root, inside a try with an ImportError handler) per import."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                for h in node.handlers):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    guarded.add(id(sub))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        for root in roots:
            yield root, id(node) in guarded


def test_wire_and_receipt_modules_need_no_optional_package():
    files = _port_files()
    for mod in (("native", "__init__.py"), ("p2p", "serialization.py"),
                ("p2p", "crypto.py"), ("parallel", "kvwire.py"),
                ("runtime", "ledger.py"), ("runtime", "profiling.py")):
        assert os.path.join(PORT, *mod) in files
    bad = []
    for p in files:
        for root, guarded in _guarded_imports(p):
            if root in NOT_IMPORTED or (root in GUARDED and not guarded):
                bad.append((os.path.relpath(p, REPO), root))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = [
        "tensorlink_tpu_torch.parallel.serving",
        "tensorlink_tpu_torch.parallel.speculative",
        "tensorlink_tpu_torch.runtime.graphs",
        "tensorlink_tpu_torch.models.llama",
        "tensorlink_tpu_torch.models.gpt2",
        "tensorlink_tpu_torch.parallel.inference",
        "tensorlink_tpu_torch.nn.attention",
        "tensorlink_tpu_torch.convert",
        "tensorlink_tpu_torch.ops.decode_glue",
        "tensorlink_tpu_torch.ops.paged_decode",
        "tensorlink_tpu_torch.ops.flash",
        "tensorlink_tpu_torch.ops.flash_attention",
        "tensorlink_tpu_torch.models.bert",
        "tensorlink_tpu_torch.train.trainer",
        "tensorlink_tpu_torch.train.optim",
        "tensorlink_tpu_torch.data.loader",
        "tensorlink_tpu_torch.config",
        "tensorlink_tpu_torch.utils.trees",
        "tensorlink_tpu_torch.native",
        "tensorlink_tpu_torch.p2p.serialization",
        "tensorlink_tpu_torch.p2p.crypto",
        "tensorlink_tpu_torch.parallel.kvwire",
        "tensorlink_tpu_torch.runtime.ledger",
        "tensorlink_tpu_torch.runtime.profiling",
        "tensorlink_tpu_torch.runtime.compile_cache",
        "tensorlink_tpu_torch.runtime.autotune",
        "tensorlink_tpu_torch.runtime.chaos",
        "tensorlink_tpu_torch.ops.quant",
        "tensorlink_tpu_torch.nn.layers",
        "tensorlink_tpu_torch.nn.moe",
        "tensorlink_tpu_torch.nn",
        "tensorlink_tpu_torch.nn.lora",
        "tensorlink_tpu_torch.nn.module",
        "tensorlink_tpu_torch.models.mlp",
        "tensorlink_tpu_torch.runtime.checkpoint",
        "tensorlink_tpu_torch.runtime.metrics",
        "tensorlink_tpu_torch.runtime.mesh",
        "tensorlink_tpu_torch.parallel.dp",
        "tensorlink_tpu_torch.parallel.tp",
        "tensorlink_tpu_torch.parallel.pp",
        "tensorlink_tpu_torch.parallel.pp1f1b",
        "tensorlink_tpu_torch.parallel.engine",
        "tensorlink_tpu_torch.parallel.ep",
        "tensorlink_tpu_torch.utils.logging",
        "tensorlink_tpu_torch.runtime.tracing",
        "tensorlink_tpu_torch.runtime.timeseries",
        "tensorlink_tpu_torch.runtime.alerts",
        "tensorlink_tpu_torch.runtime.flight",
        "tensorlink_tpu_torch.runtime.http_status",
        "tensorlink_tpu_torch.p2p.connection",
        "tensorlink_tpu_torch.diag",
        "tensorlink_tpu_torch.models",
        "tensorlink_tpu_torch.models.vit",
        "tensorlink_tpu_torch.models.t5",
        "tensorlink_tpu_torch.models.hf_import",
        "tensorlink_tpu_torch.models.torch_ingest",
        "tensorlink_tpu_torch.p2p.dht",
        "tensorlink_tpu_torch.p2p.nat",
        "tensorlink_tpu_torch.p2p.node",
        "tensorlink_tpu_torch.chain",
        "tensorlink_tpu_torch.chain.mock",
        "tensorlink_tpu_torch.roles",
        "tensorlink_tpu_torch.nn.staging",
        "tensorlink_tpu_torch.parallel.pipeserve",
        "tensorlink_tpu_torch.roles.pol",
        "tensorlink_tpu_torch.roles.privacy",
        "tensorlink_tpu_torch.roles.worker",
        "tensorlink_tpu_torch.roles.user",
        "tensorlink_tpu_torch.roles.validator",
        "tensorlink_tpu_torch.__main__",
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN) + "]\n"
        + "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


# test modules whose functions spawned ranks import: they stand on the port
RANK_MODULES = ("torch_ranks", "torch_tp_serving_ranks", "torch_sp_ranks",
                "torch_ep_ranks")


def test_rank_body_modules_import_no_jax():
    for name in RANK_MODULES:
        path = os.path.join(REPO, "tests", f"{name}.py")
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, (name, bad)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        + "".join(f"import {m}\n" for m in RANK_MODULES)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN) + "]\n"
        + "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_entry_points_need_a_device_where_cuda_is_absent():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(LlamaConfig.moe_tiny())
    model = Llama(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, max_len=32)
    eng = InferenceEngine(model, max_len=32, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT2(GPT2Config.tiny())
    gpt2 = GPT2(GPT2Config.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(gpt2, max_len=32)
    assert gpt2.init_caches(1, 8)[0]["attn"]["k"].device.type == "cpu"


def test_training_entry_points_need_a_device_where_cuda_is_absent():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Bert(BertConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        BertClassifier(BertConfig.tiny(), 3)
    model = BertClassifier(BertConfig.tiny(), 3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, lambda *a: None, TrainConfig())
    assert Trainer(model, lambda *a: None, TrainConfig(), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([{"x": [1]}])))
    with pytest.raises(RuntimeError, match="CUDA"):
        MLP(MLPConfig())
    assert MLP(MLPConfig(), device="cpu").seq[0].w.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        module_from_config({"__type__": "Dense", "in_dim": 2, "out_dim": 3})
    dense = module_from_config({"__type__": "Dense", "in_dim": 2, "out_dim": 3},
                               device="cpu")
    assert dense.w.device.type == "cpu"


def test_mesh_and_sharded_trainer_need_a_device_where_cuda_is_absent():
    from tensorlink_tpu_torch.config import MeshConfig
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
    from tensorlink_tpu_torch.runtime.mesh import make_mesh, shutdown_distributed

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshConfig())
    gpt2 = GPT2(GPT2Config.tiny(), device="cpu")
    try:
        mesh = make_mesh(MeshConfig(), device="cpu")
        assert mesh.device_type == "cpu"
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedTrainer(mesh, TrainConfig(), gpt2.as_pipeline_parts(),
                           lambda o, b: 0.0)
        tr = ShardedTrainer(mesh, TrainConfig(), gpt2.as_pipeline_parts(),
                            lambda o, b: 0.0, device="cpu")
        assert tr.device.type == "cpu"
    finally:
        shutdown_distributed()


def test_roles_need_a_device_where_cuda_is_absent():
    """A worker, a validator, a stage runner and a pipeline stage (through
    its engine) run on CUDA unless given the CPU: without CUDA each
    raises instead of falling back."""
    from tensorlink_tpu_torch.config import NodeConfig
    from tensorlink_tpu_torch.nn.staging import StageSlice
    from tensorlink_tpu_torch.parallel.pipeserve import PipelineStageEngine
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import StageRunner, WorkerNode
    from tensorlink_tpu_torch.train.optim import make_optimizer

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerNode(NodeConfig(role="worker", port=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ValidatorNode(NodeConfig(role="validator", port=0))
    assert WorkerNode(NodeConfig(role="worker", port=0), device="cpu").device.type == "cpu"
    mlp = MLP(MLPConfig(in_dim=4, hidden_dim=4, out_dim=2), device="cpu")
    params = dict(mlp.seq.named_parameters())
    opt = make_optimizer("sgd", 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        StageRunner(job_id="j", stage_index=0, module=mlp.seq, params=params,
                    opt=opt, opt_state=opt.init(params))
    model = Llama(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineStageEngine(InferenceEngine(model, max_len=32), lo=0, hi=1)
    stage = PipelineStageEngine(InferenceEngine(model, max_len=32, device="cpu"),
                                lo=0, hi=1, block_size=4)
    assert stage.device.type == "cpu" and stage._valid.device.type == "cpu"
    assert StageSlice(model, 0, 2).last
