"""The PyTorch port stands alone: no file of ``tensorlink_tpu_torch/``
(nor ``chip_smoke.py`` or ``tools/kernel_ab.py``) imports JAX or the JAX package, importing the
port leaves JAX unloaded, and the entry points never fall back to the
CPU on their own."""

import ast
import os
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
from tensorlink_tpu_torch.parallel.inference import InferenceEngine
from tensorlink_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tensorlink_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "tensorlink_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tools", "kernel_ab.py")]
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
    bad = [
        (os.path.relpath(p, REPO), root)
        for p in files for root in _imported_roots(p) if root in FORBIDDEN
    ]
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


def test_entry_points_need_a_device_where_cuda_is_absent():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(LlamaConfig.tiny())
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
