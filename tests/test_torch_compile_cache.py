"""PyTorch port, runtime/compile_cache.py and the build keys it relies on
(``ops/_build.py``, ``native``), on the CPU with ``nvcc`` patched out:

- a library's name keys on the source, the shared headers, the
  ``nvcc --version`` text and ``ARCH_FLAGS`` (a directory shared across
  hosts never hands one toolkit's build to another);
- ``build`` reports whether it ran the compiler, ``load`` records a
  cache hit when the library was already on disk;
- ``enable_compile_cache``: argument or ``$TL_COMPILE_CACHE_DIR``, first
  directory wins (a conflict is counted), an unwritable directory is
  "off"; both build directories follow it; ``cache_entries`` counts
  libraries;
- the serving engines report the loaded libraries under
  ``stats()["compile"]``."""

import os
import subprocess

import pytest
import torch

from tensorlink_tpu_torch import native
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.parallel.inference import InferenceEngine
from tensorlink_tpu_torch.parallel.serving import PagedContinuousBatchingEngine
from tensorlink_tpu_torch.runtime import compile_cache as cc


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """Isolated cache state: no active directory, zeroed counts, build
    directories restored afterwards."""
    monkeypatch.setattr(cc, "_active_dir", None)
    monkeypatch.setattr(cc, "COUNTS", dict.fromkeys(cc.COUNTS, 0))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    return tmp_path


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """A csrc/ of one kernel and an ``nvcc`` that writes its output file
    and counts its runs (this host has no toolkit)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text("int f() { return 1; }\n")
    (csrc / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_version", lambda: "nvcc: release 12.4")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    runs = []

    def run(cmd, **kw):
        runs.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "nvcc_runs", 0)
    return runs


def test_library_key_covers_the_toolkit_and_the_flags(fake_nvcc, monkeypatch):
    base = _build.library_path("kern.cu")
    monkeypatch.setattr(_build, "nvcc_version", lambda: "nvcc: release 12.8")
    other_toolkit = _build.library_path("kern.cu")
    assert other_toolkit != base
    monkeypatch.setattr(_build, "ARCH_FLAGS", ["-gencode", "arch=compute_90,code=sm_90"])
    assert _build.library_path("kern.cu") not in (base, other_toolkit)


def test_build_reports_whether_nvcc_ran(fake_nvcc):
    path, _, ran = _build.build("kern.cu")
    assert ran and os.path.exists(path) and len(fake_nvcc) == 1
    # atomic: nothing but the library is left in the directory
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    again, _, ran2 = _build.build("kern.cu")
    assert again == path and not ran2 and len(fake_nvcc) == 1
    assert _build.nvcc_runs == 1


def test_load_records_a_cache_hit(fake_nvcc, monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILDS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    _build.load("kern.cu")
    assert _build.BUILDS["kern.cu"]["compile_cache_hit"] is False
    # a second process on the same directory: the library is on disk
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILDS", {})
    _build.load("kern.cu")
    assert _build.BUILDS["kern.cu"]["compile_cache_hit"] is True
    assert len(fake_nvcc) == 1


def test_enable_points_both_builds_and_first_dir_wins(fresh):
    d1, d2 = fresh / "cache1", fresh / "cache2"
    got = cc.enable_compile_cache(str(d1))
    assert got == str(d1.resolve()) and cc.active_dir() == got
    assert _build.BUILD_DIR == got and native.BUILD_DIR == got
    assert cc.enable_compile_cache(str(d2)) == got  # not honoured
    assert cc.COUNTS["conflicts"] == 1
    assert cc.enable_compile_cache(str(d1)) == got  # same dir: no conflict
    assert cc.COUNTS["conflicts"] == 1
    assert cc.enable_compile_cache(None) == got  # nothing asked: the active one


def test_env_var_and_unwritable_dir(fresh, monkeypatch):
    assert cc.enable_compile_cache(None) is None  # neither set: off
    blocker = fresh / "file"
    blocker.write_text("x")
    monkeypatch.setenv(cc.ENV_VAR, str(blocker / "sub"))  # cannot be made
    assert cc.enable_compile_cache(None) is None
    assert cc.COUNTS["init_failed"] == 1 and cc.active_dir() is None
    monkeypatch.setenv(cc.ENV_VAR, str(fresh / "env"))
    assert cc.enable_compile_cache(None) == str((fresh / "env").resolve())


def test_cache_entries_counts_libraries(tmp_path):
    assert cc.cache_entries(None) == 0
    assert cc.cache_entries(str(tmp_path / "missing")) == 0
    (tmp_path / "liba-1.so").write_bytes(b"")
    (tmp_path / "libb-2.so").write_bytes(b"")
    (tmp_path / "libb-2.so.123.tmp").write_bytes(b"")  # a build in flight
    (tmp_path / ".probe-x").write_bytes(b"")
    assert cc.cache_entries(str(tmp_path)) == 2


def test_runtime_fingerprint_names_the_runtime():
    rt = cc.runtime_fingerprint()
    assert rt["torch"] == torch.__version__ and rt["cuda"] == torch.version.cuda
    assert rt["chip"] == (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu")


def test_engine_reports_the_libraries(fresh):
    eng = InferenceEngine(Llama(LlamaConfig.tiny(), device="cpu"), max_len=32,
                          device="cpu", cache_dtype=torch.float32,
                          param_dtype=torch.float32)
    sch = PagedContinuousBatchingEngine(eng, slots=2, block_size=8, prefill_chunk=8,
                                        compile_cache_dir=str(fresh / "cc"))
    comp = sch.stats()["compile"]
    assert comp["cache_dir"] == str((fresh / "cc").resolve())
    assert comp["compile_cache_hits"] + comp["compile_cache_misses"] == len(comp["libraries"])
    for rec in comp["libraries"].values():
        assert set(rec) == {"path", "compile_cache_hit", "build_s"}
