"""PyTorch port, ops/_build.py: the library cache key covers the shared
headers. ``library_path`` names a source's build by a hash of the source
and of every ``csrc/*.cuh``, so an edit to a header that a kernel
includes rebuilds it instead of loading a stale library. Runs on the
CPU: nothing is compiled."""

import os

from tensorlink_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "common.cuh"\nint f() { return 1; }\n')
    (csrc / "common.cuh").write_text("#pragma once\n#define ONE 1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def test_library_path_is_stable_when_nothing_changes(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    first = _build.library_path("kern.cu")
    assert first == _build.library_path("kern.cu")
    assert first.startswith(str(tmp_path / "_build"))
    assert first.endswith(".so")


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("kern.cu")
    (csrc / "common.cuh").write_text("#pragma once\n#define ONE 2\n")
    assert _build.library_path("kern.cu") != before
    # a new header counts too
    edited = _build.library_path("kern.cu")
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert _build.library_path("kern.cu") != edited


def test_library_path_changes_with_the_source(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("kern.cu")
    (csrc / "kern.cu").write_text('#include "common.cuh"\nint f() { return 2; }\n')
    assert _build.library_path("kern.cu") != before


def test_each_source_of_the_package_has_its_own_library():
    sources = ("paged_decode.cu", "flash_attention.cu", "flash_attention_f32.cu",
               "decode_glue.cu")
    assert all(os.path.exists(os.path.join(_build.CSRC_DIR, s)) for s in sources)
    paths = {_build.library_path(s) for s in sources}
    assert len(paths) == len(sources)
