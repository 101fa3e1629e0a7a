"""A session-wide cache of the JAX package's reference results for the
port's tests, and one torch thread a pytest-xdist worker.

Under pytest-xdist every worker that takes one case of a module builds
that module's fixtures, and every JAX scheduler compiles its programs
anew, so the same JAX reference would be computed once a worker.
``reference(tmp_path_factory, key, compute)`` computes it once a test
session instead: the first caller runs ``compute()`` under a file lock
and pickles the result (numpy arrays, numbers, lists and dicts of them)
into a directory every worker of the session shares; the others wait on
the lock and load it. Without xdist the directory is the session's own
temporary directory, so nothing outlives the session.

Importing this module under xdist also sets torch's intra-op threads to
one in that worker (``single_thread_under_xdist``): six workers of eight
threads each on an eight-core host spend the port's tiny CPU tensors'
time in an oversubscribed thread pool. Every xdist worker imports every
test module while collecting, so the setting holds in each worker.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import torch
from filelock import FileLock


def single_thread_under_xdist() -> None:
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


single_thread_under_xdist()


def session_dir(tmp_path_factory) -> Path:
    """A directory shared by every worker of this test session: under
    xdist a worker's base temporary directory is ``<session>/popen-gwN``,
    so its parent is the session's."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    d = root / "jax-reference"
    d.mkdir(exist_ok=True)
    return d


def reference(tmp_path_factory, key: str, compute):
    """``compute()``'s result, computed once a session under ``key``."""
    path = session_dir(tmp_path_factory) / f"{key}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        return value
