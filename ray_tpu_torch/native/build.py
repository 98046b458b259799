"""On-demand build of the native components (the port of
ray_tpu/native/build.py).

The C++ sources are compiled once, at first use, with g++ into
`ray_tpu_torch/_build/`, as `ops/_build.py` builds the CUDA kernels: the
library is named by a hash of its sources and compiled to a temporary name,
then moved into place with `os.replace`. The GCS, the raylets and the workers
of a new cluster may all reach the build at once; each either finds the
finished library or replaces it atomically with an identical one. (The JAX
copy compares mtimes and writes its output in place.)
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
_lock = threading.Lock()


def library_path(name: str, sources: List[str]) -> Path:
    h = hashlib.sha256()
    for s in sources:
        h.update(s.encode() + b"\0" + (NATIVE_DIR / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: List[str]) -> str:
    """Compiles `sources` into lib<name>-<hash>.so unless it exists; returns its path."""
    out = library_path(name, sources)
    with _lock:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = (["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp)]
               + [str(NATIVE_DIR / s) for s in sources] + ["-lpthread"])
        # The lock serialises concurrent builders of the one output file;
        # nothing latency-sensitive contends on it.
        proc = subprocess.run(cmd, capture_output=True, text=True)  # lint: disable=blocking-in-loop
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {sources}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return str(out)


def shm_pool_lib() -> str:
    return build_library("shm_pool", ["shm_pool.cc"])
