"""Build-at-first-use of the port's native host libraries (counterpart of
``video_edge_ai_proxy_tpu/utils/cbuild.py``).

A library has a plain C ABI bound with ``ctypes`` (no Python C API), so a
build is one ``g++ -O2 -std=c++17 -shared -fPIC``. The shared object lands
in ``build/native/`` at the root of the checkout, named by the hash of its
source and link flags, so an edited source never loads a stale library.
Nothing is built at import: the first ``ShmFrameBus`` of a process builds
or finds its library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_LOCK = threading.Lock()

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"


def build_library(src: str, name: str, ldflags: Sequence[str] = ()) -> str:
    """The path of the shared object built from ``src``, building it when
    it is not there yet. Processes that build at once race benignly: each
    compiles to a file of its own and renames it into place. Raises
    RuntimeError with the compiler's output on failure."""
    with open(src, "rb") as fh:
        h = hashlib.sha256(fh.read())
    for flag in ldflags:
        h.update(flag.encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    with _LOCK:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra",
               src, "-o", tmp, *ldflags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} native build failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)
