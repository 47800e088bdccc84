"""Build the port's CUDA kernels from ``csrc/`` at first use.

Each source is a plain-C-interface ``.cu`` file compiled by ``nvcc`` into
its own shared library and bound with ``ctypes`` (no PyTorch headers: a
file that includes them takes minutes to build, one with a plain C
interface seconds). Libraries land in ``build/torch_kernels/`` at the root
of the checkout, named by the hash of their source and flags so an edited
source never loads a stale library. ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them.

Flags: ``sm_90a`` (Hopper) and ``-O3`` for every source, plus each
source's own: ``nms_keep_mask`` adds ``--fmad=false`` so no ``a*b+c`` is
contracted into an FMA -- the NMS IoU must round exactly like its XLA
twin. The flash-attention sources (the float32 forward and backward, and
the tensor-core forward, dq and dk/dv) keep FMA contraction (the flag
would halve their f32 rate). Never ``--use_fast_math``. Each source builds into its
own library, so a compile error in one cannot break another's build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# Kernel name -> source under the package's csrc/.
SOURCES: Dict[str, str] = {
    "nms_keep_mask": "csrc/nms_keep_mask.cu",
    "flash_attention_fwd": "csrc/flash_attention_fwd.cu",
    "flash_attention_fwd_sm90": "csrc/flash_attention_fwd_sm90.cu",
    "flash_attention_bwd": "csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq_sm90": "csrc/flash_attention_bwd_dq_sm90.cu",
    "flash_attention_bwd_dkv_sm90": "csrc/flash_attention_bwd_dkv_sm90.cu",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

# Flags of one source only, after NVCC_FLAGS.
SOURCE_FLAGS: Dict[str, tuple] = {
    "nms_keep_mask": ("--fmad=false",),
}


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def toolkit_binary(tool: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``); raises if
    the toolkit does not have it."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", tool))
    candidates.append(f"/usr/local/cuda/bin/{tool}")
    for path in candidates:
        if os.path.exists(path):
            return path
    found = shutil.which(tool)
    if found is None:
        raise RuntimeError(f"{tool} not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return found


def source_path(name: str) -> Path:
    return _PKG / SOURCES[name]


def nvcc_flags(name: str) -> tuple:
    """Every flag ``nvcc`` gets for kernel ``name``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    digest = hashlib.sha256(source_path(name).read_bytes())
    digest.update("\0".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[list] = None) -> Dict[str, str]:
    """Build (or load cached) every kernel in ``names`` (default: all),
    one ``nvcc`` per missing library, all started together. Returns the
    nvcc/ptxas output of each kernel built now. Raises if any build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if name in _libs or out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [toolkit_binary(), *nvcc_flags(name), "-o", str(tmp), str(source_path(name))]
            procs[name] = (out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, errors = {}, []
        for name, (out, tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed building {name} "
                              f"(exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(library_path(name)))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for kernel ``name`` (building it on first use)."""
    if name not in _libs:
        build_all([name])
    return _libs[name]
