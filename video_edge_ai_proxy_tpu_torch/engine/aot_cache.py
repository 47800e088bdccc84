"""Prewarm manifest of the serving programs (counterpart of
``video_edge_ai_proxy_tpu/engine/aot_cache.py``).

A versioned JSON file in ``EngineConfig.aot_cache_dir`` records the
program set: one entry per ``(model, stem, geometry, bucket)`` serving
step an engine sharing the directory has served. A starting engine
prewarms the whole set before it takes traffic, so no batch waits for a
capture. On the card a program is a CUDA graph, which cannot be saved to
disk: the manifest saves the list, and each engine captures anew (the
kernels' libraries already persist in ``build/torch_kernels/``). So the
JAX module's ``configure`` (its persistent compile cache) has no
counterpart here.

Mismatch rule: a manifest whose ``version`` or ``stamp`` (torch's
version, CUDA's version and the device's name) differs from the running
process's is ignored, never an exception; the next record replaces it.
The JSON shape is the JAX module's, with ``stamp`` in place of
``jaxlib``. The port serves one card, so the JAX module's mesh key (the
sharded programs of a multi-chip member) is not written or read here.
Standard library and torch only.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

import torch

log = logging.getLogger("vep.torch.engine.aot_cache")

MANIFEST_VERSION = 1
MANIFEST_NAME = "prewarm_manifest.json"

# One process-wide lock: several engines in one process may share a
# directory; writers in other processes are covered by the atomic rename.
_manifest_lock = threading.Lock()


def _stamp() -> str:
    """What the program set was recorded under: torch's and CUDA's
    versions and the card's name ("cpu" without a card)."""
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return f"torch {torch.__version__} cuda {torch.version.cuda} {name}"


def manifest_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, MANIFEST_NAME)


def _program_key(prog: Dict[str, Any]) -> tuple:
    return (
        str(prog.get("model") or ""),
        str(prog.get("stem") or "classic"),
        int(prog.get("h", 0)),
        int(prog.get("w", 0)),
        int(prog.get("bucket", 0)),
    )


def load_manifest(cache_dir: str) -> Optional[List[Dict[str, Any]]]:
    """The recorded programs; None when nothing is usable (missing,
    unparseable, or a version or stamp mismatch: a clean start, never an
    exception)."""
    path = manifest_path(cache_dir)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        log.warning("unreadable prewarm manifest %s; ignoring", path, exc_info=True)
        return None
    if not isinstance(data, dict):
        log.warning("prewarm manifest %s is not a mapping; ignoring", path)
        return None
    if data.get("version") != MANIFEST_VERSION:
        log.warning("prewarm manifest %s version %r != %d; clean start",
                    path, data.get("version"), MANIFEST_VERSION)
        return None
    stamp = _stamp()
    if data.get("stamp") != stamp:
        log.warning("prewarm manifest %s recorded under %r, running %r; clean start",
                    path, data.get("stamp"), stamp)
        return None
    programs = data.get("programs")
    if not isinstance(programs, list):
        return None
    out: List[Dict[str, Any]] = []
    seen = set()
    for prog in programs:
        if not isinstance(prog, dict):
            continue
        try:
            key = _program_key(prog)
        except (TypeError, ValueError):
            continue
        if key in seen or key[4] <= 0:
            continue
        seen.add(key)
        out.append({"model": key[0] or None, "stem": key[1],
                    "h": key[2], "w": key[3], "bucket": key[4]})
    return out


def prewarm_entries(programs: List[Dict[str, Any]]) -> List[list]:
    """Manifest programs -> ``cfg.prewarm``-shaped 5-element entries
    (``[h, w, bucket, model, stem]``; model "" = the engine's own)."""
    return [[p["h"], p["w"], p["bucket"], p["model"] or "", p["stem"]] for p in programs]


def record_program(cache_dir: str, *, model: Optional[str], stem: str, src_hw: tuple,
                   bucket: int) -> None:
    """Merge one served program into the manifest: read, add, write to a
    temporary file and rename it over the old one, under the process lock,
    so that an engine starting meanwhile never reads a torn file. A stale
    manifest on disk is replaced, not merged into. Best effort: a failure
    is logged, never raised."""
    prog = {
        "model": model or None,
        "stem": stem or "classic",
        "h": int(src_hw[0]),
        "w": int(src_hw[1]),
        "bucket": int(bucket),
    }
    with _manifest_lock:
        try:
            existing = load_manifest(cache_dir) or []
            if _program_key(prog) in {_program_key(p) for p in existing}:
                return
            existing.append(prog)
            os.makedirs(cache_dir, exist_ok=True)
            path = manifest_path(cache_dir)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"version": MANIFEST_VERSION, "stamp": _stamp(),
                           "programs": existing}, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except Exception:   # best effort: the next start captures it on demand
            log.warning("could not record prewarm program %r in %s", prog, cache_dir,
                        exc_info=True)
