"""The port stands alone: it imports neither JAX, flax nor any module of the
JAX package, and its entry points refuse to fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "video_edge_ai_proxy_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "video_edge_ai_proxy_tpu")


def _port_sources():
    # tools/torch_soak_replay.py drives the port alone (the other
    # tools/torch_*.py hold the port against the JAX package).
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "torch_soak_replay.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_anywhere_in_the_source(path):
    """Covers imports inside functions too, which importing cannot see."""
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import video_edge_ai_proxy_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")


def _resolve():
    from video_edge_ai_proxy_tpu_torch.device import resolve_device

    resolve_device()


def _init_params():
    from video_edge_ai_proxy_tpu_torch.models import registry

    registry.get("tiny_yolov8").init_params()


def _engine():
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine

    InferenceEngine(MemoryFrameBus())


@pytest.mark.parametrize("entry", [_resolve, _init_params, _engine],
                         ids=["resolve_device", "init_params", "InferenceEngine"])
def test_entry_point_without_gpu_raises(entry):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_cpu_is_served_only_when_asked():
    from video_edge_ai_proxy_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
