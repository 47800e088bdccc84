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
# Packages the card's machine does not have: the port reads their formats
# itself (utils/checkpoint.py, models/import_weights.py).
ABSENT_ON_CARD = ("msgpack", "safetensors")


# The tools that drive the port alone (the other tools/torch_*.py hold the
# port against the JAX package).
PORT_TOOLS = ("torch_soak_replay.py", "torch_router_smoke.py", "torch_autoscale_smoke.py",
              "torch_capacity_smoke.py", "torch_import_weights.py", "torch_eval_detector.py",
              "torch_selftrain_e2e.py", "torch_multichip_serve_smoke.py", "torch_fault_smoke.py")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "tools" / name for name in PORT_TOOLS]


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
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN + ABSENT_ON_CARD))
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


# The camera tier's modules, which worker processes load (a worker runs
# under RLIMIT_AS and away from the card): none may load torch, directly
# or through a package's __init__, nor grpc.
WORKER_SIDE = ("utils.logging", "utils.cbuild", "ingest", "ingest.av", "ingest.sources",
               "ingest.archive", "ingest.passthrough", "ingest.worker", "ingest.native",
               "bus", "bus.resp", "bus.miniredis", "bus.redis_bus", "bus.shm_bus",
               "uplink.redis_queue")


@pytest.mark.parametrize("module", WORKER_SIDE)
def test_worker_side_modules_load_no_torch(module):
    code = (f"import sys, video_edge_ai_proxy_tpu_torch.{module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch', 'grpc')!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]", proc.stdout


def test_the_new_modules_are_in_the_source_scan():
    names = {str(p.relative_to(PKG)) for p in _port_sources() if p.is_relative_to(PKG)}
    for rel in ("utils/logging.py", "ingest/av.py", "ingest/passthrough.py", "bus/resp.py",
                "bus/miniredis.py", "bus/redis_bus.py", "uplink/redis_queue.py",
                "ingest/native/__init__.py"):
        assert rel in names, rel
    assert (PKG / "ingest" / "native" / "vepav.cpp").is_file()


# The fleet tier's control plane runs in router and supervisor processes
# of its own: importable without torch, like JAX's without jax.
CONTROL_PLANE = ("obs.capacity", "obs.fleet", "obs.journal", "serve.router",
                 "serve.supervisor", "resilience.ladder")


@pytest.mark.parametrize("module", CONTROL_PLANE)
def test_fleet_control_plane_loads_no_torch(module):
    test_worker_side_modules_load_no_torch(module)


def test_the_self_training_modules_are_in_the_source_scan():
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("utils/checkpoint.py", "models/detect_loss.py", "ops/augment.py",
                "data/segments.py", "data/__init__.py"):
        assert f"video_edge_ai_proxy_tpu_torch/{rel}" in names, rel


def test_the_fleet_tier_modules_are_in_the_source_scan():
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("obs/capacity.py", "obs/fleet.py", "serve/router.py", "serve/supervisor.py",
                "replay/harness.py"):
        assert f"video_edge_ai_proxy_tpu_torch/{rel}" in names, rel
    for name in PORT_TOOLS:
        assert f"tools/{name}" in names and (ROOT / "tools" / name).is_file(), name


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


def _fleet_member(tmp_path):
    from video_edge_ai_proxy_tpu_torch.replay.harness import _fleet_member_main

    _fleet_member_main(["--instance", "m0", "--workdir", str(tmp_path), "--serve-only",
                        "--spans-out", str(tmp_path / "spans.json")])


def _fleet_obs(tmp_path):
    from video_edge_ai_proxy_tpu_torch.replay.harness import run_fleet_obs

    run_fleet_obs(n_members=1, workdir=str(tmp_path))


def _selftrain(tmp_path):
    sys.path.insert(0, str(ROOT))
    from tools import torch_selftrain_e2e

    torch_selftrain_e2e.run("tiny_yolov8", steps=1, workdir=str(tmp_path))


@pytest.mark.parametrize("entry", [_resolve, _init_params, _engine, _fleet_member, _fleet_obs,
                                   _selftrain],
                         ids=["resolve_device", "init_params", "InferenceEngine",
                              "fleet_member", "run_fleet_obs", "selftrain"])
def test_entry_point_without_gpu_raises(entry, tmp_path):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(tmp_path) if entry in (_fleet_member, _fleet_obs, _selftrain) else entry()


def test_cpu_is_served_only_when_asked():
    from video_edge_ai_proxy_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
