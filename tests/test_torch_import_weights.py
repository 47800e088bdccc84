"""The port's importer of published checkpoints
(``video_edge_ai_proxy_tpu_torch/models/import_weights.py``) against the
JAX package's.

On synthetic state dicts in the three community layouts (the golden torch
modules of ``tests/test_import_weights.py``: torchvision's ResNet,
ultralytics' YOLOv8, timm's ViT, with random weights and BatchNorm
statistics), the port's ``convert`` gives, key for key and bit for bit,
the ``state_dict`` that JAX's ``convert`` followed by ``from_flax`` gives:
the tiny twins, the ``s2d`` stem's fold, a channel-padded stem and an
exporter's ``model.`` prefix. The converted weights reproduce the golden
modules' outputs in the port's models (RTOL = ATOL = 2e-4). Accounting is
strict: a missing, an extra or a misshapen source tensor raises, naming
it. At full width (``yolov8s``, ``resnet50``, ``vit_b16``) every port
tensor maps to a distinct source key and back.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_import_weights import _TimmViT, _TvResNet, _UlYolo, _nchw, _randomize, _state
from video_edge_ai_proxy_tpu.models import import_weights as jiw
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.parallel.sharding import unbox
from video_edge_ai_proxy_tpu_torch.models import import_weights as iw
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models import yolov8 as pyolo
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax

RTOL = ATOL = 2e-4
GOLDEN = {"tiny_resnet": _TvResNet, "tiny_vit": _TimmViT, "tiny_yolov8": _UlYolo,
          "tiny_yolov8_s2d": _UlYolo}


def _source(name: str, seed: int = 0) -> tuple:
    golden = GOLDEN[name]().eval()
    _randomize(golden, seed)
    if name == "tiny_vit":
        with torch.no_grad():
            golden.cls_token.normal_(0, 0.5)
            golden.pos_embed.normal_(0, 0.5)
    return golden, _state(golden)


def _jax_then_carry(name: str, state: dict) -> dict:
    return from_flax(jax.tree_util.tree_map(np.asarray, unbox(jiw.convert(name, state))))


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_convert_equals_jax_convert_then_from_flax(name):
    _, state = _source(name)
    _assert_same(iw.convert(name, state), _jax_then_carry(name, state))


def test_exporter_prefix_and_padded_stem_equal_jax(monkeypatch):
    """An ultralytics dict under ``model.model.`` onto a tiny YOLOv8 with a
    channel-padded stem (``stem_pad_c=8``, as yolov8n and yolov8s have):
    the same as JAX's, the padded input planes zero."""
    monkeypatch.setitem(jregistry._REGISTRY, "tiny_yolov8", dataclasses.replace(
        jregistry.get("tiny_yolov8"), build=lambda: jyolo.YOLOv8(
            dataclasses.replace(jyolo.tiny_yolov8_config(), stem_pad_c=8))))
    monkeypatch.setitem(registry._REGISTRY, "tiny_yolov8", dataclasses.replace(
        registry.get("tiny_yolov8"), build=lambda dtype: pyolo.YOLOv8(
            dataclasses.replace(pyolo.tiny_yolov8_config(), stem_pad_c=8), dtype)))
    _, state = _source("tiny_yolov8", 3)
    state = {f"model.model.{k}": v for k, v in state.items()}
    got = iw.convert("tiny_yolov8", state)
    _assert_same(got, _jax_then_carry("tiny_yolov8", state))
    stem = got["stem.conv.weight"]
    assert tuple(stem.shape[:2]) == (8, 8) and not bool(stem[:, 3:].any())


@pytest.mark.parametrize("name", ["tiny_resnet", "tiny_vit", "tiny_yolov8"])
def test_converted_weights_reproduce_the_source_outputs(name):
    golden, state = _source(name, 4)
    model = registry.get(name).build(torch.float32).eval()
    model.load_state_dict(iw.convert(name, state), strict=True)
    size = registry.get(name).input_size
    x = np.random.default_rng(5).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        want = golden(_nchw(x))
        if name == "tiny_yolov8":
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2), decode=False)
            for (gb, gc), (wb, wc) in zip(got, want):
                np.testing.assert_allclose(gb.numpy(), wb.numpy(), rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(gc.numpy(), wc.numpy(), rtol=RTOL, atol=ATOL)
            return
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_strict_accounting_fails_loudly():
    """JAX's test_strict_accounting_fails_loudly, and a misshapen tensor
    and an unknown model."""
    _, state = _source("tiny_resnet")
    missing = dict(state)
    del missing["layer2.0.bn2.running_var"]
    with pytest.raises(ValueError, match="layer2.0.bn2.running_var"):
        iw.convert("tiny_resnet", missing)
    extra = dict(state)
    extra["layer9.7.conv1.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="unconsumed.*layer9.7.conv1.weight"):
        iw.convert("tiny_resnet", extra)
    bad = dict(state)
    bad["fc.weight"] = bad["fc.weight"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch for classifier.weight"):
        iw.convert("tiny_resnet", bad)
    with pytest.raises(ValueError, match="no import mapping"):
        iw.convert("mobilenet_v2", state)
    assert iw.SUPPORTED == jiw.SUPPORTED


@pytest.mark.parametrize("name", ["yolov8s", "resnet50", "vit_b16"])
def test_full_width_layout_is_complete(name):
    """Every tensor of the full-width model maps to a distinct source key;
    a state dict in the source layout made from the model's own tensors
    converts back to them."""
    model = registry.get(name).init_params(torch.Generator().manual_seed(0), device="cpu",
                                           dtype=torch.float32)
    key_of = iw._FAMILIES[name]
    state, seen = {}, set()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        src = key_of(iw._flax_path(k))
        assert src not in seen, f"two tensors map to {src}"
        seen.add(src)
        if k == "stem.conv.weight" and name == "yolov8s":
            v = v[:, :3]        # the published stem: 3 input planes
        state[src] = v.numpy()
    got = iw.convert(name, state)
    for k, v in model.state_dict().items():
        want = v.float() if v.is_floating_point() else torch.tensor(0)
        if k == "stem.conv.weight" and name == "yolov8s":
            want = torch.cat([v[:, :3], torch.zeros_like(v[:, 3:])], dim=1)
        assert torch.equal(got[k], want), k
