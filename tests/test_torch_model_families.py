"""The other model families of the port against the JAX package's:
``resnet50`` (re-ID embeddings), ``mobilenet_v2``, ``yolov8s`` and the
tiny twins ``tiny_resnet`` and ``tiny_mobilenet_v2``.

The same weights go to both sides: a flax tree of the JAX module, made
from a numpy seed (lecun-scaled kernels, BatchNorm statistics and affine
terms drawn at random, so a swapped mapping shows), carried to the port by
``models/carry.py``. Float32 on both sides to RTOL = ATOL = 2e-4 (the bar of
``tests/test_import_weights.py`` for torch against flax):

- the models at full width on one 224^2 frame (logits, and the pooled
  embedding of ``features_only`` for the ResNets), the twins on two 32^2
  frames; ``yolov8s`` at 640 on one frame (decoded boxes and scores, and
  ``batched_nms``'s output);
- the serving step of each new registry entry against the JAX
  ``build_serving_step`` on the same uint8 frames (``tiny_resnet``'s
  embeddings and quality statistics too);
- ``from_flax``/``load_flax`` on the two new trees: every key mapped, a
  missing or an extra key raises;
- the registry entries' geometry, preprocess and kind equal JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.models import mobilenet_v2 as jmnv2
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import resnet as jresnet
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.ops import nms as jnms
from video_edge_ai_proxy_tpu_torch.engine.runner import build_serving_step
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax, load_flax
from video_edge_ai_proxy_tpu_torch.ops.nms import batched_nms

RTOL = ATOL = 2e-4
THUMB = 8
NEW_MODELS = ("mobilenet_v2", "yolov8s", "resnet50", "tiny_mobilenet_v2", "tiny_resnet")


def flax_variables(jmodel, shape, seed: int) -> dict:
    """A numpy flax tree of ``jmodel`` for inputs of ``shape``, without
    running flax's init: kernels normal with variance 1/fan_in, BatchNorm
    scale and variance uniform in [0.5, 1.5], biases and means normal(0,
    0.2)."""
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = math.prod(leaf.shape[:-1])
            return rng.normal(0.0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def jax_model(name: str):
    """The JAX registry's module of ``name``, built in float32."""
    return {
        "resnet50": lambda: jresnet.ResNet(jresnet.ResNetConfig(), dtype=jnp.float32),
        "tiny_resnet": lambda: jresnet.ResNet(jresnet.tiny_resnet_config(), dtype=jnp.float32),
        "mobilenet_v2": lambda: jmnv2.MobileNetV2(jmnv2.MobileNetV2Config(), dtype=jnp.float32),
        "tiny_mobilenet_v2": lambda: jmnv2.MobileNetV2(jmnv2.tiny_mobilenet_v2_config(),
                                                       dtype=jnp.float32),
        "yolov8s": lambda: jyolo.YOLOv8(jyolo.yolov8s_config(), dtype=jnp.float32),
    }[name]()


_CACHE: dict = {}


def pair(name: str):
    """(JAX module, flax variables, the port's float32 model with them),
    built once a module run; each model's weights from a seed of its own,
    whatever ran before."""
    if name not in _CACHE:
        spec = registry.get(name)
        jm = jax_model(name)
        variables = flax_variables(jm, (1, spec.input_size, spec.input_size, 3),
                                   seed=NEW_MODELS.index(name))
        pm = load_flax(spec.build(torch.float32), variables).eval()
        _CACHE[name] = (jm, variables, pm)
    return _CACHE[name]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


# -- the registry -----------------------------------------------------------------


@pytest.mark.parametrize("name", NEW_MODELS)
def test_registry_entry_equals_jax(name):
    mine, theirs = registry.get(name), jregistry.get(name)
    assert (mine.input_size, mine.preprocess, mine.kind, mine.clip_len) == \
        (theirs.input_size, theirs.preprocess, theirs.kind, theirs.clip_len)
    model = mine.init_params(torch.Generator().manual_seed(0), device="cpu",
                             dtype=torch.float32)
    assert model.training is False


def test_resnet50_is_torchvisions_size():
    """ResNet-50 and MobileNetV2 have torchvision's parameter counts (BN
    statistics apart), and the pooled feature is 2048 wide."""
    counts = {n: sum(p.numel() for p in registry.get(n).build(torch.float32).parameters())
              for n in ("resnet50", "mobilenet_v2")}
    assert counts == {"resnet50": 25557032, "mobilenet_v2": 3504872}
    assert registry.get("resnet50").build(torch.float32).features == 2048


# -- the models ---------------------------------------------------------------------


@pytest.mark.parametrize("name,batch", [("resnet50", 1), ("mobilenet_v2", 1),
                                        ("tiny_resnet", 2), ("tiny_mobilenet_v2", 2)])
def test_convnet_logits_equal_jax(name, batch):
    jm, variables, pm = pair(name)
    size = registry.get(name).input_size
    x = np.random.default_rng(7).normal(0.0, 1.0, (batch, size, size, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 1000 if size == 224
                                                                 else 10)
    _close(got, want, f"{name} logits")
    if "resnet" in name:
        want_f = jax.jit(lambda v, a: jm.apply(v, a, features_only=True))(variables,
                                                                           jnp.asarray(x))
        with torch.no_grad():
            got_f = pm(torch.from_numpy(x), features_only=True)
        assert tuple(got_f.shape) == (batch, pm.features)
        _close(got_f, want_f, f"{name} features")


def test_yolov8s_decode_and_nms_equal_jax():
    jm, variables, pm = pair("yolov8s")
    x = np.random.default_rng(8).uniform(0.0, 1.0, (1, 640, 640, 3)).astype(np.float32)
    jboxes, jscores = jax.jit(lambda v, a: jm.apply(v, a, decode=True))(variables,
                                                                          jnp.asarray(x))
    with torch.no_grad():
        boxes, scores = pm(torch.from_numpy(x).permute(0, 3, 1, 2), decode=True)
    assert tuple(boxes.shape) == (1, 8400, 4) and tuple(scores.shape) == (1, 8400, 80)
    _close(boxes, jboxes, "yolov8s boxes")
    _close(scores, jscores, "yolov8s scores")
    # batched_nms on the JAX model's decode, on both sides: the same keep set.
    smax = np.asarray(jscores).max(-1)
    cls = np.asarray(jscores).argmax(-1).astype(np.int32)
    want = jnms.batched_nms(jboxes, jnp.asarray(smax), jnp.asarray(cls), use_pallas=False)
    got = batched_nms(torch.from_numpy(np.array(jboxes)), torch.from_numpy(smax),
                      torch.from_numpy(cls))
    for g, w, what in zip(got, want, ("boxes", "scores", "classes", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"nms {what}")
    assert int(got[3].sum()) > 0


# -- the carry ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny_resnet", "tiny_mobilenet_v2"])
def test_from_flax_maps_the_new_trees_strictly(name):
    _, variables, pm = pair(name)
    sd = from_flax(variables)
    assert set(sd) == set(pm.state_dict())
    if name == "tiny_mobilenet_v2":
        kernel = variables["params"]["stage1_block0"]["depthwise"]["conv"]["kernel"]
        np.testing.assert_array_equal(sd["stage1_block0.depthwise.conv.weight"].numpy(),
                                      kernel.transpose(3, 2, 0, 1))
        assert tuple(kernel.shape[2:]) == (1, 96)     # depthwise: one input plane a group
    else:
        np.testing.assert_array_equal(
            sd["stage1_block0.downsample.bn.running_var"].numpy(),
            variables["batch_stats"]["stage1_block0"]["downsample"]["bn"]["var"])
    fresh = registry.get(name).build(torch.float32)
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["batch_stats"]["stem"]["bn"]["var"]
    with pytest.raises(RuntimeError, match="stem.bn.running_var"):
        load_flax(fresh, missing)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["stage9_block9"] = {"conv": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}}
    with pytest.raises(RuntimeError, match="stage9_block9"):
        load_flax(fresh, extra)


# -- the serving steps ------------------------------------------------------------------


@pytest.mark.parametrize("name,thumb", [("tiny_resnet", THUMB), ("tiny_mobilenet_v2", THUMB),
                                        ("resnet50", 0), ("mobilenet_v2", 0),
                                        ("yolov8s", 0)])
def test_serving_step_equals_jax(name, thumb):
    """The registry entry's step (bf16 preprocessing, as JAX's; the model
    in float32) against the JAX ``build_serving_step`` on the same frames
    and weights; with quality thumbnails for the twins. The detector gets
    one full 640^2 frame: a letterbox's flat padding gives anchors of equal
    scores, whose order two float32 programs may break either way."""
    jm, variables, pm = pair(name)
    spec, jspec = registry.get(name), jregistry.get(name)
    shape = (1, 640, 640, 3) if spec.kind == "detect" else (2, 96, 128, 3)
    frames = np.random.default_rng(9).integers(0, 256, shape, dtype=np.uint8)
    prev = np.random.default_rng(10).uniform(0, 1, (shape[0], thumb, thumb)).astype(np.float32)
    jstep = jax.jit(jrunner.build_serving_step(jm, jspec, quality_thumb=thumb))
    want = {k: np.asarray(v) for k, v in
            (jstep(variables, frames, prev) if thumb else jstep(variables, frames)).items()}
    step = build_serving_step(pm, spec, quality_thumb=thumb)
    args = (torch.from_numpy(frames),) + ((torch.from_numpy(prev),) if thumb else ())
    got = {k: v.numpy() for k, v in step(*args).items()}
    assert set(got) == set(want)
    if spec.kind == "embed":
        assert got["embedding"].shape == (shape[0], pm.features)
        assert got["embedding"].dtype == np.float32
    if spec.kind == "detect":
        assert got["valid"].sum() > 0
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
    if spec.kind == "classify":
        np.testing.assert_array_equal(got["top_ids"], want["top_ids"])
    for k in got:
        if got[k].dtype.kind == "f":
            _close(got[k], want[k], f"{name} {k}")
