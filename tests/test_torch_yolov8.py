"""The port's YOLOv8 against the JAX package's, with the same weights
carried across by ``models/carry.py``.

``tiny_yolov8`` in float32 on both sides, all three decode modes, to
RTOL = ATOL = 2e-4 (the bar of tests/test_import_weights.py for torch
against flax). Weights are flax's init with every BatchNorm statistic and
affine term randomised from a numpy seed, so a swapped mapping shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.replay.checksum import zero_class_prior as jzero_class_prior
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax, load_flax, zero_class_prior
from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8, tiny_yolov8_config, yolov8n_config

TOL = 2e-4


def _randomize(tree, rng):
    """flax variables -> numpy tree with randomised BN terms and head
    biases (kernels keep flax's init)."""
    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        if leaf in ("bias", "mean"):
            return rng.normal(0.0, 0.2, arr.shape).astype(np.float32)
        return arr
    return walk(tree, ())


@pytest.fixture(scope="module")
def tiny():
    jmodel = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = _randomize(variables, np.random.default_rng(0))
    tmodel = load_flax(YOLOv8(tiny_yolov8_config(), torch.float32), variables).eval()
    return jmodel, variables, tmodel


def test_from_flax_maps_every_key(tiny):
    _, variables, tmodel = tiny
    sd = from_flax(variables)
    assert set(sd) == set(tmodel.state_dict())
    kernel = variables["params"]["c2f_2"]["m0"]["cv1"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["c2f_2.m0.cv1.conv.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["detect.box0_cv1.bn.running_var"].numpy(),
                                  variables["batch_stats"]["detect"]["box0_cv1"]["bn"]["var"])
    np.testing.assert_array_equal(sd["detect.cls2_out.bias"].numpy(),
                                  variables["params"]["detect"]["cls2_out"]["bias"])


def test_from_flax_missing_key_raises(tiny):
    _, variables, _ = tiny
    params = dict(variables["params"])
    del params["sppf"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax(YOLOv8(tiny_yolov8_config(), torch.float32),
                  {"params": params, "batch_stats": variables["batch_stats"]})


def test_from_flax_extra_key_raises(tiny):
    _, variables, _ = tiny
    params = dict(variables["params"])
    params["extra"] = {"conv": {"kernel": np.zeros((1, 1, 4, 4), np.float32)}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax(YOLOv8(tiny_yolov8_config(), torch.float32),
                  {"params": params, "batch_stats": variables["batch_stats"]})


@pytest.mark.parametrize("bad", [
    {"intermediates": {}},
    {"quant": {"stem": {"conv": {"weird": np.zeros((), np.float32)}}}},
    {"params": {"stem": {"conv": {"weird": np.zeros(1, np.float32)}}}},
    {"batch_stats": {"stem": {"bn": {"count": np.zeros(1, np.float32)}}}},
])
def test_from_flax_unknown_leaf_raises(bad):
    with pytest.raises(KeyError):
        from_flax(bad)


def test_zero_class_prior_matches_jax(tiny):
    _, variables, _ = tiny
    want = from_flax(jax.tree_util.tree_map(np.asarray, jzero_class_prior(variables)))
    got = zero_class_prior(from_flax(variables))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert float(got["detect.cls0_out.bias"].abs().sum()) == 0.0


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_decode_false_matches(tiny, x64):
    jmodel, variables, tmodel = tiny
    jout = jmodel.apply(variables, jnp.asarray(x64), decode=False)
    with torch.no_grad():
        tout = tmodel(_nchw(x64), decode=False)
    for (jb, jc), (tb, tc) in zip(jout, tout):
        np.testing.assert_allclose(tb.permute(0, 2, 3, 1).numpy(), np.asarray(jb), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc.permute(0, 2, 3, 1).numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


def test_decode_true_matches(tiny, x64):
    jmodel, variables, tmodel = tiny
    jb, js = jmodel.apply(variables, jnp.asarray(x64), decode=True)
    with torch.no_grad():
        tb, ts = tmodel(_nchw(x64), decode=True)
    assert tb.shape == (2, 84, 4) and ts.shape == (2, 84, 4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)


def test_decode_serving_matches(tiny, x64):
    jmodel, variables, tmodel = tiny
    jb, jm, ji = jmodel.apply(variables, jnp.asarray(x64), decode="serving")
    with torch.no_grad():
        tb, tm, ti = tmodel(_nchw(x64), decode="serving")
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_yolov8n_layout_matches_flax():
    """Full-width yolov8n: every flax leaf (shapes from tracing init, no
    forward at 640 is run) maps onto a port parameter of the same shape,
    and the parameter counts agree."""
    jmodel = jyolo.YOLOv8(jyolo.yolov8n_config())
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 640, 640, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tmodel = YOLOv8(yolov8n_config(), torch.float32)
    load_flax(tmodel, zeros)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_flax == sum(p.numel() for p in tmodel.parameters())
    assert tmodel.stem.conv.weight.shape[1] == 8          # stem_pad_c kept


def test_registry_init_params_is_seeded():
    spec = registry.get("tiny_yolov8")
    a = spec.init_params(torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32)
    b = spec.init_params(torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    prior = float(a.state_dict()["detect.cls0_out.bias"][0])
    assert prior == pytest.approx(np.log(5 / 4 / (640 / 8) ** 2), rel=1e-6)
    assert not a.training and a.stem.conv.weight.dtype == torch.float32
