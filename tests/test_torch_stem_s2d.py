"""The space-to-depth stem: the port's fold, fused letterbox, s2d model and
serving step against the JAX package's, on one seed's numpy inputs.

Float32 on both sides, RTOL = ATOL = 2e-4 (the bar of
tests/test_torch_yolov8.py); ``space_to_depth`` and the kernel fold are
exact rearrangements and must be equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.engine.runner import build_serving_step as jbuild_serving_step
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.models.import_weights import s2d_fold_kernel as jfold
from video_edge_ai_proxy_tpu.ops import nms as jnms
from video_edge_ai_proxy_tpu.ops import preprocess as jpre
from video_edge_ai_proxy_tpu.replay.checksum import zero_class_prior as jzero_class_prior
from video_edge_ai_proxy_tpu_torch.engine.runner import build_serving_step
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import fit_state, load_flax, s2d_fold_kernel
from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8, tiny_yolov8_config
from video_edge_ai_proxy_tpu_torch.ops import preprocess as tpre

TOL = 2e-4


def _s2d_cfg(cfg):
    return dataclasses.replace(cfg, stem="s2d")


def _jax_variables(stem: str):
    """flax init of tiny_yolov8 (``stem``) with randomised BatchNorm terms
    and the class prior zeroed (so random weights detect), as numpy."""
    cfg = jyolo.tiny_yolov8_config()
    if stem == "s2d":
        cfg = _s2d_cfg(cfg)
    jmodel = jyolo.YOLOv8(cfg, dtype=jnp.float32)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, jzero_class_prior(v))
    rng = np.random.default_rng(0)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(val, path + (k,)) for k, val in node.items()}
        if path[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if path[-1] == "mean" or (path[-1] == "bias" and "bn" in path):
            return rng.normal(0.0, 0.2, node.shape).astype(np.float32)
        return np.asarray(node, np.float32)
    return jmodel, walk(v, ())


@pytest.fixture(scope="module")
def s2d():
    return _jax_variables("s2d")


@pytest.fixture(scope="module")
def classic():
    return _jax_variables("classic")


@pytest.mark.parametrize("shape", [(1, 2, 2, 3), (2, 8, 6, 3), (3, 4, 10, 12), (1, 64, 96, 1)])
def test_space_to_depth_equal(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(tpre.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpre.space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("shape,dst", [((2, 96, 128, 3), 64), ((2, 64, 64, 3), 64),
                                       ((1, 270, 480, 3), 640), ((2, 100, 60, 3), 96)])
def test_preprocess_letterbox_fused_f32(shape, dst):
    frames = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    jx, jlb = jpre.preprocess_letterbox_fused(jnp.asarray(frames), dst, out_dtype=jnp.float32)
    tx, tlb = tpre.preprocess_letterbox_fused(torch.from_numpy(frames), dst,
                                              out_dtype=torch.float32)
    assert tuple(tlb) == tuple(jlb)
    assert tx.dtype == torch.float32 and tx.shape == (shape[0], dst // 2, dst // 2, 12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    # The same linear map as the two-pass path folded afterwards.
    two_pass, _ = tpre.preprocess_letterbox(torch.from_numpy(frames), dst,
                                            out_dtype=torch.float32)
    np.testing.assert_allclose(tx.numpy(), tpre.space_to_depth(two_pass).numpy(),
                               rtol=TOL, atol=TOL)


def test_fused_letterbox_rejects_an_odd_dst():
    with pytest.raises(ValueError, match="even dst"):
        tpre.preprocess_letterbox_fused(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), 63)


@pytest.mark.parametrize("ci,co", [(3, 16), (8, 4), (1, 1)])
def test_s2d_fold_kernel_equal(ci, co):
    k = np.random.default_rng(2).normal(size=(3, 3, ci, co)).astype(np.float32)
    np.testing.assert_array_equal(s2d_fold_kernel(k), jfold(k))
    with pytest.raises(ValueError):
        s2d_fold_kernel(np.zeros((2, 2, ci, co), np.float32))


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


def _serve(model, x):
    with torch.no_grad():
        return [t.numpy() for t in model(torch.from_numpy(x).permute(0, 3, 1, 2),
                                         decode="serving")]


def test_the_fold_is_lossless(classic, x64):
    """A classic model's weights, folded into an s2d model, compute the same
    function: the port's s2d stem equals its classic stem."""
    _, variables = classic
    tclassic = load_flax(YOLOv8(tiny_yolov8_config(), torch.float32), variables).eval()
    ts2d = YOLOv8(_s2d_cfg(tiny_yolov8_config()), torch.float32).eval()
    ts2d.load_state_dict(fit_state(tclassic.state_dict(), ts2d), strict=True)
    assert tuple(ts2d.stem.conv.weight.shape) == (8, 12, 2, 2)
    with torch.no_grad():
        x = torch.from_numpy(x64).permute(0, 3, 1, 2)
        want = tclassic.stem(x)
        got = ts2d.stem(tpre.space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    (gb, gl, gc), (wb, wl, wc) = _serve(ts2d, x64), _serve(tclassic, x64)
    np.testing.assert_allclose(gb, wb, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gl, wl, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gc, wc)


def test_from_flax_carries_an_s2d_tree(s2d, x64):
    jmodel, variables = s2d
    tmodel = load_flax(YOLOv8(_s2d_cfg(tiny_yolov8_config()), torch.float32), variables).eval()
    want = jmodel.apply(variables, jnp.asarray(x64), decode="serving")
    for got, w in zip(_serve(tmodel, x64), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL)
    # The folded plane straight in gives the same.
    folded = tpre.space_to_depth(torch.from_numpy(x64)).permute(0, 3, 1, 2)
    with torch.no_grad():
        boxes = tmodel(folded, decode="serving")[0]
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)


def test_from_flax_carries_a_classic_tree_into_an_s2d_model(classic, x64):
    jmodel, variables = classic
    tmodel = load_flax(YOLOv8(_s2d_cfg(tiny_yolov8_config()), torch.float32), variables).eval()
    want = jmodel.apply(variables, jnp.asarray(x64), decode="serving")
    got = _serve(tmodel, x64)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_registry_has_the_s2d_models():
    for name, size in (("yolov8n_s2d", 640), ("tiny_yolov8_s2d", 64)):
        spec, jspec = registry.get(name), jregistry.get(name)
        assert (spec.input_size, spec.preprocess, spec.kind) == (
            jspec.input_size, jspec.preprocess, jspec.kind) == (size, "letterbox", "detect")
    model = registry.get("tiny_yolov8_s2d").init_params(device="cpu", dtype=torch.float32)
    assert model.cfg.stem == "s2d" and tuple(model.stem.conv.weight.shape) == (8, 12, 2, 2)


@pytest.mark.parametrize("bucket", [1, 2])
def test_s2d_serving_step_equals_jax(s2d, bucket):
    jmodel, variables = s2d
    frames = np.random.default_rng(4).integers(0, 256, (bucket, 96, 128, 3), dtype=np.uint8)

    @jax.jit
    def jstep(v, f):
        x, lb = jpre.preprocess_letterbox_fused(f, 64, out_dtype=jnp.float32)
        boxes, max_logit, cls_ids = jmodel.apply(v, x, decode="serving")
        b, s, c, valid = jnms.batched_nms(boxes, jax.nn.sigmoid(max_logit), cls_ids,
                                          use_pallas=False)
        return {"boxes": jpre.unletterbox_boxes(b, lb), "scores": s, "classes": c,
                "valid": valid}

    want = {k: np.asarray(v) for k, v in jstep(variables, jnp.asarray(frames)).items()}
    tmodel = load_flax(YOLOv8(_s2d_cfg(tiny_yolov8_config()), torch.float32), variables).eval()
    step = build_serving_step(tmodel, registry.get("tiny_yolov8_s2d"),
                              preprocess_dtype=torch.float32)
    got = {k: v.numpy() for k, v in step(torch.from_numpy(frames)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    # The JAX engine's own step (bf16 preprocess) dispatches the fused path.
    jfull = jbuild_serving_step(jmodel, jregistry.get("tiny_yolov8_s2d"))
    assert set(jax.jit(jfull)(variables, jnp.asarray(frames))) == set(got)
