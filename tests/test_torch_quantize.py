"""int8 serving: the port's quantization, calibration and int8 conv against
the JAX package's ``models/quantize.py`` and ``_Int8Conv``, on one seed's
numpy inputs, and its int8 serving steps against JAX's.

Bit for bit: ``quantize_tree``'s int8 leaves and scales, ``dequantize_tree``,
``quantized_nbytes`` and ``tree_nbytes`` (the port's ``serving_state``
leaves out BatchNorm's step counters, which JAX has no leaf for), and the
int8 conv's int32 and dequantized outputs on the same input (int32 sums
are exact in any order; both round half to even). Calibrated input ranges
to 2e-4 (an f32 forward in another summation order feeds the max).
The weight-only int8 step to 2e-4 in float32 (the dequantized weights are
equal, so the step is the fp step's numerics). The int8 activation step:
the same shapes and dtypes, and its detections against JAX's as ground
truth at mAP50 >= 0.9 (an f32 conv before a quantizer may flip one
rounding, which moves a few boxes a little).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.models import common as jcommon
from video_edge_ai_proxy_tpu.models import metrics as jmetrics
from video_edge_ai_proxy_tpu.models import quantize as jq
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.ops import nms as jnms
from video_edge_ai_proxy_tpu.ops import preprocess as jpre
from video_edge_ai_proxy_tpu.replay.checksum import zero_class_prior as jzero_class_prior
from video_edge_ai_proxy_tpu_torch.engine.runner import build_serving_step
from video_edge_ai_proxy_tpu_torch.models import quantize as tq
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax, load_flax
from video_edge_ai_proxy_tpu_torch.models.common import Int8Conv2d, int8_conv2d
from video_edge_ai_proxy_tpu_torch.models.metrics import DetectionEvaluator
from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8, tiny_yolov8_config

TOL = 2e-4
INT8_ACT_MAP50 = 0.9


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(act_int8: bool):
    """flax init of tiny_yolov8 (``act_int8``) with randomised BatchNorm
    terms and the class prior zeroed, as numpy."""
    cfg = dataclasses.replace(jyolo.tiny_yolov8_config(), act_int8=act_int8)
    jmodel = jyolo.YOLOv8(cfg, dtype=jnp.float32)
    v = _np(jzero_class_prior(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3)))))
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


def _port(variables, act_int8: bool):
    cfg = dataclasses.replace(tiny_yolov8_config(), act_int8=act_int8)
    return load_flax(YOLOv8(cfg, torch.float32), variables).eval()


@pytest.fixture(scope="module")
def fp():
    return _variables(False)


def _calibration_frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (2, 64, 64, 3), np.uint8) for _ in range(2)]


@pytest.fixture(scope="module")
def calibrated():
    """(JAX model, JAX calibrated variables, port model calibrated alike)."""
    jmodel, variables = _variables(True)
    frames = _calibration_frames()
    jv = _np(jq.calibrate_serving(jmodel, jregistry.get("tiny_yolov8"), variables, frames))
    tmodel = _port(variables, True)
    tq.calibrate_serving(tmodel, registry.get("tiny_yolov8"),
                         [torch.from_numpy(f) for f in frames])
    return jmodel, jv, tmodel


@pytest.mark.parametrize("act_int8", [False, True])
def test_quantize_tree_equal_jax(fp, calibrated, act_int8):
    variables = calibrated[1] if act_int8 else fp[1]
    state = tq.serving_state(_port(variables, act_int8))
    jqt, tqt = jq.quantize_tree(variables), tq.quantize_tree(state)
    assert tq.quantized_nbytes(tqt) == jq.quantized_nbytes(jqt)
    assert tq.tree_nbytes(state) == jq.tree_nbytes(variables)
    want_q = {k: v for k, v in from_flax(_np(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jqt.q))).items()
        if not k.endswith("num_batches_tracked")}
    assert set(tqt.q) == set(want_q) == set(state)
    quantized = 0
    for name, q in tqt.q.items():
        np.testing.assert_array_equal(q.float().numpy(), want_q[name].numpy(), err_msg=name)
        if name in tqt.dtype:
            quantized += 1
            assert q.dtype == torch.int8
    assert quantized == len(tqt.dtype) > 0
    # The scales: JAX's, leaf by leaf (a conv's out axis is JAX's last).
    jscale = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(s)
              for path, s in jax.tree_util.tree_flatten_with_path(jqt.scale)[0]}
    w = "params/c2f_2/m0/cv1/conv/kernel"
    np.testing.assert_array_equal(tqt.scale["c2f_2.m0.cv1.conv.weight"].numpy(), jscale[w])
    # dequantize_tree: JAX's values.
    want_deq = from_flax(_np(jq.dequantize_tree(jqt)))
    deq = tq.dequantize_tree(tqt)
    assert set(deq) == set(state)
    for name, t in deq.items():
        np.testing.assert_array_equal(t.float().numpy(), want_deq[name].numpy(), err_msg=name)


def test_calibration_gives_jax_ranges(calibrated):
    _, jv, tmodel = calibrated
    want = from_flax({"quant": jv["quant"]})
    got = {k: v for k, v in tmodel.state_dict().items() if k.endswith(".in_absmax")}
    assert set(got) == set(want) and len(got) > 40
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL, atol=TOL, err_msg=k)
    assert min(float(v) for v in got.values()) > 0.0
    assert not any(m.calibrating for m in tmodel.modules() if isinstance(m, Int8Conv2d))


def test_calibration_refuses_other_families_and_no_frames():
    model = YOLOv8(dataclasses.replace(tiny_yolov8_config(), act_int8=True), torch.float32)
    with pytest.raises(ValueError, match="detect-family"):
        tq.calibrate_serving(model, registry.get("tiny_vit"), [])
    with pytest.raises(ValueError, match="at least one"):
        tq.calibrate_serving(model, registry.get("tiny_yolov8"), [])


@pytest.mark.parametrize("ci,co,k,stride,hw", [(16, 24, 3, 2, 9), (8, 16, 3, 1, 7),
                                               (12, 8, 1, 1, 5), (5, 7, 3, 2, 6)])
def test_int8_conv_equal_jax(ci, co, k, stride, hw):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, hw, hw, ci)).astype(np.float32)
    kernel = (rng.normal(size=(k, k, ci, co)) * 0.1).astype(np.float32)
    absmax = np.float32(np.abs(x).max() * 0.8)        # some inputs clip
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    jmod = jcommon._Int8Conv(co, kernel=k, stride=stride, pad=pad, dtype=jnp.float32)
    want = np.asarray(jmod.apply({"params": {"kernel": kernel}, "quant": {"in_absmax": absmax}},
                                 jnp.asarray(x)))
    # JAX's int32 product, as _Int8Conv computes it.
    s_in = jnp.maximum(absmax, 1e-8) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(jnp.asarray(x) / s_in), -127, 127).astype(jnp.int8)
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12) * (1.0 / 127.0)
    wq = jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)
    want_i32 = np.asarray(jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))

    conv = Int8Conv2d(ci, co, k, stride, pad, torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        conv.in_absmax.fill_(float(absmax))
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = conv(tx).permute(0, 2, 3, 1).numpy()
        txq, twq, _, _ = conv.quantized(tx)
        got_i32 = int8_conv2d(txq, twq, stride, pad)
    np.testing.assert_array_equal(txq.permute(0, 2, 3, 1).numpy(), np.asarray(xq))
    np.testing.assert_array_equal(twq.permute(2, 3, 1, 0).numpy(), np.asarray(wq))
    assert got_i32.dtype == torch.int32
    np.testing.assert_array_equal(got_i32.permute(0, 2, 3, 1).numpy(), want_i32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n", [(4, 9, 5), (17, 16, 8), (40, 144, 24)])
def test_int_mm_padding_is_exact(m, k, n):
    """The card's padded ``torch._int_mm`` route, run here through the CPU
    ``_int_mm``: zero rows and columns added to meet its shape rules change
    no sum."""
    from video_edge_ai_proxy_tpu_torch.models.common import _int_mm_padded

    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    got = _int_mm_padded(a, b)
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ b.numpy().T)


def test_int8_convs_serve_the_stored_kernels(calibrated):
    """Under ``QuantizedModel`` an ``Int8Conv2d`` takes the stored int8
    kernel and scale, skipping dequantize-then-requantize: the kernel is
    the one requantizing would give bit for bit, the scale within one
    float32 rounding of the requantized one, and the step's output within
    TOL of the requantizing forward's."""
    _, _, tmodel = calibrated
    qmodel = tq.quantize_model(copy.deepcopy(tmodel))
    assert qmodel.int8_kernels and all(n in qmodel.qt.dtype for n in qmodel.int8_kernels)
    served = {}

    def grab(mod, args, name):
        served[name] = mod.quantized(args[0])

    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: grab(mod, args, name))
             for name, m in qmodel.model.named_modules() if isinstance(m, Int8Conv2d)]
    frames = torch.from_numpy(_calibration_frames()[0])
    step = build_serving_step(qmodel, registry.get("tiny_yolov8"), preprocess_dtype=torch.float32)
    got = step(frames)
    for h in hooks:
        h.remove()
    requantizing = copy.deepcopy(tmodel)
    requantizing.load_state_dict(tq.dequantize_tree(qmodel.qt), strict=False)
    for name in qmodel.int8_kernels:
        conv = name.rpartition(".")[0]
        _, wq, _, s_w = served[conv]
        with torch.no_grad():
            _, want_wq, _, want_s_w = requantizing.get_submodule(conv).quantized(torch.zeros(1))
        assert wq.dtype == torch.int8 and torch.equal(wq, qmodel.qt.q[name])
        assert torch.equal(wq, want_wq), name
        np.testing.assert_allclose(s_w.numpy(), want_s_w.numpy(), rtol=2 ** -23, atol=0)
    want = build_serving_step(requantizing, registry.get("tiny_yolov8"),
                              preprocess_dtype=torch.float32)(frames)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"].numpy())
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"].numpy())
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


def _jax_step(jmodel):
    @jax.jit
    def step(v, frames):
        x, lb = jpre.preprocess_letterbox(frames, 64, out_dtype=jnp.float32)
        boxes, max_logit, cls_ids = jmodel.apply(jq.dequantize_tree(v), x, decode="serving")
        b, s, c, valid = jnms.batched_nms(boxes, jax.nn.sigmoid(max_logit), cls_ids,
                                          use_pallas=False)
        return {"boxes": jpre.unletterbox_boxes(b, lb), "scores": s, "classes": c,
                "valid": valid}
    return step


def _map50(got, want) -> float:
    ev = DetectionEvaluator()
    for i in range(want["valid"].shape[0]):
        g, w = got["valid"][i], want["valid"][i]
        ev.add_image(got["boxes"][i][g], got["scores"][i][g], got["classes"][i][g],
                     want["boxes"][i][w], want["classes"][i][w])
    return ev.summarize()["mAP50"]


@pytest.mark.parametrize("bucket", [1, 2, 4])
@pytest.mark.parametrize("mode", ["int8", "int8_act"])
def test_int8_serving_steps_agree_with_jax(fp, calibrated, mode, bucket):
    if mode == "int8":
        jmodel, variables = fp
        tmodel = _port(variables, False)
    else:
        jmodel, variables, tmodel = calibrated
    frames = np.random.default_rng(7).integers(0, 256, (bucket, 64, 64, 3), dtype=np.uint8)
    want = {k: np.asarray(v) for k, v in
            _jax_step(jmodel)(jq.quantize_tree(variables), jnp.asarray(frames)).items()}
    qmodel = tq.quantize_model(copy.deepcopy(tmodel))
    # The model's own copies of the quantized leaves are released.
    assert all(p.numel() == 0 for n, p in qmodel.model.named_parameters() if n in qmodel.qt.dtype)
    step = build_serving_step(qmodel, registry.get("tiny_yolov8"), preprocess_dtype=torch.float32)
    got = {k: v.numpy() for k, v in step(torch.from_numpy(frames)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert want["valid"].sum() > 0
    if mode == "int8":
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    else:
        assert _map50(got, want) >= INT8_ACT_MAP50


def test_detection_evaluator_equals_jax():
    """The accuracy gates' mAP evaluator: the same summary as JAX's on
    random detections against random ground truth (overlapping boxes,
    three classes, empty images)."""
    rng = np.random.default_rng(8)
    ours, theirs = DetectionEvaluator(), jmetrics.DetectionEvaluator()
    for n_pred, n_gt in ((30, 20), (0, 5), (12, 0), (50, 50)):
        gt = rng.uniform(0, 200, (n_gt, 2))
        gt = np.concatenate([gt, gt + rng.uniform(5, 60, (n_gt, 2))], 1)
        pred = gt[rng.integers(0, max(n_gt, 1), n_pred)] if n_gt else np.zeros((n_pred, 4))
        pred = pred + rng.normal(0, 6, (n_pred, 4))
        args = (pred, rng.uniform(0, 1, n_pred), rng.integers(0, 3, n_pred), gt,
                rng.integers(0, 3, n_gt))
        ours.add_image(*args)
        theirs.add_image(*args)
    got, want = ours.summarize(), theirs.summarize()
    assert got == want and 0.0 < got["mAP50"] < 1.0
