"""The self-training loop's modules in the port against the JAX package's,
on the CPU (``tiny_yolov8`` in float32, 64-128 px, inputs from numpy seeds,
RTOL = ATOL = 2e-4 unless stated):

- ``models/detect_loss.py``: the loss and its gradients against
  ``jax.grad`` on one batch with padded targets and an image with no valid
  box, on frozen BatchNorm statistics and on batch statistics (with the
  running statistics it writes); the assigner's ``fg`` and ``gt_idx``
  exactly, ties included; CIoU with its gradient; the DFL term alone;
  ``flatten_levels``' anchor order.
- ``parallel/train.py`` ``make_trainer(mutable_aux=True)``, ``clip_norm``
  10: three steps of both trainers, losses, parameters and the carried
  ``batch_stats``; and the loss-swing check (ROADMAP Queue 3): at lr 1e-3
  JAX's own losses on one batch swing with a 1e-6 change of the images.
- ``ops/augment.py``: each apply half on the parameters JAX's own keys
  draw (JAX's split sequence reproduced here), boxes, masks and labels
  exact.
- ``data/segments.py``: ``SegmentDataset``/``Loader(with_meta=True)`` over
  an archive the port's archiver wrote, ``.npz`` and mp4: batches bit for
  bit and metas equal.
- ``utils/checkpoint.py``: msgpack both ways (bytes equal to flax's for
  the same tree, metadata included), ``set_msgpack_meta`` across the two,
  and the refusals.
- ``models/import_weights.py`` ``load_state_dict`` (.npz, .safetensors
  written by the ``safetensors`` package, .pt with its wrappers) and the
  importer CLIs' msgpacks, byte for byte; ``carry.to_flax`` as the inverse
  of ``from_flax`` for every family; ``fit_state`` as JAX's
  ``pad_stem_on_load``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from video_edge_ai_proxy_tpu.data import Loader as JLoader
from video_edge_ai_proxy_tpu.data import SegmentDataset as JSegmentDataset
from video_edge_ai_proxy_tpu.models import detect_loss as jdl
from video_edge_ai_proxy_tpu.models import import_weights as jiw
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.ops import augment as jaug
from video_edge_ai_proxy_tpu.parallel import train as jtrain
from video_edge_ai_proxy_tpu.parallel.mesh import single_device_mesh
from video_edge_ai_proxy_tpu.parallel.sharding import unbox
from video_edge_ai_proxy_tpu.utils import checkpoint as jck
from video_edge_ai_proxy_tpu_torch.data import Loader, SegmentDataset
from video_edge_ai_proxy_tpu_torch.ingest.archive import GopSegment, SegmentArchiver
from video_edge_ai_proxy_tpu_torch.models import carry
from video_edge_ai_proxy_tpu_torch.models import detect_loss as tdl
from video_edge_ai_proxy_tpu_torch.models import import_weights as iw
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8, tiny_yolov8_config
from video_edge_ai_proxy_tpu_torch.ops import augment as taug
from video_edge_ai_proxy_tpu_torch.parallel import make_trainer
from video_edge_ai_proxy_tpu_torch.utils import checkpoint as ck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RTOL = ATOL = 2e-4
G_NOISE = 1e-6
# The trainers' learning rate: at 1e-3 this detector's loss on one batch is
# chaotic within three steps on either side alone (JAX's own losses move
# by 7e-3 at step 2 and 0.18 at step 4 when the images move by 1e-6,
# ROADMAP Queue 3), so the comparison runs at 1e-4, phase 9's rate.
LR = 1e-4


# -- shared inputs --------------------------------------------------------------------------


def _variables(seed: int = 0) -> dict:
    """tiny_yolov8's flax init (float32) with BatchNorm terms drawn from a
    numpy seed, as numpy."""
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, unbox(
        jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))))
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(val, path + (k,)) for k, val in node.items()}
        if path[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if path[-1] == "mean" or (path[-1] == "bias" and "bn" in path):
            return rng.normal(0.0, 0.2, node.shape).astype(np.float32)
        return np.asarray(node, np.float32)
    return walk(v, ())


def _batch(n: int, size: int, seed: int = 1, max_boxes: int = 5):
    """(images NHWC float32 in [0, 1], targets as numpy): boxes on every
    image but the last, which has none; padded slots zero."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    mask = np.zeros((n, max_boxes), bool)
    for i in range(n - 1):
        for j in range(3):
            x1, y1 = rng.uniform(0, size * 0.6, 2)
            w, h = rng.uniform(size / 8, size / 3, 2)
            boxes[i, j] = [x1, y1, x1 + w, y1 + h]
            labels[i, j] = rng.integers(0, 4)
            mask[i, j] = True
    return x, {"boxes": boxes, "labels": labels, "mask": mask}


def _jt(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _tt(t):
    return {k: torch.from_numpy(v) for k, v in t.items()}


def _port_model(variables) -> torch.nn.Module:
    model = YOLOv8(tiny_yolov8_config(), torch.float32)
    return carry.load_flax(model, variables)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# -- the detection loss -----------------------------------------------------------------


@pytest.mark.parametrize("update_stats,n,size", [(False, 3, 64), (True, 4, 128)],
                         ids=["frozen_stats", "batch_stats"])
def test_detection_loss_and_gradients_match_jax(update_stats, n, size):
    """Batch statistics run at 4 x 128^2: at 3 x 64^2 the deepest level's
    statistics come from 12 values a channel and float32 noise through
    their backward reaches 1e-3 on either side against float64."""
    v = _variables()
    x, t = _batch(n, size)
    jm = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    jfn = jdl.make_detection_loss_fn(jm.cfg, update_stats=update_stats)
    aux = {"batch_stats": v["batch_stats"]}
    out, jgrads = jax.jit(jax.value_and_grad(lambda p: jfn(jm, p, aux, jnp.asarray(x), _jt(t)),
                                             has_aux=update_stats))(v["params"])
    jloss = out[0] if update_stats else out

    tm = _port_model(v)
    tm.train()
    loss = tdl.make_detection_loss_fn(tiny_yolov8_config(), update_stats)(tm, _nchw(x), _tt(t))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL, atol=RTOL)
    want = carry.from_flax({"params": jax.device_get(jgrads)})
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    stats = {k: b for k, b in tm.state_dict().items() if "running" in k}
    want_stats = carry.from_flax({"params": v["params"], "batch_stats": jax.device_get(
        out[1]["batch_stats"] if update_stats else v["batch_stats"])})
    for k, b in stats.items():
        np.testing.assert_allclose(b.numpy(), want_stats[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if update_stats:                      # the statistics moved
        assert not np.allclose(stats["stem.bn.running_mean"].numpy(),
                               v["batch_stats"]["stem"]["bn"]["mean"])


def _assign_inputs(seed: int = 3):
    """Raw logits, predicted boxes and targets for the assigner at 64 px
    (84 anchors); GT 1 of image 0 duplicates GT 0, so their aligns tie."""
    cfg = jyolo.tiny_yolov8_config()
    rng = np.random.default_rng(seed)
    a = sum((64 // s) ** 2 for s in cfg.strides)
    cls = rng.normal(0, 2, (2, a, cfg.num_classes)).astype(np.float32)
    box = rng.normal(0, 1, (2, a, 4 * cfg.reg_max)).astype(np.float32)
    _, t = _batch(3, 64, seed)
    t = {k: v[:2] for k, v in t.items()}
    t["boxes"][0, 1] = t["boxes"][0, 0]
    t["labels"][0, 1] = t["labels"][0, 0]
    anchors, strides = [], []
    for s in cfg.strides:
        anchors.append(np.asarray(jyolo._anchor_points(64 // s, 64 // s, s)))
        strides.append(np.full(((64 // s) ** 2,), s, np.float32))
    return cfg, cls, box, np.concatenate(anchors), np.concatenate(strides), t


def test_assign_matches_jax_exactly():
    cfg, cls, box, anchors, strides, t = _assign_inputs()
    jpred = jdl._decode_dfl(jnp.asarray(box), jnp.asarray(anchors), jnp.asarray(strides),
                            cfg.reg_max)
    tpred = tdl._decode_dfl(torch.from_numpy(box), torch.from_numpy(anchors),
                            torch.from_numpy(strides), cfg.reg_max)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=RTOL, atol=ATOL)
    jfg, jidx, jw = jdl.assign(jnp.asarray(cls), jpred, jnp.asarray(anchors),
                               *(jnp.asarray(t[k]) for k in ("boxes", "labels", "mask")))
    # the same predicted boxes on both sides, so the decisions are exact
    fg, idx, w = tdl.assign(torch.from_numpy(cls), torch.from_numpy(np.asarray(jpred)),
                            torch.from_numpy(anchors),
                            *(torch.from_numpy(t[k]) for k in ("boxes", "labels", "mask")))
    assert int(fg.sum()) > 0 and np.array_equal(fg.numpy(), np.asarray(jfg))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert not np.any(idx[0].numpy() == 1)           # the tie went to the first GT
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)


def test_flatten_levels_keeps_the_jax_anchor_order():
    cfg = tiny_yolov8_config()
    rng = np.random.default_rng(4)
    levels = [(rng.normal(size=(2, 64 // s, 64 // s, 4 * cfg.reg_max)).astype(np.float32),
               rng.normal(size=(2, 64 // s, 64 // s, cfg.num_classes)).astype(np.float32))
              for s in cfg.strides]
    want = jdl.flatten_levels([(jnp.asarray(b), jnp.asarray(c)) for b, c in levels],
                              jyolo.tiny_yolov8_config())
    got = tdl.flatten_levels([(torch.from_numpy(b).permute(0, 3, 1, 2),
                               torch.from_numpy(c).permute(0, 3, 1, 2)) for b, c in levels], cfg)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_ciou_and_its_gradient_match_jax():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 50, (64, 2, 2)).astype(np.float32)
    wh = rng.uniform(1, 30, (64, 2, 2)).astype(np.float32)
    b1 = np.concatenate([xy[:, 0], xy[:, 0] + wh[:, 0]], -1)
    b2 = np.concatenate([xy[:, 1], xy[:, 1] + wh[:, 1]], -1)
    b2[:4] = b1[:4]                                   # identical boxes: CIoU 1
    jv, jg = jax.value_and_grad(lambda a: jdl.ciou(a, jnp.asarray(b2)).sum())(jnp.asarray(b1))
    tb1 = torch.from_numpy(b1).requires_grad_()
    tv = tdl.ciou(tb1, torch.from_numpy(b2))
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(
        jdl.ciou(jnp.asarray(b1), jnp.asarray(b2))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tv.sum().detach()), float(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb1.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


def test_dfl_term_alone_matches_jax(monkeypatch):
    """The loss with the box and class weights at 0 is W_DFL x the DFL term."""
    for mod in (jdl, tdl):
        monkeypatch.setattr(mod, "W_BOX", 0.0)
        monkeypatch.setattr(mod, "W_CLS", 0.0)
    v = _variables()
    x, t = _batch(3, 64)
    jm = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    head = jax.jit(lambda v, x: jm.apply(v, x, train=False, decode=False))(v, jnp.asarray(x))
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda h: jdl.detection_loss(h, _jt(t), jm.cfg)))(head)
    thead = [(torch.from_numpy(np.asarray(b)).permute(0, 3, 1, 2).requires_grad_(),
              torch.from_numpy(np.asarray(c)).permute(0, 3, 1, 2).requires_grad_())
             for b, c in head]
    loss = tdl.detection_loss(thead, _tt(t), tiny_yolov8_config())
    loss.backward()
    assert float(jloss) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL, atol=ATOL)
    for (tb, tc), (gb, gc) in zip(thead, jg):
        np.testing.assert_allclose(tb.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gb),
                                   rtol=RTOL, atol=ATOL)
        assert float(tc.grad.abs().max()) == 0.0 and float(np.abs(gc).max()) == 0.0


# -- the trainer with BatchNorm statistics ------------------------------------------------


def test_mutable_aux_trainer_three_steps_match_jax():
    """Three steps of both ``make_trainer``s (mutable_aux, clip_norm 10) on
    one batch. Losses within 2e-4 at every step; the parameters after the
    first step as ``tests/test_torch_train.py`` holds them (within 2e-4
    where |g| >= 1e-6, 2 lr + 2e-4 elsewhere) and the carried batch_stats
    after it within 2e-4. Neither side swings: the losses fall step by step
    on both."""
    v = _variables()
    x, t = _batch(4, 128)
    jm = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    mesh = single_device_mesh()
    jtr = jtrain.make_trainer(jm, mesh, learning_rate=LR, clip_norm=10.0, mutable_aux=True,
                              loss_fn=jdl.make_detection_loss_fn(jm.cfg, update_stats=True))
    j_losses, j_first = [], None
    with mesh:
        state = jtr.init_state_from(v)
        for _ in range(3):
            state, loss = jtr.train_step(state, jnp.asarray(x), _jt(t))
            j_losses.append(float(loss))
            if j_first is None:
                j_first = carry.from_flax({
                    "params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.aux["batch_stats"])})

    tm = YOLOv8(tiny_yolov8_config(), torch.float32)
    tr = make_trainer(tm, device="cpu", learning_rate=LR, clip_norm=10.0, mutable_aux=True,
                      loss_fn=tdl.make_detection_loss_fn(tiny_yolov8_config(), True))
    tstate = tr.init_state_from(v)                   # a loaded msgpack tree
    t_losses = []
    for step in range(3):
        tstate, loss = tr.train_step(tstate, _nchw(x), _tt(t))
        t_losses.append(float(loss))
        if step == 0:
            grads = {k: p.grad.clone() for k, p in tstate.params.items()}
            params = {k: p.detach().clone() for k, p in tstate.params.items()}
            # The first step's statistics come from equal weights; the later
            # steps' from weights that agree only as the parameters do.
            assert set(tstate.aux) == {k for k in j_first if "running" in k}
            for k, b in tstate.aux.items():
                np.testing.assert_allclose(b.numpy(), j_first[k].numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=k)
    assert tstate.step == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=RTOL, atol=ATOL)
    assert j_losses[0] > j_losses[1] > j_losses[2]
    for k, p in params.items():
        diff = (p - j_first[k]).abs()
        moving = grads[k].abs() >= G_NOISE
        assert float(torch.where(moving, diff, 0.0).max()) <= ATOL, k
        assert float(diff.max()) <= 2 * LR + ATOL, k


def test_jax_swings_alike_at_lr_1e3():
    """The loss-swing check (ROADMAP Queue 3): at lr 1e-3 this detector's
    loss on one batch is chaotic in the JAX package alone. Its step-1 loss
    moves by under 1e-4 when the images move by 1e-6 (relative), its
    step-4 loss by over 1e-2 (0.18 here): float32 noise, of either
    package, is amplified a thousandfold in three updates, so losses that
    swing between steps on a fixed batch do not point at the port."""
    v = _variables()
    x, t = _batch(4, 128)
    jm = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    mesh = single_device_mesh()
    jtr = jtrain.make_trainer(jm, mesh, learning_rate=1e-3, clip_norm=10.0, mutable_aux=True,
                              loss_fn=jdl.make_detection_loss_fn(jm.cfg, update_stats=True))
    noise = np.random.default_rng(9).standard_normal(x.shape)
    runs = []
    with mesh:
        for eps in (0.0, 1e-6):
            state = jtr.init_state_from(v)
            losses = []
            for _ in range(4):
                state, loss = jtr.train_step(
                    state, jnp.asarray((x * (1 + eps * noise)).astype(np.float32)), _jt(t))
                losses.append(float(loss))
            runs.append(losses)
    print("JAX losses at lr 1e-3, images as they are and moved by 1e-6:", runs)
    assert abs(runs[0][0] - runs[1][0]) < 1e-4
    assert abs(runs[0][3] - runs[1][3]) > 1e-2


def _resnet_case():
    """tiny_resnet (float32) with BatchNorm terms from a numpy seed, a batch
    of 4 NHWC images and integer labels."""
    from video_edge_ai_proxy_tpu.models import resnet as jresnet
    from video_edge_ai_proxy_tpu_torch.models.resnet import ResNet, tiny_resnet_config

    jm = jresnet.ResNet(jresnet.tiny_resnet_config(), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, unbox(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                                 jnp.asarray(x[:1]))))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    y = rng.integers(0, 10, 4)
    return (jm, jtrain.cross_entropy_loss, v, jnp.asarray(x), jnp.asarray(y.astype(np.int32)),
            ResNet(tiny_resnet_config(), torch.float32), None, torch.from_numpy(x),
            torch.from_numpy(y))


def _yolo_frozen_case():
    """tiny_yolov8 with the detection loss on frozen statistics, as the
    defaults of both ``make_detection_loss_fn``s give it."""
    v = _variables()
    x, t = _batch(2, 64)
    jm = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    return (jm, jdl.make_detection_loss_fn(jm.cfg), v, jnp.asarray(x), _jt(t),
            YOLOv8(tiny_yolov8_config(), torch.float32),
            tdl.make_detection_loss_fn(tiny_yolov8_config()), _nchw(x), _tt(t))


@pytest.mark.parametrize("case", [_yolo_frozen_case, _resnet_case],
                         ids=["yolov8_detection_loss", "resnet_cross_entropy"])
def test_frozen_stats_trainer_three_steps_match_jax(case):
    """Three steps of both ``make_trainer``s at their defaults (frozen
    BatchNorm statistics, no mutable_aux) on one batch: the frozen forward
    saves the running buffers for its backward, and the step trains through
    it. Losses within 2e-4 at every step, the parameters after the first
    step as ``test_mutable_aux_trainer_three_steps_match_jax`` holds them,
    and the statistics unchanged on both sides."""
    jm, jloss_fn, v, jx, jy, tm, tloss_fn, tx, ty = case()
    mesh = single_device_mesh()
    jtr = jtrain.make_trainer(jm, mesh, learning_rate=LR, loss_fn=jloss_fn)
    j_losses, j_first = [], None
    with mesh:
        state = jtr.init_state_from(v)
        for _ in range(3):
            state, loss = jtr.train_step(state, jx, jy)
            j_losses.append(float(loss))
            if j_first is None:
                j_first = carry.from_flax({"params": jax.device_get(state.params)})
        j_stats = jax.device_get(state.aux["batch_stats"])

    tr = make_trainer(tm, device="cpu", learning_rate=LR, loss_fn=tloss_fn)
    tstate = tr.init_state_from(v)
    before = {k: b.clone() for k, b in tstate.aux.items()}
    t_losses = []
    for step in range(3):
        tstate, loss = tr.train_step(tstate, tx, ty)
        t_losses.append(float(loss))
        if step == 0:
            grads = {k: p.grad.clone() for k, p in tstate.params.items()}
            params = {k: p.detach().clone() for k, p in tstate.params.items()}
    np.testing.assert_allclose(t_losses, j_losses, rtol=RTOL, atol=ATOL)
    assert all(torch.equal(b, before[k]) for k, b in tstate.aux.items())
    want_stats = carry.from_flax({"params": v["params"], "batch_stats": j_stats})
    for k, b in tstate.aux.items():
        assert np.array_equal(b.numpy(), want_stats[k].numpy()), k
    for k, p in params.items():
        diff = (p - j_first[k]).abs()
        moving = grads[k].abs() >= G_NOISE
        assert float(torch.where(moving, diff, 0.0).max()) <= ATOL, k
        assert float(diff.max()) <= 2 * LR + ATOL, k


def test_frozen_aux_restores_the_statistics():
    """Without mutable_aux a loss that writes statistics leaves them as they
    were (JAX's frozen aux), and its step still trains."""
    v = _variables()
    x, t = _batch(2, 64)
    tm = YOLOv8(tiny_yolov8_config(), torch.float32)
    tr = make_trainer(tm, device="cpu", learning_rate=LR, mutable_aux=False,
                      loss_fn=tdl.make_detection_loss_fn(tiny_yolov8_config(), True))
    state = tr.init_state_from(v)
    before = {k: b.clone() for k, b in state.aux.items()}
    w0 = state.params["stem.conv.weight"].detach().clone()
    tr.train_step(state, _nchw(x), _tt(t))
    assert all(torch.equal(b, before[k]) for k, b in state.aux.items())
    assert not torch.equal(state.params["stem.conv.weight"], w0)
    assert all(p.dtype == torch.float32 for p in state.params.values())


def test_bf16_compute_keeps_float32_conv_weights():
    """param_dtype: the ConvBN kernels stay float32 under bf16 compute, so
    AdamW updates float32 master weights (optax's stance); serving models
    keep one dtype."""
    model = registry.get("tiny_yolov8").init_params(device="cpu", param_dtype=torch.float32)
    assert model.stem.conv.weight.dtype == torch.float32
    assert model.stem.conv.compute_dtype == torch.bfloat16
    x, t = _batch(2, 64)
    loss = tdl.make_detection_loss_fn(model.cfg, True)(model, _nchw(x), _tt(t))
    loss.backward()
    assert torch.isfinite(loss) and model.stem.conv.weight.grad.dtype == torch.float32
    serving = registry.get("tiny_yolov8").init_params(device="cpu")
    assert serving.stem.conv.weight.dtype == torch.bfloat16


# -- augmentations ------------------------------------------------------------------------


def _aug_inputs(seed: int = 6):
    rng = np.random.default_rng(seed)
    b, h, w, n = 5, 48, 64, 3
    imgs = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    xy = rng.uniform(0, 40, (b, n, 2)).astype(np.float32)
    wh = rng.integers(2, 24, (b, n, 2)).astype(np.float32)
    boxes = np.round(np.concatenate([xy, xy + wh], -1))
    valid = rng.uniform(size=(b, n)) < 0.7
    labels = rng.integers(0, 3, (b, n)).astype(np.int32)
    return imgs, boxes, valid, labels


def _key_params(name, key, b, h, w):
    """The parameters JAX's transform draws from ``key``, with its split
    sequence, as the port's apply half takes them."""
    if name == "hflip":
        return (torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.5, (b,)))),)
    if name == "jitter":
        out = []
        for k, s in zip(jax.random.split(key, 3), (0.2, 0.2, 0.4)):
            out.append(torch.from_numpy(np.asarray(jax.random.uniform(
                k, (b, 1, 1, 1), minval=1.0 - s, maxval=1.0 + s))))
        return (tuple(out),)
    ky, kx = jax.random.split(key)
    if name == "cutout":
        ch, cw = max(1, int(h * 0.25)), max(1, int(w * 0.25))
        return (torch.from_numpy(np.asarray(jax.random.randint(ky, (b,), 0, h - ch + 1))).long(),
                torch.from_numpy(np.asarray(jax.random.randint(kx, (b,), 0, w - cw + 1))).long())
    return (torch.from_numpy(np.asarray(jax.random.randint(ky, (b,), 0, h + 1))).long(),
            torch.from_numpy(np.asarray(jax.random.randint(kx, (b,), 0, w + 1))).long())


def _close(got, want, exact: bool):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if exact:
        assert np.array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["hflip", "jitter", "cutout", "mosaic", "recipe"])
def test_augment_apply_halves_match_jax(name):
    imgs, boxes, valid, labels = _aug_inputs()
    b, h, w, _ = imgs.shape
    key = jax.random.PRNGKey(7)
    ti, tb, tv, tl = (torch.from_numpy(a) for a in (imgs, boxes, valid, labels))
    if name == "hflip":
        wi, wb = jaug.random_hflip(key, jnp.asarray(imgs), jnp.asarray(boxes))
        gi, gb = taug.apply_hflip(ti, *_key_params(name, key, b, h, w), tb)
        _close(gi, wi, True)
        _close(gb, wb, True)
    elif name == "jitter":
        _close(taug.apply_color_jitter(ti, *_key_params(name, key, b, h, w)),
               jaug.color_jitter(key, jnp.asarray(imgs)), False)
    elif name == "cutout":
        _close(taug.apply_cutout(ti, *_key_params(name, key, b, h, w)),
               jaug.cutout(key, jnp.asarray(imgs)), True)
    elif name == "mosaic":
        want = jaug.mosaic4(key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid),
                            jnp.asarray(labels))
        got = taug.apply_mosaic4(ti, tb, tv, *_key_params(name, key, b, h, w), labels=tl)
        assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in want]
        for g, wv in zip(got, want):
            _close(g, wv, True)
        assert 0 < int(got[2].sum()) < int(tv.sum()) * 4    # some slivers dropped
    else:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        params = {"mosaic": _key_params("mosaic", k1, b, h, w),
                  "hflip": _key_params("hflip", k2, b, h, w),
                  "jitter": _key_params("jitter", k3, b, h, w)[0],
                  "cutout": _key_params("cutout", k4, b, h, w)}
        want = jaug.augment_detection_batch(key, jnp.asarray(imgs), jnp.asarray(boxes),
                                            jnp.asarray(valid), jnp.asarray(labels))
        got = taug.apply_augment(ti, tb, tv, params, labels=tl)
        _close(got[0], want[0], False)
        for g, wv in zip(got[1:], want[1:]):
            _close(g, wv, True)


def test_augment_draws_are_seeded_and_shapes_static():
    imgs, boxes, valid, labels = _aug_inputs()
    args = [torch.from_numpy(a) for a in (imgs, boxes, valid, labels)]
    one = taug.augment_detection_batch(torch.Generator().manual_seed(3), *args)
    two = taug.augment_detection_batch(torch.Generator().manual_seed(3), *args)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert tuple(one[0].shape) == imgs.shape and one[1].shape[1] == 4 * boxes.shape[1]
    flat = taug.augment_detection_batch(torch.Generator().manual_seed(3), *args[:3],
                                        use_mosaic=False)
    assert flat[1].shape == args[1].shape and len(flat) == 3


# -- the archive loader -------------------------------------------------------------------


def _archive(root: str, fmt: str, monkeypatch) -> None:
    if fmt == "npz":
        monkeypatch.setattr(SegmentArchiver, "_write_mp4", staticmethod(lambda path, seg: False))
    else:
        pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    arch = SegmentArchiver(root)
    arch.start()
    for cam in range(2):
        for s in range(3):
            frames = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(5)]
            arch.submit(GopSegment(device_id=f"cam{cam}", start_ts_ms=9000 + 1000 * s,
                                   end_ts_ms=9000 + 1000 * s + 166, fps=30.0, frames=frames))
    arch.stop()
    assert arch.written == 6
    files = sorted(f for d in os.listdir(root) for f in os.listdir(os.path.join(root, d)))
    assert files and all(f.endswith("." + fmt) for f in files)


@pytest.mark.parametrize("fmt,size", [("npz", (48, 64)), ("mp4", (32, 40))])
def test_loader_batches_and_metas_equal_jax(tmp_path, monkeypatch, fmt, size):
    root = str(tmp_path / "archive")
    _archive(root, fmt, monkeypatch)
    got = list(Loader(SegmentDataset(root, size=size, seed=4), batch_size=4, drop_last=False,
                      with_meta=True))
    want = list(JLoader(JSegmentDataset(root, size=size, seed=4), batch_size=4,
                        drop_last=False, with_meta=True))
    assert len(got) == len(want) == 8                 # 30 frames: 7 batches of 4, 1 of 2
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gb.dtype == wb.dtype == np.uint8 and gb.shape[1:3] == size
        assert np.array_equal(gb, wb)
        assert [tuple(vars(m).values()) for m in gm] == [tuple(vars(m).values()) for m in wm]
    clips = list(SegmentDataset(root, size=size, clip_len=2).indexed_samples_from(
        SegmentDataset(root, size=size).refs[0]))
    assert [i for i, _ in clips] == [0, 2] and clips[0][1].shape == (2,) + size + (3,)


# -- msgpack checkpoints ------------------------------------------------------------------


META = {"conf_threshold": 0.425, "calibration_policy": "max_f1_with_precision_floor",
        "calibration_images": 120}


def test_msgpack_interop_both_ways(tmp_path):
    v = _variables()
    # JAX writes (with metadata), the port reads; the bytes are the port's
    jpath = str(tmp_path / "jax.msgpack")
    jck.save_msgpack(jpath, v, meta=META)
    tree, meta = ck.load_msgpack_with_meta(jpath)
    assert meta == META and ck.load_msgpack_meta(jpath) == META
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(v)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ppath = str(tmp_path / "port.msgpack")
    ck.save_msgpack(ppath, carry.to_flax(_port_model(v).state_dict()), meta=META)
    with open(jpath, "rb") as f1, open(ppath, "rb") as f2:
        assert f1.read() == f2.read()
    # the port writes, JAX reads against its own template
    template = jax.tree_util.tree_map(np.zeros_like, v)
    back = jck.load_msgpack(ppath, template)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        assert np.array_equal(np.asarray(a), b)
    assert jck.load_msgpack_meta(ppath) == META
    # the port restores against a template as flax does: missing keys raise
    assert ck.load_msgpack(ppath, template)["params"].keys() == v["params"].keys()
    with pytest.raises(ValueError, match="not in the checkpoint"):
        ck.load_msgpack(ppath, {**template, "quant": {}})
    # set_msgpack_meta across the two packages, the tree untouched
    ck.set_msgpack_meta(jpath, {"conf_threshold": 0.7})
    assert jck.load_msgpack_meta(jpath) == {"conf_threshold": 0.7}
    jck.set_msgpack_meta(ppath, {"conf_threshold": 0.3})
    assert ck.load_msgpack_meta(ppath) == {"conf_threshold": 0.3}
    for path in (jpath, ppath):
        tree = ck.load_msgpack(path)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(v)):
            assert np.array_equal(a, b)
    assert ck.load_msgpack_meta(str(_legacy(tmp_path, v))) is None


def _legacy(tmp_path, v):
    path = tmp_path / "legacy.msgpack"
    path.write_bytes(serialization.msgpack_serialize(v))
    return path


def test_msgpack_encodings_equal_flax_and_refusals(tmp_path):
    """Every type of the subset at each of its size classes packs as flax
    packs it; what the subset cannot hold raises, never misreads."""
    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128,
                     -129, -32768, -32769, -2 ** 31 - 1],
            "floats": [0.5, -1e300], "flags": [True, False, None],
            "strs": ["", "x" * 31, "y" * 32, "z" * 300, "é"], "bin": b"\x00" * 70000,
            "scalar": np.float32(2.5),
            "arrays": {str(i): a for i, a in enumerate([
                np.zeros((), np.float32), np.arange(6, dtype=np.int32).reshape(2, 3),
                np.ones((17,), np.uint8), np.ones((1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                                   1, 1, 1), np.float64), np.array([True])])},
            "long": list(range(20)), "wide": {f"k{i}": i for i in range(20)}}
    data = ck.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = ck.unpackb(data)
    assert back["ints"] == tree["ints"] and back["strs"] == tree["strs"]
    assert back["scalar"] == np.float32(2.5) and back["bin"] == tree["bin"]
    assert np.array_equal(back["arrays"]["1"], tree["arrays"]["1"])
    with pytest.raises(ck.CheckpointFormatError, match="bfloat16"):
        ck.unpackb(serialization.msgpack_serialize(
            {"w": np.asarray(jnp.ones((2,), jnp.bfloat16))}))
    chunked = serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(ck.CheckpointFormatError, match="chunked"):
        ck.unpackb(chunked)
    with pytest.raises(ck.CheckpointFormatError, match="truncated"):
        ck.unpackb(data[:-3])
    with pytest.raises(ck.CheckpointFormatError):
        ck.packb({"t": (1, 2)})
    with pytest.raises(ck.CheckpointFormatError):
        ck.packb({1: 2})


def test_save_is_atomic(tmp_path, monkeypatch):
    """A write that fails at its rename leaves the old file whole and no
    temp file behind."""
    path = str(tmp_path / "ck" / "m.msgpack")
    ck.save_msgpack(path, {"params": {"w": np.ones(3, np.float32)}})

    def fail(src, dst):
        raise OSError("rename failed")

    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError):
        ck.save_msgpack(path, {"params": {"w": np.zeros(3, np.float32)}})
    monkeypatch.undo()
    assert np.array_equal(ck.load_msgpack(path)["params"]["w"], np.ones(3, np.float32))
    assert os.listdir(tmp_path / "ck") == ["m.msgpack"]


# -- the importer's readers and carry.to_flax -----------------------------------------------


def _ultralytics_state(seed: int = 0) -> dict:
    from test_import_weights import _UlYolo, _randomize, _state

    golden = _UlYolo().eval()
    _randomize(golden, seed)
    return _state(golden)


@pytest.mark.parametrize("fmt", ["npz", "safetensors", "pt", "pt_state_dict", "pt_model"])
def test_load_state_dict_matches_jax(tmp_path, fmt):
    state = _ultralytics_state()
    path = str(tmp_path / f"sd.{fmt.split('_')[0]}")
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}
    if fmt == "npz":
        np.savez(path, **state)
    elif fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(tensors, path)
    else:
        obj = dict(tensors, epoch=3) if fmt == "pt" else {fmt[3:]: tensors, "epoch": 3}
        torch.save(obj, path)
    got, want = iw.load_state_dict(path), jiw.load_state_dict(path)
    assert set(got) == set(want) == set(state)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32 and np.array_equal(got[k], want[k])


def test_safetensors_reader_takes_half_precisions(tmp_path):
    from safetensors.torch import save_file

    src = {"h": torch.randn(3, 4).half(), "b": torch.randn(5).bfloat16(),
           "e": torch.zeros(0, 2)}
    save_file(src, str(tmp_path / "x.safetensors"))
    got = iw.load_state_dict(str(tmp_path / "x.safetensors"))
    for k, t in src.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], t.float().numpy())
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 8 + b"{}")
    with pytest.raises(ValueError, match="header length"):
        iw.load_state_dict(str(tmp_path / "bad.safetensors"))


def test_importer_clis_write_the_same_msgpack(tmp_path):
    from tools import import_weights as jcli
    from tools import torch_import_weights as cli

    src = str(tmp_path / "sd.npz")
    np.savez(src, **_ultralytics_state(1))
    assert jcli.main(["--model", "tiny_yolov8", "--src", src,
                      "--out", str(tmp_path / "jax.msgpack")]) == 0
    assert cli.main(["--model", "tiny_yolov8", "--src", src, "--out",
                     str(tmp_path / "port.msgpack"), "--validate", "--device", "cpu"]) == 0
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()


@pytest.mark.parametrize("name", ["tiny_yolov8", "yolov8n", "tiny_resnet",
                                  "tiny_mobilenet_v2", "tiny_vit", "tiny_videomae",
                                  "tiny_blob_gauge"])
def test_to_flax_inverts_from_flax(name):
    _, v = jregistry.get(name).init_params(jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, unbox(v))
    back = carry.to_flax(carry.from_flax(v))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        assert a.dtype == np.float32 and a.shape == b.shape and np.array_equal(a, b)
    with pytest.raises(KeyError):
        carry.to_flax({"stem.mystery.weight": torch.zeros(3)})


def test_fit_state_pads_a_pre_cpad_stem_as_jax_does():
    """A checkpoint with a 3-plane stem for a model whose stem takes 8
    (``stem_pad_c``, yolov8n's lever, on the tiny twin): JAX's
    pad_stem_on_load and the port's fit_state
    (``import_weights.pad_stem_on_load``) pad it alike; under the s2d stem
    it folds instead."""
    import dataclasses

    jcfg = dataclasses.replace(jyolo.tiny_yolov8_config(), stem_pad_c=8)
    jm = jyolo.YOLOv8(jcfg, dtype=jnp.float32)
    template = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    raw = jax.tree_util.tree_map(np.array, template)
    raw["params"]["stem"]["conv"]["kernel"] = raw["params"]["stem"]["conv"]["kernel"][:, :, :3]
    want = jiw.pad_stem_on_load(jax.tree_util.tree_map(np.array, raw), template, jm)
    cfg = dataclasses.replace(tiny_yolov8_config(), stem_pad_c=8)
    got = iw.pad_stem_on_load(carry.from_flax(raw), YOLOv8(cfg, torch.float32))
    assert tuple(got["stem.conv.weight"].shape) == (8, 8, 3, 3)
    assert torch.equal(got["stem.conv.weight"], carry.from_flax(want)["stem.conv.weight"])
    s2d = YOLOv8(dataclasses.replace(cfg, stem="s2d"), torch.float32)
    folded = iw.pad_stem_on_load(carry.from_flax(raw), s2d)["stem.conv.weight"]
    assert tuple(folded.shape) == tuple(s2d.stem.conv.weight.shape) == (8, 12, 2, 2)


# -- the eval tool's scoring ----------------------------------------------------------------


def test_eval_tool_scores_as_jax(monkeypatch):
    """``tools/torch_eval_detector.py`` scores and calibrates exactly as
    ``tools/eval_detector.py`` on the same serving outputs (the serving
    programs are held against each other elsewhere): mAP, the threshold
    sweep and the chosen operating point."""
    from tools import eval_detector as jtool
    from tools import torch_eval_detector as tool

    rng = np.random.default_rng(12)
    n, k, m = 10, 20, 4
    gt_boxes = np.full((n, m, 4), -1, np.float32)
    gt_cls = np.full((n, m), -1, np.int64)
    outs = []
    for i in range(n):
        g = int(rng.integers(0, m + 1))
        xy = rng.uniform(0, 80, (g, 2))
        gt_boxes[i, :g] = np.concatenate([xy, xy + rng.uniform(8, 30, (g, 2))], -1)
        gt_cls[i, :g] = rng.integers(0, 3, g)
        pb = np.concatenate([rng.uniform(0, 80, (k, 2)), rng.uniform(90, 120, (k, 2))], -1)
        pb[:g] = gt_boxes[i, :g] + rng.normal(0, 2, (g, 4))     # some hits
        pc = rng.integers(0, 3, k)
        pc[:g] = gt_cls[i, :g]
        outs.append((i, pb.astype(np.float32), rng.uniform(0, 1, k).astype(np.float32), pc,
                     rng.uniform(size=k) < 0.8))

    def fixed(*args, **kw):
        return iter(outs)
    for mod in (jtool, tool):
        monkeypatch.setattr(mod, "_load_serving_step", lambda *a, **kw: (None, None))
        monkeypatch.setattr(mod, "_batched_outputs", fixed)
    images = np.zeros((n, 8, 8, 3), np.uint8)
    got = tool.evaluate("tiny_yolov8", "", images, gt_boxes, gt_cls, device="cpu")
    want = jtool.evaluate("tiny_yolov8", "", images, gt_boxes, gt_cls)
    assert {k: got[k] for k in want} == want and want["mAP50"] > 0
    got = tool.calibrate("tiny_yolov8", "", images, gt_boxes, gt_cls, device="cpu")
    want = jtool.calibrate("tiny_yolov8", "", images, gt_boxes, gt_cls)
    assert {k: got[k] for k in want} == want
