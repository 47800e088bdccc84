"""The port's NMS against the JAX package's, on the same numpy inputs.

Keep masks must be exactly equal to both ``nms_keep_mask_xla`` and the
Pallas kernel run in interpret mode; ``batched_nms`` outputs exactly equal
to ``batched_nms(use_pallas=False)`` except scores, to 1e-6 (both sides
gather the same float32 values, so the scores agree exactly in practice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import nms as jnms
from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda
from video_edge_ai_proxy_tpu_torch.ops import nms as tnms

IOU_T = 0.45


def _boxes(rng, k):
    """Random xyxy boxes with heavy overlap plus the edge cases: a
    duplicate pair, zero-area boxes, all-zero slots and class-offset boxes
    (up to 79 * 8192 px from the origin, where f32 spacing is ~0.06 px)."""
    xy = rng.uniform(0, 60, (k, 2))
    wh = rng.uniform(2, 40, (k, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if k >= 8:
        b[1] = b[0]                       # duplicate
        b[3, 2] = b[3, 0]                 # zero width
        b[4, 3] = b[4, 1] - 5.0           # negative height
        b[-2:] = 0.0                      # all-zero slots
        cls = rng.integers(0, 80, (k // 2,)).astype(np.float32)
        b[2:2 + k // 2] += cls[:, None] * tnms._CLASS_OFFSET
        b[5] = b[2]                       # a duplicate far from the origin
    return b


@pytest.mark.parametrize("k", [8, 64, 256])
def test_reference_keep_mask_equals_xla_and_pallas(k):
    rng = np.random.default_rng(k)
    b = _boxes(rng, k)
    port = tnms.nms_keep_mask_reference(torch.from_numpy(b), IOU_T).numpy()
    xla = np.asarray(jnms.nms_keep_mask_xla(jnp.asarray(b), IOU_T))
    pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(b), IOU_T, interpret=True))
    np.testing.assert_array_equal(port, xla)
    np.testing.assert_array_equal(port, pallas)
    assert 0 < port.sum() < k                 # some boxes suppressed, some kept


def test_reference_keep_mask_batched_equals_per_image():
    rng = np.random.default_rng(11)
    b = np.stack([_boxes(rng, 64) for _ in range(4)])
    port = tnms.nms_keep_mask_reference(torch.from_numpy(b), IOU_T).numpy()
    for i in range(4):
        np.testing.assert_array_equal(
            port[i], np.asarray(jnms.nms_keep_mask_xla(jnp.asarray(b[i]), IOU_T)))


def test_keep_mask_dispatch_on_cpu_is_the_plain_loop():
    rng = np.random.default_rng(3)
    b = torch.from_numpy(np.stack([_boxes(rng, 32), _boxes(rng, 32)]))
    np.testing.assert_array_equal(tnms.nms_keep_mask(b, IOU_T).numpy(),
                                  tnms.nms_keep_mask_reference(b, IOU_T).numpy())


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_keep_mask_cuda(torch.zeros((1, 8, 4)), IOU_T)


def _nms_inputs(seed, b, a, tied):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, a) for _ in range(b)])
    # Undo the class offsets: batched_nms applies its own.
    boxes = np.mod(boxes, tnms._CLASS_OFFSET).astype(np.float32)
    scores = rng.uniform(0, 1, (b, a)).astype(np.float32)
    if tied:
        scores = np.round(scores * 8) / 8     # many exact ties
    classes = rng.integers(0, 4, (b, a)).astype(np.int32)
    return boxes, scores.astype(np.float32), classes


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("cand,det", [(256, 100), (64, 20)])
def test_batched_nms_equals_jax(tied, cand, det):
    boxes, scores, classes = _nms_inputs(7, 3, 300, tied)
    jb, js, jc, jv = jnms.batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        max_candidates=cand, max_det=det, use_pallas=False)
    tb, ts, tc, tv = tnms.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
        max_candidates=cand, max_det=det)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert tv.numpy().sum() > 0


def test_batched_nms_pads_when_fewer_anchors_than_max_det():
    boxes, scores, classes = _nms_inputs(9, 2, 40, False)
    jb, js, jc, jv = jnms.batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), use_pallas=False)
    tb, ts, tc, tv = tnms.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes))
    assert tb.shape == (2, 100, 4) and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
