"""The port's preprocessing against the JAX package's, on the same numpy
frames. Tolerance RTOL = ATOL = 2e-4 in float32 (the bar of
tests/test_import_weights.py for torch against flax); the resize matrices
are built by the same numpy code and agree to 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import preprocess as jpre
from video_edge_ai_proxy_tpu_torch.ops import preprocess as tpre

TOL = 2e-4


@pytest.mark.parametrize("src,dst", [(1080, 360), (1920, 640), (270, 64), (64, 96),
                                     (7, 5), (5, 7), (100, 100), (480, 640)])
def test_resize_matrix_equal(src, dst):
    np.testing.assert_allclose(tpre._resize_matrix(src, dst),
                               jpre._resize_matrix(src, dst), rtol=0, atol=1e-7)


@pytest.mark.parametrize("hw", [(1080, 1920), (270, 480), (64, 96), (96, 128),
                                (333, 501), (1, 7)])
@pytest.mark.parametrize("dst", [64, 640])
def test_letterbox_params_equal(hw, dst):
    assert tpre.letterbox_params(hw, dst) == jpre.letterbox_params(hw, dst)


@pytest.mark.parametrize("shape,dst", [((2, 270, 480, 3), 640), ((2, 64, 96, 3), 64)])
def test_preprocess_letterbox_f32(shape, dst):
    frames = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    jx, jlb = jpre.preprocess_letterbox(jnp.asarray(frames), dst, out_dtype=jnp.float32)
    tx, tlb = tpre.preprocess_letterbox(torch.from_numpy(frames), dst,
                                        out_dtype=torch.float32)
    assert tuple(tlb) == tuple(jlb)
    assert tx.dtype == torch.float32 and tx.shape == (shape[0], dst, dst, 3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)


def test_preprocess_letterbox_bf16_close():
    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    jx, _ = jpre.preprocess_letterbox(jnp.asarray(frames), 64)
    tx, _ = tpre.preprocess_letterbox(torch.from_numpy(frames), 64)
    assert tx.dtype == torch.bfloat16
    # bf16 keeps 8 bits: values in [0, 1] differ by at most a few ulps
    # (2^-8) where the two frameworks round the matmul at other points.
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32),
                               rtol=0, atol=3 * 2.0 ** -8)


def test_unletterbox_boxes():
    rng = np.random.default_rng(2)
    boxes = rng.uniform(0, 640, (3, 10, 4)).astype(np.float32)
    lb = jpre.letterbox_params((1080, 1920), 640)
    got = tpre.unletterbox_boxes(torch.from_numpy(boxes), tpre.letterbox_params((1080, 1920), 640))
    np.testing.assert_allclose(got.numpy(), np.asarray(jpre.unletterbox_boxes(jnp.asarray(boxes), lb)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 96, 128, 3), (3, 64, 64, 3)])
def test_frame_quality_stats(shape):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    prev = rng.uniform(0, 1, (shape[0], 32, 32)).astype(np.float32)
    js, jt = jpre.frame_quality_stats(jnp.asarray(frames), jnp.asarray(prev), (32, 32))
    ts, tt = tpre.frame_quality_stats(torch.from_numpy(frames), torch.from_numpy(prev), (32, 32))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=TOL, atol=TOL)


def test_pad_channels():
    x = torch.ones((1, 3, 4, 4))
    y = tpre.pad_channels(x, 8, dim=1)
    assert y.shape == (1, 8, 4, 4) and y[:, 3:].abs().sum() == 0
    assert tpre.pad_channels(x, 3, dim=1) is x


# -- device-resident constants ---------------------------------------------------------
# Every constant of a call is built once per (device, dtype, geometry) and
# cached (the card keeps it resident, so a call makes no host-to-device
# copy and a CUDA graph can capture it). Repeated calls reuse the same
# tensors and give the same outputs, and those stay equal to JAX's.

def _calls(rng):
    frames = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    clips = rng.integers(0, 256, (2, 3, 40, 48, 3), dtype=np.uint8)
    prev = rng.uniform(0, 1, (2, 32, 32)).astype(np.float32)
    boxes = rng.uniform(0, 640, (2, 10, 4)).astype(np.float32)
    lb = ((96, 128), 64)
    return {
        "letterbox": (
            lambda: tpre.preprocess_letterbox(torch.from_numpy(frames), 64,
                                              out_dtype=torch.float32)[0],
            lambda: jpre.preprocess_letterbox(jnp.asarray(frames), 64,
                                              out_dtype=jnp.float32)[0]),
        "classify": (
            lambda: tpre.preprocess_classify(torch.from_numpy(frames), (32, 32),
                                             out_dtype=torch.float32),
            lambda: jpre.preprocess_classify(jnp.asarray(frames), (32, 32),
                                             out_dtype=jnp.float32)),
        "clip": (
            lambda: tpre.preprocess_clip(torch.from_numpy(clips), (32, 32),
                                         out_dtype=torch.float32),
            lambda: jpre.preprocess_clip(jnp.asarray(clips), (32, 32), out_dtype=jnp.float32)),
        "unletterbox": (
            lambda: tpre.unletterbox_boxes(torch.from_numpy(boxes), tpre.letterbox_params(*lb)),
            lambda: jpre.unletterbox_boxes(jnp.asarray(boxes), jpre.letterbox_params(*lb))),
        "quality": (
            lambda: tpre.frame_quality_stats(torch.from_numpy(frames), torch.from_numpy(prev),
                                             (32, 32))[0],
            lambda: jpre.frame_quality_stats(jnp.asarray(frames), jnp.asarray(prev),
                                             (32, 32))[0]),
    }


@pytest.mark.parametrize("name", ["letterbox", "classify", "clip", "unletterbox", "quality"])
def test_constants_built_once_and_outputs_unchanged(name):
    torch_fn, jax_fn = _calls(np.random.default_rng(4))[name]
    first = torch_fn()
    misses = tpre._constant.cache_info().misses
    again = torch_fn()
    assert tpre._constant.cache_info().misses == misses, "a repeated call built a constant"
    assert torch.equal(first, again)
    np.testing.assert_allclose(again.numpy(), np.asarray(jax_fn()), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind,key,dtype,want", [
    ("resize", (1080, 360), torch.float32, lambda: torch.from_numpy(tpre._resize_matrix(1080, 360))),
    ("resize", (64, 96), torch.bfloat16,
     lambda: torch.from_numpy(tpre._resize_matrix(64, 96)).to(torch.bfloat16)),
    ("inv255", (), torch.bfloat16, lambda: torch.tensor(1.0 / 255.0, dtype=torch.bfloat16)),
    ("inv255", (), torch.float32, lambda: torch.tensor(1.0 / 255.0, dtype=torch.float32)),
    ("mean", tpre.IMAGENET_MEAN, torch.float32, lambda: torch.tensor(tpre.IMAGENET_MEAN)),
    ("inv_std", tpre.IMAGENET_STD, torch.float32,
     lambda: torch.tensor([1.0 / s for s in tpre.IMAGENET_STD])),
    ("shift", tpre.letterbox_params((1080, 1920), 640), torch.float32,
     lambda: torch.tensor([0.0, 140.0, 0.0, 140.0])),
    ("luma", (), torch.float32, lambda: torch.tensor(tpre._LUMA_BGR)),
])
def test_constant_is_one_tensor_per_key_with_the_old_values(kind, key, dtype, want):
    got = tpre._constant(kind, key, dtype, torch.device("cpu"))
    assert tpre._constant(kind, key, dtype, torch.device("cpu")) is got
    assert got.dtype == dtype and not got.is_inference()
    assert torch.equal(got, want())
