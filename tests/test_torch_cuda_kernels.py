"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the NMS keep mask, the flash-attention forward and its two backward
kernels (each in float32 and, on the tensor cores, in bf16).

Marked ``cuda``: each test skips without a GPU (decided inside the test).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.ops import nms as tnms

pytestmark = pytest.mark.cuda

IOU_T = 0.45


@pytest.fixture(scope="module")
def card():
    """The card, with every kernel built first: the profiler checks below
    (which kernel a dtype ran) found no device event at all in runs that
    built kernels inside the process after the first profiler session, as
    chip_smoke.py never does (it builds in phase 2, before any profile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


def _boxes(rng, b, k):
    xy = rng.uniform(0, 60, (b, k, 2))
    wh = rng.uniform(2, 40, (b, k, 2))
    out = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    out[:, 1::7] = out[:, 0:1]                                  # duplicates
    out[:, 3::11, 2] = out[:, 3::11, 0]                         # zero width
    out[:, -3:] = 0.0                                           # all-zero slots
    cls = rng.integers(0, 80, (b, k, 1)).astype(np.float32)
    return out + np.where(rng.uniform(size=(b, k, 1)) < 0.5, cls * tnms._CLASS_OFFSET, 0.0
                          ).astype(np.float32)


@pytest.mark.parametrize("b,k", [(1, 8), (16, 256), (3, 64), (2, 100), (4, 1000), (2, 1024)])
def test_keep_mask_kernel_equals_plain_version(card, b, k):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    boxes = torch.from_numpy(_boxes(np.random.default_rng(k), b, k)).to(card)
    before = nms_keep_mask_cuda.launches
    got = nms_keep_mask_cuda(boxes, IOU_T)
    torch.cuda.synchronize()
    assert nms_keep_mask_cuda.launches == before + 1
    want = tnms.nms_keep_mask_reference(boxes, IOU_T)
    assert got.dtype == torch.bool and got.shape == (b, k)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), tnms.nms_keep_mask_reference(boxes.cpu(), IOU_T))


def _nonfinite(boxes):
    """A few NaN, +inf and -inf coordinates among the boxes."""
    boxes = boxes.copy()
    boxes[:, 2::13, 0] = np.nan
    boxes[:, 5::17, 3] = np.inf
    boxes[:, 6::19, 1] = -np.inf
    boxes[:, 9::23, 2] = np.inf
    return boxes


# The kernel's edges: one candidate, one and two 64-bit words per row, the
# largest K; B = 40 launches more clusters than fit on the card at once.
@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("t", [0.0, 0.45, 0.7, -0.1])
@pytest.mark.parametrize("b,k", [(b, k) for b in (1, 16, 40) for k in (1, 64, 65, 1024)])
def test_keep_mask_kernel_edge_cases_equal_plain_version(card, b, k, t, nonfinite):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    boxes = _boxes(np.random.default_rng(b * 10_000 + k), b, k)
    if nonfinite:
        boxes = _nonfinite(boxes)
    boxes = torch.from_numpy(boxes).to(card)
    got = nms_keep_mask_cuda(boxes, t)
    torch.cuda.synchronize()
    assert torch.equal(got, tnms.nms_keep_mask_reference(boxes, t))


# Unit squares 0.2 apart along x: greedy keeps every other box at t = 0.45,
# and every odd row (row 31 and row 63 of each 64-row block among them) is
# removed while its word still reaches the next row.
@pytest.mark.parametrize("b,k", [(1, 33), (16, 64), (16, 65), (16, 256), (4, 1024)])
def test_keep_mask_kernel_on_a_suppression_chain(card, b, k):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    x = torch.arange(k, dtype=torch.float32) * 0.2
    one = torch.stack([x, torch.zeros_like(x), x + 1.0, torch.ones_like(x)], dim=-1)
    boxes = one.expand(b, k, 4).contiguous().to(card)
    got = nms_keep_mask_cuda(boxes, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), (torch.arange(k) % 2 == 0).expand(b, k))


def test_keep_mask_kernel_refuses_what_it_does_not_take(card):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    with pytest.raises(ValueError):
        nms_keep_mask_cuda(torch.zeros((1, 1025, 4), device=card), IOU_T)
    with pytest.raises(TypeError):
        nms_keep_mask_cuda(torch.zeros((1, 8, 4), device=card, dtype=torch.float16), IOU_T)
    with pytest.raises(ValueError):
        nms_keep_mask_cuda(torch.zeros((1, 4, 8), device=card).transpose(1, 2), IOU_T)


# 2**28 images of one box ask for a grid of 2**28 clusters of 8 CTAs,
# 2**31, one more than a launch may have. 2**29 + 1 images would make
# 2**32 + 8 CTAs, which wraps to 8 in 32 bits and would run one cluster.
# Both are refused.
@pytest.mark.parametrize("b", [2 ** 28, 2 ** 29 + 1])
def test_keep_mask_refused_launch_raises_and_leaves_no_error(card, b):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    boxes = torch.zeros((b, 1, 4), device=card)
    before = nms_keep_mask_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        nms_keep_mask_cuda(boxes, IOU_T)
    assert nms_keep_mask_cuda.launches == before
    del boxes
    # The refusal leaves no error behind for the next launch to report.
    small = torch.from_numpy(_boxes(np.random.default_rng(5), 2, 64)).to(card)
    assert torch.equal(nms_keep_mask_cuda(small, IOU_T),
                       tnms.nms_keep_mask_reference(small, IOU_T))


def test_batched_nms_on_card_equals_cpu(card):
    rng = np.random.default_rng(0)
    boxes = np.mod(_boxes(rng, 4, 8400), tnms._CLASS_OFFSET).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, (4, 8400)) * 16) / 16).astype(np.float32)
    classes = rng.integers(0, 80, (4, 8400)).astype(np.int32)
    cpu = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(classes))
    gpu = tnms.batched_nms(torch.from_numpy(boxes).to(card), torch.from_numpy(scores).to(card),
                           torch.from_numpy(classes).to(card))
    for c, g in zip(cpu, gpu):
        assert torch.equal(c, g.cpu())


# Flash-attention forward. Tolerances: the kernel and its plain version both
# compute in float32 from the same inputs, in another order of summation:
# 1e-5 on O and LSE. A bf16 O is rounded once from the float32 result, so
# the two may also land one bf16 ulp apart, and one ulp of x is at most
# 2**-7 * |x|: 1e-5 + 2**-7 * |O| in bf16. The bf16 cases run the
# tensor-core forward at each head dim it instantiates; those with
# true_t < Tp hold random, nonzero padded rows, which the forward must
# compute from (queries) or never read (keys, values).
FLASH_CASES = [
    (2, 64, 16, 64, torch.float32),
    (1, 24, 16, 24, torch.float32),
    (4, 256, 64, 200, torch.float32),
    (3, 200, 32, 150, torch.bfloat16),
    (24, 512, 64, 512, torch.bfloat16),
    (2, 256, 16, 200, torch.bfloat16),
    (4, 1024, 64, 1000, torch.bfloat16),
]


def _packed(rng, bh, tp, d, dtype, card):
    return [torch.from_numpy(rng.normal(0, 1, (bh, tp, d)).astype(np.float32)).to(card, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("bh,tp,d,true_t,dtype", FLASH_CASES)
def test_flash_kernel_equals_plain_version(card, bh, tp, d, true_t, dtype):
    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention_reference

    q, k, v = _packed(np.random.default_rng(tp + d), bh, tp, d, dtype, card)
    before = flash_attention_fwd_cuda.launches
    o, lse = flash_attention_fwd_cuda(q, k, v, true_t)
    torch.cuda.synchronize()
    assert flash_attention_fwd_cuda.launches == before + 1
    assert o.dtype == dtype and o.shape == (bh, tp, d)
    assert lse.dtype == torch.float32 and lse.shape == (bh, tp, 1)
    want_o, want_lse = flash_attention_reference(q, k, v, true_t)
    o, want_o = o.float(), want_o.float()
    o_tol = 1e-5
    if dtype == torch.bfloat16:
        o_tol = o_tol + 2.0 ** -7 * torch.maximum(o.abs(), want_o.abs())
    assert bool(((o - want_o).abs() <= o_tol).all())
    assert float((lse - want_lse).abs().max()) <= 1e-5


def test_flash_attention_on_card_matches_cpu(card):
    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = (torch.from_numpy(x) for x in
               np.random.default_rng(0).normal(0, 1, (3, 2, 200, 3, 32)).astype(np.float32))
    before = flash_attention_fwd_cuda.launches
    got = flash_attention(q.to(card), k.to(card), v.to(card))
    assert flash_attention_fwd_cuda.launches == before + 1
    assert float((got.cpu() - flash_attention(q, k, v)).abs().max()) <= 1e-5


def test_flash_kernel_refuses_what_it_does_not_take(card):
    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda

    x = torch.zeros((2, 64, 64), device=card)
    with pytest.raises(TypeError):
        flash_attention_fwd_cuda(*(x.half(),) * 3, 64)
    with pytest.raises(TypeError):
        flash_attention_fwd_cuda(x, x, x.bfloat16(), 64)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd_cuda(*(torch.zeros((2, 64, 48), device=card),) * 3, 64)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 64, 64), device=card).transpose(0, 1).contiguous().transpose(0, 1)
        flash_attention_fwd_cuda(t, x, x, 64)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_fwd_cuda(x, x, torch.zeros((2, 32, 64), device=card), 32)
    with pytest.raises(ValueError, match="true_t"):
        flash_attention_fwd_cuda(x, x, x, 65)


def _device_kernels(fn, part, attempts=3):
    """Names of the device kernels containing ``part`` that one call of
    ``fn`` launched, from torch.profiler. A session in which the profiler
    recorded no device event at all is profiled again, up to ``attempts``
    times: on the H100 it now and then records none for a session of one
    short kernel, which says nothing about the route."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
        print(f"profiler session {attempt + 1} of {attempts} recorded no device event "
              f"({len(prof.events())} events in all)")
    return {e.name for e in events if part in e.name}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_dtype_picks_the_kernel(card, dtype):
    """bf16 runs the tensor-core forward (csrc/flash_attention_fwd_sm90.cu),
    float32 the float32 one (csrc/flash_attention_fwd.cu), and nothing else."""
    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda

    q, k, v = _packed(np.random.default_rng(4), 2, 256, 64, dtype, card)
    names = _device_kernels(lambda: flash_attention_fwd_cuda(q, k, v, 200), "flash_fwd_kernel")
    assert len(names) == 1
    assert ("flash_fwd_kernel_wgmma" in names.pop()) == (dtype == torch.bfloat16)


def test_fwd_refuses_misaligned_bf16(card):
    """The tensor-core forward copies 16-byte chunks: a bf16 view that does
    not start on a 16-byte boundary is refused, not read misaligned."""
    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda

    x = torch.zeros((2, 64, 64), device=card, dtype=torch.bfloat16)
    odd = torch.zeros(2 * 64 * 64 + 1, device=card, dtype=torch.bfloat16)[1:].view(2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd_cuda(x, odd, x, 64)


# Flash-attention backward. Tolerances as for the forward: the kernels and
# their plain versions compute in float32 from the same inputs (on the H100
# the float32 kernels agree bit for bit at these shapes: their sequential
# FMAs happen to follow cuBLAS's order; the bf16 tensor-core kernels carry
# p and ds as two bf16 halves, about 2**-17 of each term), so 1e-5 on dq,
# dk and dv covers another order of summation; a bf16 gradient is rounded
# once from the float32 result, so one bf16 ulp (2**-7 * |x|) more in bf16.
def _bwd_inputs(rng, bh, tp, d, true_t, dtype, card):
    from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention_reference

    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (bh, tp, d)).astype(np.float32))
                   .to(card, dtype) for _ in range(4))
    do[:, true_t:] = 0                         # padded query rows, as autograd gives them
    o, lse = flash_attention_reference(q, k, v, true_t)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return q, k, v, do, lse, delta


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    tol = 1e-5
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
    return bool(torch.isfinite(got).all()) and bool(((got - want).abs() <= tol).all())


# The backward adds bf16 at D = 16, the tiny twins' head dim, which the
# tensor-core dq and dk/dv kernels instantiate beside 32 and 64 (bf16 at
# D = 32 is FLASH_CASES' (3, 200, 32, 150), with random padded rows).
BWD_CASES = FLASH_CASES + [(2, 1664, 16, 1568, torch.bfloat16)]


@pytest.mark.parametrize("bh,tp,d,true_t,dtype", BWD_CASES)
def test_flash_backward_kernels_equal_plain_versions(card, bh, tp, d, true_t, dtype):
    from video_edge_ai_proxy_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda,
    )
    from video_edge_ai_proxy_tpu_torch.ops import flash_attention as tfa

    args = _bwd_inputs(np.random.default_rng(tp + d + 1), bh, tp, d, true_t, dtype, card)
    before = (flash_attention_bwd_dq_cuda.launches, flash_attention_bwd_dkv_cuda.launches)
    dq = flash_attention_bwd_dq_cuda(*args, true_t)
    dk, dv = flash_attention_bwd_dkv_cuda(*args, true_t)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq_cuda.launches, flash_attention_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want_dq = tfa.flash_attention_bwd_dq_reference(*args, true_t)
    want_dk, want_dv = tfa.flash_attention_bwd_dkv_reference(*args, true_t)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == (bh, tp, d)
        assert _close(got, want, dtype)
    assert not dk[:, true_t:].any() and not dv[:, true_t:].any()


# The backward kernels by wrapper name, and the part of the device kernel's
# name they launch: flash_bwd_dq_kernel_wgmma
# (csrc/flash_attention_bwd_dq_sm90.cu) and flash_bwd_dkv_kernel_wgmma
# (csrc/flash_attention_bwd_dkv_sm90.cu) in bf16; flash_bwd_dq_kernel and
# flash_bwd_dkv_kernel (csrc/flash_attention_bwd.cu) in float32.
BWD_KERNELS = [("flash_attention_bwd_dq_cuda", "flash_bwd_dq_kernel"),
               ("flash_attention_bwd_dkv_cuda", "flash_bwd_dkv_kernel")]


@pytest.mark.parametrize("wrapper,kernel", BWD_KERNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_dtype_picks_the_kernel(card, dtype, wrapper, kernel):
    """bf16 runs the backward's tensor-core kernel, float32 its float32 one,
    and nothing else."""
    from video_edge_ai_proxy_tpu_torch.kernels import flash

    fn = getattr(flash, wrapper)
    args = _bwd_inputs(np.random.default_rng(3), 2, 256, 64, 200, dtype, card)
    names = _device_kernels(lambda: fn(*args, 200), kernel)
    assert len(names) == 1
    assert (kernel + "_wgmma" in names.pop()) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("wrapper", [w for w, _ in BWD_KERNELS])
def test_bwd_refuses_misaligned_bf16(card, wrapper):
    """The tensor-core kernels copy 16-byte chunks: a bf16 view that does
    not start on a 16-byte boundary is refused, not read misaligned."""
    from video_edge_ai_proxy_tpu_torch.kernels import flash

    x = torch.zeros((2, 64, 64), device=card, dtype=torch.bfloat16)
    odd = torch.zeros(2 * 64 * 64 + 1, device=card, dtype=torch.bfloat16)[1:].view(2, 64, 64)
    rows = torch.zeros((2, 64, 1), device=card)
    with pytest.raises(ValueError, match="aligned"):
        getattr(flash, wrapper)(x, x, x, odd, rows, rows, 64)


def test_flash_attention_gradients_on_card(card):
    """Through the autograd Function: the three kernels run, and q, k, v get
    nonzero gradients equal to the plain passes' and to the CPU's."""
    from video_edge_ai_proxy_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda, flash_attention_fwd_cuda,
    )
    from video_edge_ai_proxy_tpu_torch.ops import flash_attention as tfa

    x = np.random.default_rng(1).normal(0, 1, (4, 2, 200, 3, 32)).astype(np.float32)
    grads = {}
    for name, dev, passes in (("kernels", card, tfa.KERNELS), ("plain", card, tfa.PLAIN),
                              ("cpu", torch.device("cpu"), tfa.KERNELS)):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in x[:3])
        before = [f.launches for f in (flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
                                       flash_attention_bwd_dkv_cuda)]
        out = tfa.FlashAttention.apply(q, k, v, 128, 128, passes)
        (out * torch.from_numpy(x[3]).to(dev)).sum().backward()
        after = [f.launches for f in (flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_dkv_cuda)]
        want_launches = 1 if name == "kernels" else 0
        assert [a - b for a, b in zip(after, before)] == [want_launches] * 3
        grads[name] = [a.grad.cpu() for a in (q, k, v)]
    for g, p, c in zip(grads["kernels"], grads["plain"], grads["cpu"]):
        assert float(g.abs().max()) > 0.0
        assert float((g - p).abs().max()) <= 1e-5
        assert float((g - c).abs().max()) <= 1e-4


def test_flash_backward_kernels_refuse_what_they_do_not_take(card):
    from video_edge_ai_proxy_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda,
    )

    x = torch.zeros((2, 64, 64), device=card)
    rows = torch.zeros((2, 64, 1), device=card)
    for fn in (flash_attention_bwd_dq_cuda, flash_attention_bwd_dkv_cuda):
        with pytest.raises(TypeError):
            fn(*(x.half(),) * 4, rows, rows, 64)
        with pytest.raises(TypeError):
            fn(x, x, x, x.bfloat16(), rows, rows, 64)
        with pytest.raises(ValueError, match="lse and delta"):
            fn(x, x, x, x, rows.bfloat16(), rows, 64)
        with pytest.raises(ValueError, match="lse and delta"):
            fn(x, x, x, x, rows, torch.zeros((2, 64), device=card), 64)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x, x, x, x.transpose(1, 2).contiguous().transpose(1, 2), rows, rows, 64)
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, x, x, x, rows.cpu(), rows, 64)
        with pytest.raises(ValueError, match="true_t"):
            fn(x, x, x, x, rows, rows, 0)
