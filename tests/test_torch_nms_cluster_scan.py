"""The NMS keep-mask kernel's algorithm (``csrc/nms_keep_mask.cu``),
emulated step by step in numpy, against the references on the CPU.

The emulation does what the kernel does, in its order: a cluster of C CTAs
per image, CTA r building the suppression words of a contiguous slice of
rows in its own shared memory (slices cut so that every CTA has the same
number of (row, word) items, within two rows'), words left of the
diagonal never computed, each word formed from two 32-lane ballots,
the division skipped for a (row, word) whose lanes all have inter == 0
(only for t >= 0), the rows gathered into rank 0, then the scan by
diagonal blocks of 64 rows, its chain in the kernel's branch-free form on
32-bit halves. The arithmetic is the kernel's: float32, no
fused multiply-add, NaN-propagating min/max written as the kernel writes
them. Unwritten words hold all ones, so a read of a word the kernel never
writes would suppress boxes and show.

Its keep masks must equal, bit for bit, ``nms_keep_mask_reference`` (the
port's plain version), ``nms_keep_mask_xla`` and ``nms_keep_mask_pallas``
in interpret mode (the JAX package's), at K in {1, 8, 63, 64, 65, 100, 256,
1024}, t in {0, 0.45, 0.7, -0.1} and C in {1, 3, 8}, on boxes with
duplicates, zero and negative areas, all-zero slots, class offsets and a
few NaN and infinite coordinates; and on a chain of boxes each of which
overlaps only its neighbours, where greedy keeps every other box.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import nms as jnms
from video_edge_ai_proxy_tpu_torch.ops import nms as tnms

F32 = np.float32
UNWRITTEN = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
LANES = np.arange(32)


def _max_nan(a, b):
    return np.where(np.isnan(a) | (a > b), a, b)


def _min_nan(a, b):
    return np.where(np.isnan(a) | (a < b), a, b)


def _area(b):
    return _max_nan(b[..., 2] - b[..., 0], F32(0)) * _max_nan(b[..., 3] - b[..., 1], F32(0))


def _inter(bi, bj):
    """bi [n, 1, 4], bj [n, 32, 4] -> [n, 32] intersection areas."""
    iw = _max_nan(_min_nan(bi[..., 2], bj[..., 2]) - _max_nan(bi[..., 0], bj[..., 0]), F32(0))
    ih = _max_nan(_min_nan(bi[..., 3], bj[..., 3]) - _max_nan(bi[..., 1], bj[..., 1]), F32(0))
    return iw * ih


def _iou_above(ai, aj, inter, t):
    uni = _max_nan((ai + aj) - inter, F32(1e-9))
    return inter / uni > t


def _sign_extend(x: int, bits: int) -> int:
    """The kernel's sign_extend (PTX ``szext.clamp.s32``): the low ``bits``
    bits of the 32-bit x, with bit ``bits - 1`` copied into every bit above."""
    low = x & ((1 << bits) - 1)
    return low | (0xFFFF_FFFF ^ ((1 << bits) - 1)) if (x >> (bits - 1)) & 1 else low


def _ballot(pred):
    """[n, 32] bool -> [n] uint64 word of lane bits."""
    return (pred.astype(np.uint64) << LANES.astype(np.uint64)).sum(axis=-1, dtype=np.uint64)


def _items_before(i: int, words: int) -> int:
    """(row, word) items of the rows before row i (row i has words - i // 64)."""
    b = i >> 6
    return 64 * (b * words - b * (b - 1) // 2) + (i & 63) * (words - b)


def row_slices(k: int, cluster: int):
    """[(row0, row1)] of each CTA: the first row whose items_before reaches
    total * r // C, as the kernel's binary search finds it."""
    words = (k + 63) // 64
    total = _items_before(k, words)
    cut = [next(i for i in range(k + 1) if _items_before(i, words) >= total * r // cluster)
           for r in range(cluster + 1)]
    return list(zip(cut[:-1], cut[1:]))


def emulate_keep_mask(boxes: np.ndarray, t: float, cluster: int):
    """[K, 4] float32 boxes -> ([K] bool keep, {"divided": n, "skipped": n}
    (row, word) items), as the kernel computes them."""
    k = boxes.shape[0]
    words = (k + 63) // 64
    t = F32(t)
    may_skip = bool(t >= 0)
    stats = {"divided": 0, "skipped": 0}
    rank0 = np.full((k, words), UNWRITTEN)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        area = _area(boxes)
        for rank, (row0, row1) in enumerate(row_slices(k, cluster)):
            local = rank0 if rank == 0 else np.full((k, words), UNWRITTEN)
            for w in range(words):
                # The rows of this CTA whose word w is at or right of the
                # diagonal; one warp each.
                i = np.arange(row0, row1)
                i = i[(i >> 6) <= w]
                if i.size == 0:
                    continue
                ii = i[:, None]
                ja = np.broadcast_to(64 * w + LANES, (i.size, 32))
                jb = ja + 32
                va, vb = (ja > ii) & (ja < k), (jb > ii) & (jb < k)
                ca, cb = np.minimum(ja, k - 1), np.minimum(jb, k - 1)
                bi = boxes[i][:, None, :]
                inter_a, inter_b = _inter(bi, boxes[ca]), _inter(bi, boxes[cb])
                divide = np.ones(i.size, bool)
                if may_skip:
                    divide = ((va & (inter_a != 0)) | (vb & (inter_b != 0))).any(axis=1)
                pa, pb = np.zeros_like(va), np.zeros_like(vb)
                d = divide
                ai = area[i][d, None]
                pa[d] = va[d] & _iou_above(ai, area[ca][d], inter_a[d], t)
                pb[d] = vb[d] & _iou_above(ai, area[cb][d], inter_b[d], t)
                local[i, w] = _ballot(pa) | (_ballot(pb) << np.uint64(32))
                stats["divided"] += int(d.sum())
                stats["skipped"] += int((~d).sum())
            if rank != 0:   # the gather: this CTA's rows, right of the diagonal
                for i in range(row0, row1):
                    rank0[i, i >> 6:] = local[i, i >> 6:]

    removed = [0] * words
    for b in range(words):
        base, n = 64 * b, min(64, k - 64 * b)
        diag = [int(rank0[base + r, b]) for r in range(n)] + [0] * (64 - n)
        # The chain as the kernel runs it: rem |= diag[r] & ~sign_extend(rem,
        # r + 1) on 32-bit halves, which ORs diag[r] in exactly when bit r
        # of rem is clear (diag[r] has bits only above r).
        lo, hi = removed[b] & 0xFFFF_FFFF, removed[b] >> 32
        for r in range(32):
            m = _sign_extend(lo, r + 1)
            hi |= (diag[r] >> 32) & (0 if m >> 31 else 0xFFFF_FFFF)
            lo |= diag[r] & 0xFFFF_FFFF & ~m
        for r in range(32, 64):
            hi |= (diag[r] >> 32) & ~_sign_extend(hi, r - 31) & 0xFFFF_FFFF
        rem = (hi << 32) | lo
        removed[b] = rem
        kept = ~rem & ((1 << n) - 1)
        for w in range(b + 1, words):
            for r in range(n):
                if (kept >> r) & 1:
                    removed[w] |= int(rank0[base + r, w])
    keep = np.array([not (removed[j >> 6] >> (j & 63)) & 1 for j in range(k)], bool)
    return keep, stats


def _boxes(k: int) -> np.ndarray:
    """Seeded random boxes, heavily overlapping, with the edge cases."""
    rng = np.random.default_rng(1000 + k)
    xy = rng.uniform(0, 60, (k, 2))
    wh = rng.uniform(2, 40, (k, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(F32)
    b[1::7] = b[0]                                  # duplicates
    b[3::11, 2] = b[3::11, 0]                       # zero width
    b[4::13, 3] = b[4::13, 1] - 5.0                 # negative height
    b[-max(1, k // 8):] = 0.0                       # all-zero slots
    if k >= 8:
        cls = rng.integers(0, 80, (k // 2,)).astype(F32)
        b[2:2 + k // 2] += cls[:, None] * F32(tnms._CLASS_OFFSET)
        b[5] = b[2]                                 # a duplicate far from the origin
        b[6::17, 0] = np.nan
        b[7::19, 3] = np.inf
        b[8::23, 1] = -np.inf
        b[9::29, 2] = np.inf
    return b


@functools.lru_cache(maxsize=None)
def _references(k: int, t: float):
    """(boxes, plain version, XLA, Pallas in interpret mode) keep masks."""
    b = _boxes(k)
    port = tnms.nms_keep_mask_reference(torch.from_numpy(b), t).numpy()
    xla = np.asarray(jnms.nms_keep_mask_xla(jnp.asarray(b), t))
    pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(b), t, interpret=True))
    return b, port, xla, pallas


def _chain_boxes(k: int) -> np.ndarray:
    """Unit squares 0.2 apart along x: each overlaps its neighbour with IoU
    2/3 and the next but one with IoU 3/7, so at t = 0.45 greedy keeps
    every other box, and every odd row -- row 31 and row 63 of each block
    among them -- is removed while its word still reaches the next row."""
    x = np.arange(k, dtype=F32) * F32(0.2)
    return np.stack([x, np.zeros_like(x), x + F32(1), np.ones_like(x)], axis=1)


@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("k", [33, 64, 65, 100, 256, 1024])
def test_cluster_scan_emulation_on_a_suppression_chain(k, cluster):
    b = _chain_boxes(k)
    port = tnms.nms_keep_mask_reference(torch.from_numpy(b), 0.45).numpy()
    np.testing.assert_array_equal(port, np.arange(k) % 2 == 0)
    np.testing.assert_array_equal(port, np.asarray(jnms.nms_keep_mask_xla(jnp.asarray(b), 0.45)))
    keep, _ = emulate_keep_mask(b, 0.45, cluster)
    np.testing.assert_array_equal(keep, port)


@pytest.mark.parametrize("cluster", [1, 3, 8])
@pytest.mark.parametrize("t", [0.0, 0.45, 0.7, -0.1])
@pytest.mark.parametrize("k", [1, 8, 63, 64, 65, 100, 256, 1024])
def test_cluster_scan_emulation_is_bit_identical(k, t, cluster):
    b, port, xla, pallas = _references(k, t)
    np.testing.assert_array_equal(port, xla)
    np.testing.assert_array_equal(port, pallas)
    keep, stats = emulate_keep_mask(b, t, cluster)
    np.testing.assert_array_equal(keep, port)
    words = (k + 63) // 64
    # One item per (row, word at or right of the diagonal): none left of it.
    assert stats["divided"] + stats["skipped"] == sum(words - (i >> 6) for i in range(k))
    slices = row_slices(k, cluster)
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    work = [_items_before(r1, words) - _items_before(r0, words) for r0, r1 in slices]
    assert max(work) - min(work) <= 2 * words      # balanced: each cut overshoots by < one row
    if t < 0:
        assert stats["skipped"] == 0
    elif k >= 64:
        assert stats["skipped"] > 0   # class-offset rows overlap no box of a word
