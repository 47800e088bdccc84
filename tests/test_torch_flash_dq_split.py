"""The numerics of the tensor-core dq kernel
(``csrc/flash_attention_bwd_dq_sm90.cu``), emulated in plain torch on the
CPU and held to the bar ``chip_smoke.py`` holds the kernel to.

The kernel takes bf16 q, k, v and dO, forms s = q . k^T and dP = dO . v^T
from bf16 products summed in float32, p = exp(s * scale - lse) and
ds = p * (dP - delta) in float32, and then, because dq += ds . k takes bf16
operands, splits ds as hi + lo (hi = bf16(ds), lo = bf16(ds - hi)) and runs
the product twice into the same float32 sums. ``_emulate_dq`` does the same
arithmetic densely. It must land within ``FLASH_BWD_TOL`` plus one bf16 ulp
of the plain version ``flash_attention_bwd_dq_reference`` (float32 ds),
which is the kernel's bar on the card; the error one bf16 rounding of ds
would add is printed for the record (run with ``-s``), not asserted.

Inputs are made with numpy from a seed; one small case also goes through
the JAX package's Pallas dq kernel (interpret mode) on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu_torch.ops import flash_attention as tfa

# chip_smoke.py's bar for the backward kernels: 1e-5, plus one bf16 ulp
# (2**-7 * |x|) of a bf16 gradient.
FLASH_BWD_TOL = 1e-5
BF16_ULP_REL = 2.0 ** -7


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_dq(qp, kp, vp, do, lse, delta, true_t: int, split: bool = True):
    """dq as the tensor-core kernel computes it, densely: bf16 operands,
    float32 sums, p zero on the keys >= true_t, ds split into bf16 hi + lo
    (or, with ``split=False``, rounded once to bf16). Every query row,
    padded ones too, is computed."""
    scale = qp.shape[-1] ** -0.5
    q, k, v, g = (x.float() for x in (qp, kp, vp, do))
    real_key = torch.arange(q.shape[1]) < true_t
    s = torch.matmul(q, k.transpose(1, 2))                      # [BH, query, key]
    p = torch.where(real_key[None, None, :], torch.exp(s * scale - lse), torch.zeros(()))
    ds = p * (torch.matmul(g, v.transpose(1, 2)) - delta)
    if split:
        ds_hi, ds_lo = _split(ds)
        dq = torch.matmul(ds_hi, k) + torch.matmul(ds_lo, k)
    else:
        dq = torch.matmul(ds.to(torch.bfloat16).float(), k)
    return (dq * scale).to(torch.bfloat16)


def _bf16_case(seed, bh, t, d, padded_rows: bool = False):
    """Packed bf16 q, k, v, dO, the plain forward's lse and delta =
    rowsum(dO * O). The padded rows are zero, as packing and autograd give
    them, unless ``padded_rows``: then they hold random values, which dq
    must compute from (queries) or never read (keys, values)."""
    rng = np.random.default_rng(seed)
    tp = tfa.packed_len(t)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (bh, tp, d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    if not padded_rows:
        for x in (q, k, v, do):
            x[:, t:] = 0
    o, lse = tfa.flash_attention_reference(q, k, v, t)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return q, k, v, do, lse, delta


def _excess(got, want):
    """Largest |got - want| beyond the bar (<= 0 within it), and the largest
    |got - want|, in float32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bar = FLASH_BWD_TOL + BF16_ULP_REL * torch.maximum(got.abs(), want.abs())
    return float((diff - bar).max()), float(diff.max())


@pytest.mark.parametrize("t", [1568, 200])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_split_ds_holds_the_bar(t, d):
    args = _bf16_case(t + d + 7, 2, t, d)
    want = tfa.flash_attention_bwd_dq_reference(*args, t)
    got = _emulate_dq(*args, t)
    once = _emulate_dq(*args, t, split=False)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    excess, worst = _excess(got, want)
    once_excess, once_worst = _excess(once, want)
    print(f"T={t} D={d} dq: split max|diff| {worst:.3g} (excess over the bar {excess:.3g}); "
          f"one bf16 rounding of ds: max|diff| {once_worst:.3g} (excess {once_excess:.3g}); "
          f"max|dq| {float(want.float().abs().max()):.3g}")
    assert excess <= 0.0


def test_padded_query_rows_are_computed():
    """Query rows in [true_t, Tp) are real rows of the function: with random
    q and dO there, the emulation still holds the bar on every row, and
    those rows are not zero."""
    t, d = 200, 32
    args = _bf16_case(11, 2, t, d, padded_rows=True)
    want = tfa.flash_attention_bwd_dq_reference(*args, t)
    got = _emulate_dq(*args, t)
    assert _excess(got, want)[0] <= 0.0
    assert bool(want[:, t:].any()) and bool(got[:, t:].any())


def test_emulation_matches_the_pallas_kernel():
    t, d, block = 40, 16, 16
    rng = np.random.default_rng(9)
    tp = jfa._padded_t(t, block, block)
    arrs = [rng.normal(0, 1, (2, tp, d)).astype(np.float32) for _ in range(4)]
    for x in arrs:
        x[:, t:] = 0
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrs)
    o, lse = tfa.flash_attention_reference(q, k, v, t)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    jargs = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v, do)]
    jargs += [jnp.asarray(x.numpy()) for x in (lse, delta)]
    want_dq, _, _ = jfa._flash_bwd_call(*jargs, block_q=block, block_k=block, true_t=t,
                                        interpret=True)
    want = torch.from_numpy(np.array(want_dq.astype(jnp.float32)))
    got = _emulate_dq(q, k, v, do, lse, delta, t)
    assert bool(got.float().abs().max() > 0)
    assert _excess(got, want)[0] <= 0.0
