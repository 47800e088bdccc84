"""The numerics of the tensor-core dk/dv kernel
(``csrc/flash_attention_bwd_dkv_sm90.cu``), emulated in plain torch on the
CPU and held to the bar ``chip_smoke.py`` holds the kernel to.

The kernel takes bf16 q, k, v and dO, forms s = q . k^T and dP = dO . v^T
from bf16 products summed in float32, p = exp(s * scale - lse) and
ds = p * (dP - delta) in float32, and then, because the products of the
second pair take bf16 operands, splits p and ds as x = hi + lo
(hi = bf16(x), lo = bf16(x - hi)) and runs each product twice into the same
float32 sums. ``_emulate_dkv`` does the same arithmetic densely. It must
land within ``FLASH_BWD_TOL`` plus one bf16 ulp of the plain version
``flash_attention_bwd_dkv_reference`` (float32 p and ds), which is the
kernel's bar on the card; the error one bf16 rounding of p and ds would
add is printed for the record (run with ``-s``), not asserted.

Inputs are made with numpy from a seed; one small case also goes through
the JAX package's Pallas dk/dv kernel (interpret mode) on the same inputs.
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


def _emulate_dkv(qp, kp, vp, do, lse, delta, true_t: int, split: bool = True):
    """dk, dv as the tensor-core kernel computes them, densely: bf16
    operands, float32 sums, p and ds split into bf16 hi + lo (or, with
    ``split=False``, rounded once to bf16)."""
    scale = qp.shape[-1] ** -0.5
    q, k, v, g = (x.float() for x in (qp, kp, vp, do))
    tp = q.shape[1]
    real = torch.arange(tp) < true_t
    s = torch.matmul(q, k.transpose(1, 2))                      # [BH, query, key]
    p = torch.exp(s * scale - lse)
    p = torch.where(real[None, :, None] & real[None, None, :], p, torch.zeros(()))
    ds = p * (torch.matmul(g, v.transpose(1, 2)) - delta)
    if split:
        (p_hi, p_lo), (ds_hi, ds_lo) = _split(p), _split(ds)
        dv = torch.matmul(p_hi.transpose(1, 2), g) + torch.matmul(p_lo.transpose(1, 2), g)
        dk = torch.matmul(ds_hi.transpose(1, 2), q) + torch.matmul(ds_lo.transpose(1, 2), q)
    else:
        dv = torch.matmul(p.to(torch.bfloat16).float().transpose(1, 2), g)
        dk = torch.matmul(ds.to(torch.bfloat16).float().transpose(1, 2), q)
    return (dk * scale).to(torch.bfloat16), dv.to(torch.bfloat16)


def _bf16_case(seed, bh, t, d):
    """Packed bf16 q, k, v, dO (zero on the padded rows, as packing and
    autograd give them), the plain forward's lse and delta = rowsum(dO * O)."""
    rng = np.random.default_rng(seed)
    tp = tfa.packed_len(t)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (bh, tp, d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
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
def test_split_products_hold_the_bar(t, d):
    args = _bf16_case(t + d, 2, t, d)
    want = tfa.flash_attention_bwd_dkv_reference(*args, t)
    got = _emulate_dkv(*args, t)
    once = _emulate_dkv(*args, t, split=False)
    for name, g, o, w in zip(("dk", "dv"), got, once, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        excess, worst = _excess(g, w)
        once_excess, once_worst = _excess(o, w)
        print(f"T={t} D={d} {name}: split max|diff| {worst:.3g} (excess over the bar "
              f"{excess:.3g}); one bf16 rounding of p and ds: max|diff| {once_worst:.3g} "
              f"(excess {once_excess:.3g}); max|{name}| {float(w.float().abs().max()):.3g}")
        assert excess <= 0.0
        assert not g[:, t:].any()


def test_split_keeps_float32_accuracy_per_term():
    """hi + lo carries x to about 2**-17 of its size; hi alone to 2**-9."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(1e-6, 1.0, 4096).astype(np.float32))
    hi, lo = _split(x)
    assert float(((hi + lo - x).abs() / x).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x).max()) <= 2.0 ** -8


def test_emulation_matches_the_pallas_kernel():
    t, d, block = 40, 16, 16
    rng = np.random.default_rng(5)
    tp = jfa._padded_t(t, block, block)
    arrs = [rng.normal(0, 1, (2, tp, d)).astype(np.float32) for _ in range(4)]
    for x in arrs:
        x[:, t:] = 0
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrs)
    o, lse = tfa.flash_attention_reference(q, k, v, t)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    jargs = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v, do)]
    jargs += [jnp.asarray(x.numpy()) for x in (lse, delta)]
    _, want_dk, want_dv = jfa._flash_bwd_call(*jargs, block_q=block, block_k=block,
                                               true_t=t, interpret=True)
    got = _emulate_dkv(q, k, v, do, lse, delta, t)
    for g, w in zip(got, (want_dk, want_dv)):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert _excess(g, w)[0] <= 0.0
