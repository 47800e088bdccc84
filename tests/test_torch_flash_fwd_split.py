"""The numerics of the tensor-core flash forward kernel
(``csrc/flash_attention_fwd_sm90.cu``), emulated in plain torch on the CPU
and held to the bar ``chip_smoke.py`` holds the kernel to.

The kernel takes bf16 q, k, v, forms s = q . k^T * D^-0.5 from bf16
products summed in float32 over 64-key tiles, keeps a running row max m
and denominator l in float32 (alpha = exp(m_old - m_new) rescales l and
the O accumulator at each tile), sums l from the float32 p, and then,
because P . V takes bf16 operands, splits p as p = hi + lo (hi = bf16(p),
lo = bf16(p - hi)) and runs the product twice into the same float32 sums.
``_emulate_fwd`` does the same arithmetic densely. It must land within
``FLASH_TOL`` + ``FLASH_BF16_O_REL`` * |O| on O and ``FLASH_TOL`` on LSE of
the plain version ``flash_attention_reference``, which is the kernel's bar
on the card; the error one bf16 rounding of p would add is printed for the
record (run with ``-s``), not asserted.

Inputs are made with numpy from a seed; one small case also goes through
the JAX package's Pallas forward kernel (interpret mode) on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu_torch.ops import flash_attention as tfa

# chip_smoke.py's bar for the forward kernel: 1e-5 on O and LSE, plus one
# bf16 ulp (2**-7 * |O|) of a bf16 O.
FLASH_TOL = 1e-5
FLASH_BF16_O_REL = 2.0 ** -7
KEY_TILE = 64      # keys per tile of the kernel


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_fwd(qp, kp, vp, true_t: int, split: bool = True):
    """(o, lse) as the tensor-core kernel computes them: bf16 operands,
    float32 sums, an online softmax over 64-key tiles that stops at
    ``true_t``, key and value rows ``>= true_t`` zero-filled, and p split
    into bf16 hi + lo for P . V (or, with ``split=False``, rounded once to
    bf16)."""
    scale = qp.shape[-1] ** -0.5
    q, k, v = (x.float() for x in (qp, kp, vp))
    real = (torch.arange(k.shape[1]) < true_t)[None, :, None]
    k, v = torch.where(real, k, 0.0), torch.where(real, v, 0.0)
    bh, tp, d = q.shape
    m = torch.full((bh, tp, 1), tfa._NEG)
    l = torch.zeros((bh, tp, 1))
    acc = torch.zeros((bh, tp, d))
    for k0 in range(0, true_t, KEY_TILE):
        k_t, v_t = k[:, k0:k0 + KEY_TILE], v[:, k0:k0 + KEY_TILE]
        s = torch.matmul(q, k_t.transpose(1, 2)) * scale
        cols = k0 + torch.arange(k_t.shape[1])
        s = torch.where(cols < true_t, s, tfa._NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if split:
            p_hi, p_lo = _split(p)
            pv = torch.matmul(p_hi, v_t) + torch.matmul(p_lo, v_t)
        else:
            pv = torch.matmul(p.to(torch.bfloat16).float(), v_t)
        acc = acc * alpha + pv
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return (acc / l_safe).to(torch.bfloat16), m + torch.log(l_safe)


def _bf16_case(seed, bh, t, d, padded_rows: bool):
    """Packed bf16 q, k, v of T = t tokens in Tp = packed_len(t) rows; the
    rows past t hold zeros, as packing gives them, or (``padded_rows``)
    random nonzero values, which the kernel must compute from (q) or never
    read (k, v)."""
    rng = np.random.default_rng(seed)
    tp = tfa.packed_len(t)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, tp, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    if not padded_rows:
        for x in (q, k, v):
            x[:, t:] = 0
    return q, k, v


def _excess(got, want):
    """Largest |got - want| beyond the O bar (<= 0 within it), and the
    largest |got - want|, in float32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bar = FLASH_TOL + FLASH_BF16_O_REL * torch.maximum(got.abs(), want.abs())
    return float((diff - bar).max()), float(diff.max())


@pytest.mark.parametrize("t", [1568, 200])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_split_p_holds_the_bar(t, d):
    # T = 200 packs into Tp = 256 rows: its padded rows are random, nonzero.
    q, k, v = _bf16_case(t + d, 2, t, d, padded_rows=t == 200)
    want_o, want_lse = tfa.flash_attention_reference(q, k, v, t)
    got_o, got_lse = _emulate_fwd(q, k, v, t)
    once_o, _ = _emulate_fwd(q, k, v, t, split=False)
    assert got_o.dtype == torch.bfloat16 and got_o.shape == want_o.shape
    assert got_lse.shape == want_lse.shape == (2, q.shape[1], 1)
    excess, worst = _excess(got_o, want_o)
    once_excess, once_worst = _excess(once_o, want_o)
    lse_err = float((got_lse - want_lse).abs().max())
    print(f"T={t} D={d}: split max|dO| {worst:.3g} (excess over the bar {excess:.3g}), "
          f"max|dLSE| {lse_err:.3g}; one bf16 rounding of p: max|dO| {once_worst:.3g} "
          f"(excess {once_excess:.3g}); max|O| {float(want_o.float().abs().max()):.3g}")
    assert excess <= 0.0
    assert lse_err <= FLASH_TOL
    assert bool(torch.isfinite(got_o.float()).all())


def test_split_keeps_float32_accuracy_per_term():
    """hi + lo carries p in (0, 1] to 2**-16 of its size; hi alone to 2**-8."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(1e-6, 1.0, 4096).astype(np.float32))
    hi, lo = _split(x)
    assert float(((hi + lo - x).abs() / x).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x).max()) <= 2.0 ** -8


def test_emulation_matches_the_pallas_kernel():
    t, d, block = 40, 16, 16
    rng = np.random.default_rng(6)
    tp = jfa._padded_t(t, block, block)
    arrs = [rng.normal(0, 1, (2, tp, d)).astype(np.float32) for _ in range(3)]
    for x in arrs[1:]:
        x[:, t:] = 0          # padded keys and values; the padded queries stay random
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in arrs)
    jargs = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)]
    want_o, want_lse = jfa._flash_call(*jargs, block_q=block, block_k=block, true_t=t,
                                       interpret=True)
    got_o, got_lse = _emulate_fwd(q, k, v, t)
    want_o = torch.from_numpy(np.array(want_o.astype(jnp.float32)))
    assert _excess(got_o, want_o)[0] <= 0.0
    assert float((got_lse - torch.from_numpy(np.array(want_lse))).abs().max()) <= FLASH_TOL
