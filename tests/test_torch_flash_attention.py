"""The port's flash attention against the JAX package's, on the CPU.

- The plain packed forward ``flash_attention_reference`` against the
  Pallas kernel itself, ``_flash_call(..., interpret=True)``: O and LSE in
  float32 at T = 24 (padded to the block grid) and T = 64 (no padding),
  D = 16, two block shapes, within 2e-4.
- The public ``flash_attention`` ([B, T, H, D]) against the JAX
  ``flash_attention(interpret=True)`` in float32 within 2e-4, and the
  packing helpers and block clamping equal to the JAX ones.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda
from video_edge_ai_proxy_tpu_torch.ops import flash_attention as tfa

TOL = 2e-4


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [24, 64])
@pytest.mark.parametrize("block_q,block_k", [(8, 16), (16, 8)])
def test_plain_forward_matches_pallas_kernel(t, block_q, block_k):
    b, h, d = 2, 2, 16
    q, k, v = _qkv(t, (b, t, h, d))
    tp = jfa._padded_t(t, block_q, block_k)
    assert tp == tfa._padded_t(t, block_q, block_k)
    packed = [jfa._pack(jnp.asarray(x), tp) for x in (q, k, v)]
    want_o, want_lse = jfa._flash_call(*packed, block_q=block_q, block_k=block_k,
                                       true_t=t, interpret=True)
    tpacked = [tfa._pack(torch.from_numpy(x), tp) for x in (q, k, v)]
    for jp, tp_ in zip(packed, tpacked):
        np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    got_o, got_lse = tfa.flash_attention_reference(*tpacked, t)
    assert got_o.shape == (b * h, tp, d) and got_lse.shape == (b * h, tp, 1)
    assert got_o.dtype == torch.float32 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,block", [(24, 128), (64, 16), (40, 32)])
def test_public_flash_attention_matches_jax(t, block):
    q, k, v = _qkv(100 + t, (2, t, 4, 16))
    want = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               block_q=block, block_k=block, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              block_q=block, block_k=block)
    assert got.shape == (2, t, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,block_q,block_k", [(5, 128, 128), (24, 128, 128), (200, 128, 128),
                                               (6272, 128, 128), (33, 12, 20)])
def test_padded_length_follows_the_jax_clamping(t, block_q, block_k):
    bq = max(8, -(-min(block_q, max(8, t)) // 8) * 8)
    bk = max(8, -(-min(block_k, max(8, t)) // 8) * 8)
    assert tfa.packed_len(t, block_q, block_k) == jfa._padded_t(t, bq, bk)
    x = torch.arange(2 * t * 3 * 4, dtype=torch.float32).reshape(2, t, 3, 4)
    tp = tfa.packed_len(t, block_q, block_k)
    np.testing.assert_array_equal(tfa._unpack(tfa._pack(x, tp), x.shape).numpy(), x.numpy())


def test_plain_forward_keeps_bf16_output_and_f32_lse():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(7, (3, 16, 32)))
    o, lse = tfa.flash_attention_reference(q, k, v, 10)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_o, want_lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), 10)
    np.testing.assert_array_equal(o.float().numpy(), want_o.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(lse.numpy(), want_lse.numpy())


def test_masked_keys_do_not_contribute():
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, (2, 16, 16)))
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 1e3
    v2[:, 10:] = -1e3
    o, lse = tfa.flash_attention_reference(q, k, v, 10)
    o2, lse2 = tfa.flash_attention_reference(q, k2, v2, 10)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    dense = torch.softmax(q[:, :, None, :].mul(16 ** -0.5).mul(k[:, None, :10]).sum(-1), -1)
    np.testing.assert_allclose(o.numpy(), (dense @ v[:, :10]).numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, (2, 24, 4, 16)))
    before = flash_attention_fwd_cuda.launches
    out = tfa.flash_attention(q, k, v)
    assert flash_attention_fwd_cuda.launches == before
    tp = tfa.packed_len(24)
    want, _ = tfa.flash_attention_reference(*(tfa._pack(x, tp) for x in (q, k, v)), 24)
    assert torch.equal(out, tfa._unpack(want, q.shape))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_cuda(*(tfa._pack(x, tp) for x in (q, k, v)), 24)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(*(x.to("meta") for x in (q, k, v)), 24)
