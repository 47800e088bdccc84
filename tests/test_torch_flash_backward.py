"""The port's flash-attention backward against the JAX package's, on the CPU.

- The plain packed backward versions ``flash_attention_bwd_dq_reference``
  and ``flash_attention_bwd_dkv_reference`` against the Pallas kernels
  themselves, ``_flash_bwd_call(..., interpret=True)``, on the same q, k,
  v, dO, lse and delta, within 2e-4 in float32: padded T (17, 40),
  non-divisor blocks (16/24), D = 8 and 16.
- Gradients of ``flash_attention`` through ``FlashAttention`` against
  ``jax.grad`` of the JAX ``flash_attention(interpret=True)`` and against
  autograd of the port's ``default_attention``, within 2e-4.
- The repair: the output carries the Function's ``grad_fn`` and serving
  outputs under ``inference_mode`` equal the plain forward's bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu_torch.kernels.flash import (
    flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda, flash_attention_fwd_cuda,
)
from video_edge_ai_proxy_tpu_torch.models.transformer import default_attention
from video_edge_ai_proxy_tpu_torch.ops import flash_attention as tfa

TOL = 2e-4


def _arrays(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


def _packed_case(seed, b, t, h, d, block_q, block_k):
    """Packed q, k, v, dO (zero on padded rows, as the VJP makes it), the
    Pallas forward's lse and delta = rowsum(dO * O), as numpy."""
    q, k, v, g = _arrays(seed, 4, (b, t, h, d))
    tp = jfa._padded_t(t, block_q, block_k)
    qp, kp, vp, do = (jfa._pack(jnp.asarray(x), tp) for x in (q, k, v, g))
    o, lse = jfa._flash_call(qp, kp, vp, block_q=block_q, block_k=block_k, true_t=t,
                             interpret=True)
    delta = jnp.sum(do * o, axis=-1, keepdims=True)
    return tp, [np.array(x) for x in (qp, kp, vp, do, lse, delta)]


BWD_CASES = [(17, 8, 8, 8), (40, 16, 24, 16), (40, 8, 16, 8), (64, 16, 16, 16)]


@pytest.mark.parametrize("t,block_q,block_k,d", BWD_CASES)
def test_plain_backward_matches_pallas_kernels(t, block_q, block_k, d):
    tp, arrs = _packed_case(t + d, 2, t, 2, d, block_q, block_k)
    want_dq, want_dk, want_dv = jfa._flash_bwd_call(
        *(jnp.asarray(x) for x in arrs), block_q=block_q, block_k=block_k, true_t=t,
        interpret=True)
    tens = [torch.from_numpy(x) for x in arrs]
    dq = tfa.flash_attention_bwd_dq_reference(*tens, t)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(*tens, t)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == (4, tp, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # Padded keys get exact zeros; so do padded query rows of dq (dO and
    # delta are zero there).
    assert not dk[:, t:].any() and not dv[:, t:].any() and not dq[:, t:].any()


def _loss_weights(seed, shape):
    return _arrays(seed, 1, shape)[0]


@pytest.mark.parametrize("t,block_q,block_k,d", [(24, 8, 12, 8), (40, 16, 24, 8),
                                                 (17, 128, 128, 16), (64, 16, 16, 16)])
def test_gradients_match_jax(t, block_q, block_k, d):
    q, k, v = _arrays(t, 3, (2, t, 2, d))
    w = _loss_weights(1000 + t, (2, t, 2, d))

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, block_q=block_q, block_k=block_k, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, block_q=block_q, block_k=block_k)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert float(got.abs().max()) > 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [8, 33, 130])
def test_gradients_match_dense_autograd(t):
    q, k, v = _arrays(2 * t, 3, (2, t, 3, 16))
    w = torch.from_numpy(_loss_weights(t, (2, t, 3, 16)))
    grads = []
    for attn in (tfa.flash_attention, default_attention):
        x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (attn(*x) * w).sum().backward()
        grads.append([a.grad for a in x])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_output_carries_the_functions_grad_fn():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays(3, 3, (1, 24, 2, 16)))
    out = tfa.flash_attention(q, k, v)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_outputs_unchanged_under_inference_mode(dtype):
    """What the forward gave before it became an autograd Function: the
    packed plain forward, unpacked."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _arrays(4, 3, (2, 40, 3, 16)))
    tp = tfa.packed_len(40)
    want, _ = tfa.flash_attention_reference(*(tfa._pack(x, tp) for x in (q, k, v)), 40)
    with torch.inference_mode():
        got = tfa.flash_attention(q, k, v)
    assert got.dtype == dtype and torch.equal(got, tfa._unpack(want, q.shape))


def test_bf16_gradients_keep_the_input_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
               for x in _arrays(5, 3, (1, 20, 2, 16)))
    tfa.flash_attention(q, k, v).float().sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape for x in (q, k, v))


def test_plain_passes_swap_in_on_request():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays(6, 3, (2, 24, 2, 16)))
    w = torch.from_numpy(_loss_weights(7, (2, 24, 2, 16)))
    (tfa.FlashAttention.apply(q, k, v, 128, 128, tfa.PLAIN) * w).sum().backward()
    plain = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (tfa.flash_attention(q, k, v) * w).sum().backward()
    assert all(torch.equal(a, x.grad) for a, x in zip(plain, (q, k, v)))


def test_cpu_tensors_take_the_plain_backward():
    tp, arrs = _packed_case(8, 1, 20, 2, 16, 8, 8)
    tens = [torch.from_numpy(x) for x in arrs]
    before = (flash_attention_fwd_cuda.launches, flash_attention_bwd_dq_cuda.launches,
              flash_attention_bwd_dkv_cuda.launches)
    got = tfa.flash_attention_bwd(*tens, 20)
    want = tfa.flash_attention_bwd_reference(*tens, 20)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == (flash_attention_fwd_cuda.launches, flash_attention_bwd_dq_cuda.launches,
                      flash_attention_bwd_dkv_cuda.launches)
    for wrapper in (flash_attention_bwd_dq_cuda, flash_attention_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*tens, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bwd(*(x.to("meta") for x in tens), 20)
