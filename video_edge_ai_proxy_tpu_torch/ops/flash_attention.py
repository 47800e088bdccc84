"""Exact softmax attention without a [T, T] array in device memory
(counterpart of ``video_edge_ai_proxy_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v)`` takes and returns ``[B, T, H, D]`` (non-causal,
scale ``D**-0.5``), like ``models/transformer.py`` ``default_attention``,
and is its drop-in ``attn_fn`` for long sequences. It packs the heads into
``[B*H, Tp, D]`` with right padding to the block grid and masks the padded
keys, exactly as the JAX package does, and is differentiable through
``FlashAttention``, the twin of the JAX ``_flash`` custom VJP:

- forward: ``flash_attention_fwd`` -> ``(o, lse)``, saved with the packed
  q, k, v for the backward;
- backward: ``delta = rowsum(dO * O)`` in float32 (a plain op, as in JAX),
  then ``flash_attention_bwd`` -> ``(dq, dk, dv)`` from the saved ``lse``.

Each of the two packed passes has two implementations with identical
outputs, picked by the tensors' device only:

- the CUDA kernels ``kernels/flash.py`` (``flash_attention_fwd_cuda``, the
  port of the Pallas ``_flash_kernel``; ``flash_attention_bwd_dq_cuda`` and
  ``flash_attention_bwd_dkv_cuda``, the ports of ``_flash_bwd_dq_kernel``
  and ``_flash_bwd_dkv_kernel``) for tensors on the card;
- the plain dense versions in float32 (``flash_attention_reference``,
  ``flash_attention_bwd_dq_reference``, ``flash_attention_bwd_dkv_reference``)
  for tensors on the CPU and as the kernels' yardsticks on the card.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def _pack(x: torch.Tensor, tp: int) -> torch.Tensor:
    """[B, T, H, D] -> contiguous [B*H, Tp, D] with right-padding."""
    b, t, h, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b * h, t, d)
    if tp != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, tp - t))
    return x.contiguous()


def _unpack(x: torch.Tensor, shape) -> torch.Tensor:
    b, t, h, d = shape
    return x[:, :t].reshape(b, h, t, d).permute(0, 2, 1, 3)


def _padded_t(t: int, block_q: int, block_k: int) -> int:
    # The padded length is a multiple of BOTH block sizes, as in the JAX
    # package (its grid and its in-kernel loop both index it).
    lcm = math.lcm(block_q, block_k)
    return -(-t // lcm) * lcm


def packed_len(t: int, block_q: int = 128, block_k: int = 128) -> int:
    """Tp, the padded sequence length ``flash_attention`` packs T into,
    after the JAX package's block clamping (each block at most T but at
    least 8, rounded up to a multiple of 8)."""
    def clamp(block):
        return max(8, -(-min(block, max(8, t)) // 8) * 8)
    return _padded_t(t, clamp(block_q), clamp(block_k))


def _masked_logits(q: torch.Tensor, k: torch.Tensor, true_t: int) -> torch.Tensor:
    """float32 ``q . k^T * D**-0.5`` with the key columns ``>= true_t`` at -1e30."""
    logits = torch.matmul(q, k.transpose(1, 2)) * q.shape[-1] ** -0.5
    kpos = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(kpos < true_t, logits, _NEG)


def flash_attention_reference(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                              true_t: int):
    """Plain version of the packed forward: [BH, Tp, D] q, k, v ->
    ``(o [BH, Tp, D] in q's dtype, lse [BH, Tp, 1] f32)``, computed densely
    in float32 with the key columns ``>= true_t`` set to -1e30."""
    logits = _masked_logits(qp.float(), kp.float(), true_t)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p, vp.float()) / l_safe
    return o.to(qp.dtype), m + torch.log(l_safe)


def _probs_and_dlogits(qp, kp, vp, do, lse, delta, true_t):
    """float32 ``p = exp(s - lse)`` and ``ds = p * (dO . V^T - delta)``
    over the whole [BH, Tp, Tp] grid, as the Pallas backward bodies form
    them tile by tile."""
    p = torch.exp(_masked_logits(qp.float(), kp.float(), true_t) - lse)
    ds = p * (torch.matmul(do.float(), vp.float().transpose(1, 2)) - delta)
    return p, ds


def flash_attention_bwd_dq_reference(qp, kp, vp, do, lse, delta, true_t: int):
    """Plain version of the dq kernel: [BH, Tp, D] q, k, v, dO, [BH, Tp, 1]
    f32 lse and delta -> ``dq = ds . K * scale`` in q's dtype, computed
    densely in float32 from the saved ``lse`` and ``delta``."""
    _, ds = _probs_and_dlogits(qp, kp, vp, do, lse, delta, true_t)
    scale = qp.shape[-1] ** -0.5
    return (torch.matmul(ds, kp.float()) * scale).to(qp.dtype)


def flash_attention_bwd_dkv_reference(qp, kp, vp, do, lse, delta, true_t: int):
    """Plain version of the dk/dv kernel: the same inputs ->
    ``(dk = ds^T . Q * scale, dv = p^T . dO)`` in k's and v's dtypes,
    computed densely in float32. Keys ``>= true_t`` get exact zeros."""
    p, ds = _probs_and_dlogits(qp, kp, vp, do, lse, delta, true_t)
    scale = qp.shape[-1] ** -0.5
    dk = torch.matmul(ds.transpose(1, 2), qp.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), do.float())
    return dk.to(kp.dtype), dv.to(vp.dtype)


def flash_attention_bwd_reference(qp, kp, vp, do, lse, delta, true_t: int):
    """Both plain backward versions: ``(dq, dk, dv)``."""
    dq = flash_attention_bwd_dq_reference(qp, kp, vp, do, lse, delta, true_t)
    return (dq,) + flash_attention_bwd_dkv_reference(qp, kp, vp, do, lse, delta, true_t)


def flash_attention_fwd(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, true_t: int):
    """Packed forward ``(o, lse)``: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    if qp.device.type == "cuda":
        from ..kernels.flash import flash_attention_fwd_cuda

        return flash_attention_fwd_cuda(qp, kp, vp, true_t)
    if qp.device.type == "cpu":
        return flash_attention_reference(qp, kp, vp, true_t)
    raise ValueError(f"flash_attention_fwd: unsupported device {qp.device}")


def flash_attention_bwd(qp, kp, vp, do, lse, delta, true_t: int):
    """Packed backward ``(dq, dk, dv)`` from the forward's ``lse`` and
    ``delta = rowsum(dO * O)``: the two CUDA kernels for tensors on the
    card, the plain versions for tensors on the CPU. ``do`` and ``delta``
    are zero on the padded query rows (``>= true_t``), as the autograd
    backward makes them."""
    if qp.device.type == "cuda":
        from ..kernels.flash import flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda

        dq = flash_attention_bwd_dq_cuda(qp, kp, vp, do, lse, delta, true_t)
        return (dq,) + flash_attention_bwd_dkv_cuda(qp, kp, vp, do, lse, delta, true_t)
    if qp.device.type == "cpu":
        return flash_attention_bwd_reference(qp, kp, vp, do, lse, delta, true_t)
    raise ValueError(f"flash_attention_bwd: unsupported device {qp.device}")


# The packed passes FlashAttention runs: (forward, backward).
KERNELS = (flash_attention_fwd, flash_attention_bwd)
PLAIN = (flash_attention_reference, flash_attention_bwd_reference)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward (the twin of the JAX ``_flash``
    custom VJP): ``apply(q, k, v, block_q, block_k, passes=KERNELS)`` over
    [B, T, H, D]. ``passes`` is the pair of packed passes to run; ``PLAIN``
    swaps the plain versions in on any device, as a yardstick."""

    @staticmethod
    def forward(ctx, q, k, v, block_q=128, block_k=128, passes=KERNELS):
        t = q.shape[1]
        tp = packed_len(t, block_q, block_k)
        qp, kp, vp = _pack(q, tp), _pack(k, tp), _pack(v, tp)
        o, lse = passes[0](qp, kp, vp, t)
        ctx.save_for_backward(qp, kp, vp, o, lse)
        ctx.shape, ctx.bwd = q.shape, passes[1]
        return _unpack(o, q.shape)

    @staticmethod
    def backward(ctx, g):
        qp, kp, vp, o, lse = ctx.saved_tensors
        shape = ctx.shape
        do = _pack(g, qp.shape[1])
        # delta = rowsum(dO * O), zero on the padded rows (dO is zero
        # there), so padded queries contribute nothing to dk/dv.
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq, dk, dv = ctx.bwd(qp, kp, vp, do, lse, delta, shape[1])
        return _unpack(dq, shape), _unpack(dk, shape), _unpack(dv, shape), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Exact softmax attention, [B, T, H, D] -> [B, T, H, D], differentiable.

    Arbitrary T: right-padded to the block grid (``block_q``/``block_k``
    clamped as in the JAX package) and masked in the kernel. The CUDA
    kernels tile the sequence their own way; the blocks fix only the
    padded length, so their outputs line up with the Pallas kernels'."""
    return FlashAttention.apply(q, k, v, block_q, block_k)
