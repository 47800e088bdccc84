"""Exact softmax attention without a [T, T] array in device memory
(counterpart of the forward of ``video_edge_ai_proxy_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v)`` takes and returns ``[B, T, H, D]`` (non-causal,
scale ``D**-0.5``), like ``models/transformer.py`` ``default_attention``,
and is its drop-in ``attn_fn`` for long sequences. It packs the heads into
``[B*H, Tp, D]`` with right padding to the block grid and masks the padded
keys, exactly as the JAX package does, then runs one of two
implementations of the packed forward with identical outputs ``(o, lse)``:

- the CUDA kernel ``kernels/flash.py`` ``flash_attention_fwd_cuda`` (the
  port of the Pallas ``_flash_kernel``), for tensors on the card;
- ``flash_attention_reference``, the plain dense version in float32, for
  tensors on the CPU and as the kernel's yardstick on the card.

``flash_attention_fwd`` picks between them by the tensors' device only.
The backward kernels (training) are not part of this module yet.
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


def flash_attention_reference(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                              true_t: int):
    """Plain version of the packed forward: [BH, Tp, D] q, k, v ->
    ``(o [BH, Tp, D] in q's dtype, lse [BH, Tp, 1] f32)``, computed densely
    in float32 with the key columns ``>= true_t`` set to -1e30."""
    q, k, v = qp.float(), kp.float(), vp.float()
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(1, 2)) * scale
    kpos = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(kpos < true_t, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p, v) / l_safe
    return o.to(qp.dtype), m + torch.log(l_safe)


def flash_attention_fwd(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, true_t: int):
    """Packed forward ``(o, lse)``: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    if qp.device.type == "cuda":
        from ..kernels.flash import flash_attention_fwd_cuda

        return flash_attention_fwd_cuda(qp, kp, vp, true_t)
    if qp.device.type == "cpu":
        return flash_attention_reference(qp, kp, vp, true_t)
    raise ValueError(f"flash_attention_fwd: unsupported device {qp.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Exact softmax attention, [B, T, H, D] -> [B, T, H, D].

    Arbitrary T: right-padded to the block grid (``block_q``/``block_k``
    clamped as in the JAX package) and masked in the kernel. The CUDA
    kernel tiles the sequence its own way; the blocks fix only the padded
    length, so its outputs line up with the Pallas kernel's."""
    t = q.shape[1]
    tp = packed_len(t, block_q, block_k)
    o, _ = flash_attention_fwd(_pack(q, tp), _pack(k, tp), _pack(v, tp), t)
    return _unpack(o, q.shape)
