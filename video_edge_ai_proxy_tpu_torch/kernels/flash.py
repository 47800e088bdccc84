"""Launch wrapper of the CUDA flash-attention forward kernel (``csrc/flash_attention_fwd.cu``).

``flash_attention_fwd_cuda(qp, kp, vp, true_t) -> (o, lse)`` is the card's
counterpart of the JAX package's ``_flash_call`` (the Pallas
``_flash_kernel``) on packed ``[BH, Tp, D]`` tensors: ``o`` in the input
dtype, ``lse`` ``[BH, Tp, 1]`` float32. Its plain PyTorch version is
``ops.flash_attention.flash_attention_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64)       # the head dims the source instantiates
MAX_BH = 65535                 # gridDim.y of the launch

_bound = {}


def _launcher():
    fn = _bound.get("fn")
    if fn is None:
        fn = build.load("flash_attention_fwd").flash_attention_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound["fn"] = fn
    return fn


def flash_attention_fwd_cuda(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                             true_t: int):
    """Packed q, k, v ``[BH, Tp, D]`` (bf16 or f32, contiguous, on one CUDA
    device) -> ``(o [BH, Tp, D] in their dtype, lse [BH, Tp, 1] f32)``;
    keys ``>= true_t`` are masked. Raises on what the kernel does not take."""
    for x in (qp, kp, vp):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_fwd_cuda needs CUDA tensors, got {x.device}")
    if not (qp.device == kp.device == vp.device):
        raise ValueError("flash_attention_fwd_cuda needs q, k, v on one device")
    if qp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_fwd_cuda takes bfloat16 or float32, got {qp.dtype}")
    if not (qp.dtype == kp.dtype == vp.dtype):
        raise TypeError("flash_attention_fwd_cuda needs q, k, v of one dtype")
    if qp.ndim != 3 or not (qp.shape == kp.shape == vp.shape):
        raise ValueError(f"flash_attention_fwd_cuda needs equal [BH, Tp, D] shapes, got "
                         f"{tuple(qp.shape)}, {tuple(kp.shape)}, {tuple(vp.shape)}")
    bh, tp, d = qp.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd_cuda takes head dims {HEAD_DIMS}, got {d}")
    if not 1 <= bh <= MAX_BH:
        raise ValueError(f"flash_attention_fwd_cuda takes 1 <= BH <= {MAX_BH}, got {bh}")
    if not 1 <= true_t <= tp:
        raise ValueError(f"flash_attention_fwd_cuda needs 1 <= true_t <= Tp = {tp}, "
                         f"got {true_t}")
    if not (qp.is_contiguous() and kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("flash_attention_fwd_cuda needs contiguous q, k, v")
    o = torch.empty_like(qp)
    lse = torch.empty((bh, tp, 1), dtype=torch.float32, device=qp.device)
    fn = _launcher()
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 bh, tp, d, int(true_t), int(qp.dtype == torch.bfloat16), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    flash_attention_fwd_cuda.launches += 1
    return o, lse


flash_attention_fwd_cuda.launches = 0
