"""Launch wrappers of the CUDA flash-attention kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu`` and, for
bf16, ``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_dq_sm90.cu`` and
``csrc/flash_attention_bwd_dkv_sm90.cu``).

On packed ``[BH, Tp, D]`` tensors, each the card's counterpart of one
Pallas kernel of the JAX package:

- ``flash_attention_fwd_cuda(qp, kp, vp, true_t) -> (o, lse)``:
  ``_flash_kernel`` (``_flash_call``); ``o`` in the input dtype, ``lse``
  ``[BH, Tp, 1]`` float32; bf16 on the tensor cores, float32 on the CUDA
  cores;
- ``flash_attention_bwd_dq_cuda(qp, kp, vp, do, lse, delta, true_t) -> dq``:
  ``_flash_bwd_dq_kernel`` (the first ``pallas_call`` of ``_flash_bwd_call``);
- ``flash_attention_bwd_dkv_cuda(...) -> (dk, dv)``: ``_flash_bwd_dkv_kernel``
  (the second); both bf16 on the tensor cores, float32 on the CUDA cores.

Their plain PyTorch versions are ``ops.flash_attention``
``flash_attention_reference``, ``flash_attention_bwd_dq_reference`` and
``flash_attention_bwd_dkv_reference``. Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64)       # the head dims the sources instantiate
MAX_BH = 65535                 # gridDim.y of the launches

_bound = {}


def _launcher(lib: str, fn_name: str, n_ptrs: int):
    fn = _bound.get(fn_name)
    if fn is None:
        fn = getattr(build.load(lib), fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[fn_name] = fn
    return fn


def _check(name: str, qkv, rows, true_t: int):
    """Raise on packed q, k, v (and dO) the kernels do not take: not CUDA,
    not one device, dtype, shape, head dim, BH, true_t, contiguity; and on
    per-row ``rows`` (lse, delta) that are not f32 ``[BH, Tp, 1]``."""
    qp = qkv[0]
    for x in qkv + rows:
        if x.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
        if x.device != qp.device:
            raise ValueError(f"{name} needs all its tensors on one device")
    if qp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bfloat16 or float32, got {qp.dtype}")
    if any(x.dtype != qp.dtype for x in qkv):
        raise TypeError(f"{name} needs q, k, v{', dO' if len(qkv) > 3 else ''} of one dtype")
    if qp.ndim != 3 or any(x.shape != qp.shape for x in qkv):
        raise ValueError(f"{name} needs equal [BH, Tp, D] shapes, got "
                         f"{', '.join(str(tuple(x.shape)) for x in qkv)}")
    bh, tp, d = qp.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS}, got {d}")
    if not 1 <= bh <= MAX_BH:
        raise ValueError(f"{name} takes 1 <= BH <= {MAX_BH}, got {bh}")
    if not 1 <= true_t <= tp:
        raise ValueError(f"{name} needs 1 <= true_t <= Tp = {tp}, got {true_t}")
    for x in rows:
        if x.dtype != torch.float32 or x.shape != (bh, tp, 1):
            raise ValueError(f"{name} needs lse and delta as float32 [BH, Tp, 1] = "
                             f"{(bh, tp, 1)}, got {x.dtype} {tuple(x.shape)}")
    if not all(x.is_contiguous() for x in qkv + rows):
        raise ValueError(f"{name} needs contiguous q, k, v"
                         f"{', dO, lse, delta' if rows else ''}")


def _check_aligned(name: str, tensors) -> None:
    """Raise on bf16 inputs the tensor-core kernels cannot copy in 16-byte
    chunks: a view that does not start on a 16-byte boundary."""
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{name} needs 16-byte aligned bf16 inputs (the tensor-core "
                         "kernels copy their tiles in 16-byte chunks)")


def _launch(fn, name: str, tensors, qp: torch.Tensor, true_t: int) -> None:
    bh, tp, d = qp.shape
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        err = fn(*(x.data_ptr() for x in tensors), bh, tp, d, int(true_t),
                 int(qp.dtype == torch.bfloat16), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_attention_fwd_cuda(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                             true_t: int):
    """Packed q, k, v ``[BH, Tp, D]`` (bf16 or f32, contiguous, on one CUDA
    device) -> ``(o [BH, Tp, D] in their dtype, lse [BH, Tp, 1] f32)``;
    keys ``>= true_t`` are masked. Raises on what the kernel does not take.

    The dtype picks the kernel, and nothing else does: bf16 launches
    ``flash_fwd_kernel_wgmma`` (``csrc/flash_attention_fwd_sm90.cu``, wgmma
    on the tensor cores, with p split into two bf16 halves for P . V so the
    result keeps float32 accuracy); float32 launches ``flash_fwd_kernel``
    (``csrc/flash_attention_fwd.cu``), which keeps exact float32 arithmetic
    on the CUDA cores and is the route of the float32 checks against the
    CPU. A failed build or launch raises; no route stands in for the
    other."""
    _check("flash_attention_fwd_cuda", (qp, kp, vp), (), true_t)
    if qp.dtype == torch.bfloat16:
        _check_aligned("flash_attention_fwd_cuda", (qp, kp, vp))
        fn = _launcher("flash_attention_fwd_sm90", "flash_attention_fwd_sm90_launch", 5)
    else:
        fn = _launcher("flash_attention_fwd", "flash_attention_fwd_launch", 5)
    o = torch.empty_like(qp)
    lse = torch.empty((qp.shape[0], qp.shape[1], 1), dtype=torch.float32, device=qp.device)
    _launch(fn, "flash_attention_fwd", (qp, kp, vp, o, lse), qp, true_t)
    flash_attention_fwd_cuda.launches += 1
    return o, lse


def flash_attention_bwd_dq_cuda(qp, kp, vp, do, lse, delta, true_t: int) -> torch.Tensor:
    """Packed q, k, v, dO ``[BH, Tp, D]`` (bf16 or f32, one dtype) and the
    forward's ``lse`` with ``delta = rowsum(dO * O)`` (f32 ``[BH, Tp, 1]``)
    -> ``dq`` in their dtype. Keys ``>= true_t`` are masked; query rows
    ``>= true_t`` are computed like the others.

    The dtype picks the kernel, and nothing else does: bf16 launches
    ``flash_bwd_dq_kernel_wgmma`` (``csrc/flash_attention_bwd_dq_sm90.cu``,
    wgmma on the tensor cores, with ds split into two bf16 halves so the
    result keeps float32 accuracy); float32 launches ``flash_bwd_dq_kernel``
    (``csrc/flash_attention_bwd.cu``), which keeps exact float32 arithmetic
    on the CUDA cores and is the route of the float32 gradient checks
    against the CPU. A failed build or launch raises; no route stands in
    for the other."""
    _check("flash_attention_bwd_dq_cuda", (qp, kp, vp, do), (lse, delta), true_t)
    if qp.dtype == torch.bfloat16:
        _check_aligned("flash_attention_bwd_dq_cuda", (qp, kp, vp, do))
        fn = _launcher("flash_attention_bwd_dq_sm90", "flash_attention_bwd_dq_sm90_launch", 7)
    else:
        fn = _launcher("flash_attention_bwd", "flash_attention_bwd_dq_launch", 7)
    dq = torch.empty_like(qp)
    _launch(fn, "flash_attention_bwd_dq", (qp, kp, vp, do, lse, delta, dq), qp, true_t)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


def flash_attention_bwd_dkv_cuda(qp, kp, vp, do, lse, delta, true_t: int):
    """The same inputs -> ``(dk, dv)`` in their dtype; key rows ``>= true_t``
    are written as zeros, and query rows ``>= true_t`` are skipped, which is
    exact because ``dO`` and ``delta`` are zero there.

    The dtype picks the kernel, and nothing else does: bf16 launches
    ``flash_bwd_dkv_kernel_wgmma`` (``csrc/flash_attention_bwd_dkv_sm90.cu``,
    wgmma on the tensor cores, with p and ds split into two bf16 halves so
    the result keeps float32 accuracy); float32 launches
    ``flash_bwd_dkv_kernel`` (``csrc/flash_attention_bwd.cu``), which keeps
    exact float32 arithmetic on the CUDA cores and is the route of the
    float32 gradient checks against the CPU. A failed build or launch
    raises; no route stands in for the other."""
    _check("flash_attention_bwd_dkv_cuda", (qp, kp, vp, do), (lse, delta), true_t)
    if qp.dtype == torch.bfloat16:
        _check_aligned("flash_attention_bwd_dkv_cuda", (qp, kp, vp, do))
        fn = _launcher("flash_attention_bwd_dkv_sm90", "flash_attention_bwd_dkv_sm90_launch", 8)
    else:
        fn = _launcher("flash_attention_bwd", "flash_attention_bwd_dkv_launch", 8)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    _launch(fn, "flash_attention_bwd_dkv", (qp, kp, vp, do, lse, delta, dk, dv), qp, true_t)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_fwd_cuda.launches = 0
flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0
