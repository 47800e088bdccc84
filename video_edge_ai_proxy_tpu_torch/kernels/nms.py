"""Launch wrapper of the CUDA NMS keep-mask kernel (``csrc/nms_keep_mask.cu``).

``nms_keep_mask_cuda(boxes [B, K, 4] f32 cuda, t) -> keep [B, K] bool`` is
the card's counterpart of ``nms_keep_mask_pallas`` in the JAX package, run
for the whole batch in one launch (a thread-block cluster per image) where
the Pallas kernel is vmapped one image at a time. Its plain PyTorch version
is ``ops.nms.nms_keep_mask_reference``. A failed launch, a refused cluster
launch included, raises: there is no launch without clusters.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_K = 1024       # kMaxK in the source: an image's bits fit one CTA's shared memory

_bound = {}


def _launcher():
    fn = _bound.get("fn")
    if fn is None:
        fn = build.load("nms_keep_mask").nms_keep_mask_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound["fn"] = fn
    return fn


def launch_config(k: int) -> dict:
    """How the kernel launches at ``k`` candidates, from the built library:
    ``cluster`` CTAs per image, each with ``smem_bytes`` of dynamic shared
    memory."""
    lib = build.load("nms_keep_mask")
    lib.nms_keep_mask_smem_bytes.argtypes = [ctypes.c_int]
    lib.nms_keep_mask_smem_bytes.restype = ctypes.c_size_t
    return {"cluster": int(lib.nms_keep_mask_cluster_size()),
            "smem_bytes": int(lib.nms_keep_mask_smem_bytes(k))}


def nms_keep_mask_cuda(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """[B, K, 4] f32 score-sorted xyxy boxes on a CUDA device -> [B, K]
    bool keep mask. Raises on a tensor the kernel does not take."""
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_mask_cuda needs a CUDA tensor, got "
                         f"{boxes.device}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms_keep_mask_cuda needs float32 boxes, got "
                        f"{boxes.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_keep_mask_cuda needs [B, K, 4] boxes, got "
                         f"{tuple(boxes.shape)}")
    if not boxes.is_contiguous():
        raise ValueError("nms_keep_mask_cuda needs contiguous boxes")
    b, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"nms_keep_mask_cuda takes K <= {MAX_K}, got {k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    fn = _launcher()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(boxes.data_ptr(), keep.data_ptr(), b, k,
                 float(iou_thresh), stream)
    if err != 0:
        raise RuntimeError(f"nms_keep_mask kernel launch failed: CUDA "
                           f"error {err}")
    nms_keep_mask_cuda.launches += 1
    return keep


nms_keep_mask_cuda.launches = 0
