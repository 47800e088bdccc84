"""Hand-written CUDA kernels of the port and their launch wrappers.

Each wrapper takes CUDA tensors only, checks them, launches its kernel on
PyTorch's current stream and counts the launch in its ``launches``
attribute. A launch captured into a CUDA graph runs at each replay, not
at capture: the engine's graphed step takes the capture's counts back
and adds them at every replay. The plain PyTorch version of each kernel lives beside its
caller in ``ops/``.
"""


def launch_counters() -> tuple:
    """Every kernel wrapper, each carrying its ``launches`` count."""
    from .flash import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda, flash_attention_fwd_cuda,
    )
    from .nms import nms_keep_mask_cuda

    return (nms_keep_mask_cuda, flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
            flash_attention_bwd_dkv_cuda)
