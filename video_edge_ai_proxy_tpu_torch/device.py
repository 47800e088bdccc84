"""Device resolution for every entry point of the port.

The rule: an entry point runs on the card unless its caller asks for the
CPU. ``resolve_device("cuda")`` on a machine without a usable GPU raises;
it never carries on silently on the CPU.

Numerics on the card are set here and nowhere else: TF32 is OFF for both
cuDNN convolutions and cuBLAS matmuls, so every float32 op (the detect
head's 1x1 output convs, the DFL softmax, the quality statistics) runs in
full float32 as it does in the JAX package. bf16 work is unaffected.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Return the torch device for ``device``; raise if it is a CUDA
    device and no GPU is present. Only ``cpu`` and ``cuda[:n]`` are
    accepted."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        # Full-precision float32 on the card (no TF32).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
