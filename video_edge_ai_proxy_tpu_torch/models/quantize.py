"""int8 serving (counterpart of ``video_edge_ai_proxy_tpu/models/quantize.py``).

Post-training, weight-only, symmetric int8 on the port's ``state_dict``:

- every leaf with ndim >= 2 and at least 1024 elements (conv and linear
  weights, embeddings) is stored as int8 with a float32 scale per output
  channel (max-abs / 127): axis 0 of a ``*.weight`` (OIHW, [out, in]),
  the last axis of anything else (``pos_embed``), the axes JAX's HWIO and
  [in, out] kernels keep last, so the int8 values and scales equal JAX's;
- smaller and 1-D leaves (biases, BatchNorm terms, ``in_absmax``) stay
  exact;
- ``QuantizedModel`` serves from it: the device holds the int8 leaves and
  their scales, and every call dequantizes them (``int8 * scale`` into the
  leaf's own dtype) before the forward, so on the card the dequantization
  is part of the step's captured CUDA graph. An ``Int8Conv2d`` kernel is
  not dequantized: the conv takes the int8 leaf and its scale as they are.

``calibrate_serving`` is the int8 activation path's calibration (the
engine's ``quantize="int8_act"``): it runs frame batches through the fp
forward of a model built with ``act_int8`` and records each
``Int8Conv2d``'s input max-abs; the outputs are the fp model's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping

import torch
from torch import nn

from .common import Int8Conv2d


@dataclass
class QuantizedTree:
    """A state split into int8 payloads and their scales: ``q`` holds the
    int8 leaves and, verbatim, the leaves left exact; ``scale`` the float32
    per-channel scales, an empty tensor marking a leaf left exact;
    ``dtype`` each quantized leaf's dtype before quantization (what
    ``dequantize_tree`` returns)."""

    q: Dict[str, torch.Tensor]
    scale: Dict[str, torch.Tensor]
    dtype: Dict[str, torch.dtype]


def serving_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters and buffers as the JAX package's variables
    hold them: without BatchNorm's ``num_batches_tracked`` counters."""
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _out_axis(name: str, w: torch.Tensor) -> int:
    return 0 if name.endswith(".weight") else w.ndim - 1


def _quantize_leaf(w: torch.Tensor, axis: int) -> tuple:
    """-> (int8 like ``w``, float32 scale [w.shape[axis]])."""
    wf = w.float()
    absmax = wf.abs().amax(dim=tuple(d for d in range(w.ndim) if d != axis))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    shape = [1] * w.ndim
    shape[axis] = -1
    q = torch.clamp(torch.round(wf / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def _should_quantize(w: torch.Tensor) -> bool:
    return w.ndim >= 2 and w.numel() >= 1024


def quantize_tree(state: Mapping[str, torch.Tensor]) -> QuantizedTree:
    """Quantize every kernel-shaped leaf of ``state`` (see the module
    docstring); leave the rest untouched."""
    q, scale, dtype = {}, {}, {}
    for name, w in state.items():
        if _should_quantize(w):
            q[name], scale[name] = _quantize_leaf(w, _out_axis(name, w))
            dtype[name] = w.dtype
        else:
            q[name] = w
            scale[name] = torch.zeros((0,), dtype=torch.float32, device=w.device)
    return QuantizedTree(q, scale, dtype)


def dequantize_tree(qt: QuantizedTree) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_tree``: ``float32(int8) * scale`` in each
    quantized leaf's dtype; the exact leaves as they are."""
    out = {}
    for name, q in qt.q.items():
        s = qt.scale[name]
        if name in qt.dtype:
            shape = [1] * q.ndim
            shape[_out_axis(name, q)] = -1
            out[name] = (q.float() * s.reshape(shape)).to(qt.dtype[name])
        else:
            out[name] = q
    return out


def quantized_nbytes(qt: QuantizedTree) -> int:
    return (sum(t.numel() * t.element_size() for t in qt.q.values())
            + sum(t.numel() * t.element_size() for t in qt.scale.values()))


def tree_nbytes(state: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


class QuantizedModel(nn.Module):
    """``model`` served from a ``QuantizedTree``: each call dequantizes the
    int8 leaves and runs ``model`` with them (``torch.func.functional_call``).
    ``quantize_model`` builds one and releases the model's own copies of
    the quantized leaves (zero-size placeholders of the same dtype), so the
    device holds the int8 leaves and their scales only."""

    def __init__(self, model: nn.Module, qt: QuantizedTree):
        super().__init__()
        self.model = model
        self.qt = qt
        # The int8 convs' kernels, served as stored: weight -> weight_scale.
        self.int8_kernels = {
            name: name[:-len("weight")] + "weight_scale" for name in qt.dtype
            if name.endswith(".weight")
            and isinstance(model.get_submodule(name.rpartition(".")[0]), Int8Conv2d)}

    @property
    def cfg(self):
        return self.model.cfg

    def forward(self, *args, **kwargs):
        qt = self.qt
        leaves = dequantize_tree(QuantizedTree(
            {n: q for n, q in qt.q.items() if n not in self.int8_kernels}, qt.scale, qt.dtype))
        for name, scale_name in self.int8_kernels.items():
            leaves[name] = qt.q[name]
            leaves[scale_name] = qt.scale[name]
        return torch.func.functional_call(self.model, leaves, args, kwargs)


def quantize_model(model: nn.Module) -> QuantizedModel:
    """``model`` (on its device, already calibrated where it has
    ``Int8Conv2d``) -> a ``QuantizedModel`` holding its int8 state."""
    qt = quantize_tree(serving_state(model))
    with torch.no_grad():
        for name, dtype in qt.dtype.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            old = getattr(owner, leaf)
            empty = torch.empty((0,), dtype=dtype, device=old.device)
            if leaf in owner._parameters:
                owner._parameters[leaf] = nn.Parameter(empty, requires_grad=False)
            else:
                owner._buffers[leaf] = empty
    return QuantizedModel(model, qt)


def calibrate_serving(model: nn.Module, spec, frame_batches: Iterable[torch.Tensor], *,
                      preprocess_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Record the input max-abs of every ``Int8Conv2d`` of ``model`` over
    ``frame_batches`` (uint8 [B, H, W, 3] on the model's device), each run
    through the serving letterbox (``preprocess_dtype``, bf16 as in JAX)
    and the fp forward. The ranges start from 0. Detect family only."""
    from ..ops.preprocess import preprocess_letterbox

    if spec.kind != "detect":
        raise ValueError(f"int8 activation calibration is detect-family only; "
                         f"{spec.name!r} is kind={spec.kind!r}")
    convs = [m for m in model.modules() if isinstance(m, Int8Conv2d)]
    seen = 0
    with torch.no_grad():
        for conv in convs:
            conv.in_absmax.zero_()
            conv.calibrating = True
        try:
            for frames in frame_batches:
                x, _ = preprocess_letterbox(frames, spec.input_size, out_dtype=preprocess_dtype)
                model(x.permute(0, 3, 1, 2), decode="serving")
                seen += 1
        finally:
            for conv in convs:
                conv.calibrating = False
    if not seen:
        raise ValueError("calibration needs at least one frame batch")
    return model
