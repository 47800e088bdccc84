"""Weights carried across from the JAX package.

``from_flax(variables)`` turns a flax ``{"params", "batch_stats"}`` tree of
the JAX package's YOLOv8 (leaves as numpy arrays) into this port's
``state_dict``. The port's submodules carry the flax scope names, so the
mapping is mechanical:

- ``<scope>/conv/kernel`` (HWIO) -> ``<scope>.conv.weight`` (OIHW)
- ``<scope>/bn/scale|bias`` -> ``<scope>.bn.weight|bias``
- ``batch_stats <scope>/bn/mean|var`` -> ``<scope>.bn.running_mean|running_var``
- ``<scope>_out/kernel|bias`` (head 1x1 convs) -> ``<scope>_out.weight|bias``

A leaf or collection it does not know raises; ``load_flax`` loads the
result strictly, so a key missing from either side raises too. The stem
kernel keeps its padded input channels (``stem_pad_c``), as in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {
    ("conv", "kernel"): "conv.weight",
    ("bn", "scale"): "bn.weight",
    ("bn", "bias"): "bn.bias",
}
_STAT_LEAVES = {
    ("bn", "mean"): "bn.running_mean",
    ("bn", "var"): "bn.running_var",
}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _tensor(value, transpose_conv: bool) -> torch.Tensor:
    arr = np.asarray(value, dtype=np.float32)
    if transpose_conv:
        arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    return torch.tensor(arr)          # a copy: the source may be read-only


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> port ``state_dict`` (float32,
    on the CPU). Raises ``KeyError`` on any collection or leaf it does not
    map."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected flax collections: {sorted(extra)}")
    out: Dict[str, torch.Tensor] = {}
    bn_scopes = set()
    for path, value in _flatten(variables.get("params", {})):
        scope, tail = path[:-2], path[-2:]
        if tail in _PARAM_LEAVES:
            name = ".".join(scope + (_PARAM_LEAVES[tail],))
            out[name] = _tensor(value, tail == ("conv", "kernel"))
            if tail[0] == "bn":
                bn_scopes.add(scope)
        elif path[-2].endswith("_out") and path[-1] in ("kernel", "bias"):
            name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else "bias",))
            out[name] = _tensor(value, path[-1] == "kernel")
        else:
            raise KeyError(f"unmapped flax param {'/'.join(path)}")
    for path, value in _flatten(variables.get("batch_stats", {})):
        scope, tail = path[:-2], path[-2:]
        if tail not in _STAT_LEAVES:
            raise KeyError(f"unmapped flax batch stat {'/'.join(path)}")
        out[".".join(scope + (_STAT_LEAVES[tail],))] = _tensor(value, False)
    for scope in bn_scopes:
        out[".".join(scope + ("bn.num_batches_tracked",))] = torch.tensor(0)
    return out


def load_flax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load flax variables into ``model`` strictly: a key missing from
    either side, or a shape mismatch, raises."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def zero_class_prior(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero the detection head's class-prior biases (the port of
    ``replay/checksum.py`` ``zero_class_prior``).

    The from-scratch prior (``cls{i}_out`` bias ~= -11.5) puts every
    random-init score near 1e-5, below the NMS score threshold, so a
    random-weight run would feed NMS empty candidate sets. With these
    biases at zero the scores sit near sigmoid(0) = 0.5 and NMS does real
    work. Nothing else changes."""
    def is_cls_out(name: str) -> bool:
        return any(p.startswith("cls") and p.endswith("_out") for p in name.split("."))

    return {
        name: torch.zeros_like(t) if is_cls_out(name) and t.ndim == 1 else t
        for name, t in state_dict.items()
    }
