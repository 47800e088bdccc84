"""Weights carried across from the JAX package.

``from_flax(variables)`` turns a flax ``{"params", "batch_stats"}`` tree of
the JAX package's YOLOv8, ViT or VideoMAE (leaves as numpy arrays; the
transformers' ``nn.Partitioned`` boxes unboxed by the caller) into this
port's ``state_dict``. The port's submodules carry the flax scope names,
so the mapping is mechanical, by the leaf and the module that holds it:

- conv ``kernel`` -> ``weight``: HWIO -> OIHW (``conv``, ``*_out``,
  ``patch_embed``), or [ts, p, p, C, D] -> [D, C, ts, p, p] for the
  tubelet Conv3d (``proj``)
- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in] (``qkv``,
  ``out``, ``fc1``, ``fc2``, ``head``, ``classifier``, and the VideoMAE
  decoder's ``dec_embed``, ``dec_pred``)
- BatchNorm/LayerNorm ``scale|bias`` -> ``weight|bias`` (``bn``, ``ln1``,
  ``ln2``, ``ln_final``); other ``bias`` leaves carry over
- ``batch_stats <scope>/bn/mean|var`` -> ``<scope>.bn.running_mean|running_var``
- top-level ``pos_embed``, ``cls_token`` and ``dec_pos`` carry over unchanged

``from_flax_pretrain`` maps the JAX VideoMAE pretraining tree
(``{"encoder": variables, "decoder": variables}``, as
``masked_pretrain_loss`` takes it) half by half onto
``videomae.VideoMAEPretrain``'s ``encoder.*`` and ``decoder.*``.

A leaf or collection it does not know raises; ``load_flax`` loads the
result strictly, so a key missing from either side raises too. The stem
kernel keeps its padded input channels (``stem_pad_c``), as in JAX.
``zero_class_prior`` (defined in ``replay/checksum.py``, where the JAX
package has it) is importable from here too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..replay.checksum import zero_class_prior  # noqa: F401  (re-exported)

_CONVS = {"conv", "patch_embed", "proj"}
_DENSES = {"qkv", "out", "fc1", "fc2", "head", "classifier", "dec_embed", "dec_pred"}
_NORMS = {"bn", "ln1", "ln2", "ln_final"}
_TOKENS = {"pos_embed", "cls_token", "dec_pos"}
_STAT_LEAVES = {
    ("bn", "mean"): "bn.running_mean",
    ("bn", "var"): "bn.running_var",
}
# Axis orders from a flax kernel to a torch weight, by the kernel's rank.
_CONV_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _tensor(value, axes=None) -> torch.Tensor:
    arr = np.asarray(value, dtype=np.float32)
    if axes is not None:
        arr = arr.transpose(axes)
    return torch.tensor(arr)          # a copy: the source may be read-only


def _param(path: tuple, value) -> tuple:
    """One flax param leaf -> (port name, tensor); raises ``KeyError`` on a
    leaf it does not map."""
    if len(path) == 1 and path[0] in _TOKENS:
        return path[0], _tensor(value)
    if len(path) >= 2:
        module, leaf = path[-2], path[-1]
        conv = module in _CONVS or module.endswith("_out")
        name = ".".join(path[:-1])
        if leaf == "kernel" and conv and np.ndim(value) in _CONV_AXES:
            return name + ".weight", _tensor(value, _CONV_AXES[np.ndim(value)])
        if leaf == "kernel" and module in _DENSES and np.ndim(value) == 2:
            return name + ".weight", _tensor(value, (1, 0))
        if leaf == "scale" and module in _NORMS:
            return name + ".weight", _tensor(value)
        if leaf == "bias" and (module in _NORMS | _DENSES | _CONVS - {"conv"}
                               or module.endswith("_out")):
            return name + ".bias", _tensor(value)
    raise KeyError(f"unmapped flax param {'/'.join(path)}")


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
        name, tensor = _param(path, value)
        out[name] = tensor
        if path[-2:-1] == ("bn",):
            bn_scopes.add(path[:-2])
    for path, value in _flatten(variables.get("batch_stats", {})):
        scope, tail = path[:-2], path[-2:]
        if tail not in _STAT_LEAVES:
            raise KeyError(f"unmapped flax batch stat {'/'.join(path)}")
        out[".".join(scope + (_STAT_LEAVES[tail],))] = _tensor(value)
    for scope in bn_scopes:
        out[".".join(scope + ("bn.num_batches_tracked",))] = torch.tensor(0)
    return out


def load_flax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load flax variables into ``model`` strictly: a key missing from
    either side, or a shape mismatch, raises."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def from_flax_pretrain(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX pretraining tree ``{"encoder": variables, "decoder": variables}``
    -> ``VideoMAEPretrain`` ``state_dict``. Raises ``KeyError`` on any other
    top-level key, collection or leaf."""
    if set(tree) != {"encoder", "decoder"}:
        raise KeyError(f"a pretraining tree has 'encoder' and 'decoder', got {sorted(tree)}")
    return {f"{half}.{name}": t for half in ("encoder", "decoder")
            for name, t in from_flax(tree[half]).items()}


def load_flax_pretrain(model: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX pretraining tree into ``VideoMAEPretrain`` strictly."""
    model.load_state_dict(from_flax_pretrain(tree), strict=True)
    return model
