"""Weights carried across from the JAX package.

``from_flax(variables)`` turns a flax ``{"params", "batch_stats"}`` tree of
the JAX package's YOLOv8, ResNet, MobileNetV2, ViT, VideoMAE or blob gauge
(leaves as numpy arrays; the transformers' ``nn.Partitioned`` boxes
unboxed by the caller) into this port's ``state_dict``. The port's
submodules carry the flax scope names, so the mapping is mechanical, by
the leaf and the module that holds it:

- conv ``kernel`` -> ``weight``: HWIO -> OIHW (``conv``, ``*_out``,
  ``patch_embed``; a depthwise kernel [k, k, 1, C] -> [C, 1, k, k]), or
  [ts, p, p, C, D] -> [D, C, ts, p, p] for the tubelet Conv3d (``proj``)
- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in] (``qkv``,
  ``out``, ``fc1``, ``fc2``, ``head``, ``classifier``, and the VideoMAE
  decoder's ``dec_embed``, ``dec_pred``)
- BatchNorm/LayerNorm ``scale|bias`` -> ``weight|bias`` (``bn``, ``ln1``,
  ``ln2``, ``ln_final``); other ``bias`` leaves carry over
- ``batch_stats <scope>/bn/mean|var`` -> ``<scope>.bn.running_mean|running_var``
- top-level ``pos_embed``, ``cls_token``, ``dec_pos`` and the blob gauge's
  dummy ``bias`` carry over unchanged
- ``quant <scope>/conv/in_absmax`` (the int8 activation path's calibrated
  input range) -> ``<scope>.conv.in_absmax``

``from_flax_pretrain`` maps the JAX VideoMAE pretraining tree
(``{"encoder": variables, "decoder": variables}``, as
``masked_pretrain_loss`` takes it) half by half onto
``videomae.VideoMAEPretrain``'s ``encoder.*`` and ``decoder.*``.

A leaf or collection it does not know raises; ``load_flax`` loads the
result strictly, so a key missing from either side raises too. The stem
kernel keeps its padded input channels (``stem_pad_c``), as in JAX.

``fit_state(state, model)`` fits a YOLOv8 ``state_dict`` to a model of
another variant, as the JAX package's checkpoint loader does: a classic
3x3 stem kernel folds losslessly into an ``s2d`` model's 2x2 kernel
(``s2d_fold_kernel``, after slicing off zero-padded input planes), and
the ``in_absmax`` buffers an ``act_int8`` model has and an fp state
lacks come from the model (uncalibrated). ``load_flax`` applies it, so
a classic JAX tree loads into an ``s2d`` model and an ``s2d`` tree
straight across.
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
_TOKENS = {"pos_embed", "cls_token", "dec_pos", "bias"}
_STAT_LEAVES = {
    ("bn", "mean"): "bn.running_mean",
    ("bn", "var"): "bn.running_var",
}
# Axis orders from a flax kernel to a torch weight, by the kernel's rank.
_CONV_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def s2d_fold_kernel(k: np.ndarray) -> np.ndarray:
    """A stride-2 3x3 stem kernel [3, 3, ci, co] (HWIO) -> the stride-1
    2x2 kernel [2, 2, 4*ci, co] computing the same function on the
    ``space_to_depth`` plane with ((1, 0), (1, 0)) padding.

    Classic tap ``di`` reads input row ``2p - 1 + di``, which the s2d plane
    stores at (row, offset) ``(p - 1, 1)`` for di = 0 and ``(p, di - 1)``
    otherwise; the 2x2 conv reads s2d rows ``p - 1 + u``, so tap di lands
    at ``(u, a) = (0, 1)`` or ``(1, di - 1)``; columns alike. Channel slot
    ``(2a + b) * ci + c``. The slots the classic conv never reads stay
    zero: the same products, summed in another order."""
    kh, kw, ci, co = np.shape(k)
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d fold expects a 3x3 kernel, got {np.shape(k)}")
    k = np.asarray(k)
    out = np.zeros((2, 2, 4 * ci, co), k.dtype)
    for di in range(3):
        u, a = (0, 1) if di == 0 else (1, di - 1)
        for dj in range(3):
            v, b = (0, 1) if dj == 0 else (1, dj - 1)
            s = (2 * a + b) * ci
            out[u, v, s:s + ci] = k[di, dj]
    return out


def fit_state(state: Mapping[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """``state`` fitted to ``model``'s variant (see the module docstring):
    the stem folded into an ``s2d`` model, missing ``in_absmax`` buffers
    taken from the model. Anything else is left for a strict load to
    judge."""
    out = dict(state)
    target = model.state_dict()
    key = "stem.conv.weight"
    have, want = out.get(key), target.get(key)
    cfg = getattr(model, "cfg", None)
    if (getattr(cfg, "stem", "classic") == "s2d" and have is not None and want is not None
            and tuple(have.shape[2:]) == (3, 3) and tuple(want.shape[2:]) == (2, 2)
            and want.shape[1] % 4 == 0 and have.shape[1] >= want.shape[1] // 4):
        hwio = have.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
        folded = s2d_fold_kernel(hwio[:, :, :want.shape[1] // 4])
        out[key] = torch.tensor(folded.transpose(3, 2, 0, 1))
    for name, value in target.items():
        if name.endswith(".in_absmax") and name not in out:
            out[name] = value
    return out


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
    extra = set(variables) - {"params", "batch_stats", "quant"}
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
    for path, value in _flatten(variables.get("quant", {})):
        if path[-2:] != ("conv", "in_absmax"):
            raise KeyError(f"unmapped flax quant leaf {'/'.join(path)}")
        out[".".join(path)] = _tensor(value)
    for scope in bn_scopes:
        out[".".join(scope + ("bn.num_batches_tracked",))] = torch.tensor(0)
    return out


def load_flax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load flax variables into ``model``, fitted to its variant
    (``fit_state``), strictly: a key missing from either side, or a shape
    mismatch, raises."""
    model.load_state_dict(fit_state(from_flax(variables), model), strict=True)
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
