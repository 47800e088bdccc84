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

``to_flax(state)`` is the inverse: a port ``state_dict`` -> the flax
``{"params", "batch_stats"[, "quant"]}`` tree as float32 numpy, the layout
``utils/checkpoint.py`` writes and the JAX package's ``load_msgpack``
reads against its own template; ``to_flax(from_flax(t))`` gives ``t``
back exactly.

``fit_state(state, model)`` fits a ``state_dict`` to a model of another
variant, as the JAX package's checkpoint loader does (``pad_stem_on_load``
there): a classic 3x3 stem kernel folds losslessly into an ``s2d``
model's 2x2 kernel (``s2d_fold_kernel``, after slicing off zero-padded
input planes); a stem, patchify or tubelet kernel saved before a
channel-padding lever (``stem_pad_c``, ``patch_pad_c``) was adopted is
zero-padded to the model's input planes, where those planes are padding
(never under the ``s2d`` stem, whose planes carry pixels); and the
``in_absmax`` buffers an ``act_int8`` model has and an fp state lacks come
from the model (uncalibrated). ``load_flax`` applies it, so a classic JAX
tree loads into an ``s2d`` model and an ``s2d`` tree straight across.
``zero_class_prior`` (defined in ``replay/checksum.py``, where the JAX
package has it) is importable from here too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.preprocess import pad_channels
from ..replay.checksum import zero_class_prior  # noqa: F401  (re-exported)
from ..utils.logging import get_logger

log = get_logger("models.import")

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


# Conv kernels the channel-padding levers grow: (port key, config attr).
# The input-channel axis is 1 in torch's layouts (OIHW, OITHW).
_PAD_KERNELS = (("stem.conv.weight", "stem_pad_c"), ("patch_embed.weight", "patch_pad_c"),
                ("tubelet.proj.weight", "patch_pad_c"))


def _padded_ok(cfg, attr: str, have: tuple, want: tuple) -> bool:
    """Is zero-padding ``have`` to ``want`` along the input channels sound:
    the model runs a channel-padded classic stem or patchify (``attr``
    set), and the shapes differ only by the padded planes."""
    pad_c = getattr(cfg, attr, 0)
    if not pad_c or getattr(cfg, "stem", "classic") != "classic":
        return False
    return (len(have) == len(want) > 1 and have[:1] == want[:1] and have[2:] == want[2:]
            and have[1] < want[1] == pad_c)


def fit_state(state: Mapping[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """``state`` fitted to ``model``'s variant (see the module docstring):
    the stem folded into an ``s2d`` model, pre-padding stem and patchify
    kernels zero-padded, missing ``in_absmax`` buffers taken from the
    model. Anything else is left for a strict load to judge."""
    out = dict(state)
    target = model.state_dict()
    cfg = getattr(model, "cfg", None)
    for key, attr in _PAD_KERNELS:
        have, want = out.get(key), target.get(key)
        if have is None or want is None or have.shape == want.shape:
            continue
        if (key == "stem.conv.weight" and getattr(cfg, "stem", "classic") == "s2d"
                and tuple(have.shape[2:]) == (3, 3) and tuple(want.shape[2:]) == (2, 2)
                and want.shape[1] % 4 == 0 and have.shape[1] >= want.shape[1] // 4):
            hwio = have.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
            folded = s2d_fold_kernel(hwio[:, :, :want.shape[1] // 4])
            out[key] = torch.tensor(folded.transpose(3, 2, 0, 1))
            log.info("checkpoint stem kernel s2d-folded %s -> %s", tuple(have.shape),
                     tuple(want.shape))
        elif _padded_ok(cfg, attr, tuple(have.shape), tuple(want.shape)):
            out[key] = pad_channels(have, want.shape[1], dim=1)
            log.info("checkpoint %s kernel zero-padded %s -> %s (%s compat)",
                     key.rsplit(".", 1)[0], tuple(have.shape), tuple(want.shape), attr)
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


def _nest(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """Port ``state_dict`` -> flax ``{"params", "batch_stats"[, "quant"]}``
    of float32 numpy arrays (the inverse of ``from_flax``; BatchNorm's
    ``num_batches_tracked`` has no flax leaf and is dropped). Raises
    ``KeyError`` on a key it does not map."""
    out: dict = {"params": {}, "batch_stats": {}}
    inverse = {v: k for k, v in _STAT_LEAVES.items()}
    for name, tensor in state.items():
        if name.endswith(".num_batches_tracked"):
            continue
        arr = tensor.detach().float().cpu().numpy()
        path = tuple(name.split("."))
        tail = ".".join(path[-2:])
        if tail in inverse:
            _nest(out["batch_stats"], path[:-2] + inverse[tail], arr)
            continue
        if path[-2:] == ("conv", "in_absmax"):
            _nest(out.setdefault("quant", {}), path, arr)
            continue
        if len(path) == 1:
            flax_path = path
        elif path[-1] == "weight" and path[-2] in _NORMS:
            flax_path = path[:-1] + ("scale",)
        elif path[-1] == "weight" and arr.ndim in _CONV_AXES:
            flax_path = path[:-1] + ("kernel",)
            arr = arr.transpose(np.argsort(_CONV_AXES[arr.ndim]))
        elif path[-1] == "weight" and arr.ndim == 2:
            flax_path = path[:-1] + ("kernel",)
            arr = arr.T
        else:
            flax_path = path
        # The forward map must take the leaf back to ``name``: anything it
        # does not know raises here.
        if _param(flax_path, arr)[0] != name:
            raise KeyError(f"unmapped port key {name}")
        _nest(out["params"], flax_path, np.ascontiguousarray(arr))
    if not out["batch_stats"]:
        del out["batch_stats"]
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
