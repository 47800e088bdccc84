"""Published checkpoints onto the port's models (counterpart of
``video_edge_ai_proxy_tpu/models/import_weights.py``).

``convert(model_name, state)`` maps a state dict in one of three community
layouts onto the port's ``state_dict`` for ``model_name``:

- ``yolov8n``/``yolov8s``/``tiny_yolov8`` (and the ``_s2d`` stem variants)
  from ultralytics ``model.state_dict()`` names (``model.0.conv.weight`` ...
  ``model.22.cv3.2.2.bias``);
- ``resnet50``/``tiny_resnet`` from torchvision names (``conv1.weight``,
  ``layer3.5.bn2.running_var``, ``fc.weight``);
- ``vit_b16``/``tiny_vit`` from timm names (``blocks.7.attn.qkv.weight``,
  ``patch_embed.proj.weight``, ``head.bias``).

The sources are torch layouts, as the port's modules are, so tensors carry
over unchanged; the work is the naming. Each port key is read as the flax
path the JAX package's module would have (``conv.weight`` ->
``conv/kernel``, ``bn.running_var`` -> ``bn/var``), and the JAX importer's
per-family rule names its source key. Two stem kernels are refitted: a
channel-padded stem (``stem_pad_c``, classic stem only) takes the source's
3 input planes zero-padded, and an ``s2d`` stem takes the lossless fold of
the source's 3x3 kernel (both ``carry.fit_state``).

``load_state_dict(path)`` reads a source checkpoint (``.npz``,
``.safetensors``, torch ``.pt``/``.pth`` with ``weights_only=True``) into
float32 numpy; safetensors files are parsed directly (an 8-byte
little-endian header length, a JSON header, raw little-endian buffers), so
the ``safetensors`` package is not needed.

Accounting is strict: every port tensor must be assigned from a source
tensor of its shape, and every source tensor consumed but ultralytics'
fixed DFL conv and ``num_batches_tracked``. Anything else raises
``ValueError`` listing each problem, so a layout drift fails loudly
instead of serving half-imported weights.
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from .carry import fit_state

__all__ = ["convert", "load_state_dict", "pad_stem_on_load", "SUPPORTED"]

# The JAX package's ``pad_stem_on_load(raw, template, model)`` fits a loaded
# flax tree to the model's stem and patchify kernels; on port state dicts
# ``carry.fit_state(state, model)`` does that job.
pad_stem_on_load = fit_state

_BN_SOURCE = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_LN_SCOPES = ("ln1", "ln2", "ln_final")


# safetensors dtype names -> torch dtypes (torch reads bf16, numpy cannot).
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> float32 numpy, read directly: u64 header
    length (little-endian), the JSON header (``{name: {dtype, shape,
    data_offsets}}``, ``__metadata__`` aside), then the byte buffer the
    offsets index."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, not read")
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= len(body):
            raise ValueError(f"{path}: tensor {name!r} has offsets {start}..{end} outside "
                             f"the {len(body)}-byte buffer")
        shape = tuple(info["shape"])
        if end > start:
            t = torch.frombuffer(bytearray(body[start:end]), dtype=torch.uint8).view(dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        if t.numel() != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} holds {t.numel()} elements, its "
                             f"shape {shape} wants {int(np.prod(shape))}")
        out[name] = t.reshape(shape).float().numpy()
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A state dict from ``.npz`` / ``.safetensors`` / torch ``.pt|.pth``
    as float32 numpy (imports are offline; float32 is the interchange).
    Torch pickles load with ``weights_only=True`` (a checkpoint never runs
    code), unwrapped from a ``{"state_dict": sd}`` or ``{"model": sd}``
    wrapper; non-tensor entries are dropped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k], np.float32) for k in z.files}
    if path.endswith(".safetensors"):
        return _read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint object in {path!r}")
    for wrapper in ("state_dict", "model"):
        if wrapper in obj and isinstance(obj[wrapper], dict):
            obj = obj[wrapper]
    return {
        k: np.asarray(v.detach().float().numpy() if hasattr(v, "detach") else v, np.float32)
        for k, v in obj.items() if hasattr(v, "shape")
    }


def _flax_path(name: str) -> Tuple[str, ...]:
    """A port ``state_dict`` key -> the flax param path of the JAX
    package's module (the collection left out)."""
    *scope, leaf = name.split(".")
    if not scope:
        return (leaf,)                        # cls_token, pos_embed
    if scope[-1] == "bn":
        return tuple(scope) + (_BN_LEAF[leaf],)
    if scope[-1] in _LN_SCOPES and leaf == "weight":
        return tuple(scope) + ("scale",)
    return tuple(scope) + ("kernel" if leaf == "weight" else leaf,)


def _convbn_key(prefix: str, rest: Tuple[str, ...]) -> str:
    """(conv|bn, leaf) below a ConvBN: shared by every family."""
    sub, leaf = rest[0], rest[1]
    if sub == "conv":
        return f"{prefix}.conv.weight"
    return f"{prefix}.bn.{_BN_SOURCE[leaf]}"


# -- yolo ---------------------------------------------------------------------

# The port's backbone and neck module -> its ultralytics module-list index
# (yolov8.yaml order; 10/11/13/14/17/20 are parameter-free Upsample/Concat).
_YOLO_IDX = {
    "stem": 0, "down2": 1, "c2f_2": 2, "down3": 3, "c2f_3": 4,
    "down4": 5, "c2f_4": 6, "down5": 7, "c2f_5": 8, "sppf": 9,
    "neck_up4": 12, "neck_up3": 15, "neck_down4": 16, "neck_out4": 18,
    "neck_down5": 19, "neck_out5": 21,
}


def _yolo_key(path: Tuple[str, ...]) -> str:
    mod, rest = path[0], path[1:]
    if mod == "detect":
        # box{l}_* = cv2.{l}.{0,1,2}, cls{l}_* = cv3.{l}.{0,1,2}
        head, rest = rest[0], rest[1:]
        branch = "cv2" if head.startswith("box") else "cv3"
        sub = head.split("_", 1)[1]           # cv1 | cv2 | out
        slot = {"cv1": "0", "cv2": "1", "out": "2"}[sub]
        prefix = f"22.{branch}.{head[3]}.{slot}"
        if sub == "out":                       # a plain conv with a bias
            return f"{prefix}.{'weight' if rest[0] == 'kernel' else 'bias'}"
        return _convbn_key(prefix, rest)
    idx = _YOLO_IDX[mod]
    if mod.startswith(("c2f", "neck_up", "neck_out")):
        sub = rest[0]
        if sub.startswith("m"):                # bottleneck m{i}.cv{1,2}
            return _convbn_key(f"{idx}.m.{sub[1:]}.{rest[1]}", rest[2:])
        return _convbn_key(f"{idx}.{sub}", rest[1:])
    if mod == "sppf":
        return _convbn_key(f"{idx}.{rest[0]}", rest[1:])
    return _convbn_key(str(idx), rest)         # a plain ConvBN stage


def _strip_model_prefix(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """ultralytics nests its module list under one or two ``model.`` levels,
    as the dict was exported; bare indices either way."""
    state = dict(state)
    while state and all(k.startswith("model.") for k in state):
        state = {k[len("model."):]: v for k, v in state.items()}
    return state


# -- resnet -------------------------------------------------------------------

def _resnet_key(path: Tuple[str, ...]) -> str:
    mod, rest = path[0], path[1:]
    if mod == "stem":
        sub, leaf = rest
        return "conv1.weight" if sub == "conv" else f"bn1.{_BN_SOURCE[leaf]}"
    if mod == "classifier":
        return "fc.weight" if rest[0] == "kernel" else "fc.bias"
    # stage{si}_block{bi} -> layer{si+1}.{bi}
    stage, block = mod.split("_")
    prefix = f"layer{int(stage[5:]) + 1}.{int(block[5:])}"
    sub, conv_or_bn, leaf = rest
    if sub == "downsample":
        if conv_or_bn == "conv":
            return f"{prefix}.downsample.0.weight"
        return f"{prefix}.downsample.1.{_BN_SOURCE[leaf]}"
    j = sub[4:]                                # conv{j}: .conv{j}.weight, .bn{j}.*
    if conv_or_bn == "conv":
        return f"{prefix}.conv{j}.weight"
    return f"{prefix}.bn{j}.{_BN_SOURCE[leaf]}"


# -- vit ----------------------------------------------------------------------

def _vit_key(path: Tuple[str, ...]) -> str:
    mod, rest = path[0], path[1:]
    if mod in ("cls_token", "pos_embed"):
        return mod
    if mod == "patch_embed":
        return "patch_embed.proj.weight" if rest[0] == "kernel" else "patch_embed.proj.bias"
    if mod == "classifier":
        return "head.weight" if rest[0] == "kernel" else "head.bias"
    if mod != "encoder":
        raise KeyError(f"no timm name for {'/'.join(path)}")
    sub, rest = rest[0], rest[1:]
    ln = {"scale": "weight", "bias": "bias"}
    if sub == "ln_final":
        return f"norm.{ln[rest[0]]}"
    i = int(sub[5:])
    part, rest = rest[0], rest[1:]
    if part in ("ln1", "ln2"):
        return f"blocks.{i}.norm{part[2]}.{ln[rest[0]]}"
    leaf = "weight" if rest[1] == "kernel" else "bias"
    if part == "attn":
        proj = {"qkv": "qkv", "out": "proj"}[rest[0]]
        return f"blocks.{i}.attn.{proj}.{leaf}"
    if part != "mlp":
        raise KeyError(f"no timm name for {'/'.join(path)}")
    return f"blocks.{i}.mlp.{rest[0]}.{leaf}"


_FAMILIES: Dict[str, Callable[[Tuple[str, ...]], str]] = {
    "yolov8n": _yolo_key, "yolov8s": _yolo_key, "tiny_yolov8": _yolo_key,
    "yolov8n_s2d": _yolo_key, "tiny_yolov8_s2d": _yolo_key,
    "resnet50": _resnet_key, "tiny_resnet": _resnet_key,
    "vit_b16": _vit_key, "tiny_vit": _vit_key,
}
SUPPORTED = sorted(_FAMILIES)

# Source keys with no port tensor, expected to remain: BatchNorm's
# num_batches_tracked, and ultralytics' DFL conv, whose weight is the fixed
# arange(reg_max) the decode computes.
_IGNORABLE = ("num_batches_tracked", "dfl.conv.weight")


def convert(model_name: str, state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A state dict in ``model_name``'s community layout -> the port's
    ``state_dict`` (float32 CPU tensors) for the registry model, ready for
    ``load_state_dict(..., strict=True)``. Raises ``ValueError`` listing
    every port tensor without a source, every shape mismatch and every
    source tensor left unconsumed."""
    from . import registry

    if model_name not in _FAMILIES:
        raise ValueError(f"no import mapping for {model_name!r}; supported: {SUPPORTED}")
    key_fn = _FAMILIES[model_name]
    if key_fn is _yolo_key:
        state = _strip_model_prefix(state)
    model = registry.get(model_name).init_params(device="cpu", dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    consumed: set = set()
    problems: list = []
    for name, target in model.state_dict().items():
        if name.endswith(".num_batches_tracked"):
            out[name] = torch.tensor(0)
            continue
        src_key = key_fn(_flax_path(name))
        if src_key not in state:
            problems.append(f"missing source tensor {src_key!r} for {name}")
            continue
        val = torch.tensor(np.asarray(state[src_key], np.float32))
        want = tuple(target.shape)
        if name == "stem.conv.weight" and tuple(val.shape) != want:
            val = fit_state({name: val}, model)[name]
        if tuple(val.shape) != want:
            problems.append(f"shape mismatch for {name}: source {src_key!r} gives "
                            f"{tuple(val.shape)}, the model wants {want}")
            continue
        out[name] = val
        consumed.add(src_key)
    leftovers = sorted(k for k in state if k not in consumed and not k.endswith(_IGNORABLE))
    if leftovers:
        problems.append(f"{len(leftovers)} source tensors unconsumed (layout drift?): "
                        + ", ".join(leftovers[:8]) + ("..." if len(leftovers) > 8 else ""))
    if problems:
        raise ValueError(f"import of {model_name!r} failed ({len(problems)} problems):\n- "
                         + "\n- ".join(problems))
    return out
