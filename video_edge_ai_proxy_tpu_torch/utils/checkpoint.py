"""msgpack checkpoints (counterpart of ``video_edge_ai_proxy_tpu/utils/checkpoint.py``).

The JAX package writes engine checkpoints with flax's msgpack serializer:
one map tree whose keys are strings and whose leaves are arrays, packed as
msgpack ext type 1 with the payload ``msgpack((shape, dtype name, C-order
bytes))``, and an optional metadata map under ``META_KEY`` at the top
level. This module reads and writes that format itself, for the subset
flax writes (map, array, str, bin, int, float, bool, nil, ext 1 and the
numpy-scalar ext 3), so the port needs no ``msgpack`` package: a file
written here is byte for byte the file flax would write for the same tree.

What the subset cannot hold raises ``CheckpointFormatError``, never a
misread: flax's chunked arrays (``__msgpack_chunked_array__``, for leaves
over 2**30 bytes), dtypes numpy lacks (``bfloat16``), other ext types.

Writes go through a temp file and ``os.replace``, as in JAX, so a crash
mid-write never leaves a torn checkpoint. The orbax train-state format
(``save_train_state``/``load_train_state``) has no counterpart.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Any, Mapping, Optional, Tuple

import numpy as np

# Reserved top-level key carrying checkpoint metadata (not model state):
# calibration results (conf_threshold), provenance.
META_KEY = "__vep_meta__"

# flax splits array leaves above this many bytes into chunks; the port
# refuses to write or read those.
MAX_LEAF_BYTES = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# numpy dtype kinds of the subset: bool, signed, unsigned, float, complex.
_PLAIN_KINDS = "biufc"


class CheckpointFormatError(ValueError):
    """A tree or file outside the msgpack subset this module handles."""


# -- encoder ------------------------------------------------------------------


def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes((n,))
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    raise CheckpointFormatError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_int(n: int) -> bytes:
    if n >= 0:
        return _pack_uint(n)
    if n >= -32:
        return struct.pack(">b", n)
    if n >= -0x80:
        return b"\xd0" + struct.pack(">b", n)
    if n >= -0x8000:
        return b"\xd1" + struct.pack(">h", n)
    if n >= -0x80000000:
        return b"\xd2" + struct.pack(">i", n)
    if n >= -0x8000000000000000:
        return b"\xd3" + struct.pack(">q", n)
    raise CheckpointFormatError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Optional[int], fix_max: int, codes: Tuple[int, int, int]) -> bytes:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise CheckpointFormatError(f"length {n} does not fit msgpack's 32 bits")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _pack_bin(b: bytes) -> bytes:
    return _sized(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixed:
        head = bytes((fixed[n],))
    else:
        head = _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack((shape, dtype name, bytes))."""
    if arr.dtype.kind not in _PLAIN_KINDS or arr.dtype.names:
        raise CheckpointFormatError(f"dtype {arr.dtype} cannot be checkpointed")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise CheckpointFormatError(
            f"array of {arr.nbytes} bytes is over {MAX_LEAF_BYTES}: flax would chunk it "
            "(__msgpack_chunked_array__), which this module does not write")
    shape = _sized(arr.ndim, 0x90, 16, (0, 0xDC, 0xDD)) + b"".join(
        _pack_int(int(d)) for d in arr.shape)
    return (_sized(3, 0x90, 16, (0, 0xDC, 0xDD)) + shape + _pack_str(arr.dtype.name)
            + _pack_bin(np.ascontiguousarray(arr).tobytes("C")))


def _pack(obj: Any, out: list) -> None:
    # strict types, as flax packs: bool before int, and numpy scalars as
    # ext 3, numpy arrays as ext 1.
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_pack_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_pack_str(obj))
    elif type(obj) in (bytes, bytearray):
        out.append(_pack_bin(bytes(obj)))
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj))))
    elif isinstance(obj, Mapping):
        out.append(_sized(len(obj), 0x80, 16, (0, 0xDE, 0xDF)))
        if any(type(key) is not str for key in obj):
            raise CheckpointFormatError(f"map keys {list(obj)!r} are not all str")
        # flax packs a tree rebuilt by jax.tree_util, which sorts map keys.
        for key in sorted(obj):
            out.append(_pack_str(key))
            _pack(obj[key], out)
    elif type(obj) is list:
        out.append(_sized(len(obj), 0x90, 16, (0, 0xDC, 0xDD)))
        for value in obj:
            _pack(value, out)
    else:
        raise CheckpointFormatError(f"cannot checkpoint a {type(obj).__name__}")


def packb(tree: Any) -> bytes:
    """``tree`` (maps with str keys, lists, numpy arrays and scalars, str,
    bytes, int, float, bool, None) -> msgpack bytes, as flax's
    ``msgpack_serialize`` packs it (map keys sorted)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# -- decoder ------------------------------------------------------------------

_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
          0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_EXT_LEN = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise CheckpointFormatError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.num(_FIXED[b])
        if b in _STR_LEN:
            return self.str(self.num(_STR_LEN[b]), raw)
        if b in _BIN_LEN:
            return bytes(self.take(self.num(_BIN_LEN[b])))
        if b in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"), raw)
        if b in _FIXEXT_LEN or b in _EXT_LEN:
            n = _FIXEXT_LEN[b] if b in _FIXEXT_LEN else self.num(_EXT_LEN[b])
            code = self.num(">b")
            return _ext(code, bytes(self.take(n)))
        raise CheckpointFormatError(f"msgpack type byte 0x{b:02x} is outside the subset")

    def str(self, n: int, raw: bool):
        chunk = bytes(self.take(n))
        return chunk if raw else chunk.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(raw)
            out[key] = self.read(raw)
        return out


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise CheckpointFormatError(f"msgpack ext type {code} is outside the subset")
    r = _Reader(payload)
    tpl = r.read(raw=True)
    if r.pos != len(payload) or not isinstance(tpl, list) or len(tpl) != 3:
        raise CheckpointFormatError("malformed array payload")
    shape, name, buf = tpl
    name = name.decode("ascii") if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in _PLAIN_KINDS:
        # numpy knows "bfloat16" only where ml_dtypes registered it: refused
        # everywhere, so a file reads alike with or without it.
        raise CheckpointFormatError(
            f"array dtype {name!r} is not a plain numpy dtype (bfloat16 and the other "
            "ml_dtypes leaves are not read)")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")
    return arr if code == _EXT_NDARRAY else arr[()]


def _refuse_chunked(tree: Any) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise CheckpointFormatError(
                "flax chunked array (a leaf over 2**30 bytes) is not read by the port")
        for value in tree.values():
            _refuse_chunked(value)


def unpackb(data: bytes) -> Any:
    """msgpack bytes -> tree (arrays as read-only numpy views of ``data``),
    as flax's ``msgpack_restore`` returns it."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(data):
        raise CheckpointFormatError(f"{len(data) - r.pos} bytes after the msgpack object")
    _refuse_chunked(tree)
    return tree


# -- files --------------------------------------------------------------------


def _write_atomic(path: str, data: bytes) -> None:
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read(path: str) -> Any:
    with open(path, "rb") as fh:
        return unpackb(fh.read())


def _restore(template: Any, state: Any, path: str = "") -> Any:
    """flax ``from_state_dict`` on plain trees: every key of a template map
    must be in the state (extra state keys are dropped); leaves come from
    the state."""
    if not isinstance(template, Mapping):
        return state
    if not isinstance(state, Mapping):
        raise ValueError(f"checkpoint holds a leaf where the template has a map at "
                         f"{path or '/'}")
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(f"the template's keys {sorted(missing)} are not in the checkpoint "
                         f"at {path or '/'}")
    return {k: _restore(v, state[str(k)], f"{path}/{k}") for k, v in template.items()}


def save_msgpack(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Atomic single-file save of ``tree`` (``meta``, a small JSON-like
    dict such as the calibrated serving threshold, under ``META_KEY``)."""
    state = dict(tree)
    if meta is not None:
        state[META_KEY] = meta
    _write_atomic(path, packb(state))


def load_msgpack(path: str, template: Any = None) -> Any:
    """The tree of a checkpoint, metadata stripped; restored into the
    structure of ``template`` when one is given."""
    return load_msgpack_with_meta(path, template)[0]


def load_msgpack_with_meta(path: str, template: Any = None):
    """(tree, meta dict or None) in one read of the file."""
    raw = _read(path)
    meta = None
    if isinstance(raw, dict):
        meta = raw.pop(META_KEY, None)
        if not isinstance(meta, dict):
            meta = None
    return (raw if template is None else _restore(template, raw)), meta


def set_msgpack_meta(path: str, meta: dict) -> None:
    """Attach or replace the metadata of an existing checkpoint without
    touching its tree (atomic rewrite): how calibration stamps the
    operating point onto a trained checkpoint."""
    raw = _read(path)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: not a dict-rooted msgpack checkpoint")
    raw[META_KEY] = meta
    _write_atomic(path, packb(raw))


def load_msgpack_meta(path: str) -> Optional[dict]:
    """The checkpoint's metadata dict, or None (absent or legacy)."""
    return load_msgpack_with_meta(path)[1]
