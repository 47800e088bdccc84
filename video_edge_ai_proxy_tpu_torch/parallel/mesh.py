"""The mesh of device slots (counterpart of
``video_edge_ai_proxy_tpu/parallel/mesh.py``).

The JAX package's device fabric is a ``jax.sharding.Mesh`` whose axes name
the parallelism dimensions (``AXES``: ``dp`` data parallel over cameras,
``fsdp``, ``sp``, ``tp``, ``ep``, ``pp``). The port's ``Mesh`` is an
ordered list of device *slots* under the same axis names and ``shape``:
each slot is a ``torch.device`` and the CUDA stream its steps run on.

The slots come from an explicit device list, which may repeat a device:
two slots of ``cuda:0`` step their own rows on two streams of one card,
as the JAX package's CPU twin serves a mesh over 8 virtual host devices
(``--xla_force_host_platform_device_count``). By default the list holds
the visible cards, one slot a card (``torch.cuda.device_count()``).

Data-parallel serving needs no collective: each slot steps its own rows
of a batch. Only ``dp`` may exceed 1 here; the model-parallel axes (tp,
fsdp, sp, ep placement, ring and Ulysses attention, the pipeline) are a
later slice of the port and raise.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("dp", "fsdp", "sp", "tp", "ep", "pp")

LATER_SLICE = ("tp/fsdp/sp/ep placement, ring and Ulysses attention and the pipeline are "
               "a later slice of the port; only dp may exceed 1")


class Slot:
    """One mesh slot: its index in the mesh, its device and, on a card, the
    CUDA stream its steps run on (the port's counterpart of one chip of
    the JAX mesh)."""

    __slots__ = ("index", "device", "stream")

    def __init__(self, index: int, device: torch.device):
        self.index = int(index)
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def context(self):
        """Run what follows on this slot: its device and stream on a card,
        nothing to switch on the CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def __repr__(self) -> str:
        return f"Slot({self.index}, {self.device})"


class Mesh:
    """Device slots under the axis names of ``AXES``; ``shape`` maps every
    axis to its size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names = AXES

    def __init__(self, shape: Dict[str, int], devices: Sequence[torch.device]):
        self.shape: Dict[str, int] = {a: int(shape.get(a, 1)) for a in AXES}
        self.slots: List[Slot] = [Slot(i, d) for i, d in enumerate(devices)]

    @property
    def devices(self) -> List[torch.device]:
        """The slots' devices, in slot order (a device may repeat)."""
        return [s.device for s in self.slots]

    @property
    def size(self) -> int:
        return len(self.slots)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in the order of its first slot: where a
        replicated model needs one copy."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({dict((a, n) for a, n in self.shape.items() if n > 1) or {'dp': 1}}, " \
               f"{[str(d) for d in self.devices]})"


def default_devices() -> List[torch.device]:
    """The visible cards, one slot a card; empty without a card."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` without an index names the current card: slots compare by
    device, so each carries its index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, tp: int = 1, ep: int = 1, pp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over explicit per-axis sizes; the product must equal the
    number of slots (``devices``, default: the visible cards), as in the
    JAX package. An axis other than ``dp`` above 1 raises."""
    shape = dict(zip(AXES, (dp, fsdp, sp, tp, ep, pp)))
    extra = {a: n for a, n in shape.items() if a != "dp" and n > 1}
    if extra:
        raise NotImplementedError(f"mesh {shape}: {LATER_SLICE} (asked for {extra})")
    if any(int(n) < 1 for n in shape.values()):
        raise ValueError(f"mesh {shape}: every axis needs a size of at least 1")
    devices = [_indexed(torch.device(d))
               for d in (devices if devices is not None else default_devices())]
    need = 1
    for n in shape.values():
        need *= int(n)
    if need != len(devices):
        raise ValueError(f"mesh {shape} needs {need} devices, have {len(devices)}")
    return Mesh(shape, devices)


def factor_sizes(n: int, prefer: Tuple[str, ...] = ("dp", "sp", "tp")) -> Dict[str, int]:
    """The JAX package's factoring of ``n`` devices: powers of two split
    across ``prefer`` round-robin (8 -> dp=2, sp=2, tp=2), the odd
    remainder on the first axis."""
    sizes = {a: 1 for a in AXES}
    rem = int(n)
    i = 0
    while rem % 2 == 0 and rem > 1:
        sizes[prefer[i % len(prefer)]] *= 2
        rem //= 2
        i += 1
    sizes[prefer[0]] *= rem
    return sizes


def factor_mesh(n_devices: Optional[int] = None, prefer: Tuple[str, ...] = ("dp", "sp", "tp"),
                devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` slots (default: all of
    ``devices``, default the visible cards), factored as ``factor_sizes``
    does; ``prefer=("dp",)`` is the serving profile (every slot on dp)."""
    devices = list(devices if devices is not None else default_devices())
    n = n_devices if n_devices is not None else len(devices)
    return make_mesh(**factor_sizes(n, prefer), devices=devices[:n])


def single_device_mesh(device=None) -> Mesh:
    """A dp=1 mesh over ``device`` (default: the first visible card)."""
    devices = [device] if device is not None else default_devices()[:1]
    return make_mesh(devices=devices)
