"""Training data from the edge archive (counterpart of ``video_edge_ai_proxy_tpu/data/segments.py``).

Ingest workers archive GOP segments to disk (``ingest/archive.py``, naming
contract ``<device_id>/<start_ms>_<duration_ms>.{mp4,npz}``); this module
turns that archive into training batches for ``parallel.make_trainer``:
fine-tune on the site's own footage.

Segments are read with OpenCV (mp4) or numpy (the ``.npz`` the archiver
writes where no encoder exists). ``cv2`` is imported only where it is
needed, an mp4 read or a resize (``INTER_AREA``) to another size: without
it those raise, and a segment that raises is skipped with a warning, as in
JAX. Decoding runs in a background thread, so the card does not wait on
video IO. Shuffling is Python's ``random.Random(seed)``, as in JAX, so on
the same archive the port's batches and metadata equal JAX's.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("data.segments")


@dataclass(frozen=True)
class SegmentRef:
    device_id: str
    path: str
    start_ms: int
    duration_ms: int


@dataclass(frozen=True)
class SampleMeta:
    """Identity of one training sample: which camera, which archived
    segment, which frame within it (the clip's first frame for clips).
    This is the join key supervised fine-tuning needs to attach per-frame
    labels (``Loader(with_meta=True)``)."""

    device_id: str
    start_ms: int
    frame_idx: int


def scan_archive(root: str, device_ids: Optional[Sequence[str]] = None) -> List[SegmentRef]:
    """Walk ``<root>/<device_id>/<start>_<dur>.{mp4,npz}`` into refs,
    sorted by (device, start time)."""
    refs: List[SegmentRef] = []
    if not os.path.isdir(root):
        return refs
    for device_id in sorted(os.listdir(root)):
        if device_ids is not None and device_id not in device_ids:
            continue
        dev_dir = os.path.join(root, device_id)
        if not os.path.isdir(dev_dir):
            continue
        for name in sorted(os.listdir(dev_dir)):
            stem, ext = os.path.splitext(name)
            if ext not in (".mp4", ".npz"):
                continue
            parts = stem.split("-")[0].split("_")
            try:
                start_ms, dur_ms = int(parts[0]), int(parts[1])
            except (IndexError, ValueError):
                continue
            refs.append(SegmentRef(device_id, os.path.join(dev_dir, name),
                                   start_ms, dur_ms))
    # Numeric, not lexicographic: '10000_' sorts before '9000_' as strings.
    refs.sort(key=lambda r: (r.device_id, r.start_ms))
    return refs


def read_segment(ref: SegmentRef) -> np.ndarray:
    """Decode one segment -> [T, H, W, 3] uint8 BGR."""
    if ref.path.endswith(".npz"):
        with np.load(ref.path) as z:
            return np.asarray(z["frames"], np.uint8)
    import cv2

    cap = cv2.VideoCapture(ref.path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decodable in {ref.path}")
    return np.stack(frames).astype(np.uint8)


class SegmentDataset:
    """Iterable of fixed-shape samples drawn from archived segments.

    ``clip_len=0`` yields single frames [H, W, 3]; ``clip_len=T`` yields
    clips [T, H, W, 3] cut from consecutive frames. All samples are resized
    (anisotropically — no crop) to ``size`` so batches are
    shape-homogeneous regardless of per-camera resolutions.
    """

    def __init__(
        self,
        root: str,
        *,
        size: Tuple[int, int] = (224, 224),
        clip_len: int = 0,
        device_ids: Optional[Sequence[str]] = None,
        seed: int = 0,
    ):
        self.refs = scan_archive(root, device_ids)
        self.size = size
        self.clip_len = clip_len
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.refs)

    def _fit(self, frames: np.ndarray) -> np.ndarray:
        import cv2

        h, w = self.size
        if frames.shape[1:3] != (h, w):
            frames = np.stack(
                [cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA)
                 for f in frames]
            )
        return frames

    def samples_from(self, ref: SegmentRef) -> Iterator[np.ndarray]:
        for _, sample in self.indexed_samples_from(ref):
            yield sample

    def indexed_samples_from(
        self, ref: SegmentRef
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Like `samples_from` but yields ``(frame_idx, sample)`` so callers
        can join per-frame labels (`SampleMeta`)."""
        try:
            frames = self._fit(read_segment(ref))
        except Exception as exc:
            log.warning("skipping unreadable segment %s: %s", ref.path, exc)
            return
        if self.clip_len:
            for start in range(0, len(frames) - self.clip_len + 1, self.clip_len):
                yield start, frames[start:start + self.clip_len]
        else:
            for i, frame in enumerate(frames):
                yield i, frame

    def shuffled_refs(self) -> List[SegmentRef]:
        refs = list(self.refs)
        self._rng.shuffle(refs)
        return refs


class Loader:
    """Background-decoded, shuffled batcher: iterate numpy batches
    [B, (T,) H, W, 3] uint8 BGR, for the trainer to place on its device.

    ``with_meta=True`` yields ``(batch, metas)`` instead, where ``metas``
    is a list of `SampleMeta` aligned with batch rows — the label join for
    supervised fine-tuning on archived footage."""

    def __init__(self, dataset: SegmentDataset, batch_size: int,
                 prefetch: int = 4, drop_last: bool = True,
                 with_meta: bool = False):
        if prefetch < 1:
            # queue.Queue(0) would mean UNBOUNDED readahead, not none.
            raise ValueError("prefetch must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.with_meta = with_meta

    def __iter__(self) -> Iterator[np.ndarray]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def put(item) -> bool:
            # Bounded put that notices consumer abandonment, so a
            # steps-bounded training loop doesn't leak a blocked thread.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def emit(batch, metas) -> bool:
            stacked = np.stack(batch)
            return put((stacked, metas) if self.with_meta else stacked)

        def producer():
            try:
                batch: List[np.ndarray] = []
                metas: List[SampleMeta] = []
                for ref in self.dataset.shuffled_refs():
                    if stop.is_set():
                        return
                    for idx, sample in self.dataset.indexed_samples_from(ref):
                        batch.append(sample)
                        metas.append(SampleMeta(ref.device_id, ref.start_ms, idx))
                        if len(batch) == self.batch_size:
                            if not emit(batch, metas):
                                return
                            batch, metas = [], []
                if batch and not self.drop_last:
                    emit(batch, metas)
            except BaseException as exc:  # surfaced in the consumer
                error.append(exc)
            finally:
                put(DONE)

        thread = threading.Thread(target=producer, name="segment-loader",
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
