"""The host-side input pipeline (``nf_tpu/data.py``).

* :class:`ArrayDataset`: in-memory arrays in shuffled epoch batches. The
  shuffle is numpy's ``default_rng(seed)``, as in the JAX package, so a
  seed gives both packages the same batches in the same order.
* :func:`prefetch_to_device`: a background thread keeps the next batches
  on their way to the card (pinned host memory, ``non_blocking`` copies on
  a side CUDA stream) while the current step runs.
* :func:`load_npz_images`: ``.npz`` images with the reference's uint8 ->
  [0, 1] convention.
* :func:`procedural_image_classes`: zero-download class-structured
  images; pure numpy, so a seed gives the same images and labels in both
  packages, bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device


class ArrayDataset:
    """In-memory dataset over equal-length arrays (``nf_tpu/data.py:32``;
    reference analogue ``TensorDataset`` + ``DataLoader(shuffle=True)``).
    Iterating yields tuples of numpy batches (one array unwrapped);
    ``transform(batch) -> batch`` runs on the host per batch."""

    def __init__(self, *arrays, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 transform: Optional[Callable] = None):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        n = len(arrays[0])
        for a in arrays[1:]:
            if len(a) != n:
                raise ValueError("all arrays must share the leading dim")
        self.arrays = tuple(np.asarray(a) for a in arrays)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.transform = transform
        self._rng = np.random.default_rng(seed)
        self._n = n

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return -(-self._n // self.batch_size)

    def __iter__(self) -> Iterator:
        idx = np.arange(self._n)
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (self._n - self.batch_size + 1) if self.drop_last else self._n
        for s in range(0, max(stop, 0), self.batch_size):
            sel = idx[s:s + self.batch_size]
            batch = tuple(a[sel] for a in self.arrays)
            if self.transform is not None:
                batch = self.transform(batch)
            yield batch if len(batch) > 1 else batch[0]

    def epochs(self, n: Optional[int] = None) -> Iterator:
        """``n`` epochs (endless if None) as one stream."""
        if len(self) == 0:
            raise ValueError(
                f"dataset yields 0 batches (n={self._n} < batch_size="
                f"{self.batch_size} with drop_last): epochs() would spin "
                "forever")
        done = 0
        while n is None or done < n:
            yield from self
            done += 1


_SENTINEL = object()


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    return fn(batch)


def prefetch_to_device(iterator: Iterable, size: int = 2, sharding=None,
                       device=None):
    """Yield the batches of ``iterator`` (numpy arrays or tensors, or
    tuples of them) as tensors on ``device`` (None: CUDA, raising if it is
    absent), up to ``size`` of them in flight ahead of the consumer
    (``nf_tpu/data.py:92``).

    On CUDA a worker thread pins each batch in host memory and copies it
    with ``non_blocking=True`` on a side stream, recording an event; the
    consumer's stream waits for that event before the batch is yielded,
    and each tensor is marked used by the consumer's stream
    (``record_stream``), so the allocator does not hand its memory to the
    side stream's next copy while the step still reads it. Nothing here
    waits on the host for a copy. An exception in ``iterator`` reaches
    the consumer.

    ``sharding`` (a ``parallel.data_sharding`` of a mesh): every batch is
    a global batch, the same on every rank, and lands as this rank's
    shard on the mesh's device (``device`` must then be None or that
    device); only the shard is copied."""
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    if sharding is None:
        dev = resolve_device(device)
    else:
        dev = sharding.mesh.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{dev}, where the sharding places the batch")
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def enqueue(item) -> bool:
        """A blocking put that gives up once the consumer has gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            for batch in iterator:
                host = _map(torch.as_tensor, batch)
                if sharding is not None:
                    host = _map(lambda t: sharding.block(t).contiguous(),
                                host)
                if side is None:
                    item = (_map(lambda t: t.to(dev), host), None)
                else:
                    with torch.cuda.stream(side):
                        moved = _map(lambda t: t.pin_memory().to(
                            dev, non_blocking=True), host)
                        event = torch.cuda.Event()
                        event.record(side)
                    item = (moved, event)
                if stop.is_set() or not enqueue(item):
                    return
        except BaseException as e:  # noqa: BLE001 (reaches the consumer)
            enqueue(e)
            return
        enqueue(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                _map(lambda x: x.record_stream(current), batch)
            yield batch
    finally:
        # the consumer stopped (break, exception, close): release the
        # worker and drop the batches it had queued
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)


def load_npz_images(path: str, keys: Sequence[str] = ("x", "y"),
                    to_unit_interval: bool = True):
    """Image arrays from an ``.npz`` (``nf_tpu/data.py:173``): ``x`` uint8
    NCHW and optional labels; uint8 scales to [0, 1) by 1/256, the
    reference's ``ToTensor()`` + ``Scale(255/256)``. Numpy arrays, one
    per key found."""
    with np.load(path) as d:
        out = []
        for k in keys:
            if k not in d:
                continue
            a = d[k]
            if to_unit_interval and a.dtype == np.uint8 and k == keys[0]:
                a = a.astype(np.float32) / 256.0
            out.append(a)
    if not out:
        raise ValueError(f"none of {keys} found in {path}")
    return tuple(out) if len(out) > 1 else out[0]


def procedural_image_classes(seed: int, n: int, num_classes: int = 10,
                             size: int = 32, channels: int = 3):
    """Class-structured procedural RGB images (uint8 NCHW) and int32
    labels, the stand-in for CIFAR-10 of the image recipes: a
    class-dependent coloured sinusoid and a uniform texture."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n)
    yy, xx = np.mgrid[0:size, 0:size] / size
    phase = y[:, None, None] / num_classes * 2 * np.pi
    base = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy)[None] + phase)
    rgb = np.stack([np.cos(phase), np.sin(phase),
                    np.cos(2 * phase)], 1)[:, :channels]
    img = 0.6 * base[:, None] * (0.5 + 0.5 * rgb)
    img = img + 0.1 * rng.random((n, channels, size, size))
    return ((np.clip(img, 0, 1) * 255).astype(np.uint8),
            y.astype(np.int32))
