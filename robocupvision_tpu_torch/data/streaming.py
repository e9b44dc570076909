"""A streamed input pipeline for sets larger than the card's memory (the
JAX package's data/streaming.py).

The default path (device_cache.py) keeps the whole set on the card. Here a
producer thread reads and batches on the host while the card trains, and
copies each batch to the card from pinned memory on a side stream, so the
copy overlaps the consumer's compute. It yields the same static-shape
(imgs, labels, sample_mask) batches as ``epoch_batches``, so the train
step is the same for both pipelines.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device

HostBatch = Tuple[np.ndarray, np.ndarray, np.ndarray]


class _Slot:
    """A set of pinned host buffers for one batch in flight, and the event
    recorded after its copies to the card."""

    def __init__(self) -> None:
        self.bufs = None
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, batch: HostBatch):
        """Wait for the slot's previous copies, then hold ``batch``."""
        if self.event is not None:
            self.event.synchronize()
        if self.bufs is None:  # an epoch's batches share shapes and dtypes
            self.bufs = [torch.from_numpy(np.ascontiguousarray(a))
                         .pin_memory() for a in batch]
        else:
            for b, a in zip(self.bufs, batch):
                b.numpy()[...] = a
        return self.bufs


class StreamingBatches:
    """Iterable over one epoch of device batches from an indexable
    dataset (``__len__`` and ``__getitem__`` -> (img HWC, label))."""

    def __init__(self, dataset, batch_size: int,
                 rng: Optional[np.random.Generator] = None,
                 prefetch: int = 2, sharding=None,
                 device_transform: Optional[Callable] = None,
                 process_index: int = 0, process_count: int = 1,
                 device: DeviceLike = None):
        """``rng``: the epoch's shuffle (None: the dataset's order).
        ``prefetch``: batches the producer may run ahead.
        ``device_transform``: ``(imgs, labels) -> (imgs, labels)`` applied
        on the card after the copy, so that the dataset can ship compact
        dtypes (uint8 frames and labels, 7x fewer bytes than f32 and int32)
        and normalize and widen them on the card.

        ``process_index`` / ``process_count``: each process loads only
        ``order[process_index::process_count]`` of the (identically seeded)
        epoch permutation; every process yields the same number of batches
        (a short shard ends in all-padding batches). ``batch_size`` is the
        per-process batch. ``device``: ``cuda`` unless the caller passes
        another. ``sharding`` (a mesh's data axis) is not ported."""
        if sharding is not None:
            raise NotImplementedError("sharded streaming needs the mesh, "
                                      "which is not ported yet (ROADMAP A.7)")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of "
                             f"{process_count}")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = rng
        self.prefetch = prefetch
        self.device_transform = device_transform
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        # every process reports the common batch count (the largest local
        # shard's), padded processes included: see _host_batches
        n_max_local = -(-len(self.dataset) // self.process_count)
        return -(-n_max_local // self.batch_size)

    def _host_batches(self) -> Iterator[HostBatch]:
        n = len(self.dataset)
        order = (self.rng.permutation(n) if self.rng is not None
                 else np.arange(n))
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
        n = len(order)
        bs = self.batch_size
        donor = None  # read once: an all-padding batch needs only shapes
        for bi in range(len(self)):
            idx = order[bi * bs:(bi + 1) * bs]
            if len(idx) == 0:
                if donor is None:
                    donor = self.dataset[int(order[0]) if n else 0]
                img0, lab0 = (np.asarray(a) for a in donor)
                yield (np.zeros((bs,) + img0.shape, img0.dtype),
                       np.zeros((bs,) + lab0.shape, lab0.dtype),
                       np.zeros(bs, np.float32))
                continue
            imgs, labs = zip(*(self.dataset[int(i)] for i in idx))
            imgs, labs = np.stack(imgs), np.stack(labs)
            mask = np.ones(len(idx), np.float32)
            pad = bs - len(idx)
            if pad:
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:],
                                                      imgs.dtype)])
                labs = np.concatenate([labs, np.zeros((pad,) + labs.shape[1:],
                                                      labs.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield imgs, labs, mask

    def _producer(self, put: Callable) -> None:
        """Reads the epoch's host batches and hands them on: on a CUDA
        device copied from pinned buffers on a side stream, with the event
        the consumer's stream waits on; a slot's buffers are reused only
        after their copy has finished."""
        if self.device.type != "cuda":
            for batch in self._host_batches():
                if not put(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(self.device) for a in batch) + (None,)):
                    return
            return
        torch.cuda.set_device(self.device)
        side = torch.cuda.Stream(self.device)
        slots = [_Slot() for _ in range(self.prefetch + 2)]
        for bi, batch in enumerate(self._host_batches()):
            slot = slots[bi % len(slots)]
            bufs = slot.fill(batch)
            with torch.cuda.stream(side):
                out = tuple(b.to(self.device, non_blocking=True)
                            for b in bufs)
                slot.event = torch.cuda.Event()
                slot.event.record(side)
            if not put(out + (slot.event,)):
                return

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: list = []

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                self._producer(put)
            except BaseException as e:  # raised at the epoch's end
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        completed = False
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    completed = True
                    break
                *batch, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for x in batch:  # made on the side stream, used here
                        x.record_stream(cur)
                imgs, labs, mask = batch
                if self.device_transform is not None:
                    imgs, labs = self.device_transform(imgs, labs)
                yield imgs, labs, mask
        finally:
            stop.set()
            t.join()
            # a dataset error surfaces only when the consumer ran the epoch
            # to its end; an early break raises nothing from batches it
            # never asked for
            if completed and error:
                raise error[0]
