"""Threaded batch loader and device prefetch (counterpart of
``scale_imagenet_tpu/data/loader.py``).

Host threads decode/transform items into numpy batches; ``device_prefetch``
stages them on the card two deep: a producer thread pins each batch and
copies it with ``non_blocking=True`` on a side CUDA stream, and the
consumer's stream waits on that copy's event, so the copy of batch k+1
overlaps the forward of batch k.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 6, drop_last: bool = False,
                 seed: int = 0, rank: int = 0, world: int = 1):
        """Batches in order, or shuffled by ``np.random.default_rng(seed +
        epoch)`` (``set_epoch``), as the JAX package's loader draws them.

        ``drop_last`` drops the trailing short batch (training).
        ``rank``/``world``: multi-process feeding (the reference's
        DistributedSampler): every process draws the same permutation and
        takes a contiguous slice of it.  With ``drop_last`` the slice is
        ``len // world`` and the tail past it is dropped; without it the
        slice is ``ceil(len / world)`` and short ranks emit all-pad filler
        batches (labels -1, masked from the metric sums) up to the max rank
        count, so every image is scored in lockstep."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.rank = rank
        self.world = world
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        if self.drop_last:
            return (len(self.dataset) // self.world) // self.batch_size
        per = -(-len(self.dataset) // self.world)
        return -(-per // self.batch_size)

    def _filler_batches(self):
        if self.drop_last:
            return 0
        n = len(self.dataset)
        per = -(-n // self.world)
        mine = max(0, min(per, n - self.rank * per))
        return len(self) - -(-mine // self.batch_size)

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        per = (len(idx) // self.world if self.drop_last
               else -(-len(idx) // self.world))
        idx = idx[self.rank * per:(self.rank + 1) * per]
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and \
                len(batches[-1]) < self.batch_size:
            batches.pop()

        images = None
        with ThreadPoolExecutor(self.num_workers) as pool:
            # per-item futures, two batches ahead (no nested submits: a
            # batch task waiting on item tasks in the same pool deadlocks)
            def submit(batch_idx):
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in batch_idx]

            it = iter(batches)
            pending: deque = deque()
            for _ in range(2):
                b = next(it, None)
                if b is not None:
                    pending.append(submit(b))
            while pending:
                items = [f.result() for f in pending.popleft()]
                b = next(it, None)
                if b is not None:
                    pending.append(submit(b))
                images = np.stack([i[0] for i in items])
                labels = np.asarray([i[1] for i in items], np.int32)
                yield images, labels
        n_fill = self._filler_batches()
        if n_fill and images is None:    # empty rank slice (world > n)
            images = np.asarray(self.dataset[0][0])[None]
        for _ in range(n_fill):
            yield filler_batch(self.batch_size, images.shape[1:],
                               images.dtype)


def filler_batch(batch_size: int, shape, dtype=np.uint8):
    """One all-pad lockstep batch: zero images, every label ``-1``."""
    return (np.zeros((batch_size,) + tuple(shape), dtype),
            np.full((batch_size,), -1, np.int32))


def pad_batches(iterator, batch_size: int):
    """Pad a final short batch up to ``batch_size``: pad rows repeat the
    last real row and get label ``-1``, which ``masked_metric_sums`` leaves
    out.  Every image is scored (the reference's ``drop_last=False``) while
    every batch has one shape."""
    for images, labels in iterator:
        short = batch_size - len(images)
        if short > 0:
            images = np.concatenate(
                [images, np.repeat(images[-1:], short, axis=0)])
            labels = np.concatenate(
                [labels, np.full((short,), -1, labels.dtype)])
        yield images, labels


def device_prefetch(iterator, device, size: int = 2):
    """Stage host ``(images, labels)`` numpy batches on ``device``,
    ``size`` deep, from a producer thread.

    On the card each batch is pinned and copied with ``non_blocking=True``
    on a side stream; the consumer's current stream waits on the copy's
    event, and ``record_stream`` tells the caching allocator that the
    consumer's stream uses the batch, so its memory is not handed out
    again before the forward that reads it has run.  The pinned host
    buffer stays referenced until the consumer has queued that wait.  On
    the CPU the batches become tensors and nothing else.  An exception in
    the producer reaches the consumer; closing the generator stops the
    producer.
    """
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(images, labels):
        arrays = (images, labels)
        if side is None:
            # a shard batch may be a read-only view; tensors want writable
            return tuple(torch.from_numpy(np.require(a, requirements="CW"))
                         for a in arrays), None, None
        host = []
        for a in arrays:                 # one copy, straight into pinned
            dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
            t = torch.empty(a.shape, dtype=dtype, pin_memory=True)
            t.numpy()[...] = a
            host.append(t)
        with torch.cuda.stream(side):
            dev = tuple(t.to(device, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record(side)
        return dev, ready, host

    def producer():
        try:
            for images, labels in iterator:
                if not put(stage(images, labels)):
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised by consumer
            put(e)
        else:
            put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            batch, ready, host = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in batch:
                    t.record_stream(consumer)
            del host
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
