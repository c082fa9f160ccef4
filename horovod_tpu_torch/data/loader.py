"""Rank-sharded data loading with uneven-tail (Join) handling, and the
device prefetcher: the port of ``horovod_tpu/data/loader.py``.

Analog of the fork's data loader shim (reference horovod/mxnet/dataloader.py
splits batches across ranks) plus the standard Horovod idiom of
``DistributedSampler``-style per-rank sharding; the uneven tail integrates
with Join semantics (elastic/join.py): the last partial global batch is
padded and accompanied by a per-rank ``active`` mask so the reduction
divides by the true participant count.

Where the reference places a global batch sharded across the mesh
(``shard_batch``), a rank of the port is a process that holds only its
own rows: :class:`ShardedLoader` yields this rank's shard of every global
batch, and the Join mask for every rank.

:func:`prefetch_to_device` runs the host side ahead on a thread.  For a
CUDA device it copies each batch from pinned host memory on a side
stream of its own (:attr:`Prefetcher.stream`), records an event there,
and the consumer's stream waits for that event before the batch is
used; ``record_stream`` keeps the allocator from reusing the batch's
memory before the consumer's stream is done with it.  For the CPU it
yields the CPU tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import core
from ..utils import env as env_util

_SENTINEL = object()


def _map(fn, item):
    """``fn`` over every array or tensor of a (nested tuple/list/dict)
    batch."""
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map(fn, v) for v in item)
    return item


def _as_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)) \
        if isinstance(a, np.ndarray) else a


class Prefetcher:
    """The iterator :func:`prefetch_to_device` returns: ``depth`` items
    ahead of the consumer, in order, each moved to ``device``.
    ``stream`` is the side stream the copies run on (None off the card).
    A producer exception re-raises at the consumer's next pull; closing
    the iterator (or dropping it) releases the producer thread and any
    staged batches."""

    def __init__(self, iterator: Iterable, depth: int,
                 device: Optional[torch.device]):
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device is not None and device.type == "cuda" else None
        self._it = iter(iterator)
        self._q: Optional[queue.Queue] = None
        self._err: List[BaseException] = []
        self._stop = threading.Event()
        self._done = False
        if depth > 0:
            self._q = queue.Queue(maxsize=int(depth))
            self._thread = threading.Thread(
                target=self._produce, name="hvd-prefetch", daemon=True)
            self._thread.start()

    # -- the producer side ---------------------------------------------------
    def _place(self, item):
        """``item`` on the device: (the copy, the event the consumer's
        stream waits for, or None)."""
        item = _map(_as_tensor, item)
        if self.stream is None:
            if self.device is None or self.device.type == "cpu":
                return item, None
            return _map(lambda t: t.to(self.device), item), None
        with torch.cuda.stream(self.stream):
            out = _map(lambda t: t.pin_memory().to(self.device,
                                                   non_blocking=True), item)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _put(self, entry) -> bool:
        """Bounded put that gives up once the consumer is gone: a producer
        blocked forever on a full queue would leak the thread and pin its
        staged batches."""
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for item in self._it:
                if not self._put(self._place(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            self._err.append(e)
        finally:
            self._put(_SENTINEL)

    # -- the consumer side ---------------------------------------------------
    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._q is None:
            try:
                entry = self._place(next(self._it))
            except StopIteration:
                self._done = True
                raise
        else:
            entry = self._q.get()
            if entry is _SENTINEL:
                self._done = True
                if self._err:
                    raise self._err[0]
                raise StopIteration
        item, event = entry
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            _map(lambda t: t.record_stream(consumer), item)
        return item

    def close(self) -> None:
        """Release the producer and drop the staged batches."""
        self._done = True
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

    def __del__(self):
        self.close()


def prefetch_to_device(iterator: Iterable, depth: Optional[int] = None,
                       device=None) -> Prefetcher:
    """Run ``iterator`` ``depth`` items ahead on a background thread so
    the device never waits on host-side batch assembly, each item (a
    numpy array, a tensor, or a tuple / list / dict of them) moved to
    ``device`` (default: this rank's, :func:`core.device`, once
    initialized; else the items stay where they are).

    On a CUDA device the producer copies from pinned memory on the
    prefetcher's side stream and the consumer's stream waits for the
    copy (module docstring).  ``depth`` defaults to
    ``HVD_PREFETCH_DEPTH`` (2); 0 degrades to a synchronous iterator that
    places each item when it is pulled.  Item order is preserved."""
    if depth is None:
        depth = env_util.get_int(env_util.HVD_PREFETCH_DEPTH,
                                 env_util.DEFAULT_PREFETCH_DEPTH)
    if device is None and core.is_initialized():
        device = core.device()
    return Prefetcher(iterator, max(int(depth), 0),
                      torch.device(device) if device is not None else None)


def pad_tail(cols: List[np.ndarray], valid: int, batch_size: int,
             size: int) -> Tuple[List[np.ndarray], np.ndarray]:
    """THE Join-tail layout: zero-pad a partial global batch to
    ``batch_size * size`` rows, packing valid rows onto the lowest ranks,
    and return ``(cols, rows_per_rank)`` where ``rows_per_rank > 0`` is
    the active mask."""
    g = batch_size * size
    rows_per_rank = np.full((size,), batch_size, np.int32)
    if valid < g:
        full, rem = divmod(valid, batch_size)
        rows_per_rank = np.array(
            [batch_size] * full + ([rem] if rem else [])
            + [0] * (size - full - (1 if rem else 0)), np.int32,
        )
        pad = g - valid
        cols = [
            np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            for a in cols
        ]
    return cols, rows_per_rank


class ShardedLoader:
    """Iterate ``(shard..., active)`` over a host dataset.

    Each global batch has ``batch_size * size()`` rows; this rank yields
    its own ``batch_size`` of them (rows ``[rank·b, (rank+1)·b)``, the
    reference's ``P(AXIS)`` placement) on its device.  When the data
    doesn't divide evenly, the final batch is zero-padded
    (:func:`pad_tail`) and ``active`` marks which ranks hold at least one
    real row (a bool tensor with one entry a rank).

    ``prefetch`` (default ``HVD_PREFETCH_DEPTH``, 2) keeps that many
    batches staged ahead of the training loop via
    :func:`prefetch_to_device`; 0 makes the iterator synchronous.
    """

    def __init__(self, *arrays: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = False,
                 prefetch: Optional[int] = None):
        assert arrays, "need at least one array"
        n = arrays[0].shape[0]
        assert all(a.shape[0] == n for a in arrays)
        self.arrays = [np.asarray(a) for a in arrays]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.n = n

    def __len__(self) -> int:
        g = self.batch_size * core.size()
        return self.n // g if self.drop_remainder else -(-self.n // g)

    def __iter__(self) -> Iterator[Tuple[Any, ...]]:
        r, b = core.rank(), self.batch_size

        def produce():
            for cols, rows_per_rank in self._iterate_host():
                yield (*(a[r * b:(r + 1) * b] for a in cols),
                       rows_per_rank > 0)

        return iter(prefetch_to_device(produce(), self.prefetch))

    def _iterate_host(self) -> Iterator[Tuple[List[np.ndarray], np.ndarray]]:
        """Host-side batch assembly only (index + Join-tail pad);
        placement happens in the prefetcher so the copy overlaps
        compute."""
        size = core.size()
        g = self.batch_size * size
        idx = np.arange(self.n)
        if self.shuffle:
            # same permutation on every rank: seeded, not entropy-based
            np.random.default_rng(self.seed).shuffle(idx)
            self.seed += 1
        stop = (self.n // g) * g if self.drop_remainder else self.n
        for start in range(0, stop, g):
            take = idx[start: start + g]
            valid = take.shape[0]
            yield pad_tail(
                [a[take] for a in self.arrays], valid, self.batch_size,
                size,
            )
