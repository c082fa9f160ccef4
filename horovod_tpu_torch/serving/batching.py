"""Continuous / dynamic batching for inference replicas: the port of
``horovod_tpu/serving/batching.py``.

Two pieces:

* :class:`ContinuousBatcher` — the admit/flush loop.  A batch opens
  when the first request arrives and closes when EITHER
  ``HVD_SERVE_MAX_BATCH`` requests are admitted (flush-on-size) OR
  ``HVD_SERVE_MAX_WAIT_MS`` has passed since the first admit
  (flush-on-deadline), whichever is first.  Batches never straddle the
  deadline waiting for a fuller batch — bounded queueing delay is the
  whole point of the deadline.
* :class:`BatchBucketer` — padded-shape bucketing.  A replica captures
  one CUDA graph per input shape (serving/replica.py), so raw batch
  sizes would capture a graph for every distinct fill; the bucketer rounds each batch up to a fixed ladder
  (``HVD_SERVE_BUCKET_SIZES``, default powers of two up to the max
  batch) so the number of compiled programs is bounded by the ladder
  length.  Padding rows are zeros and sliced off after the forward.

Both take an injectable clock so flush behaviour is deterministic
under test (the tests pin flush-on-size vs flush-on-deadline against a
scripted clock).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import env as env_util


def bucket_sizes_from_env(max_batch: int) -> Tuple[int, ...]:
    """The padded-size ladder: ``HVD_SERVE_BUCKET_SIZES`` (comma list)
    when set, else powers of two up to ``max_batch`` (always including
    ``max_batch`` itself so a full batch needs no padding)."""
    spec = env_util.get_str(env_util.HVD_SERVE_BUCKET_SIZES)
    if spec:
        sizes = sorted({int(s) for s in spec.split(",") if s.strip()})
        if not sizes:
            raise ValueError(
                f"{env_util.HVD_SERVE_BUCKET_SIZES}={spec!r} names no "
                "sizes")
    else:
        sizes, p = [], 1
        while p < max_batch:
            sizes.append(p)
            p *= 2
        sizes.append(max_batch)
        sizes = sorted(set(sizes))
    return tuple(sizes)


class BatchBucketer:
    """Round batch sizes up a fixed ladder so graph captures are bounded."""

    def __init__(self, sizes: Sequence[int]) -> None:
        sizes = sorted({int(s) for s in sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {sizes}")
        self.sizes = tuple(sizes)

    def bucket(self, n: int) -> int:
        """Smallest ladder size >= ``n``.  Anything above the top rung
        has no padded shape to land in — InferenceReplica caps its
        batcher at the top rung, and :meth:`pad` raises rather than
        mis-padding."""
        for s in self.sizes:
            if n <= s:
                return s
        raise ValueError(
            f"batch of {n} exceeds the bucket ladder top "
            f"{self.sizes[-1]} — cap the batcher at the top rung")

    def pad(self, stacked: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad a ``[n, ...]`` array with zero rows up to the bucket
        size; returns ``(padded, n)`` so the caller slices the real
        rows back off the output."""
        n = stacked.shape[0]
        b = self.bucket(n)
        if b == n:
            return stacked, n
        pad_width = [(0, b - n)] + [(0, 0)] * (stacked.ndim - 1)
        return np.pad(stacked, pad_width), n


class ContinuousBatcher:
    """The admit/flush loop over a broker-shaped ``pull`` callable.

    ``pull(max_n, wait_s) -> list`` is the only contract — the in-
    process :class:`~horovod_tpu_torch.serving.broker.RequestBroker` and the
    HTTP remote source both fit.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, pull: Callable[[int, float], List],
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.pull = pull
        self.max_batch = int(
            max_batch if max_batch is not None
            else env_util.get_int(env_util.HVD_SERVE_MAX_BATCH,
                                  env_util.DEFAULT_SERVE_MAX_BATCH))
        self.max_wait_s = float(
            max_wait_ms if max_wait_ms is not None
            else env_util.get_float(env_util.HVD_SERVE_MAX_WAIT_MS,
                                    env_util.DEFAULT_SERVE_MAX_WAIT_MS)
        ) / 1000.0
        self.clock = clock
        self.batches = 0

    def next_batch(self, idle_wait_s: float = 0.1) -> List:
        """One admit/flush cycle: block up to ``idle_wait_s`` for the
        first request (empty list when none arrives — the replica loop
        spins), then admit until the size cap or the deadline.  The
        opening pull asks for a FULL batch: a backlog fills the batch
        in one round trip (one HTTP pull for a RemoteSource), and the
        deadline loop only runs for the unfilled remainder."""
        batch = self.pull(self.max_batch, idle_wait_s)
        if not batch:
            return []
        deadline = self.clock() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - self.clock()
            if remaining <= 0:
                break
            more = self.pull(self.max_batch - len(batch), remaining)
            if not more:
                break  # pull honored the deadline; nothing arrived
            batch.extend(more)
        self.batches += 1
        self._record_fill(len(batch))
        return batch

    def _record_fill(self, n: int) -> None:
        try:
            from .. import metrics

            if metrics.on():
                metrics.SERVE_BATCH_FILL.observe(n)
        except Exception:  # noqa: BLE001
            pass
