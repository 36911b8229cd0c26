"""Device prefetching: a background thread samples host batches and copies
them to the device ahead of the train step.

Counterpart of ``autovc_tpu/data/prefetch.py``. On a CUDA device each batch
is pinned and copied with ``non_blocking=True``; the copy is enqueued on the
worker's current stream, the default stream the train step also runs on.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator

import torch

_END = object()  # end-of-stream sentinel


class DevicePrefetcher:
    """Wraps a host iterator of numpy tuples; a worker thread keeps ``depth``
    batches on ``device`` ahead of the consumer.

    An exception from the wrapped iterator is forwarded to the consumer, once
    per occurrence, and the worker keeps pulling, so a consumer that retries
    ``next()`` gets fresh batches. Exhaustion raises StopIteration at the
    consumer."""

    def __init__(self, it: Iterator, device: str | torch.device, depth: int = 2):
        self._it = iter(it)
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, a) -> torch.Tensor:
        t = torch.as_tensor(a)
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                batch = next(self._it)
            except StopIteration:
                self._put(_END)
                return
            except Exception as exc:  # forward and keep serving
                if not self._put(exc):
                    return
                continue
            try:
                item = tuple(self._to_device(a) for a in batch)
            except Exception as exc:  # a failed copy is forwarded too
                if not self._put(exc):
                    return
                continue
            if not self._put(item):
                return

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _END:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Stop and join the worker."""
        self._stop.set()
        try:  # drain, so a worker blocked on a full queue sees the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            warnings.warn("DevicePrefetcher worker still alive after a 60 s join: the wrapped "
                          "iterator is blocked", RuntimeWarning, stacklevel=2)
