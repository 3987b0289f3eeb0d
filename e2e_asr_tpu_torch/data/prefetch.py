"""Host -> device input prefetching.

Counterpart of ``e2e_asr_tpu/data/prefetch.py``: a background thread
materialises the next host batches and issues their copies to the device
ahead of time, so that batch filling and the copy overlap the step instead
of running before it. On the card the copies come from pinned host memory,
``non_blocking``, on a stream of their own (``to_device`` on the thread,
one event a batch); the consumer's stream waits on that event, so neither
side waits on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: for CUDA a copy from pinned host memory, issued
    ``non_blocking`` on the current stream; for the CPU the array itself.

    ``Tensor.pin_memory()`` takes its buffer from torch's caching host
    allocator, which records the copy's stream and hands the buffer out
    again only once the copy has completed."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class DevicePrefetcher:
    """Wraps a host-batch iterator; yields ``(host_batch, device_batch)``.

    ``put_fn(host_batch) -> device_batch`` runs on the prefetch thread;
    ``depth`` bounds the device batches queued ahead. With a CUDA
    ``device``, ``put_fn`` runs on a stream of its own and an event is
    recorded after it; ``__next__`` makes the consumer's current stream
    wait on that event and marks every tensor of the device batch as used
    there (``record_stream``), so that the caching allocator does not hand
    its memory to another tensor while the consumer's work is queued.
    Iteration raises whatever the source iterator or ``put_fn`` raised."""

    def __init__(self, host_iter: Iterator, put_fn: Callable, depth: int = 2,
                 device: Optional[torch.device] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._host_iter = host_iter
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = torch.device(device) if self._cuda else None
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._th = threading.Thread(target=self._run, args=(host_iter, put_fn), daemon=True)
        self._th.start()

    def _put_blocking(self, item) -> bool:
        """Put with stop-checking retries; never silently drops. True if enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _put(self, put_fn, hb):
        if not self._cuda:
            return put_fn(hb), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            db = put_fn(hb)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return db, ev

    def _run(self, host_iter, put_fn):
        try:
            for hb in host_iter:
                db, ev = self._put(put_fn, hb)
                if not self._put_blocking((hb, db, ev)):
                    return
            self._put_blocking(None)
        except BaseException as e:  # surfaced to the consumer, not swallowed
            # recorded on the attribute first: the consumer checks it when the
            # queue stays empty after the thread has ended
            self._error = e
            self._put_blocking(e)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple:
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                # the thread gone with nothing queued: its error, or the end
                if not self._th.is_alive():
                    if self._error is not None:
                        raise self._error
                    raise StopIteration
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        hb, db, ev = item
        if ev is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ev)
            for t in _tensors(db):
                if t.is_cuda:
                    t.record_stream(stream)
        return hb, db

    def close(self):
        """Stop the thread, release the queued batches and close the source
        iterator (a generator's ``finally`` blocks run: the loader's worker
        threads end)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._th.join(timeout=10.0)
        close = getattr(self._host_iter, "close", None)
        if close is not None and not self._th.is_alive():
            close()
