"""Dynamic request batching for serving.

`Predictor.predict` batches within one call; under many concurrent small
requests each caller would dispatch its own under-filled batch. The
`DynamicBatcher` coalesces graphs from concurrent callers into shared
batches: callers enqueue a (graphs, Future) pair; a background thread
drains the queue, packing up to `max_batch` graphs or waiting at most
`max_wait_ms` for stragglers, runs one `Predictor.predict` call, and
hands each caller its rows through its future.

    batcher = DynamicBatcher(predictor, max_wait_ms=2.0)
    logits = batcher.predict(graphs)          # thread-safe, blocking
    ...
    batcher.close()

A lone request waits at most max_wait_ms beyond its own compute; at
saturation every dispatch is a full batch. `serve_http` handler threads
can call `predict` directly.

Shutdown: the closed-check and the enqueue happen under one lock, and
close() sets the flag and posts the shutdown token under the same lock,
so no request can slip in behind the token and hang.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np


class DynamicBatcher:
    def __init__(self, predictor, max_wait_ms: float = 2.0,
                 max_batch: int = None):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1e3
        self.max_batch = max_batch or predictor.max_batch
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- client API
    def predict(self, graphs: Sequence) -> np.ndarray:
        """Blocking predict; safe to call from many threads."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((list(graphs), fut))
        return fut.result()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    # ---------------------------------------------------------- batch loop
    def _drain(self, first):
        """Collect (graphs, future) pairs until max_batch graphs are
        pending or max_wait elapses. FIFO + the producer lock guarantee
        nothing follows the shutdown token, so re-posting it keeps it
        last."""
        slots = [first]
        total = len(first[0])
        deadline = time.perf_counter() + self.max_wait
        while total < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)
                break
            slots.append(nxt)
            total += len(nxt[0])
        return slots

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            slots = self._drain(item)
            merged = [g for graphs, _ in slots for g in graphs]
            try:
                logits = self.predictor.predict(merged)
            except Exception as e:
                # fresh exception instance per caller: a shared instance
                # raised from many threads at once would interleave
                # __traceback__ mutations
                for _, fut in slots:
                    err = RuntimeError(f"batched predict failed: {e!r}")
                    err.__cause__ = e
                    fut.set_exception(err)
                continue
            off = 0
            for graphs, fut in slots:
                n = len(graphs)
                fut.set_result(logits[off: off + n])
                off += n
