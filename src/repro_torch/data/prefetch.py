"""Host-side prefetcher: overlaps batch synthesis with device compute.

A small background thread keeps `depth` batches ahead of the training
loop (the latency-sensitive 'CPU-class' traffic stream in the KF
scheduler's terms, see dist/kf_scheduler.py).

On the card the thread makes each batch on a CUDA stream of its own, so
that the synthesis overlaps the step running on the loop's stream, and
records an event after it.  `get` makes the loop's current stream wait on
that event before it hands the batch over (so the step that reads the
batch is ordered after the kernels that wrote it) and marks each tensor
as used on that stream (`record_stream`), so that the caching allocator
does not hand its memory back to the side stream while the step still
reads it.  On the CPU there is nothing to order.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2,
                 start_step: int = 0):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._cuda = torch.cuda.is_available()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _produce(self, step: int, stream):
        if stream is None:
            return self._make(step), None
        with torch.cuda.stream(stream):
            batch = self._make(step)
            done = torch.cuda.Event()
            done.record(stream)
        return batch, done

    def _run(self):
        stream = torch.cuda.Stream() if self._cuda else None
        while not self._stop.is_set():
            step = self._next
            try:
                batch, done = self._produce(step, stream)
            except BaseException as e:  # handed to get(), which raises it
                batch, done = e, None
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch, done), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, BaseException):
                return
            self._next = step + 1

    def get(self) -> tuple[int, dict]:
        step, batch, done = self._q.get()
        if isinstance(batch, BaseException):
            raise batch
        if done is not None:
            current = torch.cuda.current_stream()
            current.wait_event(done)
            for t in batch.values():
                if t.is_cuda:
                    t.record_stream(current)
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self.get()
