"""Background-prefetching data pipeline over any iterator.

Port of src/repro/data/pipeline.py (no JAX in it): batches stay numpy
arrays; the training driver moves each to the device after the
detectors have seen it.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class Prefetcher:
    """Runs the upstream iterator on a thread; keeps `depth` batches hot."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        except BaseException as e:  # surfaced on next __next__
            self.err = e
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self.err is not None:
                raise self.err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
