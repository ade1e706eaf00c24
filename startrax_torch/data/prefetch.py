"""Background batch prefetching: overlap host-side ray sampling with device
execution.

The reference leans on DataLoader(num_workers=4) (train_online__.py:1064) for
the same purpose; here a small thread pool keeps a bounded queue of sampled
batches ahead of the training loop. Sampling is numpy fancy-indexing (releases
the GIL for the bulk copies), so one or two workers hide it completely behind
a >100ms device step.

The port's own copy of startrax/data/prefetch.py (numpy and the
standard library), kept so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class BatchPrefetcher:
    """Runs `sample_fn(rng) -> batch dict` in background threads.

    Use as an iterator; call close() (or use as a context manager) when done.
    Sampling parameters that change over time (frame window) are read through
    the mutable `state` dict passed to sample_fn.
    """

    def __init__(
        self,
        sample_fn: Callable[[np.random.Generator, Dict], Dict],
        state: Dict,
        seed: int = 0,
        depth: int = 4,
        workers: int = 2,
    ):
        self.sample_fn = sample_fn
        self.state = state
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(seed + i,), daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, seed: int):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            try:
                item = ("batch", self.sample_fn(rng, self.state))
            except BaseException as exc:  # propagate to the consumer:
                # a dead worker + empty queue would deadlock __next__ forever
                item = ("error", exc)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "error":
                return

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        kind, payload = self._q.get()
        if kind == "error":
            raise RuntimeError("prefetch worker failed") from payload
        return payload

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=2.0)
