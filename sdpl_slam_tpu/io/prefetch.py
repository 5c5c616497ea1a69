"""Double-buffered frame prefetching.

The reference loads every frame synchronously inside the main loop
(/root/reference/example/sdpl_slam.cc:99-153): imread x2, readOpticalFlow,
LoadMask -- all on the critical path.  Here a background thread pool
decodes frames ahead of the tracking loop so host I/O overlaps device
compute (the reference's loader, pipelined).
"""

from __future__ import annotations

import concurrent.futures as _fut
from collections import OrderedDict
from typing import Callable, Iterator


class FramePrefetcher:
    """Prefetch ``load(i)`` results for i in [0, n) with a lookahead window.

    >>> pf = FramePrefetcher(seq.frame, seq.n_frames, lookahead=2)
    >>> for i, frame in pf:  # frames decode in background threads
    ...     track(frame)
    """

    def __init__(self, load: Callable[[int], object], n: int,
                 lookahead: int = 2, workers: int = 2):
        self._load = load
        self._n = n
        self._lookahead = max(lookahead, 1)
        self._pool = _fut.ThreadPoolExecutor(max_workers=workers)
        self._pending: "OrderedDict[int, _fut.Future]" = OrderedDict()

    def _schedule(self, i: int):
        if 0 <= i < self._n and i not in self._pending:
            self._pending[i] = self._pool.submit(self._load, i)

    def __iter__(self) -> Iterator:
        for i in range(min(self._lookahead + 1, self._n)):
            self._schedule(i)
        for i in range(self._n):
            fut = self._pending.pop(i)
            self._schedule(i + self._lookahead + 1)
            yield i, fut.result()
        self._pool.shutdown(wait=False)

    def peek(self, i: int):
        """Result for index ``i`` (scheduling it if needed) WITHOUT
        consuming the iteration order; None when out of range.  Used to
        hand frames t+1/t+2 to the tracker's detector prefetch (the
        chained loop dispatches detectors two frames ahead)."""
        if not (0 <= i < self._n):
            return None
        self._schedule(i)
        return self._pending[i].result()

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
