"""Host-side batch pipeline: background-thread prefetch of decoded uint8
canvases. The reference uses 8 persistent DataLoader workers
(reference: ``src/data/datasets.py:158-166``); here the host only decodes
and resizes (see ``basd_tpu_torch.data.sources``), so a small thread pool with a
bounded prefetch queue keeps the TPU fed."""

from __future__ import annotations

import queue
import threading
from typing import Iterator


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a daemon thread, buffering ``depth`` items."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item
