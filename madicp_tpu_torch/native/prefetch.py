"""Scan prefetching: overlap dataset I/O with device compute.

The reference reads each scan synchronously before every ``compute``
(``apps/mad_icp.py:172-177``, ``bin_runner.cpp:120-165``), serialising
disk + decode with odometry. Here a bounded background thread keeps a few
decoded scans ahead, so the host-side read cost disappears behind the
device step.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Iterate a reader on a background thread with a bounded buffer.

    Wraps any of the dataset readers (they yield ``(stamp, points)``).
    Exceptions raised by the reader are re-raised on the consumer side.
    On early consumer exit (e.g. ``--max-scans``) the producer is told to
    stop and is joined before the underlying reader is closed, so it
    never races a closing reader or leaks a blocked thread.
    """

    _SENTINEL = object()

    def __init__(self, reader, depth: int = 4, transform=None):
        """``transform(item) -> item`` runs on the PRODUCER thread — use
        it to stage work off the consumer's critical path (e.g.
        ``Pipeline.stage`` to copy each scan to the device and pad it
        there). It may return None for an item the consumer will skip. A
        CUDA transform names its device explicitly (torch's current device
        is per thread), works on the stream the consumer steps on (each
        thread's default: what it stages is ordered before the step that
        reads it) and launches none of the step's kernels, whose
        workspaces are ordered on that one stream."""
        self._reader = reader
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._transform = transform

    def __enter__(self):
        if hasattr(self._reader, "__enter__"):
            self._reader.__enter__()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._stop.set()
        # unblock a producer stuck on put() and wait for it to finish
        # BEFORE closing the reader underneath it
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        if hasattr(self._reader, "__exit__"):
            return self._reader.__exit__(exc_type, exc_val, exc_tb)
        return False

    def _run(self):
        try:
            for item in self._reader:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._put_final((self._SENTINEL, e))
            return
        self._put_final((self._SENTINEL, None))

    def _put_final(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def __iter__(self):
        while True:
            item = self._queue.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is self._SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item

    def __len__(self):
        return len(self._reader)
