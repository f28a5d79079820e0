"""A small reader-writer lock.

Collections are single-writer / multi-reader: mutations donate device
buffers (invalidating the old ones), so a search must never hold references
to arrays a concurrent mutation is about to donate. Searches take the
shared side, mutations the exclusive side. Writer-preference keeps a stream
of searches from starving mutations.
"""

from __future__ import annotations

import threading


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            except BaseException:
                # Exceptional exit (e.g. KeyboardInterrupt in wait): the
                # decrement unblocks readers gated on _writers_waiting, but
                # they are asleep — without a notify this is a lost wakeup
                # and every later reader hangs forever.
                self._writers_waiting -= 1
                self._cond.notify_all()
                raise
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _Guard:
        def __init__(self, lock, write):
            self._lock, self._write = lock, write

        def __enter__(self):
            (self._lock.acquire_write if self._write
             else self._lock.acquire_read)()
            return self

        def __exit__(self, *exc):
            (self._lock.release_write if self._write
             else self._lock.release_read)()

    def read(self) -> "_Guard":
        return self._Guard(self, write=False)

    def write(self) -> "_Guard":
        return self._Guard(self, write=True)
