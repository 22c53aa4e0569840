"""The bounded notify-queue of the engine's worker threads.

A copy of the pure-Python branch of lsd_slam_tpu/utils/native.py
(`NotifyQueue`, == NotifyBuffer<T>, IOWrapper/NotifyBuffer.h). The JAX
package can also back it by its native host library; the port loads no
native library.
"""

from __future__ import annotations

import threading
from collections import deque


class NotifyQueue:
    """Bounded drop-on-full queue of Python objects with a blocking pop."""

    def __init__(self, capacity: int = 8):
        self._capacity = capacity
        self._dq = deque()
        self._cv = threading.Condition()
        self._dropped = 0

    def push(self, item) -> bool:
        """Queue `item`; False (and one more `dropped`) when full."""
        with self._cv:
            if len(self._dq) >= self._capacity:
                self._dropped += 1
                return False
            self._dq.append(item)
            self._cv.notify()
            return True

    def pop(self, timeout: float = 1.0):
        """The oldest item, waiting up to `timeout` s for one; else None."""
        with self._cv:
            if not self._dq:
                self._cv.wait(timeout)
            if self._dq:
                return self._dq.popleft()
            return None

    def size(self) -> int:
        with self._cv:
            return len(self._dq)

    @property
    def dropped(self) -> int:
        return self._dropped
