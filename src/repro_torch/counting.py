"""Call and launch counters that stay exact under threads.

``counter[key] += 1`` and ``fn.launches += 1`` read, add and store in
separate steps, so two threads bumping the same count can lose an update.
The async pipeline executor runs its stage and draft actors on threads of
their own, and each of them bumps the kernels' launch counts and the
bundles' call counts; every bump goes through one lock here.  Reads and
resets happen between runs, with no actor running, and need no lock.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()


def bump(counter, key: str, n: int = 1) -> None:
    """``counter[key] += n`` (a ``collections.Counter``), atomically."""
    with _LOCK:
        counter[key] += n


def bump_attr(obj, name: str, n: int = 1) -> None:
    """``obj.<name> += n`` (a kernel wrapper's launch count),
    atomically."""
    with _LOCK:
        setattr(obj, name, getattr(obj, name) + n)
