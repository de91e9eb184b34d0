"""A search's launch signal.

An index that queues its search on the card, with the copies of its
answer, and then waits for the card, calls ``launched()`` between the
two, once a search. A caller that listens (``on_launched``) may then let
another thread launch the next search, which queues on the card behind
this one, while this thread waits for its answer
(serving/coalescer.py). The listener belongs to the calling thread; with
none, ``launched()`` does nothing. Only sq8r's search calls it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

_local = threading.local()


def launched() -> None:
    """Tell the calling thread's listener, if any, that this search's
    device work and its answer's copies are queued."""
    cb = getattr(_local, "cb", None)
    if cb is not None:
        cb()


@contextlib.contextmanager
def on_launched(cb: Optional[Callable[[], None]]):
    """Run the block with `cb` as the calling thread's listener (None: no
    listener), the one before it restored after."""
    prev = getattr(_local, "cb", None)
    _local.cb = cb
    try:
        yield
    finally:
        _local.cb = prev
