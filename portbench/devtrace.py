"""What a traced run records in the server's process: the harness's own
spans around calls into the program's layers (wrapped at run time on the
running server's objects, never in the program's files) and the device
trace of torch.profiler.
"""
from __future__ import annotations

import time

import numpy as np

from measure import attribute, idle_gaps, top_by_name, union_seconds

WINDOW_MARK = "portbench.window"


class Spans:
    """Times the Flight handlers' entries and VectorStore.search.

    handler: [(entry, t0, t1)]; store: [(queries, t0, t1)], perf_counter
    seconds. Each call also opens a profiler range named after it."""

    def __init__(self):
        self.handler: list = []
        self.store: list = []
        self._undo: list = []

    def install(self, handlers, store) -> None:
        from torch.profiler import record_function

        def wrap(obj, attr, record, size=None):
            orig = getattr(obj, attr)
            label = f"portbench.{type(obj).__name__}.{attr}"

            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    with record_function(label):
                        return orig(*a, **kw)
                finally:
                    tag = attr if size is None else size(*a, **kw)
                    record.append((tag, t0, time.perf_counter()))

            setattr(obj, attr, timed)
            self._undo.append((obj, attr))

        wrap(handlers, "do_get", self.handler)
        wrap(handlers, "do_exchange", self.handler)
        wrap(store, "search", self.store,
             size=lambda dataset, queries, *a, **kw: int(np.atleast_2d(queries).shape[0]))

    def remove(self) -> None:
        for obj, attr in self._undo:
            delattr(obj, attr)  # the class's method again
        self._undo.clear()


class DeviceTrace:
    """torch.profiler over the window (CPU and CUDA activity), read from
    its raw events: device intervals by name, host intervals by name and
    the window's own range."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def mark(self):
        """A context manager that marks the window in the trace."""
        from torch.profiler import record_function

        return record_function(WINDOW_MARK)

    def stop(self) -> dict:
        self.prof.stop()
        device, host, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns() * 1e-9
            iv = (e.name(), s, s + e.duration_ns() * 1e-9)
            if e.device_type().name == "CPU":
                if iv[0] == WINDOW_MARK:
                    window = iv[1:]
                else:
                    host.append(iv)
            else:
                device.append(iv)
        return reduce_trace(device, host, window)


def reduce_trace(device: list, host: list, window) -> dict:
    """busy_s, window_s, device_ops, idle_gaps and the device intervals
    inside the window, from raw (name, start, end) intervals."""
    if window is None:
        raise RuntimeError("the trace holds no window mark")
    lo, hi = window
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    iv = np.array([(s, e) for _, s, e in inside], float).reshape(-1, 2)
    gaps = idle_gaps(iv, lo, hi)
    return {
        "window_s": hi - lo,
        "busy_s": union_seconds(iv, lo, hi),
        "device_ops": top_by_name(inside),
        "idle_gaps": attribute(gaps, host),
        "kernels": inside,
    }
