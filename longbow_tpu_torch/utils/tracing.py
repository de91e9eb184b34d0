"""Tracing and profiling hooks.

Counterpart of longbow_tpu/utils/tracing.py (reference: OTel
TracerProvider and pprof, cmd/longbow/main.go:291-356,570-588).

Two clocks, tied together:

- the process's span recorder: ``span`` and ``interval`` append
  (name, thread, t0_ns, t1_ns, attrs) from ``time.perf_counter_ns`` to a
  bounded buffer while a caller has started it (``start`` / ``stop``).
  Off, a span costs one module-level check and returns a shared no-op
  context. Spans are recorded from every thread, which torch.profiler's
  default configuration does not do: it sees the ranges of the thread
  that started it only.
- torch.profiler's device trace (``device_trace``): kernels and copies,
  and the CUDA runtime calls that launched them from any thread.

``start`` opens a ``longbow.clock`` range and stamps the recorder's clock
inside it, so a profiler started on the same thread holds the anchor
that maps each span onto its own clock. ``device_trace`` writes both into
one Chrome trace (open it in Perfetto): a track a thread, the program's
steps over the card's kernels.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import NamedTuple, Optional

import torch

CLOCK = "longbow.clock"
MAX_RECORDS = 1 << 18  # a 45-s traced benchmark run on an H100 recorded 7,000-30,000

_recorder: Optional["_Recorder"] = None  # the process's recorder, None while off


class Trace(NamedTuple):
    """What ``stop`` returns. records: (name, thread native id, t0_ns,
    t1_ns, attrs) in the order recorded; anchor_ns: the recorder's
    clock inside the ``longbow.clock`` range, just before it closed;
    dropped: the oldest records the full buffer let go; threads: native
    id -> (``threading.get_ident()``, name) of each thread that recorded.
    The profiler names a thread that it did not start on by the CUDA
    runtime's id for it, the ident's low 32 bits, not by its native id."""

    records: list
    anchor_ns: int
    dropped: int
    threads: dict


class _Recorder:
    def __init__(self, maxlen: int):
        self._buf: deque = deque(maxlen=maxlen)
        self._mu = threading.Lock()
        self.dropped = 0
        self.anchor_ns = 0
        self.threads: dict = {}
        self.open = True

    def add(self, rec: tuple) -> None:
        with self._mu:
            if not self.open:
                return
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1  # the append lets the oldest go
            self._buf.append(rec)
            if rec[1] not in self.threads:
                me = threading.current_thread()
                if me.native_id == rec[1]:
                    self.threads[rec[1]] = (me.ident, me.name)

    def close(self) -> list:
        with self._mu:
            self.open = False
            return list(self._buf)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_t0")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self._rec.add((self._name, threading.get_native_id(), self._t0,
                       time.perf_counter_ns(), self._attrs))
        return False


def recording() -> bool:
    """Whether a caller has started the recorder."""
    return _recorder is not None


def span(name: str, **attrs):
    """A context manager that records the block on the calling thread
    while the recorder is on; off, the shared no-op context."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Span(rec, name, attrs)


def interval(name: str, t0_ns: int, t1_ns: int, thread: Optional[int] = None,
             **attrs) -> None:
    """Record [t0_ns, t1_ns] (perf_counter_ns) stamped on different
    threads, on `thread` (a native id; the calling thread by default):
    the thread the work belongs to."""
    rec = _recorder
    if rec is not None:
        rec.add((name, threading.get_native_id() if thread is None else thread,
                 t0_ns, t1_ns, attrs))


def start() -> None:
    """Turn the process's recorder on, anchored on the calling thread
    (see the module's docstring)."""
    global _recorder
    from torch.profiler import record_function

    if _recorder is not None:
        raise RuntimeError("the span recorder is already on")
    rec = _Recorder(MAX_RECORDS)
    with record_function(CLOCK):
        # the range's end is stamped as it closes: closer to this stamp
        # than its start, which a thread's first range delays
        rec.anchor_ns = time.perf_counter_ns()
    _recorder = rec


def stop() -> Trace:
    """Turn the recorder off -> what it recorded."""
    global _recorder
    rec = _recorder
    if rec is None:
        raise RuntimeError("the span recorder is not on")
    _recorder = None
    return Trace(rec.close(), rec.anchor_ns, rec.dropped, rec.threads)


RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _tracks(trace: Trace, own: int, runtime_tids: set) -> dict:
    """native id -> the Chrome export's track for each thread that
    recorded, the profiler having run on thread `own`: the track of the
    thread's CUDA runtime calls where the export holds one, else its
    native id (the track torch gives a thread's own CPU ops). On an H100
    (torch 2.11) a thread's calls sit on the system id that the profiler
    stored for its pthread when it saw the thread record CPU ops (the
    profiler's own thread; any thread under an earlier run with
    profile_all_threads), else on the low 32 bits of its ident, read as
    a signed int and written without the sign. The stored ids outlive
    the run and the thread, so a later thread given the same pthread
    id has its calls on a dead thread's track; its spans then stay on
    its native id."""
    out = {}
    for nid, (ident, _) in trace.threads.items():
        low = ident & 0xFFFFFFFF
        bits = (1 << 32) - low if low >= 1 << 31 else low
        out[nid] = bits if nid != own and bits in runtime_tids else nid
    return out


def _chrome_events(trace: Trace, clock_end_us: float, pid: int, tracks: dict) -> list:
    """The recorder's spans as Chrome trace events on the clock of a
    profiler whose ``longbow.clock`` range ended at clock_end_us (that
    clock's µs), each on its thread's track, and each such track named."""
    off = clock_end_us - trace.anchor_ns / 1e3
    events = [{"ph": "X", "cat": "longbow", "name": name, "pid": pid,
               "tid": tracks.get(tid, tid), "ts": t0 / 1e3 + off,
               "dur": (t1 - t0) / 1e3, "args": attrs}
              for name, tid, t0, t1, attrs in trace.records]
    return events + [{"ph": "M", "name": "thread_name", "pid": pid,
                      "tid": tracks[tid], "args": {"name": name}}
                     for tid, (_, name) in trace.threads.items()]


def add_spans(path: str | Path, trace: Trace, own: int) -> None:
    """Write the recorder's spans into the Chrome trace that a profiler
    started on thread `own` (a native id) exported to `path`, on that
    profiler's clock by the anchor."""
    path = Path(path)
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    clock = next((e for e in events if e.get("name") == CLOCK and e.get("ph") == "X"), None)
    if clock is None:
        raise RuntimeError("the profiler recorded no clock anchor")
    runtime = {e.get("tid") for e in events if e.get("cat") in RUNTIME_CATS}
    events += _chrome_events(trace, clock["ts"] + clock["dur"], os.getpid(),
                             _tracks(trace, own, runtime))
    path.write_text(json.dumps(doc))


@contextlib.contextmanager
def device_trace(out_dir: str | Path):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    with the span recorder on, and write one Chrome trace, trace.json,
    into out_dir: the profiler's events and the program's spans on its
    clock, a track a thread. Yields out_dir."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        start()
        try:
            yield str(out)
        finally:
            spans = stop()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    add_spans(path, spans, threading.get_native_id())


def annotate(name: str):
    """A named region in device traces (torch.profiler.record_function)."""
    from torch.profiler import record_function

    return record_function(name)
