"""Host CPU profiling (the pprof analog).

Counterpart of longbow_tpu/utils/profiling.py (standard library only),
behind the debug mux of metrics/registry.py.

The reference mounts Go's net/http/pprof handlers on its debug mux
(reference: cmd/longbow/main.go:296-300). CPython has no always-on
runtime profiler to expose, so the equivalent here is an on-demand
wall-clock stack sampler over ``sys._current_frames()``: zero overhead
while idle, ~hz stack walks per second only while a profile is being
captured, and no tracing hooks installed (``cProfile``/``settrace``
would slow the serving hot path and only see the calling thread).

Output is collapsed-stack text — one ``frame;frame;frame count`` line
per unique stack — which flamegraph tooling (inferno, speedscope,
flamegraph.pl) ingests directly.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter


def _frame_id(frame) -> str:
    code = frame.f_code
    name = code.co_filename.rsplit("/", 1)[-1]
    return f"{name}:{code.co_name}:{frame.f_lineno}"


def snapshot_stacks() -> dict[str, str]:
    """One stack per live thread, root->leaf, semicolon-joined
    (the goroutine-dump analog: /debug/pprof/threads)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        parts = []
        f = frame
        while f is not None:
            parts.append(_frame_id(f))
            f = f.f_back
        out[names.get(tid, str(tid))] = ";".join(reversed(parts))
    return out


def sample_stacks(seconds: float = 5.0, hz: int = 97) -> str:
    """Sample every live thread's stack for ``seconds`` at ``hz`` and
    return collapsed-stack lines, most-sampled first.

    Wall-clock sampling (py-spy-style): a thread blocked in a syscall
    still shows its stack, which is what you want when diagnosing a
    GIL-bound or IO-bound serving edge. hz defaults to a prime so the
    sampler doesn't phase-lock with periodic work.
    """
    hz = max(1, min(int(hz), 1000))
    period = 1.0 / hz
    deadline = time.monotonic() + max(0.05, float(seconds))
    me = threading.get_ident()
    names = {t.ident: t.name for t in threading.enumerate()}
    counts: Counter = Counter()
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None:
                parts.append(_frame_id(f))
                f = f.f_back
            if not parts:
                continue
            name = names.get(tid)
            if name is None:  # thread started after we began sampling
                names = {
                    t.ident: t.name for t in threading.enumerate()
                }
                name = names.get(tid, str(tid))
            counts[name + ";" + ";".join(reversed(parts))] += 1
        time.sleep(max(0.0, period - (time.monotonic() - t0)))
    return "\n".join(
        f"{stack} {n}" for stack, n in counts.most_common()
    )
