"""What a span of utils/tracing.py costs, on the host.

    python3 -m longbow_tpu_torch.tools.span_cost [--calls N]

Prints one JSON object: µs a call (the least of 5 repeats) of an empty
function, of ``span`` and ``interval`` with the recorder off and on (a
span with and without two attributes), of ``recording()``, and of a
``record_function`` range with no profiler running, which is what a
span would cost were it a profiler range; with the Python version and
the processor. Needs no card.
"""
from __future__ import annotations

import argparse
import json
import platform
import timeit

from torch.profiler import record_function

from longbow_tpu_torch.utils import tracing


def per_call_us(fn, calls: int) -> float:
    return min(timeit.repeat(fn, number=calls, repeat=5)) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200_000)
    args = ap.parse_args(argv)
    n = args.calls

    def empty():
        pass

    def bare():
        with tracing.span("longbow.cost"):
            pass

    def attrs():
        with tracing.span("longbow.cost", requests=3, rows=100):
            pass

    def interval():
        tracing.interval("longbow.cost", 0, 1)

    def profiler_range():
        with record_function("longbow.cost"):
            pass

    out = {"python": platform.python_version(),
           "processor": platform.processor() or platform.machine(),
           "empty_call_us": per_call_us(empty, n),
           "recording_us": per_call_us(tracing.recording, n),
           "off": {"span_us": per_call_us(bare, n), "span_attrs_us": per_call_us(attrs, n),
                   "interval_us": per_call_us(interval, n)}}
    on = max(n // 4, 1)  # the buffer holds MAX_RECORDS; the oldest go beyond
    tracing.start()
    try:
        out["on"] = {"span_us": per_call_us(bare, on), "span_attrs_us": per_call_us(attrs, on),
                     "interval_us": per_call_us(interval, on)}
    finally:
        out["on"]["dropped"] = tracing.stop().dropped
    out["record_function_no_profiler_us"] = per_call_us(profiler_range, max(n // 10, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
