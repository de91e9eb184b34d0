"""Tracing and profiling hooks.

Counterpart of longbow_tpu/utils/tracing.py (reference: OTel
TracerProvider and pprof, cmd/longbow/main.go:291-356,570-588). Device
time is traced by torch.profiler into a Chrome trace (open it in
Perfetto); host spans are a context manager that counts into the
metrics registry.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def device_trace(out_dir: str | Path):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    and write a Chrome trace, trace.json, into out_dir. Yields out_dir."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def span(name: str, registry=None):
    """Host-side span: counts into longbow_trace_spans_total{name} and
    times the block into longbow_tpu_span_duration_seconds{name} when a
    registry is given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if registry is not None:
            registry.inc("longbow_trace_spans_total", name=name)
            registry.observe(
                "longbow_tpu_span_duration_seconds",
                time.perf_counter() - t0,
                name=name,
            )


def annotate(name: str):
    """A named region in device traces (torch.profiler.record_function)."""
    from torch.profiler import record_function

    return record_function(name)
