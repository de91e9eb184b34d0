"""The metric arithmetic: pure functions of what a run recorded.

Imports numpy only.
"""
from __future__ import annotations

import numpy as np


def window_rate(done: np.ndarray, ok: np.ndarray, per_request: int, seconds: float) -> float:
    """Work answered in the window over its length: every request that
    came back within [0, seconds], times its queries."""
    done, ok = np.asarray(done, float), np.asarray(ok, bool)
    return float((ok & (done <= seconds)).sum()) * per_request / seconds


def union_seconds(intervals: np.ndarray, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    iv = np.clip(np.asarray(intervals, float).reshape(-1, 2), lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if len(iv) == 0:
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    total, cur_s, cur_e = 0.0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return total + (cur_e - cur_s)


def idle_gaps(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The [start, end) gaps in [lo, hi) that no interval covers."""
    iv = np.clip(np.asarray(intervals, float).reshape(-1, 2), lo, hi)
    iv = iv[np.argsort(iv[:, 0], kind="stable")] if len(iv) else iv
    gaps, cur = [], lo
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return np.array(gaps, float).reshape(-1, 2)


def attribute(gaps: np.ndarray, host: list, top: int = 10, scan: int = 256) -> list:
    """Idle seconds by what the host was doing when each gap began: the
    innermost host interval (name, start, end) open at that time, else
    "no traced host op". -> the `top` largest [name, seconds]."""
    host = sorted(host, key=lambda h: h[1])
    starts = np.array([h[1] for h in host], float)
    by: dict = {}
    for g0, g1 in np.asarray(gaps, float).reshape(-1, 2):
        name = "no traced host op"
        i = int(np.searchsorted(starts, g0, side="right")) - 1
        for j in range(i, max(i - scan, -1), -1):
            if host[j][2] > g0:
                name = host[j][0]
                break
        by[name] = by.get(name, 0.0) + (g1 - g0)
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:top]]


def top_by_name(events: list, top: int = 10) -> list:
    """Device seconds summed by name, the `top` largest [name, seconds]."""
    by: dict = {}
    for name, s, e in events:
        by[name] = by.get(name, 0.0) + (e - s)
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:top]]


def per_second(done: np.ndarray, seconds: float, per_request: int) -> list:
    """Work answered in each whole second of the window."""
    edges = np.arange(0, int(np.ceil(seconds)) + 1)
    return (np.histogram(np.asarray(done, float), edges)[0] * per_request).tolist()
