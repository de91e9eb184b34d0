"""Health manager and its checkers.

Counterpart of longbow_tpu/utils/health.py (reference:
health/health_manager.go, checkers.go:13-140). `HealthManager.check`
is what `MetricsRegistry.health_fn` serves at /healthz.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


class HealthManager:
    def __init__(self):
        self._checkers: dict[str, Callable[[], dict]] = {}

    def register(self, name: str, fn: Callable[[], dict]) -> None:
        self._checkers[name] = fn

    def check(self) -> dict:
        """{"status": "healthy" | "unhealthy", "checks": {name: result},
        "ts"}: unhealthy when any checker says so or raises."""
        out = {"status": "healthy", "checks": {}, "ts": time.time()}
        for name, fn in self._checkers.items():
            try:
                r = fn()
            except Exception as e:  # a failing checker is a finding, not a crash
                r = {"healthy": False, "error": str(e)}
            out["checks"][name] = r
            if not r.get("healthy", False):
                out["status"] = "unhealthy"
        return out


def store_checker(store) -> Callable[[], dict]:
    def check() -> dict:
        r = store.readiness()
        return {"healthy": r["status"] == "READY", **r}

    return check


def storage_checker(store) -> Callable[[], dict]:
    def check() -> dict:
        if store.engine is None:
            return {"healthy": True, "persistence": "disabled"}
        return {
            "healthy": True,
            "wal_bytes": store.engine.wal.size_bytes,
        }

    return check


def device_checker() -> Callable[[], dict]:
    """The CUDA cards this process sees. With none it reports unhealthy:
    the port serves from the card, and a CPU is not one."""

    def check() -> dict:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {
            "healthy": n > 0,
            "devices": [torch.cuda.get_device_name(i) for i in range(n)],
            "count": n,
            "backend": "cuda",
        }

    return check
