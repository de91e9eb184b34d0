"""Admission control + resilience kit: token-bucket rate limiting,
circuit breaker, bulkhead, graceful degradation levels, fallback cache.

Counterpart of longbow_tpu/serving/middleware.py, the same classes and
state machines. admit() raises serving/errors.py's UnavailableError (no
pyarrow here); the Flight binding turns it into FlightUnavailableError
with the same message.

reference: limiter/limiter.go:15-21 (RATE_LIMIT_RPS/BURST token
bucket), middleware/circuit_breaker.go:15 (trips after 10 consecutive
failures, 30s cooldown), resilience/circuit_breaker.go,
resilience/bulkhead.go (bounded concurrency semaphore),
resilience/graceful_degradation.go:30-250 (health-driven levels +
fallback strategies + TTL fallback cache).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from longbow_tpu_torch.serving.errors import UnavailableError


class RateLimiter:
    """Token bucket; rps<=0 disables (reference default)."""

    def __init__(self, rps: float = 0.0, burst: int = 0):
        self.rps = rps
        if rps > 0:
            self.burst = burst if burst > 0 else max(int(rps), 1)
        else:
            self.burst = 0
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        if self.rps <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rps
            )
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class PeerRateLimiter:
    """Per-client-IP token buckets (reference:
    security/input_sanitizer.go:25 CheckRateLimit(ip) — that map grows
    without bound; here buckets are LRU-capped so a scan of spoofed
    peers can't exhaust memory). rps<=0 disables."""

    MAX_PEERS = 4096

    def __init__(self, rps: float = 0.0, burst: int = 0):
        self.rps = rps
        self.burst = (
            (burst if burst > 0 else max(int(rps), 1)) if rps > 0 else 0
        )
        self._buckets: dict[str, list[float]] = {}  # ip -> [tokens, last]
        self._lock = threading.Lock()

    @staticmethod
    def peer_ip(peer: str) -> str:
        """'ipv4:1.2.3.4:55' / 'ipv6:[::1]:55' / 'unix:/p.sock' -> host."""
        if peer.startswith("ipv6:"):
            body = peer[5:]
            return body[1:body.index("]")] if "[" in body else body
        if peer.startswith("ipv4:"):
            return peer[5:].rsplit(":", 1)[0]
        return peer  # unix sockets etc: one bucket per address

    def allow(self, peer: str) -> bool:
        if self.rps <= 0 or not peer:
            return True
        ip = self.peer_ip(peer)
        now = time.monotonic()
        with self._lock:
            b = self._buckets.pop(ip, None)  # pop+reinsert = LRU order
            if b is None:
                if len(self._buckets) >= self.MAX_PEERS:
                    oldest = next(iter(self._buckets))
                    del self._buckets[oldest]
                b = [float(self.burst), now]
            tokens = min(self.burst, b[0] + (now - b[1]) * self.rps)
            ok = tokens >= 1.0
            self._buckets[ip] = [tokens - 1.0 if ok else tokens, now]
            return ok


class CircuitBreaker:
    """CLOSED -> OPEN after `threshold` consecutive failures; half-open
    retry after `cooldown_s` (reference: middleware/circuit_breaker.go:15
    — 10 failures, 30s cooldown)."""

    def __init__(
        self, threshold: int = 10, cooldown_s: float = 30.0,
        name: str = "default",
    ):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self._failures = 0
        self._opened_at = 0.0
        self._last_state = "closed"
        self._lock = threading.Lock()

    def _metric(self, which: str, **labels) -> None:
        try:
            from longbow_tpu_torch.metrics import get_registry

            get_registry().inc(which, **labels)
        except Exception:
            pass

    def _observe_state(self, new: str) -> None:
        # called under self._lock
        if new != self._last_state:
            self._metric(
                "longbow_store_circuit_breaker_state_changes_total",
                **{"name": self.name, "from": self._last_state, "to": new},
            )
            self._last_state = new

    @property
    def state(self) -> str:
        with self._lock:
            if self._failures < self.threshold:
                s = "closed"
            elif time.monotonic() - self._opened_at >= self.cooldown_s:
                s = "half-open"
            else:
                s = "open"
            self._observe_state(s)
            return s

    def allow(self) -> bool:
        if self.state != "open":
            return True
        self._metric("longbow_store_circuit_breaker_rejections_total")
        return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._observe_state("closed")
        self._metric("longbow_store_circuit_breaker_successes_total")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self.threshold:
                # >= not ==: a failed half-open probe (failures past
                # the threshold) must RE-open for a fresh cooldown, or
                # the breaker sticks half-open forever and every call
                # pays the full timeout against a dead peer
                self._opened_at = time.monotonic()
                self._observe_state("open")
        self._metric("longbow_store_circuit_breaker_failures_total")


class Bulkhead:
    """Bounded concurrent executions (reference: resilience/bulkhead.go
    — a named semaphore capping in-flight work so one slow operation
    class can't exhaust every server thread). max_concurrent<=0
    disables. A saturated bulkhead waits up to `max_wait_s` for a slot,
    then rejects."""

    def __init__(self, max_concurrent: int = 0, max_wait_s: float = 0.2):
        self.max_concurrent = max_concurrent
        self.max_wait_s = max_wait_s
        self._sem = (
            threading.Semaphore(max_concurrent)
            if max_concurrent > 0
            else None
        )
        self._in_flight = 0
        self._rejected = 0
        self._lock = threading.Lock()

    def acquire(self) -> bool:
        if self._sem is None:
            return True
        ok = self._sem.acquire(timeout=self.max_wait_s)
        with self._lock:
            if ok:
                self._in_flight += 1
            else:
                self._rejected += 1
        return ok

    def release(self) -> None:
        if self._sem is None:
            return
        with self._lock:
            self._in_flight -= 1
        self._sem.release()

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_concurrent": self.max_concurrent,
                "in_flight": self._in_flight,
                "rejected_total": self._rejected,
            }


# Degradation levels (reference: resilience/graceful_degradation.go:12-18)
DEGRADATION_NONE = 0
DEGRADATION_MINIMAL = 1
DEGRADATION_MODERATE = 2
DEGRADATION_SEVERE = 3
DEGRADATION_CRITICAL = 4
DEGRADATION_NAMES = ("none", "minimal", "moderate", "severe", "critical")


class FallbackCache:
    """TTL cache of last-good results, served when degraded (reference:
    resilience/graceful_degradation.go FallbackCache). Separate from
    the QueryCache: entries here deliberately outlive writes — stale
    answers beat no answers once the engine is unhealthy."""

    def __init__(self, ttl_s: float = 300.0, max_entries: int = 4096):
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self._d: dict[str, tuple[float, Any]] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> tuple[Any, bool]:
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                return None, False
            exp, val = hit
            if time.monotonic() > exp:
                del self._d[key]
                return None, False
            return val, True

    def put(self, key: str, val: Any) -> None:
        with self._lock:
            if len(self._d) >= self.max_entries and key not in self._d:
                # drop the entry closest to expiry
                oldest = min(self._d, key=lambda k: self._d[k][0])
                del self._d[oldest]
            self._d[key] = (time.monotonic() + self.ttl_s, val)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class GracefulDegradation:
    """Health-driven degradation levels (reference:
    resilience/graceful_degradation.go:30-250). Health checks return
    dicts with a "healthy" bool (the HealthManager checker convention);
    the failure rate maps to a level with the reference's thresholds
    (0 -> none, <=10% -> minimal, <=30% -> moderate, <=60% -> severe,
    else critical). The serving edge consults `search_policy()` to shed
    work: moderate drops graph re-rank, severe serves stale fallback
    results when available, critical serves ONLY cached results."""

    def __init__(self):
        self._checks: dict[str, Callable[[], dict]] = {}
        self._level = DEGRADATION_NONE
        self._degraded_since = 0.0
        self._last_change = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register_check(self, name: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._checks[name] = fn

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def set_level(self, level: int) -> None:
        with self._lock:
            if level != self._level:
                self._level = level
                self._last_change = time.monotonic()
                if level > DEGRADATION_NONE and not self._degraded_since:
                    self._degraded_since = time.monotonic()
                elif level == DEGRADATION_NONE:
                    self._degraded_since = 0.0

    def assess(self) -> int:
        with self._lock:
            checks = dict(self._checks)
        if not checks:
            return DEGRADATION_NONE
        failed = 0
        for fn in checks.values():
            try:
                r = fn()
                if not r.get("healthy", False):
                    failed += 1
            except Exception:
                failed += 1
        rate = failed / len(checks)
        if rate == 0:
            return DEGRADATION_NONE
        if rate <= 0.1:
            return DEGRADATION_MINIMAL
        if rate <= 0.3:
            return DEGRADATION_MODERATE
        if rate <= 0.6:
            return DEGRADATION_SEVERE
        return DEGRADATION_CRITICAL

    def start(self, interval_s: float = 5.0) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                self.set_level(self.assess())

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def search_policy(self) -> dict:
        lvl = self.level
        return {
            "level": lvl,
            "level_name": DEGRADATION_NAMES[lvl],
            "allow_graph_rerank": lvl < DEGRADATION_MODERATE,
            "allow_hybrid": lvl < DEGRADATION_SEVERE,
            "serve_stale": lvl >= DEGRADATION_SEVERE,
            "cached_only": lvl >= DEGRADATION_CRITICAL,
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "current_level": DEGRADATION_NAMES[self._level],
                "degraded_since": self._degraded_since or None,
                "health_checks": len(self._checks),
            }


class MiddlewareChain:
    """The serving edge's interceptor chain
    (reference: cmd/longbow/main.go:448-458 CircuitBreaker -> RateLimit
    -> PartitionProxy; partition proxying is obsolete here — sharding
    lives inside the device mesh). Order: breaker -> rate limit ->
    bulkhead (last, so a rejected request never holds a slot)."""

    def __init__(
        self,
        rate_limit_rps: float = 0.0,
        rate_limit_burst: int = 0,
        breaker_threshold: int = 10,
        breaker_cooldown_s: float = 30.0,
        bulkhead_max_concurrent: int = 0,
        bulkhead_max_wait_s: float = 0.2,
        ip_rate_limit_rps: float = 0.0,
        ip_rate_limit_burst: int = 0,
    ):
        self.limiter = RateLimiter(rate_limit_rps, rate_limit_burst)
        self.peer_limiter = PeerRateLimiter(
            ip_rate_limit_rps, ip_rate_limit_burst
        )
        self.breaker = CircuitBreaker(
            breaker_threshold, breaker_cooldown_s, name="flight"
        )
        self.bulkhead = Bulkhead(bulkhead_max_concurrent, bulkhead_max_wait_s)
        self.degradation: Optional[GracefulDegradation] = None
        self.fallback: Optional[FallbackCache] = None

    def admit(self, op: str, peer: str = "") -> None:
        if not self.breaker.allow():
            raise UnavailableError(
                f"circuit breaker open for {op}"
            )
        if not self.limiter.allow():
            raise UnavailableError("rate limit exceeded")
        if not self.peer_limiter.allow(peer):
            raise UnavailableError(
                "per-client rate limit exceeded"
            )
        if not self.bulkhead.acquire():
            raise UnavailableError(
                f"bulkhead saturated for {op}"
            )

    def release(self, op: str) -> None:
        """Release the bulkhead slot taken by a successful admit()."""
        self.bulkhead.release()

    def record_failure(self, op: str) -> None:
        self.breaker.record_failure()

    def record_success(self, op: str) -> None:
        self.breaker.record_success()
