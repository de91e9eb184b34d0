"""longbow_tpu_torch's serving middleware against longbow_tpu's, class by
class: the same call sequence goes to both, with time.monotonic patched
to one fake clock in both modules, and every answer must be EQUAL (the
state machines are copies; nothing is rounded). Admission refusals are
the port's UnavailableError where longbow_tpu raises
FlightUnavailableError, with the same message; the binding's mapping
turns one into the other.
"""
import types

import pyarrow.flight as flight
import pytest

from longbow_tpu.serving import middleware as jmw
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.serving import middleware as tmw
from longbow_tpu_torch.serving.errors import UnavailableError
from longbow_tpu_torch.serving.flight_server import _flight_error


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    monkeypatch.setattr(jmw, "time", fake)
    monkeypatch.setattr(tmw, "time", fake)
    return c


# (seconds to advance, calls) sequences shared by the limiter tests
_STEPS = [(0.0, 5), (0.1, 3), (0.5, 4), (2.0, 6), (0.01, 2), (10.0, 12)]


@pytest.mark.parametrize("rps,burst", [(0.0, 0), (1.0, 0), (4.0, 2), (2.5, 5), (100.0, 1)])
def test_rate_limiter_same_decisions(clock, rps, burst):
    a, b = jmw.RateLimiter(rps, burst), tmw.RateLimiter(rps, burst)
    assert a.burst == b.burst
    got, want = [], []
    for dt, calls in _STEPS:
        clock.t += dt
        for _ in range(calls):
            want.append(a.allow())
            got.append(b.allow())
    assert got == want
    assert True in got and (rps <= 0 or False in got)


def test_peer_rate_limiter_same_decisions_and_bounded(clock, monkeypatch):
    for peer in ("ipv4:10.0.0.9:5432", "ipv6:[::1]:5432", "unix:/tmp/data.sock", "x"):
        assert tmw.PeerRateLimiter.peer_ip(peer) == jmw.PeerRateLimiter.peer_ip(peer)
    a, b = jmw.PeerRateLimiter(rps=1.0, burst=2), tmw.PeerRateLimiter(rps=1.0, burst=2)
    peers = ["ipv4:1.1.1.1:10", "ipv4:2.2.2.2:10", "ipv4:1.1.1.1:9999", "", "ipv6:[::1]:1"]
    got, want = [], []
    for dt, calls in _STEPS:
        clock.t += dt
        for j in range(calls):
            p = peers[j % len(peers)]
            want.append(a.allow(p))
            got.append(b.allow(p))
    assert got == want
    # the LRU cap bounds the table under a scan of spoofed peers
    monkeypatch.setattr(jmw.PeerRateLimiter, "MAX_PEERS", 64)
    monkeypatch.setattr(tmw.PeerRateLimiter, "MAX_PEERS", 64)
    a, b = jmw.PeerRateLimiter(rps=100.0, burst=1), tmw.PeerRateLimiter(rps=100.0, burst=1)
    for i in range(100):
        p = f"ipv4:10.0.{i // 256}.{i % 256}:1"
        assert a.allow(p) == b.allow(p)
    assert list(b._buckets) == list(a._buckets) and len(b._buckets) == 64


def test_circuit_breaker_same_states(clock):
    a = jmw.CircuitBreaker(threshold=3, cooldown_s=30.0, name="t")
    b = tmw.CircuitBreaker(threshold=3, cooldown_s=30.0, name="t")
    reg = get_registry()
    opened0 = reg.counter("longbow_store_circuit_breaker_state_changes_total",
                          ("name", "from", "to")).labels(**{"name": "t", "from": "closed",
                                                           "to": "open"}).value
    script = ["f", "f", "s", "f", "f", "f", "+10", "+25", "f", "+31", "s",
              "f", "f", "f", "+31", "f", "+29", "+2"]
    states = []
    for step in script:
        if step == "f":
            a.record_failure()
            b.record_failure()
        elif step == "s":
            a.record_success()
            b.record_success()
        else:
            clock.t += float(step)
        states.append((a.state, a.allow(), b.state, b.allow()))
    assert all(s[0] == s[2] and s[1] == s[3] for s in states), states
    assert {s[0] for s in states} == {"closed", "open", "half-open"}
    opened = reg.counter("longbow_store_circuit_breaker_state_changes_total",
                         ("name", "from", "to")).labels(**{"name": "t", "from": "closed",
                                                          "to": "open"}).value
    assert opened - opened0 == 2  # closed -> open twice in the script


def test_bulkhead_same_counts():
    a = jmw.Bulkhead(max_concurrent=2, max_wait_s=0.01)
    b = tmw.Bulkhead(max_concurrent=2, max_wait_s=0.01)
    seq = ["a", "a", "a", "r", "a", "a", "r", "r", "a"]
    for op in seq:
        if op == "a":
            assert a.acquire() == b.acquire()
        else:
            a.release()
            b.release()
    assert a.stats() == b.stats() and b.stats()["rejected_total"] == 2
    assert tmw.Bulkhead(max_concurrent=0).acquire()


def test_fallback_cache_same_entries(clock):
    a = jmw.FallbackCache(ttl_s=5.0, max_entries=3)
    b = tmw.FallbackCache(ttl_s=5.0, max_entries=3)
    for i, key in enumerate("abcdab"):
        clock.t += 1.0
        a.put(key, i)
        b.put(key, i)
    seen = []
    for dt in (0.0, 2.5, 1.0, 3.0):
        clock.t += dt
        for key in "abcd":
            ga, gb = a.get(key), b.get(key)
            assert ga == gb
            seen.append(ga[1])
        assert len(a) == len(b)
    assert True in seen and False in seen


def test_graceful_degradation_same_levels_and_thread():
    a, b = jmw.GracefulDegradation(), tmw.GracefulDegradation()
    assert a.assess() == b.assess() == tmw.DEGRADATION_NONE
    healthy = {n: True for n in "abcdefghij"}

    def mk(n):
        return lambda: {"healthy": healthy[n]}

    def boom():
        raise RuntimeError("a checker that raises counts as failed")

    for n in healthy:
        a.register_check(n, mk(n))
        b.register_check(n, mk(n))
    levels = []
    for failing in ("", "a", "abc", "abcdef", "abcdefghij"):
        for n in healthy:
            healthy[n] = n not in failing
        levels.append(b.assess())
        assert levels[-1] == a.assess()
    assert levels == [0, 1, 2, 3, 4]
    a.register_check("x", boom)
    b.register_check("x", boom)
    assert a.assess() == b.assess()
    for lvl in range(5):
        a.set_level(lvl)
        b.set_level(lvl)
        assert a.search_policy() == b.search_policy()
        sa, sb = a.stats(), b.stats()
        assert sa["current_level"] == sb["current_level"]
        assert sa["health_checks"] == sb["health_checks"]
    assert tmw.DEGRADATION_NAMES == jmw.DEGRADATION_NAMES
    # the assessment thread: started, moves the level, stops when asked
    for n in healthy:
        healthy[n] = True
    b.set_level(tmw.DEGRADATION_CRITICAL)
    b._checks.pop("x")
    b.start(interval_s=0.01)
    try:
        import time

        t0 = time.monotonic()
        while b.level != tmw.DEGRADATION_NONE and time.monotonic() - t0 < 10.0:
            time.sleep(0.01)
        assert b.level == tmw.DEGRADATION_NONE
    finally:
        b.stop()
    assert not b._thread.is_alive()


def _refusal(chain, op, peer=""):
    """The message of admit()'s refusal, or None when admitted."""
    try:
        chain.admit(op, peer=peer)
    except (UnavailableError, flight.FlightUnavailableError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw,script", [
    ({"rate_limit_rps": 2.0, "rate_limit_burst": 2}, "aaaa+aa"),
    ({"breaker_threshold": 2, "breaker_cooldown_s": 5.0}, "afafa+as"),
    ({"bulkhead_max_concurrent": 1, "bulkhead_max_wait_s": 0.01}, "aarar"),
    ({"ip_rate_limit_rps": 1.0, "ip_rate_limit_burst": 1}, "aPaP+aP"),
])
def test_middleware_chain_same_admissions(clock, kw, script):
    a, b = jmw.MiddlewareChain(**kw), tmw.MiddlewareChain(**kw)
    peer = "ipv4:9.9.9.9:1"
    for step in script:
        if step in "aP":
            p = peer if step == "P" else "ipv4:8.8.8.8:1"
            ra, rb = _refusal(a, "DoGet", p), _refusal(b, "DoGet", p)
            if ra is None:
                assert rb is None
            else:
                assert ra == ("FlightUnavailableError", rb[1])
                assert rb[0] == "UnavailableError"
        elif step == "r":
            a.release("DoGet")
            b.release("DoGet")
        elif step == "f":
            a.record_failure("DoGet")
            b.record_failure("DoGet")
        elif step == "s":
            a.record_success("DoGet")
            b.record_success("DoGet")
        else:
            clock.t += 10.0
    assert a.breaker.state == b.breaker.state


def test_refusal_maps_to_the_reference_flight_error():
    mw = tmw.MiddlewareChain(rate_limit_rps=1.0, rate_limit_burst=1)
    mw.admit("DoGet")
    with pytest.raises(UnavailableError) as ei:
        mw.admit("DoGet")
    err = _flight_error(ei.value)
    assert isinstance(err, flight.FlightUnavailableError)
    assert str(err) == str(flight.FlightUnavailableError("rate limit exceeded"))
