"""Cluster membership + failure detection over the Flight control
plane.

Counterpart of longbow_tpu/distributed/membership.py (a copy).

The reference runs a hand-rolled SWIM protocol over UDP with indirect
pings and piggybacked membership updates (reference: mesh/gossip.go:
16-235, member model mesh/member.go:18, discovery mesh/discovery*.go).
This package keeps the protocol's rules (indirect probes through K
relays, piggybacked digests, incarnations) but probes over the same
gRPC/Flight channel the data plane uses: at the cluster sizes this
search tier runs at (units of nodes, each fronting an accelerator),
O(N) direct probing every period is cheaper than maintaining a UDP
stack, and the failure-detection semantics the rest of the system
needs — alive / suspect / dead with incarnation counters — are
preserved. Discovery modes (reference: mesh/discovery*.go): static
peers, a DNS name resolved per probe round, or Kubernetes endpoints
polled from the API server. Members carry an optional region label
(reference: mesh/region.go region-aware member grouping) used to order
fan-out and replication toward same-region peers first.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("longbow.membership")

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


def parse_peer(spec: str) -> tuple[str, int, int, str]:
    """'host:data[:meta][@region]' -> (host, data_port, meta_port,
    region); meta defaults to data+1 (reference convention:
    :3000/:3001), region defaults to ''."""
    spec = spec.strip()
    region = ""
    if "@" in spec:
        spec, region = spec.rsplit("@", 1)
    parts = spec.rsplit(":", 2)
    if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
        return parts[0], int(parts[1]), int(parts[2]), region
    host, port = spec.rsplit(":", 1)
    return host, int(port), int(port) + 1, region


@dataclass
class Member:
    """reference: mesh/member.go:18 Member{ID,Addr,Status,Incarnation};
    region label per mesh/region.go."""

    id: str
    host: str
    data_port: int
    meta_port: int
    status: str = ALIVE
    incarnation: int = 0
    last_seen: float = field(default_factory=time.time)
    misses: int = 0
    region: str = ""

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.data_port}"

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "addr": self.addr,
            "status": self.status,
            "incarnation": self.incarnation,
            "last_seen": self.last_seen,
            "region": self.region,
        }


class MembershipManager:
    """Probes peers each protocol period; drives alive->suspect->dead
    transitions (reference suspicion flow: gossip.go:170-235 probe ->
    suspect -> dead after timeout). Notifies subscribers on state
    change (the reference's EventDelegate, sharding/manager.go:11-99).
    """

    def __init__(
        self,
        self_id: str,
        peers: list[str],
        *,
        probe_interval_s: float = 1.0,
        suspect_after: int = 2,
        dead_after: int = 5,
        probe_timeout_s: float = 2.0,
        dns_name: Optional[str] = None,
        k8s_service: Optional[str] = None,
        self_region: str = "",
        lan_group: Optional[str] = None,
        advertise_host: str = "",
        indirect_k: int = 3,
        digest_every: int = 5,
    ):
        self.self_id = self_id
        self.self_region = self_region
        # SWIM indirect probing (reference: mesh/gossip.go:235 — on a
        # failed direct ping, ask K=3 relay peers to probe the target):
        # under an asymmetric partition (self cannot reach B but C
        # reaches both) B must NOT be marked suspect/dead. probe_action
        # is the transport hook — the cluster coordinator injects a
        # Flight `gossip-probe` DoAction call; None = direct-only
        # (single transport keeps this module client-free and lets
        # tests inject loss).
        self.indirect_k = indirect_k
        self.probe_action: Optional[
            Callable[["Member", dict], Optional[dict]]
        ] = None
        # piggybacked dissemination (reference: gossip.go:493-559 —
        # membership updates ride probe packets): every digest_every-th
        # round the direct probe also exchanges membership digests, and
        # every indirect-probe request/response carries one.
        self.digest_every = max(int(digest_every), 1)
        self._round = 0
        self.self_incarnation = 0
        self.probe_interval_s = probe_interval_s
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.probe_timeout_s = probe_timeout_s
        # DNS discovery (reference: mesh/discovery*.go DNS mode):
        # "name:data_port[:meta_port]" re-resolved every probe round so
        # scale-ups/downs of a headless service are picked up live
        self.dns_name = dns_name
        # Kubernetes discovery (reference: mesh/discovery k8s pods +
        # pod_parser.go): "service:data_port[:meta_port]" — endpoints
        # polled from the API server each probe round
        self.k8s_service = k8s_service
        # LAN zero-config discovery (reference: mesh/discovery mDNS via
        # zeroconf): "group:port" — nodes announce themselves on a UDP
        # multicast group each probe round and fold in what they hear
        self.lan_group = lan_group
        self.advertise_host = advertise_host
        self._lan_sock = None
        if lan_group:
            self._lan_open()
        self.members: dict[str, Member] = {}
        for spec in peers:
            h, dp, mp, region = parse_peer(spec)
            mid = f"{h}:{dp}"
            if mid != self_id:
                self.members[mid] = Member(mid, h, dp, mp, region=region)
        self._subs: list[Callable[[Member], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _is_self(self, host: str, dp: int) -> bool:
        """True when a discovered address is THIS node. self_id alone
        is not enough: it may be the bind form ('0.0.0.0:3000') or a
        hostname while discovery returns the pod IP — registering self
        as a peer makes every write re-put to itself (tombstone churn)
        and inflates quorum counts."""
        if f"{host}:{dp}" == self.self_id:
            return True
        self_port = self.self_id.rsplit(":", 1)[-1]
        if not self_port.isdigit() or int(self_port) != dp:
            return False
        try:
            local = {"127.0.0.1", "::1", "localhost"}
            hostname = socket.gethostname()
            local.add(hostname)
            local.update(socket.gethostbyname_ex(hostname)[2])
            return host in local
        except OSError:
            return False

    def _add_discovered(self, host: str, dp: int, mp: int, region="") -> None:
        mid = f"{host}:{dp}"
        if not self._is_self(host, dp) and mid not in self.members:
            with self._lock:
                # start SUSPECT: the first successful probe fires
                # the subscriber callbacks (join notification)
                self.members[mid] = Member(
                    mid, host, dp, mp, status=SUSPECT, region=region
                )

    def _discover_dns(self) -> None:
        if not self.dns_name:
            return
        name, dp, mp, region = parse_peer(self.dns_name)
        try:
            infos = socket.getaddrinfo(
                name, dp, proto=socket.IPPROTO_TCP
            )
        except OSError:
            return
        for info in infos:
            self._add_discovered(info[4][0], dp, mp, region)

    def _discover_k8s(self) -> None:
        """Poll the Kubernetes Endpoints API for peer pod IPs
        (reference: mesh/discovery_k8s + pod_parser.go). Uses the
        in-cluster service-account credentials; the API base and token
        path are overridable for tests (LONGBOW_K8S_API / _TOKEN_FILE /
        _NAMESPACE). Pod topology zone labels map to regions."""
        if not self.k8s_service:
            return
        svc, dp, mp, _ = parse_peer(self.k8s_service)
        api = os.environ.get("LONGBOW_K8S_API")
        if not api:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                return
            api = f"https://{host}:{port}"
        ns_file = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"
        ns = os.environ.get("LONGBOW_K8S_NAMESPACE")
        if not ns:
            try:
                with open(ns_file) as f:
                    ns = f.read().strip()
            except OSError:
                ns = "default"
        token_file = os.environ.get(
            "LONGBOW_K8S_TOKEN_FILE",
            "/var/run/secrets/kubernetes.io/serviceaccount/token",
        )
        headers = {}
        try:
            with open(token_file) as f:
                headers["Authorization"] = f"Bearer {f.read().strip()}"
        except OSError:
            pass
        import ssl
        import urllib.request

        url = f"{api}/api/v1/namespaces/{ns}/endpoints/{svc}"
        ctx = None
        if url.startswith("https"):
            ca = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
            if os.path.exists(ca):
                ctx = ssl.create_default_context(cafile=ca)
            elif os.environ.get("LONGBOW_K8S_INSECURE") == "1":
                # explicit test-only opt-out; without it a MITM on the
                # API path could inject "peers" that then receive
                # replicated vector data
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                log.error(
                    "k8s discovery: service-account CA missing at %s; "
                    "refusing unverified https (set LONGBOW_K8S_INSECURE=1 "
                    "to override in tests)", ca,
                )
                return
        try:
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=2.0, context=ctx) as r:
                body = json.loads(r.read())
        except Exception:
            return
        for subset in body.get("subsets") or []:
            for addr in subset.get("addresses") or []:
                region = (addr.get("nodeName") or "").split(".")[0]
                self._add_discovered(addr.get("ip", ""), dp, mp, region)

    # -- probing --------------------------------------------------------

    def _probe_one(self, m: Member) -> bool:
        """TCP connect to the data port — the cheapest liveness signal
        that still exercises the serving socket (a full Flight action
        would be heavier than the reference's 1400B UDP ping)."""
        try:
            with socket.create_connection(
                (m.host, m.data_port), timeout=self.probe_timeout_s
            ):
                return True
        except OSError:
            return False

    def _lan_open(self) -> None:
        import struct

        group, port, _, _ = parse_peer(self.lan_group)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except (AttributeError, OSError):
            pass
        s.bind(("", port))
        mreq = struct.pack(
            "4s4s", socket.inet_aton(group), socket.inet_aton("0.0.0.0")
        )
        s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        # loop multicast back so same-host nodes (and tests) hear it
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        s.setblocking(False)
        self._lan_sock = s
        self._lan_dest = (group, port)

    def _discover_lan(self) -> None:
        """Announce self on the multicast group; fold in peers heard
        (reference: mDNS zeroconf discovery, mesh/discovery*.go)."""
        if self._lan_sock is None:
            return
        try:
            h, dp, mp, _ = parse_peer(self.self_id)
        except (ValueError, IndexError):
            return
        beacon = json.dumps({
            "longbow": 1,
            "id": self.self_id,
            "host": self.advertise_host or h,
            "data_port": dp,
            "meta_port": mp,
            "region": self.self_region,
        }).encode()
        try:
            self._lan_sock.sendto(beacon, self._lan_dest)
        except OSError:
            pass
        for _ in range(64):  # drain what's queued, bounded
            try:
                pkt, _addr = self._lan_sock.recvfrom(2048)
            except (BlockingIOError, OSError):
                break
            try:
                msg = json.loads(pkt)
            except ValueError:
                continue
            if msg.get("longbow") != 1 or msg.get("id") == self.self_id:
                continue
            self._add_discovered(
                msg.get("host", ""), int(msg.get("data_port", 0)),
                int(msg.get("meta_port", 0)), msg.get("region", ""),
            )

    # -- SWIM digests / indirect probes ----------------------------------

    def digest(self) -> list[dict]:
        """Membership digest for piggybacking on probe traffic
        (reference: gossip.go:493-559 packs updates <=1400B; ours ride
        the Flight action body)."""
        try:
            h, dp, mp, _ = parse_peer(self.self_id)
        except (ValueError, IndexError):
            h, dp, mp = self.self_id, 0, 0
        out = [{
            "id": self.self_id,
            "host": self.advertise_host or h,
            "data_port": dp,
            "meta_port": mp,
            "status": ALIVE,
            "incarnation": self.self_incarnation,
            "region": self.self_region,
        }]
        with self._lock:
            for m in self.members.values():
                out.append({
                    "id": m.id, "host": m.host,
                    "data_port": m.data_port, "meta_port": m.meta_port,
                    "status": m.status, "incarnation": m.incarnation,
                    "region": m.region,
                })
        return out

    def merge_digest(self, entries) -> None:
        """Fold a peer's membership digest into the local view.

        Rumor rules (conservative SWIM): unknown members are added
        (discovery); a remote ALIVE with a HIGHER incarnation refutes a
        local suspicion (the relay path heals asymmetric partitions);
        remote SUSPECT/DEAD only degrades a member we ALREADY cannot
        reach (local probes are authoritative for reachability from
        this node — blindly applying remote deads would spread exactly
        the false-positive this machinery exists to prevent)."""
        changed: list[Member] = []
        for e in entries or []:
            mid = e.get("id")
            if not mid:
                continue
            host = e.get("host", "")
            try:
                dp = int(e.get("data_port", 0) or 0)
                mp = int(e.get("meta_port", 0) or 0)
                inc = int(e.get("incarnation", 0))
            except (TypeError, ValueError):
                continue
            if not host or not dp:
                try:
                    host, p = mid.rsplit(":", 1)
                    dp = int(p)
                except ValueError:
                    continue
            if mid == self.self_id or self._is_self(host, dp):
                # SWIM refutation (gossip.go:493-559 alive-rumor rule):
                # only the member itself may originate a higher
                # incarnation. Seeing ourselves rumored SUSPECT/DEAD at
                # our current incarnation, we bump past it — the next
                # digest we piggyback advertises ALIVE@inc+1, which
                # relays carry back to the suspecting node and which
                # its merge (inc > local) accepts as a refutation.
                if e.get("status", ALIVE) != ALIVE and inc >= self.self_incarnation:
                    self.self_incarnation = inc + 1
                continue
            st = e.get("status", SUSPECT)
            with self._lock:
                m = self.members.get(mid)
                if m is None:
                    # new member learned via gossip: starts SUSPECT so
                    # the first successful probe fires the join event
                    self.members[mid] = Member(
                        mid, host, dp, mp or dp + 1, status=SUSPECT,
                        incarnation=inc, region=e.get("region", ""),
                    )
                    continue
                old = m.status
                if inc > m.incarnation:
                    m.incarnation = inc
                    if st == ALIVE and m.status != ALIVE:
                        m.status = ALIVE
                        m.misses = 0
                        m.last_seen = time.time()
                    elif st == DEAD and m.status == SUSPECT:
                        m.status = DEAD
                if m.status != old:
                    changed.append(m)
        for m in changed:
            for cb in self._subs:
                try:
                    cb(m)
                except Exception:
                    pass

    def _indirect_probe(self, target: Member) -> bool:
        """Ask up to indirect_k alive relay peers to probe the target
        on our behalf (reference: gossip.go:235 ping-req via K=3
        relays). Digests ride both directions."""
        if self.probe_action is None:
            return False
        relays = [m for m in self.alive() if m.id != target.id]
        relays = relays[: self.indirect_k]
        payload = {
            "target": f"{target.host}:{target.data_port}",
            "digest": self.digest(),
        }
        try:
            from longbow_tpu_torch.metrics import get_registry

            _reg = get_registry()
        except Exception:
            _reg = None
        for r in relays:
            try:
                resp = self.probe_action(r, payload)
            except Exception:
                resp = None
            if _reg is not None:
                _reg.inc(
                    "longbow_gossip_pings_total", direction="indirect"
                )
            if not resp:
                continue
            self.merge_digest(resp.get("digest"))
            if resp.get("ok"):
                return True
        return False

    def probe_round(self) -> None:
        self._discover_dns()
        self._discover_k8s()
        self._discover_lan()
        self._round += 1
        exchange = (
            self.probe_action is not None
            and self._round % self.digest_every == 0
        )
        try:
            from longbow_tpu_torch.metrics import get_registry

            _reg = get_registry()
        except Exception:
            _reg = None
        for m in list(self.members.values()):
            ok = self._probe_one(m)
            if _reg is not None:
                _reg.inc("longbow_gossip_pings_total", direction="out")
            if ok and exchange:
                # piggyback a membership-digest exchange on the probe
                try:
                    resp = self.probe_action(m, {"digest": self.digest()})
                    if resp:
                        self.merge_digest(resp.get("digest"))
                except Exception:
                    pass
            if not ok:
                ok = self._indirect_probe(m)
            with self._lock:
                old = m.status
                if ok:
                    m.last_seen = time.time()
                    m.misses = 0
                    # NOTE: no local incarnation bump — incarnations are
                    # originated ONLY by the member itself (digest()'s
                    # self entry). A node-local bump would race past the
                    # member's own counter and permanently block the
                    # alive-rumor refutation in merge_digest.
                    m.status = ALIVE
                else:
                    m.misses += 1
                    if m.misses >= self.dead_after:
                        m.status = DEAD
                    elif m.misses >= self.suspect_after:
                        m.status = SUSPECT
                changed = m.status != old
            if changed:
                for cb in self._subs:
                    try:
                        cb(m)
                    except Exception:
                        pass
        if _reg is not None:
            _reg.set(
                "longbow_gossip_active_members",
                sum(
                    1 for m in self.members.values() if m.status == ALIVE
                ),
            )

    def subscribe(self, cb: Callable[[Member], None]) -> None:
        self._subs.append(cb)

    def alive(self) -> list[Member]:
        """Alive members, same-region peers first (reference:
        mesh/region.go region-aware grouping — fan-out and replication
        prefer peers that don't cross a region boundary)."""
        with self._lock:
            live = [m for m in self.members.values() if m.status == ALIVE]
        if self.self_region:
            live.sort(key=lambda m: (m.region != self.self_region, m.id))
        return live

    def status(self) -> dict:
        """reference: 'cluster-status' action payload shape."""
        with self._lock:
            return {
                "self": {
                    "id": self.self_id,
                    "status": ALIVE,
                    "region": self.self_region,
                },
                "members": [m.to_dict() for m in self.members.values()],
            }

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.probe_interval_s):
                try:
                    self.probe_round()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._lan_sock is not None:
            try:
                self._lan_sock.close()
            except OSError:
                pass
