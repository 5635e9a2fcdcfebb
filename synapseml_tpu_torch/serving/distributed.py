"""Distributed serving: one listener per rank of a process mesh with a
shared routing table.

The PyTorch port of the JAX package's ``serving/distributed.py``.  The
reference ships one HTTP server per executor JVM and a driver-held
service registry so a front door can reach every partition's server
(reference: DistributedHTTPSource.scala:88,203, HTTPSourceV2 ServiceInfo).
Here every RANK of the gang starts a local
:class:`~synapseml_tpu_torch.serving.server.ServingServer`, and the
routing table is rendezvoused over the process mesh — each rank
contributes its ``(ip, port, role)`` row through an ``all_gather`` over
the ``data`` axis (:func:`exchange_routing_table`), so the same
collective layer that carries training gradients also publishes the
serving topology.  Any rank (or an external balancer) can then route
requests to every replica.

Failover: the gathered table is a *topology*, not a liveness claim — a
replica can die or drain at any time.  :class:`ReplicaRouter` layers the
serving health contract on top: per-replica ``/healthz``+``/readyz``
probes, per-replica circuit breakers (``breaker_for``), and a :meth:`~
ReplicaRouter.route` that round-robins over replicas while skipping
dead/draining/warming ones and NEVER returning a replica whose breaker
is open.  After an elastic gang restart OR RESIZE, :meth:`
DistributedServingServer.refresh_routing_table` re-gathers the table over
the re-formed mesh and rebuilds the router — a shrink/grow is just a
shorter/longer table: the round-robin cursor clamps, departed endpoints
release their process-wide breakers (``drop_breaker``) and probe-gauge
rows, and a departing replica flushes its in-flight exchanges through
:meth:`DistributedServingServer.leave` (the zero-drop ``drain()`` path),
so a resize drops nothing.  Health is exported as
``serving_replicas_healthy{router}``.

Nothing here touches a device but the routing-table gather, whose
int32 rows live on the group's device.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Tuple

from ..resilience import breaker_for, drop_breaker
from ..resilience.faults import get_faults
from ..telemetry import get_registry
from ..telemetry.flight import record as flight_record
from .server import ServingServer

#: replica probe states.  WARMING is the compile plane's pre-ready
#: window (readyz 503 with status "warming"): routable exactly like
#: DRAINING — skipped without a breaker signal — so a resized-in
#: replica absorbs no traffic until its program lattice is warm, and
#: nobody's breaker opens over a replica that is merely compiling.
HEALTHY, DRAINING, DEAD, WARMING = ("healthy", "draining", "dead",
                                    "warming")

#: replica roles a routing table can carry (disaggregated serving:
#: decode replicas hold slots and stream tokens, prefill replicas are
#: compute-bound batch prefillers that hand their K/V off).  The index
#: of a name here is what rides the routing-table collective.
ROLE_NAMES: Tuple[str, ...] = ("decode", "prefill")


def _role_index(role: str) -> int:
    try:
        return ROLE_NAMES.index(role)
    except ValueError:
        raise ValueError(f"unknown replica role {role!r} "
                         f"(expected one of {ROLE_NAMES})")


class RouteResult(NamedTuple):
    """One routing decision, named: every router surface returns THIS
    shape and call sites read fields by name (it still unpacks as
    ``rank, addr, url, ...``).  ``headers`` is only populated by
    :meth:`DistributedServingServer.route_request` (trace/tenant
    propagation) — plain :meth:`~ReplicaRouter.route` fills it with a
    fresh empty dict."""
    #: table index of the routed replica (valid until the next refresh)
    rank: int
    #: the routed ``(host, port)`` captured under the router lock —
    #: hand back to ``report(addr=)`` so the report survives renumbering
    addr: Tuple[str, int]
    #: full request url for the routed replica
    url: str
    #: session-affinity outcome: ``hit`` / ``miss`` / ``repin``
    #: (repin ⇒ the pinned replica was lost: engage failover-restore)
    outcome: str
    #: headers to attach to the forwarded request
    headers: Dict[str, str]


class NoHealthyReplicaError(RuntimeError):
    """Every replica is dead, draining, or breaker-open."""

    def __init__(self, statuses: Dict[int, str]):
        super().__init__(
            "no routable replica: " + ", ".join(
                f"rank {r}: {s}" for r, s in sorted(statuses.items())))
        self.statuses = dict(statuses)


def _encode_addr(host: str, port: int) -> Tuple[int, int]:
    """(ip4 as uint32, port) — what rides the collective."""
    packed = struct.unpack("!I", socket.inet_aton(socket.gethostbyname(host)))
    return int(packed[0]), int(port)


def _decode_addr(ip_u32: int, port: int) -> Tuple[str, int]:
    return socket.inet_ntoa(struct.pack("!I", int(ip_u32) & 0xffffffff)), \
        int(port)


def exchange_routing_table(host: str, port: int,
                           deadline=None,
                           timeout_s: Optional[float] = None,
                           role: int = 0, device="cuda"
                           ) -> Tuple[List[Tuple[str, int]], List[int]]:
    """All-gather this rank's listener address over the ``data`` axis of
    the process mesh → ``([(host, port)], [role])`` indexed by rank.
    ``role`` is this rank's :data:`ROLE_NAMES` index (0 = decode),
    gathered alongside the address so a disaggregated deployment
    publishes WHICH pool each listener belongs to through the same
    collective.  A single process, or one with no process group: the
    local address and role alone (no collective).

    The gather runs over every rank of the initialized group
    (:func:`~synapseml_tpu_torch.parallel.data_parallel_mesh` on
    ``device``): one ``(ip_hi, ip_lo, port, rank, role)`` int32 row a
    rank, so the backend is the group's own — gloo over CPU tensors,
    gloo over CUDA tensors where ranks share a card, nccl where each
    has its own.  ``deadline``/``timeout_s`` bound the gather itself:
    when a peer died mid-restart the collective would block forever, and
    the bound turns that into a :class:`~synapseml_tpu_torch.parallel.
    collectives.CollectiveTimeout` the gang supervisor handles."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..parallel.collectives import all_gather
    from ..parallel.mesh import DATA_AXIS, data_parallel_mesh

    resolve_device(device)          # no card: raises unless "cpu"
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return [(host, port)], [int(role)]
    mesh = data_parallel_mesh(device=device)
    ip_u32, port_i = _encode_addr(host, port)
    # int32 collective: the ip splits into 16-bit halves (each fits int32
    # unmasked — masking bit 31 would corrupt addresses >= 128.0.0.0)
    row = torch.tensor([[ip_u32 >> 16, ip_u32 & 0xffff, port_i,
                         dist.get_rank(), int(role)]], dtype=torch.int32,
                       device=mesh.device)
    limit = deadline.limit(timeout_s) if deadline is not None else timeout_s
    gathered = all_gather(row, mesh, DATA_AXIS, tiled=True,
                          timeout_s=limit)
    by_rank: Dict[int, Tuple[Tuple[str, int], int]] = {}
    for hi, lo, p_port, rank, p_role in gathered.cpu().tolist():
        ip = (int(hi) << 16) | (int(lo) & 0xffff)
        by_rank[int(rank)] = (_decode_addr(ip, p_port), int(p_role))
    ordered = [by_rank[i] for i in sorted(by_rank)]
    return [addr for addr, _ in ordered], [r for _, r in ordered]


def probe_replica(host: str, port: int,
                  timeout_s: float = 1.0) -> str:
    """One replica's health, from its reserved paths: ``healthy`` (both
    ``/healthz`` and ``/readyz`` answer 200), ``warming`` (alive, but
    the compile plane is still AOT-compiling its program lattice —
    readyz 503 with body status ``"warming"``), ``draining`` (alive but
    readyz says stop routing — the drain/load-shed state), ``dead``
    (unreachable or healthz failing)."""
    base = f"http://{host}:{port}"
    fault = get_faults().http_fault("serving.probe", host=host, port=port)
    if fault is not None:
        return DEAD if fault[0] >= 500 else DRAINING
    try:
        with urllib.request.urlopen(base + "/healthz",
                                    timeout=timeout_s) as resp:
            if resp.status != 200:
                return DEAD
    except Exception:
        return DEAD
    try:
        with urllib.request.urlopen(base + "/readyz",
                                    timeout=timeout_s) as resp:
            return HEALTHY if resp.status == 200 else DRAINING
    except urllib.error.HTTPError as e:
        if e.code != 503:
            return DEAD
        try:
            status = json.loads(e.read().decode("utf-8")).get("status")
        except Exception:  # noqa: BLE001 — unparseable body: draining
            status = None
        return WARMING if status == "warming" else DRAINING
    except Exception:
        return DEAD


class ReplicaRouter:
    """Health-aware routing over a gathered replica table.

    One breaker per replica (shared process-wide through ``breaker_for``,
    keyed ``replica:<name>:<host>:<port>``): request failures reported via
    :meth:`report` trip it open, and :meth:`route` NEVER returns a
    replica whose breaker is open — an open replica only re-enters
    rotation through the breaker's own half-open probe admission.
    Probe results additionally mark replicas dead/draining so routing
    skips them before a single request is risked.  Thread-safe.
    """

    def __init__(self, table: List[Tuple[str, int]], name: str = "serving",
                 failure_threshold: int = 3, cooldown_s: float = 5.0,
                 probe_timeout_s: float = 1.0,
                 session_cache_size: int = 4096,
                 tenant_pin_cap: Optional[int] = None,
                 roles: Optional[List[str]] = None):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._lock = threading.Lock()
        self._rr = 0
        #: (tenant, session) -> (host, port) — keyed by ADDRESS, not
        #: rank, so an elastic resize renumbering the table cannot
        #: silently remap a session onto a stranger's prefix cache; and
        #: by TENANT, so two tenants reusing one session id can never
        #: share a pin.  Bounded LRU with per-tenant fairness: overflow
        #: evicts from the largest-pinning tenant (its own oldest pin),
        #: so one tenant's session churn cannot strip every other
        #: tenant's pins; ``tenant_pin_cap`` additionally hard-caps one
        #: tenant's pins (its cap overflow evicts only its own oldest).
        self._session_cap = int(session_cache_size)
        self._tenant_pin_cap = (int(tenant_pin_cap)
                                if tenant_pin_cap is not None else None)
        self._sessions: "OrderedDict[Tuple[str, str], Tuple[str, int]]" \
            = OrderedDict()
        self._tenant_pins: Dict[str, int] = {}
        self._g_healthy = get_registry().gauge(
            "serving_replicas_healthy",
            "replicas currently probed healthy with a non-open breaker",
            ("router",))
        # per-replica probe verdicts join the gang-level metric surface
        # (the coordinator's /metrics shows every replica's health beside
        # the rank-labeled worker metrics the gang plane mirrors)
        self._g_probe = get_registry().gauge(
            "serving_replica_probe_status",
            "last probe verdict per replica: 1 healthy, 0.5 draining, "
            "0 dead", ("router", "rank"))
        # session-affinity visibility: hit (pinned replica served),
        # miss (first route for a session — a cold pin), repin (pinned
        # replica unroutable, fell back to round-robin and re-pinned —
        # the prefix cache was lost).  A rising repin rate after a
        # resize is the router-side smoking gun for cold-prefill TTFT
        # regressions.
        self._m_affinity = get_registry().counter(
            "serving_affinity_total",
            "session-affinity routing outcomes", ("router", "outcome"))
        self._apply_table(table, roles=roles)

    def _breaker_key(self, host: str, port: int) -> str:
        return f"replica:{self.name}:{host}:{port}"

    def _apply_table(self, table: List[Tuple[str, int]],
                     roles: Optional[List[str]] = None) -> None:
        prev_table = list(getattr(self, "table", ()))
        prev = len(prev_table)
        self.table = [(h, int(p)) for h, p in table]
        # per-rank pool membership (disaggregated serving); a role-less
        # table is the colocated deployment — every replica decodes
        if roles is None:
            self.roles = ["decode"] * len(self.table)
        else:
            if len(roles) != len(self.table):
                raise ValueError(
                    f"roles ({len(roles)}) must match the table "
                    f"({len(self.table)})")
            self.roles = [str(r) for r in roles]
        # a shrunk table must not leave departed replicas' last verdicts
        # on /metrics as phantom healthy rows
        for r in range(len(self.table), prev):
            self._g_probe.remove(router=self.name, rank=str(r))
        # a shrunk table must also not leave the round-robin cursor
        # pointing past the end: route()'s modulo would still be safe,
        # but the cursor is a ROTATION POSITION and a stale one biases
        # the first post-resize pick — reset on shrink, keep on grow
        if self._rr >= len(self.table):
            self._rr = 0
        # optimistic until probed: a fresh table names live listeners
        self._status = {r: HEALTHY for r in range(len(self.table))}
        self._breakers = {
            r: breaker_for(self._breaker_key(h, p),
                           failure_threshold=self.failure_threshold,
                           cooldown_s=self.cooldown_s)
            for r, (h, p) in enumerate(self.table)}
        # departed ENDPOINTS release their process-wide breaker registry
        # entry (and its state gauge row) — an elastic gang resizing
        # every few minutes must not accumulate one breaker per address
        # it ever routed to.  Endpoints still in the table keep their
        # breaker (and its failure history) across the refresh.
        live = {self._breaker_key(h, p) for h, p in self.table}
        for h, p in prev_table:
            key = self._breaker_key(h, p)
            if key not in live:
                drop_breaker(key)
        # address -> rank for session-affinity lookups; sessions pinned
        # to a DEPARTED address fall back cleanly to round-robin (and
        # re-pin) on their next route — a resize loses the prefix cache
        # either way, never the request
        self._addr_rank = {addr: r for r, addr in enumerate(self.table)}
        for key in [s for s, addr in self._sessions.items()
                    if addr not in self._addr_rank]:
            self._drop_pin(key)
        self._update_gauge()

    # -- session-affinity pin bookkeeping (caller holds the lock) ----------
    def _drop_pin(self, key: Tuple[str, str]) -> None:
        if self._sessions.pop(key, None) is not None:
            n = self._tenant_pins.get(key[0], 0) - 1
            if n > 0:
                self._tenant_pins[key[0]] = n
            else:
                self._tenant_pins.pop(key[0], None)

    def _oldest_pin_of(self, tenant: str) -> Optional[Tuple[str, str]]:
        for key in self._sessions:          # LRU order: oldest first
            if key[0] == tenant:
                return key
        return None

    def _insert_pin(self, key: Tuple[str, str],
                    addr: Tuple[str, int]) -> None:
        tenant = key[0]
        if key not in self._sessions:
            cap = self._tenant_pin_cap
            if cap is not None and self._tenant_pins.get(tenant, 0) >= cap:
                # the tenant's own oldest pin makes room: a hard-capped
                # tenant's churn only ever evicts itself
                old = self._oldest_pin_of(tenant)
                if old is not None:
                    self._drop_pin(old)
            self._tenant_pins[tenant] = self._tenant_pins.get(tenant, 0) + 1
        self._sessions[key] = addr
        self._sessions.move_to_end(key)
        while len(self._sessions) > self._session_cap:
            # fairness at overflow: evict the LARGEST-pinning tenant's
            # oldest pin, not the global LRU head — one flooding
            # tenant's churn cannot strip every other tenant's pins
            big = max(self._tenant_pins,
                      key=lambda t: (self._tenant_pins[t], t))
            old = self._oldest_pin_of(big)
            self._drop_pin(old if old is not None
                           else next(iter(self._sessions)))

    def _update_gauge(self) -> None:
        healthy = sum(1 for r in self._status
                      if self._status[r] == HEALTHY
                      and self._breakers[r].state != "open")
        self._g_healthy.set(healthy, router=self.name)

    # -- probing -----------------------------------------------------------
    def probe(self, rank: int) -> str:
        with self._lock:
            if rank >= len(self.table):
                return DEAD            # refreshed away mid-probe-cycle
            h, p = self.table[rank]
        # network I/O outside the lock; writes re-validate the entry so a
        # concurrent refresh() cannot receive a stale rank's result
        status = probe_replica(h, p, timeout_s=self.probe_timeout_s)
        with self._lock:
            if rank < len(self.table) and self.table[rank] == (h, p):
                self._status[rank] = status
                b = self._breakers[rank]
                if status == HEALTHY:
                    # a health probe must not slam an OPEN breaker shut —
                    # request failures opened it, and only its own
                    # cooldown/half-open admission may reclose it.  Once
                    # the cooldown has elapsed (state half-open) a
                    # healthy probe counts as the reclosing success.
                    if b.state != "open":
                        b.record_success()
                elif status == DEAD:
                    b.record_failure()
                # draining is deliberate and warming is transient
                # startup work, not faults: no breaker signal for
                # either — a warming replica re-enters rotation the
                # first probe after its lattice finishes
                self._g_probe.set(
                    {HEALTHY: 1.0, WARMING: 0.75,
                     DRAINING: 0.5}.get(status, 0.0),
                    router=self.name, rank=str(rank))
                self._update_gauge()
        get_faults().note("serving.replica_probe", rank=rank, status=status)
        flight_record("replica_probe", router=self.name, rank=rank,
                      status=status)
        return status

    def probe_all(self) -> Dict[int, str]:
        with self._lock:
            ranks = list(range(len(self.table)))
        return {r: self.probe(r) for r in ranks}

    def statuses(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._status)

    def warming_count(self) -> int:
        """Replicas last probed WARMING — capacity already in flight
        (the compile plane is AOT-warming a resized-in replica), which
        the autoscaler must count against demand instead of growing
        again while the previous grow is still becoming useful."""
        with self._lock:
            return sum(1 for s in self._status.values() if s == WARMING)

    def breaker(self, rank: int):
        return self._breakers[rank]

    # -- routing -----------------------------------------------------------
    def url_for(self, rank: int, path: str = "/") -> str:
        h, p = self.table[rank]
        path = path.rstrip("/") or "/"
        return f"http://{h}:{p}{'' if path == '/' else path}"

    def route(self, path: str = "/",
              session: Optional[str] = None,
              tenant: str = "default",
              role: Optional[str] = None) -> "RouteResult":
        """Next routable replica (round-robin) → :class:`RouteResult`.

        Skips replicas probed dead or draining and replicas whose
        breaker refuses the call (open, or half-open past its probe
        budget).  Raises :class:`NoHealthyReplicaError` with the full
        per-rank status map when nothing is routable.

        ``session`` pins SESSION AFFINITY: repeated routes for the same
        key land on the same replica while it stays routable — a
        multi-turn conversation keeps hitting the replica whose slotted
        KV cache still holds its prefix, so the follow-up turn's prompt
        prefills only its new tail.  When the pinned replica becomes
        unroutable (dead, draining, breaker-open, or dropped by an
        elastic resize), the session falls back to round-robin and
        RE-PINS to the replica it gets — a cold prefill, never a
        failure.  Pins are namespaced by ``tenant``: two tenants
        reusing one session id never share a replica pin.

        ``role`` restricts routing to one pool of a disaggregated
        table (``"decode"``/``"prefill"``); None routes over every
        replica (the colocated deployment)."""
        return self.route_addr(path, session=session, tenant=tenant,
                               role=role)

    def route_addr(self, path: str = "/",
                   session: Optional[str] = None,
                   tenant: str = "default",
                   role: Optional[str] = None) -> "RouteResult":
        """:meth:`route` plus the routed ``(host, port)`` captured under
        the same lock — hand that address back to :meth:`report` and the
        report survives a concurrent :meth:`refresh` renumbering the
        table (no lossy re-parse of the url, no racy
        ``router.table[rank]`` read) — plus the session-affinity
        OUTCOME: ``"hit"`` (pinned replica still routable — its KV
        prefix is warm), ``"miss"`` (first route for the session, or no
        session), ``"repin"`` (the pinned replica was LOST — the
        session's device prefix cache is gone, so the caller should
        engage a restore path instead of silently serving
        context-free).  A pinned replica whose role no longer matches
        the requested pool counts as LOST the same way: the session
        repins into the right pool and the repin outcome still fires
        the caller's failover-restore path."""
        with self._lock:
            n = len(self.table)
            pinned = False
            key = (str(tenant), str(session)) if session is not None \
                else None
            if key is not None:
                addr = self._sessions.get(key)
                pinned = addr is not None
                if addr is not None:
                    r = self._addr_rank.get(addr)
                    if (r is not None and self._status[r] == HEALTHY
                            and (role is None or self.roles[r] == role)
                            and self._breakers[r].allow()):
                        # affinity hit: round-robin cursor untouched —
                        # pinned traffic must not skew the rotation the
                        # unpinned traffic balances on
                        self._sessions.move_to_end(key)
                        self._m_affinity.inc(1, router=self.name,
                                             outcome="hit")
                        return RouteResult(r, addr, self.url_for(r, path),
                                           "hit", {})
            start = self._rr
            for i in range(n):
                r = (start + i) % n
                if role is not None and self.roles[r] != role:
                    continue
                if self._status[r] != HEALTHY:
                    continue
                if not self._breakers[r].allow():
                    continue
                self._rr = (r + 1) % n
                if key is not None:
                    self._insert_pin(key, self.table[r])
                    # a pinned session falling through to round-robin
                    # lost its replica (resize/death/breaker): that is a
                    # REPIN (prefix cache gone); a first-ever route for
                    # the session is a plain miss (cold by definition)
                    self._m_affinity.inc(
                        1, router=self.name,
                        outcome="repin" if pinned else "miss")
                return RouteResult(r, self.table[r], self.url_for(r, path),
                                   "repin" if pinned else "miss", {})
            statuses = {
                r: (f"role {self.roles[r]}" if role is not None
                    and self.roles[r] != role
                    else self._status[r] if self._status[r] != HEALTHY
                    else f"breaker {self._breakers[r].state}")
                for r in range(n)}
        raise NoHealthyReplicaError(statuses)

    def report(self, rank: int, ok: bool,
               addr: Optional[Tuple[str, int]] = None) -> None:
        """Outcome of a routed request — feeds the replica's breaker (a
        breaker fed only by probes would take a whole probe cycle to
        notice a flapping replica).

        A report for a rank a concurrent :meth:`refresh` dropped from
        the table is ignored (never a crash).  Pass ``addr`` — the
        ``(host, port)`` the request actually went to, recoverable from
        :meth:`route`'s url — and a report whose rank was RENUMBERED by
        the refresh (its index now names a different endpoint) is
        ignored too, instead of poisoning the new occupant's breaker;
        without ``addr`` an index-only report cannot detect renumbering
        and is applied to whatever endpoint now holds the index."""
        with self._lock:
            if addr is not None and (rank >= len(self.table)
                                     or self.table[rank] !=
                                     (addr[0], int(addr[1]))):
                return
            b = self._breakers.get(rank)
        if b is None:
            return
        if ok:
            b.record_success()
        else:
            b.record_failure()
        with self._lock:
            self._update_gauge()

    def refresh(self, table: List[Tuple[str, int]],
                roles: Optional[List[str]] = None) -> None:
        """Adopt a re-gathered table (after an elastic restart or
        resize): statuses reset optimistic; breakers persist per
        endpoint still IN the table (a replica that came back on the
        same address keeps its history until its cooldown admits a
        probe), departed endpoints release theirs; the round-robin
        cursor clamps so rotation never starts past the shrunk end.
        ``route()`` calls racing the refresh either route on the old
        table (their replica drains, it does not vanish) or the new —
        never a mix."""
        with self._lock:
            self._apply_table(table, roles=roles)


class DistributedServingServer:
    """One listener on THIS rank plus the gang-wide routing table.

    Start one per rank of an initialized process group (or alone, in a
    process with none); every instance knows every rank's listener
    address (``routing_table``), so requests can be balanced across the
    whole gang while each rank's pipeline serves its local replica.
    ``device`` is :func:`exchange_routing_table`'s.  Matches the role of one-server-per-executor
    distributed serving (DistributedHTTPSource.scala:88).

    ``router`` (a :class:`ReplicaRouter` over the gathered table) adds
    failover: :meth:`route` skips dead/draining/breaker-open replicas,
    :meth:`probe_replicas` refreshes health from every replica's reserved
    paths, and :meth:`refresh_routing_table` re-gathers the table after
    an elastic gang restart."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout_s: float = 30.0,
                 max_queue: int = 1024,
                 max_body_bytes: int = 16 * 1024 * 1024,
                 gather_timeout_s: Optional[float] = None,
                 role: str = "decode", device="cuda"):
        import torch.distributed as dist
        from ..device import resolve_device
        resolve_device(device)      # no card: raises unless "cpu"
        #: the device of the routing-table collective's rows
        self.device = device
        self.local = ServingServer(host=host, port=port, api_path=api_path,
                                   reply_timeout_s=reply_timeout_s,
                                   max_queue=max_queue,
                                   max_body_bytes=max_body_bytes)
        lh, lp = self.local.address
        self._gather_timeout_s = gather_timeout_s
        #: this process's pool membership, published through the gather
        self.role = str(role)
        self.routing_table, role_ids = self._gather(lh, lp,
                                                    gather_timeout_s)
        self.routing_roles = [ROLE_NAMES[i] for i in role_ids]
        rank = dist.get_rank() if (dist.is_available()
                                   and dist.is_initialized()) else 0
        self.router = ReplicaRouter(
            self.routing_table, name=f"dserv-p{rank}",
            roles=self.routing_roles)

    def _gather(self, lh: str, lp: int, timeout_s: Optional[float]):
        return exchange_routing_table(
            lh, lp, timeout_s=timeout_s, role=_role_index(self.role),
            device=self.device)

    @property
    def address(self) -> Tuple[str, int]:
        return self.local.address

    def url_for_rank(self, rank: int, path: str = "/") -> str:
        h, p = self.routing_table[rank]
        path = path.rstrip("/") or "/"
        return f"http://{h}:{p}{'' if path == '/' else path}"

    # -- failover ----------------------------------------------------------
    def route(self, path: str = "/",
              session: Optional[str] = None,
              tenant: str = "default",
              role: Optional[str] = None) -> "RouteResult":
        """Next healthy replica for a request; ``session`` pins
        multi-turn requests to the replica holding their prefix cache,
        namespaced by ``tenant`` (see :meth:`ReplicaRouter.route`);
        ``role`` restricts the route to one disaggregated pool."""
        return self.router.route(path, session=session, tenant=tenant,
                                 role=role)

    def route_addr(self, path: str = "/",
                   session: Optional[str] = None,
                   tenant: str = "default",
                   role: Optional[str] = None) -> "RouteResult":
        """:meth:`route` plus the routed ``(host, port)`` — pass it back
        through :meth:`report_result`'s ``addr=`` so the report survives
        a concurrent table refresh renumbering the ranks — plus the
        affinity outcome (see :meth:`ReplicaRouter.route_addr`)."""
        return self.router.route_addr(path, session=session, tenant=tenant,
                                      role=role)

    def route_request(self, path: str = "/",
                      session: Optional[str] = None,
                      trace_id: Optional[str] = None,
                      tenant: str = "default",
                      role: Optional[str] = None) -> "RouteResult":
        """:meth:`route_addr` plus request-trace propagation: mints a
        trace id at THIS hop when the caller has none, records the
        routing decision on the hop's flight recorder (trace id, rank,
        session, affinity outcome), and fills :attr:`RouteResult.
        headers` with what to attach to the forwarded request
        (``X-SML-Trace-Id``) — the replica's decode loop adopts the id
        (propagated ids are always sampled), so a session-affinity hop
        chain stays attributable end to end.

        ``outcome == "repin"`` is the failover-restore trigger: the
        session's pinned replica is GONE and with it the device prefix
        cache, so the caller marks the forwarded request ``resume`` —
        the new replica rebuilds the conversation from its session
        journal (or host arena) instead of silently serving it
        context-free."""
        from ..telemetry.tracing import mint_trace_id
        from .server import TENANT_HEADER, TRACE_HEADER
        tid = trace_id or mint_trace_id()
        res = self.router.route_addr(path, session=session, tenant=tenant,
                                     role=role)
        flight_record("route", router=self.router.name, trace_id=tid,
                      rank=res.rank, session=session, tenant=tenant,
                      affinity=res.outcome)
        headers = {TRACE_HEADER: tid}
        if tenant != "default":
            headers[TENANT_HEADER] = tenant
        return res._replace(headers=headers)

    def probe_replicas(self) -> Dict[int, str]:
        return self.router.probe_all()

    def report_result(self, rank: int, ok: bool,
                      addr: Optional[Tuple[str, int]] = None) -> None:
        self.router.report(rank, ok, addr=addr)

    def refresh_routing_table(
            self, timeout_s: Optional[float] = None) -> List[Tuple[str, int]]:
        """Re-gather the table over the (re-formed) mesh — call on every
        process after an elastic restart OR resize, collectively — and
        rebuild the router's view from it.  A resize is absorbed, not
        special-cased: the gathered table simply has a different length,
        the router clamps its rotation, departed endpoints release
        their breakers, and in-flight exchanges against a departing
        replica finish through its :meth:`leave` drain."""
        lh, lp = self.local.address
        self.routing_table, role_ids = self._gather(
            lh, lp, timeout_s or self._gather_timeout_s)
        self.routing_roles = [ROLE_NAMES[i] for i in role_ids]
        self.router.refresh(self.routing_table, roles=self.routing_roles)
        return self.routing_table

    def leave(self, timeout_s: float = 30.0) -> bool:
        """This replica is departing (elastic shrink): stop admitting —
        the listener closes at once (a new request on a connection
        already open is shed 503), so a peer's probe reads this rank
        ``dead`` and every peer's router skips it before the table
        refreshes — then flush EVERY accepted in-flight exchange through
        the zero-drop ``drain()`` path and close.  Returns drain()'s
        verdict (True = nothing was dropped).  A replica that should
        probe ``draining`` while it keeps its listener calls
        ``health.begin_drain()`` on its server first."""
        return self.local.drain(timeout_s=timeout_s)

    # local-API passthroughs
    def register_api(self, *a, **kw):
        return self.local.register_api(*a, **kw)

    def get_batch(self, *a, **kw):
        return self.local.get_batch(*a, **kw)

    def reply(self, *a, **kw):
        return self.local.reply(*a, **kw)

    def close(self) -> None:
        self.local.close()
