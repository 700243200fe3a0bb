"""Admission control: priority-classed gating and load shedding for the
serving path.

Copy of pilosa_tpu/serve/admission.py.  A stdlib ThreadingHTTPServer
admits one thread per connection without bound, so overload would mean
unbounded queueing.  This module is the process-wide gate between accept
and dispatch.  Three priority classes, strictly ordered:

- ``query``: user PQL (highest);
- ``ingest``: import / import-value / import-roaring, key creation;
- ``internal``: background and node-to-node work (lowest), here the
  ingest compactor's scans.

Each class owns a concurrency cap and a bounded FIFO wait queue, so
classes are isolated.  Shedding is honest, lowest class and newest
first:

- an arrival at a full class queue is refused (429 ``queue-full``; the
  queued older requests keep their place);
- an arrival whose predicted queue wait exceeds its remaining deadline
  is refused up front (503 ``deadline-unmeetable``);
- ``internal`` arrivals yield (503 ``yield-to-query``) while the query
  queue is under pressure;
- a request whose deadline has expired, on arrival or in the queue, is
  refused (503 ``expired``) and never reaches dispatch.

Every refusal carries ``Retry-After`` from the class's EWMA service time.

With [tenants] enabled (serve/tenant.py) every class also runs weighted
fairness across tenants inside its cap: each tenant holds at most its
``share`` of the slots, queues in its own bounded FIFO (past ``queue`` an
arrival sheds 429 ``tenant-queue-full``), and freed slots dequeue by
deficit round robin weighted by ``share``.  With [tenants] off the
tenant structures are never touched.

Left out, with the port's lack of the layers they hook into: the
``admission.acquire`` failpoint (no ``faultinject``), the stats emission
(no stats registry: the controller counts into its own totals, which
``debug()`` reports as the reference's does) and the flight-record stamp
``Ticket.info`` (no ``observe``).  The remote shed of the cluster
(``ShedByPeerError``) and the client's ``Retry-After`` retries wait for
the cluster: ``rpc_class``/``tagged`` tag outbound RPC, which the port
does not send yet.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from collections import deque

from pilosa_tpu_torch.serve import tenant as _tenant
from pilosa_tpu_torch.serve.deadline import Deadline, tls_scope

#: Priority order: a lower number is a higher priority and sheds last.
PRIORITY = {"query": 0, "ingest": 1, "internal": 2}
CLASSES = tuple(sorted(PRIORITY, key=PRIORITY.get))

#: Ceiling on the time spent queued without a deadline: a wedged slot
#: holder must not strand its waiters forever.
MAX_QUEUE_WAIT_S = 60.0

#: Retry-After bounds (seconds): the floor keeps the integer header
#: non-zero, the ceiling stops a long EWMA from sending clients away for
#: minutes.
RETRY_AFTER_MIN_S = 1
RETRY_AFTER_MAX_S = 30


class ShedError(Exception):
    """A request refused (or expired) at the gate, with the HTTP status
    to answer and the suggested Retry-After (seconds)."""

    def __init__(self, klass: str, reason: str, status: int,
                 retry_after: int, wait_ns: int = 0,
                 tenant: str | None = None):
        detail = f" (tenant {tenant})" if tenant else ""
        super().__init__(
            f"{klass} request {reason}{detail} "
            f"(admission control; retry after {retry_after}s)")
        self.klass = klass
        self.reason = reason  # queue-full | tenant-queue-full |
        #                       deadline-unmeetable | yield-to-query |
        #                       queue-timeout | expired
        self.status = status  # 429 (back off) or 503 (overloaded)
        self.retry_after = retry_after
        # time queued before the refusal (an expiry in the queue)
        self.wait_ns = wait_ns
        # the shedding tenant ([tenants] on), on the 429/503 body so that
        # a client can tell its own quota from server overload
        self.tenant = tenant

    @property
    def outcome(self) -> str:
        """``expired`` for a spent deadline, ``shed`` for every capacity
        refusal."""
        return "expired" if self.reason == "expired" else "shed"


# --------------------------------------------------------------------
# outbound RPC class tagging
# --------------------------------------------------------------------

_tls_rpc = threading.local()  # .klass: the class stamped on outbound RPC


class rpc_class(tls_scope):
    """Tag every outbound RPC issued inside the with-block with an
    admission class (the ``X-Pilosa-Class`` header).  Re-entrant."""

    __slots__ = ()

    def __init__(self, klass: str):
        if klass not in PRIORITY:
            raise ValueError(f"unknown admission class: {klass!r}")
        super().__init__(_tls_rpc, "klass", klass)


def current_rpc_class() -> str | None:
    return getattr(_tls_rpc, "klass", None)


def tagged(klass: str):
    """Decorator form of :class:`rpc_class`."""
    if klass not in PRIORITY:
        raise ValueError(f"unknown admission class: {klass!r}")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with rpc_class(klass):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# --------------------------------------------------------------------
# controller
# --------------------------------------------------------------------

class _Waiter:
    __slots__ = ("event", "dl", "state", "tenant")

    def __init__(self, dl: Deadline | None, tenant: str | None = None):
        self.event = threading.Event()
        self.dl = dl
        self.state = "waiting"  # -> admitted | expired | abandoned
        self.tenant = tenant


class _TenantState:
    """One tenant's slots and queue inside one class (guarded by the
    controller's lock).  ``deficit`` is the deficit-round-robin credit:
    each ring visit adds the tenant's share, each dequeued waiter spends
    one."""

    __slots__ = ("in_flight", "waiters", "deficit", "admitted",
                 "shed", "expired", "wait_ewma_s")

    def __init__(self):
        self.in_flight = 0
        self.waiters: deque[_Waiter] = deque()
        self.deficit = 0.0
        self.admitted = 0
        self.shed = 0
        self.expired = 0
        self.wait_ewma_s = 0.0  # EWMA of observed queue waits


class _Gate:
    """One class's slots and queue (guarded by the controller's lock).
    ``tenants``/``rr``/``waiting_total`` are the per-tenant layer,
    untouched and empty while [tenants] is off."""

    __slots__ = ("cap", "depth", "in_flight", "waiters",
                 "ewma_service_s", "admitted", "shed", "expired",
                 "tenants", "rr", "waiting_total")

    def __init__(self, cap: int, depth: int):
        self.cap = max(1, int(cap))
        self.depth = max(0, int(depth))
        self.in_flight = 0
        self.waiters: deque[_Waiter] = deque()
        self.ewma_service_s = 0.0
        self.admitted = 0
        self.shed = 0
        self.expired = 0
        # tenant name -> _TenantState; rr is the DRR ring of tenants with
        # queued waiters; waiting_total sums their queue lengths
        self.tenants: dict[str, _TenantState] = {}
        self.rr: deque[str] = deque()
        self.waiting_total = 0


class Ticket:
    """One admitted request's slot.  ``release()`` is idempotent and must
    run (the handler's ``finally``), or the slot leaks."""

    __slots__ = ("_ctrl", "klass", "queue_wait_ns", "_t_admit",
                 "_released", "tenant")

    def __init__(self, ctrl: "AdmissionController | None", klass: str,
                 queue_wait_ns: int, tenant: str | None = None):
        self._ctrl = ctrl
        self.klass = klass
        self.queue_wait_ns = queue_wait_ns
        self._t_admit = time.monotonic()
        self._released = False
        self.tenant = tenant

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._ctrl is not None:
            self._ctrl._release(self.klass, self._t_admit,
                                tenant=self.tenant)


class AdmissionController:
    """Per-class slot accounting over bounded FIFO wait queues.  One per
    server; thread-safe."""

    def __init__(self, query_cap: int = 32, query_queue: int = 128,
                 ingest_cap: int = 16, ingest_queue: int = 64,
                 internal_cap: int = 16, internal_queue: int = 64,
                 default_deadline: float = 0.0, enabled: bool = True):
        self.enabled = enabled
        self.default_deadline = default_deadline  # s; 0 = none implied
        self._lock = threading.Lock()
        self._gates = {
            "query": _Gate(query_cap, query_queue),
            "ingest": _Gate(ingest_cap, ingest_queue),
            "internal": _Gate(internal_cap, internal_queue),
        }

    # ------------------------------------------------------------ sizing

    def total_capacity(self) -> int:
        """Sum of the class caps and queue depths: the most requests the
        gate holds at once, the basis of the handler's thread cap."""
        return sum(g.cap + g.depth for g in self._gates.values())

    # ----------------------------------------------------------- acquire

    def acquire(self, klass: str, dl: Deadline | None = None,
                tenant: str | None = None) -> Ticket:
        """Admit, possibly after a bounded FIFO wait, or raise ShedError.
        The wait is on an event, never a spin.  ``tenant`` counts only
        while [tenants] is enabled."""
        g = self._gates.get(klass)
        if g is None:
            raise ValueError(f"unknown admission class: {klass!r}")
        if not self.enabled:
            return Ticket(None, klass, 0)
        pol = _tenant.policy()
        tname = _tenant.resolve(tenant) if pol is not None else None
        t0 = time.perf_counter_ns()
        with self._lock:
            ts = None
            if pol is not None:
                ts = g.tenants.get(tname)
                if ts is None:
                    ts = g.tenants[tname] = _TenantState()
                quota = pol.quota_for(tname)
                share = max(1, quota.share)
            if dl is not None and dl.expired():
                g.expired += 1
                if ts is not None:
                    ts.expired += 1
                err = ShedError(klass, "expired", 503,
                                self._retry_after(g), tenant=tname)
            elif klass == "internal" and self._query_pressure_locked():
                # the lowest class sheds first while queries stack up
                g.shed += 1
                if ts is not None:
                    ts.shed += 1
                err = ShedError(klass, "yield-to-query", 503,
                                self._retry_after(self._gates["query"]),
                                tenant=tname)
            elif ts is None and g.in_flight < g.cap and not g.waiters:
                g.in_flight += 1
                g.admitted += 1
                err = None
                w = None
            elif (ts is not None and g.in_flight < g.cap
                  and ts.in_flight < share and not ts.waiters):
                # a tenant under both caps with no queued peers admits
                # straight through
                g.in_flight += 1
                g.admitted += 1
                ts.in_flight += 1
                ts.admitted += 1
                # a zero-wait admit decays the queue-wait EWMA, or a past
                # congestion would pin the deadline-unmeetable floor high
                ts.wait_ewma_s *= 0.8
                err = None
                w = None
            elif ts is not None and len(ts.waiters) >= max(0, quota.queue):
                # the tenant's own queue is full: over its quota
                g.shed += 1
                ts.shed += 1
                err = ShedError(klass, "tenant-queue-full", 429,
                                self._retry_after(g), tenant=tname)
            elif (len(g.waiters) if ts is None
                  else g.waiting_total) >= g.depth:
                # newest first: the arriving request refuses
                g.shed += 1
                if ts is not None:
                    ts.shed += 1
                err = ShedError(klass, "queue-full", 429,
                                self._retry_after(g), tenant=tname)
            elif (dl is not None
                  and (self._predicted_wait_s(g) if ts is None
                       else self._predicted_tenant_wait_s(g, ts, share))
                  > dl.remaining()):
                g.shed += 1
                if ts is not None:
                    ts.shed += 1
                err = ShedError(klass, "deadline-unmeetable", 503,
                                self._retry_after(g), tenant=tname)
            elif ts is None:
                err = None
                w = _Waiter(dl)
                g.waiters.append(w)
            else:
                err = None
                w = _Waiter(dl, tenant=tname)
                ts.waiters.append(w)
                g.waiting_total += 1
                if tname not in g.rr:
                    g.rr.append(tname)
        if err is not None:
            raise err
        if w is None:
            return Ticket(self, klass, 0, tenant=tname)
        timeout = MAX_QUEUE_WAIT_S
        if dl is not None:
            timeout = min(timeout, max(0.0, dl.remaining()))
        w.event.wait(timeout)
        # classify at wake time: only a deadline that passed is an
        # expiry; the MAX_QUEUE_WAIT_S backstop is a capacity incident
        # (a wedged slot holder) and counts as a shed
        reason = ("expired" if dl is not None and dl.expired()
                  else "queue-timeout")
        wait_ns = time.perf_counter_ns() - t0
        with self._lock:
            admitted = w.state == "admitted"
            if admitted:
                g.admitted += 1
                if ts is not None:
                    ts.admitted += 1
                    wait_s = wait_ns / 1e9
                    ts.wait_ewma_s = (wait_s if ts.wait_ewma_s == 0.0
                                      else 0.8 * ts.wait_ewma_s
                                      + 0.2 * wait_s)
            else:
                # the deadline (or the backstop) passed while queued,
                # noticed here or marked by a promoter
                if w.state == "waiting":
                    w.state = "abandoned"
                    try:
                        if ts is None:
                            g.waiters.remove(w)
                        else:
                            ts.waiters.remove(w)
                            g.waiting_total -= 1
                    except ValueError:
                        pass
                if reason == "expired":
                    g.expired += 1
                    if ts is not None:
                        ts.expired += 1
                else:
                    g.shed += 1
                    if ts is not None:
                        ts.shed += 1
        if admitted:
            return Ticket(self, klass, wait_ns, tenant=tname)
        raise ShedError(klass, reason, 503, self._retry_after(g),
                        wait_ns=wait_ns, tenant=tname)

    def try_acquire(self, klass: str) -> Ticket:
        """Non-blocking admit: a free slot with no queued waiters ahead,
        or an immediate ShedError, never a wait.  The gate of
        opportunistic background work."""
        g = self._gates.get(klass)
        if g is None:
            raise ValueError(f"unknown admission class: {klass!r}")
        if not self.enabled:
            return Ticket(None, klass, 0)
        with self._lock:
            if (klass == "internal" and self._query_pressure_locked()) \
                    or g.in_flight >= g.cap or g.waiters \
                    or g.waiting_total:
                g.shed += 1
                err = ShedError(klass, "yield-to-query", 503,
                                self._retry_after(g))
            else:
                g.in_flight += 1
                g.admitted += 1
                err = None
        if err is not None:
            raise err
        return Ticket(self, klass, 0)

    def _release(self, klass: str, t_admit: float,
                 tenant: str | None = None) -> None:
        with self._lock:
            g = self._gates[klass]
            g.in_flight -= 1
            if tenant is not None:
                ts = g.tenants.get(tenant)
                if ts is not None and ts.in_flight > 0:
                    ts.in_flight -= 1
            held = time.monotonic() - t_admit
            g.ewma_service_s = (held if g.ewma_service_s == 0.0
                                else 0.8 * g.ewma_service_s + 0.2 * held)
            while g.in_flight < g.cap and g.waiters:
                w = g.waiters.popleft()
                if w.state != "waiting":  # abandoned by its own thread
                    continue
                if w.dl is not None and w.dl.expired():
                    # expired in the queue: wake it to shed; its own
                    # thread counts the expiry
                    w.state = "expired"
                    w.event.set()
                    continue
                w.state = "admitted"
                g.in_flight += 1
                w.event.set()
                break
            if g.rr:
                self._wake_tenants_locked(g)

    def _wake_tenants_locked(self, g: _Gate) -> None:
        """Deficit-round-robin dequeue across the tenants with queued
        waiters: each ring visit credits a tenant its ``share``, each
        admitted waiter spends one credit, and no tenant exceeds its
        share of the class, so freed capacity divides by weight.  The
        caller holds the lock."""
        pol = _tenant.policy()
        while g.in_flight < g.cap and g.rr:
            advanced = False
            for _ in range(len(g.rr)):
                if g.in_flight >= g.cap:
                    break
                tname = g.rr[0]
                ts = g.tenants.get(tname)
                if ts is None or not ts.waiters:
                    g.rr.popleft()
                    if ts is not None:
                        ts.deficit = 0.0
                    advanced = True
                    continue
                # [tenants] turned off with waiters queued: an unweighted
                # drain, so that nobody strands
                quota = pol.quota_for(tname) if pol is not None else None
                share = max(1, quota.share) if quota is not None else g.cap
                if ts.deficit < 1.0:
                    ts.deficit += share
                while (ts.deficit >= 1.0 and ts.waiters
                       and g.in_flight < g.cap
                       and ts.in_flight < share):
                    w = ts.waiters.popleft()
                    g.waiting_total -= 1
                    if w.state != "waiting":
                        # abandoned by its own thread: costs no credit
                        advanced = True
                        continue
                    if w.dl is not None and w.dl.expired():
                        w.state = "expired"
                        w.event.set()
                        advanced = True
                        continue
                    w.state = "admitted"
                    g.in_flight += 1
                    ts.in_flight += 1
                    ts.deficit -= 1.0
                    w.event.set()
                    advanced = True
                if (ts.waiters and ts.deficit >= 1.0
                        and ts.in_flight < share):
                    # credit left, waiters queued, the class full: stay
                    # at the ring's front, so that the next freed slot
                    # continues this tenant's turn
                    break
                g.rr.rotate(-1)
            if not advanced:
                # every queued tenant is at its share, or the class full
                break

    # ---------------------------------------------------------- policies

    def _query_pressure_locked(self) -> bool:
        """True while the query class is saturated and its queue at least
        half full: the signal for lower classes to yield."""
        q = self._gates["query"]
        return (q.depth > 0 and q.in_flight >= q.cap
                and 2 * (len(q.waiters) + q.waiting_total) >= q.depth)

    def _predicted_wait_s(self, g: _Gate) -> float:
        """The queue position's estimate: (waiters ahead + 1) drain at
        the cap's parallelism and the EWMA service time.  Zero until the
        first release seeds the EWMA."""
        return (len(g.waiters) + 1) * g.ewma_service_s / g.cap

    def _predicted_tenant_wait_s(self, g: _Gate, ts: _TenantState,
                                 share: int) -> float:
        """A tenant's estimate: its waiters drain at its share of the
        class's parallelism, floored by its observed queue-wait EWMA."""
        eff = max(1, min(share, g.cap))
        return max((len(ts.waiters) + 1) * g.ewma_service_s / eff,
                   ts.wait_ewma_s)

    def _retry_after(self, g: _Gate) -> int:
        return int(min(RETRY_AFTER_MAX_S,
                       max(RETRY_AFTER_MIN_S,
                           math.ceil(self._predicted_wait_s(g)))))

    # ---------------------------------------------------------- counting

    def count_expired(self, klass: str) -> None:
        """An admitted request expired during execution (the executor's
        deadline checks fired): the same counter as an expiry at the
        gate."""
        g = self._gates.get(klass)
        if g is None:
            return
        with self._lock:
            g.expired += 1

    # ------------------------------------------------------------- views

    def debug(self) -> dict:
        """The ``/debug/admission`` document; with [tenants] enabled each
        class carries its per-tenant breakdown."""
        pol = _tenant.policy()
        with self._lock:
            out = {
                "enabled": self.enabled,
                "defaultDeadline": self.default_deadline,
                "classes": {
                    k: {
                        "cap": g.cap,
                        "queueDepth": g.depth,
                        "inFlight": g.in_flight,
                        "waiting": (len(g.waiters) + g.waiting_total),
                        "ewmaServiceMs": round(g.ewma_service_s * 1e3, 3),
                        "admitted": g.admitted,
                        "shed": g.shed,
                        "expired": g.expired,
                    }
                    for k, g in self._gates.items()
                },
            }
            if pol is not None:
                for k, g in self._gates.items():
                    out["classes"][k]["tenants"] = {
                        name: self._tenant_dict_locked(ts,
                                                       pol.quota_for(name))
                        for name, ts in g.tenants.items()
                    }
        if pol is not None:
            out["tenantsEnabled"] = True
        return out

    @staticmethod
    def _tenant_dict_locked(ts: _TenantState, quota) -> dict:
        return {
            "share": quota.share,
            "queueDepth": quota.queue,
            "inFlight": ts.in_flight,
            "waiting": len(ts.waiters),
            "deficit": round(ts.deficit, 3),
            "admitted": ts.admitted,
            "shed": ts.shed,
            "expired": ts.expired,
            "queueWaitEwmaMs": round(ts.wait_ewma_s * 1e3, 3),
        }

    def tenants_debug(self) -> dict:
        """Per-tenant totals over the classes: the admission half of
        ``GET /debug/tenants``."""
        out: dict[str, dict] = {}
        with self._lock:
            for g in self._gates.values():
                for name, ts in g.tenants.items():
                    d = out.setdefault(name, {
                        "inFlight": 0, "waiting": 0, "admitted": 0,
                        "shed": 0, "expired": 0, "queueWaitEwmaMs": 0.0,
                    })
                    d["inFlight"] += ts.in_flight
                    d["waiting"] += len(ts.waiters)
                    d["admitted"] += ts.admitted
                    d["shed"] += ts.shed
                    d["expired"] += ts.expired
                    d["queueWaitEwmaMs"] = round(
                        max(d["queueWaitEwmaMs"],
                            ts.wait_ewma_s * 1e3), 3)
        return out
