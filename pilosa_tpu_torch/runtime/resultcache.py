"""Generation-stamped query result cache: a repeated read launches
nothing.

Copy of pilosa_tpu/runtime/resultcache.py.  One process-wide, byte-
budgeted LRU maps a canonical query key -- (holder uid, index, root
kind, the tree's signature with leaf identities ``(field, view, row)``
at its slots, extra arguments, shard tuple, placement) -- to its result,
stamped with the participating fragments' generation state: per (field,
view) an aggregate ``(count, sum_gen, sum_delta_seq, sum_uid, max_uid)``
over the shard set (``Executor._rc_collect_gens``).  Every mutation
moves the stamp (a base write or a compaction bumps ``_gen``, a
delta-landing write ``_delta_seq``, a re-created fragment raises
``max_uid``), so a stale entry simply misses.

Stamp before read: callers capture the generation tuple BEFORE reading
any fragment data and fill with that same stamp.  A write that lands
between the two leaves the entry stamped with the old generations, so it
can never be served, only refilled.

Single flight: the first misser of a ``(key, stamp)`` leads; same-stamp
missers arriving while its flight is open wait, at most ``FLIGHT_WAIT_S``
and never past the flight's ``FLIGHT_TTL_S``, for the leader's ``put``
and serve the fill as a hit.  A waiter whose wait runs out computes
itself; a different stamp never joins an older flight.

Results live on the host: Count totals, TopN row-count dicts, GroupBy
results and Row word copies, charged against this cache's own budget.

Per-tenant soft budgets (serve/tenant.py; reference :60-68, 224-289):
with [tenants] enabled every entry is charged to the tenant that filled
it (an explicit id, or the executor's thread-local tenant scope), and
while a tenant holds more than its ``cache_share`` of the budget,
eviction takes that tenant's own oldest entries before the global LRU
order, so that one tenant churning distinct keys evicts its own
entries (``tenantPrefEvictions``).  With [tenants] off no entry carries a
tenant, the LRU is one global order and ``tenantPrefEvictions`` stays 0.
``tenant_stats`` is the cache's half of ``GET /debug/tenants``.

Left out, with the port's lack of the layers they hook into: the
``lockcheck`` lock registry (the cache takes a plain ``threading.Lock``),
the ``resultcache.fill`` failpoint (no ``faultinject``),
``invalidate_shard`` (the rebalance cutover hook; no cluster; the port's
``invalidate_index`` drops a deleted index's or field's entries instead)
and ``publish_gauges`` (no stats registry).  ``GET /debug/resultcache``
serves ``debug()``.

The ``[cache]`` knobs are process-wide, as in the reference: ``retain``
takes a server reference (the first snapshots the knobs in force) and
``release`` gives it back, the last one restoring the snapshot.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any

from pilosa_tpu_torch.serve import tenant as _tenant

#: Defaults; the server assembly reconfigures from its [cache] knobs.
DEFAULT_BUDGET_BYTES = 128 << 20
DEFAULT_MAX_ENTRY_BYTES = 8 << 20

#: Accounting floor per entry: key tuple + stamp tuple + dict slot.
ENTRY_OVERHEAD_BYTES = 256

#: How long a same-stamp misser waits for an open flight's fill before
#: computing itself.
FLIGHT_WAIT_S = 1.0

#: A flight older than this is presumed dead (its leader failed before
#: filling) and is replaced by the next misser.
FLIGHT_TTL_S = 5.0


class Key:
    """Hash-once wrapper for cache keys: a key's tail is the whole shard
    tuple, and tuples do not cache their hash, so the probe's get / pop
    / insert would rehash it three times."""

    __slots__ = ("k", "h")

    def __init__(self, k: Any) -> None:
        self.k = k
        self.h = hash(k)

    def __hash__(self) -> int:
        return self.h

    def __eq__(self, other: object) -> bool:
        if self is other:
            return True
        if isinstance(other, Key):
            return self.k == other.k
        return NotImplemented

    def __repr__(self) -> str:
        return repr(self.k)


class _Entry:
    __slots__ = ("gens", "value", "nbytes", "t", "hits", "tenant")

    def __init__(self, gens: Any, value: object, nbytes: int,
                 tenant: str | None = None) -> None:
        self.gens = gens
        self.value = value
        self.nbytes = nbytes
        self.t = time.monotonic()
        self.hits = 0
        self.tenant = tenant


class _Flight:
    """One fill in progress: the leader computes, same-stamp missers wait
    on the event, which ``put`` sets whatever its outcome.  ``tid`` is
    the leader's thread, which never waits on its own flight."""

    __slots__ = ("gens", "t0", "event", "tid")

    def __init__(self, gens: Any) -> None:
        self.gens = gens
        self.t0 = time.monotonic()
        self.event = threading.Event()
        self.tid = threading.get_ident()


class ResultCache:
    """Byte-budgeted LRU of generation-stamped query results.

    ``get(key, gens)`` hits only when the stored stamp equals the
    caller's freshly computed one; an entry with another stamp is dropped
    on the spot (an invalidation).  ``put`` keeps the cache within
    ``budget`` bytes at every moment."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 max_entry_bytes: int = DEFAULT_MAX_ENTRY_BYTES,
                 ttl_s: float = 0.0, enabled: bool = True) -> None:
        self.budget = int(budget_bytes)
        self.max_entry_bytes = int(max_entry_bytes)
        self.ttl_s = float(ttl_s)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # insertion order is LRU order (move to the end on a hit)
        self._entries: dict[Any, _Entry] = {}
        #: key -> _Flight: fills in progress
        self._flights: dict[Any, _Flight] = {}
        #: keys whose last fill was refused as oversize: their flights
        #: could never serve a waiter (bounded FIFO)
        self._noflight: dict[Any, None] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.invalidations = 0
        self.skipped_oversize = 0
        self.flight_joins = 0
        self.flight_served = 0
        # per-tenant accounting, touched only while [tenants] is on:
        # tenant -> live bytes; tenant -> its keys in LRU order; tenant ->
        # [hits, misses, fills, evictions]
        self._tenant_bytes: dict[str, int] = {}
        self._tenant_lru: dict[str, dict] = {}
        self._tenant_counters: dict[str, list] = {}
        self.tenant_pref_evictions = 0  # over-budget tenants' victims

    # ------------------------------------------------- tenant helpers

    @staticmethod
    def _caller_tenant(tenant: str | None) -> str | None:
        """The tenant an access charges: an explicit id or the thread's
        tenant scope, through the individuation bound; None (no
        accounting at all) while [tenants] is off."""
        if not _tenant.enabled():
            return None
        return _tenant.resolve(tenant if tenant is not None
                               else _tenant.current())

    def _tc_locked(self, t: str) -> list:
        c = self._tenant_counters.get(t)
        if c is None:
            c = self._tenant_counters[t] = [0, 0, 0, 0]
        return c

    def _tenant_track_locked(self, key: Any, e: _Entry) -> None:
        if e.tenant is None:
            return
        self._tenant_bytes[e.tenant] = \
            self._tenant_bytes.get(e.tenant, 0) + e.nbytes
        self._tenant_lru.setdefault(e.tenant, {})[key] = None

    def _tenant_untrack_locked(self, key: Any, e: _Entry) -> None:
        if e.tenant is None:
            return
        self._tenant_bytes[e.tenant] = \
            self._tenant_bytes.get(e.tenant, 0) - e.nbytes
        lru = self._tenant_lru.get(e.tenant)
        if lru is not None:
            lru.pop(key, None)

    def _tenant_touch_locked(self, key: Any, e: _Entry) -> None:
        if e.tenant is None:
            return
        lru = self._tenant_lru.get(e.tenant)
        if lru is not None and key in lru:
            lru[key] = lru.pop(key)

    def _victim_key_locked(self, protect: Any) -> Any:
        """The next eviction victim: the oldest entry of a tenant over
        its soft budget, else the global LRU head; never ``protect``,
        the entry being inserted."""
        pol = _tenant.policy()
        if pol is not None and self._tenant_bytes:
            for t, b in self._tenant_bytes.items():
                if b <= int(self.budget * pol.quota_for(t).cache_share):
                    continue
                for k in self._tenant_lru.get(t, ()):
                    if k != protect:
                        self.tenant_pref_evictions += 1
                        return k
        for k in self._entries:
            if k != protect:
                return k
        return None

    # -------------------------------------------------------- access

    def get(self, key: Any, gens: Any,
            wait_s: float = FLIGHT_WAIT_S,
            tenant: str | None = None) -> tuple[bool, object]:
        """(hit, value) for the CURRENT stamp ``gens``.  A miss with no
        open same-stamp flight opens one (the caller leads and is
        expected to ``put``); a miss while one is open waits up to
        ``wait_s`` for its fill and serves it as a hit.  ``wait_s=0``
        never waits."""
        if not self.enabled:
            return False, None
        t = self._caller_tenant(tenant)
        budget = wait_s
        while True:
            with self._lock:
                e = self._entries.get(key)
                if e is not None:
                    if e.gens == gens and not (
                            self.ttl_s > 0
                            and time.monotonic() - e.t > self.ttl_s):
                        self._entries[key] = self._entries.pop(key)
                        self._tenant_touch_locked(key, e)
                        e.hits += 1
                        self.hits += 1
                        if t is not None:
                            self._tc_locked(t)[0] += 1
                        return True, e.value
                    del self._entries[key]
                    self.bytes -= e.nbytes
                    self._tenant_untrack_locked(key, e)
                    self.invalidations += 1
                if key in self._noflight:
                    # the last fill of this key was refused (oversize):
                    # waiting could never turn into a hit
                    self.misses += 1
                    if t is not None:
                        self._tc_locked(t)[1] += 1
                    return False, None
                fl = self._flights.get(key)
                now = time.monotonic()
                if (fl is None or fl.gens != gens
                        or fl.tid == threading.get_ident()
                        or now - fl.t0 > FLIGHT_TTL_S):
                    # no joinable fill: this caller computes.  A flight
                    # of another stamp is left to its own waiters; an
                    # expired one is replaced; our own means we lead.
                    if fl is None or now - fl.t0 > FLIGHT_TTL_S:
                        # leaders that fail before put() leave orphans:
                        # sweep the expired ones so the registry stays
                        # bounded
                        if len(self._flights) >= 64:
                            for k in [k for k, f in self._flights.items()
                                      if now - f.t0 > FLIGHT_TTL_S]:
                                self._flights.pop(k).event.set()
                        self._flights[key] = _Flight(gens)
                    self.misses += 1
                    if t is not None:
                        self._tc_locked(t)[1] += 1
                    return False, None
                if budget <= 0:
                    self.misses += 1
                    if t is not None:
                        self._tc_locked(t)[1] += 1
                    return False, None
                self.flight_joins += 1
                remaining = min(budget, FLIGHT_TTL_S - (now - fl.t0))
            t0 = time.monotonic()
            filled = fl.event.wait(remaining)
            budget -= time.monotonic() - t0
            if filled:
                with self._lock:
                    e = self._entries.get(key)
                    if e is not None and e.gens == gens:
                        self._entries[key] = self._entries.pop(key)
                        self._tenant_touch_locked(key, e)
                        e.hits += 1
                        self.hits += 1
                        if t is not None:
                            self._tc_locked(t)[0] += 1
                        self.flight_served += 1
                        return True, e.value
                    budget = 0  # resolved without a usable fill
            # timed out, or an unusable fill: the next pass computes

    def put(self, key: Any, gens: Any, value: object,
            nbytes: int, tenant: str | None = None) -> bool:
        """Insert one result stamped with the generations captured BEFORE
        its inputs were read.  False when refused (disabled, or larger
        than ``max_entry_bytes`` or the whole budget).  Every outcome
        resolves the key's open flight.  With [tenants] on, the fill is
        charged to ``tenant`` (or the thread's tenant scope)."""
        if not self.enabled:
            return False
        t = self._caller_tenant(tenant)
        nbytes = int(nbytes) + ENTRY_OVERHEAD_BYTES
        if nbytes > self.max_entry_bytes or nbytes > self.budget:
            with self._lock:
                self.skipped_oversize += 1
                self._resolve_flight_locked(key)
                self._noflight[key] = None
                while len(self._noflight) > 256:
                    self._noflight.pop(next(iter(self._noflight)))
            return False
        with self._lock:
            self._noflight.pop(key, None)
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
                self._tenant_untrack_locked(key, old)
            e = _Entry(gens, value, nbytes, tenant=t)
            self._entries[key] = e
            self.bytes += nbytes
            self._tenant_track_locked(key, e)
            self.fills += 1
            if t is not None:
                self._tc_locked(t)[2] += 1
            self._resolve_flight_locked(key)
            # strict budget: evict until under, over-budget tenants'
            # oldest entries first, then the global LRU head; never the
            # entry just inserted (it fits the budget on its own)
            while self.bytes > self.budget and len(self._entries) > 1:
                vk = self._victim_key_locked(key)
                if vk is None:
                    break
                ve = self._entries.pop(vk)
                self.bytes -= ve.nbytes
                self._tenant_untrack_locked(vk, ve)
                self.evictions += 1
                if ve.tenant is not None:
                    self._tc_locked(ve.tenant)[3] += 1
            return True

    def _resolve_flight_locked(self, key: Any) -> None:
        fl = self._flights.pop(key, None)
        if fl is not None:
            fl.event.set()

    def invalidate_index(self, holder_uid: int, index: str) -> int:
        """Drop every entry of one holder's ``index`` -- a deleted index
        or field must hold nothing here -- counted as invalidations; the
        dropped keys' flights resolve.  Executor keys are ``(holder_uid,
        index, kind, sig, extra, shards, placement)``."""
        with self._lock:
            victims = [key for key in self._entries
                       if isinstance(getattr(key, "k", None), tuple)
                       and key.k[:2] == (holder_uid, index)]
            for key in victims:
                e = self._entries.pop(key)
                self.bytes -= e.nbytes
                self._tenant_untrack_locked(key, e)
                self._resolve_flight_locked(key)
            self.invalidations += len(victims)
            return len(victims)

    def invalidate_all(self) -> int:
        """Drop everything (tests, operators), counted as invalidations;
        open flights resolve so their waiters compute."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.bytes = 0
            self._tenant_bytes.clear()
            self._tenant_lru.clear()
            self.invalidations += n
            for fl in self._flights.values():
                fl.event.set()
            self._flights.clear()
            return n

    # ------------------------------------------------------------- exports

    def stats_dict(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "budget": self.budget,
                "maxEntryBytes": self.max_entry_bytes,
                "ttlS": self.ttl_s,
                "bytes": self.bytes,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "skippedOversize": self.skipped_oversize,
                "flightJoins": self.flight_joins,
                "flightServed": self.flight_served,
                "flightsOpen": len(self._flights),
                "tenantPrefEvictions": self.tenant_pref_evictions,
            }

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant accounting, the cache's half of ``GET
        /debug/tenants``: live bytes and entries, hits, misses, fills,
        evictions, and the soft budget while [tenants] is on.  Empty until
        a tenant-attributed access."""
        pol = _tenant.policy()
        out: dict[str, dict] = {}
        with self._lock:
            names = set(self._tenant_bytes) | set(self._tenant_counters)
            for t in sorted(names):
                c = self._tenant_counters.get(t, [0, 0, 0, 0])
                d = {
                    "bytes": self._tenant_bytes.get(t, 0),
                    "entries": len(self._tenant_lru.get(t, ())),
                    "hits": c[0],
                    "misses": c[1],
                    "fills": c[2],
                    "evictions": c[3],
                }
                if pol is not None:
                    d["softBudget"] = int(
                        self.budget * pol.quota_for(t).cache_share)
                out[t] = d
        return out

    def debug(self, top_n: int = 32) -> dict[str, Any]:
        """The ``/debug/resultcache`` document: the totals, the per-tenant
        accounting once a tenant-attributed access happened, and the
        largest entries (key digest, readable key, bytes, age, hits)."""
        out = self.stats_dict()
        tstats = self.tenant_stats()
        if tstats:
            out["tenants"] = tstats
        now = time.monotonic()
        with self._lock:
            entries = sorted(self._entries.items(),
                             key=lambda kv: -kv[1].nbytes)[:top_n]
            out["top"] = [{
                "key": key_digest(k),
                "repr": repr(k)[:200],
                "bytes": e.nbytes,
                "ageS": round(now - e.t, 3),
                "hits": e.hits,
            } for k, e in entries]
        return out


def key_digest(key: Any) -> str:
    """Stable short digest of a cache key for the debug surface."""
    return hashlib.blake2b(repr(key).encode(),
                           digest_size=8).hexdigest()


def result_nbytes(value: Any) -> int:
    """Byte estimate of one cached result: buffers by ``.nbytes``,
    containers and result dataclasses recursively, scalars a machine
    word."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, dict):
        return 64 + sum(result_nbytes(k) + result_nbytes(v)
                        for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return 64 + sum(result_nbytes(v) for v in value)
    if isinstance(value, (bytes, str)):
        return 48 + len(value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return 64 + sum(
            result_nbytes(getattr(value, f.name))
            for f in dataclasses.fields(value))
    return 32


# ----------------------------------------------------------- process-wide


_global: ResultCache | None = None
_global_lock = threading.Lock()
_KNOBS = ("budget", "max_entry_bytes", "ttl_s", "enabled")
_baseline: tuple | None = None
_refs = 0


def cache() -> ResultCache:
    """The process-wide cache; the lock only guards first construction."""
    global _global
    c = _global
    if c is not None:
        return c
    with _global_lock:
        if _global is None:
            _global = ResultCache()
        return _global


def configure(budget_bytes: int | None = None,
              max_entry_bytes: int | None = None,
              ttl_s: float | None = None,
              enabled: bool | None = None) -> ResultCache:
    """Apply [cache] knobs to the process-wide cache in place (counters
    and live entries survive); only explicit values land."""
    c = cache()
    with c._lock:
        if budget_bytes is not None:
            c.budget = int(budget_bytes)
        if max_entry_bytes is not None:
            c.max_entry_bytes = int(max_entry_bytes)
        if ttl_s is not None:
            c.ttl_s = float(ttl_s)
        if enabled is not None:
            c.enabled = bool(enabled)
    return c


def retain() -> None:
    """Take a server reference; the first one snapshots the knobs in
    force, which the last ``release`` restores."""
    global _refs, _baseline
    c = cache()
    with _global_lock:
        if _refs == 0 and _baseline is None:
            _baseline = tuple(getattr(c, k) for k in _KNOBS)
        _refs += 1


def release() -> None:
    """Drop a server reference; the last one restores the snapshot."""
    global _refs, _baseline
    c = cache()
    with _global_lock:
        if _refs > 0:
            _refs -= 1
        if _refs == 0 and _baseline is not None:
            with c._lock:
                for k, v in zip(_KNOBS, _baseline):
                    setattr(c, k, v)
            _baseline = None


def refs() -> int:
    return _refs
