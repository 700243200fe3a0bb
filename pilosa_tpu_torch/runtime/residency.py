"""Tiered device-memory residency: HBM in front of a host-RAM tier
(with an optional disk tier behind it), async promotion, and graceful
degradation under memory pressure.

Copy of pilosa_tpu/runtime/residency.py for the card.  Every cached
device tensor -- a field's row stacks, container leaves, delta stacks,
time-range stacks, BSI plane stacks and matrix stacks
(``Field._device_cache`` / ``_matrix_stack_cache``), and a fragment's row
matrix and BSI planes (``Fragment._device_cache``) -- is registered here
under ONE process-wide HBM byte budget with LRU eviction across owners.

- **Eviction demotes instead of drops.**  Owners hand ``admit()`` the
  assembled HOST bytes (``host=``) plus a rebuild closure
  (``promote=``); those bytes live in a host-RAM tier (LRU under its
  own ``[residency] host-budget-bytes``), so an HBM eviction only drops
  the device reference -- the host-side assembly (fragment locks,
  concatenation) is not repeated while the host entry stays valid.
  Host-tier overflow spills ndarray payloads to the optional disk tier
  (``disk-path``) or drops.
- **Misses enqueue an async promotion.**  A query that misses HBM but
  hits the host tier submits the entry to a bounded promotion worker
  pool (single-flight per key, each job admitted under the admission
  controller's ``internal`` class) and waits a BOUNDED slice of its
  deadline; if the promotion lands in time the query reads the promoted
  device entry, otherwise it takes the **host-bytes route**: the owner's
  ``fallback`` uploads the host bytes for that one query, uncached, and
  the same CUDA kernel runs on them (``note_fallback`` counts it).  The
  promotion continues in the background for the next query.  A
  promotion's upload is complete before its entry is published to the
  owner's cache: the worker synchronizes its CUDA stream first.
- **Pressure sheds lowest-value work first.**  A full promotion queue
  drops queued PREFETCH jobs before refusing a demand promotion; a
  refused demand promotion is an immediate host-bytes read, never an
  unbounded stall; admission-saturated workers shed the same way.
- **Out-of-memory feeds back into the budget.**  :func:`run_with_oom_retry`
  (the evict-and-retry wrapper of the executor's fused Count, Row and
  TopN dispatches and the coalescer's flushes) catches
  ``torch.cuda.OutOfMemoryError`` and nothing else, evicts every tracked
  entry, shrinks the HBM budget 10 % and retries once.

The budget is ``PILOSA_TPU_DEVICE_BUDGET_BYTES`` when set (the variable
the reference reads), else 60 % of the card's memory
(``torch.cuda.mem_get_info``), else, with no card, 2 GiB.  Payload
bytes are an ndarray's ``nbytes`` or a tensor's ``numel() *
element_size()``, summed over a tuple's members.

The predictive prefetcher (``runtime/prefetch.py``) promotes host-tier
entries ahead of demand, ranked by ``observe.access_stats``.

``?notiers=1`` (ExecOptions.tiers=False -> :class:`no_tiers`) routes the
exact pre-tier behavior: misses rebuild inline, evictions drop.  Results
are byte-identical either way.

Left out, with the port's lack of the layers they hook into: the
``lockcheck`` lock registry (plain ``threading.Lock``s), the
``residency.promote`` failpoint of the promotion worker (no
``faultinject``), the flight-recorder journal stamps of
``demote_coldest`` and the promotion worker and the ``devobs``
``device.oom_retries`` stamp of ``run_with_oom_retry`` (no
observability layer: :func:`oom_retries` counts the retries instead),
and ``live()`` (a torch tensor cannot outlive its backend, so a cached
one is never a deleted buffer).  Added: ``forget_owner``, with which a
closing field or fragment drops its demoted host twins as well as its
resident entries, and ``oom_retries``.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque

import numpy as np
import torch

from pilosa_tpu_torch.serve import tenant as _tenantmod
from pilosa_tpu_torch.serve.deadline import tls_scope as _tls_scope


def _operator_sized() -> bool:
    return bool(os.environ.get("PILOSA_TPU_DEVICE_BUDGET_BYTES"))


def _default_budget() -> int:
    env = os.environ.get("PILOSA_TPU_DEVICE_BUDGET_BYTES")
    if env:
        return int(env)
    # the card's memory: leave headroom for kernels' workspaces and live
    # intermediates; caches may take at most 60%
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info(
            torch.cuda.current_device())[1] * 0.6)
    return 2 << 30


#: The HBM budget never feedback-shrinks below this floor -- a storm of
#: out-of-memory retries must converge on "small but serving", not zero.
MIN_BUDGET_BYTES = 16 << 20


# --------------------------------------------------------------------
# [residency] runtime config (process-wide, like [containers])
# --------------------------------------------------------------------


class TierRuntimeConfig:
    """The process-wide [residency] knobs.  ``host_budget_bytes`` is
    the host-RAM tier cap (0 disables tiering entirely -- the exact
    pre-tier manager); ``promote_wait_ms`` bounds how long a demand
    miss parks on its async promotion before taking the host-bytes
    route (further capped by the request's own deadline)."""

    __slots__ = ("host_budget_bytes", "disk_path", "disk_budget_bytes",
                 "promote_workers", "promote_queue", "promote_wait_ms",
                 "prefetch", "prefetch_interval")

    def __init__(self) -> None:
        self.host_budget_bytes = 1 << 30
        self.disk_path = ""  # empty = no disk tier
        self.disk_budget_bytes = 4 << 30
        self.promote_workers = 2
        self.promote_queue = 64
        self.promote_wait_ms = 50.0
        self.prefetch = True
        self.prefetch_interval = 0.25


_cfg = TierRuntimeConfig()
_cfg_lock = threading.Lock()
_baseline: tuple | None = None
_refs = 0


def config() -> TierRuntimeConfig:
    return _cfg


def configure(host_budget_bytes: int | None = None,
              disk_path: str | None = None,
              disk_budget_bytes: int | None = None,
              promote_workers: int | None = None,
              promote_queue: int | None = None,
              promote_wait_ms: float | None = None,
              prefetch: bool | None = None,
              prefetch_interval: float | None = None) -> TierRuntimeConfig:
    """Apply [residency] config in place -- only explicit values land,
    so a second in-process server cannot wipe the first's settings with
    defaults (the containers.configure contract)."""
    with _cfg_lock:
        if host_budget_bytes is not None:
            _cfg.host_budget_bytes = int(host_budget_bytes)
        if disk_path is not None:
            _cfg.disk_path = str(disk_path)
        if disk_budget_bytes is not None:
            _cfg.disk_budget_bytes = int(disk_budget_bytes)
        if promote_workers is not None:
            _cfg.promote_workers = max(1, int(promote_workers))
        if promote_queue is not None:
            _cfg.promote_queue = max(1, int(promote_queue))
        if promote_wait_ms is not None:
            _cfg.promote_wait_ms = float(promote_wait_ms)
        if prefetch is not None:
            _cfg.prefetch = bool(prefetch)
        if prefetch_interval is not None:
            _cfg.prefetch_interval = float(prefetch_interval)
    return _cfg


def retain() -> None:
    """Take a server reference; the FIRST holder snapshots the
    pre-server baseline config (restore composes under any close
    order)."""
    global _refs, _baseline
    with _cfg_lock:
        if _refs == 0 and _baseline is None:
            _baseline = (_cfg.host_budget_bytes, _cfg.disk_path,
                         _cfg.disk_budget_bytes, _cfg.promote_workers,
                         _cfg.promote_queue, _cfg.promote_wait_ms,
                         _cfg.prefetch, _cfg.prefetch_interval)
        _refs += 1


def release() -> None:
    """Drop a server reference; the LAST holder restores the captured
    baseline and stops the shared promotion workers."""
    global _refs, _baseline
    stop = False
    with _cfg_lock:
        if _refs > 0:
            _refs -= 1
        if _refs == 0 and _baseline is not None:
            (_cfg.host_budget_bytes, _cfg.disk_path,
             _cfg.disk_budget_bytes, _cfg.promote_workers,
             _cfg.promote_queue, _cfg.promote_wait_ms,
             _cfg.prefetch, _cfg.prefetch_interval) = _baseline
            _baseline = None
            stop = True
    if stop:
        promoter().stop()


# --------------------------------------------------------------------
# per-request escape (?notiers=1)
# --------------------------------------------------------------------

_tls = threading.local()  # .notiers: True inside a no_tiers scope


class no_tiers(_tls_scope):
    """Install the ?notiers=1 escape for a scope: host-tier lookups
    miss, evictions drop instead of demoting, and admits register no
    host payload -- the exact pre-tier manager behavior.  Re-entrant;
    the executor installs it for the whole execution."""

    __slots__ = ()

    def __init__(self, on: bool = True):
        super().__init__(_tls, "notiers", on)


def tiers_off_scope() -> bool:
    """True while this thread runs under a ``no_tiers`` scope."""
    return bool(getattr(_tls, "notiers", False))


def tiers_enabled() -> bool:
    """Tiering in force for THIS thread right now: the [residency] host
    budget is nonzero and no ?notiers scope is installed."""
    return _cfg.host_budget_bytes > 0 and not tiers_off_scope()


# --------------------------------------------------------------------
# host/disk tier entries
# --------------------------------------------------------------------


def _nbytes(x) -> int:
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _payload_nbytes(payload) -> int:
    """Host bytes held by one tier payload: an ndarray or tensor, or a
    tuple whose array leaves count (non-array metadata is negligible)."""
    if isinstance(payload, (tuple, list)):
        return sum(_nbytes(p) for p in payload)
    return _nbytes(payload)


def _payload_arrays_only(payload) -> bool:
    """True when the payload is spillable to disk: a bare ndarray or a
    flat tuple of ndarrays."""
    if isinstance(payload, np.ndarray):
        return True
    return (isinstance(payload, (tuple, list)) and len(payload) > 0
            and all(isinstance(p, np.ndarray) for p in payload))


class HostEntry:
    """One demotable/demoted entry's host-side half: the assembled
    bytes, the validity token, and the rebuild closure that turns the
    bytes back into an owner-cache entry (upload included)."""

    __slots__ = ("cache", "key", "token", "payload", "promote",
                 "fallback", "nbytes", "kind", "devices", "spilled",
                 "tenant", "kind_detail")

    def __init__(self, cache: dict, key, token, payload, promote,
                 nbytes: int, kind: str, devices: int, fallback=None,
                 tenant: str | None = None, kind_detail=None):
        self.cache = cache
        self.key = key
        self.token = token
        self.payload = payload  # None while spilled to disk
        self.promote = promote
        # host-bytes adapter: payload -> the value one query consumes
        # (the port uploads it uncached; None: the payload itself is
        # that value)
        self.fallback = fallback
        self.nbytes = nbytes
        self.kind = kind
        self.devices = devices
        self.spilled: str | None = None  # .npz path when on disk
        # the tenant whose query assembled these bytes ([tenants]
        # isolation; None while off) -- host-tier byte attribution
        self.tenant = tenant
        # per-kind byte breakout ({"array": n, "run": n}) restored on
        # re-promotion so stats()["kinds"] survives a demote cycle
        self.kind_detail = kind_detail

    def host_value(self):
        """The host-bytes route's value for this entry."""
        if self.fallback is not None:
            return self.fallback(self.payload)
        return self.payload

    @property
    def eid(self) -> tuple:
        return (id(self.cache), self.key)


class ResidencyManager:
    """Tiered LRU accounting of cached device tensors across all owners.

    Owners call ``admit(cache_dict, key, nbytes, ...)`` AFTER inserting
    the entry into their own dict; the manager may synchronously evict
    other entries (possibly from other owners) by deleting them from
    their owner dicts -- demoting their host bytes into the host tier
    when the owner supplied them.  Owners therefore treat a missing key
    as a cold cache and consult ``host_lookup`` before rebuilding."""

    def __init__(self, budget_bytes: int | None = None):
        self.budget = budget_bytes or _default_budget()
        self.budget_initial = self.budget
        # True when the budget was chosen by an operator (explicit
        # constructor arg or env var) rather than probed; cache-entry
        # caps only relax for deliberately-sized deployments
        self.operator_sized = budget_bytes is not None or _operator_sized()
        self._lock = threading.Lock()
        # (owner dict id, key) -> (owner dict, key, nbytes, kind,
        # devices, tenant); dict preserves insertion order = LRU order
        # (move-to-end on touch)
        self._entries: dict[tuple, tuple] = {}
        self.total = 0
        # sum of per-entry ceil(nbytes / devices); equal to total on one
        # card
        self._per_device = 0
        # bytes by representation kind ("dense" tensors vs the
        # "compressed" container pools)
        self._by_kind: dict[str, int] = {}
        # eid -> {"array": n, "run": n}: sub-kind byte breakout for
        # kinds-split container leaves, charged ADDITIVELY into _by_kind
        self._kind_detail: dict[tuple, dict] = {}
        self.evictions = 0
        self.admits = 0
        # max SETTLED bytes (post-eviction)
        self.high_water = 0
        # ---------------- host tier ----------------
        # eid -> HostEntry; insertion order = LRU
        self._host: dict[tuple, HostEntry] = {}
        self._host_bytes = 0
        # eid -> HostEntry whose payload lives in a .npz on disk
        self._disk: dict[tuple, HostEntry] = {}
        self._disk_bytes = 0
        self._spill_seq = 0
        # tier accounting
        self.demotions = 0       # HBM evictions that kept host bytes
        self.tier_hits = 0       # host_lookup served a valid entry
        self.tier_misses = 0     # host_lookup found nothing usable
        self.tier_spills = 0     # host-tier overflow pushed to disk
        self.tier_spill_drops = 0  # overflow with no disk tier: dropped
        self.disk_hits = 0       # disk payload reloaded into host tier
        self.fallbacks = 0       # queries served over host bytes
        self.oom_budget_shrinks = 0
        # eids whose resident entry was installed by the prefetcher and
        # not yet touched by a query (prefetch.useful accounting)
        self._prefetched: set[tuple] = set()
        self.prefetch_useful = 0
        # ---------------- per-tenant accounting ([tenants]) --------
        # tenant -> HBM bytes / host-tier bytes its stacks hold, and the
        # demotion PRESSURE charged to each tenant (evictions its
        # over-quota admissions forced onto its own entries)
        self._tenant_bytes: dict[str, int] = {}
        self._tenant_host_bytes: dict[str, int] = {}
        self._tenant_pressure: dict[str, int] = {}

    @staticmethod
    def _id(cache: dict, key) -> tuple:
        return (id(cache), key)

    # --------------------------------------------------- tenant hooks

    @staticmethod
    def _admitting_tenant(old_tenant: str | None) -> str | None:
        """The tenant this admission charges: the thread-local scope
        (the executor installs the request's id), inheriting the entry's
        previous owner when the admitting thread is anonymous
        (promotion workers, prefetch, prewarm) -- None while [tenants]
        is off."""
        if not _tenantmod.enabled():
            return None
        t = _tenantmod.current()
        if t is not None:
            return _tenantmod.resolve(t)
        return old_tenant or _tenantmod.DEFAULT_TENANT

    @staticmethod
    def _tenant_quota_bytes(t: str, budget: int) -> int:
        """The tenant's share of ``budget`` (0 = unenforced)."""
        pol = _tenantmod.policy()
        if pol is None:
            return 0
        return int(budget * pol.quota_for(t).residency_share)

    def _tenant_charge_locked(self, t: str | None, n: int) -> None:
        if t is not None:
            self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) + n

    def _tenant_host_charge_locked(self, t: str | None, n: int) -> None:
        if t is not None:
            self._tenant_host_bytes[t] = \
                self._tenant_host_bytes.get(t, 0) + n

    def _kind_detail_drop_locked(self, eid: tuple) -> None:
        """Un-charge an entry's sub-kind byte breakout from
        ``_by_kind`` (eviction/forget/demote/overwrite)."""
        d = self._kind_detail.pop(eid, None)
        if d:
            for k, v in d.items():
                self._by_kind[k] = self._by_kind.get(k, 0) - v

    # ---------------------------------------------------------- admit

    def admit(self, cache: dict, key, nbytes: int,
              kind: str = "dense", devices: int = 1,
              token=None, host=None, promote=None, fallback=None,
              prefetched: bool = False, kind_detail=None) -> None:
        """Track an entry just inserted into ``cache`` under ``key``;
        evict least-recently-used entries (from any owner) until the
        total fits the budget.  The entry being admitted is never its
        own victim, so the total is bounded by max(budget, largest
        single entry) even when individual entries exceed the whole
        budget.

        ``token``+``host``+``promote`` opt the entry into the host tier:
        ``host`` is the assembled host payload, ``promote`` a closure
        rebuilding the owner-cache entry value from it (upload included)
        -- with them, eviction DEMOTES (keeps the host bytes for async
        re-promotion) instead of dropping."""
        eid = self._id(cache, key)
        tiers = host is not None and promote is not None \
            and tiers_enabled()
        spill: list[HostEntry] = []
        with self._lock:
            old = self._entries.pop(eid, None)
            ten = self._admitting_tenant(
                old[5] if old is not None else None)
            if old is not None:
                self.total -= old[2]
                self._by_kind[old[3]] = \
                    self._by_kind.get(old[3], 0) - old[2]
                self._per_device -= -(-old[2] // old[4])
                self._tenant_charge_locked(old[5], -old[2])
            self._kind_detail_drop_locked(eid)
            self._entries[eid] = (cache, key, nbytes, kind,
                                  max(1, devices), ten)
            self.total += nbytes
            self._per_device += -(-nbytes // max(1, devices))
            self._by_kind[kind] = self._by_kind.get(kind, 0) + nbytes
            if kind_detail:
                self._kind_detail[eid] = dict(kind_detail)
                for k, v in kind_detail.items():
                    self._by_kind[k] = self._by_kind.get(k, 0) + v
            self._tenant_charge_locked(ten, nbytes)
            self.admits += 1
            if prefetched:
                self._prefetched.add(eid)
            else:
                self._prefetched.discard(eid)
            if tiers:
                # the host payload is registered ONCE, here, whether the
                # entry is resident or demoted: one accounting site
                spill = self._host_put_locked(HostEntry(
                    cache, key, token, host, promote,
                    _payload_nbytes(host), kind, max(1, devices),
                    fallback=fallback, tenant=ten,
                    kind_detail=kind_detail))
            if ten is not None:
                # per-tenant HBM quota ([tenants] residency-share): an
                # over-quota tenant demotes its OWN coldest stacks; the
                # pressure is charged to the tenant that caused it
                tq = self._tenant_quota_bytes(ten, self.budget)
                while (tq > 0
                       and self._tenant_bytes.get(ten, 0) > tq):
                    vid = next((v for v, e in self._entries.items()
                                if e[5] == ten and v != eid), None)
                    if vid is None:
                        break
                    self._evict_one_locked(vid)
                    self._tenant_pressure[ten] = \
                        self._tenant_pressure.get(ten, 0) + 1
            while self.total > self.budget and len(self._entries) > 1:
                # prefer demoting a dense twin over a compressed
                # container pool (the pool is what the bitmap VM gathers
                # from); the scan is bounded, past it the LRU head goes
                victim_id = next(
                    (vid for vid, e in itertools.islice(
                        self._entries.items(), 32)
                     if vid != eid and e[3] == "dense"),
                    None)
                if victim_id is None:
                    victim_id = next(iter(self._entries))
                if victim_id == eid:
                    # never evict the entry being admitted
                    self._entries[eid] = self._entries.pop(eid)
                    continue
                self._evict_one_locked(victim_id)
            # high-water marks the SETTLED residency level
            if self.total > self.high_water:
                self.high_water = self.total
        if spill:
            self._spill_victims(spill)

    def _evict_one_locked(self, victim_id: tuple) -> None:
        """Drop one HBM entry (owner-dict pop included), demoting --
        i.e. leaving its host-tier twin in place -- when one exists."""
        (vcache, vkey, vbytes, vkind,
         vdev, vtenant) = self._entries.pop(victim_id)
        self.total -= vbytes
        self._per_device -= -(-vbytes // vdev)
        self._by_kind[vkind] = self._by_kind.get(vkind, 0) - vbytes
        self._kind_detail_drop_locked(victim_id)
        self._tenant_charge_locked(vtenant, -vbytes)
        self.evictions += 1
        self._prefetched.discard(victim_id)
        if victim_id in self._host or victim_id in self._disk:
            self.demotions += 1
        vcache.pop(vkey, None)

    # ------------------------------------------------------ host tier

    def _host_put_locked(self, ent: HostEntry) -> list[HostEntry]:
        """Insert/refresh one host-tier entry; returns the LRU-overflow
        victims DETACHED from the tier -- the caller hands them to
        :meth:`_spill_victims` AFTER releasing the lock."""
        eid = ent.eid
        old = self._host.pop(eid, None)
        if old is not None:
            self._host_bytes -= old.nbytes
            self._tenant_host_charge_locked(old.tenant, -old.nbytes)
        self._drop_disk_locked(eid)
        self._host[eid] = ent
        self._host_bytes += ent.nbytes
        self._tenant_host_charge_locked(ent.tenant, ent.nbytes)
        victims: list[HostEntry] = []
        if ent.tenant is not None:
            # per-tenant host-tier quota (residency-share of the host
            # budget): the HBM rule, applied to the tier
            tq = self._tenant_quota_bytes(ent.tenant,
                                          _cfg.host_budget_bytes)
            while (tq > 0
                   and self._tenant_host_bytes.get(ent.tenant, 0) > tq):
                vid = next((v for v, e in self._host.items()
                            if e.tenant == ent.tenant and v != eid),
                           None)
                if vid is None:
                    break
                v = self._host.pop(vid)
                self._host_bytes -= v.nbytes
                self._tenant_host_charge_locked(v.tenant, -v.nbytes)
                victims.append(v)
        while (self._host_bytes > _cfg.host_budget_bytes
               and len(self._host) > 1):
            vid = next(iter(self._host))
            if vid == eid:
                self._host[eid] = self._host.pop(eid)
                continue
            v = self._host.pop(vid)
            self._host_bytes -= v.nbytes
            self._tenant_host_charge_locked(v.tenant, -v.nbytes)
            victims.append(v)
        return victims

    def _spill_victims(self, victims: list[HostEntry]) -> None:
        """Host-tier overflow handling, OUTSIDE the manager lock: spill
        pure-array payloads to the disk tier (when configured) or drop.
        The spilled record is a FRESH HostEntry -- the evicted one may
        still be held by demand waiters and queued promotion jobs."""
        for v in victims:
            if not (_cfg.disk_path
                    and _payload_arrays_only(v.payload)):
                with self._lock:
                    self.tier_spill_drops += 1
                continue
            with self._lock:
                path = self._spill_path_locked()
            try:
                arrs = ([v.payload] if isinstance(v.payload, np.ndarray)
                        else list(v.payload))
                np.savez(path, *arrs)
            except OSError:
                with self._lock:
                    self.tier_spill_drops += 1
                continue
            d = HostEntry(v.cache, v.key, v.token, None, v.promote,
                          v.nbytes, v.kind, v.devices,
                          fallback=v.fallback, tenant=v.tenant,
                          kind_detail=v.kind_detail)
            d.spilled = path
            with self._lock:
                eid = v.eid
                if eid in self._host or eid in self._disk:
                    # a fresh admit re-entered while we wrote: our spill
                    # is stale -- discard it, keep the live entry
                    stale = path
                else:
                    stale = None
                    self._disk[eid] = d
                    self._disk_bytes += d.nbytes
                    self.tier_spills += 1
                    while (self._disk_bytes > _cfg.disk_budget_bytes
                           and len(self._disk) > 1):
                        self._drop_disk_locked(next(iter(self._disk)),
                                               count_drop=True)
            if stale is not None:
                try:
                    os.remove(stale)
                except OSError:
                    pass

    def _spill_path_locked(self) -> str:
        self._spill_seq += 1
        os.makedirs(_cfg.disk_path, exist_ok=True)
        return os.path.join(_cfg.disk_path,
                            f"spill-{os.getpid()}-{self._spill_seq}.npz")

    def _drop_disk_locked(self, eid: tuple,
                          count_drop: bool = False) -> None:
        v = self._disk.pop(eid, None)
        if v is None:
            return
        self._disk_bytes -= v.nbytes
        if count_drop:
            self.tier_spill_drops += 1
        if v.spilled:
            try:
                os.remove(v.spilled)
            except OSError:
                pass

    def host_lookup(self, cache: dict, key, token) -> HostEntry | None:
        """The tier consult on an owner-cache miss: a HostEntry whose
        token still matches (LRU-touched), or None.  A stale entry is
        dropped on sight.  Disk-tier hits reload into the host tier
        first."""
        if not tiers_enabled():
            return None
        eid = self._id(cache, key)
        loaded = None
        with self._lock:
            e = self._host.get(eid)
            if e is None and eid in self._disk:
                loaded = self._disk[eid]
        if loaded is not None:
            # np.load OUTSIDE the lock; a racing drop wastes one read
            payload = self._load_spill(loaded)
            spill: list[HostEntry] = []
            with self._lock:
                if payload is not None and self._disk.get(eid) is loaded:
                    self._drop_disk_locked(eid)
                    fresh = HostEntry(loaded.cache, loaded.key,
                                      loaded.token, payload,
                                      loaded.promote, loaded.nbytes,
                                      loaded.kind, loaded.devices,
                                      fallback=loaded.fallback,
                                      tenant=loaded.tenant,
                                      kind_detail=loaded.kind_detail)
                    spill = self._host_put_locked(fresh)
                    self.disk_hits += 1
            if spill:
                self._spill_victims(spill)
        with self._lock:
            e = self._host.get(eid)
            if e is None:
                self.tier_misses += 1
                return None
            if e.token != token:
                self._host.pop(eid, None)
                self._host_bytes -= e.nbytes
                self._tenant_host_charge_locked(e.tenant, -e.nbytes)
                self.tier_misses += 1
                return None
            self._host[eid] = self._host.pop(eid)  # LRU touch
            self.tier_hits += 1
            return e

    @staticmethod
    def _load_spill(ent: HostEntry):
        try:
            with np.load(ent.spilled) as z:
                arrs = [z[k] for k in z.files]
        except (OSError, ValueError):
            return None
        return arrs[0] if len(arrs) == 1 else tuple(arrs)

    def note_fallback(self) -> None:
        """One query served over host bytes (the deadline-bounded
        host-bytes route)."""
        with self._lock:
            self.fallbacks += 1

    # ------------------------------------------------------ lifecycle

    def touch(self, cache: dict, key) -> None:
        """Mark an entry recently used (cache hit)."""
        eid = self._id(cache, key)
        with self._lock:
            e = self._entries.pop(eid, None)
            if e is not None:
                self._entries[eid] = e
                if eid in self._prefetched:
                    # a query read an entry the prefetcher promoted
                    self._prefetched.discard(eid)
                    self.prefetch_useful += 1

    def forget(self, cache: dict, key) -> None:
        """Stop tracking an entry the owner removed itself (overwrite,
        invalidation, close) -- host/disk twins drop too."""
        eid = self._id(cache, key)
        with self._lock:
            e = self._entries.pop(eid, None)
            self._prefetched.discard(eid)
            if e is not None:
                self.total -= e[2]
                self._per_device -= -(-e[2] // e[4])
                self._by_kind[e[3]] = self._by_kind.get(e[3], 0) - e[2]
                self._kind_detail_drop_locked(eid)
                self._tenant_charge_locked(e[5], -e[2])
            h = self._host.pop(eid, None)
            if h is not None:
                self._host_bytes -= h.nbytes
                self._tenant_host_charge_locked(h.tenant, -h.nbytes)
            self._drop_disk_locked(eid)

    def forget_owner(self, cache: dict) -> int:
        """Forget every entry of one owner dict, resident or demoted,
        host and disk twins included -- a closing owner's bytes must not
        linger in the tiers, where the prefetcher would promote them
        back into a dead cache (the reference's owners forget only their
        resident keys).  Returns the entries forgotten."""
        cid = id(cache)
        with self._lock:
            keys = {eid[1] for tier in (self._entries, self._host,
                                        self._disk)
                    for eid in tier if eid[0] == cid}
        for k in keys:
            self.forget(cache, k)
        return len(keys)

    def demote(self, cache: dict, key) -> None:
        """Owner-side demotion (cache-entry-cap eviction): stop HBM
        accounting but KEEP the host/disk twin.  With tiering off this
        is exactly forget()."""
        if not tiers_enabled():
            self.forget(cache, key)
            return
        eid = self._id(cache, key)
        with self._lock:
            e = self._entries.pop(eid, None)
            self._prefetched.discard(eid)
            if e is not None:
                self.total -= e[2]
                self._per_device -= -(-e[2] // e[4])
                self._by_kind[e[3]] = self._by_kind.get(e[3], 0) - e[2]
                self._kind_detail_drop_locked(eid)
                self._tenant_charge_locked(e[5], -e[2])
                if eid in self._host or eid in self._disk:
                    self.demotions += 1

    def evict_all(self) -> int:
        """Drop EVERY tracked HBM cache entry (the out-of-memory retry
        drains all cached device tensors before re-launching).  Host-tier
        twins survive.  Returns the number of entries evicted."""
        with self._lock:
            victims = list(self._entries.values())
            n_demoted = sum(
                1 for vcache, vkey, *_ in victims
                if (id(vcache), vkey) in self._host
                or (id(vcache), vkey) in self._disk)
            self._entries.clear()
            self.total = 0
            self._per_device = 0
            self._by_kind.clear()
            self._kind_detail.clear()
            self._tenant_bytes.clear()
            self._prefetched.clear()
            self.evictions += len(victims)
            self.demotions += n_demoted
            # owner-dict pops stay under the lock: released, a
            # concurrent admit could insert a fresh entry for the same
            # key between the snapshot and the pop
            for vcache, vkey, *_rest in victims:
                vcache.pop(vkey, None)
        return len(victims)

    def note_oom_feedback(self) -> None:
        """One recovered out-of-memory error: shrink the HBM budget 10%
        (floored at MIN_BUDGET_BYTES) so the tier demotes harder."""
        with self._lock:
            new = max(MIN_BUDGET_BYTES, int(self.budget * 0.9))
            if new < self.budget:
                self.budget = new
                self.oom_budget_shrinks += 1

    # ----------------------------------------------------------- views

    def stats(self) -> dict:
        with self._lock:
            return {"budget": self.budget, "total": self.total,
                    "entries": len(self._entries),
                    "evictions": self.evictions,
                    "admits": self.admits,
                    "high_water": self.high_water,
                    "per_device": self._per_device,
                    "kinds": {k: v for k, v in self._by_kind.items()
                              if v},
                    "tenants": {t: v for t, v
                                in self._tenant_bytes.items() if v},
                    "tiers": self._tier_stats_locked()}

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant residency accounting -- the residency half of
        GET /debug/tenants: HBM bytes, host-tier bytes, the HBM quota in
        force, and the demotion pressure charged to each tenant."""
        with self._lock:
            names = (set(self._tenant_bytes)
                     | set(self._tenant_host_bytes)
                     | set(self._tenant_pressure))
            out = {}
            for t in sorted(names):
                d = {
                    "hbmBytes": self._tenant_bytes.get(t, 0),
                    "hostBytes": self._tenant_host_bytes.get(t, 0),
                    "pressure": self._tenant_pressure.get(t, 0),
                }
                q = self._tenant_quota_bytes(t, self.budget)
                if q:
                    d["hbmQuota"] = q
                out[t] = d
            return out

    def _tier_stats_locked(self) -> dict:
        return {
            "host": {
                "budget": _cfg.host_budget_bytes,
                "bytes": self._host_bytes,
                "entries": len(self._host),
            },
            "disk": {
                "path": _cfg.disk_path,
                "bytes": self._disk_bytes,
                "entries": len(self._disk),
            },
            "demotions": self.demotions,
            "hits": self.tier_hits,
            "misses": self.tier_misses,
            "spills": self.tier_spills,
            "spillDrops": self.tier_spill_drops,
            "diskHits": self.disk_hits,
            "fallbacks": self.fallbacks,
            "oomBudgetShrinks": self.oom_budget_shrinks,
            "budgetInitial": self.budget_initial,
            "prefetchUseful": self.prefetch_useful,
        }

    def resident_eids(self) -> list[tuple]:
        """The eids currently HBM-resident (LRU order, coldest first)
        -- the prefetcher's eviction-victim pool."""
        with self._lock:
            return list(self._entries)

    def demote_coldest(self, scores: dict) -> float | None:
        """Demote the lowest-scored resident entry (``scores`` maps eid
        -> access score; unlisted residents score 0) -- the prefetcher's
        victim selection.  Only entries with a host/disk twin are
        eligible (a demotion must never turn into a drop).  Returns the
        victim's score, or None when nothing was eligible."""
        with self._lock:
            best = None
            best_score = None
            for eid in self._entries:
                if eid not in self._host and eid not in self._disk:
                    continue
                s = scores.get(eid, 0.0)
                if best_score is None or s < best_score:
                    best, best_score = eid, s
            if best is None:
                return None
            self._evict_one_locked(best)
            # an explicit demotion decision, not budget pressure
            self.evictions -= 1
        return best_score

    def host_candidates(self, limit: int = 64) -> list[HostEntry]:
        """Host-tier entries whose owner cache currently lacks them --
        the prefetcher's promotion candidates, most-recently-used
        first."""
        with self._lock:
            out = [e for e in reversed(list(self._host.values()))
                   if e.key not in e.cache]
            return out[:limit]

    def top_entries(self, n: int = 20) -> list[dict]:
        """Largest tracked device cache entries."""
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: -e[2])[:n]
        return [{"key": repr(key)[:160], "bytes": nbytes,
                 "kind": kind, "devices": devices,
                 **({"tenant": tenant} if tenant is not None else {})}
                for _, key, nbytes, kind, devices, tenant in entries]

    def close(self) -> None:
        """Drop spill files and the host tier (reset)."""
        with self._lock:
            for eid in list(self._disk):
                self._drop_disk_locked(eid)
            self._host.clear()
            self._host_bytes = 0
            self._tenant_host_bytes.clear()


_global: ResidencyManager | None = None
_global_lock = threading.Lock()


def manager() -> ResidencyManager:
    """The process-wide manager (one budget per process)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = ResidencyManager()
        return _global


def reset(budget_bytes: int | None = None) -> ResidencyManager:
    """Replace the global manager (tests; budget reconfiguration).
    Stops promotion workers and clears the tier config baseline so no
    cross-test state survives."""
    global _global, _baseline, _refs
    promoter().stop()
    with _global_lock:
        if _global is not None:
            _global.close()
        _global = ResidencyManager(budget_bytes)
        mgr = _global
    with _cfg_lock:
        _cfg.__init__()
        _baseline = None
        _refs = 0
    return mgr


# --------------------------------------------------------------------
# async promotion
# --------------------------------------------------------------------


class PromotionFlight:
    """One in-flight promotion (single-flight per eid).  Demand waiters
    park on ``event`` for a bounded slice of their deadline; ``ok`` says
    whether the owner-cache entry was installed."""

    __slots__ = ("event", "ok", "error", "prefetch")

    def __init__(self, prefetch: bool):
        self.event = threading.Event()
        self.ok = False
        self.error: BaseException | None = None
        self.prefetch = prefetch


def _settle_uploads() -> None:
    """Wait for this thread's uploads on the card: a promoted entry is
    published to its owner's cache only once its bytes are complete, so
    a query on another thread never reads a half-copied tensor."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class Promoter:
    """Bounded background promotion pool: host-tier entries move back
    onto the card OFF the query path.  Single-flight per key; each job
    runs under the admission controller's ``internal`` class when one is
    wired (query saturation sheds promotions -- the query that wanted it
    takes the host-bytes route instead of queueing).  A full queue sheds
    queued PREFETCH jobs before refusing demand work."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: deque = deque()  # (HostEntry, PromotionFlight)
        self._flights: dict[tuple, PromotionFlight] = {}
        self._wake = threading.Event()
        # stop() bumps the epoch; workers retire when theirs is stale
        self._epoch = 0
        self._workers: list[threading.Thread] = []
        self.admission = None  # server assembly wires the controller
        self.promotions = 0
        self.failures = 0
        self.sheds = 0          # demand jobs refused (queue/admission)
        self.prefetch_issued = 0
        self.prefetch_completed = 0
        self.prefetch_shed = 0

    # ------------------------------------------------------- lifecycle

    def _ensure_started_locked(self) -> None:
        self._workers = [w for w in self._workers if w.is_alive()]
        want = _cfg.promote_workers
        while len(self._workers) < want:
            t = threading.Thread(target=self._run, daemon=True,
                                 args=(self._epoch,),
                                 name=f"residency-promote-"
                                      f"{len(self._workers)}")
            self._workers.append(t)
            t.start()

    def stop(self) -> None:
        """Retire the current worker generation and fail every
        queued/in-flight job (server close / reset).  Restartable: the
        next submit spawns workers under the new epoch."""
        with self._lock:
            self._epoch += 1
            workers, self._workers = self._workers, []
            drained = list(self._queue)
            self._queue.clear()
            flights = dict(self._flights)
            self._flights.clear()
        self._wake.set()
        for _, fl in drained:
            fl.error = RuntimeError("promoter stopped")
            fl.event.set()
        for fl in flights.values():
            fl.event.set()
        for w in workers:
            w.join(timeout=2)
        self.admission = None

    # ---------------------------------------------------------- submit

    def submit(self, ent: HostEntry,
               prefetch: bool = False) -> PromotionFlight | None:
        """Enqueue one promotion (or join the in-flight one).  Returns
        the flight, or None when the job was refused: a prefetch over a
        full queue is silently shed; a DEMAND job first evicts a queued
        prefetch to make room and is only refused when the queue is all
        demand work (the caller takes the host-bytes route)."""
        eid = ent.eid
        with self._lock:
            fl = self._flights.get(eid)
            if fl is not None:
                if not prefetch and fl.prefetch:
                    fl.prefetch = False  # demand upgrades the flight
                return fl
            if len(self._queue) >= _cfg.promote_queue:
                if prefetch:
                    self.prefetch_shed += 1
                    return None
                # demand pressure sheds prefetch work first
                for i, (qe, qf) in enumerate(self._queue):
                    if qf.prefetch:
                        del self._queue[i]
                        self._flights.pop(qe.eid, None)
                        qf.error = RuntimeError("shed for demand work")
                        qf.event.set()
                        self.prefetch_shed += 1
                        break
                else:
                    self.sheds += 1
                    return None
            fl = PromotionFlight(prefetch)
            self._flights[eid] = fl
            if prefetch:
                self.prefetch_issued += 1
                self._queue.append((ent, fl))
            else:
                # demand jobs jump the prefetch line
                self._queue.appendleft((ent, fl))
            self._ensure_started_locked()
        self._wake.set()
        return fl

    def queue_full(self) -> bool:
        """True when the promotion queue is at capacity -- the
        prefetcher's don't-even-try signal."""
        with self._lock:
            return len(self._queue) >= _cfg.promote_queue

    # ---------------------------------------------------------- worker

    def _run(self, epoch: int) -> None:
        while True:
            with self._lock:
                if self._epoch != epoch:
                    return  # a stop() retired this generation
                job = self._queue.popleft() if self._queue else None
                if job is None:
                    self._wake.clear()
            if job is None:
                self._wake.wait(0.25)
                continue
            ent, fl = job
            ticket = None
            adm = self.admission
            if adm is not None:
                try:
                    ticket = adm.try_acquire("internal")
                except Exception:
                    # admission saturated: shed this promotion -- the
                    # demand waiter takes the host-bytes route, a
                    # prefetch just doesn't happen
                    self._resolve(ent, fl,
                                  RuntimeError("promotion shed by "
                                               "admission"))
                    continue
            try:
                value = ent.promote(ent.payload)
                _settle_uploads()
                # install + re-admit: dict store is GIL-atomic and
                # readers validate tokens, so a racing owner rebuild at
                # worst overwrites with an equivalent entry
                ent.cache[ent.key] = value
                manager().admit(ent.cache, ent.key, ent.nbytes,
                                kind=ent.kind, devices=ent.devices,
                                token=ent.token, host=ent.payload,
                                promote=ent.promote,
                                fallback=ent.fallback,
                                prefetched=fl.prefetch,
                                kind_detail=ent.kind_detail)
                fl.ok = True
                with self._lock:
                    self.promotions += 1
                    if fl.prefetch:
                        self.prefetch_completed += 1
                self._resolve(ent, fl, None)
            except BaseException as e:  # noqa: BLE001 -- waiters fall back
                with self._lock:
                    self.failures += 1
                self._resolve(ent, fl, e)
            finally:
                if ticket is not None:
                    ticket.release()

    def _resolve(self, ent: HostEntry, fl: PromotionFlight,
                 err: BaseException | None) -> None:
        fl.error = err
        with self._lock:
            if self._flights.get(ent.eid) is fl:
                del self._flights[ent.eid]
        fl.event.set()

    # ----------------------------------------------------------- views

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": len([w for w in self._workers
                                if w.is_alive()]),
                "queue": len(self._queue),
                "inFlight": len(self._flights),
                "promotions": self.promotions,
                "failures": self.failures,
                "sheds": self.sheds,
                "prefetchIssued": self.prefetch_issued,
                "prefetchCompleted": self.prefetch_completed,
                "prefetchShed": self.prefetch_shed,
            }


_promoter = Promoter()


def promoter() -> Promoter:
    """The process-wide promotion pool (one per process, like the
    manager)."""
    return _promoter


def promote_wait_s(deadline=None) -> float:
    """The bounded demand-promotion wait: [residency] promote-wait-ms
    further capped by the request's remaining deadline."""
    wait = max(0.0, _cfg.promote_wait_ms / 1e3)
    if deadline is not None:
        try:
            wait = min(wait, max(0.0, deadline.remaining()))
        except Exception:
            pass
    return wait


# --------------------------------------------------------------------
# out-of-memory evict-and-retry (shared by every dispatch site)
# --------------------------------------------------------------------

_oom_lock = threading.Lock()
_oom_retries = 0


def oom_retries() -> int:
    """Out-of-memory errors recovered by :func:`run_with_oom_retry` in
    this process (the reference's ``device.oom_retries``)."""
    with _oom_lock:
        return _oom_retries


def run_with_oom_retry(fn):
    """Run one device dispatch; on ``torch.cuda.OutOfMemoryError``,
    evict every residency-tracked device entry (host twins survive --
    demotion, not loss), shrink the HBM budget (note_oom_feedback) so the
    tier demotes harder going forward, and retry ONCE.  Any other
    exception propagates untouched.  The retry runs after the handler
    has let go of the error, whose traceback would otherwise pin the
    failed attempt's tensors."""
    global _oom_retries
    try:
        return fn()
    except torch.cuda.OutOfMemoryError:
        pass
    with _oom_lock:
        _oom_retries += 1
    mgr = manager()
    mgr.note_oom_feedback()
    mgr.evict_all()
    return fn()
