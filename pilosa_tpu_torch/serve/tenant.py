"""Per-tenant isolation: the process-wide [tenants] policy and the
thread-local tenant identity that shared resources charge against.

Copy of pilosa_tpu/serve/tenant.py.

- **Identity**: a tenant id rides the ``X-Pilosa-Tenant`` header (or
  ``?tenant=``), handler -> api -> ``ExecOptions.tenant`` -> executor.
  Requests with no id resolve to :data:`DEFAULT_TENANT`.  The executor
  installs the id as a thread-local :class:`scope`, so that the result
  cache attributes its bytes without a parameter at every call site.
- **Policy**: a :class:`TenantQuota` per configured tenant, plus a
  default tier for the others.  ``share`` is the tenant's concurrency
  slots inside each admission class and its deficit-round-robin weight
  (serve/admission.py); ``queue`` bounds its wait queue in each class;
  ``cache_share`` is its soft fraction of the result cache's byte budget
  (runtime/resultcache.py), and ``residency_share`` its fraction of the
  card's byte budget and of the host tier's (runtime/residency.py: an
  over-quota tenant demotes its own coldest stacks).
- **Off by default**: with ``enabled`` false :func:`policy` returns None
  and every enforcement site takes its path without tenants.

The configuration is process-wide: ``configure`` applies explicit values
in place, the first server to ``retain()`` captures the config in force
and the last ``release()`` restores it.

Left out, with the port's lack of the layer it hooks into:
``publish_gauges`` (no stats registry).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from pilosa_tpu_torch.serve.deadline import tls_scope as _tls_scope

#: The tier that requests with no tenant id charge against.
DEFAULT_TENANT = "default"

#: Tenant ids are labels, not payloads: a hostile header cannot grow the
#: per-tenant tables with long ones.
MAX_TENANT_LEN = 64

#: Bound on the distinct unconfigured labels individuated per process.
#: The header is the client's word, so a client rotating labels would
#: otherwise mint a fresh default-tier quota per label.  Past the cap,
#: new unconfigured labels share the default tier; configured tenants
#: are never collapsed.
MAX_TRACKED_TENANTS = 256


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's quotas: ``share`` concurrency slots in each admission
    class (and its dequeue weight), ``queue`` queued requests per class
    (past it an arrival sheds 429 ``tenant-queue-full``),
    ``cache_share`` a soft fraction of the result-cache budget (past it
    eviction prefers the tenant's own entries), ``residency_share`` its
    fraction of the residency manager's card and host-tier budgets."""

    share: int = 4
    queue: int = 16
    cache_share: float = 0.25
    residency_share: float = 0.5


class TenantsRuntimeConfig:
    """The process-wide [tenants] knobs."""

    __slots__ = ("enabled", "default_quota", "quotas", "seen")

    def __init__(self) -> None:
        self.enabled = False
        self.default_quota = TenantQuota()
        self.quotas: dict[str, TenantQuota] = {}
        # distinct unconfigured labels individuated so far (bounded by
        # MAX_TRACKED_TENANTS; a lost race individuates one extra label)
        self.seen: set[str] = set()

    def quota_for(self, name: str) -> TenantQuota:
        return self.quotas.get(name, self.default_quota)

    def account(self, name: str) -> str:
        """The accounting identity of ``name``: itself while it is
        configured, already individuated or within the bound, else the
        shared :data:`DEFAULT_TENANT` tier."""
        if name == DEFAULT_TENANT or name in self.quotas \
                or name in self.seen:
            return name
        if len(self.seen) >= MAX_TRACKED_TENANTS:
            return DEFAULT_TENANT
        self.seen.add(name)
        return name


_cfg = TenantsRuntimeConfig()
_cfg_lock = threading.Lock()
_baseline: tuple | None = None
_refs = 0


def config() -> TenantsRuntimeConfig:
    return _cfg


def policy() -> TenantsRuntimeConfig | None:
    """The config while [tenants] is enabled, else None: one attribute
    read on the disabled path."""
    return _cfg if _cfg.enabled else None


def enabled() -> bool:
    return _cfg.enabled


def _coerce_quota(raw) -> TenantQuota:
    if isinstance(raw, TenantQuota):
        return raw
    if not isinstance(raw, dict):
        raise ValueError(f"tenant quota must be a table, got {raw!r}")
    d = {k.replace("-", "_"): v for k, v in raw.items()}
    unknown = set(d) - {"share", "queue", "cache_share",
                        "residency_share"}
    if unknown:
        raise ValueError(
            f"unknown tenant quota keys: {sorted(unknown)} "
            "(share, queue, cache-share, residency-share)")
    base = TenantQuota()
    q = TenantQuota(
        share=int(d.get("share", base.share)),
        queue=int(d.get("queue", base.queue)),
        cache_share=float(d.get("cache_share", base.cache_share)),
        residency_share=float(d.get("residency_share",
                                    base.residency_share)))
    if q.share < 1 or q.queue < 0:
        raise ValueError(f"tenant quota out of range: {q}")
    return q


def parse_quota_spec(spec: str) -> dict[str, TenantQuota]:
    """The CLI's compact quota spec: comma-separated
    ``name:share[:queue[:cache_share[:residency_share]]]`` entries, e.g.
    ``gold:16:64:0.5,free:2:8``."""
    out: dict[str, TenantQuota] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2 or not bits[0]:
            raise ValueError(
                f"bad tenant quota entry {part!r} "
                "(name:share[:queue[:cache_share[:residency_share]]])")
        base = TenantQuota()
        out[bits[0]] = _coerce_quota({
            "share": int(bits[1]),
            "queue": int(bits[2]) if len(bits) > 2 else base.queue,
            "cache_share": (float(bits[3]) if len(bits) > 3
                            else base.cache_share),
            "residency_share": (float(bits[4]) if len(bits) > 4
                                else base.residency_share)})
    return out


def configure(enabled: bool | None = None,
              default_share: int | None = None,
              default_queue: int | None = None,
              default_cache_share: float | None = None,
              default_residency_share: float | None = None,
              quotas: dict | None = None) -> TenantsRuntimeConfig:
    """Apply [tenants] config in place; only explicit values land.
    ``quotas`` maps tenant names to quota tables or :class:`TenantQuota`s
    and replaces the configured set."""
    parsed = (None if quotas is None
              else {str(n): _coerce_quota(q) for n, q in quotas.items()})
    with _cfg_lock:
        if enabled is not None:
            _cfg.enabled = bool(enabled)
        d = _cfg.default_quota
        _cfg.default_quota = TenantQuota(
            share=int(default_share) if default_share is not None
            else d.share,
            queue=int(default_queue) if default_queue is not None
            else d.queue,
            cache_share=float(default_cache_share)
            if default_cache_share is not None else d.cache_share,
            residency_share=float(default_residency_share)
            if default_residency_share is not None
            else d.residency_share)
        if _cfg.default_quota.share < 1 or _cfg.default_quota.queue < 0:
            raise ValueError(
                f"default tenant quota out of range: {_cfg.default_quota}")
        if parsed is not None:
            _cfg.quotas = parsed
    return _cfg


def retain() -> None:
    """Take a server reference; the first holder snapshots the config in
    force."""
    global _refs, _baseline
    with _cfg_lock:
        if _refs == 0 and _baseline is None:
            _baseline = (_cfg.enabled, _cfg.default_quota,
                         dict(_cfg.quotas))
        _refs += 1


def release() -> None:
    """Drop a server reference; the last holder restores the snapshot."""
    global _refs, _baseline
    with _cfg_lock:
        if _refs > 0:
            _refs -= 1
        if _refs == 0 and _baseline is not None:
            _cfg.enabled, _cfg.default_quota = _baseline[0], _baseline[1]
            _cfg.quotas = dict(_baseline[2])
            _cfg.seen = set()
            _baseline = None


def refs() -> int:
    return _refs


# --------------------------------------------------------- identity


def clean(raw: str | None) -> str | None:
    """A wire tenant id: stripped, length-capped, empty -> None.  Never
    raises: a malformed label degrades to the default tier, not a 400
    (the id is an accounting key, not a credential)."""
    if raw is None:
        return None
    t = str(raw).strip()
    if not t:
        return None
    return t[:MAX_TENANT_LEN]


def resolve(tenant: str | None) -> str:
    """The accounting identity of a request: its tenant id, or the
    default tier.  While [tenants] is enabled the id also passes the
    individuation bound (``account``)."""
    name = tenant if tenant else DEFAULT_TENANT
    pol = policy()
    return pol.account(name) if pol is not None else name


_tls = threading.local()  # .tenant: the tenant id active on this thread


class scope(_tls_scope):
    """Install a tenant id as this thread's identity for a with-block
    (the executor installs the request's)."""

    __slots__ = ()

    def __init__(self, tenant: str | None):
        super().__init__(_tls, "tenant", tenant)


def current() -> str | None:
    """The tenant id active on this thread, or None."""
    return getattr(_tls, "tenant", None)
