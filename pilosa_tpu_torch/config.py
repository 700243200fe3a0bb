"""Configuration: one Config struct fed from three merged sources —
defaults < TOML file < PILOSA_TPU_* environment < CLI flags.

Copy of pilosa_tpu/config.py: the same sections, keys, defaults,
``PILOSA_TPU_`` environment prefix and precedence, so that one TOML file
and one environment configure both packages, and ``to_toml()`` renders
the same bytes.  The section docstrings are the reference's and name its
modules.  ``_coerce`` parses a tenant-quota spec with the port's
``serve.tenant.parse_quota_spec``.

Every key is parsed, kept and printed.  ``cmd.run_server`` applies the
keys of the layers the port has: ``data-dir``, ``bind``, ``verbose``,
``log-path``, ``max-writes-per-request``, ``[cluster] long-query-time``,
``[coalescer]``, ``[ragged]``, ``[vm]``, ``[admission]``, ``[cache]``,
``[ingest]``, ``[containers]``, ``[tenants]`` and ``[residency]``.  It
logs, and does not apply, a key of a layer still to be ported
(``UNAPPLIED``), each named here with the ROADMAP Queue 1 item that
will apply it:

- item 5a (the snapshot queue and the WAL file budget):
  ``max-wal-files``;
- item 7 (observability): ``[metric]``, ``[tracing]``, ``[profile]``,
  ``[observe]`` and ``[cost]``;
- item 8 (the runtime device layers' second half): ``[faultinject]``;
- item 10 (the cluster): ``name``, ``heartbeat-interval``, ``[cluster]``
  other than ``long-query-time``, ``[anti-entropy]``, ``[replication]``,
  ``[rebalance]`` and ``[tls]``;
- item 11 (multi-device): ``[mesh]``.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: same API under the old name
    import tomli as tomllib
from dataclasses import dataclass, field, fields


ENV_PREFIX = "PILOSA_TPU_"

#: (section or None for a top-level key, field) -> the ROADMAP Queue 1
#: item whose layer will apply it; a section's ``"*"`` covers every
#: field of it
UNAPPLIED: dict[tuple[str | None, str], str] = {
    (None, "name"): "10",
    (None, "max_wal_files"): "5a",
    (None, "heartbeat_interval"): "10",
    **{("cluster", k): "10" for k in (
        "replicas", "partitions", "seeds", "coordinator",
        "breaker_threshold", "breaker_cooldown", "hedge_min_samples",
        "hedge_deviations", "hedge_min_ms", "hedge_max_fraction")},
    ("anti_entropy", "*"): "10",
    ("replication", "*"): "10",
    ("rebalance", "*"): "10",
    ("tls", "*"): "10",
    ("metric", "*"): "7",
    ("tracing", "*"): "7",
    ("profile", "*"): "7",
    ("observe", "*"): "7",
    ("cost", "*"): "7",
    ("faultinject", "*"): "8",
    ("mesh", "*"): "11",
}


@dataclass
class ClusterConfig:
    """[cluster] section (server/config.go:100-117), plus the
    failure-handling knobs of the chaos round (parallel/cluster.py
    circuit breakers, parallel/executor.py hedged replica reads — no
    reference analog; Pilosa pays the full RPC timeout per query to a
    slow-but-alive peer).  ``breaker-threshold`` consecutive transport
    failures open a peer's breaker (queries fast-fail to the next
    replica instead of paying the timeout); after
    ``breaker-cooldown`` seconds the breaker half-opens and one trial
    request (or a successful membership heartbeat probe) closes it.
    Hedging: once ``hedge-min-samples`` latency samples exist for a
    peer, a remote shard map still in flight past ``EWMA +
    hedge-deviations x EWMA-deviation`` (floored at ``hedge-min-ms``)
    is re-issued to the next replica and the first full result wins;
    hedges are bounded to ``hedge-max-fraction`` of RPC volume (0
    disables hedging)."""

    replicas: int = 1
    partitions: int = 256
    seeds: list[str] = field(default_factory=list)
    coordinator: bool = False
    long_query_time: float = 0.0  # seconds; 0 disables slow-query log
    breaker_threshold: int = 5
    breaker_cooldown: float = 5.0  # seconds open before half-open
    hedge_min_samples: int = 8
    hedge_deviations: float = 4.0
    hedge_min_ms: float = 20.0
    hedge_max_fraction: float = 0.1  # of RPC volume; 0 disables


@dataclass
class FaultinjectConfig:
    """[faultinject] — the failpoint registry (pilosa_tpu.faultinject).
    ``armed`` is a failpoint spec (``name=action;...`` — see the
    module docstring for the grammar) applied at server open; empty
    (the default) arms nothing and every compiled-in site stays on its
    zero-cost disarmed path.  Also armable live via
    ``POST /debug/failpoints``."""

    armed: str = ""


@dataclass
class AntiEntropyConfig:
    """[anti-entropy] (server/config.go:118), grown into the
    self-healing round's knobs (parallel/syncer.py).  ``jitter`` is
    the fraction of ``interval`` each wait is randomized by (so a
    fleet restarted together does not run every AE sweep in lockstep);
    ``round-budget`` (seconds, 0 = unbounded) time-slices each sweep —
    a slice stops at the budget and the next one resumes from the
    persisted (index, field, view, shard) cursor, so a huge holder
    never monopolizes the internal admission class;
    ``peer-timeout`` bounds every peer exchange (block checksums,
    block data, diff pushes, attribute blocks) so one hung peer costs
    at most that, never a stalled round."""

    interval: float = 600.0  # seconds (reference default 10m)
    jitter: float = 0.1  # fraction of interval; 0 disables
    round_budget: float = 0.0  # seconds per slice; 0 = whole holder
    peer_timeout: float = 2.0  # seconds per peer exchange


@dataclass
class ReplicationConfig:
    """[replication] — degraded-write semantics + hinted handoff
    (parallel/hints.py; no reference analog — Pilosa fails the write
    when any owner replica is unreachable).  ``write-policy = "all"``
    (the default) keeps that all-owners guarantee byte-identical;
    ``"available"`` commits the write on the reachable owners and
    queues a HINT per missed delivery, replayed by a background worker
    once the peer's breaker closes or a heartbeat proves it alive —
    anti-entropy remains the backstop.  ``hint-max-bytes`` bounds the
    node's total queued hints (0 disables the queue);
    ``hint-max-age`` (seconds) drops hints too old to be the honest
    repair; ``replay-interval`` (seconds) is the drain scan period."""

    write_policy: str = "all"  # all | available
    hint_max_bytes: int = 16 << 20
    hint_max_age: float = 3600.0
    replay_interval: float = 0.5


@dataclass
class RebalanceConfig:
    """[rebalance] — online shard migration (parallel/rebalance.py; no
    reference analog — Pilosa gates the whole cluster RESIZING).
    ``transfer-budget`` caps concurrent shard backfills so migration
    traffic (admission class internal) never starves serving;
    ``dual-write-policy = "hint"`` (the default) commits writes on the
    serving owners and never fails a write over an unreachable pending
    owner (the miss is queued as a [replication] hint), ``"strict"``
    holds pending owners to the configured write-policy;
    ``cursor-path`` overrides where the coordinator persists its
    resumable plan cursor (default ``<data-dir>/.rebalance``);
    ``backoff-base``/``backoff-cap`` (seconds) shape the exponential
    pause when a transfer target's breaker opens mid-backfill;
    ``peer-timeout`` bounds each transfer exchange."""

    transfer_budget: int = 2
    dual_write_policy: str = "hint"  # hint | strict
    cursor_path: str = ""
    backoff_base: float = 0.2
    backoff_cap: float = 30.0
    peer_timeout: float = 2.0


@dataclass
class MetricConfig:
    """[metric] (server/config.go:125-133)."""

    service: str = "mem"  # mem | statsd | nop
    host: str = "127.0.0.1:8125"  # statsd agent address
    poll_interval: float = 0.0  # runtime gauge sweep seconds; 0 = off
    diagnostics: bool = False  # no phone-home by default


@dataclass
class TracingConfig:
    """[tracing] (server/config.go:141-149).  ``endpoint`` points at an
    OTLP/HTTP collector (…/v1/traces is appended); empty with
    enabled=true records in-memory only."""

    enabled: bool = False
    endpoint: str = ""


@dataclass
class ProfileConfig:
    """[profile] (server/config.go:151-156 — the reference's
    block/mutex profile rate knobs).  ``heap`` starts tracemalloc at
    server open, feeding ``GET /debug/pprof/heap``; ``heap_frames`` is
    the retained traceback depth per allocation — tracemalloc's cost
    knob (it has no sampling rate; depth is its dial, deeper = more
    useful stacks, more overhead).  Documented deviation: Python has no
    block/mutex profile; the wall-clock sampler at /debug/pprof/profile
    covers lock waits."""

    heap: bool = False
    heap_frames: int = 4


@dataclass
class CoalescerConfig:
    """[coalescer] — cross-query micro-batched dispatch (no reference
    analog; the serving-side batching lever for the TPU dispatch
    floor, parallel/coalescer.py).  ``enabled`` is tri-state:
    ``"auto"`` turns batching on only when an accelerator is attached
    (on a host-mode CPU dispatch is free and the window would only add
    latency); TOML booleans / "true"/"false" force it."""

    enabled: str = "auto"  # auto | true | false
    window_ms: float = 2.0
    max_batch: int = 32


@dataclass
class RaggedConfig:
    """[ragged] — heterogeneous-shape megabatch execution
    (ops/tape.py + parallel/coalescer.py; no reference analog — the
    Ragged-Paged-Attention-style batching lever for structurally
    diverse query traffic).  With ``enabled`` on, the coalescer keys
    its batching window on tape SIZE CLASS instead of exact expression
    shape, so distinct Count trees share one device launch through the
    op-tape interpreter.  ``max-tape``/``max-leaves`` cap the
    per-query tape; a query over either cap falls back to the
    per-shape fused path for that query alone (behavior unchanged).
    ``prewarm`` lowers the bucket interpreter programs on a background
    thread at server open so the first heterogeneous window pays a
    dispatch, not an XLA compile.  Only meaningful where the coalescer
    itself is on (accelerator attached, or [coalescer] forced true)."""

    enabled: bool = True
    max_tape: int = 32
    max_leaves: int = 16
    prewarm: bool = True


@dataclass
class VMConfig:
    """[vm] — the Pallas bitmap VM (ops/pallas_kernels.vm_counts +
    ops/tape.execute_vm; no reference analog — the one-kernel fusion
    of the ragged tape interpreter with the compressed container
    engine).  With ``enabled`` on, a coalesced sparse Count batch
    whose every leaf stages compressed executes as ONE scalar-prefetch
    kernel over the pooled containers, never materializing a dense
    register file.  ``min-domain`` is the floor a staged query's
    padded container-domain width rounds up to (keeps lowered-variant
    counts down and gives empty-domain queries a real batch slot);
    ``max-prefetch`` caps the per-launch scalar-prefetch directory in
    int32 entries (slots x batch x domain live in SMEM on chip —
    oversized batches split in two, oversized single queries route
    the dense engines).  Rides [ragged]: disabling the ragged engine
    disables the VM too, and ``?novm=1`` is the per-request escape."""

    enabled: bool = True
    min_domain: int = 8
    max_prefetch: int = 65536


@dataclass
class ObserveConfig:
    """[observe] — the query flight recorder (pilosa_tpu.observe; no
    reference analog beyond ``cluster.long-query-time``).  ``enabled``
    keeps the per-query record assembly on (sub-1% of the coalesced
    Count path, benchmarked in bench.py extras.observe); ``recent`` is
    the ring-buffer depth behind ``GET /debug/queries``;
    ``long_query_time`` (seconds, 0 = off) logs PQL + trace id + the
    stage breakdown for queries over the threshold — the reference's
    LongQueryTime with a profile attached.

    Device-runtime telemetry (pilosa_tpu.devobs):
    ``device_sample_interval`` (seconds, 0 = off) runs the background
    sampler that pushes ``device.*``/``compile.*``/``residency.*``
    gauges into the stats backends — pull scrapers get fresh gauges at
    /metrics anyway, so the loop only matters for push (statsd)
    deployments; ``fanin_timeout`` (seconds) bounds each peer fetch of
    the cluster-wide ``GET /debug/cluster/*`` merge.

    Engine observatory (pilosa_tpu.perfobs):
    ``device_peak_gbps`` is the memory-bandwidth roof the per-engine
    achieved GB/s is reported against (``bw_util`` on /debug/cost and
    in chip captures); 0 (the default) picks a datasheet ballpark per
    jax device kind — set it when the exact part's roof is known.
    ``profiler_max_seconds`` auto-stops an on-demand device profiler
    capture (``POST /debug/profiler/start``) that was never stopped
    (0 disables the deadline — captures then run until the explicit
    stop).

    Cluster event journal (pilosa_tpu.observe.EventJournal):
    ``journal`` keeps the structured state-transition ring behind
    ``GET /debug/events`` on (disarmed cost is one module-bool read,
    benchmarked in bench.py extras.traceasm); ``journal_size`` is the
    ring depth; ``journal_kinds`` is a comma-separated kind-prefix
    allowlist (empty = keep every kind) — filtered emissions tick the
    drop counter so a too-narrow filter is visible."""

    enabled: bool = True
    recent: int = 256
    long_query_time: float = 0.0  # seconds; 0 disables slow-query log
    device_sample_interval: float = 0.0  # seconds; 0 = scrape-time only
    fanin_timeout: float = 2.0  # seconds per peer in /debug/cluster/*
    device_peak_gbps: float = 0.0  # GB/s roof; 0 = per-device default
    profiler_max_seconds: float = 30.0  # capture auto-stop; 0 = never
    journal: bool = True  # the cluster event journal ring
    journal_size: int = 2048  # event ring depth
    journal_kinds: str = ""  # comma-separated kind prefixes; "" = all


@dataclass
class CostConfig:
    """[cost] — the shadow cost model (pilosa_tpu.perfobs; no
    reference analog — the stepping stone to a cost-based planner,
    ROADMAP item 4).  With ``shadow`` on (the default), the
    executor/coalescer consult the observed-cost table AFTER choosing
    an engine: the table's verdict is stamped onto the flight record
    (``wouldChoose``/``costDisagree``) and ``cost.disagreements``
    ticks, while routing itself stays byte-identical to a consult-free
    build — there is no active mode yet.  ``shadow = false`` turns the
    consult off entirely (per-launch samples still collect)."""

    shadow: bool = True


@dataclass
class CacheConfig:
    """[cache] — the generation-stamped query result cache
    (runtime/resultcache.py; the reference's per-fragment rank cache,
    cache.go:136, generalized to whole PQL subtrees).  ``budget-bytes``
    bounds total host memory held by cached results (strict — never
    exceeded, LRU evicts); ``max-entry-bytes`` refuses any single
    result larger than this (a giant Row result must not flush the
    warm working set); ``ttl`` (seconds, 0 = none) ages entries out on
    top of generation invalidation — generations already catch every
    local write, so a TTL only matters as a backstop against external
    clock-based staleness policies.  Per-request opt-out: ``?nocache=1``
    on the query route."""

    enabled: bool = True
    budget_bytes: int = 128 << 20
    max_entry_bytes: int = 8 << 20
    ttl: float = 0.0  # seconds; 0 disables age-based expiry


@dataclass
class IngestConfig:
    """[ingest] — the streaming write path (pilosa_tpu.ingest; the
    reference's roaring op-log appended ahead of snapshots,
    fragment.go import paths).  With ``delta-enabled`` on, batched
    imports and set/clear land in a bounded per-fragment DELTA PLANE
    without bumping the base generation — device residency and
    result-cache entries stay warm under sustained ingest — and the
    background compactor merges deltas into base roaring state under
    admission's ``internal`` class.  ``delta-budget-bytes`` bounds
    process-wide pending delta memory (past it the writer flushes its
    own fragment inline); ``compact-threshold-bits`` merges a fragment
    once its delta holds that many pending bit positions;
    ``compact-interval`` (seconds) is both the compactor scan period
    and the age bound (a delta older than one interval merges even
    when small).  Per-request escape: ``?nodelta=1`` on the query
    route compacts up front and reads pure base state."""

    delta_enabled: bool = True
    delta_budget_bytes: int = 64 << 20
    compact_threshold_bits: int = 1 << 17
    compact_interval: float = 2.0


@dataclass
class ContainersConfig:
    """[containers] — the compressed container-directory device layout
    (ops/containers.py; the reference's entire performance story:
    Chambi et al. / Lemire et al. roaring container specialization,
    ported to device).  With ``enabled`` on, fused Row/Count reads
    whose leaf rows are sparse execute over pooled non-empty 2^16-bit
    container blocks — resident device bytes track real data instead
    of shards x shard-width, and absent containers are skipped
    entirely.  ``threshold`` is the per-fragment fill-ratio ceiling
    (set bits / shard width) above which a row is considered hot and
    the query keeps the dense fused path (the dense layout is the
    right engine for hot rows).  Per-request escape:
    ``?nocontainers=1`` on the query route — results are bit-identical
    either way.

    ``kinds`` turns on per-container kind specialization (bitmap vs
    sorted-array vs run-interval pools — the full roaring triple on
    device); ``array-max`` is the cardinality ceiling for the array
    kind (canonical roaring uses 4096; lower values only NARROW the
    device pick — serialization always uses the canonical constant);
    ``run-cap`` caps how many intervals a run container may carry
    before it demotes to array/bitmap on device.  With ``kinds`` off
    every container stays a dense 2048-word block — results are
    bit-identical either way."""

    enabled: bool = True
    threshold: float = 0.25
    kinds: bool = True
    array_max: int = 4096
    run_cap: int = 256


@dataclass
class ResidencyConfig:
    """[residency] — tiered device-memory residency
    (runtime/residency.py; reference analog: the syswrap-capped mmap
    plus file-handle/map LRU that lets Pilosa serve fragments far
    beyond RAM).  ``host-budget-bytes`` caps the host-RAM tier behind
    HBM (0 disables tiering: misses rebuild inline, evictions drop —
    the pre-tier behavior); ``disk-path``/``disk-budget-bytes``
    optionally put a spill tier behind host RAM.
    ``promote-workers``/``promote-queue`` size the async promotion
    pool (each job runs under admission's ``internal`` class; a full
    queue sheds prefetch work first); ``promote-wait-ms`` bounds how
    long a demand miss parks on its promotion before taking the
    host-compute fallback (further capped by the request deadline).
    ``prefetch``/``prefetch-interval`` drive the predictive
    prefetcher (runtime/prefetch.py).  Per-request escape:
    ``?notiers=1`` on the query route — results are byte-identical
    either way."""

    host_budget_bytes: int = 1 << 30
    disk_path: str = ""
    disk_budget_bytes: int = 4 << 30
    promote_workers: int = 2
    promote_queue: int = 64
    promote_wait_ms: float = 50.0
    prefetch: bool = True
    prefetch_interval: float = 0.25


@dataclass
class MeshConfig:
    """[mesh] — mesh-native SPMD execution of the fused serving path
    (parallel/meshexec.py; no reference analog — Pilosa's only
    scale-out is host map-reduce over shards, executor.go:2455).
    With ``enabled`` on, fused-operand stacks lay out across a named
    device mesh via NamedSharding and the fused / ragged-tape /
    container-gather programs run under shard_map with collective
    reductions on the shard axis, so ONE launch evaluates a query (or
    a coalesced megabatch) across every local chip.  ``enabled`` is
    tri-state like the coalescer's: ``"auto"`` activates exactly when
    it can help (more than one local device, single process, not host
    mode).  ``axis-size`` bounds how many local devices join the
    shard axis (0 = all of them).  Per-request escape: ``?nomesh=1``
    on the query route — the pre-mesh single-device programs, results
    byte-identical."""

    enabled: str = "auto"  # auto | true | false
    axis_size: int = 0  # local devices on the shard axis; 0 = all


@dataclass
class AdmissionConfig:
    """[admission] — priority-classed admission control + load
    shedding on the serving path (serve/admission.py; no reference
    analog — the overload story Pilosa punts on).  Three classes, each
    with a concurrency cap and a bounded FIFO wait queue: ``query``
    (user PQL), ``ingest`` (imports), ``internal`` (anti-entropy,
    resize transfer, translate replication).  ``default_deadline``
    (seconds, 0 = none) applies to requests that carry no
    ``X-Pilosa-Deadline`` header.  Overflow sheds with 429/503 +
    Retry-After instead of queueing unboundedly."""

    enabled: bool = True
    query_cap: int = 32
    query_queue: int = 128
    ingest_cap: int = 16
    ingest_queue: int = 64
    internal_cap: int = 16
    internal_queue: int = 64
    default_deadline: float = 0.0  # seconds; 0 = no implied deadline


@dataclass
class TenantsConfig:
    """[tenants] — per-tenant isolation (serve/tenant.py; no reference
    analog — the reference's executor has no notion of who a query
    belongs to).  Disabled by default: a config with no [tenants]
    table is byte-identical to pre-tenant behavior.  With ``enabled``
    on, every request's tenant id (X-Pilosa-Tenant / ?tenant=; absent
    = the default tier) is scheduled fairly inside each admission
    class (``share`` concurrency slots + deficit-round-robin dequeue
    weight, ``queue`` bounded per-class wait depth), charged a soft
    ``cache-share`` fraction of the result-cache budget (eviction
    prefers an over-budget tenant's own entries), and held to a
    ``residency-share`` HBM/host-tier quota (an over-quota working
    set demotes its own stacks).  ``default-*`` are the quota of every
    tenant without its own ``[tenants.quotas.<name>]`` table entry;
    ``quotas`` maps tenant name -> {share, queue, cache-share,
    residency-share} (env form:
    ``name:share[:queue[:cache_share[:residency_share]]],...``)."""

    enabled: bool = False
    default_share: int = 4
    default_queue: int = 16
    default_cache_share: float = 0.25
    default_residency_share: float = 0.5
    quotas: dict = field(default_factory=dict)


@dataclass
class TLSConfig:
    """[tls] (server/tlsconfig.go; config server/config.go:58-66)."""

    certificate_path: str = ""
    key_path: str = ""
    skip_verify: bool = False


@dataclass
class Config:
    data_dir: str = "~/.pilosa_tpu"
    bind: str = "127.0.0.1:10101"
    name: str = ""
    verbose: bool = False
    log_path: str = ""
    max_writes_per_request: int = 5000
    # process-wide cap on long-lived WAL fds (reference syswrap
    # max-file-count, syswrap/os.go:41); runtime/filebudget.py LRU
    max_wal_files: int = 512
    heartbeat_interval: float = 0.0  # seconds; 0 disables the detector
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    anti_entropy: AntiEntropyConfig = field(default_factory=AntiEntropyConfig)
    replication: ReplicationConfig = field(
        default_factory=ReplicationConfig)
    rebalance: RebalanceConfig = field(default_factory=RebalanceConfig)
    metric: MetricConfig = field(default_factory=MetricConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    coalescer: CoalescerConfig = field(default_factory=CoalescerConfig)
    ragged: RaggedConfig = field(default_factory=RaggedConfig)
    vm: VMConfig = field(default_factory=VMConfig)
    observe: ObserveConfig = field(default_factory=ObserveConfig)
    cost: CostConfig = field(default_factory=CostConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    containers: ContainersConfig = field(
        default_factory=ContainersConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    residency: ResidencyConfig = field(default_factory=ResidencyConfig)
    faultinject: FaultinjectConfig = field(
        default_factory=FaultinjectConfig)
    tenants: TenantsConfig = field(default_factory=TenantsConfig)

    # ------------------------------------------------------------- access

    @property
    def host(self) -> str:
        return self.bind.rsplit(":", 1)[0] or "127.0.0.1"

    @property
    def port(self) -> int:
        parts = self.bind.rsplit(":", 1)
        return int(parts[1]) if len(parts) == 2 and parts[1] else 10101

    def expanded_data_dir(self) -> str:
        return os.path.expanduser(self.data_dir)

    # ------------------------------------------------------------ sources

    @classmethod
    def load(cls, toml_path: str | None = None,
             env: dict | None = None,
             overrides: dict | None = None) -> "Config":
        """defaults < TOML < env < overrides (cmd/root.go:94)."""
        cfg = cls()
        if toml_path:
            with open(toml_path, "rb") as f:
                cfg._apply_dict(tomllib.load(f))
        cfg._apply_env(env if env is not None else os.environ)
        if overrides:
            cfg._apply_dict(overrides)
        return cfg

    def _apply_dict(self, d: dict) -> None:
        for k, v in d.items():
            key = k.replace("-", "_")
            if key in ("cluster", "anti_entropy", "replication",
                       "rebalance", "metric", "tracing",
                       "profile", "tls", "coalescer", "ragged", "vm",
                       "observe", "cost", "admission", "cache",
                       "ingest", "containers", "mesh", "residency",
                       "faultinject", "tenants") and isinstance(v, dict):
                section = getattr(self, key)
                for sk, sv in v.items():
                    sname = sk.replace("-", "_")
                    if hasattr(section, sname):
                        setattr(section, sname, sv)
            elif hasattr(self, key) and not isinstance(getattr(self, key),
                                                       (ClusterConfig,
                                                        AntiEntropyConfig,
                                                        ReplicationConfig,
                                                        RebalanceConfig,
                                                        MetricConfig,
                                                        TracingConfig,
                                                        ProfileConfig,
                                                        TLSConfig,
                                                        CoalescerConfig,
                                                        RaggedConfig,
                                                        VMConfig,
                                                        ObserveConfig,
                                                        CostConfig,
                                                        AdmissionConfig,
                                                        CacheConfig,
                                                        IngestConfig,
                                                        ContainersConfig,
                                                        MeshConfig,
                                                        ResidencyConfig,
                                                        FaultinjectConfig,
                                                        TenantsConfig)):
                setattr(self, key, v)

    def _apply_env(self, env: dict) -> None:
        """PILOSA_TPU_BIND=..., PILOSA_TPU_CLUSTER_REPLICAS=2, etc.
        (the reference's PILOSA_* envs, cmd/root.go:94)."""
        for f in fields(self):
            if f.name in ("cluster", "anti_entropy", "replication",
                          "rebalance", "metric", "tracing",
                          "profile", "tls", "coalescer", "ragged",
                          "vm", "observe", "cost", "admission",
                          "cache", "ingest", "containers", "mesh",
                          "residency", "faultinject", "tenants"):
                section = getattr(self, f.name)
                for sf in fields(section):
                    key = f"{ENV_PREFIX}{f.name}_{sf.name}".upper()
                    if key in env:
                        setattr(section, sf.name,
                                _coerce(env[key], getattr(section, sf.name)))
            else:
                key = f"{ENV_PREFIX}{f.name}".upper()
                if key in env:
                    setattr(self, f.name,
                            _coerce(env[key], getattr(self, f.name)))

    # ------------------------------------------------------------- render

    def to_toml(self) -> str:
        """Effective config as TOML (reference `pilosa config` /
        generate-config, ctl/config.go)."""
        lines = [
            f'data-dir = "{self.data_dir}"',
            f'bind = "{self.bind}"',
            f'name = "{self.name}"',
            f"verbose = {str(self.verbose).lower()}",
            f'log-path = "{self.log_path}"',
            f"max-writes-per-request = {self.max_writes_per_request}",
            f"max-wal-files = {self.max_wal_files}",
            f"heartbeat-interval = {self.heartbeat_interval}",
            "",
            "[cluster]",
            f"replicas = {self.cluster.replicas}",
            f"partitions = {self.cluster.partitions}",
            f"seeds = [{', '.join(repr(s) for s in self.cluster.seeds)}]",
            f"coordinator = {str(self.cluster.coordinator).lower()}",
            f"long-query-time = {self.cluster.long_query_time}",
            f"breaker-threshold = {self.cluster.breaker_threshold}",
            f"breaker-cooldown = {self.cluster.breaker_cooldown}",
            f"hedge-min-samples = {self.cluster.hedge_min_samples}",
            f"hedge-deviations = {self.cluster.hedge_deviations}",
            f"hedge-min-ms = {self.cluster.hedge_min_ms}",
            f"hedge-max-fraction = {self.cluster.hedge_max_fraction}",
            "",
            "[anti-entropy]",
            f"interval = {self.anti_entropy.interval}",
            f"jitter = {self.anti_entropy.jitter}",
            f"round-budget = {self.anti_entropy.round_budget}",
            f"peer-timeout = {self.anti_entropy.peer_timeout}",
            "",
            "[replication]",
            f'write-policy = "{self.replication.write_policy}"',
            f"hint-max-bytes = {self.replication.hint_max_bytes}",
            f"hint-max-age = {self.replication.hint_max_age}",
            f"replay-interval = {self.replication.replay_interval}",
            "",
            "[rebalance]",
            f"transfer-budget = {self.rebalance.transfer_budget}",
            f'dual-write-policy = "{self.rebalance.dual_write_policy}"',
            f'cursor-path = "{self.rebalance.cursor_path}"',
            f"backoff-base = {self.rebalance.backoff_base}",
            f"backoff-cap = {self.rebalance.backoff_cap}",
            f"peer-timeout = {self.rebalance.peer_timeout}",
            "",
            "[metric]",
            f'service = "{self.metric.service}"',
            f'host = "{self.metric.host}"',
            f"poll-interval = {self.metric.poll_interval}",
            f"diagnostics = {str(self.metric.diagnostics).lower()}",
            "",
            "[tracing]",
            f"enabled = {str(self.tracing.enabled).lower()}",
            f'endpoint = "{self.tracing.endpoint}"',
            "",
            "[profile]",
            f"heap = {str(self.profile.heap).lower()}",
            f"heap-frames = {self.profile.heap_frames}",
            "",
            "[coalescer]",
            f'enabled = "{self.coalescer.enabled}"',
            f"window-ms = {self.coalescer.window_ms}",
            f"max-batch = {self.coalescer.max_batch}",
            "",
            "[ragged]",
            f"enabled = {str(self.ragged.enabled).lower()}",
            f"max-tape = {self.ragged.max_tape}",
            f"max-leaves = {self.ragged.max_leaves}",
            f"prewarm = {str(self.ragged.prewarm).lower()}",
            "",
            "[vm]",
            f"enabled = {str(self.vm.enabled).lower()}",
            f"min-domain = {self.vm.min_domain}",
            f"max-prefetch = {self.vm.max_prefetch}",
            "",
            "[observe]",
            f"enabled = {str(self.observe.enabled).lower()}",
            f"recent = {self.observe.recent}",
            f"long-query-time = {self.observe.long_query_time}",
            f"device-sample-interval = "
            f"{self.observe.device_sample_interval}",
            f"fanin-timeout = {self.observe.fanin_timeout}",
            f"device-peak-gbps = {self.observe.device_peak_gbps}",
            f"profiler-max-seconds = "
            f"{self.observe.profiler_max_seconds}",
            f"journal = {str(self.observe.journal).lower()}",
            f"journal-size = {self.observe.journal_size}",
            f'journal-kinds = "{self.observe.journal_kinds}"',
            "",
            "[cost]",
            f"shadow = {str(self.cost.shadow).lower()}",
            "",
            "[admission]",
            f"enabled = {str(self.admission.enabled).lower()}",
            f"query-cap = {self.admission.query_cap}",
            f"query-queue = {self.admission.query_queue}",
            f"ingest-cap = {self.admission.ingest_cap}",
            f"ingest-queue = {self.admission.ingest_queue}",
            f"internal-cap = {self.admission.internal_cap}",
            f"internal-queue = {self.admission.internal_queue}",
            f"default-deadline = {self.admission.default_deadline}",
            "",
            "[cache]",
            f"enabled = {str(self.cache.enabled).lower()}",
            f"budget-bytes = {self.cache.budget_bytes}",
            f"max-entry-bytes = {self.cache.max_entry_bytes}",
            f"ttl = {self.cache.ttl}",
            "",
            "[ingest]",
            f"delta-enabled = {str(self.ingest.delta_enabled).lower()}",
            f"delta-budget-bytes = {self.ingest.delta_budget_bytes}",
            f"compact-threshold-bits = "
            f"{self.ingest.compact_threshold_bits}",
            f"compact-interval = {self.ingest.compact_interval}",
            "",
            "[containers]",
            f"enabled = {str(self.containers.enabled).lower()}",
            f"threshold = {self.containers.threshold}",
            f"kinds = {str(self.containers.kinds).lower()}",
            f"array-max = {self.containers.array_max}",
            f"run-cap = {self.containers.run_cap}",
            "",
            "[mesh]",
            f'enabled = "{self.mesh.enabled}"',
            f"axis-size = {self.mesh.axis_size}",
            "",
            "[residency]",
            f"host-budget-bytes = {self.residency.host_budget_bytes}",
            f'disk-path = "{self.residency.disk_path}"',
            f"disk-budget-bytes = {self.residency.disk_budget_bytes}",
            f"promote-workers = {self.residency.promote_workers}",
            f"promote-queue = {self.residency.promote_queue}",
            f"promote-wait-ms = {self.residency.promote_wait_ms}",
            f"prefetch = {str(self.residency.prefetch).lower()}",
            f"prefetch-interval = {self.residency.prefetch_interval}",
            "",
            "[faultinject]",
            f'armed = "{self.faultinject.armed}"',
            "",
            "[tenants]",
            f"enabled = {str(self.tenants.enabled).lower()}",
            f"default-share = {self.tenants.default_share}",
            f"default-queue = {self.tenants.default_queue}",
            f"default-cache-share = {self.tenants.default_cache_share}",
            f"default-residency-share = "
            f"{self.tenants.default_residency_share}",
            *[line
              for name, q in sorted(self.tenants.quotas.items())
              for line in _tenant_quota_toml(name, q)],
            "",
            "[tls]",
            f'certificate-path = "{self.tls.certificate_path}"',
            f'key-path = "{self.tls.key_path}"',
            f"skip-verify = {str(self.tls.skip_verify).lower()}",
        ]
        return "\n".join(lines) + "\n"


def _tenant_quota_toml(name: str, q) -> list[str]:
    """Render one [tenants.quotas.<name>] table (dict or TenantQuota)."""
    get = (q.get if isinstance(q, dict)
           else lambda k, d=None: getattr(q, k.replace("-", "_"), d))
    out = [f'[tenants.quotas."{name}"]']
    for key, default in (("share", 4), ("queue", 16),
                         ("cache-share", 0.25),
                         ("residency-share", 0.5)):
        v = get(key, None)
        if v is None and isinstance(q, dict):
            v = q.get(key.replace("-", "_"))
        out.append(f"{key} = {default if v is None else v}")
    return out


def _coerce(raw: str, current):
    if isinstance(current, dict):
        # tenant-quota spec: name:share[:queue[:cache:res]],...
        from pilosa_tpu_torch.serve.tenant import parse_quota_spec

        return {n: {"share": q.share, "queue": q.queue,
                    "cache_share": q.cache_share,
                    "residency_share": q.residency_share}
                for n, q in parse_quota_spec(raw).items()}
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, list):
        return [s for s in raw.split(",") if s]
    return raw
