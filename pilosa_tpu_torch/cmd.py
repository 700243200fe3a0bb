"""CLI: the operational command surface of the port.

Port of pilosa_tpu/cmd.py, with its argument tree:

    python -m pilosa_tpu_torch server [-c FILE] [the reference's flags]
        [--device cpu]
    python -m pilosa_tpu_torch import -i INDEX -f FIELD [--host URI]
        [--create] [--clear] [--field-type set|int|time|mutex|bool]
        [--min N] [--max N] [--time-quantum Q] [--batch-size N] FILE|- ...
    python -m pilosa_tpu_torch export -i INDEX -f FIELD [--host URI] [-o F]
    python -m pilosa_tpu_torch check DIR [--device cpu]
    python -m pilosa_tpu_torch inspect DIR [-i INDEX] [-f FIELD]
        [--device cpu]
    python -m pilosa_tpu_torch generate-config
    python -m pilosa_tpu_torch config [-c FILE]

``server`` merges defaults < TOML (``-c``) < ``PILOSA_TPU_*`` environment
< flags into a ``config.Config`` and serves it with ``run_server`` until
SIGINT or SIGTERM.  Every flag of the reference's ``server`` is taken;
one of a layer the port does not have yet lands in the Config and is
logged, not applied (config.UNAPPLIED).  ``--device``, which the
reference does not have, picks the torch device: the node, ``check`` and
``inspect`` run on ``cuda`` unless it says ``cpu``.

``import`` reads the reference's two CSV formats, ``row,col[,timestamp]``
(set, time, mutex and bool fields) and ``col,value`` (int fields), from
files or stdin (``-``), through the streaming Python csv path; the
native bulk parser is ROADMAP Queue 1 item 9, and the reference parses a
file the same with or without it (pilosa_tpu/cmd.py:621-630).  ``export``,
``check``, ``inspect``, ``generate-config`` and ``config`` print what the
reference prints.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import datetime as dt
import signal
import sys
import threading

from pilosa_tpu_torch.config import UNAPPLIED, Config


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="pilosa_tpu_torch",
        description="distributed bitmap index on a CUDA card")
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("server", help="run a node")
    ps.add_argument("-c", "--config", help="TOML config file")
    ps.add_argument("-d", "--data-dir")
    ps.add_argument("-b", "--bind")
    ps.add_argument("--name")
    ps.add_argument("--seeds", help="comma-separated seed URIs")
    ps.add_argument("--replicas", type=int)
    ps.add_argument("--anti-entropy-interval", type=float)
    ps.add_argument("--heartbeat-interval", type=float)
    ps.add_argument("--long-query-time", type=float,
                    help="seconds; log queries slower than this with "
                         "their profile breakdown ([observe] "
                         "long-query-time; 0 disables)")
    ps.add_argument("--no-admission", action="store_true",
                    help="disable the admission gate ([admission] "
                         "enabled=false): no per-class caps, no load "
                         "shedding, no accept-side thread cap")
    ps.add_argument("--admission-default-deadline", type=float,
                    help="seconds applied to requests without an "
                         "X-Pilosa-Deadline header ([admission] "
                         "default-deadline; 0 = none)")
    for _cls in ("query", "ingest", "internal"):
        ps.add_argument(f"--admission-{_cls}-cap", type=int,
                        help=f"concurrent {_cls}-class requests "
                             f"([admission] {_cls}-cap)")
        ps.add_argument(f"--admission-{_cls}-queue", type=int,
                        help=f"queued {_cls}-class requests beyond the "
                             f"cap; overflow sheds 429 "
                             f"([admission] {_cls}-queue)")
    ps.add_argument("--no-result-cache", action="store_true",
                    help="disable the generation-stamped query result "
                         "cache ([cache] enabled=false): every read "
                         "re-executes on the device")
    ps.add_argument("--cache-budget-bytes", type=int,
                    help="host-memory budget for cached query results "
                         "([cache] budget-bytes)")
    ps.add_argument("--cache-max-entry-bytes", type=int,
                    help="largest single cacheable result "
                         "([cache] max-entry-bytes)")
    ps.add_argument("--cache-ttl", type=float,
                    help="seconds before a cached result ages out even "
                         "unmutated ([cache] ttl; 0 = generations only)")
    ps.add_argument("--no-ragged", action="store_true",
                    help="disable ragged megabatch execution "
                         "([ragged] enabled=false): the coalescer "
                         "merges only identical-shape queries through "
                         "the fused path (pre-ragged behavior)")
    ps.add_argument("--ragged-max-tape", type=int,
                    help="longest op-tape a query may compile to "
                         "before falling back to the per-shape fused "
                         "path ([ragged] max-tape)")
    ps.add_argument("--ragged-max-leaves", type=int,
                    help="most leaf operand stacks a query may stage "
                         "into a ragged bucket ([ragged] max-leaves)")
    ps.add_argument("--no-containers", action="store_true",
                    help="disable the compressed container-directory "
                         "device layout ([containers] enabled=false): "
                         "every fused read routes the dense "
                         "pre-container path")
    ps.add_argument("--containers-threshold", type=float,
                    help="per-fragment fill-ratio ceiling for "
                         "compressed execution ([containers] "
                         "threshold); rows denser than this stay on "
                         "the dense path")
    ps.add_argument("--no-container-kinds", action="store_true",
                    help="disable per-container kind specialization "
                         "([containers] kinds=false): every container "
                         "stays a dense 2048-word bitmap block")
    ps.add_argument("--containers-array-max", type=int,
                    help="cardinality ceiling for the array container "
                         "kind ([containers] array-max, canonical "
                         "4096); lower values only narrow the device "
                         "pick")
    ps.add_argument("--containers-run-cap", type=int,
                    help="most intervals a run container may carry on "
                         "device ([containers] run-cap); noisier "
                         "containers demote to array/bitmap")
    ps.add_argument("--no-mesh", action="store_true",
                    help="disable mesh-native SPMD execution ([mesh] "
                         "enabled=false)")
    ps.add_argument("--mesh-axis-size", type=int,
                    help="local devices joined to the mesh shard axis "
                         "([mesh] axis-size); 0 = all local devices")
    ps.add_argument("--residency-host-budget-bytes", type=int,
                    help="host-RAM tier budget behind device memory "
                         "([residency] host-budget-bytes); 0 disables "
                         "tiering")
    ps.add_argument("--residency-disk-path",
                    help="directory for the optional disk spill tier "
                         "behind host RAM ([residency] disk-path); "
                         "empty disables it")
    ps.add_argument("--residency-promote-workers", type=int,
                    help="async promotion worker threads ([residency] "
                         "promote-workers)")
    ps.add_argument("--residency-promote-wait-ms", type=float,
                    help="bound on a demand miss's promotion wait "
                         "before the host-compute fallback "
                         "([residency] promote-wait-ms)")
    ps.add_argument("--no-prefetch", action="store_true",
                    help="disable the predictive host-tier prefetcher "
                         "([residency] prefetch=false)")
    ps.add_argument("--no-ingest-delta", action="store_true",
                    help="disable streaming-ingest delta planes "
                         "([ingest] delta-enabled=false): every write "
                         "mutates base state and bumps the generation "
                         "(pre-delta semantics)")
    ps.add_argument("--ingest-delta-budget-bytes", type=int,
                    help="process-wide bound on pending delta bytes; "
                         "past it writers flush their own fragment "
                         "inline ([ingest] delta-budget-bytes)")
    ps.add_argument("--ingest-compact-threshold-bits", type=int,
                    help="pending bit positions that trigger a "
                         "fragment's compaction on the next scan "
                         "([ingest] compact-threshold-bits)")
    ps.add_argument("--ingest-compact-interval", type=float,
                    help="compactor scan period in seconds, and the "
                         "age bound for small deltas ([ingest] "
                         "compact-interval)")
    ps.add_argument("--breaker-threshold", type=int,
                    help="consecutive transport failures that open a "
                         "peer's circuit breaker ([cluster] "
                         "breaker-threshold)")
    ps.add_argument("--breaker-cooldown", type=float,
                    help="seconds a breaker stays open before the "
                         "half-open trial ([cluster] breaker-cooldown)")
    ps.add_argument("--hedge-max-fraction", type=float,
                    help="bound on hedged replica reads as a fraction "
                         "of RPC volume ([cluster] hedge-max-fraction; "
                         "0 disables hedging)")
    ps.add_argument("--faultinject-armed",
                    help="failpoint spec armed at open ([faultinject] "
                         "armed)")
    ps.add_argument("--write-policy", choices=("all", "available"),
                    help="replica write policy ([replication] "
                         "write-policy)")
    ps.add_argument("--hint-max-bytes", type=int,
                    help="total bytes of queued hinted-handoff writes "
                         "([replication] hint-max-bytes)")
    ps.add_argument("--rebalance-transfer-budget", type=int,
                    help="concurrent shard backfills during an online "
                         "rebalance ([rebalance] transfer-budget)")
    ps.add_argument("--rebalance-dual-write-policy",
                    choices=("hint", "strict"),
                    help="delivery contract for pending shard owners "
                         "during a migration ([rebalance] "
                         "dual-write-policy)")
    ps.add_argument("--anti-entropy-round-budget", type=float,
                    help="seconds per anti-entropy slice ([anti-entropy] "
                         "round-budget; 0 = whole holder per round)")
    ps.add_argument("--tenants-enabled", action="store_true",
                    help="enable per-tenant isolation ([tenants] "
                         "enabled): weighted-fair admission and "
                         "result-cache soft budgets per X-Pilosa-Tenant")
    ps.add_argument("--tenant-default-share", type=int,
                    help="concurrency share (per admission class) of "
                         "tenants without their own quota ([tenants] "
                         "default-share)")
    ps.add_argument("--tenant-default-queue", type=int,
                    help="per-class queue depth of tenants without "
                         "their own quota ([tenants] default-queue)")
    ps.add_argument("--tenant-quota", action="append", default=None,
                    metavar="NAME:SHARE[:QUEUE[:CACHE[:RES]]]",
                    help="per-tenant quota entry ([tenants] quotas); "
                         "repeatable, e.g. --tenant-quota "
                         "gold:16:64:0.5 --tenant-quota free:2:8")
    ps.add_argument("--verbose", action="store_true")
    ps.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")

    pi = sub.add_parser("import", help="bulk-import CSV bits")
    pi.add_argument("--host", default="http://127.0.0.1:10101")
    pi.add_argument("-i", "--index", required=True)
    pi.add_argument("-f", "--field", required=True)
    pi.add_argument("--create", action="store_true",
                    help="create index/field if missing")
    pi.add_argument("--clear", action="store_true")
    pi.add_argument("--field-type", default="set",
                    choices=["set", "int", "time", "mutex", "bool"])
    pi.add_argument("--min", type=int, default=0)
    pi.add_argument("--max", type=int, default=2**31 - 1)
    pi.add_argument("--time-quantum", default="")
    pi.add_argument("--batch-size", type=int, default=1_000_000,
                    help="bits buffered per request (reference buffers 10M)")
    pi.add_argument("files", nargs="+")

    pe = sub.add_parser("export", help="export a field as CSV")
    pe.add_argument("--host", default="http://127.0.0.1:10101")
    pe.add_argument("-i", "--index", required=True)
    pe.add_argument("-f", "--field", required=True)
    pe.add_argument("-o", "--output", default="-")

    pc = sub.add_parser("check", help="offline integrity check of a data dir")
    pc.add_argument("data_dir")
    pc.add_argument("--device", default=None,
                    help="torch device the holder opens on (default cuda)")

    pn = sub.add_parser("inspect", help="dump fragment stats from a data dir")
    pn.add_argument("data_dir")
    pn.add_argument("-i", "--index")
    pn.add_argument("-f", "--field")
    pn.add_argument("--device", default=None,
                    help="torch device the holder opens on (default cuda)")

    sub.add_parser("generate-config", help="print default TOML config")

    pcfg = sub.add_parser("config", help="print effective config")
    pcfg.add_argument("-c", "--config", help="TOML config file")

    args = p.parse_args(argv)
    return {
        "server": cmd_server,
        "import": cmd_import,
        "export": cmd_export,
        "check": cmd_check,
        "inspect": cmd_inspect,
        "generate-config": cmd_generate_config,
        "config": cmd_config,
    }[args.command](args)


# ---------------------------------------------------------------- server

def cmd_server(args) -> int:
    """Flags over the TOML file and the environment
    (pilosa_tpu/cmd.py:267-367)."""
    overrides = {}
    for key in ("data_dir", "bind", "name", "heartbeat_interval"):
        v = getattr(args, key, None)
        if v is not None:  # explicit 0 must override the config file
            overrides[key] = v
    if args.verbose:
        overrides["verbose"] = True
    cfg = Config.load(args.config, overrides=overrides)
    if args.seeds:
        cfg.cluster.seeds = [s for s in args.seeds.split(",") if s]
    if args.replicas is not None:
        cfg.cluster.replicas = args.replicas
    if args.anti_entropy_interval is not None:
        cfg.anti_entropy.interval = args.anti_entropy_interval
    if args.long_query_time is not None:
        cfg.observe.long_query_time = args.long_query_time
    if args.no_admission:
        cfg.admission.enabled = False
    if args.admission_default_deadline is not None:
        cfg.admission.default_deadline = args.admission_default_deadline
    for _cls in ("query", "ingest", "internal"):
        for _kind in ("cap", "queue"):
            v = getattr(args, f"admission_{_cls}_{_kind}", None)
            if v is not None:
                setattr(cfg.admission, f"{_cls}_{_kind}", v)
    if args.no_result_cache:
        cfg.cache.enabled = False
    for key in ("budget_bytes", "max_entry_bytes", "ttl"):
        v = getattr(args, f"cache_{key}", None)
        if v is not None:
            setattr(cfg.cache, key, v)
    if args.no_ragged:
        cfg.ragged.enabled = False
    for key in ("max_tape", "max_leaves"):
        v = getattr(args, f"ragged_{key}", None)
        if v is not None:
            setattr(cfg.ragged, key, v)
    if args.no_containers:
        cfg.containers.enabled = False
    if args.containers_threshold is not None:
        cfg.containers.threshold = args.containers_threshold
    if args.no_container_kinds:
        cfg.containers.kinds = False
    if args.containers_array_max is not None:
        cfg.containers.array_max = args.containers_array_max
    if args.containers_run_cap is not None:
        cfg.containers.run_cap = args.containers_run_cap
    if args.no_mesh:
        cfg.mesh.enabled = "false"
    if args.mesh_axis_size is not None:
        cfg.mesh.axis_size = args.mesh_axis_size
    if args.residency_host_budget_bytes is not None:
        cfg.residency.host_budget_bytes = \
            args.residency_host_budget_bytes
    if args.residency_disk_path is not None:
        cfg.residency.disk_path = args.residency_disk_path
    if args.residency_promote_workers is not None:
        cfg.residency.promote_workers = args.residency_promote_workers
    if args.residency_promote_wait_ms is not None:
        cfg.residency.promote_wait_ms = args.residency_promote_wait_ms
    if args.no_prefetch:
        cfg.residency.prefetch = False
    for key in ("breaker_threshold", "breaker_cooldown",
                "hedge_max_fraction"):
        v = getattr(args, key, None)
        if v is not None:
            setattr(cfg.cluster, key, v)
    if args.faultinject_armed is not None:
        cfg.faultinject.armed = args.faultinject_armed
    if args.write_policy is not None:
        cfg.replication.write_policy = args.write_policy
    if args.hint_max_bytes is not None:
        cfg.replication.hint_max_bytes = args.hint_max_bytes
    if args.anti_entropy_round_budget is not None:
        cfg.anti_entropy.round_budget = args.anti_entropy_round_budget
    if args.rebalance_transfer_budget is not None:
        cfg.rebalance.transfer_budget = args.rebalance_transfer_budget
    if args.rebalance_dual_write_policy is not None:
        cfg.rebalance.dual_write_policy = args.rebalance_dual_write_policy
    if args.no_ingest_delta:
        cfg.ingest.delta_enabled = False
    for key in ("delta_budget_bytes", "compact_threshold_bits",
                "compact_interval"):
        v = getattr(args, f"ingest_{key}", None)
        if v is not None:
            setattr(cfg.ingest, key, v)
    if args.tenants_enabled:
        cfg.tenants.enabled = True
    if args.tenant_default_share is not None:
        cfg.tenants.default_share = args.tenant_default_share
    if args.tenant_default_queue is not None:
        cfg.tenants.default_queue = args.tenant_default_queue
    if args.tenant_quota:
        from pilosa_tpu_torch.serve.tenant import parse_quota_spec

        quotas = dict(cfg.tenants.quotas)
        for spec in args.tenant_quota:
            quotas.update(parse_quota_spec(spec))
        cfg.tenants.quotas = quotas
    return run_server(cfg, device=args.device)


def unapplied(cfg: Config) -> list[tuple[str, object, str]]:
    """(key, value, ROADMAP Queue 1 item) of every key that differs from
    its default and that the port does not apply yet."""
    default = Config()
    out = []
    for (section, name), item in UNAPPLIED.items():
        have = cfg if section is None else getattr(cfg, section)
        want = default if section is None else getattr(default, section)
        names = list(vars(have)) if name == "*" else [name]
        for n in names:
            v = getattr(have, n)
            if v != getattr(want, n):
                key = n.replace("_", "-")
                if section is not None:
                    key = f"[{section.replace('_', '-')}] {key}"
                out.append((key, v, item))
    return out


def _server_knobs(cfg: Config) -> dict:
    """The Server's keyword arguments from every key the port applies.
    An admission or tenant value left at its default is not passed, so
    that the server keeps its own default, the same value."""
    default = Config()
    adm, dadm = cfg.admission, default.admission
    ten, dten = cfg.tenants, default.tenants
    kw = dict(
        coalescer_enabled=cfg.coalescer.enabled,
        coalescer_window_ms=cfg.coalescer.window_ms,
        coalescer_max_batch=cfg.coalescer.max_batch,
        ragged_enabled=cfg.ragged.enabled,
        ragged_max_tape=cfg.ragged.max_tape,
        ragged_max_leaves=cfg.ragged.max_leaves,
        ragged_prewarm=cfg.ragged.prewarm,
        vm_enabled=cfg.vm.enabled,
        vm_min_domain=cfg.vm.min_domain,
        vm_max_prefetch=cfg.vm.max_prefetch,
        containers_enabled=cfg.containers.enabled,
        containers_threshold=cfg.containers.threshold,
        containers_kinds=cfg.containers.kinds,
        containers_array_max=cfg.containers.array_max,
        containers_run_cap=cfg.containers.run_cap,
        cache_enabled=cfg.cache.enabled,
        cache_budget_bytes=cfg.cache.budget_bytes,
        cache_max_entry_bytes=cfg.cache.max_entry_bytes,
        cache_ttl=cfg.cache.ttl,
        ingest_delta_enabled=cfg.ingest.delta_enabled,
        ingest_delta_budget_bytes=cfg.ingest.delta_budget_bytes,
        ingest_compact_threshold_bits=cfg.ingest.compact_threshold_bits,
        ingest_compact_interval=cfg.ingest.compact_interval,
        admission_enabled=adm.enabled,
        tenants_enabled=ten.enabled,
        tenants_default_share=(None if ten.default_share
                               == dten.default_share
                               else ten.default_share),
        tenants_default_queue=(None if ten.default_queue
                               == dten.default_queue
                               else ten.default_queue),
        tenants_quotas=ten.quotas or None,
        residency_host_budget_bytes=cfg.residency.host_budget_bytes,
        residency_disk_path=cfg.residency.disk_path,
        residency_disk_budget_bytes=cfg.residency.disk_budget_bytes,
        residency_promote_workers=cfg.residency.promote_workers,
        residency_promote_queue=cfg.residency.promote_queue,
        residency_promote_wait_ms=cfg.residency.promote_wait_ms,
        residency_prefetch=cfg.residency.prefetch,
        residency_prefetch_interval=cfg.residency.prefetch_interval,
        max_writes_per_request=cfg.max_writes_per_request,
        long_query_time=cfg.cluster.long_query_time,
    )
    for key in ("query_cap", "query_queue", "ingest_cap", "ingest_queue",
                "internal_cap", "internal_queue", "default_deadline"):
        if getattr(adm, key) != getattr(dadm, key):
            kw[f"admission_{key}"] = getattr(adm, key)
    for key in ("default_cache_share", "default_residency_share"):
        if getattr(ten, key) != getattr(dten, key):
            kw[f"tenants_{key}"] = getattr(ten, key)
    return kw


def run_server(cfg: Config, ready_event: threading.Event | None = None,
               stop_event: threading.Event | None = None,
               device: str | None = None) -> int:
    """Build and run a node until SIGTERM/SIGINT, or until
    ``stop_event`` is set (pilosa_tpu/cmd.py:370-534).  The node runs on
    ``device``, ``cuda`` by default.  Off the main thread no signal
    handler is installed; on it, the handlers in force before are back
    once the node has closed."""
    from pilosa_tpu_torch.logger import StandardLogger, VerboseLogger
    from pilosa_tpu_torch.server import server as _server

    # line-buffered: each log line is in the file as it is written
    log_stream = (open(cfg.log_path, "a", buffering=1) if cfg.log_path
                  else None)
    try:
        log = (VerboseLogger(log_stream) if cfg.verbose
               else StandardLogger(log_stream))
        for key, value, item in unapplied(cfg):
            log.printf("config %s = %r is parsed, not applied by the port "
                       "yet (ROADMAP Queue 1 item %s)", key, value, item)
        srv = _server.Server(cfg.expanded_data_dir(), host=cfg.host,
                             port=cfg.port, device=device, logger=log,
                             **_server_knobs(cfg))
        stop = stop_event or threading.Event()

        def _sig(signum, frame):
            stop.set()

        previous = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, _sig)
        except ValueError:
            pass  # not the main thread
        try:
            srv.open()
            try:
                log.printf("listening on %s (node %s)", srv.uri,
                           srv.holder.node_id)
                print(f"pilosa_tpu_torch serving {cfg.expanded_data_dir()} "
                      f"at {srv.uri} on {srv.device}", flush=True)
                if ready_event is not None:
                    ready_event.set()
                stop.wait()
            finally:
                srv.close()
        finally:
            for sig, handler in previous.items():
                if handler is not None:  # None: not set from Python
                    signal.signal(sig, handler)
    finally:
        if log_stream is not None:
            log_stream.close()
    return 0


# ---------------------------------------------------------------- import

def cmd_import(args) -> int:
    """CSV rows are `row,col[,timestamp]` (set/time/mutex/bool) or
    `col,value` (int) — the reference's two formats
    (pilosa_tpu/cmd.py:543-687).  Bits are buffered, then sent through
    the bulk import routes."""
    from pilosa_tpu_torch import csvload
    from pilosa_tpu_torch._client import Client, ClientError

    client = Client()
    host = args.host.rstrip("/")
    if args.create:
        opts = {"type": args.field_type}
        if args.field_type == "int":
            opts.update(min=args.min, max=args.max)
        if args.field_type == "time":
            opts.update(timeQuantum=args.time_quantum or "YMDH")
        # an index or field that exists already answers 409
        try:
            client.create_index(host, args.index, {})
        except ClientError:
            pass
        try:
            client.create_field(host, args.index, args.field,
                                {"type": args.field_type, **opts})
        except ClientError:
            pass

    is_value = args.field_type == "int"
    rows, cols, values, timestamps = [], [], [], []
    n_sent = 0

    def flush():
        nonlocal n_sent, rows, cols, values, timestamps
        if is_value and cols:
            client.import_values(host, args.index, args.field, cols, values)
        elif cols:
            client.import_bits(
                host, args.index, args.field, rows, cols,
                timestamps=[t for t in timestamps] if any(
                    t is not None for t in timestamps) else None,
                clear=args.clear)
        n_sent += len(cols)
        rows, cols, values, timestamps = [], [], [], []

    def consume_python(stream, path, line_base=0):
        """Full CSV semantics incl. timestamps and quoting (reference
        bufferBits, ctl/import.go:173)."""
        reader = csv.reader(stream)
        while True:
            try:
                rec = next(reader)
            except StopIteration:
                return True
            except csv.Error as e:
                print(f"{path}:{line_base + reader.line_num}: "
                      f"bad record: {e}", file=sys.stderr)
                return False
            line_no = line_base + reader.line_num
            if not rec or (len(rec) == 1 and not rec[0].strip()):
                continue
            try:
                if is_value:
                    cols.append(int(rec[0]))
                    values.append(int(rec[1]))
                else:
                    rows.append(int(rec[0]))
                    cols.append(int(rec[1]))
                    timestamps.append(
                        _csv_ts(rec[2]) if len(rec) > 2 and rec[2]
                        else None)
            except (ValueError, IndexError) as e:
                print(f"{path}:{line_no}: bad record {rec!r}: {e}",
                      file=sys.stderr)
                return False
            if len(cols) >= args.batch_size:
                flush()

    try:
        for path in args.files:
            stream = sys.stdin if path == "-" else open(path)
            # never close stdin: callers (and later "-" args) still need it
            ctx = contextlib.nullcontext(stream) if path == "-" else stream
            with ctx:
                # the bytes under the stream, read back as universal-
                # newline text: what the reference's loader hands its
                # Python path
                text = csvload.chain_text(b"", csvload.raw_stream(stream))
                if not consume_python(text, path):
                    return 1
        flush()
    finally:
        client.close()
    print(f"imported {n_sent} records into "
          f"{args.index}/{args.field}", file=sys.stderr)
    return 0


def _csv_ts(raw: str) -> str:
    # reference import format uses RFC3339 (ctl/import.go:300)
    return dt.datetime.fromisoformat(raw.replace("Z", "")).isoformat()


# ---------------------------------------------------------------- export

def cmd_export(args) -> int:
    """Every shard's ``/export`` CSV, shards 0 to the index's highest
    from ``/internal/shards/max`` (pilosa_tpu/cmd.py:697-717)."""
    import json
    import urllib.request

    host = args.host.rstrip("/")
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        with urllib.request.urlopen(f"{host}/internal/shards/max",
                                    timeout=30) as resp:
            max_shards = json.loads(resp.read())["standard"]
        max_shard = max_shards.get(args.index, 0)
        for shard in range(max_shard + 1):
            with urllib.request.urlopen(
                    f"{host}/export?index={args.index}&field={args.field}"
                    f"&shard={shard}", timeout=120) as resp:
                out.write(resp.read().decode())
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ----------------------------------------------------------------- check

def cmd_check(args) -> int:
    """Open every fragment offline and verify snapshot+WAL load, row
    consistency, and roaring round-trip (pilosa_tpu/cmd.py:722-751)."""
    from pilosa_tpu_torch.storage.roaring import decode as decode_roaring

    bad = 0
    holder = _open_holder_or_report(args.data_dir, args.device)
    if holder is None:
        return 1
    try:
        for d in holder.schema():
            idx = holder.index(d["name"])
            for f in idx.all_fields():
                for vname, view in f.views.items():
                    for shard, frag in sorted(view.fragments.items()):
                        label = f"{d['name']}/{f.name}/{vname}/{shard}"
                        try:
                            frag.check()  # structural invariants
                            blob = frag.to_roaring()
                            decode_roaring(blob)
                            for r in frag.row_ids():
                                frag.row_count(r)
                            print(f"ok   {label}")
                        except Exception as e:
                            bad += 1
                            print(f"FAIL {label}: {e}")
    finally:
        holder.close()
    print(f"{'FAILED' if bad else 'passed'}: {bad} corrupt fragment(s)")
    return 1 if bad else 0


# --------------------------------------------------------------- inspect

def _open_holder_or_report(data_dir: str, device: str | None):
    """Open a data dir for the offline tools, reporting (instead of
    tracebacking) when it is corrupt or locked by a live server."""
    from pilosa_tpu_torch.models.holder import Holder

    try:
        return Holder(data_dir, device=device)
    except Exception as e:
        print(f"FAIL open {data_dir}: {e}")
        print("FAILED: holder did not open")
        return None


def cmd_inspect(args) -> int:
    """Rows, bits and WAL operations of every fragment
    (pilosa_tpu/cmd.py:769-795)."""
    holder = _open_holder_or_report(args.data_dir, args.device)
    if holder is None:
        return 1
    bad = 0
    try:
        for d in holder.schema():
            if args.index and d["name"] != args.index:
                continue
            idx = holder.index(d["name"])
            for f in idx.all_fields():
                if args.field and f.name != args.field:
                    continue
                for vname, view in sorted(f.views.items()):
                    for shard, frag in sorted(view.fragments.items()):
                        label = f"{d['name']}/{f.name}/{vname}/shard={shard}"
                        try:
                            ids = frag.row_ids()
                            bits = sum(frag.row_count(r) for r in ids)
                            print(f"{label}: rows={len(ids)} bits={bits} "
                                  f"opN={frag._op_n}")
                        except Exception as e:
                            bad += 1
                            print(f"{label}: FAIL {e}")
    finally:
        holder.close()
    return 1 if bad else 0


# ---------------------------------------------------------------- config

def cmd_generate_config(args) -> int:
    print(Config().to_toml(), end="")
    return 0


def cmd_config(args) -> int:
    print(Config.load(getattr(args, "config", None)).to_toml(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
