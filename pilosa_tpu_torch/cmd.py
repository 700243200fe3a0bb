"""Command line of the port:

    python -m pilosa_tpu_torch server -d DIR -b HOST:PORT [--device cpu]
        [--no-ragged] [--ragged-max-tape N] [--ragged-max-leaves N]
        [--no-ingest-delta] [--ingest-delta-budget-bytes N]
        [--ingest-compact-threshold-bits N] [--ingest-compact-interval S]
        [--no-result-cache] [--cache-budget-bytes N]
        [--cache-max-entry-bytes N] [--cache-ttl S]
        [--no-admission] [--admission-default-deadline S]
        [--admission-{query,ingest,internal}-{cap,queue} N]
        [--tenants-enabled] [--tenant-default-share N]
        [--tenant-default-queue N]
        [--tenant-quota NAME:SHARE[:QUEUE[:CACHE[:RES]]]]...

Serves the data directory over HTTP until SIGINT or SIGTERM.  The node
runs on ``cuda`` unless ``--device cpu`` is given.  The ragged, ingest,
cache, admission and tenant flags are the reference's (pilosa_tpu/
cmd.py:43-85, 133-150, 190-210); the TOML config is not part of the
port yet.
"""

from __future__ import annotations

import argparse
import signal
import threading


def _serve(args) -> int:
    from pilosa_tpu_torch.server.server import Server

    host, _, port = (args.bind or "127.0.0.1:10101").rpartition(":")
    ragged = {}
    if args.ragged_max_tape is not None:
        ragged["ragged_max_tape"] = args.ragged_max_tape
    if args.ragged_max_leaves is not None:
        ragged["ragged_max_leaves"] = args.ragged_max_leaves
    # an admission flag left out keeps the server's default
    admission = {f"admission_{c}_{k}": getattr(args, f"admission_{c}_{k}")
                 for c in ("query", "ingest", "internal")
                 for k in ("cap", "queue")
                 if getattr(args, f"admission_{c}_{k}") is not None}
    if args.admission_default_deadline is not None:
        admission["admission_default_deadline"] = \
            args.admission_default_deadline
    quotas = None
    if args.tenant_quota:
        from pilosa_tpu_torch.serve.tenant import parse_quota_spec

        quotas = {}
        for spec in args.tenant_quota:
            quotas.update(parse_quota_spec(spec))
    srv = Server(args.data_dir, host=host or "127.0.0.1", port=int(port),
                 device=args.device, ragged_enabled=not args.no_ragged,
                 ingest_delta_enabled=not args.no_ingest_delta,
                 ingest_delta_budget_bytes=args.ingest_delta_budget_bytes,
                 ingest_compact_threshold_bits=(
                     args.ingest_compact_threshold_bits),
                 ingest_compact_interval=args.ingest_compact_interval,
                 cache_enabled=not args.no_result_cache,
                 cache_budget_bytes=args.cache_budget_bytes,
                 cache_max_entry_bytes=args.cache_max_entry_bytes,
                 cache_ttl=args.cache_ttl,
                 admission_enabled=not args.no_admission,
                 tenants_enabled=args.tenants_enabled,
                 tenants_default_share=args.tenant_default_share,
                 tenants_default_queue=args.tenant_default_queue,
                 tenants_quotas=quotas,
                 **ragged, **admission)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    srv.open()
    print(f"pilosa_tpu_torch serving {args.data_dir} at {srv.uri} on "
          f"{srv.device}", flush=True)
    try:
        stop.wait()
    finally:
        srv.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("server", help="serve a data directory over HTTP")
    ps.add_argument("-d", "--data-dir", required=True)
    ps.add_argument("-b", "--bind", help="HOST:PORT (default "
                                         "127.0.0.1:10101)")
    ps.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    ps.add_argument("--no-ragged", action="store_true",
                    help="disable ragged megabatch execution: the "
                         "coalescer merges only identical-shape queries "
                         "through the fused path (the bitmap VM rides "
                         "the ragged engine and is off too)")
    ps.add_argument("--ragged-max-tape", type=int,
                    help="longest op-tape a query may compile to before "
                         "falling back to the per-shape fused path")
    ps.add_argument("--ragged-max-leaves", type=int,
                    help="most leaf operands a query may stage into a "
                         "ragged bucket")
    ps.add_argument("--no-ingest-delta", action="store_true",
                    help="disable streaming-ingest delta planes ([ingest] "
                         "delta-enabled=false): every write merges into "
                         "the base rows at once")
    ps.add_argument("--ingest-delta-budget-bytes", type=int,
                    help="process-wide bound on pending delta bytes; past "
                         "it a writer flushes its own fragment inline")
    ps.add_argument("--ingest-compact-threshold-bits", type=int,
                    help="pending bit positions at which a fragment's "
                         "delta merges on the next compactor scan")
    ps.add_argument("--ingest-compact-interval", type=float,
                    help="compactor scan period in seconds, also the age "
                         "bound of a small delta")
    ps.add_argument("--no-result-cache", action="store_true",
                    help="disable the generation-stamped query result "
                         "cache ([cache] enabled=false): every read "
                         "executes")
    ps.add_argument("--cache-budget-bytes", type=int,
                    help="host-memory budget for cached query results "
                         "([cache] budget-bytes)")
    ps.add_argument("--cache-max-entry-bytes", type=int,
                    help="largest single cacheable result "
                         "([cache] max-entry-bytes)")
    ps.add_argument("--cache-ttl", type=float,
                    help="seconds before a cached result ages out even "
                         "unmutated ([cache] ttl; 0 = generations only)")
    ps.add_argument("--no-admission", action="store_true",
                    help="disable the admission gate ([admission] "
                         "enabled=false): no per-class caps, no load "
                         "shedding, no accept-side thread cap")
    ps.add_argument("--admission-default-deadline", type=float,
                    help="seconds applied to requests without an "
                         "X-Pilosa-Deadline header ([admission] "
                         "default-deadline; 0 = none)")
    for cls in ("query", "ingest", "internal"):
        ps.add_argument(f"--admission-{cls}-cap", type=int,
                        help=f"concurrent {cls}-class requests "
                             f"([admission] {cls}-cap)")
        ps.add_argument(f"--admission-{cls}-queue", type=int,
                        help=f"queued {cls}-class requests beyond the "
                             f"cap; overflow sheds 429 "
                             f"([admission] {cls}-queue)")
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
    args = p.parse_args(argv)
    return _serve(args)
