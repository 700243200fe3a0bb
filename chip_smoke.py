#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine whose torch sees a CUDA
card.  It drives the port's main paths -- the HTTP server answering PQL
Count trees over a 256-shard x 2^20-column index, alone and concurrently
through the coalescer, TopN, Rows and GroupBy over the same index, range
rows and Sum/Min/Max over an int field on it, and Count/Row trees over
array, run and bitmap containers ([containers] kinds, the server's
default), and writes that wait in ingest delta planes ([ingest]
delta-enabled, the server's default) under coalesced, dense and
per-shard reads, mutex, bool and time fields with the schema and admin
routes, string keys, attributes and protobuf bodies (the wire surface of
a stock Pilosa client), admission control and request deadlines
([admission] enabled, the server's default), the result cache
([cache] enabled, the server's default) with the calls it keys, and the
serving shell (a TOML file, the CLI's import, export, check and inspect,
the ``/internal`` reads) -- and holds every hand-written kernel against
its plain PyTorch version on the card.

The HBM budget of the residency manager is stated as an operator of
this shape states it: ``PILOSA_TPU_DEVICE_BUDGET_BYTES`` set to the
default's own figure, 60 % of the card's memory, which lifts the
reference's 512 MiB entry cap to a quarter of the budget, so that v's
704 MiB plane stack is cached.  The server runs the port's defaults
([residency] tiers, the prefetcher and [ragged] prewarm on), with one
knob set: its compactor
scans once an hour (``INGEST_INTERVAL``), so that every delta merge in
the run is a writer's (a fragment's snapshot past ``max_op_n`` WAL
operations, the 64 MiB budget), a query's (``?nodelta=1``, a whole-matrix
read) or an explicit compactor scan, and no route depends on timing.
After each field's import one scan merges what is left, so that the
paths read base rows, as they would once the compactor had run.

1. header: the card's name and power limit (nvidia-smi);
2. build: the K2, K3, K3-kinds, K4, K5, K6 and K1 sources, one nvcc each
   for sm_90a, side by side;
3. K2 check: ``gathered_count_and`` against its plain version on seeded
   pools (zero rows, indices past either end, P=1, a P that is not a
   power of two, and P=4096 over two 8192-row pools), bit-exact;
4. K3 check: the kernel's shared-memory formula against the wrapper's;
   ``vm_counts`` against its plain version on seeded pools and random SSA
   programs over all five opcodes (B=1 D=1; (L, T) = (4, 4) and the caps
   (16, 32); pad rows and pad slots on the zero row; an 8192-row pool),
   and on the launches of tests/torch_vm_cases.py at D=128 (16 queries
   sharing five leaves, one row in two slots, pads and COPY chains, the
   caps, a batch cut into query groups, (L, T) = (64, 32)), one launch
   each, bit-exact;
4b. K3-kinds check: ``vm_counts_kinds`` against its plain version on
   seeded kind-split megapools (array, run and bitmap containers with
   bits 0 and 65535): B=1 D=1; (L, T) = (4, 4) and the caps (16, 32);
   pad rows and slots; each kind's pool empty in turn; 4096 containers;
   and the decode's edges from tests/torch_kinds_edges.py (values and runs
   on the kernel's pass and warp boundaries, full and empty arrays, 256
   runs, a run of one bit, two runs in one word) at (4, 4), the caps and
   (L, T) = (64, 32), every edge row alone, and run rows re-padded to a
   wider rcap, bit-exact;
5. the K2 path: a ``cuda`` Server (coalescer on by default) on a
   temporary directory; field f's rows 1-3 at 8 % fill and row 4 at 50 %
   imported through ``POST .../import-roaring/{shard}``; each query once
   cold and ``WARM_RUNS`` times warm over HTTP with ``?nocoalesce=true``
   (and the K2 query as often through the API in the server's process),
   every answer equal to a numpy ``bitwise_count`` oracle; a Set, which
   waits in a delta plane, so that the recount is dense (``dfuse``, no
   kernel), then a ``?nodelta=1`` recount (the delta merged first, K2) and
   the recount warm (K2).  Launch counts are zeroed just before and read
   just after;
6. the lone query under the coalescer: the same warm Count(Intersect)
   ``WARM_RUNS`` times without the flag, each one K3 launch;
7. the coalesced path: field g's rows 1-3 at 8 % fill; 16 structurally
   distinct 2- and 3-leaf Count trees fired by 16 barrier-started HTTP
   client threads for ``ROUNDS`` rounds, every answer equal to the
   oracle, no VM fallback, K3 launches equal to ``vm.executions``
   (counts zeroed just before, read just after), and the flushes'
   distinct leaf sets and megapool builds; the card's busy share over
   more such rounds (torch.profiler); then rounds that mix in row 4
   (dense), which the VM declines and the dense tape route serves;
8. K4 and K5 checks: ``row_counts_masked`` and ``masked_matrix_counts``
   against their plain versions on seeded words with bit 31 set, at edge
   shapes (one row, widths that are not a multiple of 4 words, zero
   masks) and at the shapes of step 9, bit-exact;
9. the scan path: fields s and u, 64 rows each at fills from 0.49 % to
   12.5 %, imported on shards 0-63; TopN (unfiltered, filtered over all
   shards and on ``?shards=5``), Rows (plain, ``limit``/``previous``,
   ``column``) and GroupBy (two levels, filtered, ``limit``) each once
   cold and ``QUERY_RUNS`` times warm over HTTP, every answer equal to a
   numpy oracle, and the K4 and K5 launches equal to the launch sites
   (counts zeroed just before, read just after);
10. K6 and K1 checks: ``bsi_compare`` (and ``bsi_compare_unsigned``)
   and ``count_and`` against their plain versions on seeded words: depths
   1, 20 and 63, predicates 0, 2^depth - 1 and past 2^depth, widths that
   are not a multiple of 4 words, S = 1, the BSI path's stack shape;
   lengths that are not a multiple of the block, all-ones words, a strided
   plane, and 2^26 all-ones words (2^31 bits), bit-exact;
11. the BSI path: int field v (min -10^6, max 10^6, base 0, bitDepth 20)
   on all 256 shards, about 70 % of the columns holding a value, 30 % of
   those negative; ``import-roaring`` into it answers 400, as in the
   reference, and its 22 plane rows per shard load through the
   in-process ``Field.import_roaring`` into the view ``bsig_v``; 3000
   values through ``/import-value``; range Counts (every operator, a between across
   zero, ``!= null``, out of range, inside an Intersect), a per-shard
   ``Row(v > 999000)`` with ``?shards=5``, and Sum/Min/Max with and
   without a filter, each once cold and ``QUERY_RUNS`` times warm, every
   answer equal to a numpy oracle on the values and K6, K4 and K1
   launched exactly at their launch sites (counts zeroed just before,
   read just after); then a ``Set`` and every query again;
11b. the kinds leg: field k on all 256 shards, imported through
   ``import-roaring``: rows 1-8 arrays at ~0.1 % fill, rows 9-16 runs (16
   runs of 512 columns per container, 12.5 %), rows 17-24 bitmaps at
   8 %; a dozen Count and Row trees over the three kinds, each once cold
   and ``KINDS_WARM`` times warm under the coalescer (a Count is one
   K3-kinds launch, or one K3 over bitmap rows alone) and once with
   ``?nocoalesce=true``; 16 kinds-mixed trees from 16 clients for
   ``KINDS_ROUNDS`` rounds, K3-kinds launches equal to vm.executions;
   every answer equal to a numpy oracle and every kernel launched
   exactly at its launch sites (counts zeroed just before, read just
   after); then every query again with kinds off, equal answers, and
   field k's pool bytes on the card with kinds on and off;
11c. the ingest phase (``phase_ingest``): PQL Sets and Clears on f rows
   1-3, g rows 2-3 and k rows 1, 2, 9, 10, 17, a sparse ``/import`` batch
   and a sparse ``/import-roaring`` payload, all pending in delta planes
   (``GET /debug/ingest``); the 16 coalesced trees over those rows for
   ``INGEST_ROUNDS`` rounds, every query a ``dfuse`` tape on K3, and the
   16 kinds trees on K3-kinds (counts zeroed just before, read just
   after); a ``?nocoalesce=true`` Count and a Row root over delta rows on
   the dense ``dfuse`` path; ``?nodelta=1`` (field f merged, K2), then the
   same Count on K2; host-clock times of a warm coalesced Count over delta
   rows and after compaction, of the first Count after a Set, and of the
   write rate through ``/import``; every answer equal to the numpy
   oracle, which takes every write;
11d. the field-types phase (``phase_field_types``), every query with
   ``?nocache=1``: time field t (quantum YMD) rows 1-2 at 8 %, each bit on
   one of 7 days from 2024-01-29 (11 views), loaded through
   ``/import-roaring`` with a JSON ``{"views": ...}`` body; mutex field m
   (every column in one of rows 1-8 at 40/20/10/10/8/6/4/2 %) and bool
   field b (true 30 %, false 50 %), refused by ``/import-roaring`` (400)
   and loaded through ``Field.import_roaring``; time-range Counts (a
   3-day cover, whole months, an open end, a range with no view, one in
   an Intersect), a ranged Rows, TopN over t and m (K4 filtered), a
   coalesced Count over m (K3) and with ``?nocoalesce=true`` (K2), bool
   Counts and ``GroupBy(Rows(m), Rows(b))`` (K5 per shard), each once cold
   and ``FT_RUNS`` times warm; a ``Set`` into a new day view; a mutex
   ``/import`` of ``FT_MUTEX_MOVES`` bits and two Sets that move columns,
   then every query again; every answer equal to the numpy oracle and
   every kernel launched exactly at its sites; then ``GET /schema``,
   ``GET /export`` of an m shard against the oracle's CSV, ``POST
   /recalculate-caches``, a field deleted and recreated with other bits,
   and the read-only routes;
11e. the keys phase (``phase_keys``), every query a protobuf
   ``QueryRequest`` answered in protobuf with ``?nocache=1``: a keyed set
   field kf on the served index, 16 row keys at ~8 %, their ids from
   ``POST /internal/translate/keys`` in protobuf and their bits by id
   through protobuf ``/import-roaring``, row attributes on every row; a
   keyed index ki of 500,000 column keys and 8 row keys loaded through
   protobuf ``/import`` (rowKeys/columnKeys) in batches of 100,000 bits,
   100,000 of the keys looked up again through the translate route,
   1,000 column attributes; a keyed ``Count(Intersect)`` coalesced (K3)
   and with ``?nocoalesce=true`` (K2), a keyed filtered TopN with and without
   ``attrName`` (K4), ``GroupBy(Rows(kf), Rows(f))`` (K5 per shard),
   ``Row(kf="k3")`` with its attributes, keyed Rows, and on ki
   ``Options(Row(kr="r1"), columnAttrs=true)``, a Count and Rows, each
   once cold and 5 times warm; every answer equal to the numpy oracle
   built from the phase's keys and bits and every kernel launched
   exactly at its sites; a keyed Count timed in JSON and in protobuf;
11f. the admission phase (``phase_admission``), every query with
   ``?nocache=1``: the gate at the server's defaults (query 32/128, ingest
   16/64, internal 16/64); ``X-Pilosa-Deadline: 0`` on the K2/K3 Count is
   503 with the reference's body and ``Retry-After``, a 20 us budget 503,
   a malformed header 400, and K2 and K3 launch nothing; the 16 trees
   from 16 clients for 5 rounds with a 30 s deadline, each answer the
   oracle's; rounds at the server's coalescer in which 8 members carry
   half a window's budget and expire before their flush, the 16 live
   members the oracle's, the expired ones ``DeadlineExceededError``,
   vm.queries counting the live ones only, and at least one flush
   holding both; a budget of 1.9 windows through the API, which bypasses
   the window (K2); a controller with query cap and queue 2 handed to the
   running handler, 16 clients for 4 rounds, every shed 429/503 with
   ``Retry-After``, every answer the oracle's, ``/debug/admission``'s
   totals equal to the responses; host-clock times of the warm coalesced
   Count and of 16-client rounds with the gate on and off, in turns, and
   of one uncontended acquire and release;
11g. the cache phase (``phase_cache``): the result cache at the server's
   default (on); steps 5-11f pass ``?nocache=1`` on every query, so that
   their repeats launch their kernels.  The 16 coalesced trees twice, the
   second round all hits with no K2, K3, K3-kinds, K4 or K5 launch; a Set
   on f row 1 (a pending delta) and then a compaction each make every
   Count over field f miss and relaunch while Counts over g alone hit;
   ``CACHE_FLIGHT`` concurrent identical cold Counts make one fill and at
   most one launch; a Shift Count, MinRow/MaxRow, Store and ClearRow at
   full width against the oracle; host-clock times of warm hits against
   ``?nocache=1`` misses of a Count, a TopN, a GroupBy and a Shift Count;
11i. the residency phase (``phase_residency``): the manager's budget,
   bytes, entries and evictions after every earlier phase; the budget set
   to 128 MiB (a few 32-64 MiB stacks and leaves), 5 rounds of 7
   ``Count(Intersect(a, b))`` over seeded pairs of f rows 1-4 and g rows
   1-3, each once with ``?nocoalesce=true`` (K2), once through the
   coalescer (K3) and once with ``?notiers=1``, the last round with a
   promotion wait of 0 (host-bytes reads), then ``TopN(s, Row(f=1),
   n=10)`` (K4 over a 512 MiB matrix stack, over the budget) and
   ``Count(Row(v > 1000))`` (K6 over v's 704 MiB plane stack, over the
   entry cap) twice each; every answer the oracle's, the three bodies of
   a pair byte-identical, and the tracked bytes never over the larger of
   the budget and the largest entry; the reads' medians by route (HBM
   hit, promoted, host bytes, rebuilt); a real out-of-memory error: warm
   leaves, a ballast tensor over the card's free memory but 16 MiB, and
   a dense ``Count(Row(s=5))`` whose cold 32 MiB stack uploads only after
   ``run_with_oom_retry`` has evicted the warm leaves (one retry, the
   budget 10 % smaller); and rows of a fresh field through ``/import``,
   prewarmed in the background, whose first dense Count reads the
   prewarmed stacks;
11h. the shell phase (``phase_shell``), after the main server has
   closed: a TOML file that sets every key the port applies to a value
   the phase observes (``[cache] enabled = false``, ``[admission]
   query-cap``, ``max-writes-per-request``, ``[cluster]
   long-query-time`` with ``log-path``, ``[coalescer] enabled``, and
   ``[containers] kinds = false``, so that the 4 % rows stay bitmap
   blocks that K2 and K3 read), printed back by ``config``;
   ``cmd.run_server`` on it, in a thread, with no device flag, serving on
   cuda; three CSVs through ``cmd.main(["import", "--create", ...])``:
   set field f rows 1 and 2 over 64 shards at 4 % (about 5.4 M records),
   1,000,000 ``col,value`` records of int field v and 10,000 timestamped
   records of time field t; ``Count(Intersect(Row(f=1), Row(f=2)))`` with
   ``?nocoalesce=true`` (K2) and without (K3), ``Sum(field=v)`` (K4) and
   a time-range Count, each equal to the numpy oracle;
   ``/internal/shards/max``, ``/internal/fragment/nodes`` and
   ``/internal/nodes`` against ``/hosts``, the TOML's values on
   ``/debug/resultcache``, ``/debug/admission`` and
   ``/debug/containers``, three Sets answered 400, a ``slow query`` line
   in the log; ``export`` of f equal to the imported pairs; with the
   server stopped, ``check`` all ``ok``, ``inspect``'s rows and bits the
   oracle's, ``check`` of a directory a live server holds ``FAIL open``;
   and ``python -m pilosa_tpu_torch server -c FILE`` in a subprocess,
   serving on cuda, its ``[ragged] prewarm`` K3 launches counted
   (``/debug/ragged``), one Count equal to the oracle, exit 0 on SIGTERM.
   Its ``shell`` line has the import rate, the export and check times,
   the Counts' times and the launches;
12. K3 timing on the inputs of one real flush of step 7, K2 timing on
   step 5's pools, K4 on the fused TopN's inputs and K5 on one shard's
   GroupBy level-1 inputs, both recorded from step 9, K6 on a range
   Count's inputs and K1 on a filtered Sum's, both recorded from step
   11, K3-kinds on one launch of ``KINDS_TIMED_BATCH`` queries recorded
   from step 11b (CUDA events around each launch, L2 flushed before
   each), beside their plain versions and their bounds, and K3's and
   K3-kinds' host plans (median µs, tapes cold and cached); then
   K3-kinds and K3 each on a fixed launch made from the seed, whatever
   the coalescer flushed: B=4, D=4096, (L, T) = (4, 4), four of the
   rounds' tree shapes over arrays at ~0.1 %, 16 runs of 512 and bitmaps
   at 8 % (K3-kinds), or over bitmap rows at 8 % (K3); and K3 on a wide
   fixed launch, all 16 shapes over the same five rows of a 64-shard
   index (B=16, D=1024); and, for the ingest phase, K3-kinds and K3 on
   the same fixed launches with every leaf delta-fused over set and clear
   overlays made from the seed (1/64 of their containers live).

Latencies are host-clock times; each is reported as the median with its
10th and 90th percentiles and the sample count.

It prints the card, a ``residency`` line, a ``shell`` line, a
``queries`` line, a ``kernels`` line and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero and
prints no result; so does a machine where torch sees no card, or a
directory that holds this script and nothing else of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# before the port is imported: the width the index is served at
os.environ["PILOSA_TPU_SHARD_WIDTH_EXP"] = "20"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

#: Published device-memory rates (bytes/s) by card name, NVIDIA data
#: sheets; the first match wins.  Another card has no bound here.
HBM_RATES = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
#: SM cycles per 32-bit word that the kernels spend on integer work: a
#: bitwise op and an add at 64 per SM per cycle, a popcount at 16 (CUDA
#: C++ Programming Guide, "Arithmetic Instructions" throughput table,
#: compute capability 9.0).
BITWISE_CYCLES = 1 / 64
POPC_CYCLES = 1 / 16
K2_CYCLES_PER_WORD = BITWISE_CYCLES + POPC_CYCLES + BITWISE_CYCLES

FILL_SPARSE = 5243  # of 65536: rows at ~8 % fill
TIMED_LAUNCHES = 200
PLAIN_LAUNCHES = 50
#: host-clock calls of K3-kinds' tape plan, cold and cached
HOST_PLAN_CALLS = 50
K3_PLAIN_LAUNCHES = 10
WARM_RUNS = 300
ROUNDS = 60
MIXED_ROUNDS = 3
PROFILED_ROUNDS = 10
N_SHARDS = 256  # of 2^20 columns: the 268,435,456-column index
SCAN_SHARDS = 64  # shards 0-63 hold the scan path's fields s and u
SCAN_ROWS = 64  # rows of s and of u
QUERY_RUNS = 10  # warm runs of each TopN / Rows / GroupBy query
FILL_BITS = 10  # the scan fields' fills are multiples of 2^-10
SCAN_COLUMN = (7, 12345)  # Rows(s, column=...): shard 7, offset 12345
BSI_MIN, BSI_MAX, BSI_DEPTH = -1_000_000, 1_000_000, 20  # int field v
BSI_FILL = 7  # of 10 columns hold a value
BSI_NEG = 3  # of 10 values are negative
BSI_IMPORT_VALUES = 3000  # values that also go through /import-value
BSI_SET = (5, 4321, 123)  # Set(col, v=123) at shard 5, offset 4321
KINDS_ARRAY_BITS = 65  # of 65536 per container: the array rows, ~0.1 %
KIND_RUNS = 16  # runs per container in the run rows...
KIND_RUN_LEN = 512  # ...of this many columns each (12.5 % fill)
KINDS_WARM = 12  # warm runs of each kinds-leg query
KINDS_ROUNDS = 30  # coalesced rounds over kinds-mixed shapes
KINDS_TIMED_BATCH = 4  # queries in the timed K3-kinds launch
FIXED_B = 4  # queries of the fixed-shape K3 and K3-kinds launches...
FIXED_D = 4096  # ...one container per slot of a 2^20-column row x 256
FIXED_TREES = (0, 5, 9, 12)  # which of the 16 tree shapes they run
#: the wide K3 launch: all 16 tree shapes over the same five rows of a
#: 64-shard index, the widest batch ``max_prefetch`` admits there
WIDE_SHARDS = 64
INGEST_INTERVAL = 3600.0  # s: the smoke server's compactor scan period
INGEST_FLIPS = 4  # PQL Sets and as many Clears on each ingest-phase row
INGEST_IMPORT_BITS = 2000  # the ingest phase's sparse /import batch
INGEST_ROUNDS = 10  # coalesced rounds over rows with pending deltas
INGEST_WARM = 30  # warm runs of the timed ingest-phase Counts
INGEST_SETS = 30  # Set-then-Count samples
INGEST_BATCHES = 10  # timed /import batches...
INGEST_BATCH_BITS = 100_000  # ...of this many bits each
OVERLAY_LIVE = 1 / 64  # containers an overlay row of a fixed launch holds
CACHE_RUNS = 30  # timed warm hits, and ?nocache=1 misses, per query...
CACHE_GROUPBY_RUNS = 10  # ...but for the GroupBy's misses
CACHE_FLIGHT = 32  # concurrent identical cold Counts
CACHE_SHIFT = 1000  # Shift's n in the cache phase
#: domain of tests/torch_vm_cases.py's launches in the K3 check
K3_CASES_D = 128
#: the shell phase: field f rows 1 and 2 at 4 % over 64 shards x 2^20
#: columns (about 5.4 M CSV records), 10^6 int values, 10^4 time bits
SHELL_SHARDS = 64
SHELL_FILL = 0.04
SHELL_VALUES = 1_000_000
SHELL_VMIN, SHELL_VMAX = -1_000_000, 1_000_000
SHELL_TIMES = 10_000
SHELL_DAYS = 7  # t's bits fall on 2024-01-01 to -07: 10 views
SHELL_MAX_WRITES = 2  # max-writes-per-request in its TOML
SHELL_QUERY_CAP = 8  # [admission] query-cap in its TOML
SHELL_LONG_QUERY = 1e-06  # s: [cluster] long-query-time, every query
SHELL_RUNS = 5  # runs of each Count
SHELL_START_S = 300  # s the real entry point may take to report

_OPS = {"and": "Intersect", "or": "Union", "andnot": "Difference",
        "xor": "Xor"}
_COMBOS = (("and", "or"), ("and", "xor"), ("or", "and"), ("or", "andnot"),
           ("andnot", "or"), ("andnot", "xor"), ("xor", "and"),
           ("xor", "or"))


def _trees(a, b, c, d, e) -> list:
    """16 structurally distinct Count trees over five leaves, all in the
    (4, 4) tape size class (tests/test_vm.py SHAPES_16): 2-leaf and
    3-leaf folds and nested pairs."""
    return ([(op, a, b) for op in _OPS]
            + [(op, c, d, e) for op in _OPS]
            + [(o1, (o2, b, e), d) for o1, o2 in _COMBOS])


#: the coalesced phase: every leaf sparse (f and g rows 1-3)
TREES = _trees(("f", 1), ("g", 2), ("f", 2), ("g", 3), ("f", 3))
#: the mixed rounds: half the trees read f's dense row 4
MIXED = (_trees(("f", 4), ("g", 2), ("f", 2), ("g", 3), ("f", 3))[:4]
         + [(o1, (o2, ("g", 1), ("f", 4)), ("g", 2))
            for o1, o2 in _COMBOS[:4]]
         + TREES[4:12])


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- timing


def spread(xs: list[float]) -> dict:
    """Median, 10th and 90th percentiles and count of ``xs``."""
    q = statistics.quantiles(xs, n=10, method="inclusive")
    return {"median": statistics.median(xs), "p10": q[0], "p90": q[-1],
            "n": len(xs)}


def fmt(sp: dict, scale: float = 1.0, unit: str = "ms") -> str:
    return (f"median {sp['median'] * scale:.3f} {unit} (p10 "
            f"{sp['p10'] * scale:.3f}, p90 {sp['p90'] * scale:.3f}, "
            f"n {sp['n']})")


def time_ms(torch, fn, reps: int, flush) -> dict:
    """Per-launch device times of ``fn`` (ms) as ``spread``, CUDA events
    around each call.  Reading ``flush`` (larger than L2) before each
    call leaves L2 clean and cold, as a query finds it, and keeps the
    card busy while the host enqueues the call."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return spread([s.elapsed_time(e) for s, e in events])


# ------------------------------------------------------------------ phases


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_header(torch) -> dict:
    """The card: its name, power limit, memory rate, SM count and top SM
    clock."""
    line = smi("name,power.limit")
    log(line)
    kind = torch.cuda.get_device_name(0)
    hbm = next((r for name, r in HBM_RATES if name in kind), None)
    check(hbm is not None, f"no published memory rate for {kind}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}; {sms} SMs, max SM clock "
        f"{clk_mhz:.0f} MHz, memory {hbm / 1e12} TB/s")
    return {"kind": kind, "hbm_rate": hbm, "sm_cycles": sms * clk_mhz * 1e6,
            "smi": line}


KERNEL_SOURCES = ("gathered_count_and", "vm_counts", "vm_counts_kinds",
                  "row_counts_masked", "masked_matrix_counts", "bsi_compare",
                  "count_and")


def phase_build(nvcc_build) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    errs: dict = {}

    def build(name):
        try:
            nvcc_build.load(name)
        except Exception as e:  # noqa: BLE001 -- reported below
            errs[name] = e

    ts = [threading.Thread(target=build, args=(n,)) for n in KERNEL_SOURCES]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    check(not errs, f"build failed: {errs}")
    log(f"build: {', '.join(KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for ln in nvcc_build.build_logs.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")


def k2_cases(rng):
    """(label, na, nb, ai, bi) inputs of the K2 check: zero rows, indices
    past either end, P=1, a P that is not a power of two, full width."""
    cases = []
    for label, na, nb, p in (("p1", 5, 7, 1), ("p37", 9, 3, 37),
                             ("p1000", 64, 33, 1000),
                             ("full", 8192, 8192, 4096)):
        ai = rng.integers(-3, na + 3, size=p, dtype=np.int32)
        bi = rng.integers(-3, nb + 3, size=p, dtype=np.int32)
        ai[0], bi[0] = -1, nb + 5  # clamp to the first / last row
        cases.append((label, na, nb, ai, bi))
    return cases


def phase_k2_check(torch, ck, bm, dev, seed: int) -> int:
    """K2 against its plain version on the card; returns max |err|."""
    rng = np.random.default_rng(seed)
    worst = 0
    for label, na, nb, ai, bi in k2_cases(rng):
        a = rng.integers(0, 2 ** 32, size=(na, ck.CONTAINER_WORDS),
                         dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, size=(nb, ck.CONTAINER_WORDS),
                         dtype=np.uint32)
        a[na - 1] = 0          # the canonical absent-container row
        b[0] = 0xFFFFFFFF      # all ones: bit 31 in every word
        b[nb - 1] = 0
        ta, tb = bm.to_tensor(a, dev), bm.to_tensor(b, dev)
        tai, tbi = torch.from_numpy(ai).to(dev), torch.from_numpy(bi).to(dev)
        got = ck.gathered_count_and(ta, tai, tb, tbi)
        torch.cuda.synchronize()
        want = bm.gathered_pair_counts(ta, tai, tb, tbi)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K2 check {label}: pools {na}x{nb}, P={len(ai)}, "
            f"max_abs_err {err}")
        check(err == 0 and torch.equal(got, want),
              f"K2 differs from its plain version ({label})")
    return worst


def k3_case(rng, label, rows, slots, tape_len, n_q, domain, live_q=None):
    """(label, pool, prog, gidx): random SSA programs over all five
    opcodes; queries past ``live_q`` are pad rows (all COPY of slot 0 on
    the zero row), and each live query's last slot is a pad slot."""
    pool = rng.integers(0, 2 ** 32, size=(rows, 2048), dtype=np.uint32)
    zero = rows - 1
    pool[zero] = 0
    pool[0] = 0xFFFFFFFF
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = (rng.integers(5), rng.integers(slots + t),
                          rng.integers(slots + t))
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    if live_q is not None:
        prog[live_q:] = (4, 0, 0)
        gidx[:, live_q:] = zero
        gidx[slots - 1] = zero
        gidx[:, :, domain // 2:] = zero  # a padded domain tail
    return label, pool, prog, gidx


def phase_k3_check(torch, ck, bm, nvcc_build, vm_cases, dev,
                   seed: int) -> int:
    """K3 against its plain version on the card, one launch a case;
    returns max |err|.  First the source's shared-memory formula against
    the wrapper's, which sizes the query groups."""
    import ctypes

    smem = nvcc_build.load("vm_counts").vm_counts_smem_bytes
    smem.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 5
    for args in ((1, 0, 1, 1, 1), (5, 1, 4, 4, 2), (5, 0, 16, 4, 2),
                 (16, 32, 1, 32, 1), (112, 0, 7, 32, 1), (64, 32, 1, 32, 1),
                 (20, 3, 8, 8, 2)):
        check(smem(*args) == ck.vm_group_smem_bytes(*args),
              f"K3's shared memory formula differs from the source's at "
              f"{args}")
    rng = np.random.default_rng(seed + 3)
    cases = [k3_case(rng, "b1d1", 3, 1, 1, 1, 1),
             k3_case(rng, "l4t4", 64, 4, 4, 4, 64),
             k3_case(rng, "caps", 96, 16, 32, 2, 32),
             k3_case(rng, "pads", 40, 4, 4, 8, 16, live_q=5),
             k3_case(rng, "rows8192", 8192, 4, 4, 4, 4096)]
    cases += [(f"cases.{label}", pool, prog, gidx) for label, pool, prog, gidx
              in vm_cases.k3_cases(seed + 4, K3_CASES_D)]
    worst = 0
    for label, pool, prog, gidx in cases:
        tpool = bm.to_tensor(pool, dev)
        tprog, tgidx = torch.from_numpy(prog), torch.from_numpy(gidx)
        plan = ck.vm_plan(tprog, tgidx)
        before = ck.vm_counts.launches
        got = ck.vm_counts(tpool, tprog, tgidx)
        torch.cuda.synchronize()
        check(ck.vm_counts.launches == before + 1,
              f"K3 did not launch once ({label})")
        want = ck.vm_counts_plain(tpool, tprog, tgidx)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K3 check {label}: pool {pool.shape[0]} rows, B={prog.shape[0]} "
            f"T={prog.shape[1]} L={gidx.shape[0]} D={gidx.shape[2]}, "
            f"{plan.n_leaves} distinct leaves in {plan.n_groups} query "
            f"groups, {plan.vec} vectors per thread and pass, {plan.smem} "
            f"bytes of shared memory, max_abs_err {err}")
        check(err == 0 and torch.equal(got, want),
              f"K3 differs from its plain version ({label})")
    return worst


def scan_words(rng, shape) -> np.ndarray:
    """Random words, every 7th with bit 31 set."""
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    w.reshape(-1)[::7] |= np.uint32(1 << 31)
    return w


def phase_k4_check(torch, ck, bm, dev, seed: int, words: int) -> int:
    """K4 against its plain version on the card; returns max |err|.
    Edge shapes, then the scan path's: one shard's 64 rows against one
    filter row, and the fused TopN's 4096 rows against a 256-row filter
    stack through an index into its first 64 rows."""
    rng = np.random.default_rng(seed + 4)
    cases = [("r1w64", 1, 1, 64, False), ("r5w2048", 5, 1, 2048, False),
             ("r130w2100", 130, 1, 2100, False),
             ("r130w2100i", 130, 4, 2100, True),
             ("r7w2099i", 7, 3, 2099, True),
             ("shard", SCAN_ROWS, 1, words, False),
             ("fused", SCAN_SHARDS * SCAN_ROWS, N_SHARDS, words, True)]
    worst = 0
    for label, rows, n_filt, w, indexed in cases:
        mat = scan_words(rng, (rows, w))
        mat[0] = 0xFFFFFFFF
        filt = scan_words(rng, (n_filt, w))
        tmat, tfilt = bm.to_tensor(mat, dev), bm.to_tensor(filt, dev)
        tidx = None
        if indexed:
            tidx = torch.from_numpy(rng.integers(
                0, min(n_filt, SCAN_SHARDS), size=rows).astype(np.int32)
            ).to(dev)
        got = ck.row_counts_masked(tmat, tfilt, tidx)
        torch.cuda.synchronize()
        want = bm.row_counts_masked_plain(tmat, tfilt, tidx)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K4 check {label}: mat {rows}x{w}, {n_filt} filter rows, "
            f"{'indexed' if indexed else 'filter 0'}, max_abs_err {err}")
        check(err == 0 and torch.equal(got, want),
              f"K4 differs from its plain version ({label})")
    return worst


def phase_k5_check(torch, ck, bm, dev, seed: int, words: int) -> int:
    """K5 against its plain version on the card; returns max |err|.
    G in {1, 3, 9} x R in {1, 130} x W in {256, 300}, each with a zero
    mask, then the scan path's level shapes."""
    rng = np.random.default_rng(seed + 5)
    cases = [(f"g{g}r{r}w{w}", g, r, w) for g in (1, 3, 9)
             for r in (1, 130) for w in (256, 300)]
    cases += [("level0_filtered", 1, 3, words),
              ("level1_filtered", 4, SCAN_ROWS, words),
              ("level1", SCAN_ROWS, SCAN_ROWS, words)]
    worst = 0
    for label, g, r, w in cases:
        mat = bm.to_tensor(scan_words(rng, (r, w)), dev)
        masks = scan_words(rng, (g, w))
        masks[g - 1] = 0
        masks = bm.to_tensor(masks, dev)
        got = ck.masked_matrix_counts(mat, masks)
        torch.cuda.synchronize()
        want = bm.masked_matrix_counts_plain(mat, masks)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K5 check {label}: G={g} R={r} W={w}, max_abs_err {err}")
        check(err == 0 and torch.equal(got, want),
              f"K5 differs from its plain version ({label})")
    return worst


class Http:
    """A client of the smoke server.  With ``nocache`` every query carries
    ``?nocache=1``: the phases that time a kernel or count its launches
    skip the result cache, whose hit would launch nothing."""

    def __init__(self, uri: str, nocache: bool = False):
        self.uri = uri
        self.nocache = nocache

    def post(self, path: str, body: bytes,
             ctype: str = "application/json",
             headers: dict | None = None) -> tuple[int, bytes]:
        req = urllib.request.Request(self.uri + path, data=body,
                                     method="POST")
        req.add_header("Content-Type", ctype)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def query(self, pql: str, flags: str = "",
              headers: dict | None = None) -> tuple[list, float]:
        if self.nocache:
            flags += ("&" if "?" in flags else "?") + "nocache=1"
        t0 = time.perf_counter()
        st, body = self.post("/index/i/query" + flags, pql.encode(),
                             "text/plain", headers)
        ms = (time.perf_counter() - t0) * 1e3
        check(st == 200, f"{pql} -> HTTP {st}: {body[:300]!r}")
        return json.loads(body)["results"], ms


def sparse_rows(rng, n_shards: int, words: int) -> np.ndarray:
    m = np.empty((n_shards, words), dtype=np.uint32)
    for s in range(n_shards):
        bits = rng.integers(0, 1 << 16, size=words * 32,
                            dtype=np.uint16) < FILL_SPARSE
        m[s] = np.packbits(bits, bitorder="little").view(np.uint32)
    return m


def make_rows(n_shards: int, words: int, seed: int) -> dict:
    """Field -> row id -> uint32[n_shards, words]: rows 1-3 of f and g at
    ~8 % fill, row 4 of f at ~50 %."""
    rng = np.random.default_rng(seed)
    f = {r: sparse_rows(rng, n_shards, words) for r in (1, 2, 3)}
    f[4] = rng.integers(0, 2 ** 32, size=(n_shards, words), dtype=np.uint32)
    g = {r: sparse_rows(rng, n_shards, words) for r in (1, 2, 3)}
    return {"f": f, "g": g}


def roaring_payload(roaring, rows: dict, shard: int, cpr: int) -> bytes:
    """One shard's rows as a roaring bitmap in fragment position space
    (container key = row * containers_per_row + slot)."""
    keys, blocks = [], []
    for r in sorted(rows):
        keys.append(r * cpr + np.arange(cpr, dtype=np.uint64))
        blocks.append(rows[r][shard].view(np.uint64).reshape(
            cpr, roaring.WORDS_PER_CONTAINER))
    return roaring.encode(np.concatenate(keys), np.concatenate(blocks))


def ingest_doc(http: Http) -> dict:
    """GET /debug/ingest."""
    with urllib.request.urlopen(http.uri + "/debug/ingest",
                                timeout=600) as resp:
        return json.loads(resp.read())


def compact_all() -> dict:
    """One compactor scan that merges every pending delta, as the
    server's compactor does at its next interval (forced here: the smoke
    server's interval is an hour, so that nothing merges mid-phase).
    Returns the compactor's totals before and after."""
    from pilosa_tpu_torch.ingest import compactor

    c = compactor.compactor()
    before = c.totals()
    t0 = time.perf_counter()
    n = c.run_once(force=True)
    after = c.totals()
    check(after["fragmentsPending"] == 0, f"deltas still pending: {after}")
    return {"fragments": n, "bits": after["compactedBits"]
            - before["compactedBits"], "ms": (time.perf_counter() - t0) * 1e3,
            "before": before}


def import_field(http: Http, roaring, field: str, rows: dict, n_shards: int,
                 cpr: int) -> None:
    """One roaring payload per shard.  With [ingest] deltas on, a payload
    of at most 2^22 bits lands in the fragment's delta plane (every one
    here does); past ``max_op_n`` WAL operations the fragment writes its
    snapshot, which merges the delta first (the reference queues that
    snapshot in the background), and past the 64 MiB pending budget a
    writer merges its own fragment inline.  A compactor scan then merges
    whatever is left, so that the phases that follow read base rows, as
    they would once the server's compactor had run."""
    check(http.post(f"/index/i/field/{field}", b"{}")[0] == 200,
          f"create field {field}")
    t0 = time.perf_counter()
    sent = 0
    for s in range(n_shards):
        blob = roaring_payload(roaring, rows, s, cpr)
        sent += len(blob)
        st, body = http.post(f"/index/i/field/{field}/import-roaring/{s}",
                             blob, "application/octet-stream")
        check(st == 200, f"import-roaring {field} shard {s}: HTTP {st} "
                         f"{body!r}")
    t1 = time.perf_counter()
    merged = compact_all()
    before = merged["before"]
    log(f"import: field {field}, {n_shards} roaring payloads, {sent} bytes, "
        f"in {t1 - t0:.1f} s; {before['fragmentsPending']} fragments "
        f"pending ({before['pendingBits']} bits, {before['inlineFlushes']} "
        f"inline flushes so far), merged by one compactor scan in "
        f"{merged['ms']:.0f} ms")


def tree_pql(tree) -> str:
    if isinstance(tree[0], str) and tree[0] in _OPS:
        return f"{_OPS[tree[0]]}({', '.join(tree_pql(c) for c in tree[1:])})"
    return f"Row({tree[0]}={tree[1]})"


def tree_words(tree, data: dict) -> np.ndarray:
    if tree[0] not in _OPS:
        return data[tree[0]][tree[1]]
    acc = tree_words(tree[1], data)
    for c in tree[2:]:
        w = tree_words(c, data)
        acc = {"and": acc & w, "or": acc | w, "xor": acc ^ w,
               "andnot": acc & ~w}[tree[0]]
    return acc


def oracle(tree, data: dict) -> int:
    return int(np.bitwise_count(tree_words(tree, data)).sum(dtype=np.int64))


def phase_k2_path(torch, ck, bm, containers, srv, http: Http, data: dict
                  ) -> dict:
    """The Count routes of the K2 slice, each request with
    ``?nocoalesce=true``; returns the measurements and, in ``probe``, the
    K2 inputs of this path."""
    from pilosa_tpu_torch.pql import parse

    rows = data["f"]
    queries = [
        ("intersect_k2", ("and", ("f", 1), ("f", 2)), "k2"),
        ("union3_gathered", ("or", ("f", 1), ("f", 2), ("f", 3)),
         "gathered"),
        ("difference_gathered", ("andnot", ("f", 1), ("f", 3)), "gathered"),
        ("intersect_dense", ("and", ("f", 1), ("f", 4)), "dense"),
    ]
    out: dict = {"queries": {}}
    nocoal = "?nocoalesce=true"

    def run(label, tree, route, flags=nocoal, runs=1 + WARM_RUNS):
        """The query once cold, then ``runs - 1`` times warm."""
        pql = f"Count({tree_pql(tree)})"
        want = oracle(tree, data)
        k0 = ck.launch_counts()
        c0 = containers.counters()
        lat = []
        for _ in range(runs):
            res, ms = http.query(pql, flags)
            lat.append(ms)
            check(res == [want], f"{pql}: got {res}, oracle {want}")
        k1 = ck.launch_counts()
        k = k1["gathered_count_and"] - k0["gathered_count_and"]
        check(k1["vm_counts"] == k0["vm_counts"],
              f"{pql}: K3 launched under ?nocoalesce=true")
        c1 = containers.counters()
        served = c1["container.queries"] - c0["container.queries"]
        if route == "k2":
            check(k == len(lat), f"{pql}: K2 launched {k} times")
        else:
            check(k == 0, f"{pql}: K2 launched on the {route} route")
        if route == "dense":
            check(served == 0, f"{pql}: served compressed")
        else:
            check(served == len(lat), f"{pql}: {served} compressed")
        out["queries"][label] = {
            "pql": pql, "flags": flags, "count": want, "route": route,
            "first_ms": lat[0]}
        if runs > 1:
            out["queries"][label]["warm_ms"] = spread(lat[1:])
        log(f"{label}: {pql}{flags} = {want} ({route}); first "
            f"{lat[0]:.2f} ms" + (f", warm over HTTP {fmt(spread(lat[1:]))}"
                                  if runs > 1 else ""))

    # ---- the K2 path: counts zeroed just before, read just after
    ck.reset_launch_counts()
    for q in queries:
        run(*q)
    pql0 = out["queries"]["intersect_k2"]["pql"]
    want0 = out["queries"]["intersect_k2"]["count"]
    # the same Count through the API in this thread, under the
    # thread-local launch log
    with bm.dispatch_counter() as dc:
        res = srv.api.query("i", pql0, coalesce=False, cache=False)
    check(res == [want0], f"API {pql0} -> {res}")
    check(dc.launches == ["gathered_count_and"],
          f"API Count(Intersect) launches {dc.launches}")
    # the same, timed without HTTP: what the server adds on top
    api_lat = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        res = srv.api.query("i", pql0, coalesce=False, cache=False)
        api_lat.append((time.perf_counter() - t0) * 1e3)
        check(res == [want0], f"API {pql0} -> {res}")
    api = out["queries"]["intersect_k2"]["api_ms"] = spread(api_lat)
    log(f"intersect_k2 through the API in the server's process: {fmt(api)}")
    # a write, then the recount sees it: the Set lands in the fragment's
    # delta plane, so the container engine declines the row and the
    # recount fuses the overlay densely (dfuse, no kernel); ?nodelta=1
    # merges the delta first and the recount is K2's again
    cand = rows[2] & ~rows[1]
    flat = np.flatnonzero(cand.reshape(-1))
    check(len(flat) > 0, "no column to set")
    w = int(flat[0])
    bit = int(np.flatnonzero(np.unpackbits(
        cand.reshape(-1)[w:w + 1].view(np.uint8), bitorder="little"))[0])
    col = w * 32 + bit  # row-major over shards: shard * width + off
    res, _ms = http.query(f"Set({col}, f=1)")
    check(res == [True], f"Set({col}, f=1) -> {res}")
    rows[1].reshape(-1)[w] |= np.uint32(1) << np.uint32(bit)
    run("intersect_dfuse_after_set", queries[0][1], "dense")
    check(out["queries"]["intersect_dfuse_after_set"]["count"] == want0 + 1,
          "the recount did not see the Set")
    run("intersect_k2_nodelta", queries[0][1], "k2",
        "?nodelta=1&nocoalesce=true", runs=1)
    check(not srv.holder.index("i").field("f").view("standard")
          .delta_stats(), "?nodelta=1 left field f's delta pending")
    run("intersect_k2_after_compaction", *queries[0][1:])
    out["launches"] = ck.launch_counts()
    # ---- end of the K2 path
    log(f"K2 path launches: {out['launches']}")
    check(out["launches"]["gathered_count_and"] > 0,
          "K2 was not launched on its path")
    check(out["launches"]["vm_counts"] == 0, "K3 was launched on K2's path")

    # K2's own inputs on this path, for the timing phase
    idx = srv.holder.index("i")
    shards = tuple(sorted(idx.available_shards()))
    plan = containers.plan_fused(
        idx, parse("Intersect(Row(f=1), Row(f=2))").calls[0], shards)
    check(plan is not None, "Count(Intersect) did not plan compressed")
    dev_idxs = plan._stage()[4]
    out["probe"] = (plan.leaves[0].pool, dev_idxs[0],
                    plan.leaves[1].pool, dev_idxs[1])
    return out


def phase_lone(ck, tape, http: Http, data: dict) -> dict:
    """The warm Count(Intersect) without the flag: each lone request
    waits out the window, then runs as one K3 launch."""
    tree = ("and", ("f", 1), ("f", 2))
    pql = f"Count({tree_pql(tree)})"
    want = oracle(tree, data)
    http.query(pql)  # stage the VM directory once
    ck.reset_launch_counts()
    tape.reset_counters()
    lat = []
    for _ in range(WARM_RUNS):
        res, ms = http.query(pql)
        lat.append(ms)
        check(res == [want], f"{pql}: got {res}, oracle {want}")
    k = ck.launch_counts()
    vm = tape.counters()
    check(k["vm_counts"] == WARM_RUNS == vm["vm.executions"],
          f"lone queries: K3 {k['vm_counts']}, vm.executions "
          f"{vm['vm.executions']}, requests {WARM_RUNS}")
    check(k["gathered_count_and"] == 0, "K2 launched under the coalescer")
    warm = spread(lat)
    log(f"intersect_coalesced_lone: {pql} = {want} (K3, lone under the "
        f"coalescer); warm over HTTP {fmt(warm)}")
    return {"pql": pql, "count": want, "route": "k3_lone", "warm_ms": warm,
            "launches": k["vm_counts"]}


def fire_rounds(http: Http, trees: list, wants: list, rounds: int,
                headers: dict | None = None) -> tuple[list, float]:
    """``rounds`` rounds of every tree, one barrier-started client thread
    per tree, each request with ``headers``; (per-request latencies in
    ms, wall seconds)."""
    n = len(trees)
    pqls = [f"Count({tree_pql(t)})" for t in trees]
    bar = threading.Barrier(n)
    lat: list = [[] for _ in range(n)]
    errs: list = []

    def client(i):
        try:
            for _ in range(rounds):
                bar.wait(timeout=600)
                res, ms = http.query(pqls[i], headers=headers)
                lat[i].append(ms)
                check(res == [wants[i]],
                      f"{pqls[i]}: got {res}, oracle {wants[i]}")
        except Exception as e:  # noqa: BLE001 -- reported below
            errs.append(f"{type(e).__name__}: {e}")
            bar.abort()

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "a client thread hung")
    check(not errs, f"coalesced round failed: {errs[:3]}")
    return [x for xs in lat for x in xs], wall


@contextlib.contextmanager
def megapool_log(containers):
    """The leaf sets of the VM flushes inside the block (leaf uids) and
    the number of megapools built for them: the memo's misses, each a
    copy of the set's leaf pools on the card."""
    seen: dict = {"sets": [], "builds": 0}
    real_mp, real_build = containers.megapool, containers._megapool_plain

    def mp(leaves):
        seen["sets"].append(frozenset(leaf.uid for leaf in leaves))
        return real_mp(leaves)

    def build(order):
        seen["builds"] += len(order) > 1  # one leaf is served uncopied
        return real_build(order)

    containers.megapool, containers._megapool_plain = mp, build
    try:
        yield seen
    finally:
        containers.megapool = real_mp
        containers._megapool_plain = real_build


def profile_rounds(http: Http, wants: list) -> dict:
    """The card's busy share over ``PROFILED_ROUNDS`` coalesced rounds:
    device time that torch.profiler's CUDA activity records, over the
    rounds' wall time, and the device time by kernel.  Fails where the
    profiler records no device time."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _lat, wall = fire_rounds(http, TREES, wants, PROFILED_ROUNDS)
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0:
            by_kernel[ev.key] = t / 1e3  # us -> ms
    busy = sum(by_kernel.values())
    check(busy > 0, "the profiler recorded no device time over the "
                    "coalesced rounds")
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
    out = {"rounds": PROFILED_ROUNDS, "wall_ms": wall * 1e3,
           "device_ms": busy, "busy_share": busy / (wall * 1e3),
           "device_ms_by_kernel": top}
    log(f"profiler: {PROFILED_ROUNDS} coalesced rounds in "
        f"{wall * 1e3:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * out['busy_share']:.2f} %); by kernel (ms): {top}")
    return out


def phase_coalesced(ck, tape, containers, http: Http, roaring, data: dict,
                    cpr: int, srv_max_prefetch: int) -> dict:
    """16 distinct sparse trees from 16 concurrent clients, then rounds
    mixed with the dense row; returns the measurements and, in
    ``flush``, one VM flush's inputs."""
    import_field(http, roaring, "g", data["g"], N_SHARDS, cpr)
    wants = [oracle(t, data) for t in TREES]
    for t, w in zip(TREES, wants):  # stage every leaf and directory once
        res, _ms = http.query(f"Count({tree_pql(t)})")
        check(res == [w], f"{tree_pql(t)}: got {res}, oracle {w}")
    fire_rounds(http, TREES, wants, 1)

    # ---- the coalesced path: counts zeroed just before, read just after
    with megapool_log(containers) as mega:
        ck.reset_launch_counts()
        tape.reset_counters()
        lat, wall = fire_rounds(http, TREES, wants, ROUNDS)
        k = ck.launch_counts()
        vm = tape.counters()
    # ---- end of the coalesced path
    n_q = len(TREES) * ROUNDS
    check(vm["vm.queries"] == n_q, f"vm.queries {vm['vm.queries']} of {n_q}")
    check(vm["vm.fallbacks"] == 0, f"vm.fallbacks {vm['vm.fallbacks']}")
    check(vm["vm.executions"] > 0, "the VM never ran")
    check(k["vm_counts"] == vm["vm.executions"],
          f"K3 launched {k['vm_counts']} times for "
          f"{vm['vm.executions']} VM executions")
    check(k["gathered_count_and"] == 0, "K2 launched on the coalesced path")
    sp = spread(lat)
    out = {"queries": n_q, "rounds": ROUNDS, "vm_executions":
           vm["vm.executions"], "k3_launches": k["vm_counts"],
           "queries_per_launch": n_q / vm["vm.executions"],
           "latency_ms": sp, "qps": n_q / wall,
           "programs": tape.debug()["vm"]["programs"],
           "vm_flushes": len(mega["sets"]),
           "leaf_sets": len(set(mega["sets"])),
           "megapool_builds": mega["builds"]}
    log(f"coalesced: {len(TREES)} distinct trees x {ROUNDS} rounds from "
        f"{len(TREES)} clients, every answer exact; vm.executions "
        f"{vm['vm.executions']}, K3 launches {k['vm_counts']}, "
        f"{out['queries_per_launch']:.2f} queries per launch, "
        f"vm.fallbacks 0; per request {fmt(sp)}; {out['qps']:.1f} queries/s")
    log(f"  {out['vm_flushes']} VM flushes over {out['leaf_sets']} distinct "
        f"leaf sets; {out['megapool_builds']} megapools built (memo misses)")
    widest = max(p["batch"] for p in out["programs"])
    log(f"  VM program variants: {out['programs']}; the widest launch holds "
        f"{widest} queries (max_prefetch {srv_max_prefetch} over "
        f"{out['programs'][0]['slots']} slots x domain "
        f"{out['programs'][0]['domain']})")

    out["device"] = profile_rounds(http, wants)

    # one more round, recording each VM flush's inputs for the timing
    flushes: list = []
    real = tape.execute_vm

    def recording(batch, pool, zero_index, tape_len=None, slots=None,
                  max_prefetch=None):
        flushes.append((list(batch), pool, zero_index, tape_len, slots,
                        max_prefetch))
        return real(batch, pool, zero_index, tape_len, slots, max_prefetch)

    tape.execute_vm = recording
    try:
        fire_rounds(http, TREES, wants, 1)
    finally:
        tape.execute_vm = real
    # the calls that launched (the halving stops where a batch fits);
    # the largest of them is timed
    launched = [(batch, pool, zero, tb, lb)
                for batch, pool, zero, tb, lb, mp in flushes
                if len(batch) == 1 or lb * (1 << (len(batch) - 1)
                                            .bit_length())
                * len(batch[0][1][0]) <= mp]
    if launched:
        out["flush"] = max(launched, key=lambda f: len(f[0]))

    # rounds mixed with the dense row 4: the VM declines those trees
    mwants = [oracle(t, data) for t in MIXED]
    for t, w in zip(MIXED, mwants):  # build the dense stacks once
        res, _ms = http.query(f"Count({tree_pql(t)})", "?nocoalesce=true")
        check(res == [w], f"{tree_pql(t)}: got {res}, oracle {w}")
    tape.reset_counters()
    fire_rounds(http, MIXED, mwants, MIXED_ROUNDS)
    mvm = tape.counters()
    check(mvm["vm.fallbacks.ineligible_leaf"] > 0,
          "the VM declined no dense leaf")
    check(mvm["tape.executions"] > 0, "the dense tape route never ran")
    out["mixed"] = {"rounds": MIXED_ROUNDS, "queries": len(MIXED) *
                    MIXED_ROUNDS, "counters": {
                        k: v for k, v in mvm.items() if v}}
    log(f"mixed: {len(MIXED)} trees (8 read dense row 4) x {MIXED_ROUNDS} "
        f"rounds, every answer exact; counters {out['mixed']['counters']}")
    return out


def graded_rows(rng, n_rows: int, n_shards: int, words: int) -> dict:
    """Row id -> uint32[n_shards, words] at fills k / 2^FILL_BITS, k
    spread from 5 (0.49 %) to 128 (12.5 %), a different k for every row,
    in a shuffled order.  A word of fill k / 2^B combines fresh random
    words, k's binary digits from the least significant up: a 1 ORs one
    in, a 0 ANDs one in."""
    ks = np.round(np.linspace(5, 128, n_rows)).astype(np.int64)
    rows = {}
    for r, k in enumerate(rng.permutation(ks)):
        x = None
        for b in range(FILL_BITS):
            bit = (int(k) >> b) & 1
            if x is None:
                if bit:
                    x = rng.integers(0, 2 ** 32, size=(n_shards, words),
                                     dtype=np.uint32)
                continue
            w = rng.integers(0, 2 ** 32, size=(n_shards, words),
                             dtype=np.uint32)
            (np.bitwise_or if bit else np.bitwise_and)(x, w, out=x)
        rows[r] = x
    return rows


def popcounts(m: np.ndarray) -> int:
    return int(np.bitwise_count(m).sum(dtype=np.int64))


def pair_counts(a: dict, b: dict) -> np.ndarray:
    """counts[i, j] = |a[i] & b[j]| over all shards, int64, in threads
    (numpy's ufuncs release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    bs = np.stack([b[j].view(np.uint64) for j in sorted(b)])

    def row(i):
        return np.bitwise_count(a[i].view(np.uint64)[None] & bs).sum(
            axis=(1, 2), dtype=np.int64)

    with ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack(list(pool.map(row, sorted(a))))


def topn_json(counts: dict, n: int) -> list:
    order = sorted(((c, r) for r, c in counts.items() if c > 0),
                   key=lambda cr: (-cr[0], cr[1]))
    return [{"count": c, "id": r} for c, r in order[:n]]


def groups_json(fa: str, fb: str, counts: dict) -> list:
    """GroupBy's JSON for two levels from {(row_a, row_b): count}."""
    return [{"group": [{"field": fa, "rowID": a}, {"field": fb, "rowID": b}],
             "count": c} for (a, b), c in sorted(counts.items()) if c > 0]


def scan_oracles(data: dict) -> dict:
    """The numpy answers of the scan path's queries."""
    t0 = time.perf_counter()
    s, u = data["s"], data["u"]
    f1 = data["f"][1][:SCAN_SHARDS]
    g = {r: m[:SCAN_SHARDS] for r, m in data["g"].items()}
    su = pair_counts(s, u)
    gs = {(gr, sr): popcounts(f1 & g[gr] & s[sr]) for gr in g for sr in s}
    shard, off = SCAN_COLUMN
    w, b = divmod(off, 32)
    su_json = groups_json("s", "u", {(i, j): int(su[i, j])
                                     for i in s for j in u})
    out = {
        "topn": topn_json({r: popcounts(m) for r, m in s.items()}, 10),
        "topn_filtered": topn_json({r: popcounts(m & f1)
                                    for r, m in s.items()}, 10),
        "topn_filtered_shard5": topn_json(
            {r: popcounts(m[5] & f1[5]) for r, m in s.items()}, 10),
        "rows": sorted(r for r, m in s.items() if m.any()),
        "rows_limit_previous": [r for r in sorted(s) if r > 20][:10],
        "rows_column": sorted(r for r, m in s.items()
                              if (int(m[shard, w]) >> b) & 1),
        "groupby": su_json,
        "groupby_filtered": groups_json("g", "s", gs),
        "groupby_limit": su_json[:10],
    }
    log(f"scan oracles in {time.perf_counter() - t0:.1f} s")
    return out


def scan_queries(width: int) -> tuple:
    """(label, PQL, URL flags, K4 launches per run, K5 launches per
    run) of the scan path."""
    column = SCAN_COLUMN[0] * width + SCAN_COLUMN[1]
    return (
        ("topn", "TopN(s, n=10)", "", 0, 0),
        ("topn_filtered", "TopN(s, Row(f=1), n=10)", "", 1, 0),
        ("topn_filtered_shard5", "TopN(s, Row(f=1), n=10)", "?shards=5", 1,
         0),
        ("rows", "Rows(s)", "", 0, 0),
        ("rows_limit_previous", "Rows(s, limit=10, previous=20)", "", 0, 0),
        ("rows_column", f"Rows(s, column={column})", "", 0, 0),
        # one K5 per shard that holds s and u (level 2 of 2)
        ("groupby", "GroupBy(Rows(s), Rows(u))", "", 0, SCAN_SHARDS),
        # two per shard that holds s (the filter masks both levels)
        ("groupby_filtered", "GroupBy(Rows(g), Rows(s), filter=Row(f=1))",
         "", 0, 2 * SCAN_SHARDS),
        ("groupby_limit", "GroupBy(Rows(s), Rows(u), limit=10)", "", 0,
         SCAN_SHARDS),
    )


def phase_scans(ck, bm, http: Http, roaring, data: dict, cpr: int,
                words: int, seed: int) -> dict:
    """TopN, Rows and GroupBy over fields s and u (shards 0-63), each
    query once cold and QUERY_RUNS times warm, every answer equal to the
    oracle and K4 / K5 launched exactly at their launch sites; returns
    the measurements and, in ``probes``, K4's and K5's inputs recorded
    from one more run of the fused TopN and of the GroupBy."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 7)
    data["s"] = graded_rows(rng, SCAN_ROWS, SCAN_SHARDS, words)
    data["u"] = graded_rows(rng, SCAN_ROWS, SCAN_SHARDS, words)
    fills = sorted(popcounts(m) / m.size / 32 for m in data["s"].values())
    log(f"scan data: s and u, {SCAN_ROWS} rows each on {SCAN_SHARDS} "
        f"shards, fills {fills[0]:.4f}-{fills[-1]:.4f}, made in "
        f"{time.perf_counter() - t0:.1f} s")
    for field in ("s", "u"):
        import_field(http, roaring, field, data[field], SCAN_SHARDS, cpr)
    wants = scan_oracles(data)

    out: dict = {"queries": {}}
    # ---- the scan path: counts zeroed just before, read just after
    ck.reset_launch_counts()
    for label, pql, flags, k4_per_run, k5_per_run in scan_queries(
            words * 32):
        k0 = ck.launch_counts()
        lat = []
        for _ in range(1 + QUERY_RUNS):
            res, ms = http.query(pql, flags)
            lat.append(ms)
            check(res == [wants[label]], f"{pql}{flags}: differs from the "
                                         f"oracle: {str(res)[:300]}")
        k1 = ck.launch_counts()
        k4 = k1["row_counts_masked"] - k0["row_counts_masked"]
        k5 = k1["masked_matrix_counts"] - k0["masked_matrix_counts"]
        check(k4 == k4_per_run * len(lat),
              f"{pql}{flags}: K4 launched {k4} times in {len(lat)} runs")
        check(k5 == k5_per_run * len(lat),
              f"{pql}{flags}: K5 launched {k5} times in {len(lat)} runs")
        warm = spread(lat[1:])
        out["queries"][label] = {"pql": pql + flags, "first_ms": lat[0],
                                 "warm_ms": warm, "k4": k4, "k5": k5}
        log(f"{label}: {pql}{flags} = oracle; K4 {k4}, K5 {k5} launches; "
            f"first {lat[0]:.2f} ms, warm over HTTP {fmt(warm)}")
    out["launches"] = ck.launch_counts()
    # ---- end of the scan path
    log(f"scan path launches: {out['launches']}")
    check(out["launches"]["gathered_count_and"] == 0
          and out["launches"]["vm_counts"] == 0,
          "K2 or K3 launched on the scan path")

    # K4's and K5's inputs on this path, for the timing phase
    probes: dict = {}
    real_k4, real_k5 = bm.row_counts_gathered, bm.masked_matrix_counts

    def k4(mat, filt_stack, shard_pos):
        probes.setdefault("k4", (mat, filt_stack, shard_pos))
        return real_k4(mat, filt_stack, shard_pos)

    def k5(mat, masks):  # level 2 of GroupBy(s, u), on its first shard
        probes.setdefault("k5", (mat, masks))
        return real_k5(mat, masks)

    bm.row_counts_gathered, bm.masked_matrix_counts = k4, k5
    try:
        http.query("TopN(s, Row(f=1), n=10)")
        http.query("GroupBy(Rows(s), Rows(u))")
    finally:
        bm.row_counts_gathered, bm.masked_matrix_counts = real_k4, real_k5
    check(set(probes) == {"k4", "k5"}, f"recorded only {sorted(probes)}")
    check(probes["k4"][2] is not None
          and probes["k4"][0].shape[0] == SCAN_SHARDS * SCAN_ROWS,
          "the fused TopN did not scan the whole matrix stack")
    out["probes"] = probes
    return out


def phase_k4_time(torch, ck, bm, probe, card: dict) -> dict:
    """K4 on the fused TopN's own inputs: the field's matrix stack, the
    filter's stack over all shards and the rows' shard positions."""
    mat, filt, idx = probe
    got = ck.row_counts_masked(mat, filt, idx)
    want = bm.row_counts_masked_plain(mat, filt, idx)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, "K4 differs from its plain version on the fused TopN's "
                    "inputs")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=mat.device)
    k4 = time_ms(torch, lambda: ck._row_counts_launch(mat, filt, idx),
                 TIMED_LAUNCHES, flush)
    plain = time_ms(torch, lambda: bm.row_counts_masked_plain(mat, filt, idx),
                    PLAIN_LAUNCHES, flush)
    rows, words = mat.shape
    # bytes: the matrix once, each filter row the index names once, the
    # index and the counts
    filt_rows = int(torch.unique(idx).numel())
    nbytes = mat.numel() * 4 + filt_rows * words * 4 + 2 * rows * 4
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    ops_ms = rows * words * K2_CYCLES_PER_WORD / card["sm_cycles"] * 1e3
    ms = k4["median"]
    log(f"K4 timing: {rows} rows x {words} words against {filt_rows} of "
        f"{filt.shape[0]} filter rows, {nbytes} bytes; kernel "
        f"{fmt(k4, 1e3, 'us')} ({nbytes / ms / 1e6:.1f} GB/s at the "
        f"median), plain {fmt(plain, 1e3, 'us')}, bound "
        f"{bytes_ms * 1e3:.2f} us by bytes, {ops_ms * 1e3:.2f} us by "
        f"operations")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k4.items()}}


def phase_k5_time(torch, ck, bm, probe, card: dict) -> dict:
    """K5 on one shard's GroupBy level-1 inputs: u's row matrix against
    the masks of s's rows."""
    mat, masks = probe
    got = ck.masked_matrix_counts(mat, masks)
    want = bm.masked_matrix_counts_plain(mat, masks)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, "K5 differs from its plain version on GroupBy's inputs")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=mat.device)
    k5 = time_ms(torch, lambda: ck._mmc_launch(mat, masks), TIMED_LAUNCHES,
                 flush)
    plain = time_ms(torch, lambda: bm.masked_matrix_counts_plain(mat, masks),
                    PLAIN_LAUNCHES, flush)
    rows, words = mat.shape
    groups = masks.shape[0]
    nbytes = (rows + groups) * words * 4 + groups * rows * 4
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    # an AND, a popcount and an add for each of the G * R * W word pairs
    ops_ms = (groups * rows * words * K2_CYCLES_PER_WORD / card["sm_cycles"]
              * 1e3)
    ms = k5["median"]
    log(f"K5 timing: G={groups} R={rows} W={words}, {nbytes} bytes, "
        f"{groups * rows * words} word pairs; kernel {fmt(k5, 1e3, 'us')}, "
        f"plain {fmt(plain, 1e3, 'us')}, bound {bytes_ms * 1e3:.2f} us by "
        f"bytes, {ops_ms * 1e3:.2f} us by operations")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k5.items()}}


def host_plan_us(plan_fn, caches) -> dict:
    """Median host-clock µs of ``plan_fn()`` over ``HOST_PLAN_CALLS``
    calls with the tape caches ``caches`` cleared before each call (tapes
    not seen before) and kept (seen before)."""
    out = {}
    for name, clear in (("cold", True), ("cached", False)):
        ts = []
        for _ in range(HOST_PLAN_CALLS):
            if clear:
                for c in caches:
                    c.cache_clear()
            t0 = time.perf_counter()
            plan_fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        out[name] = float(np.median(ts))
    return out


def k3_timing(torch, ck, label: str, live: int, pool, prog_np, gidx_np,
              zero: int, card: dict) -> dict:
    """K3 on one launch's inputs (``live`` real queries), against its
    plain version and its bound, with its host plan timed alone."""
    prog = torch.from_numpy(prog_np).to(pool.device)
    gidx = torch.from_numpy(gidx_np).to(pool.device)
    got = ck.vm_counts(pool, prog, gidx)
    want = ck.vm_counts_plain(pool, prog, gidx)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, f"K3 differs from its plain version on {label}")
    prog_cpu, gidx_cpu = torch.from_numpy(prog_np), torch.from_numpy(gidx_np)
    plan_us = host_plan_us(lambda: ck.vm_plan(prog_cpu, gidx_cpu),
                           (ck._plan_row, ck._query_plan))
    plan = ck.vm_plan(prog_cpu, gidx_cpu)
    plan_dev = plan._replace(meta=plan.meta.to(pool.device))
    flush_buf = torch.zeros(64 << 20, dtype=torch.int32, device=pool.device)
    k3 = time_ms(torch, lambda: ck._vm_launch(pool, gidx, plan_dev),
                 TIMED_LAUNCHES, flush_buf)
    plain = time_ms(torch, lambda: ck.vm_counts_plain(pool, prog, gidx),
                    K3_PLAIN_LAUNCHES, flush_buf)
    n_q, tape_len, _ = prog_np.shape
    slots, _, domain = gidx_np.shape
    # bytes: each pool row the directory names, read once (queries of a
    # launch that read the same leaf name the same rows, and every pad
    # entry names the zero row), the program, the directory and the counts
    real_entries = int((gidx_np != zero).sum())
    rows_read = int(np.unique(gidx_np).size)
    nbytes = (rows_read * ck.CONTAINER_WORDS * 4 + prog_np.nbytes
              + gidx_np.nbytes + n_q * domain * 4)
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    # what the kernel reads: each group's distinct leaves once per domain
    # slot (an absent container of a leaf is a read of the zero row)
    design_bytes = plan.n_leaves * domain * ck.CONTAINER_WORDS * 4
    # operations: for each cell word of the live queries, one bitwise op
    # per instruction the result reaches (COPYs and dead code do no
    # bitwise work), a popcount and an add; beside it the first design's
    # count, every tape slot a bitwise op
    meta = plan.meta.numpy()
    live_ops = meta[:live * (2 + tape_len + slots):2 + tape_len + slots
                    ].tolist()
    word_cells = domain * ck.CONTAINER_WORDS
    ops_ms = sum(word_cells * (n * BITWISE_CYCLES + POPC_CYCLES
                               + BITWISE_CYCLES) for n in live_ops
                 ) / card["sm_cycles"] * 1e3
    all_slots_ops_ms = (live * word_cells
                        * (tape_len * BITWISE_CYCLES + POPC_CYCLES
                           + BITWISE_CYCLES)) / card["sm_cycles"] * 1e3
    ms = k3["median"]
    bound = max(bytes_ms, ops_ms)
    all_slots_bound = max(bytes_ms, all_slots_ops_ms)
    log(f"K3 timing, {label}: {live} queries, B={n_q} T={tape_len} "
        f"L={slots} D={domain}, live instructions {live_ops}, pool "
        f"{pool.shape[0]} rows, {real_entries} gathered containers over "
        f"{rows_read} distinct rows ({nbytes} bytes); the plan: "
        f"{plan.n_leaves} distinct leaves in {plan.n_groups} query groups, "
        f"{design_bytes} bytes of containers read "
        f"({design_bytes / ms / 1e6:.1f} GB/s at the median), {plan.vec} "
        f"vectors per thread and pass, {plan.smem} bytes of shared memory; "
        f"host plan (median of "
        f"{HOST_PLAN_CALLS}) {plan_us['cold']:.1f} us cold, "
        f"{plan_us['cached']:.1f} us cached; kernel {fmt(k3, 1e3, 'us')}, "
        f"plain {fmt(plain, 1e3, 'us')}; bound {bytes_ms * 1e3:.2f} us by "
        f"bytes, {ops_ms * 1e3:.2f} us by operations over live "
        f"instructions ({all_slots_ops_ms * 1e3:.2f} us with every tape "
        f"slot a bitwise op); {100 * bound / ms:.1f} % of the bound "
        f"({100 * all_slots_bound / ms:.1f} % of the all-slots bound)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "all_slots_bound_ms": all_slots_bound, "host_plan_us": plan_us,
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k3.items()},
            "shape": {"B": n_q, "live": live, "T": tape_len, "L": slots,
                      "D": domain, "pool_rows": int(pool.shape[0]),
                      "gathered": real_entries, "distinct_rows": rows_read,
                      "live_ops": live_ops, "leaves": plan.n_leaves,
                      "groups": plan.n_groups, "vec": plan.vec,
                      "read_bytes": design_bytes}}


def phase_k3_time(torch, ck, tape, flush, card: dict) -> dict:
    """K3 on the inputs of one real flush of the coalesced path."""
    batch, pool, zero, tb, lb = flush
    prog_np, gidx_np = tape.vm_program(batch, zero, tb, lb)
    return k3_timing(torch, ck, "one flush of the coalesced path",
                     len(batch), pool, prog_np, gidx_np, zero, card)


def tree_shape(tree, leaves: list):
    """An ops/expr shape of ``tree`` for tape.compile_shape; ``leaves``
    collects the leaves in slot order."""
    if tree[0] in _OPS:
        return (tree[0],) + tuple(tree_shape(c, leaves) for c in tree[1:])
    leaves.append(tree)
    return ("leaf", len(leaves) - 1)


def dfuse_shape(tree, leaves: list):
    """``tree_shape`` with every leaf delta-fused, as the VM stages a row
    with a pending ingest delta: ``("dfuse", base, set, clear)``, the
    leaves ``leaf``, ``("set", leaf)`` and ``("clear", leaf)``."""
    if tree[0] in _OPS:
        return (tree[0],) + tuple(dfuse_shape(c, leaves) for c in tree[1:])
    i = len(leaves)
    leaves += [tree, ("set", tree), ("clear", tree)]
    return ("dfuse", ("leaf", i), ("leaf", i + 1), ("leaf", i + 2))


def fixed_program(tape, trees, rows_of, delta: bool = False) -> list:
    """The VM batch of ``trees`` for tape.vm_program: each tree's tape and
    its leaves' directory entries, leaf ``(f, r)`` gathering the global
    rows ``rows_of[(f, r)]`` int32[D]; with ``delta`` every leaf
    delta-fused over ``rows_of[("set", leaf)]`` and ``("clear", leaf)``."""
    batch = []
    for tree in trees:
        leaves: list = []
        shape = (dfuse_shape if delta else tree_shape)(tree, leaves)
        batch.append((tape.compile_shape(shape, len(leaves)),
                      [rows_of[leaf] for leaf in leaves]))
    return batch


def overlay_rows(rng, leaves: list, n: int, base: int) -> tuple:
    """Set and clear overlays of ``leaves`` as a delta plane holds them:
    a fraction OVERLAY_LIVE of each row's ``n`` containers holds a few
    written bits, every other container is absent.  Returns the live
    blocks (to place at pool row ``base`` on) and each overlay's global
    rows, -1 where absent."""
    blocks, rows_of = [], {}
    for leaf in leaves:
        for kind in ("set", "clear"):
            live = np.flatnonzero(rng.random(n) < OVERLAY_LIVE)
            b = np.zeros((len(live), 2048), np.uint32)
            for j in range(len(live)):
                w = rng.integers(0, 2048, size=8)
                b[j, w] |= np.uint32(1) << rng.integers(
                    0, 32, size=8).astype(np.uint32)
            ix = np.full(n, -1, dtype=np.int32)
            ix[live] = base + sum(len(x) for x in blocks) + np.arange(
                len(live), dtype=np.int32)
            blocks.append(b)
            rows_of[(kind, leaf)] = ix
    return np.concatenate(blocks), rows_of


def vm_batch_program(tape, batch: list, zero: int) -> tuple:
    """(prog, gidx) of a batch at its own size class."""
    tb, lb = tape.size_class(max(len(t.instrs) for t, _ in batch),
                             max(t.n_leaves for t, _ in batch))
    return tape.vm_program(batch, zero, tb, lb)


def k3_fixed_launch(tape, seed: int, n_shards: int, trees: list,
                    delta: bool = False) -> tuple:
    """K3's fixed launch made from the seed: ``trees`` (of the coalesced
    path's) over five rows at ~8 % fill, one container per domain slot of
    a 2^20-column row over ``n_shards`` shards; with ``delta`` every leaf
    delta-fused over overlays of its own (``overlay_rows``).  Returns the
    pool's blocks and the program (prog, gidx) as numpy and the zero
    row."""
    rng = np.random.default_rng(seed + 51)
    leaves = [("f", 1), ("g", 2), ("f", 2), ("g", 3), ("f", 3)]
    n = n_shards * 16
    parts = [sparse_rows(rng, n_shards, (1 << 20) // 32).reshape(n, 2048)
             for _ in leaves]
    rows_of = {leaf: np.arange(i * n, (i + 1) * n, dtype=np.int32)
               for i, leaf in enumerate(leaves)}
    if delta:
        ov, ov_rows = overlay_rows(np.random.default_rng(seed + 55), leaves,
                                   n, len(leaves) * n)
        parts.append(ov)
        rows_of.update(ov_rows)
    blocks = np.concatenate(parts + [np.zeros((1, 2048), np.uint32)])
    zero = len(blocks) - 1
    rows_of = {k: np.where(v < 0, zero, v).astype(np.int32)
               for k, v in rows_of.items()}
    batch = fixed_program(tape, trees, rows_of, delta)
    prog_np, gidx_np = (vm_batch_program(tape, batch, zero) if delta
                        else tape.vm_program(batch, zero, 4, 4))
    return blocks, prog_np, gidx_np, zero


def phase_k3_fixed(torch, ck, tape, bm, dev, seed: int, card: dict,
                   n_shards: int, trees: list, delta: bool = False) -> dict:
    """K3 on its fixed launch (``k3_fixed_launch``)."""
    blocks, prog_np, gidx_np, zero = k3_fixed_launch(tape, seed, n_shards,
                                                     trees, delta)
    what = ("bitmap rows at 8 % under dfuse overlays" if delta
            else "bitmap rows at 8 %")
    return k3_timing(torch, ck, f"a fixed launch (B={len(trees)}, "
                     f"D={n_shards * 16}, {what})", len(trees),
                     bm.to_tensor(blocks, dev), prog_np, gidx_np, zero, card)


def phase_k2_time(torch, ck, bm, probe, card: dict) -> dict:
    a_pool, ai, b_pool, bi = probe
    p = int(ai.shape[0])
    got = ck.gathered_count_and(a_pool, ai, b_pool, bi)
    want = bm.gathered_pair_counts(a_pool, ai, b_pool, bi)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, "K2 differs from its plain version on the main path's "
                    "inputs")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=a_pool.device)
    k2 = time_ms(torch, lambda: ck.gathered_count_and(a_pool, ai, b_pool, bi),
                 TIMED_LAUNCHES, flush)
    # back to back, for comparison: L2 holds part of the last launch's rows
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_LAUNCHES):
        ck.gathered_count_and(a_pool, ai, b_pool, bi)
    end.record()
    torch.cuda.synchronize()
    b2b_ms = start.elapsed_time(end) / TIMED_LAUNCHES
    plain = time_ms(
        torch, lambda: bm.gathered_pair_counts(a_pool, ai, b_pool, bi),
        PLAIN_LAUNCHES, flush)
    # what the work needs: each distinct gathered row once, the two index
    # vectors once, the counts written once
    rows_a = int(torch.unique(ai.clamp(0, a_pool.shape[0] - 1)).numel())
    rows_b = int(torch.unique(bi.clamp(0, b_pool.shape[0] - 1)).numel())
    nbytes = (rows_a + rows_b) * ck.CONTAINER_WORDS * 4 + 3 * p * 4
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    # AND, popcount and add for each of the P * 2048 word pairs
    ops_ms = (p * ck.CONTAINER_WORDS * K2_CYCLES_PER_WORD
              / card["sm_cycles"] * 1e3)
    ms = k2["median"]
    log(f"K2 timing: P={p}, pools {a_pool.shape[0]}x{b_pool.shape[0]} rows, "
        f"{nbytes} bytes; kernel {fmt(k2, 1e3, 'us')} "
        f"({nbytes / ms / 1e6:.1f} GB/s at the median; back to back "
        f"{b2b_ms * 1e3:.2f} us), plain {fmt(plain, 1e3, 'us')}, "
        f"bound {bytes_ms * 1e3:.2f} us by bytes, {ops_ms * 1e3:.2f} us "
        f"by operations")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k2.items()}}


# -------------------------------------------------------------- K6 and K1


def phase_k6_check(torch, ck, dev, seed: int, words: int) -> int:
    """K6 against its plain version on the card; returns max |err|.
    Depths 1, 20 and 63 (predicate bits in the high limb), predicates 0,
    2^depth - 1 and past 2^depth (the unsigned entry's early-out), a
    width that is not a multiple of 4 words, S = 1, and the BSI path's
    stack shape."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 6)

    def words_of(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)

    cases = [(f"d{d}s{sh}w{w}", d, sh, w) for d in (1, 20, 63)
             for sh, w in ((1, 2099), (3, 2048), (1, 7))]
    cases.append(("path", BSI_DEPTH, N_SHARDS, words))
    worst = 0
    for label, depth, shards, w in cases:
        planes = words_of((shards, 2 + depth, w))
        planes[:, :, 0] = -1
        cons = words_of((shards, w))
        preds = (0, 1, 2 ** depth - 1, (2 ** depth - 1) // 3, 2 ** depth)
        for upred in preds:
            for unsigned in (False, True):
                fn = ck.bsi_compare_unsigned if unsigned else ck.bsi_compare
                got = fn(planes, cons, upred, depth)
                torch.cuda.synchronize()
                if not unsigned:
                    want = ck.bsi_compare_plain(planes, cons, upred, depth)
                elif upred < 2 ** depth:
                    want = ck.bsi_compare_plain(planes, cons, upred, depth,
                                                form=True)
                else:  # above every value: all considered columns are lt
                    want = (planes[:, 0] & ~planes[:, 1] & cons,
                            torch.zeros_like(cons))
                err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs()
                              .max()) for a, b in zip(got, want))
                worst = max(worst, err)
                check(err == 0 and all(torch.equal(a, b)
                                       for a, b in zip(got, want)),
                      f"K6 differs from its plain version ({label}, upred "
                      f"{upred}, unsigned {unsigned})")
        log(f"K6 check {label}: S={shards} depth={depth} W={w}, predicates "
            f"{preds}, general and unsigned entries, max_abs_err {worst}")
    return worst


def phase_k1_check(torch, ck, dev, seed: int, words: int) -> int:
    """K1 against its plain version on the card; returns max |err|.
    Lengths that are not a multiple of the block, all-ones inputs, a
    plane of a stack (strided rows), a misaligned base, the BSI path's
    shape, and 2^26 all-ones words, whose 2^31 bits need the int64
    accumulator."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    worst = 0
    for n in (1, 2047, 2049, 100003, 1 << 20):
        a = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                          device=dev, generator=g)
        b = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                          device=dev, generator=g)
        ones = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for label, x, y in (("random", a, b), ("ones", ones, ones),
                            ("misaligned", a[1:], b[1:])):
            err = abs(ck.count_and(x, y) - ck.count_and_plain(x, y))
            worst = max(worst, err)
            check(err == 0, f"K1 differs from its plain version (n={n}, "
                            f"{label})")
    planes = torch.randint(-2 ** 31, 2 ** 31, (N_SHARDS, 2 + BSI_DEPTH,
                                               words), dtype=torch.int32,
                           device=dev, generator=g)
    filt = planes[:, 3].contiguous()
    err = abs(ck.count_and(planes[:, 0], filt)
              - ck.count_and_plain(planes[:, 0], filt))
    worst = max(worst, err)
    check(err == 0, "K1 differs from its plain version (a plane of the "
                    "path's stack)")
    ones = torch.full((1 << 26,), -1, dtype=torch.int32, device=dev)
    big = ck.count_and(ones, ones)
    check(big == 1 << 31, f"K1 counted {big} of 2^31 bits")
    log(f"K1 check: lengths 1, 2047, 2049, 100003, 2^20 (random, all ones, "
        f"misaligned), a strided plane of [{N_SHARDS}, {2 + BSI_DEPTH}, "
        f"{words}], 2^26 all-ones words = {big} bits; max_abs_err {worst}")
    return worst


def bsi_data(seed: int, n_shards: int, width: int) -> dict:
    """The int field's values, made from the seed: about BSI_FILL/10 of
    the columns hold one, BSI_NEG/10 of those negative, magnitudes
    uniform in [0, 10^6], with 0 and both bounds present.  ``vals``
    int32 and ``exists`` bool over all columns."""
    rng = np.random.default_rng(seed + 11)
    n = n_shards * width
    exists = rng.integers(0, 10, size=n, dtype=np.uint8) < BSI_FILL
    vals = rng.integers(0, BSI_MAX + 1, size=n, dtype=np.int32)
    neg = rng.integers(0, 10, size=n, dtype=np.uint8) < BSI_NEG
    np.negative(vals, out=vals, where=neg)
    for col, v in ((3, 0), (width + 17, BSI_MAX), (2 * width + 9, BSI_MIN),
                   (n - 1, BSI_MIN), (n - 2, BSI_MAX)):
        exists[col], vals[col] = True, v
    vals[~exists] = 0
    return {"vals": vals, "exists": exists}


def bsi_planes(data: dict, n_shards: int, width: int) -> np.ndarray:
    """uint32 [n_shards, 2 + BSI_DEPTH, width / 32]: exists, sign and the
    magnitude bits of base-relative values (base 0), built in threads."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty((n_shards, 2 + BSI_DEPTH, width // 32), dtype=np.uint32)

    def shard(s):
        sl = slice(s * width, (s + 1) * width)
        e, v = data["exists"][sl], data["vals"][sl]
        mag = np.abs(v).astype(np.uint32)
        rows = [e, e & (v < 0)] + [((mag >> np.uint32(i)) & np.uint32(1))
                                   .astype(bool) for i in range(BSI_DEPTH)]
        for p, r in enumerate(rows):
            out[s, p] = np.packbits(r, bitorder="little").view(np.uint32)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(shard, range(n_shards)))
    return out


def bsi_oracles(data: dict, f1: np.ndarray, width: int) -> dict:
    """The numpy answers of the BSI path's queries on the int64 values;
    ``f1`` is field f's row 1 as bool over all columns."""
    e = data["exists"]
    v = data["vals"].astype(np.int64)
    ef = e & f1

    def count(mask) -> int:
        return int(np.count_nonzero(mask))

    def extreme(mask, fn) -> dict:
        x = fn(v[mask])
        return {"value": int(x), "count": count(mask & (v == x))}

    s5 = slice(5 * width, 6 * width)
    return {
        "gt1000": count(e & (v > 1000)),
        "lt_5000": count(e & (v < -5000)),
        "eq77": count(e & (v == 77)),
        "ne77": count(e & (v != 77)),
        "notnull": count(e),
        "between": count(e & (v > -100) & (v < 100000)),
        "out_of_range": 0,
        "f1_gt1000": count(ef & (v > 1000)),
        "row_shard5": {"columns": (np.flatnonzero(
            e[s5] & (v[s5] > 999000)) + 5 * width).tolist()},
        "sum": {"value": int(v[e].sum()), "count": count(e)},
        "sum_f1": {"value": int(v[ef].sum()), "count": count(ef)},
        "min": extreme(e, np.min),
        "max_f1": extreme(ef, np.max),
    }


#: (label, PQL, URL flags, K6, K4, K1 launches per run) of the BSI path
BSI_QUERIES = (
    ("gt1000", "Count(Row(v > 1000))", "", 1, 0, 0),
    ("lt_5000", "Count(Row(v < -5000))", "", 1, 0, 0),
    ("eq77", "Count(Row(v == 77))", "", 1, 0, 0),
    ("ne77", "Count(Row(v != 77))", "", 1, 0, 0),
    ("notnull", "Count(Row(v != null))", "", 0, 0, 0),
    ("between", "Count(Row(-100 < v < 100000))", "", 2, 0, 0),
    ("out_of_range", "Count(Row(v >= 2000000))", "", 0, 0, 0),
    ("f1_gt1000", "Count(Intersect(Row(f=1), Row(v > 1000)))", "", 1, 0, 0),
    ("row_shard5", "Row(v > 999000)", "?shards=5", 1, 0, 0),
    ("sum", "Sum(field=v)", "", 0, 2, 0),
    ("sum_f1", "Sum(Row(f=1), field=v)", "", 0, 2, 1),
    ("min", "Min(field=v)", "", 0, 0, 0),
    ("max_f1", "Max(Row(f=1), field=v)", "", 0, 0, 0),
)


def run_bsi_queries(ck, http: Http, wants: dict, runs: int, out: dict,
                    tag: str = "") -> None:
    """Each BSI query ``runs`` times, every answer equal to the oracle
    and K6 / K4 / K1 launched exactly at their launch sites."""
    for label, pql, flags, k6_per, k4_per, k1_per in BSI_QUERIES:
        k0 = ck.launch_counts()
        lat = []
        for _ in range(runs):
            res, ms = http.query(pql, flags)
            lat.append(ms)
            check(res == [wants[label]], f"{pql}{flags}{tag}: differs from "
                                         f"the oracle: {str(res)[:300]}")
        k1 = ck.launch_counts()
        got = {k: k1[k] - k0[k] for k in k1}
        check(got["bsi_compare"] == k6_per * runs
              and got["row_counts_masked"] == k4_per * runs
              and got["count_and"] == k1_per * runs,
              f"{pql}{flags}{tag}: launches {got} in {runs} runs")
        check(got["gathered_count_and"] == got["vm_counts"]
              == got["masked_matrix_counts"] == 0,
              f"{pql}{flags}{tag}: K2, K3 or K5 launched: {got}")
        entry = {"pql": pql + flags, "first_ms": lat[0], "k6": got[
            "bsi_compare"], "k4": got["row_counts_masked"],
                 "k1": got["count_and"]}
        if runs > 1:
            entry["warm_ms"] = spread(lat[1:])
        out[label + tag] = entry
        log(f"{label}{tag}: {pql}{flags} = oracle; K6 {entry['k6']}, K4 "
            f"{entry['k4']}, K1 {entry['k1']} launches; first "
            f"{lat[0]:.2f} ms" + (f", warm over HTTP {fmt(entry['warm_ms'])}"
                                  if runs > 1 else ""))


def phase_bsi(ck, srv, http: Http, roaring, data: dict, cpr: int,
              words: int, seed: int) -> dict:
    """The int field v on all shards: planes loaded into its BSI view
    through the in-process ``Field.import_roaring`` (the wire refuses
    roaring into an int field), a few thousand values through
    /import-value; every query once cold and QUERY_RUNS times warm, every
    answer equal to the numpy oracle and K6 / K4 / K1 launched exactly at
    their launch sites; then a Set and every query again.  Returns the
    measurements and, in ``probes``, K6's and K1's inputs recorded from
    one more run of the path's queries."""
    import base64

    width = words * 32
    t0 = time.perf_counter()
    bsi = bsi_data(seed, N_SHARDS, width)
    planes = bsi_planes(bsi, N_SHARDS, width)
    log(f"bsi data: {int(bsi['exists'].sum())} values on {N_SHARDS} shards, "
        f"planes {planes.shape} ({planes.nbytes} bytes), made in "
        f"{time.perf_counter() - t0:.1f} s")
    opts = {"options": {"type": "int", "min": BSI_MIN, "max": BSI_MAX,
                        "base": 0, "bitDepth": BSI_DEPTH}}
    check(http.post("/index/i/field/v", json.dumps(opts).encode())[0] == 200,
          "create int field v")
    t0 = time.perf_counter()
    rows = {p: planes[:, p] for p in range(planes.shape[1])}
    # the wire refuses roaring into an int field, as the reference does;
    # the planes load through the in-process field
    blob = roaring_payload(roaring, rows, 0, cpr)
    body = json.dumps({"views": {"bsig_v": base64.b64encode(
        blob).decode()}}).encode()
    st, resp = http.post("/index/i/field/v/import-roaring/0", body)
    check(st == 400 and b"only supported for set and time fields" in resp,
          f"import-roaring into an int field: HTTP {st} {resp!r}")
    field = srv.holder.index("i").field("v")
    sent = 0
    for s in range(N_SHARDS):
        blob = roaring_payload(roaring, rows, s, cpr)
        sent += len(blob)
        field.import_roaring(s, blob, view="bsig_v")
    log(f"import: field v, {N_SHARDS} roaring payloads of {planes.shape[1]} "
        f"plane rows through Field.import_roaring, {sent} bytes, in "
        f"{time.perf_counter() - t0:.1f} s")
    del rows, planes
    rng = np.random.default_rng(seed + 13)
    cols = rng.choice(N_SHARDS * width, size=BSI_IMPORT_VALUES,
                      replace=False)
    vals = rng.integers(BSI_MIN, BSI_MAX + 1, size=len(cols))
    body = json.dumps({"columnIDs": cols.tolist(),
                       "values": vals.tolist()}).encode()
    st, resp = http.post("/index/i/field/v/import-value", body)
    check(st == 200, f"import-value: HTTP {st} {resp!r}")
    bsi["exists"][cols] = True
    bsi["vals"][cols] = vals
    t0 = time.perf_counter()
    f1 = np.unpackbits(data["f"][1].view(np.uint8), bitorder="little"
                       ).astype(bool)
    wants = bsi_oracles(bsi, f1, width)
    log(f"bsi oracles in {time.perf_counter() - t0:.1f} s")

    out: dict = {"queries": {}}
    # ---- the BSI path: counts zeroed just before, read just after
    ck.reset_launch_counts()
    run_bsi_queries(ck, http, wants, 1 + QUERY_RUNS, out["queries"])
    # a Set moves one value; the plane stack follows the generation
    col, val = BSI_SET[0] * width + BSI_SET[1], BSI_SET[2]
    res, _ms = http.query(f"Set({col}, v={val})")
    check(res == [True], f"Set({col}, v={val}) -> {res}")
    bsi["exists"][col] = True
    bsi["vals"][col] = val
    wants = bsi_oracles(bsi, f1, width)
    run_bsi_queries(ck, http, wants, 1, out["queries"], tag="_after_set")
    out["launches"] = ck.launch_counts()
    out["gt1000_want"] = wants["gt1000"]  # the residency phase's K6 oracle
    # ---- end of the BSI path
    log(f"bsi path launches: {out['launches']}")

    # K6's and K1's inputs on this path, for the timing phase, recorded
    # where ops/bsi.py and the executor call them
    from pilosa_tpu_torch.ops import bitmap as bm
    from pilosa_tpu_torch.ops import bsi as bsi_ops

    probes: dict = {}
    real_k6, real_k1 = bsi_ops.compare, bm.popcount_and

    def k6(planes, filt, lo, hi):
        probes.setdefault("k6", (planes, filt.contiguous(),
                                 int(lo) | int(hi) << 32,
                                 planes.shape[-2] - bsi_ops.OFFSET_PLANE))
        return real_k6(planes, filt, lo, hi)

    def k1(a, b):
        probes.setdefault("k1", (a, b))
        return real_k1(a, b)

    bsi_ops.compare, bm.popcount_and = k6, k1
    try:
        http.query("Count(Row(v > 1000))")
        http.query("Sum(Row(f=1), field=v)")
    finally:
        bsi_ops.compare, bm.popcount_and = real_k6, real_k1
    check(set(probes) == {"k6", "k1"}, f"recorded only {sorted(probes)}")
    check(probes["k6"][0].shape == (N_SHARDS, 2 + BSI_DEPTH, words),
          f"K6 ran on {tuple(probes['k6'][0].shape)}, not the whole stack")
    out["probes"] = probes
    return out


def phase_k6_time(torch, ck, probe, card: dict) -> dict:
    """K6 on the BSI path's own inputs: the plane stack over all shards
    and the considered row of ``Count(Row(v > 1000))``."""
    planes, cons, upred, depth = probe
    got = ck._bsi_launch(planes, cons, upred, depth, False)
    want = ck.bsi_compare_plain(planes, cons, upred, depth)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    check(err == 0, "K6 differs from its plain version on the path's inputs")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=planes.device)
    k6 = time_ms(torch, lambda: ck._bsi_launch(planes, cons, upred, depth,
                                               False), TIMED_LAUNCHES, flush)
    plain = time_ms(torch, lambda: ck.bsi_compare_plain(planes, cons, upred,
                                                        depth),
                    PLAIN_LAUNCHES, flush)
    shards, _np, words = planes.shape
    cells = shards * words
    # bytes: the depth magnitude planes and the considered row read once,
    # lt and gt written once (exists and sign are not read: the caller
    # formed the considered row)
    nbytes = (depth + 1) * cells * 4 + 2 * cells * 4
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    # six bitwise operations per word and plane
    ops_ms = cells * depth * 6 * BITWISE_CYCLES / card["sm_cycles"] * 1e3
    ms = k6["median"]
    log(f"K6 timing: S={shards} depth={depth} W={words}, {nbytes} bytes; "
        f"kernel {fmt(k6, 1e3, 'us')} ({nbytes / ms / 1e6:.1f} GB/s at the "
        f"median), plain {fmt(plain, 1e3, 'us')}, bound "
        f"{bytes_ms * 1e3:.2f} us by bytes, {ops_ms * 1e3:.2f} us by "
        f"operations")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k6.items()}}


def phase_k1_time(torch, ck, probe, card: dict) -> dict:
    """K1 on the BSI path's own inputs: the exists plane of every shard
    (strided rows of the plane stack) against ``Sum(Row(f=1),
    field=v)``'s filter stack."""
    a, b = probe
    got = ck.count_and(a, b)
    want = ck.count_and_plain(a, b)
    err = abs(got - want)
    check(err == 0, "K1 differs from its plain version on the path's inputs")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=a.device)
    k1 = time_ms(torch, lambda: ck._count_and_launch(a, b), TIMED_LAUNCHES,
                 flush)
    plain = time_ms(torch, lambda: ck.count_and_plain(a, b), PLAIN_LAUNCHES,
                    flush)
    words = a.numel()
    nbytes = 2 * words * 4 + 8
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    ops_ms = words * K2_CYCLES_PER_WORD / card["sm_cycles"] * 1e3
    ms = k1["median"]
    log(f"K1 timing: {tuple(a.shape)} against {tuple(b.shape)} words, count "
        f"{got}, {nbytes} bytes; kernel {fmt(k1, 1e3, 'us')} "
        f"({nbytes / ms / 1e6:.1f} GB/s at the median), plain "
        f"{fmt(plain, 1e3, 'us')}, bound {bytes_ms * 1e3:.2f} us by bytes, "
        f"{ops_ms * 1e3:.2f} us by operations")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k1.items()}}


# ------------------------------------------------------------- kinds leg


def kind_blocks(rng, n: int) -> np.ndarray:
    """n dense containers cycling through array, run and bitmap styles,
    bits 0 and 65535 in every seventh."""
    blocks = np.zeros((n, 2048), dtype=np.uint32)
    for i in range(n):
        style = i % 3
        if style == 0:
            pos = rng.choice(1 << 16, int(rng.integers(1, 4000)),
                             replace=False)
        elif style == 1:
            starts = np.sort(rng.choice(256, int(rng.integers(1, 200)),
                                        replace=False)) * 256
            pos = np.concatenate([np.arange(s0, s0 + int(rng.integers(
                1, 250))) for s0 in starts])
        else:
            pos = rng.choice(1 << 16, 20000, replace=False)
        if i % 7 == 0:
            pos = np.concatenate([pos, [0, 65535]])
        np.bitwise_or.at(blocks[i], pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))
    return blocks


def kinds_case(kp, rng, label, n_blocks, slots, tape_len, n_q, domain,
               drop=None, live_q=None):
    """(label, bpool, apool, acard, rpool, prog, gidx) as numpy: a
    kind-split megapool of seeded containers (``drop`` leaves one kind's
    pool with only its empty row), random SSA programs over all five
    opcodes, pad rows past ``live_q`` and pad slots on the zero row."""
    blocks = kind_blocks(rng, n_blocks)
    kinds = kp.pick_kinds(blocks)
    if drop is not None:
        keep = kinds != drop
        blocks, kinds = blocks[keep], kinds[keep]
    _s, bb, ap, ac, rp = kp.split_pools(blocks, kinds)
    bpool = np.concatenate([bb, np.zeros((1, 2048), np.uint32)])
    apool = np.concatenate([ap, np.full((1, ap.shape[1]), 0xFFFF,
                                        np.uint16)])
    acard = np.concatenate([ac, np.zeros(1, np.int32)])
    pad = np.zeros((1, rp.shape[1]), np.uint16)
    pad[:, 0::2] = 1
    rpool = np.concatenate([rp, pad])
    rows = len(bpool) + len(apool) + len(rpool)
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = (rng.integers(5), rng.integers(slots + t),
                          rng.integers(slots + t))
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    zero = len(bpool) - 1
    gidx[slots - 1] = zero
    if live_q is not None:
        prog[live_q:] = (4, 0, 0)
        gidx[:, live_q:] = zero
        gidx[:, :, domain // 2:] = zero
    return label, bpool, apool, acard, rpool, prog, gidx


def kinds_tensors(torch, bm, dev, bpool, apool, acard, rpool):
    return (bm.to_tensor(bpool, dev),
            torch.from_numpy(apool.view(np.int16)).to(dev),
            torch.from_numpy(acard).to(dev),
            torch.from_numpy(rpool.view(np.int16)).to(dev))


def phase_k3k_check(torch, ck, bm, kp, edges, dev, seed: int) -> int:
    """K3-kinds against its plain version on the card; returns max
    |err|.  B=1 D=1; (L, T) = (4, 4) and the caps (16, 32); pad rows and
    slots; each kind's pool empty in turn; 4096 containers, those of one
    2^20-column row over 256 shards; and the decode's edges
    (tests/torch_kinds_edges.py) at (4, 4), the caps and (64, 32), every
    edge row alone, and run rows re-padded to rcap 256."""
    rng = np.random.default_rng(seed + 33)
    cases = [kinds_case(kp, rng, "b1d1", 3, 1, 1, 1, 1),
             kinds_case(kp, rng, "l4t4", 60, 4, 4, 4, 64),
             kinds_case(kp, rng, "caps", 90, 16, 32, 2, 32),
             kinds_case(kp, rng, "pads", 40, 4, 4, 8, 16, live_q=5),
             kinds_case(kp, rng, "no_bitmap", 30, 4, 4, 4, 16, drop=1),
             kinds_case(kp, rng, "no_array", 30, 4, 4, 4, 16, drop=2),
             kinds_case(kp, rng, "no_run", 30, 4, 4, 4, 16, drop=3),
             kinds_case(kp, rng, "c4096", 4096, 4, 4, 4, 2048)]
    cases += [(f"edges_{label}", *edges.edge_case(seed + 34 + slots, slots,
                                                  tape_len, n_q, domain))
              for label, slots, tape_len, n_q, domain in edges.EDGE_SHAPES]
    cases.append(("edges_decode", *edges.decode_case(seed + 35)))
    label, bpool, apool, acard, rpool, prog, gidx = kinds_case(
        kp, rng, "repad", 60, 4, 8, 4, 32)
    cases.append((label, bpool, apool, acard, edges.repad(rpool, 256), prog,
                  gidx))
    worst = 0
    for label, bpool, apool, acard, rpool, prog, gidx in cases:
        pools = kinds_tensors(torch, bm, dev, bpool, apool, acard, rpool)
        tprog, tgidx = torch.from_numpy(prog), torch.from_numpy(gidx)
        got = ck.vm_counts_kinds(*pools, tprog, tgidx)
        torch.cuda.synchronize()
        want = ck.vm_counts_kinds_plain(*pools, tprog, tgidx)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        log(f"K3-kinds check {label}: Rb={len(bpool)} Ra={len(apool)} "
            f"(acap {apool.shape[1]}) Rr={len(rpool)} (rcap "
            f"{rpool.shape[1] // 2}), B={prog.shape[0]} T={prog.shape[1]} "
            f"L={gidx.shape[0]} D={gidx.shape[2]}, max_abs_err {err}")
        check(err == 0 and torch.equal(got, want),
              f"K3-kinds differs from its plain version ({label})")
    return worst


def kind_rows(rng, n_shards: int, words: int) -> dict:
    """Field k: rows 1-8 arrays at ~0.1 % fill (random bits), rows 9-16
    runs (KIND_RUNS runs of KIND_RUN_LEN consecutive columns in every
    container, 12.5 %), rows 17-24 bitmaps at ~8 % (FILL_SPARSE)."""
    n_cont = n_shards * words // 2048
    rows = {}
    for r in range(1, 9):
        rows[r] = array_row(rng, n_cont).reshape(n_shards, words)
    for r in range(9, 17):
        rows[r] = run_row(rng, n_cont).reshape(n_shards, words)
    for r in range(17, 25):
        rows[r] = sparse_rows(rng, n_shards, words)
    return rows


def array_row(rng, n_cont: int) -> np.ndarray:
    """uint32[n_cont, 2048]: KINDS_ARRAY_BITS random bits per container on
    average (~0.1 %)."""
    m = np.zeros(n_cont * 2048, dtype=np.uint32)
    pos = rng.integers(0, n_cont * (1 << 16), size=n_cont * KINDS_ARRAY_BITS,
                       dtype=np.int64)
    np.bitwise_or.at(m, pos >> 5, np.uint32(1) << (pos & 31).astype(np.uint32))
    return m.reshape(n_cont, 2048)


def run_row(rng, n_cont: int) -> np.ndarray:
    """uint32[n_cont, 2048]: KIND_RUNS runs of KIND_RUN_LEN columns in
    every container, on every other KIND_RUN_LEN slot so that none touch."""
    slots = (1 << 16) // (2 * KIND_RUN_LEN)
    run_words = KIND_RUN_LEN // 32
    m = np.zeros((n_cont, 2048), dtype=np.uint32)
    pick = np.argsort(rng.random((n_cont, slots)), axis=1)[:, :KIND_RUNS]
    idx = (pick[:, :, None] * 2 * run_words
           + np.arange(run_words)).reshape(n_cont, -1)
    np.put_along_axis(m, idx, np.uint32(0xFFFFFFFF), axis=1)
    return m


def row_columns(words: np.ndarray) -> list:
    """Sorted column ids of a row given as uint32[n_shards, words]."""
    flat = words.reshape(-1)
    nz = np.flatnonzero(flat)
    bits = np.unpackbits(flat[nz].view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")
    w, b = np.nonzero(bits)
    return (nz[w].astype(np.int64) * 32 + b).tolist()


#: (label, tree, root) of the kinds leg: field k's rows 1-8 are arrays,
#: 9-16 runs, 17-24 bitmaps
KINDS_QUERIES = (
    ("aa", ("and", ("k", 1), ("k", 2)), "count"),
    ("ab", ("and", ("k", 1), ("k", 17)), "count"),
    ("rr", ("and", ("k", 9), ("k", 10)), "count"),
    ("ar", ("and", ("k", 2), ("k", 11)), "count"),
    ("rb", ("and", ("k", 12), ("k", 18)), "count"),
    ("bb", ("and", ("k", 17), ("k", 18)), "count"),
    ("union_arb", ("or", ("k", 3), ("k", 13), ("k", 19)), "count"),
    ("xor_rb", ("xor", ("k", 14), ("k", 20)), "count"),
    ("diff_br", ("andnot", ("k", 21), ("k", 15)), "count"),
    ("nested", ("and", ("or", ("k", 4), ("k", 16)),
                ("andnot", ("k", 22), ("k", 5))), "count"),
    ("row_aa", ("and", ("k", 1), ("k", 2)), "row"),
    ("row_ar", ("and", ("k", 6), ("k", 9)), "row"),
)
#: the coalesced rounds of the kinds leg: 16 shapes, every one reading an
#: array and a run row
KINDS_TREES = _trees(("k", 1), ("k", 9), ("k", 17), ("k", 2), ("k", 10))


def kinds_pql(tree, root: str) -> str:
    return f"Count({tree_pql(tree)})" if root == "count" else tree_pql(tree)


def kinds_want(tree, root: str, data: dict):
    words = tree_words(tree, data)
    if root == "count":
        return int(np.bitwise_count(words).sum(dtype=np.int64))
    return {"columns": row_columns(words)}


def kinds_launch_sites(label: str, root: str) -> tuple:
    """(K3-kinds, K3, K2) launches of one request of the query, by
    route: under the coalescer a Count is one VM launch (K3 when every
    leaf is all-bitmap); with ?nocoalesce=true only the all-bitmap pair
    launches (K2); the array arms and the gathered decode are plain
    torch; a Row root runs no kernel."""
    if root != "count":
        return (0, 0, 0), (0, 0, 0)
    bitmap_only = label == "bb"
    default = (0, 1, 0) if bitmap_only else (1, 0, 0)
    nocoal = (0, 0, 1) if bitmap_only else (0, 0, 0)
    return default, nocoal


def kinds_pool_bytes(srv, n_rows: int) -> dict:
    """Field k's container leaves over all shards: the bytes their pools
    hold on the card (pow2 row padding included) and the live compact
    bytes (8 KiB per bitmap container, 2 * acap + 4 per array, 4 * rcap
    per run)."""
    f = srv.holder.index("i").field("k")
    shards = tuple(sorted(srv.holder.index("i").available_shards()))
    held = live = 0
    for r in range(1, n_rows + 1):
        leaf = f.device_container_leaf(r, shards)
        held += leaf.nbytes
        live += leaf.n * 8192
        if leaf.has_kinds:
            live += leaf.an * (2 * int(leaf.apool.shape[1]) + 4)
            live += leaf.rn * 4 * (int(leaf.rpool.shape[1]) // 2)
    return {"held": held, "live": live}


def run_kinds_queries(ck, http: Http, wants: dict, runs: int, flags: str,
                      sites: int, out: dict, tag: str) -> None:
    """Each kinds-leg query ``runs`` times with ``flags``, every answer
    equal to the oracle and K3-kinds / K3 / K2 launched exactly at their
    launch sites (``sites`` picks the default or the ?nocoalesce=true
    column of kinds_launch_sites)."""
    names = ("vm_counts_kinds", "vm_counts", "gathered_count_and")
    for label, tree, root in KINDS_QUERIES:
        pql = kinds_pql(tree, root)
        k0 = ck.launch_counts()
        lat = []
        for _ in range(runs):
            res, ms = http.query(pql, flags)
            lat.append(ms)
            check(res == [wants[label]], f"{pql}{flags}: differs from the "
                                         f"oracle: {str(res)[:200]}")
        k1 = ck.launch_counts()
        got = {k: k1[k] - k0[k] for k in k1}
        per = kinds_launch_sites(label, root)[sites]
        check(all(got[n] == p * runs for n, p in zip(names, per))
              and all(v == 0 for k, v in got.items() if k not in names),
              f"{pql}{flags}: launches {got} in {runs} runs, sites {per}")
        entry = {"pql": pql + flags, "first_ms": lat[0],
                 "launches": {n: got[n] for n in names if got[n]}}
        if runs > 1:
            entry["warm_ms"] = spread(lat[1:])
        out[label + tag] = entry
        log(f"kinds {label}{tag}: {pql}{flags} = oracle; launches "
            f"{entry['launches']}; first {lat[0]:.2f} ms"
            + (f", warm over HTTP {fmt(entry['warm_ms'])}" if runs > 1
               else ""))


def phase_kinds(ck, tape, containers, srv, http: Http, roaring, cpr: int,
                words: int, seed: int) -> dict:
    """Field k (array, run and bitmap rows) on all shards, imported over
    HTTP; every kinds-leg query once cold and KINDS_WARM times warm under
    the coalescer and once with ?nocoalesce=true, every answer equal to
    the numpy oracle and every kernel launched exactly at its launch
    sites; the 16-client coalesced rounds over kinds-mixed shapes, K3-kinds
    launches equal to vm.executions; then every query again with kinds
    off, equal answers, and the pool bytes both ways.  Returns the
    measurements and, in ``flush``, one K3-kinds flush's inputs."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 17)
    data = {"k": kind_rows(rng, N_SHARDS, words)}
    log(f"kinds data: field k, 24 rows on {N_SHARDS} shards, made in "
        f"{time.perf_counter() - t0:.1f} s")
    import_field(http, roaring, "k", data["k"], N_SHARDS, cpr)
    t0 = time.perf_counter()
    wants = {label: kinds_want(tree, root, data)
             for label, tree, root in KINDS_QUERIES}
    twants = [oracle(t, data) for t in KINDS_TREES]
    log(f"kinds oracles in {time.perf_counter() - t0:.1f} s")
    check(containers.config().kinds, "container kinds are off")
    f = srv.holder.index("i").field("k")
    kinds = [int(k) for r in (1, 9, 17)
             for k in f.fragment(3).row_container_kinds(r)[3][:1]]
    check(kinds == [2, 3, 1], f"rows 1, 9, 17 picked kinds {kinds}")

    out: dict = {"queries": {}}
    c0 = containers.counters()
    # ---- the kinds leg: counts zeroed just before, read just after
    ck.reset_launch_counts()
    run_kinds_queries(ck, http, wants, 1 + KINDS_WARM, "", 0,
                      out["queries"], "")
    run_kinds_queries(ck, http, wants, 1, "?nocoalesce=true", 1,
                      out["queries"], "_nocoalesce")
    fire_rounds(http, KINDS_TREES, twants, 1)  # stage every directory
    tape.reset_counters()
    k0 = ck.launch_counts()
    lat, wall = fire_rounds(http, KINDS_TREES, twants, KINDS_ROUNDS)
    k1 = ck.launch_counts()
    vm = tape.counters()
    out["launches"] = ck.launch_counts()
    # ---- end of the kinds leg
    c1 = containers.counters()
    gathered = {k: c1[k] - c0[k] for k in (
        "container.bitmap_gathered", "container.array_gathered",
        "container.run_gathered")}
    check(all(v > 0 for v in gathered.values()),
          f"a kind was never gathered: {gathered}")
    n_q = len(KINDS_TREES) * KINDS_ROUNDS
    kk = k1["vm_counts_kinds"] - k0["vm_counts_kinds"]
    check(vm["vm.queries"] == n_q and vm["vm.fallbacks"] == 0,
          f"kinds rounds: vm counters {vm}")
    check(kk == vm["vm.executions"] > 0 and k1["vm_counts"]
          == k0["vm_counts"], f"kinds rounds: K3-kinds {kk}, vm.executions "
          f"{vm['vm.executions']}, K3 {k1['vm_counts'] - k0['vm_counts']}")
    sp = spread(lat)
    out["coalesced"] = {"queries": n_q, "rounds": KINDS_ROUNDS,
                        "vm_executions": vm["vm.executions"],
                        "k3_kinds_launches": kk,
                        "queries_per_launch": n_q / vm["vm.executions"],
                        "latency_ms": sp, "qps": n_q / wall,
                        "programs": tape.debug()["vm"]["programs"]}
    out["gathered"] = gathered
    log(f"kinds coalesced: {len(KINDS_TREES)} trees x {KINDS_ROUNDS} rounds "
        f"from {len(KINDS_TREES)} clients, every answer exact; "
        f"vm.executions {vm['vm.executions']} = K3-kinds launches, "
        f"{out['coalesced']['queries_per_launch']:.2f} queries per launch; "
        f"per request {fmt(sp)}; {out['coalesced']['qps']:.1f} queries/s; "
        f"gathered {gathered}")

    # one more round under a 100 ms window, so that the 16 queries meet
    # in one bucket and the prefetch budget halves it into launches of a
    # fixed width (KINDS_TIMED_BATCH queries), recording the launches'
    # inputs for the timing
    flushes: list = []
    real = tape.execute_vm

    def recording(batch, pool, zero_index, tape_len=None, slots=None,
                  max_prefetch=None):
        flushes.append((list(batch), pool, zero_index, tape_len, slots,
                        max_prefetch))
        return real(batch, pool, zero_index, tape_len, slots, max_prefetch)

    window = srv.coalescer.window_s
    tape.execute_vm, srv.coalescer.window_s = recording, 0.1
    try:
        fire_rounds(http, KINDS_TREES, twants, 1)
    finally:
        tape.execute_vm, srv.coalescer.window_s = real, window
    check(flushes and all(isinstance(fl[1], containers.MegaPools)
                          for fl in flushes),
          "a kinds flush ran over a plain pool")
    # the calls that launched: the halving stops where a batch fits
    launched = [fl[:5] for fl in flushes
                if len(fl[0]) == 1 or fl[4] * (1 << (len(fl[0]) - 1)
                                               .bit_length())
                * len(fl[0][0][1][0]) <= fl[5]]
    fixed = [fl for fl in launched if len(fl[0]) == KINDS_TIMED_BATCH]
    check(bool(fixed), f"no kinds launch of {KINDS_TIMED_BATCH} queries: "
                       f"{sorted(len(fl[0]) for fl in launched)}")
    out["flush"] = fixed[0]

    on = kinds_pool_bytes(srv, 24)
    containers.configure(kinds=False)
    try:
        for label, tree, root in KINDS_QUERIES:
            pql = kinds_pql(tree, root)
            for flags in ("", "?nocoalesce=true"):
                res, _ms = http.query(pql, flags)
                check(res == [wants[label]],
                      f"{pql}{flags} with kinds off: {str(res)[:200]}")
        off = kinds_pool_bytes(srv, 24)
    finally:
        containers.configure(kinds=True)
    out["pool_bytes"] = {"kinds_on": on, "kinds_off": off,
                         "held_ratio": off["held"] / on["held"],
                         "live_ratio": off["live"] / on["live"]}
    out["data"] = data  # for the ingest phase's writes and oracle
    log(f"kinds pool bytes of field k's 24 rows: kinds on {on}, kinds off "
        f"{off}; off/on {out['pool_bytes']['held_ratio']:.2f} held, "
        f"{out['pool_bytes']['live_ratio']:.2f} live; every query equal with "
        f"kinds off")
    return out


# ---------------------------------------------------------------- ingest


@contextlib.contextmanager
def staged_shapes(containers):
    """The shapes the VM stages inside the block (None for a decline)."""
    shapes: list = []
    real = containers.stage_vm

    def stage(*a, **k):
        st = real(*a, **k)
        shapes.append(None if st is None else st.shape)
        return st

    containers.stage_vm = stage
    try:
        yield shapes
    finally:
        containers.stage_vm = real


def flip_bits(rng, http: Http, rows: dict, field: str, r: int,
              n: int) -> list:
    """``n`` PQL Sets of clear bits and ``n`` Clears of set bits of row
    ``r`` (uint32[shards, words], updated), in random shards; returns the
    touched columns."""
    flat = rows[r].reshape(-1)
    calls, cols = [], []
    for want_set in (True, False):
        for _ in range(n):
            while True:
                if want_set:
                    col = int(rng.integers(0, flat.size * 32))
                else:
                    w = int(rng.choice(np.flatnonzero(flat)))
                    bits = np.flatnonzero(np.unpackbits(
                        flat[w:w + 1].view(np.uint8), bitorder="little"))
                    col = w * 32 + int(rng.choice(bits))
                w, b = col >> 5, np.uint32(1) << np.uint32(col & 31)
                if bool(flat[w] & b) != want_set and col not in cols:
                    break
            flat[w] = flat[w] | b if want_set else flat[w] & ~b
            calls.append(f"{'Set' if want_set else 'Clear'}({col}, "
                         f"{field}={r})")
            cols.append(col)
    res, _ms = http.query(" ".join(calls))
    check(res == [True] * len(calls), f"{field}{r} flips: {res}")
    return cols


def import_bits(http: Http, rows_by: dict, pairs: list) -> float:
    """POST /index/i/field/{f}/import of (field, row, column) triples,
    one request per field, updating ``rows_by[field][row]``; returns the
    host-clock seconds of the requests."""
    secs = 0.0
    for f in sorted({p[0] for p in pairs}):
        rs = [int(r) for g, r, _c in pairs if g == f]
        cs = [int(c) for g, _r, c in pairs if g == f]
        body = json.dumps({"rowIDs": rs, "columnIDs": cs}).encode()
        t0 = time.perf_counter()
        st, out = http.post(f"/index/i/field/{f}/import", body)
        secs += time.perf_counter() - t0
        check(st == 200, f"import into {f}: HTTP {st} {out[:200]!r}")
        for r, c in zip(rs, cs):
            flat = rows_by[f][r].reshape(-1)
            flat[c >> 5] |= np.uint32(1) << np.uint32(c & 31)
    return secs


def coalesced_delta_rounds(ck, tape, containers, http: Http, trees: list,
                           data: dict, kernel: str) -> dict:
    """``INGEST_ROUNDS`` rounds of ``trees`` over rows with pending deltas
    (counts zeroed just before, read just after): every answer equal to
    the oracle, every query staged by the VM as a dfuse tape, ``kernel``
    launched once per VM execution and no other kernel."""
    wants = [oracle(t, data) for t in trees]
    fire_rounds(http, trees, wants, 1)  # stage the leaves once
    with staged_shapes(containers) as shapes:
        ck.reset_launch_counts()
        tape.reset_counters()
        lat, wall = fire_rounds(http, trees, wants, INGEST_ROUNDS)
        k = ck.launch_counts()
        vm = tape.counters()
    n_q = len(trees) * INGEST_ROUNDS
    check(len(shapes) == n_q and all(
        s is not None and "dfuse" in str(s) for s in shapes),
        f"{sum(s is None for s in shapes)} declines, "
        f"{sum(s is not None and 'dfuse' not in str(s) for s in shapes)} "
        f"tapes without dfuse of {n_q}")
    check(vm["vm.queries"] == n_q and vm["vm.fallbacks"] == 0,
          f"vm counters {vm}")
    check(k[kernel] == vm["vm.executions"] > 0
          and all(v == 0 for n, v in k.items() if n != kernel),
          f"launches {k}, vm.executions {vm['vm.executions']}")
    sp = spread(lat)
    out = {"queries": n_q, "rounds": INGEST_ROUNDS, "launches": k[kernel],
           "queries_per_launch": n_q / vm["vm.executions"],
           "latency_ms": sp, "qps": n_q / wall,
           "programs": tape.debug()["vm"]["programs"]}
    log(f"ingest {kernel} rounds: {len(trees)} trees x {INGEST_ROUNDS} "
        f"rounds over rows with pending deltas, every answer exact, every "
        f"query a dfuse tape; {kernel} launches {k[kernel]} = "
        f"vm.executions, {out['queries_per_launch']:.2f} queries per "
        f"launch; per request {fmt(sp)}; {out['qps']:.1f} queries/s; VM "
        f"programs {out['programs']}")
    return out


def phase_ingest(ck, tape, containers, srv, http: Http, roaring, data: dict,
                 kdata: dict, seed: int) -> dict:
    """Streaming ingest on the served index ([ingest] deltas on, the
    compactor scanning once an hour):

    (a) PQL Sets and Clears on f rows 1-3, g rows 2-3 and k rows 1, 2, 9,
        10, 17; a sparse /import batch (f in the first eighth of the
        shards, g in the second, so that the pending planes stay under the
        64 MiB budget) and a sparse
        /import-roaring payload (under 512 bits a container) -- all land
        in delta planes, which GET /debug/ingest shows pending;
    (b) the 16 coalesced trees over those rows: each query a dfuse tape,
        K3 launched once per VM execution (counts zeroed just before,
        read just after);
    (c) the same over the kinds rows: K3-kinds;
    (d) a ?nocoalesce=true Count and a Row root over delta rows: the
        container engine declines (the pools hold base rows) and the
        dense dfuse path answers, no kernel;
    (e) ?nodelta=1 merges field f's deltas first (K2 runs); after it no f
        delta is pending and the same Count runs on K2 again;
    (g) host-clock times: a warm coalesced Count over delta rows against
        the same after compaction, the first Count after a Set, and the
        write rate through /import.

    Every answer equals the numpy oracle, which takes every write.
    (f), the fixed dfuse launches, runs with the other timings."""
    rng = np.random.default_rng(seed + 29)
    both = {"f": data["f"], "g": data["g"], "k": kdata["k"]}
    oracle_data = {**data, **kdata}
    n_shards, words = data["f"][1].shape
    width = words * 32
    out: dict = {}
    doc0 = ingest_doc(http)

    # (a) the writes
    t0 = time.perf_counter()
    for f, r in (("f", 1), ("f", 2), ("f", 3), ("g", 2), ("g", 3),
                 ("k", 1), ("k", 2), ("k", 9), ("k", 10), ("k", 17)):
        flip_bits(rng, http, both[f], f, r, INGEST_FLIPS)
    n_cols = data["f"][1].size * 32
    half, eighth = INGEST_IMPORT_BITS // 2, n_shards // 8 * width
    pairs = [("f", int(rng.integers(1, 4)), int(c)) for c in
             rng.integers(0, eighth, size=half)]
    pairs += [("g", int(rng.integers(2, 4)), int(c)) for c in
              rng.integers(eighth, 2 * eighth, size=half)]
    import_bits(http, both, pairs)
    shard = 7
    pos = np.sort(np.concatenate([
        r * width + rng.choice(width, size=100, replace=False)
        for r in (2, 3)]).astype(np.uint64))
    keys, words = roaring.positions_to_containers(pos)
    st, body = http.post(f"/index/i/field/g/import-roaring/{shard}",
                         roaring.encode(keys, words),
                         "application/octet-stream")
    check(st == 200, f"import-roaring g: HTTP {st} {body!r}")
    for p in pos.tolist():
        r, off = divmod(int(p), width)
        data["g"][r][shard, off >> 5] |= np.uint32(1) << np.uint32(off & 31)
    doc = ingest_doc(http)
    idx = srv.holder.index("i")
    pending = {f: len(idx.field(f).view("standard").delta_stats())
               for f in ("f", "g", "k")}
    check(doc["pendingBits"] > 0
          and doc["inlineFlushes"] == doc0["inlineFlushes"]
          and all(pending.values()),
          f"/debug/ingest {dict(list(doc.items())[1:10])}, fragments "
          f"pending by field {pending}")
    check(doc["config"]["compactInterval"] == INGEST_INTERVAL,
          f"compact interval {doc['config']['compactInterval']}")
    out["writes"] = {
        "pql": 10 * 2 * INGEST_FLIPS, "import_bits": INGEST_IMPORT_BITS,
        "roaring_bits": int(len(pos)), "ms": (time.perf_counter() - t0) * 1e3,
        "pending": {k: doc[k] for k in ("fragmentsPending", "pendingBits",
                                        "pendingRows", "pendingBytes",
                                        "inlineFlushes", "compactions")},
        "fragments_pending_by_field": pending,
        "compact_interval_s": doc["config"]["compactInterval"]}
    log(f"ingest writes: {out['writes']['pql']} PQL Sets/Clears, "
        f"{INGEST_IMPORT_BITS} bits through /import, {len(pos)} through "
        f"/import-roaring; /debug/ingest: {out['writes']['pending']} "
        f"(compact interval {doc['config']['compactInterval']} s)")

    # (b), (c) coalesced rounds over the delta rows
    out["k3"] = coalesced_delta_rounds(ck, tape, containers, http, TREES,
                                       oracle_data, "vm_counts")
    out["k3_kinds"] = coalesced_delta_rounds(ck, tape, containers, http,
                                             KINDS_TREES, oracle_data,
                                             "vm_counts_kinds")

    # (d) the dense dfuse path
    ck.reset_launch_counts()
    c0 = containers.counters()
    tree = ("and", ("f", 1), ("f", 2))
    res, ms_count = http.query(f"Count({tree_pql(tree)})",
                               "?nocoalesce=true")
    check(res == [oracle(tree, oracle_data)], f"dense dfuse Count: {res}")
    rtree = ("and", ("k", 1), ("k", 2))
    res, ms_row = http.query(tree_pql(rtree))
    check(res == [{"columns": row_columns(tree_words(rtree, oracle_data))}],
          f"dense dfuse Row: {str(res)[:200]}")
    c1 = containers.counters()
    k = ck.launch_counts()
    check(c1["container.fallbacks"] - c0["container.fallbacks"] == 2
          and c1["container.queries"] == c0["container.queries"]
          and not any(k.values()),
          f"dense dfuse route: containers {c1}, launches {k}")
    out["dense"] = {"count_ms": ms_count, "row_ms": ms_row,
                    "row_columns": len(res[0]["columns"])}
    log(f"ingest dense dfuse: Count ?nocoalesce=true {ms_count:.2f} ms, Row "
        f"root ({len(res[0]['columns'])} columns) {ms_row:.2f} ms, the "
        f"container engine declined both, no kernel")

    # (e) ?nodelta=1 compacts field f first; K2 again after it
    pql = f"Count({tree_pql(tree)})"
    k_runs = []
    for flags in ("?nodelta=1&nocoalesce=true", "?nocoalesce=true"):
        ck.reset_launch_counts()
        res, _ms = http.query(pql, flags)
        check(res == [oracle(tree, oracle_data)], f"{pql}{flags}: {res}")
        k_runs.append(ck.launch_counts()["gathered_count_and"])
        check(not srv.holder.index("i").field("f").view("standard")
              .delta_stats(), f"field f's deltas pending after {flags}")
    doc = ingest_doc(http)
    check(not [e for e in doc["top"] if e["field"] == "f"],
          f"/debug/ingest lists field f: {doc['top'][:3]}")
    check(k_runs == [1, 1], f"K2 launches with ?nodelta=1, then without: "
                            f"{k_runs}")
    out["nodelta"] = {"k2_launches": k_runs,
                      "pending_after": {k: doc[k] for k in (
                          "fragmentsPending", "pendingBits")}}
    log(f"ingest ?nodelta=1: field f compacted, K2 launches {k_runs}; "
        f"still pending elsewhere: {out['nodelta']['pending_after']}")

    # (g) host-clock times
    gtree = ("and", ("g", 2), ("g", 3))
    gpql = f"Count({tree_pql(gtree)})"

    def warm(label: str, flags: str = "") -> dict:
        lat = []
        for _ in range(INGEST_WARM):
            res, ms = http.query(gpql, flags)
            lat.append(ms)
            check(res == [oracle(gtree, oracle_data)], f"{label}: {res}")
        return spread(lat)

    check(bool(srv.holder.index("i").field("g").view("standard")
               .delta_stats()), "field g has no pending delta")
    http.query(gpql)  # stage once
    times = {"delta_warm_ms": warm("warm over deltas")}
    res, _ms = http.query(gpql, "?nodelta=1")
    check(res == [oracle(gtree, oracle_data)], f"{gpql}?nodelta=1: {res}")
    http.query(gpql)
    times["compacted_warm_ms"] = warm("warm after compaction")
    lat = []
    for _ in range(INGEST_SETS):
        flip = data["g"][2].reshape(-1)
        while True:
            col = int(rng.integers(0, flip.size * 32))
            if not flip[col >> 5] & (np.uint32(1) << np.uint32(col & 31)):
                break
        res, _ms = http.query(f"Set({col}, g=2)")
        check(res == [True], f"Set({col}, g=2): {res}")
        flip[col >> 5] |= np.uint32(1) << np.uint32(col & 31)
        res, ms = http.query(gpql)
        check(res == [oracle(gtree, oracle_data)], f"after a Set: {res}")
        lat.append(ms)
    times["first_after_set_ms"] = spread(lat)
    rates = []
    for _ in range(INGEST_BATCHES):
        pairs = [("f", int(r), int(c)) for r, c in zip(
            rng.integers(1, 4, size=INGEST_BATCH_BITS),
            rng.integers(0, n_cols, size=INGEST_BATCH_BITS))]
        rates.append(INGEST_BATCH_BITS / import_bits(http, both, pairs))
    times["import_bits_per_s"] = spread(rates)
    doc = ingest_doc(http)
    times["after_imports"] = {k: doc[k] for k in (
        "fragmentsPending", "pendingBits", "compactions", "inlineFlushes")}
    out["times"] = times
    log(f"ingest times: warm coalesced {gpql} over pending deltas "
        f"{fmt(times['delta_warm_ms'])}, after compaction "
        f"{fmt(times['compacted_warm_ms'])}; the first Count after a Set "
        f"{fmt(times['first_after_set_ms'])}; /import of "
        f"{INGEST_BATCH_BITS} bits {fmt(times['import_bits_per_s'], 1, 'bits/s')}"
        f"; then {times['after_imports']}")
    tree3 = ("or", ("f", 1), ("f", 2), ("f", 3))
    res, _ms = http.query(f"Count({tree_pql(tree3)})", "?nocoalesce=true")
    check(res == [oracle(tree3, oracle_data)], f"after the imports: {res}")
    out["compaction"] = compact_all()
    out["compaction"].pop("before")
    res, _ms = http.query(f"Count({tree_pql(tree3)})")
    check(res == [oracle(tree3, oracle_data)], f"after compaction: {res}")
    log(f"ingest: a compactor scan merged {out['compaction']['fragments']} "
        f"fragments ({out['compaction']['bits']} bits) in "
        f"{out['compaction']['ms']:.0f} ms; every answer still exact")
    return out


def k3k_timing(torch, ck, label: str, live: int, pools: tuple, prog_np,
               gidx_np, card: dict) -> dict:
    """K3-kinds on one launch's inputs (``live`` real queries over the
    pools (bpool, apool, acard, rpool)), against its plain version and its
    bound."""
    dev = pools[0].device
    prog = torch.from_numpy(prog_np).to(dev)
    gidx = torch.from_numpy(gidx_np).to(dev)
    got = ck.vm_counts_kinds(*pools, prog, gidx)
    want = ck.vm_counts_kinds_plain(*pools, prog, gidx)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, f"K3-kinds differs from its plain version on {label}")
    n_q, tape_len, _ = prog_np.shape
    slots, _, domain = gidx_np.shape
    # the wrapper plans the tape on the host before each launch: the
    # median cost with no tape cached (tapes not seen before) and cached
    prog_cpu = torch.from_numpy(prog_np)
    plan_us = host_plan_us(lambda: ck.vm_kinds_plan(prog_cpu, slots),
                           (ck._plan_row,))
    plan_cpu = ck.vm_kinds_plan(prog_cpu, slots)
    plan = plan_cpu.to(dev)
    flush_buf = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    k3k = time_ms(torch, lambda: ck._vm_kinds_launch(*pools, plan, gidx),
                  TIMED_LAUNCHES, flush_buf)
    plain = time_ms(torch, lambda: ck.vm_counts_kinds_plain(*pools, prog,
                                                            gidx),
                    K3_PLAIN_LAUNCHES, flush_buf)
    bpool, apool, _acard, rpool = pools
    rb, ra = int(bpool.shape[0]), int(apool.shape[0])
    acap, rcap = int(apool.shape[1]), int(rpool.shape[1]) // 2
    # bytes: each row the directory names once, in its compact form
    rows = np.unique(gidx_np)
    n_b = int((rows < rb).sum())
    n_a = int(((rows >= rb) & (rows < rb + ra)).sum())
    n_r = len(rows) - n_b - n_a
    nbytes = (n_b * 8192 + n_a * (2 * acap + 4) + n_r * 4 * rcap
              + prog_np.nbytes + gidx_np.nbytes + n_q * domain * 4)
    bytes_ms = nbytes / card["hbm_rate"] * 1e3
    # operations: for each cell word of the live queries, one bitwise op
    # per instruction the result reaches (COPYs and dead code do no
    # bitwise work), a popcount and an add; the decode is not counted
    live_ops = plan_cpu[:live, 0].tolist()
    cycles = sum(domain * ck.CONTAINER_WORDS
                 * (n * BITWISE_CYCLES + POPC_CYCLES + BITWISE_CYCLES)
                 for n in live_ops)
    ops_ms = cycles / card["sm_cycles"] * 1e3
    # the earlier formula, every tape slot a bitwise op, for comparison
    # with the shares measured before the kernel skipped COPYs
    all_slots_ops_ms = (live * domain * ck.CONTAINER_WORDS
                  * (tape_len * BITWISE_CYCLES + POPC_CYCLES
                     + BITWISE_CYCLES)) / card["sm_cycles"] * 1e3
    all_slots_bound = max(bytes_ms, all_slots_ops_ms)
    ms = k3k["median"]
    bound = max(bytes_ms, ops_ms)
    log(f"K3-kinds timing, {label}: {live} queries, B={n_q} T={tape_len} "
        f"L={slots} D={domain}, live instructions {live_ops}, pools Rb={rb} "
        f"Ra={ra} (acap {acap}) Rr={int(rpool.shape[0])} (rcap {rcap}), "
        f"distinct rows named: {n_b} bitmap, {n_a} array, {n_r} run, "
        f"{nbytes} bytes; kernel {fmt(k3k, 1e3, 'us')}, plain "
        f"{fmt(plain, 1e3, 'us')}, host plan (median of {HOST_PLAN_CALLS}) "
        f"{plan_us['cold']:.1f} us cold, {plan_us['cached']:.1f} us cached; bound "
        f"{bytes_ms * 1e3:.2f} us by bytes, {ops_ms * 1e3:.2f} us by "
        f"operations; {100 * bound / ms:.1f} % of the bound; the bound with "
        f"every tape slot a bitwise op {all_slots_bound * 1e3:.2f} us, "
        f"{100 * all_slots_bound / ms:.1f} % of it")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["median"],
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "all_slots_bound_ms": all_slots_bound, "host_plan_us": plan_us,
            "spread_us": {k: v * 1e3 if k != "n" else v
                          for k, v in k3k.items()},
            "shape": {"B": n_q, "live": live, "T": tape_len, "L": slots,
                      "D": domain, "live_ops": live_ops, "Rb": rb, "Ra": ra,
                      "acap": acap, "Rr": int(rpool.shape[0]), "rcap": rcap,
                      "rows_named": [n_b, n_a, n_r]}}


def phase_k3k_time(torch, ck, tape, flush, card: dict) -> dict:
    """K3-kinds on the inputs of one real flush of the kinds rounds."""
    batch, mp, zero, tb, lb = flush
    prog_np, gidx_np = tape.vm_program(batch, zero, tb, lb)
    return k3k_timing(torch, ck, "one flush of the kinds rounds", len(batch),
                      (mp.bpool, mp.apool, mp.acard, mp.rpool), prog_np,
                      gidx_np, card)


def k3k_fixed_launch(torch, tape, bm, kp, dev, seed: int,
                     delta: bool = False) -> tuple:
    """K3-kinds' fixed launch made from the seed: FIXED_B of the kinds
    rounds' trees over field k's rows 1 and 2 (arrays at ~0.1 %), 9 and 10
    (16 runs of 512 columns per container) and 17 (a bitmap at ~8 %),
    drawn as the kinds leg draws them, D = 4096; with ``delta`` every leaf
    delta-fused over bitmap overlays of its own (``overlay_rows``), which
    join the bitmap pool.  Returns the real query count, the pools
    (bpool, apool, acard, rpool) on ``dev`` and the program (prog, gidx)
    as numpy."""
    rng = np.random.default_rng(seed + 53)
    n = FIXED_D
    rows = {("k", 1): array_row(rng, n), ("k", 2): array_row(rng, n),
            ("k", 9): run_row(rng, n), ("k", 10): run_row(rng, n),
            ("k", 17): sparse_rows(rng, N_SHARDS, (1 << 20) // 32)
            .reshape(n, 2048)}
    blocks = np.concatenate(list(rows.values()))
    kinds = kp.pick_kinds(blocks)
    want = np.repeat([{1: 2, 2: 2, 9: 3, 10: 3, 17: 1}[r] for _f, r in rows],
                     n)
    check(np.array_equal(kinds, want), "the fixed rows picked other kinds")
    slot, bb, ap, ac, rp = kp.split_pools(blocks, kinds)
    ov_rows: dict = {}
    if delta:
        ov, ov_rows = overlay_rows(np.random.default_rng(seed + 57),
                                   list(rows), n, len(bb))
        bb = np.concatenate([bb, ov])
    rb, ra = len(bb) + 1, len(ap) + 1  # each pool ends in its empty row
    base = np.where(kinds == 1, 0, np.where(kinds == 2, rb, rb + ra))
    glob = (base + slot).astype(np.int32)
    rows_of = {leaf: glob[i * n:(i + 1) * n] for i, leaf in enumerate(rows)}
    rows_of.update({k: np.where(v < 0, rb - 1, v).astype(np.int32)
                    for k, v in ov_rows.items()})
    pad = np.zeros((1, rp.shape[1]), np.uint16)
    pad[:, 0::2] = 1
    pools = kinds_tensors(
        torch, bm, dev, np.concatenate([bb, np.zeros((1, 2048), np.uint32)]),
        np.concatenate([ap, np.full((1, ap.shape[1]), 0xFFFF, np.uint16)]),
        np.concatenate([ac, np.zeros(1, np.int32)]),
        np.concatenate([rp, pad]))
    batch = fixed_program(tape, [KINDS_TREES[i] for i in FIXED_TREES],
                          rows_of, delta)
    prog_np, gidx_np = (vm_batch_program(tape, batch, rb - 1) if delta
                        else tape.vm_program(batch, rb - 1, 4, 4))
    return len(batch), pools, prog_np, gidx_np


def phase_k3k_fixed(torch, ck, tape, bm, kp, dev, seed: int,
                    card: dict, delta: bool = False) -> dict:
    """K3-kinds on its fixed launch (``k3k_fixed_launch``)."""
    live, pools, prog_np, gidx_np = k3k_fixed_launch(torch, tape, bm, kp,
                                                     dev, seed, delta)
    what = " under dfuse overlays" if delta else ""
    return k3k_timing(torch, ck, f"a fixed launch (B={FIXED_B}, "
                      f"D={FIXED_D}, array, run and bitmap rows{what})",
                      live, pools, prog_np, gidx_np, card)


# ------------------------------------------------------------ result cache

#: the kernels a cache hit must not launch
# ------------------------------------------------- mutex, bool and time

FT_DAY0 = (2024, 1, 29)  # t's bits are stamped on 7 days from here
FT_DAYS = 7
FT_NEW_DAY = 7  # 2024-02-05: the day view the phase's PQL Set creates
#: m rows 1-8 take every column, at these percent shares
FT_MUTEX_SHARES = (40, 20, 10, 10, 8, 6, 4, 2)
FT_BOOL_TRUE, FT_BOOL_FALSE = 3, 5  # of 10 columns: b true, b false
FT_RUNS = 5  # warm runs of each field-types query
FT_MUTEX_MOVES = 10_000  # (row, column) pairs of the mutex /import
FT_EXPORT_SHARD = 5
FT_SCRATCH_BITS = (4000, 2500)  # field x's bits before and after recreate
FT_FIELDS = (("t", {"type": "time", "timeQuantum": "YMD"}),
             ("m", {"type": "mutex"}), ("b", {"type": "bool"}))


def ft_day(d: int) -> str:
    import datetime as dt

    return (dt.date(*FT_DAY0) + dt.timedelta(days=d)).strftime("%Y%m%d")


def field_type_data(seed: int, n_shards: int, words: int) -> dict:
    """t: rows 1 and 2 at ~8 %, each bit on one of FT_DAYS days, as
    ``days[(row, day)]``; m: every column in one of rows 1-8 at
    FT_MUTEX_SHARES; b: rows 1 (true, 30 %) and 0 (false, 50 %).  Arrays
    are uint32[n_shards, words]."""
    rng = np.random.default_rng(seed + 41)
    days = {(r, d): np.zeros((n_shards, words), dtype=np.uint32)
            for r in (1, 2) for d in range(FT_DAYS + 1)}
    m = {r: np.zeros((n_shards, words), dtype=np.uint32) for r in range(1, 9)}
    b = {r: np.zeros((n_shards, words), dtype=np.uint32) for r in (0, 1)}
    cuts = np.cumsum(FT_MUTEX_SHARES)[:-1] * (1 << 16) // 100

    def pack(mask):
        return np.packbits(mask, bitorder="little").view(np.uint32)

    for s in range(n_shards):
        for r in (1, 2):
            u = rng.integers(0, 1 << 16, size=words * 32, dtype=np.uint16)
            day = np.where(u < FILL_SPARSE, u % FT_DAYS, FT_DAYS + 1)
            for d in range(FT_DAYS):
                days[(r, d)][s] = pack(day == d)
        u = rng.integers(0, 1 << 16, size=words * 32, dtype=np.uint16)
        row = np.searchsorted(cuts, u, side="right") + 1
        for r in m:
            m[r][s] = pack(row == r)
        v = rng.integers(0, 10, size=words * 32, dtype=np.uint8)
        b[1][s] = pack(v < FT_BOOL_TRUE)
        b[0][s] = pack((v >= FT_BOOL_TRUE)
                       & (v < FT_BOOL_TRUE + FT_BOOL_FALSE))
    return {"days": days, "m": m, "b": b}


def ft_union(ft: dict, r: int, days) -> np.ndarray:
    out = np.zeros_like(ft["days"][(r, 0)])
    for d in days:
        np.bitwise_or(out, ft["days"][(r, d)], out=out)
    return out


def ft_time_views(ft: dict) -> dict:
    """View name -> {row: words} of t as the reference writes it: the
    standard view, the year, both months and one view per day."""
    all_days = range(FT_DAYS)
    jan = [d for d in all_days if ft_day(d)[4:6] == "01"]
    feb = [d for d in all_days if ft_day(d)[4:6] == "02"]
    views = {"": {r: ft_union(ft, r, all_days) for r in (1, 2)}}
    views["standard_2024"] = views[""]
    views["standard_202401"] = {r: ft_union(ft, r, jan) for r in (1, 2)}
    views["standard_202402"] = {r: ft_union(ft, r, feb) for r in (1, 2)}
    for d in all_days:
        views[f"standard_{ft_day(d)}"] = {r: ft["days"][(r, d)]
                                          for r in (1, 2)}
    return views


def ft_oracles(ft: dict, f1: np.ndarray) -> dict:
    """The numpy answers of the field-types queries."""
    m, b = ft["m"], ft["b"]
    every = range(FT_DAYS + 1)
    tstd = {r: ft_union(ft, r, every) for r in (1, 2)}
    three = ft_union(ft, 1, (1, 2, 3))
    mb = pair_counts(m, b)
    return {
        "time_3day": popcounts(three),
        "time_months": popcounts(ft_union(ft, 1, range(FT_DAYS))),
        "time_open": popcounts(ft_union(ft, 2, range(3, FT_DAYS + 1))),
        "time_noview": 0,
        "time_and_f": popcounts(three & f1),
        "time_rows": [1, 2],
        "time_topn": topn_json({r: popcounts(w & f1)
                                for r, w in tstd.items()}, 5),
        "mutex_topn": topn_json({r: popcounts(w) for r, w in m.items()}, 8),
        "mutex_topn_f": topn_json({r: popcounts(w & f1)
                                   for r, w in m.items()}, 8),
        "mutex_and_f": popcounts(m[3] & f1),
        "mutex_and_f_k2": popcounts(m[3] & f1),
        "bool_true": popcounts(b[1]),
        "bool_false_m1": popcounts(b[0] & m[1]),
        "groupby_mb": groups_json("m", "b", {
            (i, j): int(mb[ii, jj]) for ii, i in enumerate(sorted(m))
            for jj, j in enumerate(sorted(b))}),
    }


def ft_queries(n_shards: int) -> tuple:
    """(label, PQL, URL flags, {kernel: launches per run}) of the
    field-types queries.  A time-range leaf is a dense stack (the VM and
    the container engine decline it) and a bool literal is never fused,
    so neither launches a kernel; GroupBy's second level is one K5 per
    shard."""
    return (
        ("time_3day", "Count(Row(t=1, from=2024-01-30T00:00, "
                      "to=2024-02-02T00:00))", "", {}),
        ("time_months", "Count(Row(t=1, from=2024-01-01T00:00, "
                        "to=2024-03-01T00:00))", "", {}),
        ("time_open", "Count(Row(t=2, from=2024-02-01T00:00))", "", {}),
        ("time_noview", "Count(Row(t=1, from=2024-03-01T00:00, "
                        "to=2024-03-05T00:00))", "", {}),
        ("time_and_f", "Count(Intersect(Row(t=1, from=2024-01-30T00:00, "
                       "to=2024-02-02T00:00), Row(f=1)))", "", {}),
        ("time_rows", "Rows(t, from=2024-01-30T00:00, to=2024-02-02T00:00)",
         "", {}),
        ("time_topn", "TopN(t, Row(f=1), n=5)", "", {"row_counts_masked": 1}),
        ("mutex_topn", "TopN(m, n=8)", "", {}),
        ("mutex_topn_f", "TopN(m, Row(f=1), n=8)", "",
         {"row_counts_masked": 1}),
        ("mutex_and_f", "Count(Intersect(Row(m=3), Row(f=1)))", "",
         {"vm_counts": 1}),
        ("mutex_and_f_k2", "Count(Intersect(Row(m=3), Row(f=1)))",
         "?nocoalesce=true", {"gathered_count_and": 1}),
        ("bool_true", "Count(Row(b=true))", "", {}),
        ("bool_false_m1", "Count(Intersect(Row(b=false), Row(m=1)))", "", {}),
        ("groupby_mb", "GroupBy(Rows(m), Rows(b))", "",
         {"masked_matrix_counts": n_shards}),
    )


def ft_run(ck, http: Http, queries, wants: dict, runs: int, out: dict,
           tag: str = "") -> None:
    """Each query ``runs`` times, every answer equal to the oracle and
    every kernel launched exactly at its sites (the counts read around
    each query)."""
    for label, pql, flags, sites in queries:
        k0 = ck.launch_counts()
        lat = []
        for _ in range(runs):
            res, ms = http.query(pql, flags)
            lat.append(ms)
            check(res == [wants[label]],
                  f"{pql}{flags}: {str(res)[:300]} differs from the oracle "
                  f"{str(wants[label])[:300]}")
        k1 = ck.launch_counts()
        got = {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}
        want = {k: n * runs for k, n in sites.items()}
        check(got == want, f"{pql}{flags}: launched {got} in {runs} runs, "
                           f"its sites {want}")
        entry = {"pql": pql + flags, "first_ms": lat[0], "launches": got}
        if runs > 2:
            entry["warm_ms"] = spread(lat[1:])
        out[label + tag] = entry
        log(f"{label}{tag}: {pql}{flags} = oracle; launches {got}; first "
            f"{lat[0]:.2f} ms" + (f", warm {fmt(entry['warm_ms'])}"
                                  if runs > 2 else ""))


def ft_get(http: Http, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(http.uri + path, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ft_delete(http: Http, path: str) -> int:
    req = urllib.request.Request(http.uri + path, method="DELETE")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def ft_schema(width: int) -> dict:
    """The schema the served index has when the phase reads it."""
    def opts(**kw):
        d = {"type": "set", "cacheType": "ranked", "cacheSize": 50000,
             "min": 0, "max": 0, "base": 0, "bitDepth": 1, "timeQuantum": "",
             "noStandardView": False, "keys": False}
        d.update(kw)
        return d

    fields = {n: opts() for n in ("f", "g", "s", "u", "k")}
    fields["v"] = opts(type="int", min=BSI_MIN, max=BSI_MAX,
                       bitDepth=BSI_DEPTH)
    fields["t"] = opts(type="time", timeQuantum="YMD")
    fields["m"] = opts(type="mutex")
    fields["b"] = opts(type="bool")
    return {"indexes": [{
        "name": "i", "options": {"keys": False, "trackExistence": True},
        "fields": [{"name": n, "options": o} for n, o in sorted(
            fields.items())],
        "shardWidth": width}]}


def ft_moves(ck, http: Http, ft: dict, rng, n_cols: int) -> dict:
    """FT_MUTEX_MOVES (row, column) pairs through /import into m (each a
    per-bit mutex write: the column leaves its row), a PQL Set moving a
    column to m row 7 and a Set(b=true) on a false column; the oracle
    takes every write.  Returns the host-clock times."""
    m, b = ft["m"], ft["b"]
    cols = rng.choice(n_cols, size=FT_MUTEX_MOVES, replace=False)
    rows = rng.integers(1, 9, size=FT_MUTEX_MOVES)
    body = json.dumps({"rowIDs": rows.tolist(),
                       "columnIDs": cols.tolist()}).encode()
    t0 = time.perf_counter()
    st, resp = http.post("/index/i/field/m/import", body)
    import_ms = (time.perf_counter() - t0) * 1e3
    check(st == 200, f"mutex import: HTTP {st} {resp[:200]!r}")
    w, bit = cols >> 5, np.uint32(1) << (cols & 31).astype(np.uint32)
    for r, words in m.items():
        flat = words.reshape(-1)
        np.bitwise_and.at(flat, w, ~bit)
        np.bitwise_or.at(flat, w[rows == r], bit[rows == r])
    # a PQL Set moves one more column to row 7, another flips b to true
    flat7 = m[7].reshape(-1)
    col = int(next(c for c in range(n_cols)
                   if not (flat7[c >> 5] >> np.uint32(c & 31)) & 1))
    bcol = int(np.flatnonzero(np.unpackbits(
        b[0].reshape(-1)[:4096].view(np.uint8), bitorder="little"))[0])
    res, _ms = http.query(f"Set({col}, m=7) Set({bcol}, b=true)")
    check(res == [True, True], f"the mutex and bool Sets: {res}")
    for r, words in m.items():
        flat = words.reshape(-1)
        one = np.uint32(1) << np.uint32(col & 31)
        flat[col >> 5] = (flat[col >> 5] | one if r == 7
                          else flat[col >> 5] & ~one)
    one = np.uint32(1) << np.uint32(bcol & 31)
    b[0].reshape(-1)[bcol >> 5] &= ~one
    b[1].reshape(-1)[bcol >> 5] |= one
    return {"import_ms": import_ms, "bits": FT_MUTEX_MOVES}


def ft_admin(ck, srv, http: Http, ft: dict, rng, width: int,
             out: dict) -> None:
    """The schema and admin routes on the served index."""
    # GET /schema, timed
    lat = []
    for _ in range(1 + FT_RUNS):
        t0 = time.perf_counter()
        st, body = ft_get(http, "/schema")
        lat.append((time.perf_counter() - t0) * 1e3)
        check(st == 200 and json.loads(body) == ft_schema(width),
              f"GET /schema: HTTP {st} {body[:600]!r}")
    out["schema_read_ms"] = spread(lat[1:])
    log(f"GET /schema = the expected schema; warm {fmt(out['schema_read_ms'])}")
    # GET /export of one mutex shard: the oracle's CSV
    s = FT_EXPORT_SHARD
    lines = []
    for r in sorted(ft["m"]):
        offs = np.flatnonzero(np.unpackbits(ft["m"][r][s].view(np.uint8),
                                            bitorder="little"))
        lines.append("".join(f"{r},{s * width + int(o)}\n" for o in offs))
    want = "".join(lines).encode()
    t0 = time.perf_counter()
    st, body = ft_get(http, f"/export?index=i&field=m&shard={s}")
    out["export_ms"] = (time.perf_counter() - t0) * 1e3
    check(st == 200 and body == want,
          f"GET /export m shard {s}: HTTP {st}, {len(body)} bytes, the "
          f"oracle's {len(want)}")
    log(f"GET /export?field=m&shard={s}: {len(body)} bytes = the oracle's "
        f"CSV, in {out['export_ms']:.0f} ms")
    # POST /recalculate-caches, then an unfiltered TopN(m) from the ranks
    k0 = ck.launch_counts()
    st, body = http.post("/recalculate-caches", b"")
    check(st == 200 and body == b"{}", f"recalculate-caches: {st} {body!r}")
    res, ms = http.query("TopN(m, n=8)")
    check(res == [topn_json({r: popcounts(w) for r, w in ft["m"].items()},
                            8)], f"TopN(m) after recalculate: {res}")
    check(ck.launch_counts() == k0, "the ranked TopN launched a kernel")
    log(f"POST /recalculate-caches, then TopN(m, n=8) = oracle in "
        f"{ms:.2f} ms, no launch")
    # a scratch field, deleted and recreated with different bits
    n_cols = ft["m"][1].size * 32
    for i, n in enumerate(FT_SCRATCH_BITS):
        check(http.post("/index/i/field/x", b"{}")[0] == 200,
              f"create field x ({i})")
        cols = rng.choice(n_cols, size=n, replace=False)
        st, resp = http.post("/index/i/field/x/import", json.dumps(
            {"rowIDs": [1] * n, "columnIDs": cols.tolist()}).encode())
        check(st == 200, f"import into x: HTTP {st} {resp[:200]!r}")
        for flags in ("", "?nocoalesce=true", "?nodelta=1"):
            res, _ms = http.query("Count(Row(x=1))", flags)
            check(res == [n], f"Count(Row(x=1)){flags} after import {i}: "
                              f"{res}, not {n}")
        xs = np.zeros(n_cols // 32, dtype=np.uint32)
        np.bitwise_or.at(xs, cols >> 5,
                         np.uint32(1) << (cols & 31).astype(np.uint32))
        want = popcounts(xs & ft["f1"].reshape(-1))
        for flags in ("", "?nocoalesce=true"):
            res, _ms = http.query("Count(Intersect(Row(x=1), Row(f=1)))",
                                  flags)
            check(res == [want], f"x & f1{flags} after import {i}: {res}, "
                                 f"not {want}")
        if i == 0:
            check(ft_delete(http, "/index/i/field/x") == 200, "DELETE x")
            check(ft_delete(http, "/index/i/field/x") == 404,
                  "DELETE x twice")
            check(srv.holder.index("i").field("x") is None, "x survived")
    check(ft_delete(http, "/index/i/field/x") == 200, "DELETE x (2)")
    log(f"field x: created, {FT_SCRATCH_BITS[0]} bits counted, deleted, "
        f"recreated, {FT_SCRATCH_BITS[1]} other bits counted, deleted")
    for path in ("/", "/version", "/info", "/hosts", "/index", "/index/i",
                 "/debug/containers"):
        st, body = ft_get(http, path)
        check(st == 200, f"GET {path}: HTTP {st} {body[:200]!r}")
    st, body = ft_get(http, "/info")
    check(json.loads(body)["cpuType"] == f"{srv.device.type}+host",
          f"/info: {body!r}")
    log("GET /, /version, /info, /hosts, /index, /index/i and "
        "/debug/containers: 200")


def phase_field_types(ck, srv, http: Http, roaring, data: dict, cpr: int,
                      words: int, seed: int) -> dict:
    """Mutex, bool and time fields and the schema and admin routes on the
    served index (all shards):

    (a) t (time, quantum YMD): rows 1-2 at ~8 %, each bit on one of
        FT_DAYS days across a month boundary, so 11 views, loaded through
        ``POST /import-roaring/{shard}`` with a JSON ``{"views": ...}``
        body; m (mutex): every column in one of rows 1-8; b (bool): true
        on 30 %, false on 50 %.  The wire refuses roaring into m and b
        (400, as the reference); they load through the in-process
        ``Field.import_roaring``, their rows disjoint by construction;
    (b) time-range Counts (a 3-day cover, whole months, an open end, a
        range with no view), one inside an Intersect, a ranged Rows, a
        filtered TopN over t, TopN over m (K4 when filtered), a coalesced
        Count over m (K3) and the same with ?nocoalesce=true (K2), bool
        Counts and GroupBy(Rows(m), Rows(b)) (K5): each once cold and
        FT_RUNS times warm, every answer equal to the numpy oracle and
        every kernel launched exactly at its sites;
    (c) a PQL Set that creates a new day view: the open-ended Count
        includes it;
    (d) a mutex /import of FT_MUTEX_MOVES bits that moves columns, a Set
        on m and a Set(b=true) on a false column; every query again;
    (e) the admin routes: GET /schema, GET /export of an m shard, POST
        /recalculate-caches, a field deleted and recreated with other
        bits, and the read-only routes."""
    import base64

    width = words * 32
    n_cols = N_SHARDS * width
    t0 = time.perf_counter()
    ft = field_type_data(seed, N_SHARDS, words)
    views = ft_time_views(ft)
    host = sum(a.nbytes for a in {id(a): a for rows in views.values()
                                  for a in rows.values()}.values())
    log(f"field-types data: t {len(views)} views, m 8 rows, b 2 rows on "
        f"{N_SHARDS} shards, {host >> 20} MiB for t on the host, made in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, opts in FT_FIELDS:
        check(http.post(f"/index/i/field/{name}", json.dumps(
            {"options": opts}).encode())[0] == 200, f"create field {name}")
    t0 = time.perf_counter()
    sent = 0
    for s in range(N_SHARDS):
        body = json.dumps({"views": {
            vn: base64.b64encode(roaring_payload(roaring, rows, s, cpr)
                                 ).decode()
            for vn, rows in views.items()}}).encode()
        sent += len(body)
        st, resp = http.post(f"/index/i/field/t/import-roaring/{s}", body)
        check(st == 200, f"import-roaring t shard {s}: HTTP {st} "
                         f"{resp[:200]!r}")
    t1 = time.perf_counter()
    merged = compact_all()
    log(f"import: field t, {N_SHARDS} JSON view payloads, {sent} bytes, in "
        f"{t1 - t0:.1f} s, merged by one compactor scan in "
        f"{merged['ms']:.0f} ms")
    del views
    for name in ("m", "b"):
        st, resp = http.post(f"/index/i/field/{name}/import-roaring/0",
                             b'{"views": {"": ""}}')
        check(st == 400 and b"only supported for set and time fields" in resp,
              f"import-roaring into {name}: HTTP {st} {resp!r}")
        field = srv.holder.index("i").field(name)
        t0 = time.perf_counter()
        for s in range(N_SHARDS):
            field.import_roaring(s, roaring_payload(roaring, ft[name], s,
                                                    cpr))
        log(f"import: field {name} ({len(ft[name])} rows) through "
            f"Field.import_roaring in {time.perf_counter() - t0:.1f} s")
    ft["f1"] = data["f"][1]
    t0 = time.perf_counter()
    wants = ft_oracles(ft, ft["f1"])
    log(f"field-types oracles in {time.perf_counter() - t0:.1f} s")
    queries = ft_queries(N_SHARDS)
    rng = np.random.default_rng(seed + 43)

    out: dict = {"queries": {}}
    # ---- the field-types path: counts zeroed just before, read just after
    ck.reset_launch_counts()
    ft_run(ck, http, queries, wants, 1 + FT_RUNS, out["queries"])
    # (c) a new day view
    flat = ft["days"][(2, FT_NEW_DAY)].reshape(-1)
    col = int(rng.integers(0, n_cols))
    while any((ft["days"][(2, d)].reshape(-1)[col >> 5] >> np.uint32(
            col & 31)) & 1 for d in range(FT_DAYS)):
        col += 1
    res, _ms = http.query(f"Set({col}, t=2, 2024-02-05T10:00)")
    check(res == [True], f"the new day view's Set: {res}")
    flat[col >> 5] |= np.uint32(1) << np.uint32(col & 31)
    wants = ft_oracles(ft, ft["f1"])
    ft_run(ck, http, [q for q in queries if q[0] in ("time_open",
                                                    "time_topn")],
           wants, 2, out["queries"], tag="_new_day")
    # (d) mutex moves
    out["moves"] = ft_moves(ck, http, ft, rng, n_cols)
    wants = ft_oracles(ft, ft["f1"])
    ft_run(ck, http, queries, wants, 2, out["queries"], tag="_after_moves")
    out["launches"] = ck.launch_counts()
    # ---- end of the field-types path
    log(f"field-types path launches: {out['launches']}; the mutex import "
        f"of {FT_MUTEX_MOVES} bits in {out['moves']['import_ms']:.0f} ms")
    for k in ("gathered_count_and", "vm_counts", "row_counts_masked",
              "masked_matrix_counts"):
        check(out["launches"][k] > 0, f"{k} never launched on the "
                                      f"field-types path")
    # (e) the admin routes
    ft_admin(ck, srv, http, ft, rng, width, out)
    q = out["queries"]
    out["times"] = {"time_range_count_ms": q["time_3day"]["warm_ms"],
                    "mutex_topn_ms": q["mutex_topn"]["warm_ms"],
                    "mutex_topn_filtered_ms": q["mutex_topn_f"]["warm_ms"],
                    "groupby_ms": q["groupby_mb"]["warm_ms"],
                    "schema_read_ms": out["schema_read_ms"]}
    log("field-types times (host clock): " + "; ".join(
        f"{k} {fmt(v)}" for k, v in out["times"].items()))
    return out


KEYS_ROWS = 16  # row keys of the keyed set field kf on the served index
KEYS_FILL = 82  # of 1024: kf's rows at ~8 % fill
KEYS_COLUMNS = 500_000  # column keys of the keyed index ki (1,000,000
#                          before the residency phase: the first depth cut)
KEYS_ROW_KEYS = 8  # row keys of ki's field kr
KEYS_BATCH = 100_000  # bits of each protobuf /import into ki
KEYS_COLUMN_ATTRS = 1000  # columns of ki with attributes
KEYS_RUNS = 5  # warm runs of each keyed query
PB = "application/x-protobuf"


def keyed_rows(rng, n_rows: int, n_shards: int, words: int) -> dict:
    """Row index -> uint32[n_shards, words] at fill KEYS_FILL / 1024, the
    words combined as graded_rows combines them."""
    rows = {}
    for r in range(n_rows):
        x = None
        for b in range(FILL_BITS):
            bit = (KEYS_FILL >> b) & 1
            if x is None:
                if bit:
                    x = rng.integers(0, 2 ** 32, size=(n_shards, words),
                                     dtype=np.uint32)
                continue
            w = rng.integers(0, 2 ** 32, size=(n_shards, words),
                             dtype=np.uint32)
            (np.bitwise_or if bit else np.bitwise_and)(x, w, out=x)
        rows[r] = x
    return rows


def pb_post(http: Http, path: str, body: bytes, accept: bool = True
            ) -> tuple[int, bytes, float]:
    """A protobuf body, the answer in protobuf when ``accept``; the
    status, the body and the host-clock ms."""
    req = urllib.request.Request(http.uri + path, data=body, method="POST")
    req.add_header("Content-Type", PB)
    if accept:
        req.add_header("Accept", PB)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            st, out = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        st, out = e.code, e.read()
    return st, out, (time.perf_counter() - t0) * 1e3


def pb_query(proto, http: Http, pql: str, flags: str = "",
             index: str = "i", **req) -> tuple[dict, float]:
    """A protobuf QueryRequest answered in protobuf, with ?nocache=1:
    the decoded QueryResponse and the host-clock ms."""
    flags += ("&" if "?" in flags else "?") + "nocache=1"
    body = proto.encode(proto.QUERY_REQUEST, dict(query=pql, **req))
    st, out, ms = pb_post(http, f"/index/{index}/query{flags}", body)
    resp = proto.decode(proto.QUERY_RESPONSE, out)
    check(st == 200 and resp["err"] == "",
          f"{pql}{flags} (protobuf): HTTP {st} {resp['err']!r}")
    return resp, ms


def pb_plain(proto, resp: dict) -> list:
    """A decoded QueryResponse's results as JSON-able values: a Row's
    columns and keys and attributes, pairs as (key or id, count), groups
    as ((field, row id, row key), ...) and a count."""
    out = []
    for r in resp["results"]:
        res = proto.proto_to_result(r)
        if r["type"] == proto.TYPE_ROW:
            out.append({"columns": res.columns().tolist(),
                        "keys": list(res.keys), "attrs": res.attrs})
        elif r["type"] == proto.TYPE_PAIRS:
            out.append([[p.key or p.id, p.count] for p in res])
        elif r["type"] == proto.TYPE_GROUP_COUNTS:
            out.append([[[[fr.field, fr.row_id, fr.row_key]
                          for fr in g.group], g.count] for g in res])
        else:
            out.append(res)
    return out


def keys_queries(n_shards: int) -> tuple:
    """(label, PQL, URL flags, index, QueryRequest fields, {kernel:
    launches per run}) of the keyed path.  A keyed row is a bitmap row of
    the same index, so its Counts, TopNs and GroupBys reach the kernels
    their id forms reach; the keyed index ki lives on one shard, so its
    reads take the per-shard routes and launch nothing."""
    return (
        ("count_k3_f1", 'Count(Intersect(Row(kf="k3"), Row(f=1)))', "",
         "i", {}, {"vm_counts": 1}),
        ("count_k3_f1_k2", 'Count(Intersect(Row(kf="k3"), Row(f=1)))',
         "?nocoalesce=true", "i", {}, {"gathered_count_and": 1}),
        ("topn_kf_f1", "TopN(kf, Row(f=1), n=5)", "", "i", {},
         {"row_counts_masked": 1}),
        ("topn_kf_f1_attr", 'TopN(kf, Row(f=1), n=5, attrName="tier", '
                            'attrValues=["gold"])', "", "i", {},
         {"row_counts_masked": 1}),
        ("groupby_kf_f", "GroupBy(Rows(kf), Rows(f))", "", "i", {},
         {"masked_matrix_counts": n_shards}),
        ("row_k3_attrs", 'Row(kf="k3")', "", "i",
         {"excludeColumns": True}, {}),
        ("row_k3_shard5", 'Row(kf="k3")', "", "i", {"shards": [5]}, {}),
        ("rows_kf", "Rows(kf)", "", "i", {}, {}),
        ("row_r1_column_attrs", 'Options(Row(kr="r1"), columnAttrs=true)',
         "", "ki", {}, {}),
        ("count_r2", 'Count(Row(kr="r2"))', "", "ki", {}, {}),
        ("rows_kr", "Rows(kr)", "", "ki", {}, {}),
        ("row_missing", 'Count(Intersect(Row(kf="nope"), Row(f=1)))', "",
         "i", {}, {}),
    )


def keys_oracles(kd: dict, f: dict) -> dict:
    """The numpy answers of the keyed path, as pb_plain gives them."""
    kf, ids = kd["kf"], kd["kf_ids"]
    keys = [f"k{r}" for r in range(KEYS_ROWS)]
    f1 = f[1]
    by_f1 = {k: popcounts(kf[r] & f1) for r, k in enumerate(keys)}

    def topn(keep) -> list:
        order = sorted((k for k in keys if by_f1[k] > 0 and keep(k)),
                       key=lambda k: (-by_f1[k], ids[k]))
        return [[k, by_f1[k]] for k in order[:5]]

    pc = pair_counts(kf, f)
    fr = sorted(f)
    groups = [[[["kf", ids[keys[i]], keys[i]], ["f", fr[j], ""]],
               int(pc[i, j])]
              for i in sorted(range(KEYS_ROWS), key=lambda i: ids[keys[i]])
              for j in range(len(fr)) if pc[i, j] > 0]
    k3 = kf[3]
    shard5 = (np.nonzero(np.unpackbits(k3[5].view(np.uint8),
                                       bitorder="little"))[0]
              + 5 * k3.shape[1] * 32).tolist()
    rk, ck_ = kd["ki_rows"], kd["ki_cols"]
    r1 = np.flatnonzero(rk == 1)
    attrs = kd["ki_attrs"]
    col_attrs = [{"key": ck_[p], "attrs": attrs[p]}
                 for p in r1 if p in attrs]
    return {
        "count_k3_f1": [by_f1["k3"]],
        "count_k3_f1_k2": [by_f1["k3"]],
        "topn_kf_f1": [topn(lambda k: True)],
        "topn_kf_f1_attr": [topn(lambda k: kd["tier"][k] == "gold")],
        "groupby_kf_f": [groups],
        "row_k3_attrs": [{"columns": [], "keys": [],
                          "attrs": kd["row_attrs"]["k3"]}],
        "row_k3_shard5": [{"columns": shard5, "keys": [],
                           "attrs": kd["row_attrs"]["k3"]}],
        "rows_kf": [{"keys": sorted(keys, key=lambda k: ids[k])}],
        "row_r1_column_attrs": ([{"columns": [], "keys": [ck_[p] for p in r1],
                                  "attrs": {}}], col_attrs),
        "count_r2": [int((rk == 2).sum())],
        "rows_kr": [{"keys": [f"r{i}" for i in kd["ki_row_order"]]}],
        "row_missing": [0],
    }


def keys_answer(proto, label: str, resp: dict):
    """A keyed query's decoded answer in the oracle's form."""
    got = pb_plain(proto, resp)
    if label == "row_r1_column_attrs":
        row = dict(got[0], columns=[])
        sets = [{"key": a["key"], "attrs": proto.proto_to_attrs(a["attrs"])}
                for a in resp["columnAttrSets"]]
        return [row], sets
    if label in ("rows_kf", "rows_kr"):
        ri = resp["results"][0]["rowIdentifiers"]
        return [{"keys": list(ri["keys"])}]
    return got


def phase_keys(ck, srv, http: Http, roaring, data: dict, cpr: int,
               words: int, seed: int) -> dict:
    """String keys, attributes and protobuf bodies, the wire surface of a
    stock Pilosa client, on the served index (all shards) and a keyed
    index:

    (a) kf: a keyed set field on index i, KEYS_ROWS row keys at ~8 %;
        their ids from ``POST /internal/translate/keys`` sent and answered
        in protobuf; the bits by id through ``/import-roaring/{shard}``
        in protobuf ImportRoaringRequests, as a bulk loader sends them;
        row attributes on all its rows;
    (b) ki: a keyed index with KEYS_COLUMNS column keys and a keyed field
        kr of KEYS_ROW_KEYS row keys, every column key once, loaded
        through protobuf ``/import`` (rowKeys/columnKeys) in batches of
        KEYS_BATCH bits; the lookup rate of KEYS_BATCH of the keys through
        ``/internal/translate/keys``; KEYS_COLUMN_ATTRS column attributes
        in one PQL request;
    (c) protobuf QueryRequests answered in protobuf, each once cold and
        KEYS_RUNS times warm with ?nocache=1: a keyed Count(Intersect)
        coalesced (K3) and with ?nocoalesce=true (K2), a keyed filtered
        TopN with and without attrName (K4), GroupBy(Rows(kf), Rows(f))
        (K5 per shard), Row(kf="k3") with its attributes (all shards with
        excludeColumns, and shard 5), keyed Rows, and on ki
        Options(Row(kr="r1"), columnAttrs=true), a Count and Rows; every
        answer equal to the numpy oracle built from the phase's own keys
        and bits, every kernel launched exactly at its sites;
    (d) the same Count in JSON and in protobuf, timed.

    Launch counts are zeroed at the start of (c) and read at its end."""
    from pilosa_tpu_torch import proto

    out: dict = {"queries": {}, "times": {}}
    rng = np.random.default_rng(seed + 61)
    t0 = time.perf_counter()
    kf = keyed_rows(rng, KEYS_ROWS, N_SHARDS, words)
    keys = [f"k{r}" for r in range(KEYS_ROWS)]
    log(f"keys data: kf {KEYS_ROWS} rows at {KEYS_FILL}/1024 on "
        f"{N_SHARDS} shards, made in {time.perf_counter() - t0:.1f} s")

    # (a) kf: ids from the translate route, bits by id through roaring
    check(http.post("/index/i/field/kf", b'{"options": {"keys": true}}'
                    )[0] == 200, "create keyed field kf")
    st, body, ms = pb_post(http, "/internal/translate/keys", proto.encode(
        proto.TRANSLATE_KEYS_REQUEST, {"index": "i", "field": "kf",
                                       "keys": keys}))
    check(st == 200, f"translate kf keys: HTTP {st} {body[:200]!r}")
    id_list = proto.decode(proto.TRANSLATE_KEYS_RESPONSE, body)["ids"]
    check(id_list == list(range(1, KEYS_ROWS + 1)),
          f"kf's ids: {id_list}")
    ids = dict(zip(keys, id_list))
    by_id = {ids[k]: kf[r] for r, k in enumerate(keys)}
    t0 = time.perf_counter()
    sent = 0
    for s in range(N_SHARDS):
        blob = proto.encode(proto.IMPORT_ROARING_REQUEST, {"views": [
            {"name": "", "data": roaring_payload(roaring, by_id, s, cpr)}]})
        sent += len(blob)
        st, resp, _ = pb_post(http, f"/index/i/field/kf/import-roaring/{s}",
                              blob)
        check(st == 200 and resp == b"", f"import-roaring kf shard {s}: "
                                         f"HTTP {st} {resp[:200]!r}")
    t1 = time.perf_counter()
    merged = compact_all()
    out["times"]["kf_import_s"] = t1 - t0
    log(f"import: field kf, {N_SHARDS} protobuf roaring payloads, {sent} "
        f"bytes, in {t1 - t0:.1f} s; merged by one compactor scan in "
        f"{merged['ms']:.0f} ms")
    tier = {k: ("gold" if r % 3 == 0 else "silver")
            for r, k in enumerate(keys)}
    row_attrs = {k: {"tier": tier[k], "rank": r} for r, k in enumerate(keys)}
    res, _ms = http.query(" ".join(
        f'SetRowAttrs(kf, "{k}", tier="{tier[k]}", rank={r})'
        for r, k in enumerate(keys)))
    check(res == [None] * KEYS_ROWS, f"SetRowAttrs: {res}")

    # (b) ki: 1M column keys through protobuf /import
    check(http.post("/index/ki", b'{"options": {"keys": true}}')[0] == 200,
          "create keyed index ki")
    check(http.post("/index/ki/field/kr", b'{"options": {"keys": true}}'
                    )[0] == 200, "create keyed field kr")
    perm = rng.permutation(KEYS_COLUMNS)
    col_keys = [f"u{int(n):07d}" for n in perm]
    ki_rows = rng.integers(0, KEYS_ROW_KEYS, size=KEYS_COLUMNS)
    row_key = [f"r{i}" for i in range(KEYS_ROW_KEYS)]
    lat = []
    t0 = time.perf_counter()
    for lo in range(0, KEYS_COLUMNS, KEYS_BATCH):
        body = proto.encode(proto.IMPORT_REQUEST, {
            "index": "ki", "field": "kr",
            "rowKeys": [row_key[r] for r in ki_rows[lo:lo + KEYS_BATCH]],
            "columnKeys": col_keys[lo:lo + KEYS_BATCH]})
        st, resp, ms = pb_post(http, "/index/ki/field/kr/import", body)
        check(st == 200 and resp == b"", f"keyed import at {lo}: HTTP {st} "
                                         f"{resp[:200]!r}")
        lat.append(ms)
    load_s = time.perf_counter() - t0
    compact_all()
    # the lookup rate: a batch of existing keys from across the import,
    # whose ids are their positions in it
    pos = np.sort(rng.choice(KEYS_COLUMNS, KEYS_BATCH, replace=False))
    t0 = time.perf_counter()
    st, body, _ = pb_post(http, "/internal/translate/keys", proto.encode(
        proto.TRANSLATE_KEYS_REQUEST, {"index": "ki", "keys": [
            col_keys[p] for p in pos]}))
    lookup_s = time.perf_counter() - t0
    check(st == 200, f"translate ki keys: HTTP {st}")
    check(proto.decode(proto.TRANSLATE_KEYS_RESPONSE, body)["ids"]
          == (pos + 1).tolist(), "ki's ids are not the import order")
    out["times"].update({
        "ki_import_batch_ms": spread(lat),
        "ki_import_keys_per_s": KEYS_COLUMNS / load_s,
        "ki_lookup_keys_per_s": KEYS_BATCH / lookup_s})
    log(f"import: ki, {KEYS_COLUMNS} column keys and {KEYS_ROW_KEYS} row "
        f"keys in {KEYS_COLUMNS // KEYS_BATCH} protobuf /imports, "
        f"{load_s:.1f} s ({KEYS_COLUMNS / load_s:.0f} keys/s, created with "
        f"their bits), batch {fmt(spread(lat))}; {KEYS_BATCH} of them "
        f"looked up through /internal/translate/keys in "
        f"{lookup_s * 1e3:.0f} ms ({KEYS_BATCH / lookup_s:.0f} keys/s)")
    attr_pos = sorted(int(p) for p in rng.choice(KEYS_COLUMNS,
                                                 KEYS_COLUMN_ATTRS,
                                                 replace=False))
    ki_attrs = {p: {"seg": f"s{p % 5}", "w": p % 97} for p in attr_pos}
    st, body = http.post("/index/ki/query?nocache=1", " ".join(
        f'SetColumnAttrs("{col_keys[p]}", seg="s{p % 5}", w={p % 97})'
        for p in attr_pos).encode(), "text/plain")
    check(st == 200, f"SetColumnAttrs: HTTP {st} {body[:200]!r}")
    first_seen = []
    for r in ki_rows:
        if int(r) not in first_seen:
            first_seen.append(int(r))
    kd = {"kf": kf, "kf_ids": ids, "tier": tier, "row_attrs": row_attrs,
          "ki_rows": ki_rows, "ki_cols": col_keys, "ki_attrs": ki_attrs,
          "ki_row_order": first_seen}
    t0 = time.perf_counter()
    wants = keys_oracles(kd, data["f"])
    log(f"keys oracles in {time.perf_counter() - t0:.1f} s")

    # (c) the keyed path: counts zeroed just before, read just after
    queries = keys_queries(N_SHARDS)
    ck.reset_launch_counts()
    for label, pql, flags, index, req, sites in queries:
        k0 = ck.launch_counts()
        lat = []
        for _ in range(1 + KEYS_RUNS):
            resp, ms = pb_query(proto, http, pql, flags, index, **req)
            lat.append(ms)
            got = keys_answer(proto, label, resp)
            check(got == wants[label],
                  f"{pql}{flags} {req}: {str(got)[:300]} differs from the "
                  f"oracle {str(wants[label])[:300]}")
        k1 = ck.launch_counts()
        got = {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}
        want = {k: n * (1 + KEYS_RUNS) for k, n in sites.items()}
        check(got == want, f"{pql}{flags}: launched {got}, its sites {want}")
        out["queries"][label] = {"pql": pql + flags, "request": req,
                                 "first_ms": lat[0],
                                 "warm_ms": spread(lat[1:]),
                                 "launches": got}
        log(f"keys {label}: {pql}{flags} {req} (protobuf) = oracle; "
            f"launches {got}; first {lat[0]:.2f} ms, warm "
            f"{fmt(spread(lat[1:]))}")
    out["launches"] = ck.launch_counts()
    # ---- end of the keyed path
    for k in ("gathered_count_and", "vm_counts", "row_counts_masked",
              "masked_matrix_counts"):
        check(out["launches"][k] > 0, f"{k} never launched on the keyed "
                                      f"path")
    # (d) the same Count in JSON and in protobuf
    pql = 'Count(Intersect(Row(kf="k3"), Row(f=1)))'
    js, pb = [], []
    for _ in range(1 + KEYS_RUNS):
        res, ms = http.query(pql)
        check(res == wants["count_k3_f1"], f"{pql} (JSON): {res}")
        js.append(ms)
        resp, ms = pb_query(proto, http, pql)
        pb.append(ms)
    out["times"]["count_json_ms"] = spread(js[1:])
    out["times"]["count_protobuf_ms"] = spread(pb[1:])
    st, body = ft_get(http, "/schema")
    schema = {ix["name"]: ix for ix in json.loads(body)["indexes"]}
    check(schema["ki"]["options"]["keys"]
          and any(fd["name"] == "kf" and fd["options"]["keys"]
                  for fd in schema["i"]["fields"]),
          "GET /schema does not show the keys")
    log("keys times (host clock): " + "; ".join(
        f"{k} {fmt(v) if isinstance(v, dict) else f'{v:.1f}'}"
        for k, v in out["times"].items()))
    return out


# ------------------------------------------------------------ admission

ADMISSION_RUNS = 10  # warm one-client Counts, admission on and off each
ADMISSION_ROUNDS = 5  # 16-client rounds in each of the on/off turns
ADMISSION_TURNS = 2  # on, off, on, off
ADMISSION_DROP_ROUNDS = 5  # in-window rounds: live and expiring members
ADMISSION_EXPIRING = 8  # expiring members of each in-window round
ADMISSION_TIGHT = 10  # tight-budget Counts past the window
ADMISSION_CAP = 2  # query cap and queue of the overload leg's controller
ADMISSION_OVERLOAD_ROUNDS = 4  # 16-client rounds past those caps
ACQUIRE_CALLS = 20_000  # uncontended acquire + release pairs timed


def adm_send(http: Http, pql: str, headers: dict, flags: str = "?nocache=1"
             ) -> tuple[int, str | None, bytes]:
    """A query with extra headers: (status, Retry-After, body)."""
    req = urllib.request.Request(http.uri + "/index/i/query" + flags,
                                 data=pql.encode(), method="POST")
    req.add_header("Content-Type", "text/plain")
    for k, v in headers.items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers.get("Retry-After"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), e.read()


def adm_doc(http: Http) -> dict:
    """GET /debug/admission."""
    with urllib.request.urlopen(http.uri + "/debug/admission",
                                timeout=600) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def gate(srv, ctrl):
    """``ctrl`` as the running handler's admission controller, with the
    thread cap the server's constructor gives it; the server's own
    controller back on exit."""
    h = srv.handler
    was = (srv.admission, h.admission, h.max_threads)
    srv.admission = h.admission = ctrl
    h.max_threads = (ctrl.total_capacity() + h.ACCEPT_HEADROOM
                     if ctrl.enabled else None)
    try:
        yield ctrl
    finally:
        srv.admission, h.admission, h.max_threads = was


def flush_spy(coalescer, expired_error):
    """Per flush of ``coalescer``: (members, members it dropped as
    expired), read from the members' futures once the flush resolved
    them."""
    seen: list = []
    real = coalescer._flush

    def spy(bucket):
        real(bucket)
        seen.append((len(bucket.items), sum(
            1 for it in bucket.items
            if isinstance(it.fut.exception(timeout=0), expired_error))))

    coalescer._flush = spy
    return seen, real


def phase_admission(ck, tape, srv, data: dict, card: dict) -> dict:
    """Admission control and request deadlines ([admission], on by default)
    on the served index, every query with ?nocache=1 or cache=False:

    (a) an expired request: ``X-Pilosa-Deadline: 0`` on the K2/K3 Count
        is 503 with the reference's body and Retry-After, a budget of
        ``2e-5`` s is 503 too, and a malformed header is 400; K2 and K3
        launch nothing;
    (b) coalesced rounds of the 16 trees from 16 clients with a generous
        deadline, every answer the oracle's, K3 launches equal to
        vm.executions;
    (c) in-window rounds, in process at the server's coalescer (a member
        that passes the executor's bypass has more than two windows left
        and waits at most one, so over HTTP only a stalled host expires
        one there): the 16 trees live and ADMISSION_EXPIRING of them with
        a budget of half a window, started before the barrier, so that it
        has run out at every flush; every live count the oracle's, every
        expiring member DeadlineExceededError (the handler's 503), K3
        launched for the live members only, and at least one flush with
        live and expired members together;
    (d) a tight budget (1.9 windows) through the API: the window is
        bypassed, the Count is K2 and the oracle's;
    (e) overload: a controller with query cap and queue ADMISSION_CAP
        handed to the running handler; 16 barrier-started clients for
        ADMISSION_OVERLOAD_ROUNDS rounds, every shed 429 or 503 with
        Retry-After, every admitted answer the oracle's, and the
        controller's /debug/admission totals equal to the responses;
    (f) host-clock costs: the warm one-client coalesced Count with the
        gate on and off (a disabled controller, as admission_enabled=False
        builds), alternating; 16-client rounds on and off, alternating;
        one uncontended acquire and release.

    Launch counts are zeroed at the start and read at the end."""
    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.serve import deadline as dlmod
    from pilosa_tpu_torch.serve.admission import AdmissionController

    t_phase = time.perf_counter()
    http = Http(srv.uri, nocache=True)
    co = srv.coalescer
    window = co.window_s
    out: dict = {"window_ms": window * 1e3}
    compact_all()  # the phase reads base rows: K2 for a lone Count
    doc = adm_doc(http)
    check(doc["enabled"] and srv.admission.enabled,
          "admission is off by default")
    check({k: (c["cap"], c["queueDepth"]) for k, c in doc["classes"].items()}
          == {"query": (32, 128), "ingest": (16, 64), "internal": (16, 64)},
          f"the gate's caps are not the reference's defaults: {doc}")
    tree = ("and", ("f", 1), ("f", 2))
    pql = f"Count({tree_pql(tree)})"
    want = oracle(tree, data)
    wants = [oracle(t, data) for t in TREES]
    idx = srv.holder.index("i")
    shards = tuple(range(N_SHARDS))
    ck.reset_launch_counts()
    tape.reset_counters()

    # (a) expired and malformed deadlines
    k0, vm0 = ck.launch_counts(), tape.counters()["vm.executions"]
    st, ra, expired = adm_send(http, pql, {"X-Pilosa-Deadline": "0"})
    check(st == 503 and ra is not None, f"an expired request: {st} {ra}")
    ref_body = json.dumps({
        "error": f"query request expired (admission control; retry after "
                 f"{ra}s)", "reason": "expired", "class": "query"}).encode()
    check(expired == ref_body, f"the expired body {expired!r}, the "
                               f"reference's {ref_body!r}")
    tiny = [adm_send(http, pql, {"X-Pilosa-Deadline": "2e-5"})[0]
            for _ in range(5)]
    check(set(tiny) == {503}, f"a 20 us budget answered {tiny}")
    st, _ra, body = adm_send(http, pql, {"X-Pilosa-Deadline": "soon"})
    check(st == 400 and body == json.dumps(
        {"error": "invalid X-Pilosa-Deadline header: 'soon'"}).encode(),
        f"a malformed deadline: {st} {body!r}")
    moved = launched(k0, ck.launch_counts())
    check(not moved and tape.counters()["vm.executions"] == vm0,
          f"expired requests launched {moved}")
    out["expired"] = {"status": 503, "retry_after": ra,
                      "tiny_budget_statuses": tiny}
    log(f"admission (a): X-Pilosa-Deadline 0 -> 503 Retry-After {ra}, "
        f"{expired!r} == the reference's; 2e-5 s x5 -> {tiny}; 'soon' -> 400; "
        f"K2 and K3 launches unchanged ({k0['gathered_count_and']}, "
        f"{k0['vm_counts']})")

    # (b) coalesced rounds with a generous deadline, after one round that
    # stages the compacted rows' leaves again
    fire_rounds(http, TREES, wants, 1)
    k0, vm0 = ck.launch_counts(), tape.counters()
    lat, wall = fire_rounds(http, TREES, wants, ADMISSION_ROUNDS,
                            headers={"X-Pilosa-Deadline": "30"})
    vm1, k1 = tape.counters(), ck.launch_counts()
    execs = vm1["vm.executions"] - vm0["vm.executions"]
    check(vm1["vm.queries"] - vm0["vm.queries"]
          == len(TREES) * ADMISSION_ROUNDS, "a deadlined query left the VM")
    check(k1["vm_counts"] - k0["vm_counts"] == execs > 0,
          f"K3 {k1['vm_counts'] - k0['vm_counts']} for {execs} executions")
    out["deadlined_rounds"] = {"queries": len(TREES) * ADMISSION_ROUNDS,
                               "k3_launches": execs,
                               "latency_ms": spread(lat),
                               "qps": len(lat) / wall}
    log(f"admission (b): {len(TREES)} trees x {ADMISSION_ROUNDS} rounds with "
        f"X-Pilosa-Deadline 30, every answer exact, {execs} K3 launches; "
        f"per request {fmt(out['deadlined_rounds']['latency_ms'])}")

    # (c) members expiring in the window, at the coalescer
    budget = window / 2
    children = [parse(f"Count({tree_pql(t)})").calls[0].children[0]
                for t in TREES]
    dropped_with_live = 0
    live_q = expired_n = 0
    k0, vm0 = ck.launch_counts(), tape.counters()
    seen, real_flush = flush_spy(co, dlmod.DeadlineExceededError)
    try:
        for _ in range(ADMISSION_DROP_ROUNDS):
            n = len(TREES) + ADMISSION_EXPIRING
            bar = threading.Barrier(n)
            got: dict = {}
            errs: list = []

            def member(i):
                # the budget starts before the barrier: every flush comes
                # a window after its first member joined, so a budget
                # under one window has run out by then
                dl = None if i < len(TREES) else dlmod.Deadline(budget)
                try:
                    bar.wait(timeout=600)
                    c = children[i % len(TREES)]
                    got[i] = co.count(srv.executor, idx, c, shards,
                                      deadline=dl)
                except dlmod.DeadlineExceededError as e:
                    got[i] = e
                except Exception as e:  # noqa: BLE001 -- reported below
                    errs.append(f"{type(e).__name__}: {e}")

            ts = [threading.Thread(target=member, args=(i,))
                  for i in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            check(not errs and len(got) == n, f"in-window round: {errs}")
            for i in range(len(TREES)):
                check(got[i] == wants[i], f"a live member: {got[i]}, "
                                          f"oracle {wants[i]}")
            for i in range(len(TREES), n):
                check(isinstance(got[i], dlmod.DeadlineExceededError),
                      f"an expiring member answered {got[i]}")
            live_q += len(TREES)
            expired_n += ADMISSION_EXPIRING
    finally:
        co._flush = real_flush
    vm1, k1 = tape.counters(), ck.launch_counts()
    execs = vm1["vm.executions"] - vm0["vm.executions"]
    dropped_with_live = sum(1 for m, d in seen if 0 < d < m)
    check(vm1["vm.queries"] - vm0["vm.queries"] == live_q,
          f"vm.queries {vm1['vm.queries'] - vm0['vm.queries']} for "
          f"{live_q} live members: an expired member reached the VM")
    check(k1["vm_counts"] - k0["vm_counts"] == execs > 0,
          f"K3 {k1['vm_counts'] - k0['vm_counts']} for {execs} executions")
    check(sum(d for _m, d in seen) == expired_n,
          f"{sum(d for _m, d in seen)} expired at flush of {expired_n}")
    check(dropped_with_live > 0, f"no flush held live and expired members "
                                 f"together: {seen}")
    out["in_window"] = {"budget_ms": budget * 1e3, "rounds":
                        ADMISSION_DROP_ROUNDS, "live": live_q,
                        "expired": expired_n, "flushes": len(seen),
                        "mixed_flushes": dropped_with_live,
                        "k3_launches": execs}
    log(f"admission (c): window {window * 1e3:.3f} ms, expiring budget "
        f"{budget * 1e3:.3f} ms; {ADMISSION_DROP_ROUNDS} rounds of "
        f"{len(TREES)} live + {ADMISSION_EXPIRING} expiring members: "
        f"{len(seen)} flushes, {dropped_with_live} with live and expired "
        f"members together; every live count exact, every expiring member "
        f"DeadlineExceededError; vm.queries {live_q} (live only), "
        f"{execs} K3 launches")

    # (d) a tight budget bypasses the window
    tight = 1.9 * window
    k0, vm0 = ck.launch_counts(), tape.counters()["vm.executions"]
    for _ in range(ADMISSION_TIGHT):
        with dlmod.scope(dlmod.Deadline(tight)):
            res = srv.api.query("i", pql, cache=False)
        check(res == [want], f"tight {pql}: {res}, oracle {want}")
    k1 = ck.launch_counts()
    check(k1["gathered_count_and"] - k0["gathered_count_and"]
          == ADMISSION_TIGHT and tape.counters()["vm.executions"] == vm0
          and k1["vm_counts"] == k0["vm_counts"],
          f"tight budgets: {launched(k0, k1)}, not {ADMISSION_TIGHT} K2")
    with dlmod.scope(dlmod.Deadline(30.0)):
        res = srv.api.query("i", pql, cache=False)
    check(res == [want] and tape.counters()["vm.executions"] == vm0 + 1,
          "a generous budget did not take the window")
    out["tight"] = {"budget_ms": tight * 1e3, "queries": ADMISSION_TIGHT}
    log(f"admission (d): budget {tight * 1e3:.3f} ms (< 2 windows) x "
        f"{ADMISSION_TIGHT} through the API: K2 each, no VM execution; "
        f"30 s: one VM execution")

    # (e) overload past small caps
    ctrl = AdmissionController(query_cap=ADMISSION_CAP,
                               query_queue=ADMISSION_CAP)
    statuses: list = []
    k0 = ck.launch_counts()
    with gate(srv, ctrl):
        for _ in range(ADMISSION_OVERLOAD_ROUNDS):
            bar = threading.Barrier(len(TREES))
            resp: dict = {}

            def client(i):
                bar.wait(timeout=600)
                resp[i] = adm_send(http, f"Count({tree_pql(TREES[i])})", {})

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(len(TREES))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            check(len(resp) == len(TREES), "an overload client hung")
            for i, (st, ra, body) in resp.items():
                statuses.append(st)
                if st == 200:
                    check(json.loads(body)["results"] == [wants[i]],
                          f"an admitted answer differs: {body!r}")
                else:
                    check(st in (429, 503) and ra is not None,
                          f"a shed answered {st} Retry-After {ra}")
                    check(json.loads(body)["class"] == "query",
                          f"a shed body {body!r}")
        doc = adm_doc(http)
    q = doc["classes"]["query"]
    ok = statuses.count(200)
    shed = len(statuses) - ok
    check(q["admitted"] == ok and q["shed"] + q["expired"] == shed,
          f"/debug/admission {q} against {ok} answered, {shed} shed")
    check(shed > 0 and ok > 0, f"overload: {ok} answered, {shed} shed")
    check(q["inFlight"] == 0 and q["waiting"] == 0, f"slots leaked: {q}")
    out["overload"] = {"cap": ADMISSION_CAP, "queue": ADMISSION_CAP,
                       "requests": len(statuses), "answered": ok,
                       "shed": shed, "by_status": {
                           s: statuses.count(s) for s in sorted(set(
                               statuses))},
                       "launches": launched(k0, ck.launch_counts())}
    log(f"admission (e): cap {ADMISSION_CAP} queue {ADMISSION_CAP}, "
        f"{len(TREES)} clients x {ADMISSION_OVERLOAD_ROUNDS}: "
        f"{out['overload']['by_status']}, every answer exact, every shed "
        f"with Retry-After; /debug/admission admitted {q['admitted']}, "
        f"shed {q['shed']}, expired {q['expired']}")

    # (f) host-clock costs, the gate on and off in turns
    off = AdmissionController(enabled=False)
    http.query(pql)  # warm
    lat: dict = {"on": [], "off": []}
    for _ in range(ADMISSION_RUNS):
        for mode in ("on", "off"):
            with gate(srv, srv.admission if mode == "on" else off):
                res, ms = http.query(pql)
            check(res == [want], f"{pql}: {res}, oracle {want}")
            lat[mode].append(ms)
    qps: dict = {"on": [], "off": []}
    for _ in range(ADMISSION_TURNS):
        for mode in ("on", "off"):
            with gate(srv, srv.admission if mode == "on" else off):
                ls, wall = fire_rounds(http, TREES, wants, ADMISSION_ROUNDS)
            qps[mode].append(len(ls) / wall)
    fresh = AdmissionController()
    fresh.acquire("query").release()
    t0 = time.perf_counter()
    for _ in range(ACQUIRE_CALLS):
        fresh.acquire("query").release()
    acq_us = (time.perf_counter() - t0) / ACQUIRE_CALLS * 1e6
    out["costs"] = {"count_ms": {m: spread(v) for m, v in lat.items()},
                    "qps_16": qps, "acquire_release_us": acq_us,
                    "card": card["smi"]}
    for mode in ("on", "off"):
        log(f"admission (f) {card['smi']}: {pql} one client, gate {mode}: "
            f"{fmt(out['costs']['count_ms'][mode])}")
        log(f"admission (f) {card['smi']}: 16 clients x {ADMISSION_ROUNDS} "
            f"rounds, gate {mode}: "
            + ", ".join(f"{x:.1f}" for x in qps[mode]) + " queries/s")
    log(f"admission (f) {card['smi']}: one uncontended acquire + release "
        f"{acq_us:.3f} us ({ACQUIRE_CALLS} pairs)")
    out["launches"] = ck.launch_counts()
    check(out["launches"]["gathered_count_and"] > 0
          and out["launches"]["vm_counts"] > 0,
          f"the phase launched {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"admission phase launches: {out['launches']}; "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- cache

HIT_KERNELS = ("gathered_count_and", "vm_counts", "vm_counts_kinds",
               "row_counts_masked", "masked_matrix_counts")
#: Counts that read field g alone: a write to f leaves their stamps
G_ONLY = [("and", ("g", 2), ("g", 3)), ("or", ("g", 1), ("g", 3)),
          ("xor", ("g", 2), ("g", 1))]
_RC_COUNTERS = ("hits", "misses", "fills", "invalidations", "flightJoins",
                "flightServed", "entries")


def rc_doc(http: Http) -> dict:
    """GET /debug/resultcache."""
    with urllib.request.urlopen(http.uri + "/debug/resultcache",
                                timeout=600) as resp:
        return json.loads(resp.read())


def rc_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in _RC_COUNTERS}


def launched(k0: dict, k1: dict) -> dict:
    """The launches between two ``launch_counts`` readings, by kernel."""
    return {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}


def shifted_words(m: np.ndarray, n: int) -> np.ndarray:
    """Shift's per-shard semantics on uint32[shards, words] rows: every
    bit n columns up, dropped at its shard's edge."""
    w, b = divmod(n, 32)
    out = np.zeros_like(m)
    out[:, w:] = m[:, :m.shape[1] - w]
    if b:
        prev = np.zeros_like(out)
        prev[:, 1:] = out[:, :-1]
        out = (out << np.uint32(b)) | (prev >> np.uint32(32 - b))
    return out


def cache_round(ck, http: Http, trees: list, data: dict) -> tuple:
    """One barrier-started round of ``trees`` (every answer equal to the
    oracle): (the /debug/resultcache counters' deltas, the launches)."""
    wants = [oracle(t, data) for t in trees]
    d0, k0 = rc_doc(http), ck.launch_counts()
    fire_rounds(http, trees, wants, 1)
    return rc_delta(d0, rc_doc(http)), launched(k0, ck.launch_counts())


def time_pair(http: Http, pql: str, hit_runs: int, miss_runs: int) -> dict:
    """A warm hit against a ?nocache=1 miss of ``pql``, host clock, equal
    answers."""
    want, _ms = http.query(pql, "?nocache=1")
    http.query(pql)  # fill
    hit, miss = [], []
    for _ in range(hit_runs):
        res, ms = http.query(pql)
        check(res == want, f"{pql}: a hit differs from the miss")
        hit.append(ms)
    for _ in range(miss_runs):
        res, ms = http.query(pql, "?nocache=1")
        check(res == want, f"{pql}?nocache=1 changed its answer")
        miss.append(ms)
    return {"pql": pql, "hit_ms": spread(hit), "miss_ms": spread(miss)}


def phase_cache(ck, srv, data: dict, card: dict) -> dict:
    """The result cache ([cache] enabled, the server's default) on the
    served index, every query without ?nocache=1 unless it says so.

    (a) hits: the 16 coalesced trees, twice; the second round equals the
        oracle and launches no K2, K3, K3-kinds, K4 or K5;
    (b) stamps: a Set on f row 1 waits in a delta plane (``delta_seq``);
        every Count that reads field f misses and relaunches, with the
        write in its answer, and the Counts of g alone still hit (a stamp
        covers a (field, view) over the shards, as in the reference); a
        compaction (``gen``) does the same with equal answers;
    (c) single flight: ``CACHE_FLIGHT`` concurrent identical cold Counts
        make one fill and at most one launch;
    (d) the new calls at full width: a Shift Count (the dense fused path),
        MinRow/MaxRow, Store and ClearRow against the oracle, Store and
        ClearRow moving the stamps of field f;
    (e) host-clock times of a warm hit against a ?nocache=1 miss for a
        Count, a TopN and a GroupBy, and of a Shift Count.

    Launch counts are zeroed at the start and read at the end."""
    http = Http(srv.uri)  # the cache at the server's default: on
    out: dict = {}
    ck.reset_launch_counts()
    d_start = rc_doc(http)
    check(d_start["enabled"], "the result cache is off by default")

    # (a) hits
    miss, k_miss = cache_round(ck, http, TREES, data)
    hit, k_hit = cache_round(ck, http, TREES, data)
    check(miss["misses"] == len(TREES) and miss["fills"] == len(TREES),
          f"the first round: {miss}")
    check(k_miss.get("vm_counts", 0) > 0, f"the first round launched "
                                          f"{k_miss}")
    check(hit["hits"] == len(TREES) and hit["misses"] == 0,
          f"the second round: {hit}")
    check(not any(k_hit.get(k) for k in HIT_KERNELS),
          f"the second round (all hits) launched {k_hit}")
    out["hits"] = {"first": miss, "first_launches": k_miss,
                   "second": hit, "second_launches": k_hit}
    log(f"cache (a): {len(TREES)} trees, first round {miss} with "
        f"launches {k_miss}; second round {hit}, launches {k_hit}; every "
        f"answer equal to the oracle")

    # (b) stamps: a pending delta, then a compaction
    trees = TREES + G_ONLY
    cache_round(ck, http, G_ONLY, data)
    flat = data["f"][1].reshape(-1)
    w = int(np.flatnonzero(~flat)[len(flat) // 2])
    b = int(np.flatnonzero(np.unpackbits(
        (~flat[w:w + 1]).view(np.uint8), bitorder="little"))[0])
    res, _ms = http.query(f"Set({w * 32 + b}, f=1)")
    check(res == [True], f"the cache phase's Set: {res}")
    flat[w] |= np.uint32(1) << np.uint32(b)
    out["stamps"] = {}
    for label in ("delta", "compaction"):
        if label == "compaction":
            merged = compact_all()
            check(merged["fragments"] > 0, "nothing to compact")
        moved, k_moved = cache_round(ck, http, trees, data)
        again, k_again = cache_round(ck, http, trees, data)
        check(moved["misses"] == len(TREES) and moved["hits"]
              == len(G_ONLY), f"after the {label}: {moved}")
        check(k_moved.get("vm_counts", 0) > 0,
              f"after the {label}: the misses launched {k_moved}")
        check(again["hits"] == len(trees) and not any(
            k_again.get(k) for k in HIT_KERNELS),
            f"after the {label}, refilled: {again}, launches {k_again}")
        out["stamps"][label] = {"moved": moved, "launches": k_moved,
                                "again": again}
        log(f"cache (b) {label}: the {len(TREES)} Counts over field f "
            f"missed and relaunched ({k_moved}), the {len(G_ONLY)} over g "
            f"alone hit: {moved}; then every one hit: {again}")

    # (c) single flight
    cold = ("and", ("f", 2), ("g", 1))
    pql = f"Count({tree_pql(cold)})"
    want = oracle(cold, data)
    res, _ms = http.query(pql, "?nocache=1")  # stage the leaves once
    check(res == [want], f"{pql}: {res}")
    d0, k0 = rc_doc(http), ck.launch_counts()
    bar = threading.Barrier(CACHE_FLIGHT)
    got: list = []
    errs: list = []

    def client():
        try:
            bar.wait(timeout=600)
            got.append(http.query(pql)[0])
        except Exception as e:  # noqa: BLE001 -- reported below
            errs.append(f"{type(e).__name__}: {e}")

    ts = [threading.Thread(target=client) for _ in range(CACHE_FLIGHT)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    check(not errs and len(got) == CACHE_FLIGHT, f"single flight: {errs}")
    check(all(g == [want] for g in got), "single flight: a wrong answer")
    fl = rc_delta(d0, rc_doc(http))
    k_fl = launched(k0, ck.launch_counts())
    check(fl["fills"] == 1 and fl["misses"] == 1
          and fl["hits"] == CACHE_FLIGHT - 1, f"single flight: {fl}")
    check(sum(k_fl.values()) <= 1, f"single flight launched {k_fl}")
    out["single_flight"] = {"clients": CACHE_FLIGHT, "counters": fl,
                            "launches": k_fl}
    log(f"cache (c): {CACHE_FLIGHT} concurrent identical cold {pql}: "
        f"{fl['fills']} fill, {fl['flightJoins']} flight joins, "
        f"{fl['flightServed']} served by the flight, launches {k_fl}")

    # (d) the new calls at full width
    f1 = data["f"][1]
    calls: dict = {}
    spql = f"Count(Shift(Row(f=1), n={CACHE_SHIFT}))"
    k0 = ck.launch_counts()
    res, _ms = http.query(spql, "?nocache=1")
    swant = popcounts(shifted_words(f1, CACHE_SHIFT))
    check(res == [swant], f"{spql}: {res}, oracle {swant}")
    check(not launched(k0, ck.launch_counts()),
          f"{spql} launched a kernel on the dense fused path")
    calls["shift"] = swant
    rows = {r: m for r, m in data["f"].items() if m.any()}
    g2, g3 = data["g"][2], data["g"][3]
    for q, r, filt in (("MinRow(field=f)", min(rows), None),
                       ("MaxRow(field=f)", max(rows), None),
                       ("MaxRow(Row(g=2), field=f)", None, g2),
                       ("MinRow(Row(g=3), field=f)", None, g3)):
        if filt is not None:
            live = [x for x in rows if popcounts(rows[x] & filt)]
            r = max(live) if q.startswith("Max") else min(live)
        c = popcounts(rows[r] if filt is None else rows[r] & filt)
        res, _ms = http.query(q)
        check(res == [{"id": r, "count": c}], f"{q}: {res}, oracle "
                                              f"{r}: {c}")
        calls[q] = {"id": r, "count": c}
    probe = "Count(Row(f=2))"
    for q, want_row, label in (
            ("Store(Intersect(Row(f=1), Row(g=2)), f=9)", f1 & g2,
             "store"),
            ("ClearRow(f=9)", np.zeros_like(f1), "clearrow")):
        http.query(probe)
        cache_round(ck, http, G_ONLY, data)
        d0 = rc_doc(http)
        res, _ms = http.query(q)
        check(res == [True], f"{q}: {res}")
        res, _ms = http.query("Count(Row(f=9))")
        check(res == [popcounts(want_row)], f"after {q}: {res}")
        res, _ms = http.query(probe)
        check(res == [popcounts(data["f"][2])], f"after {q}: {probe} {res}")
        g_only, _k = cache_round(ck, http, G_ONLY, data)
        dd = rc_delta(d0, rc_doc(http))
        check(dd["misses"] >= 2 and g_only["hits"] == len(G_ONLY)
              and g_only["misses"] == 0,
              f"{q} moved the stamps: {dd}, the g Counts {g_only}")
        calls[label] = {"bits": popcounts(want_row), "counters": dd}
    out["calls"] = calls
    log(f"cache (d): {spql} = {swant} (dense, no kernel); "
        + "; ".join(f"{q} = {v}" for q, v in calls.items()
                    if q.startswith(("Min", "Max")))
        + f"; Store wrote {calls['store']['bits']} bits and ClearRow "
          f"cleared them, each moving field f's stamps "
          f"({calls['store']['counters']}, {calls['clearrow']['counters']})")

    # (e) times
    times = {
        "count": time_pair(http, f"Count({tree_pql(TREES[0])})", CACHE_RUNS,
                           CACHE_RUNS),
        "topn": time_pair(http, "TopN(s, Row(f=1), n=10)", CACHE_RUNS,
                          CACHE_RUNS),
        "groupby": time_pair(http, "GroupBy(Rows(s), Rows(u))", CACHE_RUNS,
                             CACHE_GROUPBY_RUNS),
        "shift": time_pair(http, spql, CACHE_RUNS, CACHE_RUNS),
    }
    out["times"] = times
    for label, t in times.items():
        log(f"cache (e) {label} [{card['smi']}]: {t['pql']} warm hit "
            f"{fmt(t['hit_ms'])}; ?nocache=1 miss {fmt(t['miss_ms'])}")
    out["launches"] = ck.launch_counts()
    out["debug"] = {k: v for k, v in rc_doc(http).items() if k != "top"}
    log(f"cache phase launches: {out['launches']}; /debug/resultcache "
        f"{out['debug']}")
    return out


# ------------------------------------------------------------ shell phase


RES_BUDGET = 128 << 20  # the residency phase's HBM budget (bytes)
RES_ROWS = (("f", 1), ("f", 2), ("f", 3), ("f", 4), ("g", 1), ("g", 2),
            ("g", 3))
RES_ROUNDS = 5  # churn rounds...
RES_PAIRS = 7  # ...of this many Count(Intersect) pairs, seeded order
OOM_HEADROOM = 16 << 20  # card bytes the ballast leaves: under one stack
OOM_BUDGET = 1 << 30  # the budget the OOM step's warm entries fit under
PREWARM_SHARDS = 8  # field p's shards...
PREWARM_BITS = 5243  # ...and bits per row and shard: two rows pass
#                      max_op_n, so the import merges into base rows


def tier_counters(residency) -> dict:
    """The manager's and the promotion pool's counters now."""
    st = residency.manager().stats()
    p = residency.promoter().stats()
    t = st["tiers"]
    return {"evictions": st["evictions"], "admits": st["admits"],
            "demotions": t["demotions"], "hits": t["hits"],
            "misses": t["misses"], "fallbacks": t["fallbacks"],
            "prefetchUseful": t["prefetchUseful"],
            "promotions": p["promotions"],
            "prefetchCompleted": p["prefetchCompleted"],
            "prefetchIssued": p["prefetchIssued"],
            "failures": p["failures"], "sheds": p["sheds"]}


def tier_route(d0: dict, d1: dict) -> str:
    """What one query's tiered reads were, from the counters around it:
    a host-bytes read (fallback), a promotion that landed in its wait, a
    rebuild from the fragments (cold), or HBM hits only."""
    if d1["fallbacks"] > d0["fallbacks"]:
        return "fallback"
    if d1["hits"] > d0["hits"]:
        return "promoted"
    if d1["misses"] > d0["misses"]:
        return "cold"
    return "hbm"


def raw_query(http: Http, pql: str, flags: str) -> tuple[bytes, float]:
    """One query's raw body (status 200 required) and its host-clock ms;
    ``?nocache=1`` joins the flags as in ``Http.query``."""
    if http.nocache:
        flags += ("&" if "?" in flags else "?") + "nocache=1"
    t0 = time.perf_counter()
    st, body = http.post("/index/i/query" + flags, pql.encode(),
                         "text/plain")
    ms = (time.perf_counter() - t0) * 1e3
    check(st == 200, f"{pql}{flags} -> HTTP {st}: {body[:300]!r}")
    return body, ms


def phase_residency(torch, ck, residency, prewarm, srv, data: dict,
                    gt1000: int, seed: int) -> dict:
    """Tiered residency on the served index (runtime/residency.py).

    (a) the manager at the budget in force, after every earlier phase:
        its budget, bytes, entries and evictions, and the card's
        allocated bytes;
    (b) churn: the budget set to ``RES_BUDGET``, the host tier at its
        default; ``RES_ROUNDS`` rounds of ``RES_PAIRS``
        ``Count(Intersect(a, b))`` over pairs of f1-f4 and g1-g3 in a
        seeded order, each once with ``?nocoalesce=true`` (K2, or dense
        with f4), once through the coalescer (K3) and once with
        ``?notiers=1``, the last round with a promotion wait of 0, so that
        demoted reads take the host-bytes route; then
        ``TopN(s, Row(f=1), n=10)`` (K4 over a 512 MiB matrix stack, over
        the budget: the oversized-entry rule) and ``Count(Row(v > 1000))``
        (K6 over v's 704 MiB plane stack, over the 512 MiB entry cap: built
        per query) twice each; every answer the oracle's, the three
        bodies of a pair byte-identical, and the tracked total never over
        the larger of the budget and the largest entry;
    (c) out of memory: six leaves and a matrix stack warmed under
        ``OOM_BUDGET``, the card's
        free memory taken by a ballast tensor but ``OOM_HEADROOM`` and
        every free 32 MiB block of the allocator's cache by chunks, then a
        dense ``Count(Row(s=5))`` whose cold 32 MiB stack cannot be
        uploaded until the retry has evicted the warm entries; exact, one
        retry, the budget 10 % smaller; the ballast released;
    (d) prewarm: rows 1 and 2 of a fresh field p through ``/import``,
        ``prewarm.drain()``, then the first dense Count over them reads
        the prewarmed stacks (the same cached tensors before and after).

    Launch counts are zeroed at the start and read at the end; the budget
    and the promotion wait are put back."""
    t_phase = time.perf_counter()
    mgr = residency.manager()
    dev = torch.device("cuda", 0)
    out: dict = {}
    st = mgr.stats()
    out["defaults"] = {
        "budget": st["budget"], "operator_sized": mgr.operator_sized,
        "probe_budget": int(torch.cuda.mem_get_info(dev)[1] * 0.6),
        "total": st["total"], "entries": st["entries"],
        "evictions": st["evictions"],
        "host_bytes": st["tiers"]["host"]["bytes"],
        "memory_allocated": torch.cuda.memory_allocated(dev)}
    log("residency (a), after the earlier phases: " + json.dumps(
        out["defaults"]))
    budget0 = mgr.budget
    wait0 = residency.config().promote_wait_ms
    prefetch0 = residency.config().prefetch
    http = Http(srv.uri, nocache=True)
    ck.reset_launch_counts()
    c0 = tier_counters(residency)
    oom0 = residency.oom_retries()
    try:
        # (b) churn under a budget of a few stacks; the manager trims to a
        # new budget only at its next admit, so the earlier phases'
        # entries are evicted (demoted) first
        mgr.budget = RES_BUDGET
        out["trimmed"] = mgr.evict_all()
        c0 = tier_counters(residency)
        rng = np.random.default_rng(seed + 29)
        pairs = [(a, b) for i, a in enumerate(RES_ROWS)
                 for b in RES_ROWS[i + 1:]]
        routes: dict = {}
        largest = 0

        def timed(pql: str, flags: str, want_body=None):
            nonlocal largest
            d0 = tier_counters(residency)
            body, ms = raw_query(http, pql, flags)
            route = ("notiers" if "notiers" in flags
                     else tier_route(d0, tier_counters(residency)))
            routes.setdefault(route, []).append(ms)
            st = mgr.stats()
            top = mgr.top_entries(1)
            largest = max([largest] + [e["bytes"] for e in top])
            check(st["total"] <= max(st["budget"], largest),
                  f"{pql}{flags}: tracked {st['total']} over the budget "
                  f"{st['budget']} and the largest entry {largest}")
            if want_body is not None:
                check(body == want_body, f"{pql}{flags}: {body!r} is not "
                                         f"{want_body!r}")
            return body

        for rnd in range(RES_ROUNDS):
            if rnd == RES_ROUNDS - 1:
                residency.configure(promote_wait_ms=0.0)
            for k in rng.permutation(len(pairs))[:RES_PAIRS]:
                a, b = pairs[k]
                tree = ("and", a, b)
                pql = f"Count({tree_pql(tree)})"
                want = json.dumps({"results": [oracle(tree, data)]}
                                  ).encode()
                body = timed(pql, "?nocoalesce=true")
                check(json.loads(body) == json.loads(want),
                      f"{pql}: {body!r} is not the oracle's {want!r}")
                timed(pql, "", body)
                timed(pql, "?notiers=1", body)
        residency.configure(promote_wait_ms=wait0)
        f1 = data["f"][1][:SCAN_SHARDS]
        want_topn = topn_json({r: popcounts(m & f1)
                               for r, m in data["s"].items()}, 10)
        for pql, want in (("TopN(s, Row(f=1), n=10)", [want_topn]),
                          ("Count(Row(v > 1000))", [gt1000])):
            for _ in range(2):
                body = timed(pql, "")
                check(json.loads(body)["results"] == want,
                      f"{pql}: {body[:300]!r} is not the oracle's")
        c1 = tier_counters(residency)
        churn = {k: c1[k] - c0[k] for k in c1}
        churn["demand_promotions"] = (churn["promotions"]
                                      - churn["prefetchCompleted"])
        st = mgr.stats()
        churn.update(budget=st["budget"], total=st["total"],
                     host_bytes=st["tiers"]["host"]["bytes"],
                     host_entries=st["tiers"]["host"]["entries"],
                     high_water=st["high_water"], largest_entry=largest,
                     kinds=st["kinds"],
                     # the card's bytes beside the tracked ones: the
                     # container engine's staging and megapool memos hold
                     # pools the budget does not count
                     memory_allocated=torch.cuda.memory_allocated(dev))
        churn["median_ms"] = {r: statistics.median(v)
                              for r, v in routes.items()}
        churn["reads"] = {r: len(v) for r, v in routes.items()}
        out["churn"] = churn
        check(churn["evictions"] > 0 and churn["demotions"] > 0,
              f"no eviction under {RES_BUDGET} bytes: {churn}")
        check(churn["promotions"] > 0, f"nothing was promoted: {churn}")
        log("residency (b): " + json.dumps(churn))

        # (c) a real out-of-memory error on the card, with the prefetcher
        # paused and the promotion pool idle: a promotion must not take
        # the memory the retry frees
        residency.configure(prefetch=False)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30:
            ps = residency.promoter().stats()
            if ps["queue"] == 0 and ps["inFlight"] == 0:
                break
            time.sleep(0.05)
        mgr.budget = OOM_BUDGET
        for a, b in ((("f", 1), ("f", 2)), (("f", 3), ("g", 1)),
                     (("g", 2), ("g", 3))):
            raw_query(http, f"Count({tree_pql(('and', a, b))})",
                      "?nocoalesce=true")
        # and s's 512 MiB matrix stack: the retry's dense Count needs a
        # few of its 64 MiB int64 temporaries beside the stack, so the
        # eviction must free more than the six leaves
        body, _ms = raw_query(http, "TopN(s, Row(f=1), n=10)", "")
        check(json.loads(body)["results"] == [want_topn],
              f"the OOM step's TopN: {body[:300]!r}")
        warm = mgr.stats()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        ballast = None
        size = free - OOM_HEADROOM
        while ballast is None and size > 0:
            try:
                ballast = torch.empty(size, dtype=torch.uint8, device=dev)
            except torch.cuda.OutOfMemoryError:
                size -= 64 << 20
        # the allocator's cache keeps free room inside segments that hold
        # a live block, where mem_get_info does not see it: take every
        # free block of a stack's size too, so that no upload can land
        chunks = []
        while True:
            try:
                chunks.append(torch.empty(32 << 20, dtype=torch.uint8,
                                          device=dev))
            except torch.cuda.OutOfMemoryError:
                break
        left = torch.cuda.mem_get_info(dev)[0]
        n_chunks = len(chunks)
        want = popcounts(data["s"][5])
        n0, b0 = residency.oom_retries(), mgr.budget
        try:
            res, ms = http.query("Count(Row(s=5))",
                                 "?nocoalesce=true&nocontainers=1")
        finally:
            del ballast, chunks
            torch.cuda.empty_cache()
            residency.configure(prefetch=prefetch0)
        check(res == [want], f"Count(Row(s=5)) under the ballast: {res} != "
                             f"{want}")
        oom = {"warm_entries": warm["entries"], "warm_bytes": warm["total"],
               "free_before": free, "ballast": size,
               "chunks_32mib": n_chunks, "free_left": left,
               "retries": residency.oom_retries() - n0,
               "budget_before": b0, "budget_after": mgr.budget, "ms": ms,
               "entries_after": mgr.stats()["entries"]}
        if oom["retries"]:
            check(oom["retries"] == 1 and mgr.budget == int(b0 * 0.9),
                  f"the OOM retry: {oom}")
        else:
            oom["not_raised"] = (f"{left} bytes stayed free under the "
                                 f"ballast and {n_chunks} 32 MiB chunks: "
                                 f"the 32 MiB upload fit")
        out["oom"] = oom
        log("residency (c): " + json.dumps(oom))

        # (d) prewarm of an import
        mgr.budget = budget0
        check(http.post("/index/i/field/p", b"{}")[0] == 200,
              "create field p")
        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as width

        cols = {r: np.concatenate([
            s * width + rng.choice(width, PREWARM_BITS, replace=False)
            for s in range(PREWARM_SHARDS)]) for r in (1, 2)}
        body = json.dumps({"rowIDs": [1] * len(cols[1]) + [2] * len(cols[2]),
                           "columnIDs": cols[1].tolist()
                           + cols[2].tolist()}).encode()
        p0 = prewarm.counters()
        t0 = time.perf_counter()
        check(http.post("/index/i/field/p/import", body)[0] == 200,
              "import into p")
        import_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        check(prewarm.drain(timeout=60), "prewarm did not drain")
        drain_ms = (time.perf_counter() - t0) * 1e3
        p1 = prewarm.counters()
        idx = srv.holder.index("i")
        f = idx.field("p")
        shards = tuple(sorted(idx.available_shards()))
        warm = {r: f._device_cache.get(("row", r, shards)) for r in (1, 2)}
        check(all(v is not None for v in warm.values()),
              f"prewarm left no stack: {sorted(map(str, f._device_cache))}")
        want = int(np.intersect1d(cols[1], cols[2]).size)
        d0 = tier_counters(residency)
        res, first_ms = http.query("Count(Intersect(Row(p=1), Row(p=2)))",
                                   "?nocoalesce=true&nocontainers=1")
        d1 = tier_counters(residency)
        check(res == [want], f"the prewarmed Count: {res} != {want}")
        hit = all(f._device_cache.get(("row", r, shards)) is warm[r]
                  for r in (1, 2))
        check(hit and d1["misses"] == d0["misses"],
              "the first Count after prewarm rebuilt a stack")
        out["prewarm"] = {k: p1[k] - p0[k] for k in p1}
        out["prewarm"].update(import_ms=import_ms, drain_ms=drain_ms,
                              first_count_ms=first_ms, hbm_hit=hit)
        log("residency (d): " + json.dumps(out["prewarm"]))
    finally:
        mgr.budget = budget0
        residency.configure(promote_wait_ms=wait0, prefetch=prefetch0)
    out["launches"] = ck.launch_counts()
    for k in ("gathered_count_and", "vm_counts", "row_counts_masked",
              "bsi_compare"):
        check(out["launches"][k] > 0, f"{k} never launched in the residency "
                                      f"phase: {out['launches']}")
    out["oom_retries"] = residency.oom_retries() - oom0
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"residency": {
        "defaults": out["defaults"], "churn": out["churn"],
        "trimmed": out["trimmed"], "oom": out["oom"],
        "prewarm": out["prewarm"],
        "launches": {k: v for k, v in out["launches"].items() if v},
        "phase_s": out["phase_s"]}}))
    return out


def shell_toml(tmp: str, port: int) -> str:
    """The shell phase's config: every key the port applies set to a
    value the phase can observe."""
    path = os.path.join(tmp, "node.toml")
    with open(path, "w") as f:
        f.write(f'data-dir = "{os.path.join(tmp, "data")}"\n'
                f'bind = "127.0.0.1:{port}"\n'
                f'log-path = "{os.path.join(tmp, "node.log")}"\n'
                f"max-writes-per-request = {SHELL_MAX_WRITES}\n\n"
                f"[cluster]\nlong-query-time = {SHELL_LONG_QUERY}\n\n"
                '[coalescer]\nenabled = "true"\n\n'
                "[cache]\nenabled = false\n\n"
                f"[admission]\nquery-cap = {SHELL_QUERY_CAP}\n\n"
                f"[ingest]\ncompact-interval = {INGEST_INTERVAL}\n\n"
                # 4 % rows are array containers, which K2 and K3 do not
                # read: bitmap blocks only, so that the Counts take them
                "[containers]\nkinds = false\n")
    return path


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def write_csv(path: str, cols: list) -> None:
    with open(path, "w") as f:
        f.write("".join(",".join(map(str, rec)) + "\n"
                        for rec in zip(*cols)))


def shell_data(seed: int) -> dict:
    """Field f rows 1 and 2 at ``SHELL_FILL`` over ``SHELL_SHARDS`` x
    2^20 columns, ``SHELL_VALUES`` int values of v and ``SHELL_TIMES``
    timestamped bits of t, all from the seed."""
    rng = np.random.default_rng(seed + 13)
    n_cols = SHELL_SHARDS << 20
    f = {r: np.flatnonzero(rng.integers(0, 1 << 16, n_cols, dtype=np.uint16)
                           < int(SHELL_FILL * (1 << 16)))
         for r in (1, 2)}
    v_cols = np.sort(rng.choice(n_cols, SHELL_VALUES, replace=False))
    v_vals = rng.integers(SHELL_VMIN, SHELL_VMAX + 1, SHELL_VALUES)
    t_rows = rng.integers(1, 3, SHELL_TIMES)
    t_cols = rng.integers(0, n_cols, SHELL_TIMES)
    t_days = rng.integers(1, 1 + SHELL_DAYS, SHELL_TIMES)
    return {"f": f, "v": (v_cols, v_vals), "t": (t_rows, t_cols, t_days)}


def shell_import(cmd, uri: str, argv: list) -> float:
    """One ``import`` through the CLI's entry point; its seconds."""
    t0 = time.perf_counter()
    rc = cmd.main(["import", "--host", uri, "-i", "i", "--create"] + argv)
    check(rc == 0, f"import {argv} exited {rc}")
    return time.perf_counter() - t0


def shell_get(uri: str, path: str):
    with urllib.request.urlopen(uri + path, timeout=600) as resp:
        return json.loads(resp.read())


def shell_captured(fn, *args) -> tuple[int, str]:
    """(exit code, stdout) of a CLI call."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def shell_entry_point(toml: str, want: int) -> dict:
    """``python -m pilosa_tpu_torch server -c TOML`` with no --device:
    it must report serving on cuda, answer one Count equal to ``want``
    and exit 0 on SIGTERM."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "-c", toml],
        cwd=root, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    # a server that never reports is killed, so that readline returns
    timer = threading.Timer(SHELL_START_S, proc.kill)
    timer.start()
    try:
        line = proc.stdout.readline()
        timer.cancel()
        check(" on cuda" in line, f"the entry point said {line!r}")
        uri = line.split(" at ")[1].split()[0]
        ready_s = time.perf_counter() - t0
        warmed, prewarm_s = ragged_prewarm_wait(uri, 0)
        got, ms = Http(uri).query("Count(Intersect(Row(f=1), Row(f=2)))")
        check(got == [want], f"the entry point's Count: {got} != {want}")
    finally:
        timer.cancel()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    check(rc == 0, f"the entry point exited {rc} on SIGTERM")
    return {"ready_s": ready_s, "count_ms": ms,
            "ragged_prewarm": {"launches": warmed, "s_after_ready":
                               prewarm_s}}


#: K3 launches of the [ragged] prewarm at the default max-batch of 32:
#: the pow2 batch ladder 2, 4, 8, 16, 32 (ops/tape.prewarm)
RAGGED_LADDER = 5


def ragged_prewarm_wait(uri: str, base: int) -> tuple[int, float]:
    """Wait until the served process's ``tape.prewarmed`` counter
    (``GET /debug/ragged``) has moved ``RAGGED_LADDER`` past ``base``: the
    [ragged] prewarm's launches.  Returns (launches, seconds waited)."""
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < 120:
        n = shell_get(uri, "/debug/ragged")["counters"]["tape.prewarmed"]
        if n - base >= RAGGED_LADDER:
            break
        time.sleep(0.02)
    check(n - base == RAGGED_LADDER, f"the ragged prewarm made {n - base} "
                                     f"launches")
    return n - base, time.perf_counter() - t0


def phase_shell(ck, seed: int) -> dict:
    """The serving shell: a TOML file, ``cmd.run_server`` on the card,
    three CSV imports through the CLI, K2/K3/K4 Counts against the numpy
    oracle, the ``/internal`` reads, the config's effect, ``export``,
    ``check`` and ``inspect``, and the real entry point.  Launch counts
    are zeroed at the start and read at the end."""
    from pilosa_tpu_torch import cmd
    from pilosa_tpu_torch.config import Config

    t_phase = time.perf_counter()
    out: dict = {}
    data = shell_data(seed)
    tmp = tempfile.mkdtemp(prefix="pilosa_torch_shell_")
    try:
        port = free_port()
        toml = shell_toml(tmp, port)
        # 1. the TOML file, printed back by ``config``
        rc, text = shell_captured(cmd.main, ["config", "-c", toml])
        check(rc == 0, f"config exited {rc}")
        for want in (f"max-writes-per-request = {SHELL_MAX_WRITES}",
                     f"long-query-time = {SHELL_LONG_QUERY}",
                     f"query-cap = {SHELL_QUERY_CAP}",
                     '[coalescer]\nenabled = "true"',
                     "[cache]\nenabled = false"):
            check(want in text, f"config does not print {want!r}")
        f_csv = os.path.join(tmp, "f.csv")
        f_rows = np.concatenate([np.full(len(c), r)
                                 for r, c in data["f"].items()])
        f_cols = np.concatenate(list(data["f"].values()))
        write_csv(f_csv, (f_rows.tolist(), f_cols.tolist()))
        v_csv = os.path.join(tmp, "v.csv")
        write_csv(v_csv, (data["v"][0].tolist(), data["v"][1].tolist()))
        t_csv = os.path.join(tmp, "t.csv")
        t_rows, t_cols, t_days = data["t"]
        write_csv(t_csv, (t_rows.tolist(), t_cols.tolist(),
                          [f"2024-01-{d:02d}T12:30:00Z" for d in t_days]))

        # 2. the server, from the file, with no device flag
        cfg = Config.load(toml, env={})
        ready, stop = threading.Event(), threading.Event()
        result = {}

        def serve():
            try:
                result["rc"] = cmd.run_server(cfg, ready, stop)
            except Exception as e:  # noqa: BLE001 -- reported below
                result["error"] = e
                ready.set()

        from pilosa_tpu_torch.ops import tape

        prewarmed = tape.counters()["tape.prewarmed"]
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        check(ready.wait(300), "run_server did not start")
        check("error" not in result, f"run_server: {result.get('error')!r}")
        uri = f"http://127.0.0.1:{port}"
        try:
            check(shell_get(uri, "/info")["cpuType"] == "cuda+host",
                  "run_server does not serve on cuda")
            # the [ragged] prewarm's K3 launches land before the counts
            # are zeroed
            ragged_prewarm_wait(uri, prewarmed)
            ck.reset_launch_counts()
            # 3. three CSVs through the CLI
            n_f = len(f_rows)
            secs = shell_import(cmd, uri, ["-f", "f", f_csv])
            out["import"] = {"f_records": n_f, "f_s": secs,
                             "f_records_per_s": n_f / secs}
            secs_v = shell_import(cmd, uri, [
                "-f", "v", "--field-type", "int", "--min", str(SHELL_VMIN),
                "--max", str(SHELL_VMAX), v_csv])
            secs_t = shell_import(cmd, uri, [
                "-f", "t", "--field-type", "time", "--time-quantum", "YMD",
                t_csv])
            n_all = n_f + SHELL_VALUES + SHELL_TIMES
            out["import"].update({
                "v_records": SHELL_VALUES, "v_s": secs_v,
                "t_records": SHELL_TIMES, "t_s": secs_t,
                "records_per_s": n_all / (secs + secs_v + secs_t)})
            log(f"shell: imported {n_f} + {SHELL_VALUES} + {SHELL_TIMES} "
                f"records through the CLI at "
                f"{out['import']['records_per_s']:.0f} records/s "
                f"(field f {out['import']['f_records_per_s']:.0f}/s)")
            out["compaction"] = compact_all()

            # 4. the Counts against the oracle
            http = Http(uri)
            want_and = int(np.intersect1d(data["f"][1], data["f"][2],
                                          assume_unique=True).size)
            pql = "Count(Intersect(Row(f=1), Row(f=2)))"
            counts = {}
            for label, flags, kernel in (
                    ("k2", "?nocoalesce=true", "gathered_count_and"),
                    ("k3", "", "vm_counts")):
                k0 = ck.launch_counts()
                times = []
                for _ in range(SHELL_RUNS):
                    got, ms = http.query(pql, flags)
                    check(got == [want_and], f"{pql}{flags}: {got} != "
                                             f"{want_and}")
                    times.append(ms)
                k1 = ck.launch_counts()
                check(launched(k0, k1).get(kernel, 0) == SHELL_RUNS,
                      f"{pql}{flags} launched {launched(k0, k1)}")
                counts[label] = spread(times)
            k0 = ck.launch_counts()
            v_cols, v_vals = data["v"]
            times = []
            for _ in range(1 + SHELL_RUNS):
                got, ms = http.query("Sum(field=v)")
                check(got == [{"value": int(v_vals.sum()),
                               "count": SHELL_VALUES}],
                      f"Sum(field=v): {got}")
                times.append(ms)
            # two K4 launches a Sum: the sign plane's counts and the rest
            check(launched(k0, ck.launch_counts()).get(
                "row_counts_masked", 0) == 2 * (1 + SHELL_RUNS),
                f"Sum(field=v) launched {launched(k0, ck.launch_counts())}")
            counts["k4_sum_first_ms"] = times[0]
            counts["k4_sum"] = spread(times[1:])
            t_want = len({int(c) for r, c, d in zip(t_rows, t_cols, t_days)
                          if r == 1 and 3 <= d < 6})
            got, _ms = http.query("Count(Row(t=1, from='2024-01-03T00:00', "
                                  "to='2024-01-06T00:00'))")
            check(got == [t_want], f"the time range Count: {got} != "
                                   f"{t_want}")
            out["counts"] = counts

            # 5. the routes and the config's effect
            check(shell_get(uri, "/internal/shards/max") == {
                "standard": {"i": SHELL_SHARDS - 1}},
                "/internal/shards/max")
            hosts = shell_get(uri, "/hosts")
            check(len(hosts) == 1 and hosts[0]["uri"] == uri, f"{hosts}")
            for path in ("/internal/fragment/nodes?index=i&shard=5",
                         "/internal/nodes"):
                check(shell_get(uri, path) == hosts, f"{path} != /hosts")
            check(shell_get(uri, "/debug/resultcache")["enabled"] is False,
                  "the TOML's [cache] enabled = false did not apply")
            check(shell_get(uri, "/debug/containers")["kinds"] is False,
                  "the TOML's [containers] kinds = false did not apply")
            adm = shell_get(uri, "/debug/admission")
            check(adm["classes"]["query"]["cap"] == SHELL_QUERY_CAP,
                  f"the TOML's query-cap did not apply: {adm}")
            st, body = http.post("/index/i/query",
                                 b"Set(1, f=9) Set(2, f=9) Set(3, f=9)",
                                 "text/plain")
            check((st, json.loads(body)) == (400, {
                "error": f"too many writes in one request (3 > "
                         f"{SHELL_MAX_WRITES})"}),
                  f"three Sets: {st} {body[:200]!r}")
            with open(os.path.join(tmp, "node.log")) as fh:
                log_text = fh.read()
            check("slow query (" in log_text, "no slow query was logged")

            # 6. export
            exp = os.path.join(tmp, "f_export.csv")
            t0 = time.perf_counter()
            rc = cmd.main(["export", "--host", uri, "-i", "i", "-f", "f",
                           "-o", exp])
            out["export_s"] = time.perf_counter() - t0
            check(rc == 0, f"export exited {rc}")
            pairs = np.loadtxt(exp, delimiter=",", dtype=np.int64,
                               ndmin=2)
            check(np.array_equal(
                np.sort(pairs[:, 0] << 32 | pairs[:, 1]),
                np.sort(f_rows << 32 | f_cols)),
                "the export is not the imported pairs")
        finally:
            stop.set()
            th.join(120)
        check(not th.is_alive() and result.get("rc") == 0,
              f"run_server did not stop cleanly: {result}")
        out["launches"] = ck.launch_counts()

        # 7. the offline tools
        data_dir = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        rc, text = shell_captured(cmd.main, ["check", data_dir])
        out["check_s"] = time.perf_counter() - t0
        lines = text.splitlines()
        check(rc == 0 and lines[-1] == "passed: 0 corrupt fragment(s)"
              and all(ln.startswith("ok   ") for ln in lines[:-1]),
              f"check: {rc} {text[-300:]!r}")
        out["check_fragments"] = len(lines) - 1
        rc, text = shell_captured(cmd.main, ["inspect", data_dir, "-f", "f"])
        check(rc == 0, f"inspect exited {rc}")
        rows = bits = 0
        for ln in text.splitlines():
            if ln.startswith("i/f/standard/"):
                fields = dict(kv.split("=") for kv in ln.split()[1:])
                rows = max(rows, int(fields["rows"]))
                bits += int(fields["bits"])
        check((rows, bits) == (2, n_f), f"inspect: rows {rows} bits {bits}")
        from pilosa_tpu_torch.server.server import Server

        held = Server(data_dir, port=0)
        held.open()
        try:
            rc, text = shell_captured(cmd.main, ["check", data_dir])
        finally:
            held.close()
        check(rc == 1 and text.startswith("FAIL open"),
              f"check of a held directory: {rc} {text[:200]!r}")

        # 8. the real entry point
        out["entry_point"] = shell_entry_point(toml, want_and)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"shell": {
        "import": out["import"], "export_s": out["export_s"],
        "check_s": out["check_s"], "check_fragments": out["check_fragments"],
        "counts": out["counts"], "entry_point": out["entry_point"],
        "launches": {k: v for k, v in out["launches"].items() if v},
        "phase_s": out["phase_s"]}}))
    return out


def kernel_line(name, source, replaces, launches, err, timing) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            # torch has no popcount: no one library call computes these
            "library_ms": None}


def run_paths(torch, ck, bm, kp, containers, tape, Server, roaring,
              seed: int, card: dict) -> dict:
    """The server on cuda: the K2 path, the lone query, the coalesced
    path, the scan path, the BSI path, the kinds leg, the ingest phase,
    the field-types phase, the keys phase, the admission phase, the cache
    phase, then the timings on their own inputs."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    words = SHARD_WIDTH // 32
    cpr = SHARD_WIDTH // roaring.CONTAINER_BITS
    t0 = time.perf_counter()
    data = make_rows(N_SHARDS, words, seed)
    fills = {f"{f}{r}": float(np.bitwise_count(m).sum(dtype=np.int64))
             / (N_SHARDS * SHARD_WIDTH)
             for f, rs in data.items() for r, m in rs.items()}
    log(f"data: {N_SHARDS} shards x {SHARD_WIDTH} columns "
        f"({N_SHARDS * SHARD_WIDTH} columns), fills "
        + ", ".join(f"{k} {v:.4f}" for k, v in fills.items())
        + f", made in {time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="pilosa_torch_smoke_")
    # the defaults (cuda, coalescer "auto", kinds, ingest deltas on) but
    # a compactor that scans once an hour: every merge in this run is a
    # write's inline flush, a query's (?nodelta=1, a whole-matrix read) or
    # an explicit scan, so that routes do not depend on timing
    srv = Server(tmp, port=0, ingest_compact_interval=INGEST_INTERVAL)
    try:
        srv.open()
        check(srv.device.type == "cuda", f"server runs on {srv.device}")
        # [ragged] prewarm (on by default): its K3 launches land before
        # any path zeroes the counts
        t0 = time.perf_counter()
        while (not srv.ragged_prewarm_stats["done"]
               and time.perf_counter() - t0 < 120):
            time.sleep(0.05)
        rp = srv.ragged_prewarm_stats
        check(rp["done"] and rp["failures"] == 0 and rp["launches"] > 0,
              f"the ragged prewarm: {rp}")
        log(f"ragged prewarm: {rp['launches']} K3 launches in "
            f"{rp['seconds'] * 1e3:.1f} ms after open")
        check(srv.coalescer.enabled and srv.coalescer.vm,
              "the coalescer or the VM is off on cuda")
        check(containers.config().kinds, "container kinds are off by "
                                         "default")
        cfg = ingest_doc(Http(srv.uri))["config"]
        check(cfg["deltaEnabled"], "ingest delta planes are off by default")
        log(f"ingest: delta planes on, budget {cfg['deltaBudgetBytes']} "
            f"bytes, compact threshold {cfg['compactThresholdBits']} bits, "
            f"compact interval {cfg['compactInterval']} s")
        # the phases before the cache phase time kernels and count their
        # launches: every query of theirs passes ?nocache=1
        http = Http(srv.uri, nocache=True)
        log("phases 5-11f: every query with ?nocache=1 (the result cache, "
            "on by default, would answer their repeats with no launch); "
            "the cache phase runs with the cache")
        check(http.post("/index/i", b'{"options": {"trackExistence": '
                                    b'true}}')[0] == 200, "create index")
        import_field(http, roaring, "f", data["f"], N_SHARDS, cpr)
        out = phase_k2_path(torch, ck, bm, containers, srv, http, data)
        out["queries"]["intersect_coalesced_lone"] = phase_lone(
            ck, tape, http, data)
        out["coalesced"] = phase_coalesced(ck, tape, containers, http,
                                           roaring, data, cpr,
                                           srv.coalescer.vm_max_prefetch)
        check("flush" in out["coalesced"], "no VM flush was recorded")
        out["scans"] = phase_scans(ck, bm, http, roaring, data, cpr, words,
                                   seed)
        out["bsi"] = phase_bsi(ck, srv, http, roaring, data, cpr, words,
                               seed)
        out["kinds"] = phase_kinds(ck, tape, containers, srv, http, roaring,
                                   cpr, words, seed)
        out["ingest"] = phase_ingest(ck, tape, containers, srv, http,
                                     roaring, data,
                                     out["kinds"].pop("data"), seed)
        out["field_types"] = phase_field_types(ck, srv, http, roaring, data,
                                               cpr, words, seed)
        out["keys"] = phase_keys(ck, srv, http, roaring, data, cpr, words,
                                 seed)
        out["admission"] = phase_admission(ck, tape, srv, data, card)
        out["cache"] = phase_cache(ck, srv, data, card)
        from pilosa_tpu_torch.runtime import prewarm, residency

        out["residency"] = phase_residency(
            torch, ck, residency, prewarm, srv, data,
            out["bsi"].pop("gt1000_want"), seed)
        out["k3"] = phase_k3_time(torch, ck, tape,
                                  out["coalesced"].pop("flush"), card)
        out["k2"] = phase_k2_time(torch, ck, bm, out.pop("probe"), card)
        probes = out["scans"].pop("probes")
        out["k4"] = phase_k4_time(torch, ck, bm, probes["k4"], card)
        out["k5"] = phase_k5_time(torch, ck, bm, probes["k5"], card)
        probes = out["bsi"].pop("probes")
        out["k6"] = phase_k6_time(torch, ck, probes["k6"], card)
        out["k1"] = phase_k1_time(torch, ck, probes["k1"], card)
        out["k3k"] = phase_k3k_time(torch, ck, tape,
                                    out["kinds"].pop("flush"), card)
        dev = torch.device("cuda", 0)
        out["k3k_fixed"] = phase_k3k_fixed(torch, ck, tape, bm, kp, dev,
                                           seed, card)
        out["k3_fixed"] = phase_k3_fixed(
            torch, ck, tape, bm, dev, seed, card, N_SHARDS,
            [TREES[i] for i in FIXED_TREES])
        out["k3_fixed16"] = phase_k3_fixed(torch, ck, tape, bm, dev, seed,
                                           card, WIDE_SHARDS, TREES)
        # (f) of the ingest phase: the same fixed launches with every leaf
        # delta-fused over overlays made from the seed
        out["k3k_fixed_dfuse"] = phase_k3k_fixed(torch, ck, tape, bm, kp,
                                                 dev, seed, card, delta=True)
        out["k3_fixed_dfuse"] = phase_k3_fixed(
            torch, ck, tape, bm, dev, seed, card, N_SHARDS,
            [TREES[i] for i in FIXED_TREES], delta=True)
        return out
    finally:
        srv.close()
        shutil.rmtree(tmp, ignore_errors=True)


def load_test_module(name: str):
    """tests/<name>.py of this checkout, cases it shares with the card
    tests, loaded by path: another installed package may be named
    ``tests``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20240601)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; nothing was run",
              file=sys.stderr)
        return 2
    try:
        from pilosa_tpu_torch.ops import bitmap as bm
        from pilosa_tpu_torch.ops import containers, nvcc_build, tape
        from pilosa_tpu_torch.ops import kindpools as kp
        from pilosa_tpu_torch.ops import cuda_kernels as ck
        from pilosa_tpu_torch.server.server import Server
        from pilosa_tpu_torch.storage import roaring
        edges = load_test_module("torch_kinds_edges")
        vm_cases = load_test_module("torch_vm_cases")
    except (ImportError, OSError) as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 2

    phase = "header"
    try:
        card = phase_header(torch)
        dev = torch.device("cuda", 0)
        # the HBM budget sized as an operator of this shape sizes it: the
        # default's own figure, 60 % of the card, stated through the
        # variable, which lifts the 512 MiB entry cap to a quarter of the
        # budget, so that v's 704 MiB plane stack is cached
        # (runtime/residency.py, Field._entry_cap)
        os.environ.setdefault("PILOSA_TPU_DEVICE_BUDGET_BYTES", str(int(
            torch.cuda.mem_get_info(dev)[1] * 0.6)))
        log(f"HBM budget: PILOSA_TPU_DEVICE_BUDGET_BYTES="
            f"{os.environ['PILOSA_TPU_DEVICE_BUDGET_BYTES']}")
        phase = "build"
        phase_build(nvcc_build)
        phase = "K2 check"
        k2_err = phase_k2_check(torch, ck, bm, dev, args.seed)
        phase = "K3 check"
        k3_err = phase_k3_check(torch, ck, bm, nvcc_build, vm_cases, dev,
                                args.seed)
        words = (1 << 20) // 32
        phase = "K3-kinds check"
        k3k_err = phase_k3k_check(torch, ck, bm, kp, edges, dev, args.seed)
        phase = "K4 check"
        k4_err = phase_k4_check(torch, ck, bm, dev, args.seed, words)
        phase = "K5 check"
        k5_err = phase_k5_check(torch, ck, bm, dev, args.seed, words)
        phase = "K6 check"
        k6_err = phase_k6_check(torch, ck, dev, args.seed, words)
        phase = "K1 check"
        k1_err = phase_k1_check(torch, ck, dev, args.seed, words)
        phase = "main paths"
        out = run_paths(torch, ck, bm, kp, containers, tape, Server,
                        roaring, args.seed, card)
        phase = "shell"
        out["shell"] = phase_shell(ck, args.seed)
    except Exception as e:  # noqa: BLE001 -- report the phase, exit 1
        print(f"chip_smoke: phase {phase!r} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1

    log(json.dumps({"queries": out["queries"], "coalesced":
                    out["coalesced"], "scans": out["scans"],
                    "k2_us": out["k2"]["spread_us"],
                    "k3_us": out["k3"]["spread_us"],
                    "k3_shape": out["k3"]["shape"],
                    "k3_all_slots_bound_ms": out["k3"]["all_slots_bound_ms"],
                    "k3_host_plan_us": out["k3"]["host_plan_us"],
                    "bsi": out["bsi"],
                    "k4_us": out["k4"]["spread_us"],
                    "k5_us": out["k5"]["spread_us"],
                    "k6_us": out["k6"]["spread_us"],
                    "k1_us": out["k1"]["spread_us"],
                    "kinds": out["kinds"],
                    "ingest": out["ingest"],
                    "field_types": out["field_types"],
                    "keys": out["keys"],
                    "admission": out["admission"],
                    "cache": out["cache"],
                    "residency": {k: out["residency"][k] for k in (
                        "defaults", "trimmed", "churn", "oom", "prewarm",
                        "oom_retries", "phase_s")},
                    "k3_kinds_us": out["k3k"]["spread_us"],
                    "k3_kinds_shape": out["k3k"]["shape"],
                    "k3_kinds_all_slots_bound_ms": out["k3k"]["all_slots_bound_ms"],
                    "k3_kinds_host_plan_us": out["k3k"]["host_plan_us"],
                    "fixed": {name: {k: out[key][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "spread_us", "shape") + extra}
                        for name, key, extra in (
                            ("vm_counts_kinds", "k3k_fixed",
                             ("all_slots_bound_ms", "host_plan_us")),
                            ("vm_counts", "k3_fixed",
                             ("all_slots_bound_ms", "host_plan_us")),
                            ("vm_counts_16", "k3_fixed16",
                             ("all_slots_bound_ms", "host_plan_us")),
                            ("vm_counts_dfuse", "k3_fixed_dfuse",
                             ("all_slots_bound_ms", "host_plan_us")),
                            ("vm_counts_kinds_dfuse", "k3k_fixed_dfuse",
                             ("all_slots_bound_ms", "host_plan_us")))}}))
    # every kernel's launches on its own paths, plus the field-types
    # phase's, the keys phase's, the admission phase's, the cache
    # phase's misses, the residency phase's and the shell phase's
    shell_k = out["shell"]["launches"]
    cache_k = out["cache"]["launches"]
    res_k = out["residency"]["launches"]
    adm_k = out["admission"]["launches"]
    ft_k = out["field_types"]["launches"]
    keys_k = out["keys"]["launches"]
    log(json.dumps({"kernels": [
        kernel_line("gathered_count_and",
                    "pilosa_tpu_torch/ops/csrc/gathered_count_and.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:244",
                    out["launches"]["gathered_count_and"]
                    + ft_k["gathered_count_and"]
                    + keys_k["gathered_count_and"]
                    + adm_k["gathered_count_and"]
                    + cache_k["gathered_count_and"]
                    + res_k["gathered_count_and"]
                    + shell_k["gathered_count_and"],
                    max(k2_err, out["k2"]["max_abs_err"]), out["k2"]),
        # K3 and K3-kinds: launches on their own paths plus the ingest
        # phase's dfuse launches
        kernel_line("vm_counts", "pilosa_tpu_torch/ops/csrc/vm_counts.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:454",
                    out["coalesced"]["k3_launches"]
                    + out["ingest"]["k3"]["launches"]
                    + ft_k["vm_counts"] + keys_k["vm_counts"]
                    + adm_k["vm_counts"] + cache_k["vm_counts"]
                    + res_k["vm_counts"] + shell_k["vm_counts"],
                    max(k3_err, out["k3"]["max_abs_err"],
                        out["k3_fixed"]["max_abs_err"],
                        out["k3_fixed16"]["max_abs_err"],
                        out["k3_fixed_dfuse"]["max_abs_err"]), out["k3"]),
        kernel_line("vm_counts_kinds",
                    "pilosa_tpu_torch/ops/csrc/vm_counts_kinds.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:489",
                    out["kinds"]["launches"]["vm_counts_kinds"]
                    + out["ingest"]["k3_kinds"]["launches"]
                    + cache_k["vm_counts_kinds"]
                    + res_k["vm_counts_kinds"],
                    max(k3k_err, out["k3k"]["max_abs_err"],
                        out["k3k_fixed"]["max_abs_err"],
                        out["k3k_fixed_dfuse"]["max_abs_err"]), out["k3k"]),
        kernel_line("row_counts_masked",
                    "pilosa_tpu_torch/ops/csrc/row_counts_masked.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:145",
                    out["scans"]["launches"]["row_counts_masked"]
                    + ft_k["row_counts_masked"]
                    + keys_k["row_counts_masked"]
                    + cache_k["row_counts_masked"]
                    + res_k["row_counts_masked"]
                    + shell_k["row_counts_masked"],
                    max(k4_err, out["k4"]["max_abs_err"]), out["k4"]),
        kernel_line("masked_matrix_counts",
                    "pilosa_tpu_torch/ops/csrc/masked_matrix_counts.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:652",
                    out["scans"]["launches"]["masked_matrix_counts"]
                    + ft_k["masked_matrix_counts"]
                    + keys_k["masked_matrix_counts"]
                    + cache_k["masked_matrix_counts"]
                    + res_k["masked_matrix_counts"],
                    max(k5_err, out["k5"]["max_abs_err"]), out["k5"]),
        kernel_line("bsi_compare", "pilosa_tpu_torch/ops/csrc/bsi_compare.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:726",
                    out["bsi"]["launches"]["bsi_compare"]
                    + cache_k["bsi_compare"] + res_k["bsi_compare"],
                    max(k6_err, out["k6"]["max_abs_err"]), out["k6"]),
        kernel_line("count_and", "pilosa_tpu_torch/ops/csrc/count_and.cu",
                    "pilosa_tpu/ops/pallas_kernels.py:194",
                    out["bsi"]["launches"]["count_and"]
                    + cache_k["count_and"] + res_k["count_and"],
                    max(k1_err, out["k1"]["max_abs_err"]), out["k1"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
