#!/usr/bin/env python3
"""Warm Count latency of one checkout's port server on one card, for
comparing two commits in one call.

    python3 pair_latency.py ROOT

ROOT is the root of a checkout (this one, ``.``, or another commit's
unpacked with ``git archive``).  Its server (the port's defaults on
``cuda``) serves f rows 1 and 2 at 8 % over 256 shards of 2^20 columns,
loaded in process from ``chip_smoke.make_rows``; then 500 warm runs
each (after 20 unrecorded) of ``Count(Intersect(Row(f=1), Row(f=2)))``
with ``?nocoalesce=true`` (K2) and without (the window and K3), over HTTP
with ``?nocache=1``, and 500 through the API in process.  The medians
are printed as one JSON line.  ``PAIR_NOPF=1`` starts the server with
the residency prefetcher off (a checkout whose Server takes
``residency_prefetch``).  Run the checkouts in alternating order (A B B
A ...) on one card: the host drifts within a call.
"""

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

RUNS, WARMUP = 500, 20
PQL = "Count(Intersect(Row(f=1), Row(f=2)))"


def median_ms(fn) -> float:
    lat = []
    for i in range(WARMUP + RUNS):
        t0 = time.perf_counter()
        fn()
        if i >= WARMUP:
            lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    os.environ["PILOSA_TPU_SHARD_WIDTH_EXP"] = "20"
    sys.path.insert(0, root)
    import numpy as np

    import chip_smoke as cs
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage import roaring

    words = (1 << 20) // 32
    cpr = (1 << 20) // roaring.CONTAINER_BITS
    data = cs.make_rows(256, words, 20240601)
    rows = {1: data["f"][1], 2: data["f"][2]}
    want = int(np.bitwise_count(rows[1] & rows[2]).sum())
    kw = {"residency_prefetch": False} if os.environ.get("PAIR_NOPF") else {}
    tmp = tempfile.mkdtemp()
    srv = Server(tmp, port=0, ingest_compact_interval=3600.0, **kw)
    srv.open()
    try:
        http = cs.Http(srv.uri, nocache=True)
        http.post("/index/i", b"{}")
        http.post("/index/i/field/f", b"{}")
        f = srv.holder.index("i").field("f")
        for s in range(256):
            f.import_roaring(s, cs.roaring_payload(roaring, rows, s, cpr))
        cs.compact_all()

        def over_http(flags):
            def run():
                res, _ms = http.query(PQL, flags)
                assert res == [want], res
            return run

        def in_process():
            assert srv.api.query("i", PQL, coalesce=False,
                                 cache=False) == [want]

        out = {"root": os.path.basename(root)
               + ("-noprefetch" if kw else ""),
               "k2_ms": median_ms(over_http("?nocoalesce=true")),
               "k3_ms": median_ms(over_http("")),
               "api_k2_ms": median_ms(in_process)}
        print(json.dumps(out), flush=True)
    finally:
        srv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
