"""The port's generation-stamped result cache against the JAX package's,
on the CPU at the test width (2^16 columns per shard).

A port server and a JAX server, both at their defaults (result cache on,
ingest delta planes on, coalescer ``auto``, so off on the CPU) with the
mesh off, take the same seeded writes, and then, with zero tolerance:

- every query answers byte-identical JSON on a miss, on a hit, with
  ``?nocache=1`` and with ``?nodelta=1``, and the answers equal a set
  oracle;
- ``GET /debug/resultcache`` has the reference's keys, and its counters
  (hits, misses, fills, invalidations, entries, bytes) move alike;
- a write (``Set``, ``Clear``, ``/import``, ``/import?clear=true``,
  ``Store``, ``ClearRow``), a compaction and a ``?nodelta=1`` read move
  the stamps alike: the reads of what changed miss and see the change,
  the others still hit;
- ``Shift``, ``Store``, ``ClearRow`` and ``MinRow``/``MaxRow`` answer
  alike, fused and per shard, and the WAL files are byte-identical.

Below the servers: the two ``ResultCache`` classes give the same
answers and counters on the same call sequences, single flight
included; a hit launches nothing; a coalesced Count fills the key the
direct path probes; and the server's ``[cache]`` knobs are retained and
released.  Both servers scan for compaction once an hour, so every
compaction here is a query's or an explicit one.  The fixture restores
exactly the process-wide fields the servers and the tests touch.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import ingest as jingest
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.runtime import resultcache as jrc
from pilosa_tpu.runtime import snapqueue
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.parallel import coalescer as tco
from pilosa_tpu_torch.parallel.executor import ExecOptions as TOpts
from pilosa_tpu_torch.parallel.executor import Executor as TExecutor
from pilosa_tpu_torch.runtime import resultcache as trc
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

W = SHARD_WIDTH
N_SHARDS = 3
INTERVAL = 3600.0
_KNOBS = ("enabled", "budget", "max_entry_bytes", "ttl_s")
_INGEST = ("delta_enabled", "delta_budget_bytes", "compact_threshold_bits",
           "compact_interval")
#: the /debug/resultcache counters compared as deltas between the two
_COUNTERS = ("hits", "misses", "fills", "evictions", "invalidations",
             "skippedOversize", "flightJoins", "flightServed", "entries",
             "bytes")


def _slots(cfg) -> dict:
    return {k: getattr(cfg, k) for k in type(cfg).__slots__}


@pytest.fixture(autouse=True)
def _process_wide():
    """Snapshot and restore exactly what the servers and tests touch: the
    mesh config, both result caches' knobs, both [ingest] configs and
    baselines, both [containers] configs; and check that the compactors'
    and the port cache's server references are back."""
    mesh_was = (meshexec._cfg.enabled, meshexec._cfg.axis_size)
    rc_was = [{k: getattr(m.cache(), k) for k in _KNOBS} for m in (jrc, trc)]
    ing_was = [{k: getattr(m.config(), k) for k in _INGEST}
               for m in (jingest, tingest)]
    bases = (jingest._baseline, tingest._baseline)
    ct_was = [_slots(m.config()) for m in (jct, tct)]
    refs = (jcompactor.refs(), tcompactor.refs(), trc.refs())
    meshexec.configure(enabled=False)
    try:
        yield
    finally:
        assert (jcompactor.refs(), tcompactor.refs(), trc.refs()) == refs
        for m, was in zip((jrc, trc), rc_was):
            for k, v in was.items():
                setattr(m.cache(), k, v)
        for m, was in zip((jingest, tingest), ing_was):
            m.configure(**was)
        jingest._baseline, tingest._baseline = bases
        for m, was in zip((jct, tct), ct_was):
            m.configure(**was)
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])


# ------------------------------------------------------------ the servers


def _req(uri: str, path: str, body: bytes | None = None,
         ctype: str = "text/plain") -> tuple[int, bytes]:
    req = urllib.request.Request(uri + path, data=body,
                                 method="GET" if body is None else "POST")
    if body is not None:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def both(pair, path: str, body: bytes | None = None,
         ctype: str = "text/plain", status: int = 200) -> bytes:
    """The same request to both servers: equal status and bytes."""
    js, ts = pair
    want = _req(js.uri, path, body, ctype)
    got = _req(ts.uri, path, body, ctype)
    assert got == want, (path, body, got[1][:300], want[1][:300])
    assert want[0] == status, want
    return want[1]


def query(pair, pql: str, flags: str = "") -> list:
    return json.loads(both(pair, "/index/i/query" + flags,
                           pql.encode()))["results"]


def _rc_doc(uri: str) -> dict:
    st, body = _req(uri, "/debug/resultcache")
    assert st == 200
    return json.loads(body)


class Stats:
    """The /debug/resultcache counters of both servers, as deltas from
    the moment of construction (the JAX cache is reset between tests,
    the port's is not)."""

    def __init__(self, pair) -> None:
        self.pair = pair
        self.base = [self._raw(s) for s in pair]

    @staticmethod
    def _raw(srv) -> dict:
        d = _rc_doc(srv.uri)
        return {k: d[k] for k in _COUNTERS}

    def delta(self) -> dict:
        """Both servers' deltas, asserted equal; the port's returned."""
        j, t = ({k: self._raw(s)[k] - b[k] for k in _COUNTERS}
                for s, b in zip(self.pair, self.base))
        assert t == j, (t, j)
        return t


class Oracle:
    def __init__(self) -> None:
        self.rows: dict = {}
        self.exist: set = set()

    def add(self, f: str, r: int, cols, clear: bool = False) -> None:
        s = self.rows.setdefault((f, r), set())
        cols = {int(c) for c in cols}
        if clear:
            s -= cols
        else:
            s |= cols
            self.exist |= cols

    def __call__(self, f: str, r: int) -> set:
        return set(self.rows.get((f, r), set()))


def shifted(cols: set, n: int) -> set:
    """Shift's per-shard semantics: bits drop at the shard edge."""
    return {c + n for c in cols if c % W + n < W}


def _import(pair, oracle: Oracle, f: str, r: int, cols,
            clear: bool = False) -> None:
    cols = [int(c) for c in cols]
    body = json.dumps({"rowIDs": [r] * len(cols), "columnIDs": cols})
    both(pair, f"/index/i/field/{f}/import" + ("?clear=true" if clear
                                               else ""),
         body.encode(), "application/json")
    if clear:
        oracle.add(f, r, cols, clear=True)
    else:
        oracle.add(f, r, cols)


def _load(pair, seed: int = 5) -> Oracle:
    rng = np.random.default_rng(seed)
    oracle = Oracle()
    both(pair, "/index/i", b'{"options": {"trackExistence": true}}',
         "application/json")
    for f in ("f", "g"):
        both(pair, f"/index/i/field/{f}", b"{}", "application/json")
    both(pair, "/index/i/field/v",
         b'{"options": {"type": "int", "min": -1000, "max": 1000}}',
         "application/json")
    for f, r, n in (("f", 1, 700), ("f", 2, 500), ("f", 3, 300),
                    ("f", 4, 90), ("g", 1, 600), ("g", 2, 400),
                    ("g", 3, 200)):
        _import(pair, oracle, f, r,
                rng.choice(N_SHARDS * W, size=n, replace=False))
    # bits at the top of every shard, for Shift's edge
    _import(pair, oracle, "f", 1, [s * W + W - k for s in range(N_SHARDS)
                                   for k in (1, 2, 40)])
    cols = rng.choice(N_SHARDS * W, size=150, replace=False)
    vals = rng.integers(-1000, 1001, size=150)
    both(pair, "/index/i/field/v/import-value",
         json.dumps({"columnIDs": [int(c) for c in cols],
                     "values": [int(v) for v in vals]}).encode(),
         "application/json")
    oracle.exist |= {int(c) for c in cols}
    oracle.values = dict(zip((int(c) for c in cols), (int(v) for v in vals)))
    return oracle


def _open(tmp_path, **tkw) -> tuple:
    js = JServer(str(tmp_path / "j"), mesh_enabled=False,
                 ingest_compact_interval=INTERVAL)
    ts = TServer(str(tmp_path / "t"), device="cpu",
                 ingest_compact_interval=INTERVAL, **tkw)
    js.open()
    ts.open()
    return js, ts


@pytest.fixture
def pair(tmp_path):
    js, ts = _open(tmp_path)
    try:
        yield js, ts
    finally:
        js.close()
        ts.close()


#: (query, its answer from the oracle); the answers are checked where the
#: oracle gives one cheaply, the JSON always against the JAX server
QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=2), Row(g=1), Row(g=3)))",
    "Count(Not(Row(f=2)))",
    "Count(Shift(Row(f=1), n=3))",
    "Count(Union(Shift(Row(f=1)), Row(g=1)))",
    "Count(Shift(Intersect(Row(f=1), Row(g=1)), n=70000))",
    "Row(f=1)",
    "Intersect(Row(f=1), Row(g=1))",
    "Shift(Row(f=2), n=70)",
    "TopN(f, n=3)",
    "TopN(f, Row(g=1), n=2)",
    "TopN(g, Shift(Row(f=1), n=1))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), filter=Row(g=1), limit=3)",
    "GroupBy(Rows(g), Rows(f), offset=2)",
    "Count(Row(v > 10))",
    "Count(Intersect(Row(v < 0), Row(f=1)))",
    "MinRow(field=f)",
    "MaxRow(Row(g=1), field=f)",
    "MinRow(Row(g=3), field=g)",
]


def _oracle_counts(oracle: Oracle) -> dict:
    f, g = oracle, oracle
    return {
        "Count(Row(f=1))": len(f("f", 1)),
        "Count(Intersect(Row(f=1), Row(g=2)))": len(f("f", 1) & g("g", 2)),
        "Count(Union(Row(f=2), Row(g=1), Row(g=3)))":
            len(f("f", 2) | g("g", 1) | g("g", 3)),
        "Count(Not(Row(f=2)))": len(oracle.exist - f("f", 2)),
        "Count(Shift(Row(f=1), n=3))": len(shifted(f("f", 1), 3)),
        "Count(Union(Shift(Row(f=1)), Row(g=1)))":
            len(shifted(f("f", 1), 1) | g("g", 1)),
        "Count(Shift(Intersect(Row(f=1), Row(g=1)), n=70000))": 0,
        "Count(Row(v > 10))":
            sum(1 for v in oracle.values.values() if v > 10),
    }


def _check_oracle(pair, oracle: Oracle, flags: str = "") -> None:
    for q, want in _oracle_counts(oracle).items():
        assert query(pair, q, flags) == [want], q
    assert query(pair, "Row(f=1)", flags)[0]["columns"] == \
        sorted(oracle("f", 1))
    assert query(pair, "Shift(Row(f=2), n=70)", flags)[0]["columns"] == \
        sorted(shifted(oracle("f", 2), 70))


def test_hits_misses_nocache_and_nodelta_answer_the_same_json(pair):
    oracle = _load(pair)
    _write(pair, oracle, "compaction")  # the loads' deltas into the base
    st = Stats(pair)
    first = {q: query(pair, q) for q in QUERIES}
    d = st.delta()
    # MinRow(field=f) and MaxRow(Row(g=1), field=f) read the row totals
    # that TopN(f, n=3) and TopN(f, Row(g=1), n=2) filled: one key each
    assert d["fills"] > 0 and d["hits"] == 2
    # the second round hits every cached read, and answers the same
    for q in QUERIES:
        assert query(pair, q) == first[q], q
    d2 = st.delta()
    assert d2["hits"] == 2 + d["fills"] + d["hits"]
    assert d2["fills"] == d["fills"]
    # ?nocache=1: a real execution, no probe, no fill
    for q in QUERIES:
        assert query(pair, q, "?nocache=1") == first[q], q
    assert st.delta() == d2
    # ?nodelta=1 skips the probe and compacts what it reads; the next
    # plain round misses where the compaction moved a stamp
    for q in QUERIES:
        assert query(pair, q, "?nodelta=1") == first[q], q
    for q in QUERIES:
        assert query(pair, q) == first[q], q
    st.delta()
    _check_oracle(pair, oracle)
    # one shard: only a GroupBy probes (its probe needs no fused read)
    for q in QUERIES:
        query(pair, q, "?shards=1")
        query(pair, q, "?shards=1")
    st.delta()
    # a pending delta: the reads of f miss, then hit over it
    query(pair, f"Set({W + 3}, f=2) Clear({sorted(oracle('f', 1))[0]}, f=1)")
    oracle.add("f", 2, [W + 3])
    oracle.add("f", 1, [sorted(oracle("f", 1))[0]], clear=True)
    for _ in range(2):
        _check_oracle(pair, oracle)
        _check_oracle(pair, oracle, "?nocache=1")
    st.delta()


def test_debug_resultcache_has_the_reference_keys(pair):
    # the JAX cache is reset between tests, the port's is not: drop the
    # earlier tests' entries, which would crowd this test's out of the
    # 32 largest that "top" lists
    trc.cache().invalidate_all()
    _load(pair)
    for q in QUERIES[:8]:
        query(pair, q)
        query(pair, q)
    jd, td = (_rc_doc(s.uri) for s in pair)
    for d, srv in zip((jd, td), pair):
        assert d["top"] and all(e["repr"].startswith(f"({srv.holder.uid}, ")
                                for e in d["top"])
    assert sorted(td) == sorted(jd)
    assert td["enabled"] is True and jd["enabled"] is True
    for k in ("budget", "maxEntryBytes", "ttlS", "flightsOpen",
              "tenantPrefEvictions"):
        assert td[k] == jd[k], k
    assert [sorted(e) for e in td["top"]] == [sorted(e) for e in jd["top"]]
    # the largest entries, in the same order, with the same bytes and hits
    assert [(e["bytes"], e["hits"]) for e in td["top"]] == \
        [(e["bytes"], e["hits"]) for e in jd["top"]]


READS_F = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=2)))",
           "Row(f=1)", "TopN(f, n=3)", "GroupBy(Rows(f), Rows(g))",
           "Count(Shift(Row(f=1), n=5))", "MaxRow(field=f)"]
READS_G = ["Count(Row(g=2))", "Count(Union(Row(g=1), Row(g=3)))",
           "Row(g=3)", "TopN(g, n=2)", "GroupBy(Rows(g))",
           "MinRow(field=g)"]


def _write(pair, oracle: Oracle, kind: str) -> None:
    if kind == "Set":
        col = 2 * W + 11
        query(pair, f"Set({col}, f=1)")
        oracle.add("f", 1, [col])
    elif kind == "Clear":
        col = sorted(oracle("f", 1))[5]
        query(pair, f"Clear({col}, f=1)")
        oracle.add("f", 1, [col], clear=True)
    elif kind == "import":
        _import(pair, oracle, "f", 1, [7, W + 7, 2 * W + 7])
    elif kind == "import-clear":
        _import(pair, oracle, "f", 1, sorted(oracle("f", 1))[:4],
                clear=True)
    elif kind == "Store":
        query(pair, "Store(Intersect(Row(f=2), Row(g=1)), f=1)")
        oracle.rows[("f", 1)] = oracle("f", 2) & oracle("g", 1)
    elif kind == "ClearRow":
        query(pair, "ClearRow(f=1)")
        oracle.rows[("f", 1)] = set()
    elif kind == "compaction":
        for comp in (jcompactor.compactor(), tcompactor.compactor()):
            comp.run_once(force=True)
    elif kind == "nodelta":
        query(pair, "Count(Row(f=1))", "?nodelta=1")
    else:
        raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["Set", "Clear", "import", "import-clear",
                                  "Store", "ClearRow", "compaction",
                                  "nodelta"])
def test_a_write_moves_the_stamps_of_what_it_touched(pair, kind):
    """Stamps are per (field, view), as in the reference: a write to f
    makes every read of f miss and refill, with the write in its answer,
    and the reads of g alone still hit."""
    oracle = _load(pair)
    _write(pair, oracle, "compaction")  # the loads' deltas into the base
    reads = READS_F + READS_G
    for _ in range(2):
        for q in reads:
            query(pair, q)
    if kind in ("compaction", "nodelta"):
        # a pending delta for the compaction to merge, and the reads
        # that do not merge it refilled over it
        query(pair, f"Set({W + 3}, f=1)")
        oracle.add("f", 1, [W + 3])
        for q in READS_F[:3] + READS_F[5:6]:
            query(pair, q)
    st = Stats(pair)
    _write(pair, oracle, kind)
    after = {q: query(pair, q) for q in reads}
    d = st.delta()
    # MaxRow(field=f) reads the row totals TopN(f, n=3) refilled, and
    # Store's own source read is one more miss
    assert d["misses"] == len(READS_F) - 1 + (kind == "Store"), d
    assert d["hits"] == len(READS_G) + 1, d
    assert query(pair, "Count(Row(f=1))") == [len(oracle("f", 1))]
    assert query(pair, "Row(f=1)")[0]["columns"] == sorted(oracle("f", 1))
    assert query(pair, "Count(Shift(Row(f=1), n=5))") == \
        [len(shifted(oracle("f", 1), 5))]
    # a whole-matrix read (TopN, GroupBy, MaxRow) merged the write's
    # pending delta after the reads before it refilled: one more round
    # refills those, and then every read hits
    for q in reads:
        assert query(pair, q) == after[q]
    st3 = Stats(pair)
    for q in reads:
        assert query(pair, q) == after[q]
    d3 = st3.delta()
    assert (d3["misses"], d3["hits"]) == (0, len(reads)), d3


# -------------------------------------------------------- the new calls


NEW_CALLS = [
    ("Count(Shift(Row(f=1)))", 200),
    ("Shift(Row(f=1), n=0)", 200),
    ("Count(Shift(Row(f=3), n=65535))", 200),
    ("Shift(Shift(Row(g=1), n=2), n=40)", 200),
    ("Count(Shift(Row(f=1), n=-1))", 400),
    ("Shift(Row(f=1), Row(f=2))", 400),
    ("MinRow(field=f)", 200), ("MaxRow(field=f)", 200),
    ("MinRow(Row(g=2), field=f)", 200), ("MaxRow(Not(Row(g=1)), field=g)",
                                         200),
    ("MinRow(Row(g=9), field=f)", 200), ("MaxRow(field=nope)", 400),
    ("MinRow()", 400),
]


@pytest.mark.parametrize("flags", ["", "?shards=1", "?shards=0,2",
                                   "?nocache=1"])
def test_shift_and_minrow_maxrow_answer_alike(pair, flags):
    _load(pair)
    for q, status in NEW_CALLS:
        both(pair, "/index/i/query" + flags, q.encode(), status=status)
        both(pair, "/index/i/query" + flags, q.encode(), status=status)


def _files(root: str, ext: str) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            if n.endswith(ext):
                with open(os.path.join(d, n), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, n), root)] = fh.read()
    return out


def test_store_and_clearrow_answer_and_log_alike(pair):
    oracle = _load(pair)
    steps = [
        ("Store(Row(f=2), f=9)", True),
        ("Store(Row(f=2), f=9)", False),
        ("Store(Intersect(Row(f=1), Row(g=1)), g=1)", True),
        ("Store(Shift(Row(f=4), n=9), f=4)", True),
        ("Store(Row(f=77), f=3)", True),
        ("ClearRow(f=2)", True),
        ("ClearRow(f=2)", False),
        ("ClearRow(f=77)", False),
        ("Store(Union(Row(f=1), Row(g=2)), f=2)", True),
    ]
    expect = {
        0: lambda: oracle.rows.__setitem__(("f", 9), oracle("f", 2)),
        2: lambda: oracle.rows.__setitem__(("g", 1),
                                           oracle("f", 1) & oracle("g", 1)),
        3: lambda: oracle.rows.__setitem__(("f", 4),
                                           shifted(oracle("f", 4), 9)),
        4: lambda: oracle.rows.__setitem__(("f", 3), set()),
        5: lambda: oracle.rows.__setitem__(("f", 2), set()),
        8: lambda: oracle.rows.__setitem__(("f", 2),
                                           oracle("f", 1) | oracle("g", 2)),
    }
    for i, (q, changed) in enumerate(steps):
        assert query(pair, "Count(Row(f=9)) TopN(f) Count(Row(g=1))") == \
            query(pair, "Count(Row(f=9)) TopN(f) Count(Row(g=1))")
        assert query(pair, q) == [changed], q
        if i in expect:
            expect[i]()
        for f, r in (("f", 9), ("g", 1), ("f", 4), ("f", 3), ("f", 2)):
            assert query(pair, f"Row({f}={r})")[0]["columns"] == \
                sorted(oracle(f, r)), (q, f, r)
            assert query(pair, f"Count(Row({f}={r}))") == \
                [len(oracle(f, r))], (q, f, r)
        query(pair, "GroupBy(Rows(f), Rows(g))")
    both(pair, "/index/i/query", b"Store(Row(f=1))", status=400)
    both(pair, "/index/i/query", b"Store(Row(f=1), v=1)", status=200)
    both(pair, "/index/i/query", b"ClearRow(v=1)", status=400)
    snapqueue.drain()
    jf, tf = (_files(s.data_dir, ".wal") for s in pair)
    assert sorted(tf) == sorted(jf) and jf
    for k in jf:
        assert tf[k] == jf[k], k


# ------------------------------------------------ the cache classes alike


def _sequence(mod, name: str) -> list:
    """One call sequence on a fresh cache of ``mod``; returns every
    answer and the final counters."""
    out = []
    if name == "basic":
        c = mod.ResultCache()
        out.append(c.get("a", (1,), 0))
        out.append(c.put("a", (1,), 5, 32))
        out.append(c.get("a", (1,), 0))
        out.append(c.get("a", (2,), 0))  # stamp moved: invalidation
        out.append(c.put("a", (2,), 6, 32))
        out.append(c.get("a", (2,), 0))
    elif name == "budget":
        c = mod.ResultCache(budget_bytes=1000, max_entry_bytes=600)
        for i in range(6):
            out.append(c.put(i, (0,), i, 100 + 40 * i))
        out.append(c.put("big", (0,), 0, 500))  # past max_entry_bytes
        out.append(c.get("big", (0,), 0))
        out.append([c.get(i, (0,), 0) for i in range(6)])
        out.append(c.put("big", (0,), 1, 100))
        out.append(c.get("big", (0,), 0))
    elif name == "disabled":
        c = mod.ResultCache(enabled=False)
        out.append(c.put("a", (1,), 5, 32))
        out.append(c.get("a", (1,), 0))
    elif name == "invalidate_all":
        c = mod.ResultCache()
        for i in range(3):
            c.put(i, (i,), i, 8)
        out.append(c.invalidate_all())
        out.append(c.get(1, (1,), 0))
    else:
        raise AssertionError(name)
    stats = c.stats_dict()
    return out, stats


@pytest.mark.parametrize("name", ["basic", "budget", "disabled",
                                  "invalidate_all"])
def test_the_cache_classes_answer_alike(name):
    assert _sequence(trc, name) == _sequence(jrc, name)
    assert (trc.DEFAULT_BUDGET_BYTES, trc.DEFAULT_MAX_ENTRY_BYTES,
            trc.ENTRY_OVERHEAD_BYTES, trc.FLIGHT_WAIT_S, trc.FLIGHT_TTL_S) \
        == (jrc.DEFAULT_BUDGET_BYTES, jrc.DEFAULT_MAX_ENTRY_BYTES,
            jrc.ENTRY_OVERHEAD_BYTES, jrc.FLIGHT_WAIT_S, jrc.FLIGHT_TTL_S)
    for v in ({1: [2, 3]}, "abc", np.zeros(7, dtype=np.uint32), (1, 2.0)):
        assert trc.result_nbytes(v) == jrc.result_nbytes(v)
    k = ("x", 1, (2, 3))
    assert trc.key_digest(trc.Key(k)) == jrc.key_digest(jrc.Key(k))


def _flight(mod, n: int = 6) -> tuple:
    """A leader misses, ``n`` same-stamp followers join its flight, the
    leader fills: every follower is served the fill."""
    c = mod.ResultCache()
    assert c.get("k", (1,), 0) == (False, None)  # the leader's miss
    got: list = []

    def follow():
        got.append(c.get("k", (1,), 5.0))

    ts = [threading.Thread(target=follow) for _ in range(n)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 10
    while c.flight_joins < n and time.monotonic() < deadline:
        time.sleep(0.005)
    # a different stamp never joins the open flight
    other = c.get("k", (2,), 0)
    c.put("k", (1,), 42, 32)
    for t in ts:
        t.join(timeout=10)
    return got, other, c.stats_dict()


def test_single_flight_serves_the_followers_alike():
    got, other, stats = _flight(trc)
    assert got == [(True, 42)] * 6 and other == (False, None)
    assert (stats["flightJoins"], stats["flightServed"], stats["fills"]) \
        == (6, 6, 1)
    assert (got, other, stats) == _flight(jrc)


# ----------------------------------------------------- the port below HTTP


@pytest.fixture
def executor(tmp_path):
    holder = THolder(str(tmp_path / "h"), device="cpu")
    idx = holder.create_index("i")
    rng = np.random.default_rng(3)
    for fname in ("f", "g"):
        f = idx.create_field(fname)
        for r in (1, 2, 3):
            cols = rng.choice(N_SHARDS * W, size=400, replace=False)
            f.import_bits(np.full(len(cols), r), cols)
    ex = TExecutor(holder, device="cpu")
    try:
        yield ex
    finally:
        holder.close()


@pytest.mark.parametrize("q", [
    "Count(Intersect(Row(f=1), Row(g=2)))", "Count(Shift(Row(f=1), n=4))",
    "Union(Row(f=1), Row(g=1))", "TopN(f, Row(g=1))",
    "GroupBy(Rows(f), Rows(g), filter=Row(g=3))", "MaxRow(Row(g=1), field=f)",
])
def test_a_hit_launches_nothing(executor, q):
    # twice: a GroupBy whose filter reads a child field with a pending
    # delta stamps the filter before its probe merges that delta, so its
    # first fill is dead on arrival, as in the reference
    want = executor.execute("i", q)
    assert executor.execute("i", q) == want
    with tbm.dispatch_counter() as dc:
        assert executor.execute("i", q) == want
    assert dc.launches == []
    with tbm.dispatch_counter() as dc:
        assert executor.execute("i", q, opt=TOpts(cache=False)) == want
    assert dc.launches


def test_concurrent_cold_counts_make_one_fill(executor, monkeypatch):
    """32 identical cold Counts: one leader computes, the others join its
    flight and are served its fill."""
    from pilosa_tpu_torch.ops import containers

    real = containers.plan_fused
    calls: list = []

    def slow(*args, **kw):
        calls.append(1)
        time.sleep(0.3)
        return real(*args, **kw)

    monkeypatch.setattr(containers, "plan_fused", slow)
    q = "Count(Intersect(Row(f=3), Row(g=3)))"
    rc = trc.cache()
    base = rc.stats_dict()
    bar = threading.Barrier(32)
    out: list = []

    def run():
        bar.wait()
        out.append(executor.execute("i", q)[0])

    ts = [threading.Thread(target=run) for _ in range(32)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    s = rc.stats_dict()
    assert len(out) == 32 and len(set(out)) == 1
    assert len(calls) == 1
    assert s["fills"] - base["fills"] == 1
    assert s["flightServed"] - base["flightServed"] == 31
    assert out[0] == executor.execute("i", q, opt=TOpts(cache=False))[0]


def test_a_coalesced_count_fills_the_key_the_direct_path_probes(executor):
    executor.coalescer = tco.Coalescer(enabled=True, window_s=0.5,
                                       max_batch=4)
    qs = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=1)))",
          "Count(Union(Row(f=2), Row(g=2)))", "Count(Xor(Row(f=3), Row(g=1)))"]
    bar = threading.Barrier(len(qs))
    out: dict = {}

    def run(q):
        bar.wait()
        out[q] = executor.execute("i", q)[0]

    ts = [threading.Thread(target=run, args=(q,)) for q in qs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    executor.coalescer = None
    for q in qs:
        with tbm.dispatch_counter() as dc:
            assert executor.execute("i", q)[0] == out[q]
        assert dc.launches == [], q
        assert out[q] == executor.execute("i", q, opt=TOpts(cache=False))[0]


def test_the_server_knobs_are_retained_and_released(tmp_path):
    rc = trc.cache()
    was = {k: getattr(rc, k) for k in _KNOBS}
    a = TServer(str(tmp_path / "a"), device="cpu", cache_enabled=False,
                cache_budget_bytes=1 << 20, cache_max_entry_bytes=1 << 10,
                cache_ttl=2.5)
    assert (rc.enabled, rc.budget, rc.max_entry_bytes, rc.ttl_s) == \
        (False, 1 << 20, 1 << 10, 2.5)
    b = TServer(str(tmp_path / "b"), device="cpu")
    assert rc.enabled is True and rc.budget == 1 << 20
    a.open()
    a.close()
    a.close()  # idempotent: the sibling's reference stays
    assert trc.refs() == 1 and rc.enabled is True
    b.close()
    assert {k: getattr(rc, k) for k in _KNOBS} == was
