"""Mutex, bool and time fields: a port server against a JAX-package server
on the same writes, both at their defaults (delta planes on, result cache
on, coalescer on), mesh off, on the CPU at the test width (2^16 columns
per shard).

The writes: PQL ``Set``/``Clear`` with timestamps and bool literals,
``/import`` with timestamps (unix seconds and ISO strings), mutex moves by
``/import`` and by ``Set``, a clearing ``/import``, ``/import-roaring``
with named time views, and the refusals (a roaring import into a mutex or
bool field, a bool row past 1, a timestamp into a field with no quantum,
a time range over a set field).  Then, with zero tolerance:

- Count, Row, Rows, TopN and GroupBy over the mutex, bool and time fields
  answer byte-identical JSON, coalesced, with ``?nocoalesce=true``, per
  shard (``?shards=``) and with ``?nocache=1``, and the counts equal a
  set oracle that keeps one row per column;
- a cached open-ended time-range Count moves when a write creates a new
  day view;
- the ``.wal`` files are byte-identical after the writes (a mutex
  fragment's clear-then-set records included), and the ``.snap`` files
  after a snapshot.

The fixture restores exactly the process-wide fields the servers touch.
"""

from __future__ import annotations

import base64
import datetime as dt
import json
import os
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
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.runtime import resultcache as trc
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import roaring

W = SHARD_WIDTH
N_SHARDS = 3
_INGEST = ("delta_enabled", "delta_budget_bytes", "compact_threshold_bits",
           "compact_interval")
_CACHE = ("enabled", "budget", "max_entry_bytes", "ttl_s")
DAY0 = dt.datetime(2024, 1, 29)


@pytest.fixture(autouse=True)
def _configuration():
    """Mesh off; restores both [ingest] configs and baselines, both
    [containers] configs, both result caches' knobs and the mesh config,
    and checks that both compactors' retain counts are back."""
    mesh_was = (meshexec._cfg.enabled, meshexec._cfg.axis_size)
    ing = [{k: getattr(m.config(), k) for k in _INGEST}
           for m in (jingest, tingest)]
    bases = (jingest._baseline, tingest._baseline)
    cts = [{k: getattr(m.config(), k) for k in type(m.config()).__slots__}
           for m in (jct, tct)]
    rcs = [{k: getattr(m.cache(), k) for k in _CACHE} for m in (jrc, trc)]
    refs = (jcompactor.refs(), tcompactor.refs())
    meshexec.configure(enabled=False)
    try:
        yield
    finally:
        assert (jcompactor.refs(), tcompactor.refs()) == refs
        for m, was in zip((jrc, trc), rcs):
            for k, v in was.items():
                setattr(m.cache(), k, v)
        for m, was in zip((jct, tct), cts):
            m.configure(**was)
        for m, was in zip((jingest, tingest), ing):
            m.configure(**was)
        jingest._baseline, tingest._baseline = bases
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])


@pytest.fixture
def pair(tmp_path):
    js = JServer(str(tmp_path / "j"), mesh_enabled=False,
                 coalescer_enabled=True, ragged_prewarm=False,
                 ingest_compact_interval=3600.0)
    ts = TServer(str(tmp_path / "t"), device="cpu", coalescer_enabled=True,
                 ingest_compact_interval=3600.0)
    try:
        js.open()
        ts.open()
        yield js, ts
    finally:
        js.close()
        ts.close()


def _req(uri: str, path: str, body: bytes | None = None,
         ctype: str = "application/json") -> tuple[int, bytes]:
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
         ctype: str = "application/json", status: int = 200) -> bytes:
    """The same request to both servers: the same status and bytes."""
    want = _req(pair[0].uri, path, body, ctype)
    got = _req(pair[1].uri, path, body, ctype)
    assert got == want, (path, body, got[1][:300], want[1][:300])
    assert want[0] == status, want
    return want[1]


def query(pair, pql: str, flags: str = "", status: int = 200):
    out = json.loads(both(pair, "/index/i/query" + flags, pql.encode(),
                          "text/plain", status))
    return out.get("results", out)


def _files(root: str, ext: str) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            if n.endswith(ext):
                with open(os.path.join(d, n), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, n), root)] = fh.read()
    return out


def same_files(pair, ext: str) -> dict:
    jf, tf = (_files(s.data_dir, ext) for s in pair)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        assert tf[k] == jf[k], k
    return jf


class Oracle:
    """Columns per (field, row); a time bit keeps its timestamps."""

    def __init__(self):
        self.bits: dict = {}
        self.stamps: dict = {}  # (field, row) -> {col: set of datetimes}

    def set(self, f, r, c, ts=None, mutex=False, std=True):
        if mutex:
            for (g, _r), cols in self.bits.items():
                if g == f:
                    cols.discard(c)
        if std:
            self.bits.setdefault((f, r), set()).add(c)
        if ts is not None:
            self.stamps.setdefault((f, r), {}).setdefault(c, set()).add(ts)

    def clear(self, f, r, c):
        self.bits.get((f, r), set()).discard(c)
        self.stamps.get((f, r), {}).pop(c, None)

    def __call__(self, f, r) -> set:
        return self.bits.get((f, r), set())

    def days(self, f, r, lo: dt.datetime, hi: dt.datetime) -> set:
        """Columns with a timestamp whose day lies in [lo, hi)."""
        return {c for c, tss in self.stamps.get((f, r), {}).items()
                if any(lo <= dt.datetime(t.year, t.month, t.day) < hi
                       for t in tss)}


def _schema(pair) -> None:
    both(pair, "/index/i", b"{}")
    for name, opts in (("f", {}),
                       ("t", {"type": "time", "timeQuantum": "YMD"}),
                       ("h", {"type": "time", "timeQuantum": "YMDH",
                              "noStandardView": True}),
                       ("m", {"type": "mutex"}),
                       ("b", {"type": "bool"})):
        both(pair, f"/index/i/field/{name}",
             json.dumps({"options": opts}).encode())


def _load(pair, oracle: Oracle, rng) -> None:
    _schema(pair)
    cols = rng.choice(N_SHARDS * W, size=600, replace=False)
    # f: a set field to intersect with
    f_cols = [int(c) for c in cols[::2]]
    both(pair, "/index/i/field/f/import", json.dumps(
        {"rowIDs": [1] * len(f_cols), "columnIDs": f_cols}).encode())
    for c in f_cols:
        oracle.set("f", 1, c)
    # t: PQL Sets with timestamps over 7 days across a month boundary
    sets = []
    for c in cols[100:160]:
        r = int(rng.integers(1, 3))
        ts = DAY0 + dt.timedelta(days=int(rng.integers(0, 7)),
                                 hours=int(rng.integers(0, 24)))
        sets.append(f"Set({int(c)}, t={r}, {ts:%Y-%m-%dT%H:%M})")
        oracle.set("t", r, int(c), ts)
    assert len(query(pair, " ".join(sets))) == len(sets)
    # t and h: /import with unix seconds, ISO strings and a None
    rows, ccols, stamps = [], [], []
    for i, c in enumerate(cols[160:260]):
        ts = DAY0 + dt.timedelta(days=int(rng.integers(-3, 9)),
                                 hours=int(rng.integers(0, 24)))
        rows.append(int(rng.integers(1, 3)))
        ccols.append(int(c))
        if i == 7:
            stamps.append(None)
        elif i % 2:
            stamps.append(int(ts.replace(tzinfo=dt.timezone.utc)
                              .timestamp()))
        else:
            stamps.append(f"{ts:%Y-%m-%dT%H:%M}")
        stamps_dt = None if stamps[-1] is None else ts
        oracle.set("t", rows[-1], int(c), stamps_dt)
        oracle.set("h", rows[-1], int(c), stamps_dt, std=False)
    for fld in ("t", "h"):
        both(pair, f"/index/i/field/{fld}/import", json.dumps(
            {"rowIDs": rows, "columnIDs": ccols,
             "timestamps": stamps}).encode())
    # t: /import-roaring with named views (standard, a year, a day)
    off = [int(c) % W for c in cols[260:300] if int(c) // W == 1]
    pos = np.asarray([3 * W + o for o in off], dtype=np.uint64)
    blob = base64.b64encode(roaring.encode(
        *roaring.positions_to_containers(pos))).decode()
    both(pair, "/index/i/field/t/import-roaring/1", json.dumps(
        {"views": {"": blob, "standard_2024": blob,
                   "standard_20240203": blob}}).encode())
    for o in off:
        oracle.set("t", 3, W + o, dt.datetime(2024, 2, 3))
    # m: every column of cols[300:] in a row, then moved by /import and
    # by Set; b: true/false
    mc = [int(c) for c in cols[300:]]
    mr = [int(r) for r in rng.integers(1, 6, size=len(mc))]
    both(pair, "/index/i/field/m/import", json.dumps(
        {"rowIDs": mr, "columnIDs": mc}).encode())
    for r, c in zip(mr, mc):
        oracle.set("m", r, c, mutex=True)
    moved = mc[:80]
    mr2 = [int(r) for r in rng.integers(1, 6, size=len(moved))]
    both(pair, "/index/i/field/m/import", json.dumps(
        {"rowIDs": mr2, "columnIDs": moved}).encode())
    for r, c in zip(mr2, moved):
        oracle.set("m", r, c, mutex=True)
    pql = []
    for c in mc[80:110]:
        r = int(rng.integers(1, 8))
        pql.append(f"Set({c}, m={r})")
        oracle.set("m", r, c, mutex=True)
    query(pair, " ".join(pql))
    bc = [int(c) for c in cols[:400]]
    bv = [bool(v) for v in rng.integers(0, 2, size=len(bc))]
    query(pair, " ".join(f"Set({c}, b={'true' if v else 'false'})"
                         for c, v in zip(bc, bv)))
    for c, v in zip(bc, bv):
        oracle.set("b", int(v), c, mutex=True)
    both(pair, "/index/i/field/b/import", json.dumps(
        {"rowIDs": [1] * 40, "columnIDs": bc[:40]}).encode())
    for c in bc[:40]:
        oracle.set("b", 1, c, mutex=True)


QUERIES = [
    "Count(Row(m=1))", "Count(Row(m=6))", "Row(m=2)",
    "Count(Intersect(Row(m=3), Row(f=1)))",
    "Count(Union(Row(m=1), Row(m=2), Row(m=7)))",
    "Count(Row(b=true))", "Count(Row(b=false))", "Row(b=true)",
    "Count(Intersect(Row(b=false), Row(m=1)))",
    "Count(Row(b=1))", "Count(Not(Row(b=true)))",
    "Count(Row(t=1))", "Count(Row(t=2))", "Count(Row(h=1))",
    "Count(Row(t=1, from=2024-01-30T00:00, to=2024-02-02T00:00))",
    "Count(Row(t=2, from='2024-01-01T00:00', to='2024-03-01T00:00'))",
    "Count(Row(t=1, from=2024-02-01T00:00))",
    "Count(Row(t=2, to=2024-01-31T00:00))",
    "Count(Row(t=1, from=2019-01-01T00:00, to=2019-02-01T00:00))",
    "Count(Row(t=3, from=2024-02-03T00:00, to=2024-02-04T00:00))",
    "Count(Row(h=2, from=2024-01-30T05:00, to=2024-02-01T13:00))",
    "Count(Intersect(Row(t=1, from=2024-01-29T00:00, "
    "to=2024-02-05T00:00), Row(f=1)))",
    "Row(t=2, from=2024-01-31T00:00, to=2024-02-02T00:00)",
    "Range(t=1, 2024-01-30T00:00, 2024-02-03T00:00)",
    "Rows(t)", "Rows(t, from=2024-02-01T00:00, to=2024-02-05T00:00)",
    "Rows(h)", "Rows(m)", "Rows(b)", "Rows(m, limit=3)",
    "TopN(m)", "TopN(m, n=3)", "TopN(m, Row(f=1), n=8)", "TopN(b)",
    "TopN(t, Row(f=1), n=5)", "TopN(t)",
    "GroupBy(Rows(m), Rows(b))", "GroupBy(Rows(b), filter=Row(f=1))",
    "GroupBy(Rows(t), Rows(m))",
    "MinRow(field=m)", "MaxRow(field=m)",
]


def _check(pair, oracle: Oracle) -> None:
    for flags in ("", "?nocoalesce=true", "?shards=1", "?nocache=1"):
        for q in QUERIES:
            query(pair, q, flags)
    # one row per column in the mutex and bool fields, as the oracle
    for fld, top in (("m", 8), ("b", 2)):
        seen: dict = {}
        for r in range(top):
            cols = query(pair, f"Row({fld}={r})")[0]["columns"]
            assert set(cols) == oracle(fld, r), (fld, r)
            for c in cols:
                assert c not in seen, (fld, c, seen.get(c), r)
                seen[c] = r
    got = query(pair, "Count(Intersect(Row(b=false), Row(m=1)))")
    assert got == [len(oracle("b", 0) & oracle("m", 1))]
    lo, hi = dt.datetime(2024, 1, 30), dt.datetime(2024, 2, 2)
    got = query(pair, f"Count(Row(t=1, from={lo:%Y-%m-%dT%H:%M}, "
                      f"to={hi:%Y-%m-%dT%H:%M}))")
    assert got == [len(oracle.days("t", 1, lo, hi))]


def test_time_mutex_and_bool_fields_match_the_reference(pair):
    oracle = Oracle()
    _load(pair, oracle, np.random.default_rng(2024))
    assert tingest.config().delta_enabled and jingest.config().delta_enabled
    # the refusals answer the same status and body
    for path, body, ctype in (
            ("/index/i/field/m/import-roaring/0", b'{"views": {"": ""}}',
             "application/json"),
            ("/index/i/field/b/import-roaring/0", b'{"views": {"": ""}}',
             "application/json"),
            ("/index/i/field/b/import",
             b'{"rowIDs": [2], "columnIDs": [5]}', "application/json"),
            ("/index/i/query", b"Set(5, b=2)", "text/plain"),
            ("/index/i/query", b"Set(5, f=1, 2024-01-01T00:00)",
             "text/plain"),
            ("/index/i/query", b"Set(5, m=1, 2024-01-01T00:00)",
             "text/plain"),
            ("/index/i/query", b"Count(Row(f=1, from=2024-01-01T00:00))",
             "text/plain"),
            ("/index/i/query", b"Count(Row(t=1, from='junk'))",
             "text/plain")):
        both(pair, path, body, ctype, status=400)
    _check(pair, oracle)

    # writes: mutex moves with ingest on, bool flips, a time Clear
    c = sorted(oracle("m", 1))[0]
    c2 = sorted(oracle("b", 0))[0]
    t1 = sorted(oracle("t", 1))[0]
    assert query(pair, f"Set({c}, m=7) Set({c}, m=7) Set({c2}, b=true) "
                       f"Clear({c2}, b=true) Set({c2}, b=false) "
                       f"Clear({t1}, t=1)") == [
        True, False, True, True, True, True]
    oracle.set("m", 7, c, mutex=True)
    oracle.set("b", 0, c2, mutex=True)
    oracle.clear("t", 1, t1)
    both(pair, "/index/i/field/m/import?clear=true", json.dumps(
        {"rowIDs": [7], "columnIDs": [c]}).encode())
    oracle.clear("m", 7, c)
    _check(pair, oracle)

    # a cached open-ended time-range Count moves with a new day view
    q = "Count(Row(t=2, from=2024-02-01T00:00))"
    before = query(pair, q)
    assert query(pair, q) == before
    col = next(x for x in range(N_SHARDS * W) if x not in oracle("t", 2))
    query(pair, f"Set({col}, t=2, 2024-02-12T10:00)")
    oracle.set("t", 2, col, dt.datetime(2024, 2, 12, 10))
    assert query(pair, q) == [before[0] + 1]
    assert query(pair, q) == [len(oracle.days(
        "t", 2, dt.datetime(2024, 2, 1), dt.datetime(2030, 1, 1)))]

    snapqueue.drain()
    wal = same_files(pair, ".wal")
    assert any("/m/views/standard/" in k for k in wal)
    assert any("standard_20240203" in k for k in wal)
    # mutex moves wrote clear records before the set record
    mwal = b"".join(v for k, v in wal.items() if "/m/views/" in k)
    assert mwal.count(b"\x02") > 0
    # a compaction, then the snapshots
    for comp in (jcompactor.compactor(), tcompactor.compactor()):
        comp.run_once(force=True)
    for srv in pair:
        srv.holder.snapshot()
    snaps = same_files(pair, ".snap")
    assert any("/m/views/standard/" in k for k in snaps)
    assert any("standard_202402" in k for k in snaps)
    same_files(pair, ".wal")
    _check(pair, oracle)


@pytest.mark.parametrize("quantum", ["Y", "YM", "YMD", "YMDH", "M", "MD",
                                     "MDH", "D", "DH", "H"])
def test_time_quanta_write_the_same_views(pair, quantum):
    both(pair, "/index/i", b"{}")
    both(pair, "/index/i/field/q", json.dumps(
        {"options": {"type": "time", "timeQuantum": quantum}}).encode())
    rng = np.random.default_rng(len(quantum) * 7 + ord(quantum[0]))
    pql = []
    for _ in range(30):
        ts = dt.datetime(2023, 12, 30) + dt.timedelta(
            hours=int(rng.integers(0, 24 * 70)))
        pql.append(f"Set({int(rng.integers(0, 2 * W))}, q=1, "
                   f"{ts:%Y-%m-%dT%H:%M})")
    query(pair, " ".join(pql))
    for frm, to in (("2023-12-31T05:00", "2024-02-10T17:00"),
                    ("2024-01-01T00:00", "2025-01-01T00:00"), (None, None)):
        args = "".join(f", {k}={v}" for k, v in (("from", frm), ("to", to))
                       if v is not None)
        query(pair, f"Count(Row(q=1{args}))")
        query(pair, f"Row(q=1{args})", "?shards=0")
        query(pair, f"Rows(q{args})")
    snapqueue.drain()
    same_files(pair, ".wal")
