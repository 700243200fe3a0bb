"""String keys: a port server against a JAX-package server on the same
keyed writes, both at their defaults (delta planes, result cache and
coalescer on), mesh off, on the CPU at the test width.

The schema: a keyed index ``ki`` (string column keys, 135,000 of them, so
that its columns span three shards) with a keyed set field ``kf``, an
unkeyed set field ``g`` and a keyed mutex field ``km``; an unkeyed index
``i`` with a keyed set field ``kf`` and a plain field ``f`` over three
shards.  The writes: ``/import`` with ``rowKeys``/``columnKeys``, PQL
``Set``/``Clear``/``Store``/``ClearRow`` with keys (misses included),
``POST /internal/translate/keys`` in JSON.  Then, with zero tolerance:

- keyed ``Row``/``Count``/``TopN``/``Rows``/``GroupBy``/``MinRow``/
  ``MaxRow``/``Not``/``Options`` answer byte-identical JSON, coalesced,
  with ``?nocoalesce=true``, with ``?nocache=1``, per shard and with
  ``?nodelta=1``, and their counts equal a set oracle;
- a keyed query and its id form answer the same counts, and share one
  result-cache entry;
- the refusals (a key on an unkeyed field or index, a missing
  ``previous`` key) carry the reference's status and wording;
- ``GET /schema`` and ``GET /index/{i}`` show ``keys``; ``/export``
  writes keys;
- every translate store holds the same rows, and the ``.wal`` and
  ``.snap`` files are byte-identical.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.runtime import snapqueue
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.runtime import resultcache as trc
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest (rootdir-less test files); another
# installed package is named ``tests``
import torch_wire_pair as wp  # noqa: E402

W = SHARD_WIDTH
N_KEYS = 2 * W + 3000
ROW_KEYS = [f"r{i}" for i in range(8)]

FLAGS = ["", "?nocoalesce=true", "?nocache=1", "?shards=0", "?shards=1,2",
         "?nodelta=1"]


@pytest.fixture(autouse=True)
def _configuration():
    with wp.configuration():
        yield


@pytest.fixture
def pair(tmp_path):
    with wp.servers(str(tmp_path)) as p:
        yield p


def query(pair, pql: str, flags: str = "", index: str = "ki",
          status: int = 200):
    out = json.loads(wp.both(pair, f"/index/{index}/query" + flags,
                             pql.encode(), "text/plain", status=status))
    return out.get("results", out)


SCHEMA = {"indexes": [
    {"name": "ki", "options": {"keys": True}, "fields": [
        {"name": "kf", "options": {"keys": True}},
        {"name": "g", "options": {}},
        {"name": "km", "options": {"type": "mutex", "keys": True}},
    ]},
    {"name": "i", "options": {}, "fields": [
        {"name": "kf", "options": {"keys": True}},
        {"name": "f", "options": {}},
    ]},
]}


class Oracle:
    """Columns (keys in ``ki``, ids in ``i``) per (index, field, row)."""

    def __init__(self):
        self.bits: dict = {}

    def set(self, i, f, r, c):
        self.bits.setdefault((i, f, r), set()).add(c)

    def clear(self, i, f, r, c):
        self.bits.get((i, f, r), set()).discard(c)

    def __call__(self, i, f, r) -> set:
        return self.bits.get((i, f, r), set())


def _load(pair, rng) -> Oracle:
    o = Oracle()
    wp.both(pair, "/schema", json.dumps(SCHEMA).encode())
    # ki/kf: every column key once, in a seeded order, under a seeded
    # row key; the ids follow the order of first appearance
    perm = rng.permutation(N_KEYS)
    col_keys = [f"c{int(n)}" for n in perm]
    rows = rng.integers(0, len(ROW_KEYS), size=N_KEYS)
    row_keys = [ROW_KEYS[int(r)] for r in rows]
    for lo in range(0, N_KEYS, 50000):
        wp.both(pair, "/index/ki/field/kf/import", json.dumps(
            {"rowKeys": row_keys[lo:lo + 50000],
             "columnKeys": col_keys[lo:lo + 50000]}).encode())
    for rk, ck in zip(row_keys, col_keys):
        o.set("ki", "kf", rk, ck)
    # ki/g: ids as rows, existing column keys
    gk = [col_keys[int(j)] for j in rng.choice(N_KEYS, 3000, replace=False)]
    gr = rng.integers(1, 4, size=len(gk))
    wp.both(pair, "/index/ki/field/g/import", json.dumps(
        {"rowIDs": [int(r) for r in gr], "columnKeys": gk}).encode())
    for r, c in zip(gr, gk):
        o.set("ki", "g", int(r), c)
    # ki/km: a keyed mutex, imported bit by bit
    mk = gk[:200]
    mr = [ROW_KEYS[int(r)] for r in rng.integers(0, 3, size=len(mk))]
    wp.both(pair, "/index/ki/field/km/import", json.dumps(
        {"rowKeys": mr, "columnKeys": mk}).encode())
    for r, c in zip(mr, mk):
        o.set("ki", "km", r, c)
    # i: keyed rows over three shards of ids, and a plain field
    cols = rng.choice(3 * W, size=6000, replace=False)
    kr = [ROW_KEYS[int(r)] for r in rng.integers(0, 6, size=len(cols))]
    wp.both(pair, "/index/i/field/kf/import", json.dumps(
        {"rowKeys": kr, "columnIDs": [int(c) for c in cols]}).encode())
    for r, c in zip(kr, cols):
        o.set("i", "kf", r, int(c))
    fc = rng.choice(3 * W, size=4000, replace=False)
    fr = rng.integers(1, 3, size=len(fc))
    wp.both(pair, "/index/i/field/f/import", json.dumps(
        {"rowIDs": [int(r) for r in fr],
         "columnIDs": [int(c) for c in fc]}).encode())
    for r, c in zip(fr, fc):
        o.set("i", "f", int(r), int(c))
    return o


def _writes(pair, o: Oracle) -> None:
    """PQL writes with keys, misses included."""
    assert query(pair, 'Set("c5", kf="r1")') == [
        "c5" not in o("ki", "kf", "r1")]
    o.set("ki", "kf", "r1", "c5")
    assert query(pair, 'Set("new-col", kf="r9")') == [True]
    o.set("ki", "kf", "r9", "new-col")
    assert query(pair, 'Set("new-col", g=2)') == [True]
    o.set("ki", "g", 2, "new-col")
    victim = sorted(o("ki", "kf", "r2"))[0]
    assert query(pair, f'Clear("{victim}", kf="r2")') == [True]
    o.clear("ki", "kf", "r2", victim)
    # a clear that names a missing key changes nothing
    assert query(pair, 'Clear("no-such-col", kf="r1")') == [False]
    assert query(pair, 'Clear("c5", kf="no-such-row")') == [False]
    assert query(pair, 'Set(7, kf="r2")', index="i") == [
        7 not in o("i", "kf", "r2")]
    o.set("i", "kf", "r2", 7)
    assert query(pair, 'Clear(7, kf="no-such-row")', index="i") == [False]
    # Store creates its row key; ClearRow of a missing key is a no-op
    query(pair, 'Store(Row(kf="r3"), kf="stored")', index="i")
    for c in o("i", "kf", "r3"):
        o.set("i", "kf", "stored", c)
    assert query(pair, 'ClearRow(kf="no-such-row")', index="i") == [False]
    query(pair, 'ClearRow(kf="r5")', index="i")
    o.bits.pop(("i", "kf", "r5"), None)


def _cases(o: Oracle):
    """(index, PQL, expected first result or None) of the reads."""
    c17 = sorted(o("ki", "kf", "r1"))[17]
    yield "ki", 'Row(kf="r1")', {"keys": sorted(
        o("ki", "kf", "r1"), key=lambda k: _ID[k])}
    yield "ki", 'Row(kf="no-such-row")', {"columns": []}
    yield "ki", 'Count(Row(kf="r1"))', len(o("ki", "kf", "r1"))
    yield "ki", 'Count(Intersect(Row(kf="r1"), Row(g=1)))', len(
        o("ki", "kf", "r1") & o("ki", "g", 1))
    yield "ki", 'Count(Union(Row(kf="r3"), Row(kf="r4")))', len(
        o("ki", "kf", "r3") | o("ki", "kf", "r4"))
    yield "ki", 'Count(Intersect(Row(kf="no-such-row"), Row(kf="r1")))', 0
    yield "ki", 'Count(Union(Row(kf="no-such-row"), Row(kf="r1")))', len(
        o("ki", "kf", "r1"))
    yield "ki", 'Count(Difference(Row(kf="r1"), Row(g=2)))', len(
        o("ki", "kf", "r1") - o("ki", "g", 2))
    yield "ki", 'Count(Not(Row(kf="r2")))', None
    yield "ki", 'Count(Row(km="r1"))', len(o("ki", "km", "r1"))
    yield "ki", "TopN(kf)", None
    yield "ki", "TopN(kf, n=3)", None
    yield "ki", "TopN(kf, Row(g=1), n=5)", None
    yield "ki", 'TopN(kf, Row(kf="no-such-row"), n=5)', []
    yield "ki", "Rows(kf)", sorted(
        {r for (i, f, r) in o.bits if (i, f) == ("ki", "kf")},
        key=lambda k: _RID[k])
    yield "ki", 'Rows(kf, previous="r2")', None
    yield "ki", f'Rows(kf, column="{c17}")', None
    yield "ki", 'Rows(kf, column="no-such-col")', []
    yield "ki", "Rows(kf, limit=3)", None
    yield "ki", "GroupBy(Rows(kf))", None
    yield "ki", "GroupBy(Rows(kf), Rows(g))", None
    yield "ki", "GroupBy(Rows(kf), filter=Row(g=1))", None
    yield "ki", 'GroupBy(Rows(kf, previous="r1"), limit=4)', None
    yield "ki", 'GroupBy(Rows(kf), filter=Row(kf="no-such-row"))', []
    yield "ki", "MinRow(field=kf)", None
    yield "ki", "MaxRow(field=kf)", None
    yield "ki", 'Options(Row(kf="r1"), excludeColumns=true)', {}
    yield "ki", 'Count(Row(kf="r6")) Row(kf="r9")', len(o("ki", "kf", "r6"))
    yield "i", 'Row(kf="r1")', {"columns": sorted(o("i", "kf", "r1"))}
    yield "i", 'Count(Intersect(Row(kf="r1"), Row(f=1)))', len(
        o("i", "kf", "r1") & o("i", "f", 1))
    yield "i", 'Count(Intersect(Row(kf="stored"), Row(f=2)))', len(
        o("i", "kf", "stored") & o("i", "f", 2))
    yield "i", 'Count(Row(kf="r5"))', 0
    yield "i", "TopN(kf, Row(f=1), n=5)", None
    yield "i", "TopN(kf)", None
    yield "i", "GroupBy(Rows(kf), Rows(f))", None
    yield "i", "Rows(kf)", None
    yield "i", "Rows(kf, column=7)", None
    yield "i", "MaxRow(field=kf)", None


_ID: dict = {}
_RID: dict = {}


def _ids(pair) -> None:
    """The port's ids of every column and row key of ``ki``, read from
    its translate stores (the JAX server's rows are checked equal)."""
    stores = wp.same_stores(pair)
    _ID.clear()
    _RID.clear()
    _ID.update({k: i for i, k in stores["ki/.keys.db"]})
    _RID.update({k: i for i, k in stores["ki/kf/.keys.db"]})


def test_keyed_reads_writes_and_files_match_the_reference(pair):
    rng = np.random.default_rng(16)
    o = _load(pair, rng)
    _writes(pair, o)
    _ids(pair)
    for index, pql, want in _cases(o):
        for flags in FLAGS:
            got = query(pair, pql, flags, index=index)
            if want is not None and flags not in ("?shards=0",
                                                  "?shards=1,2"):
                assert got[0] == want, (index, pql, flags)
    # a keyed TopN and GroupBy answer with keys, counted as the oracle
    top = query(pair, "TopN(kf)")[0]
    assert {p["key"]: p["count"] for p in top} == {
        r: len(o("ki", "kf", r)) for r in ROW_KEYS + ["r9"]
        if o("ki", "kf", r)}
    groups = query(pair, "GroupBy(Rows(kf), Rows(g))")[0]
    for gc in groups:
        (a, b) = gc["group"]
        assert a["field"] == "kf" and b["field"] == "g"
        assert gc["count"] == len(o("ki", "kf", a["rowKey"])
                                  & o("ki", "g", b["rowID"]))
    top = query(pair, "TopN(kf, Row(f=1), n=5)", index="i")[0]
    assert all(p["count"] == len(o("i", "kf", p["key"]) & o("i", "f", 1))
               for p in top)

    # exports write keys where the field or index has them
    for index, field in (("ki", "kf"), ("ki", "g"), ("i", "kf")):
        for shard in range(3):
            wp.both(pair, f"/export?index={index}&field={field}"
                          f"&shard={shard}")

    snapqueue.drain()
    wp.same_stores(pair)
    wp.same_files(pair, ".wal")
    for comp in (jcompactor.compactor(), tcompactor.compactor()):
        comp.run_once(force=True)
    for srv in pair:
        srv.holder.snapshot()
    wp.same_files(pair, ".snap")
    wp.same_files(pair, ".wal")


def test_a_keyed_query_and_its_id_form_share_a_cache_entry(pair):
    rng = np.random.default_rng(17)
    o = _load(pair, rng)
    _ids(pair)
    ts = pair[1]
    rid = {k: i for i, k in wp.stores(ts.data_dir)["i/kf/.keys.db"]}
    trc.cache().invalidate_all()
    keyed = 'Count(Intersect(Row(kf="r1"), Row(f=1)))'
    ided = f"Count(Intersect(Row(kf={rid['r1']}), Row(f=1)))"
    want = len(o("i", "kf", "r1") & o("i", "f", 1))
    assert query(pair, keyed, index="i") == [want]
    fills = trc.cache().debug()["fills"]
    hits = trc.cache().debug()["hits"]
    assert query(pair, ided, index="i") == [want]
    assert trc.cache().debug()["hits"] == hits + 1
    assert trc.cache().debug()["fills"] == fills


@pytest.mark.parametrize("index,pql", [
    ("i", 'Set("a", f=1)'),
    ("i", 'Set(1, f="a")'),
    ("i", 'Row(f="a")'),
    ("i", 'Count(Row(f="a"))'),
    ("i", 'Clear("a", f=1)'),
    ("i", 'Row(nof="a")'),
    ("i", 'Rows(f, previous="a")'),
    ("i", 'Rows(f, column="a")'),
    ("i", 'SetRowAttrs(f, "a", x=1)'),
    ("i", 'SetColumnAttrs("a", x=1)'),
    ("ki", 'Rows(kf, previous="no-such-row")'),
    ("ki", 'Row(g="a")'),
    ("ki", 'Store(Row(kf="r1"), g="a")'),
    ("ki", "_Empty()"),
    ("ki", 'Count(Row(kf="r1", from="2020-01-01T00:00"))'),
])
def test_key_refusals_carry_the_reference_wording(pair, index, pql):
    wp.both(pair, "/schema", json.dumps(SCHEMA).encode())
    query(pair, 'Set("c1", kf="r1")')
    query(pair, "Set(1, f=1)", index="i")
    got = wp.both(pair, f"/index/{index}/query", pql.encode(), "text/plain",
                  status=None)
    assert b"by this port yet" not in got


def test_schema_and_index_routes_show_keys(pair):
    schema = {"indexes": [{"name": "k", "options": {"keys": True},
                           "fields": [
        {"name": t, "options": dict(o, keys=True)} for t, o in (
            ("s", {}), ("m", {"type": "mutex"}), ("b", {"type": "bool"}),
            ("t", {"type": "time", "timeQuantum": "YMD"}),
            ("v", {"type": "int", "min": 0, "max": 9}))]}]}
    wp.both(pair, "/schema", json.dumps(schema).encode())
    wp.both(pair, "/index/x", json.dumps({"options": {"keys": True}}
                                         ).encode())
    wp.both(pair, "/index/x/field/y", json.dumps(
        {"options": {"keys": True, "type": "mutex"}}).encode())
    got = json.loads(wp.both(pair, "/schema"))
    assert [ix["options"]["keys"] for ix in got["indexes"]] == [True, True]
    assert all(f["options"]["keys"] for ix in got["indexes"]
               for f in ix["fields"])
    wp.both(pair, "/index/k")
    wp.both(pair, "/index")
    for q in ('Set("a", s="x")', 'Set("a", m="y")', 'Set("b", m="y")',
              'Set("a", t="z", 2024-02-03T04:05)', "Set(\"c\", v=4)",
              'Row(s="x")', 'Row(m="y")', 'Count(Row(t="z"))',
              'Row(t="z", from=2024-02-01T00:00, to=2024-02-05T00:00)',
              "Sum(field=v)", 'Row(v > 1)', "TopN(m)", "Rows(t)"):
        wp.both(pair, "/index/k/query", q.encode(), "text/plain")
    wp.same_stores(pair)
    # a deleted field or index takes its stores with it
    delete(pair, "/index/k/field/s")
    delete(pair, "/index/x")
    got = wp.same_stores(pair)
    assert "k/s/.keys.db" not in got and "x/.keys.db" not in got
    assert "k/m/.keys.db" in got


def delete(pair, path: str) -> None:
    """DELETE on both servers: the same status and bytes."""
    out = []
    for s in pair:
        r = urllib.request.Request(s.uri + path, method="DELETE")
        with urllib.request.urlopen(r, timeout=60) as resp:
            out.append((resp.status, resp.read()))
    assert out[0] == out[1] == (200, b"{}")


@pytest.mark.parametrize("body", [
    {"index": "ki", "keys": ["c1", "c2", "c1"]},
    {"index": "ki", "field": "kf", "keys": ["r1", "zz", "r1"]},
    {"index": "ki", "field": "g", "keys": ["a"]},
    {"index": "ki", "keys": []},
    {"index": "nope", "keys": ["a"]},
    {"index": "ki", "field": "nope", "keys": ["a"]},
    {"keys": ["a"]},
])
def test_translate_keys_route_in_json(pair, body):
    wp.both(pair, "/schema", json.dumps(SCHEMA).encode())
    query(pair, 'Set("c2", kf="r1")')
    wp.both(pair, "/internal/translate/keys", json.dumps(body).encode(),
            status=None)
    wp.same_stores(pair)


@pytest.mark.parametrize("path,body", [
    ("/index/ki/field/kv/import-value",
     {"columnKeys": ["c1", "c2", "zz"], "values": [5, -3, 7]}),
    ("/index/ki/field/kv/import-value",
     {"columnKeys": ["c1", "c2"], "values": [5]}),
    ("/index/ki/field/kf/import?clear=true",
     {"rowKeys": ["r1", "r1"], "columnKeys": ["c1", "nope"]}),
    ("/index/ki/field/kf/import",
     {"rowKeys": ["r1", "r2"], "columnKeys": ["c1"]}),
    ("/index/ki/field/kf/import",
     {"rowKeys": ["r3"], "columnIDs": [9]}),
    ("/index/ki/field/g/import",
     {"rowKeys": ["r1"], "columnKeys": ["c9"]}),
    ("/index/i/field/kf/import",
     {"rowKeys": ["r1"], "columnKeys": ["c9"]}),
    ("/index/ki/field/kt/import",
     {"rowKeys": ["r1", "r2"], "columnKeys": ["c1", "c3"],
      "timestamps": [1706500000, "2024-02-03T04:05"]}),
])
def test_keyed_imports_answer_as_the_reference(pair, path, body):
    wp.both(pair, "/schema", json.dumps(SCHEMA).encode())
    wp.both(pair, "/index/ki/field/kv", json.dumps(
        {"options": {"type": "int", "min": -10, "max": 10}}).encode())
    wp.both(pair, "/index/ki/field/kt", json.dumps(
        {"options": {"type": "time", "timeQuantum": "YMD", "keys": True}}
    ).encode())
    query(pair, 'Set("c1", kf="r1") Set("c2", kf="r1") Set("c3", kf="r2")')
    wp.both(pair, path, json.dumps(body).encode(), status=None)
    for index, q in (("ki", "Sum(field=kv)"), ("ki", "Row(kv > 0)"),
                     ("ki", 'Row(kf="r1")'), ("ki", "TopN(kf)"),
                     ("ki", "Rows(g)"), ("i", "Rows(kf)"),
                     ("ki", 'Row(kt="r1", from=2024-01-01T00:00, '
                            'to=2024-03-01T00:00)'), ("ki", "Rows(kt)")):
        query(pair, q, index=index)
    wp.same_stores(pair)
