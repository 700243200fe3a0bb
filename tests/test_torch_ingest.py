"""Streaming ingest as a whole: a port server against a JAX-package server,
both at their ingest defaults (delta planes on), on the CPU at the test
width (2^16 columns per shard).

The same seeded writes -- ``/import`` of sparse rows and of array-, run-
and bitmap-styled rows, sparse ``/import-roaring`` payloads (into the
delta plane) and a dense one (past 2^22 bits: into the base rows),
``Set``/``Clear`` in PQL, ``/import?clear=true`` -- go to both servers,
and then, with zero tolerance:

- every query answers byte-identical JSON: Count trees coalesced (the
  port's VM stages the pending rows as ``dfuse`` tapes) and with
  ``?nocoalesce=true`` (the dense ``dfuse`` path), ``Row`` roots, ``Not``,
  a per-shard ``?shards=`` read, ``TopN``, ``Rows``, ``GroupBy`` and
  ``?nodelta=1``, and the counts equal a set oracle;
- ``GET /debug/ingest`` is the same document (the per-fragment ages and
  the process's earlier compaction history aside);
- the ``.wal`` files are byte-identical after the writes, and the
  ``.snap`` files after a compaction;
- closed with deltas pending and reopened, both replay them into the base
  rows and answer the same.

The servers scan for compaction once an hour
(``ingest_compact_interval``), so every compaction here is a query's or
an explicit one: routes do not depend on timing.  Mesh is off in the JAX
package (one device, as the port).  The fixture restores exactly the
process-wide fields the servers and the test touch.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import ingest as jingest
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.runtime import resultcache, snapqueue
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import roaring

W = SHARD_WIDTH
N_SHARDS = 4
INTERVAL = 3600.0
_SLOTS = ("delta_enabled", "delta_budget_bytes", "compact_threshold_bits",
          "compact_interval")
#: /debug/ingest counters that are cumulative over the process
_CUMULATIVE = ("deltaWrites", "compactions", "compactedBits",
               "inlineFlushes", "compactSkipped")


@pytest.fixture(autouse=True)
def _ingest_configuration():
    """Mesh off; restores both [ingest] configs and baselines, both
    [containers] configs, the result cache switch and the mesh config,
    and checks that both compactors' retain counts are back."""
    mesh_was = (meshexec._cfg.enabled, meshexec._cfg.axis_size)
    jwas = {k: getattr(jingest.config(), k) for k in _SLOTS}
    twas = {k: getattr(tingest.config(), k) for k in _SLOTS}
    bases = (jingest._baseline, tingest._baseline)
    jct_was = {k: getattr(jct.config(), k)
               for k in type(jct.config()).__slots__}
    tct_was = {k: getattr(tct.config(), k)
               for k in type(tct.config()).__slots__}
    rc_was = resultcache.cache().enabled
    refs = (jcompactor.refs(), tcompactor.refs())
    meshexec.configure(enabled=False)
    try:
        yield
    finally:
        assert (jcompactor.refs(), tcompactor.refs()) == refs
        resultcache.cache().enabled = rc_was
        jct.configure(**jct_was)
        tct.configure(**tct_was)
        jingest.configure(**jwas)
        tingest.configure(**twas)
        jingest._baseline, tingest._baseline = bases
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])


def _open(jdir: str, tdir: str) -> tuple:
    js = JServer(jdir, mesh_enabled=False, coalescer_enabled=True,
                 ragged_prewarm=False, ingest_compact_interval=INTERVAL)
    ts = TServer(tdir, device="cpu", coalescer_enabled=True,
                 ingest_compact_interval=INTERVAL)
    js.open()
    ts.open()
    return js, ts


@pytest.fixture
def servers(tmp_path):
    js, ts = _open(str(tmp_path / "j"), str(tmp_path / "t"))
    try:
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
         ctype: str = "application/json") -> bytes:
    """The same request to both servers: equal status and bytes."""
    js, ts = pair
    want = _req(js.uri, path, body, ctype)
    got = _req(ts.uri, path, body, ctype)
    assert got == want, (path, body, got[1][:300], want[1][:300])
    assert want[0] == 200, want
    return want[1]


def query(pair, pql: str, flags: str = "") -> list:
    return json.loads(both(pair, "/index/i/query" + flags, pql.encode(),
                           "text/plain"))["results"]


def _ingest_doc(uri: str, base: dict | None = None) -> dict:
    """/debug/ingest without the ages, cumulative counters taken relative
    to ``base``."""
    st, body = _req(uri, "/debug/ingest")
    assert st == 200
    d = json.loads(body)
    for e in d["top"]:
        e.pop("ageS")
    if base is not None:
        for k in _CUMULATIVE:
            d[k] -= base[k]
    return d


def same_ingest(pair, bases) -> dict:
    jd = _ingest_doc(pair[0].uri, bases[0])
    td = _ingest_doc(pair[1].uri, bases[1])
    assert td == jd
    return td


class Oracle:
    """Columns per (field, row), and the existence row (the columns of
    every ``/import`` and ``Set``; roaring imports leave it alone), kept
    with every write."""

    def __init__(self) -> None:
        self.rows: dict = {}
        self.exist: set = set()

    def add(self, f: str, r: int, cols, clear: bool = False,
            exists: bool = False) -> None:
        s = self.rows.setdefault((f, r), set())
        cols = [int(c) for c in cols]
        if clear:
            s.difference_update(cols)
        else:
            s.update(cols)
            if exists:
                self.exist.update(cols)

    def __call__(self, f: str, r: int) -> set:
        return self.rows.get((f, r), set())


def _import(pair, oracle: Oracle, f: str, r: int, cols,
            clear: bool = False) -> None:
    cols = [int(c) for c in cols]
    body = json.dumps({"rowIDs": [r] * len(cols), "columnIDs": cols})
    both(pair, f"/index/i/field/{f}/import" + ("?clear=true" if clear
                                               else ""), body.encode())
    oracle.add(f, r, cols, clear, exists=True)


def _roaring(pair, oracle: Oracle, f: str, shard: int, rows: dict,
             clear: bool = False) -> None:
    """{row: offsets} of one shard as one raw roaring payload."""
    pos = np.sort(np.concatenate([r * W + np.asarray(o, dtype=np.int64)
                                  for r, o in rows.items()]))
    keys, words = roaring.positions_to_containers(pos.astype(np.uint64))
    both(pair, f"/index/i/field/{f}/import-roaring/{shard}"
         + ("?clear=true" if clear else ""),
         roaring.encode(keys, words), "application/octet-stream")
    for r, o in rows.items():
        oracle.add(f, r, shard * W + np.asarray(o, dtype=np.int64), clear)


def _files(root: str, ext: str) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            if n.endswith(ext):
                with open(os.path.join(d, n), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, n), root)] = fh.read()
    return out


def same_files(pair, ext: str) -> int:
    jf, tf = (_files(s.data_dir, ext) for s in pair)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        assert tf[k] == jf[k], k
    return len(jf)


def _load(pair, oracle: Oracle, rng) -> None:
    """Fields f (sparse rows), k (array, run and bitmap rows) and d; the
    writes land in the delta planes."""
    both(pair, "/index/i", b'{"options": {"trackExistence": true}}')
    for f in ("f", "k", "d"):
        both(pair, f"/index/i/field/{f}", b"{}")
    for r, n in ((1, 900), (2, 700), (3, 500), (4, 300)):
        _import(pair, oracle, "f", r,
                rng.choice(N_SHARDS * W, size=n, replace=False))
    for s in range(N_SHARDS):
        base = s * W
        _import(pair, oracle, "k", 1,
                base + np.sort(rng.choice(6000, 150, replace=False)))
        _import(pair, oracle, "k", 2, base + np.concatenate(
            [np.arange(1000, 4000), np.arange(4500, 4700)]))
        _import(pair, oracle, "k", 3, base + np.arange(s % 2, 9000, 2))
    # a sparse roaring payload per shard: under 512 bits a container
    for s in range(N_SHARDS):
        _roaring(pair, oracle, "f", s,
                 {5: rng.choice(W, 300, replace=False),
                  1: rng.choice(W, 40, replace=False)})


#: Count trees over rows with pending deltas
TREES = [
    "Intersect(Row(f=1), Row(f=2))",
    "Union(Row(f=1), Row(f=2), Row(f=3))",
    "Difference(Row(f=1), Row(f=3))",
    "Xor(Row(f=2), Row(f=5))",
    "Intersect(Row(f=1), Union(Row(f=2), Row(f=5)))",
    "Intersect(Row(k=1), Row(k=2))",
    "Union(Row(k=1), Row(k=2), Row(k=3))",
    "Difference(Row(k=3), Row(k=2))",
    "Intersect(Row(f=4), Row(k=3))",
    "Not(Row(f=1))",
]


def _set_answer(tree: str, oracle: Oracle) -> set:
    from pilosa_tpu_torch.pql import parse

    def ev(call):
        if call.name == "Row":
            f = call.field_arg()
            return oracle(f, call.args[f])
        kids = [ev(c) for c in call.children]
        if call.name == "Not":
            return oracle.exist - kids[0]
        out = set(kids[0])
        for k in kids[1:]:
            out = {"Intersect": out & k, "Union": out | k, "Xor": out ^ k,
                   "Difference": out - k}[call.name]
        return out
    return ev(parse(tree).calls[0])


def _check_trees(pair, oracle: Oracle) -> None:
    for tree in TREES:
        want = _set_answer(tree, oracle)
        for flags in ("", "?nocoalesce=true"):
            assert query(pair, f"Count({tree})", flags) == [len(want)], \
                (tree, flags)
        assert query(pair, tree)[0]["columns"] == sorted(want), tree


def _fire(uri: str, trees: list) -> dict:
    """Barrier-started concurrent Counts -> {tree: (status, body)}."""
    out: dict = {}
    bar = threading.Barrier(len(trees))

    def run(t):
        bar.wait()
        out[t] = _req(uri, "/index/i/query", f"Count({t})".encode(),
                      "text/plain")

    ts = [threading.Thread(target=run, args=(t,)) for t in trees]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=120)
    return out


def test_writes_queries_debug_ingest_wal_and_snapshots_match(
        servers, tmp_path, monkeypatch):
    pair = servers
    bases = (_ingest_doc(pair[0].uri), _ingest_doc(pair[1].uri))
    assert tingest.config().delta_enabled and jingest.config().delta_enabled
    rng = np.random.default_rng(2026)
    oracle = Oracle()
    shapes: list = []
    real_stage = tct.stage_vm

    def stage(*a, **k):
        st = real_stage(*a, **k)
        if st is not None:
            shapes.append(st.shape)
        return st

    monkeypatch.setattr(tct, "stage_vm", stage)

    _load(pair, oracle, rng)
    doc = same_ingest(pair, bases)
    assert doc["pendingBits"] > 0 and doc["compactions"] == 0
    assert same_files(pair, ".wal") > 0

    # every read fuses the pending overlays; none compacts
    _check_trees(pair, oracle)
    assert any("dfuse" in str(s) for s in shapes)
    fired = [f"Intersect(Row(f={a}), Row(f={b}))"
             for a, b in ((1, 2), (2, 3), (1, 3), (3, 4))] + [
        "Union(Row(k=1), Row(k=2))", "Xor(Row(k=2), Row(k=3))"]
    jout, tout = (_fire(srv.uri, fired) for srv in pair)
    assert tout == jout
    assert all(tout[t] == (200, json.dumps({"results": [len(
        _set_answer(t, oracle))]}).encode()) for t in fired)
    for flags in ("?shards=2", "?nocontainers=1", "?novm=1"):
        query(pair, "Count(Intersect(Row(f=1), Row(f=2)))", flags)
        query(pair, "Union(Row(f=1), Row(k=1))", flags)
    assert same_ingest(pair, bases)["compactions"] == 0

    # PQL writes, a clearing import and a clearing roaring payload
    c1 = sorted(oracle("f", 1))[0]
    writes = [("Set", c1 + 1, "f", 2), ("Set", c1 + 1, "f", 2),
              ("Clear", c1, "f", 1), ("Clear", c1, "f", 1),
              ("Set", 3 * W + 7, "k", 1), ("Clear", 3 * W + 1000, "k", 2)]
    want = []
    for op, col, f, r in writes:
        had = col in oracle(f, r)
        want.append(had != (op == "Set"))
        oracle.add(f, r, [col], clear=op == "Clear", exists=op == "Set")
    assert query(pair, " ".join(f"{op}({col}, {f}={r})"
                                for op, col, f, r in writes)) == want
    _import(pair, oracle, "f", 3, sorted(oracle("f", 3))[:50], clear=True)
    _roaring(pair, oracle, "f", 1, {2: [c - W for c in sorted(
        oracle("f", 2)) if W <= c < 2 * W][:20]}, clear=True)
    _check_trees(pair, oracle)
    same_ingest(pair, bases)
    assert same_files(pair, ".wal") > 0

    # whole-matrix readers merge the fields they scan first
    for pql in ("TopN(f, n=3)", "TopN(f, Row(k=3), n=5)", "Rows(f)",
                f"Rows(k, column={2 * W + 1001})",
                "GroupBy(Rows(f), Rows(k))",
                "GroupBy(Rows(f), filter=Row(k=3))"):
        query(pair, pql)
        same_ingest(pair, bases)
    doc = same_ingest(pair, bases)
    assert doc["compactions"] > 0

    # a dense roaring payload (past 2^22 bits) merges into the base rows;
    # its fragment is then past max_op_n, and the JAX package writes that
    # snapshot in the background: wait for it
    _roaring(pair, oracle, "d", 1, {r: np.arange(W) for r in range(70)})
    snapqueue.drain()
    _import(pair, oracle, "d", 3, [W + 5, 2 * W + 5])
    assert query(pair, "Count(Union(Row(d=3), Row(d=69)))") == [W + 1]
    same_ingest(pair, bases)

    # ?nodelta=1 compacts the rows it reads up front
    q = "Count(Intersect(Row(k=1), Row(k=3)))"
    want = len(oracle("k", 1) & oracle("k", 3))
    assert query(pair, q, "?nodelta=1") == [want]
    assert not [e for e in same_ingest(pair, bases)["top"]
                if e["field"] == "k"]
    assert query(pair, q, "?nodelta=1&nocoalesce=true") == [want]

    # a compaction, then the snapshots
    for comp in (jcompactor.compactor(), tcompactor.compactor()):
        comp.run_once(force=True)
    assert same_ingest(pair, bases)["pendingBits"] == 0
    for srv in pair:
        srv.holder.snapshot()
    assert same_files(pair, ".snap") > 0
    assert same_files(pair, ".wal") > 0
    _check_trees(pair, oracle)


def test_a_reopen_replays_pending_deltas(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    pair = _open(jdir, tdir)
    rng = np.random.default_rng(11)
    oracle = Oracle()
    try:
        _load(pair, oracle, rng)
        c = sorted(oracle("f", 1))[3]
        query(pair, f"Set({2 * W + 9}, f=4) Clear({c}, f=1)")
        oracle.add("f", 4, [2 * W + 9], exists=True)
        oracle.add("f", 1, [c], clear=True)
        assert _ingest_doc(pair[1].uri)["pendingBits"] > 0
    finally:
        for srv in pair:
            srv.close()
            srv.close()  # idempotent
    same_files(pair, ".wal")
    pair = _open(jdir, tdir)
    try:
        for srv in pair:
            f = srv.holder.index("i").field("f")
            assert all(fr._delta is None
                       for fr in f.view("standard").fragments.values())
        _check_trees(pair, oracle)
        assert query(pair, "Count(Row(f=4))") == [len(oracle("f", 4))]
    finally:
        for srv in pair:
            srv.close()


def test_servers_share_the_compactor_and_the_last_closer_restores(tmp_path):
    tingest.configure(compact_interval=7.0)
    threshold = tingest.config().compact_threshold_bits
    a = TServer(str(tmp_path / "a"), device="cpu",
                ingest_compact_threshold_bits=99)
    b = TServer(str(tmp_path / "b"), device="cpu",
                ingest_compact_interval=0.5)
    refs = tcompactor.refs()
    try:
        assert tcompactor.compactor().totals()["running"]
        assert (tingest.config().compact_threshold_bits,
                tingest.config().compact_interval) == (99, 0.5)
        a.open()
        a.close()
        a.close()
        assert tcompactor.refs() == refs - 1
        assert tcompactor.compactor().totals()["running"]
        assert tingest.config().compact_interval == 0.5  # b still open
        off = TServer(str(tmp_path / "c"), device="cpu",
                      ingest_delta_enabled=False)
        assert tcompactor.refs() == refs - 1 and not tingest.delta_enabled()
        off.close()
        assert tingest.config().compact_interval == 0.5
    finally:
        b.close()
    assert tingest.config().compact_interval == 7.0
    assert tingest.config().compact_threshold_bits == threshold
    assert tingest.delta_enabled()


def test_a_warm_matrix_read_sees_a_pending_delta(tmp_path):
    """TopN, GroupBy and Rows(column=) over a shard whose row matrix is
    warm on the device merge a delta written after it: the answer is the
    effective content (the reference answers this single-shard TopN
    from the stale matrix while its result cache is off)."""
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.parallel.executor import Executor

    h = Holder(str(tmp_path / "t"), device="cpu")
    try:
        f = h.create_index("i").create_field("f")
        f.import_bits([1, 1, 2], [1, 2, 3])
        f.flush_deltas()
        ex = Executor(h, device="cpu")

        def topn():
            return [(p.id, p.count) for p in
                    ex.execute("i", "TopN(f, n=5)")[0]]

        assert topn() == [(1, 2), (2, 1)]
        f.import_bits([2, 2, 2], [4, 5, 6])
        assert f.fragment(0).delta_stats() is not None
        assert topn() == [(2, 4), (1, 2)]
        assert f.fragment(0).delta_stats() is None  # merged first
        f.import_bits([3], [5])
        groups = ex.execute("i", "GroupBy(Rows(f))")[0]
        assert [(g.group[0].row_id, g.count) for g in groups] == [
            (1, 2), (2, 4), (3, 1)]
        f.import_bits([4], [6])
        assert ex.execute("i", "Rows(f, column=6)")[0] == [2, 4]
    finally:
        h.close()


def test_a_nodelta_not_over_a_bool_row_sees_a_pending_existence_delta(
        tmp_path):
    """ROADMAP Queue 3 item 8: under ``?nodelta=1`` a tree with a bool
    literal reads shard by shard, and its ``Not`` reads the ``_exists``
    row after a write left a delta pending there.  The port merges before
    it reads and answers the effective count, held against a numpy
    oracle (the reference answers from its stale matrix here)."""
    ts = TServer(str(tmp_path / "t"), device="cpu", coalescer_enabled=True,
                 ingest_compact_interval=INTERVAL)
    try:
        ts.open()
        for path, body in (("/index/i", b"{}"),
                           ("/index/i/field/f", b"{}"),
                           ("/index/i/field/b",
                            b'{"options": {"type": "bool"}}')):
            assert _req(ts.uri, path, body)[0] == 200
        exists = np.zeros(16, dtype=bool)
        truth = np.zeros(16, dtype=bool)
        assert _req(ts.uri, "/index/i/field/f/import", json.dumps(
            {"rowIDs": [1, 1, 1], "columnIDs": [1, 2, 3]}).encode())[0] == 200
        exists[[1, 2, 3]] = True

        def count(flags: str = "?nodelta=1") -> int:
            status, body = _req(ts.uri, "/index/i/query" + flags,
                                b"Count(Not(Row(b=true)))", "text/plain")
            assert status == 200, body
            return json.loads(body)["results"][0]

        def pql(q: str) -> None:
            assert _req(ts.uri, "/index/i/query", q.encode(),
                        "text/plain")[0] == 200

        pql("Set(1, b=true)")
        exists[1] = truth[1] = True
        want = int((exists & ~truth).sum())
        assert count() == want == 2
        pql("Set(10, f=1)")
        exists[10] = True
        ef = ts.holder.index("i").field("_exists")
        assert ef.fragment(0).delta_stats() is not None
        want = int((exists & ~truth).sum())
        assert want == 3
        assert count() == want
        assert count() == want
        assert count("") == want
    finally:
        ts.close()


def test_writers_readers_and_the_compactor_race_without_a_lost_bit(
        tmp_path):
    """Four writers set disjoint bits of one row across three shards while
    three readers count it (the dense dfuse path, overlay stacks read
    before the base stack) and a compactor merges every delta as fast as
    it can, with the interpreter switching threads every 10 µs: no read
    ever sees fewer bits than an earlier read of the same reader, and the
    last count is every bit written."""
    import sys

    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.parallel.executor import Executor

    h = Holder(str(tmp_path / "t"), device="cpu")
    f = h.create_index("i").create_field("f")
    ex = Executor(h, device="cpu")
    comp = tcompactor.Compactor()
    global_was = tcompactor._global
    tcompactor._global = comp
    cols = np.random.default_rng(5).permutation(3 * W)[:1200].reshape(4, -1)
    stop = threading.Event()
    seen: list = [[] for _ in range(3)]
    errs: list = []

    def writer(k):
        try:
            for c in cols[k].tolist():
                f.set_bit(1, c)
        except BaseException as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    def reader(k):
        try:
            while not stop.is_set():
                seen[k].append(ex.execute("i", "Count(Row(f=1))")[0])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def compacting():
        while not stop.is_set():
            comp.run_once(force=True)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        f.set_bit(1, int(cols[0, 0]))  # every shard's fragment exists
        for s in (1, 2):
            f.set_bit(2, s * W)
        ws = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
        rs = [threading.Thread(target=reader, args=(k,)) for k in range(3)]
        cs = threading.Thread(target=compacting)
        for t in rs + ws + [cs]:
            t.start()
        for t in ws:
            t.join(timeout=120)
        stop.set()
        for t in rs + [cs]:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ws + rs + [cs])
        assert ex.execute("i", "Count(Row(f=1))")[0] == cols.size
    finally:
        sys.setswitchinterval(was)
        tcompactor._global = global_was
        h.close()
    assert not errs, errs
    for counts in seen:
        assert counts and all(a <= b for a, b in zip(counts, counts[1:]))
        assert counts[-1] <= cols.size
    assert comp.compactions > 0
    h2 = Holder(str(tmp_path / "t"), device="cpu")  # the WAL holds them all
    try:
        assert Executor(h2, device="cpu").execute(
            "i", "Count(Row(f=1))")[0] == cols.size
    finally:
        h2.close()
