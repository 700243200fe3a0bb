"""Array and run containers ([containers] kinds) in the port against the
JAX package's, on the CPU.

The same seeded rows go into both packages: per shard (one container
under pytest's 2^16 shard width) a row is an array (scattered bits), a
run (long intervals) or a bitmap (every other bit over a window), with
rows that mix the kinds across shards, the array/bitmap flip at 4096
bits, the run-cap demotion at 257 runs, and bits 65535/65536 at the
shard boundary.  Then, with kinds on in both:

- each fragment picks the same kind for every container;
- every op (Intersect/Union/Xor/Difference/Not) over all-array, all-run,
  all-bitmap and cross-kind leaves, as a Count and as a Row root, over
  all shards and on shard subsets, answers what the reference answers,
  what the port answers with kinds off, and what tests/naive.py says,
  through the same routes (equal per-kind gather counters);
- concurrent coalesced Counts that mix kinds run as one VM batch over a
  kind-split megapool (K3-kinds' plain version on the CPU);
- the HTTP answers are byte-identical JSON;
- a kind byte above 3 declines the VM as ``kind_unsupported``;
- flipping ``kinds`` rebuilds the cached leaf.

The JAX side runs what the port implements: mesh off, ingest deltas
off, the result cache on (both packages' default).  Every fixture snapshots the process-wide fields
it touches and restores exactly those.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu import ingest as jingest
from pilosa_tpu import stats as jstats
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.ops import tape as jtape
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.parallel.coalescer import Coalescer as JCoalescer
from pilosa_tpu.parallel.executor import ExecOptions as JOpts
from pilosa_tpu.parallel.executor import Executor as JExecutor
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import tape as ttape
from pilosa_tpu_torch.parallel import coalescer as tco
from pilosa_tpu_torch.parallel.executor import ExecOptions as TOpts
from pilosa_tpu_torch.parallel.executor import Executor as TExecutor
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from tests.naive import NaiveBitmap

W = SHARD_WIDTH
N_SHARDS = 4
JOPT = JOpts(mesh=False)


def _array(rng, card: int = 150, lo: int = 0, hi: int = 6000):
    return np.sort(rng.choice(np.arange(lo, hi), size=card, replace=False))


def _run(a: int, b: int):
    return np.concatenate([np.arange(a, b), np.arange(b + 500, b + 700)])


def _bitmap(start: int = 0):
    return np.arange(start, 12000, 2)


def _runs(n: int, length: int = 5, gap: int = 200):
    return np.concatenate([np.arange(r * gap, r * gap + length)
                           for r in range(n)])


def rows_by_shard(seed: int) -> dict:
    """{(field, row): {shard: sorted offsets}}: the kind-styled rows."""
    rng = np.random.default_rng(seed)
    arr = {s: _array(rng) for s in range(N_SHARDS)}
    rows = {
        ("k", 1): arr,                                     # array
        ("k", 2): {s: np.union1d(arr[s][::2], _array(rng))  # array,
                   for s in range(N_SHARDS)},               # overlapping
        ("k", 3): {s: _run(1000 + 50 * s, 4000) for s in range(N_SHARDS)},
        ("k", 4): {s: _run(3000, 6000 + 100 * s) for s in range(N_SHARDS)},
        ("k", 5): {s: _bitmap(s % 2) for s in range(N_SHARDS)},
        # a different kind in every shard, absent from the last
        ("k", 6): {0: _array(rng), 1: _run(2000, 3000), 2: _bitmap()},
        # boundary bits: 65535 of shard 0 and 0 of shard 1 (= 65536)
        ("k", 7): {0: np.array([0, 31, 32, W - 1]), 1: np.array([0, 1]),
                   3: np.array([W - 1])},
        # the array/bitmap flip and the run-cap demotion
        ("k", 8): {0: np.sort(rng.choice(W, 4096, replace=False)),
                   1: np.sort(rng.choice(W, 4097, replace=False)),
                   2: _runs(256), 3: _runs(257)},
        ("g", 1): {s: _array(rng, 300, 0, 20000) for s in range(N_SHARDS)},
        ("g", 2): {s: _run(0, 9000) for s in range(N_SHARDS)},
    }
    return rows


def columns(rows: dict, key) -> np.ndarray:
    by_shard = rows[key]
    return np.concatenate([s * W + np.asarray(by_shard[s], dtype=np.int64)
                           for s in sorted(by_shard)])


#: (PQL tree, the kinds its leaves read)
TREES = [
    "Intersect(Row(k=1), Row(k=2))",              # array & array
    "Intersect(Row(k=1), Row(k=5))",              # array & bitmap
    "Intersect(Row(k=5), Row(k=1))",              # bitmap & array
    "Intersect(Row(k=3), Row(k=4))",              # run & run
    "Intersect(Row(k=1), Row(k=3))",              # array & run
    "Intersect(Row(k=3), Row(k=5))",              # run & bitmap
    "Union(Row(k=1), Row(k=3), Row(k=5))",
    "Xor(Row(k=2), Row(k=4))",
    "Xor(Row(k=3), Row(k=4))",
    "Difference(Row(k=5), Row(k=3))",
    "Difference(Row(k=1), Row(k=2))",
    "Not(Row(k=3))",
    "Intersect(Union(Row(k=1), Row(k=3)), Difference(Row(k=5), Row(k=4)))",
    "Union(Row(k=6), Row(k=7))",
    "Intersect(Row(k=6), Row(g=2))",
    "Xor(Row(k=8), Row(g=1))",
    "Union(Row(k=7), Row(k=8))",
    "Intersect(Row(k=8), Row(g=2))",
    "Difference(Row(g=2), Row(k=1), Row(k=6))",
]
SHARD_SETS = [None, [1], [0, 2], [3]]


def naive_tree(tree: str, rows: dict, shard: int, exist: NaiveBitmap):
    """tests/naive.py's answer for one shard of a parsed tree."""
    def ev(call):
        if call.name == "Row":
            fname = call.field_arg()
            return NaiveBitmap(rows.get((fname, call.args[fname]), {})
                               .get(shard, ()), nbits=W)
        kids = [ev(c) for c in call.children]
        if call.name == "Not":
            return exist.difference(kids[0])
        out = kids[0]
        for k in kids[1:]:
            out = {"Intersect": out.intersect, "Union": out.union,
                   "Xor": out.xor, "Difference": out.difference
                   }[call.name](k)
        return out
    return ev(tparse(tree).calls[0])


@pytest.fixture(autouse=True)
def _kinds_configuration():
    """Kinds on in both packages; mesh, ingest deltas and the result
    cache off on the JAX side, and ingest deltas off in the port too (the
    base routes these tests pin).  Restores exactly the fields it
    sets."""
    mesh_was = (meshexec._cfg.enabled, meshexec._cfg.axis_size)
    jct_was = {k: getattr(jct.config(), k)
               for k in type(jct.config()).__slots__}
    tct_was = {k: getattr(tct.config(), k)
               for k in type(tct.config()).__slots__}
    delta_was = jingest.config().delta_enabled
    tdelta_was = tingest.config().delta_enabled
    meshexec.configure(enabled=False)
    jct.configure(enabled=True, threshold=jct.DEFAULT_THRESHOLD, kinds=True,
                  array_max=jct.DEFAULT_ARRAY_MAX, run_cap=jct.DEFAULT_RUN_CAP)
    tct.configure(enabled=True, threshold=tct.DEFAULT_THRESHOLD, kinds=True,
                  array_max=tct.DEFAULT_ARRAY_MAX, run_cap=tct.DEFAULT_RUN_CAP)
    jingest.config().delta_enabled = False
    tingest.configure(delta_enabled=False)
    try:
        yield
    finally:
        tingest.configure(delta_enabled=tdelta_was)
        jingest.config().delta_enabled = delta_was
        jct.configure(**jct_was)
        tct.configure(**tct_was)
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])


@pytest.fixture(scope="module")
def data():
    rows = rows_by_shard(2024)
    every = np.unique(np.concatenate([columns(rows, k) for k in rows]))
    exist = [NaiveBitmap(every[every // W == s] % W, nbits=W)
             for s in range(N_SHARDS)]
    return rows, exist


def _load(idx, rows: dict) -> None:
    for fname in ("k", "g"):
        idx.create_field(fname)
    for (fname, row), _by in rows.items():
        cols = columns(rows, (fname, row))
        idx.field(fname).import_bits(np.full(len(cols), row), cols)
        idx.import_existence(cols)


@pytest.fixture
def pair(tmp_path, data):
    """(JAX executor, port executor) over the same rows."""
    rows, _exist = data
    jh = JHolder(str(tmp_path / "j"))
    th = THolder(str(tmp_path / "t"), device="cpu")
    for h in (jh, th):
        _load(h.create_index("i"), rows)
    yield JExecutor(jh), TExecutor(th, device="cpu")
    jh.close()
    th.close()


def _answer(res) -> object:
    """A Count as int, a Row as its sorted column list."""
    if isinstance(res, (int, np.integer)):
        return int(res)
    return [int(c) for c in res.columns()]


def test_each_container_takes_the_reference_kind(pair, data):
    jex, tex = pair
    rows, _exist = data
    seen = set()
    for (fname, row), by_shard in rows.items():
        for s in by_shard:
            jq = jex.holder.index("i").field(fname).view("standard") \
                .fragment(s).row_container_kinds(row)
            tq = tex.holder.index("i").field(fname).view("standard") \
                .fragment(s).row_container_kinds(row)
            assert np.array_equal(jq[0], tq[0]) and jq[2] == tq[2]
            assert np.array_equal(jq[3], tq[3]), (fname, row, s)
            seen.update(int(k) for k in tq[3])
    assert seen == {1, 2, 3}
    kinds8 = [int(tex.holder.index("i").field("k").view("standard")
                  .fragment(s).row_container_kinds(8)[3][0])
              for s in range(N_SHARDS)]
    assert kinds8 == [2, 1, 3, 2]  # 4096 | 4097 bits, 256 | 257 runs


@pytest.mark.parametrize("root", ["Count", "Row"])
@pytest.mark.parametrize("tree", TREES)
def test_every_op_matches_the_reference_naive_and_kinds_off(pair, data,
                                                            tree, root):
    jex, tex = pair
    rows, exist = data
    q = f"Count({tree})" if root == "Count" else tree
    for shards in SHARD_SETS:
        j0, t0 = jct.counters(), tct.counters()
        want = _answer(jex.execute("i", q, opt=JOpts(mesh=False,
                                                     shards=shards))[0])
        got = _answer(tex.execute("i", q, opt=TOpts(shards=shards,
                                                    coalesce=False))[0])
        assert got == want, (q, shards)
        j1, t1 = jct.counters(), tct.counters()
        # the same route: equal per-kind gathers and fallbacks
        for name in t1:
            assert t1[name] - t0[name] == j1[name] - j0[name], (q, name)
        tct.configure(kinds=False)
        try:
            off = _answer(tex.execute("i", q, opt=TOpts(
                shards=shards, coalesce=False))[0])
        finally:
            tct.configure(kinds=True)
        assert off == got
        nv = [naive_tree(tree, rows, s, exist[s])
              for s in (shards or range(N_SHARDS))]
        if root == "Count":
            assert got == sum(b.count() for b in nv)
        else:
            assert got == sorted(int(c) + s * W for s, b in
                                 zip(shards or range(N_SHARDS), nv)
                                 for c in b.positions())


def test_kind_routes_engage_and_tick_one_dispatch(pair):
    jex, tex = pair
    t0 = tct.counters()
    for tree in TREES[:6]:
        q = f"Count({tree})"
        with tbm.dispatch_counter() as tdc:
            tex.execute("i", q, opt=TOpts(coalesce=False))
        with jbm.dispatch_counter() as jdc:
            jex.execute("i", q, opt=JOPT)
        assert tdc.launches == jdc.launches == ["fused_gather"], tree
    t1 = tct.counters()
    for kind in ("array", "run", "bitmap"):
        assert t1[f"container.{kind}_gathered"] > \
            t0[f"container.{kind}_gathered"], kind
    assert t1["container.fallbacks"] == t0["container.fallbacks"]


def _fire(ex, queries, opt):
    bar = threading.Barrier(len(queries))
    out = [None] * len(queries)
    launches: list = [[] for _ in queries]
    errs: list = []
    dc_cls = (tbm.dispatch_counter if isinstance(opt, TOpts)
              else jbm.dispatch_counter)

    def run(i):
        try:
            bar.wait()
            with dc_cls() as dc:
                out[i] = int(ex.execute("i", queries[i], opt=opt)[0])
            launches[i] = dc.launches
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,))
          for i in range(len(queries))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)
    return out, [k for ks in launches for k in ks]


def test_coalesced_counts_mixing_kinds_share_one_vm_launch(pair,
                                                           monkeypatch):
    jex, tex = pair
    qs = [f"Count({t})" for t in TREES[:11]] + [
        "Count(Intersect(Row(k=5), Row(g=1)))"]
    truth = [_answer(tex.execute("i", q, opt=TOpts(coalesce=False))[0])
             for q in qs]
    kw = {"window_s": 2.0, "max_batch": len(qs)}
    jex.coalescer = JCoalescer(enabled=True, stats=jstats.MemStatsClient(),
                               **kw)
    tex.coalescer = tco.Coalescer(enabled=True, **kw)
    jtape.reset_counters()
    ttape.reset_counters()
    calls: list = []
    real = ck.vm_counts_kinds

    def spy(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(ck, "vm_counts_kinds", spy)
    # the truths above filled the port's result cache: the round skips
    # it on both sides, so every query takes the window
    jgot, jl = _fire(jex, qs, JOpts(mesh=False, cache=False))
    tgot, tl = _fire(tex, qs, TOpts(cache=False))
    assert tgot == jgot == truth
    assert tl == jl == ["vm"]
    assert len(calls) == 1  # the kind-split megapool took K3-kinds
    c, jc = ttape.counters(), jtape.counters()
    assert (c["vm.executions"], c["vm.queries"], c["vm.fallbacks"]) == \
        (1, len(qs), 0)
    assert {k: v for k, v in c.items() if k.startswith(("vm.", "tape."))} \
        == {k: v for k, v in jc.items() if k.startswith(("vm.", "tape."))}


def test_an_all_bitmap_batch_keeps_the_plain_vm(pair, monkeypatch):
    _jex, tex = pair
    tex.coalescer = tco.Coalescer(enabled=True, window_s=2.0, max_batch=2)
    calls: list = []
    real = ck.vm_counts

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(ck, "vm_counts", spy)
    qs = ["Count(Intersect(Row(k=5), Row(k=5)))",
          "Count(Union(Row(k=5), Row(k=5)))"]
    got, launches = _fire(tex, qs, TOpts())
    assert launches == ["vm"] and calls == [1]
    assert got == [_answer(tex.execute("i", q, opt=TOpts(coalesce=False))[0])
                   for q in qs]


def test_a_kind_byte_above_three_declines_the_vm(pair):
    jex, tex = pair
    shards = tuple(range(N_SHARDS))
    jcall = jparse("Count(Intersect(Row(k=6), Row(k=1)))").calls[0]
    tcall = tparse("Count(Intersect(Row(k=6), Row(k=1)))").calls[0]
    for ex, ct_mod, tp_mod, call in ((jex, jct, jtape, jcall),
                                     (tex, tct, ttape, tcall)):
        idx = ex.holder.index("i")
        leaf = idx.field("k").device_container_leaf(6, shards)
        assert leaf.has_kinds
        before = tp_mod.counters()["vm.fallbacks.kind_unsupported"]
        assert ct_mod.stage_vm(idx, call.children[0], shards) is not None
        next(k for k in leaf.kinds if k is not None and len(k))[0] = 7
        assert ct_mod.stage_vm(idx, call.children[0], shards) is None
        assert tp_mod.counters()["vm.fallbacks.kind_unsupported"] == \
            before + 1


def test_flipping_kinds_rebuilds_the_cached_leaf(pair):
    _jex, tex = pair
    f = tex.holder.index("i").field("k")
    shards = tuple(range(N_SHARDS))
    on = f.device_container_leaf(1, shards)
    assert on.has_kinds and on is f.device_container_leaf(1, shards)
    q = "Count(Intersect(Row(k=1), Row(k=3)))"
    want = _answer(tex.execute("i", q, opt=TOpts(coalesce=False))[0])
    tct.configure(kinds=False)
    try:
        off = f.device_container_leaf(1, shards)
        assert not off.has_kinds and off.kinds is None
        assert _answer(tex.execute("i", q, opt=TOpts(coalesce=False))[0]) \
            == want
        tct.configure(run_cap=1)
    finally:
        tct.configure(kinds=True)
    # row 3 holds two runs per container: run_cap 1 demotes them to arrays
    again = f.device_container_leaf(3, shards)
    assert again.has_kinds and (again.rn, again.an) == (0, N_SHARDS)
    tct.configure(run_cap=tct.DEFAULT_RUN_CAP)
    back = f.device_container_leaf(3, shards)
    assert back is not again and int(back.rn) == N_SHARDS
    assert _answer(tex.execute("i", q, opt=TOpts(coalesce=False))[0]) == want


def test_kind_pools_keep_compact_bytes(pair):
    _jex, tex = pair
    f = tex.holder.index("i").field("k")
    shards = tuple(range(N_SHARDS))
    leaf = f.device_container_leaf(1, shards)
    assert leaf.apool.dtype == torch.int16 and leaf.rpool.dtype == torch.int16
    assert leaf.n == 0 and leaf.an == N_SHARDS and leaf.rn == 0
    tct.configure(kinds=False)
    try:
        dense = f.device_container_leaf(1, shards)
    finally:
        tct.configure(kinds=True)
    assert leaf.nbytes * 4 < dense.nbytes


# ------------------------------------------------------------------ HTTP


def post(uri: str, path: str, body: bytes,
         ctype: str = "application/json") -> tuple[int, bytes]:
    req = urllib.request.Request(uri + path, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_answers_are_byte_identical_json(tmp_path, data):
    rows, _exist = data
    js = JServer(str(tmp_path / "j"), mesh_enabled=False,
                 coalescer_enabled=False, containers_kinds=True,
                 ingest_delta_enabled=False)
    js.open()
    try:
        ts = TServer(str(tmp_path / "t"), device="cpu")
        ts.open()
        try:
            for s in (js, ts):
                assert post(s.uri, "/index/i", b"{}")[0] == 200
                for fname in ("k", "g"):
                    assert post(s.uri, f"/index/i/field/{fname}",
                                b"{}")[0] == 200
                for (fname, row) in rows:
                    cols = columns(rows, (fname, row)).tolist()
                    body = json.dumps({"rowIDs": [row] * len(cols),
                                       "columnIDs": cols}).encode()
                    assert post(s.uri, f"/index/i/field/{fname}/import",
                                body)[0] == 200
            for tree in TREES:
                for path in ("/index/i/query", "/index/i/query?shards=1,3",
                             "/index/i/query?nocontainers=1"):
                    body = f"Count({tree}) {tree}".encode()
                    want = post(js.uri, path, body, "text/plain")
                    got = post(ts.uri, path, body, "text/plain")
                    assert want[0] == 200 and got == want, (tree, path)
        finally:
            ts.close()
    finally:
        js.close()
