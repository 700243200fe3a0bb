"""TopN of the port against the JAX package's, on the CPU.

A JAX-package server and a port server (``device="cpu"``) are fed the
same seeded ``/import`` bits over four shards -- rows of many fills, two
rows with equal counts (the id breaks the tie), a row on one shard
only -- and must answer every TopN with byte-identical JSON: ``n``,
``ids``, ``threshold``, ``tanimotoThreshold``, filters fused over all
shards and evaluated on one (``?shards=``).  The counts also agree with
a Python-set oracle built from tests/naive.py.  Below the servers: the
rank cache's ``.cache`` files are byte-identical and each package opens
the other's, and the field's matrix stack (the fused scan's operand)
holds the reference's rows in the reference's order.

The JAX side runs the configuration the port implements: mesh off,
the result cache on (both defaults), container kinds off, ingest deltas off, coalescer
off.
"""

from __future__ import annotations

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu.models.cache import TopNCache as JCache
from pilosa_tpu.models.fragment import Fragment as JFragment
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.models.cache import TopNCache as TCache
from pilosa_tpu_torch.models.fragment import Fragment as TFragment
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from tests.naive import NaiveBitmap

N_SHARDS = 4
NBITS = N_SHARDS * SHARD_WIDTH


def post(uri: str, path: str, body: bytes,
         ctype: str = "application/json") -> tuple[int, bytes]:
    req = urllib.request.Request(uri + path, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def dataset(seed: int) -> dict:
    """field -> row -> set of columns: s rows 0-11 at fills from 0.1 %
    to 5 % (rows 3 and 7 the same set, row 11 on shard 0 only), u rows
    0-5, and the filter rows 1-3 of f (row 3 holds s row 10, so its
    Tanimoto coefficient with row 10 is high)."""
    rng = np.random.default_rng(seed)

    def cols(n, lo=0, hi=NBITS):
        return set(rng.choice(np.arange(lo, hi), size=n,
                              replace=False).tolist())

    s = {r: cols(int(NBITS * (0.001 + 0.004 * r))) for r in range(11)}
    s[7] = set(s[3])
    s[11] = cols(900, 0, SHARD_WIDTH)
    u = {r: cols(int(NBITS * (0.02 + 0.01 * r))) for r in range(6)}
    f = {1: cols(NBITS // 12), 2: cols(NBITS // 5),
         3: s[10] | cols(NBITS // 100)}
    return {"s": s, "u": u, "f": f}


def import_dataset(uri: str, data: dict) -> None:
    assert post(uri, "/index/i", b'{"options": {}}')[0] == 200
    for field, rows in data.items():
        assert post(uri, f"/index/i/field/{field}", b"{}")[0] == 200
        row_ids, col_ids = [], []
        for r, cs in rows.items():
            row_ids += [r] * len(cs)
            col_ids += sorted(cs)
        body = json.dumps({"rowIDs": row_ids, "columnIDs": col_ids}).encode()
        assert post(uri, f"/index/i/field/{field}/import", body)[0] == 200


def jax_server(path: str) -> JServer:
    """The JAX server in the configuration the port implements."""
    return JServer(path, mesh_enabled=False, coalescer_enabled=False,
                   containers_kinds=False, ingest_delta_enabled=False)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    data = dataset(77)
    js = jax_server(str(tmp_path_factory.mktemp("jax")))
    js.open()
    ts = TServer(str(tmp_path_factory.mktemp("torch")), device="cpu")
    ts.open()
    try:
        for s in (js, ts):
            import_dataset(s.uri, data)
        yield js, ts, data
    finally:
        js.close()
        ts.close()


QUERIES = [
    "TopN(s)",
    "TopN(s, n=5)",
    "TopN(s, n=4, ids=[1, 3, 5, 7, 9, 11])",
    "TopN(s, threshold=1500)",
    "TopN(s, n=3, threshold=1500)",
    "TopN(s, Row(f=1), n=4)",
    "TopN(s, Row(f=1))",
    "TopN(s, Intersect(Row(f=1), Row(f=2)), n=6)",
    "TopN(s, Not(Row(f=2)), n=3)",
    "TopN(s, Row(f=1), tanimotoThreshold=10)",
    "TopN(s, Row(f=2), tanimotoThreshold=3)",
    "TopN(s, Row(f=3), tanimotoThreshold=50, n=2)",
    "TopN(s, Row(f=1), threshold=100)",
    "TopN(s, Row(f=9), n=3)",
    "TopN(u, n=2) TopN(s, Row(f=2), ids=[0, 7, 3])",
    "TopN(field=s, n=2)",
    "TopN(s, tanimotoThreshold=101)",
    "TopN(nope, n=2)",
    "TopN()",
]


@pytest.mark.parametrize("path", ["/index/i/query", "/index/i/query?shards=1",
                                  "/index/i/query?shards=0,3"])
def test_topn_answers_byte_identical_json(servers, path):
    js, ts, _data = servers
    for q in QUERIES:
        want = post(js.uri, path, q.encode(), "text/plain")
        got = post(ts.uri, path, q.encode(), "text/plain")
        assert got[0] == want[0], (path, q, got, want)
        if want[0] == 200:
            assert got[1] == want[1], (path, q)


def _oracle_counts(data, field: str, filt: NaiveBitmap | None,
                   shards=range(N_SHARDS)) -> dict[int, int]:
    span = NaiveBitmap(
        [c for s in shards for c in range(s * SHARD_WIDTH,
                                          (s + 1) * SHARD_WIDTH)], NBITS)
    out = {}
    for r, cs in data[field].items():
        nb = NaiveBitmap(cs, NBITS).intersect(span)
        if filt is not None:
            nb = nb.intersect(filt)
        if nb.count():
            out[r] = nb.count()
    return out


def _topn(ts, q: str, path: str = "/index/i/query") -> list[tuple[int, int]]:
    st, body = post(ts.uri, path, q.encode(), "text/plain")
    assert st == 200, body
    return [(p["id"], p["count"]) for p in json.loads(body)["results"][0]]


def test_topn_counts_agree_with_the_naive_oracle(servers):
    _js, ts, data = servers
    f1 = NaiveBitmap(data["f"][1], NBITS)
    f2 = NaiveBitmap(data["f"][2], NBITS)
    for q, filt in (("TopN(s)", None), ("TopN(s, Row(f=1))", f1),
                    ("TopN(s, Intersect(Row(f=1), Row(f=2)))",
                     f1.intersect(f2))):
        want = _oracle_counts(data, "s", filt)
        order = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))
        assert _topn(ts, q) == order, q
    # one shard: the per-shard route (no fused stack)
    want = _oracle_counts(data, "s", f1, shards=[1])
    order = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    assert _topn(ts, "TopN(s, Row(f=1), n=3)",
                 "/index/i/query?shards=1") == order
    # the tie: rows 3 and 7 hold the same columns, 3 ranks first
    ranked = [r for r, _c in _topn(ts, "TopN(s)")]
    assert ranked.index(3) + 1 == ranked.index(7)


def test_topn_launch_sites_on_a_cpu_server(servers):
    """The fused filtered TopN is one ``row_counts_gathered`` scan and
    the one-shard one a ``row_counts_masked`` scan -- the calls that
    launch K4 on a card -- and a CPU server launches no kernel.  The
    queries skip the result cache (``?nocache=1``), whose hit would
    launch nothing."""
    _js, ts, _data = servers
    before = ck.launch_counts()
    with tbm.dispatch_counter() as dc:
        ts.api.query("i", "TopN(s, Row(f=1), n=3)", cache=False)
    assert dc.launches.count("row_counts_gathered") == 1
    assert "row_counts_masked" not in dc.launches
    with tbm.dispatch_counter() as dc:
        ts.api.query("i", "TopN(s, Row(f=1), n=3)", shards=[2],
                     cache=False)
    assert dc.launches.count("row_counts_masked") == 1
    assert ck.launch_counts() == before


def test_unfiltered_topn_is_served_from_warm_rank_caches(servers):
    _js, ts, data = servers
    want = _topn(ts, "TopN(s, n=4)")
    with tbm.dispatch_counter() as dc:
        assert _topn(ts, "TopN(s, n=4)") == want
        ts.api.query("i", "TopN(s, n=4)")
    assert dc.launches == []
    # a write makes the shard's cache miss and the scan sees the bit
    col = next(c for c in range(SHARD_WIDTH) if c not in data["s"][0])
    st, _ = post(ts.uri, "/index/i/query", f"Set({col}, s=0)".encode(),
                 "text/plain")
    assert st == 200
    try:
        counts = dict(_topn(ts, "TopN(s)"))
        assert counts[0] == len(data["s"][0]) + 1
    finally:
        post(ts.uri, "/index/i/query", f"Clear({col}, s=0)".encode(),
             "text/plain")


# ------------------------------------------------------------ rank cache


def test_cache_files_are_byte_identical_and_load_across_packages(tmp_path):
    counts = {5: 10, 2: 33, 9: 33, 1: 7}
    for ctype, size in (("ranked", 50000), ("ranked", 2), ("lru", 3)):
        jc, tc = JCache(ctype, size), TCache(ctype, size)
        jc.put(4, counts)
        tc.put(4, counts)
        jp, tp = str(tmp_path / "j.cache"), str(tmp_path / "t.cache")
        jc.save(jp, 4)
        tc.save(tp, 4)
        with open(jp, "rb") as a, open(tp, "rb") as b:
            assert a.read() == b.read(), ctype
        j2, t2 = JCache(ctype, size), TCache(ctype, size)
        assert t2.load(jp, 9) and j2.load(tp, 9)
        assert t2.get(9) == j2.get(9) == jc.get(4)
        for n in (0, 1, 2, 3, 5):
            assert t2.exact_for(n) == j2.exact_for(n) == jc.exact_for(n)
    # a stale cache removes the file at save, in both
    tc = TCache()
    tc.put(1, counts)
    tc.save(tp, 2)
    assert not os.path.exists(tp)


def _frag_files(src_path: str, dst_dir) -> str:
    dst = str(dst_dir / "0")
    for ext in (".snap", ".wal", ".cache"):
        if os.path.exists(src_path + ext):
            shutil.copy(src_path + ext, dst + ext)
    return dst


@pytest.fixture
def _port_delta_off():
    """The port's ingest deltas off, as the bare JAX fragment runs (the
    reference module's default): both fragments take the base write path
    whose rank cache this test compares."""
    was = tingest.config().delta_enabled
    tingest.configure(delta_enabled=False)
    yield
    tingest.configure(delta_enabled=was)


def test_each_package_opens_the_others_rank_cache(tmp_path, _port_delta_off):
    rng = np.random.default_rng(3)
    pos = np.unique(rng.integers(0, 6 * SHARD_WIDTH, size=4000)).astype(
        np.uint64)
    jf = JFragment(str(tmp_path / "j" / "0"), "i", "s", "standard", 0)
    tf = TFragment(str(tmp_path / "t" / "0"), "i", "s", "standard", 0,
                   device=torch.device("cpu"))
    counts = {}
    for r in range(6):
        n = int(((pos >= r * SHARD_WIDTH)
                 & (pos < (r + 1) * SHARD_WIDTH)).sum())
        if n:
            counts[r] = n
    for fr in (jf, tf):
        fr.import_positions(pos)
        fr.cache_row_counts(counts)
        fr.snapshot()
    jf.close()
    tf.close()
    with open(jf.path + ".cache", "rb") as a, open(tf.path + ".cache",
                                                   "rb") as b:
        assert a.read() == b.read()
    (tmp_path / "jt").mkdir()
    (tmp_path / "tj").mkdir()
    t_on_j = TFragment(_frag_files(jf.path, tmp_path / "jt"), "i", "s",
                       "standard", 0, device=torch.device("cpu"))
    j_on_t = JFragment(_frag_files(tf.path, tmp_path / "tj"), "i", "s",
                       "standard", 0)
    try:
        assert t_on_j.cached_row_counts(0) == counts
        assert j_on_t.cached_row_counts(0) == counts
        # a write invalidates; a fill stamped with the older generation
        # never hits
        gen, _ids, _mat = t_on_j.device_matrix_with_gen()
        t_on_j.set_bit(0, 3 if not (pos == 3).any() else 4)
        t_on_j.cache_row_counts(counts, gen=gen)
        assert t_on_j.cached_row_counts(0) is None
    finally:
        t_on_j.close()
        j_on_t.close()


# ----------------------------------------------------------- matrix stack


def test_matrix_stack_matches_the_reference(servers):
    js, ts, _data = servers
    shards = (0, 1, 2, 3)
    jf = js.holder.index("i").field("s")
    tf = ts.holder.index("i").field("s")
    jg, jids, jpos, _jpd, jmat = jf.device_matrix_stack(shards)
    tg, tids, tpos, tpd, tmat = tf.device_matrix_stack(shards)
    n = len(jids)
    assert np.array_equal(tids, jids)
    assert np.array_equal(tpos, np.asarray(jpos)[:n])
    assert np.array_equal(tpd.numpy(), tpos)
    assert np.array_equal(tbm.to_numpy(tmat), np.asarray(jmat)[:n])
    assert len(tg) == len(shards)
    # cached per shard tuple
    assert tf.device_matrix_stack(shards)[4] is tmat


def _drop_matrix_stacks(f) -> None:
    """Empty the field's matrix-stack cache, host-tier twins included
    (a bare ``clear()`` of the dict would leave them to promote back)."""
    from pilosa_tpu_torch.runtime import residency

    for k in list(f._matrix_stack_cache):
        residency.manager().forget(f._matrix_stack_cache, k)
    f._matrix_stack_cache.clear()


def test_matrix_stack_cache_cap_refuses_only_larger_stacks(servers,
                                                           monkeypatch):
    _js, ts, _data = servers
    f = ts.holder.index("i").field("u")
    shards = (0, 1, 2)
    nbytes = f.device_matrix_stack(shards)[4].numel() * 4
    _drop_matrix_stacks(f)
    monkeypatch.setattr(type(f), "MATRIX_STACK_CACHE_BYTES", nbytes)
    first = f.device_matrix_stack(shards)[4]
    assert f.device_matrix_stack(shards)[4] is first
    _drop_matrix_stacks(f)
    monkeypatch.setattr(type(f), "MATRIX_STACK_CACHE_BYTES", nbytes - 1)
    first = f.device_matrix_stack(shards)[4]
    assert f.device_matrix_stack(shards)[4] is not first
    assert not f._matrix_stack_cache
    # no rows at all: nothing to scan, nothing cached
    g, ids, pos, pd, mat = f.device_matrix_stack((17,))
    assert g == (0,) and len(ids) == 0 and mat is None
