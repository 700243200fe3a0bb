"""Int fields (BSI) of the port against the JAX package's, on the CPU.

A JAX-package server and a port server (``device="cpu"``) get the same
seeded values over four shards, through ``POST .../import-value`` and
``Set(col, v=...)``, in two int fields: ``v`` spans zero (base 0) and
``w`` has ``min > 0`` (base 100).  They must answer every query shape
that chip_smoke.py drives on the card with byte-identical JSON --
``Row(v op x)`` for every operator at the predicate edges (``min``,
``max``, beyond either, -1, 0, 1, held values), between in all sign
cases, ``!= null``, range rows in set-algebra trees, ``Count``s and
filters, ``Sum``/``Min``/``Max`` with and without a filter, and the
errors -- fused over all shards and with ``?shards=``, again after
``Clear``s, and the answers agree with an
oracle built on tests/naive.py.  Below the servers: the BSI fragment
files (WAL and snapshot) are byte-identical between the packages, and
each package opens the other's data directory with the same values.

The JAX side runs the configuration the port implements: mesh off,
the result cache on (both defaults), container kinds off, ingest deltas off, coalescer
off.  The JAX server sets the mesh and container configurations process
wide and restores them when it closes; the fixture restores them once
more from its own snapshot, so the file leaves them as it found them
even when another server of the process still holds them.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.models.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from tests.naive import NaiveBitmap

N_SHARDS = 4
NBITS = N_SHARDS * SHARD_WIDTH
#: field -> (min, max): v spans zero, w lies above it (base = min = 100)
FIELDS = {"v": (-1000, 1000), "w": (100, 5000)}
PATHS = ("/index/i/query", "/index/i/query?shards=1")
OPS = ("==", "!=", "<", "<=", ">", ">=")


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
    """Imported values, Set writes and the filter rows of field f."""
    rng = np.random.default_rng(seed)
    data: dict = {"imports": {}, "sets": [], "f": {}}
    for fname, (lo, hi) in FIELDS.items():
        cols = rng.choice(NBITS, size=1200, replace=False)
        vals = rng.integers(lo, hi + 1, size=len(cols))
        edges = [lo, hi, lo + 1, hi - 1, max(lo, 0), max(lo, -1), max(lo, 1)]
        vals[:len(edges)] = edges
        data["imports"][fname] = (cols.tolist(), vals.tolist())
        # Set: overwrite imported columns and write new ones
        taken = set(cols.tolist())
        fresh = [int(c) for c in rng.choice(NBITS, size=40, replace=False)
                 if int(c) not in taken][:6]
        for col, val in zip(cols[-6:].tolist() + fresh,
                            [lo, hi, max(lo, 0), max(lo, 7)] * 3):
            data["sets"].append((fname, int(col), int(val)))
    data["f"] = {r: sorted(rng.choice(NBITS, size=NBITS // 6,
                                      replace=False).tolist())
                 for r in (1, 2)}
    return data


def load(uri: str, data: dict) -> None:
    assert post(uri, "/index/i", b'{"options": {"trackExistence": true}}'
                )[0] == 200
    for fname, (lo, hi) in FIELDS.items():
        opts = {"options": {"type": "int", "min": lo, "max": hi}}
        assert post(uri, f"/index/i/field/{fname}",
                    json.dumps(opts).encode())[0] == 200
        cols, vals = data["imports"][fname]
        body = json.dumps({"columnIDs": cols, "values": vals}).encode()
        assert post(uri, f"/index/i/field/{fname}/import-value", body
                    )[0] == 200
    assert post(uri, "/index/i/field/f", b"{}")[0] == 200
    rows, cols = [], []
    for r, cs in data["f"].items():
        rows += [r] * len(cs)
        cols += cs
    body = json.dumps({"rowIDs": rows, "columnIDs": cols}).encode()
    assert post(uri, "/index/i/field/f/import", body)[0] == 200
    for fname, col, val in data["sets"]:
        st, body = post(uri, "/index/i/query",
                        f"Set({col}, {fname}={val})".encode(), "text/plain")
        assert st == 200, body


def oracle_values(data: dict, cleared=()) -> dict:
    """field -> {column: value} after the writes (and the clears)."""
    out = {}
    for fname in FIELDS:
        cols, vals = data["imports"][fname]
        out[fname] = dict(zip(cols, vals))
    for fname, col, val in data["sets"]:
        out[fname][col] = val
    for fname, col in cleared:
        out[fname].pop(col, None)
    return out


def jax_server(path: str) -> JServer:
    """The JAX server in the configuration the port implements."""
    return JServer(path, mesh_enabled=False, coalescer_enabled=False,
                   containers_kinds=False, ingest_delta_enabled=False)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    mesh_was = (meshexec.config().enabled, meshexec.config().axis_size)
    ct_was = {k: getattr(jct.config(), k)
              for k in type(jct.config()).__slots__}
    data = dataset(91)
    js = jax_server(str(tmp_path_factory.mktemp("jax")))
    try:
        js.open()
        ts = TServer(str(tmp_path_factory.mktemp("torch")), device="cpu")
        ts.open()
        try:
            for s in (js, ts):
                load(s.uri, data)
            yield js, ts, data
        finally:
            ts.close()
    finally:
        js.close()
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])
        jct.configure(**ct_was)


def _preds(fname: str) -> list[int]:
    lo, hi = FIELDS[fname]
    return sorted({lo, hi, lo - 1, hi + 1, lo + 1, -1, 0, 1, 7,
                   (lo + hi) // 2})


def range_queries() -> list[str]:
    """Every operator against every edge predicate, one request per
    field and operator."""
    out = []
    for fname in FIELDS:
        for op in OPS:
            out.append(" ".join(f"Count(Row({fname} {op} {p}))"
                                for p in _preds(fname)))
    return out


QUERIES = [
    "Row(v > 900)", "Row(v < -990)", "Row(w == 100)", "Row(w >= 4990)",
    "Count(Row(v != null)) Count(Row(w != null))",
    "Count(Row(-100 < v < 500)) Count(Row(-500 <= v <= -100)) "
    "Count(Row(100 < v <= 900)) Count(Row(-1000 <= v <= 1000)) "
    "Count(Row(-2000 < v < -1500)) Count(Row(150 < w < 4000)) "
    "Count(Row(0 <= w <= 99)) Count(Row(-5 < w < 5000))",
    "Count(Intersect(Row(f=1), Row(v > 10)))",
    "Count(Union(Row(v < -500), Row(w > 4000)))",
    "Count(Difference(Row(v != null), Row(v == 0)))",
    "Count(Not(Row(v > 0)))",
    "Row(Intersect(Row(f=2), Row(w < 150)))",
    "Sum(field=v) Sum(field=w) Sum(Row(f=1), field=v) "
    "Sum(Row(v > 0), field=w)",
    "Min(field=v) Max(field=v) Min(field=w) Max(field=w)",
    "Min(Row(f=1), field=v) Max(Row(f=2), field=w) "
    "Max(Row(v < 0), field=v) Min(Row(v > 0), field=v)",
    "Sum(Row(f=9), field=v) Min(Row(f=9), field=w)",
    # errors
    "Sum(field=f)", "Sum(field=nope)", "Sum()", "Count(Row(v == null))",
    "Set(3, v=2000)", "Set(3, w=50)", "Count(Row(nope > 3))",
]
#: the shapes that also run on one shard (the per-shard route): a range
#: row, a range row in a tree, and the aggregates
SHARD_QUERIES = [QUERIES[i] for i in (0, 5, 6, 11, 12, 13, 14)]


def _same(js, ts, queries, paths=PATHS) -> None:
    for path in paths:
        for q in queries:
            want = post(js.uri, path, q.encode(), "text/plain")
            got = post(ts.uri, path, q.encode(), "text/plain")
            assert got[0] == want[0], (path, q, got, want)
            if want[0] == 200:
                assert got[1] == want[1], (path, q)


@pytest.mark.parametrize("group", ["ranges", "shapes"])
def test_answers_byte_identical_json(servers, group):
    js, ts, _data = servers
    if group == "ranges":
        _same(js, ts, range_queries())
    else:
        _same(js, ts, QUERIES + [
            # a range row as TopN's filter (one K4 scan on a card)
            "TopN(f, Row(v > 0), n=2)"], PATHS[:1])
        _same(js, ts, SHARD_QUERIES, PATHS[1:])


def _count(ts, q: str, path: str = "/index/i/query") -> list:
    st, body = post(ts.uri, path, q.encode(), "text/plain")
    assert st == 200, body
    return json.loads(body)["results"]


def _check_oracle(ts, values: dict, f1: NaiveBitmap) -> None:
    """Counts, rows and aggregates against the value dicts."""
    cmp = {"==": np.equal, "!=": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
    for fname in FIELDS:
        vals = values[fname]
        held_vals = np.array(list(vals.values()))
        for op in OPS:
            preds = _preds(fname)
            want = [int(cmp[op](held_vals, p).sum()) for p in preds]
            assert _count(ts, " ".join(f"Count(Row({fname} {op} {p}))"
                                       for p in preds)) == want, (fname, op)
        rows = NaiveBitmap([c for c, x in vals.items() if x > 7], NBITS)
        got = _count(ts, f"Row({fname} > 7)")[0]["columns"]
        assert got == rows.positions()
        held = {c: x for c, x in vals.items() if c in f1.bits}
        assert _count(ts, f"Sum(Row(f=1), field={fname})") == [
            {"value": sum(held.values()), "count": len(held)}]
        lo = min(vals.values())
        hi = max(held.values())
        assert _count(ts, f"Min(field={fname}) Max(Row(f=1), "
                          f"field={fname})") == [
            {"value": lo, "count": sum(1 for x in vals.values() if x == lo)},
            {"value": hi, "count": sum(1 for x in held.values()
                                       if x == hi)}]
        # one shard
        one = {c: x for c, x in vals.items() if c // SHARD_WIDTH == 2}
        assert _count(ts, f"Sum(field={fname})",
                      "/index/i/query?shards=2") == [
            {"value": sum(one.values()), "count": len(one)}]


def test_answers_agree_with_the_naive_oracle_and_follow_clears(servers):
    js, ts, data = servers
    f1 = NaiveBitmap(data["f"][1], NBITS)
    _check_oracle(ts, oracle_values(data), f1)
    # clear a few values of each field (the value argument is ignored),
    # in both servers, and check everything again
    cleared = []
    for fname in FIELDS:
        cols, _vals = data["imports"][fname]
        for col in cols[:3] + cols[-2:]:
            q = f"Clear({col}, {fname}=0)".encode()
            want = post(js.uri, "/index/i/query", q, "text/plain")
            got = post(ts.uri, "/index/i/query", q, "text/plain")
            assert got == want
            cleared.append((fname, col))
    _check_oracle(ts, oracle_values(data, cleared), f1)
    _same(js, ts, range_queries() + QUERIES[:16], PATHS[:1])
    _same(js, ts, SHARD_QUERIES, PATHS[1:])


def test_int_field_launch_sites_on_a_cpu_server(servers):
    """The calls that launch K6, K1 and K4 on a card: one compare per
    fused range leaf (two for a between across zero), the plane counts
    and a filtered Sum's K1 count; a CPU server launches no kernel.  The
    queries skip the result cache (``?nocache=1``), whose hit would
    launch nothing."""
    _js, ts, _data = servers
    before = ck.launch_counts()
    for q, compares, counts_and in (
            ("Count(Row(v > 10))", 1, 0),
            ("Count(Row(-100 < v < 500))", 2, 0),
            ("Count(Row(v != null))", 0, 0),
            ("Count(Row(v >= 2000))", 0, 0),
            ("Sum(field=v)", 0, 0),
            ("Sum(Row(f=1), field=v)", 0, 1)):
        with tbm.dispatch_counter() as dc:
            ts.api.query("i", q, cache=False)
        assert dc.launches.count("bsi_compare") == compares, q
        assert dc.launches.count("popcount_and") == counts_and, q
        assert dc.launches.count("plane_counts") == \
            (1 if q.startswith("Sum") else 0), q
    assert ck.launch_counts() == before


def test_value_import_refuses_floats_and_values_out_of_range(servers):
    js, ts, _data = servers
    for body in ({"columnIDs": [1], "values": [1.5]},
                 {"columnIDs": [1], "values": [5000]},
                 {"columnIDs": [1, 2], "values": [1]}):
        raw = json.dumps(body).encode()
        want = post(js.uri, "/index/i/field/v/import-value", raw)
        got = post(ts.uri, "/index/i/field/v/import-value", raw)
        assert got[0] == want[0] == 400, (body, got, want)


def test_roaring_import_of_plane_rows_equals_value_import(servers, tmp_path):
    """An int field's planes load in process through
    ``Field.import_roaring(shard, blob, view="bsig_<field>")``: the same
    values as through import-value give the same answers.  Over HTTP,
    import-roaring into an int field answers the reference's 400 and
    writes nothing."""
    import base64

    from pilosa_tpu_torch.storage import roaring as troaring

    js, _ts, _data = servers
    rng = np.random.default_rng(5)
    cols = rng.choice(SHARD_WIDTH, size=500, replace=False)
    vals = rng.integers(-1000, 1001, size=len(cols))
    ts = TServer(str(tmp_path / "t"), device="cpu")
    ts.open()
    try:
        assert post(ts.uri, "/index/i", b"{}")[0] == 200
        for fname in ("a", "b"):
            opts = {"options": {"type": "int", "min": -1000, "max": 1000,
                                "bitDepth": 10}}
            assert post(ts.uri, f"/index/i/field/{fname}",
                        json.dumps(opts).encode())[0] == 200
        body = json.dumps({"columnIDs": cols.tolist(),
                           "values": vals.tolist()}).encode()
        assert post(ts.uri, "/index/i/field/a/import-value", body)[0] == 200
        mag = np.abs(vals)
        pos = [cols, cols[vals < 0]] + [
            cols[((mag >> i) & 1) == 1] for i in range(10)]
        positions = np.sort(np.concatenate(
            [p + r * SHARD_WIDTH for r, p in enumerate(pos)])).astype(
            np.uint64)
        keys, words = troaring.positions_to_containers(positions)
        blob = troaring.encode(keys, words)
        b64 = base64.b64encode(blob).decode()
        # the wire refuses it as the reference does, for either view
        for fname, view in (("b", "bsig_b"), ("b", "standard")):
            raw = json.dumps({"views": {view: b64}}).encode()
            got = post(ts.uri, f"/index/i/field/{fname}/import-roaring/0",
                       raw)
            jraw = json.dumps({"views": {"bsig_v": b64}}).encode()
            want = post(js.uri, "/index/i/field/v/import-roaring/0", jraw)
            assert got == want, (view, got, want)
            assert want[0] == 400
        assert _count(ts, "Count(Row(b != null))") == [0]
        ts.holder.index("i").field("b").import_roaring(0, blob,
                                                       view="bsig_b")
        for q in ("Count(Row({} > 10))", "Sum(field={})", "Min(field={})",
                  "Row(-5 < {} < 300)"):
            assert (_count(ts, q.format("a")) == _count(ts, q.format("b"))), q
    finally:
        ts.close()


# ------------------------------------------------------------- on disk


def _write_values(holder, options_cls) -> dict:
    """Import-value, Set and Clear into two int fields of one holder;
    returns the field -> {column: value} it wrote."""
    rng = np.random.default_rng(17)
    idx = holder.create_index("i")
    out = {}
    for fname, (lo, hi) in FIELDS.items():
        f = idx.create_field(fname, options_cls.int_field(lo, hi))
        cols = rng.choice(NBITS, size=300, replace=False)
        vals = rng.integers(lo, hi + 1, size=len(cols))
        f.import_values(cols.tolist(), vals.tolist())
        out[fname] = dict(zip(cols.tolist(), vals.tolist()))
        for col, val in ((int(cols[0]), lo), (5, hi), (SHARD_WIDTH + 9, 0
                                                        if lo <= 0 else lo)):
            f.set_value(col, val)
            out[fname][col] = val
        f.clear_value(int(cols[1]))
        out[fname].pop(int(cols[1]))
    return out


def _bsi_files(root: str) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        if "bsig_" not in d:
            continue
        for fn in files:
            with open(os.path.join(d, fn), "rb") as fh:
                out[os.path.relpath(os.path.join(d, fn), root)] = fh.read()
    return out


def _values(holder, cols) -> dict:
    """field -> {column: value} over ``cols``."""
    idx = holder.index("i")
    out = {}
    for fname in FIELDS:
        f = idx.field(fname)
        out[fname] = {}
        for c in cols:
            v, ok = f.value(c)
            if ok:
                out[fname][c] = v
    return out


def test_bsi_fragment_files_are_byte_identical_and_cross_open(tmp_path):
    from pilosa_tpu.models.field import FieldOptions as JFieldOptions

    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jh = JHolder(jd)
    th = THolder(td, device="cpu")
    try:
        want = _write_values(jh, JFieldOptions)
        assert _write_values(th, TFieldOptions) == want
        wal_j, wal_t = _bsi_files(jd), _bsi_files(td)
        assert wal_j and wal_j == wal_t  # the WAL records
        jh.snapshot()
        th.snapshot()
        snap_j, snap_t = _bsi_files(jd), _bsi_files(td)
        assert any(k.endswith(".snap") for k in snap_j)
        assert snap_j == snap_t
    finally:
        jh.close()
        th.close()
    # each package opens the other's directory: every written column
    # (the cleared ones among them) and a stride of the others
    cols = sorted(set().union(*want.values()) | set(range(0, NBITS, 997))
                  | {int(c) for c in np.random.default_rng(17).choice(
                      NBITS, size=300, replace=False)})
    t_on_j = THolder(jd, device="cpu")
    try:
        assert _values(t_on_j, cols) == want
    finally:
        t_on_j.close()
    j_on_t = JHolder(td)
    try:
        assert _values(j_on_t, cols) == want
    finally:
        j_on_t.close()
