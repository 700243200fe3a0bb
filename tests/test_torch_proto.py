"""Protobuf bodies: the port's codec (pilosa_tpu_torch/proto.py) against
the JAX package's, and a port server against a JAX-package server on
protobuf requests, both at their defaults (delta planes, result cache and
coalescer on), mesh off, on the CPU at the test width.

The codec: every message schema round-trips seeded objects made with
numpy (short and long packed fields, so both the byte loop and the numpy
paths run, ``arrays=True`` too) to the same bytes and the same dicts in
both packages, and both refuse the same broken bodies with the same
message.  ``result_to_proto`` of every result type encodes to the same
``QueryResponse`` bytes, and ``proto_to_result`` reads them back.

The servers, with zero tolerance, with and without ``Accept:
application/x-protobuf``: ``QueryRequest`` bodies (shards, columnAttrs,
excludeRowAttrs, excludeColumns, a write, errors as ``QueryResponse.err``
with 400), ``/import`` (ids, keys, nanosecond timestamps), ``/import-
value``, ``/import-roaring`` (named views, ``clear``) with the empty
``ImportResponse``, and ``/internal/translate/keys``.  Every answer is
checked against a numpy oracle where it carries data, and the ``.wal``
and ``.snap`` files and the translate stores end the same.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from pilosa_tpu import proto as jproto
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.models.row import Row as JRow
from pilosa_tpu.parallel import results as jres
from pilosa_tpu.runtime import snapqueue
from pilosa_tpu_torch import proto as tproto
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.models.row import Row as TRow
from pilosa_tpu_torch.parallel import results as tres
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import roaring

# tests/ is on sys.path under pytest (rootdir-less test files); another
# installed package is named ``tests``
import torch_wire_pair as wp  # noqa: E402

W = SHARD_WIDTH
PB = wp.PB

SCHEMAS = ["ATTR", "ROW", "ROW_IDENTIFIERS", "PAIR", "FIELD_ROW",
           "GROUP_COUNT", "VAL_COUNT", "COLUMN_ATTR_SET", "QUERY_REQUEST",
           "QUERY_RESULT", "QUERY_RESPONSE", "IMPORT_REQUEST",
           "IMPORT_VALUE_REQUEST", "IMPORT_ROARING_VIEW",
           "IMPORT_ROARING_REQUEST", "IMPORT_RESPONSE",
           "TRANSLATE_KEYS_REQUEST", "TRANSLATE_KEYS_RESPONSE"]


# ------------------------------------------------------------------ codec


def _value(rng, spec, depth: int):
    kind = spec[1]
    if kind.endswith("*"):
        n = int(rng.choice([0, 1, 3, 1500])) if kind in ("uint*", "int*") \
            else int(rng.integers(0, 4))
        if depth > 2 and kind == "msg*":
            n = 0
        return [_value(rng, (spec[0], kind[:-1]) + spec[2:], depth)
                for _ in range(n)]
    if kind == "uint":
        return int(rng.choice([0, 1, int(rng.integers(0, 1 << 62)),
                               (1 << 64) - 1]))
    if kind == "int":
        return int(rng.choice([0, -1, int(rng.integers(-(1 << 62),
                                                       1 << 62))]))
    if kind == "bool":
        return bool(rng.integers(0, 2))
    if kind == "double":
        return float(rng.choice([0.0, float(rng.normal())]))
    if kind == "string":
        n = int(rng.integers(0, 12))
        return "".join(chr(int(c)) for c in rng.choice(
            [*range(97, 123), 0x3b1, 0x4e2d, 0x1f600], size=n))
    if kind == "bytes":
        return rng.integers(0, 256, size=int(rng.integers(0, 40)),
                            dtype=np.uint8).tobytes()
    if kind == "msg":
        return None if depth > 2 else _obj(rng, spec[2], depth + 1)
    raise AssertionError(kind)


def _obj(rng, schema: dict, depth: int = 0) -> dict:
    return {spec[0]: _value(rng, spec, depth) for spec in schema.values()}


def _plain(v):
    """ndarrays as lists, for comparing decoded dicts."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("name", SCHEMAS)
def test_every_message_round_trips_the_same_in_both_codecs(name):
    js, ts = getattr(jproto, name), getattr(tproto, name)
    assert repr(js) == repr(ts)
    rng = np.random.default_rng(16)
    for _ in range(12):
        obj = _obj(rng, js)
        data = jproto.encode(js, obj)
        assert tproto.encode(ts, obj) == data
        for arrays in (False, True):
            want = jproto.decode(js, data, arrays=arrays)
            got = tproto.decode(ts, data, arrays=arrays)
            assert _plain(got) == _plain(want)
        # and what each decoded encodes the same again
        assert tproto.encode(ts, tproto.decode(ts, data)) == \
            jproto.encode(js, jproto.decode(js, data))


def _decode_outcome(mod, schema, data: bytes):
    try:
        return ("ok", _plain(mod.decode(schema, data, arrays=True)))
    except (ValueError, UnicodeDecodeError) as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("name", ["QUERY_REQUEST", "IMPORT_REQUEST",
                                  "IMPORT_VALUE_REQUEST",
                                  "IMPORT_ROARING_REQUEST",
                                  "TRANSLATE_KEYS_REQUEST"])
def test_broken_bodies_fail_the_same_in_both_codecs(name):
    js, ts = getattr(jproto, name), getattr(tproto, name)
    rng = np.random.default_rng(17)
    bodies = [b"\x08", b"\x0a\x05ab", b"\x0b", b"\xff" * 11, b"\x11abc",
              b"\x15ab", b"Count(Row(f=1))", b'{"query": "x"}']
    for _ in range(20):
        data = jproto.encode(js, _obj(rng, js))
        if data:
            cut = int(rng.integers(0, len(data)))
            bodies.append(data[:cut])
            flip = bytearray(data)
            flip[int(rng.integers(0, len(data)))] ^= 0xFF
            bodies.append(bytes(flip))
    for body in bodies:
        assert _decode_outcome(tproto, ts, body) == _decode_outcome(
            jproto, js, body), body


def _results(pkg):
    """One result of every type the executor returns, built from the
    package's own classes."""
    Row, res = pkg

    def row(cols, keys=(), attrs=None, exclude=False):
        r = Row.from_columns(cols)
        r.keys = list(keys)
        r.attrs = attrs or {}
        r.exclude_columns = exclude
        return r

    fr = res.FieldRow
    return [
        row([1, 70000, 3 * W + 5], attrs={"a": 1, "b": "x", "c": True,
                                          "d": 2.5}),
        row([2, 9], keys=["x", "y"]),
        row([4], exclude=True),
        row([]),
        True, False, 0, 123456789,
        res.ValCount(val=-7, count=3),
        res.Pair(id=4, count=9), res.Pair(id=0, key="k", count=2),
        res.PairField(pair=res.Pair(id=3, count=1), field="f"),
        [res.Pair(id=1, count=5), res.Pair(id=2, key="z", count=4)],
        [res.GroupCount(group=[fr(field="f", row_id=1),
                               fr(field="g", row_id=0, row_key="q")],
                        count=8)],
        [1, 5, 9], ["a", "b"], [], None,
    ]


def test_results_encode_the_same_and_read_back():
    want_objs = _results((JRow, jres))
    got_objs = _results((TRow, tres))
    want = jproto.encode(jproto.QUERY_RESPONSE, {
        "results": [jproto.result_to_proto(r) for r in want_objs]})
    got = tproto.encode(tproto.QUERY_RESPONSE, {
        "results": [tproto.result_to_proto(r) for r in got_objs]})
    assert got == want
    jback = [jproto.proto_to_result(r) for r in
             jproto.decode(jproto.QUERY_RESPONSE, want)["results"]]
    tback = [tproto.proto_to_result(r) for r in
             tproto.decode(tproto.QUERY_RESPONSE, got)["results"]]
    from pilosa_tpu.server.handler import serialize_result as jser
    from pilosa_tpu_torch.server.handler import serialize_result as tser

    assert [tser(r) for r in tback] == [jser(r) for r in jback]
    attrs = {"s": "x", "i": -3, "b": False, "f": 0.25}
    assert tproto.attrs_to_proto(attrs) == jproto.attrs_to_proto(attrs)
    assert tproto.proto_to_attrs(tproto.attrs_to_proto(attrs)) == attrs


# ----------------------------------------------------------------- servers


@pytest.fixture(autouse=True)
def _configuration():
    with wp.configuration():
        yield


@pytest.fixture
def pair(tmp_path):
    with wp.servers(str(tmp_path)) as p:
        yield p


def pbq(pair, pql: str, accept: bool = True, index: str = "i",
        status: int | None = 200, **flags) -> bytes:
    body = tproto.encode(tproto.QUERY_REQUEST, dict(query=pql, **flags))
    return wp.both(pair, f"/index/{index}/query", body, PB,
                   accept=PB if accept else None, status=status)


def results(data: bytes) -> list:
    d = tproto.decode(tproto.QUERY_RESPONSE, data)
    assert d["err"] == ""
    return [tproto.proto_to_result(r) for r in d["results"]]


def _schema(pair) -> None:
    wp.both(pair, "/schema", json.dumps({"indexes": [
        {"name": "i", "options": {}, "fields": [
            {"name": "f", "options": {}},
            {"name": "g", "options": {}},
            {"name": "v", "options": {"type": "int", "min": -50,
                                      "max": 1000}},
            {"name": "t", "options": {"type": "time",
                                      "timeQuantum": "YMD"}}]},
        {"name": "ki", "options": {"keys": True}, "fields": [
            {"name": "kf", "options": {"keys": True}},
            {"name": "kv", "options": {"type": "int", "min": 0,
                                       "max": 100}}]},
    ]}).encode())


def test_protobuf_imports_and_queries_match_the_reference(pair):
    rng = np.random.default_rng(16)
    _schema(pair)
    bits: dict = {}
    # /import: ids, long packed fields (numpy paths), with Accept and
    # without; then the same route in JSON never mixes in
    cols = rng.choice(3 * W, size=5000, replace=False)
    rows = rng.integers(1, 6, size=len(cols))
    half = len(cols) // 2
    for lo, hi, accept in ((0, half, PB), (half, len(cols), None)):
        body = tproto.encode(tproto.IMPORT_REQUEST, {
            "index": "i", "field": "f",
            "rowIDs": rows[lo:hi].tolist(),
            "columnIDs": cols[lo:hi].tolist()})
        out = wp.both(pair, "/index/i/field/f/import", body, PB,
                      accept=accept)
        assert out == (b"" if accept else b"{}")
    for r, c in zip(rows, cols):
        bits.setdefault(("f", int(r)), set()).add(int(c))
    # timestamps in nanoseconds, 0 for none
    ts = [1706500000 * 10**9, 0, 1706600000 * 10**9]
    body = tproto.encode(tproto.IMPORT_REQUEST, {
        "rowIDs": [1, 1, 2], "columnIDs": [5, 70005, 9], "timestamps": ts})
    wp.both(pair, "/index/i/field/t/import", body, PB, accept=PB)
    # keys
    ck = [f"c{int(n)}" for n in rng.choice(10**6, size=3000, replace=False)]
    rk = [f"r{int(n)}" for n in rng.integers(0, 6, size=len(ck))]
    body = tproto.encode(tproto.IMPORT_REQUEST, {
        "rowKeys": rk, "columnKeys": ck})
    wp.both(pair, "/index/ki/field/kf/import", body, PB, accept=PB)
    for r, c in zip(rk, ck):
        bits.setdefault(("kf", r), set()).add(c)
    # /import-value, by id and by key
    vc = rng.choice(3 * W, size=1200, replace=False)
    vv = rng.integers(-50, 1001, size=len(vc))
    body = tproto.encode(tproto.IMPORT_VALUE_REQUEST, {
        "columnIDs": vc.tolist(), "values": vv.tolist()})
    wp.both(pair, "/index/i/field/v/import-value", body, PB, accept=PB)
    body = tproto.encode(tproto.IMPORT_VALUE_REQUEST, {
        "columnKeys": ck[:100], "values": list(range(100))})
    wp.both(pair, "/index/ki/field/kv/import-value", body, PB)
    # /import-roaring: named views, then a clearing one
    gc = np.sort(rng.choice(W, size=700, replace=False))
    blob = _roaring_row(1, gc)
    body = tproto.encode(tproto.IMPORT_ROARING_REQUEST, {
        "views": [{"name": "", "data": blob}]})
    wp.both(pair, "/index/i/field/g/import-roaring/1", body, PB, accept=PB)
    body = tproto.encode(tproto.IMPORT_ROARING_REQUEST, {
        "clear": True, "views": [{"name": "standard",
                                  "data": _roaring_row(1, gc[:100])}]})
    wp.both(pair, "/index/i/field/g/import-roaring/1", body, PB)
    bits[("g", 1)] = {W + int(c) for c in gc[100:]}

    reads = [
        ("Count(Row(f=1))", {}), ("Row(f=2)", {}),
        ("Count(Intersect(Row(f=1), Row(f=2)))", {}),
        ("Count(Union(Row(f=3), Row(g=1)))", {}),
        ("TopN(f, n=3)", {}), ("TopN(f, Row(g=1), n=4)", {}),
        ("Rows(f)", {}), ("GroupBy(Rows(f), Rows(g))", {}),
        ("Sum(field=v)", {}), ("Min(field=v)", {}), ("Max(field=v)", {}),
        ("Row(v > 500)", {}), ("MaxRow(field=f)", {}),
        ("Row(t=1, from=2024-01-01T00:00, to=2024-02-01T00:00)", {}),
        ("Count(Row(f=1))", {"shards": [0, 2]}),
        ("Row(f=1)", {"excludeColumns": True}),
        ("Row(f=1)", {"columnAttrs": True}),
        ("Row(f=1)", {"excludeRowAttrs": True}),
        ("Set(3, f=9) Row(f=9) Clear(3, f=9)", {}),
        ("Options(Row(f=4), columnAttrs=true)", {}),
    ]
    wp.both(pair, "/index/i/query", b"SetRowAttrs(f, 1, c=\"x\", n=2)",
            "text/plain")
    wp.both(pair, "/index/i/query",
            f"SetColumnAttrs({sorted(bits[('f', 4)])[0]}, a=true)".encode(),
            "text/plain")
    for pql, flags in reads:
        for accept in (True, False):
            pbq(pair, pql, accept=accept, **flags)
    keyed = ['Row(kf="r1")', 'Count(Row(kf="r2"))', "TopN(kf, n=3)",
             "Rows(kf)", "GroupBy(Rows(kf))", 'Row(kf="nope")',
             'Options(Row(kf="r1"), columnAttrs=true)', "Sum(field=kv)"]
    wp.both(pair, "/index/ki/query", b'SetColumnAttrs("c1", q=1)',
            "text/plain")
    for pql in keyed:
        for accept in (True, False):
            pbq(pair, pql, accept=accept, index="ki")

    # the answers against the oracle
    got = results(pbq(pair, "Count(Row(f=1)) Row(f=2) TopN(f, n=2)"))
    assert got[0] == len(bits[("f", 1)])
    assert got[1].columns().tolist() == sorted(bits[("f", 2)])
    want_top = sorted(((r, len(bits[("f", r)])) for r in range(1, 6)),
                      key=lambda p: (-p[1], p[0]))[:2]
    assert [(p.id, p.count) for p in got[2]] == want_top
    assert results(pbq(pair, "Count(Row(g=1))"))[0] == len(bits[("g", 1)])
    got = results(pbq(pair, 'Row(kf="r1") Count(Row(kf="r3"))',
                      index="ki"))
    assert sorted(got[0].keys) == sorted(bits[("kf", "r1")])
    assert got[1] == len(bits[("kf", "r3")])
    got = results(pbq(pair, "Sum(field=v)"))[0]
    assert (got.val, got.count) == (int(vv.sum()), len(vv))

    snapqueue.drain()
    wp.same_stores(pair)
    wp.same_files(pair, ".wal")
    for comp in (jcompactor.compactor(), tcompactor.compactor()):
        comp.run_once(force=True)
    for srv in pair:
        srv.holder.snapshot()
    wp.same_files(pair, ".snap")


def _roaring_row(row: int, positions) -> bytes:
    """One row's positions within a shard as a roaring blob."""
    pos = np.asarray(positions, dtype=np.uint64) + np.uint64(row * W)
    return roaring.encode(*roaring.positions_to_containers(pos))


@pytest.mark.parametrize("pql,index", [
    ("Count(Row(f=1)", "i"), ("Rows()", "i"), ("Row(nof=1)", "i"),
    ("Count(Row(f=1))", "nope"), ('Row(f="a")', "i"),
    ('Rows(kf, previous="nope")', "ki"), ("_Empty()", "i"),
    ("TopN(f, tanimotoThreshold=101)", "i"),
])
@pytest.mark.parametrize("accept", [True, False])
def test_query_errors_answer_as_the_reference(pair, pql, index, accept):
    _schema(pair)
    out = pbq(pair, pql, accept=accept, index=index, status=400)
    if accept:
        assert tproto.decode(tproto.QUERY_RESPONSE, out)["err"]


@pytest.mark.parametrize("ctype", [PB, "application/json"])
@pytest.mark.parametrize("accept", [PB, None])
def test_translate_keys_route(pair, ctype, accept):
    _schema(pair)
    for d in ({"index": "ki", "keys": ["a", "b", "a"]},
              {"index": "ki", "field": "kf", "keys": ["x", "a", "y"]},
              {"index": "ki", "keys": ["b", "c"]},
              {"index": "ki", "field": "kf", "keys": []}):
        body = (tproto.encode(tproto.TRANSLATE_KEYS_REQUEST, d)
                if ctype == PB else json.dumps(d).encode())
        out = wp.both(pair, "/internal/translate/keys", body, ctype,
                      accept=accept)
        ids = (tproto.decode(tproto.TRANSLATE_KEYS_RESPONSE, out)["ids"]
               if accept else json.loads(out)["ids"])
        assert len(ids) == len(d["keys"])
    wp.both(pair, "/index/ki/query", b'Set("a", kf="x")', "text/plain")
    out = json.loads(wp.both(pair, "/index/ki/query", b'Row(kf="x")',
                             "text/plain"))
    assert out == {"results": [{"keys": ["a"]}]}
    wp.same_stores(pair)


@pytest.mark.parametrize("path,body", [
    ("/index/i/field/f/import", b"\x22\x03\x01\x02"),
    ("/index/i/field/f/import", tproto.encode(
        tproto.IMPORT_REQUEST, {"rowIDs": [1, 2], "columnIDs": [3]})),
    ("/index/i/field/f/import", tproto.encode(
        tproto.IMPORT_REQUEST, {"rowKeys": ["a"], "columnIDs": [3]})),
    ("/index/i/field/f/import", tproto.encode(
        tproto.IMPORT_REQUEST, {"rowIDs": [1], "columnKeys": ["a"]})),
    ("/index/i/field/t/import", tproto.encode(
        tproto.IMPORT_REQUEST, {"rowIDs": [1, 1], "columnIDs": [3, 4],
                                "timestamps": [1]})),
    ("/index/i/field/v/import-value", tproto.encode(
        tproto.IMPORT_VALUE_REQUEST, {"columnIDs": [1], "values": [5000]})),
    ("/index/i/field/v/import-roaring/0", tproto.encode(
        tproto.IMPORT_ROARING_REQUEST, {"views": [{"name": "",
                                                   "data": b""}]})),
    ("/index/i/field/f/import-roaring/0", tproto.encode(
        tproto.IMPORT_ROARING_REQUEST, {"views": [{"name": "",
                                                   "data": b"junk"}]})),
    ("/index/nope/field/f/import", tproto.encode(
        tproto.IMPORT_REQUEST, {"rowIDs": [1], "columnIDs": [3]})),
    ("/index/i/query", tproto.encode(tproto.QUERY_REQUEST, {})),
])
@pytest.mark.parametrize("accept", [PB, None])
def test_protobuf_edge_bodies_answer_as_the_reference(pair, path, body,
                                                      accept):
    _schema(pair)
    wp.both(pair, path, body, PB, accept=accept, status=None)
    for q in ("Rows(f)", "Count(Row(f=1))", "Sum(field=v)", "Rows(t)"):
        wp.both(pair, "/index/i/query", q.encode(), "text/plain")
