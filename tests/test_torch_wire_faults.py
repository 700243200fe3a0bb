"""Wire answers of the port that once differed from the JAX package's,
each pinned against a JAX server on the same requests:

- ``?columnAttrs=true`` and ``Options(..., columnAttrs=true)`` add
  ``"columnAttrs": []`` wherever the reference adds it (neither server
  here has any column attributes), and
  ``Options(..., excludeRowAttrs=true)`` answers as the reference does;
- a field created with a type string the reference does not know is
  stored and served as the reference serves it: as a set field for
  ``Set``/``Row``/``Count``/``Clear``/``TopN``/``Rows``/``GroupBy``, and
  refused by range rows and aggregates with the reference's errors.

(``import-roaring`` into an int field, the third, is pinned in
tests/test_torch_int_field.py.)  And the five of ROADMAP Queue 3:

- ``Range(...)``, the legacy name of ``Row``, is served;
- an unknown call, ``Distinct(...)`` and a time range on a field with no
  time quantum get the reference's errors;
- ``?partial=1`` and ``X-Pilosa-Partial`` add the degraded-read meta;
- a body sent as protobuf that breaks the wire format is refused on the
  query and import routes with the reference's status and message, and
  writes nothing (well-formed protobuf bodies are held to the reference
  in tests/test_torch_proto.py);
- ``/import`` with timestamps into a field with no time quantum writes
  the standard view after the reference's length check.

The JAX server runs the configuration the port implements, the result
cache at its default (on) in both; the fixture restores exactly the
process-wide fields the servers touch.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from pilosa_tpu import ingest as jingest
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.server.server import Server as TServer


def post(uri: str, path: str, body: bytes,
         ctype: str = "application/json",
         headers: dict | None = None) -> tuple[int, bytes]:
    req = urllib.request.Request(uri + path, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _slots(cfg) -> dict:
    return {k: getattr(cfg, k) for k in type(cfg).__slots__}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    mesh_was = (meshexec.config().enabled, meshexec.config().axis_size)
    jct_was, tct_was = _slots(jct.config()), _slots(tct.config())
    ingest_was = _slots(jingest.config())
    js = JServer(str(tmp_path_factory.mktemp("jax")), mesh_enabled=False,
                 coalescer_enabled=False, ingest_delta_enabled=False)
    try:
        js.open()
        ts = TServer(str(tmp_path_factory.mktemp("torch")), device="cpu")
        ts.open()
        try:
            for s in (js, ts):
                assert post(s.uri, "/index/i", b"{}")[0] == 200
                assert post(s.uri, "/index/i/field/f", b"{}")[0] == 200
                for q in ("Set(5, f=1)", "Set(70000, f=1)", "Set(9, f=2)"):
                    assert post(s.uri, "/index/i/query", q.encode(),
                                "text/plain")[0] == 200
            yield js, ts
        finally:
            ts.close()
    finally:
        js.close()
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])
        jct.configure(**jct_was)
        tct.configure(**tct_was)
        for k, v in ingest_was.items():
            setattr(jingest.config(), k, v)


def _same(servers, path: str, body: bytes, ctype: str = "text/plain",
          headers: dict | None = None):
    js, ts = servers
    want = post(js.uri, path, body, ctype, headers)
    got = post(ts.uri, path, body, ctype, headers)
    assert got == want, (path, body, got, want)
    return got


@pytest.mark.parametrize("path,pql,keyed", [
    ("/index/i/query?columnAttrs=true", "Row(f=1)", True),
    ("/index/i/query?columnAttrs=true", "Count(Row(f=1)) Row(f=2)", True),
    ("/index/i/query?columnAttrs=true", "Count(Row(f=1))", True),
    ("/index/i/query?columnAttrs=false", "Row(f=1)", False),
    ("/index/i/query", "Options(Row(f=1), columnAttrs=true)", True),
    ("/index/i/query", "Options(Row(f=1), columnAttrs=false)", False),
    ("/index/i/query", "Options(Count(Row(f=1)), columnAttrs=true)", False),
    ("/index/i/query", "Options(Row(f=1), excludeRowAttrs=true)", False),
    ("/index/i/query?excludeColumns=true",
     "Options(Row(f=1), columnAttrs=true)", True),
])
def test_column_attrs_answer_as_the_reference(servers, path, pql, keyed):
    status, body = _same(servers, path, pql.encode())
    assert status == 200
    assert (b'"columnAttrs": []' in body) == keyed


QUERIES = [
    "Set(3, k3=1)", "Set(70001, k3=1)", "Row(k3=1)", "Count(Row(k3=1))",
    "Count(Intersect(Row(f=1), Row(k3=1)))", "Union(Row(k3=1), Row(f=2))",
    "Clear(3, k3=1)", "Row(k3=1)", "TopN(k3)", "Rows(k3)",
    "GroupBy(Rows(k3))", "Row(k3 > 1)", "Sum(field=k3)", "Not(Row(k3=1))",
]


def test_a_field_of_unknown_type_is_served_as_the_reference_serves_it(
        servers):
    status, _body = _same(servers, "/index/i/field/k3",
                          b'{"options": {"type": "bogus"}}',
                          "application/json")
    assert status == 200
    for q in QUERIES:
        _same(servers, "/index/i/query", q.encode())
        _same(servers, "/index/i/query?shards=1", q.encode())
    # a roaring import into it is refused as the reference refuses it
    status, _body = _same(servers, "/index/i/field/k3/import-roaring/0",
                          b'{"views": {"": ""}}', "application/json")
    assert status == 400


# ------------------------------------------------- ROADMAP Queue 3 items 1-5


@pytest.mark.parametrize("pql", [
    "Range(f=1)", "Count(Range(f=1))", "Union(Range(f=1), Row(f=2))",
    "Count(Intersect(Range(f=1), Row(f=1)))", "Range(f=7)",
])
@pytest.mark.parametrize("flags", ["", "?shards=1", "?nocache=1"])
def test_range_is_served_as_row(servers, pql, flags):
    status, body = _same(servers, "/index/i/query" + flags, pql.encode())
    assert status == 200, body


@pytest.mark.parametrize("pql", [
    "Bogus()", "Count(Bogus(f=1))", "Union(Count(Row(f=1)))",
    "Count(Union(Row(f=1), Count(Row(f=2))))", "Count(Xor(TopN(f)))",
    "Distinct(Row(f=1), field=f)", "Count(Distinct(Row(f=1), field=f))",
    "Row(f=1, from='2020-01-01T00:00', to='2021-01-01T00:00')",
    "Count(Row(f=1, from='2020-01-01T00:00'))",
    "Count(Range(f=1, to='2021-01-01T00:00'))",
])
def test_rejections_carry_the_reference_wording(servers, pql):
    status, body = _same(servers, "/index/i/query", pql.encode())
    assert status == 400
    assert b"by this port yet" not in body


@pytest.mark.parametrize("how", ["?partial=1", "?partial=true", "header"])
@pytest.mark.parametrize("pql", ["Count(Row(f=1))", "Row(f=1) TopN(f)"])
def test_partial_reads_carry_the_degraded_read_meta(servers, how, pql):
    path, headers = "/index/i/query", None
    if how == "header":
        headers = {"X-Pilosa-Partial": "1"}
    else:
        path += how
    status, body = _same(servers, path, pql.encode(), headers=headers)
    assert status == 200
    assert body.endswith(b'"missingShards": [], "missingFraction": 0.0}')


PB = "application/x-protobuf"


@pytest.mark.parametrize("path,body", [
    ("/index/i/query", b"Count(Row(f=1))"),
    ("/index/i/query", b'{"query": "Count(Row(f=1))"}'),
    ("/index/i/field/f/import",
     b'{"rowIDs": [4, 4], "columnIDs": [1, 70001]}'),
    ("/index/i/field/f/import-roaring/0",
     b'{"views": {"": "OjAAAAEAAAAAAAAAEAAAAAEA"}}'),
    ("/index/i/field/f/import", b"\x08"),
    ("/index/i/field/f/import", b"\x0a\x05ab"),
])
def test_protobuf_bodies_are_refused_and_write_nothing(servers, path, body):
    status, _ = _same(servers, path, body, PB)
    assert status == 400
    for q in ("Row(f=4)", "Count(Row(f=4))", "Row(f=0)", "Rows(f)"):
        _same(servers, "/index/i/query", q.encode())


def test_protobuf_int_imports_are_refused(servers):
    _same(servers, "/index/i/field/pv",
          b'{"options": {"type": "int", "min": 0, "max": 100}}',
          "application/json")
    status, _ = _same(servers, "/index/i/field/pv/import-value",
                      b'{"columnIDs": [1], "values": [7]}', PB)
    assert status == 400
    _same(servers, "/index/i/query", b"Sum(field=pv)")


@pytest.mark.parametrize("body,ok", [
    ({"rowIDs": [6, 6], "columnIDs": [3, 70003],
      "timestamps": [1600000000, "2021-03-04T05:06"]}, True),
    ({"rowIDs": [6], "columnIDs": [8], "timestamps": [None]}, True),
    ({"rowIDs": [6], "columnIDs": [9],
      "timestamps": [1600000000000000000]}, True),
    ({"rowIDs": [6, 6], "columnIDs": [3, 4], "timestamps": [1600000000]},
     False),
    ({"rowIDs": [6], "columnIDs": [3], "timestamps": []}, False),
    ({"rowIDs": [6], "columnIDs": [3], "timestamps": ["not a time"]},
     False),
])
def test_import_timestamps_into_a_set_field(servers, body, ok):
    status, _ = _same(servers, "/index/i/field/f/import",
                      json.dumps(body).encode(), "application/json")
    assert (status == 200) == ok
    for q in ("Row(f=6)", "Count(Row(f=6))", "TopN(f)"):
        _same(servers, "/index/i/query", q.encode())
