"""Wire answers of the port that once differed from the JAX package's,
each pinned against a JAX server on the same requests:

- ``?columnAttrs=true`` and ``Options(..., columnAttrs=true)`` add
  ``"columnAttrs": []`` wherever the reference adds it (the port keeps
  no attributes, and neither server here has any), and
  ``Options(..., excludeRowAttrs=true)`` answers as the reference does;
- a field created with a type string the reference does not know is
  stored and served as the reference serves it: as a set field for
  ``Set``/``Row``/``Count``/``Clear``/``TopN``/``Rows``/``GroupBy``, and
  refused by range rows and aggregates with the reference's errors.

(``import-roaring`` into an int field, the third, is pinned in
tests/test_torch_int_field.py.)  The JAX server runs the configuration
the port implements; the fixture restores exactly the process-wide
fields the servers touch.
"""

from __future__ import annotations

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
         ctype: str = "application/json") -> tuple[int, bytes]:
    req = urllib.request.Request(uri + path, data=body, method="POST")
    req.add_header("Content-Type", ctype)
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
                 coalescer_enabled=False, ingest_delta_enabled=False,
                 cache_enabled=False)
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


def _same(servers, path: str, body: bytes, ctype: str = "text/plain"):
    js, ts = servers
    want = post(js.uri, path, body, ctype)
    got = post(ts.uri, path, body, ctype)
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
