"""Row and column attributes: a port server against a JAX-package server
on the same writes, both at their defaults (delta planes, result cache
and coalescer on), mesh off, on the CPU at the test width.

``SetRowAttrs``/``SetColumnAttrs`` (strings, ints, bools, floats, a null
that deletes, keyed rows and columns) answer the same and leave the same
rows in every ``.row_attrs.db`` and ``.column_attrs.db``.  Then, with
zero tolerance, over three shards, coalesced, with ``?nocoalesce=true``,
``?nocache=1`` and per shard:

- a plain ``Row`` carries its row's attributes, not with
  ``excludeRowAttrs`` (``Options`` or the URL flag), never a range row;
- ``TopN(attrName=, attrValues=)`` keeps the rows whose attribute is one
  of the values, filtered or not, cut by ``n``;
- ``?columnAttrs=true`` and ``Options(columnAttrs=true)`` list the result
  columns' attribute sets, by key in a keyed index;
- an attribute set after a Row or a TopN was cached shows on the next
  read (held against an oracle as well as the reference).

``Row(f=18446744073709551615)`` answers 200 with no columns, as upstream
Pilosa does; the reference answers 500 there (ROADMAP Queue 3 item 7), so
that case is held against an oracle only.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest (rootdir-less test files); another
# installed package is named ``tests``
import torch_wire_pair as wp  # noqa: E402

W = SHARD_WIDTH
FLAGS = ["", "?nocoalesce=true", "?nocache=1", "?shards=1"]


@pytest.fixture(autouse=True)
def _configuration():
    with wp.configuration():
        yield


@pytest.fixture
def pair(tmp_path):
    with wp.servers(str(tmp_path)) as p:
        yield p


def query(pair, pql: str, flags: str = "", index: str = "i",
          status: int = 200) -> dict:
    return json.loads(wp.both(pair, f"/index/{index}/query" + flags,
                              pql.encode(), "text/plain", status=status))


ROW_ATTRS = {
    1: {"color": "red", "size": 3, "ok": True, "w": 1.5},
    2: {"color": "blue", "size": 5},
    3: {"color": "red"},
    4: {"size": 3, "ok": False},
}


def _attr_pql(attrs: dict) -> str:
    out = []
    for k, v in attrs.items():
        if isinstance(v, bool):
            out.append(f"{k}={'true' if v else 'false'}")
        elif isinstance(v, str):
            out.append(f'{k}="{v}"')
        elif v is None:
            out.append(f"{k}=null")
        else:
            out.append(f"{k}={v}")
    return ", ".join(out)


def _load(pair, rng) -> dict:
    """f (rows 1-6) and g over three shards; the row and column
    attributes; returns the columns per row of f."""
    wp.both(pair, "/index/i", b"{}")
    wp.both(pair, "/index/i/field/f", b"{}")
    wp.both(pair, "/index/i/field/g", b"{}")
    wp.both(pair, "/index/i/field/v", json.dumps(
        {"options": {"type": "int", "min": 0, "max": 100}}).encode())
    cols = rng.choice(3 * W, size=3000, replace=False)
    rows = rng.integers(1, 7, size=len(cols))
    wp.both(pair, "/index/i/field/f/import", json.dumps(
        {"rowIDs": [int(r) for r in rows],
         "columnIDs": [int(c) for c in cols]}).encode())
    gc = rng.choice(3 * W, size=2000, replace=False)
    wp.both(pair, "/index/i/field/g/import", json.dumps(
        {"rowIDs": [1] * len(gc), "columnIDs": [int(c) for c in gc]}
    ).encode())
    for r, attrs in ROW_ATTRS.items():
        assert query(pair, f"SetRowAttrs(f, {r}, {_attr_pql(attrs)})") == {
            "results": [None]}
    # a null deletes an attribute; a second call merges
    query(pair, "SetRowAttrs(f, 4, ok=null, extra=\"x\")")
    want = {r: dict(a) for r, a in ROW_ATTRS.items()}
    want[4] = {"size": 3, "extra": "x"}
    for c in cols[:40]:
        query(pair, f"SetColumnAttrs({int(c)}, tag=\"t{int(c) % 3}\", "
                    f"n={int(c) % 7})")
    query(pair, f"SetColumnAttrs({int(cols[0])}, n=null)")
    by_row = {}
    for r, c in zip(rows, cols):
        by_row.setdefault(int(r), set()).add(int(c))
    return {"rows": by_row, "attrs": want, "g": {int(c) for c in gc},
            "cols": [int(c) for c in cols]}


def test_attributes_answer_as_the_reference(pair):
    rng = np.random.default_rng(16)
    d = _load(pair, rng)
    wp.same_stores(pair)
    for flags in FLAGS:
        for r in range(1, 8):
            got = query(pair, f"Row(f={r})", flags)["results"][0]
            if flags != "?shards=1":
                assert got.get("attrs", {}) == d["attrs"].get(r, {})
        for pql in ("Options(Row(f=1), excludeRowAttrs=true)",
                    "Options(Row(f=1), excludeRowAttrs=false)",
                    "Options(Row(f=2), columnAttrs=true)",
                    "Options(Row(f=2), columnAttrs=true, "
                    "excludeColumns=true)",
                    "Union(Row(f=1), Row(f=2))", "Range(f=1)",
                    "Count(Row(f=1))", "Row(v > 10)",
                    'TopN(f, attrName="color", attrValues=["red"])',
                    'TopN(f, attrName="color", attrValues=["red", "blue"], '
                    'n=2)',
                    'TopN(f, Row(g=1), attrName="size", attrValues=[3])',
                    'TopN(f, attrName="ok", attrValues=[true])',
                    'TopN(f, attrName="w", attrValues=[1.5])',
                    'TopN(f, attrName="nope", attrValues=["red"])',
                    'TopN(f, attrName="color", attrValues=[])',
                    'TopN(f, attrName="color", attrValues="red")',
                    "Row(f=1) Row(f=4)"):
            query(pair, pql, flags, status=None)
        for path in ("?columnAttrs=true", "?excludeRowAttrs=true",
                     "?columnAttrs=true&excludeColumns=true"):
            sep = "&" if flags else ""
            query(pair, "Row(f=2) Count(Row(f=3)) Row(f=1)",
                  flags + sep + path.lstrip("?") if flags else path)
    top = query(pair, 'TopN(f, attrName="color", attrValues=["red"])'
                )["results"][0]
    assert top == sorted(
        ({"id": r, "count": len(d["rows"][r])} for r in (1, 3)),
        key=lambda p: (-p["count"], p["id"]))
    got = query(pair, "Options(Row(f=2), columnAttrs=true)")
    assert got["columnAttrs"] == [
        {"attrs": a, "id": c} for c, a in _column_attrs(d, d["rows"][2])]


def _column_attrs(d, cols):
    out = []
    for c in sorted(cols):
        if c not in d["cols"][:40]:
            continue
        a = {"tag": f"t{c % 3}", "n": c % 7}
        if c == d["cols"][0]:
            del a["n"]
        out.append((c, dict(sorted(a.items()))))
    return out


def test_new_attributes_show_past_the_result_cache(pair):
    rng = np.random.default_rng(17)
    d = _load(pair, rng)
    for _ in range(2):  # fill, then hit
        query(pair, "Row(f=5)")
        query(pair, 'TopN(f, attrName="color", attrValues=["green"])')
        query(pair, 'TopN(f, Row(g=1), attrName="color", '
                    'attrValues=["green"])')
    query(pair, 'SetRowAttrs(f, 5, color="green")')
    got = query(pair, "Row(f=5)")["results"][0]
    assert got["attrs"] == {"color": "green"}
    assert got["columns"] == sorted(d["rows"][5])
    top = query(pair, 'TopN(f, attrName="color", attrValues=["green"])'
                )["results"][0]
    assert top == [{"id": 5, "count": len(d["rows"][5])}]
    top = query(pair, 'TopN(f, Row(g=1), attrName="color", '
                      'attrValues=["green"])')["results"][0]
    assert top == [{"id": 5, "count": len(d["rows"][5] & d["g"])}]
    query(pair, 'SetRowAttrs(f, 5, color=null)')
    assert "attrs" not in query(pair, "Row(f=5)")["results"][0]
    assert query(pair, 'TopN(f, attrName="color", attrValues=["green"])'
                 )["results"][0] == []
    wp.same_stores(pair)


def test_keyed_attributes(pair):
    wp.both(pair, "/index/ki", json.dumps({"options": {"keys": True}}
                                          ).encode())
    wp.both(pair, "/index/ki/field/kf", json.dumps(
        {"options": {"keys": True}}).encode())
    for q in ('Set("a", kf="x")', 'Set("b", kf="x")', 'Set("c", kf="y")',
              'SetRowAttrs(kf, "x", color="red")',
              'SetRowAttrs(kf, "new", color="blue")',
              'SetColumnAttrs("a", n=1)', 'SetColumnAttrs("zz", n=2)',
              'Row(kf="x")', 'Options(Row(kf="x"), columnAttrs=true)',
              'TopN(kf, attrName="color", attrValues=["red"])',
              'Row(kf="new")', "Rows(kf)"):
        query(pair, q, index="ki")
    got = query(pair, 'Options(Row(kf="x"), columnAttrs=true)', index="ki")
    assert got == {"results": [{"keys": ["a", "b"],
                                "attrs": {"color": "red"}}],
                   "columnAttrs": [{"attrs": {"n": 1}, "key": "a"}]}
    query(pair, 'Row(kf="x")', "?columnAttrs=true", index="ki")
    wp.same_stores(pair)


@pytest.mark.parametrize("pql", [
    "SetRowAttrs(f, 1)", "SetRowAttrs(nof, 1, x=1)",
    "SetColumnAttrs(1)", 'SetRowAttrs(f, 1, x="y") Row(f=1)',
    "SetColumnAttrs(3, a=1, b=\"c\", d=true, e=-2.5)",
])
def test_attribute_writes_answer_as_the_reference(pair, pql):
    wp.both(pair, "/index/i", b"{}")
    wp.both(pair, "/index/i/field/f", b"{}")
    query(pair, "Set(3, f=1)")
    query(pair, pql, status=None)
    query(pair, "Row(f=1)", "?columnAttrs=true")
    wp.same_stores(pair)


def test_a_row_id_past_int64_has_no_attributes(tmp_path):
    """ROADMAP Queue 3 item 7: the port answers the largest row id with no
    columns, as upstream Pilosa does, where the reference answers 500."""
    from pilosa_tpu_torch.server.server import Server as TServer

    ts = TServer(str(tmp_path / "t"), device="cpu")
    try:
        ts.open()
        for path, body in (("/index/i", b"{}"), ("/index/i/field/f", b"{}")):
            assert wp.req(ts.uri, path, body)[0] == 200
        wp.req(ts.uri, "/index/i/query", b"Set(1, f=1)", "text/plain")
        for pql in ("Row(f=18446744073709551615)",
                    "Row(f=9223372036854775808)"):
            status, body, _ = wp.req(ts.uri, "/index/i/query",
                                     pql.encode(), "text/plain")
            assert (status, json.loads(body)) == (
                200, {"results": [{"columns": []}]})
    finally:
        ts.close()
