"""Rows and GroupBy of the port against the JAX package's, on the CPU.

The seeded data of tests/test_torch_topn.py goes into a JAX-package
server and a port server (``device="cpu"``); every Rows (``limit``,
``previous``, ``column``) and GroupBy (``filter``, ``limit``,
``offset``, a child's ``limit``/``previous``/``column``, two and three
levels) must answer with byte-identical JSON, over all shards and over
one or two (``?shards=``).  The GroupBy counts also agree with a
Python-set oracle built from tests/naive.py, and the levels that have
group masks are the ``masked_matrix_counts`` calls that launch K5 on a
card.
"""

from __future__ import annotations

import itertools
import json

import pytest

from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from tests.naive import NaiveBitmap
from tests.test_torch_topn import (NBITS, dataset, import_dataset, jax_server,
                                   post)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    data = dataset(91)
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


def _column(data) -> int:
    """A column of shard 2 that s rows 9 and 10 hold, and u row 1."""
    return min(c for c in data["s"][10] & data["s"][9] & data["u"][1]
               if c // SHARD_WIDTH == 2)


ROWS_QUERIES = [
    "Rows(s)",
    "Rows(s, limit=3)",
    "Rows(s, previous=4)",
    "Rows(s, limit=2, previous=4)",
    "Rows(s, previous=11)",
    "Rows(field=u, limit=4)",
    "Rows(s, column={col})",
    "Rows(s, column={col}, limit=1)",
    "Rows(s, column=5)",
    "Rows(u) Rows(f, previous=1)",
    "Rows(nope)",
    "Rows()",
]

GROUPBY_QUERIES = [
    "GroupBy(Rows(s))",
    "GroupBy(Rows(s), Rows(u))",
    "GroupBy(Rows(s), Rows(u), limit=5)",
    "GroupBy(Rows(s), Rows(u), offset=7, limit=5)",
    "GroupBy(Rows(s), Rows(u), offset=100000)",
    "GroupBy(Rows(s), Rows(u), filter=Row(f=1))",
    "GroupBy(Rows(f), Rows(s), filter=Row(f=1))",
    "GroupBy(Rows(s), filter=Intersect(Row(f=1), Row(f=2)), limit=4)",
    "GroupBy(Rows(s), Rows(u), Rows(f), limit=40)",
    "GroupBy(Rows(u), Rows(s), Rows(f), filter=Row(f=2), offset=3)",
    "GroupBy(Rows(s, limit=3), Rows(u))",
    "GroupBy(Rows(s), Rows(u, previous=2, limit=2))",
    "GroupBy(Rows(s, column={col}), Rows(u))",
    "GroupBy(Rows(s), Rows(u), filter=Row(f=9))",
    "GroupBy(Rows(s, previous=20), Rows(u))",
    "GroupBy()",
    "GroupBy(Row(f=1))",
    "GroupBy(Rows(nope))",
]


@pytest.mark.parametrize("path", ["/index/i/query", "/index/i/query?shards=2",
                                  "/index/i/query?shards=0,3"])
@pytest.mark.parametrize("kind", ["rows", "groupby"])
def test_answers_byte_identical_json(servers, kind, path):
    js, ts, data = servers
    col = _column(data)
    queries = ROWS_QUERIES if kind == "rows" else GROUPBY_QUERIES
    for q in queries:
        q = q.format(col=col)
        want = post(js.uri, path, q.encode(), "text/plain")
        got = post(ts.uri, path, q.encode(), "text/plain")
        assert got[0] == want[0], (path, q, got, want)
        if want[0] == 200:
            assert got[1] == want[1], (path, q)


def _groups(ts, q: str) -> dict[tuple, int]:
    st, body = post(ts.uri, "/index/i/query", q.encode(), "text/plain")
    assert st == 200, body
    return {tuple((g["field"], g["rowID"]) for g in gc["group"]): gc["count"]
            for gc in json.loads(body)["results"][0]}


def test_groupby_counts_agree_with_the_naive_oracle(servers):
    _js, ts, data = servers
    nb = {f: {r: NaiveBitmap(cs, NBITS) for r, cs in rows.items()}
          for f, rows in data.items()}

    def oracle(fields, filt=None):
        out = {}
        for combo in itertools.product(*(sorted(nb[f].items())
                                         for f in fields)):
            acc = filt
            for _r, b in combo:
                acc = b if acc is None else acc.intersect(b)
            if acc.count():
                out[tuple((f, r) for f, (r, _b) in zip(fields, combo))] = \
                    acc.count()
        return out

    assert _groups(ts, "GroupBy(Rows(s), Rows(u))") == oracle(["s", "u"])
    assert _groups(ts, "GroupBy(Rows(f), Rows(s), filter=Row(f=1))") == \
        oracle(["f", "s"], nb["f"][1])
    got = _groups(ts, "GroupBy(Rows(s), Rows(u), Rows(f))")
    assert got == oracle(["s", "u", "f"])


def test_rows_agree_with_the_naive_oracle(servers):
    _js, ts, data = servers
    col = _column(data)

    def rows(q):
        st, body = post(ts.uri, "/index/i/query", q.encode(), "text/plain")
        assert st == 200, body
        return json.loads(body)["results"][0]

    assert rows("Rows(s)") == sorted(data["s"])
    assert rows("Rows(s, limit=2, previous=4)") == [5, 6]
    assert rows(f"Rows(s, column={col})") == sorted(
        r for r, cs in data["s"].items() if col in cs)


def test_groupby_launch_sites_on_a_cpu_server(servers):
    """A level with group masks is one ``masked_matrix_counts`` per
    shard (K5 on a card); the unfiltered first level is a plain row
    count.  A CPU server launches no kernel.  The queries skip the
    result cache (``?nocache=1``), whose hit would launch nothing."""
    _js, ts, _data = servers
    n_shards = len(ts.holder.index("i").available_shards())
    before = ck.launch_counts()
    with tbm.dispatch_counter() as dc:
        ts.api.query("i", "GroupBy(Rows(s), Rows(u))", cache=False)
    assert dc.launches.count("masked_matrix_counts") == n_shards
    assert dc.launches.count("row_counts") == n_shards
    with tbm.dispatch_counter() as dc:
        ts.api.query("i", "GroupBy(Rows(f), Rows(s), filter=Row(f=1))",
                     cache=False)
    assert dc.launches.count("masked_matrix_counts") == 2 * n_shards
    assert "row_counts" not in dc.launches
    assert ck.launch_counts() == before
