"""The schema and admin HTTP routes: a port server against a JAX-package
server, both at their defaults (delta planes, result cache and coalescer
on), mesh off, on the CPU at the test width.

Every route answers the reference's status and bytes: ``GET /``,
``/version``, ``/index``, ``/schema`` (all five field types), ``POST
/schema``, ``GET``/``DELETE /index/{i}``, ``DELETE
/index/{i}/field/{f}``, ``GET /export`` (CSV of set, mutex and bool
fields), ``POST /recalculate-caches`` and their 4xx answers; ``/info``
the same but for ``cpuType``, which names the serving device;
``/hosts`` and ``/status`` the one local node, each server its own id and
address; ``/debug/containers`` the same configuration and keys.

A field or index deleted after queries warmed every cache the port keys
by (row stacks, container leaves and pools, the VM's megapool memo, the
TopN matrix, the result cache), then recreated under the same name with
different bits, answers the new bits on every route, and its files are
gone.  The fixture restores exactly the process-wide fields the servers
touch.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import ingest as jingest
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.runtime import resultcache as jrc
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.runtime import resultcache as trc
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

W = SHARD_WIDTH
_INGEST = ("delta_enabled", "delta_budget_bytes", "compact_threshold_bits",
           "compact_interval")
_CACHE = ("enabled", "budget", "max_entry_bytes", "ttl_s")

SCHEMA = {"indexes": [{"name": "i", "options": {}, "fields": [
    {"name": "f", "options": {}},
    {"name": "v", "options": {"type": "int", "min": -10, "max": 1000}},
    {"name": "t", "options": {"type": "time", "timeQuantum": "YMD"}},
    {"name": "m", "options": {"type": "mutex"}},
    {"name": "b", "options": {"type": "bool"}},
]}]}


@pytest.fixture(autouse=True)
def _configuration():
    """Mesh off and both [containers] configs at their defaults (a JAX
    server leaves the configuration it finds, which an earlier test in
    the process may have changed, and ``/debug/containers`` shows it);
    restores both [ingest] configs and baselines, both [containers]
    configs, both result caches' knobs and the mesh config, and checks
    that both compactors' retain counts are back."""
    mesh_was = (meshexec._cfg.enabled, meshexec._cfg.axis_size)
    ing = [{k: getattr(m.config(), k) for k in _INGEST}
           for m in (jingest, tingest)]
    bases = (jingest._baseline, tingest._baseline)
    cts = [{k: getattr(m.config(), k) for k in type(m.config()).__slots__}
           for m in (jct, tct)]
    rcs = [{k: getattr(m.cache(), k) for k in _CACHE} for m in (jrc, trc)]
    refs = (jcompactor.refs(), tcompactor.refs())
    meshexec.configure(enabled=False)
    for m in (jct, tct):
        m.configure(enabled=True, threshold=m.DEFAULT_THRESHOLD, kinds=True,
                    array_max=m.DEFAULT_ARRAY_MAX, run_cap=m.DEFAULT_RUN_CAP)
    try:
        yield
    finally:
        assert (jcompactor.refs(), tcompactor.refs()) == refs
        for m, was in zip((jrc, trc), rcs):
            for k, v in was.items():
                setattr(m.cache(), k, v)
        for m, was in zip((jct, tct), cts):
            m.configure(**was)
        for m, was in zip((jingest, tingest), ing):
            m.configure(**was)
        jingest._baseline, tingest._baseline = bases
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])


@pytest.fixture
def pair(tmp_path):
    js = JServer(str(tmp_path / "j"), mesh_enabled=False,
                 coalescer_enabled=True, ragged_prewarm=False,
                 ingest_compact_interval=3600.0)
    ts = TServer(str(tmp_path / "t"), device="cpu", coalescer_enabled=True,
                 ingest_compact_interval=3600.0)
    try:
        js.open()
        ts.open()
        yield js, ts
    finally:
        js.close()
        ts.close()


def _req(uri: str, path: str, body: bytes | None = None,
         method: str | None = None, ctype: str = "application/json"
         ) -> tuple[int, bytes, str]:
    method = method or ("GET" if body is None else "POST")
    req = urllib.request.Request(uri + path, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]


def both(pair, path: str, body: bytes | None = None,
         method: str | None = None, status: int = 200,
         ctype: str = "application/json") -> bytes:
    """The same request to both servers: the same status, content type
    and bytes."""
    want = _req(pair[0].uri, path, body, method, ctype)
    got = _req(pair[1].uri, path, body, method, ctype)
    assert got == want, (method, path, body, got, want)
    assert want[0] == status, want
    return want[1]


def query(pair, pql: str, flags: str = "") -> list:
    return json.loads(both(pair, "/index/i/query" + flags, pql.encode(),
                           ctype="text/plain"))["results"]


def _load(pair, rng) -> dict:
    """f, m and b over three shards; returns the expected columns."""
    both(pair, "/schema", json.dumps(SCHEMA).encode())
    cols = rng.choice(3 * W, size=500, replace=False)
    want = {}
    f_cols = [int(c) for c in cols[:300]]
    both(pair, "/index/i/field/f/import", json.dumps(
        {"rowIDs": [1] * 150 + [2] * 150, "columnIDs": f_cols}).encode())
    want["f1"] = set(f_cols[:150])
    m_rows = [int(r) for r in rng.integers(0, 4, size=200)]
    both(pair, "/index/i/field/m/import", json.dumps(
        {"rowIDs": m_rows, "columnIDs": [int(c) for c in cols[300:]]}
    ).encode())
    query(pair, " ".join(f"Set({int(c)}, b={'true' if i % 3 else 'false'})"
                         for i, c in enumerate(cols[100:250])))
    query(pair, f"Set({int(cols[5])}, v=7) "
                f"Set({int(cols[6])}, t=1, 2024-01-30T10:00)")
    return want


def test_read_only_routes_answer_as_the_reference(pair):
    for path in ("/", "/version", "/index", "/schema"):
        both(pair, path)
    _load(pair, np.random.default_rng(7))
    for path in ("/index", "/schema", "/index/i"):
        both(pair, path)
    doc = json.loads(both(pair, "/schema"))
    assert [f["name"] for f in doc["indexes"][0]["fields"]] == [
        "b", "f", "m", "t", "v"]
    # an idempotent merge: nothing changes
    both(pair, "/schema", json.dumps(SCHEMA).encode())
    both(pair, "/schema")
    # /info: the same document, cpuType naming each server's device
    j, t = (json.loads(_req(s.uri, "/info")[1]) for s in pair)
    assert t.pop("cpuType") == "cpu+host"
    j.pop("cpuType")
    assert t == j
    # /hosts and /status: the one local node
    for srv in pair:
        node = {"id": srv.holder.node_id, "uri": srv.uri,
                "isCoordinator": True, "state": "READY"}
        assert json.loads(_req(srv.uri, "/hosts")[1]) == [node]
        assert json.loads(_req(srv.uri, "/status")[1]) == {
            "state": "NORMAL", "nodes": [node],
            "localID": srv.holder.node_id}
    # /debug/containers: the configuration and the counter keys
    j, t = (json.loads(_req(s.uri, "/debug/containers")[1]) for s in pair)
    assert sorted(t.pop("counters")) == sorted(j.pop("counters"))
    assert t == j
    # the 4xx answers
    for path, body, method, status in (
            ("/index/nope", None, None, 404),
            ("/index/nope", None, "DELETE", 404),
            ("/index/i/field/nope", None, "DELETE", 404),
            ("/index/nope/field/f", None, "DELETE", 404),
            ("/export?index=nope&field=f", None, None, 404),
            ("/export?index=i&field=nope", None, None, 404),
            ("/export?field=f", None, None, 400),
            ("/export?index=i&field=f&shard=x", None, None, 400),
            ("/schema", b"{bad", None, 400),
            ("/nope", None, None, 404)):
        both(pair, path, body, method, status)


@pytest.mark.parametrize("field", ["f", "m", "b", "t"])
def test_export_and_recalculate_caches_answer_as_the_reference(pair, field):
    _load(pair, np.random.default_rng(11))
    for shard in (0, 1, 2, 9):
        csv = both(pair, f"/export?index=i&field={field}&shard={shard}")
        lines = csv.decode().splitlines()
        assert lines == sorted(lines, key=lambda ln: tuple(
            int(x) for x in ln.split(",")))
    both(pair, f"/export?index=i&field={field}")
    assert both(pair, "/recalculate-caches", b"") == b"{}"
    query(pair, f"TopN({field})")
    query(pair, f"TopN({field}, n=2)", "?shards=1")


def _warm(pair) -> None:
    """Reads that build every cached form of f's rows on the port."""
    for flags in ("", "?nocoalesce=true", "?nocontainers=1", "?shards=1"):
        query(pair, "Count(Intersect(Row(f=1), Row(f=2)))", flags)
        query(pair, "Count(Union(Row(f=1), Row(m=1)))", flags)
    query(pair, "Row(f=1)")
    query(pair, "TopN(f, Row(f=1), n=2)")
    query(pair, "GroupBy(Rows(f), Rows(m))")


def test_delete_and_recreate_serves_the_new_bits(pair):
    rng = np.random.default_rng(3)
    want = _load(pair, rng)
    _warm(pair)
    assert query(pair, "Count(Row(f=1))") == [len(want["f1"])]
    tsrv = pair[1]
    old = tsrv.holder.index("i").field("f")
    uids = {v[1].uid for v in old._device_cache.values()
            if isinstance(v[1], tct.ContainerLeaf)}
    assert uids
    fdirs = [os.path.join(s.data_dir, "i", "f") for s in pair]
    assert all(os.path.isdir(d) for d in fdirs)

    assert both(pair, "/index/i/field/f", method="DELETE") == b"{}"
    assert not any(os.path.exists(d) for d in fdirs)
    both(pair, "/index/i/field/f", method="DELETE", status=404)
    assert not old._device_cache and not old._matrix_stack_cache
    for key in list(tct._stage_memo) + list(tct._megapool_memo):
        assert not uids.intersection(
            key[2] if key[0] == "vm" else key[1]
            if isinstance(key[1], tuple) else key)
    assert not [k for k in trc.cache()._entries
                if k.k[:2] == (tsrv.holder.uid, "i")]
    both(pair, "/schema")
    query_status = _req(tsrv.uri, "/index/i/query", b"Count(Row(f=1))",
                        ctype="text/plain")[0]
    assert query_status == 400

    # recreated under the same name: fresh fragments at generation 0,
    # different bits
    both(pair, "/index/i/field/f", b"{}")
    new = [int(c) for c in rng.choice(3 * W, size=120, replace=False)]
    both(pair, "/index/i/field/f/import", json.dumps(
        {"rowIDs": [1] * 60 + [2] * 60, "columnIDs": new}).encode())
    _warm(pair)
    assert query(pair, "Count(Row(f=1))") == [60]
    assert query(pair, "Count(Intersect(Row(f=1), Row(f=2)))") == [0]
    assert query(pair, "Row(f=1)")[0]["columns"] == sorted(new[:60])
    assert query(pair, "Count(Row(f=2))", "?nocoalesce=true") == [60]
    both(pair, "/export?index=i&field=f&shard=1")

    # the whole index: deleted, its directory gone, recreated empty
    assert both(pair, "/index/i", method="DELETE") == b"{}"
    assert not any(os.path.exists(os.path.join(s.data_dir, "i"))
                   for s in pair)
    assert json.loads(both(pair, "/schema")) == {"indexes": []}
    both(pair, "/index/i", b"{}")
    both(pair, "/index/i/field/f", b"{}")
    query(pair, "Set(5, f=1)")
    assert query(pair, "Count(Row(f=1))") == [1]
    assert query(pair, "TopN(f)") == [[{"id": 1, "count": 1}]]
    both(pair, "/schema")


def test_port_refuses_a_schema_with_keys_before_creating_anything(pair):
    """A schema with keys, once refused by the port, is created as the
    reference creates it: the same answer, then the same reads."""
    body = json.dumps({"indexes": [
        {"name": "a", "options": {}, "fields": []},
        {"name": "k", "options": {"keys": True}, "fields": []}]}).encode()
    assert both(pair, "/schema", body) == b"{}"
    got = json.loads(both(pair, "/schema"))
    assert [(ix["name"], ix["options"]["keys"]) for ix in got["indexes"]] \
        == [("a", False), ("k", True)]
    both(pair, "/index/k")
    both(pair, "/index/k/field/kf", b'{"options": {"keys": true}}')
    both(pair, "/index/k/query", b'Set("c1", kf="r1")', ctype="text/plain")
    assert json.loads(both(pair, "/index/k/query", b'Row(kf="r1")',
                           ctype="text/plain")) == {
        "results": [{"keys": ["c1"]}]}
    both(pair, "/schema")
