"""A JAX-package server and a port server side by side, for the wire
tests of string keys, attributes and protobuf bodies
(tests/test_torch_keys.py, tests/test_torch_attrs.py,
tests/test_torch_proto.py).

Both run at their defaults (delta planes, result cache, coalescer and
residency tiers on), mesh off, on the CPU at the test width, each
compactor at a 3600 s interval.  ``configuration()`` snapshots exactly
the process-wide fields the servers touch and restores them; it calls no
``reset()`` of a reference module.  It gives the test a fresh port
residency manager (the reference's conftest resets only the
reference's), puts the old one back after, and drains both packages'
background prewarm.  ``both`` sends one request to each server and
requires the same status, content type and bytes."""

from __future__ import annotations

import contextlib
import os
import sqlite3
import urllib.error
import urllib.request

from pilosa_tpu import ingest as jingest
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.runtime import prewarm as jprewarm
from pilosa_tpu.runtime import resultcache as jrc
from pilosa_tpu.serve import tenant as jtenant
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.runtime import prewarm as tprewarm
from pilosa_tpu_torch.runtime import residency as tres
from pilosa_tpu_torch.runtime import resultcache as trc
from pilosa_tpu_torch.serve import tenant as ttenant
from pilosa_tpu_torch.server.server import Server as TServer

PB = "application/x-protobuf"
_INGEST = ("delta_enabled", "delta_budget_bytes", "compact_threshold_bits",
           "compact_interval")
_CACHE = ("enabled", "budget", "max_entry_bytes", "ttl_s")
#: the environment both packages' residency and prewarm read
_ENV = ("PILOSA_TPU_PREWARM", "PILOSA_TPU_DEVICE_BUDGET_BYTES")


@contextlib.contextmanager
def residency_state(budget_bytes: int | None = None):
    """A fresh port residency manager (``budget_bytes``, or the default)
    for the block; the port's [residency] config, its baseline and
    reference count, the manager in force and the environment both
    packages read are put back after, and both packages' prewarm queues
    are drained first.  The promotion workers the block started stop."""
    env = {k: os.environ.get(k) for k in _ENV}
    cfg = {k: getattr(tres.config(), k)
           for k in tres.TierRuntimeConfig.__slots__}
    base, refs, was = tres._baseline, tres._refs, tres._global
    tres._global = tres.ResidencyManager(budget_bytes)
    try:
        yield tres._global
    finally:
        assert tprewarm.drain(timeout=30), "port prewarm did not drain"
        assert jprewarm.drain(timeout=30), "reference prewarm did not drain"
        tres.promoter().stop()
        tres._global.close()
        tres._global = was
        for k, v in cfg.items():
            setattr(tres.config(), k, v)
        tres._baseline, tres._refs = base, refs
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tenant_configs() -> list:
    """Both packages' [tenants] configs, field by field (copies)."""
    return [{"enabled": c.enabled, "default_quota": c.default_quota,
             "quotas": dict(c.quotas), "seen": set(c.seen)}
            for c in (jtenant.config(), ttenant.config())]


def restore_tenant_configs(was: list) -> None:
    for m, fields in zip((jtenant, ttenant), was):
        for k, v in fields.items():
            setattr(m.config(), k, v)


@contextlib.contextmanager
def configuration():
    """Mesh off; restores both [ingest] configs and baselines, both
    [containers] configs, both result caches' knobs, both [tenants]
    configs, the port's residency state (``residency_state``) and the
    mesh config, and checks that both compactors' retain counts are
    back."""
    mesh_was = (meshexec._cfg.enabled, meshexec._cfg.axis_size)
    ing = [{k: getattr(m.config(), k) for k in _INGEST}
           for m in (jingest, tingest)]
    bases = (jingest._baseline, tingest._baseline)
    cts = [{k: getattr(m.config(), k) for k in type(m.config()).__slots__}
           for m in (jct, tct)]
    rcs = [{k: getattr(m.cache(), k) for k in _CACHE} for m in (jrc, trc)]
    tenants = tenant_configs()
    refs = (jcompactor.refs(), tcompactor.refs())
    meshexec.configure(enabled=False)
    try:
        with residency_state():
            yield
    finally:
        assert (jcompactor.refs(), tcompactor.refs()) == refs
        restore_tenant_configs(tenants)
        for m, was in zip((jrc, trc), rcs):
            for k, v in was.items():
                setattr(m.cache(), k, v)
        for m, was in zip((jct, tct), cts):
            m.configure(**was)
        for m, was in zip((jingest, tingest), ing):
            m.configure(**was)
        jingest._baseline, tingest._baseline = bases
        meshexec.configure(enabled=mesh_was[0], axis_size=mesh_was[1])


@contextlib.contextmanager
def servers(root: str, **kw):
    """(JAX server, port server) under ``root``, closed on exit; ``kw``
    are knobs both servers take (``admission_*``, ``tenants_*``)."""
    js = JServer(os.path.join(root, "j"), mesh_enabled=False,
                 coalescer_enabled=True, ragged_prewarm=False,
                 ingest_compact_interval=3600.0, **kw)
    ts = TServer(os.path.join(root, "t"), device="cpu",
                 coalescer_enabled=True, ingest_compact_interval=3600.0,
                 **kw)
    try:
        js.open()
        ts.open()
        yield js, ts
    finally:
        js.close()
        ts.close()


def req(uri: str, path: str, body: bytes | None = None,
        ctype: str = "application/json", accept: str | None = None
        ) -> tuple[int, bytes, str]:
    r = urllib.request.Request(uri + path, data=body,
                               method="GET" if body is None else "POST")
    if body is not None:
        r.add_header("Content-Type", ctype)
    if accept is not None:
        r.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]


def both(pair, path: str, body: bytes | None = None,
         ctype: str = "application/json", accept: str | None = None,
         status: int | None = 200) -> bytes:
    """The same request to both servers: the same status, content type
    and bytes; ``status`` None accepts any status."""
    want = req(pair[0].uri, path, body, ctype, accept)
    got = req(pair[1].uri, path, body, ctype, accept)
    assert got == want, (path, body, got[0], got[1][:300], want[0],
                         want[1][:300])
    if status is not None:
        assert want[0] == status, want
    return want[1]


def sqlite_rows(path: str, table: str) -> list:
    """Every row of a table of a sqlite file, in rowid order."""
    con = sqlite3.connect(path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY rowid"
                           ).fetchall()
    finally:
        con.close()


def stores(root: str) -> dict:
    """Relative path -> rows of every translate store (``.keys.db``) and
    attribute store (``.row_attrs.db``, ``.column_attrs.db``) under
    ``root``."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            if n == ".keys.db":
                out[os.path.relpath(p, root)] = sqlite_rows(p, "keys")
            elif n in (".row_attrs.db", ".column_attrs.db"):
                out[os.path.relpath(p, root)] = sqlite_rows(p, "attrs")
    return out


def same_stores(pair) -> dict:
    """Both servers hold the same translate and attribute stores, row for
    row."""
    js, ts = pair
    want, got = stores(js.data_dir), stores(ts.data_dir)
    assert got == want
    return want


def files(root: str, ext: str) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            if n.endswith(ext):
                with open(os.path.join(d, n), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, n), root)] = fh.read()
    return out


def same_files(pair, ext: str) -> dict:
    jf, tf = (files(s.data_dir, ext) for s in pair)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        assert tf[k] == jf[k], k
    return jf
