"""The port's coalescer, tape routes and bitmap VM, end to end on the
CPU, against the JAX package's: the same seeded rows imported into both,
the same concurrent Count mixes fired at both executors with a coalescer
attached, and then equal answers, equal routes and equal ``vm.*`` /
``tape.*`` counters.

The JAX side runs the configuration the port implements (single device:
mesh off; container kinds off; ingest deltas off; the result cache at
its default, on, as in the port) with
``Coalescer(enabled=True)`` attached, as its own tests/test_vm.py does.
On the CPU the port's ``"auto"`` resolves to off, so the port's
coalescer is forced on too."""

from __future__ import annotations

import json
import random
import threading
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import stats as jstats
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.ops import tape as jtape
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.parallel.coalescer import Coalescer as JCoalescer
from pilosa_tpu.parallel.executor import ExecOptions as JOpts
from pilosa_tpu.parallel.executor import Executor as JExecutor
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
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

N_SHARDS = 4
JOPT = JOpts(mesh=False)

#: 16 structurally distinct trees over <= 3 sparse leaves, all in the
#: (4, 4) size class: one ("vm", 4, 4) bucket (tests/test_vm.py SHAPES_16)
SHAPES_16 = (
    ["{0}(Row(f0=1), Row(f1=2))".format(op)
     for op in ("Intersect", "Union", "Difference", "Xor")]
    + ["{0}(Row(f0=3), Row(f1=4), Row(f2=5))".format(op)
       for op in ("Intersect", "Union", "Difference", "Xor")]
    + ["{0}({1}(Row(f0=0), Row(f2=1)), Row(f1=3))".format(o1, o2)
       for o1, o2 in (("Intersect", "Union"), ("Intersect", "Xor"),
                      ("Union", "Intersect"), ("Union", "Difference"),
                      ("Difference", "Union"), ("Difference", "Xor"),
                      ("Xor", "Intersect"), ("Xor", "Union"))]
)
QS = [f"Count({s})" for s in SHAPES_16]


@pytest.fixture(autouse=True)
def _reference_configuration():
    """The routes these tests pin: kinds off in both packages and the
    port's ingest deltas off, as the JAX holders run them (the reference
    module's default)."""
    mesh_was = meshexec._cfg.enabled
    delta_was = tingest.config().delta_enabled
    tingest.configure(delta_enabled=False)
    meshexec.configure(enabled=False)
    jct.reset()
    jct.configure(kinds=False)
    tct.reset()
    tct.configure(kinds=False)
    jtape.reset_counters()
    ttape.reset_counters()
    yield
    tingest.configure(delta_enabled=delta_was)
    meshexec.configure(enabled=mesh_was)
    jct.reset()
    tct.reset()


def _imports(seed: int):
    """(field, rows, cols) imports: three fields of six sparse rows,
    and row 9 of f0 over the 0.25 container threshold in every shard."""
    rng = random.Random(seed)
    out = []
    for fi in range(3):
        rows, cols = [], []
        for row in range(6):
            for _ in range(200):
                rows.append(row)
                cols.append(rng.randrange(N_SHARDS * SHARD_WIDTH))
        out.append((f"f{fi}", rows, cols))
    nprng = np.random.default_rng(seed)
    hot = np.concatenate([
        s * SHARD_WIDTH + nprng.choice(SHARD_WIDTH, SHARD_WIDTH // 3,
                                       replace=False)
        for s in range(N_SHARDS)])
    out.append(("f0", [9] * len(hot), hot.tolist()))
    return out


@pytest.fixture
def pair(tmp_path):
    """(JAX executor, port executor) over the same data, no coalescer."""
    jh = JHolder(str(tmp_path / "j"))
    th = THolder(str(tmp_path / "t"), device="cpu")
    for h in (jh, th):
        idx = h.create_index("i")
        for fi in range(3):
            idx.create_field(f"f{fi}")
        for fname, rows, cols in _imports(424):
            idx.field(fname).import_bits(np.asarray(rows), np.asarray(cols))
            idx.import_existence(np.asarray(cols))
    jex, tex = JExecutor(jh), TExecutor(th, device="cpu")
    yield jex, tex
    jh.close()
    th.close()


def _attach(jex, tex, **kw):
    kw.setdefault("window_s", 2.0)
    kw.setdefault("max_batch", 16)
    jex.coalescer = JCoalescer(enabled=True, stats=jstats.MemStatsClient(),
                               **kw)
    tex.coalescer = tco.Coalescer(enabled=True, **kw)


def _fire(ex, queries, opt):
    """Barrier-fire the queries from one thread each; (answers, the
    launches each thread logged)."""
    bar = threading.Barrier(len(queries))
    out = [None] * len(queries)
    kinds: list = [[] for _ in queries]
    errs: list = []
    dc_cls = tbm.dispatch_counter if isinstance(opt, TOpts) else None
    if dc_cls is None:
        from pilosa_tpu.ops import bitmap as jbm
        dc_cls = jbm.dispatch_counter

    def run(i):
        try:
            bar.wait()
            with dc_cls() as dc:
                out[i] = int(ex.execute("i", queries[i], opt=opt)[0])
            kinds[i] = dc.launches
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in
          range(len(queries))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)
    return out, [k for ks in kinds for k in ks]


def _per_shard(tex, q):
    """Ground truth on the port's per-shard path: one shard at a time."""
    return sum(int(tex.execute("i", q, opt=TOpts(shards=[s],
                                                 coalesce=False))[0])
               for s in range(N_SHARDS))


def test_sixteen_distinct_shapes_run_as_one_vm_launch(pair):
    jex, tex = pair
    truth = [_per_shard(tex, q) for q in QS]
    _attach(jex, tex)
    jgot, jl = _fire(jex, QS, JOPT)
    before = ck.vm_counts.launches
    tgot, tl = _fire(tex, QS, TOpts())
    assert tgot == jgot == truth
    assert tl == jl == ["vm"]
    c = ttape.counters()
    assert (c["vm.executions"], c["vm.queries"], c["vm.fallbacks"]) == \
        (1, 16, 0)
    assert {k: v for k, v in c.items() if k.startswith(("vm.", "tape."))} \
        == {k: v for k, v in jtape.counters().items()
            if k.startswith(("vm.", "tape."))}
    assert ck.vm_counts.launches == before  # CPU pools: the plain version
    assert ttape.debug()["vm"]["programs"] == \
        jtape.debug()["vm"]["programs"]


def test_a_dense_leaf_takes_the_tape_route(pair):
    """Row 9 is over the container threshold: the VM declines every
    query that reads it (``ineligible_leaf``), and the mixed bucket of
    those queries runs the dense tape interpreter."""
    jex, tex = pair
    qs = ["Count(Intersect(Row(f0=9), Row(f1=2)))",
          "Count(Union(Row(f0=9), Row(f2=1)))",
          "Count(Difference(Row(f0=9), Row(f1=4), Row(f2=5)))",
          "Count(Xor(Row(f1=1), Row(f0=9)))"]
    truth = [_per_shard(tex, q) for q in qs]
    _attach(jex, tex, max_batch=4)
    jgot, jl = _fire(jex, qs, JOPT)
    tgot, tl = _fire(tex, qs, TOpts())
    assert tgot == jgot == truth
    assert tl == jl == ["tape"]
    c = ttape.counters()
    assert c["vm.fallbacks.ineligible_leaf"] == 4
    assert (c["tape.executions"], c["vm.executions"]) == (1, 0)
    assert c == jtape.counters()


def test_one_shape_runs_the_same_shape_route(pair):
    jex, tex = pair
    qs = [f"Count(Intersect(Row(f0={r}), Row(f0=9)))" for r in range(4)]
    truth = [_per_shard(tex, q) for q in qs]
    _attach(jex, tex, max_batch=4)
    jgot, jl = _fire(jex, qs, JOPT)
    tgot, tl = _fire(tex, qs, TOpts())
    assert tgot == jgot == truth
    assert tl == jl == ["fused_expr"]
    assert ttape.counters() == jtape.counters()


def test_a_lone_query_passes_through(pair):
    jex, tex = pair
    q = "Count(Union(Row(f0=9), Row(f1=1)))"
    _attach(jex, tex, window_s=0.001)
    with tbm.dispatch_counter() as dc:
        got = int(tex.execute("i", q)[0])
    assert dc.launches == ["fused_expr"]
    assert got == int(jex.execute("i", q, opt=JOPT)[0]) == _per_shard(tex, q)


def test_novm_and_nocontainers_take_the_dense_engines(pair):
    jex, tex = pair
    _attach(jex, tex, max_batch=6)
    qs = QS[:6]
    truth = [_per_shard(tex, q) for q in qs]
    # the second round repeats the first's queries: both skip the
    # result cache, whose hits would take no route at all
    for opt, jopt in ((TOpts(vm=False, cache=False),
                       JOpts(mesh=False, vm=False, cache=False)),
                      (TOpts(containers=False, cache=False),
                       JOpts(mesh=False, containers=False, cache=False))):
        ttape.reset_counters()
        jtape.reset_counters()
        jgot, jl = _fire(jex, qs, jopt)
        tgot, tl = _fire(tex, qs, opt)
        assert tgot == jgot == truth
        assert "vm" not in tl and tl == jl == ["tape"]
        assert ttape.counters()["vm.executions"] == 0


def test_ragged_off_keys_buckets_on_the_exact_shape(pair):
    jex, tex = pair
    qs = QS[:4]
    truth = [_per_shard(tex, q) for q in qs]
    _attach(jex, tex, window_s=0.2, max_batch=4, ragged=False)
    tgot, tl = _fire(tex, qs, TOpts())
    jgot, jl = _fire(jex, qs, JOPT)
    assert tgot == jgot == truth
    assert sorted(tl) == sorted(jl) == ["fused_expr"] * 4
    assert ttape.counters()["vm.executions"] == 0


def test_the_prefetch_budget_splits_the_batch(pair):
    jex, tex = pair
    qs = QS[:8]
    truth = [_per_shard(tex, q) for q in qs]
    # 4 slots x 8 queries x 8 domain slots > 128: one split, two launches
    _attach(jex, tex, max_batch=8, vm_max_prefetch=128)
    jgot, jl = _fire(jex, qs, JOPT)
    tgot, tl = _fire(tex, qs, TOpts())
    assert tgot == jgot == truth
    assert tl == jl == ["vm", "vm"]


def test_the_empty_domain_rides_the_batch(pair):
    jex, tex = pair
    for ex in (jex, tex):
        f = ex.holder.index("i").create_field("lone")
        f.import_bits(np.asarray([1]), np.asarray([3]))
        f.import_bits(np.asarray([2]), np.asarray([SHARD_WIDTH + 5]))
    _attach(jex, tex, window_s=0.01)
    q = "Count(Intersect(Row(lone=1), Row(lone=2)))"
    empty0 = tct.counters()["container.empty_domains"]
    with tbm.dispatch_counter() as dc:
        got = int(tex.execute("i", q)[0])
    assert got == int(jex.execute("i", q, opt=JOPT)[0]) == 0
    assert dc.launches == ["vm"]
    assert tct.counters()["container.empty_domains"] == empty0 + 1


def test_a_failed_flush_fails_every_waiter(pair, monkeypatch):
    _jex, tex = pair
    tex.coalescer = tco.Coalescer(enabled=True, window_s=2.0, max_batch=4)

    def broken(*_a, **_k):
        raise RuntimeError("injected")

    monkeypatch.setattr(tct, "megapool", broken)
    bar = threading.Barrier(4)
    errs: list = []

    def run(q):
        bar.wait()
        try:
            tex.execute("i", q)
        except RuntimeError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=run, args=(q,)) for q in QS[:4]]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert errs == ["injected"] * 4


def test_resolve_enabled():
    assert tco.resolve_enabled("auto", "cpu") is False
    assert tco.resolve_enabled("auto", "cuda") is True
    assert tco.resolve_enabled("auto", None) is False
    assert tco.resolve_enabled(" TRUE ", "cpu") is True
    assert tco.resolve_enabled(False, "cuda") is False
    for bad in ("ture", "", "maybe"):
        with pytest.raises(ValueError):
            tco.resolve_enabled(bad, "cpu")
    with pytest.raises(ValueError):
        TServer("unused", device="cpu", coalescer_enabled="ture")
    srv = TServer("unused", device="cpu")
    try:
        assert srv.coalescer.enabled is False  # "auto" on the CPU
    finally:
        srv.close()  # gives back the compactor reference it took


def _get(uri: str) -> dict:
    with urllib.request.urlopen(uri + "/debug/ragged", timeout=30) as r:
        return json.loads(r.read())


def _post(uri: str, path: str, body: bytes) -> bytes:
    req = urllib.request.Request(uri + path, data=body, method="POST")
    req.add_header("Content-Type", "text/plain")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def test_http_escapes_and_debug_ragged(tmp_path):
    js = JServer(str(tmp_path / "j"), mesh_enabled=False,
                 coalescer_enabled=True, ragged_prewarm=False,
                 containers_kinds=False, ingest_delta_enabled=False)
    ts = TServer(str(tmp_path / "t"), device="cpu", coalescer_enabled=True,
                 vm_min_domain=16, vm_max_prefetch=1 << 14,
                 ingest_delta_enabled=False)
    js.open()
    ts.open()
    try:
        jd, td = _get(js.uri), _get(ts.uri)
        assert set(td) == set(jd)
        assert set(td["coalescer"]) == set(jd["coalescer"])
        assert set(td["counters"]) == set(jd["counters"])
        assert set(td["vm"]) == set(jd["vm"])
        assert td["coalescer"]["enabled"] is True
        assert (td["coalescer"]["vmMinDomain"],
                td["coalescer"]["vmMaxPrefetch"]) == (16, 1 << 14)
        assert td["coalescer"]["windowMs"] == jd["coalescer"]["windowMs"]

        for s in (js, ts):
            s.api.create_index("i")
            s.api.create_field("i", "f")
            s.api.import_bits("i", "f", [1, 1, 2, 2], [3, 70, 70,
                                                       SHARD_WIDTH + 9])
        ttape.reset_counters()
        q = b"Count(Intersect(Row(f=1), Row(f=2)))"
        on = _post(ts.uri, "/index/i/query", q)
        assert ttape.counters()["vm.executions"] == 1
        for flags in ("?novm=1", "?nocontainers=1", "?nocoalesce=true"):
            assert _post(ts.uri, "/index/i/query" + flags, q) == on
        assert ttape.counters()["vm.executions"] == 1
        assert on == _post(js.uri, "/index/i/query?nocache=1", q)
        assert _get(ts.uri)["vm"]["programs"] == [
            {"batch": 1, "tapeLen": 4, "slots": 4, "domain": 16}]
    finally:
        js.close()
        ts.close()
