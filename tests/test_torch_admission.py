"""Admission control and request deadlines: the port's serve/ package,
executor, coalescer, compactor and handler against the JAX package's, on
the CPU, mesh off.

- ``Deadline``/``parse_header``/the scopes/``check`` on valid, malformed,
  zero, negative and clamped values, with the same outcomes and messages;
- ``AdmissionController`` driven through the same scripted acquires and
  releases as a reference controller with the same caps
  (tests/torch_admission_script.py): the same admissions in the same
  order, the same ``ShedError``s (status, reason, Retry-After, message)
  and equal ``debug()`` documents, their timing fields reduced to
  whether they are positive;
- the executors with a deadline that expires after its n-th check: the
  same boundary raises in both, for every route; an expired query
  dispatches nothing (the port's dispatch ticks and its plain kernels'
  calls stay at zero);
- the coalescers: an entry that expires in the window is dropped before
  the launch without poisoning its batch, a tight deadline bypasses the
  window, and the counts equal the reference's;
- the compactors skip a scan the gate sheds;
- a JAX ``Server`` and a port ``Server`` side by side
  (tests/torch_wire_pair.py): a malformed, an expired, a defaulted
  deadline, one that expires in execution, shedding with small caps in
  the query and the ingest class, the accept-side thread cap, a disabled
  gate and ``/debug/admission``, each request answered with the same
  status, ``Retry-After`` and body bytes.

Every fixture restores exactly the process-wide settings it touches."""

from __future__ import annotations

import json
import re
import socket
import threading
import time

import numpy as np
import pytest

from pilosa_tpu import stats as jstats
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.models.field import FieldOptions as JFieldOptions
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.ops import tape as jtape
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.parallel.coalescer import Coalescer as JCoalescer
from pilosa_tpu.parallel.executor import ExecOptions as JOpts
from pilosa_tpu.parallel.executor import Executor as JExecutor
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu.serve import admission as jadm
from pilosa_tpu.serve import deadline as jdl
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu_torch import serve as tserve
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.models.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import tape as ttape
from pilosa_tpu_torch.parallel.coalescer import Coalescer as TCoalescer
from pilosa_tpu_torch.parallel.executor import ExecOptions as TOpts
from pilosa_tpu_torch.parallel.executor import Executor as TExecutor
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.serve import admission as tadm
from pilosa_tpu_torch.serve import deadline as tdl
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest; another installed package is named
# ``tests``
import torch_admission_script as script  # noqa: E402
import torch_wire_pair as wp  # noqa: E402

N_SHARDS = script.N_SHARDS
same = script.same


@pytest.fixture
def tenants_off():
    """[tenants] off in both packages for one test; restores both
    configs field by field."""
    was = wp.tenant_configs()
    for m in (wp.jtenant, wp.ttenant):
        m.config().enabled = False
    yield
    wp.restore_tenant_configs(was)


# ------------------------------------------------------------ deadlines


def _parse(mod, raw):
    try:
        d = mod.parse_header(raw)
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", d.budget_s, d.expired())


@pytest.mark.parametrize("raw", [
    "1.5", "30", " 2.5 ", "1_0", "0", "0.0", "-0.0", "-1", "-1e-9", "1e9",
    "86400", "86401", "inf", "-inf", "nan", "abc", "", "1.5s", "0x10"])
def test_parse_header_matches_the_reference(raw):
    assert _parse(tdl, raw) == _parse(jdl, raw)


def test_constants_match_the_reference():
    assert (tdl.HEADER, tdl.MAX_BUDGET_S) == (jdl.HEADER, jdl.MAX_BUDGET_S)
    assert (tadm.PRIORITY, tadm.CLASSES, tadm.MAX_QUEUE_WAIT_S,
            tadm.RETRY_AFTER_MIN_S, tadm.RETRY_AFTER_MAX_S) == (
        jadm.PRIORITY, jadm.CLASSES, jadm.MAX_QUEUE_WAIT_S,
        jadm.RETRY_AFTER_MIN_S, jadm.RETRY_AFTER_MAX_S)
    assert tserve.CLASSES == jadm.CLASSES
    assert tserve.Deadline is tdl.Deadline
    assert tserve.DeadlineExceededError is tdl.DeadlineExceededError
    assert tserve.ShedError is tadm.ShedError


def _scopes(mod):
    """A transcript of nested scopes, checks and the error's type."""
    out = [mod.current()]
    outer, inner = mod.Deadline(30.0), mod.Deadline(-1.0)
    with mod.scope(outer) as got:
        out.append(got is outer and mod.current() is outer)
        with mod.scope(inner):
            out.append(mod.current() is inner)
            try:
                mod.check(mod.current(), "map")
                out.append("no raise")
            except mod.DeadlineExceededError as e:
                out.append(("raised", str(e),
                            isinstance(e, ValueError)))
            with mod.scope(None):
                out.append(mod.current())
            out.append(mod.current() is inner)
        out.append(mod.current() is outer)
        mod.check(outer, "reduce")
        mod.check(None, "translate")
    out.append(mod.current())
    out.append(repr(mod.Deadline(5.0)).startswith("Deadline(remaining="))
    return out


def test_scopes_and_checks_match_the_reference():
    assert _scopes(tdl) == _scopes(jdl)


def test_a_scope_is_per_thread():
    got = {}
    with tdl.scope(tdl.Deadline(10.0)):
        t = threading.Thread(target=lambda: got.update(dl=tdl.current()))
        t.start()
        t.join(10)
    assert got == {"dl": None}


def _rpc(adm):
    out = []
    with adm.rpc_class("internal"):
        out.append(adm.current_rpc_class())
        with adm.rpc_class("ingest"):
            out.append(adm.current_rpc_class())
        out.append(adm.current_rpc_class())
    out.append(adm.current_rpc_class())

    @adm.tagged("ingest")
    def f():
        return adm.current_rpc_class()

    out.append(f())
    for bad in (lambda: adm.rpc_class("bulk"), lambda: adm.tagged("x")):
        try:
            bad()
        except ValueError as e:
            out.append(str(e))
    return out


def test_rpc_class_tags_match_the_reference():
    assert _rpc(tadm) == _rpc(jadm)


# ----------------------------------------------------------- controller


def _uncontended(r):
    r.acquire("a", "query")
    r.acquire("b", "query")
    r.debug()
    r.release("a")
    r.release("b")
    r.debug()


def _fifo(r):
    r.acquire("hold", "query")
    r.queue("w0", "query")
    r.queue("w1", "query")
    r.queue("w2", "query")
    r.debug()
    r.release("hold")
    r.join("w0")
    r.debug()
    r.release("w0")
    r.join("w1")
    r.release("w1")
    r.join("w2")


def _queue_full(r):
    r.acquire("hold", "query")
    r.queue("older", "query")
    r.acquire("newest", "query")
    r.acquire("newest2", "query", budget=30.0)
    r.debug()
    r.release("hold")
    r.join("older")


def _expired_on_arrival(r):
    r.acquire("zero", "query", budget=0.0)
    r.acquire("negative", "ingest", budget=-1.0)
    r.acquire("internal", "internal", budget=-5.0)
    r.acquire("live", "query", budget=30.0)
    r.debug()


def _expired_in_queue(r):
    r.acquire("hold", "query")
    r.queue("short", "query", budget=0.2)
    r.queue("long", "query", budget=30.0)
    r.join("short")
    r.debug()
    r.release("hold")
    r.join("long")


def _unmeetable(r):
    r.ctrl._gates["query"].ewma_service_s = 2.5  # a seeded history
    r.acquire("hold", "query")
    r.acquire("tight", "query", budget=1.0)
    r.queue("roomy", "query", budget=60.0)
    r.acquire("tight2", "query", budget=4.0)
    r.debug()
    r.release("hold")
    r.join("roomy")


def _internal_yields(r):
    r.acquire("hold", "query")
    r.queue("w", "query")
    r.acquire("bg", "internal")
    r.try_acquire("bg_try", "internal")
    r.acquire("imp", "ingest")
    r.debug()
    r.release("hold")
    r.join("w")
    r.release("w")
    r.acquire("bg_after", "internal")


def _isolation(r):
    r.acquire("i1", "internal")
    r.acquire("i2", "internal")
    r.acquire("q1", "query")
    r.acquire("q2", "query")
    r.acquire("g1", "ingest")
    r.debug()


def _disabled(r):
    for i in range(5):
        r.acquire(f"q{i}", "query", budget=0.0)
    r.try_acquire("t", "internal")
    r.debug()


def _try_acquire(r):
    r.try_acquire("a", "query")
    r.try_acquire("b", "query")
    r.release("a")
    r.try_acquire("c", "query")
    r.acquire("d", "ingest")
    r.try_acquire("e", "ingest")
    r.debug()


def _count_expired(r):
    r.acquire("a", "query")
    r.ctrl.count_expired("query")
    r.ctrl.count_expired("ingest")
    r.ctrl.count_expired("bulk")  # unknown: ignored
    r.release("a")
    r.debug()


SCRIPTS = {
    "uncontended": (_uncontended, {"query_cap": 2}),
    "fifo": (_fifo, {"query_cap": 1, "query_queue": 4}),
    "queue_full": (_queue_full, {"query_cap": 1, "query_queue": 1}),
    "expired_on_arrival": (_expired_on_arrival, {}),
    "expired_in_queue": (_expired_in_queue,
                         {"query_cap": 1, "query_queue": 4}),
    "deadline_unmeetable": (_unmeetable, {"query_cap": 1,
                                          "query_queue": 8}),
    "internal_yields": (_internal_yields, {
        "query_cap": 1, "query_queue": 2, "internal_cap": 4,
        "internal_queue": 4}),
    "class_isolation": (_isolation, {"query_cap": 2, "internal_cap": 1,
                                     "internal_queue": 0}),
    "disabled": (_disabled, {"enabled": False, "query_cap": 1,
                             "query_queue": 0}),
    "try_acquire": (_try_acquire, {"query_cap": 1, "query_queue": 1,
                                   "ingest_cap": 1}),
    "count_expired": (_count_expired, {"default_deadline": 2.5}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_scripts_match_the_reference(name, tenants_off):
    fn, kw = SCRIPTS[name]
    (want, want_order), (got, got_order) = script.run_both(fn, [
        (jadm, jdl, jadm.AdmissionController(
            stats=jstats.MemStatsClient(), **kw)),
        (tadm, tdl, tadm.AdmissionController(**kw))])
    assert got == want
    assert got_order == want_order


def test_a_request_queued_in_order_is_admitted_in_order(tenants_off):
    """FIFO promotion, held against the arrival order itself."""
    fn, kw = SCRIPTS["fifo"]
    (_log, order), = script.run_both(
        fn, [(tadm, tdl, tadm.AdmissionController(**kw))])
    assert order == ["w0", "w1", "w2"]


def test_an_expiry_in_the_queue_carries_its_wait(tenants_off):
    ctrl = tadm.AdmissionController(query_cap=1, query_queue=4)
    hold = ctrl.acquire("query")
    t0 = time.monotonic()
    with pytest.raises(tadm.ShedError) as e:
        ctrl.acquire("query", tdl.Deadline(0.1))
    assert e.value.wait_ns >= 0.1e9
    assert time.monotonic() - t0 < 5.0
    hold.release()
    hold.release()  # idempotent
    assert ctrl.debug()["classes"]["query"]["inFlight"] == 0


@pytest.mark.parametrize("kw", [{}, {"query_cap": 2, "query_queue": 3,
                                     "ingest_cap": 1, "ingest_queue": 1,
                                     "internal_cap": 1,
                                     "internal_queue": 0},
                                {"query_cap": 0, "query_queue": -4}])
def test_capacity_and_clamped_sizes_match_the_reference(kw, tenants_off):
    j = jadm.AdmissionController(**kw)
    t = tadm.AdmissionController(**kw)
    assert t.total_capacity() == j.total_capacity()
    assert script.scrub(t.debug()) == script.scrub(j.debug())
    for ctrl, mod in ((j, jadm), (t, tadm)):
        with pytest.raises(ValueError, match="unknown admission class"):
            ctrl.acquire("bulk")
        with pytest.raises(ValueError, match="unknown admission class"):
            ctrl.try_acquire("bulk")


def test_the_uncontended_path_costs_microseconds(tenants_off):
    """A coarse net against a lock disaster: one acquire and release
    well under 100 us on this host."""
    ctrl = tadm.AdmissionController()
    ctrl.acquire("query").release()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        ctrl.acquire("query").release()
    assert (time.perf_counter() - t0) / n * 1e6 < 100.0


# --------------------------------------------------------- executors


def _load(h, FieldOptions, flush: bool):
    """Field f (rows 1-3 at ~8 %) and int field v on every shard."""
    rng = np.random.default_rng(11)
    width = N_SHARDS * SHARD_WIDTH
    idx = h.create_index("i")
    f = idx.create_field("f")
    for r in (1, 2, 3):
        cols = rng.choice(width, size=width * 8 // 100, replace=False)
        f.import_bits(np.full(len(cols), r), cols)
        idx.import_existence(cols)
    v = idx.create_field("v", FieldOptions.int_field(-1000, 1000))
    cols = rng.choice(width, size=600, replace=False)
    v.import_values(cols.tolist(), rng.integers(-1000, 1000, 600).tolist())
    if flush:
        f.flush_deltas()
    return idx


@pytest.fixture
def executors(tmp_path, tenants_off):
    """(JAX executor, port executor) over the same data, mesh off, the
    port's imports compacted (the JAX holder writes base rows)."""
    mesh_was = meshexec._cfg.enabled
    meshexec.configure(enabled=False)
    jh = JHolder(str(tmp_path / "j"))
    th = THolder(str(tmp_path / "t"), device="cpu")
    _load(jh, JFieldOptions, flush=False)
    _load(th, TFieldOptions, flush=True)
    try:
        yield JExecutor(jh), TExecutor(th, device="cpu")
    finally:
        jh.close()
        th.close()
        meshexec.configure(enabled=mesh_was)


class Scripted:
    """A deadline alive for its first ``n`` ``expired()`` calls."""

    def __init__(self, n: int):
        self.n = n
        self.calls = 0

    def expired(self) -> bool:
        self.calls += 1
        return self.calls > self.n

    def remaining(self) -> float:
        return 3600.0 if self.calls < self.n else 0.0


QUERIES = [
    ("Count(Intersect(Row(f=1), Row(f=2)))", None),
    ("Count(Intersect(Row(f=1), Row(f=2)))", [1]),
    ("Count(Union(Row(f=1), Row(f=3)))", [0, 2]),
    ("Row(f=2)", None),
    ("Xor(Row(f=1), Row(f=2))", [2]),
    ("TopN(f, Row(f=2), n=2)", None),
    ("TopN(f, n=2)", None),
    ("TopN(f, Row(f=1), n=3)", [1]),
    ("Rows(f)", None),
    ("GroupBy(Rows(f))", None),
    ("MinRow(field=f)", None),
    ("Sum(field=v)", None),
    ("Sum(Row(f=1), field=v)", [0]),
    ("Max(field=v)", [2]),
    ("Count(Row(f=1)) Count(Row(f=3))", None),
    ("Count(Row(v > 10))", None),
]


def _outcome(ex, opts_cls, pql, shards, dl, cls_err):
    try:
        res = ex.execute("i", pql, opt=opts_cls(shards=shards,
                                               deadline=dl, cache=False,
                                               **({"mesh": False}
                                                  if opts_cls is JOpts
                                                  else {})))
    except cls_err as e:
        return "expired", re.sub(r"shard \d+", "shard N", str(e))
    return "ok", json.dumps([_plain(r) for r in res])


def _plain(r):
    """A result as plain data, either package's types."""
    if hasattr(r, "columns"):
        return [int(c) for c in r.columns()]
    if isinstance(r, list):
        return [_plain(x) for x in r]
    if hasattr(r, "__dataclass_fields__"):
        return {k: _plain(getattr(r, k)) for k in r.__dataclass_fields__}
    return r if not hasattr(r, "item") else r.item()


@pytest.mark.parametrize("pql,shards", QUERIES)
def test_deadline_checks_fire_where_the_references_do(executors, pql,
                                                      shards):
    """A deadline that expires after its n-th check, n = 0, 1, 2, ...:
    each package raises at the same boundary, with the same message, or
    both answer the same."""
    jex, tex = executors
    for n in range(12):
        want = _outcome(jex, JOpts, pql, shards, Scripted(n),
                        jdl.DeadlineExceededError)
        got = _outcome(tex, TOpts, pql, shards, Scripted(n),
                       tdl.DeadlineExceededError)
        assert got == want, (n, got, want)
        if want[0] == "ok":
            break
    else:
        pytest.fail(f"{pql}: still expiring after 12 checks")


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the port's plain kernel versions, which its wrappers
    compute on CPU tensors where a card would launch K2, K3, K3-kinds,
    K4, K5, K6 or K1."""
    calls = {}
    for mod, name in ((tbm, "gathered_pair_counts"),
                      (ck, "vm_counts_plain"),
                      (ck, "vm_counts_kinds_plain"),
                      (tbm, "row_counts_masked_plain"),
                      (tbm, "masked_matrix_counts_plain"),
                      (ck, "bsi_compare_plain"), (ck, "count_and_plain")):
        real = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("pql,shards", QUERIES)
def test_an_expired_query_dispatches_nothing(executors, plain_calls, pql,
                                             shards):
    jex, tex = executors
    with jbm.dispatch_counter() as jdc:
        want = _outcome(jex, JOpts, pql, shards, jdl.Deadline(-1.0),
                        jdl.DeadlineExceededError)
    with tbm.dispatch_counter() as tdc:
        got = _outcome(tex, TOpts, pql, shards, tdl.Deadline(-1.0),
                       tdl.DeadlineExceededError)
    assert got == want == ("expired", "deadline expired before translate")
    assert jdc.n == 0 and tdc.launches == []
    assert set(plain_calls.values()) == {0}
    # a live deadline answers as no deadline does
    live = _outcome(tex, TOpts, pql, shards, tdl.Deadline(60.0),
                    tdl.DeadlineExceededError)
    assert live == _outcome(tex, TOpts, pql, shards, None,
                            tdl.DeadlineExceededError)
    assert live == _outcome(jex, JOpts, pql, shards, jdl.Deadline(60.0),
                            jdl.DeadlineExceededError)


def test_the_cache_wait_is_capped_by_the_deadline():
    rc_wait = TExecutor._rc_wait
    from pilosa_tpu_torch.runtime import resultcache

    assert rc_wait(TOpts()) == resultcache.FLIGHT_WAIT_S
    assert rc_wait(TOpts(deadline=tdl.Deadline(60.0))) == \
        resultcache.FLIGHT_WAIT_S
    assert 0.0 < rc_wait(TOpts(deadline=tdl.Deadline(0.3))) <= 0.3
    assert rc_wait(TOpts(deadline=tdl.Deadline(-1.0))) == 0.0


# --------------------------------------------------------- coalescers


COUNT = "Count(Intersect(Row(f=1), Row(f=2)))"


def _window_batch(ex, co, pkg, counters):
    """A leader with no deadline, a live follower with a long one and an
    expired follower, in one window (the coalescer's ``max_batch`` of 3
    seals it when the third arrives): (results, errors, counters)."""
    idx = ex.holder.index("i")
    child = (jparse if pkg is jdl else tparse)(COUNT).calls[0].children[0]
    shards = tuple(sorted(idx.available_shards()))
    results, errs = {}, {}

    def run(name, delay, dl):
        time.sleep(delay)
        try:
            results[name] = co.count(ex, idx, child, shards, deadline=dl)
        except BaseException as e:  # noqa: BLE001 -- asserted below
            errs[name] = e

    ts = [threading.Thread(target=run, args=a) for a in (
        ("leader", 0.0, None), ("live", 0.1, pkg.Deadline(60.0)),
        ("expired", 0.1, pkg.Deadline(-1.0)))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return results, errs, counters()


def _vm_counts(tape_mod):
    c = tape_mod.counters()
    return {k: c.get(k, 0) for k in ("vm.executions", "vm.queries",
                                     "vm.fallbacks", "tape.executions")}


def test_an_expired_entry_is_dropped_before_launch(executors, plain_calls):
    jex, tex = executors
    want_n = jex.execute("i", COUNT, opt=JOpts(mesh=False))[0]
    assert tex.execute("i", COUNT)[0] == want_n
    out = []
    for ex, co, pkg, tp in (
            (jex, JCoalescer(window_s=5.0, max_batch=3, enabled=True,
                             stats=jstats.MemStatsClient()), jdl, jtape),
            (tex, TCoalescer(window_s=5.0, max_batch=3, enabled=True),
             tdl, ttape)):
        tp.reset_counters()
        plain_calls["vm_counts_plain"] = 0
        results, errs, counters = _window_batch(
            ex, co, pkg, lambda tp=tp: _vm_counts(tp))
        assert results == {"leader": want_n, "live": want_n}, errs
        assert isinstance(errs["expired"], pkg.DeadlineExceededError)
        out.append((str(errs["expired"]), counters))
    assert out[1] == out[0]
    # the two live members shared one VM launch of the plain version
    assert out[1][1]["vm.executions"] == 1
    assert out[1][1]["vm.queries"] == 2
    assert plain_calls["vm_counts_plain"] == 1


def test_a_batch_of_expired_entries_launches_nothing(executors,
                                                     plain_calls):
    _jex, tex = executors
    co = TCoalescer(window_s=0.2, max_batch=8, enabled=True)
    idx = tex.holder.index("i")
    child = tparse(COUNT).calls[0].children[0]
    shards = tuple(sorted(idx.available_shards()))
    ttape.reset_counters()
    errs = []
    # made before any member joins: every flush comes a window (0.2 s)
    # after its first member joined, past every budget
    dls = [tdl.Deadline(0.05) for _ in range(3)]

    def run(dl):
        try:
            co.count(tex, idx, child, shards, deadline=dl)
        except tdl.DeadlineExceededError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=run, args=(dl,)) for dl in dls]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert errs == ["deadline expired in the coalescer window"] * 3
    assert _vm_counts(ttape)["vm.executions"] == 0
    assert set(plain_calls.values()) == {0}


def test_a_tight_deadline_bypasses_the_window(executors, plain_calls):
    jex, tex = executors
    want = jex.execute("i", COUNT, opt=JOpts(mesh=False, coalesce=False))
    out = []
    for ex, opts_cls, co, pkg, tp in (
            (jex, JOpts, JCoalescer(window_s=1.0, max_batch=8, enabled=True,
                                    stats=jstats.MemStatsClient()), jdl,
             jtape),
            (tex, TOpts, TCoalescer(window_s=1.0, max_batch=8,
                                    enabled=True), tdl, ttape)):
        ex.coalescer = co
        kw = {"mesh": False} if opts_cls is JOpts else {}
        for budget, bypass in ((1.9, True), (30.0, False)):
            opt = opts_cls(deadline=pkg.Deadline(budget), cache=False, **kw)
            assert co.eligible(opt) is not bypass
            tp.reset_counters()
            t0 = time.perf_counter()
            got = ex.execute("i", COUNT, opt=opt)
            ms = (time.perf_counter() - t0) * 1e3
            assert got == want
            out.append((bypass, _vm_counts(tp)["vm.queries"]))
            if bypass:
                assert ms < 1000.0  # never waited the window
    assert out[2:] == out[:2] == [(True, 0), (False, 1)]
    assert plain_calls["gathered_pair_counts"] >= 1


# --------------------------------------------------------- compactors


@pytest.mark.parametrize("pressure", [False, True])
def test_a_compaction_scan_yields_to_query_pressure(pressure):
    """Each package's compactor scan under an internal ticket: skipped
    (``compact_skipped``) while the query queue is under pressure."""
    out = []
    for comp_mod, adm in ((jcompactor, jadm), (tcompactor, tadm)):
        ctrl = adm.AdmissionController(query_cap=1, query_queue=2)
        c = comp_mod.Compactor()
        c.admission = ctrl
        hold = ctrl.acquire("query") if pressure else None
        waiters = []
        if pressure:
            for _ in range(2):  # fill the query queue: pressure
                t = threading.Thread(
                    target=lambda: ctrl.acquire("query").release())
                t.start()
                waiters.append(t)
            end = time.monotonic() + 10
            while ctrl.debug()["classes"]["query"]["waiting"] < 2:
                assert time.monotonic() < end
                time.sleep(0.002)
        c._run_gated()
        dbg = script.scrub(ctrl.debug())
        if hold is not None:
            hold.release()
        for t in waiters:
            t.join(10)
        out.append((c.compact_skipped, dbg["classes"]["internal"]))
    assert out[1] == out[0]
    assert out[1][0] == (1 if pressure else 0)


def test_the_compactor_runs_ungated_without_a_controller():
    c = tcompactor.Compactor()
    c._run_gated()
    c.admission = tadm.AdmissionController(enabled=False)
    c._run_gated()
    assert c.compact_skipped == 0


# ----------------------------------------------------------- servers


@pytest.fixture
def pair_of(tmp_path):
    """A factory of (JAX server, port server) pairs with the given
    knobs, each set up with field f; all closed and every process-wide
    setting restored at the end."""
    with wp.configuration():
        stack = []

        def make(**kw):
            cm = wp.servers(str(tmp_path / f"p{len(stack)}"), **kw)
            pair = cm.__enter__()
            stack.append(cm)
            script.setup(pair, SHARD_WIDTH)
            return pair

        try:
            yield make
        finally:
            for cm in reversed(stack):
                cm.__exit__(None, None, None)


@pytest.mark.parametrize("value", ["abc", "nan", "inf", "-inf", "1.5s",
                                   "", " "])
def test_a_malformed_deadline_is_400_everywhere(pair_of, value):
    pair = pair_of()
    for path, body in (("/index/i/query", b"Count(Row(f=1))"),
                       ("/index/i/field/f/import",
                        b'{"rowIDs": [1], "columnIDs": [3]}'),
                       ("/schema", None), ("/export?index=i&field=f", None),
                       ("/debug/admission", None)):
        st, ra, body_out = same(pair, path, body,
                                {"X-Pilosa-Deadline": value},
                                "application/json" if "import" in path
                                else "text/plain")
        assert st == 400 and ra is None
        assert json.loads(body_out)["error"].startswith(
            "invalid X-Pilosa-Deadline header")
    script.quiet(pair)
    assert script.admission_doc(pair[1]) == script.admission_doc(pair[0])


@pytest.mark.parametrize("value", ["0", "-1", "-0.5", "0.0"])
def test_an_expired_deadline_is_503_before_anything_runs(pair_of, value):
    pair = pair_of()
    for path, body, klass in (
            ("/index/i/query", b"Count(Row(f=1))", "query"),
            ("/index/i/query", b"Set(99, f=1)", "query"),
            ("/export?index=i&field=f", None, "query"),
            ("/index/i/field/f/import",
             b'{"rowIDs": [1], "columnIDs": [99]}', "ingest"),
            ("/internal/translate/keys",
             b'{"index": "i", "keys": ["a"]}', "ingest")):
        st, ra, out = same(pair, path, body, {"X-Pilosa-Deadline": value},
                           "application/json" if body and b"{" in body
                           else "text/plain")
        assert (st, ra) == (503, "1")
        assert json.loads(out) == {
            "error": f"{klass} request expired (admission control; retry "
                     f"after 1s)", "reason": "expired", "class": klass}
    # an ungated route ignores it; nothing was written
    assert same(pair, "/schema", None, {"X-Pilosa-Deadline": value})[0] \
        == 200
    assert same(pair, "/index/i/query", b"Count(Row(f=1))")[2] == \
        same(pair, "/index/i/query", b"Count(Row(f=1))",
             {"X-Pilosa-Deadline": "30"})[2]
    script.quiet(pair)
    doc = script.admission_doc(pair[1])
    assert doc == script.admission_doc(pair[0])
    assert doc["classes"]["query"]["expired"] == 3
    assert doc["classes"]["ingest"]["expired"] == 2


def test_admitted_requests_answer_as_the_reference(pair_of):
    pair = pair_of()
    for body in script.ADMITTED:
        for h in ({}, {"X-Pilosa-Deadline": "30"},
                  {"X-Pilosa-Deadline": "1e12"},
                  {"X-Pilosa-Tenant": "acme"}):
            assert same(pair, "/index/i/query", body, h)[0] == 200
    assert same(pair, "/index/i/query?tenant=acme&nocache=1",
                b"Count(Row(f=2))")[0] == 200
    assert same(pair, "/export?index=i&field=f&shard=1", None,
                {"X-Pilosa-Deadline": "30"})[0] == 200
    assert same(pair, "/index/i/field/f/import",
                b'{"rowIDs": [4, 4], "columnIDs": [1, 70000]}',
                {"X-Pilosa-Deadline": "30"}, "application/json")[0] == 200
    assert same(pair, "/index/i/query", b"Count(Row(f=4))")[2] == \
        b'{"results": [2]}'
    script.quiet(pair)
    doc = script.admission_doc(pair[1])
    assert doc == script.admission_doc(pair[0])
    assert doc["classes"]["query"]["admitted"] == 4 * len(script.ADMITTED) + 3
    assert THandler.ACCEPT_HEADROOM == JHandler.ACCEPT_HEADROOM
    assert doc["acceptThreads"]["max"] == (
        pair[1].admission.total_capacity() + THandler.ACCEPT_HEADROOM)


def test_the_default_deadline_applies_without_a_header(pair_of):
    pair = pair_of(admission_default_deadline=1e-9)
    for path, body in (("/index/i/query", b"Count(Row(f=1))"),
                       ("/index/i/field/f/import",
                        b'{"rowIDs": [1], "columnIDs": [3]}')):
        st, ra, _ = same(pair, path, body, None,
                         "application/json" if b"{" in body
                         else "text/plain")
        assert (st, ra) == (503, "1")
        # a header of its own overrides the default
        assert same(pair, path, body, {"X-Pilosa-Deadline": "30"},
                    "application/json" if b"{" in body
                    else "text/plain")[0] == 200
    assert same(pair, "/schema")[0] == 200  # ungated
    script.quiet(pair)
    doc = script.admission_doc(pair[1])
    assert doc == script.admission_doc(pair[0])
    assert doc["defaultDeadline"] == 1e-9


def _slow(server, delay_s: float):
    real = server.api.executor.execute

    def slow(*a, **kw):
        time.sleep(delay_s)
        return real(*a, **kw)

    server.api.executor.execute = slow


def test_a_deadline_that_expires_in_execution_is_503(pair_of,
                                                     plain_calls):
    """Admitted, then expired before translate: 503, counted as an
    expiry, nothing dispatched."""
    pair = pair_of()
    for s in pair:
        _slow(s, 0.3)
    for body in (b"Count(Intersect(Row(f=1), Row(f=2)))", b"TopN(f, n=2)"):
        st, ra, out = same(pair, "/index/i/query", body,
                           {"X-Pilosa-Deadline": "0.1"})
        assert (st, ra) == (503, None)
        assert json.loads(out) == {
            "error": "deadline expired before translate"}
    # the protobuf form answers the error as QueryResponse.err with 400
    st, _ra, _ = same(pair, "/index/i/query", b"Count(Row(f=1))",
                      {"X-Pilosa-Deadline": "0.1",
                       "Accept": wp.PB})
    assert st == 400
    script.quiet(pair)
    doc = script.admission_doc(pair[1])
    assert doc == script.admission_doc(pair[0])
    assert doc["classes"]["query"]["expired"] == 2
    assert set(plain_calls.values()) == {0}


@pytest.mark.parametrize("klass,path,body,ctype", [
    ("query", "/index/i/query", b"Count(Row(f=1))", "text/plain"),
    ("ingest", "/index/i/field/f/import",
     b'{"rowIDs": [5], "columnIDs": [12]}', "application/json")])
def test_small_caps_shed_as_the_reference(pair_of, klass, path, body,
                                          ctype):
    pair = pair_of(**{f"admission_{klass}_cap": 1,
                      f"admission_{klass}_queue": 1})
    for s in pair:
        # Retry-After reads the class's service-time EWMA, which the
        # set-up's import seeded with its own host time: start both at 0
        s.admission._gates[klass].ewma_service_s = 0.0
    held = script.hold(pair, klass)
    ts, res = script.queued(pair, path, body, ctype)
    st, ra, out = same(pair, path, body, None, ctype)
    assert (st, ra) == (429, "1")
    assert json.loads(out) == {
        "error": f"{klass} request queue-full (admission control; retry "
                 f"after 1s)", "reason": "queue-full", "class": klass}
    # a deadline the predicted wait cannot meet sheds 503 up front
    for s in pair:
        s.admission._gates[klass].ewma_service_s = 3.0
    # the queue is full first: 429, Retry-After (1 + 1) x 3 s
    assert same(pair, path, body, {"X-Pilosa-Deadline": "1"}, ctype)[:2] \
        == (429, "6")
    script.quiet(pair, held=1)
    doc = script.admission_doc(pair[1])
    assert doc == script.admission_doc(pair[0])
    assert doc["classes"][klass]["inFlight"] == 1
    assert doc["classes"][klass]["waiting"] == 1
    for t in held:
        t.release()
    for t in ts:
        t.join(30)
    assert res[1] == res[0] and res[0][0] == 200
    script.quiet(pair)
    for s in pair:
        s.admission._gates[klass].ewma_service_s = 3.0
    held = script.hold(pair, klass)
    st, ra, out = same(pair, path, body, {"X-Pilosa-Deadline": "1"}, ctype)
    assert (st, ra) == (503, "3")
    assert json.loads(out)["reason"] == "deadline-unmeetable"
    for t in held:
        t.release()
    assert same(pair, path, body, None, ctype)[0] == 200
    # every request the gate admitted was served the same in both
    assert same(pair, "/index/i/query", b"Count(Row(f=1)) Count(Row(f=5))")[
        0] == 200
    script.quiet(pair)
    assert script.admission_doc(pair[1]) == script.admission_doc(pair[0])


def test_a_disabled_gate_admits_and_still_checks_deadlines(pair_of):
    pair = pair_of(admission_enabled=False, admission_query_cap=1,
                   admission_query_queue=0)
    held = script.hold(pair, "query", 3)  # no cap applies
    st, ra, out = same(pair, "/index/i/query", b"Count(Row(f=1))",
                       {"X-Pilosa-Deadline": "0"})
    assert (st, ra) == (503, None)
    assert json.loads(out) == {
        "error": "deadline expired before query execution"}
    assert same(pair, "/index/i/query", b"Count(Row(f=1))",
                {"X-Pilosa-Deadline": "abc"})[0] == 400
    assert same(pair, "/index/i/query", b"Count(Row(f=1))")[0] == 200
    for t in held:
        t.release()
    script.quiet(pair)
    doc = script.admission_doc(pair[1])
    assert doc == script.admission_doc(pair[0])
    assert doc["enabled"] is False
    assert doc["acceptThreads"]["max"] is None
    assert pair[1].handler.max_threads is None


def test_past_the_thread_cap_a_connection_gets_a_fast_503(pair_of):
    pair = pair_of()
    raw = []
    for s in pair:
        base = s.handler._threads_active
        s.handler.max_threads = base + 2
        socks = []
        try:
            end = time.time() + 10
            while (s.handler._threads_active < s.handler.max_threads
                   and len(socks) < 12):
                assert time.time() < end, "the cap never filled"
                socks.append(socket.create_connection(
                    (s.handler.host, s.handler.port), timeout=5))
                time.sleep(0.05)
            t0 = time.perf_counter()
            with socket.create_connection((s.handler.host, s.handler.port),
                                          timeout=5) as c:
                c.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
                data = b""
                while True:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    data += chunk
            assert time.perf_counter() - t0 < 2.0
            raw.append(data)
        finally:
            for c in socks:
                c.close()
            s.handler.max_threads = (s.admission.total_capacity()
                                     + s.handler.ACCEPT_HEADROOM)
    assert raw[1] == raw[0]
    assert raw[0].startswith(b"HTTP/1.1 503 Service Unavailable\r\n")
    assert b"Retry-After: 1\r\n" in raw[0]
    assert raw[0].endswith(b'{"error":"server overloaded"}')
    time.sleep(0.2)
    assert same(pair, "/index/i/query", b"Count(Row(f=1))")[0] == 200


# ----------------------------------------------------------------- CLI


class _Opened(Exception):
    pass


@pytest.mark.parametrize("argv,want", [
    ([], {"admission_enabled": True, "tenants_enabled": False,
          "tenants_default_share": None, "tenants_default_queue": None,
          "tenants_quotas": None}),
    (["--no-admission", "--admission-query-cap", "9",
      "--admission-internal-queue", "17", "--admission-ingest-cap", "3",
      "--admission-default-deadline", "2.5", "--tenants-enabled",
      "--tenant-default-share", "3", "--tenant-default-queue", "5",
      "--tenant-quota", "gold:16:64:0.5", "--tenant-quota", "free:2:8"],
     {"admission_enabled": False, "admission_query_cap": 9,
      "admission_internal_queue": 17, "admission_ingest_cap": 3,
      "admission_default_deadline": 2.5, "tenants_enabled": True,
      "tenants_default_share": 3, "tenants_default_queue": 5,
      "tenants_quotas": "gold:16:64:0.5,free:2:8"})])
def test_the_server_flags_reach_the_server(monkeypatch, tmp_path, argv,
                                           want):
    """The reference's admission and tenant flags (pilosa_tpu/cmd.py:
    43-58, 190-210) become the port server's knobs; a flag left out
    keeps the server's default."""
    from pilosa_tpu.serve import tenant as jtenant
    from pilosa_tpu_torch import cmd
    from pilosa_tpu_torch.server import server as tserver

    got = {}

    class Fake:
        def __init__(self, data_dir, **kw):
            got.update(kw)

        def open(self):
            raise _Opened

    monkeypatch.setattr(tserver, "Server", Fake)
    monkeypatch.setattr(cmd.signal, "signal", lambda *a: None)
    with pytest.raises(_Opened):
        cmd.main(["server", "-d", str(tmp_path), "--device", "cpu"] + argv)
    if isinstance(want["tenants_quotas"], str):
        want["tenants_quotas"] = {
            n: vars(q) for n, q in jtenant.parse_quota_spec(
                want["tenants_quotas"]).items()}
        got["tenants_quotas"] = {n: vars(q) for n, q in
                                 got["tenants_quotas"].items()}
    assert {k: v for k, v in got.items()
            if k.startswith(("admission_", "tenants_"))} == want
