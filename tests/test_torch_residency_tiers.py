"""The port's residency tiers on the CPU: the promotion pool, the
host-bytes route, ``?notiers=1``, the prefetcher, the out-of-memory
retry at every dispatch site, and the wire (tests/test_residency_tiers.py
in the JAX package, with its failpoints replaced by wrapped promote
closures: the port has no ``faultinject``).

- the promoter is single-flight per key, a full queue sheds queued
  prefetch work before a demand job, and a saturated ``internal``
  admission class sheds promotions;
- a working set four times the budget answers every ``Count`` exact
  through demotions and promotions; a promotion held past its wait, or
  one that raises, answers from the host bytes (``fallbacks``), exact;
  ``?notiers=1`` gives byte-identical rows and touches no tier;
- ``Prefetcher.run_once`` promotes the hottest demoted entry and skips
  one no query touched;
- ``run_with_oom_retry`` retries exactly once on
  ``torch.cuda.OutOfMemoryError``, evicting everything and shrinking the
  budget to its floor, and re-raises anything else untouched; the fused
  Count, Row and TopN and the coalescer's flush recover from one;
- a JAX server and a port server (tests/torch_wire_pair.py) answer
  ``?notiers=1`` and flagless queries with the same bytes, and with
  [tenants] on their ``/debug/tenants`` residency halves are equal."""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu.runtime import prewarm as jprewarm
from pilosa_tpu_torch import observe
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import expr
from pilosa_tpu_torch.parallel.coalescer import Coalescer
from pilosa_tpu_torch.parallel.executor import ExecOptions, Executor
from pilosa_tpu_torch.runtime import prewarm, residency
from pilosa_tpu_torch.runtime.prefetch import Prefetcher
from pilosa_tpu_torch.serve import deadline as _deadline
from pilosa_tpu_torch.serve.admission import AdmissionController
from pilosa_tpu_torch.server.handler import serialize_result as tser
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest; another installed package is named
# ``tests``
import torch_wire_pair as wp  # noqa: E402

#: room for about two dense row stacks of four shards
SMALL = 2 * 8 * (SHARD_WIDTH // 8) + 1024


@pytest.fixture
def tiers(monkeypatch):
    """A fresh port manager and [residency] config for the test, put back
    after (promotion workers stopped); no background prewarm, whose
    stacks would race the test's own."""
    with wp.residency_state() as mgr:
        monkeypatch.setenv("PILOSA_TPU_PREWARM", "0")
        yield mgr


def _entry(payload):
    return ("tok", payload)


class _Owner:
    """A bare owner cache exercising the manager without the field."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.cache: dict = {}

    def put(self, key, nbytes: int = 100) -> None:
        payload = np.zeros(max(1, nbytes // 8), dtype=np.uint64)
        self.cache[key] = ("tok", payload)
        self.mgr.admit(self.cache, key, nbytes, token="tok", host=payload,
                       promote=_entry)


def _gated(ent, gate: threading.Event):
    """Hold ``ent``'s promotion until ``gate`` is set."""
    promote = ent.promote
    ent.promote = lambda p: (gate.wait(5), promote(p))[1]
    return ent


# ------------------------------------------------------------ promoter


def test_single_flight_per_key(tiers):
    o = _Owner(tiers)
    o.put("k")
    gate = threading.Event()
    ent = _gated(tiers.host_lookup(o.cache, "k", "tok"), gate)
    p = residency.promoter()
    before = p.stats()["promotions"]  # the pool's counters are process-wide
    f1 = p.submit(ent)
    f2 = p.submit(ent, prefetch=True)
    assert f1 is f2 and p.stats()["inFlight"] == 1
    gate.set()
    assert f1.event.wait(5) and f1.ok
    assert p.stats()["promotions"] == before + 1


def test_full_queue_sheds_prefetch_for_demand(tiers):
    residency.configure(promote_queue=2, promote_workers=1)
    o = _Owner(tiers)
    gate = threading.Event()
    ents = []
    for i in range(4):
        o.put(i)
        ents.append(_gated(tiers.host_lookup(o.cache, i, "tok"), gate))
    p = residency.promoter()
    shed0 = p.stats()["prefetchShed"]
    f0 = p.submit(ents[0])
    deadline = time.monotonic() + 5
    while p.stats()["queue"] > 0 and time.monotonic() < deadline:
        time.sleep(0.01)  # the single worker holds f0; the queue is empty
    fp1 = p.submit(ents[1], prefetch=True)
    fp2 = p.submit(ents[2], prefetch=True)
    assert fp1 is not None and fp2 is not None
    assert p.submit(ents[1], prefetch=True) is fp1  # joins its flight
    fd = p.submit(ents[3])  # demand over a full queue sheds a prefetch
    assert fd is not None
    shed = [f for f in (fp1, fp2) if f.event.is_set() and not f.ok]
    assert len(shed) == 1 and p.stats()["prefetchShed"] == shed0 + 1
    gate.set()
    for f in (f0, fd):
        assert f.event.wait(5) and f.ok


def test_admission_saturation_sheds_promotions(tiers):
    ctrl = AdmissionController(internal_cap=1, internal_queue=1)
    held = ctrl.try_acquire("internal")  # saturate the class
    o = _Owner(tiers)
    o.put("k")
    ent = tiers.host_lookup(o.cache, "k", "tok")
    p = residency.promoter()
    p.admission = ctrl
    try:
        fl = p.submit(ent)
        assert fl.event.wait(5)
        assert not fl.ok and fl.error is not None
    finally:
        held.release()
        p.admission = None


# ------------------------------------------------------ the field layer


def _build_index(n_rows: int, shards: int = 4, fill: int = 1 << 14):
    """A pathless port holder with ``n_rows`` dense rows over ``shards``
    shards (fill high enough to stay off the container path, so every
    fused read stages the dense stacks the tier manages), with the
    numpy oracle of each row's bits."""
    h = Holder(None, device="cpu")
    f = h.create_index("i").create_field("f")
    rng = np.random.default_rng(7)
    oracle = {}
    for row in range(n_rows):
        cols = rng.choice(shards * SHARD_WIDTH, size=fill, replace=False)
        f.import_bits(np.full(len(cols), row), cols)
        oracle[row] = np.sort(cols)
    f.flush_deltas()
    return h, f, oracle


def _opt(**kw) -> ExecOptions:
    return ExecOptions(cache=False, **kw)


def _churn(ex, oracle, rounds: int = 2) -> None:
    for _ in range(rounds):
        for row in oracle:
            got = ex.execute("i", f"Count(Row(f={row}))", opt=_opt())[0]
            assert got == len(oracle[row])


def test_working_set_over_budget_is_exact(tiers):
    residency.manager().budget = SMALL
    h, _, oracle = _build_index(8)
    promoted = residency.promoter().stats()["promotions"]
    try:
        _churn(Executor(h, device="cpu"), oracle, rounds=3)
        st = tiers.stats()
        assert st["tiers"]["demotions"] > 0, "budget never demoted"
        assert st["tiers"]["hits"] > 0, "host tier never hit"
        assert st["total"] <= st["budget"]
        assert residency.promoter().stats()["promotions"] > promoted
    finally:
        h.close()


def _held_promotions(mgr, gate: threading.Event) -> None:
    for ent in list(mgr._host.values()):
        _gated(ent, gate)


def test_a_promotion_past_its_wait_answers_from_host_bytes(tiers):
    residency.manager().budget = SMALL
    residency.configure(promote_wait_ms=5000.0)
    h, _, oracle = _build_index(8)
    ex = Executor(h, device="cpu")
    gate = threading.Event()
    try:
        _churn(ex, oracle)
        _held_promotions(tiers, gate)
        fb = tiers.stats()["tiers"]["fallbacks"]
        dl = _deadline.Deadline(0.15)
        t0 = time.perf_counter()
        with _deadline.scope(dl):
            got = ex.execute("i", "Count(Row(f=0))",
                             opt=_opt(deadline=dl))[0]
        # the wait was capped at the deadline's remainder, not 5 s
        assert time.perf_counter() - t0 < 1.0
        assert got == len(oracle[0])
        assert tiers.stats()["tiers"]["fallbacks"] > fb
        # a Row over the host bytes is the same row, bit for bit
        for r in oracle:
            ex.execute("i", f"Row(f={r})", opt=_opt())
        _held_promotions(tiers, gate)
        fb = tiers.stats()["tiers"]["fallbacks"]
        with _deadline.scope(_deadline.Deadline(0.15)):
            row = ex.execute("i", "Row(f=0)", opt=_opt())[0]
        assert np.array_equal(np.asarray(row.columns(), dtype=np.int64),
                              oracle[0])
        assert tiers.stats()["tiers"]["fallbacks"] > fb
    finally:
        gate.set()
        h.close()


def test_a_promotion_that_raises_answers_from_host_bytes(tiers):
    residency.manager().budget = SMALL
    h, _, oracle = _build_index(8)
    ex = Executor(h, device="cpu")
    try:
        _churn(ex, oracle)
        for ent in list(tiers._host.values()):
            ent.promote = lambda p: (_ for _ in ()).throw(
                RuntimeError("upload refused"))
        failed = residency.promoter().stats()["failures"]
        _churn(ex, oracle, rounds=1)
        assert residency.promoter().stats()["failures"] > failed
        assert tiers.stats()["tiers"]["fallbacks"] > 0
    finally:
        h.close()


def test_notiers_rows_are_byte_identical_and_skip_the_tier(tiers):
    residency.manager().budget = SMALL
    h, _, oracle = _build_index(6)
    ex = Executor(h, device="cpu")
    try:
        on = {r: ex.execute("i", f"Row(f={r})", opt=_opt())[0].segments
              for r in oracle}
        before = tiers.stats()["tiers"]
        off = {r: ex.execute("i", f"Row(f={r})", opt=_opt(tiers=False))[0]
               .segments for r in oracle}
        after = tiers.stats()["tiers"]
        for r in oracle:
            assert on[r].keys() == off[r].keys()
            for s in on[r]:
                assert np.array_equal(on[r][s], off[r][s])
        assert after["hits"] == before["hits"]
        assert after["fallbacks"] == before["fallbacks"]
        assert after["misses"] == before["misses"]
        assert tiers.stats()["evictions"] > 0
    finally:
        h.close()


def test_a_closed_holder_leaves_no_tracked_bytes(tiers):
    residency.manager().budget = SMALL
    h, _, oracle = _build_index(6)
    _churn(Executor(h, device="cpu"), oracle)
    assert tiers.stats()["tiers"]["host"]["entries"] > 0
    h.close()
    st = tiers.stats()
    assert (st["total"], st["entries"]) == (0, 0)
    assert st["tiers"]["host"] == {"budget": 1 << 30, "bytes": 0,
                                   "entries": 0}
    assert residency.manager().host_candidates() == []


# ------------------------------------------------------------ prefetch


def test_run_once_promotes_the_hottest_candidate(tiers):
    o = _Owner(tiers)
    for i in range(6):
        o.put(i)
        o.cache.pop(i)
        tiers.demote(o.cache, i)
    for _ in range(10):
        observe.note_access((id(o.cache), 3))
    before = residency.promoter().stats()
    assert Prefetcher().run_once() == 1
    deadline = time.monotonic() + 5
    while 3 not in o.cache and time.monotonic() < deadline:
        time.sleep(0.01)
    assert 3 in o.cache and set(o.cache) == {3}
    st = residency.promoter().stats()
    assert st["prefetchIssued"] == before["prefetchIssued"] + 1
    deadline = time.monotonic() + 5
    while (residency.promoter().stats()["prefetchCompleted"]
           == before["prefetchCompleted"] and time.monotonic() < deadline):
        time.sleep(0.01)
    assert (residency.promoter().stats()["prefetchCompleted"]
            == before["prefetchCompleted"] + 1)
    tiers.touch(o.cache, 3)
    tiers.touch(o.cache, 3)
    assert tiers.stats()["tiers"]["prefetchUseful"] == 1


def test_zero_score_candidates_are_not_prefetched(tiers):
    o = _Owner(tiers)
    o.put("unseen")
    o.cache.pop("unseen")
    tiers.demote(o.cache, "unseen")
    before = residency.promoter().stats()["prefetchIssued"]
    assert Prefetcher().run_once() == 0
    assert residency.promoter().stats()["prefetchIssued"] == before


def test_the_prefetcher_thread_starts_and_stops(tiers):
    p = Prefetcher(interval=0.01)
    p.start()
    deadline = time.monotonic() + 5
    while p.stats()["cycles"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p.stats()["running"] and p.stats()["cycles"] >= 2
    p.stop()
    assert not p.stats()["running"]


# ------------------------------------------------------ out of memory


def test_oom_retry_retries_once_and_floors_the_budget(tiers):
    residency.manager().budget = residency.MIN_BUDGET_BYTES + 1
    o = _Owner(tiers)
    o.put("a")
    calls = []
    n0 = residency.oom_retries()

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 42

    assert residency.run_with_oom_retry(flaky) == 42
    assert len(calls) == 2 and residency.oom_retries() == n0 + 1
    st = tiers.stats()
    assert "a" not in o.cache and st["entries"] == 0 and st["evictions"] == 1
    assert st["tiers"]["demotions"] == 1  # the host twin survived
    assert st["budget"] == residency.MIN_BUDGET_BYTES
    assert st["tiers"]["oomBudgetShrinks"] == 1
    # a second OOM does not shrink under the floor; a third is not retried
    calls.clear()
    assert residency.run_with_oom_retry(flaky) == 42
    assert tiers.stats()["budget"] == residency.MIN_BUDGET_BYTES

    def always():
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    calls.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        residency.run_with_oom_retry(always)
    assert len(calls) == 2


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: an illegal "
                                              "memory access"),
                                 RuntimeError("RESOURCE_EXHAUSTED"),
                                 ValueError("no")])
def test_other_errors_are_not_retried(tiers, exc):
    calls = []
    n0 = residency.oom_retries()

    def fail():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)) as got:
        residency.run_with_oom_retry(fail)
    assert got.value is exc and len(calls) == 1
    assert residency.oom_retries() == n0
    assert tiers.stats()["tiers"]["oomBudgetShrinks"] == 0


SITES = {
    # site -> (query, options, function raising once)
    "count": ("Count(Row(f=1))", {"coalesce": False, "containers": False},
              (expr, "evaluate")),
    "row": ("Row(f=1)", {"containers": False}, (expr, "evaluate")),
    "topn": ("TopN(f, Row(f=2), n=3)", {}, (expr, "evaluate")),
    "coalescer": ("Count(Row(f=1))", {}, (expr, "evaluate")),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_each_dispatch_site_recovers_from_one_oom(tiers, site,
                                                  monkeypatch):
    q, kw, (mod, name) = SITES[site]
    h, _, oracle = _build_index(3)
    ex = Executor(h, device="cpu")
    ex.coalescer = Coalescer(enabled=True, window_s=0.0, device="cpu",
                             vm=False)
    try:
        want = ex.execute("i", q, opt=_opt(**kw))
        assert tiers.stats()["entries"] > 0
        real = getattr(mod, name)
        calls = []

        def once(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return real(*a, **k)

        monkeypatch.setattr(mod, name, once)
        n0 = residency.oom_retries()
        got = ex.execute("i", q, opt=_opt(**kw))
        assert len(calls) >= 2 and residency.oom_retries() == n0 + 1
        assert [tser(r) for r in got] == [tser(r) for r in want]
        st = tiers.stats()
        assert st["tiers"]["oomBudgetShrinks"] == 1
        assert st["evictions"] > 0
    finally:
        h.close()


# ---------------------------------------------------------------- wire


QUERIES = (b"Count(Row(f=1))", b"Row(f=2)", b"TopN(f, n=2)",
           b"Count(Intersect(Row(f=1), Row(f=3)))", b"GroupBy(Rows(f))",
           b"Count(Row(f=1))", b"TopN(f, Row(f=1), n=2)")


def _load_pair(pair) -> None:
    rng = np.random.default_rng(5)
    wp.both(pair, "/index/i", b"{}")
    wp.both(pair, "/index/i/field/f", b"{}")
    for row in (1, 2, 3):
        cols = rng.choice(3 * SHARD_WIDTH, size=400, replace=False)
        wp.both(pair, "/index/i/field/f/import", json.dumps(
            {"rowIDs": [row] * len(cols),
             "columnIDs": cols.tolist()}).encode())


def _drain() -> None:
    assert prewarm.drain(timeout=30) and jprewarm.drain(timeout=30)


def test_notiers_bodies_are_byte_identical_to_the_reference(tmp_path):
    with wp.configuration():
        with wp.servers(str(tmp_path)) as pair:
            _load_pair(pair)
            _drain()
            for q in QUERIES:
                plain = wp.both(pair, "/index/i/query", q, "text/plain")
                off = wp.both(pair, "/index/i/query?notiers=1", q,
                              "text/plain")
                nc = wp.both(pair, "/index/i/query?notiers=1&nocache=1", q,
                             "text/plain")
                assert plain == off == nc, q


def test_debug_tenants_residency_half_matches_the_reference(tmp_path):
    quotas = {"gold": {"share": 2, "residency_share": 0.25}}
    with wp.configuration():
        with wp.servers(str(tmp_path), tenants_enabled=True,
                        tenants_quotas=quotas) as pair:
            _load_pair(pair)
            for t in ("gold", "t-a"):
                for q in QUERIES:
                    wp.both(pair, f"/index/i/query?tenant={t}&nocache=1", q,
                            "text/plain")
            _drain()
            docs = [json.loads(wp.req(s.uri, "/debug/tenants")[1])
                    for s in pair]
            halves = [{n: d["residency"] for n, d in doc["tenants"].items()}
                      for doc in docs]
            assert halves[1] == halves[0]
            assert halves[1]["gold"]["hbmBytes"] > 0
            assert halves[1]["gold"]["hbmQuota"] > 0
            assert halves[1]["default"]["hbmBytes"] > 0  # the prewarm's
