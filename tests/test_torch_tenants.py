"""Per-tenant isolation ([tenants]): the port's serve/tenant.py,
the tenant layer of serve/admission.py and the result cache's tenant
budgets against the JAX package's, on the CPU, mesh off.

- quota specs, ``configure``, ``clean``, ``resolve`` and the
  individuation bound, with the same outcomes and messages;
- controllers with [tenants] on driven through the same scripts
  (tests/torch_admission_script.py): shares inside a class, per-tenant
  queues and ``tenant-queue-full``, the deficit-round-robin order of a
  weighted drain, an expiry in a tenant's queue, the deadline-unmeetable
  floor of a tenant's queue-wait EWMA, and the unweighted drain after
  [tenants] is turned off with waiters queued;
- the result caches: per-tenant accounting and the eviction that
  prefers an over-budget tenant's own entries (``tenantPrefEvictions``),
  and none of it with [tenants] off;
- a JAX ``Server`` and a port ``Server`` with ``tenants_enabled`` side
  by side (tests/torch_wire_pair.py): ``X-Pilosa-Tenant`` and
  ``?tenant=``, a 429 ``tenant-queue-full`` with the tenant on its body,
  ``/debug/admission`` with its tenants, ``/debug/tenants`` with its
  residency half (each package's background prewarm drained first) and
  the restore of the [tenants] config on close.

Every fixture restores exactly the process-wide settings it touches:
both packages' [tenants] configs, field by field."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from pilosa_tpu import stats as jstats
from pilosa_tpu.runtime import prewarm as jprewarm
from pilosa_tpu.runtime import resultcache as jrc
from pilosa_tpu.serve import admission as jadm
from pilosa_tpu.serve import deadline as jdl
from pilosa_tpu.serve import tenant as jten
from pilosa_tpu_torch.runtime import prewarm as tprewarm
from pilosa_tpu_torch.runtime import resultcache as trc
from pilosa_tpu_torch.serve import admission as tadm
from pilosa_tpu_torch.serve import deadline as tdl
from pilosa_tpu_torch.serve import tenant as tten
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest; another installed package is named
# ``tests``
import torch_admission_script as script  # noqa: E402
import torch_wire_pair as wp  # noqa: E402

QUOTAS = {"gold": {"share": 2, "queue": 4, "cache-share": 0.5},
          "free": {"share": 1, "queue": 1, "cache_share": 0.1,
                   "residency_share": 0.2}}


@pytest.fixture
def tenant_configs():
    """Both packages' [tenants] configs restored field by field."""
    was = wp.tenant_configs()
    yield
    wp.restore_tenant_configs(was)


@pytest.fixture
def tenants_on(tenant_configs):
    """[tenants] on in both packages: default share 1, queue 2, and the
    gold and free quotas."""
    for m in (jten, tten):
        m.configure(enabled=True, default_share=1, default_queue=2,
                    default_cache_share=0.25,
                    default_residency_share=0.5, quotas=QUOTAS)
        m.config().seen = set()


# ------------------------------------------------------------ policy


def _outcome(fn):
    try:
        out = fn()
    except ValueError as e:
        return ("ValueError", str(e))
    if isinstance(out, dict):
        return {k: vars(v) if hasattr(v, "__dict__") else repr(v)
                for k, v in out.items()}
    return repr(out)


@pytest.mark.parametrize("spec", [
    "gold:16:64:0.5,free:2:8", "a:1", " b:3:0 , ", "c:2:5:0.1:0.9",
    "x", ":3", "d:0", "e:2:-1", "f:two", "g:1:2:3:4:5", "", ",,"])
def test_quota_specs_parse_as_the_reference(spec):
    assert _outcome(lambda: tten.parse_quota_spec(spec)) == \
        _outcome(lambda: jten.parse_quota_spec(spec))


@pytest.mark.parametrize("kw", [
    {"enabled": True, "default_share": 3, "default_queue": 0},
    {"quotas": QUOTAS},
    {"quotas": {"z": {"share": 1, "bogus": 2}}},
    {"quotas": {"z": [1, 2]}},
    {"default_share": 0},
    {"default_queue": -1},
    {"quotas": {"z": tten.TenantQuota(share=5)}}])
def test_configure_matches_the_reference(tenant_configs, kw):
    def run(m):
        jkw = dict(kw)
        q = jkw.get("quotas")
        if q and isinstance(next(iter(q.values())), tten.TenantQuota):
            jkw["quotas"] = {n: m.TenantQuota(**vars(x))
                             for n, x in q.items()}

        def go():
            c = m.configure(**jkw)
            return (c.enabled, vars(c.default_quota),
                    {n: vars(x) for n, x in c.quotas.items()})
        return _outcome(go)

    assert run(tten) == run(jten)


def test_labels_clean_and_resolve_as_the_reference(tenants_on):
    labels = [None, "", "   ", " acme ", "x" * 100, "gold", "default"]
    for lab in labels:
        assert tten.clean(lab) == jten.clean(lab)
    # the individuation bound: past it, new unconfigured labels share the
    # default tier; configured ones and those seen stay themselves
    for m in (jten, tten):
        m.config().seen = {f"s{i}" for i in range(m.MAX_TRACKED_TENANTS - 1)}
    for lab in (None, "gold", "new1", "new2", "s3", "default", "free"):
        assert tten.resolve(lab) == jten.resolve(lab)
    assert tten.resolve("new3") == "default"
    assert tten.config().seen == jten.config().seen
    for m in (jten, tten):
        m.config().enabled = False
    assert tten.resolve("zzz") == jten.resolve("zzz") == "zzz"
    assert tten.policy() is None and jten.policy() is None


def test_the_scope_is_per_thread():
    out = []
    with tten.scope("acme"):
        out.append(tten.current())
        with tten.scope(None):
            out.append(tten.current())
        t = threading.Thread(target=lambda: out.append(tten.current()))
        t.start()
        t.join(10)
    out.append(tten.current())
    assert out == ["acme", None, None, None]


# -------------------------------------------------------- controllers


def _shares(r):
    """cap 3: acme (default share 1, queue 2), gold (share 2, queue 4)."""
    r.acquire("a1", "query", tenant="acme")
    r.queue("a2", "query", tenant="acme")  # acme at its share
    r.acquire("g1", "query", tenant="gold")
    r.acquire("g2", "query", tenant="gold")  # the class full now
    r.queue("g3", "query", tenant="gold")
    r.queue("a3", "query", tenant="acme")
    r.acquire("a4", "query", tenant="acme")  # acme's queue full: 429
    r.acquire("f_dl", "query", budget=0.0, tenant="free")
    r.debug()
    r.tenants_debug()
    r.release("a1")
    r.admit_next(release=False)
    r.release("g1")
    r.admit_next(release=False)
    r.release("g2")  # a free slot, but acme is at its share
    r.debug()
    r.release("a2")
    r.admit_next(release=False)
    r.tenants_debug()


def _drr(r):
    """cap 1: gold (weight 2) and free (weight 1) drain in proportion."""
    r.acquire("hold", "query", tenant="x")
    for i in range(4):
        r.queue(f"g{i}", "query", tenant="gold")
    r.queue("f0", "query", tenant="free")
    r.queue("d0", "query")  # anonymous: the default tier
    r.queue("d1", "query")
    r.debug()
    r.release("hold")
    for _ in range(7):
        r.admit_next()
    r.tenants_debug()


def _tenant_queue_full(r):
    """ingest cap 2: free (share 1, queue 1) sheds past its own queue
    while the class still has room for gold."""
    r.acquire("hold", "ingest", tenant="free")
    r.queue("f1", "ingest", tenant="free")
    r.acquire("f2", "ingest", tenant="free")
    r.acquire("f3", "ingest", tenant="free", budget=30.0)
    r.acquire("g1", "ingest", tenant="gold")
    r.debug()
    r.release("hold")
    r.join("f1")


def _expiry_in_a_tenant_queue(r):
    r.acquire("hold", "query", tenant="gold")
    r.acquire("hold2", "query", tenant="gold")
    r.queue("short", "query", tenant="gold", budget=0.2)
    r.queue("long", "query", tenant="gold", budget=30.0)
    r.join("short")
    r.tenants_debug()
    r.release("hold")
    r.join("long")


def _unmeetable_floor(r):
    r.ctrl._gates["query"].ewma_service_s = 2.5
    r.acquire("hold", "query", tenant="gold")
    r.acquire("hold2", "query", tenant="gold")
    # (0 + 1) x 2.5 s / share 2 = 1.25 s > 1 s
    r.acquire("tight", "query", tenant="gold", budget=1.0)
    r.acquire("roomy_other", "query", tenant="acme", budget=1.0)
    r.debug()


def _turned_off(r):
    r.acquire("hold", "query", tenant="gold")
    r.acquire("hold2", "query", tenant="gold")
    r.queue("g", "query", tenant="gold")
    r.queue("f", "query", tenant="free")
    r.tenant.config().enabled = False  # waiters still queued
    r.release("hold")
    r.admit_next()
    r.release("hold2")
    r.admit_next()
    r.debug()
    r.tenant.config().enabled = True


def _try_and_internal(r):
    r.acquire("q", "query", tenant="gold")
    r.acquire("q2", "query", tenant="gold")
    r.queue("q3", "query", tenant="gold")
    r.queue("q4", "query", tenant="acme")
    r.try_acquire("bg", "internal")  # query pressure: yields
    r.acquire("bg2", "internal", tenant="free")
    r.debug()
    r.release("q")
    r.join("q3")
    r.release("q2")
    r.join("q4")


TSCRIPTS = {
    "shares": (_shares, {"query_cap": 3, "query_queue": 8}),
    "drr": (_drr, {"query_cap": 1, "query_queue": 16}),
    "tenant_queue_full": (_tenant_queue_full, {"ingest_cap": 2,
                                               "ingest_queue": 8}),
    "expiry_in_a_tenant_queue": (_expiry_in_a_tenant_queue,
                                 {"query_cap": 4}),
    "unmeetable_floor": (_unmeetable_floor, {"query_cap": 4}),
    "turned_off": (_turned_off, {"query_cap": 2, "query_queue": 8}),
    "try_and_internal": (_try_and_internal, {"query_cap": 2,
                                             "query_queue": 3}),
}


@pytest.mark.parametrize("name", sorted(TSCRIPTS))
def test_tenant_scripts_match_the_reference(tenants_on, name):
    fn, kw = TSCRIPTS[name]
    (want, want_order), (got, got_order) = script.run_both(fn, [
        (jadm, jdl, jadm.AdmissionController(
            stats=jstats.MemStatsClient(), **kw)),
        (tadm, tdl, tadm.AdmissionController(**kw))])
    assert got == want
    assert got_order == want_order


def test_a_weighted_drain_follows_the_shares(tenants_on):
    """Against the arithmetic itself: gold (share 2) gets two of every
    three freed slots while both queues hold waiters."""
    fn, kw = TSCRIPTS["drr"]
    (_log, order), = script.run_both(
        fn, [(tadm, tdl, tadm.AdmissionController(**kw))])
    assert order[:3] in (["g0", "g1", "f0"], ["f0", "g0", "g1"])
    assert sorted(order) == ["d0", "d1", "f0", "g0", "g1", "g2", "g3"]


# ------------------------------------------------------ result caches


def _cache_script(mod, tenants: bool) -> dict:
    """Puts and gets under three tenants into a 4096-byte cache; free
    (cache share 0.1) churns past its soft budget."""
    c = mod.ResultCache(budget_bytes=4096, max_entry_bytes=4096)
    log = []
    for i in range(3):
        c.put(("g", i), 1, i, 400, tenant="gold")
    c.put(("a", 0), 1, 0, 300)  # the thread's scope: none
    with (tten if mod is trc else jten).scope("acme"):
        c.put(("a", 1), 1, 1, 300)
        log.append(c.get(("g", 0), 1, 0.0))
        log.append(c.get(("zz", 0), 1, 0.0))
    for i in range(8):
        c.put(("f", i), 1, i, 500, tenant="free")
        log.append(sorted(map(repr, (k for k in c._entries))))
    log.append(c.get(("f", 7), 1, 0.0, tenant="free"))
    log.append(c.get(("f", 7), 2, 0.0, tenant="free"))  # a stale stamp
    st = c.stats_dict()
    dbg = c.debug()
    dbg.pop("top")
    return {"log": log, "stats": st, "tenants": c.tenant_stats(),
            "debug": dbg, "pref": c.tenant_pref_evictions,
            "invalidated": c.invalidate_all(),
            "after": c.tenant_stats()}


def test_the_cache_prefers_an_over_budget_tenants_entries(tenants_on):
    want = _cache_script(jrc, True)
    got = _cache_script(trc, True)
    assert got == want
    assert got["pref"] > 0
    assert got["tenants"]["free"]["evictions"] > 0
    assert got["tenants"]["gold"]["evictions"] == 0
    assert set(got["tenants"]) == {"acme", "default", "free", "gold"}


def test_with_tenants_off_the_cache_keeps_one_lru(tenant_configs):
    for m in (jten, tten):
        m.config().enabled = False
    want = _cache_script(jrc, False)
    got = _cache_script(trc, False)
    assert got == want
    assert got["pref"] == 0 and got["tenants"] == {}
    assert "tenants" not in got["debug"]


def test_invalidate_index_untracks_tenant_bytes(tenants_on):
    c = trc.ResultCache()
    c.put(trc.Key((1, "i", "count")), 1, 5, 32, tenant="gold")
    c.put(trc.Key((1, "j", "count")), 1, 6, 32, tenant="gold")
    assert c.invalidate_index(1, "i") == 1
    st = c.tenant_stats()["gold"]
    assert (st["bytes"], st["entries"], st["fills"]) == (288, 1, 2)


# ------------------------------------------------------------ servers


_COUNTERS = ("hits", "misses", "fills", "evictions")


def cache_bases() -> tuple:
    """Both process-wide result caches' tenant accounting now, the port's
    emptied first: the caches outlive a test (the JAX package's is reset
    after each), so ``/debug/tenants`` compares from here."""
    trc.cache().invalidate_all()
    return jrc.cache().tenant_stats(), trc.cache().tenant_stats()


def _tenant_doc(server, base: dict) -> dict:
    """``/debug/tenants`` with its cache counters taken from ``base`` on,
    and the tenants this test did not touch left out.  Both packages'
    background prewarm is drained first, so that the residency half holds
    every stack it will build."""
    assert tprewarm.drain(timeout=30) and jprewarm.drain(timeout=30)
    st, _ra, body = script.req(server.uri, "/debug/tenants")
    assert st == 200
    doc = json.loads(body)
    for name, d in list(doc["tenants"].items()):
        c, b = d["cache"], base.get(name)
        if c is not None and b is not None:
            for k in _COUNTERS:
                c[k] -= b[k]
        if c is not None and not any(
                c[k] for k in ("bytes", "entries") + _COUNTERS):
            d["cache"] = None
        if (d["admission"] is None and d["cache"] is None
                and d["residency"] is None):
            del doc["tenants"][name]
    return script.scrub(doc)


def test_tenant_requests_answer_as_the_reference(ta_pair_tenants):
    pair, name, bases = ta_pair_tenants
    for body in script.ADMITTED:
        for h, q in (({"X-Pilosa-Tenant": name}, ""),
                     ({}, f"?tenant={name}"),
                     ({"X-Pilosa-Tenant": "gold"}, f"?tenant={name}"),
                     ({}, "")):
            assert script.same(pair, "/index/i/query" + q, body, h)[0] == 200
    assert script.same(pair, "/index/i/field/f/import",
                   b'{"rowIDs": [6], "columnIDs": [9]}',
                   {"X-Pilosa-Tenant": "free"}, "application/json")[0] == 200
    script.quiet(pair)
    doc = _tenant_doc(pair[1], bases[1])
    assert doc == _tenant_doc(pair[0], bases[0])
    assert doc["enabled"] is True
    assert doc["tenants"][name]["admission"]["admitted"] == \
        2 * len(script.ADMITTED)
    assert doc["tenants"][name]["cache"]["fills"] > 0
    assert doc["tenants"]["gold"]["admission"]["admitted"] == \
        len(script.ADMITTED)
    assert script.admission_doc(pair[1]) == script.admission_doc(pair[0])


def test_a_tenant_over_its_queue_gets_429_with_its_name(ta_pair_tenants):
    pair, _name, bases = ta_pair_tenants
    held = script.hold(pair, "query", tenant="free")
    ts, res = script.queued(pair, "/index/i/query?tenant=free",
                         b"Count(Row(f=1))", "text/plain")
    st, ra, out = script.same(pair, "/index/i/query", b"Count(Row(f=1))",
                          {"X-Pilosa-Tenant": "free"})
    assert (st, ra) == (429, "1")
    assert json.loads(out) == {
        "error": "query request tenant-queue-full (tenant free) (admission "
                 "control; retry after 1s)",
        "reason": "tenant-queue-full", "class": "query", "tenant": "free"}
    # another tenant is not held back by free's quota
    assert script.same(pair, "/index/i/query", b"Count(Row(f=2))",
                   {"X-Pilosa-Tenant": "gold"})[0] == 200
    # an expired request of a tenant names it
    st, ra, out = script.same(pair, "/index/i/query", b"Count(Row(f=2))",
                          {"X-Pilosa-Tenant": "gold",
                           "X-Pilosa-Deadline": "0"})
    assert (st, json.loads(out)["tenant"]) == (503, "gold")
    script.quiet(pair, held=1)
    assert script.admission_doc(pair[1]) == script.admission_doc(pair[0])
    assert (_tenant_doc(pair[1], bases[1])
            == _tenant_doc(pair[0], bases[0]))
    for t in held:
        t.release()
    for t in ts:
        t.join(30)
    assert res[1] == res[0] and res[0][0] == 200
    script.quiet(pair)
    assert (_tenant_doc(pair[1], bases[1])
            == _tenant_doc(pair[0], bases[0]))


@pytest.fixture
def ta_pair_tenants(tmp_path):
    """A server pair with [tenants] on (default share 1, queue 2, the gold
    and free quotas), and a tenant name of this test's own."""
    with wp.configuration():
        with wp.servers(str(tmp_path), tenants_enabled=True,
                        tenants_default_share=1, tenants_default_queue=2,
                        tenants_quotas=QUOTAS) as pair:
            script.setup(pair, SHARD_WIDTH)
            yield pair, f"t-{tmp_path.name}"[:60], cache_bases()


def test_servers_restore_the_tenant_config_on_close(tmp_path):
    with wp.configuration():
        before = wp.tenant_configs()
        with wp.servers(str(tmp_path), tenants_enabled=True,
                        tenants_quotas=QUOTAS) as pair:
            for m in (jten, tten):
                assert m.config().enabled is True
                assert set(m.config().quotas) == {"gold", "free"}
            bases = cache_bases()
            script.setup(pair, SHARD_WIDTH)
            st, _ra, body = script.req(pair[1].uri, "/debug/tenants")
            assert json.loads(body)["quotas"]["free"] == {
                "share": 1, "queue": 1, "cacheShare": 0.1,
                "residencyShare": 0.2}
            script.quiet(pair)
            assert (_tenant_doc(pair[1], bases[1])
                    == _tenant_doc(pair[0], bases[0]))
        after = wp.tenant_configs()
        for b, a in zip(before, after):
            assert (a["enabled"], a["default_quota"], a["quotas"]) == \
                (b["enabled"], b["default_quota"], b["quotas"])


def test_a_reopened_server_applies_its_tenant_knobs_again(tmp_path):
    from pilosa_tpu_torch.server.server import Server

    with wp.configuration():
        s = Server(str(tmp_path / "t"), device="cpu", tenants_enabled=True,
                   tenants_default_share=3)
        s.open()
        s.close()
        assert tten.config().enabled is False
        s.open()
        try:
            assert tten.config().enabled is True
            assert tten.config().default_quota.share == 3
        finally:
            s.close()
            s.close()  # idempotent
        assert tten.config().enabled is False
        assert tten.refs() == 0


def test_cache_fills_charge_the_coalesced_members_tenants(tenants_on,
                                                          tmp_path):
    """The coalescer fills each member's key charged to the member's own
    tenant, as the reference's does."""
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.parallel.coalescer import Coalescer
    from pilosa_tpu_torch.parallel.executor import ExecOptions, Executor
    h = Holder(str(tmp_path / "h"), device="cpu")
    try:
        idx = h.create_index("i")
        f = idx.create_field("f")
        rng = np.random.default_rng(3)
        for r in (1, 2):
            cols = rng.choice(2 * SHARD_WIDTH, 5000, replace=False)
            f.import_bits(np.full(len(cols), r), cols)
        f.flush_deltas()
        ex = Executor(h, device="cpu")
        ex.coalescer = Coalescer(window_s=0.3, max_batch=2, enabled=True)
        before = trc.cache().tenant_stats()
        names = [f"c-{tmp_path.name}-{i}"[:60] for i in range(2)]
        qs = ["Count(Intersect(Row(f=1), Row(f=2)))",
              "Count(Union(Row(f=1), Row(f=2)))"]
        bar = threading.Barrier(2)

        def run(i):
            bar.wait()
            ex.execute("i", qs[i], opt=ExecOptions(tenant=names[i]))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        after = trc.cache().tenant_stats()
        for n in names:
            assert n not in before
            assert (after[n]["fills"], after[n]["entries"],
                    after[n]["misses"]) == (1, 1, 1)
    finally:
        h.close()
