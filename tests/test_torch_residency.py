"""The port's tiered residency manager (pilosa_tpu_torch/runtime/
residency.py) against the JAX package's, on the CPU at the test width.

- **Manager parity**: one parametrised test drives a manager of each
  package through the same script -- admits (plain, tiered, oversized,
  replacing, tenant-charged, compressed with a kind breakout, under
  ``no_tiers``), touches, forgets, demotions, ``evict_all``,
  ``note_oom_feedback``, host-tier and disk-tier lookups, ``demote_coldest``
  and ``host_candidates`` -- with synthetic owner dicts, and after every
  step requires equal ``stats()``, equal surviving keys in every owner,
  and equal resident, host-tier and disk-tier keys in order.  The
  reference's own cases (tests/test_residency.py:24-110,
  tests/test_residency_tiers.py:57-167) are cases of it, with one seeded
  script of a few hundred random steps.
- **Product parity**: a holder of each package over the same seeded
  ``import_bits``/``import_values``, both managers at a 100 KiB budget:
  ``Count``, ``Row``, ``TopN``, ``GroupBy`` and a range ``Count`` give the
  same answers while both evict, the port's total never exceeds the
  larger of the budget and its largest entry, and the port holder's
  ``close`` brings its total back to 0.

The port's manager and [residency] config are swapped for the test and
put back (tests/torch_wire_pair.py ``residency_state``); the reference's
are reset by tests/conftest.py after every test."""

from __future__ import annotations

import json

import numpy as np
import pytest

from pilosa_tpu.models.field import FieldOptions as JFieldOptions
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.parallel.executor import ExecOptions as JOpts
from pilosa_tpu.parallel.executor import Executor as JExecutor
from pilosa_tpu.runtime import residency as jres
from pilosa_tpu.runtime import resultcache as jrc
from pilosa_tpu.serve import tenant as jten
from pilosa_tpu.server.handler import serialize_result as jser
from pilosa_tpu_torch.models.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.parallel.executor import ExecOptions as TOpts
from pilosa_tpu_torch.parallel.executor import Executor as TExecutor
from pilosa_tpu_torch.runtime import residency as tres
from pilosa_tpu_torch.serve import tenant as tten
from pilosa_tpu_torch.server.handler import serialize_result as tser
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest; another installed package is named
# ``tests``
import torch_wire_pair as wp  # noqa: E402

N_OWNERS = 4


def _entry(payload):
    """The synthetic promote closure: the owner entry is the payload
    tagged with a token slot, as a field's (gens, value)."""
    return ("tok", payload)


class _Side:
    """One package's manager and its synthetic owner dicts."""

    def __init__(self, res, ten, budget: int):
        self.res, self.ten = res, ten
        self.m = res.ResidencyManager(budget)
        self.owners = [dict() for _ in range(N_OWNERS)]
        self.ids = {id(c): i for i, c in enumerate(self.owners)}
        self.last = None

    def _eid(self, o: int, k) -> tuple:
        return (id(self.owners[o]), k)

    def _named(self, eids) -> list:
        return [(self.ids[e[0]], e[1]) for e in eids]

    def apply(self, step: tuple) -> None:
        op, a = step
        with self.res.no_tiers(a.get("notiers", False)), \
                self.ten.scope(a.get("tenant")):
            getattr(self, "op_" + op)(**{k: v for k, v in a.items()
                                         if k not in ("notiers", "tenant")})

    def op_admit(self, o: int, k, n: int, tier: bool = True,
                 token="tok", kind: str = "dense", kd=None,
                 prefetched: bool = False) -> None:
        payload = np.zeros(max(1, n // 8), dtype=np.uint64)
        c = self.owners[o]
        c[k] = ("tok", payload)
        extra = ({"token": token, "host": payload, "promote": _entry}
                 if tier else {})
        self.m.admit(c, k, n, kind=kind, kind_detail=kd,
                     prefetched=prefetched, **extra)

    def op_touch(self, o: int, k) -> None:
        self.m.touch(self.owners[o], k)

    def op_forget(self, o: int, k) -> None:
        self.owners[o].pop(k, None)
        self.m.forget(self.owners[o], k)

    def op_demote(self, o: int, k) -> None:
        self.owners[o].pop(k, None)
        self.m.demote(self.owners[o], k)

    def op_evict_all(self) -> None:
        self.last = self.m.evict_all()

    def op_oom(self) -> None:
        self.m.note_oom_feedback()

    def op_set_budget(self, n: int) -> None:
        self.m.budget = n

    def op_fallback(self) -> None:
        self.m.note_fallback()

    def op_lookup(self, o: int, k, token="tok") -> None:
        ent = self.m.host_lookup(self.owners[o], k, token)
        self.last = (None if ent is None
                     else (ent.nbytes, ent.kind, ent.tenant,
                           ent.host_value()[0]))

    def op_coldest(self, scores: dict) -> None:
        self.last = self.m.demote_coldest(
            {self._eid(o, k): s for (o, k), s in scores.items()})

    def op_candidates(self) -> None:
        self.last = [(self.ids[id(e.cache)], e.key, e.nbytes)
                     for e in self.m.host_candidates(8)]

    def op_top(self) -> None:
        self.last = [(d["bytes"], d["kind"], d.get("tenant"))
                     for d in self.m.top_entries(5)]

    def snapshot(self) -> dict:
        st = self.m.stats()
        st["tiers"]["disk"].pop("path")  # each package spills apart
        return {"stats": st, "tenants": self.m.tenant_stats(),
                "owners": [sorted(map(repr, c)) for c in self.owners],
                "resident": self._named(self.m._entries),
                "host": self._named(self.m._host),
                "disk": self._named(self.m._disk),
                "resident_eids": self._named(self.m.resident_eids()),
                "last": self.last}


def _A(o, k, n, **kw):
    return ("admit", dict(o=o, k=k, n=n, **kw))


def _seeded(seed: int = 24, n_steps: int = 400) -> list:
    """A random script over every operation (the reference's threaded
    smoke test, made one seeded order so that both managers see it)."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        o, k = int(rng.integers(N_OWNERS)), int(rng.integers(20))
        r = rng.random()
        if r < 0.45:
            kw = {}
            if rng.random() < 0.7:
                kw["token"] = ("g", int(rng.integers(3)))
            else:
                kw["tier"] = False
            if rng.random() < 0.25:
                kw["kind"] = "compressed"
                kw["kd"] = {"array": int(rng.integers(1, 50)),
                            "run": int(rng.integers(1, 50))}
            if rng.random() < 0.3:
                kw["tenant"] = ("gold", "free", "t-x")[int(rng.integers(3))]
            if rng.random() < 0.1:
                kw["notiers"] = True
            if rng.random() < 0.1:
                kw["prefetched"] = True
            steps.append(_A(o, k, int(rng.integers(1, 2000)) << 11, **kw))
            if kw.get("prefetched") and rng.random() < 0.5:
                steps.append(("touch", dict(o=o, k=k)))
        elif r < 0.6:
            steps.append(("touch", dict(o=o, k=k)))
        elif r < 0.68:
            steps.append(("forget", dict(o=o, k=k)))
        elif r < 0.76:
            steps.append(("demote", dict(o=o, k=k)))
        elif r < 0.88:
            steps.append(("lookup", dict(o=o, k=k,
                                         token=("g", int(rng.integers(3))))))
        elif r < 0.91:
            steps.append(("coldest", dict(scores={
                (int(rng.integers(N_OWNERS)), int(rng.integers(20))):
                    float(rng.random()) for _ in range(5)})))
        elif r < 0.94:
            steps.append(("candidates", {}))
        elif r < 0.96:
            steps.append(("oom", {}))
        elif r < 0.97:
            steps.append(("evict_all", {}))
        elif r < 0.985:
            steps.append(("top", {}))
        else:
            steps.append(("fallback", {}))
    return steps


TENANTS = {"gold": {"share": 2, "residency_share": 0.3},
           "free": {"share": 1, "residency_share": 0.1}}

# name -> (budget, [residency] config, tenants on, script)
CASES = {
    # tests/test_residency.py:24-110
    "admit_within_budget_keeps_all": (
        1000, {}, False, [_A(0, i, 100, tier=False) for i in range(5)]),
    "lru_eviction_across_owners": (
        250, {}, False, [_A(0, "x", 100, tier=False),
                         _A(1, "y", 100, tier=False),
                         ("touch", dict(o=0, k="x")),
                         _A(2, "z", 100, tier=False)]),
    "replacement_does_not_double_count": (
        300, {}, False, [_A(0, "k", 200, tier=False),
                         _A(0, "k", 200, tier=False)]),
    "oversized_entry_bounds_total": (
        100, {}, False, [_A(0, "small", 50), _A(1, "huge", 500),
                         _A(2, "huge2", 600), ("lookup", dict(o=1, k="huge"))]),
    "forget": (100, {}, False, [_A(0, "k", 60), ("forget", dict(o=0, k="k"))]),
    "never_evicts_entry_being_admitted": (
        100, {}, False, [_A(0, "a", 80), _A(0, "b", 90)]),
    # tests/test_residency_tiers.py:57-167
    "evict_demotes_into_host_tier": (
        250, {}, False, [_A(0, i, 100) for i in range(5)]
        + [("lookup", dict(o=0, k=0)), ("candidates", {})]),
    "host_lookup_token_mismatch_drops": (
        100, {}, False, [_A(0, "k", 80, token=("uid", 1)), _A(0, "k2", 80),
                         ("lookup", dict(o=0, k="k", token=("uid", 2))),
                         ("lookup", dict(o=0, k="k", token=("uid", 1)))]),
    "forget_drops_host_twin_demote_keeps_it": (
        1000, {}, False, [_A(0, "a", 100), _A(0, "b", 100),
                          ("forget", dict(o=0, k="a")),
                          ("lookup", dict(o=0, k="a")),
                          ("demote", dict(o=0, k="b")),
                          ("lookup", dict(o=0, k="b"))]),
    "host_budget_overflow_drops_without_disk": (
        100, {"host_budget_bytes": 250}, False,
        [_A(0, i, 100) for i in range(6)]),
    "disk_spill_round_trip": (
        100, {"host_budget_bytes": 250, "disk": True}, False,
        [_A(0, i, 100) for i in range(6)]
        + [("lookup", dict(o=0, k=0)), ("lookup", dict(o=0, k=1))]),
    "notiers_scope_disables_demotion_and_lookup": (
        100, {}, False, [_A(0, "a", 80, notiers=True),
                         _A(0, "b", 80, notiers=True),
                         ("lookup", dict(o=0, k="a", notiers=True)),
                         ("lookup", dict(o=0, k="a"))]),
    "oom_feedback_shrinks_budget_with_floor": (
        1 << 30, {}, False, [("oom", {}),
                             ("set_budget", dict(n=tres.MIN_BUDGET_BYTES)),
                             ("oom", {})]),
    "evict_all_keeps_host_twins": (
        1000, {}, False, [_A(0, "a", 100), _A(1, "b", 100, tier=False),
                          ("evict_all", {}), ("lookup", dict(o=0, k="a")),
                          ("lookup", dict(o=1, k="b"))]),
    "prefetched_entries_count_useful_once": (
        1000, {}, False, [_A(0, "a", 100, prefetched=True),
                          ("touch", dict(o=0, k="a")),
                          ("touch", dict(o=0, k="a"))]),
    "demote_coldest_takes_the_lowest_score": (
        1000, {}, False, [_A(0, "a", 100), _A(0, "b", 100),
                          _A(1, "c", 100, tier=False),
                          ("coldest", dict(scores={(0, "a"): 2.0,
                                                   (0, "b"): 1.0})),
                          ("candidates", {}),
                          ("coldest", dict(scores={}))]),
    "tenant_quota_demotes_its_own_entries": (
        1000, {}, True, [_A(0, i, 100, tenant="free") for i in range(3)]
        + [_A(1, i, 100, tenant="gold") for i in range(4)]
        + [_A(2, "d", 100), ("top", {})]),
    "compressed_kind_breakout": (
        150, {}, False, [_A(0, "p", 100, kind="compressed",
                            kd={"array": 30, "run": 20}),
                         _A(0, "q", 100), _A(0, "r", 100, kind="compressed"),
                         ("lookup", dict(o=0, k="p"))]),
    # a budget over MIN_BUDGET_BYTES, so that out-of-memory feedback
    # shrinks it
    "seeded_script": (20 << 20, {"host_budget_bytes": 24 << 20}, True,
                      _seeded()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_managers_decide_alike(case, tmp_path):
    budget, cfg, tenants, steps = CASES[case]
    was = wp.tenant_configs()
    with wp.residency_state():
        kw = {k: v for k, v in cfg.items() if k != "disk"}
        for res, sub in ((jres, "j"), (tres, "t")):
            res.configure(**kw, disk_path=(str(tmp_path / sub)
                                           if cfg.get("disk") else None))
        if tenants:
            for ten in (jten, tten):
                ten.configure(enabled=True, quotas=TENANTS)
        try:
            sides = [_Side(jres, jten, budget), _Side(tres, tten, budget)]
            for i, step in enumerate(steps):
                for s in sides:
                    s.apply(step)
                want, got = (s.snapshot() for s in sides)
                assert got == want, (case, i, step)
            if cfg.get("disk"):
                assert sides[1].m.stats()["tiers"]["diskHits"] > 0
                sides[1].m.close()
                assert not list((tmp_path / "t").glob("*.npz"))
        finally:
            wp.restore_tenant_configs(was)


def test_the_seeded_script_reaches_every_counter():
    """The seeded case is not vacuous: it evicts, demotes, hits and
    misses the host tier, shrinks the budget, charges tenant pressure
    and counts a useful prefetch."""
    was = wp.tenant_configs()
    budget, cfg, _tenants, steps = CASES["seeded_script"]
    with wp.residency_state():
        tres.configure(**cfg)
        tten.configure(enabled=True, quotas=TENANTS)
        try:
            side = _Side(tres, tten, budget)
            for step in steps:
                side.apply(step)
            st = side.m.stats()
            t = st["tiers"]
            assert st["evictions"] and t["demotions"] and t["hits"]
            assert t["misses"] and t["oomBudgetShrinks"] and t["spillDrops"]
            assert t["prefetchUseful"] and t["fallbacks"]
            assert any(d["pressure"] for d in side.m.tenant_stats().values())
        finally:
            wp.restore_tenant_configs(was)


# ------------------------------------------------------------ product

N_SHARDS = 4


def _load(h, FieldOptions) -> None:
    """Field f (rows 0-5, 300 random bits each over four shards) and int
    field v, from one seed; the port's deltas are merged so that both
    read base rows."""
    rng = np.random.default_rng(7)
    idx = h.create_index("i")
    f = idx.create_field("f")
    rows = np.repeat(np.arange(6), 300)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=len(rows))
    f.import_bits(rows, cols)
    idx.import_existence(cols)
    v = idx.create_field("v", FieldOptions.int_field(-1000, 1000))
    vcols = rng.choice(N_SHARDS * SHARD_WIDTH, size=500, replace=False)
    v.import_values(vcols, rng.integers(-1000, 1001, size=500))
    f.flush_deltas()


QUERIES = ("Count(Row(f=1))", "Row(f=2)", "Count(Intersect(Row(f=1), "
           "Row(f=3)))", "TopN(f)", "TopN(f, Row(f=0), n=3)",
           "GroupBy(Rows(f))", "Count(Row(v > 10))", "Row(-50 < v < 400)",
           "Count(Union(Row(f=4), Row(f=5)))")


def test_product_answers_alike_under_a_tiny_budget(tmp_path):
    with wp.configuration(), wp.residency_state(100 << 10) as tm:
        jres.reset(100 << 10)
        jrc.cache().enabled = False  # reset by the conftest after
        jh = JHolder(str(tmp_path / "j"))
        th = THolder(str(tmp_path / "t"), device="cpu")
        _load(jh, JFieldOptions)
        _load(th, TFieldOptions)
        jex, tex = JExecutor(jh), TExecutor(th, device="cpu")
        try:
            largest = 0
            for _ in range(3):
                for q in QUERIES:
                    want = jex.execute("i", q, opt=JOpts(mesh=False))
                    got = tex.execute("i", q, opt=TOpts(cache=False))
                    assert (json.dumps([tser(r) for r in got])
                            == json.dumps([jser(r) for r in want])), q
                    largest = max([largest] + [e[2] for e in
                                               tm._entries.values()])
                    st = tm.stats()
                    assert st["total"] <= max(st["budget"], largest), q
            assert jres.manager().evictions > 0
            assert tm.evictions > 0 and tm.stats()["tiers"]["demotions"] > 0
        finally:
            th.close()
            jh.close()
        assert tm.stats()["total"] == 0 and tm.stats()["entries"] == 0
        assert tm.stats()["tiers"]["host"]["bytes"] == 0
