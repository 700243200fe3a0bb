"""The port's streaming-ingest core (pilosa_tpu_torch/ingest) against the
JAX package's (pilosa_tpu/ingest), on the CPU, with zero tolerance:

- ``DeltaPlane``: the same seeded sequences of ``add_bit`` and
  ``add_positions`` (sets and clears, duplicates, rows in any order) give
  equal set and clear planes, ``row_seq``, ``bits``, ``nbytes`` and
  ``stats()``, equal ``override``/``apply_row``/``row_any`` answers, and
  planes that stay disjoint;
- ``Compactor``: the same writes to mirrored fragments on a fake clock
  give the same budget verdicts (``note_delta``), the same size, age and
  budget triggers in ``run_once``, the same totals and the same
  ``debug()`` document;
- the configuration: the port defaults to the reference's [ingest]
  settings with deltas on, and its baseline is captured once and
  restored once.

Every fixture restores exactly the process-wide fields it sets: both
packages' [ingest] configs.  The compactors here are private instances.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from pilosa_tpu import ingest as jingest
from pilosa_tpu.ingest import compactor as jcompactor
from pilosa_tpu.ingest import deltaplane as jdp
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.ingest import compactor as tcompactor
from pilosa_tpu_torch.ingest import deltaplane as tdp

N_WORDS = 64
WIDTH = N_WORDS * 32
_SLOTS = ("delta_enabled", "delta_budget_bytes", "compact_threshold_bits",
          "compact_interval")


class _Clock:
    """A fake ``time`` module for both deltaplane modules."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jdp, "time", c)
    monkeypatch.setattr(tdp, "time", c)
    return c


@pytest.fixture
def configs():
    """Both [ingest] configs, restored to exactly what they were."""
    jwas = {k: getattr(jingest.config(), k) for k in _SLOTS}
    twas = {k: getattr(tingest.config(), k) for k in _SLOTS}
    jbase, tbase = jingest._baseline, tingest._baseline
    yield
    jingest.configure(**jwas)
    tingest.configure(**twas)
    jingest._baseline, tingest._baseline = jbase, tbase


def _planes_equal(jp, tp) -> None:
    for name in ("sets", "clears"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert list(a) == list(b), name
        for r in a:
            assert a[r].dtype == b[r].dtype == np.uint32
            assert np.array_equal(a[r], b[r]), (name, r)
    assert jp.row_seq == tp.row_seq
    assert (jp.bits, jp.nbytes, jp.empty()) == (tp.bits, tp.nbytes,
                                                tp.empty())
    assert jp.stats() == tp.stats()
    tp.check()


def _write(rng, planes, seq: int) -> None:
    """One random write, the same on every plane."""
    clear = bool(rng.random() < 0.4)
    if rng.random() < 0.3:
        row, off = int(rng.integers(0, 6)), int(rng.integers(0, WIDTH))
        for p in planes:
            p.add_bit(row, off, clear, seq)
        return
    n = int(rng.integers(0, 400))
    rows = rng.integers(0, 6, size=n)
    offs = rng.integers(0, WIDTH, size=n)
    if n and rng.random() < 0.3:
        offs[: n // 2] = offs[0]  # duplicates within one word
    pos = (rows * WIDTH + offs).astype(np.uint64)
    for p in planes:
        p.add_positions(pos.copy(), clear, seq)


@pytest.mark.parametrize("seed", range(6))
def test_random_writes_build_equal_planes(clock, seed):
    rng = np.random.default_rng(seed)
    jp, tp = jdp.DeltaPlane(N_WORDS, WIDTH), tdp.DeltaPlane(N_WORDS, WIDTH)
    _planes_equal(jp, tp)
    for seq in range(1, 40):
        _write(rng, (jp, tp), seq)
        clock.t += float(rng.random())
        _planes_equal(jp, tp)
    base = rng.integers(0, 2 ** 32, size=N_WORDS, dtype=np.uint32)
    for row in range(7):
        a, b = base.copy(), base.copy()
        jp.apply_row(row, a)
        tp.apply_row(row, b)
        assert np.array_equal(a, b)
        for words in (None, np.zeros(N_WORDS, np.uint32), base):
            assert jp.row_any(row, words) == tp.row_any(row, words)
        for off in rng.integers(0, WIDTH, size=64).tolist():
            assert jp.override(row, off) == tp.override(row, off)


def test_later_writes_win_and_the_planes_stay_disjoint(clock):
    tp = tdp.DeltaPlane(N_WORDS, WIDTH)
    tp.add_bit(2, 5, False, 1)
    tp.add_positions(np.array([2 * WIDTH + 5, 2 * WIDTH + 6], np.uint64),
                     True, 2)
    assert tp.override(2, 5) is False and tp.override(2, 6) is False
    tp.add_bit(2, 6, False, 3)
    assert tp.override(2, 6) is True and tp.override(2, 7) is None
    assert tp.row_seq == {2: 3} and tp.bits == 4
    tp.check()
    arr = np.full(N_WORDS, 0xFFFFFFFF, np.uint32)
    tp.apply_row(2, arr)
    assert arr[0] == np.uint32(0xFFFFFFFF & ~(1 << 5))


class _Frag:
    """A fragment as the compactor sees it: a delta plane, a lock, a
    delta sequence and a ``flush_delta`` that reports to ``comp``."""

    def __init__(self, dp, comp, shard: int) -> None:
        self._dp, self._comp = dp, comp
        self.index, self.field, self.view, self.shard = "i", "f", \
            "standard", shard
        self._lock = threading.RLock()
        self._delta = None
        self._delta_seq = 0
        self.flushed = 0

    def write(self, pos: np.ndarray) -> bool:
        with self._lock:
            if self._delta is None:
                self._delta = self._dp.DeltaPlane(N_WORDS, WIDTH)
            self._delta_seq += 1
            self._delta.add_positions(pos, False, self._delta_seq)
            return self._comp.note_delta(self)

    def flush_delta(self) -> int:
        with self._lock:
            d = self._delta
            self._delta = None
            if d is None or d.empty():
                return 0
            self.flushed += 1
            self._comp.note_flushed(self, d.bits)
            return d.bits


def _doc(comp) -> dict:
    d = comp.debug()
    for e in d["top"]:
        e.pop("ageS")
    return d


def test_compactor_triggers_match_the_reference_on_a_fake_clock(
        clock, configs):
    # size: 300 pending positions; age: one 5 s interval; budget: eight
    # touched rows' planes (8 * 4 * N_WORDS bytes)
    budget = 8 * 4 * N_WORDS
    for mod in (jingest, tingest):
        mod.configure(delta_enabled=True, delta_budget_bytes=budget,
                      compact_threshold_bits=300, compact_interval=5.0)
    jc, tc = jcompactor.Compactor(), tcompactor.Compactor()
    jf = [_Frag(jdp, jc, s) for s in range(4)]
    tf = [_Frag(tdp, tc, s) for s in range(4)]
    rng = np.random.default_rng(7)
    seen = {"size": 0, "age": 0, "budget": 0}
    for step in range(60):
        s = int(rng.integers(0, 4))
        n = int(rng.integers(1, 200))
        rows = rng.integers(0, 3, size=n)
        pos = (rows * WIDTH + rng.integers(0, WIDTH, size=n)).astype(
            np.uint64)
        over = jf[s].write(pos.copy())
        assert tf[s].write(pos.copy()) == over
        if over:  # the writer flushes its own fragment inline
            seen["budget"] += 1
            assert jf[s].flush_delta() == tf[s].flush_delta()
        clock.t += float(rng.random() * 2)
        if step % 5 == 4:
            due = [f._delta is not None and (
                f._delta.bits >= 300 and "size" or
                f._delta.age_s() >= 5.0 and "age") for f in tf]
            for why in due:
                if why:
                    seen[why] += 1
            assert jc.run_once() == tc.run_once()
            assert [f.flushed for f in jf] == [f.flushed for f in tf]
        jd, td = _doc(jc), _doc(tc)
        assert td == jd
    assert all(seen.values()), seen
    assert jc.run_once(force=True) == tc.run_once(force=True)
    assert _doc(tc) == _doc(jc)
    assert tc.totals()["fragmentsPending"] == 0


class _Racy(_Frag):
    """A fragment whose scan loses both races of the reference's review
    fix: a reader flushes it just before the compactor does (so the
    compactor's flush merges nothing), and a writer lands just after."""

    def flush_delta(self) -> int:
        super().flush_delta()  # the reader's flush
        n = super().flush_delta()  # the compactor's: nothing left
        self.write(np.array([9], np.uint64))  # the writer
        return n


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_forget_only_while_the_delta_is_still_empty(clock, configs, pkg):
    dp, mod, comp = ((jdp, jingest, jcompactor.Compactor()) if pkg == "jax"
                     else (tdp, tingest, tcompactor.Compactor()))
    mod.configure(delta_budget_bytes=1 << 30, compact_interval=5.0)
    fr = _Racy(dp, comp, 0)
    fr.write(np.array([1], np.uint64))
    assert comp.run_once(force=True) == 0
    # the writer's delta stays registered: the next scan merges it
    assert [f for f, _ in comp.pending()] == [fr]
    assert comp.totals()["pendingBits"] == 1


def test_the_port_defaults_to_the_reference_configuration(configs):
    from pilosa_tpu import config as jconfig

    cfg = tingest.IngestConfig()
    ref = jconfig.Config().ingest
    assert cfg.delta_enabled is True is ref.delta_enabled
    assert (cfg.delta_budget_bytes, cfg.compact_threshold_bits,
            cfg.compact_interval) == (ref.delta_budget_bytes,
                                      ref.compact_threshold_bits,
                                      ref.compact_interval)
    was = {k: getattr(tingest.config(), k) for k in _SLOTS}
    tingest._baseline = None
    tingest.capture_baseline()
    tingest.configure(delta_enabled=not was["delta_enabled"],
                      compact_interval=99.0)
    tingest.capture_baseline()  # a second server: the first one's holds
    tingest.restore_baseline()
    assert {k: getattr(tingest.config(), k) for k in _SLOTS} == was
    tingest.restore_baseline()  # released: a no-op
    assert tingest._baseline is None
