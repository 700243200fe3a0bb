"""The port's background stack prewarm (pilosa_tpu_torch/runtime/
prewarm.py), the counterparts of tests/test_prewarm.py's seven tests on
a CPU holder, and one more: a closed holder leaves no running or queued
prewarm job.

- a bulk import leaves the fused path's dense stacks warm, and the first
  dense query over them builds nothing;
- a reopened holder warms in the background;
- an int field's import warms its plane stack;
- the residency budget bounds the worker, and PILOSA_TPU_PREWARM=0
  disables it;
- a deleted field is not rebuilt; a failing job is counted, not raised;
- ``Holder.close`` drops its queued jobs and waits out its running one.

Every test runs under a fresh port residency manager
(tests/torch_wire_pair.py ``residency_state``) and drains the queue at
teardown."""

from __future__ import annotations

import threading
from unittest import mock

import pytest

from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.parallel.executor import ExecOptions, Executor
from pilosa_tpu_torch.runtime import prewarm, residency
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest; another installed package is named
# ``tests``
import torch_wire_pair as wp  # noqa: E402


@pytest.fixture
def state(monkeypatch):
    with wp.residency_state() as mgr:
        monkeypatch.delenv("PILOSA_TPU_PREWARM", raising=False)
        yield mgr


@pytest.fixture
def holder(state, tmp_path):
    h = Holder(str(tmp_path / "h"), device="cpu")
    yield h
    assert prewarm.drain(timeout=30)
    h.close()


def _import_two_rows(holder, n_shards: int = 4):
    idx = holder.create_index("i")
    f = idx.create_field("f")
    rows, cols = [], []
    for row in (3, 9):
        for s in range(n_shards):
            rows.append(row)
            cols.append(s * SHARD_WIDTH + row)
    f.import_bits(rows, cols)
    return idx, f


def test_import_prewarms_fused_stacks(holder, state):
    idx, f = _import_two_rows(holder)
    assert prewarm.drain(timeout=30)
    shards = tuple(sorted(idx.available_shards()))
    # the exact keys the fused executor's dense path looks up
    assert ("row", 3, shards) in f._device_cache
    assert ("row", 9, shards) in f._device_cache
    built = prewarm.counters()["stacks_built"]
    assert built >= 2
    # the first dense query reads the warm base stacks: it builds none
    # (only the pending imports' delta overlays are new)
    keys = set(f._device_cache)
    with mock.patch.object(
            type(f), "_place_and_cache_stack",
            side_effect=AssertionError("first query rebuilt a stack")):
        got = Executor(holder, device="cpu").execute(
            "i", "Count(Intersect(Row(f=3), Row(f=9)))",
            opt=ExecOptions(containers=False, cache=False))[0]
    assert got == 0  # rows 3 and 9 share no columns
    assert {k[0] for k in set(f._device_cache) - keys} <= {"delta"}


def test_reopen_prewarms_in_background(state, tmp_path):
    path = str(tmp_path / "h")
    h = Holder(path, device="cpu")
    _import_two_rows(h)
    assert prewarm.drain(timeout=30)
    h.close()
    h2 = Holder(path, device="cpu")
    try:
        assert prewarm.drain(timeout=30)
        idx2 = h2.index("i")
        shards = tuple(sorted(idx2.available_shards()))
        assert ("row", 3, shards) in idx2.field("f")._device_cache
    finally:
        h2.close()


def test_int_field_prewarms_plane_stack(holder):
    idx = holder.create_index("i")
    v = idx.create_field("v", FieldOptions.int_field(0, 1000))
    v.import_values([1, SHARD_WIDTH + 2], [17, 400])
    assert prewarm.drain(timeout=30)
    assert any(k[0] == "planes" for k in v._device_cache)


def test_budget_bounds_prewarm(holder, state):
    state.budget = 1  # nothing fits
    before = prewarm.counters()["rows_skipped_budget"]
    idx, f = _import_two_rows(holder)
    assert prewarm.drain(timeout=30)
    assert prewarm.counters()["rows_skipped_budget"] > before
    shards = tuple(sorted(idx.available_shards()))
    assert ("row", 3, shards) not in f._device_cache


def test_env_disables_prewarm(state, tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_PREWARM", "0")
    h = Holder(str(tmp_path / "h"), device="cpu")
    try:
        idx, f = _import_two_rows(h)
        assert prewarm.drain(timeout=10)
        assert prewarm.pending() == 0
        shards = tuple(sorted(idx.available_shards()))
        assert ("row", 3, shards) not in f._device_cache
    finally:
        h.close()


def test_prewarm_skips_deleted_field(holder, state):
    idx, f = _import_two_rows(holder)
    assert prewarm.drain(timeout=30)
    state.forget_owner(f._device_cache)
    f._device_cache.clear()
    # hold the worker at the job boundary while the delete lands
    release = threading.Event()
    orig = type(idx).available_shards

    def slow_shards(self):
        release.wait(timeout=30)
        return orig(self)

    before = prewarm.counters()["stacks_built"]
    with mock.patch.object(type(idx), "available_shards", slow_shards):
        prewarm.enqueue(idx, f, [3, 9])
        idx.delete_field("f")
        release.set()
        assert prewarm.drain(timeout=30)
    assert prewarm.counters()["stacks_built"] == before
    assert not f._device_cache


def test_prewarm_failure_is_survivable_and_counted(holder):
    idx = holder.create_index("i")
    f = idx.create_field("f")

    class _BoomIndex:
        fields = {f.name: f}  # passes the liveness check

        def available_shards(self):
            raise RuntimeError("injected")

    before = prewarm.counters()["jobs_failed"]
    prewarm.enqueue(_BoomIndex(), f, [1])
    assert prewarm.drain(timeout=10)
    assert prewarm.counters()["jobs_failed"] == before + 1


def test_a_closed_holder_leaves_no_running_or_queued_job(state, tmp_path):
    h = Holder(str(tmp_path / "h"), device="cpu")
    idx, f = _import_two_rows(h)
    g = idx.create_field("g")
    assert prewarm.drain(timeout=30)
    entered, release = threading.Event(), threading.Event()
    orig = type(idx).available_shards

    def slow_shards(self):
        entered.set()
        release.wait(timeout=30)
        return orig(self)

    before = prewarm.counters()["stacks_built"]
    with mock.patch.object(type(idx), "available_shards", slow_shards):
        prewarm.enqueue(idx, f, [3, 9])  # runs, held at its boundary
        assert entered.wait(10)
        prewarm.enqueue(idx, g, [1])  # queued behind it
        assert prewarm.pending() == 2
        closer = threading.Thread(target=h.close)
        closer.start()
        # close drops the queued job at once, then waits for the running
        # one, which stops before building anything
        tick = threading.Event()
        for _ in range(500):
            if prewarm.pending() == 1:
                break
            tick.wait(0.01)
        assert prewarm.pending() == 1 and closer.is_alive()
        release.set()
        closer.join(30)
    assert not closer.is_alive()
    assert prewarm.pending() == 0
    assert prewarm.counters()["stacks_built"] == before
    assert prewarm.drain(timeout=10)
    assert prewarm._worker is None
    st = residency.manager().stats()
    assert (st["total"], st["entries"]) == (0, 0)
