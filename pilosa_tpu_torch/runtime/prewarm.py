"""Background stack prewarm: take the cold build off the first query.

Copy of pilosa_tpu/runtime/prewarm.py.  The fused executor path reads
device row stacks and BSI plane stacks that are assembled on first touch
(the host union of every shard's row, then its upload to the card).
Bulk imports and holder open enqueue the touched field and rows; one
background worker assembles exactly the (row, shards) stacks the fused
path looks up, so the first query finds them on the card.  The worker is
bounded:

  - residency budget: a stack is only built while the tracked total stays
    under BUDGET_FRACTION of the budget (eviction churn would defeat the
    point);
  - ROW_CAP rows per job, most-frequent first (a bulk import naming 10k
    distinct rows must not LRU-thrash the cache with 10k stacks);
  - stacks build through the normal Field entry points, so upload,
    caching and invalidation are the product path, not a parallel one.

``PILOSA_TPU_PREWARM=0`` (the variable the reference reads) disables
enqueueing.

The port's worker thread is a daemon that exits as soon as the queue is
empty (the next ``enqueue`` starts another), and :func:`cancel` drops a
closing holder's queued jobs and waits out its running one, so that no
prewarm work outlives its holder's ``close``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from pilosa_tpu_torch import logger as _logger

ROW_CAP = 128          # stacks per prewarm job, most-frequent rows first
BUDGET_FRACTION = 0.75  # stop building while residency usage is above this
QUEUE_DEPTH = 256

_lock = threading.Lock()
_idle = threading.Condition(_lock)
_jobs: deque = deque()  # (index, field, rows) queued, not started
_running = None  # the job the worker runs now
_worker: threading.Thread | None = None
_inflight = 0  # queued + running
_pending: set[tuple] = set()  # (id(index), field name) queued
_cancelled: set[int] = set()  # id(index) of holders closing now

_counters = {
    "stacks_built": 0,
    "rows_skipped_budget": 0,
    "jobs_failed": 0,
}

log: _logger.Logger = _logger.StandardLogger()


def enabled() -> bool:
    return os.environ.get("PILOSA_TPU_PREWARM", "1") != "0"


def bump(name: str, value: int = 1) -> None:
    with _lock:
        _counters[name] += value


def counters() -> dict:
    with _lock:
        return dict(_counters)


def _headroom_ok(extra_bytes: int) -> bool:
    from pilosa_tpu_torch.runtime import residency

    mgr = residency.manager()
    return mgr.total + extra_bytes <= mgr.budget * BUDGET_FRACTION


def _job_rows(field, rows) -> list[int]:
    """The rows to warm.  Explicit rows come frequency-ordered from the
    import path; ``None`` (holder open) samples row ids from the first
    few fragments -- bounded instead of exhaustive."""
    if rows is not None:
        return list(rows)[:ROW_CAP]
    from pilosa_tpu_torch.models.view import VIEW_STANDARD

    view = field.view(VIEW_STANDARD)
    if view is None:
        return []
    out: list[int] = []
    seen: set[int] = set()
    for shard in sorted(view.available_shards())[:4]:
        frag = view.fragment(shard)
        if frag is None:
            continue
        # hottest rows first when the fragment's TopN cache knows them,
        # plain row ids otherwise
        counts = frag.topn_cache.get(frag._gen)
        ids = ([r for r, _ in sorted(counts.items(), key=lambda kv: -kv[1])]
               if counts else frag.row_ids())
        for r in ids:
            if r not in seen:
                seen.add(r)
                out.append(r)
            if len(out) >= ROW_CAP:
                return out
    return out


def _live(index, field) -> bool:
    """A queued job must not rebuild stacks for a deleted or closed
    field: it would admit buffers into a cache nothing forgets again."""
    try:
        return (id(index) not in _cancelled and not field.closed
                and index.fields.get(field.name) is field)
    except Exception:
        return False


def _run_job(index, field, rows) -> None:
    from pilosa_tpu_torch.models.field import FieldType
    from pilosa_tpu_torch.ops import bitmap as bm
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    if not _live(index, field):
        return
    shards = tuple(sorted(index.available_shards()))
    if not shards:
        return
    stack_bytes = len(shards) * bm.n_words(SHARD_WIDTH) * 4
    if field.options.type == FieldType.INT:
        # BSI queries touch the whole plane stack at once
        if _headroom_ok(stack_bytes * (field.options.bit_depth + 2)):
            field.device_plane_stack(shards)
            bump("stacks_built")
        else:
            bump("rows_skipped_budget")
        return
    for row in _job_rows(field, rows):
        if not _live(index, field):  # delete or close landed mid-job
            return
        if not _headroom_ok(stack_bytes):
            bump("rows_skipped_budget")
            return  # budget is a hard stop, not a per-row skip
        field.device_row_stack(int(row), shards)
        bump("stacks_built")


def _run() -> None:
    global _running, _inflight, _worker
    while True:
        with _lock:
            if not _jobs:
                # idle: this thread ends; the next enqueue starts one
                _worker = None
                _idle.notify_all()
                return
            job = _running = _jobs.popleft()
            # release the dedup key at DEQUEUE: an import landing while
            # this job runs carries new rows and must re-queue
            _pending.discard((id(job[0]), job[1].name))
        index, field, rows = job
        try:
            _run_job(index, field, rows)
        except Exception as e:  # noqa: BLE001 -- must never break serving
            bump("jobs_failed")
            log.printf("prewarm: job for field %r failed (%r); first "
                       "query pays the cold build instead", field.name, e)
        finally:
            with _lock:
                _running = None
                _inflight -= 1
                _idle.notify_all()


def enqueue(index, field, rows=None) -> None:
    """Queue a prewarm job; drops silently when disabled, the queue is
    full (prewarm is best-effort -- the first query just pays the build),
    or the same field is already queued."""
    global _inflight, _worker
    if not enabled():
        return
    key = (id(index), field.name)
    with _lock:
        if key in _pending or len(_jobs) >= QUEUE_DEPTH:
            return
        _pending.add(key)
        _inflight += 1
        _jobs.append((index, field, rows))
        if _worker is None:
            _worker = threading.Thread(target=_run, daemon=True,
                                       name="stack-prewarm")
            _worker.start()


def cancel(indexes, timeout: float | None = 30.0) -> bool:
    """Drop every queued job of ``indexes`` (a closing holder's) and
    wait for a running one of theirs, which stops at its next row.
    Returns False when the wait timed out."""
    global _inflight
    ids = {id(i) for i in indexes}
    deadline = None if timeout is None else time.monotonic() + timeout
    with _idle:
        _cancelled.update(ids)
        keep = deque(j for j in _jobs if id(j[0]) not in ids)
        for j in _jobs:
            if id(j[0]) in ids:
                _pending.discard((id(j[0]), j[1].name))
                _inflight -= 1
        _jobs.clear()
        _jobs.extend(keep)
        _idle.notify_all()
        try:
            while _running is not None and id(_running[0]) in ids:
                remaining = (1.0 if deadline is None
                             else deadline - time.monotonic())
                if remaining <= 0:
                    return False
                _idle.wait(timeout=remaining)
        finally:
            _cancelled.difference_update(ids)
    return True


def drain(timeout: float | None = 30.0) -> bool:
    """Block until queued prewarm jobs finish (test/measure barrier)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with _idle:
        while _inflight > 0 or _worker is not None:
            if deadline is None:
                _idle.wait(timeout=1.0)
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            _idle.wait(timeout=remaining)
    return True


def pending() -> int:
    """Jobs queued or running now."""
    with _lock:
        return _inflight
