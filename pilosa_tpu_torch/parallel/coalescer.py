"""Cross-query micro-batched dispatch: concurrent Count queries share one
launch.

Port of pilosa_tpu/parallel/coalescer.py for one node on one card.
Fused-eligible ``Count(tree)`` queries stage their operands on the
calling thread, then meet in a bucket.  The first arrival becomes the
bucket's LEADER and waits up to ``window_s`` for followers; reaching
``max_batch`` seals the bucket early.  The leader runs the sealed bucket
and hands every waiter its count through a future.

Buckets key on the op-tape's size class (ops/tape.py), so structurally
different trees share a window:

- a query whose every leaf stages compressed (ops/containers.stage_vm)
  joins a ``("vm", tape_len, slots)`` bucket, which runs as ONE launch
  of the bitmap VM (ops/tape.execute_vm): K3 over all-bitmap leaves,
  K3-kinds when a leaf holds array or run containers;
- any other query stages dense row stacks and joins a ``("ragged",
  stack shape, tape_len, slots)`` bucket -- or, with ``[ragged]`` off or
  a tape over the caps, the exact ``(index, shape, shards)`` bucket.

At flush a dense bucket of one query passes through to the single-query
program, a bucket of one shape runs the fused program over stacked
operands, and a mixed bucket runs the tape interpreter.  The routes are
tried in the reference's order (VM, lone, same shape, tape).

Every member of a flushed batch fills its own result-cache key with the
stamp the executor took before staging (``cache_fill``), so a Count
that K3 or K3-kinds answered fills the key the direct path probes; with
[tenants] on, each fill charges the member's own tenant.

Deadlines (pilosa_tpu/parallel/coalescer.py:189-198, 383-410): a query
whose remaining budget is at most two windows bypasses the window
(``eligible``), and at flush the entries whose deadline expired in the
window are dropped before any launch.  Their futures raise
``DeadlineExceededError``; their batchmates launch without them and get
their own counts.

Each flush route launches inside ``residency.run_with_oom_retry``: on
``torch.cuda.OutOfMemoryError`` every tracked device entry is evicted,
the budget shrinks and the launch runs once more.

Not part of the port yet: the flight recorder, stats, tracing and the
mesh.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np
import torch

from pilosa_tpu_torch.ops import containers as _containers
from pilosa_tpu_torch.ops import expr
from pilosa_tpu_torch.ops import tape as _tape
from pilosa_tpu_torch.runtime import residency as _residency
from pilosa_tpu_torch.serve.deadline import DeadlineExceededError


def resolve_enabled(mode, device: str | torch.device | None) -> bool:
    """``auto`` | true | false, TOML booleans and strings alike.  ``auto``
    means on when the executor's device is a CUDA card.  Anything else
    raises: a typo silently taken as auto would invert the operator's
    intent."""
    if isinstance(mode, bool):
        return mode
    s = str(mode).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    if s != "auto":
        raise ValueError(
            f"coalescer.enabled must be auto/true/false, got {mode!r}")
    return device is not None and torch.device(device).type == "cuda"


class _Bucket:
    __slots__ = ("items", "full", "sealed")

    def __init__(self):
        self.items: list[_Entry] = []
        self.full = threading.Event()
        self.sealed = False


class _Entry:
    """One staged query waiting in a bucket.  ``tape`` is None on the
    per-shape path; ``vm`` is the query's VMStage when the bitmap VM
    routes it (such entries carry no dense leaves); ``deadline`` is the
    query's, or None."""

    __slots__ = ("shape", "leaves", "tape", "fut", "deadline", "vm")

    def __init__(self, shape, leaves, tape, fut, deadline, vm=None):
        self.shape = shape
        self.leaves = leaves
        self.tape = tape
        self.fut = fut
        self.deadline = deadline
        self.vm = vm


class Coalescer:
    """One per executor.  Thread-safe; a query waits at most
    ``window_s`` beyond its own execution time."""

    def __init__(self, window_s: float = 0.002, max_batch: int = 32,
                 enabled="auto", device: str | torch.device | None = None,
                 ragged: bool = True,
                 max_tape: int = _tape.DEFAULT_MAX_TAPE,
                 max_leaves: int = _tape.DEFAULT_MAX_LEAVES,
                 vm: bool = True,
                 vm_min_domain: int = _containers.VM_MIN_DOMAIN,
                 vm_max_prefetch: int = _containers.VM_MAX_PREFETCH):
        self.window_s = window_s
        self.max_batch = max_batch
        self.enabled = resolve_enabled(enabled, device)
        self.ragged = bool(ragged)
        self.max_tape = max_tape
        self.max_leaves = max_leaves
        # the bitmap VM rides the ragged engine: [ragged] off disables it
        self.vm = bool(vm)
        self.vm_min_domain = int(vm_min_domain)
        self.vm_max_prefetch = int(vm_max_prefetch)
        self._lock = threading.Lock()
        self._pending: dict[tuple, _Bucket] = {}
        # (shape, n_leaves) -> (Tape | None, fallback counter | None).
        # Unlocked by design: a racing duplicate compile is wasted work,
        # never a wrong entry; cleared wholesale on overflow.
        self._tape_memo: dict[tuple, tuple] = {}

    # ------------------------------------------------------------- entry

    def eligible(self, opt) -> bool:
        """Gate of the executor's fused Count path; the caller has
        already established fusion eligibility.  A query whose remaining
        deadline is within two windows bypasses the window: it is never
        held past its budget to share a launch."""
        if not (self.enabled and (opt is None or opt.coalesce)):
            return False
        dl = None if opt is None else opt.deadline
        return dl is None or dl.remaining() > 2 * self.window_s

    def _tape_for(self, shape, n_leaves):
        """Memoized compile: a Tape within the caps, or None (with the
        per-query fallback counter bumped every time)."""
        mkey = (shape, n_leaves)
        hit = self._tape_memo.get(mkey)
        if hit is None:
            try:
                tp = _tape.compile_shape(shape, n_leaves, self.max_tape)
                reason = None
                if n_leaves > self.max_leaves:
                    tp, reason = None, "tape.oversize_fallbacks"
            except _tape.TapeError as e:
                tp = None
                reason = ("tape.oversize_fallbacks"
                          if "exceeds cap" in str(e)
                          else "tape.unsupported")
            if len(self._tape_memo) >= 4096:
                self._tape_memo.clear()
            self._tape_memo[mkey] = hit = (tp, reason)
        tp, reason = hit
        if reason is not None:
            _tape.bump(reason)
        return tp

    def _bucket_key(self, idx, shape, shards, leaves):
        """(key, tape) for one dense-staged query: the size class and the
        leaf stack shape when ragged, else the exact per-shape key."""
        if self.ragged:
            tp = self._tape_for(shape, len(leaves))
            if tp is not None:
                tb, lb = _tape.size_class(len(tp.instrs), len(leaves))
                return ("ragged", tuple(leaves[0].shape), tb, lb), tp
        return (idx.name, shape, shards), None

    def count(self, executor, idx, child, shards: tuple[int, ...],
              use_delta: bool = True, use_vm: bool = True,
              cache_fill=None, deadline=None,
              tenant: str | None = None) -> int:
        """One Count(tree) through the batching window -> total.
        Staging runs on the caller's thread, so a staging error belongs
        to this query alone.  ``cache_fill`` is the executor's result-
        cache probe ``(cache, key, stamp)`` for this query, filled with
        the total once the batch resolves, charged to ``tenant``; a
        member whose batch failed, or whose ``deadline`` expired in the
        window, raises from its future and fills nothing (pilosa_tpu/
        parallel/coalescer.py:250-256, 369-371).  ``use_delta=False``
        (``?nodelta=1``) goes to staging.  Bucket keys need nothing more
        for deltas: a pending overlay puts ``dfuse`` nodes in the staged
        shape, which the tape compiler lowers to two more instructions,
        so the query lands in the size class its overlay costs
        (pilosa_tpu/parallel/coalescer.py:264-271)."""
        vmstage = None
        if self.vm and self.ragged and use_vm:
            vmstage = _containers.stage_vm(
                idx, child, shards, use_delta=use_delta,
                max_tape=self.max_tape,
                max_leaves=self.max_leaves, min_domain=self.vm_min_domain,
                max_prefetch=self.vm_max_prefetch)
            if vmstage is None:
                _tape.bump("vm.fallbacks")
        if vmstage is not None:
            tb, lb = _tape.size_class(len(vmstage.tape.instrs),
                                      len(vmstage.leaves))
            key = ("vm", tb, lb)
            entry = _Entry(vmstage.shape, (), vmstage.tape, Future(),
                           deadline, vm=vmstage)
        else:
            shape, leaves = executor._fused_expr(idx, child, shards,
                                                 use_delta)
            key, tp = self._bucket_key(idx, shape, shards, leaves)
            entry = _Entry(shape, leaves, tp, Future(), deadline)
        with self._lock:
            bucket = self._pending.get(key)
            leader = bucket is None
            if leader:
                bucket = _Bucket()
                self._pending[key] = bucket
            bucket.items.append(entry)
            if len(bucket.items) >= self.max_batch:
                bucket.sealed = True
                del self._pending[key]
                bucket.full.set()
        if leader:
            bucket.full.wait(self.window_s)
            with self._lock:
                if not bucket.sealed:
                    bucket.sealed = True
                    del self._pending[key]
            self._flush(bucket)
        arr = entry.fut.result()
        if entry.vm is not None:
            # per-domain-slot counts; pad slots gather the zero row and
            # the domain already concatenates the per-shard walks
            total = int(arr.sum())
        else:
            total = int(arr[:len(shards)].sum())
        if cache_fill is not None:
            rc, key, gens = cache_fill
            rc.put(key, gens, total, 32, tenant=tenant)
        return total

    # ------------------------------------------------------------- flush

    def _flush(self, bucket: _Bucket) -> None:
        """Leader side: run the sealed bucket and resolve every waiter's
        future.  The entries whose deadline expired in the window leave
        the batch before any launch; everything after runs inside the
        try, so that any failure resolves every future and no follower
        blocks forever."""
        live: list[_Entry] = []
        for it in bucket.items:
            dl = it.deadline
            if dl is not None and dl.expired():
                it.fut.set_exception(DeadlineExceededError(
                    "deadline expired in the coalescer window"))
            else:
                live.append(it)
        n = len(live)
        if n == 0:
            return
        try:
            shape_groups: dict = {}
            for it in live:
                shape_groups[it.shape] = shape_groups.get(it.shape, 0) + 1
            misses = sum(1 for c in shape_groups.values() if c == 1)
            if misses:
                _tape.bump("coalescer.shape_misses", misses)
            if len(shape_groups) > 1:
                _tape.bump("coalescer.shape_flushes")
            # every launch below runs inside the out-of-memory
            # evict-and-retry (pilosa_tpu/parallel/coalescer.py:511-580)
            if live[0].vm is not None:
                results = _residency.run_with_oom_retry(
                    lambda: self._flush_vm(live))
            elif n == 1:
                # lone passthrough: the single-query program
                results = _residency.run_with_oom_retry(
                    lambda: [expr.evaluate(live[0].shape, live[0].leaves,
                                           counts=True)])
            elif len(shape_groups) == 1:
                # same shape: the fused program over [B, S, W] stacks.
                # No pow2 batch padding -- it exists in the reference to
                # bound XLA recompiles, and eager torch compiles nothing
                def same_shape():
                    stacked = tuple(
                        torch.stack([it.leaves[j] for it in live])
                        for j in range(len(live[0].leaves)))
                    return list(expr.evaluate(live[0].shape, stacked,
                                              counts=True).to("cpu"))

                results = _residency.run_with_oom_retry(same_shape)
            else:
                tb, lb = _tape.size_class(
                    max(len(it.tape.instrs) for it in live),
                    max(it.tape.n_leaves for it in live))
                results = _residency.run_with_oom_retry(
                    lambda: _tape.execute(
                        [(it.tape, it.leaves) for it in live],
                        counts=True, tape_len=tb, slots=lb))
            results = [_host_int64(r) for r in results]
        except BaseException as e:  # noqa: BLE001 -- every waiter fails
            for it in live:
                it.fut.set_exception(e)
            return
        for it, row in zip(live, results):
            it.fut.set_result(row)

    def _flush_vm(self, live: list) -> list:
        """The VM bucket: the distinct leaves concatenate into ONE
        megapool, each entry's local gather rows globalize against it
        (re-padded to the bucket-wide domain width with the zero row),
        and the whole heterogeneous batch runs as one K3 launch, or one
        K3-kinds launch when a leaf holds array or run containers (or as
        many as the ``max_prefetch`` halving makes)."""
        tb, lb = _tape.size_class(
            max(len(it.tape.instrs) for it in live),
            max(len(it.vm.leaves) for it in live))
        D = max(it.vm.pad for it in live)
        pool, bases, zero = _containers.megapool(
            [lf for it in live for lf in it.vm.leaves])
        vbatch = []
        for it in live:
            rows = []
            for lf, ix in zip(it.vm.leaves, it.vm.idxs):
                g = np.full(D, zero, dtype=np.int32)
                base = bases[lf.uid]
                if isinstance(ix, tuple):
                    # kind-split staging: each lane's row in the bundle's
                    # virtual row space (containers.MegaPools); absent
                    # lanes take the bitmap base, their ib the leaf's
                    # zero row
                    kv, ib, ia, ir = ix
                    bb, ab, rb = base
                    g[:len(ib)] = np.where(
                        kv == 2, ab + ia, np.where(kv == 3, rb + ir, bb + ib))
                else:
                    # a query of all-bitmap leaves in a bucket whose
                    # megapool is a kinds bundle reads its bitmap rows
                    if isinstance(base, tuple):
                        base = base[0]
                    g[:len(ix)] = base + ix
                rows.append(g)
            vbatch.append((it.tape, rows))
        return _tape.execute_vm(vbatch, pool, zero, tape_len=tb, slots=lb,
                                max_prefetch=self.vm_max_prefetch)


def _host_int64(counts) -> np.ndarray:
    """One query's counts as host int64 (a tensor on any device, or the
    numpy vector ``execute_vm`` returns)."""
    if isinstance(counts, torch.Tensor):
        return counts.to("cpu").numpy().astype(np.int64)
    return np.asarray(counts, dtype=np.int64)
