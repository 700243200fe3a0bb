"""Query executor: PQL set algebra and Count on one node.

Port of the single-node read/write path of
pilosa_tpu/parallel/executor.py: validate, dispatch per call, evaluate
over the index's shards, reduce.  ``Set``/``Clear`` write the host
fragments; ``Row``/``Union``/``Intersect``/``Difference``/``Xor``/
``Not`` return a Row; ``Count`` returns an int; ``Options`` wraps them.

A bitmap tree over more than one shard evaluates fused, all shards at
once (``_fuse_eligible``/``_fused_supported``, executor.py:1005-1070):
the compressed container engine first (ops/containers.plan_fused, whose
``Count(Intersect(Row, Row))`` pair runs the CUDA kernel K2), else the
dense stacks through ops/expr.  A single shard, or a tree the fused path
does not take, evaluates shard by shard with torch ops on the device.
Everything runs on the executor's device; the host holds only the
fragments and the Row results.

With a coalescer attached (``Executor.coalescer``, set by the server
assembly), a fused Count goes through its batching window first
(parallel/coalescer.py; pilosa_tpu/parallel/executor.py:1748-1766),
unless the request says ``?nocoalesce=true``.

``TopN``, ``Rows`` and ``GroupBy`` read set fields
(executor.py:1792-2354).  A filtered TopN scans every row of the field
against its filter in one launch of the CUDA kernel K4: over all shards
at once through the field's matrix stack when the filter is fused-
supported, else shard by shard.  GroupBy walks its levels shard by
shard, each level that has group masks one launch of the CUDA kernel K5.
Unfiltered scans are plain torch row counts, answered from the
fragments' TopN rank caches when those are warm.  The shards of one
node are mapped one after another on the calling thread (``_local_map``).

Int fields (executor.py:1011-1027, 1617-1632, 2398-2537, 2815-2885):
``Set``/``Clear`` with a value write the field's BSI planes, a condition
row (``Row(v > 10)``, ``Row(-5 < v < 5)``, ``Row(v != null)``) is a range
leaf -- over all shards one K6 launch per compare over the field's plane
stack, else per shard -- and ``Sum``/``Min``/``Max`` aggregate over the
plane stack: fused over all shards when the filter child (if any) is
fused-supported, else shard by shard.  A filtered Sum's count is K1.
The container engine and the VM decline trees with range leaves, so
their Counts take the dense stacks (and the coalescer's dense buckets),
as in the reference.

Streaming ingest (pilosa_tpu/parallel/executor.py:1095-1135, 1585-1612):
a Row leaf whose row has a pending delta plane in any shard fuses the
overlay as a ``dfuse`` node over ``Field.device_delta_stacks``, staged
before the base stack; the coalescer's VM stages the same overlay
compressed (ops/containers.stage_vm) and the container engine declines
it.  A per-shard read answers from the fragment's effective host words
and never compacts.  TopN, Rows and GroupBy read whole matrices, which
merge pending deltas first.  Range leaves stay on the base path (BSI
views take no deltas).  ``ExecOptions.delta=False`` (``?nodelta=1``)
compacts the touched rows' deltas up front and reads pure base state.

``Shift`` moves a row's bits up within each shard (a ``shift`` node of
ops/expr, so a shift-carrying Count takes the dense program: the tape
and the container engine decline it).  ``Store`` and ``ClearRow`` write
whole rows with the reference's WAL records; ``MinRow``/``MaxRow`` read
the TopN scan's row counts (executor.py:1570, 2539-2560, 2904-2958).
``Range`` is the legacy name of ``Row``, served per shard.

The result cache (runtime/resultcache.py; executor.py:1214-1402): a
fused Row, Count, TopN (MinRow/MaxRow too) or GroupBy probes it before
reading any fragment data, under a key of the tree's signature and the
shard tuple, stamped with every participating (field, view)'s
``(count, sum_gen, sum_delta_seq, sum_uid, max_uid)``; a hit launches
nothing, a miss computes and fills with the stamp taken before the
read.  A Count probes before the coalescer, so a hit never takes a
batch slot, and the coalescer fills each member's key.  Whole-matrix
reads (TopN, GroupBy) merge their fields' deltas before stamping.
``?nocache=1`` (``ExecOptions.cache``) and ``?nodelta=1`` skip the
probe.  A miss waits on an open flight for at most
``resultcache.FLIGHT_WAIT_S`` and never past the query's remaining
deadline (``_rc_wait``).  Left out with the flight recorder:
``_rc_mark_hit`` and the ``cacheKey`` stamp; with the cluster: the
``count_shards`` probe and ``_rc_fill_ok`` (no partial results).

Residency (runtime/residency.py; executor.py:112-116, 344, 540-561,
1433-1448, 1685-1708, 1987-2003): ``ExecOptions.tiers=False``
(``?notiers=1``) installs the ``no_tiers`` scope for the execution, and
the fused Row, the un-coalesced fused Count and the fused TopN scan each
stage and launch inside ``run_with_oom_retry``, which on
``torch.cuda.OutOfMemoryError`` evicts every tracked device entry, shrinks
the budget and retries once.

Deadlines and tenants (serve/; executor.py:117-140, 345-369, 538-600):
``ExecOptions.deadline`` (the request's ``X-Pilosa-Deadline``) is checked
before translation, before each call's map (``map``), before each shard
of a per-shard map (``map of shard N``) and before the reduce, so that an
expired query never reaches a kernel launch; the coalescer drops an
entry that expires in its window.  ``ExecOptions.tenant`` is installed
as the thread's tenant scope for the execution, which the result cache
charges with [tenants] on.  The shards of one node map on the calling
thread, where both scopes (and ``no_tiers``) already hold; the
reference's hand-off of the
deadline to its remote-query threads (executor.py:515-525) waits for the
cluster.

Mutex, bool and time fields (executor.py:1038-1094, 1636-1655,
2050-2080, 2620, 2815-2866): a bool field's ``true``/``false`` literal
is row 1/0 (``_bool_row_id``) and is never fused, as in the reference; a
``Row(f=r, from=..., to=...)`` over a time field unions the views that
cover the range, clamped to the views that exist -- over more than one
shard as one cached stack (``Field.device_time_row_stack``, a dense leaf:
the container engine and the VM decline it), per shard through
``Field.row_time`` -- and its result-cache identity holds the covering
views, so a first write into a new view misses.  ``Rows`` over a time
field with ``from``/``to`` (or no standard view) reads the covering
views.  ``Set`` takes a timestamp into a time field's views.

String keys and attributes (executor.py:1486-1495, 1804-1895,
2968-3200): before any call runs, its tree is translated once (a clone):
a write creates its keys, a read that names a missing key becomes the
``_Empty``/``_Noop``/``_EmptyRows`` sentinel; after it runs, ids in its
result go back to keys (Row columns of a keyed index, TopN and MinRow/
MaxRow pairs, Rows ids, GroupBy ``rowKey``).  The result cache is probed
with the translated tree, so a keyed query and its id form share an
entry.  ``SetRowAttrs``/``SetColumnAttrs`` merge into the field's and
the index's attribute stores; a plain ``Row`` carries its row's
attributes unless ``excludeRowAttrs`` (attached after the cache probe,
so a cached Row never carries stale ones), and ``TopN(attrName=,
attrValues=)`` keeps the rows whose attribute is one of the values,
applied after the cached counts.  A row id past int64 has no attributes
(the reference answers 500 there: ROADMAP Queue 3 item 7).

With ``long_query_time`` above 0 and a ``logger`` (set by the server
from ``[cluster] long-query-time``), a query that takes longer is logged
as the reference logs it, ``trace=-`` standing for the flight recorder's
trace id (pilosa_tpu/parallel/executor.py:429-437).

Not part of the port yet: the cluster fan-out, with its key routing and
attribute forwarding, and the flight recorder.
"""

from __future__ import annotations

import bisect
import datetime as _dt
import heapq
import math
import time as _time
from dataclasses import dataclass, replace
from operator import itemgetter as _itemgetter

import numpy as np
import torch

from pilosa_tpu_torch import device as devmod
from pilosa_tpu_torch.models.field import FieldType
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.models.timequantum import (parse_time,
                                                 views_by_time_range)
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import containers, expr
from pilosa_tpu_torch.parallel.results import (FieldRow, GroupCount, Pair,
                                               ValCount, sort_pairs)
from pilosa_tpu_torch.pql import Call, Query, parse
from pilosa_tpu_torch.runtime import residency as _residency
from pilosa_tpu_torch.runtime import resultcache
from pilosa_tpu_torch.serve import deadline as _deadline
from pilosa_tpu_torch.serve import tenant as _tenantmod
from pilosa_tpu_torch.serve.deadline import DeadlineExceededError
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

_SET_OPS = {"Union": "or", "Intersect": "and", "Difference": "andnot",
            "Xor": "xor"}

#: The placement token of a result-cache key: what the reference's
#: ``meshexec.placement_token`` gives with the mesh off
#: (pilosa_tpu/parallel/meshexec.py:250-251).  One card has no mesh; the
#: token stays in the key so that a mesh placement can join it later.
_PLACEMENT = "dev"


@dataclass
class ExecOptions:
    """Per-request options (pilosa_tpu/parallel/executor.py:73)."""

    exclude_columns: bool = False
    shards: list[int] | None = None
    # ?nocoalesce=true: opt this request out of cross-query batching
    coalesce: bool = True
    # ?nocontainers=1: route fused reads through the dense stacks
    containers: bool = True
    # ?novm=1: route coalesced sparse Counts through the dense ragged/
    # fused engines instead of the bitmap VM
    vm: bool = True
    # ?nodelta=1: compact the touched fragments' pending ingest deltas up
    # front and read pure base state
    delta: bool = True
    # ?nocache=1: skip the result cache (no probe, no fill)
    cache: bool = True
    # ?excludeRowAttrs=true: a Row result carries no row attributes
    exclude_row_attrs: bool = False
    # ?columnAttrs=true: Row results ask for their columns' attributes
    column_attrs: bool = False
    # the request's end-to-end deadline (serve/deadline.Deadline, from
    # X-Pilosa-Deadline): checked at translate, map, each shard and
    # reduce, so that expired work never reaches a launch
    deadline: object | None = None
    # the request's tenant id (X-Pilosa-Tenant / ?tenant=): the thread's
    # tenant scope during the execution; inert with [tenants] off
    tenant: str | None = None
    # ?notiers=1: bypass tiered residency (host-tier lookups miss,
    # evictions drop) -- the exact pre-tier behavior, same answers
    tiers: bool = True


class ExecutionError(ValueError):
    pass


#: Sentinel calls that a read-path key miss becomes (executor.py:247-249):
#: an empty Row, a write that changes nothing, an empty Rows list.
_EMPTY_CALL = "_Empty"
_NOOP_CALL = "_Noop"
_EMPTY_ROWS_CALL = "_EmptyRows"

#: Row ids at or past this have no attribute row (sqlite's INTEGER is
#: int64)
_ATTR_ID_LIMIT = 1 << 63


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (pilosa_tpu/parallel/executor.py:66)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class Executor:
    def __init__(self, holder, device: str | torch.device | None = None):
        self.device = devmod.resolve(device)
        if self.device != holder.device:
            raise ValueError(f"executor device {self.device} differs from "
                             f"the holder's {holder.device}")
        self.holder = holder
        # optional cross-query micro-batcher (parallel/coalescer.py),
        # attached by the server assembly; None = no coalescing
        self.coalescer = None
        # the slow-query log, set by the server assembly
        # (pilosa_tpu/parallel/executor.py:258-259)
        self.logger = None
        self.long_query_time = 0.0  # seconds; 0 disables slow-query log

    # ------------------------------------------------------------- public

    def execute(self, index_name: str, query, shards=None,
                opt: ExecOptions | None = None) -> list:
        """Execute a PQL string or Query -> list of results."""
        opt = opt or ExecOptions()
        if isinstance(query, str):
            query = parse(query, allow_internal=False)
        if not isinstance(query, Query):
            raise TypeError("query must be a PQL string or Query")
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecutionError(f"index not found: {index_name}")
        t0 = _time.perf_counter()
        with _tenantmod.scope(opt.tenant), \
                _residency.no_tiers(not opt.tiers):
            _deadline.check(opt.deadline, "translate")
            # keys translate once, before any call runs
            # (executor.py:371-375)
            calls = [self._translate_call(idx, c) for c in query.calls]
            results = [self._execute_call(idx, call, shards, opt)
                       for call in calls]
            results = [self._translate_result(idx, call, res)
                       for call, res in zip(calls, results)]
        elapsed = _time.perf_counter() - t0
        if (self.long_query_time > 0 and elapsed > self.long_query_time
                and self.logger is not None):
            # the slow-query log (pilosa_tpu/parallel/executor.py:429-437);
            # with no flight recorder there is no trace id
            self.logger.printf("slow query (%.3fs) trace=%s on %s: %s",
                               elapsed, "-", index_name, query)
        return results

    # ----------------------------------------------------------- dispatch

    def _execute_call(self, idx, call: Call, shards, opt: ExecOptions):
        name = call.name
        if name == _EMPTY_CALL:
            return Row()
        if name == _NOOP_CALL:
            return False
        if name == _EMPTY_ROWS_CALL:
            return []
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "ClearRow":
            return self._execute_clear_row(idx, call)
        if name == "Store":
            return self._execute_store(idx, call, shards, opt)
        if name == "SetRowAttrs":
            return self._execute_set_row_attrs(idx, call)
        if name == "SetColumnAttrs":
            return self._execute_set_column_attrs(idx, call)
        if name == "Count":
            return self._execute_count(idx, call, shards, opt)
        if name == "TopN":
            return self._execute_topn(idx, call, shards, opt)
        if name == "Rows":
            return self._execute_rows(idx, call, shards, opt)
        if name == "GroupBy":
            return self._execute_group_by(idx, call, shards, opt)
        if name in ("Sum", "Min", "Max"):
            return self._execute_aggregate(idx, call, shards, opt)
        if name in ("MinRow", "MaxRow"):
            return self._execute_extreme_row(idx, call, shards, opt)
        if name == "Options":
            return self._execute_options(idx, call, shards, opt)
        # bitmap calls: Row/Range/Union/Intersect/Difference/Xor/Not/Shift,
        # and any other name, which the per-shard walk refuses as the
        # reference does (executor.py:477, 1581-1582)
        return self._execute_bitmap_call(idx, call, shards, opt)

    def _target_shards(self, idx, shards, opt: ExecOptions) -> list[int]:
        if opt.shards is not None:
            return sorted(opt.shards)
        if shards is not None:
            return sorted(shards)
        return sorted(idx.available_shards())

    def _field(self, idx, name: str):
        f = idx.field(name)
        if f is None:
            raise ExecutionError(f"field not found: {name}")
        return f

    @staticmethod
    def _bool_row_id(f, call: Call, fname: str):
        """The integer row id of a Row/Set/Clear, or None; a bool field's
        ``true``/``false`` literal is row 1/0 (reference
        callArgTranslation, executor.go:2678; executor.py:2620)."""
        v = call.args.get(fname)
        if f.options.type == FieldType.BOOL and isinstance(v, bool):
            return int(v)
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            return None
        return v

    # ------------------------------------------------- fused all-shard path

    def _fused_supported(self, idx, call: Call) -> bool:
        """True when the tree evaluates over all shards at once: plain
        standard-view Row leaves, time-range Rows of at most 256 covering
        views and condition rows of int fields, combined with Union/
        Intersect/Difference/Xor/Not/Shift (executor.py:1005-1060)."""
        name = call.name
        if name == "Row":
            cond = call.condition_arg()
            if cond is not None:
                fname, condition = cond
                f = idx.field(fname)
                if f is None or f.options.type != FieldType.INT:
                    return False
                if condition.op == "><":
                    v = condition.value
                    return (isinstance(v, list) and len(v) == 2
                            and all(isinstance(x, int)
                                    and not isinstance(x, bool) for x in v))
                if condition.value is None:
                    return condition.op == "!="
                return (isinstance(condition.value, int)
                        and not isinstance(condition.value, bool))
            try:
                fname = call.field_arg()
            except ValueError:
                return False
            v = call.args.get(fname)
            if not isinstance(v, int) or isinstance(v, bool):
                return False
            f = idx.field(fname)
            if f is None:
                return False
            if "from" in call.args or "to" in call.args:
                # the cover unions on the host into one cached stack; the
                # cap bounds the generation tuple a hit compares
                if not f.time_quantum:
                    return False
                views = self._time_range_views(f, call)
                return views is not None and len(views) <= 256
            return f.has_standard_rows
        if name == "Not":
            return (len(call.children) == 1
                    and idx.existence_field() is not None
                    and self._fused_supported(idx, call.children[0]))
        if name == "Shift":
            n = call.int_arg("n")
            return (len(call.children) == 1
                    and (n is None or n >= 0)
                    and self._fused_supported(idx, call.children[0]))
        if name in _SET_OPS:
            return bool(call.children) and all(
                self._fused_supported(idx, c) for c in call.children)
        return False

    def _fuse_eligible(self, idx, shards, call: Call | None) -> bool:
        """A real multi-shard batch whose tree, if any, evaluates
        fused."""
        return len(shards) > 1 and (call is None
                                    or self._fused_supported(idx, call))

    def _time_range_views(self, f, call: Call) -> list[str] | None:
        """The time views covering a ``Row(from=, to=)``
        (executor.py:1072-1094); None when the range does not parse."""
        try:
            start, end = self._time_bounds(f, call)
        except (ValueError, TypeError, OverflowError, OSError):
            return None
        return ([] if start >= end
                else views_by_time_range(VIEW_STANDARD, start, end,
                                         f.time_quantum))

    @staticmethod
    def _time_bounds(f, call: Call) -> tuple:
        """``[from, to)`` of a time-range call, an open end clamped to the
        span the field's time views cover (the reference's minMaxViews
        clamping; executor.py:1636-1655), empty when there is no time
        view.  A malformed time raises."""
        from_arg = call.args.get("from")
        to_arg = call.args.get("to")
        start = (parse_time(from_arg) if from_arg is not None
                 else _dt.datetime(1, 1, 1))
        end = (parse_time(to_arg) if to_arg is not None
               else _dt.datetime(9999, 1, 1))
        times = f.time_view_times()
        if not times:
            return start, start
        hi = max(times) + _dt.timedelta(days=366)
        return max(start, min(times)), min(end, hi)

    @staticmethod
    def _fused_row_leaf(f, row_id: int, shards: tuple[int, ...],
                        leaves: list, use_delta: bool) -> tuple:
        """One standard-view row leaf: the base stack, and when a pending
        delta touches the row in any shard, its overlay stacks under a
        ``dfuse`` node -- read BEFORE the base stack, so that a
        compaction racing the two reads can only apply the overlay twice
        (idempotent), never drop it."""
        if use_delta:
            ds = f.device_delta_stacks(row_id, shards)
        else:
            f.flush_deltas(shards)
            ds = None
        leaves.append(f.device_row_stack(row_id, shards))
        shape = ("leaf", len(leaves) - 1)
        if ds is not None:
            leaves.extend(ds)
            shape = ("dfuse", shape, ("leaf", len(leaves) - 2),
                     ("leaf", len(leaves) - 1))
        return shape

    def _fused_shape(self, idx, call: Call, shards: tuple[int, ...],
                     leaves: list, use_delta: bool = True) -> tuple:
        """(shape, leaves) of ops/expr for a supported tree: every leaf a
        dense row stack of the whole shard set."""
        name = call.name
        if name == "Row":
            cond = call.condition_arg()
            if cond is not None:
                # a range leaf: K6 over the field's plane stack
                fname, condition = cond
                value = (condition.int_slice_value()
                         if condition.op == "><" else condition.value)
                leaves.append(idx.field(fname).device_range_stack(
                    condition.op, value, shards))
                return ("leaf", len(leaves) - 1)
            fname = call.field_arg()
            f = idx.field(fname)
            if "from" in call.args or "to" in call.args:
                # one cached stack of the covering views' union, the
                # overlays applied on the host: no dfuse leaves
                views = self._time_range_views(f, call) or []
                leaves.append(f.device_time_row_stack(
                    call.args[fname], shards, tuple(views)))
                return ("leaf", len(leaves) - 1)
            return self._fused_row_leaf(f, call.args[fname], shards, leaves,
                                        use_delta)
        if name in _SET_OPS:
            return (_SET_OPS[name],
                    *(self._fused_shape(idx, c, shards, leaves, use_delta)
                      for c in call.children))
        if name == "Not":
            exist = self._fused_row_leaf(idx.existence_field(), 0, shards,
                                         leaves, use_delta)
            return ("not", exist,
                    self._fused_shape(idx, call.children[0], shards, leaves,
                                      use_delta))
        if name == "Shift":
            # bits move within each shard's row and drop at its edge, as
            # on the per-shard path
            n = call.int_arg("n")
            return ("shift", 1 if n is None else n,
                    self._fused_shape(idx, call.children[0], shards, leaves,
                                      use_delta))
        raise ExecutionError(f"unsupported fused call: {name}")

    def _fused_expr(self, idx, call: Call, shards: tuple[int, ...],
                    use_delta: bool = True):
        leaves: list = []
        shape = self._fused_shape(idx, call, shards, leaves, use_delta)
        return shape, tuple(leaves)

    def _fused_eval(self, idx, call: Call, shards: tuple[int, ...],
                    use_delta: bool = True) -> torch.Tensor:
        """A supported tree -> int32 [n_shards, words] stack on the
        device, through the dense stacks (executor.py:1187-1201)."""
        shape, leaves = self._fused_expr(idx, call, shards, use_delta)
        return expr.evaluate(shape, leaves)

    # ------------------------------------------------------- result cache

    @staticmethod
    def _rc_collect_gens(f, view_name: str, shards: tuple[int, ...],
                         out: dict) -> None:
        """The stamp of one (field, view) over the shard set, memoized in
        ``out`` (executor.py:1214-1276): ``(count, sum_gen, sum_seq,
        sum_uid, max_uid)`` of its fragments.  A surviving fragment's
        ``_gen`` and ``_delta_seq`` only grow and a new fragment's uid
        exceeds every earlier one, so any creation, deletion or write
        moves at least one component, and an unchanged view reproduces
        the stamp exactly."""
        mkey = (id(f), view_name)
        if mkey in out:
            return
        view = None if f is None else f.view(view_name)
        if view is None:
            out[mkey] = 0
            return
        frags = view.fragments
        fs = None
        if len(shards) > 1:
            try:
                fs = _itemgetter(*shards)(frags)
            except KeyError:
                fs = None
        if fs is None:
            g = frags.get
            fs = [fr for s in shards if (fr := g(s)) is not None]
        sg = sq = su = mu = 0
        for fr in fs:
            u = fr._uid
            sg += fr._gen
            sq += fr._delta_seq
            su += u
            if u > mu:
                mu = u
        out[mkey] = (len(fs), sg, sq, su, mu)

    def _rc_sig(self, idx, call: Call, shards: tuple[int, ...],
                gens_out: dict):
        """The canonical identity of a fused-supported tree: its shape
        with the leaves' (field, row) or (field, op, value) at the slots
        (executor.py:1278-1328).  Collects each participating view's
        stamp into ``gens_out`` before any fragment data is read."""
        name = call.name
        if name == "Row":
            cond = call.condition_arg()
            if cond is not None:
                fname, condition = cond
                f = idx.field(fname)
                self._rc_collect_gens(f, f.bsi_view_name, shards, gens_out)
                value = (condition.int_slice_value()
                         if condition.op == "><" else condition.value)
                if isinstance(value, list):
                    value = tuple(value)
                return ("range", fname, condition.op, value)
            fname = call.field_arg()
            f = idx.field(fname)
            if "from" in call.args or "to" in call.args:
                # the covering views are part of the identity: a first
                # write into a new view changes the cover, and the old
                # entry stops being addressed (executor.py:1296-1310)
                views = tuple(self._time_range_views(f, call) or ())
                for vn in views:
                    self._rc_collect_gens(f, vn, shards, gens_out)
                return ("time", fname, call.args[fname], views)
            self._rc_collect_gens(f, VIEW_STANDARD, shards, gens_out)
            return ("row", fname, call.args[fname])
        if name in _SET_OPS:
            return (name, *(self._rc_sig(idx, c, shards, gens_out)
                            for c in call.children))
        if name == "Not":
            ef = idx.existence_field()
            self._rc_collect_gens(ef, VIEW_STANDARD, shards, gens_out)
            return ("not", ef.name,
                    self._rc_sig(idx, call.children[0], shards, gens_out))
        if name == "Shift":
            n = call.int_arg("n")
            return ("shift", 1 if n is None else n,
                    self._rc_sig(idx, call.children[0], shards, gens_out))
        raise ExecutionError(f"uncacheable call: {name}")

    def _rc_probe(self, idx, kind: str, shards: tuple[int, ...],
                  opt: ExecOptions | None, tree: Call | None = None,
                  extra=None, gen_fields=()):
        """(cache, key, stamp) for one fused read, or None when the cache
        is off, the request says ``?nocache=1`` or ``?nodelta=1`` (whose
        contract is a real pure-base read), or the tree has no signature
        (executor.py:1330-1383).  ``extra`` joins the key; ``gen_fields``
        are (field, view) pairs read whole beyond the tree's leaves,
        whose pending deltas merge BEFORE the stamp is taken, as the read
        would merge them anyway.  The stamp lists the views' aggregates
        in traversal order, so a fill and a probe line up slot by slot."""
        rc = resultcache.cache()
        if not rc.enabled or (opt is not None
                              and not (opt.cache and opt.delta)):
            return None
        gens_out: dict = {}
        try:
            sig = (None if tree is None
                   else self._rc_sig(idx, tree, shards, gens_out))
            for f, vn in gen_fields:
                f.flush_deltas(shards)
                self._rc_collect_gens(f, vn, shards, gens_out)
        except (ExecutionError, ValueError, KeyError, TypeError,
                AttributeError):
            return None
        key = resultcache.Key((self.holder.uid, idx.name, kind, sig, extra,
                               shards, _PLACEMENT))
        return rc, key, tuple(gens_out.values())

    @staticmethod
    def _rc_wait(opt: ExecOptions) -> float:
        """How long a cache probe may wait on another reader's open fill:
        ``FLIGHT_WAIT_S``, never past the query's remaining deadline
        (executor.py:1392-1402)."""
        dl = opt.deadline
        if dl is None:
            return resultcache.FLIGHT_WAIT_S
        return max(0.0, min(resultcache.FLIGHT_WAIT_S, dl.remaining()))

    @staticmethod
    def _local_map(fn, shards, opt: ExecOptions) -> list:
        """``fn`` over this node's shards, in order, on the calling thread
        (the reference's worker pool maps the same function), between the
        deadline checks of its ``_map_shards``: before the map, before
        each shard and before the reduce (executor.py:538-600)."""
        dl = opt.deadline
        _deadline.check(dl, "map")
        out = []
        for s in shards:
            if dl is not None and dl.expired():
                raise DeadlineExceededError(
                    f"deadline expired before map of shard {s}")
            out.append(fn(s))
        _deadline.check(dl, "reduce")
        return out

    # ----------------------------------------------------- bitmap queries

    def _validate_call_fields(self, idx, call: Call) -> None:
        """Check referenced fields exist even when the shard set is
        empty."""
        if call.name in ("Row", "Range"):
            cond = call.condition_arg()
            self._field(idx, call.field_arg() if cond is None else cond[0])
        for child in call.children:
            self._validate_call_fields(idx, child)

    def _execute_bitmap_call(self, idx, call: Call, shards,
                             opt: ExecOptions) -> Row:
        self._validate_call_fields(idx, call)
        shards = self._target_shards(idx, shards, opt)
        row = Row()
        if self._fuse_eligible(idx, shards, call):
            _deadline.check(opt.deadline, "map")
            partials = self._fused_row_words(idx, call, tuple(shards), opt)
        else:
            def map_fn(s):
                w = self._bitmap_words_shard(idx, call, s, opt.delta)
                return s, None if w is None else bm.to_numpy(w).copy()

            partials = self._local_map(map_fn, shards, opt)
        for shard, words in partials:
            if words is not None and words.any():
                row.segments[shard] = words
        # a plain Row carries its row's attributes (executor.py:1486-1495)
        if (call.name == "Row" and not opt.exclude_row_attrs
                and not call.has_condition_arg()):
            try:
                fname = call.field_arg()
            except ValueError:
                fname = None
            f = idx.field(fname) if fname else None
            rowid = call.args.get(fname)
            if (f is not None and isinstance(rowid, int)
                    and rowid < _ATTR_ID_LIMIT):
                row.attrs = f.row_attrs.attrs(rowid)
        return row

    def _fused_row_words(self, idx, call: Call, g: tuple[int, ...],
                         opt: ExecOptions) -> list:
        """A fused Row tree's non-empty (shard, words) segments: from the
        result cache, else the container engine or the dense stacks,
        filling the cache (executor.py:1405-1453).  Copies both ways:
        cached words never alias a Row a caller may change."""
        probe = self._rc_probe(idx, "row", g, opt, tree=call)
        if probe is not None:
            rc, key, gens = probe
            hit, val = rc.get(key, gens, self._rc_wait(opt))
            if hit:
                return [(s, w.copy()) for s, w in val]

        def dispatch():
            # the fused Row launch (compressed or dense), staged inside
            # the out-of-memory evict-and-retry (executor.py:1433-1448)
            plan = containers.plan_fused(idx, call, g, opt, counts=False)
            if plan is not None:
                return plan.row_words()
            stack = bm.to_numpy(self._fused_eval(idx, call, g, opt.delta))
            return [(s, stack[i].copy()) for i, s in enumerate(g)
                    if stack[i].any()]

        partials = _residency.run_with_oom_retry(dispatch)
        if probe is not None:
            value = [(s, w.copy()) for s, w in partials]
            rc.put(key, gens, value,
                   sum(w.nbytes for _, w in value) + 32 * len(value))
        return partials

    def _field_row_words(self, f, row_id: int, shard: int,
                         use_delta: bool = True):
        """One shard's row on the device.  A pending delta answers from
        the fragment's effective host words and stays pending: a
        per-shard read never compacts (executor.py:1585-1612).  Under
        ``?nodelta=1`` the fragment's delta merges first."""
        frag = f.fragment(shard)
        if frag is None:
            return None
        if not use_delta:
            frag.flush_delta()
        return bm.to_tensor(frag.row(row_id), self.device)

    def _bitmap_words_shard(self, idx, call: Call, shard: int,
                            use_delta: bool = True):
        """Evaluate a bitmap tree on one shard -> int32 words on the
        device, or None for empty (executor.py:1498)."""
        name = call.name
        if name == _EMPTY_CALL:
            return None
        if name in ("Row", "Range"):
            cond = call.condition_arg()
            if cond is not None:
                return self._range_words_shard(idx, cond, shard)
            fname = call.field_arg()
            f = self._field(idx, fname)
            row_id = self._bool_row_id(f, call, fname)
            if row_id is None:
                raise ExecutionError(
                    f"Row(): field {fname!r} requires an integer row")
            if call.args.get("from") is None and call.args.get("to") is None:
                return self._field_row_words(f, row_id, shard, use_delta)
            # a time range: the covering views' union (executor.py:
            # 1636-1652)
            if not f.time_quantum:
                raise ExecutionError(f"field {fname!r} does not support "
                                     f"time-range queries")
            start, end = self._time_bounds(f, call)
            if start >= end:
                return None
            words = f.row_time(row_id, shard, start, end)
            return None if words is None else bm.to_tensor(words,
                                                           self.device)
        if name in ("Union", "Xor"):
            op = bm.b_or if name == "Union" else bm.b_xor
            out = None
            for child in call.children:
                w = self._bitmap_words_shard(idx, child, shard, use_delta)
                if w is not None:
                    out = w if out is None else op(out, w)
            return out
        if name in ("Intersect", "Difference"):
            if not call.children:
                raise ExecutionError(
                    f"{name}() requires at least one row query")
            out = self._bitmap_words_shard(idx, call.children[0], shard,
                                           use_delta)
            for child in call.children[1:]:
                if out is None:
                    return None
                w = self._bitmap_words_shard(idx, child, shard, use_delta)
                if name == "Intersect":
                    if w is None:
                        return None
                    out = bm.b_and(out, w)
                elif w is not None:
                    out = bm.b_andnot(out, w)
            return out
        if name == "Not":
            if len(call.children) != 1:
                raise ExecutionError("Not() requires a single row query")
            ef = idx.existence_field()
            if ef is None:
                raise ExecutionError("Not() queries require the index to "
                                     "have 'trackExistence' enabled")
            exist = self._field_row_words(ef, 0, shard, use_delta)
            if exist is None:
                return None
            child = self._bitmap_words_shard(idx, call.children[0], shard,
                                             use_delta)
            return exist if child is None else bm.b_not(child, exist)
        if name == "Shift":
            if len(call.children) != 1:
                raise ExecutionError("Shift() requires a single row query")
            n = call.int_arg("n")
            child = self._bitmap_words_shard(idx, call.children[0], shard,
                                             use_delta)
            if child is None:
                return None
            return bm.b_shift(child, 1 if n is None else n)
        if name == "Distinct":
            raise ExecutionError("Distinct() is not supported")
        raise ExecutionError(f"unknown call: {name}")

    def _range_words_shard(self, idx, cond, shard: int):
        """A condition row on one shard (executor.py:1617-1632) -> int32
        words on the device, or None."""
        fname, condition = cond
        f = self._field(idx, fname)
        if condition.op == "><":
            lo, hi = condition.int_slice_value()
            return f.range_between(lo, hi, shard)
        if condition.value is None:
            if condition.op == "!=":  # != null -> not null
                return f.not_null(shard)
            raise ExecutionError("Row(): EQ null condition is not supported")
        if not isinstance(condition.value, int) \
                or isinstance(condition.value, bool):
            raise ExecutionError("Row(): conditions only support integer "
                                 "values")
        return f.range_op(condition.op, condition.value, shard)

    # ------------------------------------------------------------- counts

    def _execute_count(self, idx, call: Call, shards,
                       opt: ExecOptions) -> int:
        if len(call.children) != 1:
            raise ExecutionError("Count() requires a single bitmap query")
        shards = self._target_shards(idx, shards, opt)
        child = call.children[0]
        if self._fuse_eligible(idx, shards, child):
            g = tuple(shards)
            _deadline.check(opt.deadline, "map")
            # the result-cache probe BEFORE the coalescer: a hit answers
            # before the window and never takes a batch slot
            probe = self._rc_probe(idx, "count", g, opt, tree=child)
            if probe is not None:
                rc, key, gens = probe
                hit, val = rc.get(key, gens, self._rc_wait(opt))
                if hit:
                    return val
            if self.coalescer is not None and self.coalescer.eligible(opt):
                # the coalescer drops this entry if its deadline dies in
                # the window and fills the cache for every flushed
                # member; ?nocontainers disables the VM too: it executes
                # over compressed pools
                return self.coalescer.count(
                    self, idx, child, g, use_delta=opt.delta,
                    use_vm=opt.vm and opt.containers, cache_fill=probe,
                    deadline=opt.deadline, tenant=opt.tenant)

            def compute_counts():
                # staged inside the out-of-memory evict-and-retry, so the
                # retry restages its operands after the eviction
                # (executor.py:1685-1708)
                plan = containers.plan_fused(idx, child, g, opt)
                if plan is not None:
                    return sum(plan.counts())
                shape, leaves = self._fused_expr(idx, child, g, opt.delta)
                counts = expr.evaluate(shape, leaves, counts=True)
                # per-shard int32 counts summed as Python ints: one int32
                # reduce over the stack could wrap past 2^31 set bits
                return int(counts.to("cpu").to(torch.int64).sum())

            total = _residency.run_with_oom_retry(compute_counts)
            if probe is not None:
                rc.put(key, gens, total, 32)
            return total
        def map_fn(s):
            words = self._bitmap_words_shard(idx, child, s, opt.delta)
            return 0 if words is None else bm.popcount(words)

        return sum(self._local_map(map_fn, shards, opt))

    # --------------------------------------------------------------- TopN

    def _execute_topn(self, idx, call: Call, shards, opt: ExecOptions
                      ) -> list[Pair]:
        """Exact TopN by device row scans (executor.py:1792-1939): the
        counts of every row of the field, filtered when the call has a
        child, summed over the shards, cut by ``ids``, ``threshold`` or
        ``tanimotoThreshold``, sorted by count (ties by id) and cut to
        ``n``."""
        fname = call.string_arg("_field") or call.args.get("_field")
        if not fname:
            raise ExecutionError("TopN() requires a field argument")
        f = self._field(idx, fname)
        n = call.uint_arg("n") or 0
        ids_arg = call.uint_slice_arg("ids")
        threshold = call.uint_arg("threshold") or 0
        tanimoto = call.uint_arg("tanimotoThreshold") or 0
        if tanimoto > 100:
            raise ExecutionError("Tanimoto Threshold is from 1 to 100 only")
        attr_name = call.string_arg("attrName")
        attr_values = call.args.get("attrValues")
        shards = self._target_shards(idx, shards, opt)
        filter_call = call.children[0] if call.children else None

        # A truncated per-shard rank cache is exact only with nothing to
        # merge: one shard, and no cut applied after the counts.  0
        # demands a complete cache.
        single_shard = len(shards) == 1
        cache_n = (n if single_shard and not (ids_arg or attr_name
                                              or threshold) else 0)

        def map_fn(shard):
            view = f.view(VIEW_STANDARD)
            frag = view.fragment(shard) if view is not None else None
            if frag is None:
                return {}
            if filter_call is None:
                cached = frag.cached_row_counts(cache_n)
                if cached is not None:
                    return cached
            gen, row_ids, matrix = frag.device_matrix_with_gen()
            if len(row_ids) == 0:
                return {}
            if filter_call is not None:
                fw = self._bitmap_words_shard(idx, filter_call, shard,
                                              opt.delta)
                if fw is None:
                    return {}
                counts = bm.row_counts_masked(matrix, fw)
            else:
                counts = bm.row_counts(matrix)
            counts = counts.to("cpu").numpy()
            out = {int(r): int(c) for r, c in zip(row_ids, counts) if c > 0}
            if filter_call is None:
                frag.cache_row_counts(out, gen=gen)
            return out

        fused_ok = self._fuse_eligible(idx, shards, filter_call)
        if fused_ok:
            _deadline.check(opt.deadline, "map")
            parts = [self._fused_topn_counts(idx, f, filter_call,
                                             tuple(shards), opt)]
        else:
            parts = self._local_map(map_fn, shards, opt)
        totals: dict[int, int] = {}
        for part in parts:
            for r, c in part.items():
                totals[r] = totals.get(r, 0) + c

        if ids_arg:
            allowed = set(ids_arg)
            totals = {r: c for r, c in totals.items() if r in allowed}
        if attr_name:
            # after the counts, cached or not: attributes carry no
            # generation (executor.py:1886-1895)
            if not isinstance(attr_values, list):
                raise ExecutionError("TopN() attrValues must be a list")
            allowed_vals = set(attr_values)
            row_attrs = f.row_attrs.attrs_bulk(totals)
            totals = {r: c for r, c in totals.items()
                      if row_attrs.get(r, {}).get(attr_name) in allowed_vals}
        if tanimoto and filter_call is not None:
            # Tanimoto similarity (fragment.go:1588-1652): the full row
            # count strictly inside (|src|*T/100, |src|*100/T), then the
            # coefficient ceil(100*|A∩src| / (|A|+|src|-|A∩src|)) > T,
            # on counts summed over the shards
            src_count = self._execute_count(
                idx, Call("Count", children=[filter_call]), shards, opt)
            if fused_ok:
                full_counts = self._fused_topn_counts(idx, f, None,
                                                      tuple(shards), opt)
            else:
                full = self._execute_topn(
                    idx, Call("TopN", {"_field": fname}), shards, opt)
                full_counts = {p.id: p.count for p in full}
            lo = src_count * tanimoto / 100.0
            hi = src_count * 100.0 / tanimoto
            kept = {}
            for r, inter in totals.items():
                cnt = full_counts.get(r, 0)
                if not (lo < cnt < hi) or inter == 0:
                    continue
                coeff = math.ceil(inter * 100.0
                                  / (cnt + src_count - inter))
                if coeff > tanimoto:
                    kept[r] = inter
            totals = kept
        elif threshold:
            totals = {r: c for r, c in totals.items() if c >= threshold}

        pairs = sort_pairs([Pair(id=r, count=c) for r, c in totals.items()])
        if n:
            pairs = pairs[:n]
        return pairs

    def _fused_topn_counts(self, idx, f, filter_call,
                           shards: tuple[int, ...], opt: ExecOptions
                           ) -> dict[int, int]:
        """Every shard's TopN row counts: from the result cache while the
        field's matrix and the filter's leaves are at the stamped
        generations, else one scan, filling the cache
        (executor.py:1942-1963)."""
        probe = self._rc_probe(idx, "topn", shards, opt, tree=filter_call,
                               extra=f.name,
                               gen_fields=((f, VIEW_STANDARD),))
        if probe is not None:
            rc, key, gens = probe
            hit, val = rc.get(key, gens, self._rc_wait(opt))
            if hit:
                return dict(val)
        totals = self._fused_topn_counts_uncached(idx, f, filter_call,
                                                  shards, opt.delta)
        if probe is not None:
            rc.put(key, gens, dict(totals),
                   resultcache.result_nbytes(totals))
        return totals

    def _fused_topn_counts_uncached(self, idx, f, filter_call,
                                    shards: tuple[int, ...],
                                    use_delta: bool = True
                                    ) -> dict[int, int]:
        """Every shard's TopN row counts in one scan of the field's
        matrix stack (executor.py:1965-2046): with a filter, one launch
        of K4 against the filter's fused stack, each row against its own
        shard's filter row.  An unfiltered scan is answered from the
        fragments' rank caches when every one is complete (none is while
        a delta is pending), and otherwise warms them.  The matrix stack
        merges the field's pending deltas first."""
        view = f.view(VIEW_STANDARD)
        totals: dict[int, int] = {}
        if view is None:
            return totals
        if filter_call is None:
            cached_parts = []
            for s in shards:
                frag = view.fragment(s)
                if frag is None:
                    continue
                c = frag.cached_row_counts(0)
                if c is None:
                    cached_parts = None
                    break
                cached_parts.append(c)
            if cached_parts is not None:
                for part in cached_parts:
                    for r, c in part.items():
                        totals[r] = totals.get(r, 0) + c
                return totals

        def scan():
            # the matrix stack is fetched INSIDE the out-of-memory
            # evict-and-retry: on an OOM the eviction drops its cache
            # entry, so the retry restages it (executor.py:1987-2003)
            stack = f.device_matrix_stack(shards)
            mat_dev, pos_dev = stack[4], stack[3]
            if mat_dev is None:
                return stack, None
            if filter_call is not None:
                filt = self._fused_eval(idx, filter_call, shards, use_delta)
                return stack, bm.row_counts_gathered(mat_dev, filt, pos_dev)
            return stack, bm.row_counts(mat_dev)

        (gens, row_ids, shard_pos, _pos_dev, _mat_dev), counts = \
            _residency.run_with_oom_retry(scan)
        if counts is None:
            return totals
        # int64 before the test: a count is never compared as a word
        counts = counts.to("cpu").numpy().astype(np.int64)[:len(row_ids)]
        if filter_call is not None:
            for rid, c in zip(row_ids, counts):
                if c > 0:
                    rid = int(rid)
                    totals[rid] = totals.get(rid, 0) + int(c)
            return totals

        per_shard: dict[int, dict[int, int]] = {}
        for rid, pos, c in zip(row_ids, shard_pos, counts):
            if c > 0:
                rid, c = int(rid), int(c)
                totals[rid] = totals.get(rid, 0) + c
                per_shard.setdefault(int(pos), {})[rid] = c
        # warm every fragment's cache, those whose rows all counted zero
        # too; stamp it with the generation the stack was read at, and
        # only when the token's uid is still the live fragment's
        for pos, s in enumerate(shards):
            frag = view.fragment(s)
            tok = gens[pos]
            if (frag is not None and isinstance(tok, tuple)
                    and tok[0] == frag._uid):
                frag.cache_row_counts(per_shard.get(pos, {}), gen=tok[1])
        return totals

    # --------------------------------------------------------------- Rows

    def _execute_rows(self, idx, call: Call, shards, opt: ExecOptions
                      ) -> list[int]:
        """The row ids of a field, ascending (executor.py:2050-2136):
        past ``previous``, holding ``column``, at most ``limit``.  A time
        field with ``from``/``to``, or with no standard view, reads the
        views covering the range (a row counts when any of them holds
        it); any other field ignores ``from``/``to``, as the reference
        does."""
        # "field=" is the reference's backwards-compat spelling
        fname = call.args.get("_field") or call.args.get("field")
        if not fname:
            raise ExecutionError("Rows() requires a field argument")
        f = self._field(idx, fname)
        limit = call.uint_arg("limit")
        previous = call.uint_arg("previous")
        column = call.uint_arg("column")
        shards = self._target_shards(idx, shards, opt)
        views = [VIEW_STANDARD]
        if f.time_quantum and ("from" in call.args or "to" in call.args
                               or f.options.no_standard_view):
            views = self._time_range_views(f, call)
            if views is None:
                raise ExecutionError("Rows(): malformed from/to time")
            if not views:
                return []

        def push_down(ids: list[int]) -> list[int]:
            # previous/limit apply inside the shard scan, so a shard
            # never ships more than ``limit`` ids past ``previous``
            if previous is not None:
                ids = ids[bisect.bisect_right(ids, previous):]
            if limit is not None:
                ids = ids[:limit]
            return ids

        def map_fn(shard):
            if column is not None and shard != column // SHARD_WIDTH:
                return []
            frags = []
            for vname in views:
                view = f.view(vname)
                frag = view.fragment(shard) if view is not None else None
                if frag is not None:
                    frags.append(frag)
            if not frags:
                return []
            if column is not None:
                # the column's word down each view's row matrix: a row
                # qualifies when its bit is set in any (rowFilter
                # ColumnFilter)
                off = column % SHARD_WIDTH
                w, b = off // bm.WORD_BITS, off % bm.WORD_BITS
                hit: set[int] = set()
                for frag in frags:
                    ids_arr, matrix = frag._stacked()
                    if len(ids_arr) == 0:
                        continue
                    mask = (matrix[:, w] >> np.uint32(b)) & np.uint32(1)
                    hit.update(int(r) for r in ids_arr[mask.astype(bool)])
                return push_down(sorted(hit))
            return push_down(sorted(set().union(
                *(frag.row_ids() for frag in frags))))

        parts = self._local_map(map_fn, shards, opt)
        # bounded k-way merge of the sorted per-shard lists, deduplicated,
        # stopping at ``limit``
        out: list[int] = []
        for r in heapq.merge(*parts):
            if out and r == out[-1]:
                continue
            out.append(r)
            if limit is not None and len(out) >= limit:
                break
        return out

    # ------------------------------------------------------------ GroupBy

    def _execute_group_by(self, idx, call: Call, shards, opt: ExecOptions
                          ) -> list[GroupCount]:
        """Counts of the cartesian intersections of child Rows queries
        (executor.py:2140-2354), shard by shard and level by level: each
        level with group masks counts every (group, row) pair in one
        launch of K5 and builds the surviving groups' masks; the first
        level without a filter is a plain row count."""
        if not call.children:
            raise ExecutionError("GroupBy() requires at least one Rows query")
        for child in call.children:
            if child.name != "Rows":
                raise ExecutionError("GroupBy() children must be Rows queries")
        limit = call.uint_arg("limit")
        filter_call = call.call_arg("filter")
        shards = self._target_shards(idx, shards, opt)
        # the result cache: the stamp covers each child's whole standard
        # view and the filter's leaves; the truncation arguments ride
        # the key, so the cut result caches as is (executor.py:2153-2170)
        probe = self._groupby_cache_probe(idx, call, filter_call,
                                          tuple(shards), opt)
        if probe is not None:
            rc, ckey, cgens = probe
            hit, val = rc.get(ckey, cgens, self._rc_wait(opt))
            if hit:
                return self._copy_group_counts(val)
        child_fields = []
        child_allowed: list[set | None] = []
        for child in call.children:
            fname = child.args.get("_field") or child.args.get("field")
            if not fname:
                raise ExecutionError("Rows() requires a field argument")
            child_fields.append(self._field(idx, fname))
            # a child with limit/column/previous runs once over all the
            # shards and restricts the walk to its rows
            if (child.uint_arg("limit") is not None
                    or child.uint_arg("column") is not None
                    or child.uint_arg("previous") is not None):
                allowed = self._execute_rows(idx, child, shards, opt)
                if not allowed:
                    return []
                child_allowed.append(set(allowed))
            else:
                child_allowed.append(None)

        # a fused-supported filter evaluates once over all the shards;
        # each shard slices its row out of the stack
        filt_stack = None
        shard_pos: dict[int, int] = {}
        if (filter_call is not None
                and self._fuse_eligible(idx, shards, filter_call)):
            shard_pos = {s: i for i, s in enumerate(shards)}
            filt_stack = self._fused_eval(idx, filter_call, tuple(shards),
                                          opt.delta)

        def map_fn(shard):
            mats = []
            for f, allowed in zip(child_fields, child_allowed):
                view = f.view(VIEW_STANDARD)
                frag = view.fragment(shard) if view is not None else None
                if frag is None:
                    return {}
                row_ids, matrix = frag.device_matrix()
                if allowed is not None and len(row_ids):
                    keep = np.flatnonzero(np.isin(
                        row_ids, np.fromiter(allowed, dtype=np.int64)))
                    row_ids = row_ids[keep]
                    matrix = matrix.index_select(
                        0, torch.from_numpy(keep).to(matrix.device))
                if len(row_ids) == 0:
                    return {}
                mats.append((f.name, row_ids, matrix))
            # The batched cartesian walk.  ``masks`` keeps its power-of-
            # two row count across levels; the live groups are
            # ``prefixes``, and the pad rows' counts are never read.
            prefixes: list[tuple] = [()]
            masks = None  # [G_padded, words] on the device; None = all
            if filt_stack is not None and shard in shard_pos:
                masks = filt_stack[shard_pos[shard]].unsqueeze(0)
            elif filter_call is not None:
                base = self._bitmap_words_shard(idx, filter_call, shard,
                                                opt.delta)
                if base is None:
                    return {}
                masks = base.unsqueeze(0)
            for level, (fname, row_ids, matrix) in enumerate(mats):
                last = level == len(mats) - 1
                if masks is None:
                    cnts = bm.row_counts(matrix).to("cpu").numpy()[None, :]
                else:
                    cnts = bm.masked_matrix_counts(
                        matrix, masks).to("cpu").numpy()[:len(prefixes)]
                nz_g, nz_r = np.nonzero(cnts)
                if len(nz_g) == 0:
                    return {}
                if last:
                    return {
                        prefixes[g] + ((fname, int(row_ids[r])),):
                            int(cnts[g, r])
                        for g, r in zip(nz_g, nz_r)
                    }
                new_prefixes = [
                    prefixes[g] + ((fname, int(row_ids[r])),)
                    for g, r in zip(nz_g, nz_r)
                ]
                p = len(nz_g)
                pp = _next_pow2(p)
                slots = np.zeros(pp, dtype=np.int32)
                slots[:p] = nz_r
                if masks is None:
                    new_masks = matrix.index_select(
                        0, torch.from_numpy(slots.astype(np.int64)).to(
                            matrix.device))
                else:
                    gsel = np.zeros(pp, dtype=np.int32)
                    gsel[:p] = nz_g
                    new_masks = bm.and_pairs(matrix, masks, slots, gsel)
                prefixes, masks = new_prefixes, new_masks
            return {}

        totals: dict[tuple, int] = {}
        for part in self._local_map(map_fn, shards, opt):
            for key, c in part.items():
                if any(allowed is not None and key[i][1] not in allowed
                       for i, allowed in enumerate(child_allowed)):
                    continue
                totals[key] = totals.get(key, 0) + c

        out = [
            GroupCount(group=[FieldRow(field=f, row_id=r) for f, r in key],
                       count=c)
            for key, c in sorted(totals.items())
        ]
        # offset before limit (executor.go:1135-1149); an offset past the
        # end keeps every group, as the reference does
        offset = call.uint_arg("offset")
        if offset is not None:
            out = out[offset:] if offset < len(out) else out
        if limit is not None:
            out = out[:limit]
        if probe is not None:
            rc.put(ckey, cgens, self._copy_group_counts(out),
                   resultcache.result_nbytes(out) * 2)
        return out

    def _groupby_cache_probe(self, idx, call: Call, filter_call,
                             shards: tuple[int, ...], opt: ExecOptions):
        """A GroupBy's cache (cache, key, stamp), or None when ineligible
        (executor.py:2357-2387): every child a plain standard-view Rows
        of a field with no time quantum, the filter absent or fused-
        supported."""
        sig_children = []
        gen_fields = []
        for child in call.children:
            if child.name != "Rows":
                return None
            fname = child.args.get("_field") or child.args.get("field")
            if not fname:
                return None
            f = idx.field(fname)
            if (f is None or f.options.time_quantum
                    or f.options.no_standard_view
                    or "from" in child.args or "to" in child.args):
                return None
            sig_children.append((fname, child.uint_arg("limit"),
                                 child.uint_arg("column"),
                                 child.uint_arg("previous")))
            gen_fields.append((f, VIEW_STANDARD))
        if filter_call is not None and not self._fused_supported(
                idx, filter_call):
            return None
        extra = (tuple(sig_children), call.uint_arg("limit"),
                 call.uint_arg("offset"))
        return self._rc_probe(idx, "groupby", shards, opt,
                              tree=filter_call, extra=extra,
                              gen_fields=gen_fields)

    @staticmethod
    def _copy_group_counts(res: list) -> list:
        return [replace(gc, group=[replace(fr) for fr in gc.group])
                for gc in res]

    # ------------------------------------------------------ MinRow/MaxRow

    def _execute_extreme_row(self, idx, call: Call, shards,
                             opt: ExecOptions) -> Pair:
        """MinRow/MaxRow (executor.py:2539-2603): the smallest or largest
        row id with a bit under the filter, and its count.  Fused, the
        TopN scan's row totals (cached with it); else shard by shard,
        rows walked from the end that wins, and the winning ids' counts
        summed over the shards."""
        fname = call.string_arg("field") or call.args.get("field")
        if not fname:
            raise ExecutionError(f"{call.name}() requires a field argument")
        f = self._field(idx, fname)
        shards = self._target_shards(idx, shards, opt)
        is_min = call.name == "MinRow"
        filter_call = call.children[0] if call.children else None
        if self._fuse_eligible(idx, shards, filter_call):
            totals = self._fused_topn_counts(idx, f, filter_call,
                                             tuple(shards), opt)
            live = [r for r, c in totals.items() if c > 0]
            if not live:
                return Pair()
            rid = min(live) if is_min else max(live)
            return Pair(id=rid, count=totals[rid])
        filter_row = self._local_filter_row(idx, call, shards, opt)

        def map_fn(shard):
            view = f.view(VIEW_STANDARD)
            frag = view.fragment(shard) if view is not None else None
            if frag is None:
                return Pair()
            ids = frag.row_ids()
            if not is_min:
                ids = list(reversed(ids))
            fw = (None if filter_row is None
                  else filter_row.shard_segment(shard))
            if filter_row is not None and fw is None:
                return Pair()
            for rid in ids:
                words = frag.row(rid)
                if fw is not None:
                    words = words & fw
                c = int(np.bitwise_count(words).sum())
                if c > 0:
                    return Pair(id=rid, count=c)
            return Pair()

        out = Pair()
        for p in self._local_map(map_fn, shards, opt):
            if p.count == 0:
                continue
            if out.count == 0:
                out = Pair(id=p.id, count=p.count)
            elif p.id == out.id:
                out.count += p.count
            elif (p.id < out.id) if is_min else (p.id > out.id):
                out = Pair(id=p.id, count=p.count)
        return out

    # ------------------------------------------------------ aggregates

    def _local_filter_row(self, idx, call: Call, shards, opt: ExecOptions):
        """An aggregate's filter child over the shards, or None
        (executor.py:2398-2412, one node)."""
        if not call.children:
            return None
        return self._execute_bitmap_call(idx, call.children[0], shards, opt)

    def _execute_aggregate(self, idx, call: Call, shards, opt: ExecOptions
                           ) -> ValCount:
        """Sum/Min/Max of an int field (executor.py:2414-2475): over all
        shards at once from the plane stack when fusable, else per shard
        against the filter row, merged with add/smaller/larger."""
        fname = call.string_arg("field") or call.args.get("field")
        if not fname:
            raise ExecutionError(f"{call.name}() requires a field argument")
        f = self._field(idx, fname)
        shards = self._target_shards(idx, shards, opt)
        if f.options.type == FieldType.INT and self._fuse_eligible(
                idx, shards, call.children[0] if call.children else None):
            _deadline.check(opt.deadline, "map")
            if call.name == "Sum":
                return self._fused_sum(idx, f, call, tuple(shards),
                                       opt.delta)
            return self._fused_extreme(idx, f, call, tuple(shards),
                                       opt.delta)

        filter_row = self._local_filter_row(idx, call, shards, opt)
        out = ValCount()
        if call.name == "Sum":
            def sum_fn(shard):
                s, c = f.sum(filter_row, shard)
                return ValCount(s, c)

            for vc in self._local_map(sum_fn, shards, opt):
                out = out.add(vc)
            return out
        reducer = "smaller" if call.name == "Min" else "larger"

        def extreme_fn(shard):
            r = (f.min if call.name == "Min" else f.max)(filter_row, shard)
            return ValCount() if r is None else ValCount(r[0], r[1])

        for vc in self._local_map(extreme_fn, shards, opt):
            out = getattr(out, reducer)(vc)
        return out

    def _fused_consider(self, idx, f, call: Call, shards: tuple[int, ...],
                        use_delta: bool):
        """(plane stack, consider, filter stack or None) of a fused
        aggregate."""
        P = f.device_plane_stack(shards)
        exists = P[:, bsi_ops.EXISTS_PLANE]
        if not call.children:
            return P, exists, None
        filt = self._fused_eval(idx, call.children[0], shards, use_delta)
        return P, exists & filt, filt

    def _fused_sum(self, idx, f, call: Call, shards: tuple[int, ...],
                   use_delta: bool = True) -> ValCount:
        """Sum over all shards from the plane stack (executor.py:
        2476-2496): the per-plane counts in two K4 launches, the count of
        a filtered Sum in one K1 launch, exact assembly in Python ints."""
        P, consider, filt = self._fused_consider(idx, f, call, shards,
                                                 use_delta)
        pos, neg = bsi_ops.sign_plane_counts(P, consider)
        pos = pos.to("cpu").numpy().astype(np.int64).sum(axis=0)
        neg = neg.to("cpu").numpy().astype(np.int64).sum(axis=0)
        if filt is None:
            total_count = bm.popcount(consider)
        else:
            total_count = bm.popcount_and(P[:, bsi_ops.EXISTS_PLANE], filt)
        total = sum((1 << i) * (int(p) - int(n))
                    for i, (p, n) in enumerate(zip(pos, neg)))
        return ValCount(total + total_count * f.options.base, total_count)

    def _fused_extreme(self, idx, f, call: Call, shards: tuple[int, ...],
                       use_delta: bool = True) -> ValCount:
        """Min/Max over all shards from one stacked scan (executor.py:
        2498-2537): every shard's candidate, then fragment.min/max's
        sign branching (fragment.go:1147/1191) and smaller/larger on the
        host."""
        P, consider, _ = self._fused_consider(idx, f, call, shards,
                                              use_delta)
        is_min = call.name == "Min"
        (signed_cnt, all_cnt, primary_taken, fallback_taken,
         primary_n, fallback_n) = [
            x.to("cpu").numpy()
            for x in bsi_ops.extremes_stacked(P, consider,
                                              "min" if is_min else "max")]
        reducer = "smaller" if is_min else "larger"
        out = ValCount()
        for s in range(len(shards)):
            if all_cnt[s] == 0:
                continue
            if signed_cnt[s] > 0:
                # Min: a negative exists -> largest negative magnitude;
                # Max: a non-negative exists -> largest magnitude
                v = bsi_ops.assemble_value(primary_taken[s])
                if is_min:
                    v = -v
                c = int(primary_n[s])
            else:
                # the smallest magnitude among what remains
                v = bsi_ops.assemble_value(fallback_taken[s])
                if not is_min:
                    v = -v  # Max of all-negative = closest to zero
                c = int(fallback_n[s])
            out = getattr(out, reducer)(ValCount(v + f.options.base, c))
        return out

    # ---------------------------------------------------------- writes

    def _execute_set(self, idx, call: Call) -> bool:
        col = call.uint_arg("_col")
        if col is None:
            raise ExecutionError("Set() column argument required")
        fname = call.field_arg()
        f = self._field(idx, fname)
        if f.options.type == FieldType.INT:
            # (executor.py:2815-2849): the value is the field argument
            value = call.int_arg(fname)
            if value is None:
                raise ExecutionError("Set() row argument required")
            ef = idx.existence_field()
            if ef is not None:
                ef.set_bit(0, col)
            return f.set_value(col, value)
        row_id = self._bool_row_id(f, call, fname)
        if row_id is None:
            raise ExecutionError("Set() row argument required")
        # every check before any write (executor.py:2815-2838)
        ts = call.args.get("_timestamp")
        timestamp = parse_time(ts) if ts is not None else None
        if timestamp is not None and f.options.type != FieldType.TIME:
            raise ExecutionError(f"field {fname!r} does not accept "
                                 f"timestamps")
        ef = idx.existence_field()
        if ef is not None:
            ef.set_bit(0, col)
        return f.set_bit(row_id, col, timestamp=timestamp)

    def _execute_clear_row(self, idx, call: Call) -> bool:
        """Clear a row in every view and shard (executor.py:2904-2919)."""
        fname = call.field_arg()
        f = self._field(idx, fname)
        if f.options.type not in (FieldType.SET, FieldType.TIME,
                                  FieldType.MUTEX, FieldType.BOOL):
            raise ExecutionError(f"ClearRow() is not supported on "
                                 f"{f.options.type} fields")
        row_id = call.uint_arg(fname)
        if row_id is None:
            raise ExecutionError("ClearRow() row argument required")
        changed = False
        for view in list(f.views.values()):
            for frag in list(view.fragments.values()):
                changed |= frag.clear_row(row_id)
        return changed

    def _execute_store(self, idx, call: Call, shards, opt: ExecOptions
                       ) -> bool:
        """Store(tree, f=row): write the tree's result as the row, shard
        by shard (executor.py:2921-2958).  A shard is touched when the
        source has bits there or the row already has, so no empty
        fragment or no-op WAL record is made."""
        if len(call.children) != 1:
            raise ExecutionError("Store() requires a single row query")
        fname = call.field_arg()
        f = self._field(idx, fname)
        row_id = call.uint_arg(fname)
        if row_id is None:
            raise ExecutionError("Store() row argument required")
        target = self._target_shards(idx, shards, opt)
        src = self._execute_bitmap_call(idx, call.children[0], target, opt)
        changed = False
        view = f.create_view_if_not_exists(VIEW_STANDARD)
        target_shards = set(src.segments)
        for shard, frag in list(view.fragments.items()):
            if frag.row_count(row_id) > 0:
                target_shards.add(shard)
        for shard in sorted(target_shards):
            words = src.shard_segment(shard)
            if words is None:
                words = np.zeros(bm.n_words(SHARD_WIDTH), dtype=np.uint32)
            frag = view.create_fragment_if_not_exists(shard)
            if frag.set_row(row_id, words):
                changed = True
                if words.any():
                    f._note_shards((shard,))
        return changed

    def _execute_clear(self, idx, call: Call) -> bool:
        col = call.uint_arg("_col")
        if col is None:
            raise ExecutionError("Clear() column argument required")
        fname = call.field_arg()
        f = self._field(idx, fname)
        if f.options.type == FieldType.INT:
            return f.clear_value(col)
        row_id = self._bool_row_id(f, call, fname)
        if row_id is None:
            raise ExecutionError("Clear() row argument required")
        return f.clear_bit(row_id, col)

    # ------------------------------------------------------------ options

    def _execute_options(self, idx, call: Call, shards, opt: ExecOptions):
        if len(call.children) != 1:
            raise ExecutionError("Options() requires a single child query")
        new_opt = replace(opt)
        for key, value in call.args.items():
            if key == "columnAttrs":
                new_opt.column_attrs = bool(value)
            elif key == "excludeRowAttrs":
                new_opt.exclude_row_attrs = bool(value)
            elif key == "excludeColumns":
                new_opt.exclude_columns = bool(value)
            elif key == "shards":
                if not isinstance(value, list):
                    raise ExecutionError("Options() shards must be a list")
                new_opt.shards = [int(v) for v in value]
            else:
                raise ExecutionError(f"unknown Options() argument: {key!r}")
        res = self._execute_call(idx, call.children[0], shards, new_opt)
        if isinstance(res, Row):
            res.exclude_columns = new_opt.exclude_columns
            res.wants_column_attrs = new_opt.column_attrs
        return res

    # ------------------------------------------------------- attributes

    def _execute_set_row_attrs(self, idx, call: Call) -> None:
        """Merge attributes into a row's set (executor.py:2968-2982, one
        node: nothing to forward)."""
        fname = call.args.get("_field")
        if not fname:
            raise ExecutionError("SetRowAttrs() requires a field argument")
        f = self._field(idx, fname)
        row_id = call.uint_arg("_row")
        if row_id is None:
            raise ExecutionError("SetRowAttrs() row argument required")
        attrs = {k: v for k, v in call.args.items() if not k.startswith("_")}
        f.row_attrs.set_attrs(row_id, attrs)
        return None

    def _execute_set_column_attrs(self, idx, call: Call) -> None:
        """Merge attributes into a column's set (executor.py:2984-2990)."""
        col = call.uint_arg("_col")
        if col is None:
            raise ExecutionError("SetColumnAttrs() column argument required")
        attrs = {k: v for k, v in call.args.items() if not k.startswith("_")}
        idx.column_attrs.set_attrs(col, attrs)
        return None

    # ----------------------------------------------------- key translation

    def _translate_call(self, idx, call: Call) -> Call:
        """String keys -> ids on a clone of the call tree (executor.py:
        3027-3032): writes create their keys, a read that names a missing
        key becomes a sentinel."""
        return self._translate_call_rec(idx, call.clone())

    def _translate_col_key(self, idx, call: Call, create: bool) -> bool:
        """Translate a string ``_col`` in place; False when the key does
        not exist and was not created."""
        v = call.args.get("_col")
        if not isinstance(v, str):
            return True
        if not idx.options.keys:
            raise ExecutionError(f"index {idx.name!r} does not use string "
                                 f"keys (option keys=true)")
        id_ = self._translate_one(idx, None, v, create)
        if id_ is None:
            return False
        call.args["_col"] = id_
        return True

    @staticmethod
    def _translate_one(idx, field: str | None, key: str, create: bool):
        """Key -> id in the index's or the field's store (the reference's
        no-node branch, executor.py:3051-3063)."""
        store = (idx.translate_store if field is None
                 else idx.field(field).translate_store)
        return store.translate_key(key, create=create)

    @staticmethod
    def _ids_to_keys(idx, field: str | None, ids) -> list:
        store = (idx.translate_store if field is None
                 else idx.field(field).translate_store)
        return store.translate_ids(list(ids))

    def _translate_row_key(self, idx, call: Call, arg_key: str,
                           create: bool) -> bool:
        """Translate a string row value under ``args[arg_key]``, where
        ``arg_key`` names the field; False on a read-path miss."""
        v = call.args.get(arg_key)
        if not isinstance(v, str):
            return True
        f = idx.field(arg_key)
        if f is None:
            raise ExecutionError(f"field not found: {arg_key}")
        if not f.options.keys:
            raise ExecutionError(f"field {arg_key!r} does not use string "
                                 f"keys (option keys=true)")
        id_ = self._translate_one(idx, arg_key, v, create)
        if id_ is None:
            return False
        call.args[arg_key] = id_
        return True

    def _keyed_field(self, idx, fname: str):
        f = idx.field(fname)
        if f is None:
            raise ExecutionError(f"field not found: {fname}")
        if not f.options.keys:
            raise ExecutionError(f"field {fname!r} does not use string keys")
        return f

    def _translate_call_rec(self, idx, call: Call) -> Call:
        """executor.py:3088-3172."""
        name = call.name
        if name == "Set":
            self._translate_col_key(idx, call, create=True)
            self._translate_row_key(idx, call, call.field_arg(), create=True)
            return call
        if name == "Clear":
            if not self._translate_col_key(idx, call, create=False):
                return Call(_NOOP_CALL)
            if not self._translate_row_key(idx, call, call.field_arg(),
                                           create=False):
                return Call(_NOOP_CALL)
            return call
        if name == "SetColumnAttrs":
            self._translate_col_key(idx, call, create=True)
            return call
        if name == "SetRowAttrs":
            fname = call.args.get("_field")
            v = call.args.get("_row")
            if isinstance(v, str) and fname:
                self._keyed_field(idx, fname)
                call.args["_row"] = self._translate_one(idx, fname, v,
                                                        create=True)
            return call
        if name in ("Store", "ClearRow"):
            if not self._translate_row_key(idx, call, call.field_arg(),
                                           create=name == "Store"):
                return Call(_NOOP_CALL)
            call.children = [self._translate_call_rec(idx, c)
                             for c in call.children]
            return call
        if name in ("Row", "Range"):
            if call.has_condition_arg():
                return call
            fname = next((k for k in call.args if not k.startswith("_")
                          and k not in ("from", "to")), None)
            if fname is None:
                return call
            if not self._translate_row_key(idx, call, fname, create=False):
                return Call(_EMPTY_CALL)
            return call
        if name == "Rows":
            fname = call.args.get("_field") or call.args.get("field")
            prev = call.args.get("previous")
            if isinstance(prev, str) and fname:
                self._keyed_field(idx, fname)
                id_ = self._translate_one(idx, fname, prev, create=False)
                if id_ is None:
                    raise ExecutionError(f"previous key not found: {prev!r}")
                call.args["previous"] = id_
            col = call.args.get("column")
            if isinstance(col, str):
                if not idx.options.keys:
                    raise ExecutionError(f"index {idx.name!r} does not use "
                                         f"string keys")
                id_ = self._translate_one(idx, None, col, create=False)
                if id_ is None:
                    return Call(_EMPTY_ROWS_CALL)
                call.args["column"] = id_
            return call
        # structural calls: the children and a GroupBy's filter
        call.children = [self._translate_call_rec(idx, c)
                         for c in call.children]
        filt = call.args.get("filter")
        if isinstance(filt, Call):
            call.args["filter"] = self._translate_call_rec(idx, filt.clone())
        return call

    def _translate_result(self, idx, call: Call, res):
        """Ids in a result back to keys (executor.py:3174-3217)."""
        if isinstance(res, Row):
            if idx.options.keys:
                keys = self._ids_to_keys(idx, None, res.columns())
                res.keys = [k or "" for k in keys]
            return res
        if isinstance(res, Pair) or (isinstance(res, list) and res
                                     and isinstance(res[0], Pair)):
            fname = call.args.get("_field") or call.args.get("field")
            f = idx.field(fname) if fname else None
            if f is not None and f.options.keys:
                pairs = [res] if isinstance(res, Pair) else res
                keys = self._ids_to_keys(idx, f.name, [p.id for p in pairs])
                for p, k in zip(pairs, keys):
                    p.key = k or ""
            return res
        if call.name == "Rows" and isinstance(res, list):
            fname = call.args.get("_field") or call.args.get("field")
            f = idx.field(fname) if fname else None
            if f is not None and f.options.keys:
                return [k or "" for k in self._ids_to_keys(idx, f.name, res)]
            return res
        if call.name == "GroupBy" and isinstance(res, list):
            # one translation per keyed field, not one per group row
            by_field: dict[str, set[int]] = {}
            for gc in res:
                for fr in gc.group:
                    f = idx.field(fr.field)
                    if f is not None and f.options.keys:
                        by_field.setdefault(f.name, set()).add(fr.row_id)
            keymaps = {
                fname: dict(zip(sorted(ids),
                                self._ids_to_keys(idx, fname, sorted(ids))))
                for fname, ids in by_field.items()
            }
            for gc in res:
                for fr in gc.group:
                    if fr.field in keymaps:
                        fr.row_key = keymaps[fr.field].get(fr.row_id) or ""
            return res
        return res

