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

Not part of the port yet: the result cache, the cluster fan-out, ingest
deltas, string keys and the other calls (TopN, Rows, GroupBy,
Sum/Min/Max, BSI and time ranges, Shift, Store, ClearRow, attrs).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from pilosa_tpu_torch import device as devmod
from pilosa_tpu_torch.models.field import FieldType
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import containers, expr
from pilosa_tpu_torch.pql import Call, Query, parse

_SET_OPS = {"Union": "or", "Intersect": "and", "Difference": "andnot",
            "Xor": "xor"}


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


class ExecutionError(ValueError):
    pass


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
        for call in query.calls:
            self._check_keys(idx, call)
        return [self._execute_call(idx, call, shards, opt)
                for call in query.calls]

    # ----------------------------------------------------------- dispatch

    def _execute_call(self, idx, call: Call, shards, opt: ExecOptions):
        name = call.name
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "Count":
            return self._execute_count(idx, call, shards, opt)
        if name == "Options":
            return self._execute_options(idx, call, shards, opt)
        if name in ("Row", "Not", *_SET_OPS):
            return self._execute_bitmap_call(idx, call, shards, opt)
        raise ExecutionError(f"{name}() is not supported by this port yet")

    def _check_keys(self, idx, call: Call) -> None:
        """String keys are not part of the port: refuse them with the
        reference's errors for an index or field without keys."""
        if call.name in ("Set", "Clear") and isinstance(
                call.args.get("_col"), str):
            raise ExecutionError(f"index {idx.name!r} does not use string "
                                 f"keys (option keys=true)")
        if call.name in ("Set", "Clear", "Row") \
                and not call.has_condition_arg():
            fname = next((k for k in call.args if not k.startswith("_")
                          and k not in ("from", "to")), None)
            if fname is not None and isinstance(call.args[fname], str):
                if idx.field(fname) is None:
                    raise ExecutionError(f"field not found: {fname}")
                raise ExecutionError(f"field {fname!r} does not use string "
                                     f"keys (option keys=true)")
        for c in call.children:
            self._check_keys(idx, c)

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
        if f.options.type != FieldType.SET:
            raise ExecutionError(f"field {name!r} is a {f.options.type} "
                                 f"field, which this port does not serve yet")
        return f

    @staticmethod
    def _row_id(call: Call, fname: str):
        """The integer row id of a Row/Set/Clear, or None."""
        v = call.args.get(fname)
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            return None
        return v

    # ------------------------------------------------- fused all-shard path

    def _fused_supported(self, idx, call: Call) -> bool:
        """True when the tree evaluates over all shards at once: plain
        standard-view Row leaves of set fields combined with Union/
        Intersect/Difference/Xor/Not."""
        name = call.name
        if name == "Row":
            if call.has_condition_arg():
                return False
            try:
                fname = call.field_arg()
            except ValueError:
                return False
            v = call.args.get(fname)
            if not isinstance(v, int) or isinstance(v, bool):
                return False
            if "from" in call.args or "to" in call.args:
                return False
            f = idx.field(fname)
            return f is not None and f.options.type == FieldType.SET
        if name == "Not":
            return (len(call.children) == 1
                    and idx.existence_field() is not None
                    and self._fused_supported(idx, call.children[0]))
        if name in _SET_OPS:
            return bool(call.children) and all(
                self._fused_supported(idx, c) for c in call.children)
        return False

    def _fuse_eligible(self, idx, shards, call: Call) -> bool:
        return len(shards) > 1 and self._fused_supported(idx, call)

    def _fused_shape(self, idx, call: Call, shards: tuple[int, ...],
                     leaves: list) -> tuple:
        """(shape, leaves) of ops/expr for a supported tree: every leaf a
        dense row stack of the whole shard set."""
        name = call.name
        if name == "Row":
            fname = call.field_arg()
            leaves.append(idx.field(fname).device_row_stack(
                call.args[fname], shards))
            return ("leaf", len(leaves) - 1)
        if name in _SET_OPS:
            return (_SET_OPS[name],
                    *(self._fused_shape(idx, c, shards, leaves)
                      for c in call.children))
        if name == "Not":
            leaves.append(idx.existence_field().device_row_stack(0, shards))
            exist = ("leaf", len(leaves) - 1)
            return ("not", exist,
                    self._fused_shape(idx, call.children[0], shards, leaves))
        raise ExecutionError(f"unsupported fused call: {name}")

    def _fused_expr(self, idx, call: Call, shards: tuple[int, ...]):
        leaves: list = []
        shape = self._fused_shape(idx, call, shards, leaves)
        return shape, tuple(leaves)

    # ----------------------------------------------------- bitmap queries

    def _validate_call_fields(self, idx, call: Call) -> None:
        """Check referenced fields exist even when the shard set is
        empty."""
        if call.name == "Row" and not call.has_condition_arg():
            self._field(idx, call.field_arg())
        for child in call.children:
            self._validate_call_fields(idx, child)

    def _execute_bitmap_call(self, idx, call: Call, shards,
                             opt: ExecOptions) -> Row:
        self._validate_call_fields(idx, call)
        shards = self._target_shards(idx, shards, opt)
        row = Row()
        if self._fuse_eligible(idx, shards, call):
            g = tuple(shards)
            plan = containers.plan_fused(idx, call, g, opt, counts=False)
            if plan is not None:
                partials = plan.row_words()
            else:
                shape, leaves = self._fused_expr(idx, call, g)
                stack = bm.to_numpy(expr.evaluate(shape, leaves))
                partials = [(s, stack[i].copy()) for i, s in enumerate(g)
                            if stack[i].any()]
        else:
            partials = []
            for s in shards:
                w = self._bitmap_words_shard(idx, call, s)
                if w is not None:
                    partials.append((s, bm.to_numpy(w).copy()))
        for shard, words in partials:
            if words.any():
                row.segments[shard] = words
        return row

    def _field_row_words(self, f, row_id: int, shard: int):
        frag = f.fragment(shard)
        if frag is None:
            return None
        return bm.to_tensor(frag.row(row_id), self.device)

    def _bitmap_words_shard(self, idx, call: Call, shard: int):
        """Evaluate a bitmap tree on one shard -> int32 words on the
        device, or None for empty (executor.py:1498)."""
        name = call.name
        if name == "Row":
            if call.has_condition_arg() or "from" in call.args \
                    or "to" in call.args:
                raise ExecutionError("Row(): conditions and time ranges are "
                                     "not supported by this port yet")
            fname = call.field_arg()
            f = self._field(idx, fname)
            row_id = self._row_id(call, fname)
            if row_id is None:
                raise ExecutionError(
                    f"Row(): field {fname!r} requires an integer row")
            return self._field_row_words(f, row_id, shard)
        if name in ("Union", "Xor"):
            op = bm.b_or if name == "Union" else bm.b_xor
            out = None
            for child in call.children:
                w = self._bitmap_words_shard(idx, child, shard)
                if w is not None:
                    out = w if out is None else op(out, w)
            return out
        if name in ("Intersect", "Difference"):
            if not call.children:
                raise ExecutionError(
                    f"{name}() requires at least one row query")
            out = self._bitmap_words_shard(idx, call.children[0], shard)
            for child in call.children[1:]:
                if out is None:
                    return None
                w = self._bitmap_words_shard(idx, child, shard)
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
            exist = self._field_row_words(ef, 0, shard)
            if exist is None:
                return None
            child = self._bitmap_words_shard(idx, call.children[0], shard)
            return exist if child is None else bm.b_not(child, exist)
        raise ExecutionError(f"{name}() is not supported by this port yet")

    # ------------------------------------------------------------- counts

    def _execute_count(self, idx, call: Call, shards,
                       opt: ExecOptions) -> int:
        if len(call.children) != 1:
            raise ExecutionError("Count() requires a single bitmap query")
        shards = self._target_shards(idx, shards, opt)
        child = call.children[0]
        if self._fuse_eligible(idx, shards, child):
            g = tuple(shards)
            if self.coalescer is not None and self.coalescer.eligible(opt):
                # ?nocontainers disables the VM too: it executes over
                # compressed pools
                return self.coalescer.count(
                    self, idx, child, g, use_vm=opt.vm and opt.containers)
            plan = containers.plan_fused(idx, child, g, opt)
            if plan is not None:
                return sum(plan.counts())
            shape, leaves = self._fused_expr(idx, child, g)
            counts = expr.evaluate(shape, leaves, counts=True)
            # per-shard int32 counts summed as Python ints: one int32
            # reduce over the stack could wrap past 2^31 set bits
            return int(counts.to("cpu").to(torch.int64).sum())
        total = 0
        for s in shards:
            words = self._bitmap_words_shard(idx, child, s)
            if words is not None:
                total += bm.popcount(words)
        return total

    # ---------------------------------------------------------- writes

    def _execute_set(self, idx, call: Call) -> bool:
        col = call.uint_arg("_col")
        if col is None:
            raise ExecutionError("Set() column argument required")
        fname = call.field_arg()
        f = self._field(idx, fname)
        row_id = self._row_id(call, fname)
        if row_id is None:
            raise ExecutionError("Set() row argument required")
        if call.args.get("_timestamp") is not None:
            raise ExecutionError(f"field {fname!r} does not accept "
                                 f"timestamps")
        ef = idx.existence_field()
        if ef is not None:
            ef.set_bit(0, col)
        return f.set_bit(row_id, col)

    def _execute_clear(self, idx, call: Call) -> bool:
        col = call.uint_arg("_col")
        if col is None:
            raise ExecutionError("Clear() column argument required")
        fname = call.field_arg()
        f = self._field(idx, fname)
        row_id = self._row_id(call, fname)
        if row_id is None:
            raise ExecutionError("Clear() row argument required")
        return f.clear_bit(row_id, col)

    # ------------------------------------------------------------ options

    def _execute_options(self, idx, call: Call, shards, opt: ExecOptions):
        if len(call.children) != 1:
            raise ExecutionError("Options() requires a single child query")
        new_opt = replace(opt)
        for key, value in call.args.items():
            if key in ("columnAttrs", "excludeRowAttrs"):
                raise ExecutionError(f"Options({key}=...): attributes are "
                                     f"not supported by this port yet")
            if key == "excludeColumns":
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
        return res

