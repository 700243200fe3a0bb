"""Field: a set of rows over an index's columns.

Port of pilosa_tpu/models/field.py for every field type: metadata and
shard-list files in the reference's format, bit writes and bulk import
into the standard view, and the two device forms of a row across a shard
set that the fused executor reads:

- ``device_row_stack`` -- the dense int32 [n_shards, words] stack
  (pilosa_tpu/models/field.py:420-473);
- ``device_container_leaf`` -- the pooled compressed form
  (pilosa_tpu/models/field.py:827-1050): the non-empty containers of
  every shard in one int32[_pow2(n + 1), 2048] pool on the device, row
  ``n`` the all-zero absent container, or, with [containers] kinds on
  and any array or run container in the row, three compact kind pools.

Both hold BASE content and are cached in one per-field dict keyed
on the fragments' ``(_uid, _gen)`` (``_frag_base_gen``): a write that
lands in a fragment's delta plane (pilosa_tpu_torch.ingest) leaves them
warm, and only a base write or a compaction makes them miss.  The pending
overlays of a row have forms of their own (pilosa_tpu/models/field.py:
678-825), cached per (row, shards) on the fragments' ``(_uid, row_seq)``
so that a write to another row keeps them valid:

- ``device_delta_stacks`` -- the (set, clear) dense stacks, operands of
  the dense ``dfuse`` node ``(base & ~clear) | set``;
- ``device_delta_container_leaves`` -- the same as two all-bitmap
  container leaves, operands of the VM's ``dfuse`` tapes.

The TopN scan's operand, ``device_matrix_stack`` (every row of a shard
set in one matrix), has a cache of its own; its fragments merge their
deltas first, and it keys on the effective ``(_uid, _gen, _delta_seq)``
(``_frag_gen``).

Residency (pilosa_tpu/models/field.py:420-1241): every entry of both
caches is admitted to the process-wide manager (runtime/residency.py)
under one HBM byte budget, with the reference's ``kind`` and entry caps
(64 entries in the stack cache, 8 matrix stacks, and no entry over 512
MiB unless the operator sized the budget).  The dense stacks, container
leaves and matrix stacks register their host bytes as a twin with a
promote closure, so that an eviction demotes them to the host tier; a
miss then consults the tier (``_tier_consult``) before rebuilding from
the fragments, and a promotion that misses its wait answers from the
host bytes, uploaded for that one query.  The delta overlays are tracked
without a twin.  Every access ticks the prefetcher's statistics
(``_note_access``), and bulk imports queue a background prewarm of the
imported rows' stacks (runtime/prewarm.py).  Left out with the flight
recorder (ROADMAP Queue 1 item 7): ``_note_tier``'s hbm / promoted /
fallback / cold stamps; with the cluster: ``drop_shard_stacks``.

``int`` fields (pilosa_tpu/models/field.py:1279-1562, 1700-1780) keep
their values as bit planes in the BSI view ``bsig_<field>``: writes
(``set_value``, ``clear_value``, ``import_values``), per-shard reads
(``sum``/``min``/``max``, ``range_op``/``range_between``/``not_null``,
with the reference's predicate classification and its divergence at a
GT exactly at the minimum), and the fused path's operands:
``device_plane_stack`` (every shard's planes in one int32 [S, 2 + depth,
words] tensor, cached in the same dict) and ``device_range_stack`` (a
range row over the stack, one K6 launch per compare).

``mutex`` and ``bool`` fields (pilosa_tpu/models/field.py:210-226, 326)
keep one row per column: their views pass the ``mutex`` flag to every
fragment, a bool field takes rows 0 (false) and 1 (true) only, and a bulk
import writes them bit by bit.  ``time`` fields (pilosa_tpu/models/
timequantum.py) write every bit with a timestamp into one view per
quantum unit as well (``standard_2024``, ``standard_202401``, ...), and
the standard view too unless ``no_standard_view``; ``row_time`` unions a
range's covering views on one shard and ``device_time_row_stack`` across
a shard set, on the host, into one cached device stack."""

from __future__ import annotations

import datetime as _dt
import functools
import json
import os
import re
import threading
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch import observe as _observe
from pilosa_tpu_torch.models.attrs import AttrStore
from pilosa_tpu_torch.models.timequantum import (TimeQuantum, views_by_time,
                                                 views_by_time_range)
from pilosa_tpu_torch.models.view import VIEW_BSI_PREFIX, VIEW_STANDARD, View
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import containers as ct
from pilosa_tpu_torch.ops import kindpools as kp
from pilosa_tpu_torch.runtime import prewarm, residency
from pilosa_tpu_torch.serve import deadline as _deadline
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class FieldType:
    SET = "set"
    INT = "int"
    TIME = "time"
    MUTEX = "mutex"
    BOOL = "bool"


DEFAULT_CACHE_TYPE = "ranked"
DEFAULT_CACHE_SIZE = 50000

#: row ids of a bool field (reference fragment.go:87-88)
FALSE_ROW_ID = 0
TRUE_ROW_ID = 1

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")
# internal names (the hidden existence field) carry a leading underscore
_INTERNAL_NAME_RE = re.compile(r"^_[a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    if not (_NAME_RE.match(name) or _INTERNAL_NAME_RE.match(name)):
        raise ValueError(f"invalid name: {name!r}")


def bsi_base(lo: int, hi: int) -> int:
    """Default base for an int field's range (reference bsiBase,
    field.go:1551-1559)."""
    if lo > 0:
        return lo
    if hi < 0:
        return hi
    return 0


def bit_depth(uvalue: int) -> int:
    """Bits needed for a magnitude, minimum 1."""
    return max(int(uvalue).bit_length(), 1)


def atomic_write_json(path: str, obj) -> None:
    """tmp file + os.replace (pilosa_tpu/ioutil.py)."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _frag_gen(fr) -> tuple | int:
    """Token of one fragment slot's EFFECTIVE content: (uid, gen,
    delta_seq), 0 when absent (pilosa_tpu/models/field.py:48-58)."""
    return 0 if fr is None else (fr._uid, fr._gen, fr._delta_seq)


def _frag_base_gen(fr) -> tuple | int:
    """Token of one fragment slot's BASE content: (uid, gen), blind to
    the delta sequence, so that streaming writes leave base forms warm
    (pilosa_tpu/models/field.py:61-67)."""
    return 0 if fr is None else (fr._uid, fr._gen)


def _delta_tokens(frags: list, row_id: int) -> tuple | None:
    """The per-fragment ``(uid, row_seq)`` tokens of one row's pending
    overlays, or None when no fragment has one for the row."""
    toks = tuple(0 if fr is None else (fr._uid, fr._delta_row_seq(row_id))
                 for fr in frags)
    if not any(t and t[1] for t in toks):
        return None
    return toks


def _delta_words(frags: list, row_id: int) -> tuple[list, list]:
    """Copies of each fragment's (set, clear) overlay words of one row,
    None where it has none, taken under the fragment lock: later delta
    writes mutate the plane's arrays in place."""
    sets, clears = [], []
    for fr in frags:
        s = c = None
        if fr is not None:
            with fr._lock:
                d = fr._delta
                if d is not None and d.row_touched(row_id):
                    s = d.sets.get(row_id)
                    s = None if s is None else s.copy()
                    c = d.clears.get(row_id)
                    c = None if c is None else c.copy()
        sets.append(s)
        clears.append(c)
    return sets, clears


@dataclass
class FieldOptions:
    type: str = FieldType.SET
    cache_type: str = DEFAULT_CACHE_TYPE
    cache_size: int = DEFAULT_CACHE_SIZE
    min: int = 0
    max: int = 0
    base: int = 0
    bit_depth: int = 1
    time_quantum: str = ""
    no_standard_view: bool = False
    keys: bool = False

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "min": self.min,
            "max": self.max,
            "base": self.base,
            "bitDepth": self.bit_depth,
            "timeQuantum": self.time_quantum,
            "noStandardView": self.no_standard_view,
            "keys": self.keys,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FieldOptions":
        return cls(
            type=d.get("type", FieldType.SET),
            cache_type=d.get("cacheType", DEFAULT_CACHE_TYPE),
            cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
            min=d.get("min", 0),
            max=d.get("max", 0),
            base=d.get("base", 0),
            bit_depth=d.get("bitDepth", 1),
            time_quantum=d.get("timeQuantum", ""),
            no_standard_view=d.get("noStandardView", False),
            keys=d.get("keys", False),
        )

    @classmethod
    def int_field(cls, lo: int, hi: int) -> "FieldOptions":
        """An int field over [lo, hi] with the reference's base and
        depth (pilosa_tpu/models/field.py:198-207)."""
        if lo > hi:
            raise ValueError("int field min cannot be greater than max")
        if lo < -(1 << 63) or hi >= (1 << 63):
            raise ValueError("int field range must fit in int64")
        base = bsi_base(lo, hi)
        depth = bit_depth(max(abs(lo - base), abs(hi - base)))
        if depth > 63:
            raise ValueError("int field range spans more than 63 bits from "
                             "base")
        return cls(type=FieldType.INT, min=lo, max=hi, base=base,
                   bit_depth=depth)

    @classmethod
    def time_field(cls, quantum: str, no_standard_view: bool = False
                   ) -> "FieldOptions":
        return cls(type=FieldType.TIME, time_quantum=str(TimeQuantum(quantum)),
                   no_standard_view=no_standard_view)

    @classmethod
    def mutex_field(cls, cache_type: str = DEFAULT_CACHE_TYPE,
                    cache_size: int = DEFAULT_CACHE_SIZE) -> "FieldOptions":
        return cls(type=FieldType.MUTEX, cache_type=cache_type,
                   cache_size=cache_size)

    @classmethod
    def bool_field(cls) -> "FieldOptions":
        return cls(type=FieldType.BOOL, cache_type="none", cache_size=0)


class Field:
    #: largest stack, pool pair or plane stack kept in the device cache
    #: (bytes); a larger one serves its query alone, unless the operator
    #: sized the budget (``_entry_cap``; pilosa_tpu/models/field.py:231)
    ROW_STACK_CACHE_BYTES = 512 << 20
    #: the same for matrix stacks (pilosa_tpu/models/field.py:1150)
    MATRIX_STACK_CACHE_BYTES = 512 << 20

    def __init__(self, path: str | None, index: str, name: str,
                 options: FieldOptions, device: torch.device):
        validate_name(name)
        self.path = path
        self.index = index
        self.name = name
        self.options = options
        self.device = device
        self.views: dict[str, View] = {}
        self._shards: set[int] = set()
        # key -> (gens, value): row stacks, container leaves, delta
        # overlays, time-range and plane stacks, all tracked by the
        # process-wide residency manager
        self._device_cache: dict = {}
        # ("matrix", shards) -> device_matrix_stack entry
        self._matrix_stack_cache: dict = {}
        # weak reference to the owning Index (set by Index._adopt): the
        # prewarm worker needs the index's shard set
        self._index_ref = None
        self.closed = False
        # (view names, their parsed times): time_view_times' memo
        self._view_times_memo = None
        self._lock = threading.RLock()
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._load_meta()
            self._open_views()
        self._load_shards()
        self.row_attrs = AttrStore(
            None if path is None else os.path.join(path, ".row_attrs.db"))
        self._translate_store = None

    @property
    def translate_store(self):
        """The row-key translate store, opened at first use
        (pilosa_tpu/models/field.py:259-269)."""
        if self._translate_store is None:
            from pilosa_tpu_torch.storage.translate import \
                open_translate_store

            self._translate_store = open_translate_store(
                None if self.path is None
                else os.path.join(self.path, ".keys.db"))
        return self._translate_store

    # ------------------------------------------------------------ metadata

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    @property
    def _shards_path(self) -> str:
        return os.path.join(self.path, ".shards")

    def _load_meta(self) -> None:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.options = FieldOptions.from_dict(json.load(f))
        else:
            self.save_meta()

    def save_meta(self) -> None:
        if self.path is not None:
            atomic_write_json(self._meta_path, self.options.to_dict())

    def _load_shards(self) -> None:
        if self.path is not None and os.path.exists(self._shards_path):
            with open(self._shards_path) as f:
                self._shards = set(json.load(f))
        for view in self.views.values():
            self._shards |= view.available_shards()

    def _open_views(self) -> None:
        views_dir = os.path.join(self.path, "views")
        if not os.path.isdir(views_dir):
            return
        for name in sorted(os.listdir(views_dir)):
            self.views[name] = View(os.path.join(views_dir, name),
                                    self.index, self.name, name,
                                    **self._view_opts())

    def _view_opts(self) -> dict:
        return {"device": self.device, "mutex": self._is_mutex_like,
                "cache_type": self.options.cache_type,
                "cache_size": self.options.cache_size}

    @property
    def _is_mutex_like(self) -> bool:
        return self.options.type in (FieldType.MUTEX, FieldType.BOOL)

    @property
    def time_quantum(self) -> TimeQuantum:
        return TimeQuantum(self.options.time_quantum)

    @property
    def has_standard_rows(self) -> bool:
        """Whether plain ``Row(f=n)`` reads this field's standard view
        (not an int field, not a time field without one)."""
        o = self.options
        return not (o.type == FieldType.INT
                    or (o.type == FieldType.TIME and o.no_standard_view))

    @property
    def bsi_view_name(self) -> str:
        return VIEW_BSI_PREFIX + self.name

    def view(self, name: str) -> View | None:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                path = (None if self.path is None
                        else os.path.join(self.path, "views", name))
                v = View(path, self.index, self.name, name,
                         **self._view_opts())
                self.views[name] = v
            return v

    # -------------------------------------------------------------- shards

    def available_shards(self) -> set[int]:
        return set(self._shards)

    def _note_shards(self, shards) -> None:
        """Record shards with one .shards write."""
        shards = {int(s) for s in shards}
        with self._lock:
            new = shards - self._shards
            if new:
                self._shards |= new
                if self.path is not None:
                    atomic_write_json(self._shards_path, sorted(self._shards))

    # ------------------------------------------------------------- bit ops

    def set_bit(self, row: int, col: int,
                timestamp: _dt.datetime | None = None) -> bool:
        """Set a bit in the standard view and, with a timestamp, in one
        time view per quantum unit (reference Field.SetBit, field.go:927;
        pilosa_tpu/models/field.py:388-405).  Every check runs before any
        write."""
        if self.options.type == FieldType.INT:
            raise ValueError(f"field {self.name} is an int field; use "
                             f"set_value")
        if (self.options.type == FieldType.BOOL
                and row not in (FALSE_ROW_ID, TRUE_ROW_ID)):
            raise ValueError("bool field rows must be 0 or 1")
        if timestamp is not None and self.options.type != FieldType.TIME:
            raise ValueError(f"field {self.name} has no time quantum")
        changed = False
        if not (self.options.type == FieldType.TIME
                and self.options.no_standard_view):
            changed |= self.create_view_if_not_exists(VIEW_STANDARD).set_bit(
                row, col)
        if timestamp is not None:
            for name in views_by_time(VIEW_STANDARD, timestamp,
                                      self.time_quantum):
                changed |= self.create_view_if_not_exists(name).set_bit(
                    row, col)
        self._note_shards((col // SHARD_WIDTH,))
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        """Clear a bit from the standard view and every time view
        (reference Field.ClearBit, field.go:967)."""
        changed = False
        for name, view in list(self.views.items()):
            if name == VIEW_STANDARD or name.startswith(VIEW_STANDARD + "_"):
                changed |= view.clear_bit(row, col)
        return changed

    def fragment(self, shard: int):
        view = self.view(VIEW_STANDARD)
        return None if view is None else view.fragment(shard)

    def import_bits(self, rows, cols, timestamps=None,
                    clear: bool = False) -> None:
        """Bulk import of (row, col[, timestamp]) bits: positions grouped
        by (view, shard), one ``import_positions`` per fragment
        (pilosa_tpu/models/field.py:1566-1670).  A mutex or bool field
        sets its bits one by one, so that each column keeps one row; a
        timestamp adds the bit to its time views."""
        if len(rows) != len(cols):
            raise ValueError("rows and columns length mismatch")
        if timestamps is not None and len(timestamps) != len(rows):
            raise ValueError("timestamps length mismatch")
        if self.options.type == FieldType.INT:
            raise ValueError(f"field {self.name} is an int field; use "
                             f"import_values")
        max_row = ((1 << 63) - SHARD_WIDTH) // SHARD_WIDTH
        max_col = (1 << 63) - 1

        def check_pair(r: int, c: int) -> None:
            if r < 0 or c < 0:
                raise ValueError("negative row or column id in import")
            if r > max_row:
                raise ValueError("row id too large for position space")
            if c > max_col:
                raise ValueError("column id too large for position space")

        if self._is_mutex_like and not clear:
            for i, (r, c) in enumerate(zip(rows, cols)):
                r, c = int(r), int(c)
                check_pair(r, c)
                self.set_bit(r, c, None if timestamps is None
                             else timestamps[i])
            return
        # (view, shard) -> positions
        by_frag: dict = {}
        has_std = not (self.options.type == FieldType.TIME
                       and self.options.no_standard_view)
        if timestamps is None and has_std:
            try:
                rows_np = np.asarray(rows, dtype=np.int64)
                cols_np = np.asarray(cols, dtype=np.int64)
            except OverflowError:
                raise ValueError("row or column id out of range") from None
            if len(rows_np) and (rows_np.min() < 0 or cols_np.min() < 0):
                raise ValueError("negative row or column id in import")
            if len(rows_np) and rows_np.max() > max_row:
                raise ValueError("row id too large for position space")
            pos = rows_np * SHARD_WIDTH + (cols_np % SHARD_WIDTH)
            for shard, sel in bm.group_indices(cols_np // SHARD_WIDTH).items():
                by_frag[(VIEW_STANDARD, shard)] = pos[sel]
        else:
            for i, (r, c) in enumerate(zip(rows, cols)):
                r, c = int(r), int(c)
                check_pair(r, c)
                shard = c // SHARD_WIDTH
                pos = r * SHARD_WIDTH + (c % SHARD_WIDTH)
                if has_std:
                    by_frag.setdefault((VIEW_STANDARD, shard), []).append(pos)
                ts = None if timestamps is None else timestamps[i]
                if ts is not None:
                    for name in views_by_time(VIEW_STANDARD, ts,
                                              self.time_quantum):
                        by_frag.setdefault((name, shard), []).append(pos)
        done: set[int] = set()
        try:
            for (vname, shard), positions in by_frag.items():
                frag = self.create_view_if_not_exists(
                    vname).create_fragment_if_not_exists(int(shard))
                if clear:
                    frag.import_positions((), positions)
                else:
                    frag.import_positions(positions)
                done.add(int(shard))
        finally:
            self._note_shards(done)
        if not clear:
            # warm the fused path's stacks of the imported rows in the
            # background, hottest first (pilosa_tpu/models/field.py:
            # 1680-1698)
            uniq, cnt = np.unique(np.asarray(rows, dtype=np.int64),
                                  return_counts=True)
            self._prewarm([int(r) for r in uniq[np.argsort(
                -cnt, kind="stable")][:prewarm.ROW_CAP]])

    def import_roaring(self, shard: int, data: bytes, clear: bool = False,
                       view: str = VIEW_STANDARD) -> None:
        v = self.create_view_if_not_exists(view)
        v.create_fragment_if_not_exists(shard).import_roaring(data, clear)
        self._note_shards((shard,))

    # ------------------------------------------------------- device forms

    @staticmethod
    def _touch(cache: dict, key) -> None:
        residency.manager().touch(cache, key)

    @staticmethod
    def _note_access(cache: dict, key) -> None:
        """Tick the prefetcher's access-statistics table
        (observe.access_stats) for one entry."""
        _observe.note_access((id(cache), key))

    def _tier_consult(self, cache: dict, key, gens, valid):
        """Host-tier consult after an owner-cache miss
        (pilosa_tpu/models/field.py:504-534): enqueue the async promotion
        (single-flight per key), wait a bounded slice of the request's
        deadline, and return ``("dev", entry)`` when the promoted entry
        landed in time (``valid`` re-checks it) -- else ``("host",
        value)``, the host-bytes route: the host bytes uploaded for this
        one query, uncached, read by the same kernels (the promotion
        keeps running for the next query).  None on a true cold miss: the
        caller assembles from fragment state."""
        mgr = residency.manager()
        ent = mgr.host_lookup(cache, key, gens)
        if ent is None:
            return None
        fl = residency.promoter().submit(ent)
        if fl is not None:
            fl.event.wait(residency.promote_wait_s(_deadline.current()))
        with self._lock:
            hit = cache.get(key)
            if hit is not None and valid(hit):
                self._touch(cache, key)
                return ("dev", hit)
        mgr.note_fallback()
        return ("host", ent.host_value())

    def _lookup(self, cache: dict, key, gens):
        """A (gens, value) entry's value: an HBM hit, the host tier's
        promoted entry or host-bytes value, or None on a cold miss."""
        self._note_access(cache, key)
        with self._lock:
            hit = cache.get(key)
            if hit is not None and hit[0] == gens:
                self._touch(cache, key)
                return hit[1]
        tiered = self._tier_consult(cache, key, gens,
                                    lambda h: h[0] == gens)
        if tiered is None:
            return None
        return tiered[1][1] if tiered[0] == "dev" else tiered[1]

    @staticmethod
    def _entry_cap(fixed_cap: int) -> int:
        """Per-entry cacheability cap (pilosa_tpu/models/field.py:
        638-652): the fixed default, or a quarter of the residency
        budget when the OPERATOR sized the budget
        (``PILOSA_TPU_DEVICE_BUDGET_BYTES``) for a bigger working set.  A
        probed default budget never relaxes the cap: a giant one-off
        stack stays uncacheable rather than evict the warm cache."""
        mgr = residency.manager()
        if not mgr.operator_sized:
            return fixed_cap
        return max(fixed_cap, mgr.budget // 4)

    def _evict_and_insert(self, cache: dict, key, entry, entry_bytes: int,
                          max_entries: int, kind: str = "dense",
                          token=None, host=None, promote=None,
                          fallback=None, kind_detail=None) -> None:
        """Insert under the entry cap; BYTE budgeting is global -- the
        process-wide residency manager sees every owner's device caches
        and evicts across all of them (pilosa_tpu/models/field.py:
        1077-1111).  The manager may concurrently pop entries from this
        dict under its own lock, so every removal here tolerates a
        vanished key, and the admit happens inside self._lock so the
        inserted entry can't be popped before it is tracked.
        ``token``+``host``+``promote`` opt the entry into the host tier;
        cap evictions DEMOTE too."""
        mgr = residency.manager()
        with self._lock:
            if cache.pop(key, None) is not None:
                mgr.forget(cache, key)
            while len(cache) >= max_entries:
                try:
                    k = next(iter(cache))
                except StopIteration:
                    break
                cache.pop(k, None)
                mgr.demote(cache, k)
            cache[key] = entry
            mgr.admit(cache, key, entry_bytes, kind=kind, token=token,
                      host=host, promote=promote, fallback=fallback,
                      kind_detail=kind_detail)

    def _place_and_cache_stack(self, key, gens, stack: np.ndarray
                               ) -> torch.Tensor:
        """Upload a host stack and cache it with its host twin, unless
        it is over the entry cap (then it serves this query alone)."""
        dev = bm.to_tensor(stack, self.device)
        if stack.nbytes > self._entry_cap(self.ROW_STACK_CACHE_BYTES):
            return dev  # uncacheable; never evict the warm cache for it
        upload = functools.partial(bm.to_tensor, device=self.device)

        def promote(arr, _g=gens):
            return (_g, upload(arr))

        self._evict_and_insert(self._device_cache, key, (gens, dev),
                               stack.nbytes, max_entries=64, token=gens,
                               host=stack, promote=promote,
                               fallback=upload)
        return dev

    def device_row_stack(self, row_id: int, shards: tuple[int, ...]
                         ) -> torch.Tensor:
        """One standard-view BASE row across ``shards`` as an int32
        [n_shards, words] tensor on the field's device; missing
        fragments contribute zero rows.  A pending delta does not
        invalidate it: the executor fuses the overlay on top
        (``device_delta_stacks``)."""
        frags = [self.fragment(s) for s in shards]
        gens = tuple(_frag_base_gen(fr) for fr in frags)
        key = ("row", row_id, shards)
        got = self._lookup(self._device_cache, key, gens)
        if got is not None:
            return got
        stack = np.zeros((len(shards), bm.n_words(SHARD_WIDTH)),
                         dtype=np.uint32)
        for i, frag in enumerate(frags):
            if frag is not None:
                with frag._lock:
                    arr = frag._rows.get(row_id)
                    if arr is not None:
                        stack[i] = arr
        return self._place_and_cache_stack(key, gens, stack)

    @staticmethod
    def _leaf_on(device: torch.device, d: dict, payload
                 ) -> ct.ContainerLeaf:
        """A ContainerLeaf of the directory ``d`` over the host pools
        ``payload`` uploaded to ``device``: the cold build's, the
        promotion's and the host-bytes route's one constructor.  A kinds
        payload is the (bitmap, array, card, run) pool tuple."""
        if isinstance(payload, tuple):
            pool, apool, acard, rpool = payload
            return ct.ContainerLeaf(
                **d, pool=bm.to_tensor(pool, device),
                apool=torch.from_numpy(apool.view(np.int16)).to(device),
                acard=torch.from_numpy(acard).to(device),
                rpool=torch.from_numpy(rpool.view(np.int16)).to(device))
        return ct.ContainerLeaf(**d, pool=bm.to_tensor(payload, device))

    def device_container_leaf(self, row_id: int, shards: tuple[int, ...]):
        """One standard-view row across ``shards`` in pooled compressed
        form (ops/containers.ContainerLeaf).  A shard whose row is over
        the fill-ratio threshold gets a None directory entry, the
        caller's evidence to route the query dense.  With [containers]
        kinds on, each container takes its cheapest kind and a row with
        any array or run container splits into the three kind pools
        (``_build_kinds_leaf``); an all-bitmap row keeps the one-pool
        layout.  Tracked as ``"compressed"`` with its host pools as the
        twin."""
        frags = [self.fragment(s) for s in shards]
        # the threshold and the kind knobs join the token: a cached leaf
        # froze each fragment's sparse-vs-hot verdict and its layout
        cfg = ct.config()
        kinds_on = bool(cfg.kinds)
        gens = (cfg.threshold, kinds_on, cfg.array_max, cfg.run_cap,
                *(_frag_base_gen(fr) for fr in frags))
        key = ("cont", row_id, shards)
        got = self._lookup(self._device_cache, key, gens)
        if got is not None:
            return got
        entries: list = []
        starts: list[int] = []
        kinds: list = []  # per shard: kind bytes, or None (hot row)
        blocks_list: list[np.ndarray] = []
        n = 0
        for fr in frags:
            starts.append(n)
            if fr is None:
                entries.append(np.empty(0, dtype=np.int64))
                kinds.append(np.empty(0, dtype=np.uint8))
                continue
            rc = (fr.row_container_kinds(row_id) if kinds_on
                  else fr.row_containers(row_id))
            if rc is None:
                entries.append(None)
                kinds.append(None)
                continue
            entries.append(rc[0])
            kinds.append(rc[3] if kinds_on else None)
            if len(rc[0]):
                blocks_list.append(rc[1])
                n += len(rc[0])
        d, payload, kd = None, None, None
        if kinds_on:
            flat_kinds = np.concatenate(
                [np.empty(0, dtype=np.uint8)]
                + [k for k in kinds if k is not None])
            if bool((flat_kinds != 1).any()):
                d, payload = self._build_kinds_leaf(
                    shards, entries, starts, kinds, blocks_list, flat_kinds)
                kd = {"array": int(payload[1].nbytes + payload[2].nbytes),
                      "run": int(payload[3].nbytes)}
        if d is None:
            payload = ct.build_pool(blocks_list, n)
            d = dict(shards=shards, entries=entries, starts=starts, n=n,
                     nbytes=payload.nbytes)
        leaf = self._leaf_on(self.device, d, payload)
        if leaf.nbytes <= self._entry_cap(self.ROW_STACK_CACHE_BYTES):
            on = functools.partial(self._leaf_on, self.device, d)

            def promote(p, _g=gens):
                return (_g, on(p))

            self._evict_and_insert(self._device_cache, key, (gens, leaf),
                                   leaf.nbytes, max_entries=64,
                                   kind="compressed", token=gens,
                                   host=payload, promote=promote,
                                   fallback=on, kind_detail=kd)
        return leaf

    @staticmethod
    def _build_kinds_leaf(shards, entries, starts, kinds, blocks_list,
                          flat_kinds) -> tuple[dict, tuple]:
        """Split a mixed-kind directory into the per-kind compact pools
        (ops/kindpools.split_pools): the kinds leaf's directory and its
        host (bitmap, array, card, run) pools
        (pilosa_tpu/models/field.py:986).  Every pool keeps at least one
        canonical empty tail row -- the absent-container gather target --
        and pads its row count to pow2, as the bitmap pool does."""
        flat_blocks = np.concatenate(blocks_list, axis=0)
        slots_flat, bblocks, apool_t, acard_t, rpool_t = kp.split_pools(
            flat_blocks, flat_kinds)
        slots = []
        off = 0
        for ks in kinds:
            if ks is None:
                slots.append(None)
                continue
            slots.append(slots_flat[off:off + len(ks)])
            off += len(ks)
        bn, an, rn = (int(x.shape[0]) for x in (bblocks, apool_t, rpool_t))
        pool = ct.build_pool([bblocks], bn)
        apool = np.full((ct._pow2(an + 1), apool_t.shape[1]), kp.ARRAY_PAD,
                        dtype=np.uint16)
        apool[:an] = apool_t
        acard = np.zeros(apool.shape[0], dtype=np.int32)
        acard[:an] = acard_t
        rpool = np.zeros((ct._pow2(rn + 1), rpool_t.shape[1]),
                         dtype=np.uint16)
        rpool[:, 0::2] = 1  # (1, 0): the canonical invalid pair
        rpool[:rn] = rpool_t
        nbytes = pool.nbytes + apool.nbytes + acard.nbytes + rpool.nbytes
        d = dict(shards=shards, entries=entries, starts=starts, n=bn,
                 nbytes=nbytes, kinds=kinds, slots=slots, an=an, rn=rn)
        return d, (pool, apool, acard, rpool)

    def _cached_untiered(self, key, toks, build, kind: str = "dense"):
        """A form with no host twin (the delta overlays,
        pilosa_tpu/models/field.py:678-825): a hit on ``toks``, else
        ``build() -> (value, nbytes)`` tracked under the entry cap."""
        cache = self._device_cache
        with self._lock:
            hit = cache.get(key)
            if hit is not None and hit[0] == toks:
                self._touch(cache, key)
                return hit[1]
        value, nbytes = build()
        if nbytes <= self._entry_cap(self.ROW_STACK_CACHE_BYTES):
            self._evict_and_insert(cache, key, (toks, value), nbytes,
                                   max_entries=64, kind=kind)
        return value

    def device_delta_stacks(self, row_id: int, shards: tuple[int, ...]):
        """The pending overlays of one standard-view row across
        ``shards`` as a pair of int32 [n_shards, words] tensors ``(set,
        clear)``, the operands of ops/expr's ``dfuse`` node, or None when
        no fragment has an overlay for the row
        (pilosa_tpu/models/field.py:678-737).  The executor stages them
        BEFORE the base stack: re-applying an overlay that a concurrent
        compaction has merged gives the same words."""
        frags = [self.fragment(s) for s in shards]
        toks = _delta_tokens(frags, row_id)
        if toks is None:
            return None

        def build():
            n_words = bm.n_words(SHARD_WIDTH)
            sets, clears = _delta_words(frags, row_id)
            out = []
            for words in (sets, clears):
                stack = np.zeros((len(shards), n_words), dtype=np.uint32)
                for i, w in enumerate(words):
                    if w is not None:
                        stack[i] = w
                out.append(bm.to_tensor(stack, self.device))
            return tuple(out), 2 * len(shards) * n_words * 4

        return self._cached_untiered(("delta", row_id, shards), toks, build)

    def device_delta_container_leaves(self, row_id: int,
                                      shards: tuple[int, ...]):
        """The pending overlays of one standard-view row across
        ``shards`` as a pair of all-bitmap ContainerLeaf ``(set, clear)``
        -- each shard's non-empty overlay containers pooled -- the
        operands of the VM's ``dfuse`` tapes, or None when no fragment
        has an overlay for the row (pilosa_tpu/models/field.py:739-825).
        Cached like ``device_delta_stacks``, as ``"compressed"``."""
        frags = [self.fragment(s) for s in shards]
        toks = _delta_tokens(frags, row_id)
        if toks is None:
            return None
        cpr = SHARD_WIDTH // ct.CONTAINER_BITS

        def build():
            pair = []
            for per_shard in _delta_words(frags, row_id):
                entries: list = []
                starts: list[int] = []
                blocks_list: list[np.ndarray] = []
                n = 0
                for words in per_shard:
                    starts.append(n)
                    if words is None:
                        entries.append(np.empty(0, dtype=np.int64))
                        continue
                    blocks = words.reshape(cpr, ct.CWORDS)
                    keys = np.flatnonzero(blocks.any(axis=1)).astype(
                        np.int64)
                    entries.append(keys)
                    if len(keys):
                        blocks_list.append(blocks[keys])
                        n += len(keys)
                pool = ct.build_pool(blocks_list, n)
                pair.append(ct.ContainerLeaf(
                    shards, entries, starts, bm.to_tensor(pool, self.device),
                    n, pool.nbytes))
            return tuple(pair), pair[0].nbytes + pair[1].nbytes

        return self._cached_untiered(("dcont", row_id, shards), toks, build,
                                     kind="compressed")

    def flush_deltas(self, shards=None) -> int:
        """Merge the pending deltas of this field's fragments (of
        ``shards``, or all) into their base rows: the ``?nodelta=1``
        escape (pilosa_tpu/models/field.py:1064).  Returns the bit
        positions merged."""
        merged = 0
        for view in list(self.views.values()):
            frags = (list(view.fragments.values()) if shards is None
                     else [view.fragment(s) for s in shards])
            for frag in frags:
                if frag is not None:
                    merged += frag.flush_delta()
        return merged

    def device_matrix_stack(self, shards: tuple[int, ...]):
        """The standard-view row matrices of ``shards`` concatenated
        along the row axis, in shard order, for the fused TopN scan
        (pilosa_tpu/models/field.py:1152): ``(gens, row_ids int64[N],
        shard_pos int32[N] on the host, shard_pos on the device, int32
        [N, words] matrix on the device)``, where ``shard_pos[i]`` is the
        position of row i's shard in ``shards`` and ``gens[i]`` that
        shard's fragment token.  One device, so no pad rows.  With every
        fragment empty it returns ``(gens, [], None, None, None)``,
        uncached.  Cached per shard tuple with its host halves as the
        twin, except a stack over the entry cap
        (``MATRIX_STACK_CACHE_BYTES``)."""
        view = self.view(VIEW_STANDARD)
        frags = [None if view is None else view.fragment(s) for s in shards]
        gens = []
        parts = []  # (pos, row_ids, host matrix) per non-empty fragment
        for i, frag in enumerate(frags):
            if frag is None:
                gens.append(0)
                continue
            with frag._lock:
                ids, mat = frag._stacked()
                gens.append(_frag_gen(frag))
            if len(ids):
                parts.append((i, ids, mat))
        gens = tuple(gens)
        cache = self._matrix_stack_cache
        key = ("matrix", shards)
        self._note_access(cache, key)
        with self._lock:
            hit = cache.get(key)
            if hit is not None and hit[0] == gens:
                self._touch(cache, key)
                return hit
        tiered = self._tier_consult(cache, key, gens,
                                    lambda h: h[0] == gens)
        if tiered is not None:
            return tiered[1]
        if not parts:
            return (gens, np.empty(0, dtype=np.int64), None, None, None)
        row_ids = np.concatenate([ids for _, ids, _ in parts])
        shard_pos = np.concatenate(
            [np.full(len(ids), pos, dtype=np.int32) for pos, ids, _ in parts])
        big = np.concatenate([m for _, _, m in parts], axis=0)
        on = functools.partial(self._matrix_on, self.device, gens)
        entry = on((row_ids, shard_pos, big))
        if big.nbytes > self._entry_cap(self.MATRIX_STACK_CACHE_BYTES):
            return entry  # uncacheable; the warm entries stay
        self._evict_and_insert(cache, key, entry, big.nbytes, max_entries=8,
                               token=gens, host=(row_ids, shard_pos, big),
                               promote=on, fallback=on)
        return entry

    @staticmethod
    def _matrix_on(device: torch.device, gens, payload) -> tuple:
        """A matrix-stack entry over the host halves ``payload`` uploaded
        to ``device``."""
        ids, pos, big = payload
        return (gens, ids, pos, torch.from_numpy(pos).to(device),
                bm.to_tensor(big, device))

    # ------------------------------------------------------- time views

    def time_view_times(self) -> list:
        """The times encoded in this field's time-view names, memoized per
        view-name set (pilosa_tpu/models/field.py:1243): the executor
        clamps an open range to them."""
        with self._lock:
            names = tuple(self.views)
            memo = self._view_times_memo
            if memo is not None and memo[0] == names:
                return memo[1]
            times = []
            for name in names:
                part = name.rsplit("_", 1)[-1]
                if part.isdigit():
                    fmt = {4: "%Y", 6: "%Y%m", 8: "%Y%m%d",
                           10: "%Y%m%d%H"}.get(len(part))
                    if fmt:
                        times.append(_dt.datetime.strptime(part, fmt))
            self._view_times_memo = (names, times)
            return times

    def row_time(self, row_id: int, shard: int, start, end
                 ) -> np.ndarray | None:
        """One shard's row unioned over the views covering [start, end)
        (reference Field.RowTime; pilosa_tpu/models/field.py:1262-1277):
        effective host words, or None when no covering view holds the
        shard."""
        if not self.time_quantum:
            raise ValueError(f"field {self.name} has no time quantum")
        out = None
        for name in views_by_time_range(VIEW_STANDARD, start, end,
                                        self.time_quantum):
            view = self.view(name)
            frag = None if view is None else view.fragment(shard)
            if frag is None:
                continue
            words = frag.row(row_id)
            out = words if out is None else (out | words)
        return out

    def device_time_row_stack(self, row_id: int, shards: tuple[int, ...],
                              view_names: tuple[str, ...]) -> torch.Tensor:
        """One row unioned over a set of time views across ``shards``, as
        one int32 [n_shards, words] stack on the device: the fused
        time-range Row's operand (pilosa_tpu/models/field.py:576).  The
        union runs on the host over the fragments' effective words, so a
        wide cover is one cache entry and one transfer.  Cached per (row,
        shards, views); every contributing fragment's ``(uid, gen,
        delta_seq)`` invalidates it."""
        views = [self.view(vn) for vn in view_names]
        grid = [[None if v is None else v.fragment(s) for v in views]
                for s in shards]
        gens = tuple(tuple(_frag_gen(fr) for fr in frags) for frags in grid)
        key = ("time", row_id, shards, view_names)
        got = self._lookup(self._device_cache, key, gens)
        if got is not None:
            return got
        stack = np.zeros((len(shards), bm.n_words(SHARD_WIDTH)),
                         dtype=np.uint32)
        for i, frags in enumerate(grid):
            for fr in frags:
                if fr is None:
                    continue
                with fr._lock:
                    d = fr._delta
                    arr = (fr.row(row_id) if d is not None
                           and d.row_touched(row_id)
                           else fr._rows.get(row_id))
                    if arr is not None:
                        np.bitwise_or(stack[i], arr, out=stack[i])
        return self._place_and_cache_stack(key, gens, stack)

    # ------------------------------------------------------------ BSI

    def _require_int(self) -> None:
        if self.options.type != FieldType.INT:
            raise ValueError(f"field {self.name} is not an int field")

    def _bsi_fragment(self, shard: int):
        view = self.view(self.bsi_view_name)
        return None if view is None else view.fragment(shard)

    def set_value(self, col: int, value: int) -> bool:
        """(reference Field.SetValue, field.go:1075): range-checked,
        base-relative, the depth grown (and saved) when a value needs
        more bits."""
        self._require_int()
        o = self.options
        if value < o.min:
            raise ValueError(f"value {value} below field minimum {o.min}")
        if value > o.max:
            raise ValueError(f"value {value} above field maximum {o.max}")
        base_value = value - o.base
        required = bit_depth(abs(base_value))
        if required > 63:
            raise ValueError("value is more than 63 bits from the field base")
        if required > o.bit_depth:
            with self._lock:
                o.bit_depth = required
                self.save_meta()
        view = self.create_view_if_not_exists(self.bsi_view_name)
        changed = view.set_value(col, o.bit_depth, base_value)
        self._note_shards((col // SHARD_WIDTH,))
        return changed

    def value(self, col: int) -> tuple[int, bool]:
        """(reference Field.Value, field.go:1053)"""
        self._require_int()
        view = self.view(self.bsi_view_name)
        if view is None:
            return 0, False
        v, ok = view.value(col, self.options.bit_depth)
        if not ok:
            return 0, False
        return v + self.options.base, True

    def clear_value(self, col: int) -> bool:
        self._require_int()
        frag = self._bsi_fragment(col // SHARD_WIDTH)
        return (False if frag is None
                else frag.clear_value(col, self.options.bit_depth))

    def _filter_segment(self, filter_row, shard: int):
        """(skip, words): a filter row's segment of one shard; skip when
        there is a filter and the shard has no bits in it."""
        if filter_row is None:
            return False, None
        fw = filter_row.shard_segment(shard)
        return fw is None, fw

    def sum(self, filter_row, shard: int) -> tuple[int, int]:
        """Per-shard (sum, count) with the base added back (reference
        Field.Sum, field.go:1121: sum + count*base)."""
        self._require_int()
        frag = self._bsi_fragment(shard)
        skip, fw = self._filter_segment(filter_row, shard)
        if frag is None or skip:
            return 0, 0
        s, c = frag.sum(fw, self.options.bit_depth)
        return s + c * self.options.base, c

    def _extreme(self, which: str, filter_row, shard: int):
        self._require_int()
        frag = self._bsi_fragment(shard)
        skip, fw = self._filter_segment(filter_row, shard)
        if frag is None or skip:
            return None
        v, c = getattr(frag, which)(fw, self.options.bit_depth)
        if c == 0:
            return None
        return v + self.options.base, c

    def min(self, filter_row, shard: int):
        return self._extreme("min", filter_row, shard)

    def max(self, filter_row, shard: int):
        return self._extreme("max", filter_row, shard)

    @property
    def bit_depth_min(self) -> int:
        """(reference bitDepthMin, field.go:1636)"""
        return self.options.base - (1 << self.options.bit_depth) + 1

    @property
    def bit_depth_max(self) -> int:
        """(reference bitDepthMax, field.go:1641)"""
        return self.options.base + (1 << self.options.bit_depth) - 1

    def base_value(self, op: str, value: int) -> tuple[int, bool]:
        """An absolute predicate made base-relative, with out-of-range
        detection (reference bsiGroup.baseValue, field.go:1583-1612).
        Kept from pilosa_tpu/models/field.py:1428-1452, divergence
        included: a GT predicate exactly at the representable minimum
        keeps its true base value rather than clamping to 0 (the
        reference's `value > min` guard turns `> min` into `> base`,
        dropping every negative; untested upstream)."""
        lo, hi = self.bit_depth_min, self.bit_depth_max
        base = self.options.base
        if op in (">", ">="):
            if value > hi:
                return 0, True  # nothing can exceed the representable max
            return max(value, lo) - base, False
        if op in ("<", "<="):
            if value < lo:
                return 0, True  # nothing can undercut the representable min
            return min(value, hi) - base, False
        if op in ("==", "!="):
            if value < lo or value > hi:
                return 0, True
            return value - base, False
        raise ValueError(f"invalid range operator: {op}")

    def base_value_between(self, lo_v: int, hi_v: int
                           ) -> tuple[int, int, bool]:
        """(reference baseValueBetween, field.go:1614-1628)"""
        lo, hi = self.bit_depth_min, self.bit_depth_max
        if hi_v < lo or lo_v > hi:
            return 0, 0, True
        lo_v = max(lo_v, lo)
        hi_v = min(hi_v, hi)
        return lo_v - self.options.base, hi_v - self.options.base, False

    def _classify_range(self, op: str, value):
        """Shard-independent predicate preprocessing shared by the
        per-shard and fused range paths (executor.go:1616-1661): one of
        ("empty",), ("not_null",), ("op", op, base_pred) or ("between",
        blo, bhi)."""
        o = self.options
        if op == "><":
            lo_v, hi_v = value
            blo, bhi, out_of_range = self.base_value_between(lo_v, hi_v)
            if out_of_range:
                return ("empty",)
            if lo_v <= o.min and hi_v >= o.max:
                return ("not_null",)
            return ("between", blo, bhi)
        if value is None:
            if op == "!=":
                return ("not_null",)
            raise ValueError("EQ null condition is not supported")
        predicate = value
        base_pred, out_of_range = self.base_value(op, predicate)
        if out_of_range and op != "!=":
            return ("empty",)
        if (
            (op == "<" and predicate > o.max)
            or (op == "<=" and predicate >= o.max)
            or (op == ">" and predicate < o.min)
            or (op == ">=" and predicate <= o.min)
        ):
            return ("not_null",)
        if out_of_range:  # op is "!="
            return ("not_null",)
        return ("op", op, base_pred)

    def _range_shard(self, op: str, value, shard: int):
        self._require_int()
        frag = self._bsi_fragment(shard)
        if frag is None:
            return None
        plan = self._classify_range(op, value)
        depth = self.options.bit_depth
        if plan[0] == "empty":
            return None
        if plan[0] == "not_null":
            return frag.not_null(depth)
        if plan[0] == "between":
            return frag.range_between(depth, plan[1], plan[2])
        return frag.range_op(plan[1], depth, plan[2])

    def range_op(self, op: str, predicate: int, shard: int):
        """Per-shard BSI comparison in absolute value space -> int32
        words on the device, or None."""
        return self._range_shard(op, predicate, shard)

    def range_between(self, lo_v: int, hi_v: int, shard: int):
        return self._range_shard("><", [lo_v, hi_v], shard)

    def not_null(self, shard: int):
        self._require_int()
        frag = self._bsi_fragment(shard)
        return (None if frag is None
                else frag.not_null(self.options.bit_depth))

    def device_plane_stack(self, shards: tuple[int, ...]) -> torch.Tensor:
        """Every shard's BSI planes as one int32 [n_shards, 2 + depth,
        words] tensor on the field's device (exists, sign, then the
        magnitude planes; missing fragments and rows zero), the fused
        aggregates' and range rows' operand
        (pilosa_tpu/models/field.py:1279-1327).  Cached like
        ``device_row_stack``."""
        self._require_int()
        depth = self.options.bit_depth
        view = self.view(self.bsi_view_name)
        frags = [None if view is None else view.fragment(s) for s in shards]
        gens = tuple(_frag_gen(fr) for fr in frags)
        key = ("planes", shards, depth)
        got = self._lookup(self._device_cache, key, gens)
        if got is not None:
            return got
        n_planes = bsi_ops.OFFSET_PLANE + depth
        stack = np.zeros((len(shards), n_planes, bm.n_words(SHARD_WIDTH)),
                         dtype=np.uint32)
        for i, frag in enumerate(frags):
            if frag is None:
                continue
            with frag._lock:
                for p in range(n_planes):
                    arr = frag._rows.get(p)
                    if arr is not None:
                        stack[i, p] = arr
        return self._place_and_cache_stack(key, gens, stack)

    def device_range_stack(self, op: str, value, shards: tuple[int, ...]
                           ) -> torch.Tensor:
        """The stacked range row int32 [n_shards, words]: op '><' takes
        [lo, hi], op '!=' with value None means not-null
        (pilosa_tpu/models/field.py:1521-1562).  Each compare is one K6
        launch over every shard."""
        self._require_int()
        P = self.device_plane_stack(shards)
        plan = self._classify_range(op, value)
        if plan[0] == "empty":
            return torch.zeros((P.shape[0], P.shape[2]), dtype=torch.int32,
                               device=P.device)
        if plan[0] == "not_null":
            return P[:, bsi_ops.EXISTS_PLANE].contiguous()
        if plan[0] == "between":
            return bsi_ops.between_words(P, plan[1], plan[2])
        return bsi_ops.range_words(P, plan[1], plan[2])

    def import_values(self, cols, values) -> None:
        """Bulk import of BSI values: one set/clear position batch per
        shard (reference Field.importValue, field.go:1284-1345;
        pilosa_tpu/models/field.py:1700).  Floats raise TypeError and
        values outside [min, max] ValueError."""
        self._require_int()
        if not isinstance(cols, np.ndarray):
            cols = list(cols)
        if not isinstance(values, np.ndarray):
            values = list(values)
        if len(cols) != len(values):
            raise ValueError("columns and values length mismatch")
        if len(cols) == 0:
            return
        o = self.options
        cols_np = np.asarray(cols, dtype=np.int64)
        if cols_np.min() < 0:
            raise ValueError("negative column id in import")
        raw = values if isinstance(values, np.ndarray) else np.asarray(values)
        if np.issubdtype(raw.dtype, np.floating):
            raise TypeError("BSI values must be integers")
        if raw.dtype == object:
            # mixed or big ints: range-check in Python first
            for v in raw.tolist():
                if not isinstance(v, int):
                    raise TypeError("BSI values must be integers")
                if v < o.min or v > o.max:
                    raise ValueError(f"value {v} outside field range "
                                     f"[{o.min}, {o.max}]")
            vals_np = np.asarray(raw.tolist(), dtype=np.int64)
        else:
            vals_np = raw.astype(np.int64, copy=False)
        bad = vals_np[(vals_np < o.min) | (vals_np > o.max)]
        if len(bad):
            raise ValueError(f"value {int(bad[0])} outside field range "
                             f"[{o.min}, {o.max}]")
        bv = vals_np - o.base
        uv = np.abs(bv)
        required = bit_depth(int(uv.max()))
        if required > o.bit_depth:
            with self._lock:
                o.bit_depth = required
                self.save_meta()
        depth = o.bit_depth
        view = self.create_view_if_not_exists(self.bsi_view_name)
        off = cols_np % SHARD_WIDTH
        planes = np.arange(depth, dtype=np.int64)
        done: set[int] = set()
        try:
            for shard, sel in bm.group_indices(cols_np // SHARD_WIDTH).items():
                offs = off[sel]
                bits = (uv[sel][:, None] >> planes[None, :]) & 1
                pos = ((bsi_ops.OFFSET_PLANE + planes)[None, :]
                       * SHARD_WIDTH + offs[:, None])
                neg = bv[sel] < 0
                sets = np.concatenate([
                    pos[bits == 1],
                    bsi_ops.EXISTS_PLANE * SHARD_WIDTH + offs,
                    bsi_ops.SIGN_PLANE * SHARD_WIDTH + offs[neg],
                ])
                clears = np.concatenate([
                    pos[bits == 0],
                    bsi_ops.SIGN_PLANE * SHARD_WIDTH + offs[~neg],
                ])
                frag = view.create_fragment_if_not_exists(int(shard))
                frag.import_positions(sets, clears)
                done.add(int(shard))
        finally:
            self._note_shards(done)
        self._prewarm(())  # an int field warms its BSI plane stack

    def _prewarm(self, rows) -> None:
        """Enqueue a background stack prewarm for this field (no-op
        without an owning index or with PILOSA_TPU_PREWARM=0)."""
        idx = self._index_ref() if self._index_ref is not None else None
        if idx is not None:
            prewarm.enqueue(idx, self, rows)

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Close every fragment and let go of every device form this
        field built: its own caches with their residency accounting
        (pilosa_tpu/models/field.py:1796-1813), and the coalescer's and
        the container engine's memo entries over its container leaves."""
        self.closed = True
        for view in self.views.values():
            view.close()
        self.row_attrs.close()
        if self._translate_store is not None:
            self._translate_store.close()
        mgr = residency.manager()
        with self._lock:
            uids = set()
            for _gens, value in list(self._device_cache.values()):
                for leaf in (value if isinstance(value, tuple) else (value,)):
                    if isinstance(leaf, ct.ContainerLeaf):
                        uids.add(leaf.uid)
            for cache in (self._device_cache, self._matrix_stack_cache):
                mgr.forget_owner(cache)
                cache.clear()
        ct.forget_leaves(uids)

    def snapshot(self) -> None:
        for view in self.views.values():
            view.snapshot()
