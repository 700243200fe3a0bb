"""Field: a set of rows over an index's columns.

Port of pilosa_tpu/models/field.py for ``set`` fields: metadata and
shard-list files in the reference's format, bit writes and bulk import
into the standard view, and the two device forms of a row across a shard
set that the fused executor reads:

- ``device_row_stack`` -- the dense int32 [n_shards, words] stack
  (pilosa_tpu/models/field.py:420-473);
- ``device_container_leaf`` -- the pooled compressed form
  (pilosa_tpu/models/field.py:827-984) in the all-bitmap layout: the
  non-empty containers of every shard in one int32[_pow2(n + 1), 2048]
  pool on the device, row ``n`` the all-zero absent container.

Both are cached in one plain per-field dict keyed on the fragments'
``(_uid, _gen)``; any write to a fragment makes its entries miss.  The
TopN scan's operand, ``device_matrix_stack`` (every row of a shard set
in one matrix), has a cache of its own with the reference's size cap.  The
other field types (int, time, mutex, bool) are not part of the port yet:
their options still load, so a data directory holding them opens, but
the API refuses to create them.
"""

from __future__ import annotations

import json
import os
import re
import threading
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.models.view import VIEW_STANDARD, View
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import containers as ct
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class FieldType:
    SET = "set"
    INT = "int"
    TIME = "time"
    MUTEX = "mutex"
    BOOL = "bool"


DEFAULT_CACHE_TYPE = "ranked"
DEFAULT_CACHE_SIZE = 50000

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")
# internal names (the hidden existence field) carry a leading underscore
_INTERNAL_NAME_RE = re.compile(r"^_[a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    if not (_NAME_RE.match(name) or _INTERNAL_NAME_RE.match(name)):
        raise ValueError(f"invalid name: {name!r}")


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
    """Cache token of one fragment slot: (uid, gen), 0 when absent."""
    return 0 if fr is None else (fr._uid, fr._gen)


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


class Field:
    #: device stacks and pools kept per field (oldest evicted first)
    DEVICE_CACHE_ENTRIES = 64

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
        # key -> (gens, value): device row stacks and container leaves
        self._device_cache: dict = {}
        # ("matrix", shards) -> device_matrix_stack entry
        self._matrix_stack_cache: dict = {}
        self._lock = threading.RLock()
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._load_meta()
            self._open_views()
        self._load_shards()

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
        return {"device": self.device, "cache_type": self.options.cache_type,
                "cache_size": self.options.cache_size}

    @property
    def has_standard_rows(self) -> bool:
        """Whether plain ``Row(f=n)`` reads this field's standard view
        (not an int field, not a time field without one)."""
        o = self.options
        return not (o.type == FieldType.INT
                    or (o.type == FieldType.TIME and o.no_standard_view))

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

    def set_bit(self, row: int, col: int) -> bool:
        changed = self.create_view_if_not_exists(VIEW_STANDARD).set_bit(
            row, col)
        self._note_shards((col // SHARD_WIDTH,))
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        view = self.view(VIEW_STANDARD)
        return False if view is None else view.clear_bit(row, col)

    def fragment(self, shard: int):
        view = self.view(VIEW_STANDARD)
        return None if view is None else view.fragment(shard)

    def import_bits(self, rows, cols, clear: bool = False) -> None:
        """Bulk import of (row, col) bits: one ``import_positions`` per
        shard (pilosa_tpu/models/field.py:1566)."""
        if len(rows) != len(cols):
            raise ValueError("rows and columns length mismatch")
        max_row = ((1 << 63) - SHARD_WIDTH) // SHARD_WIDTH
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
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        done: set[int] = set()
        try:
            for shard, sel in bm.group_indices(cols_np // SHARD_WIDTH).items():
                frag = view.create_fragment_if_not_exists(shard)
                if clear:
                    frag.import_positions((), pos[sel])
                else:
                    frag.import_positions(pos[sel])
                done.add(shard)
        finally:
            self._note_shards(done)

    def import_roaring(self, shard: int, data: bytes,
                       clear: bool = False) -> None:
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        view.create_fragment_if_not_exists(shard).import_roaring(data, clear)
        self._note_shards((shard,))

    # ------------------------------------------------------- device forms

    def _cached(self, key, gens, build):
        """The device cache: hit when the stored tokens equal ``gens``,
        else build, store (evicting the oldest past the cap), return."""
        with self._lock:
            hit = self._device_cache.get(key)
            if hit is not None and hit[0] == gens:
                return hit[1]
        value = build()
        with self._lock:
            self._device_cache.pop(key, None)
            while len(self._device_cache) >= self.DEVICE_CACHE_ENTRIES:
                self._device_cache.pop(next(iter(self._device_cache)))
            self._device_cache[key] = (gens, value)
        return value

    def device_row_stack(self, row_id: int, shards: tuple[int, ...]
                         ) -> torch.Tensor:
        """One standard-view row across ``shards`` as an int32
        [n_shards, words] tensor on the field's device; missing
        fragments contribute zero rows."""
        frags = [self.fragment(s) for s in shards]
        gens = tuple(_frag_gen(fr) for fr in frags)

        def build() -> torch.Tensor:
            stack = np.zeros((len(shards), bm.n_words(SHARD_WIDTH)),
                             dtype=np.uint32)
            for i, frag in enumerate(frags):
                if frag is not None:
                    with frag._lock:
                        arr = frag._rows.get(row_id)
                        if arr is not None:
                            stack[i] = arr
            return bm.to_tensor(stack, self.device)

        return self._cached(("row", row_id, shards), gens, build)

    def device_container_leaf(self, row_id: int, shards: tuple[int, ...]):
        """One standard-view row across ``shards`` in pooled compressed
        form (ops/containers.ContainerLeaf).  A shard whose row is over
        the fill-ratio threshold gets a None directory entry, the
        caller's evidence to route the query dense."""
        frags = [self.fragment(s) for s in shards]
        # the threshold joins the token: a cached leaf froze each
        # fragment's sparse-vs-hot verdict
        gens = (ct.config().threshold,
                *(_frag_gen(fr) for fr in frags))

        def build():
            entries: list = []
            starts: list[int] = []
            blocks_list: list[np.ndarray] = []
            n = 0
            for fr in frags:
                starts.append(n)
                if fr is None:
                    entries.append(np.empty(0, dtype=np.int64))
                    continue
                rc = fr.row_containers(row_id)
                if rc is None:
                    entries.append(None)
                    continue
                keys, blocks, _bits = rc
                entries.append(keys)
                if len(keys):
                    blocks_list.append(blocks)
                    n += len(keys)
            pool = ct.build_pool(blocks_list, n)
            return ct.ContainerLeaf(shards, entries, starts,
                                    bm.to_tensor(pool, self.device), n,
                                    pool.nbytes)

        return self._cached(("cont", row_id, shards), gens, build)

    #: largest matrix stack kept in the cache (bytes); a larger one is
    #: rebuilt per query (pilosa_tpu/models/field.py:1150)
    MATRIX_STACK_CACHE_BYTES = 512 << 20
    #: matrix stacks kept per field (oldest evicted first)
    MATRIX_STACK_ENTRIES = 8

    def device_matrix_stack(self, shards: tuple[int, ...]):
        """The standard-view row matrices of ``shards`` concatenated
        along the row axis, in shard order, for the fused TopN scan
        (pilosa_tpu/models/field.py:1152): ``(gens, row_ids int64[N],
        shard_pos int32[N] on the host, shard_pos on the device, int32
        [N, words] matrix on the device)``, where ``shard_pos[i]`` is the
        position of row i's shard in ``shards`` and ``gens[i]`` that
        shard's fragment token.  One device, so no pad rows.  With every
        fragment empty it returns ``(gens, [], None, None, None)``,
        uncached.  Cached per shard tuple, except a stack larger than
        ``MATRIX_STACK_CACHE_BYTES``."""
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
        key = ("matrix", shards)
        with self._lock:
            hit = self._matrix_stack_cache.get(key)
            if hit is not None and hit[0] == gens:
                return hit
        if not parts:
            return (gens, np.empty(0, dtype=np.int64), None, None, None)
        row_ids = np.concatenate([ids for _, ids, _ in parts])
        shard_pos = np.concatenate(
            [np.full(len(ids), pos, dtype=np.int32) for pos, ids, _ in parts])
        big = np.concatenate([m for _, _, m in parts], axis=0)
        entry = (gens, row_ids, shard_pos,
                 torch.from_numpy(shard_pos).to(self.device),
                 bm.to_tensor(big, self.device))
        if big.nbytes > self.MATRIX_STACK_CACHE_BYTES:
            return entry  # uncacheable; the warm entries stay
        with self._lock:
            self._matrix_stack_cache.pop(key, None)
            while len(self._matrix_stack_cache) >= self.MATRIX_STACK_ENTRIES:
                self._matrix_stack_cache.pop(
                    next(iter(self._matrix_stack_cache)))
            self._matrix_stack_cache[key] = entry
        return entry

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        for view in self.views.values():
            view.close()
        with self._lock:
            self._device_cache.clear()
            self._matrix_stack_cache.clear()

    def snapshot(self) -> None:
        for view in self.views.values():
            view.snapshot()
