"""Fragment: one (field, view, shard) bit matrix, held on the host.

Port of pilosa_tpu/models/fragment.py for plain set rows.  The host
truth is a dict of row id -> uint32 words (numpy); mutations apply there
first and append to a sidecar WAL, and past ``max_op_n`` WAL operations
the matrix is rewritten as one snapshot file and the WAL truncated.  The
snapshot and WAL formats are the reference's (fragment.py:79-88), so a
data directory written by either package opens in the other.

The fragment keeps the TopN rank cache (models/cache.TopNCache): exact
row counts stamped with its generation, loaded from the ``.cache`` file
at a WAL-clean open and saved at snapshot, and its whole row matrix on
its device (``device_matrix``), cached per generation, for the TopN and
GroupBy scans.  The row matrix and the BSI planes live in
``_device_cache`` and are admitted to the process-wide residency manager
(runtime/residency.py) as the reference admits them: the matrix without
a host twin, the planes with theirs (a demoted plane stack is uploaded
again, inline, from its host bytes); ``close`` forgets both.

A fragment of an int field's BSI view (``bsig_<field>``) holds the bit
planes of its columns' base-relative values as rows 0 (exists), 1 (sign)
and 2.. (magnitude bits), as in the reference
(pilosa_tpu/models/fragment.py:1389-1567): ``set_value``/``clear_value``
write them with the reference's WAL records, ``device_planes`` is the
int32 [2 + depth, words] plane stack on the device, cached per
generation, and ``sum``/``min``/``max``/``range_op``/``range_between``
evaluate over it (ops/bsi.py: K6 for every compare, K4 for Sum's plane
counts, K1 for a filtered Sum's count).

Streaming ingest (pilosa_tpu/models/fragment.py:505-630, 675-870,
1099-1140): with [ingest] deltas on (the default; pilosa_tpu_torch.ingest)
``set_bit``/``clear_bit``, ``import_positions`` and roaring payloads of at
most ``_DELTA_MAX_ROARING_BITS`` bits land in the fragment's delta plane
(ingest/deltaplane.py) with the same WAL records as the base path, bump
``_delta_seq`` instead of ``_gen`` and register with the compactor.
``flush_delta`` merges the plane into the base rows (sets, then clears)
and bumps ``_gen``.  ``row``/``row_ids``/``bit`` read effective content;
every whole-matrix reader (``_stacked``: snapshot, ``device_matrix``, the
TopN and Rows scans) merges first.  BSI views never take the delta path.

A fragment of a mutex or bool field (``mutex=True``,
pilosa_tpu/models/fragment.py:116, 126) keeps one row per column:
``set_bit`` clears the column in every other row first, one ``_WAL_CLEAR``
record each before the ``_WAL_SET`` (pilosa_tpu/models/fragment.py:
676-700), and its writes never land in a delta plane.

Left out: the background snapshot queue (snapshots here run inline, in
one phase).  Device copies of rows across shards are built
by the owning Field, keyed on this fragment's ``(_uid, _gen)`` (base
content) or ``(_uid, _gen, _delta_seq)`` (effective content).
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import struct
import threading

import numpy as np
import torch

from pilosa_tpu_torch import ingest
from pilosa_tpu_torch import observe as _observe
from pilosa_tpu_torch.ingest import compactor
from pilosa_tpu_torch.ingest.deltaplane import DeltaPlane
from pilosa_tpu_torch.models.cache import CACHE_TYPE_NONE, TopNCache
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import bsi as bsi_ops
from pilosa_tpu_torch.ops import containers as ct
from pilosa_tpu_torch.ops import kindpools as kp
from pilosa_tpu_torch.runtime import residency
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import roaring as rcodec

DEFAULT_MAX_OP_N = 10000

_SNAP_MAGIC = b"PTSF"
_SNAP_VERSION = 1
_SNAP_HEADER = struct.Struct("<4sIIQ")  # magic, version, width_exp, n_rows
_WAL_SET = 1
_WAL_CLEAR = 2
_WAL_BULK = 3
_WAL_ROARING = 4
_WAL_REC = struct.Struct("<BQQ")  # op, row, col-offset
_WAL_BULK_HDR = struct.Struct("<BQQ")  # op, n_set, n_clear
_WAL_ROARING_HDR = struct.Struct("<BQQ")  # op, blob_len, clear-flag

_log = logging.getLogger("pilosa_tpu_torch.fragment")


def _planes_on(device: torch.device, gen: int, P: np.ndarray) -> tuple:
    """A plane-stack entry of one generation: the host planes uploaded
    (the tier's promotion closure, pilosa_tpu/models/fragment.py:91-101)."""
    return (gen, bm.to_tensor(P, device))


class Fragment:
    """One shard of one view of one field."""

    _UID = itertools.count(1)

    def __init__(self, path: str | None, index: str, field: str, view: str,
                 shard: int, *, device: torch.device, mutex: bool = False,
                 max_op_n: int = DEFAULT_MAX_OP_N,
                 cache_type: str = "ranked", cache_size: int = 50000):
        self.path = path
        self.device = device
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.mutex = mutex
        self.max_op_n = max_op_n
        self.width = SHARD_WIDTH
        self.n_words = bm.n_words(SHARD_WIDTH)

        self._rows: dict[int, np.ndarray] = {}
        # _gen bumps on every base mutation and compaction; _uid tells a
        # re-created fragment from the one it replaced.  Device caches of
        # base content key on (_uid, _gen).
        self._gen = 0
        # the pending delta plane, and the delta sequence: bumped on every
        # delta-landing write, never reset (compaction leaves it alone)
        self._delta: DeltaPlane | None = None
        self._delta_seq = 0
        self._uid = next(Fragment._UID)
        self._closed = False
        self._lock = threading.RLock()
        self._stack_cache: tuple[int, np.ndarray, np.ndarray] | None = None
        # row -> (gen, keys, blocks, bits): the compressed directory
        self._container_cache: dict = {}
        # the device forms, tracked by the process-wide residency
        # manager (pilosa_tpu/models/fragment.py:152): "matrix" -> (gen,
        # row_ids, int32 [R, words] tensor), ("planes", depth) -> (gen,
        # int32 [2 + depth, words] BSI planes)
        self._device_cache: dict = {}
        self.topn_cache = TopNCache(cache_type, cache_size)
        self._wal = None
        self._op_n = 0
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._load()
            self._wal = open(self._wal_path, "ab")
            # a persisted .cache is exact only for a WAL-clean reopen
            # (pilosa_tpu/models/fragment.py:183-186)
            if self._op_n == 0:
                self.topn_cache.load(self._cache_path, self._gen)

    # ------------------------------------------------------------------ io

    @property
    def _snap_path(self) -> str:
        return self.path + ".snap"

    @property
    def _wal_path(self) -> str:
        return self.path + ".wal"

    @property
    def _cache_path(self) -> str:
        return self.path + ".cache"

    @property
    def _wal_new_path(self) -> str:
        """The reference's overflow WAL segment, left behind when it
        crashed mid-snapshot; folded back into the WAL on open."""
        return self.path + ".wal.new"

    def _load(self) -> None:
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                magic, version, width_exp, n_rows = _SNAP_HEADER.unpack(
                    f.read(_SNAP_HEADER.size))
                if magic != _SNAP_MAGIC or version != _SNAP_VERSION:
                    raise ValueError(f"bad fragment snapshot {self._snap_path}")
                if (1 << width_exp) != self.width:
                    raise ValueError(
                        f"fragment {self._snap_path} written with shard width "
                        f"2^{width_exp}, current width is {self.width}")
                need = (_SNAP_HEADER.size + 8 * n_rows
                        + 4 * self.n_words * n_rows)
                if os.path.getsize(self._snap_path) < need:
                    raise ValueError(
                        f"truncated fragment snapshot {self._snap_path}")
                row_ids = np.frombuffer(f.read(8 * n_rows), dtype=np.int64)
                data = np.frombuffer(
                    f.read(4 * self.n_words * n_rows), dtype=np.uint32
                ).reshape(n_rows, self.n_words)
                for rid, words in zip(row_ids, data):
                    self._rows[int(rid)] = words.copy()
        for path in (self._wal_path, self._wal_new_path):
            if os.path.exists(path):
                self._replay_wal_file(path)
        self._gen += 1
        if os.path.exists(self._wal_new_path):
            with open(self._wal_path, "ab") as w, \
                    open(self._wal_new_path, "rb") as nf:
                w.write(nf.read())
            os.remove(self._wal_new_path)

    def _replay_wal_file(self, path: str) -> None:
        """Replay every record up to a torn or corrupt tail, which is
        logged and ignored (a crash mid-append)."""
        with open(path, "rb") as f:
            buf = f.read()
        off, n = 0, len(buf)
        torn_at = None
        while off + _WAL_REC.size <= n:
            rec_start = off
            op, a, b = _WAL_REC.unpack_from(buf, off)
            off += _WAL_REC.size
            if op == _WAL_SET:
                self._apply_set(a, b)
                self._op_n += 1
            elif op == _WAL_CLEAR:
                self._apply_clear(a, b)
                self._op_n += 1
            elif op == _WAL_BULK:
                n_set, n_clear = a, b
                if off + 8 * (n_set + n_clear) > n:
                    torn_at = rec_start
                    break
                sets = np.frombuffer(buf, dtype=np.uint64, count=n_set,
                                     offset=off)
                off += 8 * n_set
                clears = np.frombuffer(buf, dtype=np.uint64, count=n_clear,
                                       offset=off)
                off += 8 * n_clear
                self._apply_bulk(sets, clears)
                self._op_n += n_set + n_clear
            elif op == _WAL_ROARING:
                blob_len, clear_flag = a, b
                if off + blob_len > n:
                    torn_at = rec_start
                    break
                blob = bytes(buf[off:off + blob_len])
                off += blob_len
                try:
                    self._op_n += self._merge_roaring(blob,
                                                      clear=bool(clear_flag))
                except rcodec.RoaringError:
                    torn_at = rec_start
                    break
            else:
                torn_at = rec_start
                break
        if torn_at is None and off != n:
            torn_at = off
        if torn_at is not None:
            _log.warning("torn WAL tail in %s at byte %d (%d trailing bytes "
                         "ignored)", path, torn_at, n - torn_at)

    def _wal_append(self, data: bytes) -> None:
        if self._wal is not None:
            self._wal.write(data)
            self._wal.flush()

    def snapshot(self) -> None:
        """Persist the whole matrix atomically and truncate the WAL.  A
        crash between the two replays the old WAL over the new snapshot,
        which is idempotent (last writer wins per position)."""
        with self._lock:
            if self.path is None or self._closed:
                return
            row_ids, matrix = self._stacked()
            tmp = self._snap_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_SNAP_HEADER.pack(_SNAP_MAGIC, _SNAP_VERSION,
                                          self.width.bit_length() - 1,
                                          len(row_ids)))
                f.write(row_ids.astype(np.int64).tobytes())
                f.write(np.ascontiguousarray(matrix).tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snap_path)
            self._wal.close()
            self._wal = open(self._wal_path, "wb")
            self._op_n = 0
            self.topn_cache.save(self._cache_path, self._gen)

    def _maybe_snapshot(self) -> None:
        if self.path is not None and self._op_n > self.max_op_n:
            self.snapshot()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._wal is not None:
                self._wal.close()
                self._wal = None
            # the host and device copies go with the fragment
            self._stack_cache = None
            # release the residency accounting with the device copies
            # (pilosa_tpu/models/fragment.py:442-447)
            residency.manager().forget_owner(self._device_cache)
            self._device_cache.clear()
            self._container_cache.clear()
            # the pending bits are in the WAL (a reopen replays them into
            # the base rows): only the compactor registration goes
            if self._delta is not None:
                compactor.compactor().forget(self)
                self._delta = None

    def check(self) -> None:
        """Invariant validator (pilosa_tpu/models/fragment.py:449-486):
        raises ValueError on the first violated structural invariant.
        Run by the CLI's ``check``.  An open durable fragment must hold
        its WAL: the port snapshots inline, so there is no snapshot in
        flight to excuse a missing one."""
        with self._lock:
            for rid, arr in self._rows.items():
                if not isinstance(rid, int) or rid < 0:
                    raise ValueError(f"invalid row id {rid!r}")
                if not isinstance(arr, np.ndarray):
                    raise ValueError(f"row {rid}: not an ndarray")
                if arr.dtype != np.uint32:
                    raise ValueError(f"row {rid}: dtype {arr.dtype}")
                if arr.shape != (self.n_words,):
                    raise ValueError(
                        f"row {rid}: shape {arr.shape} != ({self.n_words},)")
            if self._delta is not None:
                self._delta.check()
            if self._stack_cache is not None:
                gen, ids, _matrix = self._stack_cache
                if gen == self._gen:
                    # base row ids: the stack cache holds base content at
                    # the base generation, and leaves all-zero rows out
                    base_ids = [r for r, a in self._rows.items()
                                if a.any()]
                    if len(ids) != len(base_ids):
                        raise ValueError(
                            "stack cache row count diverged from rows")
                    if not np.all(ids[:-1] < ids[1:]):
                        raise ValueError("stack cache ids not sorted")
            if self._op_n < 0:
                raise ValueError(f"negative op count {self._op_n}")
            if self.path is not None and not self._closed:
                if self._wal is None:
                    raise ValueError("open durable fragment without a WAL")

    # ------------------------------------------------ streaming delta plane

    #: BSI views never take the delta path: their reads are whole plane
    #: stacks (pilosa_tpu/models/fragment.py:509-524)
    _BSI_VIEW_PREFIX = "bsig_"

    def _delta_eligible(self) -> bool:
        """Whether writes land in the delta plane: [ingest] deltas on, not
        a mutex or bool fragment (a set clears the column in OTHER rows,
        which an overlay of the new row alone would leave set in the
        base), and not a BSI view."""
        return (ingest.config().delta_enabled and not self.mutex
                and not self.view.startswith(self._BSI_VIEW_PREFIX))

    def _delta_or_new(self) -> DeltaPlane:
        d = self._delta
        if d is None:
            d = self._delta = DeltaPlane(self.n_words, self.width)
        return d

    def _delta_after_write_locked(self) -> None:
        """Register with the compactor; past the process-wide pending
        budget the writer merges its own fragment inline."""
        if compactor.compactor().note_delta(self):
            self._flush_delta_locked(inline=True)

    def _delta_row_seq(self, row: int) -> int:
        """Per-row delta token, 0 without a pending overlay: the field's
        delta forms key on (uid, row_seq), so a write to another row
        leaves them valid."""
        d = self._delta
        return 0 if d is None else d.row_seq.get(row, 0)

    def delta_stats(self) -> dict | None:
        with self._lock:
            d = self._delta
            if d is None or d.empty():
                return None
            return d.stats()

    def flush_delta(self) -> int:
        """Merge the pending delta plane into the base rows (compaction):
        bumps ``_gen``, leaves ``_delta_seq`` alone, appends nothing to
        the WAL.  Returns the pending bit positions merged."""
        with self._lock:
            return self._flush_delta_locked()

    def _flush_delta_locked(self, inline: bool = False) -> int:
        d = self._delta
        if d is None or d.empty():
            self._delta = None
            return 0
        # sets first, then clears, as _apply_bulk orders them
        for row, words in d.sets.items():
            arr = self._row_array(row, create=True)
            np.bitwise_or(arr, words, out=arr)
        for row, words in d.clears.items():
            arr = self._rows.get(row)
            if arr is not None:
                np.bitwise_and(arr, ~words, out=arr)
        bits = d.bits
        self._delta = None
        self._gen += 1
        compactor.compactor().note_flushed(self, bits, inline=inline)
        return bits

    def _bit_off_locked(self, row: int, off: int) -> bool:
        """The effective bit (base overlaid with the delta) at one offset;
        the caller holds the lock."""
        d = self._delta
        if d is not None:
            ov = d.override(row, off)
            if ov is not None:
                return ov
        arr = self._rows.get(row)
        if arr is None:
            return False
        return bool((arr[off // bm.WORD_BITS] >> np.uint32(
            off % bm.WORD_BITS)) & np.uint32(1))

    def _delta_set_bit(self, row: int, off: int, clear: bool) -> bool:
        """A single-bit write landing in the delta plane (the caller holds
        the lock): the base path's WAL record and op count."""
        if self._bit_off_locked(row, off) == (not clear):
            return False  # a no-op: no WAL record, no sequence bump
        self._wal_append(_WAL_REC.pack(_WAL_CLEAR if clear else _WAL_SET,
                                       row, off))
        self._op_n += 1
        self._delta_seq += 1
        self._delta_or_new().add_bit(row, off, clear, self._delta_seq)
        self._delta_after_write_locked()
        self._maybe_snapshot()
        return True

    # ------------------------------------------------------- host mutation

    def _row_array(self, row: int, create: bool = False) -> np.ndarray | None:
        arr = self._rows.get(row)
        if arr is None and create:
            arr = np.zeros(self.n_words, dtype=np.uint32)
            self._rows[row] = arr
        return arr

    def _apply_set(self, row: int, off: int) -> bool:
        arr = self._row_array(row, create=True)
        w, b = off // bm.WORD_BITS, np.uint32(1) << np.uint32(off % bm.WORD_BITS)
        changed = not (arr[w] & b)
        arr[w] |= b
        return changed

    def _apply_clear(self, row: int, off: int) -> bool:
        arr = self._rows.get(row)
        if arr is None:
            return False
        w, b = off // bm.WORD_BITS, np.uint32(1) << np.uint32(off % bm.WORD_BITS)
        changed = bool(arr[w] & b)
        arr[w] &= ~b
        return changed

    def _apply_bulk(self, set_pos: np.ndarray, clear_pos: np.ndarray) -> None:
        if len(set_pos):
            self._merge_positions(set_pos, False)
        if len(clear_pos):
            self._merge_positions(clear_pos, True)

    def _offset(self, col: int) -> int:
        off = col - self.shard * self.width
        if not (0 <= off < self.width):
            raise ValueError(f"column {col} out of shard {self.shard} bounds")
        return off

    def set_bit(self, row: int, col: int) -> bool:
        with self._lock:
            off = self._offset(col)
            if self._delta_eligible():
                return self._delta_set_bit(row, off, clear=False)
            # the base path merges a pending delta first, so that the
            # in-memory order of writes is the WAL's
            self._flush_delta_locked()
            changed = False
            if self.mutex:
                w = off // bm.WORD_BITS
                b = np.uint32(1) << np.uint32(off % bm.WORD_BITS)
                for other, arr in self._rows.items():
                    if other != row and arr[w] & b:
                        arr[w] &= ~b
                        self._wal_append(_WAL_REC.pack(_WAL_CLEAR, other,
                                                       off))
                        self._op_n += 1
                        changed = True
            if self._apply_set(row, off):
                self._wal_append(_WAL_REC.pack(_WAL_SET, row, off))
                self._op_n += 1
                changed = True
            if changed:
                self._gen += 1
            self._maybe_snapshot()
            return changed

    def clear_bit(self, row: int, col: int) -> bool:
        with self._lock:
            off = self._offset(col)
            if self._delta_eligible():
                return self._delta_set_bit(row, off, clear=True)
            self._flush_delta_locked()
            if not self._apply_clear(row, off):
                return False
            self._wal_append(_WAL_REC.pack(_WAL_CLEAR, row, off))
            self._op_n += 1
            self._gen += 1
            self._maybe_snapshot()
            return True

    def import_positions(self, set_pos, clear_pos=()) -> None:
        """Bulk import of absolute fragment positions
        (pos = row * width + offset), logged as one WAL bulk record."""
        with self._lock:
            sets = np.unique(np.asarray(set_pos, dtype=np.uint64))
            clears = np.unique(np.asarray(clear_pos, dtype=np.uint64))
            if len(sets) == 0 and len(clears) == 0:
                return
            record = (_WAL_BULK_HDR.pack(_WAL_BULK, len(sets), len(clears))
                      + sets.tobytes() + clears.tobytes())
            if self._delta_eligible():
                self._wal_append(record)
                self._op_n += len(sets) + len(clears)
                self._delta_seq += 1
                d = self._delta_or_new()
                d.add_positions(sets, False, self._delta_seq)
                d.add_positions(clears, True, self._delta_seq)
                self._delta_after_write_locked()
                self._maybe_snapshot()
                return
            self._flush_delta_locked()
            self._apply_bulk(sets, clears)
            self._wal_append(record)
            self._op_n += len(sets) + len(clears)
            self._gen += 1
            self._maybe_snapshot()

    def clear_row(self, row: int) -> bool:
        """Remove every bit of a row (ClearRow; pilosa_tpu/models/
        fragment.py:722): a pending delta merges first, so that the WAL
        order is the in-memory one, then one bulk record of clears."""
        with self._lock:
            self._flush_delta_locked()
            arr = self._rows.pop(row, None)
            if arr is None or not arr.any():
                return False
            pos = (row * self.width
                   + bm.unpack_positions(arr)).astype(np.uint64)
            self._wal_append(_WAL_BULK_HDR.pack(_WAL_BULK, 0, len(pos))
                             + pos.tobytes())
            self._op_n += len(pos)
            self._gen += 1
            self._maybe_snapshot()
            return True

    def set_row(self, row: int, words: np.ndarray) -> bool:
        """Replace a row wholesale (Store; pilosa_tpu/models/
        fragment.py:743): one bulk record of the new row's bits and of
        the old bits it drops."""
        with self._lock:
            self._flush_delta_locked()
            old = self._rows.get(row)
            new = np.asarray(words, dtype=np.uint32).copy()
            if old is None and not new.any():
                return False
            if old is not None and np.array_equal(old, new):
                return False
            self._rows[row] = new
            sets = (row * self.width
                    + bm.unpack_positions(new)).astype(np.uint64)
            clears = np.empty(0, dtype=np.uint64)
            if old is not None:
                clears = (row * self.width + bm.unpack_positions(
                    old & ~new)).astype(np.uint64)
            self._wal_append(
                _WAL_BULK_HDR.pack(_WAL_BULK, len(sets), len(clears))
                + sets.tobytes() + clears.tobytes())
            self._op_n += len(sets) + len(clears)
            self._gen += 1
            self._maybe_snapshot()
            return True

    def row_count(self, row: int) -> int:
        """The effective row's bit count."""
        return int(np.bitwise_count(self.row(row)).sum())

    # ------------------------------------------------- roaring interchange

    def import_roaring(self, data: bytes, clear: bool = False) -> None:
        """Merge a serialized roaring bitmap in fragment position space;
        the whole payload is logged as one WAL roaring record.  With
        deltas on, a payload of at most ``_DELTA_MAX_ROARING_BITS`` bits
        lands in the delta plane as positions."""
        with self._lock:
            if not data:
                return
            record = _WAL_ROARING_HDR.pack(_WAL_ROARING, len(data),
                                           1 if clear else 0) + data
            if self._delta_eligible():
                pos = self._delta_roaring_positions(data)
                if pos is not None:
                    if len(pos) == 0:
                        return  # an empty but valid payload: a no-op
                    self._wal_append(record)
                    self._op_n += len(pos)
                    self._delta_seq += 1
                    self._delta_or_new().add_positions(pos, clear,
                                                       self._delta_seq)
                    self._delta_after_write_locked()
                    self._maybe_snapshot()
                    return
            self._flush_delta_locked()
            changed = self._merge_roaring(data, clear)
            if changed:
                self._wal_append(record)
                self._op_n += changed
                self._gen += 1
                self._maybe_snapshot()

    #: positions path iff avg set bits/container is below this
    #: (pilosa_tpu/models/fragment.py:862)
    _SPARSE_BITS_PER_CONTAINER = 512
    _SPARSE_MAX_BITS = 1 << 25

    #: roaring payloads of more bits skip the delta plane and merge into
    #: the base directly (pilosa_tpu/models/fragment.py:866-870)
    _DELTA_MAX_ROARING_BITS = 1 << 22

    def to_roaring(self) -> bytes:
        """The whole fragment as one roaring bitmap in fragment position
        space (pilosa_tpu/models/fragment.py:1067-1092): the pending
        delta merges first, so the export is the effective content."""
        cpr = self.width // rcodec.CONTAINER_BITS
        keys = []
        blocks = []
        with self._lock:
            self._flush_delta_locked()
            for row in self.row_ids():
                w64 = self._rows[row].view(np.uint64)
                for b in range(cpr):
                    blk = w64[b * rcodec.WORDS_PER_CONTAINER:
                              (b + 1) * rcodec.WORDS_PER_CONTAINER]
                    if blk.any():
                        keys.append(row * cpr + b)
                        blocks.append(blk)
            # copied under the lock: the blocks are views of live rows
            stacked = (np.stack(blocks) if blocks
                       else np.empty((0, rcodec.WORDS_PER_CONTAINER),
                                     np.uint64))
        return rcodec.encode(np.array(keys, dtype=np.uint64), stacked)

    def _delta_roaring_positions(self, data: bytes):
        """A roaring payload's absolute bit positions for the delta
        plane, or None when it is too large, or malformed in a way the
        dense path owns reporting."""
        stats = rcodec.payload_stats(data)
        if stats is None:
            return None
        if stats[1] > self._DELTA_MAX_ROARING_BITS:
            return None
        try:
            return rcodec.decode_positions(
                data, max_positions=2 * self._DELTA_MAX_ROARING_BITS)
        except rcodec.RoaringError:
            return None

    def _merge_roaring(self, data: bytes, clear: bool) -> int:
        """In-memory merge of a roaring payload; returns the number of
        bits flipped.  Sparse payloads merge in position space, dense
        ones container block by container block."""
        stats = rcodec.payload_stats(data)
        if stats is not None:
            n_cont, n_bits = stats
            if (n_cont > 0 and n_bits <= self._SPARSE_MAX_BITS
                    and n_bits <= n_cont * self._SPARSE_BITS_PER_CONTAINER):
                try:
                    pos = rcodec.decode_positions(
                        data, max_positions=2 * self._SPARSE_MAX_BITS)
                except rcodec.RoaringError:
                    pass  # the dense path owns the error reporting
                else:
                    return self._merge_positions(pos, clear)

        keys, cwords, _flags = rcodec.decode(data)
        cpr = self.width // rcodec.CONTAINER_BITS
        wpc = rcodec.WORDS_PER_CONTAINER
        if len(keys):
            keep = cwords.any(axis=1)
            if not keep.all():
                keys, cwords = keys[keep], cwords[keep]
        keys_i = keys.astype(np.int64)
        if len(keys_i) > 1 and not np.all(keys_i[1:] > keys_i[:-1]):
            # the wire says sorted and unique; a payload that is not is
            # normalized rather than trusted
            uk, inv = np.unique(keys_i, return_inverse=True)
            merged = np.zeros((len(uk), wpc), dtype=np.uint64)
            np.bitwise_or.at(merged, inv, cwords)
            keys_i, cwords = uk, merged
        changed = 0
        for k, block in zip(keys_i, cwords):
            row, slot = divmod(int(k), cpr)
            if clear:
                arr = self._rows.get(row)
                if arr is None:
                    continue
            else:
                arr = self._row_array(row, create=True)
            w64 = arr.view(np.uint64).reshape(cpr, wpc)
            cur = w64[slot]
            delta = (cur & block) if clear else (block & ~cur)
            n_flip = int(np.bitwise_count(delta).sum())
            if n_flip:
                changed += n_flip
                w64[slot] = (cur & ~block) if clear else (cur | block)
        return changed

    def _merge_positions(self, pos: np.ndarray, clear: bool) -> int:
        """Position-space merge, O(set bits); returns bits flipped."""
        if len(pos) == 0:
            return 0
        pos = np.ascontiguousarray(pos, dtype=np.uint64)
        if len(pos) > 1 and not np.all(pos[1:] >= pos[:-1]):
            pos = np.sort(pos)
        width_shift = self.width.bit_length() - 1
        row_of = (pos >> np.uint64(width_shift)).astype(np.int64)
        masks = np.uint64(1) << (pos & np.uint64(63))
        word_of = ((pos >> np.uint64(6))
                   & np.uint64((self.width >> 6) - 1)).astype(np.int64)
        changed = 0
        for row, sel in bm.group_indices(row_of).items():
            if clear:
                arr = self._rows.get(row)
                if arr is None:
                    continue
            else:
                arr = self._row_array(row, create=True)
            uw, inv = np.unique(word_of[sel], return_inverse=True)
            agg = np.zeros(len(uw), dtype=np.uint64)
            np.bitwise_or.at(agg, inv, masks[sel])
            w64 = arr.view(np.uint64)
            cur = w64[uw]
            delta = (cur & agg) if clear else (agg & ~cur)
            n_flip = int(np.bitwise_count(delta).sum())
            if n_flip:
                changed += n_flip
                w64[uw] = (cur & ~agg) if clear else (cur | agg)
        return changed

    # -------------------------------------------------------- host queries

    def bit(self, row: int, col: int) -> bool:
        with self._lock:
            return self._bit_off_locked(row, self._offset(col))

    def row(self, row: int) -> np.ndarray:
        """Packed uint32 EFFECTIVE words for one row (a copy), read under
        the lock: the compactor may move a delta-only row into the base
        at any moment, and an unlocked base-then-delta read could see
        neither half."""
        with self._lock:
            arr = self._rows.get(row)
            out = (np.zeros(self.n_words, dtype=np.uint32) if arr is None
                   else arr.copy())
            d = self._delta
            if d is not None and d.row_touched(row):
                d.apply_row(row, out)
            return out

    def row_ids(self) -> list[int]:
        """The effective non-empty rows, under the lock (the compactor
        mutates ``_rows`` and ``_delta``)."""
        with self._lock:
            d = self._delta
            if d is None or d.empty():
                return sorted(r for r, a in self._rows.items() if a.any())
            touched = set(d.touched_rows())
            out = [r for r, a in self._rows.items()
                   if r not in touched and a.any()]
            out.extend(r for r in touched
                       if d.row_any(r, self._rows.get(r)))
            return sorted(out)

    def _stacked(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ids int64[R], matrix uint32[R, words]) of the non-empty
        rows, cached per generation.  Merges a pending delta first, so
        every whole-matrix reader sees effective content."""
        with self._lock:
            self._flush_delta_locked()
            if (self._stack_cache is not None
                    and self._stack_cache[0] == self._gen):
                return self._stack_cache[1], self._stack_cache[2]
            ids = np.array(self.row_ids(), dtype=np.int64)
            if len(ids) == 0:
                matrix = np.zeros((0, self.n_words), dtype=np.uint32)
            else:
                matrix = np.stack([self._rows[int(r)] for r in ids])
            self._stack_cache = (self._gen, ids, matrix)
            return ids, matrix

    def row_containers(self, row: int):
        """One BASE row in compressed container-directory form: ``(keys
        int64[n], blocks uint32[n, 2048], bits)`` holding only its
        non-empty 2^16-bit containers, or None when the row's fill ratio
        (bits / width) exceeds the [containers] threshold.  Cached per
        generation; a pending delta does not invalidate it
        (pilosa_tpu/models/fragment.py:1320-1366)."""
        with self._lock:
            hit = self._container_cache.get(row)
            if hit is not None and hit[0] == self._gen:
                _g, keys, blocks, bits = hit
            else:
                while len(self._container_cache) >= 1024:
                    self._container_cache.pop(
                        next(iter(self._container_cache)))
                arr = self._rows.get(row)
                bits = (0 if arr is None
                        else int(np.bitwise_count(arr).sum(dtype=np.uint64)))
                keys = blocks = None
                self._container_cache[row] = (self._gen, keys, blocks, bits)
            if bits > ct.config().threshold * self.width:
                return None
            if keys is None:
                arr = self._rows.get(row)
                if arr is None or bits == 0:
                    keys = np.empty(0, dtype=np.int64)
                    blocks = np.empty((0, ct.CWORDS), dtype=np.uint32)
                else:
                    grid = arr.reshape(-1, ct.CWORDS)
                    keys = np.flatnonzero(grid.any(axis=1))
                    blocks = grid[keys].copy()
                self._container_cache[row] = (self._gen, keys, blocks, bits)
            return keys, blocks, bits

    def row_container_kinds(self, row: int):
        """``(keys, blocks, bits, kinds uint8[n])`` for one row:
        ``row_containers`` plus the cheapest storage kind of each
        container by the serializer's cost rule under the configured
        [containers] array-max / run-cap (pilosa_tpu/models/fragment.py:
        1368-1390).  None exactly when ``row_containers`` is None."""
        trio = self.row_containers(row)
        if trio is None:
            return None
        keys, blocks, bits = trio
        cfg = ct.config()
        return keys, blocks, bits, kp.pick_kinds(
            blocks, array_max=cfg.array_max, run_cap=cfg.run_cap)

    # ----------------------------------------------------- TopN rank cache

    def cached_row_counts(self, n: int = 0) -> dict[int, int] | None:
        """Exact {row: count} from the TopN cache when valid for the
        current generation and sufficient to answer TopN(n) exactly
        (n=0 demands a complete cache); else None, also while a delta is
        pending (pilosa_tpu/models/fragment.py:1206)."""
        with self._lock:
            if self._delta is not None and not self._delta.empty():
                return None
            counts = self.topn_cache.get(self._gen)
            if counts is None or not self.topn_cache.exact_for(n):
                return None
            return counts

    def recalculate_cache(self) -> None:
        """Recompute the exact row counts into the TopN cache, a pending
        delta merged first (``POST /recalculate-caches``;
        pilosa_tpu/models/fragment.py:1221)."""
        if self.topn_cache.cache_type == CACHE_TYPE_NONE:
            return
        with self._lock:
            self._flush_delta_locked()
            counts = {}
            for r, arr in self._rows.items():
                c = int(np.bitwise_count(arr).sum(dtype=np.uint64))
                if c:
                    counts[int(r)] = c
            self.topn_cache.put(self._gen, counts)

    def cache_row_counts(self, counts: dict[int, int],
                         gen: int | None = None) -> None:
        """Store counts computed at generation ``gen`` (default: the
        current one).  A write since the caller read the matrix makes
        the entry miss; it is never stamped with the newer generation."""
        with self._lock:
            self.topn_cache.put(self._gen if gen is None else gen, counts)

    # ------------------------------------------------------ device matrix

    def device_matrix(self) -> tuple[np.ndarray, torch.Tensor]:
        """(row_ids int64[R], int32 [R, words] tensor on the fragment's
        device) of the non-empty effective rows, cached per generation: a
        pending delta merges first."""
        with self._lock:
            self._flush_delta_locked()
            key = "matrix"
            hit = self._device_cache.get(key)
            if hit is not None and hit[0] == self._gen:
                residency.manager().touch(self._device_cache, key)
                return hit[1], hit[2]
            ids, matrix = self._stacked()
            dev = bm.to_tensor(matrix, self.device)
            self._device_cache[key] = (self._gen, ids, dev)
            residency.manager().admit(self._device_cache, key,
                                      matrix.nbytes)
            return ids, dev

    def device_matrix_with_gen(self) -> tuple[int, np.ndarray, torch.Tensor]:
        """(gen, row_ids, device matrix), the generation read together
        with the matrix, for correctly stamped cache fills."""
        with self._lock:
            ids, dev = self.device_matrix()
            return self._gen, ids, dev

    # -------------------------------------------------------------- BSI

    def device_planes(self, depth: int) -> torch.Tensor:
        """The BSI plane stack int32 [2 + depth, words] on the fragment's
        device (rows 0..depth+1, absent rows zero), cached per
        generation and depth."""
        with self._lock:
            key = ("planes", depth)
            cache = self._device_cache
            _observe.note_access((id(cache), key))
            hit = cache.get(key)
            if hit is not None and hit[0] == self._gen:
                residency.manager().touch(cache, key)
                return hit[1]
            mgr = residency.manager()
            promote = functools.partial(_planes_on, self.device, self._gen)
            ent = mgr.host_lookup(cache, key, self._gen)
            if ent is not None:
                # demoted but warm: one upload, inline under the fragment
                # lock as in the reference, no plane re-assembly
                value = ent.promote(ent.payload)
                cache[key] = value
                mgr.admit(cache, key, ent.nbytes, token=self._gen,
                          host=ent.payload, promote=ent.promote)
                return value[1]
            P = np.zeros((bsi_ops.OFFSET_PLANE + depth, self.n_words),
                         dtype=np.uint32)
            for i in range(P.shape[0]):
                arr = self._rows.get(i)
                if arr is not None:
                    P[i] = arr
            value = promote(P)
            cache[key] = value
            mgr.admit(cache, key, P.nbytes, token=self._gen, host=P,
                      promote=promote)
            return value[1]

    def set_value(self, col: int, depth: int, value: int) -> bool:
        """Write a base-relative signed value as bit planes, one WAL
        record per plane, exists and sign (reference setValueBase,
        fragment.go:977; pilosa_tpu/models/fragment.py:1457)."""
        uvalue = -value if value < 0 else value
        changed = False
        off = self._offset(col)
        with self._lock:
            for i in range(depth):
                plane = bsi_ops.OFFSET_PLANE + i
                if (uvalue >> i) & 1:
                    changed |= self._apply_set(plane, off)
                    self._wal_append(_WAL_REC.pack(_WAL_SET, plane, off))
                else:
                    changed |= self._apply_clear(plane, off)
                    self._wal_append(_WAL_REC.pack(_WAL_CLEAR, plane, off))
                self._op_n += 1
            changed |= self._apply_set(bsi_ops.EXISTS_PLANE, off)
            self._wal_append(_WAL_REC.pack(_WAL_SET, bsi_ops.EXISTS_PLANE,
                                           off))
            if value < 0:
                changed |= self._apply_set(bsi_ops.SIGN_PLANE, off)
                self._wal_append(_WAL_REC.pack(_WAL_SET, bsi_ops.SIGN_PLANE,
                                               off))
            else:
                changed |= self._apply_clear(bsi_ops.SIGN_PLANE, off)
                self._wal_append(_WAL_REC.pack(_WAL_CLEAR,
                                               bsi_ops.SIGN_PLANE, off))
            self._op_n += 2
            self._gen += 1
            self._maybe_snapshot()
        return changed

    def clear_value(self, col: int, depth: int) -> bool:
        """Clear the column's exists bit; the planes keep their bits, as
        in the reference (pilosa_tpu/models/fragment.py:1487)."""
        off = self._offset(col)
        with self._lock:
            changed = self._apply_clear(bsi_ops.EXISTS_PLANE, off)
            if changed:
                self._wal_append(_WAL_REC.pack(_WAL_CLEAR,
                                               bsi_ops.EXISTS_PLANE, off))
                self._op_n += 1
                self._gen += 1
        return changed

    def value(self, col: int, depth: int) -> tuple[int, bool]:
        """One column's base-relative value (reference fragment.value,
        fragment.go:896)."""
        if not self.bit(bsi_ops.EXISTS_PLANE, col):
            return 0, False
        v = 0
        for i in range(depth):
            if self.bit(bsi_ops.OFFSET_PLANE + i, col):
                v |= 1 << i
        if self.bit(bsi_ops.SIGN_PLANE, col):
            v = -v
        return v, True

    def _consider(self, depth: int, filter_words):
        """(P, consider, filter tensor or None): the planes, their exists
        row under the filter, and the filter on the device."""
        P = self.device_planes(depth)
        if filter_words is None:
            return P, P[bsi_ops.EXISTS_PLANE], None
        filt = bm.to_tensor(filter_words, self.device)
        return P, P[bsi_ops.EXISTS_PLANE] & filt, filt

    def sum(self, filter_words, depth: int) -> tuple[int, int]:
        """(base-relative sum, count): the plane counts (two K4 launches)
        assembled in exact Python ints; with a filter the count is
        |exists & filter| (K1) (reference fragment.sum,
        fragment.go:1111)."""
        P, consider, filt = self._consider(depth, filter_words)
        pos, neg = bsi_ops.plane_counts(P, consider)
        pos = pos.to("cpu").numpy()
        neg = neg.to("cpu").numpy()
        total = sum((int(p) - int(n)) << i
                    for i, (p, n) in enumerate(zip(pos, neg)))
        if filt is None:
            count = bm.popcount(consider)
        else:
            count = bm.popcount_and(P[bsi_ops.EXISTS_PLANE], filt)
        return total, count

    def min(self, filter_words, depth: int) -> tuple[int, int]:
        """(base-relative min, count) (reference fragment.min,
        fragment.go:1147)."""
        P, consider, _ = self._consider(depth, filter_words)
        if bm.popcount(consider) == 0:
            return 0, 0
        negs = consider & P[bsi_ops.SIGN_PLANE]
        if bm.popcount(negs) > 0:
            taken, count = bsi_ops.extreme_max(P, negs)
            return (-bsi_ops.assemble_value(taken.to("cpu").numpy()),
                    int(count))
        taken, count = bsi_ops.extreme_min(P, consider)
        return bsi_ops.assemble_value(taken.to("cpu").numpy()), int(count)

    def max(self, filter_words, depth: int) -> tuple[int, int]:
        """(base-relative max, count) (reference fragment.max,
        fragment.go:1191)."""
        P, consider, _ = self._consider(depth, filter_words)
        if bm.popcount(consider) == 0:
            return 0, 0
        pos = consider & ~P[bsi_ops.SIGN_PLANE]
        if bm.popcount(pos) == 0:
            taken, count = bsi_ops.extreme_min(P, consider)
            return (-bsi_ops.assemble_value(taken.to("cpu").numpy()),
                    int(count))
        taken, count = bsi_ops.extreme_max(P, pos)
        return bsi_ops.assemble_value(taken.to("cpu").numpy()), int(count)

    def not_null(self, depth: int) -> torch.Tensor:
        """The exists row on the device (reference notNull,
        fragment.go:1460)."""
        return self.device_planes(depth)[bsi_ops.EXISTS_PLANE]

    def range_op(self, op: str, depth: int, predicate: int) -> torch.Tensor:
        """BSI comparison -> int32 words on the device; op in
        {'==','!=','<','<=','>','>='} (reference rangeOp,
        fragment.go:1273), through bsi_ops.range_words, which the fused
        path runs over whole stacks."""
        return bsi_ops.range_words(self.device_planes(depth), op, predicate)

    def range_between(self, depth: int, pred_min: int, pred_max: int
                      ) -> torch.Tensor:
        """BSI between [min, max] inclusive (reference rangeBetween,
        fragment.go:1465), through bsi_ops.between_words."""
        return bsi_ops.between_words(self.device_planes(depth), pred_min,
                                     pred_max)
