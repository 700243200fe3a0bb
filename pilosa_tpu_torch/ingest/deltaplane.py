"""Per-fragment delta plane: the bounded in-memory landing zone for
streaming writes.

Copy of pilosa_tpu/ingest/deltaplane.py (numpy only).

One ``DeltaPlane`` holds two packed-word overlays per touched row —
**set-bits** and **clear-bits** — in the same uint32 word layout as the
fragment's base rows, so the effective content of a row is

    effective = (base & ~clear) | set

exactly the fusion the read side evaluates (``ops/expr.py`` ``dfuse``
node on device; ``Fragment.row``/``bit`` host overlays).  The two
planes are kept DISJOINT per row (a later set removes the bit from the
clear plane and vice versa), so within one plane application order
cannot matter and double-application is idempotent — the property that
makes the executor's delta-stacks-then-base staging order safe under a
concurrent compaction (re-applying an already-merged delta reproduces
the same effective words).

The plane is deliberately dumb: no locking (the owning fragment's lock
guards every access), no WAL (the fragment appends the same records the
base path would at write time), no thresholds (the compactor owns
policy).  It only tracks what policy needs: pending bit-position count,
allocated bytes, per-row and whole-plane monotone write sequence, and
its creation time (the age trigger).
"""

from __future__ import annotations

import time

import numpy as np


class DeltaPlane:
    """Pending set/clear overlays for one fragment.  Caller holds the
    fragment lock for every method."""

    __slots__ = ("n_words", "width_shift", "sets", "clears", "row_seq",
                 "bits", "created_t", "last_write_t")

    def __init__(self, n_words: int, width: int):
        self.n_words = n_words
        self.width_shift = width.bit_length() - 1
        self.sets: dict[int, np.ndarray] = {}
        self.clears: dict[int, np.ndarray] = {}
        #: row -> fragment _delta_seq at last write touching it (the
        #: per-row invalidation token for the executor's delta stacks)
        self.row_seq: dict[int, int] = {}
        #: pending bit POSITIONS absorbed (not exact flips — the
        #: compaction-threshold currency, like the reference's opN)
        self.bits = 0
        self.created_t = time.monotonic()
        self.last_write_t = self.created_t

    # ------------------------------------------------------------- state

    def empty(self) -> bool:
        return self.bits == 0 and not self.sets and not self.clears

    @property
    def nbytes(self) -> int:
        return 4 * self.n_words * (len(self.sets) + len(self.clears))

    def touched_rows(self):
        return self.row_seq.keys()

    def row_touched(self, row: int) -> bool:
        return row in self.row_seq

    def age_s(self) -> float:
        return time.monotonic() - self.created_t

    def stats(self) -> dict:
        return {
            "bits": self.bits,
            "rows": len(self.row_seq),
            "bytes": self.nbytes,
            "ageS": round(self.age_s(), 3),
        }

    # ------------------------------------------------------------ writes

    def _plane_row(self, plane: dict, row: int) -> np.ndarray:
        arr = plane.get(row)
        if arr is None:
            arr = np.zeros(self.n_words, dtype=np.uint32)
            plane[row] = arr
        return arr

    def add_bit(self, row: int, off: int, clear: bool, seq: int) -> None:
        w = off >> 5
        m = np.uint32(1) << np.uint32(off & 31)
        tgt = self._plane_row(self.clears if clear else self.sets, row)
        tgt[w] |= m
        other = (self.sets if clear else self.clears).get(row)
        if other is not None:
            other[w] &= ~m
        self.row_seq[row] = seq
        self.bits += 1
        self.last_write_t = time.monotonic()

    def add_positions(self, pos: np.ndarray, clear: bool,
                      seq: int) -> None:
        """Absorb absolute fragment positions (pos = row*width + off),
        sorted or not; duplicates are harmless (OR/ANDN idempotent)."""
        if len(pos) == 0:
            return
        pos = np.asarray(pos, dtype=np.uint64)
        row_of = (pos >> np.uint64(self.width_shift)).astype(np.int64)
        offs = pos & np.uint64((1 << self.width_shift) - 1)
        words = (offs >> np.uint64(5)).astype(np.int64)
        masks = (np.uint32(1)
                 << (offs & np.uint64(31)).astype(np.uint32))
        tgt_plane = self.clears if clear else self.sets
        other_plane = self.sets if clear else self.clears
        # group by row with ONE sort, not one full-array mask per
        # unique row — this runs under the fragment lock, and an
        # import near the roaring cap spanning thousands of rows would
        # otherwise cost rows x positions comparisons while readers
        # wait on the lock
        order = np.argsort(row_of, kind="stable")
        row_s, words_s, masks_s = row_of[order], words[order], masks[order]
        bounds = np.flatnonzero(np.diff(row_s)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(row_s)]))
        for i in range(len(starts)):
            r = int(row_s[starts[i]])
            w = words_s[starts[i]:ends[i]]
            m = masks_s[starts[i]:ends[i]]
            tgt = self._plane_row(tgt_plane, r)
            # .at: duplicate word slots must accumulate, not last-write
            np.bitwise_or.at(tgt, w, m)
            other = other_plane.get(r)
            if other is not None:
                np.bitwise_and.at(other, w, ~m)
            self.row_seq[r] = seq
        self.bits += len(pos)
        self.last_write_t = time.monotonic()

    # ------------------------------------------------------------- reads

    def override(self, row: int, off: int):
        """Effective-bit override for one position: True (pending set),
        False (pending clear), or None (base decides)."""
        w, m = off >> 5, np.uint32(1) << np.uint32(off & 31)
        arr = self.sets.get(row)
        if arr is not None and arr[w] & m:
            return True
        arr = self.clears.get(row)
        if arr is not None and arr[w] & m:
            return False
        return None

    def apply_row(self, row: int, arr: np.ndarray) -> None:
        """In-place overlay: arr = (arr & ~clear) | set."""
        c = self.clears.get(row)
        if c is not None:
            np.bitwise_and(arr, ~c, out=arr)
        s = self.sets.get(row)
        if s is not None:
            np.bitwise_or(arr, s, out=arr)

    def row_any(self, row: int, base: np.ndarray | None) -> bool:
        """Whether the EFFECTIVE row has any set bit, without
        materializing the overlay when the answer is cheap."""
        s = self.sets.get(row)
        if s is not None and s.any():
            return True
        if base is None or not base.any():
            return False
        c = self.clears.get(row)
        if c is None:
            return True  # base non-empty, nothing cleared
        return bool(np.bitwise_and(base, ~c).any())

    def check(self) -> None:
        """Structural invariants (Fragment.check extension): correct
        dtype/shape, and the set/clear planes disjoint per row."""
        for name, plane in (("set", self.sets), ("clear", self.clears)):
            for row, arr in plane.items():
                if not isinstance(row, int) or row < 0:
                    raise ValueError(f"delta {name} row id {row!r}")
                if arr.dtype != np.uint32 or arr.shape != (self.n_words,):
                    raise ValueError(
                        f"delta {name} row {row}: bad words "
                        f"{arr.dtype}{arr.shape}")
        for row, s in self.sets.items():
            c = self.clears.get(row)
            if c is not None and bool(np.bitwise_and(s, c).any()):
                raise ValueError(
                    f"delta row {row}: set and clear planes overlap")
