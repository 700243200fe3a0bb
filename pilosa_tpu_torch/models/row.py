"""Row: a query-result bitmap spanning shards.

Port of pilosa_tpu/models/row.py, the part the slice uses: results are
kept as one packed-word segment per shard, host-side as numpy uint32
words -- compute stays on the device inside the executor and
materializes here at reduce time.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class Row:
    __slots__ = ("segments", "attrs", "keys", "exclude_columns",
                 "wants_column_attrs")

    def __init__(self, segments: dict[int, np.ndarray] | None = None):
        # shard -> uint32[SHARD_WIDTH/32]
        self.segments: dict[int, np.ndarray] = segments or {}
        self.attrs: dict = {}
        self.keys: list[str] = []
        # serialization directives set by Options()/query params
        # (reference execOptions excludeColumns/columnAttrs)
        self.exclude_columns = False
        self.wants_column_attrs = False

    @classmethod
    def from_columns(cls, columns) -> "Row":
        """A Row holding the given absolute column ids (the protobuf
        decoder's form of a result)."""
        row = cls()
        for col in columns:
            shard, off = divmod(int(col), SHARD_WIDTH)
            seg = row.segments.get(shard)
            if seg is None:
                seg = np.zeros(bm.n_words(SHARD_WIDTH), dtype=np.uint32)
                row.segments[shard] = seg
            seg[off // bm.WORD_BITS] |= np.uint32(1 << (off % bm.WORD_BITS))
        return row

    def columns(self) -> np.ndarray:
        """Sorted absolute column ids."""
        parts = []
        for s in sorted(self.segments):
            pos = bm.unpack_positions(self.segments[s])
            parts.append(pos + s * SHARD_WIDTH)
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    def shard_segment(self, shard: int) -> np.ndarray | None:
        return self.segments.get(shard)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Row):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())

    def __repr__(self) -> str:
        cols = self.columns()
        head = ", ".join(str(c) for c in cols[:8])
        more = "..." if len(cols) > 8 else ""
        return f"Row([{head}{more}] n={len(cols)})"
