"""View: one physical layout of a field, owning fragments by shard.

Port of pilosa_tpu/models/view.py: the standard view, a time field's
quantum views (``standard_2024``, ``standard_202401``, ...) and an int
field's BSI view (``bsig_<field>``).  It routes bits and values to the
fragment owning the column's shard, creates fragments on first write,
and passes a mutex or bool field's ``mutex`` flag to every fragment
(pilosa_tpu/models/view.py:30-40, 67, 93).
Fragment files live under ``<view>/fragments/<shard>.{snap,wal}`` as in
the reference.
"""

from __future__ import annotations

import os
import threading

import torch

from pilosa_tpu_torch.models.fragment import Fragment
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


class View:
    def __init__(self, path: str | None, index: str, field: str, name: str,
                 *, device: torch.device, mutex: bool = False,
                 cache_type: str = "ranked", cache_size: int = 50000):
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        # the fragments' device, mutex flag and TopN cache options (the
        # field's)
        self._frag_opts = {"device": device, "mutex": mutex,
                           "cache_type": cache_type, "cache_size": cache_size}
        self.fragments: dict[int, Fragment] = {}
        # guards fragment creation; reads are plain dict gets
        self._lock = threading.Lock()
        if path is not None:
            os.makedirs(self._frag_dir, exist_ok=True)
            self._open_fragments()

    @property
    def _frag_dir(self) -> str:
        return os.path.join(self.path, "fragments")

    def _frag_path(self, shard: int) -> str:
        return os.path.join(self._frag_dir, str(shard))

    def _open_fragments(self) -> None:
        seen = set()
        for fn in os.listdir(self._frag_dir):
            base = fn.split(".", 1)[0]
            if base.isdigit():
                seen.add(int(base))
        for shard in sorted(seen):
            self.fragments[shard] = Fragment(
                self._frag_path(shard), self.index, self.field, self.name,
                shard, **self._frag_opts)

    def fragment(self, shard: int) -> Fragment | None:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        """Double-checked under the view lock, so two first writers to a
        fresh shard get the same Fragment."""
        frag = self.fragments.get(shard)
        if frag is not None:
            return frag
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                path = None if self.path is None else self._frag_path(shard)
                frag = Fragment(path, self.index, self.field, self.name,
                                shard, **self._frag_opts)
                self.fragments[shard] = frag
        return frag

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    def set_bit(self, row: int, col: int) -> bool:
        return self.create_fragment_if_not_exists(
            col // SHARD_WIDTH).set_bit(row, col)

    def clear_bit(self, row: int, col: int) -> bool:
        frag = self.fragment(col // SHARD_WIDTH)
        return False if frag is None else frag.clear_bit(row, col)

    def set_value(self, col: int, depth: int, value: int) -> bool:
        return self.create_fragment_if_not_exists(
            col // SHARD_WIDTH).set_value(col, depth, value)

    def value(self, col: int, depth: int) -> tuple[int, bool]:
        frag = self.fragment(col // SHARD_WIDTH)
        return (0, False) if frag is None else frag.value(col, depth)

    # -- streaming ingest (pilosa_tpu/models/view.py:145-160) ---------------

    def flush_deltas(self) -> int:
        """Merge every fragment's pending delta plane into its base rows;
        returns the bit positions merged."""
        return sum(frag.flush_delta()
                   for frag in list(self.fragments.values()))

    def delta_stats(self) -> dict:
        """{shard: delta stats} of the fragments with a pending delta."""
        out = {}
        for shard, frag in list(self.fragments.items()):
            s = frag.delta_stats()
            if s is not None:
                out[shard] = s
        return out

    def close(self) -> None:
        for frag in self.fragments.values():
            frag.close()

    def snapshot(self) -> None:
        for frag in self.fragments.values():
            frag.snapshot()
