"""Query result types of Sum/Min/Max, TopN and GroupBy.

Copy of the ``ValCount``/``Pair``/``PairField``/``FieldRow``/
``GroupCount`` types and ``sort_pairs`` of pilosa_tpu/parallel/
results.py; the port keeps its own so it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ValCount:
    """BSI aggregate result (reference ValCount, executor.go:3000-3027)."""

    val: int = 0
    count: int = 0

    def add(self, other: "ValCount") -> "ValCount":
        return ValCount(self.val + other.val, self.count + other.count)

    def smaller(self, other: "ValCount") -> "ValCount":
        """Keep the smaller value; merge counts on ties."""
        if other.count == 0:
            return self
        if self.count == 0 or other.val < self.val:
            return other
        if other.val == self.val:
            return ValCount(self.val, self.count + other.count)
        return self

    def larger(self, other: "ValCount") -> "ValCount":
        if other.count == 0:
            return self
        if self.count == 0 or other.val > self.val:
            return other
        if other.val == self.val:
            return ValCount(self.val, self.count + other.count)
        return self


@dataclass
class Pair:
    """(row id/key, count) — TopN and MinRow/MaxRow results
    (reference Pair, pilosa.go)."""

    id: int = 0
    key: str = ""
    count: int = 0


@dataclass
class PairField:
    """Pair tagged with its field (wire form for TopN results)."""

    pair: Pair
    field: str = ""


@dataclass
class FieldRow:
    """One (field, row) coordinate of a GroupBy group
    (reference FieldRow, executor.go:3035)."""

    field: str
    row_id: int = 0
    row_key: str = ""
    value: int | None = None

    def __hash__(self):
        return hash((self.field, self.row_id, self.row_key, self.value))


@dataclass
class GroupCount:
    """One GroupBy result group (reference GroupCount, executor.go:3046)."""

    group: list[FieldRow] = field(default_factory=list)
    count: int = 0


def sort_pairs(pairs: list[Pair]) -> list[Pair]:
    """Count-descending order; ties broken by ascending id for
    determinism.  (The reference sorts by count only, cache.go:324-328,
    leaving tie order unstable — we pin it for reproducibility.)"""
    return sorted(pairs, key=lambda p: (-p.count, p.id, p.key))
