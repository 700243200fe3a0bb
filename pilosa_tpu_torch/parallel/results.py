"""Query result types of TopN and GroupBy.

Copy of the ``Pair``/``PairField``/``FieldRow``/``GroupCount`` types and
``sort_pairs`` of pilosa_tpu/parallel/results.py; the port keeps its own
so it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
