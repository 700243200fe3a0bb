"""Per-entry access statistics for the predictive prefetcher.

Copy of the ``AccessStats`` part of pilosa_tpu/observe.py (:111-163):
every tiered stack access -- an HBM hit, a host-tier promotion or a cold
build -- ticks a decayed score per cache-entry id, so that the prefetcher
(runtime/prefetch.py) can rank the demoted entries traffic is about to
want.

The rest of the reference's module -- the query flight recorder, its
``GET /debug/queries`` and ``?profile=1`` surfaces, the slow-query
breakdown and the event journal that ``residency``'s demotions and
promotions stamp -- is ROADMAP Queue 1 item 7 (observability) and is not
part of the port yet.
"""

from __future__ import annotations

import threading
import time


class AccessStats:
    """Per-cache-entry access statistics for the predictive prefetcher:
    every tiered stack access ticks a decayed score per entry id, so
    'which demoted entries is traffic about to want' is answerable by
    rank.  Scores decay by half every ``HALF_LIFE_S`` so yesterday's hot
    rows don't pin today's prefetch bandwidth; the table is LRU-capped
    (a per-row cache key churn must not grow it without bound).

    Lock discipline: one short lock per note -- the note sits on the
    stack-accessor path (~µs against a rebuild measured in ms), not on
    the per-dispatch hot path."""

    HALF_LIFE_S = 30.0
    MAX_ENTRIES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        # eid -> [score, last_monotonic]; insertion order = LRU
        self._scores: dict = {}

    def note(self, eid) -> None:
        now = time.monotonic()
        with self._lock:
            rec = self._scores.pop(eid, None)
            if rec is None:
                rec = [0.0, now]
                if len(self._scores) >= self.MAX_ENTRIES:
                    self._scores.pop(next(iter(self._scores)))
            score, last = rec
            score *= 0.5 ** ((now - last) / self.HALF_LIFE_S)
            self._scores[eid] = [score + 1.0, now]

    def score(self, eid) -> float:
        now = time.monotonic()
        with self._lock:
            rec = self._scores.get(eid)
            if rec is None:
                return 0.0
            return rec[0] * 0.5 ** ((now - rec[1]) / self.HALF_LIFE_S)


_access = AccessStats()


def access_stats() -> AccessStats:
    """The process-wide access-statistics table (process-wide like the
    residency budget the prefetcher feeds)."""
    return _access


def note_access(eid) -> None:
    _access.note(eid)
