"""Predictive prefetcher: promote host-tier entries back onto the card
ahead of the queries that will want them.

Copy of pilosa_tpu/runtime/prefetch.py.  The tiered residency manager
(runtime/residency.py) makes a working set larger than the card's budget
survivable -- demoted entries re-promote asynchronously on demand.  This
module makes it fast for skewed traffic: the access statistics
(``observe.access_stats`` -- every tiered stack access ticks a decayed
per-entry score) rank the demoted entries, and a background loop submits
the hottest ones to the promotion pool as PREFETCH work before a query
stalls on them.  The ``prefetchUseful`` counter of the manager's tier
stats (a query touching a prefetcher-installed entry) is the evidence.

Prefetch work is the FIRST thing shed under pressure: the promoter
refuses prefetch jobs on a full queue (and evicts queued prefetch jobs to
make room for demand promotions), and each job runs under admission's
``internal`` class, so query saturation pauses prefetching exactly like
it pauses compaction.

One Prefetcher per server; the state it reads -- host tier, access
scores, promotion pool -- is process-wide, and concurrent prefetchers are
harmless (single-flight per key dedupes)."""

from __future__ import annotations

import threading

from pilosa_tpu_torch import observe as _observe
from pilosa_tpu_torch.runtime import residency as _residency


class Prefetcher:
    """Background promotion-ahead loop ([residency] prefetch /
    prefetch-interval)."""

    #: At most this many prefetch submissions per cycle -- the loop must
    #: never saturate the promotion queue it is the lowest-priority user
    #: of.
    BATCH = 8

    def __init__(self, interval: float | None = None):
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.cycles = 0
        self.issued = 0

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="residency-prefetch")
        self._thread.start()

    def _run(self) -> None:
        while True:
            cfg = _residency.config()
            wait = (self.interval if self.interval is not None
                    else cfg.prefetch_interval)
            if self._stop.wait(max(0.01, wait)):
                return
            try:
                if cfg.prefetch and cfg.host_budget_bytes > 0:
                    self.issued += self.run_once()
                self.cycles += 1
            except Exception:  # noqa: BLE001 -- never take the loop down
                pass

    def run_once(self) -> int:
        """One prediction cycle: rank the demoted host-tier entries by
        access score and submit the hottest as prefetch promotions.
        Returns how many jobs were submitted (tests call this directly
        for determinism).

        Two guards keep prediction from becoming churn:

        - zero-scored entries are skipped -- promoting something no query
          ever touched is pure queue pressure;
        - a candidate must be strictly HOTTER than the coldest
          currently-resident entry (when the budget is full, every
          promotion evicts someone).
        """
        mgr = _residency.manager()
        candidates = mgr.host_candidates(64)
        if not candidates:
            return 0
        stats = _observe.access_stats()
        scored = [(stats.score(e.eid), e) for e in candidates]
        scored.sort(key=lambda p: -p[0])
        promoter = _residency.promoter()
        n = 0
        pending = 0  # bytes submitted this cycle, not yet admitted
        for score, ent in scored[:self.BATCH]:
            if score <= 0.0:
                break
            if promoter.queue_full():
                break  # saturated: shed the whole cycle, and don't demote
            # victim-aware admission: a FULL budget means promoting this
            # candidate evicts someone -- pick the victim by the same
            # access-score signal (demote the coldest resident BEFORE the
            # submit), counting this cycle's own in-flight submissions
            if mgr.total + pending + ent.nbytes > mgr.budget:
                resident = mgr.resident_eids()
                res_scores = {eid: stats.score(eid)
                              for eid in resident}
                if resident and score <= min(res_scores.values()):
                    break  # residents are already the hottest set
                mgr.demote_coldest(res_scores)
            if promoter.submit(ent, prefetch=True) is not None:
                n += 1
                pending += ent.nbytes
        return n

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    def stats(self) -> dict:
        return {"running": self._thread is not None
                and self._thread.is_alive(),
                "cycles": self.cycles,
                "issued": self.issued}
