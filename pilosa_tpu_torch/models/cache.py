"""TopN caches: per-fragment row-count caches.

Copy of pilosa_tpu/models/cache.py; the port keeps its own so it never
imports the JAX package.  The ``.cache`` files are byte-identical.

Parity target: the reference's cache interface (cache.go:35) with its
rankCache (cache.go:136) and lruCache (cache.go:58) implementations and
``.cache`` file persistence (fragment.go:2403-2434).

Design difference: the reference's ranked cache holds *approximate*
counts incrementally updated on every setBit and periodically recalculated
past a threshold; TopN answers can be stale.  Here device scans make
exact counts cheap, so the cache holds **exact** counts stamped with the
fragment generation — any mutation invalidates wholesale, and a hit
skips the device scan entirely.  A truncated ranked cache (more rows than
``size``) still answers TopN(n <= entries) exactly because the retained
entries are the true top counts.
"""

from __future__ import annotations

import json
import os

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"


class TopNCache:
    """Exact row-count cache for one fragment's standard view."""

    def __init__(self, cache_type: str = CACHE_TYPE_RANKED, size: int = 50000):
        self.cache_type = cache_type
        self.size = size
        self._gen: int | None = None
        self._counts: dict[int, int] = {}
        self._complete = False

    # ------------------------------------------------------------- access

    def get(self, gen: int) -> dict[int, int] | None:
        """Cached {row: count} if still valid for this generation and
        usable for exact answers, else None."""
        if self.cache_type == CACHE_TYPE_NONE or self._gen != gen:
            return None
        return dict(self._counts)

    @property
    def complete(self) -> bool:
        """True when the cache holds every non-empty row (untruncated)."""
        return self._complete

    def put(self, gen: int, counts: dict[int, int]) -> None:
        if self.cache_type == CACHE_TYPE_NONE:
            return
        self._gen = gen
        if len(counts) <= self.size:
            self._counts = dict(counts)
            self._complete = True
            return
        self._complete = False
        if self.cache_type == CACHE_TYPE_RANKED:
            # keep the top `size` by (count desc, id asc) — the reference's
            # rank order (cache.go:324 Pairs.Less)
            top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[: self.size]
        else:  # lru: retain an arbitrary bounded subset; exactness comes
            # only from `complete`, matching the reference's weaker
            # guarantees for lru caches
            top = list(counts.items())[: self.size]
        self._counts = dict(top)

    def exact_for(self, n: int) -> bool:
        """Can TopN(n) be answered exactly from this cache?"""
        if self._complete:
            return True
        if self.cache_type != CACHE_TYPE_RANKED:
            return False
        return 0 < n <= len(self._counts)

    def invalidate(self) -> None:
        self._gen = None
        self._counts = {}
        self._complete = False

    # -------------------------------------------------------- persistence

    def save(self, path: str, gen: int) -> None:
        """Persist beside the fragment snapshot (.cache file,
        fragment.go:2403).  Valid only for a WAL-clean reopen.  When the
        cache is stale for this generation, any previously persisted file
        must be removed — a WAL-clean reopen would otherwise adopt
        outdated counts as current."""
        if self.cache_type == CACHE_TYPE_NONE or self._gen != gen:
            if os.path.exists(path):
                os.unlink(path)
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "type": self.cache_type,
                    "complete": self._complete,
                    "counts": [[r, c] for r, c in sorted(self._counts.items())],
                },
                f,
            )
        os.replace(tmp, path)

    def load(self, path: str, gen: int) -> bool:
        """Adopt a persisted cache at the given (post-replay) generation.
        Returns True on success."""
        if self.cache_type == CACHE_TYPE_NONE or not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return False
        if d.get("type") != self.cache_type:
            return False
        self._counts = {int(r): int(c) for r, c in d.get("counts", [])}
        self._complete = bool(d.get("complete", False))
        self._gen = gen
        return True
