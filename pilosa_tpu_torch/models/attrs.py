"""Attribute storage: arbitrary key->value metadata on rows and columns.

A copy of pilosa_tpu/models/attrs.py.

Parity with the reference's AttrStore (attr.go:34) and its BoltDB
implementation (boltdb/attrstore.go): merge-on-write semantics, bulk set,
and 100-id attribute blocks with checksums for anti-entropy diffing
(attr.go:80-120).  Backed by sqlite (stdlib) instead of BoltDB.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
import threading
from collections import OrderedDict

# Attribute block size for anti-entropy diffs (reference attrBlockSize,
# attr.go:80).
ATTR_BLOCK_SIZE = 100

#: read-cache entries per store (reference attrCacheSize LRU in front
#: of BoltDB, attr.go:80) — hot TopN attr-filter scans must not hit
#: SQLite per row
ATTR_CACHE_SIZE = 8192


class AttrStore:
    def __init__(self, path: str | None = None):
        self.path = path or ":memory:"
        self._lock = threading.RLock()
        # One shared connection for all threads (an in-memory sqlite DB is
        # per-connection, so thread-local connections would each see an
        # empty database); every access is serialized by self._lock.
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        with self._lock, self._db as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, data TEXT)"
            )
        # LRU read cache (attr.go:80) holding the JSON STRING exactly
        # as stored ("" = id absent, so hot attr-less rows skip SQLite
        # too).  Caching the string rather than the parsed dict makes
        # every read an independent json.loads — no shared mutable
        # values, so a caller mutating its result (even nested lists)
        # can never poison the cache.  Writes update the entry with
        # the dump they computed anyway.
        self._cache: OrderedDict[int, str] = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    def _conn(self) -> sqlite3.Connection:
        return self._db

    def _cache_put(self, id_: int, data: str) -> None:
        # under self._lock
        self._cache[id_] = data
        self._cache.move_to_end(id_)
        while len(self._cache) > ATTR_CACHE_SIZE:
            self._cache.popitem(last=False)

    def _data_locked(self, id_: int) -> str:
        """Cached JSON string for one id ("" = absent); under
        self._lock.  Counter-free — set_attrs' read-modify-write goes
        through here so the hit/miss counters track READ traffic only
        (they exist to size ATTR_CACHE_SIZE)."""
        hit = self._cache.get(id_)
        if hit is not None:
            self._cache.move_to_end(id_)
            return hit
        cur = self._conn().execute("SELECT data FROM attrs WHERE id=?",
                                   (id_,))
        row = cur.fetchone()
        data = row[0] if row else ""
        self._cache_put(id_, data)
        return data

    def attrs(self, id_: int) -> dict:
        with self._lock:
            cached = id_ in self._cache
            self.cache_hits += cached
            self.cache_misses += not cached
            data = self._data_locked(id_)
        return json.loads(data) if data else {}

    def set_attrs(self, id_: int, attrs: dict) -> None:
        """Merge attrs into existing; None values delete keys (reference
        SetAttrs merge semantics, boltdb/attrstore.go:120)."""
        with self._lock:
            data = self._data_locked(id_)
            cur = json.loads(data) if data else {}
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            dumped = json.dumps(cur, sort_keys=True)
            with self._db as c:
                c.execute(
                    "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                    (id_, dumped),
                )
            self._cache_put(id_, dumped)

    def attrs_bulk(self, ids) -> dict[int, dict]:
        """Batched lookup: cache hits first, then one IN-query per 500
        missing ids (the per-id form would hold the store lock once per
        column on columnAttrs responses); misses populate the cache."""
        ids = [int(i) for i in dict.fromkeys(ids)]  # dedupe, keep order
        out: dict[int, dict] = {}
        with self._lock:
            missing = []
            for id_ in ids:
                hit = self._cache.get(id_)
                if hit is not None:
                    self._cache.move_to_end(id_)
                    self.cache_hits += 1
                    if hit:  # attr-less ids stay absent, as before
                        out[id_] = json.loads(hit)
                else:
                    missing.append(id_)
            self.cache_misses += len(missing)
            con = self._conn()
            found = {}
            for i in range(0, len(missing), 500):
                chunk = missing[i:i + 500]
                cur = con.execute(
                    "SELECT id, data FROM attrs WHERE id IN "
                    f"({','.join('?' * len(chunk))})", chunk)
                for id_, data in cur.fetchall():
                    found[int(id_)] = data
            for id_ in missing:
                data = found.get(id_, "")
                self._cache_put(id_, data)
                if data:
                    out[id_] = json.loads(data)
        return out

    def set_bulk_attrs(self, attrs_by_id: dict[int, dict]) -> None:
        for id_, attrs in sorted(attrs_by_id.items()):
            self.set_attrs(id_, attrs)

    def ids(self) -> list[int]:
        with self._lock:
            cur = self._conn().execute("SELECT id FROM attrs ORDER BY id")
            return [r[0] for r in cur.fetchall()]

    # ---- anti-entropy blocks (reference attr.go:80-120) ----

    def blocks(self) -> list[tuple[int, bytes]]:
        """(block id, checksum) per 100-id block of attribute data."""
        out: list[tuple[int, bytes]] = []
        h = None
        cur_block = None
        with self._lock:
            rows = self._conn().execute(
                "SELECT id, data FROM attrs ORDER BY id"
            ).fetchall()
        for id_, data in rows:
            blk = id_ // ATTR_BLOCK_SIZE
            if blk != cur_block:
                if cur_block is not None:
                    out.append((cur_block, h.digest()))
                cur_block, h = blk, hashlib.blake2b(digest_size=16)
            h.update(str(id_).encode())
            h.update(data.encode())
        if cur_block is not None:
            out.append((cur_block, h.digest()))
        return out

    def block_data(self, block: int) -> dict[int, dict]:
        lo, hi = block * ATTR_BLOCK_SIZE, (block + 1) * ATTR_BLOCK_SIZE
        with self._lock:
            rows = self._conn().execute(
                "SELECT id, data FROM attrs WHERE id >= ? AND id < ? ORDER BY id",
                (lo, hi),
            ).fetchall()
        return {r[0]: json.loads(r[1]) for r in rows}

    def blocks_diff(self, other_blocks: list[tuple[int, bytes]]) -> list[int]:
        """Block ids whose checksums differ from a peer's (reference
        attrBlocks.Diff, attr.go:90)."""
        mine = dict(self.blocks())
        theirs = dict(other_blocks)
        return sorted(
            set(b for b in mine if mine[b] != theirs.get(b))
            | set(b for b in theirs if theirs[b] != mine.get(b))
        )

    def close(self) -> None:
        with self._lock:
            self._db.close()
