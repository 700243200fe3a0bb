"""Key translation: string keys ⇄ uint64 ids, per index and per field.

A copy of pilosa_tpu/storage/translate.py.

Parity target: the reference's TranslateStore interface (translate.go:35)
with its two implementations — in-memory (translate.go:195) and the
persistent BoltDB store with monotonic sequence allocation
(boltdb/translate.go:48,140).  Ours uses sqlite3 (stdlib, transactional)
for the persistent tier; ids allocate from 1 the way the reference's
bucket sequence does.

Replication model (reference holder.go:690-878, http/translator.go:30):
exactly one primary store per (index, field) accepts writes; replicas
open read-only and tail the primary's append-ordered entry stream via
``entries(after_offset)`` / ``apply_entry``.  The cluster layer decides
who is primary; this module only enforces the read-only flag.
"""

from __future__ import annotations

import os
import sqlite3
import threading


class TranslateError(ValueError):
    pass


class ReadOnlyError(TranslateError):
    """Write attempted on a non-primary translate store
    (reference ErrTranslateStoreReadOnly, translate.go:28)."""


class TranslateStore:
    """Interface; see module docstring.  Offsets are 1-based and dense:
    the entry with offset N is the Nth key ever created, so replicas
    resume from their local max offset."""

    read_only = False

    def translate_key(self, key: str, create: bool = False) -> int | None:
        raise NotImplementedError

    def translate_keys(self, keys, create: bool = False) -> list[int | None]:
        return [self.translate_key(k, create) for k in keys]

    def translate_id(self, id: int) -> str | None:
        raise NotImplementedError

    def translate_ids(self, ids) -> list[str | None]:
        return [self.translate_id(i) for i in ids]

    def max_offset(self) -> int:
        raise NotImplementedError

    def entries(self, after: int, limit: int = 10000) -> list[tuple[int, int, str]]:
        """Replication stream: [(offset, id, key)] with offset > after."""
        raise NotImplementedError

    def apply_entry(self, offset: int, id: int, key: str) -> None:
        """Replica-side apply of a streamed entry (idempotent)."""
        raise NotImplementedError

    def apply_entries(self, entries) -> None:
        """Replica-side apply of a whole streamed page
        [(offset, id, key)] — overridden where a single transaction
        beats per-entry commits (tailing a 1M-key backlog pays one
        fsync per PAGE, not per key)."""
        for off, id_, key in entries:
            self.apply_entry(off, id_, key)

    def set_read_only(self, ro: bool) -> None:
        self.read_only = ro

    def close(self) -> None:
        pass

    def _check_writable(self) -> None:
        if self.read_only:
            raise ReadOnlyError("translate store is read-only (non-primary replica)")


class MemTranslateStore(TranslateStore):
    """Dict-backed store (reference inMemTranslateStore, translate.go:195)."""

    def __init__(self):
        self._by_key: dict[str, int] = {}
        self._by_id: dict[int, str] = {}
        self._log: list[tuple[int, int, str]] = []
        self._lock = threading.Lock()

    def translate_key(self, key: str, create: bool = False) -> int | None:
        with self._lock:
            id = self._by_key.get(key)
            if id is not None or not create:
                return id
            self._check_writable()
            id = len(self._log) + 1
            self._by_key[key] = id
            self._by_id[id] = key
            self._log.append((id, id, key))
            return id

    def translate_id(self, id: int) -> str | None:
        with self._lock:
            return self._by_id.get(id)

    def max_offset(self) -> int:
        with self._lock:
            return len(self._log)

    def entries(self, after: int, limit: int = 10000) -> list[tuple[int, int, str]]:
        with self._lock:
            return self._log[after : after + limit]

    def apply_entry(self, offset: int, id: int, key: str) -> None:
        with self._lock:
            if self._by_id.get(id) == key:
                return
            self._by_key[key] = id
            self._by_id[id] = key
            self._log.append((offset, id, key))


class SQLiteTranslateStore(TranslateStore):
    """Persistent store (reference boltdb/translate.go:48).  One table of
    (id INTEGER PRIMARY KEY, key TEXT UNIQUE); AUTOINCREMENT gives the
    monotonic sequence the reference allocates from its bolt bucket
    (boltdb/translate.go:140), and rowid order IS the replication offset
    order because ids are append-only and never reused."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._local = threading.local()
        self._lock = threading.Lock()
        # Initialize schema once via a dedicated connection.
        con = self._conn()
        with self._lock:
            con.execute(
                "CREATE TABLE IF NOT EXISTS keys ("
                "id INTEGER PRIMARY KEY AUTOINCREMENT, key TEXT UNIQUE NOT NULL)"
            )
            con.commit()

    def _conn(self) -> sqlite3.Connection:
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self.path, timeout=30.0)
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            self._local.con = con
        return con

    def translate_key(self, key: str, create: bool = False) -> int | None:
        con = self._conn()
        cur = con.execute("SELECT id FROM keys WHERE key = ?", (key,))
        row = cur.fetchone()
        if row is not None:
            return int(row[0])
        if not create:
            return None
        self._check_writable()
        with self._lock:
            try:
                cur = con.execute("INSERT INTO keys (key) VALUES (?)", (key,))
                con.commit()
                return int(cur.lastrowid)
            except sqlite3.IntegrityError:  # lost a create race
                con.rollback()
                cur = con.execute("SELECT id FROM keys WHERE key = ?", (key,))
                return int(cur.fetchone()[0])

    def translate_keys(self, keys, create: bool = False) -> list[int | None]:
        """Batched translate: IN-chunked lookups plus ONE
        INSERT-OR-IGNORE transaction for all new keys — the per-key
        path commits (fsyncs) once per new key, which dominates keyed
        bulk imports.  Same race semantics as translate_key: a
        concurrent creator wins and the re-select picks up its id."""
        # normalize to str up front: the per-key path matched numeric
        # keys through SQLite's TEXT affinity, but a dict keyed on the
        # DB's returned strings would miss them; None never worked (it
        # crashed in the race handler) so reject it loudly
        norm = []
        for k in keys:
            if k is None:
                raise ValueError("null key")
            norm.append(k if isinstance(k, str) else str(k))
        keys = norm
        uniq = list(dict.fromkeys(keys))
        con = self._conn()
        found: dict[str, int] = {}

        def select_into(chunked):
            for k, id_ in self._select_in(con, "key", chunked):
                found[k] = int(id_)

        select_into(uniq)
        if create:
            missing = [k for k in uniq if k not in found]
            if missing:
                self._check_writable()
                with self._lock:
                    try:
                        con.executemany(
                            "INSERT OR IGNORE INTO keys (key) VALUES (?)",
                            [(k,) for k in missing])
                        con.commit()
                    except Exception:
                        con.rollback()
                        raise
                select_into(missing)
        return [found.get(k) for k in keys]

    def translate_id(self, id: int) -> str | None:
        cur = self._conn().execute("SELECT key FROM keys WHERE id = ?", (int(id),))
        row = cur.fetchone()
        return None if row is None else row[0]

    @staticmethod
    def _select_in(con, column: str, values):
        """(key, id) rows for ``values`` matched on ``column``, one
        IN-query per 500 values (comfortably under SQLite's 999
        parameter floor) — the shared chunking for both batched
        directions."""
        for i in range(0, len(values), 500):
            chunk = values[i:i + 500]
            yield from con.execute(
                "SELECT key, id FROM keys WHERE "
                f"{column} IN ({','.join('?' * len(chunk))})", chunk)

    def translate_ids(self, ids) -> list[str | None]:
        """Batched lookup: one IN-query per 500 ids instead of a
        round-trip per id (translating a large Row result is otherwise
        dominated by per-id SELECTs)."""
        ids = [int(i) for i in ids]
        found: dict[int, str] = {}
        for key, id_ in self._select_in(self._conn(), "id", ids):
            found[int(id_)] = key
        return [found.get(i) for i in ids]

    def max_offset(self) -> int:
        cur = self._conn().execute("SELECT COALESCE(MAX(rowid), 0) FROM keys")
        return int(cur.fetchone()[0])

    def entries(self, after: int, limit: int = 10000) -> list[tuple[int, int, str]]:
        cur = self._conn().execute(
            "SELECT rowid, id, key FROM keys WHERE rowid > ? ORDER BY rowid LIMIT ?",
            (int(after), int(limit)),
        )
        return [(int(o), int(i), k) for o, i, k in cur.fetchall()]

    def apply_entry(self, offset: int, id: int, key: str) -> None:
        con = self._conn()
        with self._lock:
            con.execute(
                "INSERT OR IGNORE INTO keys (id, key) VALUES (?, ?)", (int(id), key)
            )
            con.commit()

    def apply_entries(self, entries) -> None:
        """One INSERT-OR-IGNORE transaction per streamed page: a
        replica catching up a large backlog commits once per ~10k-entry
        page instead of once per key (the per-entry path fsynced every
        apply — the dominant cost of 1M-key tail catch-up)."""
        con = self._conn()
        with self._lock:
            try:
                con.executemany(
                    "INSERT OR IGNORE INTO keys (id, key) VALUES (?, ?)",
                    [(int(id_), key) for _, id_, key in entries])
                con.commit()
            except Exception:
                con.rollback()
                raise

    def close(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()
            self._local.con = None


def open_translate_store(path: str | None) -> TranslateStore:
    """Persistent store when a path exists, in-memory otherwise — the same
    split the holder makes for every other storage tier."""
    if path is None:
        return MemTranslateStore()
    return SQLiteTranslateStore(path)
