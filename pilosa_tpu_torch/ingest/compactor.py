"""Background delta compaction: merges pending delta planes into the base
rows without blocking a writer.

Copy of pilosa_tpu/ingest/compactor.py.  Policy lives here, the mechanism
in ``Fragment.flush_delta``: a fragment registers on its first delta
write (``note_delta``), and the scan thread merges it once its delta
holds ``compact_threshold_bits`` positions, is one ``compact_interval``
old, or outgrows the budget; past the process-wide pending-byte budget
the WRITER flushes its own fragment inline (``note_delta`` returns True).

Lock order is fragment -> compactor everywhere: ``note_delta`` and
``note_flushed`` run under the fragment lock and take the registry lock
inside; the scan snapshots the registry, releases it, then calls
``flush_delta``.

Each scan of the thread runs under one ``internal`` ticket of the
server's admission controller (``Compactor.admission``, set by the
server assembly), so that compaction yields to query pressure: a scan
the gate sheds is skipped (``compact_skipped``) and the next interval
retries, the deltas still pending (pilosa_tpu/ingest/compactor.py:
212-231).  With no controller, or one disabled, the scan just runs.

Left out, with the port's lack of the layers they hook into: the
``compactor.merge`` failpoint (no ``faultinject``), the
``compaction.run`` journal event and ``publish_gauges`` (no ``observe``
nor stats registry).  ``GET /debug/ingest`` serves ``debug()``.
"""

from __future__ import annotations

import threading
import weakref

from pilosa_tpu_torch import ingest as _ingest
from pilosa_tpu_torch.serve.admission import ShedError
from pilosa_tpu_torch.serve.deadline import Deadline


class Compactor:
    """Process-wide delta-compaction policy and scan thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: id(frag) -> (weakref, last-known pending bytes)
        self._frags: dict[int, tuple] = {}
        self._pending_bytes = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._paused = False
        self.compactions = 0
        self.compacted_bits = 0
        self.inline_flushes = 0
        self.compact_skipped = 0
        self.delta_writes = 0
        self.admission = None  # serve.admission.AdmissionController

    # -------------------------------------------------- fragment callbacks

    def note_delta(self, frag) -> bool:
        """A delta write landed on ``frag`` (the caller holds its lock).
        Registers the fragment; True when the process-wide pending budget
        is exceeded and the caller must flush its own fragment inline."""
        d = frag._delta
        nbytes = 0 if d is None else d.nbytes
        budget = _ingest.config().delta_budget_bytes
        with self._lock:
            self.delta_writes += 1
            fid = id(frag)
            prev = self._frags.get(fid)
            self._pending_bytes += nbytes - (prev[1] if prev else 0)
            self._frags[fid] = (weakref.ref(frag), nbytes)
            return self._pending_bytes > budget > 0

    def note_flushed(self, frag, bits: int, inline: bool = False) -> None:
        """``frag`` merged its delta (the caller holds its lock)."""
        with self._lock:
            self._drop_locked(id(frag))
            self.compactions += 1
            self.compacted_bits += bits
            if inline:
                self.inline_flushes += 1

    def forget(self, frag) -> None:
        """Drop a fragment from the registry (its WAL carries the pending
        bits durably)."""
        with self._lock:
            self._drop_locked(id(frag))

    def _drop_locked(self, fid: int) -> None:
        prev = self._frags.pop(fid, None)
        if prev is not None:
            self._pending_bytes = max(0, self._pending_bytes - prev[1])

    # ------------------------------------------------------------- policy

    @staticmethod
    def _due(frag, cfg) -> bool:
        # a deliberately racy read: a stale size or age defers the merge
        # one scan, and flush_delta re-checks under the fragment lock
        d = frag._delta
        if d is None or d.empty():
            return True  # flush_delta no-ops; run_once deregisters
        return (d.bits >= cfg.compact_threshold_bits
                or d.age_s() >= cfg.compact_interval
                or d.nbytes > cfg.delta_budget_bytes)

    def run_once(self, force: bool = False) -> int:
        """One scan: merge every due (with ``force``, every pending)
        delta.  Returns the number of fragments flushed."""
        cfg = _ingest.config()
        with self._lock:
            if self._paused and not force:
                return 0
            snapshot = [(fid, ref) for fid, (ref, _) in self._frags.items()]
        flushed = 0
        for fid, ref in snapshot:
            frag = ref()
            if frag is None:
                with self._lock:
                    self._drop_locked(fid)
                continue
            if not (force or self._due(frag, cfg)):
                continue
            if frag.flush_delta() == 0:
                # already empty (a read-side flush won the race):
                # deregister, but only while the delta is STILL empty
                # under the fragment lock -- a writer landing in between
                # re-registered it, and dropping that entry would hide
                # its delta from every later scan
                with frag._lock:
                    d = frag._delta
                    if d is None or d.empty():
                        self.forget(frag)
            else:
                flushed += 1
        return flushed

    # ------------------------------------------------------------- thread

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ingest-compactor")
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def pause(self) -> None:
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    def _loop(self) -> None:
        stop = self._stop
        while not stop.wait(_ingest.config().compact_interval):
            try:
                self._run_gated()
            except Exception:  # noqa: BLE001 -- the scan must not die;
                pass  # the next interval retries (the WAL holds the bits)

    def _run_gated(self) -> None:
        """One scan under the internal admission class; a shed scan is
        skipped and the next interval retries."""
        adm = self.admission
        if adm is None or not adm.enabled:
            self.run_once()
            return
        try:
            ticket = adm.acquire(
                "internal", Deadline(_ingest.config().compact_interval))
        except ShedError:
            with self._lock:
                self.compact_skipped += 1
            return
        try:
            self.run_once()
        finally:
            ticket.release()

    # -------------------------------------------------------------- views

    def pending(self) -> list[tuple]:
        """Live (fragment, delta stats) pairs, largest pending first."""
        with self._lock:
            refs = [ref for ref, _ in self._frags.values()]
        out = []
        for ref in refs:
            frag = ref()
            if frag is None:
                continue
            with frag._lock:
                d = frag._delta
                if d is None or d.empty():
                    continue
                out.append((frag, d.stats()))
        out.sort(key=lambda fs: -fs[1]["bits"])
        return out

    def totals(self, pend: list[tuple] | None = None) -> dict:
        if pend is None:
            pend = self.pending()
        with self._lock:
            return {
                "fragmentsPending": len(pend),
                "pendingBits": sum(s["bits"] for _, s in pend),
                "pendingRows": sum(s["rows"] for _, s in pend),
                "pendingBytes": sum(s["bytes"] for _, s in pend),
                "deltaWrites": self.delta_writes,
                "compactions": self.compactions,
                "compactedBits": self.compacted_bits,
                "inlineFlushes": self.inline_flushes,
                "compactSkipped": self.compact_skipped,
                "paused": self._paused,
                "running": (self._thread is not None
                            and self._thread.is_alive()),
            }

    def debug(self, top_n: int = 32) -> dict:
        """The /debug/ingest document: the config, the totals and the
        largest pending deltas."""
        cfg = _ingest.config()
        out = {
            "config": {
                "deltaEnabled": cfg.delta_enabled,
                "deltaBudgetBytes": cfg.delta_budget_bytes,
                "compactThresholdBits": cfg.compact_threshold_bits,
                "compactInterval": cfg.compact_interval,
            },
        }
        pend = self.pending()
        out.update(self.totals(pend))
        out["top"] = [{
            "index": frag.index, "field": frag.field, "view": frag.view,
            "shard": frag.shard, "deltaSeq": frag._delta_seq, **s,
        } for frag, s in pend[:top_n]]
        return out


# ----------------------------------------------------------- process-wide

_global: Compactor | None = None
_global_lock = threading.Lock()


def compactor() -> Compactor:
    """The process-wide compactor."""
    global _global
    c = _global
    if c is not None:
        return c
    with _global_lock:
        if _global is None:
            _global = Compactor()
        return _global


# The scan thread and the [ingest] config are shared by every in-process
# server: the ingest-enabled servers are reference-counted, so an early
# closer cannot stop the thread (or restore the config) under a
# still-open one.
_refs = 0


def retain() -> Compactor:
    """One more open ingest-enabled server: start (or keep) the thread."""
    global _refs
    with _global_lock:
        _refs += 1
    c = compactor()
    c.start()
    return c


def release() -> bool:
    """Drop one reference; stops the thread and returns True only for
    the LAST one, whose caller then restores the [ingest] baseline."""
    global _refs
    with _global_lock:
        _refs = max(0, _refs - 1)
        last = _refs == 0
    if last:
        compactor().stop()
    return last


def refs() -> int:
    return _refs

