"""Streaming ingest: per-fragment delta planes with background compaction.

Copy of pilosa_tpu/ingest/__init__.py.  Writes (``set_bit``/
``clear_bit``, ``import_positions``, sparse ``import_roaring``) land in a
small per-fragment **delta plane** (``deltaplane.DeltaPlane``: set-bits
and clear-bits word planes) without bumping the fragment's base
generation ``_gen``; reads fuse ``(base & ~clear) | set`` (the ``dfuse``
node of ops/expr.py and ops/tape.py); the compactor
(``compactor.Compactor``) merges a delta into the base rows once it
crosses a size or age threshold, or the process-wide byte budget.  Only
compaction bumps ``_gen``.

- ``Fragment._gen`` -- the BASE generation.  Device row stacks and
  container leaves key on it, so a delta write leaves them warm.
- ``Fragment._delta_seq`` -- bumped on every delta-landing write, never
  reset; the effective-content tokens carry it.

Durability is unchanged: a delta-landing write appends the same WAL
record as the base path, and compaction appends nothing (replay is
idempotent and in order).

The knobs are process-wide, as the reference's ``[ingest]`` section
(pilosa_tpu/config.py:326-329).  Unlike the reference module, whose
default is off until a server turns it on, the port's default is the
reference configuration's: deltas on.
"""

from __future__ import annotations

import threading

#: process-wide bound on PENDING delta bytes; past it the writing thread
#: flushes its own fragment inline
DEFAULT_DELTA_BUDGET_BYTES = 64 << 20

#: a delta holding at least this many pending bit positions merges on
#: the compactor's next scan
DEFAULT_COMPACT_THRESHOLD_BITS = 1 << 17

#: the compactor's scan period (seconds) and the age bound: a delta older
#: than one interval merges on the next scan even when small
DEFAULT_COMPACT_INTERVAL_S = 2.0


class IngestConfig:
    """The process-wide [ingest] knobs."""

    __slots__ = ("delta_enabled", "delta_budget_bytes",
                 "compact_threshold_bits", "compact_interval")

    def __init__(self) -> None:
        self.delta_enabled = True
        self.delta_budget_bytes = DEFAULT_DELTA_BUDGET_BYTES
        self.compact_threshold_bits = DEFAULT_COMPACT_THRESHOLD_BITS
        self.compact_interval = DEFAULT_COMPACT_INTERVAL_S


_cfg = IngestConfig()
_cfg_lock = threading.Lock()


def config() -> IngestConfig:
    return _cfg


def configure(delta_enabled: bool | None = None,
              delta_budget_bytes: int | None = None,
              compact_threshold_bits: int | None = None,
              compact_interval: float | None = None) -> IngestConfig:
    """Apply [ingest] config in place -- only explicit values land, so a
    second in-process server does not wipe the first's settings."""
    with _cfg_lock:
        if delta_enabled is not None:
            _cfg.delta_enabled = bool(delta_enabled)
        if delta_budget_bytes is not None:
            _cfg.delta_budget_bytes = int(delta_budget_bytes)
        if compact_threshold_bits is not None:
            _cfg.compact_threshold_bits = int(compact_threshold_bits)
        if compact_interval is not None:
            _cfg.compact_interval = float(compact_interval)
    return _cfg


# Servers configure the knobs in place but open and close independently:
# the FIRST server to configure captures the pre-server baseline and the
# LAST one to close restores it, which is right in any close order.
_baseline: tuple | None = None


def capture_baseline() -> None:
    """Snapshot the config in force, once per overlapping group of
    in-process servers (a no-op while a baseline is held)."""
    global _baseline
    with _cfg_lock:
        if _baseline is None:
            _baseline = tuple(getattr(_cfg, k) for k in _cfg.__slots__)


def restore_baseline() -> None:
    """Re-install the captured baseline and release it (the last closing
    server calls this)."""
    global _baseline
    with _cfg_lock:
        if _baseline is None:
            return
        for k, v in zip(_cfg.__slots__, _baseline):
            setattr(_cfg, k, v)
        _baseline = None


def delta_enabled() -> bool:
    return _cfg.delta_enabled
