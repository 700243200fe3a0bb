"""Compressed container-directory Count/Row engine on torch tensors.

Port of pilosa_tpu/ops/containers.py, with its array and run kinds
(``[containers] kinds``, on by default as in the reference):

- **Layout** -- per row, the non-empty 2^16-bit containers of every
  shard of the query, driven by a host DIRECTORY (per shard: sorted
  container keys, the shard's base offset, and each container's kind).
  An all-bitmap row keeps the one-pool layout: its 2048-word blocks
  concatenate into one int32 pool padded to ``_pow2(n + 1)`` rows with
  the all-zero row at ``n``, the canonical absent container.  A row with
  array or run containers (ops/kindpools.py picks the kind by the wire
  serializer's cost rule) splits them into three pools -- bitmap blocks,
  uint16 arrays with cardinalities, uint16 (start, last) runs -- each
  with its canonical empty row (models/field.py
  ``device_container_leaf``).
- **Execution** -- the ROOT's container-key domain per shard follows
  roaring's set rules (``_domain``); each leaf's gather indices map the
  concatenated domain into its pool (``_leaf_indices``), or, for a kinds
  query, into each kind's pool with a per-lane kind byte
  (``_leaf_kind_indices``), padded to a power of two.  The
  ``Count(Intersect(Row, Row))`` pair of bitmap rows runs the CUDA kernel
  K2 (ops/cuda_kernels.gathered_count_and); the same pair of array rows,
  or of an array and a bitmap row, runs the reference's array arms
  (ops/kindpools.gathered_count_array_*); every other tree gathers,
  decodes and folds in torch (ops/expr.evaluate_gathered[_kinds]).
- **Fallback** -- a leaf row whose fill ratio (bits / shard width)
  exceeds the ``[containers]`` threshold in any shard routes the whole
  query to the dense path, as does ``?nocontainers=1`` or
  ``configure(enabled=False)``.  So does a pending ingest delta on a
  queried row (the pools hold base content); ``?nodelta=1`` compacts the
  rows' deltas first.
- **Bitmap VM** -- ``stage_vm`` stages a coalesced Count the same way
  but keeps only each leaf's local gather rows; at flush the coalescer
  concatenates the bucket's leaves into one ``megapool`` -- a plain pool
  for all-bitmap leaves, run by K3, or a ``MegaPools`` bundle of the
  three kind pools, run by K3-kinds, which decodes the compact rows as
  it gathers them (ops/tape.execute_vm).  A row with a pending ingest
  delta stays compressed there: its overlay stages as two more all-bitmap
  leaves under a ``dfuse`` node, ``(base & ~clear) | set``.

Configuration and counters are process-wide, as in the reference.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import cuda_kernels, expr
from pilosa_tpu_torch.ops import kindpools as kp
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

#: 2^16 bits = 2048 32-bit words per container
CONTAINER_BITS = 1 << 16
CWORDS = CONTAINER_BITS // 32

DEFAULT_THRESHOLD = 0.25

#: kind-selection defaults ([containers] kinds / array-max / run-cap,
#: pilosa_tpu/ops/containers.py:66-74): ``array_max`` narrows the array
#: kind's cardinality ceiling below 4096 and ``run_cap`` bounds the run
#: pool's interval size class
DEFAULT_KINDS = True
DEFAULT_ARRAY_MAX = 4096
DEFAULT_RUN_CAP = kp.DEFAULT_RUN_CAP

_AND_PAIR = ("and", ("leaf", 0), ("leaf", 1))


def _pow2(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b <<= 1
    return b


# ------------------------------------------------------------ runtime config


class ContainersRuntimeConfig:
    """The process-wide [containers] knobs."""

    __slots__ = ("enabled", "threshold", "kinds", "array_max", "run_cap")

    def __init__(self) -> None:
        self.enabled = True
        self.threshold = DEFAULT_THRESHOLD
        self.kinds = DEFAULT_KINDS
        self.array_max = DEFAULT_ARRAY_MAX
        self.run_cap = DEFAULT_RUN_CAP


_cfg = ContainersRuntimeConfig()
_cfg_lock = threading.Lock()
_baseline: tuple | None = None
_refs = 0


def config() -> ContainersRuntimeConfig:
    return _cfg


def configure(enabled: bool | None = None,
              threshold: float | None = None,
              kinds: bool | None = None,
              array_max: int | None = None,
              run_cap: int | None = None) -> ContainersRuntimeConfig:
    """Apply [containers] config in place -- only explicit values land."""
    with _cfg_lock:
        if enabled is not None:
            _cfg.enabled = bool(enabled)
        if threshold is not None:
            _cfg.threshold = float(threshold)
        if kinds is not None:
            _cfg.kinds = bool(kinds)
        if array_max is not None:
            _cfg.array_max = int(array_max)
        if run_cap is not None:
            _cfg.run_cap = int(run_cap)
    return _cfg


def retain() -> None:
    """Take a server reference; the first holder snapshots the config
    in force, which the last ``release`` restores
    (pilosa_tpu/ops/containers.py:136-160)."""
    global _refs, _baseline
    with _cfg_lock:
        if _refs == 0 and _baseline is None:
            _baseline = tuple(getattr(_cfg, k) for k in _cfg.__slots__)
        _refs += 1


def release() -> None:
    """Drop a server reference; the last one restores the baseline."""
    global _refs, _baseline
    with _cfg_lock:
        if _refs > 0:
            _refs -= 1
        if _refs == 0 and _baseline is not None:
            for k, v in zip(_cfg.__slots__, _baseline):
                setattr(_cfg, k, v)
            _baseline = None


def reset() -> ContainersRuntimeConfig:
    """Restore the defaults and drop any held baseline (tests)."""
    global _cfg, _baseline, _refs
    with _cfg_lock:
        _cfg = ContainersRuntimeConfig()
        _baseline = None
        _refs = 0
    return _cfg


# ---------------------------------------------------------------- counters

_lock = threading.Lock()
_counters = {
    "container.queries": 0,             # fused reads served compressed
    "container.fallbacks": 0,           # eligible trees routed dense
    "container.containers_gathered": 0,  # domain containers launched
    "container.containers_skipped": 0,   # containers never touched
    "container.empty_domains": 0,       # whole-query zero-work answers
    # per-kind breakout of containers_gathered
    "container.bitmap_gathered": 0,
    "container.array_gathered": 0,
    "container.run_gathered": 0,
}


def bump(name: str, value: int = 1) -> None:
    with _lock:
        _counters[name] += value


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def debug() -> dict[str, Any]:
    """``GET /debug/containers``: the config in force and the counters
    (pilosa_tpu/ops/containers.py:215)."""
    return {
        "enabled": _cfg.enabled,
        "threshold": _cfg.threshold,
        "kinds": _cfg.kinds,
        "arrayMax": _cfg.array_max,
        "runCap": _cfg.run_cap,
        "counters": counters(),
    }


# -------------------------------------------------------------- leaf pooling

_LEAF_UID = itertools.count(1)


class ContainerLeaf:
    """One expression leaf (a standard-view row across the query's
    shard set) in pooled compressed form.

    ``entries[i]`` describes shard ``shards[i]``: ``None`` for a hot
    fragment row (dense fallback evidence), else a sorted int64 array of
    the row's non-empty container keys (possibly empty).  ``starts[i]``
    is the shard's base offset into the flat directory; ``kinds[i]`` the
    kind byte of each of the shard's containers (1 bitmap, 2 array, 3
    run; None when kinds are off).  ``pool`` is an int32[P, CWORDS]
    tensor whose rows ``[n:]`` are zero -- gather index ``n`` is the
    canonical absent container.

    A KINDS leaf (``slots`` not None) splits its containers across three
    pools: ``pool`` holds only the bitmap blocks (``n`` of them),
    ``apool``/``acard`` the arrays (int16[Pa, acap] holding uint16
    values, int32[Pa]; row ``an`` the empty array) and ``rpool`` the runs
    (int16[Pr, 2 * rcap]; row ``rn`` all invalid pairs).  ``slots[i]``
    gives each of shard i's containers its row in its own kind's pool.
    An all-bitmap leaf keeps ``slots`` None and the one-pool layout."""

    __slots__ = ("shards", "entries", "starts", "pool", "n", "nbytes",
                 "uid", "kinds", "slots", "apool", "acard", "rpool", "an",
                 "rn")

    def __init__(self, shards: tuple, entries: list, starts: list,
                 pool: torch.Tensor, n: int, nbytes: int,
                 kinds: list | None = None, slots: list | None = None,
                 apool: torch.Tensor | None = None,
                 acard: torch.Tensor | None = None,
                 rpool: torch.Tensor | None = None, an: int = 0,
                 rn: int = 0) -> None:
        self.shards = shards
        self.entries = entries
        self.starts = starts
        self.pool = pool
        self.n = n
        self.nbytes = nbytes
        self.kinds = kinds
        self.slots = slots
        self.apool = apool
        self.acard = acard
        self.rpool = rpool
        self.an = an
        self.rn = rn
        # identity for the staging memo: a rebuilt leaf is a new object
        # with a fresh uid, so stale staged gathers are never addressed
        self.uid = next(_LEAF_UID)

    def dense_slots(self) -> list[int]:
        """Shard positions whose fragment row is too hot to compress."""
        return [i for i, e in enumerate(self.entries) if e is None]

    @property
    def has_kinds(self) -> bool:
        """True when the leaf carries array or run containers."""
        return self.slots is not None


def build_pool(blocks: list[np.ndarray], n: int) -> np.ndarray:
    """uint32[_pow2(n + 1), CWORDS] host pool: the ``n`` directory
    blocks, then zero rows (row ``n`` is the absent container)."""
    pool = np.zeros((_pow2(n + 1), CWORDS), dtype=np.uint32)
    if blocks:
        np.concatenate(blocks, axis=0, out=pool[:n])
    return pool


def containers_from_numpy(pool: np.ndarray, entries: list, starts: list,
                          n: int, device: torch.device | str
                          ) -> ContainerLeaf:
    """A ContainerLeaf over the reference's numpy pool and directory
    (uint32 pool, per-shard key arrays, base offsets, live block count)
    -- so kernel-level tests feed both packages identical pools."""
    host = np.array(pool, dtype=np.uint32)
    dev = torch.from_numpy(host.view(np.int32)).to(device)
    return ContainerLeaf(tuple(range(len(entries))), list(entries),
                         list(starts), dev, int(n), host.nbytes)


# ------------------------------------------------------------ domain algebra


def _domain(shape: tuple, keysets: list) -> np.ndarray:
    """The ROOT's container-key domain for one shard, from the leaves'
    key sets by roaring's per-op rules (Intersect intersects, Union and
    Xor union, Difference keeps the left side, Not keeps the existence
    row's keys)."""
    kind = shape[0]
    if kind == "leaf":
        return keysets[shape[1]]
    if kind == "and":
        out = _domain(shape[1], keysets)
        for c in shape[2:]:
            out = np.intersect1d(out, _domain(c, keysets),
                                 assume_unique=True)
        return out
    if kind in ("or", "xor"):
        out = _domain(shape[1], keysets)
        for c in shape[2:]:
            out = np.union1d(out, _domain(c, keysets))
        return out
    if kind in ("andnot", "not"):
        return _domain(shape[1], keysets)
    if kind == "dfuse":
        # (child & ~clear) | set: a result bit can only live in the
        # child's or the set overlay's containers
        return np.union1d(_domain(shape[1], keysets),
                          _domain(shape[2], keysets))
    raise ValueError(f"container-ineligible node: {kind!r}")


def _leaf_indices(leaf: ContainerLeaf, domains: list[np.ndarray],
                  pad_to: int) -> np.ndarray:
    """Gather indices into ``leaf.pool`` for the concatenated per-shard
    domains; absent containers and the pow2 tail point at the pool's
    zero row."""
    zero = leaf.n
    parts: list[np.ndarray] = []
    for i, dom in enumerate(domains):
        if len(dom) == 0:
            continue
        keys = leaf.entries[i]
        if keys is None or len(keys) == 0:
            parts.append(np.full(len(dom), zero, dtype=np.int32))
            continue
        pos = np.searchsorted(keys, dom)
        pos_c = np.minimum(pos, len(keys) - 1)
        hit = keys[pos_c] == dom
        idx = np.where(hit, leaf.starts[i] + pos_c, zero)
        parts.append(idx.astype(np.int32))
    total = sum(len(p) for p in parts)
    out = np.full(pad_to, zero, dtype=np.int32)
    if parts:
        np.concatenate(parts, out=out[:total])
    return out


def _leaf_kind_indices(leaf: ContainerLeaf, domains: list[np.ndarray],
                       pad_to: int) -> tuple:
    """Kind-dispatched gather rows for the concatenated per-shard domains
    (pilosa_tpu/ops/containers.py:365): ``(kv, ib, ia, ir)``, the lane's
    kind byte (0 absent or pad) and its row in each kind's pool.  A lane
    points at the canonical empty row of every pool but its own kind's
    (bitmap row ``n``, array row ``an``, run row ``rn``), so gathering
    all three pools, decoding and OR-ing rebuilds the lane's block.  An
    all-bitmap leaf gives kv in {0, 1} and ``ib`` = ``_leaf_indices``."""
    kv = np.zeros(pad_to, dtype=np.uint8)
    ib = np.full(pad_to, leaf.n, dtype=np.int32)
    ia = np.full(pad_to, leaf.an, dtype=np.int32)
    ir = np.full(pad_to, leaf.rn, dtype=np.int32)
    off = 0
    for i, dom in enumerate(domains):
        if len(dom) == 0:
            continue
        keys = leaf.entries[i]
        if keys is None or len(keys) == 0:
            off += len(dom)
            continue
        pos = np.searchsorted(keys, dom)
        pos_c = np.minimum(pos, len(keys) - 1)
        hit = keys[pos_c] == dom
        if leaf.slots is None:
            k = np.where(hit, 1, 0).astype(np.uint8)
            loc = (leaf.starts[i] + pos_c).astype(np.int32)
        else:
            k = np.where(hit, leaf.kinds[i][pos_c], 0).astype(np.uint8)
            loc = leaf.slots[i][pos_c].astype(np.int32)
        seg = slice(off, off + len(dom))
        kv[seg] = k
        ib[seg] = np.where(k == 1, loc, leaf.n)
        ia[seg] = np.where(k == 2, loc, leaf.an)
        ir[seg] = np.where(k == 3, loc, leaf.rn)
        off += len(dom)
    return kv, ib, ia, ir


def _bump_kind_gathers(idxs: list, total: int) -> None:
    """Per-kind breakout of containers_gathered from the staged rows
    (live lanes only; the pow2 tail is kind 0)."""
    n_b = n_a = n_r = 0
    for ix in idxs:
        if isinstance(ix, tuple):
            kv = ix[0][:total]
            n_b += int((kv == 1).sum())
            n_a += int((kv == 2).sum())
            n_r += int((kv == 3).sum())
        else:
            n_b += total
    for name, v in (("bitmap", n_b), ("array", n_a), ("run", n_r)):
        if v:
            bump(f"container.{name}_gathered", v)


def _stage_indices(leaves: list, domains: list, pad: int) -> list:
    """Per-leaf gather rows: the kinds protocol's tuples when any leaf
    carries array or run containers, else the one-pool index arrays."""
    if any(leaf.has_kinds for leaf in leaves):
        return [_leaf_kind_indices(leaf, domains, pad) for leaf in leaves]
    return [_leaf_indices(leaf, domains, pad) for leaf in leaves]


# Staged-gather memo: (shape, leaf uids) -> (domains, bounds, total, idxs,
# device idxs).  Leaf uids change on every rebuild, so stale entries stop
# being addressed; the cap bounds memory.
_stage_lock = threading.Lock()
_stage_memo: dict = {}
_STAGE_MEMO_CAP = 256


def _to_device(ix, device) -> torch.Tensor | tuple:
    """Staged gather rows on the pools' device: one index tensor, or the
    kinds protocol's (ib, ia, ir) tensors (its kv stays on the host)."""
    if isinstance(ix, tuple):
        return tuple(torch.from_numpy(v).to(device) for v in ix[1:])
    return torch.from_numpy(ix).to(device)


# ------------------------------------------------------------------ planning


class Plan:
    """A fused read staged for compressed execution over ALL its shards.
    ``counts()`` / ``row_words()`` each tick exactly one dispatch, like
    the dense fused path."""

    def __init__(self, shape: tuple, leaves: list[ContainerLeaf],
                 shards: tuple, cpr: int, n_words: int) -> None:
        self.shape = shape
        self.leaves = leaves
        self.shards = shards
        self.cpr = cpr
        self.n_words = n_words
        self._staged: tuple | None = None

    def _stage(self) -> tuple:
        """(domains, bounds, total, idxs, dev_idxs) -- the per-shard
        root domains, their concatenation boundaries, the per-leaf
        numpy gather indices and the same indices on the pools'
        device."""
        if self._staged is not None:
            return self._staged
        mkey = (self.shape, tuple(leaf.uid for leaf in self.leaves))
        with _stage_lock:
            hit = _stage_memo.get(mkey)
            if hit is not None:
                _stage_memo[mkey] = _stage_memo.pop(mkey)  # LRU touch
        if hit is None:
            domains: list[np.ndarray] = []
            for i in range(len(self.shards)):
                keysets = [leaf.entries[i] for leaf in self.leaves]
                domains.append(_domain(self.shape, keysets))
            bounds = np.cumsum([0] + [len(d) for d in domains])
            total = int(bounds[-1])
            pad = _pow2(total) if total else 0
            idxs = _stage_indices(self.leaves, domains, pad)
            dev_idxs = [_to_device(ix, leaf.pool.device)
                        for ix, leaf in zip(idxs, self.leaves)]
            hit = (domains, bounds, total, idxs, dev_idxs)
            with _stage_lock:
                _stage_memo[mkey] = hit
                while len(_stage_memo) > _STAGE_MEMO_CAP:
                    _stage_memo.pop(next(iter(_stage_memo)))
        total, idxs = hit[2], hit[3]
        n_leaves = len(self.leaves)
        bump("container.containers_gathered", total * n_leaves)
        _bump_kind_gathers(idxs, total)
        bump("container.containers_skipped",
             n_leaves * (len(self.shards) * self.cpr - total))
        self._staged = hit
        return self._staged

    def _gathered(self, counts: bool) -> torch.Tensor | None:
        """ONE launch over the pooled operands; None when the root domain
        is empty everywhere (zero device work, one dispatch tick)."""
        _domains, _bounds, total, idxs, dev_idxs = self._stage()
        if total == 0:
            bump("container.empty_domains")
            bm.note_dispatch("fused_gather")
            return None
        if isinstance(idxs[0], tuple):
            return self._gathered_kinds(counts, idxs, dev_idxs, total)
        pools = [leaf.pool for leaf in self.leaves]
        if counts and self.shape == _AND_PAIR:
            # the north-star pair: K2 on CUDA pools; its wrapper answers
            # CPU pools with the plain version
            return cuda_kernels.gathered_count_and(pools[0], dev_idxs[0],
                                                   pools[1], dev_idxs[1])
        return expr.evaluate_gathered(self.shape, tuple(pools),
                                      tuple(dev_idxs), counts=counts)

    def _gathered_kinds(self, counts: bool, idxs: list, dev_idxs: list,
                        total: int) -> torch.Tensor:
        """The kinds launch (pilosa_tpu/ops/containers.py:567-630): the
        counts-root AND pair of two array rows, or of an array and a
        bitmap row, runs roaring's array arms over the compact rows; any
        other tree gathers every pool, decodes and folds
        (expr.evaluate_gathered_kinds).  Every arm computes the same
        container algebra."""
        if counts and self.shape == _AND_PAIR:
            # an AND domain is the key-set intersection, so every live
            # lane is present in both leaves: the lane kinds pick the arm
            kv0, kv1 = idxs[0][0][:total], idxs[1][0][:total]
            (l0, l1), (d0, d1) = self.leaves, dev_idxs
            if (kv0 == 2).all() and (kv1 == 2).all():
                bm.note_dispatch("fused_gather")
                return kp.gathered_count_array_array(
                    l0.apool, l0.acard, d0[1], l1.apool, l1.acard, d1[1])
            pair = None
            if (kv0 == 2).all() and (kv1 == 1).all():
                pair = (l0, d0, l1, d1)
            elif (kv0 == 1).all() and (kv1 == 2).all():
                pair = (l1, d1, l0, d0)
            if pair is not None:
                al, ad, bl, bd = pair
                bm.note_dispatch("fused_gather")
                return kp.gathered_count_array_bitmap(
                    al.apool, al.acard, ad[1], bl.pool, bd[0])
        leafops = []
        for leaf, (ib, ia, ir) in zip(self.leaves, dev_idxs):
            if leaf.has_kinds:
                leafops.append(("k", leaf.pool, leaf.apool, leaf.acard,
                                leaf.rpool, ib, ia, ir))
            else:
                # an all-bitmap leaf in a kinds query: ib already sends
                # absent lanes to the zero row
                leafops.append(("b", leaf.pool, ib))
        return expr.evaluate_gathered_kinds(self.shape, tuple(leafops),
                                            counts=counts)

    # ----------------------------------------------------------- execution

    def counts(self) -> list[int]:
        """Per-shard popcounts of the tree, aligned with ``shards``."""
        bump("container.queries")
        out = self._gathered(counts=True)
        bounds, total = self._staged[1], self._staged[2]
        if out is None:
            return [0] * len(self.shards)
        cts = out[:total].to("cpu").numpy().astype(np.int64)
        return [int(cts[bounds[i]:bounds[i + 1]].sum())
                for i in range(len(self.shards))]

    def row_words(self) -> list[tuple[int, np.ndarray]]:
        """Non-empty per-shard result words (uint32, host), scattered
        back to the dense row layout."""
        bump("container.queries")
        out = self._gathered(counts=False)
        if out is None:
            return []
        domains, bounds, total = self._staged[:3]
        res = bm.to_numpy(out[:total])
        partials: list[tuple[int, np.ndarray]] = []
        for i, s in enumerate(self.shards):
            dom = domains[i]
            if len(dom) == 0:
                continue
            blocks = res[int(bounds[i]):int(bounds[i + 1])]
            if not blocks.any():
                continue
            words = np.zeros(self.n_words, dtype=np.uint32)
            words.reshape(self.cpr, CWORDS)[dom] = blocks
            partials.append((s, words))
        return partials


def _walk(idx: Any, call: Any, leaves: list) -> tuple | None:
    """Shape + (field, row) leaf descriptors for a tree whose every leaf
    is a plain standard-view row -- the container-eligible grammar.
    None for anything else."""
    name = call.name
    if name == "Row":
        if call.condition_arg() is not None:
            return None
        if "from" in call.args or "to" in call.args:
            return None
        try:
            fname = call.field_arg()
        except ValueError:
            return None
        row_id = call.args.get(fname)
        if not isinstance(row_id, int) or isinstance(row_id, bool):
            return None
        f = idx.field(fname)
        if f is None or not f.has_standard_rows:
            return None
        leaves.append((f, row_id))
        return ("leaf", len(leaves) - 1)
    if name in ("Union", "Intersect", "Difference", "Xor"):
        op = {"Union": "or", "Intersect": "and",
              "Difference": "andnot", "Xor": "xor"}[name]
        kids = []
        for c in call.children:
            k = _walk(idx, c, leaves)
            if k is None:
                return None
            kids.append(k)
        if not kids:
            return None
        return (op, *kids)
    if name == "Not":
        if len(call.children) != 1:
            return None
        ef = idx.existence_field()
        if ef is None:
            return None
        leaves.append((ef, 0))
        exist = ("leaf", len(leaves) - 1)
        child = _walk(idx, call.children[0], leaves)
        if child is None:
            return None
        return ("not", exist, child)
    return None


def plan_fused(idx: Any, call: Any, shards: tuple, opt: Any = None,
               counts: bool = True) -> Plan | None:
    """Stage a fused read for compressed execution, or None to route the
    dense path.  All-or-nothing per query: every leaf row must be under
    the fill-ratio threshold in EVERY shard.  A bare-leaf tree without a
    Count root is declined (the dense path answers it as a zero-launch
    passthrough of the resident stack)."""
    if not _cfg.enabled or not shards:
        return None
    if opt is not None and not getattr(opt, "containers", True):
        return None
    leaf_descs: list = []
    shape = _walk(idx, call, leaf_descs)
    if shape is None or not leaf_descs:
        return None
    if not counts and shape[0] == "leaf":
        return None
    use_delta = opt is None or getattr(opt, "delta", True)
    for f, row_id in leaf_descs:
        if not use_delta:
            # ?nodelta=1: compact up front, then a pure base read
            f.flush_deltas(shards)
            continue
        for s in shards:
            fr = f.fragment(s)
            if fr is not None and fr._delta_row_seq(row_id):
                # a pending overlay on a queried row: the pools hold base
                # content, so the dense path fuses it (pilosa_tpu/ops/
                # containers.py:1106-1124)
                bump("container.fallbacks")
                return None
    leaves = []
    for f, row_id in leaf_descs:
        leaf = f.device_container_leaf(row_id, shards)
        if leaf.dense_slots():
            bump("container.fallbacks")
            return None
        leaves.append(leaf)
    return Plan(shape, leaves, shards, SHARD_WIDTH // CONTAINER_BITS,
                bm.n_words(SHARD_WIDTH))


# ------------------------------------------------------------- bitmap VM

#: Default ``[vm]`` knobs (pilosa_tpu/ops/containers.py:678-679): the
#: smallest padded domain a staged VM query rounds up to (an empty domain
#: still gets a real, all-zero-row batch slot), and the per-launch
#: directory budget in int32 entries (slots x batch x domain), a TPU
#: scalar-memory limit the port keeps so its launches match the
#: reference's: oversized batches split, oversized single queries decline
#: to the dense engines.
VM_MIN_DOMAIN = 8
VM_MAX_PREFETCH = 1 << 16


class VMStage:
    """One fused Count read staged for the bitmap VM: the shape, its
    compiled op-tape, the container leaves in slot order, the per-leaf
    LOCAL gather rows for the concatenated per-shard root domains (each
    int32[pad], absent containers and the pow2 tail pointing at the
    leaf's own zero row).  parallel/coalescer.py globalizes the rows
    against the bucket's megapool at flush."""

    __slots__ = ("shape", "tape", "leaves", "idxs", "pad")

    def __init__(self, shape: tuple, tape: Any, leaves: list,
                 idxs: list, pad: int) -> None:
        self.shape = shape
        self.tape = tape
        self.leaves = leaves
        self.idxs = idxs
        self.pad = pad


def stage_vm(idx: Any, call: Any, shards: tuple, use_delta: bool = True,
             max_tape: int | None = None, max_leaves: int | None = None,
             min_domain: int = VM_MIN_DOMAIN,
             max_prefetch: int | None = VM_MAX_PREFETCH) -> VMStage | None:
    """Stage one fused Count read for the bitmap VM, or None to route the
    dense engines -- all-or-nothing per query, like ``plan_fused``
    (pilosa_tpu/ops/containers.py:703-825), except that a pending ingest
    delta does not decline: a row's overlay stages as two more
    all-bitmap leaves (``Field.device_delta_container_leaves``) under a
    ``dfuse`` node, ``(base & ~clear) | set``, two tape instructions.
    The delta leaves are read BEFORE the base leaf, so a concurrent
    compaction can only make the overlay apply twice, which is
    idempotent.  ``use_delta=False`` (``?nodelta=1``) compacts each row's
    deltas first.  A leaf whose directory holds a kind byte above 3
    declines as ``kind_unsupported``.  Every decline bumps its
    ``vm.fallbacks.*`` reason."""
    from pilosa_tpu_torch.ops import tape as _tp

    if not _cfg.enabled or not shards:
        _tp.bump("vm.fallbacks.disabled")
        return None
    leaf_descs: list = []
    shape = _walk(idx, call, leaf_descs)
    if shape is None or not leaf_descs:
        _tp.bump("vm.fallbacks.ineligible_leaf")
        return None
    nodemap: dict = {}
    leaves: list[ContainerLeaf] = []
    for i, (f, row_id) in enumerate(leaf_descs):
        pair = None
        if use_delta:
            pair = f.device_delta_container_leaves(row_id, shards)
        else:
            f.flush_deltas(shards)
        leaf = f.device_container_leaf(row_id, shards)
        if leaf.dense_slots():
            bump("container.fallbacks")
            _tp.bump("vm.fallbacks.ineligible_leaf")
            return None
        if leaf.has_kinds and any(k is not None and len(k)
                                  and int(k.max()) > 3 for k in leaf.kinds):
            # a kind byte the VM has no decode for (directories may
            # carry later kinds)
            _tp.bump("vm.fallbacks.kind_unsupported")
            return None
        nodemap[i] = ("leaf", len(leaves))
        leaves.append(leaf)
        if pair is not None:
            nodemap[i] = ("dfuse", nodemap[i], ("leaf", len(leaves)),
                          ("leaf", len(leaves) + 1))
            leaves.extend(pair)

    def subst(node: tuple) -> tuple:
        if node[0] == "leaf":
            return nodemap[node[1]]
        return (node[0],) + tuple(subst(c) for c in node[1:])

    shape = subst(shape)
    if max_leaves is not None and len(leaves) > max_leaves:
        _tp.bump("tape.oversize_fallbacks")
        _tp.bump("vm.fallbacks.oversize")
        return None
    tp = _tp.try_compile(shape, len(leaves), max_tape)
    if tp is None:
        _tp.bump("vm.fallbacks.oversize")
        return None
    mkey = ("vm", shape, tuple(leaf.uid for leaf in leaves),
            int(min_domain))
    with _stage_lock:
        hit = _stage_memo.get(mkey)
        if hit is not None:
            _stage_memo[mkey] = _stage_memo.pop(mkey)  # LRU touch
    if hit is None:
        domains = [_domain(shape, [leaf.entries[i] for leaf in leaves])
                   for i in range(len(shards))]
        total = int(sum(len(d) for d in domains))
        pad = max(int(min_domain), _pow2(max(1, total)))
        hit = (total, pad, _stage_indices(leaves, domains, pad))
        with _stage_lock:
            _stage_memo[mkey] = hit
            while len(_stage_memo) > _STAGE_MEMO_CAP:
                _stage_memo.pop(next(iter(_stage_memo)))
    total, pad, idxs = hit
    if max_prefetch is not None and len(leaves) * pad > max_prefetch:
        # even unbatched, the directory would blow the per-launch budget;
        # when the plain pow2 pad would have fit, the min-domain floor
        # blew it -- its own reason
        if len(leaves) * _pow2(max(1, total)) <= max_prefetch:
            _tp.bump("vm.fallbacks.min_domain")
        else:
            _tp.bump("vm.fallbacks.max_prefetch")
        return None
    n_leaves = len(leaves)
    bump("container.containers_gathered", total * n_leaves)
    _bump_kind_gathers(idxs, total)
    bump("container.containers_skipped",
         n_leaves * (len(shards) * (SHARD_WIDTH // CONTAINER_BITS) - total))
    if total == 0:
        # the query still rides the batch (all-zero-row directory, count
        # 0): one launch either way
        bump("container.empty_domains")
    return VMStage(shape, tp, leaves, idxs, pad)


# Megapool memo: a VM bucket's distinct leaves concatenate into ONE pool
# (or one MegaPools bundle) the kernel gathers from.  Steady traffic
# flushes the same leaf sets again and again, and concatenating them per
# flush would copy hundreds of MiB on the card each time (three
# 8192-row leaves pad to a 32768-row, 256 MiB pool).  Keyed on the leaf
# uid tuple: uids change on every rebuild, so stale megapools stop being
# addressed and age out of the small LRU.
_mega_lock = threading.Lock()
_megapool_memo: dict = {}
_MEGAPOOL_MEMO_CAP = 8


def forget_leaves(uids) -> int:
    """Drop every staged-gather and megapool memo entry that holds one
    of the leaves ``uids``: a deleted field's pools must leave the card
    now, not when the LRUs age them out.  Returns the entries dropped."""
    uids = set(uids)
    if not uids:
        return 0

    # stage keys are (shape, uids) or ("vm", shape, uids, min_domain);
    # megapool keys are the uid tuple itself
    memos = ((_stage_lock, _stage_memo,
              lambda k: k[2] if k[0] == "vm" else k[1]),
             (_mega_lock, _megapool_memo, lambda k: k))
    n = 0
    for lock, memo, uids_of in memos:
        with lock:
            for key in [k for k in memo if uids.intersection(uids_of(k))]:
                del memo[key]
                n += 1
    return n


class MegaPools:
    """A VM bucket's per-kind megapools (pilosa_tpu/ops/containers.py:
    838): the bitmap rows plus the compact array and run pools whose
    decoded rows conceptually follow them -- one virtual dense pool the
    global gather index addresses (``[0, Rb)`` bitmap, ``[Rb, Rb + Ra)``
    array, ``[Rb + Ra, Rb + Ra + Rr)`` run).  K3-kinds decodes the
    compact rows as it gathers them, so no dense copy of the array and
    run rows exists on the card."""

    __slots__ = ("bpool", "apool", "acard", "rpool")

    def __init__(self, bpool: torch.Tensor, apool: torch.Tensor,
                 acard: torch.Tensor, rpool: torch.Tensor) -> None:
        self.bpool = bpool
        self.apool = apool
        self.acard = acard
        self.rpool = rpool


def megapool(leaves: list) -> tuple:
    """(pool, bases, zero_index) for a set of container leaves: the
    concatenated pool a VM bucket gathers from, each leaf's row offset
    keyed by uid, and the canonical all-zero row (the first leaf's own
    zero row).  The pool's row count pads to pow2 with zero rows, as the
    reference pads its device megapools (pilosa_tpu/ops/containers.py:
    875).  When any leaf carries array or run containers the pool is a
    ``MegaPools`` bundle and ``bases[uid]`` the leaf's (bitmap, array,
    run) offsets in the bundle's virtual row space."""
    order = sorted({leaf.uid: leaf for leaf in leaves}.values(),
                   key=lambda leaf: leaf.uid)
    key = tuple(leaf.uid for leaf in order)
    with _mega_lock:
        hit = _megapool_memo.get(key)
        if hit is not None:
            _megapool_memo[key] = _megapool_memo.pop(key)  # LRU touch
            return hit
    if any(leaf.has_kinds for leaf in order):
        hit = _megapool_kinds(order)
    else:
        hit = _megapool_plain(order)
    with _mega_lock:
        _megapool_memo[key] = hit
        while len(_megapool_memo) > _MEGAPOOL_MEMO_CAP:
            _megapool_memo.pop(next(iter(_megapool_memo)))
    return hit


def _megapool_plain(order: list) -> tuple:
    bases: dict = {}
    off = 0
    for leaf in order:
        bases[leaf.uid] = off
        off += int(leaf.pool.shape[0])
    zero_index = bases[order[0].uid] + order[0].n
    if len(order) == 1:
        return (order[0].pool, bases, zero_index)
    first = order[0].pool
    pool = torch.zeros((_pow2(off), CWORDS), dtype=first.dtype,
                       device=first.device)
    for leaf in order:
        base = bases[leaf.uid]
        pool[base:base + leaf.pool.shape[0]].copy_(leaf.pool)
    return (pool, bases, zero_index)


def _megapool_kinds(order: list) -> tuple:
    """Concatenate the leaves' kind pools into one MegaPools bundle
    (pilosa_tpu/ops/containers.py:931): array and run columns re-pad to
    the widest leaf's with the 0xFFFF pad and the invalid (1, 0) pair,
    which decode to nothing; each kind pool's row count pads to pow2; a
    leaf without a kind adds no rows to that pool."""
    dev = order[0].pool.device
    acap = max([int(leaf.apool.shape[1]) for leaf in order
                if leaf.apool is not None] or [1])
    rcap2 = max([int(leaf.rpool.shape[1]) for leaf in order
                 if leaf.rpool is not None] or [2])
    offs: dict = {}
    boff = aoff = roff = 0
    for leaf in order:
        offs[leaf.uid] = (boff, aoff, roff)
        boff += int(leaf.pool.shape[0])
        if leaf.apool is not None:
            aoff += int(leaf.apool.shape[0])
        if leaf.rpool is not None:
            roff += int(leaf.rpool.shape[0])
    rb, ra, rr = (_pow2(max(1, x)) for x in (boff, aoff, roff))
    bpool = torch.zeros((rb, CWORDS), dtype=torch.int32, device=dev)
    apool = torch.full((ra, acap), -1, dtype=torch.int16, device=dev)
    acard = torch.zeros(ra, dtype=torch.int32, device=dev)
    rpool = torch.zeros((rr, rcap2), dtype=torch.int16, device=dev)
    rpool[:, 0::2] = 1
    for leaf in order:
        b0, a0, r0 = offs[leaf.uid]
        bpool[b0:b0 + leaf.pool.shape[0]].copy_(leaf.pool)
        if leaf.apool is not None:
            rows, cols = leaf.apool.shape
            apool[a0:a0 + rows, :cols].copy_(leaf.apool)
            acard[a0:a0 + rows].copy_(leaf.acard)
        if leaf.rpool is not None:
            rows, cols = leaf.rpool.shape
            rpool[r0:r0 + rows, :cols].copy_(leaf.rpool)
    # bases address the virtual row space: bitmap rows first, then the
    # array rows, then the run rows
    bases = {uid: (b0, rb + a0, rb + ra + r0)
             for uid, (b0, a0, r0) in offs.items()}
    zero_index = offs[order[0].uid][0] + order[0].n
    return (MegaPools(bpool, apool, acard, rpool), bases, zero_index)
