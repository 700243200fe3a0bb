"""Compressed container-directory Count/Row engine on torch tensors.

Port of pilosa_tpu/ops/containers.py in its all-bitmap layout (the
reference's ``[containers] kinds=false``; array and run kinds are not
part of the port yet):

- **Layout** -- per row, the non-empty 2^16-bit containers (2048 words
  each) of every shard of the query concatenate into one word POOL on
  the card, driven by a host DIRECTORY (per shard: sorted container
  keys and the shard's base offset into the pool).  Pool rows pad to
  ``_pow2(n + 1)`` with the all-zero row at ``n``, the canonical absent
  container (models/field.py ``device_container_leaf``).
- **Execution** -- the ROOT's container-key domain per shard follows
  roaring's set rules (``_domain``); each leaf's gather indices map the
  concatenated domain into its pool (``_leaf_indices``), padded to a
  power of two.  The ``Count(Intersect(Row, Row))`` pair runs the CUDA
  kernel K2 (ops/cuda_kernels.gathered_count_and); every other tree
  gathers and folds in torch (ops/expr.evaluate_gathered).
- **Fallback** -- a leaf row whose fill ratio (bits / shard width)
  exceeds the ``[containers]`` threshold in any shard routes the whole
  query to the dense path, as does ``?nocontainers=1`` or
  ``configure(enabled=False)``.
- **Bitmap VM** -- ``stage_vm`` stages a coalesced Count the same way
  but keeps only each leaf's local gather rows; at flush the coalescer
  concatenates the bucket's leaves into one ``megapool`` and runs the
  whole heterogeneous batch as one launch of K3 (ops/tape.execute_vm).

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
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

#: 2^16 bits = 2048 32-bit words per container
CONTAINER_BITS = 1 << 16
CWORDS = CONTAINER_BITS // 32

DEFAULT_THRESHOLD = 0.25

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

    __slots__ = ("enabled", "threshold")

    def __init__(self) -> None:
        self.enabled = True
        self.threshold = DEFAULT_THRESHOLD


_cfg = ContainersRuntimeConfig()
_cfg_lock = threading.Lock()


def config() -> ContainersRuntimeConfig:
    return _cfg


def configure(enabled: bool | None = None,
              threshold: float | None = None) -> ContainersRuntimeConfig:
    """Apply [containers] config in place -- only explicit values land."""
    with _cfg_lock:
        if enabled is not None:
            _cfg.enabled = bool(enabled)
        if threshold is not None:
            _cfg.threshold = float(threshold)
    return _cfg


def reset() -> ContainersRuntimeConfig:
    """Restore the defaults (tests)."""
    global _cfg
    with _cfg_lock:
        _cfg = ContainersRuntimeConfig()
    return _cfg


# ---------------------------------------------------------------- counters

_lock = threading.Lock()
_counters = {
    "container.queries": 0,             # fused reads served compressed
    "container.fallbacks": 0,           # eligible trees routed dense
    "container.containers_gathered": 0,  # domain containers launched
    "container.containers_skipped": 0,   # containers never touched
    "container.empty_domains": 0,       # whole-query zero-work answers
}


def bump(name: str, value: int = 1) -> None:
    with _lock:
        _counters[name] += value


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


# -------------------------------------------------------------- leaf pooling

_LEAF_UID = itertools.count(1)


class ContainerLeaf:
    """One expression leaf (a standard-view row across the query's
    shard set) in pooled compressed form.

    ``entries[i]`` describes shard ``shards[i]``: ``None`` for a hot
    fragment row (dense fallback evidence), else a sorted int64 array of
    the row's non-empty container keys (possibly empty).  ``starts[i]``
    is the shard's base offset into ``pool``, an int32[P, CWORDS] tensor
    whose rows ``[n:]`` are zero -- gather index ``n`` is the canonical
    absent container."""

    __slots__ = ("shards", "entries", "starts", "pool", "n", "nbytes",
                 "uid")

    def __init__(self, shards: tuple, entries: list, starts: list,
                 pool: torch.Tensor, n: int, nbytes: int) -> None:
        self.shards = shards
        self.entries = entries
        self.starts = starts
        self.pool = pool
        self.n = n
        self.nbytes = nbytes
        # identity for the staging memo: a rebuilt leaf is a new object
        # with a fresh uid, so stale staged gathers are never addressed
        self.uid = next(_LEAF_UID)

    def dense_slots(self) -> list[int]:
        """Shard positions whose fragment row is too hot to compress."""
        return [i for i, e in enumerate(self.entries) if e is None]


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


# Staged-gather memo: (shape, leaf uids) -> (domains, bounds, total, idxs,
# device idxs).  Leaf uids change on every rebuild, so stale entries stop
# being addressed; the cap bounds memory.
_stage_lock = threading.Lock()
_stage_memo: dict = {}
_STAGE_MEMO_CAP = 256


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
            idxs = [_leaf_indices(leaf, domains, pad)
                    for leaf in self.leaves]
            dev_idxs = [torch.from_numpy(ix).to(leaf.pool.device)
                        for ix, leaf in zip(idxs, self.leaves)]
            hit = (domains, bounds, total, idxs, dev_idxs)
            with _stage_lock:
                _stage_memo[mkey] = hit
                while len(_stage_memo) > _STAGE_MEMO_CAP:
                    _stage_memo.pop(next(iter(_stage_memo)))
        total = hit[2]
        n_leaves = len(self.leaves)
        bump("container.containers_gathered", total * n_leaves)
        bump("container.containers_skipped",
             n_leaves * (len(self.shards) * self.cpr - total))
        self._staged = hit
        return self._staged

    def _gathered(self, counts: bool) -> torch.Tensor | None:
        """ONE launch over the pooled operands; None when the root domain
        is empty everywhere (zero device work, one dispatch tick)."""
        _domains, _bounds, total, _idxs, dev_idxs = self._stage()
        if total == 0:
            bump("container.empty_domains")
            bm.note_dispatch("fused_gather")
            return None
        pools = [leaf.pool for leaf in self.leaves]
        if counts and self.shape == _AND_PAIR:
            # the north-star pair: K2 on CUDA pools; its wrapper answers
            # CPU pools with the plain version
            return cuda_kernels.gathered_count_and(pools[0], dev_idxs[0],
                                                   pools[1], dev_idxs[1])
        return expr.evaluate_gathered(self.shape, tuple(pools),
                                      tuple(dev_idxs), counts=counts)

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


def stage_vm(idx: Any, call: Any, shards: tuple,
             max_tape: int | None = None, max_leaves: int | None = None,
             min_domain: int = VM_MIN_DOMAIN,
             max_prefetch: int | None = VM_MAX_PREFETCH) -> VMStage | None:
    """Stage one fused Count read for the bitmap VM, or None to route the
    dense engines -- all-or-nothing per query, like ``plan_fused``
    (pilosa_tpu/ops/containers.py:703, without its delta and kind
    branches: the port has neither delta planes nor container kinds).
    Every decline bumps its ``vm.fallbacks.*`` reason."""
    from pilosa_tpu_torch.ops import tape as _tp

    if not _cfg.enabled or not shards:
        _tp.bump("vm.fallbacks.disabled")
        return None
    leaf_descs: list = []
    shape = _walk(idx, call, leaf_descs)
    if shape is None or not leaf_descs:
        _tp.bump("vm.fallbacks.ineligible_leaf")
        return None
    leaves: list[ContainerLeaf] = []
    for f, row_id in leaf_descs:
        leaf = f.device_container_leaf(row_id, shards)
        if leaf.dense_slots():
            bump("container.fallbacks")
            _tp.bump("vm.fallbacks.ineligible_leaf")
            return None
        leaves.append(leaf)
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
        hit = (total, pad, [_leaf_indices(leaf, domains, pad)
                            for leaf in leaves])
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
    bump("container.containers_skipped",
         n_leaves * (len(shards) * (SHARD_WIDTH // CONTAINER_BITS) - total))
    if total == 0:
        # the query still rides the batch (all-zero-row directory, count
        # 0): one launch either way
        bump("container.empty_domains")
    return VMStage(shape, tp, leaves, idxs, pad)


# Megapool memo: a VM bucket's distinct leaves concatenate into ONE word
# pool the kernel gathers from.  Steady traffic flushes the same leaf sets
# again and again, and concatenating them per flush would copy hundreds of
# MiB on the card each time (three 8192-row leaves pad to a 32768-row,
# 256 MiB pool).  Keyed on the leaf uid tuple: uids change on every
# rebuild, so stale megapools stop being addressed and age out of the
# small LRU.
_mega_lock = threading.Lock()
_megapool_memo: dict = {}
_MEGAPOOL_MEMO_CAP = 8


def megapool(leaves: list) -> tuple:
    """(pool, bases, zero_index) for a set of container leaves: the
    concatenated word pool a VM bucket gathers from, each leaf's row
    offset keyed by uid, and the canonical all-zero row (the first
    leaf's own zero row).  The pool's row count pads to pow2 with zero
    rows, as the reference pads its device megapools
    (pilosa_tpu/ops/containers.py:875)."""
    order = sorted({leaf.uid: leaf for leaf in leaves}.values(),
                   key=lambda leaf: leaf.uid)
    key = tuple(leaf.uid for leaf in order)
    with _mega_lock:
        hit = _megapool_memo.get(key)
        if hit is not None:
            _megapool_memo[key] = _megapool_memo.pop(key)  # LRU touch
            return hit
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
