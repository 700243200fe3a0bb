"""A whole bitmap call tree evaluated over its leaf stacks.

Port of pilosa_tpu/ops/expr.py.  A tree SHAPE is a hashable nested
tuple whose leaves are slot indices into the operand tuple:

    ("leaf", i)                           operand slot i
    ("and"|"or"|"xor"|"andnot", c, ...)   left-fold over children
    ("not", ("leaf", i_exist), child)     exist & ~child
    ("dfuse", child, set_c, clear_c)      (child & ~clear) | set
    ("shift", n, child)                   every bit n columns up

``dfuse`` is the streaming-ingest delta fusion (pilosa_tpu_torch.ingest):
the child is a base row stack, the set and clear leaves a fragment delta
plane's overlays (pilosa_tpu/ops/expr.py:20-25).  ``shift`` moves each
row's bits up by a static ``n`` and drops them at the shard edge
(``bm.shift_words``); it is not tape-eligible, so a shift-carrying Count
runs this dense program.

``evaluate(shape, leaves)`` returns the int32 word stack,
``evaluate(shape, leaves, counts=True)`` the int32 per-row popcounts
(the per-shard Count root).  ``evaluate_gathered`` is the container-pool
variant: each leaf is gathered from its pool first;
``evaluate_gathered_kinds`` the kind-split one, whose leaves gather
bitmap, array and run rows and decode them (ops/kindpools.py).  The
tree is plain torch bitwise ops plus the plain popcount; each evaluate
ticks one ``note_dispatch``, like the reference's one-launch program.

``_host_tree`` / ``_host_counts`` are the numpy engine, copied from the
reference (pilosa_tpu/ops/expr.py:503,530).
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import kindpools as kp

_FOLD_NAMES = ("and", "or", "xor", "andnot")


def _validate(shape: tuple, n_leaves: int) -> None:
    kind = shape[0]
    if kind == "leaf":
        if not 0 <= shape[1] < n_leaves:
            raise ValueError(f"leaf slot {shape[1]} out of range")
        return
    if kind in _FOLD_NAMES:
        if len(shape) < 2:
            raise ValueError(f"{kind} needs at least one child")
        for c in shape[1:]:
            _validate(c, n_leaves)
        return
    if kind == "not":
        _validate(shape[1], n_leaves)
        _validate(shape[2], n_leaves)
        return
    if kind == "dfuse":
        if len(shape) != 4:
            raise ValueError("dfuse needs (child, set, clear)")
        for c in shape[1:]:
            _validate(c, n_leaves)
        return
    if kind == "shift":
        if shape[1] < 0:
            raise ValueError("shift distance must be non-negative")
        _validate(shape[2], n_leaves)
        return
    raise ValueError(f"unknown expression node: {kind!r}")


_TORCH_FOLD = {
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
    "andnot": lambda a, b: a & ~b,
}


def _build(shape: tuple) -> Callable[[tuple], torch.Tensor]:
    """shape -> closure(leaves_tuple) -> int32 tensor."""
    kind = shape[0]
    if kind == "leaf":
        i = shape[1]
        return lambda leaves: leaves[i]
    if kind in _FOLD_NAMES:
        kids = [_build(c) for c in shape[1:]]
        fold = _TORCH_FOLD[kind]

        def ev(leaves: tuple) -> torch.Tensor:
            out = kids[0](leaves)
            for k in kids[1:]:
                out = fold(out, k(leaves))
            return out

        return ev
    if kind == "dfuse":
        kid, dset, dclear = (_build(c) for c in shape[1:])
        return lambda leaves: (kid(leaves) & ~dclear(leaves)) | dset(leaves)
    if kind == "shift":
        n, kid = shape[1], _build(shape[2])
        return lambda leaves: bm.shift_words(kid(leaves), n)
    exist = _build(shape[1])
    kid = _build(shape[2])
    return lambda leaves: exist(leaves) & ~kid(leaves)


# ----------------------------------------------------------- host engine


def _host_tree(shape: tuple, leaves: tuple) -> np.ndarray:
    kind = shape[0]
    if kind == "leaf":
        return leaves[shape[1]]
    if kind in _FOLD_NAMES:
        fold = {
            "and": np.bitwise_and,
            "or": np.bitwise_or,
            "xor": np.bitwise_xor,
            "andnot": lambda a, b: np.bitwise_and(a, np.bitwise_not(b)),
        }[kind]
        out = _host_tree(shape[1], leaves)
        for c in shape[2:]:
            out = fold(out, _host_tree(c, leaves))
        return out
    if kind == "shift":
        return _host_shift(_host_tree(shape[2], leaves), shape[1])
    if kind == "dfuse":
        return np.bitwise_or(
            np.bitwise_and(_host_tree(shape[1], leaves),
                           np.bitwise_not(_host_tree(shape[3], leaves))),
            _host_tree(shape[2], leaves))
    return np.bitwise_and(_host_tree(shape[1], leaves),
                          np.bitwise_not(_host_tree(shape[2], leaves)))


def _host_shift(a: np.ndarray, n: int) -> np.ndarray:
    """numpy twin of ``bm.shift_words`` over uint32 words
    (pilosa_tpu/ops/bitmap.py:313)."""
    if n == 0:
        return a
    w, s = n // bm.WORD_BITS, n % bm.WORD_BITS
    nw = a.shape[-1]
    if w >= nw:
        return np.zeros_like(a)
    pad = [(0, 0)] * (a.ndim - 1)
    shifted = np.pad(a, pad + [(w, 0)])[..., :nw]
    if s == 0:
        return shifted
    prev = np.pad(shifted, pad + [(1, 0)])[..., :nw]
    return (shifted << np.uint32(s)) | (prev >> np.uint32(bm.WORD_BITS - s))


def _host_counts(shape: tuple, leaves: tuple) -> np.ndarray:
    return np.bitwise_count(_host_tree(shape, leaves)).sum(
        axis=-1, dtype=np.int64)


# -------------------------------------------------------------- frontend


def evaluate(shape: tuple, leaves: tuple, counts: bool = False
             ) -> torch.Tensor:
    """Evaluate one tree over its leaf stacks (all the same shape,
    [S, W]).  Returns the result word stack, or int32 per-row counts
    with ``counts=True``.  A bare leaf without a Count root is returned
    as is, with no launch."""
    _validate(shape, len(leaves))
    if shape[0] == "leaf" and not counts:
        return leaves[shape[1]]
    bm.note_dispatch("fused_expr")
    out = _build(shape)(leaves)
    return bm.row_counts_plain(out) if counts else out


def evaluate_gathered(shape: tuple, pools: tuple, idxs: tuple,
                      counts: bool = False) -> torch.Tensor:
    """Evaluate one tree over POOLED container operands: leaf ``i`` is
    ``pools[i]`` (int32[P_i, 2048], rows past the directory's count all
    zero) gathered at ``idxs[i]`` (int32[D], clipped).  Returns the
    int32[D, 2048] result blocks, or int32[D] per-container popcounts
    with ``counts=True``."""
    _validate(shape, len(pools))
    bm.note_dispatch("fused_gather")
    leaves = tuple(bm.gather_rows(p, ix) for p, ix in zip(pools, idxs))
    out = _build(shape)(leaves)
    return bm.row_counts_plain(out) if counts else out


def evaluate_gathered_kinds(shape: tuple, leafops: tuple,
                            counts: bool = False) -> torch.Tensor:
    """Evaluate one tree over KIND-SPLIT container operands
    (pilosa_tpu/ops/expr.py:676).  ``leafops[i]`` is ``("b", pool, ib)``
    -- an all-bitmap leaf, gathered as in ``evaluate_gathered`` -- or
    ``("k", bpool, apool, acard, rpool, ib, ia, ir)``, a kind-split leaf
    whose three index vectors point at the lane's row in its own kind's
    pool and at the other pools' empty rows, so gathering, decoding and
    OR-ing rebuild the lane's block.  It is XLA in the reference; here
    plain torch with the plain decode."""
    _validate(shape, len(leafops))
    bm.note_dispatch("fused_gather")
    leaves = []
    for op in leafops:
        if op[0] == "b":
            _, pool, ib = op
            leaves.append(bm.gather_rows(pool, ib))
            continue
        _, bpool, apool, acard, rpool, ib, ia, ir = op
        ia = ia.to(apool.device).to(torch.int64)
        ir = ir.to(rpool.device).to(torch.int64)
        leaves.append(bm.gather_rows(bpool, ib)
                      | kp.decode_array(apool.index_select(0, ia),
                                        acard.index_select(0, ia))
                      | kp.decode_runs(rpool.index_select(0, ir)))
    out = _build(shape)(tuple(leaves))
    return bm.row_counts_plain(out) if counts else out
