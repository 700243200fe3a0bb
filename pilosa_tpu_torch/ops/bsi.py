"""Bit-sliced index (BSI) compare and aggregates on torch tensors.

Port of pilosa_tpu/ops/bsi.py.  An int field keeps, per shard, the bit
planes of its base-relative values as rows of one matrix (reference
encoding, fragment.go:91-93): row 0 exists, row 1 sign, rows 2.. the
magnitude bits, least significant first.  Here a fragment's planes are an
int32 [2 + depth, W] tensor and a shard set's are one [S, 2 + depth, W]
stack; every function takes either and works on the whole stack at once,
with no per-shard loop: one ``compare`` is one launch of the CUDA kernel
K6 over all shards.

- ``compare`` -- the ripple, K6 on CUDA tensors
  (ops/cuda_kernels.bsi_compare), its plain version on CPU tensors;
- ``plane_counts`` / ``plane_counts_stacked`` -- Sum's per-plane counts,
  two launches of K4 (ops/cuda_kernels.row_counts_masked with a filter
  index) over the stack viewed as rows, with no copy of it;
- ``extreme_max`` / ``extreme_min`` / ``extremes_stacked`` -- Min and
  Max, plain torch as they are XLA in the reference, each plane's test
  kept on the device (``torch.where``), with no host read per plane;
- ``range_words`` / ``between_words`` -- ``Row(v > x)`` and friends.

Predicate magnitudes arrive as two 32-bit limbs (``split_predicate``), so
depths up to 63 work.  The reference's deliberate divergence from Go at
``predicate == -1`` (range_words) is kept as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import cuda_kernels as ck

EXISTS_PLANE = 0
SIGN_PLANE = 1
OFFSET_PLANE = 2

# Maximum supported bit depth: magnitudes are int64-range, as in the
# reference (bsiGroup values are int64, field.go:1563).
MAX_BIT_DEPTH = 63


def split_predicate(upred: int) -> tuple[np.uint32, np.uint32]:
    """Split a non-negative magnitude into two uint32 limbs."""
    if upred < 0:
        raise ValueError("magnitude must be non-negative")
    if upred >= (1 << 64):
        raise ValueError(f"magnitude {upred} exceeds 64-bit kernel range")
    return np.uint32(upred & 0xFFFFFFFF), np.uint32((upred >> 32) & 0xFFFFFFFF)


def _depth(P: torch.Tensor) -> int:
    return P.shape[-2] - OFFSET_PLANE


def compare(P: torch.Tensor, filt: torch.Tensor, lo, hi
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass down the planes -> (lt, eq) masks within ``filt``: the
    columns whose magnitude is below / equal to the predicate ``lo |
    hi << 32`` (its low ``depth`` bits).  Callers derive every
    comparison: LTE = lt|eq, GT = filt & ~(lt|eq), GTE = filt & ~lt, EQ =
    eq, NEQ = exists & ~eq.  ``P`` [S, planes, W] with ``filt`` [S, W],
    or one fragment's [planes, W] with [W]."""
    bm.note_dispatch("bsi_compare")
    upred = int(lo) | (int(hi) << 32)
    lt, gt = ck.bsi_compare(P, filt.contiguous(), upred, _depth(P))
    return lt, filt & ~lt & ~gt


# ---------------------------------------------------------------- Sum


def sign_plane_counts(P: torch.Tensor, consider: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, neg) int32 [S, depth]: per shard and magnitude plane, the
    counts of its bits among the considered non-negative / negative
    columns.  The stack's rows (all planes of all shards) are one K4
    matrix with no copy; row ``s * planes + p`` takes filter row ``s``
    (positives) in the first launch and ``S + s`` (negatives) in the
    second.  The exists and sign rows are counted too and dropped."""
    bm.note_dispatch("plane_counts")
    S, nplanes, W = P.shape
    sign = P[:, SIGN_PLANE]
    filt = torch.cat([consider & ~sign, consider & sign]).contiguous()
    mat = P.reshape(S * nplanes, W)
    idx = torch.arange(S, dtype=torch.int32, device=P.device
                       ).repeat_interleave(nplanes)
    pos = ck.row_counts_masked(mat, filt, idx)
    neg = ck.row_counts_masked(mat, filt, idx + S)
    return (pos.view(S, nplanes)[:, OFFSET_PLANE:],
            neg.view(S, nplanes)[:, OFFSET_PLANE:])


def plane_counts(P: torch.Tensor, consider: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-plane intersection counts of one fragment's planes, split by
    sign -> (pos, neg) int32[depth].  Sum = sum_i (1<<i) * (pos_i -
    neg_i), assembled with exact Python ints (reference fragment.sum,
    fragment.go:1111-1143)."""
    pos, neg = sign_plane_counts(P.unsqueeze(0), consider.unsqueeze(0))
    return pos[0], neg[0]


def plane_counts_stacked(P: torch.Tensor, consider: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Batched plane counts over a [S, planes, W] stack -> (pos int32[S,
    depth], neg int32[S, depth], count int32[S]), ``count`` the
    per-shard popcount of ``consider`` (a plain torch row count).
    Per-shard counts stay below 2^31, so int32 is exact; callers sum
    across shards in Python ints."""
    pos, neg = sign_plane_counts(P, consider)
    return pos, neg, bm.row_counts_plain(consider)


# ------------------------------------------------------------ Min, Max


def _any(words: torch.Tensor) -> torch.Tensor:
    """Per-row "any bit set" of [S, W] words -> bool [S]."""
    return (words != 0).any(dim=-1)


def _extreme_max_stacked(P: torch.Tensor, filt: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned max under ``filt`` per shard -> (taken int32[S, depth],
    count int32[S]) (reference maxUnsigned, fragment.go:1215-1230):
    keep the columns holding plane i when any does."""
    depth = _depth(P)
    taken = torch.zeros((P.shape[0], depth), dtype=torch.int32,
                        device=P.device)
    for i in range(depth - 1, -1, -1):
        row = P[:, OFFSET_PLANE + i] & filt
        has = _any(row)
        taken[:, i] = has.to(torch.int32)
        filt = torch.where(has.unsqueeze(-1), row, filt)
    return taken, bm.row_counts_plain(filt)


def _extreme_min_stacked(P: torch.Tensor, filt: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned min under ``filt`` per shard (reference minUnsigned,
    fragment.go:1173): drop plane i's columns when some column lacks
    it."""
    depth = _depth(P)
    taken = torch.zeros((P.shape[0], depth), dtype=torch.int32,
                        device=P.device)
    for i in range(depth - 1, -1, -1):
        without = filt & ~P[:, OFFSET_PLANE + i]
        keep_zero = _any(without)
        taken[:, i] = (~keep_zero).to(torch.int32)
        filt = torch.where(keep_zero.unsqueeze(-1), without, filt)
    return taken, bm.row_counts_plain(filt)


def extreme_max(P: torch.Tensor, filt: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fragment's unsigned max under ``filt`` -> (taken int32[depth],
    count int32): taken[i] = 1 when the max has bit i set, count = the
    columns holding it."""
    taken, count = _extreme_max_stacked(P.unsqueeze(0), filt.unsqueeze(0))
    return taken[0], count[0]


def extreme_min(P: torch.Tensor, filt: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fragment's unsigned min under ``filt`` (see extreme_max)."""
    taken, count = _extreme_min_stacked(P.unsqueeze(0), filt.unsqueeze(0))
    return taken[0], count[0]


def extremes_stacked(P: torch.Tensor, consider: torch.Tensor, want: str
                     ) -> tuple:
    """Batched Min/Max scan over a [S, planes, W] stack -> (signed_cnt,
    all_cnt int32[S], primary_taken, fallback_taken int32[S, depth],
    primary_n, fallback_n int32[S]).  ``want`` "min" scans the negative
    magnitudes' max and every magnitude's min, "max" the non-negative
    magnitudes' max and every magnitude's min; the host applies
    fragment.min/max's sign branching (fragment.go:1147/1191) per
    shard."""
    sign = P[:, SIGN_PLANE]
    selected = consider & sign if want == "min" else consider & ~sign
    signed_cnt = bm.row_counts_plain(selected)
    all_cnt = bm.row_counts_plain(consider)
    primary_taken, primary_n = _extreme_max_stacked(P, selected)
    fallback_taken, fallback_n = _extreme_min_stacked(P, consider)
    return (signed_cnt, all_cnt, primary_taken, fallback_taken,
            primary_n, fallback_n)


# ------------------------------------------------------------ range rows


def range_words(P: torch.Tensor, op: str, predicate: int) -> torch.Tensor:
    """BSI comparison over a plane stack ([planes, W] or [S, planes, W])
    -> words ([W] or [S, W]) (the pure core of fragment.rangeOp,
    fragment.go:1273).

    Sign dispatch: predicate >= 0 -> compare magnitudes among positives
    (negatives are all smaller); predicate < 0 -> compare among
    negatives with the order inverted.  NOTE: deliberate divergence from
    the reference, kept from pilosa_tpu/ops/bsi.py -- its rangeLT/
    rangeGT route `predicate == -1 && !allowEquality` through the
    positive branch with upredicate=1 (fragment.go:1343,1412), which
    drops 0/±1 columns from `> -1` and adds 0-columns to `< -1`; that
    edge is untested upstream, so we use correct integer semantics
    instead."""
    exists = P[..., EXISTS_PLANE, :]
    sign = P[..., SIGN_PLANE, :]
    upred = -predicate if predicate < 0 else predicate
    lo, hi = split_predicate(upred)

    def u_lt(filt, allow_eq):
        lt, eq = compare(P, filt, lo, hi)
        return lt | eq if allow_eq else lt

    def u_gt(filt, allow_eq):
        lt, eq = compare(P, filt, lo, hi)
        gt = filt & ~lt & ~eq
        return gt | eq if allow_eq else gt

    if op == "==":
        base = exists & sign if predicate < 0 else exists & ~sign
        _, eq = compare(P, base, lo, hi)
        return eq
    if op == "!=":
        base = exists & sign if predicate < 0 else exists & ~sign
        _, eq = compare(P, base, lo, hi)
        return exists & ~eq
    if op in ("<", "<="):
        allow_eq = op == "<="
        if predicate >= 0:
            return (exists & sign) | u_lt(exists & ~sign, allow_eq)
        return u_gt(exists & sign, allow_eq)
    if op in (">", ">="):
        allow_eq = op == ">="
        if predicate >= 0:
            return u_gt(exists & ~sign, allow_eq)
        return (exists & ~sign) | u_lt(exists & sign, allow_eq)
    raise ValueError(f"invalid range operation: {op}")


def between_words(P: torch.Tensor, pred_min: int, pred_max: int
                  ) -> torch.Tensor:
    """BSI between [min, max] inclusive over a plane stack (the pure core
    of fragment.rangeBetween, fragment.go:1465).  A range of one sign is
    two compares of one consider row; a range across zero one compare
    among the non-negatives and one among the negatives."""
    exists = P[..., EXISTS_PLANE, :]
    sign = P[..., SIGN_PLANE, :]

    def u_between(filt, ulo, uhi):
        lo1, hi1 = split_predicate(ulo)
        lo2, hi2 = split_predicate(uhi)
        lt1, _ = compare(P, filt, lo1, hi1)
        lt2, eq2 = compare(P, filt, lo2, hi2)
        return (filt & ~lt1) & (lt2 | eq2)

    if pred_min >= 0:
        return u_between(exists & ~sign, pred_min, pred_max)
    if pred_max < 0:
        return u_between(exists & sign, -pred_max, -pred_min)
    lo2, hi2 = split_predicate(pred_max)
    lt2, eq2 = compare(P, exists & ~sign, lo2, hi2)
    pos = lt2 | eq2
    lo1, hi1 = split_predicate(-pred_min)
    lt1, eq1 = compare(P, exists & sign, lo1, hi1)
    neg = lt1 | eq1
    return pos | neg


def assemble_value(taken) -> int:
    """Host: fold per-bit takes into an exact Python int magnitude."""
    v = 0
    for i, t in enumerate(np.asarray(taken)):
        if int(t):
            v |= 1 << i
    return v
