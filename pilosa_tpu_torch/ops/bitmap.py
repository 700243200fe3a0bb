"""Packed-bitmap set algebra and popcounts on torch tensors.

Port of pilosa_tpu/ops/bitmap.py.  A bitmap over ``nbits`` columns is an
``int32[nbits // 32]`` tensor that is a bit-for-bit view of the
reference's ``uint32`` words: bit for column ``c`` lives in word
``c // 32`` at position ``c % 32`` (LSB first).  Words cross the numpy
boundary with ``ndarray.view(np.int32)`` / ``.view(np.uint32)``.

Two traps of that layout, both handled here and nowhere else:

- bit 31 makes an int32 word negative, so a word is tested with ``!= 0``
  and never ``> 0``;
- torch has no popcount op, and ``>>`` on int32 is arithmetic.  The
  plain popcount widens to int64, masks to the low 32 bits and runs the
  SWAR reduction there, where no shift can drag a sign bit in.

Every public op ticks ``note_dispatch`` once, with the reference's
launch names, so the launch-count accounting of ``dispatch_counter``
holds across both packages.

The TopN and GroupBy scans (``row_counts_masked``, ``row_counts_gathered``,
``masked_matrix_counts``) and the intersection count ``popcount_and`` go
through the CUDA kernels K4, K5 and K1 of ops/cuda_kernels.py, which
launch on CUDA tensors and compute the plain versions (``*_plain``) on
CPU tensors.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

WORD_BITS = 32

# ---------------------------------------------------------------------------
# Dispatch accounting: thread-local launch log (pilosa_tpu/ops/bitmap.py:52-94)
# ---------------------------------------------------------------------------

_dispatch = threading.local()  # .log: list[str] while a counter is active


def note_dispatch(name: str) -> None:
    """Record one launch on this thread (no-op unless a dispatch_counter
    is active on it)."""
    log = getattr(_dispatch, "log", None)
    if log is not None:
        log.append(name)


class dispatch_counter:
    """Context manager counting launches on the CURRENT thread.  Nested
    counters stack (the inner one shadows)."""

    def __enter__(self):
        self._prev = getattr(_dispatch, "log", None)
        self.launches: list[str] = []
        _dispatch.log = self.launches
        return self

    def __exit__(self, *exc):
        _dispatch.log = self._prev
        return False

    @property
    def n(self) -> int:
        return len(self.launches)


def n_words(nbits: int) -> int:
    """Number of 32-bit words for a bitmap of ``nbits`` columns."""
    if nbits % WORD_BITS != 0:
        raise ValueError(f"nbits must be a multiple of {WORD_BITS}, got {nbits}")
    return nbits // WORD_BITS


# ---------------------------------------------------------------------------
# Host helpers (numpy; pilosa_tpu/ops/bitmap.py:145-165)
# ---------------------------------------------------------------------------


def group_indices(keys: np.ndarray) -> dict:
    """Group index positions 0..n-1 by ``keys[i]`` -> {int(key): ndarray
    of indices}, via one stable argsort + split."""
    if not len(keys):
        return {}
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    bounds = np.flatnonzero(np.diff(ks)) + 1
    firsts = ks[np.concatenate(([0], bounds))]
    return {int(k): chunk
            for k, chunk in zip(firsts, np.split(order, bounds))}


def unpack_positions(words: np.ndarray) -> np.ndarray:
    """uint32 words -> sorted int64 set-bit positions (host)."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)


# ---------------------------------------------------------------------------
# numpy <-> torch word views
# ---------------------------------------------------------------------------


def to_tensor(words: np.ndarray, device: torch.device | str = "cpu"
              ) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor (same bits) on ``device``."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy words (same bits, host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Plain popcount
# ---------------------------------------------------------------------------

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_LOW32 = 0xFFFFFFFF


def popcount_elems(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts (int64, same shape) of int32 words.
    SWAR over the zero-extended int64 value: every shift is followed by
    a mask, and the widening keeps bit 31 from sign-extending."""
    v = x.to(torch.int64) & _LOW32
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * 0x01010101) & _LOW32) >> 24


def row_counts_plain(mat: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts over the last axis -> int32 (one row holds at
    most 2^20 bits here, far below 2^31)."""
    return popcount_elems(mat).sum(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Set algebra
# ---------------------------------------------------------------------------


def b_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersect."""
    note_dispatch("b_and")
    return a & b


def b_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union."""
    note_dispatch("b_or")
    return a | b


def b_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric difference."""
    note_dispatch("b_xor")
    return a ^ b


def b_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference a \\ b."""
    note_dispatch("b_andnot")
    return a & ~b


def b_not(a: torch.Tensor, existence: torch.Tensor) -> torch.Tensor:
    """Complement of ``a`` within the existence mask."""
    note_dispatch("b_not")
    return ~a & existence


def shift_words(a: torch.Tensor, n: int) -> torch.Tensor:
    """The one shift body (pilosa_tpu/ops/bitmap.py:313): every bit moves
    ``n`` columns up along the last axis and drops at the shard edge.
    The bits carried into a word from the one below are masked after
    the arithmetic ``>>``, so a sign bit never smears."""
    if n == 0:
        return a
    w, s = n // WORD_BITS, n % WORD_BITS
    nw = a.shape[-1]
    if w >= nw:
        return torch.zeros_like(a)
    # words move up by w: out_word[i] = a[i - w]
    shifted = torch.nn.functional.pad(a, (w, 0))[..., :nw]
    if s == 0:
        return shifted
    prev = torch.nn.functional.pad(shifted, (1, 0))[..., :nw]
    carry = (prev >> (WORD_BITS - s)) & ((1 << s) - 1)
    return (shifted << s) | carry


def b_shift(a: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Shift all bits toward higher columns by ``n`` (roaring.Shift); bits
    past the shard width drop, as in per-shard Shift execution."""
    if n < 0:
        raise ValueError("shift distance must be non-negative")
    note_dispatch("b_shift")
    return shift_words(a, n)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


def popcount(a: torch.Tensor) -> int:
    """Total set bits."""
    note_dispatch("popcount")
    return int(popcount_elems(a).sum())


def popcount_and(a: torch.Tensor, b: torch.Tensor) -> int:
    """|a & b| of two equal-shaped word tensors (rows may be strided):
    the CUDA kernel K1 on the card, as the reference's ``count_and``
    takes Pallas on a TPU, its plain version on the CPU."""
    from pilosa_tpu_torch.ops import cuda_kernels as ck

    note_dispatch("popcount_and")
    return ck.count_and(a, b)


def row_counts(mat: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts of a [rows, words] matrix -> int32[rows]."""
    note_dispatch("row_counts")
    return row_counts_plain(mat)


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` along axis 0 with ``mode="clip"`` index semantics:
    out-of-range indices clamp to the first / last row."""
    clipped = idx.to(torch.int64).clamp(0, pool.shape[0] - 1)
    return pool.index_select(0, clipped)


def gathered_pair_counts(a_pool: torch.Tensor, ai: torch.Tensor,
                         b_pool: torch.Tensor, bi: torch.Tensor
                         ) -> torch.Tensor:
    """Per-pair |a_pool[ai[p]] & b_pool[bi[p]]| -> int32[P], indices
    clipped to each pool (pilosa_tpu/ops/bitmap.py:483-506)."""
    note_dispatch("gathered_pair_counts")
    return row_counts_plain(gather_rows(a_pool, ai) & gather_rows(b_pool, bi))


# ---------------------------------------------------------------------------
# TopN and GroupBy scans (pilosa_tpu/ops/bitmap.py:444-547)
# ---------------------------------------------------------------------------


def row_counts_masked_plain(mat: torch.Tensor, filt_stack: torch.Tensor,
                            filt_idx: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The plain version of K4: ``out[r] = |mat[r] & filt_stack[i]|``
    with ``i = filt_idx[r]``, or 0 without an index -> int32[rows]."""
    if filt_idx is None:
        filt = filt_stack[0].unsqueeze(0)
    else:
        filt = filt_stack.index_select(0, filt_idx.to(torch.int64))
    return row_counts_plain(mat & filt)


def masked_matrix_counts_plain(mat: torch.Tensor, masks: torch.Tensor
                               ) -> torch.Tensor:
    """The plain version of K5: ``out[g, r] = |mat[r] & masks[g]|`` ->
    int32[groups, rows], one group at a time so no [G, R, W]
    intermediate is built."""
    out = torch.empty((masks.shape[0], mat.shape[0]), dtype=torch.int32,
                      device=mat.device)
    for g in range(masks.shape[0]):
        out[g] = row_counts_plain(mat & masks[g])
    return out


def row_counts_masked(mat: torch.Tensor, filt: torch.Tensor
                      ) -> torch.Tensor:
    """Per-row |mat[r] & filt| -> int32[rows]: TopN with a filter on one
    shard (K4, every row against filter row 0)."""
    from pilosa_tpu_torch.ops import cuda_kernels as ck

    note_dispatch("row_counts_masked")
    return ck.row_counts_masked(mat, filt.reshape(1, -1))


def row_counts_gathered(mat: torch.Tensor, filt_stack: torch.Tensor,
                        shard_pos: torch.Tensor) -> torch.Tensor:
    """Per-row |mat[r] & filt_stack[shard_pos[r]]| -> int32[rows]: the
    fused cross-shard TopN scan, every shard's rows in one launch of
    K4."""
    from pilosa_tpu_torch.ops import cuda_kernels as ck

    note_dispatch("row_counts_gathered")
    return ck.row_counts_masked(mat, filt_stack, shard_pos)


def masked_matrix_counts(mat: torch.Tensor, masks: torch.Tensor
                         ) -> torch.Tensor:
    """counts[g, r] = |mat[r] & masks[g]| -> int32[groups, rows]: the
    GroupBy inner product, every group against every row in one launch
    of K5."""
    from pilosa_tpu_torch.ops import cuda_kernels as ck

    note_dispatch("masked_matrix_counts")
    return ck.masked_matrix_counts(mat, masks)


def and_pairs(mat: torch.Tensor, masks: torch.Tensor, slots, group_idx
              ) -> torch.Tensor:
    """out[p] = mat[slots[p]] & masks[group_idx[p]] -> int32[P, words]:
    the next GroupBy level's group masks (plain torch, XLA in the
    reference)."""
    note_dispatch("and_pairs")
    rows = torch.as_tensor(np.asarray(slots), dtype=torch.int64,
                           device=mat.device)
    groups = torch.as_tensor(np.asarray(group_idx), dtype=torch.int64,
                             device=masks.device)
    return mat.index_select(0, rows) & masks.index_select(0, groups)
