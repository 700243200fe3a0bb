"""Per-kind container pools: the array and run layouts behind the
compressed container directory (ops/containers.py).

Port of pilosa_tpu/ops/kindpools.py.  Beside the dense bitmap block
(kind 1, 2048 32-bit words) a container may be kept as

- **array** (kind 2) -- its sorted 16-bit values, cardinality <= 4096,
  packed ``[n, acap]`` with a cardinality per row; ``acap`` is the pow2
  size class of the pool's largest cardinality and slots past a row's
  cardinality hold ``ARRAY_PAD`` (0xFFFF);
- **run** (kind 3) -- its maximal ``(start, last)`` inclusive intervals,
  packed ``[n, 2 * rcap]`` interleaved, padded with the invalid pair
  ``(1, 0)``.

Kind selection is the wire serializer's cost rule
(storage/roaring.pick_kind) with the device-only ``run_cap`` demotion.
The host side (``pick_kinds``, ``block_stats``, ``split_pools`` and the
numpy decoders) is numpy and gives the reference's arrays bit for bit;
``block_stats`` and ``split_pools`` find cardinalities, values and run
edges with word algebra instead of the reference's per-container bit
unpacking.
The pools live on the card as ``torch.int16`` holding the uint16 bits,
so resident bytes are the reference's compact bytes; every widening
masks with ``0xFFFF``.

``decode_array`` and ``decode_runs`` are the torch twins of the
reference's ``decode_array_jnp`` / ``decode_runs_jnp``: integer scatter
and shift algebra only, so bit-exact by construction --

- array decode scatters ``1 << (v & 31)`` at word ``v >> 5``; values are
  sorted and unique, so the contributions to one word are distinct
  powers of two and add == or;
- run decode scatters toggles at ``start`` and ``last + 1`` (runs are
  maximal, so toggle positions strictly increase and add == xor), then
  an in-word prefix xor by shifts and a word-level carry parity turn the
  toggles into coverage.

They are the plain decode of K3-kinds' plain version
(ops/cuda_kernels.vm_counts_kinds_plain) and of the gathered kinds path
(ops/expr.evaluate_gathered_kinds).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.storage.roaring import (ARRAY_MAX_CARD, KIND_ARRAY,
                                              KIND_BITMAP, KIND_RUN)

#: container geometry (ops/containers.py)
CONTAINER_BITS = 1 << 16
CWORDS = CONTAINER_BITS // 32

#: default ceiling on the run kind's interval count ([containers]
#: run-cap): a container with more maximal runs re-picks array/bitmap
DEFAULT_RUN_CAP = 256

#: array-pool padding: >= every real value, so padded rows stay sorted
ARRAY_PAD = 0xFFFF

def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def pick_kinds(blocks: np.ndarray, array_max: int = ARRAY_MAX_CARD,
               run_cap: int = DEFAULT_RUN_CAP) -> np.ndarray:
    """The cheapest kind per dense container block (uint32[n, CWORDS])
    by the serializer's cost rule, with the ``run_cap`` demotion (too
    many intervals -> array/bitmap) applied; uint8[n]."""
    cards, runs = block_stats(blocks)
    eff_runs = np.where(runs <= run_cap, runs, ARRAY_MAX_CARD)
    run_size = 2 + 4 * eff_runs
    array_size = np.where(cards <= array_max, 2 * cards, np.int64(1) << 40)
    kinds = np.where(
        (run_size < array_size) & (run_size < 8192), KIND_RUN,
        np.where(array_size <= 8192, KIND_ARRAY, KIND_BITMAP))
    return kinds.astype(np.uint8)


def _edges(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per dense block, the words of its run starts (set bits whose lower
    neighbour is clear) and of its run ends (set bits whose upper
    neighbour is clear); a word's neighbours across its edges are the
    adjacent words' top and bottom bits."""
    below = np.zeros_like(blocks)
    below[:, 1:] = blocks[:, :-1] >> np.uint32(31)
    above = np.zeros_like(blocks)
    above[:, :-1] = blocks[:, 1:] << np.uint32(31)
    starts = blocks & ~((blocks << np.uint32(1)) | below)
    ends = blocks & ~((blocks >> np.uint32(1)) | above)
    return starts, ends


def block_stats(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cardinality int64[n], maximal-run count int64[n]) per dense
    block, by word algebra (one run per start bit)."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint32)
    cards = np.bitwise_count(blocks).sum(axis=1, dtype=np.int64)
    runs = np.bitwise_count(_edges(blocks)[0]).sum(axis=1, dtype=np.int64)
    return cards, runs


def _positions(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row, bit) of every set bit of uint32[n, CWORDS], row-major and
    ascending within a row; only the non-zero words are unpacked."""
    r, w = np.nonzero(words)
    bits = np.unpackbits(words[r, w].view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")
    i, b = np.nonzero(bits)
    return r[i], w[i].astype(np.int64) * 32 + b


def _ragged(rows: np.ndarray, vals: np.ndarray, n: int, width: int,
            fill: int) -> np.ndarray:
    """Row-major (row, value) pairs -> uint16[n, width], ``fill`` past
    each row's values."""
    counts = np.bincount(rows, minlength=n)
    out = np.full((n, width), fill, dtype=np.uint16)
    if len(rows):
        first = np.cumsum(counts) - counts
        out[rows, np.arange(len(rows)) - first[rows]] = vals
    return out


def split_pools(blocks: np.ndarray, kinds: np.ndarray) -> tuple:
    """Split a directory's dense blocks into per-kind compact pools:
    ``(slots, bblocks, apool, acard, rpool)``.  ``slots`` int32[n] is
    each container's row in its own kind's pool (directory order kept
    per kind); ``bblocks`` the kind-1 blocks uint32[bn, CWORDS];
    ``apool``/``acard`` the arrays uint16[an, acap] and int32[an];
    ``rpool`` the runs uint16[rn, 2 * rcap].  Column widths are the pow2
    size classes of the pool's own maxima (at least 1 value, 1 pair)."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint32)
    kinds = np.asarray(kinds)
    slots = np.zeros(len(kinds), dtype=np.int32)
    for k in (KIND_BITMAP, KIND_ARRAY, KIND_RUN):
        sel = kinds == k
        slots[sel] = np.arange(int(sel.sum()), dtype=np.int32)
    bblocks = blocks[kinds == KIND_BITMAP]

    arr = blocks[kinds == KIND_ARRAY]
    rows, vals = _positions(arr)
    acard = np.bincount(rows, minlength=len(arr)).astype(np.int32)
    acap = _pow2(int(acard.max(initial=0)) or 1)
    apool = _ragged(rows, vals, len(arr), acap, ARRAY_PAD)

    run = blocks[kinds == KIND_RUN]
    starts, ends = _edges(run)
    rows, first = _positions(starts)
    _rows, last = _positions(ends)
    nruns = np.bincount(rows, minlength=len(run))
    rcap = _pow2(int(nruns.max(initial=0)) or 1)
    # pairs interleave (start, last); padding is the invalid pair (1, 0)
    pairs = np.stack([first, last], axis=1).reshape(-1)
    prow = np.repeat(rows, 2)
    pad = np.tile(np.array([1, 0], dtype=np.uint16), rcap)
    rpool = np.broadcast_to(pad, (len(run), 2 * rcap)).copy()
    if len(prow):
        base = 2 * (np.cumsum(nruns) - nruns)
        rpool[prow, np.arange(len(prow)) - base[prow]] = pairs
    return slots, bblocks, apool, acard, rpool


# ------------------------------------------------------- numpy decoders
#
# copies of the reference's numpy twins (bit-exact with the torch
# decoders below by construction).  Both accept a zero-row pool.


def decode_array_np(apool: np.ndarray, acard: np.ndarray) -> np.ndarray:
    n, cap = apool.shape
    out = np.zeros((n, CWORDS), dtype=np.uint32)
    if n == 0:
        return out
    vals = apool.astype(np.int64)
    valid = np.arange(cap, dtype=np.int64)[None, :] < acard[:, None]
    contrib = np.where(valid, np.int64(1) << (vals & 31),
                       0).astype(np.uint32)
    rows = np.broadcast_to(np.arange(n)[:, None], vals.shape)
    word = np.where(valid, vals >> 5, 0)
    np.bitwise_or.at(out, (rows, word), contrib)
    return out


def decode_runs_np(rpool: np.ndarray) -> np.ndarray:
    n = rpool.shape[0]
    if n == 0:
        return np.zeros((0, CWORDS), dtype=np.uint32)
    pairs = rpool.reshape(n, -1, 2).astype(np.int64)
    s, l = pairs[..., 0], pairs[..., 1]
    valid = l >= s
    rows = np.broadcast_to(np.arange(n)[:, None], s.shape)
    t = np.zeros((n, CWORDS + 1), dtype=np.uint32)
    for pos in (s, l + 1):
        p = np.where(valid, pos, 0)
        contrib = np.where(valid, np.int64(1) << (p & 31),
                           0).astype(np.uint32)
        np.add.at(t, (rows, p >> 5), contrib)
    x = t[:, :CWORDS]  # a toggle at bit 2^16 covers nothing in range
    for sh in (1, 2, 4, 8, 16):
        x = x ^ (x << np.uint32(sh))
    wordpar = (x >> np.uint32(31)).astype(np.int64)
    carry = ((np.cumsum(wordpar, axis=1) - wordpar) & 1).astype(np.uint32)
    return x ^ (carry * np.uint32(0xFFFFFFFF))


# ------------------------------------------------------- torch decoders
#
# int32 words hold the uint32 bits; torch's int32 shifts wrap as two's
# complement, so ``1 << 31`` is the word's top bit.


def decode_array(apool: torch.Tensor, acard: torch.Tensor) -> torch.Tensor:
    """Array rows (int16 [n, cap] holding uint16 values, int32 [n]
    cardinalities) -> dense int32 [n, CWORDS] blocks on their device."""
    n, cap = apool.shape
    out = torch.zeros((n, CWORDS), dtype=torch.int32, device=apool.device)
    if n == 0 or cap == 0:
        return out
    vals = apool.to(torch.int32) & 0xFFFF
    valid = (torch.arange(cap, device=apool.device).view(1, cap)
             < acard.to(apool.device).view(n, 1))
    one = torch.ones((), dtype=torch.int32, device=apool.device)
    contrib = torch.where(valid, one << (vals & 31), 0)
    word = torch.where(valid, vals >> 5, 0).to(torch.int64)
    base = (torch.arange(n, device=apool.device) * CWORDS).view(n, 1)
    # distinct powers of two per word: add == or, and int32 adds of them
    # never overflow
    out.view(-1).scatter_add_(0, (base + word).reshape(-1),
                              contrib.reshape(-1))
    return out


def decode_runs(rpool: torch.Tensor) -> torch.Tensor:
    """Run rows (int16 [n, 2 * rcap] holding uint16 (start, last) pairs)
    -> dense int32 [n, CWORDS] blocks on their device."""
    n = rpool.shape[0]
    dev = rpool.device
    if n == 0 or rpool.shape[1] == 0:
        return torch.zeros((n, CWORDS), dtype=torch.int32, device=dev)
    pairs = (rpool.to(torch.int32) & 0xFFFF).view(n, -1, 2)
    s, l = pairs[..., 0], pairs[..., 1]
    valid = l >= s
    one = torch.ones((), dtype=torch.int32, device=dev)
    t = torch.zeros((n, CWORDS + 1), dtype=torch.int32, device=dev)
    base = (torch.arange(n, device=dev) * (CWORDS + 1)).view(n, 1)
    for pos in (s, l + 1):
        p = torch.where(valid, pos, 0)
        contrib = torch.where(valid, one << (p & 31), 0)
        # maximal runs: toggle positions strictly increase, so the
        # contributions to one word are distinct powers of two
        t.view(-1).scatter_add_(0, (base + (p >> 5)).reshape(-1),
                                contrib.reshape(-1))
    x = t[:, :CWORDS]
    for sh in (1, 2, 4, 8, 16):
        x = x ^ (x << sh)
    wordpar = (x >> 31) & 1
    carry = (torch.cumsum(wordpar, dim=1, dtype=torch.int32) - wordpar) & 1
    return x ^ -carry


# ------------------------------------------------------------ count arms
#
# Roaring's array-array and array-bitmap intersections for a counts-root
# AND pair, over the compact rows only (pilosa_tpu/ops/pallas_kernels.py:
# 342 ``gathered_count_array_array`` and :389
# ``gathered_count_array_bitmap``).  They are XLA in the reference, not
# Pallas kernels, and plain torch here.  The caller ticks the dispatch.


def _array_rows(apool: torch.Tensor, acard: torch.Tensor,
                ia: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ia = ia.to(apool.device).to(torch.int64)
    vals = apool.index_select(0, ia).to(torch.int32) & 0xFFFF
    return vals, acard.to(apool.device).index_select(0, ia)


def gathered_count_array_array(apool0: torch.Tensor, acard0: torch.Tensor,
                               ia0: torch.Tensor, apool1: torch.Tensor,
                               acard1: torch.Tensor, ia1: torch.Tensor
                               ) -> torch.Tensor:
    """Per pair p, ``|A0[ia0[p]] & A1[ia1[p]]|`` -> int32[P]: binary
    search of each valid value of side 0 in side 1's sorted row.  Pad
    lanes point at the pools' empty rows and count 0."""
    v0, c0 = _array_rows(apool0, acard0, ia0)
    v1, c1 = _array_rows(apool1, acard1, ia1)
    pos = torch.searchsorted(v1, v0)
    probe = torch.gather(v1, 1, pos.clamp(max=v1.shape[1] - 1))
    # pos < c1 rejects pad hits: the pad is 0xFFFF, so a real 65535 in
    # row 1 sits at c1 - 1 and still passes
    hit = (pos < c1.view(-1, 1)) & (probe == v0)
    valid = (torch.arange(v0.shape[1], device=v0.device).view(1, -1)
             < c0.view(-1, 1))
    return (hit & valid).sum(dim=1, dtype=torch.int32)


def gathered_count_array_bitmap(apool: torch.Tensor, acard: torch.Tensor,
                                ia: torch.Tensor, bpool: torch.Tensor,
                                ib: torch.Tensor) -> torch.Tensor:
    """Per pair p, ``|A[ia[p]] & B[ib[p]]|`` -> int32[P]: each valid
    array value tests its bit in the bitmap row's words."""
    v, c = _array_rows(apool, acard, ia)
    words = bpool.index_select(0, ib.to(bpool.device).to(torch.int64))
    bit = (torch.gather(words, 1, (v >> 5).to(torch.int64)) >> (v & 31)) & 1
    valid = (torch.arange(v.shape[1], device=v.device).view(1, -1)
             < c.view(-1, 1))
    return torch.where(valid, bit, 0).sum(dim=1, dtype=torch.int32)
