"""Seeded kind-split megapools at the edges of K3-kinds' decode, shared by
tests/test_torch_kindpools.py (the plain version against the JAX
package, on the CPU) and tests/test_torch_cuda.py (the kernel against
its plain version, on the card).  numpy only.

The kernel decodes a container in four passes of 16,384 bits, and a
warp's part of a pass is 4096 bits, so the rows put array values and run
edges on those boundaries: values 0, 16383, 16384, 32767, 32768, 49151,
49152 and 65535 (which equals the array padding), a full array of 4096
values and an empty one, runs that cross a pass edge, cover a whole pass
or the whole container, a run of one bit, two runs in one word, a run
row with all 256 pairs valid, and runs on the warps' edges."""

from __future__ import annotations

import numpy as np

CB = 1 << 16
CW = CB // 32
ARRAY_PAD = 0xFFFF

#: the first and last bit of every pass
PASS_EDGES = (0, 16383, 16384, 32767, 32768, 49151, 49152, 65535)

#: (label, leaf slots, tape length, queries, domain) of the edge cases:
#: small, the served caps (tape.DEFAULT_MAX_LEAVES, DEFAULT_MAX_TAPE) and
#: a large shape the wrapper admits
EDGE_SHAPES = (("l4t4", 4, 4, 4, 64), ("caps", 16, 32, 2, 16),
               ("l64t32", 64, 32, 2, 8))


def _block(positions) -> np.ndarray:
    w = np.zeros(CW, dtype=np.uint32)
    p = np.asarray(positions, dtype=np.int64)
    np.bitwise_or.at(w, p >> 5, np.uint32(1) << (p & 31).astype(np.uint32))
    return w


def repad(rpool: np.ndarray, rcap: int) -> np.ndarray:
    """A run pool uint16[n, 2 * c] widened to ``rcap`` pairs with the
    padding pair (1, 0)."""
    out = np.zeros((rpool.shape[0], 2 * rcap), dtype=np.uint16)
    out[:, 0::2] = 1
    out[:, :rpool.shape[1]] = rpool
    return out


def edge_pools(seed: int) -> tuple:
    """(bpool uint32[Rb, 2048], apool uint16[Ra, 4096], acard int32[Ra],
    rpool uint16[Rr, 512]): each pool's last row is its canonical empty
    row, as in a megapool."""
    rng = np.random.default_rng(seed)
    arrays = [np.array(PASS_EDGES),
              np.sort(rng.choice(CB, 4096, replace=False)),
              np.arange(14000, 18096),  # 4096 values across a pass edge
              np.array([], dtype=np.int64),
              np.sort(rng.choice(CB, 65, replace=False)),
              np.arange(32768 - 200, 32768 + 200, 3)]
    acap = 4096
    apool = np.full((len(arrays) + 1, acap), ARRAY_PAD, dtype=np.uint16)
    acard = np.zeros(len(arrays) + 1, dtype=np.int32)
    for i, vals in enumerate(arrays):
        apool[i, :len(vals)] = vals
        acard[i] = len(vals)
    lens = rng.integers(0, 200, size=256)
    runs = [[(5, 9), (20, 25), (16000, 17000), (32760, 49160),
             (60000, 60000), (65530, 65535)],
            [(256 * i, 256 * i + int(n)) for i, n in enumerate(lens)],
            [(0, CB - 1)],
            [(100, 4095), (4097, 8191), (8193, 13000), (20479, 20481)],
            [(16384, 32767)],
            [(0, 0), (65535, 65535)]]
    rcap = 256
    rpool = repad(np.zeros((len(runs) + 1, 0), dtype=np.uint16), rcap)
    for i, pairs in enumerate(runs):
        rpool[i, :2 * len(pairs)] = np.asarray(pairs).reshape(-1)
    bpool = np.stack([_block(rng.choice(CB, 5243, replace=False)),
                      np.full(CW, 0xFFFFFFFF, dtype=np.uint32),
                      _block(PASS_EDGES),
                      np.zeros(CW, dtype=np.uint32)])
    return bpool, apool, acard, rpool


def random_program(rng, n_q: int, slots: int, tape_len: int,
                   rows: int, domain: int, zero: int) -> tuple:
    """(prog int32[B, T, 3], gidx int32[L, B, D]): random SSA programs
    over all five opcodes, the directory drawn over every row, the last
    slot on the zero row (a pad slot)."""
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = ((t + q) % 5 if t < 5 else rng.integers(5),
                          rng.integers(slots + t), rng.integers(slots + t))
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    if slots > 1:
        gidx[slots - 1] = zero
    return prog, gidx


def edge_case(seed: int, slots: int, tape_len: int, n_q: int,
              domain: int) -> tuple:
    """(bpool, apool, acard, rpool, prog, gidx) as numpy over
    ``edge_pools``."""
    pools = edge_pools(seed)
    rows = sum(len(p) for p in (pools[0], pools[1], pools[3]))
    prog, gidx = random_program(np.random.default_rng(seed + 1), n_q, slots,
                                tape_len, rows, domain, len(pools[0]) - 1)
    return (*pools, prog, gidx)


def decode_case(seed: int) -> tuple:
    """Every row of ``edge_pools`` alone: one query whose tape is COPY of
    slot 0, its domain every row, so each cell counts one row's bits."""
    pools = edge_pools(seed)
    rows = sum(len(p) for p in (pools[0], pools[1], pools[3]))
    prog = np.full((1, 1, 3), (4, 0, 0), dtype=np.int32)
    gidx = np.arange(rows, dtype=np.int32).reshape(1, 1, rows)
    return (*pools, prog, gidx)
