"""Seeded K3 launches shared by tests/test_torch_vm_plan.py (K3's host
plan, read as the kernel reads it, against the JAX package on the CPU),
tests/test_torch_cuda.py (the kernel against its plain version on the
card) and chip_smoke.py (the same on the card at a wider domain).

Each case is (label, pool uint32[R, 2048], prog int32[B, T, 3], gidx
int32[L, B, D]), the last pool row all zero:

- ``shared``: a coalesced batch of 16 tree shapes over five rows, so
  queries share leaves (tape.vm_program, the (4, 4) class);
- ``same_row``: one row in two slots of one query, and in another query;
- ``pads``: three queries padded to four, tapes COPY-chained to T = 8,
  pad slots on the zero row, and a lone ``Row`` whose result is a leaf;
- ``caps``: random SSA programs at the served caps (L, T) = (16, 32),
  a pad query and a pad slot among them;
- ``grouped``: eight queries whose tapes read all 16 slots and write all
  32 registers over rows of their own, so their distinct leaves need
  more than one query group;
- ``l64t32``: random SSA programs at (L, T) = (64, 32), a shape the
  wrapper admits beyond the caps;
- ``dfuse``: the 16 shapes of ``shared`` with every leaf replaced by a
  streaming-ingest ``dfuse`` node ``(base & ~clear) | set`` over three
  rows (15 slots), the set and clear overlays nearly empty: a few live
  containers, every other lane on the zero row.

numpy and the port's tape compiler (pilosa_tpu_torch/ops/tape.py)."""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.ops import tape

CW = 2048
OPS = ("and", "or", "xor", "andnot")
COMBOS = (("and", "or"), ("and", "xor"), ("or", "and"), ("or", "andnot"),
          ("andnot", "or"), ("andnot", "xor"), ("xor", "and"),
          ("xor", "or"))


def trees16(a, b, c, d, e) -> list:
    """16 structurally distinct Count trees over five rows (the coalesced
    path's shapes, chip_smoke.py ``TREES``): 2-leaf and 3-leaf folds and
    nested pairs."""
    return ([(op, a, b) for op in OPS] + [(op, c, d, e) for op in OPS]
            + [(o1, (o2, b, e), d) for o1, o2 in COMBOS])


def tree_shape(tree, leaves: list):
    """An ops/expr shape of ``tree`` for tape.compile_shape; ``leaves``
    collects the rows in slot order (a row read twice takes two slots)."""
    if isinstance(tree, tuple):
        return (tree[0],) + tuple(tree_shape(c, leaves) for c in tree[1:])
    leaves.append(tree)
    return ("leaf", len(leaves) - 1)


def dfuse_shape(tree, leaves: list):
    """An ops/expr shape of ``tree`` with every row leaf delta-fused:
    ``("dfuse", base, set, clear)`` over three slots; ``leaves`` collects
    the row, ``("set", row)`` and ``("clear", row)`` in slot order."""
    if isinstance(tree, tuple):
        return (tree[0],) + tuple(dfuse_shape(c, leaves) for c in tree[1:])
    base = len(leaves)
    leaves += [tree, ("set", tree), ("clear", tree)]
    return ("dfuse", ("leaf", base), ("leaf", base + 1), ("leaf", base + 2))


def row_pool(rng, n_rows: int, domain: int) -> tuple:
    """(pool, rows_of, zero): ``n_rows`` rows of ``domain`` containers,
    about a quarter of the bits set, a tenth of the containers absent (on
    the zero row), the first container all ones; rows_of[r] int32[domain]
    names row r's containers."""
    shape = (n_rows * domain + 1, CW)
    pool = (rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
            & rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32))
    pool[0] = 0xFFFFFFFF
    zero = len(pool) - 1
    pool[zero] = 0
    rows_of = {}
    for r in range(n_rows):
        ix = np.arange(r * domain, (r + 1) * domain, dtype=np.int32)
        ix[rng.random(domain) < 0.1] = zero
        rows_of[r] = ix
    return pool, rows_of, zero


def delta_pool(rng, n_rows: int, domain: int) -> tuple:
    """``row_pool`` with a set and a clear overlay row per row, keyed
    ``("set", r)`` and ``("clear", r)``: a twentieth of their containers
    live, every other lane on the zero row."""
    pool, rows_of, zero = row_pool(rng, 3 * n_rows, domain)
    out = {r: rows_of[r] for r in range(n_rows)}
    for i, kind in enumerate(("set", "clear")):
        for r in range(n_rows):
            ix = rows_of[n_rows * (i + 1) + r].copy()
            ix[rng.random(domain) >= 0.05] = zero
            out[(kind, r)] = ix
    return pool, out, zero


def coalesced(rng, trees: list, n_rows: int, domain: int,
              tape_len: int | None = None, slots: int | None = None,
              delta: bool = False):
    """(pool, prog, gidx) of the VM batch of ``trees`` over ``n_rows``
    rows, as tape.execute_vm stages it; with ``delta`` every row leaf is
    delta-fused over overlay rows of its own."""
    pool, rows_of, zero = (delta_pool if delta else row_pool)(rng, n_rows,
                                                              domain)
    batch = []
    for tree in trees:
        leaves: list = []
        shape = (dfuse_shape if delta else tree_shape)(tree, leaves)
        batch.append((tape.compile_shape(shape, len(leaves)),
                      [rows_of[r] for r in leaves]))
    tb, lb = tape.size_class(max(len(t.instrs) for t, _ in batch),
                             max(t.n_leaves for t, _ in batch))
    prog, gidx = tape.vm_program(batch, zero, tape_len or tb, slots or lb)
    return pool, prog, gidx


def random_ssa(rng, n_q: int, slots: int, tape_len: int, rows: int,
               domain: int, pad_q: int = 0) -> tuple:
    """(pool, prog, gidx): random SSA programs over all five opcodes
    (instruction t reads any slot or earlier output), the directory
    drawn over every row, the last slot a pad slot on the zero row, and
    the last ``pad_q`` queries pad rows (COPY of slot 0 on the zero
    row)."""
    pool = rng.integers(0, 2 ** 32, size=(rows, CW), dtype=np.uint32)
    pool[0] = 0xFFFFFFFF
    zero = rows - 1
    pool[zero] = 0
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = ((t + q) % 5 if t < 5 else rng.integers(5),
                          rng.integers(slots + t), rng.integers(slots + t))
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    gidx[slots - 1] = zero
    if pad_q:
        prog[n_q - pad_q:] = (tape.OP_COPY, 0, 0)
        gidx[:, n_q - pad_q:] = zero
    return pool, prog, gidx


def chained(rng, n_q: int, slots: int, tape_len: int, domain: int) -> tuple:
    """(pool, prog, gidx): every query's tape is a chain whose
    instruction t applies opcode t % 4 to the previous output and slot t %
    L, so every slot and every instruction is live, over rows of the
    query's own."""
    pool, rows_of, _zero = row_pool(rng, n_q * slots, domain)
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for t in range(tape_len):
        prog[:, t] = (t % 4, slots + t - 1 if t else slots - 1, t % slots)
    gidx = np.stack([np.stack([rows_of[q * slots + l] for q in range(n_q)])
                     for l in range(slots)])
    return pool, prog, gidx


def k3_cases(seed: int, domain: int) -> list:
    """The named cases at ``domain`` containers per leaf."""
    rng = np.random.default_rng(seed)
    same = [("and", 1, 1), ("or", ("xor", 0, 2), 0)]
    pads = [("and", 0, 1), ("andnot", ("or", 2, 0), 1), 3]
    return [
        ("shared", *coalesced(rng, trees16(0, 1, 2, 3, 4), 5, domain)),
        ("same_row", *coalesced(rng, same, 3, domain)),
        ("pads", *coalesced(rng, pads, 4, domain, tape_len=8)),
        ("caps", *random_ssa(rng, 3, 16, 32, 48, domain, pad_q=1)),
        ("grouped", *chained(rng, 8, 16, 32, domain)),
        ("l64t32", *random_ssa(rng, 2, 64, 32, 96, domain)),
        ("dfuse", *coalesced(rng, trees16(0, 1, 2, 3, 4), 5, domain,
                             delta=True)),
    ]
