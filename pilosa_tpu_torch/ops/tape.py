"""Op-tape interpreter: one launch for a batch of heterogeneous-shape
expression trees.

Port of pilosa_tpu/ops/tape.py.  Each ops/expr tree compiles to a flat
op-tape -- an opcode stream over a register file whose low registers
hold the leaves -- and a batch of tapes pads into a pow2 size class
(tape length x leaf-slot count), so structurally different Count trees
share one launch (parallel/coalescer.py).

Tape grammar (compiled from the ops/expr shape grammar):

    opcodes   AND OR XOR ANDNOT COPY
    operands  i >= 0  -> leaf slot i
              i <  0  -> instruction ~i's output register
    ``not``   -> ANDNOT(exist, child)
    ``dfuse`` -> OR(ANDNOT(child, clear), set)   (two instructions)
    ``shift`` is not tape-eligible: its distance is not an operand.

Instruction ``t`` writes register ``n_slots + t``; a bucket pads short
tapes with COPYs of the final real register, so the LAST register holds
the result.

Two engines:

- ``execute`` interprets dense leaf stacks with plain torch ops, ONE
  QUERY AT A TIME (the reference's host engine ``_host_exec``): the
  batched register file of the reference's XLA program
  ([B, slots + T, S, W]) would be 48 GiB at the default caps over 256
  full-width shards, while one query's live registers are a handful of
  [S, W] stacks, and a COPY aliases its operand without a copy.
- ``execute_vm`` packs a megabatch of compressed queries into one
  (program, gather directory) pair and runs the bitmap VM kernel K3
  (ops/cuda_kernels.vm_counts) in ONE launch.

Both tick one ``note_dispatch`` per launch, as the reference does.
Nothing is lowered ahead of time in torch, so the reference's
``_program``/``_mesh_program`` have no counterpart; the ``programs``
inventories of ``debug()`` list the bucket variants this process has
executed.  ``prewarm`` (``[ragged] prewarm``) launches K3 over the
smallest size class's batch ladder on a served card.
"""

from __future__ import annotations

import threading
from collections import namedtuple
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import cuda_kernels

OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_COPY = range(5)

_FOLD_OPS = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR,
             "andnot": OP_ANDNOT}

#: Smallest bucket edge for both axes: a Count(Row) and a
#: Count(Intersect(Row, Row)) share the (4, 4) size class.
MIN_BUCKET = 4

#: Default per-query caps (the ``[ragged]`` config): a longer tape, or a
#: tree with more leaves, falls back to the per-shape fused path.
DEFAULT_MAX_TAPE = 32
DEFAULT_MAX_LEAVES = 16


class TapeError(ValueError):
    """The shape cannot compile to a tape (unsupported node, bad leaf
    ref, or over the configured length cap)."""


#: One compiled tape: ``instrs`` is a tuple of (opcode, a, b) with the
#: symbolic operand encoding above; ``n_leaves`` the number of leaf
#: slots the operands reference.
Tape = namedtuple("Tape", ("instrs", "n_leaves"))


# ------------------------------------------------------------- compiler


def compile_shape(shape, n_leaves: int, max_len: int | None = None) -> Tape:
    """Compile one ops/expr shape into a Tape (post-order emission).
    Raises TapeError on shift nodes, unknown nodes, out-of-range leaf
    slots, or a tape longer than ``max_len``."""
    instrs: list[tuple[int, int, int]] = []

    def emit(op: int, a: int, b: int) -> int:
        instrs.append((op, a, b))
        return ~(len(instrs) - 1)

    def go(node: tuple) -> int:
        kind = node[0]
        if kind == "leaf":
            slot = node[1]
            if not 0 <= slot < n_leaves:
                raise TapeError(f"leaf slot {slot} out of range")
            return slot
        if kind in _FOLD_OPS:
            if len(node) < 2:
                raise TapeError(f"{kind} needs at least one child")
            op = _FOLD_OPS[kind]
            ref = go(node[1])
            for child in node[2:]:
                ref = emit(op, ref, go(child))
            return ref
        if kind == "not":
            return emit(OP_ANDNOT, go(node[1]), go(node[2]))
        if kind == "dfuse":
            if len(node) != 4:
                raise TapeError("dfuse needs (child, set, clear)")
            child = go(node[1])
            dset = go(node[2])
            dclear = go(node[3])
            return emit(OP_OR, emit(OP_ANDNOT, child, dclear), dset)
        if kind == "shift":
            raise TapeError("shift is not tape-eligible")
        raise TapeError(f"unknown expression node: {kind!r}")

    root = go(shape)
    if root >= 0:
        # a bare-leaf root: materialize it so the result always lives in
        # the last register
        root = emit(OP_COPY, root, 0)
    if max_len is not None and len(instrs) > max_len:
        raise TapeError(
            f"tape length {len(instrs)} exceeds cap {max_len}")
    return Tape(tuple(instrs), n_leaves)


def try_compile(shape, n_leaves: int,
                max_len: int | None = None) -> Tape | None:
    """``compile_shape`` that reports ineligibility through the counters
    instead of raising."""
    try:
        return compile_shape(shape, n_leaves, max_len)
    except TapeError as e:
        bump("tape.oversize_fallbacks" if "exceeds cap" in str(e)
             else "tape.unsupported")
        return None


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def size_class(n_instrs: int, n_leaves: int) -> tuple[int, int]:
    """The (tape_len, leaf_slots) bucket a tape pads into: pow2 on both
    axes with a MIN_BUCKET floor."""
    return (max(MIN_BUCKET, _pow2(max(1, n_instrs))),
            max(MIN_BUCKET, _pow2(max(1, n_leaves))))


# ------------------------------------------------------------- counters

_lock = threading.Lock()
# the reference's names (pilosa_tpu/ops/tape.py:181-209), so /debug/ragged
# reads the same in both packages; the mesh never runs here, and prewarm
# only on a served card
_counters = {
    "tape.executions": 0,
    "tape.queries": 0,
    "tape.oversize_fallbacks": 0,
    "tape.unsupported": 0,
    "tape.prewarmed": 0,
    "coalescer.shape_misses": 0,
    "coalescer.shape_flushes": 0,
    "vm.executions": 0,
    "vm.queries": 0,
    "vm.fallbacks": 0,
    "vm.fallbacks.disabled": 0,
    "vm.fallbacks.ineligible_leaf": 0,
    "vm.fallbacks.kind_unsupported": 0,
    "vm.fallbacks.oversize": 0,
    "vm.fallbacks.max_prefetch": 0,
    "vm.fallbacks.min_domain": 0,
    "vm.fallbacks.mesh_active": 0,
}
#: (counts, B, tape_len, slots, *stack_shape) variants ``execute`` ran
_lowered: set[tuple] = set()
#: (B, tape_len, slots, domain) variants ``execute_vm`` launched
_vm_lowered: set[tuple] = set()


def bump(name: str, value: int = 1) -> None:
    with _lock:
        _counters[name] += value


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    """Zero the counters and the program inventories (tests)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0
        _lowered.clear()
        _vm_lowered.clear()


def debug() -> dict[str, Any]:
    """The /debug/ragged document body: counters plus the program
    inventories."""
    with _lock:
        progs = [{"counts": c, "batch": b, "tapeLen": t, "slots": s,
                  "stack": list(shape)}
                 for (c, b, t, s, *shape) in sorted(_lowered)]
        vm_progs = [{"batch": b, "tapeLen": t, "slots": s, "domain": d}
                    for (b, t, s, d) in sorted(_vm_lowered)]
        reasons = {k.split(".", 2)[2]: v for k, v in _counters.items()
                   if k.startswith("vm.fallbacks.")}
        return {"counters": dict(_counters), "programs": progs,
                "vm": {"programs": vm_progs,
                       "fallbackReasons": reasons}}


# ------------------------------------------------------------ interpreter


def _abs_operand(ref: int, n_slots: int) -> int:
    """Symbolic operand -> absolute register index in a bucket with
    ``n_slots`` leaf registers."""
    return ref if ref >= 0 else n_slots + ~ref


def _one_query(tp: Tape, leaves: Sequence[torch.Tensor],
               counts: bool) -> torch.Tensor:
    """One tape over its leaf stacks (pilosa_tpu/ops/tape.py
    ``_host_exec``): each instruction output is live only while a later
    one reads it, and COPY aliases its operand."""
    outs: list[torch.Tensor] = []

    def operand(ref: int) -> torch.Tensor:
        return leaves[ref] if ref >= 0 else outs[~ref]

    for op, a, b in tp.instrs:
        xa = operand(a)
        if op == OP_COPY:
            outs.append(xa)
            continue
        xb = operand(b)
        if op == OP_AND:
            outs.append(xa & xb)
        elif op == OP_OR:
            outs.append(xa | xb)
        elif op == OP_XOR:
            outs.append(xa ^ xb)
        else:
            outs.append(xa & ~xb)
    res = outs[-1]
    return bm.row_counts_plain(res) if counts else res


def execute(batch: Sequence[tuple[Tape, tuple]], counts: bool = False,
            tape_len: int | None = None,
            slots: int | None = None) -> list[torch.Tensor]:
    """Execute a batch of (Tape, leaves) pairs as ONE dispatch.

    Every query's leaf stacks share one shape (the coalescer's bucket key
    guarantees it).  ``tape_len``/``slots`` pin the bucket the batch
    pads into (defaults: the batch's own size class).  Returns one
    result per query, in order: the word stack, or int32 per-row
    popcounts with ``counts=True``."""
    if not batch:
        return []
    tb, lb = size_class(max(len(t.instrs) for t, _ in batch),
                        max(t.n_leaves for t, _ in batch))
    tape_len = tape_len or tb
    slots = slots or lb
    for tp, ls in batch:
        if len(tp.instrs) > tape_len or len(ls) > slots:
            raise TapeError("tape exceeds its bucket")
    n = len(batch)
    bm.note_dispatch("tape")
    bump("tape.executions")
    bump("tape.queries", n)
    with _lock:
        _lowered.add((counts, _pow2(n), tape_len, slots)
                     + tuple(batch[0][1][0].shape))
    return [_one_query(tp, ls, counts) for tp, ls in batch]


def execute_vm(batch: Sequence[tuple[Tape, list]], pool,
               zero_index: int, tape_len: int | None = None,
               slots: int | None = None,
               max_prefetch: int | None = None) -> list[np.ndarray]:
    """Execute a megabatch of (Tape, gather rows) queries over ONE pooled
    compressed operand as ONE bitmap-VM launch: ops/cuda_kernels
    ``vm_counts`` (K3) over a plain pool, ``vm_counts_kinds`` (K3-kinds)
    over a kind-split ``containers.MegaPools`` bundle.

    Each query's second element is its per-leaf-slot list of int32[D]
    GLOBAL pool row indices (ops/containers.megapool); every query shares
    one domain width D.  ``zero_index`` is the pool's all-zero row: pad
    slots, pad batch rows and absent containers gather it.  Returns one
    int64[D] per-cell count vector per query, in order.

    ``max_prefetch`` bounds the directory (slots x batch x D entries; a
    TPU scalar-memory limit in the reference, kept so launches and
    counters match it): an oversized batch splits in half recursively,
    each half its own launch."""
    if not batch:
        return []
    tb, lb = size_class(max(len(t.instrs) for t, _ in batch),
                        max(t.n_leaves for t, _ in batch))
    tape_len = tape_len or tb
    slots = slots or lb
    for tp, idxs in batch:
        if len(tp.instrs) > tape_len or len(idxs) > slots:
            raise TapeError("tape exceeds its bucket")
    n = len(batch)
    D = len(batch[0][1][0])
    b_pad = _pow2(n)
    if (max_prefetch is not None and n > 1
            and slots * b_pad * D > max_prefetch):
        mid = (n + 1) // 2
        return (execute_vm(batch[:mid], pool, zero_index, tape_len,
                           slots, max_prefetch)
                + execute_vm(batch[mid:], pool, zero_index, tape_len,
                             slots, max_prefetch))
    bm.note_dispatch("vm")
    bump("vm.executions")
    bump("vm.queries", n)
    prog, gidx = vm_program(batch, zero_index, tape_len, slots)
    with _lock:
        _vm_lowered.add((b_pad, tape_len, slots, D))
    prog_t, gidx_t = torch.from_numpy(prog), torch.from_numpy(gidx)
    if isinstance(pool, torch.Tensor):
        cts = cuda_kernels.vm_counts(pool, prog_t, gidx_t)
    else:  # a kind-split containers.MegaPools bundle: K3-kinds
        cts = cuda_kernels.vm_counts_kinds(pool.bpool, pool.apool,
                                           pool.acard, pool.rpool, prog_t,
                                           gidx_t)
    cts = cts.to("cpu").numpy().astype(np.int64)
    return [cts[i] for i in range(n)]


def vm_program(batch: Sequence[tuple[Tape, list]], zero_index: int,
               tape_len: int, slots: int) -> tuple[np.ndarray, np.ndarray]:
    """The (prog int32[B, T, 3], gidx int32[L, B, D]) pair of ONE VM
    launch, B the batch padded to pow2: absolute operands, short tapes
    COPY-chained to the last register, pad rows all COPY of slot 0, and
    pad rows and pad slots gathering ``zero_index``."""
    b_pad = _pow2(len(batch))
    D = len(batch[0][1][0])
    prog = np.zeros((b_pad, tape_len, 3), dtype=np.int32)
    prog[:, :, 0] = OP_COPY  # pad rows: COPY of leaf slot 0
    gidx = np.full((slots, b_pad, D), zero_index, dtype=np.int32)
    for qi, (tp, idxs) in enumerate(batch):
        for ti, (op, a, b) in enumerate(tp.instrs):
            prog[qi, ti] = (op, _abs_operand(a, slots),
                            _abs_operand(b, slots))
        final = slots + len(tp.instrs) - 1
        # short tapes chain COPYs of the final real register forward, so
        # the LAST register holds the result
        prog[qi, len(tp.instrs):, 1] = final
        for li, ix in enumerate(idxs):
            gidx[li, qi, :len(ix)] = ix
    return prog, gidx


def prewarm(device: torch.device, max_batch: int) -> int:
    """The ``[ragged] prewarm`` counterpart (pilosa_tpu/ops/tape.py:
    623-668): launch K3 once per batch of the pow2 ladder 2..pow2(
    ``max_batch``) at the smallest size class, over a two-row pool on
    ``device``, so that a served process's first coalesced Count pays
    neither K3's module load nor its first launch.  The reference lowers
    XLA programs here; K3 is compiled ahead (ops/nvcc_build.py), so what
    is left to warm is the load, the plan's host code and the launch
    path.  Returns the launches made, each counted in ``tape.prewarmed``
    and in ``vm_counts.launches``."""
    tp = compile_shape(("and", ("leaf", 0), ("leaf", 1)), 2)
    tape_len, slots = size_class(1, 1)
    words = cuda_kernels.CONTAINER_WORDS
    pool = torch.zeros((2, words), dtype=torch.int32, device=device)
    pool[0] = -1  # row 0 all ones, row 1 the zero row
    n = 0
    b = 2
    while b <= max(2, _pow2(max_batch)):
        idxs = [np.zeros(1, dtype=np.int32)] * 2
        prog, gidx = vm_program([(tp, idxs)] * b, 1, tape_len, slots)
        cts = cuda_kernels.vm_counts(pool, torch.from_numpy(prog),
                                     torch.from_numpy(gidx))
        if int(cts[0, 0]) != words * 32:
            raise RuntimeError(f"K3 prewarm launch at batch {b} counted "
                               f"{int(cts[0, 0])}, not {words * 32}")
        bump("tape.prewarmed")
        n += 1
        b <<= 1
    return n
