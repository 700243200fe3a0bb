"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

K2 -- ``gathered_count_and`` replaces the Pallas directory-walk kernel
``_gathered_count_and_kernel`` / ``_gathered_count_and_pallas``
(pilosa_tpu/ops/pallas_kernels.py:237-284): per pair ``p``,
``popcount(a_pool[ai[p]] & b_pool[bi[p]])`` over one 2048-word
container, as int32[P].  Source: ops/csrc/gathered_count_and.cu.  It is
bound by bytes: 2 * P * 8 KiB read per call.

K3 -- ``vm_counts`` replaces the Pallas bitmap VM ``_vm_counts_kernel``
/ ``_vm_counts_pallas_body`` (pilosa_tpu/ops/pallas_kernels.py:418-486):
for each (query q, domain slot d), gather ``L`` leaf containers of one
pool through ``gidx``, interpret q's op-tape (ops/tape.py grammar,
absolute register operands) and popcount the last register, as
int32[B, D].  The host plans the launch (``vm_plan``): each query's live
instructions and slots (``vm_tape_plan``), the distinct leaves among the
live slots' directory vectors, and query groups that fit a block.  A
block owns one domain slot and one query group and reads each distinct
leaf's container once for all the group's queries.  Source:
ops/csrc/vm_counts.cu.  It is bound by bytes: 8 KiB per distinct
container.

K3-kinds -- ``vm_counts_kinds`` replaces the Pallas kinds VM
``_vm_counts_kinds_pallas`` (pilosa_tpu/ops/pallas_kernels.py:489-504),
reached through ``vm_counts`` -> ``_vm_counts_kinds`` for a kind-split
``containers.MegaPools`` bundle: K3's function over a virtual pool whose
rows ``[0, Rb)`` are bitmap blocks, ``[Rb, Rb + Ra)`` sorted uint16 array
rows and the rest uint16 (start, last) run rows, as int32[B, D].  The
block decodes each array and run row its cell names in shared memory (a
shared atomic per array value; toggled run edges and a prefix xor), so
no dense copy of them is written and no thread searches a row; it runs
only the instructions and leaves the result reaches, planned once per
query on the host (``vm_kinds_plan``).  Source: ops/csrc/vm_counts_kinds.cu.  It is bound
by the instructions it executes (the decode and the tape through shared
memory), not by the compact rows' bytes.

K4 -- ``row_counts_masked`` replaces the Pallas TopN scan
``_row_counts_kernel`` / ``_row_counts_masked_pallas``
(pilosa_tpu/ops/pallas_kernels.py:131-162): ``out[r] = |mat[r] &
filt_stack[i]|`` with ``i = filt_idx[r]``, or 0 without an index, as
int32[R].  Without the index it is the Pallas kernel's function; with
it one launch serves the fused cross-shard TopN scan
(``bitmap.row_counts_gathered``).  Source: ops/csrc/row_counts_masked.cu.
It is bound by bytes: the matrix read once.

K5 -- ``masked_matrix_counts`` replaces the Pallas GroupBy count
``_mmc_kernel`` / ``_mmc_pallas`` (pilosa_tpu/ops/pallas_kernels.py:
638-675): ``out[g, r] = |mat[r] & masks[g]|`` as int32[G, R].  Source:
ops/csrc/masked_matrix_counts.cu.  It is bound by popcounts at GroupBy's
shapes: G * R * W word pairs.

K6 -- ``bsi_compare`` replaces the Pallas BSI ripple ``_bsi_compare_kernel``
/ ``_bsi_compare_pallas`` (pilosa_tpu/ops/pallas_kernels.py:700-757):
per shard and word column, walk the magnitude planes of a bit-sliced
integer stack from the most significant down against an unsigned
predicate and return the considered columns strictly below (lt) and
strictly above (gt) it, as int32[S, W] each.  ``bsi_compare_unsigned`` is
the Pallas entry's function (:760-787): consider = exists & ~sign & filt,
formed in the kernel, and the ``upred >= 2^depth`` early-out.  Source:
ops/csrc/bsi_compare.cu.  It is bound by bytes: the depth planes and the
considered row read once, lt and gt written once.

K1 -- ``count_and`` replaces the Pallas intersection count
``_count_and_kernel`` / ``_count_and_pallas`` (pilosa_tpu/ops/
pallas_kernels.py:182-210): ``|a & b|`` over two equal-shaped word
arrays, rows with a stride each, as a Python int summed in int64 on the
card.  Source: ops/csrc/count_and.cu.  It is bound by bytes: both
operands read once.

All seven sources are CUDA C++ for sm_90a, built by ops/nvcc_build.py at
first use and bound with ctypes.  The wrappers take int32 word tensors
(bit views of the reference's uint32 words).  On CUDA tensors they launch
their kernel on the current stream, or raise -- a failed build or launch
is never answered by the plain version.  On CPU tensors they compute the
plain PyTorch version, which is how the CPU tests reach it:
``bitmap.gathered_pair_counts`` for K2, ``vm_counts_plain`` for K3,
``vm_counts_kinds_plain`` for K3-kinds, ``bitmap.row_counts_masked_plain``
for K4,
``bitmap.masked_matrix_counts_plain`` for K5, ``bsi_compare_plain`` for
K6 and ``count_and_plain`` for K1.  ``<wrapper>.launches``
counts kernel launches, process-wide, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import kindpools as kp
from pilosa_tpu_torch.ops import nvcc_build

CONTAINER_WORDS = 2048  # 32-bit words per 2^16-bit container

#: the card's shared memory for one block (Hopper: 227 KiB), less the
#: VM kernels' static shared memory (their warp sums)
VM_SMEM_LIMIT = 232448 - 64

_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_c = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
# source name -> (exported C function, argtypes)
_ENTRIES = {
    "gathered_count_and": ("gathered_count_and_launch",
                           [_c, _i, _c, _c, _i, _c, _c, _i, _c]),
    "vm_counts": ("vm_counts_launch",
                  [_c, _c, _c, _c] + [_i] * 7 + [_c]),
    "vm_counts_kinds": ("vm_counts_kinds_launch",
                        [_c, _c, _c, _c, _c, _c, _c] + [_i] * 8 + [_c]),
    "row_counts_masked": ("row_counts_masked_launch",
                          [_c, _c, _c, _c, _i, _ll, _i, _c]),
    "masked_matrix_counts": ("masked_matrix_counts_launch",
                             [_c, _c, _c, _i, _i, _ll, _c]),
    "bsi_compare": ("bsi_compare_launch",
                    [_c, _c, _c, _c, _i, _i, _ll, _i, ctypes.c_uint,
                     ctypes.c_uint, _i, _i, _c]),
    "count_and": ("count_and_launch", [_c, _ll, _c, _ll, _ll, _ll, _c, _i,
                                       _c]),
}
#: widest matrix row whose popcount fits the kernels' int32 sums
MAX_WORDS = 2 ** 26 - 1
_launch_fns: dict = {}


def _launcher(name: str):
    """The C launch function of one source, built and bound on first
    use."""
    with _bind_lock:
        fn = _launch_fns.get(name)
        if fn is None:
            sym, argtypes = _ENTRIES[name]
            fn = getattr(nvcc_build.load(name), sym)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            _launch_fns[name] = fn
        return fn


def load_all() -> list[str]:
    """Bind every source's launch function, building a missing library
    with nvcc first: what a served process's first query would otherwise
    pay.  Raises on a failed build, like a launch would."""
    for name in _ENTRIES:
        _launcher(name)
    return list(_ENTRIES)


def _check_pool(name: str, pool: torch.Tensor) -> None:
    if pool.dim() != 2 or pool.shape[1] != CONTAINER_WORDS:
        raise ValueError(f"{name} must be [rows, {CONTAINER_WORDS}], "
                         f"got {tuple(pool.shape)}")
    if pool.shape[0] == 0:
        raise ValueError(f"{name} has no rows")
    if pool.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for int32 indices")
    if pool.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check(a_pool: torch.Tensor, ai: torch.Tensor, b_pool: torch.Tensor,
           bi: torch.Tensor) -> None:
    dev = a_pool.device
    for name, t in (("a_pool", a_pool), ("ai", ai), ("b_pool", b_pool),
                    ("bi", bi)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a_pool on {dev}")
    _check_pool("a_pool", a_pool)
    _check_pool("b_pool", b_pool)
    if ai.dim() != 1 or bi.dim() != 1 or ai.shape != bi.shape:
        raise ValueError(f"ai and bi must be equal-length vectors, got "
                         f"{tuple(ai.shape)} and {tuple(bi.shape)}")
    if ai.shape[0] >= 2 ** 31:
        raise ValueError("too many pairs for one launch")


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


# -------------------------------------------------------------------- K2


def gathered_count_and(a_pool: torch.Tensor, ai: torch.Tensor,
                       b_pool: torch.Tensor, bi: torch.Tensor
                       ) -> torch.Tensor:
    """Per-pair |a_pool[ai[p]] & b_pool[bi[p]]| -> int32[P].  CUDA
    tensors launch K2 (one ``gathered_count_and`` dispatch tick); CPU
    tensors compute the plain version (one ``gathered_pair_counts``
    tick, as the reference's off-chip route ticks)."""
    _check(a_pool, ai, b_pool, bi)
    if a_pool.device.type != "cuda":
        return bm.gathered_pair_counts(a_pool, ai, b_pool, bi)
    launch = _launcher("gathered_count_and")
    n = int(ai.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=a_pool.device)
    if n == 0:
        return out
    with torch.cuda.device(a_pool.device):
        stream = torch.cuda.current_stream(a_pool.device).cuda_stream
        rc = launch(a_pool.data_ptr(), int(a_pool.shape[0]), ai.data_ptr(),
                    b_pool.data_ptr(), int(b_pool.shape[0]), bi.data_ptr(),
                    out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"gathered_count_and launch failed: CUDA error "
                           f"{rc}")
    _count(gathered_count_and)
    bm.note_dispatch("gathered_count_and")
    return out


gathered_count_and.launches = 0


# -------------------------------------------------------------------- K3


#: int4 vectors a K3 thread holds per register and pass, in the order the
#: plan tries them: a block of 128 threads walks a 2048-word container in
#: 4 / vec passes
VM_VECS = (2, 1)


def vm_group_smem_bytes(leaves: int, scratch: int, queries: int,
                        tape_len: int, vec: int = 1) -> int:
    """Shared memory of one K3 block whose query group has ``leaves``
    distinct leaves, ``scratch`` scratch registers and ``queries``
    queries, for tapes of ``tape_len``, at ``vec`` int4 vectors per
    thread and pass: the register file of 128 threads, per query its
    renamed tape (2 + ``tape_len`` ints) and four warp sums, and a row per
    leaf (vm_counts.cu ``vm_counts_smem_bytes``)."""
    return ((leaves + scratch) * vec * 128 * 16
            + (queries * (6 + tape_len) + leaves) * 4)


def vm_smem_bytes(tape_len: int, slots: int) -> int:
    """K3's admission bound for a program of ``tape_len`` instructions
    over ``slots`` leaf slots: a block of one query at one vector per
    thread and pass, with every slot live and distinct and a scratch
    register per instruction, more than any one query needs (the last
    live instruction's output is never stored).  A program admitted by it
    always has a plan (``vm_groups``)."""
    return vm_group_smem_bytes(slots, tape_len, 1, tape_len)


def vm_kinds_smem_bytes(tape_len: int, slots: int) -> int:
    """Shared memory one K3-kinds block needs: K3's register file, the
    tape packed one int per instruction, and a row index and an array
    position per slot (vm_counts_kinds.cu ``smem_bytes``).  It admits
    the same (L, T) as ``vm_smem_bytes``: L + T <= 113."""
    return (slots + tape_len) * 128 * 16 + (tape_len + 2 * slots) * 4


def _check_program(prog: torch.Tensor, gidx: torch.Tensor, rows: int,
                   device: torch.device, smem_bytes=vm_smem_bytes) -> None:
    """Types, layout, shapes and values of a VM program over a pool of
    ``rows`` rows on ``device``, for a kernel whose block needs
    ``smem_bytes(tape_len, slots)`` bytes of shared memory.  ``prog`` and
    ``gidx`` may lie on that device or on the CPU, where the host built
    them."""
    for name, t in (("prog", prog), ("gidx", gidx)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device and t.device.type != "cpu":
            raise ValueError(f"{name} is on {t.device}, the pool on "
                             f"{device}")
    if prog.dim() != 3 or prog.shape[2] != 3:
        raise ValueError(f"prog must be [B, T, 3], got {tuple(prog.shape)}")
    if gidx.dim() != 3 or gidx.shape[1] != prog.shape[0]:
        raise ValueError(f"gidx must be [L, B, D] with B = "
                         f"{prog.shape[0]}, got {tuple(gidx.shape)}")
    n_q, tape_len, _ = prog.shape
    slots, _, domain = gidx.shape
    if tape_len == 0 or slots == 0:
        raise ValueError("prog needs at least one instruction and gidx at "
                         "least one leaf slot")
    if n_q * domain >= 2 ** 31:
        raise ValueError("too many cells for one launch")
    if smem_bytes(tape_len, slots) > VM_SMEM_LIMIT:
        raise ValueError(f"a tape of {tape_len} over {slots} slots needs "
                         f"{smem_bytes(tape_len, slots)} bytes of shared "
                         f"memory, more than {VM_SMEM_LIMIT}")
    if gidx.numel():
        lo, hi = torch.aminmax(gidx)
        if int(lo) < 0 or int(hi) >= rows:
            raise IndexError(f"gidx entries must lie in [0, {rows}), got "
                             f"[{int(lo)}, {int(hi)}]")
    if prog.numel():
        # instruction t may read a leaf slot or an earlier output:
        # registers [0, slots + t)
        t = torch.arange(tape_len, device=prog.device).view(1, tape_len, 1)
        ops = prog[:, :, 0]
        bad = ((ops < 0) | (ops > 4)).any() \
            | (prog[:, :, 1:] < 0).any() \
            | (prog[:, :, 1:] >= slots + t).any()
        if bool(bad):
            raise ValueError("prog holds an opcode outside 0..4 or an "
                             "operand that is not an earlier register")


def _check_vm(pool: torch.Tensor, prog: torch.Tensor,
              gidx: torch.Tensor) -> None:
    """Types, layout, shapes and values of a K3 call."""
    if pool.dtype != torch.int32:
        raise TypeError(f"pool must be int32, got {pool.dtype}")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    _check_pool("pool", pool)
    _check_program(prog, gidx, int(pool.shape[0]), pool.device)


def vm_counts_plain(pool: torch.Tensor, prog: torch.Tensor,
                    gidx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3, a copy of the reference's numpy
    twin ``_vm_counts_host`` (pilosa_tpu/ops/pallas_kernels.py:507):
    per query, gather the [L, D, 2048] leaf blocks and run the tape
    vectorized over the domain axis."""
    n_q, tape_len, _ = prog.shape
    slots, _, domain = gidx.shape
    gidx = gidx.to(pool.device)
    out = torch.zeros((n_q, domain), dtype=torch.int32, device=pool.device)
    for q, tape in enumerate(prog.tolist()):
        regs = [pool.index_select(0, gidx[l, q].to(torch.int64))
                for l in range(slots)]
        for op, a, b in tape:
            xa = regs[a]
            if op == 4:
                regs.append(xa)
                continue
            xb = regs[b]
            if op == 0:
                regs.append(xa & xb)
            elif op == 1:
                regs.append(xa | xb)
            elif op == 2:
                regs.append(xa ^ xb)
            else:
                regs.append(xa & ~xb)
        out[q] = bm.row_counts_plain(regs[-1])
    return out


#: K3's instruction flags, in the opcode byte: operand a is the previous
#: live instruction's output, which the thread still holds; the output is
#: read again later, so it is stored in its scratch register
VM_PREV, VM_STORE = 0x10, 0x20


@functools.lru_cache(maxsize=4096)
def _query_plan(tape: bytes, tape_len: int, slots: int
                ) -> tuple[np.ndarray, tuple, int]:
    """One query's part of K3's plan, from its int32 [T, 3] instructions
    as bytes: its ``_plan_row`` with the live instructions rewritten for
    the kernel, its live leaf slots and its scratch registers.  An
    operand a that is the previous live instruction's output carries
    ``VM_PREV`` (an AND, OR or XOR whose operand b is that output swaps
    its operands first);
    an output that a later instruction reads otherwise carries
    ``VM_STORE`` and gets the next scratch register, ``slots + s``; the
    other outputs are never stored (the last one is only counted)."""
    base = _plan_row(tape, tape_len, slots)
    n = int(base[0])
    ins = []
    prev = None
    for word in base[2:2 + n].view(np.uint32).tolist():
        op, a, b, dst = word & 0xff, word >> 8 & 0xff, word >> 16 & 0xff, \
            word >> 24
        if b == prev and a != prev and op < 3:  # AND, OR, XOR commute
            a, b = b, a
        ins.append((op, a, b, dst, a == prev))
        prev = dst
    read = {b for _op, _a, b, _d, _p in ins}
    read.update(a for _op, a, _b, _d, use_prev in ins if not use_prev)
    scratch = {dst: slots + i for i, dst in enumerate(
        d for _op, _a, _b, d, _p in ins if d in read)}
    row = base.copy()
    words = row[2:2 + n].view(np.uint32)
    for i, (op, a, b, dst, use_prev) in enumerate(ins):
        words[i] = (op | (VM_PREV if use_prev else 0)
                    | (VM_STORE if dst in scratch else 0)
                    | (0 if use_prev else scratch.get(a, a)) << 8
                    | scratch.get(b, b) << 16 | scratch.get(dst, 0) << 24)
    row.flags.writeable = False
    live = tuple(np.flatnonzero(row[2 + tape_len:]).tolist())
    return row, live, len(scratch)


def _distinct_rows(flat: np.ndarray, srcs: list) -> tuple[list, list]:
    """An id for each row ``flat[s]`` of ``srcs``, equal rows with equal
    ids, and the first source of each id.  Rows are keyed by their first
    and last entries; a row whose key is taken is compared in full with
    the rows of that key."""
    keys = zip(flat[:, 0].take(srcs).tolist(),
               flat[:, -1].take(srcs).tolist())
    ids: list = []
    reps: list = []
    raws: dict = {}
    by_key: dict = {}
    for s, key in zip(srcs, keys):
        cands = by_key.setdefault(key, [])
        u = None
        if cands:
            raw = flat[s].tobytes()
            for c in cands:
                if c not in raws:
                    raws[c] = flat[reps[c]].tobytes()
                if raws[c] == raw:
                    u = c
                    break
        if u is None:
            u = len(reps)
            reps.append(s)
            cands.append(u)
        ids.append(u)
    return ids, reps


def vm_groups(leaves: list, scratch: list, tape_len: int,
              limit: int = VM_SMEM_LIMIT) -> list:
    """Cut a launch's queries, in order, into K3's query groups:
    ``leaves[q]`` the distinct leaf ids of query q's live slots,
    ``scratch[q]`` its scratch registers.  A query joins the group before
    it while that group's block still fits ``limit``
    (``vm_group_smem_bytes``); otherwise it starts a group.  Returns
    (first query, queries) per group."""
    groups = []
    start, members, scr = 0, set(), 0
    for q, (ls, s) in enumerate(zip(leaves, scratch)):
        grown, grown_scr = members.union(ls), max(scr, s)
        if q > start and vm_group_smem_bytes(
                len(grown), grown_scr, q - start + 1, tape_len) > limit:
            groups.append((start, q - start))
            start, grown, grown_scr = q, set(ls), s
        members, scr = grown, grown_scr
    groups.append((start, len(leaves) - start))
    return groups


class VMPlan(NamedTuple):
    """K3's launch plan (``vm_plan``)."""

    #: int32: per query its plan row with each slot's group-local leaf,
    #: per group (first query, queries, first leaf, leaves, scratch), per
    #: distinct leaf l * B + q of a live slot naming it (vm_counts.cu)
    meta: torch.Tensor
    tape_len: int
    n_groups: int
    #: distinct leaves, summed over the groups
    n_leaves: int
    #: int4 vectors per thread and pass (``VM_VECS``)
    vec: int
    #: dynamic shared memory of the launch's largest block
    smem: int


def vm_plan(prog: torch.Tensor, gidx: torch.Tensor,
            vec: int | None = None) -> VMPlan:
    """What K3 reads besides the pool and ``gidx`` for a checked program
    ``prog`` int32[B, T, 3] over ``gidx`` int32[L, B, D], planned on the
    host: each query's live instructions and slots (``_query_plan``,
    cached by the tape's bytes), the distinct leaves among the live
    slots' directory vectors ``gidx[l, q, :]``, query groups whose
    blocks fit ``VM_SMEM_LIMIT`` at one vector per thread and pass
    (``vm_groups``), and the first of ``VM_VECS`` at which every group
    still fits (or ``vec``, where they fit).  A ``gidx`` on the card is
    copied to the host once for it.  ``meta`` is on the CPU."""
    n_q, tape_len, _ = prog.shape
    slots, _, domain = gidx.shape
    prog_np = prog.to("cpu").numpy()
    flat = gidx.to("cpu").numpy().reshape(slots * n_q, domain)
    queries = [_query_plan(prog_np[q].tobytes(), tape_len, slots)
               for q in range(n_q)]
    srcs = [l * n_q + q for q, (_r, live, _s) in enumerate(queries)
            for l in live]
    ids, reps = _distinct_rows(flat, srcs)
    leaves, pos = [], 0
    for _row, live, _s in queries:
        leaves.append(ids[pos:pos + len(live)])
        pos += len(live)
    rows = np.stack([row for row, _l, _s in queries])
    rows[:, 2 + tape_len:] = -1
    groups, leaf_src, local_ids = [], [], []
    for q0, nq in vm_groups(leaves, [s for _r, _l, s in queries], tape_len):
        local: dict = {}
        for q in range(q0, q0 + nq):
            local_ids.extend(local.setdefault(u, len(local))
                             for u in leaves[q])
        scratch = max(queries[q][2] for q in range(q0, q0 + nq))
        groups.append((q0, nq, len(leaf_src), len(local), scratch))
        leaf_src.extend(reps[u] for u in local)
    src = np.asarray(srcs, dtype=np.int64)
    rows[src % n_q, 2 + tape_len + src // n_q] = local_ids
    meta = np.concatenate([rows.ravel(),
                           np.asarray(groups, dtype=np.int32).ravel(),
                           np.asarray(leaf_src, dtype=np.int32)])
    for width in (vec,) if vec else VM_VECS:
        smem = max(vm_group_smem_bytes(nu, scratch, nq, tape_len, width)
                   for _q0, nq, _u0, nu, scratch in groups)
        if smem <= VM_SMEM_LIMIT:
            break
    else:
        raise ValueError(f"K3's query groups do not fit {vec} vectors per "
                         f"thread")
    return VMPlan(torch.from_numpy(meta), tape_len, len(groups),
                  len(leaf_src), width, smem)


def _vm_launch(pool: torch.Tensor, gidx: torch.Tensor, plan: VMPlan
               ) -> torch.Tensor:
    """Launch K3 on tensors already checked and on the pool's card:
    ``gidx`` int32[L, B, D] and ``plan = vm_plan(prog, gidx)`` with its
    ``meta`` on that card."""
    slots, n_q, domain = gidx.shape
    out = torch.empty((n_q, domain), dtype=torch.int32, device=pool.device)
    if out.numel() == 0:
        return out
    launch = _launcher("vm_counts")
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = launch(pool.data_ptr(), gidx.data_ptr(), plan.meta.data_ptr(),
                    out.data_ptr(), n_q, plan.tape_len, slots, domain,
                    plan.n_groups, plan.vec, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"vm_counts launch failed: CUDA error {rc}")
    return out


def vm_counts(pool: torch.Tensor, prog: torch.Tensor,
              gidx: torch.Tensor) -> torch.Tensor:
    """Per-cell popcounts int32[B, D] of a batch of op-tapes
    (``prog`` int32[B, T, 3]) over one pooled operand (``pool``
    int32[R, 2048]) gathered through ``gidx`` int32[L, B, D].  A CUDA
    pool launches K3 after planning the launch on the host
    (``vm_plan``) and copying the plan and a host-built ``gidx`` to its
    card; a CPU pool computes ``vm_counts_plain``.  Ticks no dispatch:
    the caller (ops/tape.execute_vm) owns the one ``vm`` tick, as in the
    reference."""
    _check_vm(pool, prog, gidx)
    if pool.device.type != "cuda":
        return vm_counts_plain(pool, prog, gidx)
    n_q = int(prog.shape[0])
    domain = int(gidx.shape[2])
    if n_q * domain == 0:
        return torch.empty((n_q, domain), dtype=torch.int32,
                           device=pool.device)
    plan = vm_plan(prog, gidx)
    out = _vm_launch(pool, gidx.to(pool.device),
                     plan._replace(meta=plan.meta.to(pool.device)))
    _count(vm_counts)
    return out


vm_counts.launches = 0


# -------------------------------------------------------------- K3-kinds


def _check_kinds(bpool: torch.Tensor, apool: torch.Tensor,
                 acard: torch.Tensor, rpool: torch.Tensor,
                 prog: torch.Tensor, gidx: torch.Tensor) -> None:
    """Types, layout, shapes and values of a K3-kinds call: the bitmap
    pool as K3's, int16 array rows [Ra, acap] with int32 [Ra]
    cardinalities in [0, acap], int16 run rows [Rr, 2 * rcap], all on
    one device, and the program over Rb + Ra + Rr virtual rows."""
    dev = bpool.device
    for name, t, dtype in (("bpool", bpool, torch.int32),
                           ("apool", apool, torch.int16),
                           ("acard", acard, torch.int32),
                           ("rpool", rpool, torch.int16)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bpool on {dev}")
    _check_pool("bpool", bpool)
    if apool.dim() != 2 or apool.shape[1] == 0:
        raise ValueError(f"apool must be [Ra, acap >= 1], got "
                         f"{tuple(apool.shape)}")
    if acard.shape != (apool.shape[0],):
        raise ValueError(f"acard must be [{apool.shape[0]}], got "
                         f"{tuple(acard.shape)}")
    if rpool.dim() != 2 or rpool.shape[1] == 0 or rpool.shape[1] % 2:
        raise ValueError(f"rpool must be [Rr, 2 * rcap >= 2], got "
                         f"{tuple(rpool.shape)}")
    if acard.numel():
        lo, hi = torch.aminmax(acard)
        if int(lo) < 0 or int(hi) > apool.shape[1]:
            raise ValueError(f"acard entries must lie in [0, "
                             f"{apool.shape[1]}], got [{int(lo)}, {int(hi)}]")
    rows = int(bpool.shape[0]) + int(apool.shape[0]) + int(rpool.shape[0])
    if rows >= 2 ** 31:
        raise ValueError("too many rows for int32 indices")
    _check_program(prog, gidx, rows, dev, vm_kinds_smem_bytes)


def vm_counts_kinds_plain(bpool: torch.Tensor, apool: torch.Tensor,
                          acard: torch.Tensor, rpool: torch.Tensor,
                          prog: torch.Tensor, gidx: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version of K3-kinds, the reference's function written
    out: decode the array and run pools with the plain torch decode
    (ops/kindpools.py), put them behind the bitmap rows, run
    ``vm_counts_plain``."""
    pool = torch.cat([bpool, kp.decode_array(apool, acard),
                      kp.decode_runs(rpool)])
    return vm_counts_plain(pool, prog, gidx)


def vm_tape_plan(tape, slots: int) -> tuple[list, list, int]:
    """The tape plan of K3 and K3-kinds for one query's absolute
    instructions ``tape`` [(op, a, b), ...] over ``slots`` leaf slots: a
    COPY's register aliases its operand, and only what the result reaches
    runs (ops/tape.py pads tapes with COPYs and pads slots onto the zero
    row).
    Returns the live instructions as (op, a, b, dst) in order, the live
    leaf slots and the result register, which is the last live
    instruction's ``dst`` or, when none is live, a leaf slot."""
    alias = list(range(slots))
    planned = []
    for t, (op, a, b) in enumerate(tape):
        a, b = alias[a], alias[b]
        alias.append(a if op == 4 else slots + t)
        planned.append((op, a, b, slots + t))
    result = alias[-1]
    live = {result}
    for op, a, b, dst in reversed(planned):
        if dst in live:
            live.update((a, b))
    return ([ins for ins in planned if ins[3] in live],
            sorted(r for r in live if r < slots), result)


@functools.lru_cache(maxsize=4096)
def _plan_row(tape: bytes, tape_len: int, slots: int) -> np.ndarray:
    """One query's row of ``vm_kinds_plan``, from its int32 [T, 3]
    instructions as bytes."""
    instrs = np.frombuffer(tape, dtype=np.int32).reshape(tape_len, 3)
    live_ins, live_slots, result = vm_tape_plan(instrs.tolist(), slots)
    row = np.zeros(2 + tape_len + slots, dtype=np.uint32)
    row[0], row[1] = len(live_ins), result
    for i, (op, a, b, dst) in enumerate(live_ins):
        row[2 + i] = op | a << 8 | b << 16 | dst << 24
    row[2 + tape_len + np.asarray(live_slots, dtype=np.int64)] = 1
    row = row.view(np.int32)
    row.flags.writeable = False
    return row


def vm_kinds_plan(prog: torch.Tensor, slots: int) -> torch.Tensor:
    """What K3-kinds reads for a program ``prog`` int32[B, T, 3] over
    ``slots`` leaf slots, planned on the host (``vm_tape_plan``): per
    query int32[2 + T + L] holding the live instruction count n, the
    result register, the n live instructions packed ``op | a << 8 | b <<
    16 | dst << 24`` (zeros after them) and 1 for each leaf slot the
    result reaches (0 for the rest, which the kernel neither loads nor
    decodes).  On the CPU."""
    n_q, tape_len, _ = prog.shape
    prog_np = prog.to("cpu").numpy()
    plan = np.zeros((n_q, 2 + tape_len + slots), dtype=np.int32)
    for q in range(n_q):
        plan[q] = _plan_row(prog_np[q].tobytes(), tape_len, slots)
    return torch.from_numpy(plan)


def _vm_kinds_launch(bpool: torch.Tensor, apool: torch.Tensor,
                     acard: torch.Tensor, rpool: torch.Tensor,
                     plan: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Launch K3-kinds on tensors already checked and on one card, with
    ``plan = vm_kinds_plan(prog, L)`` on that card."""
    n_q = int(plan.shape[0])
    slots, _, domain = gidx.shape
    tape_len = int(plan.shape[1]) - 2 - slots
    out = torch.empty((n_q, domain), dtype=torch.int32, device=bpool.device)
    if out.numel() == 0:
        return out
    launch = _launcher("vm_counts_kinds")
    with torch.cuda.device(bpool.device):
        stream = torch.cuda.current_stream(bpool.device).cuda_stream
        rc = launch(bpool.data_ptr(), apool.data_ptr(), acard.data_ptr(),
                    rpool.data_ptr(), plan.data_ptr(), gidx.data_ptr(),
                    out.data_ptr(), int(bpool.shape[0]),
                    int(apool.shape[0]), int(apool.shape[1]),
                    int(rpool.shape[1]) // 2, n_q, tape_len, slots, domain,
                    stream)
    if rc != 0:
        raise RuntimeError(f"vm_counts_kinds launch failed: CUDA error {rc}")
    return out


def vm_counts_kinds(bpool: torch.Tensor, apool: torch.Tensor,
                    acard: torch.Tensor, rpool: torch.Tensor,
                    prog: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Per-cell popcounts int32[B, D] of a batch of op-tapes over a
    kind-split megapool (ops/containers.MegaPools): ``gidx`` int32[L, B,
    D] addresses bitmap rows ``[0, Rb)``, array rows ``[Rb, Rb + Ra)``
    and run rows after them.  CUDA pools launch K3-kinds, after copying a
    host-built ``prog``/``gidx`` to their card; CPU pools compute
    ``vm_counts_kinds_plain``.  Ticks no dispatch: the caller
    (ops/tape.execute_vm) owns the one ``vm`` tick."""
    _check_kinds(bpool, apool, acard, rpool, prog, gidx)
    if bpool.device.type != "cuda":
        return vm_counts_kinds_plain(bpool, apool, acard, rpool, prog, gidx)
    plan = vm_kinds_plan(prog, int(gidx.shape[0]))
    out = _vm_kinds_launch(bpool, apool, acard, rpool,
                           plan.to(bpool.device), gidx.to(bpool.device))
    if out.numel():
        _count(vm_counts_kinds)
    return out


vm_counts_kinds.launches = 0


# ------------------------------------------------------------- K4, K5


def _check_words(name: str, t: torch.Tensor, dev: torch.device) -> None:
    """An int32, contiguous 2-D word matrix on ``dev``."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, mat on {dev}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be [rows, words], got "
                         f"{tuple(t.shape)}")
    if t.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for one launch")


def _check_pair(mat: torch.Tensor, name: str, other: torch.Tensor) -> None:
    _check_words("mat", mat, mat.device)
    _check_words(name, other, mat.device)
    words = mat.shape[1]
    if other.shape[1] != words:
        raise ValueError(f"{name} has {other.shape[1]} words per row, mat "
                         f"{words}")
    if not 0 < words <= MAX_WORDS:
        raise ValueError(f"rows of {words} words: K4 and K5 take 1 to "
                         f"{MAX_WORDS}")
    if other.shape[0] == 0:
        raise ValueError(f"{name} has no rows")


def row_counts_masked(mat: torch.Tensor, filt_stack: torch.Tensor,
                      filt_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row ``|mat[r] & filt_stack[i]|`` -> int32[R], ``i =
    filt_idx[r]`` or 0 without an index.  CUDA tensors launch K4; CPU
    tensors compute ``bitmap.row_counts_masked_plain``.  Ticks no
    dispatch: the callers in ops/bitmap.py own it."""
    _check_pair(mat, "filt_stack", filt_stack)
    if filt_idx is not None:
        if filt_idx.dtype != torch.int32:
            raise TypeError(f"filt_idx must be int32, got {filt_idx.dtype}")
        if not filt_idx.is_contiguous():
            raise ValueError("filt_idx must be contiguous")
        if filt_idx.device != mat.device:
            raise ValueError(f"filt_idx is on {filt_idx.device}, mat on "
                             f"{mat.device}")
        if filt_idx.shape != (mat.shape[0],):
            raise ValueError(f"filt_idx must be [{mat.shape[0]}], got "
                             f"{tuple(filt_idx.shape)}")
        if filt_idx.numel():
            lo, hi = torch.aminmax(filt_idx)
            if int(lo) < 0 or int(hi) >= filt_stack.shape[0]:
                raise IndexError(f"filt_idx entries must lie in [0, "
                                 f"{filt_stack.shape[0]}), got "
                                 f"[{int(lo)}, {int(hi)}]")
    if mat.device.type != "cuda":
        return bm.row_counts_masked_plain(mat, filt_stack, filt_idx)
    out = _row_counts_launch(mat, filt_stack, filt_idx)
    if out.numel():
        _count(row_counts_masked)
    return out


def _row_counts_launch(mat: torch.Tensor, filt_stack: torch.Tensor,
                       filt_idx: torch.Tensor | None) -> torch.Tensor:
    """Launch K4 on tensors already checked and on one card."""
    rows, words = mat.shape
    out = torch.empty(rows, dtype=torch.int32, device=mat.device)
    if rows == 0:
        return out
    vec = (words % 4 == 0 and mat.data_ptr() % 16 == 0
           and filt_stack.data_ptr() % 16 == 0)
    launch = _launcher("row_counts_masked")
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        rc = launch(mat.data_ptr(), filt_stack.data_ptr(),
                    None if filt_idx is None else filt_idx.data_ptr(),
                    out.data_ptr(), rows, words, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"row_counts_masked launch failed: CUDA error "
                           f"{rc}")
    return out


row_counts_masked.launches = 0


def masked_matrix_counts(mat: torch.Tensor, masks: torch.Tensor
                         ) -> torch.Tensor:
    """``out[g, r] = |mat[r] & masks[g]|`` -> int32[G, R].  CUDA tensors
    launch K5; CPU tensors compute
    ``bitmap.masked_matrix_counts_plain``.  Ticks no dispatch: the
    caller in ops/bitmap.py owns it."""
    _check_pair(mat, "masks", masks)
    if masks.shape[0] > 65535 * 32:
        raise ValueError(f"{masks.shape[0]} masks: K5 takes at most "
                         f"{65535 * 32}")
    if mat.device.type != "cuda":
        return bm.masked_matrix_counts_plain(mat, masks)
    out = _mmc_launch(mat, masks)
    if out.numel():
        _count(masked_matrix_counts)
    return out


def _mmc_launch(mat: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Launch K5 on tensors already checked and on one card."""
    rows, words = mat.shape
    groups = masks.shape[0]
    out = torch.empty((groups, rows), dtype=torch.int32, device=mat.device)
    if rows == 0:
        return out
    launch = _launcher("masked_matrix_counts")
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        rc = launch(mat.data_ptr(), masks.data_ptr(), out.data_ptr(), rows,
                    groups, words, stream)
    if rc != 0:
        raise RuntimeError(f"masked_matrix_counts launch failed: CUDA error "
                           f"{rc}")
    return out


masked_matrix_counts.launches = 0


# ------------------------------------------------------------------ K6

#: widest predicate the kernel's two 32-bit limbs hold
MAX_BSI_DEPTH = 64


def _check_bsi(planes: torch.Tensor, cons: torch.Tensor, upred: int,
               depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Types, layout and shapes of a K6 call -> (planes as [S, 2 + depth,
    W], cons as [S, W]); a single fragment's [2 + depth, W] planes and
    [W] row are viewed as S = 1."""
    for name, t in (("planes", planes), ("cons", cons)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cons.device != planes.device:
        raise ValueError(f"cons is on {cons.device}, planes on "
                         f"{planes.device}")
    if not 0 <= depth <= MAX_BSI_DEPTH:
        raise ValueError(f"depth {depth} outside 0..{MAX_BSI_DEPTH}")
    if not 0 <= upred < 1 << 64:
        raise ValueError(f"predicate magnitude {upred} outside the two "
                         f"32-bit limbs")
    if planes.dim() == 2:
        planes = planes.unsqueeze(0)
    if planes.dim() != 3 or planes.shape[1] != 2 + depth:
        raise ValueError(f"planes must be [S, {2 + depth}, W], got "
                         f"{tuple(planes.shape)}")
    shards, _, words = planes.shape
    if cons.dim() == 1:
        cons = cons.unsqueeze(0)
    if tuple(cons.shape) != (shards, words):
        raise ValueError(f"cons must be [{shards}, {words}], got "
                         f"{tuple(cons.shape)}")
    if shards >= 2 ** 31:
        raise ValueError("too many shards for one launch")
    return planes, cons


def bsi_compare_plain(planes: torch.Tensor, cons: torch.Tensor, upred: int,
                      depth: int, form: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K6, the ripple in torch int32 bit ops:
    ``(lt, gt)`` among ``cons`` (or exists & ~sign & cons with
    ``form``) against the low ``depth`` bits of ``upred``.  Planes are
    [..., 2 + depth, W], ``cons`` [..., W]."""
    consider = cons
    if form:
        consider = planes[..., 0, :] & ~planes[..., 1, :] & cons
    lt = torch.zeros_like(consider)
    gt = torch.zeros_like(consider)
    eq = consider
    for i in range(depth - 1, -1, -1):
        plane = planes[..., 2 + i, :]
        if (upred >> i) & 1:
            lt = lt | (eq & ~plane)
            eq = eq & plane
        else:
            gt = gt | (eq & plane)
            eq = eq & ~plane
    return lt, gt


def _bsi_launch(planes: torch.Tensor, cons: torch.Tensor, upred: int,
                depth: int, form: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on tensors already checked (3-D planes, 2-D cons) and
    on one card."""
    shards, nplanes, words = planes.shape
    lt = torch.empty((shards, words), dtype=torch.int32,
                     device=planes.device)
    gt = torch.empty_like(lt)
    if lt.numel() == 0:
        return lt, gt
    vec = (words % 4 == 0 and planes.data_ptr() % 16 == 0
           and cons.data_ptr() % 16 == 0)
    launch = _launcher("bsi_compare")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = launch(planes.data_ptr(), cons.data_ptr(), lt.data_ptr(),
                    gt.data_ptr(), shards, nplanes, words, depth,
                    upred & 0xFFFFFFFF, (upred >> 32) & 0xFFFFFFFF,
                    int(form), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"bsi_compare launch failed: CUDA error {rc}")
    return lt, gt


def _bsi(planes, cons, upred, depth, form):
    squeeze = planes.dim() == 2
    planes3, cons2 = _check_bsi(planes, cons, upred, depth)
    if planes.device.type != "cuda":
        lt, gt = bsi_compare_plain(planes3, cons2, upred, depth, form)
    else:
        lt, gt = _bsi_launch(planes3, cons2, upred, depth, form)
        if lt.numel():
            _count(bsi_compare)
    if squeeze:
        return lt[0], gt[0]
    return lt, gt


def bsi_compare(planes: torch.Tensor, cons: torch.Tensor, upred: int,
                depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lt, gt)`` int32[S, W]: the columns of ``cons`` whose magnitude
    in ``planes`` (int32[S, 2 + depth, W], or one fragment's [2 + depth,
    W] with a [W] row) is strictly below / above the low ``depth`` bits
    of ``upred``.  One launch covers every shard.  CUDA tensors launch
    K6; CPU tensors compute ``bsi_compare_plain``.  Ticks no dispatch:
    the caller in ops/bsi.py owns it."""
    return _bsi(planes, cons, upred, depth, False)


def bsi_compare_unsigned(planes: torch.Tensor, filt: torch.Tensor,
                         upred: int, depth: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas entry's function (pilosa_tpu/ops/pallas_kernels.py:
    760): ``(lt, gt)`` among the non-null, non-negative columns of
    ``filt``, consider = exists & ~sign & filt formed in the kernel.  A
    predicate of ``2^depth`` or more is above every value: all considered
    columns are lt, with no launch."""
    if upred < 0:
        raise ValueError("predicate magnitude must be non-negative")
    if upred >= 1 << depth:
        planes3, filt2 = _check_bsi(planes, filt, 0, depth)
        consider = planes3[:, 0] & ~planes3[:, 1] & filt2
        if planes.dim() == 2:
            consider = consider[0]
        return consider, torch.zeros_like(consider)
    return _bsi(planes, filt, upred, depth, True)


bsi_compare.launches = 0


# ------------------------------------------------------------------ K1


def _check_count_and(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() not in (1, 2):
            raise ValueError(f"{name} must be [words] or [rows, words], got "
                             f"{tuple(t.shape)}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}'s words must be contiguous")
    if a.shape != b.shape:
        raise ValueError(f"a is {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")


def count_and_plain(a: torch.Tensor, b: torch.Tensor) -> int:
    """The plain version of K1: the int64 SWAR popcount of ``a & b``,
    summed."""
    return int(bm.popcount_elems(a & b).sum())


def _count_and_launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on tensors already checked and on one card -> the count
    as an int64[1] tensor on the card."""
    out = torch.zeros(1, dtype=torch.int64, device=a.device)
    if a.numel() == 0:
        return out
    a2 = a if a.dim() == 2 else a.unsqueeze(0)
    b2 = b if b.dim() == 2 else b.unsqueeze(0)
    rows, words = a2.shape
    sa, sb = a2.stride(0), b2.stride(0)
    vec = (words % 4 == 0 and sa % 4 == 0 and sb % 4 == 0
           and a2.data_ptr() % 16 == 0 and b2.data_ptr() % 16 == 0)
    launch = _launcher("count_and")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = launch(a2.data_ptr(), sa, b2.data_ptr(), sb, rows, words,
                    out.data_ptr(), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"count_and launch failed: CUDA error {rc}")
    return out


def count_and(a: torch.Tensor, b: torch.Tensor) -> int:
    """``|a & b|`` of two equal-shaped int32 word tensors ([words], or
    [rows, words] with any row stride, such as one plane of a plane
    stack), exact at any size.  CUDA tensors launch K1; CPU tensors
    compute ``count_and_plain``.  Ticks no dispatch: the caller
    (``bitmap.popcount_and``) owns it."""
    _check_count_and(a, b)
    if a.device.type != "cuda":
        return count_and_plain(a, b)
    out = _count_and_launch(a, b)
    if a.numel():
        _count(count_and)
    return int(out.item())


count_and.launches = 0


# ------------------------------------------------------------- accounting

_KERNELS = (gathered_count_and, vm_counts, vm_counts_kinds,
            row_counts_masked, masked_matrix_counts, bsi_compare, count_and)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    with _count_lock:
        return {k.__name__: k.launches for k in _KERNELS}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _KERNELS:
            k.launches = 0
