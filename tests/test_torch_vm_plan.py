"""K3's host plan (``cuda_kernels.vm_plan``) on the CPU: the plan, the
leaf map and the query groups, read by a small plain-torch reader that
does what vm_counts.cu does with them, against the port's
``vm_counts_plain`` and the JAX package's numpy twin ``_vm_counts_host``
and Pallas kernel ``_vm_counts_pallas(interpret=True)`` on the same numpy
inputs (tests/torch_vm_cases.py), with no tolerance.  Then the group
sizing: for every (L, T) that ``vm_smem_bytes`` admits and up to 32
queries, groups of at least one query that fit ``VM_SMEM_LIMIT``, and
admission that takes every shape the first K3 design took.

No process-wide setting is touched."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck

# tests/ is on sys.path under pytest (rootdir-less test files); another
# installed package may be named ``tests``
import torch_vm_cases as cases  # noqa: E402

CASES = {label: (pool, prog, gidx)
         for label, pool, prog, gidx in cases.k3_cases(90, domain=3)}
#: the JAX Pallas kernel in interpret mode is slow at the widest shape
PALLAS_DOMAIN = {"l64t32": 1}


def _unpack(plan: ck.VMPlan, n_q: int, slots: int) -> tuple:
    """(rows [B, 2 + T + L], groups [G, 5], leaf sources [U]) of
    ``plan.meta``, as vm_counts.cu lays them out."""
    meta = plan.meta.numpy()
    row_len = 2 + plan.tape_len + slots
    rows = meta[:n_q * row_len].reshape(n_q, row_len)
    groups = meta[n_q * row_len:n_q * row_len + 5 * plan.n_groups]
    leaf_src = meta[n_q * row_len + 5 * plan.n_groups:]
    assert len(leaf_src) == plan.n_leaves
    return rows, groups.reshape(plan.n_groups, 5), leaf_src


def _read_plan(pool: torch.Tensor, gidx: np.ndarray,
               plan: ck.VMPlan) -> np.ndarray:
    """K3's counts as the kernel reads its plan: per query group, the
    group's distinct leaves gathered once over the domain, then each
    query's live instructions with registers renamed as the block renames
    them (a slot to its group-local leaf, an output to a scratch register
    past the leaves), and the result popcounted.  Checks on the way what
    the kernel takes for granted."""
    slots, n_q, domain = gidx.shape
    tape_len = plan.tape_len
    rows, groups, leaf_src = _unpack(plan, n_q, slots)
    flat = gidx.reshape(slots * n_q, domain)
    out = np.full((n_q, domain), -1, dtype=np.int64)
    next_q = 0
    for q0, nq, u0, nu, scratch in groups.tolist():
        assert q0 == next_q and nq >= 1  # groups cover the batch in order
        next_q += nq
        assert ck.vm_group_smem_bytes(nu, scratch, nq, tape_len,
                                      plan.vec) \
            <= plan.smem <= ck.VM_SMEM_LIMIT
        srcs = leaf_src[u0:u0 + nu]
        # each container of the group read once: no two leaves are equal
        assert len({flat[s].tobytes() for s in srcs}) == nu
        regs: list = [pool.index_select(0, torch.from_numpy(
            flat[s].astype(np.int64))) for s in srcs] + [None] * scratch
        for q in range(q0, q0 + nq):
            n, res = (int(v) for v in rows[q, :2])
            lmap = rows[q, 2 + tape_len:]
            for l in range(slots):  # a live slot names its leaf's rows
                if lmap[l] >= 0:
                    assert 0 <= lmap[l] < nu
                    assert np.array_equal(gidx[l, q], flat[srcs[lmap[l]]])

            def rename(r: int) -> int:
                if r < slots:
                    assert lmap[r] >= 0
                    return int(lmap[r])
                return nu + r - slots

            result = regs[rename(res)] if n == 0 else None
            tape = rows[q, 2:2 + tape_len].view(np.uint32)
            assert not tape[n:].any()
            for i, ins in enumerate(tape[:n].tolist()):
                op, a, b = ins & 0x0f, ins >> 8 & 0xff, ins >> 16 & 0xff
                # a from the thread's registers: the previous output
                if ins & ck.VM_PREV:
                    assert i > 0
                    xa = result
                else:
                    xa = regs[rename(a)]
                xb = regs[rename(b)]
                assert xa is not None and xb is not None
                result = (xa & xb, xa | xb, xa ^ xb, xa & ~xb)[op]
                if ins & ck.VM_STORE:  # read again: a scratch register
                    dst = rename(ins >> 24)
                    assert i < n - 1 and nu <= dst < nu + scratch
                    regs[dst] = result
            out[q] = tbm.row_counts_plain(result).numpy()
    assert next_q == n_q and (out >= 0).all()
    return out


def _plan(prog: np.ndarray, gidx: np.ndarray) -> ck.VMPlan:
    return ck.vm_plan(torch.from_numpy(prog), torch.from_numpy(gidx))


@pytest.mark.parametrize("label", list(CASES))
def test_the_plan_read_as_the_kernel_reads_it_matches_every_twin(label):
    pool, prog, gidx = CASES[label]
    tpool = tbm.to_tensor(pool)
    got = _read_plan(tpool, gidx, _plan(prog, gidx))
    plain = ck.vm_counts_plain(tpool, torch.from_numpy(prog),
                               torch.from_numpy(gidx)).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, pk._vm_counts_host(pool, prog, gidx))
    d = PALLAS_DOMAIN.get(label, gidx.shape[2])
    import jax.numpy as jnp

    pal = np.asarray(pk._vm_counts_pallas(jnp.asarray(pool), prog,
                                          gidx[:, :, :d], interpret=True))
    assert np.array_equal(got[:, :d], pal)


def test_queries_that_share_rows_share_leaves():
    # 16 trees over five rows: 44 live slots, five distinct leaves
    _pool, prog, gidx = CASES["shared"]
    plan = _plan(prog, gidx)
    assert (plan.n_groups, plan.n_leaves) == (1, 5)
    # every second instruction reads the first's output as its operand
    # a, from the thread's registers: no scratch register; two vectors
    # per thread, two passes
    assert plan.vec == 2
    assert plan.smem == ck.vm_group_smem_bytes(5, 0, 16, 4, 2)
    rows, groups, _src = _unpack(plan, 16, gidx.shape[0])
    assert int((rows[:, 2 + plan.tape_len:] >= 0).sum()) == 44
    assert groups.tolist() == [[0, 16, 0, 5, 0]]
    # one row in two slots of a query is one leaf
    _pool, prog, gidx = CASES["same_row"]
    plan = _plan(prog, gidx)
    rows, _g, _src = _unpack(plan, 2, gidx.shape[0])
    assert plan.n_leaves == 3
    assert rows[0, 2 + plan.tape_len:2 + plan.tape_len + 2].tolist() \
        == [0, 0]


def test_pad_queries_slots_and_copies_do_no_work():
    _pool, prog, gidx = CASES["pads"]
    plan = _plan(prog, gidx)
    rows, groups, _src = _unpack(plan, 4, gidx.shape[0])
    tape_len = plan.tape_len
    assert tape_len == 8 and prog.shape[0] == 4
    # live instructions: AND; ANDNOT(OR(...)); the lone Row and the pad
    # query none, their result a leaf
    assert rows[:, 0].tolist() == [1, 2, 0, 0]
    lmap = rows[:, 2 + tape_len:]
    assert (lmap[:, 3:] == -1).all()  # pad slots
    assert (lmap[2:, 1:] == -1).all() and (lmap[2:, 0] >= 0).all()
    # rows 0, 1, 2, 3 of the case and the pad query's zero row; the OR's
    # output is the ANDNOT's operand a, held by the thread
    assert plan.n_leaves == 5 and groups[0, 4] == 0
    assert rows[1, 3] & ck.VM_PREV and not rows[1, 2] & ck.VM_STORE


def test_a_batch_whose_leaves_do_not_fit_one_block_is_grouped():
    _pool, prog, gidx = CASES["grouped"]
    plan = _plan(prog, gidx)
    _rows, groups, _src = _unpack(plan, 8, 16)
    # 16 leaves a query, each output read only as the next operand a (no
    # scratch register): seven queries fit a block (112 registers), the
    # eighth starts another
    assert groups[:, 1].tolist() == [7, 1]
    assert groups[:, 3].tolist() == [112, 16]
    assert (groups[:, 4] == 0).all()
    assert plan.vec == 1
    assert plan.smem == ck.vm_group_smem_bytes(112, 0, 7, 32)


def _admitted():
    """Every (L, T) that ``vm_smem_bytes`` admits."""
    limit = ck.VM_SMEM_LIMIT
    return [(slots, tape_len) for tape_len in range(1, 128)
            for slots in range(1, 128)
            if ck.vm_smem_bytes(tape_len, slots) <= limit]


def _check_groups(groups, leaves, scratch, tape_len):
    assert groups[0][0] == 0
    for (q0, nq), nxt in zip(groups, groups[1:] + [(len(leaves), 0)]):
        assert nq >= 1 and q0 + nq == nxt[0]
        members = set().union(*leaves[q0:q0 + nq])
        assert ck.vm_group_smem_bytes(len(members), max(scratch[q0:q0 + nq]),
                                      nq, tape_len) <= ck.VM_SMEM_LIMIT


def test_every_admitted_shape_groups_into_blocks_that_fit():
    admitted = _admitted()
    assert (16, 32) in admitted and (64, 32) in admitted
    assert max(l + t for l, t in admitted) == 113
    for slots, tape_len in admitted:
        # up to 32 queries, each with every slot live and a scratch
        # register per instruction: all leaves distinct, or all shared
        distinct = [list(range(q * slots, (q + 1) * slots))
                    for q in range(32)]
        shared = [list(range(slots))] * 32
        for leaves in (distinct, shared):
            scratch = [tape_len] * 32
            groups = ck.vm_groups(leaves, scratch, tape_len)
            _check_groups(groups, leaves, scratch, tape_len)
    for slots, tape_len in ((16, 32), (64, 32), (1, 112), (112, 1)):
        for n_q in range(1, 33):
            leaves = [list(range(q * slots, (q + 1) * slots))
                      for q in range(n_q)]
            scratch = [tape_len] * n_q
            _check_groups(ck.vm_groups(leaves, scratch, tape_len), leaves,
                          scratch, tape_len)


def test_random_batches_group_into_blocks_that_fit():
    rng = np.random.default_rng(91)
    for _ in range(300):
        slots, tape_len = (int(v) for v in rng.integers(1, 64, size=2))
        if ck.vm_smem_bytes(tape_len, slots) > ck.VM_SMEM_LIMIT:
            continue
        n_q = int(rng.integers(1, 33))
        leaves = [sorted(set(rng.integers(0, 3 * slots, size=int(
            rng.integers(1, slots + 1))).tolist())) for _ in range(n_q)]
        scratch = rng.integers(0, tape_len + 1, size=n_q).tolist()
        _check_groups(ck.vm_groups(leaves, scratch, tape_len), leaves,
                      scratch, tape_len)


def test_admission_takes_every_shape_the_first_design_took():
    limit = ck.VM_SMEM_LIMIT
    for slots, tape_len in ((s, t) for t in range(1, 128)
                            for s in range(1, 128)):
        first = (slots + tape_len) * 128 * 16 + (3 * tape_len + slots) * 4
        if first <= limit:
            assert ck.vm_smem_bytes(tape_len, slots) <= limit
    # the wrapper refuses past it before any plan or launch
    with pytest.raises(ValueError, match="shared memory"):
        ck.vm_counts(tbm.to_tensor(np.zeros((2, ck.CONTAINER_WORDS),
                                            dtype=np.uint32)),
                     torch.zeros((1, 50, 3), dtype=torch.int32),
                     torch.zeros((64, 1, 1), dtype=torch.int32))


def test_leaves_that_agree_only_where_sampled_stay_distinct():
    """The leaf map keys each directory vector by its first and last
    entries and compares vectors of one key in full: vectors that agree
    on those entries but not elsewhere are two leaves, and the plan still
    counts exactly."""
    rng = np.random.default_rng(93)
    pool = rng.integers(0, 2 ** 32, size=(8, ck.CONTAINER_WORDS),
                        dtype=np.uint32)
    pool[-1] = 0
    # four queries, AND of slots 0 and 1, over a domain of 9
    gidx = np.zeros((2, 4, 9), dtype=np.int32)
    gidx[1] = 1
    gidx[0, 1, 1] = 5     # agrees with query 0's slot 0 at both ends
    gidx[0, 2] = gidx[0, 1]
    gidx[0, 3, 4] = 6
    prog = np.zeros((4, 1, 3), dtype=np.int32)
    prog[:, 0] = (0, 0, 1)
    plan = _plan(prog, gidx)
    assert plan.n_leaves == 4  # row 0, the two altered vectors, row 1
    got = _read_plan(tbm.to_tensor(pool), gidx, plan)
    assert np.array_equal(got, pk._vm_counts_host(pool, prog, gidx))


def test_outputs_read_again_are_stored_and_the_rest_stay_in_registers():
    # ANDNOT(slot 2, OR(slot 0, slot 1)): the OR is the ANDNOT's b, so it
    # is stored; XOR(OR(0, 1), slot 2) swaps to keep the OR as operand a
    prog = np.array([[(1, 0, 1), (3, 2, 4), (4, 5, 0), (4, 6, 0)],
                     [(1, 0, 1), (2, 2, 4), (4, 5, 0), (4, 6, 0)]],
                    dtype=np.int32)
    rows = [ck._query_plan(p.tobytes(), 4, 4) for p in prog]
    (andnot, _live, scratch), (xor, _live2, scratch2) = rows
    assert (scratch, scratch2) == (1, 0)
    words = andnot[2:4].view(np.uint32).tolist()
    assert words == [1 | ck.VM_STORE | 0 << 8 | 1 << 16 | 4 << 24,
                     3 | 2 << 8 | 4 << 16]
    words = xor[2:4].view(np.uint32).tolist()
    assert words == [1 | 0 << 8 | 1 << 16, 2 | ck.VM_PREV | 2 << 16]
    rng = np.random.default_rng(94)
    pool = rng.integers(0, 2 ** 32, size=(4, ck.CONTAINER_WORDS),
                        dtype=np.uint32)
    gidx = rng.integers(0, 4, size=(4, 2, 5)).astype(np.int32)
    got = _read_plan(tbm.to_tensor(pool), gidx, _plan(prog, gidx))
    assert np.array_equal(got, pk._vm_counts_host(pool, prog, gidx))
