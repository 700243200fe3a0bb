"""The kind pools of the port (pilosa_tpu_torch/ops/kindpools.py) and
K3-kinds' plain version against the JAX package's, on the CPU.

``pick_kinds``, ``block_stats``, ``split_pools``, the torch decoders and
the array count arms against pilosa_tpu.ops.kindpools (numpy and jnp)
and pilosa_tpu.ops.pallas_kernels on seeded containers at the kinds'
edges: an empty pool, cardinalities 1, 4096 and 4097 (the array/bitmap
flip), 256 and 257 runs (the ``run_cap`` demotion), a full container,
bits 0 and 65535, and padding pairs.  Then ``vm_counts_kinds`` on CPU
tensors (its plain version, which the wrapper takes for a CPU pool)
against ``_vm_counts_kinds_pallas(interpret=True)`` and
``_vm_counts_kinds_jnp`` on seeded megapools, each pool empty in turn,
up to the caps (16 leaf slots, 32 instructions), every opcode, and on
the megapools of tests/torch_kinds_edges.py at the edges of the kernel's
decode, up to 64 leaf slots.  Then the kernel's tape plan, made on the
host (``vm_tape_plan``: COPYs as aliases, dead code dropped) and packed
as the kernel reads it (``vm_kinds_plan``), against the plain VM, and K3-kinds' admission by its own shared memory.  Every comparison
is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import kindpools as jkp
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import kindpools as tkp
from pilosa_tpu_torch.ops import tape as ttape

# tests/ is on sys.path under pytest (rootdir-less test files); another
# installed package may be named ``tests``
import torch_kinds_edges as edges  # noqa: E402

CB = 1 << 16
CW = CB // 32


def _block(positions) -> np.ndarray:
    w = np.zeros(CW, dtype=np.uint32)
    p = np.asarray(list(positions), dtype=np.int64)
    np.bitwise_or.at(w, p >> 5, (np.uint32(1) << (p & 31).astype(np.uint32)))
    return w


def _runs(n: int, length: int = 5, gap: int = 200) -> np.ndarray:
    return np.concatenate([np.arange(r * gap, r * gap + length)
                           for r in range(n)])


def _edge_blocks(seed: int) -> dict:
    """Named dense blocks at the kinds' edges."""
    rng = np.random.default_rng(seed)
    return {
        "empty": _block([]),
        "card1": _block([12345]),
        "card4096": _block(rng.choice(CB, 4096, replace=False)),
        "card4097": _block(rng.choice(CB, 4097, replace=False)),
        "runs256": _block(_runs(256)),
        "runs257": _block(_runs(257)),
        "full": np.full(CW, 0xFFFFFFFF, dtype=np.uint32),
        "bits0_65535": _block([0, 65535]),
        "bit65535": _block([65535]),
        "span": _block(range(31, 40001)),
        "halves": _block(np.arange(0, CB, 2)),
        "sparse": _block(rng.choice(CB, 65, replace=False)),
    }


def _blocks(seed: int = 7) -> np.ndarray:
    return np.stack(list(_edge_blocks(seed).values()))


@pytest.mark.parametrize("array_max,run_cap", [(4096, 256), (4096, 1 << 20),
                                               (100, 256), (4096, 2)])
def test_block_stats_and_pick_kinds_match_the_reference(array_max, run_cap):
    blocks = _blocks()
    for got, want in zip(tkp.block_stats(blocks), jkp.block_stats(blocks)):
        assert np.array_equal(got, want)
    got = tkp.pick_kinds(blocks, array_max=array_max, run_cap=run_cap)
    want = jkp.pick_kinds(blocks, array_max=array_max, run_cap=run_cap)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_the_kind_edges_pick_as_the_reference_says():
    names = list(_edge_blocks(7))
    kinds = dict(zip(names, tkp.pick_kinds(_blocks()).tolist()))
    assert kinds["card4096"] == 2 and kinds["card4097"] == 1
    assert kinds["runs256"] == 3 and kinds["runs257"] == 2
    assert kinds["full"] == 3 and kinds["card1"] == 2
    assert kinds["halves"] == 1


def test_an_empty_directory():
    empty = np.zeros((0, CW), dtype=np.uint32)
    for got, want in zip(tkp.block_stats(empty), jkp.block_stats(empty)):
        assert np.array_equal(got, want)
    kinds = np.zeros(0, dtype=np.uint8)
    for got, want in zip(tkp.split_pools(empty, kinds),
                         jkp.split_pools(empty, kinds)):
        assert got.dtype == want.dtype and got.shape == want.shape


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_split_pools_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    blocks = _blocks(seed)[rng.permutation(len(_edge_blocks(seed)))]
    kinds = jkp.pick_kinds(blocks)
    for got, want in zip(tkp.split_pools(blocks, kinds),
                         jkp.split_pools(blocks, kinds)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _pools(seed: int = 7):
    blocks = _blocks(seed)
    _s, _b, apool, acard, rpool = jkp.split_pools(blocks,
                                                  jkp.pick_kinds(blocks))
    return apool, acard, rpool


def _t16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_the_array_decoder_matches_numpy_and_jnp():
    apool, acard, _rpool = _pools()
    got = _u32(tkp.decode_array(_t16(apool), torch.from_numpy(acard)))
    assert np.array_equal(got, jkp.decode_array_np(apool, acard))
    assert np.array_equal(got, np.asarray(jkp.decode_array_jnp(apool, acard)))
    assert np.array_equal(got, tkp.decode_array_np(apool, acard))


def test_the_run_decoder_matches_numpy_and_jnp():
    _apool, _acard, rpool = _pools()
    got = _u32(tkp.decode_runs(_t16(rpool)))
    assert np.array_equal(got, jkp.decode_runs_np(rpool))
    assert np.array_equal(got, np.asarray(jkp.decode_runs_jnp(rpool)))
    assert np.array_equal(got, tkp.decode_runs_np(rpool))


def test_padding_pairs_and_empty_pools_decode_to_nothing():
    rpool = np.zeros((3, 8), dtype=np.uint16)
    rpool[:, 0::2] = 1  # every pair the invalid (1, 0)
    rpool[1, :4] = (0, 0, 65535, 65535)  # bits 0 and 65535, then padding
    got = _u32(tkp.decode_runs(_t16(rpool)))
    assert np.array_equal(got, jkp.decode_runs_np(rpool))
    assert got[0].sum() == 0 and got[2].sum() == 0
    assert int(np.bitwise_count(got[1]).sum()) == 2
    apool = np.full((2, 4), 0xFFFF, dtype=np.uint16)
    apool[1, :2] = (0, 65535)
    acard = np.array([0, 2], dtype=np.int32)
    got = _u32(tkp.decode_array(_t16(apool), torch.from_numpy(acard)))
    assert np.array_equal(got, jkp.decode_array_np(apool, acard))
    assert got[0].sum() == 0 and int(np.bitwise_count(got[1]).sum()) == 2
    for t in (tkp.decode_runs(torch.zeros((0, 2), dtype=torch.int16)),
              tkp.decode_array(torch.zeros((0, 1), dtype=torch.int16),
                               torch.zeros(0, dtype=torch.int32))):
        assert tuple(t.shape) == (0, CW)


def test_the_array_count_arms_match_the_reference():
    rng = np.random.default_rng(11)
    apool, acard, _rpool = _pools()
    blocks = _blocks()
    bpool = blocks[jkp.pick_kinds(blocks) == 1]
    n = 64
    ia0 = rng.integers(0, len(apool), n).astype(np.int32)
    ia1 = rng.integers(0, len(apool), n).astype(np.int32)
    ib = rng.integers(0, len(bpool), n).astype(np.int32)
    ta, tc = _t16(apool), torch.from_numpy(acard)
    got = tkp.gathered_count_array_array(ta, tc, torch.from_numpy(ia0), ta,
                                         tc, torch.from_numpy(ia1))
    want = pk._count_aa_np(apool, acard, ia0, apool, acard, ia1)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(
        pk._count_aa_jnp(apool, acard, ia0, apool, acard, ia1)))
    got = tkp.gathered_count_array_bitmap(
        ta, tc, torch.from_numpy(ia0),
        torch.from_numpy(bpool.view(np.int32)), torch.from_numpy(ib))
    want = pk._count_ab_np(apool, acard, ia0, bpool, ib)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------- K3-kinds plain


def _program(rng, n_q: int, slots: int, tape_len: int) -> np.ndarray:
    """Random valid SSA programs: instruction t reads a leaf slot or an
    earlier output; the first five instructions cover every opcode."""
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = ((t + q) % 5 if t < 5 else rng.integers(5),
                          rng.integers(slots + t), rng.integers(slots + t))
    return prog


def _megapools(seed: int, drop: str | None):
    """A seeded kind-split megapool (the reference's uint16/uint32
    layout): bitmap, array and run rows from random containers of every
    kind, each pool's tail its canonical empty row; ``drop`` leaves one
    kind's pool with no live rows."""
    rng = np.random.default_rng(seed)
    blocks = [_block(rng.choice(CB, int(rng.integers(1, 3000)),
                                replace=False)) for _ in range(6)]
    for _ in range(5):
        s = int(rng.integers(0, CB - 5000))
        blocks.append(_block(np.concatenate(
            [np.arange(s, s + int(rng.integers(1, 3000))),
             np.arange(s + 4000, s + 4100)])))
    blocks += [_block(np.arange(int(rng.integers(0, 2)), CB, 2)),
               _block(rng.choice(CB, 9000, replace=False)),
               _block([0, 65535]), _block(range(60000, 65536))]
    blocks = np.stack(blocks)
    kinds = jkp.pick_kinds(blocks)
    if drop is not None:
        keep = kinds != {"bitmap": 1, "array": 2, "run": 3}[drop]
        blocks, kinds = blocks[keep], kinds[keep]
    _s, bb, ap, ac, rp = jkp.split_pools(blocks, kinds)
    bpool = np.concatenate([bb, np.zeros((1, CW), np.uint32)])
    apool = np.concatenate([ap, np.full((1, ap.shape[1]), 0xFFFF,
                                        np.uint16)])
    acard = np.concatenate([ac, np.zeros(1, np.int32)])
    pad = np.zeros((1, rp.shape[1]), np.uint16)
    pad[:, 0::2] = 1
    rpool = np.concatenate([rp, pad])
    return bpool, apool, acard, rpool


def _port_kinds(bpool, apool, acard, rpool, prog, gidx) -> np.ndarray:
    before = ck.vm_counts_kinds.launches
    out = ck.vm_counts_kinds(
        torch.from_numpy(bpool.view(np.int32)), _t16(apool),
        torch.from_numpy(acard), _t16(rpool), torch.from_numpy(prog),
        torch.from_numpy(gidx))
    assert ck.vm_counts_kinds.launches == before  # CPU: no launch
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("drop", [None, "bitmap", "array", "run"])
@pytest.mark.parametrize("slots,tape_len,n_q,domain",
                         [(2, 2, 3, 4), (4, 8, 2, 3), (16, 32, 2, 2)])
def test_k3_kinds_plain_matches_interpret_pallas_and_jnp(drop, slots,
                                                         tape_len, n_q,
                                                         domain):
    import jax.numpy as jnp

    seed = 100 + slots + tape_len + len(drop or "")
    rng = np.random.default_rng(seed)
    bpool, apool, acard, rpool = _megapools(seed, drop)
    rows = len(bpool) + len(apool) + len(rpool)
    prog = _program(rng, n_q, slots, tape_len)
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    gidx[:, :, -1] = len(bpool) - 1  # a pad lane on the zero row
    got = _port_kinds(bpool, apool, acard, rpool, prog, gidx)
    args = (jnp.asarray(bpool), jnp.asarray(apool), jnp.asarray(acard),
            jnp.asarray(rpool), jnp.asarray(prog), jnp.asarray(gidx))
    assert np.array_equal(got, np.asarray(pk._vm_counts_kinds_jnp(*args)))
    assert np.array_equal(got, np.asarray(
        pk._vm_counts_kinds_pallas(*args, interpret=True)))


def test_k3_kinds_refuses_bad_calls_before_any_launch():
    bpool, apool, acard, rpool = _megapools(5, None)
    rows = len(bpool) + len(apool) + len(rpool)
    prog = np.array([[[0, 0, 1]]], dtype=np.int32)
    gidx = np.zeros((2, 1, 1), dtype=np.int32)
    tb = torch.from_numpy(bpool.view(np.int32))
    ta, tc, tr = _t16(apool), torch.from_numpy(acard), _t16(rpool)
    tp = torch.from_numpy(prog)
    gidx[1, 0, 0] = rows
    with pytest.raises(IndexError):
        ck.vm_counts_kinds(tb, ta, tc, tr, tp, torch.from_numpy(gidx))
    gidx[1, 0, 0] = rows - 1
    ok = ck.vm_counts_kinds(tb, ta, tc, tr, tp, torch.from_numpy(gidx))
    assert ok.shape == (1, 1)
    with pytest.raises(TypeError):  # array values must be 16-bit
        ck.vm_counts_kinds(tb, ta.to(torch.int32), tc, tr, tp,
                           torch.from_numpy(gidx))
    with pytest.raises(ValueError):  # run rows hold whole pairs
        ck.vm_counts_kinds(tb, ta, tc, tr[:, :1].contiguous(), tp,
                           torch.from_numpy(gidx))
    with pytest.raises(ValueError):  # a cardinality past the row
        ck.vm_counts_kinds(tb, ta, tc + apool.shape[1] + 1, tr, tp,
                           torch.from_numpy(gidx))
    with pytest.raises(ValueError):  # an operand that is no register yet
        ck.vm_counts_kinds(tb, ta, tc, tr, torch.tensor([[[0, 0, 2]]],
                                                        dtype=torch.int32),
                           torch.from_numpy(gidx))


def _edge_args(case: str):
    """The edge megapools and a program: a random one at each shape of
    ``edges.EDGE_SHAPES`` (domain cut to 4 lanes for the interpreter),
    every row alone (``decode``), or split_pools' own pools with their
    run rows re-padded to rcap 256 (``repad``)."""
    if case == "decode":
        return edges.decode_case(61)
    if case == "repad":
        bpool, apool, acard, rpool = _megapools(62, None)
        rpool = edges.repad(rpool, 256)
        rows = len(bpool) + len(apool) + len(rpool)
        prog, gidx = edges.random_program(np.random.default_rng(62), 4, 4,
                                          8, rows, 4, len(bpool) - 1)
        return bpool, apool, acard, rpool, prog, gidx
    _l, slots, tape_len, n_q, _d = next(s for s in edges.EDGE_SHAPES
                                        if s[0] == case)
    return edges.edge_case(60 + slots, slots, tape_len, n_q, 4)


@pytest.mark.parametrize("case", [s[0] for s in edges.EDGE_SHAPES]
                         + ["decode", "repad"])
def test_k3_kinds_plain_matches_interpret_pallas_and_jnp_at_decode_edges(
        case):
    import jax.numpy as jnp

    args = _edge_args(case)
    got = _port_kinds(*args)
    jargs = tuple(jnp.asarray(a) for a in args)
    assert np.array_equal(got, np.asarray(pk._vm_counts_kinds_jnp(*jargs)))
    assert np.array_equal(got, np.asarray(
        pk._vm_counts_kinds_pallas(*jargs, interpret=True)))
    if case == "decode":  # each cell counts one row: its own bits
        bpool, apool, acard, rpool = args[:4]
        runs = rpool.reshape(len(rpool), -1, 2).astype(np.int64)
        want = np.concatenate([
            np.bitwise_count(bpool).sum(axis=1), acard,
            np.where(runs[..., 1] >= runs[..., 0],
                     runs[..., 1] - runs[..., 0] + 1, 0).sum(axis=1)])
        assert np.array_equal(got[0], want)


def _plan_counts(pool: np.ndarray, prog: np.ndarray,
                 gidx: np.ndarray) -> np.ndarray:
    """Per-cell counts read as the kernel reads ``ck.vm_kinds_plan``:
    only the live leaf slots gathered, only the live instructions run,
    the result register popcounted."""
    slots, n_q, domain = gidx.shape
    tape_len = prog.shape[1]
    plan = ck.vm_kinds_plan(torch.from_numpy(prog), slots).numpy()
    assert plan.shape == (n_q, 2 + tape_len + slots)
    out = np.zeros((n_q, domain), dtype=np.int32)
    for q in range(n_q):
        live_n, result = plan[q, :2]
        tape = plan[q, 2:2 + tape_len].view(np.uint32)
        assert not tape[live_n:].any()
        regs = {s: pool[gidx[s, q]] for s in range(slots)
                if plan[q, 2 + tape_len + s]}
        for ins in tape[:live_n].tolist():
            op, a, b, dst = (ins & 0xff, ins >> 8 & 0xff, ins >> 16 & 0xff,
                             ins >> 24)
            xa, xb = regs[a], regs[b]
            regs[dst] = (xa & xb, xa | xb, xa ^ xb, xa & ~xb)[op]
        out[q] = np.bitwise_count(regs[result]).sum(axis=1)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_kernels_tape_plan_counts_as_the_plain_vm(seed):
    rng = np.random.default_rng(300 + seed)
    pool = rng.integers(0, 2 ** 32, size=(12, CW), dtype=np.uint32)
    pool[-1] = 0
    # the coalescer's programs: COPY-padded tapes, pad rows and pad slots
    shapes = [("and", ("leaf", 0), ("leaf", 1)),
              ("or", ("leaf", 0), ("leaf", 1), ("leaf", 2)),
              ("xor", ("and", ("leaf", 0), ("leaf", 2)), ("leaf", 1)),
              ("andnot", ("leaf", 1), ("leaf", 0))]
    batch = [(ttape.compile_shape(sh, 3), [rng.integers(0, 11, 5).astype(
        np.int32) for _ in range(3)]) for sh in shapes[:3]]
    progs = [ttape.vm_program(batch, 11, 8, 4)]
    # random SSA programs with dead instructions, dead slots and COPYs
    progs.append(edges.random_program(rng, 4, 6, 16, 12, 5, 11))
    progs.append((np.full((2, 4, 3), (4, 0, 0), dtype=np.int32),
                  rng.integers(0, 12, (3, 2, 5)).astype(np.int32)))
    for prog, gidx in progs:
        want = ck.vm_counts_plain(torch.from_numpy(pool.view(np.int32)),
                                  torch.from_numpy(prog),
                                  torch.from_numpy(gidx)).numpy()
        assert np.array_equal(_plan_counts(pool, prog, gidx), want)


def test_the_tape_plan_drops_copies_dead_code_and_pad_slots():
    # Count(Intersect(slot 0, slot 1)) in the (4, 4) class: AND, 3 COPYs
    prog = [(0, 0, 1), (4, 4, 0), (4, 5, 0), (4, 6, 0)]
    assert ck.vm_tape_plan(prog, 4) == ([(0, 0, 1, 4)], [0, 1], 4)
    # a pad row: COPYs of slot 0 only
    assert ck.vm_tape_plan([(4, 0, 0)] * 4, 4) == ([], [0], 0)
    # instruction 1 reads slot 2 but the result does not reach it
    prog = [(1, 0, 1), (2, 2, 3), (4, 3, 0)]
    assert ck.vm_tape_plan(prog, 3) == ([(1, 0, 1, 3)], [0, 1], 3)


def _admission_args(slots: int, tape_len: int):
    bpool, apool, acard, rpool = _megapools(5, None)
    prog = np.zeros((1, tape_len, 3), dtype=np.int32)
    prog[0, :, 0] = 4  # COPYs of slot 0
    gidx = np.zeros((slots, 1, 1), dtype=np.int32)
    return (torch.from_numpy(bpool.view(np.int32)), _t16(apool),
            torch.from_numpy(acard), _t16(rpool), torch.from_numpy(prog),
            torch.from_numpy(gidx))


def test_k3_kinds_admits_by_its_own_shared_memory_before_any_launch():
    limit = ck.VM_SMEM_LIMIT
    # every shape K3's formula admits, K3-kinds' admits too
    for total in range(2, 120):
        for t in range(1, total):
            if ck.vm_smem_bytes(t, total - t) <= limit:
                assert ck.vm_kinds_smem_bytes(t, total - t) <= limit
    before = ck.vm_counts_kinds.launches
    for slots in (16, 64, 81):  # the caps, a large shape, the last fit
        out = ck.vm_counts_kinds(*_admission_args(slots, 32))
        assert out.shape == (1, 1)
    assert ck.vm_kinds_smem_bytes(32, 81) <= limit
    assert ck.vm_kinds_smem_bytes(32, 82) > limit
    with pytest.raises(ValueError, match="shared memory"):
        ck.vm_counts_kinds(*_admission_args(82, 32))
    assert ck.vm_counts_kinds.launches == before
