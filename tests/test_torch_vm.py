"""K3, the bitmap VM: the port's ``vm_counts`` on CPU tensors (its plain
version, which the wrapper takes for a CPU pool) against the JAX
package's three twins -- the numpy ``_vm_counts_host``, the XLA
``_vm_counts_jnp`` and the Pallas kernel in interpret mode -- on seeded
random SSA programs over all five opcodes, at small sizes and at the
default caps (16 leaf slots, 32 instructions), with container boundary
bits 65535/65536, plus the wrapper's refusals."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck

CW = ck.CONTAINER_WORDS


def _rand_program(rng: random.Random, slots: int, tape_len: int):
    """A random valid (SSA-ordered) program row, as tests/test_vm.py
    makes them: instruction t reads any leaf slot or earlier output."""
    prog = np.zeros((tape_len, 3), dtype=np.int32)
    for t in range(tape_len):
        prog[t, 0] = rng.randrange(5)
        prog[t, 1] = rng.randrange(slots + t)
        prog[t, 2] = rng.randrange(slots + t)
    return prog


def _case(seed: int, slots: int, tape_len: int, n_q: int, domain: int,
          rows: int):
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    pool = nprng.integers(0, 1 << 32, size=(rows, CW), dtype=np.uint32)
    pool[rows - 1] = 0  # the canonical zero row
    pool[0] = 0xFFFFFFFF  # every bit, bit 31 of each word included
    gidx = nprng.integers(0, rows, size=(slots, n_q, domain)
                          ).astype(np.int32)
    prog = np.stack([_rand_program(rng, slots, tape_len)
                     for _ in range(n_q)])
    return pool, prog, gidx


def _port(pool, prog, gidx) -> np.ndarray:
    before = ck.vm_counts.launches
    out = ck.vm_counts(tbm.to_tensor(pool), torch.from_numpy(prog),
                       torch.from_numpy(gidx))
    assert ck.vm_counts.launches == before  # a CPU pool launches nothing
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


def _twins(pool, prog, gidx):
    import jax.numpy as jnp

    host = pk._vm_counts_host(pool, prog, gidx)
    jnpv = np.asarray(pk._vm_counts_jnp(pool, prog, gidx))
    pal = np.asarray(pk._vm_counts_pallas(jnp.asarray(pool), prog, gidx,
                                          interpret=True))
    return host, jnpv, pal


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_programs_match_all_three_twins(seed):
    rng = random.Random(seed)
    rows = rng.choice([9, 16, 32])
    slots, tape_len = rng.choice([2, 4]), rng.choice([2, 4])
    n_q, domain = rng.choice([3, 4]), rng.choice([1, 2])
    pool, prog, gidx = _case(seed, slots, tape_len, n_q, domain, rows)
    got = _port(pool, prog, gidx)
    for twin in _twins(pool, prog, gidx):
        assert np.array_equal(got, twin)


def test_the_default_caps_match_all_three_twins():
    pool, prog, gidx = _case(4, slots=16, tape_len=32, n_q=2, domain=2,
                             rows=40)
    got = _port(pool, prog, gidx)
    for twin in _twins(pool, prog, gidx):
        assert np.array_equal(got, twin)


def test_one_query_one_cell():
    pool, prog, gidx = _case(5, slots=4, tape_len=4, n_q=1, domain=1,
                             rows=3)
    host, _jnpv, pal = _twins(pool, prog, gidx)
    got = _port(pool, prog, gidx)
    assert got.shape == (1, 1)
    assert np.array_equal(got, host) and np.array_equal(got, pal)


def test_boundary_bits_65535_and_65536():
    """Bit 65535 is bit 31 of a container's last word; bit 65536 is bit
    0 of the next container.  Each lands in its own pool row."""
    pool = np.zeros((4, CW), dtype=np.uint32)
    pool[0, CW - 1] = np.uint32(1) << np.uint32(31)  # bit 65535
    pool[1, 0] = 1                                   # bit 65536
    pool[2, CW - 1] = np.uint32(0x80000001)
    # cells: (row 0 | row 1), (row 0 & row 2), (row 2 ^ row 0), row 1 \ 2
    prog = np.array([[[1, 0, 1]], [[0, 0, 1]], [[2, 0, 1]], [[3, 0, 1]]],
                    dtype=np.int32)
    gidx = np.array([[[0], [0], [2], [1]], [[1], [2], [0], [2]]],
                    dtype=np.int32)
    got = _port(pool, prog, gidx)
    assert got[:, 0].tolist() == [2, 1, 1, 1]
    for twin in _twins(pool, prog, gidx):
        assert np.array_equal(got, twin)


def test_a_gather_index_past_the_pool_raises_like_the_twin():
    pool, prog, gidx = _case(6, slots=2, tape_len=2, n_q=2, domain=2,
                             rows=5)
    gidx[1, 1, 1] = 5
    with pytest.raises(IndexError):
        pk._vm_counts_host(pool, prog, gidx)
    with pytest.raises(IndexError):
        _port(pool, prog, gidx)
    gidx[1, 1, 1] = -1
    with pytest.raises(IndexError):
        _port(pool, prog, gidx)


@pytest.mark.parametrize("field,value", [(0, 5), (0, -1), (1, 2), (2, 3)])
def test_a_bad_instruction_raises(field, value):
    """An opcode outside 0..4, or an operand that is not a leaf slot or
    an earlier output of its query (slots = 2, instruction 0 here)."""
    pool, prog, gidx = _case(7, slots=2, tape_len=2, n_q=1, domain=1,
                             rows=3)
    prog[0, 0, field] = value
    with pytest.raises(ValueError):
        _port(pool, prog, gidx)


def test_types_and_shapes_are_checked():
    pool, prog, gidx = _case(8, slots=2, tape_len=2, n_q=2, domain=2,
                             rows=4)
    tp, tg = torch.from_numpy(prog), torch.from_numpy(gidx)
    tpool = tbm.to_tensor(pool)
    with pytest.raises(TypeError):
        ck.vm_counts(tpool.to(torch.int64), tp, tg)
    with pytest.raises(ValueError):
        ck.vm_counts(tpool[:, :CW // 2], tp, tg)
    with pytest.raises(ValueError):
        ck.vm_counts(tpool, tp[:1], tg)
    with pytest.raises(ValueError):
        ck.vm_counts(tpool, tp, tg.transpose(1, 2))
    with pytest.raises(ValueError):  # over the card's shared memory
        ck.vm_counts(tpool, torch.zeros((1, 128, 3), dtype=torch.int32),
                     torch.zeros((8, 1, 1), dtype=torch.int32))
