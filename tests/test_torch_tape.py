"""The port's op-tape compiler and interpreters against the JAX
package's (pilosa_tpu/ops/tape.py): the same shapes compile to the same
tapes and size classes, refuse the same trees with the same fallback
counters, and the dense interpreter, the bitmap-VM driver and the fused
tree over [B, S, W] stacks give the same counts on the same seeded
words.  The JAX side runs its numpy host engines, as its own tests run
them on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.ops import expr as jexpr
from pilosa_tpu.ops import tape as jtape
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import expr as texpr
from pilosa_tpu_torch.ops import tape as ttape

L0, L1, L2, L3 = (("leaf", i) for i in range(4))

#: (shape, n_leaves) pairs that compile
SHAPES = [
    (L0, 1),
    (("and", L0, L1), 2),
    (("or", L0, L1, L2), 3),
    (("xor", ("and", L0, L1), L2), 3),
    (("andnot", L2, ("or", L0, L1)), 3),
    (("not", L3, ("and", L0, L1)), 4),
    (("and", L0), 1),
    (("dfuse", L0, L1, L2), 3),
    (("or", ("dfuse", L0, L1, L2), L3), 4),
    (("xor", ("andnot", L0, L1), ("or", L2, L3), ("and", L1, L3)), 4),
]


@pytest.fixture(autouse=True)
def _fresh_counters():
    jtape.reset_counters()
    ttape.reset_counters()
    yield


@pytest.mark.parametrize("shape,n", SHAPES)
def test_compile_shape_gives_the_reference_tape(shape, n):
    want = jtape.compile_shape(shape, n)
    got = ttape.compile_shape(shape, n)
    assert tuple(got.instrs) == tuple(want.instrs)
    assert got.n_leaves == want.n_leaves
    assert ttape.size_class(len(got.instrs), n) == \
        jtape.size_class(len(want.instrs), n)


@pytest.mark.parametrize("shape,n,max_len", [
    (("shift", L0, 1), 1, None),
    (("bogus", L0), 1, None),
    (("and", L0, ("leaf", 5)), 2, None),
    (("dfuse", L0, L1), 2, None),
    (("and",), 1, None),
    (("or", L0, L1, L2, L3), 4, 2),
])
def test_refusals_and_their_counters_match(shape, n, max_len):
    with pytest.raises(jtape.TapeError) as je:
        jtape.compile_shape(shape, n, max_len)
    with pytest.raises(ttape.TapeError) as te:
        ttape.compile_shape(shape, n, max_len)
    assert str(te.value) == str(je.value)
    assert jtape.try_compile(shape, n, max_len) is None
    assert ttape.try_compile(shape, n, max_len) is None
    assert ttape.counters() == jtape.counters()


@pytest.mark.parametrize("n_instrs", [0, 1, 2, 3, 4, 5, 9, 32, 33])
@pytest.mark.parametrize("n_leaves", [1, 3, 4, 5, 16, 17])
def test_size_class_matches(n_instrs, n_leaves):
    assert ttape.size_class(n_instrs, n_leaves) == \
        jtape.size_class(n_instrs, n_leaves)


def _words(rng, *shape) -> np.ndarray:
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    w[..., 0] = 0xFFFFFFFF  # bit 31 set: a negative int32 word
    return w


@pytest.mark.parametrize("counts", [True, False])
def test_dense_execute_matches_the_host_engine(counts):
    rng = np.random.default_rng(7)
    S, W = 3, 64
    batch_np, batch_t = [], []
    for shape, n in SHAPES:
        leaves = tuple(_words(rng, S, W) for _ in range(n))
        tp = jtape.compile_shape(shape, n)
        batch_np.append((tp, leaves))
        batch_t.append((ttape.compile_shape(shape, n),
                        tuple(tbm.to_tensor(lv) for lv in leaves)))
    with jbm.dispatch_counter() as jdc:
        want = jtape.execute(batch_np, counts=counts)
    with tbm.dispatch_counter() as tdc:
        got = ttape.execute(batch_t, counts=counts)
    assert tdc.launches == jdc.launches == ["tape"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if counts:
            assert g.tolist() == np.asarray(w).tolist()
        else:
            assert np.array_equal(tbm.to_numpy(g), w)
    c = ttape.counters()
    assert (c["tape.executions"], c["tape.queries"]) == (1, len(SHAPES))
    # a COPY aliases its operand: no copy of the leaf is made
    lone = ttape.execute([batch_t[0]])[0]
    assert lone.data_ptr() == batch_t[0][1][0].data_ptr()


def test_dense_execute_refuses_a_tape_over_its_bucket():
    tp = ttape.compile_shape(("or", L0, L1, L2), 3)
    leaves = tuple(torch.zeros((1, 4), dtype=torch.int32) for _ in range(3))
    with pytest.raises(ttape.TapeError):
        ttape.execute([(tp, leaves)], tape_len=1)
    with pytest.raises(ttape.TapeError):
        ttape.execute([(tp, leaves)], slots=2)


def _vm_batch(rng, rows: int, n_q: int, domain: int):
    """Seeded (numpy pool, [(tape, gather rows)]) over mixed shapes."""
    pool = _words(rng, rows, 2048)
    pool[rows - 1] = 0  # the zero row
    batch = []
    for q in range(n_q):
        shape, n = SHAPES[(3 * q + 1) % len(SHAPES)]
        idxs = [rng.integers(0, rows, size=domain).astype(np.int32)
                for _ in range(n)]
        batch.append((jtape.compile_shape(shape, n), idxs))
    return pool, batch


@pytest.mark.parametrize("n_q,max_prefetch", [(1, None), (5, None),
                                              (8, None), (8, 128),
                                              (7, 64), (1, 8)])
def test_execute_vm_matches_the_reference_and_its_splits(n_q, max_prefetch):
    rng = np.random.default_rng(11 + n_q)
    rows, domain = 12, 8
    pool, batch = _vm_batch(rng, rows, n_q, domain)
    with jbm.dispatch_counter() as jdc:
        want = jtape.execute_vm(batch, pool, rows - 1,
                                max_prefetch=max_prefetch)
    with tbm.dispatch_counter() as tdc:
        got = ttape.execute_vm(batch, tbm.to_tensor(pool), rows - 1,
                               max_prefetch=max_prefetch)
    assert tdc.launches == jdc.launches
    assert set(tdc.launches) == {"vm"}
    if max_prefetch is not None and n_q > 1:
        assert len(tdc.launches) > 1  # the halving split the batch
    assert [g.dtype for g in got] == [np.dtype(np.int64)] * n_q
    assert [g.tolist() for g in got] == [np.asarray(w).tolist()
                                         for w in want]
    assert ttape.counters()["vm.executions"] == len(tdc.launches)
    assert ttape.counters()["vm.queries"] == n_q
    assert [p for p in ttape.debug()["vm"]["programs"]] == \
        [p for p in jtape.debug()["vm"]["programs"]]


def test_debug_document_has_the_reference_keys():
    j, t = jtape.debug(), ttape.debug()
    assert set(t) == set(j)
    assert set(t["counters"]) == set(j["counters"])
    assert set(t["vm"]) == set(j["vm"])
    assert set(t["vm"]["fallbackReasons"]) == set(j["vm"]["fallbackReasons"])


@pytest.mark.parametrize("shape,n", SHAPES[1:6])
def test_evaluate_over_batched_stacks_counts_the_last_axis(shape, n):
    """The same-shape coalesced route feeds ``evaluate`` [B, S, W]
    stacks: per-(query, shard) counts, as the reference gives them."""
    rng = np.random.default_rng(n)
    leaves = tuple(_words(rng, 4, 3, 32) for _ in range(n))
    want = jexpr.evaluate(shape, leaves, counts=True)
    got = texpr.evaluate(shape, tuple(tbm.to_tensor(lv) for lv in leaves),
                         counts=True)
    assert tuple(got.shape) == (4, 3)
    assert got.tolist() == np.asarray(want).tolist()
    words = texpr.evaluate(shape, tuple(tbm.to_tensor(lv) for lv in leaves))
    assert np.array_equal(tbm.to_numpy(words),
                          np.asarray(jexpr.evaluate(shape, leaves)))
