"""BSI ops of the port (ops/bsi.py) and the kernels K6 (bsi_compare) and
K1 (count_and) against the JAX package, on the CPU.

Seeded numpy plane stacks at depths 1, 5, 20, 40 and 63 -- exists and
sign random and independent, magnitudes of every width, stale planes
under cleared exists bits -- go through ``pilosa_tpu.ops.bsi`` (its XLA
path; the Min/Max scans through its host engine at every depth and its
XLA path at the small ones, where that compiles in well under a second)
and the port's ``ops/bsi`` (the plain versions of K4 and K6, as the
wrappers take them for CPU tensors), one fragment at a time and as a
stack of three shards, and must agree bit for bit: ``compare``,
``plane_counts(_stacked)``, ``extremes_stacked``, ``range_words`` for
every operator and predicate sign (0, -1, 1, the extremes, values held
by columns) and ``between_words`` for all three sign cases.  Below them
the kernels' plain versions meet the Pallas kernels in interpret mode:
``bsi_compare_unsigned`` (including the ``upred >= 2^depth`` early-out)
and ``_bsi_compare_pallas``, and ``count_and`` against
``_count_and_pallas`` at lengths that are not a multiple of its
2048-word block.  No test here changes a process-wide setting.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.ops import cuda_kernels as ck

DEPTHS = (1, 5, 20, 40, 63)
WORDS = 99  # 3168 columns a shard, not a multiple of 4 words
SHARDS = 3
OPS = ("==", "!=", "<", "<=", ">", ">=")


def _stack(depth: int, seed: int = 0) -> tuple[np.ndarray, list[int]]:
    """uint32 [SHARDS, 2 + depth, WORDS] planes and some magnitudes that
    considered columns hold."""
    rng = np.random.default_rng(seed * 100 + depth)
    n = WORDS * 32
    shards, held = [], []
    for _ in range(SHARDS):
        exists = rng.random(n) < 0.7
        sign = rng.random(n) < 0.3
        mags = rng.integers(0, 2 ** depth, size=n, dtype=np.uint64)
        # small magnitudes too, so that low predicates see equal columns
        mags[: n // 8] = rng.integers(0, 3, size=n // 8, dtype=np.uint64)
        rows = [exists, sign] + [((mags >> np.uint64(i)) & np.uint64(1))
                                 .astype(bool) for i in range(depth)]
        shards.append(np.stack([np.packbits(r, bitorder="little")
                                .view(np.uint32) for r in rows]))
        held += [int(m) for m in mags[exists][:2]]
    return np.stack(shards), held


def _t(words: np.ndarray) -> torch.Tensor:
    return tbm.to_tensor(words)


def _np(t: torch.Tensor) -> np.ndarray:
    return tbm.to_numpy(t)


def _predicates(depth: int, held: list[int]) -> list[int]:
    top = 2 ** depth - 1
    return sorted({0, 1, top, held[0], held[1] // 2 + 1})


@pytest.mark.parametrize("depth", DEPTHS)
def test_compare_matches_the_reference(depth):
    P, held = _stack(depth)
    filt = P[:, 0] & ~P[:, 1]
    for upred in _predicates(depth, held):
        lo, hi = jbsi.split_predicate(upred)
        assert (lo, hi) == tbsi.split_predicate(upred)
        lt, eq = tbsi.compare(_t(P), _t(filt), lo, hi)
        for s in range(SHARDS):
            jlt, jeq = jbsi.compare(jnp.asarray(P[s]), jnp.asarray(filt[s]),
                                    lo, hi)
            assert np.array_equal(_np(lt[s]), np.asarray(jlt)), (upred, s)
            assert np.array_equal(_np(eq[s]), np.asarray(jeq)), (upred, s)
            one = tbsi.compare(_t(P[s]), _t(filt[s]), lo, hi)
            assert np.array_equal(_np(one[0]), np.asarray(jlt))
            assert np.array_equal(_np(one[1]), np.asarray(jeq))


@pytest.mark.parametrize("depth", DEPTHS)
def test_plane_counts_match_the_reference(depth):
    P, _ = _stack(depth, seed=1)
    consider = P[:, 0] & ~(P[:, 0] & P[:, 2 % P.shape[1]] & 0x0F0F0F0F)
    pos, neg, count = tbsi.plane_counts_stacked(_t(P), _t(consider))
    jpos, jneg, jcount = jbsi.plane_counts_stacked(jnp.asarray(P),
                                                   jnp.asarray(consider))
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(neg.numpy(), np.asarray(jneg))
    assert np.array_equal(count.numpy(), np.asarray(jcount))
    # one fragment: the reference's per-fragment counts at the small
    # depths (each depth is an XLA compile), the stack's rows at all
    for s in range(SHARDS):
        p1, n1 = tbsi.plane_counts(_t(P[s]), _t(consider[s]))
        assert np.array_equal(p1.numpy(), pos[s].numpy())
        assert np.array_equal(n1.numpy(), neg[s].numpy())
    if depth <= 5:
        jp1, jn1 = jbsi.plane_counts(jnp.asarray(P[0]),
                                     jnp.asarray(consider[0]))
        assert np.array_equal(pos[0].numpy(), np.asarray(jp1))
        assert np.array_equal(neg[0].numpy(), np.asarray(jn1))


@pytest.mark.parametrize("want", ["min", "max"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_extremes_match_the_reference(depth, want):
    """Against the reference's host engine (its numpy dispatch) at every
    depth, and its XLA path where that compiles quickly."""
    P, _ = _stack(depth, seed=2)
    consider = P[:, 0].copy()
    consider[2] = 0  # a shard with nothing considered
    got = [x.numpy() for x in tbsi.extremes_stacked(_t(P), _t(consider),
                                                    want)]
    refs = [jbsi.extremes_stacked(P, consider, want)]
    if depth <= 5:
        refs.append(jbsi.extremes_stacked(jnp.asarray(P),
                                          jnp.asarray(consider), want))
    for ref in refs:
        for g, r in zip(got, ref):
            assert np.array_equal(g, np.asarray(r))
    # one fragment: the stack's row 0 (primary scan = max, fallback = min)
    sign = P[0, 1] if want == "min" else ~P[0, 1]
    taken, n = tbsi.extreme_max(_t(P[0]), _t(consider[0] & sign))
    assert np.array_equal(taken.numpy(), got[2][0]) and int(n) == got[4][0]
    taken, n = tbsi.extreme_min(_t(P[0]), _t(consider[0]))
    assert np.array_equal(taken.numpy(), got[3][0]) and int(n) == got[5][0]
    assert tbsi.assemble_value(taken.numpy()) == \
        jbsi.assemble_value(got[3][0])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_range_words_match_the_reference(depth, op):
    P, held = _stack(depth, seed=3)
    tP = _t(P)
    for mag in _predicates(depth, held):
        for pred in {mag, -mag, -1}:
            got = _np(tbsi.range_words(tP, op, pred))
            for s in range(SHARDS):
                want = np.asarray(jbsi.range_words(jnp.asarray(P[s]), op,
                                                   pred))
                assert np.array_equal(got[s], want), (op, pred, s)
            one = _np(tbsi.range_words(_t(P[1]), op, pred))
            assert np.array_equal(one, got[1])


@pytest.mark.parametrize("case", ["positive", "negative", "mixed"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_between_words_match_the_reference(depth, case):
    P, held = _stack(depth, seed=4)
    a, b = sorted(held[:2])
    lo, hi = {"positive": (a, b), "negative": (-b, -a),
              "mixed": (-a, b)}[case]
    got = _np(tbsi.between_words(_t(P), lo, hi))
    for s in range(SHARDS):
        want = np.asarray(jbsi.between_words(jnp.asarray(P[s]), lo, hi))
        assert np.array_equal(got[s], want), (lo, hi, s)


@pytest.mark.parametrize("depth", DEPTHS)
def test_bsi_compare_unsigned_matches_pallas_interpret(depth):
    P, held = _stack(depth, seed=5)
    planes, filt = P[0], P[1, 0] | P[2, 1]
    preds = _predicates(depth, held) + [2 ** depth, 2 ** depth + 7]
    for upred in preds:
        lt, gt = ck.bsi_compare_unsigned(_t(planes), _t(filt), upred, depth)
        jlt, jgt = pk.bsi_compare_unsigned(planes, filt, upred, depth,
                                           interpret=True)
        assert np.array_equal(_np(lt), np.asarray(jlt)), upred
        assert np.array_equal(_np(gt), np.asarray(jgt)), upred
        if upred < 2 ** depth:
            masks = np.array([[0xFFFFFFFF if (upred >> i) & 1 else 0]
                              for i in range(depth)], dtype=np.uint32)
            plt, pgt = pk._bsi_compare_pallas(
                jnp.asarray(planes), jnp.asarray(filt), jnp.asarray(masks),
                depth, interpret=True)
            assert np.array_equal(_np(lt), np.asarray(plt))
            assert np.array_equal(_np(gt), np.asarray(pgt))
        # the general entry with the consider row formed by the caller
        consider = planes[0] & ~planes[1] & filt
        glt, ggt = ck.bsi_compare(_t(planes), _t(consider), upred, depth)
        if upred < 2 ** depth:
            assert np.array_equal(_np(glt), _np(lt))
            assert np.array_equal(_np(ggt), _np(gt))


@pytest.mark.parametrize("n", [1, 2049, 5000])
def test_count_and_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    a[0] = b[0] = 0xFFFFFFFF
    want = int(np.bitwise_count(a & b).sum())
    got = ck.count_and(_t(a), _t(b))
    assert isinstance(got, int) and got == want
    assert int(pk._count_and_pallas(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True)) == want
    assert tbm.popcount_and(_t(a), _t(b)) == want


def test_count_and_reads_a_plane_of_a_stack_in_place():
    P, _ = _stack(5, seed=6)
    tP = _t(P)
    filt = P[:, 2] | P[:, 3]
    exists = tP[:, 0]  # strided rows
    assert not exists.is_contiguous()
    want = int(np.bitwise_count(P[:, 0] & filt).sum())
    assert ck.count_and(exists, _t(filt)) == want


def test_wrappers_on_cpu_launch_nothing():
    P, _ = _stack(5, seed=7)
    before = (ck.bsi_compare.launches, ck.count_and.launches)
    ck.bsi_compare(_t(P), _t(P[:, 0]), 3, 5)
    ck.bsi_compare_unsigned(_t(P[0]), _t(P[0, 0]), 3, 5)
    ck.count_and(_t(P[0, 0]), _t(P[0, 1]))
    assert (ck.bsi_compare.launches, ck.count_and.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "planes_shape", "cons_shape",
                                 "strided", "depth", "pred", "count_shape",
                                 "count_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    P = torch.zeros((2, 7, 64), dtype=torch.int32)
    cons = torch.zeros((2, 64), dtype=torch.int32)
    depth, upred = 5, 3
    a = b = torch.zeros(64, dtype=torch.int32)
    if bad == "dtype":
        P = P.to(torch.int64)
    elif bad == "planes_shape":
        depth = 4
    elif bad == "cons_shape":
        cons = torch.zeros((3, 64), dtype=torch.int32)
    elif bad == "strided":
        cons = torch.zeros((2, 128), dtype=torch.int32)[:, ::2]
    elif bad == "depth":
        depth = 65
    elif bad == "pred":
        upred = 1 << 64
    elif bad == "count_shape":
        b = torch.zeros(65, dtype=torch.int32)
    else:
        b = torch.zeros(64, dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        if bad.startswith("count"):
            ck.count_and(a, b)
        else:
            ck.bsi_compare(P, cons, upred, depth)
