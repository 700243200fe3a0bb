"""The port's fused tree evaluator (ops/expr.py) against the JAX
package's, on the same seeded numpy stacks: result words and per-row
counts for and/or/xor/andnot/not/shift and nested three-leaf shapes,
dense and gathered.  Exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import expr as jexpr
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import expr as texpr

L0, L1, L2 = ("leaf", 0), ("leaf", 1), ("leaf", 2)
SHAPES = [
    ("and", L0, L1),
    ("or", L0, L1),
    ("xor", L0, L1),
    ("andnot", L0, L1),
    ("not", L2, L0),
    ("and", L0, L1, L2),
    ("or", ("and", L0, L1), L2),
    ("andnot", ("xor", L0, L2), ("or", L1, L2)),
    ("not", L2, ("or", L0, ("and", L1, L2))),
    ("xor", L0, ("not", L2, L1), ("andnot", L2, L0)),
    ("shift", 1, L0),
    ("shift", 33, ("and", L0, L1)),
    ("or", ("shift", 70000, L1), ("shift", 0, L2)),
]


def _stacks(seed: int, shape=(3, 4096)):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(3):
        s = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        s[:, k::5] = 0
        s[:, 1::9] = 0xFFFFFFFF
        s[:, 2::7] |= 0x80000000
        out.append(s)
    out[2] |= out[0]  # the existence row covers leaf 0
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_evaluate_words_and_counts_match_jax(shape):
    leaves = _stacks(1)
    n = 1 + max(int(s[1]) for s in _leaf_slots(shape))
    jl = tuple(jnp.asarray(x) for x in leaves[:n])
    tl = tuple(tbm.to_tensor(x) for x in leaves[:n])
    want = np.asarray(jexpr.evaluate(shape, jl))
    got = tbm.to_numpy(texpr.evaluate(shape, tl))
    assert np.array_equal(got, want)
    wc = np.asarray(jexpr.evaluate(shape, jl, counts=True))
    gc = texpr.evaluate(shape, tl, counts=True)
    assert gc.dtype == torch.int32
    assert np.array_equal(gc.numpy(), wc)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_evaluate_gathered_matches_jax(shape):
    pools = [x.reshape(-1, 2048) for x in _stacks(2, shape=(2, 8192))]
    for p in pools:
        p[-1] = 0  # zero tail row, as a container pool holds
    rng = np.random.default_rng(3)
    idxs = [rng.integers(0, len(p), size=16).astype(np.int32) for p in pools]
    idxs[0][3] = len(pools[0]) - 1
    n = 1 + max(int(s[1]) for s in _leaf_slots(shape))
    jp = tuple(jnp.asarray(p) for p in pools[:n])
    ji = tuple(jnp.asarray(i) for i in idxs[:n])
    tp = tuple(tbm.to_tensor(p) for p in pools[:n])
    ti = tuple(torch.from_numpy(i) for i in idxs[:n])
    want = np.asarray(jexpr.evaluate_gathered(shape, jp, ji))
    got = tbm.to_numpy(texpr.evaluate_gathered(shape, tp, ti))
    assert np.array_equal(got, want)
    wc = np.asarray(jexpr.evaluate_gathered(shape, jp, ji, counts=True))
    gc = texpr.evaluate_gathered(shape, tp, ti, counts=True)
    assert np.array_equal(gc.numpy(), wc)


def test_host_engine_copy_matches_reference():
    leaves = tuple(_stacks(4))
    for shape in SHAPES:
        assert np.array_equal(texpr._host_tree(shape, leaves),
                              jexpr._host_tree(shape, leaves))
        assert np.array_equal(texpr._host_counts(shape, leaves),
                              np.asarray(jexpr._host_counts(shape, leaves)))


def test_one_dispatch_per_evaluate_and_leaf_passthrough():
    tl = tuple(tbm.to_tensor(x) for x in _stacks(5))
    with tbm.dispatch_counter() as dc:
        texpr.evaluate(("and", L0, ("or", L1, L2)), tl)
        texpr.evaluate(("and", L0, L1), tl, counts=True)
        out = texpr.evaluate(L1, tl)
    assert dc.launches == ["fused_expr", "fused_expr"]
    assert out is tl[1]


@pytest.mark.parametrize("bad", [("leaf", 3), ("and",), ("shift", -1, L0),
                                 ("nand", L0, L1)], ids=str)
def test_validate_rejects_bad_shapes(bad):
    with pytest.raises(ValueError):
        texpr.evaluate(bad, tuple(tbm.to_tensor(x) for x in _stacks(6)))


def _leaf_slots(shape):
    if shape[0] == "leaf":
        return [shape]
    return [s for c in shape[1:] if isinstance(c, tuple)
            for s in _leaf_slots(c)]
