"""The compressed container engine of the port against the JAX package's:
the same imported data in both, ``plan_fused`` on the same trees, and
then equal routing (compressed or dense), equal pool layouts and
directories, equal gather indices, equal per-shard counts and equal row
words.  The JAX side runs single-device (mesh off) with array/run kinds
off, the configuration the port implements."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.ops import containers as jct
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel import meshexec
from pilosa_tpu.parallel.executor import ExecOptions as JOpts
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu_torch import ingest as tingest
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import containers as tct
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

N_SHARDS = 6

QUERIES = [
    "Intersect(Row(f=1), Row(f=2))",
    "Union(Row(f=1), Row(f=2), Row(f=3))",
    "Difference(Row(f=1), Row(f=3))",
    "Xor(Row(f=1), Row(f=2))",
    "Not(Row(f=1))",
    "Intersect(Row(f=1), Union(Row(f=2), Row(f=3)))",
    "Intersect(Row(f=1), Row(f=5))",
    "Intersect(Row(f=1), Row(f=4))",
]
# row 4, and so the existence row, is over the threshold in shard 1
DENSE = {"Intersect(Row(f=1), Row(f=4))", "Not(Row(f=1))"}


@pytest.fixture(autouse=True)
def _single_device_all_bitmap():
    """The all-bitmap base route these tests pin: kinds off in both
    packages and the port's ingest deltas off, as the JAX holders run
    them (the reference module's default)."""
    mesh_was = meshexec._cfg.enabled
    delta_was = tingest.config().delta_enabled
    tingest.configure(delta_enabled=False)
    meshexec.configure(enabled=False)
    jct.reset()
    jct.configure(kinds=False)
    tct.reset()
    tct.configure(kinds=False)
    yield
    tingest.configure(delta_enabled=delta_was)
    meshexec.configure(enabled=mesh_was)
    jct.reset()
    tct.reset()


def _data(seed: int):
    """(rows, cols): sparse rows 1-2, row 3 absent from shard 2, row 5
    empty, row 4 above the 0.25 fill threshold in shard 1."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r, n in ((1, 900), (2, 700), (3, 500)):
        c = rng.choice(N_SHARDS * SHARD_WIDTH, size=n, replace=False)
        if r == 3:
            c = c[c // SHARD_WIDTH != 2]
        rows.append(np.full(len(c), r))
        cols.append(c)
    hot = SHARD_WIDTH + rng.choice(SHARD_WIDTH, size=SHARD_WIDTH // 4 + 64,
                                   replace=False)
    rows.append(np.full(len(hot), 4))
    cols.append(hot)
    return np.concatenate(rows), np.concatenate(cols)


@pytest.fixture
def holders(tmp_path):
    rows, cols = _data(21)
    jh = JHolder(str(tmp_path / "jax"))
    th = THolder(str(tmp_path / "torch"), device="cpu")
    for h in (jh, th):
        idx = h.create_index("i")
        f = idx.create_field("f")
        f.import_bits(rows, cols)
        idx.import_existence(cols)
    yield jh, th
    jh.close()
    th.close()


def _plans(holders, q: str, counts: bool):
    jh, th = holders
    jidx, tidx = jh.index("i"), th.index("i")
    shards = tuple(sorted(jidx.available_shards()))
    assert shards == tuple(sorted(tidx.available_shards()))
    jp = jct.plan_fused(None, jidx, jparse(q).calls[0], shards,
                        JOpts(mesh=False), counts=counts)
    tp = tct.plan_fused(tidx, tparse(q).calls[0], shards, counts=counts)
    return jp, tp


@pytest.mark.parametrize("q", QUERIES)
def test_plans_route_alike_with_equal_layouts_and_indices(holders, q):
    jp, tp = _plans(holders, q, counts=True)
    assert (jp is None) == (tp is None) == (q in DENSE)
    if jp is None:
        return
    assert jp.shape == tp.shape
    for jl, tl in zip(jp.leaves, tp.leaves):
        assert not jl.has_kinds
        assert jl.n == tl.n
        assert jl.starts == tl.starts
        assert len(jl.entries) == len(tl.entries)
        for je, te in zip(jl.entries, tl.entries):
            assert np.array_equal(je, te)
        assert np.array_equal(np.asarray(jl.pool), tbm.to_numpy(tl.pool))
    jd, jb, jt, jix = jp._stage()
    td, tb, tt, tix, _dev = tp._stage()
    assert jt == tt
    assert np.array_equal(jb, tb)
    assert all(np.array_equal(a, b) for a, b in zip(jd, td))
    assert all(np.array_equal(a, b) for a, b in zip(jix, tix))


@pytest.mark.parametrize("q", QUERIES)
def test_counts_and_row_words_equal(holders, q):
    jp, tp = _plans(holders, q, counts=True)
    if jp is None:
        return
    assert tp.counts() == jp.counts()
    jp, tp = _plans(holders, q, counts=False)
    jw, tw = jp.row_words(), tp.row_words()
    assert [s for s, _ in jw] == [s for s, _ in tw]
    for (_, a), (_, b) in zip(jw, tw):
        assert np.array_equal(a, b)


def test_and_pair_on_cpu_pools_takes_the_plain_version(holders):
    _jp, tp = _plans(holders, QUERIES[0], counts=True)
    before = ck.gathered_count_and.launches
    with tbm.dispatch_counter() as dc:
        tp.counts()
    assert dc.launches == ["gathered_pair_counts"]
    assert ck.gathered_count_and.launches == before


def test_containers_from_numpy_feeds_both_packages_identical_pools(holders):
    jp, _tp = _plans(holders, QUERIES[0], counts=True)
    tleaves = [tct.containers_from_numpy(np.asarray(l.pool), l.entries,
                                         l.starts, l.n, torch.device("cpu"))
               for l in jp.leaves]
    shards = jp.shards
    tplan = tct.Plan(("and", ("leaf", 0), ("leaf", 1)), tleaves, shards,
                     SHARD_WIDTH // tct.CONTAINER_BITS,
                     tbm.n_words(SHARD_WIDTH))
    _d, _b, total, jix = jp._stage()
    _d2, _b2, total2, tix, dev_ix = tplan._stage()
    assert total == total2
    assert all(np.array_equal(a, b) for a, b in zip(jix, tix))
    pallas = np.asarray(pk.gathered_count_and(
        np.asarray(jp.leaves[0].pool), jix[0], np.asarray(jp.leaves[1].pool),
        jix[1], interpret=True))
    plain = tbm.gathered_pair_counts(tleaves[0].pool, dev_ix[0],
                                     tleaves[1].pool, dev_ix[1]).numpy()
    assert np.array_equal(plain, pallas)
    assert tplan.counts() == jp.counts()


def test_threshold_change_reroutes_and_counters_move(holders):
    _jp, tp = _plans(holders, QUERIES[7], counts=True)
    assert tp is None
    assert tct.counters()["container.fallbacks"] >= 1
    tct.configure(threshold=0.5)
    jct.configure(threshold=0.5)
    jp, tp = _plans(holders, QUERIES[7], counts=True)
    assert jp is not None and tp is not None
    assert tp.counts() == jp.counts()
    assert tct.counters()["container.queries"] >= 1
