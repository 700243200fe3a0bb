"""Tests of the port that need an NVIDIA card: the CUDA kernels K2
(``gathered_count_and``), K3 (``vm_counts``, the bitmap VM), K3-kinds
(``vm_counts_kinds``, the VM over array and run containers), K4
(``row_counts_masked``, the TopN scan), K5 (``masked_matrix_counts``,
the GroupBy count), K6 (``bsi_compare``, the BSI ripple) and K1
(``count_and``) against their plain versions (K3 also on the launches
of tests/torch_vm_cases.py, its shared memory formula against the
source's), the executor's
``Count(Intersect(Row, Row))`` route launching K2 on ``cuda`` pools, a
coalesced heterogeneous batch launching K3 once (both with container
kinds off, so that the sparse rows stay bitmap blocks), K3-kinds at the
edges of its decode (tests/torch_kinds_edges.py), a coalesced
batch over array, run and bitmap rows launching K3-kinds once,
coalesced batches over rows with pending ingest deltas launching K3 and
K3-kinds once on ``dfuse`` tapes (each launch held against its plain
version), TopN and GroupBy
launching K4 and K5, counts over a mutex field launching K2 and K3
before and after a mutex move and GroupBy over mutex and bool fields
launching K5, and an int field's range rows and aggregates
launching K6, K4 and K1 where the CPU tests see their dispatch sites,
K3 and K3-kinds launched at once from many threads with different
shared memory sizes, and an expired request or coalescer entry launching
neither K2 nor K3 while its live batchmates share one K3 launch.

Without a card every test here skips.  On a machine with one, run

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o markers=cuda -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets JAX up, and this file imports
nothing of JAX or of the JAX package; ``-o markers=cuda`` registers the
marker that tests/conftest.py registers elsewhere).  The first test
builds the kernel with nvcc.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import bitmap as bm
from pilosa_tpu_torch.ops import containers
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import kindpools as kp
from pilosa_tpu_torch.ops import tape
from pilosa_tpu_torch.parallel.coalescer import Coalescer
from pilosa_tpu_torch.parallel.executor import ExecOptions, Executor
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# tests/ is on sys.path under pytest (rootdir-less test files); another
# installed package may be named ``tests``
import torch_kinds_edges as edges  # noqa: E402
import torch_vm_cases as vm_cases  # noqa: E402

CW = ck.CONTAINER_WORDS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def bitmap_containers():
    """[containers] kinds off for one test: its sparse rows stay bitmap
    blocks.  Restores the one field it sets."""
    was = containers.config().kinds
    containers.configure(kinds=False)
    yield
    containers.configure(kinds=was)


def _pools(seed: int, na: int, nb: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, size=(na, CW), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(nb, CW), dtype=np.uint32)
    a[-1] = 0  # the canonical absent-container row
    b[-1] = 0
    b[0] = 0xFFFFFFFF
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 37, 4096])
def test_k2_matches_its_plain_version(cuda_device, p):
    a, b = _pools(13 + p, 64, 33)
    rng = np.random.default_rng(p)
    # indices past either end clamp to the first / last row
    ai = rng.integers(-3, 67, size=p, dtype=np.int32)
    bi = rng.integers(-3, 36, size=p, dtype=np.int32)
    ta, tb = bm.to_tensor(a, cuda_device), bm.to_tensor(b, cuda_device)
    tai = torch.from_numpy(ai).to(cuda_device)
    tbi = torch.from_numpy(bi).to(cuda_device)
    before = ck.gathered_count_and.launches
    got = ck.gathered_count_and(ta, tai, tb, tbi)
    torch.cuda.synchronize()
    assert ck.gathered_count_and.launches == before + 1
    want = np.array([int(np.bitwise_count(
        a[min(max(x, 0), 63)] & b[min(max(y, 0), 32)]).sum())
        for x, y in zip(ai, bi)])
    assert torch.equal(got, bm.gathered_pair_counts(ta, tai, tb, tbi))
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_k2_refuses_operands_on_two_devices(cuda_device):
    a = torch.zeros((4, CW), dtype=torch.int32, device=cuda_device)
    ai = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.gathered_count_and(a, ai, a, ai.to(cuda_device))


@pytest.mark.cuda
def test_count_intersect_on_cuda_launches_k2_once(cuda_device,
                                                  bitmap_containers):
    rng = np.random.default_rng(5)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    f = idx.create_field("f")
    cols = {r: rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 20,
                          replace=False) for r in (1, 2)}
    for r, c in cols.items():
        f.import_bits(np.full(len(c), r), c)
    # the imports wait in the fragments' delta planes, which route a
    # Count dense; compacted, the rows take the container route
    f.flush_deltas()
    want = len(set(cols[1].tolist()) & set(cols[2].tolist()))
    ex = Executor(h, device=cuda_device)
    pql = "Count(Intersect(Row(f=1), Row(f=2)))"
    with bm.dispatch_counter() as dc:
        got = ex.execute("i", pql)
    assert got == [want]
    assert dc.launches == ["gathered_count_and"]
    assert ex.execute("i", pql, opt=ExecOptions(containers=False)) == [want]
    h.close()


def _vm_case(seed: int, slots: int, tape_len: int, n_q: int, domain: int,
             rows: int):
    """Seeded pool, random SSA programs over all five opcodes, and a
    gather directory whose pad slots point at the zero row."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2 ** 32, size=(rows, CW), dtype=np.uint32)
    pool[rows - 1] = 0
    pool[0] = 0xFFFFFFFF
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = (rng.integers(5), rng.integers(slots + t),
                          rng.integers(slots + t))
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    gidx[slots - 1] = rows - 1
    return pool, prog, gidx


@pytest.mark.cuda
@pytest.mark.parametrize("slots,tape_len,n_q,domain,rows", [
    (1, 1, 1, 1, 2), (4, 4, 4, 8, 64), (16, 32, 2, 16, 40),
    (4, 4, 8, 512, 8192)])
def test_k3_matches_its_plain_version(cuda_device, slots, tape_len, n_q,
                                      domain, rows):
    pool, prog, gidx = _vm_case(slots * 100 + tape_len, slots, tape_len,
                                n_q, domain, rows)
    tpool = bm.to_tensor(pool, cuda_device)
    tprog, tgidx = torch.from_numpy(prog), torch.from_numpy(gidx)
    before = ck.vm_counts.launches
    got = ck.vm_counts(tpool, tprog, tgidx)
    torch.cuda.synchronize()
    assert ck.vm_counts.launches == before + 1
    want = ck.vm_counts_plain(tpool, tprog, tgidx)
    assert torch.equal(got, want)
    # host-built and card-resident directories give the same answer
    dev = ck.vm_counts(tpool, tprog.to(cuda_device), tgidx.to(cuda_device))
    assert torch.equal(dev, want)
    assert np.array_equal(
        got.cpu().numpy(),
        ck.vm_counts_plain(bm.to_tensor(pool), tprog, tgidx).numpy())


@pytest.mark.cuda
def test_k3_refuses_an_index_past_the_pool(cuda_device):
    pool, prog, gidx = _vm_case(3, 2, 2, 1, 4, 6)
    gidx[0, 0, 3] = 6
    with pytest.raises(IndexError):
        ck.vm_counts(bm.to_tensor(pool, cuda_device), torch.from_numpy(prog),
                     torch.from_numpy(gidx).to(cuda_device))


@functools.lru_cache(maxsize=1)
def _k3_cases() -> dict:
    return {label: case for label, *case in vm_cases.k3_cases(92, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["shared", "same_row", "pads", "caps",
                                   "grouped", "l64t32", "dfuse"])
def test_k3_plans_match_the_plain_version_in_one_launch(cuda_device, label):
    """tests/torch_vm_cases.py at D = 64: 16 queries sharing five leaves,
    one row in two slots, pads and COPY chains, the caps (16, 32), a
    batch cut into query groups, and (L, T) = (64, 32)."""
    pool, prog, gidx = _k3_cases()[label]
    tpool = bm.to_tensor(pool, cuda_device)
    tprog, tgidx = torch.from_numpy(prog), torch.from_numpy(gidx)
    plan = ck.vm_plan(tprog, tgidx)
    if label == "grouped":
        assert plan.n_groups > 1
    before = ck.vm_counts.launches
    got = ck.vm_counts(tpool, tprog, tgidx)
    torch.cuda.synchronize()
    assert ck.vm_counts.launches == before + 1
    want = ck.vm_counts_plain(tpool, tprog, tgidx)
    assert torch.equal(got, want)
    # one vector per thread and pass, where the plan took two, gives the
    # same counts
    if plan.vec == 2:
        tgidx = tgidx.to(cuda_device)
        p = ck.vm_plan(tprog, tgidx, 1)
        p = p._replace(meta=p.meta.to(cuda_device))
        assert torch.equal(ck._vm_launch(tpool, tgidx, p), want)


@pytest.mark.cuda
def test_k3_shared_memory_formula_is_the_sources(cuda_device):
    import ctypes

    from pilosa_tpu_torch.ops import nvcc_build

    fn = nvcc_build.load("vm_counts").vm_counts_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    for args in ((1, 0, 1, 1, 1), (5, 1, 4, 4, 2), (5, 0, 16, 4, 2),
                 (16, 32, 1, 32, 1), (112, 0, 7, 32, 1), (64, 32, 1, 32, 1),
                 (20, 3, 8, 8, 2)):
        assert fn(*args) == ck.vm_group_smem_bytes(*args)


@pytest.mark.cuda
def test_a_coalesced_heterogeneous_batch_launches_k3_once(
        cuda_device, bitmap_containers):
    import threading

    rng = np.random.default_rng(9)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    f = idx.create_field("f")
    cols = {r: rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 20,
                          replace=False) for r in (1, 2, 3)}
    for r, c in cols.items():
        f.import_bits(np.full(len(c), r), c)
    # the imports wait in delta planes, whose dfuse leaves would put the
    # 2- and 3-row trees in two tape size classes; compacted, they share
    # one launch
    f.flush_deltas()
    sets = {r: set(c.tolist()) for r, c in cols.items()}
    qs = {"Count(Intersect(Row(f=1), Row(f=2)))": sets[1] & sets[2],
          "Count(Union(Row(f=1), Row(f=3)))": sets[1] | sets[3],
          "Count(Difference(Row(f=2), Row(f=1), Row(f=3)))":
              sets[2] - sets[1] - sets[3],
          "Count(Xor(Row(f=3), Row(f=2)))": sets[3] ^ sets[2]}
    ex = Executor(h, device=cuda_device)
    ex.coalescer = Coalescer(window_s=2.0, max_batch=len(qs),
                             device=cuda_device)
    assert ex.coalescer.enabled  # "auto" on a card
    tape.reset_counters()
    before = ck.vm_counts.launches
    bar = threading.Barrier(len(qs))
    got = {}

    def run(q):
        bar.wait()
        got[q] = ex.execute("i", q)[0]

    ts = [threading.Thread(target=run, args=(q,)) for q in qs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert got == {q: len(s) for q, s in qs.items()}
    assert ck.vm_counts.launches - before == \
        tape.counters()["vm.executions"] == 1
    h.close()


def _kind_blocks(rng, n: int) -> np.ndarray:
    """n dense containers cycling through array, run and bitmap styles,
    with the boundary bits 0 and 65535 in some."""
    blocks = np.zeros((n, CW), dtype=np.uint32)
    for i in range(n):
        style = i % 3
        if style == 0:
            pos = rng.choice(1 << 16, int(rng.integers(1, 4000)),
                             replace=False)
        elif style == 1:
            starts = np.sort(rng.choice((1 << 16) // 256,
                                        int(rng.integers(1, 200)),
                                        replace=False)) * 256
            pos = np.concatenate([np.arange(s0, s0 + int(rng.integers(
                1, 250))) for s0 in starts])
        else:
            pos = rng.choice(1 << 16, 20000, replace=False)
        if i % 7 == 0:
            pos = np.concatenate([pos, [0, 65535]])
        w = np.zeros(CW, dtype=np.uint32)
        np.bitwise_or.at(w, pos >> 5, np.uint32(1) << (pos & 31).astype(
            np.uint32))
        blocks[i] = w
    return blocks


def _kinds_case(seed: int, n_blocks: int, slots: int, tape_len: int,
                n_q: int, domain: int, device):
    """A kind-split megapool from seeded containers (each pool's last
    row its canonical empty row), random SSA programs over all five
    opcodes and a directory whose last slot gathers the zero row."""
    rng = np.random.default_rng(seed)
    blocks = _kind_blocks(rng, n_blocks)
    _s, bb, ap, ac, rp = kp.split_pools(blocks, kp.pick_kinds(blocks))
    bpool = np.concatenate([bb, np.zeros((1, CW), np.uint32)])
    apool = np.concatenate([ap, np.full((1, ap.shape[1]), 0xFFFF,
                                        np.uint16)])
    acard = np.concatenate([ac, np.zeros(1, np.int32)])
    pad = np.zeros((1, rp.shape[1]), np.uint16)
    pad[:, 0::2] = 1
    rpool = np.concatenate([rp, pad])
    rows = len(bpool) + len(apool) + len(rpool)
    prog = np.zeros((n_q, tape_len, 3), dtype=np.int32)
    for q in range(n_q):
        for t in range(tape_len):
            prog[q, t] = (rng.integers(5), rng.integers(slots + t),
                          rng.integers(slots + t))
    gidx = rng.integers(0, rows, size=(slots, n_q, domain)).astype(np.int32)
    gidx[slots - 1] = len(bpool) - 1
    return (bm.to_tensor(bpool, device),
            torch.from_numpy(apool.view(np.int16)).to(device),
            torch.from_numpy(acard).to(device),
            torch.from_numpy(rpool.view(np.int16)).to(device),
            torch.from_numpy(prog), torch.from_numpy(gidx))


def _edge_kinds_case(case: str, slots: int, tape_len: int, n_q: int,
                     domain: int, device):
    """The megapools of tests/torch_kinds_edges.py on ``device``: a random
    program at one shape (``edges``), every row alone (``decode``), or
    split_pools' pools with the run rows re-padded to rcap 256
    (``repad``)."""
    if case == "decode":
        bpool, apool, acard, rpool, prog, gidx = edges.decode_case(71)
    elif case == "repad":
        rng = np.random.default_rng(72)
        blocks = _kind_blocks(rng, 60)
        _s, bb, ap, ac, rp = kp.split_pools(blocks, kp.pick_kinds(blocks))
        bpool = np.concatenate([bb, np.zeros((1, CW), np.uint32)])
        apool = np.concatenate([ap, np.full((1, ap.shape[1]), 0xFFFF,
                                            np.uint16)])
        acard = np.concatenate([ac, np.zeros(1, np.int32)])
        rpool = edges.repad(np.concatenate([rp, edges.repad(
            np.zeros((1, 0), np.uint16), rp.shape[1] // 2)]), 256)
        rows = len(bpool) + len(apool) + len(rpool)
        prog, gidx = edges.random_program(rng, n_q, slots, tape_len, rows,
                                          domain, len(bpool) - 1)
    else:
        bpool, apool, acard, rpool, prog, gidx = edges.edge_case(
            70 + slots, slots, tape_len, n_q, domain)
    return (bm.to_tensor(bpool, device),
            torch.from_numpy(apool.view(np.int16)).to(device),
            torch.from_numpy(acard).to(device),
            torch.from_numpy(rpool.view(np.int16)).to(device),
            torch.from_numpy(prog), torch.from_numpy(gidx))


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,slots,tape_len,n_q,domain", [
    (3, 1, 1, 1, 1), (30, 4, 4, 4, 8), (60, 16, 32, 2, 16),
    # the containers of 2^20-column rows: 16 per shard, 256 shards
    (4096, 4, 4, 8, 512),
    # the decode's edges (tests/torch_kinds_edges.py): pass and warp
    # boundaries, full and empty arrays, long, short and 256 runs, at the
    # served caps and at a large admitted shape; every row alone; run
    # rows re-padded to a wider rcap
    ("edges", 4, 4, 4, 64), ("edges", 16, 32, 2, 16),
    ("edges", 64, 32, 2, 8), ("decode", 1, 1, 1, 0), ("repad", 4, 8, 4, 32)])
def test_k3_kinds_matches_its_plain_version(cuda_device, n_blocks, slots,
                                            tape_len, n_q, domain):
    if isinstance(n_blocks, str):
        args = _edge_kinds_case(n_blocks, slots, tape_len, n_q, domain,
                                cuda_device)
    else:
        args = _kinds_case(n_blocks + slots, n_blocks, slots, tape_len,
                           n_q, domain, cuda_device)
    before = ck.vm_counts_kinds.launches
    got = ck.vm_counts_kinds(*args)
    torch.cuda.synchronize()
    assert ck.vm_counts_kinds.launches == before + 1
    want = ck.vm_counts_kinds_plain(*args)
    assert torch.equal(got, want)
    cpu = [a.cpu() for a in args]
    assert np.array_equal(got.cpu().numpy(),
                          ck.vm_counts_kinds(*cpu).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vm_counts", "vm_counts_kinds"])
def test_vm_launches_of_different_sizes_from_many_threads(cuda_device,
                                                          kernel):
    """The coalescer flushes each bucket on its leader's thread, so K3
    and K3-kinds launches of different shared memory sizes run at once.
    The size limit is one attribute of the kernel for every thread, so
    each launch sets it and enqueues under a lock; without it a launch
    finds a smaller thread's limit and fails (cudaErrorInvalidValue)."""
    import threading

    if kernel == "vm_counts":
        fn, plain = ck.vm_counts, ck.vm_counts_plain
        cases = []
        for shape in ((1, 1, 1, 1, 2), (16, 32, 2, 16, 40), (4, 4, 4, 8, 64)):
            pool, prog, gidx = _vm_case(shape[0] * 100 + shape[1], *shape)
            cases.append((bm.to_tensor(pool, cuda_device),
                          torch.from_numpy(prog), torch.from_numpy(gidx)))
    else:
        fn, plain = ck.vm_counts_kinds, ck.vm_counts_kinds_plain
        cases = [_kinds_case(n + s, n, s, t, q, d, cuda_device)
                 for n, s, t, q, d in ((3, 1, 1, 1, 1), (60, 16, 32, 2, 16),
                                       (30, 4, 4, 4, 8))]
    wants = [plain(*args) for args in cases]
    n_threads, rounds = 8, 60
    bar = threading.Barrier(n_threads)
    errs: list = []

    def client(i):
        try:
            bar.wait(timeout=60)
            for r in range(rounds):
                j = (i + r) % len(cases)
                got = fn(*cases[j])
                torch.cuda.synchronize()
                assert torch.equal(got, wants[j]), (i, r, j)
        except BaseException as e:  # noqa: BLE001 -- reported below
            errs.append(f"{type(e).__name__}: {e}")
            bar.abort()

    before = fn.launches
    ts = [threading.Thread(target=client, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs[:3]
    assert fn.launches == before + n_threads * rounds


@pytest.mark.cuda
def test_k3_kinds_refuses_an_index_past_the_pools(cuda_device):
    bpool, apool, acard, rpool, prog, gidx = _kinds_case(
        4, 9, 2, 2, 1, 4, cuda_device)
    gidx[0, 0, 3] = bpool.shape[0] + apool.shape[0] + rpool.shape[0]
    with pytest.raises(IndexError):
        ck.vm_counts_kinds(bpool, apool, acard, rpool, prog, gidx)


@pytest.mark.cuda
def test_a_mixed_kind_coalesced_batch_launches_k3_kinds_once(cuda_device):
    import threading

    rng = np.random.default_rng(19)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    f = idx.create_field("f")
    width = n_shards * SHARD_WIDTH
    cols = {1: rng.choice(width, size=width // 1000, replace=False),
            2: np.concatenate([np.arange(s, s + 512) for s in range(
                0, width, 8192)]),
            3: rng.choice(width, size=width // 12, replace=False)}
    for r, c in cols.items():
        f.import_bits(np.full(len(c), r), c)
    f.flush_deltas()  # base rows: their kinds, one size class
    kinds = {int(k) for r in cols for s in range(n_shards)
             for k in f.fragment(s).row_container_kinds(r)[3]}
    assert kinds == {1, 2, 3}  # array, bitmap and run rows
    sets = {r: set(c.tolist()) for r, c in cols.items()}
    qs = {"Count(Intersect(Row(f=1), Row(f=2)))": sets[1] & sets[2],
          "Count(Union(Row(f=1), Row(f=3)))": sets[1] | sets[3],
          "Count(Difference(Row(f=3), Row(f=1), Row(f=2)))":
              sets[3] - sets[1] - sets[2],
          "Count(Xor(Row(f=2), Row(f=3)))": sets[2] ^ sets[3]}
    ex = Executor(h, device=cuda_device)
    ex.coalescer = Coalescer(window_s=2.0, max_batch=len(qs),
                             device=cuda_device)
    tape.reset_counters()
    before = (ck.vm_counts.launches, ck.vm_counts_kinds.launches)
    bar = threading.Barrier(len(qs))
    got = {}

    def run(q):
        bar.wait()
        got[q] = ex.execute("i", q)[0]

    ts = [threading.Thread(target=run, args=(q,)) for q in qs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert got == {q: len(s) for q, s in qs.items()}
    assert ck.vm_counts.launches == before[0]
    assert ck.vm_counts_kinds.launches - before[1] == \
        tape.counters()["vm.executions"] == 1
    h.close()


def _delta_batch(device, rows: dict, writes: dict, monkeypatch) -> tuple:
    """Rows imported and compacted, then ``writes`` ({row: (sets,
    clears)}) left pending in the delta planes; four coalesced Counts
    over them on ``device``.  Every VM launch is held against its plain
    version.  Returns (answers, oracle, staged shapes, K3 launches,
    K3-kinds launches, vm.executions)."""
    import threading

    h = Holder(None, device=device)
    f = h.create_index("i").create_field("f")
    for r, c in rows.items():
        f.import_bits(np.full(len(c), r), c)
    f.flush_deltas()
    sets = {r: set(c.tolist()) for r, c in rows.items()}
    for r, (add, drop) in writes.items():
        f.import_bits(np.full(len(add), r), add)
        f.import_bits(np.full(len(drop), r), drop, clear=True)
        sets[r] = (sets[r] | set(add.tolist())) - set(drop.tolist())
    assert all(f.fragment(s)._delta is not None for s in range(3))
    # three rows each: nine slots with the overlays, one size class
    qs = {"Count(Intersect(Row(f=1), Row(f=2), Row(f=3)))":
              sets[1] & sets[2] & sets[3],
          "Count(Union(Row(f=1), Row(f=3), Row(f=2)))":
              sets[1] | sets[3] | sets[2],
          "Count(Difference(Row(f=3), Row(f=1), Row(f=2)))":
              sets[3] - sets[1] - sets[2],
          "Count(Xor(Row(f=2), Row(f=3), Row(f=1)))":
              sets[2] ^ sets[3] ^ sets[1]}
    shapes = []
    real_stage = containers.stage_vm

    def stage(*a, **k):
        st = real_stage(*a, **k)
        shapes.append(None if st is None else st.shape)
        return st

    real = {n: getattr(ck, n) for n in ("vm_counts", "vm_counts_kinds")}

    def held(name):
        def run(*args):
            got = real[name](*args)
            want = getattr(ck, name + "_plain")(*args)
            assert torch.equal(got, want), name
            return got
        return run

    # the VM's launches go through a stand-in for the kernels module, so
    # that each is held against its plain version while the wrappers
    # count their launches as always
    import types

    monkeypatch.setattr(containers, "stage_vm", stage)
    monkeypatch.setattr(tape, "cuda_kernels", types.SimpleNamespace(
        **{name: held(name) for name in real}))
    ex = Executor(h, device=device)
    ex.coalescer = Coalescer(window_s=2.0, max_batch=len(qs), device=device)
    tape.reset_counters()
    before = {n: w.launches for n, w in real.items()}
    bar = threading.Barrier(len(qs))
    got = {}

    def run(q):
        bar.wait()
        got[q] = ex.execute("i", q)[0]

    ts = [threading.Thread(target=run, args=(q,)) for q in qs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    h.close()
    return (got, {q: len(s) for q, s in qs.items()}, shapes,
            real["vm_counts"].launches - before["vm_counts"],
            real["vm_counts_kinds"].launches - before["vm_counts_kinds"],
            tape.counters()["vm.executions"])


def _delta_writes(rng, width: int) -> dict:
    """A few sets and clears on every row, in every shard."""
    return {r: (rng.choice(width, size=40, replace=False),
                rng.choice(width, size=40, replace=False)) for r in (1, 2, 3)}


@pytest.mark.cuda
def test_coalesced_counts_over_pending_deltas_launch_k3_once(
        cuda_device, bitmap_containers, monkeypatch):
    rng = np.random.default_rng(29)
    width = 3 * SHARD_WIDTH
    rows = {r: rng.choice(width, size=SHARD_WIDTH // 20, replace=False)
            for r in (1, 2, 3)}
    got, want, shapes, k3, k3k, execs = _delta_batch(
        cuda_device, rows, _delta_writes(rng, width), monkeypatch)
    assert got == want
    assert shapes and all(s is not None and "dfuse" in str(s)
                          for s in shapes)
    assert (k3, k3k) == (1, 0) and execs == 1


@pytest.mark.cuda
def test_coalesced_counts_over_pending_deltas_launch_k3_kinds_once(
        cuda_device, monkeypatch):
    rng = np.random.default_rng(31)
    width = 3 * SHARD_WIDTH
    rows = {1: rng.choice(width, size=width // 1000, replace=False),
            2: np.concatenate([np.arange(s, s + 512) for s in range(
                0, width, 8192)]),
            3: rng.choice(width, size=width // 12, replace=False)}
    got, want, shapes, k3, k3k, execs = _delta_batch(
        cuda_device, rows, _delta_writes(rng, width), monkeypatch)
    assert got == want
    assert shapes and all(s is not None and "dfuse" in str(s)
                          for s in shapes)
    assert (k3, k3k) == (0, 1) and execs == 1


def _words(seed: int, shape) -> np.ndarray:
    """Random words, every 7th with bit 31 set."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, size=shape,
                                             dtype=np.uint32)
    w.reshape(-1)[::7] |= np.uint32(1 << 31)
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_filt,words,indexed", [
    (1, 1, 64, False), (5, 1, 2048, False), (130, 1, 2100, False),
    (130, 4, 2100, True), (7, 3, 2099, True), (4096, 64, 32768, True)])
def test_k4_matches_its_plain_version(cuda_device, rows, n_filt, words,
                                      indexed):
    mat = bm.to_tensor(_words(rows + words, (rows, words)), cuda_device)
    filt = bm.to_tensor(_words(n_filt, (n_filt, words)), cuda_device)
    idx = None
    if indexed:
        idx = torch.from_numpy(np.random.default_rng(rows).integers(
            0, n_filt, size=rows).astype(np.int32)).to(cuda_device)
    before = ck.row_counts_masked.launches
    got = ck.row_counts_masked(mat, filt, idx)
    torch.cuda.synchronize()
    assert ck.row_counts_masked.launches == before + 1
    assert torch.equal(got, bm.row_counts_masked_plain(mat, filt, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("groups,rows,words", [
    (1, 1, 256), (3, 130, 300), (9, 130, 256), (4, 64, 32768),
    (64, 64, 32768), (33, 65, 1001)])
def test_k5_matches_its_plain_version(cuda_device, groups, rows, words):
    mat = bm.to_tensor(_words(rows, (rows, words)), cuda_device)
    masks = _words(groups + 100, (groups, words))
    masks[groups - 1] = 0
    masks = bm.to_tensor(masks, cuda_device)
    before = ck.masked_matrix_counts.launches
    got = ck.masked_matrix_counts(mat, masks)
    torch.cuda.synchronize()
    assert ck.masked_matrix_counts.launches == before + 1
    assert torch.equal(got, bm.masked_matrix_counts_plain(mat, masks))


@pytest.mark.cuda
def test_topn_and_groupby_on_cuda_launch_k4_and_k5(cuda_device):
    rng = np.random.default_rng(21)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    sets = {}
    for fname, rows in (("f", (1,)), ("s", range(6)), ("u", range(4))):
        fld = idx.create_field(fname)
        for r in rows:
            c = rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 16,
                           replace=False)
            fld.import_bits(np.full(len(c), r), c)
            sets[fname, r] = set(c.tolist())
    ex = Executor(h, device=cuda_device)
    counts = {r: len(sets["s", r] & sets["f", 1]) for r in range(6)}
    want = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    before = ck.launch_counts()
    got = ex.execute("i", "TopN(s, Row(f=1), n=3)")[0]
    assert [(p.id, p.count) for p in got] == want
    groups = ex.execute("i", "GroupBy(Rows(s), Rows(u))")[0]
    assert {(gc.group[0].row_id, gc.group[1].row_id): gc.count
            for gc in groups} == {
        (a, b): len(sets["s", a] & sets["u", b])
        for a in range(6) for b in range(4)
        if sets["s", a] & sets["u", b]}
    after = ck.launch_counts()
    assert after["row_counts_masked"] - before["row_counts_masked"] == 1
    assert (after["masked_matrix_counts"]
            - before["masked_matrix_counts"]) == n_shards
    h.close()


@pytest.mark.cuda
def test_mutex_and_bool_fields_on_cuda_launch_k2_k3_and_k5(
        cuda_device, bitmap_containers):
    """Counts over a mutex row run K2 (one lone fused Count) and K3
    (coalesced), before and after a write moves a column between rows;
    GroupBy(Rows(m), Rows(b)) runs one K5 per shard; a bool literal is
    not fused and launches nothing."""
    rng = np.random.default_rng(33)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    f = idx.create_field("f")
    m = idx.create_field("m", FieldOptions.mutex_field())
    b = idx.create_field("b", FieldOptions.bool_field())
    n = SHARD_WIDTH // 64
    perm = rng.permutation(n_shards * SHARD_WIDTH)[:4 * n]
    fc = rng.choice(n_shards * SHARD_WIDTH, size=2 * n, replace=False)
    f.import_bits(np.ones(len(fc), dtype=np.int64), fc)
    f.flush_deltas()
    rows = np.repeat(np.arange(1, 4), n)
    m.import_bits(rows, perm[:3 * n])  # one row per column, bit by bit
    b.import_bits(np.arange(2 * n) % 2, perm[n:3 * n])
    sets = {("m", r): set(perm[(r - 1) * n:r * n].tolist())
            for r in range(1, 4)}
    for r in (0, 1):
        sets["b", r] = set(perm[n:3 * n][r::2].tolist())
    f1 = set(fc.tolist())
    pql = "Count(Intersect(Row(m=2), Row(f=1)))"
    ex = Executor(h, device=cuda_device)
    co = Coalescer(window_s=0.05, max_batch=1, enabled=True,
                   device=cuda_device)
    for step in range(2):
        want = [len(sets["m", 2] & f1)]
        ex.coalescer = None
        k0 = ck.launch_counts()
        assert ex.execute("i", pql, opt=ExecOptions(cache=False)) == want
        ex.coalescer = co
        assert ex.execute("i", pql, opt=ExecOptions(cache=False)) == want
        k1 = ck.launch_counts()
        assert {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]} == {
            "gathered_count_and": 1, "vm_counts": 1}
        if step == 0:
            # move a column of f=1's from row 1 to row 2
            col = sorted(sets["m", 1] & f1)[0]
            assert ex.execute("i", f"Set({col}, m=2)") == [True]
            sets["m", 1].discard(col)
            sets["m", 2].add(col)
    k0 = ck.launch_counts()
    assert ex.execute("i", "Count(Row(b=true))") == [len(sets["b", 1])]
    groups = ex.execute("i", "GroupBy(Rows(m), Rows(b))",
                        opt=ExecOptions(cache=False))[0]
    assert {(gc.group[0].row_id, gc.group[1].row_id): gc.count
            for gc in groups} == {
        (a, c): len(sets["m", a] & sets["b", c])
        for a in range(1, 4) for c in (0, 1)
        if sets["m", a] & sets["b", c]}
    k1 = ck.launch_counts()
    assert {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]} == {
        "masked_matrix_counts": n_shards}
    h.close()


def _bsi_planes(seed: int, shards: int, depth: int, words: int
                ) -> np.ndarray:
    """uint32 [shards, 2 + depth, words]: random planes, bit 31 set in
    every 7th word, one all-ones and one all-zero column word."""
    p = _words(seed, (shards, 2 + depth, words))
    p[:, :, 0] = 0xFFFFFFFF
    p[:, :, -1] = 0
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 20, 63])
@pytest.mark.parametrize("shards,words", [(1, 2099), (3, 2048), (2, 7)])
def test_k6_matches_its_plain_version(cuda_device, depth, shards, words):
    P = _bsi_planes(depth + words, shards, depth, words)
    cons = _words(depth + 1, (shards, words))
    tP, tc = bm.to_tensor(P, cuda_device), bm.to_tensor(cons, cuda_device)
    for upred in (0, 1, 2 ** depth - 1, (2 ** depth - 1) // 3,
                  2 ** depth, 2 ** 64 - 1):
        before = ck.bsi_compare.launches
        lt, gt = ck.bsi_compare(tP, tc, upred, depth)
        torch.cuda.synchronize()
        assert ck.bsi_compare.launches == before + 1
        want = ck.bsi_compare_plain(tP, tc, upred, depth)
        assert torch.equal(lt, want[0]) and torch.equal(gt, want[1])
        # the Pallas entry's function, early-out included
        ult, ugt = ck.bsi_compare_unsigned(tP[0], tc[0], upred, depth)
        cpu = ck.bsi_compare_unsigned(tP[0].cpu(), tc[0].cpu(), upred,
                                      depth)
        assert torch.equal(ult.cpu(), cpu[0])
        assert torch.equal(ugt.cpu(), cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2047, 2049, 100003, 2 ** 20])
def test_k1_matches_its_plain_version(cuda_device, n):
    a = _words(n, (n,))
    b = _words(n + 1, (n,))
    ta, tb = bm.to_tensor(a, cuda_device), bm.to_tensor(b, cuda_device)
    before = ck.count_and.launches
    got = ck.count_and(ta, tb)
    assert ck.count_and.launches == before + 1
    assert got == ck.count_and_plain(ta, tb)
    assert got == int(np.bitwise_count(a & b).sum())
    # a plane of a stack, strided rows, and a misaligned base
    P = bm.to_tensor(_bsi_planes(n, 4, 3, 1030), cuda_device)
    assert ck.count_and(P[:, 0], P[:, 2]) == \
        ck.count_and_plain(P[:, 0], P[:, 2])
    assert ck.count_and(ta[1:], tb[1:]) == ck.count_and_plain(ta[1:], tb[1:])


@pytest.mark.cuda
def test_k1_counts_past_two_to_the_31(cuda_device):
    ones = torch.full((2 ** 26,), -1, dtype=torch.int32, device=cuda_device)
    assert ck.count_and(ones, ones) == 2 ** 31
    assert ck.count_and(ones.view(2 ** 10, 2 ** 16), ones.view(
        2 ** 10, 2 ** 16)) == 2 ** 31


@pytest.mark.cuda
def test_int_field_on_cuda_launches_k6_k4_and_k1(cuda_device):
    rng = np.random.default_rng(23)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    from pilosa_tpu_torch.models.field import FieldOptions

    v = idx.create_field("v", FieldOptions.int_field(-1000, 1000))
    cols = rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 4,
                      replace=False)
    vals = rng.integers(-1000, 1001, size=len(cols))
    v.import_values(cols, vals)
    f = idx.create_field("f")
    fc = rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 2,
                    replace=False)
    f.import_bits(np.ones(len(fc), dtype=np.int64), fc)
    ex = Executor(h, device=cuda_device)
    inf = np.isin(cols, fc)
    for q, want, k6, k4, k1 in (
            ("Count(Row(v > 10))", int((vals > 10).sum()), 1, 0, 0),
            ("Count(Row(-5 < v < 300))",
             int(((vals > -5) & (vals < 300)).sum()), 2, 0, 0),
            ("Sum(Row(f=1), field=v)", (int(vals[inf].sum()),
                                        int(inf.sum())), 0, 2, 1),
            ("Max(field=v)", (int(vals.max()),
                              int((vals == vals.max()).sum())), 0, 0, 0)):
        before = ck.launch_counts()
        got = ex.execute("i", q)[0]
        if not isinstance(got, int):
            got = (got.val, got.count)
        assert got == want, q
        after = ck.launch_counts()
        assert after["bsi_compare"] - before["bsi_compare"] == k6, q
        assert after["row_counts_masked"] - before["row_counts_masked"] \
            == k4, q
        assert after["count_and"] - before["count_and"] == k1, q
    h.close()


@pytest.mark.cuda
def test_keyed_protobuf_queries_on_cuda_launch_k3_k2_k4_and_k5(
        cuda_device, bitmap_containers, tmp_path):
    """A keyed field's rows are bitmap rows of the same index: a keyed
    protobuf ``Count(Intersect)`` launches K3 coalesced and K2 with
    ``?nocoalesce=true``, a keyed filtered ``TopN`` K4 and a keyed
    ``GroupBy`` K5 once per shard, each answer equal to the same query on
    a CPU server (the kernels' plain versions) and to a numpy oracle."""
    import json
    import urllib.request

    from pilosa_tpu_torch import proto
    from pilosa_tpu_torch.server.server import Server

    rng = np.random.default_rng(35)
    n_shards = 3
    keys = [f"k{i}" for i in range(6)]
    fc = rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 16,
                    replace=False)
    kc = rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 4,
                    replace=False)
    kr = rng.integers(0, len(keys), size=len(kc))
    sets = {("f", 1): set(fc.tolist())}
    for r, c in zip(kr, kc):
        sets.setdefault(("kf", keys[r]), set()).add(int(c))

    def post(uri, path, body, ctype="application/json", accept=None):
        r = urllib.request.Request(uri + path, data=body, method="POST")
        r.add_header("Content-Type", ctype)
        if accept:
            r.add_header("Accept", accept)
        with urllib.request.urlopen(r, timeout=120) as resp:
            return resp.read()

    def load(srv):
        post(srv.uri, "/index/i", b"{}")
        post(srv.uri, "/index/i/field/f", b"{}")
        post(srv.uri, "/index/i/field/kf", b'{"options": {"keys": true}}')
        post(srv.uri, "/index/i/field/f/import", proto.encode(
            proto.IMPORT_REQUEST, {"rowIDs": [1] * len(fc),
                                   "columnIDs": fc.tolist()}),
            "application/x-protobuf")
        post(srv.uri, "/index/i/field/kf/import", proto.encode(
            proto.IMPORT_REQUEST, {"rowKeys": [keys[r] for r in kr],
                                   "columnIDs": kc.tolist()}),
            "application/x-protobuf")
        for f in srv.holder.index("i").fields.values():
            f.flush_deltas()

    def pq(srv, pql, flags=""):
        out = post(srv.uri, "/index/i/query" + flags,
                   proto.encode(proto.QUERY_REQUEST, {"query": pql}),
                   "application/x-protobuf", "application/x-protobuf")
        d = proto.decode(proto.QUERY_RESPONSE, out)
        assert d["err"] == ""
        return json.dumps([_plain_result(proto.proto_to_result(r))
                           for r in d["results"]])

    cases = (
        ('Count(Intersect(Row(kf="k3"), Row(f=1)))', "?nocache=1",
         {"vm_counts": 1}),
        ('Count(Intersect(Row(kf="k3"), Row(f=1)))',
         "?nocache=1&nocoalesce=true", {"gathered_count_and": 1}),
        ("TopN(kf, Row(f=1), n=5)", "?nocache=1",
         {"row_counts_masked": 1}),
        ("GroupBy(Rows(kf), Rows(f))", "?nocache=1",
         {"masked_matrix_counts": n_shards}),
    )
    plain = {}
    cpu = Server(str(tmp_path / "cpu"), device="cpu")
    cpu.open()
    try:
        load(cpu)
        for pql, flags, _ in cases:
            plain[pql, flags] = pq(cpu, pql, flags)
    finally:
        cpu.close()
    srv = Server(str(tmp_path / "cuda"), device=cuda_device,
                 coalescer_enabled=True)
    srv.open()
    try:
        load(srv)
        for pql, flags, launched in cases:
            k0 = ck.launch_counts()
            got = pq(srv, pql, flags)
            k1 = ck.launch_counts()
            assert {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]} == \
                launched, pql
            assert got == plain[pql, flags], pql
        want = len(sets["kf", "k3"] & sets["f", 1])
        assert json.loads(pq(srv, cases[0][0]))[0] == want
        # ids follow the keys' first appearance in the import
        first = {keys[r]: i for i, r in reversed(list(enumerate(kr)))}
        top = json.loads(pq(srv, "TopN(kf, Row(f=1), n=5)"))[0]
        assert top == [
            [k, len(sets["kf", k] & sets["f", 1])] for k in sorted(
                keys, key=lambda k: (-len(sets["kf", k] & sets["f", 1]),
                                     first[k]))][:5]
    finally:
        srv.close()


def _plain_result(r):
    """A decoded result as JSON-able values: a Row's columns and keys, a
    TopN's (key or id, count) pairs, a GroupBy's groups."""
    from pilosa_tpu_torch.models.row import Row

    if isinstance(r, Row):
        return [r.columns().tolist(), list(r.keys)]
    if isinstance(r, list):
        return [_plain_result(x) for x in r]
    if hasattr(r, "group"):
        return [[(fr.field, fr.row_id, fr.row_key) for fr in r.group],
                r.count]
    if hasattr(r, "count") and hasattr(r, "key"):
        return [r.key or r.id, r.count]
    return r


@pytest.mark.cuda
def test_expired_requests_and_coalescer_entries_launch_no_kernel(
        cuda_device, bitmap_containers, monkeypatch):
    """An expired request launches neither K2 (the direct route) nor K3
    (under the coalescer); an entry that expires in the coalescer's
    window leaves the batch before the launch, and its live batchmates
    share one K3 launch, held against its plain version."""
    import threading
    import types

    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.serve.deadline import (Deadline,
                                                 DeadlineExceededError)

    rng = np.random.default_rng(41)
    n_shards = 3
    h = Holder(None, device=cuda_device)
    idx = h.create_index("i")
    f = idx.create_field("f")
    cols = {r: rng.choice(n_shards * SHARD_WIDTH, size=SHARD_WIDTH // 20,
                          replace=False) for r in (1, 2, 3)}
    for r, c in cols.items():
        f.import_bits(np.full(len(c), r), c)
    f.flush_deltas()
    sets = {r: set(c.tolist()) for r, c in cols.items()}
    qs = {"Count(Intersect(Row(f=1), Row(f=2)))": sets[1] & sets[2],
          "Count(Union(Row(f=1), Row(f=3)))": sets[1] | sets[3],
          "Count(Xor(Row(f=3), Row(f=2)))": sets[3] ^ sets[2]}
    ex = Executor(h, device=cuda_device)
    q0 = next(iter(qs))
    assert ex.execute("i", q0) == [len(qs[q0])]  # K2 built and warm
    k0 = ck.launch_counts()
    for co in (None, Coalescer(window_s=0.2, max_batch=8,
                               device=cuda_device)):
        ex.coalescer = co
        with pytest.raises(DeadlineExceededError):
            ex.execute("i", q0, opt=ExecOptions(deadline=Deadline(-1.0)))
    assert ck.launch_counts() == k0

    real = ck.vm_counts

    def held(*args):
        got = real(*args)
        assert torch.equal(got, ck.vm_counts_plain(*args))
        return got

    monkeypatch.setattr(tape, "cuda_kernels", types.SimpleNamespace(
        vm_counts=held, vm_counts_kinds=ck.vm_counts_kinds))
    shards = tuple(range(n_shards))
    members = [(q, None, 0.0) for q in qs] + [
        (q, Deadline(-1.0), 0.1) for q in list(qs)[:2]]
    # max_batch seals the one bucket when the last member arrives
    co = Coalescer(window_s=5.0, max_batch=len(members),
                   device=cuda_device)
    got, errs = {}, {}

    def run(i, q, dl, delay):
        import time

        time.sleep(delay)
        child = parse(q).calls[0].children[0]
        try:
            got[i] = co.count(ex, idx, child, shards, deadline=dl)
        except DeadlineExceededError as e:
            errs[i] = e

    tape.reset_counters()
    k0 = ck.launch_counts()
    ts = [threading.Thread(target=run, args=(i, *m))
          for i, m in enumerate(members)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    h.close()
    assert got == {i: len(s) for i, s in enumerate(qs.values())}
    assert sorted(errs) == [3, 4]
    k1 = ck.launch_counts()
    assert k1["gathered_count_and"] == k0["gathered_count_and"]
    assert k1["vm_counts"] - k0["vm_counts"] == \
        tape.counters()["vm.executions"] == 1
    assert tape.counters()["vm.queries"] == len(qs)
