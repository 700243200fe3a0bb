"""Kernels K2 (gathered_count_and), K4 (row_counts_masked) and K5
(masked_matrix_counts) of the port.

On the CPU each wrapper computes its plain PyTorch version:
``bitmap.gathered_pair_counts``, ``bitmap.row_counts_masked_plain`` and
``bitmap.masked_matrix_counts_plain``.  The plain versions are held
bit-exact against the JAX package's Pallas kernels in interpret mode and
its XLA twins (the pattern of tests/test_containers.py): K2 with zero
rows, indices past either end (clamped, as the XLA twin's
``mode="clip"``) and ``P=1``; K4 and K5 with words that have bit 31 set,
widths that are not a multiple of the Pallas blocks, and zero masks.
The CUDA kernels themselves are compared with the plain versions by the
``cuda``-marked tests of tests/test_torch_cuda.py, which need a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitmap as jbm
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitmap as tbm
from pilosa_tpu_torch.ops import cuda_kernels as ck

CW = ck.CONTAINER_WORDS


def _pools(seed: int, na: int, nb: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, size=(na, CW), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(nb, CW), dtype=np.uint32)
    a[-1] = 0  # the canonical absent-container row
    b[-1] = 0
    b[0] = 0xFFFFFFFF
    return a, b


def _plain(a, ai, b, bi) -> np.ndarray:
    return tbm.gathered_pair_counts(
        tbm.to_tensor(a), torch.from_numpy(ai), tbm.to_tensor(b),
        torch.from_numpy(bi)).numpy()


@pytest.mark.parametrize("seed,na,nb,p", [(11, 8, 4, 8), (3, 5, 9, 1),
                                          (7, 16, 16, 37)])
def test_plain_matches_pallas_interpret_and_xla_twin(seed, na, nb, p):
    a, b = _pools(seed, na, nb)
    rng = np.random.default_rng(seed + 1)
    ai = rng.integers(0, na, size=p, dtype=np.int32)
    bi = rng.integers(0, nb, size=p, dtype=np.int32)
    ai[0] = na - 1  # a zero row
    want = np.array([int(np.bitwise_count(a[x] & b[y]).sum())
                     for x, y in zip(ai, bi)])
    pallas = np.asarray(pk.gathered_count_and(a, ai, b, bi, interpret=True))
    twin = np.asarray(jbm.gathered_pair_counts(
        jnp.asarray(a), jnp.asarray(ai), jnp.asarray(b), jnp.asarray(bi)))
    got = _plain(a, ai, b, bi)
    assert got.dtype == np.int32
    assert np.array_equal(pallas, want)
    assert np.array_equal(twin, want)
    assert np.array_equal(got, want)


def test_indices_past_either_end_clamp_like_the_xla_twin():
    a, b = _pools(5, 6, 3)
    ai = np.array([-1, 6, 100, 0, -2 ** 31, 2 ** 31 - 1], dtype=np.int32)
    bi = np.array([3, -7, 1, 2 ** 31 - 1, 0, -1], dtype=np.int32)
    twin = np.asarray(jbm.gathered_pair_counts(
        jnp.asarray(a), jnp.asarray(ai), jnp.asarray(b), jnp.asarray(bi)))
    assert np.array_equal(_plain(a, ai, b, bi), twin)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    a, b = _pools(9, 4, 4)
    ai = np.array([0, 1, 2, 3], dtype=np.int32)
    bi = np.array([3, 2, 1, 0], dtype=np.int32)
    before = ck.gathered_count_and.launches
    with tbm.dispatch_counter() as dc:
        got = ck.gathered_count_and(tbm.to_tensor(a), torch.from_numpy(ai),
                                    tbm.to_tensor(b), torch.from_numpy(bi))
    assert np.array_equal(got.numpy(), _plain(a, ai, b, bi))
    assert ck.gathered_count_and.launches == before
    assert dc.launches == ["gathered_pair_counts"]


@pytest.mark.parametrize("bad", ["dtype", "width", "index_dtype",
                                 "lengths", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((4, CW), dtype=torch.int32)
    b = torch.zeros((4, CW), dtype=torch.int32)
    ai = torch.zeros(3, dtype=torch.int32)
    bi = torch.zeros(3, dtype=torch.int32)
    if bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "width":
        b = torch.zeros((4, CW // 2), dtype=torch.int32)
    elif bad == "index_dtype":
        ai = ai.to(torch.int64)
    elif bad == "lengths":
        bi = torch.zeros(2, dtype=torch.int32)
    else:
        a = torch.zeros((CW, 4), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        ck.gathered_count_and(a, ai, b, bi)


# ------------------------------------------------------------------ K4, K5


def _words(rng, shape) -> np.ndarray:
    """Random uint32 words with every 7th word's bit 31 set, so a count
    that tests ``> 0`` on the int32 view or sign-extends would differ."""
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[::7] |= np.uint32(1 << 31)
    return w


@pytest.mark.parametrize("rows", [1, 5, 130])
@pytest.mark.parametrize("words", [64, 2048, 2100])
def test_k4_plain_matches_pallas_interpret(rows, words):
    rng = np.random.default_rng(rows * 10007 + words)
    mat = _words(rng, (rows, words))
    mat[0, :] = 0xFFFFFFFF  # a full row: bit 31 in every word
    filt = _words(rng, (words,))
    want = np.bitwise_count(mat & filt[None, :]).sum(axis=1)
    pallas = np.asarray(pk._row_counts_masked_pallas(
        jnp.asarray(mat), jnp.asarray(filt), interpret=True))
    with tbm.dispatch_counter() as dc:
        got = tbm.row_counts_masked(tbm.to_tensor(mat), tbm.to_tensor(filt))
    assert dc.launches == ["row_counts_masked"]
    assert got.dtype == torch.int32
    assert np.array_equal(pallas, want)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,n_filt,words", [(1, 1, 64), (130, 4, 2100),
                                               (37, 9, 2048)])
def test_k4_gathered_form_matches_the_xla_twin(rows, n_filt, words):
    rng = np.random.default_rng(rows + n_filt)
    mat = _words(rng, (rows, words))
    stack = _words(rng, (n_filt, words))
    stack[n_filt - 1] = 0  # a shard whose filter is empty
    pos = rng.integers(0, n_filt, size=rows).astype(np.int32)
    pos[0] = n_filt - 1
    twin = np.asarray(jbm.row_counts_gathered(
        jnp.asarray(mat), jnp.asarray(stack), jnp.asarray(pos)))
    with tbm.dispatch_counter() as dc:
        got = tbm.row_counts_gathered(tbm.to_tensor(mat), tbm.to_tensor(stack),
                                      torch.from_numpy(pos))
    assert dc.launches == ["row_counts_gathered"]
    assert np.array_equal(got.numpy(), twin)
    assert got[0] == 0


@pytest.mark.parametrize("groups", [1, 3, 9])
@pytest.mark.parametrize("rows", [1, 130])
@pytest.mark.parametrize("words", [256, 300])
def test_k5_plain_matches_pallas_interpret(groups, rows, words):
    rng = np.random.default_rng(groups * 1009 + rows * 31 + words)
    mat = _words(rng, (rows, words))
    masks = _words(rng, (groups, words))
    masks[groups - 1] = 0  # a zero mask: a group with no columns left
    want = np.array([[int(np.bitwise_count(mat[r] & masks[g]).sum())
                      for r in range(rows)] for g in range(groups)])
    pallas = np.asarray(pk._mmc_pallas(jnp.asarray(mat), jnp.asarray(masks),
                                       interpret=True))
    with tbm.dispatch_counter() as dc:
        got = tbm.masked_matrix_counts(tbm.to_tensor(mat),
                                       tbm.to_tensor(masks))
    assert dc.launches == ["masked_matrix_counts"]
    assert got.shape == (groups, rows) and got.dtype == torch.int32
    assert np.array_equal(pallas, want)
    assert np.array_equal(got.numpy(), want)
    assert not got[groups - 1].any()


def test_and_pairs_matches_the_xla_twin():
    rng = np.random.default_rng(17)
    mat = _words(rng, (6, 300))
    masks = _words(rng, (4, 300))
    slots = np.array([5, 0, 3, 3, 0, 0, 0, 0], dtype=np.int32)
    gsel = np.array([1, 3, 0, 2, 0, 0, 0, 0], dtype=np.int32)
    twin = np.asarray(jbm.and_pairs(jnp.asarray(mat), jnp.asarray(masks),
                                    jnp.asarray(slots), jnp.asarray(gsel)))
    got = tbm.and_pairs(tbm.to_tensor(mat), tbm.to_tensor(masks), slots, gsel)
    assert np.array_equal(tbm.to_numpy(got), twin)


def test_k4_and_k5_wrappers_on_cpu_launch_nothing():
    rng = np.random.default_rng(2)
    mat = tbm.to_tensor(_words(rng, (5, 64)))
    masks = tbm.to_tensor(_words(rng, (3, 64)))
    before = ck.launch_counts()
    ck.row_counts_masked(mat, masks, torch.tensor([0, 1, 2, 1, 0],
                                                  dtype=torch.int32))
    ck.masked_matrix_counts(mat, masks)
    assert ck.launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "width", "noncontig", "idx_dtype",
                                 "idx_len", "idx_range", "no_words",
                                 "no_filters"])
def test_k4_wrapper_rejects_what_the_kernel_does_not_take(bad):
    mat = torch.zeros((4, 64), dtype=torch.int32)
    filt = torch.zeros((2, 64), dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    if bad == "dtype":
        mat = mat.to(torch.int64)
    elif bad == "width":
        filt = torch.zeros((2, 32), dtype=torch.int32)
    elif bad == "noncontig":
        mat = torch.zeros((64, 4), dtype=torch.int32).t()
    elif bad == "idx_dtype":
        idx = idx.to(torch.int64)
    elif bad == "idx_len":
        idx = torch.zeros(3, dtype=torch.int32)
    elif bad == "idx_range":
        idx = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    elif bad == "no_words":
        mat, filt = mat[:, :0], filt[:, :0]
    else:
        filt = filt[:0]
    with pytest.raises((TypeError, ValueError, IndexError)):
        ck.row_counts_masked(mat, filt, idx)


@pytest.mark.parametrize("bad", ["dtype", "width", "noncontig", "no_masks"])
def test_k5_wrapper_rejects_what_the_kernel_does_not_take(bad):
    mat = torch.zeros((4, 64), dtype=torch.int32)
    masks = torch.zeros((2, 64), dtype=torch.int32)
    if bad == "dtype":
        masks = masks.to(torch.int64)
    elif bad == "width":
        masks = torch.zeros((2, 65), dtype=torch.int32)
    elif bad == "noncontig":
        masks = torch.zeros((64, 2), dtype=torch.int32).t()
    else:
        masks = masks[:0]
    with pytest.raises((TypeError, ValueError)):
        ck.masked_matrix_counts(mat, masks)
