"""cv_tpu_torch's Hamming matching against cv_tpu's: integer arithmetic,
so distances, neighbours (ties included) and Lowes-ratio decisions must be
exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.matching import hamming as jham
from cv_tpu_torch.matching import hamming as tham
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.as_tensor(words.view(np.int32))


def test_popcount_all_bit_patterns():
    vals = np.array([0, 1, 2**31, 2**32 - 1, 0x55555555, 0xAAAAAAAA, 0x0F0F0F0F, 12345], np.uint32)
    got = tham.popcount32(_t(vals)).numpy()
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in vals])


@pytest.mark.parametrize("n,m", [(7, 9), (64, 50)])
def test_distance_matrix_exact(n, m):
    rng = np.random.default_rng(n)
    a, b = _words(rng, n), _words(rng, m)
    ref = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tham.distance_matrix(_t(a), _t(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_distance_matrix_batched():
    rng = np.random.default_rng(3)
    a = _words(rng, 3 * 10).reshape(3, 10, 16)
    b = _words(rng, 3 * 12).reshape(3, 12, 16)
    got = tham.distance_matrix(_t(a), _t(b)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jham.distance_matrix(jnp.asarray(a[i]), jnp.asarray(b[i])))
        )


def test_knn2_ties_go_to_lower_index():
    dist = np.array(
        [[5, 3, 3, 3, 9], [2, 2, 2, 2, 2], [7, 1, 8, 1, 0], [4, 4, 1, 9, 1]], np.int32
    )
    idx_j, d_j = jham.knn2(jnp.asarray(dist))
    idx_t, d_t = tham.knn2(torch.as_tensor(dist))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(idx_t.numpy(), [[1, 2], [0, 1], [4, 1], [2, 4]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowes_ratio_matches_exact(seed):
    rng = np.random.default_rng(seed)
    a = _words(rng, 40)
    # b holds noisy copies of some rows of a (true matches) plus duplicates
    # (forced distance ties) and random rows.
    b = _words(rng, 60)
    b[:20] = a[:20] ^ (rng.uniform(size=(20, 16)) < 0.02).astype(np.uint32)
    b[20:25] = b[:5]
    idx_j, keep_j = jham.lowes_ratio_matches(jnp.asarray(a), jnp.asarray(b), 0.5)
    idx_t, keep_t = tham.lowes_ratio_matches(_t(a), _t(b), 0.5)
    assert np.asarray(keep_j).sum() > 5
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("n,m", [(7, 9), (64, 50)])
def test_unpack_bits_and_distance_matrix_mxu(n, m):
    """The bit unpacking equals cv_tpu's; the product form equals the
    popcount form and cv_tpu's product form on descriptor words (486 bits:
    the last word's top 26 bits clear), an all-ones descriptor among them."""
    rng = np.random.default_rng(n + 100)
    a, b = _words(rng, n), _words(rng, m)
    a[0] = 2**32 - 1
    for w in (a, b):
        w[:, -1] &= np.uint32((1 << (486 - 15 * 32)) - 1)
    np.testing.assert_array_equal(tham.unpack_bits(_t(a)).numpy(), np.asarray(jham.unpack_bits(jnp.asarray(a))))
    got = tham.distance_matrix_mxu(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tham.distance_matrix(_t(a), _t(b)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jham.distance_matrix_mxu(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("seed", [0, 1])
def test_match_descriptors_exact(seed):
    rng = np.random.default_rng(seed + 30)
    a = _words(rng, 50)
    b = _words(rng, 70)
    b[:25] = a[:25] ^ (rng.uniform(size=(25, 16)) < 0.03).astype(np.uint32)
    ia, ib = tham.match_descriptors(a, b, device="cpu")
    ja, jb = jham.match_descriptors(a, b)
    assert len(ja) > 10
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_array_equal(ib, jb)
