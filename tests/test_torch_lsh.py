"""cv_tpu_torch's retrieval sketches and the engine's matchers against
cv_tpu on the same seeded descriptors: sketches bitwise, mutual-best
matching exact (with forced ties), and the engine's 3-NN exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.matching import hamming as jham
from cv_tpu.matching import lsh as jlsh
from cv_tpu.sfm.data import VSlamData as RefData
from cv_tpu_torch.matching import hamming, lsh
from cv_tpu_torch.sfm.data import VSlamData
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)


def _words(rng, n):
    w = rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)
    w[:, -1] &= np.uint32((1 << (486 - 15 * 32)) - 1)
    return w


def _t(words):
    return torch.tensor(words.view(np.int32))


def test_codebook_is_the_reference_file():
    np.testing.assert_array_equal(lsh.codewords(), jlsh.codewords())


@pytest.mark.parametrize("n", [1, 37, 1024])
def test_hash_bag_bitwise(n):
    words = _words(np.random.default_rng(n), n)
    got = lsh.hash_bag(_t(words)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jlsh.hash_bag(jnp.asarray(words))))


def test_sketch_from_distances_with_valid_mask():
    rng = np.random.default_rng(3)
    words = _words(rng, 300)
    valid = rng.uniform(size=300) < 0.6
    d = hamming.distance_matrix(_t(words), torch.tensor(lsh.codewords().view(np.int32)))
    got = lsh.sketch_from_distances(d, torch.tensor(valid)).numpy().view(np.uint32)
    ref = jlsh.sketch_from_distances(jnp.asarray(d.numpy()), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_sketch_distances_and_rerank():
    rng = np.random.default_rng(4)
    sk = _words(rng, 9)
    got = lsh.sketch_distances(_t(sk[0]), _t(sk)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlsh.sketch_distances(jnp.asarray(sk[0]), jnp.asarray(sk))))
    a, b = _words(rng, 80), _words(rng, 70)
    assert lsh.descriptor_rerank_score(a, b) == jlsh.descriptor_rerank_score(a, b)


def test_frame_retrieval_matches():
    """The data model's retrieval (sketch shortlist + descriptor rerank)
    picks the same frames in both packages."""
    from cv_tpu.sfm.data import Feed as RefFeed
    from cv_tpu_torch.sfm.data import Feed

    rng = np.random.default_rng(5)
    base = [_words(rng, 200) for _ in range(4)]
    frames = []
    for k in range(12):
        w = base[k % 4].copy()
        w[rng.integers(0, 200, 20)] ^= np.uint32(1 << 3)
        frames.append(w)
    out = []
    for data, feed_cls in ((VSlamData(), Feed), (RefData(), RefFeed)):
        feed = data.feeds.insert(feed_cls(intrinsics=None, frames=[]))
        for w in frames:
            data.add_frame_features(feed, w, np.zeros((200, 3)), np.zeros(200, np.float32), np.zeros((200, 3), np.uint8))
        out.append([data.find_visually_similar_and_recent_frames(f, 2, 2, 3, 16) for f in range(12)])
    assert out[0] == out[1]


def _tied(rng, n, m):
    """Descriptors with forced ties: duplicated rows on both sides."""
    a, b = _words(rng, n), _words(rng, m)
    b[5] = b[3]
    b[9] = a[2]
    b[10] = a[2]
    a[7] = a[6]
    b[20] = a[11] ^ np.uint32(1)
    b[21] = a[11] ^ np.uint32(2)
    # Near-duplicates so margins matter.
    for i in range(30, 60):
        b[i] = a[i] ^ np.uint32(1 << (i % 31))
    return a, b


@pytest.mark.parametrize("padded", [False, True])
def test_symmetric_matches_exact(padded):
    rng = np.random.default_rng(6)
    a, b = _tied(rng, 100, 90)
    kw = {}
    if padded:
        a = np.concatenate([a, np.zeros((28, 16), np.uint32)])
        b = np.concatenate([b, np.zeros((38, 16), np.uint32)])
        kw = dict(n_valid_a=100, n_valid_b=90)
    idx, keep = hamming.symmetric_matches(_t(a), _t(b), better_by=24, **kw)
    ridx, rkeep = jham.symmetric_matches(jnp.asarray(a), jnp.asarray(b), better_by=24, **kw)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(idx.numpy()[keep.numpy()], np.asarray(ridx)[np.asarray(rkeep)])
    assert 20 <= int(keep.sum()) < 100


def test_engine_knn3_exact():
    """The engine's 3-NN (engine.py:498-513, ``jax.lax.top_k`` of negated
    distances over a padded column count), ties to the lower index."""
    rng = np.random.default_rng(7)
    q, w = _tied(rng, 64, 128)
    w = np.concatenate([w, w[:16]])  # exact duplicate columns
    n_valid = 140
    d = hamming.distance_matrix(_t(q), _t(w))
    d = torch.where(torch.arange(w.shape[0])[None, :] < n_valid, d, hamming.PAD_DISTANCE)
    dist, idx = hamming.knn(d, 3)
    jd = jham.distance_matrix(jnp.asarray(q), jnp.asarray(w))
    jd = jnp.where(jnp.arange(w.shape[0])[None, :] < n_valid, jd, jham.PAD_DISTANCE)
    neg, jidx = jax.lax.top_k(-jd, 3)
    np.testing.assert_array_equal(dist.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
