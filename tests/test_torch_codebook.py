"""cv_tpu_torch's codebook: the package's own copy of the trained table,
codebook training against cv_tpu, and the retrieval-recall checks of
tests/test_lsh_recall.py on the port's extractor and sketches.

* ``cv_tpu_torch/matching/codebook.npy`` is byte-equal to cv_tpu's and is
  the file ``lsh.codewords()`` loads (``lsh.CODEBOOK_PATH`` lies under
  ``cv_tpu_torch/``).
* ``train_codebook`` gives cv_tpu's table bitwise on the same descriptors
  and seed (the draws are NumPy in both, the distances integers), on
  clustered seeded descriptors at sizes where clusters empty and are
  reseeded; ``pack``/``unpack`` equal cv_tpu's; ``main`` writes the port's
  file only.
* Recall (the port's exact extractor at 1,024 features on the CPU, its
  sketches with the trained codebook): rendered scenes revisited 4 frames
  later with noise (recall@1 >= 0.7 and at least the random codebook's,
  reranked >= 0.95, same-scene sketch distance below cross-scene) and 12
  real KITTI crops revisited 5,3 px over with a gain change (reranked >=
  0.9): cv_tpu's floors.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from cv_tpu.matching import codebook as jcodebook
from cv_tpu_torch.akaze import Akaze, AkazeExtractor, load_gray, to_gray_f32
from cv_tpu_torch.apps.synth import render_sequence
from cv_tpu_torch.matching import codebook, lsh
from cv_tpu_torch.utils import kitti_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensor work on one thread: parallel test workers share
    the machine's cores, and torch's threads would spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT_DIR = os.path.dirname(os.path.abspath(codebook.__file__))


def test_codebook_file_is_a_byte_copy_of_cv_tpu_s():
    assert os.path.dirname(os.path.abspath(lsh.CODEBOOK_PATH)) == PORT_DIR
    assert codebook.CODEBOOK_PATH == lsh.CODEBOOK_PATH
    assert filecmp.cmp(lsh.CODEBOOK_PATH, jcodebook.CODEBOOK_PATH, shallow=False)
    assert not np.array_equal(lsh.codewords(), lsh.random_codewords())


def _clustered_words(seed, n=3000, centers=40, flip=0.15):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (centers, 486)).astype(np.uint8)
    bits = c[rng.integers(0, centers, n)] ^ (rng.uniform(size=(n, 486)) < flip).astype(np.uint8)
    return jcodebook.pack(bits)


def test_pack_and_unpack_match_cv_tpu():
    words = _clustered_words(0, n=50)
    words[:, -1] |= np.uint32(0xFFFF0000)  # padding bits: dropped by unpack
    np.testing.assert_array_equal(codebook.unpack(words), jcodebook.unpack(words))
    bits = jcodebook.unpack(words)
    np.testing.assert_array_equal(codebook.pack(bits), jcodebook.pack(bits))


@pytest.mark.parametrize("n_codewords,iters,n,seed", [(64, 25, 2000, 3), (128, 10, 2000, 7), (512, 2, 1200, 0)])
def test_train_codebook_bitwise_equal_to_cv_tpu(n_codewords, iters, n, seed):
    desc = _clustered_words(seed + 1, n=n)
    got = codebook.train_codebook(desc, n_codewords, iters, seed=seed, device="cpu")
    want = jcodebook.train_codebook(desc, n_codewords, iters, seed=seed)
    assert got.dtype == np.uint32 and got.shape == (n_codewords, 16)
    np.testing.assert_array_equal(got, want)


def test_train_codebook_needs_enough_distinct_descriptors():
    with pytest.raises(ValueError):
        codebook.train_codebook(np.zeros((600, 16), np.uint32), device="cpu")


def test_main_writes_the_port_s_file_only(tmp_path, monkeypatch):
    target = tmp_path / "codebook.npy"
    desc = _clustered_words(5, n=600)
    before = os.stat(jcodebook.CODEBOOK_PATH).st_mtime_ns
    monkeypatch.setattr(codebook, "CODEBOOK_PATH", str(target))
    monkeypatch.setattr(codebook, "training_descriptors", lambda device: desc)
    cb = codebook.main([], device="cpu")
    np.testing.assert_array_equal(np.load(target), cb)
    np.testing.assert_array_equal(cb, codebook.train_codebook(desc, device="cpu"))
    assert os.stat(jcodebook.CODEBOOK_PATH).st_mtime_ns == before


N_SCENES = 10
Q_FRAME = 4


@pytest.fixture(scope="module")
def extractor():
    return AkazeExtractor(Akaze(maximum_features=1024), device="cpu")


@pytest.fixture(scope="module")
def scene_words(extractor):
    """Per rendered scene (held-out seeds 200-209): the database frame's
    words and those of a noisy revisit 4 frames later."""
    rng = np.random.default_rng(7)
    out = []
    for seed in range(200, 200 + N_SCENES):
        images, _, _ = render_sequence(n_frames=Q_FRAME + 1, height=384, width=512, n_points=700, seed=seed)
        q = to_gray_f32(images[Q_FRAME])
        q = np.clip(q + rng.normal(0.0, 0.01, q.shape).astype(np.float32), 0, 1)
        out.append((extractor.extract(to_gray_f32(images[0]))[1], extractor.extract(q)[1]))
    return out


def _sketch(words, cw):
    return lsh.hash_bag(torch.as_tensor(np.ascontiguousarray(words).view(np.int32)),
                        torch.as_tensor(cw.view(np.int32)))


def _retrieve(scene_words, cw, pool_cap=None):
    """Hits of each revisit retrieving its own scene: by sketch distance
    alone, or from a shortlist of ``pool_cap`` reranked by descriptors."""
    db = torch.stack([_sketch(w, cw) for w, _ in scene_words])
    hits = 0
    for i, (_, wq) in enumerate(scene_words):
        d = lsh.sketch_distances(_sketch(wq, cw), db).numpy()
        if pool_cap is None:
            hits += int(d.argmin() == i)
        else:
            pool = np.argsort(d, kind="stable")[:pool_cap]
            scores = [lsh.descriptor_rerank_score(wq, scene_words[j][0]) for j in pool]
            hits += int(pool[int(np.argmin(scores))] == i)
    return hits / len(scene_words)


def test_near_duplicate_recall(scene_words):
    trained, random = _retrieve(scene_words, lsh.codewords()), _retrieve(scene_words, lsh.random_codewords())
    assert trained >= random, (trained, random)
    assert trained >= 0.7, trained


def test_reranked_recall(scene_words):
    assert _retrieve(scene_words, lsh.codewords(), pool_cap=8) >= 0.95


def test_sketch_separation(scene_words):
    cw = lsh.codewords()
    db = torch.stack([_sketch(w, cw) for w, _ in scene_words])
    same, cross = [], []
    for i, (_, wq) in enumerate(scene_words):
        d = lsh.sketch_distances(_sketch(wq, cw), db).numpy()
        same.append(d[i])
        cross.extend(np.delete(d, i))
    assert np.mean(same) < np.mean(cross), (np.mean(same), np.mean(cross))


def test_reranked_recall_real(extractor):
    """12 real places (6 crops of each KITTI frame), each revisited 5,3 px
    over with a 6% gain and noise, among all 12."""
    rng = np.random.default_rng(11)
    ch, cw_ = 320, 416
    out = []
    for path in kitti_pair():
        img = to_gray_f32(load_gray(path))
        h, w = img.shape
        for gx in range(6):
            x, y = int(gx * (w - cw_ - 8) / 5), (h - ch) // 2
            q = img[y + 3 : y + 3 + ch, x + 5 : x + 5 + cw_]
            q = np.clip(q * 1.06 + rng.normal(0.0, 0.01, q.shape).astype(np.float32), 0, 1).astype(np.float32)
            out.append((extractor.extract(np.ascontiguousarray(img[y : y + ch, x : x + cw_]))[1],
                        extractor.extract(np.ascontiguousarray(q))[1]))
    assert _retrieve(out, lsh.codewords(), pool_cap=6) >= 0.9
