"""Graph bundle adjustment against cv_tpu's jitted loop, bit for bit.

``cv_tpu_torch.sfm.device_refine.graph_ba_core_plain`` writes every product,
sum and so(3) map of a round as XLA's CPU code evaluates
``cv_tpu.sfm.device_refine.graph_ba_core`` under the jit of
``engine.graph_ba_device``.  One step of that code is the processor's:
XLA writes ``sin / sqrt(t2s)`` as ``sin * rsqrt(t2s)`` and on a CPU with
AVX-512 lowers the float64 ``rsqrt`` to the ``vrsqrt14pd`` estimate and two
Newton steps (without AVX-512, to ``1 / sqrt``, the port's form).  So the
references here are computed by cv_tpu in a subprocess with
``XLA_FLAGS=--xla_cpu_max_isa=AVX2``, where they are the same on every
x86-64 CPU; ``tests/test_torch_sfm_geom.py`` holds the port to the default
build's within 1e-10.  Float32's ``rsqrt`` is x86's ``vrsqrtps`` estimate
with Newton steps at either setting, so the bitwise float32 cases keep
every view's delta inside ``so3_exp``'s Taylor branch (``theta^2 <= eps``,
no ``rsqrt``), and one float32 case outside it is held within a stated
tolerance.

The problems (seeded, NumPy) cover invalid edges and an edgeless view
(removed from the start), an edge whose log goes non-finite (its view
removed and kept removed), views with a single incoming edge and a hub
with the largest in-degree, half-turn residuals (so3_log's near-pi
branch) and a bucket-padded engine shape.  The
``cuda`` test holds ``csrc/graph_ba.cu`` bitwise to the plain loop on a
card (``scripts/host_graph_ba.py`` holds it on the host where there is no
``nvcc``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cv_tpu_torch.core import lie
from cv_tpu_torch.sfm import device_refine
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, seed, V, E, dtype, rate, rounds, special)
CASES = [
    ("invalid-edges-edgeless-view", 0, 6, 24, "float64", 0.01, 64, ""),
    ("engine-rate", 1, 12, 90, "float64", 0.001, 64, ""),
    ("single-incoming-edges", 2, 5, 7, "float64", 0.05, 32, ""),
    ("non-finite-edge", 3, 8, 40, "float64", 0.01, 48, "inf"),
    ("hub-in-degree", 4, 16, 200, "float64", 0.001, 24, "hub"),
    ("engine-buckets", 5, 8, 64, "float64", 0.001, 32, "pad"),
    ("near-pi-edges", 9, 8, 48, "float64", 0.01, 24, "near_pi"),
    ("float32-taylor", 6, 8, 40, "float32", 0.001, 48, ""),
    ("float32-taylor-non-finite", 7, 6, 30, "float32", 0.0005, 32, "inf"),
]
FLOAT32_GENERIC = ("float32-generic", 8, 6, 24, "float32", 0.05, 32, "")
FLOAT32_GENERIC_ATOL = 1e-5  # measured worst 1.8e-07 (vrsqrtps against 1 / sqrt)


def _rotations(rng, n, scale):
    return lie.so3_exp(torch.as_tensor(rng.normal(size=(n, 3)) * scale)).numpy()


def problem(seed, v, e, dtype, special=""):
    """Views near a random trajectory, directed edges between them (the last
    view gets none), expected relative poses from the truth with noise,
    15% of the edges invalid.  ``special``: ``inf`` puts an infinite
    translation on a valid edge; ``hub`` sends a third of the edges to view
    0; ``near_pi`` makes every fourth edge's first-round residual a half
    turn to rounding (so3_log's diagonal branch); ``pad`` lays the arrays out as the engine's buckets (the last views
    identity and edgeless, the tail edges invalid identity)."""
    rng = np.random.default_rng(seed)
    rot = _rotations(rng, v, 0.5)
    trans = rng.normal(size=(v, 3))
    live = v - 1 if special != "pad" else max(v - 3, 3)
    to = rng.integers(0, live, e)
    if special == "hub":
        to[: e // 3] = 0
    frm = (to + rng.integers(1, live, e)) % live
    r_rel = rot[to] @ np.swapaxes(rot[frm], -1, -2)
    edge_rot = _rotations(rng, e, 0.01) @ r_rel
    edge_t = trans[to] - np.einsum("eij,ej->ei", r_rel, trans[frm]) + rng.normal(size=(e, 3)) * 0.01
    valid = rng.uniform(size=e) < 0.85
    noisy_rot = _rotations(rng, v, 0.02) @ rot
    noisy_t = trans + rng.normal(size=trans.shape) * 0.02
    if special == "near_pi":
        axis = rng.normal(size=(e, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        flip = 2 * axis[:, :, None] * axis[:, None, :] - np.eye(3)
        now = noisy_rot[to] @ np.swapaxes(noisy_rot[frm], -1, -2)
        edge_rot[::4] = flip[::4] @ now[::4]
    if special == "inf":
        k = int(np.flatnonzero(valid)[1])
        edge_t[k, 1] = np.inf
    if special == "pad":
        noisy_rot[live:], noisy_t[live:] = np.eye(3), 0.0
        tail = e - e // 4
        valid[tail:], edge_rot[tail:], edge_t[tail:], to[tail:], frm[tail:] = False, np.eye(3), 0.0, 0, 0
    arrays = (noisy_rot, noisy_t, to.astype(np.int64), frm.astype(np.int64), edge_rot, edge_t, valid)
    return tuple(a.astype(dtype) if a.dtype == np.float64 else a for a in arrays)


def landmarks(seed, v, count=96, obs=4):
    """Observation rows for ``ba_filter`` (2-4 observations, some
    outliers, the last 8 rows invalid)."""
    rng = np.random.default_rng(seed)
    lm_view = np.zeros((count, obs), np.int64)
    lm_bear = np.zeros((count, obs, 3))
    lm_bear[..., 2] = 1.0
    lm_mask = np.zeros((count, obs), bool)
    for i in range(count):
        k = int(rng.integers(2, obs + 1))
        lm_view[i, :k] = rng.choice(v - 1, size=k, replace=False)
        b = rng.normal(size=(k, 3)) * 0.1 + [0, 0, 1]
        lm_bear[i, :k] = b / np.linalg.norm(b, axis=-1, keepdims=True)
        lm_mask[i, :k] = True
    lm_valid = np.ones(count, bool)
    lm_valid[-8:] = False
    return lm_view, lm_bear, lm_mask, lm_valid


# cv_tpu's graph BA (engine.graph_ba_device, the jit the engine runs) and
# its fused BA + filter on each saved problem; run as a script.
_REFERENCE = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from cv_tpu.sfm import device_refine, engine

data = dict(np.load(sys.argv[1]))
out = {}
for name in sorted({k.split("/")[0] for k in data}):
    arrays = [jnp.asarray(data[f"{name}/a{i}"]) for i in range(7)]
    rounds, rate = int(data[f"{name}/rounds"]), float(data[f"{name}/rate"])
    if f"{name}/lm0" in data:
        lms = [jnp.asarray(data[f"{name}/lm{i}"]) for i in range(4)]
        res = device_refine.ba_filter(*arrays, *lms, 0.1, 1e-5, 1e-3, jnp.int32(3), iterations=rounds, rate=rate)
    else:
        res = engine.graph_ba_device(*arrays, iterations=rounds, rate=rate)
    for i, r in enumerate(res):
        out[f"{name}/r{i}"] = np.asarray(r)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Every case's cv_tpu result, computed in one subprocess under
    ``--xla_cpu_max_isa=AVX2``."""
    tmp = tmp_path_factory.mktemp("graph_ba")
    saved = {}
    for name, seed, v, e, dtype, rate, rounds, special in CASES + [FLOAT32_GENERIC]:
        for i, a in enumerate(problem(seed, v, e, dtype, special)):
            saved[f"{name}/a{i}"] = a
        saved[f"{name}/rounds"], saved[f"{name}/rate"] = np.int64(rounds), np.float64(rate)
    for i, a in enumerate(problem(9, 8, 40, "float64")):
        saved[f"ba_filter/a{i}"] = a
    for i, a in enumerate(landmarks(9, 8)):
        saved[f"ba_filter/lm{i}"] = a
    saved["ba_filter/rounds"], saved["ba_filter/rate"] = np.int64(32), np.float64(0.01)
    np.savez(tmp / "in.npz", **saved)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX2", JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz")], env=env, check=True,
                   cwd=ROOT)
    return saved, dict(np.load(tmp / "out.npz"))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("name,seed,v,e,dtype,rate,rounds,special", CASES, ids=[c[0] for c in CASES])
def test_graph_ba_core_plain_bitwise_to_cv_tpu(references, name, seed, v, e, dtype, rate, rounds, special):
    saved, ref = references
    arrays = [torch.as_tensor(saved[f"{name}/a{i}"]) for i in range(7)]
    rot, trans, removed = device_refine.graph_ba_core_plain(*arrays, iterations=rounds, rate=rate)
    np.testing.assert_array_equal(removed.numpy(), ref[f"{name}/r2"])
    np.testing.assert_array_equal(_bits(rot.numpy()), _bits(ref[f"{name}/r0"]))
    np.testing.assert_array_equal(_bits(trans.numpy()), _bits(ref[f"{name}/r1"]))
    assert removed[-1] and not removed.all()  # the edgeless view, and views that stay
    if special == "inf":  # the infinite edge's view, removed in the first round and kept so
        k = int(np.flatnonzero(saved[f"{name}/a6"])[1])
        view = int(saved[f"{name}/a2"][k])
        assert removed[view]
        np.testing.assert_array_equal(rot[view].numpy(), saved[f"{name}/a0"][view])
    counts = np.bincount(saved[f"{name}/a2"][saved[f"{name}/a6"]], minlength=v)
    assert counts.max() >= (e // 3 if special == "hub" else 2)


def test_graph_ba_core_plain_float32_outside_the_taylor_branch(references):
    """Float32 where ``so3_exp`` takes ``sin * rsqrt``: x86's estimate in
    the reference, ``1 / sqrt`` here; within 1e-5 (measured worst 1.8e-07,
    63% of the rotation entries bitwise), removed mask exact."""
    saved, ref = references
    name, _, _, _, _, rate, rounds, _ = FLOAT32_GENERIC
    arrays = [torch.as_tensor(saved[f"{name}/a{i}"]) for i in range(7)]
    rot, trans, removed = device_refine.graph_ba_core_plain(*arrays, iterations=rounds, rate=rate)
    np.testing.assert_array_equal(removed.numpy(), ref[f"{name}/r2"])
    np.testing.assert_allclose(rot.numpy(), ref[f"{name}/r0"], atol=FLOAT32_GENERIC_ATOL, rtol=0)
    np.testing.assert_allclose(trans.numpy(), ref[f"{name}/r1"], atol=FLOAT32_GENERIC_ATOL, rtol=0)


def test_ba_filter_poses_bitwise_to_cv_tpu(references):
    """``ba_filter`` (graph BA, then the observation filter): the poses
    bitwise, the removed mask, kill, bad_obs and the robust count equal."""
    saved, ref = references
    arrays = [torch.as_tensor(saved[f"ba_filter/a{i}"]) for i in range(7)]
    lms = [torch.as_tensor(saved[f"ba_filter/lm{i}"]) for i in range(4)]
    got = device_refine.ba_filter(*arrays, *lms, 0.1, 1e-5, 1e-3, 3, iterations=32, rate=0.01)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(ref["ba_filter/r0"]))
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(ref["ba_filter/r1"]))
    for i in range(2, 6):
        np.testing.assert_array_equal(np.asarray(got[i].numpy()), ref[f"ba_filter/r{i}"])


def test_graph_ba_core_takes_the_plain_loop_on_a_cpu():
    """On CPU tensors ``graph_ba_core`` is the plain loop and launches no
    kernel; the kernel's wrapper refuses CPU tensors."""
    arrays = [torch.as_tensor(a) for a in problem(0, 6, 24, "float64")]
    before = device_refine.graph_ba_core.launches
    got = device_refine.graph_ba_core(*arrays, iterations=4, rate=0.01)
    want = device_refine.graph_ba_core_plain(*arrays, iterations=4, rate=0.01)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert device_refine.graph_ba_core.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        device_refine.graph_ba_kernel(*arrays, iterations=4, rate=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed,v,e,dtype,rate,rounds,special", CASES, ids=[c[0] for c in CASES])
def test_cuda_graph_ba_bitwise_to_plain(name, seed, v, e, dtype, rate, rounds, special):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/graph_ba.cu runs only there")
    arrays = [torch.as_tensor(a) for a in problem(seed, v, e, dtype, special)]
    want = device_refine.graph_ba_core_plain(*arrays, iterations=rounds, rate=rate)
    before = device_refine.graph_ba_core.launches
    got = device_refine.graph_ba_core(*(a.cuda() for a in arrays), iterations=rounds, rate=rate)
    assert device_refine.graph_ba_core.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.cpu().numpy()) if g.is_floating_point() else g.cpu().numpy(),
                                      _bits(w.numpy()) if w.is_floating_point() else w.numpy())



@pytest.mark.cuda
@pytest.mark.parametrize("name,seed,v,e,dtype,rate,rounds,special", CASES, ids=[c[0] for c in CASES])
def test_cuda_graph_ba_plain_bitwise_to_the_cpu(name, seed, v, e, dtype, rate, rounds, special):
    """The plain loop on CUDA tensors (the fused products' card forms,
    cuBLAS nowhere) bitwise to its CPU run over every round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plain loop's card forms run only there")
    arrays = [torch.as_tensor(a) for a in problem(seed, v, e, dtype, special)]
    want = device_refine.graph_ba_core_plain(*arrays, iterations=rounds, rate=rate)
    got = device_refine.graph_ba_core_plain(*(a.cuda() for a in arrays), iterations=rounds, rate=rate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.cpu().numpy()) if g.is_floating_point() else g.cpu().numpy(),
                                      _bits(w.numpy()) if w.is_floating_point() else w.numpy())


@pytest.mark.cuda
def test_cuda_graph_ba_refuses_views_beyond_shared_memory():
    """More views than a block's shared memory holds: ValueError, no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/graph_ba.cu runs only there")
    arrays = [torch.as_tensor(a).cuda() for a in problem(0, 6, 24, "float64")]
    v = 1 << 14
    rot = torch.eye(3, dtype=torch.float64, device="cuda").expand(v, 3, 3)
    trans = torch.zeros(v, 3, dtype=torch.float64, device="cuda")
    before = device_refine.graph_ba_core.launches
    with pytest.raises(ValueError, match="shared memory"):
        device_refine.graph_ba_core(rot, trans, *arrays[2:], iterations=4, rate=0.01)
    assert device_refine.graph_ba_core.launches == before
