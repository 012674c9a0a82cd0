"""The pose optimizers of cv_tpu_torch (the plain versions of the three
CUDA kernels, and the kernels on a card) against cv_tpu.

The problems are those of tests/test_pallas_loop.py, built with NumPy and
handed to both packages.  Gates:

* float32: each plain version against cv_tpu's resident Pallas kernel in
  interpret mode, within 1e-6 after one step (measured worst 6.0e-8) and
  1e-4 after a full run of 2,000 steps for the patience loops, 200 for the
  adaptive loop (measured worst 4.9e-5, the single-view loop), the gates of
  tests/test_pallas_loop.py;
* float64: each plain version against cv_tpu.optimize's XLA loop, within
  1e-12 after one step (measured worst 1.1e-16) and 1e-6 after a long run
  (the single-view loop stops by patience; measured worst 1.8e-14);
* the three-view loops on problems whose translations move (bearings
  from the camera centres negated, where every triangulation of the
  three-view gradient passes its cheirality test; in the problems above
  and on the SfM engine's calls every one fails): the same gates, the
  runs 300 steps for the patience loop and 10 for the adaptive loop
  (measured worst 5.0e-7 in float32, 1.1e-15 in float64);
* padding with invalid rows changes no bit; the pose type is kept;
* on a card (marker ``cuda``), each kernel against its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu import optimize as ref_opt
from cv_tpu.core.pose import CameraToCamera as RefC2C
from cv_tpu.core.pose import WorldToCamera as RefW2C
from cv_tpu.optimize import pallas_loop
from cv_tpu.sfm.se3 import so3_exp
from cv_tpu_torch.core.pose import CameraToCamera, WorldToCamera
from cv_tpu_torch.optimize import optimizers, resident
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

KINDS = ("single_view", "three_view", "adaptive")


def _single_view_problem(m=256, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (m, 3))
    wp = np.concatenate([pts, np.ones((m, 1))], axis=1)
    rot = so3_exp(np.array([0.05, -0.1, 0.04]))
    t = np.array([0.3, -0.1, 0.05])
    cam = pts @ rot.T + t
    bear = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    valid = np.ones(m, bool)
    valid[m // 2:] = False
    return dict(rot=so3_exp(np.array([0.08, -0.07, 0.06])), t=t + 0.05, bear=bear, wp=wp, valid=valid)


def _three_view_problem(n=96, seed=0, translating=0):
    """Every triangulation of the three-view gradient fails its cheirality
    test here, so only the rotations move; with ``translating`` > 0 the
    bearings of every ``translating``-th row come from the camera centres
    negated, and there all three pass and the translations move."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    negated = (np.arange(n) % translating == 0)[:, None] if translating else False
    obs = np.zeros((n, 3, 3))
    poses = []
    for i, tvec in enumerate(([0, 0, 0], [0.4, 0, 0.05], [0.8, 0.05, 0.1])):
        rot = so3_exp(np.array([0.02, -0.03, 0.01]) * i)
        cam = np.where(negated, pts + np.array(tvec, float), pts - np.array(tvec, float)) @ rot.T
        obs[:, i] = cam / np.linalg.norm(cam, axis=1, keepdims=True)
        poses.append((rot, -rot @ np.array(tvec, float)))
    return dict(
        r1=poses[1][0], t1=poses[1][1] + 0.03, r2=poses[2][0], t2=poses[2][1] - 0.02,
        obs=obs, valid=np.ones(n, bool),
    )


# The translating problems (kind + "_translating"): every row of the
# patience loop's, every fourth row of the adaptive loop's (whose rate moves
# a pose by about its translation each step, so that it diverges within
# tens of steps; its runs there are 10 steps).
TRANSLATING = {"three_view": 1, "adaptive": 4}
PARITY_KINDS = KINDS + ("three_view_translating", "adaptive_translating")


def _base(kind):
    return kind.removesuffix("_translating")


def _problem(kind):
    if kind == "single_view":
        return _single_view_problem()
    every = TRANSLATING[_base(kind)] if kind.endswith("_translating") else 0
    kind = _base(kind)
    if kind == "three_view":
        return _three_view_problem(translating=every)
    # Two distinct problems, the second with its last 30 rows invalid.
    a, b = _three_view_problem(seed=1, translating=every), _three_view_problem(seed=2, translating=every)
    b["valid"][-30:] = False
    return {key: np.stack([a[key], b[key]]) for key in a}


def _pad(kind, prob, extra):
    """The problem with ``extra`` invalid rows appended (values 0.5/1.0)."""
    out = dict(prob)
    rows = {"single_view": ("bear", "wp", "valid"), "three_view": ("obs", "valid"), "adaptive": ("obs", "valid")}
    axis = 1 if kind == "adaptive" else 0
    for key in rows[kind]:
        a = prob[key]
        shape = list(a.shape)
        shape[axis] = extra
        fill = False if key == "valid" else (1.0 if key == "wp" else 0.5)
        out[key] = np.concatenate([a, np.full(shape, fill, a.dtype)], axis=axis)
    return out


def _port(kind, prob, iters, dtype, device="cpu", plain=True):
    """Run the port (plain version or wrapper) and return all pose numbers."""

    def t(a):
        return torch.tensor(a, dtype=dtype if a.dtype != bool else torch.bool, device=device)

    if kind == "single_view":
        fn = optimizers.single_view_simple_optimize_l2 if plain else resident.single_view_l2
        pose = fn(
            WorldToCamera(rotation=t(prob["rot"]), translation=t(prob["t"])),
            t(prob["bear"]), t(prob["wp"]), t(prob["valid"]), 1e-2, iters,
        )
        assert isinstance(pose, WorldToCamera) and pose.dtype == dtype
        poses = [pose]
    else:
        p1 = CameraToCamera(rotation=t(prob["r1"]), translation=t(prob["t1"]))
        p2 = CameraToCamera(rotation=t(prob["r2"]), translation=t(prob["t2"]))
        if kind == "three_view":
            fn = optimizers.three_view_simple_optimize_l2 if plain else resident.three_view_l2
            poses = fn((p1, p2), t(prob["obs"]), t(prob["valid"]), 1e-2, iters)
        else:
            fn = optimizers.three_view_adaptive_optimize_l2 if plain else resident.three_view_adaptive
            poses = fn((p1, p2), t(prob["obs"]), t(prob["valid"]), iters)
        assert all(isinstance(p, CameraToCamera) and p.dtype == dtype for p in poses)
    return np.concatenate(
        [np.concatenate([p.rotation.cpu().numpy().reshape(-1), p.translation.cpu().numpy().reshape(-1)]) for p in poses]
    )


def _flat(poses):
    return np.concatenate(
        [np.concatenate([np.asarray(p.rotation).reshape(-1), np.asarray(p.translation).reshape(-1)]) for p in poses]
    )


def _reference(kind, prob, iters, dtype, resident_kernel):
    """cv_tpu on the same problem: the Pallas kernel (interpret mode) or the
    XLA loop."""

    def j(a):
        return jnp.asarray(a, dtype=dtype if a.dtype != bool else bool)

    if kind == "single_view":
        pose = RefW2C(rotation=j(prob["rot"]), translation=j(prob["t"]))
        args = (pose, j(prob["bear"]), j(prob["wp"]), j(prob["valid"]), 1e-2, iters)
        if resident_kernel:
            return _flat([pallas_loop.single_view_l2_resident(*args, interpret=True)])
        return _flat([ref_opt.single_view_simple_optimize_l2(*args)])
    if kind == "three_view":
        p1 = RefC2C(rotation=j(prob["r1"]), translation=j(prob["t1"]))
        p2 = RefC2C(rotation=j(prob["r2"]), translation=j(prob["t2"]))
        if resident_kernel:
            i1, i2 = p1.inverse(), p2.inverse()
            o1r, o1t, o2r, o2t = pallas_loop.three_view_l2_resident(
                i1.rotation, i1.translation, i2.rotation, i2.translation,
                j(prob["obs"]), j(prob["valid"]), 1e-2, iters, interpret=True,
            )
            return _flat([RefC2C(rotation=o1r, translation=o1t).inverse(),
                          RefC2C(rotation=o2r, translation=o2t).inverse()])
        return _flat(ref_opt.three_view_simple_optimize_l2((p1, p2), j(prob["obs"]), j(prob["valid"]), 1e-2, iters))
    # adaptive: K problems
    outs = []
    if resident_kernel:
        p1 = RefC2C(rotation=j(prob["r1"]), translation=j(prob["t1"])).inverse()
        p2 = RefC2C(rotation=j(prob["r2"]), translation=j(prob["t2"])).inverse()
        o1r, o1t, o2r, o2t = pallas_loop.three_view_adaptive_resident(
            p1.rotation, p1.translation, p2.rotation, p2.translation,
            j(prob["obs"]), j(prob["valid"]), iters, interpret=True,
        )
        outs = [RefC2C(rotation=o1r, translation=o1t).inverse(), RefC2C(rotation=o2r, translation=o2t).inverse()]
        return _flat(outs)
    pairs = [
        ref_opt.three_view_adaptive_optimize_l2(
            (RefC2C(rotation=j(prob["r1"][k]), translation=j(prob["t1"][k])),
             RefC2C(rotation=j(prob["r2"][k]), translation=j(prob["t2"][k]))),
            j(prob["obs"][k]), j(prob["valid"][k]), iters,
        )
        for k in range(prob["obs"].shape[0])
    ]
    # Same layout as the batched port: all first poses, then all second.
    first = RefC2C(rotation=jnp.stack([p[0].rotation for p in pairs]), translation=jnp.stack([p[0].translation for p in pairs]))
    second = RefC2C(rotation=jnp.stack([p[1].rotation for p in pairs]), translation=jnp.stack([p[1].translation for p in pairs]))
    return _flat([first, second])


FULL_RUN = {"single_view": 2000, "three_view": 2000, "adaptive": 200,
            "three_view_translating": 300, "adaptive_translating": 10}
CONVERGED = {"single_view": 20000, "three_view": 3000, "adaptive": 1000,
             "three_view_translating": 300, "adaptive_translating": 10}


@pytest.mark.parametrize("kind", PARITY_KINDS)
@pytest.mark.parametrize("run,tol", [("one_step", 1e-6), ("full", 1e-4)])
def test_plain_f32_matches_resident_kernel(kind, run, tol):
    prob = _problem(kind)
    iters = 1 if run == "one_step" else FULL_RUN[kind]
    got = _port(_base(kind), prob, iters, torch.float32)
    ref = _reference(_base(kind), prob, iters, jnp.float32, resident_kernel=True)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", PARITY_KINDS)
@pytest.mark.parametrize("run,tol", [("one_step", 1e-12), ("converged", 1e-6)])
def test_plain_f64_matches_xla_loop(kind, run, tol):
    prob = _problem(kind)
    iters = 1 if run == "one_step" else CONVERGED[kind]
    got = _port(_base(kind), prob, iters, torch.float64)
    ref = _reference(_base(kind), prob, iters, jnp.float64, resident_kernel=False)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _translation_sums(prob):
    """Norms of the summed translation tangents of both poses at the start
    poses (float64, the port's three-view gradient)."""
    from cv_tpu_torch.geom import epipolar

    def t(a):
        return torch.tensor(a, dtype=torch.float64)

    ftoc = CameraToCamera(rotation=t(prob["r1"]), translation=t(prob["t1"])).inverse()
    stoc = CameraToCamera(rotation=t(prob["r2"]), translation=t(prob["t2"])).inverse()
    obs = t(prob["obs"])
    f = (ftoc.rotation[..., None, :, :] * obs[..., 1, None, :]).sum(dim=-1)
    s = (stoc.rotation[..., None, :, :] * obs[..., 2, None, :]).sum(dim=-1)
    (t1, _), (t2, _) = epipolar.three_view_gradients(
        obs[..., 0, :], f, ftoc.translation[..., None, :], s, stoc.translation[..., None, :]
    )
    valid = torch.tensor(prob["valid"])[..., None]
    return [float(torch.where(valid, x, 0.0).sum(dim=-2).norm()) for x in (t1, t2)]


@pytest.mark.parametrize("kind", ["three_view", "adaptive"])
def test_translating_problems_move_the_translations(kind):
    """The translating problems take the translation path; the others do not."""
    assert min(_translation_sums(_problem(kind + "_translating"))) > 1.0
    assert max(_translation_sums(_problem(kind))) == 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_plain_padding_invariance(kind):
    """60 invalid rows of padding change no bit of the result."""
    prob = _problem(kind)
    iters = 300
    a = _port(kind, prob, iters, torch.float32)
    b = _port(kind, _pad(kind, prob, 60), iters, torch.float32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_on_cpu_is_the_plain_version(kind):
    """On CPU tensors each wrapper runs its plain version (bitwise) and
    counts no kernel launch; the pose types are kept (asserted in _port)."""
    prob = _problem(kind)
    counters = (resident.single_view_l2, resident.three_view_l2, resident.three_view_adaptive)
    before = [f.launches for f in counters]
    a = _port(kind, prob, 50, torch.float32, plain=False)
    b = _port(kind, prob, 50, torch.float32, plain=True)
    np.testing.assert_array_equal(a, b)
    assert [f.launches for f in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(kind):
    """Each CUDA kernel against its plain version on the card: 1e-6 after
    one step, 1e-4 after a full run, and bitwise padding invariance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _problem(kind)
    for iters, tol in ((1, 1e-6), (FULL_RUN[kind], 1e-4)):
        got = _port(kind, prob, iters, torch.float32, device="cuda", plain=False)
        ref = _port(kind, prob, iters, torch.float32, device="cuda", plain=True)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    a = _port(kind, prob, 300, torch.float32, device="cuda", plain=False)
    b = _port(kind, _pad(kind, prob, 60), 300, torch.float32, device="cuda", plain=False)
    np.testing.assert_array_equal(a, b)


def _interleave(kind, prob, extra, seed=7):
    """The problem with ``extra`` invalid rows (values 0.5/1.0) inserted at
    seeded random places among its rows, not only at the end."""
    out = dict(prob)
    rows = {"single_view": ("bear", "wp", "valid"), "three_view": ("obs", "valid"), "adaptive": ("obs", "valid")}
    axis = 1 if kind == "adaptive" else 0
    n = prob["valid"].shape[axis]
    at = np.sort(np.random.default_rng(seed).integers(0, n + 1, extra))
    for key in rows[kind]:
        fill = False if key == "valid" else (1.0 if key == "wp" else 0.5)
        out[key] = np.insert(prob[key], at, fill, axis=axis)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_plain_padding_invariance_interleaved(kind):
    """60 invalid rows interleaved among the valid ones change no bit."""
    prob = _problem(kind)
    a = _port(kind, prob, 300, torch.float32)
    padded = _interleave(kind, prob, 60)
    assert padded["valid"].shape[-1] == prob["valid"].shape[-1] + 60
    b = _port(kind, padded, 300, torch.float32)
    np.testing.assert_array_equal(a, b)


def _single_view_tensors(prob, dtype, device="cpu"):
    def t(a):
        return torch.tensor(a, dtype=dtype if a.dtype != bool else torch.bool, device=device)

    return WorldToCamera(rotation=t(prob["rot"]), translation=t(prob["t"])), t(prob["bear"]), t(prob["wp"]), t(
        prob["valid"])


@pytest.mark.parametrize("stop,iters", [("patience", 20000), ("iterations", 37)])
def test_plain_steps_out_counts_the_steps(monkeypatch, stop, iters):
    """``steps_out`` of the plain single-view loop equals its calls of
    ``landmark_deltas``, whether patience or ``iterations`` stops it; the
    wrapper on the CPU passes it through."""
    calls = [0]
    real = optimizers.landmark_deltas

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(optimizers, "landmark_deltas", counted)
    args = _single_view_tensors(_single_view_problem(), torch.float64)
    steps = torch.full((1,), -1, dtype=torch.int32)
    optimizers.single_view_simple_optimize_l2(*args, 1e-2, iters, steps)
    assert int(steps) == calls[0]
    if stop == "patience":
        assert calls[0] < iters
    else:
        assert calls[0] == iters
    wrapped = torch.full((1,), -1, dtype=torch.int32)
    resident.single_view_l2(*args, 1e-2, iters, steps_out=wrapped)
    assert int(wrapped) == int(steps)


def _sized_single_view(case):
    """Kernel A's shape cases: N valid rows, zero valid rows, a NaN row."""
    if case.startswith("n"):
        prob = _single_view_problem(m=int(case[1:]), seed=3)
        prob["valid"][:] = True
        return prob
    prob = _single_view_problem(m=200, seed=4)
    if case == "zero_valid":
        prob["valid"][:] = False
    else:  # nan_row: a valid row whose projection is NaN
        prob["valid"][:] = True
        prob["wp"][17] = np.nan
    return prob


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n1", "n31", "n1025", "n2048", "n2100", "n12000", "zero_valid", "nan_row"])
def test_single_view_kernel_shapes_on_card(case):
    """Kernel A against its plain version on the card, 1e-6 after one step
    and 1e-4 after 300, and the same step count; 12,000 rows are more than
    its registers and shared memory hold (~9,100 on an H100), so the rest
    are read from global memory each step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _sized_single_view(case)
    for iters, tol in ((1, 1e-6), (300, 1e-4)):
        args = _single_view_tensors(prob, torch.float32, "cuda")
        sk, sp = (torch.zeros(1, dtype=torch.int32, device="cuda") for _ in range(2))
        got = resident.single_view_l2(*args, 1e-2, iters, steps_out=sk)
        ref = optimizers.single_view_simple_optimize_l2(*args, 1e-2, iters, sp)
        torch.cuda.synchronize()
        for g, r in ((got.rotation, ref.rotation), (got.translation, ref.translation)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=tol, rtol=0)
        assert int(sk) == int(sp)


@pytest.mark.cuda
def test_single_view_kernel_interleaved_padding_on_card():
    """Invalid rows interleaved among the valid ones change no bit of
    kernel A's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _single_view_problem(m=3000, seed=5)  # 1,500 valid rows: registers and shared memory
    a = _port("single_view", prob, 300, torch.float32, device="cuda", plain=False)
    b = _port("single_view", _interleave("single_view", prob, 700), 300, torch.float32, device="cuda", plain=False)
    np.testing.assert_array_equal(a, b)


def _three_view_tensors(prob, dtype, device="cpu"):
    def t(a):
        return torch.tensor(a, dtype=dtype if a.dtype != bool else torch.bool, device=device)

    pair = (CameraToCamera(rotation=t(prob["r1"]), translation=t(prob["t1"])),
            CameraToCamera(rotation=t(prob["r2"]), translation=t(prob["t2"])))
    return pair, t(prob["obs"]), t(prob["valid"])


@pytest.mark.parametrize("stop,iters,rate", [("patience", 20000, 1.0), ("iterations", 37, 1e-2)])
def test_plain_three_view_steps_out_counts_the_steps(monkeypatch, stop, iters, rate):
    """``steps_out`` of the plain three-view loop equals its calls of the
    per-landmark tangents, whether patience (at rate 1, after ~2,000 steps)
    or ``iterations`` stops it; the wrapper on the CPU passes it through."""
    calls = [0]
    real = optimizers._three_view_landmark_gradients

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(optimizers, "_three_view_landmark_gradients", counted)
    args = _three_view_tensors(_three_view_problem(), torch.float64)
    steps = torch.full((1,), -1, dtype=torch.int32)
    optimizers.three_view_simple_optimize_l2(*args, rate, iters, steps)
    assert int(steps) == calls[0]
    if stop == "patience":
        assert calls[0] < iters
    else:
        assert calls[0] == iters
    wrapped = torch.full((1,), -1, dtype=torch.int32)
    resident.three_view_l2(*args, rate, iters, steps_out=wrapped)
    assert int(wrapped) == int(steps)


def _sized_three_view(case):
    """Kernel B's shape cases: N valid rows, 222 valid of a 1,024-row bucket
    (the engine's calls), zero valid rows, a NaN row."""
    if case.startswith("n"):
        prob = _three_view_problem(n=int(case[1:]), seed=3)
    elif case == "bucket":
        prob = _three_view_problem(n=1024, seed=3)
        prob["valid"][:] = False
        prob["valid"][np.random.default_rng(3).choice(1024, 222, replace=False)] = True
    else:
        prob = _three_view_problem(n=200, seed=4)
        if case == "zero_valid":
            prob["valid"][:] = False
        else:  # nan_row: a valid row whose bearings are NaN
            prob["obs"][17] = np.nan
    return prob


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n1", "n31", "bucket", "n1025", "n2048", "n8000", "zero_valid", "nan_row"])
def test_three_view_kernel_shapes_on_card(case):
    """Kernel B against its plain version on the card, 1e-6 after one step
    and 1e-4 after 300, and the same step count; 8,000 rows are more than
    its registers and shared memory hold (~6,500 on an H100), so the rest
    are read from global memory each step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _sized_three_view(case)
    for iters, tol in ((1, 1e-6), (300, 1e-4)):
        args = _three_view_tensors(prob, torch.float32, "cuda")
        sk, sp = (torch.zeros(1, dtype=torch.int32, device="cuda") for _ in range(2))
        got = resident.three_view_l2(*args, 1e-2, iters, steps_out=sk)
        ref = optimizers.three_view_simple_optimize_l2(*args, 1e-2, iters, sp)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_flat_torch(got), _flat_torch(ref), atol=tol, rtol=0)
        assert int(sk) == int(sp)


def _flat_torch(poses):
    return np.concatenate([np.concatenate([p.rotation.cpu().numpy().ravel(), p.translation.cpu().numpy().ravel()])
                           for p in poses])


def _adaptive_batch(k, seed, ragged=False, empty=()):
    """K three-view problems of 64 rows; ``ragged`` cuts problem j to
    64 - j % 16 valid rows, ``empty`` lists problems without valid rows."""
    probs = [_three_view_problem(n=64, seed=seed + j) for j in range(k)]
    for j, pr in enumerate(probs):
        if ragged:
            pr["valid"][64 - j % 16:] = False
        if j in empty:
            pr["valid"][:] = False
    return {key: np.stack([pr[key] for pr in probs]) for key in probs[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("k,ragged,empty", [(1, False, ()), (9, True, ()), (64, True, ()), (4, False, (2,))],
                         ids=["1x64", "9x64_ragged", "64x64", "no_valid_row"])
def test_adaptive_kernel_shapes_on_card(k, ragged, empty):
    """Kernel C against its plain version on the card at the engine's
    problem counts, 1e-6 after one step and 1e-4 after 200."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _adaptive_batch(k, seed=20, ragged=ragged, empty=empty)
    for iters, tol in ((1, 1e-6), (200, 1e-4)):
        got = _port("adaptive", prob, iters, torch.float32, device="cuda", plain=False)
        ref = _port("adaptive", prob, iters, torch.float32, device="cuda", plain=True)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["three_view", "adaptive"])
def test_three_view_kernels_interleaved_padding_on_card(kind):
    """Invalid rows interleaved among the valid ones change no bit of
    kernel B's or C's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _three_view_problem(n=1500, seed=5) if kind == "three_view" else _adaptive_batch(9, seed=30, ragged=True)
    a = _port(kind, prob, 300, torch.float32, device="cuda", plain=False)
    b = _port(kind, _interleave(kind, prob, 700 if kind == "three_view" else 60), 300, torch.float32,
              device="cuda", plain=False)
    np.testing.assert_array_equal(a, b)
