"""SE(3) poses as plain dataclasses of tensors.

Port of ``cv_tpu/core/pose.py`` (reference cv-core/src/pose.rs): one
:class:`Isometry3` holds a batch of rigid transforms as ``rotation
(..., 3, 3)`` + ``translation (..., 3)``; the subclasses keep the
reference's frame vocabulary (:class:`WorldToCamera`,
:class:`CameraToWorld`, :class:`CameraToCamera`, :class:`WorldToWorld`).  Small products are plain float matmuls, run
in full precision on the card whatever the TF32 setting
(:func:`~cv_tpu_torch.ops.precision.full_f32`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import projective
from .lie import so3_exp, so3_hat, so3_log
from ..ops import trig
from ..ops.precision import full_f32


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for ``(..., i, j) x (..., j) -> (..., i)``, broadcasting."""
    return (m * v[..., None, :]).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class Isometry3:
    """A rigid transform ``y = R x + t`` (batched)."""

    rotation: torch.Tensor  # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)

    @classmethod
    def identity(cls, batch_shape: tuple = (), dtype=torch.float64, device=None):
        eye = torch.eye(3, dtype=dtype, device=device)
        return cls(
            rotation=eye.expand(tuple(batch_shape) + (3, 3)),
            translation=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
        )

    @classmethod
    def from_numpy(cls, rotation: np.ndarray, translation: np.ndarray, device=None):
        """From NumPy arrays (copied), keeping their dtype."""
        return cls(
            rotation=torch.tensor(np.asarray(rotation), device=device),
            translation=torch.tensor(np.asarray(translation), device=device),
        )

    @classmethod
    def from_tangent(cls, translation: torch.Tensor, rotation: torch.Tensor):
        """``Se3TangentSpace.isometry`` convention: ``(R, R @ translation)``."""
        r = so3_exp(rotation)
        return cls(rotation=r, translation=_mv(r, translation))

    def to_numpy(self):
        """``(rotation, translation)`` as NumPy arrays."""
        return self.rotation.cpu().numpy(), self.translation.cpu().numpy()

    @property
    def batch_shape(self):
        return self.translation.shape[:-1]

    @property
    def dtype(self):
        return self.translation.dtype

    def inverse(self) -> "Isometry3":
        rt = self.rotation.transpose(-1, -2)
        return type(self)(rotation=rt, translation=-_mv(rt, self.translation))

    @full_f32
    def compose(self, other: "Isometry3") -> "Isometry3":
        """self after other: (self @ other)(x) = self(other(x))."""
        return Isometry3(
            rotation=self.rotation @ other.rotation,
            translation=_mv(self.rotation, other.translation) + self.translation,
        )

    def scale(self, scale) -> "Isometry3":
        """Scale the translation component (pose.rs:35-41)."""
        return type(self)(rotation=self.rotation, translation=self.translation * scale)

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Transform euclidean 3-points ``(..., 3)``."""
        return _mv(self.rotation, p) + self.translation

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        """Rotate vectors/bearings (no translation)."""
        return _mv(self.rotation, v)

    def matrix3x4(self) -> torch.Tensor:
        return torch.cat([self.rotation, self.translation[..., :, None]], dim=-1)

    def homogeneous(self) -> torch.Tensor:
        """4x4 homogeneous matrix (pose.rs:50-52)."""
        bottom = torch.cat([torch.zeros_like(self.translation), torch.ones_like(self.translation[..., :1])], dim=-1)
        return torch.cat([self.matrix3x4(), bottom[..., None, :]], dim=-2)

    def se3(self) -> torch.Tensor:
        """The reference's se(3) vector ``[t, log R]`` (pose.rs:55-60)."""
        return torch.cat([self.translation, so3_log(self.rotation)], dim=-1)

    def transform(self, hp: torch.Tensor) -> torch.Tensor:
        """Transform projective points ``(..., 4)``, renormalized
        (pose.rs:120-122)."""
        return projective.from_homogeneous(self.transform_unnormalized(hp))

    def transform_unnormalized(self, hp: torch.Tensor) -> torch.Tensor:
        xyz = _mv(self.rotation, hp[..., :3]) + self.translation * hp[..., 3:4]
        w = hp[..., 3:4].expand(xyz.shape[:-1] + (1,))
        return torch.cat([xyz, w], dim=-1)

    @full_f32
    def transform_jacobians(self, hp: torch.Tensor):
        """Transform + Jacobians w.r.t. the input point and the pose
        (pose.rs:70-90): ``(output, d_output/d_input (..., 4, 4),
        d_output/d_[t, w] (..., 4, 6))``, the output renormalized and the
        Jacobians of the raw homogeneous product (pose.rs:131-174), the pose
        block a right-perturbation of translation and rotation output."""
        output = self.transform_unnormalized(hp)
        jac_input = self.homogeneous()
        w = hp[..., 3:4]
        eye4 = torch.eye(4, dtype=hp.dtype, device=hp.device).expand(output.shape[:-1] + (4, 4))
        dp_dt = eye4 * w[..., None]
        eye3 = torch.eye(3, dtype=hp.dtype, device=hp.device).expand(self.rotation.shape)
        t_h = Isometry3(rotation=eye3, translation=self.translation).homogeneous()
        hat_rot = so3_hat(_mv(self.rotation, hp[..., :3]))  # (..., 3, 3)
        hat_h = torch.zeros(hat_rot.shape[:-2] + (4, 4), dtype=hp.dtype, device=hp.device)
        hat_h[..., :3, :3] = hat_rot
        hat_h[..., 3, 3] = 1.0
        dp_ds = t_h @ hat_h
        # The reference packs [dp_dt rows 0..3; dp_ds rows 0..3] as a 6x4
        # and transposes it (pose.rs:157-173).
        stacked = torch.cat([dp_dt[..., :3, :], dp_ds[..., :3, :]], dim=-2)
        return projective.from_homogeneous(output), jac_input, stacked.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class WorldToCamera(Isometry3):
    """Pose of the world relative to a camera: WorldPoint -> CameraPoint."""


@dataclasses.dataclass(frozen=True)
class CameraToWorld(Isometry3):
    """Camera extrinsics: CameraPoint -> WorldPoint."""


@dataclasses.dataclass(frozen=True)
class CameraToCamera(Isometry3):
    """Relative pose: CameraPoint of A -> CameraPoint of B."""


@dataclasses.dataclass(frozen=True)
class WorldToWorld(Isometry3):
    """Relative transform between two reconstructions' world frames."""

    @classmethod
    def from_camera_poses(cls, a_pose: Isometry3, b_pose: Isometry3) -> "WorldToWorld":
        """From one camera's pose in both reconstructions (pose.rs:322-324)."""
        iso = b_pose.inverse().compose(a_pose)
        return cls(rotation=iso.rotation, translation=iso.translation)


def world_to_camera_residual(pose: Isometry3, bearing: torch.Tensor, world_point: torch.Tensor):
    """``Model<FeatureWorldMatch>::residual`` (pose.rs:194-202):
    ``1 - bearing . bearing(pose @ world_point)``, broadcasting poses
    against matches."""
    obs = projective.bearing(pose.transform(world_point))
    return 1.0 - (bearing * obs).sum(dim=-1)


# The design's upper triangle, row-major: (row, column) index pairs.
_UPPER = [(i, j) for i in range(4) for j in range(i, 4)]


def _dlt_terms(pm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rows ``pm - v (v^T pm)`` ``(..., 3, 4)`` of one bearing's DLT
    block: each column's ``v^T pm`` by
    :func:`~cv_tpu_torch.ops.trig.dot_fused` and each entry one fused
    ``fma(-v_k, s_j, pm_kj)``, as XLA's CPU code computes them in the jitted
    scoring (each result below the normal range flushed: XLA's FTZ/DAZ,
    :func:`~cv_tpu_torch.ops.trig.ftz`)."""
    s = trig.dot_fused(v[..., :, None], pm, -2, flush=True)  # (..., 4)
    return trig.ftz(trig.fma(-v[..., :, None], s[..., None, :], pm))



def c2c_design(pose: Isometry3, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The residual's symmetric 4x4 DLT design ``sum_k t_k t_k^T`` over the
    three rows of each bearing's block (``a`` against the identity, ``b``
    against ``pose``), broadcast to ``(..., 4, 4)``, with the reference's
    jitted bits on a CPU: the first product rounded, every later one fused
    into the running sum (``fma(t0i, t0j, t1i t1j)``, then ``fma(t_ki, t_kj,
    acc)`` in order: a's rows, then b's)."""
    eye = torch.eye(3, 4, dtype=a.dtype, device=a.device)
    ta, tb = _dlt_terms(eye, trig.ftz(a)), _dlt_terms(trig.ftz(pose.matrix3x4()), trig.ftz(b))
    shape = torch.broadcast_shapes(ta.shape, tb.shape)
    rows = torch.cat([ta.expand(shape), tb.expand(shape)], -2)  # (..., 6, 4)
    ii, jj = (torch.tensor(k, device=a.device) for k in zip(*_UPPER))
    x, y = rows[..., ii], rows[..., jj]  # (..., 6, 10)
    acc = trig.ftz(trig.fma(x[..., 0, :], y[..., 0, :], trig.ftz(x[..., 1, :] * y[..., 1, :])))
    for k in range(2, 6):
        acc = trig.ftz(trig.fma(x[..., k, :], y[..., k, :], acc))
    full = [_UPPER.index((min(i, j), max(i, j))) for i in range(4) for j in range(4)]
    return acc[..., full].reshape(shape[:-2] + (4, 4))


def c2c_residual_plain(pose: Isometry3, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`camera_to_camera_residual` in torch operations on any device,
    with the bits of ``cv_tpu``'s jitted scoring on a CPU: the design of
    :func:`c2c_design`, the Jacobi ``ops.eigen.eigh_small_plain``, the
    eigenvector of least
    |eigenvalue| (the first on ties), and the point, the bearings and the
    cosines as XLA's CPU code computes them: each sum of products
    :func:`~cv_tpu_torch.ops.trig.dot_fused`, the pose's translation fused
    into its rotated point, the IEEE square root, and the residual as
    ``((2 - a.bearing_a) - b.bearing_b) * 0.5``, XLA's reassociation of
    ``0.5 (1 - a.bearing_a + 1 - b.bearing_b)``.  Non-finite results are
    2.0."""
    from ..ops import eigen

    eigvals, eigvecs = eigen.eigh_small_plain(c2c_design(pose, a, b))
    idx = torch.argmin(eigvals.abs(), dim=-1)
    v = torch.gather(eigvecs, -1, idx[..., None, None].expand(eigvecs.shape[:-1] + (1,)))[..., 0]
    pt = _from_homogeneous_fused(v)
    p = pt.unbind(-1)
    rot, tr, a, b = trig.ftz(pose.rotation), trig.ftz(pose.translation), trig.ftz(a), trig.ftz(b)
    q = [trig.ftz(trig.fma(tr[..., i], p[3], trig.dot_fused([rot[..., i, k] for k in range(3)], p[:3], flush=True)))
         for i in range(3)]
    qb = _from_homogeneous_fused(torch.stack(q + [p[3].expand(q[0].shape)], -1)).unbind(-1)
    da = trig.dot_fused(a.unbind(-1), p[:3], flush=True)
    db = trig.dot_fused(b.unbind(-1), qb[:3], flush=True)
    res = trig.ftz((trig.ftz(2.0 - da) - db) * 0.5)
    finite = torch.isfinite(pt).all(dim=-1)
    return torch.where(finite & torch.isfinite(res), res, torch.full_like(res, 2.0))


def _c2c_residual_unfused(pose: Isometry3, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The residual in its cheap form (a CPU's within
    ``ops.eigen.cheap_on_cpu``): the design and the scores summed in plain
    products, the unfused Jacobi sweep, within a few ulps of
    :func:`c2c_residual_plain`."""
    from ..ops.eigen import _eigh_unfused

    eye_pose = Isometry3.identity(dtype=a.dtype, device=a.device)
    shape = torch.broadcast_shapes(a.shape[:-1], pose.batch_shape) + (4, 4)
    design = torch.zeros(shape, dtype=a.dtype, device=a.device)
    for p, bearing_vec in ((eye_pose, a), (pose, b)):
        pm = p.matrix3x4()  # (..., 3, 4)
        s = (bearing_vec[..., :, None] * pm).sum(dim=-2)  # (..., 4)
        term = pm - bearing_vec[..., :, None] * s[..., None, :]  # (..., 3, 4)
        for k in range(3):
            tk = term[..., k, :]
            design = design + tk[..., :, None] * tk[..., None, :]
    eigvals, eigvecs = _eigh_unfused(design)
    idx = torch.argmin(eigvals.abs(), dim=-1)
    v = torch.gather(eigvecs, -1, idx[..., None, None].expand(eigvecs.shape[:-1] + (1,)))[..., 0]
    pt = projective.from_homogeneous(v)
    res = 0.5 * (1.0 - (a * projective.bearing(pt)).sum(dim=-1) + 1.0
                 - (b * projective.bearing(pose.transform(pt))).sum(dim=-1))
    return torch.where(projective.is_finite(pt) & torch.isfinite(res), res, torch.full_like(res, 2.0))


def _from_homogeneous_fused(point: torch.Tensor) -> torch.Tensor:
    """:func:`projective.from_homogeneous` with the norm's squares summed by
    ``dot_fused`` and the IEEE square root (the jitted scoring's bits)."""
    point = torch.where(point[..., 3:4] < 0, -point, point)
    xyz = point[..., :3].unbind(-1)
    return trig.ftz(point / trig.sqrt(trig.dot_fused(xyz, xyz, flush=True))[..., None])


def camera_to_camera_residual(pose: Isometry3, a: torch.Tensor, b: torch.Tensor):
    """``Model<FeatureMatch>::residual`` for a relative pose (pose.rs:249-296).

    Triangulates via the symmetric 4x4 DLT (smallest eigenvector of the
    accumulated design matrix) and scores cheirality + cosine distance; any
    non-finite result maps to 2.0 exactly like the reference.  Broadcasts
    the pose batch against the match batch.  On a CUDA tensor one launch of
    ``csrc/jacobi.cu``'s residual entry (:func:`c2c_residual`); on a CPU
    tensor :func:`c2c_residual_plain`, or within ``ops.eigen.cheap_on_cpu``
    (the plain version costs tens of times the cheap form there)
    :func:`_c2c_residual_unfused`.
    """
    from ..ops import eigen

    if a.device.type == "cuda":
        return c2c_residual(pose, a, b)
    return _c2c_residual_unfused(pose, a, b) if eigen._cheap(a) else c2c_residual_plain(pose, a, b)


_VOID, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _check_entry_args(name, pose: Isometry3, a: torch.Tensor, b: torch.Tensor, tensors=()):
    """The checks of the residual and score entries: CUDA tensors on one
    device, one dtype of float32 / float64."""
    tensors = (pose.rotation, pose.translation, a, b, *tensors)
    if any(t.device.type != "cuda" for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: CUDA tensors on one device, got {[t.device for t in tensors]}")
    floats = tensors[:4]
    if len({t.dtype for t in floats}) != 1 or a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: one dtype of float32 / float64, got {[t.dtype for t in floats]}")


def c2c_residual(pose: Isometry3, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`c2c_residual_plain` on CUDA tensors, one thread a
    (model, match) pair in one launch of ``csrc/jacobi.cu``
    (``cv_c2c_residual_f64`` / ``_f32``): the design, the Jacobi, the
    eigenvector and the score in registers; only the residuals are written.
    Poses of batch shape ``S + (1,)`` against ``(M, 3)`` matches (the
    consensus's layout) run as a ``(P, M)`` grid; any other broadcast is
    expanded and run pair by pair.  Counted on ``c2c_residual.launches``."""
    from .. import kernels

    _check_entry_args("c2c_residual", pose, a, b)
    sp, sd = pose.rotation.shape[:-2], torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    shape = torch.broadcast_shapes(sp, pose.translation.shape[:-1], sd)
    if len(sd) == 1 and len(sp) >= 1 and sp[-1] == 1 and shape == sp[:-1] + sd and pose.translation.shape[:-1] == sp:
        rot, tr = pose.rotation.reshape(-1, 9), pose.translation.reshape(-1, 3)
        av, bv = a.expand(sd + (3,)), b.expand(sd + (3,))
        n_pose, n_match, paired = rot.shape[0], sd[0], 0
    else:
        rot = pose.rotation.expand(shape + (3, 3)).reshape(-1, 9)
        tr = pose.translation.expand(shape + (3,)).reshape(-1, 3)
        av, bv = a.expand(shape + (3,)).reshape(-1, 3), b.expand(shape + (3,)).reshape(-1, 3)
        n_pose, n_match, paired = rot.shape[0], 1, 1
    rot, tr, av, bv = (t.contiguous() for t in (rot, tr, av, bv))
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    symbol = "cv_c2c_residual_f32" if a.dtype == torch.float32 else "cv_c2c_residual_f64"
    err = kernels.function("jacobi", symbol, [_VOID] * 5 + [_I64, _I64, _INT, _VOID])(
        rot.data_ptr(), tr.data_ptr(), av.data_ptr(), bv.data_ptr(), out.data_ptr(), n_pose, n_match, paired,
        kernels.current_stream(a.device))
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    if out.numel() > 0:
        c2c_residual.launches += 1
    return out


c2c_residual.launches = 0  # kernel launches so far

# The widest chunk of a model's row in the score entry, and so the shape of
# its summation order (csrc/jacobi.cu's kChunkWidth).
SCORE_CHUNK_WIDTH = 128


def score_chunk(matches: int) -> int:
    """The chunk width of a row of ``matches``: the least power of two at
    least ``matches``, at most ``SCORE_CHUNK_WIDTH``."""
    r = 1
    while r < SCORE_CHUNK_WIDTH and r < matches:
        r <<= 1
    return r


def ordered_row_sum(x: torch.Tensor) -> torch.Tensor:
    """The score entry's sum of ``x`` ``(..., M)`` over its last axis: the
    row cut into chunks of ``C = score_chunk(M)``, each chunk's values
    meeting in a halving tree (``s[t] + s[t + h]`` for ``h = C/2, ..., 1``;
    the last chunk padded with +0), then the chunks' sums added in order
    (the first, then each next)."""
    m = x.shape[-1]
    cw = score_chunk(m)
    chunks = max(1, -(-m // cw))
    x = torch.nn.functional.pad(x, (0, chunks * cw - m)).reshape(x.shape[:-1] + (chunks, cw))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    acc = x[..., 0, 0]
    for k in range(1, chunks):
        acc = acc + x[..., k, 0]
    return acc


def c2c_score_plain(pose: Isometry3, a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, threshold: float):
    """The consensus score of relative poses of batch shape ``S + (1,)``
    against ``(M, 3)`` matches in torch operations on any device: each
    pair's :func:`c2c_residual_plain`, an inlier where ``res < threshold``,
    ``valid`` and ``res`` finite, and per pose the inliers' count (int64)
    and the sum of their residuals in the score entry's order
    (:func:`ordered_row_sum`).  Returns ``(counts S, totals S)``."""
    res = c2c_residual_plain(pose, a, b)
    inliers = (res < threshold) & valid & torch.isfinite(res)
    return inliers.sum(dim=-1), ordered_row_sum(torch.where(inliers, res, torch.zeros_like(res)))


def c2c_score(pose: Isometry3, a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, threshold: float):
    """:func:`c2c_score_plain`, on CUDA tensors one launch of
    ``csrc/jacobi.cu``'s score entry (``cv_c2c_score_f64`` / ``_f32``): each
    pair's residual in registers as in :func:`c2c_residual`, tested and
    summed in the same launch; only the counts and totals are written (no
    residual, no mask).  Poses of batch shape ``S + (1,)`` (``S`` non-empty),
    matches ``(M, 3)``, ``valid`` ``(M,)`` bool.  On CPU tensors the plain
    version.  Counted on ``c2c_score.launches``."""
    from .. import kernels

    if a.device.type == "cpu":
        return c2c_score_plain(pose, a, b, valid, threshold)
    _check_entry_args("c2c_score", pose, a, b, (valid,))
    sp = pose.rotation.shape[:-2]
    if (len(sp) < 2 or sp[-1] != 1 or pose.translation.shape[:-1] != sp or a.dim() != 2 or a.shape != b.shape
            or a.shape[-1] != 3 or valid.shape != a.shape[:1] or valid.dtype != torch.bool):
        raise ValueError(f"c2c_score: poses S + (1,), matches (M, 3), valid (M,) bool; got {tuple(sp)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(valid.shape)} {valid.dtype}")
    rot, tr = pose.rotation.reshape(-1, 9).contiguous(), pose.translation.reshape(-1, 3).contiguous()
    av, bv, ok = a.contiguous(), b.contiguous(), valid.contiguous().view(torch.uint8)
    n_pose, n_match = rot.shape[0], av.shape[0]
    counts = torch.empty(sp[:-1], dtype=torch.int64, device=a.device)
    totals = torch.empty(sp[:-1], dtype=a.dtype, device=a.device)
    # Rows of several chunks meet in the kernel's scratch: each chunk's sum
    # and count, and a zeroed arrival count a row.
    chunks = max(1, -(-n_match // score_chunk(n_match)))
    scratch = (torch.empty(n_pose * chunks, dtype=a.dtype, device=a.device),
               torch.empty(n_pose * chunks, dtype=torch.int64, device=a.device),
               torch.zeros(n_pose, dtype=torch.int32, device=a.device)) if chunks > 1 else ()
    scratch_ptrs = [t.data_ptr() for t in scratch] or [None] * 3
    symbol = "cv_c2c_score_f32" if a.dtype == torch.float32 else "cv_c2c_score_f64"
    err = kernels.function("jacobi", symbol, [_VOID] * 5 + [ctypes.c_double, _I64, _I64] + [_VOID] * 6)(
        rot.data_ptr(), tr.data_ptr(), av.data_ptr(), bv.data_ptr(), ok.data_ptr(), float(threshold), n_pose, n_match,
        counts.data_ptr(), totals.data_ptr(), *scratch_ptrs, kernels.current_stream(a.device))
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")
    if counts.numel() > 0:
        c2c_score.launches += 1
    return counts, totals


c2c_score.launches = 0  # kernel launches so far
