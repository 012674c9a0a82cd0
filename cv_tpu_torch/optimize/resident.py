"""The pose-optimizer loops as hand-written CUDA kernels, one launch per
whole loop.

Counterpart of ``cv_tpu/optimize/pallas_loop.py``.  Each wrapper is a
drop-in for its plain version in :mod:`cv_tpu_torch.optimize.optimizers`
and takes the same arguments:

* :func:`single_view_l2` — ``csrc/single_view_l2.cu``, replaces
  ``single_view_l2_resident`` (plain: ``single_view_simple_optimize_l2``);
* :func:`three_view_l2` — ``csrc/three_view_l2.cu``, replaces
  ``three_view_l2_resident`` (plain: ``three_view_simple_optimize_l2``);
* :func:`three_view_adaptive` — ``csrc/three_view_adaptive.cu``, replaces
  ``three_view_adaptive_resident`` (plain: the batched
  ``three_view_adaptive_optimize_l2``), one block per problem.

On CPU tensors a wrapper runs the plain version in the dtype it is given.
On CUDA tensors it launches the kernel or raises; the kernel computes in
float32 (as the TPU kernels do) and the result comes back in the pose's
dtype and type.  ``<wrapper>.launches`` counts kernel launches.

Each kernel ranks the valid rows once per launch and sums them by rank, so
its sum order depends on its fixed block size (256 threads each, set in
its source) alone: invalid rows, appended or interleaved, change no bit.
``steps_out`` of A and B reports the steps taken, as the plain versions'
does.  The wrappers allocate each launch's scratch (``order``, the rank ->
row table of rows past the on-chip tiers).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..core.pose import Isometry3
from . import optimizers


def _device(*tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _flat_pose(pose: Isometry3) -> torch.Tensor:
    return torch.cat([pose.rotation.reshape(-1, 9), pose.translation.reshape(-1, 3)], dim=-1)


def _unflat_pose(flat: torch.Tensor, like: Isometry3) -> Isometry3:
    shape = tuple(like.translation.shape[:-1])
    return type(like)(
        rotation=flat[..., :9].reshape(shape + (3, 3)).to(like.dtype),
        translation=flat[..., 9:12].reshape(shape + (3,)).to(like.dtype),
    )


def _f32(t: torch.Tensor, shape: tuple, name: str) -> torch.Tensor:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def _mask(valid: torch.Tensor, shape: tuple) -> torch.Tensor:
    if valid.dtype != torch.bool or tuple(valid.shape) != shape:
        raise ValueError(f"valid must be bool {shape}, got {valid.dtype} {tuple(valid.shape)}")
    return valid.contiguous().view(torch.uint8)


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_SV_ARGS = [_P] * 7 + [_I, ctypes.c_float, _I, _P]


def _check_steps_out(steps_out, dev):
    if steps_out is not None and (steps_out.dtype != torch.int32 or steps_out.numel() != 1
                                  or steps_out.device != dev):
        raise ValueError(f"steps_out must be one int32 on {dev}, got {steps_out.dtype} "
                         f"{tuple(steps_out.shape)} on {steps_out.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def single_view_l2(pose: Isometry3, bearings, world_points, valid, optimization_rate: float, iterations: int,
                   steps_out=None):
    """Single-view L2 patience loop; see
    :func:`optimizers.single_view_simple_optimize_l2` for the arguments.

    ``steps_out``, a one-element int32 tensor on the inputs' device, gets
    the number of steps taken."""
    dev = _device(pose.rotation, pose.translation, bearings, world_points, valid)
    if dev.type == "cpu":
        return optimizers.single_view_simple_optimize_l2(
            pose, bearings, world_points, valid, optimization_rate, iterations, steps_out
        )
    n = bearings.shape[0]
    if tuple(pose.rotation.shape) != (3, 3) or tuple(pose.translation.shape) != (3,):
        raise ValueError("single_view_l2 takes one pose: rotation (3, 3), translation (3,)")
    _check_steps_out(steps_out, dev)
    pose_in = _flat_pose(pose).reshape(12).to(torch.float32).contiguous()
    bear = _f32(bearings, (n, 3), "bearings")
    wp = _f32(world_points, (n, 4), "world_points")
    vmask = _mask(valid, (n,))
    out = torch.empty(12, dtype=torch.float32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    _check(
        kernels.function("single_view_l2", "cv_single_view_l2", _SV_ARGS)(
            pose_in.data_ptr(), bear.data_ptr(), wp.data_ptr(), vmask.data_ptr(), out.data_ptr(),
            _ptr(steps_out), order.data_ptr(), n, float(optimization_rate),
            int(iterations), kernels.current_stream(dev),
        ),
        "single_view_l2",
    )
    single_view_l2.launches += 1
    return _unflat_pose(out, pose)


def _tv_pack(poses, observations, valid, batch: tuple, n: int):
    """Camera-to-center poses as (..., 24) f32, obs (..., N, 9) f32, mask."""
    ftoc, stoc = poses[0].inverse(), poses[1].inverse()
    flat = torch.cat([_flat_pose(ftoc), _flat_pose(stoc)], dim=-1).reshape(batch + (24,))
    obs = _f32(observations, batch + (n, 3, 3), "observations")
    return ftoc, stoc, flat.to(torch.float32).contiguous(), obs, _mask(valid, batch + (n,))


def _tv_unpack(out, ftoc, stoc):
    """Kernel output -> the optimized (center->first, center->second) pair,
    inverted back in the poses' dtype."""
    return _unflat_pose(out[..., :12], ftoc).inverse(), _unflat_pose(out[..., 12:], stoc).inverse()


def three_view_l2(poses: tuple, observations, valid, optimization_rate: float, iterations: int, steps_out=None):
    """Three-view L2 patience loop (one problem); see
    :func:`optimizers.three_view_simple_optimize_l2` for the arguments.

    ``steps_out``, a one-element int32 tensor on the inputs' device, gets
    the number of steps taken."""
    dev = _device(poses[0].rotation, poses[1].rotation, observations, valid)
    if dev.type == "cpu":
        return optimizers.three_view_simple_optimize_l2(
            poses, observations, valid, optimization_rate, iterations, steps_out
        )
    _check_steps_out(steps_out, dev)
    n = observations.shape[0]
    ftoc, stoc, flat, obs, vmask = _tv_pack(poses, observations, valid, (), n)
    out = torch.empty(24, dtype=torch.float32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    fn = kernels.function("three_view_l2", "cv_three_view_l2", [_P] * 6 + [_I, ctypes.c_float, _I, _P])
    _check(
        fn(flat.data_ptr(), obs.data_ptr(), vmask.data_ptr(), out.data_ptr(), _ptr(steps_out), order.data_ptr(), n,
           float(optimization_rate), int(iterations), kernels.current_stream(dev)),
        "three_view_l2",
    )
    three_view_l2.launches += 1
    return _tv_unpack(out, ftoc, stoc)


def three_view_adaptive(poses: tuple, observations, valid, iterations: int):
    """K adaptive three-view loops, fixed iterations; see
    :func:`optimizers.three_view_adaptive_optimize_l2` for the arguments
    (here batched: poses (K,), observations (K, N, 3, 3), valid (K, N))."""
    dev = _device(poses[0].rotation, poses[1].rotation, observations, valid)
    if dev.type == "cpu":
        return optimizers.three_view_adaptive_optimize_l2(poses, observations, valid, iterations)
    if observations.ndim != 4:
        raise ValueError(f"three_view_adaptive takes (K, N, 3, 3) observations, got {tuple(observations.shape)}")
    k, n = observations.shape[:2]
    ftoc, stoc, flat, obs, vmask = _tv_pack(poses, observations, valid, (k,), n)
    out = torch.empty((k, 24), dtype=torch.float32, device=dev)
    if k == 0:
        return _tv_unpack(out, ftoc, stoc)
    order = torch.empty((k, n), dtype=torch.int32, device=dev)
    fn = kernels.function("three_view_adaptive", "cv_three_view_adaptive", [_P] * 5 + [_I, _I, _I, _P])
    _check(
        fn(flat.data_ptr(), obs.data_ptr(), vmask.data_ptr(), out.data_ptr(), order.data_ptr(), k, n, int(iterations),
           kernels.current_stream(dev)),
        "three_view_adaptive",
    )
    three_view_adaptive.launches += 1
    return _tv_unpack(out, ftoc, stoc)


# Kernel launches so far (CPU calls, which run the plain versions, do not count).
single_view_l2.launches = 0
three_view_l2.launches = 0
three_view_adaptive.launches = 0
