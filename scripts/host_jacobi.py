#!/usr/bin/env python3
"""Build ``csrc/jacobi.cu`` for the host CPU with g++ and hold its consensus
entries bitwise to their plain versions, where there is no ``nvcc``.

The host stand-ins of ``scripts/host_cuda.py`` take the place of CUDA's;
the library's C functions then run on host pointers (CPU tensors'
``data_ptr``).  Checks, float64 and float32:

* ``cv_c2c_residual_*`` against ``core.pose.c2c_residual_plain`` and
  ``cv_c2c_score_*`` against ``c2c_score_plain`` on seeded consensus
  problems (inliers through the first pose, outliers, a == b, a zero
  bearing, a NaN and an infinite entry; 11 to 300 matches, so eight rows a
  block to three chunks a row; the last fifth of the rows invalid), and on
  poses scaled to 1e-155 (float32: 1e-20), where the design's products
  flush, and to 2^-80, 2^-86, 1e120 and 1e160 (float64), about the bounds
  of the range where the kernel's pair skips its flushes;
* ``cv_jacobi_*`` at N = 3, 4 and 9 against ``ops.eigen.eigh_small_plain``;
* the specialized trigonometry of the float64 angle against ``trig.cuh``'s general
  functions on edge draws: ``atan2_jacobi`` against ``atan2_64`` (exponents
  at the bounds of its common case, zeros, subnormals, infinities, NaNs)
  and ``cos_sin_jacobi`` against ``cos_sin64`` on |theta| <= pi/2, tiny and
  subnormal angles.

What nvcc decides (registers, spills, the SASS) shows only on the card.
Run from the repository root: ``python3 scripts/host_jacobi.py`` (~2 min).
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import host_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)



# Entry points of the host build for the trigonometry checks.
PROBES = r"""
extern "C" void host_atan2(const double* y, const double* x, double* a, double* b, int n) {
  for (int i = 0; i < n; ++i) {
    a[i] = atan2_jacobi(y[i], x[i]);
    b[i] = cv_trig::atan2_64(y[i], x[i]);
  }
}
extern "C" void host_cos_sin(const double* t, double* c1, double* s1, double* c2, double* s2, int n) {
  for (int i = 0; i < n; ++i) {
    cos_sin_jacobi(t[i], c1[i], s1[i]);
    cv_trig::cos_sin64(t[i], &c2[i], &s2[i]);
  }
}
"""


def same(a, b) -> bool:
    import torch

    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan) and torch.equal(a.view(bits)[~nan], b.view(bits)[~nan]))


def problem(seed: int, h: int, m: int, n: int, dtype, scale: float = 1.0):
    """``h`` x ``m`` relative poses against ``n`` bearing pairs: half the
    pairs inliers of the first pose, the degenerate rows of
    ``tests/test_torch_fused.py``'s scenes; the poses then scaled by
    ``scale`` (1e-155 puts the design's products below the normal range,
    where the reference flushes them)."""
    import numpy as np
    import torch

    from cv_tpu_torch.core import pose as tpose
    from cv_tpu_torch.core.lie import so3_exp

    rng = np.random.default_rng(seed)
    rot = so3_exp(torch.as_tensor(rng.uniform(-0.3, 0.3, (h, m, 1, 3))))
    tr = torch.as_tensor(rng.standard_normal((h, m, 1, 3)))
    a, b = (torch.nn.functional.normalize(torch.as_tensor(rng.standard_normal((n, 3))), dim=-1) for _ in "ab")
    k = n // 2
    pts = a[:k] * torch.as_tensor(rng.uniform(2, 10, (k, 1)))
    b[:k] = torch.nn.functional.normalize(pts @ rot[0, 0, 0].T + tr[0, 0, 0], dim=-1)
    b[2], a[3], b[5, 1], a[6, 0] = a[2], 0.0, float("nan"), float("inf")
    return tpose.Isometry3((rot * scale).to(dtype), (tr * scale).to(dtype)), a.to(dtype), b.to(dtype)


def check_entries(lib) -> bool:
    import torch

    from cv_tpu_torch.core import pose as tpose

    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ok = True
    for dtype, suffix in ((torch.float64, "f64"), (torch.float32, "f32")):
        res = getattr(lib, f"cv_c2c_residual_{suffix}")
        res.argtypes = [p] * 5 + [i64, i64, i32, p]
        score = getattr(lib, f"cv_c2c_score_{suffix}")
        score.argtypes = [p] * 5 + [ctypes.c_double, i64, i64] + [p] * 6
        cases = ((8, 4, 37, 1.0), (4, 4, 300, 1.0), (16, 4, 11, 1.0), (3, 4, 64, 1.0), (5, 3, 129, 1.0),
                 (12, 4, 35, 1e-155 if dtype == torch.float64 else 1e-20))
        if dtype == torch.float64:  # at the bounds of the kernel's flush-free range, and past them
            cases += ((12, 4, 35, 2.0 ** -80), (12, 4, 35, 2.0 ** -86), (12, 4, 35, 1e120), (12, 4, 35, 1e160))
        for seed, (h, m, n, scale) in enumerate(cases):
            pose, a, b = problem(seed, h, m, n, dtype, scale)
            rot, tr = pose.rotation.reshape(-1, 9).contiguous(), pose.translation.reshape(-1, 3).contiguous()
            out = torch.empty(h, m, n, dtype=dtype)
            res(rot.data_ptr(), tr.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), h * m, n, 0, None)
            good = same(out, tpose.c2c_residual_plain(pose, a, b))
            valid = torch.arange(n) < n - n // 5
            valid8 = valid.to(torch.uint8)
            chunks = max(1, -(-n // tpose.score_chunk(n)))
            for thr in (1e-3, 0.5):
                counts, totals = torch.empty(h * m, dtype=torch.int64), torch.empty(h * m, dtype=dtype)
                scratch = (torch.empty(h * m * chunks, dtype=dtype), torch.empty(h * m * chunks, dtype=torch.int64),
                           torch.zeros(h * m, dtype=torch.int32))
                score(rot.data_ptr(), tr.data_ptr(), a.data_ptr(), b.data_ptr(), valid8.data_ptr(), thr, h * m, n,
                      counts.data_ptr(), totals.data_ptr(), *(t.data_ptr() for t in scratch), None)
                pc, pt = tpose.c2c_score_plain(pose, a, b, valid, thr)
                good &= torch.equal(counts, pc.reshape(-1)) and same(totals, pt.reshape(-1))
            print(f"{suffix} {h} x {m} models (scale {scale:g}) against {n} matches: residual and score bitwise "
                  f"{good}", flush=True)
            ok &= good
    return ok


def check_jacobi(lib) -> bool:
    """``cv_jacobi_*`` (N = 3, 4, 9) against ``ops.eigen.eigh_small_plain``
    on random symmetric matrices and ``chip_smoke.symmetric_batch``'s
    structured ones."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from cv_tpu_torch.ops import eigen

    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ok = True
    for dtype, suffix in ((torch.float64, "f64"), (torch.float32, "f32")):
        fn = getattr(lib, f"cv_jacobi_{suffix}")
        fn.argtypes = [p] * 3 + [i64, i32, i32, p]
        for n, sweeps in ((3, 8), (4, 6), (9, 8)):
            a = torch.as_tensor(cs.symmetric_batch(np.random.default_rng(n), 200, n), dtype=dtype)
            w, v = torch.empty(a.shape[:2], dtype=dtype), torch.empty_like(a)
            fn(a.data_ptr(), w.data_ptr(), v.data_ptr(), a.shape[0], n, sweeps, None)
            wp, vp = eigen.eigh_small_plain(a, sweeps)
            good = same(w, wp) and same(v, vp)
            print(f"jacobi {suffix} N={n}, {a.shape[0]} matrices: bitwise {good}", flush=True)
            ok &= good
    return ok


def check_trig(lib) -> bool:
    import numpy as np

    p = ctypes.c_void_p
    rng = np.random.default_rng(0)
    n = 1 << 20
    ex = rng.choice(np.r_[np.arange(515, 531), np.arange(1515, 1531), rng.integers(1, 2046, 64), [0, 2047]], n)
    ey = np.clip(ex + rng.choice(np.r_[np.arange(-60, 61), rng.integers(-300, 300, 32)], n), 0, 2047)

    def draw(e):
        mant = rng.integers(0, 1 << 52, n, dtype=np.uint64)
        mant[::97] = 0
        sign = rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63)
        return (sign | (e.astype(np.uint64) << np.uint64(52)) | mant).view(np.float64).copy()

    x, y = draw(ex), draw(ey)
    y[::1013], x[::1019] = 0.0, -0.0
    a, b = np.empty(n), np.empty(n)
    lib.host_atan2.argtypes = [p] * 4 + [ctypes.c_int]
    lib.host_atan2(y.ctypes.data, x.ctypes.data, a.ctypes.data, b.ctypes.data, n)

    def equal(u, v):
        return bool(((u.view(np.uint64) == v.view(np.uint64)) | (np.isnan(u) & np.isnan(v))).all())

    ok = equal(a, b)
    t = np.r_[rng.uniform(-np.pi / 2, np.pi / 2, n), np.ldexp(rng.uniform(-1, 1, n // 4), rng.integers(-1100, 0, n // 4)),
              [np.nan, 0.0, -0.0, np.pi / 2, -np.pi / 2]]
    c1, s1, c2, s2 = (np.empty(len(t)) for _ in range(4))
    lib.host_cos_sin.argtypes = [p] * 5 + [ctypes.c_int]
    lib.host_cos_sin(t.ctypes.data, c1.ctypes.data, s1.ctypes.data, c2.ctypes.data, s2.ctypes.data, len(t))
    ok_cs = equal(c1, c2) and equal(s1, s2)
    print(f"atan2_jacobi bitwise atan2_64 on {n} edge draws {ok}; cos_sin_jacobi bitwise cos_sin64 on {len(t)} "
          f"angles {ok_cs}", flush=True)
    return ok and ok_cs


def main():
    import torch

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as out:
        lib = host_cuda.build("jacobi", out, PROBES)
        ok = check_entries(lib) & check_jacobi(lib) & check_trig(lib)
    print("host check:", "every hold bitwise" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
