#!/usr/bin/env python3
"""Build ``csrc/graph_ba.cu`` for the host CPU with g++ and hold it bitwise
to ``sfm.device_refine.graph_ba_core_plain``, where there is no ``nvcc``.

The kernel is built through the host stand-ins of ``scripts/host_cuda.py``
(one ``std::thread`` a CUDA thread, a ``std::barrier`` for
``__syncthreads``, the block's dynamic shared memory one buffer) and its C
entries run on CPU tensors.  Each problem runs through ``cv_graph_ba_f64``
or ``cv_graph_ba_f32`` and through the plain loop on the CPU; the poses
must agree bit for bit and the removed masks exactly.  The problems, in
float64 and float32:

* non-finite edges: an infinite translation and a NaN rotation on valid
  edges (their views removed in the first round and kept so);
* signed zeros: identity poses with -0.0 entries, edges that agree with
  them exactly (logs of exact zeros);
* near-pi edges (so3_log's diagonal branch) and Taylor-branch rates;
* the in-degree limits: an edgeless view, views with one incoming edge, a
  hub that every valid edge points at, and invalid padding edges;
* the largest E: edges that fill shared memory beside the views (the
  staged form) and more than fit (read from global memory each round).

What nvcc decides (registers, spills, the SASS) shows only on the card.
Run from the repository root: ``python3 scripts/host_graph_ba.py`` (~10 s).
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile
import time

import host_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Shared bytes an edge takes when staged (graph_ba.cu's edge_bytes): 18
# values and 3 ints; the kernel stages the edges while views and edges fit
# in 227 KB.
SHARED = 227 * 1024


def _rot(rng, n, scale):
    import torch

    from cv_tpu_torch.core import lie

    return lie.so3_exp(torch.as_tensor(rng.normal(size=(n, 3)) * scale)).numpy()


def problem(seed, v, e, kind=""):
    """A noisy pose graph over ``v`` views and ``e`` edges (the last view
    edgeless, 15% of the edges invalid), with ``kind``: ``nonfinite``,
    ``zeros``, ``near_pi``, ``hub`` or ``single`` (each live view gets at
    most one valid incoming edge)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rot, trans = _rot(rng, v, 0.5), rng.normal(size=(v, 3))
    live = v - 1
    to = rng.integers(0, live, e)
    if kind == "hub":
        to[:] = 0
    frm = (to + rng.integers(1, live, e)) % live
    valid = rng.uniform(size=e) < 0.85
    if kind == "single":
        to = np.arange(e) % live
        frm = (to + 1) % live
        valid = np.arange(e) < live
    r_rel = rot[to] @ np.swapaxes(rot[frm], -1, -2)
    edge_rot = _rot(rng, e, 0.01) @ r_rel
    edge_t = trans[to] - np.einsum("eij,ej->ei", r_rel, trans[frm]) + rng.normal(size=(e, 3)) * 0.01
    rot, trans = _rot(rng, v, 0.02) @ rot, trans + rng.normal(size=(v, 3)) * 0.02
    if kind == "nonfinite":
        k = np.flatnonzero(valid)
        edge_t[k[0], 2] = np.inf
        edge_rot[k[3], 1, 1] = np.nan
    if kind == "zeros":
        rot[:], trans[:] = np.eye(3), -0.0
        trans[::2, 1] = 0.0
        edge_rot[:], edge_t[:] = np.eye(3), -0.0
        edge_t[1::3, 0] = 0.0
    if kind == "near_pi":  # r_d a half turn to rounding in the first round
        axis = rng.normal(size=(e, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        flip = 2 * axis[:, :, None] * axis[:, None, :] - np.eye(3)
        now = rot[to] @ np.swapaxes(rot[frm], -1, -2)
        edge_rot[::4] = flip[::4] @ now[::4]
    return rot, trans, to.astype(np.int64), frm.astype(np.int64), edge_rot, edge_t, valid


def run_kernel(lib, arrays, rounds, rate):
    import torch

    rot, trans, to, frm, erot, et, valid = arrays
    v, e = rot.shape[0], to.shape[0]
    out_rot, out_trans = torch.empty_like(rot), torch.empty_like(trans)
    removed = torch.empty(v, dtype=torch.bool)
    logs = torch.empty(max(6 * e, 1), dtype=rot.dtype)
    ints = torch.empty(max(3 * e, 1), dtype=torch.int32)
    suffix = "f32" if rot.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"cv_graph_ba_{suffix}")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i32, i32, i32, ctypes.c_double] + [p] * 6
    err = fn(*(t.data_ptr() for t in (rot, trans, to, frm, erot, et, valid)), v, e, rounds, rate,
             out_rot.data_ptr(), out_trans.data_ptr(), removed.data_ptr(), logs.data_ptr(), ints.data_ptr(), None)
    assert err == 0, err
    return out_rot, out_trans, removed


def same(a, b) -> bool:
    import torch

    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return bool(torch.equal(a.view(bits), b.view(bits)))


def main():
    import numpy as np
    import torch

    from cv_tpu_torch.sfm import device_refine

    torch.set_num_threads(4)
    per_edge = {torch.float64: 18 * 8 + 12, torch.float32: 18 * 4 + 12}
    ok = True
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        lib = host_cuda.build("graph_ba", out)
        print(f"built graph_ba.cu for the host in {time.perf_counter() - t0:.1f} s", flush=True)
        for dtype in (torch.float64, torch.float32):
            fill = (SHARED - 4096) // per_edge[dtype]  # the staged form's largest E beside 16 views
            cases = [
                ("non-finite edges", 0, 8, 40, "nonfinite", 24, 0.01),
                ("signed zeros", 1, 8, 40, "zeros", 16, 0.01),
                ("near-pi edges", 2, 8, 48, "near_pi", 16, 0.01),
                ("Taylor rate", 3, 8, 40, "", 24, 1e-5),
                ("one incoming edge a view", 4, 8, 12, "single", 24, 0.05),
                ("a hub takes every edge", 5, 8, 64, "hub", 16, 0.01),
                (f"staged, E = {fill}", 6, 16, fill, "", 4, 0.001),
                ("from global memory, E = 3000", 7, 16, 3000, "nonfinite", 4, 0.001),
            ]
            for name, seed, v, e, kind, rounds, rate in cases:
                arrays = [torch.as_tensor(a) for a in problem(seed, v, e, kind)]
                arrays = [a.to(dtype) if a.is_floating_point() else a for a in arrays]
                t0 = time.perf_counter()
                got = run_kernel(lib, arrays, rounds, rate)
                t1 = time.perf_counter()
                want = device_refine.graph_ba_core_plain(*arrays, iterations=rounds, rate=rate)
                t2 = time.perf_counter()
                good = all(same(g, w) for g, w in zip(got, want))
                removed = int(want[2].sum())
                print(f"{str(dtype)[6:]} {name} (V {v}, E {e}, {rounds} rounds, rate {rate:g}; {removed} removed): "
                      f"bitwise {good} (kernel {t1 - t0:.2f} s, plain {t2 - t1:.2f} s)", flush=True)
                if not good:
                    for g, w in zip(got, want):
                        if g.is_floating_point():
                            print("   max |diff|", float(np.nanmax(np.abs((g - w).numpy()))))
                ok &= good
    print("host check:", "every hold bitwise" if ok else "FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
