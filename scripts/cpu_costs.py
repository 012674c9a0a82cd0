"""CPU costs behind three choices of the port's plain versions.

* ``ops.eigen``: the exact Jacobi (``eigh_small_plain``) against the unfused
  sweep (``_eigh_unfused``) at N = 3, 4 and 9, per call and per matrix, on
  one thread: why the callers whose matrices are off the reference's bits
  on a CPU pass ``exact=False``.
* ``ops.trig``: a call on one, two or ``SMALL`` elements through the C
  library's functions against the written-out ones: why a small CPU call
  takes the C library.
* PyTorch's CPU ``sqrt`` against the correctly rounded one (NumPy's): the
  share of draws that differ, in float32 and float64, in one call and in
  calls of three (``so3_exp``'s shapes): why ``ops.trig.sqrt`` exists.

Run from the repository root: ``python scripts/cpu_costs.py [--seconds S]``.
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cv_tpu_torch.ops import eigen, trig  # noqa: E402


def per_call_s(fn, seconds):
    fn()
    t0, k = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        fn()
        k += 1
    return (time.perf_counter() - t0) / k


def eigen_costs(seconds):
    rng = np.random.default_rng(0)
    out = []
    for n, sweeps in ((3, 8), (4, 6), (9, 8)):
        for batch in (1, 128, 4096):
            m = rng.standard_normal((batch, n, n))
            a = torch.as_tensor(m + np.swapaxes(m, -1, -2))
            exact = per_call_s(lambda: eigen.eigh_small_plain(a, sweeps), seconds)
            unfused = per_call_s(lambda: eigen._eigh_unfused(a, sweeps), seconds)
            out.append(dict(n=n, sweeps=sweeps, batch=batch, work=a.numel() * sweeps, exact_ms=exact * 1e3,
                            unfused_ms=unfused * 1e3, exact_us_per_matrix=exact / batch * 1e6,
                            unfused_us_per_matrix=unfused / batch * 1e6, ratio=exact / unfused))
    return out


def trig_costs(seconds):
    out = []
    for dtype in (torch.float64, torch.float32):
        cos_sin = trig.cos_sin_f64 if dtype == torch.float64 else trig.cos_sin_plain
        atan2 = trig.atan2_f64 if dtype == torch.float64 else trig.atan2_f32
        for k in (1, 2, trig.SMALL):
            x = torch.linspace(0.1, 3.0, k, dtype=dtype)
            out.append(dict(dtype=str(dtype)[6:], elements=k,
                            cos_sin_library_us=per_call_s(lambda: trig.cos_sin_by_dtype(x), seconds) * 1e6,
                            cos_sin_written_us=per_call_s(lambda: cos_sin(x), seconds) * 1e6,
                            atan2_library_us=per_call_s(lambda: trig.atan2_plain(x, x + 1), seconds) * 1e6,
                            atan2_written_us=per_call_s(lambda: atan2(x, x + 1), seconds) * 1e6))
    return out


def sqrt_shares():
    rng = np.random.default_rng(1)
    out = {}
    for dtype in (np.float64, np.float32):
        x = rng.uniform(0, 10, 1_000_000).astype(dtype)
        want = np.sqrt(x)
        one = torch.sqrt(torch.as_tensor(x)).numpy()
        threes = np.concatenate([torch.sqrt(torch.as_tensor(x[i:i + 3])).numpy() for i in range(0, 30_000, 3)])
        out[np.dtype(dtype).name] = dict(one_call=float((one != want).mean()),
                                         calls_of_three=float((threes != want[:30_000]).mean()),
                                         ops_trig_sqrt=float((trig.sqrt(torch.as_tensor(x)).numpy() != want).mean()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.0, help="time each call for about this long")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    result = dict(machine=platform.machine(), torch=torch.__version__,
                  capability=torch.backends.cpu.get_cpu_capability(), threads=1,
                  eigen=eigen_costs(args.seconds), trig=trig_costs(args.seconds / 2), sqrt_mismatch=sqrt_shares())
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
