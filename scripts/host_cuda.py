#!/usr/bin/env python3
"""Build a ``csrc/*.cu`` kernel source for the host CPU with g++, where
there is no ``nvcc``: the host stand-ins of ``scripts/host_jacobi.py`` and
``scripts/host_graph_ba.py``.

A header of stand-ins takes the place of CUDA's (the ``__*_rn``
intrinsics as IEEE operations, ``__ldg`` as a load, ``__shared__`` as a
static, a block's dynamic shared memory as one buffer, ``cp.async``
(``cuda_pipeline.h``'s ``__pipeline_memcpy_async``) as a plain copy, one
``std::thread`` a CUDA thread of a 1-, 2- or 3-D block and a
``std::barrier`` for ``__syncthreads``, the blocks in turn); each ``kernel<<<grid, block,
shared, stream>>>(...)`` launch becomes a call of that emulation.  The
library's C functions then run on host pointers (CPU tensors'
``data_ptr``).  What nvcc decides (registers, spills, the SASS) shows only
on the card.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cv_tpu_torch", "csrc")

STUB = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* g_barrier = nullptr;
inline unsigned char* g_dynamic_shared = nullptr;
inline unsigned char* dynamic_shared() { return g_dynamic_shared; }
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline dim3 to_dim3(const dim3& d) { return d; }
inline dim3 to_dim3(long long n) { return dim3(static_cast<unsigned>(n)); }
inline void emulate(dim3 grid, dim3 block, size_t shared, std::function<void()> body) {
  std::vector<unsigned char> smem(shared + 16);
  const unsigned threads = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(threads);
        g_barrier = &bar;
        g_dynamic_shared = smem.data();
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < threads; ++t)
          ts.emplace_back([&, t, bx, by, bz] {
            threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = block;
            gridDim = grid;
            body();
          });
        for (auto& th : ts) th.join();
      }
}
// cp.async (cuda_pipeline.h) as a plain copy, done by the time it is
// issued: the commit and the wait before the barrier have nothing to do.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<unsigned char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
template <typename T, typename S> inline T bits_of(S v) { T r; std::memcpy(&r, &v, sizeof r); return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline long long __double_as_longlong(double v) { return bits_of<long long>(v); }
inline double __longlong_as_double(long long v) { return bits_of<double>(v); }
inline int __double2hiint(double v) { return static_cast<int>(__double_as_longlong(v) >> 32); }
inline int __double2loint(double v) { return static_cast<int>(__double_as_longlong(v) & 0xffffffff); }
inline unsigned __float_as_uint(float v) { return bits_of<unsigned>(v); }
inline float __uint_as_float(unsigned v) { return bits_of<float>(v); }
inline int __float_as_int(float v) { return bits_of<int>(v); }
inline float __int_as_float(int v) { return bits_of<float>(v); }
inline double __ll2double_rn(long long v) { return static_cast<double>(v); }
inline int __double2int_rz(double v) { return static_cast<int>(v); }
inline float __double2float_rn(double v) { return static_cast<float>(v); }
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() {}
inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }  // blocks run in turn
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
using std::copysign; using std::fabs; using std::isfinite; using std::isnan;
"""


def build(name: str, out: str, extra: str = "") -> ctypes.CDLL:
    """The host library of ``csrc/<name>.cu`` (and its headers), with the
    C++ source ``extra`` appended, built in the directory ``out``."""
    for header in ("trig.cuh", "trig64_tables.cuh"):
        shutil.copy(os.path.join(CSRC, header), out)
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(STUB)
    with open(os.path.join(out, "cuda_pipeline.h"), "w") as f:
        f.write("#pragma once\n")  # its stand-ins are in the stub above
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), ([^,]+), .*?>>>\(([^;]*)\);",
                 lambda m: f"emulate(to_dim3({m.group(2)}), to_dim3({m.group(3)}), {m.group(4)}, [&] {{ "
                           f"{m.group(1)}({m.group(5)}); }});", src, flags=re.S)
    with open(os.path.join(out, f"{name}.cpp"), "w") as f:
        f.write(src + extra)
    lib = os.path.join(out, f"lib{name}.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-I", out,
                    "-include", "cuda_runtime.h", "-o", lib, os.path.join(out, f"{name}.cpp")], check=True)
    return ctypes.CDLL(lib)
