// Stage-isolating probes of the describe select: one kernel per TPU probe
// body, each computing that body's output.
//
// Replaces the Pallas probe bodies of two TPU experiments that took the
// one-hot select apart stage by stage:
//
// experiments/exp_bisect.py (grid over K keypoints, 8 a step; each body
// DMAs the keypoint's (3, PH, PW) window of the plane stack at (lvl, y0,
// x0); out (K, 3 * NS)):
//   bisect_dma_only        :75   out[k, :] = sum of the window
//   bisect_matmul_static   :86   out[k, 3 s + r] = sum over 3 copies, 3
//                                channels and PH rows of bf16(win[c, y, s % PW])
//   bisect_matmul_dyn_oh   :110  the same with column rel_x[k, s]
//   bisect_split_nomm      :132  out[k, :] = sum(p1) + sum(p2) + sum(p3), the
//                                bf16x3 split p1 = bf16(p), r = p - p1,
//                                p2 = bf16(r), p3 = bf16(r - p2)
//   bisect_vpu_rowstage    :153  out[k, c NS + s] = win[c, rel_y[k, s], 0]
// experiments/exp_r3_mxu_probe.py (patches (K, C, P, P); out (K, C, NS),
// every channel row the same unless stated):
//   mxu_dots     :50   sum over x of 9 accumulated bf16(patch[k, 0, ry, x]),
//                      ry = rel_y[8 (k / 8), s] (the step's first keypoint)
//   mxu_dotsbig  :67   sum over x of (v + v) + v, v as in mxu_dots
//   mxu_onehot   :87   (rel_x == rel_y) + patch[k, 0, 0, 0]
//   mxu_split    :99   a0 * 0 + a1, ax = the channel sum of p1 + p2 + p3 at
//                      patch[k, :, s, x]; needs NS <= P (the TPU body fails
//                      to trace above, NS = 512 at its own shapes)
//   mxu_dma      :117  patch[k, c, s / P, s % P], NS <= 4 P
//
// On the TPU the one-hot products ran on the matrix unit; here they are
// written out as the select and a sum they compute, with float32 adds
// (no cuBLAS, no tensor cores: a one-hot product has one nonzero term).
// bf16 rounding is __float2bfloat16_rn (round to nearest even, as XLA's
// astype).  Built with --fmad=false.  Sums run in another order than
// XLA's (block trees, sequential loops); chip_smoke.py holds them to their
// plain versions within a stated tolerance and the selects bitwise.
//
// What bounds them: bytes.  The window probes read a 209 KB window per
// keypoint; the patch probes one channel row or a few words.  Design: one
// block per keypoint; threads stride over samples (or the window, for the
// sums, which end in a warp-shuffle and shared-memory tree).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Sum over the block: warp shuffles, then thread 0 adds the warp partials
// in warp order.  Every thread gets the sum.  red holds >= 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
    for (int w = 1; w < (blockDim.x >> 5); ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  const float s = red[32];
  __syncthreads();
  return s;
}

// The keypoint's window origin in the stack, or nullptr when the window
// leaves the stack (the body then writes NaN).
struct Window {
  const float* base;  // planes[lvl, 0, y0, x0]
  size_t plane;       // H * W
  int width;
};

__device__ __forceinline__ Window window(const float* planes, const int* lvl, const int* y0,
                                         const int* x0, int k, int n_levels, int channels,
                                         int height, int width, int ph, int pw) {
  const int l = lvl[k], yb = y0[k], xb = x0[k];
  const size_t plane = static_cast<size_t>(height) * width;
  const bool ok = l >= 0 && l < n_levels && yb >= 0 && yb + ph <= height && xb >= 0 && xb + pw <= width;
  const float* base = ok ? planes + static_cast<size_t>(l) * channels * plane +
                               static_cast<size_t>(yb) * width + xb
                         : nullptr;
  return Window{base, plane, width};
}

__device__ __forceinline__ float at(const Window& w, int c, int y, int x) {
  return w.base[c * w.plane + static_cast<size_t>(y) * w.width + x];
}

#define BISECT_ARGS                                                                             \
  const float *__restrict__ planes, const int *__restrict__ lvl, const int *__restrict__ y0,    \
      const int *__restrict__ x0, const int *__restrict__ rel_y, const int *__restrict__ rel_x, \
      float *__restrict__ out, int n_levels, int channels, int height, int width, int ph, int pw, int ns
#define BISECT_WINDOW \
  window(planes, lvl, y0, x0, blockIdx.x, n_levels, channels, height, width, ph, pw)

__global__ void __launch_bounds__(kThreads) bisect_dma_only_kernel(BISECT_ARGS) {
  __shared__ float red[33];
  const Window w = BISECT_WINDOW;
  const int n = channels * ph * pw;
  float s = 0.0f;
  if (w.base != nullptr) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = i / (ph * pw), r = i % (ph * pw);
      s += at(w, c, r / pw, r % pw);
    }
  }
  s = block_sum(s, red);
  float* o = out + static_cast<size_t>(blockIdx.x) * 3 * ns;
  for (int j = threadIdx.x; j < 3 * ns; j += blockDim.x) o[j] = w.base != nullptr ? s : qnan();
}

template <bool kDynamic>
__device__ __forceinline__ void bisect_matmul(BISECT_ARGS) {
  const Window w = BISECT_WINDOW;
  const int k = blockIdx.x;
  float* o = out + static_cast<size_t>(k) * 3 * ns;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int col = kDynamic ? rel_x[static_cast<size_t>(k) * ns + s] : s % pw;
    float acc = qnan();
    if (w.base != nullptr && col >= 0 && col < pw) {
      acc = 0.0f;
      for (int rep = 0; rep < 3; ++rep)
        for (int c = 0; c < channels; ++c)
          for (int y = 0; y < ph; ++y) acc += bf16r(at(w, c, y, col));
    }
    for (int r = 0; r < 3; ++r) o[3 * s + r] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) bisect_matmul_static_kernel(BISECT_ARGS) {
  bisect_matmul<false>(planes, lvl, y0, x0, rel_y, rel_x, out, n_levels, channels, height, width, ph, pw, ns);
}

__global__ void __launch_bounds__(kThreads) bisect_matmul_dyn_oh_kernel(BISECT_ARGS) {
  bisect_matmul<true>(planes, lvl, y0, x0, rel_y, rel_x, out, n_levels, channels, height, width, ph, pw, ns);
}

__global__ void __launch_bounds__(kThreads) bisect_split_nomm_kernel(BISECT_ARGS) {
  __shared__ float red[33];
  const Window w = BISECT_WINDOW;
  const int n = channels * ph * pw;
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if (w.base != nullptr) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = i / (ph * pw), r = i % (ph * pw);
      const float p = at(w, c, r / pw, r % pw);
      const float p1 = bf16r(p);
      const float r1 = p - p1;
      const float p2 = bf16r(r1);
      const float p3 = bf16r(r1 - p2);
      s1 += p1;
      s2 += p2;
      s3 += p3;
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  s3 = block_sum(s3, red);
  const float s = (s1 + s2) + s3;
  float* o = out + static_cast<size_t>(blockIdx.x) * 3 * ns;
  for (int j = threadIdx.x; j < 3 * ns; j += blockDim.x) o[j] = w.base != nullptr ? s : qnan();
}

__global__ void __launch_bounds__(kThreads) bisect_vpu_rowstage_kernel(BISECT_ARGS) {
  const Window w = BISECT_WINDOW;
  const int k = blockIdx.x;
  float* o = out + static_cast<size_t>(k) * 3 * ns;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int ry = rel_y[static_cast<size_t>(k) * ns + s];
    const bool ok = w.base != nullptr && ry >= 0 && ry < ph;
    for (int c = 0; c < 3; ++c) o[c * ns + s] = ok ? at(w, c, ry, 0) : qnan();
  }
}

#define MXU_ARGS                                                                                  \
  const int *__restrict__ rel_x, const int *__restrict__ rel_y, const float *__restrict__ patches, \
      float *__restrict__ out, int channels, int p, int ns, int g

// patch[k, c, y, x]
__device__ __forceinline__ const float* patch_row(const float* patches, int k, int channels, int p, int c,
                                                  int y) {
  return patches + ((static_cast<size_t>(k) * channels + c) * p + y) * p;
}

__device__ __forceinline__ void mxu_store(float* out, int k, int channels, int ns, int s, float v) {
  for (int c = 0; c < channels; ++c) out[(static_cast<size_t>(k) * channels + c) * ns + s] = v;
}

template <int kRepeats, bool kPairwise>
__device__ __forceinline__ void mxu_row_sum(MXU_ARGS) {
  const int k = blockIdx.x;
  const int first = (k / g) * g;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int ry = rel_y[static_cast<size_t>(first) * ns + s];
    float tot = 0.0f;
    if (ry >= 0 && ry < p) {
      const float* row = patch_row(patches, k, channels, p, 0, ry);
      for (int x = 0; x < p; ++x) {
        const float v = bf16r(row[x]);
        float acc;
        if (kPairwise) {
          acc = (v + v) + v;
        } else {
          acc = 0.0f;
          for (int i = 0; i < kRepeats; ++i) acc += v;
        }
        tot += acc;
      }
    }
    mxu_store(out, k, channels, ns, s, tot);
  }
}

__global__ void __launch_bounds__(kThreads) mxu_dots_kernel(MXU_ARGS) {
  mxu_row_sum<9, false>(rel_x, rel_y, patches, out, channels, p, ns, g);
}

__global__ void __launch_bounds__(kThreads) mxu_dotsbig_kernel(MXU_ARGS) {
  mxu_row_sum<3, true>(rel_x, rel_y, patches, out, channels, p, ns, g);
}

__global__ void __launch_bounds__(kThreads) mxu_onehot_kernel(MXU_ARGS) {
  const int k = blockIdx.x;
  const float p000 = patch_row(patches, k, channels, p, 0, 0)[0];
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int rx = rel_x[static_cast<size_t>(k) * ns + s];
    const int ry = rel_y[static_cast<size_t>(k) * ns + s];
    const float hit = rx == ry ? 1.0f : 0.0f;
    mxu_store(out, k, channels, ns, s, rx >= 0 && rx < p ? hit + p000 : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads) mxu_split_kernel(MXU_ARGS) {
  const int k = blockIdx.x;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    float acc[2] = {0.0f, 0.0f};
    for (int c = 0; c < channels; ++c) {
      const float* row = patch_row(patches, k, channels, p, c, s);
      for (int x = 0; x < 2; ++x) {
        const float v = row[x];
        const float p1 = bf16r(v);
        const float r1 = v - p1;
        const float p2 = bf16r(r1);
        const float p3 = bf16r(r1 - p2);
        acc[x] = acc[x] + ((p1 + p2) + p3);
      }
    }
    mxu_store(out, k, channels, ns, s, acc[0] * 0.0f + acc[1]);
  }
}

__global__ void __launch_bounds__(kThreads) mxu_dma_kernel(MXU_ARGS) {
  const int k = blockIdx.x;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    for (int c = 0; c < channels; ++c) {
      out[(static_cast<size_t>(k) * channels + c) * ns + s] = patch_row(patches, k, channels, p, c, 0)[s];
    }
  }
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
#define BISECT_EXPORT(name)                                                                           \
  extern "C" int cv_##name(const float* planes, const int* lvl, const int* y0, const int* x0,         \
                           const int* rel_y, const int* rel_x, float* out, int n_levels, int channels, \
                           int height, int width, int ph, int pw, int k, int ns, void* stream) {       \
    if (k <= 0 || ns <= 0) return 0;                                                                  \
    name##_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(                             \
        planes, lvl, y0, x0, rel_y, rel_x, out, n_levels, channels, height, width, ph, pw, ns);       \
    return static_cast<int>(cudaGetLastError());                                                      \
  }

BISECT_EXPORT(bisect_dma_only)
BISECT_EXPORT(bisect_matmul_static)
BISECT_EXPORT(bisect_matmul_dyn_oh)
BISECT_EXPORT(bisect_split_nomm)
BISECT_EXPORT(bisect_vpu_rowstage)

#define MXU_EXPORT(name)                                                                          \
  extern "C" int cv_##name(const int* rel_x, const int* rel_y, const float* patches, float* out,  \
                           int channels, int p, int k, int ns, int g, void* stream) {             \
    if (k <= 0 || ns <= 0) return 0;                                                              \
    name##_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(rel_x, rel_y, patches,   \
                                                                         out, channels, p, ns, g); \
    return static_cast<int>(cudaGetLastError());                                                  \
  }

MXU_EXPORT(mxu_dots)
MXU_EXPORT(mxu_dotsbig)
MXU_EXPORT(mxu_onehot)
MXU_EXPORT(mxu_split)
MXU_EXPORT(mxu_dma)
