// Describe-stage sample select for the AKAZE orientation and M-LDB passes.
//
//   out[k, c - c0, s] = planes[lvl[k], c, y0[k] + rel_y[k, s], x0[k] + rel_x[k, s]]
//
// planes: (L, C, Hp, Wp) f32, contiguous (the padded (Lt, Lx, Ly) stack);
// lvl, y0, x0: (K,) i32; rel_x, rel_y: (K, NS) i32; out: (K, C - c0, NS) f32.
// A pure select, so the result is bit-exact.  An index outside the stack
// reads nothing and yields NaN.
//
// cv_select_samples_interleaved is the same select from the
// pixel-interleaved stack (L, Hp, C * Wp), lane C * x + c ('+inter' modes):
//
//   out[k, c - c0, s] = stack[lvl[k], y0[k] + rel_y[k, s], C * (x0[k] + rel_x[k, s]) + c]
//
// There a sample's C - c0 channels are adjacent words, one 12-byte span (8
// bytes for the orientation's c0 = 1), so it touches one or two 32-byte
// sectors where the channel-major stack spreads it over C - c0 planes.
//
// Replaces cv_tpu/akaze/pallas_mldb.py::select_samples_gather (kernel
// _select_kernel_gather) composed with the per-keypoint 3x128x128 patch cut
// that feeds it (cv_tpu/akaze/descriptors.py::orient_mldb_onehot).  The TPU
// version cuts the patch first because its gather works only within one
// VMEM tile; here the kernel reads the plane stack directly, so the patch
// buffer (805 MB at 4096 keypoints) is never built.  The interleaved entry
// replaces the same kernel fed by the '+inter' cut (one (128, 384) slice a
// keypoint, de-interleaved; descriptors.py:837-848).
//
// What bounds it: bytes, as scattered 4-byte reads.  Every sample of one
// keypoint lies in its 128x128 window; at the engine's calls the offsets
// are a rotated grid with spacing `scale`, so neighbouring samples share
// sectors, and a keypoint reads a few KB of the stack.  Each sample costs
// two dependent round trips (its offsets, then its values).
//
// Design: the (K, NS) samples are one flat range; a block of kThreads takes
// kThreads * kPer consecutive samples, thread t the samples t, t + kThreads,
// ... of it, so each load and store instruction of a warp covers 32
// consecutive words (offsets in, values out) and a keypoint's samples sit
// in one or a few warps of one block.  A thread issues all its offset loads
// at once, then all its value loads (kPer samples x C - c0 channels, the
// channel count a template constant for 1 to 3), and stores only after the
// last load: kPer * (C - c0) loads in flight a thread.  No shared memory,
// no tensor cores.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 1;  // samples a thread

struct Args {
  const float* planes;
  const int* lvl;
  const int* y0;
  const int* x0;
  const int* rel_x;
  const int* rel_y;
  float* out;
  int n_levels, channels, height, width, ns, c0;
  unsigned total;  // K * NS
};

// kC = C - c0 when it is 1, 2 or 3; 0: read at run time.  kInter: the
// pixel-interleaved layout (a channel's stride one word, a row's C * Wp).
template <int kC, bool kInter>
__global__ void __launch_bounds__(kThreads) select_samples_kernel(Args a) {
  const int nc = kC > 0 ? kC : a.channels - a.c0;
  constexpr int kSlots = kC > 0 ? kC : 1;
  const size_t plane = static_cast<size_t>(a.height) * a.width;
  const size_t cstride = kInter ? 1 : plane;
  const unsigned first = blockIdx.x * static_cast<unsigned>(kThreads * kPer) + threadIdx.x;

  int rx[kPer], ry[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const unsigned e = first + p * kThreads;
    const bool live = e < a.total;
    rx[p] = live ? __ldg(a.rel_x + e) : 0;
    ry[p] = live ? __ldg(a.rel_y + e) : 0;
  }
  const float* src[kPer];
  size_t dst[kPer];
  bool ok[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const unsigned e = first + p * kThreads;
    const unsigned k = e < a.total ? e / a.ns : 0;
    const unsigned s = e - k * a.ns;
    const int l = __ldg(a.lvl + k);
    const int y = __ldg(a.y0 + k) + ry[p];
    const int x = __ldg(a.x0 + k) + rx[p];
    ok[p] = e < a.total && l >= 0 && l < a.n_levels && y >= 0 && y < a.height && x >= 0 && x < a.width;
    if constexpr (kInter) {
      src[p] = a.planes + (ok[p] ? (static_cast<size_t>(l) * a.height + y) * a.channels * a.width +
                                       static_cast<size_t>(x) * a.channels + a.c0
                                 : 0);
    } else {
      src[p] = a.planes + (ok[p] ? (static_cast<size_t>(l) * a.channels + a.c0) * plane +
                                       static_cast<size_t>(y) * a.width + x
                                 : 0);
    }
    dst[p] = static_cast<size_t>(k) * nc * a.ns + s;
  }
  const float nan = __int_as_float(0x7fc00000);
  if constexpr (kC > 0) {
    float v[kPer][kSlots];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int c = 0; c < kSlots; ++c) v[p][c] = ok[p] ? __ldg(src[p] + c * cstride) : nan;
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (first + p * kThreads < a.total) {
#pragma unroll
        for (int c = 0; c < kSlots; ++c) a.out[dst[p] + static_cast<size_t>(c) * a.ns] = v[p][c];
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (first + p * kThreads < a.total) {
        for (int c = 0; c < nc; ++c) {
          a.out[dst[p] + static_cast<size_t>(c) * a.ns] = ok[p] ? __ldg(src[p] + c * cstride) : nan;
        }
      }
    }
  }
}

template <bool kInter>
int launch(const float* planes, const int* lvl, const int* y0, const int* x0, const int* rel_x, const int* rel_y,
           float* out, int n_levels, int channels, int height, int width, int k, int ns, int c0, void* stream) {
  if (k <= 0 || ns <= 0) return 0;
  const unsigned long long total = static_cast<unsigned long long>(k) * ns;
  if (total > 0xffffffffull - kThreads * kPer) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{planes, lvl, y0, x0, rel_x, rel_y, out, n_levels, channels, height, width, ns, c0,
               static_cast<unsigned>(total)};
  const unsigned blocks = static_cast<unsigned>((total + kThreads * kPer - 1) / (kThreads * kPer));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels - c0) {
    case 1: select_samples_kernel<1, kInter><<<blocks, kThreads, 0, s>>>(a); break;
    case 2: select_samples_kernel<2, kInter><<<blocks, kThreads, 0, s>>>(a); break;
    case 3: select_samples_kernel<3, kInter><<<blocks, kThreads, 0, s>>>(a); break;
    default: select_samples_kernel<0, kInter><<<blocks, kThreads, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// planes: (L, C, Hp, Wp).
extern "C" int cv_select_samples(const float* planes, const int* lvl, const int* y0, const int* x0,
                                 const int* rel_x, const int* rel_y, float* out, int n_levels, int channels,
                                 int height, int width, int k, int ns, int c0, void* stream) {
  return launch<false>(planes, lvl, y0, x0, rel_x, rel_y, out, n_levels, channels, height, width, k, ns, c0,
                       stream);
}

// The same from the pixel-interleaved stack (L, Hp, C * Wp); `width` is Wp.
extern "C" int cv_select_samples_interleaved(const float* stack, const int* lvl, const int* y0, const int* x0,
                                             const int* rel_x, const int* rel_y, float* out, int n_levels,
                                             int channels, int height, int width, int k, int ns, int c0,
                                             void* stream) {
  return launch<true>(stack, lvl, y0, x0, rel_x, rel_y, out, n_levels, channels, height, width, k, ns, c0,
                      stream);
}
