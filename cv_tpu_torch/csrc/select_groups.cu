// Describe-stage sample select over window-sorted keypoint groups.
//
//   out[t * G + j, c - c0, s] =
//       planes[win_lvl[t], c, 128 * win_ty[t] + rel_y[t * G + j, s],
//                             128 * win_tx[t] + rel_x[t * G + j, s]]
//   for j < n_active[t], and 0 for the group's other slots.
//
// planes: (L, C, Hp, Wp) f32 contiguous; win_lvl, win_ty, win_tx, n_active:
// (NG,) i32; rel_x, rel_y: (NG * G, NS) i32 in [0, 256); out: (NG * G,
// C - c0, NS) f32 with C - c0 <= 3.  A pure select, so the result is
// bit-exact; an index outside the stack reads nothing and yields NaN.
//
// Replaces cv_tpu/akaze/pallas_mldb.py::select_samples_groups (kernel
// _select_kernel_groups).  On the TPU each grid step DMAs the group's
// 256x256 window as four 128x128 quadrant blocks into VMEM, and
// window-sorted groups let consecutive steps skip repeated DMAs; `w`
// groups share a step.  Here `w` only sets the table layout (t is the
// table position whatever `w` is): one block per group.
//
// What bounds it: bytes.  The output of every slot, live or not (more than
// half the rows are zeros at the engine's calls), and for the live slots
// the offsets and the plane sectors their samples touch; at the engine's
// calls it runs at ~52% of the bound that counts 4 bytes a sample and ~59%
// of the one that counts 32 bytes a distinct sector (PERF.md).  Each sample
// costs two dependent round trips (its offsets, then its values).
//
// Design: one warp a slot, no division.  A lane loads the offsets of kPer
// samples, then all their plane values, then stores them: at kPer = 16 a
// slot's 441 M-LDB samples are one round, 16 * (2 + C - c0) loads in
// flight a lane.  The output pointer is not __restrict__ and the reads are
// plain coherent loads, so neither the compiler nor ptxas may move a load
// past a store: with read-only (non-coherent) loads ptxas sank them
// between the stores at 32 registers and a lane waited for one sample at a
// time.  The warps of dead slots, and of a group with no live slot, read
// nothing and zero their rows with 16-byte stores.  Measured and not kept
// (scripts/time_engine_calls.py): 2, 4, 8 and 14 samples a lane, two or
// four warps a slot, blocks alternating between the table's two ends,
// evict-first hints.  A shared-memory window (768 KB over three channels)
// does not fit in a block, and a slot's own footprint does not fit either
// at the engine's calls (median 6,160 floats a channel in the M-LDB
// pass).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kGroup = 8;  // slots per group (pallas_mldb.G), one warp each
constexpr int kThreads = 32 * kGroup;
constexpr int kPer = 16;  // samples a lane loads before it stores

// Zero out[lo, hi) with `n` threads, this one numbered `t`: single floats
// up to the first 16-byte boundary and after the last, float4 between
// (`out` itself is 16-byte aligned).
__device__ __forceinline__ void zero_range(float* out, size_t lo, size_t hi, int t, int n) {
  const size_t a = min(hi, (lo + 3) & ~static_cast<size_t>(3));
  const size_t b = max(a, hi & ~static_cast<size_t>(3));
  for (size_t i = lo + t; i < a; i += n) out[i] = 0.0f;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (size_t i = a / 4 + t; i < b / 4; i += n) out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = b + t; i < hi; i += n) out[i] = 0.0f;
}

template <int NC>
__global__ void __launch_bounds__(kThreads) select_groups_kernel(
    const float* planes, const int* __restrict__ win_lvl,
    const int* __restrict__ win_ty, const int* __restrict__ win_tx,
    const int* __restrict__ n_active, const int* rel_x, const int* rel_y, float* out, int n_levels,
    int channels, int height, int width, int ns, int c0) {
  const int t = blockIdx.x;
  const int j = threadIdx.x >> 5;  // the warp's slot
  const int lane = threadIdx.x & 31;
  const int live = max(__ldg(n_active + t), 0);
  const size_t row = static_cast<size_t>(NC) * ns;  // floats a slot
  if (j >= live) {
    // Slots live..G-1 are one range of the group's rows: their warps
    // zero it together.
    const size_t first = static_cast<size_t>(t) * kGroup + live;
    zero_range(out, first * row, (static_cast<size_t>(t) + 1) * kGroup * row, threadIdx.x - 32 * live,
               kThreads - 32 * live);
    return;
  }
  const int l = __ldg(win_lvl + t);
  const int yb = 128 * __ldg(win_ty + t);
  const int xb = 128 * __ldg(win_tx + t);
  const bool level_ok = l >= 0 && l < n_levels;
  const size_t plane = static_cast<size_t>(height) * width;
  const float* base = planes + (static_cast<size_t>(level_ok ? l : 0) * channels + c0) * plane;
  const size_t slot = static_cast<size_t>(t) * kGroup + j;
  const int* ry = rel_y + slot * ns;
  const int* rx = rel_x + slot * ns;
  float* o = out + slot * row;
  const float nan = __int_as_float(0x7fc00000);
  for (int s0 = lane; s0 < ns; s0 += 32 * kPer) {
    int off[kPer];
    bool ok[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = s0 + 32 * i;
      const bool in = s < ns;
      const int y = yb + (in ? ry[s] : 0);
      const int x = xb + (in ? rx[s] : 0);
      ok[i] = in && level_ok && y >= 0 && y < height && x >= 0 && x < width;
      off[i] = ok[i] ? y * width + x : 0;
    }
    float v[kPer][NC];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) v[i][c] = ok[i] ? base[c * plane + off[i]] : nan;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = s0 + 32 * i;
      if (s < ns) {
#pragma unroll
        for (int c = 0; c < NC; ++c) o[static_cast<size_t>(c) * ns + s] = v[i][c];
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue when C - c0 is not 1, 2 or 3.
extern "C" int cv_select_groups(const float* planes, const int* win_lvl,
                                const int* win_ty, const int* win_tx,
                                const int* n_active, const int* rel_x,
                                const int* rel_y, float* out, int n_levels,
                                int channels, int height, int width,
                                int n_groups, int ns, int c0, void* stream) {
  const int nc = channels - c0;
  if (nc < 1 || nc > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0 || ns <= 0) return 0;
  const auto kernel = nc == 1 ? select_groups_kernel<1> : nc == 2 ? select_groups_kernel<2> : select_groups_kernel<3>;
  kernel<<<n_groups, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y, out, n_levels, channels, height, width, ns, c0);
  return static_cast<int>(cudaGetLastError());
}
