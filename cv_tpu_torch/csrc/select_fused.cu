// Single-pass AKAZE describe samples: orientation select, dominant angle,
// M-LDB sample positions and the M-LDB select, one warp per keypoint.
//
// planes: (L, 3, Hp, Wp) f32, the padded (Lt, Lx, Ly) stack; per keypoint
// k: lvl, y0, x0 (the 128x128 window anchor), wlim, hlim (true plane size)
// i32; xf, yf, scale f32; orel_x, orel_y (K, NO) i32 window-relative
// orientation samples.  Tables: wt (NO,) weights, a1, a2 (NW,) window
// bounds, ks, ls (NS,) M-LDB offsets, all f32.  Outputs vals (K, 3, NS) f32
// and meta (K, 4) f32 = [angle, cos, sin, ok].
//
//   1. vo = planes[lvl, 1:3, y0 + orel_y, x0 + orel_x]; res = wt * vo;
//      ang = remainder(atan2(res_y, res_x) + 2pi, 2pi)
//   2. for each window w: sums of res over the samples whose angle lies in
//      (a1[w], a2[w]) (wrapping past 2pi), others counted as 0, added in
//      the plain version's halving tree (descriptors.tree_sum: zero-padded
//      to TW = 128 lanes, then v[i] + v[i + TW/2], ...); val = sx^2 + sy^2
//   3. the first maximal window gives angle = remainder(atan2(sy, sx) +
//      2pi, 2pi), or 0 when no val is above 0; co, si = cos, sin (angle)
//   4. x = xf + (-ls * si + ks * co) * scale, y = yf + (ls * co + ks * si)
//      * scale, rounded half away from zero; ok = every sample inside the
//      plane; clamped to the plane, then to the window
//   5. vals = planes[lvl, 0:3, y0 + rel_y, x0 + rel_x]
//
// Replaces cv_tpu/akaze/pallas_mldb.py::select_samples_fused (kernel
// _select_kernel_fused).  The TPU kernel reads a cut 3x128x128 patch per
// keypoint and could not be built there (Mosaic has no atan2); this one
// reads the plane stack directly, as select_samples.cu does, so no patch
// buffer exists, and the keypoint's angle never leaves its warp.
//
// What bounds it: the 3 x 441 + 2 x 109 scattered 4-byte reads per
// keypoint (in the extractor's keypoint order, so neighbouring warps
// rarely share a window), and 42 x 128 window tests; at the engine's
// 'pfused' call it runs at ~31% of its byte bound (PERF.md).
//
// Design: one warp a keypoint, no shared memory and no block barrier.
// Lane l holds samples l, l + 32, l + 64 and l + 96 (zeros past NO) in
// registers; a window's tree is the lane's ((v[l] + v[l+64]) + (v[l+32] +
// v[l+96])), the first two levels, then a butterfly of shuffles at 16, 8,
// 4, 2, 1, the other five: each lane adds its partner's partial sum, the
// same two operands as the tree's add (in either order, and a float add
// commutes), so every lane ends with the tree's bits and runs the
// first-max scan, atan2f, cosf and sinf itself (a warp issues them once
// whichever lanes take part).  The window test takes its warp-uniform
// half (lo < hi) as a branch, and an angle's wrap into [0, 2pi) skips
// fmodf on its exact fast path.  The M-LDB pass loads kPer samples' three
// channels a lane before it stores them; `ok` is one __any_sync.  Measured
// and not kept (scripts/time_engine_calls.py): 2, 7 and 14 M-LDB samples a
// lane, 2 and 8 keypoints a block, __launch_bounds__ asking 12 or 16
// blocks an SM (both spill), the window loop unrolled by 2, evict-first
// stores.
//
// Build with --fmad=false: the positions must round as the plain version's
// separate multiplies and adds do, or a rounded position moves and a
// descriptor bit flips.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;  // keypoints a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTree = 128;  // tree width: NO (109 in AKAZE) <= kTree
constexpr int kLane = kTree / 32;  // orientation samples a lane
constexpr int kMaxWindows = 48;  // NW bound (42 in AKAZE)
constexpr int kPatch = 128;
constexpr int kPer = 4;  // M-LDB samples a lane loads before it stores
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLane == 4, "a lane's first two tree levels are written out for 4 samples");

// torch.remainder for float (c10::div_mod): fmod with the sign of b.
__device__ __forceinline__ float remainder_f(float a, float b) {
  float mod = fmodf(a, b);
  if (mod == 0.0f) {
    mod = copysignf(0.0f, b);
  } else if ((b < 0.0f) != (mod < 0.0f)) {
    mod += b;
  }
  return mod;
}

// remainder_f(a, b) for b > 0, on the fast path where 0 < a < 2b (every
// angle here: atan2 + 2pi lies in [pi, 3pi]): fmod's exact result is a,
// or a - b, which is exact there (Sterbenz).
__device__ __forceinline__ float wrap(float a, float b) {
  return a > 0.0f && a < 2.0f * b ? (a >= b ? a - b : a) : remainder_f(a, b);
}

// sign(x) * floor(|x| + 0.5) (Rust f32::round), then toward-zero to int.
__device__ __forceinline__ int round_half_away(float x) {
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return static_cast<int>(sgn * floorf(fabsf(x) + 0.5f));
}

__global__ void __launch_bounds__(kThreads) select_fused_kernel(
    const float* __restrict__ planes, const int* __restrict__ lvl,
    const int* __restrict__ y0, const int* __restrict__ x0,
    const int* __restrict__ orel_x, const int* __restrict__ orel_y,
    const float* __restrict__ xf, const float* __restrict__ yf,
    const float* __restrict__ scale, const int* __restrict__ wlim,
    const int* __restrict__ hlim, const float* __restrict__ wt,
    const float* __restrict__ a1, const float* __restrict__ a2,
    const float* __restrict__ ks, const float* __restrict__ ls,
    float* __restrict__ vals, float* __restrict__ meta, int n_kp, int n_levels,
    int height, int width, int no, int nw, int ns, float two_pi) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= n_kp) return;  // the whole warp
  const int l = __ldg(lvl + k);
  const int yb = __ldg(y0 + k);
  const int xb = __ldg(x0 + k);
  const size_t plane = static_cast<size_t>(height) * width;
  const bool level_ok = l >= 0 && l < n_levels;
  const float* base = planes + static_cast<size_t>(level_ok ? l : 0) * 3 * plane;
  const float nan = __int_as_float(0x7fc00000);

  // 1. orientation samples, weighted, and their angles; zeros past NO.
  int off[kLane];
  bool ok[kLane];
#pragma unroll
  for (int i = 0; i < kLane; ++i) {
    const int s = lane + 32 * i;
    const bool in = s < no;
    const int y = yb + (in ? __ldg(orel_y + static_cast<size_t>(k) * no + s) : 0);
    const int x = xb + (in ? __ldg(orel_x + static_cast<size_t>(k) * no + s) : 0);
    ok[i] = in && level_ok && y >= 0 && y < height && x >= 0 && x < width;
    off[i] = ok[i] ? y * width + x : 0;
  }
  float rx[kLane], ry[kLane], ang[kLane];
#pragma unroll
  for (int i = 0; i < kLane; ++i) {
    const int s = lane + 32 * i;
    const float vx = ok[i] ? __ldg(base + plane + off[i]) : nan;
    const float vy = ok[i] ? __ldg(base + 2 * plane + off[i]) : nan;
    const float w = s < no ? __ldg(wt + s) : 0.0f;
    rx[i] = s < no ? w * vx : 0.0f;
    ry[i] = s < no ? w * vy : 0.0f;
    ang[i] = s < no ? wrap(atan2f(ry[i], rx[i]) + two_pi, two_pi) : 0.0f;
  }

  // 2-3. each window's tree sums, the first maximal window.
  float top = 0.0f, best_x = 0.0f, best_y = 0.0f;
  for (int w = 0; w < nw; ++w) {
    const float lo = __ldg(a1 + w);
    const float hi = __ldg(a2 + w);
    float px[kLane], py[kLane];
    // (lo < hi && lo < a && a < hi) || (hi < lo && ((a > 0 && a < hi) ||
    // (a > lo && a < 2pi))), with the warp-uniform test taken first.
    if (lo < hi) {
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        const bool in = lo < ang[i] && ang[i] < hi;
        px[i] = in ? rx[i] : 0.0f;
        py[i] = in ? ry[i] : 0.0f;
      }
    } else {
      const bool wraps = hi < lo;
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        const float a = ang[i];
        const bool in = wraps && ((a > 0.0f && a < hi) || (a > lo && a < two_pi));
        px[i] = in ? rx[i] : 0.0f;
        py[i] = in ? ry[i] : 0.0f;
      }
    }
    float sx = (px[0] + px[2]) + (px[1] + px[3]);
    float sy = (py[0] + py[2]) + (py[1] + py[3]);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      sx = sx + __shfl_xor_sync(kFull, sx, d);
      sy = sy + __shfl_xor_sync(kFull, sy, d);
    }
    const float val = sx * sx + sy * sy;
    if (w == 0 || val > top) {
      top = val;
      best_x = sx;
      best_y = sy;
    }
  }
  float angle = wrap(atan2f(best_y, best_x) + two_pi, two_pi);
  if (!(top > 0.0f)) angle = 0.0f;
  const float co = cosf(angle);
  const float si = sinf(angle);
  const float xc = __ldg(xf + k);
  const float yc = __ldg(yf + k);
  const float sc = __ldg(scale + k);
  const int w_hi = __ldg(wlim + k) - 1;
  const int h_hi = __ldg(hlim + k) - 1;

  // 4-5. M-LDB positions, the bounds flag, and the select.
  bool oob = false;
  float* o = vals + static_cast<size_t>(k) * 3 * ns;
  for (int s0 = lane; s0 < ns; s0 += 32 * kPer) {
    int moff[kPer];
    bool mok[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = s0 + 32 * i;
      const bool in = s < ns;
      const float kk = in ? __ldg(ks + s) : 0.0f;
      const float ll = in ? __ldg(ls + s) : 0.0f;
      const float sy = yc + (ll * co + kk * si) * sc;
      const float sx = xc + (-ll * si + kk * co) * sc;
      int x1 = round_half_away(sx);
      int y1 = round_half_away(sy);
      oob |= in && (x1 < 0 || x1 > w_hi || y1 < 0 || y1 > h_hi);
      x1 = min(max(x1, 0), w_hi);
      y1 = min(max(y1, 0), h_hi);
      const int y = yb + min(max(y1 - yb, 0), kPatch - 1);
      const int x = xb + min(max(x1 - xb, 0), kPatch - 1);
      mok[i] = in && level_ok && y >= 0 && y < height && x >= 0 && x < width;
      moff[i] = mok[i] ? y * width + x : 0;
    }
    float v[kPer][3];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[i][c] = mok[i] ? __ldg(base + c * plane + moff[i]) : nan;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = s0 + 32 * i;
      if (s < ns) {
#pragma unroll
        for (int c = 0; c < 3; ++c) o[static_cast<size_t>(c) * ns + s] = v[i][c];
      }
    }
  }
  const bool any_oob = __any_sync(kFull, oob);
  if (lane == 0) {
    reinterpret_cast<float4*>(meta)[k] = make_float4(angle, co, si, any_oob ? 0.0f : 1.0f);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue when NO or NW exceed the kernel's tables.
extern "C" int cv_select_fused(
    const float* planes, const int* lvl, const int* y0, const int* x0,
    const int* orel_x, const int* orel_y, const float* xf, const float* yf,
    const float* scale, const int* wlim, const int* hlim, const float* wt,
    const float* a1, const float* a2, const float* ks, const float* ls,
    float* vals, float* meta, int n_levels, int height, int width, int k,
    int no, int nw, int ns, float two_pi, void* stream) {
  if (no < 1 || no > kTree || nw < 1 || nw > kMaxWindows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0) return 0;
  select_fused_kernel<<<(k + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, lvl, y0, x0, orel_x, orel_y, xf, yf, scale, wlim, hlim, wt, a1,
      a2, ks, ls, vals, meta, k, n_levels, height, width, no, nw, ns, two_pi);
  return static_cast<int>(cudaGetLastError());
}
