// Single-pass AKAZE describe samples: orientation select, dominant angle,
// M-LDB sample positions and the M-LDB select, one block per keypoint.
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
// buffer exists, and the keypoint's angle never leaves the block.
//
// What bounds it: the 3 x 441 + 2 x 109 scattered 4-byte reads per
// keypoint, and 42 x 128 window tests.  Design: the samples, their angles
// and the (42, 128) masked window rows (43 KB of dynamic shared memory)
// stay on chip; threads stride over samples, then over (window, lane)
// pairs for each tree level, then over M-LDB offsets; one barrier-or gives
// `ok`.
//
// Build with --fmad=false: the positions must round as the plain version's
// separate multiplies and adds do, or a rounded position moves and a
// descriptor bit flips.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTree = 128;        // tree width: NO (109 in AKAZE) <= kTree
constexpr int kMaxWindows = 48;   // NW bound (42 in AKAZE)
constexpr int kPatch = 128;

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
    float* __restrict__ vals, float* __restrict__ meta, int n_levels,
    int height, int width, int no, int nw, int ns, float two_pi) {
  __shared__ float s_rx[kTree];
  __shared__ float s_ry[kTree];
  __shared__ float s_ang[kTree];
  __shared__ float s_val[kMaxWindows];
  __shared__ float s_trig[3];  // angle, cos, sin
  extern __shared__ float s_rows[];  // (2, nw, kTree): masked rows, then sums
  float* row_x = s_rows;
  float* row_y = s_rows + nw * kTree;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int l = __ldg(lvl + k);
  const int yb = __ldg(y0 + k);
  const int xb = __ldg(x0 + k);
  const size_t plane = static_cast<size_t>(height) * width;
  const bool level_ok = l >= 0 && l < n_levels;
  const float* base = planes + static_cast<size_t>(level_ok ? l : 0) * 3 * plane;
  const float nan = __int_as_float(0x7fc00000);

  // 1. orientation samples, weighted, and their angles.
  for (int s = tid; s < no; s += kThreads) {
    const int y = yb + __ldg(orel_y + static_cast<size_t>(k) * no + s);
    const int x = xb + __ldg(orel_x + static_cast<size_t>(k) * no + s);
    const bool ok = level_ok && y >= 0 && y < height && x >= 0 && x < width;
    const size_t off = static_cast<size_t>(y) * width + x;
    const float vx = ok ? __ldg(base + plane + off) : nan;
    const float vy = ok ? __ldg(base + 2 * plane + off) : nan;
    const float w = __ldg(wt + s);
    const float rx = w * vx;
    const float ry = w * vy;
    s_rx[s] = rx;
    s_ry[s] = ry;
    s_ang[s] = remainder_f(atan2f(ry, rx) + two_pi, two_pi);
  }
  __syncthreads();

  // 2. masked window rows, then their halving-tree sums.
  for (int idx = tid; idx < nw * kTree; idx += kThreads) {
    const int w = idx / kTree;
    const int s = idx - w * kTree;
    bool in = false;
    if (s < no) {
      const float lo = __ldg(a1 + w);
      const float hi = __ldg(a2 + w);
      const float ang = s_ang[s];
      in = (lo < hi && lo < ang && ang < hi) ||
           (hi < lo && ((ang > 0.0f && ang < hi) || (ang > lo && ang < two_pi)));
    }
    row_x[idx] = in ? s_rx[s] : 0.0f;
    row_y[idx] = in ? s_ry[s] : 0.0f;
  }
  __syncthreads();
  for (int half = kTree / 2; half >= 1; half >>= 1) {
    for (int idx = tid; idx < nw * half; idx += kThreads) {
      const int w = idx / half;
      const int i = w * kTree + idx - w * half;
      row_x[i] = row_x[i] + row_x[i + half];
      row_y[i] = row_y[i] + row_y[i + half];
    }
    __syncthreads();
  }
  for (int w = tid; w < nw; w += kThreads) {
    const float sx = row_x[w * kTree];
    const float sy = row_y[w * kTree];
    s_val[w] = sx * sx + sy * sy;
  }
  __syncthreads();

  // 3. the first maximal window, its angle, cos and sin.
  if (tid == 0) {
    int best = 0;
    float top = s_val[0];
    for (int w = 1; w < nw; ++w) {
      if (s_val[w] > top) {
        top = s_val[w];
        best = w;
      }
    }
    float angle = remainder_f(atan2f(row_y[best * kTree], row_x[best * kTree]) + two_pi, two_pi);
    if (!(top > 0.0f)) angle = 0.0f;
    s_trig[0] = angle;
    s_trig[1] = cosf(angle);
    s_trig[2] = sinf(angle);
  }
  __syncthreads();
  const float co = s_trig[1];
  const float si = s_trig[2];
  const float xc = __ldg(xf + k);
  const float yc = __ldg(yf + k);
  const float sc = __ldg(scale + k);
  const int w_hi = __ldg(wlim + k) - 1;
  const int h_hi = __ldg(hlim + k) - 1;

  // 4-5. M-LDB positions, the bounds flag, and the select.
  int oob = 0;
  float* o = vals + static_cast<size_t>(k) * 3 * ns;
  for (int s = tid; s < ns; s += kThreads) {
    const float kk = __ldg(ks + s);
    const float ll = __ldg(ls + s);
    const float sy = yc + (ll * co + kk * si) * sc;
    const float sx = xc + (-ll * si + kk * co) * sc;
    int x1 = round_half_away(sx);
    int y1 = round_half_away(sy);
    oob |= x1 < 0 || x1 > w_hi || y1 < 0 || y1 > h_hi;
    x1 = min(max(x1, 0), w_hi);
    y1 = min(max(y1, 0), h_hi);
    const int y = yb + min(max(y1 - yb, 0), kPatch - 1);
    const int x = xb + min(max(x1 - xb, 0), kPatch - 1);
    const bool ok = level_ok && y >= 0 && y < height && x >= 0 && x < width;
    const size_t off = static_cast<size_t>(y) * width + x;
    for (int c = 0; c < 3; ++c) {
      o[static_cast<size_t>(c) * ns + s] = ok ? __ldg(base + c * plane + off) : nan;
    }
  }
  const int any_oob = __syncthreads_or(oob);
  if (tid == 0) {
    float* m = meta + static_cast<size_t>(k) * 4;
    m[0] = s_trig[0];
    m[1] = co;
    m[2] = si;
    m[3] = any_oob ? 0.0f : 1.0f;
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
  const size_t rows = 2 * static_cast<size_t>(nw) * kTree * sizeof(float);  // 43 KB at nw = 42
  select_fused_kernel<<<k, kThreads, rows, static_cast<cudaStream_t>(stream)>>>(
      planes, lvl, y0, x0, orel_x, orel_y, xf, yf, scale, wlim, hlim, wt, a1,
      a2, ks, ls, vals, meta, n_levels, height, width, no, nw, ns, two_pi);
  return static_cast<int>(cudaGetLastError());
}
