// The AKAZE nonlinear scale space, cv_tpu/akaze/scale_space.py::build_scale_space
// (XLA code under the extractors' jit; cv_tpu's Pallas stencils of it
// measured 60x slower on the TPU and were deleted, so it replaces no Pallas
// kernel), as four entries, each over a batch of frames:
//
//   cv_sep_filter      vertical_filter(horizontal_filter(x, h), v) for one or
//                      two tap pairs of one input (the base blur; the
//                      contrast factor's blur and its Scharr x and y);
//   cv_evolution_flow  lsmooth = gaussian_blur(lt, 1), lx and ly = the
//                      Scharr pair of lsmooth at scale 1, flow = pm_g2(lx,
//                      ly, k): writes lsmooth and flow;
//   cv_fed_cycle       n explicit FED steps of lt under one flow (an
//                      evolution's whole cycle), k steps a launch;
//   cv_detector        lx, ly = the Scharr pair of lsmooth at scale s, then
//                      lxx, lyy, lxy and ldet = (lxx lyy - lxy lxy) s^4:
//                      writes lx, ly and ldet.
//
// Each is the port's plain tensor chain (cv_tpu_torch/ops/image.py) bit for
// bit: the same float32 products, sums and IEEE divisions in the same
// order, built with --fmad=false so that nothing is contracted (the FED
// cycle and the detector also spell theirs with __fmul_rn / __fadd_rn).
// A 1-D filter is _conv1d's tap chain: the first nonzero tap's product
// starts the sum, later nonzero taps are added left to right, zero taps
// are skipped (so they decide the sign of a zero, as there), edges clamp.
// Every intermediate plane is rounded to float32 where the chain stores
// it.  The FED step adds F.pad's +0 at the right and bottom borders (-0 +
// 0 is +0) and subtracts it at the left and top.  pm_g2's 1 / (k k) and
// 1 / (1 + ...) are IEEE divisions, as torch's reciprocal is.
//
// Design of the blur and the flow: a block computes a 32x16 tile of one
// frame, 256 threads.  It stages the input tile with its halo in shared
// memory, then runs each pass of the chain from one shared buffer into the
// next, each buffer covering the halo that the passes after it still need,
// and writes only the outputs.  An entry of a buffer at a position outside
// the frame holds the value at the clamped position, which is what the
// plain chain's index clamp reads there.  The halo is 4 for the blur (9
// taps), 3 for the flow (blur 2, Scharr 1).
//
// The FED cycle (temporal blocking): a block stages its tile of lt and of
// the conductivity once, with a halo of k (cp.async, +0 outside the frame,
// which no step reads: the border flows are F.pad's zeros), runs the k
// steps ping-pong in shared memory with one barrier a step, the valid
// region shrinking by one a step, and writes only the last step's
// interior.  A thread walks a column of the region, the rows above and
// below in registers.  Tiles are 32 rows by max(32, 66 - 2k) columns, so
// the first step's region is 64 columns wide (two full warps a row) up to
// k = 17.  n steps take ceil(n / k) launches of balanced lengths,
// ping-pong through a scratch plane in device memory.
//
// The detector: a 32-row tile of 64 - 2s columns (so that its Scharr
// buffers are 64 wide), s a template parameter.  The stage covers a halo of
// 2s (cp.async of the frame's part, then, on a tile at the frame's edge,
// the clamped entries replicated in shared memory); pass 1 writes the
// horizontal Scharr passes of lsmooth, pass 2 lx (over the stage's space)
// and ly, and a last pass forms lxx, lxy and lyy from lx's and ly's nine
// and six neighbours at +-s in registers.  Each 1-D pass is its 2 or 3
// nonzero taps (main: -1 at -s, +1 at +s; off: n at -s, n w at 0, n at +s),
// summed in tap order.
//
// What bounds them: bytes for the blur, the flow and a FED cycle (8-16 bytes
// a pixel, each plane read once and each output written once); the
// detector's ~120 issued instructions a pixel sit near its 16 bytes at the
// card's issue rate.  The staged halos reread from L2 and the passes'
// recomputation over them are the price of one launch an entry.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The block's dynamic shared memory.
#ifdef __CUDACC__
static __device__ __forceinline__ unsigned char* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}
#else
unsigned char* dynamic_shared();  // the host build's stand-in
#endif

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 33;  // a Scharr pair up to scale 16, a blur up to sigma 8
constexpr int kDefaultShared = 48 * 1024;
constexpr int kMaxShared = 227 * 1024;  // an H100 block's dynamic shared memory

struct Taps {
  int n;
  float t[kMaxTaps];
};

// A block's tile of one frame: output rows [y0, y0 + kTileH) and columns
// [x0, x0 + kTileW) of an h x w plane.
struct Tile {
  int h, w, y0, x0;
};

// A buffer in shared memory over the tile's local rows [-hy, kTileH + hy)
// and columns [-hx, kTileW + hx).  Its entry at local (r, c) holds its
// plane's value at (clamp(y0 + r), clamp(x0 + c)).
struct Buf {
  float* p;
  int hy, hx;
  __device__ int cols() const { return kTileW + 2 * hx; }
  __device__ int size() const { return (kTileH + 2 * hy) * cols(); }
  __device__ float* end() const { return p + size(); }
  // The entry at local (r, c).
  __device__ const float* at(int r, int c) const { return p + (r + hy) * cols() + c + hx; }
};

__host__ __device__ constexpr int buf_floats(int hy, int hx) { return (kTileH + 2 * hy) * (kTileW + 2 * hx); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// _conv1d's tap chain at one position: v[k * step] is the input under tap
// k.  +0 where every tap is zero (the plain version's zeros_like).
__device__ __forceinline__ float chain(const float* v, int step, const Taps& t) {
  float acc = 0.0f;
  bool any = false;
  for (int k = 0; k < t.n; ++k) {
    const float tap = t.t[k];
    if (tap == 0.0f) continue;
    const float term = v[k * step] * tap;
    acc = any ? acc + term : term;
    any = true;
  }
  return acc;
}

// The tile of block blockIdx.x (frame-major, then tile rows, then tile
// columns); its frame in *frame.
__device__ Tile tile_of(int h, int w, int* frame) {
  const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + kTileH - 1) / kTileH;
  int b = static_cast<int>(blockIdx.x);
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y;
  *frame = b / tiles_y;
  return Tile{h, w, ty * kTileH, tx * kTileW};
}

// dst = the plane at dst's positions, clamped into the frame.
__device__ void load(const float* plane, const Buf& dst, const Tile& tile) {
  const int cols = dst.cols(), n = dst.size();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = clampi(tile.y0 + i / cols - dst.hy, 0, tile.h - 1);
    const int x = clampi(tile.x0 + i % cols - dst.hx, 0, tile.w - 1);
    dst.p[i] = plane[static_cast<size_t>(y) * tile.w + x];
  }
}

// dst = the 1-D filter of src's plane along x (along_x) or y, at dst's
// positions.  src must cover dst and the taps' half-width along the pass.
__device__ void pass(const Buf& src, const Buf& dst, const Taps& t, bool along_x, const Tile& tile) {
  const int half = t.n / 2, cols = dst.cols(), n = dst.size();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // The local position of the clamped frame position.
    const int r = clampi(tile.y0 + i / cols - dst.hy, 0, tile.h - 1) - tile.y0;
    const int c = clampi(tile.x0 + i % cols - dst.hx, 0, tile.w - 1) - tile.x0;
    dst.p[i] = along_x ? chain(src.at(r, c - half), 1, t) : chain(src.at(r - half, c), src.cols(), t);
  }
}

// The vertical filter of src at the tile's own local position (r, c).
__device__ __forceinline__ float filter_y(const Buf& src, const Taps& t, int r, int c) {
  return chain(src.at(r - t.n / 2, c), src.cols(), t);
}

__device__ __forceinline__ void store_y(const Buf& src, const Taps& t, float* out, const Tile& tile) {
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int r = i / kTileW, c = i % kTileW, y = tile.y0 + r, x = tile.x0 + c;
    if (y < tile.h && x < tile.w) out[static_cast<size_t>(y) * tile.w + x] = filter_y(src, t, r, c);
  }
}

__global__ void __launch_bounds__(kThreads)
sep_filter_kernel(const float* __restrict__ in, float* __restrict__ out1, float* __restrict__ out2, int h, int w,
                  Taps h1, Taps v1, Taps h2, Taps v2) {
  int f;
  const Tile tile = tile_of(h, w, &f);
  const size_t off = static_cast<size_t>(f) * h * w;
  const bool two = out2 != nullptr;
  const int hy = max(v1.n / 2, two ? v2.n / 2 : 0), hx = max(h1.n / 2, two ? h2.n / 2 : 0);
  float* smem = reinterpret_cast<float*>(dynamic_shared());
  const Buf src{smem, hy, hx};
  const Buf mid{src.end(), hy, 0};  // the horizontal pass, stored as float32
  load(in + off, src, tile);
  __syncthreads();
  pass(src, mid, h1, true, tile);
  __syncthreads();
  store_y(mid, v1, out1 + off, tile);
  if (two) {
    __syncthreads();
    pass(src, mid, h2, true, tile);
    __syncthreads();
    store_y(mid, v2, out2 + off, tile);
  }
}

__global__ void __launch_bounds__(kThreads)
evolution_flow_kernel(const float* __restrict__ lt, const float* __restrict__ k, int k_step,
                      float* __restrict__ lsmooth, float* __restrict__ flow, int h, int w, Taps g, Taps m, Taps o) {
  int f;
  const Tile tile = tile_of(h, w, &f);
  const size_t off = static_cast<size_t>(f) * h * w;
  const int hg = g.n / 2, hs = max(m.n, o.n) / 2;
  float* smem = reinterpret_cast<float*>(dynamic_shared());
  const Buf src{smem, hg + hs, hg + hs};
  const Buf bx{src.end(), hg + hs, hs};  // horizontal blur
  const Buf ls{bx.end(), hs, hs};        // lsmooth
  const Buf gx{ls.end(), hs, 0};         // horizontal pass of scharr_horizontal
  const Buf gy{gx.end(), hs, 0};         // horizontal pass of scharr_vertical
  load(lt + off, src, tile);
  __syncthreads();
  pass(src, bx, g, true, tile);
  __syncthreads();
  pass(bx, ls, g, false, tile);
  __syncthreads();
  pass(ls, gx, m, true, tile);
  pass(ls, gy, o, true, tile);
  __syncthreads();
  const float kk = k[f * k_step];
  const float inv_k2 = 1.0f / (kk * kk);
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int r = i / kTileW, c = i % kTileW, y = tile.y0 + r, x = tile.x0 + c;
    if (y >= h || x >= w) continue;
    const size_t at = off + static_cast<size_t>(y) * w + x;
    const float lx = filter_y(gx, o, r, c), ly = filter_y(gy, m, r, c);
    lsmooth[at] = *ls.at(r, c);
    flow[at] = 1.0f / (1.0f + inv_k2 * (lx * lx + ly * ly));
  }
}

// The FED cycle's tile: kFedRows rows of fed_cols(k) columns.
constexpr int kFedRows = 32;
constexpr int kMaxFused = 32;  // FED steps one launch may run

__host__ __device__ constexpr int fed_cols(int k) { return 66 - 2 * k > 32 ? 66 - 2 * k : 32; }

// The half steps of one launch: 0.5 tau rounded to float32, in order.
struct HalfSteps {
  int n;
  float v[kMaxFused];
};

__global__ void __launch_bounds__(kThreads)
fed_cycle_kernel(const float* __restrict__ lt, const float* __restrict__ cond, float* __restrict__ out, int h, int w,
                 HalfSteps steps) {
  const int k = steps.n, rows = kFedRows + 2 * k, cols = fed_cols(k) + 2 * k;
  // The frame position of the buffers' entry (0, 0).
  const int y0 = static_cast<int>(blockIdx.y) * kFedRows - k, x0 = static_cast<int>(blockIdx.x) * fed_cols(k) - k;
  const size_t off = static_cast<size_t>(blockIdx.z) * h * w;
  float* const smem = reinterpret_cast<float*>(dynamic_shared());
  float* const even = smem;  // lt before the even steps, the odd steps' output
  float* const odd = smem + rows * cols;
  float* const c = smem + 2 * rows * cols;
  // Stage lt and the conductivity; +0 outside the frame.
  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const int y = y0 + r;
    const bool row_in = y >= 0 && y < h;
    const size_t row = off + static_cast<size_t>(row_in ? y : 0) * w;
    for (int q = threadIdx.x; q < cols; q += blockDim.x) {
      const int x = x0 + q;
      const bool in = row_in && x >= 0 && x < w;
      const size_t at = in ? row + x : off;
      __pipeline_memcpy_async(even + r * cols + q, lt + at, sizeof(float), in ? 0 : sizeof(float));
      __pipeline_memcpy_async(c + r * cols + q, cond + at, sizeof(float), in ? 0 : sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    // Step j computes the region [k - e, k + tile + e) on both axes.
    const int e = k - 1 - j, lo = k - e, nr = kFedRows + 2 * e, nc = fed_cols(k) + 2 * e;
    const float hs = steps.v[j];
    const float* const cur = (j & 1) ? odd : even;
    float* const nxt = (j & 1) ? even : odd;
    // This thread's rows: one run of ceil(nr / blockDim.y).
    const int per = (nr + blockDim.y - 1) / blockDim.y;
    const int r0 = lo + static_cast<int>(threadIdx.y) * per, r1 = min(r0 + per, lo + nr);
    for (int q = lo + threadIdx.x; q < lo + nc && r0 < r1; q += blockDim.x) {
      const int x = x0 + q;
      if (x < 0 || x >= w) continue;
      // The column walk: the rows above and at r in registers.
      float l_up = cur[(r0 - 1) * cols + q], l_mid = cur[r0 * cols + q];
      float c_up = c[(r0 - 1) * cols + q], c_mid = c[r0 * cols + q];
      for (int r = r0; r < r1; ++r) {
        const int at = r * cols + q;
        const float l_dn = cur[at + cols], c_dn = c[at + cols];
        const int y = y0 + r;
        if (y >= 0 && y < h) {
          // The half-flows with the four neighbours; F.pad's +0 where there is none.
          float right = 0.0f, left = 0.0f, down = 0.0f, up = 0.0f;
          if (x < w - 1) right = __fmul_rn(__fmul_rn(hs, __fadd_rn(c_mid, c[at + 1])), __fsub_rn(cur[at + 1], l_mid));
          if (x > 0) left = __fmul_rn(__fmul_rn(hs, __fadd_rn(c[at - 1], c_mid)), __fsub_rn(l_mid, cur[at - 1]));
          if (y < h - 1) down = __fmul_rn(__fmul_rn(hs, __fadd_rn(c_mid, c_dn)), __fsub_rn(l_dn, l_mid));
          if (y > 0) up = __fmul_rn(__fmul_rn(hs, __fadd_rn(c_up, c_mid)), __fsub_rn(l_mid, l_up));
          const float v = __fsub_rn(__fadd_rn(__fsub_rn(__fadd_rn(l_mid, right), left), down), up);
          if (e == 0) {
            out[off + static_cast<size_t>(y) * w + x] = v;
          } else {
            nxt[at] = v;
          }
        }
        l_up = l_mid;
        l_mid = l_dn;
        c_up = c_mid;
        c_mid = c_dn;
      }
    }
    if (e > 0) __syncthreads();
  }
}

// The Scharr pair's nonzero taps at scale s: main -1 at -s and +1 at +s,
// off n at -s and +s and n w at 0.
struct Scharr {
  float main_lo, main_hi, off_side, off_mid;
};

// _conv1d's chain of the main taps over the inputs at -s and +s.
__device__ __forceinline__ float scharr_main(float lo, float hi, const Scharr& t) {
  return __fadd_rn(__fmul_rn(lo, t.main_lo), __fmul_rn(hi, t.main_hi));
}

// _conv1d's chain of the off taps over the inputs at -s, 0 and +s.
__device__ __forceinline__ float scharr_off(float lo, float mid, float hi, const Scharr& t) {
  return __fadd_rn(__fadd_rn(__fmul_rn(lo, t.off_side), __fmul_rn(mid, t.off_mid)), __fmul_rn(hi, t.off_side));
}

constexpr int kDetRows = 32;   // a detector tile's rows
constexpr int kDetWide = 64;   // its Scharr buffers' columns

__host__ __device__ constexpr int det_cols(int s) { return kDetWide - 2 * s; }

// Shared floats of a detector block at scale s: the stage, the two
// horizontal passes, ly (lx reuses the stage's space).
__host__ __device__ constexpr int det_floats(int s) {
  return (kDetRows + 4 * s) * (det_cols(s) + 4 * s) + 2 * (kDetRows + 4 * s) * kDetWide +
         (kDetRows + 2 * s) * kDetWide;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
detector_kernel(const float* __restrict__ lsm, float* __restrict__ lx_out, float* __restrict__ ly_out,
                float* __restrict__ ldet, int h, int w, Scharr t, float s4) {
  constexpr int T = det_cols(S), SR = kDetRows + 4 * S, SC = T + 4 * S, HW = kDetWide, LR = kDetRows + 2 * S;
  const int ty0 = static_cast<int>(blockIdx.y) * kDetRows, tx0 = static_cast<int>(blockIdx.x) * T;
  const int y0 = ty0 - 2 * S, x0 = tx0 - 2 * S;  // the frame position of the stage's entry (0, 0)
  const size_t off = static_cast<size_t>(blockIdx.z) * h * w;
  float* const st = reinterpret_cast<float*>(dynamic_shared());  // SR x SC
  float* const hm = st + SR * SC;  // SR x HW: the main pass of the stage along x, at frame columns x0 + S + q
  float* const ho = hm + SR * HW;  // SR x HW: the off pass
  float* const ly = ho + SR * HW;  // LR x HW, at frame rows y0 + S + p and columns x0 + S + q
  float* const lx = st;            // LR x HW, over the stage once pass 1 has read it
  // The stage: the frame's part by cp.async; at the frame's edge, each
  // entry outside it then takes the clamped position's value.
  for (int r = threadIdx.y; r < SR; r += blockDim.y) {
    const int y = y0 + r;
    if (y < 0 || y >= h) continue;
    const float* const row = lsm + off + static_cast<size_t>(y) * w;
    for (int q = threadIdx.x; q < SC; q += blockDim.x) {
      const int x = x0 + q;
      if (x >= 0 && x < w) __pipeline_memcpy_async(st + r * SC + q, row + x, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (y0 < 0 || x0 < 0 || y0 + SR > h || x0 + SC > w) {
    for (int r = threadIdx.y; r < SR; r += blockDim.y) {
      const int rr = clampi(y0 + r, 0, h - 1) - y0;
      for (int q = threadIdx.x; q < SC; q += blockDim.x) {
        const int qq = clampi(x0 + q, 0, w - 1) - x0;
        if (rr != r || qq != q) st[r * SC + q] = st[rr * SC + qq];
      }
    }
    __syncthreads();
  }
  // Pass 1, at each column's clamped position (the rows repeat the clamped
  // rows already).
  for (int q = threadIdx.x; q < HW; q += blockDim.x) {
    const int sq = clampi(x0 + S + q, 0, w - 1) - x0;
    for (int r = threadIdx.y; r < SR; r += blockDim.y) {
      const float* const p = st + r * SC + sq;
      const float a = p[-S], b = p[0], c = p[S];
      hm[r * HW + q] = scharr_main(a, c, t);
      ho[r * HW + q] = scharr_off(a, b, c, t);
    }
  }
  __syncthreads();
  // Pass 2: lx = the off pass of hm along y, ly = the main pass of ho, at
  // each row's clamped position.
  for (int p = threadIdx.y; p < LR; p += blockDim.y) {
    const int hr = clampi(y0 + S + p, 0, h - 1) - y0;
    for (int q = threadIdx.x; q < HW; q += blockDim.x) {
      const float* const a = hm + hr * HW + q;
      const float* const b = ho + hr * HW + q;
      lx[p * HW + q] = scharr_off(a[-S * HW], a[0], a[S * HW], t);
      ly[p * HW + q] = scharr_main(b[-S * HW], b[S * HW], t);
    }
  }
  __syncthreads();
  // The second derivatives from lx's and ly's neighbours at +-s.
  for (int i = threadIdx.y; i < kDetRows; i += blockDim.y) {
    const int y = ty0 + i;
    if (y >= h) break;
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
      const int x = tx0 + j;
      if (x >= w) break;
      const float* const a = lx + (i + S) * HW + j + S;
      const float* const b = ly + (i + S) * HW + j + S;
      const float a_nw = a[-S * HW - S], a_n = a[-S * HW], a_ne = a[-S * HW + S];
      const float a_w = a[-S], a_e = a[S];
      const float a_sw = a[S * HW - S], a_s = a[S * HW], a_se = a[S * HW + S];
      // lxx: the main pass of lx along x at rows -s, 0, +s, then the off pass along y.
      const float lxx = scharr_off(scharr_main(a_nw, a_ne, t), scharr_main(a_w, a_e, t), scharr_main(a_sw, a_se, t), t);
      // lxy: the off pass of lx along x at rows -s and +s, then the main pass along y.
      const float lxy = scharr_main(scharr_off(a_nw, a_n, a_ne, t), scharr_off(a_sw, a_s, a_se, t), t);
      // lyy: the off pass of ly along x at rows -s and +s, then the main pass along y.
      const float lyy = scharr_main(scharr_off(b[-S * HW - S], b[-S * HW], b[-S * HW + S], t),
                                    scharr_off(b[S * HW - S], b[S * HW], b[S * HW + S], t), t);
      const size_t at = off + static_cast<size_t>(y) * w + x;
      lx_out[at] = a[0];
      ly_out[at] = b[0];
      ldet[at] = __fmul_rn(__fsub_rn(__fmul_rn(lxx, lyy), __fmul_rn(lxy, lxy)), s4);
    }
  }
}

// Taps from the caller's n floats: odd n in [1, kMaxTaps], else false.
bool taps_of(const float* src, int n, Taps* t) {
  if (n < 1 || n > kMaxTaps || n % 2 == 0) return false;
  t->n = n;
  for (int i = 0; i < kMaxTaps; ++i) t->t[i] = i < n ? src[i] : 0.0f;
  return true;
}

// The grid of a frames x h x w batch (0 when empty), or -1 past a 1-D grid.
long long blocks_of(int frames, int h, int w) {
  if (frames <= 0 || h <= 0 || w <= 0) return 0;
  const long long n = static_cast<long long>(frames) * ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  return n > 0x7fffffffLL ? -1 : n;
}

// Lets `kernel` take `bytes` of dynamic shared memory: 0, a cudaError_t,
// or -1 past a block's limit.
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultShared)) return 0;
  if (bytes > static_cast<size_t>(kMaxShared)) return -1;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

}  // namespace

// Each entry returns 0 or the launch's cudaError_t, or -1 for arguments it
// does not take (taps: odd counts up to 33; FED steps a launch: 1 to 32;
// Scharr scales: 1 to 16; the grid; shared memory).  All planes are
// contiguous float32 (frames, h, w); nothing is launched for an empty
// batch.

extern "C" int cv_sep_filter(const float* in, float* out1, float* out2, int frames, int h, int w, const float* h1,
                             int nh1, const float* v1, int nv1, const float* h2, int nh2, const float* v2, int nv2,
                             void* stream) {
  Taps th1, tv1, th2 = {}, tv2 = {};
  if (!taps_of(h1, nh1, &th1) || !taps_of(v1, nv1, &tv1)) return -1;
  if (out2 != nullptr && (!taps_of(h2, nh2, &th2) || !taps_of(v2, nv2, &tv2))) return -1;
  const long long blocks = blocks_of(frames, h, w);
  if (blocks <= 0) return static_cast<int>(blocks);
  const int hy = out2 != nullptr && tv2.n > tv1.n ? tv2.n / 2 : tv1.n / 2;
  const int hx = out2 != nullptr && th2.n > th1.n ? th2.n / 2 : th1.n / 2;
  const size_t shared = sizeof(float) * (buf_floats(hy, hx) + buf_floats(hy, 0));
  const int err = allow_shared(sep_filter_kernel, shared);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>(blocks);
  sep_filter_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      in, out1, out2, h, w, th1, tv1, th2, tv2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_evolution_flow(const float* lt, const float* k, int k_step, float* lsmooth, float* flow, int frames,
                                 int h, int w, const float* gauss, int ng, const float* main_taps,
                                 const float* off_taps, int ns, void* stream) {
  Taps g, m, o;
  if (!taps_of(gauss, ng, &g) || !taps_of(main_taps, ns, &m) || !taps_of(off_taps, ns, &o)) return -1;
  const long long blocks = blocks_of(frames, h, w);
  if (blocks <= 0) return static_cast<int>(blocks);
  const int hg = ng / 2, hs = ns / 2;
  const size_t shared = sizeof(float) * (buf_floats(hg + hs, hg + hs) + buf_floats(hg + hs, hs) +
                                         buf_floats(hs, hs) + 2 * buf_floats(hs, 0));
  const int err = allow_shared(evolution_flow_kernel, shared);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>(blocks);
  evolution_flow_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      lt, k, k_step, lsmooth, flow, h, w, g, m, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_fed_cycle(const float* lt, const float* cond, float* out, float* scratch, int frames, int h, int w,
                            const float* half_steps, int n, int k, void* stream) {
  if (n < 0 || k < 1 || k > kMaxFused || frames > 65535) return -1;
  if (frames <= 0 || h <= 0 || w <= 0 || n == 0) return 0;
  const int launches = (n + k - 1) / k;
  if (launches > 1 && scratch == nullptr) return -1;
  const unsigned tiles_y = static_cast<unsigned>((h + kFedRows - 1) / kFedRows);
  if (tiles_y > 65535) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, kThreads / 32);
  const size_t most = sizeof(float) * 3 * (kFedRows + 2 * k) * (fed_cols(k) + 2 * k);
  const int err = allow_shared(fed_cycle_kernel, most);
  if (err != 0) return err;
  // Balanced launches: the first n % launches run one step more.  The last
  // writes out; the ones before it alternate between scratch and out.
  const float* src = lt;
  for (int i = 0, done = 0; i < launches; ++i) {
    HalfSteps steps = {};
    steps.n = n / launches + (i < n % launches ? 1 : 0);
    for (int j = 0; j < steps.n; ++j) steps.v[j] = half_steps[done + j];
    done += steps.n;
    float* dst = (launches - 1 - i) % 2 == 0 ? out : scratch;
    const dim3 grid((w + fed_cols(steps.n) - 1) / fed_cols(steps.n), tiles_y, frames);
    const size_t shared = sizeof(float) * 3 * (kFedRows + 2 * steps.n) * (fed_cols(steps.n) + 2 * steps.n);
    fed_cycle_kernel<<<grid, block, shared, s>>>(src, cond, dst, h, w, steps);
    const int launched = static_cast<int>(cudaGetLastError());
    if (launched != 0) return launched;
    src = dst;
  }
  return 0;
}

template <int S>
int launch_detector(const float* lsmooth, float* lx, float* ly, float* ldet, int frames, int h, int w, Scharr t,
                    float s4, cudaStream_t stream) {
  const size_t shared = sizeof(float) * det_floats(S);
  const int err = allow_shared(detector_kernel<S>, shared);
  if (err != 0) return err;
  const dim3 grid((w + det_cols(S) - 1) / det_cols(S), (h + kDetRows - 1) / kDetRows, frames);
  const dim3 block(32, kThreads / 32);
  detector_kernel<S><<<grid, block, shared, stream>>>(lsmooth, lx, ly, ldet, h, w, t, s4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_detector(const float* lsmooth, float* lx, float* ly, float* ldet, int frames, int h, int w,
                           int sigma_size, float main_lo, float main_hi, float off_side, float off_mid, float s4,
                           void* stream) {
  if (sigma_size < 1 || sigma_size > 16 || frames > 65535 || (h + kDetRows - 1) / kDetRows > 65535) return -1;
  if (frames <= 0 || h <= 0 || w <= 0) return 0;
  const Scharr t = {main_lo, main_hi, off_side, off_mid};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma_size) {
    case 1: return launch_detector<1>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 2: return launch_detector<2>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 3: return launch_detector<3>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 4: return launch_detector<4>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 5: return launch_detector<5>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 6: return launch_detector<6>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 7: return launch_detector<7>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 8: return launch_detector<8>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 9: return launch_detector<9>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 10: return launch_detector<10>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 11: return launch_detector<11>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 12: return launch_detector<12>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 13: return launch_detector<13>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 14: return launch_detector<14>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    case 15: return launch_detector<15>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
    default: return launch_detector<16>(lsmooth, lx, ly, ldet, frames, h, w, t, s4, s);
  }
}
