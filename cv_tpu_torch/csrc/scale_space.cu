// The AKAZE nonlinear scale space, cv_tpu/akaze/scale_space.py::build_scale_space
// (XLA code under the extractors' jit; cv_tpu's Pallas stencils of it
// measured 60x slower on the TPU and were deleted, so it replaces no Pallas
// kernel), as four entries, each one launch over a batch of frames:
//
//   cv_sep_filter      vertical_filter(horizontal_filter(x, h), v) for one or
//                      two tap pairs of one input (the base blur; the
//                      contrast factor's blur and its Scharr x and y);
//   cv_evolution_flow  lsmooth = gaussian_blur(lt, 1), lx and ly = the
//                      Scharr pair of lsmooth at scale 1, flow = pm_g2(lx,
//                      ly, k): writes lsmooth and flow;
//   cv_fed_step        one explicit FED step of lt under the flow;
//   cv_detector        lx, ly = the Scharr pair of lsmooth at scale s, then
//                      lxx, lyy, lxy and ldet = (lxx lyy - lxy lxy) s^4:
//                      writes lx, ly and ldet.
//
// Each is the port's plain tensor chain (cv_tpu_torch/ops/image.py) bit for
// bit: the same float32 products, sums and IEEE divisions in the same
// order, built with --fmad=false so that nothing is contracted.  A 1-D
// filter is _conv1d's tap chain: the first nonzero tap's product starts the
// sum, later nonzero taps are added left to right, zero taps are skipped
// (so they decide the sign of a zero, as there), edges clamp.  Every
// intermediate plane is rounded to float32 where the chain stores it.  The
// FED step adds F.pad's +0 at the right and bottom borders (-0 + 0 is +0)
// and subtracts it at the left and top.  pm_g2's 1 / (k k) and 1 / (1 + ...)
// are IEEE divisions, as torch's reciprocal is.
//
// Design: a block computes a 32x16 tile of one frame, 256 threads.  It
// stages the input tile with its halo in shared memory, then runs each
// pass of the chain from one shared buffer into the next, each buffer
// covering the halo that the passes after it still need, and writes only
// the outputs.  An entry of a buffer at a position outside the frame holds
// the value at the clamped position, which is what the plain chain's
// index clamp reads there.  The halo is 4 for the blur (9 taps), 3 for the
// flow (blur 2, Scharr 1), 1 for the FED step, 2s for the detector.
//
// What bounds it: bytes.  Each entry does tens of float32 operations a
// pixel against 8-16 bytes moved (each plane read once, each output written
// once), far below the card's operation rate; the staged halo rereads from
// L2 and the passes' recomputation over it are the price of one launch a
// step instead of the chain's ~10-40.

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

__global__ void __launch_bounds__(kThreads)
fed_step_kernel(const float* __restrict__ lt, const float* __restrict__ cond, float* __restrict__ out, int h, int w,
                float half_step) {
  int f;
  const Tile tile = tile_of(h, w, &f);
  const size_t off = static_cast<size_t>(f) * h * w;
  float* smem = reinterpret_cast<float*>(dynamic_shared());
  const Buf l{smem, 1, 1};
  const Buf c{l.end(), 1, 1};
  load(lt + off, l, tile);
  load(cond + off, c, tile);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int r = i / kTileW, q = i % kTileW, y = tile.y0 + r, x = tile.x0 + q;
    if (y >= h || x >= w) continue;
    const float lc = *l.at(r, q), cc = *c.at(r, q);
    // The half-flows with the four neighbours; F.pad's +0 where there is none.
    float right = 0.0f, left = 0.0f, down = 0.0f, up = 0.0f;
    if (x < w - 1) right = (half_step * (cc + *c.at(r, q + 1))) * (*l.at(r, q + 1) - lc);
    if (x > 0) left = (half_step * (*c.at(r, q - 1) + cc)) * (lc - *l.at(r, q - 1));
    if (y < h - 1) down = (half_step * (cc + *c.at(r + 1, q))) * (*l.at(r + 1, q) - lc);
    if (y > 0) up = (half_step * (*c.at(r - 1, q) + cc)) * (lc - *l.at(r - 1, q));
    out[off + static_cast<size_t>(y) * w + x] = (((lc + right) - left) + down) - up;
  }
}

__global__ void __launch_bounds__(kThreads)
detector_kernel(const float* __restrict__ lsm, float* __restrict__ lx_out, float* __restrict__ ly_out,
                float* __restrict__ ldet, int h, int w, Taps m, Taps o, float s4) {
  int f;
  const Tile tile = tile_of(h, w, &f);
  const size_t off = static_cast<size_t>(f) * h * w;
  const int s = max(m.n, o.n) / 2;
  float* smem = reinterpret_cast<float*>(dynamic_shared());
  const Buf src{smem, 2 * s, 2 * s};
  const Buf hm{src.end(), 2 * s, s};  // horizontal pass of scharr_horizontal(lsmooth)
  const Buf ho{hm.end(), 2 * s, s};   // horizontal pass of scharr_vertical(lsmooth)
  const Buf bx{ho.end(), s, s};       // lx
  const Buf by{bx.end(), s, s};       // ly
  const Buf hxx{by.end(), s, 0};      // horizontal pass of scharr_horizontal(lx)
  const Buf hxy{hxx.end(), s, 0};     // horizontal pass of scharr_vertical(lx)
  const Buf hyy{hxy.end(), s, 0};     // horizontal pass of scharr_vertical(ly)
  load(lsm + off, src, tile);
  __syncthreads();
  pass(src, hm, m, true, tile);
  pass(src, ho, o, true, tile);
  __syncthreads();
  pass(hm, bx, o, false, tile);
  pass(ho, by, m, false, tile);
  __syncthreads();
  pass(bx, hxx, m, true, tile);
  pass(bx, hxy, o, true, tile);
  pass(by, hyy, o, true, tile);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int r = i / kTileW, c = i % kTileW, y = tile.y0 + r, x = tile.x0 + c;
    if (y >= h || x >= w) continue;
    const size_t at = off + static_cast<size_t>(y) * w + x;
    const float lxx = filter_y(hxx, o, r, c), lyy = filter_y(hyy, m, r, c), lxy = filter_y(hxy, m, r, c);
    lx_out[at] = *bx.at(r, c);
    ly_out[at] = *by.at(r, c);
    ldet[at] = (lxx * lyy - lxy * lxy) * s4;
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
// does not take (taps: odd counts up to 33; the grid; shared memory).  All
// planes are contiguous float32 (frames, h, w); nothing is launched for an
// empty batch.

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

extern "C" int cv_fed_step(const float* lt, const float* cond, float* out, int frames, int h, int w, float half_step,
                           void* stream) {
  const long long blocks = blocks_of(frames, h, w);
  if (blocks <= 0) return static_cast<int>(blocks);
  const size_t shared = sizeof(float) * 2 * buf_floats(1, 1);
  const unsigned grid = static_cast<unsigned>(blocks);
  fed_step_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(lt, cond, out, h, w, half_step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cv_detector(const float* lsmooth, float* lx, float* ly, float* ldet, int frames, int h, int w,
                           const float* main_taps, const float* off_taps, int ns, float s4, void* stream) {
  Taps m, o;
  if (!taps_of(main_taps, ns, &m) || !taps_of(off_taps, ns, &o)) return -1;
  const long long blocks = blocks_of(frames, h, w);
  if (blocks <= 0) return static_cast<int>(blocks);
  const int s = ns / 2;
  const size_t shared = sizeof(float) * (buf_floats(2 * s, 2 * s) + 2 * buf_floats(2 * s, s) +
                                         2 * buf_floats(s, s) + 3 * buf_floats(s, 0));
  const int err = allow_shared(detector_kernel, shared);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>(blocks);
  detector_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      lsmooth, lx, ly, ldet, h, w, m, o, s4);
  return static_cast<int>(cudaGetLastError());
}
