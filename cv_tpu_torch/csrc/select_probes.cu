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
//   bisect_matmul_dyn_oh   :110  the same with column rel_x[k, s] (+0 where
//                                it leaves [0, PW): no one-hot match)
//   bisect_split_nomm      :132  out[k, :] = sum(p1) + sum(p2) + sum(p3), the
//                                bf16x3 split p1 = bf16(p), r = p - p1,
//                                p2 = bf16(r), p3 = bf16(r - p2)
//   bisect_vpu_rowstage    :153  out[k, c NS + s] = win[c, rel_y[k, s], 0]
//                                (+0 where the row leaves [0, PH))
// experiments/exp_r3_mxu_probe.py (patches (K, C, P, P); out (K, C, NS),
// every channel row the same unless stated):
//   mxu_dots     :50   sum over x of 9 accumulated bf16(patch[k, 0, ry, x]),
//                      ry = rel_y[8 (k / 8), s] (the step's first keypoint)
//   mxu_dotsbig  :67   sum over x of (v + v) + v, v as in mxu_dots; both 0
//                      where ry leaves [0, P)
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
// plain versions within a stated tolerance and the selects bitwise, and
// the two window sums, the two column sums and the two row sums bitwise to
// their order mirrors as well.
//
// What bounds them: bytes.  The window probes read a 209 KB window per
// keypoint; the patch probes one channel row or a few words.  Design: one
// block per keypoint; threads stride over samples.  Six have a design of
// their own (below).  The two window sums: one thread a (column, row
// parity) chain of the window, plain coalesced loads, then a warp-shuffle
// and shared-memory tree.  The two one-hot column sums: the window once
// through shared memory by TMA, one thread a column; their host code
// encodes a TMA tensor map with libcuda's cuTensorMapEncodeTiled, which it
// obtains through cudaGetDriverEntryPoint (no -lcuda at build time).  The
// two one-hot row sums (P = 128 only): each patch row that a sample names
// staged once as bf16 in shared memory, one thread a row.  The row select
// (vpu_rowstage): the window's column 0 staged once in shared memory,
// rel_y in 16-byte loads.  The split select (mxu_split): a flat grid, one
// thread a (keypoint, sample) with its three loads in flight.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

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

__device__ __forceinline__ const float* at(const Window& w, int c, int y, int x) {
  return w.base + c * w.plane + static_cast<size_t>(y) * w.width + x;
}

// ---------------------------------------------------------------------------
// The one-hot column sums: bisect_matmul_static and bisect_matmul_dyn_oh.
//
// out[k, 3 s + r] = sum over rep < 3, c < 3, y < 136 of bf16(win_k[c, y,
// col]), col = s % 128 (static) or rel_x[k, s] (dynamic); the quiet NaN
// where the window leaves the stack, +0 where the column leaves [0, 128)
// (the one-hot matches nothing there, as in the TPU body).  The TPU body's
// one-hot product has one nonzero term a column, so only the window's 128
// column sums are distinct.
//
// What bounds it: bytes, one read of each 209 KB window (0.034 ms at
// exp_bisect.py's K=512).  Design: one block a keypoint, one thread a
// column.
// * The window arrives once, by TMA: chunks of kColRows rows (a box of a
//   rank-4 tensor map over the stack) on a ring of kStages slots, each with
//   a full and an empty mbarrier (no block barrier a chunk).  exp_bisect.py
//   also runs with x0 unaligned, and on the H100 a TMA box whose first
//   column is not 16-byte aligned faults (an illegal instruction,
//   measured), so a chunk's box starts at the aligned column x0 & ~3 and
//   is kBoxCols = 132 columns wide; the window is its columns x0 & 3 ..
//   (x0 & 3) + 127 (at most one 32-byte sector a row more than the
//   window's own 16 or 17).
// * As a chunk lands each thread rounds its column's rows to bf16 (exact:
//   the summed value is the rounding) and adds them.  Reps 1 and 2 re-read
//   the window: the first kChunks - kStages chunks from registers, packed
//   two bf16 rows to a word (108 a thread at kStages = 24), the last
//   kStages from their ring slots, which no later chunk overwrites.  So
//   shared memory holds only the ring (24 slots, 101 KB, two blocks an SM)
//   and the bytes in flight.  Each thread adds its column rep -> c -> y in
//   one serial chain of 1,224 float32 adds, the order of the earlier
//   one-thread-a-sample kernel: the output is the same bits
//   (probes.bisect_matmul_ordered).
// * The column sums go to shared memory; the block gathers them into the
//   output row with 16-byte stores (the dynamic body reads its rel_x row
//   once, coalesced).
// kTmaStaging = 0 (the ablation of scripts/time_engine_calls.py) loads each
// chunk with plain coalesced loads, a thread its column, and keeps all 204
// words in registers.  On the H100 it is the faster of the two (the
// compiler hoists the loads across the unrolled chunks; PERF.md §6); TMA
// stays the design, the card's counterpart of the TPU body's window DMA.

constexpr int kColPH = 136, kColPW = 128, kColChannels = 3;  // the window; kColPW threads
constexpr int kWinRows = kColChannels * kColPH;               // 408 rows, channel-major
constexpr int kColRows = 8;                                   // rows a chunk (a TMA box)
constexpr int kStages = 24;                                   // chunks in flight into shared memory
constexpr int kTmaStaging = 1;                                // 0: plain loads (the ablation)
constexpr int kBoxCols = kColPW + 4;                          // a box: from the 16-byte aligned column at or before x0
constexpr int kChunks = kWinRows / kColRows;
constexpr int kChunkFloats = kColRows * kBoxCols;
constexpr int kSlotFloats = (kChunkFloats + 31) / 32 * 32;    // slots start 128-byte aligned (TMA destinations)
// Chunks kept in registers, 4 words each: with TMA the last kStages stay
// in their ring slots (no chunk follows to overwrite them).
constexpr int kRegChunks = kTmaStaging ? kChunks - kStages : kChunks;
constexpr size_t kRingBytes = kTmaStaging ? static_cast<size_t>(kStages) * kSlotFloats * sizeof(float) : 0;
// 128 bytes of slack to align the ring (a TMA destination), the ring, the
// column sums and two mbarriers a slot (full, empty).
constexpr size_t kColSmemBytes = 128 + kRingBytes + kColPW * sizeof(float) + 2 * kStages * 8;
static_assert(kColPH % kColRows == 0 && kColRows % 2 == 0, "a chunk is whole row pairs of one channel");
static_assert(kStages > 0 && kStages < kChunks, "the ring holds part of the window");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A completion that
// never comes (a lost copy) traps, failing the launch, after 2^24 polls
// (seconds; a chunk takes microseconds) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls > (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Chunk j of keypoint (l, yb, xb): kColRows rows of the window from row
// kColRows j, all in one channel; its box starts at the 16-byte aligned
// column.
__device__ __forceinline__ void tma_load_chunk(float* dst, const CUtensorMap* map, uint64_t* bar, int j, int l,
                                               int yb, int xb) {
  const int row0 = j * kColRows;
  mbar_expect_tx(bar, kChunkFloats * sizeof(float));
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(xb & ~3), "r"(yb + row0 % kColPH), "r"(row0 / kColPH), "r"(l),
      "r"(smem_u32(bar))
      : "memory");
}

// Round this thread's column of a chunk to bf16, add it to acc in row
// order, and pack it two rows to a word (the lower row in the low half).
__device__ __forceinline__ float take_rows(const float (&v)[kColRows], uint32_t (&w)[kColRows / 2], float acc) {
#pragma unroll
  for (int r = 0; r < kColRows; r += 2) {
    const __nv_bfloat16 lo = __float2bfloat16_rn(v[r]), hi = __float2bfloat16_rn(v[r + 1]);
    acc += __bfloat162float(lo);
    acc += __bfloat162float(hi);
    w[r / 2] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
  }
  return acc;
}

// Add a packed pair of bf16 rows, the lower row first.
__device__ __forceinline__ float add_pair(uint32_t w, float acc) {
  acc += __uint_as_float(w << 16);
  acc += __uint_as_float(w & 0xffff0000u);
  return acc;
}

template <bool kDynamic>
__global__ void __launch_bounds__(kColPW, 2)
    column_sums_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ planes,
                       const int* __restrict__ lvl, const int* __restrict__ y0, const int* __restrict__ x0,
                       const int* __restrict__ rel_x, float* __restrict__ out, int n_levels, int height, int width,
                       int ns) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  float* ring = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x, k = blockIdx.x;
  float* colsum = reinterpret_cast<float*>(smem + kRingBytes);
  // A slot's full barrier completes when its chunk has landed; its empty
  // barrier when every warp has read it.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes + kColPW * sizeof(float));
  uint64_t* empty = full + kStages;

  const int l = lvl[k], yb = y0[k], xb = x0[k];
  const bool ok = l >= 0 && l < n_levels && yb >= 0 && yb + kColPH <= height && xb >= 0 && xb + kColPW <= width;
  if (ok) {  // the same for every thread of the block
    float acc = 0.0f;
    uint32_t win[kRegChunks * kColRows / 2];  // indexed by fully unrolled loops only: registers
    if constexpr (kTmaStaging) {
      if (t == 0) {
        for (int s = 0; s < kStages; ++s) {
          mbar_init(&full[s], 1);
          mbar_init(&empty[s], kColPW / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int j = 0; j < kStages && j < kChunks; ++j) {
          tma_load_chunk(ring + j * kSlotFloats, &map, &full[j], j, l, yb, xb);
        }
      }
      __syncthreads();
    }
    const float* column = planes + (static_cast<size_t>(l) * kColChannels * height + yb) * width + xb + t;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      float v[kColRows];
      if constexpr (kTmaStaging) {
        const int slot = i % kStages;
        mbar_wait(&full[slot], static_cast<uint32_t>((i / kStages) & 1));
#pragma unroll
        for (int r = 0; r < kColRows; ++r) v[r] = ring[slot * kSlotFloats + r * kBoxCols + (xb & 3) + t];
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(&empty[slot]);
        // Thread 0 refills the slot read one chunk before, which the other
        // warps have most likely left by now.
        const int prev = i - 1, next = prev + kStages;
        if (t == 0 && prev >= 0 && next < kChunks) {
          mbar_wait(&empty[prev % kStages], static_cast<uint32_t>((prev / kStages) & 1));
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          tma_load_chunk(ring + (prev % kStages) * kSlotFloats, &map, &full[prev % kStages], next, l, yb, xb);
        }
      } else {
        const int row0 = i * kColRows;
        const float* src = column + (static_cast<size_t>(row0 / kColPH) * height + row0 % kColPH) * width;
#pragma unroll
        for (int r = 0; r < kColRows; ++r) v[r] = __ldg(src + static_cast<size_t>(r) * width);
      }
      uint32_t w[kColRows / 2];
      acc = take_rows(v, w, acc);
      if (i < kRegChunks) {
#pragma unroll
        for (int q = 0; q < kColRows / 2; ++q) win[i * (kColRows / 2) + q] = w[q];
      }
    }
    for (int rep = 1; rep < 3; ++rep) {
#pragma unroll
      for (int q = 0; q < kRegChunks * kColRows / 2; ++q) {
        uint32_t w = win[q];
        // Opaque to the compiler: otherwise it keeps rep 0's unpacked
        // floats alive in place of the packed words, and spills.
        asm volatile("" : "+r"(w));
        acc = add_pair(w, acc);
      }
#pragma unroll
      for (int i = kRegChunks; i < kChunks; ++i) {
#pragma unroll
        for (int r = 0; r < kColRows; ++r) {
          acc += bf16r(ring[(i % kStages) * kSlotFloats + r * kBoxCols + (xb & 3) + t]);
        }
      }
    }
    colsum[t] = acc;
  }
  __syncthreads();

  // The gather: sample s is column col(s)'s sum, written 3 times.
  const float nan = qnan();
  const int* rx = rel_x + static_cast<size_t>(k) * ns;
  auto value = [&](int s) -> float {
    if (!ok) return nan;
    const int c = kDynamic ? rx[s] : (s & (kColPW - 1));
    return c >= 0 && c < kColPW ? colsum[c] : 0.0f;  // no one-hot column matches: a sum of zeros
  };
  const int n = 3 * ns;
  float* o = out + static_cast<size_t>(k) * n;
  int tail = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
    // Outputs 4 q .. 4 q + 3 belong to samples s = 4 q / 3 and, from
    // 4 q + e = 3 (s + 1) on, s + 1.
    for (int q = t; q < n / 4; q += kColPW) {
      const int j = 4 * q, s = j / 3, next = 3 * (s + 1) - j;  // the first e of sample s + 1 (1, 2 or 3)
      const float a = value(s), b = value((j + 3) / 3);
      reinterpret_cast<float4*>(o)[q] = make_float4(a, next > 1 ? a : b, next > 2 ? a : b, b);
    }
    tail = n / 4 * 4;
  }
  for (int j = tail + t; j < n; j += kColPW) o[j] = value(j / 3);
}

// ---------------------------------------------------------------------------
// The window sums: bisect_dma_only and bisect_split_nomm.
//
// out[k, :] = the sum of keypoint k's 3 x 136 x 128 window (dma_only), or
// sum(p1) + sum(p2) + sum(p3) of its bf16x3 split (split_nomm); the quiet
// NaN where the window leaves the stack.
//
// What bounds it: bytes, one read of each 209 KB window (0.034 ms at
// exp_bisect.py's K=512).  Design: one block a keypoint (512 blocks, all
// resident at once), kThreads = 256 threads, one thread a (column, row
// parity) chain.
// * A window row is 128 floats, so the flat walk i = t, t + 256, ... of a
//   thread a strided sample (the earlier kernel) is column t & 127 over the
//   rows of parity t >> 7, channel by channel.  Thread t adds those 204
//   values in that order into a float32 from 0 (three sums for split_nomm,
//   p1, p2 and p3 rounded by __float2bfloat16_rn), then block_sum (the warp
//   shuffle tree, the warps in order) and (s1 + s2) + s3: the same bits
//   (probes.bisect_window_ordered).
// * The window's shape is compile-time: the walk steps a row pointer by two
//   rows, and by a plane between channels.  No division in the loop.
// * Plain coalesced read-only loads, a warp 32 consecutive floats of a row,
//   kWindowRowsInFlight rows loaded before any is added.  No TMA ring: for
//   this walk plain loads measured 13-15% faster (PERF.md §6, the column
//   sums' tma-off ablation).
// * The output row: the one value, with 16-byte stores.

constexpr int kChainRows = kColPH / 2;   // rows of one parity in a channel
constexpr int kWindowRowsInFlight = 17;  // rows a thread loads before it adds them
static_assert(kThreads == 2 * kColPW, "a thread a column and row parity");
static_assert(kChainRows % kWindowRowsInFlight == 0, "a channel's chain is whole batches");

template <bool kSplit>
__device__ __forceinline__ void add_window_value(float v, float& s1, float& s2, float& s3) {
  if (kSplit) {
    const float p1 = bf16r(v);
    const float r1 = v - p1;
    const float p2 = bf16r(r1);
    const float p3 = bf16r(r1 - p2);
    s1 += p1;
    s2 += p2;
    s3 += p3;
  } else {
    s1 += v;
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 4)
    window_sum_kernel(const float* __restrict__ planes, const int* __restrict__ lvl, const int* __restrict__ y0,
                      const int* __restrict__ x0, float* __restrict__ out, int n_levels, int height, int width,
                      int ns) {
  __shared__ float red[33];
  const int t = threadIdx.x, k = blockIdx.x;
  const Window w = window(planes, lvl, y0, x0, k, n_levels, kColChannels, height, width, kColPH, kColPW);
  const bool ok = w.base != nullptr;
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if (ok) {  // the same for every thread of the block
    const size_t step = 2 * static_cast<size_t>(width);
    const float* row = w.base + static_cast<size_t>(t >> 7) * width + (t & (kColPW - 1));
#pragma unroll 1
    for (int c = 0; c < kColChannels; ++c, row += w.plane) {
      const float* p = row;
#pragma unroll 1
      for (int j = 0; j < kChainRows; j += kWindowRowsInFlight, p += kWindowRowsInFlight * step) {
        float v[kWindowRowsInFlight];
#pragma unroll
        for (int i = 0; i < kWindowRowsInFlight; ++i) v[i] = __ldg(p + i * step);
#pragma unroll
        for (int i = 0; i < kWindowRowsInFlight; ++i) add_window_value<kSplit>(v[i], s1, s2, s3);
      }
    }
  }
  float s = block_sum(s1, red);
  if (kSplit) {
    const float b2 = block_sum(s2, red);
    const float b3 = block_sum(s3, red);
    s = (s + b2) + b3;
  }
  const float v = ok ? s : qnan();
  const int n = 3 * ns;
  float* o = out + static_cast<size_t>(k) * n;
  // Up to three floats before the first 16-byte boundary, then quads, then
  // the tail.
  const int head = min(n, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(o) & 15u)) & 15u) / 4));
  const int quads = (n - head) / 4;
  if (t < head) o[t] = v;
  float4* q = reinterpret_cast<float4*>(o + head);
  for (int i = t; i < quads; i += kThreads) q[i] = make_float4(v, v, v, v);
  for (int j = head + 4 * quads + t; j < n; j += kThreads) o[j] = v;
}

// ---------------------------------------------------------------------------
// The row select: bisect_vpu_rowstage.
//
// out[k, c NS + s] = win_k[c, rel_y[k, s], 0].  The TPU body broadcasts the
// window's column 0 and sums it against a one-hot of rel_y: for a finite
// window that is the value, bit for bit; +0 where the row leaves [0, 136)
// (the one-hot matches nothing there); and the quiet NaN in every output of
// a window that leaves the stack (the body's DMA cannot take it).
//
// What bounds it: bytes, the output (7.9 MB at exp_bisect.py's K=512,
// NS=1280), rel_y (2.6 MB) and one 32-byte sector for each distinct
// (level, channel, row) of column x0 (at most 6.7 MB): ~0.005 ms.  Design:
// one block a keypoint, its column staged once.
// * Before the block's one barrier each thread issues two sets of loads, so
//   that their round trips overlap: its at most kColLoads of the column's
//   3 x 136 floats, read-only into shared memory (408 scattered 4-byte
//   reads, no box for TMA), and its kRowstageQuads quads of rel_y[k, :] as
//   int4 (16 bytes, coalesced) into registers.  A window that leaves the
//   stack loads nothing of the stack.
// * Then each thread gathers a quad's four samples from shared memory and
//   stores them to the three channel rows, a float4 each.
// * Where NS is not a multiple of 4 or the rows are not 16-byte aligned:
//   per channel row a scalar head to the first 16-byte boundary, quads,
//   then the tail, rel_y read a word at a time.

constexpr int kRowstageThreads = 320;  // NS = 1280 is one quad a thread
constexpr int kRowstageQuads = 1;      // rel_y quads a thread loads at a time
constexpr int kColLoads = (kWinRows + kRowstageThreads - 1) / kRowstageThreads;

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__global__ void __launch_bounds__(kRowstageThreads)
    rowstage_kernel(const float* __restrict__ planes, const int* __restrict__ lvl, const int* __restrict__ y0,
                    const int* __restrict__ x0, const int* __restrict__ rel_y, float* __restrict__ out,
                    int n_levels, int height, int width, int ns) {
  __shared__ float col[kWinRows];  // col[c * 136 + y] = win[c, y, 0]
  const int t = threadIdx.x, k = blockIdx.x;
  const Window w = window(planes, lvl, y0, x0, k, n_levels, kColChannels, height, width, kColPH, kColPW);
  const bool ok = w.base != nullptr;  // the same for every thread of the block
  const int* ry = rel_y + static_cast<size_t>(k) * ns;
  float* o = out + static_cast<size_t>(k) * kColChannels * ns;
  const bool vec = (ns & 3) == 0 && aligned16(ry) && aligned16(o);  // the same for the block
  const int n_quads = vec ? ns / 4 : 0;

  if (ok) {
#pragma unroll
    for (int j = 0; j < kColLoads; ++j) {
      const int i = t + j * kRowstageThreads;
      if (i < kWinRows) col[i] = __ldg(at(w, i / kColPH, i % kColPH, 0));
    }
  }
  int4 r[kRowstageQuads];
  auto load_quads = [&](int q0) {
#pragma unroll
    for (int j = 0; j < kRowstageQuads; ++j) {
      const int q = q0 + t + j * kRowstageThreads;
      if (q < n_quads) r[j] = __ldg(reinterpret_cast<const int4*>(ry) + q);
    }
  };
  load_quads(0);
  __syncthreads();

  const float nan = qnan();
  auto value = [&](int c, int y) -> float {
    if (!ok) return nan;
    return y >= 0 && y < kColPH ? col[c * kColPH + y] : 0.0f;
  };
  for (int q0 = 0; q0 < n_quads; q0 += kRowstageThreads * kRowstageQuads) {
    if (q0 > 0) load_quads(q0);
#pragma unroll
    for (int j = 0; j < kRowstageQuads; ++j) {
      const int q = q0 + t + j * kRowstageThreads;
      if (q >= n_quads) continue;
#pragma unroll
      for (int c = 0; c < kColChannels; ++c) {
        reinterpret_cast<float4*>(o + static_cast<size_t>(c) * ns)[q] =
            make_float4(value(c, r[j].x), value(c, r[j].y), value(c, r[j].z), value(c, r[j].w));
      }
    }
  }
  if (vec) return;
  for (int c = 0; c < kColChannels; ++c) {
    float* oc = o + static_cast<size_t>(c) * ns;
    const int head = min(ns, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(oc) & 15u)) & 15u) / 4));
    const int quads = (ns - head) / 4;
    if (t < head) oc[t] = value(c, __ldg(ry + t));
    for (int q = t; q < quads; q += kRowstageThreads) {
      const int* s = ry + head + 4 * q;
      reinterpret_cast<float4*>(oc + head)[q] =
          make_float4(value(c, __ldg(s)), value(c, __ldg(s + 1)), value(c, __ldg(s + 2)), value(c, __ldg(s + 3)));
    }
    for (int s = head + 4 * quads + t; s < ns; s += kRowstageThreads) oc[s] = value(c, __ldg(ry + s));
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

// ---------------------------------------------------------------------------
// The one-hot row sums: mxu_dots and mxu_dotsbig.
//
// out[k, c, s] = sum over x < 128 of e(bf16(patch[k, 0, ry, x])), ry =
// rel_y[g (k / g), s] (the group's first keypoint), for every channel row
// c; e(v) adds v nine times from 0 (dots) or is (v + v) + v (dotsbig); 0
// where ry leaves [0, 128).  The TPU body's one-hot product has one nonzero
// term a dot, so only a keypoint's 128 row sums are distinct.
//
// What bounds it: bytes, each row that a sample names read once (0.0865 ms
// at exp_r3_mxu_probe.py's K=4096, NS=512, ~126 distinct rows of 128 a
// keypoint).  Design: one block a keypoint (kRowKeypoints a block), one
// thread a row.
// * The leader's index row goes to shared memory (coalesced) and marks the
//   rows it names; rows that no sample names are never read.
// * One warp stages one row at a time: 32 lanes x 16 bytes, read-only loads
//   that do not allocate in L1, kRowsInFlight rows loaded before any is
//   stored.  Each value is rounded to bf16 as it lands (exact: the summed
//   value is the rounding) and stored two to a word, row-major with a pitch
//   of kRowPitch = 65 words.  The pad makes both sides conflict-free: a
//   lane's two words go in an order that puts lanes l and l + 16 on other
//   banks, and in the sum thread y reads word 65 y + j, bank (y + j) mod 32.
// * Thread y sums row y once, x = 0 .. 127 in one serial chain of float32
//   adds of e(v), the parent kernel's order (a thread a sample, each
//   walking its row): the output is the same bits (probes.mxu_rows_ordered).
// * The block gathers its samples from the 128 sums with 16-byte stores, the
//   same value to every channel row.
// kRowMask = 0 (the ablation of scripts/time_engine_calls.py) stages and
// sums all 128 rows.

constexpr int kRowP = 128;                          // the patch side: a thread a row
constexpr int kRowKeypoints = 1;                    // keypoints a block (kRowP threads each)
constexpr int kRowsInFlight = 16;                   // rows a warp loads before it stores them
constexpr int kRowMask = 1;                         // 0: stage every row (the ablation)
constexpr int kRowWarps = kRowP / 32;
constexpr int kRowPitch = kRowP / 2 + 1;            // words a staged row: 64 bf16 pairs and a pad
constexpr int kRowFixedWords = kRowP * kRowPitch + 2 * kRowP;  // rows, sums, marks; then the index row
static_assert(kRowP / kRowWarps % kRowsInFlight == 0, "a warp stages its rows in whole batches");
static_assert(kRowFixedWords % 4 == 0, "the index row starts 16-byte aligned");

// e(v): nine adds from 0, or (v + v) + v.
template <bool kPairwise>
__device__ __forceinline__ float row_term(float v) {
  if (kPairwise) return (v + v) + v;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) acc += v;
  return acc;
}

// 16 bytes of a patch row: read-only, no L1 allocation (each row is read
// once).
__device__ __forceinline__ float4 load_row_quad(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <bool kPairwise>
__global__ void __launch_bounds__(kRowP* kRowKeypoints)
    row_sums_kernel(const int* __restrict__ rel_y, const float* __restrict__ patches, float* __restrict__ out,
                    int k_total, int channels, int ns, int g) {
  extern __shared__ __align__(16) uint32_t row_smem[];
  const int t = threadIdx.x % kRowP, lane = t & 31, warp = t >> 5;
  const int k = blockIdx.x * kRowKeypoints + threadIdx.x / kRowP;
  const bool live = k < k_total;  // the same for every thread of a keypoint
  uint32_t* rows = row_smem + (threadIdx.x / kRowP) * (kRowFixedWords + ((ns + 3) & ~3));
  float* sums = reinterpret_cast<float*>(rows + kRowP * kRowPitch);
  int* marked = reinterpret_cast<int*>(sums + kRowP);
  int* idx = marked + kRowP;

  // The leader's indices, and the rows they name.
  marked[t] = kRowMask ? 0 : 1;
  __syncthreads();
  if (live) {
    const int* src = rel_y + static_cast<size_t>(k / g * g) * ns;
    for (int s = t; s < ns; s += kRowP) {
      const int ry = src[s];
      idx[s] = ry;
      if (ry >= 0 && ry < kRowP) marked[ry] = 1;
    }
  }
  __syncthreads();

  // Staging: warp w takes rows w, w + 4, ..., kRowsInFlight at a time.
  if (live) {
    const float* patch = patches + static_cast<size_t>(k) * channels * kRowP * kRowP + 4 * lane;
    const int first = lane >> 4;  // which of its two words the lane stores first
#pragma unroll 1
    for (int r0 = 0; r0 < kRowP / kRowWarps; r0 += kRowsInFlight) {
      float4 v[kRowsInFlight];
      bool m[kRowsInFlight];
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const int y = (r0 + i) * kRowWarps + warp;
        m[i] = marked[y] != 0;
        v[i] = m[i] ? load_row_quad(patch + y * kRowP) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        if (!m[i]) continue;
        const uint32_t w0 = bf16_pair(v[i].x, v[i].y), w1 = bf16_pair(v[i].z, v[i].w);
        uint32_t* dst = rows + ((r0 + i) * kRowWarps + warp) * kRowPitch + 2 * lane;
        dst[first] = first ? w1 : w0;
        dst[1 - first] = first ? w0 : w1;
      }
    }
  }
  __syncthreads();

  // Thread t sums row t, x in order.
  if (live && marked[t]) {
    const uint32_t* row = rows + t * kRowPitch;
    float tot = 0.0f;
#pragma unroll 8
    for (int j = 0; j < kRowP / 2; ++j) {
      const uint32_t w = row[j];
      tot += row_term<kPairwise>(__uint_as_float(w << 16));
      tot += row_term<kPairwise>(__uint_as_float(w & 0xffff0000u));
    }
    sums[t] = tot;
  }
  __syncthreads();

  // The gather: sample s is row idx[s]'s sum (0 outside the patch), written
  // to every channel row.
  if (!live) return;
  auto value = [&](int ry) { return ry >= 0 && ry < kRowP ? sums[ry] : 0.0f; };
  float* o = out + static_cast<size_t>(k) * channels * ns;
  if ((ns & 3) == 0 && (reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
    for (int q = t; q < ns / 4; q += kRowP) {
      const int4 r = reinterpret_cast<const int4*>(idx)[q];
      const float4 v = make_float4(value(r.x), value(r.y), value(r.z), value(r.w));
      for (int c = 0; c < channels; ++c) reinterpret_cast<float4*>(o + static_cast<size_t>(c) * ns)[q] = v;
    }
  } else {
    for (int s = t; s < ns; s += kRowP) {
      const float v = value(idx[s]);
      for (int c = 0; c < channels; ++c) o[static_cast<size_t>(c) * ns + s] = v;
    }
  }
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

// ---------------------------------------------------------------------------
// The split select: mxu_split.
//
// out[k, c, s] = a0 * 0 + a1 for every channel row c, where ax adds, from
// 0.0f, channel 0, then 1, then 2 of t = (p1 + p2) + p3, the bf16x3 split
// of patch[k, c, s, x] (p1 = bf16(v), r1 = v - p1, p2 = bf16(r1), p3 =
// bf16(r1 - p2)).  The multiply is kept: the output is NaN wherever column
// 0 holds an inf or a NaN, as in the TPU body.  NS <= P: the TPU body does
// not trace above.
//
// What bounds it: bytes.  A sample reads two floats of each of its three
// rows; they share one 32-byte sector, and rows lie 512 bytes apart, so the
// card moves 32 bytes a row: 50.3 MB read and 6.3 MB written at
// exp_r3_mxu_probe.py's K=4096, NS=128, 0.0169 ms.  Design: a flat grid of
// K NS threads, one a (keypoint, sample), every thread live (one division
// a thread, none in a loop).  Each thread issues its three read-only float2
// loads before the first add, then stores the three channel rows:
// consecutive threads at consecutive s, 128 bytes a warp.  No shared
// memory: each value is read once.

constexpr int kSplitThreads = 256;
constexpr int kSplitChannels = 3;

__device__ __forceinline__ float split3_term(float v) {
  const float p1 = bf16r(v);
  const float r1 = v - p1;
  const float p2 = bf16r(r1);
  const float p3 = bf16r(r1 - p2);
  return (p1 + p2) + p3;
}

__global__ void __launch_bounds__(kSplitThreads)
    split_kernel(const float* __restrict__ patches, float* __restrict__ out, int total, int p, int ns) {
  const unsigned i = blockIdx.x * kSplitThreads + threadIdx.x;  // total < 2^31: no wrap
  if (i >= static_cast<unsigned>(total)) return;
  const unsigned k = i / ns, s = i - k * ns;
  const size_t plane = static_cast<size_t>(p) * p;
  const float* row = patches + (static_cast<size_t>(k) * kSplitChannels * p + s) * p;  // channel 0, row s
  float2 v[kSplitChannels];
#pragma unroll
  for (int c = 0; c < kSplitChannels; ++c) v[c] = __ldg(reinterpret_cast<const float2*>(row + c * plane));
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < kSplitChannels; ++c) {
    a0 = a0 + split3_term(v[c].x);
    a1 = a1 + split3_term(v[c].y);
  }
  const float r = a0 * 0.0f + a1;
  float* o = out + static_cast<size_t>(k) * kSplitChannels * ns + s;
#pragma unroll
  for (int c = 0; c < kSplitChannels; ++c) o[static_cast<size_t>(c) * ns] = r;
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

// Each export launches on `stream` and returns cudaGetLastError() (0 on
// success) or a negative code of its own.  The exp_bisect.py bodies share
// one signature: the stack, lvl, y0, x0, rel_y, rel_x, out, the stack's
// shape, the window's, K and NS.

// Returns -1 when the window is not 3 x 136 x 128 (rel_x unused, as in the
// TPU body).
extern "C" int cv_bisect_vpu_rowstage(const float* planes, const int* lvl, const int* y0, const int* x0,
                                      const int* rel_y, const int* rel_x, float* out, int n_levels, int channels,
                                      int height, int width, int ph, int pw, int k, int ns, void* stream) {
  (void)rel_x;
  if (k <= 0 || ns <= 0) return 0;
  if (channels != kColChannels || ph != kColPH || pw != kColPW) return -1;
  rowstage_kernel<<<k, kRowstageThreads, 0, static_cast<cudaStream_t>(stream)>>>(planes, lvl, y0, x0, rel_y, out,
                                                                                  n_levels, height, width, ns);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Returns 0 or a cudaError_t, or -1 when the window is not 3 x 136 x 128.
template <bool kSplit>
int launch_window_sum(const float* planes, const int* lvl, const int* y0, const int* x0, float* out, int n_levels,
                      int channels, int height, int width, int ph, int pw, int k, int ns, void* stream) {
  if (k <= 0 || ns <= 0) return 0;
  if (channels != kColChannels || ph != kColPH || pw != kColPW) return -1;
  window_sum_kernel<kSplit><<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(planes, lvl, y0, x0, out,
                                                                                    n_levels, height, width, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bisect signature (rel_y and rel_x unused, as in the TPU bodies).
#define WINDOW_SUM_EXPORT(name, split)                                                                \
  extern "C" int cv_##name(const float* planes, const int* lvl, const int* y0, const int* x0,         \
                           const int* rel_y, const int* rel_x, float* out, int n_levels, int channels, \
                           int height, int width, int ph, int pw, int k, int ns, void* stream) {       \
    (void)rel_y;                                                                                      \
    (void)rel_x;                                                                                      \
    return launch_window_sum<split>(planes, lvl, y0, x0, out, n_levels, channels, height, width, ph,  \
                                    pw, k, ns, stream);                                               \
  }

WINDOW_SUM_EXPORT(bisect_dma_only, false)
WINDOW_SUM_EXPORT(bisect_split_nomm, true)

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime; nullptr when
// libcuda has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_opted_in[2][kMaxDevices];

// Opt the kernel in to kColSmemBytes of dynamic shared memory, once per
// device.
template <bool kDynamic>
cudaError_t opt_in_smem() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_smem_opted_in[kDynamic][device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(column_sums_kernel<kDynamic>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kColSmemBytes));
    if (err != cudaSuccess) return err;
    g_smem_opted_in[kDynamic][device].store(true, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Returns 0 or a cudaError_t, or: -1 when the window is not 3 x 136 x 128,
// -2 when libcuda has no cuTensorMapEncodeTiled, -3 when it refuses the
// stack (its rows must be a multiple of 16 bytes, its base 16-byte aligned).
template <bool kDynamic>
int launch_column_sums(const float* planes, const int* lvl, const int* y0, const int* x0, const int* rel_x,
                       float* out, int n_levels, int channels, int height, int width, int ph, int pw, int k, int ns,
                       void* stream) {
  if (k <= 0 || ns <= 0) return 0;
  if (channels != kColChannels || ph != kColPH || pw != kColPW) return -1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  // Rank 4, innermost first: (W, H, C, L); one box is kColRows rows of
  // kBoxCols columns.  L2 promotion 64 B: 256 B fetched whole segments
  // around each 528-byte box row and took 7% longer (measured).
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(height),
                              static_cast<cuuint64_t>(channels), static_cast<cuuint64_t>(n_levels)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * sizeof(float);
  const cuuint64_t strides[3] = {row, row * height, row * height * channels};
  const cuuint32_t box[4] = {kBoxCols, kColRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(planes), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return -3;
  }
  const cudaError_t err = opt_in_smem<kDynamic>();
  if (err != cudaSuccess) return static_cast<int>(err);
  column_sums_kernel<kDynamic><<<k, kColPW, kColSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, planes, lvl, y0, x0, rel_x, out, n_levels, height, width, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bisect signature (rel_y unused, as in the TPU bodies).
extern "C" int cv_bisect_matmul_static(const float* planes, const int* lvl, const int* y0, const int* x0,
                                       const int* rel_y, const int* rel_x, float* out, int n_levels, int channels,
                                       int height, int width, int ph, int pw, int k, int ns, void* stream) {
  (void)rel_y;
  return launch_column_sums<false>(planes, lvl, y0, x0, rel_x, out, n_levels, channels, height, width, ph, pw, k,
                                   ns, stream);
}

extern "C" int cv_bisect_matmul_dyn_oh(const float* planes, const int* lvl, const int* y0, const int* x0,
                                       const int* rel_y, const int* rel_x, float* out, int n_levels, int channels,
                                       int height, int width, int ph, int pw, int k, int ns, void* stream) {
  (void)rel_y;
  return launch_column_sums<true>(planes, lvl, y0, x0, rel_x, out, n_levels, channels, height, width, ph, pw, k,
                                  ns, stream);
}

#define MXU_EXPORT(name)                                                                          \
  extern "C" int cv_##name(const int* rel_x, const int* rel_y, const float* patches, float* out,  \
                           int channels, int p, int k, int ns, int g, void* stream) {             \
    if (k <= 0 || ns <= 0) return 0;                                                              \
    name##_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(rel_x, rel_y, patches,   \
                                                                         out, channels, p, ns, g); \
    return static_cast<int>(cudaGetLastError());                                                  \
  }

MXU_EXPORT(mxu_onehot)
MXU_EXPORT(mxu_dma)

// The MXU_EXPORT signature (rel_x, rel_y and g unused, as in the TPU body).
// Returns -1 for a shape the kernel does not take: channels other than 3,
// an odd patch side, NS > P, or K NS >= 2^31 threads.
extern "C" int cv_mxu_split(const int* rel_x, const int* rel_y, const float* patches, float* out, int channels,
                            int p, int k, int ns, int g, void* stream) {
  (void)rel_x;
  (void)rel_y;
  (void)g;
  if (k <= 0 || ns <= 0) return 0;
  const long long total = static_cast<long long>(k) * ns;
  if (channels != kSplitChannels || (p & 1) || ns > p || total > 0x7fffffffLL) return -1;
  const unsigned blocks = static_cast<unsigned>((total + kSplitThreads - 1) / kSplitThreads);
  split_kernel<<<blocks, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(patches, out,
                                                                               static_cast<int>(total), p, ns);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Returns 0 or a cudaError_t, or -1 when the patch side is not kRowP.
template <bool kPairwise>
int launch_row_sums(const int* rel_y, const float* patches, float* out, int channels, int p, int k, int ns, int g,
                    void* stream) {
  if (k <= 0 || ns <= 0) return 0;
  if (p != kRowP) return -1;
  const size_t bytes = static_cast<size_t>(kRowKeypoints) * (kRowFixedWords + ((ns + 3) & ~3)) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(row_sums_kernel<kPairwise>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_sums_kernel<kPairwise><<<(k + kRowKeypoints - 1) / kRowKeypoints, kRowP * kRowKeypoints, bytes,
                               static_cast<cudaStream_t>(stream)>>>(rel_y, patches, out, k, channels, ns, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The MXU_EXPORT signature (rel_x unused, as in the TPU bodies).
extern "C" int cv_mxu_dots(const int* rel_x, const int* rel_y, const float* patches, float* out, int channels, int p,
                           int k, int ns, int g, void* stream) {
  (void)rel_x;
  return launch_row_sums<false>(rel_y, patches, out, channels, p, k, ns, g, stream);
}

extern "C" int cv_mxu_dotsbig(const int* rel_x, const int* rel_y, const float* patches, float* out, int channels,
                              int p, int k, int ns, int g, void* stream) {
  (void)rel_x;
  return launch_row_sums<true>(rel_y, patches, out, channels, p, k, ns, g, stream);
}
