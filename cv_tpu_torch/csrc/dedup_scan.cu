// The AKAZE detector's sequential cross-scale dedup, one block per frame.
//
// For each frame b, candidates j < n_steps[b] are visited in order (they
// come evolution-major, row-major, as the reference iterates them).  A
// valid candidate looks for the FIRST cache entry i (slot order) of its own
// or the previous evolution with (px_cmp[j] - cpx[i])^2 + (py_cmp[j] -
// cpy[i])^2 <= size2[j].  None: it is appended.  One with a lower response:
// it replaces that entry in place.  Otherwise it is dropped.  Then the
// upper-scale pass drops entry i when a later entry of evolution
// class(i) + 1 lies within size2 of i's candidate and responds at least as
// strongly.  out[b, csrc[i]] = 1 for the entries that remain, 0 elsewhere.
//
// Inputs are (B, C) rows: px_cmp, py_cmp, px_store, py_store, resp, size2
// f32; class_id i32; valid u8; n_steps (B,) i32; out (B, C) u8.
//
// Replaces cv_tpu/akaze/extrema.py::dedup_scan_device, a vmapped
// lax.while_loop (not a Pallas kernel).  The port ran it as a Python loop
// of ~35 small kernels per candidate (0.42 ms per step on the card).
//
// What bounds it: the steps are sequential, so the cost is the per-step
// latency: one pass over the cache and two block barriers.  Design: the
// cache (cpx, cpy, cresp f32; ccls, csrc i32; 20 B per slot, capacity C)
// lives in dynamic shared memory when 20 * C bytes fit beside the static
// ones in the opt-in limit (C = 8192 is 160 KB; up to ~11,600 slots on an
// H100), else in a global buffer allocated in stream order.
// Threads stride over the cache slots; each stops at its first close slot,
// a warp and then a block min-reduce finds the first one overall, and
// thread 0 applies the replace / insert.  The upper-scale pass gives each
// thread its own slots and walks the later ones.
//
// Build with --fmad=false: dx * dx + dy * dy must round as the plain
// version's separate multiplies and add do.

#include <atomic>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) dedup_scan_kernel(
    const float* __restrict__ px_cmp, const float* __restrict__ py_cmp,
    const float* __restrict__ px_store, const float* __restrict__ py_store,
    const float* __restrict__ resp, const int* __restrict__ class_id,
    const float* __restrict__ size2, const uint8_t* __restrict__ valid,
    const int* __restrict__ n_steps, float* __restrict__ scratch,
    uint8_t* __restrict__ out, int c, int use_shared) {
  extern __shared__ float smem[];
  __shared__ int s_warp_min[kWarps];
  __shared__ int s_count;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(b) * c;
  float* base = use_shared ? smem : scratch + row * 5;
  float* cpx = base;
  float* cpy = base + c;
  float* cresp = base + 2 * static_cast<size_t>(c);
  int* ccls = reinterpret_cast<int*>(base + 3 * static_cast<size_t>(c));
  int* csrc = reinterpret_cast<int*>(base + 4 * static_cast<size_t>(c));

  for (int i = tid; i < c; i += kThreads) out[row + i] = 0;
  if (tid == 0) s_count = 0;
  __syncthreads();
  const int steps = min(max(n_steps[b], 0), c);
  int count = 0;  // block-uniform: every thread reads s_count after a barrier

  for (int j = 0; j < steps; ++j) {
    if (!valid[row + j]) continue;  // block-uniform
    const float pxc = px_cmp[row + j];
    const float pyc = py_cmp[row + j];
    const float s2 = size2[row + j];
    const int cls = class_id[row + j];
    int first = INT_MAX;
    for (int i = tid; i < count; i += kThreads) {
      const int ci = ccls[i];
      if (ci == cls || ci == cls - 1) {
        const float dx = pxc - cpx[i];
        const float dy = pyc - cpy[i];
        if (dx * dx + dy * dy <= s2) {
          first = i;  // the thread's slots ascend: its first is its minimum
          break;
        }
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    if (lane == 0) s_warp_min[warp] = first;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) first = min(first, s_warp_min[w]);
      const float r = resp[row + j];
      const bool exists = first != INT_MAX;
      const bool is_rep = exists && r > cresp[first];
      if (!exists || is_rep) {
        const int slot = is_rep ? first : count;
        cpx[slot] = px_store[row + j];
        cpy[slot] = py_store[row + j];
        cresp[slot] = r;
        ccls[slot] = cls;
        csrc[slot] = j;
        if (!is_rep) s_count = count + 1;
      }
    }
    __syncthreads();
    count = s_count;
  }

  // Upper-scale suppression over the final cache.
  for (int i = tid; i < count; i += kThreads) {
    const int up = ccls[i] + 1;
    const float xi = cpx[i];
    const float yi = cpy[i];
    const float ri = cresp[i];
    const int src = csrc[i];
    const float s2i = size2[row + src];
    bool hit = false;
    for (int q = i + 1; q < count; ++q) {
      if (ccls[q] == up) {
        const float dx = xi - cpx[q];
        const float dy = yi - cpy[q];
        if (dx * dx + dy * dy <= s2i && ri <= cresp[q]) {
          hit = true;
          break;
        }
      }
    }
    out[row + src] = hit ? 0 : 1;  // used slots hold distinct candidates
  }
}

// The dynamic shared memory a block may take beside the kernel's static
// ones, per device.  The first call on a device queries it and opts the
// kernel in to all of it, so later launches set nothing.  Racing first
// calls store the same value.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_dyn_limit[kMaxDevices];  // 0: not yet queried

cudaError_t dyn_shared_limit(size_t* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  long long got = g_dyn_limit[device].load(std::memory_order_relaxed);
  if (got == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dedup_scan_kernel);
    if (err != cudaSuccess) return err;
    got = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(dedup_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(got));
    if (err != cudaSuccess) return err;
    g_dyn_limit[device].store(got, std::memory_order_relaxed);
  }
  *limit = static_cast<size_t>(got);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns the first CUDA error (0 on success).
// The cache (20 B a slot, C slots a frame) lives in shared memory when
// C <= max_shared_slots and it fits in the block's opt-in limit; otherwise
// in a B * 5 * C word buffer allocated and freed in stream order around
// the launch.  max_shared_slots < 0 means no cap; 0 forces global memory.
extern "C" int cv_dedup_scan(const float* px_cmp, const float* py_cmp,
                             const float* px_store, const float* py_store,
                             const float* resp, const int* class_id,
                             const float* size2, const uint8_t* valid,
                             const int* n_steps, uint8_t* out, int b, int c,
                             int max_shared_slots, void* stream) {
  if (b <= 0 || c <= 0) return 0;
  size_t limit = 0;
  cudaError_t err = dyn_shared_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t cache_bytes = static_cast<size_t>(c) * 5 * sizeof(float);
  const bool use_shared = (max_shared_slots < 0 || c <= max_shared_slots) && cache_bytes <= limit;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = nullptr;
  if (!use_shared) {
    err = cudaMallocAsync(reinterpret_cast<void**>(&scratch), cache_bytes * b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dedup_scan_kernel<<<b, kThreads, use_shared ? cache_bytes : 0, s>>>(
      px_cmp, py_cmp, px_store, py_store, resp, class_id, size2, valid,
      n_steps, scratch, out, c, use_shared);
  err = cudaGetLastError();
  if (scratch != nullptr) {
    const cudaError_t free_err = cudaFreeAsync(scratch, s);
    if (err == cudaSuccess) err = free_err;
  }
  return static_cast<int>(err);
}
