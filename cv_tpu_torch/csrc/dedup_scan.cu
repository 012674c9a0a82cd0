// The AKAZE detector's sequential cross-scale dedup, one block per frame.
//
// For each frame b, candidates j < n_steps[b] are visited in order (they
// come evolution-major, row-major, as the reference iterates them).  A
// valid candidate looks for the FIRST cache entry i (slot order) of its own
// or the previous evolution with (px_cmp[j] - x_i)^2 + (py_cmp[j] - y_i)^2
// <= size2[j].  None: it is appended.  One with a lower response:
// it replaces that entry in place.  Otherwise it is dropped.  Then the
// upper-scale pass drops entry i when a later entry of evolution
// class(i) + 1 lies within size2 of i's candidate and responds at least as
// strongly.  out[b, src_i] = 1 for the entries that remain, 0 elsewhere;
// slot_out[b, src_i] = i (the entry's cache slot) for the entries that
// remain, -1 elsewhere, when the caller asks for it: the reference's
// keypoint order is the cache's slot order, which a later candidate that
// replaces an earlier one takes over.
//
// Inputs are (B, C) rows: px_cmp, py_cmp, px_store, py_store, resp, size2
// f32; class_id i32; valid u8; n_steps (B,) i32; out (B, C) u8; slot_out
// (B, C) i32 or null.
//
// Replaces cv_tpu/akaze/extrema.py::dedup_scan_device, a vmapped
// lax.while_loop (not a Pallas kernel).
//
// What bounds it: the steps form one dependent chain per frame, so a step's
// latency is the cost; the bytes and operations are microseconds.  The
// cache (a 16-byte slot: x, y, response, class; and the source index: 20 B
// per slot, capacity C) lives in dynamic shared memory when it fits beside
// the static ones in the opt-in limit (C = 8192 is 160 KB; up to ~10,800
// slots on an H100), else in a global buffer allocated in stream order.
//
// Design, per step:
// * Slot i belongs to thread i % kThreads (512, the fastest of 128, 256
//   and 512 at the engine's dense and SfM calls): only its owner reads or
//   writes it while the scan runs, so the cache needs no barrier of its own.
// * The scan: each thread walks its slots in order, one 16-byte load a
//   slot, checks the class (cls or cls - 1) and the distance, and stops at
//   its first close slot; a warp min-reduces them (redux.sync).
// * One barrier a step.  Lane 0 publishes its warp's minimum in
//   s_first[parity], parity toggling each valid step.  After the barrier
//   every thread folds the kWarps entries itself (one redux) and keeps
//   `first` and `count` in registers; no thread-0 section, no shared count.
//   The owner of the append slot, or of `first`, writes the slot (only it
//   needs the response at `first`, which it wrote itself).  The double
//   buffer makes one barrier enough: the next write to s_first[parity] is
//   two valid steps on, behind the next step's barrier, which no thread
//   passes before it has read this step's entries.
// * Candidates staged in shared memory.  A chunk of kChunk steps of the
//   eight inputs is loaded into registers one chunk ahead (the loads are in
//   flight while the current chunk runs) and stored into one of two shared
//   buffers at the chunk's start, behind one barrier per chunk.  Each step
//   reads the next step's candidate with broadcast shared loads, so the
//   loads are off the chain.  (cp.async's smallest copy is 4 bytes, and the
//   u8 valid row is not 4-byte aligned.)
// * The upper-scale pass walks, for each slot, only the slots between the
//   first and the last slot of class class(i) + 1 (per class below
//   kClassTable, from shared atomics), from slot i + 1 on.
// Measured and not kept (scripts/time_engine_calls.py at the engine's
// calls, each slower than this scan): a class window that starts the scan
// at the lowest slot of the two classes (the engine's replacement chains
// carry early slots up through the classes, so it starts near slot 0); a
// window kept per thread as a register mask of its slots of the two
// classes, rebuilt on a class change; per-warp masks of the 32-slot chunks
// each class has reached; loading several slots at once.  The windows visit
// fewer slots, but through a dependent chain (bit scan or ballot, address,
// load) that costs more than the strided walk's independent loads.  An
// upper pass that gathers each class's slots by a counting sort took the
// same time as the ranges and 4 B more a slot.
// cv_dedup_scan_floor launches the same chain with the cache work taken out
// (staged reads, warp reduce, barrier, fold, decision): its time over the
// steps is the least a one-block chain of these steps can take.
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
constexpr int kChunk = 256;  // candidates staged at a time
constexpr int kPerThread = (kChunk + kThreads - 1) / kThreads;
constexpr int kClassTable = 64;  // classes whose slot range the upper pass reads

static_assert(kThreads % 32 == 0 && kWarps <= 32 && (kThreads & (kThreads - 1)) == 0,
              "kThreads: a power of two, at most 1024");

// A frame's cache in 16-byte words: C slots of 16 B, then C source indices.
__host__ __device__ inline size_t cache_words(int c) { return static_cast<size_t>(c) + (static_cast<size_t>(c) + 3) / 4; }

struct Stage {  // kChunk candidates, one array per input
  float pxc[kChunk], pyc[kChunk], pxs[kChunk], pys[kChunk], resp[kChunk], s2[kChunk];
  int cls[kChunk];
  uint8_t ok[kChunk];
};

struct Inputs {
  const float* px_cmp;
  const float* py_cmp;
  const float* px_store;
  const float* py_store;
  const float* resp;
  const int* class_id;
  const float* size2;
  const uint8_t* valid;
};

// One thread's share of a chunk, held in registers between its load and
// its store into shared memory.
struct Fetched {
  float pxc[kPerThread], pyc[kPerThread], pxs[kPerThread], pys[kPerThread], resp[kPerThread], s2[kPerThread];
  int cls[kPerThread];
  uint8_t ok[kPerThread];

  __device__ void load(const Inputs& in, size_t row, int start, int steps, int tid) {
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      const int e = p * kThreads + tid;
      const int j = start + e;
      const bool live = e < kChunk && j < steps;
      const size_t at = row + (live ? j : 0);
      pxc[p] = __ldg(in.px_cmp + at);
      pyc[p] = __ldg(in.py_cmp + at);
      pxs[p] = __ldg(in.px_store + at);
      pys[p] = __ldg(in.py_store + at);
      resp[p] = __ldg(in.resp + at);
      s2[p] = __ldg(in.size2 + at);
      cls[p] = __ldg(in.class_id + at);
      ok[p] = live ? __ldg(in.valid + at) : 0;
    }
  }

  __device__ void store(Stage& st, int tid) const {
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      const int e = p * kThreads + tid;
      if (e < kChunk) {
        st.pxc[e] = pxc[p];
        st.pyc[e] = pyc[p];
        st.pxs[e] = pxs[p];
        st.pys[e] = pys[p];
        st.resp[e] = resp[p];
        st.s2[e] = s2[p];
        st.cls[e] = cls[p];
        st.ok[e] = ok[p];
      }
    }
  }
};

// One staged candidate in registers (broadcast shared loads).
struct Cand {
  float pxc, pyc, pxs, pys, resp, s2;
  int cls;
  bool ok;

  __device__ static Cand at(const Stage& st, int q) {
    return Cand{st.pxc[q], st.pyc[q], st.pxs[q], st.pys[q], st.resp[q], st.s2[q], st.cls[q], st.ok[q] != 0};
  }
};

// A cache slot: position, response and class in one 16-byte word, so a
// scan reads a slot with one load.
struct __align__(16) Slot {
  float x, y, resp;
  int cls;
};

template <bool kFloor>
__global__ void __launch_bounds__(kThreads) dedup_scan_kernel(
    Inputs in, const int* __restrict__ n_steps, float* __restrict__ scratch,
    uint8_t* __restrict__ out, int* __restrict__ slot_out, int c, int use_shared) {
  extern __shared__ float4 smem[];
  __shared__ Stage stage[2];
  __shared__ int s_first[2][kWarps];
  __shared__ int s_cls_lo[kClassTable];  // the first slot of each class
  __shared__ int s_cls_hi[kClassTable];  // and its last
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(b) * c;
  const size_t words = cache_words(c);
  float4* base = use_shared ? smem : reinterpret_cast<float4*>(scratch) + static_cast<size_t>(b) * words;
  Slot* slots = reinterpret_cast<Slot*>(base);
  int* csrc = reinterpret_cast<int*>(base + c);

  for (int i = tid; i < c; i += kThreads) {
    out[row + i] = 0;
    if (slot_out != nullptr) slot_out[row + i] = -1;
  }
  for (int i = tid; i < kClassTable; i += kThreads) {
    s_cls_lo[i] = INT_MAX;
    s_cls_hi[i] = -1;
  }
  const int steps = min(max(n_steps[b], 0), c);

  // Block-uniform state, kept in every thread's registers.
  int count = 0;  // slots in use
  int parity = 0;

  Fetched next;
  next.load(in, row, 0, steps, tid);
  for (int start = 0, chunk = 0; start < steps; start += kChunk, ++chunk) {
    Stage& st = stage[chunk & 1];
    next.store(st, tid);
    if (start + kChunk < steps) next.load(in, row, start + kChunk, steps, tid);  // in flight during this chunk
    __syncthreads();
    const int n = min(kChunk, steps - start);
    Cand ahead = Cand::at(st, 0);
    for (int q = 0; q < n; ++q) {
      const Cand cand = ahead;
      if (q + 1 < n) ahead = Cand::at(st, q + 1);  // off the chain: ready by the next step
      if (!cand.ok) continue;  // block-uniform
      const int cls = cand.cls;
      int first = INT_MAX;
      if (!kFloor) {
        // The thread's slots ascend, so its first close slot is its minimum.
        for (int i = tid; i < count; i += kThreads) {
          const Slot v = slots[i];
          const float dx = cand.pxc - v.x;
          const float dy = cand.pyc - v.y;
          if ((v.cls == cls || v.cls == cls - 1) && dx * dx + dy * dy <= cand.s2) {
            first = i;
            break;
          }
        }
        first = __reduce_min_sync(0xffffffffu, first);
      }
      if (lane == 0) s_first[parity][warp] = first;
      __syncthreads();
      first = __reduce_min_sync(0xffffffffu, lane < kWarps ? s_first[parity][lane] : INT_MAX);
      const bool exists = first != INT_MAX;
      if (!kFloor) {
        const int slot = exists ? first : count;
        if (tid == (slot & (kThreads - 1)) && (!exists || cand.resp > slots[slot].resp)) {
          slots[slot] = Slot{cand.pxs, cand.pys, cand.resp, cls};
          csrc[slot] = start + q;
        }
      }
      count += exists ? 0 : 1;
      parity ^= 1;
    }
  }
  __syncthreads();  // every slot written; the class table initialised
  if (kFloor) return;

  // Upper-scale suppression over the final cache.
  for (int i = tid; i < count; i += kThreads) {
    const int ci = slots[i].cls;
    if (ci >= 0 && ci < kClassTable) {
      atomicMin(&s_cls_lo[ci], i);
      atomicMax(&s_cls_hi[ci], i);
    }
  }
  __syncthreads();
  for (int i = tid; i < count; i += kThreads) {
    const Slot si = slots[i];
    const int up = si.cls + 1;
    int q0 = i + 1;
    int q1 = count - 1;
    if (up >= 0 && up < kClassTable) {
      q0 = max(q0, s_cls_lo[up]);
      q1 = min(q1, s_cls_hi[up]);
    }
    const int src = csrc[i];
    const float s2i = __ldg(in.size2 + row + src);
    bool hit = false;
    for (int q = q0; q <= q1 && !hit; ++q) {
      const Slot sq = slots[q];
      const float dx = si.x - sq.x;
      const float dy = si.y - sq.y;
      hit = sq.cls == up && dx * dx + dy * dy <= s2i && si.resp <= sq.resp;
    }
    out[row + src] = hit ? 0 : 1;  // used slots hold distinct candidates
    if (slot_out != nullptr) slot_out[row + src] = hit ? -1 : i;
  }
}

// The dynamic shared memory a block may take beside the kernel's static
// ones, per device and variant.  The first call on a device queries it and
// opts the kernel in to all of it, so later launches set nothing.  Racing
// first calls store the same value.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_dyn_limit[2][kMaxDevices];  // 0: not yet queried

template <bool kFloor>
cudaError_t dyn_shared_limit(size_t* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  long long got = g_dyn_limit[kFloor][device].load(std::memory_order_relaxed);
  if (got == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dedup_scan_kernel<kFloor>);
    if (err != cudaSuccess) return err;
    got = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(dedup_scan_kernel<kFloor>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(got));
    if (err != cudaSuccess) return err;
    g_dyn_limit[kFloor][device].store(got, std::memory_order_relaxed);
  }
  *limit = static_cast<size_t>(got);
  return cudaSuccess;
}

template <bool kFloor>
int launch(const Inputs& in, const int* n_steps, uint8_t* out, int* slot_out, int b, int c, int max_shared_slots,
           void* stream) {
  if (b <= 0 || c <= 0) return 0;
  size_t limit = 0;
  cudaError_t err = dyn_shared_limit<kFloor>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t cache_bytes = cache_words(c) * sizeof(float4);
  const bool use_shared = (max_shared_slots < 0 || c <= max_shared_slots) && cache_bytes <= limit;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = nullptr;
  if (!use_shared) {
    err = cudaMallocAsync(reinterpret_cast<void**>(&scratch), cache_bytes * b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dedup_scan_kernel<kFloor><<<b, kThreads, use_shared ? cache_bytes : 0, s>>>(in, n_steps, scratch, out, slot_out,
                                                                             c, use_shared);
  err = cudaGetLastError();
  if (scratch != nullptr) {
    const cudaError_t free_err = cudaFreeAsync(scratch, s);
    if (err == cudaSuccess) err = free_err;
  }
  return static_cast<int>(err);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error (0 on success).
// The cache (24 B a slot, C slots a frame) lives in shared memory when
// C <= max_shared_slots and it fits in the block's opt-in limit; otherwise
// in a buffer of B such caches allocated and freed in stream order around
// the launch.  max_shared_slots < 0 means no cap; 0 forces global memory.
extern "C" int cv_dedup_scan(const float* px_cmp, const float* py_cmp,
                             const float* px_store, const float* py_store,
                             const float* resp, const int* class_id,
                             const float* size2, const uint8_t* valid,
                             const int* n_steps, uint8_t* out, int b, int c,
                             int max_shared_slots, void* stream) {
  const Inputs in{px_cmp, py_cmp, px_store, py_store, resp, class_id, size2, valid};
  return launch<false>(in, n_steps, out, nullptr, b, c, max_shared_slots, stream);
}

// cv_dedup_scan with the slot output: slot_out (B, C) i32 receives each
// remaining entry's cache slot at its candidate's place, -1 elsewhere.
extern "C" int cv_dedup_scan_slots(const float* px_cmp, const float* py_cmp,
                                   const float* px_store, const float* py_store,
                                   const float* resp, const int* class_id,
                                   const float* size2, const uint8_t* valid,
                                   const int* n_steps, uint8_t* out, int b, int c,
                                   int max_shared_slots, void* stream, int* slot_out) {
  const Inputs in{px_cmp, py_cmp, px_store, py_store, resp, class_id, size2, valid};
  return launch<false>(in, n_steps, out, slot_out, b, c, max_shared_slots, stream);
}

// The chain floor: the same launch with the cache work taken out (no scan,
// no write, no upper-scale pass; `out` is only zeroed).  A measurement, not
// a dedup.
extern "C" int cv_dedup_scan_floor(const float* px_cmp, const float* py_cmp,
                                   const float* px_store, const float* py_store,
                                   const float* resp, const int* class_id,
                                   const float* size2, const uint8_t* valid,
                                   const int* n_steps, uint8_t* out, int b, int c,
                                   int max_shared_slots, void* stream) {
  const Inputs in{px_cmp, py_cmp, px_store, py_store, resp, class_id, size2, valid};
  return launch<true>(in, n_steps, out, nullptr, b, c, max_shared_slots, stream);
}
