// Describe-stage sample select over window-sorted keypoint groups.
//
//   out[t * G + j, c - c0, s] =
//       planes[win_lvl[t], c, 128 * win_ty[t] + rel_y[t * G + j, s],
//                             128 * win_tx[t] + rel_x[t * G + j, s]]
//   for j < n_active[t], and 0 for the group's other slots.
//
// planes: (L, C, Hp, Wp) f32 contiguous; win_lvl, win_ty, win_tx, n_active:
// (NG,) i32; rel_x, rel_y: (NG * G, NS) i32 in [0, 256); out: (NG * G,
// C - c0, NS) f32.  A pure select, so the result is bit-exact; an index
// outside the stack reads nothing and yields NaN.
//
// Replaces cv_tpu/akaze/pallas_mldb.py::select_samples_groups (kernel
// _select_kernel_groups).  On the TPU each grid step DMAs the group's
// 256x256 window as four 128x128 quadrant blocks into VMEM, and
// window-sorted groups let consecutive steps skip repeated DMAs; `w`
// groups share a step.  Here `w` only sets the table layout (t is the
// table position whatever `w` is): one block per group.
//
// What bounds it: scattered 4-byte reads, as in select_samples.cu.  The
// whole B=2 dense stack (26 x 3 x 512 x 1408 f32, 225 MB) does not sit in
// L2, but a group's samples lie in one 256x256 window (768 KB over three
// channels) and the groups come sorted by window, so neighbouring blocks
// read the same window.  Threads cover (slot, sample) pairs, so one
// block's loads and its coalesced stores run along s.  A shared-memory
// window (768 KB) does not fit in a block and is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // slots per group (pallas_mldb.G)

__global__ void __launch_bounds__(kThreads) select_groups_kernel(
    const float* __restrict__ planes, const int* __restrict__ win_lvl,
    const int* __restrict__ win_ty, const int* __restrict__ win_tx,
    const int* __restrict__ n_active, const int* __restrict__ rel_x,
    const int* __restrict__ rel_y, float* __restrict__ out, int n_levels,
    int channels, int height, int width, int ns, int c0) {
  const int t = blockIdx.x;
  const int l = __ldg(win_lvl + t);
  const int yb = 128 * __ldg(win_ty + t);
  const int xb = 128 * __ldg(win_tx + t);
  const int live = __ldg(n_active + t);
  const size_t plane = static_cast<size_t>(height) * width;
  const bool level_ok = l >= 0 && l < n_levels;
  const float* base =
      planes + static_cast<size_t>(level_ok ? l : 0) * channels * plane;
  const int nc = channels - c0;
  for (int idx = threadIdx.x; idx < kGroup * ns; idx += blockDim.x) {
    const int j = idx / ns;
    const int s = idx - j * ns;
    const size_t slot = static_cast<size_t>(t) * kGroup + j;
    float* o = out + slot * nc * ns + s;
    if (j >= live) {
      for (int c = 0; c < nc; ++c) o[static_cast<size_t>(c) * ns] = 0.0f;
      continue;
    }
    const int y = yb + __ldg(rel_y + slot * ns + s);
    const int x = xb + __ldg(rel_x + slot * ns + s);
    const bool ok = level_ok && y >= 0 && y < height && x >= 0 && x < width;
    const size_t off = ok ? static_cast<size_t>(y) * width + x : 0;
    for (int c = c0; c < channels; ++c) {
      o[static_cast<size_t>(c - c0) * ns] =
          ok ? __ldg(base + c * plane + off) : __int_as_float(0x7fc00000);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cv_select_groups(const float* planes, const int* win_lvl,
                                const int* win_ty, const int* win_tx,
                                const int* n_active, const int* rel_x,
                                const int* rel_y, float* out, int n_levels,
                                int channels, int height, int width,
                                int n_groups, int ns, int c0, void* stream) {
  if (n_groups <= 0 || ns <= 0) return 0;
  select_groups_kernel<<<n_groups, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      planes, win_lvl, win_ty, win_tx, n_active, rel_x, rel_y, out, n_levels,
      channels, height, width, ns, c0);
  return static_cast<int>(cudaGetLastError());
}
