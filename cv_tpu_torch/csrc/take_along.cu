// Gather along one axis of a 2-D float32 array (numpy's take_along_axis):
//
//   axis 1: out[r, c] = x[r, idx[r, c]]        (the lane gather)
//   axis 0: out[r, c] = x[idx[r, c], c]        (the sublane gather)
//
// x: (Rx, Cx) f32, idx and out: (R, C), contiguous; R == Rx for axis 1,
// C == Cx for axis 0.  A pure select, so the result is bit-exact; an index
// outside x yields NaN.
//
// Replaces the TPU probes experiments/exp_r3_gather_probe.py::phase_lane
// and ::phase_sublane (Mosaic's in-register dynamic gather along lanes and
// along sublanes, each a one-block Pallas kernel on a (128, 512) tile).
// On Hopper neither axis is special: both are a load through L1/L2 at a
// computed address.
//
// What bounds it: bytes (read idx, read x, write out; 768 KB at the
// probe's shape, well under a microsecond at 3.35 TB/s), so at that size
// the launch itself.  Design: one thread per output element; idx and out
// are read and written coalesced, x is read through the read-only cache.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) take_along_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
    int rows, int cols, int x_rows, int x_cols, int axis) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * cols) return;
  const int r = static_cast<int>(i / cols);
  const int c = static_cast<int>(i % cols);
  const int j = __ldg(idx + i);
  const bool ok = axis == 1 ? (j >= 0 && j < x_cols) : (j >= 0 && j < x_rows);
  const size_t src = axis == 1 ? static_cast<size_t>(r) * x_cols + j : static_cast<size_t>(j) * x_cols + c;
  out[i] = ok ? __ldg(x + src) : __int_as_float(0x7fc00000);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cv_take_along(const float* x, const int* idx, float* out, int rows, int cols,
                             int x_rows, int x_cols, int axis, void* stream) {
  const size_t n = static_cast<size_t>(rows) * cols;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  take_along_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, rows, cols, x_rows, x_cols, axis);
  return static_cast<int>(cudaGetLastError());
}
