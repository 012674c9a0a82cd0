// Gather along one axis of a 2-D float32 array (numpy's take_along_axis):
//
//   axis 1: out[r, c] = x[r, idx[r, c]]        (the lane gather)
//   axis 0: out[r, c] = x[idx[r, c], c]        (the sublane gather)
//
// x: (Rx, Cx) f32, idx and out: (R, C), contiguous; R == Rx for axis 1,
// C == Cx for axis 0; fewer than 2^31 elements each (the wrapper checks).
// A pure select, so the result is bit-exact; an index outside x yields NaN.
//
// Replaces the TPU probes experiments/exp_r3_gather_probe.py::phase_lane
// and ::phase_sublane (Mosaic's in-register dynamic gather along lanes and
// along sublanes, each a one-block Pallas kernel on a (128, 512) tile).
// On Hopper neither axis is special: both are a load through L1/L2 at a
// computed address.
//
// What bounds it: bytes (read idx, read x, write out: 768 KB at the
// probe's (128, 512), 0.2 us at 3.35 TB/s), so at that size the launch and
// the few hundred cycles one thread's chain of loads takes.  Design: a 2-D
// grid of 4-row x 128-column tiles, no division by a runtime width, 32-bit
// index arithmetic; each thread writes 4 consecutive outputs, with one
// 16-byte load of idx and one 16-byte store of out when the rows allow it
// (a scalar path otherwise); x is read through the read-only cache, the
// four loads of a thread independent of each other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 32;  // threads along a row, 4 outputs each
constexpr int kTileRows = 4;

template <int kAxis, bool kVector>
__global__ void __launch_bounds__(kTileCols * kTileRows) take_along_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out, int rows, int cols,
    int x_rows, int x_cols) {
  const int c0 = (blockIdx.x * kTileCols + threadIdx.x) * 4;
  if (c0 >= cols) return;
  for (int r = blockIdx.y * kTileRows + threadIdx.y; r < rows; r += gridDim.y * kTileRows) {
    const int base = r * cols + c0;
    int j[4];
    if (kVector) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + base));
      j[0] = v.x;
      j[1] = v.y;
      j[2] = v.z;
      j[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) j[k] = c0 + k < cols ? __ldg(idx + base + k) : 0;
    }
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // A lane past the row's end (scalar path only) reads nothing: on axis
      // 0 its column c0 + k would lie outside x.
      const unsigned jk = static_cast<unsigned>(j[k]);
      const bool ok = (kVector || c0 + k < cols) &&
                      (kAxis == 1 ? jk < static_cast<unsigned>(x_cols) : jk < static_cast<unsigned>(x_rows));
      const int jj = ok ? j[k] : 0;
      const int src = kAxis == 1 ? r * x_cols + jj : jj * x_cols + c0 + k;
      o[k] = ok ? __ldg(x + src) : __int_as_float(0x7fc00000);
    }
    if (kVector) {
      *reinterpret_cast<float4*>(out + base) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 + k < cols) out[base + k] = o[k];
      }
    }
  }
}

template <int kAxis>
void launch(const float* x, const int* idx, float* out, int rows, int cols, int x_rows, int x_cols,
            cudaStream_t stream) {
  const dim3 block(kTileCols, kTileRows);
  const int row_tiles = (rows + kTileRows - 1) / kTileRows;
  const dim3 grid((cols + 4 * kTileCols - 1) / (4 * kTileCols), row_tiles < 65535 ? row_tiles : 65535);
  const bool vector = cols % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vector) {
    take_along_kernel<kAxis, true><<<grid, block, 0, stream>>>(x, idx, out, rows, cols, x_rows, x_cols);
  } else {
    take_along_kernel<kAxis, false><<<grid, block, 0, stream>>>(x, idx, out, rows, cols, x_rows, x_cols);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cv_take_along(const float* x, const int* idx, float* out, int rows, int cols, int x_rows,
                             int x_cols, int axis, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    launch<1>(x, idx, out, rows, cols, x_rows, x_cols, s);
  } else {
    launch<0>(x, idx, out, rows, cols, x_rows, x_cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}
