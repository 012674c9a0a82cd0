// The trigonometry probe of the fused describe: four float32 functions of
// two rows a, b of N values,
//
//   out[0] = atan2(a, b)   out[1] = cos(a)   out[2] = sin(a)
//   out[3] = mod(a + 2pi, 2pi), the floored modulo: fmodf, then + 2pi where
//            the remainder is nonzero and its sign differs from 2pi's
//            (numpy's and torch.remainder's rule)
//
// with 2pi = float32(2 pi) passed by the caller.
//
// Replaces the TPU probe experiments/exp_r5_pfused.py::phase_trig, which
// asked whether Mosaic's in-kernel atan2/cos/sin round as XLA's do outside
// a kernel.  The same question on Hopper: do nvcc's atan2f/cosf/sinf round
// as PyTorch's CUDA kernels do?  So this file is built with the default
// math flags (no --use_fast_math); chip_smoke.py holds it to torch.atan2,
// torch.cos, torch.sin and torch.remainder within 2 ulp and prints whether
// each is bit-equal.
//
// What bounds it: nothing; at the probe's (2, 128) input it is one launch.
// One thread per column.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void trig_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  float* __restrict__ out, int n, float two_pi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i];
  out[i] = atan2f(x, b[i]);
  out[n + i] = cosf(x);
  out[2 * n + i] = sinf(x);
  const float y = x + two_pi;
  float m = fmodf(y, two_pi);
  if (m != 0.0f && ((m < 0.0f) != (two_pi < 0.0f))) m = m + two_pi;
  out[3 * n + i] = m;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cv_trig_probe(const float* a, const float* b, float* out, int n, float two_pi,
                             void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  trig_probe_kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n, two_pi);
  return static_cast<int>(cudaGetLastError());
}
