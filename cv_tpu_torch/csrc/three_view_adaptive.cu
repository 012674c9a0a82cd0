// K adaptive three-view loops, a fixed number of iterations each: one
// thread block per problem, the whole loop in one launch.
//
// Replaces cv_tpu/optimize/pallas_loop.py::three_view_adaptive_resident
// (the Pallas kernel _tv_kernel), which computes exactly the engine's
// _three_view_batch_device; reference three_view_optimizer.rs:203-272.
// Plain version: cv_tpu_torch/optimize/optimizers.py::three_view_adaptive_optimize_l2.
//
// What bounds it on the H100: step latency.  Each problem holds N = 64
// landmarks (576 floats); a step is ~400 flops and three triangulations per
// landmark plus one 16-value reduction, repeated ``iterations`` (1000)
// times.  On a TPU a Pallas grid runs the K problems one after another;
// here the K problems (at most 64) are K blocks that run at once on
// separate SMs.  Inside a block one thread owns one landmark (64 threads),
// tangents stay in registers, the masked sums and tangent-norm sums of
// both poses reduce through warp shuffles and shared memory, and every
// thread applies the same adaptive update (rate |mean| / mean norm,
// non-finite rates set to 0) to its register copy of the two poses.
//
// Invalid rows are skipped, not added as zeros, so rows of padding change
// no bit of the result.

#include "pose_loops.cuh"

namespace {

__device__ __forceinline__ void adaptive_delta(const float* sums, float inv_len, V3* dt, V3* dr) {
  // sums: translation sum (3), rotation sum (3), translation norm sum,
  // rotation norm sum.
  const V3 mean_t = v3(sums[0] * inv_len, sums[1] * inv_len, sums[2] * inv_len);
  const V3 mean_r = v3(sums[3] * inv_len, sums[4] * inv_len, sums[5] * inv_len);
  const float tstd = sums[6] * inv_len;
  const float rstd = sums[7] * inv_len;
  float trate = v3_norm(mean_t) / tstd;
  float rrate = v3_norm(mean_r) / rstd;
  trate = f_finite(trate) ? trate : 0.0f;
  rrate = f_finite(rrate) ? rrate : 0.0f;
  *dt = v3_scale(mean_t, trate);
  *dr = v3_scale(mean_r, rrate);
}

__global__ void tv_adaptive_kernel(const float* __restrict__ poses_in, const float* __restrict__ obs,
                                   const unsigned char* __restrict__ valid,
                                   float* __restrict__ poses_out, int n, int iterations) {
  __shared__ float red[33 * 16];
  const int p = blockIdx.x;
  const float* pobs = obs + static_cast<size_t>(p) * n * 9;
  const unsigned char* pvalid = valid + static_cast<size_t>(p) * n;
  const float inv_len = 1.0f / fmaxf(block_count(pvalid, n, red), 1.0f);
  float rf[9], tf[3], rs[9], ts[3];
  const float* pin = poses_in + 24 * p;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    rf[i] = pin[i];
    rs[i] = pin[12 + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    tf[i] = pin[9 + i];
    ts[i] = pin[21 + i];
  }
  for (int it = 0; it < iterations; ++it) {
    // Per pose: translation sum, rotation sum, translation-norm sum,
    // rotation-norm sum (8 values), first pose then second.
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (!pvalid[i]) continue;
      V3 g[4];  // first_trans, first_rot, second_trans, second_rot
      tv_tangent_rows(rf, tf, rs, ts, pobs + 9 * i, &g[0], &g[1], &g[2], &g[3]);
#pragma unroll
      for (int pose = 0; pose < 2; ++pose) {
        const V3 tg = g[2 * pose], rg = g[2 * pose + 1];
        float* a = acc + 8 * pose;
        if (!v3_isnan_any(tg)) {
          a[0] += tg.x;
          a[1] += tg.y;
          a[2] += tg.z;
          a[6] += v3_norm(tg);
        }
        if (!v3_isnan_any(rg)) {
          a[3] += rg.x;
          a[4] += rg.y;
          a[5] += rg.z;
          a[7] += v3_norm(rg);
        }
      }
    }
    block_sum<16>(acc, red);
    V3 dt1, dr1, dt2, dr2;
    adaptive_delta(acc, inv_len, &dt1, &dr1);
    adaptive_delta(acc + 8, inv_len, &dt2, &dr2);
    apply_tangent(dt1, dr1, rf, tf);
    apply_tangent(dt2, dr2, rs, ts);
  }
  if (threadIdx.x == 0) {
    float* pout = poses_out + 24 * p;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      pout[i] = rf[i];
      pout[12 + i] = rs[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pout[9 + i] = tf[i];
      pout[21 + i] = ts[i];
    }
  }
}

}  // namespace

// poses_in/poses_out: (k, 24) floats, per problem the camera-to-center
// poses of the first and second view (rotation row-major, then
// translation, each); obs: (k, n, 3, 3) bearings (center, first, second);
// valid: (k, n) bytes.  Returns the launch's cudaError_t.
extern "C" int cv_three_view_adaptive(const float* poses_in, const float* obs,
                                      const unsigned char* valid, float* poses_out, int k, int n,
                                      int iterations, void* stream) {
  tv_adaptive_kernel<<<k, 64, 0, static_cast<cudaStream_t>(stream)>>>(poses_in, obs, valid,
                                                                       poses_out, n, iterations);
  return static_cast<int>(cudaGetLastError());
}
