// K adaptive three-view loops, a fixed number of iterations each: one
// thread block per problem, the whole loop in one launch.
//
// Replaces cv_tpu/optimize/pallas_loop.py::three_view_adaptive_resident
// (the Pallas kernel _tv_kernel), which computes exactly the engine's
// _three_view_batch_device; reference three_view_optimizer.rs:203-272.
// Plain version: cv_tpu_torch/optimize/optimizers.py::three_view_adaptive_optimize_l2.
//
// What bounds it on the H100: step latency.  Each problem holds N = 64
// landmarks (the engine's bucket); a step is ~500 flops, ~55 divisions and
// ~20 square roots per landmark plus one 16-value reduction and two
// Rodrigues updates, repeated ``iterations`` (1,000 at the engine's calls)
// times.  The K problems (at most 64) are K blocks that run at once on
// separate SMs; within a block, a step is one landmark's chain of dependent
// operations, and nothing else is there to hide its latency.
//
// The design shortens that chain:
//  * a row's work is spread over four lanes of one warp, which run the same
//    code on other operands: lane j of a row triangulates one of the three
//    points (p_f, p_s, p_c) and takes one of the three rotation gradients
//    (lane 3 repeats lane 2's); three shuffles of three floats bring each
//    lane the two pieces its output vector is weighed from (first
//    translation, second translation, first rotation, second rotation), in
//    the expressions of the whole-row form, so each value rounds as there;
//  * the divisions and square roots take the branch-free fast paths
//    (FastOps); a lane with an operand out of their range redoes its piece
//    with IEEE `/` and sqrtf;
//  * the valid rows are ranked once per launch (a block scan); rank r goes
//    to the row group r % kGroups, and each lane sums its ranks in order.
//    Ranks below kGroups sit in registers, the rest are read from global
//    memory each step through a rank -> row table.  Invalid rows, appended
//    or interleaved, change no bit; a warp skips its register rows when it
//    holds no valid one;
//  * one __syncthreads a step (block_sum_step over the four lane groups);
//  * the half-warps of each warp compute the two poses' adaptive updates
//    side by side and trade them by shuffle (update_pose_pair), so every
//    thread holds both poses.
// Built with --fmad=false.

#include "pose_loops.cuh"

namespace {

// The block size: the sum order depends on it.  Chosen by the sweep of
// scripts/sweep_pose_blocks.py at the SfM engine's own calls (PERF.md).
constexpr int kThreads = 256;
constexpr int kLanes = 4;                   // lanes per row
constexpr int kGroups = kThreads / kLanes;  // rows in flight
constexpr int kWarps = kThreads / 32;
constexpr int kRowFloats = 9;  // bearings: center, first, second
static_assert(kThreads % 32 == 0 && (kWarps & (kWarps - 1)) == 0 && kWarps <= 32, "block size");

// Lane `sub` of a row's four: its triangulated translation piece T and
// its rotation gradient R (epipolar.rs:85-166).
//   sub 0: T = trans_f (p_f from (-stoc, c, s), moved by -ftoc, across f),
//          R = rot_cf (ftoc, c, f);
//   sub 1: T = trans_s (p_s from (-ftoc, c, f), moved by -stoc, across s),
//          R = rot_cs (stoc, c, s);
//   sub 2, 3: T = trans_c (p_c from (-stof, f, s), p_c + ftoc, reversed
//          across c), R = rot_fs (stof, f, s).
template <class Ops>
__device__ __forceinline__ void tv_piece(Ops& o, int sub, V3 c, V3 f, V3 s, V3 ftoc_t, V3 stoc_t, V3* trans,
                                         V3* rot) {
  const V3 stof = v3_sub(stoc_t, ftoc_t);
  const bool first = sub == 0, second = sub == 1;
  const V3 t_tri = first ? v3_neg(stoc_t) : (second ? v3_neg(ftoc_t) : v3_neg(stof));
  const V3 a = first | second ? c : f;
  const V3 b = first ? s : (second ? f : s);
  const V3 off = first ? ftoc_t : (second ? stoc_t : v3_neg(ftoc_t));
  const V3 d = first ? f : (second ? s : c);
  *trans = tv_translation(o, t_tri, a, b, off, d, !(first | second));
  const V3 t_rot = first ? ftoc_t : (second ? stoc_t : stof);
  const V3 ra = first | second ? c : f;
  const V3 rb = first ? f : s;
  *rot = tv_rotation_gradient(o, t_rot, ra, rb);
}

__device__ __forceinline__ V3 shfl_v3(unsigned mask, V3 v, int src) {
  return v3(__shfl_sync(mask, v.x, src), __shfl_sync(mask, v.y, src), __shfl_sync(mask, v.z, src));
}

// One row on its four lanes: lane `sub` adds its output vector (sub 0:
// first translation, 1: second translation, 2: first rotation, 3: second
// rotation) and the vector's norm to acc (x, y, z, norm) where the vector
// is not NaN; nothing where the row is not active.  The four lanes of the
// row call this together.
__device__ __forceinline__ void tv_adaptive_row(const float* rf, const float* tf, const float* rs, const float* ts,
                                                const float* row, bool active, int lane, float (&acc)[4]) {
  const int sub = lane & (kLanes - 1);
  const int base = lane - sub;
  const unsigned mask = 0xfu << base;
  V3 c, f, s;
  tv_bearings(rf, rs, row, &c, &f, &s);
  const V3 ftoc_t = v3(tf[0], tf[1], tf[2]);
  const V3 stoc_t = v3(ts[0], ts[1], ts[2]);
  V3 trans, rot;
  FastOps fast;
  tv_piece(fast, sub, c, f, s, ftoc_t, stoc_t, &trans, &rot);
  if (active & !fast.ok) {
    IeeeOps ieee;
    tv_piece(ieee, sub, c, f, s, ftoc_t, stoc_t, &trans, &rot);
  }
  const V3 trans_c = shfl_v3(mask, trans, base + 2);
  const V3 rot_fs = shfl_v3(mask, rot, base + 2);
  const V3 rot_u = shfl_v3(mask, rot, base + (sub & 1));  // rot_cf to lane 2, rot_cs to lane 3
  // first_trans = trans_f 2/3 + trans_c 1/3, second_trans = trans_s 2/3 +
  // trans_c 1/3, first_rot = rot_cf 2/3 + (-rot_fs) 1/3, second_rot =
  // rot_cs 2/3 + rot_fs 1/3.
  const V3 g = sub < 2 ? tv_weigh(trans, trans_c) : tv_weigh(rot_u, sub == 2 ? v3_neg(rot_fs) : rot_fs);
  FastOps fast_norm;
  float norm = v3_norm0(fast_norm, g);
  if (!fast_norm.ok) norm = v3_norm(g);
  const bool keep = active & !v3_isnan_any(g);
  acc[0] = keep ? acc[0] + g.x : acc[0];
  acc[1] = keep ? acc[1] + g.y : acc[1];
  acc[2] = keep ? acc[2] + g.z : acc[2];
  acc[3] = keep ? acc[3] + norm : acc[3];
}

// One pose's adaptive step from its sums (translation sum, rotation sum,
// translation-norm sum, rotation-norm sum): rate |mean| / mean norm per
// part, non-finite rates set to 0, applied to (r, t) in place.
template <class Ops>
__device__ __forceinline__ void adaptive_step(Ops& o, V3 sum_t, V3 sum_r, float norm_t, float norm_r, float inv_len,
                                              float* r, float* t) {
  const V3 mean_t = v3(sum_t.x * inv_len, sum_t.y * inv_len, sum_t.z * inv_len);
  const V3 mean_r = v3(sum_r.x * inv_len, sum_r.y * inv_len, sum_r.z * inv_len);
  const float tstd = norm_t * inv_len;
  const float rstd = norm_r * inv_len;
  const float trate = o.rate(v3_norm0(o, mean_t), tstd);
  const float rrate = o.rate(v3_norm0(o, mean_r), rstd);
  apply_tangent(o, v3_scale(mean_t, trate), v3_scale(mean_r, rrate), r, t);
}

__device__ __forceinline__ void load_row(const float* __restrict__ obs, int i, float* row) {
#pragma unroll
  for (int k = 0; k < kRowFloats; ++k) row[k] = __ldg(obs + kRowFloats * i + k);
}

__global__ void __launch_bounds__(kThreads, 1)
    tv_adaptive_kernel(const float* __restrict__ poses_in, const float* __restrict__ obs,
                       const unsigned char* __restrict__ valid, float* __restrict__ poses_out,
                       int* __restrict__ order, int n, int iterations) {
  __shared__ int reg_order[kGroups];
  __shared__ int warp_count[kWarps];
  __shared__ float part[2][kWarps][kLanes][4];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = tid / kLanes;
  const float* pobs = obs + static_cast<size_t>(p) * n * kRowFloats;
  int* porder = order + static_cast<size_t>(p) * n;

  const int nvalid = rank_rows<kThreads>(valid + static_cast<size_t>(p) * n, n, warp_count, [&](int rank, int i) {
    if (rank < kGroups) {
      reg_order[rank] = i;
    } else {
      porder[rank - kGroups] = i;
    }
  });
  __syncthreads();

  // The register row of this lane's group; a group beyond the valid rows
  // holds a placeholder that is computed and masked out.
  const bool has_reg = group < nvalid;
  float reg[kRowFloats];
  if (has_reg) {
    load_row(pobs, reg_order[group], reg);
  } else {
#pragma unroll
    for (int k = 0; k < kRowFloats; ++k) reg[k] = (k % 3 == 2) ? 1.0f : 0.0f;
  }
  const bool warp_has_rows = (tid - lane) / kLanes < nvalid;

  const float inv_len = 1.0f / fmaxf(static_cast<float>(nvalid), 1.0f);
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
    // Each lane sums its group's ranks group, group + kGroups, ... in order.
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (warp_has_rows) tv_adaptive_row(rf, tf, rs, ts, reg, has_reg, lane, acc);
    for (int rank = kGroups + group; rank < nvalid; rank += kGroups) {
      float row[kRowFloats];
      load_row(pobs, porder[rank - kGroups], row);
      tv_adaptive_row(rf, tf, rs, ts, row, true, lane, acc);
    }

    float out[kLanes][4];
    block_sum_step<kLanes, 4, kWarps>(acc, part[it & 1], out, lane, warp);

    // The sums of lane groups 0 and 2 drive the first pose, 1 and 3 the
    // second.
    update_pose_pair(lane, rf, tf, rs, ts, [&](auto& o, int pose, float* r, float* t) {
      const auto pick = [pose](float first, float second) { return pose ? second : first; };
      adaptive_step(o, v3(pick(out[0][0], out[1][0]), pick(out[0][1], out[1][1]), pick(out[0][2], out[1][2])),
                    v3(pick(out[2][0], out[3][0]), pick(out[2][1], out[3][1]), pick(out[2][2], out[3][2])),
                    pick(out[0][3], out[1][3]), pick(out[2][3], out[3][3]), inv_len, r, t);
    });
  }
  if (tid == 0) {
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
// valid: (k, n) bytes; order: k * n ints of scratch.  Returns the launch's
// cudaError_t.
extern "C" int cv_three_view_adaptive(const float* poses_in, const float* obs, const unsigned char* valid,
                                      float* poses_out, int* order, int k, int n, int iterations, void* stream) {
  tv_adaptive_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(poses_in, obs, valid, poses_out, order,
                                                                           n, iterations);
  return static_cast<int>(cudaGetLastError());
}
