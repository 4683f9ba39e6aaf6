// The IK control step of an arm env: for every env of a batch and every arm,
// the IK target's update from the action and a 20-iteration damped-least-
// squares IK solve toward it, in one launch.
//
// Replaces no TPU kernel: the JAX package's IK (furniture_tpu/envs/arm.py::
// _ik_prepare and furniture_tpu/controllers/ik.py::dls_ik) is plain jnp
// under a fori_loop, which XLA fuses under jit. The port's eager form of the
// same function (furniture_tpu_torch/controllers/ik.py::ik_prepare, kept as
// the plain version) runs 21 forward kinematics over all the robot's bodies
// as Python loops on [B, ...] tensors, and a batched Cholesky solve that
// synchronises the host in each of the 20 iterations: on one H100 with
// Sawyer at B = 256 about 32,000 of an ik step's 34,708 kernels and 21 of its
// 23 host synchronisations, and 822 of its 899 ms of enqueue, with the card
// idle through 93% of the step. This kernel exists to take that enqueue and
// those synchronisations off the step.
//
// What bounds it on the H100. Per env and arm: 21 forward kinematics along
// the hand's chain (the root to the hand body, ~10 bodies), and in each of
// 20 iterations the pose error, the Jacobian columns of the arm's joints at
// the hand, J J^T + damping I, its 6x6 Cholesky factorisation, two
// substitutions, dq = J^T x and the clamp to the joint ranges: about 50
// kFLOP for Sawyer, 13 MFLOP at B = 256, 0.2 us at the card's 67 TFLOP/s
// FP32 peak. It reads ~100 B and writes ~65 B an env. Neither binds: a
// launch is latency, one env's chain of dependent steps (20 x (the chain's
// depth + the factorisation and the substitutions)) after the few
// microseconds every launch costs.
//
// Design. One warp per env, ENVS warps a block (at B = 256, 64 blocks: one
// wave), as the joint-dynamics kernel; the robot's tables go into shared
// memory once a block. The forward kinematics is the joint-dynamics
// kernel's (arm_chain.cuh), restricted to the hand's chain: a body's pose
// depends only on its ancestors, so this is the same arithmetic. Lane c
// first forms the hinge rotation of chain body c (its sin and cos, the
// costliest step, for every body at once); then every lane walks the chain,
// taking each rotation from its lane by shuffle, so that each holds the
// hand's pose in registers and no barrier is needed; lane k keeps the pose
// of the body of the arm's k-th joint on the way. Lane k forms the Jacobian
// column of joint k (zero for a joint that does not move the hand), lanes
// take the 21 entries of J J^T + damping I, every lane factorises and
// solves the 6x6 system in registers, and lane k moves and clamps joint k.
// Each arm starts from the joint positions the previous arm's solve left,
// in the env's arm order; the targets come from the hand poses of the
// state's own joint positions. Three warp barriers an iteration, no block
// barrier after the tables' load, no early exit. One thread an env, the
// chain in registers, took 3.5x as long on the H100 (0.275 against 0.079 ms
// for Sawyer at B = 256).
//
// Rounding. The solve is chaotic at the last bit: near convergence the
// orientation error 2 acos(w) turns one ulp of w into ~5e-4 rad, and 20
// iterations carry that into the joint commands, so any other rounding of
// the same mathematics moves q_cmd by ~1e-3 rad in most envs. So the kernel
// rounds as its plain version does on the card: FP32, every operation
// rounded apart (Eager: no contraction the plain version's eager ops do not
// make), precise sinf, cosf, acosf and sqrtf, and each of PyTorch's CUDA
// reductions, batched products, Cholesky factorisation and solve in the
// order and the fused multiply-adds it uses. The clamps pass a NaN through,
// as torch.minimum and torch.maximum do.

#include <cuda_runtime.h>

#include "arm_chain.cuh"

namespace {

using namespace arm_chain;

constexpr int MAX_ARMS = 2;
constexpr int MAX_CHAIN = 32;  // bodies on a hand's chain: a lane each
constexpr int MAX_NA = 8;      // arm joints of an arm: a lane and a column of J each
constexpr int MAX_NJ = 32;     // the robot's joints
constexpr int ENVS = 4;        // envs (warps) a block
constexpr int ITERS = 20;      // DLS iterations (controllers/ik.py::dls_ik)
constexpr float DAMPING = 1e-3f;
constexpr float STEP_SCALE = 1.f;
constexpr unsigned FULL = 0xffffffffu;

// table widths
constexpr int CHAIN_F = 16;  // local pos (3), local quat (4), unit joint axis (3),
                             // joint axis (3), joint anchor (3) in the body frame
constexpr int CHAIN_I = 3;   // body, joint (-1: none), joint type (-1: none)
constexpr int ARM_F = 8;     // joint axis (3), anchor (3), lower and upper limit
constexpr int ARM_I = 3;     // joint, chain position of its body (-1: does not move
                             // the hand), joint type
constexpr int ARM_N = 2;     // chain length, arm joints

// words of the block's tables: chain_f, arm_f, chain_i, arm_i, arm_n
__host__ __device__ __forceinline__ int table_words(int A) {
  return A * (MAX_CHAIN * (CHAIN_F + CHAIN_I) + MAX_NA * (ARM_F + ARM_I) + ARM_N);
}

// words of one env: the state's joint positions, the solve's, J (6 rows of
// MAX_NA), J J^T + damping I (6 x 6, upper triangle used)
__host__ __device__ __forceinline__ int env_words(int NJ) { return 2 * NJ + 6 * MAX_NA + 36; }

struct Args {
  const float* qpos;     // [B,NJ]
  const float* tpos_in;  // [B,A,3] IK target positions
  const float* hqi_in;   // [B,A,4] accumulated target hand quats
  const float* action;   // [B,action_stride]: per arm [dpos3, deuler3] or [dpos3, dquat4]
  float* tpos_out;       // [B,A,3]
  float* hqi_out;        // [B,A,4]
  float* q_cmd;          // [B,NJ]
  const float* chain_f;  // [A,MAX_CHAIN,CHAIN_F]
  const int* chain_i;    // [A,MAX_CHAIN,CHAIN_I]
  const float* arm_f;    // [A,MAX_NA,ARM_F]
  const int* arm_i;      // [A,MAX_NA,ARM_I]
  const int* arm_n;      // [A,ARM_N]
  int B, NJ, A, quat_action, action_stride;
  float move_speed, rotate_speed;
  float box_lo[3], box_hi[3];  // the gripper's workspace box
};

// PyTorch's eager ops, one rounding each (Eager), in the forms its CUDA
// kernels compute them in: the order of a reduction's sum, the matrix
// products', the Cholesky factorisation's and its solve's.
using Ar = Eager;
// scalar / tensor is tensor.reciprocal() * scalar
__device__ __forceinline__ float rdiv(float s, float x) { return Ar::mul(Ar::div(1.f, x), s); }

// torch.maximum / torch.minimum / torch.clamp: a NaN passes through
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

// torch.sum(t, dim=-1) of 4 rounded terms: (t0 + t2) + (t1 + t3)
__device__ __forceinline__ float sum4(const float* t) {
  return Ar::add(Ar::add(t[0], t[2]), Ar::add(t[1], t[3]));
}
// torch.linalg.norm(x, dim=-1) of 3 and 4 entries: the rounded squares
// summed as (0 + 2) + 1 and (0 + 2) + (1 + 3)
__device__ __forceinline__ float norm3(const float* x) {
  return __fsqrt_rn(Ar::add(Ar::add(Ar::mul(x[0], x[0]), Ar::mul(x[2], x[2])), Ar::mul(x[1], x[1])));
}
__device__ __forceinline__ float norm4(const float* x) {
  float t[4];
  for (int k = 0; k < 4; ++k) t[k] = Ar::mul(x[k], x[k]);
  return __fsqrt_rn(sum4(t));
}
// J J^T's entries (a batched matrix product): one FMA chain in k
__device__ __forceinline__ float jjt_dot(const float* x, const float* y, int n) {
  float acc = 0.f;
  for (int k = 0; k < n; ++k) acc = __fmaf_rn(x[k], y[k], acc);
  return acc;
}
// J^T x's entries (a batched matrix-vector product of 6 terms): an FMA
// chain over each half, added. The library picks its kernel, and with it
// this form, by the batch size: this is its form on the H100 at B = 1 and
// 192-4096 except 2048 (the ik cell's 256 among them), where the kernel
// repeats its plain version bit for bit; at other sizes the two differ by
// rounding.
__device__ __forceinline__ float jtx_dot(const float* x, const float* y) {
  float lo = 0.f, hi = 0.f;
  for (int k = 0; k < 3; ++k) lo = __fmaf_rn(x[k], y[k], lo);
  for (int k = 3; k < 6; ++k) hi = __fmaf_rn(x[k], y[k], hi);
  return Ar::add(lo, hi);
}

// T.quat_normalize: q / clamp(|q|, 1e-12)
__device__ __forceinline__ void qnormalize(const float* q, float n, float* o) {
  const float d = tmax(n, 1e-12f);
  for (int k = 0; k < 4; ++k) o[k] = Ar::div(q[k], d);
}

// b^-1 (T.quat_inv: conj(b) / clamp(b . b, 1e-12)), then a b^-1 on the
// shortest arc (w >= 0)
__device__ __forceinline__ void qrel(const float* a, const float* b, float* o) {
  float t[4];
  for (int k = 0; k < 4; ++k) t[k] = Ar::mul(b[k], b[k]);
  const float s = tmax(sum4(t), 1e-12f);
  const float inv[4] = {Ar::div(b[0], s), Ar::div(-b[1], s), Ar::div(-b[2], s), Ar::div(-b[3], s)};
  qmul<Ar>(a, inv, o);
  if (o[0] < 0.f)
    for (int k = 0; k < 4; ++k) o[k] = -o[k];
}

// T.quat_slerp(q0, q1, t), with its lerp below sin(theta) = 1e-5; q0 is a
// row of a strided view (the hand body's quat), q1 contiguous
__device__ __forceinline__ void qslerp(const float* q0_in, const float* q1_in, float t, float* o) {
  float q0[4], q1[4];
  qnormalize(q0_in, norm4(q0_in), q0);
  qnormalize(q1_in, norm4(q1_in), q1);
  float p[4];
  for (int k = 0; k < 4; ++k) p[k] = Ar::mul(q0[k], q1[k]);
  float d = sum4(p);
  if (d < 0.f)
    for (int k = 0; k < 4; ++k) q1[k] = -q1[k];
  d = tclamp(fabsf(d), -1.f, 1.f);
  const float theta = acosf(d);
  const float st = sinf(theta);
  const bool lerp = st < 1e-5f;
  const float s = tmax(st, 1e-12f);
  const float omt = Ar::sub(1.f, t);
  const float w0 = lerp ? omt : Ar::div(sinf(Ar::mul(omt, theta)), s);
  const float w1 = lerp ? t : Ar::div(sinf(Ar::mul(t, theta)), s);
  float m[4];
  for (int k = 0; k < 4; ++k) m[k] = Ar::add(Ar::mul(w0, q0[k]), Ar::mul(w1, q1[k]));
  qnormalize(m, norm4(m), o);
}

// T.euler_to_quat of (rx, ry, rz) in degrees: qz qy qx
__device__ __forceinline__ void euler_quat(const float* deg, float* o) {
  float c[3], s[3];
  for (int k = 0; k < 3; ++k) {
    const float half = Ar::mul(Ar::mul(deg[k], 0.017453292519943295f), 0.5f);
    c[k] = cosf(half);
    s[k] = sinf(half);
  }
  o[0] = Ar::add(Ar::mul(Ar::mul(c[2], c[1]), c[0]), Ar::mul(Ar::mul(s[2], s[1]), s[0]));
  o[1] = Ar::sub(Ar::mul(Ar::mul(c[2], c[1]), s[0]), Ar::mul(Ar::mul(s[2], s[1]), c[0]));
  o[2] = Ar::add(Ar::mul(Ar::mul(c[2], s[1]), c[0]), Ar::mul(Ar::mul(s[2], c[1]), s[0]));
  o[3] = Ar::sub(Ar::mul(Ar::mul(s[2], c[1]), c[0]), Ar::mul(Ar::mul(c[2], s[1]), s[0]));
}

// The hand's world pose (hp, hq) at joint positions q, along the chain of
// nc bodies whose tables are cf, ci; the lane whose joint's body sits at
// chain position `mine` keeps that body's pose (bp, bq). Every lane of the
// warp calls it.
__device__ __forceinline__ void hand_fk(const float* cf, const int* ci, int nc, const float* q,
                                        int lane, int mine, float* hp, float* hq, float* bp,
                                        float* bq) {
  float qr[4] = {1.f, 0.f, 0.f, 0.f};
  if (lane < nc) {
    const int* ib = ci + lane * CHAIN_I;
    if (ib[1] >= 0 && ib[2] == HINGE) hinge_quat<Ar>(q[ib[1]], cf + lane * CHAIN_F + 7, qr);
  }
  for (int c = 0; c < nc; ++c) {
    float r[4];
    for (int k = 0; k < 4; ++k) r[k] = __shfl_sync(FULL, qr[k], c);
    const float* fb = cf + c * CHAIN_F;
    const int* ib = ci + c * CHAIN_I;
    const int j = ib[1];
    float wp[3], wq[4];
    chain_body<Ar>(fb, c == 0, hp, hq, j < 0 ? -1 : ib[2], fb + 10, q[j < 0 ? 0 : j], r, wp, wq);
    for (int k = 0; k < 3; ++k) hp[k] = wp[k];
    for (int k = 0; k < 4; ++k) hq[k] = wq[k];
    if (c == mine) {
      for (int k = 0; k < 3; ++k) bp[k] = wp[k];
      for (int k = 0; k < 4; ++k) bq[k] = wq[k];
    }
  }
}

// controllers/ik.py::_pose_error: (target pos - pos, axis * angle of
// target quat * quat^-1)
__device__ __forceinline__ void pose_error(const float* cp, const float* cq, const float* tp,
                                           const float* tq, float* e) {
  for (int k = 0; k < 3; ++k) e[k] = Ar::sub(tp[k], cp[k]);
  float d[4];
  qrel(tq, cq, d);
  const float angle = Ar::mul(2.f, acosf(tclamp(d[0], -1.f, 1.f)));
  const float n = tmax(norm3(d + 1), 1e-9f);
  for (int k = 0; k < 3; ++k) e[3 + k] = Ar::mul(Ar::div(d[1 + k], n), angle);
}

// torch.linalg.cholesky_ex of the 6x6 S (lower, row-major): each entry's
// updates an FMA chain in k, the column scaled by the pivot's reciprocal;
// then torch.cholesky_solve of e: L y = e, L^T x = y, each row's sum an FMA
// chain from 0 (ascending in the forward pass, descending in the backward
// one) taken from the right-hand side, then divided by the pivot.
__device__ __forceinline__ void chol_solve6(const float* S, const float* e, float* x) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = S[j * 6 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = __fmaf_rn(-L[j][k], L[j][k], d);
    L[j][j] = __fsqrt_rn(d);
    const float inv = Ar::div(1.f, L[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = S[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fmaf_rn(-L[i][k], L[j][k], s);
      L[i][j] = Ar::mul(s, inv);
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < i; ++k) t = __fmaf_rn(L[i][k], y[k], t);
    y[i] = Ar::div(Ar::sub(e[i], t), L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = 0.f;
#pragma unroll
    for (int k = 5; k > i; --k) t = __fmaf_rn(L[k][i], x[k], t);
    x[i] = Ar::div(Ar::sub(y[i], t), L[i][i]);
  }
}

__global__ void __launch_bounds__(32 * ENVS) arm_ik_prepare_kernel(Args a) {
  extern __shared__ float smem[];
  const int A = a.A, NJ = a.NJ;
  float* cf_all = smem;
  float* af_all = cf_all + A * MAX_CHAIN * CHAIN_F;
  int* ci_all = reinterpret_cast<int*>(af_all + A * MAX_NA * ARM_F);
  int* ai_all = ci_all + A * MAX_CHAIN * CHAIN_I;
  int* an_all = ai_all + A * MAX_NA * ARM_I;
  for (int i = threadIdx.x; i < A * MAX_CHAIN * CHAIN_F; i += blockDim.x) cf_all[i] = a.chain_f[i];
  for (int i = threadIdx.x; i < A * MAX_NA * ARM_F; i += blockDim.x) af_all[i] = a.arm_f[i];
  for (int i = threadIdx.x; i < A * MAX_CHAIN * CHAIN_I; i += blockDim.x) ci_all[i] = a.chain_i[i];
  for (int i = threadIdx.x; i < A * MAX_NA * ARM_I; i += blockDim.x) ai_all[i] = a.arm_i[i];
  for (int i = threadIdx.x; i < A * ARM_N; i += blockDim.x) an_all[i] = a.arm_n[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * ENVS + warp;
  if (env >= a.B) return;
  float* q0 = smem + table_words(A) + warp * env_words(NJ);
  float* q = q0 + NJ;
  float* J = q + NJ;
  float* S = J + 6 * MAX_NA;
  for (int j = lane; j < NJ; j += 32) q0[j] = q[j] = a.qpos[(size_t)env * NJ + j];
  __syncwarp();
  // lane e < 21 takes entry (sr, sc), sr <= sc, of J J^T
  int sr = 0, sc = lane;
  while (sr < 6 && sc >= 6 - sr) {
    sc -= 6 - sr;
    ++sr;
  }
  sc += sr;

  const float* act = a.action + (size_t)env * a.action_stride;
  const int aw = a.quat_action ? 7 : 6;
  for (int i = 0; i < A; ++i) {
    const float* cf = cf_all + i * MAX_CHAIN * CHAIN_F;
    const int* ci = ci_all + i * MAX_CHAIN * CHAIN_I;
    const float* af = af_all + i * MAX_NA * ARM_F;
    const int* ai = ai_all + i * MAX_NA * ARM_I;
    const int nc = an_all[i * ARM_N], na = an_all[i * ARM_N + 1];
    const int mine = lane < na ? ai[lane * ARM_I + 1] : -1;
    const float* ac = act + aw * i;
    float hp[3], hq[4], bp[3], bq[4];

    // 1. The target: the hand's pose at the state's joint positions, the
    // clamped move, the orientation target kept within 45 degrees of the
    // hand, and the position target moved by 0.3 x the move and kept within
    // 0.15 m of the hand.
    hand_fk(cf, ci, nc, q0, lane, -1, hp, hq, bp, bq);
    float dpos[3];
    for (int k = 0; k < 3; ++k)
      dpos[k] = tmin(tmax(Ar::mul(ac[k], a.move_speed), Ar::sub(a.box_lo[k], hp[k])),
                     Ar::sub(a.box_hi[k], hp[k]));
    float tq[4], m[4];
    if (a.quat_action) {
      float d[4];
      qnormalize(ac + 3, norm4(ac + 3), d);
      if (d[0] < 0.f)
        for (int k = 0; k < 4; ++k) d[k] = -d[k];
      qmul<Ar>(hq, d, m);
    } else {
      float deg[3], e[4];
      for (int k = 0; k < 3; ++k) deg[k] = Ar::mul(Ar::mul(0.3f, ac[3 + k]), a.rotate_speed);
      euler_quat(deg, e);
      qmul<Ar>(a.hqi_in + ((size_t)env * A + i) * 4, e, m);
    }
    qnormalize(m, norm4(m), tq);
    {
      float d[4];
      qrel(tq, hq, d);
      const float ang = Ar::mul(2.f, acosf(tclamp(d[0], -1.f, 1.f)));
      const float frac = tmin(rdiv(0.785398163397448f, tmax(ang, 1e-6f)), 1.f);
      qslerp(hq, tq, frac, m);
      for (int k = 0; k < 4; ++k) tq[k] = m[k];
    }
    float tp[3], err[3];
    const float* tin = a.tpos_in + ((size_t)env * A + i) * 3;
    for (int k = 0; k < 3; ++k) {
      tp[k] = Ar::add(tin[k], Ar::mul(0.3f, dpos[k]));
      err[k] = Ar::sub(tp[k], hp[k]);
    }
    const float scale = tmin(rdiv(0.15f, tmax(norm3(err), 1e-6f)), 1.f);
    for (int k = 0; k < 3; ++k) tp[k] = Ar::add(hp[k], Ar::mul(err[k], scale));
    if (lane == 0) {
      for (int k = 0; k < 3; ++k) a.tpos_out[((size_t)env * A + i) * 3 + k] = tp[k];
      for (int k = 0; k < 4; ++k) a.hqi_out[((size_t)env * A + i) * 4 + k] = tq[k];
    }

    // 2. The DLS iterations toward (tp, tq).
    for (int it = 0; it < ITERS; ++it) {
      hand_fk(cf, ci, nc, q, lane, mine, hp, hq, bp, bq);
      float e[6];
      pose_error(hp, hq, tp, tq, e);
      float col[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (lane < na && mine >= 0) {
        const float* f = af + lane * ARM_F;
        float axis[3], anchor[3];
        qrot<Ar>(bq, f, axis);
        qrot<Ar>(bq, f + 3, anchor);
        for (int k = 0; k < 3; ++k) anchor[k] = Ar::add(bp[k], anchor[k]);
        const bool hinge = ai[lane * ARM_I + 2] == HINGE;
        jac_col<Ar>(axis, anchor, hinge, hp, col);
        if (hinge)
          for (int k = 0; k < 3; ++k) col[3 + k] = axis[k];
      }
      if (lane < na)
        for (int r = 0; r < 6; ++r) J[r * MAX_NA + lane] = col[r];
      __syncwarp();
      if (lane < 21) {
        const float s = jjt_dot(J + sr * MAX_NA, J + sc * MAX_NA, na);
        S[sr * 6 + sc] = Ar::add(s, sr == sc ? DAMPING : 0.f);
        S[sc * 6 + sr] = S[sr * 6 + sc];
      }
      __syncwarp();
      float x[6];
      chol_solve6(S, e, x);
      if (lane < na) {
        const float dq = jtx_dot(col, x);
        const float* f = af + lane * ARM_F;
        const int j = ai[lane * ARM_I];
        q[j] = tclamp(Ar::add(q[j], Ar::mul(STEP_SCALE, dq)), f[6], f[7]);
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < NJ; j += 32) a.q_cmd[(size_t)env * NJ + j] = q[j];
}

}  // namespace

extern "C" {

// layout constants the wrapper checks its tables against
int arm_ik_max_arms() { return MAX_ARMS; }
int arm_ik_max_chain() { return MAX_CHAIN; }
int arm_ik_max_na() { return MAX_NA; }
int arm_ik_max_nj() { return MAX_NJ; }
int arm_ik_chain_f() { return CHAIN_F; }
int arm_ik_chain_i() { return CHAIN_I; }
int arm_ik_arm_f() { return ARM_F; }
int arm_ik_arm_i() { return ARM_I; }
int arm_ik_arm_n() { return ARM_N; }
int arm_ik_iters() { return ITERS; }
float arm_ik_damping() { return DAMPING; }
float arm_ik_step_scale() { return STEP_SCALE; }
// dynamic shared memory of a block
int arm_ik_smem_bytes(int A, int NJ) { return 4 * (table_words(A) + ENVS * env_words(NJ)); }

// Launches the kernel on `stream`: the new IK targets (tpos_out, hqi_out)
// and joint commands q_cmd from qpos, the old targets and the action, with
// the robot's tables; `box` (host) holds the workspace box's lower and
// upper corners. Returns the CUDA error code of the launch (0 on success).
int arm_ik_prepare(const float* qpos, const float* tpos_in, const float* hqi_in,
                   const float* action, float* tpos_out, float* hqi_out, float* q_cmd,
                   const float* chain_f, const int* chain_i, const float* arm_f, const int* arm_i,
                   const int* arm_n, const float* box, int B, int NJ, int A, int quat_action,
                   int action_stride, float move_speed, float rotate_speed, void* stream) {
  if (A < 1 || A > MAX_ARMS || NJ < 1 || NJ > MAX_NJ || B < 0 ||
      action_stride < (quat_action ? 7 : 6) * A)
    return (int)cudaErrorInvalidValue;
  const int smem = arm_ik_smem_bytes(A, NJ);
  cudaError_t err = cudaFuncSetAttribute(arm_ik_prepare_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    Args a{qpos,    tpos_in, hqi_in, action, tpos_out, hqi_out, q_cmd, chain_f,
           chain_i, arm_f,   arm_i,  arm_n,  B,        NJ,      A,     quat_action != 0,
           action_stride, move_speed, rotate_speed,
           {box[0], box[1], box[2]}, {box[3], box[4], box[5]}};
    arm_ik_prepare_kernel<<<(B + ENVS - 1) / ENVS, 32 * ENVS, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* arm_ik_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
