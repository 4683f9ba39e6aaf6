// Joint dynamics of an articulated arm: the semi-implicit update matrices of
// a control step, G1 = A^-1 M and G2 = dt A^-1 with A = M(q) + dt diag(D),
// for a whole batch of envs in one launch.
//
// Replaces no TPU kernel: the JAX package computes these matrices in plain
// jnp (furniture_tpu/robots/kinematics.py::joint_dyn_matrices), which XLA
// fuses under jit. The port's eager form of the same function
// (furniture_tpu_torch/robots/kinematics.py::joint_dyn_matrices, kept as the
// plain version) is a Python loop over the bodies on [B, ...] tensors: about
// 1,430 small kernels a control step and a host synchronisation in
// torch.cholesky_solve. Traced on one H100 with Sawyer at B = 512, the host
// took 33.4 ms of a 95.6 ms step to enqueue them, about 35% of the step,
// with the card idle through 94% of that time. This kernel exists to take
// that enqueue, and the synchronisation, off the step.
//
// What bounds it on the H100. Per env: forward kinematics over the NB
// bodies, each body's COM and inertia in the world frame, the upper
// triangle of M summed over the bodies, a Cholesky factorisation of A, A^-1
// by NJ forward and back substitutions, and the product A^-1 M: about 30
// kFLOP for Sawyer (NB = 30, NJ = 9), 15 MFLOP at B = 512, 0.2 us at the
// card's 67 TFLOP/s FP32 peak. It reads 36 B (qpos) and writes 648 B (G1,
// G2) an env: 0.35 MB at B = 512, 0.1 us at 3.35 TB/s. Neither binds: a
// launch is latency, a chain of dependent steps per env (the chain's
// levels, NJ steps of the factorisation, NJ of each substitution) after the
// few microseconds every launch costs.
//
// Design. One warp per env, ENVS warps a block: at B = 512 that is 128
// blocks, one wave on 132 SMs. The robot's constant tables go into shared
// memory once a block; each warp keeps its env's poses and matrices in
// shared memory beside them. The chain is walked level by level, parent
// first, lanes over the bodies of a level, with the plain version's
// composition (parent pose, then the joint's motion about its anchor; the
// one-body step and the vector helpers are arm_chain.cuh's, shared with the
// IK kernel).
// Lanes then take the bodies (COM and inertia in the world frame) and the
// joints (axis and anchor in the world frame); then the entries of M's upper
// triangle, each summing over the bodies that both of its joints move, with
// the Jacobian columns formed on the fly. The factorisation is right-looking
// with lanes over the trailing entries; lane c solves column c of A^-1;
// lanes take the entries of G1 and G2, written coalesced. The robot comes
// from its tables (body and joint counts, parents, hinge or slide joints):
// one kernel for every arm, within MAX_NB bodies and MAX_NJ joints. FP32
// throughout; only warp barriers after the one block barrier that follows
// the tables' load.

#include <cuda_runtime.h>

#include "arm_chain.cuh"

namespace {

using namespace arm_chain;

constexpr int MAX_NB = 64;   // bodies
constexpr int MAX_NJ = 32;   // joints: a lane per column of A^-1, a bit each in the ancestor masks
constexpr int ENVS = 4;      // envs (warps) a block

// table widths
constexpr int BODY_F = 23;   // local pos (3), local quat (4), unit joint axis (3), COM (3),
                             // mass, inertia about the COM in the body frame (9, row-major)
constexpr int BODY_I = 5;    // parent (-1: world), joint (-1: none), joint type, depth,
                             // joints that move the body (bit j)
constexpr int JNT_F = 8;     // axis (3), anchor (3), armature, dt * D
constexpr int JNT_I = 2;     // body, type

__host__ __device__ __forceinline__ int n_pairs(int NJ) { return NJ * (NJ + 1) / 2; }

// words of the block's tables: body_f, jnt_f, body_i, jnt_i, pairs
__host__ __device__ __forceinline__ int table_words(int NB, int NJ) {
  return NB * (BODY_F + BODY_I) + NJ * (JNT_F + JNT_I) + n_pairs(NJ);
}

// words of one env: qpos, body pos, quat, COM, world inertia; joint axis,
// anchor; M, L, A^-1
__host__ __device__ __forceinline__ int env_words(int NB, int NJ) {
  return NJ + NB * (3 + 4 + 3 + 9) + NJ * 6 + 3 * NJ * NJ;
}

struct Args {
  const float* qpos;     // [B,NJ]
  float* G1;             // [B,NJ,NJ]
  float* G2;             // [B,NJ,NJ]
  const float* body_f;   // [NB,BODY_F]
  const int* body_i;     // [NB,BODY_I]
  const float* jnt_f;    // [NJ,JNT_F]
  const int* jnt_i;      // [NJ,JNT_I]
  const int* pairs;      // [NJ(NJ+1)/2]: k | j << 16, k <= j
  int B, NB, NJ, NLEV;
  float dt;
};

__global__ void __launch_bounds__(32 * ENVS) arm_dyn_matrices_kernel(Args a) {
  extern __shared__ float smem[];
  const int NB = a.NB, NJ = a.NJ, NP = n_pairs(NJ);
  float* bf = smem;
  float* jf = bf + NB * BODY_F;
  int* bi = reinterpret_cast<int*>(jf + NJ * JNT_F);
  int* ji = bi + NB * BODY_I;
  int* pairs = ji + NJ * JNT_I;
  for (int i = threadIdx.x; i < NB * BODY_F; i += blockDim.x) bf[i] = a.body_f[i];
  for (int i = threadIdx.x; i < NJ * JNT_F; i += blockDim.x) jf[i] = a.jnt_f[i];
  for (int i = threadIdx.x; i < NB * BODY_I; i += blockDim.x) bi[i] = a.body_i[i];
  for (int i = threadIdx.x; i < NJ * JNT_I; i += blockDim.x) ji[i] = a.jnt_i[i];
  for (int i = threadIdx.x; i < NP; i += blockDim.x) pairs[i] = a.pairs[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * ENVS + warp;
  if (env >= a.B) return;
  float* q = smem + table_words(NB, NJ) + warp * env_words(NB, NJ);
  float* bpos = q + NJ;
  float* bquat = bpos + 3 * NB;
  float* com = bquat + 4 * NB;
  float* iw = com + 3 * NB;
  float* axis = iw + 9 * NB;
  float* anchor = axis + 3 * NJ;
  float* M = anchor + 3 * NJ;
  float* L = M + NJ * NJ;
  float* X = L + NJ * NJ;
  for (int j = lane; j < NJ; j += 32) q[j] = a.qpos[(size_t)env * NJ + j];
  __syncwarp();

  // 1. The chain, level by level: a body's parent pose composed with its
  // local pose, then its joint's motion (a hinge rotates about its anchor,
  // a slide moves along its axis).
  for (int d = 0; d < a.NLEV; ++d) {
    for (int i = lane; i < NB; i += 32) {
      const int* ib = bi + i * BODY_I;
      if (ib[3] != d) continue;
      const float* fb = bf + i * BODY_F;
      const int par = ib[0];
      const int j = ib[1], pb = par < 0 ? 0 : par, jb = j < 0 ? 0 : j;
      float wp[3], wq[4];
      chain_body(fb, par < 0, bpos + 3 * pb, bquat + 4 * pb, j < 0 ? -1 : ib[2], jf + jb * JNT_F,
                 q[jb], nullptr, wp, wq);
      for (int k = 0; k < 3; ++k) bpos[3 * i + k] = wp[k];
      for (int k = 0; k < 4; ++k) bquat[4 * i + k] = wq[k];
    }
    __syncwarp();
  }

  // 2. Each body's COM and inertia (R I R^T, R of the normalised quat) in
  // the world frame; each joint's axis and anchor in the world frame.
  for (int i = lane; i < NB; i += 32) {
    const float* fb = bf + i * BODY_F;
    const float* qb = bquat + 4 * i;
    float r[3];
    qrot(qb, fb + 10, r);
    for (int k = 0; k < 3; ++k) com[3 * i + k] = bpos[3 * i + k] + r[k];
    const float n = fmaxf(sqrtf(qb[0] * qb[0] + qb[1] * qb[1] + qb[2] * qb[2] + qb[3] * qb[3]),
                          1e-12f);
    const float w = qb[0] / n, x = qb[1] / n, y = qb[2] / n, z = qb[3] / n;
    const float R[3][3] = {
        {1.f - 2.f * (y * y + z * z), 2.f * (x * y - w * z), 2.f * (x * z + w * y)},
        {2.f * (x * y + w * z), 1.f - 2.f * (x * x + z * z), 2.f * (y * z - w * x)},
        {2.f * (x * z - w * y), 2.f * (y * z + w * x), 1.f - 2.f * (x * x + y * y)},
    };
    const float* I = fb + 14;
    float RI[3][3];
    for (int u = 0; u < 3; ++u)
      for (int v = 0; v < 3; ++v)
        RI[u][v] = R[u][0] * I[v] + R[u][1] * I[3 + v] + R[u][2] * I[6 + v];
    for (int u = 0; u < 3; ++u)
      for (int v = 0; v < 3; ++v)
        iw[9 * i + 3 * u + v] = RI[u][0] * R[v][0] + RI[u][1] * R[v][1] + RI[u][2] * R[v][2];
  }
  for (int j = lane; j < NJ; j += 32) {
    const int b = ji[j * JNT_I];
    float r[3];
    qrot(bquat + 4 * b, jf + j * JNT_F, axis + 3 * j);
    qrot(bquat + 4 * b, jf + j * JNT_F + 3, r);
    for (int k = 0; k < 3; ++k) anchor[3 * j + k] = bpos[3 * b + k] + r[k];
  }
  __syncwarp();

  // 3. M's upper triangle: M_kj = sum over the bodies that joints k and j
  // both move of m Jv_k . Jv_j + Jw_k^T I_w Jw_j (Jv at the COM, Jw the
  // axis of a hinge, zero for a slide), plus the armature on the diagonal.
  for (int e = lane; e < NP; e += 32) {
    const int k = pairs[e] & 0xffff, j = pairs[e] >> 16;
    const bool hk = ji[k * JNT_I + 1] == HINGE, hj = ji[j * JNT_I + 1] == HINGE;
    const unsigned both = (1u << k) | (1u << j);
    float s = 0.f;
    for (int b = 0; b < NB; ++b) {
      if ((static_cast<unsigned>(bi[b * BODY_I + 4]) & both) != both) continue;
      float vk[3], vj[3];
      jac_col(axis + 3 * k, anchor + 3 * k, hk, com + 3 * b, vk);
      jac_col(axis + 3 * j, anchor + 3 * j, hj, com + 3 * b, vj);
      float t = bf[b * BODY_F + 13] * dot3(vk, vj);
      if (hk && hj) {
        const float* I = iw + 9 * b;
        const float* aj = axis + 3 * j;
        const float Ia[3] = {dot3(I, aj), dot3(I + 3, aj), dot3(I + 6, aj)};
        t += dot3(axis + 3 * k, Ia);
      }
      s += t;
    }
    if (k == j) s += jf[k * JNT_F + 6];
    M[k * NJ + j] = s;
    M[j * NJ + k] = s;
  }
  __syncwarp();

  // 4. A = M + dt diag(D) and its Cholesky factor L (lower, in place),
  // right-looking: the column of step k, then the trailing lower triangle.
  for (int e = lane; e < NJ * NJ; e += 32) {
    const int r = e / NJ;
    L[e] = (r == e - r * NJ) ? M[e] + jf[r * JNT_F + 7] : M[e];
  }
  __syncwarp();
  for (int k = 0; k < NJ; ++k) {
    const float dk = sqrtf(L[k * NJ + k]);
    for (int i = k + 1 + lane; i < NJ; i += 32) L[i * NJ + k] /= dk;
    __syncwarp();
    if (lane == 0) L[k * NJ + k] = dk;
    for (int e = lane; e < NP; e += 32) {
      const int c = pairs[e] & 0xffff, r = pairs[e] >> 16;
      if (c > k) L[r * NJ + c] -= L[r * NJ + k] * L[c * NJ + k];
    }
    __syncwarp();
  }

  // 5. A^-1, lane c its column c: L y = e_c, then L^T x = y.
  if (lane < NJ) {
    const int c = lane;
    for (int i = 0; i < NJ; ++i) {
      float s = (i == c) ? 1.f : 0.f;
      for (int k = c; k < i; ++k) s -= L[i * NJ + k] * X[k * NJ + c];
      X[i * NJ + c] = (i < c) ? 0.f : s / L[i * NJ + i];
    }
    for (int i = NJ - 1; i >= 0; --i) {
      float s = X[i * NJ + c];
      for (int k = i + 1; k < NJ; ++k) s -= L[k * NJ + i] * X[k * NJ + c];
      X[i * NJ + c] = s / L[i * NJ + i];
    }
  }
  __syncwarp();

  // 6. G1 = A^-1 M, G2 = dt A^-1.
  float* g1 = a.G1 + (size_t)env * NJ * NJ;
  float* g2 = a.G2 + (size_t)env * NJ * NJ;
  for (int e = lane; e < NJ * NJ; e += 32) {
    const int r = e / NJ, c = e - r * NJ;
    float s = 0.f;
    for (int k = 0; k < NJ; ++k) s += X[r * NJ + k] * M[k * NJ + c];
    g1[e] = s;
    g2[e] = a.dt * X[e];
  }
}

}  // namespace

extern "C" {

// layout constants the wrapper checks its tables against
int arm_dyn_max_nb() { return MAX_NB; }
int arm_dyn_max_nj() { return MAX_NJ; }
int arm_dyn_envs_per_block() { return ENVS; }
int arm_dyn_body_f() { return BODY_F; }
int arm_dyn_body_i() { return BODY_I; }
int arm_dyn_jnt_f() { return JNT_F; }
int arm_dyn_jnt_i() { return JNT_I; }
// dynamic shared memory of a block
int arm_dyn_smem_bytes(int NB, int NJ) {
  return 4 * (table_words(NB, NJ) + ENVS * env_words(NB, NJ));
}

// Launches the kernel on `stream`: G1, G2 [B,NJ,NJ] from qpos [B,NJ] and
// the robot's tables (NLEV: the chain's depth + 1). Returns the CUDA error
// code of the launch (0 on success).
int arm_dyn_matrices(const float* qpos, float* G1, float* G2, const float* body_f,
                     const int* body_i, const float* jnt_f, const int* jnt_i, const int* pairs,
                     int B, int NB, int NJ, int NLEV, float dt, void* stream) {
  if (NB < 1 || NB > MAX_NB || NJ < 1 || NJ > MAX_NJ || NLEV < 1 || NLEV > NB || B < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = arm_dyn_smem_bytes(NB, NJ);
  cudaError_t err = cudaFuncSetAttribute(arm_dyn_matrices_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    Args a{qpos, G1, G2, body_f, body_i, jnt_f, jnt_i, pairs, B, NB, NJ, NLEV, dt};
    arm_dyn_matrices_kernel<<<(B + ENVS - 1) / ENVS, 32 * ENVS, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* arm_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
