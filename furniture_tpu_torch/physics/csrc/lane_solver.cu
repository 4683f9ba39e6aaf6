// Lane contact solver: the Jacobi contact solve alone, one launch per solve.
//
// Replaces furniture_tpu/physics/pallas_solver.py::_kernel, the Pallas TPU
// kernel of the JAX package (reached through solve_contacts_pallas). It
// computes what that kernel computes: `iters` cold-started Jacobi sweeps
// over all contact lanes of one env. Each sweep takes the relative velocity
// at every lane from the part velocities, projects it on the normal and the
// two tangents, steps lambda by -target * inv_w * lane_scale, clamps the
// normal impulse at zero and the tangents to the friction cone, and applies
// the masked increment (lambda_new - lambda) * fmask to every part of both
// sides' rigid groups through the inverse mass and inverse inertia. The
// velocities are updated incrementally sweep by sweep (the warm-started
// solver of physics_common.cuh recomputes them from all of lambda instead,
// so the two share no sweep code). Returns the parts' velocities.
//
// The TPU layout is not carried over: no one-hot part rows, no padding of
// the lane axis to 128, no [8,128] part tile. Lanes carry part indices, the
// group labels come as [B,P], and any number of parts P works.
//
// What bounds it on the H100. The wrapper hands the kernel 25 floats per
// lane and 17 per part and gets 6 per part back: 21.5 KB per env on
// table_lack (K = 210, P = 5), 88 MB at B = 4096, 0.026 ms of HBM
// bandwidth. A sweep is about 25 k FP32 operations per env, 0.3 M for 12
// sweeps, 1.2 GFLOP at B = 4096: 0.018 ms at the FP32 peak. Both bounds are
// of one order; the bytes bind. The sweeps are dependent, with two block
// barriers each, so the time a block takes is latency, hidden only by
// running many blocks per SM.
//
// What the design does about that: one thread block per env; a lane's 25
// constants are read once, coalesced along the lane axis, into registers
// when the env has no more lanes than the block has threads (else they are
// re-read each sweep through the cache); the part velocities live in shared
// memory. Each sweep has two phases. A: every lane computes its impulse
// increment and its two torques and leaves them in the lane work buffer. B:
// one warp per part scans all lanes in a fixed order (per-thread strides,
// then warp shuffles), adds the lanes whose side-a or side-b group is the
// part's group, and updates that part's velocities. No float atomics, so a
// launch repeats bit for bit. The work buffer (13 floats per lane) lives in
// dynamic shared memory when it fits the 227 KB opt-in limit, else in a
// global scratch buffer the wrapper allocates; one pointer serves both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// lane fields of the input, field-major: lanes[(b * NLF + f) * K + k]
enum LaneField {
  L_N = 0, L_T1 = 3, L_T2 = 6, L_RA = 9, L_RB = 12, L_IW = 15,
  L_BIAS = 18, L_FRIC = 19, L_SCALE = 20, L_MASK = 21, L_VB = 22,
  NLF = 25
};

// lane work buffer, field-major: work[f * K + k]
enum WorkField {
  W_IMP = 0,    // impulse increment on side a, 0..2
  W_TQA = 3,    // r_a x imp, 3..5
  W_TQB = 6,    // r_b x (-imp), 6..8
  W_CODE = 9,   // int: group of side a | group of side b << 16 (0xffff: none)
  W_LAM = 10,   // lambda 10..12 (only when the lanes are not in registers)
  NW = 13
};

// per-part shared fields, field-major: sp[f * P + p]
enum PartField { S_LV = 0, S_AV = 3, S_IM = 6, S_II = 7, PF = 16 };

struct Params {
  const float* lanes;     // [B,NLF,K]
  const int* part_a;      // [K]
  const int* part_b;      // [K], -1: no side b
  const int* group;       // [B,P]
  const float* lin;       // [B,P,3]
  const float* ang;       // [B,P,3]
  const float* inv_mass;  // [B,P]
  const float* inv_inertia;  // [B,P,9] row-major
  float* lin_out;         // [B,P,3]
  float* ang_out;         // [B,P,3]
  float* scratch;         // [B, NW*K] or null (work buffer in shared memory)
  int P, K, iters;
};

struct Lane {
  float n[3], t1[3], t2[3], ra[3], rb[3], iw[3];
  float bias, fric, scale, mask, vb[3];
  int pa, pb;
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ Lane load_lane(const float* L, const int* part_a,
                                          const int* part_b, int K, int k) {
  Lane c;
  for (int d = 0; d < 3; ++d) {
    c.n[d] = L[(L_N + d) * K + k];
    c.t1[d] = L[(L_T1 + d) * K + k];
    c.t2[d] = L[(L_T2 + d) * K + k];
    c.ra[d] = L[(L_RA + d) * K + k];
    c.rb[d] = L[(L_RB + d) * K + k];
    c.iw[d] = L[(L_IW + d) * K + k];
    c.vb[d] = L[(L_VB + d) * K + k];
  }
  c.bias = L[L_BIAS * K + k];
  c.fric = L[L_FRIC * K + k];
  c.scale = L[L_SCALE * K + k];
  c.mask = L[L_MASK * K + k];
  c.pa = part_a[k];
  c.pb = part_b[k];
  return c;
}

// Phase A for one lane: lambda step, clamps, and the masked increment's
// impulse and torques into the work buffer. `lam` is updated in place.
__device__ __forceinline__ void lane_sweep(const Lane& c, const float* sp, int P,
                                           float* work, int K, int k, float* lam) {
#define SPF(f, i) sp[(f) * P + (i)]
  float wa[3] = {SPF(S_AV, c.pa), SPF(S_AV + 1, c.pa), SPF(S_AV + 2, c.pa)};
  float cw[3], vr[3];
  cross3(wa, c.ra, cw);
  for (int d = 0; d < 3; ++d) vr[d] = SPF(S_LV + d, c.pa) + cw[d];
  float vb[3] = {c.vb[0], c.vb[1], c.vb[2]};
  if (c.pb >= 0) {
    float wb[3] = {SPF(S_AV, c.pb), SPF(S_AV + 1, c.pb), SPF(S_AV + 2, c.pb)};
    float cb[3];
    cross3(wb, c.rb, cb);
    for (int d = 0; d < 3; ++d) vb[d] += SPF(S_LV + d, c.pb) + cb[d];
  }
#undef SPF
  for (int d = 0; d < 3; ++d) vr[d] -= vb[d];
  const float vd0 = vr[0] * c.n[0] + vr[1] * c.n[1] + vr[2] * c.n[2];
  const float vd1 = vr[0] * c.t1[0] + vr[1] * c.t1[1] + vr[2] * c.t1[2];
  const float vd2 = vr[0] * c.t2[0] + vr[1] * c.t2[1] + vr[2] * c.t2[2];
  const float l0 = lam[0] - (vd0 + c.bias) * c.iw[0] * c.scale;
  const float l1 = lam[1] - vd1 * c.iw[1] * c.scale;
  const float l2 = lam[2] - vd2 * c.iw[2] * c.scale;
  const float ln = fmaxf(l0, 0.f);
  const float mf = c.fric * ln;
  const float n1 = fminf(fmaxf(l1, -mf), mf);
  const float n2 = fminf(fmaxf(l2, -mf), mf);
  const float d0 = (ln - lam[0]) * c.mask;
  const float d1 = (n1 - lam[1]) * c.mask;
  const float d2 = (n2 - lam[2]) * c.mask;
  lam[0] = ln;
  lam[1] = n1;
  lam[2] = n2;
  float imp[3], nimp[3], tqa[3], tqb[3];
  for (int d = 0; d < 3; ++d) {
    imp[d] = d0 * c.n[d] + d1 * c.t1[d] + d2 * c.t2[d];
    nimp[d] = -imp[d];
  }
  cross3(c.ra, imp, tqa);
  cross3(c.rb, nimp, tqb);
  for (int d = 0; d < 3; ++d) {
    work[(W_IMP + d) * K + k] = imp[d];
    work[(W_TQA + d) * K + k] = tqa[d];
    work[(W_TQB + d) * K + k] = tqb[d];
  }
}

// REG: the env has at most blockDim.x lanes; each thread keeps its lane's
// constants and lambda in registers for the whole launch.
template <bool REG>
__global__ void __launch_bounds__(256)
lane_solve_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int P = p.P, K = p.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  float* sp = smem;                                     // [PF * P]
  int* grp = reinterpret_cast<int*>(sp + PF * P);       // [P]
  float* work = p.scratch ? p.scratch + (size_t)b * NW * K
                          : reinterpret_cast<float*>(grp + P);
  int* code = reinterpret_cast<int*>(work + W_CODE * K);
  const float* L = p.lanes + (size_t)b * NLF * K;

  for (int i = tid; i < P; i += nt) {
    const size_t o = (size_t)b * P + i;
    for (int d = 0; d < 3; ++d) {
      sp[(S_LV + d) * P + i] = p.lin[o * 3 + d];
      sp[(S_AV + d) * P + i] = p.ang[o * 3 + d];
    }
    sp[S_IM * P + i] = p.inv_mass[o];
    for (int d = 0; d < 9; ++d) sp[(S_II + d) * P + i] = p.inv_inertia[o * 9 + d];
    grp[i] = p.group[o];
  }
  __syncthreads();
  for (int k = tid; k < K; k += nt) {
    const int pa = p.part_a[k], pb = p.part_b[k];
    const int ga = grp[pa] & 0xffff;
    const int gb = pb >= 0 ? (grp[pb] & 0xffff) : 0xffff;
    code[k] = ga | (gb << 16);
    if (!REG) {
      work[W_LAM * K + k] = 0.f;
      work[(W_LAM + 1) * K + k] = 0.f;
      work[(W_LAM + 2) * K + k] = 0.f;
    }
  }
  Lane mine;
  float lam[3] = {0.f, 0.f, 0.f};
  if (REG && tid < K) mine = load_lane(L, p.part_a, p.part_b, K, tid);
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    // A: every lane's increment
    if (REG) {
      if (tid < K) lane_sweep(mine, sp, P, work, K, tid, lam);
    } else {
      for (int k = tid; k < K; k += nt) {
        const Lane c = load_lane(L, p.part_a, p.part_b, K, k);
        float l[3] = {work[W_LAM * K + k], work[(W_LAM + 1) * K + k],
                      work[(W_LAM + 2) * K + k]};
        lane_sweep(c, sp, P, work, K, k, l);
        work[W_LAM * K + k] = l[0];
        work[(W_LAM + 1) * K + k] = l[1];
        work[(W_LAM + 2) * K + k] = l[2];
      }
    }
    __syncthreads();
    // B: one warp per part sums the lanes of its group, in a fixed order
    for (int i = warp; i < P; i += nwarps) {
      const int gp = grp[i] & 0xffff;
      float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k = lane; k < K; k += 32) {
        const int cd = code[k];
        const bool ma = (cd & 0xffff) == gp;
        const bool mb = ((cd >> 16) & 0xffff) == gp;
        if (ma != mb) {
          const float w = ma ? 1.f : -1.f;
          for (int d = 0; d < 3; ++d) s[d] += w * work[(W_IMP + d) * K + k];
        }
        if (ma)
          for (int d = 0; d < 3; ++d) s[3 + d] += work[(W_TQA + d) * K + k];
        if (mb)
          for (int d = 0; d < 3; ++d) s[3 + d] += work[(W_TQB + d) * K + k];
      }
      for (int d = 0; d < 6; ++d) s[d] = warp_sum(s[d]);
      if (lane == 0) {
        const float im = sp[S_IM * P + i];
        for (int d = 0; d < 3; ++d) {
          sp[(S_LV + d) * P + i] += s[d] * im;
          sp[(S_AV + d) * P + i] += sp[(S_II + d * 3) * P + i] * s[3] +
                                    sp[(S_II + d * 3 + 1) * P + i] * s[4] +
                                    sp[(S_II + d * 3 + 2) * P + i] * s[5];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < P; i += nt) {
    const size_t o = (size_t)b * P + i;
    for (int d = 0; d < 3; ++d) {
      p.lin_out[o * 3 + d] = sp[(S_LV + d) * P + i];
      p.ang_out[o * 3 + d] = sp[(S_AV + d) * P + i];
    }
  }
}

}  // namespace

extern "C" {

// layout constants the wrapper sizes its buffers with
int lane_fields() { return NLF; }
int lane_work_floats() { return NW; }
int lane_part_floats() { return PF; }

// Launches the solve on `stream` with one block of `threads` threads per
// env. `scratch` null keeps the lane work buffer in dynamic shared memory.
// Returns the CUDA error code of the launch (0 on success).
int lane_solve(const void* lanes, const void* part_a, const void* part_b,
               const void* group, const void* lin, const void* ang,
               const void* inv_mass, const void* inv_inertia, void* lin_out,
               void* ang_out, void* scratch, int B, int P, int K, int iters,
               int threads, int smem_bytes, void* stream) {
  Params p;
  p.lanes = static_cast<const float*>(lanes);
  p.part_a = static_cast<const int*>(part_a);
  p.part_b = static_cast<const int*>(part_b);
  p.group = static_cast<const int*>(group);
  p.lin = static_cast<const float*>(lin);
  p.ang = static_cast<const float*>(ang);
  p.inv_mass = static_cast<const float*>(inv_mass);
  p.inv_inertia = static_cast<const float*>(inv_inertia);
  p.lin_out = static_cast<float*>(lin_out);
  p.ang_out = static_cast<float*>(ang_out);
  p.scratch = static_cast<float*>(scratch);
  p.P = P;
  p.K = K;
  p.iters = iters;
  const bool reg = K <= threads;
  cudaError_t err = reg
      ? cudaFuncSetAttribute(lane_solve_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes)
      : cudaFuncSetAttribute(lane_solve_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (reg)
      lane_solve_kernel<true><<<B, threads, smem_bytes, s>>>(p);
    else
      lane_solve_kernel<false><<<B, threads, smem_bytes, s>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* lane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
