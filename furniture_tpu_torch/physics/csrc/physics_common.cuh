// Device code shared by the port's two physics kernels (megakernel.cu, the
// free-part kernel, and arm_megakernel.cu, the coupled arm + parts kernel).
//
// Both kernels give each env one thread block that runs the whole
// n-substep loop. What binds them on the H100 is not memory (a few hundred
// bytes of state per env and launch) and not the FP32 rate, but the chain of
// 13 dependent solver passes a substep, each of which has to sum every
// lane's impulse into its parts: instruction issue and the latency of the
// stretches between block barriers. So the layout keeps every pass short,
// every warp busy in the lane half, and the code of a substep small:
//
//   * Slots. The wrapper sorts the contact lanes by their a-side part and
//     deals them to "slots" so that the lanes of one segment (SEGW threads
//     of a warp, times the LPT rounds a thread makes) all have the same
//     part on their a side; segments are padded with dummy slots (kind
//     KIND_PAD). All static tables (lane constants, part indices, lane
//     kind) come in slot order, padded to 16-byte rows; the small ones are
//     copied to shared memory once a launch.
//   * One lane half per pass. The thread that owns a lane updates its
//     lambda, then computes the masked impulse and the two torques
//     r_a x imp and -(r_b x imp) once (a lane whose mask is 0 keeps its
//     lambda up to date, as the plain version does, but adds nothing after
//     the first pass, so it skips the impulse). With one lane per thread
//     (REGS) the
//     lane's whole working set (n, t1, t2, r_a, r_b, inv_w * scale, bias,
//     friction, mask, lambda, its part indices) stays in registers for
//     the substep; otherwise it lives field-major in shared memory (the
//     free-part kernel's largest models: the shared memories of a
//     thread-block cluster, see megakernel.cu) or a global scratch buffer
//     (the arm kernel) and the thread loops over its LPT lanes.
//   * Deterministic sums. The a side is reduced with warp shuffles inside
//     each segment, the six columns folded as they go (7 shuffles for 16
//     lanes): one partial per (segment, column). The b side (pair and SAT
//     lanes only) goes to a buffer ordered by b-side part, impulse negated.
//     No float atomics: a repeated launch gives the same bits.
//   * One group half per pass. The rigid groups do not change inside a
//     launch, so each group's members and the entries its sums take
//     (partials and b-buffer entries) are listed once (build_group_lists).
//     One warp per group adds the listed entries, 8 columns wide, lane
//     (chunk, column) taking every fourth entry, and gives every member its
//     velocity: a group is summed once however many parts it has. The last
//     pass goes on, in the same warp, to the velocity clamp, the
//     integration about the group COM and the floor projection; the same
//     warp then starts the next substep (part frames, group aggregates,
//     gravity) without a block barrier in between.
//   * One loop. The first pass (SAT gate, capped warm start, active-lane
//     counts as a seventh column) and the passes after it are iterations of
//     one loop, and every phase is instantiated once, so a substep's code
//     is ~55 KB for the free-part kernel (it was ~140 KB with the phases
//     inlined per call site, which cost more than any barrier). Arrays a
//     winner would index (SAT axes, box faces) are kept by value: indexed,
//     they go to local memory.
//
// A substep has two block barriers per solver pass plus one (arm: two),
// and all of a block's warps work in the lane half. Where the JAX package's
// two paths differ, this code follows engine.py, the plain version it is
// held against (see megakernel.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace furniture {

// words rounded up to a 16-byte boundary
__host__ __device__ __forceinline__ int align4(int words) { return (words + 3) & ~3; }

// lane-constant row in slot order: geometry (20), friction, beta, padded to
// six 16-byte loads
constexpr int LC = 24;
constexpr int LC_FRIC = 20;
constexpr int LC_BETA = 21;

// per-slot ints, one 16-byte row: the packed word (a-side part, b-side part
// + 1, kind, b-buffer index + 1), two kind-specific values (SAT lane: its
// pair; robot lane: hand-geom slot and finger code), one unused
constexpr int SI = 4;
constexpr int MAX_B_ENTRIES = 8190;   // the b-buffer index has 13 bits
enum LaneKind {
  KIND_PAD = 0, KIND_FLOOR = 1, KIND_VERTEX = 2, KIND_SAT = 3,
  KIND_ROBOT1 = 4,   // a sample point of the part geom in a robot box
  KIND_ROBOT2 = 5    // a sample point of the robot geom in a part box
};
__host__ __device__ __forceinline__ int pk_part_a(int pk) { return pk & 0xff; }
__host__ __device__ __forceinline__ int pk_part_b(int pk) { return ((pk >> 8) & 0xff) - 1; }
__host__ __device__ __forceinline__ int pk_kind(int pk) { return (pk >> 16) & 0x7; }
__host__ __device__ __forceinline__ int pk_b_slot(int pk) { return ((pk >> 19) & 0x1fff) - 1; }

// The static tables a block copies into shared memory at its start, in
// words after the block's other fixed fields: the solver passes read them in
// every group pass, and a global load there is hundreds of cycles on the
// critical path. slots = 0 leaves out the packed slot words (one lane per
// thread: they are in registers). The wrapper sizes the launch with the
// same function.
struct TableLayout {
  int seg_off, b_off, floor_off, sat_corner, sat_slot, slot_pk, floor_cn, total;
  __host__ __device__ TableLayout(int P, int n_floor, int n_sat, int slots) {
    int o = 0;
    seg_off = o; o += P + 1;
    b_off = o; o += P + 1;
    floor_off = o; o += P + 1;
    sat_corner = o; o += 16 * n_sat;
    sat_slot = o; o += n_sat;
    slot_pk = o; o += slots;
    floor_cn = o; o += 3 * n_floor;      // floats: the floor lanes' corners
    total = align4(o);
  }
};

// per-lane working set when it lives in memory, field-major:
// lanes[f * KS + slot]. With one lane per thread only the mask is in memory.
enum LaneField {
  F_MASK = 0,
  NF_REGS = 1,   // fields in memory when the rest is in registers
  F_LAM = 1,     // lambda 1..3
  F_N = 4,       // normal
  F_T1 = 7,      // tangent 1
  F_T2 = 10,     // tangent 2
  F_RA = 13,     // r_a
  F_RB = 16,     // r_b; robot lanes: the prescribed b-side velocity
  F_IW = 19,     // inv_w per direction (times the lane scale once counted)
  F_BIAS = 22,
  F_FRIC = 23,
  NF = 24,       // fields of the free-part kernel
  F_DEPTH = 24,  // penetration depth (arm kernel: the squeeze servo reads it)
  NF_ARM = 25
};

// a partial sum or b-buffer entry: impulse (3), torque (3), active-lane
// count, one pad: two 16-byte words
constexpr int NCOL = 8;

// per-part shared fields, part-major: sp[p * PF + f] (one multiply per part,
// constant offsets per field; S_LV..S_AV start a 16-byte word)
enum PartField {
  S_POS = 0, S_QUAT = 3, S_LIN = 7, S_ANG = 10, S_GS = 13,
  S_MASS = 14, S_COML = 15, S_IL = 18,
  S_COMW = 27, S_IW = 30, S_IGM = 39, S_GCOM = 40, S_INVI = 43,
  S_LV = 52, S_AV = 55, S_CNT = 58,
  PF = 60
};


// Phase clocks: a build with -DFT_PHASE_CLOCKS has thread 0 of each block add
// up the card's clock between the barriers of a substep, per phase, into a
// [B, NPHASE] output; its last column counts the block barriers the substep
// loop passed (every barrier of the loop goes through sync()). The timed and
// the checked kernel is the build without the define, where this struct is
// empty, sync() is the bare barrier and every other call a no-op.
constexpr int NPHASE = 8;
constexpr int PHASE_BARRIERS = NPHASE - 1;
#ifdef FT_PHASE_CLOCKS
struct PhaseClock {
  long long last;
  long long acc[NPHASE];
  __device__ __forceinline__ void start() {
    for (int i = 0; i < NPHASE; ++i) acc[i] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int phase) {
    if (threadIdx.x == 0) {
      const long long t = clock64();
      acc[phase] += t - last;
      last = t;
    }
  }
  __device__ __forceinline__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) ++acc[PHASE_BARRIERS];
  }
  __device__ __forceinline__ void store(long long* out, int b) const {
    if (threadIdx.x == 0 && out)
      for (int i = 0; i < NPHASE; ++i) out[(size_t)b * NPHASE + i] = acc[i];
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ void store(long long*, int) const {}
};
#endif

// One block's view of its env: the part fields and group labels in shared
// memory, the lane working set (shared memory or global scratch), the
// reduction buffers, the constant tables in slot order, and the thread's
// place in the block.
struct Block {
  float* sp;                 // [PF * P]
  int* grp;                  // [P]
  float* lanes;              // [NF_REGS or NF or NF_ARM][KS]
  float* bbuf;               // [NBS][NCOL] b-side impulse, torque, mask
  float* part;               // [NSEG][NCOL] a-side partial sums
  const float4* lane_const;  // [KS][LC / 4], global
  const int4* slot_i;        // [KS], global
  // copies in shared memory (TableLayout)
  const int* seg_off;        // [P+1] each part's range of segments
  const int* b_off;          // [P+1] each part's range of b-buffer entries
  const int* floor_off;      // [P+1] each part's range in floor_cn
  const int* sat_corner;     // [Ke][16] slots of each SAT lane's corner lanes
  const int* sat_slot;       // [Ke] slot of each SAT lane
  int Ke;
  const int* slot_pk;        // [KS] packed slot words (not with one lane per thread)
  const float* floor_cn;     // [Kf][3] corners of the floor lanes, by part
  // the rigid groups of this launch (build_group_lists)
  const int* gl_off;         // [ngroups+1] each group's range in gl_mem
  const int* gl_mem;         // [P] member parts, group by group, ascending
  const int* gl_eoff;        // [ngroups+1] each group's range in gl_ent
  const int* gl_ent;         // [NSEG+NBS] what a group sums: word offsets of its
                             // members' a-side partials (from `part`) and, from
                             // NSEG * NCOL on, of their b-side entries (from `bbuf`)
  int ngroups;
  int P, KS, LPT, NSEG, NBS, iters;
  float dt, dtg, slop, relax, maxv;
  int tid, nt, warp, lane, nwarps;
};

#define SP(f, i) c.sp[(i) * PF + (f)]
#define LN(f, k) c.lanes[(f) * c.KS + (k)]

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// R(q) v = v + 2 (w (u x v) + u x (u x v)), q = (w, u) in wxyz
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
  for (int c = 0; c < 3; ++c) o[c] = v[c] + 2.f * (q[0] * uv[c] + uuv[c]);
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// rows of the rotation matrix of q / max(|q|, 1e-12)
__device__ __forceinline__ void qmat(const float* q0, float R[3][3]) {
  float nq = sqrtf(q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2] + q0[3] * q0[3]);
  const float rn = 1.f / fmaxf(nq, 1e-12f);
  float w = q0[0] * rn, x = q0[1] * rn, y = q0[2] * rn, z = q0[3] * rn;
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - w * z);
  R[0][2] = 2.f * (x * z + w * y);
  R[1][0] = 2.f * (x * y + w * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - w * x);
  R[2][0] = 2.f * (x * z - w * y);
  R[2][1] = 2.f * (y * z + w * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// World `point` against the box (bpos, bquat, half extents `size`): the
// penetration along the least-penetrated axis, that face's outward normal in
// the world frame, and whether the point lies within `slop` of the box.
__device__ __forceinline__ void point_in_box(const float* point, const float* bpos,
                                             const float* bquat, const float* size,
                                             float slop, float* depth, float* nrm,
                                             bool* inside) {
  float rel[3];
  for (int j = 0; j < 3; ++j) rel[j] = point[j] - bpos[j];
  float qn = bquat[0] * bquat[0] + bquat[1] * bquat[1] + bquat[2] * bquat[2] +
             bquat[3] * bquat[3];
  const float rq = 1.f / fmaxf(qn, 1e-12f);
  float qi[4] = {bquat[0] * rq, -bquat[1] * rq, -bquat[2] * rq, -bquat[3] * rq};
  float loc[3];
  qrot(qi, rel, loc);
  float pen[3];
  for (int j = 0; j < 3; ++j) pen[j] = size[j] - fabsf(loc[j]);
  *inside = (pen[0] > -slop) && (pen[1] > -slop) && (pen[2] > -slop);
  // selects, not an indexed array: that would live in local memory
  int ax = 0;
  float least = pen[0];
  if (pen[1] < least) {
    ax = 1;
    least = pen[1];
  }
  if (pen[2] < least) {
    ax = 2;
    least = pen[2];
  }
  *depth = least;
  const float nl[3] = {ax == 0 ? sgnf(loc[0]) : 0.f, ax == 1 ? sgnf(loc[1]) : 0.f,
                       ax == 2 ? sgnf(loc[2]) : 0.f};
  qrot(bquat, nl, nrm);
}

// SAT box-box single-contact test (collide.edge_contacts of the JAX package):
// 6 face + 9 edge-cross axes; the contact is on the minimum-overlap axis at
// the midpoint of the closest points of the two supporting edges.
__device__ inline void edge_sat(const float* qa, const float* ca, const float* SA,
                                const float* qb, const float* cb, const float* SB,
                                float slop, float* pt, float* nrm, float* depth,
                                bool* inter) {
  float Ra[3][3], Rb[3][3];
  qmat(qa, Ra);
  qmat(qb, Rb);
  float a_ax[3][3], b_ax[3][3];  // [axis][world]: columns of R
  for (int k = 0; k < 3; ++k)
    for (int d = 0; d < 3; ++d) {
      a_ax[k][d] = Ra[d][k];
      b_ax[k][d] = Rb[d][k];
    }
  float t[3] = {cb[0] - ca[0], cb[1] - ca[1], cb[2] - ca[2]};
  float absAB[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) absAB[i][j] = fabsf(dot3(a_ax[i], b_ax[j]));

  // face axes in the order a0 a1 a2 b0 b1 b2 (first minimum wins)
  float face_ov = 0.f, face_n[3] = {0.f, 0.f, 0.f};
  bool all_pos = true;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const int k = f % 3;
    float ov, tax;
    const float* ax;
    if (f < 3) {
      ax = a_ax[k];
      tax = dot3(t, ax);
      ov = SA[k] + (SB[0] * absAB[k][0] + SB[1] * absAB[k][1] + SB[2] * absAB[k][2]) -
           fabsf(tax);
    } else {
      ax = b_ax[k];
      tax = dot3(t, ax);
      ov = (SA[0] * absAB[0][k] + SA[1] * absAB[1][k] + SA[2] * absAB[2][k]) + SB[k] -
           fabsf(tax);
    }
    all_pos = all_pos && (ov > -slop);
    if (f == 0 || ov < face_ov) {
      face_ov = ov;
      const float s = sgnf(tax);
      for (int c = 0; c < 3; ++c) face_n[c] = -s * ax[c];
    }
  }

  // 9 cross axes n_ij = a_i x b_j, row-major (i, j), first minimum wins
  // (the winning pair's edge directions and half lengths are kept by value:
  // an array indexed by the winner would live in local memory)
  float best_ov = 0.f, best_n[3] = {0.f, 0.f, 0.f};
  float d1[3] = {0.f, 0.f, 0.f}, d2[3] = {0.f, 0.f, 0.f}, h1 = 0.f, h2 = 0.f;
  int bi = 0, bj = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float nr[3];
      cross3(a_ax[i], b_ax[j], nr);
      const float n_len = sqrtf(dot3(nr, nr));
      const float inv = 1.f / fmaxf(n_len, 1e-12f);
      float nh[3] = {nr[0] * inv, nr[1] * inv, nr[2] * inv};
      float rA = 0.f, rB = 0.f;
      for (int m = 0; m < 3; ++m) {
        rA += SA[m] * fabsf(dot3(a_ax[m], nh));
        rB += SB[m] * fabsf(dot3(b_ax[m], nh));
      }
      const float t_n = dot3(t, nh);
      float ov = rA + rB - fabsf(t_n);
      if (n_len < 1e-6f) ov = 1e9f;
      if ((i == 0 && j == 0) || ov < best_ov) {
        best_ov = ov;
        bi = i;
        bj = j;
        h1 = SA[i];
        h2 = SB[j];
        const float flip = t_n > 0.f ? -1.f : 1.f;  // orient B -> A
        for (int c = 0; c < 3; ++c) {
          best_n[c] = flip * nh[c];
          d1[c] = a_ax[i][c];
          d2[c] = b_ax[j][c];
        }
      }
    }

  const bool use_face = face_ov < best_ov;
  float n_out[3];
  for (int c = 0; c < 3; ++c) n_out[c] = use_face ? face_n[c] : best_n[c];
  *depth = fminf(face_ov, best_ov);

  // supporting edges of the chosen cross axis, anchored along -n_out (A)
  // and +n_out (B)
  float pa0[3] = {ca[0], ca[1], ca[2]};
  float pb0[3] = {cb[0], cb[1], cb[2]};
  float off_a[3] = {0.f, 0.f, 0.f}, off_b[3] = {0.f, 0.f, 0.f};
  float neg_n[3] = {-n_out[0], -n_out[1], -n_out[2]};
  for (int m = 0; m < 3; ++m) {
    const float sa = (m == bi) ? 0.f : SA[m] * sgnf(dot3(a_ax[m], neg_n));
    const float sb = (m == bj) ? 0.f : SB[m] * sgnf(dot3(b_ax[m], n_out));
    for (int c = 0; c < 3; ++c) {
      off_a[c] += sa * a_ax[m][c];
      off_b[c] += sb * b_ax[m][c];
    }
  }
  for (int c = 0; c < 3; ++c) {
    pa0[c] += off_a[c];
    pb0[c] += off_b[c];
  }
  float r12[3] = {pb0[0] - pa0[0], pb0[1] - pa0[1], pb0[2] - pa0[2]};
  const float d12 = dot3(d1, d2);
  const float denom = fmaxf(1.f - d12 * d12, 1e-9f);
  const float r_d1 = dot3(r12, d1);
  const float r_d2 = dot3(r12, d2);
  const float s1 = fminf(fmaxf((r_d1 - d12 * r_d2) / denom, -h1), h1);
  const float s2 = fminf(fmaxf((d12 * r_d1 - r_d2) / denom, -h2), h2);
  for (int c = 0; c < 3; ++c) {
    pt[c] = 0.5f * (pa0[c] + s1 * d1[c] + pb0[c] + s2 * d2[c]);
    nrm[c] = n_out[c];
  }
  *inter = all_pos && (best_ov > -slop);
}

// The registers of one lane: what a solver pass reads and writes.
struct LaneRegs {
  float n[3], t1[3], t2[3], ra[3], rb[3], iw[3], bias, fric, mask, lam[3];
};

// segment of this thread (all LPT rounds of a thread lie in one segment)
template <int SEGW>
__device__ __forceinline__ int thread_segment(const Block& c) {
  return c.warp * (32 / SEGW) + c.lane / SEGW;
}

// slot of this thread's round r
__device__ __forceinline__ int thread_slot(const Block& c, int r) {
  return (c.warp * c.LPT + r) * 32 + c.lane;
}

__device__ __forceinline__ void load_lane(const Block& c, int k, LaneRegs& L) {
  L.mask = LN(F_MASK, k);
  for (int d = 0; d < 3; ++d) {
    L.lam[d] = LN(F_LAM + d, k);
    L.n[d] = LN(F_N + d, k);
    L.t1[d] = LN(F_T1 + d, k);
    L.t2[d] = LN(F_T2 + d, k);
    L.ra[d] = LN(F_RA + d, k);
    L.rb[d] = LN(F_RB + d, k);
    L.iw[d] = LN(F_IW + d, k);
  }
  L.bias = LN(F_BIAS, k);
  L.fric = LN(F_FRIC, k);
}

// everything but lambda, which the sweeps own
__device__ __forceinline__ void store_lane_prep(const Block& c, int k, const LaneRegs& L) {
  LN(F_MASK, k) = L.mask;
  for (int d = 0; d < 3; ++d) {
    LN(F_N + d, k) = L.n[d];
    LN(F_T1 + d, k) = L.t1[d];
    LN(F_T2 + d, k) = L.t2[d];
    LN(F_RA + d, k) = L.ra[d];
    LN(F_RB + d, k) = L.rb[d];
    LN(F_IW + d, k) = L.iw[d];
  }
  LN(F_BIAS, k) = L.bias;
  LN(F_FRIC, k) = L.fric;
}

__device__ __forceinline__ void store_lambda(const Block& c, int k, const LaneRegs& L) {
  for (int d = 0; d < 3; ++d) LN(F_LAM + d, k) = L.lam[d];
}

// the 16-byte-aligned constant row of a slot
__device__ __forceinline__ void load_lane_const(const Block& c, int k, float* lc) {
  const float4* row = c.lane_const + (size_t)k * (LC / 4);
  for (int j = 0; j < LC / 4; ++j) {
    const float4 v = __ldg(row + j);
    lc[4 * j] = v.x;
    lc[4 * j + 1] = v.y;
    lc[4 * j + 2] = v.z;
    lc[4 * j + 3] = v.w;
  }
}

// Load one env's part state and the part constants.
__device__ __forceinline__ void load_parts(const Block& c, int b, const float* pos,
                                           const float* quat, const float* lin,
                                           const float* ang, const int* group,
                                           const float* gscale, const float* part_const) {
  const int P = c.P;
  for (int i = c.tid; i < P; i += c.nt) {
    const size_t o = (size_t)b * P + i;
    for (int d = 0; d < 3; ++d) {
      SP(S_POS + d, i) = pos[o * 3 + d];
      SP(S_LIN + d, i) = lin[o * 3 + d];
      SP(S_ANG + d, i) = ang[o * 3 + d];
    }
    for (int d = 0; d < 4; ++d) SP(S_QUAT + d, i) = quat[o * 4 + d];
    SP(S_GS, i) = gscale[o];
    c.grp[i] = group[o];
    for (int d = 0; d < 13; ++d) SP(S_MASS + d, i) = part_const[i * 13 + d];
  }
}

__device__ __forceinline__ void store_parts(const Block& c, int b, float* pos, float* quat,
                                            float* lin, float* ang) {
  const int P = c.P;
  for (int i = c.tid; i < P; i += c.nt) {
    const size_t o = (size_t)b * P + i;
    for (int d = 0; d < 3; ++d) {
      pos[o * 3 + d] = SP(S_POS + d, i);
      lin[o * 3 + d] = SP(S_LIN + d, i);
      ang[o * 3 + d] = SP(S_ANG + d, i);
    }
    for (int d = 0; d < 4; ++d) quat[o * 4 + d] = SP(S_QUAT + d, i);
  }
}

// words of shared memory for the group labels and the group lists: grp [P],
// first member of each part's group [P], gl_off [P+1], gl_mem [P], ngroups,
// gl_eoff [P+1], gl_ent [NSEG+NBS]
__host__ __device__ __forceinline__ int group_words(int P, int NSEG, int NBS) {
  return align4(5 * P + 3 + NSEG + NBS);
}

// The rigid groups of this launch, from the labels in c.grp (they do not
// change inside a launch): the groups in the order of their first members,
// each with its members ascending, and for each group the list of the
// entries its group pass adds up (its members' a-side partials and b-side
// entries). `store` is the block's group_words ints, c.grp at its start.
// The labels and the staged tables must be in place behind a block barrier;
// ends with one.
__device__ __forceinline__ void build_group_lists(Block& c, int* store) {
  const int P = c.P;
  int* first = store + P;
  int* off = first + P;
  int* mem = off + P + 1;
  int* count = mem + P;
  int* eoff = count + 1;
  int* ent = eoff + P + 1;
  for (int i = c.tid; i < P; i += c.nt) {
    const int gi = c.grp[i];
    int f = i;
    for (int q = i - 1; q >= 0; --q)
      if (c.grp[q] == gi) f = q;
    first[i] = f;
  }
  __syncthreads();
  for (int i = c.tid; i < P; i += c.nt) {
    const int fi = first[i];
    int g = 0, o = 0, rank = 0;
    for (int q = 0; q < P; ++q) {
      const int fq = first[q];
      g += (fq == q && q < fi);
      o += (fq < fi);
      rank += (fq == fi && q < i);
    }
    mem[o + rank] = i;
    if (fi == i) off[g] = o;
  }
  if (c.tid == 0) {
    int n = 0;
    for (int q = 0; q < P; ++q) n += (first[q] == q);
    off[n] = P;
    *count = n;
  }
  __syncthreads();
  const int ngroups = *count;
  for (int g = c.tid; g < ngroups; g += c.nt) {
    int e = 0;
    for (int m = 0; m < off[g]; ++m) {
      const int q = mem[m];
      e += (c.seg_off[q + 1] - c.seg_off[q]) + (c.b_off[q + 1] - c.b_off[q]);
    }
    eoff[g] = e;
    for (int m = off[g]; m < off[g + 1]; ++m) {
      const int q = mem[m];
      for (int a = c.seg_off[q]; a < c.seg_off[q + 1]; ++a) ent[e++] = a * NCOL;
      for (int bb = c.b_off[q]; bb < c.b_off[q + 1]; ++bb) ent[e++] = (c.NSEG + bb) * NCOL;
    }
    if (g == ngroups - 1) eoff[ngroups] = e;
  }
  // column 7 of a partial is never written by a pass
  for (int i = c.tid; i < NCOL * c.NSEG; i += c.nt) c.part[i] = 0.f;
  __syncthreads();
  c.gl_off = off;
  c.gl_mem = mem;
  c.gl_eoff = eoff;
  c.gl_ent = ent;
  c.ngroups = ngroups;
}

// ---- 1. COM and world inertia R I R^T of part i ----
__device__ __forceinline__ void part_frame(const Block& c, int i) {
  float q[4] = {SP(S_QUAT, i), SP(S_QUAT + 1, i), SP(S_QUAT + 2, i), SP(S_QUAT + 3, i)};
  float cl[3] = {SP(S_COML, i), SP(S_COML + 1, i), SP(S_COML + 2, i)};
  float rc[3];
  qrot(q, cl, rc);
  for (int d = 0; d < 3; ++d) SP(S_COMW + d, i) = SP(S_POS + d, i) + rc[d];
  float R[3][3];
  qmat(q, R);
  float RI[3][3];
  for (int r = 0; r < 3; ++r)
    for (int d = 0; d < 3; ++d)
      RI[r][d] = R[r][0] * SP(S_IL + 0 * 3 + d, i) + R[r][1] * SP(S_IL + 1 * 3 + d, i) +
                 R[r][2] * SP(S_IL + 2 * 3 + d, i);
  for (int r = 0; r < 3; ++r)
    for (int d = 0; d < 3; ++d)
      SP(S_IW + r * 3 + d, i) = RI[r][0] * R[d][0] + RI[r][1] * R[d][1] + RI[r][2] * R[d][2];
}

// ---- 2. aggregates of part i's group (members gl_mem[m0..m1), summed in
// ascending order), inverse inertia, gravity on part i
__device__ __forceinline__ void group_aggregate(const Block& c, int i, int m0, int m1) {
  float gm = 0.f, mc[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int mm = m0; mm < m1; ++mm) {
    const int q = c.gl_mem[mm];
    const float m = SP(S_MASS, q);
    gm += m;
    for (int d = 0; d < 3; ++d) mc[d] += m * SP(S_COMW + d, q);
  }
  float gc[3] = {mc[0] / gm, mc[1] / gm, mc[2] / gm};
  float gI[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll 1
  for (int mm = m0; mm < m1; ++mm) {
    const int q = c.gl_mem[mm];
    const float m = SP(S_MASS, q);
    float d[3];
    for (int e = 0; e < 3; ++e) d[e] = SP(S_COMW + e, q) - gc[e];
    const float d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    for (int r = 0; r < 3; ++r)
      for (int e = 0; e < 3; ++e)
        gI[r][e] += SP(S_IW + r * 3 + e, q) + m * ((r == e ? d2 : 0.f) - d[r] * d[e]);
  }
  for (int r = 0; r < 3; ++r) gI[r][r] += 1e-8f;
  const float c00 = gI[1][1] * gI[2][2] - gI[1][2] * gI[2][1];
  const float c01 = gI[0][2] * gI[2][1] - gI[0][1] * gI[2][2];
  const float c02 = gI[0][1] * gI[1][2] - gI[0][2] * gI[1][1];
  const float c10 = gI[1][2] * gI[2][0] - gI[1][0] * gI[2][2];
  const float c11 = gI[0][0] * gI[2][2] - gI[0][2] * gI[2][0];
  const float c12 = gI[0][2] * gI[1][0] - gI[0][0] * gI[1][2];
  const float c20 = gI[1][0] * gI[2][1] - gI[1][1] * gI[2][0];
  const float c21 = gI[0][1] * gI[2][0] - gI[0][0] * gI[2][1];
  const float c22 = gI[0][0] * gI[1][1] - gI[0][1] * gI[1][0];
  float det = gI[0][0] * c00 + gI[0][1] * c10 + gI[0][2] * c20;
  if (fabsf(det) < 1e-18f) det = 1e-18f;
  const float id = 1.f / det;
  const float inv[9] = {c00 * id, c01 * id, c02 * id, c10 * id, c11 * id,
                        c12 * id, c20 * id, c21 * id, c22 * id};
  for (int e = 0; e < 9; ++e) SP(S_INVI + e, i) = inv[e];
  SP(S_IGM, i) = 1.f / gm;
  for (int e = 0; e < 3; ++e) SP(S_GCOM + e, i) = gc[e];
  SP(S_LIN + 2, i) = SP(S_LIN + 2, i) + c.dtg * SP(S_GS, i);
}

// The head of a substep: part frames, group aggregates and gravity, each
// group in one warp, its members side by side in the warp's lanes (the warp
// that runs the group's group_pass, so it can follow the last pass of the
// substep before without a block barrier).
__device__ __forceinline__ void group_head(const Block& c) {
#pragma unroll 1
  for (int g = c.warp; g < c.ngroups; g += c.nwarps) {
    const int m0 = c.gl_off[g], m1 = c.gl_off[g + 1];
#pragma unroll 1
    for (int m = m0 + c.lane; m < m1; m += 32) part_frame(c, c.gl_mem[m]);
    __syncwarp();
#pragma unroll 1
    for (int m = m0 + c.lane; m < m1; m += 32) group_aggregate(c, c.gl_mem[m], m0, m1);
    __syncwarp();
  }
}

// ---- 3a. narrow phase of a floor or vertex-in-box lane; lc is the lane's
// constant row
__device__ __forceinline__ void corner_lane_contact(const Block& c, int kind, int pa, int pb,
                                                    const float* lc, float* point, float* nrm,
                                                    float* depth, bool* fm_out) {
  const float slop = c.slop;
  float qa[4] = {SP(S_QUAT, pa), SP(S_QUAT + 1, pa), SP(S_QUAT + 2, pa), SP(S_QUAT + 3, pa)};
  float xa[3] = {SP(S_POS, pa), SP(S_POS + 1, pa), SP(S_POS + 2, pa)};
  // corner of the lane's geom (part a) in the world
  float cn[3] = {lc[0], lc[1], lc[2]}, rc[3];
  qrot(qa, cn, rc);
  for (int j = 0; j < 3; ++j) point[j] = xa[j] + rc[j];
  if (kind == KIND_FLOOR) {
    *depth = -point[2];
    nrm[0] = 0.f;
    nrm[1] = 0.f;
    nrm[2] = 1.f;
    *fm_out = *depth > -slop;
  } else {
    // in the destination box (part b)
    float qb[4] = {SP(S_QUAT, pb), SP(S_QUAT + 1, pb), SP(S_QUAT + 2, pb), SP(S_QUAT + 3, pb)};
    float xb[3] = {SP(S_POS, pb), SP(S_POS + 1, pb), SP(S_POS + 2, pb)};
    float dq[4] = {lc[6], lc[7], lc[8], lc[9]}, wq[4];
    qmul(qb, dq, wq);
    float dp[3] = {lc[3], lc[4], lc[5]}, wp[3];
    qrot(qb, dp, wp);
    for (int j = 0; j < 3; ++j) wp[j] += xb[j];
    bool inside;
    point_in_box(point, wp, wq, lc + 10, slop, depth, nrm, &inside);
    *fm_out = inside && (c.grp[pa] != c.grp[pb]) && (*depth > -slop);
  }
}

// narrow phase of a SAT lane: geom world poses, provisional mask (the
// corner count comes in sat_gate)
__device__ __forceinline__ void sat_lane_contact(const Block& c, int pa, int pb, const float* lc,
                                                 float* point, float* nrm, float* depth,
                                                 bool* fm_out) {
  float qa[4] = {SP(S_QUAT, pa), SP(S_QUAT + 1, pa), SP(S_QUAT + 2, pa), SP(S_QUAT + 3, pa)};
  float xa[3] = {SP(S_POS, pa), SP(S_POS + 1, pa), SP(S_POS + 2, pa)};
  float qb[4] = {SP(S_QUAT, pb), SP(S_QUAT + 1, pb), SP(S_QUAT + 2, pb), SP(S_QUAT + 3, pb)};
  float xb[3] = {SP(S_POS, pb), SP(S_POS + 1, pb), SP(S_POS + 2, pb)};
  float qga[4] = {lc[3], lc[4], lc[5], lc[6]}, qgb[4] = {lc[13], lc[14], lc[15], lc[16]};
  float pga[3] = {lc[0], lc[1], lc[2]}, pgb[3] = {lc[10], lc[11], lc[12]};
  float wqa[4], wqb[4], rpa[3], rpb[3], ca[3], cb[3];
  qmul(qa, qga, wqa);
  qmul(qb, qgb, wqb);
  qrot(qa, pga, rpa);
  qrot(qb, pgb, rpb);
  for (int j = 0; j < 3; ++j) {
    ca[j] = xa[j] + rpa[j];
    cb[j] = xb[j] + rpb[j];
  }
  bool inter;
  edge_sat(wqa, ca, lc + 7, wqb, cb, lc + 17, c.slop, point, nrm, depth, &inter);
  *fm_out = inter && (c.grp[pa] != c.grp[pb]);
}

// (r_a x d) . I_a^-1 (r_a x d) + (r_b x d) . I_b^-1 (r_b x d): the angular
// part of a lane's effective mass along direction d
__device__ __forceinline__ float direction_inertia(const Block& c, int pa, int pb,
                                                   const float* ra, const float* rb,
                                                   const float* dir) {
  float xa[3], xb[3];
  cross3(ra, dir, xa);
  cross3(rb, dir, xb);
  float qa = 0.f, qb = 0.f;
  for (int r = 0; r < 3; ++r) {
    const float ta = SP(S_INVI + r * 3, pa) * xa[0] + SP(S_INVI + r * 3 + 1, pa) * xa[1] +
                     SP(S_INVI + r * 3 + 2, pa) * xa[2];
    qa += xa[r] * ta;
    if (pb >= 0) {
      const float tb = SP(S_INVI + r * 3, pb) * xb[0] + SP(S_INVI + r * 3 + 1, pb) * xb[1] +
                       SP(S_INVI + r * 3 + 2, pb) * xb[2];
      qb += xb[r] * tb;
    }
  }
  return qa + qb;
}

// ---- 3b. solver prep of one lane (engine.lane_prep) into its registers;
// lambda is not touched
__device__ __forceinline__ void lane_prep(const Block& c, int pa, int pb, const float* point,
                                          const float* nrm, float depth, bool fm,
                                          const float* lc, LaneRegs& L) {
  const int pbs = pb >= 0 ? pb : 0;
  for (int j = 0; j < 3; ++j) {
    L.ra[j] = point[j] - SP(S_GCOM + j, pa);
    L.rb[j] = point[j] - SP(S_GCOM + j, pbs);
    L.n[j] = nrm[j];
  }
  const float ref[3] = {fabsf(nrm[2]) < 0.9f ? 0.f : 1.f, 0.f,
                        fabsf(nrm[2]) < 0.9f ? 1.f : 0.f};
  cross3(nrm, ref, L.t1);
  const float t1r = 1.f / sqrtf(dot3(L.t1, L.t1) + 1e-24f);
  for (int j = 0; j < 3; ++j) L.t1[j] *= t1r;
  cross3(nrm, L.t1, L.t2);
  const float im = SP(S_IGM, pa) + (pb >= 0 ? SP(S_IGM, pb) : 0.f);
  L.iw[0] = 1.f / fmaxf(im + direction_inertia(c, pa, pb, L.ra, L.rb, L.n), 1e-8f);
  L.iw[1] = 1.f / fmaxf(im + direction_inertia(c, pa, pb, L.ra, L.rb, L.t1), 1e-8f);
  L.iw[2] = 1.f / fmaxf(im + direction_inertia(c, pa, pb, L.ra, L.rb, L.t2), 1e-8f);
  L.bias = -fminf((lc[LC_BETA] / c.dt) * fmaxf(depth - c.slop, 0.f), 0.5f);
  L.fric = lc[LC_FRIC];
  L.mask = fm ? 1.f : 0.f;
}

// ---- 3c. narrow phase and solver prep of the SAT lane in slot k (its lane
// working set in memory), and of all SAT lanes by one warp, where the lanes
// live in memory. The SAT test is the longest straight-line code
// of a substep; a warp runs it whether one of its lanes is a SAT lane or ten
// are, so the last warp takes them all and the others skip theirs. (With
// one lane per thread the owner keeps its SAT lane: handing the prepared
// fields over through a staging buffer cost more in spilled registers than
// it saved, 15.2 ms against 13.0 ms a launch.)
__device__ __forceinline__ void prepare_sat_lane(const Block& c, int k) {
  const int pk = __ldg(c.slot_i + k).x;
  LaneRegs L;
  float lc[LC], point[3], nrm[3], depth;
  bool fm;
  load_lane_const(c, k, lc);
  sat_lane_contact(c, pk_part_a(pk), pk_part_b(pk), lc, point, nrm, &depth, &fm);
  lane_prep(c, pk_part_a(pk), pk_part_b(pk), point, nrm, depth, fm, lc, L);
  store_lane_prep(c, k, L);
}

__device__ __forceinline__ void prepare_sat_lanes(const Block& c) {
  if (c.warp != c.nwarps - 1) return;
#pragma unroll 1
  for (int e = c.lane; e < c.Ke; e += 32) prepare_sat_lane(c, c.sat_slot[e]);
}

// a dummy slot: it contributes nothing and is never updated
__device__ __forceinline__ void clear_lane(LaneRegs& L) {
  for (int d = 0; d < 3; ++d) {
    L.n[d] = L.t1[d] = L.t2[d] = L.ra[d] = L.rb[d] = L.iw[d] = L.lam[d] = 0.f;
  }
  L.bias = L.fric = L.mask = 0.f;
}

// ---- 4. a SAT lane fires only where its pair's 16 corner lanes are empty
// (their masks are in memory, behind a block barrier)
__device__ __forceinline__ void sat_gate(const Block& c, int pair, LaneRegs& L) {
  float cnt = 0.f;
  for (int j = 0; j < 16; ++j) cnt += LN(F_MASK, c.sat_corner[pair * 16 + j]);
  if (cnt > 0.f) L.mask = 0.f;
}

// ---- 5. warm start capped at cap_acc * inv_w * dt (before the lane scale
// goes into inv_w)
__device__ __forceinline__ void warm_start_lane(const Block& c, LaneRegs& L, float cap_acc) {
  const float cap = cap_acc * L.iw[0] * c.dt;
  const float l0 = fminf(L.lam[0], cap);
  const float mf = L.fric * l0;
  L.lam[0] = l0;
  L.lam[1] = fminf(fmaxf(L.lam[1], -mf), mf);
  L.lam[2] = fminf(fmaxf(L.lam[2], -mf), mf);
}

// ---- 6. mass splitting: inv_w times relax / (active lanes of the busier
// side's group)
__device__ __forceinline__ void scale_lane(const Block& c, int pa, int pb, LaneRegs& L) {
  const float na = SP(S_CNT, pa);
  const float nb = pb >= 0 ? SP(S_CNT, pb) : 0.f;
  const float sc = c.relax / fmaxf(fmaxf(na, nb), 1.f);
  for (int d = 0; d < 3; ++d) L.iw[d] *= sc;
}

// the group velocity of part i (S_LV, S_AV): a 16-byte and an 8-byte load
__device__ __forceinline__ void load_group_velocity(const Block& c, int i, float* lv, float* av) {
  const float4 a = *reinterpret_cast<const float4*>(&SP(S_LV, i));
  const float2 b = *reinterpret_cast<const float2*>(&SP(S_LV + 4, i));
  lv[0] = a.x;
  lv[1] = a.y;
  lv[2] = a.z;
  av[0] = a.w;
  av[1] = b.x;
  av[2] = b.y;
}

// ---- 7a. one Jacobi update of a lane's lambda from the group velocities.
// A robot lane (ROBOT) has no b part: its b side moves at the prescribed
// velocity kept in rb.
__device__ __forceinline__ void update_lane(const Block& c, int pa, int pb, bool robot,
                                            LaneRegs& L) {
  float la[3], wa[3];
  load_group_velocity(c, pa, la, wa);
  float cwa[3];
  cross3(wa, L.ra, cwa);
  float vr[3];
  for (int d = 0; d < 3; ++d) vr[d] = la[d] + cwa[d];
  if (pb >= 0) {
    float lb[3], wb[3];
    load_group_velocity(c, pb, lb, wb);
    float cwb[3];
    cross3(wb, L.rb, cwb);
    for (int d = 0; d < 3; ++d) vr[d] -= lb[d] + cwb[d];
  } else if (robot) {
    for (int d = 0; d < 3; ++d) vr[d] -= L.rb[d];
  }
  const float l0 = L.lam[0] - (dot3(vr, L.n) + L.bias) * L.iw[0];
  const float l1 = L.lam[1] - dot3(vr, L.t1) * L.iw[1];
  const float l2 = L.lam[2] - dot3(vr, L.t2) * L.iw[2];
  const float ln = fmaxf(l0, 0.f);
  const float mf = L.fric * ln;
  L.lam[0] = ln;
  L.lam[1] = fminf(fmaxf(l1, -mf), mf);
  L.lam[2] = fminf(fmaxf(l2, -mf), mf);
}

// ---- 7b. a lane's masked impulse and torques, once: the a side is added
// to the thread's sums, the b side (impulse negated) goes to its place in
// the b buffer; the mask rides along as the active-lane count
__device__ __forceinline__ void emit_lane(const Block& c, const LaneRegs& L, int bslot,
                                          float* acc) {
  float imp[3], ta[3];
  for (int d = 0; d < 3; ++d)
    imp[d] = (L.lam[0] * L.n[d] + L.lam[1] * L.t1[d] + L.lam[2] * L.t2[d]) * L.mask;
  cross3(L.ra, imp, ta);
  for (int d = 0; d < 3; ++d) {
    acc[d] += imp[d];
    acc[3 + d] += ta[d];
  }
  acc[6] += L.mask;
  if (bslot >= 0) {
    float tb[3];
    cross3(L.rb, imp, tb);
    float4* entry = reinterpret_cast<float4*>(c.bbuf) + 2 * bslot;
    entry[0] = make_float4(-imp[0], -imp[1], -imp[2], -tb[0]);
    entry[1] = make_float4(-tb[1], -tb[2], L.mask, 0.f);
  }
}

// The thread's sums into its segment's partial, by shuffles inside the
// segment in a fixed order. The six columns are folded as they are reduced:
// at the first level the upper half of the segment keeps columns 3..5 and
// the lower half 0..2, each handing the other three over; at the second the
// three are split two and one, at the third the two are split: 7 shuffles
// for a segment of 16 lanes, not 24, and each column ends in one lane that
// stores it. The count column is reduced plainly, in the first pass only.
template <int SEGW>
__device__ __forceinline__ void store_segment(const Block& c, float* acc, bool count) {
  static_assert(SEGW == 8 || SEGW == 16 || SEGW == 32, "segment width");
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int M1 = SEGW / 2, M2 = SEGW / 4, M3 = SEGW / 8;
  const int lane = c.lane;
  const bool h1 = (lane & M1) != 0, h2 = (lane & M2) != 0, h3 = (lane & M3) != 0;
  float* entry = c.part + NCOL * thread_segment<SEGW>(c);
  const bool writer = (lane & (M3 - 1)) == 0 && !(h2 && h3);
  const int column = (h1 ? 3 : 0) + (h2 ? 2 : (h3 ? 1 : 0));
  float k0 = h1 ? acc[3] : acc[0], k1 = h1 ? acc[4] : acc[1], k2 = h1 ? acc[5] : acc[2];
  k0 += __shfl_xor_sync(FULL, h1 ? acc[0] : acc[3], M1);
  k1 += __shfl_xor_sync(FULL, h1 ? acc[1] : acc[4], M1);
  k2 += __shfl_xor_sync(FULL, h1 ? acc[2] : acc[5], M1);
  // the lower quarter keeps k0 and k1, the upper k2
  const float r0 = __shfl_xor_sync(FULL, h2 ? k0 : k2, M2);
  const float r1 = __shfl_xor_sync(FULL, k1, M2);
  const float u0 = (h2 ? k2 : k0) + r0;
  const float u1 = k1 + r1;            // the lower quarter's second column
  // of the lower quarter's two, the upper eighth keeps the second
  const bool second = !h2 && h3;
  float v = (second ? u1 : u0) + __shfl_xor_sync(FULL, (h2 || h3) ? u0 : u1, M3);
#pragma unroll
  for (int m = M3 / 2; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  if (writer) entry[column] = v;
  if (count) {
    float n = acc[6];
#pragma unroll
    for (int m = SEGW / 2; m > 0; m >>= 1) n += __shfl_xor_sync(FULL, n, m);
    if ((lane & (SEGW - 1)) == 0) entry[6] = n;
  }
}

// the tail of a group pass: group g's sums `acc` (impulse, torque, active-lane
// count) give every member its velocity (and, with `count`, the count);
// `last` goes on to the velocity clamp, the integration about the group COM
// and the floor projection by the group's deepest corner. Run by the group's
// warp.
__device__ __forceinline__ void group_apply(const Block& c, int g, const float* acc, bool count,
                                            bool last) {
  const int lane = c.lane;
  const int m0 = c.gl_off[g], m1 = c.gl_off[g + 1];
#pragma unroll 1
  for (int m = m0 + lane; m < m1; m += 32) {
    const int q = c.gl_mem[m];
    const float igm = SP(S_IGM, q);
    float lv[3], av[3];
    for (int d = 0; d < 3; ++d) {
      lv[d] = SP(S_LIN + d, q) + acc[d] * igm;
      av[d] = SP(S_ANG + d, q) + (SP(S_INVI + d * 3, q) * acc[3] +
                                  SP(S_INVI + d * 3 + 1, q) * acc[4] +
                                  SP(S_INVI + d * 3 + 2, q) * acc[5]);
    }
    if (count) SP(S_CNT, q) = acc[6];
    if (!last) {
      for (int d = 0; d < 3; ++d) {
        SP(S_LV + d, q) = lv[d];
        SP(S_AV + d, q) = av[d];
      }
    } else {
      // velocity clamp, then integrate about the group COM
      for (int d = 0; d < 3; ++d) {
        lv[d] = fminf(fmaxf(lv[d], -c.maxv), c.maxv);
        av[d] = fminf(fmaxf(av[d], -c.maxv), c.maxv);
        SP(S_LIN + d, q) = lv[d];
        SP(S_ANG + d, q) = av[d];
      }
      const float angle = sqrtf(av[0] * av[0] + av[1] * av[1] + av[2] * av[2] + 1e-18f);
      const float ra_ = 1.f / angle;
      float axis[3] = {av[0] * ra_, av[1] * ra_, av[2] * ra_};
      const float rn = 1.f / sqrtf(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2] + 1e-24f);
      const float half = (angle * c.dt) * 0.5f;
      const float sh = sinf(half) * rn;
      float dq[4] = {cosf(half), sh * axis[0], sh * axis[1], sh * axis[2]};
      float rel[3], rr[3];
      for (int d = 0; d < 3; ++d) rel[d] = SP(S_POS + d, q) - SP(S_GCOM + d, q);
      qrot(dq, rel, rr);
      for (int d = 0; d < 3; ++d) SP(S_POS + d, q) = SP(S_GCOM + d, q) + rr[d] + lv[d] * c.dt;
      float qq[4] = {SP(S_QUAT, q), SP(S_QUAT + 1, q), SP(S_QUAT + 2, q), SP(S_QUAT + 3, q)}, nq[4];
      qmul(dq, qq, nq);
      const float rq = 1.f / fmaxf(sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3]), 1e-12f);
      for (int d = 0; d < 4; ++d) SP(S_QUAT + d, q) = nq[d] * rq;
    }
  }
  if (last) {
    // floor projection: lift the group by its deepest floor corner
    __syncwarp();
    float pen = 0.f;
#pragma unroll 1
    for (int m = m0; m < m1; ++m) {
      const int q = c.gl_mem[m];
      float qq[4] = {SP(S_QUAT, q), SP(S_QUAT + 1, q), SP(S_QUAT + 2, q), SP(S_QUAT + 3, q)};
      const float z = SP(S_POS + 2, q);
#pragma unroll 1
      for (int e = c.floor_off[q] + lane; e < c.floor_off[q + 1]; e += 32) {
        float cn[3] = {c.floor_cn[3 * e], c.floor_cn[3 * e + 1], c.floor_cn[3 * e + 2]}, rc[3];
        qrot(qq, cn, rc);
        const float d = -(z + rc[2]);
        pen = fmaxf(pen, fmaxf(d > -c.slop ? d - c.slop : 0.f, 0.f));
      }
    }
    pen = warp_max(pen);
    __syncwarp();
#pragma unroll 1
    for (int m = m0 + lane; m < m1; m += 32) SP(S_POS + 2, c.gl_mem[m]) += pen;
    __syncwarp();
  }
}

// ---- 7c. the group pass: one warp per rigid group adds the a-side partials
// and the b-side entries of all the group's members, once, and gives every
// member its velocity (and, with `count`, the group's active-lane count).
// The group's entries are listed once a launch (gl_ent) and 8 columns wide: lane (chunk, column) of the warp adds
// column `column` of every fourth entry, two shuffles finish the sums, in a
// fixed order; group_apply does the rest.
__device__ __forceinline__ void group_pass(const Block& c, bool count, bool last) {
  const int lane = c.lane;
  const int col = lane & (NCOL - 1), chunk = lane / NCOL;
  constexpr int CHUNKS = 32 / NCOL;
#pragma unroll 1
  for (int g = c.warp; g < c.ngroups; g += c.nwarps) {
    const int e1 = c.gl_eoff[g + 1];
    const int b_first = c.NSEG * NCOL;
    const float* b_base = c.bbuf - b_first;
    float s = 0.f;
#pragma unroll 4
    for (int e = c.gl_eoff[g] + chunk; e < e1; e += CHUNKS) {
      const int w = c.gl_ent[e];
      s += (w < b_first ? c.part : b_base)[w + col];
    }
    s += __shfl_xor_sync(0xffffffffu, s, NCOL);
    s += __shfl_xor_sync(0xffffffffu, s, 2 * NCOL);
    float acc[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) acc[k] = __shfl_sync(0xffffffffu, s, k);
    group_apply(c, g, acc, count, last);
  }
}

// the static ints of a slot
struct SlotInfo {
  int pk, aux0, aux1;
  __device__ __forceinline__ int pa() const { return pk_part_a(pk); }
  __device__ __forceinline__ int pb() const { return pk_part_b(pk); }
  __device__ __forceinline__ int kind() const { return pk_kind(pk); }
  __device__ __forceinline__ int bslot() const { return pk_b_slot(pk); }
};

// a slot's row from global memory (once a substep at most)
__device__ __forceinline__ SlotInfo load_slot(const Block& c, int k) {
  const int4 v = __ldg(c.slot_i + k);
  SlotInfo s;
  s.pk = v.x;
  s.aux0 = v.y;
  s.aux1 = v.z;
  return s;
}

// Copy the static tables into the block's shared memory (`tables`, laid out
// by `tl`) and point the block at the copies. A block barrier must follow.
__device__ __forceinline__ void stage_tables(Block& c, int* tables, const TableLayout& tl,
                                             const int* seg_off, const int* b_off,
                                             const int* floor_off, const int* floor_slot,
                                             const int* sat_corner, int n_floor, int n_sat,
                                             bool with_slots) {
  for (int i = c.tid; i < c.P + 1; i += c.nt) {
    tables[tl.seg_off + i] = seg_off[i];
    tables[tl.b_off + i] = b_off[i];
    tables[tl.floor_off + i] = floor_off[i];
  }
  for (int i = c.tid; i < 16 * n_sat; i += c.nt) tables[tl.sat_corner + i] = sat_corner[i];
  // the slot of each SAT lane: its row carries the pair's index
  for (int i = c.tid; i < c.KS; i += c.nt) {
    const int4 row = __ldg(c.slot_i + i);
    if (pk_kind(row.x) == KIND_SAT) tables[tl.sat_slot + row.y] = i;
  }
  if (with_slots)
    for (int i = c.tid; i < c.KS; i += c.nt) tables[tl.slot_pk + i] = __ldg(c.slot_i + i).x;
  float* cn = reinterpret_cast<float*>(tables + tl.floor_cn);
  for (int i = c.tid; i < n_floor; i += c.nt) {
    const float4 row = __ldg(c.lane_const + (size_t)floor_slot[i] * (LC / 4));
    cn[3 * i] = row.x;
    cn[3 * i + 1] = row.y;
    cn[3 * i + 2] = row.z;
  }
  c.seg_off = tables + tl.seg_off;
  c.b_off = tables + tl.b_off;
  c.floor_off = tables + tl.floor_off;
  c.sat_corner = tables + tl.sat_corner;
  c.sat_slot = tables + tl.sat_slot;
  c.Ke = n_sat;
  c.slot_pk = tables + tl.slot_pk;
  c.floor_cn = cn;
}

// what the arm kernel adds to a pass: the finger-servo press on the robot
// lanes of a squeezing arm
struct ArmPress {
  const float* arm_deepf;   // [NARM] 1 where the arm's press is engaged
  float press_vel;
};

// what a kernel does beside the first pass: nothing in the free-part kernel
struct NoHooks {
  __device__ __forceinline__ void after_first_lane() const {}
  __device__ __forceinline__ void beside_first_group() const {}
};

// ---- 7. the solver passes of a substep, one loop: pass 0 gates the SAT
// lanes, applies the capped warm start and counts the active lanes; pass 1
// sets the lane scale from those counts (and the finger-servo press);
// passes 1.. update every lane's lambda from the group velocities. Each pass
// hands the lanes' impulses to the sums (lane half), then runs the group
// pass (group half), with a block barrier after each half; the last group
// pass integrates and is not followed by a barrier. With REGS the thread's
// one lane is Lr/sr; otherwise its LPT lanes are loaded from and stored to
// memory and their packed slot words come from shared memory. `hooks` are
// run by every thread after the first lane half (before its barrier) and
// beside the first group pass.
template <int SEGW, bool REGS, bool ARM, class Hooks>
__device__ __forceinline__ void solver_passes(const Block& c, LaneRegs& Lr, const SlotInfo& sr,
                                              const ArmPress& press, const Hooks& hooks,
                                              PhaseClock& clk) {
#pragma unroll 1
  for (int it = 0; it <= c.iters; ++it) {
    const bool first = it == 0, last = it == c.iters;
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int r = 0; r < (REGS ? 1 : c.LPT); ++r) {
      const int k = thread_slot(c, r);
      SlotInfo s = sr;
      if (!REGS) s.pk = c.slot_pk[k];
      const int kind = s.kind();
      if (kind == KIND_PAD) continue;
      LaneRegs Lm;
      LaneRegs& L = REGS ? Lr : Lm;
      if (!REGS) load_lane(c, k, L);
      const int pa = s.pa(), pb = s.pb();
      const bool robot = ARM && kind >= KIND_ROBOT1;
      if (first) {
        if (kind == KIND_SAT) {
          sat_gate(c, REGS ? s.aux0 : __ldg(c.slot_i + k).y, L);
          if (!REGS) LN(F_MASK, k) = L.mask;
        }
        warm_start_lane(c, L, robot ? 30.f : 200.f);
      } else {
        if (it == 1) {
          scale_lane(c, pa, pb, L);
          if (ARM && robot && press.press_vel > 0.f && L.mask > 0.f) {
            const int finger = __ldg(c.slot_i + k).z;
            if (finger >= 0 && press.arm_deepf[finger >> 1] > 0.f) {
              for (int d = 0; d < 3; ++d) L.rb[d] += press.press_vel * L.n[d];
            }
          }
          if (!REGS) {
            for (int d = 0; d < 3; ++d) {
              LN(F_IW + d, k) = L.iw[d];
              if (ARM) LN(F_RB + d, k) = L.rb[d];
            }
          }
        }
        update_lane(c, pa, pb, robot, L);
      }
      if (!REGS) store_lambda(c, k, L);
      // a masked lane adds nothing after the first pass, which left zeros
      // in its b-buffer entry (the mask is fixed for the substep by then)
      if (first || L.mask != 0.f) emit_lane(c, L, s.bslot(), acc);
    }
    store_segment<SEGW>(c, acc, first);
    if (first) hooks.after_first_lane();
    clk.sync();
    clk.mark(first ? 2 : 4);
    if (first) hooks.beside_first_group();
    group_pass(c, first, last);
    if (!last) {
      clk.sync();
      clk.mark(first ? 2 : 3);
    }
  }
}

// ---- the latency floor's yardstick: `n` block barriers in a row, nothing
// between them. Launched with the block size, the dynamic shared memory and
// as many blocks as the physics kernel has resident on the card, the time of
// a launch over n is one barrier round trip at that occupancy.
__global__ void barrier_probe_kernel(int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) __syncthreads();
}

// blocks of `kernel` an SM holds at this block size and dynamic shared memory
template <class Kernel>
inline int resident_blocks(Kernel kernel, int threads, int smem_bytes) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
      cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem_bytes) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace furniture
