// Device code shared by the port's two physics kernels (megakernel.cu, the
// free-part kernel, and arm_megakernel.cu, the coupled arm + parts kernel).
//
// Both kernels give each env one thread block that runs the whole
// n-substep loop. This header holds what a substep of part physics is
// made of, as __device__ functions over one block's working set:
//
//   part_frames        per-part COM and world inertia R I R^T
//   group_aggregates   composite mass properties of each rigid group, gravity
//   base_lane_contact  narrow phase of a floor, vertex-in-box or SAT lane
//   lane_prep          tangent basis, effective mass, Baumgarte bias
//   sat_gate           SAT lanes fire only where the pair's 16 corner lanes
//                      are empty
//   count_active       active lanes per group (mass splitting)
//   warm_start_lane    lane scale and capped warm start
//   jacobi_integrate   the Jacobi sweeps, velocity clamp, integration about
//                      the group COM and each part's deepest floor corner;
//                      with ARM it subtracts the prescribed velocity of the
//                      kinematic robot lanes
//   floor_lift         lift each group by its deepest corner
//
// The per-part reductions go one warp per part over a static lane list,
// summed in a fixed order (per-thread strides, then warp shuffles, then the
// group's parts in index order), so results do not change from run to run.
// Where the JAX package's two paths differ, this code follows engine.py,
// the plain version it is held against (see megakernel.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace furniture {

// lane-constant columns: geometry (20), friction, beta
constexpr int LC = 22;
constexpr int LC_FRIC = 20;
constexpr int LC_BETA = 21;

// per-lane working set, field-major: lanes[f * K + k]
enum LaneField {
  F_N = 0,       // normal 0..2
  F_T1 = 3,      // tangent 1 3..5
  F_T2 = 6,      // tangent 2 6..8
  F_RA = 9,      // r_a 9..11
  F_RB = 12,     // r_b 12..14 (robot lanes: the world contact point)
  F_IW = 15,     // inv_w per direction 15..17
  F_BIAS = 18,
  F_SCALE = 19,
  F_MASK = 20,
  F_LAM = 21,    // lambda 21..23
  NF = 24,       // fields of the free-part kernel
  F_VB = 24,     // prescribed b-side velocity 24..26 (arm kernel only)
  NF_ARM = 27
};

// per-part shared fields, field-major: sp[f * P + p]
enum PartField {
  S_POS = 0, S_QUAT = 3, S_LIN = 7, S_ANG = 10, S_GS = 13,
  S_MASS = 14, S_COML = 15, S_IL = 18,
  S_COMW = 27, S_IW = 30, S_IGM = 39, S_GCOM = 40, S_INVI = 43,
  S_LV = 52, S_AV = 55, S_CNT = 58, S_PEN = 59,
  PF = 60
};

// One block's view of its env: the part fields and group labels in shared
// memory, the lane working set (shared memory or global scratch), the
// constant tables, and the thread's place in the block.
struct Block {
  float* sp;                 // [PF * P]
  int* grp;                  // [P]
  float* lanes;              // [NF * K] (or NF_ARM)
  const float* lane_const;   // [K,LC]
  const int* lane_part;      // [K,2]: part_a, part_b (-1: floor or robot)
  const int* part_off;       // [P+1] offsets into part_ent
  const int* part_nfloor;    // [P] floor lanes at the head of each list
  const int* part_ent;       // [E] (lane << 1) | side (0: a, 1: b)
  int P, K, Kf, Kp, Ke, iters;
  float dt, dtg, slop, relax, maxv;
  int tid, nt, warp, lane, nwarps;
};

#define SP(f, i) c.sp[(f) * c.P + (i)]
#define LN(f, k) c.lanes[(f) * c.K + (k)]

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
  nq = fmaxf(nq, 1e-12f);
  float w = q0[0] / nq, x = q0[1] / nq, y = q0[2] / nq, z = q0[3] / nq;
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
  qn = fmaxf(qn, 1e-12f);
  float qi[4] = {bquat[0] / qn, -bquat[1] / qn, -bquat[2] / qn, -bquat[3] / qn};
  float loc[3];
  qrot(qi, rel, loc);
  float pen[3];
  for (int j = 0; j < 3; ++j) pen[j] = size[j] - fabsf(loc[j]);
  *inside = (pen[0] > -slop) && (pen[1] > -slop) && (pen[2] > -slop);
  int ax = 0;
  if (pen[1] < pen[ax]) ax = 1;
  if (pen[2] < pen[ax]) ax = 2;
  *depth = pen[ax];
  float nl[3] = {0.f, 0.f, 0.f};
  nl[ax] = sgnf(loc[ax]);
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
  float best_ov = 0.f, best_n[3] = {0.f, 0.f, 0.f};
  int bi = 0, bj = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float nr[3];
      cross3(a_ax[i], b_ax[j], nr);
      const float n_len = sqrtf(dot3(nr, nr));
      const float inv = fmaxf(n_len, 1e-12f);
      float nh[3] = {nr[0] / inv, nr[1] / inv, nr[2] / inv};
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
        const float flip = t_n > 0.f ? -1.f : 1.f;  // orient B -> A
        for (int c = 0; c < 3; ++c) best_n[c] = flip * nh[c];
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
  const float* d1 = a_ax[bi];
  const float* d2 = b_ax[bj];
  float r12[3] = {pb0[0] - pa0[0], pb0[1] - pa0[1], pb0[2] - pa0[2]};
  const float d12 = dot3(d1, d2);
  const float denom = fmaxf(1.f - d12 * d12, 1e-9f);
  const float r_d1 = dot3(r12, d1);
  const float r_d2 = dot3(r12, d2);
  const float h1 = SA[bi], h2 = SB[bj];
  const float s1 = fminf(fmaxf((r_d1 - d12 * r_d2) / denom, -h1), h1);
  const float s2 = fminf(fmaxf((d12 * r_d1 - r_d2) / denom, -h2), h2);
  for (int c = 0; c < 3; ++c) {
    pt[c] = 0.5f * (pa0[c] + s1 * d1[c] + pb0[c] + s2 * d2[c]);
    nrm[c] = n_out[c];
  }
  *inter = all_pos && (best_ov > -slop);
}

// Load one env's part state and the part constants; lambda starts at zero.
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
  for (int k = c.tid; k < c.K; k += c.nt) {
    LN(F_LAM, k) = 0.f;
    LN(F_LAM + 1, k) = 0.f;
    LN(F_LAM + 2, k) = 0.f;
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

// ---- 1. per-part COM and world inertia R I R^T ----
__device__ __forceinline__ void part_frames(const Block& c) {
  for (int i = c.tid; i < c.P; i += c.nt) {
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
}

// ---- 2. group aggregates, inverse inertia, gravity ----
__device__ __forceinline__ void group_aggregates(const Block& c) {
  const int P = c.P;
  const int* grp = c.grp;
  for (int i = c.tid; i < P; i += c.nt) {
    const int gi = grp[i];
    float gm = 0.f, mc[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < P; ++q) {
      if (grp[q] != gi) continue;
      const float m = SP(S_MASS, q);
      gm += m;
      for (int d = 0; d < 3; ++d) mc[d] += m * SP(S_COMW + d, q);
    }
    float gc[3] = {mc[0] / gm, mc[1] / gm, mc[2] / gm};
    float gI[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    for (int q = 0; q < P; ++q) {
      if (grp[q] != gi) continue;
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
}

// ---- 3a. narrow phase of a floor, vertex-in-box or SAT lane (k < Kf+Kp+Ke)
__device__ __forceinline__ void base_lane_contact(const Block& c, int k, float* point,
                                                  float* nrm, float* depth, bool* fm_out) {
  const int Kf = c.Kf, Kp = c.Kp;
  const float slop = c.slop;
  const int* grp = c.grp;
  const int pa = c.lane_part[2 * k];
  const int pb = c.lane_part[2 * k + 1];
  const float* lc = c.lane_const + (size_t)k * LC;
  float qa[4] = {SP(S_QUAT, pa), SP(S_QUAT + 1, pa), SP(S_QUAT + 2, pa), SP(S_QUAT + 3, pa)};
  float xa[3] = {SP(S_POS, pa), SP(S_POS + 1, pa), SP(S_POS + 2, pa)};
  bool fm;
  if (k < Kf) {
    float cn[3] = {lc[0], lc[1], lc[2]}, rc[3];
    qrot(qa, cn, rc);
    for (int j = 0; j < 3; ++j) point[j] = xa[j] + rc[j];
    *depth = -point[2];
    nrm[0] = 0.f;
    nrm[1] = 0.f;
    nrm[2] = 1.f;
    fm = *depth > -slop;
  } else {
    float qb[4] = {SP(S_QUAT, pb), SP(S_QUAT + 1, pb), SP(S_QUAT + 2, pb), SP(S_QUAT + 3, pb)};
    float xb[3] = {SP(S_POS, pb), SP(S_POS + 1, pb), SP(S_POS + 2, pb)};
    if (k < Kf + Kp) {
      // corner of the source geom (part a) in the destination box (part b)
      float cn[3] = {lc[0], lc[1], lc[2]}, rc[3];
      qrot(qa, cn, rc);
      for (int j = 0; j < 3; ++j) point[j] = xa[j] + rc[j];
      float dq[4] = {lc[6], lc[7], lc[8], lc[9]}, wq[4];
      qmul(qb, dq, wq);
      float dp[3] = {lc[3], lc[4], lc[5]}, wp[3];
      qrot(qb, dp, wp);
      for (int j = 0; j < 3; ++j) wp[j] += xb[j];
      bool inside;
      point_in_box(point, wp, wq, lc + 10, slop, depth, nrm, &inside);
      fm = inside && (grp[pa] != grp[pb]) && (*depth > -slop);
    } else {
      // SAT lane: geom world poses, provisional mask (corner count in sat_gate)
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
      edge_sat(wqa, ca, lc + 7, wqb, cb, lc + 17, slop, point, nrm, depth, &inter);
      fm = inter && (grp[pa] != grp[pb]);
    }
  }
  *fm_out = fm;
}

// ---- 3b. solver prep of one lane (engine._solve_contacts) ----
__device__ __forceinline__ void lane_prep(const Block& c, int k, const float* point,
                                          const float* nrm, float depth, bool fm) {
  const int pa = c.lane_part[2 * k];
  const int pb = c.lane_part[2 * k + 1];
  const int pbs = pb >= 0 ? pb : 0;
  float ra[3], rb[3];
  for (int j = 0; j < 3; ++j) {
    ra[j] = point[j] - SP(S_GCOM + j, pa);
    rb[j] = point[j] - SP(S_GCOM + j, pbs);
  }
  const float ref[3] = {fabsf(nrm[2]) < 0.9f ? 0.f : 1.f, 0.f,
                        fabsf(nrm[2]) < 0.9f ? 1.f : 0.f};
  float t1[3], t2[3];
  cross3(nrm, ref, t1);
  const float t1n = sqrtf(dot3(t1, t1) + 1e-24f);
  for (int j = 0; j < 3; ++j) t1[j] /= t1n;
  cross3(nrm, t1, t2);
  const float ima = SP(S_IGM, pa);
  const float imb = pb >= 0 ? SP(S_IGM, pb) : 0.f;
  const float* dirs[3] = {nrm, t1, t2};
  for (int d = 0; d < 3; ++d) {
    float xa_[3], xb_[3];
    cross3(ra, dirs[d], xa_);
    cross3(rb, dirs[d], xb_);
    float qa_ = 0.f, qb_ = 0.f;
    for (int r = 0; r < 3; ++r) {
      const float ta = SP(S_INVI + r * 3, pa) * xa_[0] + SP(S_INVI + r * 3 + 1, pa) * xa_[1] +
                       SP(S_INVI + r * 3 + 2, pa) * xa_[2];
      qa_ += xa_[r] * ta;
      if (pb >= 0) {
        const float tb = SP(S_INVI + r * 3, pb) * xb_[0] + SP(S_INVI + r * 3 + 1, pb) * xb_[1] +
                         SP(S_INVI + r * 3 + 2, pb) * xb_[2];
        qb_ += xb_[r] * tb;
      }
    }
    const float w = ima + imb + qa_ + qb_;
    LN(F_IW + d, k) = 1.f / fmaxf(w, 1e-8f);
  }
  for (int j = 0; j < 3; ++j) {
    LN(F_N + j, k) = nrm[j];
    LN(F_T1 + j, k) = t1[j];
    LN(F_T2 + j, k) = t2[j];
    LN(F_RA + j, k) = ra[j];
    LN(F_RB + j, k) = rb[j];
  }
  const float beta = c.lane_const[(size_t)k * LC + LC_BETA];
  LN(F_BIAS, k) = -fminf((beta / c.dt) * fmaxf(depth - c.slop, 0.f), 0.5f);
  LN(F_MASK, k) = fm ? 1.f : 0.f;
}

// ---- 4. SAT lanes fire only where the pair's 16 corner lanes are empty
__device__ __forceinline__ void sat_gate(const Block& c) {
  const int Kf = c.Kf, Kp = c.Kp, Ke = c.Ke;
  for (int e = c.tid; e < Ke; e += c.nt) {
    float cnt = 0.f;
    for (int j = 0; j < 8; ++j)
      cnt += LN(F_MASK, Kf + e * 8 + j) + LN(F_MASK, Kf + (Ke + e) * 8 + j);
    if (cnt > 0.f) LN(F_MASK, Kf + Kp + e) = 0.f;
  }
}

// ---- 5. active-lane counts per group (mass splitting) ----
__device__ __forceinline__ void count_active(const Block& c) {
  const int P = c.P;
  const int* grp = c.grp;
  for (int i = c.warp; i < P; i += c.nwarps) {
    float cnt = 0.f;
    for (int q = 0; q < P; ++q) {
      if (grp[q] != grp[i]) continue;
      float s = 0.f;
      for (int e = c.part_off[q] + c.lane; e < c.part_off[q + 1]; e += 32)
        s += LN(F_MASK, c.part_ent[e] >> 1);
      cnt += warp_sum(s);
    }
    if (c.lane == 0) SP(S_CNT, i) = cnt;
  }
}

// ---- 6. lane scale and warm start capped at cap_acc * inv_w * dt ----
__device__ __forceinline__ void warm_start_lane(const Block& c, int k, float cap_acc) {
  const int pa = c.lane_part[2 * k];
  const int pb = c.lane_part[2 * k + 1];
  const float na = SP(S_CNT, pa);
  const float nb = pb >= 0 ? SP(S_CNT, pb) : 0.f;
  LN(F_SCALE, k) = c.relax / fmaxf(fmaxf(na, nb), 1.f);
  const float fr = c.lane_const[(size_t)k * LC + LC_FRIC];
  const float cap = cap_acc * LN(F_IW, k) * c.dt;
  const float l0 = fminf(LN(F_LAM, k), cap);
  const float mf = fr * l0;
  LN(F_LAM, k) = l0;
  LN(F_LAM + 1, k) = fminf(fmaxf(LN(F_LAM + 1, k), -mf), mf);
  LN(F_LAM + 2, k) = fminf(fmaxf(LN(F_LAM + 2, k), -mf), mf);
}

// ---- 7. Jacobi sweeps; the last pass only applies the impulses, clamps the
// velocities, integrates about the group COM and finds each part's deepest
// floor corner. Contains block barriers: every thread of the block calls it.
// With ARM, lanes from Kf+Kp+Ke on are kinematic: their b side moves at the
// prescribed velocity F_VB.
template <bool ARM>
__device__ __forceinline__ void jacobi_integrate(const Block& c) {
  const int P = c.P, K = c.K;
  const int Kb = c.Kf + c.Kp + c.Ke;
  const int* grp = c.grp;
  const float dt = c.dt, slop = c.slop;
  const int lane = c.lane;
  for (int it = 0; it <= c.iters; ++it) {
    const bool last = it == c.iters;
    // group velocities from the base velocities plus all lanes' impulses
    for (int i = c.warp; i < P; i += c.nwarps) {
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < P; ++q) {
        if (grp[q] != grp[i]) continue;
        float sv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int e = c.part_off[q] + lane; e < c.part_off[q + 1]; e += 32) {
          const int code = c.part_ent[e];
          const int k = code >> 1;
          const float fm = LN(F_MASK, k);
          const float l0 = LN(F_LAM, k), l1 = LN(F_LAM + 1, k), l2 = LN(F_LAM + 2, k);
          float imp[3];
          for (int d = 0; d < 3; ++d)
            imp[d] = (l0 * LN(F_N + d, k) + l1 * LN(F_T1 + d, k) + l2 * LN(F_T2 + d, k)) * fm;
          if (code & 1) {
            for (int d = 0; d < 3; ++d) imp[d] = -imp[d];
          }
          const int fr = (code & 1) ? F_RB : F_RA;
          float r[3] = {LN(fr, k), LN(fr + 1, k), LN(fr + 2, k)}, tq[3];
          cross3(r, imp, tq);
          for (int d = 0; d < 3; ++d) {
            sv[d] += imp[d];
            sv[3 + d] += tq[d];
          }
        }
        for (int d = 0; d < 6; ++d) acc[d] += warp_sum(sv[d]);
      }
      if (lane == 0) {
        const float igm = SP(S_IGM, i);
        float lv[3], av[3];
        for (int d = 0; d < 3; ++d) {
          lv[d] = SP(S_LIN + d, i) + acc[d] * igm;
          av[d] = SP(S_ANG + d, i) + (SP(S_INVI + d * 3, i) * acc[3] +
                                      SP(S_INVI + d * 3 + 1, i) * acc[4] +
                                      SP(S_INVI + d * 3 + 2, i) * acc[5]);
        }
        if (!last) {
          for (int d = 0; d < 3; ++d) {
            SP(S_LV + d, i) = lv[d];
            SP(S_AV + d, i) = av[d];
          }
        } else {
          // velocity clamp, then integrate about the group COM
          for (int d = 0; d < 3; ++d) {
            lv[d] = fminf(fmaxf(lv[d], -c.maxv), c.maxv);
            av[d] = fminf(fmaxf(av[d], -c.maxv), c.maxv);
            SP(S_LIN + d, i) = lv[d];
            SP(S_ANG + d, i) = av[d];
          }
          const float angle = sqrtf(av[0] * av[0] + av[1] * av[1] + av[2] * av[2] + 1e-18f);
          float axis[3] = {av[0] / angle, av[1] / angle, av[2] / angle};
          const float an = sqrtf(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2] + 1e-24f);
          const float half = (angle * dt) * 0.5f;
          const float sh = sinf(half);
          float dq[4] = {cosf(half), sh * (axis[0] / an), sh * (axis[1] / an), sh * (axis[2] / an)};
          float rel[3], rr[3];
          for (int d = 0; d < 3; ++d) rel[d] = SP(S_POS + d, i) - SP(S_GCOM + d, i);
          qrot(dq, rel, rr);
          for (int d = 0; d < 3; ++d) SP(S_POS + d, i) = SP(S_GCOM + d, i) + rr[d] + lv[d] * dt;
          float q[4] = {SP(S_QUAT, i), SP(S_QUAT + 1, i), SP(S_QUAT + 2, i), SP(S_QUAT + 3, i)}, nq[4];
          qmul(dq, q, nq);
          const float qn = fmaxf(sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3]), 1e-12f);
          for (int d = 0; d < 4; ++d) SP(S_QUAT + d, i) = nq[d] / qn;
        }
      }
      if (last) {
        // deepest floor corner of this part after integration
        __syncwarp();
        float q[4] = {SP(S_QUAT, i), SP(S_QUAT + 1, i), SP(S_QUAT + 2, i), SP(S_QUAT + 3, i)};
        const float z = SP(S_POS + 2, i);
        float pen = 0.f;
        for (int e = c.part_off[i] + lane; e < c.part_off[i] + c.part_nfloor[i]; e += 32) {
          const float* lc = c.lane_const + (size_t)(c.part_ent[e] >> 1) * LC;
          float cn[3] = {lc[0], lc[1], lc[2]}, rc[3];
          qrot(q, cn, rc);
          const float d = -(z + rc[2]);
          pen = fmaxf(pen, fmaxf(d > -slop ? d - slop : 0.f, 0.f));
        }
        pen = warp_max(pen);
        if (lane == 0) SP(S_PEN, i) = pen;
      }
    }
    __syncthreads();
    if (last) break;
    for (int k = c.tid; k < K; k += c.nt) {
      const int pa = c.lane_part[2 * k];
      const int pb = c.lane_part[2 * k + 1];
      float ra[3] = {LN(F_RA, k), LN(F_RA + 1, k), LN(F_RA + 2, k)};
      float la[3] = {SP(S_LV, pa), SP(S_LV + 1, pa), SP(S_LV + 2, pa)};
      float wa[3] = {SP(S_AV, pa), SP(S_AV + 1, pa), SP(S_AV + 2, pa)};
      float cwa[3];
      cross3(wa, ra, cwa);
      float vr[3];
      for (int d = 0; d < 3; ++d) vr[d] = la[d] + cwa[d];
      if (pb >= 0) {
        float rb[3] = {LN(F_RB, k), LN(F_RB + 1, k), LN(F_RB + 2, k)};
        float wb[3] = {SP(S_AV, pb), SP(S_AV + 1, pb), SP(S_AV + 2, pb)};
        float cwb[3];
        cross3(wb, rb, cwb);
        for (int d = 0; d < 3; ++d) vr[d] -= SP(S_LV + d, pb) + cwb[d];
      }
      if (ARM && k >= Kb) {
        for (int d = 0; d < 3; ++d) vr[d] -= LN(F_VB + d, k);
      }
      float vd[3];
      for (int d = 0; d < 3; ++d) {
        const int fd = d == 0 ? F_N : (d == 1 ? F_T1 : F_T2);
        vd[d] = vr[0] * LN(fd, k) + vr[1] * LN(fd + 1, k) + vr[2] * LN(fd + 2, k);
      }
      const float sc = LN(F_SCALE, k);
      const float l0 = LN(F_LAM, k) - (vd[0] + LN(F_BIAS, k)) * LN(F_IW, k) * sc;
      const float l1 = LN(F_LAM + 1, k) - vd[1] * LN(F_IW + 1, k) * sc;
      const float l2 = LN(F_LAM + 2, k) - vd[2] * LN(F_IW + 2, k) * sc;
      const float ln = fmaxf(l0, 0.f);
      const float mf = c.lane_const[(size_t)k * LC + LC_FRIC] * ln;
      LN(F_LAM, k) = ln;
      LN(F_LAM + 1, k) = fminf(fmaxf(l1, -mf), mf);
      LN(F_LAM + 2, k) = fminf(fmaxf(l2, -mf), mf);
    }
    __syncthreads();
  }
}

// ---- 8. floor projection: lift each group by its deepest corner ----
__device__ __forceinline__ void floor_lift(const Block& c) {
  const int P = c.P;
  for (int i = c.tid; i < P; i += c.nt) {
    float lift = 0.f;
    for (int q = 0; q < P; ++q)
      if (c.grp[q] == c.grp[i]) lift = fmaxf(lift, SP(S_PEN, q));
    SP(S_POS + 2, i) += lift;
  }
}

}  // namespace furniture
