// The connect attempt of the assembly envs, for every env of a batch in one
// launch: the first eligible aligned connector pair, then the interpolation
// toward it or the snap (group move, floor lift, weld, group merge, the next
// subtask), or on a miss only the reset of the attempt counter; an arm env's
// post-connect snap-back move in the same launch. A second instance of the
// same kernel is the cursor env's snap-back move, which comes after the free-
// part kernel's n substeps and before its 1-substep settle.
//
// Replaces no TPU kernel: the JAX package's connect attempt (furniture_tpu/
// envs/assembly.py::try_connect, reached through the cursor's _try_connect
// and the arm's _connect_phase) is plain jnp that XLA fuses under jit. The
// port's eager form of the same function (furniture_tpu_torch/envs/
// assembly.py::AssemblyOps.try_connect with the envs' glue around it, kept
// as the plain version) computes the alignment of every C x C connector pair,
// the interpolation and the snap for every env on every step, and selects
// between them: about 700 small kernels a cursor attempt, 94 for the cursor's
// snap-back move, 833 an arm attempt with its snap-back. On one H100 the host
// took 25-30 ms a step to enqueue them (a third to a half of the step), with
// the card idle through most of that time. This kernel exists to take that
// enqueue off the step.
//
// What bounds it on the H100. Per env: the eligibility of the C x C pairs,
// the alignment of the eligible ones (a few dot products and the A table
// angles each), and where a pair is found a few quaternion products per part
// and a pass over the model's sites: at most a few kFLOP, and the env's
// state, ~300-700 B, read and written once. Neither binds: a launch is
// latency, one env's chain of dependent steps (the search, then the move,
// the lift and the bookkeeping) after the few microseconds every launch
// costs.
//
// Design. One warp per env, ENVS warps a block; no block barrier. A warp
// loads its env's part poses and groups into shared memory (lane p: part p),
// forms the candidate masks and the weld-row gate, then every connector
// site's world pose, up and forward vectors and its table angles' rotated
// forward vectors (lanes over the sites). Lanes stride over the C x C pairs
// in site order (i-major, as argmax over the flattened pairs), 32 at a time;
// a ballot and __ffs give the first hit, and the search stops at the first
// chunk that has one. The winning pair's target frame and the group move are
// computed by every lane alike; lanes then take the parts for the move, the
// sites for the floor lift (a shuffle reduction) and the weld rows for the
// bookkeeping. The model's P, C, W and A come from the launch, within MAX_P,
// MAX_C, MAX_W and MAX_A, which cover every furniture model; the tables stay
// in global memory (read-only, cached). The cursor and the arms differ only
// in their arguments: the candidate sets come from the parts two cursors
// hold, or from the first part both fingers of an arm touch; the attempts
// before the snap (the cursor's 10, the arms' 0); and whether the snap-back
// move is fused.
//
// Rounding. FP32 throughout, in the plain version's formula order; the
// compiler may contract a multiply and an add, so the floats differ from the
// plain version's by rounding (~1e-7 relative). Where nothing connects every
// output is a copy of its input, bit for bit, but the attempt counter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_P = 32;   // parts: a lane each
constexpr int MAX_C = 64;   // connector sites
constexpr int MAX_W = 64;   // weld rows
constexpr int MAX_A = 8;    // table angles a site
constexpr int ENVS = 4;     // envs (warps) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int ATTEMPT = 0, SNAP_MOVE = 1;
constexpr int IN1 = 1, IN2 = 2, FREE = 4;  // a site's candidate flags
constexpr float EPS = 1e-12f;              // transforms._EPS

struct Args {
  // the state in
  const float *pos, *quat, *lin_vel, *ang_vel;  // [B,P,3], [B,P,4], [B,P,3], [B,P,3]
  const int* group;                             // [B,P]
  const uint8_t *conn_connected, *weld_active;  // [B,C], [B,W]
  const int *num_connected, *subtask, *connect_step, *body1;  // [B], [B,2], [B], [B]
  const float *body1_pos, *body1_quat;                        // [B,3], [B,4]
  // the candidates: the connect action [B] at connect_stride, and either the
  // parts two cursors hold [B,2] or the fingers' touches [B,arms,P] at
  // strides (touch_sb, touch_sa, 1)
  const float* connect;
  const int* held;
  const uint8_t *touch_l, *touch_r;
  // the state out
  float *pos_out, *quat_out, *lin_out, *ang_out;
  int* group_out;
  uint8_t *conn_out, *weld_out;
  int *num_out, *subtask_out, *step_out, *body1_out;
  float *body1_pos_out, *body1_quat_out;
  int* held_out;
  // the model's tables
  const float* conn_pos;      // [C,3]
  const int* conn_part;       // [C]
  const uint8_t* compl_;      // [C,C] the sites pair up
  const float *cos_a, *sin_a; // [C,A] of the table angles (radians)
  const uint8_t* angle_mask;  // [C,A]
  const uint8_t* has_angles;  // [C]
  const float* site_pos;      // [S,3]
  const int* site_part;       // [S]
  const int *weld_part1, *weld_part2;  // [W]
  const int* weld_lookup;     // [P,P] weld row of a part pair, -1: none
  int B, P, C, W, A, S;
  int connect_stride, touch_sb, touch_sa, arms;
  int n_try;     // attempts before the snap (the snap where connect_step >= n_try)
  int n_interp;  // the interpolation's step count
  int snap_back; // fuse the post-connect snap-back move
  float pos_dist, half_pos_dist, rot_up, rot_fwd, project_dist;
};

// words of one env's shared memory
__host__ __device__ __forceinline__ int env_words(int P, int C, int A) {
  return 10 * P + 12 * C + 3 * C * A;
}

// one env's working set in shared memory
struct Env {
  float *pos, *quat;                  // [P,3], [P,4]
  float *cpos, *cup, *cfwd, *cnup;    // [C,3] x 3, [C]
  float* frot;                        // [C,A,3] forward vectors at the table angles
  int *group, *part_in, *label_has;   // [P] x 3
  int *cgroup, *cflag;                // [C] x 2
};

__device__ Env layout(float* sm, int P, int C, int A) {
  Env e;
  e.pos = sm;
  e.quat = e.pos + 3 * P;
  e.cpos = e.quat + 4 * P;
  e.cup = e.cpos + 3 * C;
  e.cfwd = e.cup + 3 * C;
  e.cnup = e.cfwd + 3 * C;
  e.frot = e.cnup + C;
  int* ip = reinterpret_cast<int*>(e.frot + 3 * C * A);
  e.group = ip;
  e.part_in = ip + P;
  e.label_has = ip + 2 * P;
  e.cgroup = ip + 3 * P;
  e.cflag = ip + 3 * P + C;
  return e;
}

// transforms.py, in its formula order. torch.clamp passes a NaN through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
// quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  const float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross(u, v, uv);
  cross(u, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.f * (q[0] * uv[k] + uuv[k]);
}
__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}
// quat_inv: the conjugate over max(|q|^2, eps)
__device__ __forceinline__ void qinv(const float* q, float* o) {
  const float n = clamp_min(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], EPS);
  o[0] = q[0] / n;
  for (int k = 1; k < 4; ++k) o[k] = -q[k] / n;
}
__device__ __forceinline__ void qnormalize(float* q) {
  const float n = clamp_min(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), EPS);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}
// unit: v / sqrt(|v|^2 + eps^2)
__device__ __forceinline__ void unit(const float* v, float* o) {
  const float n = sqrtf(dot3(v, v) + EPS * EPS);
  for (int k = 0; k < 3; ++k) o[k] = v[k] / n;
}
__device__ __forceinline__ void up_vector(const float* q, float* o) {
  o[0] = 2.f * (q[1] * q[3] - q[0] * q[2]);
  o[1] = 2.f * (q[2] * q[3] + q[0] * q[1]);
  o[2] = 1.f - 2.f * (q[1] * q[1] + q[2] * q[2]);
}
__device__ __forceinline__ void forward_vector(const float* q, float* o) {
  o[0] = 2.f * (q[1] * q[2] + q[0] * q[3]);
  o[1] = 1.f - 2.f * (q[1] * q[1] + q[3] * q[3]);
  o[2] = 2.f * (q[2] * q[3] - q[0] * q[1]);
}
// quat_slerp (shortest arc), t in [0, 1]
__device__ void slerp(const float* q0_in, const float* q1_in, float t, float* o) {
  float q0[4], q1[4];
  for (int k = 0; k < 4; ++k) q0[k] = q0_in[k], q1[k] = q1_in[k];
  qnormalize(q0);
  qnormalize(q1);
  float d = q0[0] * q1[0] + q0[1] * q1[1] + q0[2] * q1[2] + q0[3] * q1[3];
  if (d < 0.f)
    for (int k = 0; k < 4; ++k) q1[k] = -q1[k];
  d = fminf(fabsf(d), 1.f);
  const float theta = acosf(d);
  const float sin_theta = sinf(theta);
  const bool lerp = sin_theta < 1e-5f;
  const float s = clamp_min(sin_theta, EPS);
  const float w0 = lerp ? 1.f - t : sinf((1.f - t) * theta) / s;
  const float w1 = lerp ? t : sinf(t * theta) / s;
  for (int k = 0; k < 4; ++k) o[k] = w0 * q0[k] + w1 * q1[k];
  qnormalize(o);
}
// mat_to_quat of the rows (r0, r1, r2): branch-free Shepperd, the case of
// the first maximum of (trace, m00, m11, m22)
__device__ void mat_to_quat(const float* r0, const float* r1, const float* r2, float* q) {
  const float m00 = r0[0], m01 = r0[1], m02 = r0[2];
  const float m10 = r1[0], m11 = r1[1], m12 = r1[2];
  const float m20 = r2[0], m21 = r2[1], m22 = r2[2];
  const float tr = m00 + m11 + m22;
  int best = 0;
  float top = tr;
  if (m00 > top) best = 1, top = m00;
  if (m11 > top) best = 2, top = m11;
  if (m22 > top) best = 3, top = m22;
  if (best == 0) {
    const float s = sqrtf(clamp_min(1.f + tr, EPS)) * 0.5f, d = 4.f * s;
    q[0] = s, q[1] = (m21 - m12) / d, q[2] = (m02 - m20) / d, q[3] = (m10 - m01) / d;
  } else if (best == 1) {
    const float s = sqrtf(clamp_min(1.f + m00 - m11 - m22, EPS)) * 0.5f, d = 4.f * s;
    q[0] = (m21 - m12) / d, q[1] = s, q[2] = (m01 + m10) / d, q[3] = (m02 + m20) / d;
  } else if (best == 2) {
    const float s = sqrtf(clamp_min(1.f - m00 + m11 - m22, EPS)) * 0.5f, d = 4.f * s;
    q[0] = (m02 - m20) / d, q[1] = (m01 + m10) / d, q[2] = s, q[3] = (m12 + m21) / d;
  } else {
    const float s = sqrtf(clamp_min(1.f - m00 - m11 + m22, EPS)) * 0.5f, d = 4.f * s;
    q[0] = (m10 - m01) / d, q[1] = (m02 + m20) / d, q[2] = (m12 + m21) / d, q[3] = s;
  }
  qnormalize(q);
}
// lookat_to_quat(forward, up): rows (right, true up, forward)
__device__ void lookat_to_quat(const float* forward, const float* up, float* q) {
  float v[3], u[3], c[3], v2[3], v3[3];
  unit(forward, v);
  unit(up, u);
  cross(u, v, c);
  unit(c, v2);
  cross(v, v2, v3);
  mat_to_quat(v2, v3, v, q);
}

// The rigid move of base's group (AssemblyOps.move_group): rotate about the
// base part's origin to `target`, then translate by `offset`. Every lane
// reads the base pose before any lane writes.
__device__ void move_group(Env& e, int P, int base, const float* offset, const float* target,
                           int lane) {
  const int gb = e.group[base];
  float bp[3], bq[4], inv[4], rel[4];
  for (int k = 0; k < 3; ++k) bp[k] = e.pos[base * 3 + k];
  for (int k = 0; k < 4; ++k) bq[k] = e.quat[base * 4 + k];
  qinv(bq, inv);
  qmul(target, inv, rel);
  __syncwarp();
  if (lane < P && e.group[lane] == gb) {
    float d[3], r[3], q[4];
    for (int k = 0; k < 3; ++k) d[k] = e.pos[lane * 3 + k] - bp[k];
    qrot(rel, d, r);
    for (int k = 0; k < 3; ++k) e.pos[lane * 3 + k] = r[k] + bp[k] + offset[k];
    qmul(rel, e.quat + lane * 4, q);
    for (int k = 0; k < 4; ++k) e.quat[lane * 4 + k] = q[k];
  }
  __syncwarp();
}

// The snap-back move: body1's group back to (body1_pos, body1_quat).
__device__ void snap_back_move(Env& e, int P, int body1, const float* b1pos,
                               const float* b1quat, int lane) {
  float offset[3];
  for (int k = 0; k < 3; ++k) offset[k] = b1pos[k] - e.pos[body1 * 3 + k];
  move_group(e, P, body1, offset, b1quat, lane);
}

// Alignment of site pair (i, j) (AssemblyOps.alignment).
__device__ bool aligned(const Args& a, const Env& e, int i, int j) {
  const float* pi = e.cpos + 3 * i;
  const float* pj = e.cpos + 3 * j;
  const float* ui = e.cup + 3 * i;
  const float* uj = e.cup + 3 * j;
  const float d[3] = {pj[0] - pi[0], pj[1] - pi[1], pj[2] - pi[2]};
  const float dist = sqrtf(dot3(d, d));
  const float den = clamp_min(dist, EPS);
  const float u[3] = {d[0] / den, d[1] / den, d[2] / den};
  const float up_dist = dot3(ui, uj) / (e.cnup[i] * e.cnup[j]);
  const float p12 = dot3(ui, u);
  const float nu[3] = {-u[0], -u[1], -u[2]};
  const float p21 = dot3(uj, nu);
  bool fwd_ok = true;
  if (a.has_angles[i]) {
    fwd_ok = false;
    for (int k = 0; k < a.A; ++k)
      fwd_ok |= a.angle_mask[i * a.A + k] && dot3(e.frot + (i * a.A + k) * 3, e.cfwd + 3 * j) > a.rot_fwd;
  }
  const bool up_ok = up_dist > a.rot_up;
  const bool proj_ok = fabsf(p12) > a.project_dist && fabsf(p21) > a.project_dist;
  return (dist < a.pos_dist && up_ok && fwd_ok && proj_ok) ||
         (dist < a.half_pos_dist && up_ok && fwd_ok);
}

// The world quat site i's frame takes to connect with site j.
__device__ void target_quat(const Args& a, const Env& e, int i, int j, float* tq) {
  const float* fi = e.cfwd + 3 * i;
  const float* fj = e.cfwd + 3 * j;
  float f[3];
  if (a.has_angles[i]) {
    int first = 0;
    for (int k = a.A - 1; k >= 0; --k)
      if (a.angle_mask[i * a.A + k] && dot3(e.frot + (i * a.A + k) * 3, fj) > a.rot_fwd) first = k;
    for (int k = 0; k < 3; ++k) f[k] = e.frot[(i * a.A + first) * 3 + k];
  } else {
    // the free-angle case: the nearer of the two in-plane rotations
    float kk[3], kxv[3], fp[3], fn[3];
    unit(e.cup + 3 * i, kk);
    cross(kk, fi, kxv);
    const float c = dot3(fi, fj);
    const float s = sqrtf(fmaxf(1.f - c * c, 0.f));
    for (int k = 0; k < 3; ++k) {
      fp[k] = c * fi[k] + s * kxv[k];
      fn[k] = c * fi[k] + -s * kxv[k];
    }
    const bool pos = dot3(fp, fj) > dot3(fn, fj);
    for (int k = 0; k < 3; ++k) f[k] = pos ? fp[k] : fn[k];
  }
  lookat_to_quat(e.cup + 3 * i, f, tq);
}

template <int MODE>
__device__ void connect_env(const Args& a, int env, int lane, float* sm) {
  const int P = a.P, C = a.C, W = a.W, A = a.A;
  Env e = layout(sm, P, C, A);
  for (int p = lane; p < P; p += 32) {
    for (int k = 0; k < 3; ++k) e.pos[p * 3 + k] = a.pos[((size_t)env * P + p) * 3 + k];
    for (int k = 0; k < 4; ++k) e.quat[p * 4 + k] = a.quat[((size_t)env * P + p) * 4 + k];
    e.group[p] = a.group[(size_t)env * P + p];
  }
  __syncwarp();
  int body1 = a.body1[env];
  float b1pos[3], b1quat[4];
  for (int k = 0; k < 3; ++k) b1pos[k] = a.body1_pos[(size_t)env * 3 + k];
  for (int k = 0; k < 4; ++k) b1quat[k] = a.body1_quat[(size_t)env * 4 + k];
  bool zero_vel = true;
  int s1 = -1, s2 = -1, g_p1 = -1, g_p2 = -1, weld_idx = -1;
  int num = 0, step = 0, sub0 = 0, sub1 = 0, held0 = 0, held1 = 0;
  bool snapped = false;

  if (MODE == SNAP_MOVE) {
    snap_back_move(e, P, body1 < 0 ? 0 : body1, b1pos, b1quat, lane);
  } else {
    num = a.num_connected[env];
    step = a.connect_step[env];
    sub0 = a.subtask[(size_t)env * 2];
    sub1 = a.subtask[(size_t)env * 2 + 1];
    const bool press = a.connect[(size_t)env * a.connect_stride] > 0.f;

    // 1. the candidate sets and the gate
    int part1, part2;
    bool gate;
    if (a.held) {
      held0 = a.held[(size_t)env * 2];
      held1 = a.held[(size_t)env * 2 + 1];
      gate = press && held0 >= 0 && held1 >= 0;
      part1 = held0 < 0 ? 0 : held0;
      part2 = held1 < 0 ? 0 : held1;
    } else {
      bool both = false;
      if (lane < P)
        for (int r = 0; r < a.arms; ++r) {
          const size_t o = (size_t)env * a.touch_sb + (size_t)r * a.touch_sa + lane;
          both = both || (a.touch_l[o] && a.touch_r[o]);
        }
      const unsigned m = __ballot_sync(FULL, both);
      gate = press && m != 0u;
      part1 = m ? __ffs(m) - 1 : 0;
      part2 = -1;  // site2 anywhere
    }
    gate = gate && W > 0;

    if (gate) {
      const int g1 = e.group[part1];
      const int g2 = part2 < 0 ? -1 : e.group[part2];
      for (int p = lane; p < P; p += 32) e.part_in[p] = 0, e.label_has[p] = 0;
      __syncwarp();
      // every site's world pose, up, forward and the rotated forwards
      for (int c = lane; c < C; c += 32) {
        const int p = a.conn_part[c];
        const float* q = e.quat + 4 * p;
        const int g = e.group[p];
        const int flag = (g == g1 ? IN1 : 0) | (part2 < 0 || g == g2 ? IN2 : 0) |
                         (a.conn_connected[(size_t)env * C + c] ? 0 : FREE);
        e.cgroup[c] = g;
        e.cflag[c] = flag;
        if (flag & (IN1 | IN2)) e.part_in[p] = 1;
        float r[3], kk[3], kxv[3];
        qrot(q, a.conn_pos + 3 * c, r);
        for (int k = 0; k < 3; ++k) e.cpos[3 * c + k] = e.pos[3 * p + k] + r[k];
        float* up = e.cup + 3 * c;
        float* fwd = e.cfwd + 3 * c;
        up_vector(q, up);
        forward_vector(q, fwd);
        e.cnup[c] = sqrtf(dot3(up, up));
        unit(up, kk);
        cross(kk, fwd, kxv);
        for (int k = 0; k < A; ++k) {
          const float ca = a.cos_a[c * A + k], sa = a.sin_a[c * A + k];
          for (int d = 0; d < 3; ++d) e.frot[(c * A + k) * 3 + d] = ca * fwd[d] + sa * kxv[d];
        }
      }
      __syncwarp();
      // the weld-row gate: a weld row whose two parts' groups both hold a
      // part with a candidate site
      for (int p = lane; p < P; p += 32) {
        const int g = e.group[p];
        if (e.part_in[p] && g >= 0 && g < P) e.label_has[g] = 1;
      }
      __syncwarp();
      bool any_row = false;
      for (int base = 0; base < W && !any_row; base += 32) {
        const int w = base + lane;
        bool row = false;
        if (w < W) {
          const int ga = e.group[a.weld_part1[w]], gb = e.group[a.weld_part2[w]];
          row = ga >= 0 && ga < P && gb >= 0 && gb < P && e.label_has[ga] && e.label_has[gb];
        }
        any_row = __ballot_sync(FULL, row) != 0u;
      }
      // the first eligible aligned pair in site order
      if (any_row) {
        const int n = C * C;
        for (int base = 0; base < n; base += 32) {
          const int idx = base + lane;
          bool ok = false;
          if (idx < n) {
            const int i = idx / C, j = idx - i * C;
            const int fi = e.cflag[i], fj = e.cflag[j];
            ok = (fi & IN1) && (fj & IN2) && (fi & FREE) && (fj & FREE) && a.compl_[idx] &&
                 e.cgroup[i] != e.cgroup[j] && aligned(a, e, i, j);
          }
          const unsigned m = __ballot_sync(FULL, ok);
          if (m) {
            const int hit = base + __ffs(m) - 1;
            s1 = hit / C;
            s2 = hit - s1 * C;
            break;
          }
        }
      }
    }

    // 2. interpolate or snap toward the pair found
    if (s1 >= 0) {
      float tq[4], A_[4], inv[4];
      target_quat(a, e, s1, s2, tq);
      const int p1 = a.conn_part[s1], p2 = a.conn_part[s2];
      const float* site1 = e.cpos + 3 * s1;
      const float* site2 = e.cpos + 3 * s2;
      if (step < a.n_try) {
        // AssemblyOps.interp_connect
        float cur_pos[3], cur_quat[4], d[3], btp[3], btq[4], step_pos[3], step_quat[4], off[3];
        for (int k = 0; k < 3; ++k) cur_pos[k] = e.pos[3 * p2 + k];
        for (int k = 0; k < 4; ++k) cur_quat[k] = e.quat[4 * p2 + k];
        qinv(cur_quat, inv);
        qmul(tq, inv, A_);
        for (int k = 0; k < 3; ++k) d[k] = cur_pos[k] - site2[k];
        qrot(A_, d, btp);
        for (int k = 0; k < 3; ++k) btp[k] = btp[k] + site1[k];
        qmul(A_, cur_quat, btq);
        const int left = a.n_interp - step;
        const float frac = 0.9f / (float)(left < 1 ? 1 : left);
        for (int k = 0; k < 3; ++k) step_pos[k] = cur_pos[k] + frac * (btp[k] - cur_pos[k]);
        slerp(cur_quat, btq, frac, step_quat);
        for (int k = 0; k < 3; ++k) off[k] = step_pos[k] - cur_pos[k];
        move_group(e, P, p2, off, step_quat, lane);
        step = step + 1;
      } else {
        // AssemblyOps.snap_connect: site2's group onto site1
        float s1p[3], s2p[3];
        for (int k = 0; k < 3; ++k) s1p[k] = site1[k], s2p[k] = site2[k];
        g_p1 = e.group[p1];
        g_p2 = e.group[p2];
        qinv(e.quat + 4 * p2, inv);
        qmul(tq, inv, A_);
        __syncwarp();
        if (lane < P && e.group[lane] == g_p2) {
          float dd[3], r[3], q[4];
          for (int k = 0; k < 3; ++k) dd[k] = e.pos[3 * lane + k] - s2p[k];
          qrot(A_, dd, r);
          for (int k = 0; k < 3; ++k) e.pos[3 * lane + k] = r[k] + s1p[k];
          qmul(A_, e.quat + 4 * lane, q);
          for (int k = 0; k < 4; ++k) e.quat[4 * lane + k] = q[k];
        }
        __syncwarp();
        // the floor lift: the lowest site of both groups (and the origin)
        float lo = 0.f;
        for (int s = lane; s < a.S; s += 32) {
          const int p = a.site_part[s];
          const int g = e.group[p];
          if (g == g_p1 || g == g_p2) {
            float r[3];
            qrot(e.quat + 4 * p, a.site_pos + 3 * s, r);
            const float z = e.pos[3 * p + 2] + r[2];
            if (z < lo || z != z) lo = z;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float other = __shfl_xor_sync(FULL, lo, o);
          if (other < lo || other != other) lo = other;
        }
        const float lift = lo < 0.f ? -lo : 0.f;
        if (lane < P) {
          const int g = e.group[lane];
          e.pos[3 * lane + 2] = e.pos[3 * lane + 2] + ((g == g_p1 || g == g_p2) ? lift : 0.f);
        }
        __syncwarp();
        weld_idx = a.weld_lookup[p1 * P + p2];
        for (int k = 0; k < 3; ++k) b1pos[k] = e.pos[3 * p1 + k];
        for (int k = 0; k < 4; ++k) b1quat[k] = e.quat[4 * p1 + k];
        body1 = p1;
        num = num + 1;
        step = 0;
        held1 = -1;
        snapped = true;
        // the next subtask: the first weld row whose parts the merge leaves apart
        sub0 = sub1 = -1;
        for (int base = 0; base < W; base += 32) {
          const int w = base + lane;
          bool open = false;
          if (w < W) {
            int ga = e.group[a.weld_part1[w]], gb = e.group[a.weld_part2[w]];
            ga = ga == g_p1 ? g_p2 : ga;
            gb = gb == g_p1 ? g_p2 : gb;
            open = ga != gb;
          }
          const unsigned m = __ballot_sync(FULL, open);
          if (m) {
            const int first = base + __ffs(m) - 1;
            sub0 = a.weld_part1[first];
            sub1 = a.weld_part2[first];
            break;
          }
        }
      }
    } else {
      step = 0;
      zero_vel = false;
    }

    // 3. the arm's post-connect snap-back
    if (a.snap_back && body1 >= 0) {
      snap_back_move(e, P, body1, b1pos, b1quat, lane);
      body1 = -1;
      zero_vel = true;
    }
  }

  // 4. the state out
  for (int p = lane; p < P; p += 32) {
    const size_t o = (size_t)env * P + p;
    for (int k = 0; k < 3; ++k) {
      a.pos_out[o * 3 + k] = e.pos[p * 3 + k];
      a.lin_out[o * 3 + k] = zero_vel ? 0.f : a.lin_vel[o * 3 + k];
      a.ang_out[o * 3 + k] = zero_vel ? 0.f : a.ang_vel[o * 3 + k];
    }
    for (int k = 0; k < 4; ++k) a.quat_out[o * 4 + k] = e.quat[p * 4 + k];
    if (MODE == ATTEMPT) {
      const int g = e.group[p];
      a.group_out[o] = snapped && g == g_p1 ? g_p2 : g;
    }
  }
  if (MODE == SNAP_MOVE) return;
  for (int c = lane; c < C; c += 32) {
    const size_t o = (size_t)env * C + c;
    a.conn_out[o] = a.conn_connected[o] || (snapped && (c == s1 || c == s2));
  }
  for (int w = lane; w < W; w += 32) {
    const size_t o = (size_t)env * W + w;
    a.weld_out[o] = a.weld_active[o] || (snapped && w == weld_idx);
  }
  if (lane == 0) {
    a.num_out[env] = num;
    a.step_out[env] = step;
    a.body1_out[env] = body1;
    for (int k = 0; k < 3; ++k) a.body1_pos_out[(size_t)env * 3 + k] = b1pos[k];
    for (int k = 0; k < 4; ++k) a.body1_quat_out[(size_t)env * 4 + k] = b1quat[k];
    a.subtask_out[(size_t)env * 2] = sub0;
    a.subtask_out[(size_t)env * 2 + 1] = sub1;
    if (a.held) {
      a.held_out[(size_t)env * 2] = held0;
      a.held_out[(size_t)env * 2 + 1] = held1;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(32 * ENVS) connect_step_kernel(const Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * ENVS + warp;
  if (env >= a.B) return;
  connect_env<MODE>(a, env, lane, smem + warp * env_words(a.P, a.C, a.A));
}

}  // namespace

extern "C" {

// limits and the argument block's size, which the wrapper checks
int connect_max_p() { return MAX_P; }
int connect_max_c() { return MAX_C; }
int connect_max_w() { return MAX_W; }
int connect_max_a() { return MAX_A; }
int connect_args_bytes() { return (int)sizeof(Args); }
// dynamic shared memory of a block
int connect_smem_bytes(int P, int C, int A) { return 4 * ENVS * env_words(P, C, A); }

// Launches the connect attempt (mode 0) or the cursor's snap-back move (mode
// 1) on `stream`, with `args` the argument block (Args, connect_args_bytes()
// bytes). Returns the CUDA error code of the launch (0 on success).
int connect_step(int mode, const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (a->P < 1 || a->P > MAX_P || a->C < 0 || a->C > MAX_C || a->W < 0 || a->W > MAX_W ||
      a->A < 0 || a->A > MAX_A || a->B < 0 || (mode != ATTEMPT && mode != SNAP_MOVE) ||
      (mode == ATTEMPT && !a->held && (!a->touch_l || !a->touch_r)))
    return (int)cudaErrorInvalidValue;
  if (a->B == 0) return 0;
  const int smem = connect_smem_bytes(a->P, a->C, a->A);
  const dim3 grid((a->B + ENVS - 1) / ENVS), block(32 * ENVS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == ATTEMPT)
    connect_step_kernel<ATTEMPT><<<grid, block, smem, s>>>(*a);
  else
    connect_step_kernel<SNAP_MOVE><<<grid, block, smem, s>>>(*a);
  return (int)cudaGetLastError();
}

const char* connect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
