// Arm physics kernel: n coupled substeps of arm + parts per env in one launch.
//
// Replaces furniture_tpu/physics/arm_megakernel.py::ArmMegaPhysics._kernel_body,
// the Pallas TPU kernel of the JAX package. Per substep it computes what that
// kernel computes: forward kinematics of the joint chain, joint axes and
// anchors, the hand-geom poses and velocities; the part group aggregates and
// the floor, vertex-in-box and SAT lanes of the free-part kernel; the robot
// lanes both ways (part sample points in robot boxes, robot sample points in
// part boxes) with the prescribed robot surface velocity; touch flags; the
// gripper squeeze servo and its two gates; the finger-servo press; actuator
// forces; the all-lane warm-started Jacobi solve (warm cap 200 on part
// lanes, 30 on robot lanes); the contact reaction on the joints
// p_c = J^T(-lambda), clipped; the semi-implicit joint update with the
// per-control-step matrices G1 and G2, joint velocity and position limits;
// part integration and floor projection. lambda starts at zero at each launch.
//
// Where the JAX package's two arm paths differ, this kernel follows the
// eager path (envs/arm.py::_sim_substeps), which is the plain PyTorch
// version it is held against: the optional held-velocity clamp acts after
// the substep has integrated positions, and the robot surface velocity is
// taken at the geom center plus omega x r.
//
// What bounds it on the H100. State through HBM is about 1.3 KB per env per
// launch for Sawyer (parts, joints, ctrl, G1, G2 in; parts, joints, touch
// out): under 1 us of HBM bandwidth at B = 512. The work is FP32 arithmetic
// over K = 1260 (Sawyer) to 1610 (Baxter) lanes x 13 solver sweeps x 50
// substeps, plus ~40 block barriers per substep and a serial joint chain
// (<= 37 bodies) per substep. So the bound is operations and latency, not
// memory.
//
// What the design does about that bound. One thread block per env runs the
// whole n-substep loop with everything resident in shared memory: part and
// joint state, G1 and G2, the body poses, and the 27-float working set of
// every lane (136 KB for Sawyer, 174 KB for Baxter: one block per SM, hence
// 512 threads per block). A working set above the shared-memory limit goes to
// a global scratch buffer through the same pointer. The chain is a loop over
// constant tables (parent, local pose, joint type, axis, anchor), run by one
// thread while the other warps compute the part frames. The TPU kernel's
// per-lane loops over joints (surface velocity, p_c) are replaced by sums per
// hand geom: each robot lane's velocity is v_g + w_g x (p - c_g), and p_c
// comes from the force and torque each hand geom received, reduced one warp
// per geom over a static lane list in a fixed order (no float atomics), then
// projected on the joints that move the geom's body.

#include "physics_common.cuh"

namespace {

using namespace furniture;

// joint and actuator kinds (robots/chain.py)
constexpr int HINGE = 0;
constexpr int VELOCITY = 1;
constexpr int POSITION = 2;

// indices into the pointer array handed to arm_control_step
enum PtrIndex {
  I_POS, I_QUAT, I_LIN, I_ANG, I_GROUP, I_GSCALE, I_QPOS, I_QVEL, I_CTRL, I_TAUX,
  I_G1, I_G2,
  O_POS, O_QUAT, O_LIN, O_ANG, O_QPOS, O_QVEL, O_TOUCH,
  T_PART_CONST, T_LANE_CONST, T_LANE_PART, T_PART_OFF, T_PART_NFLOOR, T_PART_ENT,
  T_BODY_F, T_BODY_I, T_JNT_F, T_JNT_I, T_RG_F, T_RG_I, T_RG_ANC, T_ACT_F, T_ACT_I,
  T_GRIP_I, T_GRIP_F, T_RL_I, T_RG_OFF, T_RG_ENT,
  SCRATCH,
  NUM_PTRS
};

enum IntIndex {
  N_B, N_P, N_KF, N_KP, N_KE, N_KR, N_L, N_SUBSTEPS, N_ITERS, N_NB, N_NJ, N_NA, N_NRG,
  N_NARM, N_NGRIP, N_COUPLE, N_THREADS, N_SMEM,
  NUM_INTS
};

enum FloatIndex {
  X_DT, X_DTG, X_SLOP, X_RELAX, X_MAXV, X_SQUEEZE, X_HALF_SQUEEZE, X_PRESS_VEL,
  X_PC_CAP, X_HELD_VEL, X_HELD_ANGVEL,
  NUM_FLOATS
};

// table widths
constexpr int BODY_F = 13;   // local pos (3), local quat (4), joint axis (3), anchor (3)
constexpr int BODY_I = 3;    // parent, joint (-1: none), joint type
constexpr int JNT_F = 10;    // axis (3), anchor (3), frictionloss, max vel, lo, hi
constexpr int JNT_I = 2;     // body, type
constexpr int RG_F = 7;      // local pos (3), local quat (4)
constexpr int RG_I = 2;      // body, arm whose finger it is (-1: none)
constexpr int ACT_F = 5;     // gain, ctrl lo, ctrl hi, force lo, force hi
constexpr int ACT_I = 2;     // joint, kind
constexpr int GRIP_I = 3;    // arm, actuator row, joint
constexpr int RL_I = 2;      // hand-geom slot, finger code (arm * 2 + side, -1: none)

struct ArmParams {
  const float* pos;
  const float* quat;
  const float* lin;
  const float* ang;
  const int* group;
  const float* gscale;
  const float* qpos;
  const float* qvel;
  const float* ctrl;
  const float* taux;
  const float* G1;
  const float* G2;
  float* pos_out;
  float* quat_out;
  float* lin_out;
  float* ang_out;
  float* qpos_out;
  float* qvel_out;
  uint8_t* touch_out;
  const float* part_const;
  const float* lane_const;
  const int* lane_part;
  const int* part_off;
  const int* part_nfloor;
  const int* part_ent;
  const float* body_f;
  const int* body_i;
  const float* jnt_f;
  const int* jnt_i;
  const float* rg_f;
  const int* rg_i;
  const float* rg_anc;    // [NRG,NJ] 1 where joint j moves the geom's body
  const float* act_f;
  const int* act_i;
  const int* grip_i;
  const float* grip_f;    // [NGRIP] closing sign
  const int* rl_i;        // [Kr,RL_I]
  const int* rg_off;      // [NRG+1] offsets into rg_ent
  const int* rg_ent;      // [Kr] lanes of each hand geom
  float* scratch;
  int P, Kf, Kp, Ke, Kr, L, n, iters, NB, NJ, NA, NRG, NARM, NGRIP, couple;
  float dt, dtg, slop, relax, maxv, squeeze, half_squeeze, press_vel, pc_cap;
  float held_vel, held_angvel;
};

// The robot's shared-memory block, in floats, after the part fields and the
// group labels. The wrapper sizes the launch with the same function.
struct RobotLayout {
  int bpos, bquat, axis, anchor, qp, qv, qv_old, rhs, tau, ctrl, ctrl_eff, g1, g2;
  int rgp, rgq, rgv, rgw, rgpen, rgF, rgT, deepf, touch, pin, total;
  __host__ __device__ RobotLayout(int P, int NB, int NJ, int NA, int NRG, int NARM) {
    int o = 0;
    bpos = o; o += 3 * NB;
    bquat = o; o += 4 * NB;
    axis = o; o += 3 * NJ;
    anchor = o; o += 3 * NJ;
    qp = o; o += NJ;
    qv = o; o += NJ;
    qv_old = o; o += NJ;
    rhs = o; o += NJ;
    tau = o; o += NJ;
    ctrl = o; o += NA;
    ctrl_eff = o; o += NA;
    g1 = o; o += NJ * NJ;
    g2 = o; o += NJ * NJ;
    rgp = o; o += 3 * NRG;
    rgq = o; o += 4 * NRG;
    rgv = o; o += 3 * NRG;
    rgw = o; o += 3 * NRG;
    rgpen = o; o += NRG;
    rgF = o; o += 3 * NRG;
    rgT = o; o += 3 * NRG;
    deepf = o; o += NARM;
    touch = o; o += 2 * NARM * P;
    pin = o; o += P;
    total = o;
  }
};

// joint j's motion field at world point p: hinge a x (p - o), slide a
__device__ __forceinline__ void joint_phi(const float* axis, const float* anchor, bool hinge,
                                          const float* p, float* phi) {
  if (hinge) {
    float d[3] = {p[0] - anchor[0], p[1] - anchor[1], p[2] - anchor[2]};
    cross3(axis, d, phi);
  } else {
    phi[0] = axis[0];
    phi[1] = axis[1];
    phi[2] = axis[2];
  }
}

__global__ void __launch_bounds__(512)
arm_control_step_kernel(ArmParams p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int P = p.P, NB = p.NB, NJ = p.NJ, NA = p.NA, NRG = p.NRG, NARM = p.NARM;
  const int Kb = p.Kf + p.Kp + p.Ke;
  const int K = Kb + p.Kr;
  const int NT = 2 * NARM * P;
  Block c;
  c.P = P;
  c.Kf = p.Kf;
  c.Kp = p.Kp;
  c.Ke = p.Ke;
  c.K = K;
  c.iters = p.iters;
  c.dt = p.dt;
  c.dtg = p.dtg;
  c.slop = p.slop;
  c.relax = p.relax;
  c.maxv = p.maxv;
  c.tid = threadIdx.x;
  c.nt = blockDim.x;
  c.warp = c.tid >> 5;
  c.lane = c.tid & 31;
  c.nwarps = c.nt >> 5;
  c.sp = smem;
  c.grp = reinterpret_cast<int*>(c.sp + PF * P);
  float* rs = reinterpret_cast<float*>(c.grp + P);
  const RobotLayout ro(P, NB, NJ, NA, NRG, NARM);
  c.lanes = p.scratch ? p.scratch + (size_t)b * NF_ARM * K : rs + ro.total;
  c.lane_const = p.lane_const;
  c.lane_part = p.lane_part;
  c.part_off = p.part_off;
  c.part_nfloor = p.part_nfloor;
  c.part_ent = p.part_ent;
  const int tid = c.tid, nt = c.nt;
  const float dt = p.dt, slop = p.slop;

  float* bpos = rs + ro.bpos;
  float* bquat = rs + ro.bquat;
  float* axis_w = rs + ro.axis;
  float* anchor_w = rs + ro.anchor;
  float* qp = rs + ro.qp;
  float* qv = rs + ro.qv;
  float* qv_old = rs + ro.qv_old;
  float* rhs = rs + ro.rhs;
  float* tau = rs + ro.tau;
  float* ctrl = rs + ro.ctrl;
  float* ctrl_eff = rs + ro.ctrl_eff;
  float* g1 = rs + ro.g1;
  float* g2 = rs + ro.g2;
  float* rgp = rs + ro.rgp;
  float* rgq = rs + ro.rgq;
  float* rgv = rs + ro.rgv;
  float* rgw = rs + ro.rgw;
  float* rgpen = rs + ro.rgpen;
  float* rgF = rs + ro.rgF;
  float* rgT = rs + ro.rgT;
  float* arm_deepf = rs + ro.deepf;
  float* touch = rs + ro.touch;
  float* pin = rs + ro.pin;

  load_parts(c, b, p.pos, p.quat, p.lin, p.ang, p.group, p.gscale, p.part_const);
  for (int j = tid; j < NJ; j += nt) {
    qp[j] = p.qpos[(size_t)b * NJ + j];
    qv[j] = p.qvel[(size_t)b * NJ + j];
  }
  for (int i = tid; i < NA; i += nt) {
    ctrl[i] = p.ctrl[(size_t)b * NA + i];
    ctrl_eff[i] = ctrl[i];
  }
  for (int i = tid; i < NJ * NJ; i += nt) {
    g1[i] = p.G1[(size_t)b * NJ * NJ + i];
    g2[i] = p.G2[(size_t)b * NJ * NJ + i];
  }
  for (int i = tid; i < NT; i += nt) touch[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < p.n; ++s) {
    // ---- A. forward kinematics (one thread walks the chain) beside the
    // part frames; touch flags cleared ----
    if (tid == nt - 1) {
      for (int i = 0; i < NB; ++i) {
        const float* bf = p.body_f + i * BODY_F;
        const int par = p.body_i[i * BODY_I];
        const int jn = p.body_i[i * BODY_I + 1];
        const int jt = p.body_i[i * BODY_I + 2];
        float pre_pos[3], pre_quat[4];
        if (par < 0) {
          for (int d = 0; d < 3; ++d) pre_pos[d] = bf[d];
          for (int d = 0; d < 4; ++d) pre_quat[d] = bf[3 + d];
        } else {
          float r[3];
          qrot(bquat + 4 * par, bf, r);
          for (int d = 0; d < 3; ++d) pre_pos[d] = bpos[3 * par + d] + r[d];
          qmul(bquat + 4 * par, bf + 3, pre_quat);
        }
        float* wpos = bpos + 3 * i;
        float* wquat = bquat + 4 * i;
        if (jn < 0) {
          for (int d = 0; d < 3; ++d) wpos[d] = pre_pos[d];
          for (int d = 0; d < 4; ++d) wquat[d] = pre_quat[d];
        } else if (jt == HINGE) {
          const float half = qp[jn] * 0.5f;
          const float sh = sinf(half);
          float qr[4] = {cosf(half), sh * bf[7], sh * bf[8], sh * bf[9]}, wq[4];
          qmul(pre_quat, qr, wq);
          float r0[3], r1[3];
          qrot(pre_quat, bf + 10, r0);
          qrot(wq, bf + 10, r1);
          for (int d = 0; d < 3; ++d) wpos[d] = pre_pos[d] + r0[d] - r1[d];
          for (int d = 0; d < 4; ++d) wquat[d] = wq[d];
        } else {
          float r[3];
          qrot(pre_quat, bf + 7, r);
          for (int d = 0; d < 3; ++d) wpos[d] = pre_pos[d] + r[d] * qp[jn];
          for (int d = 0; d < 4; ++d) wquat[d] = pre_quat[d];
        }
      }
    }
    part_frames(c);
    for (int i = tid; i < NT; i += nt) touch[i] = 0.f;
    __syncthreads();

    // ---- B. joint axes and anchors, hand-geom poses, group aggregates ----
    for (int j = tid; j < NJ; j += nt) {
      const float* jf = p.jnt_f + j * JNT_F;
      const int body = p.jnt_i[j * JNT_I];
      float r[3];
      qrot(bquat + 4 * body, jf, axis_w + 3 * j);
      qrot(bquat + 4 * body, jf + 3, r);
      for (int d = 0; d < 3; ++d) anchor_w[3 * j + d] = bpos[3 * body + d] + r[d];
    }
    for (int g = tid; g < NRG; g += nt) {
      const float* gf = p.rg_f + g * RG_F;
      const int body = p.rg_i[g * RG_I];
      float r[3];
      qrot(bquat + 4 * body, gf, r);
      for (int d = 0; d < 3; ++d) rgp[3 * g + d] = bpos[3 * body + d] + r[d];
      qmul(bquat + 4 * body, gf + 3, rgq + 4 * g);
    }
    group_aggregates(c);
    __syncthreads();

    // ---- C. velocity of each hand geom: v at its center, omega ----
    for (int g = tid; g < NRG; g += nt) {
      float v[3] = {0.f, 0.f, 0.f}, w[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < NJ; ++j) {
        if (p.rg_anc[g * NJ + j] == 0.f) continue;
        const bool hinge = p.jnt_i[j * JNT_I + 1] == HINGE;
        float phi[3];
        joint_phi(axis_w + 3 * j, anchor_w + 3 * j, hinge, rgp + 3 * g, phi);
        for (int d = 0; d < 3; ++d) {
          v[d] += qv[j] * phi[d];
          if (hinge) w[d] += qv[j] * axis_w[3 * j + d];
        }
      }
      for (int d = 0; d < 3; ++d) {
        rgv[3 * g + d] = v[d];
        rgw[3 * g + d] = w[d];
      }
    }
    __syncthreads();

    // ---- D. narrow phase and solver prep, every lane ----
    for (int k = tid; k < K; k += nt) {
      float point[3], nrm[3], depth;
      bool fm;
      if (k < Kb) {
        base_lane_contact(c, k, point, nrm, &depth, &fm);
        lane_prep(c, k, point, nrm, depth, fm);
        continue;
      }
      const int r = k - Kb;
      const int pa = p.lane_part[2 * k];
      const int g = p.rl_i[r * RL_I];
      const int finger = p.rl_i[r * RL_I + 1];
      const float* lc = p.lane_const + (size_t)k * LC;
      float qa[4] = {SP(S_QUAT, pa), SP(S_QUAT + 1, pa), SP(S_QUAT + 2, pa), SP(S_QUAT + 3, pa)};
      float xa[3] = {SP(S_POS, pa), SP(S_POS + 1, pa), SP(S_POS + 2, pa)};
      bool inside;
      if (r < p.L) {
        // side 1: a sample point of the part geom in the robot box; the
        // normal pushes the part out of the robot box
        float rc[3];
        qrot(qa, lc, rc);
        for (int d = 0; d < 3; ++d) point[d] = xa[d] + rc[d];
        point_in_box(point, rgp + 3 * g, rgq + 4 * g, lc + 3, slop, &depth, nrm, &inside);
      } else {
        // side 2: a sample point of the robot geom in the part geom's box;
        // that face normal pushes the robot point out: flipped, it acts on
        // the part
        float rc[3], wq[4], wp[3];
        qrot(rgq + 4 * g, lc, rc);
        for (int d = 0; d < 3; ++d) point[d] = rgp[3 * g + d] + rc[d];
        qmul(qa, lc + 6, wq);
        qrot(qa, lc + 3, wp);
        for (int d = 0; d < 3; ++d) wp[d] += xa[d];
        point_in_box(point, wp, wq, lc + 10, slop, &depth, nrm, &inside);
        for (int d = 0; d < 3; ++d) nrm[d] = -nrm[d];
      }
      fm = inside && (depth > -slop);
      lane_prep(c, k, point, nrm, depth, fm);
      // robot lanes have no b part: F_RB keeps the world point, F_VB the
      // robot surface velocity there; F_SCALE holds the depth until phase G
      // sets the lane scale
      LN(F_SCALE, k) = depth;
      float rel[3], wxr[3];
      for (int d = 0; d < 3; ++d) {
        LN(F_RB + d, k) = point[d];
        rel[d] = point[d] - rgp[3 * g + d];
      }
      cross3(rgw + 3 * g, rel, wxr);
      for (int d = 0; d < 3; ++d) LN(F_VB + d, k) = rgv[3 * g + d] + wxr[d];
      if (inside && finger >= 0) touch[finger * P + pa] = 1.f;
    }
    __syncthreads();

    // ---- E. SAT gate; deepest engaged penetration of each hand geom ----
    sat_gate(c);
    for (int g = c.warp; g < NRG; g += c.nwarps) {
      float pen = -1e9f;
      for (int e = p.rg_off[g] + c.lane; e < p.rg_off[g + 1]; e += 32) {
        const int k = p.rg_ent[e];
        if (LN(F_MASK, k) > 0.f) pen = fmaxf(pen, LN(F_SCALE, k));
      }
      pen = warp_max(pen);
      if (c.lane == 0) rgpen[g] = pen;
    }
    __syncthreads();

    // ---- F. squeeze servo gates per arm; active-lane counts ----
    for (int a = tid; a < NARM; a += nt) {
      float pen = -1e9f;
      for (int g = 0; g < NRG; ++g)
        if (p.rg_i[g * RG_I + 1] == a) pen = fmaxf(pen, rgpen[g]);
      const bool deep = pen > p.squeeze;
      bool closing = false;
      for (int i = 0; i < p.NGRIP; ++i) {
        if (p.grip_i[i * GRIP_I] != a) continue;
        const int row = p.grip_i[i * GRIP_I + 1];
        const int gj = p.grip_i[i * GRIP_I + 2];
        const float cs = p.grip_f[i];
        closing = closing || (cs * (ctrl[row] - qp[gj]) > 0.f);
        const float held = cs > 0.f ? fminf(ctrl[row], qp[gj]) : fmaxf(ctrl[row], qp[gj]);
        ctrl_eff[row] = deep ? held : ctrl[row];
      }
      arm_deepf[a] = (closing && (pen > p.half_squeeze)) ? 1.f : 0.f;
    }
    count_active(c);
    __syncthreads();

    // ---- G. lane scale, warm start, finger-servo press; actuator forces ----
    for (int k = tid; k < K; k += nt) {
      if (k < Kb) {
        warm_start_lane(c, k, 200.f);
        continue;
      }
      warm_start_lane(c, k, 30.f);
      const int finger = p.rl_i[(k - Kb) * RL_I + 1];
      if (p.press_vel > 0.f && finger >= 0 && LN(F_MASK, k) > 0.f &&
          arm_deepf[finger >> 1] > 0.f) {
        for (int d = 0; d < 3; ++d) LN(F_VB + d, k) += p.press_vel * LN(F_N + d, k);
      }
    }
    for (int j = tid; j < NJ; j += nt) {
      float t = 0.f;
      for (int i = 0; i < NA; ++i) {
        if (p.act_i[i * ACT_I] != j) continue;
        const float* af = p.act_f + i * ACT_F;
        const int kind = p.act_i[i * ACT_I + 1];
        const float cc = fminf(fmaxf(ctrl_eff[i], af[1]), af[2]);
        float f;
        if (kind == VELOCITY) {
          f = af[0] * cc;
        } else if (kind == POSITION) {
          f = af[0] * (cc - qp[j]);
        } else {
          f = fminf(fmaxf(af[0] * cc, af[3]), af[4]);
        }
        t += f;
      }
      tau[j] = t + p.taux[(size_t)b * NJ + j];
    }
    __syncthreads();

    // ---- H. Jacobi sweeps, velocity clamp, part integration ----
    jacobi_integrate<true>(c);

    // ---- I. floor projection; force and torque on each hand geom ----
    floor_lift(c);
    for (int g = c.warp; g < NRG; g += c.nwarps) {
      float sv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int e = p.rg_off[g] + c.lane; e < p.rg_off[g + 1]; e += 32) {
        const int k = p.rg_ent[e];
        const float fm = LN(F_MASK, k);
        const float l0 = LN(F_LAM, k), l1 = LN(F_LAM + 1, k), l2 = LN(F_LAM + 2, k);
        float imp[3], rel[3], tq[3];
        for (int d = 0; d < 3; ++d) {
          imp[d] = (l0 * LN(F_N + d, k) + l1 * LN(F_T1 + d, k) + l2 * LN(F_T2 + d, k)) * fm;
          rel[d] = LN(F_RB + d, k) - rgp[3 * g + d];
        }
        cross3(rel, imp, tq);
        for (int d = 0; d < 3; ++d) {
          sv[d] += imp[d];
          sv[3 + d] += tq[d];
        }
      }
      for (int d = 0; d < 6; ++d) sv[d] = warp_sum(sv[d]);
      if (c.lane == 0) {
        for (int d = 0; d < 3; ++d) {
          rgF[3 * g + d] = sv[d];
          rgT[3 * g + d] = sv[3 + d];
        }
      }
    }
    __syncthreads();

    // ---- J. contact reaction on the joints p_c = J^T(-lambda), the joint
    // update's right-hand side; pinched parts for the held clamp ----
    for (int j = tid; j < NJ; j += nt) {
      float pc = 0.f;
      if (p.couple) {
        const bool hinge = p.jnt_i[j * JNT_I + 1] == HINGE;
        const float* ax = axis_w + 3 * j;
        for (int g = 0; g < NRG; ++g) {
          if (p.rg_anc[g * NJ + j] == 0.f) continue;
          if (hinge) {
            float d[3] = {rgp[3 * g] - anchor_w[3 * j], rgp[3 * g + 1] - anchor_w[3 * j + 1],
                          rgp[3 * g + 2] - anchor_w[3 * j + 2]};
            float dxF[3];
            cross3(d, rgF + 3 * g, dxF);
            pc -= ax[0] * (rgT[3 * g] + dxF[0]) + ax[1] * (rgT[3 * g + 1] + dxF[1]) +
                  ax[2] * (rgT[3 * g + 2] + dxF[2]);
          } else {
            pc -= dot3(ax, rgF + 3 * g);
          }
        }
        pc = fminf(fmaxf(pc, -p.pc_cap), p.pc_cap);
      }
      const float* jf = p.jnt_f + j * JNT_F;
      rhs[j] = tau[j] - jf[6] * tanhf(qv[j] / 0.01f) + pc / dt;
      qv_old[j] = qv[j];
    }
    if (p.held_vel > 0.f) {
      for (int i = tid; i < P; i += nt) {
        float pn = 0.f;
        for (int a = 0; a < NARM; ++a)
          if (touch[(2 * a) * P + i] > 0.f && touch[(2 * a + 1) * P + i] > 0.f &&
              arm_deepf[a] > 0.f)
            pn = 1.f;
        pin[i] = pn;
      }
    }
    __syncthreads();

    // ---- K. joint update with G1, G2, velocity and position limits; the
    // optional held-velocity clamp on pinched groups ----
    for (int j = tid; j < NJ; j += nt) {
      float a1 = 0.f, a2 = 0.f;
      for (int m = 0; m < NJ; ++m) {
        a1 += g1[j * NJ + m] * qv_old[m];
        a2 += g2[j * NJ + m] * rhs[m];
      }
      const float* jf = p.jnt_f + j * JNT_F;
      float v = a1 + a2;
      v = fminf(fmaxf(v, -jf[7]), jf[7]);
      const float q_new = qp[j] + dt * v;
      const float q_cl = fminf(fmaxf(q_new, jf[8]), jf[9]);
      if (q_cl != q_new) v = 0.f;
      qp[j] = q_cl;
      qv[j] = v;
    }
    if (p.held_vel > 0.f) {
      for (int i = tid; i < P; i += nt) {
        bool pinned = false;
        for (int q = 0; q < P; ++q)
          if (c.grp[q] == c.grp[i] && pin[q] > 0.f) pinned = true;
        if (!pinned) continue;
        float lv[3] = {SP(S_LIN, i), SP(S_LIN + 1, i), SP(S_LIN + 2, i)};
        float av[3] = {SP(S_ANG, i), SP(S_ANG + 1, i), SP(S_ANG + 2, i)};
        const float sl = fminf(1.f, p.held_vel / fmaxf(sqrtf(dot3(lv, lv)), 1e-9f));
        const float sa = fminf(1.f, p.held_angvel / fmaxf(sqrtf(dot3(av, av)), 1e-9f));
        for (int d = 0; d < 3; ++d) {
          SP(S_LIN + d, i) = lv[d] * sl;
          SP(S_ANG + d, i) = av[d] * sa;
        }
      }
    }
    __syncthreads();
  }

  store_parts(c, b, p.pos_out, p.quat_out, p.lin_out, p.ang_out);
  for (int j = tid; j < NJ; j += nt) {
    p.qpos_out[(size_t)b * NJ + j] = qp[j];
    p.qvel_out[(size_t)b * NJ + j] = qv[j];
  }
  for (int i = tid; i < NT; i += nt) p.touch_out[(size_t)b * NT + i] = touch[i] > 0.f ? 1 : 0;
}

}  // namespace

extern "C" {

// layout constants the wrapper sizes and checks its buffers with
int arm_lane_floats() { return NF_ARM; }
int arm_part_floats() { return PF; }
int arm_lane_const_cols() { return LC; }
int arm_num_ptrs() { return NUM_PTRS; }
int arm_num_ints() { return NUM_INTS; }
int arm_num_floats() { return NUM_FLOATS; }
int arm_robot_floats(int P, int NB, int NJ, int NA, int NRG, int NARM) {
  return RobotLayout(P, NB, NJ, NA, NRG, NARM).total;
}

// Launches the kernel on `stream`, one block of ints[N_THREADS] threads per
// env. ptrs, ints and floats are host arrays indexed by the enums above.
// ptrs[SCRATCH] null keeps the lane working set in dynamic shared memory.
// Returns the CUDA error code of the launch (0 on success).
int arm_control_step(void* const* ptrs, const int* ints, const float* floats, void* stream) {
  ArmParams p;
  p.pos = static_cast<const float*>(ptrs[I_POS]);
  p.quat = static_cast<const float*>(ptrs[I_QUAT]);
  p.lin = static_cast<const float*>(ptrs[I_LIN]);
  p.ang = static_cast<const float*>(ptrs[I_ANG]);
  p.group = static_cast<const int*>(ptrs[I_GROUP]);
  p.gscale = static_cast<const float*>(ptrs[I_GSCALE]);
  p.qpos = static_cast<const float*>(ptrs[I_QPOS]);
  p.qvel = static_cast<const float*>(ptrs[I_QVEL]);
  p.ctrl = static_cast<const float*>(ptrs[I_CTRL]);
  p.taux = static_cast<const float*>(ptrs[I_TAUX]);
  p.G1 = static_cast<const float*>(ptrs[I_G1]);
  p.G2 = static_cast<const float*>(ptrs[I_G2]);
  p.pos_out = static_cast<float*>(ptrs[O_POS]);
  p.quat_out = static_cast<float*>(ptrs[O_QUAT]);
  p.lin_out = static_cast<float*>(ptrs[O_LIN]);
  p.ang_out = static_cast<float*>(ptrs[O_ANG]);
  p.qpos_out = static_cast<float*>(ptrs[O_QPOS]);
  p.qvel_out = static_cast<float*>(ptrs[O_QVEL]);
  p.touch_out = static_cast<uint8_t*>(ptrs[O_TOUCH]);
  p.part_const = static_cast<const float*>(ptrs[T_PART_CONST]);
  p.lane_const = static_cast<const float*>(ptrs[T_LANE_CONST]);
  p.lane_part = static_cast<const int*>(ptrs[T_LANE_PART]);
  p.part_off = static_cast<const int*>(ptrs[T_PART_OFF]);
  p.part_nfloor = static_cast<const int*>(ptrs[T_PART_NFLOOR]);
  p.part_ent = static_cast<const int*>(ptrs[T_PART_ENT]);
  p.body_f = static_cast<const float*>(ptrs[T_BODY_F]);
  p.body_i = static_cast<const int*>(ptrs[T_BODY_I]);
  p.jnt_f = static_cast<const float*>(ptrs[T_JNT_F]);
  p.jnt_i = static_cast<const int*>(ptrs[T_JNT_I]);
  p.rg_f = static_cast<const float*>(ptrs[T_RG_F]);
  p.rg_i = static_cast<const int*>(ptrs[T_RG_I]);
  p.rg_anc = static_cast<const float*>(ptrs[T_RG_ANC]);
  p.act_f = static_cast<const float*>(ptrs[T_ACT_F]);
  p.act_i = static_cast<const int*>(ptrs[T_ACT_I]);
  p.grip_i = static_cast<const int*>(ptrs[T_GRIP_I]);
  p.grip_f = static_cast<const float*>(ptrs[T_GRIP_F]);
  p.rl_i = static_cast<const int*>(ptrs[T_RL_I]);
  p.rg_off = static_cast<const int*>(ptrs[T_RG_OFF]);
  p.rg_ent = static_cast<const int*>(ptrs[T_RG_ENT]);
  p.scratch = static_cast<float*>(ptrs[SCRATCH]);
  p.P = ints[N_P];
  p.Kf = ints[N_KF];
  p.Kp = ints[N_KP];
  p.Ke = ints[N_KE];
  p.Kr = ints[N_KR];
  p.L = ints[N_L];
  p.n = ints[N_SUBSTEPS];
  p.iters = ints[N_ITERS];
  p.NB = ints[N_NB];
  p.NJ = ints[N_NJ];
  p.NA = ints[N_NA];
  p.NRG = ints[N_NRG];
  p.NARM = ints[N_NARM];
  p.NGRIP = ints[N_NGRIP];
  p.couple = ints[N_COUPLE];
  p.dt = floats[X_DT];
  p.dtg = floats[X_DTG];
  p.slop = floats[X_SLOP];
  p.relax = floats[X_RELAX];
  p.maxv = floats[X_MAXV];
  p.squeeze = floats[X_SQUEEZE];
  p.half_squeeze = floats[X_HALF_SQUEEZE];
  p.press_vel = floats[X_PRESS_VEL];
  p.pc_cap = floats[X_PC_CAP];
  p.held_vel = floats[X_HELD_VEL];
  p.held_angvel = floats[X_HELD_ANGVEL];
  const int smem_bytes = ints[N_SMEM];
  cudaError_t err = cudaFuncSetAttribute(
      arm_control_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (ints[N_B] > 0) {
    arm_control_step_kernel<<<ints[N_B], ints[N_THREADS], smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* arm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
