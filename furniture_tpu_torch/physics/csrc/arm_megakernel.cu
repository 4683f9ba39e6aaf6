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
// out): under 1 us of HBM bandwidth at B = 512. The function's work is FP32
// arithmetic over K = 1260 (Sawyer) to 1610 (Baxter) lanes x 13 solver
// passes x 50 substeps: 0.73 ms at the card's FP32 peak for Sawyer, n = 50,
// B = 512. Neither binds: the lane working set (25 floats a slot, 1536
// slots for Sawyer, 2048 for Baxter) fills most of an SM's shared memory and
// 512 threads at 128 registers fill its register file, so one block is
// resident per SM (Sawyer 173 KB, Baxter more: a second block fits neither
// way; two blocks an SM would need 16 floats a slot and 64 registers), and
// the launch is a chain of ~1400 barrier-to-barrier stretches per block
// that nothing overlaps: 4 waves of blocks at B = 512. The bare barriers
// are a floor of ~0.16 ms; the rest is the latency of each stretch with 16
// warps an SM.
//
// What the design does about that (layout and shared device code:
// physics_common.cuh). Every warp works in the lane half of every pass: the
// lanes are dealt to the 16 warps by a-side part (a thread makes LPT = 3
// rounds for Sawyer, 4 for Baxter, over lanes kept field-major in shared
// memory), each lane's impulse is computed once and summed by shuffles,
// and one group pass per rigid group replaces the warp-per-part walk over
// static lane lists. The SAT lanes, the longest straight-line code of the
// narrow phase, are all taken by the last warp. The phases that are a few
// dozen threads wide have no barrier of their own: the last warp runs the
// joint update of the substep before, then this substep's chain (a
// parallel composition over the kinematic tree by pointer jumping,
// log2(depth) rounds, instead of one thread walking up to 37 bodies), the
// joint axes and the hand-geom poses and velocities, side by side with the
// group warps' held clamp, part frames and aggregates; the servo gates and
// the actuator forces run beside the first group pass, the hand-geom force
// sums beside the last. 28 barriers a substep (was ~40). A working set
// above the shared-memory limit goes to a global scratch buffer through the
// same pointer (a kernel instance of its own, so that the instance that
// keeps it in shared memory addresses it as such).

#include "physics_common.cuh"

namespace {

using namespace furniture;

// all lanes of a warp share a part (a thread's LPT rounds too)
constexpr int SEGW = 32;

// joint and actuator kinds (robots/chain.py)
constexpr int HINGE = 0;
constexpr int VELOCITY = 1;
constexpr int POSITION = 2;

// indices into the pointer array handed to arm_control_step
enum PtrIndex {
  I_POS, I_QUAT, I_LIN, I_ANG, I_GROUP, I_GSCALE, I_QPOS, I_QVEL, I_CTRL, I_TAUX,
  I_G1, I_G2,
  O_POS, O_QUAT, O_LIN, O_ANG, O_QPOS, O_QVEL, O_TOUCH,
  T_PART_CONST, T_LANE_CONST, T_SLOT_I, T_SEG_OFF, T_B_OFF, T_FLOOR_OFF, T_FLOOR_SLOT,
  T_SAT_CORNER,
  T_BODY_F, T_BODY_I, T_JNT_F, T_JNT_I, T_RG_F, T_RG_I, T_RG_ANC, T_ACT_F, T_ACT_I,
  T_GRIP_I, T_GRIP_F, T_RG_OFF, T_RG_ENT,
  SCRATCH, CLOCKS,
  NUM_PTRS
};

enum IntIndex {
  N_B, N_P, N_KS, N_LPT, N_NBS, N_KF, N_KE, N_SUBSTEPS, N_ITERS, N_NB, N_NJ, N_NA, N_NRG,
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
  const float4* lane_const;  // [KS,LC]
  const int4* slot_i;        // [KS,SI]; robot slots: hand-geom slot, finger code
                             // (arm * 2 + side, -1: none)
  const int* seg_off;
  const int* b_off;
  const int* floor_off;
  const int* floor_slot;
  const int* sat_corner;
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
  const int* rg_off;      // [NRG+1] offsets into rg_ent
  const int* rg_ent;      // [Kr] slots of each hand geom's lanes
  float* scratch;
  long long* clocks;      // [B, NPHASE] or null (FT_PHASE_CLOCKS builds)
  int P, KS, LPT, NBS, Kf, Ke, n, iters, NB, NJ, NA, NRG, NARM, NGRIP, couple;
  float dt, dtg, slop, relax, maxv, squeeze, half_squeeze, press_vel, pc_cap;
  float held_vel, held_angvel;
};

// The robot's shared-memory block, in floats, after the part fields, the
// group labels and the partial sums. The wrapper sizes the launch with the
// same function.
struct RobotLayout {
  int bpos, bquat, tpos, tquat, anc, axis, anchor, qp, qv, qv_old, rhs, tau, ctrl, ctrl_eff;
  int g1, g2, rgp, rgq, rgv, rgw, rgpen, rgF, rgT, deepf, touch, pin, total;
  __host__ __device__ RobotLayout(int P, int NB, int NJ, int NA, int NRG, int NARM) {
    int o = 0;
    bpos = o; o += 3 * NB;
    bquat = o; o += 4 * NB;
    tpos = o; o += 3 * NB;      // second buffer of the chain's composition
    tquat = o; o += 4 * NB;
    anc = o; o += 2 * NB;       // ints: the ancestor each body is relative to
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
    total = align4(o);
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

// The robot's pointers into shared memory.
struct Robot {
  float *bpos, *bquat, *tpos, *tquat, *axis_w, *anchor_w, *qp, *qv, *qv_old, *rhs, *tau;
  float *ctrl, *ctrl_eff, *g1, *g2, *rgp, *rgq, *rgv, *rgw, *rgpen, *rgF, *rgT;
  float *arm_deepf, *touch, *pin;
  int* anc;
};

// Forward kinematics, one warp: every body's pose relative to its parent
// (joint motion included), then pointer jumping: each round composes a
// body's transform with that of the ancestor it is relative to and moves on
// to that ancestor's ancestor, so a chain of depth d is done in log2(d)
// rounds. Then the joint axes and anchors, the hand-geom poses and the
// hand-geom velocities (v at the center, omega).
__device__ __forceinline__ void robot_kinematics(const ArmParams& p, const Robot& r, int lane) {
  const int NB = p.NB, NJ = p.NJ, NRG = p.NRG;
  for (int i = lane; i < NB; i += 32) {
    const float* bf = p.body_f + i * BODY_F;
    const int jn = p.body_i[i * BODY_I + 1];
    const int jt = p.body_i[i * BODY_I + 2];
    float lp[3] = {bf[0], bf[1], bf[2]}, lq[4] = {bf[3], bf[4], bf[5], bf[6]};
    if (jn >= 0 && jt == HINGE) {
      const float half = r.qp[jn] * 0.5f;
      const float sh = sinf(half);
      float qr[4] = {cosf(half), sh * bf[7], sh * bf[8], sh * bf[9]};
      float ra[3], d[3], rd[3], wq[4];
      qrot(qr, bf + 10, ra);
      for (int k = 0; k < 3; ++k) d[k] = bf[10 + k] - ra[k];
      qrot(bf + 3, d, rd);
      for (int k = 0; k < 3; ++k) lp[k] += rd[k];
      qmul(bf + 3, qr, wq);
      for (int k = 0; k < 4; ++k) lq[k] = wq[k];
    } else if (jn >= 0) {
      float rd[3];
      qrot(bf + 3, bf + 7, rd);
      for (int k = 0; k < 3; ++k) lp[k] += rd[k] * r.qp[jn];
    }
    for (int k = 0; k < 3; ++k) r.bpos[3 * i + k] = lp[k];
    for (int k = 0; k < 4; ++k) r.bquat[4 * i + k] = lq[k];
    r.anc[i] = p.body_i[i * BODY_I];
  }
  __syncwarp();
  float *sp_ = r.bpos, *sq_ = r.bquat, *dp_ = r.tpos, *dq_ = r.tquat;
  int *sa = r.anc, *da = r.anc + NB;
  bool in_b = true;   // the current transforms are in bpos/bquat
  for (;;) {
    bool open = false;
    for (int i = lane; i < NB; i += 32) {
      const int a = sa[i];
      if (a >= 0) {
        float rp[3];
        qrot(sq_ + 4 * a, sp_ + 3 * i, rp);
        for (int k = 0; k < 3; ++k) dp_[3 * i + k] = sp_[3 * a + k] + rp[k];
        qmul(sq_ + 4 * a, sq_ + 4 * i, dq_ + 4 * i);
        da[i] = sa[a];
        open = open || (sa[a] >= 0);
      } else {
        for (int k = 0; k < 3; ++k) dp_[3 * i + k] = sp_[3 * i + k];
        for (int k = 0; k < 4; ++k) dq_[4 * i + k] = sq_[4 * i + k];
        da[i] = -1;
      }
    }
    __syncwarp();
    float* t = sp_; sp_ = dp_; dp_ = t;
    t = sq_; sq_ = dq_; dq_ = t;
    int* ti = sa; sa = da; da = ti;
    in_b = !in_b;
    if (!__any_sync(0xffffffffu, open)) break;
  }
  if (!in_b) {
    for (int i = lane; i < NB; i += 32) {
      for (int k = 0; k < 3; ++k) r.bpos[3 * i + k] = r.tpos[3 * i + k];
      for (int k = 0; k < 4; ++k) r.bquat[4 * i + k] = r.tquat[4 * i + k];
    }
    __syncwarp();
  }
  // joint axes and anchors, hand-geom poses
  for (int j = lane; j < NJ; j += 32) {
    const float* jf = p.jnt_f + j * JNT_F;
    const int body = p.jnt_i[j * JNT_I];
    float a[3];
    qrot(r.bquat + 4 * body, jf, r.axis_w + 3 * j);
    qrot(r.bquat + 4 * body, jf + 3, a);
    for (int d = 0; d < 3; ++d) r.anchor_w[3 * j + d] = r.bpos[3 * body + d] + a[d];
  }
  for (int g = lane; g < NRG; g += 32) {
    const float* gf = p.rg_f + g * RG_F;
    const int body = p.rg_i[g * RG_I];
    float a[3];
    qrot(r.bquat + 4 * body, gf, a);
    for (int d = 0; d < 3; ++d) r.rgp[3 * g + d] = r.bpos[3 * body + d] + a[d];
    qmul(r.bquat + 4 * body, gf + 3, r.rgq + 4 * g);
  }
  __syncwarp();
  // velocity of each hand geom: v at its center, omega
  for (int g = lane; g < NRG; g += 32) {
    float v[3] = {0.f, 0.f, 0.f}, w[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < NJ; ++j) {
      if (p.rg_anc[g * NJ + j] == 0.f) continue;
      const bool hinge = p.jnt_i[j * JNT_I + 1] == HINGE;
      float phi[3];
      joint_phi(r.axis_w + 3 * j, r.anchor_w + 3 * j, hinge, r.rgp + 3 * g, phi);
      for (int d = 0; d < 3; ++d) {
        v[d] += r.qv[j] * phi[d];
        if (hinge) w[d] += r.qv[j] * r.axis_w[3 * j + d];
      }
    }
    for (int d = 0; d < 3; ++d) {
      r.rgv[3 * g + d] = v[d];
      r.rgw[3 * g + d] = w[d];
    }
  }
}

// The squeeze servo of each arm from the hand geoms' deepest engaged
// penetration, then the actuator forces; one warp.
__device__ __forceinline__ void servo_and_actuators(const ArmParams& p, const Robot& r, int b,
                                                    int lane) {
  for (int a = lane; a < p.NARM; a += 32) {
    float pen = -1e9f;
    for (int g = 0; g < p.NRG; ++g)
      if (p.rg_i[g * RG_I + 1] == a) pen = fmaxf(pen, r.rgpen[g]);
    const bool deep = pen > p.squeeze;
    bool closing = false;
    for (int i = 0; i < p.NGRIP; ++i) {
      if (p.grip_i[i * GRIP_I] != a) continue;
      const int row = p.grip_i[i * GRIP_I + 1];
      const int gj = p.grip_i[i * GRIP_I + 2];
      const float cs = p.grip_f[i];
      closing = closing || (cs * (r.ctrl[row] - r.qp[gj]) > 0.f);
      const float held = cs > 0.f ? fminf(r.ctrl[row], r.qp[gj]) : fmaxf(r.ctrl[row], r.qp[gj]);
      r.ctrl_eff[row] = deep ? held : r.ctrl[row];
    }
    r.arm_deepf[a] = (closing && (pen > p.half_squeeze)) ? 1.f : 0.f;
  }
  __syncwarp();
  for (int j = lane; j < p.NJ; j += 32) {
    float t = 0.f;
    for (int i = 0; i < p.NA; ++i) {
      if (p.act_i[i * ACT_I] != j) continue;
      const float* af = p.act_f + i * ACT_F;
      const int kind = p.act_i[i * ACT_I + 1];
      const float cc = fminf(fmaxf(r.ctrl_eff[i], af[1]), af[2]);
      float f;
      if (kind == VELOCITY) {
        f = af[0] * cc;
      } else if (kind == POSITION) {
        f = af[0] * (cc - r.qp[j]);
      } else {
        f = fminf(fmaxf(af[0] * cc, af[3]), af[4]);
      }
      t += f;
    }
    r.tau[j] = t + p.taux[(size_t)b * p.NJ + j];
  }
}

// The contact reaction on the joints p_c = J^T(-lambda) from the force and
// torque each hand geom received, and the joint update with G1, G2, the
// velocity and position limits; one warp.
__device__ __forceinline__ void joint_update(const ArmParams& p, const Robot& r, int lane) {
  const int NJ = p.NJ;
  for (int j = lane; j < NJ; j += 32) {
    float pc = 0.f;
    if (p.couple) {
      const bool hinge = p.jnt_i[j * JNT_I + 1] == HINGE;
      const float* ax = r.axis_w + 3 * j;
      for (int g = 0; g < p.NRG; ++g) {
        if (p.rg_anc[g * NJ + j] == 0.f) continue;
        if (hinge) {
          float d[3] = {r.rgp[3 * g] - r.anchor_w[3 * j], r.rgp[3 * g + 1] - r.anchor_w[3 * j + 1],
                        r.rgp[3 * g + 2] - r.anchor_w[3 * j + 2]};
          float dxF[3];
          cross3(d, r.rgF + 3 * g, dxF);
          pc -= ax[0] * (r.rgT[3 * g] + dxF[0]) + ax[1] * (r.rgT[3 * g + 1] + dxF[1]) +
                ax[2] * (r.rgT[3 * g + 2] + dxF[2]);
        } else {
          pc -= dot3(ax, r.rgF + 3 * g);
        }
      }
      pc = fminf(fmaxf(pc, -p.pc_cap), p.pc_cap);
    }
    const float* jf = p.jnt_f + j * JNT_F;
    r.rhs[j] = r.tau[j] - jf[6] * tanhf(r.qv[j] / 0.01f) + pc / p.dt;
    r.qv_old[j] = r.qv[j];
  }
  __syncwarp();
  for (int j = lane; j < NJ; j += 32) {
    float a1 = 0.f, a2 = 0.f;
    for (int m = 0; m < NJ; ++m) {
      a1 += r.g1[j * NJ + m] * r.qv_old[m];
      a2 += r.g2[j * NJ + m] * r.rhs[m];
    }
    const float* jf = p.jnt_f + j * JNT_F;
    float v = a1 + a2;
    v = fminf(fmaxf(v, -jf[7]), jf[7]);
    const float q_new = r.qp[j] + p.dt * v;
    const float q_cl = fminf(fmaxf(q_new, jf[8]), jf[9]);
    if (q_cl != q_new) v = 0.f;
    r.qp[j] = q_cl;
    r.qv[j] = v;
  }
  __syncwarp();
}

// The group warps' end of a substep: the optional held-velocity clamp on
// groups with a pinched part, then the touch flags are cleared for the next
// substep.
__device__ __forceinline__ void held_clamp(const Block& c, const ArmParams& p, const Robot& r,
                                           bool clear_touch) {
  const int P = c.P;
#pragma unroll 1
  for (int g = c.warp; g < c.ngroups; g += c.nwarps) {
    const int m0 = c.gl_off[g], m1 = c.gl_off[g + 1];
    if (p.held_vel > 0.f) {
      bool pinned = false;
      for (int m = m0 + c.lane; m < m1; m += 32) {
        const int q = c.gl_mem[m];
        for (int a = 0; a < p.NARM; ++a)
          if (r.touch[(2 * a) * P + q] > 0.f && r.touch[(2 * a + 1) * P + q] > 0.f &&
              r.arm_deepf[a] > 0.f)
            pinned = true;
      }
      if (__any_sync(0xffffffffu, pinned)) {
        for (int m = m0 + c.lane; m < m1; m += 32) {
          const int q = c.gl_mem[m];
          float lv[3] = {SP(S_LIN, q), SP(S_LIN + 1, q), SP(S_LIN + 2, q)};
          float av[3] = {SP(S_ANG, q), SP(S_ANG + 1, q), SP(S_ANG + 2, q)};
          const float sl = fminf(1.f, p.held_vel / fmaxf(sqrtf(dot3(lv, lv)), 1e-9f));
          const float sa = fminf(1.f, p.held_angvel / fmaxf(sqrtf(dot3(av, av)), 1e-9f));
          for (int d = 0; d < 3; ++d) {
            SP(S_LIN + d, q) = lv[d] * sl;
            SP(S_ANG + d, q) = av[d] * sa;
          }
        }
      }
    }
    if (clear_touch) {
      for (int m = m0 + c.lane; m < m1; m += 32) {
        const int q = c.gl_mem[m];
        for (int f = 0; f < 2 * p.NARM; ++f) r.touch[f * P + q] = 0.f;
      }
    }
    __syncwarp();
  }
}

// What the arm kernel does beside the first solver pass: after its lane
// half, the deepest engaged penetration of each hand geom (a warp a geom);
// beside its group half, the servo gates and the actuator forces (the robot
// warp).
struct ArmHooks {
  const Block& c;
  const ArmParams& p;
  const Robot& r;
  int b, robot_warp;
  __device__ __forceinline__ void after_first_lane() const {
#pragma unroll 1
    for (int g = c.warp; g < p.NRG; g += c.nwarps) {
      float pen = -1e9f;
      for (int e = p.rg_off[g] + c.lane; e < p.rg_off[g + 1]; e += 32) {
        const int k = p.rg_ent[e];
        if (LN(F_MASK, k) > 0.f) pen = fmaxf(pen, LN(F_DEPTH, k));
      }
      pen = warp_max(pen);
      if (c.lane == 0) r.rgpen[g] = pen;
    }
  }
  __device__ __forceinline__ void beside_first_group() const {
    if (c.warp == robot_warp) servo_and_actuators(p, r, b, c.lane);
  }
};

template <bool SCRATCH>
__global__ void __launch_bounds__(512)
arm_control_step_kernel(ArmParams p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int P = p.P, NB = p.NB, NJ = p.NJ, NA = p.NA, NRG = p.NRG, NARM = p.NARM;
  const int NT = 2 * NARM * P;
  Block c;
  c.P = P;
  c.KS = p.KS;
  c.LPT = p.LPT;
  c.NBS = p.NBS;
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
  c.NSEG = c.nt / SEGW;
  c.sp = smem;
  c.grp = reinterpret_cast<int*>(c.sp + PF * P);
  c.part = reinterpret_cast<float*>(c.grp + group_words(P, c.NSEG, c.NBS));
  float* rs = c.part + NCOL * c.NSEG;
  const RobotLayout ro(P, NB, NJ, NA, NRG, NARM);
  int* tables = reinterpret_cast<int*>(rs + ro.total);
  const TableLayout tl(P, p.Kf, p.Ke, c.KS);
  c.bbuf = SCRATCH ? p.scratch + (size_t)b * (NCOL * c.NBS + NF_ARM * c.KS)
                   : reinterpret_cast<float*>(tables + tl.total);
  c.lanes = c.bbuf + NCOL * c.NBS;
  c.lane_const = p.lane_const;
  c.slot_i = p.slot_i;
  const int tid = c.tid, nt = c.nt;
  const float slop = p.slop;
  // the warp that runs the robot's narrow phases (kinematics, servo, joints)
  const int robot_warp = c.nwarps - 1;

  Robot r;
  r.bpos = rs + ro.bpos;
  r.bquat = rs + ro.bquat;
  r.tpos = rs + ro.tpos;
  r.tquat = rs + ro.tquat;
  r.anc = reinterpret_cast<int*>(rs + ro.anc);
  r.axis_w = rs + ro.axis;
  r.anchor_w = rs + ro.anchor;
  r.qp = rs + ro.qp;
  r.qv = rs + ro.qv;
  r.qv_old = rs + ro.qv_old;
  r.rhs = rs + ro.rhs;
  r.tau = rs + ro.tau;
  r.ctrl = rs + ro.ctrl;
  r.ctrl_eff = rs + ro.ctrl_eff;
  r.g1 = rs + ro.g1;
  r.g2 = rs + ro.g2;
  r.rgp = rs + ro.rgp;
  r.rgq = rs + ro.rgq;
  r.rgv = rs + ro.rgv;
  r.rgw = rs + ro.rgw;
  r.rgpen = rs + ro.rgpen;
  r.rgF = rs + ro.rgF;
  r.rgT = rs + ro.rgT;
  r.arm_deepf = rs + ro.deepf;
  r.touch = rs + ro.touch;
  r.pin = rs + ro.pin;

  stage_tables(c, tables, tl, p.seg_off, p.b_off, p.floor_off, p.floor_slot, p.sat_corner,
               p.Kf, p.Ke, true);
  load_parts(c, b, p.pos, p.quat, p.lin, p.ang, p.group, p.gscale, p.part_const);
  for (int j = tid; j < NJ; j += nt) {
    r.qp[j] = p.qpos[(size_t)b * NJ + j];
    r.qv[j] = p.qvel[(size_t)b * NJ + j];
  }
  for (int i = tid; i < NA; i += nt) {
    r.ctrl[i] = p.ctrl[(size_t)b * NA + i];
    r.ctrl_eff[i] = r.ctrl[i];
  }
  for (int i = tid; i < NJ * NJ; i += nt) {
    r.g1[i] = p.G1[(size_t)b * NJ * NJ + i];
    r.g2[i] = p.G2[(size_t)b * NJ * NJ + i];
  }
  for (int i = tid; i < NT; i += nt) r.touch[i] = 0.f;
  LaneRegs Lz;
  clear_lane(Lz);
  for (int rr = 0; rr < c.LPT; ++rr) store_lambda(c, thread_slot(c, rr), Lz);
  const SlotInfo no_slot = {0, 0, 0};
  const ArmPress press = {r.arm_deepf, p.press_vel};
  const ArmHooks hooks = {c, p, r, b, robot_warp};
  __syncthreads();
  build_group_lists(c, c.grp);
  // phases: 0 joint update, chain and hand geoms beside the held clamp, the
  // part frames and aggregates, 1 narrow phase+prep, 2 first pass (gates,
  // counts, warm start) with the servo gates and actuator forces, 3 group
  // half of the passes, 4 lane half, 5 integration+floor+hand-geom forces
  PhaseClock clk;
  clk.start();

#pragma unroll 1
  for (int s = 0;; ++s) {
    // ---- the robot warp: contact reaction and joint update of the substep
    // before, then this substep's kinematics; the group warps: held clamp,
    // then this substep's frames, aggregates and gravity ----
    const bool more = s < p.n;
    if (c.warp == robot_warp) {
      if (s > 0) joint_update(p, r, c.lane);
      if (more) robot_kinematics(p, r, c.lane);
    }
    if (s > 0) held_clamp(c, p, r, more);
    if (more) group_head(c);
    clk.sync();
    clk.mark(0);
    if (!more) break;

    // ---- narrow phase and solver prep, every lane (the SAT lanes in one
    // warp); touch flags ----
#pragma unroll 1
    for (int rr = 0; rr < c.LPT; ++rr) {
      const int k = thread_slot(c, rr);
      const SlotInfo si = load_slot(c, k);
      const int kind = si.kind();
      if (kind == KIND_PAD || kind == KIND_SAT) continue;
      LaneRegs L;
      float lc[LC], point[3], nrm[3], depth;
      bool fm;
      load_lane_const(c, k, lc);
      const int pa = si.pa();
      if (kind < KIND_ROBOT1) {
        corner_lane_contact(c, kind, pa, si.pb(), lc, point, nrm, &depth, &fm);
        lane_prep(c, pa, si.pb(), point, nrm, depth, fm, lc, L);
        store_lane_prep(c, k, L);
        continue;
      }
      const int g = si.aux0;
      const int finger = si.aux1;
      float qa[4] = {SP(S_QUAT, pa), SP(S_QUAT + 1, pa), SP(S_QUAT + 2, pa), SP(S_QUAT + 3, pa)};
      float xa[3] = {SP(S_POS, pa), SP(S_POS + 1, pa), SP(S_POS + 2, pa)};
      bool inside;
      if (kind == KIND_ROBOT1) {
        // a sample point of the part geom in the robot box; the normal
        // pushes the part out of the robot box
        float rc[3];
        qrot(qa, lc, rc);
        for (int d = 0; d < 3; ++d) point[d] = xa[d] + rc[d];
        point_in_box(point, r.rgp + 3 * g, r.rgq + 4 * g, lc + 3, slop, &depth, nrm, &inside);
      } else {
        // a sample point of the robot geom in the part geom's box; that
        // face normal pushes the robot point out: flipped, it acts on the
        // part
        float rc[3], wq[4], wp[3];
        qrot(r.rgq + 4 * g, lc, rc);
        for (int d = 0; d < 3; ++d) point[d] = r.rgp[3 * g + d] + rc[d];
        qmul(qa, lc + 6, wq);
        qrot(qa, lc + 3, wp);
        for (int d = 0; d < 3; ++d) wp[d] += xa[d];
        point_in_box(point, wp, wq, lc + 10, slop, &depth, nrm, &inside);
        for (int d = 0; d < 3; ++d) nrm[d] = -nrm[d];
      }
      fm = inside && (depth > -slop);
      lane_prep(c, pa, -1, point, nrm, depth, fm, lc, L);
      // robot lanes have no b part: rb keeps the robot surface velocity at
      // the contact point
      float rel[3], wxr[3];
      for (int d = 0; d < 3; ++d) rel[d] = point[d] - r.rgp[3 * g + d];
      cross3(r.rgw + 3 * g, rel, wxr);
      for (int d = 0; d < 3; ++d) L.rb[d] = r.rgv[3 * g + d] + wxr[d];
      store_lane_prep(c, k, L);
      LN(F_DEPTH, k) = depth;
      if (inside && finger >= 0) r.touch[finger * P + pa] = 1.f;
    }
    prepare_sat_lanes(c);
    clk.sync();
    clk.mark(1);

    // ---- the solver passes; the last group pass integrates the parts ----
    solver_passes<SEGW, false, true>(c, Lz, no_slot, press, hooks, clk);

    // ---- force and torque on each hand geom, beside the last group pass
    // (the warps from the top down, the group warps come last) ----
#pragma unroll 1
    for (int g = c.nwarps - 1 - c.warp; g < NRG; g += c.nwarps) {
      float sv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int e = p.rg_off[g] + c.lane; e < p.rg_off[g + 1]; e += 32) {
        const int k = p.rg_ent[e];
        const int pa = pk_part_a(c.slot_pk[k]);
        const float fm = LN(F_MASK, k);
        const float l0 = LN(F_LAM, k), l1 = LN(F_LAM + 1, k), l2 = LN(F_LAM + 2, k);
        float imp[3], rel[3], tq[3];
        for (int d = 0; d < 3; ++d) {
          imp[d] = (l0 * LN(F_N + d, k) + l1 * LN(F_T1 + d, k) + l2 * LN(F_T2 + d, k)) * fm;
          rel[d] = (LN(F_RA + d, k) + SP(S_GCOM + d, pa)) - r.rgp[3 * g + d];
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
          r.rgF[3 * g + d] = sv[d];
          r.rgT[3 * g + d] = sv[3 + d];
        }
      }
    }
    clk.sync();
    clk.mark(5);
  }
  clk.store(p.clocks, b);

  store_parts(c, b, p.pos_out, p.quat_out, p.lin_out, p.ang_out);
  for (int j = tid; j < NJ; j += nt) {
    p.qpos_out[(size_t)b * NJ + j] = r.qp[j];
    p.qvel_out[(size_t)b * NJ + j] = r.qv[j];
  }
  for (int i = tid; i < NT; i += nt) p.touch_out[(size_t)b * NT + i] = r.touch[i] > 0.f ? 1 : 0;
}

}  // namespace

extern "C" {

// layout constants the wrapper sizes and checks its buffers with
int arm_lane_floats() { return NF_ARM; }
int arm_segment_width() { return SEGW; }
int arm_sum_columns() { return NCOL; }
int arm_max_b_entries() { return MAX_B_ENTRIES; }
// words of shared memory a block uses before its b buffer and lane working
// set: part fields, group labels, partial sums, the robot's block, tables
int arm_fixed_words(int P, int NB, int NJ, int NA, int NRG, int NARM, int Kf, int Ke, int KS,
                    int NBS, int threads) {
  return PF * P + group_words(P, threads / SEGW, NBS) + NCOL * (threads / SEGW) +
         RobotLayout(P, NB, NJ, NA, NRG, NARM).total + TableLayout(P, Kf, Ke, KS).total;
}
int arm_lane_const_cols() { return LC; }
int arm_num_ptrs() { return NUM_PTRS; }
int arm_num_ints() { return NUM_INTS; }
int arm_num_floats() { return NUM_FLOATS; }
int arm_num_phases() { return NPHASE; }

// Launches the kernel on `stream`, one block of ints[N_THREADS] threads per
// env. ptrs, ints and floats are host arrays indexed by the enums above.
// ptrs[SCRATCH] null keeps the lane working set and the b buffer in dynamic
// shared memory.
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
  p.lane_const = static_cast<const float4*>(ptrs[T_LANE_CONST]);
  p.slot_i = static_cast<const int4*>(ptrs[T_SLOT_I]);
  p.seg_off = static_cast<const int*>(ptrs[T_SEG_OFF]);
  p.b_off = static_cast<const int*>(ptrs[T_B_OFF]);
  p.floor_off = static_cast<const int*>(ptrs[T_FLOOR_OFF]);
  p.floor_slot = static_cast<const int*>(ptrs[T_FLOOR_SLOT]);
  p.sat_corner = static_cast<const int*>(ptrs[T_SAT_CORNER]);
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
  p.rg_off = static_cast<const int*>(ptrs[T_RG_OFF]);
  p.rg_ent = static_cast<const int*>(ptrs[T_RG_ENT]);
  p.scratch = static_cast<float*>(ptrs[SCRATCH]);
  p.clocks = static_cast<long long*>(ptrs[CLOCKS]);
  p.P = ints[N_P];
  p.KS = ints[N_KS];
  p.LPT = ints[N_LPT];
  p.NBS = ints[N_NBS];
  p.Kf = ints[N_KF];
  p.Ke = ints[N_KE];
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
  if (ints[N_THREADS] != 512 || p.KS != ints[N_THREADS] * p.LPT) return 1;  // invalid value
  void (*kernel)(ArmParams) =
      p.scratch ? arm_control_step_kernel<true> : arm_control_step_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (ints[N_B] > 0) {
    kernel<<<ints[N_B], ints[N_THREADS], smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}

// blocks an SM holds of the kernel
int arm_resident_blocks(int scratch, int threads, int smem_bytes) {
  return scratch ? resident_blocks(arm_control_step_kernel<true>, threads, smem_bytes)
                 : resident_blocks(arm_control_step_kernel<false>, threads, smem_bytes);
}
// `n` bare block barriers in each of `blocks` blocks (see physics_common.cuh)
int arm_barrier_probe(int blocks, int threads, int smem_bytes, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  barrier_probe_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(n);
  return (int)cudaGetLastError();
}

const char* arm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
