// Lane contact solver: the whole lane solve in one launch, from the raw
// contacts to the parts' velocities.
//
// Replaces furniture_tpu/physics/pallas_solver.py::solve_contacts_pallas
// with its Pallas TPU kernel _kernel. It computes what
// lane_solver.plain_solve_contacts_lane (engine.lane_prep, then the sweeps)
// computes: per lane the fmask (mask & depth > -slop), the lever arms r_a,
// r_b from the group COMs, the branch-free tangent basis (|n_z| < 0.9), the
// effective masses (floored at 1e-8), the Baumgarte bias capped at 0.5 m/s
// and the mass-split lane scale relaxation / max(n_a, n_b, 1), the counts
// taken per rigid group in integers; then `iters` cold-started Jacobi
// sweeps, each applying the masked increment (lambda_new - lambda) * fmask
// to every part of both sides' groups, the velocities updated sweep by
// sweep. A lane whose sides lie in one group adds its impulse and its
// negation (the linear parts cancel) and both torques, as the plain version
// does. Kinematic lanes (a prescribed b-side velocity vel_b) fold vel_b's
// three projections into per-lane offsets.
//
// What bounds it on the H100. The function needs every lane's mask (1 B),
// the depth of a lane whose mask is set (4 B) and the point and normal of a
// lane with a contact (24 B; 12 more with vel_b), the part tensors (80 B a
// part in, 24 B out): 6,610 B an env on table_lack (K = 210, P = 5) with
// every lane in contact, 0.008 ms of HBM at B = 4096. The work is, for each
// lane with a contact, the preparation (~240 FP32 operations with a side b,
// once) and 12 sweeps of ~120: 331,130 an env with every lane in contact,
// 0.020 ms at the FP32 peak at B = 4096, where the operations bind; a
// resting state (~20 lanes in contact an env) needs about a tenth of both
// (lane_solver.fp32_ops_per_env, bytes_per_env). The kernel is bound by
// latency: 12 dependent sweeps, each a lane half and a group half with a
// block barrier between them, in blocks of one env.
//
// What the design does about that:
//   * one thread block per env; the preparation is done once, in registers,
//     from the raw inputs, which are loaded beside the part tensors before
//     the first barrier (nothing is staged through device memory, and no
//     PyTorch runs around the launch); a lane reads its mask first and the
//     rest only where the mask is set;
//   * slots: the wrapper sorts the lanes by their a-side part once per
//     model (megakernel.slot_tables) so that the lanes of a segment share
//     that part; a segment folds its lanes' impulses and torques into one
//     partial by warp shuffles (7 shuffles for 16 lanes);
//   * b sides: the lanes of an octet (8 consecutive slots, a round of 8
//     threads) whose b sides are all on one part (a block of 8 vertex
//     lanes of one geom pair) fold theirs into one b entry the same way; the
//     other lanes with a side b (SAT lanes) write an entry each. The entries
//     are ordered by b-side part: 30 on table_lack, not 170;
//   * groups: warp 0 lists the rigid groups of the launch with warp votes
//     (labels matched, first member, rank) and, for each group, the
//     partials and b entries its members own, before the first barrier.
//     In every sweep one warp sums five groups at once (six lanes a group,
//     one column each, over the group's list in a fixed order) and each
//     part's lane takes its group's sums by shuffle: a welded group is
//     summed once, the group half is O(K + K_b) and not O(P K), and a
//     table_lack block runs it in one warp. No float atomics (the counts
//     are integer shared-memory atomics), so a repeated launch gives the
//     same bits;
//   * a lane without contact (fmask 0) adds nothing in any sweep: the
//     partials and b entries are zeroed once; on the register route the
//     segments with a lane in contact move after the preparation (through a
//     shared stage, before the barrier that is there anyway, the order
//     within a segment kept) to the first segments of the block, so a
//     resting table_lack sweeps 5 segments in 3 warps, not 5; a warp with
//     no lane in contact skips the lane half of every sweep, one with no
//     contact on a part of side b its b entries;
//   * with at most 256 lanes (table_lack: 210 lanes in 240 slots) a lane's
//     constants (n, t1, r_a, r_b, inv_w x scale, three offsets, friction,
//     lambda, its part indices: 23 registers) stay in registers for the
//     launch, one lane a thread in blocks of 256 (ROUTE_REGS: 64 registers,
//     4 blocks an SM; two lanes a thread in blocks of 128 timed the same,
//     PERF.md); above that (56 of the 64 furniture: chair_balser_0115,
//     K = 4153; 6376 at most) each thread loops over its rounds of slots and the prepared
//     lanes and the b entries live in a global scratch buffer
//     (ROUTE_MEMORY, a kernel instance of its own);
//   * 2 x iters + 1 block barriers a launch: after the loads, after the
//     preparation and counts, and two per sweep but the last.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Route { ROUTE_REGS = 0, ROUTE_MEMORY = 1 };

constexpr int THREADS = 256;     // threads of a block, both routes

constexpr int NSEG = 16;         // segments of a block (16 slots each)
constexpr int NCOL = 8;          // a partial or b entry: impulse (3), torque (3), 2 pad
constexpr int MAX_ROUNDS = 64;   // rounds a thread of the memory route makes
constexpr int MAX_PARTS = 32;    // parts of a model: one lane of warp 0 each
constexpr int MAX_ENTRIES = 32766;   // b entries: 15 bits of a lane's code
constexpr unsigned FULL = 0xffffffffu;

// per-part shared fields, part-major sp[p * PF + f]: the velocities lead a
// 16-byte row (one float4 and one float2 load)
enum PartField { S_LV = 0, S_AV = 3, S_IM = 6, S_COM = 8, S_II = 12, PF = 24 };

// prepared lane in the scratch buffer (memory route), field-major:
// lanes[f * KS + slot]
enum LaneField {
  F_N = 0, F_T1 = 3, F_RA = 6, F_RB = 9, F_IW = 12, F_OFF = 15, F_FRIC = 18, F_LAM = 19,
  F_CODE = 22, NF = 23
};

// Phase clocks: a build with -DFT_PHASE_CLOCKS has thread 0 of each block
// add up the card's clock between the launch's barriers per phase into a
// [B, NPHASE] output; its last column counts the block barriers passed.
// The timed and checked kernel is the build without the define.
constexpr int NPHASE = 5;   // loads, preparation+counts, lane half, group half, barriers
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
    if (threadIdx.x == 0) ++acc[NPHASE - 1];
  }
  __device__ __forceinline__ void end() { __syncthreads(); }
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
  __device__ __forceinline__ void end() {}
  __device__ __forceinline__ void store(long long*, int) const {}
};
#endif

// A prepared lane staged in shared memory on its way to the thread that
// sweeps it (register route), field-major stage[f * REG_SLOTS + slot]: n,
// t1, r_a, r_b, inv_w, the offsets, friction, the code, both group keys
// (lambda starts at zero).
enum StageField {
  T_N = 0, T_T1 = 3, T_RA = 6, T_RB = 9, T_IW = 12, T_OFF = 15, T_FRIC = 18, T_CODE = 19,
  T_GA = 20, T_GB = 21, NSTAGE = 22
};
constexpr int REG_SLOTS = THREADS;   // slots of the register route's block

// Shared memory of a block, in 4-byte words (16-byte aligned pieces). The
// b entries follow the partials on the register route (one word space for
// the group lists); the memory route keeps them in its scratch buffer.
__host__ __device__ __forceinline__ int align4(int w) { return (w + 3) & ~3; }
struct SmemLayout {
  int sp, part, bbuf, stage, first, gidx, gcnt, eoff, ngroups, segmask, ent, total;
  // regs: the register route (b entries and the lane staging in shared memory)
  __host__ __device__ SmemLayout(int P, int nbe, bool regs) {
    int o = 0;
    sp = o; o += PF * P;
    part = o; o += NCOL * NSEG;
    bbuf = o; o += regs ? NCOL * nbe : 0;
    stage = o; o += regs ? NSTAGE * REG_SLOTS : 0;
    first = o; o += P;
    gidx = o; o += P;
    gcnt = o; o += P;
    eoff = o; o += P + 1;
    ngroups = o; o += 1;
    segmask = o; o += 1;
    ent = o; o += NSEG + nbe;
    total = align4(o);
  }
};

struct Params {
  const float* point;         // [B,K,3]
  const float* normal;        // [B,K,3]
  const float* depth;         // [B,K]
  const uint8_t* mask;        // [B,K] bool
  const float* vel_b;         // [B,K,3] or null (zero)
  const int4* slot_i;         // [KS] lane (-1: padding), part a, part b (-1), b entry word
  const float2* slot_f;       // [KS] friction, beta
  const int* seg_off;         // [P+1] each part's range of segments
  const int* b_off;           // [P+1] each part's range of b entries
  const int* group;           // [B,P]
  const float* g_com;         // [B,P,3]
  const float* g_inv_mass;    // [B,P]
  const float* g_inv_inertia; // [B,P,9] row-major
  const float* lin;           // [B,P,3]
  const float* ang;           // [B,P,3]
  float* lin_out;             // [B,P,3]
  float* ang_out;             // [B,P,3]
  float* scratch;             // [B, NF*KS + NCOL*NBE] (memory route) or null
  long long* clocks;          // [B, NPHASE] or null (FT_PHASE_CLOCKS builds)
  int P, K, KS, LPT, NBE, iters;
  float dt, relax, slop;
};

// A slot's b entry word (slot_i.w): -1 none; else the entry, with bit 30
// set where the slot's octet folds its b sides into that one entry.
constexpr int ENTRY_FOLDED = 1 << 30;

// A lane's registers: what a sweep reads and writes. `code` packs the a-side
// part (8 bits), the b-side part + 1 (8 bits), the octet-fold flag (1 bit)
// and the b entry + 1 (15 bits). A lane without contact is all zeros but
// its code: it adds nothing.
struct Lane {
  float n[3], t1[3], ra[3], rb[3], iw[3], off[3], fric, lam[3];
  unsigned code;
};
__device__ __forceinline__ int code_pa(unsigned c) { return (int)(c & 0xffu); }
__device__ __forceinline__ int code_pb(unsigned c) { return (int)((c >> 8) & 0xffu) - 1; }
__device__ __forceinline__ bool code_folded(unsigned c) { return (c >> 16) & 1u; }
__device__ __forceinline__ int code_entry(unsigned c) { return (int)(c >> 17) - 1; }

// a lane that adds nothing: on part 0, no side b, no b entry
__device__ __forceinline__ void empty_lane(Lane& L) {
  for (int d = 0; d < 3; ++d) L.n[d] = L.t1[d] = L.ra[d] = L.rb[d] = L.iw[d] = L.off[d] = L.lam[d] = 0.f;
  L.fric = 0.f;
  L.code = 0u;
}

// the raw inputs of a lane, as loaded
struct Raw {
  float pt[3], n[3], vb[3], depth;
  bool live;   // a real lane with its mask set (the depth test comes later)
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void load_raw(const Params& p, int b, int k, Raw& r) {
  r.live = false;
  r.depth = 0.f;
  for (int d = 0; d < 3; ++d) r.pt[d] = r.n[d] = r.vb[d] = 0.f;
  if (k < 0) return;
  const size_t o = (size_t)b * p.K + k;
  r.live = p.mask[o] != 0;
  if (!r.live) return;   // a masked-out lane needs nothing else
  r.depth = p.depth[o];
  for (int d = 0; d < 3; ++d) {
    r.pt[d] = p.point[o * 3 + d];
    r.n[d] = p.normal[o * 3 + d];
    if (p.vel_b) r.vb[d] = p.vel_b[o * 3 + d];
  }
}

// Preparation of the lane of slot (si, sf) with inputs r (engine.lane_prep)
// into L; returns whether it has a contact (fmask).
__device__ __forceinline__ bool prep_lane(const Params& p, const float* sp, int4 si, float2 sf,
                                          const Raw& r, Lane& L) {
  const int pa = si.y, pb = si.z, w = si.w;
  const unsigned folded = (w >= 0 && (w & ENTRY_FOLDED)) ? 1u : 0u;
  const int entry = w >= 0 ? (w & (ENTRY_FOLDED - 1)) : -1;
  empty_lane(L);
  L.code = (unsigned)pa | ((unsigned)(pb + 1) << 8) | (folded << 16) |
           ((unsigned)(entry + 1) << 17);
  if (!(r.live && r.depth > -p.slop)) return false;
  const float* n = r.n;
  const float* ca = sp + pa * PF;
  for (int d = 0; d < 3; ++d) {
    L.n[d] = n[d];
    L.ra[d] = r.pt[d] - ca[S_COM + d];
  }
  float im = ca[S_IM];
  if (pb >= 0) {
    const float* cb = sp + pb * PF;
    for (int d = 0; d < 3; ++d) L.rb[d] = r.pt[d] - cb[S_COM + d];
    im += cb[S_IM];
  }
  // tangent basis: t1 = unit(n x ref), ref = z unless |n_z| >= 0.9, then x
  const bool use_z = fabsf(n[2]) < 0.9f;
  const float ref[3] = {use_z ? 0.f : 1.f, 0.f, use_z ? 1.f : 0.f};
  float t1[3], t2[3];
  cross3(n, ref, t1);
  const float len = sqrtf(dot3(t1, t1) + 1e-24f);
  for (int d = 0; d < 3; ++d) t1[d] = t1[d] / len;
  cross3(n, t1, t2);
  for (int d = 0; d < 3; ++d) L.t1[d] = t1[d];
  // effective mass along each direction: inv masses + (r x d) . I^-1 (r x d)
  const float* dirs[3] = {n, t1, t2};
  for (int j = 0; j < 3; ++j) {
    float wj = im;
    float x[3];
    cross3(L.ra, dirs[j], x);
    float q = 0.f;
    for (int i = 0; i < 3; ++i)
      q += x[i] * (ca[S_II + i * 3] * x[0] + ca[S_II + i * 3 + 1] * x[1] + ca[S_II + i * 3 + 2] * x[2]);
    wj += q;
    if (pb >= 0) {
      const float* cb = sp + pb * PF;
      cross3(L.rb, dirs[j], x);
      q = 0.f;
      for (int i = 0; i < 3; ++i)
        q += x[i] * (cb[S_II + i * 3] * x[0] + cb[S_II + i * 3 + 1] * x[1] + cb[S_II + i * 3 + 2] * x[2]);
      wj += q;
    }
    L.iw[j] = 1.f / fmaxf(wj, 1e-8f);
  }
  // Baumgarte bias; a prescribed b-side velocity enters as its projections
  L.off[0] = -fminf((sf.y / p.dt) * fmaxf(r.depth - p.slop, 0.f), 0.5f);
  if (p.vel_b) {
    L.off[0] -= dot3(r.vb, n);
    L.off[1] = -dot3(r.vb, t1);
    L.off[2] = -dot3(r.vb, t2);
  }
  L.fric = sf.x;
  return true;
}

// Preparation of one slot and its share of the counts: one integer atomic
// per side on the count of the side's group (keyed by its first part).
// Gives the group keys (-1: no contact, or no side b).
__device__ __forceinline__ void prep_count(const Params& p, const float* sp, const int* first,
                                           int* gcnt, int4 s, float2 f, const Raw& r, Lane& L,
                                           int& ga, int& gb) {
  ga = gb = -1;
  if (prep_lane(p, sp, s, f, r, L)) {
    ga = first[s.y];
    atomicAdd(gcnt + ga, 1);
    if (s.z >= 0) {
      gb = first[s.z];
      atomicAdd(gcnt + gb, 1);
    }
  }
}

// the lane scale from the group counts of both sides, into inv_w
__device__ __forceinline__ void scale_lane(const int* gcnt, int fa, int fb, float relax, Lane& L) {
  const int na = gcnt[fa];
  const int nb = fb >= 0 ? gcnt[fb] : 0;
  const float sc = relax / fmaxf((float)max(na, nb), 1.f);
  for (int d = 0; d < 3; ++d) L.iw[d] *= sc;
}

// the velocities of part q: a 16-byte and an 8-byte load
__device__ __forceinline__ void load_vel(const float* sp, int q, float* lv, float* av) {
  const float4 a = *reinterpret_cast<const float4*>(sp + q * PF);
  const float2 c = *reinterpret_cast<const float2*>(sp + q * PF + 4);
  lv[0] = a.x;
  lv[1] = a.y;
  lv[2] = a.z;
  av[0] = a.w;
  av[1] = c.x;
  av[2] = c.y;
}

// One sweep of one lane: the Jacobi update of lambda from the velocities,
// the increment's impulse and a-side torque added to acc; its b side
// (impulse negated, r_b x -imp; zero without a side b) into bv.
__device__ __forceinline__ void sweep_lane(const float* sp, Lane& L, float* acc, float* bv) {
  const int pa = code_pa(L.code), pb = code_pb(L.code);
  float lv[3], av[3], c[3], vr[3];
  load_vel(sp, pa, lv, av);
  cross3(av, L.ra, c);
  for (int d = 0; d < 3; ++d) vr[d] = lv[d] + c[d];
  if (pb >= 0) {
    load_vel(sp, pb, lv, av);
    cross3(av, L.rb, c);
    for (int d = 0; d < 3; ++d) vr[d] -= lv[d] + c[d];
  }
  float t2[3];
  cross3(L.n, L.t1, t2);
  const float l0 = L.lam[0] - (dot3(vr, L.n) + L.off[0]) * L.iw[0];
  const float l1 = L.lam[1] - (dot3(vr, L.t1) + L.off[1]) * L.iw[1];
  const float l2 = L.lam[2] - (dot3(vr, t2) + L.off[2]) * L.iw[2];
  const float ln = fmaxf(l0, 0.f);
  const float mf = L.fric * ln;
  const float n1 = fminf(fmaxf(l1, -mf), mf);
  const float n2 = fminf(fmaxf(l2, -mf), mf);
  const float d0 = ln - L.lam[0], d1 = n1 - L.lam[1], d2 = n2 - L.lam[2];
  L.lam[0] = ln;
  L.lam[1] = n1;
  L.lam[2] = n2;
  float imp[3], tq[3];
  for (int d = 0; d < 3; ++d) imp[d] = d0 * L.n[d] + d1 * L.t1[d] + d2 * t2[d];
  cross3(L.ra, imp, tq);
  for (int d = 0; d < 3; ++d) {
    acc[d] += imp[d];
    acc[3 + d] += tq[d];
  }
  if (pb >= 0) {
    for (int d = 0; d < 3; ++d) bv[d] = -imp[d];
    cross3(L.rb, bv, tq);
    for (int d = 0; d < 3; ++d) bv[3 + d] = tq[d];
  } else {
    for (int d = 0; d < 6; ++d) bv[d] = 0.f;
  }
}

// Six sums over a group of W consecutive lanes of the warp (a segment of 16
// or an octet of 8), by shuffles in a fixed order, the columns folded as
// they are reduced: the upper half keeps columns 3..5 and the lower 0..2,
// each handing the other three over; then the three are split two and one,
// then the two: 7 shuffles for 16 lanes or 8. Returns the column whose
// whole sum this lane holds in v, -1 if none (a copy of kernels 1 and 2's
// store_segment, without their count column).
template <int W>
__device__ __forceinline__ int fold6(const float* acc, int lane, float& v) {
  static_assert(W == 8 || W == 16, "fold width");
  constexpr int M1 = W / 2, M2 = W / 4, M3 = W / 8;
  const bool h1 = (lane & M1) != 0, h2 = (lane & M2) != 0, h3 = (lane & M3) != 0;
  const bool writer = (lane & (M3 - 1)) == 0 && !(h2 && h3);
  const int column = (h1 ? 3 : 0) + (h2 ? 2 : (h3 ? 1 : 0));
  float k0 = h1 ? acc[3] : acc[0], k1 = h1 ? acc[4] : acc[1], k2 = h1 ? acc[5] : acc[2];
  k0 += __shfl_xor_sync(FULL, h1 ? acc[0] : acc[3], M1);
  k1 += __shfl_xor_sync(FULL, h1 ? acc[1] : acc[4], M1);
  k2 += __shfl_xor_sync(FULL, h1 ? acc[2] : acc[5], M1);
  const float r0 = __shfl_xor_sync(FULL, h2 ? k0 : k2, M2);
  const float r1 = __shfl_xor_sync(FULL, k1, M2);
  const float u0 = (h2 ? k2 : k0) + r0;
  const float u1 = k1 + r1;
  const bool second = !h2 && h3;
  v = (second ? u1 : u0) + __shfl_xor_sync(FULL, (h2 || h3) ? u0 : u1, M3);
#pragma unroll
  for (int m = M3 / 2; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return writer ? column : -1;
}

// A lane's b side into the b buffer: folded over its octet where the warp
// has folded octets (`fold`, warp-uniform; the lanes of unfolded octets take
// part in the shuffles and write their own entries), else its own entry.
__device__ __forceinline__ void emit_b(float* bbuf, unsigned code, const float* bv, bool fold,
                                       int lane) {
  const int e = code_entry(code);
  const bool folded = code_folded(code);
  if (fold) {
    float v;
    const int col = fold6<8>(bv, lane, v);
    if (folded && col >= 0) bbuf[(size_t)e * NCOL + col] = v;
  }
  if (!folded && e >= 0) {
    float4* q = reinterpret_cast<float4*>(bbuf + (size_t)e * NCOL);
    q[0] = make_float4(bv[0], bv[1], bv[2], bv[3]);
    q[1] = make_float4(bv[4], bv[5], 0.f, 0.f);
  }
}

// memory route: a prepared lane to and from the scratch buffer
__device__ __forceinline__ void store_lane(float* lanes, int KS, int k, const Lane& L) {
  for (int d = 0; d < 3; ++d) {
    lanes[(F_N + d) * KS + k] = L.n[d];
    lanes[(F_T1 + d) * KS + k] = L.t1[d];
    lanes[(F_RA + d) * KS + k] = L.ra[d];
    lanes[(F_RB + d) * KS + k] = L.rb[d];
    lanes[(F_IW + d) * KS + k] = L.iw[d];
    lanes[(F_OFF + d) * KS + k] = L.off[d];
    lanes[(F_LAM + d) * KS + k] = L.lam[d];
  }
  lanes[F_FRIC * KS + k] = L.fric;
  lanes[F_CODE * KS + k] = __uint_as_float(L.code);
}
__device__ __forceinline__ void load_lane(const float* lanes, int KS, int k, Lane& L) {
  for (int d = 0; d < 3; ++d) {
    L.n[d] = lanes[(F_N + d) * KS + k];
    L.t1[d] = lanes[(F_T1 + d) * KS + k];
    L.ra[d] = lanes[(F_RA + d) * KS + k];
    L.rb[d] = lanes[(F_RB + d) * KS + k];
    L.iw[d] = lanes[(F_IW + d) * KS + k];
    L.off[d] = lanes[(F_OFF + d) * KS + k];
    L.lam[d] = lanes[(F_LAM + d) * KS + k];
  }
  L.fric = lanes[F_FRIC * KS + k];
  L.code = __float_as_uint(lanes[F_CODE * KS + k]);
}

// register route: a prepared lane and its group keys to and from the stage
__device__ __forceinline__ void stage_lane(float* st, int k, const Lane& L, int ga, int gb) {
  for (int d = 0; d < 3; ++d) {
    st[(T_N + d) * REG_SLOTS + k] = L.n[d];
    st[(T_T1 + d) * REG_SLOTS + k] = L.t1[d];
    st[(T_RA + d) * REG_SLOTS + k] = L.ra[d];
    st[(T_RB + d) * REG_SLOTS + k] = L.rb[d];
    st[(T_IW + d) * REG_SLOTS + k] = L.iw[d];
    st[(T_OFF + d) * REG_SLOTS + k] = L.off[d];
  }
  st[T_FRIC * REG_SLOTS + k] = L.fric;
  st[T_CODE * REG_SLOTS + k] = __uint_as_float(L.code);
  st[T_GA * REG_SLOTS + k] = __int_as_float(ga);
  st[T_GB * REG_SLOTS + k] = __int_as_float(gb);
}
__device__ __forceinline__ void unstage_lane(const float* st, int k, Lane& L, int& ga, int& gb) {
  for (int d = 0; d < 3; ++d) {
    L.n[d] = st[(T_N + d) * REG_SLOTS + k];
    L.t1[d] = st[(T_T1 + d) * REG_SLOTS + k];
    L.ra[d] = st[(T_RA + d) * REG_SLOTS + k];
    L.rb[d] = st[(T_RB + d) * REG_SLOTS + k];
    L.iw[d] = st[(T_IW + d) * REG_SLOTS + k];
    L.off[d] = st[(T_OFF + d) * REG_SLOTS + k];
    L.lam[d] = 0.f;
  }
  L.fric = st[T_FRIC * REG_SLOTS + k];
  L.code = __float_as_uint(st[T_CODE * REG_SLOTS + k]);
  ga = __float_as_int(st[T_GA * REG_SLOTS + k]);
  gb = __float_as_int(st[T_GB * REG_SLOTS + k]);
}

// the position of the n-th (from 0) set bit of mask
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
#pragma unroll 1
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1u) {
      if (n == 0) return i;
      --n;
    }
  return -1;
}

// The group half of a sweep: one warp sums five rigid groups at once. Lane
// (group, column) of the warp (six columns, lanes 30 and 31 idle) adds its
// column over the group's list of partials and b entries, in order; then
// lane q, for part q of one of those groups, takes its group's six sums by
// shuffle and gives the part its velocity (its velocities and inverse mass
// and inertia loaded during the sums), written out by `last`. A table_lack
// block sums its five groups in one warp.
constexpr int GPW = 5;    // groups a warp sums
constexpr int GCOLS = 6;  // columns a group's lanes sum
template <bool MEM>
__device__ __forceinline__ void group_half(const Params& p, float* sp, const float* part,
                                           const float* bbuf, const int* gidx, const int* eoff,
                                           const int* ent, int ngroups, int b, int warp,
                                           int nwarps, int lane, bool last) {
  const int P = p.P;
  const int gi = lane / GCOLS, col = lane - gi * GCOLS;
  constexpr int B_FIRST = NSEG * NCOL;   // words of the partials before the b entries
  auto value = [&](int w) {
    if (MEM) return w < B_FIRST ? part[w + col] : bbuf[(size_t)(w - B_FIRST) + col];
    return part[w + col];   // the b entries follow the partials in shared memory
  };
#pragma unroll 1
  for (int g0 = warp * GPW; g0 < ngroups; g0 += nwarps * GPW) {
    const int gq = lane < P ? gidx[lane] - g0 : -1;   // this lane's part's group in the batch
    const bool member = gq >= 0 && gq < GPW;
    float* f = sp + lane * PF;
    float im = 0.f, ii[9], lv[3], av[3];
    if (member) {
      im = f[S_IM];
      for (int d = 0; d < 9; ++d) ii[d] = f[S_II + d];
      load_vel(sp, lane, lv, av);
    }
    float s = 0.f;
    const int g = g0 + gi;
    if (gi < GPW && g < ngroups) {
      const int e1 = eoff[g + 1];
#pragma unroll 4
      for (int e = eoff[g]; e < e1; ++e) s += value(ent[e]);
    }
    float acc[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k] = __shfl_sync(FULL, s, (member ? gq : 0) * GCOLS + k);
    if (member) {
      for (int d = 0; d < 3; ++d) {
        lv[d] += acc[d] * im;
        av[d] += ii[d * 3] * acc[3] + ii[d * 3 + 1] * acc[4] + ii[d * 3 + 2] * acc[5];
      }
      if (last) {
        const size_t o = ((size_t)b * P + lane) * 3;
        for (int d = 0; d < 3; ++d) {
          p.lin_out[o + d] = lv[d];
          p.ang_out[o + d] = av[d];
        }
      } else {
        *reinterpret_cast<float4*>(f) = make_float4(lv[0], lv[1], lv[2], av[0]);
        *reinterpret_cast<float2*>(f + 4) = make_float2(av[1], av[2]);
      }
    }
  }
}

// Warp 0, before the first barrier: the rigid groups of this env from the
// labels (lane q for part q: parts with one label are matched by a warp
// vote, a group is named by its first part and numbered in the order of
// those; gidx gives each part its group's number), each group's entries (its members' partials and b entries,
// members ascending, as word offsets: partial a at a * NCOL, b entry x at
// (NSEG + x) * NCOL) with their ranges eoff, and the zeroed counts.
__device__ __forceinline__ void group_lists(const Params& p, int b, int lane, int* first,
                                            int* gidx, int* gcnt, int* eoff, int* ngroups,
                                            int* ent) {
  const int P = p.P;
  const bool has = lane < P;
  const int label = has ? p.group[(size_t)b * P + lane] : 0;
  const unsigned valid = P >= 32 ? FULL : ((1u << P) - 1u);
  const unsigned peers = __match_any_sync(FULL, label) & valid;
  const int f = has ? __ffs(peers) - 1 : 0;
  const bool lead = has && f == lane;
  const unsigned leads = __ballot_sync(FULL, lead);
  const int g = __popc(leads & ((1u << f) - 1u));   // f < 32
  const int so0 = has ? p.seg_off[lane] : 0, so1 = has ? p.seg_off[lane + 1] : 0;
  const int bo0 = has ? p.b_off[lane] : 0, bo1 = has ? p.b_off[lane + 1] : 0;
  const int cnt = (so1 - so0) + (bo1 - bo0);
  // this part's place in the list: after the groups before its own and its
  // group's members before it
  int off = 0;
#pragma unroll 1
  for (int j = 0; j < P; ++j) {
    const int cj = __shfl_sync(FULL, cnt, j);
    const int gj = __shfl_sync(FULL, g, j);
    if (gj < g || (gj == g && j < lane)) off += cj;
  }
  const int total = (int)__reduce_add_sync(FULL, (unsigned)cnt);
  if (has) {
    first[lane] = f;
    gidx[lane] = g;
    gcnt[lane] = 0;
    int e = off;
    for (int a = so0; a < so1; ++a) ent[e++] = a * NCOL;
    for (int x = bo0; x < bo1; ++x) ent[e++] = (NSEG + x) * NCOL;
  }
  if (lead) eoff[g] = off;
  if (lane == 0) {
    const int n = __popc(leads);
    eoff[n] = total;
    *ngroups = n;
  }
}

// MEM false: a thread keeps its one lane in registers; MEM true: the lanes
// and the b buffer live in the global scratch buffer and a thread makes
// p.LPT rounds over them. A thread's slots all lie in one segment: round r
// of thread (warp, lane) is slot (warp * rounds + r) * 32 + lane, and the
// 8 threads of an octet make consecutive slots.
template <bool MEM>
__device__ __forceinline__ void lane_solve_block(const Params& p) {
  constexpr int SEGW = THREADS / NSEG;
  constexpr int NWARPS = THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int P = p.P, KS = p.KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const SmemLayout sl(P, p.NBE, !MEM);
  float* sp = smem + sl.sp;
  float* part = smem + sl.part;
  int* words = reinterpret_cast<int*>(smem);
  int* first = words + sl.first;
  int* gidx = words + sl.gidx;
  int* gcnt = words + sl.gcnt;
  int* eoff = words + sl.eoff;
  int* ent = words + sl.ent;
  unsigned* segmask = reinterpret_cast<unsigned*>(words + sl.segmask);
  float* stage = smem + sl.stage;
  float* lanes = MEM ? p.scratch + (size_t)b * ((size_t)NF * KS + (size_t)NCOL * p.NBE) : nullptr;
  float* bbuf = MEM ? lanes + (size_t)NF * KS : smem + sl.bbuf;
  PhaseClock clk;
  clk.start();

  // -- loads: the part tensors, the group lists (warp 0), zeroed sums, and
  // (register route) the thread's slot and raw lane inputs
  for (int i = tid; i < P; i += THREADS) {
    const size_t o = (size_t)b * P + i;
    float* f = sp + i * PF;
    for (int d = 0; d < 3; ++d) {
      f[S_LV + d] = p.lin[o * 3 + d];
      f[S_AV + d] = p.ang[o * 3 + d];
      f[S_COM + d] = p.g_com[o * 3 + d];
    }
    f[S_IM] = p.g_inv_mass[o];
    for (int d = 0; d < 9; ++d) f[S_II + d] = p.g_inv_inertia[o * 9 + d];
  }
  if (warp == 0) group_lists(p, b, lane, first, gidx, gcnt, eoff, words + sl.ngroups, ent);
  if (tid == 0) *segmask = 0u;
  for (int i = tid; i < NCOL * NSEG; i += THREADS) part[i] = 0.f;
  for (int i = tid; i < NCOL * p.NBE; i += THREADS) bbuf[i] = 0.f;
  int4 si;
  float2 sf;
  Raw raw;
  if constexpr (!MEM) {
    si = __ldg(p.slot_i + tid);
    sf = __ldg(p.slot_f + tid);
    load_raw(p, b, si.x, raw);
  }
  clk.sync();
  clk.mark(0);

  // -- preparation and the lanes in contact counted per rigid group;
  // register route: the segments with a lane in contact marked, the
  // prepared lanes staged
  const int seg = warp * (32 / SEGW) + lane / SEGW;   // the thread's segment
  Lane L;
  int fa, fb;
  bool warp_busy = false;           // some lane of the warp has a contact
  bool warp_bbusy = false;          // ... a contact with a part on side b
  bool warp_fold = false;           // some octet of the warp folds its b sides
  unsigned long long busy = 0;      // memory route: rounds in which some lane has a contact,
  unsigned long long bbusy = 0;     // ... one with a part on side b,
  unsigned long long fold = 0;      // ... a folded octet
  if constexpr (!MEM) {
    prep_count(p, sp, first, gcnt, si, sf, raw, L, fa, fb);
    stage_lane(stage, tid, L, fa, fb);
    if (fa >= 0) atomicOr(segmask, 1u << seg);
  } else {
#pragma unroll 1
    for (int r = 0; r < p.LPT; ++r) {
      const int k = (warp * p.LPT + r) * 32 + lane;
      const int4 s = __ldg(p.slot_i + k);
      Raw rw;
      load_raw(p, b, s.x, rw);
      Lane Lm;
      int ga, gb;
      prep_count(p, sp, first, gcnt, s, __ldg(p.slot_f + k), rw, Lm, ga, gb);
      if (__any_sync(FULL, ga >= 0)) busy |= 1ull << r;
      if (__any_sync(FULL, gb >= 0)) bbusy |= 1ull << r;
      if (__any_sync(FULL, code_folded(Lm.code))) fold |= 1ull << r;
      // the group keys ride in lambda's place until the scale is set
      Lm.lam[0] = __int_as_float(ga);
      Lm.lam[1] = __int_as_float(gb);
      store_lane(lanes, KS, k, Lm);
    }
    warp_busy = busy != 0;
  }
  clk.sync();
  clk.mark(1);

  // -- register route: the segments with a lane in contact move, lanes and
  // order within the segment kept, to the first segments of the block (a
  // resting table_lack has 5 of 16, in 3 warps instead of 5); then the lane
  // scale, then the sweeps
  const int ngroups = words[sl.ngroups];
  int hosted = -1;   // register route: the segment this thread sweeps, -1 none
  if constexpr (!MEM) {
    const unsigned busy_segs = *segmask;
    if (seg < __popc(busy_segs)) hosted = nth_bit(busy_segs, seg);
    if (hosted >= 0) {
      unstage_lane(stage, hosted * SEGW + lane % SEGW, L, fa, fb);
    } else {
      empty_lane(L);
      fa = fb = -1;
    }
    if (fa >= 0) scale_lane(gcnt, fa, fb, p.relax, L);
    warp_busy = __any_sync(FULL, hosted >= 0);
    warp_bbusy = __any_sync(FULL, fb >= 0);
    warp_fold = __any_sync(FULL, code_folded(L.code));
  } else {
#pragma unroll 1
    for (int r = 0; r < p.LPT; ++r) {
      if (!((busy >> r) & 1ull)) continue;
      const int k = (warp * p.LPT + r) * 32 + lane;
      const int ga = __float_as_int(lanes[F_LAM * KS + k]);
      const int gb = __float_as_int(lanes[(F_LAM + 1) * KS + k]);
      if (ga >= 0) {
        const float sc = p.relax / fmaxf((float)max(gcnt[ga], gb >= 0 ? gcnt[gb] : 0), 1.f);
        for (int d = 0; d < 3; ++d) lanes[(F_IW + d) * KS + k] *= sc;
      }
      for (int d = 0; d < 3; ++d) lanes[(F_LAM + d) * KS + k] = 0.f;
    }
  }
  if (p.iters == 0) {
    for (int i = tid; i < P; i += THREADS) {
      const size_t o = ((size_t)b * P + i) * 3;
      for (int d = 0; d < 3; ++d) {
        p.lin_out[o + d] = sp[i * PF + S_LV + d];
        p.ang_out[o + d] = sp[i * PF + S_AV + d];
      }
    }
  }
#pragma unroll 1
  for (int it = 0; it < p.iters; ++it) {
    // lane half: a warp without a contact adds nothing in any sweep
    if (warp_busy) {
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float bv[6];
      if constexpr (!MEM) {
        sweep_lane(sp, L, acc, bv);
        // b entries of a warp without a b-side contact stay zero
        if (warp_bbusy) emit_b(bbuf, L.code, bv, warp_fold, lane);
      } else {
#pragma unroll 1
        for (int r = 0; r < p.LPT; ++r) {
          if (!((busy >> r) & 1ull)) continue;
          const int k = (warp * p.LPT + r) * 32 + lane;
          Lane Lm;
          load_lane(lanes, KS, k, Lm);
          sweep_lane(sp, Lm, acc, bv);
          if ((bbusy >> r) & 1ull) emit_b(bbuf, Lm.code, bv, (fold >> r) & 1ull, lane);
          for (int d = 0; d < 3; ++d) lanes[(F_LAM + d) * KS + k] = Lm.lam[d];
        }
      }
      float v;
      const int col = fold6<SEGW>(acc, lane, v);
      const int mine_seg = MEM ? seg : hosted;
      if (col >= 0 && mine_seg >= 0) part[NCOL * mine_seg + col] = v;
    }
    clk.sync();
    clk.mark(2);
    const bool last = it == p.iters - 1;
    if (warp * GPW < ngroups)
      group_half<MEM>(p, sp, part, bbuf, gidx, eoff, ent, ngroups, b, warp, NWARPS, lane, last);
    if (!last) clk.sync();
    clk.mark(3);
  }
  clk.end();
  clk.store(p.clocks, b);
}

template <bool MEM>
__global__ void __launch_bounds__(THREADS, MEM ? 2 : 4)
lane_solve_kernel(Params p) {
  lane_solve_block<MEM>(p);
}

__global__ void barrier_probe_kernel(int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) __syncthreads();
}

typedef void (*KernelFn)(Params);

KernelFn route_kernel(int route) {
  switch (route) {
    case ROUTE_REGS: return lane_solve_kernel<false>;
    case ROUTE_MEMORY: return lane_solve_kernel<true>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int lane_num_phases() { return NPHASE; }
int lane_segments() { return NSEG; }
int lane_max_rounds() { return MAX_ROUNDS; }
int lane_max_parts() { return MAX_PARTS; }
int lane_max_entries() { return MAX_ENTRIES; }
int lane_threads() { return THREADS; }
// dynamic shared bytes of a block
int lane_smem_bytes(int P, int NBE, int route) {
  return 4 * SmemLayout(P, NBE, route != ROUTE_MEMORY).total;
}
// floats of an env's scratch buffer (memory route; 0 otherwise)
int lane_scratch_floats(int KS, int NBE, int route) {
  return route == ROUTE_MEMORY ? NF * KS + NCOL * NBE : 0;
}

// Launches the solve on `stream`, one block per env. Returns the CUDA error
// code of the launch (0 on success); 1 (invalid value) for a layout the
// route does not take.
int lane_solve(const void* point, const void* normal, const void* depth, const void* mask,
               const void* vel_b, const void* slot_i, const void* slot_f, const void* seg_off,
               const void* b_off, const void* group, const void* g_com, const void* g_inv_mass,
               const void* g_inv_inertia, const void* lin, const void* ang, void* lin_out,
               void* ang_out, void* scratch, void* clocks, int B, int P, int K, int KS, int LPT,
               int NBE, int iters, int route, float dt, float relax, float slop, void* stream) {
  KernelFn kernel = route_kernel(route);
  if (!kernel || P < 1 || P > MAX_PARTS || NBE < 0 || NBE > MAX_ENTRIES || iters < 0) return 1;
  if (route == ROUTE_MEMORY ? (scratch == nullptr || LPT < 1 || LPT > MAX_ROUNDS)
                            : (scratch != nullptr || LPT != 1))
    return 1;
  if (KS != THREADS * LPT) return 1;
  Params p;
  p.point = static_cast<const float*>(point);
  p.normal = static_cast<const float*>(normal);
  p.depth = static_cast<const float*>(depth);
  p.mask = static_cast<const uint8_t*>(mask);
  p.vel_b = static_cast<const float*>(vel_b);
  p.slot_i = static_cast<const int4*>(slot_i);
  p.slot_f = static_cast<const float2*>(slot_f);
  p.seg_off = static_cast<const int*>(seg_off);
  p.b_off = static_cast<const int*>(b_off);
  p.group = static_cast<const int*>(group);
  p.g_com = static_cast<const float*>(g_com);
  p.g_inv_mass = static_cast<const float*>(g_inv_mass);
  p.g_inv_inertia = static_cast<const float*>(g_inv_inertia);
  p.lin = static_cast<const float*>(lin);
  p.ang = static_cast<const float*>(ang);
  p.lin_out = static_cast<float*>(lin_out);
  p.ang_out = static_cast<float*>(ang_out);
  p.scratch = static_cast<float*>(scratch);
  p.clocks = static_cast<long long*>(clocks);
  p.P = P;
  p.K = K;
  p.KS = KS;
  p.LPT = LPT;
  p.NBE = NBE;
  p.iters = iters;
  p.dt = dt;
  p.relax = relax;
  p.slop = slop;
  const int smem = lane_smem_bytes(P, NBE, route);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// blocks of the route's kernel an SM holds at this shared memory
int lane_resident_blocks(int route, int smem_bytes) {
  KernelFn kernel = route_kernel(route);
  if (!kernel) return -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
      cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem_bytes) !=
      cudaSuccess)
    return -1;
  return n;
}

// `n` bare block barriers in each of `blocks` blocks of the kernel's size
int lane_barrier_probe(int blocks, int smem_bytes, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  barrier_probe_kernel<<<blocks, THREADS, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(n);
  return (int)cudaGetLastError();
}

const char* lane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
