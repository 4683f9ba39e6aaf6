// Free-part physics kernel: n whole substeps per env in one launch.
//
// Replaces furniture_tpu/physics/megakernel.py::MegaPhysics._kernel_body,
// the Pallas TPU kernel of the JAX package. It computes what that kernel
// computes: per substep, group-composite mass properties from the group
// labels, gravity scaled per part, the narrow phase (8 floor-corner lanes
// per geom, 16 vertex-in-box lanes per cross-part geom pair, one SAT edge
// lane per pair that fires only where the pair's 16 corner lanes are empty
// and the groups differ), tangent basis, effective mass, the solref
// Baumgarte bias capped at 0.5 m/s, the mass-split lane scale, a Jacobi
// solve with a friction cone warm-started from the previous substep
// (lambda starts at zero at every launch, capped at 200*inv_w*dt), the
// +-max_velocity clamp, axis-angle integration about the group COM and the
// floor projection by the deepest corner. Where the JAX package's two
// paths differ (engine.py vs megakernel.py: the SAT lane's supporting-edge
// anchor when the face axis wins, the quaternion normalisation inside the
// rotation matrix, the order of the 6 face axes), this kernel follows
// engine.py, which is the plain PyTorch version it is held against.
//
// What bounds it on the H100. The state moved through HBM is 560 B per env
// per launch (300 B in, 260 B out): under 1 us of HBM bandwidth at
// B = 4096. The function's work is ~0.4 MFLOP of FP32 per env per substep
// on table_lack (K = 210 lanes x 13 solver passes dominate): 1.25 ms at the
// card's FP32 peak for n = 50, B = 4096. Neither binds: a launch is 650
// dependent solver passes, each a lane half and a group half with a block
// barrier after each. The bare barriers alone are a floor of ~0.4 ms (27 a
// substep at ~35 ns each with 4 blocks an SM, 8 waves of blocks); what the
// kernel takes beyond that is the dependent instructions between the
// barriers: about half of the SM's issue slots are used, the rest is the
// latency of shared-memory loads and shuffles that 32 resident warps do not
// cover. The group half is a chain of ~10 dependent loads in 5 of 8 warps.
//
// What the design does about that (the shared device code and the layout
// are described in physics_common.cuh): one thread block of 256 threads per
// env runs the whole n-substep loop. On a model whose padded lanes fit one
// per thread (table_lack: 240 slots) a lane's working set stays in the
// registers of its thread from the narrow phase to the last solver pass,
// shared memory holds only the part fields, the lane masks, the b-side
// buffer, the partial sums and the small static tables (~10 KB), and four
// blocks share an SM (64 registers a thread; the 120 bytes it spills lie
// outside the passes) so that one block's barriers hide behind another's
// arithmetic. On a larger model each thread loops over its lanes and the
// working set lives field-major in dynamic shared memory, when it fits the
// 227 KB a block may have.
//
// The cluster route. 14 of the 64 models need more than that
// (chair_balser_0115: 4153 lanes, 24 floats each, and 3961 b-side entries,
// ~640 KB an env). Each of their envs runs on a thread-block cluster of C
// CTAs on neighbouring SMs (C = 2..5, the fewest whose share of the working
// set fits a CTA) whose shared memories hold the whole working set for the
// whole launch: nothing of it goes to device memory. The wrapper lays the
// slots out for a block of C x 512 threads and CTA r takes a contiguous run
// of its segments, with the lanes of those slots and their b-side entries.
// A pass: the lane half works on the CTA's own shared memory; the CTA sums
// its segment partials and b entries in "jobs" of about equal length (one
// octet of threads a job, one column a thread; after the first pass of a
// substep only the entries of lanes in contact, the others being zero) and
// then, one warp a rigid group, the jobs of each group's members, into a
// per-group partial, which it sends into every other CTA's shared memory
// (st.async, counted by that CTA's mbarrier); each CTA waits for the
// partials it reads, adds the C partials of every group in rank order and
// integrates every part itself, so that all CTAs hold the same part state,
// bit for bit, without another exchange. The partials are double-buffered:
// no barrier spans the cluster in a pass (a bare cluster barrier, 0.70 us
// on the H100 at 3 x 512 threads, cost 10% of a launch; an exchange takes
// 0.26 us). A SAT lane's gate reads its 16 corner lanes' masks from
// whichever CTA holds them, behind a cluster barrier at the end of the
// narrow phase. The same sums in a fixed order: a repeated launch gives the
// same bits.

#include <cooperative_groups.h>

#include "physics_common.cuh"

namespace {

using namespace furniture;
namespace cg = cooperative_groups;

// lanes of a warp that share a part: half a warp keeps the padding small on
// small furniture (table_lack: 5 parts x 3 half-warps)
constexpr int SEGW = 16;

struct Params {
  const float* pos;
  const float* quat;
  const float* lin;
  const float* ang;
  const int* group;
  const float* gscale;
  float* pos_out;
  float* quat_out;
  float* lin_out;
  float* ang_out;
  const float* part_const;   // [P,13]: mass, com (3), inertia (9)
  const float4* lane_const;  // [KS,LC]
  const int4* slot_i;        // [KS,SI]
  const int* seg_off;        // [P+1]
  const int* b_off;          // [P+1]
  const int* floor_off;      // [P+1]
  const int* floor_slot;     // [Kf]
  const int* sat_corner;     // [Ke,16]
  long long* clocks;         // [B, NPHASE] or null (FT_PHASE_CLOCKS builds)
  int P, KS, LPT, NBS, Kf, Ke, n, iters;
  float dt, dtg, slop, relax, maxv;
};

// Narrow phase and solver prep of the thread's lanes: with REGS its one lane,
// into Lr (sr its slot); else each of its LPT lanes but the SAT lanes, into
// memory.
template <bool REGS>
__device__ __forceinline__ void narrow_phase(const Block& c, LaneRegs& Lr, const SlotInfo& sr) {
#pragma unroll 1
  for (int r = 0; r < (REGS ? 1 : c.LPT); ++r) {
    const int k = thread_slot(c, r);
    const SlotInfo si = REGS ? sr : load_slot(c, k);
    if (si.kind() == KIND_PAD || (!REGS && si.kind() == KIND_SAT)) continue;
    LaneRegs Lm;
    LaneRegs& L = REGS ? Lr : Lm;
    float lc[LC], point[3], nrm[3], depth;
    bool fm;
    load_lane_const(c, k, lc);
    if (REGS && si.kind() == KIND_SAT) {
      sat_lane_contact(c, si.pa(), si.pb(), lc, point, nrm, &depth, &fm);
    } else {
      corner_lane_contact(c, si.kind(), si.pa(), si.pb(), lc, point, nrm, &depth, &fm);
    }
    lane_prep(c, si.pa(), si.pb(), point, nrm, depth, fm, lc, L);
    if (REGS) {
      LN(F_MASK, k) = L.mask;
    } else {
      store_lane_prep(c, k, L);
    }
  }
}

// REGS: one lane per thread (LPT = 1), its working set in registers and the
// rest in shared memory; else the lane working set and the b buffer are in
// dynamic shared memory.
template <bool REGS>
__global__ void __launch_bounds__(256, REGS ? 4 : 1)
mega_substeps_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  Block c;
  c.P = p.P;
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
  c.sp = smem;                                          // [PF * P]
  c.grp = reinterpret_cast<int*>(c.sp + PF * c.P);      // [group_words]
  c.part = reinterpret_cast<float*>(c.grp + group_words(c.P, c.NSEG, c.NBS));   // [NSEG * NCOL]
  int* tables = reinterpret_cast<int*>(c.part + NCOL * c.NSEG);
  const TableLayout tl(c.P, p.Kf, p.Ke, REGS ? 0 : c.KS);
  c.bbuf = reinterpret_cast<float*>(tables + tl.total);   // [NBS * NCOL]
  c.lanes = c.bbuf + NCOL * c.NBS;                      // [nf * KS]
  c.lane_const = p.lane_const;
  c.slot_i = p.slot_i;

  stage_tables(c, tables, tl, p.seg_off, p.b_off, p.floor_off, p.floor_slot, p.sat_corner,
               p.Kf, p.Ke, !REGS);
  load_parts(c, b, p.pos, p.quat, p.lin, p.ang, p.group, p.gscale, p.part_const);
  LaneRegs Lr;
  clear_lane(Lr);
  const SlotInfo sr = load_slot(c, thread_slot(c, 0));
  if (!REGS) {
    for (int r = 0; r < c.LPT; ++r) store_lambda(c, thread_slot(c, r), Lr);
  }
  const ArmPress no_press = {nullptr, 0.f};
  const NoHooks no_hooks;
  __syncthreads();
  build_group_lists(c, c.grp);
  // phases: 0 frames+aggregates, 1 narrow phase+prep, 2 the first pass
  // (gates+counts+warm start), 3 group half of the passes, 4 lane half,
  // 5 integration+floor
  PhaseClock clk;
  clk.start();

#pragma unroll 1
  for (int s = 0; s < p.n; ++s) {
    // part frames, group aggregates, gravity: the group's warp, straight
    // after its last pass of the substep before
    group_head(c);
    clk.sync();
    clk.mark(0);
    // narrow phase and solver prep, every lane (lanes in memory: the SAT
    // lanes in one warp)
    narrow_phase<REGS>(c, Lr, sr);
    if (!REGS) prepare_sat_lanes(c);
    clk.sync();
    clk.mark(1);
    solver_passes<SEGW, REGS, false>(c, Lr, sr, no_press, no_hooks, clk);
    clk.mark(5);
  }
  __syncthreads();
  clk.store(p.clocks, b);

  store_parts(c, b, p.pos_out, p.quat_out, p.lin_out, p.ang_out);
}

// ---- the cluster route ---------------------------------------------------

// CTAs of an env's cluster (the portable most) and threads a CTA
constexpr int MAX_CLUSTER = 8;
constexpr int CLUSTER_THREADS = 512;
// the phase-clock column that counts the cluster barriers of the substep loop
// (column PHASE_BARRIERS counts the block barriers)
constexpr int PHASE_CLUSTER_BARRIERS = 6;

struct ClusterParams {
  Params p;                  // KS and LPT are a CTA's; slot_i, lane_const the whole env's
  const int* sat_off;        // [C+1] each CTA's range of sat_list
  const int* sat_list;       // [Ke] slots (in their CTA) of the SAT lanes, CTA by CTA
  const int* jobs;           // [C][NJ] a job's entries: first | count << 16
  const int* job_off;        // [C][P+1] each part's range of jobs
  int C, NJ;                 // p.NBS: b entries a CTA (the most of any)
};

// Words of a cluster CTA's shared memory: the part fields, the exchange's
// two mbarriers, the group labels and lists (over the jobs), the
// double-buffered group partials of every CTA of the cluster
// ([2][C][P][NCOL]), the job results and their live entries, the staged
// tables, then the CTA's entries (segment partials, then b entries) and its
// lanes' working set. The wrapper sizes the launch with the same numbers
// (megakernel.py cluster_words).
struct ClusterLayout {
  int bar, grp, pg, jr, live, slot_pk, jobs, job_off, zero, floor_off, floor_cn, part, lanes, total;
  __host__ __device__ ClusterLayout(int P, int Kf, int KS, int NSEG, int NBS, int NJ, int C) {
    int o = PF * P;
    bar = o; o += 4;                     // two mbarriers (8 bytes each), one a partials buffer
    grp = o; o += group_words(P, NJ, 0);
    pg = o; o += 2 * C * NCOL * P;
    jr = o; o += NCOL * NJ;
    live = o; o += NJ;
    slot_pk = o; o += KS;
    jobs = o; o += NJ;
    job_off = o; o += P + 1;
    zero = o; o += P + 1;
    floor_off = o; o += P + 1;
    floor_cn = o; o += 3 * Kf;
    part = o = align4(o); o += NCOL * (NSEG + NBS);
    lanes = o; o += NF * KS;
    total = o;
  }
};

__device__ __forceinline__ void cluster_barrier(PhaseClock& clk) {
  cg::this_cluster().sync();
#ifdef FT_PHASE_CLOCKS
  if (threadIdx.x == 0) ++clk.acc[PHASE_CLUSTER_BARRIERS];
#endif
}

// a SAT lane fires only where its pair's 16 corner lanes are empty: their
// masks, read from the CTA that holds each (sat_corner: rank << 16 | slot),
// behind the cluster barrier that ends the narrow phase
__device__ __forceinline__ void cluster_sat_gate(const Block& c, const cg::cluster_group& cl,
                                                 int pair, LaneRegs& L) {
  float cnt = 0.f;
  for (int j = 0; j < 16; ++j) {
    const int code = __ldg(c.sat_corner + pair * 16 + j);
    cnt += *cl.map_shared_rank(&LN(F_MASK, code & 0xffff), code >> 16);
  }
  if (cnt > 0.f) L.mask = 0.f;
}

// The CTA's entries (segment partials from c.part on, then b entries) summed
// job by job into jr: one octet of threads a job, one column a thread, in a
// fixed order. An entry whose count column is 0 in the first pass (a b side
// or a segment without a lane in contact) holds zeros for the rest of the
// substep: the first pass marks the others in `live` (bit i for entry i of
// a job of at most 32), and the later passes add only those.
__device__ __forceinline__ void sum_jobs(const Block& c, const int* jobs, int njobs, float* jr,
                                         unsigned* live, bool first) {
  const int col = c.tid & (NCOL - 1);
#pragma unroll 1
  for (int j = c.tid / NCOL; j < njobs; j += c.nt / NCOL) {
    const int w = jobs[j], n = w >> 16;
    const float* e = c.part + (w & 0xffff) * NCOL + col;
    if (!first && n <= 32) {
      float s = 0.f;
#pragma unroll 1
      for (unsigned m = live[j]; m; m &= m - 1) s += e[(__ffs(m) - 1) * NCOL];
      jr[j * NCOL + col] = s;
      continue;
    }
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    unsigned bits = 0;
    int i = 0;
#pragma unroll 1
    for (; i + 4 <= n; i += 4) {
      const float v0 = e[i * NCOL], v1 = e[(i + 1) * NCOL], v2 = e[(i + 2) * NCOL],
                  v3 = e[(i + 3) * NCOL];
      s0 += v0;
      s1 += v1;
      s2 += v2;
      s3 += v3;
      bits |= ((unsigned)(v0 != 0.f) | ((unsigned)(v1 != 0.f) << 1) | ((unsigned)(v2 != 0.f) << 2) |
               ((unsigned)(v3 != 0.f) << 3)) << (i & 31);
    }
    for (; i < n; ++i) {
      const float v = e[i * NCOL];
      s0 += v;
      bits |= (unsigned)(v != 0.f) << (i & 31);
    }
    jr[j * NCOL + col] = (s0 + s1) + (s2 + s3);
    if (first && col == 6) live[j] = bits;
  }
}

// The exchange of a pass's group partials. Each CTA writes its partials into
// every other CTA's shared memory with st.async, which counts the bytes on
// that CTA's mbarrier of the buffer (two buffers, two mbarriers, used in
// turn); a CTA's own thread 0 arms the mbarrier with the bytes it expects
// (an arrive, the one it counts), and the group warps wait for the phase to
// complete. No barrier spans the cluster: each CTA waits only for the data
// it reads. A buffer is written again two passes later, by a CTA that has by
// then had this CTA's next partials, sent after it read the buffer.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// thread 0, before a cluster barrier
__device__ __forceinline__ void exchange_init(uint64_t* bar) {
  for (int i = 0; i < 2; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar + i)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void exchange_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// v into CTA `rank`'s copy of *dst, counted on its copy of *bar
__device__ __forceinline__ void exchange_send(float* dst, uint64_t* bar, int rank, float v) {
  unsigned rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rd) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(rd), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}
// until the phase of `parity` completes; a launch whose partials never come
// fails with an error rather than hang
__device__ __forceinline__ void exchange_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (spins > (1u << 24)) __trap();
  }
}

// Each group's share of the CTA's sums, one warp a group: its members' job
// results (gl_ent), lane (chunk, column) taking every fourth, written to its
// place (this CTA's rank) in the group partials of every CTA of the cluster.
__device__ __forceinline__ void group_partials(const Block& c, int C, int rank, const float* jr,
                                               float* out, uint64_t* bar) {
  const int col = c.lane & (NCOL - 1), chunk = c.lane / NCOL;
#pragma unroll 1
  for (int g = c.warp; g < c.ngroups; g += c.nwarps) {
    const int e1 = c.gl_eoff[g + 1];
    float s = 0.f;
#pragma unroll 4
    for (int e = c.gl_eoff[g] + chunk; e < e1; e += 32 / NCOL) s += jr[c.gl_ent[e] + col];
    s += __shfl_xor_sync(0xffffffffu, s, NCOL);
    s += __shfl_xor_sync(0xffffffffu, s, 2 * NCOL);
    float* mine = out + (rank * c.P + g) * NCOL + col;
    for (int r = chunk; r < C; r += 32 / NCOL) {
      if (r == rank) {
        *mine = s;
      } else {
        exchange_send(mine, bar, r, s);
      }
    }
  }
}

// The solver passes of a substep on the cluster route: the lane half as the
// one-block kernel's (solver_passes) on the CTA's own lanes, the CTA's sums
// into per-group partials sent to every CTA (pg, double-buffered; `pass`
// counts the launch's passes), then, once the other CTAs' partials are in,
// every CTA adds the C partials of each group in rank order from its own
// shared memory and runs the group's velocities (and, after the last pass,
// the integration) itself.
__device__ __forceinline__ void cluster_passes(const Block& c, const cg::cluster_group& cl, int C,
                                               int rank, float* pg, float* jr, const int* jobs,
                                               int njobs, unsigned* live, uint64_t* bar,
                                               int& pass, PhaseClock& clk) {
  const int col = c.lane & (NCOL - 1), chunk = c.lane / NCOL;
  const unsigned bytes = (unsigned)((C - 1) * c.ngroups * NCOL * 4);
#pragma unroll 1
  for (int it = 0; it <= c.iters; ++it, ++pass) {
    const bool first = it == 0, last = it == c.iters;
    const int buf = pass & 1;
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int r = 0; r < c.LPT; ++r) {
      const int k = thread_slot(c, r);
      const int pk = c.slot_pk[k];
      const int kind = pk_kind(pk);
      if (kind == KIND_PAD) continue;
      LaneRegs L;
      load_lane(c, k, L);
      const int pa = pk_part_a(pk), pb = pk_part_b(pk);
      if (first) {
        if (kind == KIND_SAT) {
          cluster_sat_gate(c, cl, __ldg(c.slot_i + k).y, L);
          LN(F_MASK, k) = L.mask;
        }
        warm_start_lane(c, L, 200.f);
      } else {
        if (it == 1) {
          scale_lane(c, pa, pb, L);
          for (int d = 0; d < 3; ++d) LN(F_IW + d, k) = L.iw[d];
        }
        update_lane(c, pa, pb, false, L);
      }
      store_lambda(c, k, L);
      // a masked lane adds nothing after the first pass, which left zeros
      // in its b-buffer entry (the mask is fixed for the substep by then)
      if (first || L.mask != 0.f) emit_lane(c, L, pk_b_slot(pk), acc);
    }
    store_segment<SEGW>(c, acc, first);
    clk.sync();
    clk.mark(first ? 2 : 4);
    float* out = pg + buf * C * c.P * NCOL;
    sum_jobs(c, jobs, njobs, jr, live, first);
    clk.sync();
    if (c.tid == 0) exchange_expect(bar + buf, bytes);
    group_partials(c, C, rank, jr, out, bar + buf);
    if (c.warp < c.ngroups) {
      exchange_wait(bar + buf, (unsigned)(pass >> 1) & 1u);
      __syncwarp();
    }
#pragma unroll 1
    for (int g = c.warp; g < c.ngroups; g += c.nwarps) {
      float s = 0.f;
      for (int r = chunk; r < C; r += 32 / NCOL) s += out[(r * c.P + g) * NCOL + col];
      s += __shfl_xor_sync(0xffffffffu, s, NCOL);
      s += __shfl_xor_sync(0xffffffffu, s, 2 * NCOL);
      float sums[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) sums[k] = __shfl_sync(0xffffffffu, s, k);
      group_apply(c, g, sums, first, last);
    }
    if (!last) {
      clk.sync();
      clk.mark(first ? 2 : 3);
    }
  }
}

// One env on a cluster of C CTAs (see the note at the top): CTA r of env b is
// block b * C + r. Every CTA keeps the whole part state; rank 0 writes it out.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
mega_substeps_kernel_cluster(ClusterParams cp) {
  extern __shared__ __align__(16) float smem[];
  const Params& p = cp.p;
  const cg::cluster_group cl = cg::this_cluster();
  const int C = cp.C;
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / C;
  Block c;
  c.P = p.P;
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
  const ClusterLayout lay(c.P, p.Kf, c.KS, c.NSEG, c.NBS, cp.NJ, C);
  int* words = reinterpret_cast<int*>(smem);
  c.sp = smem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  c.grp = words + lay.grp;
  float* pg = smem + lay.pg;
  float* jr = smem + lay.jr;
  unsigned* live = reinterpret_cast<unsigned*>(smem + lay.live);
  c.part = smem + lay.part;                   // [NSEG * NCOL], then the b entries
  c.bbuf = c.part + NCOL * c.NSEG;            // [NBS * NCOL]
  c.lanes = smem + lay.lanes;                 // [NF * KS]
  c.lane_const = p.lane_const + (size_t)rank * c.KS * (LC / 4);
  c.slot_i = p.slot_i + (size_t)rank * c.KS;
  c.sat_corner = p.sat_corner;
  c.Ke = p.Ke;

  // the CTA's tables into shared memory
  for (int i = c.tid; i < c.KS; i += c.nt) words[lay.slot_pk + i] = __ldg(c.slot_i + i).x;
  for (int i = c.tid; i < cp.NJ; i += c.nt) words[lay.jobs + i] = cp.jobs[rank * cp.NJ + i];
  for (int i = c.tid; i < c.P + 1; i += c.nt) {
    words[lay.job_off + i] = cp.job_off[rank * (c.P + 1) + i];
    words[lay.zero + i] = 0;
    words[lay.floor_off + i] = p.floor_off[i];
  }
  float* cn = smem + lay.floor_cn;
  for (int i = c.tid; i < p.Kf; i += c.nt) {
    const float4 row = __ldg(p.lane_const + (size_t)p.floor_slot[i] * (LC / 4));
    cn[3 * i] = row.x;
    cn[3 * i + 1] = row.y;
    cn[3 * i + 2] = row.z;
  }
  for (int i = c.tid; i < NCOL * (c.NSEG + c.NBS); i += c.nt) c.part[i] = 0.f;
  if (c.tid == 0) exchange_init(bar);   // the narrow phase's cluster barrier comes first
  c.slot_pk = words + lay.slot_pk;
  c.floor_off = words + lay.floor_off;
  c.floor_cn = cn;
  const int* jobs = words + lay.jobs;
  const int njobs = cp.job_off[rank * (c.P + 1) + c.P];
  load_parts(c, b, p.pos, p.quat, p.lin, p.ang, p.group, p.gscale, p.part_const);
  LaneRegs Lr;
  clear_lane(Lr);
  for (int r = 0; r < c.LPT; ++r) store_lambda(c, thread_slot(c, r), Lr);
  __syncthreads();
  // the group lists over the jobs (each part's range of them; no b entries):
  // gl_ent lists the job results a group's partial adds up
  c.seg_off = words + lay.job_off;
  c.b_off = words + lay.zero;
  c.part = jr;
  c.NSEG = cp.NJ;
  build_group_lists(c, c.grp);
  c.part = smem + lay.part;
  c.NSEG = c.nt / SEGW;
  const SlotInfo no_slot = {0, 0, 0};
  const int sat0 = cp.sat_off[rank], sat1 = cp.sat_off[rank + 1];
  int pass = 0;
  PhaseClock clk;
  clk.start();

#pragma unroll 1
  for (int s = 0; s < p.n; ++s) {
    group_head(c);
    clk.sync();
    clk.mark(0);
    narrow_phase<false>(c, Lr, no_slot);
    // the CTA's SAT lanes, one a thread from the last thread down
#pragma unroll 1
    for (int i = sat0 + c.nt - 1 - c.tid; i < sat1; i += c.nt) prepare_sat_lane(c, cp.sat_list[i]);
    cluster_barrier(clk);
    clk.mark(1);
    cluster_passes(c, cl, C, rank, pg, jr, jobs, njobs, live, bar, pass, clk);
    clk.mark(5);
  }
  // no CTA leaves while another may still read or write its shared memory
  cluster_barrier(clk);
  if (rank == 0) {
    clk.store(p.clocks, b);
    store_parts(c, b, p.pos_out, p.quat_out, p.lin_out, p.ang_out);
  }
}

// The cluster route's yardsticks, launched with its clusters, block size and
// shared memory: `n` bare cluster barriers (groups = 0), or `n` exchanges of
// `groups` group partials, a pass's exchange and nothing else (groups > 0).
__global__ void cluster_probe_kernel(int n, int groups) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cl = cg::this_cluster();
  if (groups == 0) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) cl.sync();
    return;
  }
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = lane & (NCOL - 1), chunk = lane / NCOL;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* pg = smem + 4;
  if (threadIdx.x == 0) exchange_init(bar);
  cl.sync();
  const unsigned bytes = (unsigned)((C - 1) * groups * NCOL * 4);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    if (threadIdx.x == 0) exchange_expect(bar + buf, bytes);
    if (warp < groups) {
      float* mine = pg + ((buf * C + rank) * groups + warp) * NCOL + col;
      for (int r = chunk; r < C; r += 32 / NCOL) {
        if (r == rank) {
          *mine = (float)i;
        } else {
          exchange_send(mine, bar + buf, r, (float)i);
        }
      }
      exchange_wait(bar + buf, (unsigned)(i >> 1) & 1u);
    }
  }
  cl.sync();
}

cudaLaunchConfig_t cluster_config(int clusters, int C, int threads, int smem_bytes,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// layout constants the wrapper sizes its buffers and tables with
int mega_lane_floats(int regs) { return regs ? NF_REGS : NF; }
int mega_lane_const_cols() { return LC; }
int mega_segment_width() { return SEGW; }
int mega_sum_columns() { return NCOL; }
int mega_part_fields() { return PF; }
int mega_num_phases() { return NPHASE; }
int mega_max_b_entries() { return MAX_B_ENTRIES; }
int mega_max_cluster() { return MAX_CLUSTER; }
int mega_cluster_threads() { return CLUSTER_THREADS; }

static void fill_params(Params& p, const void* pos, const void* quat, const void* lin,
                        const void* ang, const void* group, const void* gscale, void* pos_out,
                        void* quat_out, void* lin_out, void* ang_out, const void* part_const,
                        const void* lane_const, const void* slot_i, const void* floor_off,
                        const void* floor_slot, const void* sat_corner, void* clocks, int P,
                        int KS, int LPT, int NBS, int Kf, int Ke, int n, int iters, float dt,
                        float dtg, float slop, float relax, float maxv) {
  p.pos = static_cast<const float*>(pos);
  p.quat = static_cast<const float*>(quat);
  p.lin = static_cast<const float*>(lin);
  p.ang = static_cast<const float*>(ang);
  p.group = static_cast<const int*>(group);
  p.gscale = static_cast<const float*>(gscale);
  p.pos_out = static_cast<float*>(pos_out);
  p.quat_out = static_cast<float*>(quat_out);
  p.lin_out = static_cast<float*>(lin_out);
  p.ang_out = static_cast<float*>(ang_out);
  p.part_const = static_cast<const float*>(part_const);
  p.lane_const = static_cast<const float4*>(lane_const);
  p.slot_i = static_cast<const int4*>(slot_i);
  p.seg_off = nullptr;
  p.b_off = nullptr;
  p.floor_off = static_cast<const int*>(floor_off);
  p.floor_slot = static_cast<const int*>(floor_slot);
  p.sat_corner = static_cast<const int*>(sat_corner);
  p.clocks = static_cast<long long*>(clocks);
  p.P = P;
  p.KS = KS;
  p.LPT = LPT;
  p.NBS = NBS;
  p.Kf = Kf;
  p.Ke = Ke;
  p.n = n;
  p.iters = iters;
  p.dt = dt;
  p.dtg = dtg;
  p.slop = slop;
  p.relax = relax;
  p.maxv = maxv;
}

// Launches the one-block kernel on `stream` with one block of `threads`
// threads per env, its lane working set and b buffer in dynamic shared
// memory. `regs` selects the one-lane-per-thread kernel (LPT must be 1).
// Refuses a `smem_bytes` below what the layout needs. Returns the CUDA error
// code of the launch (0 on success).
int mega_substeps(const void* pos, const void* quat, const void* lin, const void* ang,
                  const void* group, const void* gscale, void* pos_out, void* quat_out,
                  void* lin_out, void* ang_out, const void* part_const,
                  const void* lane_const, const void* slot_i, const void* seg_off,
                  const void* b_off, const void* floor_off, const void* floor_slot,
                  const void* sat_corner, void* clocks, int B, int P, int KS, int LPT, int NBS,
                  int Kf, int Ke, int n, int iters, float dt, float dtg, float slop, float relax,
                  float maxv, int threads, int smem_bytes, int regs, void* stream) {
  Params p;
  fill_params(p, pos, quat, lin, ang, group, gscale, pos_out, quat_out, lin_out, ang_out,
              part_const, lane_const, slot_i, floor_off, floor_slot, sat_corner, clocks, P, KS,
              LPT, NBS, Kf, Ke, n, iters, dt, dtg, slop, relax, maxv);
  p.seg_off = static_cast<const int*>(seg_off);
  p.b_off = static_cast<const int*>(b_off);
  const int nseg = threads / SEGW;
  const long words = PF * P + group_words(P, nseg, NBS) + NCOL * nseg +
                     TableLayout(P, Kf, Ke, regs ? 0 : KS).total + NCOL * NBS +
                     (long)(regs ? NF_REGS : NF) * KS;
  if (threads != 256 || (regs && LPT != 1) || KS != threads * LPT || 4 * words > smem_bytes)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(Params) = regs ? mega_substeps_kernel<true> : mega_substeps_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launches the cluster route on `stream`: B clusters of C CTAs of `threads`
// threads, KS slots (LPT rounds) and NBS b entries a CTA, NJ jobs a CTA at
// most (see ClusterParams for the tables). Refuses a `smem_bytes` below what
// the layout needs. Returns the CUDA error code of the launch.
int mega_cluster_substeps(const void* pos, const void* quat, const void* lin, const void* ang,
                          const void* group, const void* gscale, void* pos_out, void* quat_out,
                          void* lin_out, void* ang_out, const void* part_const,
                          const void* lane_const, const void* slot_i, const void* floor_off,
                          const void* floor_slot, const void* sat_corner, const void* sat_off,
                          const void* sat_list, const void* jobs, const void* job_off,
                          void* clocks, int B, int P, int KS, int LPT, int Kf, int Ke, int NBS,
                          int NJ, int C, int n, int iters, float dt, float dtg, float slop,
                          float relax, float maxv, int threads, int smem_bytes, void* stream) {
  ClusterParams cp;
  fill_params(cp.p, pos, quat, lin, ang, group, gscale, pos_out, quat_out, lin_out, ang_out,
              part_const, lane_const, slot_i, floor_off, floor_slot, sat_corner, clocks, P, KS,
              LPT, NBS, Kf, Ke, n, iters, dt, dtg, slop, relax, maxv);
  cp.sat_off = static_cast<const int*>(sat_off);
  cp.sat_list = static_cast<const int*>(sat_list);
  cp.jobs = static_cast<const int*>(jobs);
  cp.job_off = static_cast<const int*>(job_off);
  cp.C = C;
  cp.NJ = NJ;
  const ClusterLayout lay(P, Kf, KS, threads / SEGW, NBS, NJ, C);
  if (threads % 32 || threads > CLUSTER_THREADS || KS != threads * LPT || C < 1 ||
      C > MAX_CLUSTER || 4L * lay.total > smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mega_substeps_kernel_cluster,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(B, C, threads, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
    err = cudaLaunchKernelEx(&cfg, mega_substeps_kernel_cluster, cp);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// blocks an SM holds of the one-block kernel that runs this layout
int mega_resident_blocks(int regs, int threads, int smem_bytes) {
  return regs ? resident_blocks(mega_substeps_kernel<true>, threads, smem_bytes)
              : resident_blocks(mega_substeps_kernel<false>, threads, smem_bytes);
}
// clusters of C CTAs the card holds at once on the cluster route (-1 on error)
int mega_cluster_resident(int C, int threads, int smem_bytes) {
  if (cudaFuncSetAttribute(mega_substeps_kernel_cluster,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, C, threads, smem_bytes, 0, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, mega_substeps_kernel_cluster, &cfg) != cudaSuccess)
    return -1;
  return n;
}
// `n` bare block barriers in each of `blocks` blocks (see physics_common.cuh)
int mega_barrier_probe(int blocks, int threads, int smem_bytes, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  barrier_probe_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(n);
  return (int)cudaGetLastError();
}
// `n` bare cluster barriers (groups = 0) or `n` exchanges of `groups` group
// partials in each of `clusters` clusters of C CTAs
int mega_cluster_probe(int clusters, int C, int threads, int smem_bytes, int n, int groups,
                       void* stream) {
  if (groups < 0 || 32 * groups > threads || 4L * (4 + 2 * C * groups * NCOL) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(clusters, C, threads, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, n, groups);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
