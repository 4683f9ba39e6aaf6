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
// arithmetic. On a larger model (chair_balser_0115, K = 4153) each thread
// loops over its lanes and the working set lives field-major in dynamic
// shared memory when it fits the 227 KB opt-in limit, else in a global
// scratch buffer the wrapper allocates: the same code, one pointer, not on
// the main path.

#include "physics_common.cuh"

namespace {

using namespace furniture;

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
  float* scratch;            // [B, NCOL*NBS + NF*KS] or null (all in smem)
  long long* clocks;         // [B, NPHASE] or null (FT_PHASE_CLOCKS builds)
  int P, KS, LPT, NBS, Kf, Ke, n, iters;
  float dt, dtg, slop, relax, maxv;
};

// REGS: one lane per thread (LPT = 1), its working set in registers and the
// rest in shared memory. SCRATCH: the b buffer and the lane working set are in
// the global scratch buffer (else in shared memory: the compiler then knows
// the address space of every access in the passes).
template <bool REGS, bool SCRATCH>
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
  constexpr int nf = REGS ? NF_REGS : NF;
  c.bbuf = SCRATCH ? p.scratch + (size_t)b * (NCOL * c.NBS + nf * c.KS)
                   : reinterpret_cast<float*>(tables + tl.total);   // [NBS * NCOL]
  c.lanes = c.bbuf + NCOL * c.NBS;                      // [nf * KS]
  c.lane_const = p.lane_const;
  c.slot_i = p.slot_i;
  const int rounds = REGS ? 1 : c.LPT;

  stage_tables(c, tables, tl, p.seg_off, p.b_off, p.floor_off, p.floor_slot, p.sat_corner,
               p.Kf, p.Ke, !REGS);
  load_parts(c, b, p.pos, p.quat, p.lin, p.ang, p.group, p.gscale, p.part_const);
  LaneRegs Lr;
  clear_lane(Lr);
  const SlotInfo sr = load_slot(c, thread_slot(c, 0));
  if (!REGS) {
    for (int r = 0; r < rounds; ++r) store_lambda(c, thread_slot(c, r), Lr);
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
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
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

}  // namespace

extern "C" {

// layout constants the wrapper sizes its buffers and tables with
int mega_lane_floats(int regs) { return regs ? NF_REGS : NF; }
int mega_lane_const_cols() { return LC; }
int mega_segment_width() { return SEGW; }
int mega_sum_columns() { return NCOL; }
int mega_num_phases() { return NPHASE; }
int mega_max_b_entries() { return MAX_B_ENTRIES; }
// words of shared memory a block uses before its b buffer and lane working
// set: part fields, group labels and lists, partial sums, static tables
int mega_fixed_words(int P, int Kf, int Ke, int KS, int NBS, int regs, int threads) {
  return PF * P + group_words(P, threads / SEGW, NBS) + NCOL * (threads / SEGW) +
         TableLayout(P, Kf, Ke, regs ? 0 : KS).total;
}

// Launches the kernel on `stream` with one block of `threads` threads per
// env. `regs` selects the one-lane-per-thread kernel (LPT must be 1).
// `scratch` null keeps the lane working set and the b buffer in dynamic
// shared memory. Returns the CUDA error code of the launch (0 on success).
int mega_substeps(const void* pos, const void* quat, const void* lin, const void* ang,
                  const void* group, const void* gscale, void* pos_out, void* quat_out,
                  void* lin_out, void* ang_out, const void* part_const,
                  const void* lane_const, const void* slot_i, const void* seg_off,
                  const void* b_off, const void* floor_off, const void* floor_slot,
                  const void* sat_corner, void* scratch, void* clocks, int B, int P, int KS,
                  int LPT, int NBS, int Kf, int Ke, int n, int iters, float dt, float dtg, float slop,
                  float relax, float maxv, int threads, int smem_bytes, int regs,
                  void* stream) {
  Params p;
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
  p.seg_off = static_cast<const int*>(seg_off);
  p.b_off = static_cast<const int*>(b_off);
  p.floor_off = static_cast<const int*>(floor_off);
  p.floor_slot = static_cast<const int*>(floor_slot);
  p.sat_corner = static_cast<const int*>(sat_corner);
  p.scratch = static_cast<float*>(scratch);
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
  if (threads != 256 || (regs && LPT != 1) || KS != threads * LPT) return 1;  // invalid value
  if (regs && p.scratch) return 1;   // one lane a thread always fits shared memory
  void (*kernel)(Params) = regs ? mega_substeps_kernel<true, false>
                           : p.scratch ? mega_substeps_kernel<false, true>
                                       : mega_substeps_kernel<false, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// blocks an SM holds of the kernel that runs this layout
int mega_resident_blocks(int regs, int scratch, int threads, int smem_bytes) {
  return regs      ? resident_blocks(mega_substeps_kernel<true, false>, threads, smem_bytes)
         : scratch ? resident_blocks(mega_substeps_kernel<false, true>, threads, smem_bytes)
                   : resident_blocks(mega_substeps_kernel<false, false>, threads, smem_bytes);
}
// `n` bare block barriers in each of `blocks` blocks (see physics_common.cuh)
int mega_barrier_probe(int blocks, int threads, int smem_bytes, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  barrier_probe_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(n);
  return (int)cudaGetLastError();
}

const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
