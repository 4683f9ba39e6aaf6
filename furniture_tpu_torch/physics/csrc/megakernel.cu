// Free-part physics kernel: n whole substeps per env in one launch.
//
// Replaces furniture_tpu/physics/megakernel.py::MegaPhysics._kernel_body,
// the Pallas TPU kernel of the JAX package. It computes what that kernel
// computes: per substep, group-composite mass properties from the [P,P]
// membership, gravity scaled per part, the narrow phase (8 floor-corner
// lanes per geom, 16 vertex-in-box lanes per cross-part geom pair, one SAT
// edge lane per pair that fires only where the pair's 16 corner lanes are
// empty and the groups differ), tangent basis, effective mass, the solref
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
// per launch (300 B in, 260 B out): about 2.3 MB at B = 4096, under 1 us of
// HBM bandwidth. The work is ~0.3-0.4 MFLOP of FP32 per env per substep on
// table_lack (K = 210 lanes x 13 solver sweeps dominate), i.e. tens of
// GFLOP per launch at B = 4096, n = 50. So the bound is FP32 arithmetic on
// the CUDA cores plus the latency of the ~32 block barriers per substep,
// not memory.
//
// What the design does about that bound: one thread block per env runs the
// whole n-substep loop, so the state, the group aggregates and (when it
// fits) the per-lane working set stay in shared memory for the launch; the
// lanes are spread over the block's threads; the per-part reductions of
// each Jacobi sweep go one warp per part over a static lane list, summed in
// a fixed order (per-thread strides, then warp shuffles, then the group's
// parts in index order), so results do not change from run to run. The
// working set (~24 floats per lane) lives in dynamic shared memory when it
// fits the 227 KB opt-in limit, else in a global scratch buffer the
// wrapper allocates; one pointer serves both.

#include "physics_common.cuh"

// The device code of a substep (narrow phase, solver prep, Jacobi sweeps,
// integration, floor projection) lives in physics_common.cuh, shared with
// the arm kernel (arm_megakernel.cu); this file is the free-part kernel's
// parameters, its phase sequence and its C interface.

namespace {

using namespace furniture;

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
  const float* lane_const;   // [K,LC]
  const int* lane_part;      // [K,2]: part_a, part_b (-1: floor)
  const int* part_off;       // [P+1] offsets into part_ent
  const int* part_nfloor;    // [P] floor lanes at the head of each list
  const int* part_ent;       // [E] (lane << 1) | side (0: a, 1: b)
  float* scratch;            // [B, NF*K] or null (working set in smem)
  int P, Kf, Kp, Ke, n, iters;
  float dt, dtg, slop, relax, maxv;
};

__global__ void __launch_bounds__(256)
mega_substeps_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  Block c;
  c.P = p.P;
  c.Kf = p.Kf;
  c.Kp = p.Kp;
  c.Ke = p.Ke;
  c.K = p.Kf + p.Kp + p.Ke;
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
  c.sp = smem;                                          // [PF * P]
  c.grp = reinterpret_cast<int*>(c.sp + PF * c.P);      // [P]
  c.lanes = p.scratch ? p.scratch + (size_t)b * NF * c.K
                      : reinterpret_cast<float*>(c.grp + c.P);
  c.lane_const = p.lane_const;
  c.lane_part = p.lane_part;
  c.part_off = p.part_off;
  c.part_nfloor = p.part_nfloor;
  c.part_ent = p.part_ent;

  load_parts(c, b, p.pos, p.quat, p.lin, p.ang, p.group, p.gscale, p.part_const);
  __syncthreads();

  for (int s = 0; s < p.n; ++s) {
    part_frames(c);
    __syncthreads();
    group_aggregates(c);
    __syncthreads();
    // narrow phase and solver prep, every lane
    for (int k = c.tid; k < c.K; k += c.nt) {
      float point[3], nrm[3], depth;
      bool fm;
      base_lane_contact(c, k, point, nrm, &depth, &fm);
      lane_prep(c, k, point, nrm, depth, fm);
    }
    __syncthreads();
    sat_gate(c);
    __syncthreads();
    count_active(c);
    __syncthreads();
    for (int k = c.tid; k < c.K; k += c.nt) warm_start_lane(c, k, 200.f);
    __syncthreads();
    jacobi_integrate<false>(c);
    floor_lift(c);
    __syncthreads();
  }

  store_parts(c, b, p.pos_out, p.quat_out, p.lin_out, p.ang_out);
}

}  // namespace

extern "C" {

// layout constants the wrapper sizes its buffers with
int mega_lane_floats() { return NF; }
int mega_part_floats() { return PF; }
int mega_lane_const_cols() { return LC; }

// Launches the kernel on `stream` with one block of `threads` threads per
// env. `scratch` null keeps the lane working set in dynamic shared memory.
// Returns the CUDA error code of the launch (0 on success).
int mega_substeps(const void* pos, const void* quat, const void* lin, const void* ang,
                  const void* group, const void* gscale, void* pos_out, void* quat_out,
                  void* lin_out, void* ang_out, const void* part_const,
                  const void* lane_const, const void* lane_part, const void* part_off,
                  const void* part_nfloor, const void* part_ent, void* scratch, int B,
                  int P, int Kf, int Kp, int Ke, int n, int iters, float dt, float dtg,
                  float slop, float relax, float maxv, int threads, int smem_bytes,
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
  p.lane_const = static_cast<const float*>(lane_const);
  p.lane_part = static_cast<const int*>(lane_part);
  p.part_off = static_cast<const int*>(part_off);
  p.part_nfloor = static_cast<const int*>(part_nfloor);
  p.part_ent = static_cast<const int*>(part_ent);
  p.scratch = static_cast<float*>(scratch);
  p.P = P;
  p.Kf = Kf;
  p.Kp = Kp;
  p.Ke = Ke;
  p.n = n;
  p.iters = iters;
  p.dt = dt;
  p.dtg = dtg;
  p.slop = slop;
  p.relax = relax;
  p.maxv = maxv;
  cudaError_t err = cudaFuncSetAttribute(
      mega_substeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    mega_substeps_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
