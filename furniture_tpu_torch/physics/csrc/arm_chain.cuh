// The articulated chain on the card: the vector and quaternion helpers and
// the one-body step of the forward kinematics, shared by the joint-dynamics
// kernel (arm_dynamics.cu) and the IK kernel (arm_ik.cu), so that the port
// has one FK on the card. Each follows robots/kinematics.py::fk and
// transforms.py in its order of operations, in FP32, in the arithmetic its
// caller picks (Fused or Eager).

#pragma once

#include <cuda_runtime.h>

namespace arm_chain {

constexpr int HINGE = 0;     // joint type (robots/chain.py); 1 is a slide

// The arithmetic a chain is computed in. Fused: plain operators, which the
// compiler may contract into fused multiply-adds (the joint-dynamics
// kernel). Eager: every operation rounded apart, as PyTorch's eager ops
// round once a kernel, and a cross product's terms as ATen's cross kernel
// rounds them (the IK kernel, which repeats its plain version on the card
// bit for bit).
struct Fused {
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  // a b - c d
  static __device__ __forceinline__ float det2(float a, float b, float c, float d) {
    return a * b - c * d;
  }
};

struct Eager {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float det2(float a, float b, float c, float d) {
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
  }
};

template <class Ar = Fused>
__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = Ar::det2(a[1], b[2], a[2], b[1]);
  o[1] = Ar::det2(a[2], b[0], a[0], b[2]);
  o[2] = Ar::det2(a[0], b[1], a[1], b[0]);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// R v = v + 2 (w (u x v) + u x (u x v)), q = (w, u) (transforms.quat_rotate)
template <class Ar = Fused>
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  const float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3<Ar>(u, v, uv);
  cross3<Ar>(u, uv, uuv);
  for (int k = 0; k < 3; ++k)
    o[k] = Ar::add(v[k], Ar::mul(2.f, Ar::add(Ar::mul(q[0], uv[k]), uuv[k])));
}

// Hamilton product a b in wxyz (transforms.quat_mul)
template <class Ar = Fused>
__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = Ar::sub(Ar::sub(Ar::sub(Ar::mul(a[0], b[0]), Ar::mul(a[1], b[1])), Ar::mul(a[2], b[2])),
                 Ar::mul(a[3], b[3]));
  o[1] = Ar::sub(Ar::add(Ar::add(Ar::mul(a[0], b[1]), Ar::mul(a[1], b[0])), Ar::mul(a[2], b[3])),
                 Ar::mul(a[3], b[2]));
  o[2] = Ar::add(Ar::add(Ar::sub(Ar::mul(a[0], b[2]), Ar::mul(a[1], b[3])), Ar::mul(a[2], b[0])),
                 Ar::mul(a[3], b[1]));
  o[3] = Ar::add(Ar::sub(Ar::add(Ar::mul(a[0], b[3]), Ar::mul(a[1], b[2])), Ar::mul(a[2], b[1])),
                 Ar::mul(a[3], b[0]));
}

// The Jacobian column of joint j at world point p: axis x (p - anchor) for
// a hinge, the axis for a slide.
template <class Ar = Fused>
__device__ __forceinline__ void jac_col(const float* axis, const float* anchor, bool hinge,
                                        const float* p, float* o) {
  if (hinge) {
    const float d[3] = {Ar::sub(p[0], anchor[0]), Ar::sub(p[1], anchor[1]),
                        Ar::sub(p[2], anchor[2])};
    cross3<Ar>(axis, d, o);
  } else {
    o[0] = axis[0];
    o[1] = axis[1];
    o[2] = axis[2];
  }
}

// A hinge's rotation at joint position qj about its unit axis u
// (transforms.quat_from_axis_angle): (cos(qj/2), sin(qj/2) u).
template <class Ar = Fused>
__device__ __forceinline__ void hinge_quat(float qj, const float* u, float* qr) {
  const float half = Ar::mul(qj, 0.5f);
  const float s = sinf(half);
  qr[0] = cosf(half);
  qr[1] = Ar::mul(s, u[0]);
  qr[2] = Ar::mul(s, u[1]);
  qr[3] = Ar::mul(s, u[2]);
}

// One body of the chain: its parent's pose (pp_in, pq_in; not read for a
// body of the world, `root`) composed with its local pose, then its joint's
// motion (a hinge rotates about its anchor, a slide moves along its axis).
// `fb`: the body's local pos (3) and quat (4); `jtype`: its joint's type,
// -1 without one; `jf`: the joint's axis (3) and anchor (3) in the body
// frame; `qj`: the joint's position; `qr`: a hinge's rotation (hinge_quat),
// or null to form it here from qj and fb's unit joint axis (fb + 7).
// Writes the body's world pose (wp, wq). The parent's and the joint's
// pointers are valid whatever the body: a pointer that may be null makes the
// loads through it generic.
template <class Ar = Fused>
__device__ __forceinline__ void chain_body(const float* fb, bool root, const float* pp_in,
                                           const float* pq_in, int jtype, const float* jf, float qj,
                                           const float* qr, float* wp, float* wq) {
  float pp[3], pq[4];
  if (root) {
    for (int k = 0; k < 3; ++k) pp[k] = fb[k];
    for (int k = 0; k < 4; ++k) pq[k] = fb[3 + k];
  } else {
    float r[3];
    qrot<Ar>(pq_in, fb, r);
    for (int k = 0; k < 3; ++k) pp[k] = Ar::add(pp_in[k], r[k]);
    qmul<Ar>(pq_in, fb + 3, pq);
  }
  if (jtype < 0) {
    for (int k = 0; k < 3; ++k) wp[k] = pp[k];
    for (int k = 0; k < 4; ++k) wq[k] = pq[k];
  } else if (jtype == HINGE) {
    float own[4];
    if (qr == nullptr) {
      hinge_quat<Ar>(qj, fb + 7, own);
      qr = own;
    }
    qmul<Ar>(pq, qr, wq);
    const float* jp = jf + 3;
    float r1[3], r2[3];
    qrot<Ar>(pq, jp, r1);
    qrot<Ar>(wq, jp, r2);
    for (int k = 0; k < 3; ++k) wp[k] = Ar::sub(Ar::add(pp[k], r1[k]), r2[k]);
  } else {
    float r[3];
    qrot<Ar>(pq, jf, r);
    for (int k = 0; k < 3; ++k) wp[k] = Ar::add(pp[k], Ar::mul(r[k], qj));
    for (int k = 0; k < 4; ++k) wq[k] = pq[k];
  }
}

}  // namespace arm_chain
