// Whole-substep kernels for Hopper (sm_90a): K3 and K2, one warp per env
// (substep_warp.cuh), in both frames.
//
// Included by two translation units, each its own library: csrc/substep.cu
// (JT_RAND false, the nominal instantiations) and csrc/substep_rand.cu
// (JT_RAND true, the randomized ones); both export the same entry points,
// so nvcc builds the two halves at once (csrc/substep_stages.cu, a third,
// is the nominal half counting K2's stages, for measurement alone).
//
// Replaces: jiminy_tpu/ops/substep_kernel.py
//   K2 `substep_batched_pallas_multi` → `_substep_multi_body` (n_sub
//      substeps of an env step in one launch, τ recomputed in-kernel
//      from the held command), and
//   K3 `substep_batched_pallas` → `_substep_body` (one substep, τ given),
// both reached through `_lane_kernel_call` → `pl.pallas_call`, in the
// flagship configuration: flat ground, euler_symplectic, FREE and
// REVOLUTE joints, joint bounds and bare-point ground contacts as PGS
// rows, a (6,) local wrench on the root body, declarative PD or direct
// motor command through the motor model (K2). K2 also carries the
// sensor stage (`_sensor_stage`, with `SensorKernelSpec` and the
// quaternion helpers `_quat_from_m_lane`, `_quat_exp_lane`,
// `_quat_mul_lane`; see `jt_sensor_measure` below). Both take, beside flat
// ground, an analytic ground per env (`_ground_query` and the
// general-ground branch of `_substep_math`; see `jt_ground_query` below):
// the `GEN` instantiations. With model randomization (`_unpack_mp`,
// `SubstepSpec.randomized` and `_compute_tau`'s `mscale`; the `RAND`
// instantiations), each env's row of packed model parameters replaces
// the baked masses, first moments and inertias in RNEA and CRBA, the
// armature on M's diagonal and, in K2's torque, the motor reduction and
// friction (see `jt_load_inertial` below). Closed loops
// (`SubstepSpec.dist_constraints` and the distance rows of `_substep_math`)
// are equality rows ahead of the bounds, and 1-DoF joint springs (the
// spring branch of `_compute_tau` and the dt²·k, dt·k·v terms of
// `_substep_math`) integrate implicitly; both are runtime branches on the
// packed header, uniform across the warp, so a model without them runs
// zero-trip loops (see `jt_distance_row` below). Declared collision pairs
// (`SubstepSpec.pair_gens`, the pair block of `_substep_math` with
// `emit_pair_contact` and `_seg_seg_lane`) add one [t1, t2, n] block per
// pair contact after the ground contacts, and sphere contact sites touch
// at centre − r·n̂ (the site offset of `_substep_math`); both are runtime
// branches on the header too (see `jt_pair_contact` below). SPHERICAL
// joints (spherical flexibility, B.8: a quaternion of 4 and ω local of 3)
// take the branches of `_lane_joint_motion`, `_lane_fk`, the RNEA bias,
// `dof_cols` and the quaternion integrate (`subspace_col`,
// `joint_motion_of`, `jt_joint_transform`, `jt_quat_step`), and a sprung
// one the spring branch of `_compute_tau`, −k·log(quat) (`jt_quat_log`,
// atan2f where the TPU kernel had a polynomial), in `jt_spring_tau`. PRISMATIC
// joints (B.10: a scalar q along the axis) take those functions' PRISMATIC
// branches: S = [0; axis], X_J = (I, axis·q), the RNEA bias and every
// Jacobian column through `subspace_col`, and REVOLUTE's scalar integrate,
// −k·q spring and bound row. Joint types are runtime branches on the
// packed spec as well, and each site names every type it serves.
//
// One substep (`jt_warp_substep` in substep_warp.cuh, the counterpart of
// `_substep_math`) is, per env: FK → RNEA bias with the root wrench → CRBA
// + armature + dt·damping (+ dt²·stiffness) → distance rows, bounds rows
// and contact rows color-major (flat basis t1 = (0,−1,0), t2 = (1,0,0),
// n = e_z, or with GEN the basis of the ground's normal at each contact;
// Baumgarte / velocity-barrier targets) → pair contact rows (each pair its
// own PGS color) → the chain (solve_chain.cuh `jt_warp_chain`) → world
// impulses in the original contact order → symplectic Euler with the
// quaternion exponential. The arithmetic follows the plain version
// (jiminy_tpu_torch/ops/substep_kernel.py `substep_reference`, i.e. the
// engine's own plain physics) step for step.
//
// What bounds it on an H100 (ANYmal: nb 13, nv 18, nc 24, 8 sweeps,
// 4 substeps): K2 moves ~0.76 KB per env (q, v, cmd, λ0, wrench in; q,
// v, λ, residual, impulses, a, τ out), ~3.1 MB at B = 4096, ≈ 0.9 µs at
// 3.35 TB/s; it needs ~50 kFLOP per env per substep (the chain ~41k,
// FK/RNEA/CRBA/Jacobians/integration the rest; counted by chip_smoke.py
// `_substep_flops`), ≈ 0.83 GFLOP per env step at B = 4096, ≈ 12 µs at
// the 67 TFLOP/s non-tensor f32 rate. So operations bound it. The sensor
// stage adds per env the buffers in and out and each update's eps
// (ANYmal's suite: 150 + 150 + 4·57 floats, ~2.1 KB) and ~1.9 kFLOP per
// update (chip_smoke.py `_sensor_flops`): still operation-bound. The
// ground query (GEN) adds each env's coefficient row (≤ 512 B) and, per
// env and substep, 0.8–2.6 kFLOP (Stairs, Fourier with 16 terms, Perlin
// with 3 octaves; chip_smoke.py `_ground_flops`): operation-bound too. The
// model parameters (RAND) add each env's row (172 floats for ANYmal, 688 B)
// and two multiplies per motor and substep: operation-bound still. Cassie
// (nb 15, nv 20, nc 28 with its 2 distance rows, 10 substeps) takes the
// large frame and ~1.4× ANYmal's operations per substep (chip_smoke.py
// `_substep_flops`, with `_distance_flops` and `_spring_flops`):
// operation-bound as well; its three self-collision capsule pairs add the
// narrow phase and 9 rows, and the chain grows with nc (37 against 28;
// chip_smoke.py `_pair_flops`); its flexible twin (nb 17, nv 26, nq 29,
// nc 28: two SPHERICAL joints above the hips) grows the columns, not the
// rows (chip_smoke.py `_substep_flops` counts the SPHERICAL terms).
//
// The TPU kernel's lane-major layout (batch on the 128 vector lanes, the
// tree unrolled into Python floats, the batch padded by repetition) does
// not carry over. The tree arrives as a packed device buffer (read at the
// same addresses by every lane of a warp, so it broadcasts from L1), and
// bodies and rows are runtime loops, so one build serves every model. Both
// kernels run one warp per env (substep_warp.cuh): four envs per block, so
// B = 4096 is 4096 warps and an SM holds 12–16 of them; the env's working
// set in shared memory, sized from the model and not from the caps (8,752 B
// for ANYmal, 11,072 for Cassie, 13,792 for the slab; L factored in place
// of M, the tree passes' arrays in the chain's X and A), with odd row
// strides; the lanes across the bodies of one depth, the motors, the row
// items, Cholesky's column, the right-hand sides of M⁻¹[p | Jᵀ], A's
// columns and each PGS group, so a substep's dependent chain is the tree's
// depth and the chain's length, not its size. A first design ran one
// thread per env with every array in local memory, sized for the caps
// (~13 KB a thread in the ANYmal frame, ~40 KB in the large one), one warp
// a block: K2 at 196–340× its bound and K3 at 196–375× (PERF.md).
//
// Packed spec (built by ops/substep_kernel.py `SubstepSpec.packed`):
//   ints:   [nb, nq, nv, ncp, nbj, nm, torque mode, ground mode, Fourier
//           terms or Perlin octaves, n_dist] then parent,
//           joint type, q_off, v_off (nb each), contact body, color
//           order (ncp each), bounded bodies (nbj), motor q_idx, v_idx
//           (nm each), per distance constraint its two bodies (−1: a
//           point of the world);
//   floats: 16 scalars (JT_S_* below; JT_S_SPRINGS is 1 when the tree has
//           joint springs, JT_S_NGEN the number of pair contact generators,
//           JT_S_SPHERES 1 when a contact site has a radius), then per body [axis 3, placement
//           rotation 9 (row-major), placement position 3, mass, h = m·c
//           3, rotational inertia about the origin 9], armature (nv),
//           damping (nv), contact positions (3·ncp), bounds low, high
//           (nbj each), motors: reduction, effort limit, velocity limit,
//           dry friction, viscous friction, friction velocity, kp, kd
//           (nm each), per distance constraint [its two points in their
//           bodies 3 + 3, the distance d₀, α/dt], with springs the
//           stiffness (nv), with sphere sites the contact radii (ncp), and
//           the pair generators' floats (see `jt_pair_contact`).
//   ints after the distance bodies: per pair generator [kind, the points'
//           body, the other shape's body, contact count, offset of its
//           floats].
// Model parameters (RAND; ops/substep_kernel.py `SubstepSpec.n_mp`), one
// row of n_mp floats per env: mass (nb), h (3·nb), origin inertia xx, yy,
// zz, xy, xz, yz (6·nb), armature (nv), and for K2 motor gain (nm), motor
// friction scale (nm); K3 reads the same row and ignores the motor tail.

#ifndef JT_RAND
#error "define JT_RAND (csrc/substep.cu: false, csrc/substep_rand.cu: true) before including"
#endif

#include <cstdint>

#include "solve_chain.cuh"

#define JT_HDR_I 10
#define JT_HDR_F 16
#define JT_BODY_F 28
#define JT_NQ_EXTRA 4  // nq ≤ nv + 4 (quaternion joints)

// joint types, the codes of ops/substep_kernel.py (core/tree.py JointType);
// every site that reads one names each type it serves, so a code without
// its branch gets no dofs, never another type's arithmetic
enum { JT_FREE = 0, JT_REVOLUTE = 1, JT_PRISMATIC = 2, JT_SPHERICAL = 3 };
enum { JT_TORQUE_NONE = 0, JT_TORQUE_PD = 1, JT_TORQUE_DIRECT = 2 };
enum {
  JT_S_DT = 0, JT_S_ALPHA_B, JT_S_ALPHA_C_DT, JT_S_SLOP, JT_S_MAX_CORR,
  JT_S_MARGIN, JT_S_FRICTION, JT_S_GROUND, JT_S_GX, JT_S_GY, JT_S_GZ, JT_S_SPRINGS,
  JT_S_NGEN, JT_S_SPHERES
};

struct SpecView {
  int nb, nq, nv, ncp, nbj, nm, mode, gmode, gn, n_dist, n_gen;
  bool springs, spheres;
  const int *parent, *jtype, *q_off, *v_off, *cbody, *corder, *bbody, *mq, *mv;
  const float *scal, *body, *arm, *damp, *cpos, *blo, *bhi;
  const float *red, *elim, *vlim, *fdry, *fvis, *feps, *kp, *kd;
};

// The distance constraints' bodies and floats and the stiffness follow the
// motor arrays, derived where they are read.
__device__ __forceinline__ const int* jt_dist_bodies(const SpecView& s) { return s.mv + s.nm; }
__device__ __forceinline__ const float* jt_dist_floats(const SpecView& s) { return s.kd + s.nm; }
__device__ __forceinline__ const float* jt_stiffness(const SpecView& s) {
  return s.kd + s.nm + 8 * s.n_dist;
}
__device__ __forceinline__ const float* jt_radii(const SpecView& s) {
  return jt_stiffness(s) + (s.springs ? s.nv : 0);
}
__device__ __forceinline__ const int* jt_pair_ints(const SpecView& s) {
  return jt_dist_bodies(s) + 2 * s.n_dist;
}
__device__ __forceinline__ const float* jt_pair_floats(const SpecView& s) {
  return jt_radii(s) + (s.spheres ? s.ncp : 0);
}

__device__ __forceinline__ SpecView jt_view(const int* si, const float* sf) {
  SpecView s;
  s.nb = si[0]; s.nq = si[1]; s.nv = si[2]; s.ncp = si[3];
  s.nbj = si[4]; s.nm = si[5]; s.mode = si[6]; s.gmode = si[7]; s.gn = si[8];
  s.n_dist = si[9];
  s.springs = sf[JT_S_SPRINGS] != 0.f;
  s.n_gen = (int)sf[JT_S_NGEN];
  s.spheres = sf[JT_S_SPHERES] != 0.f;
  const int* p = si + JT_HDR_I;
  s.parent = p; p += s.nb;
  s.jtype = p; p += s.nb;
  s.q_off = p; p += s.nb;
  s.v_off = p; p += s.nb;
  s.cbody = p; p += s.ncp;
  s.corder = p; p += s.ncp;
  s.bbody = p; p += s.nbj;
  s.mq = p; p += s.nm;
  s.mv = p;
  s.scal = sf;
  const float* f = sf + JT_HDR_F;
  s.body = f; f += JT_BODY_F * s.nb;
  s.arm = f; f += s.nv;
  s.damp = f; f += s.nv;
  s.cpos = f; f += 3 * s.ncp;
  s.blo = f; f += s.nbj;
  s.bhi = f; f += s.nbj;
  s.red = f; f += s.nm;
  s.elim = f; f += s.nm;
  s.vlim = f; f += s.nm;
  s.fdry = f; f += s.nm;
  s.fvis = f; f += s.nm;
  s.feps = f; f += s.nm;
  s.kp = f; f += s.nm;
  s.kd = f;
  return s;
}

// ---- 3-vectors, row-major 3×3 matrices, spatial (angular, linear) 6-vectors

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void mat3_mul(const float* A, const float* B, float* C) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] + A[3 * r + 2] * B[6 + c];
}

__device__ __forceinline__ void mat3_vec(const float* A, const float* x, float* y) {
  for (int r = 0; r < 3; ++r)
    y[r] = A[3 * r] * x[0] + A[3 * r + 1] * x[1] + A[3 * r + 2] * x[2];
}

__device__ __forceinline__ void mat3t_vec(const float* A, const float* x, float* y) {
  for (int r = 0; r < 3; ++r)
    y[r] = A[r] * x[0] + A[3 + r] * x[1] + A[6 + r] * x[2];
}

__device__ __forceinline__ void quat_to_m(const float* q, float* R) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

// Transform (R, p) of a child in its parent: motion parent → child
__device__ __forceinline__ void motion_p2c(const float* R, const float* p,
                                           const float* m, float* out) {
  float pw[3], d[3];
  mat3t_vec(R, m, out);
  cross3(p, m, pw);
  for (int k = 0; k < 3; ++k) d[k] = m[3 + k] - pw[k];
  mat3t_vec(R, d, out + 3);
}

// force child → parent
__device__ __forceinline__ void force_c2p(const float* R, const float* p,
                                          const float* f, float* out) {
  float ang[3], pl[3];
  mat3_vec(R, f + 3, out + 3);
  mat3_vec(R, f, ang);
  cross3(p, out + 3, pl);
  for (int k = 0; k < 3; ++k) out[k] = ang[k] + pl[k];
}

// spatial inertia (mass, h, I) times motion (w, v)
__device__ __forceinline__ void inertia_mul(float mass, const float* h, const float* I,
                                            const float* m, float* out) {
  float Iw[3], hv[3], hw[3];
  mat3_vec(I, m, Iw);
  cross3(h, m + 3, hv);
  cross3(h, m, hw);
  for (int k = 0; k < 3; ++k) {
    out[k] = Iw[k] + hv[k];
    out[3 + k] = mass * m[3 + k] - hw[k];
  }
}

// motion cross motion: (w×ow, w×ov + v×ow)
__device__ __forceinline__ void motion_cross(const float* m, const float* o, float* out) {
  float a[3], b[3];
  cross3(m, o, out);
  cross3(m, o + 3, a);
  cross3(m + 3, o, b);
  for (int k = 0; k < 3; ++k) out[3 + k] = a[k] + b[k];
}

// motion cross force: (w×n + v×f, w×f)
__device__ __forceinline__ void motion_cross_force(const float* m, const float* f, float* out) {
  float a[3], b[3];
  cross3(m, f, a);
  cross3(m + 3, f + 3, b);
  for (int k = 0; k < 3; ++k) out[k] = a[k] + b[k];
  cross3(m, f + 3, out + 3);
}

__device__ __forceinline__ int joint_nv(int jt) {
  return jt == JT_FREE ? 6 : jt == JT_SPHERICAL ? 3
       : (jt == JT_REVOLUTE || jt == JT_PRISMATIC) ? 1 : 0;
}

// column c of joint i's motion subspace as (w, v)
__device__ __forceinline__ void subspace_col(int jt, const float* axis, int c, float* col) {
  // unit columns by selects, not an index into col (which would put col
  // in local memory)
  for (int k = 0; k < 6; ++k) col[k] = 0.f;
  if (jt == JT_FREE) {
    const int hot = c < 3 ? 3 + c : c - 3;  // linear dofs (v = [v_lin, ω]), then angular
    for (int k = 0; k < 6; ++k) col[k] = k == hot ? 1.f : 0.f;
  } else if (jt == JT_SPHERICAL) {
    for (int k = 0; k < 6; ++k) col[k] = k == c ? 1.f : 0.f;  // v = ω local
  } else if (jt == JT_REVOLUTE || jt == JT_PRISMATIC) {
    // [axis; 0] turns about the axis, [0; axis] slides along it (selects,
    // not an index into col, which would put col in local memory)
    const bool lin = jt == JT_PRISMATIC;
    for (int k = 0; k < 3; ++k) {
      col[k] = lin ? 0.f : axis[k];
      col[3 + k] = lin ? axis[k] : 0.f;
    }
  }
}

// S_i · xj as a spatial motion, xj the joint's own dofs
__device__ __forceinline__ void joint_motion_of(const SpecView& s, int i, const float* xj,
                                                float* out) {
  const int jt = s.jtype[i];
  if (jt == JT_FREE) {
    for (int k = 0; k < 3; ++k) {
      out[k] = xj[3 + k];
      out[3 + k] = xj[k];
    }
  } else if (jt == JT_SPHERICAL) {
    for (int k = 0; k < 3; ++k) {
      out[k] = xj[k];
      out[3 + k] = 0.f;
    }
  } else if (jt == JT_REVOLUTE || jt == JT_PRISMATIC) {
    const float* axis = s.body + JT_BODY_F * i;
    const bool lin = jt == JT_PRISMATIC;
    for (int k = 0; k < 3; ++k) {
      const float a = axis[k] * xj[0];
      out[k] = lin ? 0.f : a;
      out[3 + k] = lin ? a : 0.f;
    }
  } else {
    for (int k = 0; k < 6; ++k) out[k] = 0.f;
  }
}

// S_i · x[v_off(i):] as a spatial motion
__device__ __forceinline__ void joint_motion(const SpecView& s, int i, const float* x, float* out) {
  joint_motion_of(s, i, x + s.v_off[i], out);
}

// joint i's own transform (Rj, pj) at q
__device__ __forceinline__ void jt_joint_transform(const SpecView& s, int i, const float* q,
                                                   float* Rj, float* pj) {
  const float* bd = s.body + JT_BODY_F * i;  // axis, Rp, pp, ...
  const int qo = s.q_off[i];
  const int jt = s.jtype[i];
  for (int k = 0; k < 3; ++k) pj[k] = 0.f;
  if (jt == JT_FREE) {
    quat_to_m(q + qo + 3, Rj);
    for (int k = 0; k < 3; ++k) pj[k] = q[qo + k];
  } else if (jt == JT_SPHERICAL) {
    quat_to_m(q + qo, Rj);
  } else if (jt == JT_PRISMATIC) {  // (I, axis·q)
    for (int r = 0; r < 9; ++r) Rj[r] = (r % 4 == 0) ? 1.f : 0.f;
    for (int k = 0; k < 3; ++k) pj[k] = bd[k] * q[qo];
  } else if (jt == JT_REVOLUTE) {  // Rodrigues: I + sin·K + (1 − cos)·K²
    const float c = cosf(q[qo]), sn = sinf(q[qo]);
    const float K[9] = {0.f, -bd[2], bd[1], bd[2], 0.f, -bd[0], -bd[1], bd[0], 0.f};
    float KK[9];
    mat3_mul(K, K, KK);
    for (int r = 0; r < 9; ++r)
      Rj[r] = ((r % 4 == 0) ? 1.f : 0.f) + sn * K[r] + (1.f - c) * KK[r];
  } else {
    for (int r = 0; r < 9; ++r) Rj[r] = (r % 4 == 0) ? 1.f : 0.f;
  }
}

// pose (R, p) of body i in its parent: joint placement ∘ joint transform
__device__ __forceinline__ void jt_local_pose(const SpecView& s, int i, const float* q,
                                              float* R, float* p) {
  const float* bd = s.body + JT_BODY_F * i;
  float Rj[9], pj[3], t3[3];
  jt_joint_transform(s, i, q, Rj, pj);
  mat3_mul(bd + 3, Rj, R);
  mat3_vec(bd + 3, pj, t3);
  for (int k = 0; k < 3; ++k) p[k] = t3[k] + bd[12 + k];
}

// so3.quat_log (counterpart of `_quat_log_lane`, with atan2f in place of its
// polynomial): the rotation vector of a unit quaternion, the shorter
// rotation (w < 0 flips the sign), the scale 2/max(w, 1e-12) where
// |xyz|² < 1e-14, else 2·atan2(|xyz|, |w|)/|xyz| with 1e-24 under the sqrt
__device__ __forceinline__ void jt_quat_log(const float* q, float* rv) {
  const float s2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2];
  const float sh = sqrtf(s2 + 1e-24f);
  const float w = fabsf(q[3]);
  const float scale = s2 < 1e-14f ? 2.f / fmaxf(w, 1e-12f) : 2.f * atan2f(sh, w) / sh;
  for (int k = 0; k < 3; ++k) rv[k] = (q[3] < 0.f ? -q[k] : q[k]) * scale;
}

// so3.quat_exp (Taylor-guarded at 0) then so3.quat_mul: qa ⊗ exp(rv)
__device__ __forceinline__ void jt_quat_turn(const float* qa, const float* rv, float* out) {
  const float th2 = rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2];
  const float th = sqrtf(th2 + 1e-24f);
  const bool small = th2 < 1e-14f;
  const float sh = small ? 0.5f - th2 / 48.f : sinf(0.5f * th) / th;
  const float bw = small ? 1.f - th2 / 8.f : cosf(0.5f * th);
  const float bx = rv[0] * sh, by = rv[1] * sh, bz = rv[2] * sh;
  const float x = qa[0], y = qa[1], z = qa[2], w = qa[3];
  out[0] = w * bx + x * bw + y * bz - z * by;
  out[1] = w * by - x * bz + y * bw + z * bx;
  out[2] = w * bz + x * by - y * bx + z * bw;
  out[3] = w * bw - x * bx - y * by - z * bz;
}

// so3.quat_integrate: normalize(q ⊗ exp(ω·dt)), the step of the FREE and
// SPHERICAL joints' quaternions (q and out may not alias)
__device__ __forceinline__ void jt_quat_step(const float* q, const float* w_dt, float* out) {
  float t[4];
  jt_quat_turn(q, w_dt, t);
  const float nrm = sqrtf(t[0] * t[0] + t[1] * t[1] + t[2] * t[2] + t[3] * t[3] + 1e-12f);
  for (int k = 0; k < 4; ++k) out[k] = t[k] / nrm;
}

// ---- actuation torque (engine._joint_torque for a declarative controller:
// PD or direct command → effort clamp → reduction → velocity derate →
// dry + viscous friction, then joint damping, then the joint springs: −k·q
// on a 1-DoF joint, −k·log(quat) on a SPHERICAL one's 3 dofs, the
// flexibility joints of `_compute_tau`). With RAND, mscale is the
// env's motor tail [gain (nm) | friction scale (nm)]: the reduction times
// the gain, the friction torque times the scale (`_compute_tau`'s order).
__device__ __forceinline__ float sign_of(float x) { return (float)((x > 0.f) - (x < 0.f)); }

// motor m's torque on its dof v_idx[m] (the part before joint damping)
template <bool RAND>
__device__ __forceinline__ float jt_motor_tau(const SpecView& s, int m, const float* q,
                                              const float* v, const float* cmd,
                                              const float* mscale) {
  const int vi = s.mv[m];
  const float vj = v[vi];
  float u = s.mode == JT_TORQUE_PD
                ? s.kp[m] * (cmd[m] - q[s.mq[m]]) - s.kd[m] * vj
                : cmd[m];
  const float el = s.elim[m];
  u = fminf(fmaxf(u, -el), el);
  float red = s.red[m];
  if constexpr (RAND) red = red * mscale[m];
  float tm = red * u;
  const float vl = s.vlim[m];
  const float over =
      fminf(fmaxf((fabsf(vj) - vl) / (0.1f * fmaxf(vl, 1e-6f)), 0.f), 1.f);
  if (sign_of(tm) == sign_of(vj)) tm = tm * (1.f - over);
  float fric = s.fdry[m] * tanhf(vj / s.feps[m]) + s.fvis[m] * vj;
  if constexpr (RAND) fric = fric * mscale[s.nm + m];
  return tm - fric;
}

// joint i's spring torque taken from its dofs of tau (springs in the spec)
__device__ __forceinline__ void jt_spring_tau(const SpecView& s, int i, const float* q,
                                              float* tau) {
  const float* stiff = jt_stiffness(s);
  const int jt = s.jtype[i], vo = s.v_off[i], qo = s.q_off[i];
  if (jt == JT_SPHERICAL) {
    if (stiff[vo] != 0.f || stiff[vo + 1] != 0.f || stiff[vo + 2] != 0.f) {
      float rv[3];
      jt_quat_log(q + qo, rv);
      for (int r = 0; r < 3; ++r) tau[vo + r] = tau[vo + r] - stiff[vo + r] * rv[r];
    }
  } else if (jt == JT_REVOLUTE || jt == JT_PRISMATIC) {  // −k·q, angle or length
    const float k = stiff[vo];
    if (k != 0.f) tau[vo] = tau[vo] - k * q[qo];
  }
}

// ---- the ground query (counterpart of `_ground_query`; the plain
// version is engine/ground.py's `query` of each ground): height and
// gradient (h, ∂h/∂x, ∂h/∂y) of the env's analytic ground at (px, py),
// from its coefficient row g (n_gc floats, the engine/ground.py layout),
// the mode and the term or octave count s.gn from the spec's header:
//   Fourier [amp | kx | ky | phase]: Σ amp·sin(kx·x + ky·y + phase), the
//     gradient from the cosines; sinf/cosf with full range reduction (the
//     arguments reach hundreds of radians a few metres out);
//   Perlin [seed, freq, amp]: per octave o (frequency freq·2ᵒ, weight
//     2⁻ᵒ, seed + 1013·o) lattice gradient noise with gradients (±1, ±1)
//     from the two low bits of an arithmetic hash, blended by the quintic
//     fade, and its analytic gradient; the hash wraps in uint32 (signed
//     overflow would be undefined), and a logical shift of uint32 is the
//     reference's masked arithmetic shift of int32;
//   Stairs [w, H, n, ramp, x0]: H·clip(k + clip((u − k·w)/ramp, 0, 1), 0,
//     n), k = ⌊u/w⌋, u = x − x0; slope H/ramp on the ramps.
enum { JT_GROUND_FLAT = 0, JT_GROUND_FOURIER = 1, JT_GROUND_PERLIN = 2, JT_GROUND_STAIRS = 3 };
#define JT_FOURIER_MAX 32  // terms (ops/substep_kernel.py MAX_FOURIER_TERMS)
#define JT_PERLIN_MAX 8    // octaves (MAX_PERLIN_OCTAVES)
#define JT_GC_MAX (4 * JT_FOURIER_MAX)

__device__ __forceinline__ uint32_t jt_hash2(uint32_t ix, uint32_t iy, uint32_t seed) {
  uint32_t h = ix * 0x27D4EB2Du + iy * 0x165667B1u + seed;
  h ^= h >> 15;
  h *= 0x2545F491u;
  return h ^ (h >> 13);
}

// one octave at lattice scale 1: out = (h, ∂h/∂px, ∂h/∂py)
__device__ __forceinline__ void jt_perlin_octave(float px, float py, uint32_t seed, float* out) {
  const float fx = floorf(px), fy = floorf(py);
  const float xf = px - fx, yf = py - fy;
  const uint32_t ix = (uint32_t)(int)fx, iy = (uint32_t)(int)fy;
  float n[4], sx[4], sy[4];  // corners (0,0), (1,0), (0,1), (1,1)
  for (int c = 0; c < 4; ++c) {
    const int di = c & 1, dj = c >> 1;
    const uint32_t h = jt_hash2(ix + di, iy + dj, seed);
    sx[c] = (h & 1u) ? -1.f : 1.f;
    sy[c] = (h & 2u) ? -1.f : 1.f;
    n[c] = sx[c] * (xf - (float)di) + sy[c] * (yf - (float)dj);
  }
  const float u = xf * xf * xf * (xf * (xf * 6.f - 15.f) + 10.f);
  const float v = yf * yf * yf * (yf * (yf * 6.f - 15.f) + 10.f);
  const float tu = xf * (xf - 1.f), tv = yf * (yf - 1.f);
  const float du = 30.f * tu * tu, dv = 30.f * tv * tv;
  const float nx0 = n[0] + u * (n[1] - n[0]), nx1 = n[2] + u * (n[3] - n[2]);
  out[0] = nx0 + v * (nx1 - nx0);
  const float dx0 = sx[0] + u * (sx[1] - sx[0]) + du * (n[1] - n[0]);
  const float dx1 = sx[2] + u * (sx[3] - sx[2]) + du * (n[3] - n[2]);
  out[1] = dx0 + v * (dx1 - dx0);
  const float dy0 = sy[0] + u * (sy[1] - sy[0]), dy1 = sy[2] + u * (sy[3] - sy[2]);
  out[2] = dy0 + v * (dy1 - dy0) + dv * (nx1 - nx0);
}

// out = (h, ∂h/∂x, ∂h/∂y) of the env's ground at (px, py)
__device__ __forceinline__ void jt_ground_query(const SpecView& s, const float* g, int n_gc,
                                                float px, float py, float* out) {
  out[0] = out[1] = out[2] = 0.f;
  if (s.gmode == JT_GROUND_FOURIER) {
    const int K = n_gc / 4;  // the row's layout; s.gn ≤ K terms are summed
    for (int j = 0; j < min(s.gn, K); ++j) {
      const float amp = g[j], kx = g[K + j], ky = g[2 * K + j];
      float sn, cs;
      sincosf(kx * px + ky * py + g[3 * K + j], &sn, &cs);
      out[0] += amp * sn;
      out[1] += amp * kx * cs;
      out[2] += amp * ky * cs;
    }
  } else if (s.gmode == JT_GROUND_PERLIN) {
    const int octaves = min(s.gn, JT_PERLIN_MAX);
    double norm = 0.0;  // fBm normalization, rounded once as the plain version's
    for (int o = 0; o < octaves; ++o) norm += ldexp(1.0, -2 * o);
    const float scale = g[2] * (float)(1.0 / (0.306 * sqrt(norm)));
    const uint32_t seed = (uint32_t)(int)g[0];
    for (int o = 0; o < octaves; ++o) {
      const float f_o = g[1] * ldexpf(1.f, o), w_o = scale * ldexpf(1.f, -o);
      float oc[3];
      jt_perlin_octave(px * f_o, py * f_o, seed + 1013u * (uint32_t)o, oc);
      out[0] += w_o * oc[0];
      out[1] += w_o * f_o * oc[1];
      out[2] += w_o * f_o * oc[2];
    }
  } else if (s.gmode == JT_GROUND_STAIRS) {
    const float w = g[0], H = g[1], n = g[2], ramp = g[3], x0 = g[4];
    const float u = px - x0;
    const float k = floorf(u / w);
    const float t = (u - k * w) / ramp;
    const float kt = k + fminf(fmaxf(t, 0.f), 1.f);
    out[0] = H * fminf(fmaxf(kt, 0.f), n);
    out[1] = (t > 0.f && t < 1.f && kt > 0.f && kt < n) ? H / ramp : 0.f;
  }
}

// the contact frame at a point of the ground: normal n̂ = (−∂h/∂x, −∂h/∂y,
// 1)/‖·‖, then cstr.tangent_basis: ref = e_z where the slope is steep (n_z
// < 0.9), else e_x; t1 = ref × n̂ normalized, t2 = n̂ × t1. basis = [t1 |
// t2 | n̂]; returns the height h.
__device__ __forceinline__ float jt_contact_basis(const SpecView& s, const float* g, int n_gc,
                                                  const float* pt, float* basis) {
  float hg[3];
  jt_ground_query(s, g, n_gc, pt[0], pt[1], hg);
  float* nn = basis + 6;
  const float inv = rsqrtf(hg[1] * hg[1] + hg[2] * hg[2] + 1.f);
  nn[0] = -hg[1] * inv;
  nn[1] = -hg[2] * inv;
  nn[2] = inv;
  const bool steep = inv < 0.9f;
  const float ref[3] = {steep ? 0.f : 1.f, 0.f, steep ? 1.f : 0.f};
  cross3(ref, nn, basis);
  const float r = rsqrtf(dot3(basis, basis) + 1e-24f);
  for (int e = 0; e < 3; ++e) basis[e] *= r;
  cross3(nn, basis, basis + 3);
  return hg[0];
}

// the env's inertials from its model-parameter row (counterpart of
// `_unpack_mp`) into the [mass, h (3), I (3×3, row-major)] layout of the
// spec's bodies: I rebuilt symmetric from xx, yy, zz, xy, xz, yz
__device__ __forceinline__ void jt_load_inertial(const SpecView& s, const float* mp, int i,
                                                 float* Ic) {
  const int nb = s.nb;
  const float* h = mp + nb + 3 * i;
  const float* I6 = mp + 4 * nb + 6 * i;
  Ic[0] = mp[i];
  for (int k = 0; k < 3; ++k) Ic[1 + k] = h[k];
  Ic[4] = I6[0]; Ic[5] = I6[3]; Ic[6] = I6[4];
  Ic[7] = I6[3]; Ic[8] = I6[1]; Ic[9] = I6[5];
  Ic[10] = I6[4]; Ic[11] = I6[5]; Ic[12] = I6[2];
}

// ---- one distance-constraint row (the closed loops of `_substep_math`):
// p_k = R_bk·p_k,local + x_bk (the constant itself for a body < 0), d =
// √(|p₁ − p₂|² + 1e-24), u = (p₁ − p₂)/max(d, 1e-9), the row u·(J_p(b₁, p₁)
// − J_p(b₂, p₂)) written into Jrow (zeroed by the caller; a body < 0 adds
// nothing), the Baumgarte target −(α/dt)·(d − d₀) returned. c: the
// constraint's packed floats [p₁ local 3, p₂ local 3, d₀, α/dt].
__device__ __forceinline__ float jt_distance_row(const SpecView& s, const float (*xwR)[9],
                                                 const float (*xwp)[3], int b1, int b2,
                                                 const float* c, float* Jrow) {
  float p[2][3], d3[3], u[3], col[6];
  const int bs[2] = {b1, b2};
  for (int k = 0; k < 2; ++k) {
    if (bs[k] < 0) {
      for (int e = 0; e < 3; ++e) p[k][e] = c[3 * k + e];
    } else {
      mat3_vec(xwR[bs[k]], c + 3 * k, p[k]);
      for (int e = 0; e < 3; ++e) p[k][e] += xwp[bs[k]][e];
    }
  }
  for (int e = 0; e < 3; ++e) d3[e] = p[0][e] - p[1][e];
  const float d = sqrtf(dot3(d3, d3) + 1e-24f);
  for (int e = 0; e < 3; ++e) u[e] = d3[e] / fmaxf(d, 1e-9f);
  for (int k = 0; k < 2; ++k) {
    const float sign = k == 0 ? 1.f : -1.f;
    for (int j = bs[k]; j >= 0; j = s.parent[j]) {
      const int jt = s.jtype[j], vo = s.v_off[j];
      float r3[3];
      for (int e = 0; e < 3; ++e) r3[e] = p[k][e] - xwp[j][e];
      for (int cc = 0; cc < joint_nv(jt); ++cc) {
        float wc[3], vc[3], wr[3];
        subspace_col(jt, s.body + JT_BODY_F * j, cc, col);
        mat3_vec(xwR[j], col, wc);
        mat3_vec(xwR[j], col + 3, vc);
        cross3(wc, r3, wr);
        float lin[3];
        for (int e = 0; e < 3; ++e) lin[e] = vc[e] + wr[e];
        Jrow[vo + cc] += sign * dot3(u, lin);
      }
    }
  }
  return -c[7] * (d - c[6]);
}

// ---- collision pairs (the pair block of `_substep_math`; the plain
// version is engine/collision.py `pair_rows`). Generators, in the packed
// spec's pair section (ops/substep_kernel.py `SubstepSpec._pack_pairs`),
// each [kind, b_p, b_f, k, offset] and its floats:
//   seg   (one contact): [μ, r_a, r_b, a0 3, a1 3, b0 3, b1 3], segment a on
//         b_p, segment b on b_f;
//   ptbox (k contacts): [μ, r_p, box centre 3, box rotation 9 (row-major),
//         half-extents 3, k points 3k], points on b_p, the box on b_f;
//   ptseg (k contacts): [μ, r_p, r_s, p0 3, p1 3, k points 3k], points on
//         b_p, the capsule [p0, p1] of radius r_s on b_f;
// every point in its body's frame.
enum { JT_GEN_SEG = 0, JT_GEN_PTBOX = 1, JT_GEN_PTSEG = 2 };

__device__ __forceinline__ void jt_world_point(const float (*xwR)[9], const float (*xwp)[3],
                                               int b, const float* pl, float* pw) {
  mat3_vec(xwR[b], pl, pw);
  for (int e = 0; e < 3; ++e) pw[e] += xwp[b][e];
}

// closest points ca, cb of the segments [p1, q1], [p2, q2] (counterpart of
// `_seg_seg_lane`, Ericson §5.1.9): s of the infinite lines clamped to
// [0, 1], then t, then s again at the clamped t where t left [0, 1]
__device__ __forceinline__ void jt_seg_seg(const float* p1, const float* q1, const float* p2,
                                           const float* q2, float* ca, float* cb) {
  const float eps = 1e-9f;
  float d1[3], d2[3], r[3];
  for (int e = 0; e < 3; ++e) {
    d1[e] = q1[e] - p1[e];
    d2[e] = q2[e] - p2[e];
    r[e] = p1[e] - p2[e];
  }
  const float a = dot3(d1, d1), ee = dot3(d2, d2);
  const float f = dot3(d2, r), c = dot3(d1, r), b = dot3(d1, d2);
  const float denom = a * ee - b * b;
  float sc = denom > eps ? fminf(fmaxf((b * f - c * ee) / fmaxf(denom, eps), 0.f), 1.f) : 0.f;
  const float t = ee > eps ? (b * sc + f) / fmaxf(ee, eps) : 0.f;
  const float tc = fminf(fmaxf(t, 0.f), 1.f);
  if (t != tc) sc = a > eps ? fminf(fmaxf((tc * b - c) / fmaxf(a, eps), 0.f), 1.f) : 0.f;
  for (int e = 0; e < 3; ++e) {
    ca[e] = p1[e] + sc * d1[e];
    cb[e] = p2[e] + tc * d2[e];
  }
}

// exact box signed distance of pl (box frame), half-extents h, and its
// outward normal nl: outside the gradient of the distance to the box,
// inside the axis of least penetration (ties to within 1e-12 averaged)
__device__ __forceinline__ float jt_box_sdf(const float* pl, const float* h, float* nl) {
  float qd[3], out[3], sg[3], one[3];
  for (int e = 0; e < 3; ++e) {
    qd[e] = fabsf(pl[e]) - h[e];
    out[e] = fmaxf(qd[e], 0.f);
    sg[e] = pl[e] >= 0.f ? 1.f : -1.f;
  }
  const float d_out = sqrtf(dot3(out, out) + 1e-18f);
  const float m = fmaxf(fmaxf(qd[0], qd[1]), qd[2]);
  for (int e = 0; e < 3; ++e) one[e] = qd[e] >= m - 1e-12f ? 1.f : 0.f;
  const float tot = one[0] + one[1] + one[2];
  for (int e = 0; e < 3; ++e) nl[e] = m < 0.f ? sg[e] * one[e] / tot : sg[e] * out[e] / d_out;
  return d_out + fminf(m, 0.f);
}

// one pair contact's rows (counterpart of `emit_pair_contact`) at row:
// [t1; t2; n]·(J_p(b_a, sa) − J_p(b_b, sb)) added into J (zeroed by the
// caller; the two chains may share ancestors), t1 = n × ref normalized
// (ref = e_x where |n_x| < 0.9, else e_y), t2 = n × t1; the ground
// contacts' Baumgarte / velocity-barrier target on the normal row, active
// where depth > −margin, μ the pair's friction.
__device__ __forceinline__ void jt_pair_contact(
    const SpecView& s, const float (*xwR)[9], const float (*xwp)[3], int ba, const float* sa,
    int bb, const float* sb, const float* n, float depth, float mu_g, int row, float* J, int ldj,
    float* target, float* active, float* mu) {
  float bs[9], col[6];
  const bool cnd = fabsf(n[0]) < 0.9f;
  const float ref[3] = {cnd ? 1.f : 0.f, cnd ? 0.f : 1.f, 0.f};
  cross3(n, ref, bs);
  const float r = rsqrtf(dot3(bs, bs) + 1e-18f);
  for (int e = 0; e < 3; ++e) bs[e] *= r;
  cross3(n, bs, bs + 3);
  for (int e = 0; e < 3; ++e) bs[6 + e] = n[e];
  const int bodies[2] = {ba, bb};
  for (int k = 0; k < 2; ++k) {
    const float sign = k == 0 ? 1.f : -1.f;
    const float* p = k == 0 ? sa : sb;
    for (int j = bodies[k]; j >= 0; j = s.parent[j]) {
      const int jt = s.jtype[j], vo = s.v_off[j];
      float r3[3];
      for (int e = 0; e < 3; ++e) r3[e] = p[e] - xwp[j][e];
      for (int cc = 0; cc < joint_nv(jt); ++cc) {
        float wc[3], vc[3], wr[3], lin[3];
        subspace_col(jt, s.body + JT_BODY_F * j, cc, col);
        mat3_vec(xwR[j], col, wc);
        mat3_vec(xwR[j], col + 3, vc);
        cross3(wc, r3, wr);
        for (int e = 0; e < 3; ++e) lin[e] = vc[e] + wr[e];
        for (int e = 0; e < 3; ++e) J[(row + e) * ldj + vo + cc] += sign * dot3(bs + 3 * e, lin);
      }
    }
  }
  const float dt = s.scal[JT_S_DT];
  const float corr = depth > 0.f
      ? fminf(fmaxf(s.scal[JT_S_ALPHA_C_DT] * (depth - s.scal[JT_S_SLOP]), 0.f),
              s.scal[JT_S_MAX_CORR])
      : depth / dt;
  const float act = depth > -s.scal[JT_S_MARGIN] ? 1.f : 0.f;
  for (int e = 0; e < 3; ++e) {
    target[row + e] = e == 2 ? corr : 0.f;
    active[row + e] = act;
    mu[row + e] = mu_g;
  }
}

// pair contact p (0 from the first generator's first contact, in
// generator order) as rows at row: its generator's narrow phase (the pair
// block of `_substep_math`) for that contact alone; nothing when the
// generators hold fewer contacts. J's rows ldj apart.
__device__ __forceinline__ void jt_pair_item(const SpecView& s, const float (*xwR)[9],
                                             const float (*xwp)[3], int p, int row, float* J,
                                             int ldj, float* target, float* active, float* mu) {
  const int* gi = jt_pair_ints(s);
  const float* gfl = jt_pair_floats(s);
  for (int gidx = 0; gidx < s.n_gen; ++gidx) {
    const int* G = gi + 5 * gidx;
    const int kind = G[0], bp = G[1], bf = G[2];
    const int count = kind == JT_GEN_SEG ? 1 : G[3];
    if (p >= count) {
      p -= count;
      continue;
    }
    const float* f = gfl + G[4];
    float n[3], sa[3], sb[3], depth;
    if (kind == JT_GEN_SEG) {
      float pa0[3], pa1[3], pb0[3], pb1[3], ca[3], cb[3], d[3];
      jt_world_point(xwR, xwp, bp, f + 3, pa0);
      jt_world_point(xwR, xwp, bp, f + 6, pa1);
      jt_world_point(xwR, xwp, bf, f + 9, pb0);
      jt_world_point(xwR, xwp, bf, f + 12, pb1);
      jt_seg_seg(pa0, pa1, pb0, pb1, ca, cb);
      for (int e = 0; e < 3; ++e) d[e] = ca[e] - cb[e];
      const float dist = sqrtf(dot3(d, d) + 1e-18f);
      for (int e = 0; e < 3; ++e) {
        n[e] = d[e] / dist;  // from b toward a
        sa[e] = ca[e] - f[1] * n[e];
        sb[e] = cb[e] + f[2] * n[e];
      }
      depth = (f[1] + f[2]) - dist;
    } else if (kind == JT_GEN_PTBOX) {
      const float rp = f[1];
      float cw[3], Rw[9];  // the box's centre and axes in the world: Rw = R_bf·R
      jt_world_point(xwR, xwp, bf, f + 2, cw);
      mat3_mul(xwR[bf], f + 5, Rw);
      float pw[3], rel[3], pl[3], nl[3];
      jt_world_point(xwR, xwp, bp, f + 17 + 3 * p, pw);
      for (int e = 0; e < 3; ++e) rel[e] = pw[e] - cw[e];
      mat3t_vec(Rw, rel, pl);  // box frame
      const float sdf = jt_box_sdf(pl, f + 14, nl);
      mat3_vec(Rw, nl, n);  // outward from the box, toward the point
      for (int e = 0; e < 3; ++e) {
        sa[e] = pw[e] - rp * n[e];
        sb[e] = pw[e] - sdf * n[e];
      }
      depth = rp - sdf;
    } else {  // JT_GEN_PTSEG: the points against a capsule on bf
      const float rp = f[1], rs = f[2];
      float p0[3], p1[3], seg[3];
      jt_world_point(xwR, xwp, bf, f + 3, p0);
      jt_world_point(xwR, xwp, bf, f + 6, p1);
      for (int e = 0; e < 3; ++e) seg[e] = p1[e] - p0[e];
      const float denom = fmaxf(dot3(seg, seg), 1e-12f);
      float pw[3], rel[3], cpt[3], d[3];
      jt_world_point(xwR, xwp, bp, f + 9 + 3 * p, pw);
      for (int e = 0; e < 3; ++e) rel[e] = pw[e] - p0[e];
      const float st = fminf(fmaxf(dot3(rel, seg) / denom, 0.f), 1.f);
      for (int e = 0; e < 3; ++e) {
        cpt[e] = p0[e] + st * seg[e];
        d[e] = pw[e] - cpt[e];
      }
      const float dist = sqrtf(dot3(d, d) + 1e-18f);
      for (int e = 0; e < 3; ++e) {
        n[e] = d[e] / dist;
        sa[e] = pw[e] - rp * n[e];
        sb[e] = cpt[e] + rs * n[e];
      }
      depth = (rp + rs) - dist;
    }
    jt_pair_contact(s, xwR, xwp, bp, sa, bf, sb, n, depth, f[0], row, J, ldj, target, active, mu);
    return;
  }
}

// ---- the pieces of one substep, each for one body, dof, row or contact,
// which the warp body (substep_warp.cuh) runs across its lanes.

// FK of body i, its local pose (xlR, xlp)[i] known and its parent's done:
// world pose and local spatial velocity
__device__ __forceinline__ void jt_fk_body(const SpecView& s, int i, const float* v,
                                           const float (*xlR)[9], const float (*xlp)[3],
                                           float (*xwR)[9], float (*xwp)[3], float (*vel)[6]) {
  float t3[3], t6[6], vj[6];
  joint_motion(s, i, v, vj);
  const int p = s.parent[i];
  if (p < 0) {
    for (int k = 0; k < 9; ++k) xwR[i][k] = xlR[i][k];
    for (int k = 0; k < 3; ++k) xwp[i][k] = xlp[i][k];
    for (int k = 0; k < 6; ++k) vel[i][k] = vj[k];
  } else {
    mat3_mul(xwR[p], xlR[i], xwR[i]);
    mat3_vec(xwR[p], xlp[i], t3);
    for (int k = 0; k < 3; ++k) xwp[i][k] = t3[k] + xwp[p][k];
    motion_p2c(xlR[i], xlp[i], vel[p], t6);
    for (int k = 0; k < 6; ++k) vel[i][k] = t6[k] + vj[k];
  }
}

// RNEA's forward pass at body i (its parent's done): the acceleration from
// a0 = [0; −g] at the root, and the force I·a + v ×* I·v; in: [mass, h, I]
__device__ __forceinline__ void jt_rnea_fwd_body(const SpecView& s, int i, const float* v,
                                                 const float* in, const float (*xlR)[9],
                                                 const float (*xlp)[3], const float (*vel)[6],
                                                 float (*acc)[6], float (*frc)[6]) {
  float t6[6], u6[6], vj[6], col[6];
  const int p = s.parent[i];
  if (p < 0) {
    const float a0[6] = {0.f, 0.f, 0.f, -s.scal[JT_S_GX], -s.scal[JT_S_GY], -s.scal[JT_S_GZ]};
    motion_p2c(xlR[i], xlp[i], a0, acc[i]);
  } else {
    joint_motion(s, i, v, vj);
    motion_p2c(xlR[i], xlp[i], acc[p], t6);
    motion_cross(vel[i], vj, u6);
    for (int k = 0; k < 6; ++k) acc[i][k] = t6[k] + u6[k];
  }
  inertia_mul(in[0], in + 1, in + 4, acc[i], t6);
  inertia_mul(in[0], in + 1, in + 4, vel[i], u6);
  motion_cross_force(vel[i], u6, col);
  for (int k = 0; k < 6; ++k) frc[i][k] = t6[k] + col[k];
}

// RNEA's backward pass at body i (its force complete): the bias of its
// dofs, and its force in its parent's frame into up (a root leaves up as is)
__device__ __forceinline__ void jt_rnea_bwd_body(const SpecView& s, int i,
                                                 const float (*xlR)[9], const float (*xlp)[3],
                                                 const float* frc_i, float* bias, float* up) {
  float col[6];
  const int vo = s.v_off[i], jt = s.jtype[i];
  for (int c = 0; c < joint_nv(jt); ++c) {
    subspace_col(jt, s.body + JT_BODY_F * i, c, col);
    float d = 0.f;
    for (int k = 0; k < 6; ++k) d += frc_i[k] * col[k];
    bias[vo + c] = d;
  }
  if (s.parent[i] >= 0) force_c2p(xlR[i], xlp[i], frc_i, up);
}

// CRBA: what body i's composite inertia (mass, h, I about its origin) adds
// to its parent's, expressed in the parent (pose R, pp of i in it)
__device__ __forceinline__ void jt_composite_terms(const float* R, const float* pp,
                                                   const float* Ici, float* out) {
  const float m = Ici[0];
  float rh[3], ha[3], RI[9], rot[9];
  mat3_vec(R, Ici + 1, rh);
  for (int k = 0; k < 3; ++k) ha[k] = rh[k] + m * pp[k];
  mat3_mul(R, Ici + 4, RI);
  for (int r = 0; r < 3; ++r)  // (R·I)·Rᵀ
    for (int c = 0; c < 3; ++c)
      rot[3 * r + c] = RI[3 * r] * R[3 * c] + RI[3 * r + 1] * R[3 * c + 1] +
                       RI[3 * r + 2] * R[3 * c + 2];
  // hat(a)·hat(b)ᵀ = (a·b)·I − b·aᵀ
  const float d1 = dot3(pp, rh), d2 = dot3(ha, pp);
  out[0] = m;
  for (int k = 0; k < 3; ++k) out[1 + k] = ha[k];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const float e = r == c ? 1.f : 0.f;
      out[4 + 3 * r + c] = rot[3 * r + c] + (d1 * e - rh[r] * pp[c]) + (d2 * e - pp[r] * ha[c]);
    }
}

// dof r's diagonal of M (armature, dt·damping, dt²·stiffness) and its
// free-motion torque pf[r] from τ and the bias b
template <bool RAND>
__device__ __forceinline__ void jt_diag_row(const SpecView& s, int r, const float* mp, float dt,
                                            const float* tau, const float* v, float b, float* Mrr,
                                            float* pf) {
  if constexpr (RAND) *Mrr += mp[10 * s.nb + r];
  else *Mrr += s.arm[r];
  if (s.springs) {  // (M + dt·C + dt²·K)·Δv = dt·(τ − C·v − dt·K·v − bias)
    const float k = jt_stiffness(s)[r];
    *Mrr += dt * s.damp[r] + dt * dt * k;
    pf[r] = (tau[r] - dt * k * v[r]) - b;
  } else {
    *Mrr += dt * s.damp[r];
    pf[r] = tau[r] - b;
  }
}

// bound t's row (J's row zeroed by the caller, ldj apart)
__device__ __forceinline__ void jt_bound_row(const SpecView& s, int t, int row, const float* q,
                                             float* J, int ldj, float* target, float* active,
                                             float* mu) {
  const float dt = s.scal[JT_S_DT], alpha_b = s.scal[JT_S_ALPHA_B];
  const int i = s.bbody[t];
  const float qj = q[s.q_off[i]];
  const float d_lo = qj - s.blo[t], d_hi = s.bhi[t] - qj;
  const float dist = fminf(d_lo, d_hi);
  J[row * ldj + s.v_off[i]] = d_lo < d_hi ? 1.f : -1.f;
  target[row] = (dist < 0.f ? -alpha_b * dist : -dist) / dt;
  active[row] = 1.f;
  mu[row] = 0.f;
}

// contact jc's rows [t1; t2; n] at row (color order: the site corder[jc];
// J's rows zeroed by the caller, ldj apart), its target, active flag and
// μ; a sphere site at its surface point; with GEN its basis [t1 | t2 | n̂]
// into basis (9)
template <bool GEN>
__device__ __forceinline__ void jt_contact_row(const SpecView& s, int jc, int row,
                                               const float (*xwR)[9], const float (*xwp)[3],
                                               const float* g, int n_gc, float* J, int ldj,
                                               float* target, float* active, float* mu,
                                               float* basis) {
  const float dt = s.scal[JT_S_DT];
  const int k = s.corder[jc], b = s.cbody[k];
  float pt[3], r3[3], col[6];
  mat3_vec(xwR[b], s.cpos + 3 * k, pt);
  for (int e = 0; e < 3; ++e) pt[e] += xwp[b][e];
  if (s.spheres) {  // a sphere site touches at centre − r·n̂, n̂ at the centre's xy
    const float rk = jt_radii(s)[k];
    if (rk > 0.f) {
      if constexpr (GEN) {
        float hg[3];
        jt_ground_query(s, g, n_gc, pt[0], pt[1], hg);
        const float inv = rsqrtf(hg[1] * hg[1] + hg[2] * hg[2] + 1.f);
        pt[0] += rk * hg[1] * inv;
        pt[1] += rk * hg[2] * inv;
        pt[2] -= rk * inv;
      } else {
        pt[2] -= rk;
      }
    }
  }
  float h_gen = 0.f;
  if constexpr (GEN) h_gen = jt_contact_basis(s, g, n_gc, pt, basis);
  // point Jacobian, written as the rows [t1; t2; n]·J_p: on flat ground
  // [−J_y; J_x; J_z]
  for (int j = b; j >= 0; j = s.parent[j]) {
    const int jt = s.jtype[j], vo = s.v_off[j];
    for (int e = 0; e < 3; ++e) r3[e] = pt[e] - xwp[j][e];
    for (int c = 0; c < joint_nv(jt); ++c) {
      float wc[3], vc[3], wr[3], lin[3];
      subspace_col(jt, s.body + JT_BODY_F * j, c, col);
      mat3_vec(xwR[j], col, wc);
      mat3_vec(xwR[j], col + 3, vc);
      cross3(wc, r3, wr);
      for (int e = 0; e < 3; ++e) lin[e] = vc[e] + wr[e];
      if constexpr (GEN) {
        for (int e = 0; e < 3; ++e) J[(row + e) * ldj + vo + c] = dot3(basis + 3 * e, lin);
      } else {
        J[row * ldj + vo + c] = -lin[1];
        J[(row + 1) * ldj + vo + c] = lin[0];
        J[(row + 2) * ldj + vo + c] = lin[2];
      }
    }
  }
  // penetrating → Baumgarte push-back; hovering within the margin → may
  // approach the surface but not cross it
  const float depth = (GEN ? h_gen : s.scal[JT_S_GROUND]) - pt[2];
  const float corr = depth > 0.f
      ? fminf(fmaxf(s.scal[JT_S_ALPHA_C_DT] * (depth - s.scal[JT_S_SLOP]), 0.f),
              s.scal[JT_S_MAX_CORR])
      : depth / dt;
  const float act = depth > -s.scal[JT_S_MARGIN] ? 1.f : 0.f;
  const float friction = s.scal[JT_S_FRICTION];
  for (int e = 0; e < 3; ++e) {
    target[row + e] = e == 2 ? corr : 0.f;
    active[row + e] = act;
    mu[row + e] = friction;
  }
}

// contact jc's world impulse in the original contact order: t1·λ₀ + t2·λ₁
// + n·λ₂ of its rows at row (basis: its GEN basis)
template <bool GEN>
__device__ __forceinline__ void jt_contact_impulse(const SpecView& s, int jc, int row,
                                                   const float* lam, const float* basis,
                                                   float* fc) {
  const int k = s.corder[jc];
  if constexpr (GEN) {
    for (int e = 0; e < 3; ++e)
      fc[3 * k + e] = basis[e] * lam[row] + basis[3 + e] * lam[row + 1] +
                      basis[6 + e] * lam[row + 2];
  } else {
    fc[3 * k] = lam[row + 1];
    fc[3 * k + 1] = -lam[row];
    fc[3 * k + 2] = lam[row + 2];
  }
}

// symplectic Euler of joint i: q ⊕ v⁺·dt (the quaternions of FREE and
// SPHERICAL joints by the exponential of the local increment)
__device__ __forceinline__ void jt_integrate_joint(const SpecView& s, int i, const float* q,
                                                   const float* v_next, float dt,
                                                   float* q_next) {
  const int qo = s.q_off[i], vo = s.v_off[i], jt = s.jtype[i];
  float w[3];
  if (jt == JT_FREE) {
    float R[9], dv[3], dp[3];
    quat_to_m(q + qo + 3, R);
    for (int k = 0; k < 3; ++k) dv[k] = v_next[vo + k] * dt;
    mat3_vec(R, dv, dp);
    for (int k = 0; k < 3; ++k) q_next[qo + k] = q[qo + k] + dp[k];
    for (int k = 0; k < 3; ++k) w[k] = v_next[vo + 3 + k] * dt;
    jt_quat_step(q + qo + 3, w, q_next + qo + 3);
  } else if (jt == JT_SPHERICAL) {
    for (int k = 0; k < 3; ++k) w[k] = v_next[vo + k] * dt;
    jt_quat_step(q + qo, w, q_next + qo);
  } else if (jt == JT_REVOLUTE || jt == JT_PRISMATIC) {
    q_next[qo] = q[qo] + v_next[vo] * dt;
  }
}

// ---- the sensor stage (counterpart of `_sensor_stage`, the plain version
// being ops/substep_kernel.py `sensor_stage_reference`, i.e.
// hardware/sensors.py `SensorSuite.update`)
//
// Packed suite (ops/substep_kernel.py `SensorKernelSpec.packed`):
//   ints:   per body what the readings need of it (JT_NEED_ROTATION: its
//           world rotation; JT_NEED_MOTION: its velocity and proper
//           acceleration too; 0: nothing), per group [type, ns, buf_len,
//           first sensor], then per sensor
//           two ints: imu (body, offset of its floats), encoder and effort
//           (q offset, v offset), contact (contact index, body);
//   floats: per IMU, its frame's rotation in the body (9, row-major) and
//           position (3).
// The ring buffers stay in global memory: each env's row of bufs_out
// (n_buf floats, [group][sensor][slot][dim]) is a copy of its row of
// bufs_in, shifted in place at each push; each update reads its eps
// straight from global memory.
enum { JT_IMU = 0, JT_ENCODER = 1, JT_EFFORT = 2, JT_CONTACT = 3 };
enum { JT_NEED_ROTATION = 1, JT_NEED_MOTION = 2 };

struct SensParams {
  const int* gi;
  const float* gf;
  const float* bufs_in;  // (B, n_buf)
  const float* eps;      // (B, n_sub / k_obs · n_eps)
  float* bufs_out;       // (B, n_buf)
  int n_groups, n_buf, n_eps, k_obs;
};

__device__ __forceinline__ int jt_sensor_dim(int type) {
  return type == JT_IMU ? 10 : type == JT_ENCODER ? 2 : type == JT_EFFORT ? 1 : 3;
}

__device__ __forceinline__ int jt_noise_dim(int type) { return type == JT_IMU ? 9 : jt_sensor_dim(type); }

// so3.matrix_to_quat: the candidate of the largest of (m00, m11, m22,
// trace), the first of equal maxima; normalized; w ≥ 0 (w = 0 positive)
__device__ __forceinline__ void jt_matrix_to_quat(const float* R, float* out) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  float q[4] = {1.f + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12};
  float best = m00;
  if (m11 > best) {
    best = m11;
    q[0] = m01 + m10; q[1] = 1.f - m00 + m11 - m22; q[2] = m12 + m21; q[3] = m02 - m20;
  }
  if (m22 > best) {
    best = m22;
    q[0] = m02 + m20; q[1] = m12 + m21; q[2] = 1.f - m00 - m11 + m22; q[3] = m10 - m01;
  }
  if (tr > best) {
    q[0] = m21 - m12; q[1] = m02 - m20; q[2] = m10 - m01; q[3] = 1.f + tr;
  }
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-12f);
  const float sgn = q[3] >= 0.f ? 1.f : -1.f;
  for (int k = 0; k < 4; ++k) out[k] = q[k] / n * sgn;
}

// One body of a sensor update (its parent's done), at the accepted state
// (q, v⁺ = v, v of the substep's start v0, so a = Δv/dt): its world
// rotation, and with JT_NEED_MOTION its velocity and proper acceleration
// from a0 = [0; −g] (algos.body_accelerations)
__device__ __forceinline__ void jt_sensor_body(const SpecView& s, int i, int need, const float* q,
                                               const float* v, const float* v0, float (*xwR)[9],
                                               float (*vel)[6], float (*acc)[6]) {
  float Rl[9], pl[3], Rj[9], pj[3], t6[6], u6[6], vj[6], aj[6], ad[6];
  const float dt = s.scal[JT_S_DT];
  const int p = s.parent[i];
  if (!(need & JT_NEED_MOTION)) {  // the rotation alone
    jt_joint_transform(s, i, q, Rj, pj);
    mat3_mul(s.body + JT_BODY_F * i + 3, Rj, Rl);
    if (p < 0) for (int k = 0; k < 9; ++k) xwR[i][k] = Rl[k];
    else mat3_mul(xwR[p], Rl, xwR[i]);
    return;
  }
  jt_local_pose(s, i, q, Rl, pl);
  joint_motion(s, i, v, vj);
  const int vo = s.v_off[i], nvj = joint_nv(s.jtype[i]);  // the joint's part of a = Δv/dt
#pragma unroll
  for (int k = 0; k < 6; ++k) {  // constant indices: ad stays in registers
    if (k < nvj) ad[k] = (v[vo + k] - v0[vo + k]) / dt;
    else ad[k] = 0.f;
  }
  joint_motion_of(s, i, ad, aj);
  if (p < 0) {
    const float a0[6] = {0.f, 0.f, 0.f, -s.scal[JT_S_GX], -s.scal[JT_S_GY], -s.scal[JT_S_GZ]};
    for (int k = 0; k < 9; ++k) xwR[i][k] = Rl[k];
    motion_p2c(Rl, pl, a0, t6);
    for (int k = 0; k < 6; ++k) {
      vel[i][k] = vj[k];
      acc[i][k] = t6[k] + aj[k];
    }
  } else {
    mat3_mul(xwR[p], Rl, xwR[i]);
    motion_p2c(Rl, pl, vel[p], t6);
    for (int k = 0; k < 6; ++k) vel[i][k] = t6[k] + vj[k];
    motion_p2c(Rl, pl, acc[p], t6);
    motion_cross(vel[i], vj, u6);
    for (int k = 0; k < 6; ++k) acc[i][k] = t6[k] + aj[k] + u6[k];
  }
}

// One sensor's reading + its eps e into row (its type's dim), from the
// bodies' rotations, velocities and accelerations (jt_sensor_body), the
// accepted q, v, the applied τ and the world impulses fc (3·ncp) → forces
// fc/dt; T: the sensor's two packed ints
__device__ __forceinline__ void jt_sensor_measure(const SpecView& s, const SensParams& sp,
                                                  int type, const int* T, const float* e,
                                                  const float* q, const float* v, const float* tau,
                                                  const float* fc, const float (*xwR)[9],
                                                  const float (*vel)[6], const float (*acc)[6],
                                                  float* row) {
  const float dt = s.scal[JT_S_DT];
  if (type == JT_IMU) {
    const int b = T[0];
    const float* Rfp = sp.gf + T[1];
    const float* pfp = Rfp + 9;
    float Rw[9], qt[4], c1[3], c2[3], c3[3], c4[3], apt[3];
    mat3_mul(xwR[b], Rfp, Rw);
    jt_matrix_to_quat(Rw, qt);
    jt_quat_turn(qt, e, row);
    const float* w = vel[b];
    // a_lin + ω×v_lin + α×p + ω×(ω×p): proper acceleration of the
    // frame origin in body coordinates
    cross3(w, vel[b] + 3, c1);
    cross3(acc[b], pfp, c2);
    cross3(w, pfp, c3);
    cross3(w, c3, c4);
    for (int d = 0; d < 3; ++d) apt[d] = acc[b][3 + d] + c1[d] + c2[d] + c4[d];
    mat3t_vec(Rfp, w, row + 4);
    mat3t_vec(Rfp, apt, row + 7);
    for (int d = 0; d < 6; ++d) row[4 + d] += e[3 + d];
  } else if (type == JT_ENCODER) {
    row[0] = q[T[0]] + e[0];
    row[1] = v[T[1]] + e[1];
  } else if (type == JT_EFFORT) {
    row[0] = tau[T[1]] + e[0];
  } else {  // contact: world force → the carrier body's frame
    const float f[3] = {fc[3 * T[0]] / dt, fc[3 * T[0] + 1] / dt, fc[3 * T[0] + 2] / dt};
    mat3t_vec(xwR[T[1]], f, row);
    for (int d = 0; d < 3; ++d) row[d] += e[d];
  }
}

// Largest sizes any instantiation takes (ops/substep_kernel.py MAX_* and
// NQ_EXTRA check them before a launch too).
#define JT_SUB_MAX_N 32
#define JT_SUB_MAX_NC 48
#define JT_SUB_MAX_NB 32

#include "substep_warp.cuh"

// the sensor stage's (ops/substep_kernel.py MAX_SENS_*)
#define JT_SENS_MAX_GROUPS 8
#define JT_SENS_MAX_BUF 4096
#define JT_SENS_MAX_EPS 1024

extern "C" const char* jt_substep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// n_mp_min: the narrowest model-parameter row the kernel reads (K3:
// 10·nb + nv; K2: with the motor tail); this library takes the model
// parameters if and only if it holds the RAND instantiations. The layout
// must be the one the kernel writes its rows in: n_dist single-row
// equality blocks (0, 1), …, (n_dist − 1, 1), then the bounds span at
// n_dist, then the contact colors covering every row after the bounds
// (the packed spec's pair generators write the last ones; SubstepSpec
// checks their counts against the pair colors when it packs).
static int jt_check_dims(int B, int nb, int nq, int nv, int nc, int n_dist, int nm,
                         int iters, const float* gc, int n_gc, const float* mp,
                         int n_mp, int n_mp_min, const int* layout, int layout_len,
                         BlockLayout* lay) {
  if (B < 0 || nb < 1 || nv < 1 || nc < 1 || nm < 0 || iters < 0 ||
      nb > JT_SUB_MAX_NB || nv > JT_SUB_MAX_N || nc > JT_SUB_MAX_NC ||
      nq < nv || nq > nv + JT_NQ_EXTRA || nm > nv || n_gc < 0 || n_gc > JT_GC_MAX ||
      (n_gc > 0) != (gc != nullptr) || (mp != nullptr) != JT_RAND ||
      (JT_RAND ? n_mp < n_mp_min : n_mp != 0) || n_dist < 0 || n_dist > nc)
    return (int)cudaErrorInvalidValue;
  const int err = jt_parse_layout(layout, layout_len, nc, lay);
  if (err != (int)cudaSuccess) return err;
  bool ok = lay->n_eq == n_dist && (lay->bounds_size == 0 || lay->bounds_start == n_dist);
  for (int e = 0; e < lay->n_eq; ++e) ok = ok && lay->eq[e][0] == e && lay->eq[e][1] == 1;
  int color_rows = 0;
  for (int g = 0; g < lay->n_colors; ++g) {
    ok = ok && lay->colors[g][0] >= n_dist + lay->bounds_size;
    color_rows += 3 * lay->colors[g][1];
  }
  ok = ok && n_dist + lay->bounds_size + color_rows == nc;
  return ok ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// K3. si/sf: the packed spec; n_dist its distance rows (the header's);
// wrench (B, 6); fc (B, 3·ncp); gc (B, n_gc) the ground coefficients (null,
// 0 on flat ground); mp (B, n_mp) the model parameters (null, 0 in the
// nominal library; required in the randomized one); wl (wl_len ints) the
// warp body's workspace layout, K2's without the sensor stage
// (ops/substep_kernel.py `SubstepSpec.warp_workspace`), checked: a missing
// or bad layout, or a PGS group wider than a warp, is refused and nothing
// falls back.
extern "C" int jt_substep(
    const int* si, const float* sf, const float* q, const float* v,
    const float* tau, const float* lam0, const float* wrench, float* q_out,
    float* v_out, float* lam_out, float* res, float* fc, int B, int nb,
    int nq, int nv, int nc, int n_dist, const float* gc, int n_gc, const float* mp,
    int n_mp, const int* wl, int wl_len, const int* layout, int layout_len, int iters, float dt,
    float relax, float reg, int compute_residual, void* stream) {
  BlockLayout lay;
  int err = jt_check_dims(B, nb, nq, nv, nc, n_dist, 0, iters, gc, n_gc, mp, n_mp,
                          10 * nb + nv, layout, layout_len, &lay);
  if (err != (int)cudaSuccess) return err;
  WarpLayout w;  // K3 reads no command: nm 0
  err = jt_check_warp_layout(wl, wl_len, nb, nq, nv, nc, 0, n_gc, false, lay, &w);
  if (err != (int)cudaSuccess) return err;
  if (B == 0) return (int)cudaSuccess;
  const SolveParams prm = {B, nv, nc, iters, compute_residual, dt, relax, reg};
  const int W = w.o[JT_WL_W], stride = w.o[JT_WL_STRIDE];
  const cudaStream_t s = (cudaStream_t)stream;
  return n_gc ? jt_warp_launch(substep_warp_kernel<true, JT_RAND>, B, W, stride, s, si, sf, q, v,
                               tau, lam0, wrench, q_out, v_out, lam_out, res, fc, gc, n_gc, mp,
                               n_mp, prm, lay, w)
              : jt_warp_launch(substep_warp_kernel<false, JT_RAND>, B, W, stride, s, si, sf, q, v,
                               tau, lam0, wrench, q_out, v_out, lam_out, res, fc, gc, n_gc, mp,
                               n_mp, prm, lay, w);
}

// K2 in its four instantiations of this library (sensor stage or not,
// analytic ground or flat; JT_RAND fixed), every model on the warp body
// with the workspace layout wl (checked; a missing or bad layout, or a PGS
// group wider than a warp, is refused: nothing falls back).
template <bool SENS>
static int jt_multi_launch(
    const int* si, const float* sf, const float* q, const float* v,
    const float* cmd, const float* lam0, const float* wrench, float* q_out,
    float* v_out, float* lam_out, float* res, float* fc, float* a_out,
    float* tau_out, int B, int n_sub, int nb, int nq, int nv, int nc, int n_dist,
    int nm, const float* gc, int n_gc, const float* mp, int n_mp, const SensParams& sp,
    const int* wl, int wl_len, const int* layout, int layout_len, int iters, float dt,
    float relax, float reg, int compute_residual, void* stream) {
  BlockLayout lay;
  int err = jt_check_dims(B, nb, nq, nv, nc, n_dist, nm, iters, gc, n_gc, mp, n_mp,
                          10 * nb + nv + 2 * nm, layout, layout_len, &lay);
  if (err != (int)cudaSuccess) return err;
  if (n_sub < 1) return (int)cudaErrorInvalidValue;
  WarpLayout w;
  err = jt_check_warp_layout(wl, wl_len, nb, nq, nv, nc, nm, n_gc, SENS, lay, &w);
  if (err != (int)cudaSuccess) return err;
  if (B == 0) return (int)cudaSuccess;
  const SolveParams prm = {B, nv, nc, iters, compute_residual, dt, relax, reg};
  const int W = w.o[JT_WL_W], stride = w.o[JT_WL_STRIDE];
  const cudaStream_t s = (cudaStream_t)stream;
  return n_gc ? jt_warp_launch(substep_multi_warp_kernel<SENS, true, JT_RAND>, B, W, stride, s, si,
                               sf, q, v, cmd, lam0, wrench, q_out, v_out, lam_out, res, fc, a_out,
                               tau_out, n_sub, gc, n_gc, mp, n_mp, prm, lay, sp, w)
              : jt_warp_launch(substep_multi_warp_kernel<SENS, false, JT_RAND>, B, W, stride, s,
                               si, sf, q, v, cmd, lam0, wrench, q_out, v_out, lam_out, res, fc,
                               a_out, tau_out, n_sub, gc, n_gc, mp, n_mp, prm, lay, sp, w);
}

// K2. cmd (B, nm); a and tau (B, nv) of the last substep; gc and mp as
// for K3, mp with the motor tail; wl (wl_len ints) the warp body's
// workspace layout (ops/substep_kernel.py `SubstepSpec.warp_workspace`).
extern "C" int jt_substep_multi(
    const int* si, const float* sf, const float* q, const float* v,
    const float* cmd, const float* lam0, const float* wrench, float* q_out,
    float* v_out, float* lam_out, float* res, float* fc, float* a_out,
    float* tau_out, int B, int n_sub, int nb, int nq, int nv, int nc, int n_dist,
    int nm, const float* gc, int n_gc, const float* mp, int n_mp, const int* wl, int wl_len,
    const int* layout, int layout_len, int iters, float dt, float relax, float reg,
    int compute_residual, void* stream) {
  const SensParams sp = {nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 1};
  return jt_multi_launch<false>(si, sf, q, v, cmd, lam0, wrench, q_out, v_out, lam_out, res, fc,
                                a_out, tau_out, B, n_sub, nb, nq, nv, nc, n_dist, nm, gc,
                                n_gc, mp, n_mp, sp, wl, wl_len, layout, layout_len, iters, dt,
                                relax, reg, compute_residual, stream);
}

// K2 with the sensor stage. gi/gf: the packed suite; bufs_in, bufs_out
// (B, n_buf); eps (B, n_sub / k_obs · n_eps); gc, mp and wl as for K2.
extern "C" int jt_substep_multi_sensors(
    const int* si, const float* sf, const float* q, const float* v,
    const float* cmd, const float* lam0, const float* wrench, float* q_out,
    float* v_out, float* lam_out, float* res, float* fc, float* a_out,
    float* tau_out, const int* gi, const float* gf, const float* bufs_in,
    const float* eps, float* bufs_out, int B, int n_sub, int nb, int nq,
    int nv, int nc, int n_dist, int nm, int n_groups, int n_buf, int n_eps, int k_obs,
    const float* gc, int n_gc, const float* mp, int n_mp, const int* wl, int wl_len,
    const int* layout, int layout_len, int iters, float dt, float relax, float reg,
    int compute_residual, void* stream) {
  if (n_sub < 1 || k_obs < 1 || n_sub % k_obs != 0 || n_groups < 1 ||
      n_groups > JT_SENS_MAX_GROUPS || n_buf < 1 || n_buf > JT_SENS_MAX_BUF ||
      n_eps < 1 || n_eps > JT_SENS_MAX_EPS)
    return (int)cudaErrorInvalidValue;
  const SensParams sp = {gi, gf, bufs_in, eps, bufs_out, n_groups, n_buf, n_eps, k_obs};
  return jt_multi_launch<true>(si, sf, q, v, cmd, lam0, wrench, q_out, v_out, lam_out, res, fc,
                               a_out, tau_out, B, n_sub, nb, nq, nv, nc, n_dist, nm, gc,
                               n_gc, mp, n_mp, sp, wl, wl_len, layout, layout_len, iters, dt,
                               relax, reg, compute_residual, stream);
}
