// K3 and K2 for Hopper: one warp per env, the env's working set in shared
// memory. Included by substep.cuh (both libraries), after the per-item
// pieces of a substep, which it runs across its lanes.
//
// One body, `jt_warp_substep`, is the substep of both kernels: K2
// (`substep_multi_warp_kernel`) runs it n_sub times with τ computed
// in-kernel before each, K3 (`substep_warp_kernel`) once with τ given.
// Every launch of either runs it, in every SENS / GEN / RAND instantiation
// and for every model inside the kernels' caps (nb ≤ 32, nv ≤ 32, nc ≤ 48:
// JT_SUB_MAX_*): the ANYmal frame (ANYmal, Ant, Spotmicro, the toys) and
// the large frame (Cassie with its self-collision pairs and flexible hips,
// the PRISMATIC slab scene) alike. Operations bound it, as substep.cuh's
// note counts them. The plain versions (ops/substep_kernel.py
// `substep_multi_reference` and `substep_reference`) are the yardstick;
// the arithmetic follows them step for step, save the equality rows' dot
// in the PGS, a fixed xor tree across the lanes (jt_warp_sum). Every
// reduction has a fixed order and nothing is atomic, so the kernels are
// deterministic and agree bit for bit: the sensor variant steps as K2
// does, n_sub substeps in one launch equal n_sub launches of one, and K3
// given K2's applied τ equals K2 at n_sub = 1.
//
// Grid: W envs (warps) per block (ops/substep_kernel.py
// `SubstepSpec.warp_workspace` picks W ≤ JT_WARP_MAX_W; K3 takes K2's
// layout without the sensor stage), ⌈B / W⌉ blocks; a
// warp past B returns whole. Workspace: each env's slice of the block's
// dynamic shared memory, laid out from the model's own sizes, not the
// caps (WarpLayout; the C entry checks it, jt_check_warp_layout): the
// carried state (q, v twice, τ, λ, the command, the wrench, the impulses,
// the ground's coefficients), the substep's M (L factored in its place,
// the diagonal apart), J and the rows' vectors, and one union that holds
// in turn the tree passes' body arrays, the chain's X = M⁻¹[p | Jᵀ] and
// Delassus A, and the sensor stage's body arrays and readings. Row strides
// are odd (no two lanes of a column walk on one bank). Bytes per env:
// ANYmal 8,752, Cassie 11,072, with self-collision 15,168, flexible
// 13,840, the slab 13,792; W = 4 for each. Registers (the launch bounds'
// 128) hold an SM to 16 warps; shared memory holds it to 12 at nc 37–43
// and to 8 at nc 46 (Cassie's self-collision, its ptbox and ptseg sets).
//
// Lanes, stage by stage, __syncwarp() between: τ across the motors and
// dofs; local poses across the bodies, then FK with RNEA's forward pass and
// RNEA's backward pass with CRBA's composite inertias by depth (the bodies
// of one depth across the lanes; a parent sums its children's terms in
// decreasing body order); M's rows and columns
// across the bodies; the diagonal terms across the dofs; the row items
// (distance constraints, bounds, ground contacts, then each pair contact
// at its own fixed rows, jt_pair_item) across the lanes; the chain
// (jt_warp_chain, solve_chain.cuh); the impulses across the contacts and Euler across the
// joints; the sensor stage's bodies by depth, its readings across the
// sensors and its delay lines across their columns (the rings stay in
// global memory). A stage with more items than lanes (the row items; X's
// nc + 1 right-hand sides; A's nc columns with their rows' setup; the
// residual) gives lane l the items l, l + 32, …; the equality rows' dot
// sums each lane's own entries in that order before the xor tree. Each PGS
// group stays one row per lane: the C entry refuses a bounds span or a
// color wider than a warp (a span has at most nv rows, a color at most
// nc / 3 contacts).
//
// JT_WARP_STAGES builds count the cycles of each stage (clock64, summed
// over every env's warp) for tools/profile_warp_stages.py.

#pragma once

#define JT_CC 19                  // per body: the force (6) and inertia (13) it adds to its parent

// The layout (ops/substep_kernel.py `_WARP_SLOTS`): W, the env's stride
// and the sizes the host cannot read from the packed spec or suite, the
// row strides, then the offset (floats, from the env's slice) of each
// region; JT_WL_U opens the union, whose three views follow it.
enum {
  JT_WL_W = 0, JT_WL_STRIDE, JT_WL_NCP, JT_WL_NROWS, JT_WL_LDM, JT_WL_LDJ, JT_WL_LDX, JT_WL_LDA,
  JT_WL_Q0, JT_WL_Q1, JT_WL_V0, JT_WL_V1, JT_WL_TAU, JT_WL_LAM, JT_WL_CMD, JT_WL_W0, JT_WL_FC,
  JT_WL_G,
  JT_WL_M, JT_WL_DL, JT_WL_PF, JT_WL_J, JT_WL_TGT, JT_WL_MU, JT_WL_ACT, JT_WL_BASIS, JT_WL_RHS,
  JT_WL_DG, JT_WL_VF,
  JT_WL_U,
  JT_WL_XLR, JT_WL_XLP, JT_WL_XWR, JT_WL_XWP, JT_WL_VEL, JT_WL_ACC, JT_WL_FRC, JT_WL_IC, JT_WL_CC,
  JT_WL_X, JT_WL_A,
  JT_WL_SXWR, JT_WL_SVEL, JT_WL_SACC, JT_WL_ROWS,
  JT_WL_LEN
};

struct WarpLayout {
  int o[JT_WL_LEN];
};

// Each region's size in floats for the dims, SENS and GEN (0: absent); the
// union's is up to the stride.
static void jt_warp_sizes(const WarpLayout& w, int nb, int nq, int nv, int nc, int nm, int n_gc,
                          bool sens, int* size) {
  const int* o = w.o;
  const int ncp = o[JT_WL_NCP], sb = sens ? nb : 0;
  for (int r = 0; r < JT_WL_LEN; ++r) size[r] = 0;
  size[JT_WL_Q0] = size[JT_WL_Q1] = nq;
  size[JT_WL_V0] = size[JT_WL_V1] = size[JT_WL_TAU] = nv;
  size[JT_WL_LAM] = nc;
  size[JT_WL_CMD] = nm;
  size[JT_WL_W0] = 6;
  size[JT_WL_FC] = 3 * ncp;
  size[JT_WL_G] = n_gc;
  size[JT_WL_M] = nv * o[JT_WL_LDM];
  size[JT_WL_DL] = size[JT_WL_PF] = size[JT_WL_VF] = nv;
  size[JT_WL_J] = nc * o[JT_WL_LDJ];
  size[JT_WL_TGT] = size[JT_WL_MU] = size[JT_WL_ACT] = size[JT_WL_RHS] = size[JT_WL_DG] = nc;
  size[JT_WL_BASIS] = n_gc > 0 ? 9 * ncp : 0;
  size[JT_WL_U] = o[JT_WL_STRIDE] - o[JT_WL_U];
  size[JT_WL_XLR] = size[JT_WL_XWR] = 9 * nb;
  size[JT_WL_XLP] = size[JT_WL_XWP] = 3 * nb;
  size[JT_WL_VEL] = size[JT_WL_ACC] = size[JT_WL_FRC] = 6 * nb;
  size[JT_WL_IC] = 13 * nb;
  size[JT_WL_CC] = JT_CC * nb;
  size[JT_WL_X] = nv * o[JT_WL_LDX];
  size[JT_WL_A] = nc * o[JT_WL_LDA];
  size[JT_WL_SXWR] = 9 * sb;
  size[JT_WL_SVEL] = size[JT_WL_SACC] = 6 * sb;
  size[JT_WL_ROWS] = sens ? o[JT_WL_NROWS] : 0;
}

// Host side: the layout from its ints into w, checked against the dims
// and the PGS layout lay: the dims within the caps and every PGS group
// (the bounds span, each color) no wider than a warp, W envs of `stride`
// floats fit a block, every offset is 16-byte aligned, every region lies
// inside its env's slice (a view of the union inside the union), and no
// two regions live at one time overlap (the regions outside the union with
// each other and with it; within each view of the union). Returns
// cudaSuccess or cudaErrorInvalidValue.
static int jt_check_warp_layout(const int* wl, int wl_len, int nb, int nq, int nv, int nc, int nm,
                                int n_gc, bool sens, const BlockLayout& lay, WarpLayout* w) {
  if (wl == nullptr || wl_len != JT_WL_LEN) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < JT_WL_LEN; ++r) w->o[r] = wl[r];
  const int* o = w->o;
  const int stride = o[JT_WL_STRIDE], u = o[JT_WL_U];
  if (!jt_block_fits(o[JT_WL_W], stride) || o[JT_WL_NCP] < 0 || 3 * o[JT_WL_NCP] > nc ||
      o[JT_WL_NROWS] < 0 || (o[JT_WL_NROWS] > 0) != sens || o[JT_WL_LDM] < nv ||
      o[JT_WL_LDJ] < nv || o[JT_WL_LDX] < nc + 1 || o[JT_WL_LDA] < nc || nb > JT_SUB_MAX_NB ||
      nv > JT_SUB_MAX_N || nc > JT_SUB_MAX_NC || !jt_groups_fit_warp(lay))
    return (int)cudaErrorInvalidValue;
  int size[JT_WL_LEN];
  jt_warp_sizes(*w, nb, nq, nv, nc, nm, n_gc, sens, size);
  const bool ok = jt_regions_ok(o, size, JT_WL_Q0, JT_WL_U, 0, stride) &&
                  jt_regions_ok(o, size, JT_WL_XLR, JT_WL_CC, u, stride) &&
                  jt_regions_ok(o, size, JT_WL_X, JT_WL_A, u, stride) &&
                  jt_regions_ok(o, size, JT_WL_SXWR, JT_WL_ROWS, u, stride);
  return ok ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// CRBA at body i, its composite inertia Ic complete: its dofs' rows and
// columns of M (row stride ldm), one column of F = Ic·Sᵢ at a time carried
// up the chain
__device__ __forceinline__ void jt_crba_cols(const SpecView& s, int i, const float (*xlR)[9],
                                             const float (*xlp)[3], const float* Ic, float* M,
                                             int ldm) {
  const int jt = s.jtype[i], vo_i = s.v_off[i], nvi = joint_nv(jt);
  const float* axis_i = s.body + JT_BODY_F * i;
  float col[6], F[6], t6[6];
  for (int a = 0; a < nvi; ++a) {
    subspace_col(jt, axis_i, a, col);
    inertia_mul(Ic[0], Ic + 1, Ic + 4, col, F);
    for (int b = 0; b < nvi; ++b) {
      subspace_col(jt, axis_i, b, col);
      float d = 0.f;
      for (int k = 0; k < 6; ++k) d += col[k] * F[k];
      M[(vo_i + b) * ldm + vo_i + a] = d;
    }
    for (int j = i; s.parent[j] >= 0;) {
      force_c2p(xlR[j], xlp[j], F, t6);
      for (int k = 0; k < 6; ++k) F[k] = t6[k];
      j = s.parent[j];
      const int jtj = s.jtype[j], vo_j = s.v_off[j];
      for (int b = 0; b < joint_nv(jtj); ++b) {
        subspace_col(jtj, s.body + JT_BODY_F * j, b, col);
        float d = 0.f;
        for (int k = 0; k < 6; ++k) d += F[k] * col[k];
        M[(vo_i + a) * ldm + vo_j + b] = d;
        M[(vo_j + b) * ldm + vo_i + a] = d;
      }
    }
  }
}


#define JT_W(region) (ws + wl.o[JT_WL_##region])

// ---- one substep of one env on its warp (the counterpart of
// `_substep_math`), K3's and K2's: q, v, tau, w0, g (GEN, n_gc wide) in the
// workspace; mp the env's model parameters (RAND); → q_next, v_next, λ in
// place, the impulses in the workspace's fc; dep: the depth of the lane's
// body (−1 past nb), maxd the deepest
template <bool GEN, bool RAND>
__device__ __forceinline__ float jt_warp_substep(int lane, int dep, int maxd, const SpecView& s,
                                                 float* ws, const WarpLayout& wl, const float* q,
                                                 const float* v, int n_gc, const float* mp,
                                                 float* q_next, float* v_next,
                                                 const SolveParams& prm, const BlockLayout& lay,
                                                 JtStages& st) {
  const int nb = s.nb, nv = s.nv, nc = prm.nc;
  const float dt = s.scal[JT_S_DT];
  const int ldm = wl.o[JT_WL_LDM], ldj = wl.o[JT_WL_LDJ];
  const float* tau = JT_W(TAU);
  float *M = JT_W(M), *J = JT_W(J), *pf = JT_W(PF);
  float *tgt = JT_W(TGT), *mu = JT_W(MU), *act = JT_W(ACT), *basis = JT_W(BASIS);
  auto xlR = reinterpret_cast<float (*)[9]>(JT_W(XLR));
  auto xlp = reinterpret_cast<float (*)[3]>(JT_W(XLP));
  auto xwR = reinterpret_cast<float (*)[9]>(JT_W(XWR));
  auto xwp = reinterpret_cast<float (*)[3]>(JT_W(XWP));
  auto vel = reinterpret_cast<float (*)[6]>(JT_W(VEL));
  auto acc = reinterpret_cast<float (*)[6]>(JT_W(ACC));
  auto frc = reinterpret_cast<float (*)[6]>(JT_W(FRC));
  auto Ic = reinterpret_cast<float (*)[13]>(JT_W(IC));
  auto cc = reinterpret_cast<float (*)[JT_CC]>(JT_W(CC));

  // ---- M and J zeroed; local poses and the inertials across the bodies
  for (int k = lane; k < nv * ldm; k += 32) M[k] = 0.f;
  for (int k = lane; k < nc * ldj; k += 32) J[k] = 0.f;
  if (lane < nb) {
    jt_local_pose(s, lane, q, xlR[lane], xlp[lane]);
    if constexpr (RAND) {
      jt_load_inertial(s, mp, lane, Ic[lane]);
    } else {
      const float* bd = s.body + JT_BODY_F * lane;
      for (int k = 0; k < 13; ++k) Ic[lane][k] = bd[15 + k];  // mass, h, I
    }
  }
  __syncwarp();
  // ---- FK and RNEA's forward pass by depth, the roots first; then the
  // root wrench as fext[0]
  for (int d = 0; d <= maxd; ++d) {
    if (dep == d) {
      jt_fk_body(s, lane, v, xlR, xlp, xwR, xwp, vel);
      jt_rnea_fwd_body(s, lane, v, Ic[lane], xlR, xlp, vel, acc, frc);
    }
    __syncwarp();
  }
  if (lane < 6) frc[0][lane] -= JT_W(W0)[lane];
  __syncwarp();
  st.mark(JT_ST_TREE_FWD);

  // ---- RNEA's backward pass (the bias into pf) and CRBA's composite
  // inertias by depth, the leaves first: what each body adds to its
  // parent, summed by the parent in decreasing body order
  for (int d = maxd; d >= 0; --d) {
    if (dep == d) {
      jt_rnea_bwd_body(s, lane, xlR, xlp, frc[lane], pf, cc[lane]);
      if (s.parent[lane] >= 0) jt_composite_terms(xlR[lane], xlp[lane], Ic[lane], cc[lane] + 6);
    }
    __syncwarp();
    if (d > 0 && dep == d - 1) {
      for (int j = nb - 1; j > lane; --j) {
        if (s.parent[j] != lane) continue;
        for (int k = 0; k < 6; ++k) frc[lane][k] += cc[j][k];
        for (int k = 0; k < 13; ++k) Ic[lane][k] += cc[j][6 + k];
      }
    }
    __syncwarp();
  }
  st.mark(JT_ST_TREE_BWD);

  // ---- M's rows and columns across the bodies
  if (lane < nb) jt_crba_cols(s, lane, xlR, xlp, Ic[lane], M, ldm);
  __syncwarp();
  st.mark(JT_ST_CRBA);

  // ---- the diagonal terms and p = τ − bias across the dofs; the row
  // items across the lanes: distance constraints, bounds and ground
  // contacts, then the pair contacts, each at its own rows (up to nc: the
  // layout jt_check_dims holds makes that the end) on the lanes that follow
  // the others' (item crow + ncp + p on lane (crow + ncp + p) mod 32)
  if (lane < nv) jt_diag_row<RAND>(s, lane, mp, dt, tau, v, pf[lane], &M[lane * ldm + lane], pf);
  const int nd = s.n_dist, crow = nd + s.nbj, prow = crow + 3 * s.ncp;
  const float* g = JT_W(G);
  for (int r = lane; r < crow + s.ncp; r += 32) {
    if (r < nd) {
      const int* bodies = jt_dist_bodies(s) + 2 * r;
      tgt[r] = jt_distance_row(s, xwR, xwp, bodies[0], bodies[1], jt_dist_floats(s) + 8 * r,
                               J + r * ldj);
      act[r] = 1.f;
      mu[r] = 0.f;
    } else if (r < crow) {
      jt_bound_row(s, r - nd, r, q, J, ldj, tgt, act, mu);
    } else {
      const int jc = r - crow;
      jt_contact_row<GEN>(s, jc, crow + 3 * jc, xwR, xwp, g, n_gc, J, ldj, tgt, act, mu,
                          basis + 9 * jc);
    }
  }
  if (s.n_gen > 0)  // the spec's, uniform across the warp
    for (int p = (lane - crow - s.ncp) & 31; prow + 3 * p + 3 <= nc; p += 32)
      jt_pair_item(s, xwR, xwp, p, prow + 3 * p, J, ldj, tgt, act, mu);
  __syncwarp();
  st.mark(JT_ST_ROWS);

  // ---- the chain
  float* lam = JT_W(LAM);
  const float res = jt_warp_chain(lane, M, ldm, JT_W(DL), pf, v, J, ldj, tgt, mu, act, lam,
                                  JT_W(X), wl.o[JT_WL_LDX], JT_W(A), wl.o[JT_WL_LDA], JT_W(RHS),
                                  JT_W(DG), JT_W(VF), v_next, prm, lay, st);

  // ---- world impulses across the contacts; Euler across the joints
  if (lane < s.ncp)
    jt_contact_impulse<GEN>(s, lane, crow + 3 * lane, lam, basis + 9 * lane, JT_W(FC));
  if (lane < nb) jt_integrate_joint(s, lane, q, v_next, dt, q_next);
  __syncwarp();
  st.mark(JT_ST_INTEGRATE);
  return res;
}

// ---- one sensor update of one env on its warp (the counterpart of
// `_sensor_stage`, at the accepted state): the bodies by depth, the
// readings across each group's sensors into the workspace's rows, then the
// delay lines across their columns, each lane shifting its own columns of
// the ring in global memory and writing the new sample at slot 0
__device__ __forceinline__ void jt_warp_sensor_stage(int lane, int dep, int maxd,
                                                     const SpecView& s, const SensParams& sp,
                                                     float* ws, const WarpLayout& wl,
                                                     const float* q, const float* v,
                                                     const float* v0, const float* tau,
                                                     const float* fc, const float* eps,
                                                     float* buf) {
  auto xwR = reinterpret_cast<float (*)[9]>(JT_W(SXWR));
  auto vel = reinterpret_cast<float (*)[6]>(JT_W(SVEL));
  auto acc = reinterpret_cast<float (*)[6]>(JT_W(SACC));
  float* rows = JT_W(ROWS);
  const int need = dep >= 0 ? sp.gi[lane] : 0;
  for (int d = 0; d <= maxd; ++d) {
    if (dep == d && need != 0) jt_sensor_body(s, lane, need, q, v, v0, xwR, vel, acc);
    __syncwarp();
  }
  const int* group = sp.gi + s.nb;
  const int* sensor = group + 4 * sp.n_groups;
  int roff = 0, eoff = 0;
  for (int gidx = 0; gidx < sp.n_groups; ++gidx) {
    const int* G = group + 4 * gidx;
    const int type = G[0], ns = G[1];
    const int dim = jt_sensor_dim(type), ndim = jt_noise_dim(type);
    for (int k = lane; k < ns; k += 32)
      jt_sensor_measure(s, sp, type, sensor + 2 * (G[3] + k), eps + eoff + k * ndim, q, v, tau,
                        fc, xwR, vel, acc, rows + roff + k * dim);
    roff += ns * dim;
    eoff += ns * ndim;
  }
  __syncwarp();
  int boff = 0;
  roff = 0;
  for (int gidx = 0; gidx < sp.n_groups; ++gidx) {
    const int* G = group + 4 * gidx;
    const int ns = G[1], bl = G[2], dim = jt_sensor_dim(G[0]);
    for (int c = lane; c < ns * dim; c += 32) {  // column c: sensor c / dim, its entry c % dim
      const int k = c / dim;
      float* r = buf + boff + k * bl * dim + (c - k * dim);
      for (int slot = bl - 1; slot > 0; --slot) r[slot * dim] = r[(slot - 1) * dim];
      r[0] = rows[roff + c];
    }
    boff += ns * bl * dim;
    roff += ns * dim;
  }
  __syncwarp();
}

// ---- K2, one warp per env: n_sub substeps, (q, v, λ) resident in the
// workspace, τ recomputed per substep; with SENS the sensor stage after
// every k_obs-th substep; with GEN an analytic ground per env; with RAND
// each env's model parameters (mp: B × n_mp), the motor tail scaling τ.
// Launch bounds: JT_WARP_MAX_W warps a block and four blocks an SM, so that
// ptxas keeps a thread to 128 registers and up to 16 warps stay resident
// (as many as the blocks' shared memory lets in).
template <bool SENS, bool GEN, bool RAND>
__global__ void __launch_bounds__(JT_WARP_MAX_W * 32, 16 / JT_WARP_MAX_W) substep_multi_warp_kernel(
    const int* __restrict__ si, const float* __restrict__ sf,
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ cmd, const float* __restrict__ lam0,
    const float* __restrict__ wrench, float* __restrict__ q_out,
    float* __restrict__ v_out, float* __restrict__ lam_out,
    float* __restrict__ res_out, float* __restrict__ fc_out,
    float* __restrict__ a_out, float* __restrict__ tau_out, int n_sub,
    const float* __restrict__ gc, int n_gc, const float* __restrict__ mp, int n_mp,
    SolveParams prm, BlockLayout lay, SensParams sp, WarpLayout wl) {
  extern __shared__ float4 jt_smem[];  // 16-byte aligned
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * wl.o[JT_WL_W] + warp;
  if (b >= prm.B) return;  // the ragged edge, a whole warp at a time
  JtStages st;
  st.start();
  float* ws = reinterpret_cast<float*>(jt_smem) + warp * wl.o[JT_WL_STRIDE];
  const SpecView s = jt_view(si, sf);
  const int nb = s.nb, nq = s.nq, nv = s.nv, nc = prm.nc, nm = s.nm;
  if (s.ncp != wl.o[JT_WL_NCP]) __trap();  // a layout for another spec
  const float* row = RAND ? mp + (size_t)b * n_mp : nullptr;
  const float* mscale = RAND ? row + 10 * nb + nv : nullptr;  // gain | friction scale
  // the depth of the lane's body (−1 past nb) and the deepest
  int dep = -1;
  if (lane < nb) {
    dep = 0;
    for (int j = s.parent[lane]; j >= 0; j = s.parent[j]) ++dep;
  }
  const int maxd = __reduce_max_sync(0xffffffffu, dep);

  float *qs = JT_W(Q0), *qn = JT_W(Q1), *vs = JT_W(V0), *vn = JT_W(V1);
  float *tau = JT_W(TAU), *u = JT_W(CMD), *fc = JT_W(FC);
  for (int k = lane; k < nq; k += 32) qs[k] = q[(size_t)b * nq + k];
  for (int k = lane; k < nv; k += 32) vs[k] = v[(size_t)b * nv + k];
  for (int k = lane; k < nc; k += 32) JT_W(LAM)[k] = lam0[(size_t)b * nc + k];
  for (int k = lane; k < nm; k += 32) u[k] = cmd[(size_t)b * nm + k];
  if (lane < 6) JT_W(W0)[lane] = wrench[6 * (size_t)b + lane];
  if constexpr (GEN)
    for (int k = lane; k < n_gc; k += 32) JT_W(G)[k] = gc[(size_t)b * n_gc + k];
  float* buf = nullptr;
  if constexpr (SENS) {
    int n_rows = 0;
    for (int gidx = 0; gidx < sp.n_groups; ++gidx)
      n_rows += sp.gi[nb + 4 * gidx + 1] * jt_sensor_dim(sp.gi[nb + 4 * gidx]);
    if (n_rows > wl.o[JT_WL_NROWS]) __trap();  // a layout for another suite
    buf = sp.bufs_out + (size_t)b * sp.n_buf;
    for (int k = lane; k < sp.n_buf; k += 32) buf[k] = sp.bufs_in[(size_t)b * sp.n_buf + k];
  }
  __syncwarp();
  st.mark(JT_ST_IO);

  const float dt = s.scal[JT_S_DT];
  float res = 0.f;
  for (int it = 0; it < n_sub; ++it) {
    // ---- τ: the motors across the lanes, then damping, then the springs
    if (lane < nv) tau[lane] = 0.f;
    __syncwarp();
    if (lane < nm) tau[s.mv[lane]] = jt_motor_tau<RAND>(s, lane, qs, vs, u, mscale);
    __syncwarp();
    if (lane < nv) tau[lane] = tau[lane] - s.damp[lane] * vs[lane];
    if (s.springs) {  // the spec's, uniform across the warp
      __syncwarp();
      if (lane < nb) jt_spring_tau(s, lane, qs, tau);
    }
    __syncwarp();
    st.mark(JT_ST_TORQUE);
    res = jt_warp_substep<GEN, RAND>(lane, dep, maxd, s, ws, wl, qs, vs, n_gc, row, qn, vn, prm,
                                     lay, st);
    if (it == n_sub - 1 && lane < nv) {  // the last substep's accepted a and applied τ
      a_out[(size_t)b * nv + lane] = (vn[lane] - vs[lane]) / dt;
      tau_out[(size_t)b * nv + lane] = tau[lane];
    }
    if constexpr (SENS) {
      // the schedule is the same for every env: a uniform branch
      if ((it + 1) % sp.k_obs == 0) {
        const int upd = (it + 1) / sp.k_obs - 1;
        const float* eps = sp.eps + (size_t)b * (n_sub / sp.k_obs) * sp.n_eps + upd * sp.n_eps;
        jt_warp_sensor_stage(lane, dep, maxd, s, sp, ws, wl, qn, vn, vs, tau, fc, eps, buf);
        st.mark(JT_ST_SENSORS);
      }
    }
    float* t = qs;  // the accepted state becomes the next substep's
    qs = qn;
    qn = t;
    t = vs;
    vs = vn;
    vn = t;
    __syncwarp();
    st.mark(JT_ST_IO);
  }
  for (int k = lane; k < nq; k += 32) q_out[(size_t)b * nq + k] = qs[k];
  for (int k = lane; k < nv; k += 32) v_out[(size_t)b * nv + k] = vs[k];
  for (int k = lane; k < nc; k += 32) lam_out[(size_t)b * nc + k] = JT_W(LAM)[k];
  for (int k = lane; k < 3 * s.ncp; k += 32) fc_out[(size_t)b * 3 * s.ncp + k] = fc[k];
  if (lane == 0) res_out[b] = res;
  st.mark(JT_ST_IO);
  st.flush(lane);
}

// ---- K3, one warp per env: one substep with τ (B × nv) given, in K2's
// workspace (its layout without the sensor stage) and through K2's substep
// body; with GEN an analytic ground per env; with RAND each env's model
// parameters (mp: B × n_mp; the inertials and the armature are read, a
// motor tail is not). Its copies in and out are K2's, written out apart:
// shared with K2 through helpers, they slowed K2's sensor instantiations
// by up to 6 % (PERF.md, Findings), so K2's code stays as it was.
template <bool GEN, bool RAND>
__global__ void __launch_bounds__(JT_WARP_MAX_W * 32, 16 / JT_WARP_MAX_W) substep_warp_kernel(
    const int* __restrict__ si, const float* __restrict__ sf,
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ tau, const float* __restrict__ lam0,
    const float* __restrict__ wrench, float* __restrict__ q_out,
    float* __restrict__ v_out, float* __restrict__ lam_out,
    float* __restrict__ res_out, float* __restrict__ fc_out,
    const float* __restrict__ gc, int n_gc, const float* __restrict__ mp, int n_mp,
    SolveParams prm, BlockLayout lay, WarpLayout wl) {
  extern __shared__ float4 jt_smem[];  // 16-byte aligned
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * wl.o[JT_WL_W] + warp;
  if (b >= prm.B) return;  // the ragged edge, a whole warp at a time
  JtStages st;
  st.start();
  float* ws = reinterpret_cast<float*>(jt_smem) + warp * wl.o[JT_WL_STRIDE];
  const SpecView s = jt_view(si, sf);
  const int nb = s.nb, nq = s.nq, nv = s.nv, nc = prm.nc;
  if (s.ncp != wl.o[JT_WL_NCP]) __trap();  // a layout for another spec
  // the depth of the lane's body (−1 past nb) and the deepest
  int dep = -1;
  if (lane < nb) {
    dep = 0;
    for (int j = s.parent[lane]; j >= 0; j = s.parent[j]) ++dep;
  }
  const int maxd = __reduce_max_sync(0xffffffffu, dep);

  float *qs = JT_W(Q0), *qn = JT_W(Q1), *vs = JT_W(V0), *vn = JT_W(V1);
  for (int k = lane; k < nq; k += 32) qs[k] = q[(size_t)b * nq + k];
  for (int k = lane; k < nv; k += 32) vs[k] = v[(size_t)b * nv + k];
  for (int k = lane; k < nv; k += 32) JT_W(TAU)[k] = tau[(size_t)b * nv + k];
  for (int k = lane; k < nc; k += 32) JT_W(LAM)[k] = lam0[(size_t)b * nc + k];
  if (lane < 6) JT_W(W0)[lane] = wrench[6 * (size_t)b + lane];
  if constexpr (GEN)
    for (int k = lane; k < n_gc; k += 32) JT_W(G)[k] = gc[(size_t)b * n_gc + k];
  __syncwarp();
  st.mark(JT_ST_IO);
  const float res = jt_warp_substep<GEN, RAND>(lane, dep, maxd, s, ws, wl, qs, vs, n_gc,
                                               RAND ? mp + (size_t)b * n_mp : nullptr, qn, vn,
                                               prm, lay, st);
  for (int k = lane; k < nq; k += 32) q_out[(size_t)b * nq + k] = qn[k];
  for (int k = lane; k < nv; k += 32) v_out[(size_t)b * nv + k] = vn[k];
  for (int k = lane; k < nc; k += 32) lam_out[(size_t)b * nc + k] = JT_W(LAM)[k];
  for (int k = lane; k < 3 * s.ncp; k += 32) fc_out[(size_t)b * 3 * s.ncp + k] = JT_W(FC)[k];
  if (lane == 0) res_out[b] = res;
  st.mark(JT_ST_IO);
  st.flush(lane);
}

#undef JT_W

// The blocks of W warps of `bytes_per_env` each that one SM holds at once
// for an instantiation of this library (registers and shared memory both
// counted), into *blocks: K2's (sens, gen) with multi, else K3's (gen).
extern "C" int jt_warp_occupancy(int multi, int sens, int gen, int W, int bytes_per_env,
                                 int* blocks) {
  if (!multi)
    return gen ? jt_warp_blocks(substep_warp_kernel<true, JT_RAND>, W, bytes_per_env, blocks)
               : jt_warp_blocks(substep_warp_kernel<false, JT_RAND>, W, bytes_per_env, blocks);
  const auto k = sens ? (gen ? substep_multi_warp_kernel<true, true, JT_RAND>
                             : substep_multi_warp_kernel<true, false, JT_RAND>)
                      : (gen ? substep_multi_warp_kernel<false, true, JT_RAND>
                             : substep_multi_warp_kernel<false, false, JT_RAND>);
  return jt_warp_blocks(k, W, bytes_per_env, blocks);
}
