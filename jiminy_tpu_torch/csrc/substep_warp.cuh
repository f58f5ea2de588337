// K2 for Hopper: one warp per env, the env's working set in shared memory.
// Included by substep.cuh (both libraries), after the per-item pieces of a
// substep, which it runs across its lanes.
//
// Every K2 launch runs this body, in every SENS / GEN / RAND instantiation
// and for every model inside the kernels' caps (nb ≤ 32, nv ≤ 32, nc ≤ 48:
// JT_SUB_MAX_*): the ANYmal frame (ANYmal, Ant, Spotmicro, the toys) and
// the large frame (Cassie with its self-collision pairs and flexible hips,
// the PRISMATIC slab scene) alike. It replaces the one-thread K2, which
// sized every array for the caps and kept them in local memory (~40 KB a
// thread in the large frame, A and X walked row by row: its time tracked
// nc²). Operations bound it, as substep.cuh's note counts them. Same
// arithmetic as the one-thread body step for step (the plain versions
// ops/substep_kernel.py `substep_multi_reference` and `substep_reference`
// are the yardstick), save the equality rows' dot in the PGS, a fixed xor
// tree across the lanes (jt_warp_sum). Every reduction has a fixed order
// and nothing is atomic, so the kernel is deterministic, and the physics
// does not depend on SENS: the sensor variant steps as K2 does, bit for
// bit, and n_sub substeps in one launch equal n_sub launches of one.
//
// Grid: W envs (warps) per block (ops/substep_kernel.py
// `SubstepSpec.warp_workspace` picks W ≤ JT_WARP_MAX_W), ⌈B / W⌉ blocks; a
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
// decreasing body order, the one-thread body's order); M's rows and columns
// across the bodies; the diagonal terms across the dofs; the row items
// (distance constraints, bounds, ground contacts, then each pair contact
// at its own fixed rows, jt_pair_item) across the lanes; the chain
// (jt_warp_chain); the impulses across the contacts and Euler across the
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

#define JT_WARP_MAX_W 4           // envs per block at most (ops/substep_kernel.py WARP_MAX_W)
#define JT_SMEM_PER_BLOCK 232448  // bytes of shared memory one block may take (H100)
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
  const long long W = o[JT_WL_W], stride = o[JT_WL_STRIDE];
  if (W < 1 || W > JT_WARP_MAX_W || stride < 1 || stride % 4 != 0 ||
      W * stride * (long long)sizeof(float) > JT_SMEM_PER_BLOCK || o[JT_WL_NCP] < 0 ||
      3 * o[JT_WL_NCP] > nc || o[JT_WL_NROWS] < 0 || (o[JT_WL_NROWS] > 0) != sens ||
      o[JT_WL_LDM] < nv || o[JT_WL_LDJ] < nv || o[JT_WL_LDX] < nc + 1 || o[JT_WL_LDA] < nc ||
      nb > JT_SUB_MAX_NB || nv > JT_SUB_MAX_N || nc > JT_SUB_MAX_NC || lay.bounds_size > 32)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < lay.n_colors; ++g)
    if (lay.colors[g][1] > 32) return (int)cudaErrorInvalidValue;
  int size[JT_WL_LEN];
  jt_warp_sizes(*w, nb, nq, nv, nc, nm, n_gc, sens, size);
  struct Set { int first, last, lo, hi; };
  const int u = o[JT_WL_U];
  const Set sets[4] = {{JT_WL_Q0, JT_WL_U, 0, (int)stride},
                       {JT_WL_XLR, JT_WL_CC, u, (int)stride},
                       {JT_WL_X, JT_WL_A, u, (int)stride},
                       {JT_WL_SXWR, JT_WL_ROWS, u, (int)stride}};
  for (const Set& st : sets) {
    for (int a = st.first; a <= st.last; ++a) {
      if (size[a] == 0) continue;
      if (o[a] % 4 != 0 || o[a] < st.lo || o[a] + size[a] > st.hi) return (int)cudaErrorInvalidValue;
      for (int b = a + 1; b <= st.last; ++b)
        if (size[b] != 0 && o[a] < o[b] + size[b] && o[b] < o[a] + size[a])
          return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaSuccess;
}

// ---- per-stage cycle counts (JT_WARP_STAGES builds alone)
enum {
  JT_ST_TORQUE = 0, JT_ST_TREE_FWD, JT_ST_TREE_BWD, JT_ST_CRBA, JT_ST_ROWS, JT_ST_FACTOR,
  JT_ST_DELASSUS, JT_ST_PGS, JT_ST_VPLUS, JT_ST_INTEGRATE, JT_ST_SENSORS, JT_ST_IO, JT_ST_N
};

#ifdef JT_WARP_STAGES
__device__ unsigned long long jt_stage_cycles[JT_ST_N + 1];  // the stages', then the envs
struct JtStages {
  long long t, cyc[JT_ST_N];
  __device__ void start() {
    for (int k = 0; k < JT_ST_N; ++k) cyc[k] = 0;
    t = clock64();
  }
  __device__ void mark(int k) {
    const long long now = clock64();
    cyc[k] += now - t;
    t = now;
  }
  __device__ void flush(int lane) {
    if (lane != 0) return;
    for (int k = 0; k < JT_ST_N; ++k) atomicAdd(&jt_stage_cycles[k], (unsigned long long)cyc[k]);
    atomicAdd(&jt_stage_cycles[JT_ST_N], 1ull);
  }
};

extern "C" int jt_stage_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, jt_stage_cycles, sizeof(jt_stage_cycles));
}

extern "C" int jt_stage_reset() {
  const unsigned long long zero[JT_ST_N + 1] = {};
  return (int)cudaMemcpyToSymbol(jt_stage_cycles, zero, sizeof(zero));
}

extern "C" int jt_stage_count() { return JT_ST_N; }
#else
struct JtStages {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush(int) {}
};
#endif

// ---- warp reductions by a fixed xor tree: every lane ends with the same bits
template <typename Op>
__device__ __forceinline__ float jt_warp_reduce(float x, Op op) {
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float jt_warp_sum(float x) {
  return jt_warp_reduce(x, [](float a, float b) { return a + b; });
}

__device__ __forceinline__ float jt_warp_max(float x) {
  return jt_warp_reduce(x, [](float a, float b) { return fmaxf(a, b); });
}

// CRBA at body i, its composite inertia Ic complete: its dofs' rows and
// columns of M (row stride ldm), one column of F = Ic·Sᵢ at a time carried
// up the chain (entry for entry the one-thread body's values)
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

// ---- the chain of one env on its warp (the counterpart of jt_solve_chain,
// its arithmetic and sweep order): L (M's lower triangle, factored in
// place, row stride ldm) with its diagonal in dL; X (nv × ldx) = M⁻¹[p |
// Jᵀ], lane l the right-hand sides l, l + 32; A (nc × lda) = J·X[:, 1:] +
// reg·I, lane l the columns l, l + 32 and their rows' setup; the grouped
// PGS with each bounds span and each (color, row type) group across the
// lanes from one λ, one row per lane, the equality rows one by one (a warp
// dot); v⁺ across the dofs, the residual across the rows, strided. λ (nc)
// in place: λ0 in, λ out. Returns the residual (0 unless asked), the same
// in every lane.
__device__ __forceinline__ float jt_warp_chain(
    int lane, float* L, int ldm, float* dL, const float* pf, const float* v, const float* J,
    int ldj, const float* target, const float* mu, const float* active, float* lam, float* X,
    int ldx, float* A, int lda, float* rhs, float* dg, float* vfree, float* v_next,
    const SolveParams& prm, const BlockLayout& lay, JtStages& st) {
  const int n = prm.n, nc = prm.nc, m = nc + 1;

  // ---- Cholesky–Crout, column j: its entries below the diagonal across
  // the lanes, s = M[i, j] − L[i, :j]·L[j, :j]
  for (int j = 0; j < n; ++j) {
    float s0 = L[j * ldm + j];
    for (int k = 0; k < j; ++k) s0 -= L[j * ldm + k] * L[j * ldm + k];
    const float d = sqrtf(fmaxf(s0, 1e-12f));
    const int i = j + 1 + lane;
    if (i < n) {
      float s = L[i * ldm + j];
      for (int k = 0; k < j; ++k) s -= L[i * ldm + k] * L[j * ldm + k];
      L[i * ldm + j] = s / d;
    }
    if (lane == 0) dL[j] = d;
    __syncwarp();
  }

  // ---- X = M⁻¹[p | Jᵀ], lane c its columns: forward L·y = rhs, back Lᵀ·x = y
  for (int c = lane; c < m; c += 32) {
    for (int i = 0; i < n; ++i) {
      if (c == 0) X[i * ldx] = pf[i];
      else X[i * ldx + c] = J[(c - 1) * ldj + i];
    }
    for (int i = 0; i < n; ++i) {
      float s = X[i * ldx + c];
      for (int k = 0; k < i; ++k) s -= L[i * ldm + k] * X[k * ldx + c];
      X[i * ldx + c] = s / dL[i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = X[i * ldx + c];
      for (int k = i + 1; k < n; ++k) s -= L[k * ldm + i] * X[k * ldx + c];
      X[i * ldx + c] = s / dL[i];
    }
  }
  __syncwarp();
  st.mark(JT_ST_FACTOR);
  if (lane < n) vfree[lane] = v[lane] + prm.dt * X[lane * ldx];
  __syncwarp();

  // ---- Delassus A = J·M⁻¹Jᵀ + reg·I, lane c its columns (X's column c + 1
  // is its own); rhs = target − J·v_free, the diagonal and λ0 of row c (A's
  // diagonal entry in the lane's own column)
  for (int c = lane; c < nc; c += 32) {
    for (int i = 0; i < nc; ++i) {
      float s = 0.f;
      for (int k = 0; k < n; ++k) s += J[i * ldj + k] * X[k * ldx + 1 + c];
      A[i * lda + c] = i == c ? s + prm.reg : s;
    }
    const int i = c;
    float jv = 0.f;
    for (int k = 0; k < n; ++k) jv += J[i * ldj + k] * vfree[k];
    rhs[i] = target[i] - jv;
    dg[i] = fmaxf(A[i * lda + i], 1e-8f);
    lam[i] = active[i] != 0.f ? lam[i] : 0.f;
  }
  __syncwarp();
  st.mark(JT_ST_DELASSUS);

  // residual of row i against the current λ: rhs_i − A_i·λ
  auto row_r = [&](int i) {
    float s = rhs[i];
    for (int c = 0; c < nc; ++c) s -= A[i * lda + c] * lam[c];
    return s;
  };

  // ---- grouped PGS sweeps (order of engine/solver.py pgs_solve_grouped):
  // within a group every row reads λ before any row writes it
  const float relax = prm.relax;
  for (int it = 0; it < prm.iters; ++it) {
    for (int e = 0; e < lay.n_eq; ++e) {
      for (int i = lay.eq[e][0]; i < lay.eq[e][0] + lay.eq[e][1]; ++i) {
        // each lane's own entries in order, then the xor tree
        float part = lane < nc ? A[i * lda + lane] * lam[lane] : 0.f;
        for (int c = lane + 32; c < nc; c += 32) part += A[i * lda + c] * lam[c];
        const float dot = jt_warp_sum(part);
        if (lane == 0) {
          const float li = lam[i] + relax * (rhs[i] - dot) / dg[i];
          lam[i] = active[i] != 0.f ? li : 0.f;
        }
        __syncwarp();
      }
    }
    if (lay.bounds_size > 0) {
      const int i = lay.bounds_start + lane;
      const bool mine = lane < lay.bounds_size;
      float li = 0.f;
      if (mine) li = fmaxf(lam[i] + relax * row_r(i) / dg[i], 0.f);
      __syncwarp();
      if (mine) lam[i] = active[i] != 0.f ? li : 0.f;
      __syncwarp();
    }
    for (int g = 0; g < lay.n_colors; ++g) {
      const int s = lay.colors[g][0];
      const bool mine = lane < lay.colors[g][1];  // lane c: contact c of the color
      for (int t = 0; t < 3; ++t) {
        const int j = t == 0 ? 2 : t - 1;  // normals, then t1, then t2
        const int i = s + 3 * lane + j;
        float li = 0.f;
        if (mine) {
          li = lam[i] + relax * row_r(i) / dg[i];
          if (j == 2) li = fmaxf(li, 0.f);
        }
        __syncwarp();
        if (mine) lam[i] = active[i] != 0.f ? li : 0.f;
        __syncwarp();
      }
      if (mine) {  // friction-cone projection
        const int i = s + 3 * lane;
        const float tn = sqrtf(lam[i] * lam[i] + lam[i + 1] * lam[i + 1] + 1e-24f);
        const float lim = mu[i + 2] * lam[i + 2];
        const float scale = tn > lim ? lim / fmaxf(tn, 1e-12f) : 1.f;
        lam[i] *= scale;
        lam[i + 1] *= scale;
      }
      __syncwarp();
    }
  }
  st.mark(JT_ST_PGS);

  // ---- v⁺ = v_free + M⁻¹Jᵀ·λ across the dofs; the residual across the
  // rows, each lane's largest from 0 (as jt_solve_chain), then the warp's
  if (lane < n) {
    float s = vfree[lane];
    for (int c = 0; c < nc; ++c) s += X[lane * ldx + 1 + c] * lam[c];
    v_next[lane] = s;
  }
  float res = 0.f;
  if (prm.compute_residual) {
    float val = 0.f;
    for (int i = lane; i < nc; i += 32) {
      const float r = row_r(i);
      float u = fabsf(r);
      if (i >= lay.bounds_start && i < lay.bounds_start + lay.bounds_size)
        u = lam[i] > 1e-6f ? fabsf(r) : fmaxf(r, 0.f);
      for (int g = 0; g < lay.n_colors; ++g) {
        const int s = lay.colors[g][0];
        if (i < s || i >= s + 3 * lay.colors[g][1]) continue;
        const int base = s + 3 * ((i - s) / 3);
        if (i - base == 2) {
          u = lam[i] > 1e-6f ? fabsf(r) : fmaxf(r, 0.f);
        } else {
          const float tn = sqrtf(lam[base] * lam[base] + lam[base + 1] * lam[base + 1] + 1e-24f);
          const bool sliding = tn >= 0.999f * fmaxf(lam[base + 2], 1e-9f);
          u = sliding ? 0.f : fabsf(r);
        }
      }
      val = fmaxf(val, active[i] != 0.f ? u : 0.f);
    }
    res = jt_warp_max(val);
  }
  __syncwarp();
  st.mark(JT_ST_VPLUS);
  return res;
}

#define JT_W(region) (ws + wl.o[JT_WL_##region])

// ---- one substep of one env on its warp (the counterpart of jt_substep):
// q, v, tau, w0, g (GEN, n_gc wide) in the workspace; mp the env's model
// parameters (RAND); → q_next, v_next, λ in place, the impulses in the workspace's fc;
// dep: the depth of the lane's body (−1 past nb), maxd the deepest
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
  // contacts, then the pair contacts, each at its own rows (up to nc, as
  // jt_pair_rows stops) on the lanes that follow the others' (item
  // crow + ncp + p on lane (crow + ncp + p) mod 32)
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
// jt_sensor_stage, at the same accepted state): the bodies by depth, the
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

#undef JT_W

// Host side: K2's warp body with the checked layout w, on stream s: the
// shared memory each block takes allowed first (and the carveout set to
// shared memory), then ⌈B / W⌉ blocks of W warps. Returns
// cudaGetLastError() of the launch, or the error that stopped it.
template <bool SENS, bool GEN>
static int jt_warp_launch(const WarpLayout& w, const int* si, const float* sf, const float* q,
                          const float* v, const float* cmd, const float* lam0,
                          const float* wrench, float* q_out, float* v_out, float* lam_out,
                          float* res, float* fc, float* a_out, float* tau_out, int n_sub,
                          const float* gc, int n_gc, const float* mp, int n_mp,
                          const SolveParams& prm, const BlockLayout& lay, const SensParams& sp,
                          cudaStream_t s) {
  const auto kernel = substep_multi_warp_kernel<SENS, GEN, JT_RAND>;
  const int W = w.o[JT_WL_W];
  const int smem = W * w.o[JT_WL_STRIDE] * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(prm.B + W - 1) / W, 32 * W, smem, s>>>(si, sf, q, v, cmd, lam0, wrench, q_out, v_out,
                                                 lam_out, res, fc, a_out, tau_out, n_sub, gc, n_gc,
                                                 mp, n_mp, prm, lay, sp, w);
  return (int)cudaGetLastError();
}

// The blocks of W warps of `bytes_per_env` each that one SM holds at once
// for the (sens, gen) instantiation of this library (registers and shared
// memory both counted), into *blocks.
extern "C" int jt_warp_occupancy(int sens, int gen, int W, int bytes_per_env, int* blocks) {
  const void* k = sens ? (gen ? (const void*)substep_multi_warp_kernel<true, true, JT_RAND>
                              : (const void*)substep_multi_warp_kernel<true, false, JT_RAND>)
                       : (gen ? (const void*)substep_multi_warp_kernel<false, true, JT_RAND>
                              : (const void*)substep_multi_warp_kernel<false, false, JT_RAND>);
  const int smem = W * bytes_per_env;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 32 * W, smem);
  return (int)err;
}
