// The constraint-solve chain of one env as a device function, shared by
// the chain kernel (constraint_solve.cu, K1) and the whole-substep
// kernels (substep.cu, K2 and K3).
//
// Counterpart of jiminy_tpu/ops/constraint_solve.py `_solve_chain`:
//
//   L = chol(M);  X = M⁻¹[p | Jᵀ];  v_free = v + dt·X[:, 0]
//   A = J·X[:, 1:] + reg·I;  rhs = target − J·v_free
//   λ = `iters` grouped PGS sweeps;  v⁺ = v_free + X[:, 1:]·λ
//   optional KKT residual (max complementarity violation)
//
// Same arithmetic and sweep order as the plain version
// (jiminy_tpu_torch/ops/constraint_solve.py `solve_reference`):
// Cholesky–Crout by columns, one forward + back substitution for all
// right-hand sides, then per sweep the equality rows one by one, the
// bounds span all at once from the same λ (clamped ≥ 0), and for each
// contact color the normals (≥ 0), first tangents and second tangents,
// each row type Jacobi-style from the same λ, then the friction-cone
// projection.
//
// One thread runs one env. Sizes are runtime values under the
// compile-time caps NMAX ≥ n and NCMAX ≥ nc; L, X, A and λ live in the
// thread's local memory. M and J are read with a row stride (ldm, ldj),
// so the caller may pass rows of a batched global array or its own
// per-thread arrays.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define JT_MAX_EQ 32
#define JT_MAX_COLORS 16

struct BlockLayout {
  int n_eq;                    // equality blocks, updated row by row
  int eq[JT_MAX_EQ][2];        // (start, size)
  int bounds_start;            // contiguous λ ≥ 0 rows
  int bounds_size;             // 0: no bounds span
  int n_colors;
  int colors[JT_MAX_COLORS][2];  // (start, n_contacts), rows k×[t1,t2,n]
};

struct SolveParams {
  int B, n, nc, iters, compute_residual;
  float dt, relax, reg;
};

// Host side: the block structure from its flat int form
//   [n_eq, (start, size)×n_eq, bounds_start, bounds_size,
//    n_colors, (start, n_contacts)×n_colors]
// into `lay`. Returns cudaSuccess or cudaErrorInvalidValue.
static inline int jt_parse_layout(const int* layout, int layout_len, int nc,
                                  BlockLayout* lay) {
  *lay = BlockLayout{};
  if (layout_len < 4) return (int)cudaErrorInvalidValue;
  int pos = 0;
  lay->n_eq = layout[pos++];
  if (lay->n_eq < 0 || lay->n_eq > JT_MAX_EQ) return (int)cudaErrorInvalidValue;
  if (layout_len < 4 + 2 * lay->n_eq) return (int)cudaErrorInvalidValue;
  for (int e = 0; e < lay->n_eq; ++e) {
    lay->eq[e][0] = layout[pos++];
    lay->eq[e][1] = layout[pos++];
    if (lay->eq[e][0] < 0 || lay->eq[e][0] + lay->eq[e][1] > nc)
      return (int)cudaErrorInvalidValue;
  }
  lay->bounds_start = layout[pos++];
  lay->bounds_size = layout[pos++];
  if (lay->bounds_size < 0 || lay->bounds_start < 0 ||
      lay->bounds_start + lay->bounds_size > nc)
    return (int)cudaErrorInvalidValue;
  lay->n_colors = layout[pos++];
  if (lay->n_colors < 0 || lay->n_colors > JT_MAX_COLORS ||
      layout_len != pos + 2 * lay->n_colors)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < lay->n_colors; ++g) {
    lay->colors[g][0] = layout[pos++];
    lay->colors[g][1] = layout[pos++];
    if (lay->colors[g][0] < 0 || lay->colors[g][1] < 0 ||
        lay->colors[g][0] + 3 * lay->colors[g][1] > nc)
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

// The chain of one env: M (n×n, row stride ldm), p, v (n), J (nc×n, row
// stride ldj), target, mu, active (0/1), lam0 (nc) → v_next (n), lam_out
// (nc); returns the residual (0 unless prm.compute_residual). lam_out may
// be lam0: λ0 is read before anything is written.
template <int NMAX, int NCMAX>
__device__ __forceinline__ float jt_solve_chain(
    const float* __restrict__ M, int ldm, const float* __restrict__ p,
    const float* __restrict__ v, const float* __restrict__ J, int ldj,
    const float* __restrict__ target, const float* __restrict__ mu,
    const float* __restrict__ active, const float* lam0, float* v_next,
    float* lam_out, const SolveParams& prm, const BlockLayout& lay) {
  const int n = prm.n, nc = prm.nc, m = nc + 1;

  float L[NMAX * NMAX];          // L[i*NMAX + j], lower triangle
  float X[NMAX * (NCMAX + 1)];   // X[k*m + c]: c = 0 → M⁻¹p, c ≥ 1 → M⁻¹Jᵀ
  float A[NCMAX * NCMAX];        // Delassus + reg·I
  float lam[NCMAX], rhs[NCMAX], diag[NCMAX], act[NCMAX], tmp[NCMAX];
  float vfree[NMAX], jrow[NMAX];

  // ---- Cholesky–Crout, column j: s = M[j:, j] − L[j:, :j]·L[j, :j]
  for (int j = 0; j < n; ++j) {
    float s0 = M[j * ldm + j];
    for (int k = 0; k < j; ++k) s0 -= L[j * NMAX + k] * L[j * NMAX + k];
    const float d = sqrtf(fmaxf(s0, 1e-12f));
    L[j * NMAX + j] = d;
    for (int i = j + 1; i < n; ++i) {
      float s = M[i * ldm + j];
      for (int k = 0; k < j; ++k) s -= L[i * NMAX + k] * L[j * NMAX + k];
      L[i * NMAX + j] = s / d;
    }
  }

  // ---- X = M⁻¹ [p | Jᵀ]: forward L·y = rhs, then back Lᵀ·x = y
  for (int i = 0; i < n; ++i) {
    X[i * m] = p[i];
    for (int c = 0; c < nc; ++c) X[i * m + 1 + c] = J[c * ldj + i];
  }
  for (int i = 0; i < n; ++i) {
    const float d = L[i * NMAX + i];
    for (int c = 0; c < m; ++c) {
      float s = X[i * m + c];
      for (int k = 0; k < i; ++k) s -= L[i * NMAX + k] * X[k * m + c];
      X[i * m + c] = s / d;
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    const float d = L[i * NMAX + i];
    for (int c = 0; c < m; ++c) {
      float s = X[i * m + c];
      for (int k = i + 1; k < n; ++k) s -= L[k * NMAX + i] * X[k * m + c];
      X[i * m + c] = s / d;
    }
  }
  for (int k = 0; k < n; ++k) vfree[k] = v[k] + prm.dt * X[k * m];

  // ---- Delassus A = J·M⁻¹Jᵀ + reg·I and rhs = target − J·v_free
  for (int i = 0; i < nc; ++i) {
    for (int k = 0; k < n; ++k) jrow[k] = J[i * ldj + k];
    for (int c = 0; c < nc; ++c) {
      float s = 0.f;
      for (int k = 0; k < n; ++k) s += jrow[k] * X[k * m + 1 + c];
      A[i * NCMAX + c] = s;
    }
    A[i * NCMAX + i] += prm.reg;
    float jv = 0.f;
    for (int k = 0; k < n; ++k) jv += jrow[k] * vfree[k];
    rhs[i] = target[i] - jv;
    diag[i] = fmaxf(A[i * NCMAX + i], 1e-8f);
    act[i] = active[i];
    lam[i] = act[i] != 0.f ? lam0[i] : 0.f;
  }

  // residual of row i against the current λ: rhs_i − A_i·λ
  auto row_r = [&](int i) {
    float s = rhs[i];
    for (int c = 0; c < nc; ++c) s -= A[i * NCMAX + c] * lam[c];
    return s;
  };

  // ---- grouped PGS sweeps (order of engine/solver.py pgs_solve_grouped)
  const float relax = prm.relax;
  for (int it = 0; it < prm.iters; ++it) {
    for (int e = 0; e < lay.n_eq; ++e) {
      for (int i = lay.eq[e][0]; i < lay.eq[e][0] + lay.eq[e][1]; ++i) {
        const float li = lam[i] + relax * row_r(i) / diag[i];
        lam[i] = act[i] != 0.f ? li : 0.f;
      }
    }
    if (lay.bounds_size > 0) {
      const int s = lay.bounds_start, k = lay.bounds_size;
      for (int i = s; i < s + k; ++i)
        tmp[i] = fmaxf(lam[i] + relax * row_r(i) / diag[i], 0.f);
      for (int i = s; i < s + k; ++i) lam[i] = act[i] != 0.f ? tmp[i] : 0.f;
    }
    for (int g = 0; g < lay.n_colors; ++g) {
      const int s = lay.colors[g][0], k = lay.colors[g][1];
      for (int t = 0; t < 3; ++t) {
        const int j = t == 0 ? 2 : t - 1;  // normals, then t1, then t2
        for (int c = 0; c < k; ++c) {
          const int i = s + 3 * c + j;
          float li = lam[i] + relax * row_r(i) / diag[i];
          if (j == 2) li = fmaxf(li, 0.f);
          tmp[c] = li;
        }
        for (int c = 0; c < k; ++c) {
          const int i = s + 3 * c + j;
          lam[i] = act[i] != 0.f ? tmp[c] : 0.f;
        }
      }
      for (int c = 0; c < k; ++c) {  // friction-cone projection
        const int i = s + 3 * c;
        const float tn = sqrtf(lam[i] * lam[i] + lam[i + 1] * lam[i + 1] + 1e-24f);
        const float lim = mu[i + 2] * lam[i + 2];
        const float scale = tn > lim ? lim / fmaxf(tn, 1e-12f) : 1.f;
        lam[i] *= scale;
        lam[i + 1] *= scale;
      }
    }
  }

  // ---- v⁺ = v_free + M⁻¹Jᵀ·λ and outputs
  for (int k = 0; k < n; ++k) {
    float s = vfree[k];
    for (int c = 0; c < nc; ++c) s += X[k * m + 1 + c] * lam[c];
    v_next[k] = s;
  }
  for (int c = 0; c < nc; ++c) lam_out[c] = lam[c];

  float res = 0.f;
  if (prm.compute_residual) {
    for (int i = 0; i < nc; ++i) {
      const float r = row_r(i);
      tmp[i] = act[i] != 0.f ? fabsf(r) : 0.f;
    }
    for (int i = lay.bounds_start; i < lay.bounds_start + lay.bounds_size; ++i) {
      const float r = row_r(i);
      const float u = lam[i] > 1e-6f ? fabsf(r) : fmaxf(r, 0.f);
      tmp[i] = act[i] != 0.f ? u : 0.f;
    }
    for (int g = 0; g < lay.n_colors; ++g) {
      const int s = lay.colors[g][0], k = lay.colors[g][1];
      for (int c = 0; c < k; ++c) {
        const int i = s + 3 * c;
        const float rn = row_r(i + 2);
        const float nv = lam[i + 2] > 1e-6f ? fabsf(rn) : fmaxf(rn, 0.f);
        const float tn = sqrtf(lam[i] * lam[i] + lam[i + 1] * lam[i + 1] + 1e-24f);
        const bool sliding = tn >= 0.999f * fmaxf(lam[i + 2], 1e-9f);
        const float t0 = sliding ? 0.f : fabsf(row_r(i));
        const float t1 = sliding ? 0.f : fabsf(row_r(i + 1));
        tmp[i] = act[i] != 0.f ? t0 : 0.f;
        tmp[i + 1] = act[i + 1] != 0.f ? t1 : 0.f;
        tmp[i + 2] = act[i + 2] != 0.f ? nv : 0.f;
      }
    }
    for (int i = 0; i < nc; ++i) res = fmaxf(res, tmp[i]);
  }
  return res;
}
