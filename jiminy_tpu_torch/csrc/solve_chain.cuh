// The constraint-solve chain of one env on one warp, and what the warp
// kernels share: K1 (constraint_solve.cu) runs the chain alone, K3 and K2
// (substep_warp.cuh) run it inside a substep.
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
// One warp runs one env (`jt_warp_chain`), its arrays in the env's slice of
// the block's dynamic shared memory, each with its own row stride (odd: no
// two lanes of a column walk on one bank). The host lays the slice out from
// the env's own sizes and the C entries check the layout before a launch
// (the helpers at the end of this file); each PGS group runs one row per
// lane, so the entries refuse a bounds span or a color wider than a warp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define JT_WARP_MAX_W 4           // envs per block at most (ops/_warp.py WARP_MAX_W)
#define JT_SMEM_PER_BLOCK 232448  // bytes of shared memory one block may take (H100)

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

// ---- the chain of one env on its warp (the counterpart of `_solve_chain`,
// the plain version's arithmetic and sweep order): L (M's lower triangle, factored in
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
  // rows, each lane's largest from 0, then the warp's
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

// ---- host side: what the warp kernels' C entries share

// Every PGS group (the bounds span, each color) one row per lane of a warp.
static inline bool jt_groups_fit_warp(const BlockLayout& lay) {
  if (lay.bounds_size > 32) return false;
  for (int g = 0; g < lay.n_colors; ++g)
    if (lay.colors[g][1] > 32) return false;
  return true;
}

// W envs (1 ≤ W ≤ JT_WARP_MAX_W) of `stride` floats (a multiple of 4) fit
// one block's shared memory.
static inline bool jt_block_fits(long long W, long long stride) {
  return W >= 1 && W <= JT_WARP_MAX_W && stride >= 1 && stride % 4 == 0 &&
         W * stride * (long long)sizeof(float) <= JT_SMEM_PER_BLOCK;
}

// The regions first..last of a layout (offsets o and sizes in floats; a
// size of 0: absent) each 16-byte aligned and inside [lo, hi), and no two
// of them overlapping.
static inline bool jt_regions_ok(const int* o, const int* size, int first, int last, int lo,
                                 int hi) {
  for (int a = first; a <= last; ++a) {
    if (size[a] == 0) continue;
    if (o[a] % 4 != 0 || o[a] < lo || o[a] + size[a] > hi) return false;
    for (int b = a + 1; b <= last; ++b)
      if (size[b] != 0 && o[a] < o[b] + size[b] && o[b] < o[a] + size[a]) return false;
  }
  return true;
}

// `kernel` may take `smem` bytes of dynamic shared memory, the carveout set
// to shared memory.
template <typename Kernel>
static cudaError_t jt_allow_smem(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// A warp kernel over B envs on stream s: ⌈B / W⌉ blocks of W warps, each
// env `stride` floats of the block's dynamic shared memory, the kernel's
// arguments `args`. Returns cudaGetLastError() of the launch, or the error
// that stopped it.
template <typename Kernel, typename... Args>
static int jt_warp_launch(Kernel kernel, int B, int W, int stride, cudaStream_t s, Args... args) {
  const int smem = W * stride * (int)sizeof(float);
  const cudaError_t err = jt_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + W - 1) / W, 32 * W, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// The blocks of W warps of `bytes_per_env` each that one SM holds at once
// for `kernel` (registers and shared memory both counted), into *blocks.
template <typename Kernel>
static int jt_warp_blocks(Kernel kernel, int W, int bytes_per_env, int* blocks) {
  const int smem = W * bytes_per_env;
  cudaError_t err = jt_allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, 32 * W, smem);
  return (int)err;
}
