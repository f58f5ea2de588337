// K1 for Hopper (sm_90a): the batched constraint-solve chain, one warp per
// env, the env's working set in shared memory.
//
// Replaces: jiminy_tpu/ops/constraint_solve.py `_solve_chain` (reached by
// `solve_batched_pallas` through `pl.pallas_call`), the TPU kernel that
// runs the impulse substep's dense chain for every env:
//
//   L = chol(M);  X = M⁻¹[p | Jᵀ];  v_free = v + dt·X[:, 0]
//   A = J·X[:, 1:] + reg·I;  rhs = target − J·v_free
//   λ = `iters` grouped PGS sweeps;  v⁺ = v_free + X[:, 1:]·λ
//   optional KKT residual (max complementarity violation)
//
// The chain is `jt_warp_chain` (solve_chain.cuh), the one K3 and K2 run
// inside their substep, with the plain version's arithmetic and sweep order
// (jiminy_tpu_torch/ops/constraint_solve.py `solve_reference`).
//
// What bounds it on an H100 (ANYmal: n 18, nc 24, 8 sweeps): each env
// moves ~3.7 KB (M, p, v, J, target, mu, active, λ0 in; v⁺, λ, residual
// out), ~15 MB at B = 4096, ≈ 4.5 µs at 3.35 TB/s; it does ~51 kFLOP,
// ≈ 0.21 GFLOP at B = 4096, ≈ 3 µs at the 67 TFLOP/s non-tensor f32
// rate. So memory bounds it.
//
// Grid: W envs (warps) per block, ⌈B / W⌉ blocks; a warp past B returns
// whole. Each warp copies its env's M into the slot of L at an odd row
// stride (the chain factors L in place; M stays as the caller gave it) and
// J, p, v, target, mu, active and λ0 beside it, every copy lane-strided
// over the env's contiguous rows so that the reads stay coalesced; runs the
// chain; writes v⁺ (straight from the chain's lanes), λ and the residual.
// The layout (ChainLayout below) is made on the host from (n, nc), not
// from the caps (ops/constraint_solve.py `warp_workspace`), and checked
// here before a launch (`jt_check_chain_layout`): L (n × ldm), dL, p, v (n),
// J (nc × ldj), target, mu, active, λ (nc), X (n × ldx, ldx ≥ nc + 1), A
// (nc × lda), rhs, diag (nc), v_free (n), each region apart. L and A could
// share their bytes (L is dead once X is formed), but each region keeps its
// own so that the layout is one list of disjoint regions: ~8.3 KB per env
// for ANYmal (n 18, nc 24), ~25 KB at n 29, nc 47 (Atlas; two blocks of
// four envs an SM), ~53 KB at n 29, nc 83 (Atlas with its self-collision
// pairs; one block of four envs an SM), ~69.4 KB at the caps (W = 3).

#include "solve_chain.cuh"

// Largest sizes the kernel takes (ops/constraint_solve.py MAX_N, MAX_NC).
#define JT_MAX_N 32
#define JT_MAX_NC 96

// The layout (ops/constraint_solve.py `_CHAIN_SLOTS`): W, the env's stride
// (floats), the row strides, then each region's offset (floats, from the
// env's slice).
enum {
  JT_CL_W = 0, JT_CL_STRIDE, JT_CL_LDM, JT_CL_LDJ, JT_CL_LDX, JT_CL_LDA,
  JT_CL_L, JT_CL_DL, JT_CL_P, JT_CL_V, JT_CL_J, JT_CL_TGT, JT_CL_MU, JT_CL_ACT, JT_CL_LAM,
  JT_CL_X, JT_CL_A, JT_CL_RHS, JT_CL_DG, JT_CL_VF,
  JT_CL_LEN
};

struct ChainLayout {
  int o[JT_CL_LEN];
};

// Host side: the layout from its ints into c, checked against (n, nc) and
// the PGS layout lay: the sizes within the caps and every PGS group no wider
// than a warp, W envs of `stride` floats fit a block, every region 16-byte
// aligned, inside its env's slice and apart from every other. Returns
// cudaSuccess or cudaErrorInvalidValue.
static int jt_check_chain_layout(const int* cl, int cl_len, int n, int nc, const BlockLayout& lay,
                                 ChainLayout* c) {
  if (cl == nullptr || cl_len != JT_CL_LEN) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < JT_CL_LEN; ++r) c->o[r] = cl[r];
  const int* o = c->o;
  if (!jt_block_fits(o[JT_CL_W], o[JT_CL_STRIDE]) || o[JT_CL_LDM] < n || o[JT_CL_LDJ] < n ||
      o[JT_CL_LDX] < nc + 1 || o[JT_CL_LDA] < nc || !jt_groups_fit_warp(lay))
    return (int)cudaErrorInvalidValue;
  int size[JT_CL_LEN] = {};
  size[JT_CL_L] = n * o[JT_CL_LDM];
  size[JT_CL_DL] = size[JT_CL_P] = size[JT_CL_V] = size[JT_CL_VF] = n;
  size[JT_CL_J] = nc * o[JT_CL_LDJ];
  size[JT_CL_TGT] = size[JT_CL_MU] = size[JT_CL_ACT] = size[JT_CL_LAM] = nc;
  size[JT_CL_RHS] = size[JT_CL_DG] = nc;
  size[JT_CL_X] = n * o[JT_CL_LDX];
  size[JT_CL_A] = nc * o[JT_CL_LDA];
  return jt_regions_ok(o, size, JT_CL_L, JT_CL_VF, 0, o[JT_CL_STRIDE]) ? (int)cudaSuccess
                                                                      : (int)cudaErrorInvalidValue;
}

#define JT_C(region) (ws + cl.o[JT_CL_##region])

// the env's m × k block (row-major, contiguous) into dst at row stride ld,
// lane-strided over the block
__device__ __forceinline__ void jt_copy_rows(int lane, const float* src, int m, int k, float* dst,
                                             int ld) {
  for (int e = lane; e < m * k; e += 32) {
    const int r = e / k;
    dst[r * ld + e - r * k] = src[e];
  }
}

// Launch bounds: JT_WARP_MAX_W warps a block and four blocks an SM, as K2's.
__global__ void __launch_bounds__(JT_WARP_MAX_W * 32, 16 / JT_WARP_MAX_W) solve_chain_warp_kernel(
    const float* __restrict__ M, const float* __restrict__ p,
    const float* __restrict__ v, const float* __restrict__ J,
    const float* __restrict__ target, const float* __restrict__ mu,
    const float* __restrict__ active, const float* __restrict__ lam0,
    float* __restrict__ v_next, float* __restrict__ lam_out,
    float* __restrict__ res_out, SolveParams prm, BlockLayout lay, ChainLayout cl) {
  extern __shared__ float4 jt_smem[];  // 16-byte aligned
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * cl.o[JT_CL_W] + warp;
  if (b >= prm.B) return;  // the ragged edge, a whole warp at a time
  float* ws = reinterpret_cast<float*>(jt_smem) + warp * cl.o[JT_CL_STRIDE];
  const int n = prm.n, nc = prm.nc, ldm = cl.o[JT_CL_LDM], ldj = cl.o[JT_CL_LDJ];
  const size_t rv = (size_t)b * n, rc = (size_t)b * nc;
  jt_copy_rows(lane, M + rv * n, n, n, JT_C(L), ldm);
  jt_copy_rows(lane, J + rc * n, nc, n, JT_C(J), ldj);
  for (int k = lane; k < n; k += 32) {
    JT_C(P)[k] = p[rv + k];
    JT_C(V)[k] = v[rv + k];
  }
  for (int k = lane; k < nc; k += 32) {
    JT_C(TGT)[k] = target[rc + k];
    JT_C(MU)[k] = mu[rc + k];
    JT_C(ACT)[k] = active[rc + k];
    JT_C(LAM)[k] = lam0[rc + k];
  }
  __syncwarp();
  JtStages st;  // counts nothing: this library is not a measuring build
  const float res = jt_warp_chain(lane, JT_C(L), ldm, JT_C(DL), JT_C(P), JT_C(V), JT_C(J), ldj,
                                  JT_C(TGT), JT_C(MU), JT_C(ACT), JT_C(LAM), JT_C(X),
                                  cl.o[JT_CL_LDX], JT_C(A), cl.o[JT_CL_LDA], JT_C(RHS), JT_C(DG),
                                  JT_C(VF), v_next + rv, prm, lay, st);
  for (int k = lane; k < nc; k += 32) lam_out[rc + k] = JT_C(LAM)[k];
  if (lane == 0) res_out[b] = res;
}

#undef JT_C

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1. M (B, n, n), p, v (B, n), J (B, nc, n), target, mu, active, lam0 (B,
// nc) → v_next (B, n), lam (B, nc), res (B,); layout: the PGS blocks (see
// jt_parse_layout in solve_chain.cuh); cl (cl_len ints): the warp's
// workspace layout, checked: a missing or bad layout, sizes past the caps
// or a PGS group wider than a warp are refused and nothing falls back.
extern "C" int jt_solve_batched(
    const float* M, const float* p, const float* v, const float* J,
    const float* target, const float* mu, const float* active,
    const float* lam0, float* v_next, float* lam, float* res, int B, int n,
    int nc, const int* layout, int layout_len, const int* cl, int cl_len, int iters, float dt,
    float relax, float reg, int compute_residual, void* stream) {
  if (B < 0 || n < 1 || nc < 1 || n > JT_MAX_N || nc > JT_MAX_NC || iters < 0)
    return (int)cudaErrorInvalidValue;
  BlockLayout lay;
  int err = jt_parse_layout(layout, layout_len, nc, &lay);
  if (err != (int)cudaSuccess) return err;
  ChainLayout c;
  err = jt_check_chain_layout(cl, cl_len, n, nc, lay, &c);
  if (err != (int)cudaSuccess) return err;
  if (B == 0) return (int)cudaSuccess;
  const SolveParams prm = {B, n, nc, iters, compute_residual, dt, relax, reg};
  return jt_warp_launch(solve_chain_warp_kernel, B, c.o[JT_CL_W], c.o[JT_CL_STRIDE],
                        (cudaStream_t)stream, M, p, v, J, target, mu, active, lam0, v_next, lam,
                        res, prm, lay, c);
}

// The blocks of W warps of `bytes_per_env` each that one SM holds at once
// (registers and shared memory both counted), into *blocks.
extern "C" int jt_solve_occupancy(int W, int bytes_per_env, int* blocks) {
  return jt_warp_blocks(solve_chain_warp_kernel, W, bytes_per_env, blocks);
}
