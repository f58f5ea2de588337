// Batched constraint-solve chain, one thread per env, for Hopper (sm_90a).
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
// Same arithmetic and sweep order as the plain version
// (jiminy_tpu_torch/ops/constraint_solve.py `solve_reference`):
// Cholesky–Crout by columns, one forward + back substitution for all
// right-hand sides, then per sweep the equality rows one by one, the
// bounds span all at once from the same λ (clamped ≥ 0), and for each
// contact color the normals (≥ 0), first tangents and second tangents,
// each row type Jacobi-style from the same λ, then the friction-cone
// projection.
//
// What bounds it on an H100 (ANYmal: n 18, nc 24, 8 sweeps): each env
// moves ~3.7 KB (M, p, v, J, target, mu, active, λ0 in; v⁺, λ, residual
// out), ~15 MB at B = 4096, ≈ 4.5 µs at 3.35 TB/s; it does ~51 kFLOP,
// ≈ 0.21 GFLOP at B = 4096, ≈ 3 µs at the 67 TFLOP/s non-tensor f32
// rate. So memory bounds it. This design does not approach that bound:
// the TPU kernel's lane-major layout (batch on the 128 vector lanes)
// has no use here, so one thread owns one env and keeps L, X, A and λ in
// its local memory (sizes are runtime values under the compile-time caps
// of the template), with the ragged edge masked and no padding. Blocks
// are one warp wide so that a 4096-env batch spreads over all SMs; each
// thread's work is serial, so the kernel is latency-bound. A warp per
// env, shared memory and tensor cores are later work.
//
// The chain itself is the device function `jt_solve_chain` of
// solve_chain.cuh, which the whole-substep kernels (substep.cu) call too.

#include "solve_chain.cuh"

#define JT_THREADS 32

template <int NMAX, int NCMAX>
__global__ void __launch_bounds__(JT_THREADS) solve_chain_kernel(
    const float* __restrict__ M, const float* __restrict__ p,
    const float* __restrict__ v, const float* __restrict__ J,
    const float* __restrict__ target, const float* __restrict__ mu,
    const float* __restrict__ active, const float* __restrict__ lam0,
    float* __restrict__ v_next, float* __restrict__ lam_out,
    float* __restrict__ res_out, SolveParams prm, BlockLayout lay) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= prm.B) return;
  const int n = prm.n, nc = prm.nc;
  const size_t rv = (size_t)b * n, rb = (size_t)b * nc;
  res_out[b] = jt_solve_chain<NMAX, NCMAX>(
      M + rv * n, n, p + rv, v + rv, J + rb * n, n, target + rb, mu + rb,
      active + rb, lam0 + rb, v_next + rv, lam_out + rb, prm, lay);
}

// Largest sizes any instantiation takes (the wrapper checks them too).
#define JT_MAX_N 32
#define JT_MAX_NC 48

extern "C" int jt_solve_chain_max_n(void) { return JT_MAX_N; }
extern "C" int jt_solve_chain_max_nc(void) { return JT_MAX_NC; }

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// layout: see jt_parse_layout in solve_chain.cuh
extern "C" int jt_solve_chain(
    const float* M, const float* p, const float* v, const float* J,
    const float* target, const float* mu, const float* active,
    const float* lam0, float* v_next, float* lam, float* res, int B, int n,
    int nc, const int* layout, int layout_len, int iters, float dt,
    float relax, float reg, int compute_residual, void* stream) {
  if (B < 0 || n < 1 || nc < 1 || n > JT_MAX_N || nc > JT_MAX_NC || iters < 0)
    return (int)cudaErrorInvalidValue;
  BlockLayout lay;
  const int err = jt_parse_layout(layout, layout_len, nc, &lay);
  if (err != (int)cudaSuccess) return err;
  if (B == 0) return (int)cudaSuccess;

  SolveParams prm = {B, n, nc, iters, compute_residual, dt, relax, reg};
  const dim3 grid((B + JT_THREADS - 1) / JT_THREADS), block(JT_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 18 && nc <= 24) {  // the ANYmal main path: smallest frame
    solve_chain_kernel<18, 24><<<grid, block, 0, s>>>(
        M, p, v, J, target, mu, active, lam0, v_next, lam, res, prm, lay);
  } else {
    solve_chain_kernel<JT_MAX_N, JT_MAX_NC><<<grid, block, 0, s>>>(
        M, p, v, J, target, mu, active, lam0, v_next, lam, res, prm, lay);
  }
  return (int)cudaGetLastError();
}
