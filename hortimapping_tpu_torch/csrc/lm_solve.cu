// Batched dense solve of the LM normal equations: x = H^-1 b for every lane.
//
// Replaces no TPU kernel: the JAX package leaves `jnp.linalg.solve` of the
// [D, D] system to XLA. The port's `torch.linalg.solve_ex` of the same
// system factors through cuSOLVER's batched LU, which at B = 32 calls
// cudaDeviceSynchronize, so the host waited there inside every LM iteration
// and the iteration could not be captured as a CUDA graph. This kernel
// launches on the caller's stream, allocates nothing and never synchronizes.
//
// Bound on the H100: latency. A lane's system is D <= 64 unknowns (39 for
// the pepper decoders, 15 for the berry), ~D^3/3 = 20k FMAs, a few
// microseconds of one SM. Design: one block per lane; the augmented
// [D, D+1] system lives in shared memory (at most 64 x 65 floats). H is
// first equilibrated symmetrically, S H S y = S b and x = S y with S the
// power of two nearest 1 / sqrt|H_ii| (exact products, no rounding): the
// pose and code blocks of the normal equations differ in scale by orders
// of magnitude, and the scaled system's condition is ~40 where H's is
// ~2e4, so the f32 solve keeps five more bits. Then LU with partial
// pivoting, right-looking as LAPACK's getf2 (the first warp picks the
// pivot, the block swaps, scales the multipliers, then updates the
// trailing rows and the right-hand side together), and back substitution
// by columns. f32 throughout, as the normal equations. A zero pivot (a
// singular H, a lane with nothing observed) is not tested for: its
// divisions give inf/nan, as solve_ex and jnp.linalg.solve do, and the LM
// discards that lane's step.
#include <cuda_runtime.h>

constexpr int kMaxDim = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lm_solve_kernel(const float* __restrict__ H, const float* __restrict__ b,
                    float* __restrict__ x, int D) {
  __shared__ float A[kMaxDim][kMaxDim + 1];
  __shared__ float scale[kMaxDim];
  __shared__ int pivot_row;
  const int tid = threadIdx.x;
  const long lane = blockIdx.x;
  const float* Hl = H + lane * D * D;
  const float* bl = b + lane * D;
  const int W = D + 1;   // columns of the augmented system
  for (int r = tid; r < D; r += kThreads) {
    const float d = fabsf(Hl[r * D + r]);
    int e = 0;
    frexpf(d, &e);   // d = m 2^e, m in [0.5, 1)
    scale[r] = (d > 0.f && isfinite(d)) ? ldexpf(1.f, -e / 2) : 1.f;
  }
  __syncthreads();
  for (int e = tid; e < D * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    A[r][c] = (c < D ? Hl[r * D + c] * scale[c] : bl[r]) * scale[r];
  }
  __syncthreads();

  for (int k = 0; k < D; ++k) {
    if (tid < 32) {
      // the largest |A[r][k]| of rows k..D-1, the first such row on a tie
      float best = -1.f;
      int arg = k;
      for (int r = k + tid; r < D; r += 32) {
        const float v = fabsf(A[r][k]);
        if (v > best) {
          best = v;
          arg = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oa = __shfl_down_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if (tid == 0) pivot_row = arg;
    }
    __syncthreads();
    const int p = pivot_row;
    if (p != k) {
      for (int c = k + tid; c < W; c += kThreads) {
        const float t = A[k][c];
        A[k][c] = A[p][c];
        A[p][c] = t;
      }
      __syncthreads();
    }
    // multipliers l_rk = A[r][k] / A[k][k], kept in column k
    const float pivot = A[k][k];
    for (int r = k + 1 + tid; r < D; r += kThreads) A[r][k] = A[r][k] / pivot;
    __syncthreads();
    // trailing update of rows k+1.. over columns k+1..D (the right-hand side
    // included): A[r][c] -= l_rk A[k][c]
    const int cols = W - (k + 1);
    const int n = (D - 1 - k) * cols;
    for (int e = tid; e < n; e += kThreads) {
      const int r = k + 1 + e / cols, c = k + 1 + e % cols;
      A[r][c] = fmaf(-A[r][k], A[k][c], A[r][c]);
    }
    __syncthreads();
  }

  // U x = y, y in column D, by columns from the last unknown
  for (int k = D - 1; k >= 0; --k) {
    if (tid == 0) A[k][D] = A[k][D] / A[k][k];
    __syncthreads();
    const float xk = A[k][D];
    for (int r = tid; r < k; r += kThreads) A[r][D] = fmaf(-A[r][k], xk, A[r][D]);
    __syncthreads();
  }
  for (int r = tid; r < D; r += kThreads) x[lane * D + r] = A[r][D] * scale[r];
}

// H [n_lanes][D][D], b [n_lanes][D] -> x [n_lanes][D], all f32 and
// contiguous; on `stream`. Returns a cudaError_t.
extern "C" int horti_lm_solve(const void* H, const void* b, void* x, int n_lanes, int D,
                              void* stream) {
  if (D < 1 || D > kMaxDim || n_lanes < 0) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return (int)cudaSuccess;
  lm_solve_kernel<<<n_lanes, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)H, (const float*)b, (float*)x, D);
  return (int)cudaGetLastError();
}
