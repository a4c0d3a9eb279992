// Decoder forward for N points that share one latent code, for B codes at
// once: out[b, n] = tanh sdf of [latent_b | pts_n].
//
// Replaces the TPU kernel `_shared_latent_kernel` (hortimapping_tpu/ops/
// pallas_mlp.py, reached through `mlp_sdf_shared_latent`), which the JAX
// mesher vmaps over codes; here one launch covers every fruit, grid (point
// tiles, fruits). The port's mesher decodes its voxel grids through it.
//
// Bound on the H100: operations. At 8x512 a point costs ~3.7 MFLOP against
// 12 bytes in and 4 out. What the TPU kernel was written for holds here too:
// only the points and one code a fruit travel from memory; each block
// builds its [code | xyz] rows in shared memory, where the generic forward
// (mlp_fwd.cu) would read a materialised [B * N, C + 3] input (140 bytes a
// row: 287 MB at 40^3 x 32 fruits, against 0.77 MB of points). The TPU
// kernel's selector and one-hot matmuls (Mosaic cannot reshape across the
// sublane/lane split) have no counterpart: a thread writes each element
// where it belongs. The chain is the forward of decoder_chain.cuh (64-row
// chunks on the tensor cores in bf16, 32-row chunks of f32 FMA), the same
// code as B1, B2 and B3. Folding the code's share of layer 0 into a
// per-fruit bias would save 32 of the 1.8 M multiply-adds a row, so it is
// not done.
#include "decoder_chain.cuh"

using namespace horti;

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    mlp_shared_latent_kernel(const float* __restrict__ latents, const float* __restrict__ pts,
                             int n_pts, DecoderWeights<WT> w, float* __restrict__ out) {
  constexpr int ROWS = kFwdRows<WT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = w.in_dim, C = in_dim - 3;
  ChainBuf buf = chain_carve<WT, ROWS>(smem, w.D, in_dim);
  const long row0 = (long)blockIdx.x * ROWS;
  const float* lat = latents + (size_t)blockIdx.y * C;

  for (int e = threadIdx.x; e < ROWS * buf.xcols; e += kThreads) {
    const int i = e % buf.xcols;
    const long r = row0 + e / buf.xcols;
    float v = 0.f;
    if (i < C)
      v = lat[i];
    else if (i < in_dim && r < n_pts)
      v = pts[r * 3 + (i - C)];
    chain_store_x<WT>(buf, e / buf.xcols, i, v);
  }
  __syncthreads();
  chain_forward<WT, ROWS>(w, buf);
  float* o = out + (size_t)blockIdx.y * n_pts;
  for (int r = threadIdx.x; r < ROWS; r += kThreads)
    if (row0 + r < n_pts) o[row0 + r] = buf.y[r];
}

template <typename WT>
static int launch(const float* latents, int n_codes, const float* pts, int n_pts,
                  const DecoderWeights<WT>& w, float* out, cudaStream_t stream) {
  constexpr int ROWS = kFwdRows<WT>;
  const size_t smem = chain_buf_bytes<WT, ROWS>(w.D, w.in_dim);
  cudaError_t err = cudaFuncSetAttribute(mlp_shared_latent_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_pts + ROWS - 1) / ROWS), (unsigned)n_codes);
  mlp_shared_latent_kernel<WT><<<grid, kThreads, smem, stream>>>(latents, pts, n_pts, w, out);
  return (int)cudaGetLastError();
}

extern "C" int horti_mlp_shared_latent(const void* latents, int n_codes, const void* pts,
                                       int n_pts, int in_dim, int D, int n_mid, int li, int bf16,
                                       const void* w0, const void* w0tk,
                                       const void* wm, const void* wmt, const void* wl,
                                       const void* b0, const void* bm, float bl, void* out,
                                       void* stream) {
  if (D % 128 != 0 || D > kMaxWidth || in_dim > D || in_dim < 3 || n_mid < 0 || n_codes > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_pts <= 0 || n_codes <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    DecoderWeights<T> w{(const T*)w0, (const T*)w0tk, (const T*)wm, (const T*)wmt,
                        (const T*)wl, (const float*)b0, (const float*)bm, bl, D, n_mid, li, in_dim};
    return launch<T>((const float*)latents, n_codes, (const float*)pts, n_pts, w, (float*)out, s);
  }
  DecoderWeights<float> w{(const float*)w0, (const float*)w0tk,
                          (const float*)wm, (const float*)wmt, (const float*)wl, (const float*)b0,
                          (const float*)bm, bl, D, n_mid, li, in_dim};
  return launch<float>((const float*)latents, n_codes, (const float*)pts, n_pts, w, (float*)out, s);
}
