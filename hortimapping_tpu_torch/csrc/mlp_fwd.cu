// Decoder forward for N independent [code | xyz] rows.
//
// Replaces the TPU kernel `_fwd_kernel` (hortimapping_tpu/ops/pallas_mlp.py,
// reached through `mlp_sdf` / `PallasDecoder.sdf`): the tanh sdf [N] of each
// row, no gradient. The port's retrieval scoring runs through it.
//
// Bound on the H100: operations. At 8x512 a row costs ~3.7 MFLOP against
// 140 bytes in and 4 out, so the kernel lives by its matmul rate; the
// weights come from L2. Design: one block of 256 threads per chunk of rows
// (64 rows in bf16, so each weight fragment fetched from L2 serves 64 rows;
// 32 in f32), the activations of the chunk never leave shared memory, and
// with no backward to feed no ReLU sign masks are kept. The chain is the
// forward of decoder_chain.cuh, the same code B1 and B2 run: bf16 on the
// tensor cores (mma.sync, f32 accumulation), f32 FMA on the CUDA cores (no
// TF32). In f32 it is slower than the plain version's cuBLAS matmuls, as
// B1 is (PERF.md).
#include "decoder_chain.cuh"

using namespace horti;

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const float* __restrict__ xin, int n_rows, DecoderWeights<WT> w,
                   float* __restrict__ sdf) {
  constexpr int ROWS = kFwdRows<WT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = w.in_dim;
  ChainBuf buf = chain_carve<WT, ROWS>(smem, w.D, in_dim);
  const long row0 = (long)blockIdx.x * ROWS;

  for (int e = threadIdx.x; e < ROWS * buf.xcols; e += kThreads) {
    const int i = e % buf.xcols;
    const long r = row0 + e / buf.xcols;
    chain_store_x<WT>(buf, e / buf.xcols, i,
                      r < n_rows && i < in_dim ? xin[r * in_dim + i] : 0.f);
  }
  __syncthreads();
  chain_forward<WT, ROWS>(w, buf);
  for (int r = threadIdx.x; r < ROWS; r += kThreads)
    if (row0 + r < n_rows) sdf[row0 + r] = buf.y[r];
}

template <typename WT>
static int launch(const float* x, int n_rows, const DecoderWeights<WT>& w, float* sdf,
                  cudaStream_t stream) {
  constexpr int ROWS = kFwdRows<WT>;
  const size_t smem = chain_buf_bytes<WT, ROWS>(w.D, w.in_dim);
  cudaError_t err = cudaFuncSetAttribute(mlp_fwd_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_rows + ROWS - 1) / ROWS);
  mlp_fwd_kernel<WT><<<blocks, kThreads, smem, stream>>>(x, n_rows, w, sdf);
  return (int)cudaGetLastError();
}

extern "C" int horti_mlp_fwd(const void* x, int n_rows, int in_dim, int D, int n_mid, int li,
                             int bf16, const void* w0, const void* w0tk,
                             const void* wm, const void* wmt, const void* wl, const void* b0,
                             const void* bm, float bl, void* sdf, void* stream) {
  if (D % 128 != 0 || D > kMaxWidth || in_dim > D || n_mid < 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    DecoderWeights<T> w{(const T*)w0, (const T*)w0tk, (const T*)wm, (const T*)wmt,
                        (const T*)wl, (const float*)b0, (const float*)bm, bl, D, n_mid, li, in_dim};
    return launch<T>((const float*)x, n_rows, w, (float*)sdf, s);
  }
  DecoderWeights<float> w{(const float*)w0, (const float*)w0tk,
                          (const float*)wm, (const float*)wmt, (const float*)wl, (const float*)b0,
                          (const float*)bm, bl, D, n_mid, li, in_dim};
  return launch<float>((const float*)x, n_rows, w, (float*)sdf, s);
}
