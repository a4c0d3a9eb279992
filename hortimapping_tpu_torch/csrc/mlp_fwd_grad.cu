// Decoder forward + input gradient for N independent [code | xyz] rows.
//
// Replaces the TPU kernel `_fwd_grad_kernel` (hortimapping_tpu/ops/
// pallas_mlp.py, reached through `mlp_sdf_and_input_grad`): sdf [N] and
// d sdf / d [code, xyz] [N, C+3], no weight gradients.
//
// Bound on the H100: operations. At 8x512 a row costs ~7.4 MFLOP (forward
// and backward) against 140 bytes of input and output, so the kernel lives
// or dies by its matmul rate; the weights come from L2, never from HBM more
// than once. Design: one block of 256 threads per chunk of 32 rows; the
// activations of the chunk never leave shared memory and the backward keeps
// only the ReLU sign bits (16 KB per chunk at 8x512), see decoder_chain.cuh.
// f32 weights multiply in f32 FMA on the CUDA cores (two 16-byte weight
// loads a k per thread), bf16 weights on the tensor cores (mma.sync); wgmma
// is later work. In f32 the chain is still slower than the plain version's
// cuBLAS matmuls at the bench shapes (PERF.md): 64-row chunks, which would
// halve its weight traffic from L2, spilled registers both at 256 threads a
// block (16 x 8 accumulators a thread) and at 512 (a 128-register cap).
#include "decoder_chain.cuh"

using namespace horti;

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_grad_kernel(const float* __restrict__ xin, int n_rows, DecoderWeights<WT> w,
                        float* __restrict__ sdf, float* __restrict__ grad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_dim = w.in_dim;
  ChainBuf buf = chain_carve<WT>(smem, w.D, in_dim);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + chain_buf_bytes<WT>(w.D, in_dim));
  const long row0 = (long)blockIdx.x * kChunk;

  for (int e = threadIdx.x; e < kChunk * buf.xcols; e += kThreads) {
    const int i = e % buf.xcols;
    const long r = row0 + e / buf.xcols;
    chain_store_x<WT>(buf, e / buf.xcols, i,
                      r < n_rows && i < in_dim ? xin[r * in_dim + i] : 0.f);
  }
  __syncthreads();
  chain_forward<WT>(w, buf, masks);
  chain_input_grad<WT>(w, masks, buf.y, buf);
  for (int r = threadIdx.x; r < kChunk; r += kThreads)
    if (row0 + r < n_rows) sdf[row0 + r] = buf.y[r];
  for (int e = threadIdx.x; e < kChunk * in_dim; e += kThreads) {
    const long r = row0 + e / in_dim;
    if (r < n_rows) grad[r * in_dim + e % in_dim] = buf.gx[e];
  }
}

template <typename WT>
static int launch(const float* x, int n_rows, const DecoderWeights<WT>& w, float* sdf, float* grad,
                  cudaStream_t stream) {
  const size_t smem =
      chain_buf_bytes<WT>(w.D, w.in_dim) + chain_mask_words(w.D, w.n_mid) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(mlp_fwd_grad_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_rows + kChunk - 1) / kChunk);
  mlp_fwd_grad_kernel<WT><<<blocks, kThreads, smem, stream>>>(x, n_rows, w, sdf, grad);
  return (int)cudaGetLastError();
}

extern "C" int horti_mlp_fwd_grad(const void* x, int n_rows, int in_dim, int D, int n_mid, int li,
                                  int bf16, const void* w0, const void* w0t, const void* w0tk,
                                  const void* wm, const void* wmt, const void* wl, const void* b0,
                                  const void* bm, float bl, void* sdf, void* grad, void* stream) {
  if (D % 128 != 0 || D > kMaxWidth || in_dim > D || n_mid < 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    DecoderWeights<T> w{(const T*)w0, (const T*)w0t, (const T*)w0tk, (const T*)wm, (const T*)wmt,
                        (const T*)wl, (const float*)b0, (const float*)bm, bl, D, n_mid, li, in_dim};
    return launch<T>((const float*)x, n_rows, w, (float*)sdf, (float*)grad, s);
  }
  DecoderWeights<float> w{(const float*)w0, (const float*)w0t, (const float*)w0tk,
                          (const float*)wm, (const float*)wmt, (const float*)wl, (const float*)b0,
                          (const float*)bm, bl, D, n_mid, li, in_dim};
  return launch<float>((const float*)x, n_rows, w, (float*)sdf, (float*)grad, s);
}
