// Decoder forward for N independent [code | xyz] rows.
//
// Replaces the TPU kernel `_fwd_kernel` (hortimapping_tpu/ops/pallas_mlp.py,
// reached through `mlp_sdf` / `PallasDecoder.sdf`): the tanh sdf [N] of each
// row, no gradient. The port's retrieval scoring runs through it.
//
// Bound on the H100: operations. At 8x512 a row costs ~3.7 MFLOP against
// 140 bytes in and 4 out, so the kernel lives by its matmul rate. Design: the
// forward of stream_chain.cuh, the chain B1 and B2 run (64-row chunks, the
// weights multicast by TMA bulk copies to a cluster of 2 blocks, wgmma in
// bf16, f32 FMA without TF32), with no ReLU sign words kept; one wave of
// clusters takes pairs of chunks in turn (`forward_wave`), so a block sets
// up its ring once for all its chunks.
#include "stream_chain.cuh"

using namespace horti;

// x [n_rows][in_dim] -> sdf [n_rows]
struct FwdRows {
  const float* x;
  float* sdf;
  int n_rows, in_dim, n_chunks;
  __device__ __forceinline__ float in(int chunk, int r, int i) const {
    const long row = (long)chunk * kSRows + r;
    return row < n_rows ? x[row * in_dim + i] : 0.f;
  }
  __device__ __forceinline__ void out(int chunk, int r, float y) const {
    const long row = (long)chunk * kSRows + r;
    if (row < n_rows) sdf[row] = y;
  }
};

template <typename WT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mlp_fwd_kernel(StreamWeights<WT> w, FwdRows rows) {
  forward_wave<WT>(w, rows);
}

// Dynamic shared memory of one block, in bytes.
extern "C" long horti_mlp_fwd_smem(int D, int n_mid, int in_dim, int bf16) {
  return (long)(bf16 ? forward_wave_smem<__nv_bfloat16>(D, n_mid, in_dim)
                     : forward_wave_smem<float>(D, n_mid, in_dim));
}

// Clusters of kCluster blocks the card holds at once (one wave), or minus a
// cudaError_t.
extern "C" int horti_mlp_fwd_clusters(int D, int n_mid, int in_dim, int bf16) {
  return bf16 ? max_active_clusters(mlp_fwd_kernel<__nv_bfloat16>,
                                    forward_wave_smem<__nv_bfloat16>(D, n_mid, in_dim))
              : max_active_clusters(mlp_fwd_kernel<float>,
                                    forward_wave_smem<float>(D, n_mid, in_dim));
}

// x [n_rows][in_dim]; fwd / bwd: the weight streams of `pack_params` (the
// forward reads fwd only).
extern "C" int horti_mlp_fwd(const void* x, int n_rows, int in_dim, int D, int n_mid, int li,
                             int bf16, const void* fwd, const void* bwd, const void* wl,
                             const void* b0, const void* bm, float bl, void* sdf, void* stream) {
  if (!chain_dims_ok(D, n_mid, in_dim)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaSuccess;
  const FwdRows rows{(const float*)x, (float*)sdf, n_rows, in_dim, (n_rows + kSRows - 1) / kSRows};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_forward_wave(
        mlp_fwd_kernel<T>, stream_weights<T>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim),
        rows, s);
  }
  return launch_forward_wave(
      mlp_fwd_kernel<float>, stream_weights<float>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim),
      rows, s);
}
