// Decoder forward for N points that share one latent code, for B codes at
// once: out[b, n] = tanh sdf of [latent_b | pts_n].
//
// Replaces the TPU kernel `_shared_latent_kernel` (hortimapping_tpu/ops/
// pallas_mlp.py, reached through `mlp_sdf_shared_latent`), which the JAX
// mesher vmaps over codes; here one launch covers every fruit. The port's
// mesher decodes its voxel grids through it.
//
// Bound on the H100: operations. At 8x512 a point costs ~3.7 MFLOP against
// 12 bytes in and 4 out. What the TPU kernel was written for holds here too:
// only the points and one code a fruit travel from memory; each block
// builds its [code | xyz] rows in shared memory, where the generic forward
// (mlp_fwd.cu) would read a materialised [B * N, C + 3] input (140 bytes a
// row: 287 MB at 40^3 x 32 fruits, against 0.77 MB of points). The TPU
// kernel's selector and one-hot matmuls (Mosaic cannot reshape across the
// sublane/lane split) have no counterpart: a thread writes each element
// where it belongs. The work is (fruit, 64-point chunk) pairs, ceil(N / 64)
// chunks a fruit, flattened over the fruits, so a chunk never spans two
// fruits; one wave of clusters takes pairs of them in turn through the
// forward of stream_chain.cuh (`forward_wave`, the body B3 runs). Folding
// the code's share of layer 0 into a per-fruit bias would save 32 of the
// 1.8 M multiply-adds a row, so it is not done.
#include "stream_chain.cuh"

using namespace horti;

// latents [B][C], pts [n_pts][3] -> out [B][n_pts]; chunk = b x per_code + j
struct SharedLatentRows {
  const float* latents;
  const float* pts;
  float* outp;
  int n_pts, C, per_code, n_chunks;
  __device__ __forceinline__ float in(int chunk, int r, int i) const {
    const int b = chunk / per_code, p = (chunk % per_code) * kSRows + r;
    if (chunk >= n_chunks || p >= n_pts) return 0.f;  // padding chunk or row
    return i < C ? latents[(long)b * C + i] : pts[(long)p * 3 + i - C];
  }
  __device__ __forceinline__ void out(int chunk, int r, float y) const {
    const int b = chunk / per_code, p = (chunk % per_code) * kSRows + r;
    if (chunk < n_chunks && p < n_pts) outp[(long)b * n_pts + p] = y;
  }
};

template <typename WT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mlp_shared_latent_kernel(StreamWeights<WT> w, SharedLatentRows rows) {
  forward_wave<WT>(w, rows);
}

// Dynamic shared memory of one block, in bytes.
extern "C" long horti_mlp_shared_latent_smem(int D, int n_mid, int in_dim, int bf16) {
  return (long)(bf16 ? forward_wave_smem<__nv_bfloat16>(D, n_mid, in_dim)
                     : forward_wave_smem<float>(D, n_mid, in_dim));
}

// Clusters of kCluster blocks the card holds at once (one wave), or minus a
// cudaError_t.
extern "C" int horti_mlp_shared_latent_clusters(int D, int n_mid, int in_dim, int bf16) {
  return bf16 ? max_active_clusters(mlp_shared_latent_kernel<__nv_bfloat16>,
                                    forward_wave_smem<__nv_bfloat16>(D, n_mid, in_dim))
              : max_active_clusters(mlp_shared_latent_kernel<float>,
                                    forward_wave_smem<float>(D, n_mid, in_dim));
}

// latents [n_codes][in_dim - 3], pts [n_pts][3]; fwd / bwd: the weight
// streams of `pack_params` (the forward reads fwd only). Chunk indices are
// ints: at most 2^30 chunks, n_codes x ceil(n_pts / 64).
extern "C" int horti_mlp_shared_latent(const void* latents, int n_codes, const void* pts,
                                       int n_pts, int in_dim, int D, int n_mid, int li, int bf16,
                                       const void* fwd, const void* bwd, const void* wl,
                                       const void* b0, const void* bm, float bl, void* out,
                                       void* stream) {
  const int per_code = (n_pts + kSRows - 1) / kSRows;
  if (!chain_dims_ok(D, n_mid, in_dim) || in_dim < 3 || (long)n_codes * per_code > (1L << 30))
    return (int)cudaErrorInvalidValue;
  if (n_pts <= 0 || n_codes <= 0) return (int)cudaSuccess;
  const SharedLatentRows rows{(const float*)latents, (const float*)pts, (float*)out,
                              n_pts, in_dim - 3, per_code, n_codes * per_code};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_forward_wave(
        mlp_shared_latent_kernel<T>,
        stream_weights<T>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim), rows, s);
  }
  return launch_forward_wave(
      mlp_shared_latent_kernel<float>,
      stream_weights<float>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim), rows, s);
}
