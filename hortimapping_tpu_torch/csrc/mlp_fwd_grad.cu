// Decoder forward + input gradient for independent [code | xyz] rows.
//
// Replaces the TPU kernel `_fwd_grad_kernel` (hortimapping_tpu/ops/
// pallas_mlp.py, reached through `mlp_sdf_and_input_grad`): sdf [N] and
// d sdf / d [code, xyz] [N, C+3], no weight gradients.
//
// Bound on the H100: operations (at 8x512 a row costs ~7.4 MFLOP forward
// and backward against 140 bytes of input and output). Design
// (stream_chain.cuh): one block per 64-row chunk, a cluster of blocks along
// x sharing every weight byte through a multicast TMA bulk copy into a
// shared-memory ring, so no thread holds weights it prefetches in
// registers; f32 on the CUDA cores (no TF32), bf16 on wgmma. The
// activations never leave shared memory; the backward keeps one ReLU sign
// bit each (32 KB per chunk at 8x512). In f32 the FMA loop itself takes
// most of the time (PERF.md).
//
// Lanes: the rows are `n_lanes` lanes of `rows_per_lane` rows (the LM's
// fruits); grid (chunks of a lane, lanes), a cluster along x so that it
// never spans two lanes. A block of a frozen lane (active = 0) writes zeros
// and returns at once, its whole cluster with it.
#include "stream_chain.cuh"

using namespace horti;

template <typename WT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mlp_fwd_grad_kernel(const float* __restrict__ xin, int rows_per_lane,
                        const float* __restrict__ active, StreamWeights<WT> w,
                        float* __restrict__ sdf, float* __restrict__ grad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int in_dim = w.in_dim;
  const int lane_id = blockIdx.y, c0 = blockIdx.x * kSRows;
  const long row0 = (long)lane_id * rows_per_lane + c0;
  const int n = min(kSRows, rows_per_lane - c0);  // <= 0 on a padding chunk

  if (active != nullptr && active[lane_id] <= 0.5f) {  // frozen LM lane
    for (int r = threadIdx.x; r < n; r += blockDim.x) sdf[row0 + r] = 0.f;
    for (int e = threadIdx.x; e < n * in_dim; e += blockDim.x) grad[row0 * in_dim + e] = 0.f;
    return;
  }
  Ring ring = ring_init<WT>(smem, w, 1, true);
  Chain64 c = chain64_carve<WT>(smem + ring_region_bytes<WT>(w.D, in_dim), w.D, w.n_mid, in_dim,
                                true);
  if (threadIdx.x >= kConsumerThreads) {
    producer_role(ring);
    return;
  }
  consumer_start();
  const int k0 = stream_k0<WT>(in_dim);
  for (int e = threadIdx.x; e < kSRows * k0; e += kConsumerThreads) {
    const int r = e / k0, i = e % k0;
    chain64_store_x<WT>(c, in_dim, r, i, r < n && i < in_dim ? xin[(row0 + r) * in_dim + i] : 0.f);
  }
  publish<WT>();
  chain64_forward<WT>(w, c, ring);
  chain64_input_grad<WT>(w, c, ring);
  for (int r = threadIdx.x; r < n; r += kConsumerThreads) sdf[row0 + r] = c.y[r];
  for (int e = threadIdx.x; e < n * in_dim; e += kConsumerThreads)
    grad[row0 * in_dim + e] = c.gx[e];
  cluster_sync();  // no block leaves while another may still signal its barriers
}

template <typename WT>
static size_t smem_bytes(int D, int n_mid, int in_dim) {
  return ring_region_bytes<WT>(D, in_dim) + chain64_bytes<WT>(D, n_mid, in_dim, true);
}

// Dynamic shared memory of one block, in bytes.
extern "C" long horti_mlp_fwd_grad_smem(int D, int n_mid, int in_dim, int bf16) {
  return (long)(bf16 ? smem_bytes<__nv_bfloat16>(D, n_mid, in_dim)
                     : smem_bytes<float>(D, n_mid, in_dim));
}

// Clusters of one block the card holds at once (blocks of a wave / kCluster),
// or minus a cudaError_t.
extern "C" int horti_mlp_fwd_grad_clusters(int D, int n_mid, int in_dim, int bf16) {
  return bf16 ? max_active_clusters(mlp_fwd_grad_kernel<__nv_bfloat16>,
                                    smem_bytes<__nv_bfloat16>(D, n_mid, in_dim))
              : max_active_clusters(mlp_fwd_grad_kernel<float>, smem_bytes<float>(D, n_mid, in_dim));
}

template <typename WT>
static int launch(const float* x, int rows_per_lane, int n_lanes, const float* active,
                  const StreamWeights<WT>& w, float* sdf, float* grad, cudaStream_t stream) {
  const int chunks = round_up((rows_per_lane + kSRows - 1) / kSRows, kCluster);
  return launch_cluster(mlp_fwd_grad_kernel<WT>, dim3((unsigned)chunks, (unsigned)n_lanes),
                        smem_bytes<WT>(w.D, w.n_mid, w.in_dim), stream, x, rows_per_lane, active,
                        w, sdf, grad);
}

// x [n_lanes * rows_per_lane][in_dim]; active [n_lanes] or null (all active);
// fwd / bwd: the weight streams of `pack_params`.
extern "C" int horti_mlp_fwd_grad(const void* x, int rows_per_lane, int n_lanes, const void* active,
                                  int in_dim, int D, int n_mid, int li, int bf16, const void* fwd,
                                  const void* bwd, const void* wl, const void* b0, const void* bm,
                                  float bl, void* sdf, void* grad, void* stream) {
  if (!chain_dims_ok(D, n_mid, in_dim) || n_lanes > 65535) return (int)cudaErrorInvalidValue;
  if (rows_per_lane <= 0 || n_lanes <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch<T>((const float*)x, rows_per_lane, n_lanes, (const float*)active,
                     stream_weights<T>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim),
                     (float*)sdf, (float*)grad, s);
  }
  return launch<float>((const float*)x, rows_per_lane, n_lanes, (const float*)active,
                       stream_weights<float>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim),
                       (float*)sdf, (float*)grad, s);
}
