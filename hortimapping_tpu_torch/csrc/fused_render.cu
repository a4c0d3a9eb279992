// The whole occlusion-aware render residual term in one launch.
//
// Replaces the TPU kernel `_fused_render_kernel` (hortimapping_tpu/ops/
// pallas_render.py, reached through `fused_render`): for every ray of every
// frame of every fruit, the decoder forward on its M samples, the in-radius
// mask, sdf -> occupancy (linear or logistic), the transmittance product,
// the rendered depth (with termination bin) and occupancy, the suffix sums
// behind d depth/d occ and d mask/d occ, the band and min-grad masks, the
// occlusion rejection of background rays, the per-ray residuals and
// in-radius count, and, only on tiles with a surviving band sample, the
// decoder input-gradient backward chained through the pose [I | -p^ | p]
// and summed per ray into the depth and mask Jacobians [pose_dim + C].
//
// Bound on the H100: operations (the decoder chain, ~3.7 MFLOP a sample
// forward and as much again backward at 8x512) against a few dozen bytes a
// sample in and ~330 bytes a ray out. Design:
//   * grid (ray tiles, frames, fruits): one launch for the batch, replacing
//     the JAX vmap over frames and fruits; a tile holds whole rays (TR rays x
//     M samples, TR = 128 / M), so the transmittance product, the suffix sum
//     and the per-ray Jacobian sums are block-local loops with no atomics;
//   * the decoder chain of decoder_chain.cuh runs over the tile in chunks
//     of 64 rows (bf16, so each weight fragment from L2 serves 64 rows) or
//     32 (f32); the forward keeps one ReLU sign bit per activation of the
//     whole tile in shared memory (16 KB per 32 rows at 8x512), so the
//     backward needs no second forward;
//   * the render math runs one thread per ray, along the ray;
//   * two gates skip work as the TPU kernel does: a frozen LM lane
//     (active = 0) writes zeros and returns, and a tile without any band
//     sample skips the backward entirely;
//   * the backward runs on the tile's band rows only (a sample whose
//     Jacobian weights are not both zero), gathered in order into 32-row
//     chunks with their sign words and tanh outputs, so its cost follows
//     the band (~1/6 of the samples at the bench shape), not the tile.
// The frame-level `min_valid_sample` gate needs all tiles of a frame and
// stays in the PyTorch epilogue (ops/render.py).
#include "decoder_chain.cuh"

using namespace horti;

struct RenderArgs {
  const float* pts;     // [B][F][R][M][3] object-frame sample points
  const float* rinfo;   // [B][F][R][3]: depth_obs, is_fg, ray_valid
  const float* depths;  // [B][F][M] ray-marching depths
  const float* fscal;   // [B][F][3]: delta_d, d_term_bg, bbx_radius
  const float* active;  // [B] 0 = frozen lane
  const float* latent;  // [B][C]
  float* jd;            // [B][F][R][J] depth Jacobian, J = pose_dim + C
  float* jm;            // [B][F][R][J] mask Jacobian
  float* res;           // [B][F][R][4]: res_d, res_m, ray_ok, in-radius count
  int F, R, M, C, J, tr, n_chunks, pose_dim, scale_on, log_occ_on, occlusion_on;
  float occ_cutoff, sigma, occlusion_th, min_grad_th;
};

// Shared-memory 4-byte words of one block besides the chain's and the masks.
__host__ __device__ inline size_t render_smem_words(int C, int J, int tr, int n_chunks) {
  const size_t rows_cap = (size_t)n_chunks * kChunk;
  return (size_t)C + rows_cap * 7 + kChunk + 1 + (size_t)tr * 4 + 2 * (size_t)tr * J;
}

__device__ __forceinline__ float occupancy(float s, const RenderArgs& a) {
  if (a.log_occ_on) {
    const float z = -s / a.sigma;
    return 1.f / (1.f + expf(-z));
  }
  return 0.5f - fminf(fmaxf(s, -a.occ_cutoff), a.occ_cutoff) / (2.f * a.occ_cutoff);
}

// Column d of the per-sample Jacobian [d/d trans | d/d rot | d/d scale | d/d code]
// from the input gradient g = [g_code (C) | g_xyz (3)] at object point p:
// trans = g_xyz, rot = p x g_xyz, scale = g_xyz . p.
__device__ __forceinline__ float jac_entry(int d, const float* g, const float* p, int C,
                                           int pose_dim) {
  const float g0 = g[C], g1 = g[C + 1], g2 = g[C + 2];
  if (d < 3) return g[C + d];
  if (d == 3) return p[1] * g2 - p[2] * g1;
  if (d == 4) return p[2] * g0 - p[0] * g2;
  if (d == 5) return p[0] * g1 - p[1] * g0;
  if (d < pose_dim) return g0 * p[0] + g1 * p[1] + g2 * p[2];  // Sim(3) scale
  return g[d - pose_dim];
}

// Forward chunks of kFwdRows rows (decoder_chain.cuh); band chunks of the
// backward: 32.
// 32-row units of a tile of tr rays x M samples, rounded up to whole
// forward chunks.
__host__ __device__ inline int render_units(int tr, int M, bool bf16) {
  const int per = (bf16 ? kFwdRows<__nv_bfloat16> : kFwdRows<float>) / kChunk;
  return ((tr * M + kChunk - 1) / kChunk + per - 1) / per * per;
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) fused_render_kernel(RenderArgs a, DecoderWeights<WT> w) {
  constexpr int FR = kFwdRows<WT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = w.D, in_dim = w.in_dim, M = a.M, C = a.C, J = a.J, tr = a.tr;
  const int b = blockIdx.z, f = blockIdx.y;
  const int r0 = blockIdx.x * tr;
  const int nr = min(tr, a.R - r0);
  const long frame = (long)b * a.F + f;
  const long ray0 = frame * a.R + r0;  // global index of the tile's first ray

  if (a.active[b] <= 0.5f) {  // frozen LM lane: its outputs are discarded
    for (int e = threadIdx.x; e < nr * J; e += kThreads) {
      a.jd[ray0 * J + e] = 0.f;
      a.jm[ray0 * J + e] = 0.f;
    }
    for (int e = threadIdx.x; e < nr * 4; e += kThreads) a.res[ray0 * 4 + e] = 0.f;
    return;
  }

  const int rows_cap = a.n_chunks * kChunk;
  ChainBuf buf = chain_carve<WT, FR>(smem, D, in_dim);
  float* lat = reinterpret_cast<float*>(smem + chain_buf_bytes<WT, FR>(D, in_dim));  // [C]
  float* P = lat + C;                               // [rows_cap][3]
  float* sdf = P + (size_t)rows_cap * 3;            // [rows_cap]
  float* wd = sdf + rows_cap;                       // [rows_cap] depth weight per sample
  float* wmk = wd + rows_cap;                       // [rows_cap] mask weight per sample
  float* rayv = wmk + rows_cap;                     // [tr][4]
  float* Jd = rayv + (size_t)tr * 4;                // [tr][J]
  float* Jm = Jd + (size_t)tr * J;                  // [tr][J]
  float* yb = Jm + (size_t)tr * J;                  // [kChunk] tanh outputs of a band chunk
  int* band_rows = reinterpret_cast<int*>(yb + kChunk);  // [rows_cap] band rows, in order
  int* n_band = band_rows + rows_cap;
  uint32_t* masks = reinterpret_cast<uint32_t*>(n_band + 1);  // [rows_cap / FR][chain masks]
  const size_t cmw = chain_mask_words(D, w.n_mid, FR);
  uint32_t* band_masks = masks + (rows_cap / FR) * cmw;  // [chain masks] of a 32-row band chunk

  const int rows = nr * M;
  const int nc = (rows + FR - 1) / FR;
  for (int e = threadIdx.x; e < C; e += kThreads) lat[e] = a.latent[(long)b * C + e];
  for (int e = threadIdx.x; e < rows_cap * 3; e += kThreads)
    P[e] = e < rows * 3 ? a.pts[ray0 * M * 3 + e] : 0.f;
  __syncthreads();

  // ---- decoder forward over the tile, chunk by chunk ----
  for (int c = 0; c < nc; ++c) {
    for (int e = threadIdx.x; e < FR * buf.xcols; e += kThreads) {
      const int r = e / buf.xcols, i = e % buf.xcols, row = c * FR + r;
      chain_store_x<WT>(buf, r, i, i < C ? lat[i] : i < in_dim ? P[row * 3 + i - C] : 0.f);
    }
    __syncthreads();
    chain_forward<WT, FR>(w, buf, masks + c * cmw);
    for (int r = threadIdx.x; r < FR; r += kThreads) sdf[c * FR + r] = buf.y[r];
    __syncthreads();
  }

  // ---- render math, one thread per ray ----
  const float* fs = a.fscal + frame * 3;
  const float delta_d = fs[0], d_term_bg = fs[1], bbx = fs[2];
  const float* dep = a.depths + frame * M;
  const float cut = a.occ_cutoff;
  int any_band = 0;
  for (int t = threadIdx.x; t < nr; t += kThreads) {
    const float* ri = a.rinfo + (ray0 + t) * 3;
    const float depth_obs = ri[0], is_fg = ri[1];
    const bool ray_valid = ri[2] > 0.5f;
    float trans = 1.f, occ_ray = 0.f, du = 0.f, count = 0.f;
    for (int m = 0; m < M; ++m) {
      const int row = t * M + m;
      const float* p = P + row * 3;
      const bool valid = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2] < bbx * bbx) && ray_valid;
      const float occ = valid ? occupancy(sdf[row], a) : 0.f;
      const float tp = occ * trans;
      occ_ray += tp;
      du += dep[m] * tp;
      trans *= 1.f - occ;
      wd[row] = trans;  // inclusive transmittance, read back by the suffix pass
      count += valid ? 1.f : 0.f;
    }
    const float term_end = trans;
    const float d_u = du + d_term_bg * term_end;
    const bool occluded = a.occlusion_on && is_fg < 0.5f && depth_obs < d_u - a.occlusion_th &&
                          depth_obs > 0.f;
    float suffix = 0.f;
    bool ok = false;
    for (int m = M - 1; m >= 0; --m) {
      const int row = t * M + m;
      const float* p = P + row * 3;
      const bool valid = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2] < bbx * bbx) && ray_valid;
      const float s = sdf[row];
      const float occ = valid ? occupancy(s, a) : 0.f;
      suffix += wd[row];
      const float one_minus = 1.f - occ;
      const float denom = one_minus <= 0.f ? 1.f : one_minus;
      const float de_do = suffix * delta_d / denom;
      const float dm_do = term_end / denom;
      const float do_ds = a.log_occ_on ? -occ * (1.f - occ) / a.sigma : -1.f / (2.f * cut);
      const bool keep = valid && s > -cut && s < cut && de_do > a.min_grad_th && !occluded;
      wd[row] = keep ? de_do * do_ds : 0.f;
      wmk[row] = keep ? dm_do * do_ds : 0.f;
      ok = ok || keep;
    }
    const float target = is_fg > 0.5f ? depth_obs : d_term_bg;
    rayv[t * 4 + 0] = ok ? target - d_u : 0.f;
    rayv[t * 4 + 1] = ok ? occ_ray - is_fg : 0.f;
    rayv[t * 4 + 2] = ok ? 1.f : 0.f;
    rayv[t * 4 + 3] = count;
    any_band |= ok ? 1 : 0;
  }
  const int band = __syncthreads_or(any_band);

  // ---- backward only where a band sample survived, and only on its rows ----
  if (band) {
    for (int e = threadIdx.x; e < tr * J; e += kThreads) {
      Jd[e] = 0.f;
      Jm[e] = 0.f;
    }
    if (threadIdx.x < 32) {  // warp 0 lists the band rows (non-zero weight), in order
      const int lane = threadIdx.x;
      int nb = 0;
      for (int base = 0; base < rows; base += 32) {
        const int row = base + lane;
        const bool keep = row < rows && (wd[row] != 0.f || wmk[row] != 0.f);
        const unsigned bits = __ballot_sync(0xffffffffu, keep);
        if (keep) band_rows[nb + __popc(bits & ((1u << lane) - 1u))] = row;
        nb += __popc(bits);
      }
      if (lane == 0) *n_band = nb;
    }
    __syncthreads();
    const int nb = *n_band, words = D / 32;
    const int band_layer = (int)mask_layer_words(D), fwd_layer = (int)mask_layer_words(D, FR);
    const int band_words = (int)chain_mask_words(D, w.n_mid);
    for (int c0 = 0; c0 < nb; c0 += kChunk) {
      const int n = min(kChunk, nb - c0);
      // gather the chunk's sign words and tanh outputs; rows past n stay zero
      for (int e = threadIdx.x; e < band_words; e += kThreads) {
        const int l = e / band_layer, r = (e % band_layer) / words, q = e % words;
        uint32_t v = 0u;
        if (r < n) {
          const int row = band_rows[c0 + r];
          v = masks[(row / FR) * cmw + l * fwd_layer + (row % FR) * words + q];
        }
        band_masks[e] = v;
      }
      for (int r = threadIdx.x; r < kChunk; r += kThreads)
        yb[r] = r < n ? sdf[band_rows[c0 + r]] : 0.f;
      __syncthreads();
      chain_input_grad<WT>(w, band_masks, yb, buf);
      const float* gx = buf.gx;
      for (int e = threadIdx.x; e < nr * J; e += kThreads) {
        const int t = e / J, d = e % J;
        float sd = 0.f, sm = 0.f;
        for (int r = 0; r < n; ++r) {
          const int row = band_rows[c0 + r];
          if (row / M != t) continue;
          const float v = jac_entry(d, gx + r * in_dim, P + row * 3, C, a.pose_dim);
          sd = fmaf(v, wd[row], sd);
          sm = fmaf(v, wmk[row], sm);
        }
        Jd[e] += sd;
        Jm[e] += sm;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < nr * J; e += kThreads) {
      const float ok = rayv[(e / J) * 4 + 2];
      a.jd[ray0 * J + e] = Jd[e] * ok;
      a.jm[ray0 * J + e] = Jm[e] * ok;
    }
  } else {
    for (int e = threadIdx.x; e < nr * J; e += kThreads) {
      a.jd[ray0 * J + e] = 0.f;
      a.jm[ray0 * J + e] = 0.f;
    }
  }
  for (int e = threadIdx.x; e < nr * 4; e += kThreads) a.res[ray0 * 4 + e] = rayv[e];
}

template <typename WT>
static int launch(const RenderArgs& a, const DecoderWeights<WT>& w, int B, size_t smem,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.R + a.tr - 1) / a.tr), (unsigned)a.F, (unsigned)B);
  fused_render_kernel<WT><<<grid, kThreads, smem, stream>>>(a, w);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block, in bytes (the wrapper sizes TR by it).
extern "C" long horti_fused_render_smem(int D, int n_mid, int in_dim, int C, int J, int tr, int M,
                                        int bf16) {
  const int n_chunks = render_units(tr, M, bf16);
  const size_t chain = bf16 ? chain_buf_bytes<__nv_bfloat16, kFwdRows<__nv_bfloat16>>(D, in_dim)
                            : chain_buf_bytes<float, kFwdRows<float>>(D, in_dim);
  return (long)(chain + render_smem_words(C, J, tr, n_chunks) * 4 +
                (size_t)(n_chunks + 1) * chain_mask_words(D, n_mid) * sizeof(uint32_t));
}

extern "C" int horti_fused_render(const void* pts, const void* rinfo, const void* depths,
                                  const void* fscal, const void* active, const void* latent, int B,
                                  int F, int R, int M, int C, int tr, int pose_dim, int scale_on,
                                  int log_occ_on, int occlusion_on, float occ_cutoff, float sigma,
                                  float occlusion_th, float min_grad_th, int D, int n_mid, int li,
                                  int bf16, const void* w0, const void* w0t, const void* w0tk,
                                  const void* wm, const void* wmt, const void* wl, const void* b0,
                                  const void* bm, float bl, void* jd, void* jm, void* res,
                                  void* stream) {
  if (D % 128 != 0 || D > kMaxWidth || C + 3 > D || tr < 1 || M < 2 || F > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0 || R == 0) return (int)cudaSuccess;
  RenderArgs a;
  a.pts = (const float*)pts;
  a.rinfo = (const float*)rinfo;
  a.depths = (const float*)depths;
  a.fscal = (const float*)fscal;
  a.active = (const float*)active;
  a.latent = (const float*)latent;
  a.jd = (float*)jd;
  a.jm = (float*)jm;
  a.res = (float*)res;
  a.F = F;
  a.R = R;
  a.M = M;
  a.C = C;
  a.J = pose_dim + C;
  a.tr = tr;
  a.n_chunks = render_units(tr, M, bf16);
  a.pose_dim = pose_dim;
  a.scale_on = scale_on;
  a.log_occ_on = log_occ_on;
  a.occlusion_on = occlusion_on;
  a.occ_cutoff = occ_cutoff;
  a.sigma = sigma;
  a.occlusion_th = occlusion_th;
  a.min_grad_th = min_grad_th;
  const size_t smem = (size_t)horti_fused_render_smem(D, n_mid, C + 3, C, a.J, tr, M, bf16);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    DecoderWeights<T> w{(const T*)w0, (const T*)w0t, (const T*)w0tk, (const T*)wm, (const T*)wmt,
                        (const T*)wl, (const float*)b0, (const float*)bm, bl, D, n_mid, li, C + 3};
    return launch<T>(a, w, B, smem, s);
  }
  DecoderWeights<float> w{(const float*)w0, (const float*)w0t, (const float*)w0tk,
                          (const float*)wm, (const float*)wmt, (const float*)wl, (const float*)b0,
                          (const float*)bm, bl, D, n_mid, li, C + 3};
  return launch<float>(a, w, B, smem, s);
}
