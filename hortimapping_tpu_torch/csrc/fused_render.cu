// The whole occlusion-aware render residual term.
//
// Replaces the TPU kernel `_fused_render_kernel` (hortimapping_tpu/ops/
// pallas_render.py, reached through `fused_render`): for every ray of every
// frame of every fruit, the decoder forward on its M samples, the in-radius
// mask, sdf -> occupancy (linear or logistic), the transmittance product,
// the rendered depth (with termination bin) and occupancy, the suffix sums
// behind d depth/d occ and d mask/d occ, the band and min-grad masks, the
// occlusion rejection of background rays, the per-ray residuals and
// in-radius count, and the decoder input-gradient backward on the band
// samples chained through the pose [I | -p^ | p] and summed per ray into
// the depth and mask Jacobians [pose_dim + C].
//
// Bound on the H100: operations (the decoder chain, ~3.7 MFLOP a sample
// forward at 8x512, as much again backward on the ~16 % of samples in the
// band) against a few dozen bytes a sample. The chain is stream_chain.cuh:
// 64-row chunks, the weights shared over a cluster, wgmma in bf16. The
// render math reads the sdf of a sample only where the sample lies inside
// the frame's radius on a valid ray of an active lane, so the chain runs on
// those samples alone. A tile holds whole rays (tr rays x M samples, at
// most 128 rows), a frame's tiles padded to whole clusters with empty ones.
// The forward, every kernel named render_forward_kernel (stages):
//   1. select: a warp a tile lists the tile's in-radius samples (the same
//      f32 test as the math, `in_radius`), in sample order, into the tile's
//      slot, with their count; a scan of the counts (the wrapper's
//      torch.cumsum) places each tile's list in the packed order;
//   2. pack: a warp a tile copies its list to its packed place;
//   3. chain: one wave of clusters over the packed rows, in full 64-row
//      chunks; each cluster reads the total from the scan on the card (the
//      host never reads it) and takes every n-th pair of chunks, its ring
//      streaming the weights for all of them. A row gathers its fruit's
//      latent and its point and writes its sdf to [B][F][R][M]. Rows are
//      independent in the chain, so each sdf has the bits a dense forward
//      would give it;
//   4. math: one thread a ray, along the ray, the rays of several tiles a
//      warp. A tile writes its residuals and its band rows (samples whose
//      depth or mask weight is not zero, in sample order) into its own slot
//      of the record scratch, with their count; a frozen LM lane
//      (active = 0) writes zeros.
// Then the band:
//   5. the band rows of the whole launch, packed in tile order by an
//      exclusive scan of the counts (torch.cumsum again), go through
//      render_band_kernel in full 64-row chunks: the forward again (with
//      sign bits) and the input-gradient backward, each row's [J]
//      contributions (jac_entry x wd, x wmk) written to its packed slot, one
//      wave of clusters as in stage 3;
//   6. render_sum_kernel: one block per tile sums its rays' contributions in
//      sample order and applies ray_ok.
// No atomics: every output has one writer and a fixed summation order, so
// two launches on the same inputs agree bit for bit.
// The frame-level `min_valid_sample` gate needs all tiles of a frame and
// stays in the PyTorch epilogue (ops/render.py).
#include "stream_chain.cuh"

using namespace horti;

constexpr int kRec = 8;          // floats a band record: ray, wd, wmk, p[3], pad
constexpr int kTileRows = 128;   // samples a tile holds at most
constexpr int kSumThreads = 128;
constexpr int kLightWarps = 4;   // warps a block of the select, pack and math stages
constexpr int kLightThreads = 32 * kLightWarps;
constexpr int kMathRows = 1024;  // samples of a warp's tiles in the math stage at most

enum Stage { kSelect, kPack, kChain, kMath };

struct RenderArgs {
  const float* pts;     // [B][F][R][M][3] object-frame sample points
  const float* rinfo;   // [B][F][R][3]: depth_obs, is_fg, ray_valid
  const float* depths;  // [B][F][M] ray-marching depths
  const float* fscal;   // [B][F][3]: delta_d, d_term_bg, bbx_radius
  const float* active;  // [B] 0 = frozen lane
  const float* latent;  // [B][C]
  int* idx;             // [n_tiles][tr * M] in-radius samples of each tile
  int* fcounts;         // [n_tiles + 1]: 0, then the in-radius samples of each tile
  const int* foffsets;  // [n_tiles + 1] their scan: where each tile's list starts, the total
  int* packed;          // [n_tiles * tr * M] the launch's in-radius samples, packed
  float* sdf;           // [B][F][R][M], written at the in-radius samples
  float* res;           // [B][F][R][4]: res_d, res_m, ray_ok, in-radius count
  float* recs;          // [n_tiles][tr * M][kRec] band records
  int* counts;          // [n_tiles] band rows of each tile
  int F, R, M, C, tr, tiles_x, n_tiles, pose_dim, log_occ_on, occlusion_on;
  float occ_cutoff, sigma, occlusion_th, min_grad_th;
};

// A tile's place: tile = (b F + f) tiles_x + x holds rays x tr .. of frame (b, f)
struct TileAt {
  long frame, ray0;  // the tile's frame and the global index of its first ray
  int b, nr;         // its fruit; its rays (0 on a padding tile)
};
__device__ __forceinline__ TileAt tile_at(const RenderArgs& a, long tile) {
  TileAt t;
  t.frame = tile / a.tiles_x;
  const int r0 = (int)(tile % a.tiles_x) * a.tr;
  t.nr = max(0, min(a.tr, a.R - r0));
  t.b = (int)(t.frame / a.F);
  t.ray0 = t.frame * a.R + r0;
  return t;
}

// |p|^2 < bbx^2 with every rounding fixed, the one contraction nvcc makes
// of p0 p0 + p1 p1 + p2 p2: the select stage and the math take the same
// decision on every sample
__device__ __forceinline__ bool in_radius(const float* p, float bbx) {
  return __fmaf_rn(p[2], p[2], __fmaf_rn(p[0], p[0], __fmul_rn(p[1], p[1]))) < __fmul_rn(bbx, bbx);
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

// Stage 1, a warp a tile: the tile's in-radius samples of valid rays of an
// active lane, as global sample indices in sample order, and their count
// (after a leading 0, so that an inclusive scan gives the offsets).
__device__ __forceinline__ void select_stage(const RenderArgs& a) {
  const int lane = threadIdx.x & 31, M = a.M, cap = a.tr * M;
  const long tile = (long)blockIdx.x * kLightWarps + (threadIdx.x >> 5);
  if (tile >= a.n_tiles) return;
  const TileAt t = tile_at(a, tile);
  const int rows = a.active[t.b] > 0.5f ? t.nr * M : 0;
  const float bbx = a.fscal[t.frame * 3 + 2];
  int nb = 0;
  for (int base = 0; base < rows; base += 32) {
    const int row = base + lane;
    const long s = t.ray0 * M + row;
    const bool in = row < rows && a.rinfo[(t.ray0 + row / M) * 3 + 2] > 0.5f &&
                    in_radius(a.pts + s * 3, bbx);
    const unsigned bits = __ballot_sync(0xffffffffu, in);
    if (in) a.idx[tile * cap + nb + __popc(bits & ((1u << lane) - 1u))] = (int)s;
    nb += __popc(bits);
  }
  if (lane == 0) a.fcounts[tile + 1] = nb;
  if (tile == 0 && lane == 0) a.fcounts[0] = 0;
}

// Stage 2, a warp a tile: the tile's list to its place in the packed order.
__device__ __forceinline__ void pack_stage(const RenderArgs& a) {
  const long tile = (long)blockIdx.x * kLightWarps + (threadIdx.x >> 5);
  if (tile >= a.n_tiles) return;
  const int q0 = a.foffsets[tile], n = a.foffsets[tile + 1] - q0;
  for (int i = threadIdx.x & 31; i < n; i += 32) a.packed[q0 + i] = a.idx[tile * a.tr * a.M + i];
}

// In-radius samples of the launch, read on the card.
__device__ __forceinline__ int fwd_total(const RenderArgs& a) { return a.foffsets[a.n_tiles]; }

// Shared memory of the chain stage besides the ring and the chain, in
// 4-byte words: P [64][3], sample [64].
constexpr int kChainExtraWords = kSRows * 4;

// Stage 3: the decoder forward over the packed rows, one wave of clusters.
// Group g of chunks (one a block of the cluster) goes to cluster g mod the
// clusters of the grid; a cluster without one returns whole, before its
// ring exists. The loop carries only g; the total is re-read.
template <typename WT>
__device__ __forceinline__ void chain_stage(const RenderArgs& a, const StreamWeights<WT>& w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = w.D, in_dim = w.in_dim, C = a.C, k0 = stream_k0<WT>(in_dim);
  constexpr int kGroupRows = kSRows * kCluster;
  const int groups = (fwd_total(a) + kGroupRows - 1) / kGroupRows;
  const int cid = blockIdx.x / kCluster, n_cl = gridDim.x / kCluster;
  if (cid >= groups) return;
  Ring ring = ring_init<WT>(smem, w, (groups - cid + n_cl - 1) / n_cl, false, kFwdSlots<WT>);
  unsigned char* cbase = smem + ring_region_bytes<WT>(D, in_dim, kFwdSlots<WT>);
  Chain64 c = chain64_carve<WT>(cbase, D, w.n_mid, in_dim, false);
  float* P = reinterpret_cast<float*>(cbase + chain64_bytes<WT>(D, w.n_mid, in_dim, false));
  int* sample = reinterpret_cast<int*>(P + kSRows * 3);  // -1 past the total

  if (threadIdx.x >= kConsumerThreads) {
    producer_role(ring);
    return;
  }
  consumer_start();
  const int fruit_samples = a.F * a.R * a.M;
  for (int g = cid; g * kGroupRows < fwd_total(a); g += gridDim.x / kCluster) {
    const int q0 = (g * kCluster + (int)(blockIdx.x % kCluster)) * kSRows;
    for (int r = threadIdx.x; r < kSRows; r += kConsumerThreads) {
      const int s = q0 + r < fwd_total(a) ? a.packed[q0 + r] : -1;
      sample[r] = s;
      for (int k = 0; k < 3; ++k) P[r * 3 + k] = s < 0 ? 0.f : a.pts[(long)s * 3 + k];
    }
    consumer_sync();
    for (int e = threadIdx.x; e < kSRows * k0; e += kConsumerThreads) {
      const int r = e / k0, i = e % k0, s = sample[r];
      const float v = s < 0 || i >= in_dim ? 0.f
                      : i < C              ? a.latent[(long)(s / fruit_samples) * C + i]
                                           : P[r * 3 + i - C];
      chain64_store_x<WT>(c, in_dim, r, i, v);
    }
    publish<WT>();
    chain64_forward<WT>(w, c, ring);  // ends with a consumer barrier: y is whole
    // the same thread wrote sample[r]: the next gather may overwrite it
    for (int r = threadIdx.x; r < kSRows; r += kConsumerThreads)
      if (sample[r] >= 0) a.sdf[sample[r]] = c.y[r];
  }
  cluster_sync();  // no block leaves while another may still signal its barriers
}

// Tiles a warp of the math stage takes: as many as fill its 32 lanes with
// rays, at most kMathRows samples (shared memory) and at least one.
__host__ __device__ inline int math_tiles(int tr, int M) {
  const int by_lanes = 32 / tr, by_rows = kMathRows / (tr * M);
  const int n = by_lanes < by_rows ? by_lanes : by_rows;
  return n > 1 ? n : 1;
}

// Stage 4: the render math, one thread a ray (u = j tr + t: ray t of the
// warp's tile j), then a warp packs each of its tiles' band rows.
__device__ __forceinline__ void math_stage(const RenderArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, M = a.M, tr = a.tr, cap = tr * M;
  const int wt = math_tiles(tr, M);
  const long tile0 = ((long)blockIdx.x * kLightWarps + (threadIdx.x >> 5)) * wt;
  float* wd = reinterpret_cast<float*>(smem) + (size_t)(threadIdx.x >> 5) * wt * cap * 2;
  float* wmk = wd + wt * cap;  // depth and mask weight of each sample of the warp's tiles
  const float cut = a.occ_cutoff;
  for (int u = lane; u < wt * tr; u += 32) {
    const int j = u / tr, t = u % tr;
    if (tile0 + j >= a.n_tiles) break;
    const TileAt at = tile_at(a, tile0 + j);
    if (t >= at.nr) continue;
    const long ray = at.ray0 + t;
    float4* out = reinterpret_cast<float4*>(a.res + ray * 4);
    if (a.active[at.b] <= 0.5f) {  // frozen LM lane: its outputs are discarded
      *out = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* fs = a.fscal + at.frame * 3;
    const float delta_d = fs[0], d_term_bg = fs[1], bbx = fs[2];
    const float* dep = a.depths + at.frame * M;
    const float* P = a.pts + ray * M * 3;
    const float* sdf = a.sdf + ray * M;
    float* wdr = wd + j * cap + t * M;
    float* wmr = wmk + j * cap + t * M;
    const float* ri = a.rinfo + ray * 3;
    const float depth_obs = ri[0], is_fg = ri[1];
    const bool ray_valid = ri[2] > 0.5f;
    float trans = 1.f, occ_ray = 0.f, du = 0.f, count = 0.f;
    for (int m = 0; m < M; ++m) {
      const bool valid = ray_valid && in_radius(P + m * 3, bbx);
      const float occ = valid ? occupancy(sdf[m], a) : 0.f;
      const float tp = occ * trans;
      occ_ray += tp;
      du += dep[m] * tp;
      trans *= 1.f - occ;
      wdr[m] = trans;  // inclusive transmittance, read back by the suffix pass
      count += valid ? 1.f : 0.f;
    }
    const float term_end = trans;
    const float d_u = du + d_term_bg * term_end;
    const bool occluded = a.occlusion_on && is_fg < 0.5f && depth_obs < d_u - a.occlusion_th &&
                          depth_obs > 0.f;
    float suffix = 0.f;
    bool ok = false;
    for (int m = M - 1; m >= 0; --m) {
      const bool valid = ray_valid && in_radius(P + m * 3, bbx);
      const float s = valid ? sdf[m] : 0.f;
      const float occ = valid ? occupancy(s, a) : 0.f;
      suffix += wdr[m];
      const float one_minus = 1.f - occ;
      const float denom = one_minus <= 0.f ? 1.f : one_minus;
      const float de_do = suffix * delta_d / denom;
      const float dm_do = term_end / denom;
      const float do_ds = a.log_occ_on ? -occ * (1.f - occ) / a.sigma : -1.f / (2.f * cut);
      const bool keep = valid && s > -cut && s < cut && de_do > a.min_grad_th && !occluded;
      wdr[m] = keep ? de_do * do_ds : 0.f;
      wmr[m] = keep ? dm_do * do_ds : 0.f;
      ok = ok || keep;
    }
    const float target = is_fg > 0.5f ? depth_obs : d_term_bg;
    *out = make_float4(ok ? target - d_u : 0.f, ok ? occ_ray - is_fg : 0.f, ok ? 1.f : 0.f, count);
  }
  __syncwarp();

  // ---- band rows (non-zero weight) of each tile, in sample order, into its slot ----
  for (int j = 0; j < wt && tile0 + j < a.n_tiles; ++j) {
    const long tile = tile0 + j;
    const TileAt at = tile_at(a, tile);
    const int rows = a.active[at.b] > 0.5f ? at.nr * M : 0;
    const float* wdt = wd + j * cap;
    const float* wmt = wmk + j * cap;
    float* slot = a.recs + tile * cap * kRec;
    int nb = 0;
    for (int base = 0; base < rows; base += 32) {
      const int row = base + lane;
      const bool keep = row < rows && (wdt[row] != 0.f || wmt[row] != 0.f);
      const unsigned bits = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const float* p = a.pts + (at.ray0 * M + row) * 3;
        float4* rec = reinterpret_cast<float4*>(slot + (size_t)(nb + __popc(bits & ((1u << lane) - 1u))) * kRec);
        rec[0] = make_float4(__int_as_float((int)(at.ray0 + row / M)), wdt[row], wmt[row], p[0]);
        rec[1] = make_float4(p[1], p[2], 0.f, 0.f);
      }
      nb += __popc(bits);
    }
    if (lane == 0) a.counts[tile] = nb;
  }
}

// Every stage of the forward under one kernel name; only the chain uses w.
template <typename WT, int S>
__global__ void __launch_bounds__(S == kChain ? kBlockThreads : kLightThreads, S == kChain ? 1 : 4)
    render_forward_kernel(RenderArgs a, StreamWeights<WT> w) {
  if constexpr (S == kSelect) select_stage(a);
  if constexpr (S == kPack) pack_stage(a);
  if constexpr (S == kChain) chain_stage<WT>(a, w);
  if constexpr (S == kMath) math_stage(a);
}

struct BandArgs {
  const float* recs;    // [n_tiles][cap][kRec]
  const int* offsets;   // [n_tiles + 1] exclusive scan of the band counts
  const float* latent;  // [B][C]
  float* cd;            // [n_tiles * cap][J] depth contributions of each band row
  float* cm;            // [n_tiles * cap][J] mask contributions
  int n_tiles, cap, C, J, pose_dim, rays_per_fruit;
};

// Packed band rows of the launch, read on the card.
__device__ __forceinline__ int band_total(const BandArgs& a) { return a.offsets[a.n_tiles]; }

// Shared memory of the band kernel besides the ring and the chain, in
// 4-byte words: P [64][3], wd, wmk [64], fruit [64].
constexpr int kBandExtraWords = kSRows * 6;

template <typename WT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    render_band_kernel(BandArgs a, StreamWeights<WT> w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = w.D, in_dim = w.in_dim, C = a.C, J = a.J;
  // group g of chunks (one a block of the cluster) goes to cluster g mod
  // the clusters of the grid; a cluster without one returns whole, before
  // its ring exists. The loop carries only g; the total is re-read.
  constexpr int kGroupRows = kSRows * kCluster;
  const int groups = (band_total(a) + kGroupRows - 1) / kGroupRows;
  const int cid = blockIdx.x / kCluster, n_cl = gridDim.x / kCluster;
  if (cid >= groups) return;
  Ring ring = ring_init<WT>(smem, w, (groups - cid + n_cl - 1) / n_cl, true);
  unsigned char* cbase = smem + ring_region_bytes<WT>(D, in_dim);
  Chain64 c = chain64_carve<WT>(cbase, D, w.n_mid, in_dim, true);
  float* P = reinterpret_cast<float*>(cbase + chain64_bytes<WT>(D, w.n_mid, in_dim, true));
  float* wdb = P + kSRows * 3;
  float* wmb = wdb + kSRows;
  int* fruit = reinterpret_cast<int*>(wmb + kSRows);

  if (threadIdx.x >= kConsumerThreads) {
    producer_role(ring);
    return;
  }
  consumer_start();
  for (int g = blockIdx.x / kCluster; g * kGroupRows < band_total(a); g += gridDim.x / kCluster) {
    const int q0 = (g * kCluster + (int)(blockIdx.x % kCluster)) * kSRows;
    const int n = max(0, min(kSRows, band_total(a) - q0));  // 0 on a padding chunk
    // gather: packed row q lies in the last tile t with offsets[t] <= q
    for (int r = threadIdx.x; r < kSRows; r += kConsumerThreads) {
      float wd = 0.f, wm = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
      int fb = -1;
      if (r < n) {
        const int q = q0 + r;
        int lo = 0, hi = a.n_tiles - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (a.offsets[mid] <= q) lo = mid; else hi = mid - 1;
        }
        const float* rec = a.recs + ((size_t)lo * a.cap + (q - a.offsets[lo])) * kRec;
        fb = __float_as_int(rec[0]) / a.rays_per_fruit;
        wd = rec[1];
        wm = rec[2];
        p0 = rec[3];
        p1 = rec[4];
        p2 = rec[5];
      }
      fruit[r] = fb;
      wdb[r] = wd;
      wmb[r] = wm;
      P[r * 3] = p0;
      P[r * 3 + 1] = p1;
      P[r * 3 + 2] = p2;
    }
    consumer_sync();
    const int k0 = stream_k0<WT>(in_dim);
    for (int e = threadIdx.x; e < kSRows * k0; e += kConsumerThreads) {
      const int r = e / k0, i = e % k0, fb = fruit[r];
      const float v = fb < 0 || i >= in_dim ? 0.f
                      : i < C              ? a.latent[(long)fb * C + i]
                                           : P[r * 3 + i - C];
      chain64_store_x<WT>(c, in_dim, r, i, v);
    }
    publish<WT>();
    chain64_forward<WT>(w, c, ring);
    chain64_input_grad<WT>(w, c, ring);
    for (int e = threadIdx.x; e < n * J; e += kConsumerThreads) {
      const int r = e / J, d = e % J;
      const float v = jac_entry(d, c.gx + r * in_dim, P + r * 3, C, a.pose_dim);
      a.cd[(long)q0 * J + e] = v * wdb[r];
      a.cm[(long)q0 * J + e] = v * wmb[r];
    }
    consumer_sync();  // the next chunk's gather overwrites P, wdb, wmb, fruit
  }
  cluster_sync();
}

struct SumArgs {
  const float* recs;
  const int* offsets;
  const float* cd;
  const float* cm;
  const float* res;  // ray_ok in column 2
  float* jd;         // [B][F][R][J]
  float* jm;
  int F, R, tr, tiles_x, cap, J;
};

// One block a tile: each (ray, column) sums its band rows' contributions in
// sample order, times ray_ok; rays without band rows get zeros.
__global__ void __launch_bounds__(kSumThreads) render_sum_kernel(SumArgs a) {
  __shared__ int ray_of[kTileRows];
  const int b = blockIdx.z, f = blockIdx.y, J = a.J;
  const int r0 = blockIdx.x * a.tr;
  const int nr = max(0, min(a.tr, a.R - r0));
  const long frame = (long)b * a.F + f;
  const long ray0 = frame * a.R + r0;
  const long tile = frame * a.tiles_x + blockIdx.x;
  const int q_lo = a.offsets[tile], nb = a.offsets[tile + 1] - q_lo;
  for (int i = threadIdx.x; i < nb; i += kSumThreads)
    ray_of[i] = __float_as_int(a.recs[((size_t)tile * a.cap + i) * kRec]);
  __syncthreads();
  for (int e = threadIdx.x; e < nr * J; e += kSumThreads) {
    const int t = e / J, d = e % J;
    const int ray = (int)(ray0 + t);
    float sd = 0.f, sm = 0.f;
    for (int i = 0; i < nb; ++i) {
      if (ray_of[i] != ray) continue;
      sd += a.cd[(long)(q_lo + i) * J + d];
      sm += a.cm[(long)(q_lo + i) * J + d];
    }
    const float ok = a.res[(ray0 + t) * 4 + 2];
    a.jd[ray0 * J + e] = sd * ok;
    a.jm[ray0 * J + e] = sm * ok;
  }
}

template <typename WT>
static size_t chain_smem(int D, int n_mid, int in_dim) {
  return ring_region_bytes<WT>(D, in_dim, kFwdSlots<WT>) +
         chain64_bytes<WT>(D, n_mid, in_dim, false) + kChainExtraWords * 4;
}
template <typename WT>
static size_t band_smem(int D, int n_mid, int in_dim) {
  return ring_region_bytes<WT>(D, in_dim) + chain64_bytes<WT>(D, n_mid, in_dim, true) +
         kBandExtraWords * 4;
}

// Dynamic shared memory of a block of the forward's chain (kind 0) or of
// the band kernel (kind 1), in bytes (the wrapper checks it against the
// card's limit).
extern "C" long horti_render_smem(int kind, int D, int n_mid, int in_dim, int bf16) {
  if (kind == 0)
    return (long)(bf16 ? chain_smem<__nv_bfloat16>(D, n_mid, in_dim)
                       : chain_smem<float>(D, n_mid, in_dim));
  return (long)(bf16 ? band_smem<__nv_bfloat16>(D, n_mid, in_dim)
                     : band_smem<float>(D, n_mid, in_dim));
}

static RenderArgs render_args(const void* pts, const void* rinfo, const void* depths,
                              const void* fscal, const void* active, const void* latent, int B,
                              int F, int R, int M, int C, int tr, int tiles_x) {
  RenderArgs a = {};
  a.pts = (const float*)pts;
  a.rinfo = (const float*)rinfo;
  a.depths = (const float*)depths;
  a.fscal = (const float*)fscal;
  a.active = (const float*)active;
  a.latent = (const float*)latent;
  a.F = F;
  a.R = R;
  a.M = M;
  a.C = C;
  a.tr = tr;
  a.tiles_x = tiles_x;
  a.n_tiles = tiles_x * F * B;
  return a;
}

static bool tiling_ok(int B, int F, int R, int M, int tr, int tiles_x) {
  return tr >= 1 && tr * M <= kTileRows && M >= 2 && tiles_x % kCluster == 0 &&
         (long)tiles_x * tr >= R && (long)tiles_x * F * B * tr * M < (1L << 31);
}

template <typename WT, int S>
static int launch_light(const RenderArgs& a, const StreamWeights<WT>& w, unsigned blocks,
                        size_t smem, cudaStream_t s) {
  render_forward_kernel<WT, S><<<blocks, kLightThreads, smem, s>>>(a, w);
  return (int)cudaGetLastError();
}

// Stage 1: idx [n_tiles][tr * M] and fcounts [n_tiles + 1]. tiles_x (a
// multiple of kCluster) x tr covers R.
extern "C" int horti_render_select(const void* pts, const void* rinfo, const void* fscal,
                                   const void* active, int B, int F, int R, int M, int tr,
                                   int tiles_x, void* idx, void* fcounts, void* stream) {
  if (!tiling_ok(B, F, R, M, tr, tiles_x)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B == 0 || F == 0 || R == 0) return (int)cudaMemsetAsync(fcounts, 0, sizeof(int), s);
  RenderArgs a = render_args(pts, rinfo, nullptr, fscal, active, nullptr, B, F, R, M, 0, tr,
                             tiles_x);
  a.idx = (int*)idx;
  a.fcounts = (int*)fcounts;
  const unsigned blocks = (unsigned)((a.n_tiles + kLightWarps - 1) / kLightWarps);
  return launch_light<float, kSelect>(a, StreamWeights<float>{}, blocks, 0, s);
}

template <typename WT>
static int launch_forward(const RenderArgs& a, const StreamWeights<WT>& w, cudaStream_t s) {
  const unsigned tiles_blocks = (unsigned)((a.n_tiles + kLightWarps - 1) / kLightWarps);
  int rc = launch_light<WT, kPack>(a, w, tiles_blocks, 0, s);
  if (rc != cudaSuccess) return rc;
  // stage 3: one wave of clusters, no more than the rows could fill if every
  // sample were in radius
  const size_t smem = chain_smem<WT>(w.D, w.n_mid, w.in_dim);
  static WaveCache cache;
  const int wave = wave_clusters(render_forward_kernel<WT, kChain>, smem, cache);
  if (wave <= 0) return wave < 0 ? -wave : (int)cudaErrorInvalidConfiguration;
  const long worst =
      ((long)a.n_tiles * a.tr * a.M + kSRows * kCluster - 1) / (kSRows * kCluster);
  const int clusters = (int)(worst < wave ? worst : wave);
  rc = launch_cluster(render_forward_kernel<WT, kChain>, dim3((unsigned)(clusters * kCluster)),
                      smem, s, a, w);
  if (rc != cudaSuccess) return rc;
  const int wt = math_tiles(a.tr, a.M);
  const int per_block = kLightWarps * wt;
  return launch_light<WT, kMath>(a, w, (unsigned)((a.n_tiles + per_block - 1) / per_block),
                                 (size_t)per_block * a.tr * a.M * 2 * sizeof(float), s);
}

// Stages 2-4: residuals [B][F][R][4], band records and counts, from stage
// 1's idx and the inclusive scan of its fcounts, foffsets [n_tiles + 1]; packed
// [n_tiles * tr * M] and sdf [B][F][R][M] are scratch.
extern "C" int horti_render_forward(const void* pts, const void* rinfo, const void* depths,
                                    const void* fscal, const void* active, const void* latent,
                                    int B, int F, int R, int M, int C, int tr, int tiles_x,
                                    int pose_dim, int log_occ_on, int occlusion_on,
                                    float occ_cutoff, float sigma, float occlusion_th,
                                    float min_grad_th, int D, int n_mid, int li, int bf16,
                                    const void* fwd, const void* bwd, const void* wl,
                                    const void* b0, const void* bm, float bl, const void* idx,
                                    const void* foffsets, void* packed, void* sdf, void* res,
                                    void* recs, void* counts, void* stream) {
  if (!chain_dims_ok(D, n_mid, C + 3) || !tiling_ok(B, F, R, M, tr, tiles_x) || F > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0 || R == 0) return (int)cudaSuccess;
  RenderArgs a = render_args(pts, rinfo, depths, fscal, active, latent, B, F, R, M, C, tr,
                             tiles_x);
  a.idx = (int*)idx;
  a.foffsets = (const int*)foffsets;
  a.packed = (int*)packed;
  a.sdf = (float*)sdf;
  a.res = (float*)res;
  a.recs = (float*)recs;
  a.counts = (int*)counts;
  a.pose_dim = pose_dim;
  a.log_occ_on = log_occ_on;
  a.occlusion_on = occlusion_on;
  a.occ_cutoff = occ_cutoff;
  a.sigma = sigma;
  a.occlusion_th = occlusion_th;
  a.min_grad_th = min_grad_th;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int in_dim = C + 3;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_forward(a, stream_weights<T>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim), s);
  }
  return launch_forward(a, stream_weights<float>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim),
                        s);
}

template <typename WT>
static int launch_band(const BandArgs& a, const StreamWeights<WT>& w, cudaStream_t s) {
  const size_t smem = band_smem<WT>(w.D, w.n_mid, w.in_dim);
  static WaveCache cache;
  const int wave = wave_clusters(render_band_kernel<WT>, smem, cache);
  if (wave <= 0) return wave < 0 ? -wave : (int)cudaErrorInvalidConfiguration;
  // no more clusters than the band could fill if every sample were in it
  const long worst = ((long)a.n_tiles * a.cap + kSRows * kCluster - 1) / (kSRows * kCluster);
  const int clusters = (int)(worst < wave ? worst : wave);
  return launch_cluster(render_band_kernel<WT>, dim3((unsigned)(clusters * kCluster)), smem, s, a,
                        w);
}

// Launch 2: the [J] contributions of the packed band rows, as many as
// offsets[n_tiles] (read on the card); cd, cm hold n_tiles x cap rows.
extern "C" int horti_render_band(const void* recs, const void* offsets, int n_tiles, int cap,
                                 const void* latent, int C, int pose_dim, int rays_per_fruit,
                                 int D, int n_mid, int li, int bf16, const void* fwd,
                                 const void* bwd, const void* wl, const void* b0, const void* bm,
                                 float bl, void* cd, void* cm, void* stream) {
  if (!chain_dims_ok(D, n_mid, C + 3) || n_tiles < 1 || cap < 1 ||
      (long)n_tiles * cap >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  BandArgs a{(const float*)recs, (const int*)offsets, (const float*)latent, (float*)cd, (float*)cm,
             n_tiles, cap, C, pose_dim + C, pose_dim, rays_per_fruit};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int in_dim = C + 3;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_band(a, stream_weights<T>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim), s);
  }
  return launch_band(a, stream_weights<float>(fwd, bwd, wl, b0, bm, bl, D, n_mid, li, in_dim), s);
}

// Launch 3: jd, jm [B][F][R][J] from the contributions.
extern "C" int horti_render_sum(const void* recs, const void* offsets, const void* cd,
                                const void* cm, const void* res, int B, int F, int R, int tr,
                                int tiles_x, int cap, int J, void* jd, void* jm, void* stream) {
  if (tr < 1 || cap > kTileRows || F > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0 || R == 0) return (int)cudaSuccess;
  SumArgs a{(const float*)recs, (const int*)offsets, (const float*)cd, (const float*)cm,
            (const float*)res, (float*)jd, (float*)jm, F, R, tr, tiles_x, cap, J};
  render_sum_kernel<<<dim3((unsigned)tiles_x, (unsigned)F, (unsigned)B), kSumThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
