// Frozen DeepSDF decoder forward (ReLU layers, latent_in skip, tanh head)
// shared by the two forward-only kernels of the port, mlp_fwd.cu (B3) and
// mlp_shared_latent.cu (B4), as the Pallas kernels share `_fwd_chain` in
// hortimapping_tpu/ops/pallas_mlp.py. The fwd+input-grad kernel (B1) and
// the fused render kernels (B2) run the Hopper chain of stream_chain.cuh,
// which takes its small helpers from here.
//
// Layout on Hopper (not the TPU's): a block of 256 threads (8 warps) pushes
// a chunk of 32 rows (64 with bf16) through the chain; the activations of
// the chunk live in shared memory and never reach device memory. Weights
// (3.7 MB in bf16, 7.4 MB in f32 for 8x512) stay in L2 and stream to the
// SMs layer by layer.
// The latent_in skip writes x into the last C+3 columns of layer li's input
// (layer li-1's padded output columns are zero).
//
// Storage type WT picks the arithmetic:
//   * float: f32 FMA on the CUDA cores (no TF32 anywhere). Activations f32
//     [32][D]; each thread owns 8 rows x 8 columns, two groups of 4
//     (columns 4 tx .. 4 tx + 3 and 256 + 4 tx ..), so its weights of one k
//     are two 16-byte loads.
//   * __nv_bfloat16: tensor cores, mma.sync m16n8k16 with f32 accumulation.
//     Activations bf16 [rows][D + 8] (the pad spreads fragment loads over
//     the banks); each warp owns every 16-row tile of n-tiles warp + 8 t and
//     streams its B fragments from L2 through its own cp.async ring. Every
//     matmul operand is rounded to bf16 first, as the JAX package's
//     `.astype(cdt)` before each dot; bf16 x bf16 products are exact in f32.
//
// A chunk fetches every weight from L2 once: 32 rows a chunk make 32 FLOP a
// weight byte, so the chain runs near the L2's rate (see PERF.md).
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace horti {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;             // rows per pass through the chain (default)
constexpr int kColThreads = 64;        // f32 path: 4 row groups x 64 column threads
constexpr int kCols = 8;               // f32 path: columns per thread, f32_col(tx, j)
constexpr int kRows = 8;               // f32 path: rows per thread, 8 ty .. 8 ty + 7
constexpr int kMaxWidth = kColThreads * kCols;  // 512
constexpr int kMaxNT = kMaxWidth / 8 / kWarps;  // bf16 path: n-tiles per warp
constexpr int kPadBf16 = 8;            // bf16 row pad (elements)
constexpr int kStages = 3;             // bf16 path: k-steps of weights in the ring per warp
constexpr int kStageBytes = kMaxNT * 8 * 32;  // one warp's B fragments of one k-step

// Rows a forward chunk: 64 on the tensor cores (each weight fragment then
// serves 64 rows), 32 for the f32 chain (more spill its registers).
template <typename WT>
constexpr int kFwdRows = std::is_same<WT, __nv_bfloat16>::value ? 64 : kChunk;

template <typename WT>
struct DecoderWeights {
  const WT* w0;     // [in_dim][D]  layer 0, [in][out]
  const WT* w0tk;   // [D][round16(in_dim)] layer 0 transposed, zero-padded in k (bf16 forward)
  const WT* wm;     // [n_mid][D][D] layers 1..n_mid, [in][out]
  const WT* wmt;    // [n_mid][D][D] the same transposed, [out][in]
  const WT* wl;     // [D] head weights (single output column)
  const float* b0;  // [D]
  const float* bm;  // [n_mid][D]
  float bl;         // head bias
  int D, n_mid, li, in_dim;  // li = 0: no latent_in skip
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared-memory buffers of one chunk of ROWS rows: h activations, x input
// (rounded to WT, zero past in_dim), y tanh out, and (bf16 path) each
// warp's ring of weight fragments.
struct ChainBuf {
  unsigned char* ring;
  void* h;
  void* x;
  float* y;
  int ldh, ldx, xcols;
};

template <typename WT>
__host__ __device__ inline void chain_dims(int D, int in_dim, int& ldh, int& ldx, int& xcols) {
  if (std::is_same<WT, bf16>::value) {
    ldh = D + kPadBf16;
    xcols = round16(in_dim);
    ldx = xcols + kPadBf16;
  } else {
    ldh = D;
    xcols = in_dim;
    ldx = in_dim;
  }
}

template <typename WT>
__host__ __device__ inline size_t ring_bytes() {
  return std::is_same<WT, bf16>::value ? (size_t)kWarps * kStages * kStageBytes : 0;
}

template <typename WT, int ROWS = kChunk>
__host__ __device__ inline size_t chain_buf_bytes(int D, int in_dim) {
  int ldh, ldx, xcols;
  chain_dims<WT>(D, in_dim, ldh, ldx, xcols);
  return ring_bytes<WT>() + align16((size_t)ROWS * ldh * sizeof(WT)) +
         align16((size_t)ROWS * ldx * sizeof(WT)) + align16(ROWS * sizeof(float));
}

template <typename WT, int ROWS = kChunk>
__device__ inline ChainBuf chain_carve(unsigned char* base, int D, int in_dim) {
  ChainBuf b;
  chain_dims<WT>(D, in_dim, b.ldh, b.ldx, b.xcols);
  b.ring = base;
  base += ring_bytes<WT>();
  b.h = base;
  base += align16((size_t)ROWS * b.ldh * sizeof(WT));
  b.x = base;
  base += align16((size_t)ROWS * b.ldx * sizeof(WT));
  b.y = reinterpret_cast<float*>(base);
  return b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// round to the storage type (identity for f32)
template <typename WT>
__device__ __forceinline__ float round_st(float v);
template <>
__device__ __forceinline__ float round_st<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_st<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename WT>
__device__ __forceinline__ void chain_store_x(ChainBuf& b, int r, int i, float v) {
  reinterpret_cast<WT*>(b.x)[r * b.ldx + i] = static_cast<WT>(round_st<WT>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ f32 path

// Column of the f32 path's accumulator j (0..7) in thread tx's two groups.
__device__ __forceinline__ int f32_col(int tx, int j) {
  return 4 * tx + (kMaxWidth / 2) * (j / 4) + j % 4;
}

// acc[i][j] = sum_k in[(8 ty + i) * ld_in + k] * W[k * ldw + f32_col(tx, j)]
// for the groups of 4 columns that start below N (ldw % 4 == 0, W 16-byte
// aligned, W's columns from N up to round4(N) zero). Ends with a barrier, so
// the caller may overwrite `in` with the result.
__device__ __forceinline__ void fma_matmul(const float* __restrict__ in, int ld_in, int K,
                                           const float* __restrict__ W, int ldw, int N,
                                           float (&acc)[kRows][kCols]) {
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  const float* a_rows = in + ty * kRows * ld_in;
  // The weights of the next k-step are loaded while this one multiplies, two
  // 16-byte loads a k; a group past N loads group 0 and is zeroed, so no load
  // sits in a branch. Where rows allow it a step is 4 k wide (one 16-byte
  // load of A per row); the sums run in k order either way.
  auto load_w = [&](float (&dst)[kCols], int k) {
    const float* wk = W + (size_t)k * ldw;
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g) {
      const int c = f32_col(tx, 4 * g);
      const float4 v = __ldg(reinterpret_cast<const float4*>(wk + (c < N ? c : 0)));
      const bool ok = c < N;
      dst[4 * g + 0] = ok ? v.x : 0.f;
      dst[4 * g + 1] = ok ? v.y : 0.f;
      dst[4 * g + 2] = ok ? v.z : 0.f;
      dst[4 * g + 3] = ok ? v.w : 0.f;
    }
  };
  if (K % 4 == 0 && ld_in % 4 == 0) {
    float w[4][kCols], wn[4][kCols];
#pragma unroll
    for (int q = 0; q < 4; ++q) load_w(w[q], q);
#pragma unroll 1
    for (int k = 0; k < K; k += 4) {
      const int kn = min(k + 4, K - 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) load_w(wn[q], kn + q);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a_rows + i * ld_in + k);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc[i][j] = fmaf(a.x, w[0][j], acc[i][j]);
          acc[i][j] = fmaf(a.y, w[1][j], acc[i][j]);
          acc[i][j] = fmaf(a.z, w[2][j], acc[i][j]);
          acc[i][j] = fmaf(a.w, w[3][j], acc[i][j]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < kCols; ++j) w[q][j] = wn[q][j];
    }
  } else {
    float w[kCols], wn[kCols];
    load_w(w, 0);
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      load_w(wn, min(k + 1, K - 1));
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = a_rows[i * ld_in + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = wn[j];
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------ bf16 path

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// 16-byte global -> shared copy that bypasses L1; valid = false writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// acc[mt][t] (16 x 8 tiles, rows 16 mt .., columns 8 (warp + 8 t) ..) =
// A [16 MT][K] (bf16 smem, row stride lda) @ B, with B given transposed as
// Bt [N][K] (bf16 global, row stride ldb, ldb % 8 == 0). K % 16 == 0. Ends
// with a barrier.
//
// Each warp streams its own B fragments through a ring of kStages k-steps
// in shared memory with cp.async, so kStages - 1 steps of weight loads are
// in flight while one step multiplies, without registers to hold them. A
// stage holds, per n-tile, 8 rows of 32 bytes (16 k values); rows 4..7 swap
// their two 16-byte halves so the fragment reads hit 32 distinct banks.
// Rows past N are zero-filled. Each fragment serves all MT row tiles, so
// more rows a chunk means fewer weight bytes from L2 per FLOP.
template <int MT>
__device__ __forceinline__ void mma_matmul(const bf16* __restrict__ A, int lda, int K,
                                           const bf16* __restrict__ Bt, int ldb, int N,
                                           unsigned char* ring, float (&acc)[MT][kMaxNT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int NT = (N + 7) / 8, steps = K / 16;
  unsigned char* wring = ring + (size_t)warp * kStages * kStageBytes;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
  // lane copies 16-byte pieces i = lane + 32 j: n-tile i / 16, row (i / 2) % 8, half i % 2
  auto issue = [&](int step) {
    if (step < steps) {
      unsigned char* st = wring + (step % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kMaxNT * 16 / 32; ++j) {
        const int i = lane + 32 * j, t = i / 16, r = (i / 2) % 8, hf = i % 2;
        const int n = (warp + kWarps * t) * 8 + r;
        const bf16* src = Bt + (size_t)(n < N ? n : 0) * ldb + step * 16 + hf * 8;
        cp_async16(st + t * 256 + r * 32 + ((hf ^ (r >> 2)) * 16), src, n < N);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    issue(step + kStages - 1);
    cp_async_wait_stages();  // this step's group has landed
    __syncwarp();
    const int k0 = step * 16;
    const unsigned char* st = wring + (step % kStages) * kStageBytes + g * 32 + tq * 4;
    const int h0 = (g >> 2) * 16, h1 = 16 - h0;
    uint32_t b[kMaxNT][2];
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t) {
      b[t][0] = *reinterpret_cast<const uint32_t*>(st + t * 256 + h0);
      b[t][1] = *reinterpret_cast<const uint32_t*>(st + t * 256 + h1);
    }
    __syncwarp();  // every lane has read the stage before it is refilled
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bf16* ar = A + (mt * 16 + g) * lda + k0 + tq * 2;
      const uint32_t a[4] = {lds32(ar), lds32(ar + 8 * lda), lds32(ar + 8),
                             lds32(ar + 8 * lda + 8)};
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t)
        if (warp + kWarps * t < NT) mma_16816(acc[mt][t], a, b[t][0], b[t][1]);  // warp-uniform
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// ------------------------------------------------------------------ chain

// Forward of one chunk of ROWS rows (32, or 64 with bf16): reads buf.x,
// writes buf.y. Every thread of the block calls it.
template <typename WT, int ROWS = kChunk>
__device__ void chain_forward(const DecoderWeights<WT>& w, ChainBuf& buf) {
  const int lane = threadIdx.x & 31;
  const int D = w.D, in_dim = w.in_dim, ldh = buf.ldh;
  WT* h = reinterpret_cast<WT*>(buf.h);
  const WT* x = reinterpret_cast<const WT*>(buf.x);
  for (int l = 0; l <= w.n_mid; ++l) {
    const float* bias = l == 0 ? w.b0 : w.bm + (size_t)(l - 1) * D;
    if constexpr (std::is_same<WT, bf16>::value) {
      constexpr int MT = ROWS / 16;
      float acc[MT][kMaxNT][4];
      if (l == 0) {
        mma_matmul<MT>(x, buf.ldx, buf.xcols, w.w0tk, buf.xcols, D, buf.ring, acc);
      } else {
        mma_matmul<MT>(h, ldh, D, w.wmt + (size_t)(l - 1) * D * D, D, D, buf.ring, acc);
      }
      const int g = lane >> 2, tq = lane & 3, warp = threadIdx.x >> 5;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < kMaxNT; ++t) {
          const int c = (warp + kWarps * t) * 8 + tq * 2;
          if (c < D) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = mt * 16 + g + hf * 8;
              const float v0 = fmaxf(acc[mt][t][2 * hf] + bias[c], 0.f);
              const float v1 = fmaxf(acc[mt][t][2 * hf + 1] + bias[c + 1], 0.f);
              *reinterpret_cast<__nv_bfloat162*>(h + r * ldh + c) = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
    } else {
      static_assert(ROWS == kChunk, "the f32 chain takes 32-row chunks");
      float acc[kRows][kCols];
      if (l == 0) {
        fma_matmul(x, in_dim, in_dim, w.w0, D, D, acc);
      } else {
        fma_matmul(h, D, D, w.wm + (size_t)(l - 1) * D * D, D, D, acc);
      }
      const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const int c = f32_col(tx, 4 * g);
          if (c < D) {  // D is a multiple of 128: whole groups
            const float4 b = *reinterpret_cast<const float4*>(bias + c);
            *reinterpret_cast<float4*>(h + r * D + c) = make_float4(
                fmaxf(acc[i][4 * g] + b.x, 0.f), fmaxf(acc[i][4 * g + 1] + b.y, 0.f),
                fmaxf(acc[i][4 * g + 2] + b.z, 0.f), fmaxf(acc[i][4 * g + 3] + b.w, 0.f));
          }
        }
      }
    }
    __syncthreads();
    if (l + 1 == w.li) {
      // latent_in: layer li reads concat(h, x); the last in_dim outputs of
      // layer li-1 are zero-padded, so the concat is a write into them
      for (int e = threadIdx.x; e < ROWS * in_dim; e += kThreads) {
        const int r = e / in_dim, i = e % in_dim;
        h[r * ldh + D - in_dim + i] = x[r * buf.ldx + i];
      }
      __syncthreads();
    }
  }
  // head: one warp per row, tanh(h . wl + bl)
  const int warp = threadIdx.x / 32;
  for (int r = warp; r < ROWS; r += kWarps) {
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s = fmaf(to_float(h[r * ldh + c]), to_float(w.wl[c]), s);
    s = warp_sum(s);
    if (lane == 0) buf.y[r] = tanhf(s + w.bl);
  }
  __syncthreads();
}

}  // namespace horti
