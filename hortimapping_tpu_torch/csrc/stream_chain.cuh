// Decoder chain of every kernel of the port, built for Hopper: the frozen
// DeepSDF decoder (ReLU layers, latent_in skip, tanh head) forward alone
// (B3, mlp_fwd.cu; B4, mlp_shared_latent.cu), and forward + input gradient
// (B1, mlp_fwd_grad.cu; B2, fused_render.cu): the same arithmetic as
// `_fwd_chain` + `input_grad_chain` in hortimapping_tpu/ops/pallas_mlp.py,
// laid out around the card's weight path.
//
// The layout answers the weight stream from L2 (3.7 MB of bf16 weights at
// 8x512, 7.4 MB in f32, once forward and once backward per chunk of rows).
// Through this ring the stream costs 5-15 % of the chain's time on an H100;
// the rest is the arithmetic and, in bf16, the layer epilogues (PERF.md).
// So:
//   * a block pushes 64 rows a chunk through the chain (two warpgroups of
//     consumers, 256 threads), and a thread-block cluster of kCluster blocks
//     shares one read of every weight byte: each block fetches 1/kCluster of each
//     stage with a TMA bulk copy multicast to every block of the cluster;
//   * the weights are pre-packed (ops/mlp_kernels.py `pack_params`) as a
//     forward and a backward stream of k-stages, each contiguous and laid
//     out as the consumer reads it, so a 1-D bulk copy lands it ready for
//     use (no tensor map);
//   * a ring of stages in shared memory, guarded by mbarriers: `full` (the
//     stage's bytes landed, one arrival + transaction bytes), `empty` (all
//     8 consumer warps of every block of the cluster are done with the
//     slot); one producer thread, in a third warpgroup, refills each slot
//     as soon as it is free. 384 threads cap every thread at 168 registers
//     at launch; setmaxnreg hands the producer warpgroup's down to 24 and
//     the consumers' up to 240 (the block's own pool: 128 x 144 freed, 256
//     x 72 taken), so the f32 chain does not spill;
//   * bf16: the matmuls run on wgmma (m64nNk16, f32 accumulation), A (the
//     activations) and B (the ring stage) read from shared memory in the
//     no-swizzle core-matrix layout; each warpgroup owns N/2 output columns
//     (m64n256k16 at N = 512, one wgmma shape per compile-time width).
//     Every matmul operand is rounded to bf16 first, as the JAX package's
//     `.astype(cdt)` before each dot. The layer epilogues work on the
//     accumulator fragments two columns at a time and build the ReLU sign
//     words in registers;
//   * f32: FMA on the CUDA cores (no TF32 anywhere), each thread 16 rows x 8
//     columns; a stage is 8 weight rows (16 KB at D = 512), read from the
//     ring into registers 4 rows at a time (8-row stages halve the waits
//     and releases of 4-row ones: PERF.md).
// Every block of a cluster consumes the same stages in the same order: the
// callers run every chunk of a block, ragged or empty, through the chain.
// The backward keeps one ReLU sign bit per activation (no second forward).
// The latent_in skip writes x into the last in_dim columns of layer li's
// input (layer li-1's padded output columns are zero).
#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace horti {

using bf16 = __nv_bfloat16;

constexpr int kColThreads = 64;  // f32: 4 row groups x 64 column threads
constexpr int kCols = 8;         // f32: columns a thread, f32_col(tx, j)
constexpr int kMaxWidth = kColThreads * kCols;  // 512, the widest layer

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32: column of a thread's accumulator j (0..7), two groups of 4 columns
// (4 tx .. 4 tx + 3 and 256 + 4 tx ..), so its weights of one k are two
// 16-byte loads
__device__ __forceinline__ int f32_col(int tx, int j) {
  return 4 * tx + (kMaxWidth / 2) * (j / 4) + j % 4;
}

constexpr int kSRows = 64;                              // rows of a chunk
constexpr int kConsumerThreads = 256;                   // two warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kBlockThreads = kConsumerThreads + 128;   // + the producer warpgroup
constexpr int kCluster = 2;  // blocks of a cluster sharing every weight fetch
// registers setmaxnreg leaves each producer thread and gives each consumer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <typename WT>
struct StreamCfg;
template <>
struct StreamCfg<bf16> {
  static constexpr int kK = 32;     // k rows a stage (two wgmma k-steps)
  static constexpr int kSlots = 3;  // ring slots (32 KB each at D = 512)
};
template <>
struct StreamCfg<float> {
  static constexpr int kK = 8;      // a multiple of 4
  static constexpr int kSlots = 3;  // 16 KB each at D = 512
};

// ring slots of a forward-only kernel: it keeps no gradient buffers, so
// there is room for one more
template <typename WT>
constexpr int kFwdSlots = StreamCfg<WT>::kSlots + 1;

template <typename WT>
constexpr bool kIsBf16 = std::is_same<WT, bf16>::value;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// K of layer 0 in the forward stream and N of layer 0 in the backward
// stream (zero-padded; ops/mlp_kernels.py `stream_dims` packs the same).
template <typename WT>
__host__ __device__ inline int stream_k0(int in_dim) {
  return round_up(in_dim, StreamCfg<WT>::kK);
}
template <typename WT>
__host__ __device__ inline int stream_n0(int in_dim) {
  return kIsBf16<WT> ? 128 : round_up(in_dim, 4);
}

template <typename WT>
struct StreamWeights {
  const WT* fwd;    // layer 0 [k0][D], layers 1..n_mid [D][D], as k-stages
  const WT* bwd;    // layers n_mid..1 transposed [D][D], layer 0 transposed [D][n0]
  const WT* wl;     // [D] head weights
  const float* b0;  // [D]
  const float* bm;  // [n_mid][D]
  float bl;
  int D, n_mid, li, in_dim;  // li = 0: no latent_in skip
};

// the weights as the C entries receive them (`pack_params` streams)
template <typename WT>
inline StreamWeights<WT> stream_weights(const void* fwd, const void* bwd, const void* wl,
                                        const void* b0, const void* bm, float bl, int D,
                                        int n_mid, int li, int in_dim) {
  return StreamWeights<WT>{(const WT*)fwd, (const WT*)bwd, (const WT*)wl, (const float*)b0,
                           (const float*)bm, bl, D, n_mid, li, in_dim};
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// the 256 consumer threads of the block (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// arrive on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// lands the bytes (and their complete_tx) at the same offsets in every
// block of `mask`
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// p, hidden from the optimiser, so loads through it stay where they are
// written: in a loop around the chain (the band kernel's) the head weights
// would otherwise be hoisted into registers that live across the chain.
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// ------------------------------------------------------------ weight ring

// The ring and the plan of the stages it carries: `passes` times the
// forward stream, each followed by the backward stream when `per` covers it.
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int slot_bytes, nslots;
  uint32_t rank, csize;
  uint32_t n_push, n_wait, n_rel;  // stages pushed (producer), waited for, released
  const unsigned char* fwd;
  const unsigned char* bwd;
  uint32_t stage_bytes, last_bytes;     // a stage of N = D; of the backward's layer 0
  uint32_t f_stages, b_mid, per, n_total;
};

template <typename WT>
__host__ __device__ inline size_t ring_slot_bytes(int D, int in_dim) {
  const int n = D > stream_n0<WT>(in_dim) ? D : stream_n0<WT>(in_dim);
  return (size_t)StreamCfg<WT>::kK * n * sizeof(WT);
}
template <typename WT>
__host__ __device__ inline size_t ring_region_bytes(int D, int in_dim,
                                                    int slots = StreamCfg<WT>::kSlots) {
  return align16(slots * ring_slot_bytes<WT>(D, in_dim) + 2 * slots * sizeof(uint64_t));
}

__device__ inline void ring_push(Ring& r, const void* src, uint32_t bytes);

// The producer (one thread): every stage of the plan, each into its slot
// as soon as every consumer warp of the cluster has released the slot.
__device__ inline void ring_produce(Ring& r) {
  while (r.n_push < r.n_total) {
    const uint32_t slot = r.n_push % r.nslots, round = r.n_push / r.nslots;
    mbar_wait(&r.empty[slot], (round & 1u) ^ 1u);
    uint32_t i = r.n_push % r.per;
    if (i < r.f_stages) {
      ring_push(r, r.fwd + (size_t)i * r.stage_bytes, r.stage_bytes);
    } else if ((i -= r.f_stages) < r.b_mid) {
      ring_push(r, r.bwd + (size_t)i * r.stage_bytes, r.stage_bytes);
    } else {
      ring_push(r, r.bwd + (size_t)r.b_mid * r.stage_bytes + (size_t)(i - r.b_mid) * r.last_bytes,
                r.last_bytes);
    }
  }
}

// Every thread of the block calls it, before the roles split: the ring of
// `slots` slots for `passes` chunks of the forward (each followed by the
// backward when `backward`).
template <typename WT>
__device__ inline Ring ring_init(unsigned char* base, const StreamWeights<WT>& w, int passes,
                                 bool backward, int slots = StreamCfg<WT>::kSlots) {
  const int D = w.D, in_dim = w.in_dim, kK = StreamCfg<WT>::kK;
  Ring r;
  r.nslots = slots;
  r.slot_bytes = (int)ring_slot_bytes<WT>(D, in_dim);
  r.fwd = reinterpret_cast<const unsigned char*>(w.fwd);
  r.bwd = reinterpret_cast<const unsigned char*>(w.bwd);
  r.stage_bytes = (uint32_t)(kK * D * sizeof(WT));
  r.last_bytes = (uint32_t)(kK * stream_n0<WT>(in_dim) * sizeof(WT));
  r.f_stages = (uint32_t)((stream_k0<WT>(in_dim) + w.n_mid * D) / kK);
  r.b_mid = (uint32_t)(w.n_mid * D / kK);
  r.per = r.f_stages + (backward ? r.b_mid + D / kK : 0);
  r.n_total = r.per * (uint32_t)passes;
  r.slots = base;
  r.full = reinterpret_cast<uint64_t*>(base + (size_t)r.nslots * r.slot_bytes);
  r.empty = r.full + r.nslots;
  r.rank = cluster_rank();
  r.csize = cluster_size();
  r.n_push = r.n_wait = r.n_rel = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < r.nslots; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], kConsumerWarps * r.csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // no block arrives on a barrier of another before it exists
  return r;
}

// The producer warpgroup's whole life after ring_init: it gives up
// registers, one thread feeds the ring, and it leaves with the cluster. The consumers call
// consumer_start, run the chain and end with cluster_sync; the two paths
// never meet again, so ptxas honours both register counts.
__device__ __forceinline__ void producer_role(Ring& r) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
  if (threadIdx.x == kConsumerThreads) ring_produce(r);
  __syncwarp();
  cluster_sync();  // no block leaves while another may still signal its barriers
}
__device__ __forceinline__ void consumer_start() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
}

// The producer: the next stage, `bytes` from `src`, into the next slot of
// every block of the cluster (released by every consumer warp of the
// cluster); this block fetches its 1/csize slice.
__device__ inline void ring_push(Ring& r, const void* src, uint32_t bytes) {
  const uint32_t slot = r.n_push % r.nslots;
  mbar_expect_tx(&r.full[slot], bytes);
  const uint32_t slice = bytes / r.csize;
  unsigned char* dst = r.slots + (size_t)slot * r.slot_bytes + r.rank * slice;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src) + r.rank * slice;
  if (r.csize == 1)
    bulk_copy(dst, s, slice, &r.full[slot]);
  else
    bulk_copy_multicast(dst, s, slice, &r.full[slot], (uint16_t)((1u << r.csize) - 1u));
  ++r.n_push;
}

// Consumers: the next stage, once it has landed.
__device__ __forceinline__ const unsigned char* ring_wait(Ring& r) {
  const uint32_t slot = r.n_wait % r.nslots, round = r.n_wait / r.nslots;
  mbar_wait(&r.full[slot], round & 1u);
  __syncwarp();
  ++r.n_wait;
  return r.slots + (size_t)slot * r.slot_bytes;
}
// Consumers (every thread of each consumer warp): the oldest stage not yet
// released is free again, in every block of the cluster.
__device__ __forceinline__ void ring_release(Ring& r) {
  const uint32_t slot = r.n_rel % r.nslots;
  ++r.n_rel;
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (uint32_t c = 0; c < r.csize; ++c) mbar_arrive_cluster(&r.empty[slot], c);
}

// ------------------------------------------------------------ wgmma (bf16)

// Shared-memory matrix descriptor, no swizzle: 8 x 16-byte core matrices,
// lbo = byte stride between the two core matrices of a k16 step, sbo =
// byte stride between 8-row groups.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the accumulators across an async wgmma
__device__ __forceinline__ void fence_acc(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Element offset of (row r, column k) of a bf16 [64][K] operand in the
// no-swizzle K-major layout: 8 x 8 core matrices of 128 contiguous bytes,
// row groups K * 16 bytes apart, k-chunks 128 bytes apart. f32: row-major.
template <typename WT>
__device__ __forceinline__ int hidx(int r, int k, int K) {
  if constexpr (kIsBf16<WT>)
    return ((r >> 3) * (K >> 3) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
  else
    return r * K + k;
}

// acc = A [64][K] @ W [K][2 NW], W arriving through the ring as K / 32
// stages (each two k16 steps of [n-group][k-chunk][8 n][8 k] core
// matrices). Warpgroup g owns columns g NW .. (g + 1) NW - 1. NW is a
// compile-time width, so each instance issues one wgmma shape on fixed
// accumulator registers. One stage's wgmma group stays in flight while the
// next is issued. Ends with a consumer barrier, so the caller may overwrite A.
template <int NW>
__device__ __forceinline__ void wg_matmul_n(const bf16* A, int K, Ring& ring, float (&acc)[128]) {
  const int wg = threadIdx.x >> 7;
  const uint32_t a0 = smem_u32(A), sbo = (uint32_t)K * 16;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const int stages = K / StreamCfg<bf16>::kK;
  for (int s = 0; s < stages; ++s) {
    const uint32_t st = smem_u32(ring_wait(ring));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t da = wg_desc(a0 + (uint32_t)(2 * s + kk) * 256u, 128, sbo);
      const uint32_t b = st + (uint32_t)(kk * 2 * NW * 32 + wg * NW * 32);
      if constexpr (NW == 256) {
        wgmma_n256(acc, da, wg_desc(b, 128, 256));
      } else {
#pragma unroll
        for (int q = 0; q < NW / 64; ++q)
          wgmma_n64(&acc[32 * q], da, wg_desc(b + q * 2048u, 128, 256));
      }
    }
    wgmma_commit();
    fence_acc(acc);
    if (s > 0) {
      wgmma_wait<1>();
      ring_release(ring);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring_release(ring);
  consumer_sync();
}

// the instance of wg_matmul_n for N (128, 256, 384 or 512)
__device__ inline void wg_matmul(const bf16* A, int K, int N, Ring& ring, float (&acc)[128]) {
  switch (N) {
    case 512: wg_matmul_n<256>(A, K, ring, acc); break;
    case 384: wg_matmul_n<192>(A, K, ring, acc); break;
    case 256: wg_matmul_n<128>(A, K, ring, acc); break;
    default: wg_matmul_n<64>(A, K, ring, acc);
  }
}

// ------------------------------------------------------------ f32 FMA

// acc[16 i + j] (rows 16 ty + i, column f32_col(tx, j)) = A [64][lda] @ W
// [K][N], W arriving through the ring as K / kK stages of kK row-major
// rows, taken 4 rows at a time: their weights go to registers (the slot is
// released after its last 4), then 16 rows x 8 columns x 4 k of FMA. Sums
// run in k order. Ends with a consumer barrier.
__device__ inline void fma_matmul64(const float* A, int lda, int K, int N, Ring& ring,
                                    float (&acc)[128]) {
  constexpr int kK = StreamCfg<float>::kK;
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const float* a_rows = A + ty * 16 * lda;
  for (int s = 0; s < K / kK; ++s) {
    const float* W = reinterpret_cast<const float*>(ring_wait(ring));
    // not unrolled: one 4-row body keeps the registers of kK = 4
#pragma unroll 1
    for (int k4 = 0; k4 < kK; k4 += 4) {
      float w[4][kCols];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const int c = f32_col(tx, 4 * g);
          const float4 v =
              *reinterpret_cast<const float4*>(W + (k4 + q) * N + (c < N ? c : 0));
          const bool ok = c < N;
          w[q][4 * g + 0] = ok ? v.x : 0.f;
          w[q][4 * g + 1] = ok ? v.y : 0.f;
          w[q][4 * g + 2] = ok ? v.z : 0.f;
          w[q][4 * g + 3] = ok ? v.w : 0.f;
        }
      if (k4 + 4 == kK) ring_release(ring);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a_rows + i * lda + kK * s + k4);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float v = acc[i * kCols + j];
          v = fmaf(a.x, w[0][j], v);
          v = fmaf(a.y, w[1][j], v);
          v = fmaf(a.z, w[2][j], v);
          v = fmaf(a.w, w[3][j], v);
          acc[i * kCols + j] = v;
        }
      }
    }
  }
  consumer_sync();
}

// f(row, column, value) for every accumulator of this thread with column < N
template <typename WT, typename F>
__device__ __forceinline__ void acc_foreach(const float (&acc)[128], int N, F f) {
  if constexpr (kIsBf16<WT>) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, NW = N / 2;
    const int r = 16 * (warp & 3) + (lane >> 2), c0 = (warp >> 2) * NW + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (8 * j < NW) {
        const int c = c0 + 8 * j;
        f(r, c, acc[4 * j]);
        f(r, c + 1, acc[4 * j + 1]);
        f(r + 8, c, acc[4 * j + 2]);
        f(r + 8, c + 1, acc[4 * j + 3]);
      }
  } else {
    const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = f32_col(tx, j);
        if (c < N) f(16 * ty + i, c, acc[i * kCols + j]);
      }
  }
}

// bf16 epilogues on the wgmma accumulator layout, two adjacent columns at a
// time (one 4-byte store each): thread (warp, lane) holds rows r and r + 8,
// columns c0 + 8 j and c0 + 8 j + 1 (j < N / 16). Row r's sign word q
// (columns 32 q ..) lies in the 4 lanes of a quad, 8 bits each, for
// j = 4 q' .. 4 q' + 3.
struct Bf16Frag {
  int r, c0, wq0, t;  // rows r, r + 8; first column; first sign word; lane in quad
};
__device__ __forceinline__ Bf16Frag bf16_frag(int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, NW = N / 2;
  return Bf16Frag{16 * (warp & 3) + (lane >> 2), (warp >> 2) * NW + 2 * (lane & 3),
                  (warp >> 2) * NW / 32, lane & 3};
}

// forward: h = bf16(relu(acc + bias)); with MASKS, the layer's sign words
// of the stored values into mk. NJ = D / 16 and MASKS are compile-time, so
// the loop is straight-line code (no branch between its loads).
template <int NJ, bool MASKS>
__device__ __forceinline__ void bf16_fwd_epi(const float (&acc)[128], const float* bias, bf16* h,
                                             uint32_t* mk) {
  constexpr int D = 16 * NJ, words = D / 32;
  const Bf16Frag f = bf16_frag(D);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = f.c0 + 8 * j;
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    const __nv_bfloat162 top =
        __floats2bfloat162_rn(fmaxf(acc[4 * j] + b.x, 0.f), fmaxf(acc[4 * j + 1] + b.y, 0.f));
    const __nv_bfloat162 bot =
        __floats2bfloat162_rn(fmaxf(acc[4 * j + 2] + b.x, 0.f), fmaxf(acc[4 * j + 3] + b.y, 0.f));
    *reinterpret_cast<__nv_bfloat162*>(h + hidx<bf16>(f.r, c, D)) = top;
    *reinterpret_cast<__nv_bfloat162*>(h + hidx<bf16>(f.r + 8, c, D)) = bot;
    if constexpr (MASKS) {
      const int sh = 2 * f.t + 8 * (j & 3);
      lo |= ((uint32_t)(__low2float(top) > 0.f) | (uint32_t)(__high2float(top) > 0.f) << 1) << sh;
      hi |= ((uint32_t)(__low2float(bot) > 0.f) | (uint32_t)(__high2float(bot) > 0.f) << 1) << sh;
      if ((j & 3) == 3) {
        lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
        hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
        lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
        hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
        if (f.t == 0) {
          mk[f.r * words + f.wq0 + j / 4] = lo;
          mk[(f.r + 8) * words + f.wq0 + j / 4] = hi;
        }
        lo = hi = 0;
      }
    }
  }
}

// backward, a hidden layer: g = bf16(acc) where the sign word of mk is set,
// else 0; with SKIP, columns from skip0 on also add bf16(acc) into gx
template <int NJ, bool SKIP>
__device__ __forceinline__ void bf16_bwd_epi(const float (&acc)[128], const uint32_t* mk, bf16* g,
                                             float* gx, int skip0, int in_dim) {
  constexpr int D = 16 * NJ, words = D / 32;
  const Bf16Frag f = bf16_frag(D);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = f.c0 + 8 * j, sh = 2 * f.t + 8 * (j & 3);
    if ((j & 3) == 0) {
      lo = mk[f.r * words + f.wq0 + j / 4];
      hi = mk[(f.r + 8) * words + f.wq0 + j / 4];
    }
    *reinterpret_cast<__nv_bfloat162*>(g + hidx<bf16>(f.r, c, D)) = __floats2bfloat162_rn(
        (lo >> sh) & 1u ? acc[4 * j] : 0.f, (lo >> (sh + 1)) & 1u ? acc[4 * j + 1] : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(g + hidx<bf16>(f.r + 8, c, D)) = __floats2bfloat162_rn(
        (hi >> sh) & 1u ? acc[4 * j + 2] : 0.f, (hi >> (sh + 1)) & 1u ? acc[4 * j + 3] : 0.f);
    if constexpr (SKIP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1), row = f.r + 8 * (e >> 1);
        if (col >= skip0) gx[row * in_dim + col - skip0] += round_st<bf16>(acc[4 * j + e]);
      }
    }
  }
}

// the instances for D (128, 256, 384 or 512)
template <bool MASKS>
__device__ inline void bf16_forward_epilogue(const float (&acc)[128], const float* bias, bf16* h,
                                             uint32_t* mk, int D) {
  switch (D) {
    case 512: bf16_fwd_epi<32, MASKS>(acc, bias, h, mk); break;
    case 384: bf16_fwd_epi<24, MASKS>(acc, bias, h, mk); break;
    case 256: bf16_fwd_epi<16, MASKS>(acc, bias, h, mk); break;
    default: bf16_fwd_epi<8, MASKS>(acc, bias, h, mk);
  }
}
template <bool SKIP>
__device__ inline void bf16_backward_epilogue(const float (&acc)[128], const uint32_t* mk, bf16* g,
                                              float* gx, int skip0, int in_dim, int D) {
  switch (D) {
    case 512: bf16_bwd_epi<32, SKIP>(acc, mk, g, gx, skip0, in_dim); break;
    case 384: bf16_bwd_epi<24, SKIP>(acc, mk, g, gx, skip0, in_dim); break;
    case 256: bf16_bwd_epi<16, SKIP>(acc, mk, g, gx, skip0, in_dim); break;
    default: bf16_bwd_epi<8, SKIP>(acc, mk, g, gx, skip0, in_dim);
  }
}

template <typename WT>
__device__ __forceinline__ void chain_matmul(const WT* A, int K, int N, Ring& ring,
                                             float (&acc)[128]) {
  if constexpr (kIsBf16<WT>)
    wg_matmul(A, K, N, ring, acc);
  else
    fma_matmul64(A, K, K, N, ring, acc);
}

// generic-proxy writes of an operand made visible to wgmma, then a barrier
template <typename WT>
__device__ __forceinline__ void publish() {
  if constexpr (kIsBf16<WT>) fence_proxy_async();
  consumer_sync();
}

// ------------------------------------------------------------ chain

// Shared-memory buffers of one 64-row chunk: h activations [64][D], x input
// [64][k0] (rounded to WT, zero past in_dim), y tanh out [64]; with the
// backward also gx input gradient f32 [64][in_dim], in x's place (only the
// forward reads x), and the ReLU sign words [(n_mid + 1)][64][D / 32].
struct Chain64 {
  void* h;
  void* x;
  float* y;
  float* gx;
  uint32_t* masks;
};

__host__ __device__ inline size_t mask64_layer_words(int D) { return (size_t)kSRows * (D / 32); }

// bytes of x, or of gx where it shares x's place
template <typename WT>
__host__ __device__ inline size_t chain64_x_bytes(int in_dim, bool grad) {
  const size_t x = (size_t)kSRows * stream_k0<WT>(in_dim) * sizeof(WT);
  const size_t gx = grad ? (size_t)kSRows * in_dim * sizeof(float) : 0;
  return align16(x > gx ? x : gx);
}

template <typename WT>
__host__ __device__ inline size_t chain64_bytes(int D, int n_mid, int in_dim, bool grad) {
  size_t b = align16((size_t)kSRows * D * sizeof(WT)) + chain64_x_bytes<WT>(in_dim, grad) +
             align16(kSRows * sizeof(float));
  if (grad) b += align16((n_mid + 1) * mask64_layer_words(D) * sizeof(uint32_t));
  return b;
}

template <typename WT>
__device__ inline Chain64 chain64_carve(unsigned char* base, int D, int n_mid, int in_dim,
                                        bool grad) {
  Chain64 c;
  c.h = base;
  base += align16((size_t)kSRows * D * sizeof(WT));
  c.x = base;
  c.gx = grad ? reinterpret_cast<float*>(base) : nullptr;
  base += chain64_x_bytes<WT>(in_dim, grad);
  c.y = reinterpret_cast<float*>(base);
  base += align16(kSRows * sizeof(float));
  c.masks = grad ? reinterpret_cast<uint32_t*>(base) : nullptr;
  return c;
}

// x[r][i] of a chunk (consumers; zero past in_dim is the caller's v = 0)
template <typename WT>
__device__ __forceinline__ void chain64_store_x(Chain64& c, int in_dim, int r, int i, float v) {
  reinterpret_cast<WT*>(c.x)[hidx<WT>(r, i, stream_k0<WT>(in_dim))] =
      static_cast<WT>(round_st<WT>(v));
}

// Forward of one chunk: reads c.x (published), writes c.y and, with c.masks,
// the sign words of every layer. The consumers of the block call it.
template <typename WT>
__device__ void chain64_forward(const StreamWeights<WT>& w, Chain64& c, Ring& ring) {
  const int D = w.D, in_dim = w.in_dim, k0 = stream_k0<WT>(in_dim);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, words = D / 32;
  WT* h = reinterpret_cast<WT*>(c.h);
  const WT* x = reinterpret_cast<const WT*>(c.x);
  float acc[128];
  for (int l = 0; l <= w.n_mid; ++l) {
    const float* bias = l == 0 ? w.b0 : w.bm + (size_t)(l - 1) * D;
    chain_matmul<WT>(l == 0 ? x : h, l == 0 ? k0 : D, D, ring, acc);
    uint32_t* mk = c.masks == nullptr ? nullptr : c.masks + (size_t)l * mask64_layer_words(D);
    if constexpr (kIsBf16<WT>) {
      if (mk != nullptr) bf16_forward_epilogue<true>(acc, bias, h, mk, D);  // block-uniform
      if (mk == nullptr) bf16_forward_epilogue<false>(acc, bias, h, mk, D);
      publish<WT>();
    } else {
      acc_foreach<WT>(acc, D, [&](int r, int col, float v) {
        h[hidx<WT>(r, col, D)] = static_cast<WT>(fmaxf(v + bias[col], 0.f));
      });
      publish<WT>();
      if (mk != nullptr) {  // block-uniform: sign words read back from h
        for (int e = warp; e < kSRows * words; e += kConsumerWarps) {
          const bool on = to_float(h[hidx<WT>(e / words, (e % words) * 32 + lane, D)]) > 0.f;
          const unsigned bits = __ballot_sync(0xffffffffu, on);
          if (lane == 0) mk[e] = bits;
        }
        consumer_sync();
      }
    }
    if (l + 1 == w.li) {
      // latent_in: layer li reads concat(h, x); the last in_dim outputs of
      // layer li-1 are zero-padded, so the concat is a write into them
      for (int e = threadIdx.x; e < kSRows * in_dim; e += kConsumerThreads) {
        const int r = e / in_dim, i = e % in_dim;
        h[hidx<WT>(r, D - in_dim + i, D)] = x[hidx<WT>(r, i, k0)];
      }
      publish<WT>();
    }
  }
  // head: one warp per row, tanh(h . wl + bl)
  for (int r = warp; r < kSRows; r += kConsumerWarps) {
    float s = 0.f;
    for (int col = lane; col < D; col += 32)
      s = fmaf(to_float(h[hidx<WT>(r, col, D)]), to_float(w.wl[col]), s);
    s = warp_sum(s);
    if (lane == 0) c.y[r] = tanhf(s + w.bl);
  }
  consumer_sync();
}

__device__ __forceinline__ bool mask64_bit(const uint32_t* mk, int words, int r, int col) {
  return (mk[r * words + col / 32] >> (col % 32)) & 1u;
}

// Input gradient d y / d x of the chunk from its sign words and tanh
// outputs (after chain64_forward with masks), into c.gx. Uses c.h for g.
template <typename WT>
__device__ void chain64_input_grad(const StreamWeights<WT>& w, Chain64& c, Ring& ring) {
  const int D = w.D, in_dim = w.in_dim, words = D / 32, skip0 = D - in_dim;
  WT* g = reinterpret_cast<WT*>(c.h);
  float* gx = c.gx;
  const float* y = c.y;
  const WT* wl = opaque(w.wl);
  const bool skip_head = w.n_mid + 1 == w.li;
  // g at the head's input; the skip takes its share unmasked, the chain
  // continues with the mask of the last hidden layer
  for (int e = threadIdx.x; e < kSRows * in_dim; e += kConsumerThreads) {
    const int r = e / in_dim;
    gx[e] = skip_head ? round_st<WT>(round_st<WT>(1.f - y[r] * y[r]) *
                                     to_float(wl[skip0 + e % in_dim]))
                      : 0.f;
  }
  const uint32_t* mk_top = c.masks + (size_t)w.n_mid * mask64_layer_words(D);
  float acc[128];
  if constexpr (kIsBf16<WT>) {
    // the same values through the backward epilogue, from the fragment layout
    const Bf16Frag f = bf16_frag(D);
    const float y0 = round_st<WT>(1.f - y[f.r] * y[f.r]);
    const float y8 = round_st<WT>(1.f - y[f.r + 8] * y[f.r + 8]);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 16 * j < D ? f.c0 + 8 * j : 0;  // past D: a harmless read, never stored
      const float w0 = to_float(wl[c]), w1 = to_float(wl[c + 1]);
      acc[4 * j] = y0 * w0;
      acc[4 * j + 1] = y0 * w1;
      acc[4 * j + 2] = y8 * w0;
      acc[4 * j + 3] = y8 * w1;
    }
    bf16_backward_epilogue<false>(acc, mk_top, g, gx, skip0, in_dim, D);
  } else {
    for (int e = threadIdx.x; e < kSRows * D; e += kConsumerThreads) {
      const int r = e / D, col = e % D;
      const float v = round_st<WT>(1.f - y[r] * y[r]) * to_float(wl[col]);
      g[hidx<WT>(r, col, D)] =
          static_cast<WT>(mask64_bit(mk_top, words, r, col) ? round_st<WT>(v) : 0.f);
    }
  }
  publish<WT>();
  for (int j = w.n_mid - 1; j >= -1; --j) {
    // g (masked, rounded) @ W_{j+1}^T; j = -1 is layer 0 into gx
    const bool last = j < 0;
    const int N = last ? stream_n0<WT>(in_dim) : D;
    chain_matmul<WT>(g, D, N, ring, acc);
    const uint32_t* mk_next = last ? nullptr : c.masks + (size_t)j * mask64_layer_words(D);
    const bool skip_here = !last && j + 1 == w.li;
    if constexpr (kIsBf16<WT>) {
      if (!last && skip_here)
        bf16_backward_epilogue<true>(acc, mk_next, g, gx, skip0, in_dim, D);
      if (!last && !skip_here)
        bf16_backward_epilogue<false>(acc, mk_next, g, gx, skip0, in_dim, D);
    }
    if (!kIsBf16<WT> || last) {
      acc_foreach<WT>(acc, N, [&](int r, int col, float v) {
        if (last) {
          if (col < in_dim) gx[r * in_dim + col] += v;
        } else {
          if (skip_here && col >= skip0) gx[r * in_dim + col - skip0] += round_st<WT>(v);
          g[hidx<WT>(r, col, D)] =
              static_cast<WT>(mask64_bit(mk_next, words, r, col) ? round_st<WT>(v) : 0.f);
        }
      });
    }
    publish<WT>();
  }
}

// Launch configuration of a cluster of kCluster blocks along x (grid.x a
// multiple of it); `attr` must outlive the launch.
inline cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename... KArgs, typename... Args>
inline int launch_cluster(void (*kernel)(KArgs...), dim3 grid, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, smem, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of `kernel` the card holds at once (one wave), or minus a
// cudaError_t.
template <typename... KArgs>
inline int max_active_clusters(void (*kernel)(KArgs...), size_t smem) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(kCluster), smem, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

// max_active_clusters of one kernel on each device, asked again only when
// its shared memory changes (the caller keeps one cache a kernel: a static of
// a launcher templated on the kernel's types). Shards of the fruit mesh
// launch from several host threads onto several devices, so the entries are
// per device ordinal (the calling thread's current device, where the launch
// goes) and read and written under a mutex; a failed query is not kept.
constexpr int kMaxDevices = 64;
struct WaveCache {
  std::mutex mu;
  size_t smem[kMaxDevices] = {};
  int clusters[kMaxDevices] = {};
};
template <typename... KArgs>
inline int wave_clusters(void (*kernel)(KArgs...), size_t smem, WaveCache& cache) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= kMaxDevices) return max_active_clusters(kernel, smem);
  std::lock_guard<std::mutex> hold(cache.mu);
  if (smem != cache.smem[dev]) {
    const int n = max_active_clusters(kernel, smem);
    if (n <= 0) return n;
    cache.clusters[dev] = n;
    cache.smem[dev] = smem;
  }
  return cache.clusters[dev];
}

// ------------------------------------------------------------ forward-only wave

// Dynamic shared memory of a block of a forward-only kernel: the ring of
// kFwdSlots slots and one chunk's h, x and y.
template <typename WT>
__host__ __device__ inline size_t forward_wave_smem(int D, int n_mid, int in_dim) {
  return ring_region_bytes<WT>(D, in_dim, kFwdSlots<WT>) +
         chain64_bytes<WT>(D, n_mid, in_dim, false);
}

// The body of a forward-only kernel (B3, B4), one wave of clusters.
// `rows` gives the launch's n_chunks 64-row chunks: in(chunk, r, i) is
// element i < in_dim of row r of the chunk (0 past the rows' end), out(chunk,
// r, y) stores row r's tanh sdf where the row exists. Pair g of chunks (one a
// block of the cluster) goes to cluster g mod the clusters of the grid, so
// both blocks of a cluster run the same number of pairs and consume the same
// stages; the second chunk of a ragged last pair runs the chain on zeros and
// stores nothing. A cluster without a pair returns whole, before its ring
// exists.
template <typename WT, typename Rows>
__device__ __forceinline__ void forward_wave(const StreamWeights<WT>& w, const Rows& rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = w.D, in_dim = w.in_dim, k0 = stream_k0<WT>(in_dim);
  const int pairs = (rows.n_chunks + kCluster - 1) / kCluster;
  const int cid = blockIdx.x / kCluster, n_cl = gridDim.x / kCluster;
  if (cid >= pairs) return;
  Ring ring = ring_init<WT>(smem, w, (pairs - cid + n_cl - 1) / n_cl, false, kFwdSlots<WT>);
  Chain64 c = chain64_carve<WT>(smem + ring_region_bytes<WT>(D, in_dim, kFwdSlots<WT>), D, w.n_mid,
                                in_dim, false);
  if (threadIdx.x >= kConsumerThreads) {
    producer_role(ring);
    return;
  }
  consumer_start();
  for (int g = cid; g < pairs; g += n_cl) {
    const int chunk = g * kCluster + (int)(blockIdx.x % kCluster);
    for (int e = threadIdx.x; e < kSRows * k0; e += kConsumerThreads) {
      const int r = e / k0, i = e % k0;
      chain64_store_x<WT>(c, in_dim, r, i, i < in_dim ? rows.in(chunk, r, i) : 0.f);
    }
    publish<WT>();
    chain64_forward<WT>(w, c, ring);  // ends with a consumer barrier: y is whole
    for (int r = threadIdx.x; r < kSRows; r += kConsumerThreads) rows.out(chunk, r, c.y[r]);
  }
  cluster_sync();  // no block leaves while another may still signal its barriers
}

// Launch of a forward-only kernel over rows.n_chunks chunks: one wave of
// clusters, or fewer when the chunk pairs do not fill one. Each kernel has
// its own Rows type, so its own instance and wave cache. Returns a
// cudaError_t.
template <typename WT, typename Rows>
inline int launch_forward_wave(void (*kernel)(StreamWeights<WT>, Rows), const StreamWeights<WT>& w,
                               const Rows& rows, cudaStream_t stream) {
  static WaveCache cache;
  const size_t smem = forward_wave_smem<WT>(w.D, w.n_mid, w.in_dim);
  const int wave = wave_clusters(kernel, smem, cache);
  if (wave <= 0) return wave < 0 ? -wave : (int)cudaErrorInvalidConfiguration;
  const int pairs = (rows.n_chunks + kCluster - 1) / kCluster;
  const int clusters = pairs < wave ? pairs : wave;
  return launch_cluster(kernel, dim3((unsigned)(clusters * kCluster)), smem, stream, w, rows);
}

// The limits of every kernel of the chain on the decoder's dimensions
inline bool chain_dims_ok(int D, int n_mid, int in_dim) {
  return D % 128 == 0 && D <= kMaxWidth && in_dim <= D && in_dim <= 128 && n_mid >= 0;
}

}  // namespace horti
