// Flash-attention dk/dv backward on Hopper's tensor cores (sm_90a, bf16):
// wgmma products, bf16 tiles in swizzled shared memory, and a two-stage
// cp.async ring for the streamed query tiles.
//
// Replaces `_flash_bwd_dkv_kernel` of
// video_edge_ai_proxy_tpu/ops/flash_attention.py:148 (the second
// `pallas_call` of `_flash_bwd_call`) for bf16 inputs; float32 inputs keep
// going to `flash_bwd_dkv_kernel` of flash_attention_bwd.cu. Same function,
// on packed bf16 q, k, v, dO [BH, Tp, D] with the forward's lse and
// delta = rowsum(dO * O) (f32 [BH, Tp, 1]):
//
//     s  = (q . k^T) * D^-0.5, masked to keys < true_t
//     p  = exp(s - lse),  ds = p * (dO . v^T - delta)
//     dv = p^T . dO,      dk = ds^T . q * D^-0.5
//
// written in bf16, key rows >= true_t as exact zeros.
//
// What bounds it on this card: operations. dk/dv does four [T, T] x D
// products, 8*BH*T^2*D = 4.8e11 operations at videomae_b_long's two clips
// (BH = 24, T = 6272, D = 64), on under 120 MB of inputs and outputs: at
// the bf16 tensor-core rate (989 TFLOP/s, an H100 SXM's published dense
// peak) 0.489 ms. The count is the function's work; this kernel runs six
// products' worth on the tensor cores (see "Numerics"), so it can reach at
// most 67% of that bound.
//
// Design, against what held the float32 CUDA-core kernel back:
// 1. Products on the tensor cores. One block per (64-key tile, head), one
//    warpgroup of 128 threads. The block's 64 keys are the M dimension of
//    every product: S^T = K . Q^T and dP^T = V . dO^T (M = 64 keys, N = 64
//    queries, K = D) and dV += P^T . dO, dK += dS^T . Q (M = 64 keys,
//    N = D, K = 64 queries), each as m64nNk16 wgmma with f32 accumulators
//    in registers (4 x 32 per thread at D = 64).
// 2. bf16 tiles, held once. K and V are loaded once per block; Q, dO, lse
//    and delta stream through the ring. Tiles are stored row-major with
//    rows of D bf16 in the swizzled layout wgmma reads (128-byte swizzle at
//    D = 64, 64 at 32, 32 at 16: 16-byte chunk c of row r at chunk
//    c ^ (address bits 7..9)), filled by 16-byte cp.async copies, whole
//    rows per thread group, no per-element index arithmetic. The same Q
//    and dO tile is the K-major B operand of the first pair and the
//    MN-major B operand (transposed B) of the second pair: no second copy.
// 3. Overlap. The copy of query tile i + 1 is in flight while tile i is
//    computed; S^T's products are waited for while dP^T's still run, and p
//    is formed under them.
// 4. P and dS stay in registers: the f32 accumulator fragments of S^T and
//    dP^T (keys x queries) are, after conversion, the bf16 A fragments of
//    the second pair (the register-A form of wgmma), no shared-memory
//    round trip.
//
// Numerics. The Pallas body and the plain version compute p . dO and
// ds . q with f32 p and ds; one bf16 rounding of p would add an error of
// order 2^-9 |p| per term, about the size of the check's 1e-5 bar after
// 6272 queries. So p and ds are split, x = hi + lo with hi = bf16(x) and
// lo = bf16(x - hi), and the second pair runs as two wgmma chains each into
// the same accumulators. Each product of two bf16 values is exact in f32;
// what remains is an error of order 2^-17 |x| and f32 summation order. The
// first pair is bf16 x bf16 into f32, the same products as before. expf is
// the accurate library version (no --use_fast_math).
//
// Masking: a block whose keys all lie at or past true_t writes zeros. Key
// rows >= true_t and query columns >= true_t get p = 0 (so ds = 0); rows
// >= true_t of every tile are zero-filled by the copies, so no padding
// value reaches a product. The query loop stops at true_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // keys per block, queries per streamed tile
constexpr int kThreads = 128;   // one warpgroup

// Shared-memory geometry of one head dim. Every tile starts on a 1024-byte
// boundary, the period of the widest swizzle.
template <int D>
struct Geo {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kChunks = D / 8;                // 16-byte chunks per row
  static constexpr int kTileBytes = kTile * kRowBytes; // 2, 4 or 8 KB
  // A ring stage: Q and dO tiles, then lse[64] and delta[64], padded.
  static constexpr int kRowsOffset = 2 * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  // K, V, two stages, and slack to align the base.
  static constexpr int kSmemBytes = 2 * kTileBytes + 2 * kStageBytes + 1024;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle.
  static constexpr uint64_t kLayout = D == 64 ? 1 : (D == 32 ? 2 : 3);
  // Stride between 8-row groups, in 16-byte units: 8 rows of D bf16.
  static constexpr uint32_t kGroupStride = (8 * kRowBytes) >> 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of a row-major tile of D bf16 per row -> its swizzled offset:
// the 16-byte chunk index (bits 4..) XOR the 128-byte line index (bits 7..),
// over as many bits as the row has chunks.
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (Geo<D>::kChunks - 1)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory (the copies)
// before later async-proxy reads (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a [*, D] bf16 head slice into the swizzled tile at
// shared address dst; rows >= limit are zero-filled (nothing is read).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int limit) {
  constexpr int kC = Geo<D>::kChunks;
#pragma unroll
  for (int i = 0; i < kTile * kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kC;
    const int c = e % kC;
    const int row = r0 + r;
    const bool in = row < limit;
    const bf16* g = src + (in ? static_cast<size_t>(row) * D + c * 8 : 0);
    cp_async16(dst + swizzle<D>(r * Geo<D>::kRowBytes + c * 16), g, in ? 16u : 0u);
  }
}

// Query tile q0: Q and dO rows, lse and delta, into a ring stage.
template <int D>
__device__ __forceinline__ void load_stage(uint32_t stage, const bf16* q, const bf16* dout,
                                           const float* lse, const float* delta, int q0,
                                           int true_t) {
  load_tile<D>(stage, q, q0, true_t);
  load_tile<D>(stage + Geo<D>::kTileBytes, dout, q0, true_t);
  const int r = threadIdx.x & (kTile - 1);
  const bool in = q0 + r < true_t;
  const float* src = (threadIdx.x < kTile ? lse : delta) + (in ? q0 + r : 0);
  cp_async4(stage + Geo<D>::kRowsOffset + threadIdx.x * 4, src, in ? 4u : 0u);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (layout << 62);
}

// A 64-row tile with rows of D bf16 read K-major (K = D along the row):
// 8-row groups D*16 bytes apart; step k of 16 elements starts 32 bytes in.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int k) {
  return make_desc(tile + 32 * k, 1, Geo<D>::kGroupStride, Geo<D>::kLayout);
}

// The same tile read MN-major as a [K = 64 rows] x [N = D] B operand: N is
// one swizzle atom wide, 8-row K groups D*16 bytes apart (the stride byte
// offset); step k of 16 rows starts 16 rows in.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int k) {
  return make_desc(tile + 16 * Geo<D>::kRowBytes * k, 1, Geo<D>::kGroupStride,
                   Geo<D>::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the start of an asynchronous wgmma and the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC8(d, i)                                                                     \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (ScaleD ? += : =) A[64 x 16] . B[16 x 64], A and B K-major in
// shared memory.
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(a), "l"(b), "r"(ScaleD));
}

// d[64 x N] += A[64 x 16] . B[16 x N], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragments of the 4 k-steps (16 queries each) of a [64 keys x 64
// queries] f32 accumulator, split as x = hi + lo in bf16. Accumulator
// element 4j + 2h + e sits at row g + 8h, column 8j + 2t + e (g = lane / 4,
// t = lane % 4); the A fragment of k-step kk takes columns 16kk..16kk + 15
// in the same thread, as registers {8kk, 8kk+1}, {+2, +3}, {+4, +5},
// {+6, +7}.
__device__ __forceinline__ void split_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r];
      const float b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int tp,
                           int true_t, float scale) {
  using G = Geo<D>;
  constexpr int kAcc = D / 2;            // accumulator registers of a [64 x D] product
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base;
  const uint32_t v_s = base + G::kTileBytes;
  const uint32_t ring = base + 2 * G::kTileBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(blockIdx.y) * tp;
  const bf16* qh = q + head * D;
  const bf16* doh = dout + head * D;
  const float* lseh = lse + head;
  const float* deltah = delta + head;
  // This thread's accumulator rows (keys) and first column pair.
  const int key = k0 + 16 * warp + (lane >> 2);    // and key + 8
  const int col = 2 * (lane & 3);
  const bool real_key[2] = {key < true_t, key + 8 < true_t};

  float acc_dk[kAcc], acc_dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  // A tile of padded keys only writes zeros (the whole block takes this
  // branch together, so no barrier is skipped by part of it).
  const int n_tiles = k0 < true_t ? (true_t + kTile - 1) / kTile : 0;
  if (n_tiles > 0) {
    load_tile<D>(k_s, k + head * D, k0, true_t);
    load_tile<D>(v_s, v + head * D, k0, true_t);
    load_stage<D>(ring, qh, doh, lseh, deltah, 0, true_t);
  }
  cp_async_commit();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    // Every thread is done with tile - 1, whose stage takes tile + 1.
    __syncthreads();
    if (tile + 1 < n_tiles) {
      load_stage<D>(ring + ((tile + 1) & 1) * G::kStageBytes, qh, doh, lseh, deltah,
                    q0 + kTile, true_t);
    }
    cp_async_commit();
    cp_async_wait<1>();      // this thread's copies of tile (and K, V) landed
    fence_proxy_async();
    __syncthreads();         // everyone's copies landed

    const uint32_t st = ring + (tile & 1) * G::kStageBytes;
    const uint32_t q_s = st;
    const uint32_t do_s = st + G::kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(gbase + (st - base) + G::kRowsOffset);
    const float* delta_s = lse_s + kTile;

    // S^T = K . Q^T and dP^T = V . dO^T, [64 keys x 64 queries] each.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk == 0) {
        wgmma_ss_n64<0>(s, desc_k_major<D>(k_s, kk), desc_k_major<D>(q_s, kk));
      } else {
        wgmma_ss_n64<1>(s, desc_k_major<D>(k_s, kk), desc_k_major<D>(q_s, kk));
      }
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk == 0) {
        wgmma_ss_n64<0>(dp, desc_k_major<D>(v_s, kk), desc_k_major<D>(do_s, kk));
      } else {
        wgmma_ss_n64<1>(dp, desc_k_major<D>(v_s, kk), desc_k_major<D>(do_s, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // p = exp(s * scale - lse), zero on padded keys and queries, while dP^T
    // is still being computed.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + col;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
      const bool rq0 = q0 + c < true_t;
      const bool rq1 = q0 + c + 1 < true_t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& s0 = s[4 * j + 2 * h];
        float& s1 = s[4 * j + 2 * h + 1];
        s0 = real_key[h] && rq0 ? expf(s0 * scale - l.x) : 0.0f;
        s1 = real_key[h] && rq1 ? expf(s1 * scale - l.y) : 0.0f;
      }
    }
    uint32_t a_hi[4][4], a_lo[4][4];
    split_fragments(s, a_hi, a_lo);
    wgmma_wait<0>();
    fence_regs(dp);

    // dV += P^T . dO (as hi and lo chains), started before dS is formed.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(acc_dv, a_hi[kk], desc_mn_major<D>(do_s, kk));
      wgmma_rs<D>(acc_dv, a_lo[kk], desc_mn_major<D>(do_s, kk));
    }
    wgmma_commit();

    // ds = p * (dP - delta); dK += dS^T . Q.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dp[4 * j + 2 * h] = s[4 * j + 2 * h] * (dp[4 * j + 2 * h] - dl.x);
        dp[4 * j + 2 * h + 1] = s[4 * j + 2 * h + 1] * (dp[4 * j + 2 * h + 1] - dl.y);
      }
    }
    uint32_t d_hi[4][4], d_lo[4][4];
    split_fragments(dp, d_hi, d_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(acc_dk, d_hi[kk], desc_mn_major<D>(q_s, kk));
      wgmma_rs<D>(acc_dk, d_lo[kk], desc_mn_major<D>(q_s, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
  }

  // Accumulator element 4j + 2h + e: key + 8h, column 8j + col + e.
  bf16* dkh = dk + head * D;
  bf16* dvh = dv + head * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key + 8 * h;
    if (row >= tp) continue;
    const bool keep = real_key[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t off = static_cast<size_t>(row) * D + 8 * j + col;
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dkh + off) =
          pack_bf16(keep ? acc_dk[i] * scale : 0.0f, keep ? acc_dk[i + 1] * scale : 0.0f);
      *reinterpret_cast<uint32_t*>(dvh + off) =
          pack_bf16(keep ? acc_dv[i] : 0.0f, keep ? acc_dv[i + 1] : 0.0f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int bh, int tp, int true_t, float scale,
           cudaStream_t stream) {
  constexpr int smem = Geo<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tp + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel_wgmma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), tp, true_t, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, dout, dk, dv: device pointers
// to contiguous [bh, tp, d] bf16 arrays, 16-byte aligned; lse, delta: device
// pointers to [bh, tp] f32. d in {16, 32, 64}; 1 <= true_t <= tp; is_bf16
// must be 1 (float32 inputs take flash_attention_bwd_dkv_launch of
// flash_attention_bwd.cu). Launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dkv_sm90_launch(const void* q, const void* k,
                                                   const void* v, const void* dout,
                                                   const float* lse, const float* delta,
                                                   void* dk, void* dv, int bh, int tp, int d,
                                                   int true_t, int is_bf16, float scale,
                                                   void* stream) {
  if (!is_bf16 || bh < 1 || bh > 65535 || tp < 1 || true_t < 1 || true_t > tp) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, dout, lse, delta, dk, dv, bh, tp, true_t, scale, s);
    case 32: return launch<32>(q, k, v, dout, lse, delta, dk, dv, bh, tp, true_t, scale, s);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dk, dv, bh, tp, true_t, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
