// Flash-attention dq backward on Hopper's tensor cores (sm_90a, bf16):
// wgmma products, bf16 tiles in swizzled shared memory, and a two-stage
// cp.async ring for the streamed K/V tiles.
//
// Replaces `_flash_bwd_dq_kernel` of
// video_edge_ai_proxy_tpu/ops/flash_attention.py:114 (the first
// `pallas_call` of `_flash_bwd_call`) for bf16 inputs; float32 inputs keep
// going to `flash_bwd_dq_kernel` of flash_attention_bwd.cu. Same function,
// on packed bf16 q, k, v, dO [BH, Tp, D] with the forward's lse and
// delta = rowsum(dO * O) (f32 [BH, Tp, 1]):
//
//     s  = (q . k^T) * D^-0.5, masked to keys < true_t
//     p  = exp(s - lse),  ds = p * (dO . v^T - delta)
//     dq = ds . k * D^-0.5
//
// written in bf16.
//
// What bounds it on this card: operations. dq does three [T, T] x D
// products, 6*BH*T^2*D = 3.625e11 operations at videomae_b_long's two clips
// (BH = 24, T = 6272, D = 64), on 97 MB of inputs and outputs: at the bf16
// tensor-core rate (989 TFLOP/s, an H100 SXM's published dense peak)
// 0.3666 ms. The count is the function's work; this kernel runs four
// products' worth on the tensor cores (dS . K twice, see "Numerics"), so it
// can reach at most 3/4 = 75% of that bound.
//
// Design, against what held the float32 CUDA-core kernel back:
// 1. Products on the tensor cores. One block per (64-query tile, head), one
//    warpgroup of 128 threads: (ceil(Tp / 64), BH) = 98 x 24 blocks at the
//    path's shapes. The block's 64 queries are the M dimension of every
//    product: S = Q . K^T and dP = dO . V^T (M = 64 queries, N = 64 keys,
//    K = D) are SS wgmma m64n64k16, both operands K-major in shared memory;
//    dQ += dS . K (M = 64 queries, N = D, K = 64 keys) is RS wgmma m64nDk16
//    into D/2 f32 accumulators per thread.
// 2. bf16 tiles, held once. Tiles are stored row-major with rows of D bf16
//    in the swizzled layout wgmma reads (128-byte swizzle at D = 64, 64 at
//    32, 32 at 16), filled by 16-byte cp.async copies. The K tile
//    [64 keys x D] is the K-major B operand of S and the MN-major
//    (transposed) B operand of dS . K: no second copy and no transpose.
// 3. Overlap. Q and dO are copied once; K and V stream through a ring of
//    two stages (one K and one V tile each, 16 KB at D = 64): the copies of
//    key tile i + 1 are in flight while tile i is computed. S's products are
//    waited for while dP's still run, and p is formed under them. 49 KB of
//    shared memory at D = 64.
// 4. dS stays in registers: the f32 accumulator fragments of S and dP are,
//    after the elementwise step, the bf16 A fragments of dS . K (the
//    register-A form of wgmma). Accumulator rows are query rows, so each
//    thread reads the lse and delta of its own two rows once, into
//    registers; no row reduction and no shared-memory round trip.
//
// Numerics. The Pallas body and the plain version compute ds . k with f32
// ds; one bf16 rounding of ds misses the check's 1e-5 + 2^-7 |dq| at these
// shapes (by 3.4e-4 to 8.7e-4 in the CPU emulation). So ds is split,
// ds = hi + lo with hi = bf16(ds) and lo = bf16(ds - hi), and dS . K runs as
// two wgmma chains into the same accumulators. Each product of two bf16
// values is exact in f32; what remains is an error of order 2^-17 |ds| and
// f32 summation order. S and dP are bf16 x bf16 into f32, the products the
// plain version forms from the bf16 inputs. expf is the accurate library
// version (no --use_fast_math).
//
// Masking: query rows are copied up to Tp (rows in [true_t, Tp) are real
// rows of the function, computed from whatever q and dO hold there; rows
// past Tp of the last tile are zero-filled and not stored). Key and value
// rows >= true_t are zero-filled by the copies (nothing past the real keys
// is read), the key loop stops at true_t, and the key columns >= true_t of
// the last partial tile get p = 0 (so ds = 0), as -1e30 logits give in the
// Pallas kernel.
//
// The helpers below (swizzle, cp.async, wgmma descriptors and wrappers,
// split_fragments) are copies of those in flash_attention_bwd_dkv_sm90.cu:
// each source builds into its own library, keyed by the hash of that one
// file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // queries per block, keys per streamed tile
constexpr int kThreads = 128;   // one warpgroup

// Shared-memory geometry of one head dim. Every tile starts on a 1024-byte
// boundary, the period of the widest swizzle.
template <int D>
struct Geo {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kChunks = D / 8;                // 16-byte chunks per row
  static constexpr int kTileBytes = kTile * kRowBytes; // 2, 4 or 8 KB
  // A ring stage: a K tile, then a V tile.
  static constexpr int kStageBytes = 2 * kTileBytes;
  // Q, dO, two stages, and slack to align the base.
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

// The A fragments of the 4 k-steps (16 keys each) of a [64 queries x 64
// keys] f32 accumulator, split as x = hi + lo in bf16. Accumulator element
// 4j + 2h + e sits at row g + 8h, column 8j + 2t + e (g = lane / 4,
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
flash_bwd_dq_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int tp, int true_t, float scale) {
  using G = Geo<D>;
  constexpr int kAcc = D / 2;            // accumulator registers of the [64 x D] dQ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + G::kTileBytes;
  const uint32_t ring = base + 2 * G::kTileBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(blockIdx.y) * tp;
  const bf16* kh = k + head * D;
  const bf16* vh = v + head * D;
  // This thread's accumulator rows (queries) and first column pair.
  const int row = q0 + 16 * warp + (lane >> 2);    // and row + 8
  const int col = 2 * (lane & 3);
  // The lse and delta of rows h = 0, 1 (rows past Tp are never stored).
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row + 8 * h < tp;
    row_lse[h] = in ? lse[head + row + 8 * h] : 0.0f;
    row_delta[h] = in ? delta[head + row + 8 * h] : 0.0f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  const int n_tiles = (true_t + kTile - 1) / kTile;
  load_tile<D>(q_s, q + head * D, q0, tp);
  load_tile<D>(do_s, dout + head * D, q0, tp);
  load_tile<D>(ring, kh, 0, true_t);
  load_tile<D>(ring + G::kTileBytes, vh, 0, true_t);
  cp_async_commit();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    // Every thread is done with tile - 1, whose stage takes tile + 1.
    __syncthreads();
    if (tile + 1 < n_tiles) {
      const uint32_t next = ring + ((tile + 1) & 1) * G::kStageBytes;
      load_tile<D>(next, kh, k0 + kTile, true_t);
      load_tile<D>(next + G::kTileBytes, vh, k0 + kTile, true_t);
    }
    cp_async_commit();
    cp_async_wait<1>();      // this thread's copies of tile (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();         // everyone's copies landed

    const uint32_t k_s = ring + (tile & 1) * G::kStageBytes;
    const uint32_t v_s = k_s + G::kTileBytes;

    // S = Q . K^T and dP = dO . V^T, [64 queries x 64 keys] each.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk == 0) {
        wgmma_ss_n64<0>(s, desc_k_major<D>(q_s, kk), desc_k_major<D>(k_s, kk));
      } else {
        wgmma_ss_n64<1>(s, desc_k_major<D>(q_s, kk), desc_k_major<D>(k_s, kk));
      }
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk == 0) {
        wgmma_ss_n64<0>(dp, desc_k_major<D>(do_s, kk), desc_k_major<D>(v_s, kk));
      } else {
        wgmma_ss_n64<1>(dp, desc_k_major<D>(do_s, kk), desc_k_major<D>(v_s, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // p = exp(s * scale - lse), zero on the key columns >= true_t, while dP
    // is still being computed. Element 4j + 2h + e is row h, key
    // k0 + 8j + col + e.
    const int real_cols = true_t - k0;   // keys of this tile below true_t
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real_key = 8 * j + col + e < real_cols;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          x = real_key ? expf(x * scale - row_lse[h]) : 0.0f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // ds = p * (dP - delta); dQ += dS . K (as hi and lo chains).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        dp[i] = s[i] * (dp[i] - row_delta[h]);
        dp[i + 1] = s[i + 1] * (dp[i + 1] - row_delta[h]);
      }
    }
    uint32_t d_hi[4][4], d_lo[4][4];
    split_fragments(dp, d_hi, d_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(acc, d_hi[kk], desc_mn_major<D>(k_s, kk));
      wgmma_rs<D>(acc, d_lo[kk], desc_mn_major<D>(k_s, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // Accumulator element 4j + 2h + e: row + 8h, column 8j + col + e.
  bf16* dqh = dq + head * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= tp) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dqh + static_cast<size_t>(r) * D + 8 * j + col) =
          pack_bf16(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int bh, int tp, int true_t, float scale,
           cudaStream_t stream) {
  constexpr int smem = Geo<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tp + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel_wgmma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), tp, true_t, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes; the signature of
// flash_attention_bwd_dq_launch (flash_attention_bwd.cu). q, k, v, dout, dq:
// device pointers to contiguous [bh, tp, d] bf16 arrays, 16-byte aligned;
// lse, delta: device pointers to [bh, tp] f32. d in {16, 32, 64};
// 1 <= true_t <= tp; is_bf16 must be 1 (float32 inputs take
// flash_attention_bwd_dq_launch). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dq_sm90_launch(const void* q, const void* k,
                                                  const void* v, const void* dout,
                                                  const float* lse, const float* delta,
                                                  void* dq, int bh, int tp, int d, int true_t,
                                                  int is_bf16, float scale, void* stream) {
  if (!is_bf16 || bh < 1 || bh > 65535 || tp < 1 || true_t < 1 || true_t > tp) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, dout, lse, delta, dq, bh, tp, true_t, scale, s);
    case 32: return launch<32>(q, k, v, dout, lse, delta, dq, bh, tp, true_t, scale, s);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dq, bh, tp, true_t, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
