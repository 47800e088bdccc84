// Greedy NMS keep mask for Hopper (sm_90a), one thread-block cluster per image.
//
// Replaces the Pallas kernel `_nms_kernel` of
// video_edge_ai_proxy_tpu/ops/nms.py (launched by `_nms_pallas_call`,
// reached through `nms_keep_mask_pallas` and `batched_nms`). Same function:
// boxes [B, K, 4] f32 xyxy, sorted by score and class-offset by the caller,
// go to keep [B, K] bool with
//
//     keep = 1^K
//     for i in 0..K-1:  keep &= ~(keep[i] & iou[i, :] > t & j > i)
//
// which is exact greedy NMS.
//
// What bounds it on this card: nothing the memory system sees. An image
// reads 16*K bytes and writes K; the work is K(K-1)/2 IoU evaluations (the
// pairs j > i, about 14 f32 operations each) and then a K-step scan whose
// every step depends on the previous one. At K = 256 and B = 16 both the
// byte and the operation bound are well under a microsecond, so the
// kernel's time is latency: the launch, the spread of the pairs over the
// card and the dependent scan.
//
// Design:
// - Suppression bits, not IoUs. The Pallas kernel keeps the K x K f32 IoU
//   matrix in VMEM; here each image keeps one bit per pair, "iou(i, j) > t
//   and j > i", as ceil(K/64) words of 64 bits per row (8 KiB at K = 256,
//   128 KiB at K = 1024), stored word-major so that a diagonal block's
//   words are contiguous. Words wholly left of the diagonal (w < i / 64)
//   hold no pair j > i; they are never computed, written or read.
// - A cluster of kCluster CTAs per image (grid B * kCluster, launched with
//   cudaLaunchKernelEx and a cluster dimension; a refused launch is an
//   error, never a launch without clusters). CTA r owns a contiguous slice
//   of rows. The host cuts the slices so that every CTA has the same
//   number of (row, word) items: rows near the top have more words right
//   of the diagonal, and equal row counts gave rank 0 four times rank 7's
//   work at K = 256. One warp takes one (row i, word w): lane l evaluates
//   the pairs (i, 64w + l) and (i, 64w + 32 + l), and two __ballot_sync
//   calls form the word, so every lane does the same work and none loops
//   over a range of its own.
// - The division is skipped only where skipping is exact: with inter == 0
//   the quotient is +-0 (or NaN when the union is NaN), never > t for
//   t >= 0. A warp whose lanes all have inter == 0 (__any_sync) forms a
//   zero word without dividing; most pairs of the main path are boxes of
//   different classes, 8192 px apart. A NaN inter is not 0 and still
//   divides; for t < 0 (or a NaN t) the skip is off.
// - Each word goes straight into rank 0's shared memory through
//   distributed shared memory (map_shared_rank), once a cluster barrier
//   wait has seen every CTA arrive (the arrive is at the kernel's start,
//   so the wait costs nothing). A cluster.sync() then releases the writes
//   to rank 0, which alone scans, reading local shared memory only.
// - The scan, in warp 0 of rank 0, goes by diagonal blocks of 64 rows. For
//   block b lane 0 reads the block's 64 diagonal words mask[64b + r][b]
//   (they do not depend on the scan, so their loads may issue ahead of
//   the steps that use them) and walks its rows with `if (!(rem >> r & 1)) rem |= diag[r]`, done as
//   `rem |= diag[r] & ~sign_extend(rem, r + 1)` on 32-bit halves: two
//   dependent register instructions per step instead of a shuffle and a
//   shared-memory load. The block's kept rows are then known, and the
//   words w > b of the "removed" set (lane w holds word w) take the OR of
//   the kept rows' words, one warp reduction per word, with no block-wide
//   barrier. The greedy order is unchanged, bit for bit.
// - Bit-for-bit agreement with the XLA and Pallas twins: the IoU is built
//   with the same formula in the same order of operations, with explicitly
//   rounded intrinsics (no FMA contraction; the file is also compiled with
//   --fmad=false) and NaN-propagating min/max as in jnp.minimum/maximum.
//   Never build this file with --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;   // a power of two
constexpr int kCluster = 8;       // the portable maximum cluster size
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;

// jnp.maximum / jnp.minimum propagate NaN; fmaxf / fminf do not.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f),
                   max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float pair_inter(float4 bi, float4 bj) {
  const float iw = max_nan(
      __fsub_rn(min_nan(bi.z, bj.z), max_nan(bi.x, bj.x)), 0.0f);
  const float ih = max_nan(
      __fsub_rn(min_nan(bi.w, bj.w), max_nan(bi.y, bj.y)), 0.0f);
  return __fmul_rn(iw, ih);
}

__device__ __forceinline__ bool pair_iou_above(float ai, float aj,
                                               float inter, float t) {
  const float uni = max_nan(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-9f);
  return __fdiv_rn(inter, uni) > t;
}

size_t smem_bytes(int k) {
  const int words = (k + 63) / 64;
  return static_cast<size_t>(k) * sizeof(float4) +
         static_cast<size_t>(64 * words) * words * 8 +
         static_cast<size_t>(k) * sizeof(float);
}

// The contiguous row slice of each CTA: CTA r owns [row[r], row[r + 1]).
struct RowCuts {
  int row[kCluster + 1];
};

// (row, word) items of the rows before row i: row i has the words from its
// diagonal word i / 64 to the last, words - i / 64 of them.
int items_before(int i, int words) {
  const int b = i >> 6;
  return 64 * (b * words - b * (b - 1) / 2) + (i & 63) * (words - b);
}

// Cut the rows so that every CTA gets the same number of items, within two
// rows' worth: CTA r starts at the first row whose items_before reaches
// total * r / kCluster. Rows near the top have more words right of the
// diagonal, so equal row counts would give rank 0 several times rank 7's
// work.
RowCuts row_cuts(int k, int words) {
  RowCuts cuts;
  const int total = items_before(k, words);
  for (int r = 0; r <= kCluster; ++r) {
    const int target = total * r / kCluster;
    int lo = 0;
    int hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (items_before(mid, words) >= target) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    cuts.row[r] = lo;
  }
  return cuts;
}

// The low `bits` bits of x (1 to 32), sign-extended: every bit from
// bits - 1 up copies bit bits - 1. One SGXT instruction; .clamp keeps
// bits = 32 whole (.wrap would take it as 0).
__device__ __forceinline__ unsigned sign_extend(unsigned x, unsigned bits) {
  unsigned d;
  asm("szext.clamp.s32 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(bits));
  return d;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
nms_keep_mask_kernel(const float* __restrict__ boxes,
                     uint8_t* __restrict__ keep, int k, int words,
                     float iou_thresh, const __grid_constant__ RowCuts cuts) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int image = blockIdx.x / kCluster;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Tell the cluster this CTA runs; the matching wait, before the first
  // write to rank 0's shared memory, then finds every CTA arrived.
  cluster_arrive_relaxed();

  // Shared layout, the same in every CTA: box [k] float4 | mask [words]
  // [kp] u64, word-major over kp = 64 * words rows (rows at their image
  // positions, so a diagonal block's words are contiguous) | area [k] f32.
  extern __shared__ float4 smem[];
  const int kp = 64 * words;
  float4* box = smem;
  unsigned long long* mask = reinterpret_cast<unsigned long long*>(box + k);
  float* area = reinterpret_cast<float*>(mask + static_cast<size_t>(kp) * words);

  const float* src = boxes + static_cast<size_t>(image) * k * 4;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float4 b = make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                                 src[4 * i + 3]);
    box[i] = b;
    area[i] = box_area(b);
  }
  __syncthreads();
  cluster_wait();

  // Phase 1: this CTA's slice of rows. A warp per (row, word) item. Word w
  // has items in the rows [row0, min(row1, 64w + 64)) of the slice; the
  // items are dealt to the warps in turn, word after word, so that every
  // warp gets the same number within one. Every branch below is uniform
  // over the warp.
  const int row0 = cuts.row[rank];
  const int row1 = cuts.row[rank + 1];
  const int w0 = row0 >> 6;
  const bool may_skip = iou_thresh >= 0.0f;
  unsigned long long* mask0 = cluster.map_shared_rank(mask, 0);
  int dealt = 0;
  for (int w = w0; w < words && row0 < row1; ++w) {
    const int n = min(row1, 64 * w + 64) - row0;
    for (int r = (warp - dealt) & (kWarps - 1); r < n; r += kWarps) {
      const int i = row0 + r;
      const float4 bi = box[i];
      const float ai = area[i];
      const int ja = 64 * w + lane;
      const int jb = ja + 32;
      const bool va = ja > i && ja < k;
      const bool vb = jb > i && jb < k;
      const int ca = min(ja, k - 1);
      const int cb = min(jb, k - 1);
      const float inter_a = pair_inter(bi, box[ca]);
      const float inter_b = pair_inter(bi, box[cb]);
      bool pa = false;
      bool pb = false;
      if (!may_skip || __any_sync(kFull, (va && inter_a != 0.0f) ||
                                             (vb && inter_b != 0.0f))) {
        pa = va && pair_iou_above(ai, area[ca], inter_a, iou_thresh);
        pb = vb && pair_iou_above(ai, area[cb], inter_b, iou_thresh);
      }
      const unsigned lo = __ballot_sync(kFull, pa);
      const unsigned hi = __ballot_sync(kFull, pb);
      if (lane == 0) {
        mask0[static_cast<size_t>(w) * kp + i] =
            (static_cast<unsigned long long>(hi) << 32) | lo;
      }
    }
    dealt += n;
  }

  // Every CTA's words are in rank 0 once the cluster is through this
  // barrier (its arrive releases the writes, its wait acquires them).
  cluster.sync();
  if (rank != 0 || warp != 0) return;

  // Phase 2, warp 0 of rank 0: the greedy scan by diagonal blocks of 64
  // rows. Lane w holds word w of the "removed" set (words <= 16).
  unsigned long long removed = 0ull;
  for (int b = 0; b < words; ++b) {
    const int base = 64 * b;
    const int n = min(64, k - base);
    const unsigned long long valid = n == 64 ? ~0ull : (1ull << n) - 1ull;
    const unsigned long long before = __shfl_sync(kFull, removed, b);
    unsigned long long rem = 0ull;
    if (lane == 0) {
      // The block's diagonal words, free of the chain; rows past k were
      // never written and read as 0.
      const ulonglong2* dp = reinterpret_cast<const ulonglong2*>(
          mask + static_cast<size_t>(b) * kp + base);
      unsigned long long diag[64];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const ulonglong2 v = dp[r];
        diag[2 * r] = 2 * r < n ? v.x : 0ull;
        diag[2 * r + 1] = 2 * r + 1 < n ? v.y : 0ull;
      }
      // Row r's diagonal word has bits only above r, so ANDing it with the
      // complement of sign_extend(rem, r + 1), whose bits above r all copy
      // bit r, keeps it exactly when row r is not removed: a step is two
      // dependent instructions, SGXT and LOP3, with no predicate. The
      // chain runs on 32-bit halves; for r >= 32 the low half of the word
      // is 0, and for r < 32 the high half follows bit 31 of the mask.
      unsigned lo = static_cast<unsigned>(before);
      unsigned hi = static_cast<unsigned>(before >> 32);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const unsigned m = sign_extend(lo, r + 1);
        hi |= static_cast<unsigned>(diag[r] >> 32) &
              ~static_cast<unsigned>(static_cast<int>(m) >> 31);
        lo |= static_cast<unsigned>(diag[r]) & ~m;
      }
#pragma unroll
      for (int r = 32; r < 64; ++r) {
        hi |= static_cast<unsigned>(diag[r] >> 32) & ~sign_extend(hi, r - 31);
      }
      rem = (static_cast<unsigned long long>(hi) << 32) | lo;
    }
    rem = __shfl_sync(kFull, rem, 0);
    if (lane == b) removed = rem;
    // The block's kept rows remove their words right of the diagonal: lane
    // l ORs rows 2l and 2l + 1, and the warp reduces.
    const unsigned long long kept = ~rem & valid;
#pragma unroll 4
    for (int w = b + 1; w < words; ++w) {
      const ulonglong2 v = reinterpret_cast<const ulonglong2*>(
          mask + static_cast<size_t>(w) * kp + base)[lane];
      const unsigned long long acc =
          (((kept >> (2 * lane)) & 1ull) ? v.x : 0ull) |
          (((kept >> (2 * lane + 1)) & 1ull) ? v.y : 0ull);
      const unsigned a_lo = __reduce_or_sync(kFull, static_cast<unsigned>(acc));
      const unsigned a_hi =
          __reduce_or_sync(kFull, static_cast<unsigned>(acc >> 32));
      if (lane == w) {
        removed |= (static_cast<unsigned long long>(a_hi) << 32) | a_lo;
      }
    }
  }

  // Lane l writes bytes [8l, 8l + 8) of each 256: one 8-byte store when
  // the row is 8-byte aligned, else byte by byte.
  uint8_t* dst = keep + static_cast<size_t>(image) * k;
  const bool whole = (k & 7) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
  for (int j0 = 0; j0 < k; j0 += 256) {
    const int j = j0 + 8 * lane;
    const unsigned long long word = __shfl_sync(kFull, removed, min(j, k - 1) >> 6);
    if (whole) {
      if (j < k) {
        // Byte q of the 8 gets bit q of the kept bits, as 0 or 1: copy the
        // 8 bits into every byte, keep bit q in byte q, and carry any set
        // bit into bit 7 of its byte (no byte overflows into the next).
        const unsigned long long kb = ~(word >> (j & 63)) & 0xffull;
        const unsigned long long spread =
            (kb * 0x0101010101010101ull) & 0x8040201008040201ull;
        *reinterpret_cast<unsigned long long*>(dst + j) =
            ((spread + 0x7f7f7f7f7f7f7f7full) >> 7) & 0x0101010101010101ull;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (j + q < k) dst[j + q] = ((word >> ((j + q) & 63)) & 1ull) ? 0 : 1;
      }
    }
  }
}

// Return `err`, clearing the runtime's last error so that a later launch
// check elsewhere does not report this failure again.
int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// C entry point, bound with ctypes. boxes: device pointer to a contiguous
// [batch, k, 4] f32 array; keep: device pointer to [batch, k] bytes (0/1).
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success). A refused cluster launch is returned as it
// is: there is no launch without clusters.
extern "C" int nms_keep_mask_launch(const float* boxes, uint8_t* keep,
                                    int batch, int k, float iou_thresh,
                                    void* stream) {
  if (batch < 0 || k < 0 || k > kMaxK) return cudaErrorInvalidValue;
  // The grid has batch * kCluster CTAs, at most 2^31 - 1: a larger batch
  // is refused here, before the product can wrap.
  if (batch > 0x7fffffff / kCluster) return cudaErrorInvalidValue;
  if (batch == 0 || k == 0) return cudaSuccess;
  const int words = (k + 63) / 64;
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return fail(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, nms_keep_mask_kernel, boxes, keep, k, words,
                         iou_thresh, row_cuts(k, words));
  if (err != cudaSuccess) return fail(err);
  return cudaGetLastError();
}

// The cluster size (CTAs per image) the launch uses.
extern "C" int nms_keep_mask_cluster_size(void) { return kCluster; }

// Dynamic shared memory of each CTA at `k` candidates, in bytes.
extern "C" size_t nms_keep_mask_smem_bytes(int k) { return smem_bytes(k); }

