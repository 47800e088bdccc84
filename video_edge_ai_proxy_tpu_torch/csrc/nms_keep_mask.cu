// Greedy NMS keep mask for Hopper (sm_90a), one thread block per image.
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
// pairs j > i, about 14 f32 operations each) and then a K-step scan whose every step depends on
// the previous one. At K = 256 and B = 16 both the byte and the operation
// bound are well under a microsecond, so the kernel's time is latency: the
// dependent scan and the launch itself.
//
// Design:
// - The Pallas kernel keeps the whole K x K f32 IoU matrix in VMEM. On
//   Hopper that would be 256 KiB at K = 256, more than a block's 227 KiB of
//   shared memory, so phase 1 stores only what the scan needs: one bit per
//   pair, "iou(i, j) > t and j > i", K * ceil(K/64) words of 64 bits (8 KiB
//   at K = 256). The (row, word) pairs are spread over the block's threads.
// - Phase 2 runs the dependent scan in one warp. Lane w holds word w of the
//   "removed" bit set (K <= 1024 means at most 16 words); at step i the lane
//   that owns bit i broadcasts its word, and when box i is not removed every
//   lane ORs row i's word into its own. That is exactly `keep[i] &` of the
//   JAX loop.
// - Bit-for-bit agreement with the XLA and Pallas twins: the IoU is built
//   with the same formula in the same order of operations, with explicitly
//   rounded intrinsics (no FMA contraction; the file is also compiled with
//   --fmad=false) and NaN-propagating min/max as in jnp.minimum/maximum.
//   Never build this file with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

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

__global__ void __launch_bounds__(kThreads)
nms_keep_mask_kernel(const float* __restrict__ boxes,
                     uint8_t* __restrict__ keep, int k, int words,
                     float iou_thresh) {
  // Shared layout: box [k] float4 | mask [k * words] u64 | removed [words]
  // u64 | area [k] f32. Offsets keep each array naturally aligned.
  extern __shared__ float4 smem[];
  float4* box = smem;
  unsigned long long* mask = reinterpret_cast<unsigned long long*>(box + k);
  unsigned long long* removed_s = mask + static_cast<size_t>(k) * words;
  float* area = reinterpret_cast<float*>(removed_s + words);

  const float* src = boxes + static_cast<size_t>(blockIdx.x) * k * 4;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float4 b = make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                           src[4 * i + 3]);
    box[i] = b;
    area[i] = box_area(b);
  }
  __syncthreads();

  // Phase 1: suppression bits, one (row i, 64-column word w) per step.
  for (int idx = threadIdx.x; idx < k * words; idx += blockDim.x) {
    const int i = idx / words;
    const int w = idx - i * words;
    const int j0 = w * 64;
    const int j_end = min(j0 + 64, k);
    const float4 bi = box[i];
    const float ai = area[i];
    unsigned long long bits = 0ull;
    for (int j = max(j0, i + 1); j < j_end; ++j) {
      const float4 bj = box[j];
      const float iw = max_nan(
          __fsub_rn(min_nan(bi.z, bj.z), max_nan(bi.x, bj.x)), 0.0f);
      const float ih = max_nan(
          __fsub_rn(min_nan(bi.w, bj.w), max_nan(bi.y, bj.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni =
          max_nan(__fsub_rn(__fadd_rn(ai, area[j]), inter), 1e-9f);
      const float iou = __fdiv_rn(inter, uni);
      if (iou > iou_thresh) bits |= 1ull << (j - j0);
    }
    mask[idx] = bits;
  }
  __syncthreads();

  // Phase 2: the dependent greedy scan in warp 0.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long removed = 0ull;
    for (int i = 0; i < k; ++i) {
      const unsigned long long wi =
          __shfl_sync(0xffffffffu, removed, i >> 6);
      if (!((wi >> (i & 63)) & 1ull) && lane < words) {
        removed |= mask[static_cast<size_t>(i) * words + lane];
      }
    }
    if (lane < words) removed_s[lane] = removed;
  }
  __syncthreads();

  uint8_t* dst = keep + static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    dst[j] = ((removed_s[j >> 6] >> (j & 63)) & 1ull) ? 0 : 1;
  }
}

}  // namespace

// C entry point, bound with ctypes. boxes: device pointer to a contiguous
// [batch, k, 4] f32 array; keep: device pointer to [batch, k] bytes (0/1).
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success).
extern "C" int nms_keep_mask_launch(const float* boxes, uint8_t* keep,
                                    int batch, int k, float iou_thresh,
                                    void* stream) {
  if (batch < 0 || k < 0 || k > kMaxK) return cudaErrorInvalidValue;
  if (batch == 0 || k == 0) return cudaSuccess;
  const int words = (k + 63) / 64;
  const size_t smem = static_cast<size_t>(k) * sizeof(float4) +
                      static_cast<size_t>(k) * words * 8 +
                      static_cast<size_t>(words) * 8 +
                      static_cast<size_t>(k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_keep_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_keep_mask_kernel<<<batch, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      boxes, keep, k, words, iou_thresh);
  return cudaGetLastError();
}
