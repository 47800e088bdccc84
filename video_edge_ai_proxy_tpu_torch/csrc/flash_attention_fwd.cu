// Flash-attention forward for Hopper (sm_90a): exact non-causal softmax
// attention with an online softmax, float32 arithmetic on the CUDA cores.
//
// Replaces the Pallas kernel `_flash_kernel` of
// video_edge_ai_proxy_tpu/ops/flash_attention.py (launched by `_flash_call`,
// reached through `_flash`, `flash_attention` and, for T >= 1024,
// models/transformer.py `auto_attention`). Same function, on packed
// q, k, v [BH, Tp, D] (bf16 or f32):
//
//     s    = (q . k^T) * D^-0.5, with s[:, j] = -1e30 for keys j >= true_t
//     m    = rowmax(s),  l = rowsum(exp(s - m))
//     o    = (exp(s - m) . v) / max(l, 1e-30)        (in the input dtype)
//     lse  = m + log(max(l, 1e-30))                   ([BH, Tp, 1] f32)
//
// computed in float32 whatever the input type, as the Pallas body does.
//
// What bounds it on this card: operations. At the videomae_b_long shapes
// (BH = 24 for two clips, Tp = 6272, D = 64) the kernel does 4*BH*T^2*D =
// 2.4e11 floating-point operations and BH*T^2 = 9.4e8 exponentials on
// 77 MB of q, k, v and o. That is far above the card's balance point, so
// memory traffic is not the limit. The bound is the bf16 tensor-core rate
// (0.245 ms at two clips); this kernel runs the products as f32 FMAs on
// the CUDA cores, whose peak is 67 TFLOP/s, so it cannot come near it.
// wgmma and TMA are the way there, in later work.
//
// Design (the TPU design does not carry over: the Pallas kernel keeps the
// whole K and V of a head resident in VMEM, ~1.6 MB at T = 6272, more than
// a block's 227 KB of shared memory):
// - One block per (query tile of 64 rows, head): 98 x 24 = 2352 blocks at
//   the path's shapes, enough to fill 132 SMs several times over.
// - The block streams K/V in tiles of 64 keys through shared memory; the
//   [64, 64] logit tile lives in registers (4 x 4 per thread) and the
//   probabilities pass through shared memory once, transposed, for P.V.
//   No [T, T] array ever reaches device memory.
// - Thread (ty, tx) of 16 x 16 owns query rows 4*ty..4*ty+3, with logit
//   columns 4*tx..4*tx+3 and output columns tx*(D/16)..tx*(D/16)+D/16-1.
//   Row max and row sum reduce over the 16 lanes of a half-warp with
//   shuffles; each thread keeps the running max m, denominator l and its
//   accumulator slice in registers.
// - Q and K tiles are stored transposed ([D][64 + 4]) so both operands of
//   the logit product are read as float4; the padding keeps rows 16-byte
//   aligned and spreads the transposing stores over more banks.
// - Key tiles stop at true_t: keys past it would enter with exp(-1e30 - m)
//   = 0, so skipping them is exact; the last partial tile is masked to -1e30
//   as in the Pallas kernel. Padded query rows are computed like real ones
//   (zero queries), so o and lse match the Pallas outputs everywhere.
// - expf/logf are the accurate library versions (no --use_fast_math): the
//   kernel is held to 1e-5 against its plain float32 version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;            // query rows per block
constexpr int kBlockK = 64;            // keys per tile
constexpr int kThreads = 256;          // 16 x 16
constexpr int kLd = 64 + 4;            // row stride of the transposed tiles
constexpr float kNeg = -1e30f;         // _NEG of the Pallas kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tp, int true_t, float scale) {
  constexpr int kCols = D / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd]  Q^T
  float* kt = qt + D * kLd;                       // [D][kLd]  K tile ^T
  float* vs = kt + D * kLd;                       // [kBlockK][D] V tile
  float* pt = vs + kBlockK * D;                   // [kBlockK][kLd] P^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * tp;
  const T* qh = q + head * D;
  const T* kh = k + head * D;
  const T* vh = v + head * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int row = q0 + r;
    qt[c * kLd + r] =
        row < tp ? to_f32(qh[static_cast<size_t>(row) * D + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_tiles = (true_t + kBlockK - 1) / kBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();   // Q is stored; the last tile's readers are done
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int key = k0 + r;
      const size_t off = static_cast<size_t>(key) * D + c;
      const bool real = key < true_t;
      kt[c * kLd + r] = real ? to_f32(kh[off]) : 0.0f;
      vs[r * D + c] = real ? to_f32(vh[off]) : 0.0f;
    }
    __syncthreads();

    // Logits of rows 4ty+i against keys k0 + 4tx + j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
    }

    // Online softmax over this tile, one row at a time.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (k0 + tx * 4 + j >= true_t) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc[rows 4ty+i][cols tx*kCols + c] += P . V over the tile's keys.
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pt + kk * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bv[c] = vs[kk * D + tx * kCols + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
  }

  T* oh = o + head * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < tp) {
      const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        store(oh + static_cast<size_t>(row) * D + tx * kCols + c,
              acc[i][c] / l_safe);
      }
      if (tx == 0) lse[head + row] = m[i] + logf(l_safe);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int tp, int true_t, float scale, cudaStream_t stream) {
  const size_t smem =
      (2 * D * kLd + kBlockK * D + kBlockK * kLd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((tp + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tp, true_t, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int tp, int d, int true_t, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, tp, true_t, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, tp, true_t, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, tp, true_t, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, o: device pointers to
// contiguous [bh, tp, d] arrays of bf16 (is_bf16 = 1) or f32 (is_bf16 = 0);
// lse: device pointer to [bh, tp] f32. d in {16, 32, 64}; 1 <= true_t <= tp.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int bh, int tp, int d, int true_t,
                                          int is_bf16, float scale,
                                          void* stream) {
  if (bh < 1 || bh > 65535 || tp < 1 || true_t < 1 || true_t > tp) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tp, d, true_t, scale, s);
  }
  return launch_d<float>(q, k, v, o, lse, bh, tp, d, true_t, scale, s);
}
