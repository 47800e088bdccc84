// Flash-attention backward for Hopper (sm_90a), float32: the gradients of
// exact non-causal softmax attention from the forward's saved log-sum-exp,
// in two kernels, float32 arithmetic on the CUDA cores.
//
// Replaces the two Pallas kernels of
// video_edge_ai_proxy_tpu/ops/flash_attention.py launched by
// `_flash_bwd_call` (reached through the `_flash` custom VJP's backward
// `_flash_bwd`), `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`, for
// float32 inputs; bf16 inputs go to the tensor-core kernels of
// flash_attention_bwd_dq_sm90.cu and flash_attention_bwd_dkv_sm90.cu. Same
// function, on packed f32 q, k, v, dO [BH, Tp, D] with the forward's lse
// and delta = rowsum(dO * O) ([BH, Tp, 1] f32):
//
//     s   = (q . k^T) * D^-0.5, with s[:, j] = -1e30 for keys j >= true_t
//     p   = exp(s - lse)
//     ds  = p * (dO . v^T - delta)
//     dq  = ds . k * D^-0.5        (flash_bwd_dq_kernel)
//     dv  = p^T . dO               (flash_bwd_dkv_kernel)
//     dk  = ds^T . q * D^-0.5      (flash_bwd_dkv_kernel)
//
// computed and written in float32, as the Pallas bodies compute.
//
// What bounds them on this card: operations. At the videomae_b_long
// shapes (BH = 24 for two clips, Tp = 6272, D = 64) dq does three
// [T, T] x D products (s, dO.v^T, ds.k: 6*BH*T^2*D = 3.6e11 operations)
// and dk/dv four (s, dO.v^T, p^T.dO, ds^T.q: 8*BH*T^2*D = 4.8e11), far
// above the card's balance point. These kernels run the products as f32
// FMAs on the CUDA cores, whose published peak is 67 TFLOP/s; they are the
// route of the float32 gradient checks against the CPU, where exact
// float32 arithmetic is the point. The bf16 training path runs on the
// tensor cores.
//
// Design (the TPU design does not carry over: each Pallas kernel keeps a
// head's whole K/V, or Q/dO, resident in VMEM, ~1.6 MB at T = 6272, more
// than a block's 227 KB of shared memory):
// - flash_bwd_dq_kernel: one block per (query tile of 64 rows, head). The
//   block holds its Q and dO tiles (transposed, float32) and its rows'
//   lse and delta in registers, and streams K and V in tiles of 64 keys
//   through shared memory. It recomputes s and p, forms ds, and
//   accumulates dq += ds . k in registers.
// - flash_bwd_dkv_kernel: one block per (key tile of 64 keys, head). The
//   block holds its K and V tiles and streams Q, dO, lse and delta in
//   tiles of 64 queries, accumulating dv += p^T . dO and dk += ds^T . q in
//   registers. Each block owns its dk/dv rows: no atomics, as in the
//   Pallas grid.
// - Thread (ty, tx) of 16 x 16 owns 4 rows (4ty..4ty+3) of its block's
//   outputs and their columns tx*(D/16)..tx*(D/16)+D/16-1, and the 4 x 4
//   logits of those rows against tile columns 4tx..4tx+3. Operands of the
//   logit products are stored transposed ([D][64 + 4]) so both are read as
//   float4; p and ds go through shared memory once, transposed, for the
//   products over the tile.
// - Masking: keys >= true_t get s = -1e30, so p = exp(-1e30 - lse) = 0 and
//   ds = 0, exactly as in the Pallas kernels. Key tiles (dq) and query
//   tiles (dk/dv) stop at true_t. Query rows >= true_t are padding with
//   dO = 0 and delta = 0, so their terms are exact zeros and dk/dv skips
//   them (p forced to 0); key rows >= true_t of dk/dv are written as zeros.
// - Dynamic shared memory: dq holds five [D][68] / [64][D] / [64][68]
//   float32 tiles (101 KB at D = 64), dk/dv eight (137 KB), above the
//   48 KB of static shared memory; the launch raises the limit with
//   cudaFuncSetAttribute.
// - expf is the accurate library version (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;              // rows of a Q, dO, K or V tile
constexpr int kThreads = 256;          // 16 x 16
constexpr int kLd = kTile + 4;         // row stride of the transposed tiles
constexpr float kNeg = -1e30f;         // _NEG of the Pallas kernels

// Rows [r0, r0 + kTile) of a [*, D] head slice, as float32, into the
// transposed tile tr[D][kLd] and, when rm is given, the row-major tile
// rm[kTile][D]; rows >= limit read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int r0,
                                          int limit, float* tr, float* rm) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int row = r0 + r;
    const float x =
        row < limit ? src[static_cast<size_t>(row) * D + c] : 0.0f;
    tr[c * kLd + r] = x;
    if (rm != nullptr) rm[r * D + c] = x;
  }
}

// acc[i][j] += a[d][4ty + i] * b[d][4tx + j] over d: the 4 x 4 logits (or
// dO . v^T terms) of a thread's rows against its tile columns.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * kLd + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + d * kLd + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
  }
}

// s[i][j] into the transposed tile t[kTile][kLd] at t[4tx + j][4ty + i].
__device__ __forceinline__ void store_transposed(float* t, int ty, int tx,
                                                 const float s[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(t + (tx * 4 + j) * kLd + ty * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int tp, int true_t, float scale) {
  constexpr int kCols = D / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd]  Q^T
  float* dot = qt + D * kLd;                      // [D][kLd]  dO^T
  float* kt = dot + D * kLd;                      // [D][kLd]  K tile ^T
  float* vt = kt + D * kLd;                       // [D][kLd]  V tile ^T
  float* ks = vt + D * kLd;                       // [kTile][D] K tile
  float* dst = ks + kTile * D;                    // [kTile][kLd] dS^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(blockIdx.y) * tp;

  load_tile<D>(q + head * D, q0, tp, qt, nullptr);
  load_tile<D>(dout + head * D, q0, tp, dot, nullptr);
  float row_lse[4], row_delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_lse[i] = row < tp ? lse[head + row] : 0.0f;
    row_delta[i] = row < tp ? delta[head + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_tiles = (true_t + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();   // Q and dO are stored; the last tile's readers are done
    load_tile<D>(k + head * D, k0, true_t, kt, ks);
    load_tile<D>(v + head * D, k0, true_t, vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
    tile_dot<D>(qt, kt, ty, tx, s);
    tile_dot<D>(dot, vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (k0 + tx * 4 + j >= true_t) x = kNeg;
        s[i][j] = expf(x - row_lse[i]) * (dp[i][j] - row_delta[i]);   // ds
      }
    }
    store_transposed(dst, ty, tx, s);
    __syncthreads();

    // acc[rows 4ty+i][cols tx*kCols + c] += dS . K over the tile's keys.
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(dst + kk * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bv[c] = ks[kk * D + tx * kCols + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
  }

  float* dqh = dq + head * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < tp) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dqh[static_cast<size_t>(row) * D + tx * kCols + c] = acc[i][c] * scale;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tp, int true_t, float scale) {
  constexpr int kCols = D / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][kLd]  K^T (this block's keys)
  float* vt = kt + D * kLd;                       // [D][kLd]  V^T
  float* qt = vt + D * kLd;                       // [D][kLd]  Q tile ^T
  float* dot = qt + D * kLd;                      // [D][kLd]  dO tile ^T
  float* qs = dot + D * kLd;                      // [kTile][D] Q tile
  float* dos = qs + kTile * D;                    // [kTile][D] dO tile
  float* pt = dos + kTile * D;                    // [kTile][kLd] P^T, by query
  float* dst = pt + kTile * kLd;                  // [kTile][kLd] dS^T, by query
  float* lse_s = dst + kTile * kLd;               // [kTile]
  float* delta_s = lse_s + kTile;                 // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(blockIdx.y) * tp;
  float* dkh = dk + head * D;
  float* dvh = dv + head * D;

  float gk[4][kCols], gv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) gk[i][c] = gv[i][c] = 0.0f;
  }

  // A tile of padded keys only: its gradients are zeros (the whole block
  // takes this branch together, so no barrier is skipped by part of it).
  const int n_tiles = k0 < true_t ? (true_t + kTile - 1) / kTile : 0;
  if (n_tiles > 0) {
    load_tile<D>(k + head * D, k0, true_t, kt, nullptr);
    load_tile<D>(v + head * D, k0, true_t, vt, nullptr);
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();   // K and V are stored; the last tile's readers are done
    load_tile<D>(q + head * D, q0, true_t, qt, qs);
    load_tile<D>(dout + head * D, q0, true_t, dot, dos);
    for (int r = tid; r < kTile; r += kThreads) {
      const int row = q0 + r;
      lse_s[r] = row < true_t ? lse[head + row] : 0.0f;
      delta_s[r] = row < true_t ? delta[head + row] : 0.0f;
    }
    __syncthreads();

    // Logits of keys 4ty+i against queries q0 + 4tx + j, and dO . v^T.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
    tile_dot<D>(kt, qt, ty, tx, s);
    tile_dot<D>(vt, dot, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool real_key = k0 + ty * 4 + i < true_t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        const float x = real_key ? s[i][j] * scale : kNeg;
        const float p = q0 + r < true_t ? expf(x - lse_s[r]) : 0.0f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - delta_s[r]);   // ds
      }
    }
    store_transposed(pt, ty, tx, s);
    store_transposed(dst, ty, tx, dp);
    __syncthreads();

    // gv[keys 4ty+i][cols tx*kCols + c] += P^T . dO and gk += dS^T . Q
    // over the tile's queries.
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      const float4 a = *reinterpret_cast<const float4*>(pt + qq * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(dst + qq * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      float ov[kCols], qv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ov[c] = dos[qq * D + tx * kCols + c];
        qv[c] = qs[qq * D + tx * kCols + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          gv[i][c] = fmaf(av[i], ov[c], gv[i][c]);
          gk[i][c] = fmaf(bv[i], qv[c], gk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row < tp) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const size_t off = static_cast<size_t>(row) * D + tx * kCols + c;
        dkh[off] = gk[i][c] * scale;
        dvh[off] = gv[i][c];
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int tp,
              int true_t, float scale, cudaStream_t stream) {
  const size_t smem = (4 * D * kLd + kTile * D + kTile * kLd) * sizeof(float);
  cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tp + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), tp, true_t, scale);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int tp, int true_t, float scale, cudaStream_t stream) {
  const size_t smem =
      (4 * D * kLd + 2 * kTile * D + 2 * kTile * kLd + 2 * kTile) *
      sizeof(float);
  cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tp + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), tp, true_t, scale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int tp, int true_t, int is_bf16) {
  return is_bf16 || bh < 1 || bh > 65535 || tp < 1 || true_t < 1 || true_t > tp;
}

}  // namespace

// C entry points, bound with ctypes. q, k, v, dout, dq, dk, dv: device
// pointers to contiguous [bh, tp, d] f32 arrays; lse, delta: device
// pointers to [bh, tp] f32. d in {16, 32, 64}; 1 <= true_t <= tp; is_bf16
// must be 0 (bf16 inputs take flash_attention_bwd_dq_sm90_launch and
// flash_attention_bwd_dkv_sm90_launch). Each launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const float* lse,
                                             const float* delta, void* dq,
                                             int bh, int tp, int d, int true_t,
                                             int is_bf16, float scale,
                                             void* stream) {
  if (bad_shape(bh, tp, true_t, is_bf16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, bh, tp, true_t, scale, s);
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, tp, true_t, scale, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, tp, true_t, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                              const void* v, const void* dout,
                                              const float* lse,
                                              const float* delta, void* dk,
                                              void* dv, int bh, int tp, int d,
                                              int true_t, int is_bf16,
                                              float scale, void* stream) {
  if (bad_shape(bh, tp, true_t, is_bf16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, tp, true_t, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, tp, true_t, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tp, true_t, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
