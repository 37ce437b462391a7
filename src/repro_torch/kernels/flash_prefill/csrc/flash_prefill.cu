// Flash prefill attention (FlashAttention-2 forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_prefill_pallas / _flash_kernel in
// src/repro/kernels/flash_prefill/kernel.py: q [B, S, H, hd], k/v
// [B, S, KV, hd] (GQA: query head h reads kv head h / (H / KV)), causal or
// not, an optional sliding window (query i sees key j only when i - j <
// window), scale 1/sqrt(hd) of the true head_dim passed in by the caller,
// (m, l, acc) in f32, the output in q's dtype.
//
// What bounds it on the card: the larger of its FLOPs and its bytes.  QK^T
// and PV cost 4 * hd FLOPs per (query, key) pair a query head sees -- S^2/2
// pairs per head when causal -- at 989 TFLOP/s of bf16 tensor cores; q, k,
// v and o cross HBM once each at 3.35 TB/s.  The FLOPs grow with S^2 and the
// bytes with S, so at the main path's lengths (S of a few hundred, GQA 2:1)
// the two are within 2x of each other, the bytes ahead (qwen3-0.6b at
// S = 512: ~1.9 us of bytes, ~1.1 us of FLOPs); past S ~ 900 the FLOPs lead.
//
// What the design does about it, for now: it keeps the [S, S] scores out of
// device memory, as FlashAttention does, and never reads a key tile that no
// query of the tile can see, but it multiplies on the CUDA cores in f32, not
// on the tensor cores, so it runs far from either bound.  One block
// of 128 threads per (64-row query tile, query head, row); the key/value
// axis, which the TPU grid walks as its sequential fourth dimension, is a
// loop inside the block over 64-row tiles.  The query tile and each K/V tile
// are staged in shared memory with 16-byte loads (so hd * sizeof(T) must be
// a multiple of 16; the wrapper checks), in rows padded by one 32-bit word
// so that the eight columns a warp reads at once fall in eight banks.
// Thread (r, c) of the 16 x 8 grid owns query rows r + 16 i (i < 4), key
// columns c + 8 j (j < 8) of the score tile and head dims c + 8 jj of the
// output; the row max and sum are shuffles over the 8 lanes of a row.  The
// probabilities go through shared memory ([64][65] f32) into P.V.  No
// head_dim padding (hd = 32, 48, 64, 112 and 128 are taken as they are, up
// to 256) and no S % 64 requirement: rows and columns past S are masked.
// Query tiles are scheduled last-first, so the causal tiles with the most key
// tiles start first.  Later work: mma.sync or wgmma products with TMA
// loads, and double-buffered K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows per block and key rows per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kPsLd = kTile + 1;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Elements per shared-memory row: hd plus one 32-bit word of padding.
template <typename T>
__host__ __device__ __forceinline__ int row_ld(int hd) {
  return hd + static_cast<int>(4 / sizeof(T));
}

// Stage rows [t0, t0 + kTile) of one head into dst [kTile][ld] with 16-byte
// global loads; rows at or past S are zero.  src points at token 0 of the
// head; consecutive tokens are tok_stride elements apart.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t tok_stride, int t0, int S,
                                          int hd, int ld) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = hd / E;
  for (int idx = threadIdx.x; idx < kTile * per_row; idx += kThreads) {
    const int t = idx / per_row;
    const int c = idx - t * per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + t < S) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(t0 + t) * tok_stride +
                                            c * E);
    }
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + t * ld + c * E);
    w[0] = val.x;
    w[1] = val.y;
    w[2] = val.z;
    w[3] = val.w;
  }
}

// DPT: output head dims per thread (hd <= 8 * DPT).
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int H, int KV, int hd, int causal, int window,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_ld<T>(hd);
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kTile][ld]
  T* ks = qs + kTile * ld;                 // [kTile][ld]
  T* vs = ks + kTile * ld;                 // [kTile][ld]
  float* ps = reinterpret_cast<float*>(vs + kTile * ld);  // [kTile][kPsLd]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r = threadIdx.x >> 3;  // row group: rows r + 16 i
  const int c = threadIdx.x & 7;   // column lane: key columns c + 8 j, dims c + 8 jj
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(KV) * hd;
  const T* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * hd;
  const T* kb = k + static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(kvh) * hd;
  const T* vb = v + static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(kvh) * hd;

  load_tile(qs, qb, q_stride, q0, S, hd, ld);

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
  }

  const int k_last = causal ? min(S - 1, q0 + kTile - 1) : S - 1;
  for (int k0 = 0; k0 <= k_last; k0 += kTile) {
    // no query of the tile sees any key of this tile through the window
    if (window > 0 && q0 - (k0 + kTile - 1) >= window) continue;
    __syncthreads();  // the previous tile's ks / vs / ps reads are done
    load_tile(ks, kb, kv_stride, k0, S, hd, ld);
    load_tile(vs, vb, kv_stride, k0, S, hd, ld);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(qs[(r + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_f32(ks[(c + 8 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r + 16 * i;
      unsigned live = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + c + 8 * j;
        const bool ok = col < S && (!causal || col <= row) &&
                        (window <= 0 || row - col < window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        live |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ((live >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        ps[(r + 16 * i) * kPsLd + c + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + group8_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    const int n_cols = min(kTile, S - k0);
    for (int t = 0; t < n_cols; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(r + 16 * i) * kPsLd + t];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) {
        const int d = c + 8 * jj;
        if (d < hd) {
          const float vv = to_f32(vs[t * ld + d]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * S + row) * q_stride + static_cast<size_t>(h) * hd;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int d = c + 8 * jj;
      if (d < hd) store(acc[i][jj] * inv, &o[d]);
    }
  }
}

template <typename T>
size_t smem_size(int hd) {
  return 3 * static_cast<size_t>(kTile) * row_ld<T>(hd) * sizeof(T) +
         static_cast<size_t>(kTile) * kPsLd * sizeof(float);
}

template <typename T, int DPT>
cudaError_t launch_dpt(const T* q, const T* k, const T* v, T* out, int B, int S,
                       int H, int KV, int hd, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = smem_size<T>(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<T, DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_prefill_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, KV, hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int KV, int hd, int causal, int window,
                   float scale, cudaStream_t stream) {
  if ((hd * sizeof(T)) % 16 != 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (hd <= 32) return launch_dpt<T, 4>(qp, kp, vp, op, B, S, H, KV, hd, causal, window, scale, stream);
  if (hd <= 64) return launch_dpt<T, 8>(qp, kp, vp, op, B, S, H, KV, hd, causal, window, scale, stream);
  if (hd <= 128) return launch_dpt<T, 16>(qp, kp, vp, op, B, S, H, KV, hd, causal, window, scale, stream);
  if (hd <= 256) return launch_dpt<T, 32>(qp, kp, vp, op, B, S, H, KV, hd, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory one block takes, in bytes (dtype: 0 = float32,
// 1 = bfloat16); the wrapper checks it against the card's opt-in limit.
extern "C" int flash_prefill_smem_bytes(int hd, int dtype) {
  return static_cast<int>(dtype == 0 ? smem_size<float>(hd) : smem_size<__nv_bfloat16>(hd));
}

// dtype: 0 = float32, 1 = bfloat16.  q [B, S, H, hd], k/v [B, S, KV, hd] and
// out [B, S, H, hd], contiguous and 16-byte aligned.  window <= 0 = none.
// Returns the cudaError_t of the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out,
                             int B, int S, int H, int KV, int hd, int causal,
                             int window, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                          scale, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal,
                                                  window, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
