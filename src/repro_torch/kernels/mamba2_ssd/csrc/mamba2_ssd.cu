// Chunked Mamba2 SSD recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mamba2_ssd_pallas / _ssd_kernel in
// src/repro/kernels/mamba2_ssd/kernel.py.  Per (row b, head h), state size N,
// head channels P, scalar decay a_t = exp(dt_t * A_h), one B/C group shared
// by all heads:
//
//   S_t[n, p] = a_t * S_{t-1}[n, p] + dt_t * B_t[n] * x_t[p]
//   y_t[p]    = sum_n C_t[n] * S_t[n, p] + D_h * x_t[p]
//
// taken 64 tokens at a time in the chunked form of mamba2_ssd_chunked_ref:
// the inclusive cumsum cum of dt * A over the chunk, the masked [C, C]
// scores CB[t, s] * exp(clip(cum_t - cum_s, +-60)) for s <= t, then
// y = (C * exp(cum)) S + scores (x * dt) + D * x, and the update
// S <- exp(cum[C-1]) S + sum_s B_s exp(clip(cum[C-1] - cum_s)) (x * dt)_s.
// Unlike the TPU wrapper, x * dt, dt * A and the D * x skip are formed here;
// y is rounded to x's dtype once, after the skip is added in f32.  The state
// and every sum stay f32; bf16 x/B/C are widened on load.
//
// What bounds it on this card: latency, as for the RWKV6 scan.  Per token
// and head it moves P inputs and P outputs (plus N of B and C per token for
// all heads) and does ~5 * N * P FLOPs of recurrence (N = P = 64 at full
// width): ~18 us of f32 FLOPs and ~6 us of bytes for a 512-token prefill of
// 112 heads, far below what a serial walk of the chunks costs.
//
// What the design does about it: the TPU grid (B, H, chunks) carried the
// state across grid steps in VMEM; here the chunk loop is inside the block
// and the state tile never leaves shared memory.  The P columns of S are
// independent, so a block owns (b, h, 16-column tile of p): 448 blocks at
// full width (B = 1, H = 112, P = 64).  Each block stages B and C (all N) and
// x, dt for its tile, recomputes the chunk's [C, C] scores (the piece the
// tiles share), then forms y and updates its S tile.  Staging 64 tokens of B,
// C and the scores in f32 takes ~62 KiB at N = 64, over the 48 KiB static
// limit, so the launch opts in to dynamic shared memory.  Not yet done:
// overlapping the next chunk's loads, tensor-core products for CB and the
// state terms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;     // tokens per chunk (the TPU kernel's chunk)
constexpr int kTileP = 16;     // head channels per block
constexpr int kThreads = 256;
constexpr float kClip = 60.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }

size_t smem_bytes(int N) {
  const size_t ldn = N + 1;
  return sizeof(float) * (2 * kChunk * ldn            // B, C
                          + kChunk * (kChunk + 1)     // scores
                          + 2 * kChunk * kTileP       // x * dt, x
                          + static_cast<size_t>(N) * kTileP  // S tile
                          + 3 * kChunk);              // dt, cum, update weights
}

// Grid (ceil(P / kTileP), H, B), kThreads threads, smem_bytes(N) dynamic
// shared memory.  x/y: [B, T, H, P]; dt: [B, T, H]; A, D: [H];
// Bm/Cm: [B, T, N]; s0/sT: [B, H, N, P].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  const float* __restrict__ s0, T* __restrict__ y,
                  float* __restrict__ sT, int T_len, int H, int P, int N) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* B_s = smem;                            // [kChunk][ldn]
  float* C_s = B_s + kChunk * ldn;              // [kChunk][ldn]
  float* sc_s = C_s + kChunk * ldn;             // [kChunk][kChunk + 1]
  float* xdt_s = sc_s + kChunk * (kChunk + 1);  // [kChunk][kTileP]
  float* x_s = xdt_s + kChunk * kTileP;         // [kChunk][kTileP]
  float* S_s = x_s + kChunk * kTileP;           // [N][kTileP]
  float* dt_s = S_s + N * kTileP;               // [kChunk]
  float* cum_s = dt_s + kChunk;                 // [kChunk]
  float* wd_s = cum_s + kChunk;                 // [kChunk] exp(clip(total - cum_s))

  const int p0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tp = min(kTileP, P - p0);  // live channels of this tile
  const float a_h = A[h];
  const float d_h = D[h];

  const size_t s_base = (static_cast<size_t>(b) * H + h) * N * P;
  for (int e = tid; e < N * kTileP; e += kThreads) {
    const int n = e / kTileP, c = e % kTileP;
    S_s[e] = c < tp ? s0[s_base + static_cast<size_t>(n) * P + p0 + c] : 0.f;
  }

  const size_t x_row = static_cast<size_t>(H) * P;  // stride of one token in x / y
  const size_t x_base = static_cast<size_t>(b) * T_len * x_row + static_cast<size_t>(h) * P + p0;
  const size_t bc_base = static_cast<size_t>(b) * T_len * N;
  const size_t dt_base = static_cast<size_t>(b) * T_len * H + h;
  float total = 0.f;
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    // -- stage the chunk; tokens past T are dt = 0, x = B = C = 0 ---------
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool live = t0 + t < T_len;
      const size_t g = bc_base + static_cast<size_t>(t0 + t) * N + n;
      B_s[t * ldn + n] = live ? to_f32(Bm[g]) : 0.f;
      C_s[t * ldn + n] = live ? to_f32(Cm[g]) : 0.f;
    }
    for (int t = tid; t < kChunk; t += kThreads) {
      dt_s[t] = t0 + t < T_len ? dt[dt_base + static_cast<size_t>(t0 + t) * H] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kChunk * kTileP; e += kThreads) {
      const int t = e / kTileP, c = e % kTileP;
      const float xv = (t0 + t < T_len && c < tp) ? to_f32(x[x_base + (t0 + t) * x_row + c]) : 0.f;
      x_s[e] = xv;
      xdt_s[e] = xv * dt_s[t];
    }
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        acc += dt_s[t] * a_h;
        cum_s[t] = acc;
      }
    }
    __syncthreads();
    total = cum_s[kChunk - 1];
    // -- scores[t][s] = (C_t . B_s) exp(clip(cum_t - cum_s)) for s <= t ----
    for (int e = tid; e < kChunk * kChunk; e += kThreads) {
      const int t = e / kChunk, s = e % kChunk;
      float acc = 0.f;
      if (s <= t) {
        for (int n = 0; n < N; ++n) acc += C_s[t * ldn + n] * B_s[s * ldn + n];
        acc *= expf(clip(cum_s[t] - cum_s[s]));
      }
      sc_s[t * (kChunk + 1) + s] = acc;
    }
    for (int s = tid; s < kChunk; s += kThreads) wd_s[s] = expf(clip(total - cum_s[s]));
    __syncthreads();
    // -- y for this tile --------------------------------------------------------
    for (int e = tid; e < kChunk * kTileP; e += kThreads) {
      const int t = e / kTileP, c = e % kTileP;
      float st = 0.f;
      for (int n = 0; n < N; ++n) st += C_s[t * ldn + n] * S_s[n * kTileP + c];
      float acc = st * expf(cum_s[t]);
      for (int s = 0; s <= t; ++s) acc += sc_s[t * (kChunk + 1) + s] * xdt_s[s * kTileP + c];
      acc += d_h * x_s[e];
      if (t0 + t < T_len && c < tp) store(acc, &y[x_base + (t0 + t) * x_row + c]);
    }
    __syncthreads();  // the update overwrites S_s
    // -- state update -------------------------------------------------------------
    const float decay = expf(total);
    for (int e = tid; e < N * kTileP; e += kThreads) {
      const int n = e / kTileP, c = e % kTileP;
      float acc = decay * S_s[e];
      for (int s = 0; s < kChunk; ++s) acc += B_s[s * ldn + n] * wd_s[s] * xdt_s[s * kTileP + c];
      S_s[e] = acc;
    }
    __syncthreads();  // the next chunk's staging overwrites the tiles
  }
  for (int e = tid; e < N * kTileP; e += kThreads) {
    const int n = e / kTileP, c = e % kTileP;
    if (c < tp) sT[s_base + static_cast<size_t>(n) * P + p0 + c] = S_s[e];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* s0, void* y, void* sT,
                   int B, int T_len, int H, int P, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(mamba2_ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kTileP - 1) / kTileP, H, B);
  mamba2_ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(sT), T_len, H, P,
      N);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for state size N (ptxas reports only
// static shared memory).
extern "C" size_t mamba2_ssd_smem_bytes(int N) { return smem_bytes(N); }

// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16; dt, A, D, s0, sT are
// f32.  N <= 128 (the wrapper checks).  Returns the cudaError_t of the launch.
extern "C" int mamba2_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, const void* D, const void* s0, void* y, void* sT,
                          int B, int T_len, int H, int P, int N, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || P < 1 || N < 1 || N > 128 || T_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(launch<float>(x, dt, A, Bm, Cm, D, s0, y, sT, B, T_len, H, P, N, st));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, s0, y, sT, B, T_len, H, P, N, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
