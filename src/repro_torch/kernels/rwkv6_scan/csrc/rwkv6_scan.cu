// Chunked RWKV6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rwkv6_scan_pallas / _rwkv6_kernel in
// src/repro/kernels/rwkv6_scan/kernel.py.  Per (row b, head h), key dim j,
// value dim i, with a data-dependent decay w_t in (0, 1):
//
//   y_t[i]   = sum_j r_t[j] * (S[j, i] + u[j] * k_t[j] * v_t[i])
//   S[j, i] <- w_t[j] * S[j, i] + k_t[j] * v_t[i]
//
// taken 16 tokens at a time in the chunked form of rwkv6_chunked_ref: per
// channel the inclusive / exclusive log decays b, b_excl of the chunk
// (log w = log(max(w, 1e-38)), formed here from w as the reference does),
// the masked [C, C] scores with pair decays exp(clip(b_excl[t] - b[s], +-60))
// for s < t and the u bonus at s == t, the state term (r * exp(b_excl)) S,
// and the update S <- exp(b[C-1]) S + sum_s k_s exp(clip(b[C-1] - b_s)) v_s^T.
// The state and every sum stay f32; bf16 r/k/v are widened on load.
//
// What bounds it on this card: neither bytes nor FLOPs but latency.  The
// recurrence is sequential in T, so each block walks its chunks one after
// another with a few barriers per chunk.  Per token and head it moves
// 4 * N input values and N outputs and does ~4 * N^2 FLOPs of recurrence
// (N = 64 at full width): about 8 us of bytes and of f32 FLOPs each for a
// 512-token prefill of 64 heads -- far below what a serial walk of 32
// chunks costs.
//
// What the design does about it: the TPU grid (B, H, chunks) carried the
// state across grid steps in VMEM; here the chunk loop is inside the block
// and the state never leaves shared memory.  The value columns i of S are
// independent in both y and the update, so a block owns (b, h, 16-column
// tile of i): N/16 blocks per head, 256 blocks at full width (B = 1,
// H = 64), instead of the 64 that one block per head would give 132 SMs.
// Each block stages r, k and log w for all N channels and v for its tile,
// recomputes the chunk's [C, C] scores (the one piece shared by the tiles),
// then forms y for its tile and updates its S tile.  Shared rows are padded
// by one float against bank conflicts.  Not yet done: overlapping the next
// chunk's loads with this chunk's math, tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;    // tokens per chunk (the TPU kernel's chunk)
constexpr int kTileI = 16;    // value columns per block
constexpr int kThreads = 256; // = kChunk * kChunk (scores) = kChunk * kTileI (y)
constexpr float kClip = 60.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }

// Grid (ceil(N / kTileI), H, B), kThreads threads.  r/k/v/w/y: [B, T, H, N];
// u: [H, N]; s0/sT: [B, H, N(key), N(value)].  Requires N <= NMAX.
template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sT, int T_len, int H, int N) {
  __shared__ float r_s[kChunk][NMAX + 1];   // r, then r * exp(b_excl)
  __shared__ float k_s[kChunk][NMAX + 1];   // k, then k * exp(clip(total - b))
  __shared__ float bi_s[kChunk][NMAX + 1];  // inclusive log decay b
  __shared__ float be_s[kChunk][NMAX + 1];  // log w, then exclusive b_excl
  __shared__ float v_s[kChunk][kTileI];
  __shared__ float sc_s[kChunk][kChunk + 1];  // scores, u bonus on the diagonal
  __shared__ float S_s[NMAX][kTileI];
  __shared__ float tot_s[NMAX];
  __shared__ float u_s[NMAX];

  const int i0 = blockIdx.x * kTileI;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ti = min(kTileI, N - i0);  // live columns of this tile

  const size_t s_base = (static_cast<size_t>(b) * H + h) * N * N;
  for (int e = tid; e < N * kTileI; e += kThreads) {
    const int j = e / kTileI, c = e % kTileI;
    S_s[j][c] = c < ti ? s0[s_base + static_cast<size_t>(j) * N + i0 + c] : 0.f;
  }
  for (int j = tid; j < N; j += kThreads) u_s[j] = u[h * N + j];

  const size_t row = static_cast<size_t>(H) * N;  // stride of one token
  const size_t base = static_cast<size_t>(b) * T_len * row + static_cast<size_t>(h) * N;
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    // -- stage the chunk; tokens past T are r = k = v = 0, w = 1 ---------
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int t = e / N, j = e % N;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (t0 + t < T_len) {
        const size_t g = base + (t0 + t) * row + j;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        lw = logf(fmaxf(w[g], 1e-38f));
      }
      r_s[t][j] = rv;
      k_s[t][j] = kv;
      be_s[t][j] = lw;
    }
    for (int e = tid; e < kChunk * kTileI; e += kThreads) {
      const int t = e / kTileI, c = e % kTileI;
      v_s[t][c] = (t0 + t < T_len && c < ti) ? to_f32(v[base + (t0 + t) * row + i0 + c]) : 0.f;
    }
    __syncthreads();
    // -- per-channel cumulative log decays ---------------------------------
    for (int j = tid; j < N; j += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const float lw = be_s[t][j];
        acc += lw;
        bi_s[t][j] = acc;
        be_s[t][j] = acc - lw;
      }
      tot_s[j] = acc;
    }
    __syncthreads();
    // -- scores[t][s]: pair-decayed r.k for s < t, the u bonus at s == t ---
    {
      const int t = tid / kChunk, s = tid % kChunk;
      float acc = 0.f;
      if (s < t) {
        for (int j = 0; j < N; ++j) {
          acc += r_s[t][j] * k_s[s][j] * expf(clip(be_s[t][j] - bi_s[s][j]));
        }
      } else if (s == t) {
        for (int j = 0; j < N; ++j) acc += r_s[t][j] * u_s[j] * k_s[t][j];
      }
      sc_s[t][s] = acc;
    }
    __syncthreads();
    // -- decay r into the state term's query and k into the update's key ---
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int t = e / N, j = e % N;
      r_s[t][j] *= expf(be_s[t][j]);
      k_s[t][j] *= expf(clip(tot_s[j] - bi_s[t][j]));
    }
    __syncthreads();
    // -- y for this tile: state term + scores . v ----------------------------
    {
      const int t = tid / kTileI, c = tid % kTileI;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += r_s[t][j] * S_s[j][c];
      for (int s = 0; s <= t; ++s) acc += sc_s[t][s] * v_s[s][c];
      if (t0 + t < T_len && c < ti) store(acc, &y[base + (t0 + t) * row + i0 + c]);
    }
    __syncthreads();  // the update overwrites S_s
    // -- state update ---------------------------------------------------------
    for (int e = tid; e < N * kTileI; e += kThreads) {
      const int j = e / kTileI, c = e % kTileI;
      float acc = expf(tot_s[j]) * S_s[j][c];
#pragma unroll
      for (int s = 0; s < kChunk; ++s) acc += k_s[s][j] * v_s[s][c];
      S_s[j][c] = acc;
    }
    __syncthreads();  // the next chunk's staging overwrites the tiles
  }
  __syncthreads();
  for (int e = tid; e < N * kTileI; e += kThreads) {
    const int j = e / kTileI, c = e % kTileI;
    if (c < ti) sT[s_base + static_cast<size_t>(j) * N + i0 + c] = S_s[j][c];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* sT, int B, int T_len,
                   int H, int N, cudaStream_t stream) {
  const dim3 grid((N + kTileI - 1) / kTileI, H, B);
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  T* yp = static_cast<T*>(y);
  float* tp = static_cast<float*>(sT);
  if (N <= 64) {
    rwkv6_scan_kernel<T, 64><<<grid, kThreads, 0, stream>>>(rp, kp, vp, wp, up, sp, yp, tp,
                                                            T_len, H, N);
  } else if (N <= 128) {
    rwkv6_scan_kernel<T, 128><<<grid, kThreads, 0, stream>>>(rp, kp, vp, wp, up, sp, yp, tp,
                                                             T_len, H, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v, y): 0 = float32, 1 = bfloat16; w, u, s0, sT are f32.
// Returns the cudaError_t of the launch.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s0, void* y, void* sT, int B,
                          int T_len, int H, int N, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || N < 1 || T_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(r, k, v, w, u, s0, y, sT, B, T_len, H, N, st));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T_len, H, N, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
