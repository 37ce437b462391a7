// Chunked Mamba2 SSD recurrence for Hopper (sm_90a), as three chunk-parallel
// passes.
//
// Replaces the Pallas TPU kernel mamba2_ssd_pallas / _ssd_kernel in
// src/repro/kernels/mamba2_ssd/kernel.py.  Per (row b, head h), state size N,
// head channels P, scalar decay a_t = exp(dt_t * A_h), one B/C group shared
// by all heads:
//
//   S_t[n, p] = a_t * S_{t-1}[n, p] + dt_t * B_t[n] * x_t[p]
//   y_t[p]    = sum_n C_t[n] * S_t[n, p] + D_h * x_t[p]
//
// taken 64 tokens at a time.  With cum the inclusive cumsum of dt * A over a
// chunk and total = cum[63], the state hand-off S_{c+1} = exp(total_c) S_c +
// L_c is the only sequential dependency, and it is elementwise.  So:
//
//   1. ssd_states (grid: chunks x p-tiles, head groups, rows): per head, cum
//      by a warp-shuffle scan, then L_c = (B * exp(clip(total - cum)) * dt)^T x
//      into f32 scratch, and total;
//   2. ssd_pass (grid: state elements, heads, rows): walks the chunks with
//      one load, one FMA and one store per element and chunk, writing each
//      chunk's incoming state S_in over L_c, and the final state;
//   3. ssd_outputs (grid as stage 1): CB = C B^T once per (row, chunk), kept
//      in registers and reused by every head of the group; per head
//      y = (CB * exp(clip(cum_t - cum_s)) * dt_s)_{s<=t} x
//          + exp(cum_t) (C S_in) + D x,
//      rounded to x's dtype once.
//
// The three launch on the caller's stream, with no synchronise.  Each block
// stages the next head's x, dt (and, in stage 3, S_in) with cp.async while it
// computes the current head.  No atomics; every sum has a fixed order, so two
// calls give bitwise equal y and state.
//
// Products.  bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) with operands
// from shared memory through ldmatrix.  x, B and C are bf16 inputs and enter
// exactly; dt is folded into the f32 side, so x is always the other operand.
// The stage-1 weight B * decay * dt is rounded to bf16 once; the stage-3
// scores and S_in are split into a bf16 hi + lo pair (two products each),
// which keeps them within the bf16 tolerance of the plain version where one
// rounding does not (tests/test_torch_ssm_stages.py).  fp32: the same three
// stages with FFMA on the CUDA cores (4 x 4 register tiles), no TF32.
//
// Overflow.  For dt >= 0 and A <= 0 (the model's softplus dt and negative A)
// every exp argument is <= 0: the scan adds non-positive terms with a
// rounding that keeps cum non-increasing, so cum_t - cum_s (s <= t),
// total - cum_s and cum_t are all <= 0; pair and state-weight decays are
// also clipped at -60 as the plain version clips them.
//
// What bounds it on this card: bytes.  At B = 1, T = 512, H = 112, P = N = 64
// the products are ~1 GFLOP of bf16 (~1 us on the tensor cores) against
// ~19 MB of inputs and outputs (bound ~5.6 us at 3.35 TB/s) plus the f32 L /
// S_in scratch (14.7 MB written by stage 1, read and rewritten by stage 2,
// read by stage 3; it mostly stays in the 50 MB L2).  As built it runs about
// ten times its bound: each block walks its heads through short phases
// (loads, scan, scores, products, epilogue) separated by barriers, at two
// blocks an SM (stages 1 and 3 are held to 128 registers for that), so the
// phases' latency, not bytes or operations, sets the time.  What the design
// does about it: heads per block (ops.HEADS_PER_BLOCK, timed against 1, 2
// and 8 by chip_smoke.py) share the chunk's B and C and the CB product;
// each warp owns one 16-row tile and four column tiles, so an A fragment
// feeds four independent accumulators; the stage-1 weight is applied to
// B's fragments in registers (no pass over shared memory); outputs go
// through shared memory and out in 16-byte pieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kChunk = 64;    // tokens per chunk (the TPU kernel's chunk)
constexpr int kTileP = 64;    // head channels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;
constexpr float kClip = 60.f;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layouts by element type: bf16 tiles pad their inner width to
// 16 (the mma's k-depth) plus 8 (ldmatrix rows land in distinct banks); f32
// tiles pad to 4 (16-byte cp.async) plus 4.
template <typename T> struct Lay;
template <> struct Lay<bf16> {
  static constexpr bool kBf = true;
  __host__ __device__ static int width(int n) { return round_up(n, 16); }
  __host__ __device__ static int ld(int n) { return round_up(n, 16) + 8; }
};
template <> struct Lay<float> {
  static constexpr bool kBf = false;
  __host__ __device__ static int width(int n) { return round_up(n, 4); }
  __host__ __device__ static int ld(int n) { return round_up(n, 4) + 4; }
};
constexpr int kLdSt = kTileP + 4;  // f32 staging of S_in: [rows][kLdSt]

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }

// the bf16 pair packed in v (low half first), times (lo, hi), rounded again
__device__ __forceinline__ uint32_t scale2(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const __nv_bfloat162 r = __floats2bfloat162_rn(f.x * lo, f.y * hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// hi + lo bf16 pair of an f32 value
__device__ __forceinline__ void split(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16(v);
  *hi = h;
  *lo = __float2bfloat16(v - __bfloat162float(h));
}

// -- async copies -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, of which the first src_bytes (0 or 16) are read; the rest zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Fill dst[r * ldd + c] (rows x cols) from src[r * lds + c], zero where
// r >= live_r or c >= live_c.  vec: cp.async in 16-byte pieces (needs
// live_c, lds and cols to be whole pieces and src 16-byte aligned), else
// plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src, size_t lds, int rows,
                                          int cols, int live_r, int live_c, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = cols / E;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
      const int r = e / per_row, c = (e % per_row) * E;
      const bool live = r < live_r && c < live_c;
      cp_async16(dst + r * ldd + c, live ? src + r * lds + c : src, live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      dst[r * ldd + c] = (r < live_r && c < live_c) ? src[r * lds + c] : from_f32<T>(0.f);
    }
  }
}

// Copy live_r x live_c of the shared tile src (row stride lds) to dst (row
// stride ldd): 16-byte pieces, neighbouring threads on neighbouring pieces,
// when vec (live_c, ldd and dst whole pieces), else element by element.
template <typename T, int NT = kThreads>
__device__ __forceinline__ void store_tile(T* dst, size_t ldd, const T* src, int lds, int live_r,
                                           int live_c, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = live_c / E;
    for (int e = threadIdx.x; e < live_r * per_row; e += NT) {
      const int r = e / per_row, c = (e % per_row) * E;
      *reinterpret_cast<uint4*>(dst + r * ldd + c) =
          *reinterpret_cast<const uint4*>(src + r * lds + c);
    }
  } else {
    for (int e = threadIdx.x; e < live_r * live_c; e += NT) {
      const int r = e / live_c, c = e % live_c;
      dst[r * ldd + c] = src[r * lds + c];
    }
  }
}

// -- warp-level products (bf16 tensor cores) ------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}
// A fragment (16 x 16) of A(m, k) = a[m * ld + k]
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* a, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(r, a + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
// A fragment of A(m, k) = a[k * ld + m]
__device__ __forceinline__ void frag_a_t(uint32_t (&r)[4], const bf16* a, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(r, a + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8);
}
// B fragment (16 x 8) of B(k, n) = b[n * ld + k]
__device__ __forceinline__ void frag_b(uint32_t (&r)[2], const bf16* b, int ld, int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x2(r, b + (n0 + (l & 7)) * ld + k0 + ((l >> 3) & 1) * 8);
}
// B fragment of B(k, n) = b[k * ld + n]
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[2], const bf16* b, int ld, int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x2_t(r, b + (k0 + (l & 15)) * ld + n0);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// Accumulator element i of a 16 x 8 tile at (m0, n0) sits at row m0 + g
// (+ 8 for i >= 2), column n0 + 2 q + (i & 1), g = lane / 4, q = lane % 4.
__device__ __forceinline__ int acc_row(int i) { return ((threadIdx.x & 31) >> 2) + (i >> 1) * 8; }
__device__ __forceinline__ int acc_col(int i) { return (threadIdx.x & 3) * 2 + (i & 1); }

// -- thread-level products (f32 CUDA cores) --------------------------------------------

// acc[i][j] += sum_{k < K} a[i][k * sa] * b[j][k * sb]: a 4 x 4 register tile
__device__ __forceinline__ void ffma44(float (&acc)[4][4], const float* const (&a)[4], int sa,
                                       const float* const (&b)[4], int sb, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i][k * sa];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[j][k * sb];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}
__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Inclusive cumsum of dt[t] * a over the chunk, by warp 0 only (two tokens a
// lane, then a shuffle scan of the pairs).  For dt >= 0, a <= 0 the result
// is non-increasing in t.
__device__ __forceinline__ void chunk_cumsum(const float* dt, float a, float* cum) {
  const int l = threadIdx.x & 31;
  const float a0 = dt[2 * l] * a, a1 = dt[2 * l + 1] * a;
  float s = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, off);
    if (l >= off) s += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (l == 0) excl = 0.f;
  cum[2 * l] = excl + a0;
  cum[2 * l + 1] = s;
}

}  // namespace

namespace {

// Dynamic shared memory of stage 1 and stage 3 at state size N.
template <typename T>
__host__ __device__ size_t states_smem(int N) {
  const int ldn = Lay<T>::ld(N), ldp = Lay<T>::ld(kTileP);
  const int nw = Lay<T>::kBf ? 0 : 1;  // the f32 path stages B * decay * dt
  return sizeof(T) * ((1 + nw) * kChunk * ldn + 2 * kChunk * ldp) +
         sizeof(float) * (4 * kChunk + Lay<T>::width(N) * kLdSt);
}
template <typename T>
__host__ __device__ size_t outputs_smem(int N) {
  const int ldn = Lay<T>::ld(N), ldp = Lay<T>::ld(kTileP), rows = Lay<T>::width(N);
  const int nsc = Lay<T>::kBf ? 2 : 1;
  return sizeof(T) * (2 * kChunk * ldn + nsc * kChunk * ldp + 2 * kChunk * ldp) +
         sizeof(float) * (2 * rows * kLdSt + 4 * kChunk) +
         (Lay<T>::kBf ? sizeof(bf16) * 2 * rows * ldp : 0);
}

// Stage 1.  Grid (chunks x p-tiles, ceil(H / hg), B).  Per head of the
// group: L[b, c, h, n, p] = sum_s B[s, n] exp(clip(total - cum[s])) dt[s] x[s, p]
// (f32 scratch [B, chunks, H, N, Ps], Ps = P rounded up to 4) and
// tot[b, c, h] = total.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: <= 128 registers
ssd_states(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, float* __restrict__ L, float* __restrict__ tot,
           int T_len, int H, int P, int N, int hg) {
  using Ly = Lay<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wn = Ly::width(N), ldn = Ly::ld(N), ldp = Ly::ld(kTileP);
  T* Bs = reinterpret_cast<T*>(smem);         // [kChunk][ldn] the chunk's B
  T* xs = Bs + kChunk * ldn;                  // 2 x [kChunk][ldp] x tiles
  T* W = xs + 2 * kChunk * ldp;               // f32 path: [kChunk][ldn] B * decay * dt
  float* dts = reinterpret_cast<float*>(W + (Ly::kBf ? 0 : kChunk * ldn));  // 2 x [kChunk]
  float* cum = dts + 2 * kChunk;                                              // [kChunk]
  float* wgt = cum + kChunk;                                                  // [kChunk]
  float* Lt = wgt + kChunk;  // [wn][kLdSt] L of the head, written out in 16-byte pieces

  const int ntp = (P + kTileP - 1) / kTileP;
  const int c = blockIdx.x / ntp, p0 = (blockIdx.x % ntp) * kTileP;
  const int h0 = blockIdx.y * hg, nh = min(hg, H - h0), b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int nc = (T_len + kChunk - 1) / kChunk;
  const int tl = min(kChunk, T_len - c * kChunk);
  const int Ps = round_up(P, 4), pl = min(kTileP, P - p0), pw = min(kTileP, Ps - p0);
  constexpr int E = 16 / sizeof(T);
  const size_t row0 = static_cast<size_t>(b) * T_len + c * kChunk;  // first token

  auto stage = [&](int i) {  // head i's x tile and dt, asynchronously
    const int h = h0 + i, buf = i & 1;
    load_tile(xs + buf * kChunk * ldp, ldp, x + (row0 * H + h) * P + p0,
              static_cast<size_t>(H) * P, kChunk, kTileP, tl, pl, P % E == 0);
    for (int t = threadIdx.x; t < kChunk; t += kThreads) {
      cp_async4(dts + buf * kChunk + t, t < tl ? dt + (row0 + t) * H + h : dt, t < tl ? 4 : 0);
    }
  };
  load_tile(Bs, ldn, Bm + row0 * N, N, kChunk, wn, tl, N, N % E == 0);
  stage(0);
  cp_async_commit();
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i, buf = i & 1;
    if (i + 1 < nh) stage(i + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* dtb = dts + buf * kChunk;
    const T* xb = xs + buf * kChunk * ldp;
    if (warp == 0) {
      chunk_cumsum(dtb, A[h], cum);
      __syncwarp();
      const float total = cum[kChunk - 1];
      for (int t = threadIdx.x; t < kChunk; t += 32) {
        wgt[t] = __expf(clip(total - cum[t])) * dtb[t];
      }
    }
    __syncthreads();
    float* Lh = L + ((static_cast<size_t>(b) * nc + c) * H + h) * N * Ps + p0;
    if constexpr (Ly::kBf) {
      // L = W^T x with W[s][n] = B[s][n] wgt[s]: each A fragment of B^T is
      // scaled by wgt in registers and rounded to bf16 once.  A warp owns
      // one 16-row tile of n and four 8-column tiles of p.
      const int mt = wn / 16, q4 = threadIdx.x & 3, nq = (warp & 1) * 4;
      for (int m = warp >> 1; m < mt; m += kWarps / 2) {
        const int m0 = m * 16;
        float acc[4][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < kChunk; k0 += 16) {
          uint32_t a[4];
          frag_a_t(a, Bs, ldn, m0, k0);
          const float* w = wgt + k0 + 2 * q4;  // a[0], a[1]: k0 + 2 q4 (+1); a[2], a[3]: + 8
          a[0] = scale2(a[0], w[0], w[1]);
          a[1] = scale2(a[1], w[0], w[1]);
          a[2] = scale2(a[2], w[8], w[9]);
          a[3] = scale2(a[3], w[8], w[9]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((nq + j) * 8 < pw) {
              uint32_t bb[2];
              frag_b_t(bb, xb, ldp, k0, (nq + j) * 8);
              mma(acc[j], a, bb);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = m0 + acc_row(q), p = (nq + j) * 8 + acc_col(q);
            Lt[n * kLdSt + p] = acc[j][q];
          }
      }
    } else {
      for (int e = threadIdx.x; e < kChunk * wn; e += kThreads) {
        const int s = e / wn, n = e % wn;
        W[s * ldn + n] = Bs[s * ldn + n] * wgt[s];
      }
      __syncthreads();
      const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
      for (int m0 = 0; m0 < N; m0 += 64) {
        float acc[4][4];
        zero44(acc);
        const float* a[4];
        const float* bb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = W + min(m0 + ty + 16 * q, wn - 1);
          bb[q] = xb + tx + 16 * q;
        }
        ffma44(acc, a, ldn, bb, ldp, kChunk);
#pragma unroll
        for (int qi = 0; qi < 4; ++qi)
#pragma unroll
          for (int qj = 0; qj < 4; ++qj) {
            const int n = m0 + ty + 16 * qi, p = tx + 16 * qj;
            if (n < wn) Lt[n * kLdSt + p] = acc[qi][qj];
          }
      }
    }
    __syncthreads();
    store_tile(Lh, static_cast<size_t>(Ps), Lt, kLdSt, N, pw, true);
    if (p0 == 0 && threadIdx.x == 0) {
      tot[(static_cast<size_t>(b) * nc + c) * H + h] = cum[kChunk - 1];
    }
    __syncthreads();  // the next head overwrites cum, wgt, W and this x buffer
  }
}

// Stage 2.  Grid (ceil(N P / kPassThreads), H, B).  Walks the chunks of one
// (row, head) per state element: L[c] <- S_in(c), S <- exp(tot[c]) S + L[c];
// writes the final state to sT.  Loads run eight chunks ahead of the chain.
__global__ void __launch_bounds__(kPassThreads)
ssd_pass(const float* __restrict__ s0, float* __restrict__ L, const float* __restrict__ tot,
         float* __restrict__ sT, int nc, int H, int P, int N) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= N * P) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = e / P, p = e % P, Ps = round_up(P, 4);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t step = static_cast<size_t>(H) * N * Ps;  // one chunk of L
  float* l = L + (static_cast<size_t>(b) * nc * H + h) * N * Ps + static_cast<size_t>(n) * Ps + p;
  const float* d = tot + static_cast<size_t>(b) * nc * H + h;
  float S = s0[bh * N * P + e];
  constexpr int kAhead = 8;
  int c = 0;
  for (; c + kAhead <= nc; c += kAhead) {
    float lv[kAhead], dv[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      lv[k] = l[(c + k) * step];
      dv[k] = d[static_cast<size_t>(c + k) * H];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      l[(c + k) * step] = S;
      S = expf(dv[k]) * S + lv[k];
    }
  }
  for (; c < nc; ++c) {
    const float lv = l[c * step];
    l[c * step] = S;
    S = expf(d[static_cast<size_t>(c) * H]) * S + lv;
  }
  sT[bh * N * P + e] = S;
}

// Stage 3.  Grid as stage 1.  CB = C B^T once per block (registers), then per
// head y = (CB exp(clip(cum_t - cum_s)) dt_s)_{s<=t} x + exp(cum_t) C S_in + D x.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: <= 128 registers
ssd_outputs(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
            const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
            const float* __restrict__ Sin, T* __restrict__ y, int T_len, int H, int P, int N,
            int hg) {
  using Ly = Lay<T>;
  constexpr int nsc = Ly::kBf ? 2 : 1;  // scores: hi, lo (bf16) or f32
  extern __shared__ __align__(16) unsigned char smem[];
  const int wn = Ly::width(N), ldn = Ly::ld(N), ldp = Ly::ld(kTileP);
  T* Bs = reinterpret_cast<T*>(smem);  // [kChunk][ldn]
  T* Cs = Bs + kChunk * ldn;           // [kChunk][ldn]
  T* SC = Cs + kChunk * ldn;           // nsc x [kChunk][ldp] masked, decayed scores
  T* xs = SC + nsc * kChunk * ldp;     // 2 x [kChunk][ldp]
  float* Sst = reinterpret_cast<float*>(xs + 2 * kChunk * ldp);  // 2 x [wn][kLdSt] S_in
  bf16* Sop = reinterpret_cast<bf16*>(Sst + 2 * wn * kLdSt);     // bf16: [wn][ldp] hi, lo
  float* dts = reinterpret_cast<float*>(Sop + (Ly::kBf ? 2 * wn * ldp : 0));  // 2 x [kChunk]
  float* cum = dts + 2 * kChunk;                                               // [kChunk]
  float* ecum = cum + kChunk;                                                  // exp(cum)

  const int ntp = (P + kTileP - 1) / kTileP;
  const int c = blockIdx.x / ntp, p0 = (blockIdx.x % ntp) * kTileP;
  const int h0 = blockIdx.y * hg, nh = min(hg, H - h0), b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // f32 4 x 4 tiles
  const int nc = (T_len + kChunk - 1) / kChunk;
  const int tl = min(kChunk, T_len - c * kChunk);
  const int Ps = round_up(P, 4), pl = min(kTileP, P - p0), pw = min(kTileP, Ps - p0);
  constexpr int E = 16 / sizeof(T);
  const size_t row0 = static_cast<size_t>(b) * T_len + c * kChunk;

  auto stage = [&](int i) {  // head i's x tile, S_in tile and dt, asynchronously
    const int h = h0 + i, buf = i & 1;
    load_tile(xs + buf * kChunk * ldp, ldp, x + (row0 * H + h) * P + p0,
              static_cast<size_t>(H) * P, kChunk, kTileP, tl, pl, P % E == 0);
    load_tile(Sst + buf * wn * kLdSt, kLdSt,
              Sin + ((static_cast<size_t>(b) * nc + c) * H + h) * N * Ps + p0,
              static_cast<size_t>(Ps), wn, kTileP, N, pw, true);
    for (int t = threadIdx.x; t < kChunk; t += kThreads) {
      cp_async4(dts + buf * kChunk + t, t < tl ? dt + (row0 + t) * H + h : dt, t < tl ? 4 : 0);
    }
  };
  load_tile(Bs, ldn, Bm + row0 * N, N, kChunk, wn, tl, N, N % E == 0);
  load_tile(Cs, ldn, Cm + row0 * N, N, kChunk, wn, tl, N, N % E == 0);
  stage(0);
  cp_async_commit();
  float cb[4][4];  // bf16: tiles (16 jj, 8 warp) of CB; f32: rows ty + 16 i, cols tx + 16 j
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i, buf = i & 1;
    if (i + 1 < nh) stage(i + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (i == 0) {  // CB[t][s] = sum_n C[t][n] B[s][n]
      if constexpr (Ly::kBf) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          cb[jj][0] = cb[jj][1] = cb[jj][2] = cb[jj][3] = 0.f;
          for (int k0 = 0; k0 < wn; k0 += 16) {
            uint32_t a[4], bb[2];
            frag_a(a, Cs, ldn, jj * 16, k0);
            frag_b(bb, Bs, ldn, k0, warp * 8);
            mma(cb[jj], a, bb);
          }
        }
      } else {
        zero44(cb);
        const float* a[4];
        const float* bb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = Cs + (ty + 16 * q) * ldn;
          bb[q] = Bs + (tx + 16 * q) * ldn;
        }
        ffma44(cb, a, 1, bb, 1, N);
      }
    }
    const float* dtb = dts + buf * kChunk;
    const T* xb = xs + buf * kChunk * ldp;
    const float* Sb = Sst + buf * wn * kLdSt;
    bf16* Shi = Sop;
    bf16* Slo = Sop + wn * ldp;
    if (warp == 0) {
      chunk_cumsum(dtb, A[h], cum);
      __syncwarp();
      for (int t = threadIdx.x; t < kChunk; t += 32) ecum[t] = __expf(cum[t]);
    }
    if constexpr (Ly::kBf) {  // S_in as a bf16 hi + lo pair
      for (int e = threadIdx.x; e < wn * kTileP; e += kThreads) {
        const int n = e / kTileP, p = e % kTileP;
        split(Sb[n * kLdSt + p], Shi + n * ldp + p, Slo + n * ldp + p);
      }
    }
    __syncthreads();
    // scores[t][s] = CB[t][s] exp(clip(cum_t - cum_s)) dt_s for s <= t, else 0
    if constexpr (Ly::kBf) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = jj * 16 + acc_row(q), s = warp * 8 + acc_col(q);
          const float v = s <= t ? cb[jj][q] * __expf(clip(cum[t] - cum[s])) * dtb[s] : 0.f;
          split(v, SC + t * ldp + s, SC + kChunk * ldp + t * ldp + s);
        }
    } else {
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) {
          const int t = ty + 16 * qi, s = tx + 16 * qj;
          SC[t * ldp + s] = s <= t ? cb[qi][qj] * __expf(clip(cum[t] - cum[s])) * dtb[s] : 0.f;
        }
    }
    __syncthreads();
    const float d_h = D[h];
    T* yh = y + (row0 * H + h) * P + p0;
    const size_t ys = static_cast<size_t>(H) * P;  // token stride of x and y
    if constexpr (Ly::kBf) {
      // a warp owns one 16-row tile of t and four 8-column tiles of p, so
      // each A fragment feeds four independent accumulators
      const int m0 = (warp >> 1) * 16, nq = (warp & 1) * 4;
      float ai[4][4] = {}, as[4][4] = {};
      for (int k0 = 0; k0 <= m0; k0 += 16) {  // scores . x (zero for s > t)
        uint32_t ah[4], al[4];
        frag_a(ah, SC, ldp, m0, k0);
        frag_a(al, SC + kChunk * ldp, ldp, m0, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((nq + j) * 8 < pl) {
            uint32_t bb[2];
            frag_b_t(bb, xb, ldp, k0, (nq + j) * 8);
            mma(ai[j], ah, bb);
            mma(ai[j], al, bb);
          }
        }
      }
      for (int k0 = 0; k0 < wn; k0 += 16) {  // C . S_in
        uint32_t a[4];
        frag_a(a, Cs, ldn, m0, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((nq + j) * 8 < pl) {
            uint32_t bh[2], bl[2];
            frag_b_t(bh, Shi, ldp, k0, (nq + j) * 8);
            frag_b_t(bl, Slo, ldp, k0, (nq + j) * 8);
            mma(as[j], a, bh);
            mma(as[j], a, bl);
          }
        }
      }
      __syncthreads();  // every warp has read the scores: y goes over them
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = m0 + acc_row(q), p = (nq + j) * 8 + acc_col(q);
          SC[t * ldp + p] =
              from_f32<T>(ai[j][q] + ecum[t] * as[j][q] + d_h * to_f32(xb[t * ldp + p]));
        }
    } else {
      float ai[4][4], as[4][4];
      zero44(ai);
      zero44(as);
      const float* a[4];
      const float* bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = SC + (ty + 16 * q) * ldp;
        bb[q] = xb + tx + 16 * q;
      }
      ffma44(ai, a, 1, bb, ldp, kChunk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = Cs + (ty + 16 * q) * ldn;
        bb[q] = Sb + tx + 16 * q;
      }
      ffma44(as, a, 1, bb, kLdSt, N);
      __syncthreads();  // every thread has read the scores: y goes over them
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) {
          const int t = ty + 16 * qi, p = tx + 16 * qj;
          SC[t * ldp + p] =
              from_f32<T>(ai[qi][qj] + ecum[t] * as[qi][qj] + d_h * to_f32(xb[t * ldp + p]));
        }
    }
    __syncthreads();
    store_tile(yh, ys, SC, ldp, tl, pl, P % E == 0);
    __syncthreads();  // the next head overwrites cum, the scores, S_in and this buffer
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* s0, void* y, void* sT, void* L,
                   void* tot, int B, int T_len, int H, int P, int N, int hg,
                   cudaStream_t stream) {
  const int nc = (T_len + kChunk - 1) / kChunk;
  const dim3 grid(nc * ((P + kTileP - 1) / kTileP), (H + hg - 1) / hg, B);
  const T* xp = static_cast<const T*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  float* Lp = static_cast<float*>(L);
  float* totp = static_cast<float*>(tot);
  cudaError_t err;
  if (nc > 0) {
    const size_t smem = states_smem<T>(N);
    err = cudaFuncSetAttribute(ssd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ssd_states<T><<<grid, kThreads, smem, stream>>>(xp, dtp, Ap, static_cast<const T*>(Bm), Lp,
                                                     totp, T_len, H, P, N, hg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_pass<<<dim3((N * P + kPassThreads - 1) / kPassThreads, H, B), kPassThreads, 0, stream>>>(
      static_cast<const float*>(s0), Lp, totp, static_cast<float*>(sT), nc, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    const size_t smem = outputs_smem<T>(N);
    err = cudaFuncSetAttribute(ssd_outputs<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ssd_outputs<T><<<grid, kThreads, smem, stream>>>(
        xp, dtp, Ap, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
        static_cast<const float*>(D), Lp, static_cast<T*>(y), T_len, H, P, N, hg);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Dynamic shared memory of one block of stage 1, 2 or 3 for state size N and
// dtype (0 = float32, 1 = bfloat16); ptxas reports only static shared memory.
extern "C" size_t mamba2_ssd_smem_bytes(int N, int dtype, int stage) {
  if (stage == 2) return 0;
  if (dtype == 1) return stage == 1 ? states_smem<bf16>(N) : outputs_smem<bf16>(N);
  return stage == 1 ? states_smem<float>(N) : outputs_smem<float>(N);
}

// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16; dt, A, D, s0, sT are
// f32.  L: f32 scratch of B * ceil(T / 64) * H * N * round_up(P, 4) values,
// tot: of B * ceil(T / 64) * H (the wrapper allocates both).  hg: heads per
// block of stages 1 and 3.  N <= 128.  Launches the three stages (only
// stage 2 when T = 0) and returns the first cudaError_t.
extern "C" int mamba2_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, const void* D, const void* s0, void* y, void* sT,
                          void* L, void* tot, int B, int T_len, int H, int P, int N, int dtype,
                          int hg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || P < 1 || N < 1 || N > 128 || T_len < 0 || hg < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(
        launch<float>(x, dt, A, Bm, Cm, D, s0, y, sT, L, tot, B, T_len, H, P, N, hg, st));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<bf16>(x, dt, A, Bm, Cm, D, s0, y, sT, L, tot, B, T_len, H, P, N, hg, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
