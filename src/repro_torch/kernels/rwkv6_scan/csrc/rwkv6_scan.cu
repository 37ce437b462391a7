// Chunked RWKV6 (Finch) recurrence for Hopper (sm_90a), as three
// chunk-parallel passes.
//
// Replaces the Pallas TPU kernel rwkv6_scan_pallas / _rwkv6_kernel in
// src/repro/kernels/rwkv6_scan/kernel.py.  Per (row b, head h), key dim j,
// value dim i, with a data-dependent decay w_t in (0, 1):
//
//   y_t[i]   = sum_j r_t[j] * (S[j, i] + u[j] * k_t[j] * v_t[i])
//   S[j, i] <- w_t[j] * S[j, i] + k_t[j] * v_t[i]
//
// The state passes between chunks of 64 tokens (the plain version's chunk of
// 16 differs from it only by f32 rounding).  Per channel, log w = log(max(w,
// 1e-38)) is summed within each 16-token sub-chunk g: the local inclusive
// prefix bl, its exclusive form ble (0 at the sub-chunk start) and the
// sub-chunk total cg[g].  Every decay exponent is built from these, so no
// difference of prefix sums spans more than one sub-chunk: one over the
// whole chunk cancels digits in f32 once w nears its 1e-38 floor (log w ~
// -87 a token).  With total = sum_g cg[g], the hand-off S_{c+1} =
// exp(total) * S_c + L_c (per key row) is the only sequential dependency,
// and it is elementwise:
//
//   1. rwkv_states (grid: chunks x value tiles, heads, rows): the log decays
//      by segmented warp-shuffle scans, L_c = (k_s * exp(clip(cg[g_s] - bl_s
//      + sum_{g > g_s} cg[g])))^T v into f32 scratch, and total;
//   2. rwkv_pass (grid: state elements, heads, rows): walks the chunks with
//      one load, one FMA and one store per element and chunk, writing each
//      chunk's incoming state S_in over L_c, and the final state;
//   3. rwkv_outputs (grid as stage 1): y = scores v + (r_t * exp(sum_{g <
//      g_t} cg[g] + ble_t)) S_in.  The scores of a pair (t, s) inside one
//      sub-chunk are formed exactly on the CUDA cores, sum_j r_t k_s
//      exp(clip(ble_t - bl_s)), with the u bonus at s == t; for s in an
//      earlier sub-chunk they are the product (r_t * exp(clip(ble_t))) .
//      (k_s * exp(clip(cg[g_s] - bl_s)) * exp(clip(sum_{g_s < g < g_t}
//      cg[g]))), all six (g_t, g_s) blocks in one pass: the last factor, a
//      per-channel constant of the pair of sub-chunks, scales the B
//      fragments in registers.
//
// The three launch on the caller's stream, with no synchronise.  A block
// handles one head (8 chunks x 64 heads give 512 blocks at full width,
// T = 512); its loads are cp.async, and S_in goes in its own group, in flight
// while the block scans the decays and forms the exact pair scores.  No
// atomics; every sum has a fixed order, so two calls give bitwise equal y
// and state.
//
// Products.  bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) with operands
// from shared memory through ldmatrix.  r, k and v are bf16 inputs; v enters
// exactly.  Every f32 operand (decayed k of stage 1, the two cross-sub-chunk
// factors, the scores, decayed r and S_in) is split into a bf16 hi + lo
// pair: against an f32 partner two products (hi v + lo v), between two
// split operands three (hi hi + hi lo + lo hi).  One rounding per operand
// leaves thousands of entries outside the bf16 tolerance of the plain
// version (tests/test_torch_ssm_stages.py).  fp32: the same three stages
// with FFMA on the CUDA cores, no TF32.
//
// Overflow.  log w <= 0, and the scan keeps bl non-increasing in t within a
// sub-chunk, so every exp argument is <= 0: ble_t - bl_s (s < t), ble_t,
// cg[g_s] - bl_s plus sub-chunk totals, and the state term's.  Decays are
// clipped at -60 where the plain version clips them; a cross pair whose two
// factors underflow lies below e^-60, where the plain version clips too.
//
// What bounds it on this card: bytes.  At B = 1, T = 512, H = 64, N = 64 the
// products are ~0.5 GFLOP of bf16 (under 1 us on the tensor cores) against
// ~27 MB of inputs and outputs (w is f32; bound ~8.1 us at 3.35 TB/s) plus
// the f32 L / S_in scratch (8.4 MB, which mostly stays in the 50 MB L2).  As
// built it runs over ten times its bound: the exact pair scores inside the
// sub-chunks (one exp per pair and channel, 35K per block) and the short,
// barrier-separated phases of stage 3 at two blocks an SM set the time.
// What the design does about it: stage 3 runs 16 warps a block in bf16; the
// pairs are spread four lanes to a pair with a fixed shuffle reduction;
// the cross-sub-chunk scores of all six sub-chunk pairs are one product
// pass; each warp's A fragments feed several accumulators; outputs go
// through shared memory and out in 16-byte pieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kChunk = 64;    // tokens per chunk between state hand-offs
constexpr int kSub = 16;      // tokens per sub-chunk of exact pair scores
constexpr int kTileP = 64;    // value columns per block
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
constexpr int kLdSt = kTileP + 4;  // f32 S_in tile: [rows][kLdSt]

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }

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
template <typename T, int NT = kThreads>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src, size_t lds, int rows,
                                          int cols, int live_r, int live_c, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = cols / E;
    for (int e = threadIdx.x; e < rows * per_row; e += NT) {
      const int r = e / per_row, c = (e % per_row) * E;
      const bool live = r < live_r && c < live_c;
      cp_async16(dst + r * ldd + c, live ? src + r * lds + c : src, live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NT) {
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

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An f32 product operand: the bf16 path stores its hi + lo pair (lo at p +
// lo_off), the f32 path the value.
// The two values of a split bf16 fragment register pair (hi + lo), times
// (f0, f1), split again into hi + lo.
__device__ __forceinline__ void rescale(uint32_t& hi, uint32_t& lo, float f0, float f1) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float v0 = (h.x + l.x) * f0, v1 = (h.y + l.y) * f1;
  const __nv_bfloat162 nh = __floats2bfloat162_rn(v0, v1);
  const float2 nf = __bfloat1622float2(nh);
  const __nv_bfloat162 nl = __floats2bfloat162_rn(v0 - nf.x, v1 - nf.y);
  hi = *reinterpret_cast<const uint32_t*>(&nh);
  lo = *reinterpret_cast<const uint32_t*>(&nl);
}

template <typename T> __device__ __forceinline__ void put(T* p, size_t lo_off, float v);
template <> __device__ __forceinline__ void put<bf16>(bf16* p, size_t lo_off, float v) {
  split(v, p, p + lo_off);
}
template <> __device__ __forceinline__ void put<float>(float* p, size_t, float v) { *p = v; }

// b[t * ld + j] holds w (tokens t >= tl count as w = 1); replaced by bl, the
// inclusive cumsum of log(max(w, 1e-38)) from the start of t's sub-chunk,
// for j < n.  Each warp scans whole channels: two tokens a lane, a shuffle
// scan of the pairs within each group of kSub / 2 lanes.  The result is
// non-increasing in t within a sub-chunk.
template <int NW = kWarps>
__device__ __forceinline__ void log_decay_cumsum(float* b, int ld, int n, int tl) {
  const int l = threadIdx.x & 31, t0 = 2 * l, t1 = 2 * l + 1, seg = l & (kSub / 2 - 1);
  for (int j0 = threadIdx.x / 32; j0 < n; j0 += 2 * NW) {  // two channels at once
    float a0[2], a1[2], s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = min(j0 + u * NW, n - 1);
      a0[u] = t0 < tl ? logf(fmaxf(b[t0 * ld + j], 1e-38f)) : 0.f;
      a1[u] = t1 < tl ? logf(fmaxf(b[t1 * ld + j], 1e-38f)) : 0.f;
      s[u] = a0[u] + a1[u];
    }
#pragma unroll
    for (int off = 1; off < kSub / 2; off <<= 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = __shfl_up_sync(0xffffffffu, s[u], off);
        if (seg >= off) s[u] += v;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float excl = __shfl_up_sync(0xffffffffu, s[u], 1);
      if (seg == 0) excl = 0.f;
      const int j = j0 + u * NW;
      if (j < n) {
        b[t0 * ld + j] = excl + a0[u];
        b[t1 * ld + j] = s[u];
      }
    }
  }
}
// ble[t][j]: bl of the previous token in t's sub-chunk, 0 at its start
__device__ __forceinline__ float ble(const float* b, int ld, int t, int j) {
  return t % kSub ? b[(t - 1) * ld + j] : 0.f;
}
// sum_{lo <= g < hi} cg[g][j], in order of g (cg[g] = bl at g's last token)
__device__ __forceinline__ float cg_sum(const float* b, int ld, int lo, int hi, int j) {
  float acc = 0.f;
  for (int g = lo; g < hi; ++g) acc += b[(g * kSub + kSub - 1) * ld + j];
  return acc;
}
// the log decay after token s to the end of sub-chunk hi - 1:
// cg[g_s] - bl_s + sum_{g_s < g < hi} cg[g]
__device__ __forceinline__ float decay_after(const float* b, int ld, int s, int hi, int j) {
  const int gs = s / kSub;
  return (b[(gs * kSub + kSub - 1) * ld + j] - b[s * ld + j]) + cg_sum(b, ld, gs + 1, hi, j);
}

}  // namespace

namespace {

// rows of the operand region X of stage 3: the cross-sub-chunk factors of t
// (sub-chunks 1-3) and of s (sub-chunks 0-2), then decayed r (kChunk rows)
constexpr int kXRows = 2 * (kChunk - kSub);

template <typename T>
__host__ __device__ size_t kd_region(int N) {  // decayed k, then the L tile (f32)
  const int nop = Lay<T>::kBf ? 2 : 1;
  const size_t kd = sizeof(T) * nop * kChunk * Lay<T>::ld(N);
  const size_t lt = sizeof(float) * Lay<T>::width(N) * kLdSt;
  return kd > lt ? kd : lt;
}
template <typename T>
__host__ __device__ size_t states_smem(int N) {
  return sizeof(float) * kChunk * Lay<float>::ld(N) +
         sizeof(T) * (kChunk * Lay<T>::ld(N) + kChunk * Lay<T>::ld(kTileP)) + kd_region<T>(N);
}
template <typename T>
__host__ __device__ size_t s_region(int N) {  // S_in as loaded (f32), then its operands
  const int nop = Lay<T>::kBf ? 2 : 1;
  const size_t f = sizeof(float) * Lay<T>::width(N) * kLdSt;
  const size_t o = sizeof(T) * nop * Lay<T>::width(N) * Lay<T>::ld(kTileP);
  return f > o ? f : o;
}
template <typename T>
__host__ __device__ size_t outputs_smem(int N) {
  const int nop = Lay<T>::kBf ? 2 : 1;
  const int ldn = Lay<T>::ld(N), ldp = Lay<T>::ld(kTileP);
  return sizeof(float) * (kChunk * Lay<float>::ld(N) + round_up(N, 4) + 3 * Lay<T>::width(N)) +
         sizeof(T) * (2 * kChunk * ldn + kChunk * ldp + nop * kXRows * ldn + nop * kChunk * ldp) +
         s_region<T>(N);
}

// Stage 1.  Grid (chunks x value tiles, H, B).  L[b, c, h, j, i] =
// sum_s k[s, j] exp(clip(log decay after s)) v[s, i] (f32 scratch [B,
// chunks, H, N, Ns], Ns = N rounded up to 4) and tot[b, c, h, j] = total_j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_states(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
            float* __restrict__ L, float* __restrict__ tot, int T_len, int H, int N) {
  using Ly = Lay<T>;
  constexpr int nop = Ly::kBf ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wn = Ly::width(N), ldn = Ly::ld(N), ldp = Ly::ld(kTileP);
  const int ldw = Lay<float>::ld(N);
  float* bs = reinterpret_cast<float*>(smem);    // [kChunk][ldw] w, then b
  T* ks = reinterpret_cast<T*>(bs + kChunk * ldw);  // [kChunk][ldn]
  T* vs = ks + kChunk * ldn;                        // [kChunk][ldp]
  T* Kd = vs + kChunk * ldp;                        // nop x [kChunk][ldn] decayed k
  float* Lt = reinterpret_cast<float*>(Kd);  // then [wn][kLdSt] L, written out in pieces
  const size_t ko = static_cast<size_t>(kChunk) * ldn;

  const int nti = (N + kTileP - 1) / kTileP;
  const int c = blockIdx.x / nti, i0 = (blockIdx.x % nti) * kTileP;
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x / 32;
  const int nc = (T_len + kChunk - 1) / kChunk;
  const int tl = min(kChunk, T_len - c * kChunk);
  const int Ns = round_up(N, 4), il = min(kTileP, N - i0), iw = min(kTileP, Ns - i0);
  constexpr int E = 16 / sizeof(T);
  const size_t ts = static_cast<size_t>(H) * N;  // token stride
  const size_t base =
      (static_cast<size_t>(b) * T_len + c * kChunk) * ts + static_cast<size_t>(h) * N;

  load_tile(bs, ldw, w + base, ts, kChunk, Lay<float>::width(N), tl, N, N % 4 == 0);
  load_tile(ks, ldn, k + base, ts, kChunk, wn, tl, N, N % E == 0);
  load_tile(vs, ldp, v + base + i0, ts, kChunk, kTileP, tl, il, N % E == 0);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  log_decay_cumsum(bs, ldw, N, tl);
  __syncthreads();
  constexpr int G = kChunk / kSub;
  for (int s = warp; s < kChunk; s += kWarps) {  // a row a warp, channels across lanes
    for (int j = threadIdx.x & 31; j < wn; j += 32) {
      const float val =
          j < N ? to_f32(ks[s * ldn + j]) * __expf(clip(decay_after(bs, ldw, s, G, j))) : 0.f;
      put<T>(Kd + s * ldn + j, ko, val);
    }
  }
  __syncthreads();
  float* Lh = L + ((static_cast<size_t>(b) * nc + c) * H + h) * N * Ns + i0;
  if constexpr (Ly::kBf) {
    // L = Kd^T v: A(j, s) = Kd[s][j] (hi, lo), B(s, i) = v[s][i]; a warp owns
    // 16-row tiles m and m + 4 of j and four 8-column tiles of i
    const int nq = (warp & 1) * 4;
    float acc[2][4][4] = {};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m0 = ((warp >> 1) + mi * (kWarps / 2)) * 16;
      if (m0 >= wn) break;
#pragma unroll
      for (int k0 = 0; k0 < kChunk; k0 += 16) {
        uint32_t ah[4], al[4];
        frag_a_t(ah, Kd, ldn, m0, k0);
        frag_a_t(al, Kd + ko, ldn, m0, k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((nq + q) * 8 < iw) {
            uint32_t bb[2];
            frag_b_t(bb, vs, ldp, k0, (nq + q) * 8);
            mma(acc[mi][q], ah, bb);
            mma(acc[mi][q], al, bb);
          }
        }
      }
    }
    __syncthreads();  // every warp has read Kd: L goes over it
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m0 = ((warp >> 1) + mi * (kWarps / 2)) * 16;
      if (m0 >= wn) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          Lt[(m0 + acc_row(r)) * kLdSt + (nq + q) * 8 + acc_col(r)] = acc[mi][q][r];
        }
    }
  } else {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      zero44(acc[mi]);
      if (mi * 64 >= N) break;
      const float* a[4];
      const float* bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = Kd + min(mi * 64 + ty + 16 * q, wn - 1);
        bb[q] = vs + tx + 16 * q;
      }
      ffma44(acc[mi], a, ldn, bb, ldp, kChunk);
    }
    __syncthreads();  // every thread has read Kd: L goes over it
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) {
          const int j = mi * 64 + ty + 16 * qi, i = tx + 16 * qj;
          if (j < wn) Lt[j * kLdSt + i] = acc[mi][qi][qj];
        }
  }
  __syncthreads();
  store_tile(Lh, static_cast<size_t>(Ns), Lt, kLdSt, N, iw, true);
  if (i0 == 0) {
    for (int j = threadIdx.x; j < N; j += kThreads) {
      tot[((static_cast<size_t>(b) * nc + c) * H + h) * N + j] = cg_sum(bs, ldw, 0, G, j);
    }
  }
}

// Stage 2.  Grid (ceil(N N / kPassThreads), H, B).  Walks the chunks of one
// (row, head) per state element (key row j, value column i): L[c] <- S_in(c),
// S <- exp(tot[c, j]) S + L[c]; writes the final state to sT.  Loads run
// eight chunks ahead of the chain.
__global__ void __launch_bounds__(kPassThreads)
rwkv_pass(const float* __restrict__ s0, float* __restrict__ L, const float* __restrict__ tot,
          float* __restrict__ sT, int nc, int H, int N) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= N * N) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = e / N, i = e % N, Ns = round_up(N, 4);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t step = static_cast<size_t>(H) * N * Ns, dstep = static_cast<size_t>(H) * N;
  float* l = L + (static_cast<size_t>(b) * nc * H + h) * N * Ns + static_cast<size_t>(j) * Ns + i;
  const float* d = tot + (static_cast<size_t>(b) * nc * H + h) * N + j;
  float S = s0[bh * N * N + e];
  constexpr int kAhead = 8;
  int c = 0;
  for (; c + kAhead <= nc; c += kAhead) {
    float lv[kAhead], dv[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      lv[q] = l[(c + q) * step];
      dv[q] = d[(c + q) * dstep];
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      l[(c + q) * step] = S;
      S = expf(dv[q]) * S + lv[q];
    }
  }
  for (; c < nc; ++c) {
    const float lv = l[c * step];
    l[c * step] = S;
    S = expf(d[c * dstep]) * S + lv;
  }
  sT[bh * N * N + e] = S;
}

// Threads of a stage-3 block: the bf16 kernel's phases are short and
// latency-bound, so it runs 16 warps; the f32 kernel's 4 x 4 FFMA tiles fit 8.
template <typename T>
__host__ __device__ constexpr int outputs_threads() { return Lay<T>::kBf ? 512 : kThreads; }

// Stage 3.  Grid as stage 1.  y[t, i] = sum_s scores[t, s] v[s, i] +
// sum_j r[t, j] exp(log decay before t) S_in[j, i].
template <typename T>
__global__ void __launch_bounds__(outputs_threads<T>(), 2)
rwkv_outputs(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ w, const float* __restrict__ u,
             const float* __restrict__ Sin, T* __restrict__ y, int T_len, int H, int N) {
  using Ly = Lay<T>;
  constexpr int nop = Ly::kBf ? 2 : 1;
  constexpr int NT = outputs_threads<T>(), NW = NT / 32;
  constexpr int kMaxS = 128 * kTileP / NT;  // S_in values a thread splits
  extern __shared__ __align__(16) unsigned char smem[];
  const int wn = Ly::width(N), ldn = Ly::ld(N), ldp = Ly::ld(kTileP);
  const int ldw = Lay<float>::ld(N);
  float* bs = reinterpret_cast<float*>(smem);       // [kChunk][ldw] w, then b
  float* us = bs + kChunk * ldw;                       // [N] u
  float* Fx = us + round_up(N, 4);  // [3][wn] exp(cg1), exp(cg2), exp(cg1 + cg2)
  T* rs = reinterpret_cast<T*>(Fx + 3 * wn);  // [kChunk][ldn]
  T* ks = rs + kChunk * ldn;                           // [kChunk][ldn]
  T* vs = ks + kChunk * ldn;                           // [kChunk][ldp]
  unsigned char* sreg = reinterpret_cast<unsigned char*>(vs + kChunk * ldp);
  float* Sst = reinterpret_cast<float*>(sreg);  // [wn][kLdSt] S_in as loaded
  T* Sop = reinterpret_cast<T*>(sreg);          // nop x [wn][ldp] (f32: Sst itself)
  T* X = reinterpret_cast<T*>(sreg + s_region<T>(N));  // nop x [kXRows][ldn]: the cross
                                                       // factors, then decayed r
  T* Y = X + nop * kXRows * ldn;                       // nop x [kChunk][ldp] scores
  const size_t xo = static_cast<size_t>(kXRows) * ldn, yo = static_cast<size_t>(kChunk) * ldp;
  const size_t so = static_cast<size_t>(wn) * ldp;

  const int nti = (N + kTileP - 1) / kTileP;
  const int c = blockIdx.x / nti, i0 = (blockIdx.x % nti) * kTileP;
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x / 32;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // f32 4 x 4 tiles
  const int nc = (T_len + kChunk - 1) / kChunk;
  const int tl = min(kChunk, T_len - c * kChunk);
  const int Ns = round_up(N, 4), il = min(kTileP, N - i0), iw = min(kTileP, Ns - i0);
  constexpr int E = 16 / sizeof(T);
  const size_t ts = static_cast<size_t>(H) * N;
  const size_t base =
      (static_cast<size_t>(b) * T_len + c * kChunk) * ts + static_cast<size_t>(h) * N;

  load_tile<float, NT>(bs, ldw, w + base, ts, kChunk, Lay<float>::width(N), tl, N, N % 4 == 0);
  load_tile<T, NT>(rs, ldn, r + base, ts, kChunk, wn, tl, N, N % E == 0);
  load_tile<T, NT>(ks, ldn, k + base, ts, kChunk, wn, tl, N, N % E == 0);
  load_tile<T, NT>(vs, ldp, v + base + i0, ts, kChunk, kTileP, tl, il, N % E == 0);
  for (int j = threadIdx.x; j < N; j += NT) cp_async4(us + j, u + h * N + j, 4);
  cp_async_commit();
  // S_in in its own group: in flight through the scan and the pair scores
  load_tile<float, NT>(Sst, kLdSt, Sin + ((static_cast<size_t>(b) * nc + c) * H + h) * N * Ns + i0,
            static_cast<size_t>(Ns), wn, kTileP, N, iw, true);
  cp_async_commit();
  cp_async_wait1();
  __syncthreads();
  log_decay_cumsum<NW>(bs, ldw, N, tl);
  __syncthreads();

  // -- scores inside each sub-chunk: the kPairs pairs s <= t of each, four
  //    lanes a pair (exact pair decays, the u bonus at s == t); 0 above the
  //    diagonal and right of the sub-chunk -----------------------------------
  constexpr int kPairs = kSub * (kSub + 1) / 2;
  const int jq = (N + 3) / 4;  // each pair's channels in four quarters, one lane each
  for (int e = threadIdx.x; e < (kChunk / kSub) * kPairs * 4; e += NT) {
    const int g = e / (4 * kPairs), q = (e / 4) % kPairs;
    const int j0 = (e & 3) * jq, j1 = min(N, j0 + jq);
    // the triangle as kSub / 2 rows of kSub + 1: row k holds tt = k (ss <= k)
    // and then tt = kSub - 1 - k (ss < kSub - k)
    const int k = q / (kSub + 1), cq = q % (kSub + 1);
    const int tt = cq <= k ? k : kSub - 1 - k, ss = cq <= k ? cq : cq - k - 1;
    const int t = g * kSub + tt, s = g * kSub + ss;
    const T* rt = rs + t * ldn;
    const T* ksr = ks + s * ldn;
    float acc = 0.f, acc1 = 0.f;  // two independent chains: j and j + 1
    if (s < t) {
      const float* bt = bs + (t - 1) * ldw;
      const float* bsr = bs + s * ldw;
      int j = j0;
      for (; j + 1 < j1; j += 2) {
        acc += to_f32(rt[j]) * to_f32(ksr[j]) * __expf(clip(bt[j] - bsr[j]));
        acc1 += to_f32(rt[j + 1]) * to_f32(ksr[j + 1]) * __expf(clip(bt[j + 1] - bsr[j + 1]));
      }
      if (j < j1) acc += to_f32(rt[j]) * to_f32(ksr[j]) * __expf(clip(bt[j] - bsr[j]));
    } else {
      int j = j0;
      for (; j + 1 < j1; j += 2) {
        acc += to_f32(rt[j]) * us[j] * to_f32(ksr[j]);
        acc1 += to_f32(rt[j + 1]) * us[j + 1] * to_f32(ksr[j + 1]);
      }
      if (j < j1) acc += to_f32(rt[j]) * us[j] * to_f32(ksr[j]);
    }
    acc += acc1;
    // the four quarters sit on four neighbouring lanes (every warp is whole)
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if ((e & 3) == 0) put<T>(Y + t * ldp + s, yo, acc);
  }
  for (int e = threadIdx.x; e < kChunk * kChunk; e += NT) {
    const int t = e / kChunk, s = e % kChunk;
    if (s > t && s >= t / kSub * kSub) put<T>(Y + t * ldp + s, yo, 0.f);
  }

  // -- scores across sub-chunks: for t in sub-chunk g and s in an earlier
  //    sub-chunk gs, (r_t exp(ble_t)) . (k_s exp(cg[gs] - bl_s) F), where F =
  //    exp(sum_{gs < g' < g} cg[g']) per channel (1 for neighbours) scales the
  //    B fragments in registers.  X rows [0, 48): the t factors of sub-chunks
  //    1-3; rows [48, 96): the s factors of sub-chunks 0-2 -------------------
  constexpr int kRowsT = kChunk - kSub;
  for (int row = warp; row < kXRows; row += NW) {  // a row a warp
    for (int j = threadIdx.x & 31; j < wn; j += 32) {
      float val = 0.f;
      if (j < N) {
        if (row < kRowsT) {
          const int t = kSub + row;
          val = to_f32(rs[t * ldn + j]) * __expf(clip(ble(bs, ldw, t, j)));
        } else {
          const int s = row - kRowsT;
          val = to_f32(ks[s * ldn + j]) * __expf(clip(decay_after(bs, ldw, s, s / kSub + 1, j)));
        }
      }
      put<T>(X + row * ldn + j, xo, val);
    }
  }
  for (int j = threadIdx.x; j < wn; j += NT) {
    const float c1 = j < N ? bs[(2 * kSub - 1) * ldw + j] : 0.f;
    const float c2 = j < N ? bs[(3 * kSub - 1) * ldw + j] : 0.f;
    Fx[j] = __expf(clip(c1));
    Fx[wn + j] = __expf(clip(c2));
    Fx[2 * wn + j] = __expf(clip(c1 + c2));
  }
  __syncthreads();
  // (g, gs) pairs: (1, 0) (2, 0) (2, 1) (3, 0) (3, 1) (3, 2), two 8-column
  // halves of gs each; F: none for neighbours, else Fx[0] (0, 2), Fx[1]
  // (1, 3), Fx[2] (0, 3)
  auto pair_of = [](int p, int& g, int& gs) {
    g = p < 1 ? 1 : (p < 3 ? 2 : 3);
    gs = p - (g * (g - 1)) / 2;
  };
  const T* Kf = X + kRowsT * ldn;  // the s factors
  if constexpr (Ly::kBf) {
    const int q4 = threadIdx.x & 3;
    for (int tile = warp; tile < 12; tile += NW) {
      int g, gs;
      pair_of(tile >> 1, g, gs);
      const int fi = g - gs == 1 ? -1 : (g - gs == 3 ? 2 : gs);
      const int n0 = gs * kSub + (tile & 1) * 8;  // row of the s factors
      const T* At = X + (g - 1) * kSub * ldn;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < wn; k0 += 16) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        frag_a(ah, At, ldn, 0, k0);
        frag_a(al, At + xo, ldn, 0, k0);
        frag_b(bh, Kf, ldn, k0, n0);
        frag_b(bl, Kf + xo, ldn, k0, n0);
        if (fi >= 0) {  // b[0]: channels k0 + 2 q4 (+1); b[1]: + 8
          const float* f = Fx + fi * wn + k0 + 2 * q4;
          rescale(bh[0], bl[0], f[0], f[1]);
          rescale(bh[1], bl[1], f[8], f[9]);
        }
        mma(acc, ah, bh);
        mma(acc, ah, bl);
        mma(acc, al, bh);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        put<T>(Y + (g * kSub + acc_row(q)) * ldp + n0 + acc_col(q), yo, acc[q]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < 6 * kSub * kSub; e += NT) {
      int g, gs;
      pair_of(e / (kSub * kSub), g, gs);
      const int fi = g - gs == 1 ? -1 : (g - gs == 3 ? 2 : gs);
      const int row = (e / kSub) % kSub, col = e % kSub;
      const T* at = X + ((g - 1) * kSub + row) * ldn;
      const T* kf = Kf + (gs * kSub + col) * ldn;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) {
        acc = fmaf(to_f32(at[j]), to_f32(kf[j]) * (fi >= 0 ? Fx[fi * wn + j] : 1.f), acc);
      }
      put<T>(Y + (g * kSub + row) * ldp + gs * kSub + col, yo, acc);
    }
  }

  // -- decayed r for the state term (over the cross factors), S_in as hi + lo
  float sv[kMaxS];
  if constexpr (Ly::kBf) {
#pragma unroll
    for (int q = 0; q < kMaxS; ++q) {
      const int e = threadIdx.x + q * NT;
      if (e < wn * kTileP) sv[q] = Sst[(e / kTileP) * kLdSt + e % kTileP];
    }
  }
  __syncthreads();  // the last cross product has read X; S_in is read
  for (int t = warp; t < kChunk; t += NW) {  // a row a warp
    for (int j = threadIdx.x & 31; j < wn; j += 32) {
      const float decay = j < N ? cg_sum(bs, ldw, 0, t / kSub, j) + ble(bs, ldw, t, j) : 0.f;
      const float val = j < N ? to_f32(rs[t * ldn + j]) * __expf(decay) : 0.f;
      put<T>(X + t * ldn + j, xo, val);
    }
  }
  if constexpr (Ly::kBf) {
#pragma unroll
    for (int q = 0; q < kMaxS; ++q) {
      const int e = threadIdx.x + q * NT;
      if (e < wn * kTileP) {
        const int n = e / kTileP, p = e % kTileP;
        put<T>(Sop + n * ldp + p, so, sv[q]);
      }
    }
  }
  __syncthreads();

  // -- y = scores v + (decayed r) S_in ------------------------------------------
  T* yh = y + base + i0;
  if constexpr (Ly::kBf) {
    // a warp owns one 16-row tile of t and kNPer 8-column tiles of i, so
    // each A fragment feeds kNPer independent accumulators
    constexpr int kNPer = 32 / NW;
    const int m0 = (warp / (NW / 4)) * 16, nq = (warp % (NW / 4)) * kNPer;
    float acc[kNPer][4] = {};
    for (int k0 = 0; k0 <= m0; k0 += 16) {  // scores are 0 right of t's sub-chunk
      uint32_t ah[4], al[4];
      frag_a(ah, Y, ldp, m0, k0);
      frag_a(al, Y + yo, ldp, m0, k0);
#pragma unroll
      for (int q = 0; q < kNPer; ++q) {
        if ((nq + q) * 8 < il) {
          uint32_t bb[2];
          frag_b_t(bb, vs, ldp, k0, (nq + q) * 8);
          mma(acc[q], ah, bb);
          mma(acc[q], al, bb);
        }
      }
    }
    for (int k0 = 0; k0 < wn; k0 += 16) {
      uint32_t ah[4], al[4];
      frag_a(ah, X, ldn, m0, k0);
      frag_a(al, X + xo, ldn, m0, k0);
#pragma unroll
      for (int q = 0; q < kNPer; ++q) {
        if ((nq + q) * 8 < il) {
          uint32_t bh[2], bl[2];
          frag_b_t(bh, Sop, ldp, k0, (nq + q) * 8);
          frag_b_t(bl, Sop + so, ldp, k0, (nq + q) * 8);
          mma(acc[q], ah, bh);
          mma(acc[q], ah, bl);
          mma(acc[q], al, bh);
        }
      }
    }
    __syncthreads();  // every warp has read the scores: y goes over them
#pragma unroll
    for (int q = 0; q < kNPer; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        Y[(m0 + acc_row(r)) * ldp + (nq + q) * 8 + acc_col(r)] = from_f32<T>(acc[q][r]);
      }
  } else {
    float acc[4][4];
    zero44(acc);
    const float* a[4];
    const float* bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = reinterpret_cast<const float*>(Y) + (ty + 16 * q) * ldp;
      bb[q] = reinterpret_cast<const float*>(vs) + tx + 16 * q;
    }
    ffma44(acc, a, 1, bb, ldp, kChunk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = reinterpret_cast<const float*>(X) + (ty + 16 * q) * ldn;
      bb[q] = Sst + tx + 16 * q;
    }
    ffma44(acc, a, 1, bb, kLdSt, N);
    __syncthreads();  // every thread has read the scores: y goes over them
#pragma unroll
    for (int qi = 0; qi < 4; ++qi)
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) Y[(ty + 16 * qi) * ldp + tx + 16 * qj] = acc[qi][qj];
  }
  __syncthreads();
  store_tile<T, NT>(yh, ts, Y, ldp, tl, il, N % E == 0);
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* y, void* sT, void* L, void* tot, int B, int T_len,
                   int H, int N, cudaStream_t stream) {
  const int nc = (T_len + kChunk - 1) / kChunk;
  const dim3 grid(nc * ((N + kTileP - 1) / kTileP), H, B);
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* wp = static_cast<const float*>(w);
  float* Lp = static_cast<float*>(L);
  float* totp = static_cast<float*>(tot);
  cudaError_t err;
  if (nc > 0) {
    const size_t smem = states_smem<T>(N);
    err = cudaFuncSetAttribute(rwkv_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    rwkv_states<T><<<grid, kThreads, smem, stream>>>(kp, vp, wp, Lp, totp, T_len, H, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  rwkv_pass<<<dim3((N * N + kPassThreads - 1) / kPassThreads, H, B), kPassThreads, 0, stream>>>(
      static_cast<const float*>(s0), Lp, totp, static_cast<float*>(sT), nc, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    const size_t smem = outputs_smem<T>(N);
    err = cudaFuncSetAttribute(rwkv_outputs<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    rwkv_outputs<T><<<grid, outputs_threads<T>(), smem, stream>>>(rp, kp, vp, wp,
                                                       static_cast<const float*>(u), Lp,
                                                       static_cast<T*>(y), T_len, H, N);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Dynamic shared memory of one block of stage 1, 2 or 3 for head size N and
// dtype (0 = float32, 1 = bfloat16).
extern "C" size_t rwkv6_scan_smem_bytes(int N, int dtype, int stage) {
  if (stage == 2) return 0;
  if (dtype == 1) return stage == 1 ? states_smem<bf16>(N) : outputs_smem<bf16>(N);
  return stage == 1 ? states_smem<float>(N) : outputs_smem<float>(N);
}

// dtype (of r, k, v, y): 0 = float32, 1 = bfloat16; w, u, s0, sT are f32.
// L: f32 scratch of B * ceil(T / 64) * H * N * round_up(N, 4) values, tot:
// of B * ceil(T / 64) * H * N (the wrapper allocates both).  N <= 128.
// Launches the three stages (only stage 2 when T = 0) and returns the first
// cudaError_t.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s0, void* y, void* sT, void* L, void* tot,
                          int B, int T_len, int H, int N, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || N < 1 || N > 128 || T_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(launch<float>(r, k, v, w, u, s0, y, sT, L, tot, B, T_len, H, N, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<bf16>(r, k, v, w, u, s0, y, sT, L, tot, B, T_len, H, N, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
