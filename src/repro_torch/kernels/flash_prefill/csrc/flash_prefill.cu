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
// Two kernels, routed by dtype.  Both keep the [S, S] scores out of device
// memory, never read a key tile that no query of the block can see (causal
// and window skips), schedule query tiles last-first (the causal tiles with
// the most key tiles start first), zero masked probabilities explicitly
// (exp(s - m) of a row masked so far would be 1) and mask rows and columns
// past S, so any S is taken without padding.
//
// bf16: flash_prefill_tc_kernel, on the tensor cores.  A block serves one
// kv head of one row over one query tile with two consumer warpgroups and
// one producer warp:
// * GQA reuse: the two warpgroups are two query heads of the kv head's
//   group over the same 64 rows (qpk >= 2; a lone head of an odd group
//   leaves its warpgroup idle), or 2 x 64 rows of the one head (qpk = 1),
//   so each K/V tile crosses HBM once per block and serves both.
// * The producer warp keeps a ring of K/V tiles (64 keys x hd) in flight
//   with TMA (cp.async.bulk.tensor from CUtensorMaps built per call on the
//   host, completion on mbarriers; empty barriers hand stages back).  TMA
//   writes each 64-dim chunk of a tile 128-byte swizzled, the layout
//   wgmma's descriptors expect, and fills rows past S (and dims past hd)
//   with zeros.
// * S = QK^T is wgmma m64n64k16 with Q and K from shared memory (K-major,
//   4 k-steps per 64-dim chunk); the online softmax runs on the f32
//   accumulator in the
//   registers that hold it (thread t of a warpgroup owns rows 16 (t / 32) +
//   (t % 32) / 4 + {0, 8}; the row max and sum are 2-step shuffles over the
//   four lanes of a row); P is converted to bf16 in registers, where the
//   accumulator's layout is exactly wgmma's register-A fragment, and
//   O += P V is wgmma m64n64k16 with A from registers and V from shared
//   memory (MN-major, transposed B), one call per 64-dim chunk.  No shared
//   memory round trip for P.
// * Overlap: inside a warpgroup, tile i's S = QK^T is issued first, then
//   the previous tile's O += P V; the warpgroup waits for S only and runs
//   tile i's softmax while that product runs on the tensor cores.  Between
//   the two warpgroups, named barriers make them take turns issuing (FA3's
//   ping-pong), so one's softmax runs under the other's products.  Only
//   tiles that cross the diagonal, the window's edge or S test their
//   entries; exponentials are ex2.approx on the special function unit.
// * hd must be a multiple of 16 (wgmma's k-depth), up to 256.  ptxas gives
//   the block 168 registers a thread (it counts the producer warp as a
//   whole warpgroup): no spills up to hd = 128, the main path's widths;
//   some past it, where O takes 96 or 128 of them.
//
// float32: flash_prefill_kernel, on the CUDA cores in f32 (TF32 tensor
// cores would break the 2e-3 gate against the plain version).  One block
// of 128 threads per (64-row query tile, query head, row); the key/value
// axis, which the TPU grid walks as its sequential fourth dimension, is a
// loop inside the block over 64-row tiles.  The query tile and each K/V tile
// are staged in shared memory with 16-byte loads (so hd * sizeof(T) must be
// a multiple of 16; the wrapper checks), in rows padded by one 32-bit word
// so that the eight columns a warp reads at once fall in eight banks.
// Thread (r, c) of the 16 x 8 grid owns query rows r + 16 i (i < 4), key
// columns c + 8 j (j < 8) of the score tile and head dims c + 8 jj of the
// output; the row max and sum are shuffles over the 8 lanes of a row.  The
// probabilities go through shared memory ([64][65] f32) into P.V.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows per block and key rows per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kPsLd = kTile + 1;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// the CUDA-core kernel runs float32 only (bf16 takes the tensor-core kernel)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }

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


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;                       // query rows per warpgroup, keys per tile
constexpr int kTcChunk = 64;                      // head dims per 128-byte swizzled chunk
constexpr int kTcChunkBytes = kTcRows * kTcChunk * 2;  // one [64][64] bf16 chunk
constexpr int kTcConsumers = 2;                   // consumer warpgroups
constexpr int kTcThreads = kTcConsumers * 128 + 32;  // + one producer warp

// K/V stages of the ring for NCH 64-dim chunks (hd <= 64 NCH).
__host__ __device__ constexpr int tc_stages(int nch) { return nch <= 2 ? 3 : 2; }

__host__ __device__ constexpr size_t tc_smem_size(int nch) {
  // 1024 bytes of alignment slack, the queries of both warpgroups, the K and
  // V rings, then the barriers
  return 1024 + static_cast<size_t>(kTcConsumers + 2 * tc_stages(nch)) * nch * kTcChunkBytes +
         128;
}

// 2^x on the special function unit (2 ulp; 0 for very negative x)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// of more than ~10 s (a lost arrival) traps: the launch fails with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One [64][64] box of a 4-D map (dims innermost first: hd, heads, S, B).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int head, int pos, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(head), "r"(pos),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile (layout 1);
// lbo / sbo in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for the bf16 A fragments a register-A wgmma reads while it runs:
// their registers stay live, and unchanged, up to the wait after it
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool B>
struct EdgeTag {
  static constexpr bool value = B;
};

// NCH: 64-dim chunks of hd (hd <= 64 NCH, hd % 16 == 0).  Grid: x = query
// tiles (last first), y = kv head x head pair, z = row.  The accumulator of
// an m64n64 wgmma: d[4 j + 2 i + c] is row 16 warp + lane / 4 + 8 i, column
// 8 j + 2 (lane % 4) + c.
template <int NCH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        __nv_bfloat16* __restrict__ out, int S, int H, int KV, int hd,
                        int causal, int window, float scale_log2) {
  constexpr int ST = tc_stages(NCH);
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* q_s = base;                                      // [2][NCH][64][64]
  unsigned char* k_s = q_s + kTcConsumers * NCH * kTcChunkBytes;  // [ST][NCH][64][64]
  unsigned char* v_s = k_s + ST * NCH * kTcChunkBytes;            // [ST][NCH][64][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + ST * NCH * kTcChunkBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int qpk = H / KV;
  const int pairs = (qpk + 1) / 2;
  const int kvh = blockIdx.y / pairs;
  const int pair = blockIdx.y - kvh * pairs;
  const int b = blockIdx.z;
  const int block_rows = qpk == 1 ? kTcConsumers * kTcRows : kTcRows;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * block_rows;

  // each consumer warpgroup's query head and first row; live when both exist
  int heads[kTcConsumers], row0s[kTcConsumers];
  bool lives[kTcConsumers];
  int row_lo = S, row_hi = -1;
#pragma unroll
  for (int w = 0; w < kTcConsumers; ++w) {
    heads[w] = qpk == 1 ? kvh : kvh * qpk + 2 * pair + w;
    row0s[w] = qpk == 1 ? q0 + kTcRows * w : q0;
    lives[w] = (qpk == 1 || 2 * pair + w < qpk) && row0s[w] < S;
    if (lives[w]) {
      row_lo = min(row_lo, row0s[w]);
      row_hi = max(row_hi, min(S - 1, row0s[w] + kTcRows - 1));
    }
  }
  // the key tiles some live row of the block sees
  const int k_hi = causal ? row_hi : S - 1;
  const int k_lo = window > 0 ? max(0, row_lo - window + 1) : 0;
  const int t_first = k_lo / kTcRows;
  const int n_tiles = row_hi < 0 ? 0 : k_hi / kTcRows - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kTcConsumers) {
    // ---- producer warp: queries once, then the K/V ring ----
    if (threadIdx.x != kTcConsumers * 128) return;
    unsigned q_bytes = 0;
#pragma unroll
    for (int w = 0; w < kTcConsumers; ++w) q_bytes += lives[w] ? NCH * kTcChunkBytes : 0;
    mbar_expect_tx(q_full, q_bytes);
#pragma unroll
    for (int w = 0; w < kTcConsumers; ++w) {
      if (!lives[w]) continue;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        tma_load(q_s + (w * NCH + c) * kTcChunkBytes, &q_map, q_full, c * kTcChunk, heads[w],
                 row0s[w], b);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      mbar_expect_tx(&full[s], 2 * NCH * kTcChunkBytes);
      const int k0 = (t_first + i) * kTcRows;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        tma_load(k_s + (s * NCH + c) * kTcChunkBytes, &k_map, &full[s], c * kTcChunk, kvh, k0, b);
        tma_load(v_s + (s * NCH + c) * kTcChunkBytes, &v_map, &full[s], c * kTcChunk, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  // Per needed tile i: issue S_i = Q K_i^T, then O += P_{i-1} V_{i-1} (the
  // previous tile's product), wait for S_i only, run tile i's softmax while
  // that product runs, then wait for it, release its stage, rescale O and
  // keep P_i in registers for the next round.
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const bool live = wg == 0 ? lives[0] : lives[1];
  const int h = wg == 0 ? heads[0] : heads[1];
  const int row0 = wg == 0 ? row0s[0] : row0s[1];
  const int row_last = min(S - 1, row0 + kTcRows - 1);
  const int r_a = row0 + 16 * warp + (lane >> 2);  // this thread's rows: r_a, r_a + 8
  const int col_a = 2 * (lane & 3);                // and columns col_a + 8 j + {0, 1}
  const uint32_t q_addr = smem_u32(q_s + wg * NCH * kTcChunkBytes);

  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t pa[4][4];        // P of the previous tile, bf16 A fragments
  if (live) mbar_wait(q_full, 0);

  // the tiles this warpgroup computes: one run [i_lo, i_hi] of the block's.
  // With both warpgroups live they take turns issuing their products
  // (ping-pong: one's softmax runs under the other's wgmma) and so walk the
  // same run, the block's whole range (which is the union of their needs;
  // a tile one of them does not need is all masked there).
  const bool pingpong = lives[0] && lives[1];
  int i_lo = pingpong ? 0 : n_tiles, i_hi = pingpong ? n_tiles - 1 : -1;
  for (int i = 0; live && !pingpong && i < n_tiles; ++i) {
    const int k0 = (t_first + i) * kTcRows;
    if ((!causal || k0 <= row_last) && (window <= 0 || k0 + kTcRows - 1 > row0 - window)) {
      i_lo = min(i_lo, i);
      i_hi = i;
    }
  }
  auto release = [&](int stage) {
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
  };
  auto wait_full = [&](int i) { mbar_wait(&full[i % ST], (i / ST) & 1); };
  // S = Q K^T over 4 NCH k-steps of 16 dims, 32 bytes along a swizzled row
  // each (dims past hd are TMA's zeros in both Q and K: they add nothing,
  // and a fixed step count keeps the wgmma chain branch-free)
  auto issue_qk = [&](float (&sc)[32], int stage) {
    const uint32_t k_addr = smem_u32(k_s + stage * NCH * kTcChunkBytes);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NCH; ++kk) {
      const uint32_t off = (kk >> 2) * kTcChunkBytes + (kk & 3) * 32;
      wgmma_ss(sc, desc_sw128(q_addr + off, 1, 64), desc_sw128(k_addr + off, 1, 64), kk > 0);
    }
    wg_commit();
  };
  // O += P V over the stage's V tile, one 64-dim chunk at a time; V is
  // MN-major, its 8-key groups 1024 bytes apart
  auto issue_pv = [&](int stage) {
    const uint32_t v_addr = smem_u32(v_s + stage * NCH * kTcChunkBytes);
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[c], pa[kk], desc_sw128(v_addr + c * kTcChunkBytes + kk * 2048, 512, 64));
    wg_commit();
    fence_regs(pa);
  };
  // after wg_wait: the product's registers are final, its stage free
  auto pv_done = [&](int stage) {
    fence_regs(pa);
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    release(stage);
  };
  // online softmax (base 2) of tile i on the accumulator's registers, then
  // O's rescale and P as wgmma's A fragments (keys 16 kk .. 16 kk + 15).
  // EDGE (a compile-time tag, so that interior tiles carry no mask code):
  // the tile crosses the diagonal, the window's edge or S, and its masked
  // scores become kNegInf.  Each row exponentiates against a finite base,
  // its running max m (scaled), or 0 while it has no live score; so a
  // masked probability, exp2(kNegInf * scale - base), is exactly +0, and
  // so is corr while m is still kNegInf.  `before_rescale` runs before O is
  // touched (the wait for the previous product, which still reads P and
  // accumulates into O).
  auto softmax = [&](float (&sc)[32], int i, auto edge_tag, auto before_rescale) {
    constexpr bool kEdge = decltype(edge_tag)::value;
    const int k0 = (t_first + i) * kTcRows;
    fence_regs(sc);
    if (kEdge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + col_a + (e & 1);
        const int row = r_a + 8 * ((e >> 1) & 1);
        const bool ok = key < S && (!causal || key <= row) && (window <= 0 || row - key < window);
        sc[e] = ok ? sc[e] : kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};  // the tile's raw row max
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float corr[2], base[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(kFull, mx[ii], 1));
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(kFull, mx[ii], 2));
      const float m_new = fmaxf(m[ii], mx[ii] == kNegInf ? kNegInf : mx[ii] * scale_log2);
      base[ii] = m_new == kNegInf ? 0.f : m_new;
      corr[ii] = fast_exp2(m[ii] - base[ii]);
      m[ii] = m_new;
      l[ii] *= corr[ii];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int ii = (e >> 1) & 1;
      sc[e] = fast_exp2(fmaf(sc[e], scale_log2, -base[ii]));
      l[ii] += sc[e];
    }
    before_rescale();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= corr[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };
  // whether tile i crosses the diagonal, the window's edge or S
  auto is_edge = [&](int i) {
    const int k0 = (t_first + i) * kTcRows;
    return !(k0 + kTcRows <= S && (!causal || k0 + kTcRows - 1 <= row0) &&
             (window <= 0 || row_last - k0 < window));
  };

  for (int i = 0; i < i_lo; ++i) {  // tiles before this warpgroup's run
    wait_full(i);
    release(i % ST);
  }
  // turns: named barrier 1 + w is warpgroup w's; a turn ends by handing
  // the other warpgroup its own (warpgroup 1's last hand-over has no taker)
  auto my_turn = [&]() {
    if (pingpong) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto their_turn = [&](bool last) {
    if (pingpong && !(last && wg == 1)) {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    }
  };
  if (pingpong && wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // 0 starts
  if (i_lo <= i_hi) {
    // the run's first tile has no previous product
    float sc[32];
    wait_full(i_lo);
    my_turn();
    issue_qk(sc, i_lo % ST);
    their_turn(false);
    wg_wait<0>();
    softmax(sc, i_lo, EdgeTag<true>{}, [] {});
    // then S_i = Q K_i^T, the previous tile's O += P V behind it; wait for
    // S_i only and run its softmax while the product runs.  Edge and
    // interior tiles take separate copies of the whole step, so that the
    // mask never costs an interior tile anything.
    auto step = [&](int i, auto edge_tag) {
      wait_full(i);
      my_turn();
      issue_qk(sc, i % ST);
      issue_pv((i - 1) % ST);
      their_turn(false);
      wg_wait<1>();
      softmax(sc, i, edge_tag, [&] {
        wg_wait<0>();
        pv_done((i - 1) % ST);
      });
    };
    for (int i = i_lo + 1; i <= i_hi; ++i) {
      if (is_edge(i)) {
        step(i, EdgeTag<true>{});
      } else {
        step(i, EdgeTag<false>{});
      }
    }
    my_turn();
    issue_pv(i_hi % ST);
    their_turn(true);
    wg_wait<0>();
    pv_done(i_hi % ST);
  }
  for (int i = max(i_hi + 1, i_lo); i < n_tiles; ++i) {  // and after it
    wait_full(i);
    release(i % ST);
  }
  if (!live) return;

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    l[ii] += __shfl_xor_sync(kFull, l[ii], 1);
    l[ii] += __shfl_xor_sync(kFull, l[ii], 2);
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = r_a + 8 * ii;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[ii], 1e-30f);
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * S + row) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = c * kTcChunk + 8 * j + col_a;
        if (d < hd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * ii] * inv, o[c][4 * j + 2 * ii + 1] * inv);
        }
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [B, S, heads, hd] bf16 as a 4-D map of [64 positions][64 dims] boxes,
// 128-byte swizzled; out-of-bounds positions and dims read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kTcChunk, 1, kTcRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH>
cudaError_t launch_tc_nch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                          __nv_bfloat16* out, int B, int S, int H, int KV, int hd, int causal,
                          int window, float scale_log2, cudaStream_t stream) {
  const size_t smem = tc_smem_size(NCH);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_tc_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int qpk = H / KV;
  const int block_rows = qpk == 1 ? kTcConsumers * kTcRows : kTcRows;
  const dim3 grid((S + block_rows - 1) / block_rows, KV * ((qpk + 1) / 2), B);
  flash_prefill_tc_kernel<NCH><<<grid, kTcThreads, smem, stream>>>(
      qm, km, vm, out, S, H, KV, hd, causal, window, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int H, int KV, int hd, int causal, int window, float scale,
                      cudaStream_t stream) {
  if (hd % 16 != 0 || hd > 4 * kTcChunk || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, S, H, hd) || !make_map(&km, k, B, S, KV, hd) ||
      !make_map(&vm, v, B, S, KV, hd)) {
    return cudaErrorInvalidValue;
  }
  auto* op = static_cast<__nv_bfloat16*>(out);
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  switch ((hd + kTcChunk - 1) / kTcChunk) {
    case 1: return launch_tc_nch<1>(qm, km, vm, op, B, S, H, KV, hd, causal, window, sl2, stream);
    case 2: return launch_tc_nch<2>(qm, km, vm, op, B, S, H, KV, hd, causal, window, sl2, stream);
    case 3: return launch_tc_nch<3>(qm, km, vm, op, B, S, H, KV, hd, causal, window, sl2, stream);
    default: return launch_tc_nch<4>(qm, km, vm, op, B, S, H, KV, hd, causal, window, sl2, stream);
  }
}

}  // namespace

// Dynamic shared memory one block takes, in bytes (dtype: 0 = float32 on
// the CUDA-core kernel, 1 = bfloat16 on the tensor-core kernel); the wrapper
// checks it against the card's opt-in limit.
extern "C" int flash_prefill_smem_bytes(int hd, int dtype) {
  if (dtype == 0) return static_cast<int>(smem_size<float>(hd));
  return static_cast<int>(tc_smem_size((hd + kTcChunk - 1) / kTcChunk));
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel;
// hd % 16 == 0).  q [B, S, H, hd], k/v [B, S, KV, hd] and out [B, S, H, hd],
// contiguous and 16-byte aligned.  window <= 0 = none.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for inputs the kernels
// do not take, or when no tensor map can be made).
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
    return static_cast<int>(launch_tc(q, k, v, out, B, S, H, KV, hd, causal, window, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
