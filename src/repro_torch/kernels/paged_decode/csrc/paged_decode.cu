// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_decode_pallas / _decode_kernel in
// src/repro/kernels/paged_decode/kernel.py: one query token per row, GQA
// attention over a paged KV pool [P, page, KV, hd], online softmax in f32,
// tokens at or past lens[b] masked, lens[b] == 0 gives zeros, scale
// 1/sqrt(hd) passed in by the caller.
//
// What bounds it on the card: HBM bytes.  Every (row, kv head) must stream
// lens[b] tokens of K and V once: sum_b lens[b] * KV * hd * 2 * sizeof(T)
// bytes at 3.35 TB/s.  The arithmetic is 4 * qpk * hd FLOPs per token per kv
// head, about 2 FLOPs per byte in bf16 -- two orders of magnitude under the
// card's ridge point -- so nothing is gained from tensor cores here.
//
// What the design does about it:
//
// * One block per (kv head, row, page range).  The qpk query heads that
//   share the kv head are all served by the block, so each K/V page crosses
//   HBM once per group; the block reads block_tables[b, p] itself (the TPU
//   kernel's scalar prefetch).  Pages past lens[b] are never read, nor are
//   the dead tokens of the last page.
// * Batch invariance.  A row's pages split into ranges of a constant
//   pages_per_split (the wrapper's PAGES_PER_SPLIT), so a row's split count,
//   and with it every sum the row's output is made of, depends on its own
//   length only, never on its neighbours: grid.z covers the longest row the
//   block table allows, and blocks past a row's own ranges return at once.
//   A row of one range writes its normalised output itself; a row of
//   several writes unnormalised partials (acc, l, m) to f32 scratch, which
//   merge_partials_kernel combines in split order (the log-sum-exp combine
//   of the host kernel's _merge_partials).  So a row's output is bitwise
//   the same in any batch.
// * Pipelined page loads.  Pages arrive in a ring of kStages stages in
//   shared memory, filled with 16-byte cp.async.cg copies (so hd * sizeof(T)
//   must be a multiple of 16 and the pages 16-byte aligned; the wrapper
//   checks): page p + kStages - 1's block-table entry is read and its copy
//   started before page p is computed.  Rows are padded so that
//   consecutive tokens start 64 bytes of banks apart.
// * Parallel scores.  Each (query head, token) score of a page is taken by
//   a team of kLanesPerTok = 4 lanes, each over a quarter of hd in 16-byte
//   slices, and a 2-step shuffle; every team of the block works at once.
// * The whole block works.  For P.V every thread owns one 16-byte slice of
//   one head's output over a subset of the page's tokens (t = j mod ts), so
//   a small group (qwen3: qpk = 2, 16 slices per head) still keeps all 128
//   threads busy; the ts partial sums are added in order at the end.
// (m, l) live in shared memory per head, updated once per page by one warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 3;       // pages in flight per block
constexpr int kLanesPerTok = 4;  // lanes that score one (head, token) pair
constexpr int kMinThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// 16 bytes of shared memory as floats.
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Elements per staged token row: hd, padded so that the row is 16 words
// (64 bytes of banks) past a multiple of 32 words; two teams of a
// quarter-warp then read two tokens' slices from disjoint banks.
template <typename T>
__host__ __device__ __forceinline__ int row_ld(int hd) {
  const int words = hd * static_cast<int>(sizeof(T)) / 4;
  const int pad = ((16 - words % 32) + 32) % 32;
  return hd + pad * 4 / static_cast<int>(sizeof(T));
}

// Threads per block and token subsets of the P.V split (see the header).
__host__ __device__ __forceinline__ int pv_subsets(int n_items) {
  return n_items >= kMinThreads ? 1 : kMinThreads / n_items;
}
__host__ __device__ __forceinline__ int block_threads(int n_items) {
  const int t = n_items * pv_subsets(n_items);
  return t < kMinThreads ? kMinThreads : (t + 31) / 32 * 32;
}

template <typename T>
size_t smem_size(int hd, int page, int qpk) {
  const int vec = 16 / static_cast<int>(sizeof(T));
  const int threads = block_threads(qpk * (hd / vec));
  return static_cast<size_t>(kStages) * 2 * page * row_ld<T>(hd) * sizeof(T) +
         sizeof(float) * (static_cast<size_t>(qpk) * hd + static_cast<size_t>(qpk) * page +
                          3 * qpk + static_cast<size_t>(threads) * vec);
}

// part: [B, KV, gridDim.z, qpk, hd + 2] f32 (acc, then l and m) for rows of
// more than one range.  page <= 32 (lane t of a warp keeps token t's score).
template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ block_tables,
                                    const int* __restrict__ lens,
                                    T* __restrict__ out,
                                    float* __restrict__ part,
                                    int H, int KV, int hd, int page,
                                    int max_pages, int pages_per_split,
                                    float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_ld<T>(hd);
  const int qpk = H / KV;
  const int nch = hd / V;  // slices per token row
  T* ring = reinterpret_cast<T*>(smem_raw);                                // [kStages][2][page][ld]
  float* q_s = reinterpret_cast<float*>(ring + kStages * 2 * page * ld);  // [qpk][hd]
  float* p_s = q_s + qpk * hd;       // [qpk][page]: scores, then probabilities
  float* stat_s = p_s + qpk * page;  // [3][qpk]: corr, m, l
  float* red_s = stat_s + 3 * qpk;   // [blockDim.x][V]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = lens[b];
  const int n_pages = min((len + page - 1) / page, max_pages);
  const int n_split = (n_pages + pages_per_split - 1) / pages_per_split;
  const size_t q_off = (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * qpk) * hd;
  if (n_split == 0) {  // lens 0: zeros
    if (split == 0) {
      for (int i = tid; i < qpk * hd; i += blockDim.x) store(0.f, &out[q_off + i]);
    }
    return;
  }
  if (split >= n_split) return;
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_pages);
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages;
  const size_t tok_stride = static_cast<size_t>(KV) * hd;

  // start the copy of page p's live tokens into ring stage `stage`
  auto issue = [&](int p, int stage) {
    const int pid = bt[p];
    const int ntok = min(page, len - p * page);
    const size_t base = static_cast<size_t>(pid) * page * tok_stride + static_cast<size_t>(kvh) * hd;
    T* ks = ring + stage * 2 * page * ld;
    T* vs = ks + page * ld;
    for (int idx = tid; idx < ntok * nch; idx += blockDim.x) {
      const int t = idx / nch;
      const int c = idx - t * nch;
      const size_t g = base + t * tok_stride + c * V;
      cp_async16(ks + t * ld + c * V, k_pages + g);
      cp_async16(vs + t * ld + c * V, v_pages + g);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (p_begin + s < p_end) issue(p_begin + s, s);
    cp_async_commit();
  }

  for (int i = tid; i < qpk * hd; i += blockDim.x) q_s[i] = to_f32(q[q_off + i]);
  for (int h = tid; h < qpk; h += blockDim.x) {
    stat_s[qpk + h] = kNegInf;
    stat_s[2 * qpk + h] = 0.f;
  }

  const int team = tid / kLanesPerTok;
  const int tl = tid % kLanesPerTok;
  const int n_teams = blockDim.x / kLanesPerTok;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  // P.V ownership: token subset j, head oh, slice oc
  const int n_items = qpk * nch;
  const int ts = pv_subsets(n_items);
  const bool owner = tid < ts * n_items;
  const int j = tid / n_items;
  const int rem = tid - j * n_items;
  const int oh = rem / nch;
  const int oc = rem - oh * nch;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;

  for (int p = p_begin, i = 0; p < p_end; ++p, ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // page p has landed; page p - 1's stage is free again
    if (p + kStages - 1 < p_end) issue(p + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const T* ks = ring + (i % kStages) * 2 * page * ld;
    const T* vs = ks + page * ld;
    const int ntok = min(page, len - p * page);

    // 1. scores: one team of 4 lanes per (head, token)
    const int pairs = qpk * ntok;
    for (int base = 0; base < pairs; base += n_teams) {
      const int pr = base + team;
      const bool live = pr < pairs;
      const int h = live ? pr / ntok : 0;
      const int t = live ? pr - h * ntok : 0;
      float dot = 0.f;
      if (live) {
        for (int c = tl; c < nch; c += kLanesPerTok) {
          float kf[V];
          load_vec(ks + t * ld + c * V, kf);
          const float* qv = q_s + h * hd + c * V;
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qv[e] * kf[e];
        }
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      if (live && tl == 0) p_s[h * page + t] = dot * scale;
    }
    __syncthreads();

    // 2. online softmax over the page, one warp per head
    for (int h = warp; h < qpk; h += n_warps) {
      const float s = lane < ntok ? p_s[h * page + lane] : kNegInf;
      const float m_old = stat_s[qpk + h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = lane < ntok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(pr);
      if (lane < page) p_s[h * page + lane] = pr;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        stat_s[h] = corr;
        stat_s[qpk + h] = m_new;
        stat_s[2 * qpk + h] = stat_s[2 * qpk + h] * corr + sum;
      }
    }
    __syncthreads();

    // 3. P.V: this thread's slice over tokens j, j + ts, ...
    if (owner) {
      const float corr = stat_s[oh];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] *= corr;
      for (int t = j; t < ntok; t += ts) {
        const float pt = p_s[oh * page + t];
        float vf[V];
        load_vec(vs + t * ld + oc * V, vf);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += pt * vf[e];
      }
    }
  }
  cp_async_wait<0>();

  // add the ts token subsets in order, then write
  if (owner) {
#pragma unroll
    for (int e = 0; e < V; ++e) red_s[tid * V + e] = acc[e];
  }
  __syncthreads();
  if (!owner || j != 0) return;
  for (int jj = 1; jj < ts; ++jj) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += red_s[(jj * n_items + rem) * V + e];
  }
  const float l = stat_s[2 * qpk + oh];
  const int d0 = oc * V;
  if (n_split == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + q_off + static_cast<size_t>(oh) * hd + d0;
#pragma unroll
    for (int e = 0; e < V; ++e) store(acc[e] * inv, &o[e]);
    return;
  }
  float* dst = part + ((((static_cast<size_t>(b) * KV + kvh) * gridDim.z + split) * qpk + oh)
                       * (hd + 2));
#pragma unroll
  for (int e = 0; e < V; ++e) dst[d0 + e] = acc[e];
  if (oc == 0) {
    dst[hd] = l;
    dst[hd + 1] = stat_s[qpk + oh];
  }
}

// Merge the partials of each row of more than one range, in split order;
// rows of one range were written by the attention kernel.  n_slots is the
// attention kernel's grid.z (the partials' stride).
template <typename T>
__global__ void merge_partials_kernel(const float* __restrict__ part,
                                      const int* __restrict__ lens,
                                      T* __restrict__ out, int H, int KV,
                                      int hd, int page, int max_pages,
                                      int pages_per_split, int n_slots) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lens[b];
  const int n_pages = min((len + page - 1) / page, max_pages);
  const int n_split = (n_pages + pages_per_split - 1) / pages_per_split;
  if (n_split <= 1) return;
  const int qpk = H / KV;
  const size_t stride = static_cast<size_t>(qpk) * (hd + 2);  // one split
  for (int idx = threadIdx.x; idx < qpk * hd; idx += blockDim.x) {
    const int h = idx / hd;
    const int d = idx - h * hd;
    const float* src = part + ((static_cast<size_t>(b) * KV + kvh) * n_slots * qpk + h)
                       * (hd + 2);
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, src[s * stride + hd + 1]);
    float den = 0.f, num = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(src[s * stride + hd + 1] - m);
      den += src[s * stride + hd] * w;
      num += src[s * stride + d] * w;
    }
    store(num * (1.f / fmaxf(den, 1e-30f)),
          &out[(static_cast<size_t>(b) * H + kvh * qpk + h) * hd + d]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lens, void* out,
                   void* part, int B, int H, int KV, int hd, int page,
                   int max_pages, int pages_per_split, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (hd % V != 0 || page < 1 || page > 32 || KV < 1 || H % KV != 0 ||
      pages_per_split < 1) {
    return cudaErrorInvalidValue;
  }
  const int qpk = H / KV;
  const int n_items = qpk * (hd / V);
  const int threads = block_threads(n_items);
  if (threads > 1024) return cudaErrorInvalidValue;
  const int n_slots = max(1, (max_pages + pages_per_split - 1) / pages_per_split);
  if (n_slots > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_size<T>(hd, page, qpk);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int* ln = static_cast<const int*>(lens);
  T* op = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  paged_decode_kernel<T><<<dim3(KV, B, n_slots), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(block_tables), ln, op, pp, H, KV, hd, page, max_pages,
      pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slots == 1) return err;
  merge_partials_kernel<T><<<dim3(KV, B), kMinThreads, 0, stream>>>(
      pp, ln, op, H, KV, hd, page, max_pages, pages_per_split, n_slots);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one attention block, in bytes (dtype: 0 =
// float32, 1 = bfloat16); the wrapper checks it against the opt-in limit.
extern "C" int paged_decode_smem_bytes(int hd, int page, int qpk, int dtype) {
  return static_cast<int>(dtype == 0 ? smem_size<float>(hd, page, qpk)
                                     : smem_size<__nv_bfloat16>(hd, page, qpk));
}

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch of
// B * KV * ceil(max_pages / pages_per_split) * (H / KV) * (hd + 2) floats
// when max_pages > pages_per_split.  Launches paged_decode_kernel, then
// merge_partials_kernel when the block table holds more than one range.
// Returns the cudaError_t of the launches.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            const void* lens, void* out, void* part, int B,
                            int H, int KV, int hd, int page, int max_pages,
                            int pages_per_split, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k_pages, v_pages, block_tables, lens, out, part,
                                          B, H, KV, hd, page, max_pages, pages_per_split,
                                          scale, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lens, out,
                                                  part, B, H, KV, hd, page, max_pages,
                                                  pages_per_split, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
