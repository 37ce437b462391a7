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
// What the design does about it: one block per (kv head, row, split).  The
// qpk query heads that share the kv head are the block's first qpk warps,
// so each K/V page crosses HBM once per group, not once per query head; the
// block reads block_tables[b, p] itself (the TPU kernel's scalar prefetch)
// and stages one page of K and V in shared memory with 16-byte loads (so
// hd * sizeof(T) must be a multiple of 16; the wrapper checks).  Pages past
// lens[b] are never read, nor are the dead tokens of the last page.
// (m, l, acc) stay in registers in f32; scores are warp-shuffle reductions.
// Lane l owns head dims l, l+32, ..., so any such hd <= 256 and any
// qpk <= 32 work without the TPU wrapper's padding (hd = 112 and qpk = 7
// included).
//
// Split over pages: a decode step has few rows, and B * KV blocks alone
// leave most of the 132 SMs idle while each block walks its pages one after
// another.  The caller splits every row's pages into n_split contiguous
// ranges (grid.z); with n_split > 1 each block writes its unnormalised
// partial (acc, l, m) to f32 scratch and a second kernel merges the
// partials with the log-sum-exp combine of the host kernel's
// _merge_partials.  Not yet done: cp.async double buffering of the next
// page, and using the idle warps of small groups (qpk < 4) for compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

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

// CH: head dims per lane (hd <= 32 * CH).  Requires hd * sizeof(T) % 16 == 0
// and 16-byte aligned k/v pages (pages are staged with 16-byte loads),
// page <= 32 (lane t keeps token t's score) and blockDim.x == 32 * max(qpk, 4).  part: [B, KV, n_split, qpk, hd + 2] f32
// (acc, then l and m) when gridDim.z > 1, unused otherwise.
template <typename T, int CH>
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [page][hd]
  T* v_s = k_s + page * hd;                 // [page][hd]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int qpk = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = warp < qpk;
  const int h = kvh * qpk + warp;
  const size_t q_off = (static_cast<size_t>(b) * H + h) * hd;

  float qr[CH], acc[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int d = lane + 32 * i;
    qr[i] = (active && d < hd) ? to_f32(q[q_off + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int len = lens[b];
  const int n_pages = min((len + page - 1) / page, max_pages);
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_pages);
  for (int p = p_begin; p < p_end; ++p) {
    const int pid = block_tables[static_cast<size_t>(b) * max_pages + p];
    const int ntok = min(page, len - p * page);
    const size_t base = static_cast<size_t>(pid) * page * KV * hd;
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
    const int per_tok = hd / E;
    for (int idx = threadIdx.x; idx < ntok * per_tok; idx += blockDim.x) {
      const int t = idx / per_tok;
      const int c = idx - t * per_tok;
      const size_t g = base + (static_cast<size_t>(t) * KV + kvh) * hd + c * E;
      reinterpret_cast<uint4*>(k_s)[idx] = *reinterpret_cast<const uint4*>(k_pages + g);
      reinterpret_cast<uint4*>(v_s)[idx] = *reinterpret_cast<const uint4*>(v_pages + g);
    }
    __syncthreads();
    if (active) {
      float s_mine = kNegInf;
      for (int t = 0; t < ntok; ++t) {
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) part_dot += qr[i] * to_f32(k_s[t * hd + d]);
        }
        const float s = warp_sum(part_dot) * scale;
        if (lane == t) s_mine = s;
      }
      const float m_new = fmaxf(m, warp_max(s_mine));
      const float corr = expf(m - m_new);
      const float p_mine = lane < ntok ? expf(s_mine - m_new) : 0.f;
      l = l * corr + warp_sum(p_mine);
#pragma unroll
      for (int i = 0; i < CH; ++i) acc[i] *= corr;
      for (int t = 0; t < ntok; ++t) {
        const float pt = __shfl_sync(kFull, p_mine, t);
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) acc[i] += pt * to_f32(v_s[t * hd + d]);
        }
      }
      m = m_new;
    }
    __syncthreads();  // the next page overwrites k_s / v_s
  }
  if (!active) return;
  if (gridDim.z == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store(acc[i] * inv, &out[q_off + d]);
    }
    return;
  }
  float* dst = part + ((((static_cast<size_t>(b) * KV + kvh) * gridDim.z + split) * qpk + warp)
                       * (hd + 2));
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) dst[d] = acc[i];
  }
  if (lane == 0) {
    dst[hd] = l;
    dst[hd + 1] = m;
  }
}

// Merge the n_split partials of each (row, query head): one warp per head.
template <typename T>
__global__ void merge_partials_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int H, int KV,
                                      int hd, int n_split) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int qpk = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= qpk) return;
  const size_t stride = static_cast<size_t>(qpk) * (hd + 2);  // one split
  const float* src = part + ((static_cast<size_t>(b) * KV + kvh) * n_split * qpk + warp)
                     * (hd + 2);
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, src[s * stride + hd + 1]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    den += src[s * stride + hd] * expf(src[s * stride + hd + 1] - m);
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  T* o = out + (static_cast<size_t>(b) * H + kvh * qpk + warp) * hd;
  for (int d = lane; d < hd; d += 32) {
    float num = 0.f;
    for (int s = 0; s < n_split; ++s) {
      num += src[s * stride + d] * expf(src[s * stride + hd + 1] - m);
    }
    store(num * inv, &o[d]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lens, void* out,
                   void* part, int B, int H, int KV, int hd, int page,
                   int max_pages, int n_split, float scale, cudaStream_t stream) {
  const int qpk = H / KV;
  const int threads = 32 * (qpk > 4 ? qpk : 4);
  const size_t smem = 2 * static_cast<size_t>(page) * hd * sizeof(T);
  const int pages_per_split = (max_pages + n_split - 1) / n_split;
  const dim3 grid(KV, B, n_split);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lens);
  T* op = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  if ((hd * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;  // 16-byte staging
  if (hd <= 32) {
    paged_decode_kernel<T, 1><<<grid, threads, smem, stream>>>(
        qp, kp, vp, bt, ln, op, pp, H, KV, hd, page, max_pages, pages_per_split, scale);
  } else if (hd <= 64) {
    paged_decode_kernel<T, 2><<<grid, threads, smem, stream>>>(
        qp, kp, vp, bt, ln, op, pp, H, KV, hd, page, max_pages, pages_per_split, scale);
  } else if (hd <= 128) {
    paged_decode_kernel<T, 4><<<grid, threads, smem, stream>>>(
        qp, kp, vp, bt, ln, op, pp, H, KV, hd, page, max_pages, pages_per_split, scale);
  } else if (hd <= 256) {
    paged_decode_kernel<T, 8><<<grid, threads, smem, stream>>>(
        qp, kp, vp, bt, ln, op, pp, H, KV, hd, page, max_pages, pages_per_split, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  merge_partials_kernel<T><<<dim3(KV, B), threads, 0, stream>>>(pp, op, H, KV, hd, n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch of
// B * KV * n_split * (H / KV) * (hd + 2) floats when n_split > 1.  Launches
// paged_decode_kernel, then merge_partials_kernel when n_split > 1.  Returns
// the cudaError_t of the launches.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            const void* lens, void* out, void* part, int B,
                            int H, int KV, int hd, int page, int max_pages,
                            int n_split, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(launch<float>(q, k_pages, v_pages, block_tables, lens, out, part,
                                          B, H, KV, hd, page, max_pages, n_split, scale, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lens, out,
                                                  part, B, H, KV, hd, page, max_pages, n_split,
                                                  scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
