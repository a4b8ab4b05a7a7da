// Paged decode attention over the token-major KV cache, CUDA C++ for
// sm_90a.
//
// Replaces the Pallas TPU kernel _decode_kernel_ragged
// (aphrodite_tpu/ops/pallas/paged_attention.py:565, launched through
// paged_decode_attention :1019) (K1): one query token per sequence,
// GQA, optional ALiBi, online softmax over the sequence's pages, and
// the optional fused write of the current token's K/V at position
// ctx-1 into its page.
//
// What bounds it on an H100: bytes. Each sequence's K and V, Σctx ·
// Hkv · d · 2 (K and V) · 2 bytes in bf16, are read once; the
// arithmetic is 4 · Hq · d flops per cached token, far under the card's
// ratio of operations to bytes.
//
// What the design does about it:
// - Grid (batch, Hkv): one block per (sequence, kv head) serves that
//   head's `group` query rows, so every K/V byte staged in shared memory
//   is used by all rows of the group (4 at Mistral-7B geometry) and read
//   from device memory once.
// - A Hopper block cannot carry a running sum to another block, so the
//   loop over the sequence's pages inside the block takes the place of
//   the TPU kernel's sequential chunk grid; the online-softmax state
//   (running max m, sum l, accumulator) lives in registers. The TPU
//   kernel's ragged work list is a grid device and has no counterpart.
// - Each page's K and V slab for the head, [page_size, d] at row stride
//   Hkv·d, is staged in shared memory with 16-byte loads, neighbouring
//   threads on neighbouring addresses.
// - One warp per query row: lanes split head_dim, a warp reduction gives
//   each score, and P·V accumulates in float32 registers. Scores ride the
//   base-2 domain (log2 e folded into the scale), the plain multiply
//   replaces the TPU kernel's exponent-add rescale (AMLA).
// - Fused write: the block first stores knew/vnew[b, h] into slot ctx-1
//   (page table[(ctx-1)/page_size]), then __syncthreads(), then attends.
//   Pages are sequence-exclusive and head lanes disjoint, so no other
//   block touches those bytes.
// - Rows with ctx 0 write zeros.
// This first version is simple: no cp.async double buffering, no wgmma,
// and no split of long sequences over several blocks (small batches
// leave SMs idle).
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerWarp = 4;   // group <= 16
constexpr int kMaxLaneElems = 8;     // head_dim <= 256
constexpr float kNegBig = -1.0e30f;  // finite: no inf - inf NaNs
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    T* __restrict__ out,                    // [B, Hq, d]
    const T* __restrict__ q,                // [B, Hq, d]
    T* k_pages,                             // [P, S, Hkv*d] (fused write)
    T* v_pages,
    const int* __restrict__ block_tables,   // [B, pages_per_seq]
    const int* __restrict__ context_lens,   // [B]
    const float* __restrict__ alibi,        // [Hq] or null
    const T* __restrict__ knew,             // [B, Hkv, d] or null
    const T* __restrict__ vnew,
    int num_kv_heads, int group, int head_dim, int num_pages,
    int page_size, int pages_per_seq, float qk_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = head_dim;
  T* k_tile = reinterpret_cast<T*>(smem);               // [S, d]
  T* v_tile = k_tile + page_size * d;                   // [S, d]
  float* q_s = reinterpret_cast<float*>(v_tile + page_size * d);  // [G, d]
  float* s_s = q_s + group * d;                         // [G, S]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t hd = static_cast<int64_t>(num_kv_heads) * d;
  const int num_q_heads = num_kv_heads * group;
  const int ctx = context_lens[b];
  const int* table = block_tables + static_cast<int64_t>(b) * pages_per_seq;

  auto page_at = [&](int idx) {
    int page = table[idx];
    return page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
  };

  // Fused write of this token's K/V (position ctx-1) for head h.
  if (knew != nullptr && ctx > 0) {
    const int pos = ctx - 1;
    const int64_t row = (static_cast<int64_t>(page_at(pos / page_size)) *
                             page_size + pos % page_size) * hd +
                        static_cast<int64_t>(h) * d;
    const int64_t src = (static_cast<int64_t>(b) * num_kv_heads + h) * d;
    for (int i = tid; i < d; i += kThreads) {
      k_pages[row + i] = knew[src + i];
      v_pages[row + i] = vnew[src + i];
    }
  }
  // The group's query rows, scaled into the base-2 score domain.
  const int64_t q_base = (static_cast<int64_t>(b) * num_q_heads +
                          static_cast<int64_t>(h) * group) * d;
  for (int i = tid; i < group * d; i += kThreads)
    q_s[i] = to_f(q[q_base + i]) * qk_scale;
  __syncthreads();

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][kMaxLaneElems];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e) acc[r][e] = 0.f;
  }

  int n_pages = (ctx + page_size - 1) / page_size;
  n_pages = n_pages < pages_per_seq ? n_pages : pages_per_seq;
  const int vecs_per_row = d * static_cast<int>(sizeof(T)) / 16;
  const int elems_per_vec = 16 / static_cast<int>(sizeof(T));

  for (int p = 0; p < n_pages; ++p) {
    // Stage this head's [S, d] K and V slabs of the page.
    const int64_t page_off =
        static_cast<int64_t>(page_at(p)) * page_size * hd +
        static_cast<int64_t>(h) * d;
    for (int i = tid; i < page_size * vecs_per_row; i += kThreads) {
      const int r = i / vecs_per_row;
      const int c = i % vecs_per_row;
      const int64_t g_off = page_off + r * hd + c * elems_per_vec;
      reinterpret_cast<uint4*>(k_tile)[i] =
          *reinterpret_cast<const uint4*>(k_pages + g_off);
      reinterpret_cast<uint4*>(v_tile)[i] =
          *reinterpret_cast<const uint4*>(v_pages + g_off);
    }
    __syncthreads();

    const int base = p * page_size;
    const int valid = min(page_size, ctx - base);
#pragma unroll
    for (int r = 0; r < kMaxRowsPerWarp; ++r) {
      const int g = warp + r * kWarps;
      if (g >= group) break;
      const float* qg = q_s + g * d;
      const float slope =
          alibi != nullptr ? alibi[h * group + g] * kLog2e : 0.f;
      float m_page = kNegBig;
      for (int t = 0; t < valid; ++t) {
        const T* kt = k_tile + t * d;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kMaxLaneElems; ++e) {
          const int j = lane + 32 * e;
          if (j < d) part += qg[j] * to_f(kt[j]);
        }
        const float s = warp_sum(part) + slope * static_cast<float>(base + t);
        if (lane == 0) s_s[g * page_size + t] = s;
        m_page = fmaxf(m_page, s);
      }
      __syncwarp();
      const float m_new = fmaxf(m[r], m_page);
      const float corr = exp2f(m[r] - m_new);
      float l_page = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxLaneElems; ++e) acc[r][e] *= corr;
      for (int t = 0; t < valid; ++t) {
        const float pt = exp2f(s_s[g * page_size + t] - m_new);
        l_page += pt;
        const T* vt = v_tile + t * d;
#pragma unroll
        for (int e = 0; e < kMaxLaneElems; ++e) {
          const int j = lane + 32 * e;
          if (j < d) acc[r][e] += pt * to_f(vt[j]);
        }
      }
      l[r] = l[r] * corr + l_page;
      m[r] = m_new;
    }
    __syncthreads();   // the next page's staging overwrites the tiles
  }

#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    const int g = warp + r * kWarps;
    if (g >= group) break;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* o = out + q_base + static_cast<int64_t>(g) * d;
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e) {
      const int j = lane + 32 * e;
      if (j < d) store_f(o + j, acc[r][e] * inv);
    }
  }
}

template <typename T>
int launch(void* out, const void* q, void* k_pages, void* v_pages,
           const int* block_tables, const int* context_lens,
           const float* alibi, const void* knew, const void* vnew,
           int batch, int num_kv_heads, int group, int head_dim,
           int num_pages, int page_size, int pages_per_seq, float qk_scale,
           cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(page_size) * head_dim *
                          sizeof(T) +
                      static_cast<size_t>(group) * (head_dim + page_size) *
                          sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0) {
    dim3 grid(batch, num_kv_heads);
    paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<T*>(out), static_cast<const T*>(q),
        static_cast<T*>(k_pages), static_cast<T*>(v_pages), block_tables,
        context_lens, alibi, static_cast<const T*>(knew),
        static_cast<const T*>(vnew), num_kv_heads, group, head_dim,
        num_pages, page_size, pages_per_seq, qk_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages, knew/vnew and out alike).
extern "C" int paged_decode_attention(
    void* out, const void* q, void* k_pages, void* v_pages,
    const int* block_tables, const int* context_lens, const float* alibi,
    const void* knew, const void* vnew, int batch, int num_kv_heads,
    int group, int head_dim, int num_pages, int page_size,
    int pages_per_seq, float qk_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kWarps * kMaxRowsPerWarp ||
      head_dim > 32 * kMaxLaneElems)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(out, q, k_pages, v_pages, block_tables,
                         context_lens, alibi, knew, vnew, batch,
                         num_kv_heads, group, head_dim, num_pages,
                         page_size, pages_per_seq, qk_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, q, k_pages, v_pages, block_tables,
                                 context_lens, alibi, knew, vnew, batch,
                                 num_kv_heads, group, head_dim, num_pages,
                                 page_size, pages_per_seq, qk_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
