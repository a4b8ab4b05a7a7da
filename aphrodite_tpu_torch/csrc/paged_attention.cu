// Paged decode attention over the token-major KV cache, CUDA C++ for
// sm_90a. Two kernels, one per Pallas grid of
// aphrodite_tpu/ops/pallas/paged_attention.py:
//
//   paged_decode_kernel (K1) replaces _decode_kernel_ragged (:565, the
//     ragged work-list grid, launched at :888-896 and :1005);
//   paged_decode_tm_kernel (K5) replaces _decode_kernel_tm (:252, the
//     padded (batch, head-block) grid, launched at :906-920 and :1005).
//
// Both compute, for one query token per sequence: GQA, optional ALiBi,
// the online softmax of the Pallas bodies, and the optional fused write
// of the current token's K/V at position ctx-1 into its page. The
// arithmetic is the Pallas bodies', chunk by chunk:
// - scores ride the base-2 domain: q is scaled by scale * kv_scale *
//   log2(e) (the int8 scale S folds in here) and, on bf16 and 8-bit
//   pages, rounded to bf16, as the TPU's bf16 MXU operands were; f32
//   pages keep f32 throughout (the JAX package's CPU reference);
// - chunks of pages_per_chunk pages; per chunk the running max is
//   max(m, ceil(max s)), an integer, so the rescale 2^(m - m_new) is an
//   exact power of two, applied as an exponent-bias add (AMLA,
//   mul_pow2, which flushes what would underflow to 0) or as a multiply;
// - p = 2^(s - m_new); l sums p in f32, P.V takes p rounded to bf16 on
//   bf16 and 8-bit pages; out = acc * (kv_scale / l).
// int8 and fp8 e5m2 page values convert to bf16 exactly, so they enter
// the dots as stored; the fused write quantizes the injected token
// (int8: rintf(x / S) by IEEE division, clamped to +-127; fp8: round to
// nearest even, no saturation, as the JAX cast).
//
// What bounds them on an H100: bytes. Each sequence's K and V, Σctx ·
// Hkv · d · 2 (K and V) · page bytes, are read once (half as many bytes
// on 8-bit pages); the arithmetic is 4 · Hq · d flops per cached token,
// far under the card's ratio of operations to bytes.
//
// What the designs do about it. A Hopper block cannot carry a running
// sum to another block, so a loop over the sequence's chunks inside the
// block takes the place of the TPU's sequential grid axis; the softmax
// state lives in registers. Within a chunk, pass 1 stages K and writes
// every score to shared memory, the chunk max follows, and pass 2 stages
// V and accumulates: each K and V byte is read from device memory once.
// - K1, grid (batch, Hkv): one block of 4 warps per (sequence, kv head)
//   serves that head's `group` query rows (a warp per row), staging one
//   page's [page_size, d] slab of the head at a time with 16-byte loads.
// - K5, grid (batch, Hkv / hb), hb = head_block(Hkv) <= 8 as the Pallas
//   grid: one block per (sequence, head block) serves group · hb rows
//   (32 at Mistral-7B geometry, one block per sequence). Each token's K
//   row of the head block, hb · d contiguous values (2 KB in bf16), is
//   one 16-byte-vector run: the block stages 16 tokens' rows at a time,
//   and each kv head has its own warp(s), up to 4 query rows a warp.
//   Fewer, wider blocks than K1: at small batch most SMs idle.
// Fused write: the block first stores the (quantized) new K/V of its
// heads into slot ctx-1 (page table[(ctx-1)/page_size]), then
// __syncthreads(), then attends. Pages are sequence-exclusive and head
// lanes disjoint, so no other block touches those bytes. Rows with ctx 0
// write zeros.
// These first versions are simple: no cp.async double buffering, no
// tensor cores, and no split of long sequences over several blocks.
//
// The C entry points launch on the caller's stream, allocate nothing
// and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kMaxLaneElems = 8;     // head_dim <= 256
constexpr float kNegBig = -1073741824.0f;  // -2^30, the Pallas bodies'
constexpr float kLog2e = 1.4426950408889634f;
// K1: 4 warps x 4 rows (group <= 16).
constexpr int kK1Threads = 128;
constexpr int kK1Warps = kK1Threads / 32;
// K5: up to 16 warps (hb * ceil(group / 4) <= 16); 16 tokens per tile.
constexpr int kK5MaxThreads = 512;
constexpr int kK5TileTokens = 16;

typedef __nv_fp8_e5m2 fp8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(fp8 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The write path's number format (ops/kv_quant.py quantize_kv).
__device__ __forceinline__ void store_page(float* p, float x, float) {
  *p = x;
}
__device__ __forceinline__ void store_page(__nv_bfloat16* p, float x,
                                           float) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_page(int8_t* p, float x, float s) {
  const float code = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  *p = static_cast<int8_t>(code);
}
__device__ __forceinline__ void store_page(fp8* p, float x, float) {
  p->__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E5M2);
}

template <typename P>
__device__ __forceinline__ float round_op(float x) {
  // Dot operands: bf16 unless the pages are f32.
  if constexpr (std::is_same<P, float>::value) return x;
  return __bfloat162float(__float2bfloat16(x));
}

// x * 2^delta as an exponent-bias add (the Pallas bodies' _mul_pow2):
// delta is an integer <= 0; entries whose exponent would underflow,
// zeros and denormals included, become 0.
__device__ __forceinline__ float mul_pow2(float x, float delta) {
  const int bits = __float_as_int(x);
  const int d = static_cast<int>(fmaxf(delta, -254.f));
  const int e = (bits >> 23) & 0xFF;
  return e + d > 0 ? __int_as_float(bits + d * (1 << 23)) : 0.f;
}

template <bool kAmla>
__device__ __forceinline__ float rescale(float x, float delta) {
  if constexpr (kAmla) return mul_pow2(x, delta);
  return x * exp2f(delta);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int clamp_page(int page, int num_pages) {
  return page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
}

// Stores the quantized new K/V values [n] of this block's heads into
// the page row at `row` (a flat element offset).
template <typename T, typename P>
__device__ __forceinline__ void fused_write(P* k_pages, P* v_pages,
                                            const T* knew, const T* vnew,
                                            int64_t row, int64_t src, int n,
                                            float kv_scale) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    store_page(k_pages + row + i, to_f(knew[src + i]), kv_scale);
    store_page(v_pages + row + i, to_f(vnew[src + i]), kv_scale);
  }
}

// The chunk max and rescale of one warp's rows: m_new = max(m,
// ceil(max s)), l and acc rescaled by 2^(m - m_new).
template <bool kAmla>
__device__ __forceinline__ void chunk_max(
    const float* s_row, int s_stride, int nrows, int valid, int lane,
    float (&m)[kRowsPerWarp], float (&l)[kRowsPerWarp],
    float (&acc)[kRowsPerWarp][kMaxLaneElems]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r >= nrows) break;
    float mc = kNegBig;
    for (int t = lane; t < valid; t += 32)
      mc = fmaxf(mc, s_row[r * s_stride + t]);
    const float m_new = fmaxf(m[r], ceilf(warp_max(mc)));
    const float delta = m[r] - m_new;
    l[r] = rescale<kAmla>(l[r], delta);
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e)
      acc[r][e] = rescale<kAmla>(acc[r][e], delta);
    m[r] = m_new;
  }
}

template <typename T>
__device__ __forceinline__ void write_out(
    T* out, int nrows, int row_stride, int d, int lane, float kv_scale,
    const float (&l)[kRowsPerWarp],
    const float (&acc)[kRowsPerWarp][kMaxLaneElems]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r >= nrows) break;
    const float f = kv_scale / (l[r] == 0.f ? 1.f : l[r]);
    T* o = out + static_cast<int64_t>(r) * row_stride;
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e) {
      const int j = lane + 32 * e;
      if (j < d) store_f(o + j, acc[r][e] * f);
    }
  }
}

struct Args {
  void* out;
  const void* q;
  void* k_pages;
  void* v_pages;
  const int* block_tables;   // [B, pages_per_seq]
  const int* context_lens;   // [B]
  const float* alibi;        // [Hq] or null
  const void* knew;          // [B, Hkv, d] or null
  const void* vnew;
  int num_kv_heads, group, head_dim, num_pages, page_size, pages_per_seq,
      pages_per_chunk, head_block;
  float qk_scale;            // scale * kv_scale * log2(e)
  float kv_scale;
};

// ----------------------------------------------------------------- K1 --

template <typename T, typename P, bool kAmla>
__global__ void __launch_bounds__(kK1Threads) paged_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.head_dim;
  const int ps = a.page_size;
  const int ct = a.pages_per_chunk * ps;           // chunk tokens
  P* tile = reinterpret_cast<P*>(smem);            // [S, d], K then V
  float* q_s = reinterpret_cast<float*>(
      smem + ((static_cast<size_t>(ps) * d * sizeof(P) + 15) / 16) * 16);
  float* s_s = q_s + a.group * d;                  // [group, ct]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t hd = static_cast<int64_t>(a.num_kv_heads) * d;
  const int num_q_heads = a.num_kv_heads * a.group;
  const int* table = a.block_tables + static_cast<int64_t>(b) *
                                          a.pages_per_seq;
  int ctx = a.context_lens[b];
  P* kp = static_cast<P*>(a.k_pages);
  P* vp = static_cast<P*>(a.v_pages);

  if (a.knew != nullptr && ctx > 0) {
    const int pos = ctx - 1;
    const int64_t row =
        (static_cast<int64_t>(clamp_page(table[pos / ps], a.num_pages)) *
             ps + pos % ps) * hd + static_cast<int64_t>(h) * d;
    fused_write(kp, vp, static_cast<const T*>(a.knew),
                static_cast<const T*>(a.vnew), row,
                (static_cast<int64_t>(b) * a.num_kv_heads + h) * d, d,
                a.kv_scale);
  }
  const int64_t q_base = (static_cast<int64_t>(b) * num_q_heads +
                          static_cast<int64_t>(h) * a.group) * d;
  const T* q = static_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < a.group * d; i += kK1Threads)
    q_s[i] = round_op<P>(to_f(q[q_base + i]) * a.qk_scale);
  __syncthreads();

  // Warp w serves rows w, w + 4, ... of the group.
  const int nrows = (a.group - warp + kK1Warps - 1) / kK1Warps;
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxLaneElems];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e) acc[r][e] = 0.f;
  }
  float slope[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = warp + r * kK1Warps;
    slope[r] = (a.alibi != nullptr && r < nrows)
                   ? a.alibi[h * a.group + g] * kLog2e : 0.f;
  }

  ctx = min(ctx, a.pages_per_seq * ps);
  const int n_chunks = (ctx + ct - 1) / ct;
  const int vecs_per_row = d * static_cast<int>(sizeof(P)) / 16;
  const int elems_per_vec = 16 / static_cast<int>(sizeof(P));

  auto stage = [&](const P* pages, int page_idx, int rows) {
    const int64_t off =
        static_cast<int64_t>(clamp_page(table[page_idx], a.num_pages)) *
            ps * hd + static_cast<int64_t>(h) * d;
    for (int i = threadIdx.x; i < rows * vecs_per_row; i += kK1Threads) {
      const int r = i / vecs_per_row;
      const int c = i % vecs_per_row;
      reinterpret_cast<uint4*>(tile)[i] = *reinterpret_cast<const uint4*>(
          pages + off + r * hd + c * elems_per_vec);
    }
  };

  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * ct;
    const int valid = min(ct, ctx - base);
    const int n_pages = (valid + ps - 1) / ps;
    // Pass 1: every score of the chunk into s_s.
    for (int p = 0; p < n_pages; ++p) {
      const int rows = min(ps, valid - p * ps);
      stage(kp, c * a.pages_per_chunk + p, rows);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r >= nrows) break;
        const float* qg = q_s + (warp + r * kK1Warps) * d;
        float* srow = s_s + (warp + r * kK1Warps) * ct + p * ps;
        for (int t = 0; t < rows; ++t) {
          const P* kt = tile + t * d;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kMaxLaneElems; ++e) {
            const int j = lane + 32 * e;
            if (j < d) part += qg[j] * to_f(kt[j]);
          }
          const float s = warp_sum(part);
          if (lane == 0)
            srow[t] = s + slope[r] * static_cast<float>(base + p * ps + t);
        }
      }
      __syncthreads();
    }
    chunk_max<kAmla>(s_s + warp * ct, kK1Warps * ct, nrows, valid, lane,
                     m, l, acc);
    // Pass 2: P.V.
    float l_chunk[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < n_pages; ++p) {
      const int rows = min(ps, valid - p * ps);
      stage(vp, c * a.pages_per_chunk + p, rows);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r >= nrows) break;
        const float* srow = s_s + (warp + r * kK1Warps) * ct + p * ps;
        for (int t = 0; t < rows; ++t) {
          const float pt = exp2f(srow[t] - m[r]);
          l_chunk[r] += pt;
          const float po = round_op<P>(pt);
          const P* vt = tile + t * d;
#pragma unroll
          for (int e = 0; e < kMaxLaneElems; ++e) {
            const int j = lane + 32 * e;
            if (j < d) acc[r][e] += po * to_f(vt[j]);
          }
        }
      }
      __syncthreads();   // the next staging overwrites the tile
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) l[r] += l_chunk[r];
  }
  write_out(static_cast<T*>(a.out) + q_base + warp * d, nrows,
            kK1Warps * d, d, lane, a.kv_scale, l, acc);
}

// ----------------------------------------------------------------- K5 --

template <typename T, typename P, bool kAmla>
__global__ void __launch_bounds__(kK5MaxThreads) paged_decode_tm_kernel(
    Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.head_dim;
  const int ps = a.page_size;
  const int hb = a.head_block;
  const int hbd = hb * d;                          // a token's row
  const int rows = a.group * hb;                   // query rows
  const int ct = a.pages_per_chunk * ps;
  P* tile = reinterpret_cast<P*>(smem);            // [16, hb*d]
  float* q_s = reinterpret_cast<float*>(
      smem + ((static_cast<size_t>(kK5TileTokens) * hbd * sizeof(P) + 15) /
              16) * 16);                           // [rows, d]
  float* s_s = q_s + rows * d;                     // [rows, ct]

  const int b = blockIdx.x;
  const int j = blockIdx.y;                        // head block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t hd = static_cast<int64_t>(a.num_kv_heads) * d;
  const int* table = a.block_tables + static_cast<int64_t>(b) *
                                          a.pages_per_seq;
  int ctx = a.context_lens[b];
  P* kp = static_cast<P*>(a.k_pages);
  P* vp = static_cast<P*>(a.v_pages);
  const int64_t lane0 = static_cast<int64_t>(j) * hbd;

  if (a.knew != nullptr && ctx > 0) {
    const int pos = ctx - 1;
    const int64_t row =
        (static_cast<int64_t>(clamp_page(table[pos / ps], a.num_pages)) *
             ps + pos % ps) * hd + lane0;
    fused_write(kp, vp, static_cast<const T*>(a.knew),
                static_cast<const T*>(a.vnew), row,
                static_cast<int64_t>(b) * hd + lane0, hbd, a.kv_scale);
  }
  // Query rows of the head block: row r serves kv head r / group.
  const int64_t q_base = static_cast<int64_t>(b) * a.num_kv_heads *
                             a.group * d + static_cast<int64_t>(j) * rows * d;
  const T* q = static_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x)
    q_s[i] = round_op<P>(to_f(q[q_base + i]) * a.qk_scale);
  __syncthreads();

  // Warp w: kv head hh = w / wph of the block, rows r0 .. r0 + nrows.
  const int wph = (a.group + kRowsPerWarp - 1) / kRowsPerWarp;
  const int hh = warp / wph;
  const int r0 = hh * a.group + (warp % wph) * kRowsPerWarp;
  const int nrows = min(kRowsPerWarp, (hh + 1) * a.group - r0);
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxLaneElems];
  float slope[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e) acc[r][e] = 0.f;
    slope[r] = (a.alibi != nullptr && r < nrows)
                   ? a.alibi[j * rows + r0 + r] * kLog2e : 0.f;
  }

  ctx = min(ctx, a.pages_per_seq * ps);
  const int n_chunks = (ctx + ct - 1) / ct;
  const int vecs_per_row = hbd * static_cast<int>(sizeof(P)) / 16;
  const int elems_per_vec = 16 / static_cast<int>(sizeof(P));

  // Tokens [t0, t0 + n) of the sequence, each its hb*d-wide row.
  auto stage = [&](const P* pages, int t0, int n) {
    for (int i = threadIdx.x; i < n * vecs_per_row; i += blockDim.x) {
      const int r = i / vecs_per_row;
      const int c = i % vecs_per_row;
      const int pos = t0 + r;
      const int64_t off =
          (static_cast<int64_t>(clamp_page(table[pos / ps], a.num_pages)) *
               ps + pos % ps) * hd + lane0 + c * elems_per_vec;
      reinterpret_cast<uint4*>(tile)[i] =
          *reinterpret_cast<const uint4*>(pages + off);
    }
  };

  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * ct;
    const int valid = min(ct, ctx - base);
    // Pass 1: scores.
    for (int t0 = 0; t0 < valid; t0 += kK5TileTokens) {
      const int n = min(kK5TileTokens, valid - t0);
      stage(kp, base + t0, n);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r >= nrows) break;
        const float* qg = q_s + (r0 + r) * d;
        float* srow = s_s + (r0 + r) * ct + t0;
        for (int t = 0; t < n; ++t) {
          const P* kt = tile + t * hbd + hh * d;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kMaxLaneElems; ++e) {
            const int jj = lane + 32 * e;
            if (jj < d) part += qg[jj] * to_f(kt[jj]);
          }
          const float s = warp_sum(part);
          if (lane == 0)
            srow[t] = s + slope[r] * static_cast<float>(base + t0 + t);
        }
      }
      __syncthreads();
    }
    chunk_max<kAmla>(s_s + r0 * ct, ct, nrows, valid, lane, m, l, acc);
    // Pass 2: P.V.
    float l_chunk[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < valid; t0 += kK5TileTokens) {
      const int n = min(kK5TileTokens, valid - t0);
      stage(vp, base + t0, n);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r >= nrows) break;
        const float* srow = s_s + (r0 + r) * ct + t0;
        for (int t = 0; t < n; ++t) {
          const float pt = exp2f(srow[t] - m[r]);
          l_chunk[r] += pt;
          const float po = round_op<P>(pt);
          const P* vt = tile + t * hbd + hh * d;
#pragma unroll
          for (int e = 0; e < kMaxLaneElems; ++e) {
            const int jj = lane + 32 * e;
            if (jj < d) acc[r][e] += po * to_f(vt[jj]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) l[r] += l_chunk[r];
  }
  write_out(static_cast<T*>(a.out) + q_base + static_cast<int64_t>(r0) * d,
            nrows, d, d, lane, a.kv_scale, l, acc);
}

// ------------------------------------------------------------ launch --

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T, typename P, bool kAmla>
int launch(const Args& a, int batch, bool tm, cudaStream_t stream) {
  const size_t ct = static_cast<size_t>(a.pages_per_chunk) * a.page_size;
  size_t smem;
  int threads;
  dim3 grid;
  void (*kernel)(Args);
  if (tm) {
    const int rows = a.group * a.head_block;
    threads = 32 * a.head_block *
              ((a.group + kRowsPerWarp - 1) / kRowsPerWarp);
    if (threads > kK5MaxThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = round16(static_cast<size_t>(kK5TileTokens) * a.head_block *
                   a.head_dim * sizeof(P)) +
           static_cast<size_t>(rows) * (a.head_dim + ct) * sizeof(float);
    grid = dim3(batch, a.num_kv_heads / a.head_block);
    kernel = paged_decode_tm_kernel<T, P, kAmla>;
  } else {
    threads = kK1Threads;
    smem = round16(static_cast<size_t>(a.page_size) * a.head_dim *
                   sizeof(P)) +
           static_cast<size_t>(a.group) * (a.head_dim + ct) * sizeof(float);
    grid = dim3(batch, a.num_kv_heads);
    kernel = paged_decode_kernel<T, P, kAmla>;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0) kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_amla(const Args& a, int batch, bool tm, bool amla,
                cudaStream_t s) {
  return amla ? launch<T, P, true>(a, batch, tm, s)
              : launch<T, P, false>(a, batch, tm, s);
}

// act_dtype (q, out, knew/vnew): 0 = float32, 1 = bfloat16.
// page_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8 e5m2;
// float pages take the activation dtype.
int dispatch(const Args& a, int batch, int act_dtype, int page_dtype,
             bool tm, bool amla, cudaStream_t s) {
  if (a.group < 1 || a.head_dim > 32 * kMaxLaneElems ||
      (!tm && a.group > kK1Warps * kRowsPerWarp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (act_dtype == 0) {
    switch (page_dtype) {
      case 0: return launch_amla<float, float>(a, batch, tm, amla, s);
      case 2: return launch_amla<float, int8_t>(a, batch, tm, amla, s);
      case 3: return launch_amla<float, fp8>(a, batch, tm, amla, s);
    }
  } else if (act_dtype == 1) {
    switch (page_dtype) {
      case 1:
        return launch_amla<__nv_bfloat16, __nv_bfloat16>(a, batch, tm,
                                                         amla, s);
      case 2: return launch_amla<__nv_bfloat16, int8_t>(a, batch, tm, amla, s);
      case 3: return launch_amla<__nv_bfloat16, fp8>(a, batch, tm, amla, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1 (tm = 0) and K5 (tm = 1) share this entry's arguments; head_block
// is K5's (1 for K1).
extern "C" int paged_decode_attention(
    void* out, const void* q, void* k_pages, void* v_pages,
    const int* block_tables, const int* context_lens, const float* alibi,
    const void* knew, const void* vnew, int batch, int num_kv_heads,
    int group, int head_dim, int num_pages, int page_size,
    int pages_per_seq, int pages_per_chunk, int head_block, float qk_scale,
    float kv_scale, int act_dtype, int page_dtype, int tm, int amla,
    void* stream) {
  Args a{out, q, k_pages, v_pages, block_tables, context_lens, alibi,
         knew, vnew, num_kv_heads, group, head_dim, num_pages, page_size,
         pages_per_seq, pages_per_chunk, head_block, qk_scale, kv_scale};
  return dispatch(a, batch, act_dtype, page_dtype, tm != 0, amla != 0,
                  static_cast<cudaStream_t>(stream));
}
