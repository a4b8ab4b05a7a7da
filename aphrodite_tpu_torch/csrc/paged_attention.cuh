// Paged decode attention over the token-major KV cache, CUDA C++ for
// sm_90a: the kernels, shared by the sources paged_attention.cu and
// paged_attention_f16.cu. One kernel, paged_decode_kernel (with
// paged_decode_merge_kernel where it splits), serves both Pallas grids
// of aphrodite_tpu/ops/pallas/paged_attention.py:
//
//   K1 replaces _decode_kernel_ragged (:565, the ragged work-list grid,
//     launched at :888-896 and :1005);
//   K5 replaces _decode_kernel_tm (:252, the padded (batch, head-block)
//     grid, launched at :906-920 and :1005).
//
// Both compute, for one query token per sequence: GQA, optional ALiBi,
// the online softmax of the Pallas bodies, and the optional fused write
// of the current token's K/V at position ctx-1 into its page. The
// arithmetic is the Pallas bodies', chunk by chunk:
// - scores ride the base-2 domain: q is scaled by scale * kv_scale *
//   log2(e) in f32 (the int8 scale S folds in here) and, on bf16 and
//   8-bit pages, rounded to bf16, as the TPU's bf16 MXU operands were;
//   under fp16 activations (fp16, int8 or fp8 pages) to fp16, the dots'
//   operand type there (DotOperand); f32 pages keep f32 throughout (the
//   JAX package's CPU reference);
// - chunks of pages_per_chunk pages; per chunk the running max is
//   max(m, ceil(max s)), an integer, so the rescale 2^(m - m_new) is an
//   exact power of two, applied as an exponent-bias add (AMLA,
//   mul_pow2, which flushes what would underflow to 0) or as a multiply;
// - p = 2^(s - m_new); l sums p in f32, P.V takes p rounded to the
//   operand type (bf16, or fp16, where p below 2^-14 is subnormal and
//   rounds as torch's cast does); out = acc * (kv_scale / l).
// int8 and fp8 e5m2 page values convert to bf16 and to fp16 exactly, so
// they enter the dots as stored; the fused write quantizes the injected
// token (int8: rintf(x / S) by IEEE division, clamped to +-127; fp8:
// round to nearest even, no saturation, as the JAX cast; fp16 rows
// convert to f32 exactly first, so the codes are those of any dtype).
//
// float16: the JAX package gates fp16 pages out of both Pallas bodies
// and attends through its f32 jnp reference (`paged_decode_attention_ref`);
// the fp16 instances (T = __half over fp16, int8 and fp8 pages) are the
// same kernel with fp16 operands and mma.sync...f16.f16.f32, fp16 pages
// staged in the bf16 pages' padded 2-byte slots.
//
// What bounds them on an H100: bytes. Each sequence's K and V, Σctx ·
// Hkv · d · 2 (K and V) · page bytes, are read once (half as many bytes
// on 8-bit pages); the arithmetic is 4 · Hq · d flops per cached token,
// far under the card's ratio of operations to bytes. A kernel near that
// bound needs enough bytes in flight on every SM (about 25 bytes per ns
// of memory latency per SM), so the design questions are how many
// blocks share a sequence, how many pages each block keeps in flight,
// and how little each page costs once it has landed.
//
// K1 (the main path's decode attention, every step of every
// configuration), grid (batch, Hkv x row blocks, n_split), 4 warps a
// block:
// 0. Row blocks. A block serves at most 16 of a kv head's query rows
//    (two n-tiles of the score MMA); a larger group (DeciLM's 32 query
//    heads over one KV head) is split into blocks of 16 rows, ceil(group
//    / 16) blocks a kv head, each walking the same pages (the second
//    block's reads mostly hit L2: its neighbour in the grid reads them
//    at the same time). Every row block of the split holding ctx-1
//    writes the same fused K/V bytes before reading them. Those grids
//    run the kRowBlocks instances; at group <= 16 the others run, whose
//    code is the single-block kernel's.
// 1. Sequence splits (flash-decoding). A Hopper block cannot carry a
//    running sum to another block, so the TPU's sequential grid axis
//    becomes, per block, a loop over a contiguous run of whole chunks:
//    split s of (sequence, kv head) walks chunks [s * per, (s + 1) *
//    per) with its own online-softmax state. The chunks are the Pallas
//    body's (pages_per_chunk pages), so each chunk's integer max and
//    bf16 rounding stay its own; every rescale is a power of two. With
//    more than one split each block writes (m, l, acc) in f32 to
//    scratch the wrapper allocates, and paged_decode_merge_kernel, a
//    second launch on the same stream, takes M = max m_s and sums l_s
//    and acc_s rescaled by 2^(m_s - M) with the same rescale<kAmla>.
//    A separate launch rather than a last-block-done counter: nothing
//    is kept between calls, so two streams or a failed call cannot
//    leave a counter behind, and the merge costs a few us. The split
//    count comes from shapes and the device's SM count alone (the
//    host's choose_decode_splits: about two blocks per SM, 1 where
//    batch * Hkv already covers the SMs), so the launch needs no host
//    sync. Empty splits (past ctx) write
//    m = -2^30, l = 0. The split holding position ctx-1 does the fused
//    write first; no other block reads that page.
// 2. A cp.async ring. Each block's loads, the K rows then the V rows
//    of each chunk, slot_rows tokens a load (a slot may cross pages),
//    stream through 2-5 slots with 16-byte cp.async.cg copies issued
//    stages - 1 loads ahead of the compute; rows past ctx are
//    zero-filled, so they add nothing to P.V. The launcher plans the
//    ring (k1_plan): bf16 5 slots of one page, 8-bit 4 of two pages (as
//    many bytes a step), f32 3 of one page; twice the pages per slot,
//    one stage fewer, where the host asks for wide slots (a grid of at
//    most two blocks per SM, from the device's SM count: there each
//    block's chain of steps, not the card's bandwidth, sets the time).
//    A slot holds at most 16 KB of page bytes, and the ring shrinks
//    until the block fits the device's shared memory, so every page
//    size and head_dim up to 256 is served. The split's block-table
//    entries are staged once (the host's split policy keeps them to
//    about 2048), so issuing a load needs no global read. Shared
//    memory stays at 48-61 KB per block at the main path's geometry:
//    four blocks per SM.
// 3. Tensor-core dots. mma.sync.m16n8k16 (bf16 in, f32 sums): scores
//    as S^T = K q^T (tokens the 16 rows, the group's query rows the 8
//    columns: Mistral's group 4 padded to 8, 16 takes two n-tiles) and
//    O^T += V^T P^T (d the 16 rows, tokens the depth), with ldmatrix
//    (.trans for V) from the staged tiles. q and p keep the Pallas
//    body's bf16 rounding; p is computed once per chunk (not per V page
//    in every warp) into bf16 over the scores' own rows. 8-bit pages are
//    widened to bf16 exactly in shared memory by the warps that read
//    them, their scale folded into q and the epilogue. f32 pages (the
//    float32 model) keep CUDA-core dots, a warp per query row, in the
//    same split and ring. wgmma and TMA are not needed: a slot is a few
//    KB and the kernel is bytes-bound, so 64-row warpgroup tiles would
//    be mostly padding.
//
// K5 is the same launch: K1's grid (batch, Hkv, n_split) is the padded
// grid at one kv head a block, with K1's splits and merge. Blocks of two
// kv heads (one run of 2 d values a token) measured 9% faster on an H100
// at batch 8 and 7-44% slower wherever the halved grid fell under two
// blocks an SM, four heads never faster (PERF.md), so K5 keeps one.
// Rows with ctx 0 write zeros.
//
// The kernels and their launchers live in this header; two sources
// instantiate them, each its own library built by its own nvcc, side by
// side: paged_attention.cu the f32 and bf16 activations (with every
// page type's plan, paged_decode_smem_bytes), paged_attention_f16.cu the
// fp16 ones. Their C entry points launch on the caller's stream,
// allocate nothing and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "kv_quant.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kMaxLaneElems = 8;     // head_dim <= 256
constexpr float kNegBig = -1073741824.0f;  // -2^30, the Pallas bodies'
constexpr float kLog2e = 1.4426950408889634f;
// K1: 4 warps x 4 rows (a row block's 16 query rows).
constexpr int kK1Threads = 128;
constexpr int kK1Warps = kK1Threads / 32;

typedef __nv_fp8_e5m2 fp8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(fp8 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_f(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The write path's number format (ops/kv_quant.py quantize_kv; the
// 8-bit codes are kv_quant.cuh's, shared with the slot writer).
__device__ __forceinline__ void store_page(float* p, float x, float) {
  *p = x;
}
__device__ __forceinline__ void store_page(__nv_bfloat16* p, float x,
                                           float) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_page(int8_t* p, float x, float s) {
  *p = kvq::int8_code(x, s);
}
__device__ __forceinline__ void store_page(fp8* p, float x, float) {
  p->__x = kvq::fp8_code(x);
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
    if constexpr (std::is_same<T, __half>::value &&
                  std::is_same<P, __half>::value) {
      // fp16 rows into fp16 pages: the bits as they are (a NaN's payload
      // and sign too, as torch's copy keeps them).
      k_pages[row + i] = knew[src + i];
      v_pages[row + i] = vnew[src + i];
    } else {
      store_page(k_pages + row + i, to_f(knew[src + i]), kv_scale);
      store_page(v_pages + row + i, to_f(vnew[src + i]), kv_scale);
    }
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
      pages_per_chunk;
  int row_blocks;            // K1: ceil(group / 16) blocks a kv head
  float qk_scale;            // scale * kv_scale * log2(e)
  float kv_scale;
};

// ----------------------------------------------------------------- K1 --

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// How K1 stages its pages. A ring of `stages` slots in shared memory,
// each `slot_rows` consecutive tokens of one chunk for one kv head (a
// slot may cross page boundaries: each row looks up its own page), is
// filled with 16-byte cp.async copies while the block computes on an
// earlier slot. bf16 slots pad each token's row by 16 bytes, so
// ldmatrix reads 8 rows at one column without bank conflicts (and a
// head_dim of 8 mod 16 reads the zeroed pad as its last 8 columns);
// 8-bit slots hold the bytes as stored and are widened to a padded bf16
// tile before the dots; f32 slots hold the f32 rows for the CUDA-core
// dots. The launcher picks the ring (k1_plan): a slot of one page on
// bf16 and two on 8-bit pages (about as many bytes a step), twice that
// where the host asks for wide slots (a grid of at most two blocks per
// SM, where shared memory is plentiful and each block's chain of steps
// sets the time), at most kSlotBytes of page bytes; then, until the
// block fits the device's shared memory, fewer stages (down to 3),
// fewer rows (down to 16), and 2 stages. The depth is the kernel's
// template argument (cp.async.wait_group takes an immediate; read at
// run time it cost 1-4% at the main path's shapes on an H100), and the
// split's block-table entries are always staged (a per-row choice of
// staged or global entries cost 4-18%).
constexpr int kSlotBytes = 16384;

constexpr int kMmaPad = 8;          // bf16 elements after a staged row
constexpr int kMmaRows = 16;        // a row block's query rows: two n-tiles
constexpr int kMaxNTiles = 2;       // of 8
constexpr int kMaxMTiles = 4;       // head_dim <= 256: 16 m-tiles / 4 warps

// K1's shared memory: the ring, the widened tile (8-bit pages), q (bf16
// rows padded to a multiple of 8 on the tensor-core path), the chunk's
// scores [group, score_stride], four [16] rows (ALiBi slopes, m, l, the
// chunk's rescale exponent) and the split's block-table entries.
// Offsets in bytes. Computed on the host and passed to the kernel.
struct K1Layout {
  int slot_rows;      // tokens per slot, a multiple of the dots' 16
  int slot_row;       // bytes per staged row
  int stages;         // slots in the ring, 2-5
  int score_stride;   // floats per score row: 4 mod 32, 16-byte rows
  int table_entries;  // the split's block-table entries
  size_t slot, cvt, q, s, vars, table, total;
};

template <typename P>
K1Layout k1_layout(int group, int d, int ps, int ppc, int table_entries,
                   int slot_rows, int stages) {
  constexpr bool kMma = !std::is_same<P, float>::value;
  constexpr bool kPadded = sizeof(P) == 2;   // bf16 and fp16 pages
  const size_t ct = static_cast<size_t>(ppc) * ps;
  K1Layout L;
  L.slot_rows = slot_rows;
  L.slot_row = kPadded ? (d + kMmaPad) * 2 : d * static_cast<int>(sizeof(P));
  L.stages = stages;
  L.score_stride = static_cast<int>((ct + 31) / 32 * 32 + 4);
  L.table_entries = table_entries;
  L.slot = static_cast<size_t>(slot_rows) * L.slot_row;
  L.cvt = stages * L.slot;
  L.q = L.cvt + (kMma && !kPadded
                     ? static_cast<size_t>(slot_rows) * (d + kMmaPad) * 2
                     : 0);
  L.s = L.q + round16(kMma ? static_cast<size_t>((group + 7) / 8 * 8) *
                                 (d + kMmaPad) * 2
                           : static_cast<size_t>(group) * d * sizeof(float));
  L.vars = L.s + round16(static_cast<size_t>(group) * L.score_stride *
                         sizeof(float));
  L.table = L.vars + 4 * kMmaRows * sizeof(float);
  L.total = L.table + round16(static_cast<size_t>(table_entries) *
                              sizeof(int));
  return L;
}

// The ring for a page type and slot width, shrunk to fit `limit` bytes
// of shared memory per block (the caller checks that it did).
// `split_entries` is one split's block-table entries.
template <typename P>
K1Layout k1_plan(int group, int d, int ps, int ppc, int split_entries,
                 bool wide, size_t limit) {
  constexpr bool kMma = !std::is_same<P, float>::value;
  const int pages = (sizeof(P) == 1 ? 2 : 1) * (wide && kMma ? 2 : 1);
  int stages = !kMma ? 3 : (sizeof(P) == 1 ? (wide ? 3 : 4)
                                           : (wide ? 4 : 5));
  const int cap = std::max(
      16, kSlotBytes / (d * static_cast<int>(sizeof(P))) / 16 * 16);
  int rows = std::min((pages * ps + 15) / 16 * 16, cap);
  K1Layout L = k1_layout<P>(group, d, ps, ppc, split_entries, rows,
                            stages);
  while (L.total > limit && (stages > 2 || rows > 16)) {
    if (stages > 3)
      --stages;
    else if (rows > 16)
      rows = std::max(16, rows / 2 / 16 * 16);
    else
      --stages;
    L = k1_layout<P>(group, d, ps, ppc, split_entries, rows, stages);
  }
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  // src-size 0 writes 16 zero bytes: rows past the live ones read as 0.
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tensor-core dots' operand type O: fp16 under fp16 activations,
// bf16 under the others. q, p and the widened 8-bit pages round to O;
// the sums stay f32.
template <typename T>
struct DotOperand {
  typedef __nv_bfloat16 type;
};
template <>
struct DotOperand<__half> {
  typedef __half type;
};

template <typename O>
__device__ __forceinline__ O to_op(float x) {
  if constexpr (std::is_same<O, __half>::value)
    return __float2half_rn(x);
  else
    return __float2bfloat16(x);
}

template <typename O>
__device__ __forceinline__ uint32_t pack_op(float lo, float hi) {
  if constexpr (std::is_same<O, __half>::value)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

template <typename O>
__device__ __forceinline__ void mma_op(float* c, const uint32_t* a,
                                       const uint32_t* b) {
  if constexpr (std::is_same<O, __half>::value)
    mma_f16(c, a, b);
  else
    mma_bf16(c, a, b);
}

// 16 int8 or fp8 e5m2 values to O, exactly (both fit bf16 and fp16:
// e5m2 is fp16 without its low 8 mantissa bits).
template <typename P, typename O>
__device__ __forceinline__ void widen16(const P* src, O* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const P* v = reinterpret_cast<const P*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_op<O>(to_f(v[2 * i]),
                                                to_f(v[2 * i + 1]));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// K1's arguments: the shared ones, the ring's layout and the split
// state. `part` holds each split's f32 state, acc [B, Hkv, n_split,
// group, d] then m and l [B, Hkv, n_split, group] each; null when
// n_split is 1.
struct SplitArgs {
  Args a;
  K1Layout L;
  float* part;
  int n_split;
};

// Grid (batch, Hkv x row blocks, n_split), 4 warps; block y serves kv
// head y / row_blocks and its query rows [16 rb, 16 rb + 16) (rb = y %
// row_blocks), `group` below. Split s walks the whole chunks
// [s * per, (s + 1) * per) that hold live tokens; its loads, K rows
// then V rows chunk by chunk, slot_rows tokens a load, run through the
// ring stages - 1 ahead of the compute. Tensor-core path (bf16 and
// 8-bit pages), with g = lane / 4 and t = lane % 4 of mma.m16n8k16:
// - scores S^T [tokens, rows] = K [tokens, d] . q^T: tokens are the 16
//   rows (ldmatrix from the slot), the group's query rows the 8 columns
//   (group 4 padded to 8, 16 takes two n-tiles; q from shared memory,
//   zero rows past the group); a warp per (16 tokens, n-tile);
// - O^T [d, rows] += V^T [d, tokens] . P^T: d is the 16 rows (ldmatrix
//   .trans of the slot), rows the columns, tokens the depth; p, computed
//   once per chunk as bf16 over the scores' rows, is the B fragment
//   (ldmatrix); warp w keeps d tiles w, w + 4, ... in registers.
// Steps cover only a slot's 16-row tiles that hold a live token; a slot
// starts at a multiple of 16 tokens of its chunk, so p's rows are read
// 16-byte aligned whatever the page size.
// f32 pages keep the CUDA-core dots (a warp per query row, a shuffle sum
// per score) inside the same split and ring.
template <typename T, typename P, bool kAmla, int kStages, bool kRowBlocks>
__global__ void __launch_bounds__(kK1Threads, 4) paged_decode_kernel(
    SplitArgs sa) {
  constexpr bool kMma = !std::is_same<P, float>::value;
  constexpr bool kPadded = sizeof(P) == 2;   // bf16 and fp16 pages
  typedef typename DotOperand<T>::type O;
  const Args& a = sa.a;
  const K1Layout& L = sa.L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.head_dim;
  const int ps = a.page_size;
  // Without row blocks (group <= 16) the block's rows are its kv head's
  // whole group and the code is the single-block kernel's.
  const int h = kRowBlocks ? blockIdx.y / a.row_blocks : blockIdx.y;
  const int row_first =
      kRowBlocks ? (blockIdx.y - h * a.row_blocks) * kMmaRows : 0;
  const int group =                                  // this block's rows
      kRowBlocks ? min(kMmaRows, a.group - row_first) : a.group;
  const int ppc = a.pages_per_chunk;
  const int ct = ppc * ps;                         // chunk tokens
  const int R = L.slot_rows;
  constexpr int stages = kStages;  // == L.stages
  // Score row stride: 4 mod 32 words, so ldmatrix reads 8 rows of p
  // (bf16 over the row's first bytes) without bank conflicts.
  const int ss = L.score_stride;
  unsigned char* ring = smem;
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* slope_s = reinterpret_cast<float*>(smem + L.vars);
  float* m_s = slope_s + kMmaRows;
  float* l_s = m_s + kMmaRows;
  float* delta_s = l_s + kMmaRows;
  int* table_s = reinterpret_cast<int*>(smem + L.table);

  const int b = blockIdx.x;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t hd = static_cast<int64_t>(a.num_kv_heads) * d;
  const int* table = a.block_tables + static_cast<int64_t>(b) *
                                          a.pages_per_seq;
  const int ctx_in = a.context_lens[b];
  P* kp = static_cast<P*>(a.k_pages);
  P* vp = static_cast<P*>(a.v_pages);
  const int n_chunks = a.pages_per_seq / ppc;
  const int per_split = (n_chunks + sa.n_split - 1) / sa.n_split;

  // The split holding position ctx-1 writes it before anything reads
  // its page; no other split reads those bytes, and its row blocks all
  // write the same values.
  if (a.knew != nullptr && ctx_in > 0) {
    const int pos = ctx_in - 1;
    if (min(pos / ct / per_split, sa.n_split - 1) == split) {
      const int64_t row =
          (static_cast<int64_t>(clamp_page(table[pos / ps], a.num_pages)) *
               ps + pos % ps) * hd + static_cast<int64_t>(h) * d;
      fused_write(kp, vp, static_cast<const T*>(a.knew),
                  static_cast<const T*>(a.vnew), row,
                  (static_cast<int64_t>(b) * a.num_kv_heads + h) * d, d,
                  a.kv_scale);
      __threadfence();           // visible to the cp.async reads (L2)
    }
  }
  const int64_t q_base =
      ((static_cast<int64_t>(b) * a.num_kv_heads + h) * a.group + row_first) *
      d;
  const T* q = static_cast<const T*>(a.q);
  if constexpr (kMma) {
    // Padded rows and columns (past the group, past d) read as zero.
    const int ld = d + kMmaPad;
    O* q_s = reinterpret_cast<O*>(smem + L.q);
    for (int i = tid; i < (group + 7) / 8 * 8 * ld; i += kK1Threads) {
      const int r = i / ld;
      const int c = i - r * ld;
      q_s[i] = to_op<O>(
          r < group && c < d ? to_f(q[q_base + r * d + c]) * a.qk_scale
                             : 0.f);
    }
    // A head_dim of 8 mod 16 takes its last 16-deep step over the slot
    // rows' pad, which no copy writes: zero it once.
    if (kPadded && d % 16 != 0)
      for (int r = tid; r < stages * R; r += kK1Threads)
        *reinterpret_cast<uint4*>(ring + r * L.slot_row + d * 2) =
            make_uint4(0, 0, 0, 0);
  } else {
    float* q_s = reinterpret_cast<float*>(smem + L.q);
    for (int i = tid; i < group * d; i += kK1Threads)
      q_s[i] = round_op<P>(to_f(q[q_base + i]) * a.qk_scale);
  }
  if (tid < kMmaRows) {
    slope_s[tid] = (a.alibi != nullptr && tid < group)
                       ? a.alibi[h * a.group + row_first + tid] * kLog2e
                       : 0.f;
    m_s[tid] = kNegBig;
    l_s[tid] = 0.f;
    delta_s[tid] = 0.f;
  }
  const int ctx = min(ctx_in, a.pages_per_seq * ps);
  const int c_begin = split * per_split;
  const int c_end = min(min(c_begin + per_split, n_chunks),
                        (ctx + ct - 1) / ct);
  // The split's pages, clamped, so a load's address needs no global
  // read.
  for (int i = tid; i < (c_end - c_begin) * ppc; i += kK1Threads)
    table_s[i] = clamp_page(table[c_begin * ppc + i], a.num_pages);
  __syncthreads();
  const int valid_last = c_end > c_begin ? min(ct, ctx - (c_end - 1) * ct)
                                         : 0;
  const int slots_per_pass = (ct + R - 1) / R;
  const int n_loads =
      c_end > c_begin
          ? 2 * (slots_per_pass * (c_end - 1 - c_begin) +
                 (valid_last + R - 1) / R)
          : 0;
  // A load: chunk c, K (kv 0) or V (kv 1), tokens t .. t + R - 1 of the
  // chunk's `valid` live ones; the producer's cursor runs stages - 1
  // loads ahead of the consumer's. Both advance by increments (no
  // divisions per load).
  struct Cursor {
    int c, kv, t, valid;
  };
  auto first = [&]() {
    return Cursor{c_begin, 0, 0,
                  c_begin == c_end - 1 ? valid_last : ct};
  };
  auto advance = [&](Cursor& u) {
    u.t += R;
    if (u.t < u.valid) return;
    u.t = 0;
    if (u.kv == 0) {
      u.kv = 1;
      return;
    }
    u.kv = 0;
    u.valid = ++u.c == c_end - 1 ? valid_last : ct;
  };
  // This thread's 16-byte copies of a slot: vectors tid, tid + 128, ...
  // of its rows; when the vectors per row divide 128 a thread keeps one
  // column and steps rows by 128 / vecs_per_row.
  const int vecs_per_row = d * static_cast<int>(sizeof(P)) / 16;
  const int elems_per_vec = 16 / static_cast<int>(sizeof(P));
  const bool regular = kK1Threads % vecs_per_row == 0;
  const int copy_r0 = tid / vecs_per_row;
  const int copy_c = tid % vecs_per_row;
  const int copy_rstep = kK1Threads / vecs_per_row;
  const int ps_log = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  Cursor load = first();
  int load_slot = 0;
  int loads_issued = 0;
  auto issue = [&]() {
    if (loads_issued < n_loads) {
      const int rows = min(R, load.valid - load.t);
      const int pages = (load.c - c_begin) * ppc;
      const P* base = (load.kv ? vp : kp) + static_cast<int64_t>(h) * d;
      // Row r of the slot: token t + r of the chunk, row (t + r) % ps
      // of the chunk's page (t + r) / ps (dead rows read nothing; their
      // address stays in the chunk's first page).
      auto row_src = [&](int r, bool live) {
        const int tt = live ? load.t + r : 0;
        const int pg = ps_log >= 0 ? tt >> ps_log : tt / ps;
        const int page = table_s[pages + pg];
        return base + (static_cast<int64_t>(page) * ps + tt - pg * ps) * hd;
      };
      unsigned char* dst = ring + load_slot * L.slot;
      if (regular) {
        for (int r = copy_r0; r < R; r += copy_rstep) {
          const bool live = r < rows;
          cp_async16(dst + r * L.slot_row + copy_c * 16,
                     row_src(r, live) + copy_c * elems_per_vec, live);
        }
      } else {
        for (int v = tid; v < R * vecs_per_row; v += kK1Threads) {
          const int r = v / vecs_per_row;
          const int c = v % vecs_per_row;
          const bool live = r < rows;
          cp_async16(dst + r * L.slot_row + c * 16,
                     row_src(r, live) + c * elems_per_vec, live);
        }
      }
      advance(load);
      load_slot = load_slot + 1 == stages ? 0 : load_slot + 1;
      ++loads_issued;
    }
    cp_async_commit();
  };

  // Tensor-core state: acc[i][4 * nt + j] is fragment j of d tile
  // warp + 4i, n-tile nt. CUDA-core state: acc[r][e] is row warp + 4r,
  // element lane + 32e, with m, l and the chunk's l in registers.
  float acc[kRowsPerWarp][kMaxLaneElems];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int e = 0; e < kMaxLaneElems; ++e) acc[r][e] = 0.f;
  float m[kRowsPerWarp], l[kRowsPerWarp], l_chunk[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
    l_chunk[r] = 0.f;
  }
  const int nrows = (group - warp + kK1Warps - 1) / kK1Warps;
  // p's length per row: a slot's dots read its live rows rounded up to
  // 16, so at most ct + 15 tokens of a chunk (within the row's 4 * ss
  // bytes, as ss >= round32(ct) + 4).
  const int p_len = ct + 16;
  const int n_nt = (group + 7) / 8;
  const int n_dt = (d + 15) / 16;

  for (int i = 0; i < stages - 1; ++i) issue();
  Cursor st = first();
  int use_slot = 0;
  for (int i = 0; i < n_loads; ++i) {
    cp_async_wait<stages - 2>();
    __syncthreads();               // load i landed; slot i - 1 is free
    issue();                       // load i + stages - 1
    const unsigned char* slot = ring + use_slot * L.slot;
    const int rows = min(R, st.valid - st.t);
    const int t0 = st.t;           // the slot's first token in the chunk
    const int pos0 = st.c * ct + t0;
    const bool opens_v = st.kv && st.t == 0;
    const bool closes_v = st.kv && st.t + R >= st.valid;
    const int live_tiles = (rows + 15) / 16;   // 16-row tiles with a live row
    if constexpr (kMma) {
      const int ld = d + kMmaPad;
      if (opens_v) {
        // A warp per query row: the chunk's integer max, then p =
        // 2^(s - m) once for the whole chunk, rounded to bf16 over the
        // row's own scores (p's bytes trail the f32 reads) and zero past
        // the live tokens as far as any slot reads, and l rescaled by
        // 2^delta plus the chunk's sum of p.
        for (int g = warp; g < group; g += kK1Warps) {
          float* srow = s_s + g * ss;
          float mc = kNegBig;
          for (int t = lane; t < st.valid; t += 32) mc = fmaxf(mc, srow[t]);
          mc = warp_max(mc);
          const float m_old = m_s[g];
          const float m_new = fmaxf(m_old, ceilf(mc));
          O* prow = reinterpret_cast<O*>(srow);
          float lsum = 0.f;
          for (int t0p = 0; t0p < p_len; t0p += 32) {
            const int t = t0p + lane;
            const float pt = t < st.valid ? exp2f(srow[t] - m_new) : 0.f;
            __syncwarp();
            if (t < p_len) prow[t] = to_op<O>(pt);
            lsum += pt;
          }
          lsum = warp_sum(lsum);
          if (lane == 0) {
            const float delta = m_old - m_new;
            delta_s[g] = delta;
            l_s[g] = rescale<kAmla>(l_s[g], delta) + lsum;
            m_s[g] = m_new;
          }
        }
      }
      // 8-bit pages: each warp widens the part of the slot its own dots
      // read (16 token rows of a score tile, or its d tiles of every
      // row) into the bf16 tile, so no block barrier is needed. Two
      // warps widening the same rows (group > 8) write equal values.
      const O* tile;
      O* cvt = reinterpret_cast<O*>(smem + L.cvt);
      auto widen = [&](int r0, int n_rows, int c0, int c_step, int n_c) {
        if constexpr (!kPadded) {
          for (int v = lane; v < n_rows * n_c; v += 32) {
            const int r = r0 + v / n_c;
            const int c = c0 + (v % n_c) * c_step;
            widen16(reinterpret_cast<const P*>(slot + r * L.slot_row) +
                        c * 16, cvt + r * ld + c * 16);
          }
          __syncwarp();
        }
      };
      if constexpr (kPadded)
        tile = reinterpret_cast<const O*>(slot);
      else
        tile = cvt;
      if (opens_v) {
        __syncthreads();           // the chunk's p, m and delta
#pragma unroll
        for (int ii = 0; ii < kMaxMTiles; ++ii)
#pragma unroll
          for (int j = 0; j < 4 * kMaxNTiles; ++j)
            acc[ii][j] = rescale<kAmla>(
                acc[ii][j], delta_s[(j / 4) * 8 + 2 * (lane & 3) + (j & 1)]);
      }
      if (!st.kv) {
        const O* q_s = reinterpret_cast<const O*>(smem + L.q);
        for (int item = warp; item < live_tiles * n_nt; item += kK1Warps) {
          const int mt = item % live_tiles;
          const int nt = item / live_tiles;
          widen(mt * 16, 16, 0, 1, n_dt);
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const O* ar =
              tile + (mt * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
          const O* br =
              q_s + (nt * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
          for (int k0 = 0; k0 < d; k0 += 16) {
            uint32_t af[4], bfr[2];
            ldsm_x4(af, ar + k0);
            ldsm_x2(bfr, br + k0);
            mma_op<O>(c, af, bfr);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = mt * 16 + (lane >> 2) + (j >> 1) * 8;
            const int g = nt * 8 + 2 * (lane & 3) + (j & 1);
            if (t < rows && g < group)
              s_s[g * ss + t0 + t] =
                  c[j] + slope_s[g] * static_cast<float>(pos0 + t);
          }
        }
      } else {
        widen(0, live_tiles * 16, warp, kK1Warps,
              (n_dt - warp + kK1Warps - 1) / kK1Warps);
        for (int kt = 0; kt < live_tiles; ++kt) {
          // P^T fragments from the chunk's p rows (rows past the group
          // read the last row: their output columns are dropped).
          uint32_t pb[kMaxNTiles][2];
#pragma unroll
          for (int nt = 0; nt < kMaxNTiles; ++nt) {
            const int g = min(nt * 8 + (lane & 7), group - 1);
            if (nt < n_nt)
              ldsm_x2(pb[nt], reinterpret_cast<const O*>(s_s + g * ss) +
                                  t0 + kt * 16 + ((lane >> 3) & 1) * 8);
          }
#pragma unroll
          for (int ii = 0; ii < kMaxMTiles; ++ii) {
            const int mt = warp + ii * kK1Warps;
            if (mt < n_dt) {
              uint32_t af[4];
              ldsm_x4_trans(af, tile + (kt * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * ld +
                                    mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
              for (int nt = 0; nt < kMaxNTiles; ++nt)
                if (nt < n_nt) mma_op<O>(&acc[ii][4 * nt], af, pb[nt]);
            }
          }
        }
      }
    } else {
      const P* tile = reinterpret_cast<const P*>(slot);
      const float* q_s = reinterpret_cast<const float*>(smem + L.q);
      if (!st.kv) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (r >= nrows) break;
          const int g = warp + r * kK1Warps;
          const float* qg = q_s + g * d;
          float* srow = s_s + g * ss + t0;
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
              srow[t] = s + slope_s[g] * static_cast<float>(pos0 + t);
          }
        }
      } else {
        if (opens_v) {
          chunk_max<kAmla>(s_s + warp * ss, kK1Warps * ss, nrows, st.valid,
                           lane, m, l, acc);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) l_chunk[r] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (r >= nrows) break;
          const float* srow = s_s + (warp + r * kK1Warps) * ss + t0;
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
        if (closes_v) {
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) l[r] += l_chunk[r];
        }
      }
    }
    advance(st);
    use_slot = use_slot + 1 == stages ? 0 : use_slot + 1;
  }
  cp_async_wait<0>();
  __syncthreads();                 // l_s complete

  const bool direct = sa.n_split == 1;
  const int64_t rows_all = static_cast<int64_t>(gridDim.x) *
                           a.num_kv_heads * sa.n_split * a.group;
  const int64_t row0 = ((static_cast<int64_t>(b) * a.num_kv_heads + h) *
                            sa.n_split + split) * a.group + row_first;
  if constexpr (kMma) {
    T* out = static_cast<T*>(a.out) + q_base;
#pragma unroll
    for (int ii = 0; ii < kMaxMTiles; ++ii) {
      const int mt = warp + ii * kK1Warps;
      if (mt >= n_dt) break;
#pragma unroll
      for (int j = 0; j < 4 * kMaxNTiles; ++j) {
        const int g = (j / 4) * 8 + 2 * (lane & 3) + (j & 1);
        const int col = mt * 16 + (lane >> 2) + ((j >> 1) & 1) * 8;
        if (g >= group || col >= d) continue;
        if (direct)
          store_f(out + g * d + col,
                  acc[ii][j] * (a.kv_scale / (l_s[g] == 0.f ? 1.f : l_s[g])));
        else
          sa.part[(row0 + g) * d + col] = acc[ii][j];
      }
    }
    if (!direct && tid < group) {
      sa.part[rows_all * d + row0 + tid] = m_s[tid];
      sa.part[rows_all * (d + 1) + row0 + tid] = l_s[tid];
    }
  } else {
    if (direct) {
      write_out(static_cast<T*>(a.out) + q_base + warp * d, nrows,
                kK1Warps * d, d, lane, a.kv_scale, l, acc);
      return;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r >= nrows) break;
      const int64_t g = row0 + warp + r * kK1Warps;
#pragma unroll
      for (int e = 0; e < kMaxLaneElems; ++e) {
        const int j = lane + 32 * e;
        if (j < d) sa.part[g * d + j] = acc[r][e];
      }
      if (lane == 0) {
        sa.part[rows_all * d + g] = m[r];
        sa.part[rows_all * (d + 1) + g] = l[r];
      }
    }
  }
}

// K1's merge, grid (B * Hkv): M = max of the splits' m, then l and acc
// summed over the splits rescaled by 2^(m_s - M) (rescale<kAmla>, in
// split order), out = acc * (kv_scale / l). Each thread takes its own
// row's M and l, so the block needs no barrier: two rounds of loads.
template <typename T, bool kAmla>
__global__ void __launch_bounds__(kK1Threads) paged_decode_merge_kernel(
    const float* part, T* out, int n_split, int group, int d,
    float kv_scale) {
  const int64_t rows_all = static_cast<int64_t>(gridDim.x) * n_split * group;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * n_split * group;
  const float* pm = part + rows_all * d;
  const float* pl = pm + rows_all;
  for (int e = threadIdx.x; e < group * d; e += blockDim.x) {
    const int g = e / d;
    float top = kNegBig;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s)
      top = fmaxf(top, pm[row0 + s * group + g]);
    float l = 0.f, acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const int64_t r = row0 + s * group + g;
      const float delta = pm[r] - top;
      l += rescale<kAmla>(pl[r], delta);
      acc += rescale<kAmla>(part[r * d + e % d], delta);
    }
    store_f(out + static_cast<int64_t>(blockIdx.x) * group * d + e,
            acc * (kv_scale / (l == 0.f ? 1.f : l)));
  }
}

// ------------------------------------------------------------ launch --

// The device's opt-in shared memory per block (227 KB on an H100),
// read once per device.
size_t smem_limit() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int v = 48 * 1024;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    v = 48 * 1024;
  if (dev < 64) cached[dev] = v;
  return static_cast<size_t>(v);
}

// One split's block-table entries: its whole chunks.
int split_entries(const Args& a, int n_split) {
  const int n_chunks = a.pages_per_seq / a.pages_per_chunk;
  return (n_chunks + n_split - 1) / n_split * a.pages_per_chunk;
}

// A row block's layout: at most kMmaRows query rows.
template <typename P>
K1Layout k1_plan_for(const Args& a, int n_split, bool wide) {
  return k1_plan<P>(std::min(a.group, kMmaRows), a.head_dim, a.page_size,
                    a.pages_per_chunk, split_entries(a, n_split), wide,
                    smem_limit());
}

template <typename T, typename P, bool kAmla, int kStages, bool kRowBlocks>
int launch_k1_grid(const Args& a, const K1Layout& L, int batch, int n_split,
                   float* part, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, P, kAmla, kStages, kRowBlocks>;
  if (L.total > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<dim3(batch, a.num_kv_heads * a.row_blocks, n_split), kK1Threads,
           L.total, stream>>>(SplitArgs{a, L, part, n_split});
  if (n_split > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_decode_merge_kernel<T, kAmla>
        <<<batch * a.num_kv_heads, kK1Threads, 0, stream>>>(
            part, static_cast<T*>(a.out), n_split, a.group, a.head_dim,
            a.kv_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Groups past 16 query rows take the row-block instances; the others
// keep the single-block ones (the same code and registers as before
// row blocks).
template <typename T, typename P, bool kAmla, int kStages>
int launch_k1_ring(const Args& a, const K1Layout& L, int batch, int n_split,
                   float* part, cudaStream_t stream) {
  return a.row_blocks > 1
             ? launch_k1_grid<T, P, kAmla, kStages, true>(a, L, batch,
                                                          n_split, part,
                                                          stream)
             : launch_k1_grid<T, P, kAmla, kStages, false>(a, L, batch,
                                                           n_split, part,
                                                           stream);
}

// The ring's depth is a template argument (the copies' wait takes an
// immediate): bf16 pages plan 2-5 stages, 8-bit 2-4, f32 2-3.
template <typename T, typename P, bool kAmla>
int launch_k1(const Args& a, int batch, int n_split, bool wide, float* part,
              cudaStream_t stream) {
  const K1Layout L = k1_plan_for<P>(a, n_split, wide);
  // A chunk's scores that leave no room for a two-slot ring.
  if (L.total > smem_limit())
    return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (L.stages) {
    case 2:
      return launch_k1_ring<T, P, kAmla, 2>(a, L, batch, n_split, part,
                                            stream);
    case 3:
      return launch_k1_ring<T, P, kAmla, 3>(a, L, batch, n_split, part,
                                            stream);
  }
  if constexpr (!std::is_same<P, float>::value) {
    if (L.stages == 4)
      return launch_k1_ring<T, P, kAmla, 4>(a, L, batch, n_split, part,
                                            stream);
  }
  if constexpr (sizeof(P) == 2) {   // bf16 and fp16 pages
    if (L.stages == 5)
      return launch_k1_ring<T, P, kAmla, 5>(a, L, batch, n_split, part,
                                            stream);
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename T, typename P>
int launch_amla(const Args& a, int batch, bool amla, int n_split, bool wide,
                float* part, cudaStream_t s) {
  return amla ? launch_k1<T, P, true>(a, batch, n_split, wide, part, s)
              : launch_k1<T, P, false>(a, batch, n_split, wide, part, s);
}

// The launch's checks and its 16-row blocks a kv head; 0 or a CUDA error.
// `page_bytes` is a page value's size: K1 stages each token's row in
// 16-byte copies.
int check_args(Args& a, int page_bytes, int n_split, const float* part) {
  const int n_chunks = a.pages_per_seq / a.pages_per_chunk;
  a.row_blocks = (a.group + kMmaRows - 1) / kMmaRows;
  if (a.group < 1 || a.head_dim > 32 * kMaxLaneElems ||
      static_cast<int64_t>(a.num_kv_heads) * a.row_blocks > 65535 ||
      a.head_dim * page_bytes % 16 != 0 || n_split < 1 ||
      (n_split > 1 && (n_split > n_chunks || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
