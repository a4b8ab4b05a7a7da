// KV page writers for the token-major paged cache, CUDA C++ for sm_90a.
//
// Pages are [num_pages, page_size, Hkv * head_dim]: one token's K (all
// kv heads) is one contiguous row of `row_bytes` bytes.
//
// Replaces three Pallas TPU kernels of aphrodite_tpu/ops/pallas/kv_write.py:
//   _prefill_write_kernel (kv_write.py:179) -> kv_write_prefill_kernel (K2)
//   _decode_write_kernel  (kv_write.py:90)  -> kv_write_slots_kernel   (K3)
//   _write_kernel         (kv_write.py:38)  -> kv_write_slots_kernel   (K4)
//
// What bounds them on an H100: bytes. They copy, or quantize with a
// division and a rounding a value (8-bit pages), far under the card's
// ratio of operations to bytes; the least time is the K and V rows read
// once and written once over the 3.35 TB/s of device memory.
//
// What the design does about it: the TPU kernels read-modify-write whole
// 8-row windows or whole pages, because a VMEM tile spans 8 page slots.
// On Hopper a row is an independent run of device memory, so each block
// copies exactly the rows it owns with 16-byte vector loads and stores,
// neighbouring threads on neighbouring addresses: no read of the page's
// old contents and no staging buffer. A tail page's rows past `valid`
// are simply not written, which is the TPU kernel's tail merge. Tokens
// that share a page write different rows, so the decode writer (K3,
// sequence-exclusive pages) and the general slot scatter (K4) are one
// kernel, as in the reference's reshape_and_cache.
// The slot writer (K3 / K4, kv_write_slots_kernel) is planned like K2: a
// block takes `rows_per_block` tokens (slot_write_plan, from the token
// count, the row's bytes and the SM count), and each thread issues its
// kSlotVecs 16-byte K loads and as many V loads before its first store.
// It takes the model's bf16, fp16 or f32 rows and writes the page
// dtype's values itself: on int8 and fp8 e5m2 pages it quantizes in
// registers with kv_quant.cuh's codes (K1's fused write's), so an 8-bit
// prompt round writes a layer in one launch where a chain of elementwise
// launches quantized the rows first. The vectors are planned on the page
// side: a thread stores whole 16-byte page vectors, each from one (copy),
// two (bf16 or fp16 -> 8 bits) or four (f32 -> 8 bits) source vectors;
// int8 quotients come from the reciprocal and two fma corrections,
// without a branch a value. The block reads its tokens' slots in one coalesced
// load into shared memory, in one of two orders the plan picks from the
// token count (measured: they cross at 512 tokens on a padded round):
// in a small launch (K3's decode rows) the data loads go out beside the
// slot read, one trip to memory in all, and only the stores of padding
// rows are dropped; in a large one (an 8-bit prompt round, most of its
// rows padding) the slots come first, so padding rows are never read
// and a block of padding returns, and occupancy hides the trip.
// The prompt writer (K2) moves whole pages: a prompt round's K and V over
// a few hundred cells, many of them padding (chip_smoke's first round:
// 256 cells of 32 rows of 2048 bytes, 86 of them live). One block a cell
// kept about two 128-thread blocks on an SM, each thread with one K and
// one V load in flight, about 8 KB an SM: a quarter of the bandwidth.
// Now a block copies `rows_per_block` rows of a cell (grid (cells, row
// groups), both from the wrapper's prefill_write_plan, from shapes
// alone), and each thread issues all of its kPrefillVecs K loads and as
// many V loads before its first store, so four times the blocks each
// keep 32 KB in flight. The source is read once and the pages are not
// read again before the rest of the forward pass has gone through L2, so
// the loads and stores are streaming (ld.global.cs, st.global.cs:
// evict first). A block reads its cell's page id and valid count
// together, one round trip before its data loads; a dead cell's blocks
// return after it. Rows at and past valid are neither read nor
// written.
//
// float16 (fp16 rows into fp16, int8 or fp8 pages; fp16 pages through
// K2): the JAX package writes them with its XLA scatter and quantize_kv,
// the Pallas writers being gated out; these are the same kernels at that
// dtype, fp16 -> fp16 K3 / K4's copy and K2's byte copy, fp16 -> 8 bits
// two quantizing kinds.
//
// Each C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "kv_quant.cuh"

namespace {

constexpr int kPrefillVecs = 4;   // K2: K (and V) vectors a thread's round

// Block (c, y) of threads T: rows [y R, min(valid, (y + 1) R)) of cell c's
// [page_size, row] source slab (rows c*page_size ...) into the same rows
// of page page_ids[c], R = rows_per_block, valid = min(valids[c],
// page_size). In round j thread t takes the rows' 16-byte vectors t +
// T (4 j + u), u < 4, loading all four of K and of V before it stores
// any. Rows at and past valid keep the page's contents; page ids outside
// [0, num_pages) skip the cell.
__global__ void __launch_bounds__(1024)
kv_write_prefill_kernel(uint4* __restrict__ k_pages,
                        uint4* __restrict__ v_pages,
                        const uint4* __restrict__ knew,
                        const uint4* __restrict__ vnew,
                        const int* __restrict__ page_ids,
                        const int* __restrict__ valids, int num_pages,
                        int page_size, int row_vecs, int rows_per_block) {
  const int c = blockIdx.x;
  const int page = page_ids[c];
  const int valid = min(valids[c], page_size);
  const int r0 = static_cast<int>(blockIdx.y) * rows_per_block;
  if (page < 0 || page >= num_pages || valid <= r0) return;
  const int r1 = min(valid, r0 + rows_per_block);
  const int n = (r1 - r0) * row_vecs;
  const int64_t src = (static_cast<int64_t>(c) * page_size + r0) * row_vecs;
  const int64_t dst =
      (static_cast<int64_t>(page) * page_size + r0) * row_vecs;
  const int step = static_cast<int>(blockDim.x);
  for (int i0 = threadIdx.x; i0 < n; i0 += kPrefillVecs * step) {
    uint4 k[kPrefillVecs], v[kPrefillVecs];
#pragma unroll
    for (int u = 0; u < kPrefillVecs; ++u) {
      const int i = i0 + u * step;
      if (i < n) {
        k[u] = __ldcs(knew + src + i);
        v[u] = __ldcs(vnew + src + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kPrefillVecs; ++u) {
      const int i = i0 + u * step;
      if (i < n) {
        __stcs(k_pages + dst + i, k[u]);
        __stcs(v_pages + dst + i, v[u]);
      }
    }
  }
}

// ---------------------------------------------------- K3 / K4: slots --

// The (source, page) pairs of the slot writer: its template argument and
// the C entry point's `kind`. Copies move 16-byte vectors of any dtype
// the source and the pages share.
enum Kind : int {
  kCopy = 0,
  kBf16Int8 = 1,
  kF32Int8 = 2,
  kBf16Fp8 = 3,
  kF32Fp8 = 4,
  kF16Int8 = 5,
  kF16Fp8 = 6,
};

// 16-byte source vectors of one 16-byte page vector.
template <int K>
constexpr int kSrcVecs = K == kCopy ? 1 : (K == kF32Int8 || K == kF32Fp8)
                                              ? 4 : 2;

constexpr int kSlotVecs = 4;   // K (and V) source vectors a thread's round

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 codes of 16 bf16 or fp16 (the high half of a word is the odd
// element; v0, v1) or f32 values (v0-v3), byte b of word w from element
// 4 w + b; bf16 and fp16 values widen to f32 exactly, so a code is the
// one the plain version's f32 arithmetic gives. rcp
// is __frcp_rn(scale) and safe says the scale lies in [2^-60, 2^60).
// Branch-free but for one test a vector: int8 quotients are
// kvq::quotient's unless a value fails kvq::quotient_safe (NaN, inf,
// magnitudes out of range) or the scale does, and then all 16 take the
// IEEE division. A branch a value (__fdiv_rn's own slow-path test) kept
// a warp's 16 values from overlapping and cost a small launch 2-4 us.
// Not inlined: one copy serves every vector of a thread's round.
template <int K>
__device__ __noinline__ uint4 quantize_vec(uint4 v0, uint4 v1, uint4 v2,
                                           uint4 v3, float scale, float rcp,
                                           bool safe) {
  constexpr bool kF32 = K == kF32Int8 || K == kF32Fp8;
  constexpr bool kF16 = K == kF16Int8 || K == kF16Fp8;
  constexpr bool kFp8 = K == kBf16Fp8 || K == kF32Fp8 || K == kF16Fp8;
  const uint4 v[4] = {v0, v1, v2, v3};
  float x[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if constexpr (kF32) {
      x[e] = __uint_as_float(word(v[e / 4], e % 4));
    } else if constexpr (kF16) {
      const uint32_t h = word(v[e / 8], (e % 8) / 2);
      x[e] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(e % 2 ? h >> 16 : h & 0xFFFFu)));
    } else {
      const uint32_t h = word(v[e / 8], (e % 8) / 2);
      x[e] = __uint_as_float(e % 2 ? h & 0xFFFF0000u : h << 16);
    }
  }
  uint32_t code[16];
  if constexpr (kFp8) {
#pragma unroll
    for (int e = 0; e < 16; ++e) code[e] = kvq::fp8_code(x[e]);
  } else {
    float q[16];
    bool ok = safe;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      q[e] = kvq::quotient(x[e], scale, rcp);
      ok &= kvq::quotient_safe(x[e]);
    }
    if (!ok) {
#pragma unroll
      for (int e = 0; e < 16; ++e) q[e] = __fdiv_rn(x[e], scale);
    }
#pragma unroll
    for (int e = 0; e < 16; ++e)
      code[e] = static_cast<uint8_t>(kvq::int8_of(q[e]));
  }
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 4; ++w)
    out[w] = code[4 * w] | code[4 * w + 1] << 8 | code[4 * w + 2] << 16 |
             code[4 * w + 3] << 24;
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// One page vector of kind K from its kSrcVecs<K> source vectors at v.
template <int K>
__device__ __forceinline__ uint4 to_page(const uint4* v, float scale,
                                         float rcp, bool safe) {
  if constexpr (K == kCopy)
    return v[0];
  else if constexpr (kSrcVecs<K> == 2)
    return quantize_vec<K>(v[0], v[1], v[0], v[1], scale, rcp, safe);
  else
    return quantize_vec<K>(v[0], v[1], v[2], v[3], scale, rcp, safe);
}

// A streaming 16-byte load (ld.global.cs, as __ldcs) the compiler keeps
// where it is written: before the slot read and the barrier, not sunk to
// the store that uses it.
__device__ __forceinline__ uint4 load_cs(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ bool slot_live(int slot, int num_slots) {
  return slot >= 0 && slot < num_slots;
}

// One round of a thread: its items i0 + step u, u < kU, of the block's
// rows, item i page vector i % row_vecs of row i / row_vecs. The thread
// walks its items with a cursor (row, vector) advanced by step an item,
// (step / row_vecs, step % row_vecs) with a carry, so no item divides.
// place() records this round's items and advances the cursor; load()
// issues the source loads of every item in the block's rows, skipping
// rows whose slot is out of range when kSkipDead (the slots are in
// s_slot then); store() converts and stores the items of live rows.
template <int K>
struct SlotRound {
  static constexpr int kSrc = kSrcVecs<K>;
  static constexpr int kU = kSlotVecs / kSrc;
  uint4 k[kSlotVecs], v[kSlotVecs];
  int row[kU], col[kU];

  __device__ __forceinline__ void place(int& r, int& c, int step_r,
                                        int step_c, int row_vecs) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      row[u] = r;
      col[u] = c;
      r += step_r;
      c += step_c;
      if (c >= row_vecs) {
        c -= row_vecs;
        ++r;
      }
    }
  }

  template <bool kSkipDead>
  __device__ __forceinline__ void load(const uint4* __restrict__ knew,
                                       const uint4* __restrict__ vnew,
                                       const int* s_slot, int t0, int nrows,
                                       int row_vecs, int num_slots) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (row[u] >= nrows) continue;
      if (kSkipDead && !slot_live(s_slot[row[u]], num_slots)) continue;
      const int64_t src =
          (static_cast<int64_t>(t0 + row[u]) * row_vecs + col[u]) * kSrc;
#pragma unroll
      for (int w = 0; w < kSrc; ++w) {
        k[u * kSrc + w] = load_cs(knew + src + w);
        v[u * kSrc + w] = load_cs(vnew + src + w);
      }
    }
  }

  __device__ __forceinline__ void store(uint4* __restrict__ k_pages,
                                        uint4* __restrict__ v_pages,
                                        const int* s_slot, int nrows,
                                        int row_vecs, int num_slots,
                                        float scale, float rcp,
                                        bool safe) const {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (row[u] >= nrows) continue;
      const int slot = s_slot[row[u]];
      if (!slot_live(slot, num_slots)) continue;
      const int64_t dst = static_cast<int64_t>(slot) * row_vecs + col[u];
      __stcs(k_pages + dst, to_page<K>(k + u * kSrc, scale, rcp, safe));
      __stcs(v_pages + dst, to_page<K>(v + u * kSrc, scale, rcp, safe));
    }
  }
};

// Block b of threads T: tokens [b R, min(num_tokens, (b + 1) R)), R =
// rows_per_block, each token's K and V rows into the page row of its
// slot (row_vecs 16-byte page vectors; the source rows hold
// kSrcVecs<K> times as many); slots outside [0, num_slots) are the
// padding no-op. (step_r, step_c) = (T / row_vecs, T % row_vecs) and
// row_magic = ceil(2^32 / row_vecs) come from the host. The R slots go to shared memory in one coalesced load:
// after the first round's data loads are issued (kSlotFirst false), or
// before any data load, a block of padding returning there (true).
template <int K, bool kSlotFirst>
__global__ void __launch_bounds__(256)
kv_write_slots_kernel(uint4* __restrict__ k_pages,
                      uint4* __restrict__ v_pages,
                      const uint4* __restrict__ knew,
                      const uint4* __restrict__ vnew,
                      const int* __restrict__ slots, int num_tokens,
                      int num_slots, int row_vecs, int rows_per_block,
                      int step_r, int step_c, uint64_t row_magic,
                      float scale) {
  extern __shared__ int s_slot[];
  const int t0 = static_cast<int>(blockIdx.x) * rows_per_block;
  const int nrows = min(rows_per_block, num_tokens - t0);
  const int tid = static_cast<int>(threadIdx.x);
  // Thread t < nrows reads slot t0 + t (the plan keeps R <= T).
  const int slot = tid < nrows ? slots[t0 + tid] : num_slots;
  // The cursor starts at item tid: row tid / row_vecs by the host's
  // ceil(2^32 / row_vecs), exact for tid and row_vecs below 2^16.
  int r = static_cast<int>((static_cast<uint64_t>(tid) * row_magic) >> 32);
  int c = tid - r * row_vecs;
  const float rcp = __frcp_rn(scale);
  const bool safe = kvq::quotient_safe(scale) && scale > 0.f;
  SlotRound<K> rnd;
  if constexpr (kSlotFirst) {
    if (tid < nrows) s_slot[tid] = slot;
    if (!__syncthreads_or(slot_live(slot, num_slots))) return;
  }
  // Every thread runs the first round (the barrier there is the block's),
  // then its own rounds while its cursor is in the block's rows.
  bool first = !kSlotFirst;
  do {
    rnd.place(r, c, step_r, step_c, row_vecs);
    rnd.template load<kSlotFirst>(knew, vnew, s_slot, t0, nrows, row_vecs,
                                  num_slots);
    if (first) {
      if (tid < nrows) s_slot[tid] = slot;
      __syncthreads();
      first = false;
    }
    rnd.store(k_pages, v_pages, s_slot, nrows, row_vecs, num_slots, scale,
              rcp, safe);
  } while (r < nrows);
}

template <int K>
cudaError_t launch_slots(dim3 grid, int threads, size_t smem, bool first,
                         cudaStream_t stream, uint4* k_pages,
                         uint4* v_pages, const uint4* knew,
                         const uint4* vnew, const int* slots,
                         int num_tokens, int num_slots, int row_vecs,
                         int rows_per_block, float scale) {
  const int step_r = threads / row_vecs;
  const int step_c = threads - step_r * row_vecs;
  const uint64_t magic = ((uint64_t{1} << 32) + row_vecs - 1) / row_vecs;
  if (first)
    kv_write_slots_kernel<K, true><<<grid, threads, smem, stream>>>(
        k_pages, v_pages, knew, vnew, slots, num_tokens, num_slots,
        row_vecs, rows_per_block, step_r, step_c, magic, scale);
  else
    kv_write_slots_kernel<K, false><<<grid, threads, smem, stream>>>(
        k_pages, v_pages, knew, vnew, slots, num_tokens, num_slots,
        row_vecs, rows_per_block, step_r, step_c, magic, scale);
  return cudaGetLastError();
}

}  // namespace

// K3 / K4: grid ceil(num_tokens / rows_per_block) of `threads` threads (a
// multiple of 32, at most 256, no fewer than rows_per_block) and
// rows_per_block ints of shared memory,
// as the wrapper's slot_write_plan gives them; `kind` the (source, page)
// pair (Kind), `row_bytes` a page row's bytes, `scale` int8's S.
extern "C" int kv_write_slots(void* k_pages, void* v_pages,
                              const void* knew, const void* vnew,
                              const int* slots, int num_tokens,
                              int num_slots, int row_bytes, int kind,
                              int rows_per_block, int threads,
                              int slot_first, float scale, void* stream) {
  if (num_tokens <= 0) return static_cast<int>(cudaGetLastError());
  if (rows_per_block < 1 || rows_per_block > threads || threads > 256 ||
      threads % 32 != 0 || row_bytes % 16 != 0 || row_bytes <= 0 ||
      row_bytes / 16 > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_tokens + rows_per_block - 1) / rows_per_block);
  const size_t smem = sizeof(int) * rows_per_block;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* kp = static_cast<uint4*>(k_pages);
  auto* vp = static_cast<uint4*>(v_pages);
  const auto* kn = static_cast<const uint4*>(knew);
  const auto* vn = static_cast<const uint4*>(vnew);
  const int row_vecs = row_bytes / 16;
  const bool first = slot_first != 0;
  cudaError_t err;
  switch (kind) {
    case kCopy:
      err = launch_slots<kCopy>(grid, threads, smem, first, st, kp, vp, kn,
                                vn, slots, num_tokens, num_slots, row_vecs,
                                rows_per_block, scale);
      break;
    case kBf16Int8:
      err = launch_slots<kBf16Int8>(grid, threads, smem, first, st, kp, vp,
                                    kn, vn, slots, num_tokens, num_slots,
                                    row_vecs, rows_per_block, scale);
      break;
    case kF32Int8:
      err = launch_slots<kF32Int8>(grid, threads, smem, first, st, kp, vp,
                                   kn, vn, slots, num_tokens, num_slots,
                                   row_vecs, rows_per_block, scale);
      break;
    case kBf16Fp8:
      err = launch_slots<kBf16Fp8>(grid, threads, smem, first, st, kp, vp,
                                   kn, vn, slots, num_tokens, num_slots,
                                   row_vecs, rows_per_block, scale);
      break;
    case kF32Fp8:
      err = launch_slots<kF32Fp8>(grid, threads, smem, first, st, kp, vp,
                                  kn, vn, slots, num_tokens, num_slots,
                                  row_vecs, rows_per_block, scale);
      break;
    case kF16Int8:
      err = launch_slots<kF16Int8>(grid, threads, smem, first, st, kp, vp,
                                   kn, vn, slots, num_tokens, num_slots,
                                   row_vecs, rows_per_block, scale);
      break;
    case kF16Fp8:
      err = launch_slots<kF16Fp8>(grid, threads, smem, first, st, kp, vp,
                                  kn, vn, slots, num_tokens, num_slots,
                                  row_vecs, rows_per_block, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K2: grid (num_cells, ceil(page_size / rows_per_block)) of `threads`
// threads (a multiple of 32, at most 1024), as the wrapper's
// prefill_write_plan gives them.
extern "C" int kv_write_prefill(void* k_pages, void* v_pages,
                                const void* knew, const void* vnew,
                                const int* page_ids, const int* valids,
                                int num_cells, int num_pages, int page_size,
                                int row_bytes, int rows_per_block,
                                int threads, void* stream) {
  if (num_cells <= 0) return static_cast<int>(cudaGetLastError());
  const int groups = (page_size + rows_per_block - 1) /
                     (rows_per_block > 0 ? rows_per_block : 1);
  if (rows_per_block < 1 || groups > 65535 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  kv_write_prefill_kernel<<<dim3(num_cells, groups), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const uint4*>(knew), static_cast<const uint4*>(vnew),
      page_ids, valids, num_pages, page_size, row_bytes / 16,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
