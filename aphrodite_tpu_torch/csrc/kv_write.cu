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
// What bounds them on an H100: bytes. They do no arithmetic; the least
// time is the K and V rows read once and written once over the 3.35 TB/s
// of device memory.
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
// Each C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// One block per token: copy its K and V rows to slot slots[t]; slots
// outside [0, num_slots) are the padding no-op.
__global__ void kv_write_slots_kernel(uint4* __restrict__ k_flat,
                                      uint4* __restrict__ v_flat,
                                      const uint4* __restrict__ knew,
                                      const uint4* __restrict__ vnew,
                                      const int* __restrict__ slots,
                                      int num_slots, int row_vecs) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= num_slots) return;
  const int64_t dst = static_cast<int64_t>(slot) * row_vecs;
  const int64_t src = static_cast<int64_t>(t) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    k_flat[dst + i] = knew[src + i];
    v_flat[dst + i] = vnew[src + i];
  }
}

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

constexpr int kThreads = 128;

}  // namespace

extern "C" int kv_write_slots(void* k_pages, void* v_pages,
                              const void* knew, const void* vnew,
                              const int* slots, int num_tokens,
                              int num_slots, int row_bytes, void* stream) {
  if (num_tokens > 0) {
    kv_write_slots_kernel<<<num_tokens, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
        static_cast<const uint4*>(knew), static_cast<const uint4*>(vnew),
        slots, num_slots, row_bytes / 16);
  }
  return static_cast<int>(cudaGetLastError());
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
