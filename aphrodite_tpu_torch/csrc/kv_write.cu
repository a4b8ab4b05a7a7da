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

// One block per cell: rows r < valids[c] of the cell's [page_size, row]
// source slab (rows c*page_size ...) into page page_ids[c]; rows at and
// past valid keep the page's contents. Page ids outside
// [0, num_pages) skip the cell.
__global__ void kv_write_prefill_kernel(uint4* __restrict__ k_pages,
                                        uint4* __restrict__ v_pages,
                                        const uint4* __restrict__ knew,
                                        const uint4* __restrict__ vnew,
                                        const int* __restrict__ page_ids,
                                        const int* __restrict__ valids,
                                        int num_pages, int page_size,
                                        int row_vecs) {
  const int c = blockIdx.x;
  const int page = page_ids[c];
  if (page < 0 || page >= num_pages) return;
  int valid = valids[c];
  valid = valid < page_size ? valid : page_size;
  if (valid <= 0) return;
  const int64_t n = static_cast<int64_t>(valid) * row_vecs;
  const int64_t dst = static_cast<int64_t>(page) * page_size * row_vecs;
  const int64_t src = static_cast<int64_t>(c) * page_size * row_vecs;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    k_pages[dst + i] = knew[src + i];
    v_pages[dst + i] = vnew[src + i];
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

extern "C" int kv_write_prefill(void* k_pages, void* v_pages,
                                const void* knew, const void* vnew,
                                const int* page_ids, const int* valids,
                                int num_cells, int num_pages, int page_size,
                                int row_bytes, void* stream) {
  if (num_cells > 0) {
    kv_write_prefill_kernel<<<num_cells, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
        static_cast<const uint4*>(knew), static_cast<const uint4*>(vnew),
        page_ids, valids, num_pages, page_size, row_bytes / 16);
  }
  return static_cast<int>(cudaGetLastError());
}
