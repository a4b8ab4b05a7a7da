// Paged decode attention (K1 and K5, paged_attention.cuh) for float32 and
// bfloat16 activations, CUDA C++ for sm_90a: the instances and C entry
// points of this library. The fp16 activations' instances are
// paged_attention_f16.cu's, built beside it.

#include "paged_attention.cuh"

namespace {

// act_dtype (q, out, knew/vnew): 0 = float32, 1 = bfloat16.
// page_dtype: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8 e5m2;
// float pages take the activation dtype.
int dispatch(Args a, int batch, int act_dtype, int page_dtype,
             bool amla, int n_split, bool wide, float* part,
             cudaStream_t s) {
  const int page_bytes = page_dtype == 0 ? (act_dtype == 0 ? 4 : 2)
                                         : (page_dtype == 1 ? 2 : 1);
  if (const int err = check_args(a, page_bytes, n_split, part)) return err;
  if (act_dtype == 0) {
    switch (page_dtype) {
      case 0:
        return launch_amla<float, float>(a, batch, amla, n_split, wide,
                                         part, s);
      case 2:
        return launch_amla<float, int8_t>(a, batch, amla, n_split,
                                          wide, part, s);
      case 3:
        return launch_amla<float, fp8>(a, batch, amla, n_split, wide,
                                       part, s);
    }
  } else if (act_dtype == 1) {
    switch (page_dtype) {
      case 1:
        return launch_amla<__nv_bfloat16, __nv_bfloat16>(
            a, batch, amla, n_split, wide, part, s);
      case 2:
        return launch_amla<__nv_bfloat16, int8_t>(a, batch, amla,
                                                  n_split, wide, part, s);
      case 3:
        return launch_amla<__nv_bfloat16, fp8>(a, batch, amla, n_split,
                                               wide, part, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1 and K5 (the same launch); n_split > 1 adds the merge.
extern "C" int paged_decode_attention(
    void* out, const void* q, void* k_pages, void* v_pages,
    const int* block_tables, const int* context_lens, const float* alibi,
    const void* knew, const void* vnew, int batch, int num_kv_heads,
    int group, int head_dim, int num_pages, int page_size,
    int pages_per_seq, int pages_per_chunk, float qk_scale, float kv_scale,
    int act_dtype, int page_dtype, int amla, int n_split, int wide,
    float* part, void* stream) {
  Args a{out, q, k_pages, v_pages, block_tables, context_lens, alibi,
         knew, vnew, num_kv_heads, group, head_dim, num_pages, page_size,
         pages_per_seq, pages_per_chunk, 1, qk_scale, kv_scale};
  return dispatch(a, batch, act_dtype, page_dtype, amla != 0, n_split,
                  wide != 0, part, static_cast<cudaStream_t>(stream));
}

// K1's dynamic shared memory per block, as its launcher plans it for a
// page type (the codes of paged_decode_attention, 4 = float16), slot
// width and split count on the current device; -1 if it does not fit.
extern "C" long long paged_decode_smem_bytes(int page_dtype, int wide,
                                             int group, int head_dim,
                                             int page_size,
                                             int pages_per_chunk,
                                             int pages_per_seq,
                                             int n_split) {
  Args a{};
  a.group = group;
  a.head_dim = head_dim;
  a.page_size = page_size;
  a.pages_per_chunk = pages_per_chunk;
  a.pages_per_seq = pages_per_seq;
  K1Layout L;
  switch (page_dtype) {
    case 0: L = k1_plan_for<float>(a, n_split, wide != 0); break;
    case 1: L = k1_plan_for<__nv_bfloat16>(a, n_split, wide != 0); break;
    case 2: L = k1_plan_for<int8_t>(a, n_split, wide != 0); break;
    case 3: L = k1_plan_for<fp8>(a, n_split, wide != 0); break;
    case 4: L = k1_plan_for<__half>(a, n_split, wide != 0); break;
    default: return -1;
  }
  return L.total > smem_limit() ? -1 : static_cast<long long>(L.total);
}
