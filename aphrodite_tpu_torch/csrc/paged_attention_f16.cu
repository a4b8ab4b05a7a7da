// Paged decode attention (K1 and K5, paged_attention.cuh) for float16
// activations, CUDA C++ for sm_90a: the fp16 instances, over fp16, int8
// and fp8 e5m2 pages, and their C entry point. A library of its own, so
// nvcc builds it beside paged_attention.cu's f32 and bf16 instances
// rather than after them.
//
// The JAX package runs no Pallas body at fp16: its layer gates fp16
// pages out of both decode kernels (_pallas_decode_ok) and attends
// through paged_decode_attention_ref, f32 scores, softmax and P.V. These
// instances are K1's kernel with fp16 dot operands (q x scale x log2(e)
// and p rounded to fp16, the sums f32; mma.sync m16n8k16 f16.f16.f32),
// fp16 pages staged in the 2-byte padded slots bf16 pages use, int8 and
// fp8 values widened to fp16 exactly.

#include "paged_attention.cuh"

namespace {

// page_dtype: 2 = int8, 3 = float8 e5m2, 4 = float16.
int dispatch_f16(Args a, int batch, int page_dtype, bool amla, int n_split,
                 bool wide, float* part, cudaStream_t s) {
  if (const int err = check_args(a, page_dtype == 4 ? 2 : 1, n_split,
                                 part))
    return err;
  switch (page_dtype) {
    case 2:
      return launch_amla<__half, int8_t>(a, batch, amla, n_split, wide,
                                         part, s);
    case 3:
      return launch_amla<__half, fp8>(a, batch, amla, n_split, wide, part,
                                      s);
    case 4:
      return launch_amla<__half, __half>(a, batch, amla, n_split, wide,
                                         part, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1 and K5 on fp16 activations (paged_decode_attention's arguments;
// the activation code is 2).
extern "C" int paged_decode_attention_f16(
    void* out, const void* q, void* k_pages, void* v_pages,
    const int* block_tables, const int* context_lens, const float* alibi,
    const void* knew, const void* vnew, int batch, int num_kv_heads,
    int group, int head_dim, int num_pages, int page_size,
    int pages_per_seq, int pages_per_chunk, float qk_scale, float kv_scale,
    int act_dtype, int page_dtype, int amla, int n_split, int wide,
    float* part, void* stream) {
  if (act_dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  Args a{out, q, k_pages, v_pages, block_tables, context_lens, alibi,
         knew, vnew, num_kv_heads, group, head_dim, num_pages, page_size,
         pages_per_seq, pages_per_chunk, 1, qk_scale, kv_scale};
  return dispatch_f16(a, batch, page_dtype, amla != 0, n_split, wide != 0,
                      part, static_cast<cudaStream_t>(stream));
}
