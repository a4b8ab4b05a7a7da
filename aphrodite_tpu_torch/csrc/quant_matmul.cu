// GPTQ, AWQ and GGUF quantized matmuls and per-row int8 activation
// quantization, CUDA C++ for sm_90a.
//
// Replaces the twelve Pallas TPU kernels of
// aphrodite_tpu/ops/pallas/quant_matmul.py (K6-K17). K6, K10 and, at
// m > 64, K12 and K16 (bf16 and f32 x), and above 13-16 rows K13, K14
// and K17 are one templated kernel, quant_gemm_kernel (warp-specialized
// wgmma, below), with a word decoder each; K8, K11 and, above 12 rows,
// K15 are one templated kernel, w8a8_gemm_kernel (s8 wgmma and a
// per-group fold, below), with a decoder each; K7 and, at m <= 64, K12
// and K16 (bf16 and f32 x), and up to 12-16 rows K13, K14, K15 and K17
// are one templated kernel, quant_stream_kernel (a cp.async ring and W
// dequantized straight into mma.sync fragments, below), with a decoder
// each:
//   _gguf_q4k_kernel (:1117)   -> quant_stream_kernel<4, kQ4k> at m <= 64,
//                                 quant_gemm_kernel<4, kQ4k> above (K12,
//                                 Q4_K exact)
//   _sqllm_kernel (:1630)      -> quant_stream_kernel<4, kLut> at m <= 64,
//                                 quant_gemm_kernel<4, kLut> above (K16,
//                                 bf16 x); quant_stream_kernel<4,
//                                 kLutX32> at m <= 64, split_x32_kernel
//                                 then quant_gemm_kernel<4, kLutX32> above
//                                 (K16, f32 x)
//   _int8_kernel (:1706)       -> quant_stream_kernel<8, kInt8> at m <= 16,
//                                 quant_gemm_kernel<8, kInt8> above (K17,
//                                 int8 per column)
//   _gguf_q8_kernel (:1210)    -> quant_stream_kernel<8, kQ8> at m <= 16,
//                                 quant_gemm_kernel<8, kQ8> above (K13,
//                                 Q8_0)
//   _gguf_i8g_kernel (:1476)   -> quant_stream_kernel<8, kI8g> at m <= 13,
//                                 quant_gemm_kernel<8, kI8g> above (K14,
//                                 grouped int8)
//   _gguf_w8a8_kernel (:1551)  -> quant_stream_kernel<8, kQs8, a8> at
//                                 m <= 12, w8a8_gemm_kernel<kQs8> above
//                                 (K15, W8A8)
//   _kernel (:554)          -> quant_gemm_kernel<BITS, kGptq> (K6)
//   _stream_kernel (:308)   -> quant_stream_kernel<BITS, kGptq / kAwq>,
//                              8-64 rows, split K, a16 and a8 arms (K7)
//   _gptq_a8_kernel, _gptq_a8_deferred_kernel (:1274, :1311)
//                           -> w8a8_gemm_kernel<kGptq4> (K8)
//   _quant8_kernel (:781)   -> quant8_kernel<V> (K9)
//   _awq_kernel (:718)      -> quant_gemm_kernel<4, kAwq> (K10)
//   _awq_a8_kernel, _awq_a8_deferred_kernel (:937, :971)
//                           -> w8a8_gemm_kernel<kAwq4> (K11)
//
// Layouts; scales [G, N] bf16, G = K / group_size, group g spans rows
// [g*gs, (g+1)*gs):
// - GPTQ (AutoGPTQ v1): qweight [K / pack, N] int32 packs pack = 32 / bits
//   codes along K, row k in word k / pack at shift bits * (k % pack);
//   qzeros [G, N / pack] int32 packs the stored zero points along N.
//   Dequant: w[k, n] = (q[k, n] - (z[g, n] + 1)) * s[g, n] (the AutoGPTQ +1).
// - AWQ (llm-awq, 4 bits): qweight [K, N / 8] int32 packs 8 codes along N,
//   interleaved: column 8j + e of row k in word (k, j) at shift
//   4 * {0, 4, 1, 5, 2, 6, 3, 7}[e]; qzeros [G, N / 8] packed the same way.
//   Dequant: w[k, n] = (q[k, n] - z[g, n]) * s[g, n] (the zero as stored).
//
// What bounds them on an H100:
// - K7, and K12 and K16 at m <= 64 (every decode step): bytes. Each int4
//   weight is used by at most 64 rows; the least time is the packed
//   weight read once over 3.35 TB/s (8.8 us for down_proj at Mistral-7B
//   width).
// - K6 / K10 (m > 64: prompt rounds, decode batches above 64): bf16
//   operations at large m (989 TFLOP/s: 1.81 ms per Mistral-7B layer at
//   m 4096), bytes below a few hundred rows. Inside the SM the limit is
//   shared memory: every chunk's x tile and packed words land there, the
//   dequantized bf16 W tile is written there and wgmma reads x once and
//   W twice (once per consumer warpgroup), about 36 bytes of shared
//   traffic per thousand operations.
// - K8 / K11 and K15 at m > 64: int8 operations at large m (1979 TOP/s:
//   0.90 ms per Mistral-7B layer at m 4096), bytes below a few hundred
//   rows.
// - K9: bytes (x read once, the int8 copy and the row scales written once);
//   at decode (1-64 rows) the launch itself.
// - K13-K15 and K17: bytes at decode (the int8 weight and its bf16 scale
//   rows or f32 column scales read once: 0.066-0.073 ms per layer at
//   Mistral-7B width, about twice K7's int4 bound), operations at prompt
//   rounds (bf16 for K13/K14/K17, int8 for K15).
// - K12 and K16: bytes at decode (4-bit codes with K12's bf16 dl/ml rows
//   per 32 input rows or K16's 16-entry codebook per column), bf16
//   operations at prompt rounds; K16 on f32 x does three bf16 products
//   per term, so three times the bf16 operations.
//
// What the design does about it.
// K6 / K10 (quant_gemm_kernel): a block owns 128 rows x 256 columns of
// the output, so each dequantized W element serves 128 rows and each x
// element 256 columns. One loader thread keeps a 5-stage ring (3 at 8
// bits) of 64-deep chunks in flight with TMA: the x tile in the 128-byte
// swizzle wgmma reads, the packed words, the group's scale and zero
// rows, each stage on one mbarrier. Two consumer warpgroups run wgmma
// m64n256k16 (bf16 into f32) on the x stage and a bf16 W tile, and
// while the tensor cores run chunk t's products they dequantize chunk
// t + 1's words into the next of three W tiles (GPTQ: one column's
// word into one 16-byte piece of the K-major tile; AWQ: one row's word,
// 8 columns, into one piece of the MN-major tile; the AWQ interleave
// puts columns 2e and 2e + 1 at nibbles e and e + 4, so one mask gives
// a bf16 pair). Each W value is bf16(float(q - z) * s), as the plain
// version rounds it: 128 + q and 128 + z are exact in bf16, so is their
// difference, and one bf16 multiply rounds the product once. Blocks walk
// groups of 8 row tiles column by column, so the blocks in flight share
// x and W tiles in L2. Where the 128 x 256 tiles fall short of the SMs
// (decode batches of 65-256 rows) the groups are split over blocks
// (gemm_plan in the wrapper) and split_reduce_kernel adds the f32
// partials in split order. The GGUF products at m > 64 (K12-K14), K16 on
// bf16 x and K17 take the same kernel with their own decoders (K12's
// words are GPTQ's 4-bit layout with a (dl, ml) pair per 32 rows in place
// of the scale and zero; K13's and K14's bytes the MN-major tile, a scale
// row per 32 or 16 rows; K16 K12's words through a per-column codebook
// held in shared memory for the whole block; K17 K13's bytes with no
// rows, its f32 column scale in the epilogue), 64-row chunks as the
// split unit and two W tiles. K16 on f32 x (QuIP#) takes it on 128 x 128
// tiles: a pass before it splits x into bf16 hi and lo rows, the loader
// brings both x tiles, the codebook decoder writes a hi and a lo W tile,
// and each k16 takes three wgmma products (x_lo w_hi + x_hi w_lo + x_hi
// w_hi) into the f32 sums.
// K8 / K11 / K15 (w8a8_gemm_kernel): K6's structure for int8 x, 128 x 128
// tiles, s8 wgmma into exact int32 group dots folded into f32 in group
// order; its decoders turn the weight's chunk into a K-major s8 tile
// (K15 transposes its bytes; K8's GPTQ words are K-major already, one
// column's two words one 16-byte piece; K11's AWQ words get a nibble
// transpose). The two TPU W4A8 bodies (classic and deferred rescale)
// differ only in the f32 summation order; the one kernel computes both.
// K7, K12, K16 at m <= 64 and K13, K14, K15, K17 up to 12-16 rows: see
// quant_stream_kernel below. K9: see quant8_kernel, at the end.
//
// Each C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError(). Build without --use_fast_math: K9's
// division must be IEEE and its rounding rintf (half to even), so that it
// equals its plain version exactly.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

// Second pass of a split-K launch: out = OutT(sum over splits, in order,
// times the A8 row scale when xs is given, times the column scale when cs
// is given).
template <typename OutT>
__global__ void split_reduce_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ cs,
                                    OutT* __restrict__ out,
                                    int splits, int m, int N) {
  const size_t total = static_cast<size_t>(m) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * total + i];
  if (xs != nullptr) v *= xs[i / N];
  if (cs != nullptr) v *= cs[i % N];
  if constexpr (std::is_same<OutT, float>::value) {
    out[i] = v;
  } else {
    out[i] = __float2bfloat16(v);
  }
}

// ------------------------------------------------------------ K6 / K10 --
//
// quant_gemm_kernel<BITS, D>: the W4A16 / W8A16 product at m > 64 (see
// the header), and the GGUF, SqueezeLLM and int8-weight products at
// m > 64, where the split unit is one 64-row chunk: K14's (D kI8g: the
// codes are bytes, the scale rows come four to a chunk, there is no zero
// row), K13's (kQ8: K14's layout with two scale rows a chunk), K12's
// (kQ4k: GPTQ's 4-bit words, two dl rows where GPTQ has a scale row, two
// ml rows where it has a zero row), K16's (kLut: K12's words and no rows;
// the block's [16, 256] slice of the codebook loaded once into shared
// memory beside the ring) and K17's (kInt8: K13's bytes and no rows; the
// column scales times the f32 sums in the epilogue, or in
// split_reduce_kernel after a split); and K16's on f32 x (kLutX32: x
// split beforehand into bf16 hi and lo rows by split_x32_kernel, both x
// tiles in each stage, the f32 codebook's entries split into (hi | lo <<
// 16) words, hi and lo W tiles, three products a k16 on 128 x 128 tiles,
// f32 out). One block owns 128 rows x 256 columns of
// the output and walks its quantization groups in 64-deep chunks:
//   - warp 8, the loader: one thread keeps a ring of kStages chunks in
//     flight with TMA (the x tile in the 128-byte swizzle, the packed
//     words, the group's scale row and zero row, all on one mbarrier);
//   - warpgroups 0 and 1, the consumers: 64 rows each, wgmma m64n256k16
//     bf16 into 128 f32 accumulators per thread, A (x) and B (W) both
//     read from shared memory in the 128-byte swizzle; while the tensor
//     cores run a chunk, all 256 threads dequantize the next chunk's
//     words into the next of three bf16 W tiles.
// Full and empty mbarriers hand the stages between loader and
// consumers; one consumer barrier per chunk publishes the W tile.
namespace gemm {

constexpr int kBM = 128;                    // rows per block
constexpr int kBN = 256;                    // columns per block
constexpr int kBK = 64;                     // k per chunk
constexpr int kThreads = 288;               // consumers 0-255, loader
constexpr int kWtTiles = 3;                 // bf16 W tiles in the ring
constexpr int kXBytes = kBM * kBK * 2;      // one x stage, 16 KB
constexpr int kWtBytes = kBN * kBK * 2;     // one bf16 W tile, 32 KB

// The word decoders: GPTQ and AWQ packed codes (K6, K10), GGUF's forms
// (no zero point): grouped int8 (K14: int8 codes [K, N], a bf16 scale row
// per 16 input rows), Q8_0 (K13: the same codes, a scale row per 32) and
// exact Q4_K (K12: GPTQ's 4-bit K-major words [K / 8, N], a bf16 (dl, ml)
// pair of rows per 32 input rows); and two with no rows per chunk:
// SqueezeLLM's (K16 on bf16 x: K12's words, each code looked up in its
// column's 16-entry bf16 codebook, lut [N, 16]) and int8 weights' (K17:
// K13's codes as they are, times an f32 scale per column in the
// epilogue); and K16's on f32 x (kLutX32: QuIP#'s f32 codebook lut [N,
// 16], each entry split into bf16 hi and lo).
enum class Dec { kGptq, kAwq, kI8g, kQ8, kQ4k, kLut, kInt8, kLutX32 };

template <int BITS, Dec D>
struct Cfg {
  static constexpr int kPack = 32 / BITS;
  // K16 on f32 x: x and W each as bf16 hi and lo tiles, three products a
  // term, on 128 x 128 tiles (at 256 columns two sets of hi and lo W tiles
  // would take 128 KB of the 227).
  static constexpr bool kX32 = D == Dec::kLutX32;
  static constexpr int kCols = kX32 ? 128 : kBN;    // columns a block
  static constexpr int kAcc = kCols / 2;            // f32 sums a thread
  // K12-K14, K16 and K17: every chunk is whole (64 rows of whole scale
  // groups, where there are any), and one chunk is the split unit.
  static constexpr bool kChunked = D == Dec::kI8g || D == Dec::kQ8 ||
                                   D == Dec::kQ4k || D == Dec::kLut ||
                                   D == Dec::kInt8 || kX32;
  // Byte codes [K, N] (K13, K14, K17), read as rows of 256 columns.
  static constexpr bool kBytes =
      D == Dec::kI8g || D == Dec::kQ8 || D == Dec::kInt8;
  // 4-bit codes 8 rows to a word, [K / 8, N] (K12, K16).
  static constexpr bool kNibWords =
      D == Dec::kQ4k || D == Dec::kLut || kX32;
  // The W tile wgmma reads: K-major (W^T rows of 64 k) where a word holds
  // one column's k rows (GPTQ, K12, K16), else MN-major.
  static constexpr bool kKMajor = D == Dec::kGptq || kNibWords;
  // The chunked decoders keep two W tiles, not three, for a fourth (K13,
  // K14, K17) or fifth (K12, K16) stage: with 24-34 KB stages the loads
  // are latency-bound, so bytes in flight set the rate (K12's five stages
  // and three tiles would pass the 232 448-byte opt-in limit by 80). K16
  // on f32 x: two sets of hi and lo tiles, four stages of 36 KB.
  static constexpr int kWt = kChunked ? 2 : kWtTiles;
  static constexpr int kStages =
      kBytes || kX32 ? 4 : kNibWords ? 5 : BITS == 8 ? 3 : 5;
  static constexpr int kWordBytes = kBK * kCols * BITS / 8;   // packed W
  // One stage's x (K16 on f32 x: the hi tile, then the lo tile) and one
  // set of W tiles (hi, then lo).
  static constexpr int kXStage = kX32 ? 2 * kXBytes : kXBytes;
  static constexpr int kWtSet = kX32 ? 2 * kCols * kBK * 2 : kWtBytes;
  // Scale rows a chunk: one (GPTQ, AWQ), K14's four (a row per 16 of its
  // 64 k), K13's and K12's two (a row per 32), none for K16 and K17.
  static constexpr int kSRows = D == Dec::kI8g                   ? 4
                                : D == Dec::kQ8 || D == Dec::kQ4k ? 2
                                : kChunked                        ? 0
                                                                  : 1;
  static constexpr int kSBytes = kBN * 2 * kSRows;
  // The zero row (GPTQ, AWQ) or K12's ml rows; none for the others.
  static constexpr int kZBytes = D == Dec::kQ4k ? kSBytes
                                 : kChunked     ? 0
                                                : kBN * BITS / 8;
  static constexpr int kBarBytes = 8 * 2 * kStages;
  // Bytes one stage's TMA loads bring (x counted only when TMA loads it).
  static constexpr int kWsBytes = kWordBytes + kSBytes + kZBytes;
  static constexpr int kSmemBytes =
      1024 + kStages * (kXStage + kWordBytes + kSBytes + kZBytes) +
      kWt * kWtSet + kBarBytes;
  // K16's codebook tile (`lut_smem`, static shared memory) beside the
  // dynamic ring; a block's whole shared memory.
  static constexpr int kLutBytes =
      D == Dec::kLut || kX32 ? 16 * kCols * 4 : 0;
  static constexpr int kBlockSmemBytes = kSmemBytes + kLutBytes;
  static_assert(kBlockSmemBytes <= 232448, "the opt-in limit per block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 2-D TMA load of the box at (c0 inner, c1 outer) of `map` into shared
// memory at `dst`, completing `bytes` on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}
// Generic-proxy writes to shared memory (st.shared) become visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Arrive, and expect `bytes` more of TMA completions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t addr, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok) : "r"(addr), "r"(parity) : "memory");
  return ok != 0;
}
// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 2^24 polls (seconds) means a lost arrival: trap, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t i = 0; !mbar_try(addr, parity); ++i)
    if (i == (1u << 24)) __trap();
}

// A wgmma shared-memory descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// d[64 x 256] = A[64 x 16] B[16 x 256] (+ d unless scale_d is 0), bf16
// into f32; B K-major (TNSPB 0: W^T rows of 64 k) or MN-major (TNSPB 1:
// W rows of 64 n). The first product of a tile takes scale_d 0, so no
// other instruction defines the accumulators (which made ptxas serialize
// the products).
template <int TNSPB>
__device__ __forceinline__ void wgmma_256(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TNSPB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// d[64 x 128] = A[64 x 16] B[16 x 128] (+ d unless scale_d is 0), bf16
// into f32, B K-major (K16 on f32 x).
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}

// Exact bf16x2 arithmetic (sm_90): one rounding each.
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&v));
}
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K16 on f32 x: hi = bf16(v), lo = bf16(v - hi) for v = a and b, as
// bf16x2 pairs: v - hi is exact in f32 (the rounding error of an 8-bit
// significand), so hi + lo is within 2^-17 |v| of v (lo keeps 8 of its
// up to 16 bits).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf2(a - f.x, b - f.y);
}

// (a & b) | c.
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (v & 0x000f000f) | 0x43004300: two 4-bit codes q as bf16 128 + q.
__device__ __forceinline__ uint32_t nib2(uint32_t v) {
  return and_or(v, 0x000f000fu, 0x43004300u);
}

// K17: the int8 codes b0, b1 of `w` picked by `sel` (0x4140: bytes 0
// and 1; 0x4342: bytes 2 and 3) as a bf16 pair, exactly. The byte
// permute sets 0x43 above each code (bf16 bits 0x43bb); one AND keeps
// bf16 128 + (b & 0x7f), another bf16 128 + 128 (b >> 7); their bf16x2
// difference is (b & 0x7f) - 128 (b >> 7) = q, exact (integers below
// 2^8). Four instructions a pair, two a code.
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0x43434343u, sel);
  return bf2_sub(t & 0xff7fff7fu, t & 0xff80ff80u);
}

// K16's codebook tile at m > 64: entry q of the block's column n at word
// q * COLS + n (kLut: the bf16 entry in the high half, an f32 of the same
// value; kLutX32: bf16 hi | lo << 16 of the f32 entry). A warp's 32
// neighbouring columns fall in 32 distinct banks whatever their codes.
// Static shared memory, so its address is a constant the lookups take as
// an immediate.
template <int COLS>
__device__ __forceinline__ uint32_t* lut_smem() {
  __shared__ __align__(16) uint32_t lut[16 * COLS];
  return lut;
}

// The byte offset in a codebook of code `c` (0-7, bits 4c .. 4c + 3) of
// word `w` for the column at byte offset `col` (no bit of it in S .. S +
// 3): the code shifted to bits S .. S + 3 (lut_smem: 10 for 256 columns,
// 9 for 128; quant_stream_kernel: 8 and 9), then one lop3.
template <int S>
__device__ __forceinline__ uint32_t lut_offset(uint32_t w, int c,
                                               uint32_t col) {
  const uint32_t s = 4 * c <= S ? w << (S - 4 * c) : w >> (4 * c - S);
  return and_or(s, 0xfu << S, col);
}

// Byte offset of 16-byte piece `c` of 128-byte row `r` in the swizzle.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// This consumer thread's share of chunk t's W tile, dequantized from the
// stage's packed words `ws`, scale row `ss` and zero row `zs` into the
// bf16 tile `wt` (kn of the chunk's 64 rows are real; the rest read as
// zero; FULL: all 64, no masks). Every value is bf16(float(q - z) * s):
// 128 + q and 128 + z are exact in bf16, so is their difference, and the
// product is rounded once. K14 (kI8g) and K13 (kQ8): bf16(float(q) * d),
// d the scale row of the code's 16-row (K14) or 32-row (K13) group, as
// the plain version rounds it. K12 (kQ4k): bf16(float(q * dl) - ml), as
// the plain version and the Pallas body round it. K16 (kLut): the
// column's codebook entry lut[n][q] (bf16), bit for bit. K17 (kInt8):
// bf16(q), exact.
template <int BITS, Dec D, bool FULL>
__device__ __forceinline__ void dequant_chunk(const uint32_t* ws,
                                              const uint32_t* zs,
                                              const __nv_bfloat16* ss,
                                              unsigned char* wt, int kn,
                                              int tid) {
  constexpr int PACK = 32 / BITS;
  if constexpr (D == Dec::kInt8) {
    // K17: columns 8j .. 8j + 7 (j = tid & 31) at rows k0 .. k0 + 7 (the
    // byte branch's split below): each row's 8 codes (8 bytes of the
    // stage) become one 16-byte piece of the MN-major tile, bf16(q)
    // exactly as the plain version and the Pallas body cast them; no
    // scale (the column's comes in the epilogue). 2 instructions a code.
    const int j = tid & 31;
    const int k0 = 16 * (tid >> 6) + 8 * ((tid >> 5) & 1);
    const unsigned char* wb = reinterpret_cast<const unsigned char*>(ws);
    unsigned char* blk = wt + (j >> 3) * (kBK * 128);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + i;
      const uint2 q = *reinterpret_cast<const uint2*>(wb + k * kBN + 8 * j);
      *reinterpret_cast<uint4*>(blk + swz(k, j & 7)) =
          make_uint4(i8_pair(q.x, 0x4140), i8_pair(q.x, 0x4342),
                     i8_pair(q.y, 0x4140), i8_pair(q.y, 0x4342));
    }
  } else if constexpr (D == Dec::kLut) {
    // K16: column n = tid of the K-major tile, word kc holds rows 8kc ..
    // 8kc + 7 (K12's words). Each code is this column's codebook entry,
    // bit for bit: the code shifted into place, one lop3 with the
    // column's offset, one ld.shared (lut_smem's address an immediate),
    // and half a byte permute to pair two rows' bf16: 3.5 instructions a
    // code.
    const int n = tid;
    const unsigned char* lut =
        reinterpret_cast<const unsigned char*>(lut_smem<kBN>());
    const uint32_t col = static_cast<uint32_t>(n) << 2;
    uint32_t w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = ws[r * kBN + n];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)   // rows 8kc + 2i and 8kc + 2i + 1
        o[i] = __byte_perm(ld32(lut + lut_offset<10>(w[kc], 2 * i, col)),
                           ld32(lut + lut_offset<10>(w[kc], 2 * i + 1, col)),
                           0x7632);
      *reinterpret_cast<uint4*>(wt + swz(n, kc)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else if constexpr (D == Dec::kLutX32) {
    // K16 on f32 x: column n = tid % 128 of the two K-major tiles (hi,
    // then lo, 16 KB each), word rows 4h .. 4h + 3 (h = tid / 128: rows
    // 32h .. 32h + 31). Each code is one lookup of its column's (hi | lo
    // << 16) entry; two rows' hi halves pair into the hi tile, their lo
    // halves into the lo tile: 4 instructions a code.
    const int n = tid & 127, h = tid >> 7;
    const unsigned char* lut =
        reinterpret_cast<const unsigned char*>(lut_smem<128>());
    const uint32_t col = static_cast<uint32_t>(n) << 2;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = ws[(4 * h + r) * 128 + n];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t oh[4], ol[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // rows 2i and 2i + 1 of word r
        const uint32_t e0 = ld32(lut + lut_offset<9>(w[r], 2 * i, col));
        const uint32_t e1 = ld32(lut + lut_offset<9>(w[r], 2 * i + 1, col));
        oh[i] = __byte_perm(e0, e1, 0x5410);
        ol[i] = __byte_perm(e0, e1, 0x7632);
      }
      const int off = swz(n, 4 * h + r);
      *reinterpret_cast<uint4*>(wt + off) =
          make_uint4(oh[0], oh[1], oh[2], oh[3]);
      *reinterpret_cast<uint4*>(wt + 128 * kBK * 2 + off) =
          make_uint4(ol[0], ol[1], ol[2], ol[3]);
    }
  } else if constexpr (Cfg<BITS, D>::kBytes) {
    // Columns 8j .. 8j + 7 (j = tid & 31) at 8 rows of the chunk's
    // 16-row group r = tid / 64 (the first or second 8 by warp parity), so
    // a thread reads one scale row (K14's row r, K13's r / 2): each row's
    // 8 codes (8 bytes of the stage) become one 16-byte piece of the
    // MN-major tile, as AWQ's word columns. q ^ 0x80 = q + 128 in
    // [0, 255], so 2^23 + q + 128 is a float by one byte permute, and
    // fma(2^23 + q + 128, d, -(2^23 + 128) d) = q d exactly (the addend
    // is exact: d has 8 significant bits), rounded once to bf16 by the
    // pack. Every chunk is whole (64 rows of whole scale groups).
    const int j = tid & 31, r = tid >> 6;
    const int k0 = 16 * r + 8 * ((tid >> 5) & 1);
    const unsigned char* wb = reinterpret_cast<const unsigned char*>(ws);
    unsigned char* blk = wt + (j >> 3) * (kBK * 128);
    const int srow = D == Dec::kQ8 ? r >> 1 : r;
    const uint4 s4 = reinterpret_cast<const uint4*>(ss + srow * kBN)[j];
    const uint32_t sv[4] = {s4.x, s4.y, s4.z, s4.w};
    float d[8], c[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d[2 * e] = __uint_as_float(sv[e] << 16);
      d[2 * e + 1] = __uint_as_float(sv[e] & 0xffff0000u);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = __fmul_rn(-8388736.f, d[e]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + i;
      const uint2 q = *reinterpret_cast<const uint2*>(wb + k * kBN + 8 * j);
      const uint32_t qw[2] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = qw[e >> 1];
        const int b = (2 * e) & 3;
        const float lo = __fmaf_rn(
            __uint_as_float(__byte_perm(w, 0x4b000000u, b | 0x7440)),
            d[2 * e], c[2 * e]);
        const float hi = __fmaf_rn(
            __uint_as_float(__byte_perm(w, 0x4b000000u, (b + 1) | 0x7440)),
            d[2 * e + 1], c[2 * e + 1]);
        o[e] = pack_bf2(lo, hi);
      }
      *reinterpret_cast<uint4*>(blk + swz(k, j & 7)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else if constexpr (D == Dec::kQ4k) {
    // GPTQ's 4-bit branch below with an affine pair in place of the zero
    // and scale: column n = tid of the K-major tile, word kc holds rows
    // 8kc .. 8kc + 7, so words 0-3 take the first (dl, ml) rows and 4-7
    // the second. q * dl is exact in f32 (4 by 8 significant bits), so
    // fma(q, dl, -ml) rounds once, as the plain version's subtraction
    // does; the pack rounds to bf16. q comes from nib2 (bf16 128 + q)
    // widened to f32 minus 128, exact.
    const int n = tid;
    const __nv_bfloat16* ms = reinterpret_cast<const __nv_bfloat16*>(zs);
    uint32_t w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = ws[r * kBN + n];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dl = __uint_as_float(bf16_bits(ss[h * kBN + n]) << 16);
      const float nml = -__uint_as_float(bf16_bits(ms[h * kBN + n]) << 16);
#pragma unroll
      for (int kc = 4 * h; kc < 4 * h + 4; ++kc) {
        const uint32_t w4 = w[kc] >> 4;
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // rows 2i (the low half) and 2i + 1 (the high half)
          const uint32_t v = nib2(__byte_perm(w[kc], w4, i | ((4 + i) << 8)));
          const float q0 = __fsub_rn(__uint_as_float(v << 16), 128.f);
          const float q1 = __fsub_rn(__uint_as_float(v & 0xffff0000u), 128.f);
          o[i] = pack_bf2(__fmaf_rn(q0, dl, nml), __fmaf_rn(q1, dl, nml));
        }
        *reinterpret_cast<uint4*>(wt + swz(n, kc)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  } else if constexpr (D == Dec::kAwq) {
    // Word column j (columns 8j .. 8j + 7) at rows tid / 32 + 8i: each
    // word is one 16-byte piece of the MN-major tile (64-column blocks of
    // 64 k rows x 128 bytes); (w >> 4e) & 0x000f000f holds columns 2e and
    // 2e + 1 (the AWQ interleave).
    const int j = tid & 31;
    const uint32_t zw = zs[j];
    const uint4 s4 = reinterpret_cast<const uint4*>(ss)[j];
    const uint32_t sv[4] = {s4.x, s4.y, s4.z, s4.w};
    uint32_t zz[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) zz[e] = nib2(zw >> (4 * e));
    unsigned char* blk = wt + (j >> 3) * (kBK * 128);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = ws[((tid >> 5) + 8 * i) * 32 + j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = (tid >> 5) + 8 * i;
      const uint32_t keep = FULL || k < kn ? 0xffffffffu : 0u;
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = bf2_mul(bf2_sub(nib2(w[i] >> (4 * e)), zz[e]),
                       FULL ? sv[e] : sv[e] & keep);
      *reinterpret_cast<uint4*>(blk + swz(k, j & 7)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    // Column n = tid of the K-major tile (W^T, rows of 64 k): a GPTQ word
    // holds PACK k rows of one column.
    const int n = tid;
    const uint32_t zw = zs[n / PACK];
    const int z = static_cast<int>((zw >> (BITS * (n % PACK))) &
                                   ((1u << BITS) - 1u)) + 1;
    const uint32_t sb = bf16_bits(ss[n]);
    constexpr int WR = kBK / PACK;                // word rows a chunk
    uint32_t w[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) w[r] = ws[r * kBN + n];
    if constexpr (BITS == 4) {
      const uint32_t zz = (0x4300u | static_cast<uint32_t>(z)) * 0x10001u;
      const uint32_t s2 = sb * 0x10001u;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        const uint32_t sk = FULL || kc * 8 < kn ? s2 : 0u;
        const uint32_t w4 = w[kc] >> 4;
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          // rows 2i (byte i, low nibble) and 2i + 1 (its high one)
          o[i] = bf2_mul(
              bf2_sub(nib2(__byte_perm(w[kc], w4, i | ((4 + i) << 8))), zz),
              sk);
        *reinterpret_cast<uint4*>(wt + swz(n, kc)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      // 8 bits: q - z in [-256, 255], in f32 as (2^23 + q) - (2^23 + z),
      // exact; times s exact in f32; rounded once to bf16.
      const float zf = 8388608.f + static_cast<float>(z);
      const float sf = __uint_as_float(sb << 16);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        uint32_t o[4];
#pragma unroll
        for (int hw = 0; hw < 2; ++hw) {
          const int wr = 2 * kc + hw;
          const float sk = FULL || wr * 4 < kn ? sf : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float lo = __uint_as_float(
                __byte_perm(w[wr], 0x4b000000u, (2 * i) | 0x7440)) - zf;
            const float hi = __uint_as_float(
                __byte_perm(w[wr], 0x4b000000u, (2 * i + 1) | 0x7440)) - zf;
            o[2 * hw + i] = pack_bf2(lo * sk, hi * sk);
          }
        }
        *reinterpret_cast<uint4*>(wt + swz(n, kc)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <int BITS, Dec D>
__global__ void __launch_bounds__(kThreads, 1)
quant_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap s_map,
                  const __grid_constant__ CUtensorMap z_map,
                  const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ partial, int m, int K, int N, int gs,
                  int groups_per_split, int x_tma,
                  const void* __restrict__ cols) {
  using C = Cfg<BITS, D>;
  constexpr int S = C::kStages;
  constexpr int PACK = C::kPack;
  constexpr bool AWQ = D == Dec::kAwq;
  static_assert(!AWQ || BITS == 4, "AWQ packs 8 4-bit codes");
  static_assert(!C::kBytes || BITS == 8,
                "K13's, K14's and K17's codes are bytes");
  static_assert(!C::kNibWords || BITS == 4, "K12's and K16's codes are 4-bit");

  // The ring, 1024-byte aligned for the 128-byte swizzle; offset from
  // smem_raw (not through an integer) so that accesses stay ld/st.shared.
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_s = smem;                              // [S][128 x 64]
  unsigned char* wt_s = x_s + S * C::kXStage;             // [kWt][W tile]
  unsigned char* words_s = wt_s + C::kWt * C::kWtSet;     // [S][packed]
  unsigned char* sc_s = words_s + S * C::kWordBytes;      // [S][rows][256]
  unsigned char* z_s = sc_s + S * C::kSBytes;             // [S][zero row]
  uint64_t* full = reinterpret_cast<uint64_t*>(z_s + S * C::kZBytes);
  uint64_t* empty = full + S;

  // Tile order: blocks launch x fastest; groups of 8 row tiles are walked
  // column by column, so the blocks resident at once share a few x row
  // tiles and W column tiles in L2.
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int per_group = 8 * gridDim.x;
  const int first_m = lin / per_group * 8;
  const int group_m = min(static_cast<int>(gridDim.y) - first_m, 8);
  const int m0 = (first_m + lin % per_group % group_m) * kBM;
  const int n0 = lin % per_group / group_m * C::kCols;
  const int G = K / gs;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);
  const int cpg = (gs + kBK - 1) / kBK;                   // chunks a group
  const int T = max(0, g_end - g_begin) * cpg;            // chunks here
  // Chunk t: group g, first row k0, kn rows (the group's last chunk may
  // be short; its other rows read as zero).
  auto chunk = [&](int t, int& g, int& k0, int& kn) {
    g = g_begin + t / cpg;
    const int c = t % cpg;
    k0 = g * gs + c * kBK;
    kn = min(kBK, gs - c * kBK);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);       // the loader's arrival, plus TMA bytes
      mbar_init(&empty[s], 256);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // -------------------------------------------------------- loader --
    // One thread keeps the ring full: chunk t into stage t % S once the
    // consumers are done with chunk t - S.
    if (threadIdx.x != 256) return;
    for (int t = 0; t < T; ++t) {
      const int slot = t % S;
      if (t >= S) mbar_wait(&empty[slot], (t / S - 1) & 1);
      int g, k0, kn;
      chunk(t, g, k0, kn);
      uint64_t* bar = &full[slot];
      mbar_expect_tx(bar, C::kWsBytes + (x_tma ? C::kXStage : 0));
      if (x_tma) tma_load(x_s + slot * C::kXStage, &x_map, bar, k0, m0);
      // K16 on f32 x: x_map covers [hi; lo], the lo rows m further on.
      if constexpr (C::kX32)
        tma_load(x_s + slot * C::kXStage + kXBytes, &x_map, bar, k0, m + m0);
      if constexpr (C::kBytes) {
        // The [64, 256] code chunk and its four d16 (K14) or two d (K13)
        // rows, none for K17 (gs is 64).
        tma_load(words_s + slot * C::kWordBytes, &w_map, bar, n0, k0);
        if constexpr (C::kSRows > 0)
          tma_load(sc_s + slot * C::kSBytes, &s_map, bar, n0,
                   k0 / (kBK / C::kSRows));
      } else if constexpr (C::kNibWords) {
        // The chunk's 8 word rows and K12's two dl and two ml rows.
        tma_load(words_s + slot * C::kWordBytes, &w_map, bar, n0, k0 / 8);
        if constexpr (D == Dec::kQ4k) {
          tma_load(sc_s + slot * C::kSBytes, &s_map, bar, n0, k0 / 32);
          tma_load(z_s + slot * C::kZBytes, &z_map, bar, n0, k0 / 32);
        }
      } else {
        if constexpr (AWQ) {
          tma_load(words_s + slot * C::kWordBytes, &w_map, bar, n0 / 8, k0);
        } else {
          tma_load(words_s + slot * C::kWordBytes, &w_map, bar, n0,
                   k0 / PACK);
        }
        tma_load(sc_s + slot * C::kSBytes, &s_map, bar, n0, g);
        tma_load(z_s + slot * C::kZBytes, &z_map, bar, n0 / PACK, g);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers --
  // While the tensor cores run chunk t - 1's and t's products, the
  // consumers dequantize chunk t + 1 into the next of three W tiles (the
  // tile of chunk t - 2, whose products both warpgroups have finished).
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // Chunk t's x and W tiles in place: wait for its loads, store x where
  // TMA could not (an unaligned view, or rows not whole 16-byte runs),
  // dequantize this thread's share of W, and make the stores visible to
  // the async proxy; a consumer barrier follows.
  auto prepare = [&](int t) {
    const int slot = t % S;
    int g, k0, kn;
    chunk(t, g, k0, kn);
    mbar_wait(&full[slot], (t / S) & 1);
    if (!C::kX32 && !x_tma) {
      unsigned char* xd = x_s + slot * C::kXStage;
      for (int i = 0; i < 32; ++i) {
        const int e = tid + 256 * i, r = e >> 6, k = e & 63;
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (m0 + r < m && k < kn)
          v = x[static_cast<size_t>(m0 + r) * K + k0 + k];
        *reinterpret_cast<__nv_bfloat16*>(xd + swz(r, k >> 3) + (k & 7) * 2) =
            v;
      }
    }
    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(words_s + slot * C::kWordBytes);
    const uint32_t* zs =
        reinterpret_cast<const uint32_t*>(z_s + slot * C::kZBytes);
    const __nv_bfloat16* ss =
        reinterpret_cast<const __nv_bfloat16*>(sc_s + slot * C::kSBytes);
    unsigned char* wt = wt_s + (t % C::kWt) * C::kWtSet;
    // A whole chunk (every chunk where the group size is a multiple of 64,
    // and every GGUF chunk) takes the unmasked instance.
    if constexpr (C::kChunked) {
      dequant_chunk<BITS, D, true>(ws, zs, ss, wt, kn, tid);
    } else if (kn == kBK) {
      dequant_chunk<BITS, D, true>(ws, zs, ss, wt, kn, tid);
    } else {
      dequant_chunk<BITS, D, false>(ws, zs, ss, wt, kn, tid);
    }
    fence_proxy_async();
  };
  auto consumers_sync = [] {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  };

  if constexpr (D == Dec::kLut) {
    // K16: this thread's column's 16 codebook entries, once per block
    // (zeros past N: a half tile reads no codebook row of another
    // matrix). A thread's lookups read only its own column's, so no
    // barrier.
    uint32_t v[16] = {};
    if (n0 + tid < N) {
      const uint16_t* src = static_cast<const uint16_t*>(cols) +
                            static_cast<size_t>(n0 + tid) * 16;
#pragma unroll
      for (int q = 0; q < 16; ++q)
        v[q] = static_cast<uint32_t>(__ldg(src + q)) << 16;
    }
    uint32_t* lut = lut_smem<kBN>();
#pragma unroll
    for (int q = 0; q < 16; ++q) lut[q * kBN + tid] = v[q];
  } else if constexpr (C::kX32) {
    // K16 on f32 x: column n = tid % 128's entries 8h .. 8h + 7 (h = tid /
    // 128), split into bf16 (hi | lo << 16); the decoders read both
    // halves of their column's 16, so a barrier follows.
    const int n = tid & 127, h = tid >> 7;
    const float* src = static_cast<const float*>(cols) +
                       static_cast<size_t>(n0 + n) * 16 + 8 * h;
    uint32_t* lut = lut_smem<128>();
#pragma unroll
    for (int q = 0; q < 8; q += 2) {
      uint32_t hw, lw;
      split_bf16(__ldg(src + q), __ldg(src + q + 1), hw, lw);
      lut[(8 * h + q) * 128 + n] = __byte_perm(hw, lw, 0x5410);
      lut[(8 * h + q + 1) * 128 + n] = __byte_perm(hw, lw, 0x7632);
    }
    consumers_sync();
  }
  float acc[C::kAcc];
  const uint32_t x_base = smem_u32(x_s) + wg * 64 * 128;
  const uint32_t wt_base = smem_u32(wt_s);
  if (T > 0) prepare(0);
  consumers_sync();
  for (int t = 0; t < T; ++t) {
    const int slot = t % S;
    const uint32_t wt_t = wt_base + (t % C::kWt) * C::kWtSet;
    // Both warpgroups run every chunk, real rows or not: a branch around
    // the products would make ptxas serialize them.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          make_desc(x_base + slot * C::kXStage + kk * 32, 16, 1024);
      if constexpr (C::kKMajor) {
        if constexpr (C::kX32) {
          // x_lo w_hi + x_hi w_lo + x_hi w_hi into the f32 sums.
          const uint64_t dl =
              make_desc(x_base + slot * C::kXStage + kXBytes + kk * 32, 16,
                        1024);
          const uint64_t wh = make_desc(wt_t + kk * 32, 16, 1024);
          const uint64_t wl =
              make_desc(wt_t + C::kCols * kBK * 2 + kk * 32, 16, 1024);
          wgmma_128(acc, dl, wh, t > 0 || kk > 0);
          wgmma_128(acc, da, wl, 1);
          wgmma_128(acc, da, wh, 1);
        } else {
          wgmma_256<0>(acc, da, make_desc(wt_t + kk * 32, 16, 1024),
                       t > 0 || kk > 0);
        }
      } else {
        wgmma_256<1>(acc, da, make_desc(wt_t + kk * 16 * 128, 8192, 1024),
                     t > 0 || kk > 0);
      }
    }
    wgmma_commit();
    if constexpr (C::kWt == 3) {
      // Chunk t + 1's W tile goes where chunk t - 2's was: both
      // warpgroups finished those products before the last consumer
      // barrier.
      if (t + 1 < T) prepare(t + 1);
      wgmma_wait<1>();                    // chunk t - 1's products done
      if (t > 0) mbar_arrive(&empty[(t - 1) % S]);
    } else {
      // Two W tiles: chunk t + 1's goes where chunk t - 1's was, once
      // both warpgroups have finished those products. Chunk t - 1's
      // stage is free as soon as they have: its words went into its W
      // tile a step ago.
      wgmma_wait<1>();
      if (t > 0) mbar_arrive(&empty[(t - 1) % S]);
      consumers_sync();
      if (t + 1 < T) prepare(t + 1);
    }
    consumers_sync();
  }
  wgmma_wait<0>();
  if (T == 0) {
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
  }
  fence_acc(acc);
  // Accumulator i of thread (warp w, lane l): row w * 16 + l / 4 (+ 8
  // for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) (+ 1 for odd i).
  const int lt = tid & 127;
  const int row = m0 + wg * 64 + (lt >> 5) * 16 + ((lt & 31) >> 2);
#pragma unroll
  for (int j = 0; j < C::kAcc / 4; ++j) {
    const int col = n0 + j * 8 + (lt & 3) * 2;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + h * 8;
      if (r >= m) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(
            partial + (static_cast<size_t>(blockIdx.z) * m + r) * N + col) =
            make_float2(v0, v1);
      } else if constexpr (C::kX32) {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) +
                                   static_cast<size_t>(r) * N + col) =
            make_float2(v0, v1);
      } else {
        if constexpr (D == Dec::kInt8) {
          // K17: bf16(sum * s[col]) in f32, as `_int8_kernel`'s flush
          // (split_reduce_kernel applies it after a split).
          const float* cs = static_cast<const float*>(cols);
          v0 *= cs[col];
          v1 *= cs[col + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(r) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint (the library links only cudart).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `elem`-byte values, read in boxes of
// box_rows x box_cols; out-of-range elements read as zero.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* base, uint64_t cols, uint64_t rows,
                uint32_t box_cols, uint32_t box_rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K6 / K10: grid (N / 256 column tiles, m / 128 row tiles, splits); a
// split covers groups_per_split whole groups and writes f32 partials,
// which split_reduce_kernel adds in split order. Four tensor maps per
// call (a host encoding each, no device work). The dynamic shared memory
// above 48 KB is allowed once per instance.
// The chunked decoders take gs the split unit, 64 rows, and no zero rows:
// K14 (kI8g) and K13 (kQ8): qweight is the int8 codes [K, N], scales the
// d16 rows [K / 16, N] or the d rows [K / 32, N]; K12 (kQ4k): qweight the
// 4-bit words [K / 8, N], scales the dl rows and qzeros the ml rows, both
// [K / 32, N]; K16 (kLut): qweight K12's words, `cols` the codebook
// [N, 16] bf16; K17 (kInt8): qweight K13's codes, `cols` the column scales
// [N] f32 (applied by split_reduce_kernel after a split).
template <int BITS, Dec D>
int launch_gemm(const void* x, const void* qweight, const void* qzeros,
                const void* scales, void* out, float* partial, int m, int K,
                int N, int gs, int splits, cudaStream_t stream,
                const void* cols = nullptr) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  using C = Cfg<BITS, D>;
  constexpr bool AWQ = D == Dec::kAwq;
  constexpr int PACK = C::kPack;
  if (splits < 1 || gs <= 0 || K % gs != 0 || N % 128 != 0 ||
      (!AWQ && gs % PACK != 0) || (C::kChunked && gs != kBK) ||
      ((D == Dec::kLut || D == Dec::kInt8 || C::kX32) && cols == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = quant_gemm_kernel<BITS, D>;
  constexpr int smem = Cfg<BITS, D>::kSmemBytes;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const int G = K / gs;
  const int gps = (G + splits - 1) / splits;
  constexpr auto kU32 = CU_TENSOR_MAP_DATA_TYPE_UINT32;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto kFlat = CU_TENSOR_MAP_SWIZZLE_NONE;
  // TMA for x needs a 16-byte aligned base and row stride.
  const int x_tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
  // K16 on f32 x: x is split_x32_kernel's [hi; lo], 2m rows, always TMA.
  if (C::kX32 && !x_tma) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map{}, w_map{}, s_map{}, z_map{};
  bool ok = !x_tma || tensor_map(&x_map, kBf16, 2, x, K,
                                  C::kX32 ? 2 * m : m, kBK, kBM,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if constexpr (C::kBytes) {
    ok = ok && tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qweight,
                          N, K, kBN, kBK, kFlat);
    if constexpr (C::kSRows > 0) {
      constexpr int rows = kBK / C::kSRows;    // input rows a scale row
      ok = ok && tensor_map(&s_map, kBf16, 2, scales, N, K / rows, kBN,
                            C::kSRows, kFlat);
    }
  } else if constexpr (C::kNibWords) {
    ok = ok && tensor_map(&w_map, kU32, 4, qweight, N, K / 8, C::kCols,
                          kBK / 8, kFlat);
    if constexpr (D == Dec::kQ4k) {
      ok = ok &&
           tensor_map(&s_map, kBf16, 2, scales, N, K / 32, kBN, 2, kFlat);
      ok = ok &&
           tensor_map(&z_map, kBf16, 2, qzeros, N, K / 32, kBN, 2, kFlat);
    }
  } else {
    ok = ok && (AWQ ? tensor_map(&w_map, kU32, 4, qweight, N / 8, K,
                                 kBN / 8, kBK, kFlat)
                    : tensor_map(&w_map, kU32, 4, qweight, N, K / PACK, kBN,
                                 kBK / PACK, kFlat));
    ok = ok && tensor_map(&s_map, kBf16, 2, scales, N, G, kBN, 1, kFlat);
    ok = ok && tensor_map(&z_map, kU32, 4, qzeros, N / PACK, G, kBN / PACK,
                          1, kFlat);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  float* part = splits > 1 ? partial : nullptr;
  const dim3 grid((N + C::kCols - 1) / C::kCols, (m + kBM - 1) / kBM,
                  splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      x_map, w_map, s_map, z_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), part, m, K, N, gs, gps, x_tma, cols);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(m) * N;
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    if constexpr (C::kX32) {
      split_reduce_kernel<float><<<blocks, threads, 0, stream>>>(
          partial, nullptr, nullptr, static_cast<float*>(out), splits, m, N);
    } else {
      split_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
          partial, nullptr,
          D == Dec::kInt8 ? static_cast<const float*>(cols) : nullptr,
          static_cast<__nv_bfloat16*>(out), splits, m, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K16 on f32 x at m > 64, the pass before quant_gemm_kernel<4, kLutX32>:
// x [m, K] f32 (n = m K values) into xhl [2m, K] bf16, hi = bf16(x) in
// rows [0, m) and lo = bf16(x - hi) in rows [m, 2m), the two x tiles the
// kernel loads by TMA. Bytes bound it: x read once, 4 bytes written a
// value (0.25 ms a Mistral-7B layer at m 4096, beside ~9 of products).
// Four values a thread, 16-byte loads where x is aligned.
__global__ void split_x32_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ xhl, size_t n,
                                 int vec) {
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float v[4];
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(x + i);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = x[i + j];
  }
  uint32_t h[2], l[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) split_bf16(v[2 * j], v[2 * j + 1], h[j], l[j]);
  *reinterpret_cast<uint2*>(xhl + i) = make_uint2(h[0], h[1]);
  *reinterpret_cast<uint2*>(xhl + n + i) = make_uint2(l[0], l[1]);
}

// K16 on f32 x at m > 64: split_x32_kernel into xhl (2 m K bf16, 16-byte
// aligned), then quant_gemm_kernel<4, kLutX32> on 128 x 128 tiles
// (`splits` runs of 64-row chunks, then split_reduce_kernel<float>); f32
// out.
int launch_gemm_x32(const float* x, const void* qweight, const void* lut,
                    void* xhl, void* out, float* partial, int m, int K,
                    int N, int splits, cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (xhl == nullptr || reinterpret_cast<uintptr_t>(xhl) % 16 != 0 ||
      K % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(m) * K;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  split_x32_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0,
                     stream>>>(x, static_cast<__nv_bfloat16*>(xhl), n, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm<4, Dec::kLutX32>(xhl, qweight, nullptr, nullptr, out,
                                      partial, m, K, N, kBK, splits, stream,
                                      lut);
}

// ------------------------------------------------------- K8, K11, K15 --
//
// w8a8_gemm_kernel<D>: the int8-activation products at m > 64, y =
// bf16(xs[m] * sum_g s[g] * (x8[m, g] . w8[g])) over scale groups g, x8
// int8 rows from quant8. The decoder D says what the int8 weight w8 is at
// rest: K15's (A8Dec::kQs8: int8 codes qs8 [K, N], 128-row groups), K8's
// (kGptq4: GPTQ's 4-bit words [K / 8, N], w8 = q - (z + 1) in [-16, 14])
// and K11's (kAwq4: AWQ's words [K, N / 8], 8 interleaved columns a word,
// w8 = q - z in [-15, 15]). One block owns 128 rows x 128 columns of the
// output and walks its chunks of 128 k rows. Both wgmma operands of an
// 8-bit product are read K-major from shared memory: x8 [m, K] is K-major
// already and goes in by TMA in the 128-byte swizzle (a chunk row is
// exactly one swizzle row); the consumers decode each chunk's weight into
// a K-major swizzled s8 tile while the tensor cores run the chunk before,
// as quant_gemm_kernel dequantizes:
//   - kQs8: qs8 is N-major at rest; four 4 x 4 byte transposes give a
//     thread 16 k bytes of each of 4 columns (byte permutes).
//   - kGptq4: a word holds 8 k rows of one column, so two words of a
//     column are one 16-byte piece of the tile, with no transpose: the
//     even and odd nibbles masked out (one lop3 each, 0x80 set above
//     each code), the zero subtracted from every byte at once (the 0x80
//     keeps the bytes from borrowing, one add and one xor take it off
//     again), and the halves interleaved by two byte permutes.
//   - kAwq4: a word holds 8 columns of one k row. A thread takes the
//     even (columns 8j + 0, 4, 1, 5) or the odd nibbles (8j + 2, 6, 3, 7)
//     of 16 rows of word column j, subtracts the zeros as kGptq4 does,
//     and transposes them into 4 pieces as kQs8 does.
// Two consumer warpgroups run wgmma m64n128k32 s8 x s8 into s32, 64 rows
// each: a group's products start with scale-d 0 and give its exact int32
// dots (K15: |dot| <= 128 * 127 * 128 < 2^22; K8 / K11: gs * 127 * 16,
// so a group past 8192 rows is folded every 8192 to stay below 2^24,
// where the conversion to f32 is exact). Once they are done, the group
// is folded into the f32 sums in group order, acc = fma(float(dot),
// s[g][n], acc): the plain version's order, with one rounding where it
// takes two. Its scale row came in the stage, and the chunk's decode
// writes it out as f32. Two s32 sets alternate by group, so that group
// g - 1 folds while group g's products run: with the f32 sums, 3 x 64
// accumulator registers a thread. No loader warp: a block of 288
// threads caps a thread at 224 registers, so consumer thread 0 issues
// each stage's TMA loads (x8 chunk, the weight's chunk, the group's scale
// row and, for K8 / K11, its zero row) as soon as both warpgroups are
// past the chunk that held it. The flush multiplies by xs[row]
// (split_reduce_kernel does, after a split) and rounds to bf16.
// A group is cut into ceil(gs / 128) chunks, its last one short where
// 128 does not divide gs (its other rows decode as zero), and a split is
// a run of those chunks (the wrapper's a8_gemm_plan): it may start and
// end inside a group, whose scale is constant over it, so one group of K
// rows (GPTQ's group_size -1) still spreads over the SMs.
constexpr int kW8Tile = 128;                // rows, columns and k of a chunk
constexpr int kW8Threads = 256;             // two consumer warpgroups
constexpr int kW8Bytes = kW8Tile * kW8Tile; // x8 stage, qs8 stage, K-major tile
constexpr int kW8SBytes = kW8Tile * 2;      // scale row

enum class A8Dec { kQs8, kGptq4, kAwq4 };

template <A8Dec D>
struct W8Cfg {
  static constexpr bool kNib = D != A8Dec::kQs8;
  static constexpr int kStages = kNib ? 6 : 5;
  static constexpr int kWBytes = kNib ? kW8Bytes / 2 : kW8Bytes;  // at rest
  static constexpr int kZBytes = kNib ? 128 : 0;   // the zero row, 64 used
  // A stage: the x8 chunk, the weight's chunk, the bf16 scale row and its
  // f32 copy, the zero row.
  static constexpr int kSmemBytes =
      1024 + kStages * (kW8Bytes + kWBytes + 3 * kW8SBytes + kZBytes) +
      kWtTiles * kW8Bytes + 8 * kStages;
  static_assert(kSmemBytes <= 232448, "the opt-in limit per block");
};

// d[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 x s8 into s32, A and B
// K-major in the 128-byte swizzle; scale_d 0 on a group's first product.
__device__ __forceinline__ void wgmma_s8_128(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// float(v), exact for |v| <= 2^24. An asm volatile, so that the
// accumulator read stays after the wgmma wait before it.
__device__ __forceinline__ float s32_to_f32(int v) {
  float r;
  asm volatile("cvt.rn.f32.s32 %0, %1;\n" : "=f"(r) : "r"(v));
  return r;
}

// Fold a group's dots `dot` into the f32 sums with its scale row (`srow`:
// this thread's first pair of f32 scales; pairs 4 apart): acc =
// fma(float(dot), s, acc), one rounding (the plain version rounds the
// product, then the sum: the two differ by at most half an ulp of the sum
// per group). Accumulator i of thread (warp w, lane l): row w * 16 + l / 4
// (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) (+ 1 for odd i).
__device__ __forceinline__ void w8a8_fold(float (&acc)[64],
                                          const int (&dot)[64],
                                          const float2* srow) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 sc = srow[4 * j];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * j + e] = __fmaf_rn(s32_to_f32(dot[4 * j + e]),
                                 (e & 1) ? sc.y : sc.x, acc[4 * j + e]);
  }
}

// One step of the consumers' loop: chunk t's products into `cur` (its x8
// stage, its K-major tile; `opens`: the chunk opens a group of `cur`, so
// its first product takes scale-d 0), chunk t + 1's decode, the consumer
// barrier once both warpgroups have finished chunk t - 1's products,
// thread 0's refill of the stage chunk t - 1 held (its scale row was
// copied out as f32 by its decode), then, where chunk t opens a group,
// the fold of the group before it from `prev` while the tensor cores run
// chunk t. The caller alternates the two sets by group.
template <int S, class Prepare, class Load>
__device__ __forceinline__ void w8a8_step(
    int t, int T, bool opens, int (&cur)[64], const int (&prev)[64],
    float (&acc)[64], uint32_t x_stage, uint32_t w_tile, const float2* srow,
    Prepare& prepare, Load& load) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_s8_128(cur, make_desc(x_stage + kk * 32, 16, 1024),
                 make_desc(w_tile + kk * 32, 16, 1024), kk > 0 || !opens);
  wgmma_commit();
  if (t + 1 < T) prepare(t + 1);
  wgmma_wait<1>();                        // chunk t - 1's products done
  // The decode's stores become visible to the next step's wgmma. After
  // the wait, not inside the pipeline stage: there ptxas serialized the
  // products (warning C7514).
  fence_proxy_async();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // Stage (t - 1) % S is free: both warpgroups are past chunk t - 1.
  if (threadIdx.x == 0 && t > 0 && t - 1 + S < T) load(t - 1 + S);
  if (t > 0 && opens) w8a8_fold(acc, prev, srow);
}

// Bytes j0 and j1 of two words (a, b) as [a.j0, b.j0, a.j1, b.j1].
__device__ __forceinline__ uint32_t pick2(int j0, int j1) {
  return static_cast<uint32_t>(j0 | (4 + j0) << 4 | j1 << 8 |
                               (4 + j1) << 12);
}

// A 4 x 4 byte transpose: words a, b, c, d (4 k rows of 4 columns) into
// o[s][i], 4 k bytes of column (rot + s) % 4, where sel01 and sel23 are
// pick2(rot, rot + 1) and pick2(rot + 2, rot + 3).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t sel01, uint32_t sel23,
                                           uint32_t (&o)[4][4], int i) {
  const uint32_t t0 = __byte_perm(a, b, sel01);
  const uint32_t t1 = __byte_perm(a, b, sel23);
  const uint32_t t2 = __byte_perm(c, d, sel01);
  const uint32_t t3 = __byte_perm(c, d, sel23);
  o[0][i] = __byte_perm(t0, t2, 0x5410);
  o[1][i] = __byte_perm(t0, t2, 0x7632);
  o[2][i] = __byte_perm(t1, t3, 0x5410);
  o[3][i] = __byte_perm(t1, t3, 0x7632);
}

// Four 4-bit codes (the low nibble of each byte of v) minus a zero
// replicated in zz (or one zero a byte), as int8 bytes: (q | 0x80) - z
// borrows nothing (128 + q - z >= 112 for z up to 16), and ^ 0x80 leaves
// q - z.
__device__ __forceinline__ uint32_t s8_codes(uint32_t v, uint32_t zz) {
  return (and_or(v, 0x0f0f0f0fu, 0x80808080u) - zz) ^ 0x80808080u;
}

// The decoders: each consumer thread's share of a chunk's K-major s8
// tile `wt` (column n's 128 k bytes in row n, 16-byte piece c at
// swz(n, c)), from the stage's weight `ws` and zero row `zrow`. Only the
// first `kn` k rows are real (the rest decode as zero); FULL: all 128.
template <A8Dec D> struct A8Decoder;

// K15: warp c takes rows 16c .. 16c + 15 of the qs8 chunk, lane q
// columns 4q .. 4q + 3 (one 32-bit word of each row: a warp reads whole
// 128-byte rows). Four 4 x 4 byte transposes give the 16 k bytes of
// each of its 4 columns, one 16-byte piece of the K-major tile each.
// Lane q starts at column 4q + rot, rot = (q / 2) % 4, so that the 8
// lanes of a quarter warp store to 8 distinct 16-byte bank groups.
template <> struct A8Decoder<A8Dec::kQs8> {
  int c16, q;
  uint32_t sel01, sel23;
  int st_off[4];
  __device__ explicit A8Decoder(int tid) : c16(tid >> 5), q(tid & 31) {
    const int rot = (q >> 1) & 3;
    sel01 = pick2(rot, (rot + 1) & 3);
    sel23 = pick2((rot + 2) & 3, (rot + 3) & 3);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * q + ((s + rot) & 3);
      st_off[s] = n * 128 + ((c16 ^ (n & 7)) << 4);
    }
  }
  template <bool FULL>
  __device__ __forceinline__ void run(const unsigned char* stage,
                                      const uint32_t*, unsigned char* wt,
                                      int) const {
    const unsigned char* ws = stage + c16 * 16 * 128 + 4 * q;
    uint32_t o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      transpose4(ld32(ws + (4 * i) * 128), ld32(ws + (4 * i + 1) * 128),
                 ld32(ws + (4 * i + 2) * 128), ld32(ws + (4 * i + 3) * 128),
                 sel01, sel23, o, i);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<uint4*>(wt + st_off[s]) =
          make_uint4(o[s][0], o[s][1], o[s][2], o[s][3]);
  }
};

// K8: the stage holds words [16 word rows][128 columns]. Thread (n =
// tid % 128, half h = tid / 128) takes pieces 4h .. 4h + 3 of column n:
// words 2c and 2c + 1 of its column are k rows 16c .. 16c + 15, nibble
// j of a word row j. lo = the even rows, hi = the odd ones, each a byte;
// [lo.b0, hi.b0, lo.b1, hi.b1] are rows 0-3 in order. A warp's loads are
// one 128-byte word row, and the 8 lanes of a quarter warp store to 8
// distinct bank groups (n % 8 differs).
template <> struct A8Decoder<A8Dec::kGptq4> {
  int n, c0;
  __device__ explicit A8Decoder(int tid)
      : n(tid & 127), c0((tid >> 7) * 4) {}
  template <bool FULL>
  __device__ __forceinline__ void run(const unsigned char* stage,
                                      const uint32_t* zrow, unsigned char* wt,
                                      int kn) const {
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(stage) + n;
    // The AutoGPTQ zero, z + 1 in [1, 16], in every byte.
    const uint32_t zz =
        (((zrow[n >> 3] >> (4 * (n & 7))) & 0xfu) + 1u) * 0x01010101u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      uint32_t o[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = ws[(2 * c + h) * 128];
        const uint32_t lo = s8_codes(w, zz), hi = s8_codes(w >> 4, zz);
        const bool real = FULL || 16 * c + 8 * h < kn;
        o[2 * h] = real ? __byte_perm(lo, hi, 0x5140) : 0u;
        o[2 * h + 1] = real ? __byte_perm(lo, hi, 0x7362) : 0u;
      }
      *reinterpret_cast<uint4*>(wt + swz(n, c)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
};

// K11: the stage holds words [128 k rows][16 word columns]. Warp c takes
// rows 16c .. 16c + 15, lane (j = lane / 2, h = lane % 2) word column j's
// even (h 0) or odd (h 1) nibbles: byte b of (w >> 4h) & 0x0f0f0f0f is
// column 8j + 2h + b / 2 + 4 (b % 2) (AWQ's order, nibble p holding
// column {0, 2, 4, 6, 1, 3, 5, 7}[p]). The zero row's word j gives the 4
// zeros in the same bytes. Four 4 x 4 transposes give 16 k bytes of
// each of the 4 columns. A warp's loads are one 64-byte row, each word
// read by two lanes; lane (j, h) starts at byte rot = j % 4, so that the
// 8 lanes of a quarter warp (4 word columns, both halves) store to the 8
// columns 8j + e with distinct e = n % 8: 8 distinct bank groups.
template <> struct A8Decoder<A8Dec::kAwq4> {
  int c, j, sh;
  uint32_t sel01, sel23;
  int st_off[4];
  __device__ explicit A8Decoder(int tid)
      : c(tid >> 5), j((tid & 31) >> 1), sh(4 * (tid & 1)) {
    const int rot = j & 3;
    sel01 = pick2(rot, (rot + 1) & 3);
    sel23 = pick2((rot + 2) & 3, (rot + 3) & 3);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int b = (s + rot) & 3;
      const int n = 8 * j + sh / 2 + (b >> 1) + 4 * (b & 1);
      st_off[s] = swz(n, c);
    }
  }
  template <bool FULL>
  __device__ __forceinline__ void run(const unsigned char* stage,
                                      const uint32_t* zrow, unsigned char* wt,
                                      int kn) const {
    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(stage) + 16 * 16 * c + j;
    const uint32_t zz = (zrow[j] >> sh) & 0x0f0f0f0fu;
    uint32_t o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[r] = s8_codes(ws[(4 * i + r) * 16] >> sh, zz);
        if (!FULL && 16 * c + 4 * i + r >= kn) v[r] = 0u;
      }
      transpose4(v[0], v[1], v[2], v[3], sel01, sel23, o, i);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<uint4*>(wt + st_off[s]) =
          make_uint4(o[s][0], o[s][1], o[s][2], o[s][3]);
  }
};

// K8's and K11's place in their chunk walk: chunk j of group g.
struct ChunkWalk {
  int g, j;
  __device__ __forceinline__ void next(int cpg) {
    if (++j == cpg) {
      j = 0;
      ++g;
    }
  }
};

template <A8Dec D>
__global__ void __launch_bounds__(kW8Threads, 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap s_map,
                 const __grid_constant__ CUtensorMap z_map,
                 const int8_t* __restrict__ x8, const float* __restrict__ xs,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
                 int m, int K, int N, int gs, int chunks_per_split,
                 int x_tma) {
  using C = W8Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_s = smem;                              // [S][128 x 128 B]
  unsigned char* wt_s = x_s + S * kW8Bytes;               // [3][128 n x 128 k]
  unsigned char* w_s = wt_s + kWtTiles * kW8Bytes;        // [S][weight chunk]
  unsigned char* sc_s = w_s + S * C::kWBytes;             // [S][128] bf16
  float* sf_s = reinterpret_cast<float*>(sc_s + S * kW8SBytes);  // f32 rows
  unsigned char* z_s = reinterpret_cast<unsigned char*>(sf_s + S * kW8Tile);
  uint64_t* full = reinterpret_cast<uint64_t*>(z_s + S * C::kZBytes);

  // Tile order as quant_gemm_kernel's: groups of 8 row tiles, column by
  // column.
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int per_group = 8 * gridDim.x;
  const int first_m = lin / per_group * 8;
  const int group_m = min(static_cast<int>(gridDim.y) - first_m, 8);
  const int m0 = (first_m + lin % per_group % group_m) * kW8Tile;
  const int n0 = lin % per_group / group_m * kW8Tile;
  // Chunks a group (K15: gs 128, one), and this split's run of them.
  const int cpg = C::kNib ? (gs + kW8Tile - 1) / kW8Tile : 1;
  const int chunks = C::kNib ? K / gs * cpg : K / kW8Tile;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int T = max(0, min(chunks, c_begin + chunks_per_split) - c_begin);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // K8 / K11: the split's first chunk is chunk walk0.j of group walk0.g.
  // The loads, the decodes and the steps each walk the chunks in order
  // from there (ChunkWalk), with no division a chunk: in the loop, those
  // cost a quarter of the kernel's time.
  const int g0 = c_begin / cpg;
  const ChunkWalk walk0{g0, c_begin - g0 * cpg};
  ChunkWalk at_load = walk0, at_prep = walk0;
  // Chunk t, the next one of walk `w`: group g, first row k0, kn real
  // rows.
  auto chunk = [&](ChunkWalk& w, int t, int& g, int& k0, int& kn) {
    if constexpr (C::kNib) {
      g = w.g;
      k0 = w.g * gs + w.j * kW8Tile;
      kn = min(kW8Tile, gs - w.j * kW8Tile);
      w.next(cpg);
    } else {
      g = c_begin + t;
      k0 = g * kW8Tile;
      kn = kW8Tile;
    }
  };

  // Chunk t into stage t % S.
  auto load = [&](int t) {
    const int slot = t % S;
    int g, k0, kn;
    chunk(at_load, t, g, k0, kn);
    uint64_t* bar = &full[slot];
    mbar_expect_tx(bar, C::kWBytes + kW8SBytes + (C::kNib ? 64 : 0) +
                            (x_tma ? kW8Bytes : 0));
    if (x_tma) tma_load(x_s + slot * kW8Bytes, &x_map, bar, k0, m0);
    unsigned char* wd = w_s + slot * C::kWBytes;
    if constexpr (D == A8Dec::kGptq4) {
      tma_load(wd, &w_map, bar, n0, k0 / 8);
    } else if constexpr (D == A8Dec::kAwq4) {
      tma_load(wd, &w_map, bar, n0 / 8, k0);
    } else {
      tma_load(wd, &w_map, bar, n0, k0);
    }
    tma_load(sc_s + slot * kW8SBytes, &s_map, bar, n0, g);
    if constexpr (C::kNib)
      tma_load(z_s + slot * C::kZBytes, &z_map, bar, n0 / 8, g);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(S, T); ++t) load(t);
  }
  __syncthreads();

  const A8Decoder<D> dec(tid);
  // Chunk t's stage in place and its weight decoded into K-major tile
  // t % 3; x8 stored by the consumers where TMA could not load it (an
  // unaligned view). The caller fences the stores for the async proxy.
  auto prepare = [&](int t) {
    const int slot = t % S;
    mbar_wait(&full[slot], (t / S) & 1);
    int g, k0, kn;
    chunk(at_prep, t, g, k0, kn);
    if (!x_tma) {
      unsigned char* xd = x_s + slot * kW8Bytes;
      const int r = tid >> 1;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int cc = 4 * (tid & 1) + c4;    // 16-byte piece of the row
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (m0 + r < m) {
          const unsigned char* src = reinterpret_cast<const unsigned char*>(
              x8 + static_cast<size_t>(m0 + r) * K + k0 + cc * 16);
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (cc * 16 + b < kn)
              w[b >> 2] |= static_cast<uint32_t>(src[b]) << (8 * (b & 3));
        }
        *reinterpret_cast<uint4*>(xd + swz(r, cc)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // The scale row as f32, for the fold.
    if (tid < kW8Tile)
      sf_s[slot * kW8Tile + tid] = __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(sc_s +
                                                 slot * kW8SBytes)[tid]);
    const unsigned char* ws = w_s + slot * C::kWBytes;
    const uint32_t* zrow =
        reinterpret_cast<const uint32_t*>(z_s + slot * C::kZBytes);
    unsigned char* wt = wt_s + (t % kWtTiles) * kW8Bytes;
    if (!C::kNib || kn == kW8Tile) {
      dec.template run<true>(ws, zrow, wt, kn);
    } else {
      dec.template run<false>(ws, zrow, wt, kn);
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int sa[64], sb[64];
  const uint32_t x_base = smem_u32(x_s) + wg * 64 * 128;
  const uint32_t wt_base = smem_u32(wt_s);
  // This thread's first scale pair in chunk t's stage.
  auto srow = [&](int t) {
    return reinterpret_cast<const float2*>(sf_s + (t + S) % S * kW8Tile) +
           (tid & 3);
  };
  auto x_stage = [&](int t) { return x_base + (t % S) * kW8Bytes; };
  auto w_tile = [&](int t) { return wt_base + (t % kWtTiles) * kW8Bytes; };
  if (T > 0) prepare(0);
  fence_proxy_async();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if constexpr (!C::kNib) {
    // K15: every chunk is a group, so the sets alternate by step and the
    // loop runs an even number of steps: an odd T adds a last step whose
    // products (on a consumed stage) are never folded.
    for (int t = 0; t < T; t += 2) {
      w8a8_step<S>(t, T, true, sa, sb, acc, x_stage(t), w_tile(t),
                   srow(t - 1), prepare, load);
      w8a8_step<S>(t + 1, T, true, sb, sa, acc, x_stage(t + 1),
                   w_tile(t + 1), srow(t), prepare, load);
    }
    wgmma_wait<0>();
    if (T > 0 && T % 2 == 0) w8a8_fold(acc, sb, srow(T - 1));
  } else {
    // K8 / K11: a group's chunks accumulate into one set, the next group
    // into the other; a group past 64 chunks (8192 rows) is folded every
    // 64, so that every dot stays below 2^24 (8192 * 127 * 16).
    ChunkWalk at_step = walk0;            // chunk t's place
    bool last_a = true;                   // the last group's set
    int t = 0;
    while (t < T) {
      do {
        w8a8_step<S>(t, T, t == 0 || (at_step.j & 63) == 0, sa, sb, acc,
                     x_stage(t), w_tile(t), srow(t - 1), prepare, load);
        at_step.next(cpg);
      } while (++t < T && (at_step.j & 63) != 0);
      last_a = true;
      if (t >= T) break;
      do {
        w8a8_step<S>(t, T, (at_step.j & 63) == 0, sb, sa, acc, x_stage(t),
                     w_tile(t), srow(t - 1), prepare, load);
        at_step.next(cpg);
      } while (++t < T && (at_step.j & 63) != 0);
      last_a = false;
    }
    wgmma_wait<0>();
    if (T > 0) {
      if (last_a) {
        w8a8_fold(acc, sa, srow(T - 1));
      } else {
        w8a8_fold(acc, sb, srow(T - 1));
      }
    }
  }

  const int lt = tid & 127;
  const int row = m0 + wg * 64 + (lt >> 5) * 16 + ((lt & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + h * 8;
    if (r >= m) continue;
    const float rs = partial == nullptr ? xs[r] : 1.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + (lt & 3) * 2;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(
            partial + (static_cast<size_t>(blockIdx.z) * m + r) * N + col) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(r) * N + col) =
            __floats2bfloat162_rn(v0 * rs, v1 * rs);
      }
    }
  }
}

// K8, K11 at m > 64 and K15 above 12 rows: grid (N / 128, m / 128,
// splits); a split covers chunks_per_split chunks of 128 rows (K15: one a
// 128-row group; K8 / K11: ceil(gs / 128) a group) and writes f32
// partials, which split_reduce_kernel adds in split order and multiplies
// by xs. K15 takes qs8 [K, N] and s128 [K / 128, N]; K8 GPTQ's qweight
// [K / 8, N], qzeros [G, N / 8] and scales [G, N]; K11 AWQ's qweight [K,
// N / 8] and the same rows. Tensor maps are encoded per call (a host
// encoding each, no device work); the dynamic shared memory above 48 KB
// is allowed once per instance.
template <A8Dec D>
int launch_w8a8(const void* x8, const float* xs, const void* qw,
                const void* qz, const void* scales, void* out,
                float* partial, int m, int K, int N, int gs, int splits,
                cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  using C = W8Cfg<D>;
  if (splits < 1 || gs <= 0 || K % gs != 0 || N % kW8Tile != 0 ||
      (!C::kNib && gs != kW8Tile) || (D == A8Dec::kGptq4 && gs % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w8a8_gemm_kernel<D>;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const int G = K / gs;
  const int chunks = G * (C::kNib ? (gs + kW8Tile - 1) / kW8Tile : 1);
  const int per = (chunks + splits - 1) / splits;
  constexpr auto kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  constexpr auto kU32 = CU_TENSOR_MAP_DATA_TYPE_UINT32;
  constexpr auto kFlat = CU_TENSOR_MAP_SWIZZLE_NONE;
  // TMA for x8 needs a 16-byte aligned base, row stride and chunk start.
  const int x_tma = reinterpret_cast<uintptr_t>(x8) % 16 == 0 &&
                    K % 16 == 0 && gs % 16 == 0;
  CUtensorMap x_map{}, w_map{}, s_map{}, z_map{};
  bool ok = !x_tma || tensor_map(&x_map, kU8, 1, x8, K, m, kW8Tile, kW8Tile,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if constexpr (D == A8Dec::kGptq4) {
    ok = ok && tensor_map(&w_map, kU32, 4, qw, N, K / 8, kW8Tile,
                          kW8Tile / 8, kFlat);
  } else if constexpr (D == A8Dec::kAwq4) {
    ok = ok && tensor_map(&w_map, kU32, 4, qw, N / 8, K, kW8Tile / 8,
                          kW8Tile, kFlat);
  } else {
    ok = ok && tensor_map(&w_map, kU8, 1, qw, N, K, kW8Tile, kW8Tile, kFlat);
  }
  ok = ok && tensor_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, scales,
                        N, G, kW8Tile, 1, kFlat);
  if constexpr (C::kNib)
    ok = ok && tensor_map(&z_map, kU32, 4, qz, N / 8, G, kW8Tile / 8, 1,
                          kFlat);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  float* part = splits > 1 ? partial : nullptr;
  const dim3 grid(N / kW8Tile, (m + kW8Tile - 1) / kW8Tile, splits);
  kernel<<<grid, kW8Threads, C::kSmemBytes, stream>>>(
      x_map, w_map, s_map, z_map, static_cast<const int8_t*>(x8), xs,
      static_cast<__nv_bfloat16*>(out), part, m, K, N, gs, per, x_tma);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(m) * N;
    const int threads = 256;
    split_reduce_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>((total + threads - 1) / threads), threads,
           0, stream>>>(partial, xs, nullptr,
                        static_cast<__nv_bfloat16*>(out), splits, m, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm

// -------------------------------------- K7, K12, K13, K14, K16, K17 --
//
// quant_stream_kernel<BITS, D, A8, NT>: the products at m <= 64, every
// decode step up to batch 64: GPTQ (4 and 8 bits) and AWQ, a16 and a8
// arms (K7), GGUF's exact Q4_K form (K12, D kQ4k), its grouped int8 form
// (K14, D kI8g), its Q8_0 form (K13, D kQ8) and its turbo form on K9's
// int8 rows (K15, D kQs8, the a8 arm), int8 weights with f32 column
// scales (K17, D kInt8), and the codebook form on bf16 x (K16,
// SqueezeLLM, D kLut) and on f32 x (K16, QuIP#, D kLutX32). Bytes bound
// them: each packed word serves at most 64 rows, so the least time is
// the weight and its scale and zero rows (K12's dl and ml rows, K13's d,
// K14's d16 and K15's s128 rows, K16's codebook, K17's column scales)
// read once (34
// us per Mistral-7B layer at 3.35 TB/s for 4-bit codes, 66-73 us for the
// bytes). The design keeps those bytes in flight and spends few
// instructions per word once they land:
// - A cp.async ring per block of 128 output columns (eight warps): 3
//   stages of 128 k rows (8.5 KB; 2 of 16.5 KB at 8 bits; 2 of 16 KB for
//   K17's bytes, 16.25 KB for K15's with their s128 row, 17 KB for K13's
//   with their d rows, 18.25 KB for K14's with their d16 rows), 16-byte
//   cp.async.cg copies issued stages - 1 ahead, one block barrier a
//   stage.
// - x resident: the block's K range of x (M_TILE = 8 NT rows, at most
//   32: m 33-64 takes two row blocks; the wrapper's plan keeps it within
//   64 KB) and of the scale and zero rows is staged once, at the start,
//   x permuted in place into the fragments' k order. Small blocks, two
//   or three an SM, measured faster than deeper rings or more x a block
//   (PERF.md).
// - W straight into mma fragments ("swap AB"): y^T = W^T x^T with
//   mma.sync m16n8k16 (bf16) or m16n8k32 (s8, the a8 arm). A warp owns 16
//   output columns as the A operand's 16 rows and up to 64 x rows as NT
//   8-wide n-tiles; each k32 step's words are dequantized from the ring
//   into A-fragment registers, with no W tile and no barrier for it.
//   - Columns: A row g is column 2g of the warp's 16 and row g + 8 column
//     2g + 1, so a thread's two columns are neighbours: one 64-bit load of
//     their GPTQ words, one nibble pair (r, r + 4) of an AWQ word, one
//     bf16x2 store of the result.
//   - k: thread t of a quad takes rows 8t .. 8t + 7 of each k32 step, one
//     GPTQ word a column. bf16: the register of pair r = 2s + h (step s,
//     fragment half h) holds rows 8t + r and 8t + r + 4, (w >> 4r) &
//     0x000f000f, bf16 128 + q in one lop3; s8: rows 8t + 0, 2, 4, 6 in
//     the low k half, the odd rows in the high one. x is staged in that
//     order (each 8-row run permuted in place), so a thread's B fragments
//     of a step are one 16-byte (8-byte) shared load. AWQ takes the same
//     rows, one word each, and swaps the halves of its column pairs.
//   - Every W value is bf16(float(q - z) * s), as the plain version rounds
//     it: 128 + q and 128 + z are exact in bf16, so is their difference,
//     and one bf16x2 multiply rounds the product once (8 bits: the same in
//     f32, then one conversion). The AutoGPTQ +1 zero and the AWQ nibble
//     order are as in the other kernels.
//   - a8: codes minus zero, in [-16, 14] (GPTQ) or [-15, 15] (AWQ), as int8
//     bytes; exact int32 dots per group, folded into f32 in group order
//     with the group's scale row (`fold`), times xs[row] in the
//     epilogue or the split reduce.
//   - K12: GPTQ's 4-bit words and fragment map; a (dl, ml) pair of rows per
//     32 input rows takes the place of the scale and zero rows (a group of
//     32: one k32 step), carried in the ring stage beside its words (four
//     dl rows, then four ml rows), so no rows are staged up front. Each
//     value is bf16(f32(q) * dl - ml), the
//     product and the difference rounded separately in f32 (q * dl is
//     exact), as the plain version rounds it; q comes from the nibble pair
//     as bf16 128 + q, widened to f32 minus 128, exact.
//   - K14: int8 codes [K, N], MN-major: a stage row is the block's 128
//     bytes of one k row, its 16-byte pieces swizzled (i8g_piece) so that
//     one ldmatrix.x4.trans gives a lane its 8 rows x 2 columns of a step
//     in the fragment map above, conflict-free; the stage carries its
//     eight d16 rows (a row per 16 k rows: a thread's 8 rows lie in one),
//     and each value is bf16(q d) rounded once, as quant_gemm_kernel's
//     byte decoder rounds it. K13 and K17: the same stage and ldmatrix;
//     K13's stage carries its four d rows (a row per 32 k rows: step b is
//     one group), K17's none. Each code becomes bf16(q), exactly, by a
//     byte permute, two masks and a bf16x2 subtraction (`i8_pair`); K13
//     multiplies the pair by (d, d), one bf16x2 multiply rounding q d
//     once as the plain version does (bit for bit, zeros' signs too);
//     K17's f32 column scale multiplies the f32 sums in the epilogue or
//     the split reduce, then one rounding. They split over 32-row units;
//     the wrappers send K13 and K17 16 rows at most, K14 13
//     (Q8_STREAM_M_MAX, INT8_STREAM_M_MAX, I8G_STREAM_M_MAX: above,
//     quant_gemm_kernel, whose TMA loads run faster, takes less time; at
//     33-64 two row blocks would each read and decode the whole weight).
//     K is a multiple of 32: a split's last stage may be short.
//   - K15 (a8): K14's stage and ldmatrix on int8 codes qs8 [K, N], the
//     stage's one s128 row after them (a 128-row stage is exactly one
//     group). The a8 arm's register a[0][i] wants rows 8t + 0, 2, 4, 6
//     (i = 0, 1) or 8t + 1, 3, 5, 7 (i = 2, 3) of one column, and the
//     ldmatrix's register r holds rows 8t + r and 8t + r + 4 of both:
//     each A register is one byte permute of two of them, no conversion
//     and no multiply. The group's exact int32 sums are folded into f32
//     with the stage's scale row when its four steps are done, as the a8
//     arm folds, times xs[row] in the epilogue or the split reduce. It
//     splits over 128-row units (whole groups); the wrapper sends it 12
//     rows at most (K15_STREAM_M_MAX; above, w8a8_gemm_kernel, whose
//     128-row tiles take 0.16 ms a layer at any m up to 64).
//   - K16: GPTQ's 4-bit words, each code looked up in its column's
//     16-entry codebook, staged once a block in shared memory (16 KB).
//     The four lanes of a quad share their columns but hold other codes,
//     so a table lane t reads must lie in banks no other lane reads: bf16
//     (kLut) keeps four copies, lane t reading copy t, each word (q, p)
//     the entries of the column pair p = (2p, 2p + 1) for code q, placed
//     at p ^ 8t in its row, so the 32 lanes of every lookup hit 32 banks
//     whatever the codes; a value is one lookup, half a byte permute (the
//     pair's half). f32 (kLutX32, QuIP#): each entry split once into bf16
//     hi and lo, one word (hi | lo << 16) per (code, column), two copies
//     (lane t reads copy t / 2, column n at n ^ 16 (t / 2)); odd lanes
//     look up their two columns in the other order, so that lanes t and t
//     ^ 1 read other columns, and swap the results back: 32 banks again.
//     x is split once, when it is staged, into bf16 hi and lo runs in
//     fragment order, and each k16 takes three products, x_lo w_hi + x_hi
//     w_lo + x_hi w_hi, into f32 sums (bf16x3, about 2^-16 relative per
//     term); the output is f32.
// - Splits over whole units of lcm(gs, 32) rows, or of 32 rows where
//   that passes 1024 (gs = K, groups of 2048 and more: a split then
//   starts and ends inside a group, the a8 arm folding its share of the
//   group's sum), from shapes and the SM count alone (the wrapper's
//   stream_plan); split_reduce_kernel, a second launch on the same
//   stream, adds the f32 partials in split order. K12-K14, K16 and K17
//   split over 32-row units, K15 over 128-row units.
// Group sizes are multiples of 8, so a thread's rows of a step lie in one
// group; where a step crosses groups (gs not a multiple of 32) each thread
// takes its own group's zero and scale, and the a8 arm runs the step once
// per group with the other groups' codes masked to zero.
namespace streamed {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 16 * kWarps;        // output columns a tile
constexpr int kKC = 128;                // k rows a ring stage

// The word decoders: GPTQ's K-major words (K7, 4 or 8 bits), AWQ's
// interleaved ones (K7), GPTQ's 4-bit words with K12's (dl, ml) rows, the
// same words through K16's codebook on bf16 x or on f32 x, and MN-major
// int8 codes: K14's with a d16 row per 16 rows, K13's (Q8_0) with a d row
// per 32, K17's with none (an f32 scale per column in the epilogue), and
// K15's on the a8 arm with an s128 row per 128.
enum class SDec { kGptq, kAwq, kQ4k, kLut, kLutX32, kI8g, kQ8, kInt8, kQs8 };

template <int BITS, SDec D>
struct Cfg {
  static constexpr bool kAwq = D == SDec::kAwq;
  static constexpr bool kLut = D == SDec::kLut || D == SDec::kLutX32;
  static constexpr bool kBytes = D == SDec::kI8g || D == SDec::kQ8 ||
                                 D == SDec::kInt8 || D == SDec::kQs8;
  static constexpr int kPack = 32 / BITS;
  // A stage's words: GPTQ [kKC / pack word rows][kBN + pad words], the
  // pad (8 words at 4 bits, 4 at 8) putting the quads' 64-bit loads in
  // distinct banks; AWQ [kKC rows][kBN / 8 words], rows swizzled
  // (awq_word); the byte codes (K13-K15, K17) [kKC rows][128 bytes],
  // 16-byte pieces swizzled (i8g_piece).
  static constexpr int kRows = kAwq || kBytes ? kKC : kKC / kPack;
  static constexpr int kRowWords =
      kAwq ? kBN / 8 : kBytes ? kBN / 4 : kBN + (BITS == 4 ? 8 : 4);
  // K12: the stage also carries its four dl rows, then its four ml rows
  // (128 bf16 each), at word kRowsOff. The byte codes' kDRows scale rows
  // there, one a kKC / kDRows k rows, kDWords apart: K14's eight d16 rows,
  // kD16Words apart (the pad puts a warp's two rows of a step in other
  // banks); K13's four d rows, unpadded (a warp reads one row a step, 8
  // neighbouring words, each quad one); K15's one s128 row (the stage's
  // group); K17 none.
  static constexpr int kRowsOff = kRows * kRowWords;
  static constexpr int kD16Words = kBN / 2 + 8;
  static constexpr int kDRows = D == SDec::kI8g ? 8
                                : D == SDec::kQ8 ? 4
                                : D == SDec::kQs8 ? 1 : 0;
  static constexpr int kDWords = D == SDec::kI8g ? kD16Words : kBN / 2;
  static constexpr int kStageWords =
      kRowsOff + (D == SDec::kQ4k ? 8 * kBN / 2 : kDRows * kDWords);
  static constexpr int kStages = BITS == 8 ? 2 : 3;
  static constexpr int kRingBytes = kStages * kStageWords * 4;
  // The split's rows staged once: a group's scale row and zero row
  // (GPTQ, AWQ); K12's, K13's, K14's and K15's rows come with the ring
  // stages, K16 and K17 have none.
  static constexpr bool kGroupRows = D == SDec::kGptq || D == SDec::kAwq;
  static constexpr int kScaleBytes = kGroupRows ? kBN * 2 : 0;
  static constexpr int kZeroWords = kGroupRows ? kBN / kPack : 0;
  // K16's codebook: bf16 four copies of [16 codes][64 column pairs], f32
  // two copies of [16 codes][128 columns] of (hi | lo << 16), 16 KB each.
  static constexpr int kLutBytes = kLut ? 16384 : 0;
};

// AWQ stage: the word offset of word w of row r. Rows of kBN / 8 words
// pack 128-byte lines; within its line a row's place is XORed with
// (r >> 3) & 3 times 8 words (4 where rows are 16 words), so the rows 8t
// + j that the four quads read together fall in distinct banks, and
// 16-byte copies stay whole.
__device__ __forceinline__ int awq_word(int r, int w) {
  constexpr int kRowWords = kBN / 8;
  const int e = r * kRowWords + w;
  return (e & ~31) | ((e & 31) ^ (((r >> 3) & 3) * (kRowWords == 16 ? 4 : 8)));
}

// Bytes of a row of resident x: the block's K range rounded up to 128,
// plus half (bf16), a quarter (int8) or an eighth (f32 x as bf16 hi and
// lo runs) of a line, so that the rows one shared load reads fall in
// distinct banks.
__host__ __device__ constexpr int x_stride(int k_rows, int es) {
  return (k_rows * es + 127) / 128 * 128 + (es == 2 ? 64 : es == 1 ? 32 : 16);
}

// K14 stage: the byte offset of 16-byte piece c (columns 16c .. 16c + 15)
// of k row r. Piece c ^ ((r >> 2) & 7) of the row's 128 bytes, so the
// eight rows one ldmatrix matrix reads (r0 + 4i, i = 0 .. 7, r0 < 4) fall
// in eight distinct 16-byte bank groups.
__device__ __forceinline__ int i8g_piece(int r, int c) {
  return r * 128 + ((c ^ ((r >> 2) & 7)) << 4);
}

__host__ __device__ constexpr int gcd_int(int a, int b) {
  return b == 0 ? a : gcd_int(b, a % b);
}

// The split unit: lcm(gs, 32) rows, whole groups and whole k32 steps, up
// to 1024 rows (32 rows of bf16 x over it fill a block's 64 KB); past
// that one k32 step (gs = K, groups of 2048 rows and more), and a split
// may start and end inside a group.
__host__ __device__ constexpr int split_unit(int gs) {
  return gs / gcd_int(gs, 32) * 32 <= 1024 ? gs / gcd_int(gs, 32) * 32 : 32;
}

// The most groups one split's k rows touch.
inline int split_groups(int K, int gs, int k_split) {
  int most = 0;
  for (int k0 = 0; k0 < K; k0 += k_split)
    most = std::max(most,
                    (std::min(K, k0 + k_split) - 1) / gs - k0 / gs + 1);
  return most;
}

// Bytes of resident x an element: int8 (a8), bf16, or f32 x as bf16 hi
// and lo.
template <SDec D, bool A8>
__host__ __device__ constexpr int x_elem_bytes() {
  return A8 ? 1 : D == SDec::kLutX32 ? 4 : 2;
}

// The ring, K16's codebook, the split's scale and zero rows, and its x.
template <int BITS, SDec D, bool A8>
constexpr int smem_bytes(int k_rows, int groups, int nt) {
  using C = Cfg<BITS, D>;
  return C::kRingBytes + C::kLutBytes +
         groups * (C::kScaleBytes + C::kZeroWords * 4) +
         8 * nt * x_stride(k_rows, x_elem_bytes<D, A8>());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}
// Four 8 x 8 b16 matrices, transposed: lane l gives the row address of
// matrix l / 8, row l % 8, and gets rows 2 (l % 4) and + 1 of column l / 4
// of each (one register a matrix, the first row in the low half).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&v)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

using gemm::s8_codes;
using gemm::split_bf16;

// A group's constants for the thread's columns c0 and c0 + 1: z0 / z1 and
// s0 / s1 per column (GPTQ bf16x2 pairs of one value, 8 bits f32 bits);
// AWQ both columns in one bf16x2 (z0, s0); a8 zeros replicated per byte;
// K12 -ml (z) and dl (s) as f32 bits (`q4k_consts`); K16 no group: s0 /
// s1 the byte offsets of the thread's codebook entries (`lut_lanes`).
struct Consts {
  uint32_t z0, z1, s0, s1;
};

template <int BITS, SDec D, bool A8>
__device__ __forceinline__ Consts group_consts(const __nv_bfloat16* sc_s,
                                               const uint32_t* z_s, int g,
                                               int c0) {
  using C = Cfg<BITS, D>;
  const uint32_t s2 = ld32(sc_s + g * kBN + c0);       // s[c0], s[c0 + 1]
  const uint32_t zw = z_s[g * C::kZeroWords + c0 / C::kPack];
  Consts q{0u, 0u, 0u, 0u};
  if constexpr (C::kAwq) {
    // c0 and c0 + 1 at nibbles r and r + 4 of their word, r = (c0 % 8) / 2.
    const uint32_t v = zw >> (2 * (c0 & 7));
    if constexpr (A8) {
      q.z0 = (v & 0xfu) * 0x01010101u;
      q.z1 = ((v >> 16) & 0xfu) * 0x01010101u;
    } else {
      q.z0 = gemm::nib2(v);                            // 128 + z, both
      q.s0 = s2;
    }
  } else {
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    const uint32_t v = zw >> (BITS * (c0 % C::kPack));
    const uint32_t za = (v & kMask) + 1u;              // the AutoGPTQ +1
    const uint32_t zb = ((v >> BITS) & kMask) + 1u;
    if constexpr (A8) {
      q.z0 = za * 0x01010101u;
      q.z1 = zb * 0x01010101u;
    } else if constexpr (BITS == 4) {
      q.z0 = (0x4300u | za) * 0x10001u;
      q.z1 = (0x4300u | zb) * 0x10001u;
      q.s0 = __byte_perm(s2, s2, 0x1010);
      q.s1 = __byte_perm(s2, s2, 0x3232);
    } else {
      q.z0 = __float_as_uint(8388608.f + static_cast<float>(za));
      q.z1 = __float_as_uint(8388608.f + static_cast<float>(zb));
      q.s0 = s2 << 16;                                 // f32 of the bf16
      q.s1 = s2 & 0xffff0000u;
    }
  }
  return q;
}

// K12, step b of a stage: dl and ml of the thread's columns c0 (low
// halves of the rows' words) and c0 + 1, as f32 bits; -ml by its sign.
template <int BITS, SDec D>
__device__ __forceinline__ Consts q4k_consts(const uint32_t* stage, int b,
                                             int c0) {
  using C = Cfg<BITS, D>;
  const uint32_t d2 = stage[C::kRowsOff + b * (kBN / 2) + c0 / 2];
  const uint32_t m2 = stage[C::kRowsOff + (4 + b) * (kBN / 2) + c0 / 2];
  return Consts{(m2 << 16) ^ 0x80000000u, (m2 & 0xffff0000u) ^ 0x80000000u,
                d2 << 16, d2 & 0xffff0000u};
}

// K14: in z0, the byte offset in a stage's first k32 step of the row
// address lane `lane` of `warp` gives ldmatrix (step b adds b * 4096):
// matrix r = lane / 8, row j = lane % 8 is k row 8 (j / 2) + r + 4 (j % 2)
// of the step, in the warp's 16-byte piece. Lane (gid, t) then gets rows
// 8t + r and 8t + r + 4 of its two columns in register r.
__device__ __forceinline__ Consts i8g_lane(int warp, int lane) {
  const int r = lane >> 3, j = lane & 7;
  const int row = 8 * (j >> 1) + r + 4 * (j & 1);
  return Consts{static_cast<uint32_t>(i8g_piece(row, warp)), 0u, 0u, 0u};
}

// K16: the byte offsets in the codebook of lane (warp, gid, t)'s entries,
// without the code (`lut_offset` ors it in): kLut copy t, the column pair p
// = 8 warp + gid at p ^ 8t (s0); kLutX32 copy t / 2, column c0 + (t & 1)
// (s0) and c0 + 1 - (t & 1) (s1) at n ^ 16 (t / 2).
template <SDec D>
__device__ __forceinline__ Consts lut_lanes(int warp, int gid, int t) {
  Consts q{0u, 0u, 0u, 0u};
  if constexpr (D == SDec::kLut) {
    const int p = 8 * warp + gid;
    q.s0 = static_cast<uint32_t>(4096 * t + 4 * (p ^ (8 * t)));
  } else {
    const int u = t >> 1, odd = t & 1, c0 = 16 * warp + 2 * gid;
    q.s0 = static_cast<uint32_t>(8192 * u + 4 * ((c0 + odd) ^ (16 * u)));
    q.s1 = static_cast<uint32_t>(8192 * u + 4 * ((c0 + 1 - odd) ^ (16 * u)));
  }
  return q;
}

// This thread's A fragments of k32 step b of a stage: bf16 a[s] for the
// two m16n8k16 steps (a[s][2h] column c0 and a[s][2h + 1] column c0 + 1 at
// rows 8t + 2s + h and 8t + 2s + h + 4), s8 a[0] for the m16n8k32 (a[0][0]
// and a[0][1] rows 8t + 0, 2, 4, 6 of c0 and c0 + 1, a[0][2] and a[0][3]
// the odd rows); kLutX32 the hi halves in a, the lo halves in al. `lut`:
// K16's codebook. K14: d0 / d1 (s0 / s1) the f32 bits of the step's d16
// pair, z0 the lane's ldmatrix row (i8g_lane).
template <int BITS, SDec D, bool A8>
__device__ __forceinline__ void step_fragments(const uint32_t* stage,
                                               const unsigned char* lut,
                                               int b, int warp, int gid,
                                               int t, const Consts& q,
                                               uint32_t (&a)[2][4],
                                               uint32_t (&al)[2][4]) {
  using C = Cfg<BITS, D>;
  using gemm::bf2_mul;
  using gemm::bf2_sub;
  using gemm::nib2;
  if constexpr (C::kAwq) {
    // Rows 32b + 8t + j of word column 2 warp + gid / 4, shifted so the
    // thread's columns sit at nibbles 0 and 4.
    const int wc = 2 * warp + (gid >> 2);
    const int sh = 4 * (gid & 3);
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = stage[awq_word(32 * b + 8 * t + j, wc)] >> sh;
    if constexpr (A8) {
      const uint32_t p02 = __byte_perm(v[0], v[2], 0x6240);
      const uint32_t p46 = __byte_perm(v[4], v[6], 0x6240);
      const uint32_t p13 = __byte_perm(v[1], v[3], 0x6240);
      const uint32_t p57 = __byte_perm(v[5], v[7], 0x6240);
      a[0][0] = s8_codes(__byte_perm(p02, p46, 0x5410), q.z0);
      a[0][1] = s8_codes(__byte_perm(p02, p46, 0x7632), q.z1);
      a[0][2] = s8_codes(__byte_perm(p13, p57, 0x5410), q.z0);
      a[0][3] = s8_codes(__byte_perm(p13, p57, 0x7632), q.z1);
    } else {
      uint32_t p[8];      // (c0, c0 + 1) at row 8t + j, dequantized
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[j] = bf2_mul(bf2_sub(nib2(v[j]), q.z0), q.s0);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * s + h;
          a[s][2 * h] = __byte_perm(p[r], p[r + 4], 0x5410);
          a[s][2 * h + 1] = __byte_perm(p[r], p[r + 4], 0x7632);
        }
    }
  } else if constexpr (BITS == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        stage + (4 * b + t) * C::kRowWords + warp * 16 + 2 * gid);
    if constexpr (A8) {
      a[0][0] = s8_codes(w.x, q.z0);
      a[0][1] = s8_codes(w.y, q.z1);
      a[0][2] = s8_codes(w.x >> 4, q.z0);
      a[0][3] = s8_codes(w.y >> 4, q.z1);
    } else if constexpr (D == SDec::kQ4k) {
      // bf16(q * dl - ml), q * dl exact, each step rounded in f32.
      const float dl[2] = {__uint_as_float(q.s0), __uint_as_float(q.s1)};
      const float nml[2] = {__uint_as_float(q.z0), __uint_as_float(q.z1)};
      const uint32_t wc[2] = {w.x, w.y};
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t v = nib2(wc[c] >> (8 * s + 4 * h));
            const float q0 = __fsub_rn(__uint_as_float(v << 16), 128.f);
            const float q1 =
                __fsub_rn(__uint_as_float(v & 0xffff0000u), 128.f);
            a[s][2 * h + c] = gemm::pack_bf2(
                __fadd_rn(__fmul_rn(q0, dl[c]), nml[c]),
                __fadd_rn(__fmul_rn(q1, dl[c]), nml[c]));
          }
    } else if constexpr (D == SDec::kLut) {
      // Rows r and r + 4: the pair words' low halves (c0), high (c0 + 1).
      auto e = [&](uint32_t v, int j) {
        return ld32(lut + gemm::lut_offset<8>(v, j, q.s0));
      };
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * s + h;
          a[s][2 * h] = __byte_perm(e(w.x, r), e(w.x, r + 4), 0x5410);
          a[s][2 * h + 1] = __byte_perm(e(w.y, r), e(w.y, r + 4), 0x7632);
        }
    } else if constexpr (D == SDec::kLutX32) {
      // Column A (c0 + odd) at s0, B at s1; the hi halves pair into a,
      // the lo halves into al; odd lanes swap A and B back.
      const bool odd = t & 1;
      const uint32_t wa = odd ? w.y : w.x, wb = odd ? w.x : w.y;
      auto e = [&](uint32_t v, int j, uint32_t col) {
        return ld32(lut + gemm::lut_offset<9>(v, j, col));
      };
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * s + h;
          const uint32_t a0 = e(wa, r, q.s0), a4 = e(wa, r + 4, q.s0);
          const uint32_t b0 = e(wb, r, q.s1), b4 = e(wb, r + 4, q.s1);
          const uint32_t ha = __byte_perm(a0, a4, 0x5410);
          const uint32_t la = __byte_perm(a0, a4, 0x7632);
          const uint32_t hb = __byte_perm(b0, b4, 0x5410);
          const uint32_t lb = __byte_perm(b0, b4, 0x7632);
          a[s][2 * h] = odd ? hb : ha;
          a[s][2 * h + 1] = odd ? ha : hb;
          al[s][2 * h] = odd ? lb : la;
          al[s][2 * h + 1] = odd ? la : lb;
        }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sh = 8 * s + 4 * h;
          a[s][2 * h] = bf2_mul(bf2_sub(nib2(w.x >> sh), q.z0), q.s0);
          a[s][2 * h + 1] = bf2_mul(bf2_sub(nib2(w.y >> sh), q.z1), q.s1);
        }
    }
  } else if constexpr (D == SDec::kQs8) {
    // K15 (a8): K14's ldmatrix (below); register r holds q[8t + r] and
    // q[8t + r + 4] of c0 (bytes 0, 2) and c0 + 1 (bytes 1, 3). Rows 8t +
    // 0, 2, 4, 6 of c0 are bytes 0 of v[0], v[2], then bytes 2 of them;
    // the odd rows the same of v[1], v[3]; c0 + 1 bytes 1 and 3.
    uint32_t v[4];
    ldsm_x4_trans(v, static_cast<uint32_t>(__cvta_generic_to_shared(stage)) +
                         b * 32 * 128 + q.z0);
    a[0][0] = __byte_perm(v[0], v[2], 0x6240);
    a[0][1] = __byte_perm(v[0], v[2], 0x7351);
    a[0][2] = __byte_perm(v[1], v[3], 0x6240);
    a[0][3] = __byte_perm(v[1], v[3], 0x7351);
  } else if constexpr (D == SDec::kQ8 || D == SDec::kInt8) {
    // K13 and K17: K14's ldmatrix (below). Bytes 0 and 2 of register r
    // (column c0 at rows 8t + r and + 4) and bytes 1 and 3 (c0 + 1) become
    // exact bf16 pairs of q by `i8_pair`; K13 then multiplies each by its
    // column's (d, d) in one bf16x2 multiply, the exact product q d
    // rounded once (a zero keeps the product's sign, as the plain
    // version's f32 product does). K17's codes stay as they are; its
    // column scale comes in the epilogue.
    uint32_t v[4];
    ldsm_x4_trans(v, static_cast<uint32_t>(__cvta_generic_to_shared(stage)) +
                         b * 32 * 128 + q.z0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t p0 = gemm::i8_pair(v[r], 0x4240);
      uint32_t p1 = gemm::i8_pair(v[r], 0x4341);
      if constexpr (D == SDec::kQ8) {
        p0 = bf2_mul(p0, q.s0);
        p1 = bf2_mul(p1, q.s1);
      }
      a[r >> 1][2 * (r & 1)] = p0;
      a[r >> 1][2 * (r & 1) + 1] = p1;
    }
  } else if constexpr (C::kBytes) {
    // K14: one ldmatrix of the step's 32 rows of the warp's 16 columns;
    // register r = 2s + h holds (q[8t + r][c0], q[8t + r][c0 + 1],
    // q[8t + r + 4][c0], q[8t + r + 4][c0 + 1]). As quant_gemm_kernel's
    // byte decoder: q ^ 0x80 = q + 128, 2^23 + q + 128 is a float by one
    // byte permute, and fma(2^23 + q + 128, d, -(2^23 + 128) d) = q d
    // exactly, rounded once to bf16 by the pack.
    uint32_t v[4];
    ldsm_x4_trans(v, static_cast<uint32_t>(__cvta_generic_to_shared(stage)) +
                         b * 32 * 128 + q.z0);
    const float d0 = __uint_as_float(q.s0), d1 = __uint_as_float(q.s1);
    const float e0 = __fmul_rn(-8388736.f, d0);
    const float e1 = __fmul_rn(-8388736.f, d1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t w = v[r] ^ 0x80808080u;
      auto val = [w](int byte, float d, float e) {
        return __fmaf_rn(
            __uint_as_float(__byte_perm(w, 0x4b000000u, byte | 0x7440)), d,
            e);
      };
      a[r >> 1][2 * (r & 1)] = gemm::pack_bf2(val(0, d0, e0), val(2, d0, e0));
      a[r >> 1][2 * (r & 1) + 1] =
          gemm::pack_bf2(val(1, d1, e1), val(3, d1, e1));
    }
  } else {
    // 8 bits: rows 8t .. 8t + 3 in word row 8b + 2t, the next four in the
    // row after; q - z as (2^23 + q) - (2^23 + z) in f32, exact, times s,
    // exact, rounded once to bf16.
    const uint32_t* row = stage + (8 * b + 2 * t) * C::kRowWords +
                          warp * 16 + 2 * gid;
    const uint2 lo = *reinterpret_cast<const uint2*>(row);
    const uint2 hi = *reinterpret_cast<const uint2*>(row + C::kRowWords);
    const float z0 = __uint_as_float(q.z0), z1 = __uint_as_float(q.z1);
    const float s0 = __uint_as_float(q.s0), s1 = __uint_as_float(q.s1);
    auto val = [](uint32_t w, int byte, float z, float s) {
      return (__uint_as_float(__byte_perm(w, 0x4b000000u, byte | 0x7440)) -
              z) * s;
    };
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * s + h;
        a[s][2 * h] =
            gemm::pack_bf2(val(lo.x, r, z0, s0), val(hi.x, r, z0, s0));
        a[s][2 * h + 1] =
            gemm::pack_bf2(val(lo.y, r, z1, s1), val(hi.y, r, z1, s1));
      }
  }
}

// Grid (N / kBN, m / (8 NT), splits), kThreads: row block y takes x rows
// [8 NT y, + 8 NT). Split z covers k rows [z k_split,
// min(K, (z + 1) k_split)), whole units of split_unit; without a split
// (partial null) the result goes to out (bf16, a8: times xs[row]; f32 for
// kLutX32; K17 times its column scales), else the f32 sums to
// partial[z][row][col]. K12: qzeros the ml rows, scales the dl rows, gs
// 32; K13, K14, K17: qweight the int8 codes [K, N], scales K13's d rows
// (gs 32), K14's d16 rows (gs 16) or K17's f32 column scales [N] (gs
// 32); K16: scales the codebook [N, 16] (bf16, or f32 for kLutX32), gs
// 32, no qzeros.
template <int BITS, SDec D, bool A8, int NT>
__global__ void __launch_bounds__(kThreads, 2)
quant_stream_kernel(
    const void* __restrict__ x, const float* __restrict__ xs,
    const uint32_t* __restrict__ qweight, const uint32_t* __restrict__ qzeros,
    const void* __restrict__ scales, void* __restrict__ out,
    float* __restrict__ partial, int m, int K, int N, int gs, int k_split) {
  using C = Cfg<BITS, D>;
  constexpr bool X32 = D == SDec::kLutX32;
  constexpr int ES = x_elem_bytes<D, A8>();
  static_assert(!A8 || D == SDec::kGptq || D == SDec::kAwq ||
                    D == SDec::kQs8,
                "the a8 arm takes GPTQ and AWQ words and K15's bytes");
  static_assert(A8 || D != SDec::kQs8, "K15's codes take int8 x");
  static_assert(BITS == 4 || D == SDec::kGptq || C::kBytes,
                "8-bit codes are GPTQ's or bytes");
  static_assert(!C::kBytes || BITS == 8, "byte codes are 8 bits");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * 8 * NT;          // the block's first x row
  const int k_begin = blockIdx.z * k_split;
  const int k_rows = min(K - k_begin, k_split);
  const int n_kb = k_rows / 32;
  const int g_begin = k_begin / gs;            // groups the split touches
  const int n_groups = (k_begin + k_rows - 1) / gs - g_begin + 1;
  const int n_stages = (n_kb + 3) / 4;
  const int xrow = x_stride(k_rows, ES);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  const unsigned char* lut_s = smem + C::kRingBytes;
  __nv_bfloat16* sc_s =
      reinterpret_cast<__nv_bfloat16*>(smem + C::kRingBytes + C::kLutBytes);
  uint32_t* z_s = reinterpret_cast<uint32_t*>(
      reinterpret_cast<unsigned char*>(sc_s) + n_groups * C::kScaleBytes);
  unsigned char* x_s =
      reinterpret_cast<unsigned char*>(z_s + n_groups * C::kZeroWords);

  // The split's scale and zero rows and x rows [0, m) of its K range, in
  // the first copy group. Rows past m are never stored: their products
  // land in outputs no one writes.
  if constexpr (C::kGroupRows) {
    constexpr int kSc = kBN / 8, kZc = C::kZeroWords / 4;
    const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
    for (int i = tid; i < n_groups * kSc; i += kThreads) {
      const int g = i / kSc, c = i % kSc;
      cp_async16(sc_s + g * kBN + c * 8,
                 sc + static_cast<size_t>(g_begin + g) * N + n0 + c * 8);
    }
    for (int i = tid; i < n_groups * kZc; i += kThreads) {
      const int g = i / kZc, c = i % kZc;
      cp_async16(z_s + g * C::kZeroWords + c * 4,
                 qzeros + static_cast<size_t>(g_begin + g) * (N / C::kPack) +
                     n0 / C::kPack + c * 4);
    }
  }
  const int rows = min(m - m0, 8 * NT);
  const int runs = k_rows * ES / 16;          // 16-byte runs of a row
  const unsigned char* xb = static_cast<const unsigned char*>(x) +
                            (static_cast<size_t>(m0) * K + k_begin) * ES;
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!X32 && x_vec)
    for (int r = 0; r < rows; ++r)
      for (int c = tid; c < runs; c += kThreads)
        cp_async16(x_s + r * xrow + c * 16,
                   xb + static_cast<size_t>(r) * K * ES + c * 16);
  // Stage st: k rows [k_begin + st kKC, + kKC) of the block's columns.
  auto issue = [&](int st) {
    if (st < n_stages) {
      uint32_t* dst = ring + (st % C::kStages) * C::kStageWords;
      const int k0 = k_begin + st * kKC;
      const int rows_k = min(kKC, k_begin + k_rows - k0);
      if constexpr (C::kAwq) {
        constexpr int kCopies = kBN / 32;         // 16-byte copies a row
        const size_t ld = static_cast<size_t>(N / 8);
        const uint32_t* src = qweight + k0 * ld + n0 / 8;
        for (int i = tid; i < rows_k * kCopies; i += kThreads) {
          const int r = i / kCopies, c = i % kCopies;
          cp_async16(dst + awq_word(r, 4 * c), src + r * ld + 4 * c);
        }
      } else if constexpr (C::kBytes) {
        // K13, K14, K17: each k row's 128 bytes (i8g_piece), then the
        // stage's scale rows (`scales`: K14's d16, one a 16-row group;
        // K13's d, one a 32-row group; K17 none), 16 copies a row.
        constexpr int kCopies = kBN / 16;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(qweight) +
            static_cast<size_t>(k0) * N + n0;
        unsigned char* dstb = reinterpret_cast<unsigned char*>(dst);
        for (int i = tid; i < rows_k * kCopies; i += kThreads) {
          const int r = i / kCopies, c = i % kCopies;
          cp_async16(dstb + i8g_piece(r, c),
                     src + static_cast<size_t>(r) * N + c * 16);
        }
        if constexpr (C::kDRows > 0) {
          constexpr int kDRowK = kKC / C::kDRows;    // k rows a d row
          const int g0 = k0 / kDRowK, ng = rows_k / kDRowK;
          const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(scales);
          for (int i = tid; i < ng * 16; i += kThreads) {
            const int r = i / 16, c = i % 16;
            cp_async16(dst + C::kRowsOff + r * C::kDWords + c * 4,
                       d + static_cast<size_t>(g0 + r) * N + n0 + c * 8);
          }
        }
      } else {
        constexpr int kCopies = kBN / 4;
        const uint32_t* src =
            qweight + static_cast<size_t>(k0 / C::kPack) * N + n0;
        for (int i = tid; i < rows_k / C::kPack * kCopies; i += kThreads) {
          const int r = i / kCopies, c = i % kCopies;
          cp_async16(dst + r * C::kRowWords + 4 * c,
                     src + static_cast<size_t>(r) * N + 4 * c);
        }
        if constexpr (D == SDec::kQ4k) {
          // The stage's dl rows (`scales`) then its ml rows (`qzeros`),
          // one a 32-row group, 16 copies a row.
          const int g0 = k0 / 32, ng = rows_k / 32;
          for (int i = tid; i < 2 * ng * 16; i += kThreads) {
            const int h = i / (ng * 16), r = i / 16 % ng, c = i % 16;
            const void* row = h ? static_cast<const void*>(qzeros) : scales;
            cp_async16(dst + C::kRowsOff + (4 * h + r) * (kBN / 2) + c * 4,
                       static_cast<const __nv_bfloat16*>(row) +
                           static_cast<size_t>(g0 + r) * N + n0 + c * 8);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) issue(s);

  // x in fragment order: each run of 8 k rows permuted in place, bf16
  // rows 0, 4, 1, 5, 2, 6, 3, 7 and int8 0, 2, 4, 6, 1, 3, 5, 7.
  auto permute = [](uint4 v) {
    if constexpr (A8)
      return make_uint4(__byte_perm(v.x, v.y, 0x6420),
                        __byte_perm(v.x, v.y, 0x7531),
                        __byte_perm(v.z, v.w, 0x6420),
                        __byte_perm(v.z, v.w, 0x7531));
    else
      return make_uint4(__byte_perm(v.x, v.z, 0x5410),
                        __byte_perm(v.x, v.z, 0x7632),
                        __byte_perm(v.y, v.w, 0x5410),
                        __byte_perm(v.y, v.w, 0x7632));
  };
  if constexpr (X32) {
    // f32 x, split once into bf16 hi and lo: each run of 8 k rows is 32
    // bytes, the hi run in bf16 fragment order and the lo run after it.
    const int runs8 = k_rows / 8;
    const float* xf = static_cast<const float*>(x) +
                      static_cast<size_t>(m0) * K + k_begin;
    for (int i = tid; i < rows * runs8; i += kThreads) {
      const int r = i / runs8, c = i % runs8;
      const float* src = xf + static_cast<size_t>(r) * K + c * 8;
      float v[8];
      if (x_vec) {
        const float4 p = reinterpret_cast<const float4*>(src)[0];
        const float4 u = reinterpret_cast<const float4*>(src)[1];
        v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
        v[4] = u.x; v[5] = u.y; v[6] = u.z; v[7] = u.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = src[j];
      }
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_bf16(v[j], v[j + 4], h[j], l[j]);
      uint4* dst = reinterpret_cast<uint4*>(x_s + r * xrow + c * 32);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(l[0], l[1], l[2], l[3]);
    }
  } else if (!x_vec) {
    // An unaligned view of x: byte loads, permuted on the way.
    for (int r = 0; r < rows; ++r)
      for (int c = tid; c < runs; c += kThreads) {
        const unsigned char* src =
            xb + static_cast<size_t>(r) * K * ES + c * 16;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = src[4 * i] | (src[4 * i + 1] << 8) | (src[4 * i + 2] << 16) |
                 (static_cast<uint32_t>(src[4 * i + 3]) << 24);
        *reinterpret_cast<uint4*>(x_s + r * xrow + c * 16) =
            permute(make_uint4(w[0], w[1], w[2], w[3]));
      }
  }
  if constexpr (C::kLut) {
    // K16's codebook, the block's 128 columns (see the header).
    uint32_t* lut = reinterpret_cast<uint32_t*>(smem + C::kRingBytes);
    if constexpr (X32) {
      const int n = tid & 127, q0 = 8 * (tid >> 7);
      const float* src = static_cast<const float*>(scales) +
                         static_cast<size_t>(n0 + n) * 16 + q0;
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        uint32_t h, l;
        split_bf16(__ldg(src + i), __ldg(src + i + 1), h, l);
        const uint32_t e0 = __byte_perm(h, l, 0x5410);   // hi | lo << 16
        const uint32_t e1 = __byte_perm(h, l, 0x7632);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          lut[u * 2048 + (q0 + i) * 128 + (n ^ (16 * u))] = e0;
          lut[u * 2048 + (q0 + i + 1) * 128 + (n ^ (16 * u))] = e1;
        }
      }
    } else {
      const int p = tid & 63, q0 = 4 * (tid >> 6);
      const uint16_t* src = static_cast<const uint16_t*>(scales) +
                            static_cast<size_t>(n0 + 2 * p) * 16 + q0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t e = static_cast<uint32_t>(__ldg(src + i)) |
                           static_cast<uint32_t>(__ldg(src + 16 + i)) << 16;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          lut[c * 1024 + (q0 + i) * 64 + (p ^ (8 * c))] = e;
      }
    }
  }

  float acc[NT][4];
  int iacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = 0.f;
      iacc[nt][e] = 0;
    }
  const int n_nt = min(NT, (m - m0 + 7) / 8);  // n-tiles with a live row
  const int c0 = warp * 16 + 2 * gid;          // the thread's columns
  const unsigned char* x_lane = x_s + gid * xrow + t * 8 * ES;
  Consts q{0u, 0u, 0u, 0u};
  if constexpr (C::kLut) q = lut_lanes<D>(warp, gid, t);
  if constexpr (C::kBytes) q = i8g_lane(warp, lane);
  // The thread's group and its end, k from k_begin (the split may start
  // inside a group); a8: the group being summed.
  int sg = -1, sg_end = g_begin * gs - k_begin;
  int fg = 0, fg_end = sg_end + gs;

  // a8: the step's s8 products into the exact group sums.
  auto products_s8 = [&](const uint32_t* af, int kb) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < n_nt) {
        const uint2 xv = *reinterpret_cast<const uint2*>(
            x_lane + nt * 8 * xrow + kb * 32);
        const uint32_t bf[2] = {xv.x, xv.y};
        mma_s8(iacc[nt], af, bf);
      }
  };
  // a8: group fg's scales of columns c0, c0 + 1 (K15: the stage's s128
  // row, its one group; GPTQ, AWQ: the rows staged up front).
  auto group_scales = [&](const uint32_t* stage) {
    if constexpr (C::kBytes)
      return stage[C::kRowsOff + c0 / 2];
    else
      return ld32(sc_s + fg * kBN + c0);
  };
  // a8, at group fg's end: its sums times its scales, added in group order.
  auto fold = [&](uint32_t s2) {
    const float s0 = __uint_as_float(s2 << 16);
    const float s1 = __uint_as_float(s2 & 0xffff0000u);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e] = __fadd_rn(acc[nt][e],
                               __fmul_rn(static_cast<float>(iacc[nt][e]),
                                         e < 2 ? s0 : s1));
        iacc[nt][e] = 0;
      }
    ++fg;
    fg_end += gs;
  };

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();              // stage st landed; stage st - 1 is free
    if (!X32 && st == 0 && x_vec) {   // x, the scale and zero rows landed
      for (int r = 0; r < rows; ++r)
        for (int c = tid; c < runs; c += kThreads) {
          uint4* p = reinterpret_cast<uint4*>(x_s + r * xrow + c * 16);
          *p = permute(*p);
        }
      __syncthreads();
    }
    issue(st + C::kStages - 1);
    const uint32_t* stage = ring + (st % C::kStages) * C::kStageWords;
    const int nb = min(4, n_kb - st * 4);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b >= nb) break;
      const int kb = st * 4 + b;
      const int kk = kb * 32;
      if constexpr (D == SDec::kQ4k) {
        q = q4k_consts<BITS, D>(stage, b, c0);   // step b is one group
      } else if constexpr (D == SDec::kI8g) {
        // K14: the thread's rows 8t .. 8t + 7 lie in d16 row 2b + t / 2.
        const uint32_t d2 =
            stage[C::kRowsOff + (2 * b + (t >> 1)) * C::kD16Words + c0 / 2];
        q.s0 = d2 << 16;
        q.s1 = d2 & 0xffff0000u;
      } else if constexpr (D == SDec::kQ8) {
        // K13: step b is one Q8_0 group, d row b; each column's d as a
        // bf16 pair (d, d).
        const uint32_t d2 = stage[C::kRowsOff + b * C::kDWords + c0 / 2];
        q.s0 = __byte_perm(d2, d2, 0x1010);
        q.s1 = __byte_perm(d2, d2, 0x3232);
      } else if constexpr (C::kGroupRows) {
        if (kk + 8 * t >= sg_end) {
          do {
            ++sg;
            sg_end += gs;
          } while (kk + 8 * t >= sg_end);
          q = group_consts<BITS, D, A8>(sc_s, z_s, sg, c0);
        }
      }
      uint32_t a[2][4], al[2][4];
      step_fragments<BITS, D, A8>(stage, lut_s, b, warp, gid, t, q, a, al);
      if constexpr (A8) {
        if (kk + 32 <= fg_end) {
          products_s8(a[0], kb);
          if (kk + 32 == fg_end) fold(group_scales(stage));
        } else {
          // The step crosses groups: once per group, the others' codes 0.
          for (;;) {
            const bool mine = sg == fg;
            const uint32_t am[4] = {mine ? a[0][0] : 0u, mine ? a[0][1] : 0u,
                                    mine ? a[0][2] : 0u, mine ? a[0][3] : 0u};
            products_s8(am, kb);
            if (fg_end > kk + 32) break;
            fold(group_scales(stage));
            if (fg_end - gs >= kk + 32) break;
          }
        }
      } else if constexpr (X32) {
        // The hi and lo runs of the step's 8 k rows; per k16, x_lo w_hi
        // + x_hi w_lo + x_hi w_hi.
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < n_nt) {
            const uint4* xp = reinterpret_cast<const uint4*>(
                x_lane + nt * 8 * xrow + kb * 128);
            const uint4 xh = xp[0], xl = xp[1];
            const uint32_t h0[2] = {xh.x, xh.y}, h1[2] = {xh.z, xh.w};
            const uint32_t l0[2] = {xl.x, xl.y}, l1[2] = {xl.z, xl.w};
            mma_bf16(acc[nt], a[0], l0);
            mma_bf16(acc[nt], al[0], h0);
            mma_bf16(acc[nt], a[0], h0);
            mma_bf16(acc[nt], a[1], l1);
            mma_bf16(acc[nt], al[1], h1);
            mma_bf16(acc[nt], a[1], h1);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < n_nt) {
            const uint4 xv = *reinterpret_cast<const uint4*>(
                x_lane + nt * 8 * xrow + kb * 64);
            const uint32_t b0[2] = {xv.x, xv.y};
            const uint32_t b1[2] = {xv.z, xv.w};
            mma_bf16(acc[nt], a[0], b0);
            mma_bf16(acc[nt], a[1], b1);
          }
      }
    }
  }
  cp_async_wait<0>();
  // a8: a group the split ends inside (never K15's: whole groups).
  if constexpr (A8 && !C::kBytes)
    if (fg_end - gs < k_rows) fold(group_scales(nullptr));

  // Columns c0, c0 + 1 of rows 8 nt + 2t and + 1.
  const int col = n0 + c0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + nt * 8 + 2 * t + h;
      if (nt >= n_nt || r >= m) continue;
      const float v0 = acc[nt][h], v1 = acc[nt][2 + h];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(
            partial + (static_cast<size_t>(blockIdx.z) * m + r) * N + col) =
            make_float2(v0, v1);
      } else if constexpr (X32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                   static_cast<size_t>(r) * N + col) =
            make_float2(v0, v1);
      } else if constexpr (D == SDec::kInt8) {
        // K17: the f32 sums times the columns' f32 scales (`scales`),
        // rounded once, as the plain version.
        const float2 cs = *reinterpret_cast<const float2*>(
            static_cast<const float*>(scales) + col);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           static_cast<size_t>(r) * N +
                                           col) =
            __floats2bfloat162_rn(v0 * cs.x, v1 * cs.y);
      } else {
        const float rs = A8 ? xs[r] : 1.f;
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           static_cast<size_t>(r) * N +
                                           col) =
            __floats2bfloat162_rn(v0 * rs, v1 * rs);
      }
    }
}

template <int BITS, SDec D, bool A8, int NT>
int run(const void* x, const float* xs, const void* qweight,
        const void* qzeros, const void* scales, void* out, float* partial,
        int m, int K, int N, int gs, int splits, int k_split,
        cudaStream_t stream) {
  auto kernel = quant_stream_kernel<BITS, D, A8, NT>;
  const int smem = smem_bytes<BITS, D, A8>(
      k_split, split_groups(K, gs, k_split), NT);
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kernel<<<dim3(N / kBN, (m + 8 * NT - 1) / (8 * NT), splits), kThreads,
           smem, stream>>>(
      x, xs, static_cast<const uint32_t*>(qweight),
      static_cast<const uint32_t*>(qzeros), scales, out,
      splits > 1 ? partial : nullptr, m, K, N, gs, k_split);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(m) * N;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    if constexpr (D == SDec::kLutX32) {
      split_reduce_kernel<float><<<blocks, 256, 0, stream>>>(
          partial, nullptr, nullptr, static_cast<float*>(out), splits, m, N);
    } else {
      // K17: its column scales (`scales`) after the sum.
      split_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
          partial, A8 ? xs : nullptr,
          D == SDec::kInt8 ? static_cast<const float*>(scales) : nullptr,
          static_cast<__nv_bfloat16*>(out), splits, m, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// block_m 8, 16, 32 or 64 rows (NT 1, 2 or 4 n-tiles; 64 as two 32-row
// blocks); `splits` runs of whole units, as the wrapper's stream_plan
// counted them (each non-empty).
template <int BITS, SDec D, bool A8>
int launch(const void* x, const float* xs, const void* qweight,
           const void* qzeros, const void* scales, void* out, float* partial,
           int m, int K, int N, int gs, int splits, int block_m,
           cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (gs <= 0 || gs % 8 != 0 || N % kBN != 0 || m > block_m ||
      splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int unit = split_unit(gs);
  if (K % unit != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int units = K / unit;
  const int per = (units + splits - 1) / splits;
  if ((units + per - 1) / per != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_split = per * unit;
  switch (block_m) {
    case 8:
      return run<BITS, D, A8, 1>(x, xs, qweight, qzeros, scales, out,
                                 partial, m, K, N, gs, splits, k_split,
                                 stream);
    case 16:
      return run<BITS, D, A8, 2>(x, xs, qweight, qzeros, scales, out,
                                 partial, m, K, N, gs, splits, k_split,
                                 stream);
    case 32:
    case 64:   // two 32-row blocks
      return run<BITS, D, A8, 4>(x, xs, qweight, qzeros, scales, out,
                                 partial, m, K, N, gs, splits, k_split,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace streamed

// GPTQ / AWQ: block_m 8-64 is K7 (quant_stream_kernel, `splits` runs of
// whole units); 128 is K6 / K10 (quant_gemm_kernel, runs of groups) for
// a16 and K8 / K11 (w8a8_gemm_kernel with a 4-bit decoder, runs of
// 128-row chunks) for a8.
template <int BITS, bool A8, bool AWQ>
int launch(const void* x, const float* xs, const void* qweight,
           const void* qzeros, const void* scales, void* out,
           float* partial, int m, int K, int N, int gs, int splits,
           int block_m, cudaStream_t stream) {
  if (block_m != 128)
    return streamed::launch<BITS, AWQ ? streamed::SDec::kAwq
                                     : streamed::SDec::kGptq, A8>(
        x, xs, qweight, qzeros, scales, out, partial, m, K, N, gs, splits,
        block_m, stream);
  if constexpr (A8) {
    static_assert(BITS == 4, "W4A8 takes 4-bit codes");
    return gemm::launch_w8a8<AWQ ? gemm::A8Dec::kAwq4
                                 : gemm::A8Dec::kGptq4>(
        x, xs, qweight, qzeros, scales, out, partial, m, K, N, gs, splits,
        stream);
  } else {
    return gemm::launch_gemm<BITS, AWQ ? gemm::Dec::kAwq
                                       : gemm::Dec::kGptq>(
        x, qweight, qzeros, scales, out, partial, m, K, N, gs, splits,
        stream);
  }
}

// K9: one block a row of x [m, K] bf16, blockDim.x threads (a multiple of
// 32, at most 1024), each holding up to V 16-byte runs of the row (the
// wrapper's quant8_plan picks both from m, K and the SM count, so a CUDA
// graph can capture the launch: wide blocks where the rows are few).
// Bytes bound it: x read once, x8 and xs written once; at decode the
// launch itself. The row is read from device memory once: thread i
// issues all of its loads (runs i, i + T, ..., 16 bytes each) before it
// reduces, keeps the row in registers, reduces |x| by warp shuffles and
// one shared step, then quantizes from its registers and stores each
// run's 8 codes in one 8-byte store. xs = max(absmax, 1e-8) / 127 and x8
// = clip(rint(x / xs), -127, 127) with IEEE division and rintf (half to
// even), as the plain version. Where the row is not whole 16-byte runs
// from a 16-byte aligned start (K % 8, a view of x at an odd offset) or
// longer than T V runs, the same kernel reads it element by element,
// twice (the second read mostly from L2).
template <int V>
__global__ void __launch_bounds__(1024)
quant8_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ x8,
              float* __restrict__ xs, int K) {
  __shared__ float warp_max[32];
  const int tid = threadIdx.x, threads = blockDim.x;
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * K;
  int8_t* out = x8 + row * K;
  const int runs = K / 8;
  const bool vec = K % 8 == 0 && runs <= V * threads &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  uint4 v[V];
  float amax = 0.f;
  if (vec) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = tid + j * threads;
      v[j] = u < runs ? reinterpret_cast<const uint4*>(xr)[u]
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        amax = fmaxf(amax, fmaxf(fabsf(__uint_as_float(w[e] << 16)),
                                 fabsf(__uint_as_float(w[e] & 0xffff0000u))));
    }
  } else {
    for (int i = tid; i < K; i += threads)
      amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  amax = (tid & 31) < threads / 32 ? warp_max[tid & 31] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
  auto code = [scale](float f) {
    return __float2int_rn(fminf(fmaxf(rintf(f / scale), -127.0f), 127.0f));
  };
  if (vec) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = tid + j * threads;
      if (u >= runs) break;
      const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      uint32_t p[4];   // codes 2e and 2e + 1 in bytes 0 and 1
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = __byte_perm(code(__uint_as_float(w[e] << 16)),
                           code(__uint_as_float(w[e] & 0xffff0000u)), 0x0040);
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(u) * 8) =
          make_uint2(__byte_perm(p[0], p[1], 0x5410),
                     __byte_perm(p[2], p[3], 0x5410));
    }
  } else {
    for (int i = tid; i < K; i += threads)
      out[i] = static_cast<int8_t>(code(__bfloat162float(xr[i])));
  }
  if (tid == 0) xs[row] = scale;
}

}  // namespace

// Dynamic shared memory per block of quant_gemm_kernel (K6 / K10) at
// `bits` (4 or 8).
extern "C" int quant_gemm_smem_bytes(int bits) {
  return bits == 8 ? gemm::Cfg<8, gemm::Dec::kGptq>::kSmemBytes
                   : gemm::Cfg<4, gemm::Dec::kGptq>::kSmemBytes;
}

// Shared memory per block of the m > 64 kernel of K8 and K11-K17, by
// kernel number: K8 (w8a8_gemm_kernel<kGptq4>), K11 (<kAwq4>), K12
// (quant_gemm_kernel<4, kQ4k>), K13 (<8, kQ8>), K14 (<8, kI8g>), K15
// (w8a8_gemm_kernel<kQs8>), K16 on bf16 x (<4, kLut>: its dynamic ring and
// 16 KB static codebook tile), K16 on f32 x (kernel 16 with f32 set: <4,
// kLutX32>, its ring and 8 KB codebook tile) and K17 (<8, kInt8>); 0 for
// any other number. Every `Dec` of quant_gemm_kernel answers here or in
// quant_gemm_smem_bytes, every `A8Dec` of w8a8_gemm_kernel here.
extern "C" int gguf_gemm_smem_bytes(int kernel, int f32) {
  if (f32) return kernel == 16
                      ? gemm::Cfg<4, gemm::Dec::kLutX32>::kBlockSmemBytes
                      : 0;
  switch (kernel) {
    case 8: return gemm::W8Cfg<gemm::A8Dec::kGptq4>::kSmemBytes;
    case 11: return gemm::W8Cfg<gemm::A8Dec::kAwq4>::kSmemBytes;
    case 12: return gemm::Cfg<4, gemm::Dec::kQ4k>::kBlockSmemBytes;
    case 13: return gemm::Cfg<8, gemm::Dec::kQ8>::kBlockSmemBytes;
    case 14: return gemm::Cfg<8, gemm::Dec::kI8g>::kBlockSmemBytes;
    case 15: return gemm::W8Cfg<gemm::A8Dec::kQs8>::kSmemBytes;
    case 16: return gemm::Cfg<4, gemm::Dec::kLut>::kBlockSmemBytes;
    case 17: return gemm::Cfg<8, gemm::Dec::kInt8>::kBlockSmemBytes;
    default: return 0;
  }
}

// y[m, N] = x[m, K] @ dequant(W), x and scales bf16. block_m 128 is K6
// (quant_gemm_kernel; `splits` groups runs, then split_reduce_kernel);
// 8, 16, 32 and 64 are K7 (quant_stream_kernel; `splits` runs of
// lcm(gs, 32) rows; with splits > 1, `partial` holds splits*m*N f32).
extern "C" int gptq_mm_a16(const void* x, const void* qweight,
                           const void* qzeros, const void* scales, void* out,
                           float* partial, int m, int K, int N, int gs,
                           int bits, int splits, int block_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return launch<4, false, false>(x, nullptr, qweight, qzeros, scales, out,
                                   partial, m, K, N, gs, splits, block_m, st);
  if (bits == 8)
    return launch<8, false, false>(x, nullptr, qweight, qzeros, scales, out,
                                   partial, m, K, N, gs, splits, block_m, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y[m, N] = bf16(xs[m] * sum_g s[g] * (x8[m, g] . (q - z)[g])), x8 int8
// from quant8, 4-bit codes. block_m 128 is K8 (w8a8_gemm_kernel<kGptq4>,
// `splits` runs of 128-row chunks, then split_reduce_kernel); 8, 16, 32
// and 64 the a8 arm of K7.
extern "C" int gptq_mm_a8(const void* x8, const float* xs,
                          const void* qweight, const void* qzeros,
                          const void* scales, void* out, float* partial,
                          int m, int K, int N, int gs, int splits,
                          int block_m, void* stream) {
  return launch<4, true, false>(x8, xs, qweight, qzeros, scales, out,
                                partial, m, K, N, gs, splits, block_m,
                                static_cast<cudaStream_t>(stream));
}

// AWQ layout, y[m, N] = x[m, K] @ dequant(W), x and scales bf16. block_m 128
// is K10 (quant_gemm_kernel, as K6); 8, 16, 32 and 64 are K7's AWQ layout
// (split K as for GPTQ).
extern "C" int awq_mm_a16(const void* x, const void* qweight,
                          const void* qzeros, const void* scales, void* out,
                          float* partial, int m, int K, int N, int gs,
                          int splits, int block_m, void* stream) {
  return launch<4, false, true>(x, nullptr, qweight, qzeros, scales, out,
                                partial, m, K, N, gs, splits, block_m,
                                static_cast<cudaStream_t>(stream));
}

// AWQ layout, y[m, N] = bf16(xs[m] * sum_g s[g] * (x8[m, g] . (q - z)[g])),
// x8 int8 from quant8. block_m 128 is K11 (w8a8_gemm_kernel<kAwq4>, as
// K8); 8, 16, 32 and 64 the a8 arm of K7's AWQ layout.
extern "C" int awq_mm_a8(const void* x8, const float* xs,
                         const void* qweight, const void* qzeros,
                         const void* scales, void* out, float* partial,
                         int m, int K, int N, int gs, int splits,
                         int block_m, void* stream) {
  return launch<4, true, true>(x8, xs, qweight, qzeros, scales, out,
                               partial, m, K, N, gs, splits, block_m,
                               static_cast<cudaStream_t>(stream));
}

// K9: `threads` threads a row (a multiple of 32, at most 1024), each
// holding up to `per` 16-byte runs of it (1, 2, 4 or 8), as the wrapper's
// quant8_plan picks them.
extern "C" int quant8(const void* x, void* x8, float* xs, int m, int K,
                      int threads, int per, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* q = static_cast<int8_t*>(x8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: quant8_kernel<1><<<m, threads, 0, st>>>(xb, q, xs, K); break;
    case 2: quant8_kernel<2><<<m, threads, 0, st>>>(xb, q, xs, K); break;
    case 4: quant8_kernel<4><<<m, threads, 0, st>>>(xb, q, xs, K); break;
    case 8: quant8_kernel<8><<<m, threads, 0, st>>>(xb, q, xs, K); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13: y[m, N] = x[m, K] @ bf16(qs[K, N] * d[K / 32, N]), Q8_0 at rest.
// block_m 128 is quant_gemm_kernel<8, kQ8> (`splits` runs of 64-row
// chunks, then split_reduce_kernel, which the wrapper sends every m over
// Q8_STREAM_M_MAX); 8, 16, 32 and 64 quant_stream_kernel<8, kQ8>
// (`splits` runs of 32 rows, as stream_plan counts them).
extern "C" int gguf_q8_mm(const void* x, const void* qs, const void* d,
                          void* out, float* partial, int m, int K, int N,
                          int splits, int block_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_gemm<8, gemm::Dec::kQ8>(
        x, qs, nullptr, d, out, partial, m, K, N, gemm::kBK, splits, st);
  return streamed::launch<8, streamed::SDec::kQ8, false>(
      x, nullptr, qs, nullptr, d, out, partial, m, K, N, 32, splits,
      block_m, st);
}

// K14: y[m, N] = x[m, K] @ bf16(qs[K, N] * d16[K / 16, N]), grouped int8.
// block_m 128 is quant_gemm_kernel<8, kI8g> (`splits` runs of 64-row
// chunks, then split_reduce_kernel, which the wrapper sends every m over
// I8G_STREAM_M_MAX); 8, 16, 32 and 64 quant_stream_kernel<8, kI8g>
// (`splits` runs of 32 rows, as stream_plan counts them).
extern "C" int gguf_i8g_mm(const void* x, const void* qs, const void* d16,
                           void* out, float* partial, int m, int K, int N,
                           int splits, int block_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_gemm<8, gemm::Dec::kI8g>(
        x, qs, nullptr, d16, out, partial, m, K, N, gemm::kBK, splits, st);
  return streamed::launch<8, streamed::SDec::kI8g, false>(
      x, nullptr, qs, nullptr, d16, out, partial, m, K, N, 16, splits,
      block_m, st);
}

// K15: y[m, N] = bf16(xs[m] * sum_g s128[g] * (x8[m, g] . qs8[g])), x8
// int8 rows from quant8, 128-row groups. block_m 128 is w8a8_gemm_kernel
// (kQs8, `splits` runs of groups, then split_reduce_kernel, which the
// wrapper sends every m over K15_STREAM_M_MAX); 8, 16, 32 and 64 the a8
// arm of quant_stream_kernel<8, kQs8> (`splits` runs of 128-row groups,
// as stream_plan counts them; xs in its epilogue or the split reduce).
extern "C" int gguf_w8a8_mm(const void* x8, const float* xs, const void* qs8,
                            const void* s128, void* out, float* partial,
                            int m, int K, int N, int splits, int block_m,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_w8a8<gemm::A8Dec::kQs8>(
        x8, xs, qs8, nullptr, s128, out, partial, m, K, N, gemm::kW8Tile,
        splits, st);
  return streamed::launch<8, streamed::SDec::kQs8, true>(
      x8, xs, qs8, nullptr, s128, out, partial, m, K, N, 128, splits,
      block_m, st);
}

// K12: y[m, N] = x[m, K] @ bf16(q * dl - ml), GGUF's exact Q4_K form: 4-bit
// codes qweight [K / 8, N], bf16 dl and ml [K / 32, N]. block_m 128 is
// quant_gemm_kernel<4, kQ4k> (`splits` runs of 64-row chunks, then
// split_reduce_kernel); 8, 16, 32 and 64 quant_stream_kernel<4, kQ4k>
// (`splits` runs of 32 rows, as stream_plan counts them).
extern "C" int gguf_q4k_mm(const void* x, const void* qweight, const void* dl,
                           const void* ml, void* out, float* partial, int m,
                           int K, int N, int splits, int block_m,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_gemm<4, gemm::Dec::kQ4k>(
        x, qweight, ml, dl, out, partial, m, K, N, gemm::kBK, splits, st);
  return streamed::launch<4, streamed::SDec::kQ4k, false>(
      x, nullptr, qweight, ml, dl, out, partial, m, K, N, 32, splits,
      block_m, st);
}

// K16, bf16: y[m, N] = x[m, K] @ w, w[k, n] = lut[n, q[k, n]], lut [N, 16]
// bf16 (SqueezeLLM). block_m 128 is quant_gemm_kernel<4, kLut> (`splits`
// runs of 64-row chunks, then split_reduce_kernel); 8, 16, 32 and 64
// quant_stream_kernel<4, kLut> (`splits` runs of 32 rows).
extern "C" int sqllm_mm(const void* x, const void* qweight, const void* lut,
                        void* out, float* partial, int m, int K, int N,
                        int splits, int block_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_gemm<4, gemm::Dec::kLut>(
        x, qweight, nullptr, nullptr, out, partial, m, K, N, gemm::kBK,
        splits, st, lut);
  return streamed::launch<4, streamed::SDec::kLut, false>(
      x, nullptr, qweight, nullptr, lut, out, partial, m, K, N, 32, splits,
      block_m, st);
}

// K16, f32: the same with f32 x, lut and y (QuIP#'s 4-bit at-rest form),
// three bf16 products a term. block_m 128 is split_x32_kernel into xhl
// (2 m K bf16 scratch), then quant_gemm_kernel<4, kLutX32> (`splits` runs
// of 64-row chunks on 128 x 128 tiles, then split_reduce_kernel<float>);
// 8, 16, 32 and 64 quant_stream_kernel<4, kLutX32> (`splits` runs of 32
// rows; xhl unused).
extern "C" int sqllm_mm_f32(const void* x, const void* qweight,
                            const void* lut, void* xhl, void* out,
                            float* partial, int m, int K, int N, int splits,
                            int block_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_gemm_x32(static_cast<const float*>(x), qweight, lut,
                                 xhl, out, partial, m, K, N, splits, st);
  return streamed::launch<4, streamed::SDec::kLutX32, false>(
      x, nullptr, qweight, nullptr, lut, out, partial, m, K, N, 32, splits,
      block_m, st);
}

// K17: y[m, N] = bf16((x[m, K] @ int8 w[K, N]) * scales[N]), scales f32.
// block_m 128 is quant_gemm_kernel<8, kInt8> (`splits` runs of 64-row
// chunks, then split_reduce_kernel with the scales, which the wrapper
// sends every m over INT8_STREAM_M_MAX); 8, 16, 32 and 64
// quant_stream_kernel<8, kInt8> (`splits` runs of 32 rows, as
// stream_plan counts them; the scales in its epilogue or the split
// reduce).
extern "C" int int8_mm(const void* x, const void* w, const float* scales,
                       void* out, float* partial, int m, int K, int N,
                       int splits, int block_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return gemm::launch_gemm<8, gemm::Dec::kInt8>(
        x, w, nullptr, nullptr, out, partial, m, K, N, gemm::kBK, splits,
        st, scales);
  return streamed::launch<8, streamed::SDec::kInt8, false>(
      x, nullptr, w, nullptr, scales, out, partial, m, K, N, 32, splits,
      block_m, st);
}
