// GPTQ, AWQ and GGUF quantized matmuls and per-row int8 activation
// quantization, CUDA C++ for sm_90a.
//
// Replaces the twelve Pallas TPU kernels of
// aphrodite_tpu/ops/pallas/quant_matmul.py (K6-K17). K6-K8, K10 and K11 are
// one templated kernel, quant_mma_kernel; K13-K15 and K17 another,
// int8_mma_kernel; K12 and K16 a third, nib_mma_kernel (see their
// comments). The three share the block tile, the x staging, the mma.sync
// fragments, the A8 group fold, the epilogue and the launcher (Tile,
// stage_x, mma_chunk, fold_group, store_tile, launch_tiles) and differ
// only in how they load the W words and write the W tile:
//   _gguf_q4k_kernel (:1117)   -> nib_mma_kernel<Q4K> (K12, Q4_K exact)
//   _sqllm_kernel (:1630)      -> nib_mma_kernel<LUT> (K16, bf16 x) and
//                                 nib_mma_kernel<LUT, X32> (K16, f32 x)
//   _int8_kernel (:1706)       -> int8_mma_kernel<G 0> (K17, int8 per
//                                 column)
//   _gguf_q8_kernel (:1210)    -> int8_mma_kernel<G 32> (K13, Q8_0)
//   _gguf_i8g_kernel (:1476)   -> int8_mma_kernel<G 16> (K14, grouped int8)
//   _gguf_w8a8_kernel (:1551)  -> int8_mma_kernel<G 128, A8> (K15, W8A8)
//   _kernel (:554)          -> 128-row tiles, GPTQ layout (K6)
//   _stream_kernel (:308)   -> 16-64-row tiles with split K, GPTQ and AWQ
//                              layouts, a16 and a8 arms (K7)
//   _gptq_a8_kernel, _gptq_a8_deferred_kernel (:1274, :1311)
//                           -> <A8>, 128-row tiles, GPTQ layout (K8)
//   _quant8_kernel (:781)   -> quant8_kernel (K9)
//   _awq_kernel (:718)      -> 128-row tiles, AWQ layout (K10)
//   _awq_a8_kernel, _awq_a8_deferred_kernel (:937, :971)
//                           -> <A8>, 128-row tiles, AWQ layout (K11)
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
// - K7 (m <= 64, every decode step): bytes. Each int4 weight is used by at
//   most 64 rows; the least time is the packed weight read once over
//   3.35 TB/s (8.4 us for down_proj at Mistral-7B width).
// - K6 / K8 / K10 / K11 (m > 64: prompt rounds, large decode batches):
//   operations at large m (989 TFLOP/s bf16, 1979 TOP/s int8), bytes below
//   a few hundred rows.
// - K9: bytes (x read once, the int8 copy and the row scales written once).
// - K13-K15: bytes at decode (the int8 weight and its bf16 scale rows read
//   once: 0.066-0.073 ms per layer at Mistral-7B width, about twice K7's
//   int4 bound), operations at prompt rounds (bf16 for K13/K14, int8 for
//   K15).
// - K12, K16 and K17: bytes at decode (4-bit codes with K12's bf16 dl/ml
//   rows per 32 input rows or K16's 16-entry codebook per column; K17's
//   int8 codes and f32 column scales), bf16 operations at prompt rounds;
//   K16 on f32 x does three bf16 products per term, so three times the
//   bf16 operations.
//
// What the design does about it. One templated kernel serves K6, K7, K8,
// K10 and K11, for both layouts: a block owns BM rows x 128 columns of the
// output and walks its quantization groups in order; each group is cut
// into 64-deep k chunks.
// For every chunk the block stages x in shared memory and dequantizes the
// chunk of W there (in the natural row order: the TPU's plane-order unpack
// and x column permutation were sublane tricks and are gone; the packed
// words of the next chunk are already on their way into registers), then
// its eight warps run mma.sync on the tile: bf16 m16n8k16 with f32 sums (A16),
// or s8 m16n8k32 with exact int32 sums per group and the f32 rescale by the
// group's scale when the group ends (A8: codes minus zero lie in [-16, 14]
// for GPTQ and [-15, 15] for AWQ and fit int8 exactly). The layouts differ
// only in how the W chunk is staged: a GPTQ word holds 8 k rows of one
// column, so a thread dequantizes one column's rows; an AWQ word holds 8
// columns of one k row, so a thread holds 4 consecutive rows of one word
// column and writes, for each of its 8 columns, those 4 rows at once
// (unpacked in natural column order: the TPU's plane-major columns and
// output un-permutation were lane tricks and are gone). The TPU kernels
// carried the f32 sum across a sequential grid axis in VMEM scratch; here
// the k loop is inside the block. For skinny m (K7) a block covers 16, 32
// or 64 rows, so the weight is streamed once, and the groups are split
// over several blocks to fill
// the 132 SMs: each split writes f32 partial sums and a second kernel adds
// them in split order (deterministic, no atomics), applies the A8 row
// scale and rounds to bf16. x of up to 64 x 14336 does not fit in shared
// memory, so it is staged chunk by chunk like W. The two TPU W4A8 bodies
// (classic and deferred rescale) differ only in the f32 summation order;
// this one kernel computes both. Simple first: no cp.async / TMA pipeline
// and no wgmma yet.
//
// Each C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError(). Build without --use_fast_math: K9's
// division must be IEEE and its rounding rintf (half to even), so that it
// equals its plain version exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;   // eight warps
constexpr int kBN = 128;        // output columns per block
constexpr int kChunk = 64;      // k values staged per step

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

template <bool A8> struct Elem;
template <> struct Elem<false> {
  using T = __nv_bfloat16;
  static constexpr int kPad = 8;     // 16 bytes: conflict-free fragments
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.f); }
};
template <> struct Elem<true> {
  using T = int8_t;
  static constexpr int kPad = 16;
  static __device__ __forceinline__ T zero() { return 0; }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

// Store WORDS 32-bit words to 8- or 16-byte aligned shared memory.
template <int WORDS>
__device__ __forceinline__ void st_words(void* p, const uint32_t* w) {
  if constexpr (WORDS == 4) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    static_assert(WORDS == 2, "2 or 4 words");
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// AWQ: the shift of column 8j + e in its word, 4 * {0,4,1,5,2,6,3,7}[e].
__device__ __forceinline__ constexpr int awq_shift(int e) {
  return 4 * ((e & 1) ? 4 + (e >> 1) : (e >> 1));
}

// The block tile shared by quant_mma_kernel and int8_mma_kernel: BM rows x
// 128 columns of the output over WARPS_M x (8 / WARPS_M) warps, each warp
// MI x NI mma fragments; x and W are staged 64 k at a time in shared tiles
// [rows][LD] (W transposed, [column][k]: the mma B operand's layout).
template <int BM_, int WARPS_M_, bool A8_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr bool A8 = A8_;
  using T = typename Elem<A8>::T;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = kBN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static constexpr int LD = kChunk + Elem<A8>::kPad;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // x per uint4
  static_assert(MI >= 1 && NI >= 1 && WM % 16 == 0 && WN % 8 == 0, "tile");
};

// This thread's place in the tile: warp row wm and column wn, and its
// fragment row group gid and thread in group tig.
struct Lane {
  int wm, wn, gid, tig;
};

template <class TL>
__device__ __forceinline__ Lane lane_of() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return Lane{warp / TL::WARPS_N, warp % TL::WARPS_N, lane >> 2, lane & 3};
}

// Zero a warp's accumulators: f32 sums, or A8's exact int32 dots.
template <class TL, typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[TL::MI][TL::NI][4]) {
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
}

// Stage x rows [m0, m0 + BM) x k [k0, k0 + kn) into x_tile, zeros past m
// and kn; 16-byte loads when `vec` (aligned rows) and the chunk is full.
template <class TL>
__device__ __forceinline__ void stage_x(typename TL::T (*x_tile)[TL::LD],
                                        const typename TL::T* __restrict__ x,
                                        int m, int K, int m0, int k0, int kn,
                                        bool vec) {
  using T = typename TL::T;
  if (vec && kn == kChunk) {
    constexpr int VPR = kChunk / TL::VEC;
    for (int i = threadIdx.x; i < TL::BM * VPR; i += kThreads) {
      const int r = i / VPR, v = i % VPR;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m)
        val = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m0 + r) * K + k0 + v * TL::VEC);
      *reinterpret_cast<uint4*>(&x_tile[r][v * TL::VEC]) = val;
    }
  } else {
    for (int i = threadIdx.x; i < TL::BM * kChunk; i += kThreads) {
      const int r = i / kChunk, col = i % kChunk;
      T v = Elem<TL::A8>::zero();
      if (m0 + r < m && col < kn)
        v = x[static_cast<size_t>(m0 + r) * K + k0 + col];
      x_tile[r][col] = v;
    }
  }
}

// The warp's products over a staged 64-deep chunk: bf16 m16n8k16 into the
// f32 sums, or (A8) s8 m16n8k32 into the exact int32 dots.
template <class TL, typename Acc>
__device__ __forceinline__ void mma_chunk(
    typename TL::T (*x_tile)[TL::LD], typename TL::T (*w_tile)[TL::LD],
    Acc (&acc)[TL::MI][TL::NI][4], Lane l) {
  constexpr int KS = TL::A8 ? 32 : 16;   // k per mma
  constexpr int EB = KS / 8;             // elements per 32-bit register
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += KS) {
    uint32_t a[TL::MI][4], b[TL::NI][2];
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi) {
      const int r = l.wm * TL::WM + mi * 16 + l.gid;
      a[mi][0] = ld32(&x_tile[r][ks + l.tig * EB]);
      a[mi][1] = ld32(&x_tile[r + 8][ks + l.tig * EB]);
      a[mi][2] = ld32(&x_tile[r][ks + KS / 2 + l.tig * EB]);
      a[mi][3] = ld32(&x_tile[r + 8][ks + KS / 2 + l.tig * EB]);
    }
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni) {
      const int n = l.wn * TL::WN + ni * 8 + l.gid;
      b[ni][0] = ld32(&w_tile[n][ks + l.tig * EB]);
      b[ni][1] = ld32(&w_tile[n][ks + KS / 2 + l.tig * EB]);
    }
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni) {
        if constexpr (TL::A8) {
          mma_s8(acc[mi][ni], a[mi], b[ni]);
        } else {
          mma_bf16(acc[mi][ni], a[mi], b[ni]);
        }
      }
  }
}

// A8, at a group's end: its exact integer dots times its scale row `srow`
// (the group's row of scales [G, N]), added to the f32 sums in group order.
template <class TL>
__device__ __forceinline__ void fold_group(
    float (&acc)[TL::MI][TL::NI][4], const int (&iacc)[TL::MI][TL::NI][4],
    const __nv_bfloat16* __restrict__ srow, int n0, Lane l) {
#pragma unroll
  for (int ni = 0; ni < TL::NI; ++ni) {
    const int col = n0 + l.wn * TL::WN + ni * 8 + l.tig * 2;
    const float s0 = __bfloat162float(srow[col]);
    const float s1 = __bfloat162float(srow[col + 1]);
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = __fadd_rn(
            acc[mi][ni][e],
            __fmul_rn(static_cast<float>(iacc[mi][ni][e]), (e & 1) ? s1 : s0));
  }
}

// Epilogue: accumulator rows gid and gid + 8, columns tig*2 and +1. Without
// a split, to `out` in OutT (A8: times the row scale xs; with column scales
// cs: times cs[col], K17); with one, the f32 sums to
// `partial[split, row, col]` for split_reduce_kernel.
template <class TL, typename OutT = __nv_bfloat16>
__device__ __forceinline__ void store_tile(
    const float (&acc)[TL::MI][TL::NI][4], const float* __restrict__ xs,
    OutT* __restrict__ out, float* __restrict__ partial, int m,
    int N, int m0, int n0, Lane l, const float* __restrict__ cs = nullptr) {
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + l.wm * TL::WM + mi * 16 + l.gid + half * 8;
      if (r >= m) continue;
      const float rs = (TL::A8 && partial == nullptr) ? xs[r] : 1.f;
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni) {
        const int col = n0 + l.wn * TL::WN + ni * 8 + l.tig * 2;
        const float v0 = acc[mi][ni][half * 2];
        const float v1 = acc[mi][ni][half * 2 + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(
              partial + (static_cast<size_t>(blockIdx.z) * m + r) * N + col) =
              make_float2(v0, v1);
        } else if constexpr (std::is_same<OutT, float>::value) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + col) =
              make_float2(v0, v1);
        } else if (cs != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(r) * N + col) =
              __floats2bfloat162_rn(v0 * cs[col], v1 * cs[col + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(r) * N + col) =
              __floats2bfloat162_rn(v0 * rs, v1 * rs);
        }
      }
    }
  }
}

// GPTQ and AWQ (K6-K8, K10, K11): one block over the groups
// [g_begin, g_end) of split blockIdx.z.
//
// Each group is cut into chunks of 64 k. Every thread holds its packed
// words of the next chunk in registers, loaded before the current chunk's
// products, so the weight stream's latency overlaps the tensor-core work
// and the barriers. GPTQ: the two threads that own a column share its
// words. AWQ: a warp covers 4 neighbouring word columns (16 bytes of a
// row) x 8 four-row groups, so its loads take whole halves of 32-byte
// sectors and its shared-memory stores, 8 bytes of one column each, span
// 16 banks per word column.
template <class TL, int BITS, bool AWQ>
__global__ void __launch_bounds__(kThreads)
quant_mma_kernel(const typename TL::T* __restrict__ x,
                 const float* __restrict__ xs,
                 const uint32_t* __restrict__ qweight,
                 const uint32_t* __restrict__ qzeros,
                 const __nv_bfloat16* __restrict__ scales,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ partial, int m, int K, int N, int gs,
                 int groups_per_split) {
  using T = typename TL::T;
  constexpr bool A8 = TL::A8;
  constexpr int PACK = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  // Words per thread per chunk: GPTQ 2 threads per column, kChunk / PACK
  // words each; AWQ 64 rows x 16 words over 256 threads.
  constexpr int WPT = AWQ ? kChunk * (kBN / 8) / kThreads : kChunk / PACK / 2;
  static_assert(!AWQ || (BITS == 4 && WPT == 4), "AWQ packs 8 4-bit codes");

  __shared__ __align__(16) T x_tile[TL::BM][TL::LD];
  __shared__ __align__(16) T w_tile[kBN][TL::LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Lane l = lane_of<TL>();
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * TL::BM;
  const int G = K / gs;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);
  const int chunks = (gs + kChunk - 1) / kChunk;    // per group
  // 16-byte x loads when every chunk start and row start is aligned.
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     K % TL::VEC == 0 && gs % TL::VEC == 0;

  // GPTQ: the column this thread dequantizes and its half of the chunk's
  // words (fixed: 256 threads, 128 columns).
  const int my_n = tid % kBN;
  const int my_col = n0 + my_n;
  const int my_half = tid / kBN;
  // AWQ: this thread's word column (8 output columns from aw_col * 8) and
  // its rows aw_rg * 4 .. + 3 of every chunk.
  const int aw_col = ((warp & 3) << 2) | (lane & 3);
  const int aw_rg = ((warp >> 2) << 3) | (lane >> 2);
  const size_t awq_ld = static_cast<size_t>(N / 8);

  float acc[TL::MI][TL::NI][4];
  zero_acc<TL>(acc);

  // GPTQ: words wi = my_half + 2 * i of chunk c of group g; AWQ: rows
  // aw_rg * 4 + i of word column aw_col. Zero past the group.
  uint32_t words[WPT];
  auto load_words = [&](int g, int c) {
    const int k0 = g * gs + c * kChunk;
    const int kn = min(kChunk, (g + 1) * gs - k0);
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      if constexpr (AWQ) {
        const int r = aw_rg * WPT + i;
        words[i] = r < kn
            ? qweight[static_cast<size_t>(k0 + r) * awq_ld + n0 / 8 + aw_col]
            : 0u;
      } else {
        const int kk = (my_half + 2 * i) * PACK;
        words[i] = kk < kn
            ? qweight[static_cast<size_t>((k0 + kk) / PACK) * N + my_col] : 0u;
      }
    }
  };
  if (g_begin < g_end) load_words(g_begin, 0);

  for (int g = g_begin; g < g_end; ++g) {
    // The group's zero and scale: GPTQ of this thread's column, AWQ of the
    // 8 columns of its word column.
    int z = 0;
    float s = 0.f;
    int zs[8];
    float ss[8];
    if constexpr (AWQ) {
      const uint32_t zw = qzeros[static_cast<size_t>(g) * awq_ld + n0 / 8 +
                                 aw_col];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        zs[e] = static_cast<int>((zw >> awq_shift(e)) & 0xfu);
        if constexpr (!A8)
          ss[e] = __bfloat162float(
              scales[static_cast<size_t>(g) * N + n0 + aw_col * 8 + e]);
      }
    } else {
      const uint32_t zw = qzeros[static_cast<size_t>(g) * (N / PACK) +
                                 my_col / PACK];
      z = static_cast<int>((zw >> (BITS * (my_col % PACK))) & MASK) + 1;
      s = __bfloat162float(scales[static_cast<size_t>(g) * N + my_col]);
    }
    int iacc[TL::MI][TL::NI][4];
    if constexpr (A8) zero_acc<TL>(iacc);
    for (int c = 0; c < chunks; ++c) {
      const int k0 = g * gs + c * kChunk;
      const int kn = min(kChunk, (g + 1) * gs - k0);   // rows in the chunk
      stage_x<TL>(x_tile, x, m, K, m0, k0, kn, x_vec);
      // Dequantize this thread's words into the W tile; past kn the
      // stored values are zero.
      if constexpr (AWQ) {
        // 4 rows of each of the word's 8 columns, in natural column order.
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = aw_col * 8 + e;
          const int sh = awq_shift(e);
          if constexpr (A8) {
            uint32_t packed = 0u;
#pragma unroll
            for (int i = 0; i < WPT; ++i) {
              const int q = static_cast<int>((words[i] >> sh) & 0xfu);
              const uint32_t b = aw_rg * WPT + i < kn
                  ? static_cast<uint32_t>(q - zs[e]) & 0xffu : 0u;
              packed |= b << (8 * i);
            }
            *reinterpret_cast<uint32_t*>(&w_tile[n][aw_rg * WPT]) = packed;
          } else {
            uint32_t packed[WPT / 2];
#pragma unroll
            for (int i = 0; i < WPT; i += 2) {
              const int q0 = static_cast<int>((words[i] >> sh) & 0xfu);
              const int q1 = static_cast<int>((words[i + 1] >> sh) & 0xfu);
              const __nv_bfloat162 w2 = __floats2bfloat162_rn(
                  aw_rg * WPT + i < kn
                      ? static_cast<float>(q0 - zs[e]) * ss[e] : 0.f,
                  aw_rg * WPT + i + 1 < kn
                      ? static_cast<float>(q1 - zs[e]) * ss[e] : 0.f);
              packed[i / 2] = *reinterpret_cast<const uint32_t*>(&w2);
            }
            st_words<WPT / 2>(&w_tile[n][aw_rg * WPT], packed);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < WPT; ++i) {
          const int kk = (my_half + 2 * i) * PACK;
          const uint32_t word = words[i];
          const bool valid = kk < kn;
          if constexpr (A8) {
            uint32_t packed[2] = {0u, 0u};
#pragma unroll
            for (int j = 0; j < PACK; ++j) {
              const int q = static_cast<int>((word >> (BITS * j)) & MASK);
              const uint32_t b = valid ? static_cast<uint32_t>(q - z) & 0xffu : 0u;
              packed[j / 4] |= b << (8 * (j % 4));
            }
            st_words<2>(&w_tile[my_n][kk], packed);
          } else {
            uint32_t packed[PACK / 2];
#pragma unroll
            for (int j = 0; j < PACK; j += 2) {
              const int q0 = static_cast<int>((word >> (BITS * j)) & MASK);
              const int q1 = static_cast<int>((word >> (BITS * (j + 1))) & MASK);
              const __nv_bfloat162 w2 = __floats2bfloat162_rn(
                  valid ? static_cast<float>(q0 - z) * s : 0.f,
                  valid ? static_cast<float>(q1 - z) * s : 0.f);
              packed[j / 2] = *reinterpret_cast<const uint32_t*>(&w2);
            }
            st_words<PACK / 2>(&w_tile[my_n][kk], packed);
          }
        }
      }
      // Next chunk's words (next group's first at the group's end).
      if (c + 1 < chunks) {
        load_words(g, c + 1);
      } else if (g + 1 < g_end) {
        load_words(g + 1, 0);
      }
      __syncthreads();
      if constexpr (A8) {
        mma_chunk<TL>(x_tile, w_tile, iacc, l);
      } else {
        mma_chunk<TL>(x_tile, w_tile, acc, l);
      }
      __syncthreads();
    }
    if constexpr (A8) fold_group<TL>(acc, iacc, scales + static_cast<size_t>(g) * N, n0, l);
  }
  store_tile<TL>(acc, xs, out, partial, m, N, m0, n0, l);
}

// K13 / K14 / K15: int8 weights qs [K, N] with one scale row per G input
// rows (scales [K / G, N] bf16), no zero point and no unpacking.
//   A8 false (K13, G 32; K14, G 16): x bf16; the chunk of W is
//     dequantized in the tile, bf16(float(q) * float(d[k / G][n])), and
//     the products are bf16 m16n8k16 with f32 sums.
//   A8 true (K15, G 128): x int8 rows from quant8; per 128-row group the
//     exact int32 dot (s8 m16n8k32), times the group's scale row, is added
//     to the f32 sum in group order; times xs[row] at the end.
//   G 0 (K17): x bf16; the codes go to the tile as they are (exact in
//     bf16), and the f32 sums are times the column's f32 scale cs[n] in
//     the epilogue (in split_reduce_kernel after a split).
// A block walks the chunks [c_begin, c_end) of 64 k rows (split
// blockIdx.z; for A8 a split starts on a group). Only the W tile differs
// from quant_mma_kernel: each thread stages 4 neighbouring columns x 8 k
// rows of a chunk, 8 32-bit words, one per k row, so a warp reads 128
// contiguous bytes of each row; it writes them to the transposed tile, 8 k
// values of a column in one 16-byte (bf16) or 8-byte (int8) store. The
// words of the next chunk are loaded before the current chunk's products.
// Eight rows of a chunk never straddle a scale group (G >= 16), so a
// thread needs one scale per column.
template <class TL, int G>
__device__ __forceinline__ void int8_mma_tile(
    const typename TL::T* __restrict__ x, const float* __restrict__ xs,
    const uint32_t* __restrict__ qs, const __nv_bfloat16* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int m,
    int K, int N, int chunks_per_split, const float* __restrict__ cs) {
  using T = typename TL::T;
  constexpr bool A8 = TL::A8;
  constexpr int CPG = A8 ? G / kChunk : 1;   // chunks per A8 scale group
  static_assert(G == 0 ? !A8
                       : (A8 ? G % kChunk == 0
                             : (kChunk % G == 0 && G % 8 == 0)),
                "scale groups");

  __shared__ __align__(16) T x_tile[TL::BM][TL::LD];
  __shared__ __align__(16) T w_tile[kBN][TL::LD];

  const int tid = threadIdx.x;
  const Lane l = lane_of<TL>();
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * TL::BM;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(K / kChunk, c_begin + chunks_per_split);
  // Staging: columns n0 + 4 * cq .. + 3, rows r0 .. r0 + 7 of a chunk.
  const int cq = tid & 31;
  const int r0 = (tid >> 5) * 8;
  const size_t ldw = static_cast<size_t>(N / 4);
  const uint32_t* qcol = qs + n0 / 4 + cq;
  // 16-byte x loads when the rows start aligned (K is a multiple of 64).
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;

  float acc[TL::MI][TL::NI][4];
  zero_acc<TL>(acc);
  int iacc[TL::MI][TL::NI][4];

  uint32_t words[8];
  auto load_words = [&](int c) {
    const size_t k = static_cast<size_t>(c) * kChunk + r0;
#pragma unroll
    for (int i = 0; i < 8; ++i) words[i] = qcol[(k + i) * ldw];
  };
  if (c_begin < c_end) load_words(c_begin);

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * kChunk;
    if constexpr (A8) {
      if ((c - c_begin) % CPG == 0) zero_acc<TL>(iacc);
    }
    stage_x<TL>(x_tile, x, m, K, m0, k0, kChunk, x_vec);
    // This thread's 4 columns x 8 rows into the transposed W tile.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = cq * 4 + j;
      if constexpr (A8) {
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          packed[i / 4] |= ((words[i] >> (8 * j)) & 0xffu) << (8 * (i % 4));
        st_words<2>(&w_tile[n][r0], packed);
      } else {
        float d = 1.f;
        if constexpr (G > 0)
          d = __bfloat162float(
              scales[static_cast<size_t>((k0 + r0) / G) * N + n0 + n]);
        uint32_t packed[4];
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const float q0 = static_cast<float>(
              static_cast<int8_t>((words[i] >> (8 * j)) & 0xffu));
          const float q1 = static_cast<float>(
              static_cast<int8_t>((words[i + 1] >> (8 * j)) & 0xffu));
          const __nv_bfloat162 w2 =
              __floats2bfloat162_rn(__fmul_rn(q0, d), __fmul_rn(q1, d));
          packed[i / 2] = *reinterpret_cast<const uint32_t*>(&w2);
        }
        st_words<4>(&w_tile[n][r0], packed);
      }
    }
    if (c + 1 < c_end) load_words(c + 1);
    __syncthreads();
    if constexpr (A8) {
      mma_chunk<TL>(x_tile, w_tile, iacc, l);
    } else {
      mma_chunk<TL>(x_tile, w_tile, acc, l);
    }
    __syncthreads();
    if constexpr (A8) {
      if ((c - c_begin) % CPG == CPG - 1)
        fold_group<TL>(acc, iacc, scales + static_cast<size_t>(c / CPG) * N,
                       n0, l);
    }
  }
  store_tile<TL>(acc, xs, out, partial, m, N, m0, n0, l,
                 G == 0 ? cs : nullptr);
}

template <class TL, int G>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const typename TL::T* __restrict__ x,
                const float* __restrict__ xs,
                const uint32_t* __restrict__ qs,
                const __nv_bfloat16* __restrict__ scales,
                __nv_bfloat16* __restrict__ out,
                float* __restrict__ partial, int m, int K, int N,
                int chunks_per_split, const float* __restrict__ cs) {
  int8_mma_tile<TL, G>(x, xs, qs, scales, out, partial, m, K, N,
                       chunks_per_split, cs);
}

// The bf16 128-row tile (K13 and K14 above 64 rows) with two blocks per SM,
// at most 128 registers: left free it takes 138 and runs one block per SM,
// about 1.6x slower at m 4096. Naming a minimum for the other tiles raises
// their registers and slows decode, so they keep int8_mma_kernel's bound.
template <class TL, int G>
__global__ void __launch_bounds__(kThreads, 2)
int8_mma_kernel_2blk(const typename TL::T* __restrict__ x,
                     const float* __restrict__ xs,
                     const uint32_t* __restrict__ qs,
                     const __nv_bfloat16* __restrict__ scales,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ partial, int m, int K, int N,
                     int chunks_per_split, const float* __restrict__ cs) {
  int8_mma_tile<TL, G>(x, xs, qs, scales, out, partial, m, K, N,
                       chunks_per_split, cs);
}

// K16 on f32 x: stage x rows [m0, m0 + BM) x k [k0, k0 + 64) as two bf16
// tiles, hi = bf16(x) and lo = bf16(x - hi), zeros past m; 16-byte f32
// loads when `vec` (aligned rows).
template <class TL>
__device__ __forceinline__ void stage_x_split(
    __nv_bfloat16 (*hi)[TL::LD], __nv_bfloat16 (*lo)[TL::LD],
    const float* __restrict__ x, int m, int K, int m0, int k0, bool vec) {
  auto split = [](float a, float b, uint32_t& h, uint32_t& w) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h2);
    const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - f.x, b - f.y);
    h = *reinterpret_cast<const uint32_t*>(&h2);
    w = *reinterpret_cast<const uint32_t*>(&l2);
  };
  constexpr int VPR = kChunk / 4;   // float4 per row
  for (int i = threadIdx.x; i < TL::BM * VPR; i += kThreads) {
    const int r = i / VPR, v = i % VPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < m) {
      const float* src = x + static_cast<size_t>(m0 + r) * K + k0 + v * 4;
      val = vec ? *reinterpret_cast<const float4*>(src)
                : make_float4(src[0], src[1], src[2], src[3]);
    }
    uint32_t h[2], w[2];
    split(val.x, val.y, h[0], w[0]);
    split(val.z, val.w, h[1], w[1]);
    st_words<2>(&hi[r][v * 4], h);
    st_words<2>(&lo[r][v * 4], w);
  }
}

// K12 and K16: 4-bit codes packed 8 per int32 along K, qweight [K / 8, N]
// (row k in word k / 8 at shift 4 * (k % 8): the natural order; the TPU's
// plane-order unpack and x column permutation were sublane tricks and are
// gone). The W tile is dequantized in shared memory per 64-deep chunk:
//   Q4K (K12): w = bf16(q * dl - ml) in f32 (no fused multiply-add, as the
//     Pallas body and the plain version round), dl and ml [K / 32, N] bf16
//     rows per 32 input rows; a thread's 8-row word never straddles a
//     group, so it reads one (dl, ml) pair per word.
//   LUT (K16): w = lut[n, q], the block's [16, 128] slice of the codebook
//     staged once in shared memory as f32 [16][128], where a warp's 32
//     neighbouring columns fall in 32 distinct banks whatever the codes.
//     bf16 x (SqueezeLLM): the entries are bf16 and go to the tile exactly.
//     f32 x (X32, QuIP#): x and w are each split into bf16 hi + lo tiles,
//     and the f32 sums take x_lo w_hi + x_hi w_lo + x_hi w_hi (bf16x3,
//     about 2^-16 relative per product; single-pass TF32 would keep 10
//     mantissa bits); the output is f32.
// A thread owns one column of the tile and half the chunk's 8 words (as
// quant_mma_kernel's GPTQ layout), so a warp's word loads cover 128
// contiguous bytes. The words of the next chunk are loaded before the
// current chunk's products. Shared memory is dynamic: the f32 variant's
// four tiles and codebook take 82 KB at 128 rows.
enum class Nib { kQ4K, kLut };

template <class TL, Nib MODE, bool X32>
constexpr int nib_smem_bytes() {
  return (TL::BM + kBN) * TL::LD * static_cast<int>(sizeof(__nv_bfloat16)) *
             (X32 ? 2 : 1) +
         (MODE == Nib::kLut ? 16 * kBN * static_cast<int>(sizeof(float)) : 0);
}

template <class TL, Nib MODE, bool X32>
__global__ void __launch_bounds__(kThreads)
nib_mma_kernel(const void* __restrict__ xv,
               const uint32_t* __restrict__ qweight,
               const void* __restrict__ s0, const void* __restrict__ s1,
               void* __restrict__ out, float* __restrict__ partial, int m,
               int K, int N, int chunks_per_split) {
  static_assert(!TL::A8 && (MODE == Nib::kLut || !X32), "nib variants");
  using OutT = typename std::conditional<X32, float, __nv_bfloat16>::type;
  constexpr int LD = TL::LD;
  constexpr int WPT = kChunk / 8 / 2;   // words per thread per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  auto x_hi = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem);
  auto w_hi = x_hi + TL::BM;
  auto x_lo = w_hi + kBN;               // X32 only
  auto w_lo = x_lo + TL::BM;            // X32 only
  auto lut_s = reinterpret_cast<float (*)[kBN]>(X32 ? w_lo + kBN : x_lo);

  const int tid = threadIdx.x;
  const Lane l = lane_of<TL>();
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * TL::BM;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(K / kChunk, c_begin + chunks_per_split);
  const int my_n = tid % kBN;
  const int my_col = n0 + my_n;
  const int my_half = tid / kBN;
  const bool x_vec = reinterpret_cast<uintptr_t>(xv) % 16 == 0;

  if constexpr (MODE == Nib::kLut) {
    for (int i = tid; i < 16 * kBN; i += kThreads) {
      const int v = i / kBN, n = i % kBN;
      const size_t idx = static_cast<size_t>(n0 + n) * 16 + v;
      if constexpr (X32) {
        lut_s[v][n] = static_cast<const float*>(s0)[idx];
      } else {
        lut_s[v][n] = __bfloat162float(
            static_cast<const __nv_bfloat16*>(s0)[idx]);
      }
    }
    __syncthreads();
  }

  float acc[TL::MI][TL::NI][4];
  zero_acc<TL>(acc);

  uint32_t words[WPT];
  auto load_words = [&](int c) {
    const size_t r = static_cast<size_t>(c) * (kChunk / 8) + my_half;
#pragma unroll
    for (int i = 0; i < WPT; ++i)
      words[i] = qweight[(r + 2 * i) * N + my_col];
  };
  if (c_begin < c_end) load_words(c_begin);

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * kChunk;
    if constexpr (X32) {
      stage_x_split<TL>(x_hi, x_lo, static_cast<const float*>(xv), m, K, m0,
                        k0, x_vec);
    } else {
      stage_x<TL>(x_hi, static_cast<const __nv_bfloat16*>(xv), m, K, m0,
                  k0, kChunk, x_vec);
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int kk = (my_half + 2 * i) * 8;
      const uint32_t word = words[i];
      float d = 0.f, mn = 0.f;
      if constexpr (MODE == Nib::kQ4K) {
        const size_t g = static_cast<size_t>((k0 + kk) / 32) * N + my_col;
        d = __bfloat162float(static_cast<const __nv_bfloat16*>(s0)[g]);
        mn = __bfloat162float(static_cast<const __nv_bfloat16*>(s1)[g]);
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int q0 = static_cast<int>((word >> (4 * j)) & 0xfu);
        const int q1 = static_cast<int>((word >> (4 * (j + 1))) & 0xfu);
        float w0, w1;
        if constexpr (MODE == Nib::kQ4K) {
          w0 = __fsub_rn(__fmul_rn(static_cast<float>(q0), d), mn);
          w1 = __fsub_rn(__fmul_rn(static_cast<float>(q1), d), mn);
        } else {
          w0 = lut_s[q0][my_n];
          w1 = lut_s[q1][my_n];
        }
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(w0, w1);
        hi[j / 2] = *reinterpret_cast<const uint32_t*>(&h2);
        if constexpr (X32) {
          const float2 f = __bfloat1622float2(h2);
          const __nv_bfloat162 l2 = __floats2bfloat162_rn(w0 - f.x, w1 - f.y);
          lo[j / 2] = *reinterpret_cast<const uint32_t*>(&l2);
        }
      }
      st_words<4>(&w_hi[my_n][kk], hi);
      if constexpr (X32) st_words<4>(&w_lo[my_n][kk], lo);
    }
    if (c + 1 < c_end) load_words(c + 1);
    __syncthreads();
    if constexpr (X32) {
      mma_chunk<TL>(x_lo, w_hi, acc, l);
      mma_chunk<TL>(x_hi, w_lo, acc, l);
    }
    mma_chunk<TL>(x_hi, w_hi, acc, l);
    __syncthreads();
  }
  store_tile<TL, OutT>(acc, nullptr, static_cast<OutT*>(out), partial, m, N,
                       m0, n0, l);
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

// The launcher the kernels share: `tile(TL{}, grid, partial)` launches the
// kernel for block_m 16, 32 or 64 (one warp row: K7's skinny tiles, split
// K) or 128 (two warp rows), over the output's 128-column blocks, its row
// blocks and `splits`; `partial` is null without a split. With a split,
// split_reduce_kernel then adds the f32 partials (times xs for A8, times
// the column scales cs for K17) into `out` of OutT.
template <bool A8, typename OutT = __nv_bfloat16, typename LaunchTile>
int launch_tiles(LaunchTile&& tile, int block_m, const float* xs, void* out,
                 float* partial, int m, int N, int splits,
                 cudaStream_t stream, const float* cs = nullptr) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  float* part = splits > 1 ? partial : nullptr;
  auto grid = [&](int bm) { return dim3(N / kBN, (m + bm - 1) / bm, splits); };
  switch (block_m) {
    case 16: tile(Tile<16, 1, A8>{}, grid(16), part); break;
    case 32: tile(Tile<32, 1, A8>{}, grid(32), part); break;
    case 64: tile(Tile<64, 1, A8>{}, grid(64), part); break;
    case 128: tile(Tile<128, 2, A8>{}, grid(128), part); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const size_t total = static_cast<size_t>(m) * N;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    split_reduce_kernel<OutT><<<blocks, threads, 0, stream>>>(
        partial, A8 ? xs : nullptr, cs, static_cast<OutT*>(out), splits, m,
        N);
  }
  return static_cast<int>(cudaGetLastError());
}

// GPTQ / AWQ: a split covers ceil(G / splits) groups.
template <int BITS, bool A8, bool AWQ>
int launch(const void* x, const float* xs, const void* qweight,
           const void* qzeros, const void* scales, void* out,
           float* partial, int m, int K, int N, int gs, int splits,
           int block_m, cudaStream_t stream) {
  const int G = K / gs;
  const int gps = (G + splits - 1) / splits;
  return launch_tiles<A8>(
      [&](auto tl, dim3 grid, float* part) {
        using TL = decltype(tl);
        quant_mma_kernel<TL, BITS, AWQ><<<grid, kThreads, 0, stream>>>(
            static_cast<const typename TL::T*>(x), xs,
            static_cast<const uint32_t*>(qweight),
            static_cast<const uint32_t*>(qzeros),
            static_cast<const __nv_bfloat16*>(scales),
            static_cast<__nv_bfloat16*>(out), part, m, K, N, gs, gps);
      },
      block_m, xs, out, partial, m, N, splits, stream);
}

// GGUF and K17: the split unit is 64 rows (A16) or one scale group (A8),
// as the wrapper's `_tiling` counted them; cs, K17's column scales (G 0).
template <int G, bool A8>
int launch_int8(const void* x, const float* xs, const void* qs,
                const void* scales, void* out, float* partial, int m, int K,
                int N, int splits, int block_m, cudaStream_t stream,
                const float* cs = nullptr) {
  if (m > 0 && (K % (A8 ? G : kChunk) != 0 || N % kBN != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kUnitChunks = A8 ? G / kChunk : 1;
  const int units = K / (kChunk * kUnitChunks);
  const int per = (units + splits - 1) / splits;
  return launch_tiles<A8>(
      [&](auto tl, dim3 grid, float* part) {
        using TL = decltype(tl);
        auto go = [&](auto* kernel) {
          kernel<<<grid, kThreads, 0, stream>>>(
              static_cast<const typename TL::T*>(x), xs,
              static_cast<const uint32_t*>(qs),
              static_cast<const __nv_bfloat16*>(scales),
              static_cast<__nv_bfloat16*>(out), part, m, K, N,
              per * kUnitChunks, cs);
        };
        if constexpr (!A8 && TL::BM == 128) {
          go(int8_mma_kernel_2blk<TL, G>);
        } else {
          go(int8_mma_kernel<TL, G>);
        }
      },
      block_m, xs, out, partial, m, N, splits, stream, cs);
}

// K12 and K16: the split unit is 64 rows. The dynamic shared memory above
// 48 KB (the f32 variant) is allowed once per kernel instance.
template <Nib MODE, bool X32>
int launch_nib(const void* x, const void* qweight, const void* s0,
               const void* s1, void* out, float* partial, int m, int K,
               int N, int splits, int block_m, cudaStream_t stream) {
  if (m > 0 && (K % kChunk != 0 || N % kBN != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  using OutT = typename std::conditional<X32, float, __nv_bfloat16>::type;
  const int units = K / kChunk;
  const int per = (units + splits - 1) / splits;
  return launch_tiles<false, OutT>(
      [&](auto tl, dim3 grid, float* part) {
        using TL = decltype(tl);
        auto kernel = nib_mma_kernel<TL, MODE, X32>;
        constexpr int smem = nib_smem_bytes<TL, MODE, X32>();
        if constexpr (smem > 48 * 1024) {
          static bool allowed = false;
          if (!allowed) {
            cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
            allowed = true;
          }
        }
        kernel<<<grid, kThreads, smem, stream>>>(
            x, static_cast<const uint32_t*>(qweight), s0, s1, out, part, m,
            K, N, per);
      },
      block_m, nullptr, out, partial, m, N, splits, stream);
}

// K9: one block per row. Pass 1 reduces |x| to the row's absmax, pass 2
// writes clip(rint(x / xs), -127, 127) with xs = max(absmax, 1e-8) / 127.
constexpr int kQuantThreads = 256;

__global__ void __launch_bounds__(kQuantThreads)
quant8_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ x8,
              float* __restrict__ xs, int K) {
  __shared__ float warp_max[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
  int8_t* out = x8 + row * K;
  for (int i = threadIdx.x; i < K; i += kQuantThreads) {
    float q = rintf(__bfloat162float(xr[i]) / scale);
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    out[i] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) xs[row] = scale;
}

}  // namespace

// y[m, N] = x[m, K] @ dequant(W), x and scales bf16. block_m 128 is K6;
// 16, 32 and 64 are K7 (with splits > 1, `partial` holds splits*m*N f32).
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
// from quant8, 4-bit codes. block_m 128 is K8; 16, 32 and 64 the a8 arm
// of K7.
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
// is K10; 16, 32 and 64 are K7's AWQ layout (split K as for GPTQ).
extern "C" int awq_mm_a16(const void* x, const void* qweight,
                          const void* qzeros, const void* scales, void* out,
                          float* partial, int m, int K, int N, int gs,
                          int splits, int block_m, void* stream) {
  return launch<4, false, true>(x, nullptr, qweight, qzeros, scales, out,
                                partial, m, K, N, gs, splits, block_m,
                                static_cast<cudaStream_t>(stream));
}

// AWQ layout, y[m, N] = bf16(xs[m] * sum_g s[g] * (x8[m, g] . (q - z)[g])),
// x8 int8 from quant8. block_m 128 is K11; 16, 32 and 64 the a8 arm of K7's
// AWQ layout.
extern "C" int awq_mm_a8(const void* x8, const float* xs,
                         const void* qweight, const void* qzeros,
                         const void* scales, void* out, float* partial,
                         int m, int K, int N, int gs, int splits,
                         int block_m, void* stream) {
  return launch<4, true, true>(x8, xs, qweight, qzeros, scales, out,
                               partial, m, K, N, gs, splits, block_m,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int quant8(const void* x, void* x8, float* xs, int m, int K,
                      void* stream) {
  if (m > 0) {
    quant8_kernel<<<m, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8), xs, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13: y[m, N] = x[m, K] @ bf16(qs[K, N] * d[K / 32, N]), Q8_0 at rest.
// block_m 16, 32 or 64 with splits >= 1 (m <= 64), else 128.
extern "C" int gguf_q8_mm(const void* x, const void* qs, const void* d,
                          void* out, float* partial, int m, int K, int N,
                          int splits, int block_m, void* stream) {
  return launch_int8<32, false>(x, nullptr, qs, d, out, partial, m, K, N,
                                splits, block_m,
                                static_cast<cudaStream_t>(stream));
}

// K14: y[m, N] = x[m, K] @ bf16(qs[K, N] * d16[K / 16, N]), grouped int8.
extern "C" int gguf_i8g_mm(const void* x, const void* qs, const void* d16,
                           void* out, float* partial, int m, int K, int N,
                           int splits, int block_m, void* stream) {
  return launch_int8<16, false>(x, nullptr, qs, d16, out, partial, m, K, N,
                                splits, block_m,
                                static_cast<cudaStream_t>(stream));
}

// K15: y[m, N] = bf16(xs[m] * sum_g s128[g] * (x8[m, g] . qs8[g])), x8
// int8 rows from quant8, 128-row groups.
extern "C" int gguf_w8a8_mm(const void* x8, const float* xs, const void* qs8,
                            const void* s128, void* out, float* partial,
                            int m, int K, int N, int splits, int block_m,
                            void* stream) {
  return launch_int8<128, true>(x8, xs, qs8, s128, out, partial, m, K, N,
                                splits, block_m,
                                static_cast<cudaStream_t>(stream));
}

// K12: y[m, N] = x[m, K] @ bf16(q * dl - ml), GGUF's exact Q4_K form: 4-bit
// codes qweight [K / 8, N], bf16 dl and ml [K / 32, N].
extern "C" int gguf_q4k_mm(const void* x, const void* qweight, const void* dl,
                           const void* ml, void* out, float* partial, int m,
                           int K, int N, int splits, int block_m,
                           void* stream) {
  return launch_nib<Nib::kQ4K, false>(x, qweight, dl, ml, out, partial, m, K,
                                      N, splits, block_m,
                                      static_cast<cudaStream_t>(stream));
}

// K16, bf16: y[m, N] = x[m, K] @ w, w[k, n] = lut[n, q[k, n]], lut [N, 16]
// bf16 (SqueezeLLM).
extern "C" int sqllm_mm(const void* x, const void* qweight, const void* lut,
                        void* out, float* partial, int m, int K, int N,
                        int splits, int block_m, void* stream) {
  return launch_nib<Nib::kLut, false>(x, qweight, lut, nullptr, out, partial,
                                      m, K, N, splits, block_m,
                                      static_cast<cudaStream_t>(stream));
}

// K16, f32: the same with f32 x, lut and y (QuIP#'s 4-bit at-rest form).
extern "C" int sqllm_mm_f32(const void* x, const void* qweight,
                            const void* lut, void* out, float* partial,
                            int m, int K, int N, int splits, int block_m,
                            void* stream) {
  return launch_nib<Nib::kLut, true>(x, qweight, lut, nullptr, out, partial,
                                     m, K, N, splits, block_m,
                                     static_cast<cudaStream_t>(stream));
}

// K17: y[m, N] = bf16((x[m, K] @ int8 w[K, N]) * scales[N]), scales f32.
extern "C" int int8_mm(const void* x, const void* w, const float* scales,
                       void* out, float* partial, int m, int K, int N,
                       int splits, int block_m, void* stream) {
  return launch_int8<0, false>(x, nullptr, w, nullptr, out, partial, m, K, N,
                               splits, block_m,
                               static_cast<cudaStream_t>(stream), scales);
}
