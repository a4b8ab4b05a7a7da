#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`aphrodite_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card: requires `torch.cuda.is_available()`; prints the device name
   and `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. Build: compiles every kernel source under `aphrodite_tpu_torch/csrc/`
   with nvcc for sm_90a (one process per source, in parallel: K1's fp16
   instances are a source of their own) and prints
   each source's `-Xptxas -v` report on one line, then K1's dynamic
   shared memory per block by page type and slot width, K6 / K10's
   (`quant_gemm_kernel`) at 4 and 8 bits, and that of the m > 64
   kernels of K8, K11, K12-K15, K16 on bf16 and f32 x and K17.
3. Kernels vs plain versions at the main path's shapes (Hq 32, Hkv 8,
   head_dim 128, bf16, 16- and 32-token pages):
   - paged decode attention, K1 (the ragged grid, called with the
     runner's work list) and K5 (the padded (batch, head-block) grid,
     called without): batch 1, 8 and 64, ragged contexts up to 2047
     tokens, with and without the fused KV write and ALiBi, AMLA on and
     off, on bf16 pages; then both on int8 (scale 0.05) and fp8 e5m2
     pages. K1 runs at split counts 1, 2, the policy's and one per
     chunk (its `num_splits` hook), K5 (K1's kernel on the padded grid,
     one kv head a block) at the split count its policy takes, each
     against the plain version at the same count; then a K5 control,
     the plain version on the neighbouring head's K rows, must miss.
     Tolerance: |kernel - plain| <= 2e-2 + 2e-2 |plain| (bf16 outputs
     of f32 sums in another order; exp2 differs by an ulp).
     Pages written by the fused write, quantized codes included: exact.
     Then K1's and K5's fp16 instances (fp16 activations; the plain
     version rounds q and p to fp16 as they do) over fp16 pages at
     every case above, over int8 and fp8 pages at 32-token pages, each
     with a control that must miss (the neighbouring head's K rows), the
     fused write at the edges of fp16 rows (fp16 pages bit for bit), at
     the same tolerance, the largest error reported.
   - prefill page writer (K2): full pages, tail pages, skipped cells,
     on bf16 and fp16 pages. Exact; a control, the plain version also
     writing row `valid` of each tail page, must differ.
   - slot writer (K3/K4, `kv_write_slots_kernel`, which quantizes 8-bit
     pages itself): every timed arm below in the plan's slot-read order
     and in both pinned; bf16, fp16 and f32 rows into pages of their
     dtype, int8 and fp8 pages, shared pages and padding slots of every
     kind; int8 ties and clamps at S 0.25, fp8 e5m2 midpoints, overflow
     to +-inf and NaN, fp16's own edges around e5m2's overflow.
     Exact; two controls must differ: the plain version at kv_scale x
     1.01 on int8 pages, and with the live slots moved one row on bf16
     pages. Timed at the window run's 2 rows (K3), a 64-row decode round
     (K3), phase 4's unaligned round (K4, 24 live slots of 32),
     `k2_problem`'s 2728 rows as slots and the same round's 8192 padded
     rows on bf16, int8 and fp8 pages (K4: an 8-bit prompt round's
     route), each with its plan, its device launches a call (1) and
     `index_copy_` of the live rows (of the codes on 8-bit pages, where
     no PyTorch call quantizes and scatters: a floor, not the library
     call); then from fp16 rows: K3's two arms on fp16 pages and the
     8192-row round into fp16, int8 and fp8 pages.
   Times each kernel (CUDA events, L2 flushed before every launch, the
   stream held by a device spin until the call is enqueued so host time
   stays out, median), its plain version, one PyTorch library call
   computing the same function (scaled_dot_product_attention over the
   gathered KV, dequantized to bf16, for K1 and K5; index_copy_ for the
   writers; a yardstick only, the port never calls it) and the bound:
   the larger of the bytes the function must move over 3.35 TB/s (8-bit
   pages move half the KV bytes) and its operations over 989 TFLOP/s
   (bf16), from this run's inputs. K1 and K5 are timed on every page
   type at phase 4's decode batch and at batch 64 x 2047, K1 also at
   batch 8 x 1016 (the long-context profile's shape), with the split
   count, merge launches and the wrapper's host time
   per call; the plain version at the kernel's split count; their fp16
   instances on fp16 pages at the same shapes, on 8-bit pages at B 8,
   SDPA in fp16.
   A full-width 2-layer model (weights large enough that attention
   matters) is checked end to end against itself run through the plain
   versions: prompt + 3 decode steps, logits within 2e-2 relative.
3b. The speculative verify shape on bf16, int8 and fp8 pages: 8
   sequences x 5 rows (k = 4 drafts; ctx L..L+4 at phase 4's decode
   contexts), the rows of a sequence sharing its block table, padded to
   48 rows as the model runner pads them. K4 (the slot scatter, shared
   pages) writes the 40 slots: exact against its plain version; K1 reads
   them read-only: within 2e-2 + 2e-2 |plain| of its plain version at
   its split count; a control, every row of a sequence at ctx L+4, must
   miss that tolerance. Each timed as in 3, beside its plain version,
   the library call and the bound.
3c. (Phase 19 (a).) K1-K4 at DeepSeek-MoE-16B's multi-head geometry, Hq
   16 over Hkv 16 of 128 (group 1: one live column of K1's 8-wide
   n-tile), through `heads(16, 16)`: K1 on the ragged grid with its work
   list, fused write on and off, at split counts 1, 2, the policy's and
   one per chunk, on bf16, int8 and fp8 pages (phase 3's tolerance), its
   fused write at the 8-bit edges; K2 and K3 / K4 exact with their
   controls, every slot arm timed; K1 timed at B 8 and B 64 x 2047 on
   each page type beside its plain version, SDPA and the bound.
3d. (Phase 20's kernels.) K1-K4 at the other architectures' attention
   geometries: Qwen2-7B's Hq 28 over Hkv 4 (group 7), Phi-2's head_dim
   80 (32 over 32), GPT-NeoX-20B's 96 (64 over 64), GPT-J-6B's 256 (16
   over 16) and DeciLM's groups 8, 16 and 32 (32 query heads over 4, 2
   and 1 KV heads of 128; group 32 runs K1's 16-row blocks). At each:
   K1 with a work list, fused write on and off, at its forced split
   counts, on bf16, int8 and fp8 pages (32-token pages, B 1 x 2047 and
   B 64; phase 3's tolerance), with a control that must miss (the
   neighbouring kv head's K rows, or at one kv head the query's rows
   rolled by 16, the other row block's); K1's fused write at the 8-bit
   edges; K2 and K3 / K4 exact with their controls at the geometry's
   row width; K1 timed at B 64 x 2047 on each page type and at B 8 on
   bf16 pages beside its plain version, SDPA and the bound, the fastest
   named. At group 1 with head_dim 80, 96 and 256 and at group 32, K1's
   fp16 instances too: the same checks on fp16, int8 and fp8 pages, the
   control, and K1 timed at B 64 x 2047 on fp16 pages.
4. End to end: the port's engine serves a Llama of Mistral-7B width and
   depth (hidden 4096, 32 layers, 32/8 heads, intermediate 14336, vocab
   32000), bf16, dummy weights from seed 0, 32-token pages, token ids in
   and out. Its local model directory goes through
   `modeling/hf_loader.resolve_model_path`, like every engine's here:
   once it is built, the run fails if `huggingface_hub` was imported (a
   local path must pass through without a hub package). Then 8 greedy
   requests (prompts of 1000, 300 and 64 tokens, then two of 12 tokens
   arriving one round later), 32 new tokens each, once
   with multi_step=1 and once with multi_step=8. The launch counters are
   reset just before and read just after; K1, K2 and K4 must each have
   launched in both runs (K5 not), and every request must finish with
   32 tokens in the vocabulary and a finite cumulative logprob (K1's
   merge must launch too: the mix's decode grids split). Then 4 decode
   steps of 8 sequences run under torch.profiler: wall and device kernel
   time per step, K1's share (with its merge) and the kernels that take
   the most; once at 64-token prompts and once at 1000-token ones.
5. The same engine and mix with APHRODITE_ATTN_RAGGED=0, at multi_step 1
   and 8: K5 must launch, with the merge (the mix's decode grids
   split), and K1 must not. Each request's tokens must equal the
   ragged run's: K5 is K1's launch on the same grid and split count.
5b. Speculative decoding (APHRODITE_SPEC=1; every other phase pins 0)
   on the same engine: 8 prompts repeating a 16-token n-gram (the mix's
   lengths, 48 new tokens, greedy but two seeded), at multi_step 1,
   first with APHRODITE_SPEC=0, then with it on twice: drafts from the
   engine's n-gram drafter, then from an oracle that drafts the classic
   run's own next tokens (dummy weights rarely emit what a prompt's
   n-gram predicts, so only the oracle reaches full acceptance). Every
   request's tokens must equal the classic run's in both, the oracle
   run must make accepted verify dispatches, and each dispatch must
   launch K4 then read-only K1 once a layer (counted inside the
   dispatches). Logged: engine steps, wall time, drafts proposed and
   accepted. Then 6 batch-8 decode rounds of 64-token n-gram prompts
   on the classic path, with the n-gram drafter and with the oracle,
   timed on the host clock and under torch.profiler: a verify round's
   wall and device time against a classic round's, tokens a round and
   tok/s. Then the async run's streams on this sync engine
   (APHRODITE_SPEC=1): its reference.
5c. AsyncAphrodite (a new engine of the same seed and geometry, the
   sync one freed first) with APHRODITE_SPEC on: 16 concurrent
   `generate` streams of token ids (`skip_tokenizer_init`; the HTTP
   layer is not imported): mixed lengths, three seeded, one with a
   256-token prefix, one a continuation of the reference's first 8
   tokens (`emitted_token_ids`), one aborted after 4 tokens. Every
   stream's tokens must equal the sync engine's (the continuation's
   joint tokens), every page must be back in the free pool, and the
   torch.profiler trace the run is wrapped in (`start_profile` /
   `stop_profile`, written under build/) must name K1's and K4's
   kernels. Logged: TTFT and per-token latency (one-sample figures).
5d. Multi-LoRA (LoRALinearMethod's delta: torch calls over the slot
   stacks, no hand kernel; the path's kernels run beneath it). PEFT
   adapters (adapter_config.json and adapter_model.bin, which the
   loader reads with torch.load) are written under build/ from numpy
   seeds.
   (a) A 2-layer Llama at Mistral-7B width, bf16, enable_lora with
   max_loras 4 and rank 16, four adapters (all seven projections at
   rank 16 twice and at rank 8, zero-padded in its slot; q+v only, the
   subset layout): 8 sequences of 64 tokens, two without an adapter, a
   prompt round (K2) and 3 decode steps (K1). Adapter rows' logits must
   lie within 2e-2 + 2e-2 |ref| of a plain f32 forward (plain attention
   and writers) with each row's W + (alpha / r) B A merged; rows without
   an adapter must equal, bit for bit, the same model with LoRA off on
   the same batch; a control that swaps two adapters' slots must miss
   the bound.
   (b) The e2e engine (phase 4's model, dummy weights from seed 0) with
   enable_lora, max_loras 4: phase 4's mix of 8 base requests plus its
   six first prompts again, each under its own adapter (six adapters
   over four slots, so the scheduler holds adapter requests back and
   the slots are evicted and reloaded), with APHRODITE_SPEC off and on,
   at multi_step 1 and 8. Every request finishes with 32 tokens, every
   adapter row differs from phase 4's tokens for its prompt, every base
   row equals phase 4's while its top-2 logit gap (teacher-forced along
   phase 4's tokens) exceeds the gap bound (4 x the largest logit
   difference between two batch shapes of the same rows, at least one
   bf16 ulp), K1, K2 and K4 launch, every page returns to the pool and
   no step holds more than 4 adapters.
   (c) (a) over a GPTQ W4A16 base (4 bits, group 128; the f32 reference
   takes W dequantized by its plain version): K6 and K7 must launch.
   (d) A batch-8 decode step profiled as in phase 4 with every row
   under an adapter and with none (beside phase 4's LoRA-off profile),
   and the delta's device time a decoder layer at batch 8 and 64
   (`apply` with the rows' slots minus without, timed as in phase 3)
   beside its bytes bound. A yardstick; it gates nothing.
6. The same model and mix with kv_cache_dtype "int8", then "fp8", at
   multi_step 1 and 8: K1 launches on 8-bit pages and the prompts take
   the quantizing slot writer (K4, not K2). The KV pool's page count is
   logged beside bf16's, and a batch-8 decode step profiled as in 4;
   then a prompt round of 4 x 512 tokens under torch.profiler: its
   device time and launches, and the slot writer's, which must be one
   launch a layer (as many slot kernels as K4 calls, 32 a forward
   pass).
7. Sliding window: the published config of mistralai/Mistral-7B-v0.1
   (MistralForCausalLM, sliding_window 4096, max_position_embeddings
   32768; the script writes the dict), bf16, dummy weights from seed 0,
   32-token pages, max_model_len 8192: a 4000-token prompt with 160
   greedy tokens (decode wraps past the window) beside a 64-token
   prompt. K2, K3 (the slot writer with distinct pages) and read-only
   K1 must launch; every request finishes with in-vocabulary tokens.
8. GPTQ kernels vs plain versions at the four projection shapes of
   Mistral-7B, (K, N) = (4096, 6144) qkv, (4096, 4096) o, (4096, 28672)
   gate_up and (14336, 4096) down, group 128, bf16 activations:
   - K7, the decode product (`quant_stream_kernel`), at m 1, 3, 8, 17,
     33 and 64: W4A16, W8A16 and the W4A8 arm, its plan (rows, splits)
     logged; at m 8 a control must miss the tolerance: the plain version
     with the zero rows shifted by one group;
   - K6 (W4A16 and W8A16) at m 72, 128, 512 and 4096 (72 and 128: decode
     batches above 64, where the plan splits the groups), with the plan
     (tile, splits) and the wrapper's host time per call logged, and K8
     (W4A8) at the same m with its plan (splits of 128-row chunks)
     logged and a control that must miss the tolerance at each m: the
     plain version with the zero rows shifted by one group;
   - K9 (per-row int8 quantization) at m 1, 8, 64, 512 and 4096: exact,
     on x, on a contiguous view of it 2 bytes past a 16-byte boundary
     and on rows of an odd K (K - 3); timed at each m, its plan (threads,
     16-byte runs a thread) logged.
   Each check calls the wrapper the engine calls (`gptq_matmul`,
   `gptq_matmul_a8`, which runs K9 then the matmul) against its plain
   version. Tolerance for the matmuls: |kernel - plain| <= 2e-2 + 2e-2
   |plain| (bf16 outputs of f32 sums taken in another order). Each case
   is timed like phase 3 (the W4A8 matmuls alone on K9's rows, with a
   check that this launch equals the wrapper's output; the wrapper's
   time is logged beside); its bound is the larger of the bytes it must
   move over 3.35 TB/s and its operations over 989 TFLOP/s (bf16) or
   1979 TOP/s (int8). The library yardstick for K6/K7-a16 is
   torch.matmul over the weight dequantized to bf16 beforehand (it
   moves 4x the int4 weight's bytes); K8 and K9 have none (PyTorch has
   no int4-by-int8 grouped product and no fused row quantizer).
9. End to end with GPTQ: the same model
   is served with quantization="gptq" (4 bits, group 128, dummy
   weights from seed 0), once with APHRODITE_W4A8=1 (the JAX bench's
   default) and once with W4A16: phase 4's request mix at multi_step 1
   and 8, then one round of 96 requests with 32-token prompts (a decode
   batch above 64). Counters are reset before and read after each run:
   the W4A8 runs must launch K9 with K8 and K7's a8 arm, the W4A16 runs
   K6 and K7, both K1, K2 and K4; the 96-request round's decode steps
   must take K8 / K6 and their split reduce (`quant_gemm_split_reduce`:
   batch 96 is one row tile). The launches
   of every kernel are logged per path
   (bf16, GPTQ and AWQ arms); the kernel JSON gives their sum.
   Then a batch-8 GPTQ decode step under
   torch.profiler in each arm: wall and device time, and the quantized
   matmuls' device time beside their weight-streaming bound; and one
   prompt round of 4 x 512 tokens (2048 rows: K8 or K6) under
   torch.profiler: its device time and the quantized kernels' share.
   The GPTQ engine is freed.
10. AWQ kernels vs plain versions at the same four projections, group
   128, bf16 (the AWQ layout: qweight [K, N/8], 8 interleaved columns per
   word): K7's AWQ layout, a16 and a8 arms, at m 1, 8 and 64; K10 (a16)
   at m 72, 128, 512 and 4096 (plan and host time logged as for K6) and
   K11 (a8) at the same m, plan logged and two controls at each m: the
   zero rows shifted by one group, and AWQ's column interleave undone
   (the words read in natural column order). Each check calls the
   engine calls (`awq_matmul`, `awq_matmul_a8`) against its plain
   version, with phase 8's tolerance, and is timed as phase 8 times the
   GPTQ cases (library yardstick for K10/K7-a16: torch.matmul over the
   weight dequantized to bf16 beforehand; K11 and K7-a8 have none).
11. End to end with AWQ: the same model served with the
   quantization_config of TheBloke/Mistral-7B-v0.1-AWQ (4 bits, group
   128, zero point, GEMM version; dummy weights from seed 0), W4A8
   (APHRODITE_W4A8=1) then W4A16: phase 4's request mix at multi_step 1,
   then the 96-request round. The W4A8 arm must launch K9 with K11 and
   K7's AWQ a8 arm, the W4A16 arm K10 and K7's AWQ layout (each with its
   split reduce in the wide round), both K1, K2 and K4. A batch-8 decode
   step and a prompt round are profiled in each arm as in phase 9.
12. Seeded draws on the card: JAX's threefry keys, bits and uniforms
   (`modeling/layers/prng.py`) for 64 rows x vocab 32000 bit-equal to
   the same calls on the CPU, and the tokens drawn equal; one seeded
   request (temperature 0.8) served alone and in a batch of 8 gives the
   same tokens.
13. GGUF kernels vs plain versions at the same four projections, m 1,
   8, 16, 17, 32, 33, 64, 512 and 4096 and 65, 72, 128 and 256 (where
   the m > 64 kernels split the K range), through the wrappers the
   engine calls: `gguf_q8_matmul` (K13, a bf16 scale row per 32 input
   rows) and `gguf_i8g_matmul` (K14, per 16 rows), up to 16 and 13 rows
   (`Q8_STREAM_M_MAX`, `I8G_STREAM_M_MAX`) on `quant_stream_kernel<8,
   kQ8 / kI8g>`, its stream plan logged, above on `quant_gemm_kernel<8,
   kQ8 / kI8g>`;
   and `gguf_w8a8_matmul` (K9, then K15, per 128 rows; up to 12 rows,
   `K15_STREAM_M_MAX`, the a8 arm of `quant_stream_kernel<8, kQs8>`,
   above `w8a8_gemm_kernel`; K15 alone on K9's rows also with each route
   pinned at m 1, 8, 13, 16, 17, 32, 33 and 64). Weights are quantized on
   the card from an N(0, 0.02) weight as the at-rest forms hold real ones
   (codes in [-127, 127], K14's Q6_K-shaped in [-32, 31]). Phase 8's
   tolerance; controls that must miss it: K13's plain version with d
   shifted by one group and with d read per 16 rows (K14's map) at every
   m, on both routes; K14's reading d16 per 32 rows at m 8 and on its
   gemm, K15's with its scale rows shifted by one group at every m, on
   both routes. Each case timed as phase 8 times them (K15 alone on
   K9's rows, with a check that it equals the wrapper's output), the
   plain version and the library yardstick (torch.matmul over the
   weight dequantized to bf16 beforehand, twice the int8 bytes) at m 8
   and 4096; the m > 64 kernels' layer times at m 72, 128, 512 and 4096
   are logged on one line.
14. End to end with dummy GGUF weights (quantization="gguf", seed 0) in
   the JAX bench's three at-rest forms: the default turbo form (K9 +
   K15), BENCH_GGUF_FMT=q8_0 (K13) and BENCH_GGUF_FMT=q6_k (K14).
   Phase 4's mix at multi_step 1 in each, then the 96-request round.
   Each form must launch its kernel and neither of the other two, and
   K1, K2 and K4, and its m > 64 kernel too (`gguf_w8a8_gemm`,
   `gguf_q8_gemm`, `gguf_i8g_gemm`; the other forms' never), whose split
   reduce (`quant_gemm_split_reduce`) the 96-request round must launch.
   The mix's decode steps (batch 8 at most) count on the form's
   own counter, which K13 and K14 add to only where they launch
   `quant_stream_kernel`; the 96-request round's on the m > 64 kernel's.
   The KV pool's page count is logged
   beside bf16's, and a batch-8 decode step profiled as in phase 9 (the
   GGUF matmuls' device time beside their weight-streaming bound; K9's
   device ms a step in the turbo run, K13's in the q8_0 run, K14's in the
   q6_k run; phase 9's GPTQ W4A8 profile reports K9's too).
15. A `.gguf` file through the loader: the script writes (under the
   gitignored `build/`, deleted after) a 2-layer Llama at Mistral-7B
   width with a 32000-token `tokenizer.ggml.*` vocabulary: F32 norms,
   F16 embeddings and output, attn_q/attn_k Q4_0 beside attn_v Q8_0 (a
   mixed group, K14), attn_output and ffn_down Q8_0 (K13), ffn_gate and
   ffn_up Q4_0 (turbo, K15). Loaded with quantization="gguf", bf16,
   skip_tokenizer_init; each bucket's at-rest form is asserted; 8 greedy
   requests (phase 4's mix) must launch all three kernels (at m > 64
   too); a prompt and 3
   decode steps are held against the same model run through the plain
   versions: each GGUF matmul against its plain version on the same
   activations (phase 8's tolerance), the logits within 2e-2 of max
   |logit| with the plain K15 on the int8 rows K9 gave the kernel run
   (a code flipped by an upstream bf16 sum-order difference moves a
   product by a whole step; the plain path on its own rows, and the
   share of codes that flipped, are logged beside it). Three controls,
   the held plain path with K15's scale rows shifted by one group, K14's
   d16 read per 32 rows, or K13's d shifted by one group, must each miss
   2e-2.
16. K12, K16 and K17 vs plain versions at the same four projections, m
   1, 8, 16, 17, 32, 33, 64, 512 and 4096 and 65, 72, 128 and 256,
   through the wrappers the engine calls: `gguf_q4k_matmul` (K12,
   random Q4_K codes with affine dl/ml rows per 32 input rows; at m <= 64
   `quant_stream_kernel<4, kQ4k>`, above `quant_gemm_kernel<4, kQ4k>`),
   `squeezellm_matmul` on bf16 x (K16, an N(0, 0.02) bf16 codebook per
   column; `quant_stream_kernel<4, kLut>`, above `quant_gemm_kernel<4,
   kLut>`) and on f32 x (QuIP#'s E8P table times Wscale 0.05, codes over
   its 12 values; `quant_stream_kernel<4, kLutX32>`, above
   `split_x32_kernel` and `quant_gemm_kernel<4, kLutX32>`) and
   `int8_matmul` (K17, int8 codes times f32 column scales; at m <= 16
   (`INT8_STREAM_M_MAX`) `quant_stream_kernel<8, kInt8>`, its stream
   plan logged, from m 17
   `quant_gemm_kernel<8, kInt8>`); each call must count one launch on
   its kernel's counter (the quant_gemm_kernel launches on their own).
   A control must miss the tolerance at every m > 64, and for K17 at
   every m: K12's plain version with dl and ml shifted by one group,
   K16's with its codebook columns rolled by one (on f32 x, QuIP#'s
   table the same in every column, its entries rolled by one code),
   K17's with its column scales rolled by one. Tolerance: phase 8's
   for bf16; K16 on f32 x within 1e-4 of max |plain| (its control must
   pass that). Timed as phase 13, with the plain
   version and the library yardstick (torch.matmul over the weight
   dequantized beforehand: bf16, f32 for K16-f32, K17's scales folded
   in) at m 8 and 4096; the bound takes three bf16 products per term for
   K16-f32. The m > 64 kernels' layer times (K12, K16, K16-f32, K17) at
   m 72, 128, 512 and 4096 are logged on one line.
17. End to end with dummy weights at Mistral-7B width and depth, as
   SqueezeLLM (K16), int8 (K17; its int8 weights stay zero, as in the
   JAX package), QuIP# (K16 on f32 activations, no K17) and GGUF's exact
   Q4_K form (APHRODITE_GGUF_EXACT=1: K12, and none of K9, K13-K15):
   phase 4's mix at multi_step 1, in which every engine step must launch
   the arm's kernel a positive multiple of 128 times (4 projections x 32
   layers; each arm's skinny kernel counted with its m > 64 kernel,
   `gguf_q4k_gemm`, `squeezellm_gemm`, `squeezellm_f32_gemm` (QuIP#),
   `int8_gemm`, which its arm must launch and every other arm must not)
   and none of the other quantized matmuls (the int8 arm's decode steps
   on K17's `quant_stream_kernel`, its prompt rounds on `int8_gemm`);
   the 96-request round (with the split reduce);
   a batch-8 decode step profiled as in phase 9 (with the kernel
   launches per step: QuIP#'s Hadamard transforms are eager torch ops;
   K17's stream kernel's device ms a step in the int8 arm).
18. 2-layer models at Mistral-7B width through K12, K16, K16-f32 and K17
   vs their plain versions (`compare_with_plain`: logits within 2e-2 of
   max |logit|, each quantized matmul on the model's activations within
   its phase-16 tolerance): exact Q4_K (codes random, dl in [1e-3,
   4e-3), ml = 8 dl), SqueezeLLM (a random codebook), int8 (codes in
   [-127, 127], scales in [1e-4, 5e-4)) and QuIP# (random Qidxs for 1024
   output columns through `quip_codes4_from_qidxs`, tiled and shuffled
   across the width, SU and SV +-1, Wscale 0.05, the get_hadK factors).
   Each has a control that must miss 2e-2: K12's dl shifted by one
   group, K16's codebook columns rolled by one, K17's scales rolled by
   one, QuIP#'s table entries rolled by one code.
19. Mixture of experts (`modeling/layers/fused_moe.py`: routing and the
   grouped expert products are torch calls, no hand kernel; K1-K4 run
   beneath):
   (a) runs as phase 3c, beside the other kernel checks: at the end of
   a full run torch.profiler's one-call traces of the slot writer came
   back empty in all eight tries (`device_launches`), twice.
   (b) 2-layer models at full width against their plain paths
   (`compare_with_plain`): Mixtral-8x7B (8 experts of 14336, top 2) and
   DeepSeek-MoE-16B (layer 0 dense at 10944, layer 1 64 experts of
   1408, top 6, 2 shared), routers U(-a, a) with a = 3 sqrt(3 / hidden).
   The plain run takes the kernel run's expert picks call by call; the
   share of its own picks in the kernel run's sets is logged and tokens
   whose k-th and (k+1)-th probabilities lie more than MOE_PICK_MARGIN
   apart must agree. Control: every expert stack rolled by one expert
   must miss the tolerance.
   (c) DeepSeek-MoE-16B whole (the published config, 28 layers, bf16,
   dummy weights from seed 0): phase 4's mix at multi_step 1 and 8, then
   with APHRODITE_SPEC=1 and oracle drafts (verify rows through the MoE
   FFN). Every request finishes, every engine step launches K1, K2 and
   K3 / K4 a positive multiple of 28 times, every page comes back; host
   reads of the group sizes are logged.
   (d) Mixtral-8x7B at full width, 2 of its 32 layers (46.7B bf16
   parameters do not fit 80 GB; 4 layers before, cut for time),
   through the mix at multi_step 1.
   (e) (c)'s engine profiled: a batch-8 decode step (wall and device ms,
   launches, the MoE FFN's device ms inside a torch.profiler range,
   host reads a step, experts touched a layer and the weight-bytes
   bound, peak memory) and a 2048-row prompt round (the MoE FFN's
   share).
20. The other architectures (`ARCH_MODELS`, published configs written
   here by hand: Qwen/Qwen2-7B, microsoft/phi-2, EleutherAI/gpt-j-6b,
   EleutherAI/gpt-neox-20b, facebook/opt-6.7b, and DeciLM-7B's widths
   with a per-layer KV list [4, 2, 1] of this script's choosing):
   (a) each at full width cut to 2 layers (DeciLM 3) against its plain
   path (`compare_with_plain`, 2e-2 of max |logit|) with a control that
   must miss (Qwen2's q/k/v biases dropped, Phi's rotary over the whole
   head, GPT-J's rotary neox-style, NeoX's qkv left per-head
   interleaved, OPT's positions without the +2 offset, DeciLM's K rows
   rolled by one KV head), then through phase 4's mix at multi_step 1
   on dummy weights; (b) Qwen2-7B whole (28 layers, bf16, dummy weights
   from seed 0): the mix at multi_step 1 and 8, then APHRODITE_SPEC=1
   with oracle drafts; every request finishes, every engine step
   launches K1, K2 and K3 / K4 a positive multiple of 28 times, K3 never
   (no sliding window: HF's Qwen2Config keeps none under
   use_sliding_window false, and the JAX package reads it so), every
   page comes back; (c) GPTQ W4A16 over a 2-layer Qwen2-7B (random
   codes, biases after the kernel) through K6 and K7 against its plain
   path, with two controls; (d) (b)'s engine profiled: a batch-8 decode
   step against the weights' bytes bound, and a 2048-row prompt round.
21. The quantized fallback route (`modeling/layers/quantization/*`:
   dequantize, then matmul, in plain torch; no hand kernel, as the JAX
   package runs it through XLA) for the layers the kernels' gates
   refuse and for float32 activations, chosen per layer before any
   launch:
   (a) at Mistral-7B's four projections, m 1, 8, 64 and 2048: GPTQ
   4-bit group 32 with an act-order g_idx (a seeded permutation of
   arange(K) // 32), GPTQ 2-bit group 128 and AWQ group 64, random codes
   and zeros, scales in [0.002, 0.022); the engine's own `apply` on the
   card against a float64 dequantize-and-matmul on the card from the
   same codes (this script's own unpacking; the weight rounded to bf16,
   as the route and the JAX package's `dequantize` round it), phase 8's
   tolerance; a
   control, GPTQ's g_idx rolled by one group or AWQ's zero rows shifted
   by one group, must miss it; no quantized wrapper may launch. Timed
   as phase 8 beside the group-128 kernel route at the same shape (K7 at
   m <= 64, K6 / K10 above) and torch.matmul over the weight
   dequantized beforehand.
   (b) GPTQ act-order (the quantize_config of TheBloke/Mistral-7B-v0.1-
   GPTQ's gptq-4bit-32g-actorder_True branch: 4 bits, group 32,
   desc_act, sym) at Mistral-7B width and depth, bf16, dummy weights
   from seed 0, each layer's g_idx then made act-order as in (a):
   phase 4's mix at multi_step 1 (W4A16); every request finishes, K1,
   K2 and K4 launch, no K6-K9; a batch-8 decode step and a 2048-row
   prompt round profiled (wall and device ms, the fallback's share
   inside a torch.profiler range "quant_fallback", peak memory).
   (c) A 2-layer GPTQ Llama at Mistral-7B width (4 bits, group 128, no
   act-order, g_idx = arange(K) // 128): teacher-forced logits at 99
   positions (a 96-row prompt, every row, then 3 decode steps) with
   APHRODITE_DISABLE_PALLAS_QUANT=0 (K6 8 and K7 24 launches) and =1
   (the fallback, none) within ROUTE_BOUND (2e-2) of max |logit|; the
   fallback with g_idx rolled by one group must miss it.
   (d) Qwen2-7B (phase 20's published config, 28 layers) with
   Qwen/Qwen2-7B-Instruct-AWQ's quantization_config (4 bits, group 128,
   zero point, gemm), bf16, dummy weights from seed 0: each projection's
   route logged (gate_up on the kernels, qkv, o and down on the
   fallback); phase 4's mix at multi_step 1 (W4A16), K7's AWQ layout and
   K10 launching once a layer every engine step and no other quantized
   kernel; a batch-8 decode step profiled.
   (e) GGUF q8_0, q6_k and q4_k buckets, SqueezeLLM and int8 at in 384,
   QuIP#'s int8 form at hidden 128 (bf16), and float32 GPTQ, AWQ, GGUF
   q8_0 and int8 at shapes their gates take: `apply` on the card against
   the same `apply` on the CPU at m 1, 5 and 72 (bf16: phase 8's
   tolerance; f32: 1e-4 of max |CPU|), no quantized wrapper launching.
22. float16 end to end (`run_fp16_phase`; the JAX package serves
   `dtype="float16"` with its f32 jnp attention and XLA scatter, the
   port with K1-K4's fp16 instances), dummy weights from seed 0:
   (a) MISTRAL_7B whole at dtype float16 (32 layers, 14.5 GB): phase
   4's mix at multi_step 1 with APHRODITE_SPEC=1 (the default) and
   again with APHRODITE_ATTN_RAGGED=0 (K5); phase 5b's n-gram mix
   classic and with oracle drafts (verify rows through K4 and read-only
   K1 at fp16, tokens equal); a batch-8 decode step profiled beside
   phase 4's bf16 one (device ms, idle share, K1's ms). (b) The 2-layer
   full-width check of phase 3 in fp16 on fp16 pages. (c) int8 KV pages
   at 2 layers through the mix. (d) Mistral-7B-v0.1 (its 4096 window) at
   2 layers on fp16 pages through the mix: K3 on fp16 rows. (e) GPTQ
   4-bit group 128 at 2 layers: every layer on the fallback route (the
   kernels take bf16 activations), the mix, a decode step profiled and
   projected to 32 layers. Every request finishes; each run's required
   kernels launch.
23. Prints the kernel JSON line (launches summed over every path
   above; the fp16 instances', `name@fp16`, over phase 22's paths, the
   others' over the rest), the card line, and last {"ok": true,
   "device": {...}}.

No earlier phase is cut in depth for time (PERF.md has the run's
seconds on an NVIDIA H100 80GB HBM3).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HQ, HKV, HEAD_DIM = 32, 8, 128
ACT = "bfloat16"                   # the kernel checks' activation dtype
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
ATOL = RTOL = 2e-2
KV_SCALE = 0.05                    # int8 KV scale (the default)

MISTRAL_7B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 1, "eos_token_id": 2,
}


# The published config.json of mistralai/Mistral-7B-v0.1 (Hugging Face
# hub): MISTRAL_7B's widths, with the 4096-token sliding window.
MISTRAL_7B_V01 = {
    "architectures": ["MistralForCausalLM"], "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "model_type": "mistral",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "sliding_window": 4096, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "transformers_version": "4.34.0.dev0",
    "use_cache": True, "vocab_size": 32000,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------ timing --

class Timer:
    """Median kernel time over `iters` launches, each with the L2 cache
    flushed first (decode reads every layer's KV cold) and the stream
    then held by a device-side spin (`torch.cuda._sleep`, about 1 ms)
    while the host runs the wrapper: the start event executes only after
    the call is enqueued, so the wrapper's host time stays out of the
    window (without the spin a call under ~0.1 ms measured its wrapper's
    40-60 us of host time too)."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch, iters: int = 20) -> None:
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(96 << 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound(nbytes: float, flops: float, ops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def heads(hq: int, hkv: int, head_dim: int = 128):
    """The kernel checks, timers and `compare_with_plain` at another
    attention geometry: they read HQ, HKV and HEAD_DIM when called."""
    global HQ, HKV, HEAD_DIM
    saved = HQ, HKV, HEAD_DIM
    HQ, HKV, HEAD_DIM = hq, hkv, head_dim
    try:
        yield
    finally:
        HQ, HKV, HEAD_DIM = saved


@contextlib.contextmanager
def activations(name: str):
    """The kernel checks and timers on `name` activations ("float16":
    K1's fp16 instances; the rows the writers take): they read ACT when
    called."""
    global ACT
    saved, ACT = ACT, name
    try:
        yield
    finally:
        ACT = saved


def act_dtype(torch):
    return getattr(torch, ACT)


def act_label() -> str:
    """" under fp16 activations" where the checks run at float16."""
    return "" if ACT == "bfloat16" else " under fp16 activations"


def k1_heads(pa) -> int:
    """K1's blocks a (sequence, split) at the current geometry: each kv
    head's query rows in blocks of 16 (what its split policy counts)."""
    return HKV * pa.row_blocks(HQ // HKV)


# -------------------------------------------------- K1 problem builder --

def decode_problem(torch, ctxs, page_size, pages_per_seq, seed,
                   alibi=False, fused=False, page_dtype=None):
    """Random decode inputs in the activation dtype (`activations`);
    pages in it, or quantized to int8 (scale KV_SCALE) or fp8 e5m2 from
    the same values."""
    from aphrodite_tpu_torch.ops.kv_quant import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = len(ctxs)
    num_pages = batch * pages_per_seq + 1
    hd = HKV * HEAD_DIM

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            act_dtype(torch))
    q = randn(batch, HQ, HEAD_DIM)
    kp = quantize_kv(randn(num_pages, page_size, hd),
                     page_dtype or act_dtype(torch), KV_SCALE)
    vp = quantize_kv(randn(num_pages, page_size, hd),
                     page_dtype or act_dtype(torch), KV_SCALE)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    tables = perm[:batch * pages_per_seq].view(batch, pages_per_seq).to(
        torch.int32).contiguous()
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    slopes = torch.tensor([2.0 ** -(8 * (i + 1) / HQ) for i in range(HQ)],
                          dtype=torch.float32, device="cuda") \
        if alibi else None
    knew = randn(batch, HKV, HEAD_DIM) if fused else None
    vnew = randn(batch, HKV, HEAD_DIM) if fused else None
    return q, kp, vp, tables, ctx, slopes, knew, vnew


def _pages_equal(torch, a, b):
    """Equal pages: bit for bit on 8-bit and fp16 pages (a copied NaN
    keeps its bits), by value otherwise."""
    view = (lambda t: t.view(torch.uint8)) if a.element_size() == 1 or \
        a.dtype == torch.float16 else (lambda t: t)
    return torch.equal(view(a), view(b))


def k1_split_counts(pa, batch, pps, ppc):
    """K1's forced split counts: 1, 2, the policy's choice and one per
    chunk (each once)."""
    n_chunks = pps // ppc
    policy = pa.choose_decode_splits(batch, k1_heads(pa), pps, ppc,
                                     pa.sm_count("cuda"))
    return sorted({n for n in (1, 2, policy, n_chunks) if n <= n_chunks})


def check_decode_attention(torch, pa, ragged: bool, page_dtype,
                           amlas=(True, False), alibis=(False, True),
                           page_sizes=(16, 32), batches=(1, 8, 64)):
    """K1 (`ragged`: with a work list) or K5 (without) vs the plain
    version across the main path's shapes (page sizes and batches of
    `page_sizes` and `batches`), on bf16, int8 or fp8 pages; K1 at every
    forced split count of `k1_split_counts`, K5 at its policy's, each
    against the plain version at the same split count. Returns the
    largest error."""
    import random
    from aphrodite_tpu_torch.ops.kv_quant import dequant_scale
    rng = random.Random(0)
    name = "K1" if ragged else "K5"
    kind = str(page_dtype).replace("torch.", "")
    kv_scale = dequant_scale(page_dtype, KV_SCALE)
    worst = 0.0
    cases = 0
    for page_size in page_sizes:
        pps = 2048 // page_size
        for batch in batches:
            specials = [1, 17, 100, 1000, 2047]
            ctxs = [specials[i] if i < len(specials)
                    else rng.randint(1, 2047) for i in range(batch)]
            if batch == 1:
                ctxs = [2047]
            ppc = pa.choose_pages_per_chunk(pps, page_size, batch)
            work = pa.build_decode_work_list(
                [-(-c // page_size) for c in ctxs], ppc) if ragged else None
            # K1: forced split counts; K5: its policy's.
            variants = k1_split_counts(pa, batch, pps, ppc) \
                if ragged else [None]
            for fused, alibi, amla, splits in (
                    (f, a, m, n) for f in (False, True) for a in alibis
                    for m in amlas for n in variants):
                n_split = splits or pa.choose_decode_splits(
                    batch, k1_heads(pa), pps, ppc, pa.sm_count("cuda"))
                q, kp, vp, tb, ctx, sl, kn, vn = decode_problem(
                    torch, ctxs, page_size, pps, seed=cases, alibi=alibi,
                    fused=fused, page_dtype=page_dtype)
                kp2, vp2 = kp.clone(), vp.clone()
                kw = dict(scale=HEAD_DIM ** -0.5, kv_scale=kv_scale,
                          pages_per_chunk=ppc, amla=amla)
                got = pa.paged_decode_attention(
                    q, kp, vp, tb, ctx, sl, kn, vn, work_items=work,
                    num_splits=splits, **kw)
                want = pa.paged_decode_attention_plain(
                    q, kp2, vp2, tb, ctx, sl, kn, vn, num_splits=n_split,
                    **kw)
                torch.cuda.synchronize()
                what = (f"{name} {kind}{act_label()} page {page_size} "
                        f"batch {batch} "
                        f"fused {fused} alibi {alibi} amla {amla}"
                        + f" splits {n_split}")
                if fused:
                    got, want = got[0], want[0]
                    if not (_pages_equal(torch, kp, kp2) and
                            _pages_equal(torch, vp, vp2)):
                        fail(f"{what}: fused write differs")
                err = (got.float() - want.float()).abs()
                lim = ATOL + RTOL * want.float().abs()
                if not torch.isfinite(got.float()).all() or \
                        bool((err > lim).any()):
                    fail(f"{what}: max err {err.max().item()}")
                worst = max(worst, err.max().item())
                cases += 1
    log(f"{name} paged_decode_attention{'' if ragged else '_tm'} on "
        f"{kind} pages{act_label()} (Hq {HQ}, Hkv {HKV}, d {HEAD_DIM}) vs "
        f"plain: "
        f"{cases} cases, max abs err {worst} "
        f"(tolerance {ATOL} + {RTOL}|plain|); fused-write pages exact"
        + ("; split counts 1, 2, the policy's and one per chunk"
           if ragged else "; at its policy's split counts"))
    return worst


def check_k5_control(torch, pa, ragged: bool = False):
    """K5 (K1 with `ragged`) at batch 64 x 2047 (pages of the activation
    dtype, 32 tokens) within tolerance of the plain version, and a wrong
    plain version, the K rows of the neighbouring kv head (pages rolled
    by head_dim along the lanes), beyond it: a head-offset fault in the
    staged rows cannot pass."""
    name = "K1" if ragged else "K5"
    ctxs = [2047] * 62 + [1000, 17]
    q, kp, vp, tb, ctx, _, _, _ = decode_problem(torch, ctxs, 32, 64,
                                                 seed=77)
    ppc = pa.choose_pages_per_chunk(64, 32, len(ctxs))
    n_split = pa.choose_decode_splits(len(ctxs), k1_heads(pa), 64, ppc,
                                      pa.sm_count("cuda"))
    work = pa.build_decode_work_list([-(-c // 32) for c in ctxs], ppc) \
        if ragged else None
    kw = dict(scale=HEAD_DIM ** -0.5, pages_per_chunk=ppc)
    got = pa.paged_decode_attention(q, kp, vp, tb, ctx, work_items=work,
                                    **kw)
    good = pa.paged_decode_attention_plain(q, kp, vp, tb, ctx,
                                           num_splits=n_split, **kw)
    bad = pa.paged_decode_attention_plain(q, kp.roll(HEAD_DIM, 2), vp, tb,
                                          ctx, num_splits=n_split, **kw)
    torch.cuda.synchronize()
    err = (got.float() - good.float()).abs()
    c_err = (got.float() - bad.float()).abs()
    if bool((err > ATOL + RTOL * good.float().abs()).any()):
        fail(f"{name}{act_label()} control case: max err "
             f"{err.max().item()} against plain")
    if not bool((c_err > ATOL + RTOL * bad.float().abs()).any()):
        fail(f"{name}{act_label()}: the control (the neighbouring head's K "
             "rows) is within tolerance of the kernel")
    log(f"{name}{act_label()} control (the neighbouring kv head's K rows) "
        f"missed: max err {c_err.max().item():.4f} against "
        f"{err.max().item():.4f} for the plain version ({n_split} "
        "split(s))")


def time_decode_attention(torch, pa, timer, ctxs, page_size, pps, fused,
                          ragged=True, page_dtype=None):
    """Kernel, plain and library times and the bound of K1 (`ragged`) or
    K5 at one decode shape, chunked as the engine chunks it."""
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.kv_quant import dequant_scale
    page_dtype = page_dtype or act_dtype(torch)
    q, kp, vp, tb, ctx, sl, kn, vn = decode_problem(
        torch, ctxs, page_size, pps, seed=99, fused=fused,
        page_dtype=page_dtype)
    batch = len(ctxs)
    ppc = pa.choose_pages_per_chunk(pps, page_size, batch)
    work = pa.build_decode_work_list(
        [-(-c // page_size) for c in ctxs], ppc) if ragged else None
    kw = dict(scale=HEAD_DIM ** -0.5,
              kv_scale=dequant_scale(page_dtype, KV_SCALE),
              pages_per_chunk=ppc)
    def call():
        return pa.paged_decode_attention(q, kp, vp, tb, ctx, sl, kn, vn,
                                         work_items=work, **kw)
    merges = pa.PAGED_DECODE_MERGE_LAUNCHES.count
    call()
    merges = pa.PAGED_DECODE_MERGE_LAUNCHES.count - merges
    n_split = pa.choose_decode_splits(batch, k1_heads(pa), pps, ppc,
                                      pa.sm_count("cuda"))
    # The wrapper's host time per call: 50 calls enqueued back to back.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    ms = timer(call)
    # K1's plain version at one split (its PERF.md rows); K5's at the
    # split count it picks.
    plain_ms = timer(lambda: pa.paged_decode_attention_plain(
        q, kp, vp, tb, ctx, sl, kn, vn,
        num_splits=1 if ragged else n_split, **kw))
    # Library yardstick: SDPA over each sequence's KV gathered to the
    # batch-max context and dequantized to the activation dtype (gather,
    # dequant and head expansion outside the timing).
    lmax = max(ctxs)
    idx = tb.long()
    deq = kw["kv_scale"]
    kg = (kp[idx].to(q.dtype) * deq).view(
        batch, pps * page_size, HKV, HEAD_DIM)[:, :lmax]
    vg = (vp[idx].to(q.dtype) * deq).view(
        batch, pps * page_size, HKV, HEAD_DIM)[:, :lmax]
    group = HQ // HKV
    kx = kg.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
    vx = vg.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
    mask = (torch.arange(lmax, device="cuda")[None] <
            ctx.long()[:, None]).view(batch, 1, 1, lmax)
    q4 = q.view(batch, HQ, 1, HEAD_DIM)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q4, kx, vx, attn_mask=mask, scale=HEAD_DIM ** -0.5))
    del kg, vg, kx, vx
    elt = kp.element_size()
    total_ctx = sum(ctxs)
    nbytes = (total_ctx * HKV * HEAD_DIM * 2 * elt     # K and V read
              + 2 * batch * HQ * HEAD_DIM * 2          # q in, out
              + batch * pps * 4 + batch * 4)           # tables, ctx
    if fused:
        nbytes += 2 * batch * HKV * HEAD_DIM * (2 + elt)  # knew/vnew in+out
    flops = 4 * HQ * HEAD_DIM * total_ctx
    b_ms, b_by = bound(nbytes, flops)
    return ms, plain_ms, library_ms, b_ms, b_by, n_split, merges, host_us


# ------------------------------------------------------- K2 / K3 / K4 --

def k2_problem(torch, gen, num_pages: int, page_size: int = 32):
    """K2's inputs at the first prompt round of phase 4: prompts of 1000,
    300, 64, 1000, 300, 64 tokens padded to 1024 in a batch bucket of 8
    (256 cells, 88 live, 2728 rows), each live page of a prompt at a
    random page of a pool of `num_pages`, the bucket's other cells
    skipped (page id num_pages), a prompt's last page its tail. Returns
    knew, vnew [cells * page_size, Hkv * d] bf16, page ids and valids
    (int32 on the card), the identity src_blocks (host), and the live
    source rows with their slots (int64 on the card): the rows
    index_copy_, the library yardstick, writes."""
    import numpy as np
    hd = HKV * HEAD_DIM
    prompts = [1000, 300, 64, 1000, 300, 64]
    padded_batch, padded_len = 8, 1024
    ppp = padded_len // page_size
    cells = padded_batch * ppp
    pid = np.full((cells,), num_pages, dtype=np.int32)
    vld = np.zeros((cells,), dtype=np.int32)
    perm = torch.randperm(num_pages, generator=gen,
                          device="cuda").cpu().numpy()
    nxt = 0
    for i, n in enumerate(prompts):
        for p in range(-(-n // page_size)):
            pid[i * ppp + p] = perm[nxt]
            vld[i * ppp + p] = min(n - p * page_size, page_size)
            nxt += 1
    live = np.repeat(pid < num_pages, page_size) & \
        (np.tile(np.arange(page_size), cells) < np.repeat(vld, page_size))
    slots = (np.repeat(pid.astype(np.int64), page_size) * page_size +
             np.tile(np.arange(page_size), cells))[live]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    return dict(knew=randn(cells * page_size, hd),
                vnew=randn(cells * page_size, hd),
                pid=torch.from_numpy(pid).cuda(),
                vld=torch.from_numpy(vld).cuda(),
                sblk=np.arange(cells, dtype=np.int32),
                live=torch.from_numpy(live).cuda(),
                slots=torch.from_numpy(slots).cuda(),
                cells=cells, rows=int(vld.sum()))


def k2_bound_bytes(c) -> int:
    """K2's bytes at `k2_problem`'s cells: the live rows of K and V read
    once and written once, and the page ids and valids read."""
    return 2 * 2 * c["rows"] * HKV * HEAD_DIM * 2 + c["cells"] * 8


def check_and_time_writers(torch, kw, timer, profiled: bool = True,
                           timed: bool = True, fp16: bool = False):
    """K2 exact against its plain version (with a control), then K3 / K4
    (`check_and_time_slot_writers`); with `timed` False nothing is timed
    (K3 / K4 only `check_slot_writers`) and None is returned for each.
    With `fp16` K2 is also held on fp16 pages, with its control, and the
    slot writer's arms of fp16 rows are checked and timed too. Returns
    K2's times and the slot writer's by arm."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    hd = HKV * HEAD_DIM
    page_size = 32

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    # K2 at the first prompt round of phase 4, with tail pages and
    # skipped cells.
    num_pages = 4096
    kp, vp = randn(num_pages, page_size, hd), randn(num_pages, page_size,
                                                    hd)
    c = k2_problem(torch, gen, num_pages, page_size)
    knew, vnew, pid_t, vld_t, sblk = (c[k] for k in ("knew", "vnew", "pid",
                                                     "vld", "sblk"))
    a = kw.write_kv_pages_prefill(knew, vnew, kp.clone(), vp.clone(),
                                  pid_t, sblk, vld_t)
    b = kw.write_kv_pages_prefill_plain(knew, vnew, kp.clone(), vp.clone(),
                                        pid_t, vld_t)
    # The control: the plain version also writing row `valid` of each
    # tail page must differ from the kernel's pages.
    bad = kw.write_kv_pages_prefill_plain(knew, vnew, kp.clone(),
                                          vp.clone(), pid_t, vld_t + 1)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        fail("K2 write_kv_pages_prefill differs from its plain version")
    if torch.equal(a[0], bad[0]) or torch.equal(a[1], bad[1]):
        fail("K2: the control (row valid written) equals the kernel's "
             "pages")
    if fp16:
        # fp16 pages: bf16's path byte for byte (16-byte vectors).
        f16 = [t.to(torch.float16) for t in (knew, vnew, kp, vp)]
        a = kw.write_kv_pages_prefill(f16[0], f16[1], f16[2].clone(),
                                      f16[3].clone(), pid_t, sblk, vld_t)
        b = kw.write_kv_pages_prefill_plain(f16[0], f16[1], f16[2].clone(),
                                            f16[3].clone(), pid_t, vld_t)
        bad = kw.write_kv_pages_prefill_plain(
            f16[0], f16[1], f16[2].clone(), f16[3].clone(), pid_t,
            vld_t + 1)
        torch.cuda.synchronize()
        if not (_pages_equal(torch, a[0], b[0]) and
                _pages_equal(torch, a[1], b[1])):
            fail("K2 write_kv_pages_prefill on fp16 pages differs from its "
                 "plain version")
        if _pages_equal(torch, a[0], bad[0]):
            fail("K2 on fp16 pages: the control (row valid written) equals "
                 "the kernel's pages")
        del f16, a, b, bad
    cells, rows = c["cells"], c["rows"]
    block_rows, threads = kw.prefill_write_plan(page_size, hd * 2)
    log(f"K2 write_kv_pages_prefill vs plain (row width {hd}): exact "
        f"({cells} cells, {rows} rows, tail pages and skipped cells; blocks "
        f"of {block_rows} rows, {threads} threads) on bf16"
        + (" and fp16" if fp16 else "") + " pages; the control (row valid "
        "written) differs")
    if not timed:
        check_slot_writers(torch, kw, slot_arms(torch, gen),
                           slot_pages(torch, gen), 4096 * 32)
        return None, None
    # Library yardstick: index_copy_ of the valid rows into their slots.
    slots = c["slots"]
    src_k, src_v = knew[c["live"]], vnew[c["live"]]
    k_flat, v_flat = kp.view(-1, hd), vp.view(-1, hd)
    k2 = dict(
        ms=timer(lambda: kw.write_kv_pages_prefill(
            knew, vnew, kp, vp, pid_t, sblk, vld_t)),
        plain_ms=timer(lambda: kw.write_kv_pages_prefill_plain(
            knew, vnew, kp, vp, pid_t, vld_t)),
        library_ms=timer(lambda: (k_flat.index_copy_(0, slots, src_k),
                                  v_flat.index_copy_(0, slots, src_v))))
    k2["bound_ms"], k2["bound_by"] = bound(k2_bound_bytes(c), 0)

    return k2, check_and_time_slot_writers(torch, kw, timer, gen, profiled,
                                           fp16)


def slot_arms(torch, gen, num_pages: int = 4096, page_size: int = 32,
              fp16: bool = False):
    """K3 / K4's timed arms at the main path's shapes, 8 kv heads of 128,
    32-token pages in a pool of `num_pages`: (name, distinct_pages, knew,
    vnew, page dtype, slots int32 on the card; padding slots num_slots):
    K3 at the sliding-window run's decode step (2 rows, each into its own
    page) and at a 64-row decode round; K4 at phase 4's unaligned round
    (two 12-token prompts padded to 16 rows: 24 live slots of 32), at
    `k2_problem`'s round with its 2728 live rows as slots, and at the
    same round's 8192 padded rows (the route of an 8-bit prompt round)
    on bf16, int8 and fp8 e5m2 pages. The rows are bf16 (the model's);
    with `fp16` the arms of fp16 rows follow: K3's two, and the 8-bit
    prompt round into fp16, int8 and fp8 pages."""
    hd = HKV * HEAD_DIM
    num_slots = num_pages * page_size

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    c = k2_problem(torch, gen, num_pages, page_size)
    padded = torch.full((c["knew"].shape[0],), num_slots, dtype=torch.int32,
                        device="cuda")
    padded[c["live"]] = c["slots"].to(torch.int32)
    unaligned = torch.full((32,), num_slots, dtype=torch.int32,
                           device="cuda")
    unaligned[:12] = torch.arange(12, dtype=torch.int32) + 5 * page_size
    unaligned[16:28] = torch.arange(12, dtype=torch.int32) + 9 * page_size
    wide = torch.randperm(num_pages, generator=gen, device="cuda")[:64] * \
        page_size + torch.randint(page_size, (64,), generator=gen,
                                  device="cuda")
    arms = [
        ("K3 bf16, 2 rows", True, randn(2, hd), randn(2, hd),
         torch.bfloat16, torch.tensor([7 * page_size + 3,
                                       11 * page_size + 30],
                                      dtype=torch.int32, device="cuda")),
        ("K3 bf16, B 64", True, randn(64, hd), randn(64, hd),
         torch.bfloat16, wide.to(torch.int32)),
        ("K4 bf16, 32 slots, 24 live", False, randn(32, hd), randn(32, hd),
         torch.bfloat16, unaligned),
        ("K4 bf16, 2728 rows", False, c["knew"][c["live"]].contiguous(),
         c["vnew"][c["live"]].contiguous(), torch.bfloat16,
         c["slots"].to(torch.int32))]
    for kind, page_dtype in (("bf16", torch.bfloat16), ("int8", torch.int8),
                             ("fp8", torch.float8_e5m2)):
        arms.append((f"K4 {kind}, 8192 rows, 2728 live", False, c["knew"],
                     c["vnew"], page_dtype, padded))
    if fp16:
        # The same shapes from fp16 rows (the float16 model's): K3's two,
        # K4's 8-bit prompt round into fp16, int8 and fp8 pages.
        f16 = torch.float16
        arms += [
            ("K3 fp16, 2 rows", True, arms[0][2].to(f16),
             arms[0][3].to(f16), f16, arms[0][5]),
            ("K3 fp16, B 64", True, arms[1][2].to(f16), arms[1][3].to(f16),
             f16, arms[1][5])]
        for kind, page_dtype in (("fp16", f16), ("int8", torch.int8),
                                 ("fp8", torch.float8_e5m2)):
            arms.append((f"K4 fp16 rows, {kind} pages, 8192 rows, 2728 "
                         "live", False, c["knew"].to(f16),
                         c["vnew"].to(f16), page_dtype, padded))
    return arms


def slot_pages(torch, gen, num_pages: int = 4096, page_size: int = 32):
    """K and V pages of `slot_arms`' pool by page dtype: bf16 N(0, 1),
    its fp16 values and its int8 (scale KV_SCALE) and fp8 e5m2 codes."""
    from aphrodite_tpu_torch.ops.kv_quant import quantize_kv
    shape = (num_pages, page_size, HKV * HEAD_DIM)
    bf = [torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2)]
    return {dt: [quantize_kv(p, dt, KV_SCALE) for p in bf]
            for dt in (torch.bfloat16, torch.float16, torch.int8,
                       torch.float8_e5m2)}


def device_launches(torch, fn) -> int:
    """Device kernels (and copies or fills) one call of `fn` runs, by
    torch.profiler after one call unprofiled (host and device activity:
    with the device's alone a run was seen to miss the kernel). The
    most of at least three profiled calls, and of up to eight while
    every trace so far is empty: a trace was seen to hold no kernel for
    a call that ran one (three in a row once on an NVIDIA H100); a
    trace drops events, never adds them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for i in range(8):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(ev.count for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CUDA))
        if i >= 2 and max(counts) > 0:
            break
    return max(counts)


def wrapper_launches(kw, fn) -> int:
    """Launches one call of `fn` counts on the slot writer's counters (the
    wrapper's own count: what `device_launches` reads from a trace, less
    any other device work the call might do)."""
    counters = (kw.WRITE_KV_PAGES_LAUNCHES, kw.WRITE_KV_PAGES_DECODE_LAUNCHES)
    before = sum(c.count for c in counters)
    fn()
    return sum(c.count for c in counters) - before


def time_slot_arm(torch, kw, timer, arm, pages, num_slots: int,
                  profiled: bool = True):
    """One `slot_arms` arm: the wrapper (the parent's whole chain on 8-bit
    pages in an older tree), its plain version, the library call
    (`index_copy_` of the live rows, K and V; on 8-bit pages no PyTorch
    call quantizes and scatters, so None, and `index_copy_` of the codes
    as `floor_ms`), device launches a call, and the bound: the live rows
    read (source dtype) and written (page dtype) once, K and V, and every
    slot read, over 3.35 TB/s, against a division a value (8-bit pages)
    over 67 TFLOP/s of f32."""
    from aphrodite_tpu_torch.ops.kv_quant import quantize_kv
    name, distinct, kn, vn, page_dtype, slots = arm
    kp, vp = pages[page_dtype]
    hd = kn.shape[1]
    live = (slots >= 0) & (slots < num_slots)
    idx = slots[live].long()
    n_live = int(live.sum())
    k_flat, v_flat = (p.view(torch.uint8).view(-1, hd)
                      if p.element_size() == 1 else p.view(-1, hd)
                      for p in (kp, vp))
    rows = [x[live] for x in (kn, vn)]
    if page_dtype != kn.dtype:
        rows = [quantize_kv(r, page_dtype, KV_SCALE).view(torch.uint8)
                for r in rows]

    def call():
        kw.write_kv_pages(kn, vn, kp, vp, slots, distinct_pages=distinct,
                          kv_scale=KV_SCALE)
    copy_ms = timer(lambda: (k_flat.index_copy_(0, idx, rows[0]),
                             v_flat.index_copy_(0, idx, rows[1])))
    quant = page_dtype != kn.dtype
    t = dict(ms=timer(call),
             plain_ms=timer(lambda: kw.write_kv_pages_plain(
                 kn, vn, kp, vp, slots, KV_SCALE)),
             library_ms=None if quant else copy_ms,
             floor_ms=copy_ms if quant else None,
             launches_per_call=device_launches(torch, call) if profiled
             else wrapper_launches(kw, call),
             tokens=kn.shape[0], live=n_live)
    nbytes = 2 * n_live * hd * (kn.element_size() + kp.element_size()) + \
        4 * kn.shape[0]
    t["bound_ms"], t["bound_by"] = bound(nbytes, 2 * n_live * hd if quant
                                         else 0, F32_FLOPS_PER_S)
    return name, t


@contextlib.contextmanager
def slot_order(kw, first):
    """Pin K3 / K4's slot-read order through its plan's threshold:
    `first` True reads the slots first at every token count, False
    beside the data, None keeps the plan's choice."""
    saved = kw.SLOT_FIRST_MIN_TOKENS
    if first is not None:
        kw.SLOT_FIRST_MIN_TOKENS = 0 if first else 1 << 62
    try:
        yield
    finally:
        kw.SLOT_FIRST_MIN_TOKENS = saved


def edge_rows(torch, src_dtype, hd: int, n: int = 48):
    """n rows of the 8-bit write rules' edge values, each exact in bf16:
    int8 ties at S = 0.25 (x / S = k + 1/2, k in [-128, 127]) and values
    that clamp at +-127; every midpoint of two neighbouring finite fp8
    e5m2 values and of the largest and +inf (61440), values past it,
    +-inf and NaN; all of them negated too, repeated to fill a row and
    shifted one place a row. fp16 rows (the twin): the same list but
    the values past fp16's range, plus fp16's own edges around e5m2's
    overflow (57376, 60000, 61408, 61472, 65504), each exact in fp16."""
    e5m2 = torch.arange(0, 0x7C, dtype=torch.uint8).view(
        torch.float8_e5m2).float()
    if src_dtype == torch.float16:
        clamp, past = [], [57376.0, 60000.0, 61408.0, 61472.0, 65504.0]
    else:
        clamp, past = [2.0 ** 30], [65536.0, 2.0 ** 20]
    vals = torch.cat([
        torch.arange(-128, 128).float() * 0.25 + 0.125,
        torch.tensor([31.875, 32.0, 40.0] + clamp), e5m2,
        (e5m2[:-1] + e5m2[1:]) / 2,
        torch.tensor([61440.0] + past + [float("inf"), float("nan")])])
    vals = torch.cat([vals, -vals]).repeat(-(-hd // (2 * len(vals))) + 1)
    rows = torch.stack([vals[r:r + hd] for r in range(n)])
    return rows.to("cuda", src_dtype).contiguous()


def check_slot_writers(torch, kw, arms, pages, num_slots: int):
    """K3 / K4 exact against the plain version: every timed arm, in the
    plan's slot-read order and in both pinned; every (rows, pages) dtype
    pair the kernel takes on shared pages with padding slots of every
    kind; the 8-bit rules' edges (int8 ties and clamps at S = 0.25, fp8
    e5m2 midpoints, overflow and NaN) from bf16 and f32 rows. Then the
    controls, which must miss: the plain version at kv_scale x 1.01 on
    int8 pages, and with every live slot moved one row on bf16 pages."""
    from aphrodite_tpu_torch.ops.kv_quant import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(11)

    def same(a, b):
        return _pages_equal(torch, a[0], b[0]) and \
            _pages_equal(torch, a[1], b[1])

    def check(what, kn, vn, kp, vp, slots, scale=KV_SCALE, orders=(None,),
              distinct=False):
        want = kw.write_kv_pages_plain(kn, vn, kp.clone(), vp.clone(), slots,
                                       scale)
        for first in orders:
            with slot_order(kw, first):
                got = kw.write_kv_pages(kn, vn, kp.clone(), vp.clone(),
                                        slots, distinct_pages=distinct,
                                        kv_scale=scale)
            torch.cuda.synchronize()
            if not same(got, want):
                fail(f"K3/K4 write_kv_pages differs from its plain version: "
                     f"{what}, slots read first {first}")
        return got

    for name, distinct, kn, vn, page_dtype, slots in arms:
        check(name, kn, vn, *pages[page_dtype], slots,
              orders=(None, False, True), distinct=distinct)
    hd = HKV * HEAD_DIM
    base = torch.randn(64, 32, hd, generator=gen, device="cuda")
    slots = torch.randperm(64 * 32, generator=gen, device="cuda")[:96].to(
        torch.int32)
    slots[::5] = 64 * 32                    # padding lanes
    slots[1::7] = 64 * 32 + 9
    slots[2::11] = -1
    for (src_dtype, page_dtype) in kw.SLOT_KINDS:
        kn, vn = (torch.randn(96, hd, generator=gen, device="cuda").mul_(
            3).to(src_dtype) for _ in range(2))
        kp = quantize_kv(base, page_dtype, KV_SCALE)
        check(f"{src_dtype} rows into {page_dtype} pages", kn, vn, kp,
              kp.flip(0).contiguous(), slots, orders=(None, False, True))
        if page_dtype in (torch.int8, torch.float8_e5m2):
            edges = edge_rows(torch, src_dtype, hd)
            check(f"edge values, {src_dtype} rows into {page_dtype} pages",
                  edges, edges.flip(0).contiguous(), kp, kp.clone(),
                  slots[:48], scale=0.25, orders=(False, True))
    log("K3/K4 write_kv_pages vs plain: exact (every timed arm in both "
        "slot-read orders; bf16, fp16 and f32 rows into pages of their "
        "dtype, int8 and fp8 pages, shared pages, padding slots; int8 ties "
        "and clamps at S 0.25, fp8 midpoints, overflow and NaN, fp16's "
        "edges around e5m2's overflow)")
    kn = torch.randn(96, hd, generator=gen, device="cuda").to(torch.bfloat16)
    kp = quantize_kv(base, torch.int8, KV_SCALE)
    got = kw.write_kv_pages(kn, kn, kp.clone(), kp.clone(), slots,
                            kv_scale=KV_SCALE)
    bad = kw.write_kv_pages_plain(kn, kn, kp.clone(), kp.clone(), slots,
                                  KV_SCALE * 1.01)
    kb = base.to(torch.bfloat16)
    got_b = kw.write_kv_pages(kn, kn, kb.clone(), kb.clone(), slots)
    moved = torch.where((slots >= 0) & (slots < 64 * 32),
                        (slots + 1) % (64 * 32), slots)
    bad_b = kw.write_kv_pages_plain(kn, kn, kb.clone(), kb.clone(), moved)
    torch.cuda.synchronize()
    if same(got, bad) or same(got_b, bad_b):
        fail("K3/K4: a control (kv_scale x 1.01 on int8 pages, slots "
             "moved one row on bf16 pages) equals the kernel's pages")
    log("K3/K4 controls (kv_scale x 1.01 on int8 pages, slots moved one "
        "row on bf16 pages) differ")


def check_fused_write_edges(torch, pa, kw):
    """K1's (work list) and K5's fused write at the 8-bit rules' edges
    (`edge_rows` of the activation dtype as the new K and V, S = 0.25 on
    int8 pages; under fp16 activations fp16 pages too): the pages equal
    the slot writer's plain version writing the same rows at each
    sequence's position ctx - 1 (a sequence at ctx 0 writes nothing)."""
    from aphrodite_tpu_torch.ops.kv_quant import dequant_scale
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    page_size, pps, batch = 32, 64, len(ctxs)
    ppc = pa.choose_pages_per_chunk(pps, page_size, batch)
    work = pa.build_decode_work_list([-(-c // page_size) for c in ctxs], ppc)
    rows = edge_rows(torch, act_dtype(torch), HKV * HEAD_DIM, batch)
    vrows = rows.flip(0).contiguous()
    for page_dtype in (torch.int8, torch.float8_e5m2) + (
            (torch.float16,) if ACT == "float16" else ()):
        scale = dequant_scale(page_dtype, 0.25)
        for name, items in (("K1", work), ("K5", None)):
            q, kp, vp, tb, ctx, _, _, _ = decode_problem(
                torch, ctxs, page_size, pps, seed=5, page_dtype=page_dtype)
            pos = (ctx.long() - 1).clamp(min=0)
            slots = tb.long().gather(1, (pos // page_size)[:, None])[:, 0] \
                * page_size + pos % page_size
            slots = torch.where(ctx > 0, slots, kp.shape[0] * page_size).to(
                torch.int32)
            want = kw.write_kv_pages_plain(rows, vrows, kp.clone(),
                                           vp.clone(), slots, scale)
            pa.paged_decode_attention(
                q, kp, vp, tb, ctx, None, rows.view(batch, HKV, HEAD_DIM),
                vrows.view(batch, HKV, HEAD_DIM), work_items=items,
                scale=HEAD_DIM ** -0.5, kv_scale=scale, pages_per_chunk=ppc)
            torch.cuda.synchronize()
            if not (_pages_equal(torch, kp, want[0]) and
                    _pages_equal(torch, vp, want[1])):
                fail(f"{name} fused write on {page_dtype} pages"
                     f"{act_label()} differs from the slot writer's plain "
                     "version at the edge values")
    log(f"K1/K5 fused write{act_label()} at the 8-bit edges (int8 ties and "
        "clamps at S 0.25, fp8 midpoints, overflow and NaN) equals the "
        "slot writer's plain version on int8 and fp8 pages"
        + (" and, bit for bit, on fp16 pages" if ACT == "float16" else ""))


def check_and_time_slot_writers(torch, kw, timer, gen,
                                profiled: bool = True, fp16: bool = False):
    """K3 / K4: `check_slot_writers` on `slot_arms` (with `fp16`, its
    arms of fp16 rows too), then each arm timed with `time_slot_arm` and
    held to one launch a call: device launches in a torch.profiler
    trace, or with `profiled` False the wrapper's launch counter.
    Returns each arm's times by name."""
    pages = slot_pages(torch, gen)
    arms = slot_arms(torch, gen, fp16=fp16)
    num_slots = 4096 * 32
    check_slot_writers(torch, kw, arms, pages, num_slots)
    sms = kw.build.sm_count("cuda")
    timed = {}
    for arm in arms:
        name, t = time_slot_arm(torch, kw, timer, arm, pages, num_slots,
                                profiled)
        timed[name] = t
        rows, threads, first = kw.slot_write_plan(
            arm[2].shape[0], arm[2].shape[1] * arm[2].element_size(), sms)
        lib = (f"index_copy_ {t['library_ms']:.4f} ms" if t["library_ms"]
               is not None else f"no library call (index_copy_ of the "
               f"codes {t['floor_ms']:.4f} ms)")
        log(f"{name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, {lib}, bound {t['bound_ms']:.6f} ms ({t['bound_by']}); "
            f"{t['launches_per_call']} "
            f"{'device' if profiled else 'wrapper'} launch(es) a call; plan "
            f"{rows} rows, {threads} threads, slots read "
            f"{'first' if first else 'beside the data'}")
        if t["launches_per_call"] != 1:
            fail(f"{name}: write_kv_pages ran {t['launches_per_call']} "
                 f"{'device' if profiled else 'wrapper'} launches, not 1")
    return timed


# ------------------------------------------ full-width model check --

def check_model_against_plain(torch, dtype=None):
    """A 2-layer Llama at Mistral-7B width in `dtype` (bf16 by default;
    fp16 on fp16 pages), weights U(-0.05, 0.05) so attention shapes the
    output: prompt (page-aligned -> K2) and 3 decode steps (K1 fused)
    through the kernels vs through the plain versions; logits within
    2e-2 of max |logit|."""
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)

    cfg = config_from_dict(dict(MISTRAL_7B, num_hidden_layers=2))
    dtype = dtype or torch.bfloat16
    model = LlamaForCausalLM(cfg, dtype=dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = model.init_params(dev)
    for bucket in params.values():
        for t in bucket.values():
            t.uniform_(-0.05, 0.05, generator=gen)
    for key, bucket in params.items():
        if key.endswith("layernorm") or key == "model.norm":
            bucket["weight"].fill_(1.0)
    compare_with_plain(torch, model, params,
                       "full-width 2-layer model" + (
                           " in fp16" if dtype == torch.float16 else ""),
                       page_dtype=dtype)


def kv_row_widths(model):
    """Each layer's KV page row width (Hkv x head_dim), from its
    attention layer (`self_attn`, GPT-J's `attn`, NeoX's `attention`)."""
    widths = []
    for layer in model.layers:
        block = next(getattr(layer, n) for n in ("self_attn", "attention",
                                                 "attn")
                     if hasattr(layer, n))
        widths.append(block.attn.num_kv_heads * block.attn.head_size)
    return widths


def compare_with_plain(torch, model, params, label: str,
                       rel_tol: float = 2e-2, w8a8_rows: bool = False,
                       controls=None, moe_margin=None,
                       param_controls=None, model_controls=None,
                       prompt_len: int = 64, gptq_control=None,
                       page_dtype=None) -> float:
    """`model` over `params` (its few layers, each with pages of its own
    row width), a prompt (page-aligned -> K2)
    and 3 decode steps (K1 fused) through the kernels vs through their
    plain versions (attention, writers, the GGUF matmuls and K12, K16,
    K17); logits within `rel_tol` of max |logit|. In the kernel run every
    quantized matmul is also held to its plain version on the same
    activations (phase 8's tolerance; K16 on f32 x within 1e-4 of max
    |plain|). `controls` ({what: {matmul name: wrong plain fn}}): each
    held plain path with that matmul made wrong must miss `rel_tol`.
    With `w8a8_rows` the plain K15 takes the int8 rows K9
    gave the kernel run (call by call), so that a code flipped by an
    upstream bf16 sum-order difference does not count against the
    kernels; the plain path on its own rows is logged beside it, with the
    share of codes that flipped. Then three controls, each the held
    plain path with one GGUF matmul made wrong (K15's scale rows shifted
    by one group, K14's d16 read per 32 rows, K13's d shifted by one
    group), must each miss `rel_tol`, or the comparison could not see
    such a fault. With `moe_margin` (a probability) every plain run
    routes each MoE layer's tokens to the experts the kernel run picked,
    call by call (a pick that flips at a near tie between the runs would
    swap a token's FFN wholesale, which says nothing of the kernels); the
    share of the plain run's own (token, slot) picks in the kernel run's
    set is logged, and every token whose k-th and (k+1)-th probabilities
    (the plain run's) lie more than `moe_margin` apart must pick the
    kernel run's experts. `param_controls` ({what: params}): the held
    plain path over those parameters must miss `rel_tol`;
    `model_controls` ({what: context manager factory}): the held plain
    path run inside that context (which changes the model) must miss it
    too. `prompt_len` (a multiple of 32, at most 125) sets the prompt's
    rows. `gptq_control` ((what, wrong plain fn)): in the kernel run every
    GPTQ matmul's output must also miss phase 8's tolerance against that
    wrong plain version on the same activations. `page_dtype` (default
    bf16) is the KV pages' (fp16 for a float16 model). Returns the
    largest held relative error."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                     SequenceGroupMetadata)
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    from aphrodite_tpu_torch.modeling.layers import attention, fused_moe
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm

    cfg = model.config
    dev = torch.device("cuda")

    class _Cfg:
        def get_vocab_size(self):
            return cfg.vocab_size

        def get_sliding_window(self):
            return None
    page_size, num_pages = 32, 16
    plain_versions = {
        (attention, "write_kv_pages"):
            lambda k, v, kp, vp, s, **_: kw.write_kv_pages_plain(
                k, v, kp, vp, s),
        (attention, "write_kv_pages_prefill"):
            lambda k, v, kp, vp, pid, sb, vld:
            kw.write_kv_pages_prefill_plain(k, v, kp, vp, pid, vld),
        (attention, "paged_decode_attention"):
            pa.paged_decode_attention_plain,
        (qmm, "gptq_matmul"): lambda x, qw, qz, sc, *, bits, group_size:
            qmm.gptq_matmul_plain(x, qw, qz, sc, bits=bits,
                                  group_size=group_size),
        (qmm, "gguf_q8_matmul"): qmm.gguf_q8_matmul_plain,
        (qmm, "gguf_i8g_matmul"): qmm.gguf_i8g_matmul_plain,
        (qmm, "gguf_w8a8_matmul"): qmm.gguf_w8a8_matmul_plain,
        **{(qmm, name): getattr(qmm, name + "_plain")
           for name in LATE_MATMULS},
    }

    per_call = {}
    k9_rows = []            # (x8, xs) of every K15 call of the kernel run

    def checked(name):
        kernel, plain_fn = getattr(qmm, name), getattr(qmm, name + "_plain")

        def fn(*args):
            got = kernel(*args)
            what = f"{label}: {name} on the model's activations"
            check = check_close_f32 if got.dtype == torch.float32 \
                else check_close
            err = check(torch, got, plain_fn(*args), what)
            per_call[name] = max(per_call.get(name, 0.0), err)
            if name == "gguf_w8a8_matmul":
                k9_rows.append(qmm.quantize_activations_int8(args[0]))
            return got
        return fn
    kernel_checks = {(qmm, name): checked(name)
                     for name in GGUF_MATMULS + LATE_MATMULS}

    gptq_kernel = qmm.gptq_matmul
    gptq_missed = []        # whether each call's control missed

    def gptq_checked(x, qw, qz, sc, *, bits, group_size):
        got = gptq_kernel(x, qw, qz, sc, bits=bits, group_size=group_size)
        err = check_close(torch, got, qmm.gptq_matmul_plain(
            x, qw, qz, sc, bits=bits, group_size=group_size),
            f"{label}: gptq_matmul on the model's activations")
        per_call["gptq_matmul"] = max(per_call.get("gptq_matmul", 0.0), err)
        if gptq_control is not None:
            bad = gptq_control[1](x, qw, qz, sc, bits=bits,
                                  group_size=group_size).float()
            gptq_missed.append(bool(((got.float() - bad).abs() >
                                     ATOL + RTOL * bad.abs()).any()))
        return got
    kernel_checks[(qmm, "gptq_matmul")] = gptq_checked
    route = fused_moe.route
    kernel_picks = []       # (probs, expert ids) of the kernel run's calls
    pick_stats = []         # the plain run's, a call at a time

    def recording(x, gate, k, renorm):
        probs, vals, idx = route(x, gate, k, renorm)
        kernel_picks.append((probs, idx))
        return probs, vals, idx
    if moe_margin is not None:
        kernel_checks[(fused_moe, "route")] = recording

    def on_kernel_picks(versions, stats=None):
        """`versions` with the router taking the kernel run's picks, call
        by call (a fresh pass for every run); `stats` collects, a call
        at a time, the plain picks in the kernel run's sets, all picks,
        tokens past the margin, those among them that disagree, and the
        largest probability difference between the runs."""
        if moe_margin is None:
            return versions
        calls = iter(kernel_picks)

        def fn(x, gate, k, renorm):
            probs, _, own = route(x, gate, k, renorm)
            kprobs, idx = next(calls)
            if kprobs.shape != probs.shape:
                fail(f"{label}: router call order differs between the runs")
            agree = (own[:, :, None] == idx[:, None, :]).any(-1)
            top = probs.topk(k + 1, dim=-1).values
            held = (top[:, k - 1] - top[:, k]) > moe_margin
            if stats is not None:
                stats.append((int(agree.sum()), agree.numel(),
                              int(held.sum()),
                              int((held & ~agree.all(-1)).sum()),
                              float((probs - kprobs).abs().max())))
            vals = probs.gather(1, idx)
            if renorm:
                vals = vals / vals.sum(dim=-1, keepdim=True)
            return probs, vals, idx
        return {**versions, (fused_moe, "route"): fn}

    flips = []              # (codes that differ, codes, largest difference)

    def on_k9_rows(scales=lambda s128: s128):
        """The plain versions, with K15 on the kernel run's int8 rows,
        call by call (a fresh pass over them for every run)."""
        rows = iter(k9_rows)

        def fn(x, qs8, s128):
            x8, xs = next(rows)
            if x8.shape != x.shape:
                fail(f"{label}: K15 call order differs between the runs")
            own8, _ = qmm.quantize_activations_int8_plain(x)
            diff = (own8.int() - x8.int()).abs()
            flips.append((int((diff > 0).sum()), diff.numel(),
                          int(diff.max())))
            return qmm.gguf_w8a8_launch_plain(x8, xs, qs8, scales(s128),
                                              x.dtype)
        return {**plain_versions, (qmm, "gguf_w8a8_matmul"): fn}

    def run(versions, params=params):
        runner = ModelRunner(model, params, _Cfg(), None, page_size,
                             num_pages * page_size, dev)
        kv = [(torch.zeros(num_pages, page_size, width,
                           dtype=page_dtype or torch.bfloat16, device=dev),
               torch.zeros(num_pages, page_size, width,
                           dtype=page_dtype or torch.bfloat16, device=dev))
              for width in kv_row_widths(model)]
        saved = {}
        for (mod, name), fn in versions.items():
            saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, fn)
        try:
            tokens = [(i * 37 + 11) % 32000 for i in range(prompt_len)]
            table = [3, 9, 4, 12]
            logits_all = []
            for step in range(4):
                data = SequenceData(list(tokens) if step == 0
                                    else list(tokens[:-1]))
                if step:
                    data.append_token_id(tokens[-1], 0.0)
                md = SequenceGroupMetadata(
                    "0", step == 0, {0: data},
                    SamplingParams(temperature=0.0), {0: table}, {0: {}})
                inputs, _ = (runner._prepare_prompt([md]) if step == 0
                             else runner._prepare_decode([md]))
                meta = inputs["metadata"].replace(is_prompt=step == 0)
                logits, kv = runner._logits(
                    params, inputs["input_ids"], inputs["positions"], kv,
                    meta, inputs["sel"])
                row = logits[0].float()
                logits_all.append(row)
                tokens.append(int(row.argmax()))
            torch.cuda.synchronize()
            return logits_all, tokens
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)

    def rel_errs(got, want):
        return [((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]

    got, got_tokens = run(kernel_checks)
    if gptq_control is not None:
        log(f"{label}: control, {gptq_control[0]}: missed phase 8's "
            f"tolerance on {sum(gptq_missed)} of {len(gptq_missed)} GPTQ "
            "matmuls of the kernel run (each must)")
        if not gptq_missed or not all(gptq_missed):
            fail(f"{label}: the GPTQ matmul check cannot see "
                 f"{gptq_control[0]}")
    want, want_tokens = run(on_kernel_picks(plain_versions, pick_stats))
    rels = rel_errs(got, want)
    held = "plain path" + (" on the kernel run's expert picks"
                           if moe_margin is not None else "")
    if moe_margin is not None:
        agree, picks, tokens, wrong, dp = (
            sum(st[0] for st in pick_stats), sum(st[1] for st in pick_stats),
            sum(st[2] for st in pick_stats), sum(st[3] for st in pick_stats),
            max(st[4] for st in pick_stats))
        log(f"{label}: router picks over {len(pick_stats)} MoE calls: "
            f"{agree} of {picks} (token, slot) picks of the plain run in the "
            f"kernel run's sets ({agree / picks:.4f}); {tokens} tokens with "
            f"a k-th to (k+1)-th margin over {moe_margin}, {wrong} of them "
            f"picking otherwise; largest router probability difference "
            f"between the runs {dp:.2e}")
        if wrong:
            fail(f"{label}: {wrong} tokens with a top-k margin over "
                 f"{moe_margin} picked other experts than the kernel run")
    if w8a8_rows:
        own_rels = rels
        log(f"{label}: plain path on its own int8 rows (a reading, not "
            f"held): logits rel err per step {own_rels}")
        want, want_tokens = run(on_k9_rows())
        rels = rel_errs(got, want)
        n_diff, n_all, top = (sum(f[0] for f in flips),
                              sum(f[1] for f in flips),
                              max(f[2] for f in flips))
        log(f"{label}: K9 on the plain path's activations vs on the kernel "
            f"path's: {n_diff} of {n_all} int8 codes differ "
            f"({n_diff / n_all:.2e}; at most by {top}) over "
            f"{len(flips)} K15 calls")
        held = "plain path on the kernel run's int8 rows"
    log(f"{label}, prompt + 3 decode steps: kernel path vs {held}: "
        f"logits rel err per step {rels} (tolerance {rel_tol}; max |logit| "
        f"{max(w.abs().max().item() for w in want):.3f}); tokens "
        f"{got_tokens[prompt_len:]} vs {want_tokens[prompt_len:]}"
        + (f"; each quantized matmul vs its plain version on the same "
           f"activations, max err {per_call}" if per_call else ""))
    if not all(torch.isfinite(g).all() for g in got) or max(rels) > rel_tol:
        fail(f"{label}: kernel path vs {held}: logits differ by "
             f"{max(rels)} of max |logit|")
    held_versions = {what: {**plain_versions,
                            **{(qmm, n): f for n, f in wrong.items()}}
                     for what, wrong in (controls or {}).items()}
    for what, wrong_params in (param_controls or {}).items():
        c_rels = rel_errs(got, run(on_kernel_picks(plain_versions),
                                   wrong_params)[0])
        log(f"{label}: control, {what}: logits rel err per step "
            f"{c_rels} (must exceed {rel_tol})")
        if max(c_rels) <= rel_tol:
            fail(f"{label}: the comparison cannot see {what}: "
                 f"{max(c_rels)} <= {rel_tol}")
    for what, changed in (model_controls or {}).items():
        with changed():
            c_rels = rel_errs(got, run(plain_versions)[0])
        log(f"{label}: control, {what}: logits rel err per step "
            f"{c_rels} (must exceed {rel_tol})")
        if max(c_rels) <= rel_tol:
            fail(f"{label}: the comparison cannot see {what}: "
                 f"{max(c_rels)} <= {rel_tol}")
    if w8a8_rows:
        held_versions.update({
            "K15 with its scale rows shifted by one group":
                on_k9_rows(lambda s128: torch.roll(s128, 1, 0)),
            "K14 reading d16 per 32 rows": {
                **on_k9_rows(), (qmm, "gguf_i8g_matmul"): lambda x, qs, d16:
                qmm.gguf_q8_matmul_plain(x, qs, d16[:qs.shape[0] // 32])},
            "K13 with its d rows shifted by one group": {
                **on_k9_rows(), (qmm, "gguf_q8_matmul"): lambda x, qs, d:
                qmm.gguf_q8_matmul_plain(x, qs, torch.roll(d, 1, 0))},
        })
    for what, versions in held_versions.items():
        c_rels = rel_errs(got, run(versions)[0])
        log(f"{label}: control, {what}: logits rel err per step "
            f"{c_rels} (must exceed {rel_tol})")
        if max(c_rels) <= rel_tol:
            fail(f"{label}: the comparison cannot see {what}: "
                 f"{max(c_rels)} <= {rel_tol}")
    return max(rels)


# ------------------------------------------------ GPTQ and AWQ kernels --

GPTQ_PROJ = (("qkv", 4096, 6144), ("o", 4096, 4096),
             ("gate_up", 4096, 28672), ("down", 14336, 4096))
GPTQ_GS = 128
# K7's m (phases 8 and 10): 1-64 rows, every n-tile count of its mma.
K7_MS = (1, 3, 8, 17, 33, 64)


def quant_weights(torch, K, N, bits, seed, awq: bool, gs=GPTQ_GS):
    """Random packed codes and zeros, scales in [0.002, 0.022), in groups
    of gs rows: GPTQ qweight [K / pack, N], AWQ qweight [K, N / 8]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pack = 32 // bits

    def bits32(*shape):
        return torch.empty(*shape, dtype=torch.int32, device="cuda").random_(
            -2 ** 31, 2 ** 31, generator=gen)
    scales = (torch.rand(K // gs, N, generator=gen, device="cuda") *
              0.02 + 0.002).to(torch.bfloat16)
    qweight = bits32(K, N // 8) if awq else bits32(K // pack, N)
    return qweight, bits32(K // gs, N // pack), scales


def weight_bytes(K, N, bits, gs=GPTQ_GS):
    """Packed codes, zeros and bf16 scales of one GPTQ or AWQ layer."""
    G = K // gs
    return K * N * bits // 8 + G * N * bits // 8 + G * N * 2


def check_close(torch, got, want, what):
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all() or \
            bool((err > ATOL + RTOL * want.float().abs()).any()):
        fail(f"{what}: max err {err.max().item()} (tolerance {ATOL} + "
             f"{RTOL}|plain|)")
    return err.max().item()


def a8_gemm_controls(qmm, got, x, qw, qz, sc, awq: bool,
                     label: str) -> str:
    """K8's or K11's output `got` must miss the tolerance against wrong
    plain versions: the zero rows shifted by one group and, for K11,
    AWQ's column interleave undone (the words read as 8 columns in
    natural order). Returns the log text."""
    gs = GPTQ_GS
    if awq:
        bad = {"zeros shifted by one group": qmm.awq_matmul_a8_plain(
            x, qw, qz.roll(1, 0), sc, group_size=gs),
               "AWQ interleave undone": qmm._a8(
            x, qmm.unpack_cols(qw, 4) -
            qmm.unpack_cols(qz, 4).repeat_interleave(gs, dim=0), sc, gs)}
    else:
        bad = {"zeros shifted by one group": qmm.gptq_matmul_a8_plain(
            x, qw, qz.roll(1, 0), sc, bits=4, group_size=gs)}
    text = ""
    for what, b in bad.items():
        c_err = (got.float() - b.float()).abs()
        if not bool((c_err > ATOL + RTOL * b.float().abs()).any()):
            fail(f"{label}: the control ({what}) is within tolerance of "
                 "the kernel")
        text += f"; control ({what}) max err {c_err.max().item():.4f}"
    return text


def check_and_time_quant(torch, qmm, timer, awq: bool):
    """The quantized matmul kernels of one layout against their plain
    versions at the Mistral-7B projection shapes, each timed: GPTQ K6-K9
    (4- and 8-bit codes for the a16 kernels), or with `awq` K10, K11 and
    K7's AWQ layout. Returns {kernel: {...}} with ms, plain_ms,
    library_ms and bound_ms summed over the four projections of one layer
    at the main path's shapes (m 8 for K7, the e2e decode batch; m 4096
    for the tiled kernels and K9, a prompt round), 4-bit codes, and
    max_abs_err over every case."""
    big, big_a8 = ("k10", "k11") if awq else ("k6", "k8")
    names = ("k7", "k7a8", big, big_a8) + (() if awq else ("k9",))
    out = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_bytes_ms=0.0,
                   bound_ops_ms=0.0, max_abs_err=0.0) for k in names}
    for k in ("k7a8", big_a8) + (() if awq else ("k9",)):
        out[k]["library_ms"] = None
    main_m = dict.fromkeys(("k7", "k7a8"), 8)
    main_m.update(dict.fromkeys((big, big_a8, "k9"), 4096))
    fmt = "AWQ" if awq else "GPTQ"
    if awq:
        a16, a16_plain = qmm.awq_matmul, qmm.awq_matmul_plain
        a8, a8_plain = qmm.awq_matmul_a8, qmm.awq_matmul_a8_plain
    else:
        a16, a16_plain = qmm.gptq_matmul, qmm.gptq_matmul_plain
        a8, a8_plain = qmm.gptq_matmul_a8, qmm.gptq_matmul_a8_plain
    for seed, (proj, K, N) in enumerate(GPTQ_PROJ):
        gen = torch.Generator(device="cuda").manual_seed(
            (200 if awq else 100) + seed)
        x_all = torch.randn(4096, K, generator=gen, device="cuda").to(
            torch.bfloat16)
        for bits in (4,) if awq else (4, 8):
            qw, qz, sc = quant_weights(torch, K, N, bits, seed * 10 + bits,
                                       awq)
            kw = dict(group_size=GPTQ_GS) if awq else \
                dict(bits=bits, group_size=GPTQ_GS)
            w16 = (qmm.dequantize_awq_plain if awq else
                   qmm.dequantize_plain)(qw, qz, sc, dtype=torch.bfloat16,
                                         **kw)
            wbytes = weight_bytes(K, N, bits)
            cases = [("k7", m) for m in K7_MS] + \
                [(big, m) for m in (72, 128, 512, 4096)]
            if bits == 4:
                cases += [("k7a8", m) for m in K7_MS] + \
                    [(big_a8, m) for m in (72, 128, 512, 4096)]
            for kern, m in cases:
                x = x_all[:m]
                stream = kern in ("k7", "k7a8")
                what = ""
                if kern in ("k7", big):
                    def run():
                        return a16(x, qw, qz, sc, stream=stream, **kw)

                    def plain():
                        return a16_plain(x, qw, qz, sc, **kw)
                    got = run()
                    nbytes = m * K * 2 + wbytes + m * N * 2
                    ops, rate = 2 * m * K * N, BF16_FLOPS_PER_S
                else:
                    def wrapper():
                        return a8(x, qw, qz, sc, stream=stream, **kw)
                    got = wrapper()
                    x8, xs = qmm.quantize_activations_int8(x)
                    counter = getattr(qmm, f"{fmt}_MATMUL"
                                      f"{'_STREAM' if stream else ''}"
                                      "_A8_LAUNCHES")

                    # Timed: the matmul kernel alone on K9's rows (K9 is
                    # timed below on its own). Checked: the wrapper the
                    # engine calls, and the timed launch equals it.
                    def run():
                        return qmm._launch(
                            True, x8, xs, qw, qz, sc, bits=4, gs=GPTQ_GS,
                            stream=stream, counter=counter,
                            what=f"{fmt} matmul a8", awq=awq)
                    if not torch.equal(run(), got):
                        fail(f"{fmt} {kern} {proj} m={m}: the matmul "
                             "launched on K9's rows differs from the a8 "
                             "wrapper's output")

                    def plain():
                        return a8_plain(x, qw, qz, sc, **kw)
                    nbytes = m * K + m * 4 + wbytes + m * N * 2
                    ops, rate = 2 * m * K * N, INT8_OPS_PER_S
                    what = (f"; checked: {a8.__name__} (K9 + matmul, "
                            f"{timer(wrapper):.4f} ms) vs plain; timed as "
                            "kernel: the matmul alone on K9's rows")
                    if kern == big_a8:
                        what += a8_gemm_controls(
                            qmm, got, x, qw, qz, sc, awq,
                            f"{fmt} {kern} {proj} m={m}")
                err = check_close(torch, got, plain(),
                                  f"{fmt} {kern} {proj} m={m} bits={bits}")
                if stream:
                    rows, splits = qmm.stream_plan(
                        m, K, N, GPTQ_GS, qmm.build.sm_count("cuda"), bits,
                        1 if kern == "k7a8" else 2)
                    what += (f"; plan: {rows}-row blocks of "
                             f"{qmm.STREAM_BLOCK_N} columns, {splits} "
                             "split(s)")
                    if m == 8:
                        # The control: zero rows shifted by one group.
                        bad = (a8_plain if kern == "k7a8" else a16_plain)(
                            x, qw, qz.roll(1, 0), sc, **kw)
                        c_err = (got.float() - bad.float()).abs()
                        if not bool((c_err > ATOL + RTOL *
                                     bad.float().abs()).any()):
                            fail(f"{fmt} {kern} {proj} m={m} bits={bits}: "
                                 "the control (zeros shifted by one group) "
                                 "is within tolerance of the kernel")
                        what += (f"; control (zeros shifted by one group) "
                                 f"max err {c_err.max().item():.4f}")
                if kern == big_a8:
                    splits, per = qmm.a8_gemm_plan(
                        m, K, N, GPTQ_GS, qmm.build.sm_count("cuda"))
                    what += (f"; plan: 128 x 128 tiles, {splits} split(s) "
                             f"of {per} chunks of 128 rows")
                if kern == big:
                    # K6 / K10's plan, and the wrapper's host time per
                    # call: 50 calls enqueued back to back.
                    splits, per = qmm.gemm_plan(m, K, N, GPTQ_GS,
                                                qmm.build.sm_count("cuda"))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(50):
                        run()
                    host_us = (time.perf_counter() - t0) / 50 * 1e6
                    what = (f"; plan: 128 x 256 tiles, {splits} split(s) of "
                            f"{per} groups; wrapper {host_us:.1f} us of "
                            "host time per call")
                torch.cuda.synchronize()
                ms, plain_ms = timer(run), timer(plain)
                lib = timer(lambda: torch.matmul(x, w16)) \
                    if kern in ("k7", big) else None
                b_ms, b_by = bound(nbytes, ops, rate)
                log(f"{fmt} {kern} {proj} (K {K}, N {N}) m={m} bits={bits}: "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                    + (f"{lib:.4f} ms (bf16 matmul, {16 // bits}x the "
                       "weight bytes)" if lib is not None else "none")
                    + f", bound {b_ms:.4f} ms ({b_by}), max err {err}"
                    + what)
                rec = out[kern]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if bits == 4 and m == main_m[kern]:
                    rec["ms"] += ms
                    rec["plain_ms"] += plain_ms
                    rec["bound_bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                    rec["bound_ops_ms"] += ops / rate * 1e3
                    if lib is not None:
                        rec["library_ms"] += lib
            del w16
        for m in () if awq else (1, 8, 64, 512, 4096):
            x = x_all[:m]
            # Also on a contiguous view 2 bytes past a 16-byte boundary
            # (the element path) and on rows of an odd K (K - 3: the
            # element path too).
            buf = torch.empty(m * K + 1, dtype=x.dtype, device="cuda")
            view = buf[1:].view(m, K)
            view.copy_(x)
            odd = x[:, :K - 3].contiguous()
            for what, xv in (("", x), (" (unaligned view)", view),
                             (f" (K {K - 3})", odd)):
                got8, gots = qmm.quantize_activations_int8(xv)
                want8, wants = qmm.quantize_activations_int8_plain(xv)
                torch.cuda.synchronize()
                if not (torch.equal(got8, want8) and
                        torch.equal(gots, wants)):
                    fail(f"K9 quantize_activations_int8 {proj} m={m}{what} "
                         "differs from its plain version")
            del buf, view, odd
            ms = timer(lambda: qmm.quantize_activations_int8(x))
            plain_ms = timer(
                lambda: qmm.quantize_activations_int8_plain(x))
            nbytes = m * K * 2 + m * K + m * 4
            log(f"k9 input of {proj} m={m} K={K} (plan "
                f"{qmm.quant8_plan(m, K, qmm.build.sm_count('cuda'))}: "
                "threads, runs a thread): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes), exact, "
                "also on an unaligned view and an odd K")
            if m == main_m["k9"]:
                rec = out["k9"]
                rec["ms"] += ms
                rec["plain_ms"] += plain_ms
                rec["bound_bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        del x_all, qw, qz, sc
        torch.cuda.empty_cache()
    for rec in out.values():
        t_b, t_o = rec.pop("bound_bytes_ms"), rec.pop("bound_ops_ms")
        rec["bound_ms"], rec["bound_by"] = (t_b, "bytes") if t_b >= t_o \
            else (t_o, "operations")
    log(f"{fmt} kernels vs plain: all cases within tolerance"
        + ("" if awq else ", K9 exact")
        + "; per layer (4 projections) at the main path's m: "
        + json.dumps(out))
    return out


# ------------------------------------------------------- GGUF kernels --

# (name in the kernel JSON, JSON key, group rows G, Pallas body line)
GGUF_KERNELS = {"k13": ("gguf_q8_matmul", 32, 1210),
                "k14": ("gguf_i8g_matmul", 16, 1476),
                "k15": ("gguf_w8a8_matmul", 128, 1551)}
# 16 and 17: K13's and K17's routes meet there (Q8_STREAM_M_MAX,
# INT8_STREAM_M_MAX);
# 32 and 33: quant_stream_kernel's row blocks (K12, K16) change there.
GGUF_MS = (1, 8, 16, 17, 32, 33, 64, 512, 4096)

# The m > 64 kernels (K12-K15) also at the m their split plans serve
# (decode batches above 64, short prompt rounds).
GEMM_MS = (65, 72, 128, 256)
# m at which the m > 64 kernels' layer times are logged for PERF.md.
GEMM_LOG_MS = (72, 128, 512, 4096)


def gguf_weights(torch, key, K, N, seed):
    """int8 codes and bf16 scale rows quantized from an N(0, 0.02) weight
    as the at-rest forms hold real ones: symmetric absmax per G-row group,
    codes in [-127, 127] (K14 Q6_K-shaped: amax / 31, codes in [-32,
    31])."""
    G = GGUF_KERNELS[key][1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(K // G, G, N, generator=gen, device="cuda") * 0.02
    top = 31 if key == "k14" else 127
    s = w.abs().amax(dim=1) / top
    q = torch.clamp(torch.round(w / s[:, None]), -top - (key == "k14"),
                    top).to(torch.int8)
    return q.view(K, N), s.to(torch.bfloat16)


def gguf_layer_bytes(key, K, N):
    """int8 codes and bf16 scale rows of one GGUF projection."""
    return K * N + K // GGUF_KERNELS[key][1] * N * 2


def check_and_time_gguf(torch, qmm, timer):
    """K13, K14 and K15 against their plain versions at the Mistral-7B
    projection shapes and m 1-4096 and GEMM_MS, through the wrappers the
    engine calls; K15 timed alone on K9's rows (checked equal to the
    wrapper's output). At m > 64 they run their warpgroup-MMA kernels,
    and each has a control that must miss the tolerance (K15's and K13's
    scale rows shifted by one group, K14's d16 read per 32 rows). Plain
    and library times at m 8 (decode) and 4096 (a prompt
    round). Returns {key: {...}} summed over one layer's four projections
    at m 8, and the same at m 4096 under "<key>@4096"."""
    out = {}
    for key in GGUF_KERNELS:
        for m in (8, 4096):
            out[key if m == 8 else f"{key}@4096"] = dict(
                ms=0.0, plain_ms=0.0, library_ms=0.0, bound_bytes_ms=0.0,
                bound_ops_ms=0.0, max_abs_err=0.0)
    layer_ms = {key: dict.fromkeys(GEMM_LOG_MS, 0.0) for key in GGUF_KERNELS}
    sms = qmm.build.sm_count("cuda")
    for seed, (proj, K, N) in enumerate(GPTQ_PROJ):
        gen = torch.Generator(device="cuda").manual_seed(300 + seed)
        x_all = torch.randn(4096, K, generator=gen, device="cuda").to(
            torch.bfloat16)
        for key, (name, G, _) in GGUF_KERNELS.items():
            qs, sc = gguf_weights(torch, key, K, N, seed * 10 + G)
            wrapper = getattr(qmm, name)
            plain_fn = getattr(qmm, name + "_plain")
            w16 = (qs.float() * sc.float().repeat_interleave(G, dim=0)).to(
                torch.bfloat16)
            for m in sorted(GGUF_MS + GEMM_MS):
                x = x_all[:m]
                got = wrapper(x, qs, sc)
                plain = plain_fn(x, qs, sc)
                err = check_close(torch, got, plain,
                                  f"{name} {proj} m={m}")
                plan = ""
                # quant_stream_kernel takes up to Q8_STREAM_M_MAX /
                # I8G_STREAM_M_MAX / K15_STREAM_M_MAX rows (K15 over
                # 128-row groups, on int8 x); the warpgroup-MMA kernels
                # the rest.
                skinny = {"k13": qmm.Q8_STREAM_M_MAX,
                          "k14": qmm.I8G_STREAM_M_MAX,
                          "k15": qmm.K15_STREAM_M_MAX}[key]
                if m <= skinny:
                    unit, xb = (128, 1) if key == "k15" else (32, 2)
                    block_m, splits = qmm.stream_plan(m, K, N, unit, sms, 8,
                                                      xb)
                    plan = (f"; stream plan: {block_m}-row blocks, {splits} "
                            f"split(s) of {-(-(K // unit) // splits) * unit}"
                            " rows")
                if key == "k14" and m == 8:
                    # quant_stream_kernel's d16 rows: reading them per 32
                    # rows must miss.
                    plan += stream_control_missed(
                        torch, got, qmm.gguf_q8_matmul_plain(
                            x, qs, sc[:K // 32]), f"{name} {proj} m={m}",
                        "d16 read per 32 rows")
                if key == "k13":
                    # Both routes: d shifted by one group, and d read per
                    # 16 rows (K14's map), must miss.
                    what = f"{name} {proj} m={m}"
                    bad = plain_fn(x, qs, torch.roll(sc, 1, 0))
                    plan += control_missed(
                        torch, qmm, got, bad, what, "d shifted by one group",
                        m, K, N, unit=64, block_n=256, sms=sms) \
                        if m > skinny else stream_control_missed(
                            torch, got, bad, what, "d shifted by one group")
                    plan += stream_control_missed(
                        torch, got, qmm.gguf_i8g_matmul_plain(
                            x, qs, torch.cat([sc, sc])), what,
                        "d read per 16 rows")
                if key == "k15":
                    # Both routes: the scale rows shifted by one group
                    # must miss.
                    what = f"{name} {proj} m={m}"
                    bad = plain_fn(x, qs, torch.roll(sc, 1, 0))
                    plan += control_missed(
                        torch, qmm, got, bad, what,
                        "scale rows shifted by one group", m, K, N,
                        unit=128, block_n=128, sms=sms) \
                        if m > skinny else stream_control_missed(
                            torch, got, bad, what,
                            "scale rows shifted by one group")
                if m > skinny and key == "k14":
                    # The control: a wrong plain version must miss.
                    plan = control_missed(
                        torch, qmm, got,
                        qmm.gguf_q8_matmul_plain(x, qs, sc[:K // 32]),
                        f"{name} {proj} m={m}", "d16 read per 32 rows", m,
                        K, N, unit=64, block_n=256, sms=sms)
                if key == "k15":
                    x8, xs = qmm.quantize_activations_int8(x)

                    def run():
                        return qmm.gguf_w8a8_launch(x8, xs, qs, sc)
                    if not torch.equal(run(), got):
                        fail(f"{name} {proj} m={m}: K15 on K9's rows "
                             "differs from the wrapper's output")
                    nbytes = m * K + m * 4 + gguf_layer_bytes(key, K, N) \
                        + m * N * 2
                    rate = INT8_OPS_PER_S
                else:
                    def run():
                        return wrapper(x, qs, sc)
                    nbytes = m * K * 2 + gguf_layer_bytes(key, K, N) + \
                        m * N * 2
                    rate = BF16_FLOPS_PER_S
                ops = 2 * m * K * N
                torch.cuda.synchronize()
                ms = timer(run)
                if m in GEMM_LOG_MS and key in layer_ms:
                    layer_ms[key][m] += ms
                b_ms, b_by = bound(nbytes, ops, rate)
                line = (f"{name} {proj} (K {K}, N {N}) m={m}: kernel "
                        f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max err "
                        f"{err}{plan}")
                if m in (8, 4096):
                    plain_ms = timer(lambda: plain_fn(x, qs, sc))
                    lib = timer(lambda: torch.matmul(x, w16))
                    line += (f", plain {plain_ms:.4f} ms, library "
                             f"{lib:.4f} ms (bf16 matmul over the weight "
                             "dequantized beforehand)")
                    rec = out[key if m == 8 else f"{key}@4096"]
                    rec["ms"] += ms
                    rec["plain_ms"] += plain_ms
                    rec["library_ms"] += lib
                    rec["bound_bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                    rec["bound_ops_ms"] += ops / rate * 1e3
                if key == "k15":
                    line += (f"; wrapper (K9 + K15) "
                             f"{timer(lambda: wrapper(x, qs, sc)):.4f} ms")
                log(line)
                for k in (key, f"{key}@4096"):
                    out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err)
            if key == "k15":
                check_k15_routes(torch, qmm, x_all, qs, sc, proj)
            del qs, sc, w16
        del x_all
        torch.cuda.empty_cache()
    for rec in out.values():
        t_b, t_o = rec.pop("bound_bytes_ms"), rec.pop("bound_ops_ms")
        rec["bound_ms"], rec["bound_by"] = (t_b, "bytes") if t_b >= t_o \
            else (t_o, "operations")
    log("GGUF kernels vs plain: all cases within tolerance, every control "
        "missed it; per layer (4 projections) at m 8 and 4096: "
        + json.dumps(out))
    log("K13 / K14 / K15 m > 64 kernels (K15 alone on K9's rows), ms per "
        "layer (4 projections) by m: " + json.dumps(layer_ms))
    return out


# K15's rows around its routes' meeting point and block sizes, each
# checked on both routes pinned.
K15_PIN_MS = (1, 8, 13, 16, 17, 32, 33, 64)


def check_k15_routes(torch, qmm, x_all, qs, sc, proj: str) -> None:
    """K15 alone on K9's rows with each route pinned (`stream=True`:
    quant_stream_kernel's a8 arm; False: w8a8_gemm_kernel) at
    `K15_PIN_MS`, against `gguf_w8a8_launch_plain` on the same rows
    within the tolerance, and the plain version with the scale rows
    shifted by one group must miss it."""
    notes = []
    for m in K15_PIN_MS:
        x8, xs = qmm.quantize_activations_int8(x_all[:m])
        want = qmm.gguf_w8a8_launch_plain(x8, xs, qs, sc)
        bad = qmm.gguf_w8a8_launch_plain(x8, xs, qs, torch.roll(sc, 1, 0))
        for route, pin in (("stream", True), ("gemm", False)):
            what = f"gguf_w8a8_launch {proj} m={m} on the {route} route"
            got = qmm.gguf_w8a8_launch(x8, xs, qs, sc, stream=pin)
            err = check_close(torch, got, want, what)
            stream_control_missed(torch, got, bad, what,
                                  "scale rows shifted by one group")
            notes.append(f"{m}/{route} {err:.4f}")
    log(f"K15 {proj}, both routes pinned vs plain (max err), every "
        "control missed: " + ", ".join(notes))


def stream_control_missed(torch, got, bad, what: str, control: str) -> str:
    """Fails unless the control `bad` (a wrong plain version) misses the
    tolerance against the kernel's output `got`; returns the log's note
    of the control's error."""
    c_err = (got.float() - bad.float()).abs()
    if not bool((c_err > ATOL + RTOL * bad.float().abs()).any()):
        fail(f"{what}: the control ({control}) is within tolerance of the "
             "kernel")
    return f"; control ({control}) max err {c_err.max().item():.4f}"


def control_missed(torch, qmm, got, bad, what: str, control: str, m: int,
                   K: int, N: int, unit: int, block_n: int, sms: int) -> str:
    """`stream_control_missed` against a warpgroup-MMA kernel's output
    `got`; the note adds the kernel's split plan."""
    note = stream_control_missed(torch, got, bad, what, control)
    splits, per = qmm.gemm_plan(m, K, N, unit, sms, block_n=block_n)
    return (f"; plan: 128 x {block_n} tiles, {splits} split(s) of {per} x "
            f"{unit} rows{note}")


# ------------------------------------------- K12, K16 and K17 kernels --

# JSON key -> (kernel JSON name, Pallas body line)
LATE_KERNELS = {"k12": ("gguf_q4k_matmul", 1117),
                "k16": ("squeezellm_matmul", 1630),
                "k16f32": ("squeezellm_matmul_f32", 1630),
                "k17": ("int8_matmul", 1706)}
LATE_MATMULS = ("gguf_q4k_matmul", "squeezellm_matmul", "int8_matmul")
# The counters of the m > 64 kernels of K12, K16 (bf16 and f32 x) and
# K17.
LATE_GEMMS = {"k12": "gguf_q4k_gemm", "k16": "squeezellm_gemm",
              "k16f32": "squeezellm_f32_gemm", "k17": "int8_gemm"}
F32_RTOL = 1e-4                   # K16 on f32 x: of max |plain|


def pack_rows4(torch, codes):
    """int codes [K, N] in [0, 16) -> int32 [K / 8, N], 8 along K (row k
    in word k / 8 at shift 4 * (k % 8))."""
    K, N = codes.shape
    c8 = codes.to(torch.int64).view(K // 8, 8, N)
    word = torch.zeros(K // 8, N, dtype=torch.int64, device=codes.device)
    for p in range(8):
        word |= c8[:, p, :] << (4 * p)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def quip_lut(torch, N, wscale=0.05, dtype=None):
    """QuIP#'s 4-bit table: the 12 E8P values (odd quarters in
    [-11/4, 11/4]) times Wscale, the same for every output column."""
    from aphrodite_tpu_torch.modeling.layers.quantization.quip import (
        E8P_VALUES4)
    lut16 = torch.zeros(16, dtype=torch.float32, device="cuda")
    lut16[:12] = torch.tensor(E8P_VALUES4, dtype=torch.float32,
                              device="cuda") / 4.0
    return (lut16 * wscale)[None, :].expand(N, 16).contiguous().to(
        dtype or torch.float32)


def late_weights(torch, qmm, key, K, N, seed):
    """(wrapper args after x, the weight dequantized beforehand for the
    library call): K12 random Q4_K codes with dl in [1e-3, 4e-3) and ml
    = 8 dl; K16 random codes and an N(0, 0.02) bf16 codebook; K16-f32
    QuIP#'s codes (uniform over the 12 E8P values) and f32 table times
    Wscale 0.05; K17 codes in [-127, 127] and f32 scales in [1e-4, 5e-4)
    (the library weight folds them in)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    if key == "k17":
        q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(N, generator=gen, device="cuda") * 4e-4 + 1e-4
        return (q, s), (q.float() * s).to(bf16)
    if key == "k16f32":
        codes = torch.randint(0, 12, (K, N), generator=gen, device="cuda")
        qw, lut = pack_rows4(torch, codes), quip_lut(torch, N)
        return (qw, lut), qmm.squeezellm_dequantize_plain(qw, lut,
                                                          torch.float32)
    qw = torch.randint(-2 ** 31, 2 ** 31, (K // 8, N), generator=gen,
                       device="cuda", dtype=torch.int64).to(torch.int32)
    if key == "k12":
        dl = torch.rand(K // 32, N, generator=gen, device="cuda") * 3e-3 \
            + 1e-3
        dl, ml = dl.to(bf16), (dl * 8).to(bf16)
        return (qw, dl, ml), qmm.gguf_q4k_dequantize_plain(qw, dl, ml, bf16)
    lut = (torch.randn(N, 16, generator=gen, device="cuda") * 0.02).to(bf16)
    return (qw, lut), qmm.squeezellm_dequantize_plain(qw, lut, bf16)


def late_layer_bytes(key, K, N):
    """Codes and scales of one projection: K12 4-bit codes with bf16 dl
    and ml rows per 32 input rows, K16 4-bit codes with a 16-entry table
    per column (bf16, or f32 for QuIP#), K17 int8 codes with f32 column
    scales."""
    return {"k12": K * N // 2 + 2 * (K // 32) * N * 2,
            "k16": K * N // 2 + N * 16 * 2,
            "k16f32": K * N // 2 + N * 16 * 4,
            "k17": K * N + N * 4}[key]


def check_close_f32(torch, got, want, what):
    """K16 on f32 x: within F32_RTOL of max |plain|."""
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or \
            err > F32_RTOL * want.abs().max().item():
        fail(f"{what}: max err {err} (tolerance {F32_RTOL} max|plain| = "
             f"{F32_RTOL * want.abs().max().item()})")
    return err


def control_missed_f32(torch, qmm, got, bad, what: str, control: str,
                       m: int, K: int, N: int, sms: int) -> str:
    """K16 on f32 x at m > 64: fails unless the control `bad` misses
    F32_RTOL of max |bad| against the kernel's output `got`; returns the
    log's note of the plan (128 x 128 tiles) and the control's error."""
    c_err = (got - bad).abs().max().item()
    if c_err <= F32_RTOL * bad.abs().max().item():
        fail(f"{what}: the control ({control}) is within tolerance of the "
             "kernel")
    splits, per = qmm.gemm_plan(m, K, N, 64, sms,
                                block_n=qmm.X32_BLOCK_N)
    return (f"; plan: 128 x {qmm.X32_BLOCK_N} tiles, {splits} split(s) of "
            f"{per} x 64 rows; control max err {c_err:.6f}")


def late_control(torch, qmm, key, x, args):
    """The wrong plain version the m > 64 kernels of K12, K16 (bf16 and
    f32 x) and K17 must miss, and what it is: K12's dl and ml shifted by
    one group, K16's codebook columns rolled by one (on f32 x QuIP#'s
    table entries rolled by one code), K17's column scales rolled by
    one."""
    if key == "k12":
        qw, dl, ml = args
        return (qmm.gguf_q4k_matmul_plain(x, qw, torch.roll(dl, 1, 0),
                                          torch.roll(ml, 1, 0)),
                "dl and ml shifted by one group")
    if key == "k16":
        qw, lut = args
        return (qmm.squeezellm_matmul_plain(x, qw, torch.roll(lut, 1, 0)),
                "codebook columns rolled by one")
    if key == "k16f32":
        # QuIP#'s table is the same in every column: roll its codes.
        qw, lut = args
        return (qmm.squeezellm_matmul_plain(x, qw, torch.roll(lut, 1, 1)),
                "table entries rolled by one code")
    w, s = args
    return (qmm.int8_matmul_plain(x, w, torch.roll(s, 1, 0)),
            "column scales rolled by one")


def check_and_time_late(torch, qmm, timer):
    """K12, K16 (bf16 x, and f32 x on QuIP#'s table) and K17 against
    their plain versions at the Mistral-7B projection shapes and m
    1-4096 and GEMM_MS, where their m > 64 kernels split, with a control
    at every m > 64 (`late_control`), through the wrappers the engine
    calls, each call counted once on its kernel's counter (the skinny
    one at m <= 64, LATE_GEMMS above); each timed like phase
    8, its plain version and the library call (torch.matmul over the
    weight dequantized beforehand: bf16, f32 for K16-f32, K17's scales
    folded in) at m 8 and 4096. Bound: the bytes over 3.35 TB/s, or the
    operations over 989 TFLOP/s (bf16; K16-f32 does three bf16 products
    per term). Returns {key: {...}} summed over one layer's four
    projections at m 8, and at m 4096 under "<key>@4096"."""
    out = {}
    for key in LATE_KERNELS:
        for m in (8, 4096):
            out[key if m == 8 else f"{key}@4096"] = dict(
                ms=0.0, plain_ms=0.0, library_ms=0.0, bound_bytes_ms=0.0,
                bound_ops_ms=0.0, max_abs_err=0.0)
    layer_ms = {key: dict.fromkeys(GEMM_LOG_MS, 0.0) for key in LATE_GEMMS}
    sms = qmm.build.sm_count("cuda")
    counters = qmm.build.COUNTERS
    for seed, (proj, K, N) in enumerate(GPTQ_PROJ):
        gen = torch.Generator(device="cuda").manual_seed(500 + seed)
        x_all = torch.randn(4096, K, generator=gen, device="cuda")
        for key, (name, _) in LATE_KERNELS.items():
            f32 = key == "k16f32"
            wrapper = getattr(qmm, name.replace("_f32", ""))
            plain_fn = getattr(qmm, name.replace("_f32", "") + "_plain")
            args, w_lib = late_weights(torch, qmm, key, K, N, seed * 10 +
                                       len(key))
            xb = x_all if f32 else x_all.to(torch.bfloat16)
            # K17's quant_gemm_kernel takes every m over
            # INT8_STREAM_M_MAX, the others' every m over 64.
            gemm_from = qmm.INT8_STREAM_M_MAX if key == "k17" else 64
            for m in sorted(GGUF_MS + GEMM_MS):
                x = xb[:m]
                counter = counters[LATE_GEMMS[key] if m > gemm_from
                                   else name]
                before = counter.count
                got = wrapper(x, *args)
                if counter.count != before + 1:
                    fail(f"{name} {proj} m={m}: counter {counter.name} "
                         f"moved by {counter.count - before}, not 1")
                plain = plain_fn(x, *args)
                what = f"{name} {proj} m={m}"
                err = check_close_f32(torch, got, plain, what) if f32 \
                    else check_close(torch, got, plain, what)
                plan = ""
                if key == "k17" and m <= gemm_from:
                    # quant_stream_kernel<8, kInt8>: its plan, and the
                    # control must miss there too.
                    block_m, splits = qmm.stream_plan(m, K, N, 32, sms, 8, 2)
                    bad, control = late_control(torch, qmm, key, x, args)
                    plan = (f"; stream plan: {block_m}-row blocks, {splits} "
                            f"split(s) of {-(-(K // 32) // splits) * 32} rows"
                            + stream_control_missed(torch, got, bad, what,
                                                    control))
                if m > gemm_from:
                    bad, control = late_control(torch, qmm, key, x, args)
                    if f32:
                        plan = control_missed_f32(torch, qmm, got, bad, what,
                                                  control, m, K, N, sms)
                    else:
                        plan = control_missed(torch, qmm, got, bad, what,
                                              control, m, K, N, unit=64,
                                              block_n=256, sms=sms)
                size = 4 if f32 else 2
                nbytes = m * K * size + late_layer_bytes(key, K, N) + \
                    m * N * size
                ops = 2 * m * K * N * (3 if f32 else 1)
                torch.cuda.synchronize()
                ms = timer(lambda: wrapper(x, *args))
                if m in GEMM_LOG_MS:
                    layer_ms[key][m] += ms
                b_ms, b_by = bound(nbytes, ops)
                line = (f"{name} {proj} (K {K}, N {N}) m={m}: kernel "
                        f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max err "
                        f"{err}{plan}")
                if m in (8, 4096):
                    plain_ms = timer(lambda: plain_fn(x, *args))
                    lib = timer(lambda: torch.matmul(x, w_lib))
                    line += (f", plain {plain_ms:.4f} ms, library "
                             f"{lib:.4f} ms (torch.matmul over the weight "
                             f"dequantized beforehand)")
                    rec = out[key if m == 8 else f"{key}@4096"]
                    rec["ms"] += ms
                    rec["plain_ms"] += plain_ms
                    rec["library_ms"] += lib
                    rec["bound_bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                    rec["bound_ops_ms"] += ops / BF16_FLOPS_PER_S * 1e3
                log(line)
                for k in (key, f"{key}@4096"):
                    out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err)
            del args, w_lib, xb
        del x_all
        torch.cuda.empty_cache()
    for rec in out.values():
        t_b, t_o = rec.pop("bound_bytes_ms"), rec.pop("bound_ops_ms")
        rec["bound_ms"], rec["bound_by"] = (t_b, "bytes") if t_b >= t_o \
            else (t_o, "operations")
    log("K12/K16/K17 vs plain: all cases within tolerance, every control "
        "missed it; per layer (4 projections) at m 8 and 4096: "
        + json.dumps(out))
    log("K12 / K16 (bf16 x) / K16 (f32 x) / K17 m > 64 kernels, ms per "
        "layer (4 projections) by m: " + json.dumps(layer_ms))
    return out


def fill_quant_params(torch, params, quantization, seed):
    """Weights that make a 2-layer model's kernels do real work: dense
    tensors U(-0.05, 0.05), norms 1; K12 random Q4_K codes with dl in
    [1e-3, 4e-3) and ml = 8 dl; K16 random codes with an N(0, 0.02)
    codebook; K17 codes in [-127, 127] with scales in [1e-4, 5e-4);
    QuIP# random Qidxs for 1024 output columns re-encoded by
    `quip_codes4_from_qidxs`, tiled across the width and the columns
    shuffled, SU and SV +-1, Wscale 0.05, the get_hadK factors as
    created."""
    import numpy as np
    from aphrodite_tpu_torch.modeling.layers.quantization.quip import (
        quip_codes4_from_qidxs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rs = np.random.RandomState(seed)
    for key, bucket in params.items():
        if key.endswith("layernorm") or key == "model.norm":
            bucket["weight"].fill_(1.0)
            continue
        if set(bucket) == {"weight"} and bucket["weight"].is_floating_point():
            bucket["weight"].uniform_(-0.05, 0.05, generator=gen)
            continue
        if quantization == "quip":
            q_in, q_out = bucket["qweight"].shape[0] * 8, \
                bucket["qweight"].shape[1]
            qidxs = rs.randint(-2 ** 15, 2 ** 15, (1024, q_in // 8)).astype(
                np.int16)
            qw, lut = quip_codes4_from_qidxs(qidxs)
            # Tiled, then the columns shuffled: a period of 1024 columns
            # would meet the output transform's Hadamard blocks and leave
            # most outputs exactly zero.
            reps = q_out // 1024
            perm = torch.from_numpy(rs.permutation(q_out))
            bucket["qweight"].copy_(torch.from_numpy(qw).repeat(1, reps)[
                :, perm])
            bucket["lookup_table"].copy_(torch.from_numpy(lut).repeat(
                reps, 1)[perm])
            bucket["Wscale"].fill_(0.05)
            for name in ("SU", "SV"):
                bucket[name].copy_(torch.randint(
                    0, 2, bucket[name].shape, generator=gen,
                    device=dev) * 2 - 1)
            continue
        for name, t in bucket.items():
            if name in ("qweight",):
                t.random_(-2 ** 31, 2 ** 31, generator=gen)
            elif name == "dl":
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) *
                        3e-3 + 1e-3)
            elif name == "lookup_table":
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) *
                        0.02)
            elif name == "weight":
                t.random_(-127, 128, generator=gen)
            elif name == "scales":
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) *
                        4e-4 + 1e-4)
        if "ml" in bucket:
            bucket["ml"].copy_(bucket["dl"].float() * 8)


def check_quant_models(torch):
    """Phase 18: 2-layer Llamas at Mistral-7B width in the exact Q4_K
    form (K12), SqueezeLLM (K16), int8 (K17) and QuIP# (K16-f32), weights
    from `fill_quant_params`, through the kernels vs through their plain
    versions (`compare_with_plain`, 2e-2 of max |logit|), each with a
    control that must miss."""
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config_cls)
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    cfg = config_from_dict(dict(MISTRAL_7B, num_hidden_layers=2))
    controls = {
        "gguf": ("K12 with its dl rows shifted by one group",
                 "gguf_q4k_matmul", lambda x, qw, dl, ml:
                 qmm.gguf_q4k_matmul_plain(x, qw, torch.roll(dl, 1, 0),
                                           ml)),
        "squeezellm": ("K16 with its codebook columns rolled by one",
                       "squeezellm_matmul", lambda x, qw, lut:
                       qmm.squeezellm_matmul_plain(x, qw,
                                                   torch.roll(lut, 1, 0))),
        "int8": ("K17 with its column scales rolled by one", "int8_matmul",
                 lambda x, w, s: qmm.int8_matmul_plain(x, w,
                                                       torch.roll(s, 1, 0))),
        "quip": ("K16-f32 with its table entries rolled by one code",
                 "squeezellm_matmul", lambda x, qw, lut:
                 qmm.squeezellm_matmul_plain(x, qw, torch.roll(lut, 1, 1))),
    }
    models = (("gguf", "exact Q4_K (K12)"), ("squeezellm", "SqueezeLLM (K16)"),
              ("int8", "int8 (K17)"), ("quip", "QuIP# (K16-f32)"))
    os.environ["APHRODITE_GGUF_EXACT"] = "1"      # dummy_form -> Q4_K
    try:
        for seed, (quantization, label) in enumerate(models):
            method = get_quantization_config_cls(
                quantization).default().get_linear_method()
            model = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                                     linear_method=method)
            params = model.init_params(torch.device("cuda"))
            t0 = time.perf_counter()
            fill_quant_params(torch, params, quantization, 40 + seed)
            log(f"2-layer {label} model: weights made in "
                f"{time.perf_counter() - t0:.1f} s")
            what, name, wrong = controls[quantization]
            compare_with_plain(torch, model, params,
                               f"2-layer {label} model",
                               controls={what: {name: wrong}})
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("APHRODITE_GGUF_EXACT")


def quant_engine(torch, model: str, label: str, quantization: str = "gguf",
                **kw):
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model, quantization=quantization, dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True, **kw))
    if engine.model_config.quantization != quantization:
        fail(f"{label}: not served with quantization={quantization!r}")
    log(f"{label} engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return engine


def bucket_forms(engine):
    """{projection: sorted param names} of layer 0."""
    return {key.rsplit(".", 1)[-1]: sorted(bucket) for key, bucket in
            engine.executor.params.items()
            if key.startswith("model.layers.0.") and key.endswith("_proj")}


def write_gguf_model(path: str, layers: int = 2) -> float:
    """A Llama `.gguf` at Mistral-7B width with `layers` layers, weights
    N(0, 0.02) from seed 0: F32 norms, F16 embeddings and output, a
    32000-token `tokenizer.ggml.*` vocabulary (as the JAX package's tests
    write one); attn_q/attn_k Q4_0 beside attn_v Q8_0 (a mixed group ->
    K14), attn_output and ffn_down Q8_0 (K13), ffn_gate and ffn_up Q4_0
    (turbo -> K15). Returns the seconds it took."""
    import numpy as np
    from aphrodite_tpu_torch.modeling.gguf import write_gguf
    t0 = time.perf_counter()
    c = MISTRAL_7B
    h, inter, vocab = c["hidden_size"], c["intermediate_size"], \
        c["vocab_size"]
    kv = c["num_key_value_heads"] * HEAD_DIM
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02
    meta = {
        "general.architecture": "llama", "general.alignment": 32,
        "llama.context_length": c["max_position_embeddings"],
        "llama.embedding_length": h, "llama.feed_forward_length": inter,
        "llama.block_count": layers,
        "llama.attention.head_count": c["num_attention_heads"],
        "llama.attention.head_count_kv": c["num_key_value_heads"],
        "llama.attention.layer_norm_rms_epsilon": c["rms_norm_eps"],
        "llama.rope.freq_base": c["rope_theta"],
        "tokenizer.ggml.tokens": [f"<t{i}>" for i in range(vocab)],
        "tokenizer.ggml.scores": [-float(i) for i in range(vocab)],
        "tokenizer.ggml.token_type": [1] * vocab,
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
    }
    tensors = {"token_embd.weight": (w(vocab, h) * 50, "F16"),
               "output.weight": (w(vocab, h), "F16"),
               "output_norm.weight": (np.ones(h, np.float32), "F32")}
    for i in range(layers):
        p = f"blk.{i}"
        tensors.update({
            f"{p}.attn_norm.weight": (np.ones(h, np.float32), "F32"),
            f"{p}.ffn_norm.weight": (np.ones(h, np.float32), "F32"),
            f"{p}.attn_q.weight": (w(h, h), "Q4_0"),
            f"{p}.attn_k.weight": (w(kv, h), "Q4_0"),
            f"{p}.attn_v.weight": (w(kv, h), "Q8_0"),
            f"{p}.attn_output.weight": (w(h, h), "Q8_0"),
            f"{p}.ffn_gate.weight": (w(inter, h), "Q4_0"),
            f"{p}.ffn_up.weight": (w(inter, h), "Q4_0"),
            f"{p}.ffn_down.weight": (w(h, inter), "Q8_0"),
        })
    write_gguf(path, meta, tensors)
    return time.perf_counter() - t0


# ------------------------------------------------------- seeded draws --

def check_seeded_draws(torch, engine, timer):
    """JAX's threefry draws (`modeling/layers/prng.py`) on the card: keys,
    bits and uniforms bit-equal to the same calls on the CPU for 64 rows
    x vocab 32000 of seeded logits, and the tokens drawn equal; the time
    of one draw per row (plain torch ops, as the sampler runs them); then
    one seeded request served alone and inside a batch of 8 gives the
    same tokens."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.modeling.layers import prng
    gen = torch.Generator().manual_seed(5)
    bases = torch.randint(-2 ** 40, 2 ** 40, (64,), generator=gen)
    salt1 = torch.randint(0, 2 ** 31 - 1, (64,), generator=gen)
    salt2 = torch.randint(0, 4, (64,), generator=gen)
    logits = torch.randn(64, 32000, generator=gen) * 3
    keys = prng.row_keys(bases, salt1, salt2)
    keys_d = prng.row_keys(bases.cuda(), salt1.cuda(), salt2.cuda())
    checks = {
        "keys": (keys_d, keys),
        "bits": (prng.random_bits(keys_d, (2, 32000)),
                 prng.random_bits(keys, (2, 32000))),
        "uniforms": (prng.uniform(keys_d, (2, 32000)),
                     prng.uniform(keys, (2, 32000))),
        "tokens": (prng.categorical(keys_d, logits.cuda(), 3),
                   prng.categorical(keys, logits, 3)),
    }
    for name, (dev, cpu) in checks.items():
        if not torch.equal(dev.cpu(), cpu):
            fail(f"threefry {name} on the card differ from the CPU's")
    logits_d = logits.cuda()
    draw_ms = timer(lambda: prng.categorical(prng.row_keys(
        bases.cuda(), salt1.cuda(), salt2.cuda()), logits_d, 1))
    log("threefry draws, 64 rows x vocab 32000: keys, bits, uniforms and "
        "3 tokens per row bit-equal on the card and the CPU; one draw per "
        f"row (keys from host tensors, then categorical) {draw_ms:.4f} ms")

    engine.scheduler_config.multi_step = 1
    seeded = SamplingParams(temperature=0.8, seed=1234, max_tokens=16,
                            ignore_eos=True)
    prompt = [(j * 89 + 7) % 31000 + 100 for j in range(40)]

    def serve(batch: int, tag: str):
        engine.add_request(f"{tag}-seeded", None, seeded,
                           prompt_token_ids=prompt)
        for i in range(batch - 1):
            engine.add_request(f"{tag}-{i}", None, SamplingParams(
                temperature=1.0, max_tokens=16, ignore_eos=True),
                prompt_token_ids=[(j * 31 + i * 7) % 31000 + 100
                                  for j in range(20 + 9 * i)])
        tokens = None
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished and out.request_id == f"{tag}-seeded":
                    tokens = list(out.outputs[0].token_ids)
        return tokens
    alone, batched = serve(1, "alone"), serve(8, "batch")
    if alone is None or alone != batched or len(alone) != 16:
        fail(f"seeded request: alone {alone} vs in a batch of 8 {batched}")
    log(f"seeded request (seed 1234, temperature 0.8): the same 16 tokens "
        f"alone and in a batch of 8: {alone}")


# ---------------------------------------------------------- end to end --

BF16_KERNELS = ("paged_decode_attention", "paged_decode_merge",
                "write_kv_pages_prefill", "write_kv_pages")
W4A8_KERNELS = BF16_KERNELS + ("quantize_activations_int8",
                               "gptq_matmul_a8", "gptq_matmul_stream_a8")
W4A16_KERNELS = BF16_KERNELS + ("gptq_matmul", "gptq_matmul_stream")
AWQ_A8_KERNELS = BF16_KERNELS + ("quantize_activations_int8",
                                 "awq_matmul_a8", "awq_matmul_stream_a8")
AWQ_A16_KERNELS = BF16_KERNELS + ("awq_matmul", "awq_matmul_stream")
GGUF_MATMULS = ("gguf_q8_matmul", "gguf_i8g_matmul", "gguf_w8a8_matmul")
# The counters of K13's, K14's and K15's m > 64 kernels, in that order.
GGUF_GEMMS = ("gguf_q8_gemm", "gguf_i8g_gemm", "gguf_w8a8_gemm")


def check_outputs(outputs, n: int, what: str, vocab: int = 32000) -> None:
    if len(outputs) != n:
        fail(f"{what}: {len(outputs)} of {n} finished")
    for rid, out in outputs.items():
        toks = out.outputs[0].token_ids
        if len(toks) != 32 or not all(0 <= t < vocab for t in toks):
            fail(f"{rid}: bad tokens {toks}")
        lp = out.outputs[0].cumulative_logprob
        if not (lp == lp) or abs(lp) == float("inf"):
            fail(f"{rid}: non-finite cumulative logprob")


def run_engine(torch, engine, multi_step: int, counters, card: str,
               required=BF16_KERNELS, tag: str = "", absent=(),
               tokens=None, per_step=None, vocab: int = 32000):
    """Phase 4's request mix; fails if a kernel of `required` did not
    launch or one of `absent` did (K5 is absent from every run but those
    under APHRODITE_ATTN_RAGGED=0). Fills `tokens` (request id without
    the tag -> token ids) when given. With `per_step` (counter names, a
    launch count n) every engine step must launch those kernels, summed,
    a positive multiple of n times (n = the matmuls per forward pass)."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    engine.scheduler_config.multi_step = multi_step
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)

    def prompt(n, salt):
        return [(i * 131 + salt * 977) % 31000 + 100 for i in range(n)]
    first = [1000, 300, 64, 1000, 300, 64]
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, n in enumerate(first):
        engine.add_request(f"{tag}m{multi_step}-{i}", None, sp,
                           prompt_token_ids=prompt(n, i))
    outputs, steps = {}, 0
    late_added = False
    deltas = []
    def stepped():
        return sum(counters[name].count for name in per_step[0])
    while engine.has_unfinished_requests():
        before = stepped() if per_step else 0
        for out in engine.step():
            if out.finished:
                outputs[out.request_id] = out
        if per_step:
            deltas.append(stepped() - before)
        steps += 1
        if not late_added:
            # Two 12-token prompts one round later: alone in their prompt
            # chunk round, padded to 16 rows under 32-token pages, they
            # take the slot writer (K4).
            for j in range(2):
                engine.add_request(f"{tag}m{multi_step}-late{j}", None, sp,
                                   prompt_token_ids=prompt(12, 10 + j))
            late_added = True
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    check_outputs(outputs, 8, f"{tag}multi_step={multi_step}", vocab)
    for name in required:
        if launches.get(name, 0) <= 0:
            fail(f"{tag}multi_step={multi_step}: kernel {name} never "
                 f"launched on the main path ({launches})")
    for name in tuple(absent) + _k5_absent():
        if launches.get(name, 0):
            fail(f"{tag}multi_step={multi_step}: kernel {name} launched "
                 f"{launches[name]} times where it must not ({launches})")
    if per_step and any(d <= 0 or d % per_step[1] for d in deltas):
        fail(f"{tag}multi_step={multi_step}: {' + '.join(per_step[0])} "
             f"launches per engine step {deltas}, not a positive multiple "
             f"of {per_step[1]} in every step")
    if tokens is not None:
        for rid, out in outputs.items():
            tokens[rid[len(tag):]] = list(out.outputs[0].token_ids)
    new_tokens = 8 * 32
    log(f"e2e {tag}multi_step={multi_step}: 8 requests x 32 tokens, "
        f"{steps} engine steps, {dt:.3f} s, {new_tokens / dt:.1f} generated "
        f"tok/s on {card}, launches {launches}"
        + (f"; {' + '.join(per_step[0])} per step {deltas}" if per_step
           else ""))
    return launches


def _k5_absent():
    """K5 launches only under APHRODITE_ATTN_RAGGED=0."""
    return () if os.environ.get("APHRODITE_ATTN_RAGGED") == "0" else \
        ("paged_decode_attention_tm",)


def run_wide_round(torch, engine, counters, card: str, required, decode,
                   layers: int, tag: str):
    """96 requests with 32-token prompts at multi_step 1: a decode batch
    above 64, so the decode steps take the tiled kernel (`decode`) and
    not the skinny one. Every engine step runs 4 quantized matmuls per
    layer; the 31 decode steps alone launch `decode` 31 * 4 * layers
    times."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    engine.scheduler_config.multi_step = 1
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(96):
        engine.add_request(f"{tag}wide-{i}", None, sp, prompt_token_ids=[
            (j * 53 + i * 101) % 31000 + 100 for j in range(32)])
    outputs, steps = {}, 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outputs[out.request_id] = out
        steps += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    check_outputs(outputs, 96, f"{tag}96-request round")
    for name in required:
        if launches.get(name, 0) <= 0:
            fail(f"{tag}96-request round: kernel {name} never launched "
                 f"({launches})")
    for name in _k5_absent():
        if launches.get(name, 0):
            fail(f"{tag}96-request round: kernel {name} launched "
                 f"{launches[name]} times where it must not")
    if launches.get(decode, 0) < 31 * 4 * layers:
        fail(f"{tag}96-request round: {decode} launched "
             f"{launches.get(decode, 0)} times, fewer than the "
             f"{31 * 4 * layers} of 31 decode steps at batch 96")
    log(f"e2e {tag}96 requests x 32 tokens (32-token prompts): {steps} "
        f"engine steps, {dt:.3f} s, {96 * 32 / dt:.1f} generated tok/s on "
        f"{card}, launches {launches}")
    return launches


_T_START = time.perf_counter()


def log_clocks(label: str) -> None:
    """The card's SM clock, power draw and temperature now (a throttled
    card runs every kernel slower), and the seconds since the script
    started."""
    state = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()
    log(f"card state {label}: {state} (SM clock, max SM clock, power "
        f"draw, temperature); {time.perf_counter() - _T_START:.1f} s into "
        "the run")


def free_engine(torch, label: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label} engine freed: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB still allocated")


def run_sliding_window(torch, counters, card: str):
    """The published Mistral-7B-v0.1 config (4096-token window), bf16,
    dummy weights from seed 0, 32-token pages, max_model_len 8192: a
    4000-token prompt decoded 160 greedy tokens (past the window, so the
    block table wraps and decode writes reuse the window's pages) beside
    a 64-token prompt. Decode takes the slot writer with distinct pages
    (K3) and a read-only K1; the window has no decode bursts."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    model_dir = os.path.join(HERE, "build", "chip_smoke_mistral_v01")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(MISTRAL_7B_V01, f)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=8192, skip_tokenizer_init=True,
        disable_log_stats=True))
    window = engine.model_config.get_sliding_window()
    if window != 4096:
        fail(f"Mistral-7B-v0.1 served with sliding window {window}")
    log(f"sliding-window engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens, "
        f"window {window}")
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lens = {"long": (4000, 160), "short": (64, 160)}
    for rid, (n, new) in lens.items():
        engine.add_request(rid, None, SamplingParams(
            temperature=0.0, max_tokens=new, ignore_eos=True),
            prompt_token_ids=[(i * 131 + n) % 31000 + 100 for i in range(n)])
    outputs, steps = {}, 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outputs[out.request_id] = out
        steps += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    for rid, (n, new) in lens.items():
        toks = outputs[rid].outputs[0].token_ids if rid in outputs else []
        if len(toks) != new or not all(0 <= t < 32000 for t in toks):
            fail(f"sliding window {rid}: bad tokens {toks}")
    for name in ("write_kv_pages_decode", "paged_decode_attention",
                 "write_kv_pages_prefill"):
        if launches.get(name, 0) <= 0:
            fail(f"sliding window: kernel {name} never launched "
                 f"({launches})")
    log(f"e2e sliding window (prompts 4000 and 64, 160 tokens each, the "
        f"long one to position 4160 past the 4096 window): {steps} engine "
        f"steps, {dt:.3f} s, {320 / dt:.1f} generated tok/s on {card}, "
        f"launches {launches}; last tokens of the long request "
        f"{list(outputs['long'].outputs[0].token_ids[-8:])}")
    del engine
    free_engine(torch, "sliding-window")
    return launches


QUANT_KERNEL_NAMES = ("quant_stream_kernel", "split_reduce_kernel",
                      "split_x32_kernel", "quant8_kernel",
                      "quant_gemm_kernel", "w8a8_gemm_kernel")


def profile_decode(torch, engine, tag: str = "",
                   quant_bound_ms: float = 0.0, prompt_len: int = 64,
                   named=(), lora_requests=None,
                   width: str = "Mistral-7B width", scopes=(),
                   counts=(), steps: int = 4):
    """Where a decode step's time goes at the e2e geometry: 8 running
    sequences (prompts of `prompt_len` tokens). `steps` (4) single
    decode steps are timed on the host clock (synchronised), then as
    many more run under torch.profiler, which gives the device's kernel
    time per step, its
    share of the wall time, K1's (with its merge) and the kernels that
    take the most. With `quant_bound_ms` it also reports the quantized
    matmuls' device time per step beside that weight-streaming bound;
    `named` pairs (label, kernel name) report that kernel's device ms
    and launches a step (K9's quant8_kernel, K14's quant_stream_kernel
    where no other decoder runs). `lora_requests` gives row i its
    adapter (a LoRA engine). `scopes` names torch.profiler ranges
    (`record_function`) whose kernels' device ms a step, and span on the
    device timeline, it reports (the ranges' own device rows stay out of
    the kernel totals);
    `counts` pairs (label, counter) whose increase a step over the
    unprofiled steps it reports. Returns (wall ms, device ms) a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    engine.scheduler_config.multi_step = 1
    sp = SamplingParams(temperature=0.0, max_tokens=14, ignore_eos=True)
    for i in range(8):
        engine.add_request(f"{tag}prof-{i}", None, sp, prompt_token_ids=[
            (j * 71 + i * 13) % 31000 + 100 for j in range(prompt_len)],
            lora_request=lora_requests[i] if lora_requests else None)
    # The prompt rounds, then a decode step to warm up.
    produced = {}
    while len(produced) < 8 or min(produced.values()) < 2:
        for out in engine.step():
            produced[out.request_id] = len(out.outputs[0].token_ids)
    before = [c.count for _, c in counts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = [(c.count - b) / steps for (_, c), b in zip(counts, before)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    while engine.has_unfinished_requests():
        engine.step()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.key not in scopes), reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3 / steps
    n_launch = sum(r[2] for r in rows) // steps
    top = "; ".join(f"{k[:48]} x{c // steps}/step {us / 1e3 / steps:.3f} ms"
                    for us, k, c in rows[:8])
    k1_ms = sum(us for us, k, _ in rows if "paged_decode_kernel" in k or
                "paged_decode_merge" in k) / 1e3 / steps
    log(f"{tag}decode step, batch 8 at {width}, {prompt_len}-token "
        f"prompts: wall {wall_ms:.2f} ms/step (unprofiled), device kernels "
        f"{dev_ms:.2f} ms/step (busy share {dev_ms / wall_ms:.3f}), "
        f"{n_launch} kernel launches/step; K1 with its merge {k1_ms:.3f} "
        f"ms/step (share {k1_ms / dev_ms:.3f}); top kernels: {top}")
    for scope in scopes:
        k_ms, span_ms = (v / steps for v in scope_device_ms(prof, scope))
        log(f"{tag}{scope}: kernels {k_ms:.3f} ms/step of device time "
            f"(share {k_ms / dev_ms:.3f}); its span on the device timeline "
            f"{span_ms:.3f} ms/step (share of the wall {span_ms / wall_ms:.3f})")
    for (label, _), n in zip(counts, per_step):
        log(f"{tag}{label}: {n:g} a step")
    for label, kernel in named:
        k_us = sum(us for us, k, _ in rows if kernel in k)
        k_n = sum(c for _, k, c in rows if kernel in k) // steps
        log(f"{tag}{label}: {k_us / 1e3 / steps:.4f} ms/step of device "
            f"time, {k_n} launches/step")
    if quant_bound_ms:
        quant_ms = sum(us for us, k, _ in rows
                       if any(n in k for n in QUANT_KERNEL_NAMES)) / 1e3 \
            / steps
        log(f"{tag}quantized kernels (matmuls, split reduce, int8 rows) "
            f"{quant_ms:.3f} ms/step of {dev_ms:.2f} ms device time "
            f"(share {quant_ms / dev_ms:.3f}); weight-streaming bound "
            f"{quant_bound_ms:.3f} ms/step ({quant_ms / quant_bound_ms:.2f}"
            f"x)")
    return wall_ms, dev_ms


def scope_device_ms(prof, scope: str):
    """(Device ms of the kernels launched inside every torch.profiler
    range named `scope`, the ranges' ms on the device timeline: from
    their first kernel's start to their last one's end, idle gaps
    included)."""
    from torch.autograd import DeviceType
    kernels = span = 0.0
    for ev in prof.events():
        if ev.name == scope:
            if ev.device_type == DeviceType.CPU:
                kernels += ev.device_time_total
            else:
                span += ev.device_time_total
    return kernels / 1e3, span / 1e3


def quant_model_dir(awq: bool) -> str:
    """A model directory under build/ holding MISTRAL_7B's config.json
    with a 4-bit quantization_config, group 128, for dummy weights:
    GPTQ's (no act-order) or TheBloke/Mistral-7B-v0.1-AWQ's (zero point,
    GEMM version)."""
    quant = {"quant_method": "awq", "bits": 4, "group_size": GPTQ_GS,
             "zero_point": True, "version": "gemm"} if awq else \
        {"quant_method": "gptq", "bits": 4, "group_size": GPTQ_GS,
         "desc_act": False, "sym": False}
    path = os.path.join(HERE, "build",
                        f"chip_smoke_{'awq' if awq else 'gptq'}_model")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(MISTRAL_7B, quantization_config=quant), f)
    return path


def _profiled_prompt_round(torch, engine, tag: str, counters=None,
                           scopes=()):
    """One prompt round at the e2e geometry under torch.profiler: 4
    prompts of 512 tokens (2048 rows, the scheduler's token budget at
    max_model_len 2048), one output token each, after one such round
    unprofiled to warm up; `counters` are reset before the profiled
    round. Returns its device rows [(us, launches, kernel name)], its
    engine steps and the device ms of the kernels inside each of
    `scopes` (torch.profiler ranges, whose own rows stay out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    engine.scheduler_config.multi_step = 1
    sp = SamplingParams(temperature=0.0, max_tokens=1, ignore_eos=True)

    def prompt_round(salt: int) -> int:
        for i in range(4):
            engine.add_request(f"{tag}round-{salt}-{i}", None, sp,
                               prompt_token_ids=[
                                   (j * 37 + i * 11 + salt) % 31000 + 100
                                   for j in range(512)])
        steps = 0
        while engine.has_unfinished_requests():
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        return steps
    prompt_round(0)
    for c in (counters or {}).values():
        c.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps = prompt_round(1)
    return [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.key not in scopes], \
        steps, {scope: scope_device_ms(prof, scope)[0] for scope in scopes}


def profile_prompt_round(torch, engine, tag: str = "",
                         names=QUANT_KERNEL_NAMES):
    """`_profiled_prompt_round`'s round: logs its device kernel time and
    the quantized kernels' (K9, the matmuls, the split reduce: the kernels
    `names` match) and returns both in ms."""
    rows, steps, _ = _profiled_prompt_round(torch, engine, tag)
    dev_ms = sum(us for us, _, _ in rows) / 1e3
    quant_ms = sum(us for us, _, k in rows if any(n in k for n in names)) \
        / 1e3
    log(f"{tag}prompt round, 4 x 512 tokens at Mistral-7B width: {steps} "
        f"engine step(s), device kernels {dev_ms:.3f} ms, quantized "
        f"kernels {quant_ms:.3f} ms (share {quant_ms / dev_ms:.3f})")
    return dev_ms, quant_ms


def profile_kv8_prompt_round(torch, engine, counters, layers: int,
                             tag: str = ""):
    """`_profiled_prompt_round`'s round on 8-bit KV pages, where every
    layer writes its prompt rows through the slot writer (K4): the
    round's device kernel time and launches, the slot kernel's
    (`kv_write_slots_kernel`) and K4's counter. Fails unless the counter
    took `layers` calls a forward pass and the device ran one slot
    kernel a call. Returns them in a dict (times in ms)."""
    rows, steps, _ = _profiled_prompt_round(torch, engine, tag, counters)
    calls = counters["write_kv_pages"].count
    slot = [(us, n) for us, n, k in rows if "kv_write_slots" in k]
    r = dict(steps=steps, device_ms=sum(us for us, _, _ in rows) / 1e3,
             launches=sum(n for _, n, _ in rows),
             slot_ms=sum(us for us, _ in slot) / 1e3,
             slot_launches=sum(n for _, n in slot), calls=calls)
    log(f"{tag}prompt round, 4 x 512 tokens at Mistral-7B width: {steps} "
        f"engine step(s), device kernels {r['device_ms']:.3f} ms in "
        f"{r['launches']} launches; the slot writer (K4) "
        f"{r['slot_ms']:.4f} ms in {r['slot_launches']} launches, "
        f"{calls} write_kv_pages calls ({calls / max(steps, 1):g} a step)")
    if calls != layers * steps or r["slot_launches"] != calls:
        fail(f"{tag}prompt round: {calls} write_kv_pages calls and "
             f"{r['slot_launches']} slot kernels for {steps} steps of "
             f"{layers} layers (want one launch a layer)")
    return r


def run_late_arms(torch, model_dir: str, counters, card: str, layers: int,
                  bf16_pages: int):
    """Phase 17: the Mistral-7B-shaped model with dummy weights served as
    SqueezeLLM (K16), int8 (K17), QuIP# (K16 on f32 activations) and
    GGUF's exact Q4_K form (APHRODITE_GGUF_EXACT=1, K12): phase 4's mix
    at multi_step 1, where every engine step must launch the arm's
    kernel 4 * layers times (or a multiple; counted with its m > 64
    kernel) and none of the others, then the 96-request round (its m > 64
    kernel with the split reduce) and a profiled batch-8 decode step.
    Returns the launches by path."""
    by_path = {}
    late_names = tuple(name for name, _ in LATE_KERNELS.values())
    for quantization, key, label, env in (
            ("squeezellm", "k16", "SqueezeLLM", {}),
            ("int8", "k17", "int8", {}),
            ("quip", "k16f32", "QuIP#", {}),
            ("gguf", "k12", "GGUF exact Q4_K", {"APHRODITE_GGUF_EXACT": "1"})):
        kernel = LATE_KERNELS[key][0]
        os.environ.update(env)
        engine = quant_engine(torch, model_dir, label,
                             quantization=quantization, load_format="dummy")
        log(f"{label}: layer 0 buckets {bucket_forms(engine)}; "
            f"{engine.cache_config.num_gpu_blocks} KV pages (bf16 had "
            f"{bf16_pages})")
        tag = f"{label} "
        # Every arm's prompt rounds and wide decode steps take its m > 64
        # kernel, with the split reduce in the 96-request round.
        gemm = (LATE_GEMMS[key],)
        absent = tuple(k for k in late_names + GGUF_MATMULS + GGUF_GEMMS +
                       tuple(LATE_GEMMS.values()) +
                       ("quantize_activations_int8",)
                       if k not in (kernel,) + gemm)
        wide = ("quant_gemm_split_reduce",) + gemm
        runs = [run_engine(torch, engine, 1, counters, card,
                           required=BF16_KERNELS + (kernel,) + gemm,
                           absent=absent, tag=tag,
                           per_step=((kernel,) + gemm, 4 * layers)),
                run_wide_round(torch, engine, counters, card,
                               ("paged_decode_attention",
                                "write_kv_pages_prefill") + wide, wide[-1],
                               layers, tag)]
        by_path[label] = {}
        for run in runs:
            for name, n in run.items():
                by_path[label][name] = by_path[label].get(name, 0) + n
        step_bound = layers * sum(late_layer_bytes(key, K, N) for _, K, N
                                  in GPTQ_PROJ) / HBM_BYTES_PER_S * 1e3
        named = (("K17 (quant_stream_kernel<8, kInt8>)",
                  "quant_stream_kernel"),) if key == "k17" else ()
        # QuIP#'s step (~12000 launches) profiled over 2 steps, not 4: its
        # trace took most of the arm's time (cut for time).
        profile_decode(torch, engine, tag, quant_bound_ms=step_bound,
                       named=named, steps=2 if key == "k16f32" else 4)
        for name in env:
            os.environ.pop(name)
        del engine
        free_engine(torch, label)
    return by_path


# ------------------------------------- the serving path: spec verify --

# The verify shape: phase 4's 8 decode sequences (the mix's lengths, 16
# tokens into their answers), each with k = APHRODITE_SPEC_K drafts, so
# k + 1 rows a sequence share its block table at ctx L .. L + k.
VERIFY_CTX = [1016, 316, 80, 1016, 316, 80, 28, 28]
SPEC_K = 4


def verify_problem(torch, pa, page_dtype, seed: int = 0,
                   page_size: int = 32):
    """One verify round's K4 and K1 inputs as the model runner builds
    them (`_prepare_spec_verify`): row j of sequence s at position
    L_s - 1 + j with ctx L_s + j and its slot from the sequence's table,
    the 40 rows padded to the decode bucket of 48 (out-of-range slots,
    ctx 0, out-of-range page ids clamped as the attention layer clamps
    them), K1's work list and chunking from the runner's rules."""
    from aphrodite_tpu_torch.ops.kv_quant import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows_per = SPEC_K + 1
    batch = len(VERIFY_CTX) * rows_per
    padded = 48
    need = [-(-(L + SPEC_K) // page_size) for L in VERIFY_CTX]
    pps = -(-max(need) // 4) * 4
    num_pages = sum(need) + 8
    num_slots = num_pages * page_size
    hd = HKV * HEAD_DIM

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(
        seed)).tolist()
    tables, slots, ctx, counts = [], [], [], []
    for s, L in enumerate(VERIFY_CTX):
        table = perm[sum(need[:s]):sum(need[:s + 1])]
        for j in range(rows_per):
            pos = L - 1 + j
            tables.append(table)
            slots.append(table[pos // page_size] * page_size +
                         pos % page_size)
            ctx.append(pos + 1)
            counts.append(len(table))
    tb = torch.full((padded, pps), num_pages, dtype=torch.int32)
    for i, t in enumerate(tables):
        tb[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
    slot_t = torch.full((padded,), num_slots, dtype=torch.int32)
    slot_t[:batch] = torch.tensor(slots, dtype=torch.int32)
    ctx_t = torch.zeros((padded,), dtype=torch.int32)
    ctx_t[:batch] = torch.tensor(ctx, dtype=torch.int32)
    bad_ctx = ctx_t.clone()
    bad_ctx[:batch] = torch.tensor([L + SPEC_K for L in VERIFY_CTX
                                    for _ in range(rows_per)],
                                   dtype=torch.int32)
    ppc = pa.choose_pages_per_chunk(pps, page_size, padded)
    counts += [0] * (padded - batch)
    nw_real = sum(max(1, -(-c // ppc)) for c in counts)
    mix = 1
    while padded * mix < nw_real:
        mix *= 2
    work = pa.build_decode_work_list(
        counts, ppc, pad_to=padded * min(mix, -(-pps // ppc)))
    kp = quantize_kv(randn(num_pages, page_size, hd), page_dtype, KV_SCALE)
    vp = quantize_kv(randn(num_pages, page_size, hd), page_dtype, KV_SCALE)
    return dict(q=randn(padded, HQ, HEAD_DIM), knew=randn(padded, hd),
                vnew=randn(padded, hd), kp=kp, vp=vp,
                tables=tb.cuda().clamp(max=num_pages - 1),
                slots=slot_t.cuda(), ctx=ctx_t.cuda(),
                bad_ctx=bad_ctx.cuda(), ppc=ppc, work=work, pps=pps,
                rows=batch, padded=padded, num_slots=num_slots)


def check_verify_shape(torch, pa, kw, timer):
    """K4 then read-only K1 at the verify shape on bf16, int8 and fp8
    pages: K4's pages exactly the plain version's; K1 within 2e-2 +
    2e-2 |plain| of the plain version at its split count, on the pages
    K4 wrote; a control, every row of a sequence at ctx L + k (the rows
    seeing the drafts after them), must miss that tolerance. Each timed
    (CUDA events, L2 flushed) beside its plain version, the library
    call (`index_copy_` on bf16 pages; SDPA over the gathered,
    dequantized KV) and the bound. Returns {page kind: {"K4": ..., "K1":
    ...}}."""
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.kv_quant import dequant_scale
    out = {}
    for page_dtype in (torch.bfloat16, torch.int8, torch.float8_e5m2):
        kind = str(page_dtype).replace("torch.", "")
        p = verify_problem(torch, pa, page_dtype)
        kv_scale = dequant_scale(page_dtype, KV_SCALE)
        kp2, vp2 = p["kp"].clone(), p["vp"].clone()
        k4 = kw.WRITE_KV_PAGES_LAUNCHES.count
        kw.write_kv_pages(p["knew"], p["vnew"], p["kp"], p["vp"],
                          p["slots"], distinct_pages=False,
                          kv_scale=KV_SCALE)
        kw.write_kv_pages_plain(p["knew"], p["vnew"], kp2, vp2, p["slots"],
                                KV_SCALE)
        torch.cuda.synchronize()
        if kw.WRITE_KV_PAGES_LAUNCHES.count != k4 + 1:
            fail(f"verify shape {kind}: K4 did not count one launch")
        if not (_pages_equal(torch, p["kp"], kp2) and
                _pages_equal(torch, p["vp"], vp2)):
            fail(f"verify shape {kind}: K4's pages differ from plain")
        n_split = pa.choose_decode_splits(p["padded"], k1_heads(pa),
                                          p["pps"], p["ppc"],
                                          pa.sm_count("cuda"))
        akw = dict(scale=HEAD_DIM ** -0.5, kv_scale=kv_scale,
                   pages_per_chunk=p["ppc"])
        args = (p["q"], p["kp"], p["vp"], p["tables"])
        k1 = pa.PAGED_DECODE_ATTENTION_LAUNCHES.count

        def attend(ctx):
            return pa.paged_decode_attention(*args, ctx, None, None, None,
                                             work_items=p["work"], **akw)
        got = attend(p["ctx"])
        want = pa.paged_decode_attention_plain(
            *args, p["ctx"], None, None, None, num_splits=n_split, **akw)
        bad = attend(p["bad_ctx"])
        torch.cuda.synchronize()
        if pa.PAGED_DECODE_ATTENTION_LAUNCHES.count != k1 + 2:
            fail(f"verify shape {kind}: K1 did not count its launches")
        err = (got.float() - want.float()).abs()
        lim = ATOL + RTOL * want.float().abs()
        if not torch.isfinite(got.float()).all() or \
                bool((err > lim).any()):
            fail(f"verify shape {kind}: K1 max err {err.max().item()}")
        c_err = (bad.float() - want.float()).abs()
        if not bool((c_err > lim).any()):
            fail(f"verify shape {kind}: the control (ctx L + k on every "
                 "row) is within tolerance of the plain version")
        arm = ("verify", False, p["knew"], p["vnew"], page_dtype,
               p["slots"])
        _, t4 = time_slot_arm(torch, kw, timer, arm,
                              {page_dtype: (p["kp"], p["vp"])},
                              p["num_slots"])
        t4["max_abs_err"] = 0.0
        # K1: kernel, plain at its split count, SDPA over each row's KV
        # gathered to the longest context and dequantized to bf16.
        rows, pps = p["padded"], p["pps"]
        ms = timer(lambda: attend(p["ctx"]))
        plain_ms = timer(lambda: pa.paged_decode_attention_plain(
            *args, p["ctx"], None, None, None, num_splits=n_split, **akw))
        lmax = max(VERIFY_CTX) + SPEC_K
        idx = p["tables"].long()
        kg = (p["kp"][idx].to(torch.bfloat16) * kv_scale).view(
            rows, pps * 32, HKV, HEAD_DIM)[:, :lmax]
        vg = (p["vp"][idx].to(torch.bfloat16) * kv_scale).view(
            rows, pps * 32, HKV, HEAD_DIM)[:, :lmax]
        group = HQ // HKV
        kx = kg.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
        vx = vg.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
        mask = (torch.arange(lmax, device="cuda")[None] <
                p["ctx"].long()[:, None]).view(rows, 1, 1, lmax)
        q4 = p["q"].view(rows, HQ, 1, HEAD_DIM)
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            q4, kx, vx, attn_mask=mask, scale=HEAD_DIM ** -0.5))
        del kg, vg, kx, vx
        # A sequence's k + 1 rows share one table: its L + k tokens of
        # KV need to come from memory once. The operations count every
        # row's context.
        total_ctx = int(p["ctx"].sum())
        kv_tokens = sum(L + SPEC_K for L in VERIFY_CTX)
        elt = p["kp"].element_size()
        nbytes = (kv_tokens * HKV * HEAD_DIM * 2 * elt
                  + 2 * rows * HQ * HEAD_DIM * 2 + rows * pps * 4 + rows * 4)
        b_ms, b_by = bound(nbytes, 4 * HQ * HEAD_DIM * total_ctx)
        t1 = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=b_ms, bound_by=b_by, n_split=n_split,
                  max_abs_err=err.max().item(),
                  control_err=c_err.max().item())
        out[kind] = {"K4": t4, "K1": t1}
        log(f"verify shape ({len(VERIFY_CTX)} sequences x {SPEC_K + 1} "
            f"rows, padded to {rows}; ctx L..L+{SPEC_K}) on {kind} pages: "
            f"K4 exact, {t4['ms']:.4f} ms (plain {t4['plain_ms']:.4f}, "
            f"library {t4['library_ms']}, bound {t4['bound_ms']:.6f} "
            f"({t4['bound_by']}), {t4['launches_per_call']} device "
            f"launch(es) a call); K1 read-only max err "
            f"{t1['max_abs_err']:.4g} (tolerance {ATOL} + {RTOL}|plain|), "
            f"{ms:.4f} ms (plain {plain_ms:.4f}, SDPA {library_ms:.4f}, "
            f"bound {b_ms:.6f} ({b_by}), {n_split} split(s)); the control "
            f"(ctx L+{SPEC_K} on every row) missed by max err "
            f"{t1['control_err']:.4f}")
    return out


def spec_prompt(n: int, salt: int):
    """A prompt of `n` tokens repeating a 16-token n-gram, so the
    drafter finds the prompt's tail earlier in it (tests/engine/
    test_spec_decode.py's PROMPT at the e2e model's vocabulary)."""
    unit = [(i * 131 + salt * 977) % 31000 + 100 for i in range(16)]
    return (unit * (n // 16 + 1))[:n]


SPEC_MIX = [(1000, None), (300, None), (64, None), (1000, None),
            (300, None), (64, None), (12, 7), (40, 4242)]


def oracle_drafter(references):
    """A drafter that proposes the next k tokens the classic run emitted
    after the same history (`references`: full token lists, prompt and
    output): a perfect prompt-lookup match, to measure verify rounds at
    full acceptance where dummy weights give the n-gram drafter little
    to match."""
    by_head = {tuple(full[:32]): full for full in references}

    def propose(seq_id, token_ids, k):
        full = by_head.get(tuple(token_ids[:32]))
        n = len(token_ids)
        if full is None or list(full[:n]) != list(token_ids):
            return []
        return list(full[n:n + k])
    return propose


def time_drafter(histories, reps: int = 30):
    """Host ms of one decode round's drafting, as `_spec_round` does it:
    `NgramDrafter.propose` (k = APHRODITE_SPEC_K, fresh acceptance
    state, so full width) once per sequence over `histories`. Returns
    the median and the least of `reps` rounds."""
    from aphrodite_tpu_torch.common import flags
    from aphrodite_tpu_torch.processing.drafter import NgramDrafter
    drafter = NgramDrafter()
    k = flags.get_int("APHRODITE_SPEC_K")
    rounds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for seq_id, history in enumerate(histories):
            drafter.propose(seq_id, history, k)
        rounds.append((time.perf_counter() - t0) * 1e3)
    rounds.sort()
    return rounds[len(rounds) // 2], rounds[0]


def log_drafter_cost(mix_histories, card: str):
    """The drafter's host cost a round at batch 8 and 64: on the spec
    mix's own final histories (prompt and 48 tokens; batch 64 repeats
    them 8 times), and on random tokens of the same lengths, where no
    n-gram recurs and every length is scanned to the end."""
    import random
    rng = random.Random(0)
    noise = [[rng.randrange(100, 31100) for _ in h] for h in mix_histories]
    parts = []
    for label, hist in (("the mix's histories", mix_histories),
                        ("random tokens", noise)):
        for batch in (8, 64):
            med, least = time_drafter(hist * (batch // len(hist)))
            parts.append(f"{label} at batch {batch}: {med:.3f} ms a round "
                         f"(least {least:.3f})")
    log(f"n-gram drafter's host time a decode round (history lengths "
        f"{sorted(len(h) for h in mix_histories)}, 30 rounds each, "
        f"median) on {card}'s host: " + "; ".join(parts))


def run_spec_mix(torch, engine, counters, card: str, spec: bool,
                 propose=None, tag: str = ""):
    """The mix with n-gram prompts at multi_step 1, 48 new tokens each,
    greedy but for the last two (seeded, temperature 1): APHRODITE_SPEC
    as `spec` says, drafts from `propose` in place of the engine's
    drafter when given. Returns (tokens by request, launches, stats):
    verify dispatches and, inside them, K1's and K4's launches; drafts
    proposed and accepted; engine steps; wall time; the full token
    lists (prompt and output)."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    os.environ["APHRODITE_SPEC"] = "1" if spec else "0"
    engine.scheduler_config.multi_step = 1
    tag = tag or ("spec" if spec else "classic")
    if propose is not None:
        engine.drafter.propose = propose
    ex = engine.executor
    real = ex.execute_spec_verify
    stats = dict(dispatches=0, k1=0, k4=0, proposed=0, accepted=0,
                 rows=0)

    def verify(mds, drafts, *a, **kwargs):
        k1 = counters["paged_decode_attention"].count
        k4 = counters["write_kv_pages"].count
        results = real(mds, drafts, *a, **kwargs)
        stats["dispatches"] += 1
        stats["k1"] += counters["paged_decode_attention"].count - k1
        stats["k4"] += counters["write_kv_pages"].count - k4
        stats["rows"] += sum(len(d) + 1 for d in drafts.values())
        for r in results:
            stats["proposed"] += r.proposed
            stats["accepted"] += r.accepted
        return results
    ex.execute_spec_verify = verify
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (n, seed) in enumerate(SPEC_MIX):
        sp = SamplingParams(temperature=0.0 if seed is None else 1.0,
                            seed=seed, max_tokens=48, ignore_eos=True)
        engine.add_request(f"{tag}-{i}", None, sp,
                           prompt_token_ids=spec_prompt(n, i))
    outputs, steps = {}, 0
    try:
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    outputs[out.request_id[len(tag) + 1:]] = out
            steps += 1
    finally:
        del ex.execute_spec_verify
        if propose is not None:
            del engine.drafter.propose
    torch.cuda.synchronize()
    stats["wall_s"] = time.perf_counter() - t0
    stats["steps"] = steps
    os.environ["APHRODITE_SPEC"] = "0"
    launches = {name: c.count for name, c in counters.items()}
    tokens = {}
    for rid, out in outputs.items():
        toks = list(out.outputs[0].token_ids)
        if len(toks) != 48 or not all(0 <= t < 32000 for t in toks):
            fail(f"{tag} mix {rid}: bad tokens {toks}")
        tokens[rid] = toks
    stats["full"] = [list(out.prompt_token_ids) +
                     list(out.outputs[0].token_ids)
                     for out in outputs.values()]
    if len(tokens) != len(SPEC_MIX):
        fail(f"{tag} mix: {len(tokens)} of {len(SPEC_MIX)} finished")
    log(f"e2e {tag} mix (n-gram prompts, 8 requests x 48 tokens, "
        f"multi_step 1): {steps} engine steps, {stats['wall_s']:.3f} s, "
        f"{8 * 48 / stats['wall_s']:.1f} generated tok/s on {card}; "
        f"verify dispatches {stats['dispatches']} ({stats['rows']} rows), "
        f"K1 / K4 launches inside them {stats['k1']} / {stats['k4']}, "
        f"drafts proposed {stats['proposed']}, accepted "
        f"{stats['accepted']}; launches {launches}")
    return tokens, launches, stats


def profile_references(engine, max_tokens: int = 96):
    """`profile_spec_step`'s 8 sequences run to `max_tokens` on the
    classic path: their full token lists, an oracle's references."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    os.environ["APHRODITE_SPEC"] = "0"
    engine.scheduler_config.multi_step = 1
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens,
                        ignore_eos=True)
    for i in range(8):
        engine.add_request(f"ref-prof-{i}", None, sp,
                           prompt_token_ids=spec_prompt(64, 20 + i))
    full = []
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                full.append(list(out.prompt_token_ids) +
                            list(out.outputs[0].token_ids))
    return full


def profile_spec_step(torch, engine, spec: bool, steps: int = 6,
                      propose=None, tag: str = ""):
    """Batch-8 decode rounds of 64-token n-gram prompts with
    APHRODITE_SPEC as `spec` says (drafts from `propose` when given),
    after the prompt rounds and two rounds of warm-up: wall ms a round
    (synchronised, unprofiled), then the same number under
    torch.profiler for the device's kernel time a round; tokens emitted
    a round, and how many of the rounds were verify rounds. Returns the
    figures and the sequences' full token lists."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    os.environ["APHRODITE_SPEC"] = "1" if spec else "0"
    engine.scheduler_config.multi_step = 1
    tag = tag or ("spec" if spec else "classic")
    sp = SamplingParams(temperature=0.0, max_tokens=1983, ignore_eos=True)
    for i in range(8):
        engine.add_request(f"{tag}-prof-{i}", None, sp,
                           prompt_token_ids=spec_prompt(64, 20 + i))
    ex = engine.executor
    real = ex.execute_spec_verify
    verifies = [0]

    def verify(*a, **kw):
        verifies[0] += 1
        return real(*a, **kw)
    ex.execute_spec_verify = verify
    if propose is not None:
        engine.drafter.propose = propose

    def emitted():
        return sum(g.get_seqs()[0].get_output_len()
                   for g in engine.scheduler.running)
    try:
        while len(engine.scheduler.running) < 8 or \
                engine.scheduler.waiting or engine.scheduler.prefilling:
            engine.step()
        for _ in range(2):
            engine.step()
        torch.cuda.synchronize()
        n0, v0, t0 = emitted(), verifies[0], time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        tok = (emitted() - n0) / steps
        n_verify = verifies[0] - v0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
    finally:
        del ex.execute_spec_verify
        if propose is not None:
            del engine.drafter.propose
        for i in range(8):
            engine.abort_request(f"{tag}-prof-{i}")
        os.environ["APHRODITE_SPEC"] = "0"
    dev_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA) / 1e3 / steps
    log(f"{tag} decode round, batch 8 at Mistral-7B width, 64-token "
        f"n-gram prompts: wall {wall_ms:.2f} ms/round (unprofiled), "
        f"device kernels {dev_ms:.2f} ms/round, {tok:.2f} tokens/round "
        f"({tok / 8:.2f} a sequence), {n_verify} of {steps} timed rounds "
        f"verify rounds; {tok / wall_ms * 1e3:.1f} tok/s of wall time")
    return dict(wall_ms=wall_ms, dev_ms=dev_ms, tokens=tok,
                verify_rounds=n_verify)


# ---------------------------------------- the serving path: async --

def async_requests():
    """The async run's 16 streams: (name, prompt, sampling kwargs,
    prefix_pos). Mixed lengths, n-gram prompts for most (verify
    rounds), seeded ones, one with a prefix; "resume" is later sent as a
    continuation of its first 8 tokens, "abort" is aborted mid-decode."""
    reqs = []
    for i, n in enumerate((1000, 300, 64, 12, 700, 128, 40, 2)):
        reqs.append((f"g{i}", spec_prompt(n, 30 + i),
                     dict(temperature=0.0, max_tokens=24 + 4 * i), None))
    for i, n in enumerate((64, 500, 16)):
        reqs.append((f"s{i}", spec_prompt(n, 40 + i),
                     dict(temperature=1.0, seed=100 + i, top_p=0.9,
                          max_tokens=20), None))
    reqs.append(("prefix", spec_prompt(320, 50),
                 dict(temperature=0.0, max_tokens=24), 256))
    reqs.append(("resume", spec_prompt(200, 51),
                 dict(temperature=0.0, max_tokens=32), None))
    reqs.append(("long", [(i * 37) % 31000 + 100 for i in range(900)],
                 dict(temperature=0.0, max_tokens=16), None))
    reqs.append(("plain", [(i * 53) % 31000 + 100 for i in range(33)],
                 dict(temperature=0.0, max_tokens=16), None))
    reqs.append(("abort", spec_prompt(100, 52),
                 dict(temperature=0.0, max_tokens=400), None))
    return reqs


def run_sync_reference(torch, engine):
    """The async run's streams (but the aborted one) on the sync engine
    with APHRODITE_SPEC on, all added at once: tokens by name."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    os.environ["APHRODITE_SPEC"] = "1"
    engine.scheduler_config.multi_step = 1
    for name, prompt, sp, prefix_pos in async_requests():
        if name != "abort":
            engine.add_request(f"ref-{name}", None, SamplingParams(
                ignore_eos=True, **sp), prompt_token_ids=prompt,
                prefix_pos=prefix_pos)
    tokens = {}
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                tokens[out.request_id[4:]] = list(out.outputs[0].token_ids)
    engine.scheduler.clear_prefixes()
    os.environ["APHRODITE_SPEC"] = "0"
    return tokens


def check_release(torch, executor):
    """`GPUExecutor.release()`, which reincarnation calls before it
    builds a new executor, must give the weights' and the pages' memory
    back while the engine still holds the old executor."""
    def storages(tree, out):
        if isinstance(tree, torch.Tensor):
            st = tree.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
        elif isinstance(tree, dict):
            for v in tree.values():
                storages(v, out)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                storages(v, out)
        return out
    weights = sum(storages(executor.params, {}).values())
    pages = sum(storages(executor.cache_engine.kv_caches, {}).values())
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    executor.release()
    gc.collect()
    after = torch.cuda.memory_allocated()
    log(f"executor release(): {before / 2**30:.2f} -> {after / 2**30:.2f} "
        f"GiB allocated; weights {weights / 2**30:.2f} GiB and pages "
        f"{pages / 2**30:.2f} GiB were held")
    if before - after < 0.99 * (weights + pages):
        fail(f"release() freed {(before - after) / 2**30:.2f} GiB of the "
             f"{(weights + pages) / 2**30:.2f} GiB of weights and pages")


def run_async_serving(torch, model_dir, counters, card: str, reference):
    """`AsyncAphrodite` on phase 4's geometry (a new engine from the same
    seed, so the same weights): 16 concurrent `generate` streams, with
    APHRODITE_SPEC on, between `start_profile` and `stop_profile`. Every
    stream but the aborted one must give the sync engine's tokens
    (`reference`; the resumed stream its joint tokens), the aborted
    stream's pages must be free, and the trace must name K1's and K4's
    kernels. Returns the launches and the one-sample latency figures."""
    import asyncio
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
    os.environ["APHRODITE_SPEC"] = "1"
    t0 = time.perf_counter()
    engine = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True, disable_log_requests=True))
    sync = engine.engine
    log(f"async engine up in {time.perf_counter() - t0:.1f} s: "
        f"{sync.cache_config.num_gpu_blocks} KV pages of 32 tokens")
    trace_dir = os.path.join(HERE, "build", "chip_smoke_trace")
    bm = sync.scheduler.block_manager
    total = sync.cache_config.num_gpu_blocks
    times, finals, aborted = {}, {}, {}
    for c in counters.values():
        c.reset()

    async def stream(name, prompt, sp, prefix_pos):
        emitted = reference["resume"][:8] if name == "resume" else None
        t_submit = time.perf_counter()
        stamps, final = [], None
        async for out in engine.generate(
                None, SamplingParams(ignore_eos=True, **sp), name,
                prompt_token_ids=prompt, prefix_pos=prefix_pos,
                emitted_token_ids=emitted):
            stamps.append((time.perf_counter(),
                           len(out.outputs[0].token_ids)))
            final = out
            if name == "abort" and len(out.outputs[0].token_ids) >= 4:
                await engine.abort(name)
                aborted["tokens"] = len(out.outputs[0].token_ids)
                break
        times[name] = (t_submit, stamps)
        finals[name] = final

    async def serve():
        sync.start_profile(trace_dir)
        t_start = time.perf_counter()
        try:
            await asyncio.gather(*(stream(*r) for r in async_requests()))
            # The abort lands at the loop's next step: wait for idle.
            for _ in range(2000):
                if not sync.has_unfinished_requests():
                    break
                await asyncio.sleep(0.005)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        finally:
            path = sync.stop_profile()
        return wall, path

    wall, trace = asyncio.run(serve())
    os.environ["APHRODITE_SPEC"] = "0"
    launches = {name: c.count for name, c in counters.items()}
    if sync.has_unfinished_requests():
        fail("async run: the engine still holds requests after the abort")
    if bm.block_tables:
        fail(f"async run: block tables left behind {sorted(bm.block_tables)}")
    sync.scheduler.clear_prefixes()
    if bm.get_num_free_gpu_blocks() != total:
        fail(f"async run: {total - bm.get_num_free_gpu_blocks()} pages not "
             "returned to the free pool")
    mismatched = []
    for name, _, sp, _ in async_requests():
        if name == "abort":
            continue
        got = list(finals[name].outputs[0].token_ids)
        if got != reference[name]:
            mismatched.append(f"{name}: async {got} / sync {reference[name]}")
        if len(got) != sp["max_tokens"]:
            fail(f"async run {name}: {len(got)} tokens")
    if mismatched:
        fail("async tokens differ from the sync engine's: " +
             "; ".join(mismatched))
    with open(trace) as f:
        text = f.read()
    named = {k: text.count(k) for k in ("paged_decode_kernel",
                                        "kv_write_slots_kernel")}
    if not all(named.values()):
        fail(f"async run: the profiler trace {trace} lacks a kernel "
             f"({named})")
    for name in ("paged_decode_attention", "write_kv_pages",
                 "write_kv_pages_prefill"):
        if launches.get(name, 0) <= 0:
            fail(f"async run: kernel {name} never launched ({launches})")
    ttft = sorted(s[0][0] - t for t, s in times.values() if s)
    tpot = sorted((s[-1][0] - s[0][0]) / (s[-1][1] - s[0][1])
                  for _, s in times.values()
                  if len(s) > 1 and s[-1][1] > s[0][1])
    new_tokens = sum(len(f.outputs[0].token_ids) for n, f in finals.items()
                     if f is not None) - 8
    stats = dict(wall_s=wall, ttft_p50_s=ttft[len(ttft) // 2],
                 ttft_max_s=ttft[-1], tpot_p50_ms=tpot[len(tpot) // 2] * 1e3,
                 tpot_max_ms=tpot[-1] * 1e3, tokens=new_tokens)
    log(f"e2e async serving (16 concurrent streams, one aborted after "
        f"{aborted.get('tokens')} tokens, one resumed from 8 emitted "
        f"tokens, one with a 256-token prefix; APHRODITE_SPEC on): "
        f"{wall:.3f} s, {new_tokens} tokens, {new_tokens / wall:.1f} "
        f"generated tok/s on {card}; one-sample smoke figures: TTFT p50 "
        f"{stats['ttft_p50_s']:.3f} s, max {stats['ttft_max_s']:.3f} s; "
        f"per output token p50 {stats['tpot_p50_ms']:.2f} ms, max "
        f"{stats['tpot_max_ms']:.2f} ms; every stream's tokens equal the "
        f"sync engine's; all {total} pages free after the abort; trace "
        f"{os.path.relpath(trace, HERE)} names K1 {named['paged_decode_kernel']} "
        f"and K4 {named['kv_write_slots_kernel']} times; launches {launches}")
    check_release(torch, sync.executor)
    del engine, sync, bm
    free_engine(torch, "async")
    return launches, stats


# ------------------------------------------------------- LoRA (5d) --

LORA_SLOTS, LORA_RANK = 4, 16
LORA_ALL = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj")
LORA_QV = ("q_proj", "v_proj")


def lora_proj(cfg=None):
    """HF projection -> (module, fan in, fan out, merged bucket, output
    row offset there) at `cfg`'s widths (MISTRAL_7B's by default)."""
    cfg = cfg or MISTRAL_7B
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    kv = cfg["num_key_value_heads"] * (h // cfg["num_attention_heads"])
    return {"q_proj": ("self_attn", h, h, "self_attn.qkv_proj", 0),
            "k_proj": ("self_attn", h, kv, "self_attn.qkv_proj", h),
            "v_proj": ("self_attn", h, kv, "self_attn.qkv_proj", h + kv),
            "o_proj": ("self_attn", h, h, "self_attn.o_proj", 0),
            "gate_proj": ("mlp", h, inter, "mlp.gate_up_proj", 0),
            "up_proj": ("mlp", h, inter, "mlp.gate_up_proj", inter),
            "down_proj": ("mlp", inter, h, "mlp.down_proj", 0)}


def write_peft_adapter(torch, path: str, seed: int, rank: int, targets,
                       layers: int, std: float, dtype, keep: bool = False):
    """A PEFT adapter directory at Mistral-7B width: adapter_config.json
    (lora_alpha 2r) and adapter_model.bin (the loader's torch.load route:
    the card machine has no safetensors), A [r, in] and B [out, r] drawn
    ~ N(0, std^2) from numpy RandomState(seed) and stored in `dtype`.
    With `keep`, returns {(layer, proj): (A, B)} as stored, in f32."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank,
                   "target_modules": list(targets)}, f)
    rs = np.random.RandomState(seed)
    state, kept = {}, {}
    for i in range(layers):
        for proj in targets:
            part, fan_in, fan_out = lora_proj()[proj][:3]
            base = f"base_model.model.model.layers.{i}.{part}.{proj}"
            a = torch.from_numpy((rs.standard_normal((rank, fan_in)) * std)
                                 .astype(np.float32)).to(dtype)
            b = torch.from_numpy((rs.standard_normal((fan_out, rank)) * std)
                                 .astype(np.float32)).to(dtype)
            state[f"{base}.lora_A.weight"] = a
            state[f"{base}.lora_B.weight"] = b
            if keep:
                kept[(i, proj)] = (a.float(), b.float())
    torch.save(state, os.path.join(path, "adapter_model.bin"))
    return kept


def drive_rows(torch, runner, kv, prompts, lora_reqs, tables, forced=None,
               steps: int = 3):
    """A prompt round of `prompts` (row i under adapter `lora_reqs[i]` or
    none) and `steps` decode steps through `runner` on pages `kv`. Each
    row's next token is its logits' argmax, or `forced[i][step]`.
    Returns (f32 logits [rows, vocab] a step, the tokens of each row)."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                     SequenceGroupMetadata)
    out_tokens = [[] for _ in prompts]
    logits_all = []
    for step in range(steps + 1):
        mds = []
        for i, prompt in enumerate(prompts):
            data = SequenceData(list(prompt))
            for t in out_tokens[i]:
                data.append_token_id(t, 0.0)
            mds.append(SequenceGroupMetadata(
                f"r{i}", step == 0, {i: data},
                SamplingParams(temperature=0.0), {i: tables[i]}, {i: {}},
                lora_request=lora_reqs[i]))
        inputs, _ = (runner._prepare_prompt(mds) if step == 0
                     else runner._prepare_decode(mds))
        meta = inputs["metadata"].replace(is_prompt=step == 0)
        logits, kv = runner._logits(
            runner._params_with_lora(inputs), inputs["input_ids"],
            inputs["positions"], kv, meta, inputs["sel"])
        rows = logits[:len(prompts)].float()
        logits_all.append(rows)
        nxt = rows.argmax(-1).tolist() if forced is None else \
            [f[step] for f in forced]
        for i, t in enumerate(nxt):
            out_tokens[i].append(int(t))
    torch.cuda.synchronize()
    return logits_all, out_tokens


def lora_bound_excess(torch, got, want) -> float:
    """max |got - want| / (2e-2 + 2e-2 |want|): above 1 misses the bound."""
    return ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()


def check_lora_two_layer(torch, counters, gptq: bool):
    """Phase 5d (a) / (c): a 2-layer Llama at Mistral-7B width, bf16 or
    GPTQ W4A16 (4 bits, group 128), with LoRA at max_loras 4, rank 16,
    and four PEFT adapters written under build/ (all seven projections at
    rank 16 twice and at rank 8, which the slot pads with zeros; q+v only
    at rank 16, the subset layout). 8 sequences of 64 tokens, two without
    an adapter: a prompt round (K2; K6 on GPTQ) and 3 decode steps (K1;
    K7 on GPTQ). Held: adapter rows' logits within 2e-2 + 2e-2 |ref| of a
    plain f32 forward (the plain attention and writers) with each row's
    W + (alpha / r) B A merged (GPTQ: W dequantized by its plain version);
    rows without an adapter bit-equal to the same model with LoRA off on
    the same batch; a control that swaps two adapters' slots misses the
    bound (its excess on each row it moves is logged). Returns the
    bound's largest excess."""
    from aphrodite_tpu_torch.common.config import LoRAConfig
    from aphrodite_tpu_torch.lora.layers import (LORA_A, LORA_B,
                                                 LoRALinearMethod)
    from aphrodite_tpu_torch.lora.models import layouts_from_model
    from aphrodite_tpu_torch.lora.request import LoRARequest
    from aphrodite_tpu_torch.lora.worker_manager import WorkerLoRAManager
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    from aphrodite_tpu_torch.modeling.layers import attention
    from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQConfig)
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)

    label = "GPTQ W4A16" if gptq else "bf16"
    cfg = config_from_dict(dict(MISTRAL_7B, num_hidden_layers=2))
    dev = torch.device("cuda")
    base_method = GPTQConfig(4, GPTQ_GS).get_linear_method() if gptq \
        else LinearMethod()
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                             linear_method=LoRALinearMethod(
                                 base_method, LORA_SLOTS, LORA_RANK))
    params = model.init_params(dev)
    gen = torch.Generator(device=dev).manual_seed(70 + gptq)
    # Dense weights U(-0.05, 0.05) as phase 3's model; GPTQ codes random
    # about a zero point of 8 (random zero points bias whole groups, and
    # the residual stream then drowns the adapters' deltas: the swapped
    # control stayed within the bound on 3 of 4 rows) with scales
    # in [3e-3, 6e-3) (about the same spread); the LM head
    # U(-1e-3, 1e-3). bf16 against f32 moves the final hidden state by
    # ~1% whatever the adapters do: with the head at U(-0.01, 0.01) (max
    # |logit| 1.9) even the rows without an adapter missed 2e-2 + 2e-2
    # |ref| (by 1.58x, adapter rows 2.19x, on an NVIDIA H100), so the
    # head maps that drift to logits under the bound's 2e-2 term; the
    # swapped-slot control shows the bound still sees an adapter's
    # effect.
    for key, bucket in params.items():
        for name, t in bucket.items():
            if name in (LORA_A, LORA_B):
                t.zero_()
            elif key.endswith("layernorm") or key == "model.norm":
                t.fill_(1.0)
            elif key == "lm_head":
                t.uniform_(-1e-3, 1e-3, generator=gen)
            elif name == "g_idx":
                t.copy_(torch.arange(t.numel(), device=dev) // GPTQ_GS)
            elif name == "qweight":
                t.random_(-2 ** 31, 2 ** 31, generator=gen)
            elif name == "qzeros":
                t.fill_(0x77777777)             # z - 1 = 7 in every nibble
            elif name == "scales":
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) *
                        3e-3 + 3e-3)
            elif t.is_floating_point():
                t.uniform_(-0.05, 0.05, generator=gen)

    root = os.path.join(HERE, "build", "lora_smoke", "gptq" if gptq
                        else "bf16")
    peft, reqs = {}, {}
    for lid, rank, targets in ((1, 16, LORA_ALL), (2, 16, LORA_ALL),
                               (3, 8, LORA_ALL), (4, 16, LORA_QV)):
        path = os.path.join(root, f"a{lid}")
        peft[lid] = write_peft_adapter(torch, path, 100 * (1 + gptq) + lid,
                                       rank, targets, 2, 0.04,
                                       torch.float32, keep=True)
        reqs[lid] = LoRARequest(f"a{lid}", lid, path)

    class _Cfg:
        def get_vocab_size(self):
            return cfg.vocab_size

        def get_sliding_window(self):
            return None
    page_size, num_pages = 32, 32

    kv_width = lora_proj()["k_proj"][2]

    def pages(dtype):
        return [(torch.zeros(num_pages, page_size, kv_width, dtype=dtype,
                             device=dev),
                 torch.zeros(num_pages, page_size, kv_width, dtype=dtype,
                             device=dev)) for _ in range(2)]

    def runner_of(m, p, dtype=torch.bfloat16):
        return ModelRunner(m, p, _Cfg(), None, page_size,
                           num_pages * page_size, dev, kv_cache_dtype=dtype)
    runner = runner_of(model, params)
    manager = WorkerLoRAManager(
        LoRAConfig(max_lora_rank=LORA_RANK, max_loras=LORA_SLOTS),
        runner.write_lora_slot, runner.clear_lora_slot,
        layouts_from_model(model))
    row_ids = [1, 2, None, 3, 4, None, 2, 1]
    row_reqs = [reqs.get(i) for i in row_ids]
    manager.set_active_adapters(row_reqs)
    runner.lora_slot_of = manager.slot_of
    prompts = [[(j * 131 + i * 977) % (cfg.vocab_size - 100) + 50
                for j in range(64)] for i in range(8)]
    tables = [[3 * i + 1, 3 * i + 2, 3 * i + 3] for i in range(8)]

    for c in counters.values():
        c.reset()
    got, tokens = drive_rows(torch, runner, pages(torch.bfloat16), prompts,
                             row_reqs, tables)
    launches = {n: c.count for n, c in counters.items() if c.count}
    required = ("paged_decode_attention", "write_kv_pages_prefill") + (
        ("gptq_matmul", "gptq_matmul_stream") if gptq else ())
    for name in required:
        if not launches.get(name):
            fail(f"LoRA 2-layer {label}: kernel {name} never launched "
                 f"({launches})")

    # LoRA off, the same batch and tokens: rows without an adapter
    # bit-equal.
    model_off = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                                 linear_method=base_method)
    params_off = {k: {n: t for n, t in b.items()
                      if n not in (LORA_A, LORA_B)}
                  for k, b in params.items()}
    off, _ = drive_rows(torch, runner_of(model_off, params_off),
                        pages(torch.bfloat16), prompts, [None] * 8, tables,
                        forced=tokens)
    base_rows = [i for i, a in enumerate(row_ids) if a is None]
    if not all(torch.equal(g[base_rows], o[base_rows])
               for g, o in zip(got, off)):
        fail(f"LoRA 2-layer {label}: rows without an adapter differ from "
             "the model with LoRA off on the same batch")

    # The plain f32 reference, one adapter (or none) at a time.
    ref_base = {}
    for key, bucket in params.items():
        if "qweight" in bucket:
            w = qmm.dequantize_plain(bucket["qweight"], bucket["qzeros"],
                                     bucket["scales"], bits=4,
                                     group_size=GPTQ_GS,
                                     dtype=torch.bfloat16)
            ref_base[key] = {"weight": w.t().float().contiguous()}
        else:
            ref_base[key] = {n: t.float() for n, t in bucket.items()
                             if n not in (LORA_A, LORA_B)}
    model_ref = LlamaForCausalLM(cfg, dtype=torch.float32)
    plain = {
        (attention, "write_kv_pages"):
            lambda k, v, kp, vp, s, **_: kw.write_kv_pages_plain(
                k, v, kp, vp, s),
        (attention, "write_kv_pages_prefill"):
            lambda k, v, kp, vp, pid, sb, vld:
            kw.write_kv_pages_prefill_plain(k, v, kp, vp, pid, vld),
        (attention, "paged_decode_attention"):
            pa.paged_decode_attention_plain,
    }
    saved = {key: getattr(*key) for key in plain}
    ref = {}
    try:
        for key, fn in plain.items():
            setattr(*key, fn)
        for lid in (None, 1, 2, 3, 4):
            rows = [i for i, a in enumerate(row_ids) if a == lid]
            p_ref = dict(ref_base)
            for (layer, proj), (a, b) in (peft[lid].items() if lid
                                          else ()):
                scale = 2.0                      # lora_alpha / r
                suffix, off_row = lora_proj()[proj][3:]
                key = f"model.layers.{layer}.{suffix}"
                if p_ref[key] is ref_base[key]:
                    p_ref[key] = {"weight": ref_base[key]["weight"].clone()}
                w = p_ref[key]["weight"]
                w[off_row:off_row + b.shape[0]] += scale * (
                    b.to(dev) @ a.to(dev))
            want, _ = drive_rows(
                torch, runner_of(model_ref, p_ref, torch.float32),
                pages(torch.float32), [prompts[i] for i in rows],
                [None] * len(rows), [tables[i] for i in rows],
                forced=[tokens[i] for i in rows])
            for j, i in enumerate(rows):
                ref[i] = [w[j] for w in want]
            del p_ref
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)

    excess = {i: max(lora_bound_excess(torch, got[s][i], ref[i][s])
                     for s in range(len(got))) for i in range(8)}
    held = max(excess[i] for i in range(8) if row_ids[i] is not None)

    # Control: adapters 1 and 2 swap slots.
    swap = {1: 2, 2: 1}
    runner.lora_slot_of = lambda i: manager.slot_of(swap.get(i, i))
    ctl, _ = drive_rows(torch, runner, pages(torch.bfloat16), prompts,
                        row_reqs, tables, forced=tokens)
    runner.lora_slot_of = manager.slot_of
    moved = [i for i, a in enumerate(row_ids) if a in swap]
    ctl_excess = {i: max(lora_bound_excess(torch, ctl[s][i], ref[i][s])
                         for s in range(len(ctl))) for i in moved}
    log(f"LoRA 2-layer {label} model (max_loras {LORA_SLOTS}, rank "
        f"{LORA_RANK}; adapters all 7 projections r16 x2, r8, q+v r16): "
        f"prompt + 3 decode steps of 8 rows vs a plain f32 forward with "
        f"each row's W + (alpha/r) B A merged: |err| / (2e-2 + 2e-2 |ref|)"
        f" at most {held:.3f} on adapter rows (must be <= 1), "
        f"{max(excess[i] for i in base_rows):.3f} on the rows without "
        f"(a reading); those rows bit-equal to LoRA off; control (adapters "
        f"1 and 2 swap slots) {ctl_excess} (the largest must exceed 1); max "
        f"|logit| {max(r.abs().max().item() for r in got):.3f}; launches "
        f"{launches}")
    if held > 1:
        fail(f"LoRA 2-layer {label}: adapter rows miss the bound by "
             f"{held:.3f}x")
    if max(ctl_excess.values()) <= 1:
        fail(f"LoRA 2-layer {label}: the swapped-slot control stays within "
             f"the bound ({ctl_excess})")
    del model, params, runner, manager, model_off, params_off, ref_base
    gc.collect()
    torch.cuda.empty_cache()
    return held


def time_lora_delta(torch, timer) -> dict:
    """Phase 5d (d): device time of the LoRA delta a decoder layer (its
    four wrapped layers at Mistral-7B width, max_loras 4, rank 16, every
    row with an adapter, the step's mask prebuilt) at batch 8 and 64:
    `LoRALinearMethod.apply` with the rows' slots minus the same call
    without them (the base F.linear), each timed as phase 3 times a
    kernel, beside the bytes bound of the delta (x, all slots' A and B
    and y read once, y written once)."""
    from aphrodite_tpu_torch.lora.layers import (LORA_A, LORA_B, LORA_IDX,
                                                 LORA_MASK, LoRALinearMethod,
                                                 slot_mask)
    from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    method = LoRALinearMethod(LinearMethod(), LORA_SLOTS, LORA_RANK)
    out = {}
    for m in (8, 64):
        idx = (torch.arange(m, device=dev, dtype=torch.int32) % LORA_SLOTS)
        mask = slot_mask(idx, LORA_SLOTS, torch.bfloat16)
        with_ms = without_ms = bound_ms = 0.0
        proj = lora_proj()
        for fan_in, fan_out, packed in (
                (proj["q_proj"][1], sum(proj[p][2] for p in LORA_QV) +
                 proj["k_proj"][2], 3),
                proj["o_proj"][1:3] + (1,),
                (proj["gate_proj"][1], 2 * proj["gate_proj"][2], 2),
                proj["down_proj"][1:3] + (1,)):
            r = LORA_RANK * packed * LORA_SLOTS

            def randn(*shape):
                return (torch.randn(*shape, generator=gen, device=dev) *
                        0.02).to(torch.bfloat16)
            base = {"weight": randn(fan_out, fan_in),
                    LORA_A: randn(r, fan_in), LORA_B: randn(fan_out, r)}
            lora = dict(base, **{LORA_IDX: idx, LORA_MASK: mask})
            x = randn(m, 1, fan_in)
            with_ms += timer(lambda: method.apply(lora, x))
            without_ms += timer(lambda: method.apply(base, x))
            bound_ms += 2 * (r * fan_in + fan_out * r + m * fan_in +
                             2 * m * fan_out) / HBM_BYTES_PER_S * 1e3
        out[m] = (with_ms - without_ms, with_ms, without_ms, bound_ms)
        log(f"LoRA delta a decoder layer at batch {m} (4 wrapped layers, "
            f"max_loras {LORA_SLOTS}, rank {LORA_RANK}): "
            f"{with_ms - without_ms:.4f} ms of device time ({with_ms:.4f} "
            f"with the delta, {without_ms:.4f} the base alone); bytes bound "
            f"{bound_ms:.5f} ms; {32 * (with_ms - without_ms):.3f} ms over "
            "32 layers")
    return out


def lora_gap_bound(torch, runner, prompts, tokens):
    """Top-2 logit gaps along the base model's own trajectories
    (`prompts[i]` then `tokens[i]`, teacher-forced in one cache-less
    prompt round a sequence) and the gap bound: 4 x the largest logit
    difference between that round and the same sequences two at a time
    (equal lengths: the same rows in another batch shape), floored at one
    bf16 ulp of the largest logit. Returns (gaps per sequence, bound)."""
    from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
    dev = torch.device("cuda")

    def forced(seqs):
        full = [p + t[:-1] for p, t in zip(seqs[0], seqs[1])]
        n, L = len(full), len(full[0])
        ids = torch.tensor(full, dtype=torch.int32, device=dev)
        pos = torch.arange(L, dtype=torch.int32, device=dev).repeat(n, 1)
        meta = InputMetadata(
            slot_mapping=torch.zeros((n * L,), dtype=torch.int32,
                                     device=dev),
            block_tables=torch.zeros((n, 1), dtype=torch.int32, device=dev),
            context_lens=torch.zeros((n,), dtype=torch.int32, device=dev),
            prompt_lens=torch.full((n,), L, dtype=torch.int32, device=dev),
            is_prompt=True)
        k = len(seqs[1][0])
        sel = torch.cat([torch.arange(L - k, L, device=dev) + r * L
                         for r in range(n)])
        logits, _ = runner._logits(runner.params, ids, pos, None, meta, sel)
        return logits.float().view(n, k, -1)
    alone = [forced(([p], [t]))[0] for p, t in zip(prompts, tokens)]
    noise = 0.0
    by_len = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    for group in by_len.values():
        for i, j in zip(group[::2], group[1::2]):
            pair = forced(([prompts[i], prompts[j]], [tokens[i], tokens[j]]))
            noise = max(noise, (pair[0] - alone[i]).abs().max().item(),
                        (pair[1] - alone[j]).abs().max().item())
    top = max(a.abs().max().item() for a in alone)
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    gaps = [(lambda t2: (t2[:, 0] - t2[:, 1]).tolist())(
        a.topk(2, dim=-1).values) for a in alone]
    return gaps, max(4 * noise, ulp), noise


def mix_prompt(n: int, salt: int):
    """run_engine's prompts (phase 4's mix)."""
    return [(i * 131 + salt * 977) % 31000 + 100 for i in range(n)]


# Phase 4's mix: (request id without the tag, prompt length, salt).
MIX = [(str(i), n, i) for i, n in enumerate([1000, 300, 64, 1000, 300, 64])]
MIX_LATE = [(f"late{j}", 12, 10 + j) for j in range(2)]


def run_lora_engine(torch, model_dir, counters, card: str, phase4):
    """Phase 5d (b): the port's engine at Mistral-7B width and depth,
    bf16, dummy weights from seed 0 (phase 4's), enable_lora with
    max_loras 4 and rank 16, and six PEFT adapters written under build/
    (all seven projections, rank 16 or 8). Phase 4's mix of 8
    base requests plus its six first prompts again, each under its own
    adapter (6 over 4 slots: the scheduler holds adapter requests back
    and the slots are evicted and reloaded), with APHRODITE_SPEC off and
    on, at multi_step 1 and 8. Every request must finish with its 32
    tokens; every adapter row must differ from phase 4's tokens for its
    prompt; every base row must equal phase 4's while its top-2 logit
    gap (the base model teacher-forced along phase 4's tokens) exceeds
    the gap bound (`lora_gap_bound`); K1, K2 and K4 must launch; every
    page must return to the pool; no step may hold more than 4 adapters.
    Then phase 5d (d)'s batch-8 decode profiles on this engine. Returns
    (launches, the profiles); the caller frees the engine once this
    frame, whose spies hold it, is gone."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.lora.request import LoRARequest
    root = os.path.join(HERE, "build", "lora_smoke", "e2e")
    t0 = time.perf_counter()
    reqs = {}
    # All seven projections (the subset layout is phase 5d (a)'s), A and
    # B ~ N(0, 0.3^2): a dummy layer adds ~1e-8 of the residual stream
    # (the embedding's U(-1e-3, 1e-3)), so an adapter must be strong to
    # move a token (through gate / up / down it adds ~50x the residual).
    for lid in range(1, 7):
        path = os.path.join(root, f"a{lid}")
        write_peft_adapter(torch, path, 500 + lid, 16 if lid % 2 else 8,
                           LORA_ALL, MISTRAL_7B["num_hidden_layers"], 0.3,
                           torch.bfloat16)
        reqs[lid] = LoRARequest(f"a{lid}", lid, path)
    log(f"LoRA e2e: 6 adapters at Mistral-7B depth written in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True, enable_lora=True, max_loras=LORA_SLOTS,
        max_lora_rank=LORA_RANK))
    executor = engine.executor
    manager = executor.lora_manager.manager
    total = engine.cache_config.num_gpu_blocks
    log(f"LoRA engine up in {time.perf_counter() - t0:.1f} s: {total} KV "
        f"pages of 32 tokens")
    held, moves = [], {"activate": 0, "deactivate": 0}
    real_pre = executor._pre_step

    def pre_step(mds, *args):
        real_pre(mds, *args)
        held.append((len({md.lora_int_id for md in mds if md.lora_request}),
                     len(manager._slot_of)))
    executor._pre_step = pre_step
    for name in moves:
        def counted(lora_id, _real=getattr(manager, f"{name}_lora"),
                    _name=name):
            done = _real(lora_id)
            moves[_name] += bool(done)
            return done
        setattr(manager, f"{name}_lora", counted)

    gaps = {}
    for ms in (1, 8):
        prompts = [mix_prompt(n, salt) for _, n, salt in MIX + MIX_LATE]
        want = [phase4[f"m{ms}-{rid}"] for rid, _, _ in MIX + MIX_LATE]
        gaps[ms] = lora_gap_bound(torch, executor.model_runner, prompts,
                                  want)
    launches_all = {}
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    for spec, ms in ((False, 1), (False, 8), (True, 1), (True, 8)):
        tag = f"LoRA spec {'on' if spec else 'off'} multi_step={ms}"
        os.environ["APHRODITE_SPEC"] = "1" if spec else "0"
        engine.scheduler_config.multi_step = ms
        held.clear()
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rid, n, salt in MIX:
            engine.add_request(f"{tag}/{rid}", None, sp,
                               prompt_token_ids=mix_prompt(n, salt))
        for lid, (rid, n, salt) in enumerate(MIX, 1):
            engine.add_request(f"{tag}/a{lid}-{rid}", None, sp,
                               prompt_token_ids=mix_prompt(n, salt),
                               lora_request=reqs[lid])
        outputs, steps = {}, 0
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    outputs[out.request_id[len(tag) + 1:]] = \
                        list(out.outputs[0].token_ids)
            steps += 1
            if steps == 1:
                for rid, n, salt in MIX_LATE:
                    engine.add_request(f"{tag}/{rid}", None, sp,
                                       prompt_token_ids=mix_prompt(n, salt))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {n: c.count for n, c in counters.items() if c.count}
        for name, n in launches.items():
            launches_all[name] = launches_all.get(name, 0) + n
        if len(outputs) != 14 or any(len(t) != 32 or not all(
                0 <= x < 32000 for x in t) for t in outputs.values()):
            fail(f"{tag}: {len(outputs)} of 14 requests finished with 32 "
                 "in-vocabulary tokens")
        for name in BF16_KERNELS[:1] + ("write_kv_pages_prefill",
                                        "write_kv_pages"):
            if not launches.get(name):
                fail(f"{tag}: kernel {name} never launched ({launches})")
        free = engine.scheduler.block_manager.get_num_free_gpu_blocks()
        if free != total:
            fail(f"{tag}: {total - free} pages not returned to the pool")
        most = max(max(h) for h in held)
        if most > LORA_SLOTS:
            fail(f"{tag}: a step held {most} adapters")
        same_as_base = [f"a{lid}" for lid, (rid, _, _) in enumerate(MIX, 1)
                        if outputs[f"a{lid}-{rid}"] == phase4[f"m{ms}-{rid}"]]
        if same_as_base:
            fail(f"{tag}: adapter rows {same_as_base} equal the base tokens")
        row_gaps, gap_bound, noise = gaps[ms]
        compared, stopped = 0, 0
        for k, (rid, _, _) in enumerate(MIX + MIX_LATE):
            got, base = outputs[rid], phase4[f"m{ms}-{rid}"]
            for t, (g, w) in enumerate(zip(got, base)):
                if row_gaps[k][t] <= gap_bound:
                    stopped += 1
                    break              # a near tie may flip from here
                if g != w:
                    fail(f"{tag}: base row {rid} differs from phase 4 at "
                         f"token {t} where the top-2 gap "
                         f"{row_gaps[k][t]:.3e} exceeds the bound "
                         f"{gap_bound:.3e}: {got} / {base}")
                compared += 1
        log(f"e2e {tag}: 8 base + 6 adapter requests (6 adapters over "
            f"{LORA_SLOTS} slots) x 32 tokens, {steps} engine steps, "
            f"{dt:.3f} s, {14 * 32 / dt:.1f} generated tok/s on {card}; "
            f"adapter rows all differ from the base tokens; base rows equal "
            f"phase 4's on {compared} tokens compared while the top-2 gap "
            f"exceeds {gap_bound:.3e} (4 x the batch-shape noise "
            f"{noise:.3e}; {stopped} rows stopped at a near tie); at most "
            f"{most} adapters a step; slot activations "
            f"{moves['activate']}, evictions {moves['deactivate']} so far; "
            f"all {total} pages free; launches {launches}")
    os.environ["APHRODITE_SPEC"] = "0"
    if moves["deactivate"] < 1:
        fail("LoRA e2e: 6 adapters over 4 slots evicted no slot")
    every = [reqs[i % LORA_SLOTS + 1] for i in range(8)]
    profiles = {
        "every row": profile_decode(torch, engine, "LoRA, every row with "
                                    "an adapter: ", lora_requests=every),
        "no row": profile_decode(torch, engine, "LoRA, no row with an "
                                 "adapter: "),
    }
    return launches_all, profiles



# ------------------------------------------------- mixture of experts --

# The published config.json of deepseek-ai/deepseek-moe-16b-base
# (Hugging Face hub; `auto_map` and the training-only keys left out):
# multi-head attention, 16 query heads over 16 KV heads of 128.
DEEPSEEK_MOE_16B = {
    "architectures": ["DeepseekForCausalLM"], "attention_bias": False,
    "bos_token_id": 100000, "eos_token_id": 100001,
    "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 10944,
    "max_position_embeddings": 4096, "model_type": "deepseek",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 28, "num_key_value_heads": 16,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 10000,
    "scoring_func": "softmax", "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 102400,
}

# The published config.json of mistralai/Mixtral-8x7B-v0.1.
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "output_router_logits": False, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000,
}

MOE_BUCKETS = (".block_sparse_moe", ".mlp_moe")
MOE_STACKS = ("w_gate", "w_up", "w_down")
# Phase 19 (b): tokens whose k-th and (k+1)-th router probabilities lie
# further apart than this must pick the same experts in the kernel and
# the plain run (with router logits of standard deviation ~3, a k-th
# probability of DeepSeek's 64 experts is ~0.01; a 2% change of a
# logit moves it by ~2e-4).
MOE_PICK_MARGIN = 1e-3


def check_moe_kernels(torch, pa, kw, timer):
    """Phase 19 (a): K1-K4 at DeepSeek-MoE-16B's attention, Hq 16 over
    Hkv 16 of 128 (group 1: one live column of K1's 8-wide n-tile). K1
    on the ragged grid with a work list, fused write on and off, at its
    forced split counts, on bf16, int8 and fp8 pages (phase 3's
    tolerance); K1's fused write at the 8-bit edges; K2 and K3 / K4
    exact with their controls, and timed; K1 timed at B 8 and B 64 x
    2047 on each page type beside its plain version, SDPA and the
    bound."""
    with heads(16, 16):
        for page_dtype in (torch.bfloat16, torch.int8, torch.float8_e5m2):
            check_decode_attention(torch, pa, True, page_dtype,
                                   amlas=(True,), alibis=(False,))
        check_fused_write_edges(torch, pa, kw)
        # Launches a call by the wrapper's counter: phase 3 counts the
        # same wrapper's device launches by torch.profiler, whose one-call
        # traces of these arms came back empty in all eight tries at
        # Hkv 16 in three full runs (never when this phase ran alone).
        k2, _ = check_and_time_writers(torch, kw, timer, profiled=False)
        log(f"K2 at Hkv 16 (256 cells, 2728 rows): kernel {k2['ms']:.4f} "
            f"ms, plain {k2['plain_ms']:.4f} ms, index_copy_ "
            f"{k2['library_ms']:.4f} ms, bound {k2['bound_ms']:.6f} ms "
            f"({k2['bound_by']})")
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "n_split", "merges", "host_us")
        e2e_ctx = [1016, 316, 80, 1016, 316, 80, 28, 28]
        for page_dtype in (torch.bfloat16, torch.int8, torch.float8_e5m2):
            kind = str(page_dtype).replace("torch.", "")
            for shape, ctxs, pps in (("B 8", e2e_ctx, 36),
                                     ("B 64 x 2047", [2047] * 64, 64)):
                t = dict(zip(keys, time_decode_attention(
                    torch, pa, timer, ctxs, 32, pps, fused=True,
                    page_dtype=page_dtype)))
                log(f"K1 at group 1 (Hq 16 / Hkv 16), {kind} pages at "
                    f"{shape} (page 32, fused): kernel {t['ms']:.4f} ms, "
                    f"plain {t['plain_ms']:.4f} ms, sdpa "
                    f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} "
                    f"ms ({t['bound_by']}); {t['n_split']} split(s), "
                    f"{t['merges']} merge launch(es) a call; wrapper "
                    f"{t['host_us']:.1f} us of host time a call")


def moe_params(torch, model, seed: int):
    """`model`'s parameters on the card, U(-0.05, 0.05) as phase 3's
    2-layer model, norms 1, and each router U(-a, a) with a = 3 sqrt(3 /
    hidden): logits of standard deviation ~3 on normed rows, so most
    top-k margins are clear."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(dev)
    width = 3 * math.sqrt(3 / model.config.hidden_size)
    for key, bucket in params.items():
        for t in bucket.values():
            t.uniform_(-0.05, 0.05, generator=gen)
        if key.endswith("layernorm") or key == "model.norm":
            bucket["weight"].fill_(1.0)
        if key.endswith(MOE_BUCKETS):
            bucket["gate"].uniform_(-width, width, generator=gen)
    return params


def check_moe_two_layer(torch, counters):
    """Phase 19 (b): 2-layer Mixtral-8x7B (8 experts of 14336, top 2,
    both layers MoE) and DeepSeek-MoE-16B (layer 0 dense at 10944,
    layer 1 64 routed experts of 1408, top 6, 2 shared) at full width
    through the kernels vs their plain versions (`compare_with_plain`,
    the plain run on the kernel run's expert picks, picks past
    MOE_PICK_MARGIN held equal); the control, every expert stack rolled
    by one expert, must miss the tolerance."""
    from aphrodite_tpu_torch.modeling.loader import _get_model_architecture
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    for name, base, geometry in (("Mixtral-8x7B", MIXTRAL_8X7B, (32, 8)),
                                 ("DeepSeek-MoE-16B", DEEPSEEK_MOE_16B,
                                  (16, 16))):
        cfg = config_from_dict(dict(base, num_hidden_layers=2))
        model = _get_model_architecture(cfg)(cfg, dtype=torch.bfloat16)
        params = moe_params(torch, model, seed=2)
        rolled = {key: {n: t.roll(1, 0) if n in MOE_STACKS else t
                        for n, t in bucket.items()}
                  if key.endswith(MOE_BUCKETS) else bucket
                  for key, bucket in params.items()}
        k1, k2 = (counters[n] for n in ("paged_decode_attention",
                                        "write_kv_pages_prefill"))
        before = k1.count, k2.count
        with heads(*geometry):
            compare_with_plain(
                torch, model, params, f"{name} 2-layer",
                moe_margin=MOE_PICK_MARGIN, param_controls={
                    "every expert stack rolled by one expert": rolled})
        # The kernel run: K2 for the page-aligned prompt, K1 in each of
        # the 3 decode steps, in both layers.
        if (k1.count - before[0], k2.count - before[1]) != (6, 2):
            fail(f"{name} 2-layer: K1 / K2 launched {k1.count - before[0]}"
                 f" / {k2.count - before[1]} times, not 6 / 2")
        del model, params, rolled
        free_engine(torch, f"{name} 2-layer")


@contextlib.contextmanager
def moe_scope(torch, picks=None):
    """Every FusedMoE call inside a torch.profiler range "fused_moe";
    with `picks` a list, every routing call's expert ids appended to it
    (kept on the card: no sync)."""
    from aphrodite_tpu_torch.modeling.layers import fused_moe
    real_call, real_route = fused_moe.FusedMoE.__call__, fused_moe.route

    def scoped(self, params, hidden):
        with torch.profiler.record_function("fused_moe"):
            return real_call(self, params, hidden)

    def route(*args):
        probs, vals, idx = real_route(*args)
        picks.append(idx)
        return probs, vals, idx
    fused_moe.FusedMoE.__call__ = scoped
    if picks is not None:
        fused_moe.route = route
    try:
        yield
    finally:
        fused_moe.FusedMoE.__call__ = real_call
        fused_moe.route = real_route


def moe_decode_bytes(cfg: dict, touched: float) -> float:
    """The weight bytes (bf16) a decode step of a DeepSeek-MoE config
    reads, with `touched` routed experts a MoE layer: every attention
    projection, the dense layers' MLPs, each MoE layer's touched experts,
    shared experts and router, and the LM head (the KV read, under 1% at
    the profile's contexts, left out)."""
    h, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    d = h // cfg["num_attention_heads"]
    attn = (2 * cfg["num_attention_heads"] +
            2 * cfg["num_key_value_heads"]) * d * h
    moe_layers = layers - cfg["first_k_dense_replace"]
    inter = cfg["moe_intermediate_size"]
    per_moe = (touched + cfg["n_shared_experts"]) * 3 * h * inter + \
        cfg["n_routed_experts"] * h
    elems = layers * attn + cfg["first_k_dense_replace"] * 3 * h * \
        cfg["intermediate_size"] + moe_layers * per_moe + \
        cfg["vocab_size"] * h
    return 2 * elems


def run_mix_and_oracle_spec(engine, name: str, run, multi_steps,
                            spec: bool) -> None:
    """`run(multi_step, tag, tokens)` at each of `multi_steps` (the
    multi_step 1 run's tokens kept), then with `spec` once more with
    APHRODITE_SPEC=1 and an oracle drafter of those tokens: verify rows
    through the whole model, at least one verify dispatch required."""
    classic = {}
    for ms in multi_steps:
        run(ms, f"{name} ", classic if ms == 1 else None)
    if not spec:
        return
    refs = [mix_prompt(n, salt) + classic[f"m1-{rid}"]
            for rid, n, salt in MIX + MIX_LATE]
    ex = engine.executor
    real = ex.execute_spec_verify
    dispatches = []

    def verify(*a, **kw):
        dispatches.append(1)
        return real(*a, **kw)
    os.environ["APHRODITE_SPEC"] = "1"
    engine.drafter.propose = oracle_drafter(refs)
    ex.execute_spec_verify = verify
    drafted = {}
    try:
        run(1, f"{name} spec ", drafted)
    finally:
        del ex.execute_spec_verify, engine.drafter.propose
        os.environ["APHRODITE_SPEC"] = "0"
    if not dispatches:
        fail(f"{name}: APHRODITE_SPEC=1 made no verify dispatch")
    same = sum(drafted[rid] == toks for rid, toks in classic.items())
    log(f"{name} spec (oracle drafts of the multi_step 1 run's tokens): "
        f"{len(dispatches)} verify dispatches; {same} of {len(classic)} "
        "requests' tokens equal the classic run's (a reading: bf16 sums of "
        "other row counts may flip a near tie)")


def run_moe_engine(torch, counters, card: str, name: str, cfg: dict,
                   multi_steps=(1, 8), spec: bool = False,
                   profile: bool = False):
    """Phase 19 (c) / (d): the port's engine over `cfg` (bf16, dummy
    weights from seed 0, 32-token pages, max_model_len 2048) through
    phase 4's mix at each of `multi_steps` (APHRODITE_SPEC=0), then with
    `spec` once more with APHRODITE_SPEC=1 and drafts from an oracle of
    the multi_step 1 run's tokens (verify rows through the MoE FFN).
    Every request finishes with 32 tokens in the vocabulary; every
    engine step launches K1, K2, K3 and K4, summed, a positive multiple
    of the layer count; every page comes back. With `profile`, phase 19
    (e): a batch-8 decode step (wall and device ms, launches, the MoE
    FFN's device ms, host reads a step, experts touched a layer and the
    weight-bytes bound, peak memory) and a 2048-row prompt round (the
    MoE FFN's share). Returns the launches summed over the runs; the
    caller frees the engine once this returns."""
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.modeling.layers import fused_moe
    model_dir = os.path.join(HERE, "build", f"chip_smoke_{name}")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    pages = engine.cache_config.num_gpu_blocks
    log(f"{name} engine up in {time.perf_counter() - t0:.1f} s: "
        f"{cfg['num_hidden_layers']} layers, {pages} KV pages of 32 "
        f"tokens, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on {card}")
    layers = cfg["num_hidden_layers"]
    attention = ("paged_decode_attention", "write_kv_pages_prefill",
                 "write_kv_pages", "write_kv_pages_decode")
    summed = {}

    def run(ms, tag, tokens=None):
        reads = fused_moe.HOST_READS.count
        launches = run_engine(
            torch, engine, ms, counters, card, tag=tag, tokens=tokens,
            required=attention[:3], per_step=(attention, layers),
            vocab=cfg["vocab_size"])
        free = engine.scheduler.block_manager.get_num_free_gpu_blocks()
        if free != pages:
            fail(f"{tag}multi_step={ms}: {free} of {pages} pages back")
        log(f"{tag}multi_step={ms}: {fused_moe.HOST_READS.count - reads} "
            f"host reads of the MoE layers' group sizes; every page back")
        for k, n in launches.items():
            summed[k] = summed.get(k, 0) + n

    run_mix_and_oracle_spec(engine, name, run, multi_steps, spec)
    if profile:
        picks = []
        torch.cuda.reset_peak_memory_stats()
        with moe_scope(torch, picks):
            # 2 steps, not 4 (~5100 launches a step; cut for time).
            profile_decode(torch, engine, f"{name} ", width=f"{name} width",
                           scopes=("fused_moe",), counts=((
                               "MoE host reads (group sizes)",
                               fused_moe.HOST_READS),), steps=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        touched = [int(p.unique().numel()) for p in picks
                   if p.shape[0] == 8]
        mean = sum(touched) / len(touched)
        nbytes = moe_decode_bytes(cfg, mean)
        log(f"{name} batch-8 decode: {mean:.2f} of "
            f"{cfg['n_routed_experts']} routed experts touched a MoE layer "
            f"(48 picks; {len(touched)} layer calls); weight bytes a step "
            f"{nbytes / 1e9:.2f} GB, bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f}"
            f" ms (bytes); peak memory {peak:.2f} GiB on {card}")
        with moe_scope(torch):
            rows, steps, scoped = _profiled_prompt_round(
                torch, engine, f"{name} ", scopes=("fused_moe",))
        dev_ms = sum(us for us, _, _ in rows) / 1e3
        moe_ms = scoped["fused_moe"]
        log(f"{name} prompt round, 4 x 512 tokens: {steps} engine step(s), "
            f"device kernels {dev_ms:.3f} ms in "
            f"{sum(n for _, n, _ in rows)} launches; the MoE FFN (routing, "
            f"grouped products, combine) {moe_ms:.3f} ms (share "
            f"{moe_ms / dev_ms:.3f})")
    return summed


def run_moe_phase(torch, pa, kw, timer, counters, card: str,
                  only: str = "abcd"):
    """Phase 19's parts named in `only`: (a) `check_moe_kernels`, (b)
    `check_moe_two_layer`, (c) with (e) DeepSeek-MoE-16B whole, (d)
    Mixtral-8x7B at 2 of its 32 layers. Returns (launches by path,
    seconds by part)."""
    by_path, seconds = {}, {}
    engines = {"c": ("DeepSeek-MoE-16B", DEEPSEEK_MOE_16B,
                     dict(spec=True, profile=True)),
               "d": ("Mixtral-8x7B-2L",
                     dict(MIXTRAL_8X7B, num_hidden_layers=2),
                     dict(multi_steps=(1,)))}
    for part in only:
        t0 = time.perf_counter()
        if part == "a":
            check_moe_kernels(torch, pa, kw, timer)
        elif part == "b":
            check_moe_two_layer(torch, counters)
        else:
            name, cfg, kwargs = engines[part]
            by_path[name] = run_moe_engine(torch, counters, card, name, cfg,
                                           **kwargs)
            free_engine(torch, name)
        seconds[part] = round(time.perf_counter() - t0, 1)
    return by_path, seconds


# ---------------------------------------------- the other architectures --

# The published config.json files (Hugging Face hub; tokenizer and
# training-only keys left out) of Qwen/Qwen2-7B, microsoft/phi-2,
# EleutherAI/gpt-j-6b, EleutherAI/gpt-neox-20b and facebook/opt-6.7b.
QWEN2_7B = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151643, "hidden_act": "silu",
    "hidden_size": 3584, "initializer_range": 0.02,
    "intermediate_size": 18944, "max_position_embeddings": 131072,
    "max_window_layers": 28, "model_type": "qwen2",
    "num_attention_heads": 28, "num_hidden_layers": 28,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "sliding_window": 131072, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 152064,
}
PHI_2 = {
    "architectures": ["PhiForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 50256, "embd_pdrop": 0.0, "eos_token_id": 50256,
    "hidden_act": "gelu_new", "hidden_size": 2560, "initializer_range": 0.02,
    "intermediate_size": 10240, "layer_norm_eps": 1e-05,
    "max_position_embeddings": 2048, "model_type": "phi",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "partial_rotary_factor": 0.4, "qk_layernorm": False, "resid_pdrop": 0.1,
    "rope_scaling": None, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float16",
    "use_cache": True, "vocab_size": 51200,
}
GPT_J_6B = {
    "activation_function": "gelu_new", "architectures": ["GPTJForCausalLM"],
    "attn_pdrop": 0.0, "bos_token_id": 50256, "embd_pdrop": 0.0,
    "eos_token_id": 50256, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "model_type": "gptj", "n_embd": 4096,
    "n_head": 16, "n_inner": None, "n_layer": 28, "n_positions": 2048,
    "resid_pdrop": 0.0, "rotary": True, "rotary_dim": 64,
    "scale_attn_weights": True, "tie_word_embeddings": False,
    "use_cache": True, "vocab_size": 50400,
}
GPT_NEOX_20B = {
    "architectures": ["GPTNeoXForCausalLM"],
    "attention_probs_dropout_prob": 0, "bos_token_id": 0, "eos_token_id": 0,
    "hidden_act": "gelu_fast", "hidden_dropout_prob": 0, "hidden_size": 6144,
    "initializer_range": 0.02, "intermediate_size": 24576,
    "layer_norm_eps": 1e-05, "max_position_embeddings": 2048,
    "model_type": "gpt_neox", "num_attention_heads": 64,
    "num_hidden_layers": 44, "rotary_emb_base": 10000, "rotary_pct": 0.25,
    "tie_word_embeddings": False, "torch_dtype": "float16",
    "use_cache": True, "use_parallel_residual": True, "vocab_size": 50432,
}
OPT_6_7B = {
    "_remove_final_layer_norm": False, "activation_dropout": 0.0,
    "activation_function": "relu", "architectures": ["OPTForCausalLM"],
    "attention_dropout": 0.0, "bos_token_id": 2,
    "do_layer_norm_before": True, "dropout": 0.1, "eos_token_id": 2,
    "ffn_dim": 16384, "hidden_size": 4096, "init_std": 0.02,
    "layerdrop": 0.0, "max_position_embeddings": 2048, "model_type": "opt",
    "num_attention_heads": 32, "num_hidden_layers": 32, "pad_token_id": 1,
    "torch_dtype": "float16", "use_cache": True, "vocab_size": 50272,
    "word_embed_proj_dim": 4096,
}
# Deci/DeciLM-7B's widths (hidden 4096, 32 query heads, intermediate
# 14336, vocab 32000; model_type "deci", a LlamaConfig in remote code).
# Its published per-layer KV head list is not in the repository: this
# one, of three layers, takes 4, 2 and 1 heads (groups 8, 16 and 32).
DECILM_7B_WIDTH = {
    "architectures": ["DeciLMForCausalLM"], "model_type": "deci",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_hidden_layers": 3,
    "num_key_value_heads_per_layer": [4, 2, 1], "vocab_size": 32000,
    "max_position_embeddings": 8192, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "hidden_act": "silu",
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 1, "eos_token_id": 2,
}
# Phase 20 (a): (name, config, layers kept).
ARCH_MODELS = (("Qwen2-7B", QWEN2_7B, 2), ("Phi-2", PHI_2, 2),
               ("GPT-J-6B", GPT_J_6B, 2), ("GPT-NeoX-20B", GPT_NEOX_20B, 2),
               ("OPT-6.7B", OPT_6_7B, 2),
               ("DeciLM-7B width", DECILM_7B_WIDTH, 3))
# Phase 3d: (name, Hq, Hkv, head_dim).
ARCH_GEOMETRIES = (("Qwen2-7B", 28, 4, 128), ("Phi-2", 32, 32, 80),
                   ("GPT-NeoX-20B", 64, 64, 96), ("GPT-J-6B", 16, 16, 256),
                   ("DeciLM group 8", 32, 4, 128),
                   ("DeciLM group 16", 32, 2, 128),
                   ("DeciLM group 32", 32, 1, 128))
# The geometries at which phase 3d also holds K1's fp16 instances: group 1
# at head_dim 80, 96 and 256, and group 32 (two 16-row blocks).
FP16_GEOMETRIES = ("Phi-2", "GPT-NeoX-20B", "GPT-J-6B", "DeciLM group 32")
ATTENTION_COUNTERS = ("paged_decode_attention", "write_kv_pages_prefill",
                      "write_kv_pages", "write_kv_pages_decode")


def cut_layers(cfg: dict, layers: int) -> dict:
    """`cfg` at its first `layers` layers (GPT-J counts them in n_layer;
    DeciLM's per-layer list is cut with them)."""
    key = "n_layer" if "n_layer" in cfg else "num_hidden_layers"
    out = dict(cfg, **{key: layers})
    if "num_key_value_heads_per_layer" in cfg:
        out["num_key_value_heads_per_layer"] = \
            cfg["num_key_value_heads_per_layer"][:layers]
    return out


def check_k1_row_control(torch, pa, label: str):
    """K1 at B 64 x 2047 (bf16, 32-token pages, its policy's splits)
    within tolerance of the plain version, and a wrong plain version
    beyond it: the neighbouring kv head's K rows where the geometry has
    more than one, else (one kv head of 32 query rows, two row blocks)
    the plain version on the query with each head's rows rolled by 16,
    so a row block that read the other block's rows cannot pass."""
    ctxs = [2047] * 62 + [1000, 17]
    q, kp, vp, tb, ctx, _, _, _ = decode_problem(torch, ctxs, 32, 64,
                                                 seed=78)
    ppc = pa.choose_pages_per_chunk(64, 32, len(ctxs))
    work = pa.build_decode_work_list([-(-c // 32) for c in ctxs], ppc)
    n_split = pa.choose_decode_splits(len(ctxs), k1_heads(pa), 64, ppc,
                                      pa.sm_count("cuda"))
    kw = dict(scale=HEAD_DIM ** -0.5, pages_per_chunk=ppc)
    got = pa.paged_decode_attention(q, kp, vp, tb, ctx, work_items=work,
                                    **kw)
    good = pa.paged_decode_attention_plain(q, kp, vp, tb, ctx,
                                           num_splits=n_split, **kw)
    group = HQ // HKV
    if HKV > 1:
        what = "the neighbouring kv head's K rows"
        bad = pa.paged_decode_attention_plain(
            q, kp.roll(HEAD_DIM, 2), vp, tb, ctx, num_splits=n_split, **kw)
    else:
        what = "each head's query rows rolled by 16 (the other row block)"
        rolled = q.view(len(ctxs), HKV, group, HEAD_DIM).roll(16, 2)
        bad = pa.paged_decode_attention_plain(
            rolled.reshape(q.shape).contiguous(), kp, vp, tb, ctx,
            num_splits=n_split, **kw)
    torch.cuda.synchronize()
    err = (got.float() - good.float()).abs()
    c_err = (got.float() - bad.float()).abs()
    if bool((err > ATOL + RTOL * good.float().abs()).any()):
        fail(f"K1 {label} control case: max err {err.max().item()} against "
             "plain")
    if not bool((c_err > ATOL + RTOL * bad.float().abs()).any()):
        fail(f"K1 {label}: the control ({what}) is within tolerance of the "
             "kernel")
    log(f"K1 {label} control ({what}) missed: max err "
        f"{c_err.max().item():.4f} against {err.max().item():.4f} for the "
        f"plain version ({n_split} split(s), {pa.row_blocks(group)} row "
        f"block(s) a kv head)")


def check_arch_kernels(torch, pa, kw, timer):
    """Phase 3d: K1-K4 at the other architectures' attention geometries
    (`ARCH_GEOMETRIES`: Qwen2-7B's group 7, head_dim 80, 96 and 256 at
    group 1, DeciLM's groups 8, 16 and 32 at head_dim 128). At each: K1
    on the ragged grid with a work list, fused write on and off, at its
    forced split counts, on bf16, int8 and fp8 pages, 32-token pages, B
    1 x 2047 and B 64 (phase 3's tolerance), and its control
    (`check_k1_row_control`); K1's fused write at the 8-bit edges; K2
    and K3 / K4 exact with their controls (untimed); K1 timed at B 64 x
    2047 on each page type, and at B 8 (phase 4's decode batch) on bf16
    pages, beside its plain version, SDPA and the bound. At group 1 with
    head_dim 80, 96 and 256 and at group 32 (`FP16_GEOMETRIES`), K1's
    fp16 instances too: the same checks on fp16, int8 and fp8 pages
    under fp16 activations, the control, and K1 timed at B 64 x 2047 on
    fp16 pages. Returns K1's largest error (bf16 activations, fp16
    ones) and its times by (geometry, activations, page type, shape)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "n_split", "merges", "host_us")
    e2e_ctx = [1016, 316, 80, 1016, 316, 80, 28, 28]
    worst, worst16, times = 0.0, 0.0, {}
    for name, hq, hkv, d in ARCH_GEOMETRIES:
        t0 = time.perf_counter()
        with heads(hq, hkv, d):
            for page_dtype in (torch.bfloat16, torch.int8,
                               torch.float8_e5m2):
                worst = max(worst, check_decode_attention(
                    torch, pa, True, page_dtype, amlas=(True,),
                    alibis=(False,), page_sizes=(32,), batches=(1, 64)))
            check_k1_row_control(torch, pa, name)
            check_fused_write_edges(torch, pa, kw)
            check_and_time_writers(torch, kw, None, timed=False)
            arms = [("bfloat16", page_dtype) for page_dtype in (
                torch.bfloat16, torch.int8, torch.float8_e5m2)]
            if name in FP16_GEOMETRIES:
                with activations("float16"):
                    for page_dtype in (torch.float16, torch.int8,
                                       torch.float8_e5m2):
                        worst16 = max(worst16, check_decode_attention(
                            torch, pa, True, page_dtype, amlas=(True,),
                            alibis=(False,), page_sizes=(32,),
                            batches=(1, 64)))
                    check_k1_row_control(torch, pa, f"{name}{act_label()}")
                arms.append(("float16", torch.float16))
            for act, page_dtype in arms:
                kind = str(page_dtype).replace("torch.", "")
                shapes = (("B 64 x 2047", [2047] * 64, 64),) + (
                    (("B 8", e2e_ctx, 36),)
                    if page_dtype == torch.bfloat16 else ())
                for shape, ctxs, pps in shapes:
                    with activations(act):
                        t = dict(zip(keys, time_decode_attention(
                            torch, pa, timer, ctxs, 32, pps, fused=True,
                            page_dtype=page_dtype)))
                    times[(name, act, kind, shape)] = t
                    fastest = min(("K1", t["ms"]), ("plain", t["plain_ms"]),
                                  ("SDPA", t["library_ms"]),
                                  key=lambda kv: kv[1])[0]
                    under = "" if act == "bfloat16" else \
                        " under fp16 activations"
                    log(f"K1 at {name} (Hq {hq} / Hkv {hkv}, d {d}), {kind}"
                        f" pages{under} at {shape} (page 32, fused): kernel "
                        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                        f"sdpa {t['library_ms']:.4f} ms, bound "
                        f"{t['bound_ms']:.6f} ms ({t['bound_by']}); fastest "
                        f"{fastest}; {t['n_split']} split(s), "
                        f"{t['merges']} merge launch(es) a call")
        log(f"phase 3d {name}: {time.perf_counter() - t0:.1f} s")
    return worst, worst16, times


def arch_params(torch, model, seed: int, bias_width: float = 0.05):
    """`model`'s parameters on the card, U(-0.05, 0.05) as phase 3's
    2-layer model, norm weights 1, the q/k/v biases U(-bias_width,
    bias_width)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(dev)
    for key, bucket in params.items():
        for name, t in bucket.items():
            width = bias_width if (name == "bias" and
                                   key.endswith(".qkv_proj")) else 0.05
            t.uniform_(-width, width, generator=gen)
        if key.endswith(("norm", "ln_1", "ln_f")):
            bucket["weight"].fill_(1.0)
    return params


@contextlib.contextmanager
def rotary_swapped(model, attr: str, make):
    """Every layer's attention (`attr`) with its rotary embedding
    replaced by `make(old)` inside the block."""
    blocks = [getattr(layer, attr) for layer in model.layers]
    saved = [b.rotary for b in blocks]
    for b in blocks:
        b.rotary = make(b.rotary)
    try:
        yield
    finally:
        for b, r in zip(blocks, saved):
            b.rotary = r


def neox_interleaved(bucket, head_dim: int):
    """A de-interleaved NeoX qkv bucket ([Q | K | V] rows) put back in
    HF's per-head [q k v] order: the loader's step undone."""
    out = {}
    for name, t in bucket.items():
        heads = t.shape[0] // 3 // head_dim
        out[name] = t.view(3, heads, head_dim, *t.shape[1:]) \
            .transpose(0, 1).reshape(t.shape)
    return out


def arch_controls(name: str, model, params):
    """Phase 20 (a)'s control for a family: (param_controls,
    model_controls) for `compare_with_plain`, each of which must miss."""
    from aphrodite_tpu_torch.modeling.layers.rotary_embedding import get_rope
    if name == "Qwen2-7B":
        return {"the q/k/v biases dropped": {
            key: ({n: t for n, t in bucket.items() if n != "bias"}
                  if key.endswith(".qkv_proj") else bucket)
            for key, bucket in params.items()}}, {}
    if name == "GPT-NeoX-20B":
        d = model.layers[0].attention.head_dim
        return {"query_key_value left per-head interleaved": {
            key: (neox_interleaved(bucket, d)
                  if key.endswith(".qkv_proj") else bucket)
            for key, bucket in params.items()}}, {}
    if name == "OPT-6.7B":
        key = "model.decoder.embed_positions"
        return {"positions without OPT's +2 offset": dict(params, **{
            key: {"weight": params[key]["weight"].roll(2, 0)}})}, {}
    if name.startswith("DeciLM"):
        key = "model.layers.0.self_attn.qkv_proj"
        attn = model.layers[0].self_attn
        q, kv = attn.num_heads * attn.head_dim, \
            attn.num_kv_heads * attn.head_dim
        w = params[key]["weight"].clone()
        w[q:q + kv] = w[q:q + kv].roll(attn.head_dim, 0)
        return {"layer 0's K rows rolled by one of its 4 KV heads":
                dict(params, **{key: {"weight": w}})}, {}
    if name == "GPT-J-6B":
        return {}, {"rotary applied neox-style": lambda: rotary_swapped(
            model, "attn", lambda r: get_rope(
                r.head_size, r.rotary_dim, r.max_position_embeddings,
                r.base, is_neox_style=True))}
    return {}, {"rotary over the whole head (80 dims, not 32)":
                lambda: rotary_swapped(model, "self_attn", lambda r: get_rope(
                    r.head_size, r.head_size, r.max_position_embeddings,
                    r.base, is_neox_style=True))}


def check_arch_two_layer(torch, counters):
    """Phase 20 (a), the models: each family of `ARCH_MODELS` at its full
    width and 2 layers (DeciLM 3, KV heads 4, 2 and 1), weights
    `arch_params` (Qwen2's q/k/v biases U(-1, 1), as trained Qwen2
    biases are large), through the kernels vs through their plain
    versions (`compare_with_plain`: logits within 2e-2 of max |logit|),
    and the family's control (`arch_controls`), which must miss. The
    kernel run must launch K2 once a layer (the page-aligned prompt) and
    K1 once a layer in each of the 3 decode steps."""
    from aphrodite_tpu_torch.modeling.loader import _get_model_architecture
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    for name, base, layers in ARCH_MODELS:
        cfg = config_from_dict(cut_layers(base, layers))
        model = _get_model_architecture(cfg)(cfg, dtype=torch.bfloat16)
        params = arch_params(torch, model, seed=3,
                             bias_width=1.0 if name == "Qwen2-7B" else 0.05)
        param_controls, model_controls = arch_controls(name, model, params)
        k1, k2 = (counters[n] for n in ("paged_decode_attention",
                                        "write_kv_pages_prefill"))
        before = k1.count, k2.count
        compare_with_plain(torch, model, params, f"{name} {layers}-layer",
                           param_controls=param_controls,
                           model_controls=model_controls)
        if (k1.count - before[0], k2.count - before[1]) != \
                (3 * layers, layers):
            fail(f"{name} {layers}-layer: K1 / K2 launched "
                 f"{k1.count - before[0]} / {k2.count - before[1]} times, "
                 f"not {3 * layers} / {layers}")
        del model, params, param_controls, model_controls
        free_engine(torch, f"{name} {layers}-layer")


def check_gptq_qwen2(torch, counters):
    """Phase 20 (c): GPTQ W4A16 (4 bits, group 128) over a 2-layer
    Qwen2-7B at full width, random codes about a zero point of 8, scales
    in [3e-3, 6e-3), the q/k/v biases U(-4, 4) added after the kernel's
    product (at U(-1, 1) dropping them moved the logits by 1.8% of max
    |logit|, inside the tolerance, on an NVIDIA H100): a 96-row prompt
    (K6) and 3 decode steps (K7) through the kernels vs their plain
    versions (`compare_with_plain`, each GPTQ
    matmul also held to its plain version on the model's activations),
    with two controls: every GPTQ matmul of the kernel run against its
    plain version with the scales rolled by one group must miss phase
    8's tolerance (at the logits the roll moved them by only 1.9% of max
    |logit| on an NVIDIA H100, inside the 2e-2 bound), and the logits of
    the plain path without the biases must miss 2e-2."""
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQConfig)
    from aphrodite_tpu_torch.modeling.models.qwen2 import Qwen2ForCausalLM
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    cfg = config_from_dict(cut_layers(QWEN2_7B, 2))
    model = Qwen2ForCausalLM(cfg, dtype=torch.bfloat16,
                             linear_method=GPTQConfig(
                                 4, GPTQ_GS).get_linear_method())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(90)
    params = model.init_params(dev)
    for key, bucket in params.items():
        for name, t in bucket.items():
            if key.endswith("norm"):
                t.fill_(1.0)
            elif name == "qweight":
                t.random_(-2 ** 31, 2 ** 31, generator=gen)
            elif name == "qzeros":
                t.fill_(0x77777777)            # zero point 8, stored z - 1
            elif name == "scales":
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) *
                        3e-3 + 3e-3)
            elif name == "g_idx":
                t.copy_(torch.arange(t.numel(), device=dev) // GPTQ_GS)
            elif name == "bias":
                t.uniform_(-4.0, 4.0, generator=gen)
            else:
                t.uniform_(-0.05, 0.05, generator=gen)
    no_bias = {key: ({n: t for n, t in bucket.items() if n != "bias"}
                     if key.endswith(".qkv_proj") else bucket)
               for key, bucket in params.items()}
    k6, k7 = counters["gptq_matmul"], counters["gptq_matmul_stream"]
    before = k6.count, k7.count
    os.environ["APHRODITE_W4A8"] = "0"
    try:
        compare_with_plain(
            torch, model, params, "GPTQ W4A16 Qwen2-7B 2-layer",
            prompt_len=96,
            gptq_control=("the plain matmul with its scales rolled by one "
                          "group", lambda x, qw, qz, sc, *, bits, group_size:
                          qmm.gptq_matmul_plain(x, qw, qz,
                                                torch.roll(sc, 1, 0),
                                                bits=bits,
                                                group_size=group_size)),
            param_controls={"the q/k/v biases dropped": no_bias})
    finally:
        os.environ.pop("APHRODITE_W4A8")
    launched = k6.count - before[0], k7.count - before[1]
    # The kernel run: 4 projections a layer in the prompt round (m 96,
    # K6) and in each of the 3 decode steps (m 1, K7).
    if launched != (8, 24):
        fail(f"GPTQ Qwen2 2-layer: K6 / K7 launched {launched}, not (8, 24)")
    log(f"GPTQ W4A16 Qwen2-7B 2-layer: K6 / K7 launched {launched[0]} / "
        f"{launched[1]} times in the kernel run")
    del model, params, no_bias
    free_engine(torch, "GPTQ Qwen2 2-layer")


def decode_weight_bytes(params, skip=("embed_tokens", "embed_in", "wte")):
    """(Bytes of every parameter but the input embedding tables, which a
    decode step reads only its rows of, bytes of every parameter)."""
    read = total = 0
    for key, bucket in params.items():
        n = sum(t.numel() * t.element_size() for t in bucket.values())
        total += n
        if not key.endswith(skip):
            read += n
    return read, total


def run_arch_engine(torch, counters, card: str, name: str, cfg: dict,
                    multi_steps=(1,), spec: bool = False,
                    profile: bool = False):
    """Phase 20 (a)'s engine runs, and (b) with (d): the port's engine
    over `cfg` (bf16, dummy weights from seed 0, 32-token pages,
    max_model_len 2048) through phase 4's mix at each of `multi_steps`,
    then with `spec` once more with APHRODITE_SPEC=1 and oracle drafts
    (`run_mix_and_oracle_spec`). Every request finishes with 32 tokens in
    the vocabulary; every engine step launches K1, K2, K3 and K4, summed, a
    positive multiple of the layer count; K3 (the window branch's slot
    writer) launches only where the model has a window, which is logged;
    every page comes back. With `profile` a batch-8 decode step against
    the weights' bytes bound and a 2048-row prompt round. Returns the
    launches summed over the runs."""
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    model_dir = os.path.join(HERE, "build", "chip_smoke_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    pages = engine.cache_config.num_gpu_blocks
    layers = engine.model_config.hf_config.num_hidden_layers
    window = engine.model_config.get_sliding_window()
    read, total = decode_weight_bytes(engine.executor.params)
    log(f"{name} engine up in {time.perf_counter() - t0:.1f} s: {layers} "
        f"layers, {total / 1e9:.2f} GB of weights, {pages} KV pages of 32 "
        f"tokens (KV heads a layer "
        f"{sorted(set(engine.model_config.get_kv_heads_per_layer()))}), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on "
        f"{card}; sliding window {window}: "
        + ("none, so each decode step writes its tokens inside K1 (the "
           "fused write) and the window branch's K3 does not run"
           if window is None else "the runner's window branch (K3 and a "
           "read-only K1)"))
    summed = {}

    def run(ms, tag, tokens=None):
        launches = run_engine(
            torch, engine, ms, counters, card, tag=tag, tokens=tokens,
            required=ATTENTION_COUNTERS[:3],
            per_step=(ATTENTION_COUNTERS, layers),
            absent=("write_kv_pages_decode",) if window is None else (),
            vocab=cfg["vocab_size"])
        free = engine.scheduler.block_manager.get_num_free_gpu_blocks()
        if free != pages:
            fail(f"{tag}multi_step={ms}: {free} of {pages} pages back")
        for k, n in launches.items():
            summed[k] = summed.get(k, 0) + n

    run_mix_and_oracle_spec(engine, name, run, multi_steps, spec)
    if profile:
        torch.cuda.reset_peak_memory_stats()
        _, dev = profile_decode(torch, engine, f"{name} ",
                                width=f"{name} width")
        peak = torch.cuda.max_memory_allocated() / 2**30
        read_ms = read / HBM_BYTES_PER_S * 1e3
        log(f"{name} batch-8 decode step: weights {total / 1e9:.2f} GB "
            f"(bound {total / HBM_BYTES_PER_S * 1e3:.3f} ms), of which a "
            f"step reads {read / 1e9:.2f} GB (all but the input embedding; "
            f"bound {read_ms:.3f} ms); device {dev / read_ms:.2f}x the read "
            f"bound; peak memory {peak:.2f} GiB on {card}")
        rows, steps, _ = _profiled_prompt_round(torch, engine, f"{name} ")
        dev_ms = sum(us for us, _, _ in rows) / 1e3
        attn_ms = sum(us for us, _, k in rows if "kv_write" in k or
                      "paged_decode" in k) / 1e3
        log(f"{name} prompt round, 4 x 512 tokens: {steps} engine step(s), "
            f"device kernels {dev_ms:.3f} ms in "
            f"{sum(n for _, n, _ in rows)} launches; the page writers "
            f"{attn_ms:.3f} ms")
    del engine
    return summed


def run_arch_phase(torch, counters, card: str, only: str = "abc"):
    """Phase 20's parts named in `only`: (a) `check_arch_two_layer`, then
    each 2-layer model of `ARCH_MODELS` through the mix at multi_step 1
    (`run_arch_engine`); (b) with (d) Qwen2-7B whole at multi_step 1 and
    8, with oracle-drafted verify rounds, profiled; (c)
    `check_gptq_qwen2`. Returns (launches by path, seconds by part)."""
    by_path, seconds = {}, {}
    for part in only:
        t0 = time.perf_counter()
        if part == "a":
            check_arch_two_layer(torch, counters)
            for name, base, layers in ARCH_MODELS:
                path = f"{name} {layers}-layer"
                by_path[path] = run_arch_engine(
                    torch, counters, card, path, cut_layers(base, layers))
                free_engine(torch, path)
        elif part == "b":
            by_path["Qwen2-7B"] = run_arch_engine(
                torch, counters, card, "Qwen2-7B", QWEN2_7B,
                multi_steps=(1, 8), spec=True, profile=True)
            free_engine(torch, "Qwen2-7B")
        elif part == "c":
            check_gptq_qwen2(torch, counters)
        seconds[part] = round(time.perf_counter() - t0, 1)
    return by_path, seconds


# ---------------------------------------------- the fallback route (21) --

# The counters of every quantized matmul wrapper and of K9.
QUANT_COUNTERS = ("gptq_matmul", "gptq_matmul_stream", "gptq_matmul_a8",
                  "gptq_matmul_stream_a8", "quantize_activations_int8",
                  "awq_matmul", "awq_matmul_stream", "awq_matmul_a8",
                  "awq_matmul_stream_a8") + GGUF_MATMULS + GGUF_GEMMS + \
    LATE_MATMULS + tuple(LATE_GEMMS.values())
FALLBACK_MS = (1, 8, 64, 2048)
# Phase 21 (c)'s bound on |fallback - kernels| over max |logit|: both
# routes round the same dequantized weight to bf16 ((q - z) s in f32,
# then rounded) and sum its products in f32, in another order; each
# projection's bf16 output may then round to a neighbouring value (2^-8
# relative), and 2 layers carry such steps to the logits. 2e-2 is about
# five bf16 ulps of the largest logit, the bound phase 3 holds the
# kernel path to against the plain one for the same reason.
ROUTE_BOUND = 2e-2
# The quantize_config of TheBloke/Mistral-7B-v0.1-GPTQ's
# gptq-4bit-32g-actorder_True branch.
GPTQ_ACT_ORDER = {"quant_method": "gptq", "bits": 4, "group_size": 32,
                  "desc_act": True, "sym": True}
# The quantization_config of Qwen/Qwen2-7B-Instruct-AWQ.
QWEN2_AWQ = {"quant_method": "awq", "bits": 4, "group_size": 128,
             "zero_point": True, "version": "gemm"}


def act_order_g_idx(torch, K: int, gs: int, gen):
    """A seeded act-order assignment: a permutation of arange(K) // gs on
    the card, so every group holds exactly gs rows."""
    groups = torch.arange(K, device="cuda", dtype=torch.int32) // gs
    return groups[torch.randperm(K, generator=gen, device="cuda")]


def unpacked_f64(torch, words, bits: int, along_rows: bool, awq=False):
    """int32 words -> their codes as float64 on the card (this script's
    own unpacking, beside the port's): GPTQ codes along rows (qweight) or
    columns (qzeros), 32 // bits a word, code p at shift p * bits; AWQ
    columns 8j + e at shift 4 * AWQ_ORDER[e]."""
    w = words.long()
    if awq:
        shifts = torch.tensor([4 * p for p in (0, 4, 1, 5, 2, 6, 3, 7)],
                              device=w.device)
    else:
        shifts = torch.arange(32 // bits, device=w.device) * bits
    mask = (1 << (4 if awq else bits)) - 1
    if along_rows:
        codes = (w[:, None, :] >> shifts[None, :, None]) & mask
        return codes.reshape(-1, w.shape[1]).double()
    codes = (w[:, :, None] >> shifts[None, None, :]) & mask
    return codes.reshape(w.shape[0], -1).double()


def f64_weight(torch, arm: str, params, bits: int, gs: int):
    """The layer's weight [K, N] in float64 from its codes: GPTQ rows in
    groups g_idx (zeros stored minus one), AWQ rows in groups k // gs.
    Every entry (q - z) s is exact in f32 (a code difference of at most
    5 bits times a bf16 scale)."""
    if arm == "awq":
        q = unpacked_f64(torch, params["qweight"], 4, False, awq=True)
        z = unpacked_f64(torch, params["qzeros"], 4, False, awq=True)
        g = torch.arange(q.shape[0], device=q.device) // gs
    else:
        q = unpacked_f64(torch, params["qweight"], bits, True)
        z = unpacked_f64(torch, params["qzeros"], bits, False) + 1
        g = params["g_idx"].long()
    return (q - z[g]) * params["scales"].double()[g]


def fallback_arms(torch):
    """(label, method, bits, group, params builder) of phase 21 (a)'s
    three arms; the builder takes (K, N, seed) and returns the layer's
    parameters on the card: random codes and zeros, scales in [0.002,
    0.022) (`quant_weights`), and for GPTQ g_idx (an act-order
    assignment for the group-32 arm, arange(K) // 128 for 2 bits)."""
    from aphrodite_tpu_torch.modeling.layers.quantization.awq import (
        AWQConfig)
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQConfig)

    def gptq(bits, gs, desc_act):
        def build(K, N, seed):
            qw, qz, sc = quant_weights(torch, K, N, bits, seed, False, gs)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            g_idx = act_order_g_idx(torch, K, gs, gen) if desc_act else \
                torch.arange(K, device="cuda", dtype=torch.int32) // gs
            return {"qweight": qw, "qzeros": qz, "scales": sc,
                    "g_idx": g_idx}
        return GPTQConfig(bits, gs, desc_act).get_linear_method(), build

    def awq(gs):
        def build(K, N, seed):
            qw, qz, sc = quant_weights(torch, K, N, 4, seed, True, gs)
            return {"qweight": qw, "qzeros": qz, "scales": sc}
        return AWQConfig(4, gs).get_linear_method(), build
    return (("GPTQ 4-bit g32 act-order", "gptq", 4, 32) + gptq(4, 32, True),
            ("GPTQ 2-bit g128", "gptq", 2, 128) + gptq(2, 128, False),
            ("AWQ g64", "awq", 4, 64) + awq(64))


def fallback_control(torch, arm: str, params, gs: int):
    """The wrong parameters a control feeds the fallback: GPTQ's g_idx
    rolled by one group of rows, AWQ's zero rows shifted by one group."""
    if arm == "awq":
        return dict(params, qzeros=torch.roll(params["qzeros"], 1, 0))
    return dict(params, g_idx=torch.roll(params["g_idx"], gs))


def check_and_time_fallback(torch, timer, counters, card: str):
    """Phase 21 (a): each arm of `fallback_arms` at Mistral-7B's four
    projections, m 1, 8, 64 and 2048, through the engine's own `apply`
    on the card (the fallback: the gates refuse act-order, 2 bits and
    groups of 64) against a float64 dequantize-and-matmul on the card
    from the same codes (`f64_weight`, rounded to bf16 as the route's
    weight is), within phase 8's tolerance; its
    control (`fallback_control`) must miss it. No quantized wrapper may
    launch. Timed as phase 8 (median of 20, L2 flushed, host time held
    out) beside the group-128 4-bit kernel route of the same layout at
    the same shape (its `apply`: K7 at m <= 64, K6 / K10 above) and
    torch.matmul over the weight dequantized beforehand. Returns the
    times {(arm, proj, m): (fallback, kernel, matmul)} in ms."""
    from aphrodite_tpu_torch.modeling.layers.quantization.awq import (
        AWQConfig)
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQConfig)
    os.environ["APHRODITE_W4A8"] = "0"
    times, worst, unrounded = {}, {}, {}
    try:
        for a, (label, arm, bits, gs, method, build) in enumerate(
                fallback_arms(torch)):
            kmethod = (AWQConfig(4, GPTQ_GS) if arm == "awq" else
                       GPTQConfig(4, GPTQ_GS)).get_linear_method()
            for p, (proj, K, N) in enumerate(GPTQ_PROJ):
                params = build(K, N, 500 + 10 * a + p)
                kq = quant_weights(torch, K, N, 4, 600 + 10 * a + p,
                                   arm == "awq")
                kparams = dict(zip(("qweight", "qzeros", "scales"), kq))
                if arm != "awq":
                    kparams["g_idx"] = torch.arange(
                        K, device="cuda", dtype=torch.int32) // GPTQ_GS
                # The route's weight is the dequantized one rounded to
                # x's dtype, as the JAX package's `dequantize(params,
                # x.dtype)` defines it: the reference rounds it the same
                # way and takes the products and sums in float64.
                # Against the unrounded weight (logged, not held) the
                # bf16 rounding of W alone misses phase 8's tolerance.
                exact = f64_weight(torch, arm, params, bits, gs)
                w64 = exact.to(torch.bfloat16).double()
                bad = fallback_control(torch, arm, params, gs)
                w16 = method.dequantize(params, torch.bfloat16)
                gen = torch.Generator(device="cuda").manual_seed(700 + p)
                x_all = torch.randn(max(FALLBACK_MS), K, generator=gen,
                                    device="cuda").to(torch.bfloat16)
                for m in FALLBACK_MS:
                    x = x_all[:m]
                    for c in counters.values():
                        c.reset()
                    got = method.apply(params, x)
                    ref = (x.double() @ w64).float()
                    err = check_close(torch, got, ref,
                                      f"fallback {label} {proj} m={m}")
                    worst[label] = max(worst.get(label, 0.0), err)
                    unrounded[label] = max(unrounded.get(label, 0.0), (
                        got.double() - x.double() @ exact).abs().max().item())
                    miss = (method.apply(bad, x).float() - ref).abs()
                    if not bool((miss > ATOL + RTOL * ref.abs()).any()):
                        fail(f"fallback {label} {proj} m={m}: the control "
                             "is within tolerance of the f64 reference")
                    launched = {n: counters[n].count for n in QUANT_COUNTERS
                                if counters[n].count}
                    if launched:
                        fail(f"fallback {label} {proj} m={m}: quantized "
                             f"wrappers launched {launched}")
                    if not kmethod.uses_kernels(kparams, x):
                        fail(f"fallback {label} {proj}: the group-128 "
                             "comparison layer does not take the kernels")
                    times[(label, proj, m)] = (
                        timer(lambda: method.apply(params, x)),
                        timer(lambda: kmethod.apply(kparams, x)),
                        timer(lambda: x @ w16))
                del w64, exact, w16, x_all
                torch.cuda.empty_cache()
    finally:
        os.environ.pop("APHRODITE_W4A8")
    log(f"phase 21 (a) fallback route vs float64 over the bf16 weight on "
        f"{card}: max err {json.dumps(worst)} (tolerance {ATOL} + "
        f"{RTOL}|ref|); against float64 over the unrounded weight (a "
        f"reading, not held) {json.dumps(unrounded)}; every control (GPTQ "
        "g_idx rolled by one group, AWQ zeros shifted by one group) "
        "missed; no quantized wrapper launched")
    for (label, proj, m), (fb, kr, mm) in times.items():
        log(f"fallback {label} {proj} m={m}: fallback {fb:.4f} ms, "
            f"group-128 kernel route {kr:.4f} ms, torch.matmul over the "
            f"dequantized weight {mm:.4f} ms ({fb / kr:.1f}x the kernel "
            f"route) on {card}")
    for label in worst:
        for m in FALLBACK_MS:
            fb, kr, mm = (sum(times[(label, proj, m)][i]
                              for proj, _, _ in GPTQ_PROJ) for i in range(3))
            log(f"fallback {label}, one layer's four projections at m={m}: "
                f"fallback {fb:.4f} ms, kernel route {kr:.4f} ms, "
                f"torch.matmul {mm:.4f} ms on {card}")
    return times


@contextlib.contextmanager
def fallback_scope(torch):
    """Every GPTQ and AWQ `apply` that takes the dequantize route inside a
    torch.profiler range "quant_fallback" (the kernel route outside)."""
    from aphrodite_tpu_torch.modeling.layers.quantization import awq, gptq
    classes = (gptq.GPTQLinearMethod, awq.AWQLinearMethod)
    real = {cls: cls.apply for cls in classes}

    def scoped(real_apply):
        def apply(self, params, x):
            if self.uses_kernels(params, x):
                return real_apply(self, params, x)
            with torch.profiler.record_function("quant_fallback"):
                return real_apply(self, params, x)
        return apply
    for cls in classes:
        cls.apply = scoped(real[cls])
    try:
        yield
    finally:
        for cls in classes:
            cls.apply = real[cls]


def profile_fallback_engine(torch, engine, tag: str, card: str,
                            width: str, prompt: bool = True):
    """A batch-8 decode step (and with `prompt` a 2048-row prompt round)
    of a fallback engine under torch.profiler: wall and device ms, the
    dequantize route's share (`fallback_scope`) and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    with fallback_scope(torch):
        wall, dev = profile_decode(torch, engine, tag, width=width,
                                   scopes=("quant_fallback",))
        out = {"decode_wall_ms": wall, "decode_device_ms": dev}
        if prompt:
            rows, steps, scoped = _profiled_prompt_round(
                torch, engine, tag, scopes=("quant_fallback",))
            dev_ms = sum(us for us, _, _ in rows) / 1e3
            log(f"{tag}prompt round, 4 x 512 tokens at {width}: {steps} "
                f"engine step(s), device kernels {dev_ms:.3f} ms, of which "
                f"the dequantize route {scoped['quant_fallback']:.3f} ms "
                f"(share {scoped['quant_fallback'] / dev_ms:.3f}) on {card}")
            out.update(prompt_device_ms=dev_ms,
                       prompt_fallback_ms=scoped["quant_fallback"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag}peak memory {peak:.2f} GiB over the profiles on {card}")
    return out


def quant_config_dir(name: str, cfg: dict, quant: dict) -> str:
    path = os.path.join(HERE, "build", f"chip_smoke_{name}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg, quantization_config=quant), f)
    return path


def run_act_order_engine(torch, counters, card: str, layers: int):
    """Phase 21 (b): GPTQ_ACT_ORDER over MISTRAL_7B (its width, `layers`
    layers), bf16, dummy weights from seed 0, every layer's g_idx then
    overwritten with an act-order assignment; phase 4's mix at
    multi_step 1 (W4A16): every request finishes, K1, K2 and K4 launch,
    no GPTQ kernel nor K9 does; then profiled. Returns the launches."""
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    path = quant_config_dir("gptq_actorder", dict(
        MISTRAL_7B, num_hidden_layers=layers), GPTQ_ACT_ORDER)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=path, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 0
    for bucket in engine.executor.params.values():
        if "g_idx" in bucket:
            bucket["g_idx"].copy_(act_order_g_idx(
                torch, bucket["g_idx"].shape[0], 32, gen))
            n += 1
    log(f"GPTQ act-order engine ({layers} layers, group 32, desc_act) up in "
        f"{time.perf_counter() - t0:.1f} s: {n} layers' g_idx made "
        f"act-order, {engine.cache_config.num_gpu_blocks} KV pages of 32 "
        f"tokens, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"on {card}")
    os.environ["APHRODITE_W4A8"] = "0"
    try:
        launches = run_engine(torch, engine, 1, counters, card,
                              required=("paged_decode_attention",
                                        "write_kv_pages_prefill",
                                        "write_kv_pages"),
                              absent=QUANT_COUNTERS, tag="GPTQ act-order ")
        profile = profile_fallback_engine(
            torch, engine, "GPTQ act-order ", card,
            f"Mistral-7B width, {layers} layers")
    finally:
        os.environ.pop("APHRODITE_W4A8")
    del engine
    free_engine(torch, "GPTQ act-order")
    return launches, profile


def forced_logits(torch, model, params, tokens, prompt_len: int):
    """Teacher-forced logits of `model` at every position of `tokens`: a
    prompt of its first `prompt_len` tokens (every row's logits), then
    one decode step a further token, fed that token; [len(tokens),
    vocab] in f32."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                     SequenceGroupMetadata)
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    cfg = model.config
    dev = torch.device("cuda")

    class _Cfg:
        def get_vocab_size(self):
            return cfg.vocab_size

        def get_sliding_window(self):
            return None
    page_size, num_pages = 32, 16
    runner = ModelRunner(model, params, _Cfg(), None, page_size,
                         num_pages * page_size, dev)
    kv = [(torch.zeros(num_pages, page_size, width, dtype=torch.bfloat16,
                       device=dev),
           torch.zeros(num_pages, page_size, width, dtype=torch.bfloat16,
                       device=dev)) for width in kv_row_widths(model)]
    table = [3, 9, 4, 12]
    rows = []
    for n in range(prompt_len - 1, len(tokens)):
        prompt = n == prompt_len - 1
        data = SequenceData(list(tokens[:n + 1]) if prompt
                            else list(tokens[:n]))
        if not prompt:
            data.append_token_id(tokens[n], 0.0)
        md = SequenceGroupMetadata("0", prompt, {0: data},
                                   SamplingParams(temperature=0.0),
                                   {0: table}, {0: {}})
        inputs, _ = (runner._prepare_prompt([md]) if prompt
                     else runner._prepare_decode([md]))
        meta = inputs["metadata"].replace(is_prompt=prompt)
        sel = torch.arange(prompt_len, device=dev) if prompt \
            else inputs["sel"]
        logits, kv = runner._logits(params, inputs["input_ids"],
                                    inputs["positions"], kv, meta, sel)
        rows.append(logits[:prompt_len if prompt else 1].float())
    torch.cuda.synchronize()
    return torch.cat(rows)


def check_route_agreement(torch, counters, card: str):
    """Phase 21 (c): a 2-layer GPTQ Llama at Mistral-7B width (4 bits,
    group 128, no act-order, g_idx = arange(K) // 128 as real desc_act
    False checkpoints store it; random codes and zeros, scales in [3e-3,
    6e-3), other weights U(-0.05, 0.05), norms 1): teacher-forced logits
    along 99 fixed tokens (a 96-row prompt, every row, then 3 decode
    steps) with APHRODITE_DISABLE_PALLAS_QUANT=0 (K6 and K7) and =1 (the
    fallback) within ROUTE_BOUND of max |logit|; the fallback with every
    g_idx rolled by one group must miss it."""
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQConfig)
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    cfg = config_from_dict(dict(MISTRAL_7B, num_hidden_layers=2))
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                             linear_method=GPTQConfig(
                                 4, GPTQ_GS).get_linear_method())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(91)
    params = model.init_params(dev)
    for key, bucket in params.items():
        for name, t in bucket.items():
            if key.endswith("norm"):
                t.fill_(1.0)
            elif name in ("qweight", "qzeros"):
                t.random_(-2 ** 31, 2 ** 31, generator=gen)
            elif name == "scales":
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) *
                        3e-3 + 3e-3)
            elif name == "g_idx":
                t.copy_(torch.arange(t.numel(), device=dev) // GPTQ_GS)
            else:
                t.uniform_(-0.05, 0.05, generator=gen)
    rolled = {key: (dict(bucket, g_idx=torch.roll(bucket["g_idx"], GPTQ_GS))
                    if "g_idx" in bucket else bucket)
              for key, bucket in params.items()}
    tokens = [(i * 37 + 11) % 32000 for i in range(99)]
    runs = {}
    os.environ["APHRODITE_W4A8"] = "0"
    try:
        for label, flag, p in (("kernels", "0", params),
                               ("fallback", "1", params),
                               ("fallback, g_idx rolled", "1", rolled)):
            os.environ["APHRODITE_DISABLE_PALLAS_QUANT"] = flag
            for c in counters.values():
                c.reset()
            runs[label] = forced_logits(torch, model, p, tokens, 96)
            runs[label + " launches"] = (counters["gptq_matmul"].count,
                                         counters["gptq_matmul_stream"].count)
    finally:
        os.environ.pop("APHRODITE_DISABLE_PALLAS_QUANT")
        os.environ.pop("APHRODITE_W4A8")
    # Kernel route: 4 projections x 2 layers in the prompt (K6) and in
    # each of 3 decode steps (K7); the fallback none.
    if runs["kernels launches"] != (8, 24) or \
            runs["fallback launches"] != (0, 0):
        fail(f"phase 21 (c): K6 / K7 launches {runs['kernels launches']} "
             f"(kernels) and {runs['fallback launches']} (fallback), not "
             "(8, 24) and (0, 0)")
    want = runs["kernels"]
    scale = want.abs().max().item()
    rel = (runs["fallback"] - want).abs().max().item() / scale
    ctl = (runs["fallback, g_idx rolled"] - want).abs().max().item() / scale
    same = int((runs["fallback"].argmax(-1) == want.argmax(-1)).sum())
    log(f"phase 21 (c) route agreement at Mistral-7B width, 2 layers, 99 "
        f"teacher-forced positions on {card}: fallback vs kernels max "
        f"|diff| {rel:.3e} of max |logit| {scale:.3f} (bound {ROUTE_BOUND}); "
        f"argmax equal at {same} of {want.shape[0]}; control, g_idx rolled "
        f"by one group: {ctl:.3e} (must exceed the bound)")
    if not torch.isfinite(runs["fallback"]).all() or rel > ROUTE_BOUND:
        fail(f"phase 21 (c): the routes differ by {rel} of max |logit|")
    if ctl <= ROUTE_BOUND:
        fail(f"phase 21 (c): the comparison cannot see g_idx rolled by one "
             f"group: {ctl} <= {ROUTE_BOUND}")
    del model, params, rolled
    free_engine(torch, "phase 21 (c) 2-layer")


def run_qwen2_awq_engine(torch, counters, card: str, layers: int):
    """Phase 21 (d): QWEN2_7B (`layers` layers) with QWEN2_AWQ, bf16,
    dummy weights from seed 0, phase 4's mix at multi_step 1 under W4A16:
    every request finishes; gate_up (out 37888, a multiple of 1024) runs
    K7's AWQ layout or K10, once a layer every engine step; qkv (4608), o
    and down (3584) take the fallback; no K9, no AWQ a8 arm, no GPTQ
    kernel. Logs each projection's route; profiles a batch-8 decode step.
    Returns the launches."""
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config)
    path = quant_config_dir("qwen2_awq", cut_layers(QWEN2_7B, layers),
                            QWEN2_AWQ)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=path, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    method = get_quantization_config(engine.model_config).get_linear_method()
    x = torch.zeros(1, 1, dtype=torch.bfloat16, device="cuda")
    routes = {key.rsplit(".", 1)[-1]: (
        tuple(bucket["scales"].shape), "kernels"
        if method.uses_kernels(bucket, x) else "fallback")
        for key, bucket in engine.executor.params.items()
        if key.startswith("model.layers.0.") and "qweight" in bucket}
    log(f"Qwen2-7B-AWQ engine ({layers} layers) up in "
        f"{time.perf_counter() - t0:.1f} s on {card}: layer 0's routes "
        f"(scales shape, route) {routes}; "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens")
    want = {"qkv_proj": "fallback", "o_proj": "fallback",
            "gate_up_proj": "kernels", "down_proj": "fallback"}
    if {k: r for k, (_, r) in routes.items()} != want:
        fail(f"Qwen2-7B-AWQ: routes {routes}, expected {want}")
    gate_up = ("awq_matmul", "awq_matmul_stream")
    os.environ["APHRODITE_W4A8"] = "0"
    try:
        launches = run_engine(
            torch, engine, 1, counters, card, tag="Qwen2-7B-AWQ ",
            required=("paged_decode_attention", "write_kv_pages_prefill")
            + gate_up, absent=tuple(n for n in QUANT_COUNTERS
                                    if n not in gate_up),
            per_step=(gate_up, layers), vocab=QWEN2_7B["vocab_size"])
        profile = profile_fallback_engine(
            torch, engine, "Qwen2-7B-AWQ ", card,
            f"Qwen2-7B width, {layers} layers", prompt=False)
    finally:
        os.environ.pop("APHRODITE_W4A8")
    del engine
    free_engine(torch, "Qwen2-7B-AWQ")
    return launches, profile


def other_format_layers(torch):
    """Phase 21 (e)'s layers [(label, in, linear method, params on the
    CPU, activation dtype)] and the generator for their x. bf16 at
    shapes a gate refuses: GGUF q8_0, q6_k and q4_k buckets at in 384,
    SqueezeLLM and int8 at 384 x 384, QuIP#'s int8 form at hidden 128;
    float32 at shapes the gates take (the kernels take bf16 only): GPTQ,
    AWQ, GGUF q8_0 and int8."""
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config_cls)
    from aphrodite_tpu_torch.modeling.layers.quantization.quip import (
        QuipConfig)
    gen = torch.Generator().manual_seed(21)
    bf, f32 = torch.bfloat16, torch.float32

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int64).to(torch.int8)

    def unit(*shape, lo=1e-3, hi=4e-3, dtype=bf):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).to(dtype)

    def method(name):
        return get_quantization_config_cls(name).default().get_linear_method()
    layers = [
        ("GGUF q8_0 (384, 256) bf16", 384, method("gguf"),
         {"qs": i8(384, 256), "d": unit(12, 256)}, bf),
        ("GGUF q6_k (384, 256) bf16", 384, method("gguf"),
         {"qs": i8(384, 256), "d16": unit(24, 256)}, bf),
        ("GGUF q4_k (384, 256) bf16", 384, method("gguf"),
         {"qweight": words(48, 256), "dl": unit(12, 256),
          "ml": unit(12, 256, lo=8e-3, hi=3.2e-2)}, bf),
        ("SqueezeLLM (384, 384) bf16", 384, method("squeezellm"),
         {"qweight": words(48, 384),
          "lookup_table": (torch.randn(384, 16, generator=gen) * 0.02
                           ).to(bf)}, bf),
        ("int8 (384, 384) bf16", 384, method("int8"),
         {"weight": i8(384, 384), "scales": unit(384, lo=1e-4, hi=5e-4,
                                                  dtype=f32)}, bf),
        ("QuIP# int8 form (128, 128) bf16", 128,
         QuipConfig().get_linear_method(),
         {"weight": (torch.randint(0, 12, (128, 128), generator=gen) * 2
                     - 11).to(torch.int8),
          "Wscale": torch.tensor(0.05), "SU": (torch.randint(
              0, 2, (128,), generator=gen) * 2 - 1).to(bf),
          "SV": (torch.randint(0, 2, (128,), generator=gen) * 2 - 1
                 ).to(bf)}, bf),
        ("GPTQ 4-bit g128 (1024, 1024) f32", 1024, method("gptq"),
         {"qweight": words(128, 1024), "qzeros": words(8, 128),
          "scales": unit(8, 1024, lo=2e-3, hi=2.2e-2, dtype=f32),
          "g_idx": torch.arange(1024, dtype=torch.int32) // 128}, f32),
        ("AWQ g128 (1024, 1024) f32", 1024, method("awq"),
         {"qweight": words(1024, 128), "qzeros": words(8, 128),
          "scales": unit(8, 1024, lo=2e-3, hi=2.2e-2, dtype=f32)}, f32),
        ("GGUF q8_0 (1024, 1024) f32", 1024, method("gguf"),
         {"qs": i8(1024, 1024), "d": unit(32, 1024, dtype=f32)}, f32),
        ("int8 (1024, 1024) f32", 1024, method("int8"),
         {"weight": i8(1024, 1024),
          "scales": unit(1024, lo=1e-4, hi=5e-4, dtype=f32)}, f32),
    ]
    return layers, gen


def check_other_formats(torch, counters, card: str):
    """Phase 21 (e): each of `other_format_layers` through its method's
    `apply` on the card against the same `apply` on the CPU at m 1, 5 and
    72: bf16 within phase 8's tolerance, f32 within 1e-4 of max |CPU|;
    no quantized wrapper launches (the gates refuse the bf16 shapes, the
    kernels take no f32 activations)."""
    worst = {}
    layers, gen = other_format_layers(torch)
    for label, K, method, params, dtype in layers:
        card_params = {n: t.cuda() for n, t in params.items()}
        for m in (1, 5, 72):
            x = torch.randn(m, K, generator=gen).to(dtype)
            for c in counters.values():
                c.reset()
            got = method.apply(card_params, x.cuda()).cpu()
            launched = {n: counters[n].count for n in QUANT_COUNTERS
                        if counters[n].count}
            if launched:
                fail(f"phase 21 (e) {label}: wrappers launched {launched}")
            want = method.apply(params, x)
            if got.dtype != dtype or got.shape != want.shape:
                fail(f"phase 21 (e) {label}: {got.dtype} {tuple(got.shape)}"
                     f" on the card, {want.dtype} {tuple(want.shape)} on "
                     "the CPU")
            if dtype == torch.float32:
                err = (got - want).abs().max().item() / \
                    want.abs().max().item()
                if not math.isfinite(err) or err > F32_RTOL:
                    fail(f"phase 21 (e) {label} m={m}: {err} of max |CPU| "
                         f"(tolerance {F32_RTOL})")
            else:
                err = check_close(torch, got, want,
                                  f"phase 21 (e) {label} m={m}")
            worst[label] = max(worst.get(label, 0.0), err)
    log(f"phase 21 (e) the other formats' fallback on the card vs the CPU "
        f"(m 1, 5, 72; bf16 max abs err, f32 max err of max |CPU|) on "
        f"{card}: {json.dumps(worst)}; no quantized wrapper launched")


def run_fallback_phase(torch, counters, card: str, only: str = "abcde",
                       act_order_layers: int = 32, qwen2_layers: int = 28):
    """Phase 21's parts named in `only`. Returns (launches by path,
    seconds by part)."""
    by_path, seconds = {}, {}
    timer = Timer(torch)
    for part in only:
        t0 = time.perf_counter()
        if part == "a":
            check_and_time_fallback(torch, timer, counters, card)
        elif part == "b":
            by_path["GPTQ act-order"], _ = run_act_order_engine(
                torch, counters, card, act_order_layers)
        elif part == "c":
            check_route_agreement(torch, counters, card)
        elif part == "d":
            by_path["Qwen2-7B-AWQ"], _ = run_qwen2_awq_engine(
                torch, counters, card, qwen2_layers)
        elif part == "e":
            check_other_formats(torch, counters, card)
        seconds[part] = round(time.perf_counter() - t0, 1)
    return by_path, seconds



# ------------------------------------------------ float16 end to end --

def fp16_engine(torch, name: str, cfg: dict, **kw):
    """An engine at `dtype="float16"` over `cfg` (its checkpoint's
    torch_dtype float16), dummy weights from seed 0, 32-token pages;
    fails unless the model and its pages (or the 8-bit ones asked for)
    are fp16."""
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    path = os.path.join(HERE, "build", f"chip_smoke_fp16_{name}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg, torch_dtype="float16"), f)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=path, load_format="dummy", dtype="float16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True, **kw))
    pages = engine.executor.cache_engine.dtype
    want = {"int8": torch.int8, "fp8": torch.float8_e5m2}.get(
        kw.get("kv_cache_dtype"), torch.float16)
    embed = engine.executor.params["model.embed_tokens"]["weight"]
    if engine.model_config.dtype != "float16" or \
            embed.dtype != torch.float16 or pages != want:
        fail(f"fp16 {name}: model {engine.model_config.dtype} / "
             f"{embed.dtype}, pages {pages}")
    log(f"fp16 {name} engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens "
        f"({pages}), {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    return engine


def run_fp16_phase(torch, counters, card: str, bf16_profile):
    """Phase 22: float16 end to end at full width (`dtype="float16"`,
    dummy weights from seed 0). (a) MISTRAL_7B whole (32 layers, 14.5
    GB of fp16 weights): phase 4's mix at multi_step 1 with speculative
    decoding on, as by default (the verify dispatches counted), then
    with APHRODITE_ATTN_RAGGED=0 (K5's fp16 instance); the n-gram mix
    classic and with oracle drafts (verify rows: K4 then read-only K1 at
    fp16), tokens equal; a batch-8 decode step profiled beside phase
    4's bf16 one. (b) `check_model_against_plain` in fp16. (c) int8 KV
    pages at 2 layers: the mix (fp16 rows quantized by K1's fused write
    and the slot writer). (d) Mistral-7B-v0.1's sliding window at 2
    layers on fp16 pages: the mix (K3 on fp16 rows, read-only K1). (e)
    GPTQ 4-bit, group 128, at 2 layers: every layer on the fallback
    route (the kernels take bf16 activations only), the mix, a decode
    step profiled and its device ms projected to 32 layers. Returns
    (launches by path, seconds by part)."""
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config)
    by_path, seconds = {}, {}
    t0 = time.perf_counter()
    engine = fp16_engine(torch, "mistral", MISTRAL_7B)
    ex = engine.executor
    real = ex.execute_spec_verify
    dispatches = []

    def verify(*a, **kw):
        dispatches.append(1)
        return real(*a, **kw)
    ex.execute_spec_verify = verify
    os.environ["APHRODITE_SPEC"] = "1"
    try:
        by_path["float16"] = run_engine(torch, engine, 1, counters, card,
                                        tag="fp16 ")
    finally:
        os.environ["APHRODITE_SPEC"] = "0"
        del ex.execute_spec_verify
    log(f"fp16 mix with APHRODITE_SPEC=1 (the default): {len(dispatches)} "
        "verify dispatch(es) from the n-gram drafter")
    os.environ["APHRODITE_ATTN_RAGGED"] = "0"
    try:
        by_path["float16 padded grid"] = run_engine(
            torch, engine, 1, counters, card, tag="fp16 padded ",
            required=("paged_decode_attention_tm", "paged_decode_merge",
                      "write_kv_pages_prefill", "write_kv_pages"),
            absent=("paged_decode_attention",))
    finally:
        os.environ.pop("APHRODITE_ATTN_RAGGED")
    classic, _, stats = run_spec_mix(torch, engine, counters, card,
                                     spec=False, tag="fp16 classic")
    tokens, launches, oracle = run_spec_mix(
        torch, engine, counters, card, spec=True,
        propose=oracle_drafter(stats["full"]), tag="fp16 oracle")
    by_path["float16 spec"] = launches
    if tokens != classic or oracle["dispatches"] < 1 or \
            oracle["k4"] != 32 * oracle["dispatches"]:
        fail(f"fp16 oracle verify rounds: {oracle['dispatches']} "
             f"dispatches, {oracle['k4']} K4 launches, tokens equal "
             f"{tokens == classic}")
    wall, dev = profile_decode(torch, engine, "fp16 ")
    log(f"fp16 vs bf16 batch-8 decode step (64-token prompts) on {card}: "
        f"wall {wall:.2f} / {bf16_profile[0]:.2f} ms, device "
        f"{dev:.2f} / {bf16_profile[1]:.2f} ms, idle share "
        f"{1 - dev / wall:.3f} / {1 - bf16_profile[1] / bf16_profile[0]:.3f}")
    del engine, ex, real
    free_engine(torch, "fp16 Mistral-7B")
    seconds["a"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    check_model_against_plain(torch, torch.float16)
    seconds["b"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    engine = fp16_engine(torch, "int8kv", cut_layers(MISTRAL_7B, 2),
                         kv_cache_dtype="int8")
    by_path["float16 int8 KV"] = run_engine(
        torch, engine, 1, counters, card, tag="fp16 int8 KV ",
        required=("paged_decode_attention", "write_kv_pages"),
        absent=("write_kv_pages_prefill",))
    del engine
    free_engine(torch, "fp16 int8 KV")
    seconds["c"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    engine = fp16_engine(torch, "window", cut_layers(MISTRAL_7B_V01, 2))
    if engine.model_config.get_sliding_window() != 4096:
        fail("fp16 Mistral-7B-v0.1 served without its window")
    by_path["float16 sliding window"] = run_engine(
        torch, engine, 1, counters, card, tag="fp16 window ",
        required=("paged_decode_attention", "write_kv_pages_decode",
                  "write_kv_pages_prefill"))
    del engine
    free_engine(torch, "fp16 sliding window")
    seconds["d"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    layers = 2
    engine = fp16_engine(torch, "gptq", dict(
        cut_layers(MISTRAL_7B, layers), quantization_config={
            "quant_method": "gptq", "bits": 4, "group_size": GPTQ_GS,
            "desc_act": False, "sym": False}))
    method = get_quantization_config(engine.model_config).get_linear_method()
    x = torch.zeros(1, 1, dtype=torch.float16, device="cuda")
    routes = {key.rsplit(".", 1)[-1]: "kernels" if method.uses_kernels(
        bucket, x) else "fallback"
        for key, bucket in engine.executor.params.items()
        if key.startswith("model.layers.") and "qweight" in bucket}
    log(f"fp16 GPTQ (4 bits, group 128, {layers} layers): routes {routes}")
    if set(routes.values()) != {"fallback"}:
        fail(f"fp16 GPTQ: routes {routes}, every layer must take the "
             "fallback")
    os.environ["APHRODITE_W4A8"] = "0"
    try:
        by_path["float16 GPTQ fallback"] = run_engine(
            torch, engine, 1, counters, card, tag="fp16 GPTQ ",
            required=("paged_decode_attention", "write_kv_pages_prefill",
                      "write_kv_pages"), absent=QUANT_COUNTERS)
        profile = profile_fallback_engine(
            torch, engine, "fp16 GPTQ ", card,
            f"Mistral-7B width, {layers} layers", prompt=False)
    finally:
        os.environ.pop("APHRODITE_W4A8")
    full = MISTRAL_7B["num_hidden_layers"]
    log(f"fp16 GPTQ decode step projected to {full} layers (device ms x "
        f"{full} / {layers}, the head counted {full // layers} times: an "
        f"upper bound): {profile['decode_device_ms'] * full / layers:.2f} "
        f"ms of device time on {card}")
    del engine
    free_engine(torch, "fp16 GPTQ")
    seconds["e"] = round(time.perf_counter() - t0, 1)
    return by_path, seconds


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "aphrodite_tpu_torch")):
        print("chip_smoke: aphrodite_tpu_torch/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1

    # 1. Card.
    t_start = time.perf_counter()
    device_kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {device_kind} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    # Every phase but the serving path's (5b, 5c) runs the classic decode
    # path: their launch counts a step assume no verify rounds.
    os.environ["APHRODITE_SPEC"] = "0"

    # 2. Build.
    from aphrodite_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {sorted(build.build_logs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or
                 "Compiling entry" in ln]
        log(f"ptxas {name}: " + " | ".join(lines))
    # K1's dynamic shared memory per block as its launcher plans it at
    # the main path's geometry (page 32, chunks of 4 to 16 pages, one
    # split), by page type, and at the largest geometry it serves.
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    log("K1 dynamic shared memory per block (Hq 32, Hkv 8, d 128, page "
        "32, 64-page tables; chunk 4 / 8 / 16 pages; narrow slots, then "
        "wide where the grid holds at most two blocks per SM): " +
        "; ".join(
            f"{str(dt).replace('torch.', '')} {kind} " + " / ".join(
                str(pa.k1_smem_bytes(dt, wide, HQ // HKV, HEAD_DIM, 32, ppc,
                                     64, 1)) for ppc in (4, 8, 16)) + " B"
            for dt in (torch.bfloat16, torch.float16, torch.int8,
                       torch.float8_e5m2, torch.float32)
            for kind, wide in (("narrow", False), ("wide", True))
            if not (wide and dt == torch.float32)) +
        "; group 16, d 256, page 256, 8-page chunks: " + " / ".join(
            str(pa.k1_smem_bytes(dt, False, 16, 256, 256, 8, 8, 1))
            for dt in (torch.bfloat16, torch.int8, torch.float32)) +
        " B (bf16 / 8-bit / f32)")
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", "an unreported number of")
    log("K6 / K10 (quant_gemm_kernel: 128 x 256 tiles, 288 threads) dynamic "
        "shared memory per block: " + " / ".join(
            f"{qmm.gemm_smem_bytes(bits)} B at {bits} bits" for bits in (4, 8))
        + f"; K8 / K11 (w8a8_gemm_kernel<kGptq4 / kAwq4>) "
        f"{qmm.gguf_gemm_smem_bytes(8)} / {qmm.gguf_gemm_smem_bytes(11)} B"
        + f"; at m > 64 K12 (quant_gemm_kernel<4, kQ4k>) "
        f"{qmm.gguf_gemm_smem_bytes(12)} B, K13 (<8, kQ8>) "
        f"{qmm.gguf_gemm_smem_bytes(13)} B, K14 (<8, kI8g>) "
        f"{qmm.gguf_gemm_smem_bytes(14)} B, K15 (w8a8_gemm_kernel: 128 x "
        f"128 tiles, 256 threads) {qmm.gguf_gemm_smem_bytes(15)} B, K16 on "
        f"bf16 x (<4, kLut>, its 16 KB static codebook tile included) "
        f"{qmm.gguf_gemm_smem_bytes(16)} B, K16 on f32 x (<4, kLutX32>: "
        f"128 x 128 tiles, its 8 KB codebook tile included) "
        f"{qmm.gguf_gemm_smem_bytes(16, f32=True)} B, K17 (<8, kInt8>) "
        f"{qmm.gguf_gemm_smem_bytes(17)} B (the card allows {optin} B)")

    # 3. Kernels vs plain versions, and times.
    log_clocks("before the kernel checks")
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    timer = Timer(torch)
    i8, f8 = torch.int8, torch.float8_e5m2
    k1_err = check_decode_attention(torch, pa, True, torch.bfloat16)
    k5_err = check_decode_attention(torch, pa, False, torch.bfloat16)
    for ragged in (True, False):
        for page_dtype in (i8, f8):
            err = check_decode_attention(torch, pa, ragged, page_dtype,
                                         amlas=(True,), alibis=(False,))
            if ragged:
                k1_err = max(k1_err, err)
            else:
                k5_err = max(k5_err, err)
    check_k5_control(torch, pa)
    check_fused_write_edges(torch, pa, kw)
    # fp16 activations (K1's and K5's fp16 instances) over fp16, int8 and
    # fp8 pages, every case of the bf16 checks (8-bit pages at 32-token
    # pages only); a control for each of K1 and K5; the fused write at
    # the edges.
    t0 = time.perf_counter()
    with activations("float16"):
        k1_err16 = check_decode_attention(torch, pa, True, torch.float16)
        k5_err16 = check_decode_attention(torch, pa, False, torch.float16)
        for ragged in (True, False):
            for page_dtype in (i8, f8):
                err = check_decode_attention(torch, pa, ragged, page_dtype,
                                             page_sizes=(32,))
                if ragged:
                    k1_err16 = max(k1_err16, err)
                else:
                    k5_err16 = max(k5_err16, err)
        check_k5_control(torch, pa, ragged=True)
        check_k5_control(torch, pa)
        check_fused_write_edges(torch, pa, kw)
    log(f"phase 3 fp16 kernel checks: {time.perf_counter() - t0:.1f} s")
    k2, slot_times = check_and_time_writers(torch, kw, timer, fp16=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    k3, k4, k3_16, k4_16 = ({k: slot_times[arm][k] for k in keys} for arm in (
        "K3 bf16, 2 rows", "K4 int8, 8192 rows, 2728 live",
        "K3 fp16, 2 rows", "K4 fp16 rows, int8 pages, 8192 rows, 2728 live"))
    # K1 and K5 timed at phase 4's decode batch: 8 sequences about 16
    # tokens into their 32 new tokens, 32-token pages, fused write; and
    # at batch 64 x 2047; K1 also at batch 8 x 1016. Then their fp16
    # instances: on fp16 pages at those shapes, on 8-bit pages at B 8.
    e2e_ctx = [1016, 316, 80, 1016, 316, 80, 28, 28]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "n_split", "merges", "host_us")
    attn = {}
    for act, name, ragged, page_dtype in (
            (a, n, r, p) for a in ("bfloat16", "float16")
            for n, r in (("K1", True), ("K5", False))
            for p in (getattr(torch, a), i8, f8)):
        page_kind = str(page_dtype).replace("torch.", "")
        # K1 also at the long-context profile's decode shape: 8 rows of
        # 1016 tokens, 32-page tables, 512-token chunks.
        shapes = (("B 8", e2e_ctx, 36), ("B 64 x 2047", [2047] * 64, 64)) + (
            (("B 8 x 1016", [1016] * 8, 32),) if ragged else ())
        if act == "float16" and page_dtype != torch.float16:
            shapes = shapes[:1]
        with activations(act):
            for shape, ctxs, pps in shapes:
                t = dict(zip(keys, time_decode_attention(
                    torch, pa, timer, ctxs, 32, pps, fused=True,
                    ragged=ragged, page_dtype=page_dtype)))
                attn[(name, act, page_kind, shape)] = t
                log(f"{name} {page_kind} pages{act_label()} at {shape} "
                    f"(page 32, fused): "
                    f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                    f"ms, sdpa over the dequantized KV "
                    f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} "
                    f"ms ({t['bound_by']}); {t['n_split']} split(s), "
                    f"{t['merges']} merge launch(es) per call; wrapper "
                    f"{t['host_us']:.1f} us of host time per call")
                if name == "K1" and t["ms"] >= t["library_ms"]:
                    log(f"K1 {page_kind} pages{act_label()} at {shape}: "
                        "slower than the SDPA yardstick")
    k1, k5, k1_16, k5_16 = (
        {k: attn[(name, act, act, "B 8")][k] for k in keys[:5]}
        for act in ("bfloat16", "float16") for name in ("K1", "K5"))
    check_model_against_plain(torch)
    # 3b. K4 then read-only K1 at the speculative verify shape.
    check_verify_shape(torch, pa, kw, timer)
    # 3c. K1-K4 at DeepSeek-MoE-16B's multi-head geometry (phase 19 (a)).
    check_moe_kernels(torch, pa, kw, timer)
    # 3d. K1-K4 at the other architectures' geometries (phase 20).
    t0 = time.perf_counter()
    arch_err, arch_err16, _ = check_arch_kernels(torch, pa, kw, timer)
    k1_err = max(k1_err, arch_err)
    k1_err16 = max(k1_err16, arch_err16)
    log(f"phase 3d: {time.perf_counter() - t0:.1f} s")

    # 4. End to end at Mistral-7B width and depth.
    log_clocks("before the e2e phase (4)")
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    model_dir = os.path.join(HERE, "build", "chip_smoke_model")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(MISTRAL_7B, f)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    log(f"engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens")
    hub = "huggingface_hub" in sys.modules
    log(f"model path {model_dir} passed through resolve_model_path; "
        f"huggingface_hub imported: {hub} (required: False)")
    if hub:
        fail("resolving a local model directory imported huggingface_hub")
    bf16_pages = engine.cache_config.num_gpu_blocks
    counters = build.COUNTERS
    torch.cuda.reset_peak_memory_stats()
    by_path = {"bf16": {}, "bf16 padded grid": {}, "int8 KV": {},
               "fp8 KV": {}, "sliding window": {}, "GPTQ W4A8": {},
               "GPTQ W4A16": {}}

    def add(path, launches):
        for name, n in launches.items():
            by_path[path][name] = by_path[path].get(name, 0) + n
    ragged_tokens = {}
    for ms in (1, 8):
        add("bf16", run_engine(torch, engine, ms, counters, smi,
                               absent=("paged_decode_attention_tm",),
                               tokens=ragged_tokens))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"e2e peak memory {peak:.2f} GiB on {smi}")
    lora_off_profile = profile_decode(torch, engine)
    profile_decode(torch, engine, "long-context ", prompt_len=1000)

    # 5. The same engine on the padded-grid kernel (K5).
    os.environ["APHRODITE_ATTN_RAGGED"] = "0"
    padded_tokens = {}
    for ms in (1, 8):
        add("bf16 padded grid", run_engine(
            torch, engine, ms, counters, smi, tag="padded ",
            required=("paged_decode_attention_tm", "paged_decode_merge",
                      "write_kv_pages_prefill", "write_kv_pages"),
            absent=("paged_decode_attention",),
            tokens=padded_tokens))
    os.environ.pop("APHRODITE_ATTN_RAGGED")
    same = sum(padded_tokens[k] == v for k, v in ragged_tokens.items())
    log(f"APHRODITE_ATTN_RAGGED=0 (K5) vs the ragged grid (K1): {same} of "
        f"{len(ragged_tokens)} requests' 32 tokens equal (required: K5 is "
        "K1's launch on the same grid and split count)")
    for rid in sorted(ragged_tokens):
        if padded_tokens[rid] != ragged_tokens[rid]:
            log(f"  {rid}: K1 {ragged_tokens[rid]} / K5 {padded_tokens[rid]}")
    if same != len(ragged_tokens):
        fail("APHRODITE_ATTN_RAGGED=0: K5's tokens differ from K1's")

    log_clocks("before the spec phase (5b)")
    # 5b. Speculative decoding on the same engine: the n-gram mix with
    # APHRODITE_SPEC on and off, tokens equal; verify rounds against
    # classic decode rounds; the async run's sync reference.
    classic_tokens, _, classic = run_spec_mix(torch, engine, counters, smi,
                                              spec=False)
    by_path["spec"] = {}
    arms = {}
    # The engine's n-gram drafter, then one that drafts the classic run's
    # own next tokens (full acceptance: dummy weights rarely emit what
    # the prompt's n-gram predicts).
    for arm, propose in (("spec", None),
                         ("oracle", oracle_drafter(classic["full"]))):
        tokens, launches, stats = run_spec_mix(
            torch, engine, counters, smi, spec=True, propose=propose,
            tag=arm)
        arms[arm] = stats
        for name, n in launches.items():
            by_path["spec"][name] = by_path["spec"].get(name, 0) + n
        diff = [rid for rid in classic_tokens
                if tokens[rid] != classic_tokens[rid]]
        for rid in diff:
            log(f"  {arm} {rid}: classic {classic_tokens[rid]} / spec "
                f"{tokens[rid]}")
        if diff:
            fail(f"APHRODITE_SPEC=1 ({arm} drafts): tokens of {diff} "
                 "differ from the classic run's")
        layers = MISTRAL_7B["num_hidden_layers"]
        if stats["k1"] != layers * stats["dispatches"] or \
                stats["k4"] != layers * stats["dispatches"]:
            fail(f"{arm} verify rounds: {stats['k1']} K1 and "
                 f"{stats['k4']} K4 launches in {stats['dispatches']} "
                 f"dispatches, not {layers} each a dispatch")
        log(f"{arm} drafts vs classic (the n-gram mix, 8 x 48 tokens): "
            f"tokens equal; engine steps {stats['steps']} / "
            f"{classic['steps']} ({stats['steps'] / 8:.2f} / "
            f"{classic['steps'] / 8:.2f} a request); wall "
            f"{stats['wall_s']:.3f} / {classic['wall_s']:.3f} s; "
            f"{stats['dispatches']} verify dispatches, each K4 then "
            f"read-only K1 in every layer ({stats['k4']} / {stats['k1']} "
            f"launches); drafts proposed {stats['proposed']}, accepted "
            f"{stats['accepted']}")
    log_drafter_cost(arms["spec"]["full"], smi)
    if arms["oracle"]["dispatches"] < 1 or arms["oracle"]["accepted"] < 1:
        fail("APHRODITE_SPEC=1: the oracle-drafted mix made no accepted "
             "verify dispatch")
    profile_spec_step(torch, engine, spec=False)
    profile_spec_step(torch, engine, spec=True)
    profile_spec_step(torch, engine, spec=True,
                      propose=oracle_drafter(profile_references(engine)),
                      tag="oracle")
    reference = run_sync_reference(torch, engine)
    del engine
    free_engine(torch, "bf16")

    log_clocks("before the async phase (5c)")
    # 5c. AsyncAphrodite: 16 concurrent streams through the serving path.
    by_path["async"], _ = run_async_serving(torch, model_dir, counters, smi,
                                            reference)

    log_clocks("before the LoRA phase (5d)")
    # 5d. Multi-LoRA: 2-layer checks over bf16 and GPTQ W4A16 bases, the
    # e2e engine with 6 adapters over 4 slots, the decode step's cost.
    os.environ["APHRODITE_W4A8"] = "0"
    check_lora_two_layer(torch, counters, gptq=False)
    check_lora_two_layer(torch, counters, gptq=True)
    os.environ.pop("APHRODITE_W4A8")
    by_path["LoRA"], lora_profiles = run_lora_engine(
        torch, model_dir, counters, smi, ragged_tokens)
    free_engine(torch, "LoRA")
    delta = time_lora_delta(torch, timer)
    (every_wall, every_dev), (none_wall, none_dev) = (
        lora_profiles["every row"], lora_profiles["no row"])
    off_wall, off_dev = lora_off_profile
    log(f"LoRA batch-8 decode step on {smi} (64-token prompts; wall / "
        f"device ms a step): every row with an adapter {every_wall:.2f} / "
        f"{every_dev:.2f}; no row with an adapter {none_wall:.2f} / "
        f"{none_dev:.2f}; LoRA off (phase 4's engine) {off_wall:.2f} / "
        f"{off_dev:.2f}; the delta {delta[8][0]:.4f} / {delta[64][0]:.4f} ms "
        f"of device time a decoder layer at batch 8 / 64")

    log_clocks("before the 8-bit KV phase (6)")
    # 6. int8 and fp8 KV pages.
    for kv_dtype, page_dtype in (("int8", torch.int8),
                                 ("fp8", torch.float8_e5m2)):
        path = f"{kv_dtype} KV"
        t0 = time.perf_counter()
        engine = AphroditeEngine.from_engine_args(EngineArgs(
            model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
            block_size=32, max_model_len=2048, skip_tokenizer_init=True,
            disable_log_stats=True, kv_cache_dtype=kv_dtype))
        if engine.executor.cache_engine.dtype != page_dtype:
            fail(f"{path}: pages are {engine.executor.cache_engine.dtype}")
        log(f"{path} engine up in {time.perf_counter() - t0:.1f} s: "
            f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens "
            f"({page_dtype}; bf16 had {bf16_pages}), kv_scale "
            f"{engine.executor.cache_engine.kv_scale}")
        for ms in (1, 8):
            # 8-bit prompts take the quantizing slot scatter (K4), not K2.
            add(path, run_engine(
                torch, engine, ms, counters, smi, tag=f"{path} ",
                required=("paged_decode_attention", "write_kv_pages"),
                absent=("write_kv_pages_prefill",)))
        profile_decode(torch, engine, f"{path} ")
        profile_kv8_prompt_round(torch, engine, counters,
                                 MISTRAL_7B["num_hidden_layers"], f"{path} ")
        del engine
        free_engine(torch, path)

    log_clocks("before the window phase (7)")
    # 7. Sliding window: the published Mistral-7B-v0.1 config.
    add("sliding window", run_sliding_window(torch, counters, smi))

    # 8. GPTQ kernels vs plain versions, and times.
    log_clocks("before the GPTQ kernel phase")
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    gptq = check_and_time_quant(torch, qmm, timer, awq=False)

    log_clocks("before the GPTQ e2e phase (9)")
    # 9. End to end with GPTQ, W4A8 then W4A16.
    gptq_dir = quant_model_dir(awq=False)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=gptq_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    if engine.model_config.quantization != "gptq":
        fail("the GPTQ model was not served with quantization='gptq'")
    log(f"GPTQ engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    layers = MISTRAL_7B["num_hidden_layers"]
    step_bound_ms = layers * sum(weight_bytes(K, N, 4) for _, K, N in
                                 GPTQ_PROJ) / HBM_BYTES_PER_S * 1e3
    torch.cuda.reset_peak_memory_stats()
    # The wide round has page-aligned prompts only (no slot writer) and
    # no batch at or below 64 (no skinny kernel).
    for arm, flag, required, wide, decode in (
            ("W4A8", "1", W4A8_KERNELS, ("quantize_activations_int8",
                                          "quant_gemm_split_reduce"),
             "gptq_matmul_a8"),
            ("W4A16", "0", W4A16_KERNELS, ("quant_gemm_split_reduce",),
             "gptq_matmul")):
        os.environ["APHRODITE_W4A8"] = flag
        tag = f"GPTQ {arm} "
        runs = [run_engine(torch, engine, ms, counters, smi,
                           required=required, tag=tag) for ms in (1, 8)]
        runs.append(run_wide_round(
            torch, engine, counters, smi,
            ("paged_decode_attention", "write_kv_pages_prefill", decode)
            + wide, decode, layers, tag))
        for run in runs:
            for name, n in run.items():
                by_path[tag.strip()][name] = \
                    by_path[tag.strip()].get(name, 0) + n
        profile_decode(torch, engine, tag, quant_bound_ms=step_bound_ms,
                       named=(("K9 (quant8_kernel)", "quant8_kernel"),)
                       if arm == "W4A8" else ())
        profile_prompt_round(torch, engine, tag)
    os.environ.pop("APHRODITE_W4A8")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"GPTQ e2e peak memory {peak:.2f} GiB on {smi}")
    del engine
    free_engine(torch, "GPTQ")

    log_clocks("before the AWQ kernel phase (10)")
    # 10. AWQ kernels vs plain versions, and times.
    awq = check_and_time_quant(torch, qmm, timer, awq=True)

    # 11. End to end with AWQ (TheBloke/Mistral-7B-v0.1-AWQ's
    # quant_config), W4A8 then W4A16.
    awq_dir = quant_model_dir(awq=True)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=awq_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    if engine.model_config.quantization != "awq":
        fail("the AWQ model was not served with quantization='awq'")
    log(f"AWQ engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    for arm, flag, required, wide, decode in (
            ("W4A8", "1", AWQ_A8_KERNELS, ("quantize_activations_int8",
                                            "quant_gemm_split_reduce"),
             "awq_matmul_a8"),
            ("W4A16", "0", AWQ_A16_KERNELS, ("quant_gemm_split_reduce",),
             "awq_matmul")):
        os.environ["APHRODITE_W4A8"] = flag
        tag = f"AWQ {arm} "
        by_path[tag.strip()] = {}
        runs = [run_engine(torch, engine, 1, counters, smi,
                           required=required, tag=tag),
                run_wide_round(
                    torch, engine, counters, smi,
                    ("paged_decode_attention", "write_kv_pages_prefill",
                     decode) + wide, decode, layers, tag)]
        for run in runs:
            for name, n in run.items():
                by_path[tag.strip()][name] = \
                    by_path[tag.strip()].get(name, 0) + n
        profile_decode(torch, engine, tag, quant_bound_ms=step_bound_ms)
        profile_prompt_round(torch, engine, tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"AWQ e2e peak memory {peak:.2f} GiB on {smi}")

    # 12. Seeded draws on the card (the AWQ engine, W4A16).
    check_seeded_draws(torch, engine, timer)
    os.environ.pop("APHRODITE_W4A8")
    del engine
    free_engine(torch, "AWQ")

    # 13. GGUF kernels vs plain versions, and times.
    log_clocks("before the GGUF kernel phase")
    gguf = check_and_time_gguf(torch, qmm, timer)

    log_clocks("before the GGUF e2e phase (14)")
    # 14. End to end with dummy GGUF weights in the JAX bench's three
    # at-rest forms (BENCH_GGUF_FMT).
    q8, i8g, w8a8 = GGUF_MATMULS
    gemm_of = dict(zip(GGUF_MATMULS, GGUF_GEMMS))
    for fmt, kernel in (("", w8a8), ("q8_0", q8), ("q6_k", i8g)):
        form = fmt or "turbo"
        os.environ["BENCH_GGUF_FMT"] = fmt
        engine = quant_engine(torch, model_dir, f"GGUF {form}",
                             load_format="dummy")
        os.environ.pop("BENCH_GGUF_FMT")
        key = {w8a8: "k15", q8: "k13", i8g: "k14"}[kernel]
        log(f"GGUF {form}: layer 0 buckets {bucket_forms(engine)}; "
            f"{engine.cache_config.num_gpu_blocks} KV pages (bf16 had "
            f"{bf16_pages})")
        tag = f"GGUF {form} "
        # The mix's prompt rounds take the form's m > 64 kernel, its
        # decode steps quant_stream_kernel; the 96-request round's
        # decode steps the m > 64 kernel and its split reduce.
        gemm = gemm_of[kernel]
        required = BF16_KERNELS + (kernel, gemm) + \
            (("quantize_activations_int8",) if kernel == w8a8 else ())
        absent = tuple(k for k in GGUF_MATMULS + GGUF_GEMMS
                       if k not in (kernel, gemm))
        by_path[tag.strip()] = {}
        runs = [run_engine(torch, engine, 1, counters, smi,
                           required=required, absent=absent, tag=tag),
                run_wide_round(
                    torch, engine, counters, smi,
                    ("paged_decode_attention", "write_kv_pages_prefill",
                     "quant_gemm_split_reduce", gemm), gemm, layers, tag)]
        for run in runs:
            for name, n in run.items():
                by_path[tag.strip()][name] = \
                    by_path[tag.strip()].get(name, 0) + n
        step_bound = layers * sum(gguf_layer_bytes(key, K, N) for _, K, N
                                  in GPTQ_PROJ) / HBM_BYTES_PER_S * 1e3
        named = {"k15": (("K9 (quant8_kernel)", "quant8_kernel"),),
                 "k14": (("K14 (quant_stream_kernel<8, kI8g>)",
                          "quant_stream_kernel"),),
                 "k13": (("K13 (quant_stream_kernel<8, kQ8>)",
                          "quant_stream_kernel"),)}.get(key, ())
        profile_decode(torch, engine, tag, quant_bound_ms=step_bound,
                       named=named)
        del engine
        free_engine(torch, f"GGUF {form}")

    log_clocks("before the GGUF file phase (15)")
    # 15. A .gguf file at full width through the loader.
    import tempfile
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "mistral-width-2l.gguf")
        secs = write_gguf_model(path)
        log(f"GGUF file: 2 layers at Mistral-7B width written in "
            f"{secs:.1f} s ({os.path.getsize(path) / 2**20:.0f} MiB)")
        engine = quant_engine(torch, path, "GGUF file")
    forms = bucket_forms(engine)
    want_forms = {"qkv_proj": ["d16", "qs"], "o_proj": ["d", "qs"],
                  "gate_up_proj": ["qs8", "s128"],
                  "down_proj": ["d", "qs"]}
    if forms != want_forms:
        fail(f"GGUF file: at-rest forms {forms}, expected {want_forms}")
    log(f"GGUF file: layer 0 at-rest forms {forms}")
    by_path["GGUF file"] = run_engine(
        torch, engine, 1, counters, smi, tag="GGUF file ",
        required=BF16_KERNELS + GGUF_MATMULS + GGUF_GEMMS +
        ("quantize_activations_int8",))
    runner = engine.executor.model_runner
    compare_with_plain(torch, runner.model, runner.params,
                       "GGUF file (K13, K14, K15)", w8a8_rows=True)
    del engine, runner
    free_engine(torch, "GGUF file")

    # 16. K12, K16 and K17 kernels vs plain versions, and times.
    log_clocks("before the K12/K16/K17 kernel phase")
    late = check_and_time_late(torch, qmm, timer)

    log_clocks("before the late arms' e2e phase (17)")
    # 17. End to end with dummy weights: SqueezeLLM (K16), int8 (K17),
    # QuIP# (K16 on f32 activations) and GGUF's exact Q4_K form (K12).
    by_path.update(run_late_arms(torch, model_dir, counters, smi, layers,
                                 bf16_pages))

    log_clocks("before the quantized 2-layer models (18)")
    # 18. 2-layer full-width models through K12, K16, K16-f32 and K17 vs
    # their plain versions, each with a control.
    check_quant_models(torch)

    # 19. Mixture of experts: K1-K4 at DeepSeek-MoE-16B's multi-head
    # geometry, 2-layer Mixtral and DeepSeek models against their plain
    # paths, DeepSeek-MoE-16B whole and Mixtral-8x7B at 2 of 32 layers.
    log_clocks("before the MoE phase")
    moe_paths, moe_seconds = run_moe_phase(torch, pa, kw, timer, counters,
                                           smi, only="bcd")
    by_path.update(moe_paths)
    log(f"MoE phase (19) seconds {json.dumps(moe_seconds)}; the run so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 20. The other architectures: six families at full width against
    # their plain paths and through the mix, Qwen2-7B whole and
    # profiled, GPTQ over Qwen2.
    log_clocks("before the other architectures' phase")
    arch_paths, arch_seconds = run_arch_phase(torch, counters, smi)
    by_path.update(arch_paths)
    log(f"other architectures' phase (20) seconds {json.dumps(arch_seconds)};"
        f" the run so far {time.perf_counter() - t_start:.1f} s")

    # 21. The quantized fallback route: act-order, 2-bit and small-group
    # GPTQ, AWQ off its gate, float32 and the other formats' gated shapes
    # through dequantize-then-matmul.
    log_clocks("before the fallback phase (21)")
    fallback_paths, fallback_seconds = run_fallback_phase(torch, counters,
                                                          smi)
    by_path.update(fallback_paths)
    log(f"fallback phase (21) seconds {json.dumps(fallback_seconds)}; the "
        f"run so far {time.perf_counter() - t_start:.1f} s")

    # 22. float16 end to end: Mistral-7B whole at dtype="float16", the
    # padded grid, verify rows, int8 KV, the window and GPTQ's fallback.
    log_clocks("before the float16 phase (22)")
    fp16_paths, fp16_seconds = run_fp16_phase(torch, counters, smi,
                                              lora_off_profile)
    by_path.update(fp16_paths)
    log(f"float16 phase (22) seconds {json.dumps(fp16_seconds)}; the run "
        f"so far {time.perf_counter() - t_start:.1f} s")
    # The fp16 instances' launches are the float16 paths'; every other
    # path runs bf16 or f32 activations.
    launches, launches16 = {}, {}
    for label, path in by_path.items():
        into = launches16 if label.startswith("float16") else launches
        for name, n in path.items():
            into[name] = into.get(name, 0) + n
    log("launches by path (counters reset before each run, summed over a "
        "path's runs): " + json.dumps(by_path))

    quant_src = "aphrodite_tpu_torch/csrc/quant_matmul.cu"
    pallas_qmm = "aphrodite_tpu/ops/pallas/quant_matmul.py"
    attn_src = "aphrodite_tpu_torch/csrc/paged_attention.cuh"
    pallas_pa = "aphrodite_tpu/ops/pallas/paged_attention.py"
    pallas_kvw = "aphrodite_tpu/ops/pallas/kv_write.py"
    entries = [
        dict(name="paged_decode_attention", route="cuda", source=attn_src,
             replaces=f"{pallas_pa}:565",
             launches=launches["paged_decode_attention"],
             max_abs_err=k1_err, **k1),
        dict(name="paged_decode_attention_tm", route="cuda",
             source=attn_src, replaces=f"{pallas_pa}:252",
             launches=launches["paged_decode_attention_tm"],
             max_abs_err=k5_err, **k5),
        dict(name="paged_decode_attention@fp16", route="cuda",
             source=attn_src, replaces=f"{pallas_pa}:565",
             launches=launches16["paged_decode_attention"],
             max_abs_err=k1_err16, **k1_16),
        dict(name="paged_decode_attention_tm@fp16", route="cuda",
             source=attn_src, replaces=f"{pallas_pa}:252",
             launches=launches16["paged_decode_attention_tm"],
             max_abs_err=k5_err16, **k5_16),
        dict(name="write_kv_pages@fp16", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces=f"{pallas_kvw}:38",
             launches=launches16["write_kv_pages"], max_abs_err=0.0,
             **k4_16),
        dict(name="write_kv_pages_decode@fp16", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces=f"{pallas_kvw}:90",
             launches=launches16["write_kv_pages_decode"], max_abs_err=0.0,
             **k3_16),
        dict(name="write_kv_pages_prefill", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces="aphrodite_tpu/ops/pallas/kv_write.py:179",
             launches=launches["write_kv_pages_prefill"], max_abs_err=0.0,
             **k2),
        dict(name="write_kv_pages", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces="aphrodite_tpu/ops/pallas/kv_write.py:38",
             launches=launches["write_kv_pages"], max_abs_err=0.0, **k4),
        dict(name="write_kv_pages_decode", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces="aphrodite_tpu/ops/pallas/kv_write.py:90",
             launches=launches["write_kv_pages_decode"], max_abs_err=0.0,
             **k3),
        dict(name="gptq_matmul", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:554", launches=launches["gptq_matmul"],
             **gptq["k6"]),
        dict(name="gptq_matmul_stream", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:308",
             launches=launches["gptq_matmul_stream"], **gptq["k7"]),
        dict(name="gptq_matmul_stream_a8", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:308",
             launches=launches["gptq_matmul_stream_a8"], **gptq["k7a8"]),
        dict(name="gptq_matmul_a8", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:1274",
             launches=launches["gptq_matmul_a8"], **gptq["k8"]),
        dict(name="quantize_activations_int8", route="cuda",
             source=quant_src, replaces=f"{pallas_qmm}:781",
             launches=launches["quantize_activations_int8"], **gptq["k9"]),
        dict(name="awq_matmul", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:718", launches=launches["awq_matmul"],
             **awq["k10"]),
        dict(name="awq_matmul_stream", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:308",
             launches=launches["awq_matmul_stream"], **awq["k7"]),
        dict(name="awq_matmul_stream_a8", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:308",
             launches=launches["awq_matmul_stream_a8"], **awq["k7a8"]),
        dict(name="awq_matmul_a8", route="cuda", source=quant_src,
             replaces=f"{pallas_qmm}:937",
             launches=launches["awq_matmul_a8"], **awq["k11"]),
    ] + [dict(name=name, route="cuda", source=quant_src,
              replaces=f"{pallas_qmm}:{line}", launches=launches[name],
              **gguf[key]) for key, (name, _, line) in GGUF_KERNELS.items()
         ] + [dict(name=name, route="cuda", source=quant_src,
                   replaces=f"{pallas_qmm}:{GGUF_KERNELS[key][2]}",
                   launches=launches[name], **gguf[f"{key}@4096"])
              for key, name in zip(GGUF_KERNELS, GGUF_GEMMS)
              ] + [dict(name=name, route="cuda", source=quant_src,
                   replaces=f"{pallas_qmm}:{line}", launches=launches[name],
                   **late[key]) for key, (name, line) in LATE_KERNELS.items()
                   ] + [dict(name=name, route="cuda", source=quant_src,
                             replaces=f"{pallas_qmm}:{LATE_KERNELS[key][1]}",
                             launches=launches[name], **late[f"{key}@4096"])
                        for key, name in LATE_GEMMS.items()]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
