"""The PyTorch port end to end against the JAX package on the tiny model
of tests/conftest.py, in float32 on the CPU.

Both engines get the same weights: the JAX engine's dummy parameters,
scaled up (x100, so attention and the MLP do real work) and converted
with `params_from_jax`. Both pin the same `num_gpu_blocks` (the JAX
pages pad head_dim to 128 lanes and would size the pool differently),
and run with speculative decoding off.

- Prefill and decode logits agree within 1e-5 absolute (f32; logits are
  O(0.1)).
- Greedy `LLM.generate` agrees token for token for mixed prompt
  lengths, with multi_step 1 and 4, through pipelined prompt rounds,
  chunked prefill in combined rounds (a prompt arriving past the round
  budget; its last 8-token chunk is not page-aligned under 32-token
  pages and takes the slot scatter) and decode bursts. A token is
  compared only while the port's top-2 logprob gap exceeds 1e-4 (a near
  tie may flip).
- Seeded random sampling gives the JAX engine's tokens (the port draws
  JAX's threefry bits, `modeling/layers/prng.py`).
- int8 and fp8 KV pages: greedy tokens under the same gap rule, against
  the JAX engine with the same `kv_cache_dtype` (see
  `test_greedy_generation_on_8bit_kv_matches_jax` for the tolerance);
  APHRODITE_ATTN_RAGGED=0 (the padded-grid kernel): the same tokens.
- A sliding-window Mistral (window 24, 8-token pages; the checkpoint of
  tests/engine/test_sliding_window_e2e.py) generates 40 tokens past the
  window beside a prompt longer than the window: token for token the
  JAX engine's.
"""
import jax
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.common.sequence import (
    SequenceData as JaxSequenceData,
    SequenceGroupMetadata as JaxSequenceGroupMetadata)
from aphrodite_tpu.engine.aphrodite_engine import (
    AphroditeEngine as JaxEngine)
from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                 SequenceGroupMetadata)
from aphrodite_tpu_torch.common.utils import Counter
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax, to_device


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_injected_faults(monkeypatch):
    """Run without fault injection whatever an earlier test in this
    process left in the environment."""
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    monkeypatch.delenv("APHRODITE_FAULT_SEED", raising=False)
    jax_faults.reset()
    faultinject.reset()


NUM_BLOCKS = 96
WEIGHT_SCALE = 100.0
GAP_TOL = 1e-4
PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)]
           for n in (5, 40, 120, 200)]
ENGINE_KW = dict(load_format="dummy", dtype="float32", block_size=32,
                 max_model_len=256, max_num_seqs=8, swap_space=0.01,
                 disable_log_stats=True, skip_tokenizer_init=True,
                 max_num_batched_tokens=256, max_chunk_tokens=64,
                 multi_step=4)


def _engine_pair(model_dir, **kw):
    """The JAX engine and the port's on the tiny model, the port given
    the JAX engine's scaled dummy weights."""
    jcfg = JaxEngineArgs(model=model_dir,
                         **ENGINE_KW, **kw).create_engine_configs()
    jcfg[1].num_gpu_blocks = NUM_BLOCKS
    jax_engine = JaxEngine(*jcfg)
    scaled = jax.tree_util.tree_map(lambda a: a * WEIGHT_SCALE,
                                    jax_engine.executor.params)
    jax_engine.executor.params = scaled
    jax_engine.executor.model_runner.params = scaled

    tcfg = EngineArgs(model=model_dir, device="cpu",
                      **ENGINE_KW, **kw).create_engine_configs()
    tcfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AphroditeEngine(*tcfg)
    host = jax.tree_util.tree_map(np.asarray, scaled)
    params = to_device(params_from_jax(host), torch.device("cpu"),
                       torch.float32)
    port.executor.params = params
    port.executor.model_runner.params = params
    return jax_engine, port


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    yield _engine_pair(tiny_model_dir)
    mp.undo()


@pytest.fixture(scope="module", params=["int8", "fp8"])
def quant_engines(request, tiny_model_dir):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    yield _engine_pair(tiny_model_dir, kv_cache_dtype=request.param)
    mp.undo()


def _generate(engine, multi_step, prompts, **sp_kw):
    """`LLM.generate` over `engine` (the JAX or the port's LLM class,
    matching the engine's package), greedy unless `sp_kw` says otherwise;
    every page is freed after."""
    if isinstance(engine, AphroditeEngine):
        llm_cls, sp_cls = LLM, SamplingParams
    else:
        llm_cls, sp_cls = JaxLLM, JaxSamplingParams
    llm = object.__new__(llm_cls)
    llm.engine, llm.request_counter = engine, Counter()
    engine.scheduler_config.multi_step = multi_step
    outs = llm.generate(prompt_token_ids=[list(p) for p in prompts],
                        sampling_params=sp_cls(**dict(
                            dict(temperature=0.0, max_tokens=8,
                                 ignore_eos=True), **sp_kw)))
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() == \
        NUM_BLOCKS
    return outs


def _run(engine, multi_step, prompts, **sp_kw):
    return [o.outputs[0] for o in _generate(engine, multi_step, prompts,
                                            **sp_kw)]


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("multi_step", [1, 4])
def test_greedy_generation_matches_jax(engines, multi_step, monkeypatch):
    from aphrodite_tpu_torch.modeling.layers import attention
    jax_engine, port = engines
    want = [o.token_ids for o in _run(jax_engine, multi_step, PROMPTS)]
    calls = {}
    for name in ("write_kv_pages_prefill", "write_kv_pages",
                 "paged_decode_attention"):
        _spy(monkeypatch, attention, name, calls)
    _spy(monkeypatch, port.executor, "execute_combined", calls)
    got = [o.token_ids for o in _run(port, multi_step, PROMPTS)]
    # Every route of the slice ran: page-aligned and unaligned prompt
    # writes, fused decode attention, and chunked prefill riding
    # combined rounds.
    assert all(calls.get(n, 0) > 0 for n in (
        "write_kv_pages_prefill", "write_kv_pages",
        "paged_decode_attention", "execute_combined")), calls
    # The port's own top-2 gaps (logprobs=2 routes prompts through the
    # raw-logits path; the tokens must not change).
    scored = _run(port, multi_step, PROMPTS, logprobs=2)
    assert _gap_compare(want, got, scored) >= 24


def _gap_compare(want, got, scored, gap_tol=GAP_TOL):
    """Tokens equal while the port's top-2 logprob gap exceeds gap_tol;
    returns how many were compared."""
    compared = 0
    for w, g, s in zip(want, got, scored):
        assert list(s.token_ids) == list(g)
        for pos, (wt, gt) in enumerate(zip(w, g)):
            top = sorted(s.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= gap_tol:
                break                      # near tie: may flip from here
            assert wt == gt, (pos, w, g)
            compared += 1
    return compared


# 8-bit pages: the JAX engine's CPU route attends in f32 (the jnp
# reference) where the port's plain kernel, like both Pallas bodies,
# rounds the scaled query and the softmax weights to bf16. A decode
# step's logits then differ by up to 4.1e-6 (int8) and 3.1e-6 (fp8) on
# this model, held to 2e-5. Over a generation the difference can also
# move a later K or V value across an int8 rounding boundary (one code,
# 0.05), which flipped a token at a top-2 gap of 1.04e-4: tokens are
# compared while the gap exceeds 5e-4.
GAP_TOL_8BIT = 5e-4
LOGIT_TOL_8BIT = 2e-5


def test_greedy_generation_on_8bit_kv_matches_jax(quant_engines,
                                                  monkeypatch):
    """int8 (scale 0.05) and fp8 e5m2 pages through prompt rounds,
    chunked prefill over a cached prefix (the gather dequantizes) and
    decode bursts, against the JAX engine with the same cache dtype."""
    from aphrodite_tpu_torch.modeling.layers import attention
    jax_engine, port = quant_engines
    dtype = port.executor.cache_engine.kv_caches[0][0].dtype
    assert dtype in (torch.int8, torch.float8_e5m2)
    want = [o.token_ids for o in _run(jax_engine, 4, PROMPTS)]
    calls = {}
    for name in ("write_kv_pages_prefill", "write_kv_pages",
                 "paged_decode_attention"):
        _spy(monkeypatch, attention, name, calls)
    scored = _run(port, 4, PROMPTS, logprobs=2)
    # 8-bit prompts take the quantizing slot scatter, never K2.
    assert calls.get("write_kv_pages", 0) > 0 and \
        calls.get("paged_decode_attention", 0) > 0
    assert "write_kv_pages_prefill" not in calls
    got = [s.token_ids for s in scored]
    assert _gap_compare(want, got, scored, GAP_TOL_8BIT) >= 12


def test_8bit_kv_logits_match_jax(quant_engines):
    """Prefill and two decode steps on 8-bit pages: logits within
    LOGIT_TOL_8BIT of the JAX engine's (see above)."""
    _logits_match(quant_engines, LOGIT_TOL_8BIT)


def test_padded_grid_flag_gives_the_same_tokens(engines, monkeypatch):
    """APHRODITE_ATTN_RAGGED=0 routes decode to the padded-grid kernel
    (K5): the same greedy tokens as the JAX engine."""
    jax_engine, port = engines
    monkeypatch.setenv("APHRODITE_ATTN_RAGGED", "0")
    want = [o.token_ids for o in _run(jax_engine, 1, PROMPTS)]
    got = [o.token_ids for o in _run(port, 1, PROMPTS)]
    scored = _run(port, 1, PROMPTS, logprobs=2)
    assert _gap_compare(want, got, scored) >= 24


WINDOW, WINDOW_BLOCK = 24, 8


@pytest.fixture(scope="module")
def mistral_dir(tmp_path_factory):
    """The tiny Mistral of tests/engine/test_sliding_window_e2e.py."""
    from transformers import MistralConfig, MistralForCausalLM
    torch.manual_seed(7)
    cfg = MistralConfig(vocab_size=128, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=256,
                        sliding_window=WINDOW, tie_word_embeddings=False,
                        attn_implementation="eager")
    model = MistralForCausalLM(cfg).eval().to(torch.float32)
    path = tmp_path_factory.mktemp("mistral-sw-port")
    model.save_pretrained(path, safe_serialization=True)
    return str(path)


def test_sliding_window_generation_matches_jax(mistral_dir, monkeypatch):
    """A 10-token prompt decoded 40 steps (the window's pages wrap) beside
    a 30-token prompt longer than the window (its prefill writes the
    window's pages twice; the last write wins). Decode takes the slot
    writer (K3) and a read-only attention call."""
    from aphrodite_tpu_torch.modeling.layers import attention
    from aphrodite_tpu_torch.ops.cuda import kv_write
    prompts = [[5, 9, 11, 3, 7, 2, 8, 4, 6, 10],
               [(i * 37 + 5) % 120 + 3 for i in range(30)]]
    kw = dict(load_format="safetensors", dtype="float32", max_model_len=128,
              max_num_seqs=4, block_size=WINDOW_BLOCK, swap_space=0.01,
              skip_tokenizer_init=True, disable_log_stats=True)
    jllm = JaxLLM(model=mistral_dir, **kw)
    assert jllm.engine.model_config.get_sliding_window() == WINDOW
    want = [list(o.outputs[0].token_ids) for o in jllm.generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(
            temperature=0.0, max_tokens=40, ignore_eos=True))]
    llm = LLM(model=mistral_dir, device="cpu", **kw)
    assert llm.engine.model_config.get_sliding_window() == WINDOW
    calls, distinct = {}, []
    _spy(monkeypatch, attention, "paged_decode_attention", calls)
    real = kv_write.write_kv_pages

    def writer(*a, distinct_pages=False, **k):
        distinct.append(distinct_pages)
        return real(*a, distinct_pages=distinct_pages, **k)
    monkeypatch.setattr(attention, "write_kv_pages", writer)
    got = [list(o.outputs[0].token_ids) for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(
            temperature=0.0, max_tokens=40, ignore_eos=True))]
    assert got == want
    assert calls.get("paged_decode_attention", 0) > 0
    assert True in distinct and False in distinct    # K3 and K4


@pytest.mark.parametrize("n", [1, 2])
def test_seeded_generation_matches_jax(engines, n):
    """Seeded random sampling (temperature 0.8, top_p 0.9) draws the JAX
    package's threefry bits: token for token the JAX engine's, for two
    seeds (one of them 2**31 and above), through prompt rounds and
    decode bursts of 4 (the burst adds the step to each key's salt)."""
    jax_engine, port = engines
    runs = []
    for seed in (3, 2 ** 31 + 11):
        kw = dict(temperature=0.8, top_p=0.9, n=n, seed=seed)
        want = _generate(jax_engine, 4, PROMPTS[:3], **kw)
        got = [[list(c.token_ids) for c in o.outputs]
               for o in _generate(port, 4, PROMPTS[:3], **kw)]
        assert all(len(g) == n for g in got)
        assert got == [[list(c.token_ids) for c in o.outputs]
                       for o in want], seed
        runs.append(got)
    assert runs[0] != runs[1]                  # the seeds drew differently


def _metadata(seq_cls, md_cls, sp_cls, tokens, table, is_prompt):
    data = seq_cls(list(tokens[:-1]) if not is_prompt else list(tokens))
    if not is_prompt:
        data.append_token_id(tokens[-1], 0.0)
    return md_cls(request_id="0", is_prompt=is_prompt, seq_data={0: data},
                  sampling_params=sp_cls(temperature=0.0),
                  block_tables={0: table}, persistent_data={0: {}})


def test_prefill_and_decode_logits_match_jax(engines):
    """One 40-token prompt (padded to 64 tokens: two whole pages for the
    page writer) and two decode steps on its pages."""
    _logits_match(engines, 1e-5)


def _logits_match(engines, tol):
    jax_engine, port = engines
    jr, tr = jax_engine.executor.model_runner, port.executor.model_runner
    jkv = jax_engine.executor.cache_engine.kv_caches
    tkv = port.executor.cache_engine.kv_caches
    tokens = list(PROMPTS[1])
    table = [3, 7, 11, 13]
    for step in range(3):
        is_prompt = step == 0
        args = (tokens, table, is_prompt)
        jin, _ = jr._prepare_prompt([_metadata(
            JaxSequenceData, JaxSequenceGroupMetadata, JaxSamplingParams,
            *args)]) if is_prompt else jr._prepare_decode([_metadata(
                JaxSequenceData, JaxSequenceGroupMetadata,
                JaxSamplingParams, *args)])
        tin, _ = tr._prepare_prompt([_metadata(
            SequenceData, SequenceGroupMetadata, SamplingParams,
            *args)]) if is_prompt else tr._prepare_decode([_metadata(
                SequenceData, SequenceGroupMetadata, SamplingParams,
                *args)])
        want, jkv = jr._step_fn(jr.params, jin["input_ids"],
                                jin["positions"], jkv, jin["metadata"],
                                jin["sel"], is_prompt=is_prompt,
                                use_prefix=False)
        meta = tin["metadata"].replace(is_prompt=is_prompt)
        got, tkv = tr._logits(tr.params, tin["input_ids"],
                              tin["positions"], tkv, meta, tin["sel"])
        want = np.asarray(want)[:tin["num_rows"]]
        got = got.numpy()[:tin["num_rows"]]
        assert np.abs(want).max() > 1e-2          # not a degenerate model
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        tokens.append(int(want[-1].argmax()))
    jax_engine.executor.cache_engine.kv_caches = jkv


def test_port_tokenizer_path_on_cpu(tiny_model_dir):
    """Text prompts through the port's (lazily imported) tokenizer."""
    from aphrodite_tpu_torch.endpoints.llm import LLM
    llm = LLM(model=tiny_model_dir, load_format="dummy", dtype="float32",
              block_size=16, max_model_len=128, swap_space=0.01,
              device="cpu")
    out = llm.generate(["the quick brown fox"],
                       SamplingParams(temperature=0.0, max_tokens=4,
                                      ignore_eos=True))
    assert len(out[0].outputs[0].token_ids) == 4
    assert isinstance(out[0].outputs[0].text, str)


def test_burst_ends_on_the_last_reserved_slot(engines):
    """A burst whose last step writes the last slot of the last reserved
    page, with the block table exactly that wide: the position after it
    lies past the table and must never be looked up."""
    _, port = engines
    runner = port.executor.model_runner
    data = SequenceData([(i * 5 + 1) % 250 for i in range(125)])
    md = SequenceGroupMetadata(
        request_id="burst", is_prompt=False, seq_data={0: data},
        sampling_params=SamplingParams(temperature=0.0),
        block_tables={0: [40, 41, 42, 43]}, persistent_data={0: {}})
    outs, _ = runner.execute_decode_burst(
        [md], port.executor.cache_engine.kv_caches, 4, extra_cap={0: 4})
    assert len(outs) == 4


def test_swap_and_copy_on_write_under_tight_memory(tiny_model_dir,
                                                   monkeypatch):
    """Beam search (forked sequences share pages: copy-on-write) under a
    pool too small for the batch (preemption: swap or recompute) gives
    the same outputs as an unconstrained pool, as the JAX package's
    test_swap_preemption_under_tight_memory checks for itself."""
    _swap_and_cow(tiny_model_dir, monkeypatch, "auto")


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "fp8"])
def test_swap_and_copy_on_write_on_8bit_pages(tiny_model_dir, monkeypatch,
                                              kv_cache_dtype):
    """The same on int8 and fp8 pages: swaps and CoW copies move the
    8-bit pages as bytes (CPU torch lacks index_copy_ and masked_fill
    for float8_e5m2)."""
    _swap_and_cow(tiny_model_dir, monkeypatch, kv_cache_dtype)


def _swap_and_cow(tiny_model_dir, monkeypatch, kv_cache_dtype):
    prompts = [[(i * 13 + j * 7) % 250 + 5 for j in range(30 + 3 * i)]
               for i in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                        n=2, best_of=2, use_beam_search=True)

    def run(num_blocks):
        cfg = EngineArgs(model=tiny_model_dir, load_format="dummy",
                         dtype="float32", block_size=16, max_model_len=256,
                         max_num_seqs=8, swap_space=0.05,
                         disable_log_stats=True, skip_tokenizer_init=True,
                         device="cpu", kv_cache_dtype=kv_cache_dtype
                         ).create_engine_configs()
        cfg[1].num_gpu_blocks = num_blocks
        engine = AphroditeEngine(*cfg)
        for i, p in enumerate(prompts):
            engine.add_request(str(i), None, sp, prompt_token_ids=p)
        results, pressure = {}, False
        while engine.has_unfinished_requests():
            outs = engine.step()
            pressure = pressure or bool(engine.scheduler.swapped)
            for o in outs:
                if o.finished:
                    results[o.request_id] = [tuple(c.token_ids)
                                             for c in o.outputs]
        return results, pressure

    from aphrodite_tpu_torch.executor import cache_engine, model_runner
    calls = {}
    _spy(monkeypatch, model_runner, "_copy_blocks_op", calls)
    _spy(monkeypatch, cache_engine.CacheEngine, "swap_out", calls)
    plenty, _ = run(512)
    tight, pressure = run(18)
    assert pressure and calls.get("swap_out", 0) > 0
    assert calls.get("_copy_blocks_op", 0) > 0          # CoW page copies
    assert tight == plenty
