"""Prefix caching and stream resume in the PyTorch port against the JAX
package, on the tiny model of tests/conftest.py in float32 on the CPU
(the plain kernel versions). Mirrors tests/engine/test_engine_e2e.py
(`test_prefix_caching_reuse`, `test_full_prefix_hit_keeps_page_writer_engaged`)
and the colocated cases of tests/engine/test_resume.py.

Both engines get the JAX engine's dummy weights (`params_from_jax`) and
the same pinned `num_gpu_blocks` (helpers of tests/test_torch_spec.py).
Tolerances: token ids and texts equal (greedy and seeded), the prompt
round's layout (context length, whole-page writer cells) equal to the
JAX runner's.

- Prefix reuse: a request with `prefix_pos` computes the prefix, a
  second one reuses its pages (the chunk starts after the prefix), and
  both give the tokens of the run without a prefix and of the JAX
  engine; a prefix covering the whole prompt too.
- Resume (`emitted_token_ids`): the joint output equals the unbroken
  run's at every split, seeded and speculative included; max_tokens
  and stop strings count the joint output; EOS as the last emitted
  token finishes on arrival; multi-sequence continuations are refused;
  `resumed_text` is the text the original stream delivered.
"""
import pytest
import torch

from aphrodite_tpu.common.prefix import Prefix as JaxPrefix
from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.common.sequence import (
    SequenceData as JaxSequenceData,
    SequenceGroupMetadata as JaxSequenceGroupMetadata)
from aphrodite_tpu_torch.common.prefix import Prefix
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                 SequenceGroupMetadata)
from test_torch_spec import NUM_BLOCKS, drain, engine_pair, sampling


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


PROMPT = [5 + (i * 7) % 90 for i in range(12)]
PATTERN = [11, 23, 37, 41] * 5


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    return engine_pair(tiny_model_dir)


def _both(engines, fn):
    """fn(engine) on the JAX engine and on the port's."""
    return [fn(e) for e in engines]


def _gen(engine, rid, prompt, prefix_pos=None, emitted=None, **sp):
    engine.add_request(rid, None, sampling(engine, **sp),
                       prompt_token_ids=list(prompt),
                       prefix_pos=prefix_pos, emitted_token_ids=emitted)
    return drain(engine)[0][rid]


def _ids(out):
    return list(out.outputs[0].token_ids)


# ---- prefix caching ----

@pytest.mark.parametrize("n,prefix_pos", [(64, 32), (48, 48)])
def test_prefix_caching_reuse(engines, monkeypatch, n, prefix_pos):
    """Computing the prefix and reusing its pages give the tokens of the
    run without a prefix, in both packages (48 / 48: a prefix covering
    the whole prompt, so the chunk starts a page before its end)."""
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    vocab = engines[1].model_config.get_vocab_size()
    prompt = [(13 * i + 7) % (vocab - 10) + 5 for i in range(n)]
    sp = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
    chunk_starts = []
    runner = engines[1].executor.model_runner
    real = runner._prepare_prompt

    def spy(mds):
        inputs, sm = real(mds)
        chunk_starts.extend(inputs["metadata"].context_lens[:len(mds)]
                            .tolist())
        return inputs, sm
    monkeypatch.setattr(runner, "_prepare_prompt", spy)
    runs = []
    for engine in engines:
        tag = type(engine).__module__.split(".")[0]
        runs.append([_ids(_gen(engine, f"{tag}-pfx-{n}-{i}", prompt,
                               prefix_pos=p, **sp))
                     for i, p in enumerate((None, prefix_pos,
                                            prefix_pos))])
    (j_none, j_first, j_second), (t_none, t_first, t_second) = runs
    assert t_none == t_first == t_second == j_none == j_first == j_second
    # The third run's prompt chunk starts after the cached prefix
    # (clamped to a page boundary below the prompt's end).
    page = runner.page_size
    assert chunk_starts[-1] == min(prefix_pos, (n - 1) // page * page) > 0
    # The prefix's pages stay pinned until the pool drops it; then none
    # is leaked.
    for engine in engines:
        engine.scheduler.clear_prefixes()
        assert engine.scheduler.block_manager.get_num_free_gpu_blocks() \
            == NUM_BLOCKS


def test_full_prefix_hit_keeps_page_writer_engaged(engines):
    """A computed prefix covering the whole prompt clamps the chunk
    start to a page boundary, so the whole-page writer (K2) stays
    engaged: the layout equals the JAX runner's."""
    jax_engine, port = engines
    layouts = []
    for engine, prefix_cls, data_cls, md_cls, sp_cls in (
            (jax_engine, JaxPrefix, JaxSequenceData,
             JaxSequenceGroupMetadata, JaxSamplingParams),
            (port, Prefix, SequenceData, SequenceGroupMetadata,
             SamplingParams)):
        mr = engine.executor.model_runner
        page = mr.page_size
        tokens = list(range(1, 2 * page + 1))
        prefix = prefix_cls(tokens, page)
        prefix.computed = True
        md = md_cls(request_id="pfx-full", is_prompt=True,
                    seq_data={0: data_cls(tokens)},
                    sampling_params=sp_cls(temperature=0.0, max_tokens=2,
                                           ignore_eos=True),
                    block_tables={0: [0, 1]}, persistent_data={0: {}},
                    prefix=prefix)
        saved = mr._prefill_writer_ok
        mr._prefill_writer_ok = True          # the JAX gate is TPU-only
        try:
            inputs, _ = mr._prepare_prompt([md])
        finally:
            mr._prefill_writer_ok = saved
        meta = inputs["metadata"]
        pid, _, vld = meta.prefill_cells
        layouts.append((int(meta.context_lens[0]), int(pid[0]),
                        int(vld[0]), bool(inputs["use_prefix"])))
    page = port.executor.model_runner.page_size
    assert layouts[1] == layouts[0] == (page, 1, page, True)


# ---- resume ----

@pytest.mark.parametrize("spec", ["0", "1"])
def test_seeded_continuation_bit_equal(engines, monkeypatch, spec):
    """A continuation from k emitted tokens gives the unbroken seeded
    run's joint tokens and text at every split, in both packages."""
    monkeypatch.setenv("APHRODITE_SPEC", spec)
    sp = dict(temperature=1.0, seed=4242, max_tokens=10, ignore_eos=True)
    fulls = _both(engines, lambda e: _gen(e, f"seeded-full-{spec}",
                                          PROMPT, **sp))
    ids = _ids(fulls[1])
    assert len(ids) == 10 and ids == _ids(fulls[0])
    for k in (1, 4, 9):
        out = _gen(engines[1], f"cont-{spec}-{k}", PROMPT,
                   emitted=ids[:k], **sp)
        assert _ids(out) == ids, f"split {k}"
        assert out.outputs[0].text == fulls[0].outputs[0].text
        assert out.resumed_tokens == k
        assert fulls[1].outputs[0].text.startswith(out.resumed_text)


def test_continuation_respects_joint_max_tokens(engines, monkeypatch):
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    port = engines[1]
    sp = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
    ids = _ids(_gen(port, "len-full", PROMPT, **sp))
    out = _gen(port, "len-cont", PROMPT, emitted=ids[:4], **sp)
    assert _ids(out) == ids and out.outputs[0].finish_reason == "length"
    free0 = port.scheduler.block_manager.get_num_free_gpu_blocks()
    port.add_request("len-done", None, SamplingParams(**sp),
                     prompt_token_ids=list(PROMPT), emitted_token_ids=ids)
    outs = port.step()
    (done,) = [o for o in outs if o.finished]
    assert done.request_id == "len-done" and _ids(done) == ids
    assert done.outputs[0].finish_reason == "length"
    assert not port.has_unfinished_requests()
    assert port.scheduler.block_manager.get_num_free_gpu_blocks() == free0


def test_continuation_stop_string_spans_splice(engines, monkeypatch):
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    jax_engine, port = engines
    base = dict(temperature=0.0, max_tokens=8, ignore_eos=True)
    full = _gen(port, "stop-full", PROMPT, **base)
    stop = full.outputs[0].text[-3:]
    assert stop
    sp = dict(base, stop=[stop])
    refs = _both(engines, lambda e: _gen(e, "stop-ref", PROMPT, **sp))
    ref_text = refs[1].outputs[0].text
    assert ref_text == refs[0].outputs[0].text
    ids = _ids(full)
    out = _gen(port, "stop-cont", PROMPT, emitted=ids[:3], **sp)
    assert out.outputs[0].text == ref_text
    assert out.outputs[0].finish_reason == refs[1].outputs[0].finish_reason
    out = _gen(port, "stop-done", PROMPT, emitted=_ids(refs[1]), **sp)
    assert out.outputs[0].finish_reason == refs[1].outputs[0].finish_reason
    assert out.outputs[0].text == ref_text == out.resumed_text


def test_continuation_eos_on_last_emitted(engines):
    port = engines[1]
    eos = port.tokenizer.get_lora_tokenizer().eos_token_id
    out = _gen(port, "eos-done", PROMPT, emitted=[33, eos],
               temperature=0.0, max_tokens=8)
    assert out.outputs[0].finish_reason == "stop"
    assert _ids(out) == [33, eos]


def test_continuation_rejects_multi_sequence(engines):
    sp = SamplingParams(temperature=1.0, n=2, best_of=2, max_tokens=4)
    with pytest.raises(ValueError, match="single-sequence"):
        engines[1].add_request("multi", None, sp,
                               prompt_token_ids=list(PROMPT),
                               emitted_token_ids=[1, 2])


def test_spec_stream_resumes_bit_equal(engines, monkeypatch):
    """A seeded speculative stream resumes bit-equal to the unbroken
    run (and to the JAX engine's) at every split point."""
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    sp = dict(temperature=1.0, seed=616, max_tokens=12, ignore_eos=True)
    fulls = _both(engines, lambda e: _gen(e, "spec-full", PATTERN, **sp))
    ids = _ids(fulls[1])
    assert len(ids) == 12 and ids == _ids(fulls[0])
    for k in (1, 5, 11):
        out = _gen(engines[1], f"spec-cont-{k}", PATTERN,
                   emitted=ids[:k], **sp)
        assert _ids(out) == ids, f"split {k}"
        assert out.outputs[0].text == fulls[0].outputs[0].text
        assert out.resumed_tokens == k


def test_spec_resume_redrafts_from_joint_history(engines, monkeypatch):
    """Killed inside the greedy cycle, the resumed stream drafts against
    the joint prompt + output history and lands accepted rounds."""
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    port = engines[1]
    sp = dict(temperature=0.0, max_tokens=60, ignore_eos=True)
    ids = _ids(_gen(port, "redraft-full", PATTERN, **sp))
    histories, accepted = [], []
    orig_propose, orig_observe = port.drafter.propose, port.drafter.observe

    def spy_propose(seq_id, token_ids, k):
        histories.append(list(token_ids))
        return orig_propose(seq_id, token_ids, k)

    def spy_observe(seq_id, proposed, acc):
        accepted.append(acc)
        return orig_observe(seq_id, proposed, acc)
    monkeypatch.setattr(port.drafter, "propose", spy_propose)
    monkeypatch.setattr(port.drafter, "observe", spy_observe)
    kill = 40
    out = _gen(port, "redraft-cont", PATTERN, emitted=ids[:kill], **sp)
    assert _ids(out) == ids
    assert histories and all(h[:len(PATTERN) + kill] ==
                             PATTERN + ids[:kill] for h in histories)
    assert sum(accepted) > 0


def test_continuation_detok_resumes_mid_word(engines, monkeypatch):
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    port = engines[1]
    sp = dict(temperature=1.0, seed=99, max_tokens=12, ignore_eos=True)
    full = _gen(port, "detok-full", PROMPT, **sp)
    ids, text = _ids(full), full.outputs[0].text
    for k in range(1, 12, 3):
        out = _gen(port, f"detok-{k}", PROMPT, emitted=ids[:k], **sp)
        assert out.outputs[0].text == text
        assert text.startswith(out.resumed_text)
