"""The sampler of the PyTorch port against the JAX package's: each
stage of the logits pipeline on the same knob tensors and logits, the
whole pipeline, and the greedy / logprob columns of the packed result
through `Sampler.finalize`. Tolerance 1e-5 (float32 on both sides);
masks and token ids exact. Random draws differ by design (torch
generators vs threefry) and are not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxParams)
from aphrodite_tpu.common.sequence import SequenceData as JaxData
from aphrodite_tpu.modeling import sampling_metadata as jsm
from aphrodite_tpu.modeling.layers import sampler as js
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import SequenceData
from aphrodite_tpu_torch.modeling import sampling_metadata as tsm
from aphrodite_tpu_torch.modeling.layers import sampler as ts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 64
KNOBS = [
    dict(temperature=0.0),
    dict(temperature=0.7, top_p=0.8, top_k=10, repetition_penalty=1.3,
         presence_penalty=0.4, frequency_penalty=0.2),
    dict(temperature=1.2, min_p=0.05, top_a=0.2, tfs=0.9,
         custom_token_bans=[3, 5]),
    dict(temperature=0.9, eta_cutoff=3.0, epsilon_cutoff=2.0,
         typical_p=0.8, smoothing_factor=0.3, dynatemp_range=0.5),
]


# Every stage active on every row (the whole-pipeline test): a neutral
# knob (tfs 1.0, typical_p 1.0) puts its threshold exactly at the end of
# a float cumulative sum, where the two frameworks' summation orders may
# mask the last token differently.
KNOBS_ALL = [dict(temperature=0.8 + 0.1 * i, top_p=0.9, top_k=30,
                  min_p=0.01, top_a=0.05, tfs=0.95, eta_cutoff=2.0,
                  epsilon_cutoff=1.0, typical_p=0.9, smoothing_factor=0.2,
                  repetition_penalty=1.1, custom_token_bans=[i])
             for i in range(4)]
# Rows where a stage's knob is active (neutral rows: see KNOBS_ALL).
ACTIVE_ROWS = {"_apply_tfs": [2], "_apply_typical_sampling": [3]}


def _metadata(params_cls, data_cls, meta_mod, knobs=KNOBS):
    groups, data = [], {}
    for i, kw in enumerate(knobs):
        d = data_cls([(i * 7 + j) % VOCAB for j in range(5 + i)])
        for j in range(i):
            d.append_token_id((i + 3 * j) % VOCAB, -1.0)
        data[i] = d
        groups.append(([i], params_cls(**kw)))
    return meta_mod.SamplingMetadata(
        seq_groups=groups, seq_data=data, prompt_lens=[],
        selected_token_indices=np.arange(len(KNOBS)),
        categorized_sample_indices={})


def _tensors(knobs=KNOBS):
    jt, _ = jsm.build_sampling_tensors(
        _metadata(JaxParams, JaxData, jsm, knobs), VOCAB)
    tt, _ = tsm.build_sampling_tensors(
        _metadata(SamplingParams, SequenceData, tsm, knobs), VOCAB)
    return jt, tt


def _logits(seed=0):
    return np.random.default_rng(seed).normal(
        size=(len(KNOBS), VOCAB)).astype(np.float32) * 3


def test_knob_tensors_match():
    jt, tt = _tensors()
    for name in ("temperatures", "top_ps", "top_ks", "min_ps", "top_as",
                 "tfss", "eta_cutoffs", "epsilon_cutoffs", "typical_ps",
                 "smoothing_factors", "repetition_penalties",
                 "prompt_tokens", "output_tokens", "banned_tokens",
                 "dynatemp_mins", "dynatemp_maxs"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    for flag in ("do_penalties", "do_temperatures", "do_top_p_top_k",
                 "do_top_as", "do_min_p", "do_tfss", "do_eta_cutoffs",
                 "do_epsilon_cutoffs", "do_typical_ps", "do_quadratic",
                 "do_token_bans", "do_mirostat"):
        assert getattr(tt, flag) == getattr(jt, flag), flag


@pytest.mark.parametrize("stage", [
    "_apply_penalties", "_apply_temperatures", "_apply_alphabet_soup",
    "_apply_tfs", "_apply_eta_cutoff", "_apply_epsilon_cutoff",
    "_apply_typical_sampling", "_apply_quadratic", "_apply_token_bans"])
def test_stage_matches_jax(stage):
    jt, tt = _tensors()
    x = _logits(1)
    want = np.asarray(getattr(js, stage)(jnp.asarray(x), jt))
    got = getattr(ts, stage)(torch.from_numpy(x), tt).numpy()
    rows = ACTIVE_ROWS.get(stage, slice(None))
    want, got = want[rows], got[rows]
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = ~np.isneginf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


def test_whole_pipeline_matches_jax():
    jt, tt = _tensors(KNOBS_ALL)
    x = _logits(2)
    keys = js._make_row_keys(jnp.zeros(len(KNOBS), jnp.int32),
                             jnp.zeros(len(KNOBS), jnp.int32),
                             jnp.zeros(len(KNOBS), jnp.int32))
    want, _ = js._process_logits(jnp.asarray(x), jt, keys)
    got, _ = ts._process_logits(torch.from_numpy(x), tt, ())
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = ~np.isneginf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


def test_mirostat_deterministic_part_matches_jax():
    """With mu below every surprise but the argmin's, mirostat keeps one
    token: the one-hot logits and the updated mu are deterministic."""
    def meta(params_cls, data_cls, mod):
        return mod.SamplingMetadata(
            seq_groups=[([0], params_cls(temperature=1.0, mirostat_mode=2,
                                         mirostat_tau=0.01,
                                         mirostat_eta=0.1))],
            seq_data={0: data_cls([1, 2, 3])}, prompt_lens=[],
            selected_token_indices=np.arange(1),
            categorized_sample_indices={})
    jt, _ = jsm.build_sampling_tensors(meta(JaxParams, JaxData, jsm), VOCAB)
    tt, _ = tsm.build_sampling_tensors(
        meta(SamplingParams, SequenceData, tsm), VOCAB)
    x = _logits(3)[:1]
    keys = js._make_row_keys(jnp.zeros(1, jnp.int32),
                             jnp.zeros(1, jnp.int32),
                             jnp.zeros(1, jnp.int32))
    w_logits, w_mu = js._process_logits(jnp.asarray(x), jt, keys)
    g_logits, g_mu = ts._process_logits(torch.from_numpy(x), tt, [5])
    np.testing.assert_array_equal(g_logits.numpy(), np.asarray(w_logits))
    np.testing.assert_allclose(g_mu.numpy(), np.asarray(w_mu), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("num_topk", [0, 3])
def test_greedy_and_logprob_packing_matches_jax(num_topk):
    """Greedy rows: token, lp(greedy) and the top-k logprob columns of
    the packed result, and the SequenceOutputs finalize assembles."""
    def meta(params_cls, data_cls, mod):
        return mod.SamplingMetadata(
            seq_groups=[([i], params_cls(temperature=0.0,
                                         logprobs=num_topk or None))
                        for i in range(4)],
            seq_data={i: data_cls([i, i + 1]) for i in range(4)},
            prompt_lens=[], selected_token_indices=np.arange(4),
            categorized_sample_indices={})
    x = _logits(4)
    jmeta = meta(JaxParams, JaxData, jsm)
    tmeta = meta(SamplingParams, SequenceData, tsm)
    jsamp, tsamp = js.Sampler(VOCAB), ts.Sampler(VOCAB)
    jplan, tplan = jsamp.plan(jmeta), tsamp.plan(tmeta)
    assert (jplan.max_best_of, jplan.num_topk) == \
        (tplan.max_best_of, tplan.num_topk)
    want, _ = js.fused_sample(
        jnp.asarray(x), jplan.tensors, jnp.asarray(jplan.bases),
        jnp.asarray(jplan.salt1), jnp.asarray(jplan.salt2),
        max_best_of=jplan.max_best_of, num_topk=jplan.num_topk,
        need_logprobs=False)
    got, _ = ts.fused_sample(
        torch.from_numpy(x), tplan.tensors, tplan.bases, tplan.salt1,
        tplan.salt2, max_best_of=tplan.max_best_of,
        num_topk=tplan.num_topk, need_logprobs=False,
        draw_rows=tplan.draw_rows)
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape
    w_int = 1 + tplan.max_best_of + tplan.num_topk
    np.testing.assert_array_equal(got[:, 0], want[:, 0])          # greedy
    np.testing.assert_array_equal(got[:, 1 + tplan.max_best_of:w_int],
                                  want[:, 1 + tplan.max_best_of:w_int])
    gf, wf = got[:, w_int:].view(np.float32), want[:, w_int:].view(
        np.float32)
    cols = [0] + list(range(1 + tplan.max_best_of,
                            1 + tplan.max_best_of + tplan.num_topk)) + [-1]
    np.testing.assert_allclose(gf[:, cols], wf[:, cols], rtol=1e-5,
                               atol=1e-5)
    gout = tsamp.finalize(tmeta, tplan, got, None)
    wout = jsamp.finalize(jmeta, jplan, want, None)
    for g, w in zip(gout, wout):
        assert g.samples[0].output_token == w.samples[0].output_token
        assert g.samples[0].logprobs.keys() == w.samples[0].logprobs.keys()
        for tok, lp in w.samples[0].logprobs.items():
            assert abs(g.samples[0].logprobs[tok] - lp) < 1e-5


def test_seeded_draws_are_reproducible_and_batch_independent():
    """Seeded rows draw from their own (seed, position) generator: the
    same request samples the same token alone or in a batch."""
    x = torch.from_numpy(_logits(5))
    seeds = ts.row_seeds([7, 7, 9, 7], [3, 3, 3, 4], [0, 0, 0, 0])
    a = ts._categorical(x[[0, 0, 0, 0]], seeds, 2)
    b = ts._categorical(x[:1], seeds[:1], 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], a[1])
    assert ts.row_seed(7, 3, 0) != ts.row_seed(7, 4, 0)
