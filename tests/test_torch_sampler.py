"""The sampler of the PyTorch port against the JAX package's: each
stage of the logits pipeline on the same knob tensors and logits, the
whole pipeline, the greedy / logprob columns of the packed result
through `Sampler.finalize`, and the random draws. Tolerance 1e-5
(float32 on both sides); masks and token ids exact.

Random draws (`modeling/layers/prng.py` against `jax.random` on the
CPU): keys, random bits and uniforms bit-equal over seeds that include
0, 2**31 - 1, 2**31, 2**32 + 5 and -1; Gumbel noise within 2 ulp (the
two frameworks' `log` may round differently); categorical draws equal
for num 1 and 3; the whole packed `fused_sample` result equal on seeded
rows, mirostat included.
"""
import jax
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
from aphrodite_tpu_torch.modeling.layers import prng
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
    got, _ = ts._process_logits(torch.from_numpy(x), tt,
                                torch.from_numpy(_key_array(keys)))
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
    g_logits, g_mu = ts._process_logits(torch.from_numpy(x), tt,
                                        torch.from_numpy(_key_array(keys)))
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
    """A row's draws depend on its (seed, salt1, salt2) key and its
    logits alone: the same request samples the same tokens alone or in
    a batch, and another output position draws from another key."""
    x = torch.from_numpy(_logits(5))
    keys = prng.row_keys(torch.tensor([7, 7, 9, 7]),
                         torch.tensor([3, 3, 3, 4]),
                         torch.tensor([0, 0, 0, 0]))
    a = prng.categorical(keys, x[[0, 0, 0, 0]], 2)
    b = prng.categorical(keys[:1], x[:1], 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], a[1])
    assert not torch.equal(keys[0], keys[3])
    # The sampler draws only its random rows; theirs are unchanged and
    # the others hold the argmax.
    rows = torch.tensor([1, 3])
    got = ts._sample_tokens(x, keys, 2, 0, rows)[1]
    want = ts._sample_tokens(x, keys, 2, 0)[1]
    assert torch.equal(got[rows], want[rows])
    assert torch.equal(got[0], x[0].argmax().repeat(2))


@pytest.mark.parametrize("draw_rows,folds", [([], 0), ([1, 3], 1),
                                              (None, 1)])
def test_keys_are_folded_only_when_a_row_draws(monkeypatch, draw_rows,
                                               folds):
    """A step in which every row is greedy folds no threefry keys; one in
    which some row draws folds them once for the batch."""
    calls = []
    real = prng.row_keys
    monkeypatch.setattr(prng, "row_keys",
                        lambda *a: calls.append(1) or real(*a))
    _, tt = _tensors()
    zeros = torch.zeros(len(KNOBS), dtype=torch.int64)
    rows = None if draw_rows is None else torch.tensor(draw_rows,
                                                       dtype=torch.int64)
    packed, _ = ts.fused_sample(torch.from_numpy(_logits(6)), tt, zeros,
                                zeros, zeros, max_best_of=1, num_topk=0,
                                need_logprobs=False, draw_rows=rows)
    assert len(calls) == folds
    assert packed.shape[0] == len(KNOBS)


# ------------------------------------------------- JAX's threefry draws --

SEEDS = np.array([0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -1, 977],
                 dtype=np.int64)
SALT1 = np.array([0, 3, 2 ** 31 - 1, 17, 5, 0], dtype=np.int32)
SALT2 = np.array([0, 1, 0, 2, 0, 1], dtype=np.int32)


def _key_array(keys) -> np.ndarray:
    """JAX uint32 keys [rows, 2] as the port's int64 key tensor data."""
    return np.asarray(keys).astype(np.int64)


def _jax_keys():
    """The JAX sampler's own row keys (`_make_row_keys` over the host
    int64 bases, which JAX with x64 off holds as int32)."""
    return js._make_row_keys(jnp.asarray(SEEDS), jnp.asarray(SALT1),
                             jnp.asarray(SALT2))


def _port_keys():
    return prng.row_keys(torch.from_numpy(SEEDS), torch.from_numpy(SALT1),
                         torch.from_numpy(SALT2))


def test_prng_key_and_fold_in_are_bit_equal():
    for seed in SEEDS:
        want = np.asarray(jax.random.PRNGKey(int(seed))).astype(np.int64)
        got = prng.prng_key(torch.tensor([int(seed)]))[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(seed))
        for data in (0, 1, 2 ** 31 - 1, 12345):
            want_f = jax.random.fold_in(jax.random.PRNGKey(int(seed)), data)
            got_f = prng.fold_in(prng.prng_key(torch.tensor([int(seed)])),
                                 torch.tensor([data]))[0].numpy()
            np.testing.assert_array_equal(got_f, _key_array(want_f))
    np.testing.assert_array_equal(_port_keys().numpy(),
                                  _key_array(_jax_keys()))


@pytest.mark.parametrize("shape", [(1000,), (3, 257)])
def test_random_bits_and_uniform_are_bit_equal(shape):
    jkeys = np.asarray(_jax_keys())
    keys = _port_keys()
    bits = prng.random_bits(keys, shape).numpy()
    uni = prng.uniform(keys, shape).numpy()
    tiny = np.finfo(np.float32).tiny
    lo = prng.uniform(keys, shape, minval=tiny).numpy()
    for r, k in enumerate(jkeys):
        k = jnp.asarray(k)
        np.testing.assert_array_equal(
            bits[r], np.asarray(jax.random.bits(k, shape, jnp.uint32)
                                ).astype(np.int64))
        np.testing.assert_array_equal(
            uni[r].view(np.int32),
            np.asarray(jax.random.uniform(k, shape)).view(np.int32))
        np.testing.assert_array_equal(
            lo[r].view(np.int32),
            np.asarray(jax.random.uniform(k, shape, minval=tiny)
                       ).view(np.int32))


def test_gumbel_is_within_two_ulp():
    """-log(-log(u)) from bit-equal uniforms: the two frameworks' `log`
    may each round differently by an ulp. The inner log's relative error
    passes to the outer one as an absolute error of about 2**-23, so the
    ulp is taken at max(|g|, 1): near g = 0 the output's own ulp is far
    smaller than what the inner rounding leaves."""
    shape = (4, 1000)
    got = prng.gumbel(_port_keys(), shape).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), shape))
                     for k in np.asarray(_jax_keys())])
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()


@pytest.mark.parametrize("num", [None, 1, 3])
def test_categorical_draws_are_equal(num):
    logits = np.random.default_rng(6).normal(
        size=(len(SEEDS), 500)).astype(np.float32) * 2
    logits[2, 100:] = -np.inf                    # masked tokens
    if num is None:
        want = jax.vmap(lambda k, lg: jax.random.categorical(k, lg))(
            _jax_keys(), jnp.asarray(logits))
    else:
        want = jax.vmap(lambda k, lg: jax.random.categorical(
            k, lg, shape=(num,)))(_jax_keys(), jnp.asarray(logits))
    got = prng.categorical(_port_keys(), torch.from_numpy(logits), num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[2] < 100).all()


SEEDED = [
    dict(temperature=0.8, top_p=0.9, seed=7),
    dict(temperature=1.0, seed=2 ** 31 + 3, best_of=3, n=3),
    dict(temperature=0.7, top_k=20, seed=-1),
    dict(temperature=1.0, mirostat_mode=2, mirostat_tau=3.0,
         mirostat_eta=0.1, seed=2 ** 32 + 5),
    dict(temperature=0.0),
]


@pytest.mark.parametrize("num_topk", [0, 2])
def test_fused_sample_on_seeded_rows_equals_jax(num_topk):
    """The whole packed result on seeded rows (one with mirostat, one
    drawing 3 of best_of 3, seeds 2**31 + 3, -1 and 2**32 + 5): greedy
    token, draws and top-k ids exactly, the float columns (logprobs,
    mirostat mu) within 1e-5; and the tokens finalize assembles, beside
    an unseeded greedy row."""
    def meta(params_cls, data_cls, mod):
        groups, data = [], {}
        for i, kw in enumerate(SEEDED):
            d = data_cls([(i * 5 + j) % VOCAB for j in range(3 + i)])
            for j in range(i):
                d.append_token_id((i + 2 * j) % VOCAB, -1.0)
            data[i] = d
            groups.append(([i], params_cls(logprobs=num_topk or None,
                                           **kw)))
        return mod.SamplingMetadata(
            seq_groups=groups, seq_data=data, prompt_lens=[],
            selected_token_indices=np.arange(len(SEEDED)),
            categorized_sample_indices={})
    x = np.random.default_rng(7).normal(
        size=(len(SEEDED), VOCAB)).astype(np.float32) * 2
    jmeta = meta(JaxParams, JaxData, jsm)
    tmeta = meta(SamplingParams, SequenceData, tsm)
    jsamp, tsamp = js.Sampler(VOCAB), ts.Sampler(VOCAB)
    jplan, tplan = jsamp.plan(jmeta), tsamp.plan(tmeta)
    assert tplan.tensors.do_mirostat
    np.testing.assert_array_equal(tplan.bases.numpy()[:4],
                                  np.asarray(jplan.bases)[:4])
    want, _ = js.fused_sample(
        jnp.asarray(x), jplan.tensors, jnp.asarray(jplan.bases),
        jnp.asarray(jplan.salt1), jnp.asarray(jplan.salt2),
        max_best_of=jplan.max_best_of, num_topk=jplan.num_topk,
        need_logprobs=False)
    got, _ = ts.fused_sample(
        torch.from_numpy(x), tplan.tensors, tplan.bases, tplan.salt1,
        tplan.salt2, max_best_of=tplan.max_best_of,
        num_topk=tplan.num_topk, need_logprobs=False)
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape
    # Seeded rows: every column. The unseeded (greedy) row's key mixes
    # process entropy, so there only the greedy token and its logprob.
    w_int = 1 + tplan.max_best_of + tplan.num_topk
    seeded = slice(0, 4)
    B = tplan.max_best_of
    np.testing.assert_array_equal(got[seeded, :1 + B], want[seeded, :1 + B])
    # Top-k ids where the logprob is finite (the mirostat row's one-hot
    # logits leave ties at -inf, which the two top-k order differently).
    finite = np.isfinite(want[seeded, w_int + 1 + B:w_int + 1 + B + num_topk]
                         .view(np.float32))
    np.testing.assert_array_equal(got[seeded, 1 + B:w_int][finite],
                                  want[seeded, 1 + B:w_int][finite])
    np.testing.assert_allclose(got[seeded, w_int:].view(np.float32),
                               want[seeded, w_int:].view(np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[4, 0], want[4, 0])
    np.testing.assert_allclose(got[4, w_int:w_int + 1].view(np.float32),
                               want[4, w_int:w_int + 1].view(np.float32),
                               rtol=1e-5, atol=1e-5)
    # The random rows' draws are not all the argmax: they did draw.
    assert (got[:4, 1:1 + tplan.max_best_of] != got[:4, :1]).any()
    gout = tsamp.finalize(tmeta, tplan, got, None)
    wout = jsamp.finalize(jmeta, jplan, want, None)
    for g, w in zip(gout, wout):
        assert [s.output_token for s in g.samples] == \
            [s.output_token for s in w.samples]
