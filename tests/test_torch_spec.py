"""Speculative decoding in the PyTorch port against the JAX package, on
the tiny model of tests/conftest.py in float32 on the CPU (the plain
kernel versions). Mirrors tests/engine/test_spec_decode.py.

Both engines get the JAX engine's dummy weights (`params_from_jax`) and
the same pinned `num_gpu_blocks`. Tolerances:

- `delta_rejection_length`: exact cases.
- `rejection_sample` (threefry uniforms and Gumbel noise from a JAX key,
  split as `jax.random.split` splits it): output tokens and accept
  counts equal to the JAX function's on seeded inputs; the split keys
  bit-equal.
- Greedy and seeded generations: token for token equal across the
  port's spec run, its classic run (`APHRODITE_SPEC=0`) and the JAX
  engine's spec run (the tiny model's logits are far from ties on
  these prompts, so no gap rule is needed).
- The tiny model's greedy stream enters a cycle the drafter exploits:
  at least 8 accepted drafts.
- Verify rounds keep max_tokens exact, drop tokens verified past a stop
  string, mix drafted and undrafted rows, leak no page, and
  `APHRODITE_SPEC=0` keeps the drafter out of the loop.
- The verify batch: rows at positions L-1+j with ctx L+j, slots from
  the reserved table, salt1 offset by j on the host before the draw,
  padding rows with the out-of-range slot; its rows write through the
  slot scatter with shared pages (K4) and attend read-only (K1).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.engine.aphrodite_engine import (
    AphroditeEngine as JaxEngine)
from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
from aphrodite_tpu.modeling.layers.rejection import (
    rejection_sample as jax_rejection_sample)
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax, to_device
from aphrodite_tpu_torch.modeling.layers.rejection import (
    delta_rejection_length, rejection_sample, split_key)


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


NUM_BLOCKS = 64
ENGINE_KW = dict(load_format="dummy", dtype="float32", block_size=16,
                 max_model_len=256, max_num_seqs=8, swap_space=0.01,
                 disable_log_stats=True)
# A prompt whose tail n-gram recurs: the drafter proposes from the
# first decode step.
PATTERN = [11, 23, 37, 41]
PROMPT = PATTERN * 5


def engine_pair(model_dir, num_blocks=NUM_BLOCKS, scale=1.0, **kw):
    """The JAX engine and the port's on `model_dir`, the port given the
    JAX engine's dummy weights (times `scale`) and both the same pool."""
    args = dict(ENGINE_KW, **kw)
    jcfg = JaxEngineArgs(model=model_dir, **args).create_engine_configs()
    jcfg[1].num_gpu_blocks = num_blocks
    jax_engine = JaxEngine(*jcfg, log_stats=False,
                           skip_tokenizer_init=args.get(
                               "skip_tokenizer_init", False))
    params = jax_engine.executor.params
    if scale != 1.0:
        params = jax.tree_util.tree_map(lambda a: a * scale, params)
        jax_engine.executor.params = params
        jax_engine.executor.model_runner.params = params
    tcfg = EngineArgs(model=model_dir, device="cpu",
                      **args).create_engine_configs()
    tcfg[1].num_gpu_blocks = num_blocks
    port = AphroditeEngine(*tcfg, log_stats=False,
                           skip_tokenizer_init=args.get(
                               "skip_tokenizer_init", False))
    host = jax.tree_util.tree_map(np.asarray, params)
    tparams = to_device(params_from_jax(host), torch.device("cpu"),
                        torch.float32)
    port.executor.params = tparams
    port.executor.model_runner.params = tparams
    return jax_engine, port


def drain(engine):
    """Step until idle: ({request id: final RequestOutput}, steps)."""
    finals, steps = {}, 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                finals[out.request_id] = out
        steps += 1
        assert steps < 2000
    return finals, steps


def sampling(engine, **kw):
    cls = SamplingParams if isinstance(engine, AphroditeEngine) \
        else JaxSamplingParams
    return cls(**kw)


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    return engine_pair(tiny_model_dir)


def _run(engine, rid, prompt=None, **sp):
    engine.add_request(rid, None, sampling(engine, **sp),
                       prompt_token_ids=list(prompt or PROMPT))
    finals, steps = drain(engine)
    return finals[rid], steps


def _tokens(out):
    return list(out.outputs[0].token_ids)


def _three_way(engines, monkeypatch, rid, prompt=None, **sp):
    """(JAX spec, port classic, port spec) outputs of one request."""
    jax_engine, port = engines
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    jax_out, _ = _run(jax_engine, f"{rid}-jax", prompt, **sp)
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    classic, _ = _run(port, f"{rid}-classic", prompt, **sp)
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    spec, _ = _run(port, f"{rid}-spec", prompt, **sp)
    return jax_out, classic, spec


# ---- the rejection rules ----

@pytest.mark.parametrize("sampled,drafted,want", [
    ([1, 2, 3], [1, 2, 3], 3),
    ([1, 9, 3], [1, 2, 3], 1),
    ([9, 2, 3], [1, 2, 3], 0),
    ([1, 2, 3, 4], [1, 2], 2),
    ([], [], 0),
])
def test_delta_rejection_length(sampled, drafted, want):
    assert delta_rejection_length(sampled, drafted) == want


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_split_key_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    words = torch.from_numpy(
        np.asarray(jax.random.key_data(key)).astype(np.int64))
    want = np.asarray(jax.random.split(key, 3)).astype(np.int64)
    assert np.array_equal(split_key(words, 3).numpy(), want)


@pytest.mark.parametrize("seed,case", [(0, "random"), (1, "random"),
                                       (2, "same"), (3, "sparse")])
def test_rejection_sample_matches_jax(seed, case):
    """Equal outputs and accept counts for the same key: "same" draft
    and target distributions accept everything (bonus slot filled),
    "sparse" ones hold zeros (the floored log and the all-zero
    recovered fallback)."""
    rng = np.random.default_rng(seed)
    b, k, v = 6, 4, 97
    target = rng.random((b, k, v)).astype(np.float32)
    draft = rng.random((b, k, v)).astype(np.float32)
    if case == "same":
        draft = target.copy()
    if case == "sparse":
        target[target < 0.7] = 0.0
        draft[draft < 0.7] = 0.0
    target /= target.sum(-1, keepdims=True)
    draft /= draft.sum(-1, keepdims=True)
    draft_ids = rng.integers(0, v, (b, k)).astype(np.int32)
    if case == "sparse":
        # Half the drafts on tokens the target gives zero mass.
        draft_ids[:, 1] = np.argmin(target[:, 1], axis=-1)
    bonus = rng.integers(0, v, (b,)).astype(np.int32)
    key = jax.random.PRNGKey(100 + seed)
    want_out, want_n = jax_rejection_sample(
        key, jnp.asarray(target), jnp.asarray(bonus), jnp.asarray(draft),
        jnp.asarray(draft_ids))
    words = torch.from_numpy(
        np.asarray(jax.random.key_data(key)).astype(np.int64))
    got_out, got_n = rejection_sample(
        words, torch.from_numpy(target), torch.from_numpy(bonus),
        torch.from_numpy(draft), torch.from_numpy(draft_ids))
    assert np.array_equal(got_out.numpy(), np.asarray(want_out))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    if case == "same":
        assert (got_n.numpy() == k).all()


# ---- the engines: spec runs bit-equal to classic and to JAX ----

def test_greedy_spec_bit_equal_to_classic_and_jax(engines, monkeypatch):
    jax_out, classic, spec = _three_way(
        engines, monkeypatch, "greedy", temperature=0.0, max_tokens=24,
        ignore_eos=True)
    assert _tokens(spec) == _tokens(classic) == _tokens(jax_out)
    assert spec.outputs[0].text == classic.outputs[0].text == \
        jax_out.outputs[0].text


@pytest.mark.parametrize("seed", [7, 4242])
def test_seeded_spec_bit_equal(engines, monkeypatch, seed):
    """The verify row for output position n draws with salt1 = n, the
    salt classic decode uses at n, in both packages."""
    jax_out, classic, spec = _three_way(
        engines, monkeypatch, f"seed{seed}", temperature=1.0, seed=seed,
        max_tokens=20, ignore_eos=True)
    assert _tokens(spec) == _tokens(classic) == _tokens(jax_out)


def test_seeded_spec_with_knobs_bit_equal(engines, monkeypatch):
    jax_out, classic, spec = _three_way(
        engines, monkeypatch, "knobs", temperature=0.9, seed=99,
        top_p=0.8, top_k=40, max_tokens=16, ignore_eos=True)
    assert _tokens(spec) == _tokens(classic) == _tokens(jax_out)


def test_spec_round_actually_accepts(engines, monkeypatch):
    """The tiny model's greedy stream settles into a cycle; the drafter
    must land multi-token rounds there, and the output still equals the
    classic run's and the JAX spec run's."""
    jax_engine, port = engines
    observed = []
    orig = port.drafter.observe

    def spy(seq_id, proposed, accepted):
        observed.append((proposed, accepted))
        return orig(seq_id, proposed, accepted)

    monkeypatch.setattr(port.drafter, "observe", spy)
    jax_out, classic, spec = _three_way(
        engines, monkeypatch, "accept", temperature=0.0, max_tokens=80,
        ignore_eos=True)
    assert _tokens(spec) == _tokens(classic) == _tokens(jax_out)
    assert observed, "spec verify never ran on a repetitive stream"
    assert sum(a for _, a in observed) >= 8, observed


@pytest.mark.parametrize("cap", [1, 2, 5, 8])
def test_spec_respects_max_tokens_exactly(engines, monkeypatch, cap):
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    out, _ = _run(engines[1], f"cap-{cap}", temperature=0.0,
                  max_tokens=cap, ignore_eos=True)
    assert len(out.outputs[0].token_ids) == cap
    assert out.outputs[0].finish_reason == "length"


def test_spec_stop_string_drops_overrun(engines, monkeypatch):
    """Tokens verified past a satisfied stop are dropped: the output
    equals the classic stopped run's and the JAX spec run's."""
    jax_engine, port = engines
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    base, _ = _run(port, "stop-base", temperature=0.0, max_tokens=16,
                   ignore_eos=True)
    text = base.outputs[0].text
    stop = text[len(text) // 2:len(text) // 2 + 3]
    assert stop
    jax_out, classic, spec = _three_way(
        engines, monkeypatch, "stop", temperature=0.0, max_tokens=16,
        ignore_eos=True, stop=[stop])
    assert spec.outputs[0].text == classic.outputs[0].text == \
        jax_out.outputs[0].text
    assert _tokens(spec) == _tokens(classic) == _tokens(jax_out)
    assert spec.outputs[0].finish_reason == \
        classic.outputs[0].finish_reason == "stop"


def test_spec_batch_mixed_with_undrafted_rows(engines, monkeypatch):
    """A verify round carries 1-row groups for sequences with no
    proposal beside widened rows."""
    jax_engine, port = engines
    arbitrary = [5 + (i * 7) % 90 for i in range(12)]
    outs = {}
    for name, engine, spec in (("jax", jax_engine, "1"),
                               ("classic", port, "0"),
                               ("spec", port, "1")):
        monkeypatch.setenv("APHRODITE_SPEC", spec)
        for i, prompt in enumerate((PROMPT, arbitrary)):
            engine.add_request(f"mix-{name}-{i}", None, sampling(
                engine, temperature=0.0, max_tokens=12, ignore_eos=True),
                prompt_token_ids=list(prompt))
        finals, _ = drain(engine)
        outs[name] = [_tokens(finals[f"mix-{name}-{i}"]) for i in (0, 1)]
    assert outs["spec"] == outs["classic"] == outs["jax"]


def test_spec_no_kv_page_leak(engines, monkeypatch):
    port = engines[1]
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    bm = port.scheduler.block_manager
    assert not port.has_unfinished_requests()
    free0 = bm.get_num_free_gpu_blocks()
    verified = []
    real = port.executor.execute_spec_verify

    def spy(*a, **kw):
        verified.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(port.executor, "execute_spec_verify", spy)
    sp = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True)
    for i in range(3):
        port.add_request(f"leak-{i}", None, sp,
                         prompt_token_ids=list(PROMPT))
    drain(port)
    assert verified
    assert bm.get_num_free_gpu_blocks() == free0 == NUM_BLOCKS


def test_spec_disabled_flag_pins_classic(engines, monkeypatch):
    port = engines[1]
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    called = []
    monkeypatch.setattr(port.drafter, "propose",
                        lambda *a, **k: called.append(1) or [])
    _run(port, "pin-classic", temperature=0.0, max_tokens=6,
         ignore_eos=True)
    assert not called


# ---- the verify batch ----

def _decode_metadata(port, rid, prompt):
    """Run one request's prompt round and return the decode metadata of
    its sequence (with its table as the prompt round left it)."""
    from aphrodite_tpu_torch.common.sequence import SequenceGroupMetadata
    port.add_request(rid, None, SamplingParams(
        temperature=0.0, max_tokens=32, ignore_eos=True),
        prompt_token_ids=list(prompt))
    os.environ["APHRODITE_SPEC"] = "0"
    try:
        port.step()                         # the prompt round
    finally:
        os.environ.pop("APHRODITE_SPEC")
    group = port.scheduler.running[0]
    seq = group.get_seqs()[0]
    table = port.scheduler.block_manager.get_block_table(seq)
    md = SequenceGroupMetadata(
        request_id=rid, is_prompt=False,
        seq_data={seq.seq_id: seq.data},
        sampling_params=group.sampling_params,
        block_tables={seq.seq_id: list(table)}, persistent_data={})
    return md, seq, list(table)


def test_verify_batch_layout_and_salts(engines, monkeypatch):
    """k+1 single-seq rows per sequence at positions L-1+j, ctx L+j,
    slots from the table; salt1 = output_len + j on the host; padding
    rows carry the out-of-range slot and page ids. A table one page
    short of position L-1+k raises IndexError (the reservation
    contract), never a silent wrap."""
    port = engines[1]
    runner = port.executor.model_runner
    prompt = list(range(5, 5 + 30))           # L = 31 after one token
    md, seq, table = _decode_metadata(port, "layout", prompt)
    L = seq.get_len()
    ps = runner.page_size
    k = 2 * ps - L % ps                       # crosses into a new page
    need = -(-(L - 1 + k + 1) // ps)
    table = list(table) + [table[-1] + 1 + i
                           for i in range(need - len(table))]
    md.block_tables[seq.seq_id] = table
    draft = [7] * k
    inputs, sampling_md, offsets, rows = runner._prepare_spec_verify(
        [md], {seq.seq_id: draft})
    assert rows == [k + 1] and offsets == list(range(k + 1))
    meta = inputs["metadata"]
    pos = inputs["positions"][:k + 1, 0].tolist()
    assert pos == list(range(L - 1, L + k))
    assert meta.context_lens[:k + 1].tolist() == \
        list(range(L, L + k + 1))
    assert meta.slot_mapping[:k + 1].tolist() == [
        table[p // ps] * ps + p % ps for p in pos]
    assert inputs["input_ids"][:k + 1, 0].tolist() == \
        [seq.data.get_last_token_id()] + draft
    assert meta.spec_verify and inputs["num_rows"] == k + 1
    padded = inputs["input_ids"].shape[0]
    assert padded > k + 1
    assert (meta.slot_mapping[k + 1:] == runner.num_slots).all()
    assert (meta.block_tables[k + 1:] ==
            runner.num_slots // ps).all()
    plan = runner.sampler.plan(sampling_md, pad_to=padded,
                               salt1_offsets=offsets)
    base = len(seq.data.output_token_ids)
    # Unseeded rows: salt1 0 plus the row's offset, as in JAX.
    assert plan.salt1[:k + 1].tolist() == list(range(k + 1))
    md.sampling_params = SamplingParams(temperature=1.0, seed=3,
                                        max_tokens=32)
    inputs, sampling_md, offsets, _ = runner._prepare_spec_verify(
        [md], {seq.seq_id: draft})
    plan = runner.sampler.plan(sampling_md, pad_to=padded,
                               salt1_offsets=offsets)
    assert plan.salt1[:k + 1].tolist() == [base + j
                                           for j in range(k + 1)]
    md.block_tables[seq.seq_id] = table[:-1]
    with pytest.raises(IndexError):
        runner._prepare_spec_verify([md], {seq.seq_id: draft})
    port.abort_request("layout")
    drain(port)


def test_verify_rows_write_through_k4_and_attend_read_only(engines,
                                                           monkeypatch):
    """Every verify forward pass writes its rows with the slot scatter
    (shared pages allowed: `distinct_pages=False`) and calls decode
    attention without the fused write."""
    from aphrodite_tpu_torch.modeling.layers import attention
    port = engines[1]
    writes, reads = [], []
    real_w, real_a = attention.write_kv_pages, \
        attention.paged_decode_attention

    def spy_w(*a, **kw):
        writes.append(kw.get("distinct_pages"))
        return real_w(*a, **kw)

    def spy_a(q, kp, vp, tables, ctx, slopes, knew, vnew, **kw):
        reads.append(knew is None)
        return real_a(q, kp, vp, tables, ctx, slopes, knew, vnew, **kw)
    verifying = []
    real_v = port.executor.model_runner.execute_spec_verify

    def spy_v(*a, **kw):
        writes.clear()
        reads.clear()
        out = real_v(*a, **kw)
        verifying.append((list(writes), list(reads)))
        return out
    monkeypatch.setattr(attention, "write_kv_pages", spy_w)
    monkeypatch.setattr(attention, "paged_decode_attention", spy_a)
    monkeypatch.setattr(port.executor.model_runner, "execute_spec_verify",
                        spy_v)
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    _run(port, "routes", temperature=0.0, max_tokens=12, ignore_eos=True)
    layers = port.model_config.hf_config.num_hidden_layers
    assert verifying
    for w, r in verifying:
        assert w == [False] * layers and r == [True] * layers
