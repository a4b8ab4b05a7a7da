"""Model layers of the PyTorch port against the JAX package's, on the
same numpy inputs in float32: RMSNorm, fused add + RMSNorm, SiLU-and-mul,
rotary embeddings (plain and the scalings a Llama config may name),
the embedding and LM head, the fused linear layers, and dense prompt
attention (GQA, ALiBi, sliding window, cached prefix). Tolerance 1e-5
(absolute and relative; every function here is float32 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.modeling.layers import activation as jact
from aphrodite_tpu.modeling.layers import layernorm as jln
from aphrodite_tpu.modeling.layers import linear as jlin
from aphrodite_tpu.modeling.layers import rotary_embedding as jrope
from aphrodite_tpu.modeling.layers import vocab_embedding as jvoc
from aphrodite_tpu.ops import attention as jattn
from aphrodite_tpu_torch.modeling.layers import activation as tact
from aphrodite_tpu_torch.modeling.layers import layernorm as tln
from aphrodite_tpu_torch.modeling.layers import linear as tlin
from aphrodite_tpu_torch.modeling.layers import rotary_embedding as trope
from aphrodite_tpu_torch.modeling.layers import vocab_embedding as tvoc
from aphrodite_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_and_fused_add():
    r = _rng()
    x = r.normal(size=(3, 5, 64)).astype(np.float32)
    res = r.normal(size=x.shape).astype(np.float32)
    w = r.normal(size=(64,)).astype(np.float32)
    _close(tln.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jln.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    for residual in (None, res):
        got = tln.fused_add_rms_norm(
            torch.from_numpy(x),
            None if residual is None else torch.from_numpy(residual),
            torch.from_numpy(w), 1e-5)
        want = jln.fused_add_rms_norm(
            jnp.asarray(x),
            None if residual is None else jnp.asarray(residual),
            jnp.asarray(w), 1e-5)
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_silu_and_mul():
    x = _rng(1).normal(size=(4, 7, 2 * 48)).astype(np.float32)
    _close(tact.silu_and_mul(torch.from_numpy(x)),
           jact.silu_and_mul(jnp.asarray(x)))


@pytest.mark.parametrize("scaling,neox,rot", [
    (None, True, 32), (None, False, 32), (None, True, 16),
    ({"type": "linear", "factor": 2.0}, True, 32),
    ({"type": "dynamic", "factor": 2.0}, True, 32),
    ({"type": "yarn", "factor": 4.0,
      "original_max_position_embeddings": 256}, True, 32)])
def test_rotary_embedding(scaling, neox, rot):
    r = _rng(2)
    head = 32
    q = r.normal(size=(2, 9, 4, head)).astype(np.float32)
    k = r.normal(size=(2, 9, 2, head)).astype(np.float32)
    pos = r.integers(0, 500, size=(2, 9)).astype(np.int32)
    jr = jrope.get_rope(head, rot, 512, 10000.0, neox, scaling)
    tr = trope.get_rope(head, rot, 512, 10000.0, neox, scaling)
    np.testing.assert_array_equal(tr.cos_sin_cache, jr.cos_sin_cache)
    gq, gk = tr(torch.from_numpy(pos), torch.from_numpy(q),
                torch.from_numpy(k))
    wq, wk = jr(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(k))
    _close(gq, wq)
    _close(gk, wk)


def test_embedding_and_lm_head():
    r = _rng(3)
    vocab, hidden = 100, 32
    table = r.normal(size=(vocab, hidden)).astype(np.float32)
    ids = r.integers(0, vocab, size=(3, 6)).astype(np.int32)
    je = jvoc.VocabParallelEmbedding(vocab, hidden, dtype=jnp.float32)
    te = tvoc.VocabParallelEmbedding(vocab, hidden, dtype=torch.float32)
    jp, tp = {}, {}
    je.weight_loader(jp, "weight", table)
    te.weight_loader(tp, "weight", torch.from_numpy(table))
    assert tuple(tp["weight"].shape) == jp["weight"].shape
    _close(te(tp, torch.from_numpy(ids)),
           je({"weight": jnp.asarray(jp["weight"])}, jnp.asarray(ids)))
    hidden_states = r.normal(size=(5, hidden)).astype(np.float32)
    jh = jvoc.ParallelLMHead(vocab, hidden, dtype=jnp.float32)
    th = tvoc.ParallelLMHead(vocab, hidden, dtype=torch.float32)
    got = th.compute_logits(tp, torch.from_numpy(hidden_states))
    want = jh.compute_logits({"weight": jnp.asarray(jp["weight"])},
                             jnp.asarray(hidden_states))
    assert got.shape == (5, vocab)
    _close(got, want)


def test_fused_linear_layers_load_and_apply_like_jax():
    """HF q/k/v and gate/up shards load into the fused projections;
    applying them gives the JAX layers' outputs (torch keeps HF's
    [out, in] layout, JAX transposes)."""
    r = _rng(4)
    hidden, head, nh, nkv, inter = 32, 8, 4, 2, 48
    x = r.normal(size=(3, hidden)).astype(np.float32)
    shards = {s: r.normal(size=(n * head, hidden)).astype(np.float32)
              for s, n in (("q", nh), ("k", nkv), ("v", nkv))}
    jq = jlin.QKVParallelLinear(hidden, head, nh, nkv, dtype=jnp.float32)
    tq = tlin.QKVParallelLinear(hidden, head, nh, nkv, dtype=torch.float32)
    jp, tp = {}, {}
    for s, w in shards.items():
        jq.weight_loader(jp, "weight", w, s)
        tq.weight_loader(tp, "weight", torch.from_numpy(w), s)
    got = tq.split(tq(tp, torch.from_numpy(x)))
    want = jq.split(jq({"weight": jnp.asarray(jp["weight"])},
                       jnp.asarray(x)))
    for g, w in zip(got, want):
        _close(g, w)
    gu = [r.normal(size=(inter, hidden)).astype(np.float32)
          for _ in range(2)]
    jm = jlin.MergedColumnParallelLinear(hidden, [inter] * 2,
                                         dtype=jnp.float32)
    tm = tlin.MergedColumnParallelLinear(hidden, [inter] * 2,
                                         dtype=torch.float32)
    jp, tp = {}, {}
    for i, w in enumerate(gu):
        jm.weight_loader(jp, "weight", w, i)
        tm.weight_loader(tp, "weight", torch.from_numpy(w), i)
    _close(tm(tp, torch.from_numpy(x)),
           jm({"weight": jnp.asarray(jp["weight"])}, jnp.asarray(x)))


@pytest.mark.parametrize("case", ["plain", "alibi_window", "prefix"])
def test_prefill_attention(case):
    r = _rng(5)
    b, s, hq, hkv, d = 2, 12, 4, 2, 16
    kv_len = s + (8 if case == "prefix" else 0)
    q = r.normal(size=(b, s, hq, d)).astype(np.float32)
    k = r.normal(size=(b, kv_len, hkv, d)).astype(np.float32)
    v = r.normal(size=(b, kv_len, hkv, d)).astype(np.float32)
    ctx = np.array([8, 5] if case == "prefix" else [0, 0], np.int32)
    valid = ctx + np.array([12, 7], np.int32)
    kw = {}
    if case == "alibi_window":
        kw = dict(sliding_window=5,
                  slopes=np.array([0.5, 0.25, 0.125, 0.0625], np.float32))
    slopes = kw.pop("slopes", None)
    got = tattn.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ctx), torch.from_numpy(valid), 0.25,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        **kw)
    want = jattn.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ctx),
        jnp.asarray(valid), 0.25,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes), **kw)
    _close(got, want)
