"""The port's dropout (ops/dropout.py) and the model's dropout paths on the
CPU. torch cannot reproduce jax.random's bits, so the masks are held to the
reference's law rather than its draws:

- the keep share within a binomial 5-sigma band of 1 - p, every kept
  element scaled by exactly 1 / (1 - p) (the mean preserved), every dropped
  one exactly 0;
- drop-path constant over each sample;
- rate 0 and a None generator are the identity; the same generator seed
  gives the same masks, another seed others;
- the LIMA ramp is the reference's (first layer exactly 0), and a one-layer
  stack under it drops nothing; the LM's embedding output is dropped
  before the stack, as the reference's model_forward drops it;
- attention dropout on the dot path equals the flash path's for the same
  generator seed (both keep by the flash kernels' counter hash), within
  the 1e-5 relative of tests/test_torch_bert_t5.py.
"""
import math

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.models import transformer as jtfm
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.models import t5 as tt5
from megatron_tpu_torch.models import transformer as ttfm
from megatron_tpu_torch.ops.dropout import drop_path, dropout

torch.set_num_threads(2)
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=300, seq_length=64, compute_dtype="float32")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_share_and_scale(rate):
    x = torch.randn(64, 1024, generator=_gen(0)) + 3.0
    y = dropout(_gen(1), x, rate)
    kept = y != 0
    n = x.numel()
    sigma = math.sqrt(n * rate * (1 - rate))
    assert abs(kept.sum().item() - n * (1 - rate)) < 5 * sigma
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0,
                               atol=0)
    # mean preserved: E[y] = x, within 5 sigma of the sample mean
    spread = (x.abs().max() / (1 - rate)).item() / math.sqrt(n)
    assert abs((y - x).mean().item()) < 5 * spread


def test_dropout_identity_and_seeds():
    x = torch.randn(8, 32, generator=_gen(0))
    assert dropout(None, x, 0.3) is x
    assert dropout(_gen(1), x, 0.0) is x
    assert drop_path(None, x, 0.3) is x
    assert torch.equal(dropout(_gen(5), x, 0.3), dropout(_gen(5), x, 0.3))
    assert not torch.equal(dropout(_gen(5), x, 0.3),
                           dropout(_gen(6), x, 0.3))


def test_drop_path_is_constant_per_sample():
    rate = 0.5
    x = torch.rand(4096, 3, 5, generator=_gen(0)) + 1.0
    y = drop_path(_gen(2), x, rate)
    ratio = y / x
    per_sample = ratio.reshape(4096, -1)
    assert torch.equal(per_sample, per_sample[:, :1].expand_as(per_sample))
    kept = per_sample[:, 0] != 0
    torch.testing.assert_close(per_sample[kept, 0],
                               torch.full_like(per_sample[kept, 0],
                                               1 / (1 - rate)))
    sigma = math.sqrt(4096 * rate * (1 - rate))
    assert abs(kept.sum().item() - 4096 * (1 - rate)) < 5 * sigma


def test_lima_and_drop_path_ramps_match_jax():
    kw = dict(TINY, num_layers=5, hidden_dropout=0.2, drop_path_rate=0.3)
    for lima in (False, True):
        tcfg = tbert.bert_config(**kw, lima_dropout=lima)
        jcfg = jc.ModelConfig(**{**tcfg.__dict__})
        hidden, paths = ttfm.dropout_rates(tcfg, 5)
        # within an ulp: numpy's fp32 linspace rounds once from fp64, XLA's
        # accumulates in fp32
        for got, want in ((hidden, jtfm.lima_dropout_rates(jcfg, 5)),
                          (paths, jtfm.drop_path_rates(jcfg, 5))):
            want = np.asarray(want)
            np.testing.assert_allclose(np.float32(got), want, rtol=1e-6)
            assert got[0] == want[0] and got[-1] == want[-1]
        if lima:
            assert hidden[0] == 0.0
    hidden, paths = ttfm.dropout_rates(tbert.bert_config(**TINY), 3)
    assert hidden == [0.0] * 3 and paths == [None] * 3


def test_one_layer_lima_stack_drops_nothing():
    cfg = tbert.bert_config(**dict(TINY, num_layers=1), hidden_dropout=0.5,
                            lima_dropout=True)
    model = tbert.BertModel(cfg, device="cpu", seed=3)
    x = torch.randn(2, 16, 64, generator=_gen(0))
    want, _, _ = ttfm.stack_apply(model["transformer"], x, cfg,
                                  causal=False)
    got, _, _ = ttfm.stack_apply(model["transformer"], x, cfg, causal=False,
                                 deterministic=False, generator=_gen(1))
    assert torch.equal(got, want)


def test_lm_drops_its_embedding_output(monkeypatch):
    """A one-layer LIMA LM drops nothing in its stack, so all its hidden
    dropout is the embedding output's: the loss moves with the generator
    seed, and what reaches the stack keeps 1 - p of the embedding, each kept
    element scaled by exactly 1 / (1 - p)."""
    rate = 0.5
    cfg = tc.llama2_config("tiny", num_layers=1, hidden_size=64,
                           num_attention_heads=4, vocab_size=300,
                           seq_length=64, compute_dtype="float32",
                           hidden_dropout=rate, lima_dropout=True)
    model = tlm.LanguageModel(cfg, device="cpu", seed=5)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 300, (2, 65)))

    def loss(seed):
        with torch.no_grad():
            return tlm.loss_fn(model, toks, cfg, deterministic=False,
                               generator=_gen(seed)).item()

    base = tlm.loss_fn(model, toks, cfg).item()
    assert loss(1) == loss(1)
    assert len({loss(1), loss(2), base}) == 3

    seen = []
    stack_apply = ttfm.stack_apply

    def spy(params, x, *a, **kw):
        seen.append(x)
        return stack_apply(params, x, *a, **kw)

    monkeypatch.setattr(ttfm, "stack_apply", spy)
    loss(3)
    emb = model["embedding"]["word_embeddings"].detach()[toks[:, :-1]]
    got = seen[0]
    kept = got != 0
    n = emb.numel()
    sigma = math.sqrt(n * rate * (1 - rate))
    assert abs(kept.sum().item() - n * (1 - rate)) < 5 * sigma
    torch.testing.assert_close(got[kept], emb[kept] / (1 - rate), rtol=0,
                               atol=0)


def _bert_loss(cfg, model, seed, deterministic=False):
    rs = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rs.randint(0, 300, (2, 64))),
             "labels": torch.from_numpy(rs.randint(0, 300, (2, 64))),
             "loss_mask": torch.ones(2, 64),
             "padding_mask": torch.ones(2, 64, dtype=torch.long)}
    batch["padding_mask"][1, 40:] = 0
    with torch.no_grad():
        return tbert.bert_loss(
            model, batch, cfg, deterministic=deterministic,
            generator=None if seed is None else _gen(seed)).item()


@pytest.mark.parametrize("kind", ["hidden", "attention", "drop_path"])
def test_model_dropout_is_seeded_by_the_generator(kind):
    extra = {"hidden": dict(hidden_dropout=0.2, lima_dropout=True),
             "attention": dict(attention_dropout=0.2),
             "drop_path": dict(drop_path_rate=0.5)}[kind]
    cfg = tbert.bert_config(**TINY, attention_impl="flash", **extra)
    model = tbert.BertModel(cfg, device="cpu", seed=4)
    base = _bert_loss(cfg, model, None, deterministic=True)
    assert _bert_loss(cfg, model, 1) == _bert_loss(cfg, model, 1)
    assert _bert_loss(cfg, model, 1) != _bert_loss(cfg, model, 2)
    assert _bert_loss(cfg, model, 1) != base
    # eval: no generator, no dropout
    assert _bert_loss(cfg, model, None) == base


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_dot_path_attention_dropout_equals_flash(family):
    """The same generator seed drops the same attention weights on both
    paths: the bidirectional and padded encoders, and T5's causal decoder
    (its cross-attention runs no attention dropout, as the reference's)."""
    out = {}
    for impl in ("dot", "flash"):
        kw = dict(TINY, attention_impl=impl, attention_dropout=0.3,
                  hidden_dropout=0.1)
        rs = np.random.RandomState(0)
        if family == "bert":
            cfg = tbert.bert_config(**kw)
            model = tbert.BertModel(cfg, device="cpu", seed=5)
            out[impl] = _bert_loss(cfg, model, 9)
            continue
        cfg = tt5.t5_config(**kw)
        model = tt5.T5Model(cfg, device="cpu", seed=5)
        enc_mask = torch.ones(2, 64, dtype=torch.long)
        enc_mask[0, 50:] = 0
        batch = {"text_enc": torch.from_numpy(rs.randint(0, 300, (2, 64))),
                 "text_dec": torch.from_numpy(rs.randint(0, 300, (2, 32))),
                 "labels": torch.from_numpy(rs.randint(0, 300, (2, 32))),
                 "loss_mask": torch.ones(2, 32), "enc_mask": enc_mask}
        with torch.no_grad():
            out[impl] = tt5.t5_loss(model, batch, cfg, deterministic=False,
                                    generator=_gen(9)).item()
    assert abs(out["dot"] - out["flash"]) <= 1e-5 * abs(out["flash"])
