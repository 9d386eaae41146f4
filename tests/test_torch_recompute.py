"""Activation recompute (`recompute_granularity` "selective" and "full",
models/transformer.py) on the CPU: within the port the loss and every
gradient equal "none"'s bit for bit, with dropout on too; against the JAX
package, whose layer body runs under `jax.checkpoint` at the same
granularity, one make_train_step step from the same state and batch.

Tolerances: bit equality inside the port (recompute runs the same
operations on the same inputs, and replays the dropout masks); against JAX
the step tolerances of tests/test_torch_training.py and
tests/test_torch_bert_t5.py: metrics 1e-5 relative, moments 1e-4 of each
leaf's largest magnitude.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import t5 as jt5
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.models import t5 as tt5
from megatron_tpu_torch.models import transformer as ttfm
from megatron_tpu_torch.ops import quantized as tq

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
GRANULARITIES = ("none", "selective", "full")
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=300, seq_length=32, compute_dtype="float32",
            attention_impl="flash")
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1)
B, S, S_DEC = 2, 32, 16


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


def _model_configs(family, granularity, **kw):
    kw = dict(TINY, recompute_granularity=granularity, **kw)
    if family == "llama":
        return jc.llama2_config("tiny", **kw), tc.llama2_config("tiny", **kw)
    if family == "mixtral":
        kw.update(ffn_hidden_size=96, num_experts=4,
                  moe_capacity_factor=1.25)
        return (jc.mixtral_config("tiny", **kw),
                tc.mixtral_config("tiny", **kw))
    if family == "bert":
        return jbert.bert_config(**kw), tbert.bert_config(**kw)
    return jt5.t5_config(**kw), tt5.t5_config(**kw)


def _batch(family, seed=0, n_micro=None):
    rs = np.random.RandomState(seed)
    lead = () if n_micro is None else (n_micro,)
    if family in ("llama", "mixtral"):
        return {"tokens": rs.randint(0, 300, lead + (B, S + 1)),
                "loss_mask": (rs.rand(*lead, B, S) > 0.2).astype(
                    np.float32)}
    if family == "bert":
        pad = np.ones(lead + (B, S), np.int64)
        pad[..., 1, 20:] = 0
        return {"tokens": rs.randint(0, 300, lead + (B, S)),
                "labels": rs.randint(0, 300, lead + (B, S)),
                "loss_mask": (rs.rand(*lead, B, S) < 0.3).astype(np.float32),
                "padding_mask": pad,
                "is_random": rs.randint(0, 2, lead + (B,))}
    pad = np.ones(lead + (B, S), np.int64)
    pad[..., 1, 20:] = 0
    return {"text_enc": rs.randint(0, 300, lead + (B, S)),
            "text_dec": rs.randint(0, 300, lead + (B, S_DEC)),
            "labels": rs.randint(0, 300, lead + (B, S_DEC)),
            "loss_mask": (rs.rand(*lead, B, S_DEC) < 0.8).astype(np.float32),
            "enc_mask": pad}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_model(family, cfg, seed=0):
    if family == "bert":
        return tbert.BertModel(cfg, device="cpu", seed=seed, trainable=True)
    if family == "t5":
        return tt5.T5Model(cfg, device="cpu", seed=seed, trainable=True)
    return tlm.LanguageModel(cfg, device="cpu", seed=seed, trainable=True)


def _port_loss(family, model, batch, cfg, generator):
    det = generator is None
    if family == "bert":
        return tbert.bert_loss(model, batch, cfg, generator=generator,
                               deterministic=det)
    if family == "t5":
        return tt5.t5_loss(model, batch, cfg, generator=generator,
                           deterministic=det)
    return tlm.loss_fn(model, batch["tokens"], cfg,
                       loss_mask=batch["loss_mask"], generator=generator,
                       deterministic=det)


def _loss_and_grads(family, granularity, dropout):
    """The port's loss and grads at `granularity`, the layers' calls
    counted, and a draw from the generator after the backward (the
    generator must end where "none" leaves it)."""
    _, cfg = _model_configs(family, granularity,
                            **(DROPOUT if dropout else {}))
    model = _port_model(family, cfg)
    gen = torch.Generator().manual_seed(7) if dropout else None
    calls = []
    orig = ttfm.layer_apply

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    ttfm.layer_apply = counted
    try:
        loss = _port_loss(family, model, _t(_batch(family)), cfg, gen)
        loss.backward()
    finally:
        ttfm.layer_apply = orig
    after = (None if gen is None else
             torch.randint(0, 1 << 30, (4,), generator=gen).tolist())
    return (loss.detach(), {k: p.grad for k, p in model.named_parameters()
                            if p.grad is not None},
            len(calls), after)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("family", ["llama", "mixtral", "bert", "t5"])
def test_recompute_equals_none_bit_for_bit(family, dropout):
    """Each layer runs twice under recompute (forward, then again in the
    backward), the dropout masks drawn again equal, so the loss and every
    gradient equal "none"'s exactly and the generator ends where it did."""
    base = _loss_and_grads(family, "none", dropout)
    for granularity in GRANULARITIES[1:]:
        loss, grads, calls, after = _loss_and_grads(family, granularity,
                                                    dropout)
        assert calls == 2 * base[2], granularity
        assert torch.equal(loss, base[0]), granularity
        assert after == base[3], granularity
        assert grads.keys() == base[1].keys()
        for name, g in grads.items():
            assert torch.equal(g, base[1][name]), (granularity, name)


def _backward_products(family, granularity):
    """The weight-GEMM products (`qdense`'s) that run in the backward."""
    _, cfg = _model_configs(family, granularity)
    model = _port_model(family, cfg)
    loss = _port_loss(family, model, _t(_batch(family)), cfg, None)
    calls = []
    orig = tq._product

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tq._product = counted
    try:
        loss.backward()
    finally:
        tq._product = orig
    return len(calls)


@pytest.mark.parametrize("family,per_layer", [("llama", 5), ("mixtral", 3)])
def test_selective_recomputes_no_weight_gemm(family, per_layer):
    """"full" runs each layer's weight GEMMs again in the backward (QKV
    as q and kv, the output projection, the MLP's two; Mixtral's experts
    are batched products outside qdense); "selective" hands back the kept
    outputs and runs none, as "none" does."""
    assert _backward_products(family, "none") == 0
    assert _backward_products(family, "selective") == 0
    assert (_backward_products(family, "full")
            == per_layer * TINY["num_layers"])


def _gemm_case(case):
    """(x, w, quantized_gemm) of one layout a weight GEMM may meet."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 16, generator=g)
    w = torch.randn(16, 24, generator=g)
    if case == "strided_x":
        x = torch.randn(6, 2, 16, generator=g).transpose(0, 1)
    elif case == "frozen_w_strided_x":
        x = torch.randn(6, 2, 16, generator=g).transpose(0, 1)
        return x.requires_grad_(), w, "none"
    elif case == "frozen_w":
        return x.requires_grad_(), w, "none"
    elif case == "rows":
        x = x.reshape(12, 16)
    elif case == "column_major_w":
        w = torch.randn(24, 16, generator=g).t()
    elif case == "glu_w":
        w = w.reshape(16, 2, 12)
    return (x.requires_grad_(), w.requires_grad_(),
            "int8" if case == "int8" else "none")


@pytest.mark.parametrize("case", ["plain", "strided_x", "frozen_w",
                                  "frozen_w_strided_x", "rows",
                                  "column_major_w", "glu_w", "int8"])
def test_kept_gemm_backward_is_the_products(case):
    """Under the selective tape a product's kept output backpropagates as
    the product does, bit for bit, and the recompute runs no product but
    the one torch would compute as a broadcast bmm (a frozen w beside an
    x whose leading dims do not fold)."""
    x, w, mode = _gemm_case(case)

    def f(t, g):
        return (tq.qdense(t, w, mode).tanh() * 3.0).sum()

    def grads(loss):
        leaves = [t for t in (x, w) if t.requires_grad]
        return torch.autograd.grad(loss, leaves)

    want = grads(f(x, None))
    loss = ttfm.recompute(f, x, "selective")
    calls = []
    orig = tq._product

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tq._product = counted
    try:
        got = grads(loss)
    finally:
        tq._product = orig
    assert len(calls) == (1 if case == "frozen_w_strided_x" else 0)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b), case


def _drop_path_and_lima():
    """The LM's other stochastic branches: drop-path and the LIMA ramp."""
    out = {}
    for granularity in GRANULARITIES:
        cfg = tc.llama2_config("tiny", **TINY, drop_path_rate=0.2,
                               lima_dropout=True, hidden_dropout=0.2,
                               recompute_granularity=granularity)
        model = tlm.LanguageModel(cfg, device="cpu", seed=2, trainable=True)
        gen = torch.Generator().manual_seed(11)
        batch = _t(_batch("llama", 1))
        loss = tlm.loss_fn(model, batch["tokens"], cfg, generator=gen,
                           deterministic=False)
        loss.backward()
        out[granularity] = (loss.detach(),
                            [p.grad for p in model.parameters()])
    return out


def test_recompute_replays_drop_path_and_the_lima_ramp():
    out = _drop_path_and_lima()
    for granularity in GRANULARITIES[1:]:
        assert torch.equal(out[granularity][0], out["none"][0])
        for a, b in zip(out[granularity][1], out["none"][1]):
            assert torch.equal(a, b)


def test_recompute_needs_grad_and_skips_a_kv_cache():
    """Under no_grad (serving, evaluation) no layer runs twice."""
    _, cfg = _model_configs("llama", "full")
    model = tlm.LanguageModel(cfg, device="cpu")
    toks = _t(_batch("llama"))["tokens"]
    with torch.no_grad():
        got = tlm.loss_fn(model, toks, cfg)
    _, none_cfg = _model_configs("llama", "none")
    with torch.no_grad():
        want = tlm.loss_fn(model, toks, none_cfg)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="recompute_granularity"):
        ttfm.recompute(lambda x, g: x, torch.ones(1), "block")


def _jax_state_and_step(family, jcfg, seed=0):
    if family in ("llama", "mixtral"):
        return (jts.init_train_state(jax.random.PRNGKey(seed), jcfg),
                jts.make_train_step(jcfg, mesh=None, donate=False))
    mod = jbert if family == "bert" else jt5
    params = getattr(mod, f"{family}_init")(jax.random.PRNGKey(seed),
                                            jcfg.model)
    jloss = getattr(mod, f"{family}_loss")
    return (jts.state_from_params(params, jcfg),
            jts.make_train_step(
                jcfg, mesh=None, donate=False,
                loss_fn=lambda p, mb, r: jloss(p, mb, jcfg.model),
                init_params_fn=lambda: params,
                axes_fn=getattr(mod, f"{family}_axes")))


@pytest.mark.parametrize("family", ["llama", "mixtral", "bert", "t5"])
@pytest.mark.parametrize("granularity", ["selective", "full"])
def test_recompute_step_matches_jax(family, granularity):
    """One make_train_step step over 2 microbatches at the same
    granularity in both packages, from the same state."""
    models = _model_configs(family, granularity)
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, clip_grad=1.0,
               weight_decay=0.1)
    tr = dict(micro_batch_size=B, global_batch_size=2 * B, train_iters=10)
    jcfg = jc.MegatronConfig(model=models[0],
                             optimizer=jc.OptimizerConfig(**opt),
                             training=jc.TrainingConfig(**tr))
    tcfg = tc.MegatronConfig(model=models[1],
                             optimizer=tc.OptimizerConfig(**opt),
                             training=tc.TrainingConfig(**tr))
    jstate, jstep = _jax_state_and_step(family, jcfg)
    model_cls = {"bert": tbert.BertModel, "t5": tt5.T5Model}.get(
        family, tlm.LanguageModel)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu",
                                    model_cls=model_cls)
    if family in ("bert", "t5"):
        tloss = tbert.bert_loss if family == "bert" else tt5.t5_loss
        tstep = tts.make_train_step(
            tcfg, loss_fn=lambda m, mb, g: tloss(m, mb, tcfg.model),
            device="cpu")
    else:
        tstep = tts.make_train_step(tcfg, device="cpu")
    batch = _batch(family, 3, n_micro=2)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       None)
    tstate, tm = tstep(tstate, _t(batch))
    for key in ("lm_loss", "grad_norm"):
        assert _rel_err(float(tm[key]), float(jm[key])) < 1e-5, key
    _, opt_state, _ = train_state_to_numpy(tstate)
    jmu = _flatten(jstate.opt_state.mu)
    for name, want in jmu.items():
        assert _rel_err(opt_state["mu"][name], want) < 1e-4, name
