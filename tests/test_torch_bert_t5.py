"""The port's BERT and T5 on the CPU against the JAX package, on the same
numpy inputs and the same weights (moved across by the bridge), in fp32.

Tolerances and why:
- logits 1e-5 relative to the largest magnitude: the same fp32 formulas
  summed in another order (measured ~1e-6);
- loss gradients 1e-4 relative per leaf: backward sums of many more terms,
  in another order;
- the plain flash forward and backward against the Pallas kernels in
  interpret mode 2e-5 (as tests/test_torch_flash_backward.py);
- dataset samples bit for bit: the same numpy draws;
- one make_train_step step: metrics 1e-5 relative; parameters within 1e-5
  except where a near-zero gradient flips the sign of Adam's first
  normalized update, which moves an element by up to 2 lr (at most 1e-4 of
  a leaf's elements, and one element of the smallest leaves).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data import masked_dataset as jmd
from megatron_tpu.data.indexed_dataset import IndexedDatasetBuilder
from megatron_tpu.data.indexed_dataset import MMapIndexedDataset as JIndexed
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import t5 as jt5
from megatron_tpu.ops.flash_attention_pallas import pallas_flash_attention
from megatron_tpu.training import optimizer as jopt
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (params_from_numpy,
                                                 train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.data import masked_dataset as tmd
from megatron_tpu_torch.data.indexed_dataset import \
    MMapIndexedDataset as TIndexed
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import t5 as tt5
from megatron_tpu_torch.models.attention import attention_apply
from megatron_tpu_torch.ops import flash_attention as fa
from megatron_tpu_torch.ops import flash_attention_cuda

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=300, seq_length=64, compute_dtype="float32")
S, S_DEC, B = 64, 32, 2
# the second row's real tokens; the rest are pads
REAL = 40


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


def _bert(impl):
    kw = dict(TINY, attention_impl=impl)
    jcfg, tcfg = jbert.bert_config(**kw), tbert.bert_config(**kw)
    params = jbert.bert_init(jax.random.PRNGKey(0), jcfg)
    model = tbert.BertModel.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu",
                                model_cls=tbert.BertModel), trainable=True)
    return jcfg, tcfg, params, model


def _t5(impl):
    kw = dict(TINY, attention_impl=impl)
    jcfg, tcfg = jt5.t5_config(**kw), tt5.t5_config(**kw)
    params = jt5.t5_init(jax.random.PRNGKey(1), jcfg)
    model = tt5.T5Model.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu",
                                model_cls=tt5.T5Model), trainable=True)
    return jcfg, tcfg, params, model


def _pad_mask(s):
    mask = np.ones((B, s), np.int64)
    mask[1, REAL:] = 0
    return mask


def _bert_batch(padding, seed=0):
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, 300, (B, S)),
             "tokentype_ids": (np.arange(S)[None] >= S // 2).repeat(
                 B, 0).astype(np.int64),
             "labels": rs.randint(0, 300, (B, S)),
             "loss_mask": (rs.rand(B, S) < 0.15).astype(np.float32),
             "is_random": rs.randint(0, 2, (B,))}
    if padding:
        batch["padding_mask"] = _pad_mask(S)
    return batch


def _t5_batch(padding, seed=0):
    rs = np.random.RandomState(seed)
    batch = {"text_enc": rs.randint(0, 300, (B, S)),
             "text_dec": rs.randint(0, 300, (B, S_DEC)),
             "labels": rs.randint(0, 300, (B, S_DEC)),
             "loss_mask": (rs.rand(B, S_DEC) < 0.8).astype(np.float32)}
    if padding:
        batch["enc_mask"] = _pad_mask(S)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


IMPL_PAD = [("dot", False), ("dot", True), ("flash", False),
            ("flash", True)]


@pytest.mark.parametrize("impl,padding", IMPL_PAD)
def test_bert_forward_matches_jax(impl, padding):
    jcfg, tcfg, params, model = _bert(impl)
    batch = _bert_batch(padding)
    jb, tb = _j(batch), _t(batch)
    want_lm, want_nsp = jbert.bert_forward(
        params, jb["tokens"], jcfg, tokentype_ids=jb["tokentype_ids"],
        padding_mask=jb.get("padding_mask"))
    with torch.no_grad():
        got_lm, got_nsp = tbert.bert_forward(
            model, tb["tokens"], tcfg, tokentype_ids=tb["tokentype_ids"],
            padding_mask=tb.get("padding_mask"))
    assert got_lm.dtype == got_nsp.dtype == torch.float32
    assert _rel_err(got_lm.numpy(), want_lm) < 1e-5
    assert _rel_err(got_nsp.numpy(), want_nsp) < 1e-5


@pytest.mark.parametrize("impl,padding", IMPL_PAD)
def test_t5_forward_matches_jax(impl, padding):
    jcfg, tcfg, params, model = _t5(impl)
    batch = _t5_batch(padding)
    jb, tb = _j(batch), _t(batch)
    want = jt5.t5_forward(params, jb["text_enc"], jb["text_dec"], jcfg,
                          enc_padding_mask=jb.get("enc_mask"))
    with torch.no_grad():
        got = tt5.t5_forward(model, tb["text_enc"], tb["text_dec"], tcfg,
                             enc_padding_mask=tb.get("enc_mask"))
    assert got.shape == (B, S_DEC, tcfg.padded_vocab_size)
    assert _rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("family,impl", [("bert", "dot"), ("bert", "flash"),
                                         ("t5", "dot"), ("t5", "flash")])
def test_loss_grads_match_jax(family, impl):
    """bert_loss (MLM + NSP, padded) and t5_loss (padded encoder): the loss
    and every gradient leaf."""
    if family == "bert":
        jcfg, tcfg, params, model = _bert(impl)
        batch, jloss, tloss = _bert_batch(True, 3), jbert.bert_loss, \
            tbert.bert_loss
    else:
        jcfg, tcfg, params, model = _t5(impl)
        batch, jloss, tloss = _t5_batch(True, 3), jt5.t5_loss, tt5.t5_loss
    want, want_g = jax.value_and_grad(jloss)(params, _j(batch), jcfg)
    got = tloss(model, _t(batch), tcfg)
    got.backward()
    assert _rel_err(got.item(), want) < 1e-5
    grads = _flatten(want_g)
    assert len(grads) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), grads[name.replace(".", "/")]) \
            < 1e-4, name


def test_pad_segments_and_trees_match_jax():
    """bert_pad_segments, the parameter trees' names and shapes, and the
    weight-decay masks (stacked leaves by the models' prefixes against
    JAX's logical axes)."""
    mask = _pad_mask(S)
    np.testing.assert_array_equal(
        tbert.bert_pad_segments(torch.from_numpy(mask)).numpy(),
        np.asarray(jbert.bert_pad_segments(jnp.asarray(mask))))
    for family, axes in (("bert", jbert.bert_axes), ("t5", jt5.t5_axes)):
        jcfg, _, params, model = (_bert if family == "bert" else _t5)("dot")
        flat = _flatten(params)
        state = model.state_dict()
        assert sorted(state) == sorted(k.replace("/", ".") for k in flat)
        for key, arr in flat.items():
            assert tuple(state[key.replace("/", ".")].shape) == arr.shape
        want = _flatten(jopt.weight_decay_mask(params, axes(jcfg)))
        got = tts.weight_decay_mask(model)
        assert got == {k.replace("/", "."): bool(v) for k, v in want.items()}


def test_attention_keeps_the_references_refusals():
    """No adapters or cache on cross-attention, no window off the causal
    self-attention path."""
    _, tcfg, _, model = _t5("dot")
    p = {k: v[0] for k, v in model["decoder"]["inter_attention"].items()}
    x, enc = torch.zeros(1, 4, 64), torch.zeros(1, 8, 64)
    out, _ = attention_apply(p, x, tcfg, causal=False, kv_input=enc)
    assert out.shape == x.shape
    with pytest.raises(ValueError, match="adapter"):
        attention_apply(p, x, tcfg, kv_input=enc, adapters=(None, None))
    with pytest.raises(ValueError, match="uncached"):
        attention_apply(p, x, tcfg, kv_input=enc, kv_cache=object())
    windowed = tc.ModelConfig(**{**tcfg.__dict__, "sliding_window": 4})
    with pytest.raises(ValueError, match="sliding_window"):
        attention_apply(p, x, windowed, causal=False)


# --- the plain flash versions on the slice's new paths ------------------------

D = 64


def _qkvdo(sq, sk, nq, nkv, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal(shape).astype(np.float32) for shape in (
        (B, sq, nq, D), (B, sk, nkv, D), (B, sk, nkv, D), (B, sq, nq, D)))


@pytest.mark.parametrize("case", ["bidirectional_pad", "cross"])
def test_plain_flash_matches_pallas_interpret(case):
    """BERT's and T5's encoder attention (non-causal, pad segments) and
    T5's cross-attention (non-causal, sq 32 / sk 64, no segment ids):
    forward and dq/dk/dv of the port's Function on CPU tensors against
    jax.vjp of the Pallas kernel."""
    if case == "cross":
        sq, sk, seg = 32, 64, None
    else:
        sq = sk = 64
        seg = np.array(jbert.bert_pad_segments(jnp.asarray(_pad_mask(64))))
    q, k, v, do = _qkvdo(sq, sk, 4, 4, seed=sq + sk)
    jseg = None if seg is None else jnp.asarray(seg, jnp.float32)
    want, vjp = jax.vjp(lambda q_, k_, v_: pallas_flash_attention(
        q_, k_, v_, False, None, 32, 32, True, jseg, jseg),
        *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    counts = flash_attention_cuda.launch_counts()
    out = fa.flash_attention(
        tq, tk, tv, causal=False, scale=D ** -0.5,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    out.backward(torch.from_numpy(do))
    assert flash_attention_cuda.launch_counts() == counts
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for t, w in zip((tq, tk, tv), wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


# --- datasets -----------------------------------------------------------------

@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("masked") / "docs")
    rng = np.random.default_rng(0)
    b = IndexedDatasetBuilder(prefix)
    for n in (96, 40, 7, 130, 1, 64, 300, 17):
        b.add_item(rng.integers(5, 300, size=n).tolist())
        b.end_document()
    b.finalize()
    return prefix


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def test_masked_lm_predictions_bit_equal():
    tokens = np.random.RandomState(5).randint(0, 300, 77)
    for seed in range(5):
        want = jmd.create_masked_lm_predictions(
            tokens, 300, 4, np.random.RandomState(seed), 0.2,
            special_ids=(2, 3))
        got = tmd.create_masked_lm_predictions(
            tokens, 300, 4, np.random.RandomState(seed), 0.2,
            special_ids=(2, 3))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_bert_and_t5_samples_bit_equal(docs):
    kw = dict(num_samples=40, max_seq_length=64, vocab_size=300, seed=7)
    jb = jmd.BertDataset(JIndexed(docs), cls_id=2, sep_id=3, mask_id=4,
                         pad_id=0, **kw)
    tb = tmd.BertDataset(TIndexed(docs), cls_id=2, sep_id=3, mask_id=4,
                         pad_id=0, **kw)
    kw5 = dict(num_samples=40, max_seq_length=64, max_seq_length_dec=32,
               vocab_size=300, sentinel_ids=range(290, 300), bos_id=2,
               eos_id=3, pad_id=0, seed=7)
    j5 = jmd.T5Dataset(JIndexed(docs), **kw5)
    t5 = tmd.T5Dataset(TIndexed(docs), **kw5)
    for i in range(40):
        _same(tb[i], jb[i])
        _same(t5[i], j5[i])


# --- one training step with a custom loss --------------------------------------

# the first-step gradient below which Adam's step lr g / (|g| + 1e-8) may
# turn with the rounding of g: ten times Adam's eps
G_EXEMPT = 1e-7


def _configs(model):
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, clip_grad=1.0,
               weight_decay=0.1)
    tr = dict(micro_batch_size=2, global_batch_size=4, train_iters=10)
    return (jc.MegatronConfig(model=model[0], optimizer=jc.OptimizerConfig(
                **opt), training=jc.TrainingConfig(**tr)),
            tc.MegatronConfig(model=model[1], optimizer=tc.OptimizerConfig(
                **opt), training=tc.TrainingConfig(**tr)))


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_custom_loss_train_step_matches_jax(family):
    """make_train_step(loss_fn=...) over 2 microbatches against the JAX
    step from the same state: metrics, and every parameter, mu and nu."""
    mod = dict(bert=(jbert, tbert), t5=(jt5, tt5))[family]
    kw = dict(TINY, attention_impl="flash")
    models = (getattr(mod[0], f"{family}_config")(**kw),
              getattr(mod[1], f"{family}_config")(**kw))
    jcfg, tcfg = _configs(models)
    init = getattr(mod[0], f"{family}_init")
    jloss = getattr(mod[0], f"{family}_loss")
    tloss = getattr(mod[1], f"{family}_loss")
    params = init(jax.random.PRNGKey(2), jcfg.model)
    jstate = jts.state_from_params(params, jcfg)
    model_cls = tbert.BertModel if family == "bert" else tt5.T5Model
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu",
                                    model_cls=model_cls)
    jstep = jts.make_train_step(
        jcfg, mesh=None, donate=False,
        loss_fn=lambda p, mb, r: jloss(p, mb, jcfg.model),
        init_params_fn=lambda: params,
        axes_fn=getattr(mod[0], f"{family}_axes"))
    tstep = tts.make_train_step(
        tcfg, loss_fn=lambda m, mb, g: tloss(m, mb, tcfg.model),
        device="cpu")
    make = _bert_batch if family == "bert" else _t5_batch
    micro = [make(True, seed) for seed in (11, 12)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    jstate, jm = jstep(jstate, _j(batch), None)
    tstate, tm = tstep(tstate, _t(batch))
    for key in ("lm_loss", "grad_norm", "lr", "wd"):
        assert _rel_err(float(tm[key]), float(jm[key])) < 1e-5, key
    got, opt_state, iteration = train_state_to_numpy(tstate)
    assert iteration == 1 and opt_state["step"] == 1
    jmu, jnu = _flatten(jstate.opt_state.mu), _flatten(jstate.opt_state.nu)
    for name, want in _flatten(jstate.params).items():
        # Adam's first step moves an element by lr g / (|g| + eps), nearly
        # lr sign(g): where JAX's (clipped) gradient is below G_EXEMPT, the
        # rounding of g may turn the step, so only those elements are
        # exempt; every other one is held to 1e-5
        g = np.asarray(jmu[name]) / (1 - tcfg.optimizer.adam_beta1)
        held = np.abs(g) >= G_EXEMPT
        diff = np.abs(got[name] - np.asarray(want))
        assert diff[held].max(initial=0.0) <= 1e-5, name
        assert _rel_err(opt_state["mu"][name], jmu[name]) < 1e-4, name
        assert _rel_err(opt_state["nu"][name], jnu[name]) < 2e-4, name
