"""The port's training slice on the CPU against the JAX package, on the same
numpy inputs and the same initial weights (moved across by the bridge), in
fp32 compute.

Tolerances and why:
- schedules 1e-6 relative: the reference computes in fp32, the port in
  Python floats;
- cross-entropy, loss_fn and its grads 1e-5 relative to the largest value:
  the same fp32 formulas summed in another order (measured ~1e-6);
- one optimizer step from identical grads 1e-6: the same elementwise fp32
  arithmetic;
- three make_train_step steps: loss, grad_norm and lr 1e-5 relative; mu and
  nu 1e-3 of each leaf's largest magnitude. Parameters hold 1e-5 except
  where a gradient is so close to zero that the ~1e-6 relative difference
  of the two frameworks' grads flips Adam's normalized update m / sqrt(v):
  each step then moves that element by up to 2 lr, so over three steps it
  may differ by up to 6 lr (6e-3 here). Such elements are rare (10 of
  786k in w1 in the runs that set this bound), so at most 1e-4 of a
  leaf's elements may use that bound.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.models import language_model as jlm
from megatron_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from megatron_tpu.training import microbatches as jmb
from megatron_tpu.training import optimizer as jopt
from megatron_tpu.training import scheduler as jsched
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (params_from_numpy,
                                                 train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.models import transformer as ttfm
from megatron_tpu_torch.ops import flash_attention_cuda
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss as t_ce
from megatron_tpu_torch.training import microbatches as tmb
from megatron_tpu_torch.training import optimizer as topt
from megatron_tpu_torch.training import scheduler as tsched

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=300, seq_length=32)


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


# --- schedules and microbatches ---------------------------------------------

@pytest.mark.parametrize("style", ["constant", "linear", "cosine",
                                   "inverse-square-root"])
@pytest.mark.parametrize("warmup", [dict(lr_warmup_iters=0),
                                    dict(lr_warmup_iters=4),
                                    dict(lr_warmup_fraction=0.25)])
def test_learning_rate_matches_jax(style, warmup):
    kw = dict(lr=3e-4, min_lr=3e-5, lr_decay_style=style, lr_decay_iters=16,
              **warmup)
    jo, to = jc.OptimizerConfig(**kw), tc.OptimizerConfig(**kw)
    jt, tt = jc.TrainingConfig(train_iters=20), tc.TrainingConfig(
        train_iters=20)
    for it in range(24):
        np.testing.assert_allclose(tsched.learning_rate(it, to, tt),
                                   float(jsched.learning_rate(it, jo, jt)),
                                   rtol=1e-6)


@pytest.mark.parametrize("style", ["constant", "linear", "cosine"])
def test_weight_decay_matches_jax(style):
    kw = dict(weight_decay_incr_style=style, start_weight_decay=0.01,
              end_weight_decay=0.1, lr_decay_iters=10)
    jo, to = jc.OptimizerConfig(**kw), tc.OptimizerConfig(**kw)
    for it in range(14):
        np.testing.assert_allclose(
            tsched.weight_decay(it, to, tc.TrainingConfig()),
            float(jsched.weight_decay(it, jo, jc.TrainingConfig())),
            rtol=1e-6)


@pytest.mark.parametrize("rampup", [None, (8, 8, 96), (4, 12, 50)])
def test_microbatch_calculator_matches_jax(rampup):
    want = jmb.MicrobatchCalculator(40, 2, 2, rampup)
    got = tmb.MicrobatchCalculator(40, 2, 2, rampup)
    for consumed in range(0, 200, 7):
        want.update(consumed)
        got.update(consumed)
        assert (got.global_batch_size, got.num_microbatches) == (
            want.global_batch_size, want.num_microbatches)


# --- cross-entropy, weight-decay mask, optimizer ------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    """Padded vocab (300 of 384 ids real) with and without label
    smoothing: per-token loss and the gradient of its sum."""
    rs = np.random.RandomState(0)
    logits = (rs.standard_normal((3, 7, 384)) * 4).astype(np.float32)
    labels = rs.randint(0, 300, (3, 7))
    want, want_g = jax.value_and_grad(
        lambda x: j_ce(x, jnp.asarray(labels), 300, smoothing).sum())(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = t_ce(x, torch.from_numpy(labels), 300, smoothing).sum()
    got.backward()
    assert _rel_err(got.item(), want) < 1e-5
    assert _rel_err(x.grad.numpy(), want_g) < 1e-5
    per_token = t_ce(x.detach(), torch.from_numpy(labels), 300, smoothing)
    assert _rel_err(per_token.numpy(), j_ce(jnp.asarray(logits),
                                           jnp.asarray(labels), 300,
                                           smoothing)) < 1e-5


@pytest.mark.parametrize("name", ["llama2_config", "falcon_config",
                                  "gpt_config"])
def test_weight_decay_mask_matches_jax(name):
    """Stacked norm scales [L, h] and biases stay exempt; the stacked dim
    does not count toward rank."""
    args = () if name == "gpt_config" else ("tiny",)
    jcfg = getattr(jc, name)(*args, **SMALL)
    tcfg = getattr(tc, name)(*args, **SMALL)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    want = _flatten(jopt.weight_decay_mask(params, jlm.model_axes(jcfg)))
    meta = tlm.LanguageModel(tcfg, device="meta").state_dict()
    got = topt.weight_decay_mask(meta)
    assert got == {k.replace("/", "."): bool(v) for k, v in want.items()}
    assert not got["transformer.input_norm.scale"]
    assert got["transformer.attention.wq"]


def _small_tree(seed=0):
    jcfg = jc.gpt_config(**SMALL)
    params = jlm.model_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tc.gpt_config(**SMALL), params


def _jax_opt_state_tree(opt_state):
    return (_flatten(opt_state.mu),
            None if opt_state.nu is None else _flatten(opt_state.nu))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_apply_optimizer_matches_jax(optimizer, clip):
    """Two optimizer steps from the same params and grads (clipping active
    at 0.05, off at 0), with decay on the >= 2-D leaves."""
    jcfg, tcfg, params = _small_tree()
    kw = dict(optimizer=optimizer, clip_grad=clip, weight_decay=0.1)
    jo, to = jc.OptimizerConfig(**kw), tc.OptimizerConfig(**kw)
    jmask = jopt.weight_decay_mask(params, jlm.model_axes(jcfg))
    jstate = jopt.init_optimizer(params, jo)
    tparams = params_from_numpy(params, tcfg, device="cpu")
    tstate = topt.init_optimizer(tparams, to)
    tmask = topt.weight_decay_mask(tparams)
    rs = np.random.RandomState(1)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rs.standard_normal(p.shape).astype(np.float32) * 0.01), params)
        tgrads = {k.replace("/", "."): torch.tensor(np.asarray(v))
                  for k, v in _flatten(grads).items()}
        params, jstate, jm = jopt.apply_optimizer(params, grads, jstate, jo,
                                                  1e-3, 0.1, jmask)
        tstate, tm = topt.apply_optimizer(tparams, tgrads, tstate, to, 1e-3,
                                          0.1, tmask)
        for key in ("grad_norm", "found_inf", "loss_scale"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    jmu, jnu = _jax_opt_state_tree(jstate)
    for k, v in _flatten(params).items():
        name = k.replace("/", ".")
        np.testing.assert_allclose(tparams[name].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tstate.mu[name].numpy(),
                                   np.asarray(jmu[k]), rtol=1e-6, atol=1e-8)
        if jnu is not None:
            np.testing.assert_allclose(tstate.nu[name].numpy(),
                                       np.asarray(jnu[k]), rtol=1e-6,
                                       atol=1e-12)
    assert int(tstate.step) == int(jstate.step) == 2


def test_found_inf_skip_and_fp16_scaler_automaton_match_jax():
    """Dynamic loss scaling as fp16 compute seeds it, over a run of finite
    and overflowing steps: an overflow skips the whole update (params and
    moments unchanged, Adam's step not advanced), spends hysteresis, then
    halves the scale; a window of good steps doubles it."""
    jcfg, tcfg, params = _small_tree(seed=2)
    kw = dict(initial_loss_scale=2.0 ** 10, loss_scale_window=2,
              hysteresis=2, min_loss_scale=16.0)
    jo, to = jc.OptimizerConfig(**kw), tc.OptimizerConfig(**kw)
    jstate = jopt.init_optimizer(params, jo, compute_dtype=jnp.float16)
    tparams = params_from_numpy(params, tcfg, device="cpu")
    tstate = topt.init_optimizer(tparams, to, compute_dtype=torch.float16)
    assert float(tstate.scaler.scale) == float(jstate.scaler.scale) == 1024
    rs = np.random.RandomState(3)
    for overflow in (False, True, True, True, False, False, False, True):
        scale = float(jstate.scaler.scale)
        flat = {k: rs.standard_normal(v.shape).astype(np.float32) * scale
                for k, v in _flatten(params).items()}
        if overflow:
            flat["lm_head" if "lm_head" in flat else
                 "embedding/word_embeddings"][0, 0] = np.inf
        grads = jax.tree.map(jnp.asarray, _unflatten_like(params, flat))
        before = {k: v.clone() for k, v in tparams.items()}
        params, jstate, jm = jopt.apply_optimizer(params, grads, jstate, jo,
                                                  1e-3, 0.0)
        tstate, tm = topt.apply_optimizer(
            tparams, {k.replace("/", "."): torch.from_numpy(v.copy())
                      for k, v in flat.items()}, tstate, to, 1e-3, 0.0)
        assert int(tm["found_inf"]) == int(jm["found_inf"]) == int(overflow)
        for a, b in ((tstate.scaler.scale, jstate.scaler.scale),
                     (tstate.scaler.growth_tracker,
                      jstate.scaler.growth_tracker),
                     (tstate.scaler.hysteresis, jstate.scaler.hysteresis),
                     (tstate.step, jstate.step)):
            assert float(a) == float(b)
        if overflow:
            assert all(torch.equal(before[k], v) for k, v in tparams.items())
    for k, v in _flatten(params).items():
        np.testing.assert_allclose(tparams[k.replace("/", ".")].numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-6)


def _unflatten_like(tree, flat, prefix=""):
    return {k: (_unflatten_like(v, flat, f"{prefix}{k}/")
                if isinstance(v, dict) else flat[f"{prefix}{k}"])
            for k, v in tree.items()}


# --- loss_fn and the training step --------------------------------------------

def _tiny(impl="flash", **kw):
    kw = dict(attention_impl=impl, compute_dtype="float32", seq_length=64,
              **kw)
    return jc.llama2_config("tiny", **kw), tc.llama2_config("tiny", **kw)


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[:, s * 5 // 8:] = 1
    return seg


@pytest.mark.parametrize("impl,extra", [("flash", "none"),
                                        ("flash", "segments"),
                                        ("flash", "loss_mask"),
                                        ("dot", "segments")])
def test_loss_fn_and_grads_match_jax(impl, extra):
    jcfg, tcfg = _tiny(impl)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = tlm.LanguageModel.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu"), trainable=True)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, tcfg.vocab_size, (2, 65))
    seg = _segments(2, 64) if extra == "segments" else None
    mask = ((rs.rand(2, 65) > 0.3).astype(np.float32)
            if extra == "loss_mask" else None)
    want, want_g = jax.value_and_grad(jlm.loss_fn)(
        params, jnp.asarray(toks), jcfg,
        loss_mask=None if mask is None else jnp.asarray(mask),
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = tlm.loss_fn(
        model, torch.from_numpy(toks), tcfg,
        loss_mask=None if mask is None else torch.from_numpy(mask),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    got.backward()
    assert _rel_err(got.item(), want) < 1e-5
    grads = _flatten(want_g)
    for name, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), grads[name.replace(".", "/")]) < 1e-5


def _train_configs(family="llama"):
    kw = dict(attention_impl="flash", compute_dtype="float32", seq_length=64)
    if family == "mixtral":
        # capacity 1.25: tokens drop, and the router loss is in the loss
        kw.update(vocab_size=32000, moe_capacity_factor=1.25)
    preset = {"llama": "llama2_config", "mixtral": "mixtral_config"}[family]
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, clip_grad=1.0,
               weight_decay=0.1)
    tr = dict(micro_batch_size=2, global_batch_size=4, train_iters=10)
    return (jc.MegatronConfig(model=getattr(jc, preset)("tiny", **kw),
                              optimizer=jc.OptimizerConfig(**opt),
                              training=jc.TrainingConfig(**tr)),
            tc.MegatronConfig(model=getattr(tc, preset)("tiny", **kw),
                              optimizer=tc.OptimizerConfig(**opt),
                              training=tc.TrainingConfig(**tr)))


def test_three_train_steps_match_jax():
    """Three make_train_step steps, 2 microbatches with segment ids and a
    loss mask, from the same initial tree: metrics and every param, mu and
    nu leaf. CPU tensors never reach a kernel."""
    _three_train_steps("llama")


def test_three_mixtral_train_steps_match_jax():
    """As above on a tiny Mixtral at capacity 1.25: its router and expert
    banks are leaves like any other, and its loss holds the router's."""
    _three_train_steps("mixtral")


def _three_train_steps(family):
    jcfg, tcfg = _train_configs(family)
    assert tcfg.num_microbatches == 2
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    jstep = jts.make_train_step(jcfg, mesh=None, donate=False)
    tstep = tts.make_train_step(tcfg, device="cpu")
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 32000, (2, 2, 65))
    seg = np.broadcast_to(_segments(2, 64), (2, 2, 64)).copy()
    mask = (rs.rand(2, 2, 64) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "segment_ids": jnp.asarray(seg),
              "loss_mask": jnp.asarray(mask)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "segment_ids": torch.from_numpy(seg),
              "loss_mask": torch.from_numpy(mask)}
    counts = flash_attention_cuda.launch_counts()
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch, None)
        tstate, tm = tstep(tstate, tbatch)
        for key in ("lm_loss", "grad_norm", "lr", "wd"):
            assert _rel_err(float(tm[key]), float(jm[key])) < 1e-5, key
        assert int(tm["found_inf"]) == int(jm["found_inf"]) == 0
        losses.append(float(tm["lm_loss"]))
    assert losses[0] > losses[1] > losses[2]
    assert flash_attention_cuda.launch_counts() == counts

    params, opt_state, iteration = train_state_to_numpy(tstate)
    assert iteration == 3 and opt_state["step"] == int(jstate.opt_state.step)
    lr = tcfg.optimizer.lr
    jmu, jnu = _jax_opt_state_tree(jstate.opt_state)
    for name, want in _flatten(jstate.params).items():
        diff = np.abs(params[name] - np.asarray(want))
        assert diff.max() <= 6 * lr, name
        assert (diff > 1e-5).sum() <= 1e-4 * diff.size, name
        for got_m, want_m in ((opt_state["mu"][name], jmu[name]),
                              (opt_state["nu"][name], jnu[name])):
            assert _rel_err(got_m, want_m) < 1e-3, name


def test_train_state_round_trip():
    jcfg, tcfg = _train_configs()
    jstate = jts.init_train_state(jax.random.PRNGKey(1), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state, 7, tcfg,
                                    device="cpu")
    params, opt_state, iteration = train_state_to_numpy(tstate)
    assert iteration == 7
    for name, want in _flatten(jstate.params).items():
        np.testing.assert_array_equal(params[name], np.asarray(want))
        np.testing.assert_array_equal(opt_state["mu"][name], 0.0)
    assert opt_state["scaler"] == {"scale": 1.0, "growth_tracker": 0,
                                   "hysteresis": 2}
    assert all(p.requires_grad for p in tstate.params.parameters())


# --- the repairs and the refusals ----------------------------------------------

def test_unstacked_layers_give_the_stacked_leaf_its_per_layer_grads():
    """stack_apply takes each stacked leaf apart with one unbind: the
    stacked leaf's grad equals the per-layer grads, stacked."""
    rs = np.random.RandomState(0)
    w = rs.standard_normal((3, 4, 4)).astype(np.float32)
    b = rs.standard_normal((3, 4)).astype(np.float32)
    x = torch.from_numpy(rs.standard_normal((2, 4)).astype(np.float32))
    stacked = {"w": torch.tensor(w, requires_grad=True),
               "n": {"b": torch.tensor(b, requires_grad=True)}}
    per_layer = [{"w": torch.tensor(w[i], requires_grad=True),
                  "n": {"b": torch.tensor(b[i], requires_grad=True)}}
                 for i in range(3)]

    def run(layers):
        h = x
        for p in layers:
            h = torch.tanh(h @ p["w"] + p["n"]["b"])
        return h.square().sum()

    layers = ttfm.unstack_layers(stacked)
    assert len(layers) == 3 and layers[1]["n"]["b"].shape == (4,)
    run(layers).backward()
    run(per_layer).backward()
    np.testing.assert_allclose(
        stacked["w"].grad.numpy(),
        torch.stack([p["w"].grad for p in per_layer]).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        stacked["n"]["b"].grad.numpy(),
        torch.stack([p["n"]["b"].grad for p in per_layer]).numpy(),
        rtol=1e-6)


def test_training_entry_points_raise_without_gpu_and_device(monkeypatch):
    _, tcfg = _train_configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_train_state(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.make_train_step(tcfg)
    state = tts.init_train_state(tcfg, device="cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    tts.make_train_step(tcfg, device="cpu")


def test_what_the_slice_leaves_out_raises():
    """A custom loss (BERT, T5, ICT) under context parallelism still
    raises (ROADMAP item 7 (g)), with or without a pipelined spec; the
    pipelined keywords dispatch as the reference's do: ignored without a
    pipeline mesh, and on one a pipelined_spec under gpipe and a custom
    loss_fn with neither keyword are refused; a custom loss and experts
    under a mesh, bf16 and fp16 master weights, activation recompute,
    hidden dropout, drop-path and the dot path's attention dropout run."""
    import dataclasses
    from megatron_tpu_torch.parallel.mesh import single_device_mesh
    _, tcfg = _train_configs()
    moe = tc.MegatronConfig(model=tc.mixtral_config("tiny", **SMALL))
    cp_mesh = dataclasses.replace(single_device_mesh(),
                                  shape=dict(dp=1, pp=1, cp=2, tp=1))
    for kw in (dict(loss_fn=lambda *a: 0.0), dict(pipelined_spec=object()),
               dict(pipelined_loss_fn=object())):
        with pytest.raises(NotImplementedError, match="item 7 \\(g\\)"):
            tts.make_train_step(tcfg, device="cpu", mesh=cp_mesh, **kw)
        tts.make_train_step(tcfg, device="cpu", **kw)
    for schedule, kw, ok in (("1f1b", dict(pipelined_spec=object()), True),
                             ("gpipe", dict(pipelined_spec=object()), False),
                             ("gpipe", dict(pipelined_loss_fn=object()),
                              True),
                             ("1f1b", dict(loss_fn=lambda *a: 0.0), False)):
        par = tc.ParallelConfig(pipeline_parallel=2,
                                pipeline_schedule=schedule)
        cfg = dataclasses.replace(tcfg, parallel=par)
        pp_mesh = dataclasses.replace(single_device_mesh(), parallel=par,
                                      shape=dict(dp=1, pp=2, cp=1, tp=1))
        if ok:
            tts.make_train_step(cfg, device="cpu", mesh=pp_mesh, **kw)
        else:
            with pytest.raises(ValueError, match="pipelined_spec"):
                tts.make_train_step(cfg, device="cpu", mesh=pp_mesh, **kw)
    tts.make_train_step(tcfg, device="cpu", loss_fn=lambda *a: 0.0)
    tts.make_train_step(tcfg, device="cpu", mesh=single_device_mesh(),
                        loss_fn=lambda *a: 0.0)
    tts.make_train_step(moe, device="cpu", mesh=single_device_mesh())
    toks = torch.zeros(2, 1, 9, dtype=torch.long)
    for dtype in ("bfloat16", "float16"):
        cfg = tc.MegatronConfig(model=tc.llama2_config(
            "tiny", **SMALL, params_dtype=dtype, compute_dtype=dtype))
        state = tts.init_train_state(cfg, device="cpu")
        state, m = tts.make_train_step(cfg, device="cpu")(
            state, {"tokens": toks})
        assert next(state.params.parameters()).dtype == getattr(torch, dtype)
        assert torch.isfinite(m["lm_loss"]) and state.iteration == 1
    model = tlm.LanguageModel(tc.llama2_config("tiny", **SMALL),
                              device="cpu")
    for granularity in ("selective", "full"):
        loss = tlm.loss_fn(model, toks[0], tc.llama2_config(
            "tiny", **SMALL, recompute_granularity=granularity))
        assert torch.equal(loss, tlm.loss_fn(
            model, toks[0], tc.llama2_config("tiny", **SMALL)))
    toks = toks[0]
    for cfg_kw in (dict(hidden_dropout=0.1), dict(drop_path_rate=0.1),
                   dict(attention_dropout=0.1)):
        cfg = tc.llama2_config("tiny", **SMALL, **cfg_kw)
        loss = tlm.loss_fn(model, toks, cfg, deterministic=False,
                           generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(loss)


def test_flash_dropout_in_the_model_is_seeded_by_the_generator():
    """Attention dropout on the flash path: the same generator seed gives
    the same loss, another seed another one."""
    cfg = tc.llama2_config("tiny", **SMALL, attention_impl="flash",
                           attention_dropout=0.2, compute_dtype="float32")
    model = tlm.LanguageModel(cfg, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 300, (2, 17)))

    def loss(seed):
        return tlm.loss_fn(model, toks, cfg, deterministic=False,
                           generator=torch.Generator().manual_seed(seed))

    assert loss(1).item() == loss(1).item() != loss(2).item()
    assert loss(1).item() != tlm.loss_fn(model, toks, cfg).item()
