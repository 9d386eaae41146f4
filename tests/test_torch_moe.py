"""The port's Mixture-of-Experts layer (models/moe.py,
ops/quantized.int8_expert_matmul) against the JAX package's, on the same
numpy inputs and weights (moved across by `params_from_numpy` for the
models), on the CPU.

Tolerances and why:
- `moe_apply` outputs and aux in fp32 1e-5 (absolute, on outputs of order
  0.1-1): the same fp32 formulas summed in another order; the routing
  (`_sort_route`'s expert, token, slot and keep, `moe_dispatch`'s one-hot
  tensors and the top-k indices) exactly;
- grads 1e-5 relative to each leaf's largest magnitude;
- `int8_expert_matmul`: int8 values and scales bit-exact, outputs 1e-6
  relative (the same int32 products, dequantized by the same fp32
  multiplies), the straight-through backward 1e-6 relative (fp32 products
  in another order);
- a tiny Mixtral: logits 1e-4 (as tests/test_torch_model.py), loss and
  grads 1e-5 relative (as tests/test_torch_training.py); greedy tokens
  exact and logprobs within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import arguments as jargs
from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.inference.generation import SamplingParams as JSampling
from megatron_tpu.models import language_model as jlm
from megatron_tpu.models import moe as jmoe
from megatron_tpu.ops import quantized as jq
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import arguments as targs
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.models import moe as tmoe
from megatron_tpu_torch.ops import quantized as tq

torch.set_num_threads(2)
TOL = 1e-5
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             ffn_hidden_size=96, vocab_size=128, seq_length=32,
             compute_dtype="float32", num_experts=4, moe_top_k=2)
DROPLESS = 2.0  # E / K: C = s, nothing drops


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return (jconfig.ModelConfig(**kw).derived(),
            tconfig.ModelConfig(**kw).derived())


def _bank(jcfg, seed=0, bias_scale=0.1):
    """A JAX expert bank from `moe_init`, with random biases (zeros would
    hide a misplaced bias) when the config has them."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    rs = np.random.RandomState(seed + 1)
    return {k: (jnp.asarray(rs.standard_normal(v.shape).astype(np.float32)
                            * bias_scale) if k.startswith("b") else v)
            for k, v in p.items()}


def _torch(tree, requires_grad=False):
    return {k: torch.tensor(np.asarray(v), requires_grad=requires_grad)
            for k, v in tree.items()}


def _x(b=2, s=32, h=64, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (b, s, h)).astype(np.float32)


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


def _routing(cfg, p, x):
    logits = jnp.asarray(x) @ p["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, cfg.moe_top_k)
    return gates / jnp.sum(gates, -1, keepdims=True), idx


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
@pytest.mark.parametrize("cap", [1.25, DROPLESS])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_apply_matches_jax(dispatch, cap, bias, activation):
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, moe_capacity_factor=cap,
                       use_bias=bias, activation=activation)
    p = _bank(jcfg)
    x = _x()
    want, want_aux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    got, got_aux = tmoe.moe_apply(_torch(p), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=TOL)
    # the capacity-1.25 cases really drop tokens
    gates, idx = _routing(jcfg, p, x)
    _, _, _, _, keep = tmoe._sort_route(
        torch.tensor(np.asarray(idx)).long(),
        torch.tensor(np.asarray(gates)), 4, tmoe.moe_capacity(tcfg, 32))
    assert bool(keep.all()) == (cap == DROPLESS)


@pytest.mark.parametrize("cap", [1.25, DROPLESS])
def test_sort_route_and_dense_dispatch_match_jax(cap):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cap)
    p = _bank(jcfg)
    x = _x()
    gates, idx = _routing(jcfg, p, x)
    C = jmoe.moe_capacity(jcfg, 32)
    assert tmoe.moe_capacity(tcfg, 32) == C
    want = jax.vmap(lambda i, g: jmoe._sort_route(i, g, 4, C))(idx, gates)
    tidx = torch.tensor(np.asarray(idx)).long()
    tgates = torch.tensor(np.asarray(gates))
    got = tmoe._sort_route(tidx, tgates, 4, C)
    for name, g, w in zip(("expert", "token", "gate", "slot", "keep"),
                          got, want):
        w = np.asarray(w)
        g = np.broadcast_to(g.numpy(), w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip(tmoe.moe_dispatch(tidx, tgates, 4, C),
                    jmoe.moe_dispatch(idx, gates, 4, C)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_ties_go_to_the_lower_index_as_in_jax():
    """Router logits built to tie at the k boundary: expert 0 leads and
    experts 1, 2 and 3 tie for the second place (even rows), or experts 3
    and 1 tie above 0 and 2 (odd rows). jax.lax.top_k takes the lower
    index first; so must the port."""
    jcfg, tcfg = _cfgs()
    p = _bank(jcfg)
    h = 64
    router = np.zeros((h, 4), np.float32)
    router[0] = [2.0, 1.0, 1.0, 1.0]
    router[1] = [0.0, 1.0, 0.0, 1.0]
    x = np.zeros((2, 8, h), np.float32)
    x[0, :, 0] = 1.0
    x[1, :, 1] = 1.0
    p["router"] = jnp.asarray(router)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    _, want_idx = jax.lax.top_k(jprobs, 2)
    assert np.asarray(want_idx)[0, 0].tolist() == [0, 1]
    assert np.asarray(want_idx)[1, 0].tolist() == [1, 3]
    probs, gates, idx = tmoe.route(torch.from_numpy(x),
                                   torch.from_numpy(router), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want, _ = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    got, _ = tmoe.moe_apply(_torch(p), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("dispatch,cap", [("sort", 1.25), ("sort", DROPLESS),
                                          ("dense", 1.25)])
def test_moe_grads_match_jax(dispatch, cap):
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, moe_capacity_factor=cap,
                       use_bias=True)
    p = _bank(jcfg)
    x = _x()
    w = np.random.RandomState(3).standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jmoe.moe_apply(params, xx, jcfg)
        return jnp.sum(y * jnp.asarray(w)) + 0.5 * aux

    (gp, gx) = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = _torch(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    ((y * torch.from_numpy(w)).sum() + 0.5 * aux).backward()
    assert _rel_err(tx.grad.numpy(), gx) < TOL
    for k in p:
        assert _rel_err(tp[k].grad.numpy(), gp[k]) < TOL, k


def test_rows_independent_of_neighbours_and_padding_when_dropless():
    """Mixtral's capacity E / K: a row's output does not depend on the
    other rows of its batch nor on pad tokens after it (an engine bucket).
    Under a finite capacity pad tokens take slots, as in the reference."""
    _, tcfg = _cfgs(moe_capacity_factor=DROPLESS)
    jcfg, _ = _cfgs()
    p = _torch(_bank(jcfg))
    x = torch.from_numpy(_x(b=3, s=20))
    with torch.no_grad():
        batch, _ = tmoe.moe_apply(p, x, tcfg)
        for i in range(3):
            alone, _ = tmoe.moe_apply(p, x[i:i + 1, :13], tcfg)
            torch.testing.assert_close(alone[0], batch[i, :13], rtol=0,
                                       atol=1e-6)


def test_int8_expert_matmul_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 4, 6, 32)).astype(np.float32)
    w = (rs.standard_normal((4, 32, 24)) * 0.1).astype(np.float32)
    # quantized values and scales
    jxi, jsx = jq.quantize_rows(jnp.asarray(x))
    txi, tsx = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(txi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    jwi, jsw = jax.vmap(jq._quantize_cols)(jnp.asarray(w))
    twi, tsw = tq._quantize_bank(torch.from_numpy(w))
    np.testing.assert_array_equal(twi.numpy(), np.asarray(jwi))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    # forward, and the straight-through backward
    dy = rs.standard_normal((2, 4, 6, 24)).astype(np.float32)
    want, vjp = jax.vjp(jq.int8_expert_matmul, jnp.asarray(x),
                        jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = tq.int8_expert_matmul(tx, tw)
    got.backward(torch.from_numpy(dy))
    assert _rel_err(got.detach().numpy(), want) < 1e-6
    assert _rel_err(tx.grad.numpy(), want_dx) < 1e-6
    assert _rel_err(tw.grad.numpy(), want_dw) < 1e-6


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_moe_int8_bank_path_matches_jax(dispatch):
    jcfg, tcfg = _cfgs(quantized_gemm="int8", moe_dispatch=dispatch,
                       moe_capacity_factor=DROPLESS)
    p = _bank(jcfg)
    x = _x()
    want, _ = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    got, _ = tmoe.moe_apply(_torch(p), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _mixtral(**kw):
    kw = dict(dict(vocab_size=256, attention_impl="flash",
                   compute_dtype="float32", seq_length=64), **kw)
    jcfg = jconfig.mixtral_config("tiny", **kw)
    tcfg = tconfig.mixtral_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = tlm.LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def mixtral():
    return _mixtral()


def test_quantize_weights_leaves_the_bank_untouched(mixtral):
    jcfg, params, tcfg, model = mixtral
    jtree = jq.quantize_weights(params)
    ttree = tq.quantize_weights(model)

    def kinds(tree, w8):
        return {k: (kinds(v, w8) if isinstance(v, dict) or hasattr(
            v, "items") else isinstance(v, w8)) for k, v in tree.items()}
    assert kinds(ttree, tq.W8) == kinds(jtree, jq.W8)
    assert not any(kinds(ttree, tq.W8)["transformer"]["mlp"].values())
    assert kinds(ttree, tq.W8)["transformer"]["attention"]["wq"]
    for k, v in ttree["transformer"]["mlp"].items():
        assert v is model.transformer["mlp"][k]
    toks = np.random.RandomState(0).randint(0, 256, (2, 24))
    want, _ = jlm.model_forward(jtree, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, _ = tlm.model_forward(ttree, torch.from_numpy(toks), tcfg)
    # int8 attention: an activation within an ulp of a rounding boundary
    # moves by one int8 step (tests/test_torch_quantized.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-2)


def test_mixtral_forward_and_aux_match_jax(mixtral):
    jcfg, params, tcfg, model = mixtral
    toks = np.random.RandomState(1).randint(0, 256, (2, 48))
    want, _, want_aux = jlm.model_forward(params, jnp.asarray(toks), jcfg,
                                          return_aux=True)
    with torch.no_grad():
        got, _, got_aux = tlm.model_forward(model, torch.from_numpy(toks),
                                            tcfg, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert _rel_err(got_aux.item(), want_aux) < TOL
    # a dense model's aux is a zero tensor, and it launches nothing
    dense = tconfig.llama2_config("tiny", vocab_size=256, num_layers=1,
                                  compute_dtype="float32")
    dm = tlm.LanguageModel(dense, device="cpu")
    _, _, aux = tlm.model_forward(dm, torch.from_numpy(toks[:, :8]), dense,
                                  return_aux=True)
    assert aux.dtype == torch.float32 and aux.item() == 0.0


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_mixtral_loss_with_aux_and_grads_match_jax(dispatch):
    jcfg, params, tcfg, _ = _mixtral(moe_dispatch=dispatch,
                                     moe_capacity_factor=1.25)
    model = tlm.LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"),
        trainable=True)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 256, (2, 65))
    mask = (rs.rand(2, 65) > 0.3).astype(np.float32)
    want, want_g = jax.value_and_grad(jlm.loss_fn)(
        params, jnp.asarray(toks), jcfg, loss_mask=jnp.asarray(mask))
    got = tlm.loss_fn(model, torch.from_numpy(toks), tcfg,
                      loss_mask=torch.from_numpy(mask))
    got.backward()
    assert _rel_err(got.item(), want) < TOL
    # the aux term is in the loss: without it both would differ
    _, _, aux = tlm.model_forward(model, torch.from_numpy(toks[:, :-1]), tcfg,
                                  return_aux=True)
    assert tcfg.moe_aux_loss_coeff * aux.item() > 1e-3
    grads = _flatten(want_g)
    for name, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), grads[name.replace(".", "/")]) < TOL


def test_mixtral_serial_greedy_matches_jax_generator(mixtral):
    jcfg, params, tcfg, model = mixtral
    prompts = [[5, 17, 3, 9], list(range(30, 51))]
    jgen = JGenerator(params, jcfg, eos_id=0)
    gen = Generator(model, tcfg, eos_id=0, device="cpu")
    for p in prompts:
        wt, wl, wlp = jgen.generate([p], 12, JSampling(temperature=0.0))
        gt, gl, glp = gen.generate([p], 12,
                                   sampling=SamplingParams(temperature=0.0))
        n = int(wl[0])
        assert int(gl[0]) == n
        assert gt[0, :n].tolist() == np.asarray(wt)[0, :n].tolist()
        np.testing.assert_allclose(np.asarray(glp)[0, len(p):n],
                                   np.asarray(wlp)[0, len(p):n], rtol=1e-4,
                                   atol=1e-4)


def test_moe_flags_parse_to_jax_model_config():
    argv = ["--num_layers", "2", "--hidden_size", "64",
            "--num_attention_heads", "4", "--ffn_hidden_size", "96",
            "--seq_length", "32", "--use_rms_norm", "--num_experts", "4",
            "--moe_top_k", "1", "--moe_capacity_factor", "1.5",
            "--moe_aux_loss_coeff", "0.05", "--moe_dispatch", "dense"]
    want, _ = jargs.parse_cli(argv)
    got, _ = targs.parse_cli(argv)
    fields = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    for name in fields & {f.name for f in dataclasses.fields(
            jconfig.ModelConfig)}:
        assert getattr(got.model, name) == getattr(want.model, name), name
    assert (got.model.num_experts, got.model.moe_top_k,
            got.model.moe_dispatch) == (4, 1, "dense")
    # the preset's dropless capacity survives, an explicit flag wins
    for extra, cap in (([], 4.0), (["--moe_capacity_factor", "1.25"], 4.0),
                       (["--moe_capacity_factor", "2.5"], 2.5)):
        argv = ["--model", "mixtral-8x7b", "--num_layers", "2", *extra]
        want, _ = jargs.parse_cli(argv)
        got, _ = targs.parse_cli(argv)
        assert got.model.moe_capacity_factor == \
            want.model.moe_capacity_factor == cap
        assert got.model == tconfig.ModelConfig(**{
            f: getattr(want.model, f) for f in fields})
    with pytest.raises(NotImplementedError, match="item 7"):
        targs.parse_cli(["--num_experts", "4", "--expert_axis", "dp"])


@pytest.mark.parametrize("bad,match", [(dict(moe_top_k=5), "moe_top_k"),
                                       (dict(moe_top_k=0), "moe_top_k"),
                                       (dict(moe_dispatch="scan"),
                                        "moe_dispatch")])
def test_validate_checks_the_routing(bad, match):
    cfg = tconfig.MegatronConfig(model=dataclasses.replace(
        tconfig.mixtral_config("tiny"), **bad))
    with pytest.raises(ValueError, match=match):
        cfg.validate()
    with pytest.raises(AssertionError, match=match):
        jconfig.MegatronConfig(model=dataclasses.replace(
            jconfig.mixtral_config("tiny"), **bad)).validate()


def test_mixtral_entry_points_raise_without_gpu_and_device(monkeypatch):
    from megatron_tpu_torch.serving import ServingEngine
    from megatron_tpu_torch.training.train_step import (init_train_state,
                                                        make_train_step)
    cfg = tconfig.mixtral_config("tiny", vocab_size=256)
    mcfg = tconfig.MegatronConfig(model=cfg).validate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tlm.LanguageModel(cfg),
               lambda: init_train_state(mcfg),
               lambda: make_train_step(mcfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    model = tlm.LanguageModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(model, cfg, eos_id=0)
    gen = Generator(model, cfg, eos_id=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(gen, tconfig.ServingConfig(num_slots=2, max_len=64))
