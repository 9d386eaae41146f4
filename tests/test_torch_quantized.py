"""The port's int8 path against the JAX package's, on the same numpy inputs
and weights: ops/quantized.py, int8-resident (W8) weights, and int8 KV
caches on the serial route, in beam search and in the engine's pools.

Tolerances:
- `quantize_rows`, `_quantize_cols`, `quantize_weights` and the W8 / int8
  GEMM forwards are bit-exact (the same fp32 division by a tensor, half-to-
  even rounding and an exact int32 product);
- straight-through grads and `loss_fn` grads with quantized_gemm="int8":
  1e-5 of the largest value (fp32 products summed in another order), loss
  1e-5 relative;
- logits of a tiny fp32 model with W8 weights: 2e-2 absolute on logits up
  to ~1.6. The fp32 activations before each quantization agree to ~1e-6,
  and where one lands within that of a rounding boundary its int8 value
  moves by one step (1/127 of the row's amax), which moves the logits of
  the positions after it by up to ~1e-2; most rows stay bit-exact. Argmax
  must agree everywhere;
- generation with int8 caches and/or W8 weights: greedy tokens exact,
  logprobs within 2e-2 (the same argument).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import generation as jgen
from megatron_tpu.models import language_model as jlm
from megatron_tpu.ops import quantized as jq
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference import generation as tgen
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.ops import quantized as tq
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine

torch.set_num_threads(2)
GRAD_TOL = 1e-5
LOGIT_TOL = 2e-2
PROMPTS = [[5, 17, 3, 99, 250, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
            19, 20, 21],
           list(range(30, 67)),
           [400, 401, 402]]
BLOCK = dict(num_slots=3, kv_block_size=16, block_native_attn=True,
             max_len=128)


def _ties(dtype):
    """Rows with a zero row, exact .5 ties (amax 127 gives scale 1.0), and
    random values."""
    rs = np.random.RandomState(0)
    x = rs.randn(6, 40).astype(np.float32) * 3
    x[1] = 0.0
    x[2, :8] = [127.0, 0.5, 1.5, -2.5, 63.5, -0.5, 126.5, -126.5]
    x[3, :4] = [-127.0, 2.5, 3.5, -3.5]
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_and_cols_bit_exact(dtype):
    x = _ties(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for jfn, tfn, arr_j, arr_t in (
            (jq.quantize_rows, tq.quantize_rows, jx, tx),
            (jq._quantize_cols, tq._quantize_cols, jx.T, tx.T)):
        (wq, ws), (gq, gs) = jfn(arr_j), tfn(arr_t)
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    q, s = tq.quantize_rows(torch.from_numpy(x))
    assert q[2, :8].tolist() == [127, 0, 2, -2, 64, 0, 126, -126]
    assert s[1].item() == 1.0 and not q[1].any()


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX params, port cfg, port model) of tiny Llama, fp32
    compute, flash attention."""
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = tlm.LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def quantized(tiny):
    """(JAX quantized params, the port's tree carried across from them)."""
    jcfg, params, tcfg, _ = tiny
    pq = jq.quantize_weights(params)
    tree = tlm.params_tree(params_from_numpy(_flatten(pq), tcfg,
                                             device="cpu"))
    return pq, tree


def test_quantize_weights_bit_exact(tiny, quantized):
    _, _, _, model = tiny
    _, carried = quantized
    mine = tq.quantize_weights(model)
    assert tq.has_quantized_weights(mine)
    assert not tq.has_quantized_weights(model)
    for group, names in (("attention", ("wq", "wkv", "wo")),
                         ("mlp", ("w1", "w2"))):
        for name in names:
            a = mine["transformer"][group][name]
            b = carried["transformer"][group][name]
            assert isinstance(a, tq.W8) and a.q.dtype == torch.int8
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    # embedding, norms and head are the model's own tensors
    assert mine["embedding"]["word_embeddings"] is \
        model.embedding["word_embeddings"]
    assert not isinstance(mine["transformer"]["input_norm"]["scale"], tq.W8)


def test_int8_matmul_forward_and_straight_through_grads():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 64).astype(np.float32)
    w = rs.randn(64, 48).astype(np.float32)
    dy = rs.randn(2, 5, 48).astype(np.float32)
    want = jq.int8_matmul(jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jq.int8_matmul(a, b) * dy),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = tq.int8_matmul(tx, tw)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(dy))
    for g, r in ((tx.grad, jdx), (tw.grad, jdw)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * abs(r).max())


def test_qdense_glu_layout_and_w8_dispatch():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 4, 32).astype(np.float32)
    w = rs.randn(32, 2, 24).astype(np.float32)
    want = jq.qdense(jnp.asarray(x), jnp.asarray(w), "int8")
    got = tq.qdense(torch.from_numpy(x), torch.from_numpy(w), "int8")
    assert got.shape == (3, 4, 2, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a W8 weight takes the int8 path whatever the flag says
    q, s = jq._quantize_cols(jnp.asarray(w.reshape(32, -1)))
    jw8 = jq.W8(q.reshape(32, 2, 24), s.reshape(2, 24))
    tw8 = tq.W8(torch.from_numpy(np.array(jw8.q)),
                torch.from_numpy(np.array(jw8.scale)))
    want = jq.qdense(jnp.asarray(x), jw8, "none")
    for flag in ("none", "int8"):
        got = tq.qdense(torch.from_numpy(x), tw8, flag)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq.wcast(tw8, torch.bfloat16) is tw8


def test_w8_model_logits_match_jax(tiny, quantized):
    jcfg, _, tcfg, _ = tiny
    pq, tree = quantized
    toks = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 24))
    want, _ = jlm.model_forward(pq, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, _ = tlm.model_forward(tree, torch.from_numpy(toks), tcfg)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_loss_fn_grads_with_int8_gemm_match_jax(tiny):
    _, params, _, _ = tiny
    kw = dict(attention_impl="flash", compute_dtype="float32",
              quantized_gemm="int8")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    toks = np.random.RandomState(5).randint(0, tcfg.vocab_size, (2, 17))
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(params, jnp.asarray(toks),
                                                    jcfg)
    model = tlm.LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"),
        trainable=True)
    loss = tlm.loss_fn(model, torch.from_numpy(toks), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = {k.replace("/", "."): v for k, v in _flatten(jgrads).items()}
    for name, p in model.named_parameters():
        r = np.asarray(want[name])
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * max(abs(r).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("arm", ["int8kv", "w8", "w8_int8kv"])
def test_generate_int8_matches_jax(tiny, quantized, arm):
    jcfg, params, tcfg, model = tiny
    pq, tree = quantized
    w8 = arm.startswith("w8")
    kv = "int8kv" in arm
    jg = jgen.Generator(pq if w8 else params, jcfg, eos_id=0, pad_id=0,
                        kv_cache_dtype=jnp.int8 if kv else jnp.bfloat16)
    tg = tgen.Generator(tree if w8 else model, tcfg, eos_id=0, pad_id=0,
                        device="cpu",
                        kv_cache_dtype=torch.int8 if kv else torch.bfloat16)
    wt, wl, wlp = jg.generate(PROMPTS, 12,
                              sampling=jgen.SamplingParams(temperature=0.0))
    gt, gl, glp = tg.generate(PROMPTS, 12,
                              sampling=tgen.SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(gl, wl)
    for i, n in enumerate(wl):
        np.testing.assert_array_equal(gt[i, :n], wt[i, :n])
        np.testing.assert_allclose(glp[i, :n], wlp[i, :n], rtol=0,
                                   atol=LOGIT_TOL)


def test_beam_search_on_int8_cache_matches_jax(tiny):
    jcfg, params, tcfg, model = tiny
    jg = jgen.Generator(params, jcfg, eos_id=0, pad_id=0,
                        kv_cache_dtype=jnp.int8)
    tg = tgen.Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                        kv_cache_dtype=torch.int8)
    wt, wl, ws = jgen.beam_search(jg, PROMPTS[0], 3, 5)
    gt, gl, gs = tgen.beam_search(tg, PROMPTS[0], 3, 5)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=LOGIT_TOL)


ENGINE_PROMPTS = [[5, 17, 3], list(range(30, 44)), list(range(100, 120)),
                  list(range(200, 233)), [7, 8, 9, 10, 11, 12, 13, 14, 15]]


@pytest.mark.parametrize("w8", [False, True], ids=["bf16w", "w8"])
def test_int8_block_engine_matches_jax_engine(tiny, quantized, w8):
    jcfg, params, tcfg, model = tiny
    pq, tree = quantized
    serving = dict(BLOCK, kv_dtype="int8")
    jeng = JServingEngine(
        jgen.Generator(pq if w8 else params, jcfg, eos_id=0, pad_id=0),
        jconfig.ServingConfig(**serving))
    try:
        reqs = [jeng.submit(p, 10, JSamplingOptions(temperature=0.0))
                for p in ENGINE_PROMPTS]
        want = [r.result(timeout=600) for r in reqs]
    finally:
        jeng.close()
    gen = tgen.Generator(tree if w8 else model, tcfg, eos_id=0, pad_id=0,
                         device="cpu")
    with ServingEngine(gen, ServingConfig(**serving), device="cpu") as eng:
        assert eng.pool.caches.arena.k.dtype == torch.int8
        reqs = [eng.submit(p, 10, SamplingOptions(temperature=0.0))
                for p in ENGINE_PROMPTS]
        got = [r.result(timeout=600) for r in reqs]
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=0, atol=LOGIT_TOL)


def test_int8_engine_route_equals_int8_serial_route(quantized, tiny):
    _, tree = quantized
    _, _, tcfg, _ = tiny
    gen = tgen.Generator(tree, tcfg, eos_id=0, pad_id=0, device="cpu",
                         kv_cache_dtype=torch.int8)

    class Tok:
        eod = 0
        vocab_size = tcfg.vocab_size

        def tokenize(self, text):
            return [int(t) for t in text.split()]

        def detokenize(self, ids):
            return " ".join(str(i) for i in ids)

    payload = {"prompts": [" ".join(map(str, p)) for p in ENGINE_PROMPTS],
               "tokens_to_generate": 10, "temperature": 0.0}
    for serving in (ServingConfig(**BLOCK),
                    ServingConfig(num_slots=3, max_len=128)):
        server = MegatronServer(gen, Tok(), serving=serving, device="cpu")
        try:
            assert server.engine.pool.dtype == torch.int8
            s1, engine = server.handle(payload)
            s2, serial = server.handle(dict(payload, serial=True))
        finally:
            server.close()
        assert s1 == s2 == 200
        assert engine["segments"] == serial["segments"]


def test_int8_pool_accounting_counts_scales(tiny):
    _, _, tcfg, _ = tiny
    from megatron_tpu_torch.serving.kv_pool import SlotKVPool
    per = 2 * tcfg.num_layers * tcfg.num_kv_heads
    for block in (None, 16):
        pool = SlotKVPool(tcfg, 2, 64, dtype=torch.int8, block_size=block,
                          device="cpu")
        assert pool.bytes_per_token() == per * (tcfg.kv_channels + 4)
        c = pool.caches.arena if block else pool.caches
        assert bool((c.k_scale == 1.0).all())
        tokens = c.k.numel() // (tcfg.num_kv_heads * tcfg.kv_channels
                                 * tcfg.num_layers)
        assert pool.nbytes() == tokens * pool.bytes_per_token()
