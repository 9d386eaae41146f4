"""The port's model forward against the JAX package's, on the same weights
(moved across by the bridge) and the same numpy tokens, in fp32 compute.
Tolerance 1e-4 on logits: the same fp32 arithmetic in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import init_kv_caches as j_init_kv
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import init_kv_caches
from megatron_tpu_torch.models import attention as tattention
from megatron_tpu_torch.models import language_model as tlm

torch.set_num_threads(2)
TOL = 1e-4
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}


@pytest.fixture(scope="module", params=sorted(PRESETS))
def pair(request):
    """(jax cfg, jax params, port cfg, port model) for a tiny preset on the
    flash path with fp32 compute."""
    fn = PRESETS[request.param]
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = tlm.LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def test_model_forward_matches_jax(pair):
    jcfg, params, tcfg, model = pair
    toks = _tokens(jcfg, 2, 48, seed=0)
    want, _ = jlm.model_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, caches = tlm.model_forward(model, torch.from_numpy(toks), tcfg)
    assert caches is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_cached_prefill_then_decode_matches_jax(pair):
    """Offset-0 prefill (flash) then 4 single-token decode steps (dot path
    over the bf16 cache)."""
    jcfg, params, tcfg, model = pair
    b, s, max_len = 2, 32, 64
    toks = _tokens(jcfg, b, s + 4, seed=1)
    jrope = jlm.make_rope(jcfg, max_len=jcfg.max_position_embeddings)
    trope = tlm.make_rope(tcfg, max_len=tcfg.max_position_embeddings,
                          device="cpu")
    jc = j_init_kv(jcfg, b, max_len)
    tc = init_kv_caches(tcfg, b, max_len, device="cpu")
    steps = [toks[:, :s]] + [toks[:, s + i:s + i + 1] for i in range(4)]
    with torch.no_grad():
        for chunk in steps:
            want, jc = jlm.model_forward(params, jnp.asarray(chunk), jcfg,
                                         kv_caches=jc, rope=jrope)
            got, tc = tlm.model_forward(model, torch.from_numpy(chunk), tcfg,
                                        kv_caches=tc, rope=trope)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    assert tc.offset == s + 4


def test_offset_chunk_takes_dot_path(pair, monkeypatch):
    """A multi-token chunk at offset > 0 attends the cache's live region on
    the dot path: the flash kernel runs only for the offset-0 prefill."""
    jcfg, params, tcfg, model = pair
    calls = []
    real = tattention.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tattention, "flash_attention", counting)
    b, max_len = 1, 64
    toks = _tokens(jcfg, b, 40, seed=2)
    jrope = jlm.make_rope(jcfg, max_len=jcfg.max_position_embeddings)
    trope = tlm.make_rope(tcfg, max_len=tcfg.max_position_embeddings,
                          device="cpu")
    jc = j_init_kv(jcfg, b, max_len)
    tc = init_kv_caches(tcfg, b, max_len, device="cpu")
    with torch.no_grad():
        for lo, hi, flash_calls in ((0, 24, tcfg.num_layers),
                                    (24, 40, tcfg.num_layers)):
            want, jc = jlm.model_forward(params, jnp.asarray(toks[:, lo:hi]),
                                         jcfg, kv_caches=jc, rope=jrope)
            got, tc = tlm.model_forward(model, torch.from_numpy(
                toks[:, lo:hi]), tcfg, kv_caches=tc, rope=trope)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
            assert len(calls) == flash_calls
