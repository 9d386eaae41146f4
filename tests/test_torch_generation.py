"""The port's generation and sampling against the JAX package's, on the same
weights and prompts, in fp32 compute with the reference's bf16 KV cache.
Greedy tokens must match exactly; logprobs and scores within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import generation as jgen
from megatron_tpu.inference import sampling as jsampling
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference import generation as tgen
from megatron_tpu_torch.inference import sampling as tsampling
from megatron_tpu_torch.models.language_model import LanguageModel

torch.set_num_threads(2)
TOL = 1e-4
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}


@pytest.fixture(scope="module", params=sorted(PRESETS))
def gens(request):
    """(JAX Generator, port Generator) over the same tiny flash model."""
    fn = PRESETS[request.param]
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return (jgen.Generator(params, jcfg, eos_id=0, pad_id=0),
            tgen.Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu"))


PROMPTS = [[5, 17, 3, 99, 250, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
            19, 20, 21],
           list(range(30, 67)),
           [400, 401, 402]]


@pytest.mark.parametrize("prompts", [PROMPTS[:2], PROMPTS],
                         ids=["flash_prefill", "one_token_prefill"])
def test_greedy_generate_matches_jax(gens, prompts):
    jg, tg = gens
    greedy = jgen.SamplingParams(temperature=0.0)
    wt, wl, wlp = jg.generate(prompts, 12, sampling=greedy)
    gt, gl, glp = tg.generate(prompts, 12,
                              sampling=tgen.SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(gl, wl)
    assert gt.shape == wt.shape
    for i, n in enumerate(wl):
        np.testing.assert_array_equal(gt[i, :n], wt[i, :n])
        np.testing.assert_allclose(glp[i, :n], wlp[i, :n], rtol=TOL,
                                   atol=TOL)


def test_score_matches_jax(gens):
    jg, tg = gens
    rows = [PROMPTS[0], PROMPTS[1][:25]]
    np.testing.assert_allclose(tg.score(rows), jg.score(rows), rtol=TOL,
                               atol=TOL)


def test_beam_search_matches_jax(gens):
    jg, tg = gens
    wt, wl, ws = jgen.beam_search(jg, PROMPTS[0], 3, 5)
    gt, gl, gs = tgen.beam_search(tg, PROMPTS[0], 3, 5)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [0, 1, 5, 50])
def test_top_k_filter_matches_jax(k):
    logits = np.random.RandomState(k).standard_normal((3, 64)).astype(
        np.float32)
    want = np.asarray(jsampling.top_k_filter(jnp.asarray(logits), k))
    # the port keeps only the per-row filter; k on every row is the scalar
    got = tsampling._top_k_filter_rows(torch.from_numpy(logits),
                                       torch.full((3,), k)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 1.0])
def test_top_p_filter_matches_jax(p):
    logits = 3 * np.random.RandomState(7).standard_normal((3, 64)).astype(
        np.float32)
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(logits), p))
    got = tsampling._top_p_filter_rows(torch.from_numpy(logits),
                                       torch.full((3,), p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_greedy_rules_and_vocab_mask():
    logits = torch.zeros(2, 8)
    logits[0, 6] = 5.0  # in the padded tail: never drawn
    logits[1, 2] = 1.0
    for kw in (dict(temperature=0.0), dict(top_k=1)):
        out = tsampling.sample(None, logits, vocab_size=6, **kw)
        assert out[1].item() == 2 and out[0].item() < 6
    g = torch.Generator().manual_seed(0)
    drawn = tsampling.sample(g, logits.repeat(50, 1), vocab_size=6,
                             temperature=1.0)
    assert int(drawn.max()) < 6


def test_seeded_sampling_is_deterministic_in_the_port(gens):
    _, tg = gens
    sp = tgen.SamplingParams(temperature=0.8, top_k=40, top_p=0.9)
    a = tg.generate(PROMPTS[:2], 8, sampling=sp, seed=7)
    b = tg.generate(PROMPTS[:2], 8, sampling=sp, seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = tg.generate(PROMPTS[:2], 8, sampling=sp, seed=8)
    assert not np.array_equal(a[0], c[0])
