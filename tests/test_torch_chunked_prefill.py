"""The port's chunked prefill.

- generation.prefill_chunk against the JAX function on the same weights
  and tokens: a prompt forwarded in three chunks (the first at offset 0,
  the flash path; the others at their offset, the dot path; the last
  bucket-padded) gives each chunk's last-token logits within 1e-4 with
  an fp32 cache; with an int8 cache within 2e-2, tests/test_torch_
  quantized.py's bound (an activation within an ulp of a rounding boundary
  quantizes one step apart in the two packages).
- The engine with `prefill_chunk` against the JAX ServingEngine, both
  block-native (the JAX one in Pallas interpret mode), on tiny Llama and
  Falcon with fp32 compute: greedy tokens exact, logprobs within 1e-4,
  the same chunk count.
- Inside the port: decode steps run between a long prompt's chunks, and
  chunked equals unchunked on the whole-region pool.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import generation as jgeneration
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference import generation as tgeneration
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine

torch.set_num_threads(2)
TOL = 1e-4
INT8_TOL = 2e-2
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}
# 45 and 60 tokens: 3 and 4 chunks of 16, a padded tail each
PROMPTS = [list(range(100, 145)), [5, 17, 3], list(range(30, 90)),
           list(range(200, 209))]
NEW = 8
CHUNK = 16


def _models(name):
    fn = PRESETS[name]
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_prefill_chunk_matches_jax(kv):
    jcfg, params, tcfg, model = _models("llama")
    toks = list(range(300, 345))
    jdt = jnp.float32 if kv == "float32" else jnp.int8
    tdt = torch.float32 if kv == "float32" else torch.int8
    jcache = jgeneration.init_kv_caches(jcfg, 1, 64, dtype=jdt)
    tcache = tgeneration.init_kv_caches(tcfg, 1, 64, dtype=tdt)
    jrope = jlm.make_rope(jcfg, max_len=jcfg.max_position_embeddings)
    trope = tlm.make_rope(tcfg, max_len=tcfg.max_position_embeddings)
    pos = 0
    for n, padded in ((16, 16), (16, 16), (13, 16)):
        chunk = np.zeros((1, padded), np.int32)
        chunk[0, :n] = toks[pos:pos + n]
        jcache, jlast = jgeneration.prefill_chunk(
            params, jnp.asarray(chunk), jcache, jcfg, rope=jrope,
            last_idx=n - 1, next_offset=pos + n)
        tcache, tlast = tgeneration.prefill_chunk(
            model, torch.from_numpy(chunk).long(), tcache, tcfg, rope=trope,
            last_idx=n - 1, next_offset=pos + n)
        pos += n
        assert tcache.offset == pos == int(np.asarray(jcache.offset)[0])
        tol = TOL if kv == "float32" else INT8_TOL
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   rtol=tol, atol=tol)


def _submit_all(submit):
    reqs = [submit(p, NEW) for p in PROMPTS]
    return [r.result(timeout=600) for r in reqs]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_chunked_engine_matches_jax_engine(name):
    jcfg, params, tcfg, model = _models(name)
    kw = dict(num_slots=3, max_len=128, kv_block_size=16,
              block_native_attn=True, prefill_chunk=CHUNK)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                          jconfig.ServingConfig(**kw))
    try:
        want = _submit_all(lambda p, n: jeng.submit(
            p, n, JSamplingOptions(temperature=0.0)))
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**kw), device="cpu") as eng:
        got = _submit_all(lambda p, n: eng.submit(
            p, n, SamplingOptions(temperature=0.0)))
        snap = eng.metrics.snapshot()
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    # 45 and 60 tokens take 3 and 4 chunks
    assert snap["prefill_chunks"] == jsnap["prefill_chunks"] == 7
    assert snap["prefill_forward_tokens"] == jsnap["prefill_forward_tokens"]


@pytest.fixture(scope="module")
def port_gen():
    _, _, tcfg, model = _models("llama")
    return Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


def test_decode_steps_run_between_chunks(port_gen):
    """A 100-token prompt arriving while two streams decode takes 7 chunks
    of 16, one an iteration, and both streams commit a token between
    consecutive chunks."""
    gen = Generator(port_gen.params, port_gen.cfg, eos_id=-1, pad_id=0,
                    device="cpu", kv_cache_dtype=torch.float32)
    greedy = SamplingOptions(temperature=0.0)
    with ServingEngine(gen, ServingConfig(num_slots=3, max_len=256,
                                          prefill_chunk=CHUNK),
                       device="cpu") as eng:
        running = [eng.submit([5, 6, 7 + i], 60, greedy) for i in range(2)]
        while any(len(r.generated) < 2 for r in running):
            time.sleep(0.01)
        marks = []  # the streams' token total before each chunk
        orig = eng._advance_prefill

        def spy():
            before = eng.metrics.snapshot()["prefill_chunks"]
            tokens = sum(len(r.generated) for r in running)
            orig()
            if eng.metrics.snapshot()["prefill_chunks"] > before:
                marks.append(tokens)

        eng._advance_prefill = spy
        long = eng.submit(list(range(1, 101)), 4, greedy)
        long.result(timeout=120)
        for r in running:
            r.result(timeout=120)
    assert long.prefill_chunks == 7 and len(marks) == 7
    assert all(b - a >= 2 for a, b in zip(marks, marks[1:])), marks


@pytest.mark.parametrize("chunk", [5, 16])
def test_chunked_equals_unchunked_region(port_gen, chunk):
    outs = []
    for c in (None, chunk):
        with ServingEngine(port_gen, ServingConfig(
                num_slots=3, max_len=128, prefill_chunk=c),
                device="cpu") as eng:
            outs.append([t for t, _ in _submit_all(
                lambda p, n: eng.submit(p, n,
                                        SamplingOptions(temperature=0.0)))])
    assert outs[0] == outs[1]
