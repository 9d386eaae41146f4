"""The port's speculative decoding.

- verify_draft_probs, NGramDrafter and build_draft_rounds against the JAX
  functions on the same numpy inputs (per-row temperature, top-k, top-p,
  filler drafts).
- generation.verify_tokens against JAX's: a [slots, 4]-token window at
  per-row offsets over the same cache contents, whole-region and
  block-native (the block kernel's plain version in the port, Pallas
  interpret mode in JAX); logits within 1e-4.
- The engine with `speculative_k` against the JAX ServingEngine, both
  block-native, on tiny Llama and Falcon with fp32 compute, with the
  n-gram drafter and with one that proposes the known greedy continuation
  of some streams (so drafts are accepted): greedy tokens exact, logprobs
  within 1e-4, the same rounds, drafts and accepted counts.
- Inside the port (torch cannot reproduce jax.random): speculative greedy
  equals plain decode with `decode_sync_interval` 1 and 2 on the block,
  bracketed and whole-region pools; a seeded sampled request's stream is
  the same alone in the grid and among other requests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import generation as jgeneration
from megatron_tpu.inference import sampling as jsampling
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.models.attention import KVCache as JKVCache
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import kv_pool as jkv
from megatron_tpu.serving import spec_decode as jspec
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference import generation as tgeneration
from megatron_tpu_torch.inference import sampling as tsampling
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.models.attention import BlockKVCache, KVCache
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.serving import spec_decode as tspec

torch.set_num_threads(2)
TOL = 1e-4
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}
# prompts that repeat spans, so the n-gram drafter proposes
PROMPTS = [[5, 6, 7, 8] * 6, list(range(30, 40)) * 3, [9, 3, 9, 3, 9, 3, 9],
           list(range(100, 120)) + list(range(100, 110))]
NEW = 12
K = 3
GREEDY = SamplingOptions(temperature=0.0)


def _models(name):
    fn = PRESETS[name]
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def test_verify_draft_probs_matches_jax():
    rs = np.random.RandomState(0)
    b, w, V, vocab = 4, 3, 40, 37
    logits = 3 * rs.standard_normal((b, w, V)).astype(np.float32)
    drafts = rs.randint(0, vocab, (b, w)).astype(np.int32)
    drafts[1, 2] = -1  # a filler
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    ks = np.array([0, 5, 1, 0], np.int32)
    ps = np.array([0.0, 0.9, 0.5, 0.0], np.float32)
    want_p, want_t = jsampling.verify_draft_probs(
        jnp.asarray(logits), jnp.asarray(drafts),
        temperature=jnp.asarray(temps), top_k=jnp.asarray(ks),
        top_p=jnp.asarray(ps), vocab_size=vocab)
    got_p, got_t = tsampling.verify_draft_probs(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        temperature=torch.from_numpy(temps), top_k=torch.from_numpy(ks),
        top_p=torch.from_numpy(ps), vocab_size=vocab)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    # filters given as None (off on every row) equal all-zero knobs
    off_p, _ = tsampling.verify_draft_probs(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        temperature=torch.from_numpy(temps), top_k=None, top_p=None,
        vocab_size=vocab)
    zero_p, _ = jsampling.verify_draft_probs(
        jnp.asarray(logits), jnp.asarray(drafts),
        temperature=jnp.asarray(temps), top_k=jnp.zeros(b, jnp.int32),
        top_p=jnp.zeros(b, jnp.float32), vocab_size=vocab)
    np.testing.assert_allclose(off_p.numpy(), np.asarray(zero_p),
                               rtol=1e-6, atol=1e-7)


def test_drafter_and_draft_rounds_match_jax():
    rs = np.random.RandomState(1)
    histories = [list(rs.randint(0, 4, n)) for n in (0, 1, 2, 9, 30, 200)]
    histories.append(None)
    for args in ((3, 1, 1024), (2, 2, 8), (4, 1, 16)):
        ours, ref = tspec.NGramDrafter(*args), jspec.NGramDrafter(*args)
        for h in histories[:-1]:
            for n in (0, 1, 5):
                assert ours.propose(h, n) == ref.propose(h, n)
        for k, rounds in ((3, 1), (2, 3)):
            got = tspec.build_draft_rounds(histories, ours, k, rounds)
            want = jspec.build_draft_rounds(histories, ref, k, rounds)
            for g, w in zip(got[0] + got[2], want[0] + want[2]):
                np.testing.assert_array_equal(g, w)
            assert got[1] == want[1]


@pytest.mark.parametrize("layout", ["region", "block"])
def test_verify_tokens_matches_jax(layout):
    jcfg, params, tcfg, model = _models("llama")
    rs = np.random.RandomState(2)
    L, nkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.kv_channels
    S, cap, B, w, max_len = 3, 64, 16, 4, 64
    k = (0.5 * rs.standard_normal((L, S, cap, nkv, hd))).astype(np.float32)
    v = (0.5 * rs.standard_normal((L, S, cap, nkv, hd))).astype(np.float32)
    lengths = np.array([5, 31, 62], np.int32)  # the last at the clamp
    tokens = rs.randint(1, 500, (S, w)).astype(np.int32)
    jrope = jlm.make_rope(jcfg, max_len=jcfg.max_position_embeddings)
    trope = tlm.make_rope(tcfg, max_len=tcfg.max_position_embeddings)
    if layout == "region":
        jc = JKVCache(jnp.asarray(k), jnp.asarray(v),
                      jnp.zeros((L, S), jnp.int32))
        tc = KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                     torch.zeros(S, dtype=torch.int32))
    else:
        nb = cap // B
        T = S * nb + 1
        perm = rs.permutation(T - 1)[:S * nb].reshape(S, nb).astype(np.int32)
        ka = np.zeros((L, T, B, nkv, hd), np.float32)
        va = np.zeros((L, T, B, nkv, hd), np.float32)
        for s in range(S):
            for i in range(nb):
                ka[:, perm[s, i]] = k[:, s, i * B:(i + 1) * B]
                va[:, perm[s, i]] = v[:, s, i * B:(i + 1) * B]
        jc = jkv.block_native_cache(jkv.BlockKV(
            JKVCache(jnp.asarray(ka), jnp.asarray(va),
                     jnp.zeros((L, S), jnp.int32)), jnp.asarray(perm)))
        tc = BlockKVCache(torch.from_numpy(ka.copy()),
                          torch.from_numpy(va.copy()),
                          torch.zeros(S, dtype=torch.int32),
                          torch.from_numpy(perm))
    want, _ = jgeneration.verify_tokens(
        params, jnp.asarray(tokens), jc, jcfg, rope=jrope,
        lengths=jnp.asarray(lengths), max_len=max_len)
    got, _ = tgeneration.verify_tokens(
        model, torch.from_numpy(tokens).long(), tc, tcfg, rope=trope,
        lengths=torch.from_numpy(lengths), max_len=max_len)
    # rows whose window stays inside the region; the last row's tail
    # passes the clamp, where both packages give garbage
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[2, :2].numpy(), np.asarray(want)[2, :2],
                               rtol=TOL, atol=TOL)


def _submit_all(submit, prompts=PROMPTS):
    reqs = [submit(p, NEW) for p in prompts]
    return [r.result(timeout=600) for r in reqs]


class OracleDrafter:
    """Proposes the continuation of known greedy streams: a random model
    seldom repeats itself, and these drafts are accepted, so the accept
    path runs on every round."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, tokens, n):
        for seq in self.streams:
            if seq[:len(tokens)] == list(tokens):
                return seq[len(tokens):len(tokens) + n]
        return []


def _greedy_streams(gen):
    with ServingEngine(gen, ServingConfig(num_slots=3, max_len=128),
                       device="cpu") as eng:
        return [t for t, _ in _submit_all(lambda p, n: eng.submit(p, n,
                                                                  GREEDY))]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_spec_engine_matches_jax_engine(name):
    jcfg, params, tcfg, model = _models(name)
    kw = dict(num_slots=3, max_len=128, kv_block_size=16,
              block_native_attn=True, speculative_k=K)
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu")
    # the n-gram drafter (mostly rejected on a random model), then drafts
    # that are right but for a wrong guess here and there
    streams = _greedy_streams(gen)
    for drafter in (None, OracleDrafter(streams[:2])):
        jeng = JServingEngine(JGenerator(params, jcfg, eos_id=-1, pad_id=0),
                              jconfig.ServingConfig(**kw), drafter=drafter)
        try:
            want = _submit_all(lambda p, n: jeng.submit(
                p, n, JSamplingOptions(temperature=0.0)))
            jsnap = jeng.metrics.snapshot()
        finally:
            jeng.close()
        with ServingEngine(gen, ServingConfig(**kw), device="cpu",
                           drafter=drafter) as eng:
            got = _submit_all(lambda p, n: eng.submit(p, n, GREEDY))
            snap = eng.metrics.snapshot()
        for (gt, glp), (wt, wlp) in zip(got, want):
            assert gt == wt
            np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
        assert [t for t, _ in got] == streams
        assert snap["spec_rounds"] > 0
        for key in ("spec_rounds", "draft_tokens", "accepted_tokens",
                    "spec_fallback_steps"):
            assert snap[key] == jsnap[key], key
    assert snap["accepted_tokens"] > 0


@pytest.fixture(scope="module")
def port_gen():
    _, _, tcfg, model = _models("llama")
    return Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


@pytest.mark.parametrize("kw", [
    dict(kv_block_size=16, block_native_attn=True),
    dict(kv_block_size=16, block_native_attn=True, decode_sync_interval=2),
    dict(kv_block_size=16),
    dict(),
], ids=["block", "block_k2", "bracketed", "region"])
def test_spec_greedy_equals_plain_decode(port_gen, kw):
    outs, snaps = [], []
    drafter = OracleDrafter(_greedy_streams(port_gen))
    for k in (0, K):
        with ServingEngine(port_gen, ServingConfig(
                num_slots=3, max_len=128, speculative_k=k, **kw),
                device="cpu", drafter=drafter) as eng:
            outs.append(_submit_all(lambda p, n: eng.submit(p, n, GREEDY)))
            snaps.append(eng.metrics.snapshot())
    assert [t for t, _ in outs[0]] == [t for t, _ in outs[1]]
    for (_, a), (_, b) in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert snaps[1]["accepted_tokens"] > 0
    # fewer host reads than tokens: rounds commit several
    assert snaps[1]["host_syncs"] < snaps[0]["host_syncs"]


def test_seeded_stream_independent_of_grid(port_gen):
    """A seeded sampled request under speculative_k: alone, and among
    three other requests (greedy and sampled, some proposing drafts in
    rounds where it proposes none), the same tokens."""
    sp = SamplingOptions(temperature=0.8, top_p=0.95)
    target = [5, 6, 7, 8] * 6
    streams = []
    for others in ([], PROMPTS[1:]):
        with ServingEngine(port_gen, ServingConfig(
                num_slots=4, max_len=128, speculative_k=K,
                kv_block_size=16, block_native_attn=True),
                device="cpu") as eng:
            reqs = [eng.submit(target, 24, sp, seed=11)]
            reqs += [eng.submit(p, 20, GREEDY if i % 2 else sp, seed=i)
                     for i, p in enumerate(others)]
            streams.append(reqs[0].result(timeout=120)[0])
            for r in reqs[1:]:
                r.result(timeout=120)
            snap = eng.metrics.snapshot()
            assert snap["spec_rounds"] > 0
    assert streams[0] == streams[1]
