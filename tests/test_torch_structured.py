"""The port's structured output and n-best fan-out.

- serving/structured.py against the JAX package's: the TokenFSM tables
  (`mask_table`, `next_table`, `accepting`) and `max_path_len` bit for bit
  over a pool of regex and JSON-schema grammars, and the same
  GrammarCompileError messages for malformed, unsupported and
  unsatisfiable ones.
- `sample_batched(mask=)` and `verify_draft_probs(mask=)` against JAX's
  (greedy rows, dead rows, dead positions), all-True rows bit-identical to
  no mask, and a masked step that reads nothing back to the host.
- The port's engine against the JAX ServingEngine (both block-native, the
  JAX block kernel in Pallas interpret mode) on the same tiny fp32 model:
  constrained greedy tokens exact and logprobs within 1e-4, speculation
  off and on, an fp32 and an int8 pool, with equal `mask_uploads`.
- Inside the port: a preempted constrained request resumes its FSM state
  (the same stream as unpreempted), a grammar dead end fails typed and
  answers 422 over real HTTP, and a fan-out's samples equal their serially
  seeded twins with one real prefill, best-first order and block
  refcounts back to baseline; a fan-out stream is sample-major under one
  global frame id and resumes from Last-Event-ID.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import sampling as jsampling
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import structured as jstructured
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference import sampling as tsampling
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import (AdmissionError, EngineRouter,
                                        FanoutRequest, GrammarDeadEndError,
                                        SamplingOptions, ServingEngine,
                                        invariants)
from megatron_tpu_torch.serving import structured as tstructured

torch.set_num_threads(2)
TOL = 1e-4
GREEDY = SamplingOptions(temperature=0.0)
PROMPT = [5, 17, 3, 42]
REGEX_RF = {"type": "regex", "pattern": "[0-9]{2,6}"}
SCHEMA_RF = {"type": "json_schema",
             "schema": {"type": "object",
                        "properties": {
                            "id": {"type": "integer", "minimum": 0,
                                   "maxDigits": 2},
                            "ok": {"type": "boolean"}}}}
# vocab 128: the byte-level identity tokens cover digits, letters and the
# JSON structural characters
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            num_kv_heads=2, vocab_size=128, seq_length=64,
            max_position_embeddings=64, make_vocab_size_divisible_by=64,
            compute_dtype="float32", attention_impl="flash")


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.ModelConfig(**TINY).derived()
    tcfg = tconfig.ModelConfig(**TINY).derived()
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def port_gen(models):
    _, _, tcfg, model = models
    return Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


# ---------------------------------------------------------------------
# the grammar compiler
# ---------------------------------------------------------------------
GRAMMARS = {
    "digits": REGEX_RF,
    "self_loop": {"type": "regex", "pattern": "A*"},
    "alternation": {"type": "regex", "pattern": "(yes|no|maybe)!?"},
    "classes": {"type": "regex", "pattern": "[a-c]+[^a-z]?x{1,3}"},
    "escapes": {"type": "regex", "pattern": "\\d\\.\\d+(e-?\\d)?"},
    "schema_object": SCHEMA_RF,
    "schema_nested": {"type": "json_schema", "schema": {
        "type": "object", "properties": {
            "tags": {"type": "array", "items": {"enum": ["a", "b"]},
                     "maxItems": 2},
            "name": {"type": "string", "maxLength": 3},
            "v": {"const": None}}}},
    "schema_number": {"type": "json_schema",
                      "schema": {"type": "number"}},
}


@pytest.mark.parametrize("name", sorted(GRAMMARS))
@pytest.mark.parametrize("vocab,eos", [(128, None), (128, 0), (300, 299)])
def test_fsm_tables_match_jax(name, vocab, eos):
    rf = GRAMMARS[name]
    try:
        want = jstructured.compile_response_format(rf, vocab, eos_id=eos)
    except jstructured.GrammarCompileError as e:
        with pytest.raises(tstructured.GrammarCompileError) as got:
            tstructured.compile_response_format(rf, vocab, eos_id=eos)
        assert str(got.value) == str(e)
        return
    got = tstructured.compile_response_format(rf, vocab, eos_id=eos)
    np.testing.assert_array_equal(got.mask_table, want.mask_table)
    np.testing.assert_array_equal(got.next_table, want.next_table)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    assert got.mask_table.dtype == want.mask_table.dtype
    assert got.next_table.dtype == want.next_table.dtype
    assert got.max_path_len == want.max_path_len
    for s in range(got.mask_table.shape[0]):
        assert got.is_terminal(s) == want.is_terminal(s)


REFUSED = {
    "unbalanced": {"type": "regex", "pattern": "("},
    "dangling_star": {"type": "regex", "pattern": "*a"},
    "bad_class": {"type": "regex", "pattern": "[z-a]"},
    "unsatisfiable": {"type": "regex", "pattern": "a{3,1}"},
    "untokenizable": {"type": "regex", "pattern": "é+"},
    "schema_unsupported": {"type": "json_schema",
                           "schema": {"type": "object",
                                      "patternProperties": {}}},
    "schema_anyof": {"type": "json_schema",
                     "schema": {"anyOf": [{"type": "integer"}]}},
    "bad_type": {"type": "xml"},
    "not_a_dict": "regex",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_grammar_refusals_match_jax(name):
    rf = REFUSED[name]
    assert (tstructured.validate_response_format(rf)
            == jstructured.validate_response_format(rf))
    with pytest.raises(jstructured.GrammarCompileError) as want:
        jstructured.compile_response_format(rf, 128)
    with pytest.raises(tstructured.GrammarCompileError) as got:
        tstructured.compile_response_format(rf, 128)
    assert str(got.value) == str(want.value)


def test_token_strings_and_replay_match_jax():
    # multi-character pieces: the composition walks each piece's chars
    strings = [chr(i) for i in range(128)] + ["12", "{\"", "ab", "true"]
    for rf in (REGEX_RF, SCHEMA_RF, GRAMMARS["alternation"]):
        want = jstructured.compile_response_format(
            rf, len(strings), token_strings=strings, eos_id=0)
        got = tstructured.compile_response_format(
            rf, len(strings), token_strings=strings, eos_id=0)
        np.testing.assert_array_equal(got.mask_table, want.mask_table)
        np.testing.assert_array_equal(got.next_table, want.next_table)
        rs = np.random.RandomState(0)
        for _ in range(20):
            toks = list(rs.randint(0, len(strings), rs.randint(1, 8)))
            assert got.replay(toks) == want.replay(toks)
            assert got.final_text_valid(toks) == want.final_text_valid(toks)


# ---------------------------------------------------------------------
# the sampler's mask seam
# ---------------------------------------------------------------------
def _mask_inputs(b=5, V=40, vocab=37, seed=0):
    rs = np.random.RandomState(seed)
    logits = 3 * rs.standard_normal((b, V)).astype(np.float32)
    mask = rs.rand(b, V) < 0.4
    mask[1] = True            # an all-True row
    mask[3] = False           # a dead row
    return logits, mask, vocab


def test_sample_batched_greedy_mask_matches_jax():
    logits, mask, vocab = _mask_inputs()
    b = logits.shape[0]
    temps = np.zeros(b, np.float32)
    want = jsampling.sample_batched(
        jnp.zeros((b, 2), jnp.uint32), jnp.asarray(logits),
        temperature=jnp.asarray(temps), top_k=jnp.zeros(b, jnp.int32),
        top_p=jnp.zeros(b, jnp.float32), vocab_size=vocab,
        mask=jnp.asarray(mask))
    got = tsampling.sample_batched(
        [None] * b, torch.from_numpy(logits),
        temperature=torch.from_numpy(temps), top_k=None, top_p=None,
        vocab_size=vocab, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[3]) == -1


def test_sample_batched_mask_rows():
    """Drawing rows: an all-True row draws the same token as with no
    mask from the same generator state, a dead row returns -1, and every
    drawn token is legal."""
    logits, mask, vocab = _mask_inputs()
    b = logits.shape[0]
    temps = torch.full((b,), 0.9)
    gens_a = [torch.Generator().manual_seed(i) for i in range(b)]
    gens_b = [torch.Generator().manual_seed(i) for i in range(b)]
    got = tsampling.sample_batched(
        gens_a, torch.from_numpy(logits), temperature=temps, top_k=None,
        top_p=None, vocab_size=vocab, mask=torch.from_numpy(mask))
    free = tsampling.sample_batched(
        gens_b, torch.from_numpy(logits), temperature=temps, top_k=None,
        top_p=None, vocab_size=vocab)
    assert int(got[1]) == int(free[1])
    assert int(got[3]) == -1
    for i in (0, 2, 4):
        assert mask[i, int(got[i])]
    # all-True everywhere: bit-identical to no mask, row for row
    gens_c = [torch.Generator().manual_seed(i) for i in range(b)]
    gens_d = [torch.Generator().manual_seed(i) for i in range(b)]
    ones = torch.ones(b, logits.shape[1], dtype=torch.bool)
    a = tsampling.sample_batched(gens_c, torch.from_numpy(logits),
                                 temperature=temps, top_k=None, top_p=None,
                                 vocab_size=vocab, mask=ones)
    c = tsampling.sample_batched(gens_d, torch.from_numpy(logits),
                                 temperature=temps, top_k=None, top_p=None,
                                 vocab_size=vocab)
    assert torch.equal(a, c)


def test_masked_step_reads_nothing_back(monkeypatch):
    """The engine passes its mask buffer on every step: a step with it
    must not read a tensor back to the host (no __bool__, item, tolist)."""
    logits, mask, vocab = _mask_inputs()
    b = logits.shape[0]
    args = dict(temperature=torch.full((b,), 0.9), top_k=None, top_p=None,
                vocab_size=vocab, mask=torch.ones(b, logits.shape[1],
                                                  dtype=torch.bool))
    gens = [torch.Generator().manual_seed(i) for i in range(b)]
    gens[0] = None  # a greedy row beside the drawing ones

    def no_read(*a, **k):
        raise AssertionError("host read in the masked sampling step")

    for name in ("__bool__", "item", "tolist", "numpy", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    tsampling.sample_batched(gens, torch.from_numpy(logits), **args)
    args["mask"] = torch.from_numpy(mask)
    tsampling.sample_batched(gens, torch.from_numpy(logits), **args)


def test_verify_draft_probs_mask_matches_jax():
    rs = np.random.RandomState(4)
    b, w, V, vocab = 4, 3, 40, 37
    logits = 3 * rs.standard_normal((b, w, V)).astype(np.float32)
    drafts = rs.randint(0, vocab, (b, w)).astype(np.int32)
    mask = rs.rand(b, w, V) < 0.5
    mask[0] = True                    # a free row
    mask[2, 1] = False                # a dead position
    for i in range(b):                # some drafts legal, some not
        mask[i, 0, drafts[i, 0]] = True
    mask[3, 2, drafts[3, 2]] = False
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    ks = np.array([0, 5, 0, 0], np.int32)
    ps = np.array([0.0, 0.9, 0.0, 0.0], np.float32)
    want_p, want_t = jsampling.verify_draft_probs(
        jnp.asarray(logits), jnp.asarray(drafts),
        temperature=jnp.asarray(temps), top_k=jnp.asarray(ks),
        top_p=jnp.asarray(ps), vocab_size=vocab, mask=jnp.asarray(mask))
    got_p, got_t = tsampling.verify_draft_probs(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        temperature=torch.from_numpy(temps), top_k=torch.from_numpy(ks),
        top_p=torch.from_numpy(ps), vocab_size=vocab,
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert int(got_t[2, 1]) == -1 and float(got_p[3, 2]) == 0.0
    # an all-True mask is bit-identical to none
    nomask_p, nomask_t = tsampling.verify_draft_probs(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        temperature=torch.from_numpy(temps), top_k=torch.from_numpy(ks),
        top_p=torch.from_numpy(ps), vocab_size=vocab)
    ones_p, ones_t = tsampling.verify_draft_probs(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        temperature=torch.from_numpy(temps), top_k=torch.from_numpy(ks),
        top_p=torch.from_numpy(ps), vocab_size=vocab,
        mask=torch.ones(b, w, V, dtype=torch.bool))
    assert torch.equal(ones_p, nomask_p) and torch.equal(ones_t, nomask_t)


# ---------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------
# digits repeated: the n-gram drafter proposes digit continuations, legal
# under the digit grammars, so verify rounds carry masked drafts
DIGIT_PROMPT = [ord(c) for c in "1212121212"]
CASES = [(DIGIT_PROMPT, {"type": "regex", "pattern": "[0-9]{6,10}"}, 10),
         (PROMPT, REGEX_RF, 6),
         (PROMPT, SCHEMA_RF, 24),
         ([7, 8, 9], None, 8)]   # free traffic on the same grid


@pytest.mark.parametrize("kv_dtype,spec", [("float32", 0), ("float32", 3),
                                           ("int8", 0), ("int8", 3)])
def test_constrained_engine_matches_jax_engine(models, kv_dtype, spec):
    jcfg, params, tcfg, model = models
    kw = dict(num_slots=4, max_queue=16, max_len=64, kv_block_size=16,
              block_native_attn=True, kv_dtype=kv_dtype, speculative_k=spec)
    # start=False, submit all, then start: both engines admit the same
    # requests in the same iterations, so their windows (and mask uploads)
    # line up
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=-1, pad_id=0),
                          jconfig.ServingConfig(**kw), start=False)
    try:
        reqs = [jeng.submit(p, n, JSamplingOptions(temperature=0.0),
                            response_format=rf) for p, rf, n in CASES]
        jeng._thread.start()
        want = [r.result(timeout=600) for r in reqs]
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**kw), device="cpu",
                       start=False) as eng:
        reqs = [eng.submit(p, n, GREEDY, response_format=rf)
                for p, rf, n in CASES]
        eng._thread.start()
        got = [r.result(timeout=600) for r in reqs]
        snap = eng.metrics.snapshot()
        report = invariants.check_all(eng, requests=reqs)
    for (p, rf, _), (gt, gl), (wt, wl) in zip(CASES, got, want):
        assert gt == list(wt), (rf, gt, wt)
        np.testing.assert_allclose(gl, wl, rtol=TOL, atol=TOL)
        if rf is not None:
            fsm = tstructured.compile_response_format(rf, tcfg.vocab_size,
                                                      eos_id=-1)
            assert fsm.replay(gt[len(p):])[0]
    for key in ("mask_uploads", "structured_requests", "grammar_dead_ends",
                "spec_rounds", "draft_tokens", "accepted_tokens"):
        assert snap[key] == jsnap[key], key
    assert snap["structured_requests"] == 3
    if spec:
        assert snap["spec_rounds"] > 0 and snap["draft_tokens"] > 0
    assert report["ok"] and report["grammar"]["checked"] == 3


# ---------------------------------------------------------------------
# inside the port: preemption, dead ends, fan-out
# ---------------------------------------------------------------------
def test_preempted_constrained_request_resumes_fsm(port_gen):
    rf = {"type": "regex", "pattern": "[0-9]{8,12}"}
    sp = SamplingOptions(temperature=0.9)
    base = dict(num_slots=1, max_queue=16, max_len=64, kv_block_size=16,
                block_native_attn=True, priority_levels=2, preemption=True)
    with ServingEngine(port_gen, ServingConfig(**base),
                       device="cpu") as eng:
        want, _ = eng.submit(PROMPT, 12, sp, seed=9,
                             response_format=rf).result(timeout=120)
        victim = eng.submit(PROMPT, 12, sp, seed=9, response_format=rf)
        t0 = time.monotonic()
        while len(victim.generated) < 2 and not victim.done():
            time.sleep(0.001)
            assert time.monotonic() - t0 < 60
        hp = eng.submit([7, 8, 9], 4, sp, seed=11, priority=1)
        hp.result(timeout=120)
        got, _ = victim.result(timeout=120)
        assert victim.preemptions >= 1
        # a second victim whose parked KV is dropped replays its prompt
        # plus generated tokens, the FSM state riding on the request
        victim2 = eng.submit(PROMPT, 12, sp, seed=9, response_format=rf)
        while len(victim2.generated) < 2 and not victim2.done():
            time.sleep(0.001)
        hp2 = eng.submit([7, 8, 9], 4, sp, seed=11, priority=1)
        while victim2.preemptions == 0 and not victim2.done():
            time.sleep(0.001)
        eng.scheduler.clear_parked()
        hp2.result(timeout=120)
        got2, _ = victim2.result(timeout=120)
        report = invariants.check_all(eng, requests=[victim, victim2, hp])
    assert got == want and got2 == want
    fsm = victim.fsm
    assert fsm.replay(got[len(PROMPT):])[0]
    assert report["ok"]


class CharTokenizer:
    vocab_size = 128
    eod = 0
    bos = 1

    def tokenize(self, text):
        return [ord(c) % 128 for c in text]

    def detokenize(self, ids):
        return "".join(chr(i) for i in ids if 0 <= i < 128)


def _put(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_dead_end_is_422_over_http_and_fanout_shapes(port_gen):
    server = MegatronServer(port_gen, CharTokenizer(), serving=ServingConfig(
        num_slots=4, max_queue=8, max_len=64, kv_block_size=16,
        block_native_attn=True, enable_prefix_cache=True), device="cpu")
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        # the dead end: top_p keeps only the unconstrained argmax and the
        # grammar bans exactly that token
        status, body = _put(port, {"prompts": ["hi"], "temperature": 0.0,
                                   "tokens_to_generate": 1})
        g = body["segments"][0][-1]
        lone = "A" if g != ord("A") else "B"
        status, body = _put(port, {
            "prompts": ["hi"], "tokens_to_generate": 4, "temperature": 1.0,
            "top_p": 1e-6, "random_seed": 1,
            "response_format": {"type": "regex", "pattern": lone}})
        # the processed distribution is empty: the draw is illegal and the
        # request fails typed, as the reference's does (422, not a 500)
        assert status == 422, body
        assert "grammar" in body["message"]
        # a constrained JSON completion parses
        status, body = _put(port, {
            "prompts": ["hi"], "tokens_to_generate": 32,
            "temperature": 0.0, "response_format": SCHEMA_RF})
        assert status == 200
        obj = json.loads(body["text"][0][2:])
        assert set(obj) == {"id", "ok"}
        # fan-out: per-prompt lists of n completions
        status, body = _put(port, {
            "prompts": ["hi", "yo"], "tokens_to_generate": 4,
            "temperature": 0.9, "random_seed": 3, "n": 2, "best_of": 3,
            "logprobs": True})
        assert status == 200, body
        assert [len(t) for t in body["text"]] == [2, 2]
        assert all(len(s) == 2 for s in body["segments"])
        for segs, lps in zip(body["segments"], body["logprobs"]):
            for seg, lp in zip(segs, lps):
                assert len(seg) == len(lp)
        # the serial route refuses both, as the reference does
        for extra in ({"n": 2}, {"response_format": REGEX_RF}):
            status, body = _put(port, dict({"prompts": ["hi"],
                                            "serial": True}, **extra))
            assert status == 400 and "serving-engine path" in body[
                "message"]
        # a 422 and the rest leave the engine's invariants whole
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/invariants?strict=1",
                timeout=30) as resp:
            report = json.loads(resp.read())
        assert report["ok"], report
        assert server.engine.metrics.snapshot()["grammar_dead_ends"] == 1.0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.close()


# not a multiple of the 16-token block: a whole-prompt hit caps at
# plen - 1, so a block-aligned prompt would alias no whole block
FPROMPT = [1 + (i * 7) % 90 for i in range(24)]


def test_fanout_one_prefill_seeding_and_refcounts(port_gen):
    sp = SamplingOptions(temperature=0.8)
    with ServingEngine(port_gen, ServingConfig(
            num_slots=4, max_queue=32, max_len=64, kv_block_size=16,
            block_native_attn=True, enable_prefix_cache=True,
            retained_slots=0), device="cpu") as eng:
        eng.generate([3, 4, 5], 2, GREEDY)
        baseline = (eng.pool.shared_block_count(),
                    int(eng.pool.accounting()["rc"].sum()))
        snap0 = eng.metrics.snapshot()
        agg = eng.submit(FPROMPT, 6, sp, seed=5, n=4, best_of=4)
        assert isinstance(agg, FanoutRequest) and agg.n == 4
        toks_list, lps_list = agg.result(timeout=120)
        d = {k: int(v - snap0[k])
             for k, v in eng.metrics.snapshot().items() if k in snap0}
        assert d["fanout_requests"] == 1 and d["fanout_samples"] == 4
        assert d["requests_received"] == 4
        # one real prefill: the siblings alias the leader's whole block
        assert d["prefix_hits"] == 3
        assert d["prefill_tokens_saved"] == 3 * 16
        assert d["prefill_forward_tokens"] == len(FPROMPT) + 3 * 8
        # each sample equals its serially seeded twin (seed + i)
        for i, c in enumerate(agg.children):
            assert c.seed == 5 + i
            want, lens, _ = port_gen.generate(
                [FPROMPT], 6, SamplingParams(temperature=0.8), seed=5 + i)
            assert c.prompt + c.generated == want[0, :lens[0]].tolist()
        # best first by summed logprob, ties on the sample index
        ranked = sorted(((c.sample_index, c.prompt + c.generated,
                          c.gen_logprobs) for c in agg.children),
                        key=lambda t: (-sum(t[2]), t[0]))
        assert toks_list == [t[1] for t in ranked]
        assert lps_list == [t[2] for t in ranked]
        # n of best_of: the n best of all samples
        agg2 = eng.submit(FPROMPT, 4, sp, seed=40, n=2, best_of=4)
        t2, l2 = agg2.result(timeout=120)
        assert sorted(-sum(lp) for lp in l2) == sorted(
            -sum(c.gen_logprobs) for c in agg2.children)[:2]
        with pytest.raises(AdmissionError, match="exceeds"):
            eng.submit(FPROMPT, 2, sp, n=5, best_of=5)
        with pytest.raises(AdmissionError, match="n <= best_of"):
            eng.submit(FPROMPT, 2, sp, n=3, best_of=2)
        # a structured fan-out shares one FSM compile
        agg3 = eng.submit(FPROMPT, 6, SamplingOptions(temperature=0.9),
                          seed=60, n=2, best_of=2, response_format=REGEX_RF)
        agg3.result(timeout=120)
        assert agg3.children[0].fsm is agg3.children[1].fsm
        report = invariants.check_all(eng, requests=[agg, agg2, agg3])
        assert report["ok"] and report["grammar"]["checked"] == 2
        t0 = time.monotonic()
        while (eng.pool.shared_block_count(),
               int(eng.pool.accounting()["rc"].sum())) != baseline:
            time.sleep(0.01)
            assert time.monotonic() - t0 < 30


def test_router_refuses_fanout_and_carries_grammar(port_gen):
    engines = [ServingEngine(port_gen, ServingConfig(
        num_slots=2, max_len=64, kv_block_size=16, block_native_attn=True),
        device="cpu") for _ in range(2)]
    router = EngineRouter(engines)
    try:
        with pytest.raises(AdmissionError, match="parallel sampling"):
            router.submit(PROMPT, 4, GREEDY, n=2)
        r = router.submit(PROMPT, 6, GREEDY, response_format=REGEX_RF)
        toks, _ = r.result(timeout=120)
        want, _ = engines[0].submit(PROMPT, 6, GREEDY,
                                    response_format=REGEX_RF).result(120)
        assert toks == want
        assert invariants.check_all(router, requests=[r])["ok"]
    finally:
        router.close()


def _sse_events(port, payload, headers=None):
    """Every SSE frame of one streamed PUT as (event, id, data)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers=dict({"Content-Type": "application/json"},
                                   **(headers or {})))
    frames, fields = [], {}
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if not line:
                if fields:
                    frames.append((fields.get("event"), fields.get("id"),
                                   json.loads(fields["data"])))
                fields = {}
                continue
            k, _, v = line.partition(": ")
            fields[k] = v
    return frames


def test_fanout_stream_is_sample_major_and_resumes(port_gen):
    server = MegatronServer(port_gen, CharTokenizer(), serving=ServingConfig(
        num_slots=4, max_queue=8, max_len=64, kv_block_size=16,
        block_native_attn=True, enable_prefix_cache=True), device="cpu")
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    payload = {"prompts": ["stream me"], "stream": True, "n": 2,
               "best_of": 2, "tokens_to_generate": 5, "temperature": 0.9,
               "random_seed": 4, "response_format": REGEX_RF}
    try:
        status, body = _put(port, dict(payload, best_of=3))
        assert status == 400 and "n == best_of" in body["message"]
        frames = _sse_events(port, payload)
        start, tokens, done = frames[0], frames[1:-1], frames[-1]
        assert start[0] == "start" and start[2]["n"] == 2
        assert [int(f[1]) for f in tokens] == list(range(len(tokens)))
        samples = [f[2]["sample"] for f in tokens]
        assert samples == sorted(samples) and set(samples) == {0, 1}
        assert done[0] == "done" and done[2]["completed"] == 2
        # every sample's tokens are its seeded engine twin's (seed + i),
        # and grammar-legal
        fsm = tstructured.compile_response_format(REGEX_RF, 128, eos_id=-1)
        for k in (0, 1):
            toks = [f[2]["token"] for f in tokens if f[2]["sample"] == k]
            assert fsm.replay(toks)[0]
            want, _ = server.engine.submit(
                CharTokenizer().tokenize("stream me"), 5,
                SamplingOptions(temperature=0.9), seed=4 + k,
                response_format=REGEX_RF).result(timeout=60)
            assert toks == want[len("stream me"):]
        # a resume replays exactly the frames after Last-Event-ID
        sid = start[2]["stream_id"]
        cut = len(tokens) // 2
        again = _sse_events(port, {"stream": True, "stream_id": sid},
                            headers={"Last-Event-ID": str(cut)})
        assert again[0][2]["resumed"] is True
        assert [f[1:] for f in again[1:-1]] == [f[1:] for f in
                                                tokens[cut + 1:]]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.close()
