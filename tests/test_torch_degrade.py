"""The port's brownout ladder and SLO accounting.

- serving/degrade.py against the JAX package's DegradeController: the
  level series, transitions and `describe()` after each `observe` of the
  same seeded traces (hypothesis draws the ladder's shape and the trace).
- ServingConfig's degrade/SLO refusals against JAX's (JAX asserts, the port
  raises ValueError), on the same inputs.
- Each rung on both engines (the port's and the JAX ServingEngine, both
  block-native on the same tiny fp32 weights): rung 1 turns speculation
  off with no token changed, on a repeating prompt where both drafters do
  draft (the reference's own rung-1 test fails on a prompt whose drafter
  never drafts, so its verdict is no oracle here); rung 2's clamps become
  the request's config; rungs 3 and 4 shed.
- Inside the port: rung 1 switched on mid-stream, a burst walking the
  ladder up and back to 0, the level surviving a supervisor restart, and
  the SLO counters and goodput ledger.
"""
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import degrade as jdegrade
from megatron_tpu.serving.scheduler import OverloadShedError as JShed
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.resilience.faults import (FaultInjector,
                                                  use_fault_injector)
from megatron_tpu_torch.serving import (AdmissionError, OverloadShedError,
                                        SamplingOptions, ServingEngine,
                                        invariants)
from megatron_tpu_torch.serving import degrade as tdegrade

torch.set_num_threads(2)
TOL = 1e-4
GREEDY = SamplingOptions(temperature=0.0)
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            num_kv_heads=2, vocab_size=96, seq_length=64,
            max_position_embeddings=64, make_vocab_size_divisible_by=32,
            compute_dtype="float32", attention_impl="flash")
# a huge dwell_down: a level the test forces stays put while the loop
# keeps evaluating
HOLD = dict(degrade_ladder=4, degrade_dwell_down=10**9)
BLOCK = dict(num_slots=2, max_queue=8, max_len=64, kv_block_size=16,
             block_native_attn=True)
# repeats, so the n-gram drafter of both engines proposes drafts
DRAFTING = [5, 6, 7, 8] * 5


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.ModelConfig(**TINY).derived()
    tcfg = tconfig.ModelConfig(**TINY).derived()
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


# ---------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------
@st.composite
def ladders(draw):
    max_level = draw(st.integers(1, 4))
    raise_at = None
    if draw(st.booleans()):
        first = draw(st.floats(0.05, 2.0))
        steps = draw(st.lists(st.floats(0.05, 3.0), min_size=max_level - 1,
                              max_size=max_level - 1))
        raise_at = [first]
        for s in steps:
            raise_at.append(raise_at[-1] + s)
        raise_at = tuple(raise_at)
    return dict(max_level=max_level, raise_at=raise_at,
                hysteresis=draw(st.floats(0.05, 0.95)),
                dwell_up=draw(st.integers(1, 4)),
                dwell_down=draw(st.integers(1, 6)))


@settings(max_examples=60, deadline=None)
@given(ladders(), st.integers(0, 2**31 - 1))
def test_controller_level_series_matches_jax(shape, seed):
    rs = np.random.RandomState(seed)
    ours = tdegrade.DegradeController(**shape)
    ref = jdegrade.DegradeController(**shape)
    slots = int(rs.randint(1, 9))
    # bursts and lulls: runs of one pressure regime
    for _ in range(int(rs.randint(5, 40))):
        q = int(rs.choice([0, 0, 1, slots, 4 * slots, 16 * slots]))
        a = int(rs.randint(0, slots + 1))
        for _ in range(int(rs.randint(1, 8))):
            assert ours.observe(q, a, slots) == ref.observe(q, a, slots)
            assert ours.describe() == ref.describe()
    assert ours.transitions == ref.transitions
    for lvl in range(shape["max_level"] + 1):
        ours.level = ref.level = lvl
        assert ours.spec_disabled() == ref.spec_disabled()
        assert ours.cap_work() == ref.cap_work()
        for pl in (1, 2, 3):
            for p in range(pl):
                assert (ours.shed_priority(p, pl)
                        == ref.shed_priority(p, pl))


CONFIGS = {
    "ok_full": dict(degrade_ladder=4),
    "ok_raise_at": dict(degrade_ladder=2, degrade_raise_at=(0.5, 2.0)),
    "ok_slo": dict(slo_ttft_ms=50.0, slo_itl_p99_ms=20.0),
    "ladder_5": dict(degrade_ladder=5),
    "ladder_neg": dict(degrade_ladder=-1),
    "raise_at_no_ladder": dict(degrade_raise_at=(1.0,)),
    "raise_at_len": dict(degrade_ladder=2, degrade_raise_at=(1.0,)),
    "raise_at_order": dict(degrade_ladder=2, degrade_raise_at=(2.0, 1.0)),
    "raise_at_zero": dict(degrade_ladder=1, degrade_raise_at=(0.0,)),
    "hysteresis": dict(degrade_ladder=1, degrade_hysteresis=1.0),
    "dwell_up": dict(degrade_ladder=1, degrade_dwell_up=0),
    "dwell_down": dict(degrade_ladder=1, degrade_dwell_down=0),
    "max_new": dict(degrade_ladder=2, degrade_max_new_tokens=0),
    "slo_ttft": dict(slo_ttft_ms=0.0),
    "slo_itl": dict(slo_itl_p99_ms=-1.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_refusals_match_jax(name):
    kw = CONFIGS[name]
    try:
        jconfig.ServingConfig(**kw).validate()
        jax_ok = True
    except AssertionError:
        jax_ok = False
    if jax_ok:
        ServingConfig(**kw).validate()
        assert name.startswith("ok_")
    else:
        with pytest.raises(ValueError):
            ServingConfig(**kw).validate()
    c_t = tdegrade.DegradeController.from_config(ServingConfig(**kw)) \
        if jax_ok else None
    c_j = jdegrade.DegradeController.from_config(jconfig.ServingConfig(
        **kw)) if jax_ok else None
    assert (c_t is None) == (c_j is None)
    if c_t is not None:
        assert c_t.describe() == c_j.describe()


# ---------------------------------------------------------------------
# each rung on both engines
# ---------------------------------------------------------------------
def _engines(models, start=True, eos=0, **kw):
    jcfg, params, tcfg, model = models
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=eos, pad_id=0),
                          jconfig.ServingConfig(**kw), start=start)
    teng = ServingEngine(Generator(model, tcfg, eos_id=eos, pad_id=0,
                                   device="cpu"),
                         ServingConfig(**kw), device="cpu", start=start)
    return jeng, teng


def _close(*engines):
    for e in engines:
        e.close()


def test_rung1_spec_off_token_exact_and_reversible(models):
    jeng, teng = _engines(models, **BLOCK, speculative_k=3, **HOLD)
    try:
        got = {}
        for name, eng, sp in (("jax", jeng, JSamplingOptions), ("port", teng,
                                                               SamplingOptions)):
            eng.degrade.level = 1
            degraded = eng.submit(DRAFTING, 12, sp(temperature=0.0)).result(
                timeout=300)
            snap1 = eng.metrics.snapshot()
            eng.degrade.level = 0
            full = eng.submit(DRAFTING, 12, sp(temperature=0.0)).result(
                timeout=300)
            snap2 = eng.metrics.snapshot()
            got[name] = (degraded, full, snap1, snap2)
        (jd, jf, js1, js2), (td, tf, ts1, ts2) = got["jax"], got["port"]
        for (gt, gl), (wt, wl) in ((td, jd), (tf, jf)):
            assert gt == list(wt)
            np.testing.assert_allclose(gl, wl, rtol=TOL, atol=TOL)
        # degraded windows read like a non-speculative engine's
        assert ts1["spec_rounds"] == js1["spec_rounds"] == 0.0
        assert ts1["draft_tokens"] == js1["draft_tokens"] == 0.0
        # back at level 0 both drafters draft on the repeating prompt
        assert ts2["spec_rounds"] == js2["spec_rounds"] >= 1.0
        assert ts2["draft_tokens"] == js2["draft_tokens"] > 0.0
        assert ts2["accepted_tokens"] == js2["accepted_tokens"]
        # the same tokens with speculation on and off
        assert td[0] == tf[0]
    finally:
        _close(jeng, teng)


def test_rung1_switches_mid_stream(models):
    _, _, tcfg, model = models
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**BLOCK, speculative_k=3, **HOLD),
                       device="cpu") as eng:
        want, _ = eng.submit(DRAFTING, 30, GREEDY).result(timeout=300)
        r = eng.submit(DRAFTING, 30, GREEDY)
        while len(r.generated) < 6 and not r.done():
            time.sleep(0.0005)
        eng.degrade.level = 1
        mid = len(r.generated)
        got, _ = r.result(timeout=300)
        assert mid < 30 and got == want
        assert invariants.check_all(eng, requests=[r])["ok"]


def test_rung2_clamps_effective_config(models):
    jeng, teng = _engines(models, eos=-1, **BLOCK, degrade_max_new_tokens=4,
                          **HOLD)
    try:
        outs = {}
        for name, eng, sp in (("jax", jeng, JSamplingOptions),
                              ("port", teng, SamplingOptions)):
            eng.degrade.level = 2
            r = eng.submit([5, 17, 3], 16, sp(temperature=0.0))
            r2 = eng.submit([7, 8, 9], 16, sp(temperature=0.0), n=1,
                            best_of=2)
            assert r.max_new_tokens == 4
            assert getattr(r2, "children", None) is None
            with pytest.raises(Exception) as ei:
                eng.submit([1, 2], 4, sp(temperature=0.0), n=3, best_of=2)
            assert "AdmissionError" in type(ei.value).__name__
            outs[name] = [x.result(timeout=300) for x in (r, r2)]
            snap = eng.metrics.snapshot()
            outs[name].append((snap["requests_received"],
                               snap["requests_rejected"]))
        for (gt, gl), (wt, wl) in zip(outs["port"][:2], outs["jax"][:2]):
            assert gt == list(wt) and len(gt) == 3 + 4
            np.testing.assert_allclose(gl, wl, rtol=TOL, atol=TOL)
        assert outs["port"][2] == outs["jax"][2]
        # the clamped request is the serial run of its effective config
        serial, lens, _ = teng.gen.generate(
            [[5, 17, 3]], 4, SamplingParams(temperature=0.0))
        assert outs["port"][0][0] == serial[0, :lens[0]].tolist()
    finally:
        _close(jeng, teng)


def test_rungs_3_4_shed(models):
    jeng, teng = _engines(models, **BLOCK, priority_levels=2, **HOLD)
    try:
        for eng, sp, shed in ((jeng, JSamplingOptions, JShed),
                              (teng, SamplingOptions, OverloadShedError)):
            eng.degrade.level = 3
            with pytest.raises(shed) as ei:
                eng.submit([1, 2, 3], 4, sp(temperature=0.0), priority=0)
            assert ei.value.retry_after >= 1
            eng.submit([5, 17, 3], 4, sp(temperature=0.0),
                       priority=1).result(timeout=300)
            eng.degrade.level = 4
            for prio in (0, 1):
                with pytest.raises(shed):
                    eng.submit([1, 2, 3], 4, sp(temperature=0.0),
                               priority=prio)
        keys = ("requests_received", "requests_rejected", "requests_shed",
                "requests_completed")
        js, ts = jeng.metrics.snapshot(), teng.metrics.snapshot()
        assert [ts[k] for k in keys] == [js[k] for k in keys] == [
            4.0, 3.0, 3.0, 1.0]
        h = teng.health()
        assert h["degrade_level"] == 4
        assert h["degrade"] == jeng.health()["degrade"]
    finally:
        _close(jeng, teng)


# ---------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_gen(models):
    _, _, tcfg, model = models
    return Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu")


def test_ladder_walks_up_and_back_under_load(port_gen):
    with ServingEngine(port_gen, ServingConfig(
            num_slots=2, max_queue=32, max_len=64, degrade_ladder=4,
            degrade_raise_at=(0.25, 0.5, 1.0, 2.0), degrade_dwell_up=1,
            degrade_dwell_down=2), device="cpu") as eng:
        eng.generate([9, 9], 2, GREEDY)
        reqs = [eng.submit([1 + i, 2, 3], 24, GREEDY) for i in range(10)]
        peak = 0
        while any(not r.done() for r in reqs):
            peak = max(peak, eng.health()["degrade_level"])
            time.sleep(0.001)
        give_up = time.monotonic() + 30
        while eng.health()["degrade_level"] and time.monotonic() < give_up:
            time.sleep(0.01)
        snap = eng.metrics.snapshot()
        assert peak >= 1
        assert eng.health()["degrade_level"] == 0
        assert snap["degrade_level"] == 0.0
        assert snap["degrade_transitions"] >= 2
        assert snap["degrade_transitions"] % 2 == 0
        assert invariants.check_all(eng, requests=reqs)["ok"]


def test_level_survives_restart(port_gen):
    with ServingEngine(port_gen, ServingConfig(
            num_slots=1, max_queue=8, max_len=64, max_engine_restarts=2,
            degrade_max_new_tokens=4, **HOLD), device="cpu") as eng:
        eng.generate([9, 9], 2, GREEDY)
        eng.degrade.level = 2
        eng.metrics.set_degrade_gauge(2)
        with use_fault_injector(FaultInjector(serve_crash_calls={1})):
            victim = eng.submit([1, 2, 3], 6, GREEDY)
            with pytest.raises(RuntimeError, match="engine step"):
                victim.result(timeout=120)
            after = eng.submit([4, 5, 6], 16, GREEDY)
            toks, _ = after.result(timeout=120)
        assert eng.metrics.snapshot()["engine_restarts"] == 1
        assert eng.health()["degrade_level"] == 2
        # still rung 2 after the restart: the clamp applies
        assert after.max_new_tokens == 4 and len(toks) == 3 + 4
        assert invariants.check_all(eng, requests=[victim, after])["ok"]


def test_slo_counters_and_goodput(port_gen):
    with ServingEngine(port_gen, ServingConfig(
            num_slots=2, max_queue=8, max_len=64, slo_ttft_ms=1e-4,
            slo_itl_p99_ms=1e-4), device="cpu") as eng:
        for r in [eng.submit([5 + i, 17, 3], 8, GREEDY) for i in range(3)]:
            r.result(timeout=120)
        snap = eng.metrics.snapshot()
        assert snap["slo_ttft_violations"] >= 3.0
        assert snap["slo_itl_violations"] >= 1.0
        assert snap["tokens_generated"] >= 24.0
        assert snap["goodput_tokens"] == 0.0
    with ServingEngine(port_gen, ServingConfig(
            num_slots=2, max_queue=8, max_len=64), device="cpu") as eng:
        assert eng.degrade is None
        h = eng.health()
        assert h["degrade_level"] == 0 and h["degrade"] is None
        eng.submit([5, 17, 3], 8, GREEDY).result(timeout=120)
        snap = eng.metrics.snapshot()
        assert snap["slo_ttft_violations"] == 0.0
        assert snap["goodput_tokens"] == snap["tokens_generated"] > 0
        with pytest.raises(AdmissionError):
            eng.submit([1, 2], 4, GREEDY, n=3)
