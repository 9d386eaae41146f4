"""The port's engine supervisor: restarts, the circuit breaker, the
hung-iteration watchdog and the serving fault points
(serving/engine.py), against the JAX package's engine.

- The reference's TestEngineSupervisor cases (tests/test_serving.py), on
  the port: a crashed step restarts the loop, fails its slotted request
  and serves the queued one token for token as the serial route; a crash
  loop opens the breaker (slotted fail, queued 503, submit raises
  EngineUnhealthyError); a stalled iteration is failed by the watchdog
  during the stall and the engine serves again; a NaN-poisoned slot fails
  one request, not the engine; restarts age out after RESTART_DECAY_S;
  the watchdog fails requests caught mid-admission; a re-admitted request
  records its queue wait once.
- Under one fault schedule (crashes and a NaN slot), the port's engine
  and the JAX engine give every request the same outcome (served with the
  same greedy tokens, or failed with the same error type), the same
  restart count and the same breaker state.
- A restart rebuilds the pool as new tensors and keeps none of the old.

Each test closes every engine it starts (which stops its watchdog) and
deactivates the global injector.
"""
import time

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.resilience import FaultInjector as JFaultInjector
from megatron_tpu.resilience import use_fault_injector as j_use
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.resilience import (FaultInjector, deactivate,
                                           use_fault_injector)
from megatron_tpu_torch.serving import (EngineUnhealthyError,
                                        RequestFailedError, SamplingOptions,
                                        ServiceUnavailableError,
                                        ServingEngine)
from megatron_tpu_torch.serving.engine import EngineHungError

torch.set_num_threads(2)
KW = dict(attention_impl="flash", compute_dtype="float32")


@pytest.fixture(autouse=True)
def _no_leftover_injector():
    yield
    deactivate()


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.llama2_config("tiny", **KW)
    tcfg = tconfig.llama2_config("tiny", **KW)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def gen(models):
    _, _, tcfg, model = models
    return Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


def _engine(gen, start=True, **kw):
    return ServingEngine(gen, ServingConfig(max_queue=8, max_len=64, **kw),
                         device="cpu", start=start)


def _serial(gen, prompt, n, sampling, seed):
    toks, lens, _ = gen.generate([prompt], n, sampling=sampling, seed=seed)
    return toks[0, :lens[0]].tolist()


def test_step_crash_restarts_and_serves_queued(gen):
    sampling = SamplingOptions(temperature=0.9, top_k=5)
    with _engine(gen, num_slots=1, max_engine_restarts=2) as eng:
        eng.generate([9, 9], 2, sampling, seed=0)  # a full iteration first
        with use_fault_injector(FaultInjector(serve_crash_calls={1})):
            victim = eng.submit([1, 2, 3], 6, sampling, seed=1)
            queued = eng.submit([4, 5], 4, sampling, seed=2)
            with pytest.raises(RequestFailedError, match="engine step"):
                victim.result(timeout=120)
            toks, _ = queued.result(timeout=120)
        snap = eng.metrics.snapshot()
        health = eng.health()
        assert snap["engine_restarts"] == 1
        assert health["healthy"] and health["state"] == "running"
        assert health["engine_restarts"] == 1
    assert toks == _serial(gen, [4, 5], 4,
                           SamplingParams(temperature=0.9, top_k=5), 2)


def test_crash_loop_trips_breaker_and_503s(gen):
    sampling = SamplingOptions(temperature=0.8)
    eng = _engine(gen, num_slots=1, max_engine_restarts=0)
    try:
        eng.generate([9, 9], 2, sampling, seed=0)
        with use_fault_injector(FaultInjector(
                serve_crash_calls=set(range(1, 32)))):
            slotted = eng.submit([1, 2], 4, sampling, seed=1)
            queued = eng.submit([3, 4], 4, sampling, seed=2)
            with pytest.raises(RequestFailedError):
                slotted.result(timeout=120)
            with pytest.raises(ServiceUnavailableError):
                queued.result(timeout=120)
        health = eng.health()
        assert health["circuit_breaker_open"]
        assert not health["healthy"]
        assert health["state"] == "unhealthy"
        assert eng.metrics.snapshot()["engine_restarts"] == 0
        with pytest.raises(EngineUnhealthyError):
            eng.submit([5], 2, sampling, seed=3)
    finally:
        eng.close()


def test_hung_iteration_watchdog_restart(gen):
    sampling = SamplingOptions(temperature=0.8)
    with _engine(gen, num_slots=1, engine_step_timeout_s=0.6,
                 max_engine_restarts=2) as eng:
        # the first full iteration arms the watchdog
        eng.generate([9, 9], 2, sampling, seed=0)
        assert eng._watchdog.started
        with use_fault_injector(FaultInjector(serve_delay_calls={1: 1.5})):
            victim = eng.submit([1, 2], 8, sampling, seed=1)
            t0 = time.monotonic()
            with pytest.raises(RequestFailedError, match="hung"):
                victim.result(timeout=120)
            # failed by the watchdog during the stall, not after it
            assert time.monotonic() - t0 < 1.5
            probe = eng.submit([3, 4], 2, sampling, seed=2)
            probe.result(timeout=120)
        snap = eng.metrics.snapshot()
        health = eng.health()
        assert snap["engine_restarts"] >= 1
        assert health["healthy"] and health["state"] == "running"
    assert not eng._watchdog._thread.is_alive()


def test_nonfinite_guard_fails_only_poisoned_slot(gen):
    sampling = SamplingOptions(temperature=0.9, top_k=5)
    eng = _engine(gen, start=False, num_slots=2)
    try:
        ok_req = eng.submit([5, 17, 3], 5, sampling, seed=1)
        poisoned = eng.submit([7, 8, 9], 5, sampling, seed=2)
        eng._admit()  # one batched prefill: slots 0 and 1
        with use_fault_injector(FaultInjector(serve_nan_calls={2: 1})):
            eng._step()  # both decode token 1
            assert len(poisoned.generated) == 1
            eng._step()  # slot 1's carried logits poisoned
        assert poisoned.done()
        with pytest.raises(RequestFailedError, match="non-finite"):
            poisoned.result(timeout=1)
        assert eng.pool.free_count() == 1  # the poisoned slot is free
        assert not ok_req.done()  # the grid keeps decoding
        while not ok_req.done():
            eng._step()
        toks, _ = ok_req.result(timeout=1)
        snap = eng.metrics.snapshot()
        assert snap["nonfinite_logit_fails"] == 1
        assert snap["engine_restarts"] == 0  # a request died, not the engine
    finally:
        eng.close()
    assert toks == _serial(gen, [5, 17, 3], 5,
                           SamplingParams(temperature=0.9, top_k=5), 1)


def test_restart_budget_decays_after_healthy_period(gen):
    eng = _engine(gen, start=False, num_slots=1)
    try:
        eng._restarts, eng._last_restart_t = 2, time.monotonic()
        eng._maybe_decay_restarts()
        assert eng._restarts == 2  # recent: still counts
        eng._last_restart_t = time.monotonic() - eng.RESTART_DECAY_S - 1.0
        eng._maybe_decay_restarts()
        assert eng._restarts == 0 and eng._last_restart_t is None
    finally:
        eng.close()


def test_watchdog_covers_mid_admit_pops(gen):
    """A wedge inside a group prefill leaves its requests in no slot yet:
    _on_hang still fails them, through the _admitting list."""
    eng = _engine(gen, start=False, num_slots=2, engine_step_timeout_s=30.0)
    try:
        r = eng.submit([1, 2, 3], 4)
        orig, seen = eng._prefill_group, {}

        def wedged(*a):
            eng._on_hang()  # the watchdog fires while this call runs
            seen["resolved_during_wedge"] = r.done()
            return orig(*a)

        eng._prefill_group = wedged
        eng._admit()
        assert seen["resolved_during_wedge"] is True
        with pytest.raises(RequestFailedError, match="hung"):
            r.result(timeout=1)
        assert eng._admitting == []
        assert eng.health()["state"] == "wedged"
        with pytest.raises(EngineHungError):
            eng._session()
    finally:
        eng.close()


def test_requeued_group_admission_records_wait_once(gen):
    eng = _engine(gen, start=False, num_slots=1)
    try:
        r = eng.submit([1, 2], 2)
        r.mark_admitted()  # an earlier admission already happened
        before = len(eng.metrics._queue_wait)
        eng._admit()
        assert eng._slot_req[0] is r  # it was admitted again
        assert len(eng.metrics._queue_wait) == before
    finally:
        eng.close()


def test_restart_rebuilds_the_pool_and_drops_the_old(gen):
    eng = _engine(gen, start=False, num_slots=2, kv_block_size=16)
    try:
        eng.submit([1, 2, 3], 4)
        eng._admit()
        old_pool, old_k = eng.pool, eng.pool.caches.arena.k
        eng._restart_session("RuntimeError('x')")
        assert eng.pool is not old_pool
        assert eng.pool.caches.arena.k.data_ptr() != old_k.data_ptr()
        assert not eng._active.any() and eng._slot_req == [None, None]
        assert eng.pool.free_count() == 2
        assert not eng._wedged
    finally:
        eng.close()


def _outcome(req, timeout=300):
    try:
        return ("served", req.result(timeout=timeout)[0])
    except Exception as e:  # noqa: BLE001 — the outcome is the type
        return ("failed", type(e).__name__)


SCHEDULE = dict(serve_crash_calls={3, 9}, serve_nan_calls={6: 1})
PROMPTS = [[5, 17, 3], list(range(30, 44)), [7, 8, 9], list(range(100, 120)),
           [11, 12], [40, 41, 42, 43], [60, 61, 62, 63, 64]]


@pytest.mark.parametrize("restarts", [1, 2])
def test_same_outcomes_as_jax_under_one_schedule(models, restarts):
    """Crash at engine steps 3 and 9, a NaN slot at step 6: with one
    restart the second crash opens the breaker, with two it restarts
    again. Both engines start with the whole queue in place."""
    jcfg, params, tcfg, model = models
    sv = dict(num_slots=2, max_queue=16, max_len=64,
              max_engine_restarts=restarts)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                          jconfig.ServingConfig(**sv), start=False)
    try:
        with j_use(JFaultInjector(**SCHEDULE)) as jinj:
            reqs = [jeng.submit(p, 5, JSamplingOptions(temperature=0.0))
                    for p in PROMPTS]
            jeng._thread.start()
            want = [_outcome(r) for r in reqs]
            jfired = list(jinj.fired)
        jhealth = jeng.health()
        jrestarts = jeng.metrics.snapshot()["engine_restarts"]
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    eng = ServingEngine(gen, ServingConfig(**sv), device="cpu", start=False)
    try:
        with use_fault_injector(FaultInjector(**SCHEDULE)) as inj:
            reqs = [eng.submit(p, 5, SamplingOptions(temperature=0.0))
                    for p in PROMPTS]
            eng._thread.start()
            got = [_outcome(r) for r in reqs]
            fired = list(inj.fired)
        health = eng.health()
        snap = eng.metrics.snapshot()
    finally:
        eng.close()
    assert got == want
    assert fired == jfired
    assert snap["engine_restarts"] == jrestarts
    for key in ("healthy", "state", "circuit_breaker_open",
                "engine_restarts"):
        assert health[key] == jhealth[key], key
    assert {o for o, _ in got} == {"served", "failed"}
