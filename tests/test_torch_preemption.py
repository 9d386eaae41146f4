"""The port's priority preemption.

- The scheduler's requeue / peek_priority / parked_count / clear_parked /
  drop_resumed / live_depth against the JAX AdmissionScheduler on the same
  sequence of requests.
- The engine with preemption against the JAX ServingEngine, both
  block-native (the JAX one in Pallas interpret mode), on tiny Llama and
  Falcon with fp32 compute: two priority-0 streams fill the grid, two
  priority-1 requests arrive and preempt them; greedy tokens exact,
  logprobs within 1e-4, and the victims' tokens are those of a run with
  no preemption.
- Inside the port (torch cannot reproduce jax.random): seeded sampled
  victims give their unpreempted streams both when they resume from their
  parked KV and when the park budget is forced full so they replay, on the
  block-native and the whole-region pool; a supervisor restart drops
  parked KV, and the victim replays.
"""
import time

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving.request import GenRequest as JGenRequest
from megatron_tpu.serving.scheduler import \
    AdmissionScheduler as JAdmissionScheduler
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.serving.request import GenRequest
from megatron_tpu_torch.serving.scheduler import AdmissionScheduler

torch.set_num_threads(2)
TOL = 1e-4
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}
LOW = [list(range(10, 30)), list(range(40, 57))]
HIGH = [[1, 2, 3, 4, 5], [6, 7, 8]]
LOW_NEW, HIGH_NEW = 40, 5
BLOCK = dict(num_slots=2, max_len=128, kv_block_size=16,
             block_native_attn=True, priority_levels=2)


def _models(name):
    fn = PRESETS[name]
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def test_scheduler_requeue_and_peek_match_jax():
    def run(sched_cls, req_cls):
        sched = sched_cls(4, max_total_len=64, num_slots=2)
        reqs = [req_cls([1, 2], 4, priority=p) for p in (0, 1, 0, 1)]
        log = []
        for r in reqs[:3]:
            sched.submit(r)
        log.append(sched.peek_priority())
        reqs[1].cancel()
        log.append(sched.peek_priority())
        popped = sched.pop_ready(2)  # the cancelled one fails in passing
        log.append([reqs.index(r) for r in popped])
        # a victim re-enters past the bound, at its arrival position
        for r in reqs[3:] + [reqs[0]]:
            sched.submit(r) if r is reqs[3] else sched.requeue(r)
        reqs[0].parked = ("kv", "logits")
        reqs[0].resume_rng = "state"
        log.append((sched.depth(), sched.live_depth(), sched.parked_count()))
        log.append([reqs.index(r) for r in sched.pop_ready(1)])
        sched.requeue(reqs[3])
        log.append(sched.clear_parked())
        log.append([reqs.index(r) for r in sched.drop_resumed()])
        sched.close()
        log.append(sched.requeue(reqs[2]))
        log.append(reqs[2].done())
        return log

    assert run(AdmissionScheduler, GenRequest) == run(JAdmissionScheduler,
                                                      JGenRequest)


def _preempted(submit, high_priority=1):
    """Two low-priority streams fill the two slots; once both decode, two
    higher-priority requests arrive."""
    low = [submit(p, LOW_NEW, 0, 7 + i) for i, p in enumerate(LOW)]
    deadline = time.monotonic() + 300
    while any(len(r.generated) < 2 for r in low):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    high = [submit(p, HIGH_NEW, high_priority, 0) for p in HIGH]
    return [r.result(timeout=600) for r in low + high]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preemption_engine_matches_jax_engine(name):
    jcfg, params, tcfg, model = _models(name)
    kw = dict(BLOCK, preemption=True)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=-1, pad_id=0),
                          jconfig.ServingConfig(**kw))
    try:
        want = _preempted(lambda p, n, prio, seed: jeng.submit(
            p, n, JSamplingOptions(temperature=0.0), priority=prio))
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu")
    got = {}
    for on in (True, False):
        with ServingEngine(gen, ServingConfig(**dict(kw, preemption=on)),
                           device="cpu") as eng:
            got[on] = _preempted(lambda p, n, prio, seed: eng.submit(
                p, n, SamplingOptions(temperature=0.0), priority=prio))
            snap = eng.metrics.snapshot()
            if on:
                assert snap["preemptions"] >= 1
    assert jsnap["preemptions"] >= 1
    for (gt, glp), (wt, wlp) in zip(got[True], want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    assert [t for t, _ in got[True]] == [t for t, _ in got[False]]


@pytest.fixture(scope="module")
def port_gen():
    _, _, tcfg, model = _models("llama")
    return Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


@pytest.mark.parametrize("pool", ["block", "region"])
def test_sampled_victims_parked_and_replayed_equal_unpreempted(port_gen,
                                                               pool):
    sp = SamplingOptions(temperature=0.9, top_p=0.9)
    kw = BLOCK if pool == "block" else dict(num_slots=2, max_len=128,
                                            priority_levels=2)
    runs = {}
    for arm in ("off", "parked", "replay"):
        with ServingEngine(port_gen, ServingConfig(
                **kw, preemption=arm != "off"), device="cpu") as eng:
            if arm == "replay":
                # the park budget full: every victim replays
                eng.scheduler.parked_count = lambda: eng.num_slots
            runs[arm] = [t for t, _ in _preempted(
                lambda p, n, prio, seed: eng.submit(p, n, sp, seed=seed,
                                                    priority=prio))]
            snap = eng.metrics.snapshot()
            assert (snap["preemptions"] >= 1) == (arm != "off")
    assert runs["parked"] == runs["off"] == runs["replay"]


def test_restart_drops_parked_kv(port_gen):
    eng = ServingEngine(port_gen, ServingConfig(**BLOCK, preemption=True),
                        device="cpu", start=False)
    req = GenRequest([1, 2, 3], 4, SamplingOptions(temperature=0.0))
    req.parked = ("kv", "logits")
    req.resume_rng = torch.empty(0, dtype=torch.uint8)
    eng.scheduler.requeue(req)
    eng._restart_session("injected")
    assert req.parked is None and eng.scheduler.depth() == 1
    assert not req.done()
    eng.close()
