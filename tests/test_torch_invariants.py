"""The port's serving invariant checker (serving/invariants.py).

- After the same workload on the port's engine and the JAX ServingEngine
  (block-native, the prefix cache on, the same tiny fp32 weights; plain,
  structured and fan-out requests and a refused one), `check_all` gives
  the same verdict law for law on both: the laws checked, the outcome
  counts, the conservation balance, the KV-block statistics, the
  token-exactness and grammar counts. The same holds for a router over two
  replicas on each side.
- Seeded violations each law must catch, on both packages' objects alike:
  a stranded future, a leaked block reference, a removed schema key, an
  illegal grammar token, a dropped terminal count and an inconsistent
  /healthz payload; and the perf laws 8-11 on the same harness inputs.
- The metrics schema: the port's snapshot keys are the reference's minus
  the 13 serving-topology keys (which come with their slice), plus the
  port's three inter-token and TTFT percentile keys.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.inference.generation import SamplingParams as JSP
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import EngineRouter as JEngineRouter
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import invariants as jinv
from megatron_tpu.serving.metrics import ServingMetrics as JMetrics
from megatron_tpu.serving.request import GenRequest as JGenRequest
from megatron_tpu.serving.structured import compile_response_format as jcrf
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import (EngineRouter, SamplingOptions,
                                        ServingEngine)
from megatron_tpu_torch.serving import invariants as tinv
from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.serving.request import GenRequest
from megatron_tpu_torch.serving.structured import compile_response_format

torch.set_num_threads(2)
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            num_kv_heads=2, vocab_size=128, seq_length=64,
            max_position_embeddings=64, make_vocab_size_divisible_by=64,
            compute_dtype="float32", attention_impl="flash")
KW = dict(num_slots=4, max_queue=16, max_len=64, kv_block_size=16,
          block_native_attn=True, enable_prefix_cache=True)
REGEX_RF = {"type": "regex", "pattern": "[0-9]{2,6}"}
# the reference's keys the port's slices have not reached: the serving
# topology, pipeline serving, the handoff
TOPOLOGY_KEYS = {
    "prefill_tp", "decode_tp", "prefill_devices",
    "decode_devices", "prefill_group_busy", "decode_group_busy",
    "serving_pp", "pp_waves", "pp_stage_bubble",
    "pp_activation_bytes_per_step", "handoffs", "handoff_bytes_per_req",
    "placement_replans"}
PORT_EXTRA_KEYS = {"itl_p50_ms", "itl_p99_ms", "ttft_p99_ms"}


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.ModelConfig(**TINY).derived()
    tcfg = tconfig.ModelConfig(**TINY).derived()
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    # fp32 caches: the engines' block kernel and the serial oracle's dot
    # path then see the same values
    jgen = JGenerator(params, jcfg, eos_id=-1, pad_id=0,
                      kv_cache_dtype=jax.numpy.float32)
    tgen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)
    return jgen, tgen


def _workload(eng, sp_cls):
    """Plain greedy requests (two sharing a prefix), a structured one, a
    two-sample fan-out and one refused at submit (too long)."""
    g = sp_cls(temperature=0.0)
    reqs = [eng.submit(list(range(10, 30)), 6, g),
            eng.submit(list(range(10, 30)) + [3, 4], 6, g),
            eng.submit([5, 17, 3, 42], 6, g, response_format=REGEX_RF),
            eng.submit(list(range(40, 60)), 4, g, n=2, best_of=2)]
    with pytest.raises(Exception) as ei:
        eng.submit([1] * 60, 10, g)
    assert "AdmissionError" in type(ei.value).__name__
    return reqs


def _oracle(gen, sp_cls):
    cache = {}

    def want(req):
        # a router request keeps its arguments in its spec
        spec = getattr(req, "spec", None) or dict(
            prompt=req.prompt, max_new_tokens=req.max_new_tokens,
            seed=req.seed)
        key = (tuple(spec["prompt"]), spec["max_new_tokens"], spec["seed"])
        if key not in cache:
            toks, lens, _ = gen.generate([list(spec["prompt"])],
                                         spec["max_new_tokens"],
                                         sp_cls(temperature=0.0),
                                         seed=spec["seed"])
            cache[key] = list(np.asarray(toks)[0, :int(lens[0])])
        return cache[key]
    return want


def _strip(report):
    """The comparable part of a report (the kv stats' namespaces are
    package objects)."""
    out = {k: report[k] for k in ("ok", "laws_checked", "outcomes",
                                  "token_exact", "grammar", "violations")
           if k in report}
    eng = report.get("engine")
    if eng is not None:
        out["balance"] = eng["balance"]
        out["kv"] = eng["kv"]
    return out


def test_engine_verdicts_match_jax(models):
    jgen, tgen = models
    jeng = JServingEngine(jgen, jconfig.ServingConfig(**KW), start=False)
    teng = ServingEngine(tgen, ServingConfig(**KW), device="cpu",
                         start=False)
    try:
        jreqs = _workload(jeng, JSamplingOptions)
        treqs = _workload(teng, SamplingOptions)
        jeng._thread.start()
        teng._thread.start()
        assert jinv.wait_quiesced(jeng) and tinv.wait_quiesced(teng)
        want = _strip(jinv.check_all(jeng, jreqs))
        got = _strip(tinv.check_all(teng, treqs))
        # token exactness against the serial route, for the unconstrained
        # requests (the fan-out's samples each against their own seed)
        want["token_exact"] = jinv.check_token_exact(
            jreqs[:2] + jreqs[3:], [_oracle(jgen, JSP)])
        got["token_exact"] = tinv.check_token_exact(
            treqs[:2] + treqs[3:], [_oracle(tgen, SamplingParams)])
        assert got == want
        assert got["ok"] and got["grammar"]["checked"] == 1
        assert got["token_exact"]["checked"] == 4
        assert set(got["laws_checked"]) == {
            "typed_terminals", "conservation", "metrics_schema", "healthz",
            "kv_accounting", "grammar_validity"}
        # the same seeded violations, each caught under its law on both
        for corrupt, law in ((_leak_block, "kv_accounting"),
                             (_free_list_drift, "kv_accounting")):
            verdicts = []
            for eng, inv in ((jeng, jinv), (teng, tinv)):
                undo = corrupt(eng)
                try:
                    rep = inv.check_all(eng, raise_on_violation=False)
                finally:
                    undo()
                verdicts.append((rep["ok"], sorted(
                    {v.split("]")[0][1:] for v in rep["violations"]})))
            assert verdicts[0] == verdicts[1] == (False, [law])
        assert tinv.check_all(teng)["ok"]
    finally:
        jeng.close()
        teng.close()


def _leak_block(eng):
    """One extra reference on a block nothing holds."""
    pool = eng.pool
    b = next(b for b in range(pool.total_blocks)
             if b != pool.TRASH and int(pool._rc[b]) > 0)
    pool._rc[b] += 1

    def undo():
        pool._rc[b] -= 1
    return undo


def _free_list_drift(eng):
    pool = eng.pool
    b = pool._free_blocks.pop()

    def undo():
        pool._free_blocks.append(b)
    return undo


def test_router_verdicts_match_jax(models):
    jgen, tgen = models
    kw = dict(KW, num_slots=2)
    jr = JEngineRouter([JServingEngine(jgen, jconfig.ServingConfig(**kw))
                        for _ in range(2)])
    tr = EngineRouter([ServingEngine(tgen, ServingConfig(**kw),
                                     device="cpu") for _ in range(2)])
    try:
        reports = []
        for router, sp, inv, gen, spp in ((jr, JSamplingOptions, jinv, jgen,
                                           JSP),
                                          (tr, SamplingOptions, tinv, tgen,
                                           SamplingParams)):
            reqs = [router.submit([7 + i, 8, 9], 5, sp(temperature=0.0))
                    for i in range(4)]
            for r in reqs:
                r.result(timeout=300)
            assert inv.wait_quiesced(router)
            rep = inv.check_all(router, reqs, oracles=[_oracle(gen, spp)])
            reports.append({k: rep[k] for k in ("ok", "laws_checked",
                                                "outcomes", "token_exact")})
            # a removed schema key on the aggregate is a schema violation
            snap = router.aggregate_snapshot()
            snap.pop("degrade_level")
            with pytest.raises(inv.InvariantViolation) as ei:
                inv.check_schema(snap, router=True)
            assert ei.value.law == "metrics_schema"
        assert reports[0] == reports[1]
        assert reports[1]["ok"] and reports[1]["token_exact"]["checked"] == 4
    finally:
        jr.close()
        tr.close()


# ---------------------------------------------------------------------
# seeded violations on host objects, both packages alike
# ---------------------------------------------------------------------
@pytest.mark.parametrize("inv,req_cls,sp_cls,crf", [
    (jinv, JGenRequest, JSamplingOptions, jcrf),
    (tinv, GenRequest, SamplingOptions, compile_response_format)],
    ids=["jax", "port"])
def test_seeded_violations_caught(inv, req_cls, sp_cls, crf):
    # a stranded future: never resolved
    stranded = req_cls([1, 2, 3], 4, sp_cls(temperature=0.0))
    sw = inv._Sweep()
    out = inv.resolve_terminals([stranded], timeout=0.01, sweep=sw)
    assert out["stranded"] == 1
    assert [law for law, _ in sw.violations] == ["typed_terminals"]
    # an untyped terminal: a bare RuntimeError out of result()
    bad = req_cls([1, 2, 3], 4, sp_cls(temperature=0.0))
    bad.result = lambda timeout=None: (_ for _ in ()).throw(
        RuntimeError("bare"))
    with pytest.raises(inv.InvariantViolation) as ei:
        inv.resolve_terminals([bad], timeout=0.01)
    assert ei.value.law == "typed_terminals"
    # an illegal grammar token on a completed structured request
    req = req_cls([5, 17, 3], 4, sp_cls(temperature=0.0))
    req.fsm = crf(REGEX_RF, 128)
    for t in (ord("1"), ord("x")):
        req.append_token(t, -0.1)
    req.finish()
    with pytest.raises(inv.InvariantViolation) as ei:
        inv.check_grammar_validity([req])
    assert ei.value.law == "grammar_validity"
    # a dropped terminal transition
    snap = {"requests_received": 5.0, "requests_completed": 3.0,
            "requests_rejected": 1.0, "requests_failed": 0.0,
            "requests_cancelled": 0.0, "requests_expired": 0.0,
            "requests_shed": 0.0}
    inv.check_metrics_conservation(dict(snap), in_flight=1)
    with pytest.raises(inv.InvariantViolation) as ei:
        inv.check_metrics_conservation(snap, in_flight=0)
    assert ei.value.law == "conservation"
    # an inconsistent healthz payload
    h = {"healthy": True, "state": "running", "accepting": False,
         "loop_alive": True, "circuit_breaker_open": False,
         "active_slots": 0, "num_slots": 2, "queue_depth": 0,
         "free_slots": 2}
    with pytest.raises(inv.InvariantViolation) as ei:
        inv.check_engine_health(h)
    assert ei.value.law == "healthz"
    with pytest.raises(inv.InvariantViolation):
        inv.check_router_health({"replicas_up": 1, "num_replicas": 2,
                                 "state": "down", "healthy": False,
                                 "accepting": False})


PERF_CASES = [
    ("slo", dict(samples_ms={"ttft_ms": [5, 9, 40], "itl_ms": [1, 2]},
                 bounds_ms={"ttft_ms": (0.99, 30.0),
                            "itl_ms": (0.5, 10.0)})),
    ("goodput", dict(snapshot={"tokens_generated": 100.0,
                               "goodput_tokens": 40.0}, floor=0.5)),
    ("goodput_ok", dict(snapshot={"tokens_generated": 100.0,
                                  "goodput_tokens": 80.0}, floor=0.5)),
    ("shed", dict(arms=[(0.5, 0.0), (1.0, 0.3), (2.0, 0.1)])),
    ("shed_ok", dict(arms=[(0.5, 0.0), (2.0, 0.4), (1.0, 0.38)])),
    ("revert", dict(levels=[0, 1, 2, 2, 1], max_level=4)),
    ("thrash", dict(levels=[0, 1, 0, 1, 0, 1, 0], max_level=4,
                    max_direction_changes=2)),
    ("no_rise", dict(levels=[0, 0, 0], max_level=4, require_rise=True)),
    ("revert_ok", dict(levels=[0, 1, 2, 3, 2, 1, 0], max_level=4,
                       require_rise=True, max_direction_changes=2)),
]
PERF_FN = {"slo": "check_slo_bounds", "goodput": "check_goodput_floor",
           "shed": "check_shed_monotone", "revert": "check_degrade_revert",
           "thrash": "check_degrade_revert", "no_rise":
           "check_degrade_revert"}


@pytest.mark.parametrize("name,kw", PERF_CASES, ids=[c[0] for c in PERF_CASES])
def test_perf_laws_match_jax(name, kw):
    fn = PERF_FN[name.replace("_ok", "")]
    verdicts = []
    for inv in (jinv, tinv):
        sw = inv._Sweep()
        out = getattr(inv, fn)(**copy.deepcopy(kw), sweep=sw)
        verdicts.append((out, sw.checked, sw.violations))
    assert verdicts[0] == verdicts[1]
    assert bool(verdicts[1][2]) == (not name.endswith("_ok"))


def test_snapshot_schema_is_the_references_minus_later_slices():
    ref = set(JMetrics().snapshot())
    ours = set(ServingMetrics().snapshot())
    assert ref - ours == TOPOLOGY_KEYS
    assert ours - ref == PORT_EXTRA_KEYS
    # the ten keys of this slice, at 0 on a fresh scrape
    snap = ServingMetrics().snapshot()
    for k in ("mask_uploads", "structured_requests", "grammar_dead_ends",
              "fanout_requests", "fanout_samples", "degrade_level",
              "degrade_transitions", "goodput_tokens", "slo_ttft_violations",
              "slo_itl_violations"):
        assert snap[k] == 0.0, k
    tinv.check_schema(snap)
    m = ServingMetrics()
    m.record_completed(0.1, 10, good_tokens=4)
    m.record_completed(0.1, 5)
    m.set_degrade_gauge(3)
    s = m.snapshot()
    assert (s["goodput_tokens"], s["tokens_generated"],
            s["degrade_level"]) == (9.0, 15.0, 3.0)


def test_router_aggregates_degrade_level_as_max(models):
    _, tgen = models
    engines = [ServingEngine(tgen, ServingConfig(num_slots=1, max_len=64),
                             device="cpu", start=False) for _ in range(3)]
    try:
        router = EngineRouter(engines)
        for e, lvl in zip(engines, (1, 3, 0)):
            e.metrics.set_degrade_gauge(lvl)
        agg = router.aggregate_snapshot()
        assert agg["degrade_level"] == 3.0
        tinv.check_schema(agg, router=True)
    finally:
        for e in engines:
            e.close()
