"""The port's prefix-affinity router (serving/router.py) against the JAX
package's EngineRouter, and inside the port.

- Routed greedy outputs over two block-native replicas (fp32 compute; the
  JAX engines' Pallas kernel in interpret mode) equal the JAX router's
  tokens and logprobs (1e-4); seeded sampled outputs equal the port's own
  serial route.
- The same submit sequence picks the same replicas as the JAX router
  (prefix affinity first, then the least load, then the index).
- A replica killed mid-decode: every future resolves, token-exact against
  the serial route, with its failover and retry counters, arrival ids kept
  and a degraded (still ready) /healthz; all replicas down is a typed 503;
  a half-open replica takes one canary and returns to rotation.
- MegatronServer builds the bare engine for num_replicas 1 and the router
  for 2; every always-present gauge has an aggregation rule and survives a
  fleet scrape; the front-door fields validate as the reference's do.
"""
import time

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import EngineRouter as JEngineRouter
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import (EngineRouter, NoReplicaAvailableError,
                                        SamplingOptions, ServingEngine,
                                        ServingMetrics)
from megatron_tpu_torch.serving import metrics as tmetrics
from megatron_tpu_torch.serving import router as trouter
from megatron_tpu_torch.tools import run_text_generation_server as cli

torch.set_num_threads(2)
TOL = 1e-4
GREEDY = SamplingOptions(temperature=0.0)
ROUTED = dict(num_slots=2, max_queue=32, max_len=64, enable_prefix_cache=True,
              kv_block_size=16, block_native_attn=True)


@pytest.fixture(scope="module")
def tiny():
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def _router(tiny, kv_dtype=torch.float32, **kw):
    """Two replicas over one Generator. Against the serial route the cache
    is fp32 (the block path's fp32 softmax matches the serial dot path
    only under matched dtypes); against JAX it is JAX's default bf16."""
    _, _, tcfg, model = tiny
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=kv_dtype)
    sc = ServingConfig(**dict(ROUTED, **kw))
    engines = [ServingEngine(gen, sc, device="cpu") for _ in range(2)]
    return EngineRouter(engines, max_retries=2, heartbeat_timeout_s=3.0,
                        probe_backoff_s=0.05), engines, gen


def _jrouter(tiny):
    jcfg, params, _, _ = tiny
    gen = JGenerator(params, jcfg, eos_id=0, pad_id=0)
    sc = jconfig.ServingConfig(**ROUTED)
    engines = [JServingEngine(gen, sc) for _ in range(2)]
    return JEngineRouter(engines, max_retries=2, heartbeat_timeout_s=3.0,
                         probe_backoff_s=0.05), engines


def _serial(gen, prompt, n, sp=SamplingParams(temperature=0.0), seed=0):
    toks, lens, _ = gen.generate([prompt], n, sp, seed=seed)
    return toks[0, :lens[0]].tolist()


def test_routed_greedy_outputs_match_jax_router(tiny):
    prompts = [[5 + i, 2, 7, 9] for i in range(6)]
    jr, _ = _jrouter(tiny)
    try:
        reqs = [jr.submit(p, 6, JSamplingOptions(temperature=0.0), seed=i)
                for i, p in enumerate(prompts)]
        want = [r.result(timeout=600) for r in reqs]
    finally:
        jr.close()
    router, engines, _ = _router(tiny, kv_dtype=torch.bfloat16)
    try:
        reqs = [router.submit(p, 6, GREEDY, seed=i)
                for i, p in enumerate(prompts)]
        got = [r.result(timeout=600) for r in reqs]
        # a 6-request burst over 2 x 2 slots spreads over both replicas
        assert all(e.metrics.snapshot()["requests_received"] > 0
                   for e in engines)
    finally:
        router.close()
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)


def test_routed_sampled_outputs_match_serial(tiny):
    router, _, gen = _router(tiny)
    try:
        s = SamplingOptions(temperature=0.9, top_k=5)
        reqs = [(router.submit([5 + i, 2, 7], 6, s, seed=i), i)
                for i in range(6)]
        for r, i in reqs:
            toks, lps = r.result(timeout=300)
            assert toks == _serial(gen, [5 + i, 2, 7], 6, SamplingParams(
                temperature=0.9, top_k=5), seed=i)
            assert len(lps) == len(toks) - 3
    finally:
        router.close()


def _pick_sequence(router, engines, warm, generate):
    """Warm replica 0 with prefix B and replica 1 with prefix A (directly on
    the engines), then route one request at a time, each finished before
    the next: the picks are decided by affinity and, with both replicas
    idle, the index."""
    a, b = list(range(2, 20)), list(range(30, 48))
    generate(engines[1], a)
    generate(engines[0], b)
    picks = []
    for prompt in (a + [50, 51], b + [52], [60, 61, 62], a + [53],
                   [64, 65], b + a[:3]):
        picks.append(warm(router, prompt))
    return picks


def test_warm_replica_picks_match_jax(tiny):
    jr, jengines = _jrouter(tiny)
    try:
        want = _pick_sequence(
            jr, jengines,
            lambda r, p: _route_one(r, p, JSamplingOptions(temperature=0.0)),
            lambda e, p: e.generate(p, 3, JSamplingOptions(temperature=0.0),
                                    seed=0))
    finally:
        jr.close()
    router, engines, _ = _router(tiny, kv_dtype=torch.bfloat16)
    try:
        got = _pick_sequence(
            router, engines, lambda r, p: _route_one(r, p, GREEDY),
            lambda e, p: e.generate(p, 3, GREEDY, seed=0))
    finally:
        router.close()
    assert got == want
    assert got[:2] == [1, 0]


def _route_one(router, prompt, sampling):
    with router._lock:
        peek = router._pick_locked(prompt)[0].idx
    r = router.submit(prompt, 3, sampling, seed=0)
    r.result(timeout=600)
    assert r.replica.idx == peek
    return r.replica.idx


def test_kill_mid_decode_failover_token_exact(tiny):
    router, engines, gen = _router(tiny)
    try:
        for e in engines:
            e.generate([3, 1, 4], 2, GREEDY, seed=0)
        sampled = SamplingOptions(temperature=0.8, top_p=0.9)
        reqs = []
        for i in range(6):
            s = GREEDY if i % 2 == 0 else sampled
            reqs.append((router.submit([9 + i, 3, 5], 16, s, seed=i), i, s))
        give_up = time.monotonic() + 30
        while engines[0].health()["active_slots"] == 0:
            assert time.monotonic() < give_up
            time.sleep(0.002)
        engines[0].close()  # the kill
        for r, i, s in reqs:
            toks, _ = r.result(timeout=300)  # no stranded future
            assert toks == _serial(gen, [9 + i, 3, 5], 16, SamplingParams(
                temperature=s.temperature, top_p=s.top_p), seed=i), i
            assert r.inner.id == r.arrival_id  # the retry kept its place
        h = router.health()
        assert h["state"] == "degraded" and h["healthy"] and h["accepting"]
        snap = router.aggregate_snapshot()
        assert snap["router_failovers"] == 1 and snap["router_retries"] >= 1
        assert snap["fleet_replicas_up"] == 1.0
        # the front door still serves
        toks, _ = router.submit([9, 9, 8], 4, GREEDY, seed=9).result(60)
        assert toks == _serial(gen, [9, 9, 8], 4)
    finally:
        router.close()


def test_all_replicas_down_is_typed_503(tiny):
    _, _, tcfg, model = tiny
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    server = MegatronServer(gen, _Tok(), serving=ServingConfig(
        **dict(ROUTED, num_replicas=2)), device="cpu")
    try:
        for e in server.engine.engines:
            e.close()
        with pytest.raises(NoReplicaAvailableError, match="replicas are down"):
            server.engine.submit([1, 2], 2)
        status, body = server.handle({"prompts": ["ab"],
                                      "tokens_to_generate": 2})
        assert status == 503 and body["retry_after"] >= 1
        status, h = server.healthz()
        assert status == 503 and h["state"] == "down" and not h["healthy"]
    finally:
        server.close()


def test_half_open_canary_recovery(tiny):
    router, engines, _ = _router(tiny)
    try:
        for e in engines:
            e.generate([3, 1, 4], 2, GREEDY, seed=0)
        rep0 = router.replicas[0]
        with router._lock:
            rep0.state = "down"  # ejected (simulated); the engine is fine
            rep0.down_until = 0.0
        # the next refresh sees a healthy snapshot: PROBING, and the first
        # submit is its canary
        r = router.submit([4, 5, 6], 2, GREEDY, seed=1)
        assert r.replica is rep0
        r.result(timeout=120)
        assert rep0.canary is None and rep0.state == "up"
        assert router.health()["state"] == "running"
    finally:
        router.close()


class _Tok:
    eod = 0
    bos = None

    def tokenize(self, text):
        return [2 + (ord(c) % 100) for c in text]

    def detokenize(self, ids):
        return " ".join(map(str, ids))


def test_num_replicas_builds_bare_engine_or_router(tiny):
    _, _, tcfg, model = tiny
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    for n in (1, 2):
        server = MegatronServer(gen, _Tok(), serving=ServingConfig(
            **dict(ROUTED, num_replicas=n)), device="cpu")
        try:
            if n == 1:
                assert isinstance(server.engine, ServingEngine)
                assert server.engine._host_tier is None
            else:
                assert isinstance(server.engine, EngineRouter)
                engines = server.engine.engines
                assert len(engines) == 2 and engines[0].pool is not \
                    engines[1].pool and engines[0].gen is engines[1].gen
            payload = {"prompts": ["hello"], "tokens_to_generate": 4,
                       "temperature": 0.0}
            status, body = server.handle(payload)
            assert status == 200
            assert body["segments"][0] == _serial(
                gen, _Tok().tokenize("hello"), 4)
            snap = server.metrics_snapshot()
            assert snap["requests_completed"] == 1.0
            if n == 2:
                assert snap["num_replicas"] == 2.0
                server.engine.engines[1].close()
                status, h = server.healthz()
                assert status == 200 and h["state"] == "degraded"
        finally:
            server.close()


class _FakeEngine:
    """metrics and max_len are all aggregate_snapshot touches."""

    def __init__(self):
        self.metrics = ServingMetrics()
        self.max_len = 64


def test_every_base_gauge_has_an_aggregation_rule():
    handled = (set(trouter._SUM_GAUGES) | set(trouter._MAX_GAUGES)
               | set(trouter._ROUTER_GAUGES))
    missing = [g for g in tmetrics._BASE_GAUGES if g not in handled]
    assert not missing, f"gauges with no aggregation rule: {missing}"
    # and the rules name only gauges an engine reports
    assert handled <= set(tmetrics._BASE_GAUGES)


def test_nonzero_gauges_survive_aggregation():
    eng_a, eng_b = _FakeEngine(), _FakeEngine()
    for i, g in enumerate(tmetrics._BASE_GAUGES):
        setattr(eng_a.metrics, g, i + 1)
    agg = EngineRouter([eng_a, eng_b]).aggregate_snapshot()
    for g in tmetrics._BASE_GAUGES:
        assert agg[g] > 0.0, g
    for k in ("router_failovers", "router_retries", "host_tier_hits",
              "host_tier_demotions", "host_tier_checksum_misses",
              "stream_reconnects"):
        assert agg[k] == 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(host_kv_bytes=1 << 20), "host_kv_bytes"),
    (dict(host_kv_bytes=1 << 20, enable_prefix_cache=True), "host_kv_bytes"),
    (dict(num_replicas=0), "num_replicas"),
    (dict(num_replicas=2, serial_fallback=True), "serial_fallback"),
    (dict(router_max_retries=-1), "router_max_retries"),
    (dict(router_heartbeat_timeout_s=0.0), "router_heartbeat_timeout_s"),
    (dict(stream_ttl_s=0.0), "stream_ttl_s"),
])
def test_front_door_fields_validate_as_jax(kw, match):
    with pytest.raises(AssertionError):
        jconfig.ServingConfig(**kw).validate()
    with pytest.raises(ValueError, match=match):
        ServingConfig(**kw).validate()


def test_front_door_fields_legal_combination():
    kw = dict(num_replicas=2, enable_prefix_cache=True, kv_block_size=16,
              host_kv_bytes=1 << 20, max_len=64, stream_ttl_s=30.0,
              router_max_retries=0, router_heartbeat_timeout_s=1.0)
    jconfig.ServingConfig(**kw).validate()
    ServingConfig(**kw).validate()


def test_cli_passes_the_front_door_flags():
    args = cli.build_parser().parse_args([
        "--num_replicas", "2", "--router_max_retries", "3",
        "--router_heartbeat_timeout_s", "2.5", "--host_kv_bytes", "4096",
        "--stream_ttl_s", "30", "--enable_prefix_cache",
        "--kv_block_size", "16", "--retained_slots", "2"])
    sc = cli.serving_config(args, 4).validate()
    assert (sc.num_replicas, sc.router_max_retries,
            sc.router_heartbeat_timeout_s, sc.host_kv_bytes,
            sc.stream_ttl_s, sc.enable_prefix_cache,
            sc.retained_slots) == (2, 3, 2.5, 4096, 30.0, True, 2)


@pytest.mark.parametrize("call", [lambda r: r.affinity_digest()],
                         ids=["affinity_digest"])
def test_later_router_features_raise(call):
    with pytest.raises(NotImplementedError, match="item 6"):
        call(EngineRouter([_FakeEngine()]))


@pytest.mark.parametrize("drill", ["kill", "wedge", "host_tier"])
def test_chaos_router_drill_holds(drill):
    """tools/chaos_router.py's drills 1-3 on the CPU (its --smoke sizes)."""
    from megatron_tpu_torch.tools import chaos_router
    fn = {"kill": lambda: chaos_router.kill_drill(12, "cpu"),
          "wedge": lambda: chaos_router.wedge_drill(12, 1.0, 2.5, "cpu"),
          "host_tier": lambda: chaos_router.host_tier_drill(12, "cpu")}
    record = fn[drill]()
    assert record["ok"], record


@pytest.mark.parametrize("name", ["kill_half_drill", "kill_stage_drill"])
def test_chaos_router_topology_drills_raise(name):
    from megatron_tpu_torch.tools import chaos_router
    with pytest.raises(NotImplementedError, match="item 7"):
        getattr(chaos_router, name)(12)
