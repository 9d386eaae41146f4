"""Remote replicas (serving/remote.py) against the JAX package.

- `affinity_digest()` of the JAX and the port ServingEngine, after the same
  prompts on the same tiny fp32 weights with the prefix cache, a host tier
  and an adapter: equal dicts (granularity, namespace hash sets, adapter
  residency); `digest_peek` of both packages equal on those digests and on
  synthetic ones, and equal to the port engine's `prefix_peek`.
- The reference's scripted one-shot HTTP faults (refused, timeout, reset
  mid-body, garbage JSON, truncated SSE, 503 with Retry-After, 429, 400):
  the same exception class names, `status`, `retry_after` and counter
  increments from both packages' `RemoteReplica`.
- The wire both ways: the port's `RemoteReplica` against a JAX
  `MegatronServer` in replica mode, and the JAX `RemoteReplica` against the
  port's replica server, give greedy tokens equal to the JAX serial output
  on the same weights; stream resume through Last-Event-ID.
- `validate_generate_payload`'s `prompt_tokens` errors and the servers'
  statuses, the fleet config checks, the fleet's aggregate over parsed JSON
  snapshots and `_check_remote_engine`'s verdicts (unreachable included):
  equal to JAX's.
- A fleet front tier over two port replica servers: tokens through the
  hop, SSE through two hops, GET /affinity, the fleet /invariants, the
  router's merged digest and a dead replica's failover.
"""
import http.server
import json
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.inference.generation import SamplingParams as JSP
from megatron_tpu.inference.server import MegatronServer as JMegatronServer
from megatron_tpu.inference.server import \
    validate_generate_payload as jvalidate
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import EngineRouter as JEngineRouter
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import adapters as jad
from megatron_tpu.serving import invariants as jinv
from megatron_tpu.serving import remote as jremote
from megatron_tpu.serving.metrics import ServingMetrics as JMetrics
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.inference.server import \
    validate_generate_payload as tvalidate
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import (EngineRouter, SamplingOptions,
                                        ServingEngine)
from megatron_tpu_torch.serving import invariants as tinv
from megatron_tpu_torch.serving import remote as tremote
from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.tools.chaos_common import IntTokenizer, free_port

torch.set_num_threads(2)
GREEDY = SamplingOptions(temperature=0.0)
JGREEDY = JSamplingOptions(temperature=0.0)
RANK, ALPHA = 4, 8.0
REPLICA = dict(num_slots=2, max_queue=16, max_len=64, kv_block_size=16,
               enable_prefix_cache=True)
PROMPTS = [[5, 17, 3, 42], list(range(20, 40)), [7, 8, 9, 10, 11]]
NEW = 8


@pytest.fixture(scope="module")
def tiny():
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    jgen = JGenerator(params, jcfg, eos_id=-1, pad_id=0,
                      kv_cache_dtype=jnp.float32)
    tgen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)
    return jcfg, jgen, tcfg, tgen


def _jax_serial(jgen, prompt, n=NEW):
    toks, lens, _ = jgen.generate([list(prompt)], n, JSP(temperature=0.0))
    return list(np.asarray(toks)[0, :int(lens[0])])


# ---------------------------------------------------------------------
# the affinity digest and digest_peek
# ---------------------------------------------------------------------
DIGEST_SERVING = dict(num_slots=2, max_queue=16, max_len=64,
                      kv_block_size=16, block_native_attn=True,
                      enable_prefix_cache=True, retained_slots=1,
                      host_kv_bytes=1 << 22, adapter_slots=2,
                      adapter_rank=RANK)
# served one after another: two 2-block prompts, one under the adapter,
# then churn that demotes the first retained entries to the host tier
DIGEST_RUNS = [(list(range(1, 41)), None), (list(range(50, 90)), "t0"),
               (list(range(3, 24)), None), (list(range(60, 81)), None)]
DIGEST_PROBES = [(list(range(1, 41)) + [99], None),
                 (list(range(1, 17)) + [5, 6], None),
                 (list(range(50, 90)) + [7], "t0"),
                 (list(range(50, 90)) + [7], None),
                 (list(range(3, 24)), None), ([9, 9, 9], None),
                 (list(range(60, 81)) + [1], "t0")]


def test_affinity_digest_and_peek_match_jax(tiny):
    jcfg, jgen, tcfg, tgen = tiny
    factors = jad.random_adapter_factors(jcfg, RANK, 5)
    jeng = JServingEngine(jgen, jconfig.ServingConfig(**DIGEST_SERVING))
    try:
        jeng.register_adapter("t0", factors=factors, rank=RANK, alpha=ALPHA)
        for p, aid in DIGEST_RUNS:
            jeng.submit(p, 4, JGREEDY, adapter_id=aid).result(timeout=600)
        jdigest = jeng.affinity_digest()
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    eng = ServingEngine(tgen, ServingConfig(**DIGEST_SERVING), device="cpu")
    try:
        eng.register_adapter("t0", factors=factors, rank=RANK, alpha=ALPHA)
        for p, aid in DIGEST_RUNS:
            eng.submit(p, 4, GREEDY, adapter_id=aid).result(timeout=600)
        digest = eng.affinity_digest()
        snap = eng.metrics.snapshot()
        peeks = [eng.prefix_peek(p, aid) for p, aid in DIGEST_PROBES]
    finally:
        eng.close()
    assert snap["host_tier_demotions"] == jsnap["host_tier_demotions"] >= 1
    assert digest == jdigest
    assert digest["granularity"] == 16
    assert set(digest["namespaces"]) == {"", "t0"}
    assert digest["adapters"] == {"t0": 2}
    got = [tremote.digest_peek(digest, p, aid) for p, aid in DIGEST_PROBES]
    want = [jremote.digest_peek(jdigest, p, aid) for p, aid in DIGEST_PROBES]
    assert got == want == peeks
    assert max(got) == 32  # a host-tier chain counts like the device's


def test_digest_peek_matches_jax_on_synthetic_chains():
    import zlib
    rs = np.random.RandomState(4)
    for g in (1, 4, 16):
        toks = rs.randint(0, 500, size=5 * g).tolist()
        chain, cum = [], 0
        for i in range(0, len(toks), g):
            cum = zlib.crc32(",".join(str(t) for t in toks[i:i + g])
                             .encode(), cum)
            chain.append(cum)
        digest = {"granularity": g, "namespaces": {"": chain[:4],
                                                  "a": chain[:2]},
                  "adapters": {}}
        probes = [(toks, None), (toks + [1], None), (toks[:2 * g], None),
                  (toks[:g] + [7] * g + toks[2 * g:], None), (toks, "a"),
                  (toks, "b"), ([], None)]
        for p, aid in probes:
            assert tremote.digest_peek(digest, p, aid) \
                == jremote.digest_peek(digest, p, aid), (g, p, aid)
    for bad in (None, {}, {"granularity": 0, "namespaces": {}}):
        assert tremote.digest_peek(bad, [1, 2, 3]) \
            == jremote.digest_peek(bad, [1, 2, 3]) == 0


# ---------------------------------------------------------------------
# scripted one-shot faults, both packages' clients
# ---------------------------------------------------------------------
def _drain_request(conn) -> None:
    """Read one HTTP request (headers and its Content-Length body), so the
    reply cannot race the client's send."""
    conn.settimeout(5.0)
    buf = b""
    while b"\r\n\r\n" not in buf:
        d = conn.recv(4096)
        if not d:
            return
        buf += d
    head, _, body = buf.partition(b"\r\n\r\n")
    want = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            want = int(line.split(b":")[1])
    while len(body) < want:
        d = conn.recv(4096)
        if not d:
            break
        body += d


def _serve_once(handler) -> int:
    """A localhost socket answering exactly one connection with
    `handler(conn)` after draining the request."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    port = s.getsockname()[1]

    def run():
        try:
            conn, _ = s.accept()
        except OSError:
            return
        try:
            _drain_request(conn)
            handler(conn)
        except Exception:  # noqa: BLE001 — the client is under test
            pass
        finally:
            conn.close()
            s.close()

    threading.Thread(target=run, daemon=True).start()
    return port


def _http(body: bytes, status: bytes = b"200 OK",
          ctype: bytes = b"application/json", extra: bytes = b"") -> bytes:
    return (b"HTTP/1.1 " + status + b"\r\nContent-Type: " + ctype
            + b"\r\nContent-Length: " + str(len(body)).encode() + b"\r\n"
            + extra + b"Connection: close\r\n\r\n" + body)


def _reset_mid_body(conn):
    conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                 b"Content-Length: 9999\r\n\r\n{\"requests_received\": 1")


def _truncated_sse(conn):
    conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                 b"Connection: close\r\n\r\n")


# (the fault's server, or None for a refused port; the client call)
FAULTS = {
    "refused": (None, "health"),
    "timeout": (lambda conn: time.sleep(2.0), "health"),
    "reset_mid_body": (_reset_mid_body, "metrics"),
    "garbage_json": (lambda conn: conn.sendall(
        _http(b"<html>not json</html>")), "metrics"),
    "truncated_sse": (_truncated_sse, "submit"),
    "503_retry_after": (lambda conn: conn.sendall(_http(
        json.dumps({"message": "draining"}).encode(),
        status=b"503 Service Unavailable",
        extra=b"Retry-After: 1.5\r\n")), "submit"),
    "429": (lambda conn: conn.sendall(_http(
        json.dumps({"message": "queue full", "retry_after": 2,
                    "queue_depth": 31}).encode(),
        status=b"429 Too Many Requests")), "submit"),
    "400": (lambda conn: conn.sendall(_http(
        json.dumps({"message": "prompt too long"}).encode(),
        status=b"400 Bad Request")), "submit"),
}


def _fault_outcome(mod, counters, fault):
    handler, call = FAULTS[fault]
    port = free_port() if handler is None else _serve_once(handler)
    rep = mod.RemoteReplica(f"127.0.0.1:{port}", counters=counters,
                            connect_timeout_s=0.5, read_timeout_s=0.5,
                            max_retries=0, backoff_s=0.01)
    try:
        if call == "health":
            rep.health()
        elif call == "metrics":
            rep.metrics.snapshot()
        else:
            rep.submit([1, 2, 3], 4)
    except Exception as e:  # noqa: BLE001 — the outcome under test
        snap = counters.snapshot()
        return dict(cls=type(e).__name__, kind=getattr(e, "kind", None),
                    status=getattr(e, "status", None),
                    retry_after=getattr(e, "retry_after", None),
                    counters={k: snap[k] for k in (
                        "router_remote_timeouts", "router_remote_retries",
                        "router_probe_failures")})
    raise AssertionError(f"{fault}: no exception")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_scripted_faults_match_jax(fault):
    got = _fault_outcome(tremote, ServingMetrics(), fault)
    want = _fault_outcome(jremote, JMetrics(), fault)
    assert got == want
    # every transport fault is a retryable 503 in the port's taxonomy too
    if got["kind"] is not None:
        assert issubclass(getattr(tremote, got["cls"]),
                          tremote.ServiceUnavailableError)


# ---------------------------------------------------------------------
# the wire both ways
# ---------------------------------------------------------------------
def _serve_port(server):
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def _stop(httpd, thread, server):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    server.close()


def test_port_client_against_jax_replica(tiny, monkeypatch):
    """The port's RemoteReplica drives a JAX replica-mode server (its
    stdlib transport in a thread): greedy tokens equal JAX's serial route,
    a dropped stream resumes, the digest, metrics and the replica's own
    invariant report come over the wire."""
    jcfg, jgen, tcfg, tgen = tiny
    made = []

    class Recording(http.server.ThreadingHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(http.server, "ThreadingHTTPServer", Recording)
    server = JMegatronServer(jgen, IntTokenizer(),
                             serving=jconfig.ServingConfig(
                                 replica_mode=True, **REPLICA))
    thread = threading.Thread(target=server._run_stdlib,
                              args=("127.0.0.1", 0), daemon=True)
    thread.start()
    try:
        give_up = time.monotonic() + 60
        while not made:
            assert time.monotonic() < give_up
            time.sleep(0.01)
        addr = "127.0.0.1:%d" % made[0].server_address[1]
        counters = ServingMetrics()
        rep = tremote.RemoteReplica(addr, counters=counters,
                                    read_timeout_s=60.0,
                                    digest_interval_s=0.01)
        assert rep.health()["accepting"]
        reqs = [rep.submit(p, NEW, GREEDY, seed=i)
                for i, p in enumerate(PROMPTS)]
        got = [r.result(timeout=600)[0] for r in reqs]
        assert got == [_jax_serial(jgen, p) for p in PROMPTS]
        # the digest of the JAX engine answers the port's peek
        time.sleep(0.02)
        rep.health()
        assert rep.prefix_peek(PROMPTS[1] + [1]) == 16
        # a dropped stream resumes exactly through Last-Event-ID
        conn, resp, start = rep._open_stream(
            {"prompt_tokens": [PROMPTS[0]], "tokens_to_generate": NEW,
             "temperature": 0.0, "stream": True})
        head = []
        while len(head) < 3:
            ev, data, _ = tremote._read_frame(resp)
            if ev == "token":
                head.append(data["token"])
        conn.close()
        conn, resp, start2 = rep._open_stream(
            {"stream_id": start["stream_id"], "stream": True},
            headers={"Last-Event-ID": "2"})
        assert start2["resumed"] and start2["next_index"] == 3
        tail = []
        while True:
            ev, data, _ = tremote._read_frame(resp)
            if ev == "done":
                break
            if ev == "token":
                tail.append(data["token"])
        conn.close()
        assert PROMPTS[0] + head + tail == got[0]
        snap = rep.metrics.snapshot()
        assert snap["requests_completed"] >= 4
        report = rep.invariant_report(strict=False)
        assert report["ok"] and report["engines"] == 1
    finally:
        server.engine.close()
        for h in made:
            h.shutdown()
            h.server_close()
        thread.join(timeout=30)


def test_jax_client_against_port_replica(tiny):
    """The JAX RemoteReplica drives the port's replica server: greedy
    tokens equal JAX's serial route; a 400 and a 429 come back as the JAX
    client's typed errors; the digest and the invariant report parse."""
    jcfg, jgen, tcfg, tgen = tiny
    server = MegatronServer(tgen, IntTokenizer(), device="cpu",
                            serving=ServingConfig(replica_mode=True,
                                                  **REPLICA))
    httpd, thread = _serve_port(server)
    try:
        addr = "127.0.0.1:%d" % httpd.server_address[1]
        rep = jremote.RemoteReplica(addr, read_timeout_s=60.0,
                                    digest_interval_s=0.01)
        assert rep.health()["accepting"] and rep.max_len == 64
        reqs = [rep.submit(p, NEW, JGREEDY, seed=i)
                for i, p in enumerate(PROMPTS)]
        got = [r.result(timeout=600)[0] for r in reqs]
        assert got == [_jax_serial(jgen, p) for p in PROMPTS]
        time.sleep(0.02)
        rep.health()
        assert rep.prefix_peek(PROMPTS[1] + [1]) == 16
        from megatron_tpu.serving import AdmissionError as JAdmissionError
        with pytest.raises(JAdmissionError, match="exceeds max_len"):
            rep.submit([1] * 60, 10, JGREEDY)
        report = rep.invariant_report(strict=True)
        assert report["ok"], report
        assert rep.drain(timeout=30) is True
    finally:
        _stop(httpd, thread, server)


# ---------------------------------------------------------------------
# payloads, statuses and config checks
# ---------------------------------------------------------------------
PAYLOADS = [
    {"prompt_tokens": [[1, 2, 3]]},
    {"prompt_tokens": [[1, 2, 3]], "prompts": ["a"]},
    {"prompt_tokens": []},
    {"prompt_tokens": "1 2 3"},
    {"prompt_tokens": [[1, 2], []]},
    {"prompt_tokens": [[1, "2"]]},
    {"prompt_tokens": [[1, True]]},
    {"prompt_tokens": [[1, 2.0]]},
    {"prompt_tokens": [[1]] * 129},
    {"prompt_tokens": [[1, 2]], "beam_width": 2},
    {"prompt_tokens": [[1, 2], [3]], "beam_width": 2},
    {"prompt_tokens": [[1, 2]], "arrival_id": "x"},
    {"prompt_tokens": [[1, 2]], "tokens_to_generate": -1},
]


def test_prompt_tokens_validation_matches_jax():
    for p in PAYLOADS:
        assert tvalidate(p) == jvalidate(p), p


class _CharTok:
    eod = 0
    bos = 1

    def tokenize(self, text):
        return [2 + (ord(c) % 90) for c in text][:16]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


STATUS_PAYLOADS = [
    {"prompt_tokens": [[5, 6, 7]], "tokens_to_generate": 2,
     "temperature": 0.0},
    {"prompt_tokens": [[5, 6, 7]], "tokens_to_generate": 2, "serial": True},
    {"prompt_tokens": [[5] * 60], "tokens_to_generate": 10},
    {"prompt_tokens": [[5, 6, 7], [8, 9]], "stream": True},
    {"prompts": ["ab"], "tokens_to_generate": 2, "temperature": 0.0},
]


@pytest.mark.parametrize("replica_mode", [False, True])
def test_prompt_tokens_statuses_match_jax(tiny, replica_mode):
    """A public server refuses the wire format with the reference's 400; a
    replica serves it, text prompts too, and refuses what the reference
    refuses."""
    jcfg, jgen, tcfg, tgen = tiny
    kw = dict(REPLICA, replica_mode=replica_mode)
    jserver = JMegatronServer(jgen, _CharTok(),
                              serving=jconfig.ServingConfig(**kw))
    try:
        want = [jserver.handle(dict(p)) for p in STATUS_PAYLOADS]
    finally:
        jserver.close()
    server = MegatronServer(tgen, _CharTok(), device="cpu",
                            serving=ServingConfig(**kw))
    try:
        got = [server.handle(dict(p)) for p in STATUS_PAYLOADS]
    finally:
        server.close()
    for p, (gs, gb), (ws, wb) in zip(STATUS_PAYLOADS, got, want):
        assert gs == ws, (p, gb, wb)
        if gs != 200:
            assert gb["message"] == wb["message"], p
        elif not p.get("stream"):
            assert gb["segments"] == [list(map(int, s))
                                      for s in wb["segments"]], p


FLEET_CONFIGS = [
    dict(fleet="127.0.0.1:1,127.0.0.1:2"),
    dict(fleet=" , "),
    dict(fleet="localhost"),
    dict(fleet="127.0.0.1:1", serial_fallback=True),
    dict(fleet="127.0.0.1:1", num_replicas=2),
    dict(fleet="127.0.0.1:1", replica_mode=True),
    dict(replica_mode=True),
    dict(replica_mode=True, serial_fallback=True),
    dict(remote_connect_timeout_s=0.0),
    dict(remote_read_timeout_s=-1.0),
    dict(remote_max_retries=-1),
    dict(remote_digest_interval_s=0.0),
]


@pytest.mark.parametrize("i", range(len(FLEET_CONFIGS)))
def test_fleet_config_checks_match_jax(i):
    """The reference asserts what the port raises as ValueError: the same
    verdicts and, for the fleet's own checks, the same messages."""
    kw = FLEET_CONFIGS[i]
    try:
        jconfig.ServingConfig(**kw).validate(None)
        want = None
    except AssertionError as e:
        want = str(e)
    try:
        ServingConfig(**kw).validate(None)
        got = None
    except ValueError as e:
        got = str(e)
    assert (got is None) == (want is None), (kw, got, want)
    if want is not None and ("fleet" in want or "replica_mode" in want):
        assert got == want


def test_topology_fields_still_raise():
    for kw in (dict(serving_tp=2), dict(disaggregate_prefill=True),
               dict(serving_pp=2), dict(placement_auto=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            ServingConfig(**kw).validate()


# ---------------------------------------------------------------------
# the fleet's aggregate and invariant verdicts
# ---------------------------------------------------------------------
class _StubEngine:
    """An engine duck type whose snapshot is a fixed dict."""

    def __init__(self, snap: dict):
        self._snap = dict(snap)
        self.max_len = 128
        outer = self

        class _M:
            def snapshot(self):
                return dict(outer._snap)

        self.metrics = _M()

    def health(self):
        return {"healthy": True, "state": "running", "accepting": True,
                "loop_alive": True, "queue_depth": 0, "active_slots": 0,
                "service_time_ewma_ms": 1.0}

    def close(self):
        pass


def _fleet_snaps():
    base = ServingMetrics().snapshot()
    a, b = dict(base), dict(base)
    a.update({"requests_received": 5.0, "requests_completed": 4.0,
              "ttft_p95_ms": 10.0, "tokens_per_s": 80.0,
              "slot_occupancy": 0.5, "weight_version": 3.0,
              "degrade_level": 2.0, "goodput_tokens": 50.0,
              "router_remote_timeouts": 1.0})
    b.update({"requests_received": 7.0, "requests_completed": 7.0,
              "ttft_p95_ms": 25.0, "tokens_per_s": 40.0,
              "slot_occupancy": 0.75, "weight_version": 5.0,
              "degrade_level": 1.0, "goodput_tokens": 25.0})
    return a, b


def test_aggregate_over_parsed_snapshots_matches_jax():
    a, b = _fleet_snaps()
    aggs = []
    for router_cls in (EngineRouter, JEngineRouter):
        for wire in (False, True):
            snaps = [json.loads(json.dumps(s)) if wire else s
                     for s in (a, b)]
            router = router_cls([_StubEngine(s) for s in snaps])
            try:
                aggs.append(router.aggregate_snapshot())
            finally:
                router.close()
    port_live, port_wire, jax_live, jax_wire = aggs
    assert port_live == port_wire
    assert jax_live == jax_wire
    for k, v in port_live.items():
        if k in jax_live:
            assert v == jax_live[k], k
    assert port_live["requests_received"] == 12.0
    assert port_live["weight_version_min"] == 3.0
    assert port_live["weight_version_max"] == 5.0
    assert port_live["degrade_level"] == 2.0
    assert port_live["goodput_tokens"] == 75.0
    assert port_live["fleet_replicas_up"] == 2.0


class _RemoteStub:
    def __init__(self, addr, report=None, exc=None):
        self.addr, self._report, self._exc = addr, report, exc

    def invariant_report(self, strict=True):
        if self._exc is not None:
            raise self._exc
        return self._report


REPORTS = [
    dict(report={"engines": 1, "laws_checked": ["conservation", "healthz"],
                 "violations": [], "ok": True}),
    dict(report={"engines": 1, "laws_checked": ["conservation", "kv"],
                 "violations": [["conservation", "planted drift"],
                                "a bare string"], "ok": False}),
    dict(exc="refused"),
]


@pytest.mark.parametrize("i", range(len(REPORTS)))
def test_check_remote_engine_matches_jax(i):
    case = REPORTS[i]
    out = []
    for mod, inv in ((tremote, tinv), (jremote, jinv)):
        exc = (mod.RemoteConnectionRefusedError("connection refused: x")
               if case.get("exc") else None)
        stub = _RemoteStub("127.0.0.1:9", case.get("report"), exc)
        sw = inv._Sweep()
        sw.checked.append("typed_terminal")
        res = inv._check_remote_engine(stub, True, sw)
        out.append((res, list(sw.checked), list(sw.violations)))
    assert out[0] == out[1]


def test_fleet_invariant_report_matches_jax():
    """A front tier's GET /invariants over a replica answering a report
    with a violation and a dead address: the same report from both
    packages' servers (the dead one under `unreachable`, the live one's
    violation tagged with its address)."""
    # each package's front tier scrapes its own schema
    fresh = {}
    replica_report = {"engines": 1, "laws_checked": ["conservation"],
                      "violations": [["conservation", "planted drift"]],
                      "ok": False}
    health = {"healthy": True, "accepting": True, "state": "running",
              "loop_alive": True, "queue_depth": 0, "max_len": 64,
              "weight_version": "unversioned"}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = {"/healthz": health, "/metrics": fresh["snap"],
                    "/affinity": {"granularity": 16, "namespaces": {},
                                  "adapters": {}}}.get(
                self.path.split("?")[0], replica_report)
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    fleet = f"127.0.0.1:{srv.server_address[1]},127.0.0.1:{free_port()}"
    kw = dict(fleet=fleet, remote_connect_timeout_s=1.0,
              remote_read_timeout_s=2.0, remote_max_retries=0)
    try:
        fresh["snap"] = json.loads(json.dumps(JMetrics().snapshot()))
        jserver = JMegatronServer(None, object(),
                                  serving=jconfig.ServingConfig(**kw))
        try:
            want = jserver.invariant_report(strict=False)
        finally:
            jserver.engine.close()
        fresh["snap"] = json.loads(json.dumps(ServingMetrics().snapshot()))
        server = MegatronServer(None, object(), serving=ServingConfig(**kw))
        try:
            got = server.invariant_report(strict=False)
            assert server.healthz()[0] == 200
            assert server.affinity_digest()["granularity"] == 16
        finally:
            server.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert got == want
    assert got["unreachable"] == [fleet.split(",")[1]] and not got["ok"]


# ---------------------------------------------------------------------
# a front tier over two port replica servers
# ---------------------------------------------------------------------
def _put(port, payload, headers=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json",
                               **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _frames(text):
    out = []
    for block in text.strip().split("\n\n"):
        f = {}
        for line in block.split("\n"):
            k, _, v = line.partition(": ")
            f[k] = v
        f["data"] = json.loads(f["data"])
        out.append(f)
    return out


def test_front_tier_over_port_replicas(tiny):
    """Two replica servers over one tiny Generator and a front tier that
    holds no weights: text in, `prompt_tokens` over the wire, the tokens
    of the serial route out; an SSE stream through both hops; the router's
    merged digest and each replica's GET /affinity; the fleet's strict
    invariant sweep; a replica closed under traffic fails over."""
    jcfg, jgen, tcfg, tgen = tiny
    replicas = [MegatronServer(tgen, IntTokenizer(), device="cpu",
                               serving=ServingConfig(replica_mode=True,
                                                     **REPLICA))
                for _ in range(2)]
    served = [_serve_port(r) for r in replicas]
    addrs = ",".join("127.0.0.1:%d" % h.server_address[1]
                     for h, _ in served)
    front = MegatronServer(None, IntTokenizer(), serving=ServingConfig(
        fleet=addrs, remote_read_timeout_s=30.0,
        remote_digest_interval_s=0.01, router_heartbeat_timeout_s=1.0))
    fhttpd, fthread = _serve_port(front)
    fport = fhttpd.server_address[1]
    try:
        assert front.generator is None
        assert _get(fport, "/healthz")["replicas_up"] == 2
        text = " ".join(map(str, PROMPTS[1]))
        status, body = _put(fport, {"prompts": [text],
                                    "tokens_to_generate": NEW,
                                    "temperature": 0.0, "logprobs": True})
        assert status == 200
        body = json.loads(body)
        want = _jax_serial(jgen, PROMPTS[1])
        assert body["segments"][0] == want
        assert len(body["logprobs"][0]) == len(want)
        status, text_sse = _put(fport, {"prompts": [text],
                                        "tokens_to_generate": NEW,
                                        "temperature": 0.0, "stream": True})
        fs = _frames(text_sse)
        assert fs[0]["event"] == "start" and fs[-1]["event"] == "done"
        toks = [f["data"]["token"] for f in fs if f.get("event") == "token"]
        assert [int(f["id"]) for f in fs if f.get("event") == "token"] \
            == list(range(NEW))
        assert PROMPTS[1] + toks == want == fs[-1]["data"]["segments"]
        time.sleep(0.05)
        front.engine.health()
        merged = front.engine.affinity_digest()
        assert tremote.digest_peek(merged, PROMPTS[1] + [3]) == 16
        assert any(_get(h.server_address[1], "/affinity")["namespaces"]
                   for h, _ in served)
        inv = _get(fport, "/invariants?strict=1")
        assert inv["ok"] and inv["engines"] == 2, inv
        snap = _get(fport, "/metrics")
        assert snap["fleet_replicas_up"] == 2.0
        assert snap["requests_completed"] >= 2
        # a replica closed under traffic: the front tier fails over
        reqs = [front.engine.submit(p, NEW, GREEDY, seed=i)
                for i, p in enumerate(PROMPTS)]
        victim = reqs[0].replica.idx
        httpd, thread = served[victim]
        httpd.shutdown()
        httpd.server_close()
        replicas[victim].close()
        got = [r.result(timeout=120)[0] for r in reqs]
        assert got == [_jax_serial(jgen, p) for p in PROMPTS]
        h = _get(fport, "/healthz")
        assert h["accepting"] and h["replicas_up"] == 1
        inv = _get(fport, "/invariants")
        assert inv["unreachable"] == [addrs.split(",")[victim]]
    finally:
        _stop(fhttpd, fthread, front)
        for (httpd, thread), r in zip(served, replicas):
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            r.close()


def test_front_tier_refuses_local_routes():
    front = MegatronServer(None, _CharTok(), serving=ServingConfig(
        fleet=f"127.0.0.1:{free_port()}", remote_connect_timeout_s=0.5))
    try:
        for p, msg in (({"prompts": ["a"], "serial": True},
                        "the serial route forwards locally"),
                       ({"prompts": ["a"], "beam_width": 2},
                        "beam search forwards locally"),
                       ({"prompt_tokens": [[1]]}, "replica-mode wire")):
            status, body = front.handle(p)
            assert status == 400 and msg in body["message"], body
    finally:
        front.close()
    with pytest.raises(ValueError, match="fleet front tier"):
        MegatronServer(None, _CharTok(), serving=ServingConfig())


def test_fleet_admin_over_the_wire(tiny, tmp_path):
    """The control plane across the process boundary: a front tier's
    `PUT /admin` swap walks a rolling upgrade over two replica servers,
    each staging the checkpoint itself (nothing staged in the front tier);
    a corrupt publish answers 409 and the fleet serves on; the new
    weights' greedy tokens equal JAX's serial route on them; a drain
    reaches every replica."""
    import glob
    import os

    from megatron_tpu_torch.training import checkpointing as t_ckpt
    from megatron_tpu_torch.training.train_step import TrainState
    jcfg, jgen, tcfg, tgen = tiny
    params2 = jlm.model_init(jax.random.PRNGKey(1), jcfg)
    model2 = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params2), tcfg, device="cpu"))

    def publish(iteration):
        return t_ckpt.save_checkpoint(
            str(tmp_path), TrainState(params=model2, opt_state=None,
                                      iteration=iteration),
            tconfig.MegatronConfig(model=tcfg), iteration)

    good = publish(2)
    bad = publish(3)
    payload = max((p for p in glob.glob(os.path.join(bad, "**"),
                                        recursive=True)
                   if os.path.isfile(p)
                   and os.path.basename(p) != "manifest.json"),
                  key=os.path.getsize)
    with open(payload, "r+b") as f:
        b0 = f.read(1)
        f.seek(0)
        f.write(bytes([b0[0] ^ 0xFF]))
    replicas = [MegatronServer(tgen, IntTokenizer(), device="cpu",
                               serving=ServingConfig(replica_mode=True,
                                                     **REPLICA))
                for _ in range(2)]
    served = [_serve_port(r) for r in replicas]
    front = MegatronServer(None, IntTokenizer(), serving=ServingConfig(
        fleet=",".join("127.0.0.1:%d" % h.server_address[1]
                       for h, _ in served), remote_read_timeout_s=60.0))
    try:
        status, body = front.handle_admin({"op": "swap_weights",
                                           "ckpt_dir": bad})
        assert status == 409, body
        text = {"prompts": ["5 17 3 42"], "tokens_to_generate": NEW,
                "temperature": 0.0}
        status, body = front.handle(dict(text))
        assert status == 200
        assert body["segments"][0] == _jax_serial(jgen, PROMPTS[0])
        status, body = front.handle_admin({"op": "swap_weights",
                                           "ckpt_dir": good})
        assert status == 200 and body["iteration"] == 2, body
        jgen2 = JGenerator(params2, jcfg, eos_id=-1, pad_id=0,
                           kv_cache_dtype=jnp.float32)
        for _ in range(2):  # whichever replica serves it
            status, body = front.handle(dict(text))
            assert body["segments"][0] == _jax_serial(jgen2, PROMPTS[0])
        snap = front.metrics_snapshot()
        assert snap["weight_swaps"] == 2 and snap["rolling_upgrades"] == 1
        assert snap["weight_version_min"] == snap["weight_version_max"] == 2
        assert front.handle_admin({"op": "drain", "timeout": 30}) \
            == (200, {"drained": True})
        assert all(not r.engine.health()["accepting"] for r in replicas)
    finally:
        front.close()
        for (httpd, thread), r in zip(served, replicas):
            _stop(httpd, thread, r)


def test_grammar_dead_end_over_the_wire_is_not_retried():
    """A replica's typed 422 stream error reaches the router as the
    in-process engine's GrammarDeadEndError, and the router settles it as
    the reference does (the same grammar, prompt and seed dead-end on every
    replica) instead of resubmitting it."""
    from megatron_tpu_torch.serving import GrammarDeadEndError
    puts = []
    health = {"healthy": True, "accepting": True, "state": "running",
              "loop_alive": True, "queue_depth": 0, "max_len": 64}

    class Handler(http.server.BaseHTTPRequestHandler):
        def _json(self, body):
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._json(health if self.path == "/healthz" else
                       {"granularity": 0, "namespaces": {}, "adapters": {}})

        def do_PUT(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            puts.append(self.path)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(
                b'event: start\ndata: {"stream_id": "s1"}\n\n'
                b'id: 0\nevent: token\ndata: {"index": 0, "token": 7}\n\n'
                b'event: error\ndata: {"status": 422, "message": '
                b'"grammar dead end"}\n\n')

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    counters = ServingMetrics()
    reps = [tremote.RemoteReplica(f"127.0.0.1:{srv.server_address[1]}",
                                  counters=counters, read_timeout_s=5.0)
            for _ in range(2)]
    router = EngineRouter(reps, metrics=counters)
    try:
        req = router.submit([1, 2, 3], 4, GREEDY)
        with pytest.raises(GrammarDeadEndError, match="grammar dead end"):
            req.result(timeout=30)
        assert req.generated == [7]
        assert puts == ["/api"]
        assert counters.snapshot()["router_retries"] == 0
    finally:
        router.close()
        srv.shutdown()
        srv.server_close()
