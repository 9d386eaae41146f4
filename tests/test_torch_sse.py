"""SSE streaming and cancel on the port's MegatronServer, against the JAX
server's own frames.

The reference's `TestSSEStreaming::test_stream_matches_completed_future`
fails on the reference itself (its tiny model ends at EOS after 2 tokens
while the test slices 8), so its verdict is no oracle: here the port's
frames (event names, ids, tokens, texts, logprobs within 1e-4) are held
against the JAX server's frames for the same greedy payload, and the
port's streamed tokens against its own whole completion of the same seeded
payload. Also: a resume with Last-Event-ID (nothing duplicated or missing,
`stream_reconnects` counted), the 404/400 statuses of bad stream and
cancel payloads equal to JAX's, the serial-fallback refusals, a deadline's
typed `error` event (504, with `committed`), the stdlib transport end to
end, a cancel that frees the slot, and a stream through the router that
fails over to the survivor mid-stream with the same tokens.
"""
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.inference.server import MegatronServer as JMegatronServer
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel

torch.set_num_threads(2)
TOL = 1e-4
SERVING = dict(num_slots=2, max_queue=16, max_len=64)


class FakeTokenizer:
    vocab_size = 96
    eod = 0
    bos = 1

    def tokenize(self, text):
        return [2 + (ord(c) % 90) for c in text][:16]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def frames(body):
    """Parse SSE text (or the generator's chunks) into frame dicts."""
    out = []
    for block in "".join(body).strip().split("\n\n"):
        f = {}
        for line in block.split("\n"):
            k, _, v = line.partition(": ")
            f.setdefault(k, v)
        f["data"] = json.loads(f["data"])
        out.append(f)
    return out


def tokens_of(fs):
    return [f["data"]["token"] for f in fs if f.get("event") == "token"]


@pytest.fixture(scope="module")
def tiny():
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    # eos past the tokenizer's ids and unlikely as a sample, so streams run
    # to their token budget
    eos = tcfg.vocab_size - 1
    return jcfg, params, tcfg, model, eos


@pytest.fixture(scope="module")
def servers(tiny):
    jcfg, params, tcfg, model, eos = tiny
    jsrv = JMegatronServer(JGenerator(params, jcfg, eos_id=eos, pad_id=0),
                           FakeTokenizer(),
                           serving=jconfig.ServingConfig(**SERVING))
    srv = MegatronServer(Generator(model, tcfg, eos_id=eos, pad_id=0,
                                   device="cpu"),
                         FakeTokenizer(), serving=ServingConfig(**SERVING),
                         device="cpu")
    yield jsrv, srv
    jsrv.close()
    srv.close()


PAYLOAD = {"prompts": ["hello"], "tokens_to_generate": 10,
           "temperature": 0.0, "random_seed": 7, "stream": True}


def test_frames_equal_jax_server_frames(servers):
    jsrv, srv = servers
    (jstatus, jbody), (status, body) = (s.handle(dict(PAYLOAD))
                                        for s in (jsrv, srv))
    assert status == jstatus == 200
    want, got = frames(jbody), frames(body)
    assert [f.get("event") for f in got] == [f.get("event") for f in want]
    assert [f.get("id") for f in got] == [f.get("id") for f in want]
    assert got[0]["event"] == "start" and got[-1]["event"] == "done"
    assert sorted(got[0]["data"]) == sorted(want[0]["data"])
    assert got[0]["data"]["resumed"] is False
    assert len(tokens_of(got)) == 10
    for g, w in zip(got[1:-1], want[1:-1]):
        for key in ("index", "token", "text"):
            assert g["data"][key] == w["data"][key], key
        np.testing.assert_allclose(g["data"]["logprob"],
                                   w["data"]["logprob"], rtol=TOL, atol=TOL)
    assert got[-1]["data"]["segments"] == want[-1]["data"]["segments"]
    assert got[-1]["data"]["text"] == want[-1]["data"]["text"]


def test_stream_equals_whole_completion(servers):
    _, srv = servers
    payload = dict(PAYLOAD, prompts=["a sampled one"], temperature=0.9,
                   top_k=5, random_seed=21, tokens_to_generate=12)
    streamed = frames(srv.handle(dict(payload))[1])
    status, whole = srv.handle({k: v for k, v in payload.items()
                                if k != "stream"})
    assert status == 200
    seg = whole["segments"][0]
    assert tokens_of(streamed) == seg[len(seg) - 12:]
    assert streamed[-1]["data"]["segments"] == seg


def test_resume_with_last_event_id(servers):
    jsrv, srv = servers
    results = []
    for s in (jsrv, srv):
        before = s.metrics_snapshot()["stream_reconnects"]
        fs = frames(s.handle(dict(PAYLOAD, prompts=["resume me"]))[1])
        sid = fs[0]["data"]["stream_id"]
        # the client dropped after event id 2
        status, body = s.handle({"stream": True, "stream_id": sid},
                                headers={"Last-Event-ID": "2"})
        assert status == 200
        again = frames(body)
        assert again[0]["data"]["resumed"] is True
        assert again[0]["data"]["next_index"] == 3
        ids = [int(f["id"]) for f in again if f.get("event") == "token"]
        assert ids == list(range(3, len(tokens_of(fs))))
        assert tokens_of(again) == tokens_of(fs)[3:]
        assert again[-1]["event"] == "done"
        assert s.metrics_snapshot()["stream_reconnects"] == before + 1
        results.append(tokens_of(fs))
    assert results[0] == results[1]


BAD = [
    ({"stream": True, "stream_id": "nope"}, None),
    ({"prompts": ["a", "b"], "stream": True}, None),
    ({"prompts": ["a"], "beam_width": 2, "stream": True}, None),
    ({"stream": True, "stream_id": "nope"}, {"Last-Event-ID": "x"}),
    ({"cancel": True}, None),
    ({"cancel": True, "stream_id": "gone"}, None),
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_statuses_equal_jax(servers, i):
    payload, headers = BAD[i]
    (jstatus, jbody), (status, body) = (
        s.handle(dict(payload), headers=headers) for s in servers)
    assert status == jstatus and status in (200, 400, 404)
    assert body == jbody


def test_serial_fallback_refuses_stream_and_cancel(tiny):
    jcfg, params, tcfg, model, eos = tiny
    jsrv = JMegatronServer(JGenerator(params, jcfg, eos_id=eos, pad_id=0),
                           FakeTokenizer(),
                           serving=jconfig.ServingConfig(serial_fallback=True))
    srv = MegatronServer(Generator(model, tcfg, eos_id=eos, pad_id=0,
                                   device="cpu"), FakeTokenizer(),
                         serving=ServingConfig(serial_fallback=True),
                         device="cpu")
    for payload in ({"prompts": ["x"], "stream": True},
                    {"stream_id": "s", "cancel": True}):
        (jstatus, jbody), (status, body) = (s.handle(dict(payload))
                                            for s in (jsrv, srv))
        assert status == jstatus == 400 and body == jbody
        assert "engine" in body["message"]


def test_deadline_is_a_typed_error_event(servers):
    for s in servers:
        status, body = s.handle(
            {"prompts": ["doomed"], "tokens_to_generate": 48,
             "temperature": 0.0, "random_seed": 13, "deadline_s": 0.02,
             "stream": True})
        assert status == 200  # the stream opened; the failure is in-band
        fs = frames(body)
        assert fs[-1]["event"] == "error"
        assert fs[-1]["data"]["status"] == 504
        assert fs[-1]["data"]["retryable"] is False
        assert fs[-1]["data"]["committed"] == len(tokens_of(fs))


def _serve_http(srv):
    httpd = srv.make_http_server("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


def test_stdlib_sse_end_to_end(servers):
    _, srv = servers
    httpd, t = _serve_http(srv)
    try:
        port = httpd.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api",
            data=json.dumps(dict(PAYLOAD, tokens_to_generate=4)).encode(),
            method="PUT", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            assert resp.headers.get("Content-Type") == "text/event-stream"
            text = resp.read().decode()
        fs = frames([text])
        assert fs[0]["event"] == "start" and fs[-1]["event"] == "done"
        assert len(tokens_of(fs)) == 4
        # a resume over HTTP, the header on the request
        sid = fs[0]["data"]["stream_id"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api",
            data=json.dumps({"stream": True, "stream_id": sid}).encode(),
            method="PUT", headers={"Last-Event-ID": "1"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            again = frames([resp.read().decode()])
        assert tokens_of(again) == tokens_of(fs)[2:]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_cancel_frees_the_slot(tiny):
    _, _, tcfg, model, eos = tiny
    srv = MegatronServer(Generator(model, tcfg, eos_id=eos, pad_id=0,
                                   device="cpu"), FakeTokenizer(),
                         serving=ServingConfig(num_slots=2, max_len=512,
                                               kv_block_size=16,
                                               block_native_attn=True),
                         device="cpu")
    eng = srv.engine
    try:
        status, body = srv.handle(dict(PAYLOAD, tokens_to_generate=400))
        start = next(body)
        sid = json.loads(start.split("data: ")[1])["stream_id"]
        seen = [next(body) for _ in range(5)]
        assert all("event: token" in f for f in seen)
        assert eng.health()["active_slots"] == 1
        status, ack = srv.handle({"stream_id": sid, "cancel": True})
        assert status == 200 and ack == {"cancelled": True,
                                          "stream_id": sid}
        rest = frames(list(body))
        assert rest[-1]["event"] == "error"
        assert rest[-1]["data"]["status"] == 500
        give_up = time.monotonic() + 30
        while eng.health()["active_slots"] or eng.pool.free_rows() != 2:
            assert time.monotonic() < give_up
            time.sleep(0.01)
        assert srv.metrics_snapshot()["requests_cancelled"] == 1
        # every block back in the free pool (the gauge is pushed by the
        # next step, so the pool's own accounting is read)
        assert eng.pool.kv_gauges(eng._lengths)[0] == 0
        assert 5 <= rest[-1]["data"]["committed"] < 400
    finally:
        srv.close()


def test_stream_fails_over_to_the_survivor(tiny):
    _, _, tcfg, model, eos = tiny
    gen = Generator(model, tcfg, eos_id=eos, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    srv = MegatronServer(gen, FakeTokenizer(), serving=ServingConfig(
        num_slots=2, max_len=128, kv_block_size=16, block_native_attn=True,
        num_replicas=2, router_heartbeat_timeout_s=2.0), device="cpu")
    try:
        payload = dict(PAYLOAD, prompts=["fail over"], tokens_to_generate=60)
        status, body = srv.handle(dict(payload))
        got = [next(body) for _ in range(6)]
        rreq = next(iter(srv._streams.values())).req
        rreq.replica.engine.close()  # the kill, mid-stream
        got += list(body)
        fs = frames(got)
        assert fs[-1]["event"] == "done"
        ids = [int(f["id"]) for f in fs if f.get("event") == "token"]
        assert ids == list(range(60))
        status, whole = srv.handle({k: v for k, v in payload.items()
                                    if k != "stream"})
        seg = whole["segments"][0]
        assert tokens_of(fs) == seg[len(seg) - 60:]
        snap = srv.metrics_snapshot()
        assert snap["router_failovers"] == 1 and snap["router_retries"] == 1
    finally:
        srv.close()
