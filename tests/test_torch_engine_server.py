"""The port's MegatronServer on its engine route, over real HTTP on
127.0.0.1: the engine route equals the `"serial": true` route for greedy
payloads, a short request sent after a long one returns first, a full
queue and early shedding answer 429 with Retry-After, the fields of later slices get 400s,
a `"stream": true` payload is answered as server-sent events with the
engine route's tokens, a cancel over HTTP ends its stream and frees its
slot, and /healthz and /metrics answer from the engine."""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel

torch.set_num_threads(2)


class CharTokenizer:
    vocab_size = 128
    eod = 0
    bos = 1

    def tokenize(self, text):
        return [2 + (ord(c) % 120) for c in text]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def _serve(serving):
    cfg = tconfig.llama2_config("tiny", attention_impl="flash",
                                compute_dtype="float32")
    model = LanguageModel(cfg, device="cpu", seed=0)
    # eos outside the prompts' and the model's likely range, so generation
    # runs to its token budget
    gen = Generator(model, cfg, eos_id=cfg.vocab_size - 1, pad_id=0,
                    device="cpu", kv_cache_dtype=torch.float32)
    server = MegatronServer(gen, CharTokenizer(), serving=serving,
                            device="cpu")
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return server, httpd, thread


def _stop(server, httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    server.close()


def _put(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def block_server():
    served = _serve(ServingConfig(num_slots=2, max_queue=8, max_len=256,
                                  kv_block_size=16, block_native_attn=True))
    yield served[0], served[1].server_address[1]
    _stop(*served)


def test_engine_route_equals_serial_route(block_server):
    _, port = block_server
    payload = {"prompts": ["hello world, again", "hi", "a longer prompt "
               "that spans two blocks"], "tokens_to_generate": 12,
               "temperature": 0.0, "logprobs": True}
    status, engine, _ = _put(port, payload)
    assert status == 200
    status, serial, _ = _put(port, dict(payload, serial=True))
    assert status == 200
    assert engine["segments"] == serial["segments"]
    assert engine["text"] == serial["text"]
    for lps, seg in zip(engine["logprobs"], engine["segments"]):
        assert len(lps) == len(seg)
        assert all(x == x and abs(x) != float("inf") for x in lps)


def test_short_request_returns_before_long(block_server):
    _, port = block_server
    done = {}

    def send(name, n):
        _put(port, {"prompts": [f"request {name}"], "tokens_to_generate": n,
                    "temperature": 0.0})
        done[name] = time.monotonic()

    long_t = threading.Thread(target=send, args=("long", 120))
    long_t.start()
    time.sleep(0.3)
    send("short", 2)
    long_t.join(timeout=120)
    assert done["short"] < done["long"]


LATER = {
    "n": {"prompts": ["hi"], "n": 2},
    "best_of": {"prompts": ["hi"], "best_of": 3},
    "response_format": {"prompts": ["hi"],
                        "response_format": {"type": "regex",
                                            "pattern": "a+"}},
    "adapter_id": {"prompts": ["hi"], "adapter_id": "a"},
    "prompt_tokens": {"prompt_tokens": [[5, 6]]},
}
# the fields whose slice has come: still a 400 on this adapterless engine,
# now saying why
LATER_PORTED = {"adapter_id": "serving no adapters"}


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_slice_fields_are_400(block_server, name):
    _, port = block_server
    status, body, _ = _put(port, LATER[name])
    assert status == 400
    assert LATER_PORTED.get(name, "later slice") in body["message"]


def _open_stream(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _read_frame(resp):
    """The next SSE frame off the socket as (event, id, data)."""
    fields = {}
    while True:
        line = resp.readline().decode()
        if line in ("\n", ""):
            break
        k, _, v = line.rstrip("\n").partition(": ")
        fields[k] = v
    return (fields.get("event"), fields.get("id"),
            json.loads(fields["data"]) if "data" in fields else None)


def test_stream_over_http_equals_engine_route(block_server):
    _, port = block_server
    payload = {"prompts": ["stream me over http"], "tokens_to_generate": 12,
               "temperature": 0.0}
    with _open_stream(port, dict(payload, stream=True)) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/event-stream"
        got = []
        while True:
            event, eid, data = _read_frame(resp)
            got.append((event, eid, data))
            if event in ("done", "error"):
                break
    assert got[0][0] == "start" and got[-1][0] == "done"
    tokens = [d["token"] for e, _, d in got if e == "token"]
    assert [int(i) for e, i, _ in got if e == "token"] == list(range(12))
    status, body, _ = _put(port, payload)
    assert status == 200
    assert tokens == body["segments"][0][-12:]
    assert got[-1][2]["segments"] == body["segments"][0]


def test_cancel_over_http_ends_the_stream(block_server):
    server, port = block_server
    with _open_stream(port, {"prompts": ["cancel me"],
                             "tokens_to_generate": 200,
                             "temperature": 0.0, "stream": True}) as resp:
        event, _, start = _read_frame(resp)
        assert event == "start"
        for _ in range(3):
            assert _read_frame(resp)[0] == "token"
        status, ack, _ = _put(port, {"stream_id": start["stream_id"],
                                     "cancel": True})
        assert status == 200 and ack["cancelled"] is True
        while True:
            event, _, data = _read_frame(resp)
            if event != "token":
                break
    assert event == "error" and data["committed"] < 200
    give_up = time.monotonic() + 30
    while server.engine.health()["active_slots"]:
        assert time.monotonic() < give_up
        time.sleep(0.01)
    assert _get(port, "/metrics")[1]["requests_cancelled"] >= 1


def test_admission_errors_health_and_metrics(block_server):
    _, port = block_server
    assert _put(port, {})[:2] == (400, {"message":
                                        "prompts argument required"})
    status, body, _ = _put(port, {"prompts": ["x" * 200],
                                  "tokens_to_generate": 100})
    assert status == 400 and "max_len=256" in body["message"]
    status, health = _get(port, "/healthz")
    assert status == 200 and health["state"] == "running"
    assert health["num_slots"] == 2 and health["kv_attn_path"] == 2
    status, metrics = _get(port, "/metrics")
    assert status == 200 and metrics["kv_attn_path"] == 2.0
    assert metrics["requests_completed"] >= 1
    # every earlier request has returned, so the engine is quiet
    assert metrics["requests_received"] == (
        metrics["requests_completed"] + metrics["requests_rejected"]
        + metrics["requests_failed"] + metrics["requests_cancelled"]
        + metrics["requests_expired"])
    assert metrics["ttft_p50_ms"] > 0 and metrics["itl_p50_ms"] > 0


def test_full_queue_is_429_with_retry_after():
    served = _serve(ServingConfig(num_slots=1, max_queue=1, max_len=256))
    server, httpd, _ = served
    port = httpd.server_address[1]
    try:
        threads = [threading.Thread(target=_put, args=(
            port, {"prompts": [f"busy {i}"], "tokens_to_generate": 240,
                   "temperature": 0.0})) for i in range(2)]

        def wait_for(cond):
            give_up = time.monotonic() + 60
            while not cond():
                assert time.monotonic() < give_up
                time.sleep(0.01)

        threads[0].start()
        wait_for(lambda: server.engine.health()["active_slots"])
        threads[1].start()
        wait_for(lambda: server.engine.queue_depth() >= 1)
        status, body, headers = _put(port, {"prompts": ["one more"],
                                            "tokens_to_generate": 2})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        assert body["retry_after"] >= 1 and body["queue_depth"] == 1
        for t in threads:
            t.join(timeout=120)
    finally:
        _stop(*served)


def test_early_shedding_is_429_with_retry_after():
    served = _serve(ServingConfig(num_slots=1, max_queue=4, max_len=256,
                                  shed_on_overload=True))
    server, httpd, _ = served
    port = httpd.server_address[1]
    try:
        # one completion seeds the service-time estimate (never shed blind)
        assert _put(port, {"prompts": ["warm"], "tokens_to_generate": 8,
                           "temperature": 0.0})[0] == 200
        busy = threading.Thread(target=_put, args=(
            port, {"prompts": ["busy"], "tokens_to_generate": 200,
                   "temperature": 0.0}))
        busy.start()
        give_up = time.monotonic() + 60
        while not server.engine.health()["active_slots"]:
            assert time.monotonic() < give_up
            time.sleep(0.01)
        # the slot's observed service time already exceeds this deadline
        status, body, headers = _put(port, {"prompts": ["late"],
                                            "tokens_to_generate": 4,
                                            "deadline_s": 1e-4})
        assert status == 429 and "shed early" in body["message"]
        assert int(headers["Retry-After"]) >= 1 and body["retry_after"] >= 1
        busy.join(timeout=120)
        snap = server.engine.metrics.snapshot()
        assert snap["requests_shed"] == 1 and snap["requests_rejected"] == 1
    finally:
        _stop(*served)
