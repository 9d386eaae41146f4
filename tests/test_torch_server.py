"""The port's server in serial mode against the JAX package's
(ServingConfig(serial_fallback=True) on both): the same statuses and
messages for the same payloads, and the same greedy text, over the same
weights. The engine route is tests/test_torch_engine_server.py's."""
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.config import ServingConfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.inference.server import MegatronServer as JServer
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel

torch.set_num_threads(2)


class FakeTokenizer:
    vocab_size = 96
    eod = 0
    bos = 1

    def tokenize(self, text):
        return [2 + (ord(c) % 90) for c in text][:16]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def servers():
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    jserver = JServer(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                      FakeTokenizer(),
                      serving=ServingConfig(serial_fallback=True))
    tserver = MegatronServer(
        Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu"),
        FakeTokenizer(), serving=tconfig.ServingConfig(serial_fallback=True),
        device="cpu")
    yield jserver, tserver
    jserver.close()


REFUSED = {
    "empty": {},
    "not_a_dict": ["hello"],
    "empty_prompt": {"prompts": [""]},
    "oversize": {"prompts": ["hello"], "tokens_to_generate": 600},
    "negative_tokens": {"prompts": ["hi"], "tokens_to_generate": -1},
    "bad_temperature": {"prompts": ["hi"], "temperature": "hot"},
    "stream": {"prompts": ["hi"], "stream": True},
    "n_gt_1": {"prompts": ["hi"], "n": 2},
    "best_of": {"prompts": ["hi"], "best_of": 3},
    "response_format": {"prompts": ["hi"],
                        "response_format": {"type": "regex",
                                            "pattern": "a+"}},
    "bad_response_format": {"prompts": ["hi"],
                            "response_format": {"type": "xml"}},
    "adapter_id": {"prompts": ["hi"], "adapter_id": "a"},
    "prompt_tokens": {"prompt_tokens": [[5, 6]]},
    "cancel": {"stream_id": "s", "cancel": True},
    "multi_prompt_beam": {"prompts": ["a", "b"], "beam_width": 2},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_jax(servers, name):
    jserver, tserver = servers
    want = jserver.handle(REFUSED[name])
    got = tserver.handle(REFUSED[name])
    assert got == want
    assert got[0] == 400


def test_greedy_and_beam_match_jax(servers):
    jserver, tserver = servers
    payload = {"prompts": ["hello world", "hi"], "tokens_to_generate": 6,
               "temperature": 0.0, "logprobs": True}
    ws, wb = jserver.handle(payload)
    gs, gb = tserver.handle(payload)
    assert gs == ws == 200
    assert gb["text"] == wb["text"] and gb["segments"] == wb["segments"]
    for g, w in zip(gb["logprobs"], wb["logprobs"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    beam = {"prompts": ["hello"], "beam_width": 2, "tokens_to_generate": 3}
    ws, wb = jserver.handle(beam)
    gs, gb = tserver.handle(beam)
    assert gs == ws == 200 and gb["text"] == wb["text"]
    np.testing.assert_allclose(gb["score"], wb["score"], rtol=1e-4,
                               atol=1e-4)


def test_put_over_stdlib_http(servers):
    _, tserver = servers
    httpd = tserver.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        def put(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(), method="PUT",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        status, body = put("/api", {"prompts": ["hi"],
                                    "tokens_to_generate": 2,
                                    "temperature": 0.0})
        assert status == 200 and len(body["text"]) == 1
        assert len(body["segments"][0]) == 4
        assert put("/api", {}) == (400, {"message":
                                         "prompts argument required"})
        assert put("/admin", {})[0] == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["serving"] == "serial"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
