"""The port's tools/serving_bench.py against the reference's tool: the same
record keys in the in-process engine mode, the overload mode and the
`--url` mode (both tools driving one port server over HTTP), and the
`--stream` records of a fleet front tier with TTFT and inter-token
percentiles beside them. Tiny shapes, CPU."""
import json
import os
import runpy
import sys
import threading

import pytest
import torch

from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.tools import serving_bench
from megatron_tpu_torch.tools.chaos_common import (IntTokenizer,
                                                   tiny_model_cfg)

torch.set_num_threads(2)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
SHAPE = ["--layers", "2", "--hidden", "64", "--heads", "4", "--vocab",
         "128", "--seq", "128"]


def _jax_record(monkeypatch, tmp_path, argv):
    out = tmp_path / "jax.log"
    monkeypatch.setattr(sys, "argv", ["serving_bench.py", "--out", str(out)]
                        + argv)
    try:
        runpy.run_path(os.path.join(TOOLS, "serving_bench.py"),
                       run_name="__main__")
    except SystemExit as e:
        assert not e.code
    return json.loads(out.read_text())


def _port_record(tmp_path, argv):
    out = tmp_path / "port.log"
    assert serving_bench.main(["--out", str(out)] + argv, device="cpu") == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("argv", [
    ["--requests", "6", "--slots", "2", "--prompt", "12", "--new", "6"],
    ["--overload", "--requests", "12", "--slots", "2", "--prompt", "12",
     "--new", "6", "--deadline", "2.0"],
], ids=["engine", "overload"])
def test_in_process_records_have_the_references_keys(monkeypatch, tmp_path,
                                                     argv):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    got = _port_record(tmp_path, argv + SHAPE)
    want = _jax_record(monkeypatch, tmp_path, argv + SHAPE)
    assert sorted(got) == sorted(want)
    assert got["bench"] == "serving" and got["mode"] == want["mode"]
    if got["mode"] == "engine":
        assert got["tokens_per_s"] > 0
        assert got["ttft_p95_ms"] >= got["ttft_p50_ms"] >= 0
        assert 0 < got["slot_occupancy"] <= 1
        assert got["decode_steps"] >= 6
    else:
        served = round(got["goodput_frac"] * got["requests"])
        assert got["shed"] + got["expired_504"] + served == got["requests"]
        assert got["queue_wait_p99_ms"] >= got["queue_wait_p50_ms"] >= 0


class _CharTok:
    """Text prompts for the front door (the tools send English text)."""
    eod = 0
    bos = None

    def tokenize(self, text):
        return [1 + ord(c) % 120 for c in text]

    def detokenize(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _serve(server):
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def _stop(httpd, thread, server):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    server.close()


@pytest.fixture(scope="module")
def tiny_gen():
    cfg = tiny_model_cfg()
    return Generator(LanguageModel(cfg, device="cpu", seed=0), cfg,
                     eos_id=-1, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


URL_ARGS = ["--requests", "6", "--prompt", "16", "--new", "4"]


def test_url_record_has_the_references_keys(monkeypatch, tmp_path,
                                            tiny_gen):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    server = MegatronServer(tiny_gen, _CharTok(), device="cpu",
                            serving=ServingConfig(num_slots=4,
                                                  max_queue=32))
    httpd, thread = _serve(server)
    try:
        url = ["--url", "127.0.0.1:%d" % httpd.server_address[1]]
        got = _port_record(tmp_path, url + URL_ARGS)
        want = _jax_record(monkeypatch, tmp_path, url + URL_ARGS)
    finally:
        _stop(httpd, thread, server)
    assert sorted(got) == sorted(want)
    for rec in (got, want):
        assert rec["mode"] == "http" and rec["completed"] == 6
        assert rec["failed"] == 0 and rec["rejected_429"] == 0
        assert rec["tokens_per_s"] > 0
        assert rec["latency_p95_ms"] >= rec["latency_p50_ms"] > 0


def test_stream_records_through_a_fleet_front_tier(tmp_path, tiny_gen):
    """`--stream --vary_prompts` against a front tier over two replica
    servers and over one: every request completes, and the record adds
    TTFT p50/p99 and the inter-token p50 to the reference's keys."""
    replicas = [MegatronServer(tiny_gen, IntTokenizer(), device="cpu",
                               serving=ServingConfig(
                                   replica_mode=True, num_slots=4,
                                   max_queue=32, kv_block_size=16,
                                   enable_prefix_cache=True))
                for _ in range(2)]
    served = [_serve(r) for r in replicas]
    addrs = ["127.0.0.1:%d" % h.server_address[1] for h, _ in served]
    records = {}
    try:
        for label, fleet in (("two", addrs), ("one", addrs[:1])):
            front = MegatronServer(None, _CharTok(),
                                   serving=ServingConfig(
                                       fleet=",".join(fleet)))
            fh, ft = _serve(front)
            try:
                records[label] = _port_record(tmp_path, [
                    "--url", "127.0.0.1:%d" % fh.server_address[1],
                    "--stream", "--vary_prompts"] + URL_ARGS)
            finally:
                _stop(fh, ft, front)
    finally:
        for (h, t), r in zip(served, replicas):
            _stop(h, t, r)
    for rec in records.values():
        assert rec["mode"] == "http_stream"
        assert rec["completed"] == 6 and rec["failed"] == 0
        assert rec["tokens_per_s"] > 0
        assert rec["ttft_p99_ms"] >= rec["ttft_p50_ms"] > 0
        assert rec["itl_p50_ms"] >= 0
        assert {"ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms"} < set(rec)
