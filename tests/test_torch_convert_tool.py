"""The slice as a whole on the CPU: the port's weight toolchain beside the
JAX package's tools on the same files.

- A tiny HF Llama directory (`save_pretrained`, safetensors, at the JAX
  tool's "tiny" preset) goes through the port's
  tools/convert_hf_checkpoint.py and through the root one (its release
  saved with backend="npz": the root tool's default orbax exists only with
  JAX). The two checkpoints hold the same leaves bit for bit, and each
  package reads the other's: the port's `load_npz_checkpoint` the JAX one,
  JAX's `load_checkpoint` the port's. An export of the port's checkpoint equals
  the HF tensors, and its re-import the first import.
- The port's CLI server (run_text_generation_server.main, device "cpu",
  127.0.0.1, GPT-2 BPE tokenizer files) answers greedy requests on the
  engine route (16-token blocks) and the serial route with the tokens JAX's
  Generator gives on the same checkpoint in fp32; text_generation_cli gets
  an answer from it.
- The server's flags of later slices raise NotImplementedError naming
  their ROADMAP item.
- A numpy-written HF Mixtral directory goes through both tools to the same
  checkpoint, and the port's export and re-import round trip bit for bit.
- merge_datasets writes the same bytes as the root tool; compare_loss_curves
  parses the port's training log lines and agrees with the root tool.
- The export and the server verify the checkpoint's manifest, as JAX's
  `load_checkpoint` does: a flipped byte raises.
- `serving.kv_pool.slot_nbytes`, which sizes the server's default
  num_slots, equals JAX's; on the CPU `fit_num_slots` keeps the request.
"""
import functools
import importlib
import io
import json
import os
import shutil
import sys
import threading
import urllib.request
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.inference.generation import Generator as JaxGenerator
from megatron_tpu.inference.generation import SamplingParams
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training import checkpointing as jckpt
from megatron_tpu.training.train_step import TrainState as JaxTrainState
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert import hf_io
from megatron_tpu_torch.convert.from_jax import load_npz_checkpoint
from megatron_tpu_torch.data import IndexedDatasetBuilder, build_tokenizer
from megatron_tpu_torch.tools import compare_loss_curves
from megatron_tpu_torch.tools import convert_hf_checkpoint as tool
from megatron_tpu_torch.tools import merge_datasets
from megatron_tpu_torch.tools import run_text_generation_server as srv
from megatron_tpu_torch.tools import synthetic_corpus
from megatron_tpu_torch.tools import text_generation_cli
from megatron_tpu_torch.training import checkpointing as tckpt
from megatron_tpu_torch.training.loop import training_log
from megatron_tpu_torch.utils.logging import NullWriter

transformers = pytest.importorskip("transformers")
jax_tool = importlib.import_module("tools.convert_hf_checkpoint")
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """An HF directory at the tiny Llama preset, imported by both tools."""
    root = tmp_path_factory.mktemp("convert")
    cfg = tc.llama2_config("tiny")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_kv_heads,
        intermediate_size=cfg.ffn_hidden_size,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.norm_epsilon, tie_word_embeddings=False)).eval()
    hf_dir = str(root / "hf")
    hf.save_pretrained(hf_dir, safe_serialization=True)
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    # the port's checkpoint keeps fp32 compute in its config.json, so that
    # both packages serve it in fp32
    fp32 = tc.llama2_config("tiny", compute_dtype="float32")
    _, model = tool.do_import(Namespace(hf_path=hf_dir, out=port_dir,
                                        family="llama", size="tiny",
                                        source="hf"), fp32, device="cpu")
    # the root tool saves with JAX's default orbax backend, which only JAX
    # reads; its conversion is saved here in the npz format both read
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "save_checkpoint", functools.partial(
            jckpt.save_checkpoint, backend="npz"))
        jax_tool.main(["import", "--hf_path", hf_dir, "--out", jax_dir,
                       "--family", "llama", "--size", "tiny"])
    vocab, merges = synthetic_corpus.write_gpt2_vocab(str(root),
                                                      cfg.vocab_size)
    return dict(hf=hf, hf_dir=hf_dir, port=port_dir, jax=jax_dir,
                model=model, cfg=fp32, vocab=vocab, merges=merges,
                root=root)


def _jax_params(root):
    cfg = jckpt.load_config_from_checkpoint(root).model
    example = JaxTrainState(
        params=jax.eval_shape(lambda: jlm.model_init(jax.random.PRNGKey(0),
                                                     cfg)),
        opt_state=None, iteration=0)
    state, _, _ = jckpt.load_checkpoint(root, example, no_load_optim=True)
    return state.params, cfg


def test_both_tools_write_the_same_checkpoint(converted):
    want = tckpt.read_params(tckpt.tracked_dir(converted["jax"]))
    got = tckpt.read_params(tckpt.tracked_dir(converted["port"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_each_package_reads_the_others_checkpoint(converted):
    model, _ = load_npz_checkpoint(converted["jax"], device="cpu")
    for k, t in converted["model"].state_dict().items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(),
                                      t.numpy(), err_msg=k)
    params, jcfg = _jax_params(converted["port"])
    assert jcfg.compute_dtype == "float32"
    flat = jckpt._flatten(params)
    for k, t in converted["model"].state_dict().items():
        np.testing.assert_array_equal(np.asarray(flat[k.replace(".", "/")]),
                                      t.numpy(), err_msg=k)


def test_export_round_trips_to_the_hf_tensors(converted, tmp_path):
    out = str(tmp_path / "hf_out")
    tool.main(["export", "--load", converted["port"], "--hf_out", out,
               "--family", "llama"], device="cpu")
    with hf_io.HFStateDict(out) as sd:
        want = converted["hf"].state_dict()
        assert sorted(sd) == sorted(want)
        for k, t in want.items():
            np.testing.assert_array_equal(sd[k], t.numpy(), err_msg=k)
    # and its re-import equals the first import
    again = str(tmp_path / "again")
    tool.main(["import", "--hf_path", out, "--out", again, "--size", "tiny"],
              device="cpu")
    a = tckpt.read_params(tckpt.tracked_dir(again))
    b = tckpt.read_params(tckpt.tracked_dir(converted["port"]))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_export_and_server_refuse_a_corrupt_checkpoint(converted, tmp_path):
    """Like JAX's load_checkpoint, the port's load verifies the manifest:
    one flipped byte of params.npz fails the export and the server."""
    root = str(tmp_path / "ckpt")
    shutil.copytree(converted["port"], root)
    path = os.path.join(tckpt.tracked_dir(root), tckpt.PARAMS_FILE)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="checksum mismatch"):
        tool.main(["export", "--load", root, "--hf_out",
                   str(tmp_path / "out"), "--family", "llama"],
                  device="cpu")
    with pytest.raises(ValueError, match="checksum mismatch"):
        srv.build_server(["--load", root, "--tokenizer_type",
                          "GPT2BPETokenizer", "--vocab_file",
                          converted["vocab"], "--merge_file",
                          converted["merges"]], device="cpu")


def test_import_checks_the_hf_config(converted, tmp_path):
    with pytest.raises(ValueError, match="hidden_size"):
        tool.main(["import", "--hf_path", converted["hf_dir"], "--out",
                   str(tmp_path / "x"), "--size", "7b"], device="cpu")


def _serve(argv):
    ready = threading.Event()
    held = {}

    def on_ready(server, httpd):
        held.update(server=server, httpd=httpd)
        ready.set()

    errors = []

    def run():
        try:
            srv.main(argv, device="cpu", ready=on_ready)
        except BaseException as e:  # noqa: BLE001 — reported by the test
            errors.append(e)
            ready.set()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert ready.wait(300) and not errors, errors
    return held, thread


def _put(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def test_cli_server_greedy_equals_jax_generator(converted, monkeypatch):
    c = converted
    tok = build_tokenizer("GPT2BPETokenizer", vocab_file=c["vocab"],
                          merge_file=c["merges"])
    prompts = ["the quick brown fox jumps", "a b c d e f g h i j k l"]
    n_new = 8
    params, jcfg = _jax_params(c["port"])
    gen = JaxGenerator(params, jcfg, eos_id=tok.eod)
    want = []
    for p in prompts:
        ids = tok.tokenize(p)
        toks, lens, _ = gen.generate([ids], n_new,
                                     SamplingParams(temperature=0.0))
        want.append([int(t) for t in toks[0, :lens[0]]])

    held, thread = _serve([
        "--load", c["port"], "--tokenizer_type", "GPT2BPETokenizer",
        "--vocab_file", c["vocab"], "--merge_file", c["merges"], "--host",
        "127.0.0.1", "--port", "0", "--kv_block_size", "16",
        "--num_slots", "2", "--serving_max_len", "128"])
    port = held["httpd"].server_address[1]
    try:
        assert held["server"].engine is not None
        for p, w in zip(prompts, want):
            for route in ({}, {"serial": True}):
                body = _put(port, {"prompts": [p], "tokens_to_generate":
                                   n_new, "temperature": 0.0, **route})
                assert body["segments"][0] == w, (p, route)
        monkeypatch.setattr(sys, "stdin", io.StringIO(f"{prompts[0]}\n4\n"))
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdout", out)
        assert text_generation_cli.main([f"127.0.0.1:{port}"]) == 0
        assert "Megatron Response:" in out.getvalue()
    finally:
        held["httpd"].shutdown()
        thread.join(60)
    assert not thread.is_alive()


@pytest.mark.parametrize("flags,item", [
    (["--fleet", "127.0.0.1:1"], "Queue 1 item 6"),
    (["--replica_mode"], "Queue 1 item 6"),
    (["--remote_max_retries", "3"], "Queue 1 item 6"),
    (["--remote_connect_timeout_s", "5"], "Queue 1 item 6"),
    (["--remote_read_timeout_s", "60"], "Queue 1 item 6"),
    (["--serving_tp", "2"], "Queue 1 item 7"),
    (["--disaggregate_prefill"], "Queue 1 item 7"),
    (["--remote_digest_interval_s", "5"], "Queue 1 item 6"),
])
def test_unported_server_flags_raise(flags, item, tmp_path):
    """Item 7's flags still raise NotImplementedError naming it. Item 6's,
    remote replicas, are ported: each lands in the ServingConfig, and
    `--fleet` builds a front tier that holds no weights and touches no
    device (no --device here, no GPU): a router over RemoteReplica
    clients."""
    if item == "Queue 1 item 7":
        with pytest.raises(NotImplementedError, match=item):
            srv.build_server(["--load", "unused", *flags], device="cpu")
        return
    from megatron_tpu_torch.serving import EngineRouter
    from megatron_tpu_torch.serving.remote import RemoteReplica
    from megatron_tpu_torch.tools import synthetic_corpus
    name = flags[0][2:]
    args = srv.build_parser().parse_args(["--load", "unused", *flags])
    cfg = srv.serving_config(args, 8).validate()
    want = {"fleet": "127.0.0.1:1", "replica_mode": True,
            "remote_max_retries": 3, "remote_connect_timeout_s": 5.0,
            "remote_read_timeout_s": 60.0,
            "remote_digest_interval_s": 5.0}[name]
    assert getattr(cfg, name) == want
    if name != "fleet":
        return
    vocab, merges = synthetic_corpus.write_gpt2_vocab(str(tmp_path), 512)
    server, args = srv.build_server(
        [*flags, "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
         vocab, "--merge_file", merges, "--remote_connect_timeout_s",
         "0.5"])
    try:
        assert server.generator is None
        assert isinstance(server.engine, EngineRouter)
        assert [type(e) for e in server.engine.engines] == [RemoteReplica]
        assert server.engine.engines[0].addr == "127.0.0.1:1"
    finally:
        server.close()
    with pytest.raises(SystemExit):  # a front tier loads no weights
        srv.build_server(["--load", "unused", *flags])


def test_convert_tool_mixtral_roundtrip(tmp_path):
    """An HF Mixtral directory written with numpy (safetensors, the tiny
    preset's shapes): the port's tool and the root tool import it to the
    same checkpoint bit for bit; the port's export equals the HF tensors,
    and its re-import the first import."""
    from safetensors.numpy import save_file

    from megatron_tpu_torch.verify_correctness import (
        seed_hf_llama_numpy_sd, synthetic_hf_mixtral_names)
    cfg = tc.mixtral_config("tiny")
    names = synthetic_hf_mixtral_names(
        vocab=cfg.vocab_size, hidden=cfg.hidden_size, layers=cfg.num_layers,
        heads=cfg.num_attention_heads, kv=cfg.num_kv_heads,
        ffn=cfg.ffn_hidden_size, experts=cfg.num_experts)
    sd = seed_hf_llama_numpy_sd(names, seed=5)
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    save_file(sd, str(hf_dir / "model.safetensors"))
    (hf_dir / "config.json").write_text(json.dumps(
        hf_io.hf_config_dict(cfg, "mixtral")))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tool.main(["import", "--hf_path", str(hf_dir), "--out", port_dir,
               "--family", "mixtral", "--size", "tiny"], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "save_checkpoint", functools.partial(
            jckpt.save_checkpoint, backend="npz"))
        jax_tool.main(["import", "--hf_path", str(hf_dir), "--out", jax_dir,
                       "--family", "mixtral", "--size", "tiny"])
    want = tckpt.read_params(tckpt.tracked_dir(jax_dir))
    got = tckpt.read_params(tckpt.tracked_dir(port_dir))
    assert sorted(got) == sorted(want)
    assert got["transformer/mlp/w1"].shape == (2, 4, 256, 2, 512)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = str(tmp_path / "hf_out")
    tool.main(["export", "--load", port_dir, "--hf_out", out,
               "--family", "mixtral"], device="cpu")
    assert hf_io.read_hf_config(out)["architectures"] == [
        "MixtralForCausalLM"]
    with hf_io.HFStateDict(out) as back:
        assert sorted(back) == sorted(sd)
        for k, t in sd.items():
            np.testing.assert_array_equal(back[k], t, err_msg=k)
    again = str(tmp_path / "again")
    tool.main(["import", "--hf_path", out, "--out", again, "--family",
               "mixtral", "--size", "tiny"], device="cpu")
    again = tckpt.read_params(tckpt.tracked_dir(again))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)
    # a config.json of another expert count is refused
    (hf_dir / "config.json").write_text(json.dumps(dict(
        hf_io.hf_config_dict(cfg, "mixtral"), num_local_experts=8)))
    with pytest.raises(ValueError, match="num_local_experts"):
        tool.main(["import", "--hf_path", str(hf_dir), "--out",
                   str(tmp_path / "x"), "--family", "mixtral", "--size",
                   "tiny"], device="cpu")


def test_tools_raise_without_gpu_and_device(monkeypatch, converted):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["export", "--load", converted["port"], "--hf_out", "x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.build_server(["--load", converted["port"]])


def test_merge_datasets_matches_the_root_tool(tmp_path):
    src = tmp_path / "shards"
    src.mkdir()
    rng = np.random.default_rng(0)
    for name in ("b_text_document", "a_text_document"):
        builder = IndexedDatasetBuilder(str(src / name), dtype=np.uint16)
        for _ in range(5):
            builder.add_item(rng.integers(0, 60000, rng.integers(1, 40)))
            builder.end_document()
        builder.finalize()
    root_tool = importlib.import_module("tools.merge_datasets")
    root_tool.main(["--input", str(src), "--output_prefix",
                    str(tmp_path / "jax")])
    assert merge_datasets.main(["--input", str(src), "--output_prefix",
                                str(tmp_path / "port")]) == 0
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()


def test_compare_loss_curves_reads_the_port_log(tmp_path, capsys):
    lines = [training_log({"lm_loss": 10.5 - i, "lr": 3e-5,
                           "grad_norm": 1.0}, i + 1, 2 * (i + 1), 0.1, 1e3,
                          NullWriter(), 0, 0) for i in range(3)]
    ours, theirs = tmp_path / "ours.log", tmp_path / "theirs.log"
    ours.write_text("\n".join(lines) + "\n")
    theirs.write_text("\n".join(lines[:2] + [lines[2].replace(
        "8.500000E+00", "9.000000E+00")]) + "\n")
    assert compare_loss_curves.parse_log(str(ours)) == {2: 10.5, 4: 9.5,
                                                        6: 8.5}
    root_tool = importlib.import_module("tools.compare_loss_curves")
    for a, b in ((ours, ours), (ours, theirs)):
        argv = [str(a), str(b), "--quiet"]
        assert compare_loss_curves.main(argv) == root_tool.main(argv)
    assert compare_loss_curves.main([str(ours), str(ours)]) == 0
    assert compare_loss_curves.main([str(ours), str(theirs)]) == 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("block", [None, 16])
def test_slot_nbytes_matches_jax_and_cpu_keeps_the_request(kv, block):
    """The CLI server's default num_slots: one slot's bytes as JAX counts
    them; on the CPU, which has no memory budget, the request stands."""
    import jax.numpy as jnp

    from megatron_tpu.serving import kv_pool as jkv
    from megatron_tpu_torch.serving import kv_pool as tkv
    jcfg = jc.llama2_config("7b", num_layers=2)
    tcfg = tc.llama2_config("7b", num_layers=2)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if kv == "bf16"
              else (jnp.int8, torch.int8))
    assert tkv.slot_nbytes(tcfg, 4096, td, block) == \
        jkv.slot_nbytes(jcfg, 4096, jd, block)
    assert tkv.fit_num_slots(tcfg, 4096, td, requested=5, block_size=block,
                             device="cpu") == 5
