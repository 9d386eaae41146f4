"""The port's HF directory reader and writer (convert/hf_io.py), which use
neither `transformers` nor `safetensors`, against the files those libraries
write and read.

- `HFStateDict` returns exactly the tensors of `safetensors.torch.save_file`
  output (BF16, F16 and F32, upcast to fp32 bit for bit), sharded under a
  `model.safetensors.index.json`; of `.bin` shards under a
  `pytorch_model.bin.index.json` and of a single `pytorch_model.bin`; and
  of a hand-written file whose tensor is not aligned to its element size.
  `__metadata__` is skipped; a dtype the reader does not take raises.
- A directory the port's export writes loads in `transformers`
  (`AutoConfig`, `AutoModelForCausalLM`) with the port's logits, Llama and
  Falcon, at an average max-abs <= 1e-3 (measured ~1e-6).
"""
import json
import os
import struct
from argparse import Namespace

import numpy as np
import pytest
import torch

from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert import hf_io
from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                      model_forward)
from megatron_tpu_torch.tools import convert_hf_checkpoint as tool
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training.train_step import TrainState

safetensors_torch = pytest.importorskip("safetensors.torch")
torch.set_num_threads(2)


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a.bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "b.f16": torch.randn(3, generator=g).to(torch.float16),
            "c.f32": torch.randn(2, 3, 4, generator=g),
            "d.empty": torch.zeros(0, 4)}


def _check(sd, want):
    assert sorted(sd) == sorted(want)
    for k, t in want.items():
        got = sd[k]
        assert got.dtype == np.float32 and got.shape == tuple(t.shape), k
        np.testing.assert_array_equal(got, t.float().numpy(), err_msg=k)


def test_reads_sharded_safetensors(tmp_path):
    shards = [_tensors(0), {f"x{k}": v for k, v in _tensors(1).items()}]
    weight_map = {}
    for i, part in enumerate(shards):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        safetensors_torch.save_file(part, str(tmp_path / name),
                                    metadata={"format": "pt"})
        weight_map.update({k: name for k in part})
    (tmp_path / hf_io.SAFETENSORS_INDEX).write_text(json.dumps(
        {"metadata": {"total_size": 0}, "weight_map": weight_map}))
    with hf_io.HFStateDict(str(tmp_path)) as sd:
        assert sd.kind == "safetensors" and len(sd.files) == 2
        _check(sd, {**shards[0], **shards[1]})


def test_reads_single_safetensors_without_index(tmp_path):
    want = _tensors(2)
    safetensors_torch.save_file(want, str(tmp_path / "model.safetensors"))
    with hf_io.HFStateDict(str(tmp_path)) as sd:
        _check(sd, want)


def test_reads_unaligned_tensor_and_skips_metadata(tmp_path):
    """A header whose length puts the data section at an odd offset: the
    tensor is copied out before it is viewed."""
    x = torch.randn(6, 2)
    header = {"__metadata__": {"k": "v"},
              "w": {"dtype": "F32", "shape": [6, 2],
                    "data_offsets": [0, 48]}}
    raw = json.dumps(header).encode()
    while (8 + len(raw)) % 4 != 1:  # headers are padded with spaces
        raw += b" "
    path = tmp_path / "model.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw)) + raw
                     + x.numpy().tobytes())
    with hf_io.HFStateDict(str(tmp_path)) as sd:
        assert list(sd) == ["w"]
        _check(sd, {"w": x})


def test_refuses_other_dtypes(tmp_path):
    safetensors_torch.save_file({"i": torch.zeros(3, dtype=torch.int64)},
                                str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        hf_io.HFStateDict(str(tmp_path))


def test_reads_bin_shards_and_single_bin(tmp_path):
    shards = [_tensors(3), {f"y{k}": v for k, v in _tensors(4).items()}]
    weight_map = {}
    for i, part in enumerate(shards):
        name = f"pytorch_model-{i + 1:05d}-of-00002.bin"
        torch.save(part, tmp_path / name)
        weight_map.update({k: name for k in part})
    (tmp_path / hf_io.BIN_INDEX).write_text(json.dumps(
        {"weight_map": weight_map}))
    with hf_io.HFStateDict(str(tmp_path)) as sd:
        assert sd.kind == "bin"
        _check(sd, {**shards[0], **shards[1]})
    single = tmp_path / "single"
    single.mkdir()
    torch.save(shards[0], single / "pytorch_model.bin")
    with hf_io.HFStateDict(str(single)) as sd:
        _check(sd, shards[0])


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        hf_io.HFStateDict(str(tmp_path))


def test_config_check_names_the_disagreement():
    cfg = tc.llama2_config("7b")
    hf = dict(hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
              num_key_value_heads=32, intermediate_size=11008,
              vocab_size=32000)
    hf_io.check_hf_config(hf, cfg, "llama")
    with pytest.raises(ValueError, match="num_hidden_layers 40 vs 32"):
        hf_io.check_hf_config(dict(hf, num_hidden_layers=40), cfg, "llama")
    # Falcon-7B's published config: older spellings, no num_kv_heads
    hf_io.check_hf_config(dict(hidden_size=4544, n_layer=32, n_head=71,
                               multi_query=True, vocab_size=65024),
                          tc.falcon_config("7b"), "falcon")


FAMILIES = {
    "llama": tc.llama2_config("tiny", num_layers=2, hidden_size=64,
                              num_attention_heads=4, num_kv_heads=2,
                              vocab_size=300, seq_length=32,
                              compute_dtype="float32"),
    "falcon": tc.falcon_config("tiny", num_layers=2, hidden_size=64,
                               num_attention_heads=4, num_kv_heads=1,
                               vocab_size=200, seq_length=32,
                               compute_dtype="float32"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_loads_in_transformers_with_equal_logits(tmp_path, family):
    transformers = pytest.importorskip("transformers")
    cfg = FAMILIES[family]
    model = LanguageModel(cfg, device="cpu", seed=3)
    ckpt.save_checkpoint(str(tmp_path / "ckpt"), TrainState(model, None, 0),
                         tc.MegatronConfig(model=cfg), iteration=0,
                         release=True)
    out = str(tmp_path / "hf")
    tool.do_export(Namespace(load=str(tmp_path / "ckpt"), hf_out=out,
                             family=family, size="tiny"), device="cpu")
    hf_cfg = transformers.AutoConfig.from_pretrained(out)
    assert hf_cfg.model_type == family
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        out, torch_dtype=torch.float32).eval()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
        got, _ = model_forward(model, tokens, cfg)
    err = np.abs(got.numpy()[..., :cfg.vocab_size] - want).max(-1).mean()
    assert err <= 1e-3, err
    assert os.path.exists(os.path.join(out, hf_io.BIN_SINGLE))
