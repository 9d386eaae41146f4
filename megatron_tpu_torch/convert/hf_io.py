"""Hugging Face checkpoint directories read and written without
`transformers` or `safetensors`.

The JAX package reads an HF directory through
`transformers.AutoModelForCausalLM.from_pretrained(torch_dtype=float32)` and
writes one through `transformers`' config classes. The port reads and writes
the files themselves:

- `config.json` (`read_hf_config`);
- `*.safetensors`, parsed here: an unsigned 64-bit little-endian header
  length, a JSON header (padded with spaces) mapping each name to its
  `dtype` (BF16, F16 or F32), `shape` and `data_offsets` (relative to the
  end of the header), then the raw bytes; `__metadata__` is skipped;
- `pytorch_model*.bin` through `torch.load(weights_only=True, mmap=True)`;
- the shard maps `model.safetensors.index.json` and
  `pytorch_model.bin.index.json`.

`HFStateDict` is a mapping from tensor name to an fp32 numpy array. It reads
a tensor from its shard when asked for it and keeps one shard open at a time,
memory-mapped, so an import through it holds the converted model and the
tensor in hand, never a second fp32 copy of the model.

`save_hf_checkpoint` writes `pytorch_model.bin` (fp32, as the JAX export
does) and a `config.json` with the fields the JAX export passes to
`LlamaConfig` / `FalconConfig` / `MixtralConfig`, plus `model_type` and
`architectures`, so that `transformers.AutoModelForCausalLM` loads the
directory.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig

SAFETENSORS_INDEX = "model.safetensors.index.json"
BIN_INDEX = "pytorch_model.bin.index.json"
BIN_SINGLE = "pytorch_model.bin"
CONFIG = "config.json"

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32}


def read_hf_config(path: str) -> dict:
    with open(os.path.join(path, CONFIG)) as f:
        return json.load(f)


def read_safetensors_header(path: str) -> tuple[dict, int]:
    """({name: {"dtype", "shape", "data_offsets"}}, byte offset of the data
    section) of one .safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes is truncated")
    header = json.loads(raw.decode("utf-8"))
    header.pop("__metadata__", None)
    for name, entry in header.items():
        if entry["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{entry['dtype']}; the reader takes "
                             f"{sorted(_ST_DTYPES)}")
    return header, 8 + n


def _shard_map(path: str) -> tuple[str, dict]:
    """("safetensors" | "bin", {name: file}); for a single .bin the names
    are filled in when the file is first opened."""
    for index, kind in ((SAFETENSORS_INDEX, "safetensors"),
                        (BIN_INDEX, "bin")):
        p = os.path.join(path, index)
        if os.path.exists(p):
            with open(p) as f:
                return kind, dict(json.load(f)["weight_map"])
    shards = sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
    if shards:
        return "safetensors", {n: None for n in shards}
    if os.path.exists(os.path.join(path, BIN_SINGLE)):
        return "bin", {BIN_SINGLE: None}
    raise FileNotFoundError(f"no *.safetensors, {BIN_SINGLE} or shard "
                            f"index under {path}")


class HFStateDict(Mapping):
    """The tensors of an HF checkpoint directory by name, each read from
    its shard on access and upcast to an fp32 numpy array (a copy that owns
    its memory). One shard is open at a time; `close()` closes it."""

    def __init__(self, path: str):
        self.path = path
        self.kind, weight_map = _shard_map(path)
        self._where: dict[str, str] = {}
        self._headers: dict[str, tuple[dict, int]] = {}
        self._open_file: Optional[str] = None
        self._open: Optional[tuple] = None
        for name, file in weight_map.items():
            if file is None:  # a directory without an index: scan the file
                for key in self._names_in(name):
                    self._where[key] = name
            else:
                self._where[name] = file
        self.files = sorted(set(self._where.values()))

    def _names_in(self, file: str) -> list:
        if self.kind == "safetensors":
            return list(self._header(file)[0])
        return list(self._load(file))

    def _header(self, file: str) -> tuple[dict, int]:
        if file not in self._headers:
            self._headers[file] = read_safetensors_header(
                os.path.join(self.path, file))
        return self._headers[file]

    def _load(self, file: str):
        """The open shard `file`, closing the one before."""
        if self._open_file != file:
            self.close()
            full = os.path.join(self.path, file)
            if self.kind == "safetensors":
                f = open(full, "rb")
                # copy-on-write: writable for torch.frombuffer, and never
                # written, so no page is copied
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                self._open = (f, mm)
            else:
                self._open = torch.load(full, map_location="cpu",
                                        weights_only=True, mmap=True)
            self._open_file = file
        return self._open

    def close(self) -> None:
        if self._open is not None and self.kind == "safetensors":
            f, mm = self._open
            mm.close()
            f.close()
        self._open, self._open_file = None, None

    def __getitem__(self, name: str) -> np.ndarray:
        file = self._where[name]
        if self.kind == "bin":
            t = self._load(file)[name]
        else:
            t = self._safetensors_tensor(file, name)
        out = t.to(torch.float32, copy=True).numpy()
        del t
        return out

    def _safetensors_tensor(self, file: str, name: str) -> torch.Tensor:
        header, data_start = self._header(file)
        entry = header[name]
        dtype = _ST_DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * itemsize:
            raise ValueError(f"{file}: tensor {name} spans {end - begin} "
                             f"bytes for shape {shape} of {entry['dtype']}")
        if count == 0:
            return torch.zeros(shape, dtype=dtype)
        _, mm = self._load(file)
        start = data_start + begin
        if start % itemsize:
            # an unaligned tensor is copied out before it is viewed
            return torch.frombuffer(bytearray(mm[start:start + end - begin]),
                                    dtype=dtype).reshape(shape)
        return torch.frombuffer(mm, dtype=dtype, count=count,
                                offset=start).reshape(shape)

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# config.json names of the fields the import checks, with Falcon's older
# spellings
_CONFIG_ALIASES = {
    "num_hidden_layers": ("num_hidden_layers", "n_layer"),
    "num_attention_heads": ("num_attention_heads", "n_head"),
}


def hf_config_dict(cfg: ModelConfig, family: str) -> dict:
    """The config.json of an export: the fields the JAX export passes to
    LlamaConfig / FalconConfig / MixtralConfig, with model_type and
    architectures."""
    if family == "mixtral":
        return dict(
            model_type="mixtral", architectures=["MixtralForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.num_kv_heads,
            intermediate_size=cfg.ffn_hidden_size,
            max_position_embeddings=cfg.max_position_embeddings,
            rms_norm_eps=cfg.norm_epsilon, rope_theta=cfg.rope_theta,
            num_local_experts=cfg.num_experts,
            num_experts_per_tok=cfg.moe_top_k,
            tie_word_embeddings=cfg.tie_embed_logits)
    if family == "llama":
        return dict(
            model_type="llama", architectures=["LlamaForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.num_kv_heads,
            intermediate_size=cfg.ffn_hidden_size,
            max_position_embeddings=cfg.max_position_embeddings,
            rms_norm_eps=cfg.norm_epsilon,
            tie_word_embeddings=cfg.tie_embed_logits)
    if family == "falcon":
        return dict(
            model_type="falcon", architectures=["FalconForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_kv_heads=cfg.num_kv_heads,
            ffn_hidden_size=cfg.ffn_hidden_size,
            max_position_embeddings=cfg.max_position_embeddings,
            rope_theta=cfg.rope_theta,
            new_decoder_architecture=cfg.parallel_layernorm,
            multi_query=cfg.num_kv_heads == 1,
            parallel_attn=cfg.parallel_attn, bias=cfg.use_bias,
            layer_norm_epsilon=cfg.norm_epsilon)
    raise ValueError(f"no HF config for family {family!r}")


def check_hf_config(hf: dict, cfg: ModelConfig, family: str) -> None:
    """Raise when an HF config.json disagrees with the ModelConfig the
    import converts to (a wrong --size fails here, not in a reshape)."""
    want = {"hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "vocab_size": cfg.vocab_size}
    if family in ("llama", "mixtral"):
        want["num_key_value_heads"] = cfg.num_kv_heads
        want["intermediate_size"] = cfg.ffn_hidden_size
    if family == "mixtral":
        want["num_local_experts"] = cfg.num_experts
        want["num_experts_per_tok"] = cfg.moe_top_k
        want["rope_theta"] = cfg.rope_theta
    elif family == "falcon":
        kv = hf.get("num_kv_heads")
        if kv is None and not hf.get("new_decoder_architecture"):
            kv = 1 if hf.get("multi_query", True) else \
                _field(hf, "num_attention_heads")
        hf = dict(hf, num_kv_heads=kv)
        want["num_kv_heads"] = cfg.num_kv_heads
    bad = {k: (_field(hf, k), v) for k, v in want.items()
           if _field(hf, k) is not None and _field(hf, k) != v}
    if bad:
        raise ValueError("HF config.json disagrees with the model config "
                         "(config.json, model): " + ", ".join(
                             f"{k} {a} vs {b}" for k, (a, b) in bad.items()))


def _field(hf: dict, name: str):
    for key in _CONFIG_ALIASES.get(name, (name,)):
        if hf.get(key) is not None:
            return hf[key]
    return None


def save_hf_checkpoint(out_dir: str, sd: Mapping[str, np.ndarray],
                       config: dict) -> str:
    """Write `pytorch_model.bin` (the tensors as they are, sharing memory
    with `sd`; a name that holds the same array as another, a tied LM head,
    is stored once) and `config.json` under `out_dir`. Returns the .bin
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, BIN_SINGLE)
    tensors: dict = {}
    by_array: dict = {}
    for k, v in sd.items():
        if id(v) not in by_array:
            by_array[id(v)] = torch.from_numpy(
                np.require(v, requirements=["C", "W"]))
        tensors[k] = by_array[id(v)]
    torch.save(tensors, path)
    with open(os.path.join(out_dir, CONFIG), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
    return path
