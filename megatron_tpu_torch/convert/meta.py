"""Meta's raw Llama checkpoints: the shard merge and the parameter mapping
(megatron_tpu/convert/meta.py; the reference's merge_llama.py and
weights2megatron.py with source="meta").

Meta ships `consolidated.{00..NN}.pth` shards cut along the original
tensor-parallel axes:

  dim 0 (row-stacked):   attention wq/wk/wv, feed_forward w1/w3, output
  dim 1 (col-stacked):   attention wo, feed_forward w2, tok_embeddings
  replicated:            attention_norm, ffn_norm, norm; rope.freqs skipped

Meta's weights already use the interleaved-pair rotary layout the model
implements, so unlike the HF path no row is permuted.
"""
from __future__ import annotations

import os
import re
from typing import Mapping

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig

# short param name (second-to-last dotted component) -> shard concat axis
_SHARD_AXIS = {
    "wq": 0, "wk": 0, "wv": 0, "w1": 0, "w3": 0, "output": 0,
    "wo": 1, "w2": 1, "tok_embeddings": 1,
    "attention_norm": None, "ffn_norm": None, "norm": None,
}


def _t(w) -> np.ndarray:
    # torch's blocked, multi-threaded transpose: numpy's strided copy of a
    # 7B projection is several times slower (the values are only moved)
    return torch.from_numpy(np.asarray(w)).t().contiguous().numpy()


def _pad_vocab(w: np.ndarray, padded: int) -> np.ndarray:
    v = w.shape[0]
    if v == padded:
        return w
    assert v < padded
    return np.concatenate(
        [w, np.zeros((padded - v, w.shape[1]), w.dtype)], axis=0)


def _short(name: str) -> str:
    parts = name.split(".")
    return parts[-2] if len(parts) >= 2 else parts[0]


def list_meta_shards(root_dir: str) -> list[str]:
    names = [n for n in os.listdir(root_dir)
             if re.fullmatch(r"consolidated\.[0-9]+\.pth", n)]
    if not names:
        raise FileNotFoundError(
            f"no consolidated.NN.pth shards under {root_dir}")
    # numeric order: consolidated.10.pth comes after consolidated.2.pth
    names.sort(key=lambda n: int(n.split(".")[1]))
    return [os.path.join(root_dir, n) for n in names]


def merge_meta_llama(root_dir: str) -> dict:
    """Load and merge all consolidated shards into whole numpy tensors,
    one shard at a time."""
    per_key: dict[str, list] = {}
    for path in list_meta_shards(root_dir):
        shard = torch.load(path, map_location="cpu", weights_only=True)
        for name, tensor in shard.items():
            if _short(name) == "rope":  # rope.freqs: recomputed, not stored
                continue
            # numpy holds fp16 and fp32 as they are; only bf16 upcasts
            if tensor.dtype == torch.bfloat16:
                tensor = tensor.to(torch.float32)
            per_key.setdefault(name, []).append(tensor.numpy())
        del shard
    merged = {}
    for name, pieces in per_key.items():
        short = _short(name)
        if short not in _SHARD_AXIS:
            raise KeyError(
                f"unrecognized meta checkpoint tensor {name!r}: no shard "
                "axis known")
        axis = _SHARD_AXIS[short]
        if axis is None or len(pieces) == 1:
            merged[name] = pieces[0]
        else:
            merged[name] = np.concatenate(pieces, axis=axis)
    return merged


def meta_llama_to_params(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                         dtype=np.float32) -> dict:
    """A merged Meta state dict -> the parameter tree."""
    L = cfg.num_layers

    def get(name):
        return np.asarray(sd[name], dtype=dtype)

    layers = {"attention": {"wq": [], "wkv": [], "wo": []},
              "mlp": {"w1": [], "w2": []},
              "input_norm": {"scale": []},
              "post_attn_norm": {"scale": []}}
    for i in range(L):
        p = f"layers.{i}."
        wq = _t(get(p + "attention.wq.weight"))           # [h, nq*hd]
        wk = _t(get(p + "attention.wk.weight"))
        wv = _t(get(p + "attention.wv.weight"))
        layers["attention"]["wq"].append(wq)
        layers["attention"]["wkv"].append(np.concatenate([wk, wv], axis=1))
        layers["attention"]["wo"].append(_t(get(p + "attention.wo.weight")))
        gate = _t(get(p + "feed_forward.w1.weight"))      # [h, ffn]
        up = _t(get(p + "feed_forward.w3.weight"))
        layers["mlp"]["w1"].append(np.stack([gate, up], axis=1))
        layers["mlp"]["w2"].append(_t(get(p + "feed_forward.w2.weight")))
        layers["input_norm"]["scale"].append(get(p + "attention_norm.weight"))
        layers["post_attn_norm"]["scale"].append(get(p + "ffn_norm.weight"))

    stacked = {k: {kk: np.stack(vv) for kk, vv in v.items()}
               for k, v in layers.items()}
    params = {
        "embedding": {"word_embeddings": _pad_vocab(
            get("tok_embeddings.weight"), cfg.padded_vocab_size)},
        "transformer": stacked,
        "final_norm": {"scale": get("norm.weight")},
    }
    if not cfg.tie_embed_logits:
        params["lm_head"] = _t(_pad_vocab(get("output.weight"),
                                          cfg.padded_vocab_size))
    return params
