"""Hugging Face Llama, Falcon and Mixtral state dicts <-> the reference's
parameter tree (megatron_tpu/convert/hf.py).

Numpy in, numpy out. The tree is the JAX package's: nested dicts under its
names with the stacked [L, ...] layer layout, which
`convert.from_jax.params_from_numpy` turns into the port's `LanguageModel`.

Layout notes (the reference's weights2megatron and megatron2hf):
- HF's nn.Linear stores W as [out, in]; the tree stores [in, out], so every
  projection is transposed on the way in and out.
- HF applies RoPE rotate-half (pairs (i, i + hd/2)); the model uses Meta's
  interleaved pairs (2i, 2i + 1). Each head's q and k rows are reordered so
  that new[2i], new[2i + 1] = hf[i], hf[i + hd/2].
- The embedding and an untied LM head are zero-padded to
  cfg.padded_vocab_size on import and trimmed to cfg.vocab_size on export.

- Mixtral is a Llama backbone (attention, norms and embeddings map as
  Llama's) whose MLPs are `block_sparse_moe` banks: gate.weight [E, h] ->
  router [h, E]; experts.{e}.w1 (gate) -> w1[e, :, 0], w3 (up) ->
  w1[e, :, 1], w2 (down) -> w2[e]. Mixtral is dropless: serve it at
  moe_capacity_factor >= E / top_k (its preset's default).

A layer's leaves are written into [L, ...] arrays allocated at the first
layer (an expert's into its slice of the layer's bank), so an import holds
one copy of the model beside the tensor it reads. `sd` may be any mapping,
such as `hf_io.HFStateDict`, which reads each tensor from its shard when it
is asked for.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig


def _t(w) -> np.ndarray:
    # torch's blocked, multi-threaded transpose: numpy's strided copy of a
    # 7B projection is several times slower (the values are only moved)
    return torch.from_numpy(np.asarray(w)).t().contiguous().numpy()


def interleave_rope_rows(w: np.ndarray, n_heads: int, head_dim: int
                         ) -> np.ndarray:
    """A [n_heads * head_dim, in] projection's output rows from HF's
    rotate-half order to Meta's interleaved order."""
    out, inp = w.shape
    assert out == n_heads * head_dim
    w = w.reshape(n_heads, head_dim, inp)
    half = head_dim // 2
    inter = np.empty_like(w)
    inter[:, 0::2] = w[:, :half]
    inter[:, 1::2] = w[:, half:]
    return inter.reshape(out, inp)


def deinterleave_rope_rows(w: np.ndarray, n_heads: int, head_dim: int
                           ) -> np.ndarray:
    """The inverse of interleave_rope_rows (the model's order -> HF's)."""
    out, inp = w.shape
    w = w.reshape(n_heads, head_dim, inp)
    half = head_dim // 2
    de = np.empty_like(w)
    de[:, :half] = w[:, 0::2]
    de[:, half:] = w[:, 1::2]
    return de.reshape(out, inp)


def _pad_vocab(w: np.ndarray, padded: int) -> np.ndarray:
    v = w.shape[0]
    if v == padded:
        return w
    assert v < padded
    return np.concatenate(
        [w, np.zeros((padded - v, w.shape[1]), w.dtype)], axis=0)


class _Layers:
    """Stacked per-layer leaves: put(group, name, i, array) writes layer i
    of the [L, ...] array `tree[group][name]`, allocated at the first
    write."""

    def __init__(self, n_layers: int):
        self.n = n_layers
        self.tree: dict = {}

    def put(self, group: str, name: str, i: int, arr: np.ndarray) -> None:
        self._stack(group, name, arr.shape, arr.dtype)[i] = arr

    def layer(self, group: str, name: str, i: int, shape: tuple,
              dtype) -> np.ndarray:
        """Layer i of `tree[group][name]`, a view to write in place."""
        return self._stack(group, name, shape, dtype)[i]

    def _stack(self, group, name, shape, dtype) -> np.ndarray:
        node = self.tree.setdefault(group, {})
        if name not in node:
            node[name] = np.empty((self.n,) + tuple(shape), dtype)
        return node[name]


def _getter(sd: Mapping, dtype):
    def get(name):
        return np.asarray(sd[name], dtype=dtype)
    return get


def hf_llama_to_params(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                       dtype=np.float32) -> dict:
    """HF LlamaForCausalLM state dict -> the parameter tree."""
    def mlp(get, layers, i, p):
        gate = _t(get(p + "mlp.gate_proj.weight"))  # [h, ffn]
        up = _t(get(p + "mlp.up_proj.weight"))
        layers.put("mlp", "w1", i, np.stack([gate, up], axis=1))
        layers.put("mlp", "w2", i, _t(get(p + "mlp.down_proj.weight")))
    return _llama_backbone_import(sd, cfg, dtype, mlp)


def hf_mixtral_to_params(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                         dtype=np.float32) -> dict:
    """HF MixtralForCausalLM state dict -> the parameter tree (Llama's
    backbone, an expert bank for each MLP). Mixtral's softmax, top-k and
    renormalization are models/moe.py's routing."""
    if cfg.num_experts <= 1:
        raise ValueError("mixtral conversion needs num_experts > 1")
    E, h, ffn = cfg.num_experts, cfg.hidden_size, cfg.ffn_hidden_size

    def mlp(get, layers, i, p):
        m = p + "block_sparse_moe."
        layers.put("mlp", "router", i, _t(get(m + "gate.weight")))
        w1 = layers.layer("mlp", "w1", i, (E, h, 2, ffn), dtype)
        w2 = layers.layer("mlp", "w2", i, (E, ffn, h), dtype)
        for e in range(E):
            x = f"{m}experts.{e}."
            w1[e, :, 0] = _t(get(x + "w1.weight"))  # gate
            w1[e, :, 1] = _t(get(x + "w3.weight"))  # up
            w2[e] = _t(get(x + "w2.weight"))        # down
    return _llama_backbone_import(sd, cfg, dtype, mlp)


def _llama_backbone_import(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                           dtype, mlp) -> dict:
    """A Llama-layout state dict -> the parameter tree; `mlp(get, layers,
    i, prefix)` writes layer i's MLP leaves."""
    hd = cfg.kv_channels
    nq = cfg.num_attention_heads
    nkv = cfg.num_kv_heads
    get = _getter(sd, dtype)
    layers = _Layers(cfg.num_layers)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wq = interleave_rope_rows(get(p + "self_attn.q_proj.weight"), nq, hd)
        wk = interleave_rope_rows(get(p + "self_attn.k_proj.weight"), nkv, hd)
        wv = get(p + "self_attn.v_proj.weight")
        layers.put("attention", "wq", i, _t(wq))
        layers.put("attention", "wkv", i,
                   np.concatenate([_t(wk), _t(wv)], axis=1))
        layers.put("attention", "wo", i,
                   _t(get(p + "self_attn.o_proj.weight")))
        mlp(get, layers, i, p)
        layers.put("input_norm", "scale", i, get(p + "input_layernorm.weight"))
        layers.put("post_attn_norm", "scale", i,
                   get(p + "post_attention_layernorm.weight"))
    params = {
        "embedding": {"word_embeddings": _pad_vocab(
            get("model.embed_tokens.weight"), cfg.padded_vocab_size)},
        "transformer": layers.tree,
        "final_norm": {"scale": get("model.norm.weight")},
    }
    if not cfg.tie_embed_logits:
        params["lm_head"] = _t(_pad_vocab(get("lm_head.weight"),
                                          cfg.padded_vocab_size))
    return params


def params_to_hf_llama(params, cfg: ModelConfig, dtype=np.float32) -> dict:
    """The parameter tree -> an HF LlamaForCausalLM state dict."""
    def mlp(t, i, p):
        w1 = np.asarray(t["mlp"]["w1"][i], dtype)  # [h, 2, ffn]
        return {p + "mlp.gate_proj.weight": _t(w1[:, 0]),
                p + "mlp.up_proj.weight": _t(w1[:, 1]),
                p + "mlp.down_proj.weight": _t(
                    np.asarray(t["mlp"]["w2"][i], dtype))}
    return _llama_backbone_export(params, cfg, dtype, mlp)


def params_to_hf_mixtral(params, cfg: ModelConfig,
                         dtype=np.float32) -> dict:
    """The parameter tree -> an HF MixtralForCausalLM state dict (the
    inverse of hf_mixtral_to_params)."""
    def mlp(t, i, p):
        m = p + "block_sparse_moe."
        out = {m + "gate.weight": _t(np.asarray(t["mlp"]["router"][i],
                                                dtype))}
        w1 = np.asarray(t["mlp"]["w1"][i], dtype)  # [E, h, 2, ffn]
        w2 = np.asarray(t["mlp"]["w2"][i], dtype)  # [E, ffn, h]
        for e in range(cfg.num_experts):
            out[f"{m}experts.{e}.w1.weight"] = _t(w1[e, :, 0])
            out[f"{m}experts.{e}.w3.weight"] = _t(w1[e, :, 1])
            out[f"{m}experts.{e}.w2.weight"] = _t(w2[e])
        return out
    return _llama_backbone_export(params, cfg, dtype, mlp)


def _llama_backbone_export(params, cfg: ModelConfig, dtype, mlp) -> dict:
    """The parameter tree -> a Llama-layout state dict; `mlp(t, i, prefix)`
    returns layer i's MLP tensors."""
    hd = cfg.kv_channels
    nq = cfg.num_attention_heads
    nkv = cfg.num_kv_heads
    t = params["transformer"]
    v = cfg.vocab_size
    sd = {"model.embed_tokens.weight": np.asarray(
        params["embedding"]["word_embeddings"], dtype)[:v]}
    sd["model.norm.weight"] = np.asarray(params["final_norm"]["scale"], dtype)
    if not cfg.tie_embed_logits:
        sd["lm_head.weight"] = _t(np.asarray(params["lm_head"], dtype))[:v]
    else:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wq = _t(np.asarray(t["attention"]["wq"][i], dtype))  # [nq*hd, h]
        sd[p + "self_attn.q_proj.weight"] = deinterleave_rope_rows(wq, nq, hd)
        wkv = np.asarray(t["attention"]["wkv"][i], dtype)  # [h, 2*nkv*hd]
        wk, wv = wkv[:, :nkv * hd], wkv[:, nkv * hd:]
        sd[p + "self_attn.k_proj.weight"] = deinterleave_rope_rows(
            _t(wk), nkv, hd)
        sd[p + "self_attn.v_proj.weight"] = _t(wv)
        sd[p + "self_attn.o_proj.weight"] = _t(
            np.asarray(t["attention"]["wo"][i], dtype))
        sd.update(mlp(t, i, p))
        sd[p + "input_layernorm.weight"] = np.asarray(
            t["input_norm"]["scale"][i], dtype)
        sd[p + "post_attention_layernorm.weight"] = np.asarray(
            t["post_attn_norm"]["scale"][i], dtype)
    return sd


def hf_falcon_to_params(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                        dtype=np.float32) -> dict:
    """HF FalconForCausalLM state dict -> the parameter tree.

    Falcon fuses QKV as nkv groups of (q_per_kv + 2) heads,
    [nkv, q_per_kv + 2, hd, h]: the last two heads of each group are that
    group's K and V. Falcon-7B's `multi_query` layout is the case nkv = 1,
    Falcon-40B's `new_decoder_architecture` the grouped one."""
    hd = cfg.kv_channels
    nq = cfg.num_attention_heads
    nkv = cfg.num_kv_heads
    qpg = nq // nkv
    h = cfg.hidden_size
    if cfg.use_post_ln or not cfg.parallel_attn:
        raise NotImplementedError("falcon conversion expects parallel_attn")
    get = _getter(sd, dtype)
    layers = _Layers(cfg.num_layers)
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        qkv = get(p + "self_attention.query_key_value.weight")
        qkv = qkv.reshape(nkv, qpg + 2, hd, h)
        q = interleave_rope_rows(qkv[:, :qpg].reshape(nq * hd, h), nq, hd)
        k = interleave_rope_rows(qkv[:, qpg].reshape(nkv * hd, h), nkv, hd)
        v = qkv[:, qpg + 1].reshape(nkv * hd, h)
        layers.put("attention", "wq", i, _t(q))
        layers.put("attention", "wkv", i, np.concatenate([_t(k), _t(v)], 1))
        layers.put("attention", "wo", i,
                   _t(get(p + "self_attention.dense.weight")))
        layers.put("mlp", "w1", i, _t(get(p + "mlp.dense_h_to_4h.weight")))
        layers.put("mlp", "w2", i, _t(get(p + "mlp.dense_4h_to_h.weight")))
        if cfg.parallel_layernorm:  # falcon-40b: ln_attn + ln_mlp
            norms = (("input_norm", "ln_attn"), ("mlp_norm", "ln_mlp"))
        else:  # falcon-7b: one input_layernorm
            norms = (("input_norm", "input_layernorm"),)
        for group, name in norms:
            layers.put(group, "scale", i, get(p + name + ".weight"))
            layers.put(group, "bias", i, get(p + name + ".bias"))
    params = {
        "embedding": {"word_embeddings": _pad_vocab(
            get("transformer.word_embeddings.weight"),
            cfg.padded_vocab_size)},
        "transformer": layers.tree,
        "final_norm": {"scale": get("transformer.ln_f.weight"),
                       "bias": get("transformer.ln_f.bias")},
    }
    if not cfg.tie_embed_logits:
        # released falcons tie; an untied finetune round-trips through
        # lm_head.weight
        params["lm_head"] = _t(_pad_vocab(get("lm_head.weight"),
                                          cfg.padded_vocab_size))
    return params


def params_to_hf_falcon(params, cfg: ModelConfig, dtype=np.float32) -> dict:
    """The parameter tree -> an HF FalconForCausalLM state dict: the fused
    grouped QKV rebuilt with each group's K and V as its last two heads, and
    the rotary rows back in rotate-half order."""
    if cfg.use_post_ln or not cfg.parallel_attn or cfg.use_bias:
        # other layouts would drop norm or bias tensors without a word
        raise NotImplementedError(
            "falcon export expects parallel_attn, pre-LN, no biases")
    hd = cfg.kv_channels
    nq = cfg.num_attention_heads
    nkv = cfg.num_kv_heads
    qpg = nq // nkv
    h = cfg.hidden_size
    t = params["transformer"]
    v = cfg.vocab_size
    sd = {"transformer.word_embeddings.weight": np.asarray(
        params["embedding"]["word_embeddings"], dtype)[:v]}
    if cfg.tie_embed_logits:
        sd["lm_head.weight"] = sd["transformer.word_embeddings.weight"]
    else:
        sd["lm_head.weight"] = _t(np.asarray(params["lm_head"], dtype))[:v]
    sd["transformer.ln_f.weight"] = np.asarray(params["final_norm"]["scale"],
                                               dtype)
    sd["transformer.ln_f.bias"] = np.asarray(params["final_norm"]["bias"],
                                             dtype)
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        q = deinterleave_rope_rows(
            _t(np.asarray(t["attention"]["wq"][i], dtype)), nq, hd)
        wkv = np.asarray(t["attention"]["wkv"][i], dtype)  # [h, 2*nkv*hd]
        k = deinterleave_rope_rows(_t(wkv[:, :nkv * hd]), nkv, hd)
        vv = _t(wkv[:, nkv * hd:])
        qkv = np.concatenate(
            [q.reshape(nkv, qpg, hd, h), k.reshape(nkv, 1, hd, h),
             vv.reshape(nkv, 1, hd, h)], axis=1)
        sd[p + "self_attention.query_key_value.weight"] = qkv.reshape(
            nkv * (qpg + 2) * hd, h)
        sd[p + "self_attention.dense.weight"] = _t(
            np.asarray(t["attention"]["wo"][i], dtype))
        sd[p + "mlp.dense_h_to_4h.weight"] = _t(
            np.asarray(t["mlp"]["w1"][i], dtype))
        sd[p + "mlp.dense_4h_to_h.weight"] = _t(
            np.asarray(t["mlp"]["w2"][i], dtype))
        if cfg.parallel_layernorm:  # falcon-40b
            norms = (("input_norm", "ln_attn"), ("mlp_norm", "ln_mlp"))
        else:  # falcon-7b
            norms = (("input_norm", "input_layernorm"),)
        for group, name in norms:
            sd[p + name + ".weight"] = np.asarray(t[group]["scale"][i], dtype)
            sd[p + name + ".bias"] = np.asarray(t[group]["bias"][i], dtype)
    return sd

