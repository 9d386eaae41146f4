"""The port's weight converters (megatron_tpu_torch/convert/hf.py, meta.py,
megatron.py) against the JAX package's on the same numpy inputs, and the
converted models against `transformers`.

- Import and export are bit-exact against JAX's functions, leaf for leaf,
  dtype included: the same numpy arithmetic in the same order. Cases: a
  tiny Llama with GQA and a padded vocabulary (300 -> 384), Falcon in its
  7B multi-query layout and its 40B grouped (new_decoder_architecture)
  layout, Meta's consolidated-shard merge (bf16 and fp32 shards), and
  Megatron-LM checkpoints: a tp1 release, tp2 x pp2 training shards, pp2 x
  vpp2 chunks, the legacy qkv orders of checkpoint versions 0 and 1.0 (tp1
  and tp2), and the export (`save_megatron_checkpoint`) with biases, GLU and
  a GPT layout.
- The port's fp32 logits on tiny HF Llama and Falcon models converted by
  the port agree with `transformers`' at an average max-abs <= 1e-3, the
  reference's CI gate (measured ~1e-6: the same fp32 model in two
  frameworks).
"""
import dataclasses
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.convert import hf as jhf
from megatron_tpu.convert import megatron as jmeg
from megatron_tpu.convert import meta as jmeta
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert import hf as thf
from megatron_tpu_torch.convert import megatron as tmeg
from megatron_tpu_torch.convert import meta as tmeta
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                      model_forward)
from megatron_tpu_torch.verify_correctness import synthetic_hf_llama_names

torch.set_num_threads(2)
TOL = 1e-3  # the reference CI gate, average max-abs logit error in fp32

LLAMA = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             num_kv_heads=2, ffn_hidden_size=176, vocab_size=300,
             seq_length=32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def assert_trees_equal(got, want):
    """Same keys, shapes, dtypes and bits."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _cfgs(fn, **kw):
    return (getattr(jc, fn)("tiny", **kw).derived(),
            getattr(tc, fn)("tiny", **kw))


def _random_sd(names, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in names}


def _falcon_names(cfg):
    h, hd = cfg.hidden_size, cfg.kv_channels
    qkv = (cfg.num_attention_heads + 2 * cfg.num_kv_heads) * hd
    names = [("transformer.word_embeddings.weight", (cfg.vocab_size, h))]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        names += [(p + "self_attention.query_key_value.weight", (qkv, h)),
                  (p + "self_attention.dense.weight", (h, h)),
                  (p + "mlp.dense_h_to_4h.weight", (cfg.ffn_hidden_size, h)),
                  (p + "mlp.dense_4h_to_h.weight", (h, cfg.ffn_hidden_size))]
        norms = ("ln_attn", "ln_mlp") if cfg.parallel_layernorm \
            else ("input_layernorm",)
        for n in norms:
            names += [(p + n + ".weight", (h,)), (p + n + ".bias", (h,))]
    names += [("transformer.ln_f.weight", (h,)),
              ("transformer.ln_f.bias", (h,))]
    return names


FALCON = {
    "7b_multi_query": dict(num_layers=2, hidden_size=64,
                           num_attention_heads=4, num_kv_heads=1,
                           vocab_size=200, seq_length=32),
    "40b_grouped": dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                        num_kv_heads=2, vocab_size=200, seq_length=32,
                        parallel_layernorm=True),
}


# --- HF ---------------------------------------------------------------------

def test_hf_llama_import_export_bit_exact():
    jcfg, tcfg = _cfgs("llama2_config", **LLAMA)
    assert tcfg.padded_vocab_size == 384
    sd = _random_sd(synthetic_hf_llama_names(
        vocab=300, hidden=64, layers=2, heads=4, kv=2, ffn=176), 0)
    want = jhf.hf_llama_to_params(sd, jcfg)
    got = thf.hf_llama_to_params(sd, tcfg)
    assert_trees_equal(got, want)
    assert not got["embedding"]["word_embeddings"][300:].any()
    back = thf.params_to_hf_llama(got, tcfg)
    assert_trees_equal(back, jhf.params_to_hf_llama(want, jcfg))
    assert_trees_equal(back, sd)  # trimmed back to the vocabulary


@pytest.mark.parametrize("layout", sorted(FALCON))
def test_hf_falcon_import_export_bit_exact(layout):
    jcfg, tcfg = _cfgs("falcon_config", **FALCON[layout])
    sd = _random_sd(_falcon_names(tcfg), 1)
    want = jhf.hf_falcon_to_params(sd, jcfg)
    got = thf.hf_falcon_to_params(sd, tcfg)
    assert_trees_equal(got, want)
    back = thf.params_to_hf_falcon(got, tcfg)
    assert_trees_equal(back, jhf.params_to_hf_falcon(want, jcfg))
    tied = dict(sd, **{"lm_head.weight":
                       sd["transformer.word_embeddings.weight"]})
    assert_trees_equal(back, tied)


def test_interleave_rope_rows_matches_jax():
    w = np.random.default_rng(2).standard_normal((4 * 16, 8)).astype(
        np.float32)
    got = thf.interleave_rope_rows(w, 4, 16)
    np.testing.assert_array_equal(got, jhf.interleave_rope_rows(w, 4, 16))
    np.testing.assert_array_equal(thf.deinterleave_rope_rows(got, 4, 16), w)


# --- Meta -------------------------------------------------------------------

def _meta_shards(tmp_path, cfg, n_shards, dtype):
    """consolidated.NN.pth shards cut along Meta's tensor-parallel axes."""
    h, hd = cfg.hidden_size, cfg.kv_channels
    q, kv, ffn, v = (cfg.num_attention_heads * hd, cfg.num_kv_heads * hd,
                     cfg.ffn_hidden_size, cfg.vocab_size)
    names = [("tok_embeddings.weight", (v, h))]
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        names += [(p + "attention.wq.weight", (q, h)),
                  (p + "attention.wk.weight", (kv, h)),
                  (p + "attention.wv.weight", (kv, h)),
                  (p + "attention.wo.weight", (h, q)),
                  (p + "feed_forward.w1.weight", (ffn, h)),
                  (p + "feed_forward.w2.weight", (h, ffn)),
                  (p + "feed_forward.w3.weight", (ffn, h)),
                  (p + "attention_norm.weight", (h,)),
                  (p + "ffn_norm.weight", (h,))]
    names += [("norm.weight", (h,)), ("output.weight", (v, h))]
    full = _random_sd(names, 3)
    for s in range(n_shards):
        shard = {"rope.freqs": torch.ones(hd // 2)}
        for name, arr in full.items():
            axis = tmeta._SHARD_AXIS[tmeta._short(name)]
            if axis is not None:
                arr = np.split(arr, n_shards, axis=axis)[s]
            shard[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                dtype)
        torch.save(shard, os.path.join(tmp_path, f"consolidated.{s:02d}.pth"))
    return full


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_meta_shard_merge_and_import_bit_exact(tmp_path, dtype):
    jcfg, tcfg = _cfgs("llama2_config", **dict(LLAMA, vocab_size=256))
    full = _meta_shards(str(tmp_path), tcfg, 2, dtype)
    assert tmeta.list_meta_shards(str(tmp_path)) == \
        jmeta.list_meta_shards(str(tmp_path))
    got_sd = tmeta.merge_meta_llama(str(tmp_path))
    assert_trees_equal(got_sd, jmeta.merge_meta_llama(str(tmp_path)))
    if dtype == torch.float32:
        assert_trees_equal(got_sd, full)
    assert_trees_equal(tmeta.meta_llama_to_params(got_sd, tcfg),
                       jmeta.meta_llama_to_params(got_sd, jcfg))


# --- Megatron-LM ------------------------------------------------------------

MEG = dict(num_layers=4, hidden_size=64, num_attention_heads=4,
           num_kv_heads=2, ffn_hidden_size=176, vocab_size=128,
           make_vocab_size_divisible_by=1, seq_length=64,
           compute_dtype="float32")


def _meg_cfgs(**kw):
    kw = dict(MEG, **kw)
    return (jc.ModelConfig(**kw).derived(), tc.ModelConfig(**kw).derived())


def _lm_dict(cfg, seed=4):
    """A random language_model dict in the reference's release spelling."""
    h, hd = cfg.hidden_size, cfg.kv_channels
    qkv = (cfg.num_attention_heads + 2 * cfg.num_kv_heads) * hd
    ffn, v = cfg.ffn_hidden_size, cfg.padded_vocab_size
    names = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        names += [(p + "attention.query_key_value.weight", (qkv, h)),
                  (p + "attention.dense.weight", (h, h)),
                  (p + "mlp.dense_h_to_4h.weight", (2 * ffn, h)),
                  (p + "mlp.dense_4h_to_h.weight", (h, ffn)),
                  (p + "input_layernorm.weight", (h,)),
                  (p + "post_attention_layernorm.weight", (h,))]
    names.append(("final_layernorm.weight", (h,)))
    enc = _random_sd(names, seed)
    rest = _random_sd([("emb", (v, h)), ("head", (v, h))], seed + 1)
    return {"embedding": {"word_embeddings.weight": rest["emb"]},
            "transformer": enc, "lm_head": rest["head"]}


def _args_ns(cfg, **extra):
    d = dict(num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
             ffn_hidden_size=cfg.ffn_hidden_size,
             num_attention_heads=cfg.num_attention_heads,
             num_attention_heads_kv=cfg.num_kv_heads,
             padded_vocab_size=cfg.padded_vocab_size,
             glu_activation="swiglu", use_rms_norm=True,
             tie_embed_logits=False, use_bias=False,
             position_embedding_type="rotary", seq_length=cfg.seq_length,
             layernorm_epsilon=1e-5,
             max_position_embeddings=cfg.max_position_embeddings)
    d.update(extra)
    return Namespace(**d)


def _torchify(tree):
    return {k: (_torchify(v) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in tree.items()}


def _write(root, tag, rank_dir, payload):
    d = os.path.join(root, tag, rank_dir)
    os.makedirs(d, exist_ok=True)
    torch.save(payload, os.path.join(d, "model_optim_rng.pt"))
    with open(os.path.join(root, "latest_checkpointed_iteration.txt"),
              "w") as f:
        f.write(tag.replace("iter_", "").lstrip("0") or "0"
                if tag != "release" else "release")


def _shard_tp(lm, cfg, tp):
    """Per-tp-rank dicts in the reference's parallel-layer layouts."""
    hd, nq, nkv = cfg.kv_channels, cfg.num_attention_heads, cfg.num_kv_heads
    per, ffn = nq // nkv, cfg.ffn_hidden_size
    out = []
    for t in range(tp):
        enc = {}
        for k, v in lm["transformer"].items():
            if "query_key_value" in k:
                rows = (per + 2) * hd
                enc[k] = v[t * nkv // tp * rows:(t + 1) * nkv // tp * rows]
            elif "dense_h_to_4h" in k:
                up, gate = np.split(v, 2, axis=0)
                f0, f1 = t * ffn // tp, (t + 1) * ffn // tp
                enc[k] = np.concatenate([up[f0:f1], gate[f0:f1]])
            elif k.endswith(("attention.dense.weight",
                             "mlp.dense_4h_to_h.weight")):
                cols = v.shape[1] // tp
                enc[k] = v[:, t * cols:(t + 1) * cols]
            else:
                enc[k] = v
        rows = lm["lm_head"].shape[0] // tp
        out.append({"embedding": {"word_embeddings.weight": lm["embedding"][
            "word_embeddings.weight"][t * rows:(t + 1) * rows]},
            "transformer": enc,
            "lm_head": lm["lm_head"][t * rows:(t + 1) * rows]})
    return out


def _training_spelling(lm, lo, hi, first, last):
    """The reference's training save: "encoder" and "self_attention" keys,
    a nested word_embeddings, local layer indices of layers [lo, hi)."""
    enc = {}
    for k, v in lm["transformer"].items():
        if k.startswith("layers."):
            i = int(k.split(".")[1])
            if lo <= i < hi:
                rest = k.split(".", 2)[2].replace("attention.",
                                                  "self_attention.", 1)
                enc[f"layers.{i - lo}.{rest}"] = torch.from_numpy(v)
        elif last:
            enc[k] = torch.from_numpy(v)
    out = {"encoder": enc}
    if first:
        out["embedding"] = {"word_embeddings": {"weight": torch.from_numpy(
            lm["embedding"]["word_embeddings.weight"])}}
    if last:
        out["lm_head"] = torch.from_numpy(lm["lm_head"])
    return out


def _legacy(lm, cfg, version, heads):
    """qkv rows of checkpoint_version 0 ([3, np, hn]) or 1.0
    ([np, hn, 3]) over `heads` heads."""
    out = dict(lm, transformer=dict(lm["transformer"]))
    hd = cfg.kv_channels
    for k, w in lm["transformer"].items():
        if "query_key_value" in k:
            r = w.reshape(heads, 3, hd, -1)
            r = r.transpose(1, 0, 2, 3) if version == 0 \
                else r.transpose(0, 2, 1, 3)
            out["transformer"][k] = np.ascontiguousarray(r).reshape(w.shape)
    return out


def _write_case(root, case, cfg):
    lm = _lm_dict(cfg)
    L = cfg.num_layers
    if case == "release_tp1":
        _write(root, "release", "mp_rank_00", {
            "iteration": "release", "checkpoint_version": 3.0,
            "args": _args_ns(cfg), "model": {"language_model":
                                             _torchify(lm)}})
    elif case == "tp2_pp2":
        for t, part in enumerate(_shard_tp(lm, cfg, 2)):
            for p in range(2):
                _write(root, "iter_0000100", f"mp_rank_{t:02d}_{p:03d}", {
                    "iteration": 100, "checkpoint_version": 3.0,
                    "args": _args_ns(cfg, tensor_model_parallel_size=2,
                                     pipeline_model_parallel_size=2),
                    "model": {"language_model": _training_spelling(
                        part, p * L // 2, (p + 1) * L // 2, p == 0,
                        p == 1)}})
    elif case == "pp2_vpp2":
        for p in range(2):
            payload = {"iteration": 100, "checkpoint_version": 3.0,
                       "args": _args_ns(
                           cfg, pipeline_model_parallel_size=2,
                           virtual_pipeline_model_parallel_size=2)}
            for c in range(2):
                lo = c * (L // 2) + p * (L // 4)
                payload[f"model{c}"] = {"language_model": _training_spelling(
                    lm, lo, lo + 1, p == 0 and c == 0, p == 1 and c == 1)}
            _write(root, "iter_0000100", f"mp_rank_00_{p:03d}", payload)
    elif case.startswith("legacy"):
        version = 0 if "v0" in case else 1.0
        tp = 2 if "tp2" in case else 1
        parts = _shard_tp(lm, cfg, tp) if tp > 1 else [lm]
        for t, part in enumerate(parts):
            part = _legacy(part, cfg, version,
                           cfg.num_attention_heads // tp)
            _write(root, "release", f"mp_rank_{t:02d}", {
                "iteration": "release", "checkpoint_version": version,
                "args": _args_ns(cfg, tensor_model_parallel_size=tp),
                "model": {"language_model": _torchify(part)}})
    return root


MEG_CASES = {"release_tp1": {}, "tp2_pp2": {}, "pp2_vpp2": {},
             "legacy_v0": dict(num_kv_heads=4),
             "legacy_v1": dict(num_kv_heads=4),
             "legacy_v0_tp2": dict(num_kv_heads=4)}


@pytest.mark.parametrize("case", sorted(MEG_CASES))
def test_megatron_import_bit_exact(tmp_path, case):
    jcfg, tcfg = _meg_cfgs(**MEG_CASES[case])
    root = _write_case(str(tmp_path), case, tcfg)
    jsd, jargs, jinfo = jmeg.load_megatron_checkpoint(root)
    tsd, targs, tinfo = tmeg.load_megatron_checkpoint(root)
    assert tinfo == jinfo and targs == jargs
    assert_trees_equal(tsd, jsd)
    want = jmeg.megatron_to_params(jsd, jcfg)
    assert_trees_equal(tmeg.megatron_to_params(tsd, tcfg), want)
    got_cfg = tmeg.config_from_megatron_args(targs)
    assert dataclasses.asdict(got_cfg) == {
        k: v for k, v in dataclasses.asdict(
            jmeg.config_from_megatron_args(jargs)).items()
        if k in dataclasses.asdict(got_cfg)}


@pytest.mark.parametrize("variant", ["llama", "biased_glu", "gpt"])
def test_megatron_export_bit_exact(tmp_path, variant):
    extra = {"llama": {},
             "biased_glu": dict(use_bias=True),
             "gpt": dict(use_bias=True, use_rotary_emb=False,
                         use_position_embedding=True, norm_type="layernorm",
                         activation="gelu", tie_embed_logits=True)}[variant]
    jcfg, tcfg = _meg_cfgs(num_layers=3, **extra)
    meta = LanguageModel(tcfg, device="meta").state_dict()
    rng = np.random.default_rng(5)
    flat = {k.replace(".", "/"): rng.standard_normal(tuple(t.shape)).astype(
        np.float32) for k, t in meta.items()}
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    assert_trees_equal(tmeg.params_to_megatron(tree, tcfg),
                       jmeg.params_to_megatron(tree, jcfg))
    jmeg.save_megatron_checkpoint(str(tmp_path / "j"), tree, jcfg)
    tmeg.save_megatron_checkpoint(str(tmp_path / "t"), tree, tcfg)
    path = os.path.join("release", "mp_rank_00", "model_optim_rng.pt")
    a = torch.load(tmp_path / "t" / path, weights_only=False)
    b = torch.load(tmp_path / "j" / path, weights_only=False)
    assert vars(a.pop("args")) == vars(b.pop("args"))
    la, lb = a.pop("model")["language_model"], b.pop("model")[
        "language_model"]
    assert a == b
    assert_trees_equal({k: ({kk: vv.numpy() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.numpy())
                        for k, v in la.items()},
                       {k: ({kk: vv.numpy() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.numpy())
                        for k, v in lb.items()})
    sd, _, _ = tmeg.load_megatron_checkpoint(str(tmp_path / "t"))
    assert_trees_equal(tmeg.megatron_to_params(sd, tcfg), tree)


# --- logits against transformers --------------------------------------------

def _port_logits(params, cfg, tokens):
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = LanguageModel.from_state_dict(
        cfg, params_from_numpy(params, cfg, "cpu"))
    with torch.no_grad():
        logits, _ = model_forward(model, torch.from_numpy(tokens), cfg)
    return logits.numpy()[..., :cfg.vocab_size]


def _hf_gap(hf_model, params, cfg, seed):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int64)
    with torch.no_grad():
        want = hf_model(torch.from_numpy(tokens)).logits.float().numpy()
    return float(np.abs(_port_logits(params, cfg, tokens) - want)
                 .max(-1).mean())


def test_llama_logits_match_transformers():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=300, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=176,
        max_position_embeddings=32, rms_norm_eps=1e-5,
        tie_word_embeddings=False)).eval()
    _, tcfg = _cfgs("llama2_config", **LLAMA)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    assert _hf_gap(hf, thf.hf_llama_to_params(sd, tcfg), tcfg, 6) <= TOL


@pytest.mark.parametrize("layout", sorted(FALCON))
def test_falcon_logits_match_transformers(layout):
    transformers = pytest.importorskip("transformers")
    kw = FALCON[layout]
    torch.manual_seed(1)
    hf = transformers.FalconForCausalLM(transformers.FalconConfig(
        vocab_size=kw["vocab_size"], hidden_size=kw["hidden_size"],
        num_hidden_layers=kw["num_layers"],
        num_attention_heads=kw["num_attention_heads"],
        num_kv_heads=kw["num_kv_heads"],
        multi_query=kw["num_kv_heads"] == 1,
        new_decoder_architecture=kw.get("parallel_layernorm", False),
        parallel_attn=True, bias=False, alibi=False,
        rope_theta=10000.0)).eval()
    _, tcfg = _cfgs("falcon_config", **kw)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    assert _hf_gap(hf, thf.hf_falcon_to_params(sd, tcfg), tcfg, 7) <= TOL
