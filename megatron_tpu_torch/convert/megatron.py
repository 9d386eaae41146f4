"""Reference Megatron-LM checkpoints (the `mp_rank` .pt layout) in both
directions (megatron_tpu/convert/megatron.py).

The reference trains and serves from torch checkpoints laid out as

    <load_dir>/latest_checkpointed_iteration.txt        # "release" or int
    <load_dir>/iter_0000500/mp_rank_00/model_optim_rng.pt        # pp == 1
    <load_dir>/iter_0000500/mp_rank_01_003/model_optim_rng.pt    # tp 1, pp 3

Each shard's payload is {"iteration", "checkpoint_version", "args":
Namespace, "model": {"language_model": {...}}}, or "model0".."model{vpp-1}"
chunks under interleaved virtual pipelining. `load_megatron_checkpoint`
merges the tp, pp and vpp shards of such a checkpoint and
`megatron_to_params` maps it onto the parameter tree; `params_to_megatron`
and `save_megatron_checkpoint` write the reverse direction, a tp1/pp1
release the reference reads.

Format facts:
- tp merge axes: qkv, embedding, lm_head and h_to_4h concatenate on dim 0,
  attention dense and 4h_to_h on dim 1; norms and the biases of
  row-parallel layers are replicated.
- GLU h_to_4h shards are per-rank [up; gate] halves: merged as chunk(2,
  dim=0) per rank, then all ups and all gates (w3 before w1).
- QKV rows are grouped per kv head, [q_0..q_{nq/nkv-1}, k, v] blocks of
  head_dim rows each, already in the interleaved-pair RoPE order the model
  uses: un-grouping is a pure row permutation.
- checkpoint_version < 2.0 stores qkv rows [num_splits*np*hn] (v0) or
  [np*hn*num_splits] (v1); the fix-up, per tp shard before the merge,
  transposes them back (MHA only, as the reference).
- vpp chunk c on pp rank r holds global layers
  c*(L/vpp) + r*(L/(pp*vpp)) + local.
- Release checkpoints written by weights2megatron spell the keys
  {"transformer": {"layers.N.attention..."}} with a flat
  "word_embeddings.weight"; training checkpoints use {"encoder":
  {"layers.N.self_attention..."}} with a nested {"word_embeddings":
  {"weight"}}. Both are read.

The payload pickles an argparse.Namespace (and, from the reference's own
save, megatron enums), so it loads only with `weights_only=False`: this
module is the one place of the port that loads so, on the user's own
checkpoints, with value-identical enum stubs when no `megatron` package is
importable. Optimizer moments are not imported (the reference's
--finetune / --no_load_optim semantics).
"""
from __future__ import annotations

import os
import re
import sys
from typing import Mapping, Optional

import numpy as np

import torch

from megatron_tpu_torch.config import ModelConfig

TRACKER = "latest_checkpointed_iteration.txt"
PAYLOAD = "model_optim_rng.pt"


# ---------------------------------------------------------------------------
# layout discovery
# ---------------------------------------------------------------------------

def read_tracker(load_dir: str) -> str:
    with open(os.path.join(load_dir, TRACKER)) as f:
        return f.read().strip()


def iter_dirname(iteration) -> str:
    if iteration == "release":
        return "release"
    return f"iter_{int(iteration):07d}"


def discover_shards(ckpt_dir: str) -> dict[tuple[int, int], str]:
    """Map (tp_rank, pp_rank) -> payload path under one iteration dir.

    Handles both `mp_rank_XX` (pp==1) and `mp_rank_XX_YYY` naming
    (ref: checkpointing.py:96-103); a distributed-optimizer layout's
    extra `mp_rank_XX_dpr` optim dirs contain no PAYLOAD and are skipped.
    """
    shards: dict[tuple[int, int], str] = {}
    for name in sorted(os.listdir(ckpt_dir)):
        m = re.fullmatch(r"mp_rank_(\d{2})(?:_(\d{3}))?", name)
        if not m:
            continue
        path = os.path.join(ckpt_dir, name, PAYLOAD)
        if not os.path.exists(path):
            continue
        shards[(int(m.group(1)), int(m.group(2) or 0))] = path
    if not shards:
        raise FileNotFoundError(f"no mp_rank_*/{PAYLOAD} under {ckpt_dir}")
    tp = 1 + max(t for t, _ in shards)
    pp = 1 + max(p for _, p in shards)
    missing = [(t, p) for t in range(tp) for p in range(pp)
               if (t, p) not in shards]
    if missing:
        raise FileNotFoundError(f"incomplete shard grid {tp}x{pp}: "
                                f"missing {missing}")
    return shards


# ---------------------------------------------------------------------------
# per-shard normalization
# ---------------------------------------------------------------------------

def _normalize_lm(lm: Mapping) -> dict:
    """One shard's language_model dict -> {"embedding": flat, "encoder":
    flat (self_attention spelling), "lm_head": arr|None} regardless of
    which key-spelling era produced it."""
    out = {"embedding": {}, "encoder": {}, "lm_head": None}
    enc = lm.get("encoder", lm.get("transformer"))
    if enc is not None:
        for k, v in enc.items():
            out["encoder"][k.replace(".attention.", ".self_attention.")] = v
    emb = lm.get("embedding", {})
    for k, v in emb.items():
        if isinstance(v, Mapping):  # nested {"word_embeddings": {"weight"}}
            for kk, vv in v.items():
                out["embedding"][f"{k}.{kk}"] = vv
        else:
            out["embedding"][k] = v
    if "lm_head" in lm:
        out["lm_head"] = lm["lm_head"]
    return out


def _fix_qkv_legacy(w: np.ndarray, version: float, n_heads: int,
                    head_dim: int) -> np.ndarray:
    """checkpoint_version < 2.0 row-order fixup (MHA qkv only).

    v0 stored [num_splits, np, hn, ...]; v1 stored [np, hn, num_splits,
    ...]; canonical (>=2.0) is [np, num_splits, hn, ...]
    (ref: checkpointing.py:341-377 _transpose_first_dim, 379-411)."""
    tail = w.shape[1:]
    if version == 0:
        r = w.reshape((3, n_heads, head_dim) + tail)
        return r.transpose(1, 0, *range(2, r.ndim)).reshape(w.shape)
    if version == 1.0:
        r = w.reshape((n_heads, head_dim, 3) + tail)
        return r.transpose(0, 2, 1, *range(3, r.ndim)).reshape(w.shape)
    raise ValueError(f"invalid legacy checkpoint version {version}")


# ---------------------------------------------------------------------------
# tp merge
# ---------------------------------------------------------------------------

def _merge_tp(key: str, parts: list[np.ndarray], glu: bool) -> np.ndarray:
    """Merge one encoder tensor's tp shards (rules in module docstring)."""
    if len(parts) == 1:
        return parts[0]
    if ".mlp.dense_h_to_4h." in key and glu:
        ups, gates = [], []
        for p in parts:
            u, g = np.split(p, 2, axis=0)
            ups.append(u)
            gates.append(g)
        return np.concatenate(ups + gates, axis=0)
    if (".self_attention.query_key_value." in key
            or ".mlp.dense_h_to_4h." in key
            or key in ("word_embeddings.weight", "lm_head")):
        return np.concatenate(parts, axis=0)
    if key.endswith((".self_attention.dense.weight",
                     ".mlp.dense_4h_to_h.weight")):
        return np.concatenate(parts, axis=1)
    # norms, row-parallel biases, anything replicated
    for t, p in enumerate(parts[1:], 1):
        np.testing.assert_allclose(
            parts[0], p, rtol=0, atol=0,
            err_msg=f"{key}: replicated shard {t} differs from rank 0")
    return parts[0]


def _install_enum_stubs():
    """Make reference-pickled enums loadable WITHOUT the reference tree.

    Checkpoints written by the reference's own save_checkpoint pickle
    enum members from megatron.model.enums inside the args namespace
    (validate_args converts position_embedding_type to the enum,
    ref: megatron/arguments.py:245-246; values ref: model/enums.py).
    When `megatron` is not importable, install stub modules holding
    value-identical enums so unpickling reconstructs members whose
    str() the config mapping below understands. Never shadows a real
    megatron package."""
    import enum
    import importlib.util
    import sys
    import types

    if importlib.util.find_spec("megatron") is not None:
        return []
    root = types.ModuleType("megatron")
    model = types.ModuleType("megatron.model")
    enums = types.ModuleType("megatron.model.enums")
    for name, members in (
            ("ModelType", ("encoder_or_decoder", "encoder_and_decoder")),
            ("LayerType", ("encoder", "decoder")),
            ("AttnType", ("self_attn", "cross_attn")),
            ("AttnMaskType", ("padding", "causal")),
            ("PositionEmbeddingType", ("rotary", "absolute")),
    ):
        setattr(enums, name,
                enum.Enum(name, {m: i + 1 for i, m in enumerate(members)}))
    root.model = model
    model.enums = enums
    names = ["megatron", "megatron.model", "megatron.model.enums"]
    sys.modules.update(zip(names, (root, model, enums)))
    return names


def _tolerant_torch_load(path: str, installed: list):
    """`installed` accumulates stub module names across calls; the
    CALLER removes them when the whole checkpoint is loaded (the stubs
    must not outlive the load — they would shadow a real megatron tree
    put on sys.path later in the process)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        if "megatron" not in str(e):
            raise
        if not installed:
            installed.extend(_install_enum_stubs())
        return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# load + merge
# ---------------------------------------------------------------------------

def load_megatron_checkpoint(load_dir: str, iteration=None
                             ) -> tuple[dict, dict, dict]:
    """Load a reference-layout checkpoint, merging tp/pp/vpp shards.

    Returns (sd, args, meta): `sd` is a flat global-layer-indexed dict in
    the self_attention spelling plus "word_embeddings.weight" /
    "position_embeddings.weight" / "final_layernorm.*" / "lm_head"; `args`
    is the reference argparse namespace as a plain dict; `meta` carries
    iteration / checkpoint_version / tp / pp."""
    if iteration is None:
        iteration = read_tracker(load_dir)
    ckpt_dir = os.path.join(load_dir, iter_dirname(iteration))
    shards = discover_shards(ckpt_dir)
    tp = 1 + max(t for t, _ in shards)
    pp = 1 + max(p for _, p in shards)

    # torch.load(weights_only=False): the payload embeds an
    # argparse.Namespace; these files are the user's own checkpoints.
    # Stub installation state is carried across shards so a 32-shard
    # enum-bearing checkpoint pays at most ONE failed load, not one per
    # shard.
    loaded = {}
    installed: list = []
    try:
        for rank, path in shards.items():
            loaded[rank] = _tolerant_torch_load(path, installed)
    finally:
        for m in installed:
            sys.modules.pop(m, None)
    first = loaded[(0, 0)]
    version = float(first.get("checkpoint_version", 0))
    args_ns = first.get("args")
    args = dict(vars(args_ns)) if args_ns is not None else {}
    vpp = int(args.get("virtual_pipeline_model_parallel_size") or 1)
    glu = bool(args.get("glu_activation"))
    n_heads = int(args.get("num_attention_heads", 0))
    n_kv = int(args.get("num_attention_heads_kv", n_heads) or n_heads)
    hidden = int(args.get("hidden_size", 0))
    head_dim = hidden // n_heads if n_heads else 0

    def model_chunks(payload) -> list[dict]:
        if "model" in payload:
            return [_normalize_lm(payload["model"]["language_model"])]
        return [_normalize_lm(payload[f"model{c}"]["language_model"])
                for c in range(vpp)]

    grid = {rank: model_chunks(p) for rank, p in loaded.items()}
    n_chunks = len(grid[(0, 0)])

    # count total layers to place each (pp, chunk)'s local block globally
    per_block = None
    for (t, p), chunks in grid.items():
        for chunk in chunks:
            n_local = len({m.group(1) for k in chunk["encoder"]
                           for m in [re.match(r"layers\.(\d+)\.", k)] if m})
            if per_block is None:
                per_block = n_local
            elif n_local != per_block:
                raise ValueError("ragged layer blocks across shards "
                                 f"({n_local} vs {per_block})")
    total_layers = per_block * pp * n_chunks
    if "num_layers" in args and args["num_layers"] is not None:
        declared = int(args["num_layers"])
        if declared != total_layers:
            raise ValueError(f"args.num_layers={declared} but shards hold "
                             f"{total_layers}")

    sd: dict[str, np.ndarray] = {}
    to_np = lambda v: np.asarray(v.float().numpy() if hasattr(v, "float")
                                 else v)
    # the legacy (<2.0) qkv row orders are PER-SHARD layouts over that
    # rank's heads — the fixup must run on each tp shard BEFORE the merge
    # (the reference fixes per rank at load: checkpointing.py:379-411)
    fix_legacy_qkv = (version < 2.0 and n_heads == n_kv)

    def put(key, parts):
        arrs = [to_np(p) for p in parts]
        if fix_legacy_qkv and ".query_key_value." in key:
            arrs = [_fix_qkv_legacy(a, version, n_heads // len(arrs),
                                    head_dim) for a in arrs]
        sd[key] = _merge_tp(key, arrs, glu)

    # encoder tensors, re-keyed to global layer indices
    for c in range(n_chunks):
        for p in range(pp):
            offset = (c * (total_layers // n_chunks)
                      + p * per_block)
            keys = grid[(0, p)][c]["encoder"].keys()
            for k in keys:
                m = re.match(r"layers\.(\d+)\.(.*)", k)
                if m:
                    gk = f"layers.{int(m.group(1)) + offset}.{m.group(2)}"
                elif p == pp - 1 and c == n_chunks - 1:
                    gk = k  # final_layernorm rides the last block
                else:
                    continue
                put(gk, [grid[(t, p)][c]["encoder"][k] for t in range(tp)])

    # embedding (first stage, first chunk) / lm_head (last stage, last chunk)
    emb = [grid[(t, 0)][0]["embedding"] for t in range(tp)]
    put("word_embeddings.weight",
        [e["word_embeddings.weight"] for e in emb])
    if "position_embeddings.weight" in emb[0]:
        put("position_embeddings.weight",
            [emb[0]["position_embeddings.weight"]])
    heads = [grid[(t, pp - 1)][n_chunks - 1]["lm_head"] for t in range(tp)]
    if heads[0] is not None:
        put("lm_head", heads)

    meta = {"iteration": iteration, "checkpoint_version": version,
            "tp": tp, "pp": pp, "vpp": n_chunks}
    return sd, args, meta


# ---------------------------------------------------------------------------
# merged sd -> our param tree
# ---------------------------------------------------------------------------

def _t(w: np.ndarray) -> np.ndarray:
    # torch's blocked, multi-threaded transpose: numpy's strided copy of a
    # 7B projection is several times slower (the values are only moved)
    return torch.from_numpy(np.asarray(w)).t().contiguous().numpy()


def _fit_vocab(w: np.ndarray, padded: int) -> np.ndarray:
    """Slice or zero-pad checkpoint vocab rows to our padded size (the two
    sides may pad differently: make_vocab_size_divisible_by * tp)."""
    if w.shape[0] > padded:
        return w[:padded]
    if w.shape[0] < padded:
        return np.concatenate(
            [w, np.zeros((padded - w.shape[0], w.shape[1]), w.dtype)])
    return w


def _ungroup_qkv(qkv: np.ndarray, nq: int, nkv: int, hd: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grouped [(q..q,k,v) x nkv] rows -> (wq, wk, wv) with sequential
    global head order (inverse of weights2megatron.py:87-99)."""
    per = nq // nkv
    g = qkv.reshape((nkv, (per + 2) * hd) + qkv.shape[1:])
    qs = g[:, :per * hd]
    k = g[:, per * hd:(per + 1) * hd]
    v = g[:, (per + 1) * hd:]
    return (qs.reshape((nq * hd,) + qkv.shape[1:]),
            k.reshape((nkv * hd,) + qkv.shape[1:]),
            v.reshape((nkv * hd,) + qkv.shape[1:]))


def _group_qkv(q: np.ndarray, k: np.ndarray, v: np.ndarray, nkv: int,
               per: int, hd: int) -> np.ndarray:
    """Sequential-head (q, k, v) rows -> the grouped [(q..q,k,v) x nkv]
    layout — the inverse of _ungroup_qkv; serves weights AND biases."""
    groups = []
    for g in range(nkv):
        groups.append(q[g * per * hd:(g + 1) * per * hd])
        groups.append(k[g * hd:(g + 1) * hd])
        groups.append(v[g * hd:(g + 1) * hd])
    return np.concatenate(groups)


def megatron_to_params(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                       dtype=np.float32) -> dict:
    """Merged reference sd (from load_megatron_checkpoint) -> our stacked
    param tree (the same layout convert/hf.py produces)."""
    hd = cfg.kv_channels
    nq = cfg.num_attention_heads
    nkv = cfg.num_kv_heads
    L = cfg.num_layers
    has_bias = cfg.use_bias
    norm_has_bias = cfg.norm_type == "layernorm"

    def get(name):
        return np.asarray(sd[name], dtype=dtype)

    layers: dict = {"attention": {"wq": [], "wkv": [], "wo": []},
                    "mlp": {"w1": [], "w2": []},
                    "input_norm": {"scale": []},
                    "post_attn_norm": {"scale": []}}
    if has_bias:
        layers["attention"].update({"bq": [], "bkv": [], "bo": []})
        layers["mlp"].update({"b1": [], "b2": []})
    if norm_has_bias:
        layers["input_norm"]["bias"] = []
        layers["post_attn_norm"]["bias"] = []

    for i in range(L):
        p = f"layers.{i}."
        wq, wk, wv = _ungroup_qkv(
            get(p + "self_attention.query_key_value.weight"), nq, nkv, hd)
        layers["attention"]["wq"].append(_t(wq))
        layers["attention"]["wkv"].append(
            np.concatenate([_t(wk), _t(wv)], axis=1))
        layers["attention"]["wo"].append(
            _t(get(p + "self_attention.dense.weight")))
        w_in = get(p + "mlp.dense_h_to_4h.weight")
        if cfg.is_glu:
            up, gate = np.split(w_in, 2, axis=0)
            layers["mlp"]["w1"].append(np.stack([_t(gate), _t(up)], axis=1))
        else:
            layers["mlp"]["w1"].append(_t(w_in))
        layers["mlp"]["w2"].append(_t(get(p + "mlp.dense_4h_to_h.weight")))
        layers["input_norm"]["scale"].append(
            get(p + "input_layernorm.weight"))
        layers["post_attn_norm"]["scale"].append(
            get(p + "post_attention_layernorm.weight"))
        if norm_has_bias:
            layers["input_norm"]["bias"].append(
                get(p + "input_layernorm.bias"))
            layers["post_attn_norm"]["bias"].append(
                get(p + "post_attention_layernorm.bias"))
        if has_bias:
            bq, bk, bv = _ungroup_qkv(
                get(p + "self_attention.query_key_value.bias"), nq, nkv, hd)
            layers["attention"]["bq"].append(bq)
            layers["attention"]["bkv"].append(np.concatenate([bk, bv]))
            layers["attention"]["bo"].append(
                get(p + "self_attention.dense.bias"))
            b_in = get(p + "mlp.dense_h_to_4h.bias")
            layers["mlp"]["b1"].append(
                np.stack(np.split(b_in, 2)[::-1]) if cfg.is_glu else b_in)
            layers["mlp"]["b2"].append(get(p + "mlp.dense_4h_to_h.bias"))

    params = {
        "embedding": {"word_embeddings": _fit_vocab(
            get("word_embeddings.weight"), cfg.padded_vocab_size)},
        "transformer": {k: {kk: np.stack(vv) for kk, vv in v.items()}
                        for k, v in layers.items()},
        "final_norm": {"scale": get("final_layernorm.weight")},
    }
    if norm_has_bias:
        params["final_norm"]["bias"] = get("final_layernorm.bias")
    if cfg.use_position_embedding:
        params["embedding"]["position_embeddings"] = get(
            "position_embeddings.weight")
    if not cfg.tie_embed_logits:
        params["lm_head"] = _t(_fit_vocab(get("lm_head"),
                                          cfg.padded_vocab_size))
    return params


def config_from_megatron_args(args: Mapping, **overrides) -> ModelConfig:
    """Best-effort ModelConfig from the checkpoint's embedded reference
    argparse namespace (ref: megatron/arguments.py names)."""
    n_heads = int(args["num_attention_heads"])
    fields = dict(
        num_layers=int(args["num_layers"]),
        hidden_size=int(args["hidden_size"]),
        ffn_hidden_size=(int(args["ffn_hidden_size"])
                         if args.get("ffn_hidden_size") else None),
        num_attention_heads=n_heads,
        num_kv_heads=int(args.get("num_attention_heads_kv") or n_heads),
        seq_length=int(args.get("seq_length") or 2048),
        max_position_embeddings=(int(args["max_position_embeddings"])
                                 if args.get("max_position_embeddings")
                                 else None),
        vocab_size=int(args.get("padded_vocab_size")
                       or args.get("vocab_size") or 32000),
        make_vocab_size_divisible_by=1,
        use_rotary_emb=(str(args.get("position_embedding_type", "rotary"))
                        .endswith("rotary")),
        use_position_embedding=(str(args.get("position_embedding_type", ""))
                                .endswith("absolute")),
        norm_type="rmsnorm" if args.get("use_rms_norm") else "layernorm",
        norm_epsilon=float(args.get("layernorm_epsilon") or 1e-5),
        activation=str(args.get("glu_activation") or "gelu"),
        use_bias=bool(args.get("use_bias", False)),
        parallel_attn=bool(args.get("parallel_attn", False)),
        parallel_layernorm=bool(args.get("parallel_layernorm", False)),
        tie_embed_logits=bool(args.get("tie_embed_logits", False)),
    )
    fields.update(overrides)
    return ModelConfig(**fields).derived()


# ---------------------------------------------------------------------------
# export: our params -> reference layout (release, tp1/pp1)
# ---------------------------------------------------------------------------

def params_to_megatron(params, cfg: ModelConfig, dtype=np.float32) -> dict:
    """Our param tree -> the reference's language_model dict (release
    spelling, single shard) — the inverse of megatron_to_params."""
    hd = cfg.kv_channels
    nq = cfg.num_attention_heads
    nkv = cfg.num_kv_heads
    per = nq // nkv
    t = params["transformer"]
    enc: dict[str, np.ndarray] = {}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        wq = _t(np.asarray(t["attention"]["wq"][i], dtype))  # [nq*hd, h]
        wkv = np.asarray(t["attention"]["wkv"][i], dtype)
        wk = _t(wkv[:, :nkv * hd])
        wv = _t(wkv[:, nkv * hd:])
        enc[p + "attention.query_key_value.weight"] = _group_qkv(
            wq, wk, wv, nkv, per, hd)
        enc[p + "attention.dense.weight"] = _t(
            np.asarray(t["attention"]["wo"][i], dtype))
        w1 = np.asarray(t["mlp"]["w1"][i], dtype)
        if cfg.is_glu:  # [h, 2, ffn] (gate, up) -> [up; gate] rows
            enc[p + "mlp.dense_h_to_4h.weight"] = np.concatenate(
                [_t(w1[:, 1]), _t(w1[:, 0])])
        else:
            enc[p + "mlp.dense_h_to_4h.weight"] = _t(w1)
        enc[p + "mlp.dense_4h_to_h.weight"] = _t(
            np.asarray(t["mlp"]["w2"][i], dtype))
        enc[p + "input_layernorm.weight"] = np.asarray(
            t["input_norm"]["scale"][i], dtype)
        enc[p + "post_attention_layernorm.weight"] = np.asarray(
            t["post_attn_norm"]["scale"][i], dtype)
        if cfg.norm_type == "layernorm":
            enc[p + "input_layernorm.bias"] = np.asarray(
                t["input_norm"]["bias"][i], dtype)
            enc[p + "post_attention_layernorm.bias"] = np.asarray(
                t["post_attn_norm"]["bias"][i], dtype)
        if cfg.use_bias:
            bq = np.asarray(t["attention"]["bq"][i], dtype)
            bkv = np.asarray(t["attention"]["bkv"][i], dtype)
            bk, bv = bkv[:nkv * hd], bkv[nkv * hd:]
            enc[p + "attention.query_key_value.bias"] = _group_qkv(
                bq, bk, bv, nkv, per, hd)
            enc[p + "attention.dense.bias"] = np.asarray(
                t["attention"]["bo"][i], dtype)
            b1 = np.asarray(t["mlp"]["b1"][i], dtype)
            enc[p + "mlp.dense_h_to_4h.bias"] = (
                np.concatenate([b1[1], b1[0]])  # (gate, up) -> [up; gate]
                if cfg.is_glu else b1)
            enc[p + "mlp.dense_4h_to_h.bias"] = np.asarray(
                t["mlp"]["b2"][i], dtype)
    enc["final_layernorm.weight"] = np.asarray(
        params["final_norm"]["scale"], dtype)
    if cfg.norm_type == "layernorm":
        enc["final_layernorm.bias"] = np.asarray(
            params["final_norm"]["bias"], dtype)
    emb = {"word_embeddings.weight": np.asarray(
        params["embedding"]["word_embeddings"], dtype)}
    if cfg.use_position_embedding:
        emb["position_embeddings.weight"] = np.asarray(
            params["embedding"]["position_embeddings"], dtype)
    lm = {"embedding": emb, "transformer": enc}
    if not cfg.tie_embed_logits:
        lm["lm_head"] = _t(np.asarray(params["lm_head"], dtype))
    return lm


def save_megatron_checkpoint(load_dir: str, params, cfg: ModelConfig,
                             iteration="release",
                             args_extra: Optional[Mapping] = None) -> str:
    """Write a reference-readable release checkpoint (tp1/pp1):
    tracker + release/mp_rank_00/model_optim_rng.pt
    (ref: weights2megatron.py:214-224's output contract)."""
    from argparse import Namespace

    lm = params_to_megatron(params, cfg)
    args = {
        "num_layers": cfg.num_layers, "hidden_size": cfg.hidden_size,
        "ffn_hidden_size": cfg.ffn_hidden_size,
        "num_attention_heads": cfg.num_attention_heads,
        "num_attention_heads_kv": cfg.num_kv_heads,
        "padded_vocab_size": cfg.padded_vocab_size,
        "make_vocab_size_divisible_by": 1,
        "glu_activation": cfg.activation if cfg.is_glu else None,
        "use_rms_norm": cfg.norm_type == "rmsnorm",
        "use_bias": cfg.use_bias,
        "tie_embed_logits": cfg.tie_embed_logits,
        "parallel_attn": cfg.parallel_attn,
        "layernorm_epsilon": cfg.norm_epsilon,
        "seq_length": cfg.seq_length,
        "max_position_embeddings": cfg.max_position_embeddings,
        "position_embedding_type": "absolute"
        if cfg.use_position_embedding else "rotary",
        "tensor_model_parallel_size": 1,
        "pipeline_model_parallel_size": 1,
        "iteration": iteration,
    }
    if args_extra:
        args.update(args_extra)
    shard_dir = os.path.join(load_dir, iter_dirname(iteration), "mp_rank_00")
    os.makedirs(shard_dir, exist_ok=True)
    payload = {"iteration": iteration, "checkpoint_version": 3.0,
               "args": Namespace(**args),
               "model": {"language_model": {
                   k: ({kk: torch.from_numpy(np.ascontiguousarray(vv))
                        for kk, vv in v.items()}
                       if isinstance(v, dict)
                       else torch.from_numpy(np.ascontiguousarray(v)))
                   for k, v in lm.items()}}}
    path = os.path.join(shard_dir, PAYLOAD)
    torch.save(payload, path)
    with open(os.path.join(load_dir, TRACKER), "w") as f:
        f.write(str(iteration))
    return path
