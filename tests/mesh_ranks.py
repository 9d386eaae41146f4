"""What the ranks of the mesh tests run (not a test file; no JAX here, so
the spawned ranks stay light). Every function takes and returns numpy
arrays and plain values."""
from __future__ import annotations

import importlib

import numpy as np
import torch

from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.parallel import sharding as shd
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.training import checkpointing as ckpt

# the module (the package exports its train_step function under the name)
ts = importlib.import_module("megatron_tpu_torch.training.train_step")


def family_model(family: str, cfg, mesh=None, **options):
    """A trainable model of `family` ("lm", "bert", "t5", "biencoder") on
    the CPU, on `mesh` when given."""
    from megatron_tpu_torch.models import bert, biencoder, t5
    build = {"lm": lm.LanguageModel, "bert": bert.BertModel,
             "t5": t5.T5Model, "biencoder": biencoder.BiencoderModel}
    return build[family](cfg.model, device="cpu", trainable=True, mesh=mesh,
                         **options)


def family_loss(family: str, cfg):
    """make_train_step's `loss_fn` of a family (None for the LM)."""
    from megatron_tpu_torch.models import bert, biencoder, t5
    mcfg = cfg.model
    det = mcfg.hidden_dropout == 0.0
    if family == "bert":
        return lambda m, mb, g: bert.bert_loss(m, mb, mcfg, generator=g,
                                               deterministic=det)
    if family == "t5":
        return lambda m, mb, g: t5.t5_loss(m, mb, mcfg, generator=g,
                                           deterministic=det)
    if family == "biencoder":
        return lambda m, mb, g: biencoder.retrieval_loss(
            m, mb, mcfg, generator=g, deterministic=det)[0]
    return None


def family_pipelined(family: str, cfg) -> dict:
    """make_train_step's pipelined keyword of a family under pp > 1: BERT's
    spec, T5's pipelined loss (nothing for the LM or pp 1)."""
    from megatron_tpu_torch.models import bert, t5
    if cfg.parallel.pipeline_parallel == 1:
        return {}
    if family == "bert":
        return {"pipelined_spec": bert.bert_1f1b_fns}
    if family == "t5":
        mcfg = cfg.model

        def pipelined_loss_fn(model, batch, seeds, cotangent):
            return t5.t5_pipeline_loss_fn(
                model, batch, mcfg, vpp=cfg.parallel.virtual_pipeline_chunks,
                seeds=seeds, deterministic=mcfg.hidden_dropout == 0.0,
                cotangent=cotangent)
        return {"pipelined_loss_fn": pipelined_loss_fn}
    return {}


def model_on(cfg, weights: dict, mesh=None, family: str = "lm",
             **options):
    """A trainable model of `family` holding `weights` (the whole tree
    under the port's names); on a mesh, this rank's parts of them."""
    model = family_model(family, cfg, mesh, **options)
    axes = lm.flat_axes(model.param_axes())
    with torch.no_grad():
        for k, p in model.named_parameters():
            whole = torch.from_numpy(np.array(weights[k]))
            p.copy_(whole if mesh is None else shd.shard_leaf(
                whole, axes[k], mesh, cfg.model.num_kv_heads))
    return model


def whole_state(state) -> dict:
    """{"params" | "mu" | "nu": {jax name: numpy}} of a train state, the
    leaves gathered whole on a mesh (every rank calls it)."""
    placed = ckpt.sharded_leaves(state)
    out = {"params": ckpt._param_leaves(state), "mu": {}, "nu": {}}
    for k, t in ckpt._opt_leaves(state).items():
        group = k.split("/", 1)[0]
        if group in ("mu", "nu"):
            out[group][k.split("/", 1)[1]] = t
    for group in ("params", "mu", "nu"):
        out[group] = {k: (t if placed is None else placed.whole(
            k if group == "params" else f"{group}/{k}", t)).float().numpy()
                      for k, t in out[group].items()}
    return out


def train(cfg, weights: dict, batches: list, seeds=None, sharded=True,
          family: str = "lm", options=None, save_dir=None) -> dict:
    """`len(batches)` steps of make_train_step from `weights` (a sharded
    step on a mesh over the process group when `sharded`), each batch the
    global one ({name: numpy}), step i's generator seeded with seeds[i]
    (None: no generator); a `family` other than the LM trains with its
    loss_fn and model `options`, and `save_dir` saves the final state
    there. Returns {"metrics": [{name: float}], "params", "mu", "nu":
    whole leaves, "bytes": the transport's count}."""
    mesh = build_mesh(cfg.parallel) if sharded else None
    state = ts.state_from_params(
        model_on(cfg, weights, mesh, family, **(options or {})), cfg)
    step = ts.make_train_step(cfg, mesh=mesh, device="cpu",
                              loss_fn=family_loss(family, cfg),
                              **family_pipelined(family, cfg))
    metrics = []
    for i, batch in enumerate(batches):
        gen = (None if seeds is None
               else torch.Generator().manual_seed(int(seeds[i])))
        state, m = step(state, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()}, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    if save_dir is not None:
        ckpt.save_checkpoint(save_dir, state, cfg, len(batches))
    out = whole_state(state)
    out["metrics"] = metrics
    out["bytes"] = 0 if mesh is None or mesh.transport is None \
        else mesh.transport.bytes
    return out


def mesh_view(parallel) -> dict:
    """This rank's coordinates, and for each axis the sum of the ranks of
    its group (an all-reduce of the rank ids over that axis)."""
    from megatron_tpu_torch.parallel import collectives
    from megatron_tpu_torch.parallel.mesh import axis_size, mesh_info
    mesh = build_mesh(parallel)
    sums = {a: int(collectives.all_reduce(
        torch.tensor([mesh.rank]), mesh, a)[0]) for a in ("dp", "tp")}
    return {"coords": mesh.coords, "sums": sums, "info": mesh_info(mesh),
            "tp": axis_size(mesh, "tp")}


def shard_roundtrip(cfg, weights: dict) -> dict:
    """This rank's parts of every leaf, and the leaves gathered back."""
    mesh = build_mesh(cfg.parallel)
    axes = lm.flat_axes(lm.model_axes(cfg.model))
    nkv = cfg.model.num_kv_heads
    parts = {k: shd.shard_leaf(torch.from_numpy(np.array(v)), axes[k], mesh,
                               nkv) for k, v in weights.items()}
    back = {k: shd.gather_leaf(v, axes[k], mesh, nkv)
            for k, v in parts.items()}
    return {"parts": {k: v.numpy() for k, v in parts.items()},
            "back": {k: v.numpy() for k, v in back.items()}}


def vocab_parallel_ce(logits, labels, vocab_size: int, smoothing: float,
                      tp: int) -> dict:
    """The vocab-parallel cross-entropy of this rank's logits columns:
    the per-token loss and the grad of its sum."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.ops.cross_entropy import \
        vocab_parallel_cross_entropy
    mesh = build_mesh(ParallelConfig(tensor_parallel=tp))
    width = logits.shape[-1] // tp
    t = mesh.coords["tp"]
    x = torch.tensor(logits[..., t * width:(t + 1) * width],
                     requires_grad=True)
    loss = vocab_parallel_cross_entropy(x, torch.from_numpy(labels), mesh,
                                        vocab_size=vocab_size,
                                        label_smoothing=smoothing)
    loss.sum().backward()
    return {"loss": loss.detach().numpy(), "grad": x.grad.numpy()}


def finetune_run(argv: list) -> dict:
    """finetune.main(argv) on the CPU on this rank: its return code, each
    step's (iteration, lm_loss, grad_norm) and the final state's whole
    leaves."""
    from megatron_tpu_torch import finetune
    from megatron_tpu_torch.training import loop
    steps, states = [], []
    make, train_fn = loop.make_train_step, loop.train

    def recording_make(*a, **k):
        step = make(*a, **k)

        def run(state, batch, gen):
            it = state.iteration
            state, m = step(state, batch, gen)
            steps.append((it, float(m["lm_loss"]), float(m["grad_norm"])))
            return state, m
        return run

    def recording_train(*a, **k):
        out = train_fn(*a, **k)
        states.append(out[0])
        return out

    loop.make_train_step, loop.train = recording_make, recording_train
    try:
        rc = finetune.main(argv, device="cpu")
    finally:
        loop.make_train_step, loop.train = make, train_fn
    out = whole_state(states[-1])
    out.update(rc=rc, steps=steps, iteration=states[-1].iteration)
    return out


def grad_stats(parallel) -> dict:
    """optimizer.sharded_grad_norm and count_zeros over a mesh, on grads
    made from the rank's coordinates: "cut" (a tp part, counted on every
    rank) holds the rank's number in zeros, "whole" (replicated, counted
    on rank 0 alone) 5 zeros; with `poison`, rank 3 puts an inf in its
    copy of "whole", which it does not count."""
    from megatron_tpu_torch.training import optimizer as opt
    from megatron_tpu_torch.parallel import collectives
    mesh = build_mesh(parallel)
    r = mesh.rank
    cut = torch.full((8,), float(r + 1))
    cut[:r] = 0.0
    whole = torch.full((6,), 2.0)
    whole[:5] = 0.0
    out = {}
    for poison in (False, True):
        grads = {"cut": cut.clone(), "whole": whole.clone()}
        if poison and r == 3:
            grads["whole"][5] = float("inf")
        shards = opt.GradShards(
            owned={"cut": True, "whole": r == 0},
            sum_world=lambda t: collectives.sum_world(t, mesh))
        norm, found_inf = opt.sharded_grad_norm(grads, shards)
        out[poison] = dict(norm=float(norm), found_inf=bool(found_inf),
                           zeros=int(opt.count_zeros(grads, shards)))
    return out


def any_rank_flags(parallel) -> list:
    """collectives.any_rank of no rank's flag, then of rank 1's alone."""
    from megatron_tpu_torch.parallel import collectives
    mesh = build_mesh(parallel)
    return [collectives.any_rank(False, mesh),
            collectives.any_rank(mesh.rank == 1, mesh)]


def cp_attention(algo: str, q, k, v, cp: int, causal: bool,
                 layout: str = "auto", impl: str = "flash") -> dict:
    """Ring ("ring") or Ulysses attention of this cp rank's contiguous
    chunk of q, k, v ([b, S, n, d] numpy, whole): its rows of the output,
    and the grads of sum(tanh(out)) summed over the ranks, for its chunk
    of q, k and v. A ValueError comes back as its message."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.parallel.ring_attention import ring_attention
    from megatron_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = build_mesh(ParallelConfig(context_parallel=cp))
    c, per = mesh.coords["cp"], q.shape[1] // cp
    ts = [torch.tensor(x[:, c * per:(c + 1) * per], requires_grad=True)
          for x in (q, k, v)]
    try:
        if algo == "ring":
            out = ring_attention(*ts, mesh, causal=causal, layout=layout,
                                 impl=impl)
        else:
            out = ulysses_attention(*ts, mesh, causal=causal)
    except ValueError as e:
        return {"error": str(e)}
    torch.tanh(out).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": [t.grad.numpy() for t in ts]}


def cp_attention_layer(cfg, params: dict, x, segment_ids, cp: int,
                       seed) -> dict:
    """models/attention.py's attention_apply on this cp rank's chunk of x
    ([b, S, h] numpy) with segment ids and, with a `seed`, attention
    dropout from a generator seeded so (cp=1: the unsharded call on the
    whole x): the output rows and the grads of sum(tanh(out)) for x and
    every weight (this rank's part of the sums over the rows)."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models.attention import attention_apply
    mesh = (build_mesh(ParallelConfig(context_parallel=cp)) if cp > 1
            else None)
    c = 0 if mesh is None else mesh.coords["cp"]
    per = x.shape[1] // cp
    xt = torch.tensor(x[:, c * per:(c + 1) * per], requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    seg = None if segment_ids is None else torch.from_numpy(
        segment_ids[:, c * per:(c + 1) * per])
    out, _ = attention_apply(pt, xt, cfg.model, segment_ids=seg,
                             deterministic=seed is None, generator=gen,
                             mesh=mesh)
    torch.tanh(out).sum().backward()
    return {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "dw": {k: v.grad.numpy() for k, v in pt.items()}}


def train_without_data_zigzag(cfg, weights: dict, batches: list) -> dict:
    """`train` with the LM loss's zigzag pre-permutation turned off: the
    ring then takes the contiguous split of the sequence. "zigzag" holds
    what the loss was told."""
    told = []
    real = lm.data_zigzag_cp

    def off(*args, **kwargs):
        told.append(real(*args, **kwargs))
        return 0
    lm.data_zigzag_cp = off
    try:
        out = train(cfg, weights, batches)
    finally:
        lm.data_zigzag_cp = real
    out["zigzag"] = told
    return out


def load_whole(cfg, save_dir: str, sharded: bool = True) -> dict:
    """A fresh state of cfg's model (on a mesh over the process group when
    `sharded`) loaded from the checkpoint under `save_dir`: its whole
    leaves (`whole_state`) and the iteration."""
    mesh = build_mesh(cfg.parallel) if sharded else None
    state = ts.state_from_params(
        lm.LanguageModel(cfg.model, device="cpu", trainable=True, mesh=mesh),
        cfg)
    loaded = ckpt.load_checkpoint(save_dir, state)
    out = whole_state(state)
    out["iteration"] = loaded.iteration
    return out


def pipeline_grads(cfg, weights: dict, batch: dict, seed=None,
                   schedule=None, store=None, cotangent=1.0) -> dict:
    """The pipelined LM step's forward and backward on this rank's mesh
    (train_step.pipelined_lm_grads) from `weights`: the global loss, every
    grad reduced over the mesh and gathered whole, the transport's bytes
    and the deepest stash a chunk held."""
    import dataclasses
    from megatron_tpu_torch.parallel import pipeline as pl
    mesh = build_mesh(cfg.parallel)
    model = model_on(cfg, weights, mesh)
    gen = None if seed is None else torch.Generator().manual_seed(int(seed))
    peaks = []
    run_pipeline = pl.run_pipeline

    def recording(*a, **k):
        out = run_pipeline(*a, **k)
        peaks.append(out[2].peak_stash)
        return out
    pl.run_pipeline = recording
    try:
        loss, grads = ts.pipelined_lm_grads(
            model, {k: torch.from_numpy(np.array(v)) for k, v in
                    batch.items()}, gen, cfg, schedule=schedule,
            store=store, cotangent=cotangent)
    finally:
        pl.run_pipeline = run_pipeline
    layout = {k: dataclasses.replace(v, zero_dim=None)
              for k, v in ts.state_layout(model).items()}
    grads = ts._reduce_grads(grads, layout, mesh)
    axes = lm.flat_axes(model.param_axes())
    nkv = cfg.model.num_kv_heads
    return {"loss": float(ts.sum_loss(loss, mesh)),
            "grads": {k: shd.gather_leaf(g, axes[k], mesh, nkv).numpy()
                      for k, g in grads.items()},
            "bytes": 0 if mesh.transport is None else mesh.transport.bytes,
            "peak": peaks[0]}


def pipeline_eval(cfg, weights: dict, batch: dict) -> float:
    """The LM evaluation loss of the training loop's eval step on this
    rank's mesh (the pipelined forward under pp)."""
    from megatron_tpu_torch.training import loop
    mesh = build_mesh(cfg.parallel)
    model = model_on(cfg, weights, mesh)
    step = loop._make_eval_step(cfg, "cpu", mesh=mesh)
    return float(step(model, {k: torch.from_numpy(np.array(v))
                              for k, v in batch.items()}))


def family_eval(cfg, weights: dict, batch: dict, family: str) -> float:
    """A family's evaluation loss through the training loop's eval step on
    this rank's mesh (its pipelined keyword under pp)."""
    from megatron_tpu_torch.training import loop
    mesh = build_mesh(cfg.parallel)
    model = model_on(cfg, weights, mesh, family)
    step = loop._make_eval_step(cfg, "cpu", loss_fn=family_loss(family, cfg),
                                mesh=mesh, **family_pipelined(family, cfg))
    return float(step(model, {k: torch.from_numpy(np.array(v))
                              for k, v in batch.items()}))


def load_state(cfg, root: str, family: str = "lm") -> dict:
    """A fresh state of `family` built on this rank's mesh, loaded from the
    checkpoint under `root`: its whole leaves (`whole_state`) and the
    iteration."""
    mesh = build_mesh(cfg.parallel)
    state = ts.state_from_params(family_model(family, cfg, mesh), cfg)
    loaded = ckpt.load_checkpoint(root, state)
    out = whole_state(state)
    out["iteration"] = loaded.iteration
    return out


def bubble_record(argv: list) -> dict:
    """tools/bench_bubble's measurement on this rank (the pool's gloo
    group is the pipeline's), on the CPU."""
    from megatron_tpu_torch.tools import bench_bubble
    return bench_bubble.measure(bench_bubble.parse(argv),
                                torch.device("cpu"))
