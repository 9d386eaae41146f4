"""BERT and T5 pipelined over pp in the port against the JAX package's
pipelined steps on the 8-device virtual CPU mesh: BERT through
`make_train_step(cfg, mesh, loss_fn=..., pipelined_spec=bert_1f1b_fns)`,
T5 through its `t5_pipeline_loss_fn`, same numpy weights and batches, 2
SGD steps of 2 microbatches, fp32, 4 layers (T5: 4 + 4). The port's
stages are gloo processes (tests/mesh_pool.py). Each JAX step is compiled
once for the file, at pp 2; the port's pp 2 x vpp 2 and pp 2 x tp 2 (with
sequence parallelism) runs are held to the same run, since the layout
does not change the function. Then `pretrain_bert` and `pretrain_t5` run
2 iterations on 2 ranks at pp 2 under torchrun's environment and save
what the one-rank run of the same flags saves.

Limits (tests/test_torch_mesh_step.py's check_run, and the readings they
were set from on this CPU):
- parameters: each leaf within PARAM_REL = 1e-2 of its largest update
  over the run, or ZERO_GRAD_ATOL = 1e-9 where that is more (read: at
  most 2.4e-5 of the update);
- lm_loss, grad norm and params norm: METRIC_RTOL = 1e-5 relative (read:
  at most 1.6e-7);
- the entry points: each saved leaf within 1e-5 absolute of the one-rank
  run's, SGD at lr 0.1 (read: at most 7.5e-9).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from megatron_tpu import config as jc
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import t5 as jt5
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu.training.train_step import make_train_step as j_make_step
from megatron_tpu.training.train_step import state_from_params as j_state
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import t5 as tt5
from mesh_pool import RankPool
from test_torch_mesh_bert_t5 import batches, pretrain_bert_rank
from test_torch_mesh_step import check_run

torch.set_num_threads(2)
ZERO_GRAD_ATOL = 1e-9
LAYERS = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def configs(family: str, *, pp=2, vpp=1, tp=1, sp=False):
    kw = dict(num_layers=LAYERS, hidden_size=64, num_attention_heads=4,
              vocab_size=250, make_vocab_size_divisible_by=128,
              seq_length=16, max_position_embeddings=16,
              compute_dtype="float32", attention_impl="flash")
    mods = (jt5, tt5) if family == "t5" else (jbert, tbert)
    name = "t5_config" if family == "t5" else "bert_config"
    out = []
    for mod, fam in zip((jc, tc), mods):
        out.append(mod.MegatronConfig(
            model=getattr(fam, name)(**kw),
            parallel=mod.ParallelConfig(pipeline_parallel=pp,
                                        virtual_pipeline_chunks=vpp,
                                        tensor_parallel=tp,
                                        sequence_parallel=sp),
            optimizer=mod.OptimizerConfig(lr=0.1, optimizer="sgd",
                                          sgd_momentum=0.0,
                                          weight_decay=0.01, clip_grad=1.0),
            training=mod.TrainingConfig(micro_batch_size=2,
                                        global_batch_size=4,
                                        log_params_norm=True),
        ).validate(n_devices=pp * tp))
    return out


def jax_run(family: str, jcfg, batch_list):
    """The reference's pipelined step at pp 2."""
    par = jcfg.parallel
    mesh = j_build_mesh(par, devices=jax.devices()[:par.pipeline_parallel])
    m = jcfg.model
    key = jax.random.PRNGKey(0)
    if family == "bert":
        params = jbert.bert_init(key, m)
        extra = dict(loss_fn=lambda p, mb, r: jbert.bert_loss(p, mb, m),
                     axes_fn=jbert.bert_axes,
                     pipelined_spec=jbert.bert_1f1b_fns)
    else:
        params = jt5.t5_init(key, m)
        extra = dict(loss_fn=lambda p, mb, r: jt5.t5_loss(p, mb, m),
                     axes_fn=jt5.t5_axes,
                     pipelined_loss_fn=lambda p, b, r: jt5.t5_pipeline_loss_fn(
                         p, b, m, mesh))
    step = j_make_step(jcfg, mesh=mesh, donate=False,
                       init_params_fn=lambda: params, **extra)
    weights = {k.replace("/", "."): np.asarray(v)
               for k, v in _flatten(params).items()}
    state = j_state(params, jcfg)
    metrics = []
    for i, b in enumerate(batch_list):
        state, mt = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in mt.items()})
    return weights, {"metrics": metrics, "params": {
        k: np.asarray(v) for k, v in _flatten(state.params).items()}}


@pytest.fixture(scope="module")
def refs():
    out = {}
    for family in ("bert", "t5"):
        jcfg, _ = configs(family)
        batch_list = batches(family, 2)
        out[family] = (batch_list, *jax_run(family, jcfg, batch_list))
    return out


CASES = [(f, kw) for f in ("bert", "t5")
         for kw in (dict(), dict(vpp=2), dict(tp=2, sp=True))]


@pytest.mark.parametrize("family,kw", CASES, ids=[
    f"{f}-pp2" + "".join(f"-{k}{v}" for k, v in kw.items())
    for f, kw in CASES])
def test_pipelined_family_step_matches_jax(pool, refs, family, kw):
    batch_list, weights, want = refs[family]
    _, tcfg = configs(family, **kw)
    world = tcfg.parallel.pipeline_parallel * tcfg.parallel.tensor_parallel
    ranks = pool.run(world, mesh_ranks.train, tcfg, weights, batch_list,
                     None, True, family)
    check_run(ranks, want, weights, ZERO_GRAD_ATOL)


def test_pipelined_eval_losses(pool, refs):
    """The loop's eval step under pp runs BERT's spec and T5's pipelined
    loss forward: the first step's loss, before any update."""
    for family in ("bert", "t5"):
        batch_list, weights, want = refs[family]
        _, tcfg = configs(family, vpp=2)
        got = pool.run(2, mesh_ranks.family_eval, tcfg, weights,
                       batch_list[0], family)
        for g in got:
            np.testing.assert_allclose(g, want["metrics"][0]["lm_loss"],
                                       rtol=1e-5)


def pretrain_t5_rank(argv: list) -> int:
    """pretrain_t5.main on this rank of the pool's gloo group, under
    torchrun's environment (not a test)."""
    import torch.distributed as dist
    from megatron_tpu_torch import pretrain_t5
    env = dict(os.environ)
    os.environ.update(RANK=str(dist.get_rank()),
                      WORLD_SIZE=str(dist.get_world_size()))
    try:
        return pretrain_t5.main(argv, device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from megatron_tpu.data.indexed_dataset import IndexedDatasetBuilder
    tmp = tmp_path_factory.mktemp("pp_pretrain")
    vocab = tmp / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                 "[MASK]"] + [f"tok{i}" for i in range(59)])
                     + "\n")
    docs = str(tmp / "docs")
    rng = np.random.default_rng(0)
    b = IndexedDatasetBuilder(docs)
    for _ in range(8):
        b.add_item(rng.integers(5, 64, size=96).tolist())
        b.end_document()
    b.finalize()
    return {"vocab": str(vocab), "docs": docs, "tmp": tmp}


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_pretrain_entry_points_at_pp2(pool, corpus, family):
    from megatron_tpu_torch.training import checkpointing as ckpt
    runs = {}
    for world in (1, 2):
        save = str(corpus["tmp"] / f"{family}_{world}")
        argv = ["--data_path", corpus["docs"], "--vocab_file",
                corpus["vocab"], "--tokenizer_type", "BertWordPieceLowerCase",
                "--num_layers", "2", "--hidden_size", "64",
                "--num_attention_heads", "4", "--seq_length", "32",
                "--max_position_embeddings", "32", "--micro_batch_size", "2",
                "--global_batch_size", "4", "--train_iters", "2",
                "--optimizer", "sgd", "--lr", "0.1",
                "--attention_impl", "flash", "--distributed_backend", "gloo",
                "--save", save, "--save_interval", "2",
                "--pipeline_model_parallel_size", str(world)]
        if family == "t5":
            argv += ["--vocab_extra_ids", "8", "--decoder_seq_length", "16"]
        rank_fn = pretrain_bert_rank if family == "bert" else \
            pretrain_t5_rank
        assert pool.run(world, rank_fn, argv) == [0] * world
        assert ckpt.load_config_from_checkpoint(
            save).parallel.pipeline_parallel == world
        runs[world] = ckpt.read_params(ckpt.tracked_dir(save))
    assert sorted(runs[1]) == sorted(runs[2])
    for k, w in runs[1].items():
        np.testing.assert_allclose(runs[2][k], w, rtol=0, atol=1e-5,
                                   err_msg=k)
