"""The BERT, T5 and ICT steps of the port sharded over a (dp, tp) mesh,
against the JAX package's sharded steps (`make_train_step(cfg, mesh,
loss_fn=..., axes_fn=...)`) on the 8-device virtual CPU mesh: same numpy
weights and batches, 2 steps of 2 microbatches, fp32. The port's ranks are
gloo processes (tests/mesh_pool.py). Also: the axes trees against JAX's,
and `pretrain_bert` on 2 ranks (tp 2) saving a checkpoint that the
unsharded port reloads.

Limits (tests/test_torch_mesh_step.py's, and the readings they were set
from on this CPU, all cases below):
- parameters: SGD without momentum, each leaf within PARAM_REL = 1e-2 of
  its largest update over the run, or within ZERO_GRAD_ATOL = 1e-9 where
  that is more (read: at most 2.8e-2 of that limit): a leaf whose grad is
  zero in exact arithmetic moves by rounding alone (the context tower's
  ict_head bias: adding one vector to every context shifts each query's
  scores by a constant, which the softmax ignores; read: updates of
  1.2e-11 in JAX, 2.3e-11 apart);
- lm_loss, grad norm and params norm: METRIC_RTOL = 1e-5 relative (read:
  at most 2.6e-7); found_inf exact;
- the reloaded checkpoint: bit for bit (the save gathers the parts, and
  the load copies them).
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
from megatron_tpu.models import biencoder as jbi
from megatron_tpu.models import t5 as jt5
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu.training.train_step import make_train_step as j_make_step
from megatron_tpu.training.train_step import state_from_params as j_state
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import biencoder as tbi
from megatron_tpu_torch.models import t5 as tt5
from mesh_pool import RankPool
from test_torch_mesh_step import check_run

torch.set_num_threads(2)
ZERO_GRAD_ATOL = 1e-9
SEQ, SEQ_DEC, VOCAB = 16, 8, 250
STEPS, N_MICRO = 2, 2
HEAD = 16  # the ICT head's width


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def configs(family: str, *, tp=1, dp=1, sp=False, zero=False, micro=2):
    """(JAX config, port config) of a tiny BERT-shaped model (T5's
    widths are BERT's here) on a (dp, tp) mesh."""
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=VOCAB, make_vocab_size_divisible_by=128,
              seq_length=SEQ, max_position_embeddings=SEQ,
              compute_dtype="float32", attention_impl="flash")
    mods = (jt5, tt5) if family == "t5" else (jbert, tbert)
    name = "t5_config" if family == "t5" else "bert_config"
    out = []
    for mod, cfg_mod in zip((jc, tc), mods):
        out.append(mod.MegatronConfig(
            model=getattr(cfg_mod, name)(**kw),
            parallel=mod.ParallelConfig(tensor_parallel=tp,
                                        sequence_parallel=sp,
                                        use_distributed_optimizer=zero),
            optimizer=mod.OptimizerConfig(lr=0.1, optimizer="sgd",
                                          sgd_momentum=0.0,
                                          weight_decay=0.01, clip_grad=1.0),
            training=mod.TrainingConfig(
                micro_batch_size=micro,
                global_batch_size=micro * dp * N_MICRO,
                log_params_norm=True)).validate(n_devices=tp * dp))
    return out


def _pads(rs, rows, s, lo):
    return (np.arange(s)[None] < rs.randint(lo, s + 1, (rows, 1))).astype(
        np.int64)


def batches(family: str, rows: int, seed=1) -> list:
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        micro = []
        for _ in range(N_MICRO):
            if family == "bert":
                mb = {"tokens": rs.randint(0, VOCAB, (rows, SEQ)),
                      "tokentype_ids": (np.arange(SEQ)[None] >= SEQ // 2
                                        ).repeat(rows, 0).astype(np.int64),
                      "labels": rs.randint(0, VOCAB, (rows, SEQ)),
                      "loss_mask": (rs.rand(rows, SEQ) < 0.3).astype(
                          np.float32),
                      "is_random": rs.randint(0, 2, (rows,)),
                      "padding_mask": _pads(rs, rows, SEQ, 10)}
            elif family == "t5":
                mb = {"text_enc": rs.randint(0, VOCAB, (rows, SEQ)),
                      "text_dec": rs.randint(0, VOCAB, (rows, SEQ_DEC)),
                      "labels": rs.randint(0, VOCAB, (rows, SEQ_DEC)),
                      "loss_mask": (rs.rand(rows, SEQ_DEC) < 0.8).astype(
                          np.float32),
                      "enc_mask": _pads(rs, rows, SEQ, 10)}
            else:
                mb = {"query_tokens": rs.randint(0, VOCAB, (rows, SEQ)),
                      "context_tokens": rs.randint(0, VOCAB, (rows, SEQ)),
                      "query_pad_mask": _pads(rs, rows, SEQ, 6),
                      "context_pad_mask": _pads(rs, rows, SEQ, 12)}
            micro.append(mb)
        out.append({k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return out


def jax_family(family: str, jcfg):
    """(params, loss_fn, axes_fn) of the JAX family."""
    m = jcfg.model
    key = jax.random.PRNGKey(0)
    if family == "bert":
        return (jbert.bert_init(key, m),
                lambda p, mb, r: jbert.bert_loss(p, mb, m), jbert.bert_axes)
    if family == "t5":
        return (jt5.t5_init(key, m, decoder_layers=1),
                lambda p, mb, r: jt5.t5_loss(p, mb, m), jt5.t5_axes)
    return (jbi.biencoder_init(key, m, ict_head_size=HEAD),
            lambda p, mb, r: jbi.retrieval_loss(p, mb, m)[0],
            lambda mc: jbi.biencoder_axes(mc, ict_head_size=HEAD))


def jax_run(family: str, jcfg, batch_list):
    par = jcfg.parallel
    n = par.tensor_parallel * par.data_parallel
    mesh = j_build_mesh(par, devices=jax.devices()[:n])
    params, loss_fn, axes_fn = jax_family(family, jcfg)
    weights = {k.replace("/", "."): np.asarray(v)
               for k, v in _flatten(params).items()}
    step = j_make_step(jcfg, mesh=mesh, donate=False, loss_fn=loss_fn,
                       init_params_fn=lambda: params, axes_fn=axes_fn)
    state = j_state(params, jcfg)
    metrics = []
    for i, b in enumerate(batch_list):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return weights, {"metrics": metrics, "params": {
        k: np.asarray(v) for k, v in _flatten(state.params).items()}}


OPTIONS = {"bert": {}, "t5": {"decoder_layers": 1},
           "biencoder": {"ict_head_size": HEAD}}


def check_family(pool, family, jcfg, tcfg):
    rows = tcfg.training.micro_batch_size * tcfg.parallel.data_parallel
    batch_list = batches(family, rows)
    weights, want = jax_run(family, jcfg, batch_list)
    world = tcfg.parallel.tensor_parallel * tcfg.parallel.data_parallel
    check_run(pool.run(world, mesh_ranks.train, tcfg, weights, batch_list,
                       None, True, family, OPTIONS[family]),
              want, weights, ZERO_GRAD_ATOL)


def test_axes_trees_match_jax():
    jcfg, tcfg = configs("bert")
    m_j, m_t = jcfg.model, tcfg.model
    assert tbert.bert_axes(m_t) == jbert.bert_axes(m_j)
    assert tt5.t5_axes(m_t) == jt5.t5_axes(m_j)
    for shared in (False, True):
        for head in (None, HEAD):
            assert tbi.biencoder_axes(
                m_t, ict_head_size=head, shared=shared) == \
                jbi.biencoder_axes(m_j, ict_head_size=head, shared=shared)


# (family, mesh of configs())
CASES = [
    ("bert", dict(tp=2, sp=True)),
    ("bert", dict(dp=2, zero=True, micro=1)),
    ("t5", dict(tp=2)),
    ("t5", dict(tp=2, sp=True)),
    ("biencoder", dict(dp=2, micro=1)),
    ("biencoder", dict(dp=2, tp=2, sp=True, micro=1)),
]


@pytest.mark.parametrize("family,kw", CASES,
                         ids=[f"{f}-" + "-".join(f"{k}{v}" for k, v in
                                                 kw.items())
                              for f, kw in CASES])
def test_family_step_matches_jax(pool, family, kw):
    jcfg, tcfg = configs(family, **kw)
    check_family(pool, family, jcfg, tcfg)


def pretrain_bert_rank(argv: list) -> int:
    """pretrain_bert.main on this rank of the pool's gloo group, under
    torchrun's environment (not a test)."""
    import torch.distributed as dist
    from megatron_tpu_torch import pretrain_bert
    env = dict(os.environ)
    os.environ.update(RANK=str(dist.get_rank()),
                      WORLD_SIZE=str(dist.get_world_size()))
    try:
        return pretrain_bert.main(argv, device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.mark.parametrize("flags", [
    ("--tensor_model_parallel_size", "2", "--sequence_parallel"),
    ("--micro_batch_size", "1", "--use_distributed_optimizer")],
    ids=["tp2_sp", "dp2_zero1"])
def test_pretrain_bert_on_two_ranks_saves_what_the_unsharded_port_reloads(
        pool, tmp_path, flags):
    """pretrain_bert under torchrun's environment on 2 ranks, at tp 2 with
    sequence parallelism and at dp 2 with ZeRO-1 (each rank its share of
    the batch iterator's global batches): the save reloads unsharded."""
    from megatron_tpu.data.indexed_dataset import IndexedDatasetBuilder
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.train_step import TrainState
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                 "[MASK]"] + [f"tok{i}" for i in range(59)])
                     + "\n")
    docs = str(tmp_path / "docs")
    rng = np.random.default_rng(0)
    b = IndexedDatasetBuilder(docs)
    for _ in range(8):
        b.add_item(rng.integers(5, 64, size=96).tolist())
        b.end_document()
    b.finalize()
    save = str(tmp_path / "ckpt")
    argv = ["--data_path", docs, "--vocab_file", str(vocab),
            "--tokenizer_type", "BertWordPieceLowerCase",
            "--num_layers", "2", "--hidden_size", "64",
            "--num_attention_heads", "4", "--seq_length", "32",
            "--max_position_embeddings", "32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", "2", "--lr", "1e-4",
            "--attention_impl", "flash", "--distributed_backend", "gloo",
            "--save", save, "--save_interval", "2", *flags]
    assert pool.run(2, pretrain_bert_rank, argv) == [0, 0]
    cfg = ckpt.load_config_from_checkpoint(save)
    assert cfg.parallel.data_parallel == (2 if "--use_distributed_optimizer"
                                          in flags else 1)
    model = tbert.BertModel(cfg.model.derived(), device="cpu")
    loaded = ckpt.load_checkpoint(save, TrainState(model, None, 0),
                                  no_load_optim=True)
    assert loaded.iteration == 2
    saved = ckpt.read_params(ckpt.tracked_dir(save))
    assert sorted(saved) == sorted(k.replace(".", "/")
                                   for k, _ in model.named_parameters())
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved[k.replace(".", "/")])
