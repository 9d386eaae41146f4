"""The port's mesh, sharding rules, leaf layout, vocab-parallel
cross-entropy and the flash kernels' dropout index, against the JAX
package on the CPU. Collectives run on gloo ranks (tests/mesh_pool.py),
spawned once for the file.

Limits: the rank grid, the rules, the axes, the shard/gather round trip
and the dropout bits are exact; the vocab-parallel cross-entropy is held
at 1e-5 of the largest value, as the unsharded one in
test_torch_training.py (the same fp32 formulas summed across shards in
another order; read: at most 5.1e-8 on the loss, 2.7e-7 on the grads); the flash rank slices equal the
unsharded plain call bit for bit, and the unsharded plain call equals the
Pallas kernel in interpret mode at test_torch_flash_backward.py's 1e-5.
"""
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from megatron_tpu import config as jc
from megatron_tpu.models import language_model as jlm
from megatron_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from megatron_tpu.ops.flash_attention_pallas import (STAT_LANES,
                                                    _dropout_keep,
                                                    pallas_flash_attention)
from megatron_tpu.parallel import sharding as jshd
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.ops import flash_attention as fa
from megatron_tpu_torch.parallel import sharding as tshd
from megatron_tpu_torch.parallel.mesh import rank_grid
from mesh_pool import RankPool

torch.set_num_threads(2)
SMALL = dict(num_layers=2, hidden_size=64, vocab_size=250,
             make_vocab_size_divisible_by=128, seq_length=16)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _model_cfgs(tree: str):
    if tree == "gpt":
        kw = dict(SMALL, num_attention_heads=4, max_position_embeddings=16)
        return jc.gpt_config(**kw), tc.gpt_config(**kw)
    nkv = {"llama": 2, "mqa": 1}[tree]
    kw = dict(SMALL, num_attention_heads=8, num_kv_heads=nkv)
    return jc.llama2_config("tiny", **kw), tc.llama2_config("tiny", **kw)


def _flat_axes(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


# --- the mesh and the rules ----------------------------------------------------

@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2), (2, 4), (1, 8)])
def test_rank_grid_matches_jax_mesh(dp, tp):
    """Rank r sits where device r sits in the reference's mesh: tp
    fastest, then cp, pp and dp."""
    n = dp * tp
    jmesh = j_build_mesh(jc.ParallelConfig(tensor_parallel=tp,
                                           data_parallel=dp),
                         devices=jax.devices()[:n])
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    got = rank_grid(tc.ParallelConfig(tensor_parallel=tp, data_parallel=dp),
                    n)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_build_mesh_groups_follow_the_grid(pool):
    """On 4 gloo ranks at (dp 2, tp 2): each rank's coordinates are its
    place in the grid, and its dp and tp groups hold the ranks that differ
    from it only along that axis."""
    parallel = tc.ParallelConfig(tensor_parallel=2)
    grid = rank_grid(parallel, 4).reshape(2, 2)
    for rank, view in enumerate(pool.run(4, mesh_ranks.mesh_view, parallel)):
        d, t = (int(i) for i in np.argwhere(grid == rank)[0])
        assert (view["coords"]["dp"], view["coords"]["tp"]) == (d, t)
        assert view["sums"] == {"dp": int(grid[:, t].sum()),
                                "tp": int(grid[d].sum())}
        assert view["info"] == {"dp": 2, "pp": 1, "cp": 1, "tp": 2}
        assert view["tp"] == 2


def test_any_rank_agrees_on_the_host(pool):
    """The loop's exit agreement: a flag raised on one rank holds on all."""
    ranks = pool.run(4, mesh_ranks.any_rank_flags,
                     tc.ParallelConfig(tensor_parallel=2))
    assert ranks == [[False, True]] * 4


@pytest.mark.parametrize("sp", [False, True])
def test_rules_and_specs_match_jax(sp):
    rules = tshd.make_logical_rules(sp)
    assert rules == jshd.make_logical_rules(sp)
    for tree in ("llama", "mqa", "gpt"):
        jcfg, tcfg = _model_cfgs(tree)
        for name, axes in _flat_axes(jlm.model_axes(jcfg)).items():
            assert tshd.logical_to_spec(axes, rules) == tuple(
                jshd.logical_to_spec(axes, rules)), name


@pytest.mark.parametrize("tree", ["llama", "mqa", "gpt"])
def test_model_axes_match_jax(tree):
    jcfg, tcfg = _model_cfgs(tree)
    got = tlm.flat_axes(tlm.model_axes(tcfg))
    assert got == _flat_axes(jlm.model_axes(jcfg))
    meta = tlm.LanguageModel(tcfg, device="meta").state_dict()
    assert sorted(got) == sorted(meta)


# --- leaves --------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", ["llama", "mqa", "gpt"])
def test_shard_then_gather_is_byte_exact(pool, tree, tp):
    """Every leaf of tiny Llama (8/2 heads), MQA (8/1) and GPT trees; rank
    0's wkv holds k and v of its own kv heads (all of them, replicated,
    when tp exceeds the kv heads)."""
    jcfg, tcfg = _model_cfgs(tree)
    weights = {k.replace("/", "."): np.asarray(v) for k, v in _flatten(
        jlm.model_init(jax.random.PRNGKey(0), jcfg)).items()}
    cfg = tc.MegatronConfig(model=tcfg, parallel=tc.ParallelConfig(
        tensor_parallel=tp)).validate(n_devices=tp)
    ranks = pool.run(tp, mesh_ranks.shard_roundtrip, cfg, weights)
    for r in ranks:
        for k, w in weights.items():
            assert r["back"][k].dtype == w.dtype
            assert r["back"][k].tobytes() == w.tobytes(), k
    hd, nkv = tcfg.kv_channels, tcfg.num_kv_heads
    wkv = weights["transformer.attention.wkv"]
    L, h = wkv.shape[:2]
    per = nkv // tp if nkv % tp == 0 else nkv
    want = wkv.reshape(L, h, 2, nkv, hd)[:, :, :, :per].reshape(L, h, -1)
    assert np.array_equal(ranks[0]["parts"]["transformer.attention.wkv"],
                          want)
    # wq and the MLP are cut on heads and ffn columns
    wq = weights["transformer.attention.wq"]
    assert np.array_equal(ranks[-1]["parts"]["transformer.attention.wq"],
                          wq[..., (tp - 1) * wq.shape[-1] // tp:])


def test_grad_norm_and_zeros_count_each_part_once(pool):
    """At (dp 2, tp 2): the norm sums the owned leaves' squares over the
    world, the zero count likewise, and an inf in a copy no rank counts
    still sets found_inf on every rank."""
    ranks = pool.run(4, mesh_ranks.grad_stats,
                     tc.ParallelConfig(tensor_parallel=2))
    squares = sum((8 - r) * (r + 1) ** 2 for r in range(4)) + 2.0 ** 2
    for rank in ranks:
        assert rank[False] == dict(norm=pytest.approx(squares ** 0.5),
                                   found_inf=False, zeros=0 + 1 + 2 + 3 + 5)
        assert rank[True]["found_inf"]


# --- vocab-parallel cross-entropy ---------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_cross_entropy_matches_jax(pool, tp, smoothing):
    """Padded vocab (250 real ids of 256): the per-token loss and the
    logits grads of its sum, each rank's columns concatenated."""
    rs = np.random.RandomState(0)
    logits = (rs.standard_normal((3, 7, 256)) * 4).astype(np.float32)
    labels = rs.randint(0, 250, (3, 7))
    want, want_g = jax.value_and_grad(
        lambda x: j_ce(x, jnp.asarray(labels), 250, smoothing).sum())(
        jnp.asarray(logits))
    want_tok = np.asarray(j_ce(jnp.asarray(logits), jnp.asarray(labels), 250,
                               smoothing))
    ranks = pool.run(tp, mesh_ranks.vocab_parallel_ce, logits, labels, 250,
                     smoothing, tp)
    grad = np.concatenate([r["grad"] for r in ranks], axis=-1)
    for r in ranks:
        err = np.abs(r["loss"] - want_tok).max() / np.abs(want_tok).max()
        assert err < 1e-5
    assert abs(ranks[0]["loss"].sum() - float(want)) < 1e-5 * abs(float(want))
    err = np.abs(grad - np.asarray(want_g)).max() / np.abs(want_g).max()
    assert err < 1e-5


# --- the flash kernels' dropout index ------------------------------------------

B, S, D, NQ, NKV = 2, 128, 64, 4, 2
SEED, RATE = 4321, 0.1


def _flash_inputs():
    rs = np.random.RandomState(3)
    return tuple(rs.standard_normal(shape).astype(np.float32) for shape in (
        (B, S, NQ, D), (B, S, NKV, D), (B, S, NKV, D), (B, S, NQ, D)))


def _plain(q, k, v, do, **index):
    """Plain forward and backward with dropout: (out, lse, dq, dk, dv)."""
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(
        tq, tk, tv, causal=True, dropout_rate=RATE, dropout_seed=SEED,
        **index)
    out.backward(torch.from_numpy(do))
    return [t.detach().numpy() for t in (out, lse, tq.grad, tk.grad,
                                         tv.grad)]


def test_flash_rank_slices_equal_the_unsharded_call():
    """Heads split over tp 2 (head offsets 0 and 2 of 4) and rows over dp 2
    (batch offsets 0 and 1): the rank slices' outputs and grads,
    concatenated, equal the unsharded plain call bit for bit, which equals
    the Pallas kernel in interpret mode at the global rows. The plain calls
    run on one thread: with two, the CPU's matrix products split their
    sums by the load they find, and 2 of 25 runs beside a busy host
    differed in the last bits."""
    q, k, v, do = _flash_inputs()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _flash_slices_equal_whole(q, k, v, do)
    finally:
        torch.set_num_threads(threads)
    seed = jnp.full((1, STAT_LANES), float(SEED))
    fn = lambda q_, k_, v_: pallas_flash_attention(  # noqa: E731
        q_, k_, v_, True, None, S, S, True, None, None, None, RATE, seed)
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    whole = _plain(q, k, v, do)
    for got, w in zip([whole[0], *whole[2:]],
                      [want, *vjp(jnp.asarray(do))]):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-5)


def _flash_slices_equal_whole(q, k, v, do):
    whole = _plain(q, k, v, do)
    hq, hk = NQ // 2, NKV // 2
    tp_parts = [_plain(q[:, :, t * hq:(t + 1) * hq],
                       k[:, :, t * hk:(t + 1) * hk],
                       v[:, :, t * hk:(t + 1) * hk],
                       do[:, :, t * hq:(t + 1) * hq],
                       head_offset=t * hq, total_heads=NQ)
                for t in range(2)]
    dp_parts = [_plain(q[d:d + 1], k[d:d + 1], v[d:d + 1], do[d:d + 1],
                       batch_offset=d) for d in range(2)]
    # out, lse, dq, dk, dv: their head dims
    for i, dim in enumerate((2, 1, 2, 2, 2)):
        assert np.array_equal(np.concatenate(
            [p[i] for p in tp_parts], axis=dim), whole[i]), i
        assert np.array_equal(np.concatenate(
            [p[i] for p in dp_parts], axis=0), whole[i]), i


def test_dropout_rows_at_offsets_are_the_global_rows_bits():
    """A rank's keep bits (batch offset 1 of 2 rows, head offset 2 of 4
    heads) are the JAX kernel's at the global bh = (1 + b) * 4 + 2 + h."""
    rows = fa._dropout_rows(1, S, 1, 2, SEED, "cpu", batch_offset=1,
                            head_offset=2, total_heads=NQ)
    got = fa._dropout_keep_from_row(rows, torch.arange(S), RATE).numpy()
    for h in range(2):
        want = np.asarray(_dropout_keep(
            jnp.int32(SEED), jnp.int32(1 * NQ + 2 + h), jnp.int32(0),
            jnp.int32(0), S, S, RATE))
        assert np.array_equal(got[0, :, 0, h], want)


def test_flash_dropout_index_is_checked():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="dropout index"):
        fa.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1,
                           head_offset=1, total_heads=2)


# --- the config and what still raises ------------------------------------------

def test_validate_checks_the_mesh_against_the_model():
    def cfg(model_kw=None, **par):
        kw = dict(SMALL, num_attention_heads=8, num_kv_heads=2)
        kw.update(model_kw or {})
        return tc.MegatronConfig(model=tc.llama2_config("tiny", **kw),
                                 parallel=tc.ParallelConfig(**par))
    ok = cfg(tensor_parallel=4, sequence_parallel=True).validate(n_devices=8)
    assert ok.parallel.data_parallel == 2
    assert ok.training.global_batch_size == 2 and ok.num_microbatches == 1
    for bad, n, what in (
            (cfg(tensor_parallel=16), 16, "attention heads"),
            (cfg(dict(hidden_size=96, num_attention_heads=12,
                      num_kv_heads=4, ffn_hidden_size=192),
                 tensor_parallel=6), 6, "kv heads"),
            (cfg(dict(ffn_hidden_size=100), tensor_parallel=8), 8, "ffn"),
            (cfg(dict(seq_length=18), tensor_parallel=4,
                 sequence_parallel=True), 4, "seq_length"),
            (cfg(dict(make_vocab_size_divisible_by=2), tensor_parallel=4), 4,
             "padded vocab"),
            (cfg(tensor_parallel=2), 3, "world size"),
            (cfg(dict(seq_length=18), context_parallel=4), 4,
             "context parallel"),
            (cfg(context_parallel=2, tensor_parallel=2), 3, "world size")):
        with pytest.raises(ValueError, match=what):
            bad.validate(n_devices=n)
    # the pipeline fields validate as the reference's: the stages and
    # virtual chunks must split the layers, the schedule be known; cp and
    # the expert axis run
    for field in (dict(pipeline_parallel=2), dict(virtual_pipeline_chunks=2),
                  dict(pipeline_schedule="gpipe"),
                  dict(pipeline_store_activations=True)):
        got = cfg(**field).validate(n_devices=2).parallel
        for k, v in field.items():
            assert getattr(got, k) == v
        assert got.data_parallel == 2 // got.pipeline_parallel
    for field, what in ((dict(pipeline_parallel=4), "num_layers"),
                        (dict(virtual_pipeline_chunks=3), "virtual"),
                        (dict(pipeline_schedule="zigzag"), "schedule")):
        with pytest.raises(ValueError, match=what):
            cfg(**field).validate(n_devices=4)
    cp = cfg(context_parallel=2, tensor_parallel=2).validate(n_devices=8)
    assert cp.parallel.data_parallel == 2
    # 4 experts over 2 ranks of their axis, and not over 8 or 6
    for axis, ok, bad in (("tp", dict(tensor_parallel=2), (8, 8)),
                          ("dp", dict(expert_axis="dp"), (1, 6))):
        def moe(**par):
            return tc.MegatronConfig(
                model=tc.mixtral_config("tiny", **SMALL),
                parallel=tc.ParallelConfig(**par))
        got = moe(**ok).validate(n_devices=2).parallel
        assert got.expert_axis == axis and got.data_parallel == (
            1 if axis == "tp" else 2)
        with pytest.raises(ValueError, match="num_experts"):
            moe(tensor_parallel=bad[0], expert_axis=axis).validate(
                n_devices=bad[1])


def test_step_refuses_a_config_its_mesh_was_not_built_for():
    import importlib
    ts = importlib.import_module("megatron_tpu_torch.training.train_step")
    from megatron_tpu_torch.parallel.mesh import single_device_mesh
    tp2 = tc.MegatronConfig(parallel=tc.ParallelConfig(tensor_parallel=2))
    with pytest.raises(ValueError, match="no mesh"):
        ts.make_train_step(tp2, device="cpu")
    sp = tc.MegatronConfig(parallel=tc.ParallelConfig(sequence_parallel=True))
    with pytest.raises(ValueError, match="another parallel config"):
        ts.make_train_step(sp, mesh=single_device_mesh(), device="cpu")


def test_bert_t5_ict_steps_under_a_mesh_raise():
    """Their steps run under (dp, tp) (tests/test_torch_mesh_bert_t5.py).
    Under context parallelism make_train_step refuses a custom loss, and
    run_pretrain refuses a model built on another mesh than the one it is
    given, before it builds anything."""
    import importlib
    from megatron_tpu_torch.models.bert import BertModel, bert_config
    from megatron_tpu_torch.parallel.mesh import single_device_mesh
    from megatron_tpu_torch.training.pretrain import run_pretrain
    ts = importlib.import_module("megatron_tpu_torch.training.train_step")
    cfg = tc.MegatronConfig()
    bert = bert_config(num_layers=2, hidden_size=64, num_attention_heads=4,
                       vocab_size=256, seq_length=16)
    with pytest.raises(ValueError, match="another mesh"):
        run_pretrain(cfg, None, init_params_fn=lambda: BertModel(
            bert, device="cpu"), loss_fn=None, device="cpu",
            mesh=single_device_mesh())
    cp_mesh = dataclasses.replace(single_device_mesh(),
                                  shape=dict(dp=1, pp=1, cp=2, tp=1))
    with pytest.raises(NotImplementedError, match="item 7"):
        ts.make_train_step(cfg, mesh=cp_mesh, loss_fn=lambda *a: 0.0,
                           device="cpu")
