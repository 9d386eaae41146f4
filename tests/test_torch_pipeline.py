"""The port's pipelined LM step (parallel/pipeline.py) against the JAX
package's, fp32, on a tiny Llama (4 layers, h 64, 4 q / 2 kv heads, vocab
250, seq 16, 3 microbatches of 2 rows, a random loss mask). The port's
stages are gloo processes (tests/mesh_pool.py); the JAX references run on
the 8-device virtual CPU mesh, each computed once for the file:
- `pipeline_train_1f1b` at pp 2 (recompute mode) and at pp 2 x vpp 2
  (store mode), and `pipeline_loss_fn` (gpipe) at pp 2;
- the unpipelined `lm.loss_fn` over the microbatches (value_and_grad), the
  reference of every layout (pipelining is a schedule, not a change of
  the function).

Arms: pp 2 and 4, store and recompute, vpp 2, gpipe; pp 2 x tp 2 with
sequence parallelism, pp 2 x cp 2 with ring attention, MoE (4 experts,
top 2) at pp 2; pp 2 x dp 2 with ZeRO-1 trains two SGD steps against the
port's one-rank step. With dropout on, the pipelined step equals a
sequential simulation under the same seeds, bit for bit at every layout
and mode.

Limits, and the readings they were set from (this CPU):
- loss within LOSS_RTOL = 1e-5 relative (read: 0, the fp32 losses
  equal);
- each grad leaf within GRAD_TOL = 1e-4 of that leaf's largest grad,
  absolute (read: at most 6.0e-7 of it);
- ZeRO-1 as tests/test_torch_mesh_step.py's check_run (PARAM_REL 1e-2 of
  each leaf's update, metrics 1e-5 relative; read 1.5e-5 of the update
  and 8.6e-8 relative);
- dropout: exact (the simulation's grads bit for bit; its loss, summed
  in float64 on the host, within 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from conftest import make_test_mesh
from megatron_tpu import config as jc
from megatron_tpu.models import language_model as jlm
from megatron_tpu.parallel import pipeline as jpl
from megatron_tpu.parallel import sharding as jshd
from megatron_tpu.training import make_train_step as j_make_step
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.ops.dropout import draw_seeds
from megatron_tpu_torch.parallel import pipeline as pl
from megatron_tpu_torch.parallel import sharding as tshd
from megatron_tpu_torch.parallel.mesh import single_device_mesh
from mesh_pool import RankPool
from test_torch_mesh_step import check_run

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
SEQ, VOCAB, N_MICRO, ROWS = 16, 250, 3, 2


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def model_kw(**kw):
    return dict(dict(num_layers=4, hidden_size=64, num_attention_heads=4,
                     num_kv_heads=2, vocab_size=VOCAB,
                     make_vocab_size_divisible_by=128, seq_length=SEQ,
                     compute_dtype="float32"), **kw)


def configs(*, pp=1, vpp=1, tp=1, dp=1, cp=1, sp=False, zero=False,
            schedule="1f1b", store=False, family="llama", **kw):
    """(JAX config, port config) of one layout."""
    par = dict(pipeline_parallel=pp, virtual_pipeline_chunks=vpp,
               tensor_parallel=tp, context_parallel=cp, sequence_parallel=sp,
               use_distributed_optimizer=zero, pipeline_schedule=schedule,
               pipeline_store_activations=store)
    out = []
    for mod in (jc, tc):
        make = (mod.mixtral_config if family == "moe"
                else mod.llama2_config)
        out.append(mod.MegatronConfig(
            model=make("tiny", **model_kw(**kw)),
            parallel=mod.ParallelConfig(**par),
            optimizer=mod.OptimizerConfig(optimizer="sgd", lr=0.1,
                                          sgd_momentum=0.0, clip_grad=1.0,
                                          weight_decay=0.01),
            training=mod.TrainingConfig(
                micro_batch_size=ROWS // dp,
                global_batch_size=ROWS * N_MICRO, log_params_norm=True),
        ).validate(n_devices=pp * tp * dp * cp))
    return out


def make_batch(seed=1):
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, VOCAB, (N_MICRO, ROWS, SEQ + 1)),
            "loss_mask": (rs.rand(N_MICRO, ROWS, SEQ) > 0.25).astype(
                np.float32)}


def jax_weights(jcfg):
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg.model)
    return params, {k.replace("/", "."): np.asarray(v)
                    for k, v in _flatten(params).items()}


def as_port(tree) -> dict:
    return {k.replace("/", "."): np.asarray(v)
            for k, v in _flatten(tree).items()}


def jax_sequential(jcfg, params, batch):
    """The unpipelined reference: mean over microbatches of lm.loss_fn."""
    rope = jlm.make_rope(jcfg.model)
    tokens, mask = jnp.asarray(batch["tokens"]), jnp.asarray(
        batch["loss_mask"])

    def loss(p):
        return sum(jlm.loss_fn(p, tokens[i], jcfg.model, loss_mask=mask[i],
                               rope=rope, deterministic=True)
                   for i in range(N_MICRO)) / N_MICRO
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), as_port(grads)


def jax_1f1b(jcfg, params, batch, pp, vpp, store):
    mesh = make_test_mesh(jax.devices(), pp=pp)
    intake, chunk, head = jpl.gpt_1f1b_fns(jcfg.model, deterministic=True)
    streams = jpl.gpt_1f1b_streams(jnp.asarray(batch["tokens"]), jcfg.model,
                                   loss_mask=jnp.asarray(batch["loss_mask"]))

    def run(p, s):
        return jpl.pipeline_train_1f1b(
            p, s, jcfg.model, mesh, intake_fn=intake, chunk_fn=chunk,
            head_loss_fn=head, batch_shape=(ROWS, SEQ), vpp=vpp,
            store_activations=store)
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(run)(params, streams)
    return float(loss), as_port(grads)


@pytest.fixture(scope="module")
def ref():
    """The JAX references of the dense Llama, once for the file."""
    jcfg, _ = configs()
    params, weights = jax_weights(jcfg)
    batch = make_batch()
    mesh = make_test_mesh(jax.devices(), pp=2)
    with jax.set_mesh(mesh):
        gpipe = float(jax.jit(lambda p, t, m: jpl.pipeline_loss_fn(
            p, t, jcfg.model, mesh, loss_mask=m))(
                params, jnp.asarray(batch["tokens"]),
                jnp.asarray(batch["loss_mask"])))
    return {"weights": weights, "batch": batch,
            "sequential": jax_sequential(jcfg, params, batch),
            "1f1b": jax_1f1b(jcfg, params, batch, 2, 1, False),
            "1f1b_vpp2": jax_1f1b(jcfg, params, batch, 2, 2, True),
            "gpipe_loss": gpipe}


def check(got: dict, want: tuple):
    loss, grads = want
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    assert sorted(got["grads"]) == sorted(grads)
    for k, w in grads.items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


def run_arm(pool, tcfg, weights, batch, seed=None):
    par = tcfg.parallel
    world = (par.pipeline_parallel * par.tensor_parallel
             * par.context_parallel * par.data_parallel)
    ranks = pool.run(world, mesh_ranks.pipeline_grads, tcfg, weights,
                     batch, seed)
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]  # every stage reports it
    return ranks[0]


ARMS = {"pp2": dict(pp=2), "pp2_store": dict(pp=2, store=True),
        "pp4": dict(pp=4), "pp4_store": dict(pp=4, store=True),
        "vpp2": dict(pp=2, vpp=2), "vpp2_store": dict(pp=2, vpp=2,
                                                     store=True),
        "gpipe": dict(pp=2, schedule="gpipe"),
        "gpipe_vpp2": dict(pp=2, vpp=2, schedule="gpipe")}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_pipelined_grads_match_jax(pool, ref, arm):
    """Each schedule, mode and layout against the reference's 1F1B (pp 2
    recompute; pp 2 x vpp 2 store) and its unpipelined loss."""
    _, tcfg = configs(**ARMS[arm])
    got = run_arm(pool, tcfg, ref["weights"], ref["batch"])
    check(got, ref["sequential"])
    check(got, ref["1f1b_vpp2" if "vpp2" in arm else "1f1b"])
    # 1F1B's stash never holds more than 2P - 1 microbatches a chunk
    p = tcfg.parallel.pipeline_parallel * tcfg.parallel.virtual_pipeline_chunks
    assert got["peak"] <= (N_MICRO if "gpipe" in arm
                           else min(N_MICRO, 2 * p - 1))


def test_eval_loss_matches_gpipe(pool, ref):
    """pipeline_loss_fn (the eval forward) at pp 2 and pp 2 x vpp 2."""
    for kw in (dict(pp=2), dict(pp=2, vpp=2)):
        _, tcfg = configs(**kw)
        got = pool.run(2, mesh_ranks.pipeline_eval, tcfg, ref["weights"],
                       ref["batch"])
        for g in got:
            np.testing.assert_allclose(g, ref["gpipe_loss"],
                                       rtol=LOSS_RTOL)


@pytest.mark.parametrize("kw", [dict(pp=2, tp=2, sp=True),
                                dict(pp=2, cp=2, attention_impl="ring"),
                                dict(pp=2, dp=2)],
                         ids=["tp2_sp", "cp2_ring", "dp2"])
def test_pipeline_beside_the_mesh(pool, ref, kw):
    """pp beside tp with sequence parallelism, cp with the ring's zigzag
    streams, and dp (each rank its rows, the loss over the whole
    microbatch's mask count) against the unpipelined reference."""
    _, tcfg = configs(**kw)
    check(run_arm(pool, tcfg, ref["weights"], ref["batch"]),
          ref["sequential"])


def test_moe_at_pp2(pool):
    """The MoE decoder (4 experts, top 2, aux coefficient 0.1) at pp 2:
    each stage's router loss reaches the loss and its own routers."""
    kw = dict(moe_aux_loss_coeff=0.1, moe_capacity_factor=4.0)
    jcfg, _ = configs(family="moe", **kw)
    params, weights = jax_weights(jcfg)
    batch = make_batch(2)
    want = jax_sequential(jcfg, params, batch)
    for arm in (dict(pp=2), dict(pp=2, store=True, vpp=2)):
        _, tcfg = configs(family="moe", **arm, **kw)
        check(run_arm(pool, tcfg, weights, batch), want)


def test_zero1_dp2_trains_like_one_rank(pool, ref):
    """pp 2 x dp 2 with the distributed optimizer, two SGD steps, against
    the port's one-rank step from the same weights."""
    _, one = configs()
    _, tcfg = configs(pp=2, dp=2, zero=True)
    batches = [make_batch(3), make_batch(4)]
    want = pool.run(1, mesh_ranks.train, one, ref["weights"], batches,
                    None, False)[0]
    ranks = pool.run(4, mesh_ranks.train, tcfg, ref["weights"], batches)
    check_run(ranks, want, ref["weights"])


def test_zero1_layout_matches_reference():
    """Under pp the distributed optimizer cuts only the stacked leaves, on
    the dim the reference's tree_distributed_opt_sharding(pipelined=True)
    puts dp on."""
    jcfg, tcfg = configs(pp=2, dp=2, zero=True)
    jmesh = make_test_mesh(jax.devices(), dp=2, pp=2)
    rules = jshd.make_logical_rules(False)
    shapes = jax.eval_shape(lambda: jlm.model_init(jax.random.PRNGKey(0),
                                                   jcfg.model))
    def walk(tree, prefix=""):
        out = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                out.update(walk(v, f"{prefix}{key}/"))
            else:
                out[prefix + key] = v
        return out
    spec = walk(jshd.tree_distributed_opt_sharding(
        jmesh, jlm.model_axes(jcfg.model), rules, shapes, pipelined=True))
    mesh = dataclasses.replace(single_device_mesh(),
                               shape=dict(dp=2, pp=2, cp=1, tp=1),
                               parallel=tcfg.parallel)
    axes = tlm.flat_axes(tlm.model_axes(tcfg.model))
    leaves = walk(shapes)
    cut = 0
    for k, sh in spec.items():
        want = next((d for d, a in enumerate(sh.spec) if a == "dp"), None)
        cut += want is not None
        shape = list(leaves[k].shape)
        if "layers" in axes[k.replace("/", ".")]:
            shape[0] //= 2
        assert tshd.distributed_opt_dim(axes[k.replace("/", ".")],
                                        tuple(shape), mesh) == want, k
    assert cut and cut < len(spec)  # the stacked leaves, and only they


def sequential_dropout(tcfg, weights, batch, seed):
    """The reference's simulation (tests/test_pipeline.py:458-506): each
    microbatch through the same intake, chunk and head functions in
    order, one chunk of every layer, under the step's seeds."""
    model = mesh_ranks.model_on(tcfg, weights)
    mcfg = tcfg.model
    rope = tlm.make_rope(mcfg, device="cpu")
    intake, chunk, head = pl.gpt_1f1b_fns(mcfg, rope, deterministic=False)
    tokens = torch.from_numpy(batch["tokens"])
    streams = pl.gpt_1f1b_streams(tokens, mcfg, torch.from_numpy(
        batch["loss_mask"]))
    seeds = draw_seeds(torch.Generator().manual_seed(seed), N_MICRO)
    total = 0.0
    for m in range(N_MICRO):
        sl = {k: v[m] for k, v in streams.items() if v is not None}
        x = intake(model, sl, seeds[m])
        h, _ = chunk(model["transformer"], x, sl, 0, seeds[m])
        loss = head(model, h, sl, seeds[m])
        (loss / N_MICRO).backward()
        total += float(loss.detach()) / N_MICRO
    return total, {k: p.grad.numpy() for k, p in model.named_parameters()}


def test_dropout_masks_bit_equal_across_layouts(pool, ref):
    """Dropout on (hidden 0.3, attention 0.1): the pipelined step equals
    the sequential simulation under the same seeds bit for bit, at pp 2
    and 4, vpp 2, store and recompute, and gpipe — the masks depend on
    the microbatch and the layer alone."""
    kw = dict(hidden_dropout=0.3, attention_dropout=0.1)
    _, one = configs(**kw)
    want_loss, want = sequential_dropout(one, ref["weights"], ref["batch"],
                                         7)
    nodrop = ref["sequential"][0]
    assert abs(want_loss - nodrop) > 1e-3  # the masks took effect
    for arm in (dict(pp=2), dict(pp=2, store=True), dict(pp=4),
                dict(pp=2, vpp=2), dict(pp=2, vpp=2, store=True),
                dict(pp=2, schedule="gpipe")):
        _, tcfg = configs(**arm, **kw)
        got = run_arm(pool, tcfg, ref["weights"], ref["batch"], seed=7)
        assert got["loss"] == pytest.approx(want_loss, rel=1e-6, abs=0)
        for k, w in want.items():
            np.testing.assert_array_equal(got["grads"][k], w, err_msg=k)


def test_config_refusals_match_reference(caplog):
    """Each pipeline check of the reference's config raises in the port
    (the reference asserts, the port raises ValueError), and store mode
    under gpipe is dropped with the reference's warning."""
    def both(model=None, n=2, **par):
        out = []
        for mod in (jc, tc):
            make = (mod.mixtral_config if model == "moe"
                    else mod.llama2_config)
            out.append(lambda mod=mod, make=make: mod.MegatronConfig(
                model=make("tiny", **model_kw()),
                parallel=mod.ParallelConfig(**par)).validate(n_devices=n))
        return out
    for kw, n, what in ((dict(pipeline_parallel=3), 3, "num_layers"),
                        (dict(pipeline_parallel=2, virtual_pipeline_chunks=3),
                         2, "virtual"),
                        (dict(pipeline_parallel=2,
                              pipeline_schedule="zigzag"), 2, "schedule")):
        j, t = both(n=n, **kw)
        with pytest.raises(AssertionError):
            j()
        with pytest.raises(ValueError, match=what):
            t()
    for kw, n in ((dict(pipeline_parallel=2, expert_axis="dp"), 4),
                  (dict(pipeline_parallel=2, tensor_parallel=2), 4),
                  (dict(pipeline_parallel=2, expert_axis="dp"), None)):
        j, t = both("moe", n=n, **kw)
        with pytest.raises(AssertionError):
            j()
        with pytest.raises(ValueError, match="pipeline_parallel"):
            t()
    j, t = both(pipeline_parallel=2, pipeline_schedule="gpipe",
                pipeline_store_activations=True)
    assert not j().parallel.pipeline_store_activations
    assert not t().parallel.pipeline_store_activations
    assert caplog.text.count("only applies to the 1f1b schedule") == 2


def test_make_train_step_refusals_match_reference():
    """make_train_step under pp refuses what the reference refuses: a
    pipelined_spec under gpipe, a custom loss_fn with neither a spec nor
    a pipelined loss; a custom loss under cp still raises (ROADMAP item 7
    (g))."""
    import importlib
    ts = importlib.import_module("megatron_tpu_torch.training.train_step")
    for schedule, kw in (("gpipe", dict(pipelined_spec=object())),
                         ("1f1b", dict(loss_fn=lambda *a: 0.0))):
        jcfg, tcfg = configs(pp=2, schedule=schedule)
        jmesh = make_test_mesh(jax.devices(), pp=2)
        with pytest.raises(AssertionError):
            j_make_step(jcfg, mesh=jmesh, **kw)
        mesh = dataclasses.replace(single_device_mesh(),
                                   shape=dict(dp=1, pp=2, cp=1, tp=1),
                                   parallel=tcfg.parallel)
        with pytest.raises(ValueError, match="pipelined_spec|1F1B"):
            ts.make_train_step(tcfg, mesh=mesh, device="cpu", **kw)
    _, tcfg = configs(pp=2, cp=2, attention_impl="ring")
    mesh = dataclasses.replace(single_device_mesh(),
                               shape=dict(dp=1, pp=2, cp=2, tp=1),
                               parallel=tcfg.parallel)
    with pytest.raises(NotImplementedError, match="item 7 \\(g\\)"):
        ts.make_train_step(tcfg, mesh=mesh, device="cpu",
                           pipelined_spec=object())
