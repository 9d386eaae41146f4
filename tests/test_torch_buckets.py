"""The port's length buckets (data/buckets.py) on the CPU against the JAX
package's.

- `make_buckets`, `bucket_for` (its refusal of overlong input too),
  `collate_bucketed` and `bucket_batches` (the padded tail and
  `drop_last`) equal JAX's, arrays bit for bit;
- the masked-mean loss of a bucket-padded batch equals the unpadded loss
  (1e-5 relative);
- bucketed batches of two lengths go through one port `make_train_step`
  in turn (32, 64, 32) beside JAX's: each step's loss and grad norm within
  1e-5 relative; afterwards each parameter within 1e-5, except where one
  of JAX's gradients (read back from its first moments) is nonzero but
  under G_EXEMPT (Adam's step lr g / (|g| + eps) may turn with the
  rounding of a g that small), as tests/test_torch_tasks.py holds its
  steps.

`test_one_step_two_buckets_bounded_compiles` of the reference pins jit
compile counts, which have no torch counterpart; it is not copied.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data import buckets as jb
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.data import buckets as tb
from megatron_tpu_torch.models import language_model as tlm

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
G_EXEMPT = 1e-7


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def test_make_buckets_and_bucket_for_equal_jax():
    for args in ((4096,), (512, 128), (192, 64), (256, 256), (2048, 64, 32)):
        assert tb.make_buckets(*args) == jb.make_buckets(*args)
    for bad in ((1000,), (512, 100)):
        with pytest.raises(AssertionError):
            tb.make_buckets(*bad)
        with pytest.raises(AssertionError):
            jb.make_buckets(*bad)
    bks = [128, 256, 512]
    for n in (1, 127, 128, 129, 256, 511, 512):
        assert tb.bucket_for(n, bks) == jb.bucket_for(n, bks)
        assert tb.bucket_for(n, bks[::-1]) == jb.bucket_for(n, bks[::-1])
    with pytest.raises(ValueError, match="exceeds the largest bucket 512"):
        tb.bucket_for(513, bks)


def _same_batch(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("masks", [False, True])
def test_collate_bucketed_equals_jax(masks):
    rs = np.random.RandomState(0)
    samples = [rs.randint(1, 100, ln) for ln in (9, 33, 17, 65, 2, 40)]
    lm = ([(rs.rand(len(s) - 1) > 0.3).astype(np.float32) for s in samples]
          if masks else None)
    for buckets in ([32, 64, 128], [128], [64, 96, 200]):
        _same_batch(tb.collate_bucketed(samples, 3, 2, buckets, 7, lm),
                    jb.collate_bucketed(samples, 3, 2, buckets, 7, lm))
    with pytest.raises(ValueError):
        tb.collate_bucketed(samples, 3, 2, [32], 0)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("n", [8, 9, 11])
def test_bucket_batches_equal_jax(drop_last, n):
    rs = np.random.RandomState(n)
    data = []
    for i in range(n):
        toks = rs.randint(1, 100, rs.randint(5, 60))
        # dicts with and without a loss mask, and bare arrays
        data.append(toks if i % 3 == 0 else {
            "tokens": toks, **({"loss_mask": (rs.rand(len(toks) - 1) > 0.5)
                                .astype(np.float32)} if i % 3 == 1 else {})})
    got = list(tb.bucket_batches(iter(data), 2, 2, [64, 128], 0,
                                 drop_last=drop_last))
    want = list(jb.bucket_batches(iter(data), 2, 2, [64, 128], 0,
                                  drop_last=drop_last))
    assert len(got) == len(want) == (n // 4 if drop_last else -(-n // 4))
    for t, j in zip(got, want):
        _same_batch(t, j)


def _cfgs(**kw):
    common = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                  vocab_size=128, seq_length=128, compute_dtype="float32",
                  attention_impl="flash", **kw)
    return jc.llama2_config("tiny", **common), tc.llama2_config("tiny",
                                                                **common)


def test_padded_loss_equals_unpadded():
    _, tcfg = _cfgs()
    model = tlm.LanguageModel(tcfg, device="cpu", seed=0)
    seq = np.random.RandomState(1).randint(1, 100, 33)  # 32 positions
    with torch.no_grad():
        exact = tlm.loss_fn(model, torch.from_numpy(seq[None]), tcfg).item()
        batch = tb.collate_bucketed([seq], 1, 1, [64, 128], pad_id=0)
        padded = tlm.loss_fn(
            model, torch.from_numpy(batch["tokens"][0]), tcfg,
            loss_mask=torch.from_numpy(batch["loss_mask"][0])).item()
    assert batch["tokens"].shape[-1] == 65
    assert _rel(padded, exact) < 1e-5


def test_bucketed_train_steps_match_jax():
    jm, tm = _cfgs()
    opt = dict(lr=1e-3, clip_grad=1.0, weight_decay=0.1)
    tr = dict(micro_batch_size=2, global_batch_size=4, train_iters=10)
    jcfg = jc.MegatronConfig(model=jm, optimizer=jc.OptimizerConfig(**opt),
                             training=jc.TrainingConfig(**tr))
    tcfg = tc.MegatronConfig(model=tm, optimizer=tc.OptimizerConfig(**opt),
                             training=tc.TrainingConfig(**tr))
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    jstep = jts.make_train_step(jcfg, mesh=None, donate=False)
    tstep = tts.make_train_step(tcfg, device="cpu")
    rs = np.random.RandomState(2)
    mus = []
    for longest in (30, 60, 25):  # buckets 32, 64, 32
        samples = [rs.randint(1, 128, rs.randint(5, longest + 1))
                   for _ in range(3)] + [rs.randint(1, 128, longest + 1)]
        batch = tb.collate_bucketed(samples, 2, 2, [32, 64, 128], pad_id=0)
        assert batch["tokens"].shape[-1] - 1 == (32 if longest < 32 else 64)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, None)
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        for key in ("lm_loss", "grad_norm"):
            assert _rel(float(tmet[key]), float(jmet[key])) < 1e-5, key
        mus.append({k: np.asarray(v) for k, v in
                    _flatten(jstate.opt_state.mu).items()})
    got, _, iteration = train_state_to_numpy(tstate)
    assert iteration == 3
    n_held = n_all = 0
    for name, want in _flatten(jstate.params).items():
        held = np.ones(want.shape, bool)
        prev = np.zeros(want.shape, np.float32)
        for mu in mus:  # mu_t = beta1 mu_{t-1} + (1 - beta1) g_t
            g = np.abs(mu[name] - 0.9 * prev) / 0.1
            held &= (g == 0) | (g >= G_EXEMPT)
            prev = mu[name]
        diff = np.abs(got[name] - np.asarray(want))
        assert diff[held].max(initial=0.0) <= 1e-5, name
        n_held, n_all = n_held + held.sum(), n_all + held.size
    assert n_held > 0.9 * n_all
