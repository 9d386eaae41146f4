"""The port's checkpoints (megatron_tpu_torch/training/checkpointing.py)
against the JAX package's npz checkpoints, both ways, on the CPU.

Every check is exact: a checkpoint one package saves loads in the other with
every parameter, moment and scaler leaf bit-equal, and the same iteration,
consumed samples and data state; the manifests verify on both sides; the
config round-trips field for field.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.resilience import integrity as j_integrity
from megatron_tpu.training import checkpointing as j_ckpt
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu.training.train_step import (TrainState as JTrainState,
                                              init_train_state as j_init)
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (load_npz_checkpoint,
                                                 train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.resilience import integrity as t_integrity
from megatron_tpu_torch.training import checkpointing as t_ckpt
from megatron_tpu_torch.training import init_train_state as t_init

torch.set_num_threads(2)
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             num_kv_heads=2, vocab_size=300, seq_length=32)
DATA_STATE = {"version": 1, "dataloader_type": "single", "seed": 1234,
              "drop_last": True, "micro_batch_times_dp": 2,
              "dataset_len": 64, "epoch": 0, "samples_yielded": 12,
              "sampler": {"consumed_samples": 12}, "prefetch_depth": 2}


def _configs(**training):
    kw = dict(training, save_interval=3, seed=7)
    data = dict(data_path=["1.0", "corpus_document"], split="90,5,5",
                reset_attention_mask=True)
    return (jc.MegatronConfig(model=jc.llama2_config("tiny", **SMALL),
                              training=jc.TrainingConfig(**kw),
                              data=jc.DataConfig(**data)),
            tc.MegatronConfig(model=tc.llama2_config("tiny", **SMALL),
                              training=tc.TrainingConfig(**kw),
                              data=tc.DataConfig(**data)))


def _jax_state(seed=0):
    """A JAX training state with random moments, step and scaler."""
    jcfg, _ = _configs()
    st = j_init(jax.random.PRNGKey(seed), jcfg)
    rs = np.random.RandomState(seed)

    def rand(x):
        return jnp.asarray(rs.standard_normal(x.shape).astype(np.float32))

    o = st.opt_state
    opt = o._replace(step=jnp.int32(5), mu=jax.tree.map(rand, o.mu),
                     nu=jax.tree.map(lambda x: jnp.abs(rand(x)), o.nu),
                     scaler=o.scaler._replace(
                         scale=jnp.float32(2.0 ** 12),
                         growth_tracker=jnp.int32(3),
                         hysteresis=jnp.int32(1)))
    return JTrainState(st.params, opt, jnp.int32(5))


def _port_state(jstate):
    _, tcfg = _configs()
    return train_state_from_numpy(jstate.params, jstate.opt_state,
                                  jstate.iteration, tcfg, device="cpu")


def _port_leaves(state):
    params, opt, _ = train_state_to_numpy(state)
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"mu/{k}": v for k, v in opt["mu"].items()})
    flat.update({f"nu/{k}": v for k, v in opt["nu"].items()})
    flat.update({"step": np.int32(opt["step"]),
                 **{f"scaler/{k}": v for k, v in opt["scaler"].items()}})
    return {k: np.array(v) for k, v in flat.items()}  # copies, not views


def _jax_leaves(jstate):
    flat = {f"params/{k}": v for k, v in _flatten(jstate.params).items()}
    flat.update(_flatten(jstate.opt_state))
    return flat


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    jcfg, tcfg = _configs()
    src = _port_state(_jax_state(0))
    root = str(tmp_path)
    d = t_ckpt.save_checkpoint(root, src, tcfg, 5, consumed_samples=20,
                               data_state=DATA_STATE)
    assert j_integrity.verify_checkpoint(d) == (True, "ok")
    assert j_ckpt.read_tracker(root) == "5"
    with open(os.path.join(d, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["format_version"] == 1 and meta["has_opt_state"]
    loaded = j_ckpt.load_checkpoint(root, j_init(jax.random.PRNGKey(1),
                                                 jcfg))
    assert (loaded.iteration, loaded.consumed_samples) == (5, 20)
    assert loaded.data_state == DATA_STATE
    _assert_leaves_equal(_jax_leaves(loaded.state), _port_leaves(src))


def test_jax_checkpoint_loads_in_port(tmp_path):
    jcfg, tcfg = _configs()
    jstate = _jax_state(1)
    root = str(tmp_path)
    d = j_ckpt.save_checkpoint(root, jstate, jcfg, 5, consumed_samples=20,
                               backend="npz", data_state=DATA_STATE,
                               quarantine=[{"from_iteration": 2}])
    assert t_integrity.verify_checkpoint(d) == (True, "ok")
    example = t_init(tcfg, seed=3, device="cpu")
    loaded = t_ckpt.load_checkpoint(root, example)
    assert loaded.state is example and example.iteration == 5
    assert (loaded.iteration, loaded.consumed_samples) == (5, 20)
    assert loaded.data_state == DATA_STATE
    assert loaded.quarantine == [{"from_iteration": 2}]
    _assert_leaves_equal(_port_leaves(example), _jax_leaves(jstate))
    # the bridge's loader reads the same weights through checkpointing
    model, cfg = load_npz_checkpoint(root, device="cpu")
    assert cfg == tcfg.model.derived()
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(_flatten(jstate.params)[
                k.replace(".", "/")]))


def test_moe_train_state_crosses_packages_bit_for_bit(tmp_path):
    """A tiny Mixtral's train state (router, expert banks, their moments):
    each package reads the other's npz checkpoint leaf for leaf, bit for
    bit."""
    model_kw = dict(SMALL, vocab_size=256, num_experts=4)
    jcfg = jc.MegatronConfig(model=jc.mixtral_config("tiny", **model_kw))
    tcfg = tc.MegatronConfig(model=tc.mixtral_config("tiny", **model_kw))
    st = j_init(jax.random.PRNGKey(2), jcfg)
    rs = np.random.RandomState(2)
    jstate = JTrainState(st.params, st.opt_state._replace(
        step=jnp.int32(4), mu=jax.tree.map(lambda x: jnp.asarray(
            rs.standard_normal(x.shape).astype(np.float32)), st.opt_state.mu)),
        jnp.int32(4))
    # [L, E, h, 2, ffn]: the expert bank, not a dense MLP
    assert _flatten(jstate.params)["transformer/mlp/w1"].shape[:2] == (2, 4)
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, jcfg, 4,
                           backend="npz")
    example = t_init(tcfg, seed=3, device="cpu")
    t_ckpt.load_checkpoint(str(tmp_path / "jax"), example)
    _assert_leaves_equal(_port_leaves(example), _jax_leaves(jstate))
    t_ckpt.save_checkpoint(str(tmp_path / "port"), example, tcfg, 4)
    loaded = j_ckpt.load_checkpoint(str(tmp_path / "port"),
                                    j_init(jax.random.PRNGKey(5), jcfg))
    _assert_leaves_equal(_jax_leaves(loaded.state), _port_leaves(example))


@pytest.mark.parametrize("mode", ["finetune", "no_load_optim"])
def test_finetune_and_no_load_optim_match_jax(tmp_path, mode):
    jcfg, tcfg = _configs()
    root = str(tmp_path)
    t_ckpt.save_checkpoint(root, _port_state(_jax_state(2)), tcfg, 5,
                           consumed_samples=20, data_state=DATA_STATE)
    jex = j_init(jax.random.PRNGKey(4), jcfg)
    tex = _port_state(jex)
    fresh_opt = _port_leaves(tex)
    kw = {mode: True}
    jl = j_ckpt.load_checkpoint(root, jex, **kw)
    tl = t_ckpt.load_checkpoint(root, tex, **kw)
    assert (tl.iteration, tl.consumed_samples, tl.data_state) == (
        jl.iteration, jl.consumed_samples, jl.data_state)
    assert tl.state.iteration == int(jl.state.iteration)
    _assert_leaves_equal(_port_leaves(tl.state), _jax_leaves(jl.state))
    got = _port_leaves(tl.state)
    for k in fresh_opt:
        if not k.startswith("params/"):  # the optimizer stays the example's
            np.testing.assert_array_equal(got[k], fresh_opt[k])


def test_torn_tip_falls_back_to_newest_valid(tmp_path):
    _, tcfg = _configs()
    root = str(tmp_path)
    state = _port_state(_jax_state(3))
    want = _port_leaves(state)
    t_ckpt.save_checkpoint(root, state, tcfg, 3, consumed_samples=12)
    with torch.no_grad():
        state.params.embedding.word_embeddings.add_(1.0)
    d6 = t_ckpt.save_checkpoint(root, state, tcfg, 6, consumed_samples=24)
    path = os.path.join(d6, "params.npz")
    with open(path, "r+b") as f:  # one flipped byte: bit rot in the tip
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    assert not t_integrity.verify_checkpoint(d6)[0]
    tex = _port_state(_jax_state(5))
    loaded = t_ckpt.load_checkpoint(root, tex)
    assert (loaded.iteration, loaded.consumed_samples) == (3, 12)
    assert loaded.ckpt_dir.endswith("iter_0000003")
    _assert_leaves_equal(_port_leaves(tex), want)
    jl = j_ckpt.load_checkpoint(root, _jax_state(5))
    assert jl.iteration == 3


def test_config_round_trips_between_packages(tmp_path):
    jcfg, tcfg = _configs(rampup_batch_size=(2, 2, 8), global_batch_size=4,
                          micro_batch_size=2)
    tcfg = dataclasses.replace(tcfg, resilience=tc.ResilienceConfig(
        keep_last_k=3, loss_spike_factor=4.0))
    jcfg = dataclasses.replace(jcfg, resilience=jc.ResilienceConfig(
        keep_last_k=3, loss_spike_factor=4.0))
    root = str(tmp_path / "t")
    t_ckpt.save_checkpoint(root, _port_state(_jax_state(0)), tcfg, 1)
    got = j_ckpt.load_config_from_checkpoint(root)
    for section in ("model", "optimizer", "training", "data", "resilience"):
        want = dataclasses.asdict(getattr(tcfg, section))
        have = dataclasses.asdict(getattr(got, section))
        assert set(want) <= set(have), section
        assert json.loads(json.dumps({k: have[k] for k in want})) == \
            json.loads(json.dumps(want)), section
    root = str(tmp_path / "j")
    j_ckpt.save_checkpoint(root, _jax_state(0), jcfg, 1, backend="npz")
    back = t_ckpt.load_config_from_checkpoint(root)
    assert back.model == tcfg.model and back.optimizer == tcfg.optimizer
    assert back.data == tcfg.data and back.resilience == tcfg.resilience
    assert dataclasses.replace(back.training, rampup_batch_size=(2, 2, 8)) \
        == tcfg.training


def test_orbax_checkpoint_raises(tmp_path):
    d = tmp_path / "iter_0000004"
    (d / "state").mkdir(parents=True)
    (d / "metadata.json").write_text(json.dumps(
        {"iteration": 4, "format_version": 2}))
    (tmp_path / t_ckpt.TRACKER).write_text("4")
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="orbax"):
        t_ckpt.load_checkpoint(str(tmp_path),
                               t_init(tcfg, seed=0, device="cpu"))
    with pytest.raises(NotImplementedError, match="orbax"):
        load_npz_checkpoint(str(tmp_path), device="cpu")


def test_missing_checkpoint_starts_from_scratch(tmp_path):
    _, tcfg = _configs()
    loaded = t_ckpt.load_checkpoint(str(tmp_path),
                                    t_init(tcfg, seed=0, device="cpu"))
    assert tuple(loaded) == (None, 0, 0)


def _npz_members():
    rs = np.random.RandomState(3)
    return {"c": rs.randn(5, 7).astype(np.float32),
            "fortran": np.asfortranarray(rs.randn(4, 6)),
            "scalar": np.float32(2.5) * np.ones((), np.float32),
            "empty": np.zeros((0, 3), np.int32),
            "int8": rs.randint(-128, 127, (3, 2, 5)).astype(np.int8)}


@pytest.mark.parametrize("writer", ["np.savez", "port"])
def test_npz_reader_matches_np_load(tmp_path, writer):
    """The port's direct member reader gives np.load's arrays, for files
    numpy writes (the JAX package's) and files the port writes (a
    transposed tensor stored in Fortran order), with and without the
    CRC-32 check; the port's write-time digest is the file's SHA-256."""
    path = str(tmp_path / "x.npz")
    members = _npz_members()
    if writer == "np.savez":
        np.savez(path, **members)
    else:
        leaves = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in members.items()}
        leaves["fortran"] = torch.from_numpy(
            np.ascontiguousarray(members["fortran"].T)).T
        size, digest = t_ckpt._write_npz(path, leaves)
        assert digest == t_integrity._digest_file(path)
        assert size == os.path.getsize(path)
    with np.load(path) as npz:
        want = {k: npz[k] for k in npz.files}
    for crc in (True, False):
        got = dict(t_ckpt._npz_arrays(path, crc=crc))
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert np.array_equal(got[k], v), k
    assert list(dict(t_ckpt._npz_arrays(path, ["int8", "c"]))) == \
        ["int8", "c"]
    with pytest.raises(KeyError):
        dict(t_ckpt._npz_arrays(path, ["missing"]))


def test_npz_reader_checks_crc_unless_digested(tmp_path):
    """A flipped payload byte fails the member's CRC-32 as np.load fails
    it; with the check off (the caller verified the file's SHA-256 first)
    the reader does not look."""
    import zipfile
    path = str(tmp_path / "x.npz")
    np.savez(path, a=np.arange(64, dtype=np.float32))
    raw = bytearray(open(path, "rb").read())
    at = raw.index(np.arange(64, dtype=np.float32).tobytes()) + 17
    raw[at] ^= 0x40
    open(path, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile):
        with np.load(path) as npz:
            npz["a"]
    with pytest.raises(zipfile.BadZipFile):
        dict(t_ckpt._npz_arrays(path))
    assert not np.array_equal(dict(t_ckpt._npz_arrays(path, crc=False))["a"],
                              np.arange(64, dtype=np.float32))
