"""The port's fault-injection harness and hung-step watchdog
(resilience/faults.py, resilience/watchdog.py) and the training paths they
thread through, against the JAX package.

- The reference's TestFaultInjection and TestWatchdog cases
  (tests/test_resilience.py), ported: scheduled fault points, the
  MEGATRON_TPU_FAULTS grammar, a corrupted batch's non-finite loss through
  the port's train step, the watchdog's deadline, heartbeat, suspend and
  detection-only latch, and a stalled step through the port's loop that
  fires the watchdog, saves a final checkpoint that verifies and exits with
  code 43 (the exit monkeypatched).
- `from_env` gives JAX's schedules for a list of specs and refuses what JAX
  refuses; the serving points fire on the same engine-step calls.
- The checkpoint fault points (`checkpoint_write`, `tracker_read`) sit where
  JAX's do: one npz save makes the same number of write calls in both
  packages, and scheduled transient errors are absorbed by the retry.
- tools/validate_dataset gives JAX's verdicts on a clean corpus and on each
  of the three corruption modes, and its --smoke record detects all three.
- `python -m megatron_tpu_torch.finetune` reads MEGATRON_TPU_FAULTS and
  --step_timeout_s (CPU, in process).

Every test deactivates the global injector and stops every watchdog it
starts, so no thread outlives it on an xdist worker.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.resilience import FaultInjector as JFaultInjector
from megatron_tpu.resilience import use_fault_injector as j_use
from megatron_tpu.training import checkpointing as j_ckpt
from megatron_tpu.training.train_step import init_train_state as j_init
from megatron_tpu_torch import config as tc
from megatron_tpu_torch import finetune
from megatron_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from megatron_tpu_torch.resilience import (FaultInjector, InjectedFault,
                                           StepWatchdog, deactivate,
                                           fault_point, get_fault_injector,
                                           integrity, use_fault_injector)
from megatron_tpu_torch.resilience import watchdog as watchdog_mod
from megatron_tpu_torch.tools import preprocess_data as t_pre
from megatron_tpu_torch.tools import synthetic_corpus as sc
from megatron_tpu_torch.tools import validate_dataset as t_validate
from megatron_tpu_torch.training import checkpointing as ckpt
from megatron_tpu_torch.training import init_train_state, make_train_step
from megatron_tpu_torch.training.loop import train
from tools import validate_dataset as j_validate

torch.set_num_threads(2)
FAST_IO = dict(io_backoff_s=0.01, io_backoff_max_s=0.02)
MODEL = dict(num_layers=2, hidden_size=32, num_attention_heads=2,
             vocab_size=64, seq_length=16)


@pytest.fixture(autouse=True)
def _no_leftover_injector():
    yield
    deactivate()


def tiny_cfg(**res_overrides):
    return tc.MegatronConfig(
        model=tc.ModelConfig(**MODEL),
        optimizer=tc.OptimizerConfig(lr=1e-3),
        training=tc.TrainingConfig(micro_batch_size=1, global_batch_size=2,
                                   train_iters=6, log_interval=100),
        data=tc.DataConfig(num_workers=0),
        resilience=tc.ResilienceConfig(**{**FAST_IO, **res_overrides}),
    ).validate()


def _batch(key=1):
    rs = np.random.RandomState(key)
    return {"tokens": rs.randint(0, 64, (2, 1, 17)).astype(np.int64),
            "loss_mask": np.ones((2, 1, 16), np.float32)}


def _batches(seed=0):
    i = 0
    while True:
        yield _batch(seed * 1000 + i)
        i += 1


# ---------------------------------------------------------------------------
# fault points and the MEGATRON_TPU_FAULTS grammar
# ---------------------------------------------------------------------------

def test_fault_point_fires_on_scheduled_calls_only():
    inj = FaultInjector(transient_errors={"checkpoint_write": {2}})
    with use_fault_injector(inj):
        fault_point("checkpoint_write")  # call 1: clean
        with pytest.raises(InjectedFault):
            fault_point("checkpoint_write")  # call 2: fires
        fault_point("checkpoint_write")  # call 3: clean again
    fault_point("checkpoint_write")  # deactivated: no-op
    assert get_fault_injector() is None
    assert inj.fired == [("transient_error", "checkpoint_write@2")]
    assert issubclass(InjectedFault, OSError)


def test_from_env_spec():
    inj = FaultInjector.from_env("write_error@2, nan@5, nan@6, delay@3:1.5")
    assert inj.transient_errors == {"checkpoint_write": {2}}
    assert inj.nan_step_calls == {5, 6}
    assert inj.delay_step_calls == {3: 1.5}
    assert FaultInjector.from_env("") is None
    with pytest.raises(ValueError):
        FaultInjector.from_env("tyop@1")


SCHEDULE_FIELDS = ("transient_errors", "nan_step_calls", "delay_step_calls",
                   "serve_delay_calls", "serve_crash_calls",
                   "serve_nan_calls", "serve_host_corrupt_calls",
                   "serve_adapter_corrupt_calls")


@pytest.mark.parametrize("spec", [
    "write_error@2,write_error@3,nan@5,nan@6,delay@4:1.5",
    "tracker_error@1, delay@7, serve_delay@2:8, serve_crash@3",
    "serve_nan@4:1,serve_nan@9,serve_host_corrupt@5,serve_adapter_corrupt@6",
    " , serve_crash@1,serve_crash@2,,", "delay@3:30", ""])
def test_from_env_matches_jax(spec, monkeypatch):
    want = JFaultInjector.from_env(spec)
    got = FaultInjector.from_env(spec)
    if want is None:
        assert got is None
        return
    for name in SCHEDULE_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    # read from the environment when no spec is passed
    monkeypatch.setenv(FaultInjector.ENV_VAR, spec)
    env = FaultInjector.from_env()
    assert all(getattr(env, n) == getattr(want, n) for n in SCHEDULE_FIELDS)


@pytest.mark.parametrize("spec", ["tyop@1", "nan@x", "delay@", "serve_nan@"])
def test_from_env_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        JFaultInjector.from_env(spec)
    with pytest.raises(ValueError):
        FaultInjector.from_env(spec)


def test_serving_points_fire_on_the_same_calls_as_jax():
    spec = "serve_delay@2:0.01,serve_crash@3,serve_nan@4:1,serve_nan@6"
    outcomes = []
    for inj in (JFaultInjector.from_env(spec), FaultInjector.from_env(spec)):
        seen = []
        for _ in range(7):
            call = inj.next_serve_step()
            slept = []
            inj.maybe_serve_delay(call, sleep=slept.append)
            try:
                inj.check_serve_crash(call)
                crashed = False
            except OSError:
                crashed = True
            seen.append((call, tuple(slept), crashed,
                         inj.serve_nan_slot(call)))
        outcomes.append((seen, inj.fired))
    assert outcomes[0] == outcomes[1]


def test_corrupt_batch_produces_nonfinite_loss():
    cfg = tiny_cfg()
    state = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, device="cpu")
    inj = FaultInjector(nan_step_calls={1})
    assert inj.corrupt_batch(_batch(), 2) is not None  # unscheduled: as is
    bad = inj.corrupt_batch(_batch(), 1)
    assert np.isinf(bad["loss_mask"]).all()
    batch = {k: torch.from_numpy(v) for k, v in bad.items()}
    _, m = step(state, batch, torch.Generator().manual_seed(0))
    assert not np.isfinite(float(m["lm_loss"]))
    assert bool(m["found_inf"])


# ---------------------------------------------------------------------------
# checkpoint fault points
# ---------------------------------------------------------------------------

def test_checkpoint_write_points_match_jax_and_retry_absorbs(tmp_path):
    """One npz save calls `checkpoint_write` as often in both packages;
    transient errors on the first two writes are retried away and the
    checkpoint verifies; a tracker read error is retried too."""
    jcfg = jc.MegatronConfig(model=jc.ModelConfig(**MODEL),
                             resilience=jc.ResilienceConfig(**FAST_IO))
    import jax
    jstate = j_init(jax.random.PRNGKey(0), jcfg.validate(n_devices=1))
    jinj = JFaultInjector()
    with j_use(jinj):
        j_ckpt.save_checkpoint(str(tmp_path / "j"), jstate, jcfg, 3, 6,
                               backend="npz")
    cfg = tiny_cfg()
    state = init_train_state(cfg, seed=0, device="cpu")
    inj = FaultInjector()
    with use_fault_injector(inj):
        ckpt.save_checkpoint(str(tmp_path / "t"), state, cfg, 3, 6)
    assert inj._counts == jinj._counts and inj._counts["checkpoint_write"] > 2

    root = str(tmp_path / "retried")
    inj = FaultInjector.from_env("write_error@1,write_error@2,"
                                 "tracker_error@1")
    with use_fault_injector(inj):
        d = ckpt.save_checkpoint(root, state, cfg, 3, 6)
        assert ckpt.read_tracker(root) == "3"
    assert [k for k, _ in inj.fired] == ["transient_error"] * 3
    ok, why = integrity.verify_checkpoint(d)
    assert ok, why


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_watchdog_fires_after_deadline(monkeypatch):
    exits = []
    monkeypatch.setattr(watchdog_mod, "_exit", exits.append)
    timeouts = []
    wd = StepWatchdog(0.15, on_timeout=lambda: timeouts.append(1),
                      exit_code=43, dump_stacks=False)
    wd.start()
    try:
        deadline = time.monotonic() + 5.0
        while not exits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.fired
        assert timeouts == [1]
        assert exits == [43]
    finally:
        wd.stop()


def test_watchdog_heartbeat_defers_firing(monkeypatch):
    exits = []
    monkeypatch.setattr(watchdog_mod, "_exit", exits.append)
    wd = StepWatchdog(0.3, dump_stacks=False)
    wd.start()
    try:
        for _ in range(5):
            time.sleep(0.1)
            wd.heartbeat()
        assert not wd.fired and exits == []
    finally:
        wd.stop()


def test_watchdog_suspend_pauses_deadline(monkeypatch):
    exits = []
    monkeypatch.setattr(watchdog_mod, "_exit", exits.append)
    wd = StepWatchdog(0.2, poll_s=0.05, dump_stacks=False)
    wd.start()
    try:
        with wd.suspend():
            time.sleep(0.8)
        assert not wd.fired and exits == []
        time.sleep(0.1)  # resumed: inside the fresh deadline
        assert not wd.fired
    finally:
        wd.stop()


def test_watchdog_detection_only_latches_until_rearm(monkeypatch):
    exits = []
    monkeypatch.setattr(watchdog_mod, "_exit", exits.append)
    timeouts = []
    wd = StepWatchdog(0.1, on_timeout=lambda: timeouts.append(1),
                      poll_s=0.02, dump_stacks=False, exit_process=False)
    wd.start()
    try:
        deadline = time.monotonic() + 5.0
        while not timeouts and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)  # latched: no second firing while stalled
        assert timeouts == [1] and wd.fired and exits == []
        wd.rearm()
        assert not wd.fired
        while len(timeouts) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert timeouts == [1, 1] and exits == []
    finally:
        wd.stop()
    assert not wd._thread.is_alive()


def test_watchdog_fires_on_artificially_delayed_step(tmp_path, monkeypatch):
    """Through the port's train loop: a stall before step call 3 passes
    step_timeout_s; the watchdog fires, the final checkpoint lands and
    verifies, and the exit code is 43."""
    exits = []
    monkeypatch.setattr(watchdog_mod, "_exit", exits.append)
    cfg = tiny_cfg(step_timeout_s=0.4, max_consecutive_nonfinite=0)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, train_iters=5, sync_metrics=True))
    root = str(tmp_path)

    def save_fn(st, iteration, consumed, data_state=None, quarantine=None):
        ckpt.save_checkpoint(root, st, cfg, iteration, consumed)

    inj = FaultInjector(delay_step_calls={3: 1.5})
    with use_fault_injector(inj):
        train(cfg, _batches(0), seed=1, save_fn=save_fn, device="cpu")
    assert exits == [43], "the watchdog exits with its own code"
    assert ("delay", "step@3:1.5") in inj.fired
    tag = ckpt.read_tracker(root)
    assert tag is not None
    ok, why = integrity.verify_checkpoint(
        os.path.join(root, f"iter_{int(tag):07d}"))
    assert ok, why


def test_train_deadline_scales_to_the_log_window(monkeypatch):
    """Metrics are fetched once a log window, so the deadline is
    step_timeout_s x log_interval (per step with sync_metrics); the
    watchdog is armed only after the first step and stopped at the end;
    a poisoned batch reaches the step through the injector."""
    made = []

    class Recording(StepWatchdog):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    from megatron_tpu_torch.training import loop
    monkeypatch.setattr(loop, "StepWatchdog", Recording)
    for sync, want in ((False, 30.0 * 4), (True, 30.0)):
        cfg = tiny_cfg(step_timeout_s=30.0, max_consecutive_nonfinite=0)
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, train_iters=4, log_interval=4, sync_metrics=sync))
        inj = FaultInjector(nan_step_calls={2})
        with use_fault_injector(inj):
            train(cfg, _batches(0), seed=1, device="cpu")
        wd = made[-1]
        assert wd.timeout_s == want and wd.started and not wd.fired
        assert not wd._thread.is_alive()
        assert inj.fired == [("nan", "step@2")]


# ---------------------------------------------------------------------------
# tools/validate_dataset
# ---------------------------------------------------------------------------

def _build(prefix):
    b = IndexedDatasetBuilder(prefix, dtype="int32")
    for i in range(16):
        b.add_item(list(range(i, i + 12)))
        b.end_document()
    b.finalize()
    return prefix


@pytest.mark.parametrize("mode", ["clean"] + list(
    FaultInjector.DATASET_FAULTS))
def test_validate_dataset_verdicts_match_jax(tmp_path, mode, capsys):
    prefix = _build(str(tmp_path / "c"))
    if mode != "clean":
        FaultInjector.corrupt_dataset(prefix, mode)
    want = j_validate.check_prefix(prefix)
    got = t_validate.check_prefix(prefix)
    assert bool(got) == bool(want) == (mode != "clean")
    assert [p.startswith("advisory:") for p in got] == [
        p.startswith("advisory:") for p in want]
    assert t_validate.main([prefix]) == j_validate.main([prefix])
    assert ("CORRUPT" in capsys.readouterr().out) == (mode != "clean")


def test_validate_dataset_smoke_detects_every_fault(tmp_path):
    record = t_validate.run_smoke(str(tmp_path))
    assert record["completed"] and record["clean_validates"]
    assert record["detected"] == {m: True for m in
                                  FaultInjector.DATASET_FAULTS}
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert FaultInjector.dataset_corruption_drill(str(tmp_path / "t")) == \
        JFaultInjector.dataset_corruption_drill(str(tmp_path / "j"))


# ---------------------------------------------------------------------------
# the finetune entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("res_corpus")
    vocab, merges = sc.write_gpt2_vocab(str(d), 2000)
    jsonl = sc.write_jsonl(str(d / "c.jsonl"), 40, 2, min_words=5,
                           max_words=40)
    t_pre.main(["--input", jsonl, "--output_prefix", str(d / "c"),
                "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
                vocab, "--merge_file", merges, "--append_eod"])
    return dict(vocab=vocab, merges=merges, data=str(d / "c_document"))


def test_finetune_reads_faults_and_step_timeout(corpus, tmp_path,
                                                monkeypatch):
    """The CPU form of the card's training-watchdog drill: a delay on step
    call 3 past --step_timeout_s makes the watchdog save a checkpoint that
    verifies and exit with --watchdog_exit_code."""
    exits = []
    monkeypatch.setattr(watchdog_mod, "_exit", exits.append)
    monkeypatch.setenv(FaultInjector.ENV_VAR, "delay@3:1.5")
    save = str(tmp_path / "ckpt")
    rc = finetune.main([
        "--model", "llama2-tiny", "--num_layers", "2", "--hidden_size", "64",
        "--num_attention_heads", "4", "--seq_length", "32",
        "--data_path", corpus["data"], "--split", "100,0,0",
        "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
        corpus["vocab"], "--merge_file", corpus["merges"],
        "--micro_batch_size", "2", "--global_batch_size", "2",
        "--train_iters", "4", "--log_interval", "1", "--lr", "1e-3",
        "--step_timeout_s", "0.5", "--watchdog_exit_code", "44",
        "--save", save, "--save_interval", "100", "--no_save_optim"],
        device="cpu")
    assert rc == 0 and exits == [44]
    assert get_fault_injector() is None  # deactivated after the run
    tag = ckpt.read_tracker(save)
    assert tag is not None
    ok, why = integrity.verify_checkpoint(
        os.path.join(save, f"iter_{int(tag):07d}"))
    assert ok, why
