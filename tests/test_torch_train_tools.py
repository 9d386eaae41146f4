"""The port's training tools on the CPU: tools/bench_remat.py and
tools/bench_32k.py at tiny shapes (every arm and the ladder's fit run; the
times are the harness's), and tools/chaos_train.py beside the root tool on
the same fault script (the rollback, the quarantined window, the saves and
both corruption drills equal the reference's)."""
import importlib.util
import json
import os

import pytest
import torch

from megatron_tpu_torch.tools import (bench_32k, bench_common, bench_remat,
                                      chaos_train)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def test_bench_remat_smoke_runs_every_arm(capsys):
    assert bench_remat.main(["--smoke", "--iters", "2", "--warmup", "1"],
                            device="cpu") == 0
    rec, = _records(capsys)
    arms = ["none", "selective", "full", "full+int8"]
    # the root tool's report: every arm's tokens a second, the best arm
    assert list(rec["results"]) == arms
    assert all(v and v > 0 for v in rec["results"].values())
    assert rec["best"] in arms and rec["completed"]
    assert rec["device_kind"] == "cpu"
    for arm in arms:
        a = rec["arms"][arm]
        assert a["peak_gib"] is None      # no device memory on the CPU
        assert a["launches_per_step"]["flash_fwd_cuda"] == 0
    # recompute changes no value: the three bf16 arms train the same loss
    losses = {rec["arms"][a]["loss"] for a in arms[:3]}
    assert len(losses) == 1


def test_bench_remat_reports_a_failed_arm(monkeypatch, capsys):
    real = bench_remat.bench_common.time_train_steps

    def oom_on_none(cfg, *a, **k):
        if cfg.model.recompute_granularity == "none":
            raise RuntimeError("CUDA out of memory (simulated)")
        return real(cfg, *a, **k)

    monkeypatch.setattr(bench_remat.bench_common, "time_train_steps",
                        oom_on_none)
    assert bench_remat.main(["--smoke", "--iters", "1", "--warmup", "1"],
                            device="cpu") == 1
    rec, = _records(capsys)
    assert rec["results"]["none"] is None
    assert "out of memory" in rec["arms"]["none"]["error"]
    assert rec["results"]["full"] > 0 and not rec["completed"]


def test_bench_32k_ladder_and_fit(capsys):
    argv = ["--seq_length", "128", "--hidden", "64", "--ffn", "128",
            "--heads", "4", "--vocab", "512", "--iters", "1", "--warmup",
            "1"]
    assert bench_32k.main(argv, device="cpu") == 0
    recs = _records(capsys)
    assert [r.get("layers") for r in recs[:2]] == [4, 3]
    assert recs[0]["metric"] == "128_slice_train_tokens_per_sec_per_card"
    ext = recs[2]
    assert ext["metric"] == "extrapolated_7b_128_tokens_per_sec_per_card"
    assert "EXTRAPOLATED to 32 layers" in ext["note"]
    # no device utilization from a CPU run
    assert ext["mfu_at_h100_bf16_peak"] is None
    f = bench_32k.fit([(4, recs[0]["step_ms"] / 1e3),
                       (3, recs[1]["step_ms"] / 1e3)], 32)
    assert ext["value"] == pytest.approx(128 / f["step_s"])
    # the fit through two exact points of a + b L
    f = bench_32k.fit([(4, 1.0 + 4 * 0.5), (3, 1.0 + 3 * 0.5)], 32)
    assert f["per_layer_s"] == pytest.approx(0.5)
    assert f["overhead_s"] == pytest.approx(1.0)
    assert f["step_s"] == pytest.approx(17.0)
    assert bench_32k.slice_config(bench_32k.parse([]), 4).model \
        .rope_scaling_factor == 8.0


@pytest.mark.parametrize("error,trained", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), [3, 2]),
    (RuntimeError("an illegal memory access"), None)])
def test_bench_32k_steps_down_only_when_out_of_memory(monkeypatch, error,
                                                      trained):
    """A depth that runs out of card memory is recorded as failed and the
    ladder goes on; any other error stops the run."""
    real = bench_common.time_train_steps

    def fails_at_four(cfg, *a, **k):
        if cfg.model.num_layers == 4:
            raise error
        return real(cfg, *a, **k)

    monkeypatch.setattr(bench_common, "time_train_steps", fails_at_four)
    args = bench_32k.parse(["--seq_length", "64", "--hidden", "32",
                            "--ffn", "64", "--heads", "2", "--vocab", "128",
                            "--iters", "1", "--warmup", "0"])
    if trained is None:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            bench_32k.measure(args, torch.device("cpu"))
        return
    recs = bench_32k.measure(args, torch.device("cpu"))
    assert recs[0] == {"layers": 4, "failed": recs[0]["failed"]}
    assert "OutOfMemoryError" in recs[0]["failed"]
    assert [r["layers"] for r in recs[1:3]] == trained
    assert recs[3]["note"].startswith("EXTRAPOLATED")


def _root_chaos_train():
    spec = importlib.util.spec_from_file_location(
        "root_chaos_train", os.path.join(ROOT, "tools", "chaos_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STRUCTURAL = ("completed", "final_iteration", "consumed_samples",
              "faults_fired", "saves", "quarantine_windows",
              "exact_resume_state_saved", "corrupt_fallback_iteration",
              "data_faults_detected", "valid_checkpoints", "metric", "unit")


def test_chaos_train_smoke_matches_the_root_tool(tmp_path, capsys):
    assert chaos_train.main(["--smoke"], device="cpu") == 0
    got, = _records(capsys)
    spec = "write_error@2,nan@3,nan@4"
    want = _root_chaos_train().run_chaos(8, 32, spec, str(tmp_path))
    assert set(want) <= set(got)
    for key in STRUCTURAL:
        assert got[key] == want[key], key
    assert got["completed"] and got["value"] is not None
    assert got["quarantine_windows"][0]["rollback"] == 1
