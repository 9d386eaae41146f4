"""The port's ported benchmark tools at `--smoke --device cpu`: both exit 0,
print every arm, label the kernel arms `plain` (on the CPU the wrappers take
their plain versions), and print no FAILED line. An arm that fails makes
bench_kernels exit 1."""
import pytest
import torch

from megatron_tpu_torch.tools import bench_decode, bench_kernels

torch.set_num_threads(2)


def test_bench_kernels_smoke_on_cpu(capsys):
    assert bench_kernels.main(["--smoke", "--device", "cpu",
                               "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    arms = [ln for ln in out.splitlines() if "|" in ln]
    assert [ln.split(" [")[0] for ln in arms] == [
        "rms fwd", "ln  fwd", "rms vjp", "ln  vjp", "gemm", "flash fwd"]
    for ln in arms:
        if not ln.startswith("gemm"):
            assert "| plain " in ln or ": plain " in ln, ln
    assert out.rstrip().endswith("done")


def test_bench_kernels_exits_1_on_a_failed_arm(capsys, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("injected")
    monkeypatch.setattr(bench_kernels, "int8_matmul", broken)
    assert bench_kernels.main(["--smoke", "--device", "cpu",
                               "--iters", "1"]) == 1
    out = capsys.readouterr().out
    assert "gemm [64x128x256] FAILED: RuntimeError: injected" in out


def test_bench_decode_smoke_on_cpu(capsys):
    assert bench_decode.main(["--smoke", "--device", "cpu", "--int8_weights",
                              "--int8_kv"]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out and "roofline" not in out
    labels = [ln.split("(")[0] for ln in out.splitlines()
              if "new-tok/s" in ln]
    assert labels == ["generate", "int8kv generate", "int8 generate",
                      "int8w+kv generate"]
    # a window below the cache length runs every arm on rolling caches
    assert bench_decode.main(["--smoke", "--device", "cpu", "--int8_kv",
                              "--sliding_window", "8"]) == 0
    out = capsys.readouterr().out
    assert "sliding_window=8 (rolling cache)" in out and "FAILED" not in out
    assert [ln.split("(")[0] for ln in out.splitlines()
            if "new-tok/s" in ln] == ["generate", "int8kv generate"]
