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


# The engine bench tools (bench_block_attn, bench_spec, bench_prefix,
# bench_sync): each runs at --smoke --device cpu, exits 0 and prints one
# JSON record whose keys are the root tool's (tools/bench_*.py) at every
# level, with the assertions tests/test_bench_tools.py makes of the root
# tools' records; each tool asserts its own arms' agreement.
BLOCK_ARM = {"attn_path", "tokens_generated", "decode_steps",
             "kv_gather_bytes_per_step", "kv_attn_path", "tok_s", "wall_s"}
SPEC_ARM = {"speculative_k", "tokens_generated", "spec_rounds",
            "spec_fallback_steps", "draft_tokens", "accepted_tokens",
            "acceptance_rate", "tokens_per_round", "accepted_tok_s",
            "wall_s"}
PREFIX_ARM = {"enable_prefix_cache", "prefill_chunk", "prefix_hits",
              "hit_rate", "prefix_hit_tokens", "prefill_tokens_saved",
              "prefill_forward_tokens", "prefill_chunks", "ttft_p50_ms",
              "ttft_p95_ms", "tokens_per_s"}
MULTITURN_ARM = {"kv_block_size", "pool_bytes", "retained_after_turn1",
                 "turn2_hits", "turn2_session_hits", "turn2_session_hit_rate",
                 "turn2_hit_tokens", "prefill_tokens_saved",
                 "prefill_forward_tokens", "kv_blocks_retained",
                 "kv_bytes_wasted", "tokens_per_s"}
SYNC_TRAIN = {"host_syncs", "host_syncs_per_step", "ms_per_step"}
SYNC_SERVE = {"decode_sync_interval", "tokens", "decode_steps", "host_syncs",
              "syncs_per_step", "syncs_per_token", "wasted_decode_steps",
              "prompts_per_prefill", "tokens_per_s"}


def _record(capsys, tool, *argv):
    import importlib
    import json
    mod = importlib.import_module(f"megatron_tpu_torch.tools.{tool}")
    assert mod.main(["--smoke", "--device", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("dtypes", [None, "bfloat16,int8"])
def test_bench_block_attn_record(capsys, dtypes):
    rec = _record(capsys, "bench_block_attn",
                  *(["--dtypes", dtypes] if dtypes else []))
    assert set(rec) == {"bench", "device", "requests", "new_tokens",
                        "max_len", "greedy_arms_token_exact", "combos",
                        "best_speedup_x", "note"}
    assert rec["bench"] == "block_native_attn" and rec["device"] == "cpu"
    assert rec["greedy_arms_token_exact"] is True
    assert [c["kv_dtype"] for c in rec["combos"]] == (
        dtypes or "bfloat16").split(",")
    for combo in rec["combos"]:
        assert set(combo) == {"kv_block_size", "kv_dtype", "bracket",
                              "kernel", "speedup_x",
                              "bracket_overhead_bytes_per_step"}
        assert set(combo["bracket"]) == set(combo["kernel"]) == BLOCK_ARM
        assert combo["bracket"]["kv_gather_bytes_per_step"] > 0
        assert combo["kernel"]["kv_gather_bytes_per_step"] == 0
        assert combo["bracket"]["kv_attn_path"] == 1
        assert combo["kernel"]["kv_attn_path"] == 2
        assert combo["kernel"]["tokens_generated"] == \
            combo["bracket"]["tokens_generated"] > 0


@pytest.mark.parametrize("block", [None, "16"])
def test_bench_spec_record(capsys, block):
    rec = _record(capsys, "bench_spec", *(["--block", block] if block
                                          else []))
    assert set(rec) == {"bench", "device", "requests", "new_tokens",
                        "greedy_arms_token_exact", "baseline", "arms",
                        "best_speedup_x", "best_acceptance_rate",
                        "roofline"}
    assert rec["bench"] == "speculative_decode"
    assert rec["greedy_arms_token_exact"] is True
    assert set(rec["baseline"]) == SPEC_ARM
    assert rec["baseline"]["speculative_k"] == 0
    assert rec["baseline"]["draft_tokens"] == 0
    assert [a["speculative_k"] for a in rec["arms"]] == [2, 4]
    for arm in rec["arms"]:
        assert set(arm) == SPEC_ARM | {"speedup_x"}
        assert arm["tokens_generated"] == \
            rec["baseline"]["tokens_generated"]
        assert arm["spec_rounds"] >= 1 and arm["draft_tokens"] >= 1
        assert arm["tokens_per_round"] == pytest.approx(
            1 + arm["speculative_k"] * arm["acceptance_rate"], abs=0.02)
    assert rec["best_acceptance_rate"] > 0.0
    assert set(rec["roofline"]) == {"step_bytes", "ideal_tok_s", "note"}
    assert rec["roofline"]["step_bytes"] > 0
    assert rec["roofline"]["ideal_tok_s"] is None  # no card, no rate


def test_bench_prefix_record(capsys):
    rec = _record(capsys, "bench_prefix", "--block_native_attn")
    assert set(rec) == {"bench", "device", "requests", "shared", "unique",
                        "baseline", "prefix", "prefix_chunked",
                        "forward_token_reduction_x",
                        "multiturn_whole_region", "multiturn_blocks",
                        "retained_capacity_x"}
    assert rec["bench"] == "prefix_cache"
    base, pref, chnk = (rec["baseline"], rec["prefix"],
                        rec["prefix_chunked"])
    assert set(base) == set(pref) == set(chnk) == PREFIX_ARM
    whole, blocks = rec["multiturn_whole_region"], rec["multiturn_blocks"]
    assert set(whole) == set(blocks) == MULTITURN_ARM
    # whole-region retention is bounded by the 3 slots and thrashes on 5
    # serial sessions; block retention keeps every session
    assert whole["retained_after_turn1"] <= 3
    assert blocks["retained_after_turn1"] == 5
    assert blocks["turn2_session_hit_rate"] == 1.0
    assert rec["retained_capacity_x"] >= 2.0
    assert blocks["kv_bytes_wasted"] < whole["kv_bytes_wasted"]
    assert base["prefix_hits"] == 0 and base["prefill_tokens_saved"] == 0
    assert pref["prefix_hits"] >= 1 and pref["prefill_tokens_saved"] >= 32
    assert pref["prefill_forward_tokens"] < base["prefill_forward_tokens"]
    assert rec["forward_token_reduction_x"] > 1.0
    assert chnk["prefill_chunks"] > pref["prefill_chunks"]
    assert chnk["prefill_tokens_saved"] >= 32


def test_bench_sync_record(capsys):
    rec = _record(capsys, "bench_sync")
    assert set(rec) == {"bench", "device", "training", "serving"}
    tr, sv = rec["training"], rec["serving"]
    assert set(tr) == {"sync", "async", "sync_reduction_x"}
    assert set(tr["sync"]) == set(tr["async"]) == SYNC_TRAIN
    assert tr["sync"]["host_syncs"] == 9          # one fetch a step
    assert tr["async"]["host_syncs"] <= 4         # one a window (+ the 1st)
    assert tr["sync_reduction_x"] >= 2
    assert set(sv) == {"k1", "k", "sync_reduction_x"}
    assert set(sv["k1"]) == set(sv["k"]) == SYNC_SERVE
    assert sv["k1"]["syncs_per_step"] == 1.0
    assert sv["k"]["syncs_per_step"] == pytest.approx(1 / 3, abs=1e-3)
    assert sv["k"]["tokens"] == sv["k1"]["tokens"]
