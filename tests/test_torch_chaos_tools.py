"""The port's chaos and structured-output tools at their --smoke sizes,
in-process on the CPU: each exits 0 with every drill or arm holding and
every invariant sweep (serving/invariants.py) clean.

- tools/chaos_serve.py: overload with a NaN slot, a wedged iteration, a
  crash loop that opens the breaker (speculative engine, block kernel,
  two adapters).
- tools/chaos_storm.py: three seeded storms (plain, speculative, adapter
  skew) at 0.5x/1x/2x of the calibrated rate, judged by laws 8-11, and
  the injected SLO regression that the SLO law must catch.
- tools/chaos_upgrade.py: drills 1-2 (the draining replica killed
  mid-rollout; a corrupt publish mid-watch); drill 3 raises, naming the
  serving topology it needs.
- tools/bench_structured.py: constrained against free and n=1 x 4 against
  n=4, every constrained completion legal and parsed, every sample equal
  to its twin.
"""
import json

import pytest
import torch

torch.set_num_threads(2)


def _record(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_chaos_serve_smoke(capsys):
    from megatron_tpu_torch.tools import chaos_serve
    rc = chaos_serve.main(["--smoke"], device="cpu")
    rec = _record(capsys)
    assert rc == 0 and rec["completed"], rec
    for drill in ("overload", "hang", "crash_loop"):
        assert rec[drill]["ok"] and rec[drill]["invariants_ok"], drill
    assert rec["overload"]["preemptions"] >= 1
    assert rec["overload"]["spec_rounds"] >= 1
    assert rec["crash_loop"]["breaker_open"]


def test_chaos_storm_smoke(capsys):
    from megatron_tpu_torch.tools import chaos_storm
    rc = chaos_storm.main(["--smoke"], device="cpu")
    rec = _record(capsys)
    runs = rec["runs"]
    assert rc == 0 and rec["completed"], [
        (r["repro"], r["violations"], r["degrade_peak"])
        for r in runs if not r["ok"]]
    assert len(runs) == 4 and all(r["ok"] for r in runs)
    for r in runs[:3]:
        assert r["degrade_peak"] >= 1 and r["degrade_final"] == 0
        assert r["counters"]["degrade_transitions"] % 2 == 0
        shed = [a["shed_frac"] for a in r["arms"]]
        assert shed[-1] >= shed[0] - chaos_storm.SHED_TOLERANCE
    assert runs[3]["injected_caught"]


def test_chaos_upgrade_smoke(capsys):
    from megatron_tpu_torch.tools import chaos_upgrade
    rc = chaos_upgrade.main(["--smoke"], device="cpu")
    rec = _record(capsys)
    assert rc == 0 and rec["completed"], rec
    assert rec["kill_draining"]["rollout_aborted_typed"]
    assert rec["kill_draining"]["health_state"] == "degraded"
    assert rec["corrupt_watch"]["no_retry_loop"]
    assert rec["kill_draining"]["invariants_ok"]
    assert rec["corrupt_watch"]["invariants_ok"]
    with pytest.raises(NotImplementedError, match="item 7"):
        chaos_upgrade.disagg_race_drill(8)


def test_bench_structured_smoke(capsys):
    from megatron_tpu_torch.tools import bench_structured
    rc = bench_structured.main(["--smoke"], device="cpu")
    rec = _record(capsys)
    assert rc == 0 and rec["ok"], rec
    arm = rec["constrained_vs_free"]
    assert arm["free"]["mask_uploads"] == 0
    for g in ("regex", "json_schema"):
        assert arm[g]["outputs_legal"] and arm[g]["outputs_parse"]
        assert arm[g]["mask_uploads"] > 0
    for text in arm["json_schema"]["completions"]:
        json.loads(text)
    fan = rec["n1_vs_n4"]
    assert fan["samples_token_exact"]
    assert fan["fanout"]["fanout_samples"] == 4
    assert fan["fanout"]["prefill_tokens_saved"] > 0
