"""The port's tools/chaos_fleet.py: a fleet of real replica processes
(`python -m megatron_tpu_torch.tools.chaos_fleet --serve_replica`, the
replica-mode MegatronServer on the CPU) behind the router over
`RemoteReplica` clients, under the reference's seeded drills.

- sigkill (the reference's `--smoke`): a replica SIGKILLed mid-decode;
  nothing strands, every completion equals the serial oracle of the same
  weights in this process, the router degrades (not down), the respawn is
  re-admitted through the canary, the fleet's invariant sweep is green.
- flaky_proxy: one replica behind the seeded fault shim; every fault typed,
  every completion exact.
- sigstop and restart, marked slow as the reference marks its fleet drill
  (tests/test_resilience.py `test_chaos_fleet_smoke`).
- The child mode's refusals: no port, no GPU without `--device`.

Each drill's processes are stopped by the tool itself; the tests bound
every wait (the tool's own timeouts and the subprocess timeout).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from megatron_tpu_torch.tools import chaos_fleet
from megatron_tpu_torch.tools.chaos_common import REPO_ROOT, free_port

torch.set_num_threads(2)


def _run(drills, seed=0, requests=6):
    return chaos_fleet.run_chaos(seed, 2, 12, requests, drills, "cpu")


def _common(record, name):
    assert record["tool"] == "chaos_fleet" and "repro" in record
    d = record["drills"][name]
    assert d["ok"], d
    assert d["outcomes"]["stranded"] == 0 and d["outcomes"]["error"] == 0
    assert d["exact"] is True
    assert d["invariants_ok"] is True, d["violations"]
    assert record["fleet_counters"]["fleet_replicas_up"] == 2.0
    return d


def test_sigkill_drill():
    record = _run(["sigkill"])
    assert record["completed"] is True
    d = _common(record, "sigkill")
    assert d["state_after_kill"] == "degraded"
    assert d["degraded_not_down"] and d["post_ok"] and d["readmitted"]
    # the failover was remote: the dead process missed its probes
    assert record["fleet_counters"]["router_failovers"] >= 1
    assert record["fleet_counters"]["router_probe_failures"] >= 1


def test_flaky_proxy_drill():
    record = _run(["flaky_proxy"], seed=3, requests=8)
    assert record["completed"] is True
    d = _common(record, "flaky_proxy")
    assert d["typed_only"] is True
    faults = d["proxy_faults"]
    assert sum(faults.values()) > 0
    assert faults["cut"] + faults["refuse"] >= 1


@pytest.mark.slow
def test_sigstop_and_restart_drills():
    record = _run(["sigstop", "restart"], seed=7, requests=8)
    assert record["completed"] is True, json.dumps(record)
    stop = _common(record, "sigstop")
    assert stop["degraded_not_down"] and stop["readmitted"]
    restart = _common(record, "restart")
    assert restart["readmitted"]


def test_cli_record_and_child_refusals(tmp_path):
    out = tmp_path / "rec.json"
    assert chaos_fleet.main(["--smoke", "--out", str(out)],
                            device="cpu") == 0
    assert json.loads(out.read_text())["completed"] is True
    with pytest.raises(SystemExit):
        chaos_fleet.main(["--serve_replica"])
    # a replica without --device on a machine with no GPU raises: no quiet
    # fallback to the CPU
    run = subprocess.run(
        [sys.executable, "-m", "megatron_tpu_torch.tools.chaos_fleet",
         "--serve_replica", "--port", str(free_port())],
        cwd=str(REPO_ROOT), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(REPO_ROOT)))
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr
