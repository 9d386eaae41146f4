"""Chaos drills across processes (the root tools/chaos_fleet.py): a fleet of
replica server processes behind the remote router, under seeded fault
schedules. Nothing strands and no token moves.

`tools/chaos_router.py` drills the router over engines of one process;
this tool crosses the process boundary. Each replica is `python -m
megatron_tpu_torch.tools.chaos_fleet --serve_replica`, a `MegatronServer`
with `replica_mode` on its own port (stdlib HTTP), and the parent drives an
`EngineRouter` over `RemoteReplica` clients, so every fault goes through
the wire path: SSE streams, typed transport faults, the Last-Event-ID
resume, health probes over TCP. Four seeded drills:

1. sigkill: one replica process is SIGKILLed mid-decode. No future
   strands, every completed request equals the parent's serial oracle
   (failover resubmits by seed), the router reports degraded (not down)
   and keeps accepting; a respawn on the same port is re-admitted through
   the half-open canary, and the fleet ends at full strength.
2. sigstop: one replica is SIGSTOPped (TCP still connects, nothing
   answers). Health probes time out, missed heartbeats eject it, its
   streams fail over token for token, and after SIGCONT the canary
   re-admits it.
3. flaky_proxy: one replica is reached only through `FlakyProxy`, a seeded
   fault shim (refuse, cut after N bytes, or delay each connection). Every
   injected fault lands as a typed transport error inside the retry,
   reconnect and failover machinery; outcomes stay exact.
4. restart: a replica is SIGKILLed and respawned while traffic flows;
   what was submitted across the window resolves exactly and the fleet
   returns to full strength.

Every drill ends with `invariants.check_all` over the fleet: each replica
process sweeps itself (`GET /invariants`) and the router-level laws run
here; a replica dead at sweep time is listed unreachable, not convicted.

One JSON record goes to stdout (and `--out`) with the seed and a repro
line. `--device` names the device of the replicas and of the parent's
oracle (the card unless given):

  python -m megatron_tpu_torch.tools.chaos_fleet --smoke --device cpu
  python -m megatron_tpu_torch.tools.chaos_fleet --seed 7 --replicas 3

`--serve_replica` is the child mode. Beside the drills' tiny model it
serves Llama-2-7B's width (`--model llama2-7b --layers N --dtype ...`,
random weights from `--seed`) with any `--serving` fields, and on SIGTERM
it drains, stops and writes its kernel launch counts (on the card also its
peak reserved device bytes) to `--counts_out`.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import signal
import socket
import sys
import threading
import time

from megatron_tpu_torch.tools.chaos_common import (IntTokenizer,
                                                   emit_record, free_port,
                                                   invariant_sweep,
                                                   resolve_exact,
                                                   serial_oracle,
                                                   spawn_replica,
                                                   tiny_generator,
                                                   tiny_model_cfg,
                                                   wait_replica_ready)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

# the replicas and the parent's oracle build the same tiny model (seed,
# dtype): that is what makes exactness across processes a real check
REPLICA_SERVING = dict(num_slots=4, max_queue=64, enable_prefix_cache=True,
                       kv_block_size=16)


# ---------------------------------------------------------------------
# the replica child
# ---------------------------------------------------------------------
def replica_generator(model: str = "tiny", layers: int = 0,
                      dtype: str = "bfloat16", seed: int = 0,
                      device: DeviceLike = None):
    """The Generator a replica serves: the drills' tiny model, or
    Llama-2-7B's width at `layers` of its 32 (0: all) in `dtype` (float32
    computes in fp32 with fp32 caches and TF32 off), random weights from
    `seed`. Its eos (-1) is never sampled, so a request runs its
    max_new_tokens."""
    import torch
    device = resolve_device(device)
    if model == "tiny":
        return tiny_generator(tiny_model_cfg(), device, seed=seed)
    if model != "llama2-7b":
        raise ValueError(f"unknown replica model {model!r}")
    from megatron_tpu_torch.config import llama2_config
    from megatron_tpu_torch.inference.generation import Generator
    from megatron_tpu_torch.models.language_model import LanguageModel
    fields = {"num_layers": layers} if layers else {}
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = llama2_config("7b", compute_dtype="float32", **fields)
        lm = LanguageModel(cfg, device=device, dtype=torch.float32,
                           seed=seed)
        return Generator(lm, cfg, eos_id=-1, pad_id=0, device=device,
                         kv_cache_dtype=torch.float32)
    cfg = llama2_config("7b", **fields)
    lm = LanguageModel(cfg, device=device, dtype=torch.bfloat16, seed=seed)
    return Generator(lm, cfg, eos_id=-1, pad_id=0, device=device)


def launch_counts() -> dict:
    """This process's launch count of every kernel wrapper."""
    from megatron_tpu_torch.ops import block_attention_cuda as bac
    from megatron_tpu_torch.ops import flash_attention_cuda as fc
    from megatron_tpu_torch.ops import fused_norms_cuda as fnc
    return dict(fc.launch_counts(),
                block_attention_cuda=bac.block_attention_cuda.launches,
                **fnc.launch_counts())


def serve_replica(port: int, device: DeviceLike = None, model: str = "tiny",
                  layers: int = 0, dtype: str = "bfloat16", seed: int = 0,
                  serving: dict = None, counts_out: str = None) -> int:
    """`--serve_replica`: one engine as a `replica_mode` server process on
    127.0.0.1:port until SIGTERM (drain, stop, then the launch counts to
    `counts_out`) or SIGKILL. The parent talks to it only over HTTP."""
    from megatron_tpu_torch.config import ServingConfig
    from megatron_tpu_torch.inference.server import MegatronServer
    device = resolve_device(device)
    gen = replica_generator(model, layers, dtype, seed, device)
    fields = dict(REPLICA_SERVING if serving is None else serving)
    config = ServingConfig(replica_mode=True, **fields).validate(gen.cfg)
    server = MegatronServer(gen, IntTokenizer(), serving=config,
                            device=device)
    httpd = server.make_http_server("127.0.0.1", port)

    def on_sigterm(signum, frame):
        # shutdown() waits for serve_forever, which runs on this thread
        threading.Thread(target=lambda: (server.engine.drain(60.0),
                                         httpd.shutdown()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, on_sigterm)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()
    if counts_out:
        counts = launch_counts()
        if device.type == "cuda":
            import torch
            counts["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        with open(counts_out, "w") as f:
            json.dump(counts, f)
    return 0


# ---------------------------------------------------------------------
# the parent's fleet
# ---------------------------------------------------------------------
class Fleet:
    """N replica processes and the remote router over them, with the
    process handles the drills kill and stop."""

    def __init__(self, n: int, heartbeat_s: float = 2.0,
                 replica_args=(), ready_timeout: float = 120.0):
        from megatron_tpu_torch.serving import EngineRouter
        from megatron_tpu_torch.serving.metrics import ServingMetrics
        from megatron_tpu_torch.serving.remote import RemoteReplica
        self.replica_args = list(replica_args)
        self.ready_timeout = ready_timeout
        self.ports = [free_port() for _ in range(n)]
        self.procs = [spawn_replica(p, self.replica_args)
                      for p in self.ports]
        try:
            for port, proc in zip(self.ports, self.procs):
                wait_replica_ready(f"127.0.0.1:{port}", ready_timeout, proc)
        except BaseException:
            self.kill_all()
            raise
        self.counters = ServingMetrics()
        self.replicas = [
            RemoteReplica(f"127.0.0.1:{port}", counters=self.counters,
                          connect_timeout_s=2.0, read_timeout_s=5.0,
                          max_retries=2, digest_interval_s=0.5)
            for port in self.ports]
        self.router = EngineRouter(self.replicas, metrics=self.counters,
                                   max_retries=2,
                                   heartbeat_timeout_s=heartbeat_s,
                                   probe_backoff_s=0.2)

    def respawn(self, i: int) -> None:
        self.procs[i] = spawn_replica(self.ports[i], self.replica_args)
        wait_replica_ready(f"127.0.0.1:{self.ports[i]}", self.ready_timeout,
                           self.procs[i])

    def kill_all(self) -> None:
        for p in self.procs:
            try:
                if p.poll() is None:
                    os.kill(p.pid, signal.SIGCONT)  # a stopped one too
                    p.kill()
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def close(self) -> None:
        try:
            self.router.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        self.kill_all()


def _sampling():
    from megatron_tpu_torch.serving import SamplingOptions
    return SamplingOptions(temperature=0.0)


def submit_batch(router, rng: random.Random, n_reqs: int, new_tokens: int,
                 seed0: int = 0):
    """n_reqs greedy requests over seeded random 4-token prompts (ids
    1..127; 0 is the pad). Greedy keeps the oracle seed-independent; the
    distinct seeds still ride the failover resubmissions."""
    sampling = _sampling()
    reqs = []
    for i in range(n_reqs):
        p = [rng.randint(1, 127) for _ in range(4)]
        reqs.append((router.submit(p, new_tokens, sampling, seed=seed0 + i),
                     p, new_tokens))
    return reqs


def wait_readmitted(fleet: Fleet, timeout: float = 90.0):
    """Drive the half-open re-admission: DOWN -> PROBING needs a probe
    window and a request, so poll the router's health and feed it small
    canary requests until every replica is back in rotation. Returns
    (readmitted, canary requests); the canaries join the drill's resolve
    and sweep, so none can strand unseen."""
    sampling = _sampling()
    deadline = time.monotonic() + timeout
    canaries = []
    while time.monotonic() < deadline:
        if fleet.router.health().get("replicas_up", 0) \
                >= len(fleet.replicas):
            return True, canaries
        r = fleet.router.submit([3, 1, 4, 1], 2, sampling, seed=0)
        try:
            r.result(timeout=30)
        except Exception:  # noqa: BLE001 — classified in the resolve
            pass
        canaries.append((r, [3, 1, 4, 1], 2))
        time.sleep(0.25)
    return False, canaries


def _drill_wrap(fleet: Fleet, want, name: str, body: dict, reqs) -> dict:
    """The drills' tail: resolve every future against the oracle, then
    the fleet's invariant sweep over HTTP."""
    outcomes, exact = resolve_exact(reqs, want)
    inv = invariant_sweep(fleet.router, [r for r, _, _ in reqs],
                          strict=True)
    body.update({
        "drill": name, "outcomes": outcomes, "exact": exact,
        "stranded": outcomes["stranded"],
        "invariants_ok": bool(inv.get("ok")),
        "violations": [str(v) for v in inv.get("violations", [])],
    })
    body["ok"] = (exact and outcomes["stranded"] == 0
                  and body["invariants_ok"]
                  and all(body.get(k, True) for k in
                          ("degraded_not_down", "post_ok", "readmitted",
                           "typed_only")))
    return body


# ---------------------------------------------------------------------
# drills
# ---------------------------------------------------------------------
def drill_sigkill(fleet: Fleet, want, rng: random.Random, new_tokens: int,
                  n_reqs: int) -> dict:
    victim = rng.randrange(len(fleet.procs))
    reqs = submit_batch(fleet.router, rng, n_reqs, new_tokens)
    time.sleep(0.2)  # decode has started: the kill lands mid-stream
    fleet.procs[victim].kill()
    fleet.procs[victim].wait()
    # the front door still serves after losing a process
    post = fleet.router.submit([9, 9, 8, 7], 4, _sampling(), seed=99)
    post_toks, _ = post.result(timeout=60)
    health = fleet.router.health()
    # back to full strength: the same port, a new process
    fleet.respawn(victim)
    readmitted, canaries = wait_readmitted(fleet)
    return _drill_wrap(fleet, want, "sigkill", {
        "victim": victim,
        "post_ok": post_toks == want([9, 9, 8, 7], 4),
        "degraded_not_down": health["accepting"],
        "state_after_kill": health["state"],
        "readmitted": readmitted,
    }, reqs + [(post, [9, 9, 8, 7], 4)] + canaries)


def drill_sigstop(fleet: Fleet, want, rng: random.Random, new_tokens: int,
                  n_reqs: int) -> dict:
    victim = rng.randrange(len(fleet.procs))
    reqs = submit_batch(fleet.router, rng, n_reqs, new_tokens)
    time.sleep(0.2)
    os.kill(fleet.procs[victim].pid, signal.SIGSTOP)
    try:
        # more traffic into the wedge: probes time out, heartbeats lapse,
        # the stopped replica is ejected and this work fails over
        reqs += submit_batch(fleet.router, rng, n_reqs, new_tokens,
                             seed0=100)
        time.sleep(0.5)
        health = fleet.router.health()
    finally:
        os.kill(fleet.procs[victim].pid, signal.SIGCONT)
    readmitted, canaries = wait_readmitted(fleet)
    return _drill_wrap(fleet, want, "sigstop", {
        "victim": victim,
        "degraded_not_down": health["accepting"],
        "readmitted": readmitted,
    }, reqs + canaries)


class FlakyProxy(threading.Thread):
    """A seeded fault shim in front of one replica: each accepted
    connection draws a verdict from the seeded generator, in accept order
    on this one thread: refuse (close before a byte), cut (truncate the
    replica's bytes after a seeded budget: a reset mid-body or a truncated
    SSE stream), delay (latency on every chunk) or clean. The client sees
    the fault taxonomy serving/remote.py types."""

    def __init__(self, upstream_port: int, seed: int,
                 refuse_p: float = 0.15, cut_p: float = 0.15,
                 delay_s: float = 0.03):
        super().__init__(daemon=True, name="flaky-proxy")
        self.upstream_port = upstream_port
        self.port = free_port()
        self._rng = random.Random(seed)
        self.refuse_p, self.cut_p, self.delay_s = refuse_p, cut_p, delay_s
        self.faults = {"refuse": 0, "cut": 0, "delay": 0, "clean": 0}
        self._listen = socket.socket()
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(("127.0.0.1", self.port))
        self._listen.listen(64)
        self._stop = threading.Event()

    def run(self):
        while not self._stop.is_set():
            try:
                client, _ = self._listen.accept()
            except OSError:
                return
            r = self._rng.random()
            budget = self._rng.randint(64, 600)
            verdict = ("refuse" if r < self.refuse_p
                       else "cut" if r < self.refuse_p + self.cut_p
                       else "delay" if r < self.refuse_p + self.cut_p + 0.25
                       else "clean")
            self.faults[verdict] += 1
            threading.Thread(target=self._handle, daemon=True,
                             args=(client, verdict, budget)).start()

    def _handle(self, client, verdict: str, budget: int):
        try:
            if verdict == "refuse":
                client.close()
                return
            up = socket.create_connection(
                ("127.0.0.1", self.upstream_port), timeout=5.0)
        except OSError:
            client.close()
            return

        def pump(src, dst, limit=None, delay=0.0):
            moved = 0
            try:
                while True:
                    data = src.recv(4096)
                    if not data:
                        break
                    if limit is not None and moved + len(data) > limit:
                        data = data[:max(0, limit - moved)]
                        if data:
                            dst.sendall(data)
                        break  # truncated: a reset mid-body
                    if delay:
                        time.sleep(delay)
                    dst.sendall(data)
                    moved += len(data)
            except OSError:
                pass
            finally:
                for sock in (src, dst):
                    try:
                        sock.close()
                    except OSError:
                        pass

        threading.Thread(target=pump, args=(client, up), daemon=True).start()
        pump(up, client, limit=budget if verdict == "cut" else None,
             delay=self.delay_s if verdict == "delay" else 0.0)

    def close(self):
        self._stop.set()
        try:
            self._listen.close()
        except OSError:
            pass


def drill_flaky_proxy(fleet: Fleet, want, rng: random.Random,
                      new_tokens: int, n_reqs: int, seed: int) -> dict:
    """A second router whose first replica is reached only through the
    fault shim (the other directly); the replica processes serve both
    routers at once, which is load of its own."""
    from megatron_tpu_torch.serving import (EngineRouter,
                                            ServiceUnavailableError)
    from megatron_tpu_torch.serving.metrics import ServingMetrics
    from megatron_tpu_torch.serving.remote import RemoteReplica
    proxy = FlakyProxy(fleet.ports[0], seed=seed)
    proxy.start()
    counters = ServingMetrics()
    replicas = [RemoteReplica(addr, counters=counters, connect_timeout_s=2.0,
                              read_timeout_s=5.0, max_retries=2,
                              digest_interval_s=0.5)
                for addr in (f"127.0.0.1:{proxy.port}",
                             f"127.0.0.1:{fleet.ports[-1]}")]
    router = EngineRouter(replicas, metrics=counters, max_retries=2,
                          heartbeat_timeout_s=2.0, probe_backoff_s=0.2)
    typed_only = True
    reqs = []
    try:
        sampling = _sampling()
        for i in range(n_reqs):
            p = [rng.randint(1, 127) for _ in range(4)]
            try:
                reqs.append((router.submit(p, new_tokens, sampling, seed=i),
                             p, new_tokens))
            except ServiceUnavailableError:
                pass  # a typed refusal at submit: acceptable
            except Exception:  # noqa: BLE001 — what the drill looks for
                typed_only = False
        outcomes, exact = resolve_exact(reqs, want)
        snap = router.aggregate_snapshot()
        inv = invariant_sweep(router, [r for r, _, _ in reqs], strict=True)
    finally:
        router.close()
        proxy.close()
    body = {
        "drill": "flaky_proxy", "outcomes": outcomes, "exact": exact,
        "stranded": outcomes["stranded"], "typed_only": typed_only,
        "proxy_faults": proxy.faults,
        "remote_retries": snap.get("router_remote_retries", 0.0),
        "remote_timeouts": snap.get("router_remote_timeouts", 0.0),
        "invariants_ok": bool(inv.get("ok")),
        "violations": [str(v) for v in inv.get("violations", [])],
    }
    body["ok"] = (exact and outcomes["stranded"] == 0 and typed_only
                  and body["invariants_ok"])
    return body


def drill_restart(fleet: Fleet, want, rng: random.Random, new_tokens: int,
                  n_reqs: int) -> dict:
    """The kill and the respawn both land while traffic is in flight."""
    victim = rng.randrange(len(fleet.procs))
    reqs = submit_batch(fleet.router, rng, n_reqs, new_tokens)
    time.sleep(0.15)
    fleet.procs[victim].kill()
    fleet.procs[victim].wait()
    # traffic goes on while the process is gone...
    reqs += submit_batch(fleet.router, rng, n_reqs, new_tokens, seed0=200)
    # ...and while it comes back
    fleet.respawn(victim)
    reqs += submit_batch(fleet.router, rng, n_reqs, new_tokens, seed0=300)
    readmitted, canaries = wait_readmitted(fleet)
    return _drill_wrap(fleet, want, "restart", {
        "victim": victim, "readmitted": readmitted,
    }, reqs + canaries)


# ---------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------
DRILLS = ("sigkill", "sigstop", "flaky_proxy", "restart")


def run_chaos(seed: int, n_replicas: int, new_tokens: int, n_reqs: int,
              drills, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    rng = random.Random(seed)
    fleet = Fleet(n_replicas, replica_args=["--device", str(device)])
    want = serial_oracle(tiny_generator(tiny_model_cfg(), device))
    results = {}
    fns = {"sigkill": drill_sigkill, "sigstop": drill_sigstop,
           "restart": drill_restart}
    try:
        for name in drills:
            try:
                if name == "flaky_proxy":
                    results[name] = drill_flaky_proxy(
                        fleet, want, rng, new_tokens, n_reqs, seed)
                elif name in fns:
                    results[name] = fns[name](fleet, want, rng, new_tokens,
                                              n_reqs)
                else:
                    raise SystemExit(f"unknown drill {name!r}")
            except SystemExit:
                raise
            except Exception as e:  # noqa: BLE001 — a crashed drill is a
                # violation with a record and its repro line
                results[name] = {"drill": name, "ok": False,
                                 "invariants_ok": False,
                                 "crash": f"{type(e).__name__}: {e}"}
        snap = fleet.router.aggregate_snapshot()
    finally:
        fleet.close()
    return {
        "tool": "chaos_fleet",
        "completed": all(r.get("ok") for r in results.values()),
        "replicas": n_replicas, "new_tokens": new_tokens,
        "drills": results,
        "invariants_ok": all(r.get("invariants_ok")
                             for r in results.values()),
        "fleet_counters": {
            k: snap.get(k, 0.0)
            for k in ("router_failovers", "router_retries",
                      "router_remote_timeouts", "router_remote_retries",
                      "router_probe_failures", "fleet_replicas_up")},
        "repro": (f"python -m megatron_tpu_torch.tools.chaos_fleet --seed "
                  f"{seed} --replicas {n_replicas} --new_tokens "
                  f"{new_tokens} --requests {n_reqs} --drills "
                  f"{','.join(drills)} --device {device.type}"),
    }


def main(argv=None, *, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve_replica", action="store_true",
                    help="child mode: run one replica server process")
    ap.add_argument("--port", type=int, default=0,
                    help="child mode: the port to serve on")
    ap.add_argument("--model", default="tiny", choices=("tiny", "llama2-7b"),
                    help="child mode: the model served")
    ap.add_argument("--layers", type=int, default=0,
                    help="child mode, llama2-7b: layers of 32 (0: all)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="child mode, llama2-7b: weights and compute")
    ap.add_argument("--serving", default=None,
                    help="child mode: ServingConfig fields as a JSON object "
                         "(default: the drills' 4-slot prefix-cache pool)")
    ap.add_argument("--counts_out", default=None,
                    help="child mode: write the kernel launch counts here "
                         "after a SIGTERM shutdown")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault schedule seed (child mode: weight seed)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--new_tokens", type=int, default=12)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests a drill batch")
    ap.add_argument("--drills", default=",".join(DRILLS),
                    help="comma list from: " + ",".join(DRILLS))
    ap.add_argument("--smoke", action="store_true",
                    help="2 replicas, the sigkill drill only")
    ap.add_argument("--device", default=None,
                    help="replicas' and oracle's device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    device = args.device if args.device is not None else device
    if args.serve_replica:
        if not args.port:
            ap.error("--serve_replica requires --port")
        return serve_replica(
            args.port, device, args.model, args.layers, args.dtype,
            args.seed, None if args.serving is None
            else json.loads(args.serving), args.counts_out)
    drills = [d for d in args.drills.split(",") if d]
    if args.smoke:
        args.replicas, args.new_tokens, args.requests = 2, 12, 6
        drills = ["sigkill"]
    record = run_chaos(args.seed, args.replicas, args.new_tokens,
                       args.requests, drills, device)
    emit_record(record, args.out, seed=args.seed)
    if not record["completed"]:
        print(f"VIOLATION, repro: {record['repro']}", file=sys.stderr)
    return 0 if record["completed"] else 1


if __name__ == "__main__":
    sys.exit(main())
