"""REST text-generation server (megatron_tpu/inference/server.py).

The `/api` PUT contract is the reference's: {"prompts": [...],
"tokens_to_generate": N, "temperature", "top_k", "top_p", "logprobs",
"random_seed", "add_BOS", "beam_width", "length_penalty", "priority",
"deadline_s", "serial", "adapter_id", "response_format", "n", "best_of"}
-> {"text", "segments", "logprobs"} or, for beam search, {"text",
"score"}.

By default the server builds one continuous-batching `ServingEngine`
(serving/engine.py) and every prompt of a payload becomes an engine request
interleaved with all other traffic; prompt i of a seeded payload uses seed
+ i. Statuses follow the reference: 429 with Retry-After on a full queue
or a draining engine, 504 on a deadline, 503 when the engine is unhealthy,
400 on admission errors. A payload with `"serial": true`, and beam search,
take the serial route: one request at a time under a lock
(`Generator.generate`, `beam_search`). With
`ServingConfig(serial_fallback=True)` there is no engine and every payload
takes the serial route, with the reference's statuses and messages in that
mode. A payload's `adapter_id` serves it under that registered LoRA
adapter on the engine route (an unknown one, or one on the serial route, is
a 400). `response_format` constrains the engine route's output to a regex
or a JSON schema (a grammar that does not compile is a 400, a generation
that reaches a state with no legal token a 422); with `n`/`best_of` each
prompt fans out into best_of samples and its text/segments/logprobs
entries become lists of the n best. The serial route refuses both, and a
router refuses fan-out. `GET /invariants[?strict=1]` runs the invariant
sweep (serving/invariants.py) on the live engines and answers its report.

The control plane, `PUT /admin` (`handle_admin`): `{"op": "swap_weights",
"ckpt_dir": ...}` hot-swaps the engine (a router walks a rolling upgrade)
and answers 409 when the checkpoint is refused, the old weights serving
on; `{"op": "register_adapter", "adapter_id": ..., "path": ...}` registers
an exported `.npz`; `{"op": "drain"}` drains. With
`ServingConfig(watch_checkpoints=root)` a CheckpointWatcher polls the
root's tracker and swaps to every new publish. After a swap the serial and
beam routes, which run the server's original weights, answer 409.

The front door: `ServingConfig(num_replicas=N)` with N >= 2 puts N engine
replicas over the one Generator (the weights held once, a block pool each)
behind the prefix-affinity router (serving/router.py): health-driven
failover, token-exact retries on survivors, and a /healthz that tells
degraded from down; N = 1 is the bare engine. A payload with
`"stream": true` (one prompt) is answered as server-sent events
(`text/event-stream`): a `start` event carrying the `stream_id`, one
`token` event per committed token with `id:` its index, then `done` or a
typed `error` event carrying the HTTP `status` a whole-completion caller
would have seen and the count of `committed` tokens. A dropped client
resumes with `{"stream": true, "stream_id": ...}` and the `Last-Event-ID`
header (the request holds every committed token, so the resume replays the
tail: nothing duplicated, nothing missing); `{"stream_id": ...,
"cancel": true}` evicts a stream's request and frees its slot. Finished
streams stay resumable for `stream_ttl_s`.

Remote replicas (serving/remote.py). With `ServingConfig(replica_mode=True)`
the server is one replica process of a fleet: it also takes the
pre-tokenized wire format, `{"prompt_tokens": [[ids...]], ...}` in place
of `prompts` (the front tier tokenized already, so the stream stays token
for token the same across the hop and across a failover), and serves
`GET /affinity`, its engine's routing digest. With
`ServingConfig(fleet="host:port,...")` the server is a front tier that
holds no weights and touches no device: `generator` is None, and the
router drives a `RemoteReplica` client for each address; its
`/invariants` folds each replica's own report (an unreachable replica is
listed under `unreachable`, not convicted). A server that is not a
replica answers `prompt_tokens` with a 400.

The transport is the standard library's threading HTTP server.
"""
from __future__ import annotations

import itertools
import json
import math
import secrets
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.inference.api import (beam_search_and_post_process,
                                              generate_and_post_process)
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.serving.engine import ServingEngine
from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.serving.remote import RemoteReplica
from megatron_tpu_torch.serving.request import (DeadlineExceededError,
                                                GrammarDeadEndError,
                                                SamplingOptions,
                                                ServiceUnavailableError)
from megatron_tpu_torch.serving.router import (EngineRouter,
                                               RollingUpgradeError)
from megatron_tpu_torch.serving.scheduler import (AdmissionError,
                                                  EngineUnhealthyError,
                                                  OverloadShedError,
                                                  QueueFullError)
from megatron_tpu_torch.serving.structured import validate_response_format
from megatron_tpu_torch.serving.weights import (CheckpointWatcher,
                                                WeightSwapError)
from megatron_tpu_torch.training.checkpointing import read_tracker
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

MAX_PROMPTS = 128

_TOKENS_NEED_REPLICA = ("prompt_tokens is the replica-mode wire format (run "
                        "the server with --replica_mode); send text prompts")


class _StreamEntry:
    """A row of the SSE stream registry: the live request (its `generated`
    list is the resume buffer) and the TTL bookkeeping."""

    __slots__ = ("sid", "req", "created", "done_t")

    def __init__(self, sid: str, req):
        self.sid = sid
        self.req = req
        self.created = time.monotonic()
        self.done_t = None  # set when first seen done; the TTL runs


def _is_stream_body(body) -> bool:
    return isinstance(body, types.GeneratorType)


def validate_generate_payload(payload) -> Optional[str]:
    """The request validator: an error message (-> HTTP 400) or None."""
    if not isinstance(payload, dict):
        return "request body must be a JSON object"
    has_text = "prompts" in payload
    has_tokens = "prompt_tokens" in payload
    if has_text and has_tokens:
        return "prompts and prompt_tokens are mutually exclusive"
    if not has_text and not has_tokens:
        return "prompts argument required"
    if has_tokens:
        rows = payload["prompt_tokens"]
        if not isinstance(rows, list) or not rows:
            return "prompt_tokens must be a non-empty list"
        if len(rows) > MAX_PROMPTS:
            return f"Maximum number of prompts is {MAX_PROMPTS}"
        for r in rows:
            if not isinstance(r, list) or not r or not all(
                    isinstance(t, int) and not isinstance(t, bool)
                    for t in r):
                return ("prompt_tokens rows must be non-empty lists "
                        "of integer token ids")
        n_prompts = len(rows)
    else:
        prompts = payload["prompts"]
        if not isinstance(prompts, list) or not prompts:
            return "prompts must be a non-empty list"
        if len(prompts) > MAX_PROMPTS:
            return f"Maximum number of prompts is {MAX_PROMPTS}"
        if not all(isinstance(p, str) and p for p in prompts):
            return "prompts must be non-empty strings"
        n_prompts = len(prompts)
    try:
        n = int(payload.get("tokens_to_generate", 64))
    except (TypeError, ValueError):
        return "tokens_to_generate must be an integer"
    if n < 0:
        return "tokens_to_generate must be >= 0"
    for field, conv in (("temperature", float), ("top_k", int),
                        ("top_p", float), ("length_penalty", float),
                        ("beam_width", int), ("random_seed", int),
                        ("priority", int), ("deadline_s", float),
                        ("arrival_id", int)):
        v = payload.get(field)
        if v is None:
            continue
        try:
            conv(v)
        except (TypeError, ValueError):
            return f"{field} must be a number"
    if payload.get("deadline_s") is not None:
        d = float(payload["deadline_s"])
        if not math.isfinite(d) or d <= 0.0:
            return "deadline_s must be a finite number > 0"
    if payload.get("beam_width") and n_prompts > 1:
        return "With beam_search only one prompt is allowed"
    if has_tokens and payload.get("beam_width"):
        return "prompt_tokens requires the serving-engine path; beam " \
               "search is text-prompt only"
    aid = payload.get("adapter_id")
    if aid is not None and not isinstance(aid, (str, int)):
        return "adapter_id must be a string or integer"
    if aid is not None and payload.get("beam_width"):
        return "beam search runs the serial path; adapters require " \
               "the serving engine"
    rf = payload.get("response_format")
    if rf is not None:
        msg = validate_response_format(rf)
        if msg is not None:
            return f"response_format: {msg}"
    for field in ("n", "best_of"):
        v = payload.get(field)
        if v is None:
            continue
        if isinstance(v, bool) or not isinstance(v, int):
            return f"{field} must be an integer"
        if v < 1:
            return f"{field} must be >= 1"
    n_samples = payload.get("n")
    best_of = payload.get("best_of")
    if n_samples is not None and best_of is not None \
            and n_samples > best_of:
        return f"n ({n_samples}) must be <= best_of ({best_of})"
    if (best_of or n_samples or 1) > 1 and payload.get("beam_width"):
        return "beam search does not compose with n/best_of parallel " \
               "sampling"
    return None


class MegatronServer:
    """Text-generation server over one Generator: the continuous-batching
    engine route, unless `serving.serial_fallback`, plus the serial route;
    or, with `serving.fleet`, a front tier over replica processes
    (`generator` None).

    `device` must name the generator's device; None means the current CUDA
    device and raises without one (a front tier resolves none).
    `weight_version` names the checkpoint the generator's weights came
    from (the watcher then does not swap to it again)."""

    def __init__(self, generator: Optional[Generator], tokenizer, *,
                 serving: Optional[ServingConfig] = None,
                 device: DeviceLike = None, request_timeout: float = 600.0,
                 weight_version=None):
        serving = serving if serving is not None else ServingConfig()
        if not serving.fleet:
            if generator is None:
                raise ValueError("a server holds a Generator unless it is a "
                                 "fleet front tier (ServingConfig.fleet)")
            device = resolve_device(device)
            if generator.device != device:
                raise ValueError(f"generator runs on {generator.device}, "
                                 f"the server on {device}")
        self.generator = generator
        self.tokenizer = tokenizer
        self.serving = serving.validate(
            generator.cfg if generator is not None else None)
        self._lock = threading.Lock()  # the serial route: one at a time
        self._request_counter = itertools.count()
        self._timeout = request_timeout
        # the SSE stream registry: stream_id -> live request, so that a
        # dropped connection resumes through Last-Event-ID
        self._streams: dict = {}
        self._streams_lock = threading.Lock()
        self.engine = None
        self._watcher = None
        if self.serving.serial_fallback:
            return
        if self.serving.fleet:
            # the router over a RemoteReplica client per address; one
            # registry is both the router's and the transport-fault
            # counters' sink, so one /metrics scrape shows both
            counters = ServingMetrics()
            replicas = [
                RemoteReplica(
                    addr.strip(), counters=counters,
                    connect_timeout_s=self.serving.remote_connect_timeout_s,
                    read_timeout_s=self.serving.remote_read_timeout_s,
                    max_retries=self.serving.remote_max_retries,
                    digest_interval_s=self.serving.remote_digest_interval_s)
                for addr in self.serving.fleet.split(",") if addr.strip()]
            self.engine = EngineRouter(
                replicas, metrics=counters,
                max_retries=self.serving.router_max_retries,
                heartbeat_timeout_s=self.serving.router_heartbeat_timeout_s)
        elif self.serving.num_replicas == 1:
            self.engine = ServingEngine(generator, self.serving,
                                        device=device,
                                        weight_version=weight_version)
        else:
            # N replicas over the one Generator: its weights are held
            # once, and each replica has its own pool, queue and supervisor
            engines = []
            try:
                for _ in range(self.serving.num_replicas):
                    engines.append(ServingEngine(
                        generator, self.serving, device=device,
                        weight_version=weight_version))
            except BaseException:
                for e in engines:
                    e.close()
                raise
            self.engine = EngineRouter(
                engines, max_retries=self.serving.router_max_retries,
                heartbeat_timeout_s=self.serving.router_heartbeat_timeout_s)
        if self.serving.watch_checkpoints:
            root = self.serving.watch_checkpoints
            initial_tag = None
            if weight_version is not None:
                # the tracker still names what the weights came from: the
                # first poll must not swap to it again
                try:
                    tag = read_tracker(root)
                except Exception:  # noqa: BLE001 — racing a publish
                    tag = None
                if tag == str(weight_version.iteration):
                    initial_tag = tag
            self._watcher = CheckpointWatcher(
                self.engine, root, interval_s=self.serving.watch_interval_s,
                initial_tag=initial_tag).start()

    def close(self):
        if self._watcher is not None:
            self._watcher.close()
        if self.engine is not None:
            self.engine.close()

    def _seed_for(self, payload) -> int:
        """An explicit random_seed stays deterministic; unseeded requests
        mix entropy with a per-process counter."""
        if payload.get("random_seed") is not None:
            return int(payload["random_seed"])
        return (secrets.randbits(31)
                ^ (next(self._request_counter) & 0x7FFFFFFF))

    def handle(self, payload, headers: Optional[dict] = None
               ) -> Tuple[int, object]:
        """Returns (http_status, body): a JSON-able dict, or for a
        `"stream": true` payload a generator of SSE frames (the transport
        answers it as `text/event-stream`). `headers` carries the request's
        headers (Last-Event-ID for a stream's resume)."""
        if self.engine is None:
            return self._handle_serial_mode(payload)
        try:
            if isinstance(payload, dict):
                if payload.get("prompt_tokens") is not None \
                        and not self.serving.replica_mode:
                    # the front tier's protocol to a replica process; a
                    # public server speaks text (its tokenizer is the
                    # contract)
                    return 400, {"message": _TOKENS_NEED_REPLICA}
                if payload.get("cancel"):
                    return self._handle_cancel(payload)
                if payload.get("stream"):
                    # validated inside: a resume carries only a stream_id
                    return self._handle_stream(payload, headers or {})
            err = validate_generate_payload(payload)
            if err is not None:
                return 400, {"message": err}
            if self.generator is None and (payload.get("beam_width")
                                           or payload.get("serial")):
                what = ("beam search" if payload.get("beam_width")
                        else "the serial route")
                return 400, {"message": f"{what} forwards locally; a fleet "
                                        "front tier holds no weights"}
            if payload.get("serial") \
                    and payload.get("prompt_tokens") is not None:
                return 400, {"message": "prompt_tokens requires the serving-"
                                        "engine path (drop 'serial': true / "
                                        "serial_fallback)"}
            if payload.get("beam_width") or payload.get("serial"):
                err = self._stale_fallback_error(
                    "beam search" if payload.get("beam_width")
                    else "the serial route")
                if err is not None:
                    return 409, {"message": err}
            if payload.get("beam_width"):
                return 200, self._handle_beam(payload)
            if payload.get("serial"):
                if payload.get("adapter_id") is not None:
                    # the serial route has no adapter bank: it would decode
                    # the base model
                    return 400, {"message":
                                 "adapter_id requires the serving-engine "
                                 "path (drop 'serial': true / "
                                 "serial_fallback)"}
                if payload.get("response_format") is not None or \
                        (payload.get("best_of") or payload.get("n") or 1) > 1:
                    # no FSM masking and no slot grid to fan out on there:
                    # its output would be wrong, not degraded
                    return 400, {"message":
                                 "response_format and n/best_of require "
                                 "the serving-engine path (drop 'serial': "
                                 "true / serial_fallback)"}
                return 200, self._handle_serial(payload)
            return 200, self._handle_engine(payload)
        except EngineUnhealthyError as e:
            return 503, self._backoff_body(str(e), retry_after=30)
        except QueueFullError as e:
            # a full queue, early shedding (a subclass) or a draining
            # engine: retryable, with the backoff hint
            return 429, self._backoff_body(
                str(e), retry_after=e.retry_after,
                queue_depth=e.queue_depth)
        except DeadlineExceededError as e:
            return 504, {"message": str(e)}
        except ServiceUnavailableError as e:
            return 503, self._backoff_body(str(e), retry_after=5)
        except AdmissionError as e:
            return 400, {"message": str(e)}
        except GrammarDeadEndError as e:
            # well-formed (not a 400), the server healthy (not a 500): the
            # constrained generation is unprocessable. Not retryable as
            # is: the same grammar, budget and seed dead-end again
            return 422, {"message": str(e)}
        except Exception as e:  # noqa: BLE001 — a server fault is a 500
            return 500, {"message": str(e)}

    def _handle_serial_mode(self, payload) -> Tuple[int, dict]:
        """Every payload on the serial route (`serial_fallback`), with the
        reference's statuses and messages in that mode."""
        try:
            if isinstance(payload, dict) \
                    and payload.get("prompt_tokens") is not None:
                return 400, {"message": _TOKENS_NEED_REPLICA}
            if isinstance(payload, dict) and payload.get("cancel"):
                return 400, {"message": "cancel requires the serving engine"}
            if isinstance(payload, dict) and payload.get("stream"):
                return 400, {"message": "streaming requires the continuous-"
                                        "batching engine (serial_fallback "
                                        "serves whole completions only)"}
            err = validate_generate_payload(payload)
            if err is not None:
                return 400, {"message": err}
            if payload.get("beam_width"):
                return 200, self._handle_beam(payload)
            if payload.get("adapter_id") is not None:
                return 400, {"message":
                             "adapter_id requires the serving-engine "
                             "path (drop 'serial': true / "
                             "serial_fallback)"}
            if payload.get("response_format") is not None or \
                    (payload.get("best_of") or payload.get("n") or 1) > 1:
                return 400, {"message":
                             "response_format and n/best_of require "
                             "the serving-engine path (drop 'serial': "
                             "true / serial_fallback)"}
            return 200, self._handle_serial(payload)
        except AdmissionError as e:
            return 400, {"message": str(e)}
        except Exception as e:  # noqa: BLE001 — a server fault is a 500
            return 500, {"message": str(e)}

    def _stale_fallback_error(self, what: str) -> Optional[str]:
        """The serial and beam routes forward through the server's
        Generator, which a hot swap leaves alone (replicas share it): once
        an engine has swapped they would serve the old weights under a
        fleet reporting the new version, so they answer 409 instead."""
        try:
            snap = (self.engine.aggregate_snapshot()
                    if isinstance(self.engine, EngineRouter)
                    else self.engine.metrics.snapshot())
            swapped = snap.get("weight_swaps", 0) > 0
        except Exception:  # noqa: BLE001 — cannot tell: let it through
            swapped = False
        if not swapped:
            return None
        return (f"{what} is unavailable after a live-weight hot swap: it "
                "forwards through the server's original startup weights, "
                "not the engine's current version; restart the server on "
                "the new checkpoint to use it")

    def _backoff_body(self, message: str,
                      retry_after: Optional[int] = None,
                      queue_depth: Optional[int] = None) -> dict:
        """429/503 body: the message, the backoff hint in whole seconds
        (>= 1, also sent as the Retry-After header) and the queue depth."""
        if queue_depth is None:
            queue_depth = (self.engine.queue_depth()
                           if self.engine is not None else 0)
        hint = (1 if retry_after is None
                else max(1, int(math.ceil(float(retry_after)))))
        return {"message": message, "retry_after": hint,
                "queue_depth": int(queue_depth)}

    @staticmethod
    def response_headers(body: dict) -> dict:
        """A `retry_after` hint in the body becomes the Retry-After header."""
        if isinstance(body, dict) and body.get("retry_after"):
            return {"Retry-After": str(int(body["retry_after"]))}
        return {}

    def handle_admin(self, payload) -> Tuple[int, dict]:
        """`PUT /admin` (server.py handle_admin): `swap_weights` (a router
        walks a rolling upgrade; 409 on a refusal, the old weights serving
        on), `register_adapter` by path, and `drain`; 400 on a bad
        request."""
        if self.engine is None:
            return 400, {"message": "admin ops require the serving engine "
                                    "(serial_fallback has no control "
                                    "plane)"}
        if not isinstance(payload, dict):
            return 400, {"message": "request body must be a JSON object"}
        op = payload.get("op")
        if op == "swap_weights":
            ckpt = payload.get("ckpt_dir")
            if not ckpt:
                return 400, {"message": "swap_weights requires ckpt_dir"}
            timeout = payload.get("timeout")
            timeout = float(timeout) if timeout is not None else 120.0
            try:
                if isinstance(self.engine, EngineRouter):
                    version = self.engine.rolling_upgrade(
                        str(ckpt), swap_timeout_s=timeout)
                else:
                    version = self.engine.swap_weights(str(ckpt),
                                                       timeout=timeout)
            except (WeightSwapError, RollingUpgradeError) as e:
                # a refusal leaves the old weights serving: a conflict
                # with the current state, not a server fault
                return 409, {"message": str(e)}
            return 200, {"label": version.label,
                         "iteration": int(version.iteration)}
        if op == "register_adapter":
            aid = payload.get("adapter_id")
            if aid is None:
                return 400, {"message": "register_adapter requires "
                                        "adapter_id"}
            try:
                rank = payload.get("rank")
                self.engine.register_adapter(
                    aid, path=payload.get("path"),
                    rank=None if rank is None else int(rank),
                    alpha=float(payload.get("alpha", 1.0)))
            except AdmissionError as e:
                return 400, {"message": str(e)}
            return 200, {"registered": aid}
        if op == "drain":
            timeout = payload.get("timeout")
            drained = self.engine.drain(
                float(timeout) if timeout is not None else 120.0)
            return 200, {"drained": bool(drained)}
        return 400, {"message": f"unknown admin op {op!r} (swap_weights | "
                                "register_adapter | drain)"}

    def healthz(self) -> Tuple[int, dict]:
        """200 while the engine (or the router: a degraded router, with
        some replica still up, stays ready) accepts work, else 503, with
        the health snapshot; the serial mode has no loop to probe."""
        if self.engine is None:
            return 200, {"healthy": True, "serving": "serial"}
        self._gc_streams()  # probes double as the registry's sweeper
        h = self.engine.health()
        return (200 if h["accepting"] else 503), h

    def metrics_snapshot(self) -> dict:
        if self.engine is None:
            return {"serving": "serial"}
        self._gc_streams()  # scrapes double as the registry's sweeper
        if isinstance(self.engine, EngineRouter):
            # counters summed across replicas, the router's own added
            return self.engine.aggregate_snapshot()
        return self.engine.metrics.snapshot()

    def _preflight_lengths(self, payload: dict, max_total: int, what: str):
        """Tokenize and check lengths before generating, so empty or
        oversize prompts are a 400. Returns the ids (BOS applied). Rows of
        `prompt_tokens` are ids already (the front tier tokenized and
        applied BOS): only their lengths are checked."""
        n = int(payload.get("tokens_to_generate", 64))
        if payload.get("prompt_tokens") is not None:
            prompt_ids = []
            for i, row in enumerate(payload["prompt_tokens"]):
                ids = [int(t) for t in row]
                if len(ids) + n > max_total:
                    raise AdmissionError(
                        f"prompt {i} ({len(ids)} tokens) + tokens_to_"
                        f"generate ({n}) exceeds {what}={max_total}")
                prompt_ids.append(ids)
            return prompt_ids
        add_bos = bool(payload.get("add_BOS", False))
        prompt_ids = []
        for i, p in enumerate(payload["prompts"]):
            ids = self.tokenizer.tokenize(p)
            if add_bos and self.tokenizer.bos is not None:
                ids = [self.tokenizer.bos] + ids
            if not ids:
                raise AdmissionError(f"prompt {i} tokenized to zero tokens")
            if len(ids) + n > max_total:
                raise AdmissionError(
                    f"prompt {i} ({len(ids)} tokens) + tokens_to_"
                    f"generate ({n}) exceeds {what}={max_total}")
            prompt_ids.append(ids)
        return prompt_ids

    def _handle_beam(self, payload: dict) -> dict:
        prompt_ids = self._preflight_lengths(
            payload, self.generator.cfg.max_position_embeddings,
            "max_position_embeddings")
        with self._lock:
            texts, scores = beam_search_and_post_process(
                self.generator, self.tokenizer, payload["prompts"][0],
                tokens_to_generate=int(payload.get("tokens_to_generate",
                                                   64)),
                beam_size=int(payload["beam_width"]),
                length_penalty=float(payload.get("length_penalty", 1.0)),
                add_BOS=bool(payload.get("add_BOS", False)),
                prompt_ids=prompt_ids[0])
        return {"text": texts, "score": scores}

    def _handle_serial(self, payload: dict) -> dict:
        prompt_ids = self._preflight_lengths(
            payload, self.generator.cfg.max_position_embeddings,
            "max_position_embeddings")
        with self._lock:
            texts, tokens, logprobs = generate_and_post_process(
                self.generator, self.tokenizer, payload["prompts"],
                tokens_to_generate=int(payload.get("tokens_to_generate",
                                                   64)),
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 0.0)),
                add_BOS=bool(payload.get("add_BOS", False)),
                return_output_log_probs=bool(payload.get("logprobs",
                                                         False)),
                seed=self._seed_for(payload),
                prompt_ids=prompt_ids)
        out = {"text": texts, "segments": tokens}
        if logprobs is not None:
            out["logprobs"] = logprobs
        return out

    def _handle_engine(self, payload: dict) -> dict:
        """The continuous-batching route: each prompt is an independent
        engine request (prompt i with seed + i). Every prompt is tokenized
        and checked before any is submitted. A payload with more prompts
        than the queue holds drains its own finished rows to make room; a
        429 fires only when other traffic fills the queue before this
        payload served a row.

        With `n`/`best_of` each prompt fans out into best_of samples
        seeded from seed + i * best_of (seed + i would collide across
        prompts) and its entries become lists of the n best completions.
        `response_format` rides to the engine's constrained decoding."""
        n = int(payload.get("tokens_to_generate", 64))
        sampling = SamplingOptions(
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 0.0)))
        seed = self._seed_for(payload)
        rf = payload.get("response_format")
        n_samples = int(payload.get("n", 1) or 1)
        best_of = int(payload.get("best_of", n_samples) or n_samples)
        fanout = best_of > 1
        priority = int(payload.get("priority", 0) or 0)
        deadline_s = payload.get("deadline_s")
        deadline_s = None if deadline_s is None else float(deadline_s)
        # a failover resubmitted by a front tier carries its original
        # arrival position, so it re-enters this queue where its first
        # attempt stood (prompt i offset by i)
        aid0 = payload.get("arrival_id")
        aid0 = None if aid0 is None else int(aid0)
        prompt_ids = self._preflight_lengths(payload, self.engine.max_len,
                                             "max_len")
        give_up = time.monotonic() + self._timeout
        reqs: dict = {}
        results: dict = {}
        pending: list = []
        try:
            for i, ids in enumerate(prompt_ids):
                while True:
                    try:
                        reqs[i] = self.engine.submit(
                            ids, n, sampling, seed=seed + i * best_of,
                            priority=priority, deadline_s=deadline_s,
                            arrival_id=None if aid0 is None else aid0 + i,
                            adapter_id=payload.get("adapter_id"),
                            response_format=rf, n=n_samples,
                            best_of=best_of)
                        pending.append(i)
                        break
                    except OverloadShedError:
                        raise
                    except QueueFullError:
                        if pending:  # make room by draining our oldest row
                            j = pending.pop(0)
                            results[j] = reqs[j].result(self._timeout)
                        elif results:
                            if time.monotonic() > give_up:
                                raise RuntimeError(
                                    "timed out waiting for queue space "
                                    f"after serving {len(results)} of "
                                    f"{len(prompt_ids)} prompts")
                            time.sleep(0.05)
                        else:
                            raise  # backpressure: nothing served yet
            for j in pending:
                results[j] = reqs[j].result(self._timeout)
        except Exception:
            # the payload failed: stop decoding its rows nobody will read
            for r in reqs.values():
                self.engine.cancel(r)
            raise
        texts, tokens, logprobs = [], [], []
        for i in range(len(prompt_ids)):
            if fanout:
                # the n best samples, each a (tokens, logprobs) pair
                plen = len(reqs[i].prompt)
                toks_list, lps_list = results[i]
                texts.append([self.tokenizer.detokenize(t)
                              for t in toks_list])
                tokens.append(toks_list)
                logprobs.append([[0.0] * plen + lp for lp in lps_list])
                continue
            toks, gen_lps = results[i]
            texts.append(self.tokenizer.detokenize(toks))
            tokens.append(toks)
            # one value per output token; prompt positions are zero
            logprobs.append([0.0] * len(reqs[i].prompt) + gen_lps)
        out = {"text": texts, "segments": tokens}
        if payload.get("logprobs"):
            out["logprobs"] = logprobs
        return out

    # ------------------------------------------------------------------
    # SSE streaming
    # ------------------------------------------------------------------
    @staticmethod
    def _sse(data: dict, event: Optional[str] = None,
             event_id: Optional[int] = None) -> str:
        """One SSE frame. Token frames carry `id:` = the token's index,
        which is what makes a Last-Event-ID resume exact."""
        lines = []
        if event_id is not None:
            lines.append(f"id: {event_id}")
        if event:
            lines.append(f"event: {event}")
        lines.append("data: " + json.dumps(data))
        return "\n".join(lines) + "\n\n"

    def _gc_streams(self):
        """Sweep the stream registry; runs on every stream request and on
        the /metrics and /healthz paths, so finished or abandoned entries
        do not outlive their TTL on a server that gets no new streams."""
        with self._streams_lock:
            self._gc_streams_locked(time.monotonic())

    def _gc_streams_locked(self, now: float):
        ttl = float(self.serving.stream_ttl_s)
        for sid in list(self._streams):
            e = self._streams[sid]
            if e.done_t is None and e.req.done():
                e.done_t = now
            if e.done_t is not None and now - e.done_t > ttl:
                del self._streams[sid]
            elif e.done_t is None and now - e.created > ttl + self._timeout:
                # a router request settles only while a caller pumps it:
                # past the request timeout and the TTL nobody can resume
                # an abandoned stream, so cancel it and drop it
                try:
                    self.engine.cancel(e.req)
                except Exception:  # noqa: BLE001 — the sweep is best-effort
                    pass
                del self._streams[sid]

    def _handle_stream(self, payload: dict, headers) -> Tuple[int, object]:
        """`"stream": true`: a fresh stream submits one request and returns
        the frame generator; a resume (`stream_id`) re-attaches to the live
        request and replays its committed tokens from Last-Event-ID + 1."""
        last = headers.get("Last-Event-ID") if headers else None
        if last is None:
            last = payload.get("last_event_id")
        try:
            last = int(last) if last is not None else -1
        except (TypeError, ValueError):
            return 400, {"message": "Last-Event-ID must be an integer "
                                    "token index"}
        sid = payload.get("stream_id")
        if sid is not None:
            with self._streams_lock:
                self._gc_streams_locked(time.monotonic())
                entry = self._streams.get(sid)
            if entry is None:
                return 404, {"message": f"unknown or expired stream_id "
                                        f"{sid!r}; start a new stream"}
            self.engine.metrics.count("stream_reconnects")
            if getattr(entry.req, "children", None):
                return 200, self._stream_events_fanout(entry,
                                                       start=last + 1,
                                                       resumed=True)
            return 200, self._stream_events(entry, start=last + 1,
                                            resumed=True)
        err = validate_generate_payload(payload)
        if err is not None:
            return 400, {"message": err}
        if payload.get("beam_width"):
            return 400, {"message": "beam search is whole-batch; it does "
                                    "not stream"}
        if len(payload.get("prompts") or payload.get("prompt_tokens")
               or ()) != 1:
            return 400, {"message": "streaming supports exactly one prompt "
                                    "per request"}
        n_samples = int(payload.get("n", 1) or 1)
        best_of = int(payload.get("best_of", n_samples) or n_samples)
        if best_of > 1 and n_samples != best_of:
            # ranking needs every sample finished: a fan-out stream
            # delivers all of them
            return 400, {"message": "streaming requires n == best_of "
                                    "(n-best selection cannot stream; "
                                    "drop best_of or stream all "
                                    "samples)"}
        prompt_ids = self._preflight_lengths(payload, self.engine.max_len,
                                             "max_len")
        sampling = SamplingOptions(
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 0.0)))
        deadline_s = payload.get("deadline_s")
        aid = payload.get("arrival_id")
        req = self.engine.submit(
            prompt_ids[0], int(payload.get("tokens_to_generate", 64)),
            sampling, seed=self._seed_for(payload),
            priority=int(payload.get("priority", 0) or 0),
            deadline_s=None if deadline_s is None else float(deadline_s),
            arrival_id=None if aid is None else int(aid),
            adapter_id=payload.get("adapter_id"),
            response_format=payload.get("response_format"),
            n=n_samples, best_of=best_of)
        entry = _StreamEntry(secrets.token_hex(8), req)
        with self._streams_lock:
            self._gc_streams_locked(time.monotonic())
            self._streams[entry.sid] = entry
        if getattr(req, "children", None):
            return 200, self._stream_events_fanout(entry, start=0,
                                                   resumed=False)
        return 200, self._stream_events(entry, start=0, resumed=False)

    @staticmethod
    def _error_status(e: Exception) -> int:
        """The HTTP status a whole-completion caller would have seen for a
        request's terminal error (a stream's typed `error` frame)."""
        if isinstance(e, DeadlineExceededError):
            return 504
        if isinstance(e, (ServiceUnavailableError, EngineUnhealthyError)):
            return 503
        if isinstance(e, QueueFullError):
            return 429
        if isinstance(e, GrammarDeadEndError):
            return 422  # deterministic for its grammar and seed
        return 500

    def _stream_events(self, entry: _StreamEntry, start: int,
                       resumed: bool):
        """The frame generator: `start` (the stream_id for a later resume),
        one `token` frame per committed token with `id:` its index, then
        one terminal frame: `done` with the whole completion, or `error`
        with the status a whole-completion caller would have seen (a
        replica's crash mid-stream ends here, never in a silent hang)."""
        req = entry.req
        # the version of the replica serving the stream now (a failed-over
        # stream reports the survivor's), on every start frame
        rep = getattr(req, "replica", None)
        eng = rep.engine if rep is not None else self.engine
        version = getattr(eng, "weight_version", None)
        yield self._sse({"stream_id": entry.sid, "resumed": resumed,
                         "next_index": max(start, 0),
                         "weight_version": (version.label if version
                                            is not None else "unversioned")},
                        event="start")
        i = max(start, 0)
        # the budget the whole-completion route enforces through
        # result(timeout): a stuck request ends in a terminal frame
        give_up = time.monotonic() + self._timeout
        while True:
            gen = req.generated
            if i < len(gen):
                lps = req.gen_logprobs
                data = {"index": i, "token": int(gen[i]),
                        "text": self.tokenizer.detokenize([int(gen[i])])}
                if i < len(lps):
                    data["logprob"] = float(lps[i])
                yield self._sse(data, event="token", event_id=i)
                i += 1
                continue
            if req.done():
                break
            if time.monotonic() > give_up:
                yield self._sse(
                    {"message": f"stream timed out after "
                                f"{self._timeout:.0f}s waiting for tokens",
                     "status": 500, "retryable": True,
                     "committed": len(req.generated)}, event="error")
                return
            # a router request's wait_token drives its retry pump, so a
            # failed-over stream goes on from a survivor
            req.wait_token(i, timeout=0.25)
        try:
            toks, _ = req.result(timeout=self._timeout)
        except Exception as e:  # noqa: BLE001 — a typed terminal frame
            status = self._error_status(e)
            yield self._sse({"message": str(e), "status": status,
                             "retryable": status in (429, 503),
                             "committed": len(req.generated)},
                            event="error")
            return
        yield self._sse({"text": self.tokenizer.detokenize(toks),
                         "segments": toks,
                         "generated": len(req.generated)}, event="done")

    def _stream_events_fanout(self, entry: _StreamEntry, start: int,
                              resumed: bool):
        """The frame generator of a fan-out stream (n == best_of): sample
        0 streams to its end, then sample 1, and so on, under one global
        frame id across all samples, so a Last-Event-ID resume is as exact
        as a single stream's. A token frame carries its `sample` beside its
        per-sample `index`; a sample's typed failure is an `error` frame
        tagged with the sample and the stream goes on; `done` reports every
        completed text."""
        agg = entry.req
        version = getattr(self.engine, "weight_version", None)
        yield self._sse({"stream_id": entry.sid, "resumed": resumed,
                         "next_index": max(start, 0), "n": agg.n,
                         "weight_version": (version.label if version
                                            is not None else "unversioned")},
                        event="start")
        gid = 0  # the global frame id
        start = max(start, 0)
        give_up = time.monotonic() + self._timeout
        texts, errors = [], []
        for k, req in enumerate(agg.children):
            i = 0
            while True:
                gen = req.generated
                if i < len(gen):
                    if gid >= start:
                        lps = req.gen_logprobs
                        data = {"sample": k, "index": i,
                                "token": int(gen[i]),
                                "text": self.tokenizer.detokenize(
                                    [int(gen[i])])}
                        if i < len(lps):
                            data["logprob"] = float(lps[i])
                        yield self._sse(data, event="token", event_id=gid)
                    gid += 1
                    i += 1
                    continue
                if req.done():
                    break
                if time.monotonic() > give_up:
                    yield self._sse(
                        {"message": f"stream timed out after "
                                    f"{self._timeout:.0f}s waiting for "
                                    "tokens", "status": 500,
                         "retryable": True, "sample": k,
                         "committed": len(req.generated)}, event="error")
                    return
                req.wait_token(i, timeout=0.25)
            try:
                toks, _ = req.result(timeout=self._timeout)
                texts.append(self.tokenizer.detokenize(toks))
            except Exception as e:  # noqa: BLE001 — a typed sample frame
                status = self._error_status(e)
                errors.append({"sample": k, "status": status})
                yield self._sse({"message": str(e), "status": status,
                                 "retryable": status in (429, 503),
                                 "sample": k,
                                 "committed": len(req.generated)},
                                event="error")
        yield self._sse({"text": texts, "n": agg.n,
                         "completed": len(texts), "failed": errors},
                        event="done")

    def invariant_report(self, strict: bool = False) -> dict:
        """`GET /invariants`: the invariant sweep (serving/invariants.py)
        of this process's live engines, as a report. Default strict=False:
        a live engine is rarely quiesced; the caller opts into the strict
        accounting sweep once traffic stops. A sweep that raises is itself
        a reported violation, not a 500. On a front tier each remote
        replica sweeps itself and its report is folded in; the addresses
        of replicas that did not answer are listed under `unreachable`."""
        from megatron_tpu_torch.serving.invariants import (
            _check_remote_engine, _Sweep, check_engine, check_router_health,
            check_schema)
        if self.engine is None:
            return {"engines": 0, "laws_checked": [], "violations": [],
                    "ok": True}
        sweep = _Sweep()
        unreachable = []
        is_router = isinstance(self.engine, EngineRouter)
        engines = self.engine.engines if is_router else [self.engine]
        for e in engines:
            try:
                if hasattr(e, "invariant_report"):
                    res = _check_remote_engine(e, strict, sweep)
                    if "unreachable" in res:
                        unreachable.append(res["remote"])
                else:
                    check_engine(e, strict=strict, sweep=sweep)
            except Exception as ex:  # noqa: BLE001
                sweep.violations.append(
                    ("sweep", f"check_engine raised {type(ex).__name__}: "
                              f"{ex}"))
        if is_router:
            try:
                check_router_health(self.engine.health(), sweep=sweep)
                check_schema(self.engine.aggregate_snapshot(), router=True,
                             sweep=sweep)
            except Exception as ex:  # noqa: BLE001
                sweep.violations.append(
                    ("sweep", f"router sweep raised {type(ex).__name__}: "
                              f"{ex}"))
        report = {"engines": len(engines),
                  "laws_checked": list(sweep.checked),
                  "violations": [[law, detail]
                                 for law, detail in sweep.violations],
                  "ok": not sweep.violations}
        if unreachable:
            report["unreachable"] = unreachable
        return report

    def affinity_digest(self) -> dict:
        """`GET /affinity`: the routing digest a remote front tier reads in
        place of calling `prefix_peek` over the wire for every request (the
        engine's `affinity_digest`; a router merges its replicas')."""
        if self.engine is None:
            return {"granularity": 0, "namespaces": {}, "adapters": {}}
        return self.engine.affinity_digest()

    def _handle_cancel(self, payload: dict) -> Tuple[int, dict]:
        """`{"stream_id": ..., "cancel": true}`: evict a live stream's
        request, so its slot stops decoding tokens nobody will read.
        Idempotent: an unknown or collected stream answers 200 with
        `cancelled` false."""
        sid = payload.get("stream_id")
        if not isinstance(sid, str) or not sid:
            return 400, {"message": "cancel requires a stream_id"}
        with self._streams_lock:
            self._gc_streams_locked(time.monotonic())
            entry = self._streams.get(sid)
        if entry is None:
            return 200, {"cancelled": False, "stream_id": sid,
                         "message": "unknown or already-expired stream"}
        self.engine.cancel(entry.req)
        return 200, {"cancelled": True, "stream_id": sid}

    def make_http_server(self, host: str, port: int) -> ThreadingHTTPServer:
        """The HTTP front end, bound but not yet serving: PUT /api (JSON,
        or server-sent events for a stream) and /admin, GET /healthz,
        /metrics, /invariants[?strict=1] and /affinity. The caller runs
        `serve_forever()` and stops it with `shutdown()`."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, status: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in server.response_headers(body).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _send_stream(self, status: int, gen):
                """An SSE response: no Content-Length, one flushed write a
                frame. A dropped client stops the writer only: the request
                decodes on, and a resume replays its tail."""
                self.send_response(status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for chunk in gen:
                        self.wfile.write(chunk.encode())
                        self.wfile.flush()
                except OSError:
                    pass  # the client is gone; the stream stays resumable
                finally:
                    gen.close()

            def do_PUT(self):
                from urllib.parse import urlsplit
                path = urlsplit(self.path).path.rstrip("/")
                if path not in ("/api", "/admin"):
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._send(400, {"message": f"invalid JSON: {e}"})
                    return
                try:
                    if path == "/admin":
                        status, body = server.handle_admin(payload)
                    else:
                        status, body = server.handle(payload,
                                                     headers=self.headers)
                except Exception as e:  # noqa: BLE001 — a fault is a 500
                    status, body = 500, {"message": str(e)}
                if _is_stream_body(body):
                    self._send_stream(status, body)
                else:
                    self._send(status, body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit
                parts = urlsplit(self.path)
                path = parts.path.rstrip("/")
                if path == "/metrics":
                    self._send(200, server.metrics_snapshot())
                elif path == "/healthz":
                    self._send(*server.healthz())
                elif path == "/invariants":
                    strict = (parse_qs(parts.query).get("strict", ["0"])[0]
                              not in ("0", "", "false"))
                    try:
                        self._send(200,
                                   server.invariant_report(strict=strict))
                    except Exception as e:  # noqa: BLE001 — a report
                        self._send(500, {"message": str(e)})
                elif path == "/affinity":
                    try:
                        self._send(200, server.affinity_digest())
                    except Exception as e:  # noqa: BLE001
                        self._send(500, {"message": str(e)})
                else:
                    self.send_error(404)

            def log_message(self, fmt, *a):
                pass

        return ThreadingHTTPServer((host, port), Handler)
