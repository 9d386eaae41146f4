"""REST text-generation server (megatron_tpu/inference/server.py).

The `/api` PUT contract is the reference's: {"prompts": [...],
"tokens_to_generate": N, "temperature", "top_k", "top_p", "logprobs",
"random_seed", "add_BOS", "beam_width", "length_penalty", "priority",
"deadline_s", "serial"} -> {"text", "segments", "logprobs"} or, for beam
search, {"text", "score"}.

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
mode. On the engine route, `stream`, `n`/`best_of`, `response_format`,
`adapter_id`, `prompt_tokens` and `cancel` get a 400 saying which later
slice brings them.

The transport is the standard library's threading HTTP server.
"""
from __future__ import annotations

import itertools
import json
import math
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.inference.api import (beam_search_and_post_process,
                                              generate_and_post_process)
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.serving.engine import ServingEngine
from megatron_tpu_torch.serving.request import (DeadlineExceededError,
                                                SamplingOptions,
                                                ServiceUnavailableError)
from megatron_tpu_torch.serving.scheduler import (AdmissionError,
                                                  EngineUnhealthyError,
                                                  OverloadShedError,
                                                  QueueFullError)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

MAX_PROMPTS = 128

# what the engine route refuses, and the slice that brings it
_LATER_ON_ENGINE = (
    ("prompt_tokens", "prompt_tokens (the replica-mode wire format) comes "
                      "with remote replicas in a later slice"),
    ("cancel", "cancel comes with SSE streaming in a later slice"),
    ("stream", "streaming comes with SSE in a later slice"),
    ("adapter_id", "adapter_id comes with LoRA adapters in a later slice"),
    ("response_format", "response_format comes with structured output in "
                        "a later slice"),
)


def validate_response_format(rf) -> Optional[str]:
    """Structural check of a `response_format` payload
    (serving/structured.py validate_response_format)."""
    if not isinstance(rf, dict):
        return "response_format must be an object"
    t = rf.get("type")
    if t == "regex":
        if not isinstance(rf.get("pattern"), str) or not rf["pattern"]:
            return ("response_format type 'regex' requires a non-empty "
                    "string 'pattern'")
        return None
    if t == "json_schema":
        if not isinstance(rf.get("schema"), dict):
            return ("response_format type 'json_schema' requires an "
                    "object 'schema'")
        return None
    return ("response_format.type must be 'regex' or 'json_schema', "
            f"got {t!r}")


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
    engine route, unless `serving.serial_fallback`, plus the serial route.

    `device` must name the generator's device; None means the current CUDA
    device and raises without one."""

    def __init__(self, generator: Generator, tokenizer, *,
                 serving: Optional[ServingConfig] = None,
                 device: DeviceLike = None, request_timeout: float = 600.0):
        device = resolve_device(device)
        if generator.device != device:
            raise ValueError(f"generator runs on {generator.device}, the "
                             f"server on {device}")
        self.generator = generator
        self.tokenizer = tokenizer
        self.serving = (serving if serving is not None
                        else ServingConfig()).validate(generator.cfg)
        self._lock = threading.Lock()  # the serial route: one at a time
        self._request_counter = itertools.count()
        self._timeout = request_timeout
        self.engine = (None if self.serving.serial_fallback else
                       ServingEngine(generator, self.serving, device=device))

    def close(self):
        if self.engine is not None:
            self.engine.close()

    def _seed_for(self, payload) -> int:
        """An explicit random_seed stays deterministic; unseeded requests
        mix entropy with a per-process counter."""
        if payload.get("random_seed") is not None:
            return int(payload["random_seed"])
        return (secrets.randbits(31)
                ^ (next(self._request_counter) & 0x7FFFFFFF))

    def handle(self, payload) -> Tuple[int, dict]:
        """Returns (http_status, JSON-able body)."""
        if self.engine is None:
            return self._handle_serial_mode(payload)
        try:
            if isinstance(payload, dict):
                for field, msg in _LATER_ON_ENGINE:
                    if payload.get(field) not in (None, False):
                        return 400, {"message": msg}
                if any(isinstance(payload.get(f), int)
                       and payload[f] > 1 for f in ("n", "best_of")):
                    return 400, {"message": "n/best_of parallel sampling "
                                            "comes with fan-out in a later "
                                            "slice"}
            err = validate_generate_payload(payload)
            if err is not None:
                return 400, {"message": err}
            if payload.get("beam_width"):
                return 200, self._handle_beam(payload)
            if payload.get("serial"):
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
        except Exception as e:  # noqa: BLE001 — a server fault is a 500
            return 500, {"message": str(e)}

    def _handle_serial_mode(self, payload) -> Tuple[int, dict]:
        """Every payload on the serial route (`serial_fallback`), with the
        reference's statuses and messages in that mode."""
        try:
            if isinstance(payload, dict) \
                    and payload.get("prompt_tokens") is not None:
                return 400, {"message":
                             "prompt_tokens is the replica-mode wire "
                             "format (run the server with "
                             "--replica_mode); send text prompts"}
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
        return 400, {"message": "admin ops (weight swap, adapter "
                                "registration) come with live weights in a "
                                "later slice" if self.engine is not None
                     else "admin ops require the serving engine "
                          "(serial_fallback has no control plane)"}

    def healthz(self) -> Tuple[int, dict]:
        """200 while the engine accepts work, else 503, with the engine's
        health snapshot; the serial mode has no loop to probe."""
        if self.engine is None:
            return 200, {"healthy": True, "serving": "serial"}
        h = self.engine.health()
        return (200 if h["accepting"] else 503), h

    def metrics_snapshot(self) -> dict:
        if self.engine is None:
            return {"serving": "serial"}
        return self.engine.metrics.snapshot()

    def _preflight_lengths(self, payload: dict, max_total: int, what: str):
        """Tokenize and check lengths before generating, so empty or
        oversize prompts are a 400. Returns the ids (BOS applied)."""
        n = int(payload.get("tokens_to_generate", 64))
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
        payload served a row."""
        n = int(payload.get("tokens_to_generate", 64))
        sampling = SamplingOptions(
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 0.0)))
        seed = self._seed_for(payload)
        priority = int(payload.get("priority", 0) or 0)
        deadline_s = payload.get("deadline_s")
        deadline_s = None if deadline_s is None else float(deadline_s)
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
                            ids, n, sampling, seed=seed + i,
                            priority=priority, deadline_s=deadline_s)
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
            toks, gen_lps = results[i]
            texts.append(self.tokenizer.detokenize(toks))
            tokens.append(toks)
            # one value per output token; prompt positions are zero
            logprobs.append([0.0] * len(reqs[i].prompt) + gen_lps)
        out = {"text": texts, "segments": tokens}
        if payload.get("logprobs"):
            out["logprobs"] = logprobs
        return out

    def make_http_server(self, host: str, port: int) -> ThreadingHTTPServer:
        """The HTTP front end, bound but not yet serving: PUT /api and
        /admin, GET /healthz and /metrics. The caller runs
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
                if path == "/admin":
                    status, body = server.handle_admin(payload)
                else:
                    status, body = server.handle(payload)
                self._send(status, body)

            def do_GET(self):
                from urllib.parse import urlsplit
                path = urlsplit(self.path).path.rstrip("/")
                if path == "/metrics":
                    self._send(200, server.metrics_snapshot())
                elif path == "/healthz":
                    self._send(*server.healthz())
                else:
                    self.send_error(404)

            def log_message(self, fmt, *a):
                pass

        return ThreadingHTTPServer((host, port), Handler)
