"""REST text-generation server, serial and beam routes
(megatron_tpu/inference/server.py).

The `/api` PUT contract is the reference's: {"prompts": [...],
"tokens_to_generate": N, "temperature", "top_k", "top_p", "logprobs",
"random_seed", "add_BOS", "beam_width", "length_penalty"} -> {"text",
"segments", "logprobs"} or, for beam search, {"text", "score"}. Requests
run one at a time under a lock: the reference's serial route
(`ServingConfig(serial_fallback=True)`). Status codes and messages are the
reference server's in that mode; a payload that needs the continuous-
batching engine (`stream`, `n`/`best_of`, `response_format`, `adapter_id`,
`prompt_tokens`, `cancel`) gets the same 400 it gives there. The engine
itself is ported in a later slice.

The transport is the standard library's threading HTTP server.
"""
from __future__ import annotations

import itertools
import json
import math
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from megatron_tpu_torch.inference.api import (beam_search_and_post_process,
                                              generate_and_post_process)
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

MAX_PROMPTS = 128


class AdmissionError(ValueError):
    """A request that can never be served (empty or oversize prompt): 400."""


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
    """Serial text-generation server over one Generator.

    `device` must name the generator's device; None means the current CUDA
    device and raises without one."""

    def __init__(self, generator: Generator, tokenizer, *,
                 device: DeviceLike = None):
        device = resolve_device(device)
        if generator.device != device:
            raise ValueError(f"generator runs on {generator.device}, the "
                             f"server on {device}")
        self.generator = generator
        self.tokenizer = tokenizer
        self._lock = threading.Lock()  # one request at a time
        self._request_counter = itertools.count()

    def _seed_for(self, payload) -> int:
        """An explicit random_seed stays deterministic; unseeded requests
        mix entropy with a per-process counter."""
        if payload.get("random_seed") is not None:
            return int(payload["random_seed"])
        return (secrets.randbits(31)
                ^ (next(self._request_counter) & 0x7FFFFFFF))

    def handle(self, payload) -> Tuple[int, dict]:
        """Returns (http_status, JSON-able body)."""
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

    def handle_admin(self, payload) -> Tuple[int, dict]:
        return 400, {"message": "admin ops require the serving "
                                "engine (serial_fallback has no "
                                "control plane)"}

    def healthz(self) -> Tuple[int, dict]:
        return 200, {"healthy": True, "serving": "serial"}

    def metrics_snapshot(self) -> dict:
        return {"serving": "serial"}

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
