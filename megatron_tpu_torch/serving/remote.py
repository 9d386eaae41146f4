"""Remote replicas: the front door across a process boundary
(megatron_tpu/serving/remote.py).

`EngineRouter` (serving/router.py) drives a duck type (`health()`,
`submit()`, `prefix_peek()`, `metrics.snapshot()`, `swap_weights()`) shaped
like the HTTP surface every server already has (`/healthz`, `/metrics`,
`PUT /api` with SSE). `RemoteReplica` speaks that surface to a standalone
`replica_mode` server process and satisfies the same duck type, so the
unchanged router becomes a front tier across processes
(`ServingConfig(fleet="host:port,...")`) with all of its machinery:

- Typed transport faults. Connection refused, reset mid-body, connect or
  read timeout, a truncated SSE stream and malformed JSON each map to a
  `RemoteTransportError` subclass, every one a `ServiceUnavailableError`
  (503, retryable), so the router's per-replica reject and missed-heartbeat
  paths and the typed-terminal invariant hold across the boundary. HTTP
  error responses map back to the typed errors the in-process engine
  raises (400 AdmissionError, 429 QueueFullError with `retry_after`,
  503/504/422), so a remote refusal reads like a local one.
- Health with per-call timeouts. `health()` is a `GET /healthz` under the
  short connect budget; any fault raises, which the router counts as a
  missed heartbeat: a dead or stopped process walks UP -> DOWN like a dead
  in-process replica, and its in-flight work is resubmitted by seed to a
  survivor, token for token.
- Streaming with bounded reconnect. `submit()` opens an SSE stream and
  reads the admission verdict before it returns (a 429/503/400 raises
  before the caller holds a future); a reader thread commits the token
  frames into a plain `GenRequest`. A transport fault mid-stream
  reconnects a bounded number of times (exponential backoff with jitter,
  `Retry-After` honoured) through the `stream_id` / `Last-Event-ID`
  resume; when the reconnects run out the attempt fails `unavailable`,
  the router's cue to resubmit elsewhere.
- Affinity over snapshots. `prefix_peek`/`adapter_peek` answer from the
  compact digest the replica serves (`GET /affinity`, the engine's
  `affinity_digest`): per-namespace cumulative CRC32 chains over its
  prefix index, refreshed on the health-poll cadence. Affinity stays a
  hint (admission resolves the real hit on the replica's engine thread),
  so a stale digest can skew a pick, never a token.

Counters (in the pinned schema, serving/metrics.py):
`router_remote_timeouts` counts calls that hit a connect or read timeout,
`router_remote_retries` transport-level retries of one HTTP call, and
`router_probe_failures` failed health probes. Whole-request failovers stay
`router_failovers`/`router_retries`.
"""
from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
import zlib
from typing import Optional, Sequence

from megatron_tpu_torch.serving.metrics import ServingMetrics
from megatron_tpu_torch.serving.request import (DeadlineExceededError,
                                                GenRequest,
                                                GrammarDeadEndError,
                                                RequestFailedError,
                                                SamplingOptions,
                                                ServiceUnavailableError)
from megatron_tpu_torch.serving.scheduler import (AdmissionError,
                                                  QueueFullError)


class RemoteTransportError(ServiceUnavailableError):
    """A transport-layer fault talking to a replica process. Subclasses
    name the fault kind; ALL of them are ServiceUnavailableError (503,
    retryable), so the typed-terminal law and the router's per-replica
    reject path hold without knowing the transport exists."""

    kind = "transport"

    def __init__(self, msg: str, status: Optional[int] = None,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


class RemoteConnectionRefusedError(RemoteTransportError):
    """TCP connect refused — the process is gone (or not yet up)."""
    kind = "refused"


class RemoteConnectionResetError(RemoteTransportError):
    """Connection reset / dropped mid-body — the process died under
    an open call."""
    kind = "reset"


class RemoteTimeoutError(RemoteTransportError):
    """Connect or read deadline exceeded — the process may be wedged
    (SIGSTOP), not dead; the router's heartbeat grace decides."""
    kind = "timeout"


class RemoteProtocolError(RemoteTransportError):
    """The bytes came back but are not the protocol: malformed JSON,
    a truncated SSE stream, a missing start frame."""
    kind = "protocol"


def _map_fault(e: Exception) -> RemoteTransportError:
    """Transport exception -> typed fault. Total: every socket/http
    failure lands in exactly one kind, never a bare exception."""
    if isinstance(e, RemoteTransportError):
        return e
    if isinstance(e, socket.timeout):
        return RemoteTimeoutError(f"timed out: {e}")
    if isinstance(e, ConnectionRefusedError):
        return RemoteConnectionRefusedError(f"connection refused: {e}")
    if isinstance(e, (ConnectionResetError, BrokenPipeError)):
        return RemoteConnectionResetError(f"connection reset: {e}")
    if isinstance(e, (http.client.IncompleteRead, http.client.BadStatusLine,
                      http.client.ResponseNotReady)):
        return RemoteConnectionResetError(f"reset mid-response: {e}")
    if isinstance(e, (json.JSONDecodeError, http.client.HTTPException)):
        return RemoteProtocolError(f"malformed response: {e}")
    if isinstance(e, OSError):
        return RemoteConnectionRefusedError(f"connect failed: {e}")
    return RemoteProtocolError(f"{type(e).__name__}: {e}")


class _WeightVersionView:
    """The (label, iteration) pair a remote health payload reports —
    enough surface for the router's rolling-upgrade bookkeeping and
    the server's per-stream version stamp."""

    __slots__ = ("label", "iteration")

    def __init__(self, label: str, iteration: int = 0):
        self.label = str(label)
        self.iteration = int(iteration)

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"_WeightVersionView({self.label!r}, {self.iteration})"


class _RemoteMetrics:
    """`engine.metrics` facade: `snapshot()` is a `GET /metrics` parsed
    to the same plain-float dict a local registry returns, so the
    router's `aggregate_snapshot` folds remote replicas by the in-process
    rules (counters summed, per-request gauges as the max, the weight
    version as min/max)."""

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica

    def snapshot(self) -> dict:
        status, _, body = self._replica._request(
            "GET", "/metrics",
            read_timeout=self._replica.connect_timeout_s)
        if status != 200 or not isinstance(body, dict):
            raise RemoteProtocolError(
                f"replica {self._replica.addr} /metrics answered "
                f"{status}: {body!r}")
        return {k: float(v) for k, v in body.items()
                if isinstance(v, (int, float))}


def _read_frame(fp) -> Optional[tuple]:
    """One SSE frame off a streaming response: (event, data, id) —
    `data` parsed as JSON. Returns None on EOF (the caller decides
    whether that EOF is clean — terminal frame already seen — or a
    TRUNCATED stream). Raises RemoteProtocolError on unparseable
    `data:`; socket faults propagate raw for `_map_fault`."""
    fields: dict = {}
    got = False
    while True:
        raw = fp.readline()
        if not raw:
            return None
        line = raw.decode("utf-8", "replace").rstrip("\r\n")
        if not line:
            if got:
                break
            continue
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        fields[k.strip()] = v.lstrip()
        got = True
    data_raw = fields.get("data", "")
    try:
        data = json.loads(data_raw) if data_raw else {}
    except json.JSONDecodeError as e:
        raise RemoteProtocolError(f"malformed SSE data frame: {e}") \
            from e
    eid = fields.get("id")
    try:
        eid = int(eid) if eid is not None else None
    except ValueError:
        eid = None
    return fields.get("event"), data, eid


def digest_peek(digest: Optional[dict], tokens: Sequence[int],
                adapter_id=None) -> int:
    """Client half of the affinity digest: recompute the cumulative
    CRC32 chain over `tokens` at the digest's block granularity and
    count consecutive blocks present in the replica's hash set —
    the remote spelling of `PrefixIndex.lookup`'s longest-prefix walk,
    capped at len(tokens)-1 like the engine's peek (one suffix token
    must still forward). Hash collisions and staleness only skew a
    routing HINT; admission re-resolves on the replica."""
    if not digest or not tokens:
        return 0
    g = int(digest.get("granularity") or 0)
    if g < 1:
        return 0
    label = "" if adapter_id is None else str(adapter_id)
    hashes = digest.get("namespaces", {}).get(label)
    if not hashes:
        return 0
    hs = set(hashes)
    limit = len(tokens) - 1
    cum, depth, best = 0, 0, 0
    while (depth + 1) * g <= limit:
        block = tokens[depth * g:(depth + 1) * g]
        cum = zlib.crc32(
            ",".join(str(int(t)) for t in block).encode(), cum)
        if cum not in hs:
            break
        depth += 1
        best = depth * g
    return best


class RemoteRequest(GenRequest):
    """One attempt's future over a remote SSE stream: a plain
    GenRequest whose tokens are committed by a background reader
    thread, so the ENTIRE caller surface the router's retry pump
    consumes (`generated`, `wait_token`, `_done`, `state`,
    `error_kind`, `result`) is inherited, not reimplemented. The
    replica's engine owns the terminal accounting (its counters feed
    the fleet conservation law); this handle only mirrors the stream."""

    def __init__(self, replica: "RemoteReplica", prompt, max_new_tokens,
                 sampling, seed, priority, deadline_s, arrival_id,
                 adapter_id, response_format):
        super().__init__(prompt, max_new_tokens, sampling, seed=seed,
                         priority=priority, deadline_s=deadline_s,
                         arrival_id=arrival_id, adapter_id=adapter_id)
        self.response_format = response_format
        self._replica = replica
        self.stream_id: Optional[str] = None
        self._conn = None
        self._resp = None
        self._reader: Optional[threading.Thread] = None

    def _attach(self, conn, resp, start: dict):
        self._conn, self._resp = conn, resp
        self.stream_id = start.get("stream_id")
        self._reader = threading.Thread(
            target=self._reader_loop, daemon=True,
            name=f"remote-sse-{self.id}")
        self._reader.start()

    def _close_conn(self):
        conn, self._conn, self._resp = self._conn, None, None
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — best-effort
                pass

    def _reader_loop(self):
        """Commit SSE frames into the inherited GenRequest state.
        Transport faults mid-stream reconnect (bounded, backoff +
        jitter, Last-Event-ID replay); a dead replica exhausts the
        reconnects and fails this ATTEMPT `unavailable` — the router's
        pump then resubmits the request token-exact by seed to a
        survivor. Every exit path is a terminal transition or a clean
        post-terminal return: no stranded futures."""
        rep = self._replica
        while True:
            try:
                frame = _read_frame(self._resp)
            except Exception as e:  # noqa: BLE001 — typed below
                fault = _map_fault(e)
                if isinstance(fault, RemoteTimeoutError):
                    rep._count("router_remote_timeouts")
                frame = None
            else:
                fault = None
            if frame is None:
                if self.done():
                    self._close_conn()
                    return  # clean EOF after the terminal frame
                # truncated stream / reset / timeout without a terminal
                # frame: the replica may be restarting — reconnect
                self._close_conn()
                if self._reconnect():
                    continue
                self.fail(
                    f"replica {rep.addr} stream lost "
                    f"({fault.kind if fault else 'truncated'}: "
                    f"{fault or 'EOF before terminal frame'}) after "
                    f"{len(self.generated)} tokens; reconnects "
                    "exhausted", kind="unavailable")
                return
            event, data, _ = frame
            if event == "token":
                idx = data.get("index")
                if idx == len(self.generated):
                    if self.admit_time is None:
                        self.mark_admitted()
                    self.append_token(int(data.get("token", 0)),
                                      float(data.get("logprob", 0.0)))
                # idx < len(generated): a replayed duplicate after an
                # imperfect resume — already committed, skip (never
                # double-append); idx > len: a gap, impossible under
                # Last-Event-ID replay, ignored defensively
            elif event == "done":
                self.finish()
                self._close_conn()
                return
            elif event == "error":
                status = int(data.get("status", 500))
                kind = ("deadline" if status == 504
                        else "grammar" if status == 422
                        else "unavailable" if status in (429, 503)
                        else "error")
                self.fail(data.get("message",
                                   f"replica error {status}"), kind=kind)
                self._close_conn()
                return
            # "start" frames (initial or post-resume) carry no tokens

    def _reconnect(self) -> bool:
        """Bounded SSE resume against the SAME replica: reopen with
        `stream_id` + `Last-Event-ID` so the replica replays the
        committed tail (no dup / no gap — the resume protocol is
        exact). Exponential backoff + jitter between attempts,
        `Retry-After` honored when the replica says it is saturated.
        False when the stream is unrecoverable HERE (process gone or
        restarted: its stream registry died with it) — failover to a
        survivor is the CALLER's move."""
        rep = self._replica
        for attempt in range(rep.max_retries + 1):
            if self.done():
                return False
            delay = min(rep.backoff_s * (2 ** attempt), 2.0)
            delay += rep._rng.uniform(0, delay)
            try:
                conn, resp, _ = rep._open_stream(
                    {"stream_id": self.stream_id, "stream": True},
                    headers={"Last-Event-ID":
                             str(len(self.generated) - 1)},
                    retries=0)
            except RemoteTransportError as e:
                rep._count("router_remote_retries")
                if e.retry_after:
                    delay = max(delay, float(e.retry_after))
                time.sleep(delay)
                continue
            except Exception:  # noqa: BLE001 — HTTP-typed (404/400/...)
                # the replica answered but refused the resume: its
                # registry no longer knows this stream (process
                # restarted) — unrecoverable here, resubmit elsewhere
                return False
            self._conn, self._resp = conn, resp
            rep._count("router_remote_retries")
            return True
        return False


class RemoteReplica:
    """HTTP client handle over one `--replica_mode` server process,
    satisfying the engine duck type `EngineRouter` consumes (module
    docstring). Construct with a SHARED `counters` registry (the
    router's) so transport-fault counters aggregate fleet-wide;
    `metrics` stays the REMOTE snapshot facade the aggregate sums."""

    def __init__(self, addr: str, counters: Optional[ServingMetrics]
                 = None, connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 30.0, max_retries: int = 2,
                 digest_interval_s: float = 2.0,
                 backoff_s: float = 0.05):
        host, _, port = addr.rpartition(":")
        assert host and port, f"replica address {addr!r} must be host:port"
        self.addr = addr
        self.host, self.port = host, int(port)
        self.counters = counters
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        self.max_retries = max(int(max_retries), 0)
        self.digest_interval_s = float(digest_interval_s)
        self.backoff_s = float(backoff_s)
        self.metrics = _RemoteMetrics(self)
        # jitter source: seeded per handle for stable tests; jitter
        # shifts WHEN a retry fires, never WHICH tokens a stream holds
        self._rng = random.Random(zlib.crc32(addr.encode()))
        self._last_health: dict = {}
        self._digest: Optional[dict] = None
        self._digest_t = 0.0
        self._max_len: Optional[int] = None
        self._lock = threading.Lock()

    # ---- transport core ----------------------------------------------
    def _count(self, name: str):
        if self.counters is not None:
            self.counters.count(name)

    def _connect(self, read_timeout: Optional[float] = None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.connect_timeout_s)
        try:
            conn.connect()
            conn.sock.settimeout(read_timeout if read_timeout is not None
                                 else self.read_timeout_s)
        except Exception as e:  # noqa: BLE001 — typed below
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            fault = _map_fault(e)
            if isinstance(fault, RemoteTimeoutError):
                self._count("router_remote_timeouts")
            raise fault from e
        return conn

    def _request(self, method: str, path: str, body: Optional[dict]
                 = None, headers: Optional[dict] = None,
                 read_timeout: Optional[float] = None) -> tuple:
        """One JSON call: (status, response-headers, parsed body).
        Transport faults raise typed; a non-JSON body raises
        RemoteProtocolError. No retries here — callers that may
        safely re-issue (idempotent GETs, stream resumes) own their
        own bounded loops."""
        conn = self._connect(read_timeout=read_timeout)
        try:
            conn.request(
                method, path,
                body=json.dumps(body) if body is not None else None,
                headers=dict({"Content-Type": "application/json"},
                             **(headers or {})))
            resp = conn.getresponse()
            status = resp.status
            hdrs = {k.lower(): v for k, v in resp.getheaders()}
            raw = resp.read()
        except Exception as e:  # noqa: BLE001 — typed below
            fault = _map_fault(e)
            if isinstance(fault, RemoteTimeoutError):
                self._count("router_remote_timeouts")
            raise fault from e
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
        try:
            parsed = json.loads(raw) if raw else {}
        except json.JSONDecodeError as e:
            raise RemoteProtocolError(
                f"replica {self.addr} {path} answered non-JSON "
                f"({raw[:64]!r}): {e}", status=status) from e
        return status, hdrs, parsed

    def _http_error(self, status: int, body, headers: dict) -> Exception:
        """Map a non-200 JSON response to the SAME typed error the
        in-process engine raises, `Retry-After` preserved — a remote
        rejection must be indistinguishable from a local one."""
        msg = (body.get("message", f"HTTP {status}")
               if isinstance(body, dict) else f"HTTP {status}")
        msg = f"replica {self.addr}: {msg}"
        ra = (body.get("retry_after") if isinstance(body, dict) else None) \
            or headers.get("retry-after")
        ra = float(ra) if ra is not None else None
        if status == 400:
            return AdmissionError(msg)
        if status == 429:
            return QueueFullError(
                msg, retry_after=int(ra) if ra else None,
                queue_depth=(body.get("queue_depth")
                             if isinstance(body, dict) else None))
        if status == 503:
            e = ServiceUnavailableError(msg)
            e.retry_after = ra
            return e
        if status == 504:
            return DeadlineExceededError(msg)
        if status == 422:
            return GrammarDeadEndError(msg)
        return RequestFailedError(msg)

    def _get_json(self, path: str, read_timeout: Optional[float] = None,
                  retries: Optional[int] = None) -> dict:
        """Idempotent GET with bounded transport retries (exponential
        backoff + jitter, Retry-After honored on 429/503)."""
        retries = self.max_retries if retries is None else retries
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            if attempt:
                self._count("router_remote_retries")
                delay = min(self.backoff_s * (2 ** (attempt - 1)), 2.0)
                delay += self._rng.uniform(0, delay)
                if isinstance(last, (RemoteTransportError,
                                     QueueFullError)) \
                        and getattr(last, "retry_after", None):
                    delay = max(delay, float(last.retry_after))
                time.sleep(delay)
            try:
                status, hdrs, body = self._request(
                    "GET", path, read_timeout=read_timeout)
            except RemoteTransportError as e:
                last = e
                continue
            if status != 200:
                err = self._http_error(status, body, hdrs)
                if status in (429, 503):
                    last = err
                    continue
                raise err
            if not isinstance(body, dict):
                raise RemoteProtocolError(
                    f"replica {self.addr} {path}: expected a JSON "
                    f"object, got {type(body).__name__}")
            return body
        raise last  # type: ignore[misc]

    # ---- engine duck type --------------------------------------------
    def health(self) -> dict:
        """GET /healthz with the SHORT (connect-sized) read budget — a
        wedged process must miss its heartbeat within the router's
        grace, not hold the probe thread for a full read timeout.
        Returns the payload for ANY status (a 503 payload still
        carries the state fields the router classifies on); every
        transport fault counts `router_probe_failures` and raises,
        which the router treats as a missed heartbeat."""
        try:
            status, hdrs, body = self._request(
                "GET", "/healthz", read_timeout=self.connect_timeout_s)
        except RemoteTransportError:
            self._count("router_probe_failures")
            raise
        if not isinstance(body, dict) or "state" not in body:
            self._count("router_probe_failures")
            raise RemoteProtocolError(
                f"replica {self.addr} /healthz answered {status} with "
                f"no health payload: {body!r}")
        with self._lock:
            self._last_health = body
            if body.get("max_len"):
                self._max_len = int(body["max_len"])
        self._maybe_refresh_digest()
        return body

    def _maybe_refresh_digest(self):
        now = time.monotonic()
        with self._lock:
            if now - self._digest_t < self.digest_interval_s:
                return
            self._digest_t = now  # claim the slot even on failure
        try:
            d = self._get_json("/affinity",
                               read_timeout=self.connect_timeout_s,
                               retries=0)
        except Exception:  # noqa: BLE001 — the digest is a hint
            return
        with self._lock:
            self._digest = d

    @property
    def max_len(self) -> int:
        """The replica's admission bound, learned from its health
        payload. Unreachable-at-boot replicas answer a no-op bound
        (the router takes the fleet MIN, so any reachable replica's
        real bound wins; a lone unreachable fleet defers the length
        check to per-request admission, which 400s exactly)."""
        if self._max_len is None:
            try:
                self.health()
            except Exception:  # noqa: BLE001 — down at boot
                pass
        return self._max_len if self._max_len is not None else 1 << 30

    @property
    def weight_version(self) -> Optional[_WeightVersionView]:
        h = self._last_health
        if not h:
            return None
        return _WeightVersionView(h.get("weight_version", "unversioned"),
                                  h.get("weight_iteration", 0))

    def queue_depth(self) -> int:
        return int(self._last_health.get("queue_depth", 0) or 0)

    def prefix_peek(self, tokens: Sequence[int], adapter_id=None) -> int:
        with self._lock:
            digest = self._digest
        return digest_peek(digest, tokens, adapter_id)

    def affinity_digest(self) -> dict:
        """The replica's digest as this client last read it (refreshed on
        the health cadence), so a router over remote replicas can merge
        them for a tier further out; empty before the first read."""
        with self._lock:
            digest = self._digest
        return dict(digest) if digest else {"granularity": 0,
                                            "namespaces": {}, "adapters": {}}

    def adapter_peek(self, adapter_id) -> int:
        if adapter_id is None:
            return 0
        with self._lock:
            digest = self._digest
        if not digest:
            return 0
        return int(digest.get("adapters", {}).get(str(adapter_id), 0))

    # ---- submit / streaming ------------------------------------------
    def _open_stream(self, payload: dict, headers: Optional[dict] = None,
                     retries: Optional[int] = None) -> tuple:
        """PUT /api with `stream: true`; the admission verdict is read
        SYNCHRONOUSLY (a non-SSE response maps to the typed local
        error; the SSE `start` frame must arrive before this returns),
        so callers get submit-time semantics identical to the
        in-process engine. Connect-phase faults retry bounded; once
        bytes flow, faults raise — the replica may have admitted, and
        a blind re-issue would double-submit."""
        retries = self.max_retries if retries is None else retries
        last: Optional[RemoteTransportError] = None
        for attempt in range(retries + 1):
            if attempt:
                self._count("router_remote_retries")
                delay = min(self.backoff_s * (2 ** (attempt - 1)), 2.0)
                time.sleep(delay + self._rng.uniform(0, delay))
            try:
                conn = self._connect()
            except RemoteTransportError as e:
                last = e
                continue
            try:
                conn.request("PUT", "/api", body=json.dumps(payload),
                             headers=dict({"Content-Type":
                                           "application/json"},
                                          **(headers or {})))
                resp = conn.getresponse()
            except Exception as e:  # noqa: BLE001 — typed below
                conn.close()
                last = _map_fault(e)
                if isinstance(last, RemoteTimeoutError):
                    self._count("router_remote_timeouts")
                continue
            ctype = resp.getheader("Content-Type", "") or ""
            if "text/event-stream" not in ctype:
                # admission refused: JSON body with the typed status
                hdrs = {k.lower(): v for k, v in resp.getheaders()}
                try:
                    body = json.loads(resp.read() or b"{}")
                except Exception as e:  # noqa: BLE001
                    conn.close()
                    raise RemoteProtocolError(
                        f"replica {self.addr} refused the stream with "
                        f"unparseable body: {e}",
                        status=resp.status) from e
                conn.close()
                raise self._http_error(resp.status, body, hdrs)
            try:
                frame = _read_frame(resp)
            except Exception as e:  # noqa: BLE001 — typed below
                conn.close()
                fault = _map_fault(e)
                if isinstance(fault, RemoteTimeoutError):
                    self._count("router_remote_timeouts")
                raise fault from e
            if frame is None or frame[0] != "start" \
                    or "stream_id" not in frame[1]:
                conn.close()
                raise RemoteProtocolError(
                    f"replica {self.addr}: SSE stream truncated before "
                    f"its start frame (got {frame!r})")
            return conn, resp, frame[1]
        raise last  # type: ignore[misc]

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               sampling: SamplingOptions = SamplingOptions(),
               seed: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None,
               arrival_id: Optional[int] = None, adapter_id=None,
               response_format=None, n: int = 1,
               best_of: Optional[int] = None) -> RemoteRequest:
        if (best_of or n or 1) > 1:
            raise AdmissionError(
                "parallel sampling (n/best_of > 1) is not supported "
                "over the remote replica protocol; fan out client-side "
                "with n=1 requests")
        payload: dict = {
            "prompt_tokens": [[int(t) for t in prompt]],
            "tokens_to_generate": int(max_new_tokens),
            "temperature": float(sampling.temperature),
            "top_k": int(sampling.top_k),
            "top_p": float(sampling.top_p),
            "random_seed": int(seed),
            "priority": int(priority),
            "logprobs": True,
            "stream": True,
        }
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        if arrival_id is not None:
            payload["arrival_id"] = int(arrival_id)
        if adapter_id is not None:
            payload["adapter_id"] = adapter_id
        if response_format is not None:
            payload["response_format"] = response_format
        conn, resp, start = self._open_stream(payload)
        req = RemoteRequest(self, list(prompt), max_new_tokens, sampling,
                            seed, priority, deadline_s, arrival_id,
                            adapter_id, response_format)
        req._attach(conn, resp, start)
        return req

    def cancel(self, req: RemoteRequest):
        """Best-effort remote cancel: flag locally (the router's
        bookkeeping reads `cancelled`), then ask the replica to evict —
        a dead replica's stream fails `unavailable` on its own and the
        cancelled flag keeps the router from resubmitting it."""
        req.cancel()
        sid = getattr(req, "stream_id", None)
        if sid is None:
            return
        try:
            self._request("PUT", "/api",
                          {"stream_id": sid, "cancel": True},
                          read_timeout=self.connect_timeout_s)
        except Exception:  # noqa: BLE001 — best-effort
            pass

    # ---- fleet control plane -----------------------------------------
    def swap_weights(self, ckpt_dir: str,
                     timeout: Optional[float] = None, staged=None):
        """Drive the replica's own hot swap over the wire. `staged`
        host buffers cannot cross a process boundary and are IGNORED —
        the replica stages itself from `ckpt_dir` (shared storage),
        paying one disk read per process instead of zero; the manifest
        gate and recompile-free flip run exactly as locally."""
        budget = (float(timeout) if timeout else 120.0) + 60.0
        status, hdrs, body = self._request(
            "PUT", "/admin",
            {"op": "swap_weights", "ckpt_dir": str(ckpt_dir),
             "timeout": timeout}, read_timeout=budget)
        if status != 200 or not isinstance(body, dict):
            raise self._http_error(status, body, hdrs)
        return _WeightVersionView(body.get("label", "unversioned"),
                                  body.get("iteration", 0))

    def register_adapter(self, adapter_id, path: Optional[str] = None,
                         factors=None, rank: Optional[int] = None,
                         alpha: float = 1.0):
        if factors is not None:
            raise AdmissionError(
                "in-memory adapter factors cannot cross the process "
                "boundary; register remote adapters by path "
                "(shared storage)")
        status, hdrs, body = self._request(
            "PUT", "/admin",
            {"op": "register_adapter", "adapter_id": adapter_id,
             "path": path, "rank": rank, "alpha": alpha})
        if status != 200:
            raise self._http_error(status, body, hdrs)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Fleet drain (front-tier SIGTERM): ask the replica to stop
        admitting and finish in-flight work. An unreachable replica
        has nothing left to drain — True, like a dead local engine."""
        budget = (float(timeout) if timeout else 120.0) + 30.0
        try:
            status, _, body = self._request(
                "PUT", "/admin", {"op": "drain", "timeout": timeout},
                read_timeout=budget)
        except RemoteTransportError:
            return True
        if status != 200 or not isinstance(body, dict):
            return False
        return bool(body.get("drained", False))

    def invariant_report(self, strict: bool = True) -> dict:
        """GET /invariants: the replica runs its OWN sweep on its live
        objects (KV accounting and in-flight walks cannot cross the
        wire) and serves the report — `check_all`'s fleet mode folds
        each replica's violations into the fleet sweep."""
        body = self._get_json(f"/invariants?strict={int(bool(strict))}",
                              read_timeout=max(self.read_timeout_s, 60.0))
        if "violations" not in body or "laws_checked" not in body:
            raise RemoteProtocolError(
                f"replica {self.addr} /invariants report malformed: "
                f"{body!r}")
        return body

    def close(self):
        """A remote replica is an independent process — the front tier
        closing does NOT stop it (ops owns its lifecycle); only local
        client state drops."""
        with self._lock:
            self._digest = None
            self._last_health = {}

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"RemoteReplica({self.addr!r})"
