"""Online serving front end: HTTP + SSE streaming over MultiModelServer
(port of ``repro.serving.server``, the same wire behaviour).

Two layers, both stdlib-only (``http.server``/``socketserver`` threads —
no new runtime deps):

* ``ServingFrontend`` — the tick loop that turns the library engine into
  a live service.  Engines are NOT thread-safe, so every engine mutation
  — and every CUDA tensor an engine makes or launches on — happens on ONE
  background thread: HTTP handler threads enqueue ops
  (submit / cancel / summary) and block on a tiny future while the loop
  interleaves them with ``MultiModelServer.step()`` — continuous
  arrivals admit and retire between decode steps, exactly the join
  semantics the engine already guarantees token-identity for.  The loop
  drains completions every tick (``drain_completed``), so a server
  surviving millions of requests holds steady memory.
* ``HydraHTTPServer`` — an OpenAI-compatible wire surface on top:
  ``POST /v1/completions`` and ``POST /v1/chat/completions`` (with
  ``"stream": true`` for SSE token streaming), ``POST /v1/cancel`` and
  ``DELETE /v1/requests/<id>`` for first-class cancellation, plus
  ``GET /v1/models`` / ``GET /v1/metrics`` / ``GET /health``.  A client
  that disconnects mid-stream triggers the same ``cancel`` path — the
  SSE writer probes the socket with keep-alive comments while decode is
  quiet, so a dead peer frees its lane and KV reservation within a tick
  even when no token is flowing.

The models here have no tokenizer, so the wire speaks token ids:
``prompt`` accepts a list of ints (used verbatim) or a string (byte-level
stand-in encoding, ``byte % vocab_size``); completions stream each token
id as the text chunk ``" <id>"`` plus a structured ``token_id`` field.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Callable, Optional

import numpy as np

import torch

from repro_torch.serving.multi import MultiModelServer
from repro_torch.serving.request import Request, Status
from repro_torch.serving.slo import OverloadedError

_FINISH_REASON = {Status.FINISHED: "stop", Status.CANCELLED: "cancelled",
                  Status.REJECTED: "rejected"}


def encode_prompt(prompt: Any, vocab_size: int) -> np.ndarray:
    """Token ids pass through; strings get the byte-level stand-in
    encoding (documented in docs/serving.md — the repo has no tokenizer)."""
    if isinstance(prompt, str):
        if not prompt:
            raise ValueError("empty prompt")
        return (np.frombuffer(prompt.encode("utf-8"), np.uint8)
                .astype(np.int32) % vocab_size)
    arr = np.asarray(prompt, np.int32).reshape(-1)
    if arr.size == 0:
        raise ValueError("empty prompt")
    if (arr < 0).any() or (arr >= vocab_size).any():
        raise ValueError(f"prompt token ids must be in [0, {vocab_size})")
    return arr


@dataclass
class _Op:
    """One engine mutation shipped to the tick thread; a minimal future."""
    fn: Callable[[], Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class ServingFrontend:
    """Single-threaded engine loop + thread-safe submit/cancel surface.

    ``model_options`` (per routing name) carries the ServeJob-level HTTP
    fields: ``{"stream": bool, "endpoint": str | None}`` — whether SSE
    streaming is offered for the model, and an optional extra alias
    clients may pass as ``"model"``.
    """

    def __init__(self, server: MultiModelServer, *,
                 model_options: Optional[dict[str, dict]] = None,
                 idle_wait_s: float = 0.002, op_timeout_s: float = 120.0):
        self.server = server
        self.model_options = dict(model_options or {})
        self.idle_wait_s = idle_wait_s
        self.op_timeout_s = op_timeout_s
        self._aliases: dict[str, str] = {}
        for name, opts in self.model_options.items():
            alias = (opts or {}).get("endpoint")
            if not alias:
                continue
            if alias in server.engines or \
                    self._aliases.get(alias, name) != name:
                raise ValueError(
                    f"endpoint alias {alias!r} collides with an existing "
                    "model name or alias")
            self._aliases[alias] = name
        self._ops: Queue[_Op] = Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters (one writer: the tick thread)
        self.n_submitted = 0
        self.n_completed = 0
        self.n_cancelled = 0
        self.ticks = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(target=self._loop,
                                        args=(self._cuda_devices(),),
                                        name="hydra-serve-tick", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- tick loop (the ONLY thread that touches engines) --------------------
    def _cuda_devices(self) -> list[int]:
        """The engines' CUDA device indices, read on the caller's thread
        (an index-less ``"cuda"`` means that thread's current device)."""
        return sorted({eng.device.index if eng.device.index is not None
                       else torch.cuda.current_device()
                       for eng in self.server.engines.values()
                       if eng.device.type == "cuda"})

    def _loop(self, cuda: list[int]) -> None:
        if cuda:
            # this thread's current device is the engines': every tensor an
            # op makes and every launch it issues land there, on this
            # thread's stream, never on a handler thread's
            torch.cuda.set_device(cuda[0])
        try:
            self._tick_until_stopped()
        finally:
            # leave no queued CUDA work behind the thread
            for dev in cuda:
                torch.cuda.synchronize(dev)

    def _tick_until_stopped(self) -> None:
        while not self._stop.is_set():
            ran_op = self._drain_ops()
            stepped = self.server.step()
            if stepped is not None:
                self.ticks += 1
            for done in self.server.drain_completed().values():
                for req in done:
                    self.n_completed += 1
                    if req.status is Status.CANCELLED:
                        self.n_cancelled += 1
            if stepped is None and not ran_op:
                self._wake.wait(self.idle_wait_s)
                self._wake.clear()
        self._drain_ops()        # never strand a blocked handler thread

    def _drain_ops(self) -> bool:
        ran = False
        while True:
            try:
                op = self._ops.get_nowait()
            except Empty:
                return ran
            ran = True
            try:
                op.result = op.fn()
            except BaseException as e:      # delivered to the caller
                op.error = e
            op.done.set()

    def _call(self, fn: Callable[[], Any]) -> Any:
        if self._thread is None or not self._thread.is_alive():
            raise RuntimeError("serving frontend is not running")
        op = _Op(fn)
        self._ops.put(op)
        self._wake.set()
        if not op.done.wait(self.op_timeout_s):
            raise TimeoutError(
                f"engine loop did not pick up the request within "
                f"{self.op_timeout_s}s")
        if op.error is not None:
            raise op.error
        return op.result

    # -- public surface (any thread) -----------------------------------------
    def resolve_model(self, name: str) -> str:
        target = self._aliases.get(name, name)
        if target not in self.server.engines:
            known = sorted(self.server.engines) + sorted(self._aliases)
            raise KeyError(f"unknown model {name!r} (serving {known})")
        return target

    def streaming_allowed(self, model: str) -> bool:
        return bool(self.model_options.get(model, {}).get("stream", True))

    def engine_cfg(self, model: str):
        return self.server.engines[model].cfg

    def submit(self, model: str, prompt, max_new_tokens: int, *,
               request_id: str = "", eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[str] = None,
               max_ttft_ms: Optional[float] = None) -> Request:
        """Thread-safe submit; always attaches a TokenStream (the HTTP
        layer consumes it even for non-streaming responses)."""
        def _do():
            req = self.server.submit(model, prompt, max_new_tokens,
                                     request_id=request_id, eos_id=eos_id,
                                     deadline_ms=deadline_ms,
                                     priority=priority,
                                     max_ttft_ms=max_ttft_ms,
                                     stream=True)
            self.n_submitted += 1
            return req
        return self._call(_do)

    def cancel(self, request_id: str) -> bool:
        return self._call(lambda: self.server.cancel(request_id))

    def metrics(self) -> dict:
        def _do():
            return {
                "n_submitted": self.n_submitted,
                "n_completed": self.n_completed,
                "n_cancelled": self.n_cancelled,
                # SLO outcomes, aggregated across engines (per-request
                # deadline_met/preemptions ride in recent_requests)
                "n_preempted": sum(e.n_preempted
                                   for e in self.server.engines.values()),
                "n_resumed": sum(e.n_resumed
                                 for e in self.server.engines.values()),
                "n_shed": sum(e.n_shed
                              for e in self.server.engines.values()),
                "ticks": self.ticks,
                "engines": {name: eng.summary()
                            for name, eng in self.server.engines.items()},
                "recent_requests": {
                    name: eng.recent_metrics()
                    for name, eng in self.server.engines.items()},
            }
        return self._call(_do)


# ---------------------------------------------------------------------------
# HTTP layer (OpenAI-compatible wire shape + SSE)
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    """One request per connection (HTTP/1.0 close-delimited — SSE needs
    no chunked framing that way).  ``frontend`` is bound by the server."""

    frontend: ServingFrontend = None        # type: ignore[assignment]
    server_version = "hydra-serve/1.0"
    # SSE keep-alive probe period: with no token flowing, a comment line
    # is written this often — a dead socket raises and cancels the request
    ping_every_s = 0.25

    def log_message(self, fmt, *args):      # quiet by default
        pass

    # -- helpers -------------------------------------------------------------
    def _json(self, status: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str) -> None:
        self._json(status, {"error": {"message": message,
                                      "type": "invalid_request_error"}})

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        obj = json.loads(raw.decode("utf-8"))
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    # -- routing -------------------------------------------------------------
    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            fe = self.frontend
            data = [{"id": name, "object": "model", "owned_by": "hydra",
                     "backend": eng.backend.name,
                     **{k: v for k, v in
                        fe.model_options.get(name, {}).items()}}
                    for name, eng in fe.server.engines.items()]
            self._json(200, {"object": "list", "data": data})
        elif self.path == "/v1/metrics":
            self._json(200, self.frontend.metrics())
        else:
            self._error(404, f"no route {self.path!r}")

    def do_DELETE(self):
        if self.path.startswith("/v1/requests/"):
            rid = self.path[len("/v1/requests/"):]
            found = self.frontend.cancel(rid)
            self._json(200 if found else 404,
                       {"request_id": rid, "cancelled": found})
        else:
            self._error(404, f"no route {self.path!r}")

    def do_POST(self):
        try:
            body = self._body()
        except (ValueError, json.JSONDecodeError) as e:
            return self._error(400, f"bad JSON body: {e}")
        if self.path == "/v1/completions":
            self._completion(body, chat=False)
        elif self.path == "/v1/chat/completions":
            self._completion(body, chat=True)
        elif self.path == "/v1/cancel":
            rid = str(body.get("request_id", ""))
            found = self.frontend.cancel(rid)
            self._json(200 if found else 404,
                       {"request_id": rid, "cancelled": found})
        else:
            self._error(404, f"no route {self.path!r}")

    # -- completions ---------------------------------------------------------
    def _completion(self, body: dict, *, chat: bool) -> None:
        fe = self.frontend
        try:
            model = fe.resolve_model(str(body.get("model", "")))
        except KeyError as e:
            return self._error(404, str(e))
        want_stream = bool(body.get("stream", False))
        if want_stream and not fe.streaming_allowed(model):
            return self._error(
                400, f"model {model!r} is served with stream=False "
                "(ServeJob.stream); request a non-streaming completion")
        try:
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    raise ValueError("chat needs a non-empty 'messages'")
                raw: Any = "".join(str(m.get("content", ""))
                                   for m in messages)
            else:
                raw = body.get("prompt")
            vocab = fe.engine_cfg(model).vocab_size
            prompt = encode_prompt(raw, vocab)
            max_tokens = int(body.get("max_tokens", 16))
            eos_id = body.get("eos_id")
            # SLO fields (serving/slo.py): nonsense values raise
            # ValueError from SLO.validate -> HTTP 400 with the
            # actionable message, same as every other body error
            deadline_ms = body.get("deadline_ms")
            max_ttft_ms = body.get("max_ttft_ms")
            priority = body.get("priority")
            req = fe.submit(model, prompt, max_tokens,
                            request_id=str(body.get("request_id", "")),
                            eos_id=None if eos_id is None else int(eos_id),
                            deadline_ms=(None if deadline_ms is None
                                         else float(deadline_ms)),
                            priority=(None if priority is None
                                      else str(priority)),
                            max_ttft_ms=(None if max_ttft_ms is None
                                         else float(max_ttft_ms)))
        except OverloadedError as e:
            # shed at the door: structured 429 so clients can back off
            # or retry at a higher priority
            return self._json(429, {"error": {
                "message": str(e), "type": "overloaded",
                "code": 429, **e.payload}})
        except (TypeError, ValueError) as e:
            return self._error(400, str(e))
        if want_stream:
            self._stream_sse(req, model, chat=chat)
        else:
            self._respond_full(req, model, chat=chat)

    @staticmethod
    def _chunk(req: Request, model: str, *, chat: bool, tok: Optional[int],
               finish: Optional[str]) -> dict:
        piece = "" if tok is None else f" {tok}"
        choice: dict[str, Any] = {"index": 0, "finish_reason": finish}
        if tok is not None:
            choice["token_id"] = tok
        if chat:
            choice["delta"] = ({"content": piece} if tok is not None else {})
            obj = "chat.completion.chunk"
        else:
            choice["text"] = piece
            obj = "text_completion"
        return {"id": req.request_id, "object": obj, "model": model,
                "choices": [choice]}

    def _stream_sse(self, req: Request, model: str, *, chat: bool) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        stream = req.stream
        try:
            while True:
                try:
                    tok = stream.get(timeout=self.ping_every_s)
                except StopIteration:
                    break
                if tok is None:             # no token yet: probe the socket
                    self.wfile.write(b": ping\n\n")
                    self.wfile.flush()
                    continue
                data = json.dumps(self._chunk(req, model, chat=chat,
                                              tok=tok, finish=None))
                self.wfile.write(f"data: {data}\n\n".encode())
                self.wfile.flush()
            final = self._chunk(req, model, chat=chat, tok=None,
                                finish=self._finish_reason(req))
            final["usage"] = {"prompt_tokens": req.prompt_len,
                              "completion_tokens": len(req.generated),
                              "total_tokens": req.prompt_len
                              + len(req.generated)}
            final["metrics"] = req.metrics()
            self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream: withdraw the request so its
            # lane + KV reservation free within one tick
            self.frontend.cancel(req.request_id)

    def _respond_full(self, req: Request, model: str, *, chat: bool) -> None:
        toks = list(req.stream)             # blocks until the stream closes
        text = "".join(f" {t}" for t in toks)
        finish = self._finish_reason(req)
        choice: dict[str, Any] = {"index": 0, "finish_reason": finish,
                                  "token_ids": toks}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
            obj = "chat.completion"
        else:
            choice["text"] = text
            obj = "text_completion"
        self._json(200, {
            "id": req.request_id, "object": obj, "model": model,
            "choices": [choice],
            "usage": {"prompt_tokens": req.prompt_len,
                      "completion_tokens": len(toks),
                      "total_tokens": req.prompt_len + len(toks)},
            "metrics": req.metrics()})

    @staticmethod
    def _finish_reason(req: Request) -> str:
        reason = _FINISH_REASON.get(req.status, "length")
        if reason == "stop" and req.eos_id is not None and req.generated \
                and req.generated[-1] == req.eos_id:
            return "stop"
        return "length" if reason == "stop" else reason


class HydraHTTPServer:
    """The deployable wrapper: frontend tick loop + threaded HTTP server.

        server = HydraHTTPServer(MultiModelServer({...}), port=8000)
        with server:                     # or .start() / .stop()
            print(server.url)            # http://127.0.0.1:8000
            ...

    ``port=0`` binds an ephemeral port (tests / benches); ``url`` reports
    the bound address either way.
    """

    def __init__(self, server: MultiModelServer, *, host: str = "127.0.0.1",
                 port: int = 0,
                 model_options: Optional[dict[str, dict]] = None):
        self.frontend = ServingFrontend(server, model_options=model_options)
        handler = type("BoundHandler", (_Handler,),
                       {"frontend": self.frontend})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "HydraHTTPServer":
        self.frontend.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="hydra-serve-http", daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
            self._http_thread = None
        self.frontend.stop()

    def serve_forever(self) -> None:
        """Blocking entry point for the CLI (Ctrl-C stops cleanly)."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def __enter__(self) -> "HydraHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
