"""The port's HTTP + SSE front end (``repro_torch.serving.server``): the
seven cases of ``tests/test_http_server.py`` on the port, plus the
``DELETE`` route and ``/v1/metrics`` returning to its baseline.

The served model is qwen3-0.6b smoke in f32 with the JAX package's
weights (``_torch_weights.both_params``), so the tokens can be held to the
JAX engine's: the SSE chunks carry exactly the tokens the engine decodes,
byte for byte the non-streaming completion's, the port's offline decode's
and the JAX engine's offline decode's; a client that disconnects
mid-stream has its request cancelled and its lane freed within a tick;
per-request metrics match external timings under a frozen clock.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import functools
import http.client
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.serving import (HydraHTTPServer, InferenceEngine,
                                 MultiModelServer, Status, TokenStream,
                                 encode_prompt)

MAX_SEQ = 64


@functools.lru_cache(maxsize=None)
def _dense():
    """(jax cfg, jax params, port cfg, port params): same f32 weights."""
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    jparams, params = both_params(jcfg, cfg, 0)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def served():
    """One live HTTP server over two engines (same params): ``m`` streams
    and has a route alias, ``locked`` is served with streaming disabled."""
    _, _, cfg, params = _dense()
    eng = InferenceEngine(cfg, params, capacity=2, max_seq=MAX_SEQ,
                          model_name="m", device="cpu")
    locked = InferenceEngine(cfg, params, capacity=1, max_seq=MAX_SEQ,
                             model_name="locked", device="cpu")
    srv = HydraHTTPServer(
        MultiModelServer({"m": eng, "locked": locked}),
        model_options={"m": {"stream": True, "endpoint": "alias-m"},
                       "locked": {"stream": False}})
    with srv:
        yield srv, cfg, params, eng


def _prompt(cfg, seed, plen=8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, plen).astype(np.int32)


def _request(srv, method, path, body=None):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def _post(srv, path, body):
    return _request(srv, "POST", path, body)


def _stream_lines(srv, path, body, *, close_after=None):
    """POST an SSE request; returns the raw ``data:`` payload list (or a
    truncated one when ``close_after`` token chunks, closing the socket)."""
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    payloads, n_tokens = [], 0
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.rstrip(b"\n")
            if not line or line.startswith(b":"):
                continue
            assert line.startswith(b"data: ")      # SSE framing
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                payloads.append("[DONE]")
                break
            event = json.loads(data)
            payloads.append(event)
            if "token_id" in event["choices"][0]:
                n_tokens += 1
                if close_after is not None and n_tokens >= close_after:
                    return payloads
    finally:
        conn.close()
    return payloads


def _port_offline(cfg, params, prompt, gen):
    """The port's engine decoding the prompt alone."""
    eng = InferenceEngine(cfg, params, capacity=1, max_seq=MAX_SEQ,
                          device="cpu")
    req = eng.submit(prompt, gen)
    eng.run()
    return list(map(int, req.generated))


def _jax_offline(prompt, gen):
    """The JAX engine decoding the prompt alone, same weights."""
    jcfg, jparams, _, _ = _dense()
    eng = JEngine(jcfg, jparams, capacity=1, max_seq=MAX_SEQ)
    req = eng.submit(prompt, gen)
    eng.run()
    return list(map(int, req.generated))


# ---------------------------------------------------------------------------
# wire surface
# ---------------------------------------------------------------------------

def test_health_models_and_errors(served):
    srv, cfg, _, _ = served
    assert _request(srv, "GET", "/health") == (200, {"status": "ok"})
    status, models = _request(srv, "GET", "/v1/models")
    assert status == 200
    assert {m["id"] for m in models["data"]} == {"m", "locked"}

    status, err = _post(srv, "/v1/completions",
                        {"model": "nope", "prompt": [1, 2], "max_tokens": 2})
    assert status == 404 and "unknown model" in err["error"]["message"]
    status, err = _post(srv, "/v1/completions",
                        {"model": "m", "prompt": [], "max_tokens": 2})
    assert status == 400
    status, err = _post(srv, "/v1/completions",      # exceeds max_seq
                        {"model": "m", "prompt": [1] * 8, "max_tokens": 500})
    assert status == 400 and "max_seq" in err["error"]["message"]
    status, err = _post(srv, "/v1/completions",
                        {"model": "locked", "prompt": [1, 2, 3],
                         "max_tokens": 2, "stream": True})
    assert status == 400 and "stream" in err["error"]["message"]
    assert _request(srv, "GET", "/v1/nope")[0] == 404


def test_sse_stream_token_identical_to_non_streaming_and_offline(served):
    """In f32: the streamed ids = the non-streamed ids = the port's offline
    decode = the JAX engine's offline decode, also through the alias."""
    srv, cfg, params, _ = served
    prompt = _prompt(cfg, 11)
    gen = 6
    body = {"model": "m", "prompt": prompt.tolist(), "max_tokens": gen}

    status, full = _post(srv, "/v1/completions", body)
    assert status == 200
    full_ids = full["choices"][0]["token_ids"]

    events = _stream_lines(srv, "/v1/completions", dict(body, stream=True))
    assert events[-1] == "[DONE]"
    final = events[-2]
    chunks = [e for e in events[:-2]]
    sse_ids = [e["choices"][0]["token_id"] for e in chunks]
    # framing: every chunk is one token with its printable piece
    assert all(e["object"] == "text_completion" for e in chunks)
    assert [e["choices"][0]["text"] for e in chunks] == \
        [f" {t}" for t in sse_ids]
    assert final["choices"][0]["finish_reason"] == "length"
    assert final["usage"]["completion_tokens"] == gen
    assert final["metrics"]["status"] == "finished"

    offline = _port_offline(cfg, params, prompt, gen)
    assert sse_ids == full_ids == offline == _jax_offline(prompt, gen)

    # the route alias resolves to the same model, same tokens
    status, via_alias = _post(srv, "/v1/completions",
                              dict(body, model="alias-m"))
    assert status == 200
    assert via_alias["choices"][0]["token_ids"] == offline


def test_chat_endpoint_stand_in_tokenizer_round_trip(served):
    srv, cfg, _, _ = served
    text = "hello"
    ids = encode_prompt(text, cfg.vocab_size).tolist()
    status, comp = _post(srv, "/v1/completions",
                         {"model": "m", "prompt": text, "max_tokens": 4})
    assert status == 200
    events = _stream_lines(
        srv, "/v1/chat/completions",
        {"model": "m", "messages": [{"role": "user", "content": text}],
         "max_tokens": 4, "stream": True})
    chunks = [e for e in events[:-2]]
    assert all(e["object"] == "chat.completion.chunk" for e in chunks)
    assert [e["choices"][0]["delta"]["content"] for e in chunks] == \
        [f" {e['choices'][0]['token_id']}" for e in chunks]
    # chat(messages=text) and completions(prompt=text) hit the same
    # byte-level encoding, so greedy decode gives identical tokens
    assert [e["choices"][0]["token_id"] for e in chunks] == \
        comp["choices"][0]["token_ids"]
    assert comp["usage"]["prompt_tokens"] == len(ids)


def _wait_decoding(eng, rid):
    deadline = time.time() + 30
    while time.time() < deadline:       # wait until it is really decoding
        if any(m["request_id"] == rid
               for m in (r.metrics() for r in eng.active_requests())):
            return
        time.sleep(0.01)
    raise AssertionError(f"{rid} never started decoding")


def _consume_in_thread(srv, cfg, rid, seed, done):
    def consume():
        done.append(_stream_lines(
            srv, "/v1/completions",
            {"model": "m", "prompt": _prompt(cfg, seed).tolist(),
             "max_tokens": 40, "stream": True, "request_id": rid}))
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    return t


def test_cancel_endpoint_mid_decode(served):
    srv, cfg, _, eng = served
    rid = "http-cancel-1"
    done = []
    t = _consume_in_thread(srv, cfg, rid, 12, done)
    _wait_decoding(eng, rid)
    status, ack = _post(srv, "/v1/cancel", {"request_id": rid})
    assert status == 200 and ack["cancelled"]
    t.join(timeout=30)
    assert done, "stream never terminated after cancel"
    events = done[0]
    assert events[-1] == "[DONE]"
    assert events[-2]["choices"][0]["finish_reason"] == "cancelled"
    n_streamed = sum(1 for e in events[:-2]
                     if "token_id" in e["choices"][0])
    assert n_streamed < 40              # decode really stopped early
    status, ack = _post(srv, "/v1/cancel", {"request_id": rid})
    assert status == 404                # already retired: nothing to cancel


def test_delete_route_cancels_and_metrics_return_to_baseline(served):
    """``DELETE /v1/requests/<id>`` takes the cancel path; afterwards
    ``/v1/metrics`` shows every lane free and no KV reserved, as before
    the request, and counts the cancellation."""
    srv, cfg, _, eng = served
    _, before = _request(srv, "GET", "/v1/metrics")
    rid = "http-delete-1"
    done = []
    t = _consume_in_thread(srv, cfg, rid, 15, done)
    _wait_decoding(eng, rid)
    status, ack = _request(srv, "DELETE", f"/v1/requests/{rid}")
    assert status == 200 and ack == {"request_id": rid, "cancelled": True}
    t.join(timeout=30)
    assert done and done[0][-2]["choices"][0]["finish_reason"] == \
        "cancelled"
    assert _request(srv, "DELETE", f"/v1/requests/{rid}")[0] == 404
    deadline = time.time() + 10
    while time.time() < deadline:
        _, after = _request(srv, "GET", "/v1/metrics")
        m = after["engines"]["m"]
        if m["free_lanes"] == before["engines"]["m"]["free_lanes"] and \
                m["kv_reserved_bytes"] == 0:
            break
        time.sleep(0.01)
    assert m["free_lanes"] == before["engines"]["m"]["free_lanes"]
    assert m["kv_reserved_bytes"] == \
        before["engines"]["m"]["kv_reserved_bytes"] == 0
    assert after["n_cancelled"] >= before["n_cancelled"] + 1
    assert after["n_submitted"] == before["n_submitted"] + 1


def test_disconnect_mid_stream_frees_lane_within_a_tick(served):
    srv, cfg, _, eng = served
    rid = "http-disc-1"
    free_before = eng.n_free_lanes
    events = _stream_lines(
        srv, "/v1/completions",
        {"model": "m", "prompt": _prompt(cfg, 13).tolist(),
         "max_tokens": 40, "stream": True, "request_id": rid},
        close_after=2)                  # hang up after two tokens
    assert len(events) >= 2
    deadline = time.time() + 10
    freed = False
    while time.time() < deadline:
        if eng.n_free_lanes == free_before and not any(
                r.request_id == rid for r in eng.active_requests()):
            freed = True
            break
        time.sleep(0.01)
    assert freed, "disconnected request still holds its lane"
    # the disconnect rode the SAME cancel path: status survived retirement
    rec = [m for m in eng.recent_metrics() if m["request_id"] == rid]
    assert rec and rec[0]["status"] == "cancelled"
    assert eng.budget.reserved_bytes == 0


# ---------------------------------------------------------------------------
# metrics under a frozen clock match external measurement
# ---------------------------------------------------------------------------

def test_request_metrics_match_external_measurement_frozen_clock():
    _, _, cfg, params = _dense()
    t = [100.0]
    eng = InferenceEngine(cfg, params, capacity=2, max_seq=MAX_SEQ,
                          clock=lambda: t[0], device="cpu")
    req = eng.submit(_prompt(cfg, 14), 3)       # arrival stamped at t=100
    t[0] = 102.0
    eng.step()              # admit + prefill + first token, all at t=102
    t[0] = 105.0
    eng.run()               # remaining decode + retirement at t=105
    m = req.metrics()
    # externally-known truth: queued 100->102, first token at 102, done 105
    assert m["queue_wait_s"] == pytest.approx(2.0)
    assert m["ttft_s"] == pytest.approx(2.0)
    assert m["e2e_s"] == pytest.approx(5.0)
    assert m["decode_s"] == pytest.approx(3.0)
    assert req.arrival_time == 100.0 and req.finish_time == 105.0


def test_token_stream_iter_and_close_semantics():
    s = TokenStream("r")
    s.put(1)
    s.put(2)
    assert s.get(timeout=0.01) == 1
    s.close(Status.FINISHED)
    s.close(Status.CANCELLED)           # idempotent: first close wins
    assert list(s) == [2]
    assert s.status is Status.FINISHED and s.closed
    with pytest.raises(StopIteration):
        s.get(timeout=0.01)


def test_encode_prompt_matches_jax():
    """Token ids pass through, strings take the byte-level stand-in, and
    the same inputs are refused with JAX's messages."""
    from repro.serving import encode_prompt as jencode
    for prompt in ("hello", "héllo wörld", [0, 5, 511]):
        np.testing.assert_array_equal(encode_prompt(prompt, 512),
                                      jencode(prompt, 512))
    for bad in ("", [], [512], [-1]):
        with pytest.raises(ValueError) as ours:
            encode_prompt(bad, 512)
        with pytest.raises(ValueError) as theirs:
            jencode(bad, 512)
        assert str(ours.value) == str(theirs.value)
