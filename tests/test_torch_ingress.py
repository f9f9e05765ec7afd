"""Port parity, the HTTP front door (``repro_torch.serving.ingress``, a copy
of the reference's) over the port's in-process ``Orchestrator`` on the
CPU, exercised with raw sockets and hand-parsed HTTP/1.1 as the
reference's ``tests/test_ingress.py`` does: response framing, streamed
chunk order, deterministic 429 backpressure (the ``hold_pump`` hook),
the 400 taxonomy, 404/405, 503 while closing, and the budget governor
on the port's telemetry. The same completions get the same tokens from
the port's ingress as from the reference's over the JAX package.

Not ported: the reference's ``test_graceful_shutdown_mid_stream``. It
fails against the reference's own code (the stream ends without a
"shutting down" event), so it is no oracle for this copy; the 503 intake
rule of a closing ingress is held below."""
import json
import socket
import time

import numpy as np
import pytest

from repro.serving.ingress import Ingress as JaxIngress
from repro.serving.ingress import byte_tokens as jax_byte_tokens
from repro.serving.orchestrator import Orchestrator as JaxOrchestrator
from repro_torch.serving.ingress import BudgetGovernor, Ingress, byte_tokens
from repro_torch.serving.instrument import EngineTelemetry
from repro_torch.serving.orchestrator import Orchestrator
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401
from _torch_parity import tiny_pair

MAX_QUEUE = 2
KW = dict(max_batch=2, max_len=64, block_size=8)


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


@pytest.fixture(scope="module")
def served(tiny):
    _, _, tcfg, tp = tiny
    orch = Orchestrator(tcfg, tp, n_instances=2, max_queue=MAX_QUEUE,
                        device="cpu", **KW)
    ing = Ingress(orch, model_id="tiny-test").start()
    yield orch, ing
    ing.close()
    orch.close()


# ----------------------------------------------------- raw-socket client
def _connect(ing):
    return socket.create_connection(("127.0.0.1", ing.port), timeout=60)


def _send(sock, method, path, body=None, raw=None):
    if raw is None:
        payload = b"" if body is None else json.dumps(body).encode()
        raw = f"{method} {path} HTTP/1.1\r\nHost: t\r\n".encode()
        if payload:
            raw += b"Content-Type: application/json\r\n"
            raw += b"Content-Length: %d\r\n" % len(payload)
        raw += b"\r\n" + payload
    sock.sendall(raw)


def _recv_all(sock):
    data = b""
    while chunk := sock.recv(65536):
        data += chunk
    return data


def _parse(data):
    """Strict HTTP/1.1 response parse: (status, headers, raw body)."""
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    proto, status, *_ = lines[0].split(" ")
    assert proto == "HTTP/1.1"
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(status), headers, body


def _parse_chunked(body):
    """Decode chunked transfer encoding strictly: (payloads, terminated)."""
    chunks, rest, done = [], body, False
    while rest:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            assert rest[:2] in (b"\r\n", b"")
            done = True
            break
        assert len(rest) >= size + 2, "truncated chunk"
        chunks.append(rest[:size])
        assert rest[size:size + 2] == b"\r\n"
        rest = rest[size + 2:]
    return chunks, done


def _request(ing, method, path, body=None, raw=None):
    s = _connect(ing)
    _send(s, method, path, body=body, raw=raw)
    data = _recv_all(s)
    s.close()
    return _parse(data)


def _stream_tokens(body):
    chunks, terminated = _parse_chunked(body)
    assert terminated, "missing 0\\r\\n\\r\\n chunked terminator"
    events = []
    for c in chunks:
        assert c.startswith(b"data: ") and c.endswith(b"\n\n")
        events.append(c[len(b"data: "):].strip())
    return events


# ------------------------------------------------------------- framing
def test_health_and_models_framing(served):
    _, ing = served
    status, headers, body = _request(ing, "GET", "/healthz")
    assert status == 200
    assert int(headers["content-length"]) == len(body)
    assert headers["content-type"] == "application/json"
    assert headers["connection"] == "close"
    obj = json.loads(body)
    assert obj["status"] == "ok" and obj["pod_size"] == 2
    status, headers, body = _request(ing, "GET", "/v1/models")
    assert status == 200
    assert int(headers["content-length"]) == len(body)
    assert json.loads(body)["data"][0]["id"] == "tiny-test"


def test_stats_surfaces_snapshot_and_counters(served):
    _, ing = served
    status, _, body = _request(ing, "GET", "/stats")
    assert status == 200
    obj = json.loads(body)
    assert set(obj) >= {"snapshot", "ingress", "pod", "finished", "dropped"}
    assert obj["snapshot"]["pod_size"] == 2
    assert set(obj["ingress"]) >= {"requests", "rejected_429", "tokens_out",
                                   "routed_prefix", "routed_vacancy"}


def test_byte_tokenizer_matches_reference(tiny):
    _, _, tcfg, _ = tiny
    for text in ("same text", "héllo wörld", "x" * 300):
        got = byte_tokens(text, tcfg.vocab_size)
        np.testing.assert_array_equal(got, jax_byte_tokens(text,
                                                           tcfg.vocab_size))
        assert (got >= 2).all() and (got < tcfg.vocab_size).all()


# ---------------------------------------------------------- completions
def test_unary_completion(served):
    _, ing = served
    status, headers, body = _request(
        ing, "POST", "/v1/completions",
        body={"prompt": [5, 6, 7, 8], "max_tokens": 4})
    assert status == 200
    assert int(headers["content-length"]) == len(body)
    obj = json.loads(body)
    assert len(obj["tokens"]) == 4
    assert obj["usage"]["completion_tokens"] == 4
    assert obj["routing"]["reason"] in ("prefix", "vacancy")
    assert obj["routing"]["instance"] in (0, 1)


def test_streaming_chunk_framing_and_order(served):
    _, ing = served
    status, headers, body = _request(
        ing, "POST", "/v1/completions",
        body={"prompt": "stream me please", "max_tokens": 6, "stream": True})
    assert status == 200
    assert headers["transfer-encoding"] == "chunked"
    assert headers["content-type"] == "text/event-stream"
    assert "content-length" not in headers
    events = _stream_tokens(body)
    head = json.loads(events[0])
    assert head["routing"] in ("prefix", "vacancy")
    assert events[-1] == b"[DONE]"
    toks = [json.loads(e) for e in events[1:-1]]
    assert [t["index"] for t in toks] == list(range(6))
    assert all(isinstance(t["token"], int) for t in toks)


def test_tokens_arrive_incrementally(served):
    """At least one token chunk is on the wire before the request
    finishes: the data arrives in more than one socket read."""
    _, ing = served
    s = _connect(ing)
    _send(s, "POST", "/v1/completions",
          body={"prompt": "incremental", "max_tokens": 8, "stream": True})
    reads = []
    while chunk := s.recv(65536):
        reads.append(chunk)
    s.close()
    assert len(reads) > 1, "entire stream arrived in one flush"
    _, terminated = _parse_chunked(b"".join(reads).partition(b"\r\n\r\n")[2])
    assert terminated


# ------------------------------------------------------- backpressure
def test_deterministic_429_and_recovery(served):
    """With the pump held, accepted-but-unpumped requests fill every seat
    (2 instances x max_queue) and the next admission is shed with 429 +
    Retry-After; releasing the pump drains the backlog."""
    _, ing = served
    seats = 2 * MAX_QUEUE
    base = ing.counters.requests
    ing.hold_pump.set()
    socks = []
    try:
        for k in range(seats):
            s = _connect(ing)
            _send(s, "POST", "/v1/completions",
                  body={"prompt": [10 + k], "max_tokens": 2})
            socks.append(s)
        deadline = time.monotonic() + 30
        while ing.counters.requests < base + seats:
            assert time.monotonic() < deadline, "accepts not registered"
            time.sleep(0.01)
        status, headers, body = _request(
            ing, "POST", "/v1/completions",
            body={"prompt": [99], "max_tokens": 2})
        assert status == 429
        assert headers["retry-after"] == "1"
        assert json.loads(body)["error"]
        assert ing.counters.rejected_429 >= 1
    finally:
        ing.hold_pump.clear()
    for s in socks:
        status, _, body = _parse(_recv_all(s))
        s.close()
        assert status == 200
        assert len(json.loads(body)["tokens"]) == 2


# ------------------------------------------------------------- rejects
@pytest.mark.parametrize("body", [
    {"max_tokens": 4},
    {"prompt": ""},
    {"prompt": []},
    {"prompt": [1, -2, 3]},
    {"prompt": [1, "x"]},
    {"prompt": [1, 2], "max_tokens": 0},
    {"prompt": [1, 2], "max_tokens": 99999},
    {"prompt": [1, 2], "temperature": "hot"},
])
def test_malformed_completions_get_400(served, body):
    _, ing = served
    status, _, resp = _request(ing, "POST", "/v1/completions", body=body)
    assert status == 400
    assert json.loads(resp)["error"]


def test_broken_http_framing_gets_400(served):
    _, ing = served
    for raw in [b"GARBAGE\r\n\r\n",
                b"GET /healthz\r\n\r\n",
                b"POST /v1/completions HTTP/1.1\r\n"
                b"Content-Length: 99999999\r\n\r\n",
                b"POST /v1/completions HTTP/1.1\r\n"
                b"Content-Length: 4\r\n\r\nnot-"]:
        status, _, _ = _request(ing, "POST", "/x", raw=raw)
        assert status == 400


def test_unknown_path_404_and_wrong_method_405(served):
    _, ing = served
    assert _request(ing, "GET", "/nope")[0] == 404
    assert _request(ing, "GET", "/v1/completions")[0] == 405
    assert _request(ing, "POST", "/healthz", body={"x": 1})[0] == 404


def test_closing_ingress_rejects_new_intake_with_503(tiny):
    _, _, tcfg, tp = tiny
    orch = Orchestrator(tcfg, tp, n_instances=1, device="cpu", **KW)
    ing = Ingress(orch).start()
    ing._closing = True
    status, _, body = _request(ing, "GET", "/healthz")
    assert status == 503 and b"shutting down" in body
    ing._closing = False
    ing.close()
    orch.close()


@pytest.mark.parametrize("body,code", [
    ({"prompt": "x", "slo_class": "platinum"}, "unknown_slo_class"),
    ({"prompt": "x", "deadline_ms": -0.1}, "bad_deadline"),
    ({"prompt": "x", "slo": "interactive", "maxTokens": 4},
     "unknown_fields"),
])
def test_typed_400_taxonomy(served, body, code):
    _, ing = served
    status, _, resp = _request(ing, "POST", "/v1/completions", body=body)
    assert status == 400
    out = json.loads(resp)
    assert out["error"] == code
    if code == "unknown_fields":
        assert sorted(out["fields"]) == ["maxTokens", "slo"]
    else:
        assert out["detail"]


def test_slo_completion_accepted_end_to_end(served):
    _, ing = served
    status, _, resp = _request(
        ing, "POST", "/v1/completions",
        body={"prompt": "hello slo", "max_tokens": 4,
              "slo_class": "interactive", "deadline_ms": 2000})
    assert status == 200
    assert len(json.loads(resp)["tokens"]) == 4


# ------------------------------------------------------ parity with JAX
@pytest.mark.usefixtures("partitionable_threefry")
def test_same_completions_same_tokens_as_reference(tiny):
    """Unary and streamed, greedy and sampled completions, one after the
    other: the port's ingress over the port's orchestrator answers with
    the tokens the reference's ingress gets from the JAX package."""
    jcfg, jp, tcfg, tp = tiny
    bodies = [{"prompt": "parity text", "max_tokens": 6},
              {"prompt": list(range(3, 14)), "max_tokens": 6,
               "temperature": 0.8, "top_k": 16, "seed": 5},
              {"prompt": "parity stream", "max_tokens": 6, "stream": True,
               "temperature": 0.7, "top_k": 8, "seed": 9}]

    def tokens(ing, body):
        status, _, resp = _request(ing, "POST", "/v1/completions", body=body)
        assert status == 200
        if not body.get("stream"):
            return json.loads(resp)["tokens"]
        return [json.loads(e)["token"] for e in _stream_tokens(resp)[1:-1]]

    got = {}
    for name, orch, ingress in (
            ("port", Orchestrator(tcfg, tp, n_instances=2, device="cpu",
                                  **KW), Ingress),
            ("jax", JaxOrchestrator(jcfg, jp, n_instances=2, **KW),
             JaxIngress)):
        ing = ingress(orch, model_id="parity").start()
        try:
            got[name] = [tokens(ing, b) for b in bodies]
        finally:
            ing.close()
            orch.close()
    assert got["port"] == got["jax"]
    assert all(len(t) == 6 for t in got["port"])


# ------------------------------------------------- the budget governor
class _FakeInstance:
    def __init__(self):
        self.calls = []

    def set_token_budget(self, budget):
        self.calls.append(budget)
        return budget


class _FakeRec:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((kind, fields))


class _FakeOrch:
    def __init__(self, tel):
        self.telemetry = [tel]
        self.instances = [_FakeInstance()]
        self.flightrec = _FakeRec()

    def _alive(self):
        return [0]


def _saturated_telemetry(budget=128, packed=None, delay=10.0):
    tel = EngineTelemetry()
    tel.budget = budget
    tel.packed_tokens.extend([packed if packed is not None else budget] * 8)
    tel.queue_delays.extend([delay] * 8)
    return tel


def test_budget_governor_grows_under_saturation_and_delay():
    orch = _FakeOrch(_saturated_telemetry())
    gov = BudgetGovernor(orch, period_s=0.5)
    assert gov.tick(now=10.0)
    assert orch.instances[0].calls == [192]
    assert gov.budgets[0] == 192 and gov.adjustments == 1
    kind, ev = orch.flightrec.events[0]
    assert kind == "budget_governor"
    assert ev["budget"] == 192 and ev["prev"] == 128
    assert not gov.tick(now=10.2)
    assert gov.adjustments == 1


def test_budget_governor_shrinks_when_budget_rides_empty():
    orch = _FakeOrch(_saturated_telemetry(budget=128, packed=16, delay=0.0))
    gov = BudgetGovernor(orch, period_s=0.0)
    assert gov.tick(now=1.0)
    assert orch.instances[0].calls == [96]
    for t in range(2, 20):
        gov.tick(now=float(t))
    assert gov.budgets[0] == gov.min_budget
    assert orch.instances[0].calls[-1] == gov.min_budget
    n = gov.adjustments
    gov.tick(now=100.0)
    assert gov.adjustments == n


def test_budget_governor_skips_phase_engines_and_holds_steady_band():
    orch = _FakeOrch(EngineTelemetry())
    gov = BudgetGovernor(orch, period_s=0.0)
    assert gov.tick(now=1.0)
    assert orch.instances[0].calls == []
    orch2 = _FakeOrch(_saturated_telemetry(delay=0.0))
    gov2 = BudgetGovernor(orch2, period_s=0.0)
    assert gov2.tick(now=1.0)
    assert orch2.instances[0].calls == []
