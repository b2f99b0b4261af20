"""The port's stdlib HTTP server and client on a toy fp32 engine (port 0):
the chat round trip, the logprob contract against ``ascore``, SSE chunks,
PWT3 and checkpoint-directory weight updates, a frozen server's 403,
keep-alive, the tool-call stop rule; and both directions across the
packages: the JAX package's aiohttp ``HTTPLLM`` against the port's server,
and the port's ``HTTPLLM`` against the JAX package's ``InferenceServer``, on
the same fp32 weights with the same greedy tokens."""

import asyncio
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.inference import EngineConfig as JEngineConfig
from pipelinerl_tpu.inference import InferenceEngine as JEngine
from pipelinerl_tpu.inference.client import Prompt as JPrompt
from pipelinerl_tpu.inference.http_client import HTTPLLM as JHTTPLLM
from pipelinerl_tpu.inference.server import InferenceServer as JServer
from pipelinerl_tpu.inference.server import _tool_close_boundary as j_tool_close_boundary
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu_torch.inference import EngineConfig, InferenceEngine
from pipelinerl_tpu_torch.inference.client import InProcessLLM, Prompt, make_training_text
from pipelinerl_tpu_torch.inference.http_client import HTTPLLM, HTTPStatusError, request_json
from pipelinerl_tpu_torch.inference.server import InferenceServer, _tool_close_boundary, param_checksums
from pipelinerl_tpu_torch.inference.weight_transfer import flatten_params, push_weights_http
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer
from pipelinerl_tpu_torch.train.checkpoints import export_hf

torch.set_num_threads(1)
KW = dict(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=2)
TCFG = tt.ModelConfig(dtype=torch.float32, **KW)
JCFG = jt.ModelConfig(dtype=jnp.float32, **KW)
LP_ATOL = 1e-5  # tests/test_torch_engine.py's fp32 tolerance between the packages
MSG = [{"role": "user", "content": "hi"}]


def port_params(seed: int) -> dict:
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.key(seed), JCFG))
    return tt.params_from_numpy(tree, TCFG, "cpu")


def port_engine(params, **kw) -> InferenceEngine:
    base = dict(max_slots=4, max_len=128, prefill_buckets=(64,), cache_dtype=torch.float32)
    base.update(kw)
    return InferenceEngine(params, TCFG, EngineConfig(**base), eos_token_id=ToyTokenizer().eos_token_id, device="cpu")


class Served:
    def __init__(self, engine, tokenizer=None, **kw):
        self.engine, self.tokenizer = engine, tokenizer or ToyTokenizer()
        self.server = InferenceServer(engine, self.tokenizer, **kw)

    def __enter__(self):
        self.engine.start()
        self.url = f"http://127.0.0.1:{self.server.start('127.0.0.1', 0)}"
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.engine.stop()


@pytest.fixture(scope="module")
def served():
    with Served(port_engine(port_params(0))) as s:
        yield s


def test_chat_round_trip(served):
    llm = HTTPLLM(served.url, served.tokenizer, {"max_tokens": 8, "temperature": 1.0})
    call = asyncio.run(llm.agenerate(Prompt(messages=MSG)))
    assert 1 <= len(call.output_token_ids) <= 8 and len(call.logprobs) == len(call.output_token_ids)
    assert call.finish_reason in ("stop", "length")
    assert call.prompt_token_ids == served.tokenizer.apply_chat_template(MSG, add_generation_prompt=True)
    tt_ = make_training_text(InProcessLLM(served.engine, served.tokenizer), call)
    assert tt_.input_ids == call.prompt_token_ids + call.output_token_ids
    assert tt_.labels[: len(call.prompt_token_ids)] == [-100] * len(call.prompt_token_ids)


def test_logprob_contract_against_ascore(served):
    """Sampled logprobs equal the server's teacher-forced scores
    (tests/test_server.py's tolerance)."""
    llm = HTTPLLM(served.url, served.tokenizer, {"max_tokens": 6, "temperature": 1.0})

    async def go():
        call = await llm.agenerate(Prompt(messages=[{"role": "user", "content": "abc"}]))
        return call, await llm.ascore(call.prompt_token_ids + call.output_token_ids)

    call, scored = asyncio.run(go())
    np.testing.assert_allclose(call.logprobs, scored[len(call.prompt_token_ids) - 1:], rtol=1e-4, atol=1e-5)


def test_greedy_over_http_equals_in_process(served):
    """The same greedy request alone, over HTTP and through the same engine
    in process: the same ids and the same logprobs, bit for bit."""
    params = {"max_tokens": 12, "temperature": 0.0}
    http_call = asyncio.run(HTTPLLM(served.url, served.tokenizer, params).agenerate(Prompt(messages=MSG)))
    local = asyncio.run(InProcessLLM(served.engine, served.tokenizer, params).agenerate(Prompt(messages=MSG)))
    assert http_call.output_token_ids == local.output_token_ids
    assert http_call.logprobs == local.logprobs


def test_sse_chunks(served):
    llm = HTTPLLM(served.url, served.tokenizer, {"max_tokens": 8, "temperature": 1.0})

    async def go():
        return [c async for c in llm.astream(Prompt(messages=[{"role": "user", "content": "stream please"}]))]

    chunks = asyncio.run(go())
    token_ids = [t for c in chunks for t in c[0]]
    logprobs = [lp for c in chunks for lp in c[1]]
    finishes = [c[3] for c in chunks if c[3] is not None]
    assert finishes and finishes[-1] in ("stop", "length")
    assert 1 <= len(token_ids) <= 8 and len(logprobs) == len(token_ids)
    assert all(np.isfinite(lp) and lp <= 0 for lp in logprobs)
    assert "".join(c[2] for c in chunks) == served.tokenizer.decode(token_ids, skip_special_tokens=True)


def test_keep_alive_and_routes(served):
    """Two requests on one connection; /v1/models, /weight_version and a
    404."""
    conn = http.client.HTTPConnection("127.0.0.1", int(served.url.rsplit(":", 1)[1]), timeout=30)
    try:
        conn.request("GET", "/health")
        first = conn.getresponse()
        health = json.loads(first.read())
        sock = conn.sock
        conn.request("GET", "/v1/models")
        models = json.loads(conn.getresponse().read())
        assert conn.sock is sock, "the connection was not kept alive"
        conn.request("GET", "/nowhere")
        assert conn.getresponse().status == 404
    finally:
        conn.close()
    assert health["status"] == "ok" and "counters" in health and "push" in health
    assert models["data"][0]["id"] == "local"
    assert "pushes_received" in asyncio.run(request_json(served.url, "/weight_version"))


def test_pwt3_push_answers_after_the_swap():
    with Served(port_engine(port_params(0))) as s:
        new = port_params(7)
        timings = push_weights_http([s.url], new, version=5, timeout=60)
        assert s.engine.version == 5  # 200 means the engine serves it
        assert timings["replies"][s.url]["version"] == 5 and timings["bytes"] > 0
        got = asyncio.run(request_json(s.url, "/debug/param_checksums"))
        assert got["version"] == 5 and got["checksums"] == param_checksums(new)
        assert got["checksums"] != param_checksums(port_params(0))
        # a tree that does not fit is refused with 400
        bad = {"embed": torch.zeros(3)}
        with pytest.raises(RuntimeError, match="weight push failed"):
            push_weights_http([s.url], bad, version=6, timeout=30)
        assert s.engine.version == 5


def test_checkpoint_dir_update(tmp_path):
    with Served(port_engine(port_params(0))) as s:
        new = port_params(9)
        ckpt = export_hf(tmp_path, new, TCFG)
        reply = asyncio.run(request_json(s.url, "/receive_weight_update",
                                         {"checkpoint_dir": str(ckpt), "version": 42}))
        assert reply["version"] == 42
        deadline = time.monotonic() + 30
        while s.engine.version != 42 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s.engine.version == 42
        got, want = dict(flatten_params(s.engine.params)), dict(flatten_params(new))
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_frozen_server_refuses_pushes():
    with Served(port_engine(port_params(0)), frozen=True) as s:
        with pytest.raises(urllib.error.HTTPError) as e:
            req = urllib.request.Request(f"{s.url}/receive_weight_update", data=b"PWT3",
                                         headers={"Content-Type": "application/x-msgpack"}, method="POST")
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 403
        with pytest.raises(HTTPStatusError) as e2:
            asyncio.run(request_json(s.url, "/receive_weight_update", {"checkpoint_dir": "/nonexistent"}))
        assert e2.value.status == 403
        assert s.engine.version == 0


@pytest.mark.parametrize("text,n_calls", [
    ('x<tool_call>{"name":"f"}</tool_call> spurious tail', 1),
    ('x<tool_call>{"name":"f"}</tool_call> spurious tail<tool_call>{"name":"g"}</tool_call>xx', 2),
    ("no tags here", 1),
    ("", 1),
])
def test_tool_close_boundary_matches_jax(text, n_calls):
    tok = ToyTokenizer()
    ids = tok.encode(text)
    b = _tool_close_boundary(tok, ids, n_calls)
    assert b == j_tool_close_boundary(tok, ids, n_calls)
    if "</tool_call>" in text:
        assert tok.decode(ids[:b]).count("</tool_call>") == n_calls
        assert tok.decode(ids[:b]).endswith("</tool_call>")
    else:
        assert b == len(ids)


def test_sse_stops_at_a_tool_call():
    """With tools in the request, the stream emits a delta.tool_calls entry
    and ends with finish_reason "tool_calls" long before max_tokens, and no
    text after the closing tag reaches the client (tests/
    test_tool_parser_streaming.py's scripted tokenizer)."""
    scripted = '<tool_call>{"name": "run_python_code", "arguments": {}}</tool_call>' \
        " and then some extra text that should never stream"

    class ScriptedTok:
        eos_token_id = 0

        def apply_chat_template(self, messages, add_generation_prompt=True, **kw):
            return [3, 5, 7]

        def decode(self, ids, skip_special_tokens=True):
            return scripted[: len(ids)]

    engine = port_engine(port_params(0), max_slots=2, max_len=512, prefill_buckets=(32,), decode_window=4)
    with Served(engine, ScriptedTok()) as s:
        body = {"messages": [{"role": "user", "content": "go"}], "max_tokens": 400, "stream": True,
                "tools": [{"type": "function", "function": {"name": "run_python_code"}}]}
        req = urllib.request.Request(f"{s.url}/v1/chat/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        events = []
        with urllib.request.urlopen(req, timeout=120) as resp:
            for line in resp:
                line = line.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    events.append(json.loads(line[len("data: "):]))
    finishes = [e["choices"][0].get("finish_reason") for e in events]
    assert "tool_calls" in finishes, finishes
    tool_deltas = [tc for e in events for tc in e["choices"][0]["delta"].get("tool_calls", [])]
    assert tool_deltas and tool_deltas[0]["function"]["name"] == "run_python_code"
    assert "extra text" not in "".join(e["choices"][0]["delta"].get("content") or "" for e in events)
    usage = next(e["choices"][0]["usage"] for e in events if "usage" in e["choices"][0])
    streamed = [t for e in events for t in e["choices"][0].get("token_ids", [])]
    assert usage["completion_tokens"] == len(streamed) == len(scripted.split(" and then")[0])


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's engine and aiohttp server on seed 0's fp32 weights."""
    engine = JEngine(jt.init_params(jax.random.key(0), JCFG), JCFG,
                     JEngineConfig(max_slots=4, max_len=128, prefill_buckets=(64,), cache_dtype=jnp.float32),
                     eos_token_id=ToyTokenizer().eos_token_id)
    engine.start()
    loop = asyncio.new_event_loop()
    box: dict = {}

    def serve():
        asyncio.set_event_loop(loop)
        box["runner"] = loop.run_until_complete(JServer(engine, ToyTokenizer()).run(host="127.0.0.1", port=0))
        loop.run_forever()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    deadline = time.monotonic() + 30
    while "runner" not in box and time.monotonic() < deadline:
        time.sleep(0.02)
    port = box["runner"].addresses[0][1]
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(box["runner"].cleanup(), loop).result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        engine.stop()


def test_across_packages(served, jax_server):
    """JAX's HTTPLLM on the port's server and the port's HTTPLLM on JAX's
    server: the same greedy tokens, logprobs within the packages' fp32
    tolerance, SSE and scoring through both."""
    tok = ToyTokenizer()
    params = {"max_tokens": 10, "temperature": 0.0}

    async def jax_client_on_port_server():
        llm = JHTTPLLM(served.url, tok, params)
        call = await llm.agenerate(JPrompt(messages=MSG))
        chunks = [c async for c in llm.astream(JPrompt(messages=MSG))]
        scores = await llm.ascore(call.prompt_token_ids + call.output_token_ids)
        return call, chunks, scores

    async def port_client_on_jax_server():
        llm = HTTPLLM(jax_server, tok, params)
        call = await llm.agenerate(Prompt(messages=MSG))
        chunks = [c async for c in llm.astream(Prompt(messages=MSG))]
        scores = await llm.ascore(call.prompt_token_ids + call.output_token_ids)
        return call, chunks, scores

    a, a_chunks, a_scores = asyncio.run(jax_client_on_port_server())
    b, b_chunks, b_scores = asyncio.run(port_client_on_jax_server())
    assert a.output_token_ids == b.output_token_ids and len(a.output_token_ids) > 0
    np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0, atol=LP_ATOL)
    for chunks, call in ((a_chunks, a), (b_chunks, b)):
        assert [t for c in chunks for t in c[0]] == call.output_token_ids
        assert chunks[-1][3] in ("stop", "length")
    np.testing.assert_allclose(a_scores, b_scores, rtol=0, atol=LP_ATOL)
    n = len(a.prompt_token_ids)
    np.testing.assert_allclose(a_scores[n - 1:], a.logprobs, rtol=0, atol=LP_ATOL)


def test_push_bodies_over_64_mib(served, jax_server):
    """A fault of the reference (ROADMAP Queue 3): the JAX server's aiohttp
    app caps request bodies at 64 MiB, so it answers 413 to any push of more
    than about 32M bf16 parameters (Qwen2.5-0.5B's body is 988 MB). The
    port's server reads the whole body and judges its contents (here: not a
    PWT3 body, 400)."""
    body = b"X" * (65 << 20)

    def post(url):
        req = urllib.request.Request(f"{url}/receive_weight_update", data=body,
                                     headers={"Content-Type": "application/x-msgpack"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        return e.value.code, e.value.read()

    assert post(jax_server)[0] == 413
    status, reply = post(served.url)
    assert status == 400 and b"not a PWT3" in reply
