"""The port's environment servers against the JAX package's: the math and
logic verifiers, the web environment and the research corpus answer the
same requests with the same status and JSON; the port's clients (its
``JsonSession`` and rollouts) work against JAX's aiohttp servers and JAX's
aiohttp clients against the port's servers; rollouts over RPC give what
in-process grading gives; the miniwob pool fails over past a dead port and
returns ``_failed_rollout`` when every server is dead, as JAX's does."""

import asyncio
import copy
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import aiohttp
import pytest
import torch

from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.domains.deep_research import environment as j_research
from pipelinerl_tpu.domains.logic import verifier_api as j_logic_api
from pipelinerl_tpu.domains.math import verifier_api as j_math_api
from pipelinerl_tpu.domains.miniwob import environment_server as j_web
from pipelinerl_tpu.domains.miniwob import rollouts as j_miniwob
from pipelinerl_tpu.inference import engine as j_engine
from pipelinerl_tpu.inference.client import InProcessLLM as JInProcessLLM
from pipelinerl_tpu_torch.config import Config
from pipelinerl_tpu_torch.domains.deep_research import environment as t_research
from pipelinerl_tpu_torch.domains.deep_research import rollouts as t_research_rollouts
from pipelinerl_tpu_torch.domains.logic import dataset as logic_dataset
from pipelinerl_tpu_torch.domains.logic import verifier_api as t_logic_api
from pipelinerl_tpu_torch.domains.logic.verifiers import verify_answer as logic_verify
from pipelinerl_tpu_torch.domains.math import rollouts as t_math_rollouts
from pipelinerl_tpu_torch.domains.math import verifier_api as t_math_api
from pipelinerl_tpu_torch.domains.math.verifier import grade_answer, verify_countdown
from pipelinerl_tpu_torch.domains.miniwob import environment_server as t_web
from pipelinerl_tpu_torch.domains.miniwob import rollouts as t_miniwob
from pipelinerl_tpu_torch.inference import engine as t_engine
from pipelinerl_tpu_torch.inference.client import InProcessLLM
from pipelinerl_tpu_torch.utils.http_json import JsonSession
from tests.test_logic_domain import _oracle
from tests.test_torch_domain_math import ScriptedEngine, tokenizer_pair
from tests.test_torch_domain_miniwob import _scripts as web_scripts
from tests.test_torch_domains import assert_same_rollout

torch.set_num_threads(1)


class JaxServer:
    """A JAX aiohttp environment served from a loop on its own thread."""

    def __init__(self, env):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.runner = asyncio.run_coroutine_threadsafe(env.run(host="127.0.0.1", port=0), self.loop).result(10)
        self.port = self.runner.addresses[0][1]

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


class PortServer:
    def __init__(self, env):
        self.env = env
        self.port = env.start(host="127.0.0.1", port=0)

    def stop(self):
        self.env.shutdown()


PAIRS = {
    "math": (t_math_api.MathEnvironment, j_math_api.MathEnvironment),
    "logic": (t_logic_api.LogicEnvironment, j_logic_api.LogicEnvironment),
    "web": (t_web.WebEnvironmentServer, j_web.WebEnvironmentServer),
    "research": (t_research.ResearchEnvironment, j_research.ResearchEnvironment),
}


@pytest.fixture
def servers(request):
    """{"port": server, "jax": server} of the kind the test names."""
    t_cls, j_cls = PAIRS[request.param]
    out = {"port": PortServer(t_cls()), "jax": JaxServer(j_cls())}
    yield out
    for s in out.values():
        s.stop()


def call(port: int, method: str, path: str, body=None) -> tuple[int, object]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def logic_cases():
    cases = []
    for p in logic_dataset.generate_problems(18, seed=7)[:9]:
        ctx = p["reward_context"]
        answer = _oracle(ctx["task"], ctx["game_data"])
        cases += [{"prediction": f"<answer>{answer}</answer>", "reward_context": ctx},
                  {"prediction": "<answer>surely not</answer>", "reward_context": ctx},
                  {"prediction": "", "reward_context": ctx}]
    return cases + [{"prediction": "<answer>1</answer>"}, {"reward_context": None}]


REQUESTS = {
    "math": [("POST", "/verify_answer", b) for b in (
        {"prediction": "so \\boxed{6}", "gold": "6"}, {"prediction": "\\boxed{5}", "gold": "6", "strict": True},
        {"prediction": "no idea", "gold": "6"}, {"prediction": "\\boxed{\\frac{1}{2}}", "gold": 0.5, "strict": False},
        {"prediction": "<answer>(3 + 5) * 2</answer>", "gold": "", "numbers": [3, 5, 2], "target": 16},
        {"prediction": "<answer>3 * 5 * 2</answer>", "gold": "", "numbers": [3, 5, 2], "target": 16},
        {"gold": "6"},  # no prediction: the verification raises, so unparsable
    )] + [("GET", "/health", None)],
    "logic": [("POST", "/verify_answer", b) for b in logic_cases()] + [("GET", "/health", None)],
    "web": [("POST", "/start_task", {"task": "simweb.enter-text", "seed": 1}), ("GET", "/health", None),
            ("POST", "/step", {"session_id": "$sid", "action": 'click("nonexistent")'}),
            ("POST", "/step", {"session_id": "$sid", "action": "gibberish"}),
            ("POST", "/step", {"session_id": "nope", "action": 'click("submit")'}),
            ("POST", "/start_task", {"task": "simweb.nope", "seed": 0}), ("POST", "/start_task", {"seed": 0}),
            ("POST", "/close", {"session_id": "$sid"}), ("POST", "/close", {"session_id": "$sid"}),
            ("GET", "/health", None), ("POST", "/start_task", {"task": "simweb.click-button", "seed": 2}),
            ("POST", "/step", {"session_id": "$sid", "action": 'click("b0")'}), ("GET", "/health", None)],
    "research": [("GET", path, None) for path in (
        "/search?q=institute+cartography&seed=0", "/search?q=Biography&seed=1", "/search?q=zz&seed=0",
        "/read?id=doc_3a&seed=0", "/read?id=doc_3a&seed=1", "/read?id=doc_99z&seed=0", "/search?q=born",
        "/health")],
}


def replay(port: int, requests) -> list:
    """Send ``requests`` in order, ``$sid`` standing for the session id of
    the last ``/start_task``; session ids in answers read ``<sid>``."""
    sid, out = None, []
    for method, path, body in requests:
        if body is not None and body.get("session_id") == "$sid":
            body = {**body, "session_id": sid}
        status, answer = call(port, method, path, body)
        if isinstance(answer, dict) and "session_id" in answer:
            sid = answer["session_id"]
            answer = {**answer, "session_id": "<sid>"}
        out.append((status, answer))
    return out


@pytest.mark.parametrize("servers", sorted(PAIRS), indirect=True)
def test_servers_answer_alike(servers, request):
    kind = request.node.callspec.params["servers"]
    port_answers, jax_answers = (replay(servers[pkg].port, REQUESTS[kind]) for pkg in ("port", "jax"))
    assert port_answers == jax_answers
    statuses = {status for status, _ in port_answers}
    assert 200 in statuses
    if kind == "web":
        assert statuses == {200, 400, 404}
    if kind == "research":
        assert 404 in statuses
    log = servers["port"].env.request_log()
    assert sum(log["/health"].values()) == sum(1 for r in REQUESTS[kind] if r[1] == "/health")


def test_web_server_refuses_past_max_sessions():
    for server in (PortServer(t_web.WebEnvironmentServer(max_sessions=1)),
                   JaxServer(j_web.WebEnvironmentServer(max_sessions=1))):
        try:
            assert call(server.port, "POST", "/start_task", {"task": "simweb.enter-text"})[0] == 200
            assert call(server.port, "POST", "/start_task", {"task": "simweb.enter-text"}) == \
                (503, {"error": "server at capacity"})
        finally:
            server.stop()


def test_logic_verification_past_its_timeout_answers_unparsable(monkeypatch):
    monkeypatch.setattr(t_logic_api, "VERIFY_TIMEOUT_S", 0.2)
    monkeypatch.setattr(t_logic_api, "verify_answer", lambda prediction, ctx: time.sleep(1) or "correct")
    server = PortServer(t_logic_api.LogicEnvironment())
    try:
        assert call(server.port, "POST", "/verify_answer", {"prediction": "x"}) == (200, {"answer_status": "unparsable"})
    finally:
        server.stop()


async def _rpc_statuses(pkg: str, port: int) -> list[str]:
    """Every math and logic case through a package's RPC client."""
    math_api, logic_api = (t_math_api, t_logic_api) if pkg == "port" else (j_math_api, j_logic_api)
    session_cm = JsonSession() if pkg == "port" else aiohttp.ClientSession()
    out = []
    async with session_cm as session:
        for _, _, body in REQUESTS["math"][:6]:
            extra = {k: body[k] for k in ("numbers", "target") if k in body}
            out.append(await math_api.verify_answer_rpc(session, "127.0.0.1", port, body["prediction"],
                                                        str(body["gold"]), body.get("strict", True), extra or None))
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_rpc_clients_across_packages(client_pkg, server_pkg):
    """The math client of one package on the other's server (and the
    port's on its own) grades as the verifier does in process; the logic
    client likewise."""
    cls = {"port": (t_math_api.MathEnvironment, t_logic_api.LogicEnvironment),
           "jax": (j_math_api.MathEnvironment, j_logic_api.LogicEnvironment)}[server_pkg]
    wrap = PortServer if server_pkg == "port" else JaxServer
    math_server, logic_server = wrap(cls[0]()), wrap(cls[1]())
    try:
        got = asyncio.run(_rpc_statuses(client_pkg, math_server.port))
        want = [verify_countdown(b["prediction"], b["numbers"], b["target"]) if "numbers" in b
                else grade_answer(b["prediction"], str(b["gold"]), b.get("strict", True))
                for _, _, b in REQUESTS["math"][:6]]
        assert got == want and "correct" in got and "wrong" in got

        async def logic():
            api = t_logic_api if client_pkg == "port" else j_logic_api
            async with (JsonSession() if client_pkg == "port" else aiohttp.ClientSession()) as session:
                return [await api.verify_answer_rpc(session, "127.0.0.1", logic_server.port, b["prediction"],
                                                    b["reward_context"]) for b in logic_cases()[:27]]

        assert asyncio.run(logic()) == [logic_verify(b["prediction"], b["reward_context"]) for b in logic_cases()[:27]]
    finally:
        math_server.stop()
        logic_server.stop()


# -- rollouts over the servers ------------------------------------------------


async def _scripted(pkg, fn, cfg, problem, replies, session):
    """One rollout of ``fn`` with a scripted toy-tokenizer LLM."""
    j_tok, t_tok = tokenizer_pair("toy")
    ids = [t_tok.encode(r) + [t_tok.eos_token_id] for r in replies]
    mod, llm_cls, tok = (t_engine, InProcessLLM, t_tok) if pkg == "port" else (j_engine, JInProcessLLM, j_tok)
    engine = ScriptedEngine(mod, ids, "stop")
    result = await fn(cfg, llm_cls(engine, tok, {"max_tokens": 64}), copy.deepcopy(problem), session)
    if hasattr(result.metrics, "total_execution_time"):  # wall time
        result.metrics.total_execution_time = 0.0
    return result, engine.prompts


def dead_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def web_cfg(pkg, ports, loops=8):
    data = {"actor": {"agent_max_loops": loops, "reward_computation": "nico", "rollout_timeout": 30},
            "environment": [{"hostname": "127.0.0.1", "port": p} for p in ports]}
    return Config(data) if pkg == "port" else JConfig(data)


@pytest.mark.parametrize("name", ["success", "step_errors", "out_of_loops"])
def test_miniwob_fails_over_past_a_dead_port(name):
    """Both packages' rollouts, each on its own server behind a dead port,
    equal each other and the in-process episode; the server's sessions
    close."""
    problem, replies, reward = web_scripts()[name]
    servers = {"port": PortServer(t_web.WebEnvironmentServer()), "jax": JaxServer(j_web.WebEnvironmentServer())}
    try:
        async def run(pkg):
            fn = (t_miniwob if pkg == "port" else j_miniwob).generate_miniwob_rollout
            async with (JsonSession() if pkg == "port" else aiohttp.ClientSession()) as session:
                return await _scripted(pkg, fn, web_cfg(pkg, [dead_port(), servers[pkg].port]), problem, replies,
                                       session)

        remote = {pkg: asyncio.run(run(pkg)) for pkg in servers}
        local = asyncio.run(_scripted("port", t_miniwob.generate_miniwob_rollout, web_cfg("port", []), problem,
                                      replies, None))
        assert_same_rollout(remote["jax"], remote["port"])
        assert_same_rollout(local, remote["port"])
        assert remote["port"][0].metrics.reward == pytest.approx(reward)
        for pkg in servers:
            assert call(servers[pkg].port, "GET", "/health")[1]["active_sessions"] == 0
        assert servers["port"].env.request_log()["/start_task"] == {"200": 1}
    finally:
        for s in servers.values():
            s.stop()


def test_miniwob_returns_the_failed_rollout_when_every_server_is_dead():
    problem, replies, _ = web_scripts()["success"]

    async def run(pkg):
        fn = (t_miniwob if pkg == "port" else j_miniwob).generate_miniwob_rollout
        async with (JsonSession() if pkg == "port" else aiohttp.ClientSession()) as session:
            return (await _scripted(pkg, fn, web_cfg(pkg, [dead_port(), dead_port()]), problem, replies, session))[0]

    port, jax = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert port.training_texts == jax.training_texts == []
    assert port.metrics.model_dump() == jax.metrics.model_dump()
    assert port.metrics.reward == -1.0 and not port.metrics.no_error and port.metrics.no_answer


MATH_PROBLEMS = [
    ({"task": "2 + 4", "answer": "6", "dataset": "synthetic_arithmetic"}, ["so \\boxed{6}"]),
    ({"task": "2 + 4", "answer": "6", "dataset": "synthetic_arithmetic"}, ["\\boxed{7}"]),
    ({"task": "make 16", "numbers": [3, 5, 2], "target": 16, "dataset": "countdown"}, ["<answer>(3 + 5) * 2</answer>"]),
]


@pytest.mark.parametrize("case", range(len(MATH_PROBLEMS)))
def test_math_rollout_over_rpc_equals_in_process(case):
    problem, replies = MATH_PROBLEMS[case]
    server = PortServer(t_math_api.MathEnvironment())
    try:
        cfg = Config({"actor": {"task_template": "{task}"}, "rewards": {"buffer_tokens": 0},
                      "environment": [{"hostname": "127.0.0.1", "port": server.port}]})

        async def remote():
            async with JsonSession() as session:
                return await _scripted("port", t_math_rollouts.generate_math_rollout, cfg, problem, replies, session)

        over_rpc = asyncio.run(remote())
        in_process = Config({k: v for k, v in cfg.items() if k != "environment"})
        local = asyncio.run(_scripted("port", t_math_rollouts.generate_math_rollout, in_process, problem, replies,
                                      None))
        assert_same_rollout(local, over_rpc)
        assert server.env.request_log()["/verify_answer"] == {"200": 1}
    finally:
        server.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_research_rollout_on_servers_equals_in_process(server_pkg):
    """The port's research tools on either package's server search and read
    what the in-process corpus gives."""
    server = (PortServer(t_research.ResearchEnvironment()) if server_pkg == "port"
              else JaxServer(j_research.ResearchEnvironment()))
    problem = {**t_research.load_problems(["train"])[0]}
    replies = ["<search>Biography</search>", "<read>doc_0a</read>", "<read>doc_nope</read>",
               f"<answer>{problem['answer']}</answer>"]
    try:
        cfg = Config({"actor": {}, "environment": [{"hostname": "127.0.0.1", "port": server.port}]})

        async def remote():
            async with JsonSession() as session:
                return await _scripted("port", t_research_rollouts.generate_research_rollout, cfg, problem, replies,
                                       session)

        over_http = asyncio.run(remote())
        local = asyncio.run(_scripted("port", t_research_rollouts.generate_research_rollout, Config({"actor": {}}),
                                      problem, replies, None))
        assert_same_rollout(local, over_http)
        assert over_http[0].metrics.success and over_http[0].metrics.num_reads == 2
    finally:
        server.stop()
