"""Faults of the port against the reference, repaired: the attention
names ``blockwise`` and ``cp`` that the JAX trainer and engine accept;
``finetune.memory_debug`` / ``finetune.profile``, which the JAX trainer
reads and the port, once refusing them, now runs; and the
session fault shared with JAX: JAX's ``ActorLoop`` hands every rollout
``session=None``, so its domains never reach the environment servers its
launcher starts (and deep_research with servers listed fails), while the
port's actor opens one session and its rollouts reach the servers."""

import asyncio
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu import actor as j_actor
from pipelinerl_tpu import state as j_state
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.domains.deep_research import rollouts as j_research
from pipelinerl_tpu.domains.logic import rollouts as j_logic
from pipelinerl_tpu.inference import engine as j_engine
from pipelinerl_tpu.inference.client import InProcessLLM as JInProcessLLM
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu.ops.blockwise_attention import mha_packed_blockwise
from pipelinerl_tpu_torch import actor as t_actor
from pipelinerl_tpu_torch import state as t_state
from pipelinerl_tpu_torch.config import Config, compose
from pipelinerl_tpu_torch.domains.deep_research import environment as t_research_env
from pipelinerl_tpu_torch.domains.deep_research import rollouts as t_research
from pipelinerl_tpu_torch.domains.logic import dataset as logic_dataset
from pipelinerl_tpu_torch.domains.logic import rollouts as t_logic
from pipelinerl_tpu_torch.domains.logic.verifier_api import LogicEnvironment
from pipelinerl_tpu_torch.domains.math import rollouts as t_math
from pipelinerl_tpu_torch.domains.miniwob import rollouts as t_miniwob
from pipelinerl_tpu_torch.inference.client import InProcessLLM
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader
from pipelinerl_tpu_torch.utils.http_json import JsonSession
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.launch import validate_config
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.ops.gqa_attention import mha_packed_gqa
from pipelinerl_tpu_torch.train import trainer as ttr
from tests.test_logic_domain import _oracle
from tests.test_torch_domain_math import ScriptedEngine
from tests.test_torch_transformer import make_models, packed_row

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 both sides; blockwise sums by tiles, in another order


@pytest.mark.parametrize("H,K,q_offset,Lq", [(4, 4, 0, 192), (4, 2, 0, 192), (6, 2, 64, 128)])
def test_blockwise_route_matches_mha_packed_blockwise(H, K, q_offset, Lq):
    """What ``attn_impl="blockwise"`` runs (the GQA autograd function; its
    plain versions on the CPU) against JAX's ``mha_packed_blockwise`` on the
    same fp32 inputs from a seed, small blocks so that several tiles run:
    output and the gradients of q, k and v, a query block at an offset
    (the context-parallel shard's layout) included."""
    rng = np.random.default_rng(H * 10 + K + q_offset)
    B, Lkv, Dh = 2, q_offset + Lq, 16
    q = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    do = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    kv_seg = np.sort(rng.integers(0, 4, (B, Lkv)), axis=1).astype(np.int32)
    q_seg = kv_seg[:, q_offset:]

    def jf(q_, k_, v_):
        return mha_packed_blockwise(q_, k_, v_, jnp.asarray(q_seg), jnp.asarray(kv_seg), q_offset, None, 64, 32)

    j_out, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = mha_packed_gqa(*leaves, torch.from_numpy(np.ascontiguousarray(q_seg)), torch.from_numpy(kv_seg),
                            q_offset)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    for leaf, ref in zip(leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["blockwise", "cp"])
def test_forward_under_blockwise_and_cp_matches_jax(name):
    """The model's forward under each name against the JAX forward under
    the same name: ``blockwise`` runs JAX's blockwise kernel there and the
    port's GQA route here; ``cp`` (no cp axis) runs the plain attention in
    both."""
    jcfg, jp, tcfg, tp = make_models(3)
    ids, pos, seg = packed_row(np.random.default_rng(4), B=2, L=24, n_segs=3)
    j_logits = jt.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg), attn_impl=name)
    impl = ttr.resolve_attn_impl(name, 24, torch.device("cpu"))
    t_logits = tt.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), torch.from_numpy(seg),
                          attn_impl=impl)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-4)


def test_trainer_and_engine_accept_blockwise_and_cp():
    """The trainer resolves ``cp`` to the plain attention (the JAX trainer
    does so without a cp axis) and keeps ``blockwise``, which ``forward``
    routes to the GQA kernels; the engine runs ``blockwise`` and ``flash``
    on the GQA route and ``cp`` on the plain one, as the JAX engine's
    forward does, where it raised before."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ttr.resolve_attn_impl("cp", 32768, cuda) == "xla"
    assert ttr.resolve_attn_impl("blockwise", 4096, cpu) == "blockwise"
    assert ttr.resolve_attn_impl("auto", 4096, cuda) == "gqa"
    assert ttr.resolve_attn_impl("auto", 4096, cpu) == "xla"
    for name, want in (("blockwise", "gqa"), ("flash", "gqa"), ("cp", "xla"), ("auto", "gqa")):
        assert te._resolve_impl(name, cuda, "gqa") == want
    with pytest.raises(ValueError, match="unknown attention"):
        te._resolve_impl("nope", cuda, "gqa")
    cfg = tt.ModelConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                         num_kv_heads=1, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for name, want in (("blockwise", "gqa"), ("cp", "xla")):
        engine = te.InferenceEngine(params, cfg, te.EngineConfig(max_slots=2, max_len=32, prefill_buckets=(8,),
                                                                 cache_dtype=torch.float32, attn_impl=name),
                                    eos_token_id=1, device="cpu")
        assert engine.attn_impl == want


@pytest.mark.parametrize("key", ["memory_debug", "profile"])
def test_memory_debug_and_profile_run_as_in_jax(key, tmp_path):
    """JAX's trainer builds a memory debugger and a step profiler from these
    keys; the port's ``validate_config`` takes ``enabled: true`` and
    ``false`` as JAX's does, and builds the same (``utils/memory_debug.py``;
    ``tests/test_torch_memory_debug.py`` runs them)."""
    from pipelinerl_tpu import launch as j_launch
    from pipelinerl_tpu.utils import memory_debug as j_md
    from pipelinerl_tpu_torch.utils import memory_debug as t_md

    make = {"memory_debug": ("create_memory_debugger", "MemoryDebugger", "NullDebugger"),
            "profile": ("create_step_profiler", "StepProfiler", "NullProfiler")}[key]
    for flag in ("true", "false"):
        ov = [f"output_dir={tmp_path}", f"+finetune.{key}.enabled={flag}"]
        cfg, jcfg = compose("bandit_cpu", ov), j_compose("conf", "bandit_cpu", ov)
        validate_config(cfg)
        j_launch.validate_config(jcfg)
        built = getattr(t_md, make[0])(cfg, str(tmp_path))
        jbuilt = getattr(j_md, make[0])(jcfg, str(tmp_path / "jax"))
        want = make[1] if flag == "true" else make[2]
        assert type(built).__name__ == type(jbuilt).__name__ == want
        for obj in (built, jbuilt):
            if hasattr(obj, "close"):
                obj.close()


# -- the session fault (shared with JAX) ---------------------------------------

LOGIC_PROBLEMS = logic_dataset.load_problems(["train"])[:2]


def logic_replies() -> list[str]:
    """Per problem, a right and a wrong answer (the group's two attempts)."""
    out = []
    for p in LOGIC_PROBLEMS:
        ctx = p["reward_context"]
        out += [f"<answer>{_oracle(ctx['task'], ctx['game_data'])}</answer>", "<answer>surely not</answer>"]
    return out


def run_actor(pkg: str, exp: str, environment: list | None, policy=None) -> list[float]:
    """Two logic groups of two attempts, one group at a time, through the
    package's ``ActorLoop`` with a scripted LLM; → the sample rewards in
    the actor stream's order."""
    ov = ["output_dir=" + exp, "attempts=2", "actor.max_parallel_groups=1"]
    if environment:
        ov.append("+environment=[" + ",".join(f"{{hostname: {e['hostname']}, port: {e['port']}}}"
                                               for e in environment) + "]")
    if pkg == "port":
        cfg, mod, state, llm_cls, tok, eng = compose("logic", ov), t_actor, t_state, InProcessLLM, ToyTokenizer(), \
            __import__("pipelinerl_tpu_torch.inference.engine", fromlist=["x"])
        policy = policy or t_logic.generate_logic_rollout
    else:
        cfg, mod, state, llm_cls, tok, eng = j_compose("conf", "logic", ov), j_actor, j_state, JInProcessLLM, \
            JToyTokenizer(), j_engine
        policy = policy or j_logic.generate_logic_rollout
    ids = [tok.encode(r) + [tok.eos_token_id] for r in logic_replies()]
    llm = llm_cls(ScriptedEngine(eng, ids, "stop"), tok, {"max_tokens": 64})
    loop = mod.ActorLoop(cfg, [llm], copy.deepcopy(LOGIC_PROBLEMS), state.TrainerState(exp), exp, policy)
    asyncio.run(loop.run(total_groups=len(LOGIC_PROBLEMS)))
    groups = list(StreamReader(SingleStreamSpec(exp, "actor")).read_available())
    return [s["reward"] for g in groups for s in g["samples"]]


def test_the_actor_session_reaches_the_verifier_server(tmp_path):
    """With ``cfg.environment`` naming a ``LogicEnvironment``, the port's
    actor grades every rollout on it (its request log counts them), with
    the rewards of in-process grading."""
    server = LogicEnvironment()
    port = server.start(host="127.0.0.1", port=0)
    try:
        remote = run_actor("port", str(tmp_path / "remote"), [{"hostname": "127.0.0.1", "port": port}])
        assert server.request_log()["/verify_answer"] == {"200": 4}
    finally:
        server.shutdown()
    local = run_actor("port", str(tmp_path / "local"), None)
    assert remote == local and 1.0 in local and min(local) < 0


def test_the_jax_actor_hands_its_rollouts_no_session(tmp_path):
    """The fault in the reference: with the same config JAX's ``ActorLoop``
    passes ``session=None``, so the server it names sees no request; the
    port's passes a ``JsonSession``."""
    server = LogicEnvironment()
    port = server.start(host="127.0.0.1", port=0)
    environment = [{"hostname": "127.0.0.1", "port": port}]
    sessions = {"jax": [], "port": []}

    def capture(pkg, fn):
        async def policy(cfg, llm, problem, session):
            sessions[pkg].append(session)
            return await fn(cfg, llm, problem, session)

        return policy

    try:
        run_actor("jax", str(tmp_path / "jax"), environment, capture("jax", j_logic.generate_logic_rollout))
        assert "/verify_answer" not in server.request_log()
        run_actor("port", str(tmp_path / "port"), environment, capture("port", t_logic.generate_logic_rollout))
    finally:
        server.shutdown()
    assert sessions["jax"] == [None] * 4
    assert len(sessions["port"]) == 4 and all(isinstance(s, JsonSession) for s in sessions["port"])
    assert len({id(s) for s in sessions["port"]}) == 1  # one session for the loop's life


def test_deep_research_with_servers_listed_runs_in_the_port_and_fails_in_jax():
    """JAX's research tools build no corpus when servers are listed and then
    meet a rollout without a session: ``assert self.corpus is not None``.
    The port's search the server over the actor's session; handed no
    session while servers are listed, they raise naming it rather than
    leave the servers unused."""
    problem = t_research_env.load_problems(["train"])[0]
    replies = ["<search>Biography</search>", f"<answer>{problem['answer']}</answer>"]
    environment = [{"hostname": "127.0.0.1", "port": 1}]

    def rollout(pkg, fn, cfg):
        tok = ToyTokenizer() if pkg == "port" else JToyTokenizer()
        eng = __import__("pipelinerl_tpu_torch.inference.engine", fromlist=["x"]) if pkg == "port" else j_engine
        llm_cls = InProcessLLM if pkg == "port" else JInProcessLLM
        ids = [tok.encode(r) + [tok.eos_token_id] for r in replies]
        return asyncio.run(fn(cfg, llm_cls(ScriptedEngine(eng, ids, "stop"), tok, {"max_tokens": 64}),
                              dict(problem), None))

    from pipelinerl_tpu.config import Config as JConfig

    with pytest.raises(AssertionError):
        rollout("jax", j_research.generate_research_rollout, JConfig({"actor": {}, "environment": environment}))
    with pytest.raises(ValueError, match="no client session"):
        rollout("port", t_research.generate_research_rollout, Config({"actor": {}, "environment": environment}))

    server = t_research_env.ResearchEnvironment()
    port = server.start(host="127.0.0.1", port=0)
    try:
        async def with_session():
            cfg = Config({"actor": {}, "environment": [{"hostname": "127.0.0.1", "port": port}]})
            tok = ToyTokenizer()
            ids = [tok.encode(r) + [tok.eos_token_id] for r in replies]
            async with JsonSession() as session:
                llm = InProcessLLM(ScriptedEngine(te, ids, "stop"), tok, {"max_tokens": 64})
                return await t_research.generate_research_rollout(cfg, llm, dict(problem), session)

        result = asyncio.run(with_session())
        assert result.metrics.success and result.metrics.num_searches == 1
        assert server.request_log()["/search"] == {"200": 1}
    finally:
        server.shutdown()


@pytest.mark.parametrize("domain", ["math", "logic", "miniwob"])
def test_rollouts_handed_no_session_refuse_listed_servers(domain):
    """Each domain that reaches environment servers raises where
    ``cfg.environment`` lists servers and the rollout got no session,
    instead of grading or stepping in process past them; with no server
    listed the same rollout runs in process."""
    fn, problem, reply = {
        "math": (t_math.generate_math_rollout, {"task": "2 + 4", "answer": "6"}, "\\boxed{6}"),
        "logic": (t_logic.generate_logic_rollout, LOGIC_PROBLEMS[0], logic_replies()[0]),
        "miniwob": (t_miniwob.generate_miniwob_rollout, {"task": "simweb.click-button", "seed": 1}, 'click("b0")'),
    }[domain]
    tok = ToyTokenizer()

    def rollout(cfg):
        llm = InProcessLLM(ScriptedEngine(te, [tok.encode(reply) + [tok.eos_token_id]] * 8, "stop"), tok,
                           {"max_tokens": 64})
        return asyncio.run(fn(cfg, llm, copy.deepcopy(problem), None))

    actor = {"task_template": "{task}", "agent_max_loops": 1}
    with pytest.raises(ValueError, match="no client session"):
        rollout(Config({"actor": actor, "environment": [{"hostname": "127.0.0.1", "port": 1}]}))
    assert rollout(Config({"actor": actor})).domain == domain
