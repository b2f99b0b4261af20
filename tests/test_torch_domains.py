"""The port's counting and guessing domains against the JAX package's: the
same problems, and under one scripted LLM the same rewards, metrics and
training texts, a guessing run of several turns included. Every preset's
dataset loader, rollout policy and environment-server class resolve (the
server answers ``/health``), and the ``base`` preset runs its guessing
domain through ``run_inline``."""

import asyncio
import json
import urllib.request
from concurrent.futures import Future

import pytest
import torch

from pipelinerl_tpu.domains import counting as j_counting
from pipelinerl_tpu.domains import guessing as j_guessing
from pipelinerl_tpu.inference import engine as j_engine
from pipelinerl_tpu.inference.client import InProcessLLM as JInProcessLLM
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu_torch import presets
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.domains import counting, guessing
from pipelinerl_tpu_torch.domains.registry import resolve, resolve_domain_rollout
from pipelinerl_tpu_torch.inference import engine as t_engine
from pipelinerl_tpu_torch.inference.client import InProcessLLM
from pipelinerl_tpu_torch.launch import run_inline
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer

TEXT_FIELDS = ("text", "n_predicted", "reward", "logprobs", "input_ids", "labels", "finished", "finish_reason",
               "prompt_tokens", "output_tokens")


class ScriptedEngine:
    """An engine stand-in that answers each request with the next scripted
    reply (its bytes, then EOS), as a finished ``GenResult`` of ``mod``."""

    def __init__(self, mod, replies, tokenizer, finish="stop"):
        self.mod, self.replies, self.tok, self.finish = mod, list(replies), tokenizer, finish
        self.prompts = []

    def submit(self, request):
        self.prompts.append(list(request.prompt_ids))
        ids = self.tok.encode(self.replies.pop(0)) + [self.tok.eos_token_id]
        future = Future()
        future.set_result(self.mod.GenResult(ids, [-0.25] * len(ids), self.finish, 3, 4, len(request.prompt_ids)))
        return future

    def abort(self, request_id):
        pass


def rollout_pair(j_fn, t_fn, problem, replies):
    """One rollout of the same problem and replies in each package."""
    out = []
    for mod, llm_cls, tok, fn in ((j_engine, JInProcessLLM, JToyTokenizer(), j_fn),
                                  (t_engine, InProcessLLM, ToyTokenizer(), t_fn)):
        engine = ScriptedEngine(mod, replies, tok)
        result = asyncio.run(fn(None, llm_cls(engine, tok, {"max_tokens": 64}), dict(problem), None))
        out.append((result, engine.prompts))
    return out


def assert_same_rollout(j, t):
    (jr, j_prompts), (tr, t_prompts) = j, t
    assert t_prompts == j_prompts
    assert tr.metrics.model_dump() == jr.metrics.model_dump()
    assert (tr.domain, tr.dataset_name) == (jr.domain, jr.dataset_name)
    assert len(tr.training_texts) == len(jr.training_texts) == len(t_prompts)
    for tt, jt in zip(tr.training_texts, jr.training_texts):
        assert {f: getattr(tt, f) for f in TEXT_FIELDS} == {f: getattr(jt, f) for f in TEXT_FIELDS}
        assert tt.metadata == jt.metadata == {"model_version": 3}


@pytest.mark.parametrize("names", [["train"], ["test"], ["train", "test"]])
def test_load_problems_equal_jax(names):
    assert counting.load_problems(names) == j_counting.load_problems(names)
    assert guessing.load_problems(names) == j_guessing.load_problems(names)
    assert [p["answer"] for p in guessing.load_problems(["train"])[:3]] == [1, 383, 765]  # (2 i 191) % 1024 + 1
    with pytest.raises(ValueError):
        guessing.load_problems(["nope"])


@pytest.mark.parametrize("reply,reward", [("<answer>4</answer>", 1.0), ("<answer>2</answer>", 0.0),
                                          ("four", 0.0)])
def test_counting_rollout_equals_jax(reply, reward):
    problem = {"word": "mississippi", "letter": "s", "count": 4, "dataset": "train", "domain": "counting"}
    j, t = rollout_pair(j_counting.generate_counting_rollout, counting.generate_counting_rollout, problem, [reply])
    assert_same_rollout(j, t)
    assert t[0].metrics.reward == reward and t[0].training_texts[0].reward == reward


@pytest.mark.parametrize(
    "replies,turns,reward",
    [
        # a binary search that finds 383 at the fifth turn: reward 2 - 4/10
        (["<answer>512</answer>", "<answer>256</answer>", "<answer>384</answer>", "<answer>320</answer>",
          "<answer>383</answer>"], 5, 1.6),
        # a format error at the third turn: reward -2 + 2/10
        (["<answer>512</answer>", "<answer>100</answer>", "no idea"], 3, -1.8),
        # thirteen wrong guesses: reward 0
        ([f"<answer>{g}</answer>" for g in range(1, 14)], 13, 0.0),
    ],
)
def test_guessing_rollout_equals_jax(replies, turns, reward):
    problem = {"answer": 383, "dataset": "train", "domain": "guessing"}
    j, t = rollout_pair(j_guessing.generate_guessing_rollout, guessing.generate_guessing_rollout, problem, replies)
    assert_same_rollout(j, t)
    result, prompts = t
    assert len(result.training_texts) == turns
    assert result.metrics.reward == pytest.approx(reward)
    assert all(text.reward == result.metrics.reward for text in result.training_texts)
    # each turn rebuilds its prompt from the first messages plus one feedback
    # message: no turn's prompt extends the previous turn's transcript
    for i in range(1, turns):
        previous = prompts[i - 1] + result.training_texts[i - 1].input_ids[len(prompts[i - 1]):]
        assert prompts[i][: len(previous)] != previous


# presets whose training sets are hub datasets: their loader raises, naming
# the files the repository lacks, and the hermetic sets stand in
HERMETIC = {"math": ["synthetic_arithmetic", "countdown"],
            "multi_domain": ["math::synthetic_arithmetic", "math::countdown", "guessing::train", "counting::train"],
            "tir": ["synthetic_arithmetic"], "coding": ["synthetic_coding"]}


# presets whose every set is a hub split (chartqa's images arrive as
# features; no hermetic set ships): the loader raises, the domain resolves
HUB_ONLY = {"chartqa": "chartqa"}


@pytest.mark.parametrize("name", presets.names())
def test_every_preset_resolves_its_domain_functions(name):
    cfg = compose(name, ["output_dir=/tmp/unused"])
    loader, policy = resolve(cfg.dataset_loader), resolve(cfg.rollout_policy)
    assert callable(loader) and callable(policy)
    names = list(cfg.train_dataset_names)
    if name in HUB_ONLY:
        with pytest.raises(ValueError, match="not in the repository"):
            loader(names)
        assert callable(resolve_domain_rollout(HUB_ONLY[name]))
        return
    if name in HERMETIC:
        with pytest.raises(ValueError, match="not in the repository"):
            loader(names)
        names = HERMETIC[name]
    problems = loader(names)
    assert problems and all(callable(resolve_domain_rollout(d)) for d in {p["domain"] for p in problems})
    if cfg.get("environment_class"):  # the environment-server job's class, served as run_environment serves it
        env = resolve(cfg.environment_class)()
        try:
            port = env.start(host="127.0.0.1", port=0)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as resp:
                assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
        finally:
            env.shutdown()


def test_base_preset_runs_the_guessing_domain(tmp_path):
    """``--config-name=base`` on the CPU (rows as long as the engine's
    ``max_len``, which ``validate_config`` asks of the JAX package too): the
    toy model's guessing rollouts, one optimizer step."""
    torch.set_num_threads(2)
    cfg = compose("base", [f"output_dir={tmp_path}", "device=cpu", "total_groups=1", "llm.parameters.max_tokens=16",
                           "finetune.seq_length=2048", "finetune.samples_per_step=8", "finetune.max_train_steps=1",
                           "finetune.save_checkpoint_steps=0"])
    stats = run_inline(cfg, device="cpu")
    assert stats["actor"]["groups_completed"] == 1
    assert stats["trainer"]["completed_steps"] == 1
