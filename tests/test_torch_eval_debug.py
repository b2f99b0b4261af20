"""Eval interleaving and ``debug.mode``, each beside the JAX package on the
same inputs (the CPU).

- the port's inline loop on ``bandit_cpu`` runs the test problems after each
  version and ``stats_test`` carries a snapshot of each eval, as JAX's
  ``tests/test_e2e_bandit.py`` asks of the JAX loop;
- an eval ``ActorLoop(is_training=False)`` in each package, a scripted LLM
  answering the same ``test_subset`` problems: the same ``actor_test``
  groups and the same ``stats_test`` snapshot, under a config whose lag
  budget, difficulty-aware penalty and ``domain_mix`` would change a
  training loop's;
- ``debug_stages`` against JAX's ``_debug_stages`` for each mode;
  ``debug_link_streams`` of both packages on the same recording; and both
  packages' inline runs replaying one recorded run's streams, which link the
  same topics, pack the same training data and train the same samples;
- ``validate_config`` refuses a mode that drops the actor with nothing to
  replay, as JAX's does."""

import asyncio
import copy
import os

import pytest
import torch

from pipelinerl_tpu import actor as j_actor
from pipelinerl_tpu import launch as j_launch
from pipelinerl_tpu import state as j_state
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.domains.registry import resolve as j_resolve
from pipelinerl_tpu.inference import engine as j_engine
from pipelinerl_tpu.inference.client import InProcessLLM as JInProcessLLM
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu_torch import actor as t_actor
from pipelinerl_tpu_torch import state as t_state
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.domains.registry import resolve
from pipelinerl_tpu_torch.inference import engine as t_engine
from pipelinerl_tpu_torch.inference.client import InProcessLLM
from pipelinerl_tpu_torch.launch import debug_link_streams, debug_replay_topics, debug_stages, run_inline, \
    validate_config
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader
from tests.test_logic_domain import _oracle
from tests.test_torch_domain_math import ScriptedEngine

torch.set_num_threads(1)
CUTS = ["device=cpu", "finetune.save_checkpoint_steps=0", "actor.publish_stats_every_n_groups=2"]


def read(exp, topic) -> list[dict]:
    return list(StreamReader(SingleStreamSpec(str(exp), topic)).read_available())


def test_inline_eval_interleaving_emits_stats_test(tmp_path):
    """An eval pauses the training submissions; with ``max_lag`` 0 the
    trainer then runs at most one step past the eval's version, so of six
    steps' evals at least one runs whole (four test problems, one attempt
    each) before training ends."""
    stats = run_inline(compose("bandit_cpu", [f"output_dir={tmp_path}", *CUTS, "finetune.max_train_steps=6",
                                              "eval_every_n_versions=16", "test_dataset_names=[test]",
                                              "test_subset=4", "max_lag=0"]), device="cpu")
    assert stats["trainer"]["completed_steps"] == 6
    snapshots, groups = read(tmp_path, "stats_test"), read(tmp_path, "actor_test")
    assert any("success_mean" in s for s in snapshots), snapshots
    # each eval's snapshots count its own groups: one reached all four
    assert max(s["groups_completed"] for s in snapshots) == 4
    assert len(groups) >= 4 and all(len(g["samples"]) == 1 and g["samples"][0]["dataset_name"] == "test"
                                    for g in groups)
    assert all(g["samples"][0]["dataset_name"] == "train" for g in read(tmp_path, "actor"))


# A config under which a training loop would differ: 4 attempts, a lag
# budget of one group at version 0, a difficulty-aware penalty on every
# output (buffer_tokens = max_tokens) and a domain_mix that samples problems.
EVAL_OVERRIDES = ["attempts=4", "test_attempts=2", "eval_every_n_versions=1", "test_subset=3", "max_lag=0",
                  "finetune.samples_per_step=2", "actor.max_parallel_groups=1",
                  "actor.publish_stats_every_n_groups=100", "llm.parameters.max_tokens=64",
                  "test_llm.parameters.max_tokens=64", "rewards.buffer_tokens=64",
                  "actor.difficulty_aware_penalty.enabled=true", "+domain_mix={logic: 1.0}"]


def eval_loop(pkg: str, exp: str, is_training: bool = False, overrides=()):
    """The package's ``ActorLoop`` on the ``logic`` preset's ``test_subset``
    problems (the port's ``load_test_problems``; JAX's launcher's rule), a
    scripted LLM giving each group a right and a wrong answer; → (problems,
    loop, the data topic's groups, the stats topic's snapshots)."""
    ov = [f"output_dir={exp}", *EVAL_OVERRIDES, *overrides]
    if pkg == "port":
        cfg = compose("logic", ov)
        problems = t_actor.load_test_problems(cfg)
        mod, state, llm_cls, tok, eng, policy = t_actor, t_state, InProcessLLM, ToyTokenizer(), t_engine, \
            resolve(cfg.rollout_policy)
    else:
        cfg = j_compose("conf", "logic", ov)
        problems = j_resolve(cfg.dataset_loader)(list(cfg.test_dataset_names))[: int(cfg.test_subset)]
        mod, state, llm_cls, tok, eng, policy = j_actor, j_state, JInProcessLLM, JToyTokenizer(), j_engine, \
            j_resolve(cfg.rollout_policy)
    replies = []
    for p in problems:
        ctx = p["reward_context"]
        replies += [f"<answer>{_oracle(ctx['task'], ctx['game_data'])}</answer>", "<answer>surely not</answer>"]
    llm = llm_cls(ScriptedEngine(eng, [tok.encode(r) + [tok.eos_token_id] for r in replies], "stop"), tok,
                  dict(cfg.test_llm.parameters.items()))
    loop = mod.ActorLoop(cfg, [llm], copy.deepcopy(problems), state.TrainerState(exp), exp, policy,
                         is_training=is_training)
    asyncio.run(asyncio.wait_for(loop.run(total_groups=len(problems)), 60))
    data, stats = ("actor", "stats") if is_training else ("actor_test", "stats_test")
    return problems, loop, read(exp, data), read(exp, stats)


def test_eval_loop_equals_jax(tmp_path):
    """Both packages' eval loops write the same ``actor_test`` groups
    (``test_attempts`` samples each, ``dataset_name`` "test", the same
    tokens and rewards) and one ``stats_test`` snapshot at the end with the
    same keys and values. Neither holds to the lag budget (all three groups
    run at version 0), rescales by the difficulty-aware penalty (a training
    loop over the same rollouts does) or samples by ``domain_mix`` (each
    group meets its own problem's answers: one right, one wrong)."""
    t_problems, t_loop, t_groups, t_snaps = eval_loop("port", str(tmp_path / "port"))
    j_problems, j_loop, j_groups, j_snaps = eval_loop("jax", str(tmp_path / "jax"))
    assert t_problems == j_problems and len(t_problems) == 3
    strip = lambda groups: [{**g, "group_id": None, "samples": [{**s, "group_id": None} for s in g["samples"]]}
                            for g in groups]  # noqa: E731
    assert strip(t_groups) == strip(j_groups)
    assert len(t_groups) == 3 and all(len(g["samples"]) == 2 for g in t_groups)
    assert all(s["dataset_name"] == "test" for g in t_groups for s in g["samples"])
    assert all(sorted(s["reward"] > 0 for s in g["samples"]) == [False, True] for g in t_groups)
    assert len(t_snaps) == len(j_snaps) == 1
    rate = "output_tokens_per_second"
    assert {k: v for k, v in t_snaps[0].items() if k != rate} == {k: v for k, v in j_snaps[0].items() if k != rate}
    assert t_snaps[0]["groups_completed"] == 3 and t_snaps[0]["rollouts_completed"] == 6
    for loop in (t_loop, j_loop):  # a training loop on the same config: 4 attempts, one group at version 0
        train = type(loop)(loop.cfg, [], [], loop.trainer_state, loop.exp_path, None)
        assert (loop.attempts, loop._lag_budget(0)) == (2, float("inf")) and (train.attempts, train._lag_budget(0)) \
            == (4, 1)
    # the same rollouts in a port training loop (2 attempts, no lag cap): the
    # penalty rescales the right answers' rewards
    _, _, train_groups, _ = eval_loop("port", str(tmp_path / "train"), True, ["attempts=2", "max_lag=null"])
    rewards = lambda groups: sorted(s["reward"] for g in groups for s in g["samples"])  # noqa: E731
    assert len(train_groups) == 3 and rewards(train_groups) != rewards(t_groups)


@pytest.mark.parametrize("mode", ["", "finetune", "preprocessor", "preprocessor+finetune", "actor+preprocessor",
                                  "actor+finetune", "open_loop", "nonsense"])
def test_debug_stages_equal_jax(mode):
    ov = ["output_dir=/x"] + ([f"+debug.mode={mode}"] if mode else [])
    cfg, jcfg = compose("bandit_cpu", ov), j_compose("conf", "bandit_cpu", ov)
    if mode == "nonsense":
        for fn, c in ((debug_stages, cfg), (j_launch._debug_stages, jcfg)):
            with pytest.raises(ValueError, match="Unknown debug.mode"):
                fn(c)
        return
    assert debug_stages(cfg) == j_launch._debug_stages(jcfg)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A full bandit_cpu run whose streams the debug modes replay."""
    exp = tmp_path_factory.mktemp("recorded")
    run_inline(compose("bandit_cpu", [f"output_dir={exp}", *CUTS, "finetune.max_train_steps=2"]), device="cpu")
    return exp


def links(exp) -> dict[str, str]:
    root = exp / "streams"
    return {name: os.readlink(root / name) for name in sorted(os.listdir(root)) if (root / name).is_symlink()}


@pytest.mark.parametrize("mode", ["finetune", "preprocessor", "preprocessor+finetune", "actor+preprocessor",
                                  "open_loop"])
def test_debug_link_streams_equal_jax(tmp_path, recorded, mode):
    """Each mode's replayed topics linked by both packages' functions from
    the same recording: the same links; linking again keeps them; a topic
    the recording lacks raises in both."""
    topics = debug_replay_topics(debug_stages(compose("bandit_cpu", ["output_dir=/x", f"+debug.mode={mode}"])))
    for fn, exp in ((debug_link_streams, tmp_path / "port"), (j_launch.debug_link_streams, tmp_path / "jax")):
        fn(str(exp), str(recorded), topics)
        fn(str(exp), str(recorded), topics)
        with pytest.raises(FileNotFoundError, match="No recorded stream"):
            fn(str(exp), str(recorded), ["absent"])
    assert links(tmp_path / "port") == links(tmp_path / "jax")
    assert sorted(links(tmp_path / "port")) == sorted(topics)


@pytest.mark.parametrize("mode,stages", [("finetune", {"trainer"}), ("preprocessor+finetune", {"preprocessor",
                                                                                               "trainer"})])
def test_debug_mode_replays_the_recorded_streams(tmp_path, recorded, mode, stages):
    """Both packages' inline runs of ``mode`` on one recording: the same
    streams linked (JAX's launcher decides its own), the same training data
    packed anew where the preprocessor runs, the same samples and tokens
    trained, the same weight-update requests."""
    assert debug_stages(compose("bandit_cpu", ["output_dir=/x", f"+debug.mode={mode}"])) == stages
    ov = ["finetune.save_checkpoint_steps=0", "actor.publish_stats_every_n_groups=2", "finetune.max_train_steps=2",
          f"+debug.mode={mode}", f"+debug.streams_from={recorded}"]
    port, jax = tmp_path / "port", tmp_path / "jax"
    stats = run_inline(compose("bandit_cpu", [f"output_dir={port}", "device=cpu", *ov]), device="cpu")
    j_stats = j_launch.run_inline(j_compose("conf", "bandit_cpu", [f"output_dir={jax}", *ov]))
    assert stats["trainer"]["completed_steps"] == 2 and stats["engine"] == {}
    assert stats["actor"]["groups_completed"] == 0
    for key in ("completed_steps", "samples", "tokens", "last_broadcasted_version"):
        assert stats["trainer"][key] == j_stats["trainer"][key], key
    replayed = ["training_data"] if mode == "finetune" else ["actor"]
    assert links(port) == links(jax) == {t: str((recorded / "streams" / t).resolve()) for t in replayed}
    if mode != "finetune":  # the preprocessor packed the recorded groups anew
        assert not (port / "streams" / "training_data").is_symlink() and read(port, "training_data")
        assert read(port, "training_data") == read(jax, "training_data")
    assert len(read(port, "weight_update_request")) == len(read(jax, "weight_update_request")) > 0


def test_open_loop_runs_the_actor_alone(tmp_path):
    stats = run_inline(compose("bandit_cpu", [f"output_dir={tmp_path}", *CUTS, "+debug.mode=open_loop",
                                              "total_groups=3"]), device="cpu")
    assert stats["actor"]["groups_completed"] == 3 and stats["trainer"] == {}
    assert {g["model_version"] for g in read(tmp_path, "actor")} == {0}
    assert not read(tmp_path, "training_data")


@pytest.mark.parametrize("overrides,match", [(["+debug.mode=finetune"], "streams_from"),
                                             (["+debug.mode=preprocessor"], "streams_from"),
                                             (["+debug.mode=nonsense"], "Unknown debug.mode")])
def test_validate_config_refuses_what_jax_refuses(overrides, match):
    """Mirrors ``tests/test_validate_config.py::test_debug_without_replay_rejected``."""
    ov = ["output_dir=/tmp/x", *overrides]
    for validate, cfg in ((validate_config, compose("bandit_cpu", ov)), (j_launch.validate_config,
                                                                           j_compose("conf", "bandit_cpu", ov))):
        with pytest.raises(ValueError, match=match):
            validate(cfg)
    validate_config(compose("bandit_cpu", ["output_dir=/tmp/x", "+debug.mode=finetune", "+debug.streams_from=/y"]))
    validate_config(compose("bandit_cpu", ["output_dir=/tmp/x", "+debug.mode=open_loop"]))
