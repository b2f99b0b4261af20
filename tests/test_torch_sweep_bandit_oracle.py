"""The bandit oracle sweep's reading of a run: the learning gate of
``chip_smoke.phase_rl_loop``, the success curve, and the windows of
optimizer steps whose advantages were all zero, on a run directory
written here by hand."""

import json

from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamWriter
from pipelinerl_tpu_torch.utils.sweep_bandit_oracle import (
    analyse_run,
    parse_seeds,
    summarise,
    zero_advantage_windows,
)


def _step(adv_max, adv_min, entropy, reward):
    return {"rl/max_advantage": adv_max, "rl/min_advantage": adv_min, "rl/entropy": entropy, "rl/reward": reward}


def _write_run(path, rewards, successes, steps):
    with StreamWriter(SingleStreamSpec(str(path), "stats"), "files") as w:
        for r, s in zip(rewards, successes):
            w.write({"reward_mean": r, "success_mean": s})
    (path / "metrics").mkdir(parents=True)
    (path / "metrics" / "trainer_0.jsonl").write_text("".join(json.dumps(s) + "\n" for s in steps))


def test_parse_seeds():
    assert parse_seeds("1-3,42") == [1, 2, 3, 42]
    assert parse_seeds("7") == [7]


def test_zero_advantage_windows():
    steps = [_step(1.0, -1.0, 80.0, 5.0), _step(0, 0, 0.5, 32.0), _step(0, 0, 45.0, 32.0),
             _step(0.3, -0.8, 72.0, 6.0), _step(0, 0, 1.0, 16.0)]
    assert zero_advantage_windows(steps) == [
        {"first": 1, "last": 2, "entropy_first": 0.5, "entropy_last": 45.0, "reward_after": 6.0},
        {"first": 4, "last": 4, "entropy_first": 1.0, "entropy_last": 1.0, "reward_after": None},
    ]


def test_a_run_that_reached_the_target_and_left_it_fails_the_gate(tmp_path):
    steps = [_step(1.0, -1.0, 80.0, 5.0), _step(0, 0, 0.5, 32.0), _step(0, 0, 45.0, 32.0), _step(0.3, -0.8, 72.0, 6.0)]
    _write_run(tmp_path / "collapsed", [0.42, 0.59, 2.0, 2.0, 0.18, 0.92], [0.0, 0.0, 1.0, 1.0, 0.0, 0.0], steps)
    _write_run(tmp_path / "learned", [0.44, 0.45, 0.9, 0.97, 0.98], [0.0] * 5, steps[:1])
    collapsed, learned = analyse_run(tmp_path / "collapsed"), analyse_run(tmp_path / "learned")
    assert collapsed["gate"] is False and collapsed["reached"] and collapsed["success_last"] == 0.0
    assert abs(collapsed["early"] - 0.505) < 1e-9 and abs(collapsed["late"] - 0.55) < 1e-9
    assert collapsed["steps"] == 4 and len(collapsed["zero_advantage_windows"]) == 1
    assert learned["gate"] is True and not learned["reached"]
    assert summarise([collapsed, learned]) == {
        "runs": 2, "gate_failed": 1, "reached_target": 1, "reached_then_left": 1,
        "zero_advantage_windows": 1, "windows_where_entropy_rose": 1,
    }
