"""The port's copies of packing, advantages and the trainer batch message
against the JAX package's on the same samples: arrays equal, and the
``training_data`` stream message byte for byte."""

import copy
import json

import numpy as np
import pytest

from pipelinerl_tpu.train import advantages as jadv
from pipelinerl_tpu.train import packing as jpack
from pipelinerl_tpu.types import TrainerBatch as JBatch
from pipelinerl_tpu_torch.train import advantages as tadv
from pipelinerl_tpu_torch.train import packing as tpack
from pipelinerl_tpu_torch.types import TrainerBatch as TBatch

EOS = 257


def raw_samples(seed=0, n_groups=2, attempts=3):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(n_groups):
        for r in range(attempts):
            n_prompt, n_out = int(rng.integers(2, 6)), int(rng.integers(1, 9))
            ids = rng.integers(0, 256, n_prompt + n_out).tolist()
            if r == 0:
                ids[-1] = EOS  # finished with EOS, no finish reason
            out.append({
                "input_ids": ids,
                "labels": [-100] * n_prompt + ids[n_prompt:],
                "reward": float(rng.integers(0, 3)),
                "logprobs": (-rng.random(n_out)).tolist(),
                "ref_logprobs": (-rng.random(n_out)).tolist() if g == 0 else [],
                "group_id": f"g{g}",
                "rollout_index": r,
                "step_index": 0,
                "model_version": 3 + g,
                "finished": r != 1,
                "finish_reason": {0: None, 1: "length", 2: "stop"}[r],
            })
    return out


def both(seed=0, divide_by_std=False):
    samples = raw_samples(seed)
    j = jadv.populate_rl_data([jadv.prepare_rl_fields(copy.deepcopy(s)) for s in samples], EOS, divide_by_std)
    t = tadv.populate_rl_data([tadv.prepare_rl_fields(copy.deepcopy(s)) for s in samples], EOS, divide_by_std)
    return j, t


@pytest.mark.parametrize("divide_by_std", [False, True])
def test_populate_rl_data_matches(divide_by_std):
    j, t = both(1, divide_by_std)
    assert j == t


def test_pack_samples_and_message_match():
    j, t = both(2)
    jb, tb = jpack.pack_samples(j, 96, EOS), tpack.pack_samples(t, 96, EOS)
    for name, arr in jb.arrays().items():
        np.testing.assert_array_equal(tb.arrays()[name], arr, err_msg=name)
    for attr in ("model_version", "sentinel", "padding", "num_sequences"):
        assert getattr(tb, attr) == getattr(jb, attr)
    np.testing.assert_array_equal(tb.seq_boundaries, jb.seq_boundaries)
    j_msg, t_msg = json.dumps(jb.to_msg(), separators=(",", ":")), json.dumps(tb.to_msg(), separators=(",", ":"))
    assert t_msg == j_msg
    # either package reads the other's message
    back = TBatch.from_msg(json.loads(j_msg))
    for name, arr in JBatch.from_msg(json.loads(t_msg)).arrays().items():
        np.testing.assert_array_equal(back.arrays()[name], arr)


def test_greedy_pack_and_sentinel_match():
    j, t = both(3)
    jp, tp = jpack.greedy_pack(j, 24), tpack.greedy_pack(t, 24)
    assert [len(p) for p in tp] == [len(p) for p in jp] and tp == jp
    js, ts = jpack.make_sentinel_batch(32, EOS, 5), tpack.make_sentinel_batch(32, EOS, 5)
    assert ts.sentinel and ts.model_version == js.model_version == 5
    assert json.dumps(ts.to_msg()) == json.dumps(js.to_msg())
    with pytest.raises(ValueError):
        tpack.pack_samples(t, 8, EOS)
