"""The VLM path through the port's launcher on the CPU: ``vlm_bandit_cpu``
inline (the toy VLM of ``build_model``, the toy tower of ``build_vision``,
the toy processor of ``build_processor``; a few steps here, the learning
oracle under ``-m slow``), ``validate_config``'s VLM rule against the JAX
package's, and the HF route (``_is_vlm_checkpoint``, ``build_vision``,
``build_processor``) on a directory the port's ``export_hf`` writes."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import vl_tokenizer_dir
from pipelinerl_tpu import launch as j_launch
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.inference.processor import HFVisualProcessor
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models import vision as tv
from pipelinerl_tpu_torch.models.toy_tokenizer import IMAGE, ToyVisualProcessor
from pipelinerl_tpu_torch.train.checkpoints import export_hf
from pipelinerl_tpu_torch.train.trainer import param_leaves

torch.set_num_threads(1)


def flat(tree) -> dict:
    return dict(param_leaves(tree))


REPO = Path(__file__).resolve().parent.parent


def run_vlm_bandit(out, *extra, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=vlm_bandit_cpu", f"output_dir={out}",
         "finetune.save_checkpoint_steps=0", "device=cpu", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_vlm_bandit_cpu_runs_inline(tmp_path):
    """Four steps of the preset: every group's prompts carry the image
    (one prefill per GRPO cluster, its siblings forked), the trainer takes
    the visual rows, and the run ends with its summary."""
    stats = run_vlm_bandit(tmp_path, "finetune.max_train_steps=4", "total_groups=10")
    assert stats["trainer"]["completed_steps"] == 4 and stats["trainer"]["samples"] == 64
    engine = stats["engine"]
    assert engine["prefill_batches"] >= 8 and engine["prefill_reused_tokens"] > 0
    assert engine["prefix_cache_parked_slots"] == 0  # visual slots are never parked
    with open(tmp_path / "streams" / "actor" / "0" / "0.jsonl") as f:
        samples = [s for line in f for s in json.loads(line)["samples"]]
    assert samples and all(s["visual_features"]["image_grid_thw"] == [[1, 4, 4]] for s in samples)
    prompts = [[i for i, label in zip(s["input_ids"], s["labels"]) if label == -100] for s in samples]
    assert all(p.count(IMAGE) == 4 for p in prompts)


@pytest.mark.slow
def test_vlm_bandit_learns_on_the_port(tmp_path):
    """JAX's gate (tests/test_e2e_vlm_bandit.py): at least 100 steps, and a
    success tail of at least 0.7 in one of two runs (an image-blind policy
    caps at 0.5)."""
    tails = []
    for attempt in range(2):
        stats = run_vlm_bandit(tmp_path / f"run{attempt}", timeout=1500)
        assert stats["trainer"]["completed_steps"] >= 100, stats["trainer"]
        tails.append(stats["actor"]["success_tail_mean"])
        if tails[-1] >= 0.7:
            return
    raise AssertionError(f"VLM bandit never cleared 0.7: tails={tails}")


@pytest.mark.parametrize("over", [["parallel.cp=2"], ["parallel.dp=2"], []])
def test_validate_config_vlm_rule_equals_jax(over):
    overrides = ["output_dir=/tmp/unused", *[f"+{o}" for o in over]]
    jcfg, tcfg = j_compose("conf", "vlm_bandit_cpu", overrides), compose("vlm_bandit_cpu", overrides)
    outcomes = []
    for fn, cfg in ((j_launch.validate_config, jcfg), (launch.validate_config, tcfg)):
        try:
            fn(cfg)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append("requires parallel.cp == 1 and dp == 1" in str(e))
    assert outcomes[0] == outcomes[1] == (True if over else None)
    with pytest.raises(ValueError, match="inline only"):
        launch.validate_config(compose("vlm_bandit_cpu", ["output_dir=/tmp/unused", "launch_mode=processes"]))


def test_toy_vlm_builds_as_jax_builds_it():
    """``build_model``'s toy VLM (mrope sections split from the head, the
    IMAGE placeholder), ``build_vision``'s tower config and
    ``build_processor``'s toy processor, against the JAX launcher's."""
    overrides = ["output_dir=/tmp/unused"]
    jcfg, tcfg = j_compose("conf", "vlm_bandit_cpu", overrides), compose("vlm_bandit_cpu", overrides)
    jparams, jmc, _ = j_launch.build_model(jcfg)
    tparams, tmc, tok = launch.build_model(tcfg, "cpu")
    assert (tmc.mrope_section, tmc.image_token_id) == (jmc.mrope_section, jmc.image_token_id) == ((8, 4, 4), IMAGE)
    jvp, jvc = j_launch.build_vision(jcfg, jmc)
    tvp, tvc = launch.build_vision(tcfg, tmc, "cpu")
    assert {k: getattr(tvc, k) for k in tv.VisionConfig.__dataclass_fields__ if k != "dtype"} == {
        k: getattr(jvc, k) for k in tv.VisionConfig.__dataclass_fields__ if k != "dtype"}
    assert {k: tuple(v.shape) for k, v in flat(tvp).items()} == {k: tuple(v.shape) for k, v in flat(jvp).items()}
    assert isinstance(launch.build_processor(tcfg, tok, tvc), ToyVisualProcessor)
    assert launch.build_processor(compose("bandit_cpu", overrides), tok, None) is None


def test_hf_vlm_directory_takes_the_chartqa_route(tmp_path):
    """A Qwen2.5-VL directory from the port's ``export_hf`` (a trained tower,
    the published config's extra keys, the vision tokens added to the
    fixture tokenizer): ``_is_vlm_checkpoint`` in both launchers,
    ``build_model`` with mrope and the image token, ``build_vision`` reading
    the tower back bit for bit, and ``build_processor`` an
    ``HFVisualProcessor`` whose prompts expand the image."""
    tokens = {"<|vision_start|>": 540, "<|vision_end|>": 541, "<|image_pad|>": 542}
    mc = tt.ModelConfig(vocab_size=600, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                        num_kv_heads=2, attention_bias=True, tie_word_embeddings=True, dtype=torch.float32,
                        mrope_section=(2, 1, 1), image_token_id=542,
                        hf_architecture="Qwen2_5_VLForConditionalGeneration")
    vc = tv.VisionConfig(hidden_size=16, intermediate_size=32, num_heads=2, depth=2, out_hidden_size=32,
                         dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), mc, "cpu")
    params["vision_tower"] = tv.init_vision_params(torch.Generator().manual_seed(1), vc, "cpu")
    out = export_hf(tmp_path, params, mc, vision_cfg=vc)
    vl_tokenizer_dir(out, tokens)
    config = json.loads((out / "config.json").read_text())
    config.update(rope_scaling={"type": "mrope", "mrope_section": [2, 1, 1]}, vision_start_token_id=540,
                  vision_end_token_id=541)
    (out / "config.json").write_text(json.dumps(config))
    assert launch._is_vlm_checkpoint(str(out)) and j_launch._is_vlm_checkpoint(str(out))
    assert not launch._is_vlm_checkpoint("toy") and not launch._is_vlm_checkpoint(str(tmp_path / "nope"))
    cfg = compose("chartqa", ["output_dir=/tmp/unused", f"model_path={out}", "finetune.param_dtype=float32"])
    got, gmc, tok = launch.build_model(cfg, "cpu")
    assert (gmc.mrope_section, gmc.image_token_id, gmc.vision_start_token_id) == ((2, 1, 1), 542, 540)
    assert gmc.valid_vocab == len(tok) == 543
    tower, gvc = launch.build_vision(cfg, gmc, "cpu")
    assert gvc == vc
    mine = flat(params["vision_tower"])
    for name, t in flat(tower).items():
        assert torch.equal(t, mine[name]), name
    processor = launch.build_processor(cfg, tok, gvc)
    assert isinstance(processor, HFVisualProcessor)
    feats = {"pixel_values": np.zeros((24, vc.patch_dim), np.float32), "image_grid_thw": [1, 4, 6]}
    ids, visual = processor([{"role": "user", "content": [{"type": "image", "image": feats},
                                                          {"type": "text", "text": "hi"}]}])
    assert ids.count(542) == 6 and ids.count(540) == ids.count(541) == 1 and visual["pixel_values"].shape == (24, 1176)
