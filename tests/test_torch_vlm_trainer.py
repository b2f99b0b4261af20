"""The port's VLM training path against the JAX package's, on the JAX test's
toy VLM (tests/test_vlm_trainable_tower.py) with fp32 weights carried
through numpy: ``pack_visual_sample``; one VLM pass's loss and gradients
with a frozen tower (which gets none) and a trained one; LoRA with a
trained tower refused; save and resume carrying ``vision_tower``; a push
that refreshes the engine's tower; the VLM ``export_hf`` byte for byte with
JAX's and each package's ``load_hf_vision`` reading the other's directory."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.models import hf_loader as jl
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models import vision as jv
from pipelinerl_tpu.train import packing as jpack
from pipelinerl_tpu.train import trainer as jtr
from pipelinerl_tpu.train.advantages import prepare_rl_fields as j_prepare
from pipelinerl_tpu.train.checkpoints import export_hf as j_export_hf
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import hf_loader as tl
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models import vision as tv
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamWriter
from pipelinerl_tpu_torch.train import checkpoints as ck
from pipelinerl_tpu_torch.train import packing as tpack
from pipelinerl_tpu_torch.train import trainer as ttr
from pipelinerl_tpu_torch.train.advantages import prepare_rl_fields
from pipelinerl_tpu_torch.types import MASKED_TOKEN_ID, TrainerBatch

torch.set_num_threads(1)
IMG, EOS = 60, 59
MKW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           mrope_section=(2, 1, 1), image_token_id=IMG)
VKW = dict(hidden_size=16, intermediate_size=32, num_heads=2, depth=2, out_hidden_size=32, patch_size=2,
           temporal_patch_size=1, spatial_merge_size=2, window_size=8, fullatt_block_indexes=(1,))
L = 48
OVERRIDES = ["finetune.samples_per_step=1", "finetune.max_train_steps=2", f"finetune.seq_length={L}",
             "finetune.learning_rate=1e-2", "finetune.num_warmup_steps=0", "finetune.gradient_checkpointing=false",
             "finetune.save_checkpoint_steps=0"]
# fp32 on both sides, sums in another order: the loss to 1e-5 relative, each
# gradient tensor to 1e-4 of its largest entry
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def jax_models():
    jcfg, jvcfg = jt.ModelConfig(dtype=jnp.float32, **MKW), jv.VisionConfig(dtype=jnp.float32, **VKW)
    return jt.init_params(jax.random.key(0), jcfg), jcfg, jv.init_vision_params(jax.random.key(1), jvcfg), jvcfg


def port_models():
    jparams, _, jvparams, _ = jax_models()
    tcfg, tvcfg = tt.ModelConfig(dtype=torch.float32, **MKW), tv.VisionConfig(dtype=torch.float32, **VKW)
    return (tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu"), tcfg,
            tt.params_from_numpy(jax.tree.map(np.asarray, jvparams), tcfg, "cpu"), tvcfg)


def sample(prepare, grid=(1, 4, 6), seed=3):
    """One VLM sample (the JAX test's, with a wider image): prompt text, the
    image's placeholders, an answer of four tokens."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(grid))
    prompt = [1, 2] + [IMG] * (n // 4) + [3]
    out = [5, 6, 7, EOS]
    s = prepare({
        "input_ids": prompt + out, "labels": [MASKED_TOKEN_ID] * len(prompt) + out, "reward": 1.0,
        "logprobs": [-0.5] * len(out), "group_id": "g", "rollout_index": 0, "step_index": 0, "finished": True,
        "model_version": 0,
        "visual_features": {"pixel_values": rng.normal(size=(n, 12)).astype(np.float32),
                            "image_grid_thw": np.asarray([grid], np.int64)},
    })
    s["advantages"] = [1.0] * len(s["input_ids"])
    return s


def batches():
    jb = jpack.pack_visual_sample(sample(j_prepare), L, EOS, IMG, 2)
    tb = tpack.pack_visual_sample(sample(prepare_rl_fields), L, EOS, IMG, 2)
    return jb, tb


def test_pack_visual_sample_equals_jax():
    jb, tb = batches()
    for name, arr in jb.arrays().items():
        np.testing.assert_array_equal(tb.arrays()[name], arr, err_msg=name)
    assert (tb.padding, tb.num_sequences, tb.model_version) == (jb.padding, jb.num_sequences, jb.model_version)
    assert sorted(tb.visual) == sorted(jb.visual)
    for k, v in jb.visual.items():
        np.testing.assert_array_equal(tb.visual[k], v, err_msg=k)
        assert tb.visual[k].dtype == v.dtype
    # the stream message round-trips the visual row in both packages' forms
    msg = tb.to_msg()
    assert msg == json.loads(json.dumps(jb.to_msg()))
    back = TrainerBatch.from_msg(json.loads(json.dumps(msg)))
    for k, v in tb.visual.items():
        np.testing.assert_array_equal(back.visual[k], v)


def trainers(tmp_path, train_tower):
    jparams, jcfg, jvparams, jvcfg = jax_models()
    tparams, tcfg, tvparams, tvcfg = port_models()
    over = [f"output_dir={tmp_path}", *OVERRIDES, f"finetune.train_vision_tower={str(train_tower).lower()}"]
    jpushed, tpushed = [], []
    jloop = jtr.TrainerLoop(j_compose("conf", "base", over), jparams, jcfg, str(tmp_path / "j"),
                            weight_update_cb=lambda p, v: jpushed.append((p, v)), vision_params=jvparams,
                            vision_cfg=jvcfg)
    tloop = ttr.TrainerLoop(compose("base", over), tparams, tcfg, str(tmp_path / "t"),
                            weight_update_cb=lambda p, v: tpushed.append((p, v)), vision_params=tvparams,
                            vision_cfg=tvcfg)
    return jloop, tloop, jpushed, tpushed


@pytest.mark.parametrize("train_tower", [False, True])
def test_vlm_pass_loss_and_gradients_equal_jax(tmp_path, train_tower):
    jloop, tloop, _, _ = trainers(tmp_path, train_tower)
    assert tloop.train_vision == jloop.train_vision == train_tower
    assert ("vision_tower" in tloop.params) == ("vision_tower" in jloop.params) == train_tower
    jb, tb = batches()
    jm = jloop.train_pass(jb)
    tm = tloop.train_pass(tb)
    assert tm["loss"] == pytest.approx(jm["loss"], rel=LOSS_RTOL)
    for key in ("entropy", "new_logprobs", "num_output_tokens_sum"):
        assert tm[key] == pytest.approx(jm[key], rel=1e-4)
    jgrads = dict(ttr.param_leaves(jax.tree.map(np.asarray, jloop._grad_accum)))
    tgrads = {name: p.grad for name, p in ttr.param_leaves(tloop.params)}
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        got = tgrads[name].numpy()
        np.testing.assert_allclose(got, g, rtol=0, atol=GRAD_RTOL * max(np.abs(g).max(), 1e-12), err_msg=name)
    tower = [n for n in tgrads if n.startswith("vision_tower.")]
    if train_tower:
        assert tower and all(float(tgrads[n].abs().sum()) > 0 for n in tower if "merger" in n or "wqkv" in n)
    else:
        # the frozen tower is out of the trainable tree and gets no gradient
        assert not tower and all(p.grad is None for _, p in ttr.param_leaves(tloop.vision_params))


def test_trained_tower_moves_pushes_and_refreshes_the_engine(tmp_path):
    _, tloop, _, tpushed = trainers(tmp_path, True)
    before = ttr.detached_copy(tloop.params["vision_tower"])
    tloop.train_pass(batches()[1])
    tloop.optimizer_step()
    assert max(float((p.detach() - q).abs().max()) for (_, p), (_, q) in
               zip(ttr.param_leaves(tloop.params["vision_tower"]), ttr.param_leaves(before))) > 0
    writer = StreamWriter(SingleStreamSpec(exp_path=str(tmp_path), topic="weight_update_request"))
    tloop.maybe_push_weights(writer, force=True)
    writer.close()
    pushed, version = tpushed[-1]
    assert "vision_tower" in pushed
    tparams, tcfg, tvparams, tvcfg = port_models()
    engine = te.InferenceEngine(tparams, tcfg, te.EngineConfig(max_slots=2, max_len=64, prefill_buckets=(32,),
                                                               cache_dtype=torch.float32),
                                eos_token_id=EOS, device="cpu", vision_params=tvparams, vision_cfg=tvcfg)
    engine.update_params(pushed, version=7)
    engine.step()
    assert engine.version == 7 and "vision_tower" not in engine.params
    trained = dict(ttr.param_leaves(tloop.params["vision_tower"]))
    for name, a in ttr.param_leaves(engine.vision_params):
        assert torch.equal(a, trained[name].detach()), name
    engine.stop()


def test_lora_with_a_trained_tower_is_refused(tmp_path):
    over = [f"output_dir={tmp_path}", "finetune.samples_per_step=1", "finetune.train_vision_tower=true",
            "+finetune.lora.enabled=true", "+finetune.lora.r=2"]
    jparams, jcfg, jvparams, jvcfg = jax_models()
    tparams, tcfg, tvparams, tvcfg = port_models()
    with pytest.raises(ValueError, match="LoRA"):
        jtr.TrainerLoop(j_compose("conf", "base", over), jparams, jcfg, str(tmp_path), vision_params=jvparams,
                        vision_cfg=jvcfg)
    with pytest.raises(ValueError, match="LoRA"):
        ttr.TrainerLoop(compose("base", over), tparams, tcfg, str(tmp_path), vision_params=tvparams,
                        vision_cfg=tvcfg)


def test_save_and_resume_carry_the_tower(tmp_path):
    """A trained tower is part of the training state: a resumed trainer
    holds the saved tower and optimizer state bit for bit, and its export
    has the tower under ``visual.*``."""
    _, tloop, _, _ = trainers(tmp_path, True)
    tloop.train_pass(batches()[1])
    tloop.optimizer_step()
    tloop.save_checkpoint()
    _, resumed, _, _ = trainers(tmp_path, True)
    assert resumed.try_resume() and resumed.metrics.completed_steps == 1
    for (name, a), (_, b) in zip(ttr.param_leaves(resumed.params), ttr.param_leaves(tloop.params)):
        assert torch.equal(a, b), name
    assert any(n.startswith("vision_tower.") for n, _ in ttr.param_leaves(resumed.params))
    state = resumed.optimizer.state_dict()["state"]
    assert len(state) == len(ttr.param_leaves(tloop.params))
    back, vcfg = tl.load_hf_vision(tmp_path / "t" / "finetune" / ck.CURRENT_DIR, dtype=torch.float32, device="cpu")
    assert vcfg == tloop.vision_cfg
    trained = dict(ttr.param_leaves(tloop.params["vision_tower"]))
    for name, a in ttr.param_leaves(back):
        assert torch.equal(a, trained[name].detach()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_export_hf_bytes_equal_jax_and_loaders_cross(tmp_path, dtype):
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    flags = dict(attention_bias=True, tie_word_embeddings=True, hf_architecture="Qwen2_5_VLForConditionalGeneration")
    jcfg, tcfg = jt.ModelConfig(dtype=jdtype, **MKW, **flags), tt.ModelConfig(dtype=tdtype, **MKW, **flags)
    jvcfg, tvcfg = jv.VisionConfig(dtype=jdtype, **VKW), tv.VisionConfig(dtype=tdtype, **VKW)
    rng = np.random.default_rng(5)
    noisy = lambda x: (np.asarray(x, np.float32) + 0.05 * rng.normal(size=x.shape)).astype(np.float32)  # noqa: E731
    tree = jax.tree.map(noisy, jt.init_params(jax.random.key(3), jcfg))
    tree["vision_tower"] = jax.tree.map(noisy, jv.init_vision_params(jax.random.key(4), jvcfg))
    j_dir = j_export_hf(tmp_path / "jax", jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree), jcfg,
                        vision_cfg=jvcfg)
    t_dir = ck.export_hf(tmp_path / "port", tt.params_from_numpy(tree, tcfg, "cpu"), tcfg, vision_cfg=tvcfg)
    assert (t_dir / "model.safetensors").read_bytes() == (j_dir / "model.safetensors").read_bytes()
    assert json.loads((t_dir / "config.json").read_text()) == json.loads((j_dir / "config.json").read_text())
    # each package's loader reads the other's directory, the same bits
    jvp, jvc = jl.load_hf_vision(t_dir, dtype=jdtype)
    tvp, tvc = tl.load_hf_vision(j_dir, dtype=tdtype, device="cpu")
    assert jvc.depth == tvc.depth == VKW["depth"] and tvc.fullatt_block_indexes == jvc.fullatt_block_indexes
    ours = dict(ttr.param_leaves(tvp))
    for name, a in ttr.param_leaves(jax.tree.map(np.asarray, jvp)):
        assert a.tobytes() == ours[name].contiguous().view(torch.uint8).numpy().tobytes(), name
    assert tl.load_model_config(j_dir, tdtype) == dataclass_like(jl.load_model_config(t_dir), tdtype)


def dataclass_like(jcfg, dtype):
    """A JAX ``ModelConfig`` as the port's, field for field."""
    return tt.ModelConfig(**{k: getattr(jcfg, k) for k in tt.ModelConfig.__dataclass_fields__ if k != "dtype"},
                          dtype=dtype)
