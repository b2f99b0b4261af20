"""The port's HF loader (``models/hf_loader.py``) against the JAX package's
on the same checkpoint directories: ``build_hf_checkpoint``'s Qwen2
checkpoint (fp32 and bf16, padded vocabulary), Qwen3 (``qk_norm``) and
Llama directories written by JAX's ``export_hf``, tied embeddings, a
checkpoint split over two files, and a VLM architecture, which raises.
Loaded tensors must be equal bit for bit; forward logits at fp32 within
the transformer tests' tolerance."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from pipelinerl_tpu.models import hf_loader as jl
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models.hf_fixture import build_hf_checkpoint
from pipelinerl_tpu.train.checkpoints import export_hf as j_export_hf
from pipelinerl_tpu_torch.models import hf_loader as tl
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.train.trainer import param_leaves

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-4  # fp32 on both sides; sums run in another order
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def assert_same_tensors(jparams: dict, tparams: dict) -> None:
    """Same names, shapes, dtypes and bits."""
    jleaves = dict(param_leaves(jax.tree.map(np.asarray, jparams)))
    tleaves = {name: as_numpy(t) for name, t in param_leaves(tparams)}
    assert sorted(jleaves) == sorted(tleaves)
    for name, a in jleaves.items():
        b = tleaves[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name


def assert_configs_agree(jcfg, tcfg) -> None:
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
                  "head_dim", "rope_theta", "rms_norm_eps", "attention_bias", "qk_norm", "tie_word_embeddings",
                  "hf_architecture"):
        assert getattr(jcfg, field) == getattr(tcfg, field), field


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def fixture_dir(request, tmp_path_factory):
    return request.param, build_hf_checkpoint(tmp_path_factory.mktemp(f"hf_{request.param}"), dtype=request.param)


def test_fixture_checkpoint_loads_equal(fixture_dir):
    name, path = fixture_dir
    jdtype, tdtype = DTYPES[name]
    jparams, jcfg = jl.load_hf_model(path, dtype=jdtype)
    tparams, tcfg = tl.load_hf_model(path, dtype=tdtype, device="cpu")
    assert_configs_agree(jcfg, tcfg)
    assert tcfg.dtype == tdtype and tcfg.vocab_size == 768
    assert_same_tensors(jparams, tparams)


def test_fixture_checkpoint_logits_agree_at_fp32(fixture_dir):
    """Each package's loader and forward, fp32 (the bf16 checkpoint upcast
    on load), on one packed row of three segments."""
    _, path = fixture_dir
    jparams, jcfg = jl.load_hf_model(path, dtype=jnp.float32)
    tparams, tcfg = tl.load_hf_model(path, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    L = 40
    ids = rng.integers(0, 540, (1, L))
    seg = np.repeat([0, 1, 2], [15, 15, 10])[None].astype(np.int32)
    pos = np.concatenate([np.arange(15), np.arange(15), np.arange(10)])[None].astype(np.int32)
    j_logits = jt.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg))
    t_logits = tt.forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), torch.from_numpy(seg))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=RTOL, atol=ATOL)


ARCHS = {
    "qwen3_qk_norm": dict(attention_bias=False, qk_norm=True, hf_architecture="Qwen3ForCausalLM"),
    "llama": dict(attention_bias=False, qk_norm=False, hf_architecture="LlamaForCausalLM"),
    "qwen2_tied": dict(attention_bias=True, qk_norm=False, tie_word_embeddings=True,
                       hf_architecture="Qwen2ForCausalLM"),
    "llama_no_arch_field": dict(attention_bias=False, qk_norm=False),
}


def jax_export(tmp_path, arch: str, seed: int = 0):
    """A directory written by JAX's ``export_hf`` from perturbed fp32
    weights (so norms and biases are not 0 and 1)."""
    cfg = jt.ModelConfig(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=3, num_heads=4,
                         num_kv_heads=2, head_dim=8, rope_theta=500_000.0, rms_norm_eps=1e-5,
                         dtype=jnp.float32, **ARCHS[arch])
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.normal(size=x.shape), jnp.float32),
                          jt.init_params(jax.random.key(seed), cfg))
    return j_export_hf(tmp_path, params, cfg), params, cfg


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_jax_exports_load_equal(tmp_path, arch):
    path, params, cfg = jax_export(tmp_path, arch)
    jparams, jcfg = jl.load_hf_model(path, dtype=jnp.float32)
    tparams, tcfg = tl.load_hf_model(path, dtype=torch.float32, device="cpu")
    assert_configs_agree(jcfg, tcfg)
    assert_same_tensors(params, tparams)
    assert_same_tensors(jparams, tparams)
    assert ("lm_head" in tparams) == (not cfg.tie_word_embeddings)
    assert ("q_norm" in tparams["layers"]) == cfg.qk_norm and ("bq" in tparams["layers"]) == cfg.attention_bias


def test_checkpoint_split_over_two_files(tmp_path):
    """Real checkpoints shard their tensors over several files: the index
    covers every ``*.safetensors`` of the directory."""
    path, params, _ = jax_export(tmp_path, "llama")
    tensors = load_file(str(path / "model.safetensors"))
    names = sorted(tensors)
    (path / "model.safetensors").unlink()
    save_file({n: tensors[n] for n in names[::2]}, str(path / "model-00001-of-00002.safetensors"))
    save_file({n: tensors[n] for n in names[1::2]}, str(path / "model-00002-of-00002.safetensors"))
    tparams, _ = tl.load_hf_model(path, dtype=torch.float32, device="cpu")
    assert_same_tensors(params, tparams)


def test_language_model_prefixed_names_load(tmp_path):
    """Names under ``model.language_model.`` (current transformers' VLM
    export layout) map onto ``model.``, as in the JAX loader."""
    path, params, _ = jax_export(tmp_path, "llama")
    tensors = load_file(str(path / "model.safetensors"))
    renamed = {n.replace("model.", "model.language_model.", 1) if n.startswith("model.") else n: t
               for n, t in tensors.items()}
    save_file(renamed, str(path / "model.safetensors"))
    tparams, _ = tl.load_hf_model(path, dtype=torch.float32, device="cpu")
    assert_same_tensors(params, tparams)


def test_vlm_and_unknown_architectures_raise(tmp_path):
    """A Qwen2.5-VL config, flat and with its language keys nested under
    ``text_config``, loads as the JAX loader loads it (mrope sections and
    vision token ids included), and its trunk's tensors equal JAX's; an
    unknown architecture still raises. (Until the VLM path was ported the
    VLM architecture raised too.)"""
    path, _, _ = jax_export(tmp_path, "llama")
    config = json.loads((path / "config.json").read_text())
    config.update(architectures=["Qwen2_5_VLForConditionalGeneration"], image_token_id=151655,
                  vision_start_token_id=151652, vision_end_token_id=151653,
                  rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]})
    nested = {k: v for k, v in config.items() if k in ("architectures", "image_token_id", "vision_start_token_id",
                                                      "vision_end_token_id", "torch_dtype")}
    nested["text_config"] = {k: v for k, v in config.items() if k not in nested}
    for layout in (config, nested):
        (path / "config.json").write_text(json.dumps(layout))
        jcfg = jl.load_model_config(path, dtype=jnp.float32)
        tcfg = tl.load_model_config(path, dtype=torch.float32)
        assert_configs_agree(jcfg, tcfg)
        assert tcfg.mrope_section == jcfg.mrope_section == (1, 1, 2)
        assert (tcfg.image_token_id, tcfg.vision_start_token_id, tcfg.vision_end_token_id) == (151655, 151652, 151653)
        assert_same_tensors(jl.load_hf_model(path, dtype=jnp.float32)[0],
                            tl.load_hf_model(path, dtype=torch.float32, device="cpu")[0])
    assert tl.load_hf_vision(path, device="cpu") == (None, None) == jl.load_hf_vision(path)
    config["architectures"] = ["GPT2LMHeadModel"]
    (path / "config.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="Unsupported architecture"):
        tl.load_model_config(path)

# Llama-3.2-1B's published config.json
# (https://huggingface.co/meta-llama/Llama-3.2-1B/blob/main/config.json)
LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "head_dim": 64, "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 131072, "mlp_bias": False, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 16, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05, "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                                            "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 128256,
}
# Mistral-7B-v0.1's published config.json, its sliding window of 4,096
MISTRAL_7B_V01 = {
    "architectures": ["MistralForCausalLM"], "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mistral", "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 4096, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000,
}


@pytest.mark.parametrize("config", [LLAMA32_1B, MISTRAL_7B_V01], ids=["llama32_rope_scaling", "mistral_sliding_window"])
def test_shared_loader_faults_are_pinned(tmp_path, config):
    """Both packages read these published configs to the same
    ``ModelConfig``, and both leave out what neither implements: Llama 3.2's
    ``rope_scaling`` (``rope_type`` llama3, factor 32: plain RoPE at
    ``rope_theta``) and Mistral v0.1's ``sliding_window`` (full causal
    attention). Faults of the reference, kept so that the port stays equal
    to it (ROADMAP Queue 3)."""
    (tmp_path / "config.json").write_text(json.dumps(config))
    jcfg, tcfg = jl.load_model_config(tmp_path), tl.load_model_config(tmp_path)
    assert_configs_agree(jcfg, tcfg)
    assert tcfg.mrope_section is None and jcfg.mrope_section is None
    assert tcfg.rope_theta == config["rope_theta"] and tcfg.hf_architecture == config["architectures"][0]
    assert not any("scaling" in f or "window" in f for f in tt.ModelConfig.__dataclass_fields__)
    assert not any("scaling" in f or "window" in f for f in jt.ModelConfig.__dataclass_fields__)
    assert (tcfg.head_dim_, tcfg.num_kv_heads) == ((64, 8) if "rope_scaling" in config else (128, 8))
