"""The configs the port runs, as Python presets (the H100 host has no yaml).

Each preset mirrors the JAX package's composed YAML of the same name key for
key (``conf/base.yaml`` with its group defaults; ``conf/bandit_cpu.yaml``;
``conf/bandit_tpu.yaml``; ``conf/counting.yaml``; ``conf/guessing.yaml``;
``conf/test.yaml``;
``conf/{math,logic,ifeval,fn_calling,multi_domain,tir,coding,miniwob}.yaml``;
``conf/vlm_bandit_cpu.yaml``; ``conf/chartqa.yaml``),
with dotted paths renamed from the JAX package to this one. The hub dataset
names stay as they are; the port's loaders raise on them. The config groups
(``conf/finetune/{base,grpo,ppo,actor_critic}.yaml``,
``conf/rewards/{base,success,pure_success}.yaml``) are group presets: a root
preset takes the ``base`` of each, and a ``finetune=ppo`` override selects
another, as a ``finetune: ppo`` entry of ``base.yaml``'s defaults would.
``tests/test_torch_config.py`` holds every preset and group against the JAX
package's ``compose``, so the copies cannot drift.
"""

from __future__ import annotations

import copy

from .config import Config

_FINETUNE_BASE = {
    "seq_length": 1024,
    "samples_per_step": 64,
    "learning_rate": 1e-6,
    "optim": "adamw",
    "lr_scheduler_type": "constant_with_warmup",
    "num_warmup_steps": 50,
    "weight_decay": 0.01,
    "gradient_clipping_threshold": 0.3,
    "gradient_checkpointing": True,
    "train_vision_tower": False,
    "max_train_steps": 1000,
    "weight_update_interval": "${finetune.samples_per_step}",
    "max_lag": "${max_lag}",
    "param_dtype": "bfloat16",
    "save_checkpoint_steps": 100,
    "rl": {
        "policy_loss": "reinforce",
        "use_advantages": True,
        "divide_advantage_by_std": False,
        "kl_coef": 0.0,
        "final_kl_coef": 0.0,
        "entropy_bonus": 0.0,
        "final_entropy_bonus": 0.0,
        "epsilon_low": 0.02,
        "epsilon_high": 0.02,
        "relu_log_p_weights": False,
        "clamp_log_ratio_ref_new_value": 5,
        "group_normalization": False,
        "overlong_filtering": False,
        "filter_zero_advantage_groups": False,
        "temperature": "${llm.parameters.temperature}",
        "value_loss_coef": 0.0,
        "max_segments": 512,
    },
}

_FINETUNE_GRPO = {
    "rl": {
        "policy_loss": "ppo",
        "use_advantages": True,
        "divide_advantage_by_std": True,
        "kl_coef": 0.0,
        "epsilon_low": 0.2,
        "epsilon_high": 0.2,
    },
}

_FINETUNE_PPO = {
    "rl": {
        "policy_loss": "ppo",
        "use_advantages": True,
        "kl_coef": 0.1,
        "final_kl_coef": 0.1,
        "epsilon_low": 0.2,
        "epsilon_high": 0.2,
    },
}

_FINETUNE_ACTOR_CRITIC = {
    "value_head": True,
    "rl": {
        "policy_loss": "ppo",
        "use_advantages": True,
        "value_loss_coef": 0.5,
        "epsilon_low": 0.2,
        "epsilon_high": 0.2,
    },
}

_REWARDS_BASE = {
    "correct_answer_finished": 1.0,
    "wrong_answer_finished": -0.5,
    "no_answer_finished": -1.0,
    "correct_answer_not_finished": 0.5,
    "wrong_answer_not_finished": -1.0,
    "no_answer_not_finished": -1.0,
    "unparsable_not_finished": -1.0,
    "unparsable_finished": -1.0,
    "buffer_tokens": 0,
}

# correct answers alone score, finished or not
_REWARDS_SUCCESS = {
    "correct_answer_finished": 1.0,
    "correct_answer_not_finished": 0.5,
    "wrong_answer_finished": 0,
    "wrong_answer_not_finished": 0,
    "no_answer_finished": 0,
    "no_answer_not_finished": 0,
    "unparsable_finished": 0,
    "unparsable_not_finished": 0,
    "buffer_tokens": 0,
}

_REWARDS_PURE_SUCCESS = {**_REWARDS_SUCCESS, "correct_answer_not_finished": 0}

_BASE = {
    "seed": 42,
    "output_dir": "???",
    "launch_mode": "inline",
    "model_path": None,
    "toy_model": {
        "vocab_size": 260,
        "hidden_size": 128,
        "intermediate_size": 256,
        "num_layers": 2,
        "num_heads": 4,
        "num_kv_heads": 2,
    },
    "dataset_loader": "pipelinerl_tpu_torch.domains.guessing.load_problems",
    "rollout_policy": "pipelinerl_tpu_torch.domains.registry.generate_dispatched_rollout",
    "train_dataset_names": ["train"],
    "test_dataset_names": ["test"],
    "train_subset": None,
    "total_groups": None,
    "attempts": 8,
    "max_lag": None,
    "pop_old_data": True,
    "eval_every_n_versions": 0,
    "llm": {"parameters": {"max_tokens": 512, "temperature": 1.0}},
    "test_llm": {"parameters": {"max_tokens": 512, "temperature": 1.0, "top_p": 0.95, "top_k": 50}},
    "actor": {
        "system_prompt": None,
        "task_template": "{task}",
        "discount_factor": 1.0,
        "difficulty_aware_penalty": {"enabled": False, "gamma": 1.0, "failure_scale": 1.0},
        "llm_max_rollouts": 64,
        "max_parallel_groups": 16,
        "max_rollout_retries": 2,
        "throughput_window_size": 50,
        "publish_stats_every_n_groups": 8,
    },
    "engine": {
        "max_slots": 32,
        "max_len": 2048,
        "prefill_buckets": [128, 256, 512, 1024, 2048],
        "cache_dtype": "bfloat16",
        "replicas": 1,
    },
    "preprocess": {"ring_buffer_size": 128, "max_ready_samples_per_lead": 64},
    "streams": {"backend": "files"},
    "world": {
        "replicas": 1,
        "env_replicas": 1,
        "actor_fraction": 4,
        "finetune_fraction": 4,
        "engine_start_port": 8080,
        "environment_start_port": 7777,
    },
}

_BANDIT_CPU = {
    "model_path": None,
    "dataset_loader": "pipelinerl_tpu_torch.domains.bandit.load_problems",
    "attempts": 8,
    "total_groups": 160,
    "max_lag": 32,
    "toy_model": {
        "hidden_size": 64,
        "intermediate_size": 128,
        "num_layers": 2,
        "num_heads": 2,
        "num_kv_heads": 2,
    },
    "llm": {"parameters": {"max_tokens": 3, "temperature": 1.0}},
    "engine": {
        "max_slots": 8,
        "max_len": 64,
        "prefill_buckets": [32, 64],
        "cache_dtype": "float32",
        "decode_window": 4,
        "adaptive_window": False,
    },
    "finetune": {
        "seq_length": 256,
        "samples_per_step": 16,
        "learning_rate": 4e-3,
        "num_warmup_steps": 0,
        "max_train_steps": 40,
        "param_dtype": "float32",
        "gradient_checkpointing": False,
        "rl": {"entropy_bonus": 0.05, "final_entropy_bonus": 0.005},
    },
}

_BANDIT_TPU = {
    "toy_model": {
        "hidden_size": 256,
        "intermediate_size": 512,
        "num_layers": 4,
        "num_heads": 4,
        "num_kv_heads": 2,
    },
    "engine": {"cache_dtype": "bfloat16", "decode_window": 8, "max_slots": 16},
    "finetune": {"param_dtype": "bfloat16", "learning_rate": 1e-2, "max_train_steps": 60},
    "total_groups": 450,
}

_COUNTING = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.counting.load_problems",
    "model_path": "???",
    "attempts": 16,
    "max_lag": 512,
    "llm": {"parameters": {"max_tokens": 256}},
    "engine": {"max_slots": 64, "max_len": 1024, "prefill_buckets": [128, 256, 512]},
    "finetune": {"seq_length": 2048, "samples_per_step": 256, "learning_rate": 2e-6, "max_train_steps": 200},
}

_GUESSING = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.guessing.load_problems",
    "model_path": "???",
    "attempts": 64,
    "max_lag": 1024,
    "llm": {"parameters": {"max_tokens": 200, "temperature": 1.0}},
    "engine": {"max_slots": 64, "max_len": 2048, "prefill_buckets": [256, 512, 1024, 2048]},
    "finetune": {
        "seq_length": 4096,
        "samples_per_step": 512,
        "learning_rate": 2e-6,
        "max_train_steps": 100,
        "weight_update_interval": 512,
    },
}

# the reference's operational oracle: guessing on Qwen2.5-0.5B
_TEST = {
    "attempts": 4,
    "max_lag": 128,
    "llm": {"parameters": {"max_tokens": 500}},
    "finetune": {"samples_per_step": 32, "max_train_steps": 100, "seq_length": 4096},
}

# the reference's flagship run: math GRPO on a real checkpoint
_MATH = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.math.load_datasets",
    "train_dataset_names": ["open_reasoner_zero_57k", "open_reasoner_zero_extended_72k"],
    "test_dataset_names": ["aime_2024", "math_500"],
    "actor": {
        "system_prompt": "Please reason step by step, and put your final answer within \\boxed{}.",
        "task_template": "{task}",
        "difficulty_aware_penalty": {"enabled": False, "gamma": 1.0, "failure_scale": 1.0},
    },
    "llm": {"parameters": {"max_tokens": 8192}},
    "engine": {"max_len": 10240, "max_slots": 64, "prefill_buckets": [256, 512, 1024, 2048], "attn_impl": "flash"},
    "finetune": {"seq_length": 12288, "samples_per_step": 4096, "learning_rate": 1e-6, "attn_impl": "flash"},
}

_LOGIC = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.logic.dataset.load_problems",
    "train_dataset_names": ["train"],
    "test_dataset_names": ["test"],
    "environment_class": "pipelinerl_tpu_torch.domains.logic.verifier_api.LogicEnvironment",
    "actor": {
        "system_prompt": ("Solve the logic puzzle. Reason step by step, then give the final answer inside "
                          "<answer></answer> tags."),
        "task_template": "{task}",
    },
    "world": {"env_replicas": 1},
    "llm": {"parameters": {"max_tokens": 4096}},
    "engine": {"max_len": 6144, "max_slots": 64, "prefill_buckets": [256, 512, 1024], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 1024, "learning_rate": 1e-6, "attn_impl": "flash"},
}

_IFEVAL = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.ifeval.dataset.load_datasets",
    "rollout_policy": "pipelinerl_tpu_torch.domains.ifeval.rollouts.generate_ifeval_rollout",
    "train_dataset_names": ["synthetic_ifeval"],
    "test_dataset_names": ["synthetic_ifeval"],
    "model_path": "???",
    "actor": {
        "system_prompt": "",
        "task_template": "{task}\n\nBe concise and direct in your response. Do not add unnecessary elaboration.",
        "ifeval_partial_credit": True,
    },
    "llm": {"parameters": {"max_tokens": 2048}},
    "engine": {"max_len": 4096, "max_slots": 64, "prefill_buckets": [256, 512, 1024, 2048], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 512, "learning_rate": 1e-6, "attn_impl": "flash"},
}

_FN_CALLING = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.fn_calling.dataset.load_datasets",
    "rollout_policy": "pipelinerl_tpu_torch.domains.fn_calling.rollouts.generate_fn_calling_rollout",
    "train_dataset_names": ["synthetic_fn_calling"],
    "test_dataset_names": ["synthetic_fn_calling"],
    "model_path": "???",
    "actor": {"system_prompt": "", "task_template": "{task}"},
    "llm": {"parameters": {"max_tokens": 1024}},
    "engine": {"max_len": 4096, "max_slots": 64, "prefill_buckets": [256, 512, 1024, 2048], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 512, "learning_rate": 1e-6, "attn_impl": "flash"},
}

_MULTI_DOMAIN = {
    "dataset_loader": "pipelinerl_tpu_torch.domain_sampling.load_multidomain",
    "rollout_policy": "pipelinerl_tpu_torch.domains.registry.generate_dispatched_rollout",
    "train_dataset_names": ["math::open_reasoner_zero_57k", "guessing::train", "counting::train"],
    "test_dataset_names": ["math::math_500", "counting::test"],
    "model_path": "???",
    "domain_mix": {"math": 0.6, "guessing": 0.2, "counting": 0.2},
    "adaptive_domain_sampling": True,
    "actor": {"system_prompt": "", "task_template": "{task}"},
    "llm": {"parameters": {"max_tokens": 4096}},
    "engine": {"max_len": 6144, "max_slots": 64, "prefill_buckets": [256, 512, 1024, 2048], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 1024, "learning_rate": 1e-6, "attn_impl": "flash"},
}

_TIR = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.math.load_datasets",
    "rollout_policy": "pipelinerl_tpu_torch.domains.tir.rollouts.generate_tir_rollout",
    "train_dataset_names": ["open_reasoner_zero_57k"],
    "test_dataset_names": ["aime_2024"],
    "model_path": "???",
    "sandbox_url": None,
    "sandbox_timeout": 30.0,
    "actor": {
        "max_turns": 6,
        "system_prompt": ("Solve the problem step by step. Use the run_python_code tool to compute, and submit your "
                          "final answer with the MathAnswer tool."),
    },
    "python_tool_shaping": {"bonus_on_correct_with_python": 0.1, "penalty_on_incorrect_without_python": 0.1,
                            "max_abs": 0.2},
    "length_shaping": {"target_ratio": 0.5, "slope": 0.0, "max_penalty": 0.0, "bonus_on_short_correct": 0.0},
    "llm": {"parameters": {"max_tokens": 16000}},
    "engine": {"max_len": 32768, "max_slots": 32, "prefill_buckets": [512, 1024, 2048, 4096, 8192, 16384],
               "attn_impl": "flash"},
    # context-parallel over 8 devices: a trainer world of 8 ranks
    # (parallel/, launch runs it in processes mode)
    "parallel": {"dp": 1, "cp": 8, "tp": 1},
    "finetune": {"seq_length": 32768, "samples_per_step": 1024, "attn_impl": "auto", "cp_block_kv": 1024,
                 "rl": {"policy_loss": "gspo", "divide_advantage_by_std": True}},
}

_CODING = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.coding.dataset.load_datasets",
    "rollout_policy": "pipelinerl_tpu_torch.domains.coding.rollouts.generate_coding_rollout",
    "train_dataset_names": ["taco", "apps"],
    "test_dataset_names": ["livecodebench"],
    "model_path": "???",
    "sandbox_url": None,
    "sandbox_timeout": 10.0,
    "max_tests_per_problem": 5,
    "actor": {
        "system_prompt": "",
        "task_template": ("{task}\n\nWrite your solution in Python. Be concise. Output only the code in a single "
                          "```python``` block."),
    },
    "llm": {"parameters": {"max_tokens": 4096}},
    "engine": {"max_len": 6144, "max_slots": 64, "prefill_buckets": [256, 512, 1024, 2048], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 1024, "learning_rate": 1e-6, "attn_impl": "flash"},
}

_MINIWOB = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.miniwob.load_tasks.load_tasks",
    "train_dataset_names": ["simweb_train"],
    "test_dataset_names": ["simweb_test"],
    "environment_class": "pipelinerl_tpu_torch.domains.miniwob.environment_server.WebEnvironmentServer",
    "actor": {"agent_max_loops": 8, "reward_computation": "nico", "rollout_timeout": 600, "system_prompt": None},
    "world": {"env_replicas": 2},
    "llm": {"parameters": {"max_tokens": 512}},
    "engine": {"max_len": 4096, "max_slots": 32, "prefill_buckets": [512, 1024, 2048], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 256, "learning_rate": 1e-6, "attn_impl": "flash"},
}

# group -> name -> (parent in the group or None, own body)
_GROUPS = {
    "finetune": {
        "base": (None, _FINETUNE_BASE),
        "grpo": ("base", _FINETUNE_GRPO),
        "ppo": ("base", _FINETUNE_PPO),
        "actor_critic": ("base", _FINETUNE_ACTOR_CRITIC),
    },
    "rewards": {
        "base": (None, _REWARDS_BASE),
        "success": (None, _REWARDS_SUCCESS),
        "pure_success": (None, _REWARDS_PURE_SUCCESS),
    },
}

_VLM_BANDIT_CPU = {
    "model_path": None,
    "dataset_loader": "pipelinerl_tpu_torch.domains.vlm_bandit.load_problems",
    "rollout_policy": "pipelinerl_tpu_torch.domains.vlm_bandit.generate_vlm_bandit_rollout",
    "attempts": 8,
    "total_groups": 900,
    "max_lag": 32,
    "toy_model": {"hidden_size": 64, "intermediate_size": 128, "num_layers": 2, "num_heads": 2, "num_kv_heads": 2},
    "toy_vision": {
        "hidden_size": 16,
        "intermediate_size": 32,
        "num_heads": 2,
        "depth": 2,
        "patch_size": 2,  # patch_dim = 3 * 1 * 2 * 2 = 12 (vlm_bandit.make_image)
        "temporal_patch_size": 1,
        "spatial_merge_size": 2,
        "window_size": 8,
        "fullatt_block_indexes": [1],
    },
    "llm": {"parameters": {"max_tokens": 3, "temperature": 1.0}},
    "engine": {
        "max_slots": 8,
        "max_len": 64,
        "prefill_buckets": [32, 64],
        "cache_dtype": "float32",
        "decode_window": 4,
        "adaptive_window": False,
    },
    "finetune": {
        "seq_length": 64,  # VLM rows are unpacked [1, L]
        "samples_per_step": 16,
        "learning_rate": 4e-3,
        "num_warmup_steps": 0,
        "max_train_steps": 190,
        "param_dtype": "float32",
        "gradient_checkpointing": False,
        "rl": {"entropy_bonus": 0.05, "final_entropy_bonus": 0.02},
    },
}

_CHARTQA = {
    "dataset_loader": "pipelinerl_tpu_torch.domains.chartqa.load_datasets",
    "rollout_policy": "pipelinerl_tpu_torch.domains.chartqa.generate_chartqa_rollout",
    "train_dataset_names": ["chartqa_train"],
    "test_dataset_names": ["chartqa_test"],
    "model_path": "???",
    "actor": {
        "system_prompt": "You are an expert at analyzing charts and graphs. Please examine the chart carefully and "
                         "answer the question accurately. Remember to provide your final answer in a boxed format, "
                         "like \\boxed{your answer}.",
        "task_template": "Question: {question}\n\nPlease analyze the chart step by step and put your final answer "
                         "within \\boxed{}.",
        "llm_max_rollouts": 16,
    },
    "llm": {"parameters": {"max_tokens": 2048, "temperature": 0.7}},
    "test_llm": {"parameters": {"max_tokens": 2048, "temperature": 0.7}},
    "engine": {"max_len": 8192, "max_slots": 16, "prefill_buckets": [1024, 2048, 4096, 8192], "attn_impl": "flash"},
    "finetune": {"seq_length": 8192, "samples_per_step": 512, "learning_rate": 1e-6, "attn_impl": "flash"},
}

# name -> (parent preset or None, own body); a body merges over its parent,
# and a root preset over its groups
_PRESETS = {
    "base": (None, _BASE),
    "bandit_cpu": ("base", _BANDIT_CPU),
    "bandit_tpu": ("bandit_cpu", _BANDIT_TPU),
    "counting": ("base", _COUNTING),
    "guessing": ("base", _GUESSING),
    "test": ("guessing", _TEST),
    "math": ("base", _MATH),
    "logic": ("base", _LOGIC),
    "ifeval": ("base", _IFEVAL),
    "fn_calling": ("base", _FN_CALLING),
    "multi_domain": ("base", _MULTI_DOMAIN),
    "tir": ("base", _TIR),
    "coding": ("base", _CODING),
    "miniwob": ("base", _MINIWOB),
    "vlm_bandit_cpu": ("base", _VLM_BANDIT_CPU),
    "chartqa": ("base", _CHARTQA),
}


def group_preset(group: str, name: str) -> Config:
    """The unresolved config of group ``group``'s entry ``name``."""
    if name not in _GROUPS.get(group, {}):
        raise KeyError(f"no {group!r} group entry {name!r}; the port has {sorted(_GROUPS.get(group, {}))}")
    parent, body = _GROUPS[group][name]
    cfg = group_preset(group, parent) if parent else Config()
    cfg.merge(copy.deepcopy(body))
    return cfg


def preset(name: str, groups: dict[str, str] | None = None) -> Config:
    """The unresolved config of preset ``name``, with the ``base`` entry of
    each group unless ``groups`` selects another."""
    if name not in _PRESETS:
        raise KeyError(f"no preset {name!r}; the port has {sorted(_PRESETS)}")
    parent, body = _PRESETS[name]
    if parent:
        cfg = preset(parent, groups)
    else:
        cfg = Config()
        for group in _GROUPS:
            cfg.merge({group: group_preset(group, (groups or {}).get(group, "base"))})
    cfg.merge(copy.deepcopy(body))
    return cfg


def names() -> list[str]:
    return sorted(_PRESETS)


def group_names(group: str) -> list[str]:
    return sorted(_GROUPS[group])


def is_group(group: str) -> bool:
    return group in _GROUPS
