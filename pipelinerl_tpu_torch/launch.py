"""Orchestrator: builds the model, engine and stages, and runs the RL loop.

Port of the JAX package's ``launch.py`` inline mode: one process owns the
card and runs the engine loop, the preprocessor and the trainer on threads
beside the actor's asyncio scheduler, all decoupled through file streams.
Weight updates are in-process swaps (``InferenceEngine.update_params``) of
copies the trainer hands over. The model is the toy model (``model_path``
``toy`` or null) or an HF checkpoint directory (``model_path=<dir>``: its
safetensors, ``config.json`` and byte-level BPE tokenizer). A VLM run
(``toy_vision``, or a checkpoint whose ``config.json`` has a
``vision_config``) also builds the vision tower (``build_vision``), which
the engine and the trainer share by copy, and the client's visual processor
(``build_processor``).

``launch_mode=processes`` (``run_processes``) runs the stages as separate
processes on one host, supervised fail-fast: a ``device`` job (engine,
HTTP server and trainer in one CUDA process) or, with
``world.trainer_procs=1``, an ``engine`` job and a ``trainer`` job that
pushes PWT3 bodies into it over HTTP; the host-only ``environment``
servers, the ``stream_hub`` through which every topic rides when the world
spans hosts, and the ``actor`` and ``preprocessor`` jobs
(``CUDA_VISIBLE_DEVICES=""``). A job on a host other than this one starts
as ``ssh <host> env <assignments> <command>`` (the experiment directory on
a shared filesystem). VLM runs are inline only.

A ``parallel`` product dp*cp*tp above 1 (the ``tir`` preset's ``cp: 8``)
trains as a world of dp*cp*tp trainer ranks, one per device
(``world.trainer_ranks``), and ``engine.tp * engine.pp`` above 1 serves
as that many engine rank processes (``inference/tp_ranks.py``; only rank 0
has an HTTP port): ``main`` runs such a config in processes mode in the split layout,
and logs that it switched. JAX drives a whole mesh from one process
inline; the port's one rank per device cannot share the inline process,
so the switch is deliberate.

Both modes interleave evals (``eval_every_n_versions``: the test problems
through an eval ``ActorLoop`` onto ``actor_test`` and ``stats_test``), and
inline mode runs a subset of the stages under ``debug.mode``, replaying the
missing upstream streams from ``debug.streams_from``.

    python3 -m pipelinerl_tpu_torch.launch --config-name=bandit_tpu output_dir=/tmp/run
    python3 -m pipelinerl_tpu_torch.launch --config-name=test model_path=<hf dir> output_dir=/tmp/run
    python3 -m pipelinerl_tpu_torch.launch --config-name=bandit_tpu output_dir=/tmp/run launch_mode=processes [world.trainer_procs=1]
    python3 -m pipelinerl_tpu_torch.launch --config-name=test model_path=<hf dir> output_dir=/tmp/run launch_mode=processes world.trainer_procs=2 parallel.dp=2
    python3 -m pipelinerl_tpu_torch.launch --config-name=test model_path=<hf dir> output_dir=/tmp/run engine.tp=2 parallel.tp=2
    python3 -m pipelinerl_tpu_torch.launch --config-name=test model_path=<hf dir> output_dir=/tmp/run +engine.pp=2

prints the run's summary as one JSON line, last.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any

import torch

from .actor import ActorLoop, ActorStats, load_test_problems, run_with_evals
from .config import Config, compose
from .domains.registry import resolve
from .entrypoints.common import wait_for_http
from .inference import EngineConfig, InferenceEngine
from .inference.client import InProcessLLM
from .inference.processor import HFVisualProcessor
from .models.hf_loader import load_hf_model, load_hf_vision
from .models.hf_tokenizer import HFTokenizer
from .models.toy_tokenizer import IMAGE, ToyTokenizer, ToyVisualProcessor
from .models.transformer import ModelConfig, init_params, init_value_head
from .models.vision import VisionConfig, init_vision_params
from .preprocess import Preprocessor
from .state import TrainerState
from .streams import set_streams_backend
from .streams_tcp import wait_for_hub
from .train.rl_loss import RLLossConfig
from .train.trainer import TrainerLoop, detached_copy, summary
from .utils import setup_logging
from .world import WorldMap, engine_pp, engine_ranks, engine_tp, parallel_product, trainer_ranks

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: Config, device="cuda"):
    """→ (params, model_cfg, tokenizer) in ``finetune.param_dtype``: the toy
    model from ``toy_model`` with random weights from ``seed`` (and a value
    head under ``finetune.value_head``), or the HF checkpoint at
    ``model_path`` with its tokenizer. A checkpoint whose vocabulary is
    padded past the tokenizer gets ``valid_vocab``, so the padding rows are
    never sampled. As in the JAX package, only the toy model gets a value
    head."""
    model_path = cfg.get("model_path")
    dtype = _DTYPES[cfg.finetune.get("param_dtype", "float32")]
    if model_path in (None, "toy"):
        tokenizer = ToyTokenizer()
        toy = cfg.get("toy_model", Config({}))
        mrope = toy.get("mrope_section")
        if mrope is None and cfg.get("toy_vision") is not None:
            # the toy VLM's (t, h, w) split of the head_dim / 2 rotary channels
            half = (int(toy.get("hidden_size", 128)) // int(toy.get("num_heads", 4))) // 2
            mrope = (half - 2 * (half // 4), half // 4, half // 4)
        model_cfg = ModelConfig(
            vocab_size=int(toy.get("vocab_size", tokenizer.vocab_size)),
            hidden_size=int(toy.get("hidden_size", 128)),
            intermediate_size=int(toy.get("intermediate_size", 256)),
            num_layers=int(toy.get("num_layers", 2)),
            num_heads=int(toy.get("num_heads", 4)),
            num_kv_heads=int(toy.get("num_kv_heads", 2)),
            dtype=dtype,
            mrope_section=tuple(int(x) for x in mrope) if mrope else None,
            image_token_id=int(toy.get("image_token_id", IMAGE)) if cfg.get("toy_vision") is not None else None,
        )
        seed = int(cfg.get("seed", 0))
        params = init_params(torch.Generator().manual_seed(seed), model_cfg, device)
        if cfg.finetune.get("value_head", False):
            params["value_head"] = init_value_head(torch.Generator().manual_seed(seed + 99), model_cfg, device)
        return params, model_cfg, tokenizer
    params, model_cfg = load_hf_model(model_path, dtype=dtype, device=device)
    tokenizer = HFTokenizer(model_path)
    n_tok = len(tokenizer)
    if n_tok < model_cfg.vocab_size:
        model_cfg = dataclasses.replace(model_cfg, valid_vocab=n_tok)
        logger.info("Masking %d padded logit rows (vocab %d, tokenizer %d)",
                    model_cfg.vocab_size - n_tok, model_cfg.vocab_size, n_tok)
    return params, model_cfg, tokenizer


def build_vision(cfg: Config, model_cfg: ModelConfig, device="cuda"):
    """→ (tower params, ``VisionConfig``), or (None, None) for a text run:
    the toy tower of ``toy_vision`` with random weights from ``seed`` + 3,
    or the tower of a VLM checkpoint at ``model_path``."""
    dtype = _DTYPES[cfg.finetune.get("param_dtype", "float32")]
    toy = cfg.get("toy_vision")
    if toy is not None:
        vcfg = VisionConfig(
            hidden_size=int(toy.get("hidden_size", 16)),
            intermediate_size=int(toy.get("intermediate_size", 32)),
            num_heads=int(toy.get("num_heads", 2)),
            depth=int(toy.get("depth", 2)),
            out_hidden_size=model_cfg.hidden_size,
            patch_size=int(toy.get("patch_size", 2)),
            temporal_patch_size=int(toy.get("temporal_patch_size", 1)),
            spatial_merge_size=int(toy.get("spatial_merge_size", 2)),
            window_size=int(toy.get("window_size", 8)),
            fullatt_block_indexes=tuple(toy.get("fullatt_block_indexes", (1,))),
            dtype=dtype,
        )
        return init_vision_params(torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 3), vcfg, device), vcfg
    if cfg.get("model_path") in (None, "toy"):
        return None, None
    return load_hf_vision(cfg.model_path, dtype=dtype, device=device)


def build_processor(cfg: Config, tokenizer, vision_cfg):
    """The client's visual processor, or None for a text run."""
    if vision_cfg is None:
        return None
    if cfg.get("model_path") in (None, "toy"):
        return ToyVisualProcessor(tokenizer, vision_cfg.spatial_merge_size)
    return HFVisualProcessor(cfg.model_path, tokenizer)


def _is_vlm_checkpoint(model_path) -> bool:
    """Whether ``model_path`` is a checkpoint directory whose
    ``config.json`` has a ``vision_config`` (the JAX ``_is_vlm_checkpoint``)."""
    if model_path in (None, "toy"):
        return False
    try:
        with open(Path(model_path) / "config.json") as f:
            return bool(json.load(f).get("vision_config"))
    except (OSError, ValueError):
        return False


def engine_params(params: dict) -> dict:
    """A copy of the weights the engine runs on: the value head is the
    trainer's alone."""
    return detached_copy({k: v for k, v in params.items() if k != "value_head"})


def build_engine(cfg: Config, params: dict, model_cfg: ModelConfig, tokenizer, device="cuda",
                 vision_params: dict | None = None, vision_cfg=None, tp_world=None) -> InferenceEngine:
    """The engine with the JAX package's defaults for keys the config leaves
    out (prefill attention "xla", decode attention "auto"), with the vision
    tower of a VLM run. At ``engine.tp * engine.pp`` above 1 this process
    is one rank of the engine (``tp_world``, ``tp_ranks.join_engine_world``),
    which keeps its stage's slice of ``params``."""
    ecfg = cfg.get("engine", Config({}))
    n = engine_ranks(cfg)
    if n > 1 and (tp_world is None or tp_world.size != n or tp_world.pp != engine_pp(cfg)):
        split = " ".join(f"engine.{k}={v}" for k, v in (("tp", engine_tp(cfg)), ("pp", engine_pp(cfg))) if v > 1)
        raise ValueError(f"{split} runs as {n} engine rank processes (launch_mode=processes; "
                         "entrypoints.run_engine joins them): pass their tp_world")
    return InferenceEngine(
        params,
        model_cfg,
        EngineConfig(
            max_slots=int(ecfg.get("max_slots", 32)),
            max_len=int(ecfg.get("max_len", 2048)),
            prefill_buckets=tuple(ecfg.get("prefill_buckets", (128, 256, 512, 1024))),
            seed=int(cfg.get("seed", 0)),
            cache_dtype=_DTYPES[ecfg.get("cache_dtype", "bfloat16")],
            decode_window=int(ecfg.get("decode_window", 8)),
            window_pipeline_depth=int(ecfg.get("window_pipeline_depth", 2)),
            adaptive_window=bool(ecfg.get("adaptive_window", True)),
            attn_impl=str(ecfg.get("attn_impl", "xla")),
            decode_attn_impl=str(ecfg.get("decode_attn_impl", "auto")),
            max_prefill_batch=int(ecfg.get("max_prefill_batch", 8)),
            kv_layout=str(ecfg.get("kv_layout", "auto")),
            kv_block_size=int(ecfg.get("kv_block_size", 128)),
            kv_pool_blocks=int(ecfg.kv_pool_blocks) if ecfg.get("kv_pool_blocks") else None,
            prefix_cache=bool(ecfg.get("prefix_cache", True)),
        ),
        eos_token_id=tokenizer.eos_token_id,
        device=device,
        vision_params=vision_params,
        vision_cfg=vision_cfg,
        tp_world=tp_world,
    )


def validate_config(cfg: Config) -> None:
    """Cross-cutting invariants, checked before anything starts."""
    problems: list[str] = []
    mode = str(cfg.get("launch_mode", "inline"))
    if mode not in ("inline", "processes"):
        problems.append(f"unknown launch_mode {mode!r}: the port runs inline and processes")
    seq_length = int(cfg.finetune.seq_length)
    engine_max = int(cfg.select("engine.max_len", 0) or 0)
    if engine_max > seq_length:
        problems.append(
            f"engine.max_len ({engine_max}) > finetune.seq_length ({seq_length}): "
            "generated samples would not fit a packed trainer batch"
        )
    buckets = list(cfg.select("engine.prefill_buckets", []) or [])
    if buckets and max(buckets) > engine_max:
        problems.append(f"largest prefill bucket ({max(buckets)}) exceeds engine.max_len ({engine_max})")
    attempts = int(cfg.get("attempts", 1))
    if attempts < 2 and not cfg.finetune.get("value_head", False):
        problems.append("attempts < 2 with no value head: leave-one-out advantages are always zero "
                        "(nothing to learn from)")
    samples_per_step = int(cfg.finetune.samples_per_step)
    if samples_per_step % attempts != 0:
        logger.warning(
            "finetune.samples_per_step (%d) is not a multiple of attempts (%d); "
            "group boundaries will straddle optimizer steps", samples_per_step, attempts,
        )
    max_tokens = int(cfg.select("llm.parameters.max_tokens", 0) or 0)
    if max_tokens >= engine_max:
        problems.append(
            f"llm.parameters.max_tokens ({max_tokens}) >= engine.max_len ({engine_max}): "
            "no room for any prompt in the KV cache"
        )
    if buckets and max_tokens and max_tokens + min(buckets) > engine_max:
        problems.append(
            f"llm.parameters.max_tokens ({max_tokens}) + smallest prefill bucket ({min(buckets)}) "
            f"exceeds engine.max_len ({engine_max}): no prompt can receive its full completion budget"
        )
    # the KL term needs a reference policy: without one the ref logprobs
    # would read 0.0 and the penalty would be garbage. The JAX package checks
    # this in processes mode, where the flag provisions the reference job;
    # the port refuses a disabled flag inline too rather than ignore it
    kl_coef = float(cfg.select("finetune.rl.kl_coef", 0.0) or 0.0)
    if kl_coef != 0.0 and str(cfg.select("world.ref_engine", "auto")) in ("false", "False", "0"):
        problems.append(
            "finetune.rl.kl_coef != 0 with world.ref_engine disabled: "
            "the preprocessor would score KL against a zero reference policy"
        )
    policy = cfg.select("finetune.rl.policy_loss", "reinforce")
    if policy not in ("reinforce", "ppo", "gspo"):
        problems.append(f"unknown finetune.rl.policy_loss {policy!r}")
    # VLM rows are unpacked [1, L] and cannot be cp-sliced
    if cfg.get("toy_vision") is not None or _is_vlm_checkpoint(cfg.get("model_path")):
        par = cfg.get("parallel") or {}
        if int(par.get("cp", 1)) > 1 or int(par.get("dp", 1)) > 1:
            problems.append("VLM training requires parallel.cp == 1 and dp == 1 "
                            "(multimodal rows are unpacked and cannot be cp-sliced)")
        if mode == "processes":
            problems.append("VLM runs are inline only: processes mode does not carry the vision tower")
    rl_node = cfg.select("finetune.rl")
    if rl_node:
        unknown = [k for k in rl_node.keys() if k not in RLLossConfig.__dataclass_fields__]
        if unknown:
            problems.append(f"unknown finetune.rl key(s): {unknown}")
    debug_mode = str(cfg.select("debug.mode", "") or "")
    if debug_mode and debug_mode != "open_loop" and "actor" not in debug_stages(cfg) \
            and not cfg.select("debug.streams_from"):
        problems.append(f"debug.mode={debug_mode!r} drops the actor but debug.streams_from is unset — "
                        "nothing would feed the pipeline")
    dp, cp, tp = parallel_product(cfg)
    if min(dp, cp, tp, engine_tp(cfg), engine_pp(cfg)) < 1:
        problems.append(f"parallel.dp ({dp}), parallel.cp ({cp}), parallel.tp ({tp}), engine.tp ({engine_tp(cfg)}) "
                        f"and engine.pp ({engine_pp(cfg)}) must be at least 1")
    elif seq_length % cp:
        problems.append(f"finetune.seq_length ({seq_length}) must split over parallel.cp ({cp})")
    try:
        trainer_ranks(cfg)
    except ValueError as e:
        problems.append(str(e))
    if problems:
        raise ValueError("Invalid config:\n- " + "\n- ".join(problems))


def _stage(target, failures: list, trainer_state: TrainerState, name: str):
    """A stage thread's body: a stage that raises records the error and ends
    the run (the actor stops on ``training_done``); ``run_inline`` re-raises
    it after the other stages stop."""

    def run(*args):
        try:
            target(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by run_inline
            logger.exception("stage %s failed", name)
            failures.append(e)
            trainer_state.training_done = True

    return run


def debug_stages(cfg: Config) -> set[str]:
    """The stages ``debug.mode`` runs: all three by default, the actor alone
    for ``open_loop``, else the ``+``-joined names (``finetune`` is the
    trainer)."""
    mode = str(cfg.select("debug.mode", "") or "")
    all_stages = {"actor", "preprocessor", "trainer"}
    if not mode:
        return all_stages
    if mode == "open_loop":
        return {"actor"}
    stages = set(mode.split("+")) & (all_stages | {"finetune"})
    if "finetune" in stages:
        stages.discard("finetune")
        stages.add("trainer")
    if not stages:
        raise ValueError(f"Unknown debug.mode {mode!r}")
    return stages


def debug_replay_topics(stages: set[str]) -> list[str]:
    """The recorded topics that stand in for the stages left out: the actor
    stream for a preprocessor without an actor, the training data for a
    trainer without a preprocessor."""
    replay = []
    if "preprocessor" in stages and "actor" not in stages:
        replay.append("actor")
    if "trainer" in stages and "preprocessor" not in stages:
        replay.append("training_data")
    return replay


def debug_link_streams(exp_path: str, streams_from: str, topics: list[str]) -> None:
    """Symlink ``topics`` from a previous run's streams, so that recorded
    streams stand in for the stages left out."""
    src_root = Path(streams_from) / "streams"
    dst_root = Path(exp_path) / "streams"
    dst_root.mkdir(parents=True, exist_ok=True)
    for topic in topics:
        src, dst = src_root / topic, dst_root / topic
        if not src.exists():
            raise FileNotFoundError(f"No recorded stream {src} to replay")
        if dst.is_symlink() or dst.exists():
            continue
        dst.symlink_to(src.resolve())
        logger.info("Replaying stream %s from %s", topic, src)


def run_inline(cfg: Config, device="cuda") -> dict[str, Any]:
    """Engine, actor, preprocessor and trainer in one process, decoupled
    through streams, or the subset of them ``debug.mode`` names. Returns the
    run's summary."""
    validate_config(cfg)
    exp_path = str(cfg.output_dir)
    Path(exp_path).mkdir(parents=True, exist_ok=True)
    setup_logging(Path(exp_path) / "logs")
    set_streams_backend(str(cfg.select("streams.backend", "files") or "files"), hub=cfg.select("streams.hub"))
    cfg.save(Path(exp_path) / "conf" / "exp_config.json")
    stages = debug_stages(cfg)
    streams_from = cfg.select("debug.streams_from")
    if streams_from:
        debug_link_streams(exp_path, str(streams_from), debug_replay_topics(stages))

    params, model_cfg, tokenizer = build_model(cfg, device)
    vision_params, vision_cfg = build_vision(cfg, model_cfg, device)
    engine = None
    if "actor" in stages:
        # the engine owns copies: AdamW updates the trainer's tensors in place
        engine = build_engine(cfg, engine_params(params), model_cfg, tokenizer, device,
                              detached_copy(vision_params) if vision_params is not None else None, vision_cfg)
        engine.start()
    trainer_state = TrainerState(exp_path)
    trainer_state.start_listening()
    if "trainer" not in stages:
        trainer_state.debug_mode_init()  # version 0 without a trainer
    failures: list[BaseException] = []
    threads, preprocessor, trainer = [], None, None
    if "preprocessor" in stages:
        ref_score_fn = None
        if float(cfg.finetune.rl.get("kl_coef", 0.0) or 0.0) != 0.0:
            # the reference policy: a second engine on the initial weights
            # that is never started and never updated. It owns a copy, as
            # the policy engine does: AdamW updates the trainer's tensors in
            # place.
            ref_engine = build_engine(cfg, engine_params(params), model_cfg, tokenizer, device)
            ref_score_fn = ref_engine.score_tokens
        preprocessor = Preprocessor(cfg, exp_path, trainer_state, eos_token_id=tokenizer.eos_token_id,
                                    ref_score_fn=ref_score_fn, image_token_id=model_cfg.image_token_id,
                                    spatial_merge_size=vision_cfg.spatial_merge_size if vision_cfg else 2)
        threads.append(threading.Thread(target=_stage(preprocessor.run, failures, trainer_state, "preprocessor"),
                                        name="preprocessor", daemon=True))
    if "trainer" in stages:
        trainer = TrainerLoop(cfg, params, model_cfg, exp_path,
                              weight_update_cb=engine.update_params if engine is not None else None,
                              vision_params=vision_params, vision_cfg=vision_cfg,
                              device_quiesce=engine.quiesced if engine is not None else None)
        threads.append(threading.Thread(target=_stage(trainer.run, failures, trainer_state, "trainer"),
                                        args=(int(cfg.finetune.get("max_train_steps", 100)),), name="trainer",
                                        daemon=True))
    actor = None
    if "actor" in stages:
        processor = build_processor(cfg, tokenizer, vision_cfg)
        llm = InProcessLLM(engine, tokenizer, dict(cfg.llm.parameters.items()), processor=processor)
        problems = resolve(cfg.dataset_loader)(list(cfg.get("train_dataset_names", ["train"])))
        if cfg.get("train_subset"):
            problems = problems[: int(cfg.train_subset)]
        actor = ActorLoop(cfg, [llm], problems, trainer_state, exp_path, resolve(cfg.rollout_policy))
    for t in threads:
        t.start()
    try:
        actor_stats = ActorStats()
        if actor is not None:
            test_problems = load_test_problems(cfg)
            test_llms = [InProcessLLM(engine, tokenizer, dict(cfg.test_llm.parameters.items()), processor=processor)
                         ] if test_problems else []
            actor_stats, _ = asyncio.run(run_with_evals(actor, test_llms, test_problems, cfg.get("total_groups")))
        if "trainer" in stages:  # let the trainer drain
            deadline = time.monotonic() + float(cfg.get("drain_timeout_s", 120))
            while not trainer_state.training_done and time.monotonic() < deadline:
                time.sleep(0.1)
    finally:
        if preprocessor is not None:
            preprocessor.stop()
        for t in threads:
            t.join(timeout=30)
        if engine is not None:
            engine.stop()
        trainer_state.stop()
    if failures:
        raise failures[0]
    return {
        "actor": actor_stats.snapshot(),
        "trainer": summary(trainer.metrics) if trainer is not None else {},
        "engine": engine.perf_counters() if engine is not None else {},
    }


ENTRYPOINTS = {
    "device": "pipelinerl_tpu_torch.entrypoints.run_device",
    "engine": "pipelinerl_tpu_torch.entrypoints.run_engine",
    "engine_rank": "pipelinerl_tpu_torch.entrypoints.run_engine",
    "ref_engine": "pipelinerl_tpu_torch.entrypoints.run_engine",
    "trainer": "pipelinerl_tpu_torch.entrypoints.run_trainer",
    "stream_hub": "pipelinerl_tpu_torch.entrypoints.run_stream_hub",
    "actor": "pipelinerl_tpu_torch.entrypoints.run_actor",
    "preprocessor": "pipelinerl_tpu_torch.entrypoints.run_preprocess",
    "environment": "pipelinerl_tpu_torch.entrypoints.run_environment",
}
CARD_JOBS = ("device", "engine", "engine_rank", "ref_engine", "trainer")
# jobs that end on their own once training is done; the servers are stopped
SELF_ENDING = ("trainer", "actor", "preprocessor")
# the environment a job on another host is started with over ssh
REMOTE_ENV = ("PYTHONPATH", "CUDA_VISIBLE_DEVICES", "CARD_SLOT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def card_slots(world_map: WorldMap) -> dict[str, int]:
    """Each card job's place among the card jobs of its host, the servers
    (device, engine, its tp ranks, ref_engine) first and the trainer ranks
    after them:
    the job takes card ``slot % cards`` (``entrypoints.common.stage_device``),
    so a host with as many cards as slots gives every job its own."""
    slots: dict[str, int] = {}
    taken: dict[str, int] = {}
    for kind in CARD_JOBS:
        for job in world_map.jobs_of(kind):
            slots[f"{job.kind}_{job.replica_idx}"] = taken.get(job.hostname, 0)
            taken[job.hostname] = taken.get(job.hostname, 0) + 1
    return slots


def _kill_groups(procs: list, sig: int) -> None:
    for _, proc in procs:
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


def run_processes(cfg: Config) -> int:
    """The stages as supervised processes (JAX ``launch.run_processes``):
    the stream hub first (when the world has one; every job's topics then
    ride ``tcp``), then the environment servers and the card jobs, then,
    once the hub answers a ping and every server ``/health``, the
    preprocessor and the actors. ``cfg.environment`` lists the environment
    servers for the rollouts. Each job has its own process group; when a
    job fails, or on SIGTERM, every group is killed. Once the trainer
    reports TrainingDone, the jobs that end on their own get 30 s to do so,
    then the servers are stopped. With ``DRY_RUN`` set it only writes each
    job's start script. Returns an exit code."""
    validate_config(cfg)
    exp_path = Path(str(cfg.output_dir))
    exp_path.mkdir(parents=True, exist_ok=True)
    setup_logging(exp_path / "logs" / "launcher")
    world_map = WorldMap(cfg)
    cfg = Config(cfg.to_dict())
    cfg["jobs"] = world_map.to_config()
    if world_map.environment_servers:
        cfg["environment"] = world_map.environment_servers
    if world_map.use_stream_hub:
        # the hub's own settings (persist, hub_maxlen) stay
        cfg["streams"] = {**cfg.get("streams", Config({})).to_dict(), "backend": "tcp",
                          "hub": world_map.stream_hub_addr}
    config_dir = exp_path / "conf"
    cfg.save(config_dir / "exp_config.json")
    dry_run = bool(os.environ.get("DRY_RUN"))
    log_dir = exp_path / "logs"
    procs: list[tuple[str, subprocess.Popen]] = []
    root = str(Path(__file__).resolve().parent.parent)
    slots = card_slots(world_map)
    local = [name for kind in CARD_JOBS for name in (f"{j.kind}_{j.replica_idx}" for j in world_map.jobs_of(kind)
                                                     if j.is_local)]
    cards = torch.cuda.device_count() if local and not dry_run else 0
    if cards and len(local) > cards:
        logger.warning("%d card jobs on this host's %d cards: slot s takes card s %% %d, so jobs share cards (%s)",
                       len(local), cards, cards, {n: slots[n] % cards for n in local})

    def spawn(job) -> None:
        name = f"{job.kind}_{job.replica_idx}"
        cmd = [sys.executable, "-m", ENTRYPOINTS[job.kind], f"--config-dir={config_dir}",
               "--config-name=exp_config", f"+me.kind={job.kind}", f"+me.replica_idx={job.replica_idx}"]
        if job.port is not None:
            cmd.append(f"+me.port={job.port}")
        if job.kind in ("actor", "trainer"):
            urls = ",".join(f'"{u}"' for u in world_map.llm_urls)
            cmd.append(f"+me.llm_urls=[{urls}]")
        if job.kind == "preprocessor" and world_map.ref_llm_urls:
            ref_urls = ",".join(f'"{u}"' for u in world_map.ref_llm_urls)
            cmd.append(f"+me.ref_llm_urls=[{ref_urls}]")
        for key, value in job.extra.items():
            cmd.append(f"+me.{key}={value}")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        if job.kind not in CARD_JOBS:
            env["CUDA_VISIBLE_DEVICES"] = ""  # host-only jobs never touch the card
        else:
            env["CARD_SLOT"] = str(slots[name])
        if job.kind == "trainer":  # its device among the trainer ranks of its host
            peers = [j for j in world_map.jobs_of("trainer") if j.hostname == job.hostname]
            env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"] = str(peers.index(job)), str(len(peers))
        elif "tp_rank" in job.extra:  # one rank of a tp/pp engine (NCCL when each has its card)
            ranks = job.extra["tp_size"] * job.extra.get("pp_size", 1)
            env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"] = str(job.extra["tp_rank"]), str(ranks)
        (exp_path / job.kind).mkdir(exist_ok=True)
        script = " \\\n  ".join(cmd)
        (exp_path / job.kind / f"start_{name}.sh").write_text(f"#!/bin/sh\n{script}\n")
        if not job.is_local:
            # another host: its environment inline over ssh (key-based auth;
            # the experiment directory on a shared filesystem)
            cmd = ["ssh", job.hostname, "env", *(f"{k}={env[k]}" for k in REMOTE_ENV if k in env), *cmd]
        if dry_run:
            logger.info("DRY_RUN: %s", " ".join(cmd))
            return
        log_dir.mkdir(parents=True, exist_ok=True)
        with open(log_dir / f"{name}.out", "w") as log_file:
            # its own process group: a stop kills the job's whole tree
            proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        procs.append((name, proc))

    def on_term(signum, frame):
        _kill_groups(procs, signal.SIGTERM)
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, on_term) if not dry_run else None
    trainer_state = TrainerState(str(exp_path))
    exit_code = 1
    try:
        for job in world_map.jobs_of("stream_hub"):
            spawn(job)
        if world_map.use_stream_hub and not dry_run:
            wait_for_hub(world_map.stream_hub_addr)
            set_streams_backend("tcp", hub=world_map.stream_hub_addr)  # the launcher follows the trainer too
        for kind in ("environment", "device", "engine", "engine_rank", "ref_engine", "trainer"):
            for job in world_map.jobs_of(kind):
                spawn(job)
        if not dry_run:
            env_urls = [f"http://{e['hostname']}:{e['port']}" for e in world_map.environment_servers]
            wait_for_http(world_map.llm_urls + world_map.ref_llm_urls + env_urls, procs=procs)
        for job in world_map.jobs_of("preprocessor") + world_map.jobs_of("actor"):
            spawn(job)
        if dry_run:
            return 0
        trainer_state.start_listening()
        exit_code = _supervise(procs, trainer_state)
    except (RuntimeError, TimeoutError, KeyboardInterrupt) as e:
        logger.error("Stopping every job: %s", e)
        exit_code = 1
    finally:
        if not dry_run:
            trainer_state.stop()  # before the hub it may be reading from goes
            _kill_groups(procs, signal.SIGTERM)
            for name, proc in procs:
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    logger.error("Job %s ignored SIGTERM; killing its group", name)
                    _kill_groups([(name, proc)], signal.SIGKILL)
                    proc.wait(timeout=15)
            if previous is not None:  # None: a handler installed outside Python
                signal.signal(signal.SIGTERM, previous)
    return exit_code


def _supervise(procs: list, trainer_state: TrainerState) -> int:
    """Poll the jobs until TrainingDone; a job that exits with an error
    before then fails the run."""
    while True:
        if trainer_state.training_done:
            logger.info("TrainingDone observed; waiting for the jobs that end on their own")
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                running = [n for n, p in procs if p.poll() is None and n.rsplit("_", 1)[0] in SELF_ENDING]
                if not running:
                    break
                time.sleep(0.2)
            failed = [(n, p.returncode) for n, p in procs if p.returncode not in (None, 0)]
            if failed:
                logger.error("Job(s) %s exited with errors", failed)
                return 1
            return 0
        for name, proc in procs:
            rc = proc.poll()
            if rc is not None and rc != 0:
                raise RuntimeError(f"job {name} exited with {rc}")
        time.sleep(0.5)


def processes_summary(exp_path: str) -> dict[str, Any]:
    """The stats files the jobs wrote (``<kind>/stats_<kind>_<i>.json``)."""
    return {p.stem.removeprefix("stats_"): json.loads(p.read_text())
            for p in sorted(Path(exp_path).glob("*/stats_*.json"))}


def main(argv: list[str] | None = None) -> dict[str, Any]:
    argv = list(sys.argv[1:] if argv is None else argv)
    config_name = "base"
    overrides = []
    for arg in argv:
        if arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
        elif arg.startswith("--"):
            raise ValueError(f"unknown option {arg!r}: the port's configs are the presets of presets.py")
        else:
            overrides.append(arg)
    cfg = compose(config_name, overrides)
    dp, cp, tp = parallel_product(cfg)
    if (dp * cp * tp > 1 or engine_ranks(cfg) > 1) and str(cfg.get("launch_mode", "inline")) == "inline":
        setup_logging()
        logger.info("parallel dp*cp*tp=%d, engine.tp*pp=%d: a trainer world of %d ranks and engines of %d ranks, "
                    "one per device; running in processes mode (split layout) instead of inline", dp * cp * tp,
                    engine_ranks(cfg), max(dp * cp * tp, 1), engine_ranks(cfg))
        cfg["launch_mode"] = "processes"
    if str(cfg.get("launch_mode", "inline")) == "processes":
        rc = run_processes(cfg)
        if not os.environ.get("DRY_RUN"):
            print(json.dumps({"exit_code": rc, "jobs": processes_summary(str(cfg.output_dir))}), flush=True)
        raise SystemExit(rc)
    # the card unless the caller asks otherwise with device=cpu
    stats = run_inline(cfg, device=str(cfg.get("device", "cuda")))
    logger.info("Run complete: %s", stats)
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
