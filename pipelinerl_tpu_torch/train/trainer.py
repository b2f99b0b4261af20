"""The finetune loop on one device: stream-fed micro-batches, gradient
accumulation, AdamW, Lion or Adafactor with optax's semantics,
weight-version publishing and in-flight weight pushes.

Port of the JAX package's ``train/trainer.py`` ``TrainerLoop`` for one
device. Left out: the device mesh (dp/cp/tp), which raises, and the memory
debugger and step profiler, which ``launch.validate_config`` refuses
(``finetune.memory_debug.enabled``, ``finetune.profile.enabled``).

- ``train_pass`` runs forward and backward of one packed micro-batch and
  accumulates into ``.grad``; the loss is pre-normalized by the step's
  sample count, so the sum over passes is exact. ``optimizer_step`` applies
  when the accumulated sample count reaches ``finetune.samples_per_step``.
- The weight version is the cumulative trained sample count.
- A push hands ``weight_update_cb`` detached copies: AdamW updates the
  trainer's tensors in place, and the engine reads its weights between
  decode windows on another thread.
- LoRA (``finetune.lora.enabled``): the trainable tensors are the adapters
  (``train/lora.py``), the base weights freeze, and the forward, pushes and
  exports run on the merged weights.
- VLM rows (``TrainerBatch.visual``, one unpacked ``[1, L]`` sample) take
  the VLM pass (``_vlm_inputs``, the JAX ``_vlm_pass``): the vision tower
  encodes the pixels, its merged tokens are spliced at the image
  placeholders, and the row runs with mrope positions. The tower is
  frozen, or trained with the rest under
  ``finetune.train_vision_tower`` (``params["vision_tower"]``, pushed,
  saved and exported with the rest; each tower layer recomputed in the
  backward pass under remat).
- Checkpoints: every ``save_checkpoint_steps`` steps and at the end, the
  training state and an HF export under ``finetune/`` (``checkpoints.py``);
  ``run`` resumes from a saved state unless ``force_restart``, and its first
  push sends the resumed weights.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

from ..config import Config
from ..models.transformer import ModelConfig
from ..models.vision import prepare_vision_inputs, vision_forward, vision_inputs_to
from ..state import SamplesProcessed, TrainingDone, WeightUpdateSuccess
from ..streams import SingleStreamSpec, StreamReader, StreamWriter
from ..types import TrainerBatch
from ..utils.metrics_logger import MetricsLogger
from .checkpoints import export_hf, load_training_state, save_training_state
from .lora import init_lora_params, lora_config_from, merge_lora
from .optimizers import Adafactor, Lion
from .rl_loss import RLLossConfig, rl_loss

logger = logging.getLogger(__name__)


@dataclass
class TrainingMetrics:
    completed_steps: int = 0
    passes: int = 0
    samples: int = 0
    tokens: int = 0
    last_broadcasted_version: int = 0
    samples_too_old_to_train: int = 0
    train_loss: float = 0.0
    grad_norm: float = 0.0
    lr: float = 0.0
    time_waiting_for_data: float = 0.0


def param_leaves(params: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every tensor in a nested parameter dict, in
    insertion order."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += param_leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def detached_copy(params: dict) -> dict:
    """A copy of a nested parameter dict that shares no storage with it."""
    return {k: detached_copy(v) if isinstance(v, dict) else v.detach().clone() for k, v in params.items()}


def lr_lambda(cfg: Config) -> Callable[[int], float]:
    """The optax schedule of ``make_optimizer`` as a multiplier of the peak
    rate, evaluated at the update count before the update (optax's count):
    the first warmup update has rate 0."""
    warmup = int(cfg.finetune.get("num_warmup_steps", 0))
    max_steps = int(cfg.finetune.get("max_train_steps", 100_000))
    kind = cfg.finetune.get("lr_scheduler_type", "constant_with_warmup")
    if kind == "cosine":
        w = max(1, warmup)  # optax.warmup_cosine_decay_schedule
        decay = max_steps - w

        def f(c: int) -> float:
            if c < w:
                return c / w
            t = min(c - w, decay) / decay if decay > 0 else 1.0
            return 0.5 * (1.0 + math.cos(math.pi * t))

        return f
    if kind in ("constant", "constant_with_warmup"):
        return (lambda c: min(c, warmup) / warmup) if warmup > 0 else (lambda c: 1.0)
    raise ValueError(f"Unknown lr_scheduler_type {kind!r}")


def make_optimizer(cfg: Config, params: dict):
    """→ (optimizer, LambdaLR), each as the JAX package's ``make_optimizer``
    builds it with optax. AdamW and Lion take optax's decay mask: decay only
    tensors with ``ndim >= 2`` (on the stacked ``[L, ...]`` layout that
    includes the norms and biases, as in the JAX package).
    ``torch.optim.AdamW`` decays ``p`` by ``lr * wd`` before the Adam step,
    which is optax's ``-lr * (adam + wd * p)`` on the same pre-update ``p``.
    Adafactor takes no weight decay, as ``optax.adafactor(schedule)``."""
    name = cfg.finetune.get("optim", "adamw")
    if name not in ("adamw", "adamw_torch", "lion", "adafactor"):
        raise ValueError(f"Unknown optimizer {name!r}")
    lr = float(cfg.finetune.learning_rate)
    wd = float(cfg.finetune.get("weight_decay", 0.0))
    leaves = [p for _, p in param_leaves(params)]
    if name == "adafactor":
        optimizer = Adafactor(leaves, lr=lr)
    else:
        groups = [
            {"params": [p for p in leaves if p.ndim >= 2], "weight_decay": wd},
            {"params": [p for p in leaves if p.ndim < 2], "weight_decay": 0.0},
        ]
        groups = [g for g in groups if g["params"]]
        if name == "lion":
            optimizer = Lion(groups, lr=lr)
        else:
            optimizer = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lr_lambda(cfg))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float | None) -> torch.Tensor:
    """The pre-clip global norm, and ``g / norm * max_norm`` in place when
    ``norm >= max_norm``, as optax's ``global_norm`` and
    ``clip_by_global_norm`` compute them: each tensor's sum of squares in
    its own dtype, summed and rooted in that dtype, and the threshold
    rounded to it (no eps, unlike ``clip_grad_norm_``)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if max_norm is not None and bool(norm >= torch.tensor(max_norm, dtype=norm.dtype, device=norm.device)):
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(torch.tensor(max_norm, dtype=g.dtype, device=g.device))
    return norm


def batch_to_tensors(batch: TrainerBatch, device) -> dict[str, torch.Tensor]:
    """The batch's arrays on ``device``: token ids int64 (gather indices),
    segment ids int32 (the kernels' type), the RL columns fp32."""
    out = {}
    for name, arr in batch.arrays().items():
        t = torch.from_numpy(arr)
        if name in ("input_ids", "labels"):
            t = t.long()
        out[name] = t.to(device, non_blocking=True)
    return out


def resolve_attn_impl(name: str, seq_length: int, device: torch.device) -> str:
    """``"auto"``: the GQA kernels on CUDA at ``seq_length >= 2048``, the
    plain attention below that or on the CPU. ``"cp"`` without a cp axis
    (the trainer mesh refuses one) runs ``"xla"``, as the JAX trainer does;
    ``"blockwise"`` goes to the GQA kernels, which compute its function."""
    if name == "auto":
        return "gqa" if device.type == "cuda" and seq_length >= 2048 else "xla"
    if name == "cp":
        return "xla"
    return name


class TrainerLoop:
    def __init__(
        self,
        cfg: Config,
        params: dict,
        model_cfg: ModelConfig,
        exp_path: str,
        weight_update_cb: Callable[[dict, int], None] | None = None,
        vision_params: dict | None = None,
        vision_cfg=None,  # models.vision.VisionConfig
    ):
        ft = cfg.finetune
        if cfg.get("parallel") and math.prod(int(v) for v in dict(cfg.parallel.items()).values()) > 1:
            raise NotImplementedError("the trainer mesh is not ported yet (ROADMAP Queue 1, item 8)")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.exp_path = exp_path
        self.weight_update_cb = weight_update_cb
        self.metrics = TrainingMetrics()
        # the vision tower of VLM rows: frozen, or trained with the rest as
        # params["vision_tower"] under finetune.train_vision_tower
        self.vision_cfg = vision_cfg
        self.vision_params = vision_params
        self.train_vision = bool(ft.get("train_vision_tower", False)) and vision_params is not None
        if vision_params is not None:
            for _, p in param_leaves(vision_params):
                p.requires_grad_(False)
        # LoRA: the trainable tensors become the adapters; the base freezes
        self.lora_cfg = lora_config_from(ft)
        if self.lora_cfg.enabled and self.train_vision:
            raise ValueError("train_vision_tower is incompatible with LoRA (the tower is not a "
                             "low-rank-adaptable matmul set in this design)")
        if self.train_vision:
            params = {**params, "vision_tower": vision_params}
            self.vision_params = None  # it lives in the trainable tree now
        self.frozen_params: dict = {}
        if self.lora_cfg.enabled:
            self.frozen_params = params
            for _, p in param_leaves(params):
                p.requires_grad_(False)
            device = param_leaves(params)[0][1].device
            generator = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)) + 7)
            params = init_lora_params(generator, params, self.lora_cfg)
        self.params = params
        self._leaves = [p for _, p in param_leaves(params)]
        for p in self._leaves:
            p.requires_grad_(True)
        self.device = self._leaves[0].device

        self.samples_per_step = int(ft.samples_per_step)
        self.weight_update_interval = int(ft.get("weight_update_interval", 1))
        self.max_train_steps = int(ft.get("max_train_steps", 100_000))
        self.max_lag = ft.get("max_lag")
        rl = {k: v for k, v in ft.rl.items() if k in RLLossConfig.__dataclass_fields__}
        rl["batch_size"] = int(rl.get("batch_size", self.samples_per_step)) or self.samples_per_step
        self.loss_cfg = RLLossConfig(**rl)

        self.optimizer, self.scheduler = make_optimizer(cfg, params)
        self.clip = ft.get("gradient_clipping_threshold")
        self._has_grads = False
        self.last_pass_samples = 0
        self.input_spec = SingleStreamSpec(exp_path=exp_path, topic="training_data")
        self.save_checkpoint_steps = int(ft.get("save_checkpoint_steps", 0) or 0)
        self.checkpoint_dir = Path(exp_path) / "finetune"

        seq_length = int(ft.get("seq_length", 1024))
        self.attn_impl = resolve_attn_impl(str(ft.get("attn_impl", "auto")), seq_length, self.device)
        # never materialize the [L, V] fp32 logits of a long row whole
        self.logits_chunk = 2048 if seq_length >= 8192 else None
        remat_cfg = ft.get("gradient_checkpointing", True)
        if remat_cfg in (True, "auto", "full", "true"):
            self.remat: bool | str = True
        elif remat_cfg == "mlp":
            self.remat = "mlp"
        else:
            self.remat = False

    # ------------------------------------------------------------------
    def model_params(self) -> dict:
        """The weights the model runs on: the trainable params, or under LoRA
        the frozen base merged with the adapters (differentiable in them)."""
        if self.lora_cfg.enabled:
            return merge_lora(self.frozen_params, self.params, self.lora_cfg)
        return self.params

    def served_params(self) -> dict:
        """What pushes and exports carry: ``model_params`` without the value
        head, which is the trainer's alone."""
        return {k: v for k, v in self.model_params().items() if k != "value_head"}

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, tokenizer=None) -> None:
        """The training state (the adapters under LoRA) and an HF export of
        the merged weights without the value head."""
        save_training_state(self.checkpoint_dir, param_leaves(self.params), self.optimizer, self.scheduler,
                            dataclasses.asdict(self.metrics))
        with torch.no_grad():
            export_hf(self.checkpoint_dir, self.served_params(), self.model_cfg, tokenizer, self.vision_cfg)
        logger.info("Saved checkpoint at step %d (%d samples)", self.metrics.completed_steps, self.metrics.samples)

    def try_resume(self) -> bool:
        """Restore the saved training state, if any: the trainable tensors
        in place, the optimizer, the scheduler and the metrics."""
        metrics = load_training_state(self.checkpoint_dir, param_leaves(self.params), self.optimizer, self.scheduler)
        if metrics is None:
            return False
        for key, value in metrics.items():
            if hasattr(self.metrics, key):
                setattr(self.metrics, key, value)
        logger.info("Resumed from checkpoint: step %d, %d samples", self.metrics.completed_steps, self.metrics.samples)
        return True

    def train_pass(self, batch: TrainerBatch) -> dict:
        """One micro-batch: forward, loss, backward into ``.grad``. Returns
        the loss metrics as floats."""
        arrays = batch_to_tensors(batch, self.device)
        vlm = self._vlm_inputs(batch, arrays) if batch.visual is not None else {}
        loss, metrics = rl_loss(
            self.model_params(), self.model_cfg, self.loss_cfg, arrays,
            float(self.metrics.completed_steps), self.max_train_steps, 1.0 if batch.sentinel else 0.0,
            remat=self.remat, attn_impl=self.attn_impl, logits_chunk=self.logits_chunk, **vlm,
        )
        loss.backward()
        self._has_grads = True
        samples = 0 if batch.sentinel else batch.num_sequences
        self.metrics.passes += 1
        self.metrics.samples += samples
        self.metrics.tokens += 0 if batch.sentinel else batch.length - batch.padding
        self.last_pass_samples = samples
        # one device-to-host read for all metrics
        values = torch.stack([v.detach().float().reshape(()).to(self.device) for v in metrics.values()]).tolist()
        host = dict(zip(metrics, values))
        self.metrics.train_loss = host["loss"]
        return host

    def _vlm_inputs(self, batch: TrainerBatch, arrays: dict) -> dict:
        """The VLM pass's inputs (the JAX ``_vlm_pass``): mrope rows in
        ``arrays["position_ids"]`` ([3, 1, L]), and the tower's merged tokens
        with the placeholder mask. A trained tower runs inside the graph, so
        its weights get gradients; a frozen one runs without it."""
        if self.vision_cfg is None or (self.vision_params is None and not self.train_vision):
            raise ValueError("multimodal batch but the trainer has no vision tower")
        vin = vision_inputs_to(prepare_vision_inputs(batch.visual["pixel_values"], batch.visual["image_grid_thw"],
                                                     self.vision_cfg), self.device)
        arrays["position_ids"] = torch.from_numpy(batch.visual["mrope_position_ids"]).long()[:, None, :].to(self.device)
        if self.train_vision:
            embeds = vision_forward(self.params["vision_tower"], self.vision_cfg, **vin, remat=self.remat is True)
        else:
            with torch.no_grad():
                embeds = vision_forward(self.vision_params, self.vision_cfg, **vin)
        return {"image_embeds": embeds[None], "image_mask": arrays["input_ids"] == int(self.model_cfg.image_token_id)}

    def zero_grad(self) -> None:
        """Drop the accumulated gradients without a step."""
        self.optimizer.zero_grad(set_to_none=True)
        self._has_grads = False

    def optimizer_step(self) -> None:
        assert self._has_grads, "optimizer_step before any train_pass"
        grads = [p.grad for p in self._leaves if p.grad is not None]
        norm = clip_by_global_norm(grads, None if self.clip is None else float(self.clip))
        self.optimizer.step()
        self.zero_grad()
        self.metrics.grad_norm = float(norm)
        self.metrics.lr = self.optimizer.param_groups[0]["lr"]
        self.scheduler.step()
        self.metrics.completed_steps += 1

    def maybe_push_weights(self, writer: StreamWriter, force: bool = False) -> bool:
        version = self.metrics.samples
        if force or version - self.metrics.last_broadcasted_version >= self.weight_update_interval:
            if self.weight_update_cb is not None:
                with torch.no_grad():
                    self.weight_update_cb(detached_copy(self.served_params()), version)
            writer.write(WeightUpdateSuccess(version=version).model_dump())
            self.metrics.last_broadcasted_version = version
            return True
        return False

    def run(self, max_steps: int | None = None) -> TrainingMetrics:
        """Consume the training_data stream until ``max_steps`` optimizer
        steps (or ``finetune.max_train_steps``)."""
        target_steps = min(self.max_train_steps, max_steps if max_steps is not None else self.max_train_steps)
        mlog = MetricsLogger(self.exp_path, "trainer_0")
        reader = StreamReader(self.input_spec, poll_interval=0.01)
        writer = StreamWriter(SingleStreamSpec(exp_path=self.exp_path, topic="weight_update_request"))
        # a loader thread tails the stream and decodes messages off the step
        # loop; the bounded queue keeps backpressure
        prefetch: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def loader() -> None:
            while not stop.is_set():
                got = False
                for msg in reader.read_available(max_messages=8):
                    got = True
                    b = TrainerBatch.from_msg(msg)
                    while not stop.is_set():
                        try:
                            prefetch.put(b, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                if not got:
                    time.sleep(0.005)

        loader_thread = threading.Thread(target=loader, name="trainer-loader", daemon=True)
        if not bool(self.cfg.get("force_restart", False)):
            self.try_resume()
        # initial broadcast so actors can start, and resync after a resume
        self.maybe_push_weights(writer, force=True)
        writer.write(SamplesProcessed(samples=self.metrics.samples).model_dump())
        samples_this_step = 0
        sums: dict[str, float] = {}
        lag_min, lag_max = float("inf"), -1
        t_start = t_step = time.monotonic()
        loader_thread.start()
        try:
            while self.metrics.completed_steps < target_steps:
                t_wait = time.monotonic()
                try:
                    batch = prefetch.get(timeout=0.25)
                except queue.Empty:
                    self.metrics.time_waiting_for_data += time.monotonic() - t_wait
                    continue
                self.metrics.time_waiting_for_data += time.monotonic() - t_wait
                if not batch.sentinel:
                    # staleness: trained samples against the version the
                    # batch's samples were generated under
                    lag = self.metrics.samples - batch.model_version
                    lag_min, lag_max = min(lag_min, lag), max(lag_max, lag)
                    if self.max_lag is not None and lag > int(self.max_lag):
                        self.metrics.samples_too_old_to_train += batch.num_sequences
                for key, value in self.train_pass(batch).items():
                    sums[key] = sums.get(key, 0.0) + value
                samples_this_step += self.last_pass_samples
                writer.write(SamplesProcessed(samples=self.metrics.samples).model_dump())
                if samples_this_step < self.samples_per_step:
                    continue
                self.optimizer_step()
                ratio_sum = sums.get("ratio_new_old_sum", 0.0)
                ratio_sq = sums.get("ratio_new_old_squared_sum", 0.0)
                n_tok = sums.get("num_output_tokens_sum", 0.0)
                elapsed = time.monotonic() - t_step
                t_step = time.monotonic()
                mlog.log(
                    {
                        **{f"rl/{k}": v for k, v in sums.items()},
                        "stats/ess": ratio_sum**2 / ratio_sq if ratio_sq else 0.0,
                        "stats/ess_fraction": ratio_sum**2 / (ratio_sq * n_tok) if ratio_sq and n_tok else 0.0,
                        "throughput/tokens_per_step": samples_this_step,
                        "throughput/sec_per_step": elapsed,
                        "throughput/tokens_per_sec": sums.get("input_size", n_tok) / elapsed if elapsed > 0 else 0.0,
                        "completed_steps": self.metrics.completed_steps,
                        "samples": self.metrics.samples,
                        "lr": self.metrics.lr,
                        "grad_norm": self.metrics.grad_norm,
                        "loss": sums.get("loss", 0.0),
                        "samples_too_old_to_train": self.metrics.samples_too_old_to_train,
                        "time_waiting_for_data": self.metrics.time_waiting_for_data,
                        **({"lag/min": lag_min, "lag/max": lag_max} if lag_max >= 0 else {}),
                    },
                    step=self.metrics.completed_steps,
                )
                sums = {}
                lag_min, lag_max = float("inf"), -1
                samples_this_step = 0
                self.maybe_push_weights(writer)
                if self.save_checkpoint_steps and self.metrics.completed_steps % self.save_checkpoint_steps == 0:
                    self.save_checkpoint()
            elapsed = time.monotonic() - t_start
            logger.info(
                "Trainer done: %d steps, %d samples, %d tokens in %.1fs (%.0f tok/s)",
                self.metrics.completed_steps, self.metrics.samples, self.metrics.tokens,
                elapsed, self.metrics.tokens / max(elapsed, 1e-9),
            )
            self.maybe_push_weights(writer, force=True)
            if self.save_checkpoint_steps:
                self.save_checkpoint()
            writer.write(TrainingDone().model_dump())
        finally:
            stop.set()
            loader_thread.join(timeout=5)
            reader.stop()
            writer.close()
            mlog.close()
        return self.metrics


def summary(metrics: TrainingMetrics) -> dict[str, Any]:
    """The trainer part of ``run_inline``'s result."""
    return {
        "completed_steps": metrics.completed_steps,
        "samples": metrics.samples,
        "tokens": metrics.tokens,
        "train_loss": metrics.train_loss,
        "last_broadcasted_version": metrics.last_broadcasted_version,
    }
