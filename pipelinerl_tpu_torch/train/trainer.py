"""The finetune loop: stream-fed micro-batches, gradient accumulation,
AdamW, Lion or Adafactor with optax's semantics, weight-version publishing
and in-flight weight pushes, on one device or as one rank of a trainer
world.

Port of the JAX package's ``train/trainer.py`` ``TrainerLoop``, with its
memory snapshots and step profile (``utils/memory_debug.py``, per rank).
``parallel.pp`` is not read, as the JAX trainer, which has no pp axis,
does not read it: a trainer at pp above 1 logs one line and trains as at
pp 1.

A trainer world (``torch.distributed`` joined, ``parallel/multihost.py``)
runs a ``(world / (cp * tp), cp, tp)`` mesh, one rank per device:

- the params (the frozen base under LoRA, whose adapters are replicated)
  are cut along their dp and tp dims (``parallel/sharding.py``); a pass
  gathers the top leaves over dp (the embedding table over tp as well) and
  the layers one at a time over dp inside the forward (again in the
  backward under remat), whose backward reduce-scatters the gradients;
  under tp each rank keeps its heads, FFN columns and vocabulary rows
  (Megatron's splits, ``models/transformer.py``; the query heads by whole
  heads, ``sharding.TPCut``, so H need not split over tp); under LoRA the frozen
  base is gathered over dp for a pass and the adapters' product cut to the
  rank's tp slice. AdamW and Lion update the rank's slices, Adafactor
  gathers a leaf to compute its factored moments over the whole of it;
- each rank reads the ``training_data`` partition of its dp rank (cp and
  tp peers read the same one), buffers ``parallel.dp / dp_ranks`` rows a
  pass (``dp_local``) and takes its cp slice of them; attention under a cp
  axis is ``parallel/cp_attention.py`` whatever ``attn_impl`` says (a
  slice needs the other slices' keys), on the rank's tp heads;
- the pass's metrics and its (samples, tokens) counts are summed over the
  world, so every rank steps, publishes the same version and saves at the
  same time; only rank 0 writes the control streams and the checkpoint,
  after every rank has joined the gathers;
- the gradient norm is the global one in fp32 (single device: optax's
  arithmetic, bit for bit); results match one device up to the order of
  the sums.

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
from typing import Any, Callable, ContextManager

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..models.transformer import ModelConfig
from ..models.vision import prepare_vision_inputs, vision_forward, vision_inputs_to
from ..inference.weight_transfer import gather_for_push
from ..parallel import collectives
from ..parallel.cp_attention import make_cp_attention
from ..parallel.mesh import axis_group, axis_rank, axis_size
from ..parallel.multihost import make_multihost_mesh
from ..parallel.sharding import (
    cp_slice,
    gather_params,
    layer_gather,
    leaf_specs,
    leaf_tp_sizes,
    shard_params,
    tp_cut,
    tp_dim,
    tp_partial_leaves,
    tp_piece,
    unshard_params,
    untp_local,
)
from ..parallel.train_step import batch_tensors, pass_backward, step_grads
from ..state import SamplesProcessed, TrainingDone, WeightUpdateSuccess
from ..streams import SingleStreamSpec, StreamReader, StreamWriter
from ..types import TrainerBatch
from ..utils.memory_debug import create_memory_debugger, create_step_profiler
from ..utils.metrics_logger import MetricsLogger
from .checkpoints import export_hf, load_training_state, save_training_state
from .lora import init_lora_params, lora_config_from, merge_lora
from .optimizers import Adafactor, Lion
from .rl_loss import RLLossConfig

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


def make_optimizer(cfg: Config, params: dict, views: list | None = None):
    """→ (optimizer, LambdaLR), each as the JAX package's ``make_optimizer``
    builds it with optax. AdamW and Lion take optax's decay mask: decay only
    tensors with ``ndim >= 2`` (on the stacked ``[L, ...]`` layout that
    includes the norms and biases, as in the JAX package); a dp shard keeps
    its leaf's ``ndim`` (the cut is along a dim), so the mask is the full
    leaf's. ``torch.optim.AdamW`` decays ``p`` by ``lr * wd`` before the
    Adam step, which is optax's ``-lr * (adam + wd * p)`` on the same
    pre-update ``p``. Adafactor takes no weight decay, as
    ``optax.adafactor(schedule)``; ``views`` (per leaf, ``(to_full,
    to_local)`` or None) let it see the whole of a sharded leaf."""
    name = cfg.finetune.get("optim", "adamw")
    if name not in ("adamw", "adamw_torch", "lion", "adafactor"):
        raise ValueError(f"Unknown optimizer {name!r}")
    lr = float(cfg.finetune.learning_rate)
    wd = float(cfg.finetune.get("weight_decay", 0.0))
    leaves = [p for _, p in param_leaves(params)]
    if name == "adafactor":
        optimizer = Adafactor(leaves, lr=lr, views=views)
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


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float | None,
                        norm: torch.Tensor | None = None) -> torch.Tensor:
    """The pre-clip global norm, and ``g / norm * max_norm`` in place when
    ``norm >= max_norm``, as optax's ``global_norm`` and
    ``clip_by_global_norm`` compute them: each tensor's sum of squares in
    its own dtype, summed and rooted in that dtype, and the threshold
    rounded to it (no eps, unlike ``clip_grad_norm_``). A sharded trainer
    passes the world's ``norm`` (``parallel.sharding.grad_norm``)."""
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if max_norm is not None and bool(norm >= torch.tensor(max_norm, dtype=norm.dtype, device=norm.device)):
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(torch.tensor(max_norm, dtype=g.dtype, device=g.device))
    return norm


def batch_to_tensors(batch: TrainerBatch, device) -> dict[str, torch.Tensor]:
    """The batch's arrays on ``device``: token ids int64 (gather indices),
    segment ids int32 (the kernels' type), the RL columns fp32."""
    return batch_tensors(batch.arrays(), device)


def resolve_attn_impl(name: str, seq_length: int, device: torch.device, mesh=None, num_kv_heads: int = 0,
                      cp_impl: str = "blockwise"):
    """Under a cp axis, context-parallel attention (``make_cp_attention``)
    whatever the name. Else ``"auto"``: the GQA kernels on CUDA at
    ``seq_length >= 2048``, the plain attention below that or on the CPU;
    ``"cp"`` without a cp axis runs ``"xla"``, as the JAX trainer does;
    ``"blockwise"`` goes to the GQA kernels, which compute its function."""
    if axis_size(mesh, "cp") > 1:
        return make_cp_attention(mesh, num_kv_heads=num_kv_heads, impl=cp_impl)
    if name == "auto":
        return "gqa" if device.type == "cuda" and seq_length >= 2048 else "xla"
    if name == "cp":
        return "xla"
    return name


def parallel_shape(cfg: Config, world: int) -> tuple[int, int, int]:
    """(dp, cp, tp) of the trainer from ``parallel`` and the world size,
    with the JAX trainer's checks: cp * tp needs as many ranks of the
    world, and dp must be a multiple of the world's dp ranks. A world with
    no ``parallel`` product is all dp. ``pp`` is not read (one line says
    so), as the JAX trainer's mesh has no pp axis."""
    par = cfg.get("parallel") or Config({})
    if int(par.get("pp", 1) or 1) > 1:
        logger.info("parallel.pp=%s is not read: the JAX trainer has no pp axis, so this trains as at pp 1",
                    par.get("pp"))
    dp, cp, tp = int(par.get("dp", 1)), int(par.get("cp", 1)), int(par.get("tp", 1))
    if dp * cp * tp == 1 and world > 1:
        dp = world
    if world % (cp * tp):
        raise ValueError(f"parallel cp*tp={cp * tp} needs a trainer world of a multiple of {cp * tp} ranks, it has "
                         f"{world} (launch starts dp*cp*tp ranks)")
    if dp % (world // (cp * tp)):
        raise ValueError(f"parallel.dp={dp} must be a multiple of the world's dp ranks {world // (cp * tp)} "
                         "(each dp rank contributes dp / dp_ranks rows a pass)")
    return dp, cp, tp


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
        device_quiesce: Callable[[], ContextManager] | None = None,
    ):
        ft = cfg.finetune
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.dp, self.cp, self.tp = parallel_shape(cfg, self.world)
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.exp_path = exp_path
        self.weight_update_cb = weight_update_cb
        # a context in which no other thread of this process launches on the
        # card (an inline run's engine: ``InferenceEngine.quiesced``); the
        # step profiler starts and stops its trace under it
        self.device_quiesce = device_quiesce
        self.metrics = TrainingMetrics()
        # the vision tower of VLM rows: frozen, or trained with the rest as
        # params["vision_tower"] under finetune.train_vision_tower
        self.vision_cfg = vision_cfg
        self.vision_params = vision_params
        self.train_vision = bool(ft.get("train_vision_tower", False)) and vision_params is not None
        if self.train_vision and self.dp * self.cp * self.tp > 1:
            raise ValueError("train_vision_tower requires an unsharded trainer "
                             "(VLM rows train at batch 1, one row a pass)")
        # the mesh: (dp ranks, cp, tp); each dp rank runs dp_local rows a pass
        n_dp = self.world // (self.cp * self.tp)
        self.dp_local = self.dp // n_dp
        self.mesh = make_multihost_mesh(n_dp, self.cp, self.tp) if self.world > 1 else None
        # the attention leaves' tp cut: whole heads, and wk/wv whole on every
        # tp rank where K does not split
        self.cut = tp_cut(model_cfg, self.tp)
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
            # the adapters are small: replicated; the frozen base is sharded
            self.frozen_params = (shard_params(self.frozen_params, self.mesh, self.cut) if self.mesh
                                  else self.frozen_params)
        elif self.mesh is not None:
            params = shard_params(params, self.mesh, self.cut)
        # the rule table's spec of each trainable leaf; replicated adapters,
        # whose gradients tp peers hold in part (each sees its slice)
        n_leaves = len(param_leaves(params))
        self._specs = leaf_specs(params, self.cut) if self._sharded_params() else [(None,)] * n_leaves
        self._tp_partial = (tp_partial_leaves(params, self.cut) if self._sharded_params()
                            else [self.tp > 1] * n_leaves)
        self.params = params
        self._leaves = [p for _, p in param_leaves(params)]
        for p in self._leaves:
            p.requires_grad_(True)
        self.device = self._leaves[0].device
        self._rows: list[TrainerBatch] = []

        self.samples_per_step = int(ft.samples_per_step)
        self.weight_update_interval = int(ft.get("weight_update_interval", 1))
        self.max_train_steps = int(ft.get("max_train_steps", 100_000))
        self.max_lag = ft.get("max_lag")
        rl = {k: v for k, v in ft.rl.items() if k in RLLossConfig.__dataclass_fields__}
        rl["batch_size"] = int(rl.get("batch_size", self.samples_per_step)) or self.samples_per_step
        self.loss_cfg = RLLossConfig(**rl)

        self.optimizer, self.scheduler = make_optimizer(cfg, params, self._shard_views())
        # AdamW's and Lion's state is per element: sliced as its leaf is
        self._sharded_state = self.mesh is not None and not isinstance(self.optimizer, Adafactor)
        self.clip = ft.get("gradient_clipping_threshold")
        self._has_grads = False
        self.last_pass_samples = 0
        # one partition per dp rank; cp and tp peers read the same one
        self.input_spec = SingleStreamSpec(exp_path=exp_path, topic="training_data",
                                           partition=axis_rank(self.mesh, "dp"))
        self.save_checkpoint_steps = int(ft.get("save_checkpoint_steps", 0) or 0)
        self.checkpoint_dir = Path(exp_path) / "finetune"

        seq_length = int(ft.get("seq_length", 1024))
        self.attn_impl = resolve_attn_impl(str(ft.get("attn_impl", "auto")), seq_length, self.device, self.mesh,
                                           model_cfg.num_kv_heads if self.mesh else 0,
                                           str(ft.get("cp_attn_impl", "blockwise")))
        # a world's layers are gathered one at a time in the forward
        self.gather_layer = layer_gather(self.mesh) if self._sharded_params() else None
        # never materialize the [L, V] fp32 logits of a long row whole: by
        # the local length (the JAX trainer drops chunking under cp, where
        # each chip holds L/cp logits; at L/cp 16,384 that is still 9.96 GB)
        self.logits_chunk = 2048 if seq_length // self.cp >= 8192 else None
        remat_cfg = ft.get("gradient_checkpointing", True)
        if remat_cfg in (True, "auto", "full", "true"):
            self.remat: bool | str = True
        elif remat_cfg == "mlp":
            self.remat = "mlp"
        else:
            self.remat = False

    # ------------------------------------------------------------------
    def _shard_views(self) -> list:
        """Per leaf, ``(to_full, to_local)`` of a leaf cut over dp or tp,
        else None."""
        if self.mesh is None:
            return [None] * len(self._leaves)
        axes = [(axis_group(self.mesh, a), axis_size(self.mesh, a), axis_rank(self.mesh, a), a) for a in ("dp", "tp")]
        tp_sizes = (leaf_tp_sizes(self.params, self.cut, self.tp) if self._sharded_params()
                    else [None] * len(self._specs))

        def view(spec, sizes):
            cuts = [(g, n, r, spec.index(a), sizes if a == "tp" else None)
                    for g, n, r, a in axes if a in spec and n > 1]
            if not cuts:
                return None

            def to_full(x):
                for g, _, _, d, s in cuts:
                    x = collectives.gather(x, d, g, s)
                return x

            def to_local(x):
                for _, n, r, d, s in cuts:
                    x = tp_piece(x, d, n, r, s)
                return x.contiguous()

            return to_full, to_local

        return [view(spec, sizes) for spec, sizes in zip(self._specs, tp_sizes)]

    def _tp_cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This tp rank's slice of a whole layer leaf ``name``."""
        d = tp_dim(leaf_specs({"layers": {name: full}}, self.cut)[0])
        return tp_piece(full, d, self.tp, axis_rank(self.mesh, "tp"), self.cut.sizes(name, self.tp))

    def model_params(self) -> dict:
        """The weights the model runs on: the trainable params, or under LoRA
        the frozen base merged with the adapters (differentiable in them). In
        a world the top leaves are gathered over dp (the embedding table over
        tp too, differentiably) and the layers stay sliced for ``forward``'s
        ``gather_layer`` (``self.gather_layer``); under LoRA the frozen base
        is gathered over dp (it takes no gradient), the embedding over tp,
        and the adapters' product is cut to the rank's tp slice."""
        if self.lora_cfg.enabled:
            if self.mesh is None:
                return merge_lora(self.frozen_params, self.params, self.lora_cfg)
            frozen = unshard_params(self.frozen_params, self.mesh, self.cut, axes=("dp",))
            if self.tp > 1:
                frozen["embed"] = collectives.gather(frozen["embed"], 1, axis_group(self.mesh, "tp"))
                return merge_lora(frozen, self.params, self.lora_cfg, local=self._tp_cut)
            return merge_lora(frozen, self.params, self.lora_cfg)
        return gather_params(self.params, self.mesh, self.cut) if self.mesh else self.params

    @torch.no_grad()
    def served_params(self) -> dict:
        """What pushes and exports carry: the full weights the model runs on
        (every rank of a world joins the gathers) without the value head,
        which is the trainer's alone."""
        if not self.lora_cfg.enabled:
            params = gather_for_push(self.params, self.mesh, self.cut)
        elif self.tp > 1:
            params = untp_local(self.model_params(), axis_group(self.mesh, "tp"), self.cut)
        else:
            params = self.model_params()
        return {k: v for k, v in params.items() if k != "value_head"}

    # -- checkpoint / resume ------------------------------------------------
    def _optimizer_leaf(self) -> list[int]:
        """The leaf index of each of the optimizer's state indices."""
        ids = {id(p): i for i, p in enumerate(self._leaves)}
        return [ids[id(p)] for g in self.optimizer.param_groups for p in g["params"]]

    def _optimizer_state(self, to: int) -> Callable[[dict], dict]:
        """A state-dict transform: ``to`` 0 gathers the sliced leaves'
        per-element state to the full leaves, 1 takes this rank's slice of
        full state. Identity without per-element sharded state."""
        views, order = self._shard_views(), self._optimizer_leaf()

        def transform(state: dict) -> dict:
            if not self._sharded_state:
                return state
            out = dict(state, state={})
            for idx, st in state["state"].items():
                view = views[order[int(idx)]]
                out["state"][idx] = {k: view[to](v) if view and isinstance(v, torch.Tensor) and v.ndim else v
                                     for k, v in st.items()}
            return out

        return transform

    def gathered_state(self) -> tuple[list[tuple[str, torch.Tensor]], dict]:
        """The full trainable leaves by name and the optimizer's state dict
        over them (a world's slices gathered; every rank joins)."""
        named = param_leaves(unshard_params(self.params, self.mesh, self.cut) if self._sharded_params()
                             else self.params)
        return named, self._optimizer_state(0)(self.optimizer.state_dict())

    def leaf_state(self, optimizer_state: dict) -> dict[str, dict]:
        """An optimizer state dict's per-parameter entries by leaf name."""
        names, order = [n for n, _ in param_leaves(self.params)], self._optimizer_leaf()
        return {names[order[int(i)]]: st for i, st in optimizer_state["state"].items()}

    def save_checkpoint(self, tokenizer=None) -> None:
        """The training state (the adapters under LoRA) and an HF export of
        the merged weights without the value head. In a world every rank
        joins the gathers of the full state and rank 0 writes it."""
        named, optimizer_state = self.gathered_state()
        served = self.served_params()
        if self.rank != 0:
            return
        save_training_state(self.checkpoint_dir, named, optimizer_state, self.scheduler,
                            dataclasses.asdict(self.metrics))
        export_hf(self.checkpoint_dir, served, self.model_cfg, tokenizer, self.vision_cfg)
        logger.info("Saved checkpoint at step %d (%d samples)", self.metrics.completed_steps, self.metrics.samples)

    def _sharded_params(self) -> bool:
        return self.mesh is not None and not self.lora_cfg.enabled

    def try_resume(self) -> bool:
        """Restore the saved training state, if any: the trainable tensors
        in place, the optimizer, the scheduler and the metrics. In a world
        each rank reads the full state and keeps its slices."""
        views = self._shard_views() if self._sharded_params() else [None] * len(self._leaves)
        metrics = load_training_state(self.checkpoint_dir, param_leaves(self.params), self.optimizer, self.scheduler,
                                      piece=lambda i, t: views[i][1](t) if views[i] else t,
                                      optimizer_state=self._optimizer_state(1))
        if metrics is None:
            return False
        for key, value in metrics.items():
            if hasattr(self.metrics, key):
                setattr(self.metrics, key, value)
        logger.info("Resumed from checkpoint: step %d, %d samples", self.metrics.completed_steps, self.metrics.samples)
        return True

    def train_pass(self, batch: TrainerBatch) -> dict:
        """One micro-batch: forward, loss, backward into ``.grad``. Returns
        the loss metrics as floats, the world's sums in a world. With
        ``dp_local`` > 1 rows buffer until the pass has them all (``{}``
        meanwhile); a sentinel row's labels are all masked, so it adds zero
        loss, and the pass is a sentinel only when all its rows are."""
        if batch.visual is not None:
            return self._vlm_pass(batch)
        self._rows.append(batch)
        if len(self._rows) < self.dp_local:
            self.last_pass_samples = 0
            return {}
        rows, self._rows = self._rows, []
        if len(rows) == 1:
            stacked = batch.arrays()
        else:
            stacked = {name: np.concatenate([r.arrays()[name] for r in rows]) for name in batch.arrays()}
        # (samples, tokens) of the rows, counted once per dp rank: cp peers
        # hold the same rows (the sums run over dp and cp, tp peers each
        # take their own)
        own = axis_rank(self.mesh, "cp") == 0
        counts = {"global_samples": torch.tensor(float(sum(r.num_sequences for r in rows if not r.sentinel) * own)),
                  "global_tokens": torch.tensor(float(sum(r.length - r.padding for r in rows if not r.sentinel) * own))}
        arrays = batch_tensors(cp_slice(stacked, self.mesh), self.device)
        return self._after_pass(pass_backward(
            self.model_params(), self.model_cfg, self.loss_cfg, arrays, float(self.metrics.completed_steps),
            self.max_train_steps, 1.0 if all(r.sentinel for r in rows) else 0.0, self.mesh, self.gather_layer, counts, remat=self.remat, attn_impl=self.attn_impl,
            logits_chunk=self.logits_chunk,
        ))

    def _vlm_pass(self, batch: TrainerBatch) -> dict:
        if self.mesh is not None or self.dp > 1:
            raise ValueError("VLM training requires dp=1 and a single rank (the reference trains chartqa at batch 1)")
        arrays = batch_to_tensors(batch, self.device)
        vlm = self._vlm_inputs(batch, arrays)  # sets the mrope rows in ``arrays``
        counts = {"global_samples": torch.tensor(0.0 if batch.sentinel else float(batch.num_sequences)),
                  "global_tokens": torch.tensor(0.0 if batch.sentinel else float(batch.length - batch.padding))}
        return self._after_pass(pass_backward(
            self.model_params(), self.model_cfg, self.loss_cfg, arrays,
            float(self.metrics.completed_steps), self.max_train_steps, 1.0 if batch.sentinel else 0.0,
            extra=counts, remat=self.remat, attn_impl=self.attn_impl, logits_chunk=self.logits_chunk, **vlm,
        ))

    def _after_pass(self, metrics: dict) -> dict:
        self._has_grads = True
        # one device-to-host read for all metrics
        values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).tolist()
        host = dict(zip(metrics, values))
        samples = int(round(host.pop("global_samples")))
        self.metrics.passes += 1
        self.metrics.samples += samples
        self.metrics.tokens += int(round(host.pop("global_tokens")))
        self.last_pass_samples = samples
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
        norm = step_grads(self._leaves, self._specs, self.mesh, self._tp_partial) if self.mesh is not None else None
        grads = [p.grad for p in self._leaves if p.grad is not None]
        norm = clip_by_global_norm(grads, None if self.clip is None else float(self.clip), norm)
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
                # a world's gather makes new tensors; one device's are live
                served = self.served_params()
                self.weight_update_cb(served if self.mesh is not None else detached_copy(served), version)
            self.publish(writer, WeightUpdateSuccess(version=version))
            self.metrics.last_broadcasted_version = version
            return True
        return False

    def publish(self, writer: StreamWriter, msg) -> None:
        """Rank 0 alone speaks on the control streams: versions are the same
        on every rank by construction."""
        if self.rank == 0:
            writer.write(msg.model_dump())

    def run(self, max_steps: int | None = None) -> TrainingMetrics:
        """Consume the training_data stream until ``max_steps`` optimizer
        steps (or ``finetune.max_train_steps``)."""
        target_steps = min(self.max_train_steps, max_steps if max_steps is not None else self.max_train_steps)
        mlog = MetricsLogger(self.exp_path, f"trainer_{self.rank}")
        memdbg = create_memory_debugger(self.cfg, self.exp_path, self.rank, self.device)
        self.profiler = create_step_profiler(self.cfg, self.exp_path, self.rank, self.device, self.device_quiesce)
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

        loader_thread = threading.Thread(target=loader, name=f"trainer-loader-{self.rank}", daemon=True)
        if not bool(self.cfg.get("force_restart", False)):
            self.try_resume()
        # initial broadcast so actors can start, and resync after a resume
        self.maybe_push_weights(writer, force=True)
        self.publish(writer, SamplesProcessed(samples=self.metrics.samples))
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
                memdbg.snapshot("before_train_pass", step=self.metrics.completed_steps)
                pass_metrics = self.train_pass(batch)
                memdbg.snapshot("after_train_pass", step=self.metrics.completed_steps)
                for key, value in pass_metrics.items():
                    sums[key] = sums.get(key, 0.0) + value
                samples_this_step += self.last_pass_samples
                self.publish(writer, SamplesProcessed(samples=self.metrics.samples))
                if samples_this_step < self.samples_per_step:
                    continue
                self.optimizer_step()
                memdbg.snapshot("after_optimizer_step", step=self.metrics.completed_steps)
                self.profiler.on_step(self.metrics.completed_steps)
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
                memdbg.snapshot("after_weight_push", step=self.metrics.completed_steps)
                if self.save_checkpoint_steps and self.metrics.completed_steps % self.save_checkpoint_steps == 0:
                    self.save_checkpoint()
                    memdbg.snapshot("after_save", step=self.metrics.completed_steps)
            elapsed = time.monotonic() - t_start
            logger.info(
                "Trainer done: %d steps, %d samples, %d tokens in %.1fs (%.0f tok/s)",
                self.metrics.completed_steps, self.metrics.samples, self.metrics.tokens,
                elapsed, self.metrics.tokens / max(elapsed, 1e-9),
            )
            self.maybe_push_weights(writer, force=True)
            if self.save_checkpoint_steps:
                self.save_checkpoint()
            self.publish(writer, TrainingDone())
            self.profiler.stop()
        finally:
            stop.set()
            loader_thread.join(timeout=5)
            memdbg.close()
            reader.stop()
            writer.close()
            mlog.close()
            # after an error: write what was traced without raising over it
            self.profiler.stop(check=False)
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
