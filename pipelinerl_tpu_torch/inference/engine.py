"""Continuous-batching inference engine, slab and paged KV layouts, in PyTorch.

Port of the JAX package's ``inference/engine.py``. A fixed number of decode
slots S decode together; prompts prefill in padded buckets; decoding runs in
windows of W steps that stage new K/V in a small band and merge it into the
cache once per window, with one device-to-host read per window. Two KV
layouts:

- slab (the default): each slot owns a contiguous cache of capacity
  ``max_len``. A finished slot is parked in place with its transcript; a
  later prompt that extends the transcript resumes the slot and prefills
  only its tail (``forward_extend``), and admission evicts parked slots,
  least recently parked first, when it needs their room;
- paged (``kv_layout="paged"``): fixed-size pages from one shared pool
  (``block_pool.BlockPool``). Admission reserves prompt + budget + one
  window of pages, so a request never runs out mid-flight; a GRPO group's
  forks share the prompt's full pages; finished transcripts' full pages stay
  in an LRU prefix cache, and a later prompt that extends one prefills only
  its tail (``forward_extend``).

- In-flight weight updates never pause decoding: ``update_params`` swaps the
  parameter dict between windows; requests in flight continue on the new
  weights. A push from another process (``update_params_serialized``, a
  PWT3 body) or a host tree of numpy arrays goes through the transfer
  thread first, in one of three modes by size:
  - up to ``push_double_buffer_max_bytes`` ("blob", "double-buffer"): each dtype
    group is copied as one run from a pinned staging ring into one device
    buffer on a side CUDA stream, the leaves are carved as views of it, and
    once the copies' event has fired the whole tree goes to the engine
    thread, which swaps it between windows. The buffers are recorded on the
    engine's stream, so a later swap that drops them cannot free them under
    a decode window that still reads them;
  - over it ("blob-chunked" for a PWT3 body, "streamed" for a host tree, the
    JAX engine's chunked ``_transfer_blob`` and ``_stream_leaves_inplace``):
    whole tensors are staged in chunks of at most ``push_stream_chunk_bytes``,
    and a tensor larger than a chunk by ranges of whole rows (the row
    splice). Each piece is copied into the live weights on the engine's
    stream, after the piece's copy event and between two windows, so the
    extra device memory is about two pieces, never a second tree. Windows
    that run meanwhile see a mix of old and new weights, as in the JAX
    engine: each token's logprob still comes from the logits that sampled
    it, and the version stamps bracket the change; the version moves when
    the last piece is in.
  A push of a newer version that arrives mid-transfer supersedes the one in
  flight at most once in a row, after any group or piece (a cut stream
  leaves a mixed tree with no version bump, as in JAX); one of an older
  version (two bodies read at once can queue out of order) waits and is
  dropped unstaged once a newer one has been published (the swap keeps its
  version check as a backstop). The JAX engine paces its copies through a
  gate the engine thread opens, because host-to-device copies on its TPU
  link serialise with execution; an H100's copy engines run beside the SMs,
  so pacing is not ported.
- VLM requests (``GenRequest.visual``) prefill one row per GRPO cluster
  (``_prefill_vlm``): the vision tower encodes the pixels at a bucketed
  patch count, the merged tokens are spliced at the image placeholders,
  the row runs with mrope positions, and identical siblings fork its KV.
  Each slot keeps an mrope ``pos_delta`` that shifts its decode positions.
  A push that carries ``vision_tower`` refreshes the engine's tower.
- Token-native: prompts arrive as token ids, completions leave as token ids
  plus per-token processed logprobs.
- Windows are pipelined: up to ``window_pipeline_depth`` windows are queued
  on the device before the oldest is read back, and the device carries the
  last sampled token of each slot from one window to the next.

- Tensor and pipeline parallelism (``tp_world``, ``engine.tp *
  engine.pp`` rank processes, ``tp_ranks.py``): each rank holds its
  stage's layers cut to its tp slice and a cache of those layers' KV heads
  (``[L/pp, S, T, K_local, Dh]``, or its page pool ``[L/pp, NB, BT,
  K_local, Dh]``, with the one-rank engine's S, T and NB); rank 0
  schedules and broadcasts each step's inputs, every rank runs the step,
  each stage hands its hidden state to the next, and the last stage's
  logits are all-gathered over tp before its sampler; its tokens go to
  every rank, so every scheduler reads back the same windows. Pushes land
  through the tree path on every rank.

The scheduling loop runs on its own thread (``start``) or is driven by
calling ``step``; ``submit`` returns a ``concurrent.futures.Future`` and is
thread-safe.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, ContextManager

import numpy as np
import torch

from ..models.mrope import mrope_positions
from ..models.transformer import (
    ModelConfig,
    decode_step_staged,
    forward,
    forward_extend,
    lm_head_logits,
    tp_kv_heads,
)
from ..parallel.collectives import TP, gather_vocab
from ..parallel.mesh import check_pp_layers
from ..parallel.sharding import pp_local, tp_cut, tp_local
from ..models.vision import prepare_vision_inputs, vision_forward, vision_inputs_to
from ..ops.paged_attention import gather_pages, paged_append, paged_decode_attention
from ..ops.sampling import sample_fast, sample_masked
from ..train.rl_loss import token_logprobs_from_logits
from . import tp_ranks
from .block_pool import BlockPool, PrefixCache
from .weight_transfer import (
    as_tensor,
    byte_view,
    deserialize_params,
    entry_count,
    flatten_params,
    parse_push_header,
    serialize_params,
    torch_dtype,
    unflatten_params,
)

logger = logging.getLogger(__name__)

# a push is staged in chunks of this size, on CUDA through a ring of this
# many pinned host chunks: the host fills one while the copy engine drains
# the others
PUSH_CHUNK_BYTES = 64 << 20
PUSH_RING_CHUNKS = 3


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_len: int = 1024  # per-slot KV capacity (prompt + completion)
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024)
    seed: int = 0
    cache_dtype: torch.dtype = torch.bfloat16
    # decode steps per window; the host reads tokens back once per window,
    # and a slot finishing mid-window wastes at most W-1 speculative tokens
    decode_window: int = 8
    # windows queued on the device before the oldest is read back
    window_pipeline_depth: int = 2
    # when the median remaining budget of the active slots fits a smaller
    # window (W/2, W/4), dispatch that size instead
    adaptive_window: bool = False
    # prefill attention: "auto" | "xla" (plain torch) | "gqa" (CUDA kernel)
    attn_impl: str = "auto"
    # decode attention: "auto" | "xla" (plain torch) | "ragged" (CUDA kernel).
    # "auto" takes the kernels on CUDA and the plain versions elsewhere.
    decode_attn_impl: str = "auto"
    # same-bucket admissions prefill together, in batches of 8/4/2/1 up to this
    max_prefill_batch: int = 8
    # KV layout: "slab" reserves a contiguous [max_len] cache per slot;
    # "paged" allocates kv_block_size-token pages from a shared pool, so the
    # device holds only tokens that exist. "auto" resolves to slab.
    kv_layout: str = "auto"
    kv_block_size: int = 128  # tokens per page
    # cross-request prefix reuse, by layout:
    # - paged: finished transcripts' full pages stay in an LRU cache, and a
    #   prompt that extends one prefills only its tail;
    # - slab: a finished slot is parked with its K/V rows in place, and a
    #   prompt that extends its transcript resumes the slot and prefills
    #   only its tail. Parked slots count as free capacity: admission evicts
    #   them least recently parked first, so parking never lowers the number
    #   of requests in flight.
    prefix_cache: bool = True
    # shortest parked transcript that a slab hit reuses
    slab_prefix_min_tokens: int = 32
    # pool size in pages; None sizes it to slab parity, S * ceil(T_alloc / BT)
    kv_pool_blocks: int | None = None
    # host-side pushes up to this size are staged whole beside the live
    # weights and swapped atomically; a larger one streams into the live
    # weights in pieces of at most push_stream_chunk_bytes
    push_double_buffer_max_bytes: int = 6 << 30
    push_stream_chunk_bytes: int = 256 << 20
    # VLM: merged-visual-token buckets of the vision tower's input
    vision_unit_buckets: tuple[int, ...] = (64, 256, 1024, 4096)


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    max_tokens: int = 256
    stop_token_ids: tuple[int, ...] = ()

    @property
    def needs_masking(self) -> bool:
        return self.top_p < 1.0 or self.top_k > 0


@dataclass
class GenRequest:
    prompt_ids: list[int]
    params: SamplingParams
    request_id: str = ""
    # VLM: {"pixel_values": [N, patch_dim], "image_grid_thw": [n, 3]};
    # prompt_ids hold one image placeholder per merged visual token
    visual: dict | None = None
    # streaming: called from the engine thread as tokens materialize, once
    # per window: cb(token_ids, logprobs, finish); the last call has finish
    # set. Must be fast and must not block.
    stream_callback: Any = None


@dataclass
class GenResult:
    token_ids: list[int]  # completion tokens (stop token included)
    logprobs: list[float]  # processed logprob per completion token
    finish_reason: str  # "stop" | "length" | "abort"
    model_version_start: int = 0
    model_version_end: int = 0
    prompt_tokens: int = 0


@dataclass
class _Slot:
    request: GenRequest
    future: Future
    token_ids: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    version_start: int = 0
    max_new_tokens: int = 0
    # True until the prefill-sampled first token reaches the transcript (it
    # rides in row 0 of the next window's packed output)
    pending_first: bool = True
    # True once a window was dispatched for this occupant: only the first
    # dispatch takes the token from the prefill's first_info, later windows
    # chain the device carry
    first_dispatched: bool = False
    # slot-assignment id: keeps a pipelined window from delivering a
    # previous occupant's tokens to a new request
    gen: int = 0
    # stamp of this occupant's slab park entry, -1 while it has none
    park_stamp: int = -1


@dataclass
class _Window:
    """A dispatched decode window not yet read back."""

    # int32 [2, N+1, S] on the device: row 0 of axis 1 is the prefill first
    # token info (token, bitcast fp32 logprob), rows 1..N the window's tokens
    # and bitcast logprobs. One read per window.
    packed: torch.Tensor
    active: np.ndarray  # [S] at dispatch
    gens: np.ndarray  # [S] slot generations at dispatch
    pending: list[int]  # slots whose prefill first token rides along
    n_steps: int = 0


def _trainer_only(name: str) -> bool:
    return name == "value_head" or name.startswith("value_head/")


class _PinnedRing:
    """A few reusable pinned host chunks: a chunk is refilled only after the
    copy that last read it has run."""

    def __init__(self, n: int, chunk_bytes: int):
        self.bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True) for _ in range(max(1, n))]
        self.events: list[torch.cuda.Event | None] = [None] * len(self.bufs)
        self.next = 0

    def acquire(self) -> tuple[int, torch.Tensor]:
        slot = self.next
        self.next = (slot + 1) % len(self.bufs)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        return slot, self.bufs[slot]

    def release(self, slot: int, stream) -> None:
        event = torch.cuda.Event()
        event.record(stream)
        self.events[slot] = event


def _resolve_impl(name: str, device: torch.device, kernel: str) -> str:
    if name == "auto":
        return kernel if device.type == "cuda" else "xla"
    if name in ("flash", "blockwise") and kernel == "gqa":
        return "gqa"  # JAX's splash and blockwise attention, which the port routes to kernel #2
    if name == "cp" and kernel == "gqa":
        return "xla"  # the JAX engine's forward runs mha_packed for a name it does not know
    if name not in ("xla", kernel):
        raise ValueError(f"unknown attention implementation {name!r}")
    return name


class InferenceEngine:
    def __init__(
        self,
        params: dict,
        model_cfg: ModelConfig,
        cfg: EngineConfig,
        eos_token_id: int,
        version: int = 0,
        device="cuda",
        vision_params: dict | None = None,
        vision_cfg=None,  # models.vision.VisionConfig
        tp_world: tp_ranks.EngineWorld | None = None,  # this rank of a tp and/or pp engine
    ):
        self.device = torch.device(device)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.eos_token_id = eos_token_id
        self.version = version
        # tensor and pipeline parallelism: this rank's tp group, its stage,
        # the names, dtypes and whole shapes a push must carry, then this
        # rank's slice of the weights
        self.tp_world = tp_world
        self._multi = tp_world is not None and tp_world.size > 1
        self.tp: TP | None = tp_world.tp if tp_world is not None and tp_world.tp_size > 1 else None
        self.pp: tp_ranks.EngineWorld | None = tp_world if tp_world is not None and tp_world.pp > 1 else None
        if self.pp is not None:
            check_pp_layers(model_cfg.num_layers, self.pp.pp)
        self._cut = tp_cut(model_cfg, 1 if self.tp is None else self.tp.size)
        self._push_spec = {name: (str(t.dtype).removeprefix("torch."), tuple(t.shape))
                           for name, t in flatten_params({**params, **({"vision_tower": vision_params}
                                                                       if vision_params is not None else {})})}
        self.params = self._local(params)
        # the vision tower (models/vision.py): visual requests are refused
        # without one; a push that carries ``vision_tower`` refreshes it
        self.vision_params = vision_params
        self.vision_cfg = vision_cfg
        self._pending_params: tuple[dict, int] | None = None
        self._pending_vision: dict | None = None
        self._params_lock = threading.Lock()
        # held while the engine thread dispatches, and by the transfer thread
        # to queue a streamed piece's copy, so pieces land between windows
        self._dispatch_lock = threading.Lock()

        S, T = cfg.max_slots, cfg.max_len
        L = model_cfg.num_layers // (1 if self.pp is None else self.pp.pp)
        K, Dh = tp_kv_heads(model_cfg, self.tp), model_cfg.head_dim_
        # + window: band merges stay in bounds (valid tokens never pass
        # position max_len - 1; the tail is speculative scratch)
        self.T_alloc = T + max(1, cfg.decode_window)
        dev = self.device
        if cfg.kv_layout not in ("auto", "slab", "paged"):
            raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
        self.paged = cfg.kv_layout == "paged"
        self.prefix_cache: PrefixCache | None = None
        if self.paged:
            BT = cfg.kv_block_size
            max_blocks = -(-self.T_alloc // BT)
            self.block_pool = BlockPool(
                n_blocks=cfg.kv_pool_blocks or S * max_blocks, block_size=BT,
                max_blocks_per_slot=max_blocks, n_slots=S,
            )
            NB = self.block_pool.n_blocks
            self.k_pool = torch.zeros((L, NB, BT, K, Dh), dtype=cfg.cache_dtype, device=dev)
            self.v_pool = torch.zeros_like(self.k_pool)
            # tokens reserved per slot at admission (its pages' capacity)
            self._slot_capacity = np.zeros(S, np.int64)
            if cfg.prefix_cache:
                self.prefix_cache = PrefixCache(self.block_pool)
        else:
            self.k_cache = torch.zeros((L, S, self.T_alloc, K, Dh), dtype=cfg.cache_dtype, device=dev)
            self.v_cache = torch.zeros_like(self.k_cache)
        # slab prefix reuse: slot -> (parked transcript, LRU stamp). Parked
        # slots keep their K/V rows; admission resumes them for prompts that
        # extend the transcript and evicts them otherwise (empty on paged)
        self._parked: dict[int, tuple[list[int], int]] = {}
        self._park_stamp = 0
        self.slab_prefix_hits = 0
        self.cache_lens = torch.zeros(S, dtype=torch.int32, device=dev)
        # per-slot (first sampled token, bitcast logprob) written by prefill
        # on the device, read back as row 0 of the next packed window
        self.first_info = torch.zeros((S, 2), dtype=torch.int32, device=dev)
        # device-resident last sampled token per slot: each window starts
        # from the previous window's carry, not the host's stale view
        self._device_tokens = torch.zeros(S, dtype=torch.int64, device=dev)
        # per-slot mrope decode offset: max(position) + 1 - prompt length of
        # a VLM prompt, 0 for text
        self._pos_delta = np.zeros(S, np.int64)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(cfg.seed + 1)

        self._slots: list[_Slot | None] = [None] * S
        self._queue: deque[tuple[GenRequest, Future]] = deque()
        self._queue_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._work_event = threading.Event()

        self.buckets = tuple(sorted(b for b in cfg.prefill_buckets if b <= T))
        if not self.buckets or self.buckets[-1] < T:
            self.buckets = self.buckets + (T,)

        # perf counters
        self.total_generated_tokens = 0
        self.total_prefill_tokens = 0
        self.prefill_reused_tokens = 0  # prompt tokens served by KV fork
        self.prefill_batches = 0
        self.prefill_extend_batches = 0  # of them, tails against cached prefixes (both layouts)
        self.decode_steps = 0
        self.speculative_wasted_tokens = 0
        self.windows_dispatched = 0
        self.window_slots_dispatched = 0
        self.window_size_counts: dict[int, int] = {}
        self.aborted_requests = 0

        window = max(1, cfg.decode_window)
        if cfg.adaptive_window and window >= 4:
            self._window_sizes = sorted({max(1, window // 4), max(1, window // 2), window})
        else:
            self._window_sizes = [window]
        self.attn_impl = _resolve_impl(cfg.attn_impl, dev, "gqa")
        self.decode_attn_impl = _resolve_impl(cfg.decode_attn_impl, dev, "ragged")
        self._windows: deque[_Window] = deque()
        # early-retired occupants: (slot, gen) -> state. A slot whose budget
        # is covered by dispatched windows is freed for admission at once;
        # its future resolves when its last window is read back.
        self._retiring: dict[tuple[int, int], _Slot] = {}
        self._gen_counter = 0
        self._abort_ids: set[str] = set()

        # weight pushes through the transfer thread
        self._transfer_pending: tuple | None = None  # ("tree" | "blob", ...)
        self._transfer_event = threading.Event()
        self._transfer_thread: threading.Thread | None = None
        self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._ring: _PinnedRing | None = None  # made at the first push on CUDA
        self.last_push_timings: dict = {}
        self._push_yields = 0
        self._push_arrival_prev: float | None = None
        self._push_interval_ema: float | None = None
        self._push_last_span_s = 0.0
        self._push_last_version: int | None = None
        self._pushes_received = 0
        self._pushes_completed = 0
        self._pushes_superseded = 0
        self._published_at: float | None = None
        # read-back times of the last windows: the decode gaps during a push
        self._window_times: deque[float] = deque(maxlen=4096)
        # a tp engine's rank 0: requests and jobs waiting for the next
        # step's command; a worker: its staged pushes by version
        self._inbox: list[tuple[GenRequest, Future]] = []
        self._tp_jobs: list[tuple[str, Any, Future]] = []
        self._tp_staged: dict[int, dict] = {}
        self._tp_swap: tuple | None = None
        self._tp_futures: list[Future] = []
        self._tp_aborts: set[str] = set()
        # a running CRC of every window read back: equal on a tp engine's
        # ranks while they stay in lockstep
        self.window_digest = 0
        self._tp_receiver: threading.Thread | None = None
        if self._multi and tp_world.rank > 0:
            self._tp_receiver = threading.Thread(target=self._tp_receive_pushes, daemon=True, name="tp-push-receiver")
            self._tp_receiver.start()

    def _local(self, params: dict) -> dict:
        """This rank's slice of a full model tree: its stage's layers and top
        leaves, cut to its tp slice (the tree itself on one rank)."""
        if self.pp is not None:
            params = pp_local(params, self.pp.stage, self.pp.pp)
        if self.tp is not None:
            params = tp_local(params, self.tp.rank, self.tp.size, self._cut)
        return params

    # ------------------------------------------------------------------
    # public API (thread-safe)
    # ------------------------------------------------------------------
    def submit(self, request: GenRequest) -> Future:
        future: Future = Future()
        # running futures cannot be cancelled: a caller that gives up calls
        # abort(), and the engine always resolves the future itself
        future.set_running_or_notify_cancel()
        prompt_len = len(request.prompt_ids)
        if request.visual is not None and (self.vision_params is None or self.vision_cfg is None):
            future.set_exception(RuntimeError("engine has no vision tower but got a visual request"))
            return future
        if prompt_len == 0 or prompt_len >= self.cfg.max_len:
            self._notify(request, [], [], "abort")
            future.set_result(GenResult([], [], "abort", self.version, self.version, prompt_len))
            return future
        with self._queue_lock:
            # a many-rank engine's rank 0 queues it with the next step's command
            (self._inbox if self._multi else self._queue).append((request, future))
        self._work_event.set()
        return future

    def abort(self, request_id: str) -> None:
        """Cancel a request by id. A queued request resolves at the next step
        with finish_reason "abort"; an in-flight slot is freed there, its
        future resolving with the tokens generated so far."""
        if not request_id:
            return
        with self._queue_lock:
            (self._tp_aborts if self._multi else self._abort_ids).add(request_id)
        self._work_event.set()

    def update_params(self, params: dict, version: int) -> None:
        """Swap weights between decode windows: no pause, no drain. The
        engine thread installs ``params`` at its next step unless a newer
        version is already installed; a ``vision_tower`` subtree refreshes
        the tower with it. A tree of numpy arrays goes through the transfer
        thread, which copies it to the engine's device first."""
        leaves = [leaf for _, leaf in flatten_params(params)]
        if self._multi:
            # every rank lands its slice: the tree goes as a PWT3 body
            self.update_params_serialized(serialize_params(params, version))
            return
        if leaves and all(isinstance(leaf, np.ndarray) for leaf in leaves):
            self._enqueue_transfer(("tree", params, version))
            return
        vision = None
        if "vision_tower" in params:
            params = dict(params)
            vision = params.pop("vision_tower")
        with self._params_lock:
            self._pending_params = (params, version)
            self._pending_vision = vision
        self._work_event.set()

    def update_params_serialized(self, body) -> int:
        """Swap weights from a PWT3 body (``weight_transfer.py``): the
        transfer thread stages it on the device while decoding goes on.
        Raises ValueError on a tree that does not match the engine's weights.
        Returns the version."""
        groups, tensors, version, base = parse_push_header(body)
        self._validate_push_spec(tensors)
        if self._multi:  # the tree path on every rank, as JAX's tp and pp engines
            self._enqueue_transfer(("tp", body, version))
            return version
        keep = [t for t in tensors if self._pushed(t["name"])]
        self._enqueue_transfer(("blob", body, groups, keep, base, version))
        return version

    def _pushed(self, name: str) -> bool:
        """Whether a pushed tensor reaches the engine: the value head is the
        trainer's, and a tower reaches only an engine that has one."""
        return not _trainer_only(name) and (self.vision_params is not None or not name.startswith("vision_tower/"))

    def _validate_push_spec(self, tensors: list[dict]) -> None:
        """A pushed tree must match the engine's weights exactly (names,
        shapes, dtypes), ``vision_tower/*`` the engine's tower where it has
        one; the value head is the trainer's and is dropped, and so is a
        tower pushed to an engine without one."""
        expected = self._push_spec
        got = {t["name"]: (t["dtype"], tuple(int(x) for x in t["shape"]))
               for t in tensors if self._pushed(t["name"])}
        if set(got) != set(expected):
            missing = sorted(set(expected) - set(got))[:5]
            extra = sorted(set(got) - set(expected))[:5]
            raise ValueError(f"weight push tree mismatch: missing={missing} extra={extra}")
        for name, spec in got.items():
            if spec != expected[name]:
                raise ValueError(f"weight push tensor mismatch for {name!r}: pushed {spec}, engine has {expected[name]}")

    def _should_yield_to_newer(self, version: int) -> bool:
        """Mid-transfer supersede policy: yield to a queued push of a newer
        version at most once in a row, then finish. Two bodies read at once
        can queue out of order, and a newer push that yielded to an older
        one would never land."""
        with self._params_lock:
            pending = self._transfer_pending
            if pending is None or pending[-1] <= version or self._push_yields >= 1:
                return False
            self._push_yields += 1
            self._pushes_superseded += 1
            return True

    def push_counters(self) -> dict:
        """Pushes received, completed and superseded, the last completed
        span and version, the arrival cadence, and span over cadence (above
        1 the engine serves ever staler weights)."""
        interval = self._push_interval_ema
        return {
            "pushes_received": self._pushes_received,
            "pushes_completed": self._pushes_completed,
            "pushes_superseded": self._pushes_superseded,
            "push_last_span_s": round(self._push_last_span_s, 3),
            "push_last_version": self._push_last_version,
            "push_interval_ema_s": round(interval, 3) if interval else None,
            "push_span_vs_update_interval": (
                round(self._push_last_span_s / interval, 3) if interval and interval > 0 else None
            ),
        }

    def _enqueue_transfer(self, job: tuple) -> None:
        now = time.monotonic()
        self._pushes_received += 1
        if self._push_arrival_prev is not None:
            dt = now - self._push_arrival_prev
            self._push_interval_ema = dt if self._push_interval_ema is None else 0.7 * self._push_interval_ema + 0.3 * dt
        self._push_arrival_prev = now
        with self._params_lock:
            # the newest version waits (a job's version is its last field)
            if self._transfer_pending is None or self._transfer_pending[-1] <= job[-1]:
                self._transfer_pending = job
        if self._transfer_thread is None or not self._transfer_thread.is_alive():
            self._transfer_thread = threading.Thread(target=self._transfer_loop, daemon=True, name="weight-transfer")
            self._transfer_thread.start()
        self._transfer_event.set()

    def _transfer_loop(self) -> None:
        """Stage pushes on the device off the engine thread, the newest
        version winning, and publish each complete tree for the engine
        thread's swap."""
        while not self._stop.is_set():
            self._transfer_event.wait(timeout=0.1)
            self._transfer_event.clear()
            with self._params_lock:
                job, self._transfer_pending = self._transfer_pending, None
                waiting = self._pending_params
                newest = self.version if waiting is None else max(self.version, waiting[1])
            if job is None or job[-1] < newest:
                continue  # an older push queued behind a newer one that has landed
            try:
                if job[0] == "blob":
                    self._transfer_blob(*job[1:])
                elif job[0] == "tp":
                    self._transfer_tp(*job[1:])
                else:
                    self._transfer_tree(*job[1:])
            except Exception:  # noqa: BLE001 - a bad push must not kill the thread
                logger.exception("weight push failed; dropped")

    def live_tree(self) -> dict:
        """The weights a push replaces: the model's, with the tower under
        ``vision_tower`` where the engine has one."""
        if self.vision_params is None:
            return self.params
        return {**self.params, "vision_tower": self.vision_params}

    def _transfer_blob(self, body, groups: list[dict], tensors: list[dict], base: int, version: int) -> None:
        """Within the double-buffer budget, each dtype group's run in one
        device buffer, its tensors carved as views, and the tree published
        once every copy has landed; over it, the chunked stream into the
        live weights."""
        t0 = time.monotonic()
        total = sum(entry_count(t) * torch_dtype(t["dtype"]).itemsize for t in tensors)
        if total > self.cfg.push_double_buffer_max_bytes:
            pieces = []
            for g in groups:
                entries = sorted((t for t in tensors if t["dtype"] == g["dtype"]), key=lambda t: int(t["elem_offset"]))
                dt = torch_dtype(g["dtype"])
                start = base + int(g["byte_offset"])
                for lo, hi, targets in self._plan_pieces(
                        [(t["name"], tuple(int(x) for x in t["shape"]), int(t["elem_offset"])) for t in entries],
                        dt.itemsize):
                    pieces.append((byte_view(body, start + lo * dt.itemsize, (hi - lo) * dt.itemsize), dt,
                                   hi - lo, targets))
            self._stream_pieces(pieces, version, t0, total, "blob-chunked")
            return
        staged, nbytes = {}, 0
        for g in groups:
            entries = [t for t in tensors if t["dtype"] == g["dtype"]]
            if not entries:
                continue
            dt = torch_dtype(g["dtype"])
            lo = min(int(t["elem_offset"]) for t in entries)
            hi = max(int(t["elem_offset"]) + entry_count(t) for t in entries)
            start = base + int(g["byte_offset"]) + lo * dt.itemsize
            run = self._stage_run(byte_view(body, start, (hi - lo) * dt.itemsize), dt, hi - lo)
            nbytes += (hi - lo) * dt.itemsize
            for t in entries:
                off = int(t["elem_offset"]) - lo
                staged[t["name"]] = run[off : off + entry_count(t)].view(t["shape"])
            if self._should_yield_to_newer(version):
                return  # the newer push wins (one yield in a row)
        self._publish(unflatten_params(staged), version, t0, nbytes, "blob")

    def _transfer_tree(self, params: dict, version: int) -> None:
        """A host tree of numpy arrays: one staged run per leaf within the
        double-buffer budget, else streamed into the live weights leaf by
        leaf (a leaf larger than a chunk by rows)."""
        t0 = time.monotonic()
        leaves = [(name, as_tensor(leaf)) for name, leaf in flatten_params(params) if self._pushed(name)]
        total = sum(t.numel() * t.element_size() for _, t in leaves)
        if total > self.cfg.push_double_buffer_max_bytes:
            pieces = []
            for name, src in leaves:
                raw = src.reshape(-1).view(torch.uint8)
                for lo, hi, targets in self._plan_pieces([(name, tuple(src.shape), 0)], src.element_size()):
                    size = src.element_size()
                    pieces.append((raw[lo * size : hi * size], src.dtype, hi - lo, targets))
            self._stream_pieces(pieces, version, t0, total, "streamed")
            return
        staged = {}
        for name, src in leaves:
            run = self._stage_run(src.reshape(-1).view(torch.uint8), src.dtype, src.numel())
            staged[name] = run.view(src.shape)
        self._publish(unflatten_params(staged), version, t0, total, "double-buffer")

    def _transfer_tp(self, body, version: int) -> None:
        """Rank 0 of a tp engine: the body to every rank, then this rank's
        slice staged; once every rank holds its slice, the version is
        published for the next step's command to swap in."""
        t0 = time.monotonic()
        tp_ranks.send_push(self.tp_world, body, version)
        staged = self._stage_tp_slice(body)
        if not tp_ranks.all_staged(self.tp_world, staged is not None):
            logger.error("weight push %d: a rank failed to stage its slice; dropped", version)
            return
        self._publish(staged, version, t0, len(body), "tp-tree")

    def _stage_tp_slice(self, body) -> dict | None:
        """This rank's slice of a PWT3 body on the device (a tower whole,
        under ``vision_tower``, where the engine has one), or None when it
        fails."""
        try:
            params, _ = deserialize_params(body)
            vision = params.pop("vision_tower", None)
            params.pop("value_head", None)
            tree = self._local(params)
            if vision is not None and self.vision_params is not None:
                tree["vision_tower"] = vision
            staged = {}
            for name, src in flatten_params(tree):
                src = src.contiguous()
                staged[name] = self._stage_run(src.reshape(-1).view(torch.uint8), src.dtype, src.numel()).view(
                    src.shape)
            if self._copy_stream is not None:
                self._copy_stream.synchronize()
            return unflatten_params(staged)
        except Exception:  # noqa: BLE001 - every rank must reach the all-reduce
            logger.exception("staging a tp push slice failed")
            return None

    def _tp_receive_pushes(self) -> None:
        """A worker's push receiver: each body rank 0 broadcasts, this rank's
        slice staged and kept by version until a command swaps it in."""
        while True:
            got = tp_ranks.receive_push(self.tp_world)
            if got is None:
                return
            body, version = got
            staged = self._stage_tp_slice(body.numpy())
            if staged is not None:
                with self._params_lock:
                    self._tp_staged[version] = staged
            tp_ranks.all_staged(self.tp_world, staged is not None)

    def _plan_pieces(self, entries: list[tuple[str, tuple, int]], itemsize: int) -> list[tuple[int, int, list]]:
        """Cut one dtype run's tensors, ``(name, shape, elem_offset)`` in
        offset order, into pieces of at most ``push_stream_chunk_bytes``:
        consecutive whole tensors share a piece, and a tensor larger than a
        piece goes by ranges of whole rows (a single row larger than a piece
        is a piece of its own). Returns ``(lo, hi, targets)`` element ranges
        of the run, each target ``(name, first row, rows or None for the
        whole tensor, element offset in the piece)``."""
        budget = max(1, int(self.cfg.push_stream_chunk_bytes) // itemsize)
        pieces: list[tuple[int, int, list]] = []
        lo = hi = None
        targets: list = []

        def flush():
            nonlocal lo, hi, targets
            if targets:
                pieces.append((lo, hi, targets))
            lo = hi = None
            targets = []

        for name, shape, off in entries:
            count = math.prod(shape)
            if count > budget:
                flush()
                row = math.prod(shape[1:]) if len(shape) > 1 else 1
                rows = max(1, budget // row)
                for r in range(0, shape[0] if len(shape) > 1 else count, rows):
                    n = min(rows, (shape[0] if len(shape) > 1 else count) - r)
                    pieces.append((off + r * row, off + (r + n) * row, [(name, r, n, 0)]))
                continue
            if targets and off + count - lo > budget:
                flush()
            if lo is None:
                lo = off
            targets.append((name, None, None, off - lo))
            hi = off + count
        flush()
        return pieces

    def _stream_pieces(self, pieces: list[tuple], version: int, t0: float, total: int, mode: str) -> None:
        """Stage each piece on the copy stream and copy it into the live
        weights on the engine's stream between two windows. At most two
        pieces' buffers are alive: a piece's splice is waited for before the
        piece after next is staged. A newer push may cut the stream after
        any piece; the version moves when the last piece is in."""
        engine_stream = torch.cuda.default_stream(self.device) if self.device.type == "cuda" else None
        previous = None
        done_bytes, row_spliced = 0, []
        for src, dtype, count, targets in pieces:
            run = self._stage_run(src, dtype, count)
            copied = None
            if self._copy_stream is not None:
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            with self._dispatch_lock:
                live = dict(flatten_params(self.live_tree()))
                with torch.cuda.stream(engine_stream) if engine_stream is not None else contextlib.nullcontext():
                    if copied is not None:
                        engine_stream.wait_event(copied)
                    for name, row, rows, off in targets:
                        dst = live[name] if row is None else live[name][row : row + rows]
                        dst.copy_(run[off : off + dst.numel()].view(dst.shape))
                    spliced = None
                    if engine_stream is not None:
                        spliced = torch.cuda.Event()
                        spliced.record(engine_stream)
            del run
            if previous is not None:
                previous.synchronize()
            previous = spliced
            done_bytes += count * dtype.itemsize
            row_spliced += [name for name, row, _, _ in targets if row == 0]
            self.last_push_timings = {"transfer_s": time.monotonic() - t0, "bytes_done": done_bytes, "bytes": total,
                                      "in_progress": True, "mode": mode, "pieces": len(pieces),
                                      "row_spliced": row_spliced}
            if self._should_yield_to_newer(version):
                return  # the newer push wins; the tree stays mixed, the version unmoved
            with self._params_lock:
                if self._pending_params is not None and self._pending_params[1] >= version:
                    return  # a fully staged tree of an equal or newer version supersedes
        if previous is not None:
            previous.synchronize()
        t1 = time.monotonic()
        with self._params_lock:
            if self._pending_params is not None and self._pending_params[1] >= version:
                return
            if version > self.version:
                self.version = version
        self._note_push_complete(t0, t1, version)
        self.last_push_timings = {"transfer_s": t1 - t0, "bytes": total, "gbps": total / max(t1 - t0, 1e-9) / 1e9,
                                  "mode": mode, "pieces": len(pieces), "row_spliced": row_spliced,
                                  **self.window_gaps(t0, t1)}
        self._work_event.set()

    def _stage_run(self, src: torch.Tensor, dtype: torch.dtype, count: int) -> torch.Tensor:
        """Copy ``src`` (uint8 bytes on the host) into a new device tensor of
        ``count`` elements of ``dtype``, chunk by chunk. On CUDA each chunk
        goes through the pinned ring to the copy stream; the buffer is
        allocated on that stream and recorded on the engine's."""
        chunk = PUSH_CHUNK_BYTES
        side = self._copy_stream
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            run = torch.empty(count, dtype=dtype, device=self.device)
            dst = run.view(torch.uint8) if count else run
            for a in range(0, src.numel(), chunk):
                b = min(a + chunk, src.numel())
                if side is None:
                    self._copy_chunk(dst[a:b], src[a:b])
                    continue
                if self._ring is None:
                    self._ring = _PinnedRing(PUSH_RING_CHUNKS, chunk)
                slot, pinned = self._ring.acquire()
                pinned[: b - a].copy_(src[a:b])
                self._copy_chunk(dst[a:b], pinned[: b - a])
                self._ring.release(slot, side)
        if side is not None:
            run.record_stream(torch.cuda.default_stream(self.device))
        return run

    def _copy_chunk(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """One chunk of a staged run (asynchronous on the copy stream)."""
        dst.copy_(src, non_blocking=True)

    def _publish(self, tree: dict, version: int, t0: float, nbytes: int, mode: str) -> None:
        """Hand a fully staged tree to the engine thread, once its copies
        have landed, unless an equal or newer tree is already waiting."""
        if self._copy_stream is not None:
            done = torch.cuda.Event()
            done.record(self._copy_stream)
            done.synchronize()
        t1 = time.monotonic()
        vision = tree.pop("vision_tower", None)
        with self._params_lock:
            if self._pending_params is not None and self._pending_params[1] >= version:
                return
            self._pending_params = (tree, version)
            self._pending_vision = vision
            self._published_at = t1
        self._note_push_complete(t0, t1, version)
        self.last_push_timings = {"transfer_s": t1 - t0, "bytes": nbytes, "gbps": nbytes / max(t1 - t0, 1e-9) / 1e9,
                                  "mode": mode, **self.window_gaps(t0, t1)}
        self._work_event.set()

    def _note_push_complete(self, t0: float, t1: float, version: int) -> None:
        self._push_yields = 0
        self._push_last_span_s = t1 - t0
        self._push_last_version = version
        self._pushes_completed += 1

    def window_gaps(self, t0: float, t1: float) -> dict:
        """Windows read back during [t0, t1], the largest gap between read
        backs there, and the median gap of the windows before it."""
        times = list(self._window_times)
        during = [t for t in times if t0 <= t <= t1]
        before = [t for t in times if t < t0][-257:]
        spans = [b - a for a, b in zip([t0, *during], [*during, t1])]
        steady = sorted(b - a for a, b in zip(before, before[1:]))
        return {
            "windows_during": len(during),
            "max_window_gap_s": max(spans),
            "steady_window_gap_s": steady[len(steady) // 2] if steady else None,
        }

    @torch.no_grad()
    def score_tokens(self, input_ids: list[int], temperature: float = 1.0) -> list[float]:
        """Teacher-forced logprobs of ``input_ids[1:]`` under the current
        weights (the JAX engine's ``score_tokens``): one row padded to the
        smallest prefill bucket that holds it, one segment, the engine's
        prefill attention. The KL reference policy scores samples with it."""
        n = len(input_ids)
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:
            raise ValueError(f"sequence of {n} tokens exceeds the largest bucket {self.buckets[-1]}")
        if self._multi:  # every rank runs it, at the next step
            return self._tp_job("score", (list(input_ids), float(temperature)))
        return self._score(list(input_ids), temperature)

    def _score(self, input_ids: list[int], temperature: float) -> list[float]:
        n = len(input_ids)
        padded = torch.zeros((1, self._bucket(n)), dtype=torch.int64)
        padded[0, :n] = torch.tensor(input_ids, dtype=torch.int64)
        lp = _score_fn(self.params, self.model_cfg, self.attn_impl, padded.to(self.device), temperature, self.tp,
                       self.pp)
        return lp[0, : n - 1].tolist()

    def rank_checksums(self) -> list[dict]:
        """Each rank's ``server.param_checksums`` of its live weights, in
        rank order (one rank alone)."""
        if not self._multi:
            return [self._checksums()]
        return self._tp_job("checksums", None)

    def _checksums(self) -> dict:
        from .server import param_checksums

        with torch.no_grad():
            return param_checksums(self.live_tree())

    def _tp_job(self, kind: str, args):
        """Rank 0: run a job on every rank at the next step; its result."""
        future: Future = Future()
        with self._queue_lock:
            self._tp_jobs.append((kind, args, future))
        self._work_event.set()
        if self._thread is None:  # stepped by hand
            self.step()
        return future.result()

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine-loop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._work_event.set()
        self._transfer_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._transfer_thread is not None:
            self._transfer_thread.join(timeout=10)
        if self._multi and self.tp_world.rank == 0:  # the workers' loops and receivers end
            tp_ranks.send_command(self.tp_world, None)
            tp_ranks.send_push(self.tp_world, None, 0)

    @property
    def num_active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def num_pending(self) -> int:
        return len(self._queue)

    def perf_counters(self) -> dict:
        windows = max(1, self.windows_dispatched)
        produced = max(1, self.total_generated_tokens)
        return {
            "generated_tokens": self.total_generated_tokens,
            "prefill_tokens": self.total_prefill_tokens,
            "prefill_reused_tokens": self.prefill_reused_tokens,
            "prefill_batches": self.prefill_batches,
            "decode_steps": self.decode_steps,
            "speculative_wasted_tokens": self.speculative_wasted_tokens,
            "speculation_waste_frac": self.speculative_wasted_tokens
            / (produced + self.speculative_wasted_tokens),
            "slot_occupancy": self.window_slots_dispatched / (windows * self.cfg.max_slots),
            "window_size_counts": dict(self.window_size_counts),
            "aborted_requests": self.aborted_requests,
            "num_active": self.num_active,
            "num_pending": self.num_pending,
            "num_retiring": len(self._retiring),
            **({k: v for k, v in self.push_counters().items() if v is not None} if self._pushes_received else {}),
            **(self._paged_counters() if self.paged else self._slab_counters()),
        }

    def _slab_counters(self) -> dict:
        return {
            "prefill_extend_batches": self.prefill_extend_batches,
            "prefix_cache_hits": self.slab_prefix_hits,
            "prefix_cache_parked_slots": len(self._parked),
        }

    def _paged_counters(self) -> dict:
        out = {
            "kv_pages_free": self.block_pool.free_blocks,
            "kv_pages_total": self.block_pool.n_blocks,
            "prefill_extend_batches": self.prefill_extend_batches,
        }
        if self.prefix_cache is not None:
            out.update(
                prefix_cache_hits=self.prefix_cache.hits,
                prefix_cache_reused_tokens=self.prefix_cache.reused_tokens,
                prefix_cache_pages=self.prefix_cache.pages_held,
            )
        return out

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------
    def quiesced(self) -> ContextManager:
        """A context in which this engine launches nothing on the device: it
        waits for the step in flight, and the next waits for the context to
        end (the step profiler's trace starts and stops under it)."""
        return self._dispatch_lock

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.step():
                self._work_event.wait(timeout=0.005)
                self._work_event.clear()

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling iteration: weight swap, aborts, early retirement,
        admission, one decode window. A many-rank engine's rank 0 first
        broadcasts the step's inputs (and skips a step with nothing to do)."""
        with self._dispatch_lock:
            cmd = None
            if self._multi:
                cmd = self._tp_lead()
                if cmd is None:
                    return False
            did = self._step_body()
            if cmd is not None:
                self._tp_run_jobs(cmd)
        return did or cmd is not None

    def _step_body(self) -> bool:
        self._maybe_swap_params()
        aborted = self._process_aborts()
        self._retire_exhausted()
        admitted = self._admit()
        decoded = self._decode()
        return aborted or admitted or decoded

    def _tp_lead(self) -> dict | None:
        """Rank 0: this step's command (the requests submitted since the last
        step, the aborts, the version to swap in, the jobs), broadcast to the
        other ranks and applied here; None (and nothing sent) when the step
        would do nothing."""
        with self._queue_lock:
            reqs, self._inbox = self._inbox, []
            jobs, self._tp_jobs = self._tp_jobs, []
            aborts, self._tp_aborts = self._tp_aborts, set()
            queued = bool(self._queue)
        with self._params_lock:
            pending, self._pending_params = self._pending_params, None
            vision, self._pending_vision = self._pending_vision, None
            swap = pending if pending is not None and pending[1] >= self.version else None
        busy = queued or self._windows or any(s is not None for s in self._slots)
        if not (reqs or jobs or aborts or swap or busy):
            return None
        cmd = {"reqs": [(r.prompt_ids, r.params, r.request_id, r.visual) for r, _ in reqs],
               "aborts": sorted(aborts), "swap": None if swap is None else swap[1],
               "jobs": [(kind, args) for kind, args, _ in jobs]}
        tp_ranks.send_command(self.tp_world, cmd)
        self._queue.extend(reqs)
        self._abort_ids = aborts
        self._tp_swap = None if swap is None else (swap, vision)
        self._tp_futures = [f for _, _, f in jobs]
        return cmd

    def _tp_apply(self, cmd: dict) -> None:
        """A worker: the command's requests queued (futures no one reads),
        its aborts, and the staged push it swaps in."""
        for prompt_ids, params, request_id, visual in cmd["reqs"]:
            self._queue.append((GenRequest(prompt_ids, params, request_id, visual), tp_ranks.resolved_future()))
        self._abort_ids = set(cmd["aborts"])
        self._tp_swap = None
        if cmd["swap"] is not None:
            with self._params_lock:
                tree = self._tp_staged.pop(cmd["swap"])
                for v in [v for v in self._tp_staged if v < cmd["swap"]]:
                    del self._tp_staged[v]
            self._tp_swap = ((tree, cmd["swap"]), tree.pop("vision_tower", None))

    def _tp_run_jobs(self, cmd: dict) -> None:
        """After the step, on every rank: each job of the command; rank 0
        resolves their futures."""
        results = []
        for kind, args in cmd["jobs"]:
            if kind == "score":
                results.append(self._score(*args))
            else:
                results.append(tp_ranks.gather_to_rank0(self.tp_world, self._checksums()))
        if self.tp_world.rank == 0:
            for future, result in zip(self._tp_futures, results):
                future.set_result(result)

    def serve_tp_worker(self) -> None:
        """A many-rank engine's rank above 0: run rank 0's commands until it
        stops."""
        while True:
            cmd = tp_ranks.receive_command(self.tp_world)
            if cmd is None:
                # rank 0 stops the push receiver next: it must have left the
                # push group before the process leaves the world
                self._tp_receiver.join(timeout=60)
                return
            with torch.no_grad(), self._dispatch_lock:
                self._tp_apply(cmd)
                self._step_body()
                self._tp_run_jobs(cmd)

    def _maybe_swap_params(self) -> None:
        if self._multi:  # the command's swap, on every rank
            swap, self._tp_swap = self._tp_swap, None
            if swap is not None:
                (self.params, self.version), vision = swap
                if vision is not None:
                    self.vision_params = vision
                if self._published_at is not None:
                    self.last_push_timings["publish_to_swap_s"] = time.monotonic() - self._published_at
                    self._published_at = None
            return
        # a push that finished after a newer one was installed is dropped
        with self._params_lock:
            pending, self._pending_params = self._pending_params, None
            vision, self._pending_vision = self._pending_vision, None
            if pending is not None and pending[1] >= self.version:
                self.params, self.version = pending
                if vision is not None:
                    self.vision_params = vision
                if self._published_at is not None:
                    self.last_push_timings["publish_to_swap_s"] = time.monotonic() - self._published_at
                    self._published_at = None

    def _process_aborts(self) -> bool:
        with self._queue_lock:
            if not self._abort_ids:
                return False
            ids, self._abort_ids = self._abort_ids, set()
            kept: deque = deque()
            queued_hits = []
            for request, future in self._queue:
                (queued_hits if request.request_id in ids else kept).append((request, future))
            self._queue = kept
        did = False
        for request, future in queued_hits:
            self._notify(request, [], [], "abort")
            future.set_result(
                GenResult([], [], "abort", self.version, self.version, len(request.prompt_ids))
            )
            self.aborted_requests += 1
            did = True
        for i, s in enumerate(self._slots):
            if s is not None and s.request.request_id in ids:
                self._finish_slot(i, "abort")
                self.aborted_requests += 1
                did = True
        return did

    def _retire_exhausted(self) -> None:
        """Free slots whose remaining budget is already covered by
        dispatched windows. The occupant moves to the retiring registry and
        resolves when its last window is read back; the slot admits a new
        request that rides the very next window. Stop-token finishes stay on
        the read-back path (they cannot be predicted)."""
        if not self._windows:
            return
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            inflight = sum(w.n_steps for w in self._windows if w.active[i] and w.gens[i] == s.gen)
            if inflight == 0:
                continue
            projected = len(s.token_ids) + (1 if s.pending_first else 0) + inflight
            if projected < s.max_new_tokens:
                continue
            self._slots[i] = None
            self._retiring[(i, s.gen)] = s
            # registers or parks the committed tokens only, a true prefix of
            # the final transcript: in-flight windows write past it
            if self.paged:
                self._release_pages(i, s)
            else:
                self._maybe_park(i, s)

    def _release_pages(self, slot: int, state: _Slot) -> None:
        """Register the slot's transcript in the prefix cache, then drop its
        pages. Safe while windows are in flight: they hold the table as it
        was at dispatch, and every write to a page reallocated from here is
        queued on the engine's one stream after theirs.

        The final sampled token is left out, as the JAX slab engine's parked
        transcripts leave it out: no step may have fed it yet, so its K/V
        row can be unwritten (the JAX paged engine registers it; ROADMAP
        Queue 3)."""
        if self.prefix_cache is not None and state.token_ids and self._text_slot(slot, state):
            self.prefix_cache.register(
                state.request.prompt_ids + state.token_ids[:-1], self.block_pool.table[slot]
            )
        self.block_pool.release(slot)
        self._slot_capacity[slot] = 0

    def _reserve_tokens(self, request: GenRequest) -> int:
        """Tokens reserved at admission: the prompt, the request's own budget
        and one window of speculative overshoot."""
        n = len(request.prompt_ids)
        max_new = min(request.params.max_tokens, self.cfg.max_len - n)
        return min(n + max_new + max(1, self.cfg.decode_window), self.T_alloc)

    def _fit_pool(self, pairs: list[tuple]) -> list[tuple]:
        """FIFO fit check against the page pool: keep the longest prefix of
        ``pairs`` whose reservations fit (forks counted like primaries),
        evicting prefix-cache pages before giving up, and requeue the rest in
        order. Admission never runs out of pages mid-flight."""
        budget = self.block_pool.free_blocks
        fit = 0
        for request, _ in pairs:
            need = self.block_pool.blocks_for(self._reserve_tokens(request))
            if need > budget and self.prefix_cache is not None:
                before = self.block_pool.free_blocks
                self.prefix_cache.evict_for(before + (need - budget))
                budget += self.block_pool.free_blocks - before
            if need > budget:
                break
            budget -= need
            fit += 1
        if fit < len(pairs):
            with self._queue_lock:
                self._queue.extendleft(reversed(pairs[fit:]))
        return pairs[:fit]

    def _batches(self, group: list) -> list[list]:
        """``group`` cut into consecutive batches of 8/4/2/1."""
        out, pos = [], 0
        while pos < len(group):
            batch = next(
                b for b in (8, 4, 2, 1)
                if b == 1 or (b <= self.cfg.max_prefill_batch and pos + b <= len(group))
            )
            out.append(group[pos : pos + batch])
            pos += batch
        return out

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def _admit(self) -> bool:
        """Admit queued requests into free and parked slots (the JAX
        engine's ``_admit``). Identical prompts (the attempts of a GRPO
        group) prefill once and fork the KV to their siblings; prompts that
        extend a cached transcript (a paged prefix-cache hit, or a parked
        slab slot, which resumes in place) prefill only their tails, batched
        by (tail bucket, prefix bucket); the rest prefill together per
        bucket. Batches run 8/4/2/1."""
        parked = self._parked
        free_slots = [i for i, s in enumerate(self._slots) if s is None and i not in parked]
        if not free_slots and not parked:
            return False
        with self._queue_lock:
            # parked slots count as capacity: a hit resumes one in place, a
            # miss takes a free slot first, then evicts the least recently
            # parked one
            take = min(len(free_slots) + len(parked), len(self._queue))
            pairs = [self._queue.popleft() for _ in range(take)]
        if self.paged:
            pairs = self._fit_pool(pairs)
        if not pairs:
            return False

        def next_slot() -> int:
            return free_slots.pop(0) if free_slots else self._evict_parked()

        # a VLM request clusters on (prompt, image bytes): a GRPO group shares
        # one image, so its siblings still fork the KV
        clusters: dict[tuple, list[tuple]] = {}
        for pair in pairs:
            key: tuple = tuple(pair[0].prompt_ids)
            if pair[0].visual is not None:
                pix = np.ascontiguousarray(pair[0].visual["pixel_values"])
                key = key + ("#img", pix.shape, zlib.crc32(pix.tobytes()))
            clusters.setdefault(key, []).append(pair)
        by_bucket: dict[int, list] = {}
        extends: dict[tuple[int, int], list] = {}
        slab_extends: dict[tuple[int, int], list] = {}
        vlm_entries: list[tuple[int, list]] = []
        for members in clusters.values():
            request, future = members[0]
            n = len(request.prompt_ids)
            if request.visual is not None:
                entry = [next_slot(), request, future, members[1:], [next_slot() for _ in members[1:]]]
                vlm_entries.append((self._bucket(n), entry))
                continue
            hit = slab_hit = None
            if self.prefix_cache is not None:
                hit = self.prefix_cache.lookup(request.prompt_ids)
            elif not self.paged and self.cfg.prefix_cache:
                slab_hit = self._park_lookup(request.prompt_ids)
            primary = next_slot() if slab_hit is None else slab_hit[0]
            entry = [primary, request, future, members[1:], [next_slot() for _ in members[1:]]]
            if hit is not None:
                pages, n_prefix = hit
                page_bucket = 1 << (len(pages) - 1).bit_length()
                extends.setdefault((self._bucket(n - n_prefix), page_bucket), []).append((entry, n_prefix, pages))
            elif slab_hit is not None and slab_hit[1] + self._bucket(n - slab_hit[1]) <= self.T_alloc:
                n_prefix = slab_hit[1]
                key = (self._bucket(n - n_prefix), self._bucket(n_prefix))
                slab_extends.setdefault(key, []).append((entry, n_prefix))
            else:
                if slab_hit is not None:
                    # the padded tail would overrun the slot: a cold prefill
                    # in the parked slot, and no hit
                    self.slab_prefix_hits -= 1
                by_bucket.setdefault(self._bucket(n), []).append(entry)
        for (tail_bucket, page_bucket), group in extends.items():
            for batch in self._batches(group):
                self._prefill_extend(tail_bucket, page_bucket, batch)
        for (tail_bucket, pfx_bucket), group in slab_extends.items():
            for batch in self._batches(group):
                self._prefill_extend_slab(tail_bucket, pfx_bucket, batch)
        for bucket, entry in vlm_entries:
            self._prefill_vlm(bucket, entry)
        for bucket, group in by_bucket.items():
            for batch in self._batches(group):
                self._prefill_batch(bucket, batch)
        return True

    def _new_slot(self, slot: int, request: GenRequest, future: Future) -> None:
        max_new = min(request.params.max_tokens, self.cfg.max_len - len(request.prompt_ids))
        self._gen_counter += 1
        self._pos_delta[slot] = 0
        self._slots[slot] = _Slot(
            request=request, future=future, version_start=self.version,
            max_new_tokens=max_new, gen=self._gen_counter,
        )

    def _sampling_arrays(self, requests: list[GenRequest]):
        dev = self.device
        temps = torch.tensor([r.params.temperature for r in requests], dtype=torch.float32)
        top_p = torch.tensor([r.params.top_p for r in requests], dtype=torch.float32)
        top_k = torch.tensor([r.params.top_k for r in requests], dtype=torch.int64)
        return temps.to(dev), top_p.to(dev), top_k.to(dev)

    def _prefill_batch(self, bucket: int, group: list[list]) -> None:
        """One padded-batch prefill with no host sync: each row's first
        sampled token stays on the device until the next window's read-back.
        ``group`` rows are [slot, request, future, sibling_pairs,
        sibling_slots]; siblings are populated by a KV fork afterwards."""
        B = len(group)
        padded = np.zeros((B, bucket), np.int64)
        lengths = np.zeros(B, np.int64)
        for b, (_, request, _, _, _) in enumerate(group):
            n = len(request.prompt_ids)
            padded[b, :n] = request.prompt_ids
            lengths[b] = n
        slots = [row[0] for row in group]
        dev = self.device
        ids = torch.from_numpy(padded).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        if self.paged:
            # every page the request can touch, reserved up front
            # (_fit_pool made sure they are free)
            for slot, request, _, _, _ in group:
                reserve = self._reserve_tokens(request)
                self.block_pool.allocate(slot, reserve)
                self._slot_capacity[slot] = reserve
            table_rows = torch.from_numpy(self.block_pool.table[slots]).to(dev)
            last_logits = _prefill_paged_fn(
                self.params, self.model_cfg, self.attn_impl, self.k_pool, self.v_pool,
                self.cache_lens, ids, lens, slots_t, table_rows, tp=self.tp, pp=self.pp,
            )
        else:
            last_logits = _prefill_fn(
                self.params, self.model_cfg, self.attn_impl, self.k_cache, self.v_cache,
                self.cache_lens, ids, lens, slots_t, tp=self.tp, pp=self.pp,
            )
        self.prefill_batches += 1
        self._sample_first_tokens(last_logits, slots, [row[1] for row in group])
        for b, (slot, request, future, siblings, sibling_slots) in enumerate(group):
            self.total_prefill_tokens += len(request.prompt_ids)
            self._new_slot(slot, request, future)
            if siblings:
                self._fork_slots(slot, _row(last_logits, b), siblings, sibling_slots)

    def _prefill_vlm(self, bucket: int, entry: list) -> None:
        """Admit one VLM cluster (the JAX engine's ``_prefill_vlm``): the
        tower encodes the pixels at a bucketed patch count, the primary slot
        prefills one row with the visual tokens spliced at the placeholders
        and mrope positions (the pads after the prompt continue the rows),
        and identical siblings fork its KV."""
        slot, request, future, siblings, sibling_slots = entry
        vis, vcfg = request.visual, self.vision_cfg
        grid = np.asarray(vis["image_grid_thw"], np.int64).reshape(-1, 3)
        vin = prepare_vision_inputs(vis["pixel_values"], grid, vcfg, self.cfg.vision_unit_buckets)
        ids = request.prompt_ids
        n = len(ids)
        pos3, delta = mrope_positions(ids, grid, self.model_cfg.image_token_id, vcfg.spatial_merge_size,
                                      tokens_per_second=vcfg.tokens_per_second)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = ids
        pos_p = np.zeros((3, 1, bucket), np.int64)
        pos_p[:, 0, :n] = pos3
        pos_p[:, 0, n:] = pos3.max() + 1 + np.arange(bucket - n)
        dev = self.device
        input_ids = torch.from_numpy(padded).to(dev)
        lengths = torch.tensor([n], dtype=torch.int64, device=dev)
        slots_t = torch.tensor([slot], dtype=torch.int64, device=dev)
        vlm = dict(positions=torch.from_numpy(pos_p).to(dev), image_mask=input_ids == int(self.model_cfg.image_token_id),
                   vin=vision_inputs_to(vin, dev))
        if self.paged:
            reserve = self._reserve_tokens(request)
            self.block_pool.allocate(slot, reserve)
            self._slot_capacity[slot] = reserve
            last_logits = _prefill_vlm_paged_fn(
                self.params, self.model_cfg, self.attn_impl, self.vision_params, vcfg, self.k_pool, self.v_pool,
                self.cache_lens, input_ids, lengths, slots_t, torch.from_numpy(self.block_pool.table[[slot]]).to(dev),
                tp=self.tp, pp=self.pp, **vlm,
            )
        else:
            last_logits = _prefill_vlm_fn(
                self.params, self.model_cfg, self.attn_impl, self.vision_params, vcfg, self.k_cache, self.v_cache,
                self.cache_lens, input_ids, lengths, slots_t, tp=self.tp, pp=self.pp, **vlm,
            )
        self.prefill_batches += 1
        self._sample_first_tokens(last_logits, [slot], [request])
        self.total_prefill_tokens += n
        self._new_slot(slot, request, future)
        self._pos_delta[slot] = delta
        if siblings:
            self._fork_slots(slot, _row(last_logits, 0), siblings, sibling_slots)

    def _tail_arrays(self, tail_bucket: int, group: list[tuple]):
        """The padded tails [B, tail_bucket], tail lengths and prefix lengths
        of extend rows (entry, prefix tokens, ...), as tensors on the
        device."""
        B = len(group)
        tails = np.zeros((B, tail_bucket), np.int64)
        tail_lens = np.zeros(B, np.int64)
        prefix_lens = np.zeros(B, np.int64)
        for i, (entry, n_prefix, *_) in enumerate(group):
            tail = entry[1].prompt_ids[n_prefix:]
            tails[i, : len(tail)] = tail
            tail_lens[i] = len(tail)
            prefix_lens[i] = n_prefix
        dev = self.device
        return (torch.from_numpy(tails).to(dev), torch.from_numpy(tail_lens).to(dev),
                torch.from_numpy(prefix_lens).to(dev))

    def _start_extended(self, last_logits: torch.Tensor, group: list[tuple]) -> None:
        """Bookkeeping after an extend batch on either layout: first tokens,
        counters, the new occupants, and siblings forked off each primary."""
        self.prefill_batches += 1
        self.prefill_extend_batches += 1
        self._sample_first_tokens(last_logits, [row[0][0] for row in group], [row[0][1] for row in group])
        for b, ((slot, request, future, siblings, sibling_slots), n_prefix, *_) in enumerate(group):
            self.total_prefill_tokens += len(request.prompt_ids) - n_prefix
            self.prefill_reused_tokens += n_prefix
            self._new_slot(slot, request, future)
            if siblings:
                self._fork_slots(slot, _row(last_logits, b), siblings, sibling_slots)

    def _prefill_extend(self, tail_bucket: int, page_bucket: int, group: list[tuple]) -> None:
        """Admit clusters whose prompts extend cached transcripts, in one
        batch: attach each prefix's pages (refcount + 1), reserve the rest,
        and prefill only the tails against the gathered prefix K/V. Identical
        siblings fork off their primary afterwards. ``group`` rows are
        (entry, prefix tokens, prefix pages)."""
        prefix_pages = np.zeros((len(group), page_bucket), np.int64)
        slots = []
        for i, (entry, _, pages) in enumerate(group):
            slot, request = entry[0], entry[1]
            self.block_pool.attach(slot, pages)
            reserve = self._reserve_tokens(request)
            self.block_pool.extend(slot, reserve)
            self._slot_capacity[slot] = reserve
            # pad entries repeat a real page; prefix_lens masks them
            prefix_pages[i] = pages[-1]
            prefix_pages[i, : len(pages)] = pages
            slots.append(slot)
        dev = self.device
        last_logits = _prefill_extend_fn(
            self.params, self.model_cfg, self.attn_impl, self.k_pool, self.v_pool, self.cache_lens,
            *self._tail_arrays(tail_bucket, group), torch.tensor(slots, dtype=torch.int64, device=dev),
            torch.from_numpy(prefix_pages).to(dev), torch.from_numpy(self.block_pool.table[slots]).to(dev),
            tp=self.tp, pp=self.pp,
        )
        self._start_extended(last_logits, group)

    def _prefill_extend_slab(self, tail_bucket: int, pfx_bucket: int, group: list[tuple]) -> None:
        """Resume parked slab slots whose transcripts the prompts extend, in
        one batch (the JAX engine's ``_prefill_extend_slab``): the tails run
        against each slot's first ``pfx_bucket`` cached rows and their K/V
        is written at the prefix length. Identical siblings fork off the
        resumed slot afterwards. ``group`` rows are (entry, prefix tokens)."""
        slots = torch.tensor([entry[0] for entry, _ in group], dtype=torch.int64, device=self.device)
        last_logits = _prefill_extend_slab_fn(
            self.params, self.model_cfg, self.attn_impl, pfx_bucket, self.k_cache, self.v_cache,
            self.cache_lens, *self._tail_arrays(tail_bucket, group), slots, tp=self.tp, pp=self.pp,
        )
        self._start_extended(last_logits, group)

    def _sample_first_tokens(self, logits: torch.Tensor | None, slots: list[int], requests) -> None:
        """Sample each prefilled row's first token on the device into
        ``first_info``; at pp above 1 the last stage samples (the stages
        before it pass no ``logits``) and every rank receives its draws."""
        tokens = logprobs = None
        if logits is not None:
            temps, top_p, top_k = self._sampling_arrays(requests)
            tokens, logprobs = sample_masked(logits, self._generator, temps, top_p, top_k)
        if self.pp is not None:
            tokens, logprobs = tp_ranks.share_sampled(self.pp, tokens, logprobs, len(slots), self.device)
        idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        self.first_info[idx] = torch.stack(
            [tokens.to(torch.int32), logprobs.float().view(torch.int32)], dim=-1
        )

    def _fork_slots(
        self,
        src_slot: int,
        logits_row: torch.Tensor | None,  # [V] — the source's prefill last-token logits (None before the last stage)
        siblings: list[tuple[GenRequest, Future]],
        dst_slots: list[int],
    ) -> None:
        """Populate ``dst_slots`` from ``src_slot``'s fresh prefill with an
        independent first-token sample each, and no second prefill of the
        shared prompt. Slab: one KV row copy each. Paged: the prompt's full
        pages are shared by refcount and only a partial tail page is copied;
        each sibling reserves its own decode pages (_fit_pool counted them)."""
        if self.paged:
            n_prompt = len(siblings[0][0].prompt_ids)
            tail_pages = []
            for (request, _), dst in zip(siblings, dst_slots):
                tail, _ = self.block_pool.fork(src_slot, dst, n_prompt)
                reserve = self._reserve_tokens(request)
                self.block_pool.extend(dst, reserve)
                self._slot_capacity[dst] = reserve
                tail_pages.extend(int(p) for p in tail)
            if tail_pages:
                src_tail = int(self.block_pool.table[src_slot, n_prompt // self.cfg.kv_block_size])
                _copy_pages_fn(self.k_pool, self.v_pool, src_tail, tail_pages)
        else:
            _fork_fn(self.k_cache, self.v_cache, src_slot, dst_slots)
        idx = torch.tensor(dst_slots, dtype=torch.int64, device=self.device)
        self.cache_lens[idx] = self.cache_lens[src_slot].clone()
        F = len(dst_slots)
        self._sample_first_tokens(
            None if logits_row is None else logits_row[None].expand(F, -1), dst_slots, [r for r, _ in siblings]
        )
        for (request, future), slot in zip(siblings, dst_slots):
            self.prefill_reused_tokens += len(request.prompt_ids)
            self._new_slot(slot, request, future)
            self._pos_delta[slot] = self._pos_delta[src_slot]

    def _stop_tokens(self, p: SamplingParams) -> tuple[int, ...]:
        return (self.eos_token_id,) + tuple(p.stop_token_ids)

    def _maybe_finish(self, slot: int, token: int) -> None:
        state = self._slots[slot]
        if token in self._stop_tokens(state.request.params):
            self._finish_slot(slot, "stop")
        elif len(state.token_ids) >= state.max_new_tokens:
            self._finish_slot(slot, "length")

    @staticmethod
    def _notify(request: GenRequest, tokens: list[int], logprobs: list[float], finish) -> None:
        """Call a request's stream callback; its exceptions are logged and
        never reach the scheduling loop."""
        cb = request.stream_callback
        if cb is None:
            return
        try:
            cb(tokens, logprobs, finish)
        except Exception:  # noqa: BLE001 — a user callback must not kill the loop
            logger.exception("stream callback failed for %s", request.request_id)

    def _maybe_park(self, slot: int, state: _Slot) -> None:
        """Park a finished slab slot (the JAX engine's ``_maybe_park``): its
        K/V rows stay in place and its transcript is remembered, so that the
        conversation's next turn resumes the slot and prefills only its
        tail. The transcript leaves out the final sampled token: a token's
        K/V row is written only when a later step feeds it, and the last one
        may never be fed (a stop, a budget that ends on a window's last
        step, an abort). Windows still in flight for the old occupant write
        only past the parked rows, and they are queued on the engine's one
        stream before any extend that resumes the slot."""
        if not self.cfg.prefix_cache or not self._text_slot(slot, state):
            return
        transcript = state.request.prompt_ids + state.token_ids[:-1]
        if not self.cfg.slab_prefix_min_tokens <= len(transcript) < self.cfg.max_len:
            return
        self._park_stamp += 1
        state.park_stamp = self._park_stamp
        self._parked[slot] = (transcript, self._park_stamp)

    def _text_slot(self, slot: int, state: _Slot) -> bool:
        """Whether a slot's transcript is text alone: a VLM transcript's KV
        depends on its pixels, so it is never parked or cached."""
        return state.request.visual is None and self._pos_delta[slot] == 0

    def _park_lookup(self, prompt_ids: list[int]) -> tuple[int, int] | None:
        """The longest parked transcript of at least
        ``slab_prefix_min_tokens`` that is a proper prefix of the prompt, as
        (slot, its length); the hit leaves the parked set (the JAX engine's
        ``_park_lookup``)."""
        best_slot, best_len = -1, 0
        n = len(prompt_ids)
        for slot, (transcript, _) in self._parked.items():
            t = len(transcript)
            if t >= n or t <= best_len or t < self.cfg.slab_prefix_min_tokens:
                continue
            if transcript == prompt_ids[:t]:
                best_slot, best_len = slot, t
        if best_slot < 0:
            return None
        del self._parked[best_slot]
        self.slab_prefix_hits += 1
        return best_slot, best_len

    def _evict_parked(self) -> int:
        """Free the least recently parked slot, its K/V abandoned (the JAX
        engine's ``_evict_parked``)."""
        slot = min(self._parked, key=lambda s: self._parked[s][1])
        del self._parked[slot]
        return slot

    def _finish_slot(self, slot: int, finish: str) -> None:
        state = self._slots[slot]
        self._slots[slot] = None
        if self.paged:
            self._release_pages(slot, state)
        else:
            self._maybe_park(slot, state)
        self._resolve(state, finish)

    def _resolve(self, state: _Slot, finish: str) -> None:
        self._notify(state.request, [], [], finish)
        state.future.set_result(
            GenResult(
                token_ids=state.token_ids,
                logprobs=state.logprobs,
                finish_reason=finish,
                model_version_start=state.version_start,
                model_version_end=self.version,
                prompt_tokens=len(state.request.prompt_ids),
            )
        )

    def _resolve_retired(self, key: tuple[int, int], state: _Slot, finish: str) -> None:
        """Resolve an early-retired occupant at its last window's read-back
        (its slot was freed at retire time). A slab park entry made at
        retirement, which holds the committed transcript, grows to the full
        one less its final token if it is still this occupant's: the slot
        may have been resumed, evicted or parked again meanwhile."""
        self._retiring.pop(key, None)
        parked = self._parked.get(key[0])
        if state.park_stamp >= 0 and parked is not None and parked[1] == state.park_stamp:
            full = state.request.prompt_ids + state.token_ids[:-1]
            if self.cfg.slab_prefix_min_tokens <= len(full) < self.cfg.max_len:
                self._parked[key[0]] = (full, parked[1])
        self._resolve(state, finish)

    def _decode(self) -> bool:
        """Dispatch one decode window, and read back the oldest once the
        pipeline is full. A request's tokens reach its future (depth - 1)
        windows after dispatch."""
        S = self.cfg.max_slots
        active = np.zeros(S, np.bool_)
        gens = np.zeros(S, np.int64)
        pending: list[int] = []
        fresh: list[int] = []
        remainings: list[int] = []
        requests: list[GenRequest] = []
        for i, s in enumerate(self._slots):
            if s is None:
                requests.append(None)
                continue
            active[i] = True
            gens[i] = s.gen
            if s.pending_first:
                pending.append(i)
            if not s.first_dispatched:
                fresh.append(i)
                s.first_dispatched = True
            # a pending first token spends one budget unit before any of
            # this window's steps land
            remainings.append(s.max_new_tokens - len(s.token_ids) - (1 if s.pending_first else 0))
            requests.append(s.request)
        if not active.any():
            did = bool(self._windows)
            while self._windows:
                self._process_window(self._windows.popleft())
            return did

        window = self._window_sizes[-1]
        if len(self._window_sizes) > 1:
            med = sorted(remainings)[len(remainings) // 2]
            if med < window:
                window = next(w for w in self._window_sizes if w >= med)
        idle = SamplingParams()
        params = [r.params if r is not None else idle for r in requests]
        dev = self.device
        temperature = torch.tensor([p.temperature for p in params], dtype=torch.float32).to(dev)
        masked = any(p.needs_masking for p in params)
        top_p = top_k = None
        if masked:
            top_p = torch.tensor([p.top_p for p in params], dtype=torch.float32).to(dev)
            top_k = torch.tensor([p.top_k for p in params], dtype=torch.int64).to(dev)
        pending_mask = np.zeros(S, np.bool_)
        pending_mask[fresh] = True
        window_args = (
            self.cache_lens, self._device_tokens, torch.from_numpy(active).to(dev),
            torch.from_numpy(pending_mask).to(dev), self.first_info, self._generator,
            temperature, top_p, top_k, torch.from_numpy(self._pos_delta.copy()).to(dev),
        )
        if self.paged:
            # the table snapshot, sliced to the power-of-two bucket of the
            # most pages any active slot holds: attention and the "xla"
            # route's gather view cover the active working set, not MAXB.
            # Copied before the transfer: the live table changes on release
            # while this window is still queued.
            most = max(1, int(self.block_pool.slot_blocks[active].max()))
            width = min(1 << (most - 1).bit_length(), self.block_pool.max_blocks_per_slot)
            table = torch.from_numpy(self.block_pool.table[:, :width].copy()).to(dev)
            capacity = torch.from_numpy(self._slot_capacity.astype(np.int32)).to(dev)
            packed, self._device_tokens = _decode_window_paged_fn(
                self.params, self.model_cfg, self.decode_attn_impl, window,
                self.k_pool, self.v_pool, table, capacity, *window_args, tp=self.tp, pp=self.pp,
            )
        else:
            packed, self._device_tokens = _decode_window_fn(
                self.params, self.model_cfg, self.decode_attn_impl, window, self.cfg.max_len,
                self.k_cache, self.v_cache, *window_args, tp=self.tp, pp=self.pp,
            )
        self.windows_dispatched += 1
        self.window_slots_dispatched += int(active.sum())
        self.window_size_counts[window] = self.window_size_counts.get(window, 0) + 1
        self._windows.append(_Window(packed, active, gens, pending, n_steps=window))
        while len(self._windows) >= max(1, self.cfg.window_pipeline_depth):
            self._process_window(self._windows.popleft())
        return True

    def _process_window(self, w: _Window) -> None:
        packed = w.packed.cpu().numpy()  # the one device-to-host read per window
        self._window_times.append(time.monotonic())
        self.window_digest = zlib.crc32(packed.tobytes(), self.window_digest)
        win_tokens = packed[0, 1:]  # [N, S]
        win_logprobs = packed[1, 1:].view(np.float32)
        first_tokens = packed[0, 0]
        first_logprobs = packed[1, 0].view(np.float32)
        n_steps = win_tokens.shape[0]
        self.decode_steps += n_steps
        for i in w.pending:
            key = (i, int(w.gens[i]))
            s = self._slots[i]
            if s is None or s.gen != w.gens[i]:
                s = self._retiring.get(key)
            if s is None or not s.pending_first:
                continue
            s.pending_first = False
            token, lp = int(first_tokens[i]), float(first_logprobs[i])
            s.token_ids.append(token)
            s.logprobs.append(lp)
            self.total_generated_tokens += 1
            self._notify(s.request, [token], [lp], None)
            if self._slots[i] is s:
                self._maybe_finish(i, token)
            elif token in self._stop_tokens(s.request.params):
                self._resolve_retired(key, s, "stop")
            elif len(s.token_ids) >= s.max_new_tokens:
                self._resolve_retired(key, s, "length")
        for i in np.flatnonzero(w.active):
            key = (int(i), int(w.gens[i]))
            s = self._slots[i]
            retired = False
            if s is None or s.gen != w.gens[i]:
                s = self._retiring.get(key)
                retired = s is not None
            if s is None:
                # the occupant finished or was aborted before this read-back:
                # all it decoded here was speculation
                self.speculative_wasted_tokens += n_steps
                continue
            col = win_tokens[:, i]
            stop_hits = np.flatnonzero(np.isin(col, self._stop_tokens(s.request.params)))
            budget = s.max_new_tokens - len(s.token_ids)
            finish = None
            cut = n_steps
            if stop_hits.size and int(stop_hits[0]) + 1 <= budget:
                cut = int(stop_hits[0]) + 1  # stop token included
                finish = "stop"
            elif budget <= n_steps:
                cut = budget
                finish = "length"
            if cut > 0:
                chunk = col[:cut].tolist()
                chunk_lps = win_logprobs[:cut, i].tolist()
                s.token_ids.extend(chunk)
                s.logprobs.extend(chunk_lps)
                self.total_generated_tokens += cut
                self._notify(s.request, chunk, chunk_lps, None)
            if finish is not None:
                self.speculative_wasted_tokens += n_steps - cut
                if retired:
                    self._resolve_retired(key, s, finish)
                else:
                    self._finish_slot(int(i), finish)


# ---------------------------------------------------------------------------
# device step functions (engine state passed explicitly, updated in place)
# ---------------------------------------------------------------------------


def _row(logits: torch.Tensor | None, b: int) -> torch.Tensor | None:
    return None if logits is None else logits[b]


def _stage_in(pp, model_cfg: ModelConfig, shape: tuple, device) -> torch.Tensor | None:
    """The previous pipeline stage's hidden state of ``shape`` + [D], or
    None on the first stage (and on one rank): it embeds."""
    if pp is None or pp.first:
        return None
    return tp_ranks.recv_hidden(pp, (*shape, model_cfg.hidden_size), model_cfg.dtype, device)


def _stage_out(pp, out: torch.Tensor) -> torch.Tensor | None:
    """A stage's output: the logits (or normed hidden) of the last stage,
    as they are; before it, the hidden state goes to the next stage and
    None comes back."""
    if pp is None or pp.last:
        return out
    tp_ranks.send_hidden(pp, out)
    return None


def _merge_staged(
    cache: torch.Tensor,  # [L, S, T_alloc, K, Dh], updated in place
    staged: torch.Tensor,  # [L, W, S, K, Dh]
    base_lens: torch.Tensor,  # [S]
) -> None:
    """Write each slot's staged band at its base length: one indexed copy
    per window. T_alloc = capacity + W keeps every write in bounds."""
    S, T_alloc = cache.shape[1], cache.shape[2]
    W = staged.shape[1]
    dev = cache.device
    starts = base_lens.to(torch.int64).clamp(max=T_alloc - W)
    t_idx = starts[:, None] + torch.arange(W, device=dev)[None, :]  # [S, W]
    s_idx = torch.arange(S, device=dev)[:, None]
    cache[:, s_idx, t_idx] = staged.permute(0, 2, 1, 3, 4)


def _decode_steps(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl,
    n_steps: int,
    cache_k: torch.Tensor,  # [L, S, T, K, Dh] frozen cache, or [L, NB, BT, K, Dh] pool
    cache_v: torch.Tensor,
    base_lens: torch.Tensor,  # [S]
    max_position: int,
    tokens: torch.Tensor,  # [S] — the tokens to feed at step 0
    active: torch.Tensor,  # [S] bool
    generator: torch.Generator,
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor | None,  # [S]; None: no top-p/top-k in this window
    top_k: torch.Tensor | None,
    pos_delta: torch.Tensor,  # [S] mrope decode offset (0 for text slots)
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
):
    """``n_steps`` decode steps with no host read: each sampled token feeds
    the next step on the device, and new K/V go to a [L, W, S, K, Dh] band.
    A VLM slot's rope position is its cache index plus ``pos_delta`` (its
    three mrope rows are equal past the prompt, so the 1D rope serves).
    Under ``tp`` the ranks' logits are gathered before the sampler, so every
    rank samples the same tokens. Under ``pp`` each step runs stage by
    stage, the last samples, and its tokens reach every rank.
    Returns (k_staged, v_staged, tokens [N, S], logprobs [N, S], carry)."""
    L, S = cache_k.shape[0], tokens.shape[0]
    K, Dh = cache_k.shape[-2:]
    k_staged = torch.zeros((L, n_steps, S, K, Dh), dtype=cache_k.dtype, device=cache_k.device)
    v_staged = torch.zeros_like(k_staged)
    win_tokens, win_logprobs = [], []
    for step in range(n_steps):
        positions = (base_lens + step).clamp(max=max_position) + pos_delta
        out, k_new, v_new = decode_step_staged(
            params, model_cfg, tokens, positions, cache_k, cache_v,
            base_lens, k_staged, v_staged, step, attn_impl=attn_impl, tp=tp,
            hidden_in=_stage_in(pp, model_cfg, (S,), tokens.device), last_stage=pp is None or pp.last,
        )
        k_staged[:, step] = k_new
        v_staged[:, step] = v_new
        logits = _stage_out(pp, out)
        new_tokens = logprobs = None
        if logits is not None:
            logits = gather_vocab(logits, tp)
            if top_p is not None:
                new_tokens, logprobs = sample_masked(logits, generator, temperature, top_p, top_k)
            else:
                new_tokens, logprobs = sample_fast(logits, generator, temperature)
        if pp is not None:
            new_tokens, logprobs = tp_ranks.share_sampled(pp, new_tokens, logprobs, S, tokens.device)
        tokens = torch.where(active, new_tokens, tokens)
        win_tokens.append(tokens)
        win_logprobs.append(logprobs)
    return k_staged, v_staged, torch.stack(win_tokens), torch.stack(win_logprobs), tokens


def _pack_window(first_info: torch.Tensor, win_tokens: torch.Tensor, win_logprobs: torch.Tensor):
    """The int32 [2, N+1, S] window output: row 0 the prefill first-token
    info, rows 1..N the window's tokens and bitcast fp32 logprobs."""
    lp_bits = win_logprobs.float().view(torch.int32)
    tok_rows = torch.cat([first_info[None, :, 0], win_tokens.to(torch.int32)])
    lp_rows = torch.cat([first_info[None, :, 1], lp_bits])
    return torch.stack([tok_rows, lp_rows])


def _decode_window_fn(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl: str,
    n_steps: int,
    capacity: int,  # slab token capacity (T_alloc = capacity + max window)
    k_cache: torch.Tensor,  # [L, S, T_alloc, K, Dh], updated in place
    v_cache: torch.Tensor,
    cache_lens: torch.Tensor,  # [S] int32, updated in place
    tokens: torch.Tensor,  # [S] — device carry of the last sampled tokens
    active: torch.Tensor,  # [S] bool
    pending_mask: torch.Tensor,  # [S] bool — slots whose last token is first_info's
    first_info: torch.Tensor,  # [S, 2] int32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor | None,  # [S]; None: no top-p/top-k in this window
    top_k: torch.Tensor | None,
    pos_delta: torch.Tensor,  # [S]
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
):
    """A slab decode window: ``_decode_steps`` over the frozen cache, then
    the band merges into the cache once. Returns the packed window output
    and the new token carry."""
    T_alloc = k_cache.shape[2]
    tokens = torch.where(pending_mask, first_info[:, 0].to(torch.int64), tokens)
    base_lens = cache_lens.clone()  # frozen for the whole window
    k_staged, v_staged, win_tokens, win_logprobs, tokens = _decode_steps(
        params, model_cfg, attn_impl, n_steps, k_cache, v_cache, base_lens, T_alloc - 1,
        tokens, active, generator, temperature, top_p, top_k, pos_delta, tp, pp,
    )
    _merge_staged(k_cache, k_staged, base_lens)
    _merge_staged(v_cache, v_staged, base_lens)
    cache_lens.copy_(torch.where(active, (base_lens + n_steps).clamp(max=capacity - 1), base_lens))
    return _pack_window(first_info, win_tokens, win_logprobs), tokens


def _decode_window_paged_fn(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl: str,  # "xla" | "ragged"
    n_steps: int,
    k_pool: torch.Tensor,  # [L, NB, BT, K, Dh], updated in place
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [S, MAXB] int32 — host snapshot at dispatch
    capacity: torch.Tensor,  # [S] int32 — tokens reserved per slot
    cache_lens: torch.Tensor,  # [S] int32, updated in place
    tokens: torch.Tensor,
    active: torch.Tensor,
    pending_mask: torch.Tensor,
    first_info: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_p: torch.Tensor | None,
    top_k: torch.Tensor | None,
    pos_delta: torch.Tensor,  # [S]
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
):
    """A paged decode window. "ragged" runs kernel #5 through the table at
    every step; "xla" gathers each slot's pages once per window into a
    contiguous view (the pool is frozen for the window, so the gather is
    loop-invariant) and runs the plain staged attention over it. The band
    then appends through the table; inactive slots append nothing, since
    their table rows may already be released. Lengths clamp at each slot's
    reserved capacity - 1."""
    BT = k_pool.shape[2]
    MAXB = block_table.shape[1]
    tokens = torch.where(pending_mask, first_info[:, 0].to(torch.int64), tokens)
    base_lens = cache_lens.clone()
    if attn_impl == "ragged":

        def attn(q, k, v, kc, vc, lens, ks, vs, step):
            return paged_decode_attention(q, k, v, kc, vc, block_table, lens, ks, vs, step)

        cache_k, cache_v = k_pool, v_pool
    elif attn_impl == "xla":
        attn = "xla"
        cache_k, cache_v = gather_pages(k_pool, block_table), gather_pages(v_pool, block_table)
    else:
        raise ValueError(f"unknown attention implementation {attn_impl!r}")
    k_staged, v_staged, win_tokens, win_logprobs, tokens = _decode_steps(
        params, model_cfg, attn, n_steps, cache_k, cache_v, base_lens, MAXB * BT - 1,
        tokens, active, generator, temperature, top_p, top_k, pos_delta, tp, pp,
    )
    count = torch.where(active, n_steps, 0)
    paged_append(k_pool, k_staged.transpose(1, 2), block_table, base_lens, count)
    paged_append(v_pool, v_staged.transpose(1, 2), block_table, base_lens, count)
    cache_lens.copy_(torch.where(active, torch.minimum(base_lens + n_steps, capacity - 1), base_lens))
    return _pack_window(first_info, win_tokens, win_logprobs), tokens


def _prefill_forward(params, model_cfg, attn_impl, input_ids, lengths, positions=None, image_embeds=None,
                     image_mask=None, tp=None, pp=None):
    """Forward over B padded prompts (``positions`` default to 0..P-1; a VLM
    row passes its ``[3, 1, P]`` mrope rows and spliced visual tokens).
    Returns (fp32 logits [B, V] of each row's last prompt token, k [L, B, P,
    K, Dh], v): the lm_head runs at one position per row, not over the
    whole bucket. Under ``pp``: this stage's layers' K/V, and the logits on
    the last stage only (None before it)."""
    B, P = input_ids.shape
    if positions is None:
        positions = torch.arange(P, device=input_ids.device)[None, :].expand(B, P)
    segments = torch.zeros((B, P), dtype=torch.int32, device=input_ids.device)
    out, (k_new, v_new) = forward(
        params, model_cfg, input_ids, positions, segments, return_kv=True,
        attn_impl=attn_impl, skip_unembed=True, image_embeds=image_embeds, image_mask=image_mask, tp=tp,
        hidden_in=_stage_in(pp, model_cfg, (B, P), input_ids.device), last_stage=pp is None or pp.last,
    )
    return _last_logits(params, model_cfg, _stage_out(pp, out), lengths, tp), k_new, v_new


def _last_logits(params, model_cfg, normed, lengths, tp=None):
    """The whole vocabulary's fp32 logits [B, V] at each row's last token
    (gathered over tp); None for a stage before the last (``normed``
    None)."""
    if normed is None:
        return None
    last = normed[torch.arange(normed.shape[0], device=normed.device), lengths - 1]  # [B, D]
    return gather_vocab(lm_head_logits(params, model_cfg, last, tp), tp)


def _prefill_fn(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl: str,
    k_cache: torch.Tensor,  # [L, S, T_alloc, K, Dh], updated in place
    v_cache: torch.Tensor,
    cache_lens: torch.Tensor,  # [S], updated in place
    input_ids: torch.Tensor,  # [B, P] padded bucket
    lengths: torch.Tensor,  # [B] true prompt lengths
    slots: torch.Tensor,  # [B]
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
    **vlm,  # positions, image_embeds, image_mask of a VLM row
) -> torch.Tensor | None:
    """Prefill B padded prompts into their slots' cache prefixes. Returns the
    fp32 logits [B, V] of each row's last prompt token (None before the
    last pipeline stage)."""
    last_logits, k_new, v_new = _prefill_forward(params, model_cfg, attn_impl, input_ids, lengths, tp=tp, pp=pp,
                                                 **vlm)
    P = input_ids.shape[1]
    k_cache[:, slots, :P] = k_new.to(k_cache.dtype)
    v_cache[:, slots, :P] = v_new.to(v_cache.dtype)
    cache_lens[slots] = lengths.to(torch.int32)
    return last_logits


def _prefill_paged_fn(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl: str,
    k_pool: torch.Tensor,  # [L, NB, BT, K, Dh], updated in place
    v_pool: torch.Tensor,
    cache_lens: torch.Tensor,  # [S], updated in place
    input_ids: torch.Tensor,  # [B, P]
    lengths: torch.Tensor,  # [B]
    slots: torch.Tensor,  # [B]
    table_rows: torch.Tensor,  # [B, MAXB] — the rows' freshly allocated pages
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
    **vlm,  # positions, image_embeds, image_mask of a VLM row
) -> torch.Tensor | None:
    """Paged prefill: the forward of ``_prefill_fn``, then each row's prompt
    K/V appended into its pages (pad rows dropped by ``count``)."""
    last_logits, k_new, v_new = _prefill_forward(params, model_cfg, attn_impl, input_ids, lengths, tp=tp, pp=pp,
                                                 **vlm)
    zero = torch.zeros_like(lengths)
    paged_append(k_pool, k_new, table_rows, zero, lengths)
    paged_append(v_pool, v_new, table_rows, zero, lengths)
    cache_lens[slots] = lengths.to(torch.int32)
    return last_logits


def _vision_embeds(vision_params, vision_cfg, vin, pp) -> torch.Tensor | None:
    """The tower's merged tokens [1, M, D] on the first pipeline stage,
    which splices them; None on the later stages."""
    if pp is not None and not pp.first:
        return None
    return vision_forward(vision_params, vision_cfg, **vin)[None]


def _prefill_vlm_fn(params, model_cfg, attn_impl, vision_params, vision_cfg, k_cache, v_cache, cache_lens,
                    input_ids, lengths, slots, positions, image_mask, vin, tp=None, pp=None) -> torch.Tensor | None:
    """One-row VLM prefill into the slab (the JAX ``_prefill_vlm_fn``): the
    tower encodes the bucketed patches ``vin``, its merged tokens are
    spliced at ``image_mask`` ([1, P]), and the row runs with mrope
    ``positions`` ([3, 1, P]). Returns the last-token fp32 logits [1, V]."""
    embeds = _vision_embeds(vision_params, vision_cfg, vin, pp)
    return _prefill_fn(params, model_cfg, attn_impl, k_cache, v_cache, cache_lens, input_ids, lengths, slots, tp, pp,
                       positions=positions, image_embeds=embeds, image_mask=image_mask)


def _prefill_vlm_paged_fn(params, model_cfg, attn_impl, vision_params, vision_cfg, k_pool, v_pool, cache_lens,
                          input_ids, lengths, slots, table_rows, positions, image_mask, vin, tp=None,
                          pp=None) -> torch.Tensor | None:
    """``_prefill_vlm_fn`` into the paged pool (the JAX
    ``_prefill_vlm_paged_fn``)."""
    embeds = _vision_embeds(vision_params, vision_cfg, vin, pp)
    return _prefill_paged_fn(params, model_cfg, attn_impl, k_pool, v_pool, cache_lens, input_ids, lengths, slots,
                             table_rows, tp, pp, positions=positions, image_embeds=embeds, image_mask=image_mask)


def _prefill_extend_fn(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl: str,
    k_pool: torch.Tensor,  # [L, NB, BT, K, Dh], updated in place
    v_pool: torch.Tensor,
    cache_lens: torch.Tensor,  # [S], updated in place
    tail_ids: torch.Tensor,  # [B, Tb] — prompt tokens past the cached prefixes
    tail_lens: torch.Tensor,  # [B]
    prefix_lens: torch.Tensor,  # [B] — tokens covered by each row's prefix pages
    slots: torch.Tensor,  # [B]
    prefix_pages: torch.Tensor,  # [B, n_pages] physical page ids (pad = repeat)
    table_rows: torch.Tensor,  # [B, MAXB] — each slot's full table (for the append)
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
) -> torch.Tensor | None:
    """Prefill of B tails against their cached prefix pages: gather the
    prefixes, run ``forward_extend`` over [prefix | tail], append the tail
    K/V at ``prefix_lens``. Returns the fp32 last-token logits [B, V]."""
    k_pre, v_pre = gather_pages(k_pool, prefix_pages), gather_pages(v_pool, prefix_pages)
    positions = prefix_lens[:, None] + torch.arange(tail_ids.shape[1], device=tail_ids.device)[None, :]
    out, (k_new, v_new) = forward_extend(
        params, model_cfg, tail_ids, positions, k_pre, v_pre, prefix_lens,
        attn_impl=attn_impl, skip_unembed=True, tp=tp,
        hidden_in=_stage_in(pp, model_cfg, tuple(tail_ids.shape), tail_ids.device), last_stage=pp is None or pp.last,
    )
    paged_append(k_pool, k_new, table_rows, prefix_lens, tail_lens)
    paged_append(v_pool, v_new, table_rows, prefix_lens, tail_lens)
    cache_lens[slots] = (prefix_lens + tail_lens).to(torch.int32)
    return _last_logits(params, model_cfg, _stage_out(pp, out), tail_lens, tp)


def _prefill_extend_slab_fn(
    params: dict,
    model_cfg: ModelConfig,
    attn_impl: str,
    pfx_bucket: int,  # cached rows gathered per slot
    k_cache: torch.Tensor,  # [L, S, T_alloc, K, Dh], updated in place
    v_cache: torch.Tensor,
    cache_lens: torch.Tensor,  # [S], updated in place
    tail_ids: torch.Tensor,  # [B, Tb] — prompt tokens past the parked transcripts
    tail_lens: torch.Tensor,  # [B]
    prefix_lens: torch.Tensor,  # [B] — parked transcript lengths (<= pfx_bucket)
    slots: torch.Tensor,  # [B]
    tp: TP | None = None,
    pp: tp_ranks.EngineWorld | None = None,
) -> torch.Tensor | None:
    """Prefill of B tails against their parked slab slots (the JAX
    ``_prefill_extend_slab_fn``): gather each slot's first ``pfx_bucket``
    rows, run ``forward_extend`` over [prefix | tail] (the rows past the
    prefix length are masked as its pad), and write the tail K/V at
    ``prefix_lens``. The tail's pad rows land at positions >= the new cache
    length, where decode writes before any read. Returns the fp32
    last-token logits [B, V]."""
    k_pre, v_pre = k_cache[:, slots, :pfx_bucket], v_cache[:, slots, :pfx_bucket]
    Tb = tail_ids.shape[1]
    positions = prefix_lens[:, None] + torch.arange(Tb, device=tail_ids.device)[None, :]
    out, (k_new, v_new) = forward_extend(
        params, model_cfg, tail_ids, positions, k_pre, v_pre, prefix_lens,
        attn_impl=attn_impl, skip_unembed=True, tp=tp,
        hidden_in=_stage_in(pp, model_cfg, tuple(tail_ids.shape), tail_ids.device), last_stage=pp is None or pp.last,
    )
    k_cache[:, slots[:, None], positions] = k_new.to(k_cache.dtype)
    v_cache[:, slots[:, None], positions] = v_new.to(v_cache.dtype)
    cache_lens[slots] = (prefix_lens + tail_lens).to(torch.int32)
    return _last_logits(params, model_cfg, _stage_out(pp, out), tail_lens, tp)


def _score_fn(params: dict, model_cfg: ModelConfig, attn_impl: str, input_ids: torch.Tensor, temperature: float,
              tp: TP | None = None, pp: tp_ranks.EngineWorld | None = None):
    """fp32 logprobs [1, P - 1] of ``input_ids[:, 1:]`` from one packed
    forward over the padded row (the JAX ``_score_fn``); under ``pp`` the
    row runs stage by stage and the last stage's logprobs reach every
    rank."""
    P = input_ids.shape[1]
    positions = torch.arange(P, device=input_ids.device)[None, :]
    segments = torch.zeros((1, P), dtype=torch.int32, device=input_ids.device)
    out = forward(params, model_cfg, input_ids, positions, segments, attn_impl=attn_impl, tp=tp,
                  hidden_in=_stage_in(pp, model_cfg, (1, P), input_ids.device), last_stage=pp is None or pp.last)
    logits = _stage_out(pp, out)
    lp = None if logits is None else token_logprobs_from_logits(gather_vocab(logits, tp), input_ids, temperature)
    if pp is not None:
        lp = tp_ranks.share_from_last(pp, None if lp is None else lp.float(), (1, P - 1), torch.float32,
                                      input_ids.device)
    return lp


def _fork_fn(
    k_cache: torch.Tensor,  # [L, S, T_alloc, K, Dh], updated in place
    v_cache: torch.Tensor,
    src: int,
    dsts: list[int],
) -> None:
    """Clone a freshly prefilled slot's KV rows into ``dsts`` (the source
    copied first: at one layer, torch's overlap check takes the source
    slice and the indexed rows for one region)."""
    idx = torch.tensor(dsts, dtype=torch.int64, device=k_cache.device)
    k_cache[:, idx] = k_cache[:, src : src + 1].clone()
    v_cache[:, idx] = v_cache[:, src : src + 1].clone()


def _copy_pages_fn(
    k_pool: torch.Tensor,  # [L, NB, BT, K, Dh], updated in place
    v_pool: torch.Tensor,
    src: int,
    dsts: list[int],
) -> None:
    """Copy one page to each of ``dsts`` (a fork's partial tail page; full
    pages are shared by refcount), the source copied first as in
    ``_fork_fn``."""
    idx = torch.tensor(dsts, dtype=torch.int64, device=k_pool.device)
    k_pool[:, idx] = k_pool[:, src : src + 1].clone()
    v_pool[:, idx] = v_pool[:, src : src + 1].clone()
