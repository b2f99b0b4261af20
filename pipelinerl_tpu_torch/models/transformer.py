"""Decoder-only transformer for the Qwen2/Qwen3/Llama families, in PyTorch.

Port of the JAX package's ``models/transformer.py``. Parameters keep the JAX
pytree's names and its stacked ``[L, ...]`` layer layout, so the same arrays
load into either package (``params_from_numpy``); a Python loop over layers
takes the place of ``lax.scan``.

- Packed rows: ``forward`` takes ``[B, L]`` token rows with segment ids;
  masking is derived inside the attention op from segment ids and flat token
  indices, never from a mask tensor.
- FP32 output head: ``lm_head_logits`` computes the logits in fp32 and masks
  padded vocabulary rows there, the one funnel that sampler and trainer share.
- Training: ``forward`` is differentiable on every attention path, and
  ``remat`` recomputes a layer (or its MLP) in the backward pass.
- Decode is staged: ``decode_step_staged`` attends over a frozen cache plus
  this window's staged band plus the token itself, and returns the new K/V
  for the caller to stage.
- Prefix reuse: ``forward_extend`` runs only a tail's layers against cached
  prefix K/V.
- Actor-critic: ``init_value_head`` and ``value_predictions`` put a linear
  value head on ``forward``'s ``return_hidden`` output.
- Tensor parallelism (``tp``, a ``parallel.collectives.TP``): ``forward``,
  ``forward_extend`` and ``decode_step_staged`` run Megatron's splits on
  this rank's slice of the weights (``parallel.sharding.tp_local``). Each
  rank projects its query heads (``tp_heads``: contiguous blocks, the
  first ``H % tp`` ranks one head more, so H need not split over tp) and
  the KV heads they read (its ``K/tp`` when K splits; otherwise the heads
  its query heads read, from ``wk``/``wv`` held whole), its ``F/tp`` FFN
  columns; ``wo`` and ``wdown`` are row-parallel, their partial sums
  all-reduced (g), and their inputs' gradients all-reduced (f). The
  embedding table is whole; the head is vocabulary-split at
  ``lm_head_logits``: each rank computes the logits of its ``V/tp`` rows
  (the rows of the table when tied). The row-parallel partial sums go over
  the group in fp32 and round once, as one rank's product does.
- Pipeline stages (an engine at ``pp`` above 1, ``inference/tp_ranks.py``):
  ``forward``, ``forward_extend`` and ``decode_step_staged`` run the layers
  they are given (a stage's, ``parallel.sharding.pp_local``). A later
  stage passes the previous stage's hidden state as ``hidden_in`` in place
  of the embedding, and a stage before the last passes
  ``last_stage=False`` to get its hidden state back in place of the logits;
  the rope tables come from the positions on every stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import decode_attention_staged, mha_packed
from ..parallel.collectives import TP, copy_to_tp, count_once, head_counts, reduce_from_tp

_NEG_INF = -1e30


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int | None = None
    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False  # True for Qwen2-family q/k/v projections
    qk_norm: bool = False  # True for Qwen3 per-head q/k RMSNorm
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # tokenizer entry count when smaller than vocab_size (padded checkpoints
    # such as Qwen2.5: 151,936 logit rows for 151,643 tokenizer entries); ids
    # >= valid_vocab get a -1e30 logit in lm_head_logits and are never sampled
    valid_vocab: int | None = None
    # the HF ``architectures`` entry the config came from (written back by
    # ``train.checkpoints.export_hf``)
    hf_architecture: str | None = None
    # multimodal rotary sections (t, h, w) over head_dim / 2 channels, set
    # for Qwen2.5-VL-family models; None is the standard 1D rope
    mrope_section: tuple[int, ...] | None = None
    # VLM special tokens (image placeholder expansion, mrope indexing)
    image_token_id: int | None = None
    vision_start_token_id: int | None = None
    vision_end_token_id: int | None = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random init (scaled normal), the JAX ``init_params`` layout. Draws on
    the generator's device, then moves to ``device`` in ``cfg.dtype``."""
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, Dh = cfg.num_layers, cfg.head_dim_
    dt = cfg.dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=device, dtype=dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "ln1": ones(L, D),
        "ln2": ones(L, D),
        "wq": normal((L, D, cfg.q_dim), D**-0.5),
        "wk": normal((L, D, cfg.kv_dim), D**-0.5),
        "wv": normal((L, D, cfg.kv_dim), D**-0.5),
        "wo": normal((L, cfg.q_dim, D), cfg.q_dim**-0.5),
        "wgate": normal((L, D, Fi), D**-0.5),
        "wup": normal((L, D, Fi), D**-0.5),
        "wdown": normal((L, Fi, D), Fi**-0.5),
    }
    if cfg.attention_bias:
        layers["bq"] = zeros(L, cfg.q_dim)
        layers["bk"] = zeros(L, cfg.kv_dim)
        layers["bv"] = zeros(L, cfg.kv_dim)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Dh)
        layers["k_norm"] = ones(L, Dh)
    params = {
        "embed": normal((V, D), 0.02),
        "layers": layers,
        "final_norm": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((D, V), D**-0.5)
    return params


def _tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX parameter pytree, as numpy arrays under the same keys and
    shapes, to the port's parameters in ``cfg.dtype`` on ``device``. Any
    subtree converts the same way: a ``vision_tower`` entry (the trained
    tower of a VLM), or the tower's own tree passed alone."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor_from_numpy(node, cfg.dtype, device)

    return convert(tree)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [.., head_dim] in the HF rotate-half layout."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    angles = positions.float()[..., None] * inv_freq  # [..., Dh/2]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def mrope_cos_sin(
    positions: torch.Tensor,  # [3, ...] (t, h, w) position rows
    head_dim: int,
    theta: float,
    section: tuple[int, ...],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal 3D rope (Qwen2.5-VL): the rotary channels split into (t,
    h, w) sections of ``section`` channels each (per cos/sin half), each
    section rotated by its own position row. Text tokens carry three equal
    rows, where this is the standard rope. Returns cos/sin [..., head_dim]
    in ``apply_rope``'s rotate-half layout."""
    cos3, sin3 = rope_cos_sin(positions, head_dim, theta)  # [3, ..., Dh]
    row = torch.empty(head_dim, dtype=torch.int64)
    offset = 0
    for i, width in enumerate(list(section) * 2):
        row[offset : offset + width] = i % 3
        offset += width
    if offset != head_dim:
        raise ValueError(f"mrope sections {section} do not fill head_dim {head_dim}")
    idx = row.to(positions.device).expand(*cos3.shape[1:])[None]
    return cos3.gather(0, idx)[0], sin3.gather(0, idx)[0]


def positional_cos_sin(cfg: ModelConfig, position_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The standard rope, or mrope for ``[3, B, L]`` position rows of a
    model with ``mrope_section``."""
    if cfg.mrope_section is not None and position_ids.ndim == 3 and position_ids.shape[0] == 3:
        return mrope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta, cfg.mrope_section)
    return rope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta)


def splice_image_embeds(
    x: torch.Tensor,  # [B, L, D] token embeddings
    image_embeds: torch.Tensor,  # [B, M, D] visual tokens (bucket-padded)
    image_mask: torch.Tensor,  # [B, L] bool, image placeholder positions
) -> torch.Tensor:
    """The k-th placeholder position's embedding becomes the k-th visual
    token, at a static shape: a running count over the mask indexes the
    visual rows."""
    idx = (torch.cumsum(image_mask.long(), dim=1) - 1).clamp(0, image_embeds.shape[1] - 1)
    gathered = torch.gather(image_embeds.to(x.dtype), 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(image_mask[..., None], gathered, x)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., heads, Dh]; cos/sin: broadcastable [..., Dh] (no head dim)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


def tp_heads(cfg: ModelConfig, tp: TP | None) -> tuple[int, list[int] | None]:
    """(this rank's query heads, and the global KV heads they read when K
    does not split over tp, else None). The ranks hold contiguous blocks of
    query heads, the first ``H % tp`` one more (``collectives.head_counts``).
    Query head ``j`` of the rank reads its ``j // (H_local / K_local)``-th
    KV head; where the heads' groups straddle ranks unevenly, each query
    head gets its own copy."""
    if tp is None or tp.size == 1:
        return cfg.num_heads, None
    H, K, n = cfg.num_heads, cfg.num_kv_heads, tp.size
    counts = head_counts(H, n)
    Hl, first = counts[tp.rank], sum(counts[: tp.rank])
    if K % n == 0:  # then H % n == 0 too: each rank holds whole groups
        return Hl, None
    heads = [(first + j) // (H // K) for j in range(Hl)]
    distinct = sorted(set(heads))
    g = Hl // len(distinct)
    if Hl % len(distinct) == 0 and heads == [distinct[j // g] for j in range(Hl)]:
        return Hl, distinct
    return Hl, heads


def tp_kv_heads(cfg: ModelConfig, tp: TP | None) -> int:
    """The KV heads a rank holds (its cache's head dim)."""
    kv = tp_heads(cfg, tp)[1]
    if kv is not None:
        return len(kv)
    return cfg.num_kv_heads // (1 if tp is None else tp.size)


def _project_qkv(layer: dict, cfg: ModelConfig, x: torch.Tensor, tp: TP | None = None):
    """x: [..., D] → q [..., H, Dh], k/v [..., K, Dh]; under ``tp`` this
    rank's heads."""
    Hl, kv_heads = tp_heads(cfg, tp)
    x = copy_to_tp(x, tp)
    q = x @ layer["wq"]
    k = x @ layer["wk"]
    v = x @ layer["wv"]
    if "bq" in layer:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    Dh = cfg.head_dim_
    q = q.reshape(*x.shape[:-1], Hl, Dh)
    k = k.reshape(*x.shape[:-1], -1, Dh)
    v = v.reshape(*x.shape[:-1], -1, Dh)
    if kv_heads is not None:
        k, v = k[..., kv_heads, :], v[..., kv_heads, :]
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _row_parallel(x: torch.Tensor, w: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """``x @ w`` for a weight cut along its input rows over tp: each rank's
    partial product in fp32, summed over the group (g), then rounded once
    to ``x``'s dtype, so the result differs from one rank's product only by
    the order of its fp32 sums (bf16 partials rounded apart would each move
    by a bf16 step)."""
    if tp is None or tp.size == 1:
        return x @ w
    return reduce_from_tp(x.float() @ w.float(), tp).to(x.dtype)


def _mlp(layer: dict, x: torch.Tensor, tp: TP | None = None) -> torch.Tensor:
    x = copy_to_tp(x, tp)
    return _row_parallel(F.silu(x @ layer["wgate"]) * (x @ layer["wup"]), layer["wdown"], tp)


def _attn_out(layer: dict, attn: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """The row-parallel output projection of ``attn`` [..., H_local, Dh]."""
    return _row_parallel(attn.reshape(*attn.shape[:-2], -1), layer["wo"], tp)


def vocab_range(cfg: ModelConfig, tp: TP | None) -> tuple[int, int]:
    """[lo, hi) of the vocabulary rows whose logits this rank computes."""
    if tp is None or tp.size == 1:
        return 0, cfg.vocab_size
    if cfg.vocab_size % tp.size:
        raise ValueError(f"vocab_size {cfg.vocab_size} does not split over tp={tp.size}")
    n = cfg.vocab_size // tp.size
    return tp.rank * n, (tp.rank + 1) * n


def lm_head_logits(params: dict, cfg: ModelConfig, x_normed: torch.Tensor, tp: TP | None = None) -> torch.Tensor:
    """FP32 lm_head over already-final-norm'd hidden states. Padded
    vocabulary rows (ids >= ``cfg.valid_vocab``) get -1e30 here, the single
    funnel every consumer shares, so sampler and trainer logprobs agree while
    untrained padding ids can never be sampled. Under ``tp`` the logits of
    this rank's ``V/tp`` rows (``vocab_range``): the head's local columns,
    or the rows of the whole embedding table when tied; the mask compares
    global ids."""
    lo, hi = vocab_range(cfg, tp)
    if cfg.tie_word_embeddings:
        table = params["embed"] if (lo, hi) == (0, cfg.vocab_size) else params["embed"][lo:hi]
        w = table.float().T
    else:
        w = params["lm_head"].float()
    logits = copy_to_tp(x_normed, tp).float() @ w
    if cfg.valid_vocab is not None and cfg.valid_vocab < hi:
        # in place, where the JAX package takes a ``where``: the product saves
        # its inputs, not its output, so autograd accepts the write (the
        # masked logits get zero gradient either way) and no second [.., V]
        # fp32 buffer is made
        logits[..., max(cfg.valid_vocab - lo, 0) :] = _NEG_INF
    return logits


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor, tp: TP | None = None) -> torch.Tensor:
    """Final norm + FP32 lm_head. Returns fp32 logits (this rank's
    vocabulary rows under ``tp``)."""
    return lm_head_logits(params, cfg, rms_norm(x, params["final_norm"], cfg.rms_norm_eps), tp)


def _unbind_layers(params: dict) -> list[dict]:
    """Per-layer weight dicts from one ``unbind`` of each stacked weight: its
    backward stacks the layers' gradients once, where ``w[l]`` slices would
    each add a zero-filled gradient of the whole ``[L, ...]`` tensor."""
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    return [dict(zip(names, ws)) for ws in per_layer]


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------


def forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, L]
    position_ids: torch.Tensor,  # [B, L], or [3, B, L] mrope rows (VLM)
    segment_ids: torch.Tensor,  # [B, L]
    return_kv: bool = False,
    remat: bool | str = False,  # True: per layer; "mlp": the MLP only
    attn_impl="xla",  # "xla" (plain torch) | "gqa" | "flash" | "blockwise" (CUDA kernels) | a callable
    skip_unembed: bool = False,
    return_hidden: bool = False,
    image_embeds: torch.Tensor | None = None,  # [B, M, D] visual tokens
    image_mask: torch.Tensor | None = None,  # [B, L] bool placeholder positions
    gather_layer: Callable[[dict], dict] | None = None,  # a world's per-layer dp gather
    tp: TP | None = None,  # this rank's tensor-parallel group (its heads, FFN columns, vocabulary rows)
    hidden_in: torch.Tensor | None = None,  # [B, L, D] a later pipeline stage's input, in place of the embedding
    last_stage: bool = True,  # False: the hidden state [B, L, D] after these layers in the logits slot
):
    """Full forward over packed rows. Returns fp32 logits [B, L, V]; with
    ``return_kv`` also the per-layer keys/values, each [L, B, T, K, Dh]; with
    ``return_hidden`` also the last layer's output [B, L, D] before the
    final norm (the value head's input), last.

    ``remat`` recomputes activations in the backward pass instead of keeping
    them: ``True`` checkpoints each layer, ``"mlp"`` only each MLP (the
    attention residuals stay). ``skip_unembed`` returns the final-norm'd
    hidden [B, L, D] in the logits slot instead: prefill callers need one
    position's logits only, and the chunked loss unembeds by pieces.

    A VLM row passes ``image_embeds`` (the tower's merged tokens), spliced
    at ``image_mask``, and ``[3, B, L]`` mrope position rows; attention
    masks by segment and flat index, so it sees no positions. A callable
    ``attn_impl`` takes ``mha_packed``'s arguments (context-parallel
    attention, ``parallel/cp_attention.py``). ``gather_layer`` turns a
    layer's dp slices into its full weights inside the layer's (remat)
    region (``parallel.sharding.layer_gather``). Under ``tp`` the logits
    are this rank's ``V/tp`` columns and the K/V its heads'. A pipeline
    stage runs the layers of ``params`` from ``hidden_in`` (after the
    first) and, before the last, returns its hidden state unnormed in the
    logits slot."""
    if callable(attn_impl):
        attn_fn = attn_impl
    elif attn_impl in ("gqa", "blockwise"):
        # JAX's blockwise attention computes kernel #2's function
        # (pipelinerl_tpu/ops/gqa_attention.py:19); the port routes it there
        from ..ops.gqa_attention import mha_packed_gqa_simple as attn_fn
    elif attn_impl == "flash":
        from ..ops.flash_attention import mha_packed_flash as attn_fn
    elif attn_impl == "xla":
        attn_fn = mha_packed
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if remat not in (False, True, "mlp"):
        raise ValueError(f"unknown remat {remat!r}")
    if hidden_in is not None:
        x = hidden_in
    else:
        # the whole table on every tp rank: its gather's backward sums over tp
        x = count_once(params["embed"][input_ids], tp)
        if image_embeds is not None:
            x = splice_image_embeds(x, image_embeds, image_mask)
    cos, sin = positional_cos_sin(cfg, position_ids)
    if position_ids.ndim == 3:
        position_ids = position_ids[0]

    def mlp_block(h, layer):
        return _mlp(layer, rms_norm(h, layer["ln2"], cfg.rms_norm_eps), tp)

    def layer_fn(h, layer):
        if gather_layer is not None:
            layer = gather_layer(layer)
        normed = rms_norm(h, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(layer, cfg, normed, tp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attn_fn(q, k, v, segment_ids, position_ids)
        h = h + _attn_out(layer, attn, tp)
        if remat == "mlp":
            return h + checkpoint(mlp_block, h, layer, use_reentrant=False), k, v
        return h + mlp_block(h, layer), k, v

    ks, vs = [], []
    for layer in _unbind_layers(params):
        if remat is True:
            x, k, v = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x, k, v = layer_fn(x, layer)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if not last_stage:
        out = x
    elif skip_unembed:
        out = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    else:
        out = unembed(params, cfg, x, tp)
    outs = [out]
    if return_kv:
        outs.append((torch.stack(ks), torch.stack(vs)))
    if return_hidden:
        outs.append(x)
    return outs[0] if len(outs) == 1 else tuple(outs)


# ---------------------------------------------------------------------------
# decode step (inference hot path)
# ---------------------------------------------------------------------------


def extend_segments(prefix_len: torch.Tensor, Pfx: int, Lt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment ids of a tail prefill against a padded prefix: (q_seg [B, Lt],
    kv_seg [B, Pfx + Lt]), int32. The tail is segment 0; prefix keys at
    index >= ``prefix_len`` (the pad) are segment 1, so the valid prefix and
    the tail form one segment with the pad between them."""
    dev = prefix_len.device
    q_seg = torch.zeros((prefix_len.shape[0], Lt), dtype=torch.int32, device=dev)
    pre_seg = (torch.arange(Pfx, device=dev)[None, :] >= prefix_len[:, None]).to(torch.int32)
    return q_seg, torch.cat([pre_seg, q_seg], 1)


def forward_extend(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, Lt] — tail tokens (padded bucket)
    position_ids: torch.Tensor,  # [B, Lt] — absolute positions (prefix_len + i)
    k_prefix: torch.Tensor,  # [L, B, Pfx, K, Dh] — cached prefix K (rope applied)
    v_prefix: torch.Tensor,
    prefix_len: torch.Tensor,  # [B] — valid prefix tokens (the rest of Pfx is pad)
    attn_impl: str = "xla",  # "xla" (plain torch) | "gqa" (CUDA kernel)
    skip_unembed: bool = False,
    tp: TP | None = None,
    hidden_in: torch.Tensor | None = None,  # [B, Lt, D] a later pipeline stage's input
    last_stage: bool = True,  # False: the hidden state after these layers in the logits slot
):
    """Prefill of a tail against a cached prefix: only the tail's layers run,
    attending over [prefix | tail]. Tail queries sit at global flat indices
    Pfx.. (``q_offset = Pfx``), so every prefix key is visible and the tail
    is causal; prefix pad keys (index >= prefix_len) are masked by a segment
    mismatch (segment 1 against the tail's 0). Tail pad tokens sit after the
    valid ones, causally invisible to them.

    Returns (fp32 logits [B, Lt, V], or the final-norm'd hidden with
    ``skip_unembed``, or the hidden state before the last pipeline stage;
    (k_tail, v_tail) [L, B, Lt, K, Dh])."""
    if attn_impl == "gqa":
        from ..ops.gqa_attention import mha_packed_gqa as attn_fn
    elif attn_impl == "xla":
        from ..ops.gqa_attention import mha_packed_gqa_plain as attn_fn
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, Lt = input_ids.shape
    Pfx = k_prefix.shape[2]
    x = params["embed"][input_ids] if hidden_in is None else hidden_in
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta)
    q_seg, kv_seg = extend_segments(prefix_len.to(input_ids.device), Pfx, Lt)
    ks, vs = [], []
    for layer, k_pre, v_pre in zip(_unbind_layers(params), k_prefix, v_prefix):
        normed = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(layer, cfg, normed, tp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_all = torch.cat([k_pre.to(k.dtype), k], 1)
        v_all = torch.cat([v_pre.to(v.dtype), v], 1)
        attn = attn_fn(q, k_all, v_all, q_seg, kv_seg, Pfx)[0]
        x = x + _attn_out(layer, attn, tp)
        x = x + _mlp(layer, rms_norm(x, layer["ln2"], cfg.rms_norm_eps), tp)
        ks.append(k)
        vs.append(v)
    if not last_stage:
        out = x
    elif skip_unembed:
        out = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    else:
        out = unembed(params, cfg, x, tp)
    return out, (torch.stack(ks), torch.stack(vs))


def decode_step_staged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S] — base_lens + step
    k_cache: torch.Tensor,  # [L, S, T, K, Dh] — frozen during the window
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # [S] int32 — cache lengths at window start
    k_staged: torch.Tensor,  # [L, W, S, K, Dh] — this window's earlier tokens
    v_staged: torch.Tensor,
    step: int,  # index within the window; band rows < step are valid
    attn_impl="xla",  # "xla" (plain torch) | "ragged" (CUDA kernel) | a callable
    # with the signature of ops/attention.decode_attention_staged (the
    # engine's paged layout closes a block table over it)
    tp: TP | None = None,
    hidden_in: torch.Tensor | None = None,  # [S, D] a later pipeline stage's input
    last_stage: bool = True,  # False: the hidden state [S, D] after these layers in the logits slot
):
    """One decode step attending over frozen cache + staged band + self.
    Returns (fp32 logits [S, V], k_new [L, S, K, Dh], v_new [L, S, K, Dh]);
    the caller stages the new K/V and merges the band once per window.
    Under ``tp``: this rank's ``V/tp`` logits and its heads' K/V. A
    pipeline stage before the last returns its hidden state in place of the
    logits."""
    if callable(attn_impl):
        attn_fn = attn_impl
    elif attn_impl == "ragged":
        from ..ops.decode_attention import decode_attention_staged_ragged as attn_fn
    elif attn_impl == "xla":
        attn_fn = decode_attention_staged
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    x = params["embed"][tokens] if hidden_in is None else hidden_in  # [S, D]
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)  # [S, Dh]
    ks, vs = [], []
    for l, layer in enumerate(_unbind_layers(params)):
        normed = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(layer, cfg, normed, tp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attn_fn(
            q, k, v, k_cache[l], v_cache[l], base_lens, k_staged[l], v_staged[l], step
        )
        x = x + _attn_out(layer, attn, tp)
        x = x + _mlp(layer, rms_norm(x, layer["ln2"], cfg.rms_norm_eps), tp)
        ks.append(k)
        vs.append(v)
    return (unembed(params, cfg, x, tp) if last_stage else x), torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# value head (PPO actor-critic)
# ---------------------------------------------------------------------------


def init_value_head(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """A linear head over the last layer's output to one value per token:
    ``w`` [D, 1] scaled normal, ``b`` [1] zero, in ``cfg.dtype``."""
    D = cfg.hidden_size
    w = torch.randn((D, 1), generator=generator, device=generator.device) * D**-0.5
    return {"w": w.to(device=device, dtype=cfg.dtype), "b": torch.zeros((1,), dtype=cfg.dtype, device=device)}


def value_predictions(value_head: dict, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, L, D] → values [B, L], fp32."""
    out = hidden.float() @ value_head["w"].float()
    return out[..., 0] + value_head["b"].float()[0]
