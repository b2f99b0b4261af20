"""RL policy-gradient losses (REINFORCE / PPO / GSPO) in PyTorch.

Port of the JAX package's ``train/rl_loss.py``:

- logprobs of realized tokens as gather minus logsumexp, and exact entropy;
- Schulman KL approximations to the reference and behaviour policies, with
  log-ratio clamping;
- three policy objectives: PPO token-level clip, REINFORCE with a detached
  clipped ratio, GSPO sequence-level ratios through segment sums
  (``index_add`` over row-offset segment ids);
- per-token weights 1/batch_size (or 1/group_tokens under group
  normalization), overlong filtering, linear coefficient decay;
- actor-critic: with a ``value_head`` in the params, advantages are the
  return minus V(s) (detached in the policy term) and a weighted squared
  value error joins the loss;
- a metrics dict of scalar tensors under the JAX package's names.

``jax.lax.stop_gradient`` is ``detach``. Batches are packed ``[B, L]``
rows (``types.TrainerBatch``) as torch tensors.

Under context parallelism (``cp_group``) each rank holds an ``L/cp`` slice
of the rows plus one halo column (``parallel.sharding.cp_slice``): the
forward runs on the slice, and its last position predicts the halo's
token, so no position is dropped. GSPO's segment sums span the slices:
they are summed over the cp group before any nonlinearity
(``collectives.all_reduce_sum``, whose backward sums the gradient), and the
sequence-level term is divided by the group size, so the cp ranks' local
losses sum to the row's loss, as every other (token-additive) term does.

Under tensor parallelism (``tp``) each rank holds the logits of its
``V/tp`` vocabulary rows, and ``_stats`` is vocabulary-parallel, after the
temperature: log Z from the group's maximum and its sum of exponentials,
the target's logit from the rank that owns it, and the entropy as log Z
minus the group's sum of p · logit. Every rank then holds the same
statistics and the same loss; the sums are Megatron's g (identity
backward) and log Z enters each rank's own entropy terms through f, so
the gradients are the single-device ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..models.transformer import ModelConfig, forward, lm_head_logits, value_predictions
from ..parallel.collectives import TP, all_reduce_sum, copy_to_tp, max_over_tp, reduce_from_tp


@dataclass(frozen=True)
class RLLossConfig:
    """Loss configuration; field semantics as the JAX package's."""

    policy_loss: str = "reinforce"  # "ppo" | "reinforce" | "gspo"
    use_advantages: bool = True
    epsilon_low: float = 0.02
    epsilon_high: float = 0.02
    batch_size: int = 0  # sequences per global batch; required unless group_normalization
    kl_coef: float = 0.0
    final_kl_coef: float = 0.0
    entropy_bonus: float = 0.0
    final_entropy_bonus: float = 0.0
    relu_log_p_weights: bool = False
    clamp_log_ratio_ref_new_value: float = 5.0
    divide_advantage_by_std: bool = False
    overlong_filtering: bool = False
    group_normalization: bool = False
    temperature: float = 1.0
    value_loss_coef: float = 0.0
    # upper bound on sequences per packed row (GSPO segment sums)
    max_segments: int = 512
    # consumed by the preprocessor, not the loss
    filter_zero_advantage_groups: bool = False

    @property
    def use_entropy_loss(self) -> bool:
        return self.entropy_bonus != 0.0 or self.final_entropy_bonus != 0.0


def linear_decay_coef(step, max_step: int, initial: float, final: float):
    return initial + (final - initial) * step / max(1, max_step)


def token_logprobs_from_logits(logits: torch.Tensor, input_ids: torch.Tensor, temperature: float) -> torch.Tensor:
    """logprob of input_ids[:, 1:] under logits[:, :-1] / temperature,
    [B, L-1] fp32."""
    logits = logits[:, :-1, :] / temperature
    selected = logits.gather(-1, input_ids[:, 1:, None].long())[..., 0]
    return selected - torch.logsumexp(logits, dim=-1)


def _stats(logits_t: torch.Tensor, targets: torch.Tensor, tp: TP | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(logprob of targets, entropy) of temperature-scaled logits; under
    ``tp`` of this rank's vocabulary columns, the group's statistics."""
    if tp is not None and tp.size > 1:
        return _stats_vocab_parallel(logits_t, targets, tp)
    log_norm = torch.logsumexp(logits_t, dim=-1)
    selected = logits_t.gather(-1, targets[..., None].long())[..., 0]
    logprobs_full = logits_t - log_norm[..., None]
    entropy = -(logprobs_full.exp() * logprobs_full).sum(-1)
    return selected - log_norm, entropy


def _stats_vocab_parallel(logits_t: torch.Tensor, targets: torch.Tensor, tp: TP) -> tuple[torch.Tensor, torch.Tensor]:
    """``_stats`` over the tp group's vocabulary: this rank holds the
    columns ``[rank * V_local, (rank + 1) * V_local)``."""
    n_local = logits_t.shape[-1]
    shift = max_over_tp(logits_t.detach().amax(dim=-1), tp)
    log_norm = shift + torch.log(reduce_from_tp(torch.exp(logits_t - shift[..., None]).sum(-1), tp))
    local = targets.long() - tp.rank * n_local
    own = (local >= 0) & (local < n_local)
    picked = logits_t.gather(-1, local.clamp(0, n_local - 1)[..., None])[..., 0]
    selected = reduce_from_tp(torch.where(own, picked, torch.zeros_like(picked)), tp)
    probs = torch.exp(logits_t - copy_to_tp(log_norm, tp)[..., None])
    entropy = log_norm - reduce_from_tp((probs * logits_t).sum(-1), tp)
    return selected - log_norm, entropy


def _token_stats_from_logits(
    logits: torch.Tensor, input_ids: torch.Tensor, temperature: float, tp: TP | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(new_logprobs, entropy), both [B, L-1] fp32, at the positions that
    predict input_ids[:, 1:]."""
    return _stats(logits[:, :-1, :].float() / temperature, input_ids[:, 1:], tp)


def _token_stats_chunked(
    model_params: dict,
    model_cfg: ModelConfig,
    normed_hidden: torch.Tensor,  # [B, L, D], final-norm'd trunk output
    input_ids: torch.Tensor,  # [B, L]
    temperature: float,
    chunk: int,
    halo: bool = False,
    tp: TP | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_token_stats_from_logits`` with the [*, V] fp32 logits alive one
    sequence chunk at a time: each chunk's unembed runs under
    ``checkpoint`` and is recomputed in the backward pass. With ``halo``
    (a cp slice) ``input_ids`` has one column more than the hidden, and
    every position keeps its statistics."""
    B, L, _ = normed_hidden.shape
    # position i predicts input_ids[i + 1]; without a halo the last target
    # is a dummy
    targets = input_ids[:, 1:] if halo else torch.cat([input_ids[:, 1:], input_ids[:, :1]], dim=1)

    def body(h_c, t_c):
        return _stats(lm_head_logits(model_params, model_cfg, h_c, tp) / temperature, t_c, tp)

    lps, ents = [], []
    for c in range(0, L, chunk):
        lp, ent = checkpoint(body, normed_hidden[:, c : c + chunk], targets[:, c : c + chunk], use_reentrant=False)
        lps.append(lp)
        ents.append(ent)
    lp, ent = torch.cat(lps, 1), torch.cat(ents, 1)
    return (lp, ent) if halo else (lp[:, :-1], ent[:, :-1])


def rl_loss_from_logits(
    logits: torch.Tensor, batch: dict, step, max_step: int, cfg: RLLossConfig,
    values: torch.Tensor | None = None,  # [B, L] value-head predictions
) -> tuple[torch.Tensor, dict]:
    """Loss and metrics from precomputed logits [B, L, V]."""
    new_logprobs, entropy = _token_stats_from_logits(logits, batch["input_ids"], cfg.temperature)
    return _rl_loss_from_stats(new_logprobs, entropy, batch, step, max_step, cfg, values)


def _rl_loss_from_stats(
    new_logprobs: torch.Tensor,  # [B, L-1] fp32
    entropy: torch.Tensor,  # [B, L-1] fp32
    batch: dict,
    step,
    max_step: int,
    cfg: RLLossConfig,
    values: torch.Tensor | None = None,
    cp_group=None,
) -> tuple[torch.Tensor, dict]:
    masks = (batch["labels"] != -100)[:, 1:]
    masks_f = masks.float()
    if not cfg.use_entropy_loss:
        entropy = entropy.detach()

    rewards = batch["rewards"][:, 1:]
    ref_logprobs = batch["ref_logprobs"][:, 1:]
    old_logprobs = batch["old_logprobs"][:, 1:]
    group_tokens = batch["group_tokens"][:, 1:]
    num_labels = batch["num_labels"][:, 1:].clamp(min=1.0)
    overflow = batch["overflow"][:, 1:]
    if values is not None:
        # actor-critic: advantages are the MC return minus V(s); the policy
        # term detaches them below, the value loss keeps the gradient
        values_t = values if cp_group is not None else values[:, :-1]
        advantages = rewards - values_t
    else:
        values_t = None
        advantages = batch["advantages"][:, 1:]

    if cfg.group_normalization:
        tokens_weights = 1.0 / group_tokens.clamp(min=1e-6)
    else:
        assert cfg.batch_size > 0, "batch_size required without group_normalization"
        tokens_weights = torch.full_like(group_tokens, 1.0 / cfg.batch_size)
    if cfg.overlong_filtering:
        tokens_weights = tokens_weights * (1.0 - overflow)

    log_ratio_new_old = new_logprobs - old_logprobs
    ratio_new_old = torch.exp(log_ratio_new_old)
    log_ratio_ref_new = ref_logprobs - new_logprobs

    log_p_weights = (advantages if cfg.use_advantages else rewards).detach()
    if cfg.relu_log_p_weights:
        log_p_weights = log_p_weights.clamp(min=0.0)

    clamp_val = cfg.clamp_log_ratio_ref_new_value
    clamp_ref_new_ind = (log_ratio_ref_new.abs() > clamp_val).float()
    log_ratio_ref_new_c = log_ratio_ref_new.clamp(-clamp_val, clamp_val)
    approx_kl = torch.exp(log_ratio_ref_new_c) - log_ratio_ref_new_c - 1.0
    approx_kl_new_old = torch.exp(log_ratio_new_old) - log_ratio_new_old - 1.0

    entropy_coef = linear_decay_coef(step, max_step, cfg.entropy_bonus, cfg.final_entropy_bonus)
    kl_coef = linear_decay_coef(step, max_step, cfg.kl_coef, cfg.final_kl_coef)

    def masked_sum(x):
        return (x * masks_f).sum()

    if cfg.policy_loss == "ppo":
        surr1 = ratio_new_old * log_p_weights
        clamped_ratio = ratio_new_old.clamp(1 - cfg.epsilon_low, 1 + cfg.epsilon_high)
        clamp_new_old_ind = (clamped_ratio != ratio_new_old).float()
        surr2 = clamped_ratio * log_p_weights
        per_token = torch.minimum(surr1, surr2) - kl_coef * approx_kl
        if cfg.use_entropy_loss:
            per_token = per_token + entropy_coef * entropy
        total_loss = -masked_sum(per_token * tokens_weights)
    elif cfg.policy_loss == "reinforce":
        clamp_new_old_ind = (ratio_new_old > 1 + cfg.epsilon_high).float()
        ratio_clamped = ratio_new_old.clamp(0.0, 1 + cfg.epsilon_high)
        per_token = new_logprobs * log_p_weights * ratio_clamped.detach() - kl_coef * approx_kl
        if cfg.use_entropy_loss:
            per_token = per_token + entropy_coef * entropy
        total_loss = -masked_sum(per_token * tokens_weights)
    elif cfg.policy_loss == "gspo":
        # rows are independent packs: offset each row's segment ids so one
        # flat segment sum covers the batch; ids past the range are dropped,
        # as jax.ops.segment_sum drops them
        B = new_logprobs.shape[0]
        n_seg = cfg.max_segments * B
        row_offset = torch.arange(B, device=masks.device)[:, None] * cfg.max_segments
        seg = (batch["segment_ids"][:, 1:].long() + row_offset).reshape(-1)
        in_range = (seg < n_seg).float()
        seg = torch.where(seg < n_seg, seg, torch.zeros_like(seg))

        def seg_sum(x):  # [B, L-1] -> [n_seg]
            src = (x * masks_f).reshape(-1) * in_range
            return torch.zeros(n_seg, dtype=src.dtype, device=src.device).index_add(0, seg, src)

        sums = torch.stack([seg_sum(log_ratio_new_old), seg_sum(advantages),
                            seg_sum(torch.ones_like(masks_f)), seg_sum(tokens_weights)])
        if cp_group is not None:  # a segment can cross cp slices
            sums = all_reduce_sum(sums, cp_group)
        lrn_sum, adv_sum, tok_count, weight_sum = sums.unbind(0)

        group_ratio = torch.exp(lrn_sum / tok_count.clamp(min=1e-6))
        group_adv = (adv_sum / tok_count.clamp(min=1e-6)).detach()
        valid = (tok_count > 0) & (weight_sum > 0)
        clamped_group = group_ratio.clamp(1 - cfg.epsilon_low, 1 + cfg.epsilon_high)
        clamp_seg_ind = ((clamped_group != group_ratio) & valid).float()
        min_terms = torch.minimum(group_ratio * group_adv, clamped_group * group_adv) * valid.float() * weight_sum
        total_loss = -min_terms.sum()
        if cp_group is not None:  # every cp rank holds the row's sums
            total_loss = total_loss / torch.distributed.get_world_size(cp_group)
        clamp_new_old_ind = clamp_seg_ind[seg].reshape(masks_f.shape)
    else:
        raise ValueError(f"Unknown policy_loss {cfg.policy_loss!r}")

    if values_t is not None:
        value_loss = masked_sum(0.5 * (values_t - rewards).square() * tokens_weights)
        total_loss = total_loss + cfg.value_loss_coef * value_loss

    num_output_tokens = masks_f.sum()

    def seq_mean_sum(x):
        """Per-sequence mean summed over sequences."""
        return masked_sum(x / num_labels)

    def masked_max(x):
        return torch.where(masks, x, torch.full_like(x, -torch.inf)).max()

    def masked_min(x):
        return torch.where(masks, x, torch.full_like(x, torch.inf)).min()

    new_lp, kl = new_logprobs.detach(), approx_kl.detach()
    ratio = ratio_new_old.detach()
    metrics = {
        "loss": total_loss,
        "reward": seq_mean_sum(rewards),
        "max_reward": masked_max(rewards),
        "min_reward": masked_min(rewards),
        "entropy": seq_mean_sum(entropy.detach()),
        "old_logprobs": seq_mean_sum(old_logprobs),
        "new_logprobs": seq_mean_sum(new_lp),
        "ref_logprobs": seq_mean_sum(ref_logprobs),
        "advantage": seq_mean_sum(advantages),
        "max_advantage": masked_max(advantages),
        "min_advantage": masked_min(advantages),
        "kl": seq_mean_sum(kl),
        "kl_new_old": seq_mean_sum(approx_kl_new_old.detach()),
        "mean_abs_log_ratio_new_old": seq_mean_sum(log_ratio_new_old.detach().abs()),
        "max_kl": masked_max(kl),
        "ratio_new_old": seq_mean_sum(ratio),
        "ratio_new_old_sum": masked_sum(ratio),
        "ratio_new_old_squared_sum": masked_sum(ratio * ratio),
        "ratio_ref_new": seq_mean_sum(torch.exp(log_ratio_ref_new.detach())),
        "ratio_ref_old": seq_mean_sum(torch.exp(ref_logprobs - old_logprobs)),
        "clamp_log_ratio_ref_new_indicator": seq_mean_sum(clamp_ref_new_ind),
        "clamp_log_ratio_new_old_indicator": seq_mean_sum(clamp_new_old_ind),
        "token_weight": seq_mean_sum(tokens_weights),
        "num_output_tokens_sum": num_output_tokens,
        "kl_coef": torch.as_tensor(kl_coef, dtype=torch.float32),
        "entropy_bonus_coef": torch.as_tensor(entropy_coef, dtype=torch.float32),
    }
    if values_t is not None:
        v = values_t.detach()
        metrics["value_mean"] = seq_mean_sum(v)
        metrics["value_loss"] = value_loss.detach()
        metrics["value_mse"] = seq_mean_sum((v - rewards).square())
    return total_loss, metrics


def rl_loss(
    params: dict,
    model_cfg: ModelConfig,
    loss_cfg: RLLossConfig,
    batch: dict,
    step,
    max_step: int,
    sentinel: float,  # 0 or 1: a sentinel batch's loss is multiplied by 0
    remat: bool | str = True,
    attn_impl: str = "xla",
    logits_chunk: int | None = None,
    image_embeds: torch.Tensor | None = None,  # [B, M, D] the tower's merged tokens
    image_mask: torch.Tensor | None = None,  # [B, L] placeholder positions
    cp_group=None,  # the cp axis's group: ``batch`` is this rank's slice plus its halo
    gather_layer=None,  # a world's per-layer dp gather (``parallel.sharding.layer_gather``)
    tp: TP | None = None,  # the tp axis: this rank's heads, FFN columns and vocabulary rows
) -> tuple[torch.Tensor, dict]:
    """Forward and loss for one packed micro-batch. With ``logits_chunk``
    (long rows) the [L, V] fp32 logits are never whole: the unembed and
    its statistics run chunk by chunk under checkpoint. A ``value_head``
    entry of ``params`` adds the actor-critic value path. A VLM row passes
    mrope rows as ``batch["position_ids"]`` ([3, B, L]) and the visual
    tokens to splice. Under ``cp_group`` the returned loss is this rank's
    share (the group's shares sum to the row's loss). Under ``tp`` every tp
    rank returns the same loss."""
    model_params = {k: v for k, v in params.items() if k not in ("value_head", "vision_tower")}
    ids, pos, seg = batch["input_ids"], batch["position_ids"], batch["segment_ids"]
    if cp_group is not None:  # drop the halo column: it is the next slice's
        ids, pos, seg = ids[:, :-1], pos[:, :-1], seg[:, :-1]
    L = ids.shape[1]
    chunked = logits_chunk is not None and L % logits_chunk == 0 and L > logits_chunk
    out = forward(
        model_params, model_cfg, ids, pos, seg,
        remat=remat, attn_impl=attn_impl, skip_unembed=chunked, return_hidden="value_head" in params,
        image_embeds=image_embeds, image_mask=image_mask, gather_layer=gather_layer, tp=tp,
    )
    values = None
    if "value_head" in params:
        out, hidden = out
        values = value_predictions(params["value_head"], hidden)
    if chunked:  # ``out`` is the final-norm'd hidden
        new_logprobs, entropy = _token_stats_chunked(
            model_params, model_cfg, out, batch["input_ids"], loss_cfg.temperature, logits_chunk,
            halo=cp_group is not None, tp=tp,
        )
    elif cp_group is not None:
        new_logprobs, entropy = _stats(out.float() / loss_cfg.temperature, batch["input_ids"][:, 1:], tp)
    else:
        new_logprobs, entropy = _token_stats_from_logits(out, batch["input_ids"], loss_cfg.temperature, tp)
    loss, metrics = _rl_loss_from_stats(new_logprobs, entropy, batch, step, max_step, loss_cfg, values, cp_group)
    loss = loss * (1.0 - sentinel)
    metrics["loss"] = loss
    return loss, metrics
