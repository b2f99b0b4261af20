"""The sharded train step: loss, gradient and optimizer update over the
(dp, cp, tp) mesh.

Port of the JAX package's ``parallel/train_step.py``. JAX compiles one
program over the mesh; the port runs it on every rank over the rank's
shards, in two pieces that ``TrainerLoop`` shares (it runs several passes
a step): ``pass_backward`` runs the loss on the rank's rows and cp slice
(the top leaves gathered over dp, the layers one at a time in the
forward, context-parallel attention over cp) and its backward, which
reduce-scatters over dp; under tp the forward runs Megatron's splits on
the rank's heads, FFN columns and vocabulary rows, and every tp rank
computes the same loss; ``step_grads`` sums over cp (and over tp the
gradients tp peers hold in part, ``sharding.sync_grads``) and takes the
global norm; the optimizer then updates the rank's shards in place. Under a mesh the results match the
single-device step up to the order of the sums (fp32: within 1e-5
relative on the tests' tiny model; not bit for bit).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .cp_attention import make_cp_attention
from .mesh import axis_group, axis_size, reduce_over, tp_context
from .sharding import gather_params, grad_norm, layer_gather, leaf_specs, sync_grads, tp_partial_leaves

# rl_loss metrics that are not sums over tokens or rows
MAX_METRICS = ("max_reward", "max_advantage", "max_kl")
MIN_METRICS = ("min_reward", "min_advantage")
CONST_METRICS = ("kl_coef", "entropy_bonus_coef")


def reduce_metrics(metrics: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """The global batch's metrics from every rank's: sums summed over dp
    (rows) and cp (slices), maxima and minima reduced as such, the
    coefficients kept; tp peers hold the same metrics. Three all-reduces an
    axis; identity without a world."""
    if mesh is None or axis_size(mesh, "dp") * axis_size(mesh, "cp") == 1:
        return metrics
    out = dict(metrics)
    for keys, op in ((MAX_METRICS, torch.distributed.ReduceOp.MAX), (MIN_METRICS, torch.distributed.ReduceOp.MIN),
                     ([k for k in metrics if k not in MAX_METRICS + MIN_METRICS + CONST_METRICS],
                      torch.distributed.ReduceOp.SUM)):
        keys = [k for k in keys if k in metrics]
        if not keys:
            continue
        flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        reduce_over(flat, mesh, ("dp", "cp"), op)
        out.update(zip(keys, flat.unbind(0)))
    return out


def batch_tensors(batch: dict, device) -> dict[str, torch.Tensor]:
    """numpy (or tensor) columns on ``device``: token ids int64, segment
    ids int32, the RL columns fp32."""
    out = {}
    for name, arr in batch.items():
        t = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
        if name in ("input_ids", "labels"):
            t = t.long()
        out[name] = t.to(device)
    return out


def pass_backward(weights: dict, model_cfg, loss_cfg, arrays: dict, step: float, max_step: int, sentinel: float,
                  mesh=None, gather_layer=None, extra: dict | None = None, **loss_kwargs) -> dict:
    """One pass: ``rl_loss`` on ``weights`` (``gather_params``' on a rank's
    shards with ``gather_layer``, LoRA's merged weights, or one device's
    params) over this rank's rows and cp slice, and its backward into the
    trainable leaves' ``.grad``. Returns the world's metrics, ``extra``
    (per-rank sums such as row counts) summed with them."""
    from ..train.rl_loss import rl_loss

    loss, metrics = rl_loss(weights, model_cfg, loss_cfg, arrays, step, max_step, sentinel,
                            cp_group=axis_group(mesh, "cp"), gather_layer=gather_layer, tp=tp_context(mesh),
                            **loss_kwargs)
    loss.backward()
    metrics.update(extra or {})
    return reduce_metrics({k: v.to(loss.device) for k, v in metrics.items()}, mesh)


def step_grads(leaves: list[torch.Tensor], specs: list[tuple], mesh,
               tp_partial: list[bool] | None = None) -> torch.Tensor:
    """After a step's passes: the gradients summed over cp (the whole
    leaves over dp, the ``tp_partial`` ones over tp), and the global norm in
    fp32."""
    sync_grads(leaves, specs, mesh, tp_partial)
    return grad_norm(leaves, specs, mesh)


def make_sharded_train_step(
    model_cfg,
    loss_cfg,
    optimizer: Callable | None = None,
    max_step: int = 1,
    remat: bool | str = True,
    mesh=None,
) -> Callable:
    """→ step(params, opt_state, batch, step, sentinel) → (params, opt_state,
    loss, metrics) on this rank's shards. ``params`` is the dict of shards
    (``sharding.shard_params``, leaves that require grad), ``opt_state`` a
    torch optimizer over them in ``trainer.param_leaves`` order, or None for
    ``optimizer(leaves)`` (optax's ``init``), and ``batch`` this rank's rows
    and cp slice (``sharding.shard_batch``). The returned loss and metrics
    are the global batch's, ``grad_norm`` the global norm, on every rank;
    the shards are updated in place."""
    from ..train.trainer import param_leaves
    from .sharding import tp_cut

    attn = make_cp_attention(mesh, num_kv_heads=model_cfg.num_kv_heads) if axis_size(mesh, "cp") > 1 else "xla"
    kv = tp_cut(model_cfg, axis_size(mesh, "tp"))

    def step_fn(params, opt_state, batch, step, sentinel):
        leaves = [p for _, p in param_leaves(params)]
        opt_state = opt_state if opt_state is not None else optimizer(leaves)
        metrics = pass_backward(gather_params(params, mesh, kv), model_cfg, loss_cfg,
                                batch_tensors(batch, leaves[0].device), float(step), max_step, float(sentinel),
                                mesh, layer_gather(mesh), remat=remat, attn_impl=attn)
        metrics["grad_norm"] = step_grads(leaves, leaf_specs(params, kv), mesh, tp_partial_leaves(params, kv))
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, metrics["loss"], metrics

    return step_fn
