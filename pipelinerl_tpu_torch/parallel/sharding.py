"""Sharding rules: params cut along their ``dp`` dim, batches by rows over
dp and contiguous slices of the sequence over cp.

Port of the JAX package's ``parallel/sharding.py``. The rule table is
JAX's, ``tp`` and ``pp`` entries included (they name the dims a later
tensor or pipeline split would cut, ROADMAP Queue 1 item 15); the port
acts on the ``dp`` entry only. A spec is a tuple of axis names (or None)
per dim, as ``jax.sharding.PartitionSpec`` is.

The params are a dict of stacked ``[L, ...]`` tensors, not ``nn.Module``s,
so FSDP2's ``fully_shard`` does not apply as is. The port uses explicit
autograd-aware collectives (``collectives.py``) instead of DTensor:

- ``shard_params`` keeps this rank's slice of each leaf along its dp dim
  (a leaf with no dp dim stays whole on every rank);
- ``gather_params`` all-gathers the sliced top leaves (embeddings, head,
  value head) over dp for a pass and leaves the stacked layers sliced;
  ``layer_gather`` gives ``transformer.forward`` one layer's full weights
  at a time, in one all-gather per layer. Each gather's backward
  reduce-scatters the gradient over dp, so each rank's ``.grad`` is the
  dp sum on its slice. Under per-layer remat (the trainer's default) the
  forward gathers a layer again in the backward, so one layer's full
  weights and full gradients are alive at a time, besides the top leaves:
  the ZeRO-3 memory shape, at 1.5x the layers' gather traffic;
- ``sync_grads`` then sums the sliced leaves' gradients over cp (cp ranks
  hold the same slice and each saw its part of the sequence) and the whole
  leaves' gradients over every rank, once per optimizer step.

``shard_batch`` takes this rank's rows and cp slice of a global batch;
``cp_slice`` takes the cp slice of rows the rank already holds. A cp slice
carries one more column than its ``L/cp`` positions, the first column of
the next slice (labels -100 past the row's end): position ``i`` predicts
token ``i + 1``, so the last position of a slice needs its successor's
target (``rl_loss`` reads the halo under cp).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import collectives
from .mesh import axis_group, axis_rank, axis_size, world_group

# the spec of each param leaf, per dim; layer leaves carry the stacked-layer
# dim first
_LAYER_SPECS = {
    "ln1": ("pp", None),
    "ln2": ("pp", None),
    "wq": ("pp", "dp", "tp"),
    "wk": ("pp", "dp", "tp"),
    "wv": ("pp", "dp", "tp"),
    "wo": ("pp", "tp", "dp"),
    "wgate": ("pp", "dp", "tp"),
    "wup": ("pp", "dp", "tp"),
    "wdown": ("pp", "tp", "dp"),
    "bq": ("pp", "tp"),
    "bk": ("pp", "tp"),
    "bv": ("pp", "tp"),
    "q_norm": ("pp", None),
    "k_norm": ("pp", None),
}

_TOP_SPECS = {
    "embed": ("dp", "tp"),
    "final_norm": (None,),
    "lm_head": ("dp", "tp"),
}

_VALUE_HEAD_SPECS = {"w": ("dp", None), "b": (None,)}

def param_partition_specs(params: dict) -> dict:
    """The spec of every leaf, in the params' structure."""
    specs: dict = {}
    for name, value in params.items():
        if name == "layers":
            specs["layers"] = {k: _LAYER_SPECS[k] for k in value}
        elif name == "value_head":
            specs["value_head"] = dict(_VALUE_HEAD_SPECS)
        else:
            specs[name] = _TOP_SPECS[name]
    return specs


def _map(fn, params: dict, specs: dict) -> dict:
    return {k: _map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k]) for k, v in params.items()}


def dp_dim(spec: tuple) -> int | None:
    return spec.index("dp") if "dp" in spec else None


def shard_params(params: dict, mesh) -> dict:
    """This rank's slice of every leaf along its dp dim (whole leaves where
    the spec has no dp), as new leaf tensors that share no storage."""
    n, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")

    def cut(p: torch.Tensor, spec: tuple) -> torch.Tensor:
        d = dp_dim(spec)
        if d is None or n == 1:
            return p.detach().clone()
        if p.shape[d] % n:
            raise ValueError(f"a leaf of shape {tuple(p.shape)} does not split {n} ways along dim {d}")
        return p.detach().chunk(n, dim=d)[r].clone()

    return _map(cut, params, param_partition_specs(params))


def gather_params(shards: dict, mesh) -> dict:
    """The weights of a pass: the sliced top leaves all-gathered over dp
    (differentiable: the backward reduce-scatters over dp), the stacked
    layers still sliced, for ``forward``'s ``gather_layer``
    (``layer_gather``)."""
    group = axis_group(mesh, "dp")

    def full(p, spec):
        d = dp_dim(spec)
        return p if d is None else collectives.all_gather(p, d, group)

    specs = param_partition_specs(shards)
    top = {k: v for k, v in shards.items() if k != "layers"}
    return {**_map(full, top, specs), "layers": shards["layers"]}


def layer_gather(mesh) -> Callable[[dict], dict] | None:
    """→ ``gather(layer)``: one layer's full weights from its dp slices (a
    dict of ``_unbind_layers``), in one all-gather per dtype; the backward
    reduce-scatters the layer's gradients over dp. None without a dp
    axis."""
    group, n = axis_group(mesh, "dp"), axis_size(mesh, "dp")
    if group is None:
        return None

    def gather(layer: dict) -> dict:
        out = dict(layer)
        sliced = [k for k in layer if dp_dim(_LAYER_SPECS[k]) is not None]
        for dtype in sorted({layer[k].dtype for k in sliced}, key=str):
            names = [k for k in sliced if layer[k].dtype == dtype]
            flat = torch.cat([layer[k].reshape(-1) for k in names])[None]
            pieces = collectives.all_gather(flat, 0, group).split([layer[k].numel() for k in names], dim=1)
            for k, piece in zip(names, pieces):
                # the stacked spec's dp dim, less the unbound layer dim
                out[k] = torch.cat(piece.reshape(n, *layer[k].shape).unbind(0), dim=dp_dim(_LAYER_SPECS[k]) - 1)
        return out

    return gather


@torch.no_grad()
def unshard_params(shards: dict, mesh) -> dict:
    """The inverse of ``shard_params``: the full leaves, on every rank."""
    group = axis_group(mesh, "dp")

    def full(p, spec):
        d = dp_dim(spec)
        return p.detach() if d is None or group is None else collectives.gather(p.detach(), d, group)

    return _map(full, shards, param_partition_specs(shards))


def leaf_specs(shards: dict) -> list[tuple]:
    """The specs in ``trainer.param_leaves`` order."""
    out = []

    def walk(tree, specs):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, specs[k])
            else:
                out.append(specs[k])

    walk(shards, param_partition_specs(shards))
    return out


@torch.no_grad()
def sync_grads(leaves: list[torch.Tensor], specs: list[tuple], mesh) -> None:
    """Once per step, after the passes: the sliced leaves' gradients summed
    over cp, the whole leaves' over every rank. Leaves the same on every
    rank are bucketed into one flat all-reduce per group."""
    for group, pick in ((axis_group(mesh, "cp"), lambda s: dp_dim(s) is not None),
                        (world_group(mesh), lambda s: dp_dim(s) is None)):
        grads = [p.grad for p, s in zip(leaves, specs) if pick(s) and p.grad is not None]
        if group is None or not grads:
            continue
        for dtype in sorted({g.dtype for g in grads}, key=str):
            same = [g for g in grads if g.dtype == dtype]
            flat = collectives.reduce_(torch.cat([g.reshape(-1) for g in same]), group)
            for g, piece in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(piece.view_as(g))


def _rows(arr: np.ndarray, mesh) -> np.ndarray:
    n, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split over dp={n}")
    b = arr.shape[0] // n
    return arr[r * b:(r + 1) * b]


def cp_slice(batch: dict[str, np.ndarray], mesh) -> dict[str, np.ndarray]:
    """This cp rank's contiguous ``L/cp`` slice (along dim 1) of every ``[B, L, ...]`` column
    plus one halo column (the next slice's first; past the row's end, labels
    -100 and zeros). Identity without a cp axis."""
    n, r = axis_size(mesh, "cp"), axis_rank(mesh, "cp")
    if n == 1:
        return batch
    out = {}
    for name, arr in batch.items():
        L = arr.shape[1]
        if L % n:
            raise ValueError(f"a row of {L} does not split over cp={n}")
        c = L // n
        pad = np.full((arr.shape[0], 1, *arr.shape[2:]), -100 if name == "labels" else 0, dtype=arr.dtype)
        out[name] = np.concatenate([arr, pad], axis=1)[:, r * c:(r + 1) * c + 1]
    return out


def shard_batch(batch: dict[str, np.ndarray], mesh) -> dict[str, np.ndarray]:
    """This rank's part of a global ``[B, L]`` batch: its rows by dp rank
    (``B/dp`` contiguous rows) and its cp slice, ``P("dp", "cp")``."""
    return cp_slice({name: _rows(np.asarray(v), mesh) for name, v in batch.items()}, mesh)


def grad_norm(leaves: list[torch.Tensor], specs: list[tuple], mesh) -> torch.Tensor:
    """The global gradient norm after ``sync_grads``, in fp32: the sliced
    leaves' sums of squares summed over dp (a cp replica counts once), plus
    the whole leaves' once."""
    sliced = [p.grad for p, s in zip(leaves, specs) if p.grad is not None and dp_dim(s) is not None]
    whole = [p.grad for p, s in zip(leaves, specs) if p.grad is not None and dp_dim(s) is None]
    dev = leaves[0].device
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for g in sliced:
        sq = sq + torch.sum(g.float() * g.float())
    collectives.reduce_(sq, axis_group(mesh, "dp"))
    for g in whole:
        sq = sq + torch.sum(g.float() * g.float())
    return torch.sqrt(sq)
