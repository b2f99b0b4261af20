"""Sharding rules: params cut along their ``dp`` and ``tp`` dims, batches
by rows over dp and contiguous slices of the sequence over cp.

Port of the JAX package's ``parallel/sharding.py``. The rule table is
JAX's; the trainer acts on its ``dp`` and ``tp`` entries, and an engine's
pipeline stage on its ``pp`` entry (``pp_local``). A spec is a tuple of
axis names (or None) per dim, as ``jax.sharding.PartitionSpec`` is. A
``TPCut`` says how a model's attention leaves cut over tp beyond the
table:

- where K does not split over tp (``replicate_kv``), ``wk``/``wv``/
  ``bk``/``bv`` drop their ``tp`` entry and stay whole on every tp rank, as
  JAX's engine replicates such a cache;
- the query-head leaves ``wq``/``bq`` (columns) and ``wo`` (rows) cut in
  whole heads: rank r takes ``collectives.head_counts(H, tp)[r]``
  contiguous heads, the first ``H % tp`` ranks one more than the rest, so
  an ``H`` that does not split over tp runs (JAX cuts the flat ``H*Dh``
  columns in equal chunks and lets GSPMD reshard the heads; both compute
  the same function). ``q_norm`` is per ``Dh`` and stays whole. The
  gathers of such a leaf pad each rank's piece to the largest
  (``collectives.gather``'s ``sizes``).

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

Under tp the stacked layers keep their tp slice for the pass (a rank's
heads and FFN columns, ``models/transformer.py``'s Megatron splits):
``layer_gather`` gathers over dp only. ``gather_params`` gathers the
embedding table whole over dp and tp (every rank looks up any id; the
lookup's gradient is counted once, ``collectives.count_once``) and the
head over dp only: its tp cut is the vocabulary split the head runs on.
``sync_grads`` sums over tp only the gradients that tp peers hold in part:
``q_norm``/``k_norm`` (each rank's own heads read them) and the whole
``wk``/``wv`` under ``replicate_kv``; ``ln1``, ``ln2``, ``final_norm`` and
the value head see replicated inputs, so their gradients are equal on tp
peers and stay as they are. ``grad_norm`` counts each leaf's shards once.
``tp_local`` cuts a full tree to one tp rank's pass layout, the layout of
a tp engine's rank.

``shard_batch`` takes this rank's rows and cp slice of a global batch;
``cp_slice`` takes the cp slice of rows the rank already holds. A cp slice
carries one more column than its ``L/cp`` positions, the first column of
the next slice (labels -100 past the row's end): position ``i`` predicts
token ``i + 1``, so the last position of a slice needs its successor's
target (``rl_loss`` reads the halo under cp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import collectives
from .mesh import axis_group, axis_rank, axis_size, check_pp_layers

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

# the leaves whole on every tp rank when K does not split over tp
_KV_LEAVES = ("wk", "wv", "bk", "bv")
# the leaves cut by query heads along their tp dim
_HEAD_LEAVES = ("wq", "bq", "wo")
# whole leaves that each tp rank applies to its own heads: partial gradients
_TP_PARTIAL = ("q_norm", "k_norm")


@dataclass(frozen=True)
class TPCut:
    """How a model's attention leaves cut over tp: ``replicate_kv`` keeps
    the KV leaves whole on every rank; ``num_heads``/``head_dim`` (0: equal
    chunks) cut the query-head leaves in whole heads."""

    replicate_kv: bool = False
    num_heads: int = 0
    head_dim: int = 0

    def sizes(self, name: str, n: int) -> list[int] | None:
        """Each tp rank's length of leaf ``name``'s tp dim when the ranks'
        pieces differ, else None (equal chunks)."""
        if name not in _HEAD_LEAVES or n == 1 or not self.num_heads or self.num_heads % n == 0:
            return None
        return [h * self.head_dim for h in collectives.head_counts(self.num_heads, n)]


def tp_cut(model_cfg, n: int) -> TPCut:
    """The ``TPCut`` of a ``ModelConfig`` over ``n`` tp ranks: K that does
    not split keeps its KV leaves whole, and each rank selects the KV heads
    its query heads read (JAX's replicated cache spec, ``engine.py:336-340``)."""
    if model_cfg is None or n == 1:
        return TPCut()
    return TPCut(model_cfg.num_kv_heads % n != 0, model_cfg.num_heads, model_cfg.head_dim_)


def _layer_spec(name: str, cut: TPCut) -> tuple:
    spec = _LAYER_SPECS[name]
    if cut.replicate_kv and name in _KV_LEAVES:
        return tuple(None if a == "tp" else a for a in spec)
    return spec


def param_partition_specs(params: dict, cut: TPCut = TPCut()) -> dict:
    """The spec of every leaf, in the params' structure (the rule table's;
    with ``cut.replicate_kv`` the KV leaves have no tp dim)."""
    specs: dict = {}
    for name, value in params.items():
        if name == "layers":
            specs["layers"] = {k: _layer_spec(k, cut) for k in value}
        elif name == "value_head":
            specs["value_head"] = dict(_VALUE_HEAD_SPECS)
        else:
            specs[name] = _TOP_SPECS[name]
    return specs


def _map(fn, params: dict, specs: dict) -> dict:
    """``fn(leaf, spec, name)`` over the tree, ``name`` the leaf's key."""
    return {k: _map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k], k) for k, v in params.items()}


def dp_dim(spec: tuple) -> int | None:
    return spec.index("dp") if "dp" in spec else None


def tp_dim(spec: tuple) -> int | None:
    return spec.index("tp") if "tp" in spec else None


def tp_piece(p: torch.Tensor, d: int | None, n: int, r: int, sizes: list[int] | None = None) -> torch.Tensor:
    """Rank ``r``'s piece of ``p`` along dim ``d`` over ``n`` ranks: equal
    chunks, or contiguous pieces of ``sizes`` (a cut by whole heads)."""
    if d is None or n == 1:
        return p
    if sizes is not None:
        return p.narrow(d, sum(sizes[:r]), sizes[r])
    if p.shape[d] % n:
        raise ValueError(f"a leaf of shape {tuple(p.shape)} does not split {n} ways along dim {d}")
    return p.chunk(n, dim=d)[r]


def shard_params(params: dict, mesh, cut: TPCut = TPCut()) -> dict:
    """This rank's slice of every leaf along its dp and tp dims (whole
    along an axis the spec lacks), as new leaf tensors that share no
    storage."""
    n_tp = axis_size(mesh, "tp")

    def piece(p: torch.Tensor, spec: tuple, name: str) -> torch.Tensor:
        p = tp_piece(p.detach(), dp_dim(spec), axis_size(mesh, "dp"), axis_rank(mesh, "dp"))
        p = tp_piece(p, tp_dim(spec), n_tp, axis_rank(mesh, "tp"), cut.sizes(name, n_tp))
        return p.clone()

    return _map(piece, params, param_partition_specs(params, cut))


def _pass_specs(params: dict, cut: TPCut) -> dict:
    """The specs of a tp pass's layout: the embedding table whole."""
    specs = param_partition_specs(params, cut)
    return {**specs, "embed": (None, None)} if "embed" in specs else specs


def tp_local(params: dict, rank: int, size: int, cut: TPCut = TPCut()) -> dict:
    """One tp rank's weights of a full tree, in the layout a pass runs on:
    each layer leaf and the head cut along their tp dim (the query-head
    leaves by whole heads), the embedding table and the whole leaves as
    they are (copies that share no storage with ``params`` where cut, the
    same tensors elsewhere)."""

    def piece(p: torch.Tensor, spec: tuple, name: str) -> torch.Tensor:
        d = tp_dim(spec)
        return p if d is None or size == 1 else tp_piece(p, d, size, rank, cut.sizes(name, size)).clone()

    return _map(piece, params, _pass_specs(params, cut))


@torch.no_grad()
def untp_local(params: dict, group, cut: TPCut = TPCut()) -> dict:
    """The inverse of ``tp_local`` on every rank of ``group`` (the tp
    group): each cut leaf all-gathered along its tp dim."""
    n = collectives._size(group)

    def full(p, spec, name):
        d = tp_dim(spec)
        return p.detach() if d is None else collectives.gather(p.detach(), d, group, cut.sizes(name, n))

    return _map(full, params, _pass_specs(params, cut))


def pp_local(params: dict, stage: int, pp: int) -> dict:
    """One pipeline stage's weights of a full tree: the stacked layers
    ``[stage·L/pp, (stage+1)·L/pp)``, the embedding table on the first
    stage (and on the last when the head is tied to it), ``final_norm`` and
    ``lm_head`` on the last stage, other top leaves as they are. The layer
    slices are copies that share no storage with ``params``; the tree
    itself at pp 1."""
    if pp == 1:
        return params
    L = next(iter(params["layers"].values())).shape[0]
    check_pp_layers(L, pp)
    n = L // pp
    first, last = stage == 0, stage == pp - 1
    tied = "lm_head" not in params
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {name: w[stage * n:(stage + 1) * n].clone() for name, w in v.items()}
        elif k == "embed":
            if first or (last and tied):
                out[k] = v
        elif k in ("final_norm", "lm_head"):
            if last:
                out[k] = v
        else:
            out[k] = v
    return out


def gather_params(shards: dict, mesh, cut: TPCut = TPCut()) -> dict:
    """The weights of a pass: the sliced top leaves all-gathered over dp,
    the embedding table over tp as well (differentiable: the backward
    reduce-scatters), the head keeping its tp columns, the stacked layers
    still sliced, for ``forward``'s ``gather_layer`` (``layer_gather``)."""

    def full(p, spec, axes):
        for axis in axes:
            d = spec.index(axis) if axis in spec else None
            if d is not None:
                p = collectives.all_gather(p, d, axis_group(mesh, axis))
        return p

    specs = param_partition_specs(shards, cut)
    out = {}
    for k, v in shards.items():
        if k == "layers":
            out[k] = v
        elif k == "value_head":
            out[k] = _map(lambda p, s, _: full(p, s, ("dp",)), v, specs[k])
        else:
            out[k] = full(v, specs[k], ("dp", "tp") if k == "embed" else ("dp",))
    return out


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
def unshard_params(shards: dict, mesh, cut: TPCut = TPCut(), axes: tuple = ("dp", "tp")) -> dict:
    """The inverse of ``shard_params``: the full leaves, on every rank
    (gathered over ``axes`` only: ``("dp",)`` keeps the tp slices)."""

    def full(p, spec, name):
        p = p.detach()
        for axis in axes:
            d = spec.index(axis) if axis in spec else None
            if d is not None:
                sizes = cut.sizes(name, axis_size(mesh, "tp")) if axis == "tp" else None
                p = collectives.gather(p, d, axis_group(mesh, axis), sizes)
        return p

    return _map(full, shards, param_partition_specs(shards, cut))


def _walk_leaves(tree: dict, fn) -> list:
    out = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out.append(fn(path + (k,)))

    walk(tree, ())
    return out


def leaf_specs(shards: dict, cut: TPCut = TPCut()) -> list[tuple]:
    """The specs in ``trainer.param_leaves`` order."""
    specs = param_partition_specs(shards, cut)

    def spec(path):
        node = specs
        for k in path:
            node = node[k]
        return node

    return _walk_leaves(shards, spec)


def tp_partial_leaves(shards: dict, cut: TPCut = TPCut()) -> list[bool]:
    """Per leaf in ``trainer.param_leaves`` order: whether tp peers each
    hold part of its gradient (whole leaves read by each rank's own heads)."""
    partial = _TP_PARTIAL + (_KV_LEAVES if cut.replicate_kv else ())
    return _walk_leaves(shards, lambda path: path[0] == "layers" and path[-1] in partial)


def leaf_tp_sizes(shards: dict, cut: TPCut, n: int) -> list[list[int] | None]:
    """Per leaf in ``trainer.param_leaves`` order: each tp rank's length of
    its tp dim where the pieces differ (``TPCut.sizes``), else None."""
    return _walk_leaves(shards, lambda path: cut.sizes(path[-1], n) if path[0] == "layers" else None)


@torch.no_grad()
def sync_grads(leaves: list[torch.Tensor], specs: list[tuple], mesh, tp_partial: list[bool] | None = None) -> None:
    """Once per step, after the passes: every gradient summed over cp, the
    leaves with no dp dim over dp as well (the others were reduce-scattered
    over dp in the backward), and the ``tp_partial`` ones over tp. Leaves
    summed over the same axes are bucketed into one flat all-reduce per
    axis and dtype."""
    tp_partial = tp_partial or [False] * len(leaves)
    buckets: dict[tuple, list[torch.Tensor]] = {}
    for p, spec, part in zip(leaves, specs, tp_partial):
        if p.grad is None:
            continue
        axes = ("cp",) + (("dp",) if dp_dim(spec) is None else ()) + (("tp",) if part else ())
        axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
        if axes:
            buckets.setdefault((axes, str(p.grad.dtype)), []).append(p.grad)
    for (axes, _), grads in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for axis in axes:
            collectives.reduce_(flat, axis_group(mesh, axis))
        for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
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
    """The global gradient norm after ``sync_grads``, in fp32: each leaf's
    sum of squares summed over the axes that cut it (dp, tp), so a shard
    counts once and a replica (cp; tp for a whole leaf) once."""
    dev = leaves[0].device
    sq = {cut: torch.zeros((), dtype=torch.float32, device=dev)
          for cut in ((True, True), (True, False), (False, True), (False, False))}
    for p, s in zip(leaves, specs):
        if p.grad is not None:
            cut = (dp_dim(s) is not None, tp_dim(s) is not None)
            sq[cut] = sq[cut] + torch.sum(p.grad.float() * p.grad.float())
    dp_group, tp_group = axis_group(mesh, "dp"), axis_group(mesh, "tp")
    both = collectives.reduce_(sq[True, True], tp_group) + sq[True, False]
    total = collectives.reduce_(both, dp_group) + collectives.reduce_(sq[False, True], tp_group)
    return torch.sqrt(total + sq[False, False])
