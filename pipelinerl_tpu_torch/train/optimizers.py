"""Lion and Adafactor with optax 0.2.6's arithmetic, as ``torch.optim``
optimizers.

The JAX trainer builds ``optax.lion(schedule, weight_decay=wd,
mask=ndim >= 2)`` and ``optax.adafactor(schedule)`` (``train/trainer.py``
``make_optimizer``). These classes compute the same updates on the same
tensors, step by step, in the parameter's dtype where optax does:

- the state (Lion's ``mu``, Adafactor's ``v_row``/``v_col``/``v``) is kept
  in the parameter's dtype, as optax keeps it with ``mu_dtype=None`` and
  casts the factored moments to ``param.dtype``;
- the learning rate is ``group["lr"]`` (a ``LambdaLR`` over the same
  schedule as AdamW), rounded to the update's dtype as optax's
  ``scale_by_schedule`` rounds it;
- Adafactor's block RMS (the clip and the parameter scale) is over the
  whole tensor, which on the stacked ``[L, ...]`` layout is every layer at
  once; it factors over the two largest axes of that tensor, wherever they
  sit, and only when the second largest has ``min_dim_size_to_factor`` rows.

Weight decay applies where a group's ``weight_decay`` is nonzero (Lion's
mask); Adafactor, as ``optax.adafactor`` is built, takes none.

On a trainer world's dp shards Lion is per element and runs as is.
Adafactor's factored moments and block RMS span the whole stacked leaf, so
it takes ``views``: per param, ``(to_full, to_local)`` (an all-gather over
dp and this rank's slice) or None. It gathers the leaf and its gradient,
keeps the moments of the whole leaf (the same on every rank), and applies
its slice of the update.
"""

from __future__ import annotations

import numpy as np
import torch


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as JAX multiplies a Python number into an array: rounded
    to the array's dtype first (a weakly typed scalar). The schedule's
    value passes through fp32 first, as optax computes it."""
    return torch.tensor(np.float32(value), dtype=like.dtype, device=like.device)


# optax.lion's and optax.adafactor's defaults, which the JAX trainer keeps
LION_B1, LION_B2 = 0.9, 0.99
DECAY_RATE = 0.8  # Adafactor's second-moment decay: 1 - (t + 1)^-0.8
MIN_DIM_SIZE_TO_FACTOR = 128
EPS = 1e-30  # added to g² before the means
MIN_SCALE = 1e-3  # the floor of the parameter's block RMS


class Lion(torch.optim.Optimizer):
    """``optax.lion``: ``u = sign((1 - b1) g + b1 mu)``, then
    ``mu <- (1 - b2) g + b2 mu``, ``u += wd p`` in a decayed group, and
    ``p <- p - lr u``."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                update = torch.sign(g * _scalar(1.0 - LION_B1, g) + mu * _scalar(LION_B1, mu))
                mu.copy_(g * _scalar(1.0 - LION_B2, g) + mu * _scalar(LION_B2, mu))
                if wd:
                    update = update + p * _scalar(wd, p)
                p.add_(update * _scalar(-group["lr"], update))
                state["step"] += 1


def factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: (second largest axis, largest axis) of
    ``shape`` (a stable argsort, so of two equal axes the later is the
    largest), or None when the tensor has one axis or the second largest
    is under ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``x ** -0.5`` computed in fp32 and rounded to x's dtype, as XLA
    computes a bf16 power (torch's bf16 ``rsqrt`` rounds otherwise)."""
    return torch.pow(x.float(), -0.5).to(x.dtype)


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(x²)) over the whole tensor, in x's dtype."""
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with its defaults: ``scale_by_factored_rms``
    (decay ``1 - (t + 1)^-0.8``, eps 1e-30 added to g² before the means),
    ``clip_by_block_rms(1.0)``, the learning rate,
    ``scale_by_param_block_rms`` (``max(rms(p), 1e-3)``) and ``scale(-1)``."""

    def __init__(self, params, lr: float, views: list | None = None):
        params = list(params)
        super().__init__(params, {"lr": lr})
        self._views = {id(p): v for p, v in zip(params, views or []) if v is not None}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for shard in group["params"]:
                if shard.grad is None:
                    continue
                to_full, to_local = self._views.get(id(shard), (None, None))
                p = to_full(shard) if to_full else shard
                g = to_full(shard.grad) if to_full else shard.grad
                state = self.state[shard]
                dims = factored_dims(tuple(p.shape))
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d0])
                        state["v_col"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])
                # the decay rate in fp32 from the count before this update
                t = torch.tensor(float(state["step"]) + 1.0, dtype=torch.float32, device=p.device)
                decay = 1.0 - t ** -DECAY_RATE
                grad_sqr = g * g + EPS
                if dims is None:
                    v = state["v"]
                    v.copy_(decay * v.float() + (1.0 - decay) * grad_sqr.float())
                    update = g * _inv_sqrt(v)
                else:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.copy_(decay * v_row.float() + (1.0 - decay) * torch.mean(grad_sqr, dim=d0).float())
                    v_col.copy_(decay * v_col.float() + (1.0 - decay) * torch.mean(grad_sqr, dim=d1).float())
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = torch.mean(v_row, dim=reduced_d1, keepdim=True)
                    row_factor = _inv_sqrt(v_row / row_col_mean)
                    col_factor = _inv_sqrt(v_col)
                    update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                # clip_by_block_rms at a threshold of 1
                update = update / torch.clamp(_block_rms(update), min=1.0)
                update = update * _scalar(group["lr"], update)
                rms = _block_rms(p)
                min_scale = _scalar(MIN_SCALE, p)
                update = update * torch.where(rms <= min_scale, min_scale, rms)
                shard.add_(-(to_local(update) if to_local else update))
                state["step"] += 1
