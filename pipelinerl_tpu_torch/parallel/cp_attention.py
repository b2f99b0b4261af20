"""Context-parallel attention: the packed sequence cut over the cp axis.

Port of the JAX package's ``parallel/cp_attention.py``. Each cp rank holds
a contiguous ``L/cp`` slice of q, k, v and the segment ids. K, V and the kv
segment ids are all-gathered over cp (under GQA the kv heads are few: 32k
tokens x 2 kv heads x 64 dims in bf16 is 16 MB a layer), and the rank runs
``ops.gqa_attention.mha_packed_gqa`` over its queries against the whole row
with ``q_offset = cp_rank * L/cp``: kernels #2-#4 on CUDA tensors, their
plain versions on CPU tensors. The gather's backward reduce-scatters dK
and dV over cp, the VJP that GSPMD gives the JAX package.

``impl`` ``"blockwise"`` and ``"gqa"`` both go to the GQA kernels, the
port's route for JAX's blockwise kernel, whose function they compute;
``block_kv`` is JAX's blockwise tile and has no effect here. Pass the
result as ``attn_impl`` to ``models.transformer.forward``.
"""

from __future__ import annotations

from ..ops.gqa_attention import mha_packed_gqa
from . import collectives
from .mesh import axis_group, axis_rank


def make_cp_attention(mesh, *, num_kv_heads: int, block_kv: int = 1024, impl: str = "blockwise"):
    """→ attn(q, k, v, segment_ids, position_ids=None, scale=None) over this
    rank's slices (q [B, L/cp, H, Dh], k/v [B, L/cp, K, Dh], segment ids
    [B, L/cp]), with the ``mha_packed`` contract of the whole row. The
    kernels take any ``num_kv_heads`` dividing H."""
    del num_kv_heads, block_kv  # one kernel route for every K and tile
    if impl not in ("blockwise", "gqa"):
        raise ValueError(f"unknown cp attention impl {impl!r}")
    group = axis_group(mesh, "cp")
    rank = axis_rank(mesh, "cp")

    def attn(q, k, v, segment_ids, position_ids=None, scale=None):
        del position_ids  # causality by flat index
        kg = collectives.all_gather(k, 1, group).contiguous()
        vg = collectives.all_gather(v, 1, group).contiguous()
        segg = collectives.gather(segment_ids, 1, group).contiguous()
        return mha_packed_gqa(q.contiguous(), kg, vg, segment_ids.contiguous(), segg, rank * q.shape[1], scale)[0]

    return attn
