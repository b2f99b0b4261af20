"""``attn_impl="flash"``: packed causal segment attention through the GQA
kernels.

The JAX package's ``ops/flash_attention.py`` runs JAX's library splash
kernel (``make_splash_mha``) on the TPU: causal by flat index within the
packed row, and-ed with same segment, GQA, forward and backward, with q
pre-scaled. That is kernel #2's contract with ``q_offset = 0`` and the same
segment ids for queries and keys, so the port routes it to the GQA autograd
function (kernels #2-#4 on the card, their plain versions on the CPU).
"""

from __future__ import annotations

from .gqa_attention import mha_packed_gqa_simple

# drop-in for ``mha_packed``: (q, k, v, segment_ids, position_ids, scale) ->
# [B, L, H, Dh] in q's dtype
mha_packed_flash = mha_packed_gqa_simple
