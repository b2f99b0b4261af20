"""Attention and sampling ops: plain PyTorch versions and CUDA kernels."""


def kernel_launches() -> dict[str, int]:
    """This process's launch counts of the five kernels: each wrapper adds
    one where it launches its kernel."""
    from . import decode_attention, gqa_attention, paged_attention

    return {"decode": decode_attention.launches, "gqa_fwd": gqa_attention.launches,
            "gqa_dq": gqa_attention.dq_launches, "gqa_dkv": gqa_attention.dkv_launches,
            "paged": paged_attention.launches}
