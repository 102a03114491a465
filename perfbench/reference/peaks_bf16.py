"""The H100 SXM's dense bfloat16 tensor-core peak (NVIDIA's data sheet:
1,979 TFLOP/s with sparsity, half that dense; at the full 700 W power
limit), for the shares of a language model's work, which runs in bfloat16."""

from perfbench.reference.peaks import HBM_BYTES_PER_S

BF16_OPS_PER_S = 989.4e12


def least_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the chip could take for bfloat16 work, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
